"""make_mesh without a process group: a one-rank gloo group formed in this
process on an in-memory store, over which msm_sharded equals msm."""

import numpy as np
import torch
import torch.distributed as dist

from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import curve as cv, msm
from halo_accumulation_tpu_torch.ops.field import FR
from halo_accumulation_tpu_torch.parallel import msm_sharded as sh

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def test_one_rank_mesh():
    """make_mesh without a process group forms a one-rank group in memory;
    shard_points is then every point and msm_sharded equals msm."""
    assert not dist.is_initialized()
    try:
        mesh = sh.make_mesh(devices="cpu")
        assert mesh.size() == 1 and dist.get_world_size() == 1
        rng = np.random.default_rng(8)
        ks = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(16)]
        P = cv.from_affine_ints([F.p_mul(k, (F.G_X, F.G_Y)) for k in ks[8:]])
        s = FR.from_ints(ks[:8])
        assert torch.equal(sh.shard_points(P, mesh).x, P.x)
        assert bool(cv.peq(sh.msm_sharded(sh.shard_points(P, mesh), s, mesh), msm.msm(P, s)))
    finally:
        dist.destroy_process_group()

"""The port's sharded MSM (parallel/msm_sharded.py) and check_device's mesh
path on torch.distributed over gloo, with 2 and 3 CPU ranks spawned from
the test (a FileStore under the test's tmp_path joins them: no network).

msm_sharded at N = 64 (2 ranks; 3 ranks at N = 96 in
test_torch_parallel_3.py) must equal the int
oracle (the JAX package's fields.p_msm) on every rank, and the
single-device msm.  pcdl.check_device(mesh=) of a hiding instance at
d = 1 must give the verdict check_device gives without a mesh, for the
instance and for a copy whose U is wrong: through msm_sharded where the
mesh's size divides d + 1 (2 ranks), through the single-device path where
it does not (3 ranks).  The ranks import only torch and the port.  The
one-rank mesh this process forms itself is in test_torch_parallel_one.py."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from halo_accumulation_tpu_torch import chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import curve as cv, msm
from halo_accumulation_tpu_torch.ops.field import FR
from halo_accumulation_tpu_torch.parallel import msm_sharded as sh
from tests._spawn import join_all
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

D = 1
DEADLINE_S = 240  # for the ranks: about three times this file's cold time in tier-1 (75 s; _3.py 38 s)


def _rank(rank: int, world: int, store: str, out: str, pts, scs, claims) -> None:
    """One rank: the sharded MSM and the mesh check of every claim, written
    to out.<rank> as JSON."""
    torch.set_num_threads(1)
    sh.init_process_group(rank, world, f"file://{store}", "cpu")
    try:
        mesh = sh.make_mesh(devices="cpu")
        assert mesh.size() == world and mesh.mesh_dim_names == (sh.AXIS,)
        P, s = cv.from_affine_ints(pts), FR.from_ints(scs)
        shard = sh.shard_points(P, mesh)
        assert shard.x.shape == (18, len(pts) // world)
        R = sh.msm_sharded(shard, s, mesh)
        res = {"sharded": cv.to_host(R)[0]}
        pp = pp_mod.get_pp(D + 1, "cpu")
        spy = []
        real = sh.msm_sharded
        sh.msm_sharded = lambda *a, **k: spy.append(1) or real(*a, **k)
        res["mesh"] = [bool(pcdl.check_device(*q, pp, mesh=mesh)) for q in claims]
        sh.msm_sharded = real
        res["sharded_checks"] = len(spy)
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def claims():
    """A hiding instance at d = 1 and a copy whose U is off by one
    generator, (C, d, z, v, pi) each, and check_device's verdicts on them
    without a mesh."""
    pp = pp_mod.get_pp(D + 1, "cpu")
    q = chain.random_instance(np.random.default_rng(7), D, pp)
    bad = dataclasses.replace(q.pi, U=F.p_add(q.pi.U, pp.gs_host(1)[0]))
    qs = [(q.C, q.d, q.z, q.v, q.pi), (q.C, q.d, q.z, q.v, bad)]
    return qs, [bool(pcdl.check_device(*c, pp)) for c in qs]


def run_world(world: int, N: int, claims, tmp_path) -> None:
    """Spawn world ranks on N random points and the claims; meanwhile the
    single-device msm runs here.  Every rank's point must equal the oracle
    and that msm's, and its mesh verdicts check_device's."""
    from halo_accumulation_tpu import fields as jF

    rng = np.random.default_rng(N)
    ks = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2 * N)]
    pts = [F.p_mul(k, (F.G_X, F.G_Y)) for k in ks[N:]]
    scs = ks[:N]
    qs, plain = claims
    assert plain == [True, False]
    out = str(tmp_path / "out")
    ctx = mp.start_processes(_rank, args=(world, str(tmp_path / "store"), out, pts, scs, qs),
                             nprocs=world, join=False, start_method="spawn")
    with join_all([ctx], DEADLINE_S):
        single = cv.to_host(msm.msm(cv.from_affine_ints(pts), FR.from_ints(scs)))[0]
    want = jF.p_msm(scs, pts)
    assert single == want
    for r in range(world):
        with open(f"{out}.{r}") as f:
            res = json.load(f)
        assert tuple(res["sharded"]) == want
        assert res["mesh"] == plain
        assert res["sharded_checks"] == (2 if (D + 1) % world == 0 else 0)


def test_msm_sharded_matches(claims, tmp_path):
    """2 ranks, N = 64; the mesh check goes through msm_sharded (2 divides
    d + 1).  3 ranks are in test_torch_parallel_3.py."""
    run_world(2, 64, claims, tmp_path)

"""open_(mesh=) on 3 gloo ranks at n = 16: 3 does not divide n, so every
rank takes the single-device open (a spy on _open_sharded sees no call)
and writes its bytes, the JAX package's open's; the claim without
hiding."""

import torch

from tests._spawn import join_all
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_mesh_open import jax_proofs, results, spawn

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

NAMES = ("plain",)
DEADLINE_S = 80  # for the ranks: about three times this file's cold time in tier-1 (24 s)


def test_mesh_open_three_ranks_single_device(tmp_path):
    with join_all([spawn(3, tmp_path, NAMES), spawn(0, tmp_path, NAMES)], DEADLINE_S):
        pass
    (single,) = results(0, tmp_path, NAMES)
    assert single["proofs"] == {k: jax_proofs()[k] for k in NAMES}
    for r, res in enumerate(results(3, tmp_path, NAMES)):
        assert res["sharded"] == 0, f"rank {r} split the fold over a mesh whose size does not divide n"
        assert res["proofs"] == single["proofs"], f"rank {r}: the proof differs from the single-device open's"

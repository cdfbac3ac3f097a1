"""open_(mesh=) on gloo ranks: the fold's width split over 4 CPU ranks (2
in test_torch_mesh_open_2.py; a FileStore under tmp_path joins them: no
network) at n = 16.

With 4 ranks each holds w = 4 lanes of t and of the URS, so the rounds at
half-width m = 8 and 4 read coefficients of lanes other ranks hold and the
rounds at m = 2 and 1 only the rank's own; with 2 ranks, w = 8.  Each rank
opens one polynomial without and with hiding from an rng in the same state
as the single-device opens'; every rank's proof must equal that open's
bytes, and succinct_check must accept it.  The world runs beside two
processes that make the single-device opens, whose bytes must equal the
JAX package's pcdl.open_ on the same claim, rng and w
(tests/data/open_16.json, written by tools/port_test_chain.py: the JAX
open takes longer on the CPU than a test file may).  The 3-rank case (3 does not
divide n) is in test_torch_mesh_open_3.py."""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from halo_accumulation_tpu_torch import chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops.field import FR
from halo_accumulation_tpu_torch.parallel import msm_sharded as sh
from tests._spawn import join_all
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

N = 16
DEADLINE_S = 200  # for the ranks: about three times this file's cold time in tier-1 (62 s; _2.py 40 s)
HIDING = {"plain": None, "hiding": 12345}
JAX_OPENS = pathlib.Path(__file__).resolve().parent / "data" / "open_16.json"


def claim():
    """(coefficients, z, v) of the polynomial every open proves."""
    rng = np.random.default_rng(3)
    coeffs = [chain.rand_scalar(rng) for _ in range(N)]
    z = chain.rand_scalar(rng)
    return coeffs, z, sum(c * pow(z, i, F.R) for i, c in enumerate(coeffs)) % F.R


def jax_proofs() -> dict:
    """{case: proof hex} of the JAX package's open_ of claim() from rng
    seed 5, for each HIDING case."""
    with open(JAX_OPENS) as f:
        ref = json.load(f)
    _, z, v = claim()
    assert (ref["n"], ref["hiding"], int(ref["z"]), int(ref["v"])) == (N, HIDING, z, v)
    return ref["proofs"]


def opens(pp, mesh=None, spy=None, names=tuple(HIDING)) -> dict:
    """{name: (C, proof bytes)} of the named HIDING cases, each opened from
    rng seed 5; spy: a list that collects each _open_sharded call."""
    coeffs, z, v = claim()
    out = {}
    real = pcdl._open_sharded
    if spy is not None:
        pcdl._open_sharded = lambda *a: spy.append(1) or real(*a)
    try:
        for name in names:
            w = HIDING[name]
            C = pcdl.commit(FR.from_ints(coeffs), N - 1, w, pp)
            pi = pcdl.open_(np.random.default_rng(5), FR.from_ints(coeffs), C, N - 1, z, w, pp, mesh=mesh, axis=sh.AXIS,
                            v=v)
            out[name] = (C, pi.serialize().hex())
    finally:
        pcdl._open_sharded = real
    return out


def _rank(rank: int, world: int, store: str, out: str, names) -> None:
    """One rank of a world opening the named HIDING cases; world 0: no
    mesh, process r opens the r-th named case on one device."""
    torch.set_num_threads(1)
    pp = pp_mod.get_pp(N, "cpu")
    spy = []
    with torch.inference_mode():  # no autograd bookkeeping: a quarter of the twins' CPU time
        if world == 0:
            res = opens(pp, names=[names[rank]])
        else:
            sh.init_process_group(rank, world, f"file://{store}", "cpu")
            try:
                res = opens(pp, sh.make_mesh(devices="cpu"), spy, names)
            finally:
                dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump({"proofs": {k: b for k, (_, b) in res.items()}, "C": {k: c for k, (c, _) in res.items()},
                   "sharded": len(spy)}, f)


def spawn(world: int, tmp_path, names=tuple(HIDING)):
    return mp.start_processes(_rank, args=(world, str(tmp_path / f"store{world}"), str(tmp_path / f"out{world}"),
                                           names), nprocs=world or len(names), join=False, start_method="spawn")


def results(world: int, tmp_path, names=tuple(HIDING)) -> list:
    out = []
    for r in range(world or len(names)):
        with open(tmp_path / f"out{world}.{r}") as f:
            out.append(json.load(f))
    return out


def run_world(world: int, tmp):
    """A world's proofs by rank, and the single-device {case: (C, proof
    bytes)}, each equal to the JAX package's and accepted by
    succinct_check."""
    with join_all([spawn(w, tmp) for w in (0, world)], DEADLINE_S):
        pass
    single = {k: (tuple(r["C"][k]) if r["C"][k] else None, b) for r in results(0, tmp) for k, b in r["proofs"].items()}
    assert {k: b for k, (_, b) in single.items()} == jax_proofs(), "the single-device open differs from the JAX package's"
    _, z, v = claim()
    for C, b in single.values():
        pcdl.succinct_check(C, N - 1, z, v, pcdl.EvalProof.deserialize(bytes.fromhex(b)), pp_mod.get_pp(N, "cpu"))
    return single, results(world, tmp)


def check_world(world: int, runs, hiding: str) -> None:
    single, ranks = runs
    want = single[hiding][1]
    for r, res in enumerate(ranks):
        assert res["sharded"] == len(HIDING), f"rank {r} took the single-device open"
        assert res["proofs"][hiding] == want, f"rank {r} of {world}: the proof differs from the single-device open's"


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return run_world(4, tmp_path_factory.mktemp("mesh_open_4"))


@pytest.mark.parametrize("hiding", HIDING)
def test_mesh_open_four_ranks(runs4, hiding):
    check_world(4, runs4, hiding)

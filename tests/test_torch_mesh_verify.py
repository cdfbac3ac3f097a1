"""succinct_check_batch(mesh=) and verify_chain(mesh=) on 2 gloo ranks (3
in test_torch_mesh_verify_3.py; a FileStore under tmp_path joins them: no
network) against the
single-device path, on tests/data/chain_16_2.bin (the JAX package's
build_chain(default_rng(7), 16, 2), written by tools/port_test_chain.py:
building it here would take longer than a test file may).

The batch is 8 rows, the chain's five claims and three repeated; a copy
with one row's v off by one must fail at that row.  verify_chain accepts
the chain; three tampered copies fail at a succinct row (c of step 1's
fresh claim), at a U_0 row (G0 and G1 swapped in the key: only the U_0
rows read them) and at the final decider (G2 and G3 swapped: only its
deferred MSM reads them).  With 2 ranks the rows split 4 and 4 (the U_0
rows 1 and 1) and the decider's deferred MSM runs on msm_sharded; with 3,
8 rows pad to 9 (U_0 rows 2 to 3) and 3 does not divide n = 16, so the
decider runs on one device.  Every rank must give the single-device
verdict, or raise its text.  The cases run in two groups, each on a world
of its own, at once; the single-device path runs here meanwhile."""

import dataclasses
import json
import pathlib

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from halo_accumulation_tpu_torch import acc, chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.parallel import msm_sharded as sh
from tests._spawn import join_all
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

DEADLINE_S = 150  # for the ranks: about three times this file's cold time in tier-1 (36 s; _3.py 46 s)
CHAIN = pathlib.Path(__file__).resolve().parent / "data" / "chain_16_2.bin"
BAD_ROW = 5


def swapped(pp, i: int, j: int):
    gx, gy = pp.gs_x.clone(), pp.gs_y.clone()
    gx[:, [i, j]], gy[:, [i, j]] = gx[:, [j, i]], gy[:, [j, i]]
    return pp_mod.PublicParams(pp.n, gx, gy, pp.s, pp.h)


def cases(mesh=None, names=None) -> dict:
    """{case: None (accepted) or the ValueError's text} of each named call
    (all by default)."""
    d, qss, accs = chain.load_chain(CHAIN)
    pp = pp_mod.get_pp(d + 1, "cpu")
    claims = [(q.C, q.d, q.z, q.v, q.pi) for q in qss[0] + qss[1] + [a.to_instance() for a in accs]]
    rows = claims + claims[:3]
    bad_rows = list(rows)
    C, dd, z, v, pi = rows[BAD_ROW]
    bad_rows[BAD_ROW] = (C, dd, z, (v + 1) % F.R, pi)
    q = qss[1][1]
    bad_c = dataclasses.replace(q, pi=dataclasses.replace(q.pi, c=(q.pi.c + 1) % F.R))
    calls = {
        "batch": lambda: pcdl.succinct_check_batch(rows, pp, mesh=mesh, axis=sh.AXIS),
        "batch_bad_row": lambda: pcdl.succinct_check_batch(bad_rows, pp, mesh=mesh, axis=sh.AXIS),
        "chain": lambda: acc.verify_chain(d, qss, accs, pp, mesh=mesh, axis=sh.AXIS),
        "chain_bad_row": lambda: acc.verify_chain(d, [qss[0], [qss[1][0], bad_c]], accs, pp, mesh=mesh, axis=sh.AXIS),
        "chain_bad_u0": lambda: acc.verify_chain(d, qss, accs, swapped(pp, 0, 1), mesh=mesh, axis=sh.AXIS),
        "chain_bad_decider": lambda: acc.verify_chain(d, qss, accs, swapped(pp, 2, 3), mesh=mesh, axis=sh.AXIS),
    }
    out = {}
    for name in names or calls:
        fn = calls[name]
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


GROUPS = (("batch_bad_row", "chain", "chain_bad_row"), ("batch", "chain_bad_u0", "chain_bad_decider"))
WANT = {"batch": None, "batch_bad_row": f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {BAD_ROW})",
        "chain": None, "chain_bad_row": "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 2)",
        "chain_bad_u0": "U_0 != PCDL.Commit(h_0) at step 0", "chain_bad_decider": "U != CM.Commit(ck, h_vec)"}


def _rank(rank: int, world: int, store: str, out: str, names) -> None:
    torch.set_num_threads(1)
    sh.init_process_group(rank, world, f"file://{store}", "cpu")
    try:
        spy = []
        real = sh.msm_sharded
        sh.msm_sharded = lambda *a, **k: spy.append(1) or real(*a, **k)
        with torch.inference_mode():  # no autograd bookkeeping: a quarter of the twins' CPU time
            res = cases(sh.make_mesh(devices="cpu"), names)
        with open(f"{out}.{rank}", "w") as f:
            json.dump({"cases": res, "sharded_deciders": len(spy)}, f)
    finally:
        dist.destroy_process_group()


def run_world(world: int, tmp_path) -> None:
    """Spawn a world of ranks for each of GROUPS; meanwhile the
    single-device path runs here and must give the JAX package's verdicts
    and texts (WANT).  Every rank must give the same, and its verify_chain
    deciders must take msm_sharded exactly when the mesh's size divides
    n = 16."""
    with join_all([mp.start_processes(_rank, args=(world, str(tmp_path / f"store{g}"), str(tmp_path / f"out{g}"), names),
                                      nprocs=world, join=False, start_method="spawn") for g, names in enumerate(GROUPS)],
                  DEADLINE_S):
        single = cases()
    assert single == WANT
    for g, names in enumerate(GROUPS):
        chains = sum(name.startswith("chain") for name in names)
        for r in range(world):
            with open(tmp_path / f"out{g}.{r}") as f:
                res = json.load(f)
            assert res["cases"] == {k: single[k] for k in names}, f"rank {r} of {world}"
            assert res["sharded_deciders"] == (chains if 16 % world == 0 else 0)


def test_mesh_verify_two_ranks(tmp_path):
    run_world(2, tmp_path)

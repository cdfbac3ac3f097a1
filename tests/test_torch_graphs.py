"""The port's single-dispatch programs (runtime.graphed) and its api façade,
on the CPU.

A CUDA graph replays what its capture recorded, so a body that copies a
value to the host cannot be captured (and one that branched on a value
would replay the branch of the capture).  On the CPU the bodies run
eagerly, so here a guard makes every host copy inside a body raise
(`SyncGuard`), except inside ops/cuda_kernels.py's plain twins, which the
card replaces with kernels.  The verdict bodies of verify_chain and
check_many_device run under it on the first step of chain_512_10.bin and
on two tampered copies; the n = 512 open body is left to the card (minutes
in the twins here), where tests/test_torch_cuda.py runs every body
under torch.cuda.set_sync_debug_mode("error").  Then the graph cache's
keys, its launch accounting, and api against the JAX package's api.
"""

import dataclasses
import inspect
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import api as japi
from halo_accumulation_tpu_torch import acc, api, chain, fields as F, pcdl, pp as pp_mod, runtime
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHAIN_512 = ROOT / ".chain_cache" / "chain_512_10.bin"
CHAIN_1024 = ROOT / ".chain_cache" / "chain_1024_10.bin"
TENSOR_SYNCS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__", "__index__", "nonzero", "unique")
TORCH_SYNCS = ("nonzero", "unique")
TWINS = ("fmul_plain", "padd_plain", "pdbl_plain", "bucket_masked_plain", "bucket_accum_plain", "finv_plain",
         "rho_round_plain")


class HostSync(Exception):
    pass


class SyncGuard:
    """While the guard is entered, the tensor calls that bring values to
    the host raise HostSync; inside a kernel's plain twin they run."""

    def __init__(self, monkeypatch):
        self.depth = 0
        for name in TENSOR_SYNCS:
            monkeypatch.setattr(torch.Tensor, name, self._guarded(getattr(torch.Tensor, name), name))
        for name in TORCH_SYNCS:
            monkeypatch.setattr(torch, name, self._guarded(getattr(torch, name), f"torch.{name}"))
        for name in TWINS:
            monkeypatch.setattr(ck, name, self._lifted(getattr(ck, name)))

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1

    def _guarded(self, fn, name):
        def call(*args, **kwargs):
            if self.depth > 0:
                raise HostSync(f"{name} inside a graph body")
            return fn(*args, **kwargs)

        return call

    def _lifted(self, fn):
        def call(*args, **kwargs):
            depth, self.depth = self.depth, 0
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth = depth

        return call


@pytest.fixture(scope="module")
def loaded():
    return chain.load_chain(CHAIN_512)


@pytest.fixture(scope="module")
def pp(loaded):
    return pp_mod.get_pp(loaded[0] + 1, "cpu")


def _swapped(pp, i: int, j: int):
    """The URS with generators i and j swapped: a key the chain's proofs do
    not open under."""
    gx, gy = pp.gs_x.clone(), pp.gs_y.clone()
    gx[:, [i, j]], gy[:, [i, j]] = gx[:, [j, i]], gy[:, [j, i]]
    return pp_mod.PublicParams(pp.n, gx, gy, pp.s, pp.h)


def _tamper(case: str, loaded, pp):
    """(qss, accs, pp) of the chain's first step, good or tampered: C_bar'
    (the accumulator's C_bar replaced by the next one's) or the deferred
    MSM's U (generators 2 and 3 swapped, which only the final decider's
    n-point MSM reads)."""
    _, qss, accs = loaded
    if case == "c_bar":
        return qss[:1], [dataclasses.replace(accs[0], C_bar=accs[1].C_bar)], pp
    if case == "u":
        return qss[:1], accs[:1], _swapped(pp, 2, 3)
    return qss[:1], accs[:1], pp


ROW_TEXT = "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"
U_TEXT = "U != CM.Commit(ck, h_vec)"
# the JAX package's texts, by path and case: decide_many's decider meets a
# wrong C_bar in its row equation (check_many_device is its body)
TEXTS = {"verify_chain": {"good": None, "c_bar": "C_bar' != C_bar at step 0", "u": U_TEXT},
         "check_many_device": {"good": None, "c_bar": ROW_TEXT, "u": U_TEXT}}


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["good", "c_bar", "u"])
def test_verdict_bodies_have_no_host_sync(loaded, pp, monkeypatch, case):
    """verify_chain's and check_many_device's bodies (what runtime.graphed
    captures on the card) under the guard, each path raising the JAX
    package's text; their verdicts equal the eager path's: verify_chain's
    body run again unguarded, whose last row (the final decider) is the
    one check_many_device makes for the same accumulator."""
    d = loaded[0]
    qss, accs, key = _tamper(case, loaded, pp)
    guard, bodies = SyncGuard(monkeypatch), []

    def guarded(name, shape_key, body, args, device, holds=()):
        with guard:
            out = body(*args)
        bodies.append((body, args, out))
        return out

    monkeypatch.setattr(runtime, "graphed", guarded)
    outcomes = (_outcome(lambda: acc.verify_chain(d, qss, accs, key)), _outcome(lambda: acc.decide_many(accs, key)))
    assert outcomes == (TEXTS["verify_chain"][case], TEXTS["check_many_device"][case])
    monkeypatch.undo()
    (body, args, got_chain), (_, _, got_decide) = bodies
    want = body(*args).tolist()
    assert got_chain.dtype == got_decide.dtype == torch.bool
    assert got_chain.tolist() == want and got_decide.tolist() == want[-1:]
    assert want == [True, True, case == "good"]


def _keys(monkeypatch):
    """runtime.graphed replaced by a recorder of its keys that computes
    nothing: every row verdict comes back True."""
    keys = []

    def record(name, shape_key, body, args, device, holds=()):
        keys.append(runtime.graph_key(name, shape_key, holds))
        return torch.ones(args[3].shape[1], dtype=torch.bool)

    monkeypatch.setattr(runtime, "graphed", record)
    return keys


def test_graph_keys(loaded, pp, monkeypatch):
    """Same shape, one key; another K, another M (the degree), another URS:
    another key.  verify_chain keys by its rows (B grows with the steps),
    decide_many by K."""
    d, qss, accs = loaded
    keys = _keys(monkeypatch)
    acc.decide_many(accs[:2], pp)
    acc.decide_many(accs[2:4], pp)
    acc.decide_many(accs[:3], pp)
    acc.decide_many(accs[:2], _swapped(pp, 0, 1))
    d2, _, accs2 = chain.load_chain(CHAIN_1024)
    acc.decide_many(accs2[:2], pp_mod.get_pp(d2 + 1, "cpu"))
    acc.verify_chain(d, qss[1:3], accs[1:3], pp)
    acc.verify_chain(d, qss[2:4], accs[2:4], pp)
    acc.verify_chain(d, qss[:2], accs[:2], pp)
    assert keys[0] == keys[1] and keys[5] == keys[6]
    assert len({keys[i] for i in (0, 2, 3, 4, 5, 7)}) == 6
    B, M, K, n = keys[0][1]
    assert keys[0][0] == "verdicts" and (B, M, K, n) == (2, 21, 2, 512) and keys[4][1][1:] == (23, 2, 1024)
    assert keys[5][1] == (4 + 2 + 1, 21, 1, 512) and keys[7][1] == (3 + 2 + 1, 21, 1, 512)


def test_graphs_off_paths_take_no_graph(loaded, pp, monkeypatch):
    """Rowperm keeps the eager path, as do more than 32 succinct checks in
    verify_chain (the JAX package's condition for its fused verdict)."""
    d, qss, accs = loaded
    keys = _keys(monkeypatch)
    monkeypatch.setattr(pcdl, "_rows_and_isinf", lambda P, s: torch.ones(s.shape[1], dtype=torch.bool))
    monkeypatch.setattr(pcdl, "_deferred", lambda xis, U, pp: torch.ones(xis.shape[1], dtype=torch.bool))
    d100, qss100, accs100 = chain.load_chain(ROOT / ".chain_cache" / "chain_512_100.bin")
    acc.verify_chain(d100, qss100[:17], accs100[:17], pp)  # 33 succinct checks
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    acc.verify_chain(d, qss[:2], accs[:2], pp)
    acc.decide_many(accs[:2], pp)
    assert keys == []
    monkeypatch.delenv("HALO_TPU_MSM_IMPL")
    acc.verify_chain(d100, qss100[:16], accs100[:16], pp)  # 31 succinct checks
    assert len(keys) == 1


def test_cpu_runs_body_eagerly():
    """On the CPU graphed calls body on its args and keeps no graph."""
    before = dict(runtime.graphs)
    out = runtime.graphed("t", (3,), lambda a, b: a + b, (torch.ones(3), torch.arange(3.0)), "cpu")
    assert out.tolist() == [1.0, 2.0, 3.0] and runtime.graphs == before


def test_replay_launch_accounting(monkeypatch):
    """A capture's launches are taken back and kept; each replay adds them
    again, widths included."""
    for k in ck.KERNELS.values():
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "widths", Counter())
    ck.KERNELS["padd"].launches, ck.KERNELS["padd"].widths[10] = 3, 3
    mark = ck.launch_record()
    ck.KERNELS["padd"].launches += 2
    ck.KERNELS["padd"].widths.update({10: 1, 7936: 1})
    ck.KERNELS["fmul"].launches += 1
    ck.KERNELS["fmul"].widths[4] += 1
    delta = ck.launches_since(mark)
    ck.restore_launches(mark)
    assert ck.launch_counts()["padd"] == 3 and ck.launch_widths()["padd"] == {10: 3}
    ck.add_launches(delta)
    ck.add_launches(delta)
    assert ck.launch_counts() == {**{k: 0 for k in ck.KERNELS}, "padd": 7, "fmul": 2}
    assert ck.launch_widths()["padd"] == {10: 5, 7936: 2} and ck.launch_widths()["fmul"] == {4: 2}


def _public(module) -> set:
    return {name for name in vars(module) if not name.startswith("_")}


def test_api_names_and_signatures():
    """api exports the JAX api's names; every function has its signature,
    setup with one more parameter, device."""
    assert _public(api) == _public(japi)
    for name in _public(japi):
        jfn = getattr(japi, name)
        if not inspect.isfunction(jfn):
            continue
        got = inspect.signature(getattr(api, name))
        if name == "setup":
            params = list(got.parameters.values())
            assert params[-1].name == "device" and params[-1].default is None
            got = got.replace(parameters=params[:-1])
        assert got == inspect.signature(jfn), name
    assert (api.Instance, api.Accumulator, api.EvalProof, api.HPoly, api.PublicParams) == (
        acc.Instance, acc.Accumulator, pcdl.EvalProof, pcdl.HPoly, pp_mod.PublicParams)


# verb -> (module, function, arguments): each verb hands its arguments on
VERBS = {
    "setup": (pp_mod, "get_pp", (16, "cpu")),
    "commit": (pcdl, "commit", ([1, 2], 15, None, "pp")),
    "open": (pcdl, "open_", ("rng", [1, 2], "C", 15, 5, None, "pp")),
    "succinct_check": (pcdl, "succinct_check", ("C", 15, 5, 7, "pi", "pp")),
    "check": (pcdl, "check", ("C", 15, 5, 7, "pi", "pp")),
    "accumulate": (acc, "prover", ("rng", 15, ["q"], "pp")),
    "verify": (acc, "verifier", (15, ["q"], "acc", "pp")),
    "decide": (acc, "decider", ("acc", "pp")),
    "verify_chain": (acc, "verify_chain", (15, [["q"]], ["acc"], "pp")),
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_api_verb_calls_port(verb, monkeypatch):
    module, fn, args = VERBS[verb]
    calls = []
    monkeypatch.setattr(module, fn, lambda *a: calls.append(a) or "result")
    assert getattr(api, verb)(*args) == "result" and calls == [args]


def test_api_setup_defaults_to_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(pp_mod, "get_pp", lambda *a: calls.append(a))
    api.setup(16)
    assert calls == [(16, None)]


def test_api_eval_poly_matches_jax():
    rng = np.random.default_rng(5)
    p = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(9)]
    z = int.from_bytes(rng.bytes(40), "little") % F.R
    assert api.eval_poly(p, z) == japi.eval_poly(p, z)

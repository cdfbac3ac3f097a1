"""portbench/costs.py is a frozen copy: each constant and function equals
chip_smoke.py's, where the port's least-work counts were set."""

from __future__ import annotations

import importlib.util
import pathlib
import random

import pytest

from portbench import costs
from portbench.reference import curve

REPO = pathlib.Path(__file__).resolve().parents[2]
COPIED = ("MEM_RATE", "IMAD_PER_CLOCK_SM", "SMS", "FQ_BYTES", "MIN_MULS_FMUL", "MIN_MULS_SQR", "MIN_MULS_PADD",
          "MIN_MULS_MADD", "MIN_MULS_PDBL", "FINV_DIVSTEPS", "FINV_BATCH", "DIVSTEP_OPS", "MATRIX_MULS",
          "FINV_DIVSTEP_OPS32", "KECCAK_OPS32", "RHO_BYTES")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_costs", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", COPIED)
def test_constant_equals_chip_smoke(smoke, name):
    assert getattr(costs, name) == getattr(smoke, name)


def test_finv_least_ops_equals_chip_smoke(smoke):
    for p in (curve.Q, curve.R):
        assert costs.finv_least_ops(p) == smoke.finv_least_ops(p)
        for k in range(1, 9):
            assert costs.sliding_window_chain(p - 2, k) == smoke.sliding_window_chain(p - 2, k)


@pytest.mark.parametrize("kernel,width,nbytes,ops", [
    ("fmul", 65536, "3 * FQ_BYTES * n", "MIN_MULS_FMUL * n"),
    ("padd", 7936, "9 * FQ_BYTES * n", "MIN_MULS_PADD * n"),
    ("pdbl", 10, "6 * FQ_BYTES * n", "MIN_MULS_PDBL * n"),
    ("rho_round", 1, "RHO_BYTES", "KECCAK_OPS32"),
])
def test_launch_bound_equals_chip_smoke(smoke, kernel, width, nbytes, ops):
    """chip_smoke.bound() of the same bytes and operations (pdbl at one
    doubling, what the counters allow)."""
    env = {"n": width, **{k: getattr(smoke, k) for k in COPIED + ("MIN_MULS_PDBL",)}}
    want = smoke.bound(eval(nbytes, env), eval(ops, env), 0, 1980.0)["bound_ms"] / 1e3
    assert costs.launch_least_seconds(kernel, width, 1980.0) == pytest.approx(want, rel=1e-12)


def test_finv_bound_takes_the_cheaper_field(smoke):
    want = min(smoke.bound(2 * 32 * 2, smoke.finv_least_ops(p) * 2, 0, 1980.0)["bound_ms"] for p in (curve.Q, curve.R))
    assert costs.launch_least_seconds("finv", 2, 1980.0) == pytest.approx(want / 1e3, rel=1e-12)
    assert costs.launch_least_seconds("bucket_masked", 7936, 1980.0) is None


def test_busy_union_equals_chip_smoke(smoke):
    rng = random.Random(3)
    for _ in range(50):
        iv = sorted((s, s + rng.random()) for s in (rng.random() * 10 for _ in range(rng.randrange(1, 40))))
        assert costs.busy_seconds(iv) == pytest.approx(smoke._busy_us([(s, t, "k") for s, t in iv]), abs=1e-12)

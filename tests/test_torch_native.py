"""The port's native C++ backend (halo_accumulation_tpu_torch/native/)
against the pure-Python oracle, and hostops' choice between them.

Mirrors tests/test_native.py for the port's own copy: group ops, MSM, URS
generators and SHA3 against fields.py, pp.gen_scalar and hashlib, all
exact.  Then the protocol end to end: a one-step chain at n = 512 built
with native host ops equals the JAX-built chain_512_10.bin's first step,
and every host op of that build equals the oracle's result for the same
arguments.
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from halo_accumulation_tpu_torch import chain, fields as F, hostops, native, pp as pp_mod
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHAIN_512 = ROOT / ".chain_cache" / "chain_512_10.bin"
G = (F.G_X, F.G_Y)


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no g++: the native backend cannot be built here")
    return native


def test_builds_into_build_dir(lib):
    """The library lives under build/native/, named by the hash of its
    source and flags, and nothing is written into either package."""
    path = lib.lib_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert not list((ROOT / "halo_accumulation_tpu_torch").rglob("*.so"))


def test_sha3(lib):
    for msg in (b"", b"a", b"hello", b"x" * 135, b"y" * 136, b"z" * 1000):
        assert lib.sha3(msg) == hashlib.sha3_256(msg).digest()


def test_group_ops(lib, rng):
    """Random points, the identity, P + P, P + (-P), k = 0 and k = R - 1."""
    ks = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(6)]
    pts = [F.p_mul(k, G) for k in ks]
    assert lib.point_add(pts[0], pts[1]) == F.p_add(pts[0], pts[1])
    assert lib.point_add(pts[0], pts[0]) == F.p_add(pts[0], pts[0])
    assert lib.point_add(pts[0], F.p_neg(pts[0])) is None
    assert lib.point_add(None, pts[2]) == pts[2]
    assert lib.point_add(pts[2], None) == pts[2]
    assert lib.point_add(None, None) is None
    assert lib.scalar_mul(ks[3], pts[4]) == F.p_mul(ks[3], pts[4])
    assert lib.scalar_mul(0, pts[0]) is None
    assert lib.scalar_mul(F.R - 1, pts[1]) == F.p_neg(pts[1])
    assert lib.scalar_mul(ks[5], None) is None


def test_msm(lib, rng):
    n = 33
    ks = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)]
    pts = [F.p_mul(k + 1, G) for k in range(n)]
    assert lib.msm(ks, pts) == F.p_msm(ks, pts)
    assert lib.msm([0] * n, pts) is None
    assert lib.msm(ks[:6], pts[:3] + [None] * 3) == F.p_msm(ks[:3], pts[:3])


def test_urs_matches_generator_scalars(lib):
    """URS index i is gen_scalar(i) G (indices 0 and 1 are S and H)."""
    for i, P in enumerate(lib.urs(0, 6)):
        assert P == F.p_mul(pp_mod.gen_scalar(i), G)


def test_hostops_route(lib, rng, monkeypatch):
    """use_native() picks the backend where it builds; forced off, hostops
    runs the oracle; both give the same points, scalars reduced mod R
    first (a scalar above R, as transcript arithmetic may hand over)."""
    k = int.from_bytes(rng.bytes(40), "little")
    P, Q = F.p_mul(5, G), F.p_mul(7, G)
    assert hostops.use_native()
    for flag in (True, False):
        monkeypatch.setattr(hostops, "_use_native", flag)
        assert hostops.p_mul(k + F.R, P) == F.p_mul(k, P)
        assert hostops.p_add(P, Q) == F.p_add(P, Q)
        assert hostops.p_msm([k, F.R + 3], [P, Q]) == F.p_msm([k, 3], [P, Q])


def test_build_chain_same_bytes_native_on_and_off(lib, monkeypatch):
    """build_chain(default_rng(7), 512, 1) with use_native() forced on
    writes the first step of chain_512_10.bin (built by the JAX package)
    byte for byte.  Every host op of the build is checked against the
    oracle on the same arguments, so the build with use_native() forced off
    takes the same values at every step and writes the same bytes; one
    build instead of two, since a step at n = 512 takes minutes in the
    CPU twins."""
    calls = {"p_add": 0, "p_mul": 0, "p_msm": 0}
    native_ops = {name: getattr(hostops, name) for name in calls}
    oracle = {"p_add": F.p_add, "p_mul": F.p_mul, "p_msm": F.p_msm}

    def checked(name):
        def op(*args):
            got = native_ops[name](*args)
            assert got == oracle[name](*args), name
            calls[name] += 1
            return got

        return op

    monkeypatch.setattr(hostops, "_use_native", True)
    for name in calls:
        monkeypatch.setattr(hostops, name, checked(name))
    d, qss, accs = chain.build_chain(np.random.default_rng(7), 512, 1, pp_mod.get_pp(512, "cpu"))
    _, fqss, faccs = chain.load_chain(CHAIN_512)
    assert chain.step_records(qss, accs) == chain.step_records(fqss[:1], faccs[:1])
    assert all(calls.values()), calls

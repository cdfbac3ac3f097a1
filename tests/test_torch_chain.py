"""Port parity of the verifier path on a committed chain.

Both packages parse the same `.chain_cache` bytes; the port's host
transcript replays must equal the JAX package's (with a JAX PublicParams
built from the port's URS); the port's verify_chain and decide_many must
accept the chain and reject tampered copies with the JAX package's
ValueError texts.  To stay fast the device checks run on a one- or
two-step prefix of `chain_512_10.bin` (a prefix of a chain is itself a
valid chain)."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import acc as jacc, chain as jchain, pcdl as jpcdl, pp as jpp
from halo_accumulation_tpu_torch import acc as acc_mod, chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import curve as cv, poly
from halo_accumulation_tpu_torch.ops.field import FR, L
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
LEGACY = ROOT / ".chain_cache" / "chain_512_10.bin"  # no HALOCHN2 tag: starts with d
TAGGED = ROOT / ".chain_cache" / "chain_1024_10.bin"


@pytest.fixture(scope="module")
def loaded():
    return chain.load_chain(LEGACY)


@pytest.fixture(scope="module")
def pp(loaded):
    return pp_mod.get_pp(loaded[0] + 1, "cpu")


@pytest.fixture(scope="module")
def jax_pp(pp):
    """The JAX package's PublicParams holding the port's URS."""
    gx, gy, s, h = pp_mod.to_numpy(pp)
    return jpp.PublicParams(pp.n, gx, gy, s, h)


def _fields(q):
    return (q.C, q.d, q.z, q.v, q.pi.Ls, q.pi.Rs, q.pi.U, q.pi.c, q.pi.C_bar, q.pi.w_prime)


def _acc_fields(a):
    return _fields(a.to_instance()) + (a.pi_V.h, a.pi_V.U, a.pi_V.w)


def bump_v(a):
    return acc_mod.Accumulator(a.C_bar, a.d, a.z, (a.v + 1) % F.R, a.pi, a.pi_V)


@pytest.mark.parametrize("path", [LEGACY, TAGGED], ids=["legacy", "HALOCHN2"])
def test_load_chain_matches_jax(path):
    assert (path.read_bytes()[:8] == chain.CHAIN_MAGIC) == (path == TAGGED)
    d, qss, accs = chain.load_chain(path)
    jd, jqss, jaccs = jchain.load_chain(path)
    assert d == jd and len(accs) == len(jaccs) == 10
    assert [[_fields(q) for q in qs] for qs in qss] == [[_fields(q) for q in qs] for qs in jqss]
    assert [_acc_fields(a) for a in accs] == [_acc_fields(a) for a in jaccs]


def test_serialization_matches_jax(loaded):
    _, qss, accs = loaded
    for a in accs:
        blob = acc_mod.serialize_accumulator(a)
        assert blob == jacc.serialize_accumulator(jacc.deserialize_accumulator(blob))
        assert acc_mod.serialize_accumulator(acc_mod.deserialize_accumulator(blob)) == blob
    for q in qss[-1]:
        assert q.serialize() == jacc.Instance(q.C, q.d, q.z, q.v, jpcdl.EvalProof.deserialize(q.pi.serialize())).serialize()


def test_succinct_check_parts_match_jax(loaded, pp, jax_pp):
    """Every instance and accumulator of the chain: the same h challenges,
    MSM row points and scalars as the JAX host replay."""
    _, qss, accs = loaded
    claims = [(q.C, q.d, q.z, q.v, q.pi) for qs in qss for q in qs]
    claims += [(a.C_bar, a.d, a.z, a.v, a.pi) for a in accs]
    for C, d, z, v, pi in claims:
        h, pts, scs = pcdl.succinct_check_parts(C, d, z, v, pi, pp)
        jh, jpts, jscs = jpcdl.succinct_check_parts(C, d, z, v, jpcdl.EvalProof.deserialize(pi.serialize()), jax_pp)
        assert (h.xis, pts, scs) == (jh.xis, jpts, jscs)


def test_commit_matches_accumulator_U0(loaded, pp, jax_pp):
    """U_0 == PCDL.Commit(h_0) for every step (the degree-1 host commit),
    and a device commit of the same coefficients agrees."""
    d, _, accs = loaded
    for a in accs:
        assert pcdl.commit(list(a.pi_V.h), d, None, pp) == a.pi_V.U == jpcdl.commit(list(a.pi_V.h), d, None, jax_pp)
    coeffs = accs[0].pi_V.h + [0] * 7
    assert pcdl.commit(coeffs, d, None, pp) == accs[0].pi_V.U


def test_deferred_check_small_degree(pp):
    """Below 128 points the deciders' deferred MSM is the exact row ladder:
    U == Commit(h) holds for the right U and fails for another."""
    rng = np.random.default_rng(3)
    xis = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(5)]  # lg n = 4
    h = pcdl.HPoly(xis)
    coeffs = FR.to_ints(poly.tensor_h_coeffs(FR.from_ints(xis)))
    U = F.p_msm(coeffs, pp.gs_host(16))
    ok = pcdl._deferred(FR.from_ints(h.xis * 2).reshape(L, 2, -1), cv.from_affine_ints([U, F.p_add(U, U)]), pp)
    assert ok.tolist() == [True, False]


def test_verify_chain_accepts(loaded, pp):
    d, qss, accs = loaded
    chain.verify_chain_fast(d, qss[:2], accs[:2], pp)


def test_decide_many_accepts(loaded, pp):
    chain.verify_chain_slow(loaded[2][:2], pp)


def test_verify_chain_rejects_tampered_v(loaded, pp):
    d, qss, accs = loaded
    with pytest.raises(ValueError) as e:
        chain.verify_chain_fast(d, qss[:1], [bump_v(accs[0])], pp)
    assert str(e.value) == "h(z) != v at step 0"


def test_verify_chain_rejects_tampered_proof(loaded, pp):
    """A proof's c enters no challenge, so every host-side check still
    passes and the batched device row equation has to catch it."""
    d, qss, accs = loaded
    q = qss[0][0]
    bad = acc_mod.Instance(q.C, q.d, q.z, q.v, dataclasses.replace(q.pi, c=(q.pi.c + 1) % F.R))
    with pytest.raises(ValueError) as e:
        chain.verify_chain_fast(d, [[bad]], accs[:1], pp)
    assert str(e.value) == "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"


def test_decide_many_rejects_tampered_v(loaded, pp):
    accs = loaded[2]
    with pytest.raises(ValueError) as e:
        chain.verify_chain_slow([bump_v(accs[0])], pp)
    assert str(e.value) == "C_(log_n) != CM.Commit_Sigma(c || v') (batch index 0)"


def test_port_imports_no_jax():
    """The port, its prover included, loads and runs without JAX: an
    opening proof at n = 2 is made and checked, and the chain builder is
    importable, with no jax, jaxlib or JAX-package module loaded."""
    code = (
        "import sys, numpy as np, halo_accumulation_tpu_torch\n"
        "from halo_accumulation_tpu_torch import acc, chain, pcdl, pp, runtime\n"
        "from halo_accumulation_tpu_torch.ops import cuda_kernels, curve, field, msm, poly\n"
        "assert chain.build_chain is halo_accumulation_tpu_torch.build_chain and acc.prover\n"
        "p = pp.get_pp(2, 'cpu')\n"
        "C = pcdl.commit([3, 4], 1, None, p)\n"
        "pi = pcdl.open_(np.random.default_rng(0), [3, 4], C, 1, 5, None, p)\n"
        "pcdl.check(C, 1, 5, 23, pi, p)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'halo_accumulation_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_jax_pp_from_port_urs(pp, jax_pp):
    """The URS crosses packages through numpy unchanged."""
    assert np.array_equal(np.asarray(jax_pp.gs_x), pp_mod.to_numpy(pp)[0])
    assert jax_pp.gs_host(4) == pp.gs_host(4)

"""PCDL end-to-end: commit -> open -> succinct_check / check, hiding and
non-hiding, plus the generator-fold identity.  Mirrors the reference tests
pcdl.rs:382-438 (test_u_check), :441-461 (test_check), :464-483
(test_check_no_hiding)."""

import numpy as np
import pytest

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu import pcdl
from halo_accumulation_tpu import pp as pp_mod


N_URS = 64


@pytest.fixture(scope="module")
def pp():
    return pp_mod.get_pp(N_URS, use_disk_cache=True)


def rand_fr(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)]


def eval_host(coeffs, z):
    zp, v = 1, 0
    for c in coeffs:
        v = (v + c * zp) % F.R
        zp = zp * z % F.R
    return v


@pytest.mark.slow  # 484 s cold in tier-1, its four cases; tests the JAX reference; run with -m slow
@pytest.mark.parametrize("hiding", [False, True], ids=["plain", "hiding"])
@pytest.mark.parametrize("n", [8, 32])
def test_check_e2e(rng, pp, hiding, n):
    d = n - 1
    d_prime = int(rng.integers(1, d))
    p = rand_fr(rng, d_prime + 1)
    w = rand_fr(rng, 1)[0] if hiding else None
    C = pcdl.commit(p, d, w, pp)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    pi = pcdl.open_(rng, p, C, d, z, w, pp)
    # succinct + full check pass
    h, U = pcdl.succinct_check(C, d, z, v, pi, pp)
    assert U == pi.U
    pcdl.check(C, d, z, v, pi, pp)
    # wrong evaluation must fail
    with pytest.raises(ValueError):
        pcdl.succinct_check(C, d, z, (v + 1) % F.R, pi, pp)
    # tampered proof must fail
    bad = pcdl.EvalProof(pi.Ls, pi.Rs, pi.U, (pi.c + 1) % F.R, pi.C_bar, pi.w_prime)
    with pytest.raises(ValueError):
        pcdl.succinct_check(C, d, z, v, bad, pp)


@pytest.mark.slow
def test_check_e2e_1024(rng):
    """One d+1 = 2^10 end-to-end (larger than the reference's test degrees,
    pcdl.rs:441-461 caps at 2^9): exercises the width-class ladder of the
    open() inner loop and the multi-group MSM at a realistic size."""
    # prefix-sliced from the largest cached URS (pp.get_pp): regeneration
    # here cost minutes of XLA:CPU compiles and was the suite's sinkhole
    pp1k = pp_mod.get_pp(1024)
    d = 1023
    p = rand_fr(rng, 700)  # deg 699: pads through non-pow2 width classes
    w = rand_fr(rng, 1)[0]
    C = pcdl.commit(p, d, w, pp1k)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    pi = pcdl.open_(rng, p, C, d, z, w, pp1k)
    pcdl.check(C, d, z, v, pi, pp1k)
    with pytest.raises(ValueError):
        pcdl.check(C, d, z, (v + 1) % F.R, pi, pp1k)


def test_u_equals_h_commit(rng, pp):
    """U returned by open == commit(h coefficients) (the decider identity,
    pcdl.rs:382-438)."""
    n = 16
    d = n - 1
    p = rand_fr(rng, n)  # full degree
    C = pcdl.commit(p, d, None, pp)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    pi = pcdl.open_(rng, p, C, d, z, None, pp)
    h, U = pcdl.succinct_check(C, d, z, v, pi, pp)
    from halo_accumulation_tpu.ops.field import FR
    from halo_accumulation_tpu.runtime import cached_jit
    from halo_accumulation_tpu.ops import poly as poly_mod

    hc = cached_jit(poly_mod.tensor_h_coeffs, len(h.xis))(FR.from_ints(h.xis))
    assert pcdl.commit(hc, d, None, pp) == U


def test_commit_homomorphism(rng, pp):
    """Pedersen homomorphism (pedersen.rs:54-63)."""
    l, d = 16, 31
    m1, m2 = rand_fr(rng, l), rand_fr(rng, l)
    w1, w2 = rand_fr(rng, 2)
    lhs = pcdl.commit([(a + b) % F.R for a, b in zip(m1, m2)], d, (w1 + w2) % F.R, pp)
    rhs = F.p_add(pcdl.commit(m1, d, w1, pp), pcdl.commit(m2, d, w2, pp))
    assert lhs == rhs


@pytest.mark.slow  # 1,230 s cold in tier-1; tests the JAX reference; run with -m slow
def test_open_device_matches_host(rng, monkeypatch):
    """The device-transcript fused open (_open_fold_device: on-device SHA3
    challenges, H'-as-basis-columns, fused fori ladder) must produce
    BYTE-IDENTICAL proofs to the host-hashed path at a degree above the
    small-width ladder shortcut."""
    n = 512
    pp5 = pp_mod.get_pp(n)
    d = n - 1
    p = rand_fr(rng, 300)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    from halo_accumulation_tpu.ops.field import FR

    cd = FR.from_ints(p)
    C = pcdl.commit(cd, d, None, pp5)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "0")
    pi_host = pcdl.open_(np.random.default_rng(1), cd, C, d, z, None, pp5)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "1")
    pi_dev = pcdl.open_(np.random.default_rng(1), cd, C, d, z, None, pp5)
    assert pi_dev.serialize() == pi_host.serialize()
    pcdl.check(C, d, z, v, pi_dev, pp5)
    # hiding variant through the same fused graph
    w = rand_fr(rng, 1)[0]
    Ch = pcdl.commit(cd, d, w, pp5)
    pi_h = pcdl.open_(np.random.default_rng(2), cd, Ch, d, z, w, pp5)
    pcdl.check(Ch, d, z, v, pi_h, pp5)


@pytest.mark.slow  # 431 s cold in tier-1; tests the JAX reference; run with -m slow
def test_open_device_collapse_matches_host(rng, monkeypatch):
    """The basis-collapse segments (fold-by-16 every 4 rounds,
    msm.fold_basis) must preserve bit-identical proofs: force the collapse
    at n=512 by lowering the width threshold (production threshold is
    2048; the math is width-independent)."""
    n = 512
    pp5 = pp_mod.get_pp(n)
    d = n - 1
    p = rand_fr(rng, 450)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    from halo_accumulation_tpu.ops.field import FR

    cd = FR.from_ints(p)
    C = pcdl.commit(cd, d, None, pp5)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "0")
    pi_host = pcdl.open_(np.random.default_rng(1), cd, C, d, z, None, pp5, v=v)
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "1")
    monkeypatch.setattr(pcdl, "_COLLAPSE_MIN", 512)
    pi_dev = pcdl.open_(np.random.default_rng(1), cd, C, d, z, None, pp5, v=v)
    assert pi_dev.serialize() == pi_host.serialize()
    pcdl.check(C, d, z, v, pi_dev, pp5)

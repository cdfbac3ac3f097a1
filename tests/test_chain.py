"""Chain-level tests: batched verify_chain vs step-by-step semantics,
accumulator checkpoint roundtrip, and the public API facade.

Mirrors the reference's E2E test style (acc.rs:298-315) plus the benchmark
helpers' chain shape (benches/acc.rs:76-106)."""

import pytest

from halo_accumulation_tpu import acc as acc_mod
from halo_accumulation_tpu import api, chain, fields as F
from halo_accumulation_tpu import pp as pp_mod

pytestmark = pytest.mark.slow  # 2,119 s cold in tier-1, its six tests; tests the JAX reference; run with -m slow


@pytest.fixture(scope="module")
def pp():
    return pp_mod.get_pp(16, use_disk_cache=True)


def test_verify_chain_matches_stepwise(rng, pp):
    d, qss, accs = chain.build_chain(rng, 16, 3, pp)
    # step-by-step (the reference's literal fast helper, acc.rs:64-74)
    for qs, a in zip(qss, accs):
        acc_mod.verifier(d, qs, a, pp)
    acc_mod.decider(accs[-1], pp)
    # batched fast path must accept the same chain
    chain.verify_chain_fast(d, qss, accs, pp)
    # slow path: decider at every step
    chain.verify_chain_slow(accs, pp)


def test_verify_chain_rejects_tampering(rng, pp):
    d, qss, accs = chain.build_chain(rng, 16, 2, pp)
    bad = acc_mod.Accumulator(
        C_bar=accs[-1].C_bar,
        d=accs[-1].d,
        z=accs[-1].z,
        v=(accs[-1].v + 1) % F.R,
        pi=accs[-1].pi,
        pi_V=accs[-1].pi_V,
    )
    with pytest.raises(ValueError):
        chain.verify_chain_fast(d, qss, accs[:-1] + [bad], pp)
    # tampered succinct-check input in a middle step
    q0 = qss[0][0]
    bad_q = acc_mod.Instance(C=q0.C, d=q0.d, z=q0.z, v=(q0.v + 1) % F.R, pi=q0.pi)
    with pytest.raises(ValueError):
        chain.verify_chain_fast(d, [[bad_q]] + qss[1:], accs, pp)


def test_accumulator_serialize_roundtrip(rng, pp):
    d, qss, accs = chain.build_chain(rng, 16, 2, pp)
    a = accs[-1]
    blob = acc_mod.serialize_accumulator(a)
    b = acc_mod.deserialize_accumulator(blob)
    assert (b.C_bar, b.d, b.z, b.v) == (a.C_bar, a.d, a.z, a.v)
    assert b.pi == a.pi
    assert (b.pi_V.h, b.pi_V.U, b.pi_V.w) == (a.pi_V.h, a.pi_V.U, a.pi_V.w)
    # the deserialized accumulator still verifies and decides
    acc_mod.verifier(d, qss[-1], b, pp)
    acc_mod.decider(b, pp)
    # roundtrip is byte-stable
    assert acc_mod.serialize_accumulator(b) == blob


def test_chain_save_load_roundtrip(rng, pp, tmp_path):
    d, qss, accs = chain.build_chain(rng, 16, 2, pp)
    path = tmp_path / "chain.bin"
    chain.save_chain(path, d, qss, accs)
    d2, qss2, accs2 = chain.load_chain(path)
    assert d2 == d and len(qss2) == len(qss) and len(accs2) == len(accs)
    for qs, qs2 in zip(qss, qss2):
        assert [(q.C, q.d, q.z, q.v, q.pi) for q in qs] == [
            (q.C, q.d, q.z, q.v, q.pi) for q in qs2
        ]
    # the loaded chain still passes full verification
    chain.verify_chain_fast(d2, qss2, accs2, pp)


def test_api_smoke(rng, pp):
    d = pp.d
    p = [1, 2, 3, 4]
    C = api.commit(p, d=d, w=None, pp=pp)
    z = 7
    v = api.eval_poly(p, z)
    pi = api.open(rng, p, C, d=d, z=z, w=None, pp=pp)
    api.check(C, d=d, z=z, v=v, pi=pi, pp=pp)
    with pytest.raises(ValueError):
        api.check(C, d=d, z=z, v=(v + 1) % F.R, pi=pi, pp=pp)
    q = chain.random_instance(rng, d, pp)
    a = api.accumulate(rng, d, [q], pp)
    api.verify(d, [q], a, pp)
    api.decide(a, pp)


def test_decide_many_rejects_tampering(rng, pp):
    """The batched slow path (one combined verdict fetch) must reject
    exactly like per-step decider() calls."""
    d, qss, accs = chain.build_chain(rng, 16, 2, pp)
    chain.verify_chain_slow(accs, pp)  # accepts the honest chain
    bad = acc_mod.Accumulator(
        C_bar=accs[0].C_bar,
        d=accs[0].d,
        z=accs[0].z,
        v=(accs[0].v + 1) % F.R,
        pi=accs[0].pi,
        pi_V=accs[0].pi_V,
    )
    with pytest.raises(ValueError):
        chain.verify_chain_slow([bad, accs[1]], pp)

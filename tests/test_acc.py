"""ASDL end-to-end accumulation chain (mirrors acc.rs:264-315
test_acc_scheme): random instances accumulated step by step, verifier at
each step, decider at the end; rejection paths covered."""

import pytest

from halo_accumulation_tpu import acc as acc_mod
from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu import pcdl
from halo_accumulation_tpu import pp as pp_mod

pytestmark = pytest.mark.slow  # 424 s cold in tier-1, its two tests; tests the JAX reference; run with -m slow

N_URS = 16


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


def random_instance(rng, d, pp):
    d_prime = int(rng.integers(1, d))
    p = rand_fr(rng, d_prime + 1)
    w = rand_fr(rng, 1)[0]
    C = pcdl.commit(p, d, w, pp)
    z = rand_fr(rng, 1)[0]
    v = eval_host(p, z)
    pi = pcdl.open_(rng, p, C, d, z, w, pp)
    return acc_mod.Instance(C, d, z, v, pi)


def test_acc_scheme(rng, pp):
    d = N_URS - 1
    steps = 4
    acc = None
    for _ in range(steps):
        q = random_instance(rng, d, pp)
        qs = [acc.to_instance(), q] if acc is not None else [q]
        acc = acc_mod.prover(rng, d, qs, pp)
        acc_mod.verifier(d, qs, acc, pp)
    acc_mod.decider(acc, pp)


def test_acc_rejects_tampering(rng, pp):
    d = N_URS - 1
    q = random_instance(rng, d, pp)
    acc = acc_mod.prover(rng, d, [q], pp)
    acc_mod.verifier(d, [q], acc, pp)
    # tampered v
    bad = acc_mod.Accumulator(acc.C_bar, acc.d, acc.z, (acc.v + 1) % F.R, acc.pi, acc.pi_V)
    with pytest.raises(ValueError):
        acc_mod.verifier(d, [q], bad, pp)
    with pytest.raises(ValueError):
        acc_mod.decider(bad, pp)
    # tampered instance (verifier re-runs the succinct checks)
    q_bad = acc_mod.Instance(q.C, q.d, q.z, (q.v + 1) % F.R, q.pi)
    with pytest.raises(ValueError):
        acc_mod.verifier(d, [q_bad], acc, pp)

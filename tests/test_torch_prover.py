"""Port parity of the prover: the IPA opening, the accumulation prover and
the chain builder.

The same numpy rng goes to both packages, and the proof bytes must be equal.
At the committed chains' smallest width (n = 512) a prover step takes
minutes in the plain PyTorch twins on the CPU, so here the prover runs at
n = 8 (the exact-ladder branch of open_): random_instance and acc.prover
must write the JAX package's bytes.  tests/test_torch_cuda.py rebuilds the
first step of chain_512_10.bin byte for byte on the card under both MSM
settings (chip_smoke.py does the same at n = 16384).  Proof bytes depend on
MSM results only through canonical points, so the JAX side's ladder MSMs
and its succinct checks' row MSM run on the int oracle here: the JAX MSMs
and the port's are held to each other in tests/test_torch_msm.py, and their
XLA compile would take most of a minute on the CPU.  The row-permutation
decider runs on a one-step prefix of chain_512_10.bin."""

import pathlib

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import acc as jacc_mod, chain as jchain, pcdl as jpcdl, pp as jpp
from halo_accumulation_tpu.ops import curve as jcv, msm as jmsm
from halo_accumulation_tpu.ops.field import FR as JFR
from halo_accumulation_tpu_torch import acc as acc_mod, chain, fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import msm
from halo_accumulation_tpu_torch.ops.field import FR
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHAIN_512 = ROOT / ".chain_cache" / "chain_512_10.bin"
N = 8


@pytest.fixture(scope="module")
def pp():
    return pp_mod.get_pp(N, "cpu")


@pytest.fixture(scope="module")
def jax_pp(pp):
    gx, gy, s, h = pp_mod.to_numpy(pp)
    return jpp.PublicParams(pp.n, gx, gy, s, h)


@pytest.fixture(scope="module")
def instance(pp):
    """The port's random_instance(default_rng(7), 7): (instance, the rng after it)."""
    rng = np.random.default_rng(7)
    return chain.random_instance(rng, N - 1, pp), rng


@pytest.fixture(scope="module")
def accumulator(instance, pp):
    """The port's prover on [instance], from default_rng(8)."""
    return acc_mod.prover(np.random.default_rng(8), N - 1, [instance[0]], pp)


def _oracle_ladder(points, scalars):
    """The JAX package's msm_ladder on the int oracle: the same canonical
    point, no XLA compile."""
    host = jpcdl.points_to_host([jcv.PointVec(points.x[:, i], points.y[:, i], points.z[:, i])
                                 for i in range(points.x.shape[1])])
    P = jcv.from_affine_ints([F.p_msm(_jints(scalars), host)])
    return jcv.PointVec(P.x[:, 0], P.y[:, 0], P.z[:, 0])


def _oracle_succinct_check_batch(checks, pp, mesh=None, axis=None):
    """The JAX package's succinct_check_batch with its row MSM on the int
    oracle: the same transcript replay, verdicts and error text."""
    out = []
    for b, chk in enumerate(checks):
        h, pts, scs = jpcdl.succinct_check_parts(*chk, pp)
        if F.p_msm(scs, pts) is not None:
            raise ValueError(f"C_(log_n) != CM.Commit_Sigma(c || v') (batch index {b})")
        out.append((h, chk[4].U))
    return out


@pytest.fixture(scope="module")
def jax_instance(jax_pp):
    """The JAX package's random_instance(default_rng(7), 7) on the int
    oracle's MSMs: (instance, the rng after it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsm, "msm_ladder", _oracle_ladder)
        rng = np.random.default_rng(7)
        return jchain.random_instance(rng, N - 1, jax_pp), rng


@pytest.fixture(scope="module")
def jax_accumulator(jax_instance, jax_pp):
    """The JAX package's prover on [its instance] from default_rng(8), on
    the int oracle's MSMs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsm, "msm_ladder", _oracle_ladder)
        mp.setattr(jpcdl, "succinct_check_batch", _oracle_succinct_check_batch)
        return jacc_mod.prover(np.random.default_rng(8), N - 1, [jax_instance[0]], jax_pp)


def _jints(a):
    return [int(v) for v in np.atleast_1d(JFR.to_ints(a))]


def _jfr(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("m", [16, 2, 1])
def test_open_round_helpers_match_jax(rng, m):
    """One round's pre-fold scalars, routes and dot products, and its fold,
    equal the JAX package's (canonical values; width 32, half-width m)."""
    n = 32
    cs, zs, t = (FR.from_ints([int.from_bytes(rng.bytes(40), "little") for _ in range(n)]) for _ in range(3))
    cs[:, 2 * m :] = 0
    zs[:, 2 * m :] = 0
    xi, xi_inv = (FR.from_ints([v])[:, 0] for v in (12345, pow(12345, -1, F.R)))
    got = pcdl._open_round_pre(cs, zs, t, m)
    want = jpcdl._open_round_pre(_jfr(cs), _jfr(zs), _jfr(t), m)
    assert torch.equal(got[1], torch.from_numpy(np.asarray(want[1]).astype(np.int64)))
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert FR.to_ints(g) == _jints(w)
    got = pcdl._open_round_fold(cs, zs, t, m, xi, xi_inv)
    want = jpcdl._open_round_fold(_jfr(cs), _jfr(zs), _jfr(t), m, _jfr(xi), _jfr(xi_inv))
    for g, w in zip(got, want):
        assert FR.to_ints(g) == _jints(w)
    s_comb, route = pcdl._open_round_pre(cs, zs, t, m)[:2]
    for g, w in zip(msm._split_routes(s_comb, route), jpcdl._split_routes(_jfr(s_comb), np.asarray(route))):
        assert FR.to_ints(g) == _jints(w)
    # q of 7 coefficients, as in open_ at n = 8: the JAX prover compiles the same shapes
    q = FR.from_ints([int.from_bytes(rng.bytes(40), "little") for _ in range(7)])
    assert FR.to_ints(pcdl._mul_by_linear(q, xi)) == _jints(jpcdl._mul_by_linear(_jfr(q), _jfr(xi)))
    a = FR.from_ints(list(range(8)))
    assert FR.to_ints(pcdl._add_scaled(a, pcdl._mul_by_linear(q, xi), xi)) == _jints(
        jpcdl._add_scaled(_jfr(a), jpcdl._mul_by_linear(_jfr(q), _jfr(xi)), _jfr(xi)))


def test_random_instance_matches_jax(instance, jax_instance):
    """random_instance from default_rng(7): the same instance bytes (commit,
    hiding, every round's L and R, U, c, C_bar, w'), and the rng left in
    the same state, as the JAX package's."""
    (q, prng), (jq, jrng) = instance, jax_instance
    assert q.serialize() == jq.serialize()
    assert prng.bytes(8) == jrng.bytes(8)


def test_prover_matches_jax(accumulator, jax_accumulator):
    """acc.prover on [that instance] from default_rng(8) writes the JAX
    package's accumulator bytes (C_bar, z, v, the hiding opening proof,
    h_0, U_0, w)."""
    assert acc_mod.serialize_accumulator(accumulator) == jacc_mod.serialize_accumulator(jax_accumulator)


def test_prover_step_verifies(instance, accumulator, pp):
    """The accumulator from acc.prover passes verify_chain and decide_many,
    and a tampered v is rejected."""
    q, acc = instance[0], accumulator
    chain.verify_chain_fast(N - 1, [[q]], [acc], pp)
    chain.verify_chain_slow([acc], pp)
    bad = acc_mod.Accumulator(acc.C_bar, acc.d, acc.z, (acc.v + 1) % F.R, acc.pi, acc.pi_V)
    with pytest.raises(ValueError, match=r"^h\(z\) != v at step 0$"):
        chain.verify_chain_fast(N - 1, [[q]], [bad], pp)


def test_save_chain_roundtrip(instance, accumulator, tmp_path):
    """save_chain writes the tagged layout; both packages load it back to
    the same records."""
    q, acc = instance[0], accumulator
    path = tmp_path / "chain.bin"
    chain.save_chain(path, N - 1, [[q]], [acc])
    assert path.read_bytes()[:8] == chain.CHAIN_MAGIC
    d, qss, accs = chain.load_chain(path)
    jd, jqss, jaccs = jchain.load_chain(path)
    assert d == jd == N - 1
    assert chain.step_records(qss, accs) == chain.step_records([[q]], [acc])
    assert [x.serialize() for x in jqss[0]] == [q.serialize()]
    assert [jacc_mod.serialize_accumulator(a) for a in jaccs] == [acc_mod.serialize_accumulator(acc)]


def test_rowperm_verifiers_accept_committed_prefix(monkeypatch):
    """Under HALO_TPU_MSM_IMPL=rowperm the deciders commit each claim through
    the row-permutation MSM over the URS's affine rows: a one-step prefix of
    chain_512_10.bin is accepted by the decider.  verify_chain's final
    decider runs the same deferred MSM; both verifiers run on the whole
    chain under rowperm in tests/test_torch_cuda.py."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "rowperm")
    d, qss, accs = chain.load_chain(CHAIN_512)
    pp512 = pp_mod.get_pp(d + 1, "cpu")
    chain.verify_chain_slow(accs[:1], pp512)

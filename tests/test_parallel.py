"""Sharded MSM on the virtual 8-device CPU mesh == single-device result.
(The reference has no distributed layer; this is the psum/all-gather
equivalent demanded by the TPU build - SURVEY.md section 2 parallelism.)

Covers N >= 1024 (above the round-1 TPU fused-kernel failure threshold:
the sharded path must only ever use the staged stage-1 kernel) and a
non-power-of-two device split."""

import os

import numpy as np
import pytest

import jax

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu.ops import curve as cv, msm
from halo_accumulation_tpu.ops.field import FR
from halo_accumulation_tpu.parallel import msm_sharded as pms
from halo_accumulation_tpu.pcdl import point_to_host
from halo_accumulation_tpu.runtime import cached_jit


def _random_problem(rng, N):
    G = (F.G_X, F.G_Y)
    pts = [F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, G) for _ in range(N)]
    ss = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(N)]
    return pts, ss


_HEAVY = os.environ.get("HALO_TEST_HEAVY", "0") != "0"


@pytest.mark.parametrize(
    "n_dev,N",
    [(8, 64), (3, 96),
     pytest.param(8, 256, marks=pytest.mark.slow)]  # 129 s cold in tier-1; tests the JAX reference; run with -m slow
    # N=1024 covers window grouping/padding above the small-N regime
    # (ADVICE r4 low); ~10 min of XLA:CPU compile, so opt-in.
    + ([(8, 1024)] if _HEAVY else []),
)
def test_msm_sharded_matches(rng, n_dev, N):
    assert len(jax.devices()) == 8, f"expected 8 virtual devices, got {len(jax.devices())}"
    mesh = pms.make_mesh(n_dev)
    pts, ss = _random_problem(rng, N)
    P = cv.from_affine_ints(pts)
    s = FR.from_ints(ss)
    want = F.p_msm(ss, pts)

    Psh = pms.shard_points(P, mesh)
    R = pms.msm_sharded(Psh, s, mesh)
    assert point_to_host(R) == want
    # must agree with the staged single-device MSM bit-for-bit
    R1 = msm.msm(P, s)
    assert bool(np.asarray(cached_jit(cv.peq)(R, R1)))


@pytest.mark.slow  # 315 s cold in tier-1; tests the JAX reference; run with -m slow
def test_open_fold_sharded_matches(rng):
    """Degree-axis ("sequence parallel") sharding of the IPA open fold:
    gs/cs/zs sharded over the mesh must produce the bit-identical proof."""
    from halo_accumulation_tpu import chain, pcdl
    from halo_accumulation_tpu import pp as pp_mod

    pp = pp_mod.get_pp(16, use_disk_cache=True)
    mesh = pms.make_mesh(8)
    d = 15
    coeffs = [chain.rand_scalar(rng) for _ in range(d + 1)]
    z = chain.rand_scalar(rng)
    v = 0
    zp = 1
    for co in coeffs:
        v = (v + co * zp) % F.R
        zp = zp * z % F.R
    C = pcdl.commit(FR.from_ints(coeffs), d, None, pp)
    pi_single = pcdl.open_(rng, FR.from_ints(coeffs), C, d, z, None, pp)
    pi_sharded = pcdl.open_(rng, FR.from_ints(coeffs), C, d, z, None, pp, mesh=mesh, axis=pms.AXIS)
    assert pi_sharded.serialize() == pi_single.serialize()
    pcdl.check(C, d, z, v, pi_sharded, pp)


@pytest.mark.slow  # 670 s cold in tier-1; tests the JAX reference; run with -m slow
def test_verify_chain_sharded(rng):
    """The headline fast path with a mesh: batched succinct checks + U_0
    rows sharded over the instance axis, decider's n-MSM sharded over
    points - must accept a valid chain and reject a tampered one, exactly
    like the single-device path."""
    from halo_accumulation_tpu import acc as acc_mod, chain
    from halo_accumulation_tpu import pp as pp_mod

    pp = pp_mod.get_pp(16, use_disk_cache=True)
    mesh = pms.make_mesh(8)
    d, qss, accs = chain.build_chain(rng, 16, 2, pp)
    acc_mod.verify_chain(d, qss, accs, pp, mesh=mesh, axis=pms.AXIS)
    acc_mod.verify_chain(d, qss, accs, pp)
    bad = acc_mod.Accumulator(
        accs[-1].C_bar, accs[-1].d, accs[-1].z, (accs[-1].v + 1) % F.R,
        accs[-1].pi, accs[-1].pi_V,
    )
    with pytest.raises(ValueError):
        acc_mod.verify_chain(d, qss, accs[:-1] + [bad], pp, mesh=mesh, axis=pms.AXIS)


@pytest.mark.slow  # 201 s cold in tier-1; tests the JAX reference; run with -m slow
def test_succinct_check_batch_sharded(rng):
    """Instance-batch (dp) sharding of the batched succinct check."""
    from halo_accumulation_tpu import chain, pcdl
    from halo_accumulation_tpu import pp as pp_mod

    pp = pp_mod.get_pp(16, use_disk_cache=True)
    mesh = pms.make_mesh(4)
    qs = [chain.random_instance(rng, 15, pp) for _ in range(2)]
    checks = [(q.C, q.d, q.z, q.v, q.pi) for q in qs] * 4
    res = pcdl.succinct_check_batch(checks, pp, mesh=mesh, axis=pms.AXIS)
    assert len(res) == len(checks)
    # a corrupted row is still caught through the sharded path
    q0 = qs[0]
    bad = [(q0.C, q0.d, q0.z, (q0.v + 1) % F.R, q0.pi)] + checks[1:]
    with pytest.raises(ValueError):
        pcdl.succinct_check_batch(bad, pp, mesh=mesh, axis=pms.AXIS)

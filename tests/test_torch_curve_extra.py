"""The port's curve ops that only tests and tools call, against the JAX
package: padd_mixed (with the q_inf mask), scalar_bits_msb and
gather_points on the same seeded inputs (the JAX functions run eagerly, no
jit), and pmul_shared against the int oracle, as tests/test_curve.py holds
the JAX one.  Points compare as canonical affine values; bits and gathered
limbs exactly."""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu.ops import curve as jcv
from halo_accumulation_tpu.ops.field import FQ as JFQ, FR as JFR
from halo_accumulation_tpu_torch import fields as F
from halo_accumulation_tpu_torch.ops import cuda_kernels as ck, curve as cv
from halo_accumulation_tpu_torch.ops.field import FQ, FR, limb_array_to_ints

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def rand_points(rng, n):
    return [F.p_mul(int.from_bytes(rng.bytes(40), "little") % F.R, (F.G_X, F.G_Y)) for _ in range(n)]


def host(P) -> list:
    """A JAX or port PointVec (18, n) -> host affine ints / None."""
    x, y, z = (limb_array_to_ints(np.asarray(c).astype(np.int64)) for c in P)
    return [cv.affine_int(a, b, c) for a, b, c in zip(x, y, z)]


def test_padd_mixed_matches_jax():
    """P + (qx, qy) over random lanes, P == Q, P == -Q, P the identity and
    a masked lane (q_inf) that must return P; with and without the mask."""
    rng = np.random.default_rng(11)
    A = rand_points(rng, 6) + [None, None]
    B = rand_points(rng, 4) + [A[0], F.p_neg(A[1]), rand_points(rng, 1)[0], A[3]]
    inf = [False] * 7 + [True]
    xs = [b[0] for b in B]
    ys = [b[1] for b in B]
    P, jP = cv.from_affine_ints(A), jcv.from_affine_ints(A)
    for mask in (None, inf):
        got = cv.padd_mixed(P, FQ.from_ints(xs), FQ.from_ints(ys), None if mask is None else torch.tensor(mask))
        want = jcv.padd_mixed(jP, JFQ.from_ints(xs), JFQ.from_ints(ys), None if mask is None else np.array(mask))
        assert host(got) == host(want)
        assert host(got) == [a if mask and m else F.p_add(a, b) for a, b, m in zip(A, B, inf)]


@pytest.mark.parametrize("nbits", [255, 8, 16])
def test_scalar_bits_msb_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    for k in [0, 1, F.R - 1, 1 << 254, int.from_bytes(rng.bytes(40), "little") % F.R]:
        got = cv.scalar_bits_msb(FR.from_ints([k])[:, 0], nbits)
        want = np.asarray(jcv.scalar_bits_msb(JFR.from_ints([k])[:, 0], nbits))
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
        assert got.tolist() == [bool(k >> i & 1) for i in range(nbits - 1, -1, -1)]


def test_gather_points_matches_jax():
    """Gathers along batch axes 0 and 1 of a (18, 3, 4) vector, with a
    1-D and a 2-D index, give the JAX package's limbs."""
    rng = np.random.default_rng(5)
    pts = rand_points(rng, 11) + [None]
    P, jP = cv.from_affine_ints(pts), jcv.from_affine_ints(pts)
    P = cv.PointVec(*(c.reshape(18, 3, 4) for c in P))
    jP = jcv.PointVec(*(c.reshape(18, 3, 4) for c in jP))
    for axis, idx in ((0, [2, 0, 2]), (1, [[3, 0], [1, 1]]), (1, [0])):
        got = cv.gather_points(P, torch.tensor(idx), axis)
        want = jcv.gather_points(jP, np.array(idx), axis)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_pmul_shared_matches_oracle():
    """k P for one scalar k over five points and the identity equals the
    oracle's p_mul for k in 0, 1, 2, a random scalar and r - 1; each run
    calls the padd and pdbl wrappers 1 + 128 times each (their twins here)."""
    rng = np.random.default_rng(0xC0FFEE)
    A = rand_points(rng, 5) + [None]
    P = cv.from_affine_ints(A)
    calls = []
    real = ck.padd, ck.pdbl
    ck.padd = lambda *a: calls.append("padd") or real[0](*a)
    ck.pdbl = lambda *a: calls.append("pdbl") or real[1](*a)
    try:
        for k in [0, 1, 2, int.from_bytes(rng.bytes(40), "little") % F.R, F.R - 1]:
            calls.clear()
            assert cv.to_host(cv.pmul_shared(FR.from_ints([k])[:, 0], P)) == [F.p_mul(k, a) for a in A]
            assert calls.count("padd") == calls.count("pdbl") == 129
    finally:
        ck.padd, ck.pdbl = real

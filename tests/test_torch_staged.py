"""The staged backstop MSM of the port (ops/msm.py: HALO_TPU_MSM_IMPL=staged
and the measured-pad fallback) on the CPU twins.

Its host planning (bucket counts, measured and pinned pads, the pad check)
must equal the JAX package's on the same digits; its points must equal the
int oracle, stage by stage as well as whole, on random and adversarial
scalars (tests/test_msm.py's).  Every comparison is exact (canonical
affine points)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu.ops import msm as jmsm
from halo_accumulation_tpu_torch.ops import curve as cv, msm
from halo_accumulation_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

G = (F.G_X, F.G_Y)


def rand_scalars(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(n)]


def rand_points(rng, n):
    return [F.p_mul(s, G) for s in rand_scalars(rng, n)]


def point(R):
    return cv.to_host(R)[0]


@pytest.fixture
def staged(monkeypatch):
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "staged")


def test_planners_match_jax(rng):
    """_max_bucket_counts, _measure_pads / _measure_pad, _pads_ok,
    pinned_pads and _width_class equal the JAX package's: random digits,
    one bucket holding most of a row, a row of zeros (bucket 0 never
    counts) and a row of one digit."""
    for c, R, N in ((3, 6, 40), (4, 5, 33), (6, 4, 130)):
        d = rng.integers(0, 1 << c, (R, N))
        d[1, : N // 2] = 5
        d[2] = 0
        d[R - 1] = (1 << c) - 1
        td, jd = torch.from_numpy(d), jnp.asarray(d.astype(np.uint32))
        counts = msm._max_bucket_counts(td, c)
        assert counts.tolist() == np.asarray(jmsm._max_bucket_counts(jd, c)).tolist()
        assert counts[2] == 0 and counts[R - 1] == N
        pads = msm._measure_pads(td, c)
        assert pads == jmsm._measure_pads(jd, c) and msm._measure_pad(td, c, "k") == jmsm._measure_pad(jd, c, "k")
        for trial in (pads, [max(1, p // 2) for p in pads]):
            assert bool(msm._pads_ok(td, c, trial)) == bool(jmsm._pads_ok(jd, c, tuple(trial)))
        assert bool(msm._pads_ok(td, c, pads)) and not bool(msm._pads_ok(td, c, [1] * R))
    for n in (1, 37, 96, 128, 512, 2048, 16384, 65536):
        for c in (3, 4, 5, 8, 10):
            assert msm.pinned_pads(n, c) == jmsm.pinned_pads(n, c)
    for m in (1, 5, 100, 128, 129, 130, 512, 513, 2048, 8192, 8193):
        assert msm._width_class(m) == jmsm._width_class(m)


def test_staged_msm_vs_oracle(rng, staged):
    """msm under the staged setting (its measured pads), then the same
    bucket sums through stages 2 to 4 whole (_weight_and_combine) and one
    by one (_suffix_mask, _window_reduce, _horner_combine)."""
    n, c = 37, 4
    pts = rand_points(rng, n)
    pts[3] = None
    scs = rand_scalars(rng, n)
    scs[5] = 0
    want = F.p_msm(scs, pts)
    P, s = cv.from_affine_ints(pts), FR.from_ints(scs)
    assert point(msm.msm(P, s, c=c)) == want
    digits = msm._digits(s, c)
    S = msm._bucket_sums(P, digits, c, msm._measure_pad(digits, c))
    assert all(a.shape == (msm.num_windows(c), 18, 1 << c) for a in S)
    assert point(msm._weight_and_combine(S, c)) == want
    T = msm._suffix_mask(S, c)
    assert all(a.shape == S[0].shape for a in T)
    assert point(msm._horner_combine(msm._window_reduce(T), c)) == want


def test_staged_adversarial(rng, staged):
    """tests/test_msm.py's adversarial scalars under the staged setting:
    all equal (one bucket a window holds every point), zero-heavy, all
    zero, identity points, and scalars at the field's edge."""
    n = 64
    pts = rand_points(rng, n)
    P = cv.from_affine_ints(pts)

    def run(points, scalars):
        return point(msm.msm(cv.from_affine_ints(points) if points is not pts else P, FR.from_ints(scalars)))

    s_eq = [12345678901234567890] * n
    assert run(pts, s_eq) == F.p_msm(s_eq, pts)
    s_sparse = [7, 11] + [0] * (n - 2)
    assert run(pts, s_sparse) == F.p_msm(s_sparse, pts)
    assert run(pts, [0] * n) is None
    pts2 = pts[:4] + [None] * 4
    ss = rand_scalars(rng, 8)
    assert run(pts2, ss) == F.p_msm(ss, pts2)
    s_edge = [F.R - 1, 1, F.R - 2, 2] + [0] * 4
    assert run(pts2, s_edge) == F.p_msm(s_edge[:4], pts2[:4])

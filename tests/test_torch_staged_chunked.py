"""The staged MSM's point-chunked and window-group paths, forced with a
small scatter budget as tests/test_msm.py's test_msm_chunked_paths does
(c = 3, n = 96, budgets of 64 and 256 columns), against the int oracle;
and the chunk partials' complete-add combine."""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu_torch.ops import curve as cv, msm
from halo_accumulation_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

G = (F.G_X, F.G_Y)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0xC0FFEE)
    n = 96  # not a power of two: _pad_points runs inside the chunk loop
    scs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2 * n)]
    pts = [F.p_mul(k, G) for k in scs[n:]]
    return pts, scs[:n]


@pytest.mark.parametrize("budget", [64, 256])
def test_msm_chunked_paths(problem, budget, monkeypatch):
    """Budget 64: one window's matrix never fits, so the points go in
    chunks whose pads are re-measured; budget 256: several windows a
    dispatch.  Either way the oracle's point, and no scatter matrix past
    the budget."""
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "staged")
    monkeypatch.setattr(msm, "_SCATTER_BUDGET_COLS", budget)
    pts, scs = problem
    groups, chunks = [], []
    bs, bsc = msm._bucket_sums, msm._bucket_sums_chunk

    def spy_bs(points, digits, c, pad):
        chunks.append(points.x.shape[1])
        return bs(points, digits, c, pad)

    def spy_bsc(points, digits, c, pad):
        groups.append(digits.shape[0])
        assert (1 << c) * pad * digits.shape[0] <= budget or digits.shape[0] == 1
        return bsc(points, digits, c, pad)

    monkeypatch.setattr(msm, "_bucket_sums", spy_bs)
    monkeypatch.setattr(msm, "_bucket_sums_chunk", spy_bsc)
    R = msm.msm(cv.from_affine_ints(pts), FR.from_ints(scs), c=3)
    assert cv.to_host(R) == [F.p_msm(scs, pts)]
    if budget == 64:
        assert max(chunks) < len(pts)  # the points went in chunks
    else:
        assert max(groups) > 1  # windows went a group a dispatch


def test_combine_sums(problem):
    """_combine_sums adds two partial stacks bucket by bucket: the halves'
    bucket sums combined equal the whole vector's, as points."""
    pts, scs = problem
    c, n = 3, 32
    P, s = cv.from_affine_ints(pts[:n]), FR.from_ints(scs[:n])
    d = msm._digits(s, c)
    pad = msm._measure_pad(d, c)
    whole = msm._bucket_sums(P, d, c, pad)
    h = n // 2
    lo = msm._bucket_sums(cv.PointVec(*(a[:, :h] for a in P)), d[:, :h], c, pad)
    hi = msm._bucket_sums(cv.PointVec(*(a[:, h:] for a in P)), d[:, h:], c, pad)
    both = msm._combine_sums(lo, hi)
    flat = lambda S: cv.PointVec(*(a.movedim(0, 1) for a in S))  # noqa: E731
    assert bool(cv.peq(flat(both), flat(whole)).all())


def test_staged_pinned_budget_counts_every_bucket(problem, monkeypatch):
    """The one deliberate difference from the JAX package's routing: the
    staged branch of msm_flagged holds 2^c x pad to the scatter budget.
    With the budget at 512 and c = 4, the top window's pinned pad (48 over
    a cut bucket space of 8) passes the JAX package's beff x pad test and
    then fails its _bucket_sums assertion (16 x 48 > 512); the port sends
    the MSM to msm(), which measures, and gets the oracle's point."""
    from halo_accumulation_tpu.ops import curve as jcv, msm as jmsm
    from halo_accumulation_tpu.ops.field import FR as JFR

    pts, scs = problem
    pts, scs = pts[:37], scs[:37]
    c, pads = 4, msm.pinned_pads(37, 4)
    assert msm._beffs(c)[0] * pads[0] <= 512 < (1 << c) * pads[0]
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", "staged")
    monkeypatch.setattr(msm, "_SCATTER_BUDGET_COLS", 512)
    monkeypatch.setattr(jmsm, "_SCATTER_BUDGET_COLS", 512)
    measured, real = [], msm._msm_measured
    monkeypatch.setattr(msm, "_msm_measured", lambda *a: measured.append(1) or real(*a))
    R, ok = msm.msm_flagged(cv.from_affine_ints(pts), FR.from_ints(scs), c=c, pads=pads)
    assert bool(ok) and measured == [1]
    assert cv.to_host(R) == [F.p_msm(scs, pts)]
    with pytest.raises(AssertionError, match="caller must chunk points first"):
        jmsm.msm_flagged(jcv.from_affine_ints(pts), JFR.from_ints(scs), c=c, pads=pads)

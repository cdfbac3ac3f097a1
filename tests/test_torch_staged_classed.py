"""msm_classed (the width padded to its class, pinned pad classes at c = 5)
against the int oracle at widths 5, 100 and 130 with measured pads, as
tests/test_msm.py's test_msm_classed (the flagged variant is in
test_torch_staged_flags.py).  Widths up to 128 take the exact ladder; 130
pads to the 512 class and runs the staged pipeline.  Also msm_naive, the
binary-method reference, against msm."""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu_torch.ops import curve as cv, msm
from halo_accumulation_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

G = (F.G_X, F.G_Y)


@pytest.mark.parametrize("n", [5, 100, 130])
def test_msm_classed(n, monkeypatch, flagged=False):
    rng = np.random.default_rng(n)
    scs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(2 * n)]
    pts = [F.p_mul(k, G) for k in scs[n:]]
    scs = scs[:n]
    staged = []
    real = msm._staged_msm
    monkeypatch.setattr(msm, "_staged_msm", lambda *a: staged.append(a[2]) or real(*a))
    flags = [] if flagged else None
    R = msm.msm_classed(cv.from_affine_ints(pts), FR.from_ints(scs), flags=flags)
    assert cv.to_host(R) == [F.p_msm(scs, pts)]
    if flagged:
        assert len(flags) == 1 and bool(flags[0])
    assert staged == ([5] if n > msm._CLASS_MIN else [])


def test_msm_naive_matches():
    """The binary-method reference equals msm and the oracle at 16 points."""
    rng = np.random.default_rng(16)
    scs = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(32)]
    pts = [F.p_mul(k, G) for k in scs[16:]]
    P, s = cv.from_affine_ints(pts), FR.from_ints(scs[:16])
    R1 = msm.msm_naive(P, s)
    assert bool(cv.peq(R1, msm.msm(P, s)))
    assert cv.to_host(R1) == [F.p_msm(scs[:16], pts)]

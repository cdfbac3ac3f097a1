"""The pinned-pad overflow fallback under every MSM setting: a commitment
whose coefficients are all equal puts every point of a window in one
bucket, past any pinned pad, so pcdl.commit must finish through the staged
_msm_measured (as the JAX package's commit does, pcdl.py:214-217) and
still equal the sum the int oracle gives.  n = 128, the narrowest width
the sort-payload pipeline takes, with msm._LADDER_MAX lowered below it so
the commit does not take the exact ladder (it does up to 256 points)."""

import pytest
import torch

from halo_accumulation_tpu import fields as F
from halo_accumulation_tpu_torch import pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops import msm
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

N = 128


@pytest.fixture(scope="module")
def urs():
    return pp_mod.get_pp(N, "cpu")


@pytest.mark.parametrize("impl", ["sortrows", "rowperm", "staged"])
def test_overflowing_commit_takes_staged_measured(urs, impl, monkeypatch):
    monkeypatch.setenv("HALO_TPU_MSM_IMPL", impl)
    monkeypatch.setattr(msm, "_LADDER_MAX", N // 2)
    measured, staged = [], []
    real_measured, real_staged = msm._msm_measured, msm._staged_msm

    def spy_measured(points, scalars, c=None):
        measured.append(points.x.shape[1])
        return real_measured(points, scalars, c)

    def spy_staged(points, digits, c, pads, beffs):
        staged.append(pads)
        return real_staged(points, digits, c, pads, beffs)

    monkeypatch.setattr(msm, "_msm_measured", spy_measured)
    monkeypatch.setattr(msm, "_staged_msm", spy_staged)
    C = pcdl.commit([1] * N, N - 1, None, urs)
    want = None
    for g in urs.gs_host(N):
        want = F.p_add(want, g)
    assert C == want
    assert measured == [N]
    # the measured run: the last window holds all N points in bucket 1
    assert staged[-1][-1] == N and max(staged[-1][:-1]) == 1
    assert len(staged) == (2 if impl == "staged" else 1)  # staged also ran its pinned pass

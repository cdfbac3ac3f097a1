"""msm_classed with the deferred pinned-pad flag (its flags list), at the
widths of test_torch_staged_classed.py: the oracle's point and one True
flag a call."""

import pytest
import torch

from tests.test_torch_staged_classed import test_msm_classed as _classed

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


@pytest.mark.parametrize("n", [5, 100, 130])
def test_msm_classed_flags(n, monkeypatch):
    _classed(n, monkeypatch, flagged=True)

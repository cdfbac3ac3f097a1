"""One collapse segment of the device-transcript open (msm.fold_basis),
forced at n = 512 on the CPU by lowering pcdl._COLLAPSE_MIN to 512 (four
rounds at 512, the basis folded by 16, five rounds and U at 32), as the
JAX package's tests/test_pcdl.py does: the proof must equal the host
transcript's proof of test_torch_open_device.py's plain claim, made here
again, and pcdl.check must accept it.
"""

import torch

from halo_accumulation_tpu_torch import pcdl
from halo_accumulation_tpu_torch.ops import msm
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_open_device import D, _open_plain, _spy, claim, host_plain, pp  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def test_open_device_collapse_matches_host(pp, claim, host_plain, monkeypatch):  # noqa: F811
    """One collapse segment (msm.fold_basis) forced at n = 512."""
    monkeypatch.setattr(pcdl, "_COLLAPSE_MIN", 512)
    folds = _spy(monkeypatch, msm, "fold_basis")
    pi = _open_plain(pp, claim, True, monkeypatch)
    assert len(folds) == 1
    assert pi.serialize() == host_plain.serialize()
    cd, z, v, C = claim
    pcdl.check(C, D, z, v, pi, pp)

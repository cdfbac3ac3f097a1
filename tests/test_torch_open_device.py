"""The device-transcript IPA open (pcdl._open_device) against the host
transcript, at n = 512 on the CPU (the plain twins of every kernel).

HALO_TPU_OPEN_DEVICE=1 (the default) must write the host transcript's
EvalProof bytes for a random polynomial of degree 299, against the =0
open of the same claim, made once for the module; pcdl.check accepts the
device proof and no open takes the _safe rebuild.  Every comparison is
exact.  n = 512 is the narrowest width that takes the device path
(n > 256).  The hiding instance against chain_512_10.bin is in
test_torch_open_device_hiding.py, the forced collapse segment in
test_torch_open_device_collapse.py: each open takes about two minutes in
the CPU twins, so the three files run side by side.
"""

import numpy as np
import pytest
import torch

from halo_accumulation_tpu_torch import fields as F, pcdl, pp as pp_mod
from halo_accumulation_tpu_torch.ops.field import FR
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

N = 512
D = N - 1


@pytest.fixture(scope="module")
def pp():
    return pp_mod.get_pp(N, "cpu")


@pytest.fixture(scope="module")
def claim(pp):
    """(coefficients, z, v, C) of a random polynomial of degree 299."""
    rng = np.random.default_rng(20261017)
    p = [int.from_bytes(rng.bytes(40), "little") % F.R for _ in range(300)]
    z = int.from_bytes(rng.bytes(40), "little") % F.R
    v = sum(c * pow(z, i, F.R) for i, c in enumerate(p)) % F.R
    cd = FR.from_ints(p)
    return cd, z, v, pcdl.commit(cd, D, None, pp)


def _spy(monkeypatch, module, name: str) -> list:
    """Record the keyword arguments of every call of module.name."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _taking(device: bool, monkeypatch, make):
    """make() under HALO_TPU_OPEN_DEVICE=1 or 0, which must open once on
    that transcript and never take the _safe rebuild (no pad overflows
    here)."""
    monkeypatch.setenv("HALO_TPU_OPEN_DEVICE", "1" if device else "0")
    opens, devs = _spy(monkeypatch, pcdl, "open_"), _spy(monkeypatch, pcdl, "_open_device")
    out = make()
    assert len(devs) == int(device) and not any(kw.get("_safe") for kw in opens)
    return out


def _open_plain(pp, claim, device: bool, monkeypatch):
    cd, z, v, C = claim
    return _taking(device, monkeypatch, lambda: pcdl.open_(np.random.default_rng(1), cd, C, D, z, None, pp, v=v))


@pytest.fixture(scope="module")
def host_plain(pp, claim):
    """The host transcript's proof of the plain claim."""
    with pytest.MonkeyPatch.context() as mp:
        return _open_plain(pp, claim, False, mp)


@pytest.mark.parametrize("hiding", [False], ids=["plain"])
def test_open_device_matches_host(pp, claim, host_plain, hiding, monkeypatch):
    pi = _open_plain(pp, claim, True, monkeypatch)
    assert pi.serialize() == host_plain.serialize()
    cd, z, v, C = claim
    pcdl.check(C, D, z, v, pi, pp)

"""The device-transcript IPA open on a hiding instance at n = 512 on the
CPU: random_instance(default_rng(7), 511) under HALO_TPU_OPEN_DEVICE=1
opens once on the device transcript (no _safe rebuild) and must equal the
first instance of chain_512_10.bin, which the JAX package wrote (its host
and device transcripts write the same bytes, and the port's host
transcript is held to it by tests/test_torch_prover.py); pcdl.check
accepts it.  The plain claim is in test_torch_open_device.py.
"""

import pathlib

import numpy as np
import pytest
import torch

from halo_accumulation_tpu_torch import chain, pcdl
from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_open_device import D, _taking, pp  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

CHAIN_512 = pathlib.Path(__file__).resolve().parent.parent / ".chain_cache" / "chain_512_10.bin"


@pytest.mark.parametrize("hiding", [True], ids=["hiding"])
def test_open_device_matches_host(pp, hiding, monkeypatch):  # noqa: F811
    q = _taking(True, monkeypatch, lambda: chain.random_instance(np.random.default_rng(7), D, pp))
    want = chain.load_chain(CHAIN_512)[1][0][0]
    assert q.serialize() == want.serialize()
    pcdl.check(q.C, D, q.z, q.v, q.pi, pp)

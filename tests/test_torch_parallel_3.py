"""test_torch_parallel.py's sharded MSM with 3 gloo ranks at N = 96; 3 does
not divide d + 1 = 2, so check_device(mesh=) takes the single-device path
there and must still give the verdicts check_device gives."""

import torch

from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_parallel import claims, run_world  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def test_msm_sharded_three_ranks(claims, tmp_path):  # noqa: F811
    run_world(3, 96, claims, tmp_path)

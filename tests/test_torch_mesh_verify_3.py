"""test_torch_mesh_verify.py's cases on 3 gloo ranks: 8 succinct rows pad
to 9 (3 a rank), the 2 U_0 rows to 3, and 3 does not divide n = 16, so
each verify_chain's decider runs on one device on every rank."""

import torch

from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_mesh_verify import run_world

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def test_mesh_verify_three_ranks(tmp_path):
    run_world(3, tmp_path)

"""test_torch_mesh_open.py's check on 2 gloo ranks: w = 8 lanes a rank, so
only the first round (m = 8) reads coefficients of lanes the other rank
holds."""

import pytest
import torch

from tests.test_torch_host_extra import own_urs_cache  # noqa: F401  (a URS cache of the module's own)
from tests.test_torch_mesh_open import HIDING, check_world, run_world

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("mesh_open_2"))


@pytest.mark.parametrize("hiding", HIDING)
def test_mesh_open_two_ranks(runs2, hiding):
    check_world(2, runs2, hiding)

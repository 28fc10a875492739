"""The port's expansion-opacity crossing on the cylindrical and 3D
Cartesian grids against the JAX package's XLA path and Pallas kernel, on
the CPU (the check and tolerances of tests/test_torch_expansion.py: cell and
packet type agree on > 0.97 of lanes, > 0.9 at max_inner 4)."""

import pytest
import torch

from test_torch_expansion import check_crossing, expo_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_cyl(tmp_path_factory):
    return expo_scene(tmp_path_factory, "cyl2d")


@pytest.fixture(scope="module")
def scene_cart(tmp_path_factory):
    return expo_scene(tmp_path_factory, "cart3d")


@pytest.mark.parametrize("max_inner", [1, 4])
def test_crossing_cylindrical_matches_jax(scene_cyl, max_inner):
    check_crossing(scene_cyl, max_inner, seed=10 + max_inner)


@pytest.mark.parametrize("max_inner", [1, 4])
def test_crossing_cartesian_matches_jax(scene_cart, max_inner):
    check_crossing(scene_cart, max_inner, seed=20 + max_inner)

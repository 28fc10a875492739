"""The deferred-event crossing (K6) on a 1D model mapped onto an 8^3
CARTESIAN3D grid: the port's rpkt_step against the Pallas kernel in
interpret mode and the XLA path, with the draws and tolerances of
tests/test_torch_deferred.py (a file of its own so the two scenes' JAX
compiles run on separate test workers)."""

import pytest
import torch

from test_torch_deferred import _scene, check_deferred_parity

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_3d(tmp_path_factory):
    import artis_tpu.options as jo

    return _scene(tmp_path_factory, "defer_3d", 5,
                  dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
                       ncoordgrid_z=8))


@pytest.mark.parametrize("max_inner", [1, 4])
def test_deferred_1dmodel_3dgrid_matches_pallas_and_xla(scene_3d, max_inner):
    check_deferred_parity(scene_3d, max_inner)

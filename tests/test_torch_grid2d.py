"""The port on the 2D cylindrical grid, and a 2D model on the 3D grid,
against the JAX package on the CPU (helpers and tolerances of
tests/test_torch_grid3d.py):

- grid_init of a (3 x 6) cylindrical model on its own grid: integer arrays
  equal, float arrays to rtol 1e-12; boundary_distance (rtol 1e-9) and
  get_cellindex_from_pos (exact) in float64;
- interop.from_numpy carries a JAX GridData of either new type (the
  ``ncoordgrid`` and ``model_ncoord`` tuples, ``model_dim``) into the port;
- gamma_step with the same injected uniforms on both sides (rtol 1e-9);
- rpkt_step of the port (plain version) against the XLA path (tag-51
  draws) and the Pallas kernel in interpret mode (_PALLAS_TEST_INJECT) on
  the scenes of tests/test_pallas_rpkt.py (4 x 8 cylindrical model,
  2D model on a 12^3 grid), 512 packets at max_inner 1 and 4: cell and
  packet type agree on > 0.95 (0.9 at max_inner 4), prop_time / nu_cmf /
  e_cmf within rel 3e-3 on > 0.95 (0.9) of the agreeing lanes;
- on the cylindrical grid at a later start time against the XLA path only:
  the Pallas kernel passes the rcyl bounds at tmin to its expanding-circle
  intersection (pallas_rpkt.py:762-765, 822, 833) where the XLA path and
  the port scale them to the step's start time, so the two agree only at
  t = tmin (ROADMAP Queue 3);
- one whole timestep of kilonova_2d_2dgrid (tests/test_configmatrix.py) at
  2000 packets against the JAX package within Monte Carlo noise (4/sqrt(n)).
"""

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import (
    NPKTS, assert_geometry_matches, assert_grids_equal, assert_lane_parity, both_grids,
    check_gamma_parity, check_rpkt_parity, check_timestep, forced_state, jax_scene, np_fields,
    run_port, run_xla, timestep_pair)

torch.set_num_threads(1)


def test_grid_init_cylindrical_matches(tmp_path):
    d = str(tmp_path)
    make_run(d, ncells=3, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, model_dim=2)
    gj, hj, gt, ht = both_grids(d, "CYLINDRICAL2D")
    assert_grids_equal(gj, gt)
    assert gt.ncoordgrid == (3, 6, 1)
    np.testing.assert_allclose(ht.initial_radial_pos_sum_mgi, hj.initial_radial_pos_sum_mgi,
                               rtol=1e-12)
    assert_geometry_matches(gj, gt, seed=2)


@pytest.mark.parametrize("grid_type", ["CYLINDRICAL2D", "CARTESIAN3D"])
def test_interop_carries_the_grid(tmp_path, grid_type):
    from artis_tpu_torch import interop
    from artis_tpu_torch.grid import GridData

    d = str(tmp_path)
    make_run(d, ncells=3, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, model_dim=2)
    gj, _, gt, _ = both_grids(d, grid_type)
    carried = interop.from_numpy(GridData, np_fields(gj), dtype=torch.float64)
    assert_grids_equal(gj, carried)
    assert carried.ncoordgrid == gt.ncoordgrid and carried.model_ncoord == (3, 6)
    assert carried.model_dim == 2 and carried.grid_type == gt.grid_type


@pytest.fixture(scope="module")
def scene_cyl(tmp_path_factory):
    """4 x 8 cylindrical model on its own grid
    (tests/test_pallas_rpkt.py::scene_2d)."""
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "t2d_cyl", dict(ncells=4, model_dim=2),
                     dict(grid_type=jo.GridType.CYLINDRICAL2D))


@pytest.fixture(scope="module")
def scene_cyl_fe(tmp_path_factory):
    """The 4 x 8 cylindrical model with a 570-line Fe atom (three ions of 20
    levels): the line walk of kilonova_2d_2dgrid_fe, at a test's size."""
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "t2d_cyl_fe", dict(ncells=4, model_dim=2),
                     dict(grid_type=jo.GridType.CYLINDRICAL2D),
                     atom=dict(elements=((26, 3),), nlevels_per_ion=20))


@pytest.fixture(scope="module")
def scene_2d3d(tmp_path_factory):
    """2D model on a 12^3 grid (tests/test_pallas_rpkt.py::scene_2dmodel_3dgrid)."""
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "t2d_3d", dict(ncells=3, model_dim=2),
                     dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=12,
                          ncoordgrid_y=12, ncoordgrid_z=12))


@pytest.mark.parametrize("max_inner", [1, 4])
def test_rpkt_cylindrical_matches_jax(scene_cyl, max_inner):
    check_rpkt_parity(scene_cyl, seed=13, max_inner=max_inner)


def test_rpkt_cylindrical_fe_matches_jax(scene_cyl_fe):
    """The cylindrical line walk on the Fe-like list (K3's walk on
    kilonova_2d_2dgrid_fe) against the XLA path and the Pallas ``cyl2d``
    branch."""
    assert scene_cyl_fe["sim"].dad.nlines > 500
    check_rpkt_parity(scene_cyl_fe, seed=19, max_inner=4)


def test_rpkt_cylindrical_later_time_matches_xla(scene_cyl):
    """Packets starting at 1.15 t_min: the expanding rcyl bounds are scaled
    to the start time (the XLA path's form)."""
    import jax.numpy as jnp

    st0 = forced_state(scene_cyl, seed=17)
    t0 = float(scene_cyl["ctx"].ts) * 1.15
    st0 = st0.replace(pos=st0.pos * 1.15, prop_time=jnp.full(NPKTS, t0))
    rng = np.random.default_rng(17)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    assert_lane_parity(run_xla(scene_cyl, st0, tau_u, 1),
                       run_port(scene_cyl, st0, tau, sel, 1), 1)


@pytest.mark.parametrize("max_inner", [1, 4])
def test_rpkt_2dmodel_3dgrid_matches_jax(scene_2d3d, max_inner):
    check_rpkt_parity(scene_2d3d, seed=41, max_inner=max_inner)


def test_gamma_step_cylindrical_matches_jax(scene_cyl):
    check_gamma_parity(scene_cyl, seed=6)


def test_kilonova_2d_2dgrid_timestep_matches_jax(tmp_path_factory):
    import artis_tpu.options as jo

    sj, st = timestep_pair(tmp_path_factory, "kn_2d_2d", dict(ncells=3, model_dim=2),
                           dict(grid_type=jo.GridType.CYLINDRICAL2D))
    check_timestep(sj, st)

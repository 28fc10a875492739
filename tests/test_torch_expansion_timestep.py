"""One whole timestep of the port in expansion-opacity mode against the JAX
package, on the CPU, with thermalisation probability -1 (every reference
preset: a bin event activates the macro-atom on a line of its bin); the
0.9 mode (fixed-probability thermalisation, coherent scatter otherwise) is
tests/test_torch_expansion_thermalised.py. Both packages start from the
same pellets; escaped luminosity, particle deposition and per-cell J agree
within Monte Carlo noise (the 4/sqrt(n) rule of tests/test_torch_slice.py,
through tests/test_torch_grid3d.py::check_timestep), and bound-bound bin
events occur in both (tests/test_expansion_bb.py). The JAX side compiles
its transport loop for each mode, which is most of the time."""

import numpy as np
import torch

from test_torch_grid3d import check_timestep, timestep_pair

torch.set_num_threads(1)


def check_expansion_timestep(tmp_path_factory, p_therm):
    import artis_tpu.options as jo
    from artis_tpu_torch import stats

    sj, st = timestep_pair(tmp_path_factory, f"expo_ts{p_therm}", dict(ncells=5, logrho0=-7.5),
                           dict(grid_type=jo.GridType.SPHERICAL1D, expansionopacities_on=True,
                                rpkt_boundbound_thermalisation_probability=p_therm))
    check_timestep(sj, st)
    assert int(st.est.counters[stats.MA_STAT_ACTIVATION_BB]) > 0
    assert int(np.asarray(sj.est.counters)[stats.MA_STAT_ACTIVATION_BB]) > 0
    if p_therm < 0:
        # the line cumulative stays float64 in a float32 run
        assert st.update_grid(1).expopac_wcum.dtype == torch.float64


def test_timestep_matches_jax(tmp_path_factory):
    check_expansion_timestep(tmp_path_factory, -1.0)

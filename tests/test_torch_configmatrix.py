"""The classic and kilonova configurations of the reference CI's matrix on
the port, on the CPU (tests/test_configmatrix.py runs them on the JAX
package), each with a float32 crossing (``test_config``) and at the
default float64 transport (``test_config_float64``): classicmode_1d_3dgrid and classicmode_3d (the classic preset:
dipole / polarised electron scattering through the deferred-event
crossing, rate-balance ionisation), kilonova_1d_1dgrid, kilonova_1d_3dgrid,
kilonova_2d_2dgrid (with Barnes particle thermalisation and with binned
expansion opacities) and kilonova_2d_3dgrid, each miniaturised the same way
(384 packets, 3 timesteps, a few model cells) and run through the port's
Simulation for two timesteps with the sanity checks of test_config: every
packet accounted for, finite non-negative energies not above the injected
total (+5 %), transport happened, finite temperatures, the output files
written. classicmode_1d_3dgrid_nlte is classicmode_1d_3dgrid with
``num_lte_timesteps=1``, so its second timestep takes the non-LTE grid
update (the T_R / W fit and the thermal-balance T_e solve) in a whole
simulation. nebular_1d_3dgrid_nont and nebular_1d_3dgrid_limitbfest_nont
are the CI's two nebular configurations (the nltenebular preset: NLTE
populations with superlevels, the multibin radiation field, the detailed
bf-rate and J_b_lu estimators, LUT-off photoionisation and bf heating, one
outer iteration) without the non-thermal solver, with
``num_lte_timesteps=1`` so that their second timestep solves the NLTE
populations; they also write nlte_0000.out and radfield_0000.out.
nebular_1d_3dgrid and nebular_1d_3dgrid_limitbfest are the same two with
the non-thermal solver on (the Spencer-Fano solve at the preset's 256
points, the synthetic non-thermal files of
``synthdata.write_synthetic_nonthermal_data`` in the run directory), run
for three timesteps: the second is the first non-LTE timestep, which keeps
the default solution, the third solves Spencer-Fano and splits the
deposited leptons. kilonova_2d_2dgrid_xcomgammaphotoion is kilonova_2d_2dgrid
with XCOM gamma photoionisation, on the synthetic
``synthdata.write_synthetic_xcom_data`` table and synthetic Ni56 / Co56
gamma lines (tests/test_torch_xcom.py holds it against the JAX package);
its gamma packets must deposit energy. The table is the port's own copy;
the JAX test module is not imported."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _mini(**kw):
    base = dict(npkts=384, mintemp=1000.0, maxtemp=20000.0, tablesize=12, linewalk_chunk=64,
                transport_dtype="float32")
    base.update(kw)
    return base


GRID8 = dict(grid_type="CARTESIAN3D", ncoordgrid_x=8, ncoordgrid_y=8, ncoordgrid_z=8)
# the nebular configurations, one NLTE outer iteration as in the CI
# (tests/test_configmatrix.py), without and with the non-thermal solver
NONT = dict(nt_on=False, nt_solve_spencerfano=False, nlte_outer_iters=1)
NT = dict(nlte_outer_iters=1)
# name -> (preset, Options keywords, model_dim, make_run keywords)
CONFIGS = {
    "classicmode_1d_3dgrid": ("classic", _mini(**GRID8), 1, {}),
    "classicmode_1d_3dgrid_nlte": ("classic", _mini(**GRID8), 1, dict(num_lte_timesteps=1)),
    "classicmode_3d": ("classic", _mini(grid_type="CARTESIAN3D"), 3, dict(ncells=4)),
    "kilonova_1d_1dgrid": ("kilonova_lte", _mini(grid_type="SPHERICAL1D"), 1, {}),
    "kilonova_1d_3dgrid": ("kilonova_lte", _mini(**GRID8), 1, {}),
    "kilonova_2d_2dgrid": ("kilonova_lte", _mini(grid_type="CYLINDRICAL2D"), 2, dict(ncells=3)),
    "kilonova_2d_2dgrid_barnesthermalisation": (
        "kilonova_lte",
        _mini(grid_type="CYLINDRICAL2D", particle_thermalisation_scheme="BARNES"), 2,
        dict(ncells=3)),
    "kilonova_2d_2dgrid_expansionopac": (
        "kilonova_lte", _mini(grid_type="CYLINDRICAL2D", expansionopacities_on=True), 2,
        dict(ncells=3)),
    "kilonova_2d_2dgrid_xcomgammaphotoion": (
        "kilonova_lte", _mini(grid_type="CYLINDRICAL2D", use_xcom_gammaphotoion=True), 2,
        dict(ncells=3)),
    "kilonova_2d_3dgrid": ("kilonova_lte", _mini(**GRID8), 2, dict(ncells=3)),
    "nebular_1d_3dgrid_nont": (
        "nltenebular", _mini(**GRID8, **NONT, detailed_bf_estimators_usefromtimestep=1), 1,
        dict(num_lte_timesteps=1)),
    "nebular_1d_3dgrid_limitbfest_nont": (
        "nltenebular", _mini(**GRID8, **NONT, detailed_bf_estimators_usefromtimestep=2,
                             sf_auger_contribution_on=False), 1, dict(num_lte_timesteps=1)),
    "nebular_1d_3dgrid": (
        "nltenebular", _mini(**GRID8, **NT, detailed_bf_estimators_usefromtimestep=1), 1,
        dict(num_lte_timesteps=1, ntimesteps=4)),
    "nebular_1d_3dgrid_limitbfest": (
        "nltenebular", _mini(**GRID8, **NT, detailed_bf_estimators_usefromtimestep=2,
                             sf_auger_contribution_on=False), 1,
        dict(num_lte_timesteps=1, ntimesteps=4)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config(name, tmp_path):
    _run_config(name, tmp_path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_float64(name, tmp_path):
    """The same at the default float64 transport, the precision
    tests/test_configmatrix.py runs the configurations at."""
    _run_config(name, tmp_path, transport_dtype="float64")


def _run_config(name, tmp_path, **dtype_kw):
    from artis_tpu_torch import options as to
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.synthdata import (make_run, write_synthetic_gamma_lines,
                                           write_synthetic_nonthermal_data,
                                           write_synthetic_xcom_data)

    preset, okw, model_dim, make_kw = CONFIGS[name]
    okw = dict(okw, grid_type=to.GridType[okw["grid_type"]], **dtype_kw)
    if "particle_thermalisation_scheme" in okw:
        okw["particle_thermalisation_scheme"] = to.ThermalisationScheme[
            okw["particle_thermalisation_scheme"]]
    d = str(tmp_path)
    mk = dict(ncells=5, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, ngreyts=0,
              model_dim=model_dim)
    mk.update(make_kw)
    make_run(d, **mk)
    opts = getattr(to, preset)(**okw)
    if opts.nt_on:
        write_synthetic_nonthermal_data(d, ((26, 3), (27, 2), (28, 2)))
    if opts.use_xcom_gammaphotoion:
        write_synthetic_xcom_data(d, ((26, 3), (27, 2), (28, 2)))
        write_synthetic_gamma_lines(d)
    sim = Simulation(d, opts, datadir="/nonexistent", device="cpu")
    modes = []
    for ts in range(mk["ntimesteps"] - 1):
        sim.do_timestep(ts)
        modes.append(sim.plasma_mode)
    sim.finish()
    sim.close()
    later = "nlte" if make_kw.get("num_lte_timesteps") == 1 else "lte"
    assert modes == ["first"] + [later] * (mk["ntimesteps"] - 2)
    if opts.nt_on:
        # the last timestep solved Spencer-Fano and split the deposits
        from artis_tpu_torch import stats

        assert sim.sf_solves >= 1 and sim._sf_carry is not None
        c = sim.est.counters.numpy()
        assert c[stats.NT_STAT_TO_IONIZATION] + c[stats.NT_STAT_TO_KPKT] > 0

    if opts.use_xcom_gammaphotoion:
        assert sim.xcom is not None and np.all(sim.gamma_dep_ts[:2] > 0), sim.gamma_dep_ts

    types = sim.state.ptype.numpy()
    assert len(types) == opts.npkts
    e_cmf = sim.state.e_cmf.double().numpy()
    assert np.all(np.isfinite(e_cmf)) and np.all(e_cmf >= 0)
    assert e_cmf.sum() * sim.pellet_tables.e0 <= sim.pellet_tables.norm * 1.05
    assert int(sim.total_rpkt_steps) > 0
    assert np.all(np.isfinite(sim.cells.Te.numpy()))
    files = ["light_curve.out", "spec.out", "deposition.out", "estimators_0000.out",
             "timesteps.out"]
    if preset == "nltenebular":
        files += ["nlte_0000.out", "radfield_0000.out"]
    for fn in files:
        assert os.path.exists(os.path.join(d, fn)), fn

"""The detailed J_b_lu line estimators of the port (K5-jblue) and their
consumers against the JAX package on the CPU.

- The driver's line selection (``jblue_of_line``, radfield.cc:520-552)
  equals the JAX driver's, for one element and for all;
- the plain crossing's per-(cell, line) J_b_lu sums and counts against the
  XLA path and the Pallas kernel in interpret mode
  (tests/test_pallas_rpkt.py::test_kernel_jblue_matches_xla's scene and
  tolerances: sum and count totals within rel 5e-2, > 0.9 of the entries
  either side filled within rel 1e-2) at max_inner 1, and on a 1D model
  mapped onto an 8^3 grid against the XLA path;
- ``compute_process_rates`` and ``trans_values_at`` with the normalised
  J_b_lu estimators and the LUT-off photoionisation coefficients, float64,
  rtol 1e-9;
- the NLTE solve with J_b_lu equal to the dilute blackbody of every line
  reproduces the solve without it (the port's version of
  tests/test_jblue.py::test_nlte_solver_consistent_when_jblue_equals_dbb,
  rtol 1e-10).
"""

import numpy as np
import pytest
import torch

from test_torch_grid3d import NPKTS, forced_state, jax_scene, np_fields, run_pallas, run_port
from test_torch_grid3d import port_opts, run_xla

torch.set_num_threads(1)

RTOL = 1e-9
JB_KW = dict(detailed_line_estimators_on=True, jblue_elem_z=0, jblue_max_lowerlevel=15)


@pytest.fixture(scope="module")
def scene_jb(tmp_path_factory):
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "tjb_1d", dict(ncells=8),
                     dict(grid_type=jo.GridType.SPHERICAL1D, **JB_KW))


def _assert_jblue_close(est_j, est_t):
    rx, cx = np.asarray(est_j.jblue_raw), np.asarray(est_j.jblue_count)
    rp, cp = est_t.jblue_raw.double().numpy(), est_t.jblue_count.double().numpy()
    assert rx.shape == rp.shape and cx.shape == cp.shape
    assert rx.sum() > 0 and cx.sum() > 0
    assert rp.sum() == pytest.approx(rx.sum(), rel=5e-2)
    assert cp.sum() == pytest.approx(cx.sum(), rel=5e-2)
    sel = (rx > 0) | (rp > 0)
    denom = np.maximum(np.abs(rx[sel]), np.abs(rp[sel]))
    rel = np.abs(rx[sel] - rp[sel]) / np.maximum(denom, 1e-300)
    assert np.mean(rel < 1e-2) > 0.9, np.mean(rel < 1e-2)


def _compare(sc, seed, pallas):
    st0 = forced_state(sc, seed=seed)
    rng = np.random.default_rng(seed)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    est_t = run_port(sc, st0, tau, sel, 1)[1]
    _assert_jblue_close(run_xla(sc, st0, tau_u, 1)[1], est_t)
    if pallas:
        _assert_jblue_close(run_pallas(sc, st0, tau, sel, 1)[1], est_t)


def test_crossing_jblue_matches_jax(scene_jb):
    assert scene_jb["sim"]._njblue > 1
    _compare(scene_jb, seed=31, pallas=True)


def test_crossing_jblue_1dmodel_3dgrid_matches_xla(tmp_path_factory):
    import artis_tpu.options as jo

    sc = jax_scene(tmp_path_factory, "tjb_3d", dict(ncells=5),
                   dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
                        ncoordgrid_z=8, **JB_KW))
    _compare(sc, seed=32, pallas=False)


@pytest.mark.parametrize("elem_z", [0, 26])
def test_line_selection_matches(scene_jb, elem_z):
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td

    jsim = scene_jb["sim"]
    jopts = scene_jb["opts"].replace(jblue_elem_z=elem_z)
    sj = jd.Simulation(jsim.rundir, jopts, datadir="/nonexistent")
    st = td.Simulation(jsim.rundir, port_opts(jopts, transport_dtype="float32"),
                       datadir="/nonexistent", device="cpu")
    st.close()
    np.testing.assert_array_equal(st.jblue_of_line.numpy(), np.asarray(sj.jblue_of_line))
    assert st._njblue == sj._njblue > 1
    assert tuple(st.est.jblue_raw.shape) == (st.grid.nonempty_npts, st._njblue)


def _rate_inputs(sc, seed):
    """The scene's own populations and cells with normalised J_b_lu rows and
    LUT-off photoionisation coefficients made from a seed."""
    sim, ctx = sc["sim"], sc["ctx"]
    rng = np.random.default_rng(seed)
    ncells = np.asarray(sim.cells.Te).shape[0]
    jb_line = np.asarray(sim.jblue_of_line)
    jb_arr = 10 ** rng.uniform(-8.0, -3.0, (ncells, sim._njblue))
    corr = 10 ** rng.uniform(-12.0, -6.0, (ncells, sim.dad.nbfcontinua))
    return sim, ctx, jb_line, jb_arr, corr


def _port_plasma(sim):
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    f64 = torch.float64
    return (interop.from_numpy(DeviceAtomicData, np_fields(sim.dad), dtype=f64),
            interop.from_numpy(RateCoeffTables, np_fields(sim.rc), dtype=f64))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x)).to(dtype)


def test_process_rates_with_jblue_and_lut_off_match(scene_jb):
    import jax.numpy as jnp

    import artis_tpu.plasma.transitionrates as jtr
    import artis_tpu_torch.plasma.transitionrates as ttr

    sim, ctx, jb_line, jb_arr, corr = _rate_inputs(scene_jb, 5)
    c = sim.cells
    args = (ctx.levelpops, ctx.nnion, c.Te, c.TR * 1.7, c.W * 0.3 + 0.01, c.nne, float(ctx.t_mid))
    rj = jtr.compute_process_rates(sim.dad, sim.rc, *args,
                                   jblue_normed=(jnp.asarray(jb_line), jnp.asarray(jb_arr)),
                                   corr_photoion_cells=jnp.asarray(corr))
    dad, rc = _port_plasma(sim)
    rt = ttr.compute_process_rates(dad, rc, *(_t(a) for a in args[:-1]), args[-1],
                                   jblue_normed=(_t(jb_line, torch.int64), _t(jb_arr)),
                                   corr_photoion_cells=_t(corr))
    base = ttr.compute_process_rates(dad, rc, *(_t(a) for a in args[:-1]), args[-1])
    for f in ("ma_rates", "cool_exc_level", "cool_ion_cont", "cool_fb_cont", "cont_rad",
              "cont_tot_down", "cont_tot_up", "totalcooling", "jb_line", "jb_arr"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=RTOL, atol=0, err_msg=f)
    # the J_b_lu rows and the LUT-off coefficients moved the upward rates
    for f in ("ma_rates", "cont_tot_up"):
        assert not np.allclose(getattr(rt, f).numpy(), getattr(base, f).numpy(), rtol=1e-3,
                               atol=0), f


def test_trans_values_at_with_jblue_matches(scene_jb):
    import jax.numpy as jnp

    import artis_tpu.plasma.transitionrates as jtr
    import artis_tpu_torch.plasma.transitionrates as ttr

    sim, ctx, jb_line, jb_arr, _ = _rate_inputs(scene_jb, 6)
    rng = np.random.default_rng(7)
    ncells = jb_arr.shape[0]
    n, k = 300, 16
    rows = rng.integers(0, ncells, n)
    kidx = rng.integers(0, sim.dad.ntrans_total, (n, k))
    c = sim.cells
    te, ne = np.asarray(c.Te)[rows], np.asarray(c.nne)[rows]
    tr, w = np.asarray(c.TR)[rows] * 1.5, np.asarray(c.W)[rows] * 0.2 + 0.01
    vj = jtr.trans_values_at(sim.dad, ctx.levelpops, jnp.asarray(rows), jnp.asarray(kidx),
                             jnp.asarray(te), jnp.asarray(ne), jnp.asarray(tr), jnp.asarray(w),
                             float(ctx.t_mid), jnp.asarray(jb_line), jnp.asarray(jb_arr))
    dad, _ = _port_plasma(sim)
    vt = ttr.trans_values_at(dad, _t(ctx.levelpops), torch.as_tensor(rows),
                             torch.as_tensor(kidx), _t(te), _t(ne), _t(tr), _t(w),
                             float(ctx.t_mid), _t(jb_line, torch.int64), _t(jb_arr))
    for a, b in zip(vj, vt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)


def test_nlte_solver_consistent_when_jblue_equals_dbb(tmp_path):
    from artis_tpu_torch import atomic
    from artis_tpu_torch.io import atomicdata
    from artis_tpu_torch.options import kilonova_lte
    from artis_tpu_torch.plasma import cellstate, ltepop, nltepop, ratecoeff
    from artis_tpu_torch.plasma.radfield import dbb
    from artis_tpu_torch.synthdata import write_synthetic_atomicdata

    write_synthetic_atomicdata(str(tmp_path), elements=((26, 3),), nlevels_per_ion=6)
    ad = atomicdata.read_atomicdata(str(tmp_path), nlevels_requiretransitions=lambda z, s: 0)
    dad = atomic.to_device(ad)
    opts = kilonova_lte(mintemp=1000.0, maxtemp=30000.0, tablesize=40)
    rc = ratecoeff.build_tables(dad, opts.tablesize, opts.mintemp, opts.maxtemp)
    indices = nltepop.build_indices(dad, opts)
    temps = torch.tensor([6000.0, 9000.0, 14000.0], dtype=torch.float64)
    cells = cellstate.init_cellstate(dad, 3, np.full(3, 1e-13), np.ones(3), opts.mintemp,
                                     opts.maxtemp)
    cells = cells.replace(Te=temps, TR=temps, TJ=temps, W=torch.full((3,), 0.3, dtype=torch.float64),
                          elem_massfrac=torch.ones((3, 1), dtype=torch.float64))
    cells = ltepop.calculate_ion_balance_nne(dad, cells, opts)
    lte = ltepop.calculate_levelpops(dad, cells, opts)
    _, pops_default = nltepop.solve_all_elements(indices, dad, rc, cells, opts, lte, 5.0 * 86400.0)
    jb_line = torch.arange(dad.nlines)
    jb_arr = dbb(dad.line_nu.double()[None, :], torch.clamp(cells.TR, min=1.0)[:, None],
                 cells.W[:, None])
    _, pops_jblue = nltepop.solve_all_elements(indices, dad, rc, cells, opts, lte, 5.0 * 86400.0,
                                               jblue_normed=(jb_line, jb_arr))
    np.testing.assert_allclose(pops_jblue.numpy(), pops_default.numpy(), rtol=1e-10)
    assert not np.allclose(pops_default.numpy(), lte.numpy(), rtol=1e-3, atol=0)

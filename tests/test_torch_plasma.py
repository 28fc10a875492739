"""Plasma parity: the port's LTE grid update against the JAX package's
``_plasma_update_device`` on captured inputs, in float64.

The inputs are captured from a JAX run: its "first" grid update of
timestep 0 and its "lte" update of timestep 1, which consumes the
normalised timestep-0 estimators. Both packages then get identical numpy
copies of the atomic data, rate tables, cell state and estimators.

Tolerance: rtol 1e-8. The computation is deterministic float64 on both
sides; the only differences are summation order and the 64-step nne
bisection evaluated with differently ordered sums, both far below 1e-8."""

import dataclasses

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

RTOL = 1e-8
OPT_KW = dict(npkts=256, mintemp=1000.0, maxtemp=20000.0, tablesize=20)


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    d = str(tmp_path_factory.mktemp("plasma_jax"))
    # an early, dense scene: the timestep-0 radiation field lifts T_J above
    # mintemp, so the lte update really depends on the estimators
    make_run(d, ncells=8, ntimesteps=3, tmin_days=0.5, tmax_days=1.5, ngreyts=0,
             logrho0=-8.0, logrho_slope=-0.15)
    sim = jd.Simulation(d, jo.kilonova_lte(grid_type=jo.GridType.SPHERICAL1D, **OPT_KW),
                        datadir="/nonexistent")
    calls = []
    orig = sim._plasma_jit

    def capture(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    sim._plasma_jit = capture
    sim.do_timestep(0)
    sim.update_grid(1)
    assert [c[1]["mode"] for c in calls] == ["first", "lte"]
    return sim, calls


def _run_both(sim, call, transport_dtype="float64"):
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td
    import artis_tpu_torch.options as to
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    a, kw = call
    dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffh, dep = a[:9]
    mode = kw["mode"]
    out_j = jd._plasma_update_device(dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffh, dep,
                                     mode=mode)
    # float32 transport: the inputs are demoted as the port's driver demotes them
    fd = getattr(torch, transport_dtype)
    t = lambda x: torch.as_tensor(np.array(x, np.float64)).to(fd)
    out_t = td._plasma_update_device(
        interop.from_numpy(DeviceAtomicData, _np_fields(dad), dtype=fd),
        interop.from_numpy(RateCoeffTables, _np_fields(rc), dtype=fd),
        interop.from_numpy(CellState, _np_fields(cells), dtype=fd),
        to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, transport_dtype=transport_dtype,
                        **OPT_KW),
        t(j_norm), t(nuj_norm), float(t_mid), t(ffh), t(dep), mode=mode)
    return out_j, out_t


@pytest.fixture(scope="module")
def results(captured):
    sim, calls = captured
    return {c[1]["mode"]: _run_both(sim, c) for c in calls}


@pytest.fixture(scope="module")
def results_f32(captured):
    sim, calls = captured
    return {c[1]["mode"]: _run_both(sim, c, "float32") for c in calls}


def _close(a, b, name):
    xa = np.asarray(a).astype(np.float64)
    xb = b.detach().cpu().numpy().astype(np.float64)
    assert xa.shape == xb.shape, name
    np.testing.assert_allclose(xb, xa, rtol=RTOL, atol=1e-300, err_msg=name)


# JAX result tuple positions: cells, levelpops, nnion, chi_ff_part, rates,
# tau_sob, bf_a, bf_dep (the port returns these eight, then its
# expansion-opacity tables)
ARRAYS = {"levelpops": 1, "nnion": 2, "chi_ff_nnionpart": 3, "tau_sob": 5, "bf_a": 6,
          "bf_dep": 7}
CELL_FIELDS = ("Te", "TR", "TJ", "W", "nne", "ion_groundlevelpops", "ion_partfuncts",
               "totalcooling", "ion_cooling_contribs")
RATE_FIELDS = ("ma_rates", "cool_exc_level", "cool_ion_cont", "cool_fb_cont", "cool_ff_ion",
               "ion_cooling", "totalcooling", "cont_rad", "cont_tot_down", "cont_tot_up")


@pytest.mark.parametrize("mode", ["first", "lte"])
@pytest.mark.parametrize("name", list(ARRAYS))
def test_plasma_tables_match(results, mode, name):
    out_j, out_t = results[mode]
    _close(out_j[ARRAYS[name]], out_t[ARRAYS[name]], name)


@pytest.mark.parametrize("mode", ["first", "lte"])
@pytest.mark.parametrize("field", CELL_FIELDS)
def test_plasma_cells_match(results, mode, field):
    out_j, out_t = results[mode]
    _close(getattr(out_j[0], field), getattr(out_t[0], field), field)


@pytest.mark.parametrize("mode", ["first", "lte"])
@pytest.mark.parametrize("field", RATE_FIELDS)
def test_process_rates_match(results, mode, field):
    out_j, out_t = results[mode]
    _close(getattr(out_j[4], field), getattr(out_t[4], field), field)


def test_lte_mode_moved_the_temperatures(results):
    """The captured lte update really consumed estimators (T_J from J)."""
    out_j, out_t = results["lte"]
    first_j, _ = results["first"]
    assert not np.allclose(np.asarray(out_j[0].TJ), np.asarray(first_j[0].TJ))
    _close(out_j[0].TJ, out_t[0].TJ, "TJ")


@pytest.mark.parametrize("mode", ["first", "lte"])
@pytest.mark.parametrize("field", RATE_FIELDS)
def test_float32_transport_keeps_rate_shares(results_f32, mode, field):
    """With float32 transport the rate tables still come out in float64, so
    the cells' channel shares (what the k-packet and macro-atom selections
    draw from) match the float64 reference. Computed in float32, the rates
    of cold cells (nne down to ~1e-7 here, ~1e-36 in outer shells) underflow
    to zero and every k-packet there falls back to free-free emission.
    Tolerance: 1e-3 absolute on each share; the inputs carry float32
    rounding, amplified by the Boltzmann factors of the level populations."""
    out_j, out_t = results_f32[mode]
    b = getattr(out_t[4], field)
    assert b.dtype == torch.float64, field
    a = np.asarray(getattr(out_j[4], field)).astype(np.float64)
    b = b.numpy()
    # shares within a (cell, level) row for the macro-atom table, within a
    # cell for the others
    axes = (2,) if field == "ma_rates" else tuple(range(1, a.ndim))

    def shares(x):
        tot = np.abs(x).sum(axis=axes, keepdims=True) if axes else np.abs(x)
        return np.where(tot > 0, x / np.where(tot > 0, tot, 1.0), 0.0)

    if not axes:
        # totalcooling: one number per cell, compared relative to itself
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=0, err_msg=field)
    else:
        np.testing.assert_allclose(shares(b), shares(a), rtol=0, atol=1e-3, err_msg=field)

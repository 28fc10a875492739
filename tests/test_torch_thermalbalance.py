"""The non-LTE grid update without NLTE populations (the classic preset's
timesteps from ``num_lte_timesteps`` on) of the port against the JAX
package's ``_plasma_update_device`` on captured inputs, in float64.

A JAX classic run (SPHERICAL1D, ``num_lte_timesteps=1``, no grey timesteps)
has its timestep-1 ``"nlte"`` call captured, its timestep-0 estimators
taken from the port's transport of the same scene: the full-spectrum T_R / W fit,
the thermal-balance T_e bisection (each step re-solving the Saha balance),
the thick-cell T_J override, and the rate-balance ionisation from the
normalised LUT gamma estimators with ``corrphotoionrenorm`` in the rate
tables. Both packages then get identical numpy copies of every input.

Tolerances: rtol 1e-8 for the closed-form values (T_R, W and everything
computed at an agreeing T_e); T_e itself to one final bisection bracket,
(maxtemp - mintemp) / 2^24, since a heating-minus-cooling sign within
rounding of zero may send the last bisection steps the other way. Cases:
the captured call (its timestep-0 gamma estimators are zero: no packet
reached a bf window, so corrphotoionrenorm is 0 and the Saha balance
stands); the same call with every other cell thick (the T_J override runs
there); and the same call with gamma estimators of three times the fitted
field, where the rate-balance branch moves nne away from the Saha solution
by far more than the tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

RTOL = 1e-8
OPT_KW = dict(npkts=384, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
              rpkt_crossings_per_dispatch=16)
TE_BRACKET = (OPT_KW["maxtemp"] - OPT_KW["mintemp"]) / 2**24


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """A JAX classic run's timestep-1 grid update. Its timestep-0
    estimators come from the port's transport of the same scene (the JAX
    transport would only add its compile time): the update under test
    gets the same numbers on both sides either way."""
    import jax.numpy as jnp

    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    import artis_tpu_torch.options as to

    dirs = [str(tmp_path_factory.mktemp(f"tbal_{k}")) for k in ("jax", "port")]
    # an early scene, dense for the test scenes, so that photoionisation and
    # the thermal balance have work to do
    for d in dirs:
        make_run(d, ncells=8, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
                 logrho0=-7.0, num_lte_timesteps=1)
    port = td.Simulation(dirs[1], to.classic(grid_type=to.GridType.SPHERICAL1D,
                                             transport_dtype="float32", **OPT_KW),
                         datadir="/nonexistent", device="cpu")
    port.do_timestep(0)
    port.close()
    sim = jd.Simulation(dirs[0], jo.classic(grid_type=jo.GridType.SPHERICAL1D, **OPT_KW),
                        datadir="/nonexistent")
    calls = []
    orig = sim._plasma_jit

    def capture(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    sim._plasma_jit = capture
    sim.update_grid(0)
    est = port.est
    sim.prev_est = sim._zero_est().replace(**{
        k: jnp.asarray(getattr(est, k).double().numpy())
        for k in ("j", "nuj", "ffheating", "dep_gamma", "dep_positron", "dep_electron",
                  "dep_alpha", "gammaestimator", "bfheatingestimator")})
    sim.update_grid(1)
    assert [c[1]["mode"] for c in calls] == ["first", "nlte"]
    # the JAX side of every case goes through the run's own jitted update
    return calls[1] + (orig,)


def _port_opts(**kw):
    import artis_tpu_torch.options as to

    return to.classic(grid_type=to.GridType.SPHERICAL1D, transport_dtype="float64",
                      **dict(OPT_KW, **kw))


def _synthetic_gamma(call, factor=3.0):
    """Normalised gamma estimators of a radiation field ``factor`` times the
    fitted dilute blackbody (W corrphotoion(T_R) per ground continuum), for
    a case in which every cell photoionises."""
    import artis_tpu.plasma.radfield as jrad

    from artis_tpu.plasma.ratecoeff import interpolate_lut

    a, kw, jit = call
    dad, rc, cells, opts, j_norm, nuj_norm = a[:6]
    _, t_r, w, _ = jrad.fit_params_fullspec(j_norm, nuj_norm, opts.mintemp, opts.maxtemp)
    corr = interpolate_lut(rc.corrphotoion, rc, dad.groundcont_contindex[None, :],
                           jnp.maximum(t_r, rc.mintemp)[:, None])
    return factor * w[:, None] * corr


def _run_both(call, thick=None, gest=None, port_dtype=torch.float64, with_jax=True,
              **opt_kw):
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    a, kw, jit = call
    dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffh, dep = a[:9]
    if thick is not None:
        cells = cells.replace(thick=jnp.asarray(thick, jnp.asarray(cells.thick).dtype))
    kw = dict(kw, gammaest_norm=kw["gammaest_norm"] if gest is None else gest)
    gest = kw["gammaest_norm"]
    out_j = None
    if with_jax:
        out_j = jit(dad, rc, cells, opts.replace(**opt_kw), *a[4:], **kw)
    t = lambda x: torch.as_tensor(np.array(x, np.float64)).to(port_dtype)
    out_t = td._plasma_update_device(
        interop.from_numpy(DeviceAtomicData, _np_fields(dad), dtype=port_dtype),
        interop.from_numpy(RateCoeffTables, _np_fields(rc), dtype=port_dtype),
        interop.from_numpy(CellState, _np_fields(cells), dtype=port_dtype),
        _port_opts(**opt_kw), t(j_norm), t(nuj_norm), float(t_mid), t(ffh), t(dep),
        mode="nlte", gammaest_norm=t(gest))
    return out_j, out_t


@pytest.fixture(scope="module")
def results(captured):
    return _run_both(captured)


@pytest.fixture(scope="module")
def results_thick(captured):
    ncells = np.asarray(captured[0][2].Te).shape[0]
    thick = np.zeros(ncells, np.int64)
    thick[::2] = 1
    return _run_both(captured, thick=thick)


@pytest.fixture(scope="module")
def results_gamma(captured):
    return _run_both(captured, gest=_synthetic_gamma(captured))


@pytest.fixture(scope="module")
def cases(results, results_thick, results_gamma):
    return dict(captured=results, thick=results_thick, gamma=results_gamma)


def _close(a, b, name, rtol=RTOL):
    xa = np.asarray(a).astype(np.float64)
    xb = b.detach().cpu().numpy().astype(np.float64)
    assert xa.shape == xb.shape, name
    np.testing.assert_allclose(xb, xa, rtol=rtol, atol=1e-300, err_msg=name)


def _cells_agree(out_j, out_t):
    """T_e within one bisection bracket; returns the cells whose T_e agree
    to rounding (where every other value must then agree to RTOL)."""
    te_j = np.asarray(out_j[0].Te)
    te_t = out_t[0].Te.numpy()
    np.testing.assert_allclose(te_t, te_j, rtol=0, atol=TE_BRACKET)
    return np.abs(te_t - te_j) <= 1e-12 * te_j


# JAX result tuple positions: cells, levelpops, nnion, chi_ff_part, rates,
# tau_sob, bf_a, bf_dep
ARRAYS = {"levelpops": 1, "nnion": 2, "chi_ff_nnionpart": 3, "tau_sob": 5, "bf_a": 6,
          "bf_dep": 7}
CELL_FIELDS = ("Te", "TR", "TJ", "W", "nne", "ion_groundlevelpops", "ion_partfuncts",
               "totalcooling")
RATE_FIELDS = ("ma_rates", "cool_ion_cont", "cool_fb_cont", "cont_rad", "cont_tot_down",
               "cont_tot_up", "totalcooling")


CASES = ["captured", "thick", "gamma"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("field", CELL_FIELDS)
def test_nlte_cells_match(cases, case, field):
    out_j, out_t = cases[case]
    ok = _cells_agree(out_j, out_t)
    assert ok.sum() >= ok.size - 1
    _close(np.asarray(getattr(out_j[0], field))[ok], getattr(out_t[0], field)[ok], field)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(ARRAYS) + list(RATE_FIELDS))
def test_nlte_tables_match(cases, case, name):
    out_j, out_t = cases[case]
    ok = _cells_agree(out_j, out_t)
    if name in ARRAYS:
        a, b = out_j[ARRAYS[name]], out_t[ARRAYS[name]]
    else:
        a, b = getattr(out_j[4], name), getattr(out_t[4], name)
    _close(np.asarray(a)[ok], b[ok], name)


def test_nlte_update_moved_te_and_fit(results):
    """The captured update did its work: T_e left T_J (the thermal balance,
    not the LTE path) and the T_R / W fit took W below 1."""
    cj = results[0][0]
    assert np.max(np.abs(np.asarray(cj.Te) / np.asarray(cj.TJ) - 1.0)) > 1e-3
    assert np.min(np.asarray(cj.W)) < 0.9


def test_thick_cells_take_tj(results_thick):
    out_j, out_t = results_thick
    c = out_t[0]
    thick = c.thick.numpy() == 1
    np.testing.assert_array_equal(c.Te.numpy()[thick], c.TJ.numpy()[thick])
    np.testing.assert_array_equal(c.W.numpy()[thick], 1.0)
    assert not np.allclose(c.Te.numpy()[~thick], c.TJ.numpy()[~thick])


def test_rate_balance_moves_nne(captured, results_gamma):
    """The rate-balance ionisation (force_saha_ion_balance off) really ran in
    the photoionising case: the same update with the Saha balance forced
    gives an nne that differs by far more than the tolerance, and the rate
    tables carry a corrphotoionrenorm away from 1 (the estimators' field is
    3x the fitted one; the renormalisation is held in the tables' bf
    ionisation rates, cont_tot_up, above)."""
    _, out_t = results_gamma
    _, out_saha = _run_both(captured, gest=_synthetic_gamma(captured), with_jax=False,
                            force_saha_ion_balance=True)
    rel = np.abs(out_t[0].nne.numpy() / out_saha[0].nne.numpy() - 1.0)
    assert rel.max() > 1e3 * RTOL
    _, plain = _run_both(captured, gest=_synthetic_gamma(captured, factor=1.0), with_jax=False)
    up3 = out_t[4].cont_tot_up.numpy()
    up1 = plain[4].cont_tot_up.numpy()
    assert np.max(np.abs(up3 / np.where(up1 > 0, up1, 1.0) - 1.0)) > 1e-2


def test_float32_cells_keep_the_float64_te(captured, results):
    """Under float32 transport the port still solves the thermal balance in
    float64 (plasma/thermalbalance.py): from the float32-rounded inputs its
    T_e lands within a few bisection brackets of the float64 reference in
    every cell."""
    out_j, _ = results
    _, out_32 = _run_both(captured, port_dtype=torch.float32, with_jax=False)
    te_32 = out_32[0].Te.double().numpy()
    np.testing.assert_allclose(te_32, np.asarray(out_j[0].Te), rtol=1e-5)

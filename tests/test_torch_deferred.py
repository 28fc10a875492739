"""The deferred-event crossing (K6, dipole scattering) of the port against
the JAX package, on the CPU.

With ``dipole`` on, the crossing kernel hands every event, electron
scattering and the thick-cell grey scatter included, to the event pass,
which draws the continuum split over the whole opacity and scatters by the
dipole phase function (JAX engine.py:1016, :1329). Here:

- the port's rpkt_step (the plain version of the kernel in its deferred
  mode, then its event pass) against the Pallas kernel in interpret mode
  (``_PALLAS_TEST_INJECT``) and against the XLA path (injected tag-51
  optical depths), with ``dipole`` and ``pol_on`` on, at max_inner 1 and 4,
  on a SPHERICAL1D scene (and, in tests/test_torch_deferred_grid3d.py, a
  1D model on an 8^3 CARTESIAN3D grid). The
  event pass's continuum split (tag 52) and bf macro-atom split (tag 55)
  get the same uniforms on both sides, so lanes agree event for event; the
  dipole directions come from each package's own generator and are not
  compared. Tolerances are those of tests/test_torch_rpkt_kernel.py and
  tests/test_torch_grid3d.py (the tests/test_pallas_rpkt.py tolerances);
- the deferred mode sends electron-scattering and thick-cell events to the
  pass (``evented``, ``thick``) and counts none of them in the kernel's
  ``misc`` electron / thick scatter counters, while the in-kernel mode
  counts the same lanes there; the pass counts the electron scatterings
  (``ESCOUNTER``) and leaves them polarised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.synthdata import make_run
from test_torch_grid3d import (
    OPT_KW, assert_lane_parity, forced_state, port_inputs, run_pallas, run_port, run_xla,
)

torch.set_num_threads(1)

NPKTS = OPT_KW["npkts"]


def _scene(tmp_path_factory, name, ncells, opts_kw):
    """A JAX Simulation after timestep 0's grid update on a dense, hot
    scene (nne up to 8e11 at 8000 K), where electron scattering is a large
    share of the continuum events."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    d = str(tmp_path_factory.mktemp(name))
    make_run(d, ncells=ncells, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-6.0)
    opts = jo.kilonova_lte(**dict(OPT_KW, dipole=True, pol_on=True, **opts_kw))
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    return dict(sim=sim, opts=opts, ctx=ctx, est=sim._zero_est())


@pytest.fixture(scope="module")
def scene_1d(tmp_path_factory):
    import artis_tpu.options as jo

    return _scene(tmp_path_factory, "defer_1d", 8, dict(grid_type=jo.GridType.SPHERICAL1D))


def _state(sc, seed):
    """In-flight r-packets over the grid at frequencies across the line list
    and the bf windows."""
    if sc["opts"].grid_type.name == "SPHERICAL1D":
        from test_torch_rpkt_kernel import _forced_state

        return _forced_state(sc, seed=seed, nu_logrange=(14.2, 15.8))
    return forced_state(sc, seed=seed, nu_logrange=(14.2, 15.8))


class _SameEventDraws:
    """Both packages' event-pass uniforms for tags 52 (continuum split) and
    55 (bf to macro-atom) set to the same arrays."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.u = {tag: rng.uniform(1e-6, 1.0, n) for tag in (52, 55)}

    def __enter__(self):
        from artis_tpu_torch.transport import engine as teng

        self.orig = jeng._uniform, teng._uniform
        uj, ut = self.orig
        u = self.u
        jeng._uniform = lambda key, tag, n, dtype: (jnp.asarray(u[tag], dtype) if tag in u
                                                    else uj(key, tag, n, dtype))
        teng._uniform = lambda key, tag, n, like: (torch.as_tensor(u[tag], dtype=like.dtype)
                                                   if tag in u else ut(key, tag, n, like))

    def __exit__(self, *exc):
        from artis_tpu_torch.transport import engine as teng

        jeng._uniform, teng._uniform = self.orig


def _escounter(est):
    from artis_tpu_torch import stats

    return int(np.asarray(est.counters)[stats.ESCOUNTER])


def check_deferred_parity(sc, max_inner):
    st0 = _state(sc, seed=7)
    rng = np.random.default_rng(17)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    with _SameEventDraws(NPKTS, seed=23):
        out_t = run_port(sc, st0, tau, sel, max_inner)
        out_p = run_pallas(sc, st0, tau, sel, max_inner)
        out_x = run_xla(sc, st0, tau_u, max_inner)
    # the pass scattered electrons on both sides, and the port's scattered
    # lanes left polarised
    assert _escounter(out_t[1]) > 0
    for out_j in (out_p, out_x):
        assert_lane_parity(out_j, out_t, max_inner)
        wj, wt = np.asarray(out_j[0].where), out_t[0].where.numpy()
        pj, pt = np.asarray(out_j[0].ptype), out_t[0].ptype.numpy()
        both = (wj == wt) & (pj == pt)
        assert np.mean(np.asarray(out_j[2])[both] == out_t[2].numpy()[both]) > 0.97
    nsc_t = out_t[0].nscatterings.numpy()
    assert (np.abs(out_t[0].stokes.numpy()[nsc_t > 0, 1:]) > 0).any()


@pytest.mark.parametrize("max_inner", [1, 4])
def test_deferred_matches_pallas_and_xla(scene_1d, max_inner):
    check_deferred_parity(scene_1d, max_inner)


def test_deferred_events_reach_the_pass(scene_1d):
    """Kernel counters and event flags in the two modes, on the plain
    version with injected draws, one crossing per lane, with every other
    cell made thick."""
    from artis_tpu_torch import stats
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport import rpkt_kernel

    sc = scene_1d
    p = port_inputs(sc, _state(sc, seed=3))
    cells = p["cells"]
    thick = torch.zeros_like(cells.thick)
    thick[::2] = 1
    cells = cells.replace(thick=thick)
    ctx, dad, grid = p["ctx"], p["dad"], p["grid"]
    _, lanes = teng.rpkt_lanes(p["st"], ctx.t2)
    n = lanes["posx"].shape[0]
    rng = np.random.default_rng(5)
    draws = (torch.as_tensor(-np.log(rng.uniform(0.05, 0.95, n)).astype(np.float32)),
             torch.as_tensor(rng.uniform(0.0, 1.0, n).astype(np.float32)))
    tables = rpkt_kernel.kernel_tables(dad, grid, cells, ctx)

    def run(defer):
        return rpkt_kernel.propagate_reference(
            1, lanes, tables, *draws, float(ctx.t2), float(ctx.tmin),
            float(grid.max_path_step), nlines=dad.nlines, ncells=cells.Te.shape[0],
            ngc=max(dad.nbfcontinua_ground, 1), nphixs=dad.nphixspoints, max_inner=1,
            relativistic=p["opts"].use_relativistic_doppler_shift,
            phixs_dnu=float(dad.nphixsnuincrement),
            last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=True,
            defer_scatter=defer)

    ink, dfr = run(False), run(True)
    assert float(ink["misc"][3]) > 0 and float(ink["misc"][4]) > 0
    assert float(dfr["misc"][3]) == 0 and float(dfr["misc"][4]) == 0
    # the lanes the in-kernel mode scattered are the deferred mode's thick
    # and electron-scattering events, and nothing else changed
    scat = ink["inkscat"] > 0
    ev_d = dfr["evented"] > 0
    assert int(dfr["inkscat"].sum()) == 0
    assert torch.equal(ev_d, (ink["evented"] > 0) | scat)
    thick_d = ev_d & (dfr["thick"] > 0)
    escat_d = (ev_d & ~thick_d & (dfr["is_bb"] == 0)
               & (draws[1] * dfr["chi_cont"] < dfr["chi_escat"]))
    assert int(thick_d.sum()) == int(ink["misc"][4])
    assert int(escat_d.sum()) == int(ink["misc"][3])
    assert torch.equal(thick_d | escat_d, scat)
    assert torch.equal(dfr["where"], ink["where"])
    for k in ("prop_time", "posx", "nu_cmf"):
        assert torch.equal(dfr[k], ink[k]), k

    # through rpkt_step: the event pass counts the electron scatterings
    st = p["st"]
    opts = p["opts"].replace(rpkt_crossings_per_dispatch=1)
    out = teng.rpkt_step((7,), st, p["est"], ctx, grid, dad, cells, opts, 4, test_draws=draws)
    assert _escounter(out[1]) > 0
    st2 = out[0]
    scattered = (st2.nscatterings > st.nscatterings) & (st2.ptype == st.ptype)
    assert bool(scattered.any())
    assert int(np.asarray(out[1].counters)[stats.INTERACTIONS]) == int(ev_d.sum())

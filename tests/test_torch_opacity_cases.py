"""The grey opacity cases 0-3 on the port against the JAX package, on the
CPU.

- ``kappagrey`` at tmin of cases 0, 1, 2 and 3 as the JAX package's
  ``_calculate_kappagrey_initial`` computes it, to rtol 1e-12 (float64
  host arithmetic on both sides), and case 3's ``opcase3_normal``.
- tests/test_grid.py::test_opacity_case3_rho_crit_regime_switch on the
  port: ``rho_crit`` of timesteps 0 and 4 as the JAX package's, both
  regimes of kappagrey at timestep 0 and every cell below rho_crit at
  timestep 4, to rtol 1e-12.
- tests/test_configmatrix.py::test_grey_thin_limit_analytic's case-0
  oracle on the port: the packets that decay early escape, each with the
  pellet energy up to O(v/c).
- The crossing's free-free continuum (``ff_only``, the kernel's field for
  opacity_case < 4) through the port's rpkt_step against the JAX XLA
  rpkt_step at opacity_case 0 and 3, lane for lane with injected tag-51
  optical depths, to the tolerances of tests/test_pallas_rpkt.py:122-163
  (lane outcomes > 97 %, float state rtol 2e-3, J / nuJ / ffheating to
  5e-3, crossing counts within 2 % + 3), with the detailed bf-rate rows
  (1e-2, the LUT tolerance), which accumulate below case 4 too, and the
  LUT gamma / bf-heating rows and electron scatterings, which stay zero.
- Timesteps 0-2 of a case-3 run of both packages from the same pellets:
  kappagrey and rho_crit of every timestep to rtol 1e-12, the escaped
  luminosity and J within 4/sqrt(n) (tests/test_physics_validation.py),
  and no electron scattering or bound-free event on either side.
- A virtual-packet trace at case 0 against the JAX ``trace_vpkts``: every
  Stokes bin to rtol 1e-9; the channels without electron scattering and
  without bound-free opacity equal the full one."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.packets import TYPE_RPKT
from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts

torch.set_num_threads(1)

OPT_KW = dict(mintemp=1000.0, maxtemp=20000.0, tablesize=16)
NPKTS = 512


def _sims(d, jopts):
    """Both packages' Simulation of the run directory ``d`` (the port's in
    float32 transport; the caller closes it)."""
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td

    sj = jd.Simulation(d, jopts, datadir="/nonexistent")
    st = td.Simulation(d, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    return sj, st


def _lte_opts(**kw):
    import artis_tpu.options as jo

    return jo.kilonova_lte(grid_type=jo.GridType.SPHERICAL1D, **dict(OPT_KW, **kw))


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_kappagrey_initial_matches_jax(tmp_path, case):
    make_run(str(tmp_path), ncells=6, ntimesteps=6, tmin_days=0.4, tmax_days=8.0, ngreyts=6,
             opacity_case=case, rho_crit_para=7.5e-9, num_lte_timesteps=999)
    sj, st = _sims(str(tmp_path), _lte_opts(npkts=64))
    st.close()
    np.testing.assert_allclose(st._kappagrey_np, np.asarray(sj.cells.kappagrey), rtol=1e-12)
    np.testing.assert_allclose(st.cells.kappagrey.numpy(), st._kappagrey_np, rtol=1e-6)
    if case == 3:
        assert st.opcase3_normal == pytest.approx(sj.opcase3_normal, rel=1e-12)


def test_opacity_case3_rho_crit_regime_switch(tmp_path):
    """tests/test_grid.py's assertions on the port, with the JAX package's
    rho_crit beside it."""
    d = str(tmp_path)
    make_run(d, ncells=6, ntimesteps=6, tmin_days=0.4, tmax_days=8.0, ngreyts=6,
             opacity_case=3, rho_crit_para=7.5e-9, num_lte_timesteps=999)
    sj, sim = _sims(d, _lte_opts(npkts=64))
    assert sim.params.opacity_case == 3
    mgi = sim.mgi_of_nonempty
    full = sim.opcase3_normal * (0.9 * sim.model.ffegrp[mgi] + 0.1)

    sim.update_grid(0)
    sj.update_grid(0)
    assert sim.rho_crit == pytest.approx(sj.rho_crit, rel=1e-12)
    rho0 = sim.rho_tmin_nonempty / (float(sim.ts.mid[0]) / sim.params.tmin) ** 3
    k0 = sim._kappagrey_np
    np.testing.assert_allclose(k0, np.asarray(sj.cells.kappagrey), rtol=1e-12)
    dense0 = rho0 > sim.rho_crit
    assert dense0.any() and not dense0.all()
    np.testing.assert_allclose(k0[dense0], full[dense0] * sim.rho_crit / rho0[dense0],
                               rtol=1e-12)
    np.testing.assert_allclose(k0[~dense0], full[~dense0], rtol=1e-12)
    rho_crit_0 = sim.rho_crit

    sim.update_grid(4)
    sj.update_grid(4)
    assert sim.rho_crit == pytest.approx(sj.rho_crit, rel=1e-12)
    rho4 = sim.rho_tmin_nonempty / (float(sim.ts.mid[4]) / sim.params.tmin) ** 3
    assert sim.rho_crit < rho_crit_0
    assert np.all(rho4 < sim.rho_crit)
    np.testing.assert_allclose(sim._kappagrey_np, full, rtol=1e-12)
    np.testing.assert_allclose(sim._kappagrey_np, np.asarray(sj.cells.kappagrey), rtol=1e-12)
    sim.close()


def test_grey_thin_limit_analytic(tmp_path):
    """tests/test_configmatrix.py's case-0 oracle on the port: with tau_grey
    ~ 1e-4 every packet activated early enough free-streams out, with the
    pellet energy e0 (scaled by tdecay / tmin for decays before tmin) up to
    O(v/c) Doppler factors."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.options import GridType, ThermalisationScheme, kilonova_lte
    from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_RADIOACTIVE_PELLET

    d = str(tmp_path)
    make_run(d, ncells=5, ntimesteps=5, tmin_days=1.5, tmax_days=6.0, ngreyts=99,
             opacity_case=0, logrho0=-16.0)
    opts = kilonova_lte(npkts=384, grid_type=GridType.SPHERICAL1D, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=12, transport_dtype="float32",
                        particle_thermalisation_scheme=ThermalisationScheme.INSTANT)
    sim = Simulation(d, opts, datadir="/nonexistent", device="cpu")
    for ts in range(4):
        sim.do_timestep(ts)
    sim.close()
    st = sim.state
    types_ = st.ptype.numpy()
    tdec = st.tdecay.double().numpy()
    t_end = float(sim.ts.start[4])
    rmax_end = float(sim.grid.rmax) * t_end / float(sim.params.tmin)
    margin = 2.0 * rmax_end / 2.99792458e10
    early = (tdec > 0) & (tdec < t_end - margin) & (types_ != TYPE_RADIOACTIVE_PELLET)
    esc = types_ == TYPE_ESCAPE
    assert early.sum() > 50
    assert esc[early].mean() > 0.97, esc[early].mean()
    tmin = float(sim.params.tmin)
    expected = np.minimum(np.maximum(tdec, 1e-30) / tmin, 1.0)[esc]
    ratio = st.e_rf.double().numpy()[esc] / expected
    inside = (ratio > 0.75) & (ratio < 1.35)
    assert inside.mean() > 0.9, (inside.mean(), ratio.min(), ratio.max())
    assert abs(np.mean(ratio[inside]) - 1.0) < 0.1


@pytest.fixture(scope="module")
def crossing_scene(tmp_path_factory):
    """test_torch_rpkt_kernel.py's scene (8 shells, days 2-4, no grey
    timestep) with the detailed bf-rate estimators: the JAX package's
    timestep-0 grid update."""
    import artis_tpu.driver as jd

    d = str(tmp_path_factory.mktemp("ff_crossing"))
    make_run(d, ncells=8, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0)
    opts = _lte_opts(npkts=NPKTS, linewalk_chunk=128, rpkt_crossings_per_dispatch=4,
                     detailed_bf_estimators_on=True, tablesize=20)
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    # at timestep 0's 1000 K free-free is negligible; singly ionised at 1e4 K
    # and 1e3 times denser in electrons (chip_smoke.dense_tables) it makes
    # the continuum events of the free-free continuum
    rho = np.asarray(sim.cells.rho)
    te = np.full_like(rho, 1.0e4)
    nne = rho / (56.0 * 1.66054e-24) * 1.0e3
    cells = sim.cells.replace(Te=jnp.asarray(te), nne=jnp.asarray(nne))
    ctx = dataclasses.replace(ctx, chi_ff_nnionpart=jnp.asarray(nne * 3.69255e8 / np.sqrt(te)))
    return dict(sim=sim, opts=opts, ctx=ctx, cells=cells, est=sim._zero_est())


def _forced_state(sc, seed=3, nu_logrange=(14.2, 15.95)):
    """In-flight r-packets over the shells (tests/test_pallas_rpkt.py),
    with frequencies across the bf windows."""
    rng = np.random.default_rng(seed)
    sim, ctx = sc["sim"], sc["ctx"]
    grid, st = sim.grid, sim.state
    n = st.npkts
    t0 = float(ctx.ts)
    ncell = int(grid.ncoordgrid[0])
    cell = rng.integers(0, ncell, n)
    rmin = np.asarray(grid.cell_pos_min[:ncell, 0]) * t0 / float(grid.tmin)
    rmax = np.asarray(grid.cell_pos_max[:ncell, 0]) * t0 / float(grid.tmin)
    r = rmin[cell] + (rmax[cell] - rmin[cell]) * rng.uniform(0.02, 0.98, n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(*nu_logrange, n)
    return st.replace(
        ptype=jnp.full(n, TYPE_RPKT, jnp.int32), pos=jnp.asarray(u * r[:, None]),
        dir=jnp.asarray(dv), where=jnp.asarray(cell, jnp.int32),
        prop_time=jnp.full(n, t0), nu_rf=jnp.asarray(nu), nu_cmf=jnp.asarray(nu * 0.98),
        e_rf=jnp.ones(n), e_cmf=jnp.full(n, 0.98), next_trans=jnp.zeros(n, jnp.int32))


def _run_xla(sc, st, tau_u, case):
    orig = jeng._uniform

    def patched(key, tag, n, dtype):
        return jnp.asarray(tau_u, dtype) if tag == 51 else orig(key, tag, n, dtype)

    jeng._uniform = patched
    try:
        return jeng.rpkt_step(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"], sc["sim"].grid,
                              sc["sim"].dad, sc["cells"], sc["opts"], case)
    finally:
        jeng._uniform = orig


def _run_port(sc, st, tau, case):
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.estimators import Estimators
    from artis_tpu_torch.grid import GridData
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport.engine import StepContext

    sim, f32 = sc["sim"], torch.float32
    conv = interop.from_numpy
    draws = (torch.as_tensor(tau), torch.full((tau.size,), 0.5))
    return teng.rpkt_step(
        (7,), conv(PacketState, np_fields(st), dtype=f32),
        conv(Estimators, np_fields(sc["est"]), dtype=f32),
        conv(StepContext, np_fields(sc["ctx"]), dtype=f32),
        conv(GridData, np_fields(sim.grid), dtype=torch.float64),
        conv(DeviceAtomicData, np_fields(sim.dad), dtype=f32),
        conv(CellState, np_fields(sc["cells"]), dtype=f32),
        port_opts(sc["opts"], transport_dtype="float32"), case, test_draws=draws)


@pytest.mark.parametrize("case", [0, 3])
def test_ff_only_crossing_matches_xla_path(crossing_scene, case):
    from artis_tpu_torch import stats

    st0 = _forced_state(crossing_scene)
    rng = np.random.default_rng(42)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    st_j, est_j, mam_j, *_, nadv_j = _run_xla(crossing_scene, st0, tau_u, case)
    st_t, est_t, mam_t, *_, nadv_t = _run_port(crossing_scene, st0, tau, case)
    wj, wt = np.asarray(st_j.where), st_t.where.numpy()
    pj, pt = np.asarray(st_j.ptype), st_t.ptype.numpy()
    assert np.mean(wj == wt) > 0.97 and np.mean(pj == pt) > 0.97
    both = (wj == wt) & (pj == pt)
    for name in ("prop_time", "nu_cmf", "e_cmf"):
        np.testing.assert_allclose(getattr(st_t, name).numpy()[both],
                                   np.asarray(getattr(st_j, name))[both], rtol=2e-3,
                                   atol=1e-30, err_msg=name)
    px, pp = np.asarray(st_j.pos)[both], st_t.pos.numpy()[both]
    scale = np.maximum(np.linalg.norm(px, axis=1, keepdims=True), 1e-30)
    assert np.max(np.abs(px - pp) / scale) < 2e-3
    mam_j, mam_t = np.asarray(mam_j), mam_t.numpy()
    assert np.mean(mam_j[both] == mam_t[both]) > 0.97 and mam_t.sum() > 0
    for name, rtol in (("j", 5e-3), ("nuj", 5e-3), ("ffheating", 5e-3), ("bfrate", 1e-2)):
        a = np.asarray(getattr(est_j, name)).sum()
        b = getattr(est_t, name).numpy().sum()
        assert a > 0 and b == pytest.approx(a, rel=rtol), name
    for name in ("gammaestimator", "bfheatingestimator"):
        assert not np.asarray(getattr(est_j, name)).any()
        assert not getattr(est_t, name).numpy().any(), name
    # a free-free continuum: continuum events become k-packets, none is an
    # electron scattering or a bound-free absorption
    cj, ct = np.asarray(est_j.counters), est_t.counters.numpy()
    for c in (stats.ESCOUNTER, stats.K_STAT_FROM_BF, stats.MA_STAT_ACTIVATION_BF):
        assert cj[c] == 0 and ct[c] == 0, stats.COUNTER_NAMES[c]
    assert ct[stats.K_STAT_FROM_FF] > 0 and cj[stats.K_STAT_FROM_FF] > 0
    assert abs(int(nadv_j) - int(nadv_t)) <= max(3, 0.02 * int(nadv_j) + 3)


@pytest.fixture(scope="module")
def case3_runs(tmp_path_factory):
    """Timesteps 0-2 of a case-3 run (8 shells, days 2-4, timestep 0 grey;
    rho_crit_para 1e-7: the inner shells lie above rho_crit in every
    timestep, the outer ones below) of both packages from the JAX
    package's pellets, with kappagrey and rho_crit of each timestep."""
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td

    dj, dt = (str(tmp_path_factory.mktemp(f"case3_{k}")) for k in ("jax", "torch"))
    for d in (dj, dt):
        make_run(d, ncells=8, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=1,
                 logrho0=-8.0, opacity_case=3, rho_crit_para=1e-7)
    jopts = _lte_opts(npkts=1000, tablesize=20, rpkt_crossings_per_dispatch=16)
    sj = jd.Simulation(dj, jopts, datadir="/nonexistent")
    st = td.Simulation(dt, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    grey = []
    for ts in range(3):
        sj.do_timestep(ts)
        st.do_timestep(ts)
        grey.append((np.asarray(sj.cells.kappagrey), st._kappagrey_np, sj.rho_crit, st.rho_crit,
                     sj.rho_tmin_nonempty / (float(sj.ts.mid[ts]) / sj.params.tmin) ** 3))
    st.close()
    return sj, st, grey


def test_case3_timesteps_kappagrey(case3_runs):
    _, _, grey = case3_runs
    for kj, kt, rj, rt, rho in grey:
        assert rt == pytest.approx(rj, rel=1e-12)
        np.testing.assert_allclose(kt, kj, rtol=1e-12)
        assert (rho > rt).any() and (rho < rt).any()


def test_case3_timesteps_match_jax_in_mc_noise(case3_runs):
    from artis_tpu import stats as jstats
    from artis_tpu_torch import stats

    sj, st, _ = case3_runs
    n_esc = int(sj._escaped_counted.sum())
    tol = 4.0 / np.sqrt(n_esc)
    for a, b, name in ((sj.cmf_lum_ts.sum(), st.cmf_lum_ts.sum(), "cmf_lum"),
                       (sj.lc_lum.sum(), st.lc_lum.sum(), "lc_lum"),
                       (float(np.asarray(sj.est.j).sum()), float(st.est.j.sum()), "J")):
        assert abs(b - a) <= tol * abs(a), (name, a, b, tol)
    cj, ct = np.asarray(sj.est.counters), st.est.counters.numpy()
    assert cj[jstats.ESCOUNTER] == 0 and ct[stats.ESCOUNTER] == 0
    assert cj[jstats.K_STAT_FROM_BF] == 0 and ct[stats.K_STAT_FROM_BF] == 0


@pytest.fixture(scope="module")
def vpkt_scene(tmp_path_factory):
    """tests/test_torch_vpkt.py's classic miniature (6 shells on a 6^3
    grid, days 1-2) at opacity_case 0 with its vpkt.txt: the JAX package's
    timestep-0 grid update in float64 and the port's Simulation."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    from test_torch_vpkt import VPKT_TXT

    d = tmp_path_factory.mktemp("vpkt_case0")
    make_run(str(d), ncells=6, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-7.0, opacity_case=0)
    (d / "vpkt.txt").write_text(VPKT_TXT)
    jopts = jo.classic(npkts=64, grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=6,
                       ncoordgrid_y=6, ncoordgrid_z=6, mintemp=1000.0, maxtemp=20000.0,
                       tablesize=12, vpkt_on=True)
    sj = jd.Simulation(str(d), jopts, datadir="/nonexistent")
    jctx = sj.update_grid(0)
    st = td.Simulation(str(d), port_opts(jopts, transport_dtype="float64"),
                       datadir="/nonexistent", device="cpu")
    st.close()
    return sj, jctx, st


def test_vpkt_trace_case0_matches_jax(vpkt_scene):
    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch import interop as tinterop
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.transport import vpkt as tv
    from test_torch_vpkt import _rays

    sj, jctx, st = vpkt_scene
    rays = _rays(st, float(sj.ts.mid[0]))
    jcfg, tcfg = sj.vpkt_cfg, st.vpkt_cfg
    shp = (jcfg.nobs, int(jcfg.vgrid_numin.shape[0]), jcfg.vgrid_ny, jcfg.vgrid_nz, 3)
    jcum = (jctx.vpkt_cum_tau, jctx.vpkt_cum_taunu)
    jvs, _ = jv.trace_vpkts(
        jcfg, jv.zero_vspectra(jcfg, jnp.float64), sj.dad, sj.grid, sj.cells, jctx, *jcum,
        jnp.asarray(rays["pos"]), jnp.asarray(rays["dir"]), jnp.asarray(rays["t"]),
        jnp.asarray(rays["where"], jnp.int32), jnp.asarray(rays["nu"]), jnp.asarray(rays["e"]),
        jnp.asarray(rays["qu"]), jnp.asarray(rays["scatter"]), jnp.asarray(rays["active"]),
        opacity_case=0, vgrid_acc=jnp.zeros(shp))
    cells = tinterop.from_numpy(CellState, np_fields(sj.cells), dtype=torch.float64)
    ctx = types.SimpleNamespace(**{k: torch.as_tensor(np.asarray(getattr(jctx, k)))
                                   for k in ("bf_a", "bf_dep", "chi_ff_nnionpart")})
    t = {k: torch.as_tensor(v) for k, v in rays.items()}
    tvs, _ = tv.trace_vpkts(
        tcfg, tv.zero_vspectra(tcfg, torch.float64), st.dad, st.grid, cells, ctx,
        *(torch.as_tensor(np.asarray(x)) for x in jcum), t["pos"], t["dir"], t["t"], t["where"],
        t["nu"], t["e"], t["qu"], t["scatter"], t["active"], 0,
        vgrid_acc=torch.zeros(shp, dtype=torch.float64))
    a, b = np.asarray(jvs), tvs.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12 * np.abs(a).max())
    assert b[..., 0].sum() > 0
    # the channels without electron scattering (-4) and without bound-free
    # opacity (-2) see the free-free continuum of the full channel (0)
    chan = list(tcfg.exclude)
    for e in (-2, -4):
        np.testing.assert_array_equal(b[:, chan.index(e)], b[:, chan.index(0)])

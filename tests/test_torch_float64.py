"""The float64 crossing (the default ``transport_dtype`` of both packages)
against the JAX package's float64 XLA path, on the CPU.

- Lane for lane: the port's ``engine.rpkt_step`` (the plain version of the
  crossing kernel in float64, ``test_draws`` injected) against the JAX
  package's float64 ``rpkt_step`` (its XLA crossing loop,
  ``_rpkt_propagate_once``; run as the JAX tests run it) with the same
  optical depths
  injected as tag 51, the same uniform as the continuum selection, the
  continuum split (tag 52) and the expansion-opacity bin split (tag 59),
  in every configuration of the kernel table: the 1D line walk (K1), the
  3D walk with the detailed bf-rate rows (K2, K5-bfrate), the cylinder
  (K3), binned expansion opacities (K4) on the 1D, 3D and cylindrical
  grids (the cylinder's with the multibin rows), the deferred events with
  grey cells (K6), the multibin and J_b_lu estimators (K5-multibin,
  K5-jblue) on the 1D and the cylindrical line walk (the latter with LUT
  photoionisation and bf heating off) and the free-free continuum of
  opacity case 3 (ff-only). Both event
  passes are replaced by a probe of their inputs, which are compared
  instead. The kernel scatters electrons and thick-cell packets in flight
  where the XLA path ends the crossing at the event: those lanes must be
  the XLA path's scatter events, one for one, and are held still in a
  second pair of runs whose estimators are compared. Every other lane's
  integer outputs (cell, packet type, line cursor, event kind, continuum,
  activating line, model cell) are equal, its float outputs within
  ``RTOL`` = 1e-9, every estimator cell and counter within ``RTOL`` too
  (the float32 crossing against the same path takes 2e-3,
  tests/test_torch_rpkt_kernel.py).
- Whole timesteps: timesteps 0-1 of the default slice (8 shells, both
  packages from the JAX package's pellets, float64 end to end): escaped
  luminosity and the light curve, escaped packets, J and nuJ of each
  timestep's transport over the volume and per-cell T_e of the grid
  updates after them within 4/sqrt(n) (tests/test_torch_slice.py);
  per-cell T_e and nne of the port's grid update after timestep 1 equal
  to the JAX package's on the port's estimators and cells (nne moves by
  orders of magnitude with a few per cent of T_e in these cells, so two
  independent runs cannot be held to 4/sqrt(n) in it).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
import artis_tpu.transport.opacity as jopacity
from artis_tpu.packets import TYPE_ESCAPE, TYPE_RPKT
from artis_tpu.synthdata import make_run
from test_torch_grid3d import forced_state, np_fields, port_opts

torch.set_num_threads(1)

RTOL = 1e-9
NPKTS = 256
MAX_INNER = 4
SEL = 0.5
OPT_KW = dict(npkts=NPKTS, mintemp=1000.0, maxtemp=20000.0, tablesize=16,
              linewalk_chunk=64, rpkt_crossings_per_dispatch=MAX_INNER)
F64 = torch.float64


def _scene(tmp_path_factory, name, make_kw, opts_kw, preset="kilonova_lte"):
    """A JAX float64 Simulation after timestep 0's grid update."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    d = str(tmp_path_factory.mktemp(name))
    make_run(d, **dict(dict(ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0,
                            logrho0=-8.0), **make_kw))
    opts = getattr(jo, preset)(**dict(OPT_KW, **opts_kw))
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    return dict(sim=sim, opts=opts, ctx=ctx, est=sim._zero_est(), cells=sim.cells)


def _shell_state(sc, seed):
    """In-flight r-packets over the shells of a 1D grid
    (tests/test_pallas_rpkt.py)."""
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
    nu = 10 ** rng.uniform(14.2, 15.6, n)
    return st.replace(
        ptype=jnp.full(n, TYPE_RPKT, jnp.int32), pos=jnp.asarray(u * r[:, None]),
        dir=jnp.asarray(dv), where=jnp.asarray(cell, jnp.int32),
        prop_time=jnp.full(n, t0), nu_rf=jnp.asarray(nu), nu_cmf=jnp.asarray(nu * 0.98),
        e_rf=jnp.ones(n), e_cmf=jnp.full(n, 0.98), next_trans=jnp.zeros(n, jnp.int32))


def _ionised(cells, factor=1.0e3):
    """The same cells at 1e4 K with 1e3 times more electrons (singly
    ionised): free-free and electron scattering take a share of the
    continuum events beside bound-free."""
    rho = np.asarray(cells.rho)
    nne = rho / (56.0 * 1.66054e-24) * factor
    return cells.replace(Te=jnp.full_like(cells.Te, 1.0e4), nne=jnp.asarray(nne))


class _Probe:
    """Replaces an event pass by a record of its inputs. The JAX package's
    pass runs under the traced lax.cond of its rpkt_step, so there the
    inputs leave through the outputs: the macro-atom triple carries
    take_event, the continuum and the activating line, and fields of the
    packet state that the comparison does not read carry the rest
    (``xla_events``)."""

    def __init__(self, torch_side):
        self.torch_side, self.args = torch_side, None

    def __call__(self, key, st, est, ctx, grid, dad, cells, opts, opacity_case, take_event,
                 thick, is_bb, chi_escat, chi_ff, chi_bf, chi_cont_cmf, bf_contindex, act_line,
                 nonemptymgi, no_escat=False):
        if not self.torch_side:
            i32 = jnp.int32
            st = st.replace(stokes=jnp.stack([chi_escat, chi_ff, chi_bf], axis=1),
                            em_time=chi_cont_cmf, emissiontype=nonemptymgi.astype(i32),
                            absorptiontype=(2 * thick + is_bb).astype(i32))
            return st, est, take_event, bf_contindex.astype(i32), act_line.astype(i32)
        conv = lambda x: x.numpy()
        self.args = dict(take_event=conv(take_event), thick=conv(thick), is_bb=conv(is_bb),
                         chi_escat=conv(chi_escat), chi_ff=conv(chi_ff), chi_bf=conv(chi_bf),
                         chi_cont=conv(chi_cont_cmf), bf_idx=conv(bf_contindex),
                         act_line=conv(act_line), mgi=conv(nonemptymgi))
        n = take_event.shape[0]
        z = torch.zeros(n, dtype=torch.int32)
        return st, est, torch.zeros(n, dtype=torch.bool), z, z - 99


def xla_events(out):
    """The event-pass inputs of a JAX rpkt_step run with the probe."""
    st, take_event = out[0], np.asarray(out[2])
    sto, kind = np.asarray(st.stokes), np.asarray(st.absorptiontype)
    return dict(take_event=take_event, thick=take_event & (kind >= 2),
                is_bb=take_event & (kind % 2 == 1), chi_escat=sto[:, 0], chi_ff=sto[:, 1],
                chi_bf=sto[:, 2], chi_cont=np.asarray(st.em_time), bf_idx=np.asarray(out[3]),
                act_line=np.asarray(out[4]), mgi=np.asarray(st.emissiontype))


class _SelUniform:
    """jax.random in the JAX package's opacity module with its continuum
    selection drawing ``sel``."""

    def __init__(self, sel):
        self.sel = sel

    def uniform(self, key, shape, dtype=jnp.float64, *a, **k):
        return jnp.asarray(self.sel, dtype).reshape(shape)

    def __getattr__(self, name):
        return getattr(jax.random, name)


def _run_xla(sc, st, tau_u, sel, case, opts):
    """The JAX package's float64 rpkt_step, draws injected; returns (st,
    est, event-pass inputs)."""
    probe = _Probe(False)
    orig_u, orig_apply, orig_jax = jeng._uniform, jeng._rpkt_apply_events, jopacity.jax
    draws = {51: tau_u, 52: sel, 59: sel}

    def patched(key, tag, n, dtype):
        return jnp.asarray(draws[tag], dtype) if tag in draws else orig_u(key, tag, n, dtype)

    class _J:
        random = _SelUniform(sel)

        def __getattr__(self, name):
            return getattr(jax, name)

    jeng._uniform, jeng._rpkt_apply_events, jopacity.jax = patched, probe, _J()
    try:
        out = jeng.rpkt_step(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"], sc["sim"].grid,
                             sc["sim"].dad, sc["cells"], opts, case)
    finally:
        jeng._uniform, jeng._rpkt_apply_events, jopacity.jax = orig_u, orig_apply, orig_jax
    return out[0], out[1], xla_events(out)


def _run_port(sc, st, tau, sel, case, opts):
    """The port's rpkt_step in float64 (the crossing's plain version) with
    ``test_draws``; returns (st, est, event-pass inputs)."""
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.estimators import Estimators
    from artis_tpu_torch.grid import GridData
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport.engine import StepContext

    sim = sc["sim"]
    conv = interop.from_numpy
    probe = _Probe(True)
    orig = teng._rpkt_apply_events
    teng._rpkt_apply_events = probe
    try:
        out = teng.rpkt_step(
            (7,), conv(PacketState, np_fields(st), dtype=F64),
            conv(Estimators, np_fields(sc["est"]), dtype=F64),
            conv(StepContext, np_fields(sc["ctx"]), dtype=F64),
            conv(GridData, np_fields(sim.grid), dtype=F64),
            conv(DeviceAtomicData, np_fields(sim.dad), dtype=F64),
            conv(CellState, np_fields(sc["cells"]), dtype=F64),
            port_opts(opts), case,
            test_draws=(torch.as_tensor(tau), torch.full((tau.size,), sel)))
    finally:
        teng._rpkt_apply_events = orig
    return out[0], out[1], probe.args


EST_FIELDS = ("j", "nuj", "ffheating", "gammaestimator", "bfheatingestimator", "bfrate",
              "radfieldbin_j", "radfieldbin_nuj", "radfieldbin_count", "jblue_raw",
              "jblue_count", "nesc", "cmf_lum")
STATE_INT = ("where", "ptype", "next_trans")
STATE_FLOAT = ("pos", "dir", "nu_rf", "e_rf", "prop_time", "nu_cmf", "e_cmf")
EVENT_INT = ("take_event", "thick", "is_bb", "bf_idx", "act_line", "mgi")
EVENT_FLOAT = ("chi_escat", "chi_ff", "chi_bf", "chi_cont")


def _close(a, b, name):
    """b within RTOL of a, entry by entry; vectors (rows of an (n, 3)
    array: positions, directions) by their length."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 2 and a.shape[1] == 3:
        err, scale = np.linalg.norm(b - a, axis=1), np.linalg.norm(a, axis=1)
    else:
        err, scale = np.abs(b - a), np.abs(a)
    assert np.all(err <= RTOL * scale + 1e-300), (name, float(np.max(err / np.maximum(scale,
                                                                                     1e-300))))


def _crossing_matches(sc, st0, case=4, defer=False, **want):
    """Both rpkt_steps from ``st0``; returns what the lanes did (for the
    callers' coverage checks)."""
    from artis_tpu_torch import stats

    rng = np.random.default_rng(42)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(tau_u)
    sel = np.full(NPKTS, SEL)
    opts = sc["opts"]
    st_j, est_j, ev_j = _run_xla(sc, st0, tau_u, sel, case, opts)
    st_t, est_t, ev_t = _run_port(sc, st0, tau, SEL, case, opts)
    assert ev_j is not None and ev_t is not None
    # the lanes the kernel scattered in flight (electron or thick-cell
    # scattering) are the XLA path's scatter events
    scat_t = (st_t.nscatterings.numpy() > 0)
    ev = ev_j["take_event"]
    scat_j = ev & (ev_j["thick"] | (~ev_j["is_bb"] & (SEL * ev_j["chi_cont"]
                                                     < ev_j["chi_escat"])))
    if defer:
        assert not scat_t.any()
    else:
        np.testing.assert_array_equal(scat_t, scat_j)
        once = scat_t & (st_t.nscatterings.numpy() == 1)
        _close(np.asarray(st_j.pos)[once], st_t.em_pos.numpy()[once], "em_pos")
        _close(np.asarray(st_j.prop_time)[once], st_t.em_time.numpy()[once], "em_time")
    keep = ~scat_t
    for name in STATE_INT:
        np.testing.assert_array_equal(getattr(st_t, name).numpy()[keep],
                                      np.asarray(getattr(st_j, name))[keep], err_msg=name)
    for name in STATE_FLOAT:
        _close(np.asarray(getattr(st_j, name))[keep], getattr(st_t, name).numpy()[keep], name)
    evk = keep & ev
    np.testing.assert_array_equal(ev_t["take_event"][keep], ev[keep])
    # the continuum of bound-free events (the split of the event pass)
    bf_ev = evk & ~ev_j["thick"] & ~ev_j["is_bb"] & (
        SEL * ev_j["chi_cont"] >= ev_j["chi_escat"] + ev_j["chi_ff"])
    for name in EVENT_INT:
        sel_l = bf_ev if name == "bf_idx" else evk
        np.testing.assert_array_equal(ev_t[name][sel_l].astype(np.int64),
                                      ev_j[name][sel_l].astype(np.int64), err_msg=name)
    for name in EVENT_FLOAT:
        _close(ev_j[name][evk], ev_t[name][evk], name)

    # the estimators, with the lanes the kernel scattered held still on both
    # sides (their paths part at the scatter)
    if scat_t.any():
        t2 = float(sc["ctx"].t2)
        st0 = st0.replace(prop_time=jnp.where(jnp.asarray(scat_t), t2, st0.prop_time))
        st_j, est_j, _ = _run_xla(sc, st0, tau_u, sel, case, opts)
        st_t, est_t, _ = _run_port(sc, st0, tau, SEL, case, opts)
    for name in EST_FIELDS:
        _close(np.asarray(getattr(est_j, name)), getattr(est_t, name).numpy(), name)
    cj, ct = np.asarray(est_j.counters), est_t.counters.numpy()
    assert ct[stats.CELLCROSSINGS] == cj[stats.CELLCROSSINGS]
    kinds = dict(events=int(evk.sum()), bb=int((evk & ev_j["is_bb"]).sum()), bf=int(bf_ev.sum()),
                 thick=int((evk & ev_j["thick"]).sum()), scattered=int(scat_t.sum()),
                 escaped=int((np.asarray(st_j.ptype) == TYPE_ESCAPE).sum()),
                 crossings=int(cj[stats.CELLCROSSINGS]))
    for k, v in want.items():
        assert kinds[k] > 0 if v else kinds[k] == 0, (k, kinds)
    return kinds, est_j


# ---------------------------------------------------------------------------
# the configurations of the kernel table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sph(tmp_path_factory):
    """8 shells with the tables of every 1D configuration (bf-rate rows,
    binned expansion opacities, multibin and J_b_lu estimators): each test
    runs the crossing with its own options."""
    return _scene(tmp_path_factory, "f64_sph", dict(ncells=8),
                  dict(grid_type=_gt("SPHERICAL1D"), detailed_bf_estimators_on=True,
                       expansionopacities_on=True, multibin_radfield=True,
                       detailed_line_estimators_on=True, jblue_elem_z=0))


@pytest.fixture(scope="module")
def cart(tmp_path_factory):
    """The 8 shells on a 6^3 grid with the bf-rate rows and binned
    expansion opacities."""
    return _scene(tmp_path_factory, "f64_cart", dict(ncells=8),
                  dict(grid_type=_gt("CARTESIAN3D"), ncoordgrid_x=6, ncoordgrid_y=6,
                       ncoordgrid_z=6, detailed_bf_estimators_on=True,
                       expansionopacities_on=True))


@pytest.fixture(scope="module")
def cyl(tmp_path_factory):
    """A 4 x 8 cylinder with the tables of every cylindrical configuration
    (binned expansion opacities, multibin and J_b_lu estimators)."""
    return _scene(tmp_path_factory, "f64_cyl", dict(ncells=4, model_dim=2),
                  dict(grid_type=_gt("CYLINDRICAL2D"), expansionopacities_on=True,
                       multibin_radfield=True, detailed_line_estimators_on=True,
                       jblue_elem_z=0))


def _gt(name):
    import artis_tpu.options as jo

    return jo.GridType[name]


def _with(sc, cells=None, **opts):
    """The scene with other cells or options (the line walk without the
    NLTE estimators and expansion opacities unless named)."""
    base = dict(expansionopacities_on=False, multibin_radfield=False,
                detailed_line_estimators_on=False)
    return dict(sc, cells=sc["cells"] if cells is None else cells,
                opts=sc["opts"].replace(**dict(base, **opts)))


def test_k1_line_walk(sph):
    sc = _with(sph, _ionised(sph["cells"]))
    kinds, est = _crossing_matches(sc, _shell_state(sc, 1), events=True, bb=True, bf=True,
                                   scattered=True, escaped=True, crossings=True)
    assert np.asarray(est.gammaestimator).sum() > 0 and np.asarray(est.bfrate).sum() > 0


def test_ff_only_case3(sph):
    sc = _with(sph, _ionised(sph["cells"]))
    kinds, est = _crossing_matches(sc, _shell_state(sc, 2), case=3, events=True, bf=False,
                                   scattered=False, crossings=True)
    assert not np.asarray(est.gammaestimator).any()
    assert np.asarray(est.ffheating).sum() > 0 and np.asarray(est.bfrate).sum() > 0


def _state(sc, scene, seed):
    return _shell_state(sc, seed) if scene == "sph" else forced_state(sc, seed=seed)


@pytest.mark.parametrize("scene, multibin", [("sph", False), ("cart", False), ("cyl", True)],
                         ids=["sph", "cart", "cyl_multibin"])
def test_k4_expansion_opacities(request, scene, multibin):
    """The bin walk of each geometry; on the cylinder with the multibin
    rows, the bin walk's instantiation with the NLTE fields."""
    sc = _with(request.getfixturevalue(scene), expansionopacities_on=True,
               multibin_radfield=multibin)
    kinds, est = _crossing_matches(sc, _state(sc, scene, 5), events=True, bb=True,
                                   crossings=True)
    assert np.asarray(est.radfieldbin_count).sum() > 0 or not multibin


@pytest.mark.parametrize("scene", ["sph", "cyl"])
def test_k5_multibin_and_jblue(request, scene):
    """The multibin and J_b_lu rows of the 1D line walk, and of the
    cylindrical one with LUT photoionisation and bf heating off (as
    nltenebular runs them: no LUT rows)."""
    lut = scene == "sph"
    sc = _with(request.getfixturevalue(scene), multibin_radfield=True,
               detailed_line_estimators_on=True, use_lut_photoion=lut, use_lut_bfheating=lut)
    kinds, est = _crossing_matches(sc, _state(sc, scene, 7), events=True, bb=True,
                                   crossings=True)
    assert np.asarray(est.radfieldbin_count).sum() > 0
    assert np.asarray(est.jblue_count).sum() > 0
    assert bool(np.asarray(est.gammaestimator).any()) == lut


def test_k2_bfrate_3d_walk(cart):
    sc = _with(cart)
    kinds, est = _crossing_matches(sc, forced_state(sc, seed=3, nu_logrange=(14.2, 15.9)),
                                   events=True, bb=True, bf=True, crossings=True)
    assert np.asarray(est.bfrate).sum() > 0


def test_k6_deferred_with_grey_cells(cart):
    """The deferred events of dipole scattering, every other cell grey at a
    grey opacity equal to its electron scattering."""
    cells = _ionised(cart["cells"])
    nne, rho = np.asarray(cells.nne), np.asarray(cells.rho)
    cells = cells.replace(thick=jnp.asarray(np.arange(nne.size) % 2, cells.thick.dtype),
                          kappagrey=jnp.asarray(6.6524e-25 * nne / np.maximum(rho, 1e-30)))
    sc = _with(cart, cells, dipole=True)
    _crossing_matches(sc, forced_state(sc, seed=6, nu_logrange=(14.2, 15.9)), defer=True,
                      events=True, thick=True, crossings=True)


def test_k3_cylinder(cyl):
    sc = _with(cyl)
    _crossing_matches(sc, forced_state(sc, seed=4), events=True, bb=True, crossings=True)


# ---------------------------------------------------------------------------
# whole timesteps
# ---------------------------------------------------------------------------


def _to_jax(obj, like):
    """A port dataclass (cells, estimators) as the JAX package's ``like``."""
    import dataclasses

    return like.replace(**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                           for f in dataclasses.fields(like)})


@pytest.fixture(scope="module")
def timesteps(tmp_path_factory):
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    import artis_tpu_torch.options as to
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    kw = dict(npkts=1000, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
              rpkt_crossings_per_dispatch=16)
    dj, dt = (str(tmp_path_factory.mktemp(f"f64_ts_{k}")) for k in ("jax", "torch"))
    # half a day to a day: most cells' T_e lie above the mintemp floor
    for d in (dj, dt):
        make_run(d, ncells=8, ntimesteps=3, tmin_days=0.5, tmax_days=1.0, ngreyts=0,
                 logrho0=-8.0)
    sj = jd.Simulation(dj, jo.kilonova_lte(grid_type=jo.GridType.SPHERICAL1D, **kw),
                       datadir="/nonexistent")
    st = td.Simulation(dt, to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, **kw),
                       datadir="/nonexistent", device="cpu")
    assert st.opts.transport_dtype == "float64" and sj.opts.transport_dtype == "float64"
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=F64)
    est = []
    for ts in range(2):
        sj.do_timestep(ts)
        st.do_timestep(ts)
        est.append({k: (np.asarray(getattr(sj.prev_est, k)), getattr(st.prev_est, k).numpy())
                    for k in ("j", "nuj")})
    cells = [(np.asarray(sj.cells.Te), np.asarray(sj.cells.nne)),
             (st.cells.Te.numpy(), st.cells.nne.numpy())]
    before = st.cells
    sj.update_grid(2)
    st.update_grid(2)
    cells += [(np.asarray(sj.cells.Te), np.asarray(sj.cells.nne)),
              (st.cells.Te.numpy(), st.cells.nne.numpy())]
    # the JAX package's grid update on the port's estimators and cells
    sj.cells = _to_jax(before, sj.cells)
    sj.prev_est = _to_jax(st.prev_est, sj.prev_est)
    sj.update_grid(2)
    injected = (np.asarray(sj.cells.Te), np.asarray(sj.cells.nne))
    vol = np.asarray(st._assoc_vol_model)
    st.close()
    return sj, st, cells, est, injected, vol


def _rel_close(a, b, n, name):
    assert n > 0, name
    tol = 4.0 / np.sqrt(n)
    assert abs(b - a) <= tol * abs(a), f"{name}: {a} vs {b} (tol {tol}, n={n})"


def test_timesteps_escaped_luminosity_and_packets(timesteps):
    sj, st = timesteps[:2]
    assert st.state.pos.dtype == F64
    n_esc = int(sj._escaped_counted.sum())
    for ts in range(2):
        _rel_close(sj.cmf_lum_ts[ts], st.cmf_lum_ts[ts], n_esc, f"cmf_lum[{ts}]")
    _rel_close(float(sj.lc_lum.sum()), float(st.lc_lum.sum()), n_esc, "light curve")
    pj, pt = np.asarray(sj.state.ptype), st.state.ptype.numpy()
    a, b = int(np.sum(pj == TYPE_ESCAPE)), int(np.sum(pt == TYPE_ESCAPE))
    assert abs(a - b) <= 4.0 * np.sqrt(max(a, 1)), (a, b)


def test_timesteps_cell_temperatures(timesteps):
    """T_e of the grid updates after timesteps 0 and 1 (each package's own
    estimators) within 4/sqrt(n), n the r-packets a cell holds on average;
    most cells lie above the mintemp floor."""
    sj, _, cells = timesteps[:3]
    n_cell = sj.opts.npkts / len(cells[0][0])
    for k in (0, 2):
        te_j, te_t = cells[k][0], cells[k + 1][0]
        assert np.sum(te_t > sj.opts.mintemp) > te_t.size // 2
        for c in range(te_j.size):
            _rel_close(float(te_j[c]), float(te_t[c]), n_cell, f"Te[{c}]")


def test_timesteps_path_estimators(timesteps):
    """J and nuJ of timesteps 0 and 1 (each package's own transport), the
    estimators that set T_e, integrated over the volume (sum of J_c V_c:
    the energy-weighted path length every packet adds to) within
    4/sqrt(npkts). Per cell the packets that cross a shell are too few to
    hold J to a count-based tolerance: T_e holds it per cell above."""
    sj, est, vol = timesteps[0], timesteps[3], timesteps[5]
    for ts, e in enumerate(est):
        for k in ("j", "nuj"):
            a, b = e[k]
            assert np.all(a > 0) and np.all(b > 0), (ts, k)
            _rel_close(float(a @ vol), float(b @ vol), sj.opts.npkts, f"{k} V ts {ts}")


def test_timesteps_cell_nne(timesteps):
    """T_e and nne of the port's grid update after timestep 1 against the
    JAX package's on the port's estimators and cells, in every cell, to
    rtol 1e-9: nne follows the transport through the port's J."""
    cells, (te_j, nne_j) = timesteps[2], timesteps[4]
    te_t, nne_t = cells[3]
    np.testing.assert_allclose(te_t, te_j, rtol=1e-9)
    np.testing.assert_allclose(nne_t, nne_j, rtol=1e-9)
    assert np.ptp(np.log10(nne_t)) > 1.0


@pytest.fixture(scope="module")
def f64_resumed(tmp_path_factory):
    """The default slice at the preset's float64 (400 packets, 6 shells):
    three timesteps straight, and two, a checkpoint and the third resumed
    from it; both runs then write their final outputs and packets file."""
    import artis_tpu_torch.options as to
    from artis_tpu_torch.driver import Simulation

    opts = to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, npkts=400, mintemp=1000.0,
                           maxtemp=20000.0, tablesize=20)
    assert opts.transport_dtype == "float64"
    d1 = str(tmp_path_factory.mktemp("f64_straight"))
    d2 = str(tmp_path_factory.mktemp("f64_resumed"))
    for d in (d1, d2):
        make_run(d, ncells=6, ntimesteps=3, tmax_days=2.0, ngreyts=1)
    sim_a = Simulation(d1, opts, device="cpu")
    for ts in range(3):
        sim_a.do_timestep(ts)
    sim_b1 = Simulation(d2, opts, device="cpu")
    for ts in range(2):
        sim_b1.do_timestep(ts)
    sim_b1.save_checkpoint(2)
    sim_b1.close()
    del sim_b1
    sim_b2 = Simulation(d2, opts, device="cpu")
    assert sim_b2.params.simulation_continued_from_saved
    assert sim_b2.params.timestep_start == 2
    sim_b2.do_timestep(2)
    for sim in (sim_a, sim_b2):
        sim.finish()
        sim.close()
    return sim_a, sim_b2, d1, d2


@pytest.mark.parametrize("part", ["state", "cells", "est"])
def test_checkpoint_resume_float64_bitwise(f64_resumed, part):
    """A float64 run resumed from its checkpoint is the straight run bit
    for bit, in float64 (the checkpoint keeps the packets' dtype)."""
    import dataclasses

    a, b = f64_resumed[:2]
    assert b.state.pos.dtype == F64 and b.state.e_cmf.dtype == F64
    oa, ob = getattr(a, part), getattr(b, part)
    for f in dataclasses.fields(oa):
        torch.testing.assert_close(getattr(ob, f.name), getattr(oa, f.name), rtol=0, atol=0,
                                   equal_nan=True, msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(a.lc_lum, b.lc_lum)
    np.testing.assert_array_equal(a.spec.flux, b.spec.flux)


def test_exspec_reads_float64_packets(f64_resumed, tmp_path_factory):
    """The float64 run's packets file, transport_log.json and exspec: the
    file holds the run's escaped packets (its frequencies to the six
    significant digits of the %g text format, packet.cc's), each timestep
    is logged, and the port's exspec writes what the JAX package's writes
    from it (rtol 1e-12)."""
    import json
    import shutil

    import artis_tpu.exspec as jex
    import artis_tpu.options as jo
    import artis_tpu_torch.exspec as tex
    import artis_tpu_torch.options as to
    from artis_tpu_torch.packets import TYPE_ESCAPE as T_ESC, read_packets_text

    sim, _, d1, d2 = f64_resumed
    p = read_packets_text(os.path.join(d1, "packets00_0000.out"))
    esc = sim.state.ptype.numpy() == T_ESC
    assert esc.sum() > 20 and np.array_equal(p["ptype"] == T_ESC, esc)
    np.testing.assert_allclose(p["nu_rf"][esc], sim.state.nu_rf.numpy()[esc], rtol=5e-6)
    for d, nts in ((d1, [0, 1, 2]), (d2, [2])):
        log = json.load(open(os.path.join(d, "transport_log.json")))
        assert [r["nts"] for r in log] == nts and all(r["completed"] for r in log)
    out = {}
    for name, run, opts in (("jax", jex.run_exspec, jo.kilonova_lte()),
                            ("port", tex.run_exspec, to.kilonova_lte())):
        d = str(tmp_path_factory.mktemp(f"f64_exspec_{name}"))
        shutil.copytree(d1, d, dirs_exist_ok=True)
        run(d, opts)
        out[name] = np.loadtxt(os.path.join(d, "spec.out"))
    assert np.any(out["port"][1:, 1:] > 0)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-12)

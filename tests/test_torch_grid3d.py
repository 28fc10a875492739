"""The port on the 3D Cartesian grid against the JAX package, on the CPU.

- grid_init for a 1D model on an 8^3 grid, a 2D (3 x 6) model on an 8^3
  grid and a 3D 6^3 model on its own grid: integer arrays equal, float
  arrays to rtol 1e-12 (the same float64 formulas on the same host data);
- boundary_distance (rtol 1e-9) and get_cellindex_from_pos (exact) in
  float64 on packets spread over the grid;
- gamma_step from the same gamma packets with the same injected uniforms
  (both packages' ``_uniform`` / ``_isotropic`` patched): lane outcomes
  equal, float state to rtol 1e-9 (both float64);
- the port's rpkt_step (the plain version of the crossing kernel) against
  the XLA path with injected tag-51 draws and against the Pallas kernel in
  interpret mode with _PALLAS_TEST_INJECT, on the scenes of
  tests/test_pallas_rpkt.py (1D model on 16^3 and 3D 6^3 model here; the
  2D model on 12^3 in tests/test_torch_grid2d.py), 512 packets at
  max_inner 1 and 4, with its tolerances: cell and packet type agree on
  > 0.95 of lanes (> 0.9 at max_inner 4), and prop_time / nu_cmf / e_cmf within rel 3e-3 on > 0.95 (0.9) of the
  agreeing lanes; J totals to 5e-2 (2e-1 at max_inner 4). The residual
  comes from float32 boundary ties (the port runs float32, the XLA path
  float64) and the Pallas kernel's float32 model mapping;
- one whole timestep of kilonova_1d_3dgrid (tests/test_configmatrix.py) at
  2000 packets against the JAX package within Monte Carlo noise: escaped
  luminosity, particle deposition and per-cell J by the 4/sqrt(n) rule of
  tests/test_torch_slice.py;
- check_supported accepts the new grids, the detailed bf-rate estimators,
  the expansion opacities, the classic preset (dipole / polarised
  scattering, rate-balance ionisation) and nltenebular without the
  non-thermal solver, and still raises for the options off the ported
  slice (the non-thermal solver, vpkt, XCOM, linestat).
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.packets import TYPE_GAMMA, TYPE_RPKT
from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

GRID_RTOL = 1e-12
DIST_RTOL = 1e-9
NPKTS = 512
OPT_KW = dict(npkts=NPKTS, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
              linewalk_chunk=128, pallas_block=256, rpkt_crossings_per_dispatch=4)


# ---------------------------------------------------------------------------
# helpers shared with tests/test_torch_grid2d.py
# ---------------------------------------------------------------------------


def np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_opts(jopts, **kw):
    """The port's Options with every field of the JAX package's ``jopts``."""
    import artis_tpu_torch.options as to

    vals = {}
    for f in dataclasses.fields(jopts):
        v = getattr(jopts, f.name)
        vals[f.name] = getattr(to, type(v).__name__)[v.name] if isinstance(v, enum.Enum) else v
    return to.Options(**vals).replace(**kw)


def assert_grids_equal(gj, gt):
    for f in dataclasses.fields(gt):
        a, b = getattr(gj, f.name), getattr(gt, f.name)
        if torch.is_tensor(b):
            a, b = np.asarray(a), b.cpu().numpy()
            assert a.shape == b.shape, (f.name, a.shape, b.shape)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=GRID_RTOL, atol=0, err_msg=f.name)
            else:
                np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64),
                                              err_msg=f.name)
        elif isinstance(b, enum.Enum):
            assert b.name == a.name, f.name
        elif isinstance(b, float):
            assert b == pytest.approx(float(a), rel=GRID_RTOL), f.name
        else:
            assert tuple(np.atleast_1d(b)) == tuple(np.atleast_1d(a)), f.name


def both_grids(d, grid_type_name, ncoord=(8, 8, 8)):
    """The JAX package's and the port's grid_init on one run directory."""
    import artis_tpu.grid as jg
    import artis_tpu.io.model as jm
    import artis_tpu.options as jo
    import artis_tpu_torch.grid as tg
    import artis_tpu_torch.io.model as tm
    import artis_tpu_torch.options as to
    from artis_tpu.io.inputparams import read_parameterfile

    tmin = read_parameterfile(f"{d}/input.txt").tmin
    gj, hj = jg.grid_init(jm.read_model(f"{d}/model.txt", tmin), tmin,
                          jo.GridType[grid_type_name], ncoord, with_host=True)
    gt, ht = tg.grid_init(tm.read_model(f"{d}/model.txt", tmin), tmin,
                          to.GridType[grid_type_name], ncoord, with_host=True)
    return gj, hj, gt, ht


def assert_geometry_matches(gj, gt, seed):
    """boundary_distance and get_cellindex_from_pos, float64, on packets
    spread over the grid at 1.3 tmin."""
    import artis_tpu.grid as jg
    import artis_tpu_torch.grid as tg

    rng = np.random.default_rng(seed)
    n = 2000
    t = np.full(n, 1.3 * gt.tmin)
    rmax_t = gt.rmax * 1.3
    pos = rng.uniform(-rmax_t, rmax_t, size=(n, 3)) * 0.999
    dirv = rng.normal(size=(n, 3))
    dirv /= np.linalg.norm(dirv, axis=1, keepdims=True)
    cj = np.asarray(jg.get_cellindex_from_pos(gj, jnp.asarray(pos), jnp.asarray(t)))
    ct = tg.get_cellindex_from_pos(gt, torch.as_tensor(pos), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(ct, cj)
    dj, sj = jg.boundary_distance(gj, jnp.asarray(dirv), jnp.asarray(pos), jnp.asarray(t),
                                  jnp.asarray(cj))
    dt, st = tg.boundary_distance(gt, torch.as_tensor(dirv), torch.as_tensor(pos),
                                  torch.as_tensor(t), torch.as_tensor(ct))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=DIST_RTOL, atol=0)
    # the scene exercises crossings, escapes and the step cap
    s = st.numpy()
    assert (s >= 0).any() and (s == -99).any()


def jax_scene(tmp_path_factory, name, make_kw, opts_kw, atom=None):
    """A JAX Simulation after timestep 0's grid update (the capture scenes of
    tests/test_pallas_rpkt.py); ``atom``, where given, the keywords of a
    synthetic atom written over the run's own (write_synthetic_atomicdata)."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    from artis_tpu.synthdata import write_synthetic_atomicdata

    d = str(tmp_path_factory.mktemp(name))
    make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0,
             **make_kw)
    if atom is not None:
        write_synthetic_atomicdata(d, **atom)
    opts = jo.kilonova_lte(**dict(OPT_KW, **opts_kw))
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    return dict(sim=sim, opts=opts, ctx=ctx, est=sim._zero_est())


def forced_state(sc, seed=0, nu_logrange=(14.2, 15.4)):
    """In-flight r-packets spread over a 2D or 3D grid
    (tests/test_pallas_rpkt.py::_force_rpkt_state_3d)."""
    from artis_tpu.grid import get_cellindex_from_pos

    rng = np.random.default_rng(seed)
    grid = sc["sim"].grid
    st = sc["sim"].state
    n = st.npkts
    t0 = float(sc["ctx"].ts)
    rmax_t = float(grid.rmax) * t0 / float(grid.tmin)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * (rmax_t * rng.uniform(0.1, 0.75, n) ** (1 / 3))[:, None]
    cell = np.asarray(get_cellindex_from_pos(grid, jnp.asarray(pos), jnp.full(n, t0)))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(*nu_logrange, n)
    f64 = np.float64
    return st.replace(
        ptype=jnp.full(n, TYPE_RPKT, jnp.int32), pos=jnp.asarray(pos, f64),
        dir=jnp.asarray(d, f64), where=jnp.asarray(cell, jnp.int32),
        prop_time=jnp.full(n, t0, f64), nu_rf=jnp.asarray(nu, f64),
        nu_cmf=jnp.asarray(nu * 0.98, f64), e_rf=jnp.ones(n, f64),
        e_cmf=jnp.full(n, 0.98, f64), next_trans=jnp.zeros(n, jnp.int32))


def port_inputs(sc, st, dtype=torch.float32):
    """The JAX scene carried into the port (interop.from_numpy): float32 for
    the crossing, as the port's driver demotes them; the grid stays float64."""
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.estimators import Estimators
    from artis_tpu_torch.grid import GridData
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.transport.engine import StepContext

    sim = sc["sim"]
    return dict(
        st=interop.from_numpy(PacketState, np_fields(st), dtype=dtype),
        est=interop.from_numpy(Estimators, np_fields(sc["est"]), dtype=dtype),
        ctx=interop.from_numpy(StepContext, np_fields(sc["ctx"]), dtype=dtype),
        grid=interop.from_numpy(GridData, np_fields(sim.grid), dtype=torch.float64),
        dad=interop.from_numpy(DeviceAtomicData, np_fields(sim.dad), dtype=dtype),
        cells=interop.from_numpy(CellState, np_fields(sim.cells), dtype=dtype),
        opts=port_opts(sc["opts"], transport_dtype="float32"))


def run_port(sc, st, tau, sel, max_inner):
    from artis_tpu_torch.transport import engine as teng

    p = port_inputs(sc, st)
    draws = (torch.as_tensor(tau, dtype=torch.float32), torch.as_tensor(sel, dtype=torch.float32))
    return teng.rpkt_step((7,), p["st"], p["est"], p["ctx"], p["grid"], p["dad"], p["cells"],
                          p["opts"].replace(rpkt_crossings_per_dispatch=max_inner), 4,
                          test_draws=draws)


def run_pallas(sc, st, tau, sel, max_inner):
    opts = sc["opts"].replace(rpkt_crossings_per_dispatch=max_inner, use_pallas_rpkt=True)
    jeng._PALLAS_TEST_INJECT = (jnp.asarray(tau), jnp.asarray(sel))
    try:
        return jeng.rpkt_step_pallas(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"],
                                     sc["sim"].grid, sc["sim"].dad, sc["sim"].cells, opts, 4)
    finally:
        jeng._PALLAS_TEST_INJECT = None


def run_xla(sc, st, tau_u, max_inner):
    opts = sc["opts"].replace(rpkt_crossings_per_dispatch=max_inner)
    orig = jeng._uniform

    def patched(key, tag, n, dtype):
        if tag == 51:
            return jnp.asarray(tau_u, dtype)
        return orig(key, tag, n, dtype)

    jeng._uniform = patched
    try:
        return jeng.rpkt_step(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"], sc["sim"].grid,
                              sc["sim"].dad, sc["sim"].cells, opts, 4)
    finally:
        jeng._uniform = orig


def assert_lane_parity(out_j, out_t, max_inner):
    """tests/test_pallas_rpkt.py's 2D/3D tolerances."""
    thresh = 0.95 if max_inner <= 1 else 0.9
    st_j, est_j, st_t, est_t = out_j[0], out_j[1], out_t[0], out_t[1]
    wj, wt = np.asarray(st_j.where), st_t.where.numpy()
    pj, pt = np.asarray(st_j.ptype), st_t.ptype.numpy()
    assert np.mean(wj == wt) > thresh, np.mean(wj == wt)
    assert np.mean(pj == pt) > thresh, np.mean(pj == pt)
    both = (wj == wt) & (pj == pt)
    for name in ("prop_time", "nu_cmf", "e_cmf"):
        a = np.asarray(getattr(st_j, name))[both]
        b = getattr(st_t, name).numpy()[both].astype(np.float64)
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-30)
        assert np.mean(rel < 3e-3) > thresh, (name, np.mean(rel < 3e-3))
    a = np.asarray(est_j.j).sum()
    b = float(est_t.j.sum())
    assert a > 0
    assert b == pytest.approx(a, rel=5e-2 if max_inner <= 1 else 2e-1)


def check_rpkt_parity(sc, seed, max_inner):
    st0 = forced_state(sc, seed=seed)
    rng = np.random.default_rng(seed)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    out_t = run_port(sc, st0, tau, sel, max_inner)
    assert_lane_parity(run_xla(sc, st0, tau_u, max_inner), out_t, max_inner)
    assert_lane_parity(run_pallas(sc, st0, tau, sel, max_inner), out_t, max_inner)


def check_gamma_parity(sc, seed):
    """gamma_step of both packages from the same gamma packets, with the
    same uniforms injected per tag on both sides (float64)."""
    from artis_tpu_torch.transport import engine as teng

    rng = np.random.default_rng(seed)
    st0 = forced_state(sc, seed=seed)
    n = NPKTS
    nu = 10 ** rng.uniform(19.5, 20.7, n)  # 0.13-2 MeV: Compton, photoelectric, pairs
    st0 = st0.replace(ptype=jnp.full(n, TYPE_GAMMA, jnp.int32), nu_cmf=jnp.asarray(nu),
                      nu_rf=jnp.asarray(nu * 1.01), e_rf=jnp.ones(n))
    uni = {tag: rng.uniform(1e-6, 1.0, n) for tag in range(41, 49)}
    iso = {tag: rng.normal(size=(n, 3)) for tag in range(41, 49)}
    iso = {k: v / np.linalg.norm(v, axis=1, keepdims=True) for k, v in iso.items()}
    uj, ij = jeng._uniform, jeng._isotropic
    uo, io = teng._uniform, teng._isotropic
    jeng._uniform = lambda key, tag, n_, dtype: jnp.asarray(uni[tag], dtype)
    jeng._isotropic = lambda key, tag, n_, dtype: jnp.asarray(iso[tag], dtype)
    teng._uniform = lambda key, tag, n_, like: torch.as_tensor(uni[tag], dtype=like.dtype)
    teng._isotropic = lambda key, tag, n_, like: torch.as_tensor(iso[tag], dtype=like.dtype)
    try:
        sim, ctx = sc["sim"], sc["ctx"]
        cells = sim.cells
        st_j, est_j = jeng.gamma_step(jax.random.PRNGKey(3), st0, sc["est"], ctx, sim.grid,
                                      cells.rho, cells.nnetot, cells.ffegrp, -1.0, sc["opts"])
        p = port_inputs(sc, st0, dtype=torch.float64)
        c = p["cells"]
        st_t, est_t = teng.gamma_step((3,), p["st"], p["est"], p["ctx"], p["grid"], c.rho,
                                      c.nnetot, c.ffegrp, -1.0,
                                      p["opts"].replace(transport_dtype="float64"))
    finally:
        jeng._uniform, jeng._isotropic = uj, ij
        teng._uniform, teng._isotropic = uo, io
    for name in ("where", "ptype", "absorptiontype"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)), err_msg=name)
    for name in ("pos", "dir", "prop_time", "nu_cmf", "nu_rf", "e_cmf", "e_rf"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
                                   rtol=DIST_RTOL, atol=0, err_msg=name)
    np.testing.assert_allclose(est_t.dep_gamma.numpy(), np.asarray(est_j.dep_gamma),
                               rtol=DIST_RTOL, atol=0)
    # the draws reached crossings, escapes and interactions
    where0 = np.asarray(st0.where)
    assert (np.asarray(st_j.where) != where0).any()
    assert (np.asarray(st_j.ptype) != TYPE_GAMMA).any()


def rel_close(a, b, n, name):
    """|b - a| <= 4/sqrt(n) |a| (tests/test_torch_slice.py)."""
    assert n > 0, name
    tol = 4.0 / np.sqrt(n)
    assert abs(b - a) <= tol * abs(a), f"{name}: {a} vs {b} (tol {tol}, n={n})"


def timestep_pair(tmp_path_factory, name, make_kw, opts_kw):
    """One timestep of both packages from the same pellets (the port in
    float32 on the CPU, the JAX package in float64)."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    mk = dict(ncells=5, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, ngreyts=0)
    mk.update(make_kw)
    dj = str(tmp_path_factory.mktemp(f"{name}_jax"))
    dt = str(tmp_path_factory.mktemp(f"{name}_torch"))
    for d in (dj, dt):
        make_run(d, **mk)
    kw = dict(npkts=2000, mintemp=1000.0, maxtemp=20000.0, tablesize=12, linewalk_chunk=64,
              rpkt_crossings_per_dispatch=16, **opts_kw)
    jopts = jo.kilonova_lte(**kw)
    sj = jd.Simulation(dj, jopts, datadir="/nonexistent")
    st = td.Simulation(dt, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    sj.do_timestep(0)
    st.do_timestep(0)
    return sj, st


def check_timestep(sj, st):
    from artis_tpu.packets import TYPE_ESCAPE

    n_esc = int(sj._escaped_counted.sum())
    rel_close(sj.cmf_lum_ts[0], st.cmf_lum_ts[0], n_esc, "cmf_lum")
    rel_close(float(sj.lc_lum.sum()), float(st.lc_lum.sum()), n_esc, "lc_lum")
    n_part = float(sj.est.positron_emission + sj.est.electron_emission)
    dep = lambda s: s.dep_ts["positron"][0] + s.dep_ts["electron"][0]
    rel_close(dep(sj), dep(st), n_part, "particle deposition")
    ptype = np.asarray(sj.state.ptype)
    n_r = int(np.sum((ptype == TYPE_RPKT) | ((ptype == TYPE_ESCAPE)
                                              & (np.asarray(sj.state.escape_type) == TYPE_RPKT))))
    a, b = np.asarray(sj.est.j), st.est.j.numpy()
    rel_close(float(a.sum()), float(b.sum()), n_r, "J")
    # per cell, on the cells that hold most of the path length
    for c in np.argsort(a)[::-1][: max(1, a.size // 2)]:
        rel_close(float(a[c]), float(b[c]), n_r * a[c] / a.sum(), f"J[{c}]")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

GRID3D_CASES = {
    "1dmodel_8cube": dict(ncells=5, model_dim=1),
    "2dmodel_8cube": dict(ncells=3, model_dim=2),
    "3dmodel_6cube": dict(ncells=6, model_dim=3),
}


@pytest.mark.parametrize("case", list(GRID3D_CASES))
def test_grid_init_matches(tmp_path, case):
    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, **GRID3D_CASES[case])
    gj, hj, gt, ht = both_grids(d, "CARTESIAN3D")
    assert_grids_equal(gj, gt)
    for k in ("cell_pos_min", "mgi_of_cell", "nonemptymgi_of_cell", "cell_of_nonemptymgi",
              "numpropcells_mgi", "initial_radial_pos_sum_mgi"):
        np.testing.assert_allclose(getattr(ht, k), getattr(hj, k), rtol=GRID_RTOL, err_msg=k)
    assert gt.ncoordgrid == ((6, 6, 6) if case.startswith("3d") else (8, 8, 8))


@pytest.mark.parametrize("case", list(GRID3D_CASES))
def test_boundary_distance_and_cellindex_match(tmp_path, case):
    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, **GRID3D_CASES[case])
    gj, _, gt, _ = both_grids(d, "CARTESIAN3D")
    assert_geometry_matches(gj, gt, seed=len(case))


def test_noncubic_grid_raises(tmp_path):
    import artis_tpu_torch.grid as tg
    import artis_tpu_torch.io.model as tm
    from artis_tpu_torch.options import GridType

    d = str(tmp_path)
    make_run(d, ncells=5, ntimesteps=3, tmin_days=1.5, tmax_days=3.0)
    with pytest.raises(ValueError, match="cubic"):
        tg.grid_init(tm.read_model(f"{d}/model.txt", 1.5 * 86400), 1.5 * 86400,
                     GridType.CARTESIAN3D, (8, 8, 6))


@pytest.fixture(scope="module")
def scene_1d3d(tmp_path_factory):
    """1D model on a 16^3 grid (tests/test_pallas_rpkt.py::scene_3d)."""
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "t3d_1d", dict(ncells=8),
                     dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=16,
                          ncoordgrid_y=16, ncoordgrid_z=16))


@pytest.fixture(scope="module")
def scene_3d3d(tmp_path_factory):
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "t3d_3d", dict(ncells=6, model_dim=3),
                     dict(grid_type=jo.GridType.CARTESIAN3D))


@pytest.mark.parametrize("max_inner", [1, 4])
def test_rpkt_1dmodel_3dgrid_matches_jax(scene_1d3d, max_inner):
    check_rpkt_parity(scene_1d3d, seed=11, max_inner=max_inner)


@pytest.mark.parametrize("max_inner", [1, 4])
def test_rpkt_3dmodel_matches_jax(scene_3d3d, max_inner):
    check_rpkt_parity(scene_3d3d, seed=43, max_inner=max_inner)


def test_gamma_step_3dgrid_matches_jax(scene_3d3d):
    check_gamma_parity(scene_3d3d, seed=5)


def test_kilonova_1d_3dgrid_timestep_matches_jax(tmp_path_factory):
    import artis_tpu.options as jo

    sj, st = timestep_pair(tmp_path_factory, "kn_1d_3d", dict(model_dim=1),
                           dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=8,
                                ncoordgrid_y=8, ncoordgrid_z=8))
    check_timestep(sj, st)


def test_check_supported_takes_the_new_slice():
    import artis_tpu_torch.options as to
    from artis_tpu_torch.transport.engine import check_supported

    base = to.kilonova_lte()
    for gt in to.GridType:
        check_supported(base.replace(grid_type=gt, detailed_bf_estimators_on=True,
                                     expansionopacities_on=True), 4)
        # the classic preset: dipole / polarised scattering, rate-balance
        # ionisation
        check_supported(base.replace(grid_type=gt, dipole=True, pol_on=True,
                                     force_saha_ion_balance=False), 4)
        check_supported(to.classic(grid_type=gt), 4)
        # NLTE populations, the multibin field, the J_b_lu estimators and
        # LUT-off rates: nltenebular, without and with the non-thermal
        # solver (Spencer-Fano, or the work-function approximation)
        check_supported(to.nltenebular(grid_type=gt, nt_on=False,
                                       nt_solve_spencerfano=False), 4)
        check_supported(to.nltenebular(grid_type=gt), 4)
        check_supported(to.nltenebular(grid_type=gt, nt_solve_spencerfano=False), 4)
        check_supported(base.replace(grid_type=gt, nt_on=True, nt_solve_spencerfano=True), 4)
        # virtual packets and XCOM gamma photoionisation
        check_supported(to.classic(grid_type=gt, vpkt_on=True), 4)
        check_supported(base.replace(grid_type=gt, vpkt_on=True, use_xcom_gammaphotoion=True), 4)
    with pytest.raises(NotImplementedError, match="grid_type"):
        check_supported(base.replace(grid_type="SPHERICAL3D"), 4)
    # the run diagnostics and the grey opacity cases 0-3 run too
    for name in ("record_linestat", "track_ion_stats", "log_macroatom"):
        check_supported(base.replace(**{name: True}), 4)
    for case in range(7):
        check_supported(base, case)

"""The analytic thermalisation schemes of the port against the JAX package,
on the CPU, in float64 with the same inputs and draws on both sides.

- transport/thermalisation.py: the Barnes time scales and efficiency, the
  column density along rays (with and without the t^3 scaling), the
  Wollaeger efficiency and the Guttman efficiency with the JAX package's
  own 16 isotropic directions injected, on the 1D, cylindrical and 3D
  grids: rtol 1e-9;
- the particle steps INSTANT, BARNES and WOLLAEGER and the gamma steps
  BARNES, WOLLAEGER and GUTTMAN of the engine, with the uniforms of each tag
  (and the Guttman directions) injected on both sides: packet types and
  absorption types equal lane for lane, times and estimators to rtol 1e-9.
  The Barnes time scales and the Wollaeger densities are set so that the
  efficiencies lie near 1/2 and both outcomes, deposit and escape, occur
  (the synthetic scenes alone would deposit every packet).
"""

import dataclasses

import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.packets import TYPE_ESCAPE, TYPE_GAMMA
from test_torch_grid3d import NPKTS, forced_state, jax_scene, port_inputs

torch.set_num_threads(1)

RTOL = 1e-9
GRIDS = ("sph1d", "cyl2d", "cart3d")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    import artis_tpu.options as jo

    return {
        "sph1d": jax_scene(tmp_path_factory, "th_sph", dict(ncells=6),
                           dict(grid_type=jo.GridType.SPHERICAL1D)),
        "cyl2d": jax_scene(tmp_path_factory, "th_cyl", dict(ncells=4, model_dim=2),
                           dict(grid_type=jo.GridType.CYLINDRICAL2D)),
        "cart3d": jax_scene(tmp_path_factory, "th_cart", dict(ncells=5, model_dim=3),
                            dict(grid_type=jo.GridType.CARTESIAN3D)),
    }


def _close(t, j, name, rtol=RTOL):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t, np.asarray(j), rtol=rtol,
                               atol=0, err_msg=name)


def test_barnes_scales_match():
    from artis_tpu.transport import thermalisation as jt
    from artis_tpu_torch.transport import thermalisation as tt

    for m, e in ((1e31, 1e49), (3.2e31, 7.7e50)):
        assert tt.barnes_t_ineff(m, e) == pytest.approx(jt.barnes_t_ineff(m, e), rel=1e-14)
        for alpha in (False, True):
            assert tt.barnes_tau_ineff_particle(m, e, alpha) == pytest.approx(
                jt.barnes_tau_ineff_particle(m, e, alpha), rel=1e-14)
    t = np.linspace(1e4, 1e7, 50)
    _close(tt.barnes_f_gamma(torch.as_tensor(t), 3e5), jt.barnes_f_gamma(t, 3e5), "f_gamma")


def _rays(sc, seed):
    """Gamma packets spread over the grid: (port state, JAX state)."""
    rng = np.random.default_rng(seed)
    st0 = forced_state(sc, seed=seed)
    nu = 10 ** rng.uniform(19.5, 20.7, NPKTS)
    import jax.numpy as jnp

    st0 = st0.replace(ptype=jnp.full(NPKTS, TYPE_GAMMA, jnp.int32), nu_cmf=jnp.asarray(nu),
                      nu_rf=jnp.asarray(nu * 1.01))
    return port_inputs(sc, st0, dtype=torch.float64), st0


@pytest.mark.parametrize("grid", GRIDS)
def test_column_densities_match(scenes, grid):
    import jax
    import jax.numpy as jnp

    from artis_tpu import geometry as jgeo
    from artis_tpu.transport import thermalisation as jt
    from artis_tpu_torch.transport import thermalisation as tt

    sc = scenes[grid]
    p, st0 = _rays(sc, seed=len(grid))
    gj, ctx = sc["sim"].grid, sc["ctx"]
    rng = np.random.default_rng(1)
    d = rng.normal(size=(NPKTS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rho = np.array(ctx.rho_tmin_mgi)
    for scaling in (False, True):
        cj = jt.column_density_ray(gj, st0.pos, jnp.asarray(d), st0.prop_time, st0.where,
                                   jnp.asarray(rho), scaling)
        ct = tt.column_density_ray(p["grid"], p["st"].pos, torch.as_tensor(d),
                                   p["st"].prop_time, p["st"].where, torch.as_tensor(rho),
                                   scaling)
        assert float(np.asarray(cj).min()) > 0
        _close(ct, cj, f"column density (time scaling {scaling})")
    fw_j = jt.wollaeger_f_gamma(gj, st0.pos, st0.prop_time, st0.where, ctx.rho_t_mgi)
    fw_t = tt.wollaeger_f_gamma(p["grid"], p["st"].pos, p["st"].prop_time, p["st"].where,
                                p["ctx"].rho_t_mgi)
    _close(fw_t, fw_j, "wollaeger")
    key = jax.random.PRNGKey(4)
    fg_j = jt.guttman_f_gamma(key, gj, st0.pos, st0.prop_time, st0.where, ctx.rho_tmin_mgi,
                              float(ctx.tmin))
    dirs = np.stack([np.asarray(jgeo.rand_isotropic_unitvec(jax.random.fold_in(key, i),
                                                            (NPKTS,), jnp.float64))
                     for i in range(tt.GUTTMAN_NDIRS)])
    fg_t = tt.guttman_f_gamma(torch.as_tensor(dirs), p["grid"], p["st"].pos,
                              p["st"].prop_time, p["st"].where, p["ctx"].rho_tmin_mgi,
                              float(ctx.tmin))
    _close(fg_t, fg_j, "guttman")
    assert 0.0 < float(fg_t.mean()) < 1.0 and 0.0 < float(fw_t.mean()) < 1.0


def _inject(uni, iso=None):
    """Patch both packages' per-tag draws; returns a restore function."""
    import jax.numpy as jnp

    from artis_tpu_torch.transport import engine as teng

    saved = (jeng._uniform, teng._uniform, teng._isotropic)
    jeng._uniform = lambda key, tag, n, dtype: jnp.asarray(uni[tag], dtype)
    teng._uniform = lambda key, tag, n, like: torch.as_tensor(uni[tag], dtype=like.dtype)
    if iso is not None:
        teng._isotropic = lambda key, tag, n, like: torch.as_tensor(iso[tag], dtype=like.dtype)

    def restore():
        jeng._uniform, teng._uniform, teng._isotropic = saved

    return restore


@pytest.mark.parametrize("scheme", ["INSTANT", "BARNES", "WOLLAEGER"])
def test_particle_step_matches(scenes, scheme):
    import jax
    import jax.numpy as jnp

    import artis_tpu.options as jo
    from artis_tpu.packets import (TYPE_NONTHERMAL_PREDEPOSIT_ALPHA,
                                   TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS,
                                   TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS)
    from artis_tpu_torch.transport import engine as teng

    sc = scenes["cyl2d"]
    rng = np.random.default_rng(7)
    st0 = forced_state(sc, seed=7)
    kinds = np.array([TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS, TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS,
                      TYPE_NONTHERMAL_PREDEPOSIT_ALPHA])
    st0 = st0.replace(ptype=jnp.asarray(kinds[rng.integers(0, 3, NPKTS)], jnp.int32),
                      nu_cmf=jnp.asarray(10 ** rng.uniform(19.0, 20.0, NPKTS)),
                      originated_from_particlenotgamma=jnp.asarray(rng.uniform(size=NPKTS) < 0.8))
    uni = {tag: rng.uniform(1e-6, 1.0, NPKTS) for tag in (21, 22)}
    jopts = sc["opts"].replace(
        particle_thermalisation_scheme=jo.ThermalisationScheme[scheme])
    # efficiencies near 1/2: tau_ineff ~ t (Barnes), rho ~ 2 a / t (Wollaeger)
    t0 = float(sc["ctx"].ts)
    sc = dict(sc, ctx=dataclasses.replace(sc["ctx"], barnes_tau_ineff_lepton=jnp.asarray(1.2 * t0),
                                          barnes_tau_ineff_alpha=jnp.asarray(1.6 * t0)))
    rho = 2.5e-11 / t0 * rng.uniform(0.3, 3.0, sc["sim"].cells.rho.shape[0])
    p = port_inputs(sc, st0, dtype=torch.float64)
    sim = sc["sim"]
    restore = _inject(uni)
    try:
        st_j, est_j = jeng.nonthermal_predeposit_step(jax.random.PRNGKey(2), st0, sc["est"],
                                                      sc["ctx"], sim.grid, jnp.asarray(rho), jopts)
        st_t, est_t = teng.nonthermal_predeposit_step(
            (2,), p["st"], p["est"], p["ctx"], p["grid"], torch.as_tensor(rho),
            p["opts"].replace(particle_thermalisation_scheme=type(
                p["opts"].particle_thermalisation_scheme)[scheme]))
    finally:
        restore()
    np.testing.assert_array_equal(st_t.ptype.numpy(), np.asarray(st_j.ptype))
    for name in ("pos", "prop_time", "nu_cmf"):
        _close(getattr(st_t, name), getattr(st_j, name), name)
    for name in ("dep_electron", "dep_positron", "dep_alpha", "electron_dep_discrete",
                 "positron_dep_discrete", "alpha_dep_discrete"):
        _close(getattr(est_t, name), getattr(est_j, name), name)
    # the outcomes occurred: deposited and, for the analytic schemes, escaped
    assert float(est_t.dep_electron.sum()) > 0
    assert (st_t.ptype.numpy() == TYPE_ESCAPE).any() == (scheme != "INSTANT")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scheme", ["BARNES", "WOLLAEGER", "GUTTMAN"])
def test_gamma_step_matches(scenes, scheme, grid):
    import jax
    import jax.numpy as jnp

    import artis_tpu.options as jo
    from artis_tpu import geometry as jgeo
    from artis_tpu_torch.transport import engine as teng

    sc = scenes[grid]
    # Barnes efficiency near 1/2: t_ineff ~ t
    sc = dict(sc, ctx=dataclasses.replace(sc["ctx"],
                                          barnes_t_ineff=jnp.asarray(float(sc["ctx"].ts))))
    p, st0 = _rays(sc, seed=3)
    rng = np.random.default_rng(9)
    uni = {62: rng.uniform(1e-6, 1.0, NPKTS)}
    key = jax.random.PRNGKey(6)
    kd = jax.random.fold_in(key, 61)
    iso = {i: np.array(jgeo.rand_isotropic_unitvec(jax.random.fold_in(kd, i), (NPKTS,),
                                                     jnp.float64)) for i in range(16)}
    jopts = sc["opts"].replace(gamma_thermalisation_scheme=jo.ThermalisationScheme[scheme])
    topts = p["opts"].replace(gamma_thermalisation_scheme=type(
        p["opts"].gamma_thermalisation_scheme)[scheme], transport_dtype="float64")
    sim = sc["sim"]
    c = p["cells"]
    restore = _inject(uni, iso)
    try:
        st_j, est_j = jeng.gamma_step(key, st0, sc["est"], sc["ctx"], sim.grid, sim.cells.rho,
                                      sim.cells.nnetot, sim.cells.ffegrp, -1.0, jopts)
        st_t, est_t = teng.gamma_step((6,), p["st"], p["est"], p["ctx"], p["grid"], c.rho,
                                      c.nnetot, c.ffegrp, -1.0, topts)
    finally:
        restore()
    for name in ("ptype", "absorptiontype", "escape_type"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)), err_msg=name)
    _close(st_t.escape_time, st_j.escape_time, "escape_time")
    _close(est_t.dep_gamma, est_j.dep_gamma, "dep_gamma")
    assert float(est_t.nesc) == float(est_j.nesc)
    # both outcomes occurred
    assert float(est_t.nesc) > 0 and float(est_t.dep_gamma.sum()) > 0


def test_column_density_stops_outside_the_grid(scenes, monkeypatch):
    """In float32 (the port's transport dtype) a ray within the boundary
    guard (2e-6 of the radius) short of its shell's outer boundary, moving
    outward, sees no crossing and steps past the shell keeping its cell.
    Without an extent check (the JAX package's loop, here with the port's
    check turned off) it then runs to the crossing cap, 200 here; the port
    stops it once it is outside the grid."""
    from artis_tpu_torch.transport import thermalisation as tt

    p = port_inputs(scenes["sph1d"], forced_state(scenes["sph1d"], seed=1))
    grid = p["grid"]
    cell = 2
    f32 = torch.float32
    t = torch.full((1,), grid.tmin, dtype=f32)
    pos = torch.tensor([[0.0, 0.0, float(grid.cell_pos_max[cell, 0]) * (1 - 1e-7)]], dtype=f32)
    up = torch.tensor([[0.0, 0.0, 1.0]], dtype=f32)
    calls = []
    bd = tt.boundary_distance
    monkeypatch.setattr(tt, "boundary_distance", lambda *a: calls.append(1) or bd(*a))
    rho = p["ctx"].rho_tmin_mgi
    col = tt.column_density_ray(grid, pos, up, t, torch.tensor([cell]), rho, True,
                                max_crossings=200)
    assert len(calls) < 40 and bool(torch.isfinite(col).all()) and float(col[0]) > 0
    calls.clear()
    monkeypatch.setattr(tt, "_outside",
                        lambda grid, pos, t: torch.zeros(pos.shape[0], dtype=torch.bool))
    tt.column_density_ray(grid, pos, up, t, torch.tensor([cell]), rho, True, max_crossings=200)
    assert len(calls) == 200

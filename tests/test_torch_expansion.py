"""Binned expansion opacities in the port against the JAX package, on the CPU.

(a) The functions of transport/expansionopacity.py against
    artis_tpu.transport.expansionopacity in float64 on numpy-made inputs,
    rtol 1e-9: the opacity and Planck tables, the line-selection cumulative
    and bin offsets, the vectorised bin walk, and the samplers fed the
    JAX package's own uniforms (the line index exactly). Also the segment
    test of tests/test_expansion_bb.py, and why the Simulation keeps the line
    cumulative in float64.
(b) rpkt_step of the port in expansion mode (the plain version of the
    crossing kernel's bin walk) against the XLA path (injected tag-51
    optical depths and tag-59 bound-bound split) and the Pallas kernel in
    interpret mode (_PALLAS_TEST_INJECT), on the 1D grid here and on the
    cylindrical and 3D grids in tests/test_torch_expansion_grids.py, at
    max_inner 1 and 4, with the tolerances of
    tests/test_pallas_rpkt.py::test_kernel_expansion_mode_matches_xla: cell
    and packet type agree on > 0.97 of lanes (> 0.9 at max_inner 4),
    prop_time / nu_cmf / e_cmf within rel 1e-2 on that share of the agreeing
    lanes, J and nuJ totals to 2e-2 (1e-1 at max_inner 4); bound-bound
    events occur. The port runs float32 against float64 (XLA) and the
    bin-edge comparisons amplify the rounding.
(c) One whole timestep of both packages in each thermalisation-probability
    mode: tests/test_torch_expansion_timestep.py (-1) and
    tests/test_torch_expansion_thermalised.py (0.9).
(d) compare_outputs rejects a bin walk that reads its neighbour bin, and
    accepts the kernel's early exit past the abort distance (the outcome
    does not change when every event beyond it is dropped).
"""

import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.constants import CLIGHT
from artis_tpu.synthdata import make_run
from test_torch_grid3d import NPKTS, OPT_KW, forced_state, port_inputs, run_pallas

torch.set_num_threads(1)

RTOL = 1e-9


def _jexpo():
    from artis_tpu.transport import expansionopacity as je

    return je


def _texpo():
    from artis_tpu_torch.transport import expansionopacity as te

    return te


class _Dad:
    def __init__(self, line_nu):
        import jax.numpy as jnp

        self.line_nu = jnp.asarray(line_nu)


def _lines(rng, nlines):
    """nu-descending lines over 300-40000 A (some outside the bin range),
    some sharing bins."""
    lam = np.sort(np.concatenate([rng.uniform(300.0, 40000.0, nlines - 8),
                                  np.full(4, 600.0) + rng.uniform(0, 1, 4),
                                  [530.0, 534.5, 34969.0, 36000.0]]))
    return 1e8 * CLIGHT / lam


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    nlines, ncells = 400, 3
    line_nu = _lines(rng, nlines)
    tau = rng.uniform(0.0, 3.0, (ncells, nlines)) * (rng.uniform(size=(ncells, nlines)) < 0.7)
    tau_factor = tau / 2.0e5  # tau_sob_factor = tau / t
    return dict(line_nu=line_nu, tau_factor=tau_factor, t_mid=2.0e5,
                rho=rng.uniform(1e-14, 1e-12, ncells), t_r=rng.uniform(3000.0, 9000.0, ncells))


def test_build_tables_match(tables):
    import jax.numpy as jnp

    je, te = _jexpo(), _texpo()
    tb = tables
    kj, pj = je.build_expansion_opacities(jnp.asarray(tb["tau_factor"]), _Dad(tb["line_nu"]),
                                          jnp.asarray(tb["rho"]), jnp.asarray(tb["t_r"]),
                                          tb["t_mid"])
    kt, pt = te.build_expansion_opacities(torch.as_tensor(tb["tau_factor"]),
                                          torch.as_tensor(tb["line_nu"]),
                                          torch.as_tensor(tb["rho"]), torch.as_tensor(tb["t_r"]),
                                          tb["t_mid"])
    assert kt.shape == (3, te.NBINS) and te.NBINS == je.NBINS == 970
    assert float(kt.sum()) > 0
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=RTOL, atol=0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL, atol=0)
    wj, oj = je.build_line_selection(jnp.asarray(tb["tau_factor"]), _Dad(tb["line_nu"]),
                                     tb["t_mid"])
    wt, ot = te.build_line_selection(torch.as_tensor(tb["tau_factor"]),
                                     torch.as_tensor(tb["line_nu"]), tb["t_mid"])
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("relativistic", [False, True])
def test_bin_walk_matches(relativistic):
    import jax.numpy as jnp

    je, te = _jexpo(), _texpo()
    rng = np.random.default_rng(5 + relativistic)
    n = 600
    # frequencies from bluer than LAMBDA_MIN to redder than LAMBDA_MAX
    nu = 1e8 * CLIGHT / rng.uniform(400.0, 36000.0, n)
    t0 = np.full(n, 2.0e5)
    krd = rng.uniform(0.0, 3e-14, (n, te.NBINS)) * (rng.uniform(size=(n, te.NBINS)) < 0.5)
    chi_cont = rng.uniform(1e-17, 1e-15, n)
    tau = -np.log(rng.uniform(0.05, 0.95, n))
    dnudl = -nu * rng.uniform(1e-16, 1e-15, n)
    active = rng.uniform(size=n) < 0.9
    args = (krd, nu, t0, chi_cont, tau, np.full(n, 1e15), nu * 0.9, dnudl, active)
    ej, bj = je.get_event_expansion_batch(*(jnp.asarray(a) for a in args), relativistic)
    et, bt = te.get_event_expansion_batch(*(torch.as_tensor(a) for a in args), relativistic)
    ej, bj = np.asarray(ej), np.asarray(bj)
    assert np.isfinite(ej).sum() > n // 2 and (bj > 0).sum() > n // 4
    np.testing.assert_array_equal(np.isfinite(et.numpy()), np.isfinite(ej))
    fin = np.isfinite(ej)
    np.testing.assert_allclose(et.numpy()[fin], ej[fin], rtol=RTOL, atol=0)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=RTOL, atol=0)
    # redder than the last bin: no path length in any bin, no event
    red = nu < te.bin_nu_lower(te.NBINS - 1)
    assert red.any() and np.all(~np.isfinite(ej[red]))


def test_samplers_match(tables):
    import jax
    import jax.numpy as jnp

    je, te = _jexpo(), _texpo()
    tb = tables
    wj, oj = je.build_line_selection(jnp.asarray(tb["tau_factor"]), _Dad(tb["line_nu"]),
                                     tb["t_mid"])
    rng = np.random.default_rng(3)
    n = 512
    cell = rng.integers(0, 3, n)
    lam_ev = np.where(rng.uniform(size=n) < 0.3, 600.5, rng.uniform(500.0, 36000.0, n))
    nu_ev = 1e8 * CLIGHT / lam_ev
    mask = rng.uniform(size=n) < 0.8
    key = jax.random.PRNGKey(21)
    lj, okj = je.sample_bb_line(key, wj, oj, jnp.asarray(cell), jnp.asarray(nu_ev),
                                jnp.asarray(mask), chunk=64)
    u = np.asarray(jax.random.uniform(key, (n,), jnp.float64))
    lt, okt = te.sample_bb_line(torch.as_tensor(u.copy()), torch.as_tensor(np.array(wj)),
                                torch.as_tensor(np.array(oj)), torch.as_tensor(cell),
                                torch.as_tensor(nu_ev), torch.as_tensor(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() > n // 4
    np.testing.assert_array_equal(lt.numpy()[ok], np.asarray(lj)[ok])

    _, pj = je.build_expansion_opacities(jnp.asarray(tb["tau_factor"]), _Dad(tb["line_nu"]),
                                         jnp.asarray(tb["rho"]), jnp.asarray(tb["t_r"]),
                                         tb["t_mid"])
    key = jax.random.PRNGKey(8)
    nj = je.sample_planck_times_expansion_opacity(key, pj, jnp.asarray(cell), jnp.asarray(mask))
    u1 = np.array(jax.random.uniform(key, (n,), jnp.float64))
    u2 = np.array(jax.random.uniform(jax.random.fold_in(key, 1), (n,), jnp.float64))
    nt = te.sample_planck_times_expansion_opacity(
        torch.as_tensor(u1), torch.as_tensor(u2), torch.as_tensor(np.array(pj)),
        torch.as_tensor(cell), torch.as_tensor(mask))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=RTOL, atol=0)
    assert (nt.numpy()[mask] > 0).all()


def test_sample_bb_line_segments_and_weights():
    """tests/test_expansion_bb.py::test_sample_bb_line_segments_and_weights
    on the port: three lines share the bin [570, 605.5) A; events there draw
    only from that segment, by weight (1 - e^-tau); a cell without weight
    in the bin reports ok=False."""
    te = _texpo()
    lam = np.array([600.0, 601.0, 604.0, 2000.0, 2010.0, 34000.0])
    nu = np.sort(1e8 * CLIGHT / lam)[::-1].copy()
    tau = torch.tensor([[2.0, 0.0, 1.0, 3.0, 3.0, 0.5], [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]],
                       dtype=torch.float64)
    wcum, binoff = te.build_line_selection(tau, torch.as_tensor(nu), 1.0)
    assert wcum.shape == (2, 6)
    b0 = int((600.0 - te.LAMBDA_MIN) / te.DELTA_LAMBDA)
    assert int(binoff[b0 + 1] - binoff[b0]) == 3
    n = 256
    u = torch.as_tensor(np.random.default_rng(0).uniform(size=n))
    nu_ev = torch.full((n,), 1e8 * CLIGHT / 602.0, dtype=torch.float64)
    line, ok = te.sample_bb_line(u, wcum, binoff, torch.zeros(n, dtype=torch.long), nu_ev,
                                 torch.ones(n, dtype=torch.bool))
    assert bool(ok.all())
    lam_sel = 1e8 * CLIGHT / nu[line.numpy()]
    assert np.all(lam_sel >= te.LAMBDA_MIN + b0 * te.DELTA_LAMBDA)
    assert np.all(lam_sel < te.LAMBDA_MIN + (b0 + 1) * te.DELTA_LAMBDA)
    counts = {v: int(np.sum(np.isclose(lam_sel, v, atol=0.4))) for v in (600.0, 601.0, 604.0)}
    assert counts[601.0] == 0
    assert counts[600.0] > counts[604.0] > 0
    _, ok1 = te.sample_bb_line(u[:8], wcum, binoff, torch.ones(8, dtype=torch.long), nu_ev[:8],
                               torch.ones(8, dtype=torch.bool))
    assert not bool(ok1.any())


def test_line_cumulative_needs_float64():
    """Why the Simulation builds wcum in float64: behind 1e5 lines of weight
    10-500, a bin whose lines weigh 1e-6 in all moves the cumulative by less
    than a float32 ulp of it, so in float32 that bin has no weight and its
    events could never activate a line."""
    te = _texpo()
    nlines = 100_000
    lam = np.linspace(600.0, 30000.0, nlines)  # ascending wavelength
    lam[-3:] = [34000.0, 34001.0, 34002.0]  # a bin of its own at the red end
    nu = 1e8 * CLIGHT / lam  # the nu-descending line list
    tau = np.full((1, nlines), 1.0)
    tau[0, -3:] = 1e-6 / 3.0 / (34000.0 / te.DELTA_LAMBDA)  # the red bin's lines
    b = int((34000.0 - te.LAMBDA_MIN) / te.DELTA_LAMBDA)
    nu_ev = torch.full((4,), 1e8 * CLIGHT / 34001.5, dtype=torch.float64)
    for dtype, expect in ((torch.float64, True), (torch.float32, False)):
        wcum, binoff = te.build_line_selection(torch.as_tensor(tau, dtype=dtype),
                                               torch.as_tensor(nu), 1.0)
        assert int(binoff[b + 1] - binoff[b]) == 3
        _, ok = te.sample_bb_line(torch.full((4,), 0.5, dtype=torch.float64), wcum, binoff,
                                  torch.zeros(4, dtype=torch.long), nu_ev,
                                  torch.ones(4, dtype=torch.bool))
        assert bool(ok.all()) == expect, dtype


# ---------------------------------------------------------------------------
# (b) the crossing in expansion mode against the XLA path and the Pallas kernel
# ---------------------------------------------------------------------------

SCENES = {
    # tests/test_pallas_rpkt.py::scene_expo: dense, so the binned line
    # opacity drives events
    "sph1d": (dict(ncells=8, logrho0=-6.8), dict(grid_type="SPHERICAL1D")),
    "cyl2d": (dict(ncells=4, model_dim=2, logrho0=-7.0), dict(grid_type="CYLINDRICAL2D")),
    "cart3d": (dict(ncells=6, model_dim=3, logrho0=-7.0), dict(grid_type="CARTESIAN3D")),
}


def expo_scene(tmp_path_factory, name):
    """A JAX Simulation of SCENES[name] in expansion mode (thermalisation
    probability -1) after timestep 0's grid update."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    mk, okw = SCENES[name]
    d = str(tmp_path_factory.mktemp(f"expo_{name}"))
    make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, **mk)
    opts = jo.kilonova_lte(**dict(OPT_KW, expansionopacities_on=True,
                                  rpkt_boundbound_thermalisation_probability=-1.0,
                                  grid_type=jo.GridType[okw["grid_type"]]))
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    return dict(sim=sim, opts=opts, ctx=ctx, est=sim._zero_est())


@pytest.fixture(scope="module")
def scene_sph(tmp_path_factory):
    return expo_scene(tmp_path_factory, "sph1d")


def run_xla(sc, st, tau_u, sel, max_inner):
    import jax

    opts = sc["opts"].replace(rpkt_crossings_per_dispatch=max_inner)
    orig = jeng._uniform

    def patched(key, tag, n, dtype):
        import jax.numpy as jnp

        if tag == 51:
            return jnp.asarray(tau_u, dtype)
        if tag == 59:  # the bound-bound split of a bin event
            return jnp.asarray(sel, dtype)
        return orig(key, tag, n, dtype)

    jeng._uniform = patched
    try:
        return jeng.rpkt_step(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"], sc["sim"].grid,
                              sc["sim"].dad, sc["sim"].cells, opts, 4)
    finally:
        jeng._uniform = orig


def _port_inputs(sc, st):
    """port_inputs with the line cumulative kept in float64, as the port's
    Simulation keeps it."""
    import dataclasses

    p = port_inputs(sc, st)
    p["ctx"] = dataclasses.replace(
        p["ctx"], expopac_wcum=torch.as_tensor(np.array(sc["ctx"].expopac_wcum)))
    return p


def run_port(sc, st, tau, sel, max_inner):
    from artis_tpu_torch.transport import engine as teng

    p = _port_inputs(sc, st)
    return teng.rpkt_step((7,), p["st"], p["est"], p["ctx"], p["grid"], p["dad"], p["cells"],
                          p["opts"].replace(rpkt_crossings_per_dispatch=max_inner), 4,
                          test_draws=(torch.as_tensor(tau), torch.as_tensor(sel)))


def assert_parity(out_j, out_t, max_inner):
    from artis_tpu_torch import stats

    thresh = 0.97 if max_inner <= 1 else 0.9
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
        assert np.mean(rel < 1e-2) > thresh, (name, np.mean(rel < 1e-2))
    for name in ("j", "nuj"):
        a = np.asarray(getattr(est_j, name)).sum()
        b = float(getattr(est_t, name).sum())
        assert a > 0 and b == pytest.approx(a, rel=2e-2 if max_inner <= 1 else 1e-1), name
    # bound-bound (bin) events occurred, so the bin walk decided outcomes
    assert int(est_t.counters[stats.MA_STAT_ACTIVATION_BB]) > 5


def check_crossing(sc, max_inner, seed):
    """The port's crossing against the XLA path and the Pallas kernel from
    the same forced r-packets and draws."""
    st0 = forced_state(sc, seed=seed)
    rng = np.random.default_rng(seed + 7)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = rng.uniform(0.0, 1.0, NPKTS).astype(np.float32)
    out_t = run_port(sc, st0, tau, sel, max_inner)
    assert_parity(run_xla(sc, st0, tau_u, sel, max_inner), out_t, max_inner)
    assert_parity(run_pallas(sc, st0, tau, sel, max_inner), out_t, max_inner)


@pytest.mark.parametrize("max_inner", [1, 4])
def test_crossing_1d_matches_jax(scene_sph, max_inner):
    check_crossing(scene_sph, max_inner, seed=max_inner)


# ---------------------------------------------------------------------------
# (d) the kernel check
# ---------------------------------------------------------------------------


def _plain_expansion(sc, max_inner=4, **over):
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport import rpkt_kernel

    p = _port_inputs(sc, forced_state(sc, seed=3, nu_logrange=(14.2, 15.9)))
    ctx, dad = p["ctx"], p["dad"]
    _, lanes = teng.rpkt_lanes(p["st"], ctx.t2)
    n = lanes["posx"].shape[0]
    rng = np.random.default_rng(5)
    tables = rpkt_kernel.kernel_tables(dad, p["grid"], p["cells"], ctx)
    tables.update(over)
    return rpkt_kernel.propagate_reference(
        1, lanes, tables, torch.as_tensor(-np.log(rng.uniform(0.05, 0.95, n)).astype(np.float32)),
        torch.as_tensor(rng.uniform(0.0, 1.0, n).astype(np.float32)), float(ctx.t2),
        float(ctx.tmin), float(p["grid"].max_path_step), nlines=dad.nlines,
        ncells=p["cells"].Te.shape[0], ngc=max(dad.nbfcontinua_ground, 1),
        nphixs=dad.nphixspoints, max_inner=max_inner,
        relativistic=p["opts"].use_relativistic_doppler_shift,
        phixs_dnu=float(dad.nphixsnuincrement),
        last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=True, expansion=True,
        **rpkt_kernel.kernel_geometry(p["grid"])), tables


@pytest.mark.parametrize("shift", [0, 1, -1])
def test_compare_outputs_rejects_a_neighbour_bin(scene_sph, shift):
    """A kernel that read kappa of the bin next to the one it walks (the
    table rolled by one bin) disagrees with the plain version beyond
    compare_outputs' limits; the right bins agree."""
    from artis_tpu_torch.transport import rpkt_kernel

    sc = scene_sph
    good, tables = _plain_expansion(sc)
    assert int(((good["is_bb"] > 0) & (good["evented"] > 0)).sum()) > 5
    bad, _ = _plain_expansion(sc, expo_kappa=torch.roll(tables["expo_kappa"], shift, dims=1)
                              .contiguous())
    ok, rep = rpkt_kernel.compare_outputs(bad, good)
    assert ok == (shift == 0), rep


def test_early_exit_changes_nothing(scene_sph, monkeypatch):
    """The CUDA kernel leaves the bin walk once the walked distance passes
    the abort distance (the boundary or time limit). Dropping every event
    that lies beyond that point from the plain version leaves all its
    outputs as they were."""
    from artis_tpu_torch.transport import expansionopacity as te
    from artis_tpu_torch.transport import rpkt_kernel

    sc = scene_sph
    full, _ = _plain_expansion(sc, max_inner=8)
    orig = rpkt_kernel._expansion_event
    dropped = []

    def truncated(kappa_rho_dop, nu, tstart, safe_chi, tau_next, abort_dist, dnudl, need_chi,
                  u_bb, relativistic):
        ev, first, walked = orig(kappa_rho_dop, nu, tstart, safe_chi, tau_next, abort_dist,
                                 dnudl, need_chi, u_bb, relativistic)
        w = te.bin_walk(kappa_rho_dop, nu, tstart, safe_chi, tau_next, dnudl, need_chi,
                        relativistic, rpkt_kernel.BIG)
        beyond = w["d_prev"].gather(1, w["j"][:, None])[:, 0] > abort_dist
        dropped.append(int((beyond & w["anyhit"] & need_chi).sum()))
        return ev._replace(edist=torch.where(beyond, torch.full_like(ev.edist, rpkt_kernel.BIG),
                                             ev.edist),
                           is_boundbound=ev.is_boundbound & ~beyond), first, walked

    monkeypatch.setattr(rpkt_kernel, "_expansion_event", truncated)
    cut, _ = _plain_expansion(sc, max_inner=8)
    assert sum(dropped) > 0
    for k, v in full.items():
        assert torch.equal(cut[k], v), k

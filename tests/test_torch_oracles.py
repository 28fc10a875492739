"""The closed-form physics oracles of tests/test_oracles.py on the port,
with that test's own scene, packets and tolerances: the port's transport
loop with the plain version of the crossing kernel on the CPU (the same
checks run through the kernel K1 on the card in tests/test_torch_cuda.py,
which imports ``pcygni_check`` and ``planck_check`` from here; this file
imports no jax).

1. P-Cygni line profile of a two-level atom (``test_pcygni_two_level_atom``,
   tests/test_oracles.py:146): 262144 r-packets leave a transparent
   photosphere at v_ph = 0.4 vmax with a flat comoving spectrum over
   +-2.6 vmax/c around the single line, which has a constant Sobolev
   depth 1.3 outside the photosphere and no continuum; the escaping
   profile is held bin by bin to the Jeffery & Branch (1990) quadrature
   (0.06 + 4 sigma), its rms deviation under 0.035 and its equivalent
   width within 0.05. The packets are four times the JAX test's 65536:
   at 65536 the Monte Carlo noise of one run alone is about the rms limit
   (the JAX package's run 0.0305, one run of the port 0.0354 with every
   bin within its tolerance and the equivalent width 0.031 off), while at
   262144 the port's rms is 0.0103 and its equivalent width 0.013 off:
   the deviation falls as 1/sqrt(n), so it is noise, not a bias.
2. Deep-thermalisation limit (``test_thick_cell_spectrum_is_planck``,
   :216): 65536 k-packets in grey thick cells (grey depth 5, T_e 8000 K)
   re-emit a blackbody and diffuse out; the comoving escape spectrum,
   with the expansion redshift undone, has the Planck mean and width and
   the Planck energy share in each of 23 bins (8 % + 4 sigma)."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NPKTS = 65536
NPKTS_PCYGNI = 4 * NPKTS
NCELLS = 20
VMAX_KMPS = 6000.0
IPH = 8  # photosphere at shell boundary IPH -> v_ph = 0.4 * vmax
TAU0 = 1.3
BAND = 2.6  # flat-sampling band half-width in units of vmax/c
CLIGHT = 2.99792458e10
H = 6.62607015e-27
KB = 1.380649e-16


def oracle_sim(d, device):
    """tests/test_oracles.py's scene: 20 shells to 6000 km/s at 5-7 days,
    logrho0 -14, and a single-ion two-level atom (one line, no continua:
    a macro-atom activated at the line's upper level can only deactivate
    through the same line, pure resonance scattering). Returns (sim, opts)."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.options import GridType, kilonova_lte
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    make_run(d, ncells=NCELLS, ntimesteps=4, tmin_days=5.0, tmax_days=7.0, ngreyts=0,
             vmax_kmps=VMAX_KMPS, logrho0=-14.0)
    write_synthetic_atomicdata(d, elements=((26, 1),), nlevels_per_ion=2)
    opts = kilonova_lte(npkts=NPKTS, grid_type=GridType.SPHERICAL1D, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=20, linewalk_chunk=64,
                        transport_dtype="float32")
    sim = Simulation(d, opts, datadir="/nonexistent", device=device)
    assert sim.ad.nlines == 1
    return sim, opts


def _state(sim, ptype, pos, dirs, t1, nu_cmf, nu_rf, e_rf):
    from artis_tpu_torch.grid import get_cellindex_from_pos
    from artis_tpu_torch.packets import empty_state

    n = pos.shape[0]
    dev = sim.device
    st = empty_state(n, dtype=torch.float32, device=dev)
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    posj, tj = f(pos), f(np.full(n, t1))
    where = get_cellindex_from_pos(sim.grid, torch.as_tensor(pos, device=dev),
                                   torch.full((n,), t1, dtype=torch.float64, device=dev))
    return dataclasses.replace(
        st, ptype=torch.full((n,), ptype, dtype=torch.int64, device=dev), prop_time=tj,
        where=where.long(), pos=posj, dir=f(dirs), nu_cmf=f(nu_cmf), nu_rf=f(nu_rf),
        e_cmf=f(np.ones(n)), e_rf=f(e_rf),
        next_trans=torch.full((n,), -1, dtype=torch.int64, device=dev), tdecay=f(np.zeros(n)))


def _surface_rpkts(sim, opts, nu0, r_emit, t1, seed=12345):
    """Packets leaving a transparent sphere surface with I=const (mu-weighted
    outward directions) and a flat cmf spectrum over +-BAND*vmax/c."""
    from artis_tpu_torch import geometry
    from artis_tpu_torch.packets import TYPE_RPKT

    rng = np.random.default_rng(seed)
    n = NPKTS_PCYGNI
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * r_emit * 1.0000001
    mu = np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(0, 2 * np.pi, size=n)
    a = np.where(np.abs(u[:, 2:3]) < 0.9, np.array([[0.0, 0.0, 1.0]]),
                 np.array([[1.0, 0.0, 0.0]]))
    t1v = np.cross(u, a)
    t1v /= np.linalg.norm(t1v, axis=1, keepdims=True)
    t2v = np.cross(u, t1v)
    snt = np.sqrt(1 - mu ** 2)
    dirs = (u * mu[:, None] + t1v * (snt * np.cos(phi))[:, None]
            + t2v * (snt * np.sin(phi))[:, None])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    b = BAND * VMAX_KMPS * 1e5 / CLIGHT
    nu_cmf = nu0 * rng.uniform(1 - b, 1 + b, size=n)
    dop = geometry.doppler_nucmf_on_nurf(torch.as_tensor(pos), torch.as_tensor(dirs),
                                         torch.full((n,), t1, dtype=torch.float64),
                                         opts.use_relativistic_doppler_shift).numpy()
    return _state(sim, TYPE_RPKT, pos, dirs, t1, nu_cmf, nu_cmf / dop, 1.0 / dop)


def _run_transport(sim, opts, st, ctx, max_chunks=40):
    from artis_tpu_torch.packets import TYPE_ESCAPE
    from artis_tpu_torch.transport import engine

    est = sim._zero_est()
    for chunk in range(max_chunks):
        st, est, _, _ = engine.transport_timestep(
            (99, chunk), st, est, sim.grid, sim.dad, sim.aux, sim.rc, sim.rates, sim.cells, ctx,
            opts, max_iters=512, **sim._transport_kwargs(0))
        if not bool((st.ptype != TYPE_ESCAPE).any()):
            break
    return st, est


def _pcygni_oracle(nu_grid, nu0, v_ph, vmax, tau0):
    """Emergent flux / continuum for resonance scattering off a transparent
    emitting sphere (tests/test_oracles.py's quadrature: Jeffery & Branch
    1990, no occulting core)."""
    c = CLIGHT
    out = np.zeros(len(nu_grid))
    pgrid = np.linspace(0, vmax, 4000)
    dp = pgrid[1] - pgrid[0]
    pm = pgrid + dp / 2
    for i, nu in enumerate(np.asarray(nu_grid)):
        vz = c * (1.0 - nu0 / nu)
        r = np.hypot(pm, vz)
        in_env = (r >= v_ph) & (r <= vmax)
        tau = np.where(in_env, tau0, 0.0)
        disk = pm < v_ph
        vez = np.sqrt(np.maximum(v_ph ** 2 - pm ** 2, 0.0))
        att = np.where(disk & in_env & (vz > vez), np.exp(-tau), 1.0)
        i_disk = np.where(disk, att, 0.0)
        w = 0.5 * (1.0 - np.sqrt(np.maximum(1.0 - (v_ph / np.maximum(r, v_ph)) ** 2, 0.0)))
        i_em = np.where(in_env, w * (1.0 - np.exp(-tau)), 0.0)
        out[i] = np.sum((i_disk + i_em) * 2 * pm) * dp / v_ph ** 2
    return out


def pcygni_check(sim, opts):
    """tests/test_oracles.py::test_pcygni_two_level_atom on ``sim``."""
    from artis_tpu_torch.packets import TYPE_ESCAPE

    nu0 = float(sim.dad_f64.line_nu[0])
    ctx = sim.update_grid(0)
    t1 = float(sim.ts.start[0])
    vmax = VMAX_KMPS * 1e5
    v_ph = vmax * IPH / NCELLS
    # constant Sobolev tau outside the photosphere, zero inside; no es/ff/bf
    tau_tab = torch.zeros_like(ctx.tau_sob_factor)
    tau_tab[IPH:, 0] = TAU0 / (t1 * 1.01)
    ctx = dataclasses.replace(ctx, tau_sob_factor=tau_tab,
                              chi_ff_nnionpart=torch.zeros_like(ctx.chi_ff_nnionpart),
                              bf_a=torch.zeros_like(ctx.bf_a), t2=t1 * 1.2)
    sim.cells = dataclasses.replace(sim.cells, nne=torch.zeros_like(sim.cells.nne),
                                    thick=torch.zeros_like(sim.cells.thick))
    st = _surface_rpkts(sim, opts, nu0, v_ph * t1, t1)
    st, _ = _run_transport(sim, opts, st, ctx)
    esc = (st.ptype == TYPE_ESCAPE).cpu().numpy()
    assert esc.mean() > 0.999, f"only {esc.sum()}/{esc.size} escaped"
    nu_esc = st.nu_rf.double().cpu().numpy()[esc]
    e_esc = st.e_rf.double().cpu().numpy()[esc]
    bw = vmax / CLIGHT  # one x-unit in frequency
    nb = 52
    edges = nu0 * (1 + bw * np.linspace(-BAND, BAND, nb + 1))
    hist, _ = np.histogram(nu_esc, bins=edges, weights=e_esc)
    x_mid = ((edges[:-1] + edges[1:]) / 2 / nu0 - 1.0) / bw
    # continuum = plateau bins outside the line but inside clean sampling
    cont_sel = (np.abs(x_mid) > 1.25) & (np.abs(x_mid) < 2.0)
    cont = hist[cont_sel].mean()
    assert cont > 0
    prof_mc = hist / cont
    counts, _ = np.histogram(nu_esc, bins=edges)
    prof_an = np.zeros(nb)
    for i in range(nb):
        sub = np.linspace(edges[i], edges[i + 1], 9)[1::2]
        prof_an[i] = _pcygni_oracle(sub, nu0, v_ph, vmax, TAU0).mean()
    # away from the sampling-band edges and the envelope-edge resonance
    # discontinuities at x = +-1
    sel = (np.abs(x_mid) < 2.0) & (np.abs(np.abs(x_mid) - 1.0) > 0.1)
    sigma = np.sqrt(np.maximum(counts, 1)) / counts
    for i in np.nonzero(sel)[0]:
        tol = 0.06 + 4.0 * sigma[i] * max(prof_mc[i], 0.3)
        assert abs(prof_mc[i] - prof_an[i]) < tol, (
            f"bin x={x_mid[i]:+.2f}: mc={prof_mc[i]:.4f} an={prof_an[i]:.4f} tol={tol:.4f}")
    rms = float(np.sqrt(np.mean((prof_mc[sel] - prof_an[sel]) ** 2)))
    assert rms < 0.035, f"profile rms deviation {rms:.4f}"
    line_sel = np.abs(x_mid) <= 1.25
    dx = x_mid[1] - x_mid[0]
    ew_mc = float(np.sum((prof_mc - 1.0)[line_sel]) * dx)
    ew_an = float(np.sum((prof_an - 1.0)[line_sel]) * dx)
    assert abs(ew_mc - ew_an) < 0.05, (ew_mc, ew_an)
    return dict(rms=rms, ew_mc=ew_mc, ew_an=ew_an)


def planck_check(sim, opts):
    """tests/test_oracles.py::test_thick_cell_spectrum_is_planck on ``sim``."""
    from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_KPKT

    ctx = sim.update_grid(0)
    t1 = float(sim.ts.start[0])
    vmax = VMAX_KMPS * 1e5
    t_set = 8000.0
    tau_grey = 5.0
    rho = sim.cells.rho.double().cpu().numpy()
    r_out = vmax * t1
    kappagrey = (tau_grey / r_out) / np.maximum(rho, 1e-300)
    c = sim.cells
    sim.cells = dataclasses.replace(
        c, nne=torch.zeros_like(c.nne), Te=torch.full_like(c.Te, t_set),
        thick=torch.ones_like(c.thick),
        kappagrey=torch.as_tensor(kappagrey, dtype=c.kappagrey.dtype, device=c.kappagrey.device))
    ctx = dataclasses.replace(ctx, tau_sob_factor=torch.zeros_like(ctx.tau_sob_factor),
                              chi_ff_nnionpart=torch.zeros_like(ctx.chi_ff_nnionpart),
                              bf_a=torch.zeros_like(ctx.bf_a), t2=t1 * 1.4)
    rng = np.random.default_rng(777)
    n = NPKTS
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radii = 0.5 * r_out * rng.uniform(size=n) ** (1 / 3)
    st = _state(sim, TYPE_KPKT, u * radii[:, None], u, t1, np.full(n, 1e15), np.full(n, 1e15),
                np.ones(n))
    st, _ = _run_transport(sim, opts, st, ctx, max_chunks=60)
    esc = (st.ptype == TYPE_ESCAPE).cpu().numpy()
    assert esc.mean() > 0.98, f"only {esc.sum()}/{n} escaped"
    # t * nu_cmf is conserved along every ray in first-order homologous
    # flow and grey scattering is coherent in the cmf: undo the expansion
    # redshift and the comoving escape spectrum is the emission Planck one
    t_esc = st.escape_time.double().cpu().numpy()[esc]
    nu = st.nu_cmf.double().cpu().numpy()[esc] * t_esc / t1
    e = st.e_cmf.double().cpu().numpy()[esc]
    kt_h = KB * t_set / H
    zeta4, zeta5, zeta6 = 1.0823232337, 1.0369277551, 1.0173430619
    mean_an = 4.0 * zeta5 / zeta4 * kt_h
    m2_an = 20.0 * zeta6 / zeta4 * kt_h ** 2
    mean_mc = float(np.sum(nu * e) / np.sum(e))
    sd_an = np.sqrt(m2_an - mean_an ** 2)
    sd_mc = float(np.sqrt(np.sum(e * (nu - mean_mc) ** 2) / np.sum(e)))
    assert abs(mean_mc / mean_an - 1.0) < 0.005 + 4.0 * sd_an / mean_an / np.sqrt(esc.sum()), (
        mean_mc, mean_an)
    assert abs(sd_mc / sd_an - 1.0) < 0.02, (sd_mc, sd_an)
    edges = kt_h * np.linspace(0.5, 12.0, 24)
    hist, _ = np.histogram(nu, bins=edges, weights=e)
    counts, _ = np.histogram(nu, bins=edges)
    xs = np.linspace(0.02, 30.0, 6000) * kt_h
    bnu = (xs / kt_h) ** 3 / np.expm1(np.clip(xs / kt_h, 1e-6, 80.0))
    total = np.trapezoid(bnu, xs)
    frac_mc = hist / np.sum(e)
    for i in range(len(edges) - 1):
        m = (xs >= edges[i]) & (xs < edges[i + 1])
        frac_an = np.trapezoid(bnu[m], xs[m]) / total
        if frac_an < 2e-3:
            continue
        tol = 0.08 * frac_an + 4.0 * np.sqrt(max(counts[i], 1)) / esc.sum()
        assert abs(frac_mc[i] - frac_an) < tol, (
            f"bin [{edges[i] / kt_h:.1f},{edges[i + 1] / kt_h:.1f}] kT/h: "
            f"mc={frac_mc[i]:.5f} an={frac_an:.5f}")
    return dict(mean_ratio=mean_mc / mean_an, sd_ratio=sd_mc / sd_an)


@pytest.fixture(scope="module")
def cpu_sim(tmp_path_factory):
    sim, opts = oracle_sim(str(tmp_path_factory.mktemp("torch_oracle")), "cpu")
    yield sim, opts
    sim.close()


def test_pcygni_two_level_atom(cpu_sim):
    pcygni_check(*cpu_sim)


def test_thick_cell_spectrum_is_planck(cpu_sim):
    planck_check(*cpu_sim)

"""Virtual packets: observer-direction spectra with polarisation.

Port of the JAX package's vpkt module (reference: vpkt.cc:899-962
vpkt_call_estimators, 162-420 rlc_emiss_vpkt, 33-111 binned Stokes spectra,
611-790 vpkt.txt configuration; Bulla, Sim & Kromer 2015).

At every real-packet interaction (electron scatter, macro-atom or k-packet
emission) a virtual packet is launched toward each observer direction: the
direction-dependent emission weight comes from the Rayleigh dipole phase
matrix (scatters) or 1/4pi (thermal emission), the optical depth along the
ray to escape is integrated, and e_rf * pn * exp(-tau) is accumulated into
time/frequency-binned Stokes (I, Q, U) spectra per opacity-exclusion channel.

The rays are traced as batched torch ops: the interacting packets are
compacted, flattened over (packets x observers), the rays outside the time
and frequency windows dropped, and the rest traced in chunks of at most
``RAY_CHUNK`` rays (which bounds the (rays, continua) temporaries of the
bound-free opacity). The line opacity of a segment is closed form: with nu
linear in distance, sum_l tau_l (t + D(nu_l)/c) over the lines crossed is
expressible through two per-timestep cumulative tables, sum(tau_factor)
and sum(tau_factor * nu), built in float64 (a float32 running sum over
1e5 lines keeps too few digits of a segment's share; ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import geometry
from ..constants import CLIGHT_PROP, DAY, PI
from ..devutil import index_add
from ..grid import BOUNDARY_ESCAPE, boundary_distance
from . import opacity

# the most rays traced at once
RAY_CHUNK = 1 << 17
# crossings between two host checks of whether every ray of a chunk ended
CHECK_EVERY = 4
# what the traces did since the last reset_stats(): sites spawned from,
# rays traced (those inside the time and frequency windows) and the cell
# crossings of those rays
STATS = dict(sites=0, rays=0, crossings=0)


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class VpktConfig:
    obsdirs: torch.Tensor  # (nobs, 3) float64 unit vectors
    numin: torch.Tensor  # (nranges,) frequency selection windows [Hz]
    numax: torch.Tensor
    nobs: int
    nspectra: int
    exclude: tuple  # per spectrum: 0 all, -1 no-bb, -2 no-bf, -3 no-ff, -4 no-es, Z>0 no element Z
    tmin: float  # arrival-time window [s]
    tmax: float
    tau_max: float
    vmtbins: int
    vmnubins: int
    specnumin: float  # spectral grid (log-nu bins)
    specnumax: float
    # velocity-grid polarisation maps (reference: vpkt.cc:66-160)
    vgrid_numin: torch.Tensor | None = None  # (nwlbins,) frequency selection per map
    vgrid_numax: torch.Tensor | None = None
    vgrid_on: bool = False
    vgrid_tmin: float = 0.0  # arrival-time selection [s]
    vgrid_tmax: float = 0.0
    vgrid_ny: int = 50  # reference: VGRID_NY/VGRID_NZ (vpkt.h)
    vgrid_nz: int = 50
    # vpkt-only grey-depth threshold: cells with grey_depth above it get
    # thick=2 (vpkts die there, r-packets transport normally;
    # vpkt.cc:739-748, update_grid.cc:1031-1035); < 0 means "inherit
    # cell_is_optically_thick" (override_thickcell_tau != 1)
    thick_vpkt: float = -1.0


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def read_vpkt_config(path: str, tmin: float, tmax: float, vmtbins: int = 30,
                     vmnubins: int = 1000) -> VpktConfig:
    """Parse vpkt.txt (reference: vpkt.cc:611-790; the JAX package's
    parser, short files read as leniently)."""
    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)
    nobs = int(next(it))
    costh = [min(max(float(next(it)), -0.9999), 0.9999) for _ in range(nobs)]
    phis = [float(next(it)) * PI / 180.0 for _ in range(nobs)]
    dirs = np.array([[np.sqrt(1 - c * c) * np.cos(p), np.sqrt(1 - c * c) * np.sin(p), c]
                     for c, p in zip(costh, phis)])
    if int(next(it)) == 1:
        nspectra = int(next(it))
        exclude = tuple(int(next(it)) for _ in range(nspectra))
    else:
        nspectra, exclude = 1, (0,)
    override_t = int(next(it))
    t0 = float(next(it)) * DAY
    t1 = float(next(it)) * DAY
    if override_t != 1:
        t0, t1 = tmin, tmax
    if int(next(it)) == 1:
        nranges = int(next(it))
        ranges = [(float(next(it)), float(next(it))) for _ in range(nranges)]
        # in Angstroms (lambda max, lambda min per reference usage)
        numin = np.array([2.99792458e18 / max(a, b) for a, b in ranges])
        numax = np.array([2.99792458e18 / min(a, b) for a, b in ranges])
    else:
        numin, numax = np.array([1e14]), np.array([5e15])
    # reference order (vpkt.cc:741-790): the thick-cell override pair,
    # tau_max, then the velocity-grid map section
    tau_max, thick_vpkt, vgrid_on = 10.0, -1.0, False
    vg_t0, vg_t1 = t0, t1
    vg_numin, vg_numax = np.array([1e14]), np.array([5e15])
    rest = []
    try:
        rest.append(float(next(it)))
        rest.append(float(next(it)))
        # "override_thickcell cell_thick_tau": with the flag 1 the given
        # grey-depth threshold marks cells thick=2 for vpkts only
        if int(rest[0]) == 1:
            thick_vpkt = rest[1]
        tau_max = float(next(it))
        vgrid_on = int(float(next(it))) != 0
        if vgrid_on:
            vg_t0 = float(next(it)) * DAY
            vg_t1 = float(next(it)) * DAY
            nrg = int(float(next(it)))
            pairs = [(float(next(it)), float(next(it))) for _ in range(nrg)]
            vg_numin = np.array([2.99792458e18 / max(a, b) for a, b in pairs])
            vg_numax = np.array([2.99792458e18 / min(a, b) for a, b in pairs])
    except StopIteration:
        # a file that ends after the pair's first entry takes it as tau_max
        if rest and tau_max == 10.0:
            tau_max = rest[0]
    return VpktConfig(
        obsdirs=_t(dirs), numin=_t(numin), numax=_t(numax), nobs=nobs, nspectra=nspectra,
        exclude=exclude, tmin=float(t0), tmax=float(t1), tau_max=tau_max, vmtbins=vmtbins,
        vmnubins=vmnubins, specnumin=1e14, specnumax=5e15, vgrid_numin=_t(vg_numin),
        vgrid_numax=_t(vg_numax), vgrid_on=vgrid_on, vgrid_tmin=float(vg_t0),
        vgrid_tmax=float(vg_t1), thick_vpkt=thick_vpkt)


def default_vpkt_config(tmin: float, tmax: float, nobs: int = 1, vmtbins: int = 30,
                        vmnubins: int = 1000) -> VpktConfig:
    """The configuration without vpkt.txt: ``nobs`` observers in the xz
    plane, cos theta evenly over [-0.9, 0.9] (0 for one), all opacity."""
    costh = np.linspace(-0.9, 0.9, nobs) if nobs > 1 else np.array([0.0])
    dirs = np.stack([np.sqrt(1 - costh ** 2), np.zeros(nobs), costh], axis=1)
    return VpktConfig(
        obsdirs=_t(dirs), numin=_t([1e14]), numax=_t([5e15]), nobs=nobs, nspectra=1,
        exclude=(0,), tmin=tmin, tmax=tmax, tau_max=10.0, vmtbins=vmtbins, vmnubins=vmnubins,
        specnumin=1e14, specnumax=5e15, vgrid_numin=_t([1e14]), vgrid_numax=_t([5e15]))


def zero_vspectra(cfg: VpktConfig, dtype=torch.float32, device="cpu"):
    """(nobs, nspectra, vmtbins, vmnubins, 3) Stokes I, Q, U flux sums."""
    return torch.zeros((cfg.nobs, cfg.nspectra, cfg.vmtbins, cfg.vmnubins, 3), dtype=dtype,
                       device=device)


def exclusion_tables_spec(exclude: tuple) -> tuple:
    """Unique excluded element Zs, defining extra line-opacity tables
    (table 0 = all lines; table 1+i = lines of Z=zs[i] removed)."""
    return tuple(sorted({z for z in exclude if z > 0}))


def build_vpkt_tables(tau_sob_factor, dad, exclude: tuple = (), dtype=torch.float64):
    """Cumulative line-opacity tables for the closed-form segment tau (per
    timestep): (ntab, ncells, nlines+1) cumsums of tau_factor and of
    tau_factor * nu over the nu-descending line list, in ``dtype``. Table 0
    holds all lines, one more table per excluded element Z zeroes that
    element's lines (reference: vpkt.cc:330-340)."""
    tf = tau_sob_factor.to(dtype)
    nu = dad.line_nu.to(dtype)[None, :]
    zero = torch.zeros((tf.shape[0], 1), dtype=dtype, device=tf.device)
    tabs_t, tabs_n = [], []
    keeps = [None] + [dad.elem_z[dad.ion_element[dad.line_ion]] != z
                      for z in exclusion_tables_spec(exclude)]
    for keep in keeps:
        tfk = tf if keep is None else torch.where(keep[None, :], tf, torch.zeros_like(tf))
        tabs_t.append(torch.cat([zero, torch.cumsum(tfk, dim=1)], dim=1))
        tabs_n.append(torch.cat([zero, torch.cumsum(tfk * nu, dim=1)], dim=1))
    return torch.stack(tabs_t), torch.stack(tabs_n)


def _segment_bb_tau(line_nu_neg, cum_tau, cum_taunu, cellidx, nu_start, nu_end, t_start,
                    d_nu_on_d_l):
    """Exact sum of tau_sobolev(t at line crossing) over the lines with
    nu_end < nu_trans <= nu_start (reference: vpkt.cc:293-346 per-line
    walk), in the tables' dtype. With nu(d) = nu_start + d_nu_on_d_l * d,
    line l crosses at D_l = (nu_l - nu_start) / d_nu_on_d_l, so
    sum tau_l (t + D_l/c) = s_tau (t - nu_start / (c dndl)) + s_taunu / (c dndl).
    ``line_nu_neg`` is -line_nu (ascending)."""
    dt = cum_tau.dtype
    nlines = line_nu_neg.shape[0]
    j1 = torch.searchsorted(line_nu_neg, -nu_start.contiguous(), right=False)
    j2 = torch.searchsorted(line_nu_neg, -nu_end.contiguous(), right=True)
    j1 = torch.clamp(j1, 0, nlines)
    j2 = torch.maximum(torch.clamp(j2, max=nlines), j1)
    s_tau = cum_tau[cellidx, j2] - cum_tau[cellidx, j1]
    s_taunu = cum_taunu[cellidx, j2] - cum_taunu[cellidx, j1]
    inv_cd = 1.0 / (CLIGHT_PROP * d_nu_on_d_l.to(dt))
    return torch.clamp(s_tau * (t_start.to(dt) - nu_start.to(dt) * inv_cd) + s_taunu * inv_cd,
                       min=0.0)


def _emission(obs, rpos, rt, rdir_in, rq_in, ru_in, ris_scatter):
    """Emission weight pn and the emergent Stokes Q, U in the observer's
    frame (vpkt.cc:180-256, Bulla et al. 2015): the dipole phase matrix for
    scatters, 1/4pi and no polarisation for thermal emission."""
    vel = geometry.get_velocity(rpos, rt)
    old_dir_cmf, qi, ui = geometry.frame_transform(rdir_in, rq_in, ru_in, vel)
    obs_cmf = geometry.angle_ab(obs, vel)
    ref1_o, ref2_o = geometry.meridian(old_dir_cmf)
    i1 = geometry.get_rot_angle(old_dir_cmf, obs_cmf, ref1_o, ref2_o)
    qold = qi * torch.cos(2 * i1) - ui * torch.sin(2 * i1)
    uold = qi * torch.sin(2 * i1) + ui * torch.cos(2 * i1)
    mu = geometry.dot(old_dir_cmf, obs_cmf)
    pn_scatter = 3.0 / (16.0 * PI) * (1 + mu ** 2 + (mu ** 2 - 1) * qold)
    inew = 0.75 * ((mu * mu + 1.0) + qold * (mu * mu - 1.0))
    qnew = (0.75 * ((mu * mu - 1.0) + qold * (mu * mu + 1.0))) / torch.clamp(inew, min=1e-30)
    unew = (1.5 * mu * uold) / torch.clamp(inew, min=1e-30)
    ref1_n, ref2_n = geometry.meridian(obs_cmf)
    i2 = PI + geometry.get_rot_angle(obs_cmf, old_dir_cmf, ref1_n, ref2_n)
    q_sc = qnew * torch.cos(2 * i2) + unew * torch.sin(2 * i2)
    u_sc = -qnew * torch.sin(2 * i2) + unew * torch.cos(2 * i2)
    _, q_rf, u_rf = geometry.frame_transform(obs_cmf, q_sc, u_sc, -vel)
    zero = torch.zeros_like(q_rf)
    pn = torch.where(ris_scatter, pn_scatter, torch.full_like(pn_scatter, 1.0 / (4 * PI)))
    return pn, torch.where(ris_scatter, q_rf, zero), torch.where(ris_scatter, u_rf, zero)


def _trace_rays(cfg, dad, grid, cells, ctx, cum_tau, cum_taunu, line_nu_neg, obs, pos, t,
                where, nu_c, max_crossings: int, opacity_case: int):
    """Per-channel optical depth (n, nspectra) of rays from ``pos`` at time
    ``t`` in cell ``where`` with cmf frequency ``nu_c`` toward ``obs``, to
    escape; inf for rays killed by tau_max or a thick cell (vpkt.cc:283,
    365: thick 1 and 2). A ray passes empty cells untouched. At most
    ``max_crossings`` crossings; every ``CHECK_EVERY`` crossings the host
    checks whether any ray is left and drops the finished ones."""
    n = pos.shape[0]
    dt = pos.dtype
    zs = exclusion_tables_spec(cfg.exclude)
    tabs = sorted({0, *(1 + zs.index(e) for e in cfg.exclude if e > 0)})
    excl = {-2: 2, -3: 1, -4: 0}  # channel -> the continuum it leaves out (es, ff, bf)
    tau_out = torch.zeros((n, cfg.nspectra), dtype=dt, device=pos.device)
    rows = torch.arange(n, device=pos.device)
    t0 = t
    it = 0
    crossings = torch.zeros((), dtype=torch.int64, device=pos.device)
    while it < max_crossings:
        done = torch.zeros(rows.shape[0], dtype=torch.bool, device=pos.device)
        tau = tau_out[rows]
        for _ in range(min(CHECK_EVERY, max_crossings - it)):
            it += 1
            crossings += (~done).sum()
            sdist, snext = boundary_distance(grid, obs, pos, t, where)
            sdist = torch.clamp(sdist, min=0.0)
            s_cont = sdist * (t0 / t) ** 3
            mgi = grid.nonemptymgi_of_cell[where]
            nonempty = mgi >= 0
            safe_mgi = torch.clamp(mgi, min=0)
            # vpkts die in thick 1 (grey) and thick 2 (vpkt-only) cells
            thick = nonempty & (cells.thick[safe_mgi] != 0)
            live = ~done & nonempty
            chi = opacity.calculate_chi_rpkt_cont(
                dad, torch.where(live, nu_c, torch.full_like(nu_c, 1e15)), safe_mgi, live,
                ctx.bf_a, ctx.bf_dep, ctx.chi_ff_nnionpart, cells.nne, cells.Te, opacity_case)
            chi_tot = chi[0] + chi[1] + chi[2]
            # continuum per channel with exclusions (vpkt.cc:267-280)
            chi_chan = torch.stack([chi_tot - chi[excl[e]] if e in excl else chi_tot
                                    for e in cfg.exclude], dim=1)
            # line opacity over the segment, closed form; the segment's
            # frequencies and dnu/dl in the tables' dtype (float64): in
            # float32 a short segment's Doppler change would round to 0 and
            # the clamps below to -0, giving NaN
            t_end = t + sdist / CLIGHT_PROP
            pos_end = pos + obs * sdist[:, None]
            p64, o64, t64, s64, nu64 = (x.to(cum_tau.dtype) for x in (pos, obs, t, sdist, nu_c))
            nu_rf_ray = nu64 / geometry.doppler_nucmf_on_nurf(p64, o64, t64, False)
            nu_end64 = nu_rf_ray * geometry.doppler_nucmf_on_nurf(
                p64 + o64 * s64[:, None], o64, t64 + s64 / CLIGHT_PROP, False)
            dndl = torch.clamp((nu_end64 - nu64) / torch.clamp(s64, min=1e-300), max=-1e-300)
            nu_cmf_end = nu_end64.to(dt)
            tb = {}
            for k in tabs:
                seg = _segment_bb_tau(line_nu_neg, cum_tau[k], cum_taunu[k], safe_mgi, nu64,
                                      nu_end64, t64, dndl).to(dt)
                tb[k] = torch.where(live & ~thick, seg, torch.zeros_like(seg))
            # bb per channel: none for -1, the element-excluded table for
            # Z>0 (vpkt.cc:330-340), every line otherwise
            bb_chan = torch.stack([torch.zeros_like(tb[0]) if e == -1
                                   else tb[1 + zs.index(e)] if e > 0 else tb[0]
                                   for e in cfg.exclude], dim=1)
            tau = tau + torch.where(live[:, None], chi_chan * s_cont[:, None] + bb_chan,
                                    torch.zeros_like(chi_chan))
            # killed on tau_max or on passing through a thick cell
            killed = live & ((tau.min(dim=1).values > cfg.tau_max) | thick)
            tau = torch.where(killed[:, None], torch.full_like(tau, torch.inf), tau)
            escaped = snext == BOUNDARY_ESCAPE
            pos = torch.where(done[:, None], pos, pos_end)
            t = torch.where(done, t, t_end)
            nu_c = torch.where(done, nu_c, nu_cmf_end)
            where = torch.where(done | escaped, where, torch.clamp(snext, min=0))
            done = done | killed | escaped
        tau_out[rows] = tau
        if it >= max_crossings or bool(done.all()):
            break
        keep = ~done
        rows, obs, pos, t, t0, where, nu_c = (x[keep] for x in (rows, obs, pos, t, t0, where,
                                                                nu_c))
    STATS["crossings"] += int(crossings)
    return tau_out


def trace_vpkts(cfg: VpktConfig, vspec, dad, grid, cells, ctx, cum_tau, cum_taunu, pos, dirvec,
                prop_time, where, nu_cmf, e_cmf, stokes_qu, is_scatter, active,
                opacity_case: int, e_scale: float = 1.0, max_crossings: int = 512,
                vgrid_acc=None):
    """Launch virtual packets from the ``active`` interaction sites toward
    every observer and add their exp(-tau)-weighted Stokes fluxes to a copy
    of ``vspec`` (reference: vpkt.cc:899-962). With cfg.vgrid_on and
    a ``vgrid_acc`` accumulator, also bins each ray's emission velocity,
    projected onto the observer plane, into the polarisation maps
    (vpkt.cc:66-160). Returns (vspec, vgrid_acc). Below ``opacity_case``
    4 the rays' continuum is free-free only."""
    dev, dt = pos.device, pos.dtype
    nobs = cfg.nobs
    sites = torch.nonzero(active)[:, 0]
    STATS["sites"] += sites.numel()
    if sites.numel() == 0:
        return vspec, vgrid_acc
    # flatten (sites, observers) -> rays
    obs_all = cfg.obsdirs.to(device=dev, dtype=dt)
    site = sites.repeat_interleave(nobs)
    obsidx = torch.arange(nobs, device=dev).repeat(sites.numel())
    obs = obs_all[obsidx]
    rpos, rt = pos[site], prop_time[site]
    # the rest-frame frequency and arrival time that select and bin a ray,
    # in float64: in float32 the card's and the CPU's rounding put a ray at
    # a bin edge into different bins
    f64 = torch.float64
    pos64, obs64, rt64 = rpos.to(f64), cfg.obsdirs.to(dev)[obsidx], rt.to(f64)
    doppler = geometry.doppler_nucmf_on_nurf(pos64, obs64, rt64, False)
    nu_rf = nu_cmf[site].to(f64) / doppler
    e_rf = (e_cmf[site].to(f64) / doppler).to(dt)
    # arrival-time / frequency-window selection (vpkt.cc:925-945)
    t_arrive = rt64 - geometry.dot(pos64, obs64) / CLIGHT_PROP
    in_nu = ((nu_rf[:, None] > cfg.numin.to(dev)[None, :])
             & (nu_rf[:, None] < cfg.numax.to(dev)[None, :])).any(dim=1)
    sel = torch.nonzero((t_arrive >= cfg.tmin) & (t_arrive <= cfg.tmax) & in_nu)[:, 0]
    if sel.numel() == 0:
        return vspec, vgrid_acc
    STATS["rays"] += sel.numel()
    site, obsidx, obs, rpos, rt = site[sel], obsidx[sel], obs[sel], rpos[sel], rt[sel]
    nu_rf, e_rf, t_arrive = nu_rf[sel], e_rf[sel], t_arrive[sel]
    pn, q_out, u_out = _emission(obs, rpos, rt, dirvec[site], stokes_qu[site, 0],
                                 stokes_qu[site, 1],
                                 torch.as_tensor(is_scatter, device=dev).expand_as(active)[site])
    line_nu_neg = -dad.line_nu.to(cum_tau.dtype).contiguous()
    tau = torch.cat([
        _trace_rays(cfg, dad, grid, cells, ctx, cum_tau, cum_taunu, line_nu_neg,
                    obs[c:c + RAY_CHUNK], rpos[c:c + RAY_CHUNK], rt[c:c + RAY_CHUNK],
                    where[site[c:c + RAY_CHUNK]], nu_cmf[site[c:c + RAY_CHUNK]], max_crossings,
                    opacity_case)
        for c in range(0, sel.numel(), RAY_CHUNK)])

    # --- bin into the Stokes spectra (vpkt.cc:33-111 add_to_vspecpol) ---
    dlogt = np.log(cfg.tmax / cfg.tmin) / cfg.vmtbins
    dlognu = np.log(cfg.specnumax / cfg.specnumin) / cfg.vmnubins
    tbin = torch.floor(torch.log(torch.clamp(t_arrive, min=1e-30) / cfg.tmin) / dlogt).long()
    nubin = torch.floor(torch.log(torch.clamp(nu_rf, min=1e-30) / cfg.specnumin) / dlognu).long()
    ok = (tbin >= 0) & (tbin < cfg.vmtbins) & (nubin >= 0) & (nubin < cfg.vmnubins)
    weights = torch.exp(-tau)  # (n, nspec); killed rays: 0
    stokes = torch.stack([torch.ones_like(q_out), q_out, u_out], dim=1)  # (n, 3)
    contrib = e_rf * pn * e_scale
    vals = contrib[:, None, None] * weights[:, :, None] * stokes[:, None, :]
    nspec = cfg.nspectra
    flat = (((obsidx * nspec)[:, None] + torch.arange(nspec, device=dev)[None, :])
            * cfg.vmtbins + tbin[:, None]) * cfg.vmnubins + nubin[:, None]  # (n, nspec)
    vspec = index_add(vspec.reshape(-1, 3), 0, flat[ok].reshape(-1),
                      vals[ok].reshape(-1, 3).to(vspec.dtype)).view(vspec.shape)

    if cfg.vgrid_on and vgrid_acc is not None:
        # emission velocity rotated into (n_obs, ref1, ref2)
        # (reference: vpkt.cc:114-160 add_to_vpkt_grid)
        vel0 = rpos / rt[:, None]
        ox, oy, oz = obs[:, 0], obs[:, 1], obs[:, 2]
        denom = torch.clamp(1.0 + ox, min=1e-6)
        sq = torch.sqrt(torch.clamp(1.0 - ox * ox, min=1e-12))
        vref1 = (-oy * vel0[:, 0] + (ox + oz * oz / denom) * vel0[:, 1]
                 - oy * oz * (1.0 - ox) / sq * vel0[:, 2])
        vref2 = (-oz * vel0[:, 0] - oy * oz * (1.0 - ox) / sq * vel0[:, 1]
                 + (ox + oy * oy / denom) * vel0[:, 2])
        # observer along +x: (vref1, vref2) = (vy, vz) exactly
        on_x = torch.abs(ox) > 0.999999
        vref1 = torch.where(on_x, torch.sign(ox) * vel0[:, 1], vref1)
        vref2 = torch.where(on_x, torch.sign(ox) * vel0[:, 2], vref2)
        vmax = float(grid.vmax)
        ny_b = torch.floor((vmax - vref1) / (2.0 * vmax / cfg.vgrid_ny)).long()
        nz_b = torch.floor((vmax - vref2) / (2.0 * vmax / cfg.vgrid_nz)).long()
        ok_v = ((torch.abs(vref1) < vmax) & (torch.abs(vref2) < vmax)
                & (t_arrive >= cfg.vgrid_tmin) & (t_arrive <= cfg.vgrid_tmax))
        # channel 0 (all opacity) weights the maps (vpkt.cc:404-413)
        svals = (e_rf * e_scale * weights[:, 0])[:, None] * stokes  # (n, 3)
        nwl = vgrid_acc.shape[1]
        in_wl = ((nu_rf[:, None] > cfg.vgrid_numin.to(dev)[None, :])
                 & (nu_rf[:, None] < cfg.vgrid_numax.to(dev)[None, :]))
        wl = torch.arange(nwl, device=dev)
        ny_s = torch.clamp(ny_b, 0, cfg.vgrid_ny - 1)
        nz_s = torch.clamp(nz_b, 0, cfg.vgrid_nz - 1)
        vflat = (((obsidx * nwl)[:, None] + wl[None, :]) * cfg.vgrid_ny
                 + ny_s[:, None]) * cfg.vgrid_nz + nz_s[:, None]  # (n, nwl)
        take = ok_v[:, None] & in_wl
        vvals = svals[:, None, :].expand(-1, nwl, -1)
        vgrid_acc = index_add(vgrid_acc.reshape(-1, 3), 0, vflat[take],
                              vvals[take].to(vgrid_acc.dtype)).view(vgrid_acc.shape)
    return vspec, vgrid_acc


def write_vspecpol(path: str, cfg: VpktConfig, vspec, nprocs: int = 1):
    """specpol_virtual output (reference: vpkt.cc write_vspecpol layout:
    first column arrival times, then per time bin I, Q, U columns)."""
    arr = np.asarray(vspec)  # (nobs, nspec, nt, nnu, 3)
    dlogt = np.log(cfg.tmax / cfg.tmin) / cfg.vmtbins
    dlognu = np.log(cfg.specnumax / cfg.specnumin) / cfg.vmnubins
    tmid = cfg.tmin * np.exp((np.arange(cfg.vmtbins) + 0.5) * dlogt)
    numid = cfg.specnumin * np.exp((np.arange(cfg.vmnubins) + 0.5) * dlognu)
    dt = cfg.tmin * (np.exp((np.arange(cfg.vmtbins) + 1) * dlogt)
                     - np.exp(np.arange(cfg.vmtbins) * dlogt))
    dnu = cfg.specnumin * (np.exp((np.arange(cfg.vmnubins) + 1) * dlognu)
                           - np.exp(np.arange(cfg.vmnubins) * dlognu))
    # flux normalisation to a 1 Mpc observer (reference exspec convention)
    MPC2 = (3.0857e24) ** 2
    norm = 1.0 / (4 * PI * MPC2) / nprocs
    with open(path, "w") as f:
        f.write("0 " + " ".join(f"{t / DAY:g}" for t in tmid) + "\n")
        for iobs in range(cfg.nobs):
            for ispec in range(cfg.nspectra):
                for stokes_i in range(3):
                    for inu in range(cfg.vmnubins):
                        row = [f"{numid[inu]:g}"]
                        for itb in range(cfg.vmtbins):
                            val = arr[iobs, ispec, itb, inu, stokes_i]
                            row.append(f"{val * norm / dt[itb] / dnu[inu]:g}")
                        f.write(" ".join(row) + "\n")


def write_vpkt_grid(path: str, cfg: VpktConfig, vgrid, vmax: float, nprocs: int = 1):
    """Velocity-grid polarisation map file (reference: vpkt.cc:527-560
    write_vpkt_grid): one row per (obsdir, wlbin, ny, nz) with the bin's
    central (vref1, vref2) and summed Stokes I, Q, U."""
    vg = np.asarray(vgrid, dtype=np.float64) / nprocs
    nobs, nwl, ny, nz, _ = vg.shape
    ybin = 2.0 * vmax / ny
    zbin = 2.0 * vmax / nz
    with open(path, "w") as f:
        f.write("#obsdirindex wlbin vref1 vref2 I Q U\n")
        for o in range(nobs):
            for wl in range(nwl):
                for n in range(ny):
                    vref1 = vmax - (n + 0.5) * ybin
                    for m in range(nz):
                        vref2 = vmax - (m + 0.5) * zbin
                        i, q, u = vg[o, wl, n, m]
                        f.write(f"{o} {wl} {vref1:g} {vref2:g} {i:g} {q:g} {u:g}\n")

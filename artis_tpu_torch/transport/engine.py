"""The batched packet-transport engine: one timestep = a loop of masked
"advance one action" passes over the whole packet batch.

Port of the JAX package's engine (reference: update_packets.cc:361-437
update_packets, rpkt.cc:604-737 do_rpkt_step, gammapkt.cc:719-817
transport_gamma, gammapkt.cc:380-458 compton_scatter, gammapkt.cc:983-1024
pellet_gamma_decay, kpkt.cc:377-402 do_kpkt_blackbody,
update_packets.cc:30-211 pellet/nonthermal handling).

Every iteration advances every active packet by one action: pellet decay,
non-thermal deposition, k-packet destruction, a gamma flight step, an
r-packet propagation through up to ``rpkt_crossings_per_dispatch`` crossings
(the crossing kernel, ``rpkt_kernel.propagate``), the event pass, and
macro-atom resolution. Phases with no packet to act on are skipped on the
host. With ``dipole`` (the classic preset) the kernel hands every event,
electron scattering included, to the event pass, which scatters by the
dipole phase function and carries the Stokes vector
(``electron_scatter_batch``); otherwise electron scattering is an isotropic
redirect inside the kernel.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import geometry, rng, stats
from ..atomic import DeviceAtomicData
from ..constants import CLIGHT_PROP, H, ME_C2, MEV, PI, SIGMA_T, THOMSON_LIMIT
from ..decay import DECAYTYPE_ALPHA, DECAYTYPE_BETAMINUS, DECAYTYPE_BETAPLUS
from ..devutil import index_add_
from ..estimators import Estimators, cell_add
from ..grid import BOUNDARY_ESCAPE, GridData, boundary_distance
from ..options import GridType, Options, ThermalisationScheme
from ..packets import (
    EMTYPE_FREEFREE, EMTYPE_NOTSET, TYPE_ESCAPE, TYPE_GAMMA, TYPE_KPKT, TYPE_MA,
    TYPE_NONTHERMAL_PREDEPOSIT_ALPHA, TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS,
    TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS, TYPE_NTALPHA_DEPOSITED,
    TYPE_NTLEPTON_DEPOSITED, TYPE_PRE_KPKT, TYPE_RADIOACTIVE_PELLET, TYPE_RPKT,
    PacketState,
)
from ..plasma.radfield import sample_planck_montecarlo
from . import rpkt_kernel
from . import vpkt as vpkt_mod


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Per-timestep data prepared by the driver before transport. The XCOM
    tables (float64, each element's rows padded to the longest, with
    ``xcom_nrows`` its own row count) and the vpkt tables hold (1,)-sized
    placeholders when their mode is off, and so do the expansion-opacity
    tables when that mode is off,
    ``jblue_of_line`` (line -> J_b_lu column, -1 none) without the detailed
    line estimators and the ``nt_*`` fractions of the Spencer-Fano
    deposition split without the non-thermal solver."""

    levelpops: torch.Tensor
    nnion: torch.Tensor
    chi_ff_nnionpart: torch.Tensor
    tau_sob_factor: torch.Tensor  # (ncells, nlines)
    bf_a: torch.Tensor
    bf_dep: torch.Tensor  # LOG departure
    expopac_kappa: torch.Tensor  # (ncells, NBINS) expansion opacities [cm^2/g]
    expopac_planck_cum: torch.Tensor  # (ncells, NBINS) Planck x kappa cumulative
    expopac_wcum: torch.Tensor  # (ncells, nlines) cumulative bb-line weights
    expopac_binoffsets: torch.Tensor  # (NBINS+1,) line segment offsets per bin
    elem_numberdens: torch.Tensor
    xcom_energy: torch.Tensor
    xcom_sigma: torch.Tensor
    vpkt_cum_tau: torch.Tensor
    vpkt_cum_taunu: torch.Tensor
    vpkt_cfg: object
    nt_frac_ion_by_ion: torch.Tensor
    nt_frac_ionization: torch.Tensor
    nt_ionenfrac_auger: torch.Tensor
    nt_frac_excitation: torch.Tensor
    nt_exc_fracdep_cum: torch.Tensor
    nt_exc_upper: torch.Tensor
    jblue_of_line: torch.Tensor
    gammaline_energy: torch.Tensor  # (nnuc, maxlines) [erg]
    gammaline_cumfrac: torch.Tensor
    gammaline_nlines: torch.Tensor
    nuc_engamma: torch.Tensor
    barnes_t_ineff: torch.Tensor  # scalar [s] (Barnes gamma thermalisation)
    barnes_tau_ineff_lepton: torch.Tensor  # scalar [s] (Barnes particle scheme)
    barnes_tau_ineff_alpha: torch.Tensor  # scalar [s]
    rho_t_mgi: torch.Tensor  # (npts_model+1,) density at t_mid (Wollaeger)
    rho_tmin_mgi: torch.Tensor  # (npts_model+1,) density at tmin (Guttman)
    tmin: float
    ts: float  # timestep start [s]
    t2: float  # timestep end [s]
    t_mid: float
    is_first_timestep: bool
    nt_ion_topion: torch.Tensor | None = None  # (nions,) top ion of each ion's element
    xcom_nrows: torch.Tensor | None = None  # (nelements,) rows of each XCOM table


def check_supported(opts: Options, opacity_case: int | None = None) -> None:
    """Raise NotImplementedError naming the first option off the ported
    slice: transport on a SPHERICAL1D, CYLINDRICAL2D or CARTESIAN3D grid
    (every preset), in every grey opacity case (``opacity_case`` 0-6: below
    4 the continuum is free-free only), with the run diagnostics
    (``record_linestat``, ``track_ion_stats``, ``log_macroatom``), optionally with
    NLTE populations, the non-thermal solver (``nt_on``: the Spencer-Fano
    solve with ``nt_solve_spencerfano``, else the work-function
    approximation), the multibin radiation field, virtual packets
    (``vpkt_on``), XCOM gamma photoionisation, the
    detailed bf-rate and J_b_lu line estimators, LUT-off photoionisation
    and bf heating, binned expansion opacities, dipole / polarised electron
    scattering (``dipole``, ``pol_on``) and rate-balance ionisation
    (``force_saha_ion_balance=False``); particles thermalise by the INSTANT,
    DETAILED, BARNES or WOLLAEGER scheme, gammas by detailed transport or
    the BARNES, WOLLAEGER or GUTTMAN scheme."""
    off = [
        ("grid_type", opts.grid_type not in (GridType.SPHERICAL1D, GridType.CYLINDRICAL2D,
                                             GridType.CARTESIAN3D)),
        # the JAX package has no GUTTMAN particle scheme either
        ("particle_thermalisation_scheme=GUTTMAN",
         opts.particle_thermalisation_scheme == ThermalisationScheme.GUTTMAN),
    ]
    for name, bad in off:
        if bad:
            raise NotImplementedError(f"option {name} is not ported")


def want_bfrate(opts: Options, dad: DeviceAtomicData) -> bool:
    """Whether the crossing accumulates the detailed bf-rate estimators."""
    return bool(opts.detailed_bf_estimators_on and dad.nbfcontinua > 0)


def crossing_estimators(opts: Options, est: Estimators) -> dict:
    """The estimator keywords of ``rpkt_kernel.propagate`` for a run: the
    multibin bins (K5-multibin), the J_b_lu columns (K5-jblue; not in
    expansion-opacity mode, which has no line walk) and the LUT gamma /
    bf-heating estimators, off under LUT-off photoionisation / bf heating
    (the JAX package's want_gamma / want_bfheat)."""
    return dict(nradbins=opts.radfieldbincount if opts.multibin_radfield else 0,
                njblue=(est.jblue_raw.shape[1] if opts.detailed_line_estimators_on
                        and not opts.expansionopacities_on else 0),
                want_gamma=opts.use_lut_photoion, want_bfheat=opts.use_lut_bfheating)


def check_crossing_dtype(opts: Options) -> None:
    """The crossing kernel and its plain version run in float32 (the Pallas
    kernel's precision) and float64 (the XLA path's, the default); any other
    transport dtype raises. Setup and the grid update run in float64 either
    way."""
    if opts.transport_dtype not in ("float32", "float64"):
        raise NotImplementedError(
            f"option transport_dtype={opts.transport_dtype!r} is not ported for the "
            "r-packet crossing (float32 or float64 only)")


def _uniform(key, tag: int, n: int, like):
    return rng.uniform(key, tag, n, like.dtype, like.device)


def _isotropic(key, tag: int, n: int, like):
    return rng.isotropic(key, tag, n, like.dtype, like.device)


def _w(mask, a, b):
    """torch.where with a Python-scalar or tensor ``a``."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    return torch.where(mask, a, b)


def _w3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _stokes_reset(st):
    s = torch.zeros_like(st.stokes)
    s[:, 0] = 1.0
    return s


def emit_rpkt_batch(key, tag, st: PacketState, mask, opts: Options) -> PacketState:
    """Isotropic cmf re-emission (reference: rpkt.cc:945-970)."""
    n = st.npkts
    dir_cmf = _isotropic(key, tag, n, st.pos)
    vel_rev = st.pos / (-st.prop_time)[:, None]
    new_dir = geometry.angle_ab(dir_cmf, vel_rev)
    doppler = geometry.doppler_nucmf_on_nurf(st.pos, new_dir, st.prop_time,
                                             opts.use_relativistic_doppler_shift)
    return st.replace(
        ptype=_w(mask, TYPE_RPKT, st.ptype), dir=_w3(mask, new_dir, st.dir),
        nu_rf=_w(mask, st.nu_cmf / doppler, st.nu_rf),
        e_rf=_w(mask, st.e_cmf / doppler, st.e_rf),
        stokes=_w3(mask, _stokes_reset(st), st.stokes))


DIPOLE_TRIALS = 48  # rejection-sampling trials of the dipole phase function


def electron_scatter_lanes(pos, dir_rf, prop_time, stokes, u0, u_trials, dipole: bool,
                           relativistic: bool):
    """Thomson scattering of k lanes with optional dipole angular sampling
    and Stokes transport (reference: rpkt.cc:292-409): the rest-frame to
    comoving transform, the scattering angles drawn in the comoving frame,
    the rotation of the old direction by them, the rotation of Q, U into the
    scattering plane (i1), the Rayleigh matrix, the rotation back to the new
    direction's meridian frame (i2) and the transform back to the rest
    frame. u0 (2, k) are the isotropic (cos theta, phi) uniforms;
    u_trials (DIPOLE_TRIALS, 3, k) the dipole trials (cos theta, phi,
    acceptance), unused when ``dipole`` is off. Returns (new rest-frame
    direction, its Doppler factor nu_cmf/nu_rf, Q, U)."""
    vel = pos / prop_time[:, None]
    old_dir_cmf, qi, ui = geometry.frame_transform(dir_rf, stokes[:, 1], stokes[:, 2], vel)
    m_ang = 2.0 * u0[0] - 1.0
    phisc = 2.0 * PI * u0[1]
    if dipole:
        # rejection sampling of p(mu, phi) = (mu^2+1) + (mu^2-1)(Q cos2phi +
        # U sin2phi), max 2 (Code & Whitney 1995): the first accepted trial
        # wins; the mean acceptance is 2/3, so a lane that accepts none of
        # the 48 (< 1e-8 of them) keeps its u0 draw, as in the JAX package
        m_try = 2.0 * u_trials[:, 0] - 1.0
        mu2 = m_try * m_try
        ph_try = 2.0 * PI * u_trials[:, 1]
        p = (mu2 + 1.0) + (mu2 - 1.0) * (torch.cos(2.0 * ph_try) * qi + torch.sin(2.0 * ph_try) * ui)
        acc = 2.0 * u_trials[:, 2] <= p
        first = torch.argmax(acc.to(torch.int8), dim=0)[None]
        any_acc = acc.any(dim=0)
        m_ang = torch.where(any_acc, m_try.gather(0, first)[0], m_ang)
        phisc = torch.where(any_acc, ph_try.gather(0, first)[0], phisc)

    # rotate old_dir_cmf by (theta_sc, phi_sc) (rpkt.cc:343-357)
    cos_t = m_ang
    sin_t = torch.sqrt(torch.clamp(1.0 - m_ang * m_ang, min=0.0))
    odx, ody, odz = old_dir_cmf[:, 0], old_dir_cmf[:, 1], old_dir_cmf[:, 2]
    general = torch.abs(odz) < 0.99999
    root = torch.sqrt(torch.clamp(1.0 - odz * odz, min=1e-30))
    cphi, sphi = torch.cos(phisc), torch.sin(phisc)
    gdir = torch.stack([sin_t / root * (ody * sphi - odx * odz * cphi) + odx * cos_t,
                        sin_t / root * (-odx * sphi - ody * odz * cphi) + ody * cos_t,
                        sin_t * cphi * root + odz * cos_t], dim=-1)
    pdir = torch.stack([sin_t * cphi, sin_t * sphi, torch.where(odz > 0, cos_t, -cos_t)], dim=-1)
    new_dir_cmf = _w3(general, gdir, pdir)

    # rotate Stokes into the scattering plane (angle i1, Bulla+2015)
    ref1_o, ref2_o = geometry.meridian(old_dir_cmf)
    i1 = geometry.get_rot_angle(old_dir_cmf, new_dir_cmf, ref1_o, ref2_o)
    cos2i1, sin2i1 = torch.cos(2.0 * i1), torch.sin(2.0 * i1)
    q_old = qi * cos2i1 - ui * sin2i1
    u_old = qi * sin2i1 + ui * cos2i1
    # Rayleigh scattering matrix
    mu = geometry.dot(old_dir_cmf, new_dir_cmf)
    i_new = 0.75 * ((mu * mu + 1.0) + q_old * (mu * mu - 1.0))
    q_new = 0.75 * ((mu * mu - 1.0) + q_old * (mu * mu + 1.0)) / i_new
    u_new = 1.5 * mu * u_old / i_new
    # rotate back to the meridian frame of the new direction (angle i2)
    ref1_n, ref2_n = geometry.meridian(new_dir_cmf)
    i2 = PI + geometry.get_rot_angle(new_dir_cmf, old_dir_cmf, ref1_n, ref2_n)
    cos2i2, sin2i2 = torch.cos(2.0 * i2), torch.sin(2.0 * i2)
    q_f = q_new * cos2i2 + u_new * sin2i2
    u_f = -q_new * sin2i2 + u_new * cos2i2

    new_dir_rf, q_f, u_f = geometry.frame_transform(new_dir_cmf, q_f, u_f, -vel)
    # a direction on the polar axis or a zero scattering plane makes the
    # rotation angles NaN: such a packet leaves unpolarised (engine.py:232-236
    # of the JAX package); the direction never depends on those angles
    bad = ~(torch.isfinite(q_f) & torch.isfinite(u_f))
    q_f = torch.where(bad, torch.zeros_like(q_f), q_f)
    u_f = torch.where(bad, torch.zeros_like(u_f), u_f)
    doppler = geometry.doppler_nucmf_on_nurf(pos, new_dir_rf, prop_time, relativistic)
    return new_dir_rf, doppler, q_f, u_f


def electron_scatter_batch(key, tag, st: PacketState, mask, opts: Options) -> PacketState:
    """Thomson scattering with optional dipole angular sampling and full
    Stokes-vector transport (reference: rpkt.cc:292-409
    electron_scatter_rpkt) for the lanes of ``mask``: they are gathered
    (``nonzero`` / index), scattered by ``electron_scatter_lanes`` and
    written back, so the draws cover only the scattering lanes."""
    idx = torch.nonzero(mask)[:, 0]
    k = idx.numel()
    if k == 0:
        return st
    dev, dt = st.pos.device, st.pos.dtype
    kk = rng.fold_in(key, tag)
    u0 = rng.uniform(kk, 0, (2, k), dt, dev)
    u_trials = rng.uniform(kk, 1, (DIPOLE_TRIALS, 3, k), dt, dev) if opts.dipole else None
    new_dir, doppler, q_f, u_f = electron_scatter_lanes(
        st.pos[idx], st.dir[idx], st.prop_time[idx], st.stokes[idx], u0, u_trials,
        opts.dipole, opts.use_relativistic_doppler_shift)

    def put(full, part):
        r = full.clone()
        r[idx] = part.to(full.dtype)
        return r

    stokes = torch.stack([torch.ones_like(q_f), q_f, u_f], dim=-1)
    return st.replace(ptype=put(st.ptype, torch.full_like(st.ptype[idx], TYPE_RPKT)),
                      dir=put(st.dir, new_dir), nu_rf=put(st.nu_rf, st.nu_cmf[idx] / doppler),
                      e_rf=put(st.e_rf, st.e_cmf[idx] / doppler),
                      stokes=put(st.stokes, stokes))


# ---------------------------------------------------------------------------
# pellets (reference: update_packets.cc:149-211 update_pellet)
# ---------------------------------------------------------------------------


def pellet_step(key, st: PacketState, est: Estimators, ctx: StepContext, opts: Options):
    n = st.npkts
    is_pellet = (st.ptype == TYPE_RADIOACTIVE_PELLET) & (st.prop_time < ctx.t2)
    ts = st.prop_time
    tdecay = st.tdecay
    no_decay = is_pellet & (tdecay > ctx.t2)
    decays_now = is_pellet & (tdecay <= ctx.t2) & (tdecay > ts)
    early_decay = is_pellet & (tdecay <= ts) & (tdecay > 0) & bool(ctx.is_first_timestep)
    one = torch.ones_like(ts)
    scale = _w(no_decay, ctx.t2 / ts, one) * _w(decays_now, tdecay / ts, one)
    pos = st.pos * scale[:, None]
    prop_time = _w(no_decay, ctx.t2, _w(decays_now, tdecay, st.prop_time))
    est = est.replace(pellet_decays=est.pellet_decays + decays_now.sum())

    to_particle = decays_now & st.originated_from_particlenotgamma
    dt = st.pellet_decaytype
    newtype = st.ptype
    newtype = _w(to_particle & (dt == DECAYTYPE_BETAPLUS), TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS, newtype)
    newtype = _w(to_particle & (dt == DECAYTYPE_BETAMINUS), TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS, newtype)
    newtype = _w(to_particle & (dt == DECAYTYPE_ALPHA), TYPE_NONTHERMAL_PREDEPOSIT_ALPHA, newtype)
    z = torch.zeros_like(st.e_cmf)
    est = est.replace(
        positron_emission=est.positron_emission
        + _w(to_particle & (dt == DECAYTYPE_BETAPLUS), st.e_cmf, z).sum(),
        electron_emission=est.electron_emission
        + _w(to_particle & (dt == DECAYTYPE_BETAMINUS), st.e_cmf, z).sum(),
        alpha_emission=est.alpha_emission
        + _w(to_particle & (dt == DECAYTYPE_ALPHA), st.e_cmf, z).sum())
    em_time = _w(to_particle, prop_time, st.em_time)
    absorptiontype = _w(to_particle, -10, st.absorptiontype)

    to_gamma = decays_now & ~st.originated_from_particlenotgamma
    nuc = torch.clamp(st.pellet_nucindex, 0, ctx.gammaline_nlines.shape[0] - 1)
    has_spec = ctx.gammaline_nlines[nuc] > 0
    to_kpkt_nospec = to_gamma & ~has_spec
    newtype = _w(to_kpkt_nospec, TYPE_KPKT, newtype)
    absorptiontype = _w(to_kpkt_nospec, -6, absorptiontype)
    to_gamma = to_gamma & has_spec
    dir_cmf = _isotropic(key, 11, n, st.pos)
    vel_rev = pos / (-_w(tdecay > 0, tdecay, one))[:, None]
    gdir = geometry.angle_ab(dir_cmf, vel_rev)
    zrand = _uniform(key, 12, n, st.pos)
    cumrows = ctx.gammaline_cumfrac[nuc]
    lineidx = (zrand[:, None] > cumrows).sum(dim=1)
    lineidx = torch.clamp(lineidx, 0, ctx.gammaline_energy.shape[1] - 1)
    nu_gamma = ctx.gammaline_energy[nuc, lineidx] / H
    doppler = geometry.doppler_nucmf_on_nurf(pos, gdir, torch.clamp(prop_time, min=1e-30),
                                             opts.use_relativistic_doppler_shift)
    est = est.replace(gamma_emission=est.gamma_emission
                      + _w(decays_now & ~st.originated_from_particlenotgamma, st.e_cmf, z).sum())
    newtype = _w(to_gamma, TYPE_GAMMA, newtype)

    # pellets that decayed before tmin: Lucy 2004 pre-kpkts (update_packets.cc:192-204)
    e_cmf = _w(early_decay, st.e_cmf * tdecay / prop_time, st.e_cmf)
    newtype = _w(early_decay, TYPE_PRE_KPKT, newtype)
    absorptiontype = _w(early_decay, -7, absorptiontype)
    return st.replace(
        ptype=newtype, pos=pos, prop_time=prop_time, e_cmf=e_cmf, em_time=em_time,
        absorptiontype=absorptiontype, dir=_w3(to_gamma, gdir, st.dir),
        nu_cmf=_w(to_gamma, nu_gamma, st.nu_cmf),
        nu_rf=_w(to_gamma, nu_gamma / doppler, st.nu_rf),
        e_rf=_w(to_gamma, e_cmf / doppler, st.e_rf),
        stokes=_w3(to_gamma, _stokes_reset(st), st.stokes)), est


# ---------------------------------------------------------------------------
# non-thermal particle predeposit (reference: update_packets.cc:30-143)
# ---------------------------------------------------------------------------


def nonthermal_predeposit_step(key, st: PacketState, est: Estimators, ctx: StepContext,
                               grid: GridData, cells_rho, opts: Options):
    """Particle thermalisation of the non-thermal predeposit packets, by the
    scheme of ``particle_thermalisation_scheme`` (update_packets.cc:30-143):
    INSTANT deposits at once; DETAILED (Shingles+2023) deposits along the
    particle's energy-loss track; BARNES and WOLLAEGER absorb with an
    analytic probability and let the rest escape."""
    scheme = opts.particle_thermalisation_scheme
    n = st.npkts
    is_beta_minus = st.ptype == TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS
    is_beta_plus = st.ptype == TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS
    is_alpha = st.ptype == TYPE_NONTHERMAL_PREDEPOSIT_ALPHA
    mask = (is_beta_minus | is_beta_plus | is_alpha) & (st.prop_time < ctx.t2)
    deposit_type = _w(is_alpha, TYPE_NTALPHA_DEPOSITED,
                      torch.full_like(st.ptype, TYPE_NTLEPTON_DEPOSITED))
    nonemptymgi = grid.nonemptymgi_of_cell[st.where]
    nonempty = nonemptymgi >= 0
    safe_mgi = torch.clamp(nonemptymgi, min=0)
    ts = st.prop_time
    z = torch.zeros_like(ts)
    newpos, newtime, new_nucmf = st.pos, st.prop_time, st.nu_cmf
    if scheme == ThermalisationScheme.INSTANT:
        en_deposited = _w(mask, st.e_cmf, z)
        newtype = _w(mask, deposit_type, st.ptype)
        deposited_now = mask
    elif scheme in (ThermalisationScheme.DETAILED,
                    ThermalisationScheme.DETAILEDWITHGAMMAPRODUCTS):
        # Shingles+2023 local deposition (update_packets.cc:75-113)
        rho = _w(nonempty, cells_rho.to(ts.dtype)[safe_mgi], z)
        endot = torch.where(is_alpha, 5.0e11 * MEV * rho, 4.0e10 * MEV * rho)
        endot = torch.clamp(endot, min=1e-300)
        particle_en = H * st.nu_cmf
        t_enzero = ts + particle_en / endot
        en_deposited = _w(mask, st.e_cmf * (torch.clamp(t_enzero, max=ctx.t2) - ts)
                          / (particle_en / endot), z)
        rnd_en_absorb = _uniform(key, 21, n, st.pos) * particle_en
        t_absorb = ts + rnd_en_absorb / endot
        t_new = torch.clamp(t_absorb, max=ctx.t2)
        absorbed = mask & (t_absorb <= ctx.t2)
        newtype = _w(absorbed, deposit_type, st.ptype)
        new_nucmf = _w(mask & ~absorbed, (particle_en - endot * (t_new - ts)) / H, st.nu_cmf)
        newpos = _w3(mask, st.pos * (t_new / ts)[:, None], st.pos)
        newtime = _w(mask, t_new, st.prop_time)
        deposited_now = absorbed
    elif scheme in (ThermalisationScheme.BARNES, ThermalisationScheme.WOLLAEGER):
        if scheme == ThermalisationScheme.BARNES:
            # Barnes et al. 2016 (update_packets.cc:42-57)
            tau_ineff = torch.where(is_alpha, ctx.barnes_tau_ineff_alpha.to(ts.dtype),
                                    ctx.barnes_tau_ineff_lepton.to(ts.dtype))
            x = 2.0 * ts * ts / torch.clamp(tau_ineff * tau_ineff, min=1e-300)
        else:
            # Wollaeger+2018 local thermalisation (update_packets.cc:59-75)
            rho = _w(nonempty, cells_rho.to(ts.dtype)[safe_mgi], torch.full_like(ts, 1e-300))
            a_const = _w(is_alpha, 1.2e-11, torch.full_like(ts, 1.3e-11))
            x = 2.0 * a_const / torch.clamp(ts * rho, min=1e-300)
        f_p = torch.log1p(x) / torch.clamp(x, min=1e-300)
        absorbed = mask & (_uniform(key, 22, n, st.pos) < f_p)
        en_deposited = _w(absorbed, st.e_cmf, z)
        newtype = _w(absorbed, deposit_type, _w(mask, TYPE_ESCAPE, st.ptype))
        deposited_now = absorbed
    else:
        raise NotImplementedError(f"particle thermalisation scheme {scheme}")
    frompart = st.originated_from_particlenotgamma
    est = est.replace(
        dep_electron=cell_add(est.dep_electron, nonemptymgi, en_deposited, mask & is_beta_minus & frompart),
        dep_positron=cell_add(est.dep_positron, nonemptymgi, en_deposited, mask & is_beta_plus & frompart),
        dep_alpha=cell_add(est.dep_alpha, nonemptymgi, en_deposited, mask & is_alpha & frompart),
        electron_dep_discrete=est.electron_dep_discrete
        + _w(deposited_now & is_beta_minus & frompart, st.e_cmf, z).sum(),
        positron_dep_discrete=est.positron_dep_discrete
        + _w(deposited_now & is_beta_plus & frompart, st.e_cmf, z).sum(),
        alpha_dep_discrete=est.alpha_dep_discrete
        + _w(deposited_now & is_alpha & frompart, st.e_cmf, z).sum())
    return st.replace(ptype=newtype, pos=newpos, prop_time=newtime, nu_cmf=new_nucmf), est


# ---------------------------------------------------------------------------
# k-packets (grey / blackbody path) (reference: kpkt.cc:377-402)
# ---------------------------------------------------------------------------


def kpkt_blackbody_step(key, st: PacketState, ctx: StepContext, grid: GridData,
                        cells_te, cells_thick, opts: Options):
    """Emit k-packets in thick cells (and pre-kpkts) as blackbody r-packets
    (reference: kpkt.cc:377-402, update_packets.cc:253-268)."""
    nonemptymgi = grid.nonemptymgi_of_cell[st.where]
    safe_mgi = torch.clamp(nonemptymgi, min=0)
    te = cells_te.to(st.pos.dtype)[safe_mgi]
    thick = (nonemptymgi >= 0) & (cells_thick[safe_mgi] == 1)
    mask = (st.ptype == TYPE_PRE_KPKT) | ((st.ptype == TYPE_KPKT) & thick)
    mask = mask & (st.prop_time < ctx.t2) & (nonemptymgi >= 0)
    if not bool(mask.any()):
        return st, mask
    idx = torch.nonzero(mask)[:, 0]
    nu_sel = sample_planck_montecarlo(rng.fold_in(key, 31), torch.clamp(te[idx], min=1.0),
                                      opts.nu_min_r, opts.nu_max_r)
    nu_planck = st.nu_cmf.clone()
    nu_planck[idx] = nu_sel
    st = st.replace(nu_cmf=nu_planck)
    st = emit_rpkt_batch(key, 32, st, mask, opts)
    return st.replace(
        next_trans=_w(mask, -1, st.next_trans),
        emissiontype=_w(mask, EMTYPE_FREEFREE, st.emissiontype),
        em_pos=_w3(mask, st.pos, st.em_pos), em_time=_w(mask, st.prop_time, st.em_time),
        nscatterings=_w(mask, 0, st.nscatterings),
        trueemissiontype=_w(mask, EMTYPE_FREEFREE, st.trueemissiontype),
        trueem_time=_w(mask, st.prop_time, st.trueem_time),
        trueemissionvelocity=_w(mask, geometry.vec_len(st.pos) / st.prop_time,
                                st.trueemissionvelocity)), mask


# ---------------------------------------------------------------------------
# gamma transport (reference: gammapkt.cc:719-817)
# ---------------------------------------------------------------------------


def _sigma_compton_partial(x, f):
    """(reference: gammapkt.cc:258-268)"""
    term1 = (x * x - 2 * x - 2) * torch.log(f) / x / x
    term2 = ((f * f - 1) / (f * f)) / 2
    term3 = ((f - 1) / x) * ((1 / x) + (2 / f) + (1 / (x * f)))
    return 3 * SIGMA_T * (term1 + term2 + term3) / (8 * x)


def _choose_f(xx, zrand):
    """Bisect sigma_compton_partial(x, f) = zrand*sigma(x, fmax)
    (reference: gammapkt.cc:296-327)."""
    f_max = 1.0 + 2.0 * xx
    f_min = torch.ones_like(xx)
    norm = zrand * _sigma_compton_partial(xx, f_max)
    for _ in range(60):
        ftry = 0.5 * (f_min + f_max)
        high = _sigma_compton_partial(xx, ftry) > norm
        f_min, f_max = torch.where(high, f_min, ftry), torch.where(high, ftry, f_max)
    return 0.5 * (f_min + f_max)


def _thomson_angle(u):
    """(reference: gammapkt.cc:330-340)"""
    b = 8.0 * u - 4.0
    x = (torch.sqrt(b * b + 4.0) - b) / 2.0
    t = torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
    return 1.0 / t - t


def _scatter_dir(key, tag, dir_in, cos_theta):
    """Rotate dir_in by the scattering angle (reference: gammapkt.cc:343-378)."""
    n = dir_in.shape[0]
    phi = _uniform(key, tag, n, dir_in) * 2.0 * PI
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta**2, min=0.0))
    xprime = sin_theta * torch.cos(phi)
    yprime = sin_theta * torch.sin(phi)
    zprime = cos_theta
    xylen = torch.sqrt(dir_in[:, 0] ** 2 + dir_in[:, 1] ** 2)
    norm1 = 1.0 / torch.clamp(xylen, min=1e-300)
    norm2 = 1.0 / geometry.vec_len(dir_in)
    r11 = dir_in[:, 1] * norm1
    r12 = -dir_in[:, 0] * norm1
    r21 = dir_in[:, 0] * dir_in[:, 2] * norm1 * norm2
    r22 = dir_in[:, 1] * dir_in[:, 2] * norm1 * norm2
    r23 = -norm2 / norm1
    r31 = dir_in[:, 0] * norm2
    r32 = dir_in[:, 1] * norm2
    r33 = dir_in[:, 2] * norm2
    out = torch.stack([r11 * xprime + r21 * yprime + r31 * zprime,
                       r12 * xprime + r22 * yprime + r32 * zprime,
                       r23 * yprime + r33 * zprime], dim=-1)
    polar = xylen < 1e-12
    sgn = torch.where(dir_in[:, 2] >= 0, 1.0, -1.0).to(dir_in.dtype)
    fallback = torch.stack([xprime, yprime, sgn * zprime], dim=-1)
    return _w3(polar, fallback, out)


def _meanf_sigma(x):
    """(reference: gammapkt.cc:625-637)"""
    f = 1 + 2 * x
    term0 = 2 / x
    term1 = (1 - 2 / x - 3 / (x * x)) * torch.log(f)
    term2 = (4 / x + 3 / (x * x) - 1) * 2 * x / f
    term3 = (1 - 2 / x - 1 / (x * x)) * 2 * x * (1 + x) / f / f
    term4 = -2.0 * x * (4 * x * x + 6 * x + 3) / 3 / f / f / f
    return 3 * SIGMA_T * (term0 + term1 + term2 + term3 + term4) / (8 * x)


def gamma_analytic_step(key, st: PacketState, est: Estimators, ctx: StepContext,
                        grid: GridData, opts: Options):
    """Analytic thermalisation: each gamma packet is absorbed (to a k-packet)
    with the scheme's efficiency or escapes (reference: gammapkt.cc:819-971
    barnes / wollaeger / guttman)."""
    from . import thermalisation as th

    mask = (st.ptype == TYPE_GAMMA) & (st.prop_time < ctx.t2)
    scheme = opts.gamma_thermalisation_scheme
    dt = st.pos.dtype
    if scheme == ThermalisationScheme.BARNES:
        f = th.barnes_f_gamma(torch.clamp(st.prop_time, min=1.0), ctx.barnes_t_ineff.to(dt))
    elif scheme == ThermalisationScheme.WOLLAEGER:
        f = th.wollaeger_f_gamma(grid, st.pos, st.prop_time, st.where, ctx.rho_t_mgi.to(dt))
    else:  # GUTTMAN: the directions of the gamma packets only
        idx = torch.nonzero(mask)[:, 0]
        f = torch.zeros_like(st.prop_time)
        if idx.numel():
            kd = rng.fold_in(key, 61)
            dirs = torch.stack([_isotropic(kd, i, st.npkts, st.pos)[idx]
                                for i in range(th.GUTTMAN_NDIRS)])
            f[idx] = th.guttman_f_gamma(dirs, grid, st.pos[idx], st.prop_time[idx],
                                        st.where[idx], ctx.rho_tmin_mgi.to(dt), ctx.tmin)
    absorbed = mask & (_uniform(key, 62, st.npkts, st.pos) < f)
    escaping = mask & ~absorbed
    nonemptymgi = grid.nonemptymgi_of_cell[st.where]
    est = est.replace(
        dep_gamma=cell_add(est.dep_gamma, nonemptymgi, st.e_cmf, absorbed & (nonemptymgi >= 0)),
        nesc=est.nesc + escaping.sum().to(est.nesc.dtype))
    st = st.replace(
        ptype=_w(absorbed, TYPE_KPKT, _w(escaping, TYPE_ESCAPE, st.ptype)),
        absorptiontype=_w(absorbed, -4, st.absorptiontype),
        escape_type=_w(escaping, TYPE_GAMMA, st.escape_type),
        escape_time=_w(escaping, st.prop_time, st.escape_time))
    return st, est


def xcom_photoion_chi(energy, sigma, nrows, numberdens, nu_cmf):
    """(n,) XCOM photoelectric opacity [1/cm], float64 (reference:
    gammapkt.cc:499-545; artis_tpu/transport/engine.py:631-660): per element
    the cross-section interpolated log-log in its own table and clamped to
    the table's first and last rows outside it, times the element's number
    density (numberdens (n, nelements) [/cm3]). ``energy`` / ``sigma``
    (nelements, L >= 2) [MeV] / [barn] hold each element's ``nrows`` rows
    and padding after them; an element without rows adds nothing. The JAX
    package interpolates into the padding above a short table's last row,
    which is NaN in float32 (ROADMAP Queue 3)."""
    f64 = torch.float64
    e = nu_cmf.to(f64) / 2.41326e20
    idx = torch.searchsorted(energy, e[None, :].expand(energy.shape[0], -1).contiguous())
    nr = nrows.to(idx.dtype)[:, None]
    last = torch.clamp(nr - 1, min=0)
    hi = torch.minimum(torch.clamp(idx, min=1), torch.clamp(last, min=1))
    lo = hi - 1
    loge_tab, logsig_tab = torch.log10(energy), torch.log10(sigma)
    x0, x1 = loge_tab.gather(1, lo), loge_tab.gather(1, hi)
    y0, y1 = logsig_tab.gather(1, lo), logsig_tab.gather(1, hi)
    loge = torch.log10(torch.clamp(e, min=1e-30))[None, :]
    logsig = y0 + (y1 - y0) / torch.clamp(x1 - x0, min=1e-30) * (loge - x0)
    logsig = torch.where(idx <= 0, logsig_tab[:, :1], logsig)
    logsig = torch.where(idx >= nr, logsig_tab.gather(1, last.expand(-1, e.shape[0])), logsig)
    sig = torch.where(nr > 0, 10.0 ** logsig * 1e-24, torch.zeros_like(logsig))
    return (sig.T * numberdens.to(f64)).sum(dim=1)


def gamma_step(key, st: PacketState, est: Estimators, ctx: StepContext, grid: GridData,
               cells_rho, cells_nnetot, cells_ffegrp, gamma_kappagrey: float, opts: Options):
    """One flight step of all gamma packets (reference: gammapkt.cc:719-817),
    or the analytic absorb-or-escape of the BARNES, WOLLAEGER and GUTTMAN
    schemes (``gamma_analytic_step``)."""
    if opts.gamma_thermalisation_scheme in (ThermalisationScheme.BARNES,
                                            ThermalisationScheme.WOLLAEGER,
                                            ThermalisationScheme.GUTTMAN):
        return gamma_analytic_step(key, st, est, ctx, grid, opts)
    n = st.npkts
    dt = st.pos.dtype
    rel = opts.use_relativistic_doppler_shift
    mask = (st.ptype == TYPE_GAMMA) & (st.prop_time < ctx.t2)
    nonemptymgi = grid.nonemptymgi_of_cell[st.where]
    nonempty = nonemptymgi >= 0
    safe_mgi = torch.clamp(nonemptymgi, min=0)
    z = torch.zeros_like(st.prop_time)
    rho = _w(nonempty, cells_rho.to(dt)[safe_mgi], z)
    nnetot = _w(nonempty, cells_nnetot.to(dt)[safe_mgi], z)
    ffegrp = _w(nonempty, cells_ffegrp.to(dt)[safe_mgi], z)
    doppler = geometry.doppler_nucmf_on_nurf(st.pos, st.dir, st.prop_time, rel)
    xx = H * st.nu_cmf / ME_C2
    detailed = gamma_kappagrey < 0
    if detailed:
        sigma_c = _w(xx < THOMSON_LIMIT, SIGMA_T,
                     _sigma_compton_partial(torch.clamp(xx, min=1e-10), 1 + 2 * xx))
        chi_compton = sigma_c * nnetot * doppler
        if opts.use_xcom_gammaphotoion:
            chi_pe_cmf = _w(nonempty, xcom_photoion_chi(
                ctx.xcom_energy, ctx.xcom_sigma, ctx.xcom_nrows, ctx.elem_numberdens[safe_mgi],
                st.nu_cmf).to(dt), z)
        else:
            hnu_over_100kev = st.nu_cmf / 2.41326e19
            sigma_si = 1.16e-24 * hnu_over_100kev**-3.13
            sigma_fe = 25.7e-24 * hnu_over_100kev**-3.0
            chi_pe_cmf = (sigma_fe * (rho / (56 * 1.67352e-24)) * ffegrp
                          + sigma_si * (rho / (28 * 1.67352e-24)) * (1.0 - ffegrp))
        chi_pe = chi_pe_cmf * doppler
        hnu_over_mev = st.nu_cmf / 2.41326e20
        above_thresh = st.nu_cmf > 2.46636e20
        high = st.nu_cmf > 3.6199e20
        sigma_pair_si = torch.where(high, (0.0481 + 0.301 * (hnu_over_mev - 1.5)) * 196e-27,
                                    1.0063 * (hnu_over_mev - 1.022) * 196e-27)
        sigma_pair_fe = torch.where(high, (0.0481 + 0.301 * (hnu_over_mev - 1.5)) * 784e-27,
                                    1.0063 * (hnu_over_mev - 1.022) * 784e-27)
        chi_pp_cmf = (sigma_pair_fe * (rho / (56 * 1.67352e-24)) * ffegrp
                      + sigma_pair_si * (rho / (28 * 1.67352e-24)) * (1.0 - ffegrp))
        chi_pp = _w(above_thresh, torch.clamp(chi_pp_cmf * doppler, min=0.0), z)
    else:
        chi_compton = z
        chi_pe = gamma_kappagrey * rho * doppler
        chi_pp = z
    chi_tot = chi_compton + chi_pe + chi_pp

    tau_next = -torch.log(torch.clamp(_uniform(key, 41, n, st.pos), min=1e-300))
    sdist, snext = boundary_distance(grid, st.dir, st.pos, st.prop_time, st.where)
    tdist = torch.clamp((ctx.t2 - st.prop_time) * CLIGHT_PROP, min=0.0)
    edist = _w(chi_tot > 0, tau_next / torch.clamp(chi_tot, min=1e-300), torch.full_like(z, torch.inf))
    dist = torch.minimum(torch.minimum(sdist, tdist), edist)
    take_boundary = mask & (sdist <= tdist) & (sdist <= edist)
    take_tlimit = mask & (tdist < sdist) & (tdist < edist)
    take_event = mask & (edist < sdist) & (edist < tdist)

    # two half-moves, path-based deposition at the midpoint (gammapkt.cc:640-667)
    pos1, t1, nucmf1, _, _ = geometry.move_pkt(st.pos, st.dir, st.prop_time, st.nu_rf,
                                               st.nu_cmf, st.e_rf, dist / 2.0, rel)
    dop_sq = geometry.doppler_squared_nucmf_on_nurf(pos1, st.dir, t1, rel)
    xx_mid = torch.clamp(H * nucmf1 / ME_C2, min=1e-10)
    if detailed:
        heating = (_meanf_sigma(xx_mid) * nnetot + chi_pe / doppler
                   + (chi_pp / doppler) * torch.clamp(1.0 - 2.46636e20 / nucmf1, min=0.0))
    else:
        heating = chi_pe / doppler
    heating_cont = heating * st.e_rf * dist * dop_sq
    est = est.replace(dep_gamma=cell_add(est.dep_gamma, nonemptymgi, heating_cont,
                                         mask & nonempty & (chi_tot > 0)))
    pos2, t2_, nucmf2, ecmf2, _ = geometry.move_pkt(pos1, st.dir, t1, st.nu_rf, nucmf1,
                                                    st.e_rf, dist / 2.0, rel)
    st = st.replace(pos=_w3(mask, pos2, st.pos),
                    prop_time=_w(take_tlimit, ctx.t2, _w(mask, t2_, st.prop_time)),
                    nu_cmf=_w(mask, nucmf2, st.nu_cmf), e_cmf=_w(mask, ecmf2, st.e_cmf))
    escaping = take_boundary & (snext == BOUNDARY_ESCAPE)
    crossing = take_boundary & (snext >= 0)
    st = st.replace(where=_w(crossing, snext, st.where),
                    escape_type=_w(escaping, st.ptype, st.escape_type),
                    escape_time=_w(escaping, st.prop_time, st.escape_time),
                    ptype=_w(escaping, TYPE_ESCAPE, st.ptype))
    est = est.replace(nesc=est.nesc + escaping.sum())

    # physical event (gammapkt.cc:793-813)
    chi_rnd = _uniform(key, 42, n, st.pos) * chi_tot
    ev_compton = take_event & (chi_compton > chi_rnd)
    ev_pe = take_event & ~ev_compton & ((chi_compton + chi_pe) > chi_rnd)
    ev_pp = take_event & ~ev_compton & ~ev_pe

    xx_e = torch.clamp(H * st.nu_cmf / ME_C2, min=1e-10)
    thomson = xx_e < THOMSON_LIMIT
    f = _w(thomson, 1.0, _choose_f(xx_e, _uniform(key, 43, n, st.pos)))
    stay_gamma = thomson | (_uniform(key, 44, n, st.pos) < 1.0 / f)
    scatters = ev_compton & stay_gamma
    absorbs_compton = ev_compton & ~stay_gamma
    vel = geometry.get_velocity(st.pos, st.prop_time)
    cmf_dir = geometry.angle_ab(st.dir, vel)
    cos_theta = _w(thomson, _thomson_angle(_uniform(key, 45, n, st.pos)), 1.0 - (f - 1.0) / xx_e)
    new_cmf_dir = _scatter_dir(key, 46, cmf_dir, cos_theta)
    new_rf_dir = geometry.angle_ab(new_cmf_dir, -vel)
    nu_cmf_scat = st.nu_cmf / f
    dop_new = geometry.doppler_nucmf_on_nurf(st.pos, new_rf_dir, st.prop_time, rel)
    st = st.replace(
        nu_cmf=_w(scatters, nu_cmf_scat, st.nu_cmf), dir=_w3(scatters, new_rf_dir, st.dir),
        nu_rf=_w(scatters, nu_cmf_scat / dop_new, st.nu_rf),
        e_rf=_w(scatters, st.e_cmf / dop_new, st.e_rf),
        ptype=_w(absorbs_compton, TYPE_NTLEPTON_DEPOSITED, st.ptype),
        absorptiontype=_w(absorbs_compton, -3, st.absorptiontype))
    st = st.replace(ptype=_w(ev_pe, TYPE_NTLEPTON_DEPOSITED, st.ptype),
                    absorptiontype=_w(ev_pe, -4, st.absorptiontype))
    # pair production (gammapkt.cc:676-716)
    prob_g = torch.clamp(1.022 * MEV / (H * torch.clamp(st.nu_cmf, min=1e-30)), 0.0, 1.0)
    to_lepton = ev_pp & (_uniform(key, 47, n, st.pos) > prob_g)
    to_511 = ev_pp & ~to_lepton
    dir_cmf_pp = _isotropic(key, 48, n, st.pos)
    vel_rev = st.pos / (-st.prop_time)[:, None]
    dir_rf_pp = geometry.angle_ab(dir_cmf_pp, vel_rev)
    nu_511 = 0.511 * MEV / H
    dop_pp = geometry.doppler_nucmf_on_nurf(st.pos, dir_rf_pp, st.prop_time, rel)
    st = st.replace(
        ptype=_w(to_lepton, TYPE_NTLEPTON_DEPOSITED, st.ptype),
        absorptiontype=_w(to_lepton, -5, st.absorptiontype),
        nu_cmf=_w(to_511, nu_511, st.nu_cmf), dir=_w3(to_511, dir_rf_pp, st.dir),
        nu_rf=_w(to_511, nu_511 / dop_pp, st.nu_rf), e_rf=_w(to_511, st.e_cmf / dop_pp, st.e_rf))
    converted = mask & (st.ptype != TYPE_GAMMA) & (st.ptype != TYPE_ESCAPE)
    est = est.replace(gamma_dep_discrete=est.gamma_dep_discrete + _w(converted, st.e_cmf, z).sum())
    return st, est


# ---------------------------------------------------------------------------
# r-packet transport (reference: rpkt.cc:604-737 do_rpkt_step)
# ---------------------------------------------------------------------------


def rpkt_lanes(st: PacketState, t2: float):
    """Compact the moving r-packets of ``st`` (``nonzero`` / index) into the
    crossing kernel's lane tensors: floats in the packets' dtype (float32
    or float64, the launch's precision), int32. Returns (idx, lanes), idx
    the packet indices of the lanes."""
    moving0 = (st.ptype == TYPE_RPKT) & (st.prop_time < t2)
    idx = torch.nonzero(moving0)[:, 0]

    def gf(x):
        return x[idx].contiguous()

    def gi(x):
        return x[idx].to(torch.int32).contiguous()

    lanes = dict(
        posx=gf(st.pos[:, 0]), posy=gf(st.pos[:, 1]), posz=gf(st.pos[:, 2]),
        dirx=gf(st.dir[:, 0]), diry=gf(st.dir[:, 1]), dirz=gf(st.dir[:, 2]),
        nu_rf=gf(st.nu_rf), nu_cmf=gf(st.nu_cmf), e_rf=gf(st.e_rf), e_cmf=gf(st.e_cmf),
        prop_time=gf(st.prop_time), where=gi(st.where), next_trans=gi(st.next_trans),
        moving=torch.ones(idx.numel(), dtype=torch.int32, device=idx.device),
        lane_id=gi(st.number))
    return idx, lanes


def rpkt_step(key, st: PacketState, est: Estimators, ctx: StepContext, grid: GridData,
              dad: DeviceAtomicData, cells, opts: Options, opacity_case: int,
              tables: dict | None = None, test_draws=None):
    """One r-packet advance: the moving lanes are compacted (nonzero /
    index_select) into one call of the crossing kernel, its outputs are
    scattered back, and ONE event-application pass follows for the lanes
    that reached their optical-depth target (the contract of the JAX
    package's rpkt_step / rpkt_step_pallas).

    test_draws: optional (tau, sel) (N,) arrays injected in place of the
    kernel's random numbers (the JAX package's _PALLAS_TEST_INJECT), taken
    in the packets' dtype.
    Returns (st, est, ma_mask, ma_level, ma_activating_line, nadv)."""
    check_crossing_dtype(opts)
    n = st.npkts
    dev = st.pos.device
    dtype = st.pos.dtype
    # dipole scattering needs the event pass's full machinery: the kernel
    # then defers every event, electron and thick-cell grey scattering
    # included, instead of redirecting isotropically in-kernel (K6; the JAX
    # package's inkernel_scatter=False)
    defer = bool(opts.dipole or opts.vpkt_on)
    idx, lanes = rpkt_lanes(st, ctx.t2)
    none = (torch.zeros(n, dtype=torch.bool, device=dev), torch.zeros_like(st.ptype),
            torch.full_like(st.ptype, -99))
    if idx.numel() == 0:
        return (st, est) + none + (0,)
    if tables is None:
        tables = rpkt_kernel.kernel_tables(dad, grid, cells, ctx, dtype)
    test_mode = test_draws is not None
    if test_mode:
        test_tau = test_draws[0].to(device=dev, dtype=dtype)[idx].contiguous()
        test_sel = test_draws[1].to(device=dev, dtype=dtype)[idx].contiguous()
    else:
        test_tau = test_sel = torch.zeros(idx.numel(), dtype=dtype, device=dev)
    ngc = max(dad.nbfcontinua_ground, 1)
    out = rpkt_kernel.propagate(
        rng.seed_of(rng.fold_in(key, 7777)), lanes, tables, test_tau, test_sel,
        float(ctx.t2), float(ctx.tmin), float(grid.max_path_step),
        nlines=dad.nlines, ncells=cells.Te.shape[0], ngc=ngc, nphixs=dad.nphixspoints,
        max_inner=max(opts.rpkt_crossings_per_dispatch, 1),
        relativistic=opts.use_relativistic_doppler_shift,
        phixs_dnu=float(dad.nphixsnuincrement),
        last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=test_mode,
        want_bfrate=want_bfrate(opts, dad), expansion=opts.expansionopacities_on,
        defer_scatter=defer, ff_only=opacity_case < 4, **crossing_estimators(opts, est),
        **rpkt_kernel.kernel_geometry(grid))

    def put(full, part):
        r = full.clone()
        r[idx] = part.to(full.dtype)
        return r

    def put3(full, a, b, c):
        r = full.clone()
        r[idx] = torch.stack([a, b, c], dim=1).to(full.dtype)
        return r

    escaped = torch.zeros(n, dtype=torch.bool, device=dev)
    escaped[idx] = out["escaped"] > 0
    scat = torch.zeros(n, dtype=torch.bool, device=dev)
    scat[idx] = out["inkscat"] > 0
    touched = torch.zeros(n, dtype=torch.bool, device=dev)
    touched[idx] = out["evented"] > 0
    new_time = put(st.prop_time, out["prop_time"])
    st = st.replace(
        pos=put3(st.pos, out["posx"], out["posy"], out["posz"]),
        dir=put3(st.dir, out["dirx"], out["diry"], out["dirz"]),
        nu_rf=put(st.nu_rf, out["nu_rf"]), e_rf=put(st.e_rf, out["e_rf"]),
        prop_time=new_time, nu_cmf=put(st.nu_cmf, out["nu_cmf"]),
        e_cmf=put(st.e_cmf, out["e_cmf"]), where=put(st.where, out["where"]),
        next_trans=put(st.next_trans, out["next_trans"]),
        escape_type=_w(escaped, st.ptype, st.escape_type),
        escape_time=_w(escaped, new_time, st.escape_time),
        ptype=_w(escaped, TYPE_ESCAPE, st.ptype),
        em_pos=_w3(scat, put3(st.em_pos, out["em_x"], out["em_y"], out["em_z"]), st.em_pos),
        em_time=_w(scat, put(st.em_time, out["em_t"]), st.em_time),
        nscatterings=put(st.nscatterings, st.nscatterings[idx] + out["nsc"].long()),
        stokes=_w3(scat, _stokes_reset(st), st.stokes))

    misc = out["misc"]
    est_k = out["est"]
    cnt = est.counters.clone()
    cnt[stats.CELLCROSSINGS] += misc[5].to(cnt.dtype)
    cnt[stats.ESCOUNTER] += misc[3].to(cnt.dtype)
    cnt[stats.INTERACTIONS] += (misc[3] + misc[4]).to(cnt.dtype)
    ngc_real = dad.nbfcontinua_ground
    est = est.replace(
        j=est.j + est_k[:, 0].to(est.j.dtype), nuj=est.nuj + est_k[:, 1].to(est.j.dtype),
        ffheating=est.ffheating + est_k[:, 2].to(est.j.dtype),
        nesc=est.nesc + misc[1].to(est.nesc.dtype),
        cmf_lum=est.cmf_lum + misc[2].to(est.cmf_lum.dtype), counters=cnt)
    if opts.use_lut_photoion:
        est = est.replace(gammaestimator=est.gammaestimator
                          + out["gamma"][:, :ngc_real].to(est.gammaestimator.dtype))
    if opts.use_lut_bfheating:
        est = est.replace(bfheatingestimator=est.bfheatingestimator
                          + out["bfheat"][:, :ngc_real].to(est.bfheatingestimator.dtype))
    if want_bfrate(opts, dad):
        est = est.replace(bfrate=est.bfrate + out["bfrate"].to(est.bfrate.dtype))
    if out["radbin"].shape[2]:
        rb = out["radbin"].to(est.radfieldbin_j.dtype)
        est = est.replace(radfieldbin_j=est.radfieldbin_j + rb[:, 0],
                          radfieldbin_nuj=est.radfieldbin_nuj + rb[:, 1],
                          radfieldbin_count=est.radfieldbin_count + rb[:, 2])
    if out["jblue"].shape[2]:
        jb = out["jblue"].to(est.jblue_raw.dtype)
        est = est.replace(jblue_raw=est.jblue_raw + jb[:, 0], jblue_count=est.jblue_count + jb[:, 1])
    nadv = int(misc[0].item())
    if not bool(touched.any()):
        return (st, est) + none + (nadv,)

    def full(part, fill, dt):
        r = torch.full((n,), fill, dtype=dt, device=dev)
        r[idx] = part.to(dt)
        return r

    res = _rpkt_apply_events(
        key, st, est, ctx, grid, dad, cells, opts, opacity_case, touched,
        full(out["thick"] > 0, False, torch.bool), full(out["is_bb"] > 0, False, torch.bool),
        full(out["chi_escat"], 0.0, dtype), full(out["chi_ff"], 0.0, dtype),
        full(out["chi_bf"], 0.0, dtype), full(out["chi_cont"], 0.0, dtype),
        full(out["bf_idx"], 0, torch.int64), full(out["act_line"], -99, torch.int64),
        full(out["mgi"], 0, torch.int64), no_escat=not defer)
    return res + (nadv,)


def _rpkt_apply_events(key, st, est, ctx, grid, dad, cells, opts, opacity_case,
                       take_event, thick, is_bb, chi_escat, chi_ff, chi_bf, chi_cont_cmf,
                       bf_contindex, ev_act_line, nonemptymgi, no_escat: bool = True):
    """Apply the physical-event outcomes of the lanes that had one
    (reference: rpkt.cc:411-557 rpkt_event_*). With ``no_escat`` the kernel
    already handled electron scattering, so the continuum split is drawn
    from the conditional distribution over [chi_es, chi_tot]; without it
    (the deferred mode of dipole scattering) the split is drawn over the
    whole continuum and electron scattering is decided here, by
    ``electron_scatter_batch``. In expansion-opacity
    mode a bound-bound event has no line yet: with
    ``rpkt_boundbound_thermalisation_probability`` >= 0 it scatters
    coherently, re-emitted from Planck x kappa with that probability; below
    0 the line is drawn within the hit bin and activates the macro-atom, and
    a bin without line weight scatters coherently."""
    n = st.npkts
    ev_thick = take_event & thick
    ev_bb = take_event & ~thick & is_bb
    ev_cont = take_event & ~thick & ~is_bb
    u52 = _uniform(key, 52, n, st.pos)
    if no_escat:
        chi_rnd = chi_escat + u52 * torch.clamp(chi_cont_cmf - chi_escat, min=0.0)
    else:
        chi_rnd = u52 * chi_cont_cmf
    ev_escat = ev_cont & (chi_rnd < chi_escat)
    ev_ff = ev_cont & ~ev_escat & (chi_rnd < chi_escat + chi_ff)
    ev_bf = ev_cont & ~ev_escat & ~ev_ff
    if opts.vpkt_on:
        est = vpkt_spawn(st, est, ctx, grid, dad, cells, opts, ev_escat, True, st.nu_cmf,
                         opacity_case)
    counters = est.counters.clone()
    stats.bump(counters, stats.INTERACTIONS, take_event)
    stats.bump(counters, stats.ESCOUNTER, ev_escat)
    stats.bump(counters, stats.K_STAT_FROM_FF, ev_ff)
    stats.bump(counters, stats.MA_STAT_ACTIVATION_BB, ev_bb)

    iso_mask = ev_thick
    if opts.expansionopacities_on:
        from . import expansionopacity as expo

        p_therm = opts.rpkt_boundbound_thermalisation_probability
        safe_mgi = torch.clamp(nonemptymgi, min=0)
        if p_therm >= 0.0:
            # fixed-probability thermalisation (rpkt.cc:706-713)
            thermalise = ev_bb & (_uniform(key, 56, n, st.pos) < p_therm)
            nu_new = expo.sample_planck_times_expansion_opacity(
                _uniform(key, 57, n, st.pos), _uniform(key, 64, n, st.pos),
                ctx.expopac_planck_cum, safe_mgi, thermalise)
            st = st.replace(nu_cmf=_w(thermalise, nu_new.to(st.nu_cmf.dtype), st.nu_cmf),
                            emissiontype=_w(thermalise, EMTYPE_FREEFREE, st.emissiontype))
            iso_mask = ev_thick | ev_bb
            ev_bb = torch.zeros_like(ev_bb)
        else:
            # every reference preset: the line within the hit bin activates
            # the macro-atom (rpkt.cc:238-262, 703-705)
            line, ok = expo.sample_bb_line(_uniform(key, 56, n, st.pos), ctx.expopac_wcum,
                                           ctx.expopac_binoffsets, safe_mgi, st.nu_cmf, ev_bb)
            ev_act_line = _w(ev_bb & ok, line, ev_act_line)
            iso_mask = ev_thick | (ev_bb & ~ok)
            ev_bb = ev_bb & ok
    scatter_mask = iso_mask | ev_escat
    st_scattered = emit_rpkt_batch(key, 53, st, iso_mask, opts)
    st_scattered = electron_scatter_batch(key, 59, st_scattered, ev_escat, opts)
    st = st_scattered.replace(
        nscatterings=_w(scatter_mask, st.nscatterings + 1, st.nscatterings),
        em_pos=_w3(scatter_mask, st.pos, st.em_pos),
        em_time=_w(scatter_mask, st.prop_time, st.em_time),
        emissiontype=_w(scatter_mask, st.emissiontype, st_scattered.emissiontype))
    st = st.replace(ptype=_w(ev_ff, TYPE_KPKT, st.ptype),
                    absorptiontype=_w(ev_ff, -1, st.absorptiontype))
    if dad.nbfcontinua > 0:
        nu_edge_sel = dad.cont_nu_edge.to(st.pos.dtype)[bf_contindex]
        goes_macroatom = ev_bf & (_uniform(key, 55, n, st.pos)
                                  < nu_edge_sel / torch.clamp(st.nu_cmf, min=1e-30))
        st = st.replace(absorptiontype=_w(ev_bf, -2, st.absorptiontype),
                        ptype=_w(ev_bf & ~goes_macroatom, TYPE_KPKT, st.ptype))
        ma_level_bf = dad.cont_uniqueupper[bf_contindex]
        st = st.replace(ptype=_w(goes_macroatom, TYPE_MA, st.ptype))
        stats.bump(counters, stats.K_STAT_FROM_BF, ev_bf & ~goes_macroatom)
        stats.bump(counters, stats.MA_STAT_ACTIVATION_BF, goes_macroatom)
        ma_from_bf = goes_macroatom
    else:
        st = st.replace(absorptiontype=_w(ev_bf, -2, st.absorptiontype),
                        ptype=_w(ev_bf, TYPE_KPKT, st.ptype))
        ma_from_bf = torch.zeros_like(ev_bf)
        ma_level_bf = torch.zeros_like(st.ptype)
    est = est.replace(counters=counters)
    act_line = ev_act_line
    st = st.replace(ptype=_w(ev_bb, TYPE_MA, st.ptype),
                    absorptiontype=_w(ev_bb, act_line, st.absorptiontype),
                    absorptionfreq=_w(ev_bb, st.nu_rf, st.absorptionfreq))
    ma_level_bb = dad.line_upperunique[torch.clamp(act_line, 0, dad.nlines - 1)]
    ma_level = torch.where(ev_bb, ma_level_bb, ma_level_bf)
    ma_mask = ev_bb | ma_from_bf
    ma_activating_line = _w(ev_bb, act_line, torch.full_like(act_line, -99))
    if opts.record_linestat:
        # per-line absorption counts (rpkt.cc:530-535 acounter)
        al = act_line[ev_bb]
        la = index_add_(est.line_absorbcount.clone(), 0,
                        torch.clamp(al, 0, est.line_absorbcount.shape[0] - 1),
                        torch.ones_like(al, dtype=est.line_absorbcount.dtype))
        est = est.replace(line_absorbcount=la)
    if opts.track_ion_stats:
        # per-ion absorption statistics (rpkt.cc:487-535, stats.cc:36-154)
        e = st.e_cmf
        ist = est.ion_stats.clone()
        line_ion = dad.line_ion[torch.clamp(act_line, 0, dad.nlines - 1)]
        stats.ion_add(ist, nonemptymgi, line_ion, stats.ION_MACROATOM_ENERGYIN_RADEXC, e, ev_bb)
        emt = st.emissiontype
        stats.ion_add(ist, nonemptymgi, dad.line_ion[torch.clamp(emt, 0, dad.nlines - 1)],
                      stats.ION_BOUNDBOUND_ABSORBED, e, ev_bb & (emt >= 0))
        if dad.nbfcontinua > 0:
            ion_bf = dad.cont_ion[bf_contindex]
            eps = (H * dad.cont_nu_edge[bf_contindex]).to(e.dtype)
            stats.ion_add(ist, nonemptymgi, ion_bf, stats.ION_PHOTOION,
                          e / torch.clamp(eps, min=1e-300), ev_bf)
            stats.ion_add(ist, nonemptymgi, ion_bf, stats.ION_RADRECOMB_ABSORBED, e, ev_bf)
            stats.ion_add(ist, nonemptymgi, torch.clamp(ion_bf + 1, max=dad.nions_total - 1),
                          stats.ION_MACROATOM_ENERGYIN_PHOTOION, e, ma_from_bf)
        est = est.replace(ion_stats=ist)
    return st, est, ma_mask, ma_level, ma_activating_line


# ---------------------------------------------------------------------------
# full-timestep wavefront (reference: update_packets.cc:361-437)
# ---------------------------------------------------------------------------


def vpkt_spawn(st: PacketState, est: Estimators, ctx: StepContext, grid: GridData,
               dad: DeviceAtomicData, cells, opts: Options, mask, is_scatter: bool, nu_cmf,
               opacity_case: int) -> Estimators:
    """Launch virtual packets from the real packets in ``mask`` at their
    interaction (reference: vpkt.cc:899-962 vpkt_call_estimators; the JAX
    package's _vpkt_spawn): electron scatters (``is_scatter``, the dipole
    phase matrix) or thermal emission at ``nu_cmf``. Draws no random
    number and leaves the packets as they are; skipped when no packet
    interacts."""
    if not bool(mask.any()):
        return est
    cfg = ctx.vpkt_cfg
    vspec, vgrid = vpkt_mod.trace_vpkts(
        cfg, est.vspec, dad, grid, cells, ctx, ctx.vpkt_cum_tau, ctx.vpkt_cum_taunu, st.pos,
        st.dir, st.prop_time, st.where, nu_cmf, st.e_cmf, st.stokes[:, 1:3], is_scatter, mask,
        opacity_case, vgrid_acc=est.vgrid if cfg.vgrid_on else None)
    return est.replace(vspec=vspec, vgrid=est.vgrid if vgrid is None else vgrid)


def apply_macroatom_results(key, tag, st: PacketState, ma_res, ma_mask, opts: Options):
    """Apply macro-atom deactivation outcomes (reference: macroatom.cc:398-628)."""
    kind = _w(ma_mask, ma_res["kind"], torch.zeros_like(ma_res["kind"]))
    rad = (kind == 1) | (kind == 2)
    to_kpkt = kind == 3
    st = st.replace(nu_cmf=_w(rad, ma_res["nu_cmf"].to(st.nu_cmf.dtype), st.nu_cmf))
    st_emitted = emit_rpkt_batch(key, tag, st, rad, opts)
    st = st_emitted.replace(
        emissiontype=_w(rad, ma_res["emissiontype"], st.emissiontype),
        next_trans=_w(rad, ma_res["next_trans"], st.next_trans),
        em_pos=_w3(rad, st.pos, st.em_pos), em_time=_w(rad, st.prop_time, st.em_time),
        nscatterings=_w(rad, 0, st.nscatterings),
        ptype=_w(to_kpkt, TYPE_KPKT, st_emitted.ptype))
    first = ma_mask & (st.trueemissiontype == EMTYPE_NOTSET) & rad
    return st.replace(
        trueemissiontype=_w(first, st.emissiontype, st.trueemissiontype),
        trueem_time=_w(first, st.em_time, st.trueem_time),
        trueemissionvelocity=_w(first, geometry.vec_len(st.em_pos)
                                / torch.clamp(st.em_time, min=1e-30),
                                st.trueemissionvelocity))


def nt_deposit_split(key, st: PacketState, est: Estimators, nt_dep, ctx: StepContext,
                     grid: GridData, dad: DeviceAtomicData, cells, opts: Options):
    """The Spencer-Fano split of the deposited leptons (reference:
    nonthermal.cc:2308-2387 do_ntlepton_deposit; artis_tpu engine.py:1892-1990):
    with probability frac_ionization a macro-atom at the ground state of
    the upper ion (the lower ion drawn by its share of the ionisation, the
    Auger electrons by their energy-weighted probabilities, clamped to the
    element's top ion); under ``nt_excitation_on``, with probability
    frac_excitation a macro-atom at the upper level of a transition drawn
    from the cumulative deposition fractions (a draw beyond the stored
    list falls through); else, and always in thick cells, a k-packet. The
    three uniforms are tags 121-123 of the iteration's key."""
    n = st.npkts
    u_all = _uniform(key, 121, n, st.pos)
    u2_all = _uniform(key, 122, n, st.pos)
    u3_all = _uniform(key, 123, n, st.pos)
    idx = torch.nonzero(nt_dep)[:, 0]
    if idx.numel() == 0:
        return st, est
    mgi = torch.clamp(grid.nonemptymgi_of_cell[st.where[idx]], min=0)
    thick = cells.thick[mgi] == 1
    u = u_all[idx]
    frac_ion = ctx.nt_frac_ionization[mgi]
    to_ion = ~thick & (u < frac_ion)
    # the lower ion, by its share of the ionisation
    cum = torch.cumsum(ctx.nt_frac_ion_by_ion[mgi], dim=1)
    nions = cum.shape[1]
    u2 = u2_all[idx] * torch.clamp(cum[:, -1], min=1e-300)
    lowerion = torch.clamp((cum <= u2[:, None]).sum(dim=1), max=nions - 1)
    # Auger electrons can skip ion stages (nonthermal.cc:2218-2243
    # nt_random_upperion, energy-weighted)
    cum_a = torch.cumsum(ctx.nt_ionenfrac_auger[mgi, lowerion], dim=1)
    u3 = u3_all[idx] * torch.clamp(cum_a[:, -1], min=1e-300)
    n_auger = torch.clamp((cum_a <= u3[:, None]).sum(dim=1), max=cum_a.shape[1] - 1)
    upperion = torch.minimum(lowerion + 1 + n_auger, ctx.nt_ion_topion[lowerion])
    level = dad.ion_level_start[upperion].to(st.ma_level.dtype)
    to_exc = torch.zeros_like(to_ion)
    if opts.nt_excitation_on:
        rows_e = ctx.nt_exc_fracdep_cum[mgi]
        u_rel = u - frac_ion
        maybe = ~thick & ~to_ion & (u < frac_ion + ctx.nt_frac_excitation[mgi])
        tsel = (rows_e <= u_rel[:, None]).sum(dim=1)
        to_exc = maybe & (tsel < rows_e.shape[1]) & (u_rel < rows_e[:, -1])
        exc_level = ctx.nt_exc_upper[torch.clamp(tsel, max=rows_e.shape[1] - 1)]
        level = torch.where(to_exc, exc_level.to(level.dtype), level)
    to_ma = to_ion | to_exc
    ptype, ma_level, trueem = st.ptype.clone(), st.ma_level.clone(), st.trueemissiontype.clone()
    ptype[idx] = torch.where(to_ma, TYPE_MA, TYPE_KPKT).to(ptype.dtype)
    ma_level[idx] = torch.where(to_ma, level, ma_level[idx])
    trueem[idx] = torch.where(to_ma, torch.full_like(trueem[idx], EMTYPE_NOTSET), trueem[idx])
    cnt = est.counters.clone()
    for stat, mask in ((stats.NT_STAT_TO_IONIZATION, to_ion),
                       (stats.MA_STAT_ACTIVATION_NTCOLLION, to_ion),
                       (stats.NT_STAT_TO_EXCITATION, to_exc),
                       (stats.MA_STAT_ACTIVATION_NTCOLLEXC, to_exc),
                       (stats.NT_STAT_TO_KPKT, ~to_ma)):
        stats.bump(cnt, stat, mask)
    if opts.track_ion_stats:
        # non-thermal ionisations (nonthermal.cc:2340-2347)
        ist = est.ion_stats.clone()
        mgi_s = grid.nonemptymgi_of_cell[st.where[idx]]
        e = st.e_cmf[idx]
        eps_ion = (dad.ion_eps0[upperion] - dad.ion_eps0[lowerion]).to(e.dtype)
        stats.ion_add(ist, mgi_s, lowerion, stats.ION_NTION, e / torch.clamp(eps_ion, min=1e-300),
                      to_ion)
        stats.ion_add(ist, mgi_s, upperion, stats.ION_MACROATOM_ENERGYIN_NTCOLLION, e, to_ion)
        est = est.replace(ion_stats=ist)
    return (st.replace(ptype=ptype, ma_level=ma_level, trueemissiontype=trueem),
            est.replace(counters=cnt))


def _select(st: PacketState, idx):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[idx]
                                      for f in dataclasses.fields(st)})


def _scatter(st: PacketState, idx, sub: PacketState):
    kw = {}
    for f in dataclasses.fields(st):
        full = getattr(st, f.name).clone()
        full[idx] = getattr(sub, f.name)
        kw[f.name] = full
    return dataclasses.replace(st, **kw)


def transport_timestep(key, st: PacketState, est: Estimators, grid: GridData,
                       dad: DeviceAtomicData, aux, rc, rates, cells, ctx: StepContext,
                       opts: Options, gamma_kappagrey: float, opacity_case: int,
                       kpktdiffusion_timescale: float, apply_kpkt_diffusion: bool,
                       max_iters: int = 4096, wall_budget: float = -1.0):
    """Advance every packet towards the end of the timestep for up to
    ``max_iters`` iterations, or until ``wall_budget`` seconds (if > 0) have
    passed, which leaves stragglers mid-timestep. Returns (st, est, iters,
    nsteps) where nsteps counts r-packet crossing steps. The r-packet phase
    goes through the crossing kernel: a launch when the packet tensors are on
    CUDA, its plain version on the CPU. ``key`` is a counter tuple."""
    from .kpkt import do_kpkt_batch
    from .macroatom import do_macroatom_batch, macroatom_log_rows

    check_supported(opts, opacity_case)
    check_crossing_dtype(opts)
    t_start = time.time()
    t2 = ctx.t2
    tables = rpkt_kernel.kernel_tables(dad, grid, cells, ctx, st.pos.dtype)
    nsteps = 0  # a Python int: no overflow (the JAX package's int64 float64 count)
    it = 0
    while it < max_iters:
        active = (st.ptype != TYPE_ESCAPE) & (st.prop_time < t2)
        if not bool(active.any()):
            break
        if wall_budget > 0 and time.time() - t_start > wall_budget:
            break
        k = rng.fold_in(key, it)
        it += 1
        live = st.prop_time < t2

        # 1-3: pellets, non-thermal predeposits, deposit conversion
        pt = st.ptype
        if bool((live & ((pt == TYPE_RADIOACTIVE_PELLET)
                         | (pt == TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS)
                         | (pt == TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS)
                         | (pt == TYPE_NONTHERMAL_PREDEPOSIT_ALPHA)
                         | (pt == TYPE_NTLEPTON_DEPOSITED)
                         | (pt == TYPE_NTALPHA_DEPOSITED))).any()):
            st, est = pellet_step(rng.fold_in(k, 101), st, est, ctx, opts)
            st, est = nonthermal_predeposit_step(rng.fold_in(k, 102), st, est, ctx, grid,
                                                 cells.rho, opts)
            nt_dep = ((st.ptype == TYPE_NTLEPTON_DEPOSITED)
                      | (st.ptype == TYPE_NTALPHA_DEPOSITED)) & (st.prop_time < t2)
            if opts.nt_on and opts.nt_solve_spencerfano:
                st, est = nt_deposit_split(k, st, est, nt_dep, ctx, grid, dad, cells, opts)
            else:
                st = st.replace(ptype=_w(nt_dep, TYPE_KPKT, st.ptype))

        # 4: k-packets
        nonemptymgi = grid.nonemptymgi_of_cell[st.where]
        safe_mgi = torch.clamp(nonemptymgi, min=0)
        nonthick = (nonemptymgi >= 0) & (cells.thick[safe_mgi] != 1)
        zb = torch.zeros(st.npkts, dtype=torch.bool, device=st.pos.device)
        ma_mask_k, ma_level_k = zb, torch.zeros_like(st.ptype)
        live = st.prop_time < t2
        if bool((live & ((st.ptype == TYPE_KPKT) | (st.ptype == TYPE_PRE_KPKT))).any()):
            k4 = rng.fold_in(k, 103)
            st, _ = kpkt_blackbody_step(k4, st, ctx, grid, cells.Te, cells.thick, opts)
            kpkt_mask = (st.ptype == TYPE_KPKT) & (st.prop_time < t2) & nonthick
            kidx = torch.nonzero(kpkt_mask)[:, 0]
            if kidx.numel():
                st_n, rad_n, ma_n, lvl_n = do_kpkt_batch(
                    rng.fold_in(k, 104), dad, aux, rc, rates, ctx.levelpops, _select(st, kidx),
                    torch.ones(kidx.numel(), dtype=torch.bool, device=kidx.device),
                    safe_mgi[kidx], cells.Te, cells.nne, t2, ctx.t2 - ctx.ts,
                    kpktdiffusion_timescale, apply_kpkt_diffusion)
                st = _scatter(st, kidx, st_n)
                kpkt_rad = zb.clone()
                kpkt_rad[kidx] = rad_n
                ma_mask_k = zb.clone()
                ma_mask_k[kidx] = ma_n
                ma_level_k = torch.zeros_like(st.ptype)
                ma_level_k[kidx] = lvl_n
                if opts.vpkt_on:
                    est = vpkt_spawn(st, est, ctx, grid, dad, cells, opts, kpkt_rad, False,
                                     st.nu_cmf, opacity_case)
                st = emit_rpkt_batch(rng.fold_in(k, 105), 0, st, kpkt_rad, opts)
                st = st.replace(em_pos=_w3(kpkt_rad, st.pos, st.em_pos),
                                em_time=_w(kpkt_rad, st.prop_time, st.em_time),
                                nscatterings=_w(kpkt_rad, 0, st.nscatterings))
                cnt = est.counters.clone()
                stats.bump(cnt, stats.K_STAT_TO_R_FF, kpkt_rad)
                stats.bump(cnt, stats.K_STAT_TO_MA_COLLEXC, ma_mask_k)
                est = est.replace(counters=cnt)
                if opts.track_ion_stats:
                    # collisional excitation into the macro-atom (kpkt.cc)
                    ion_k = dad.level_ion[torch.clamp(ma_level_k, 0, dad.nlevels_total - 1)]
                    est = est.replace(ion_stats=stats.ion_add(
                        est.ion_stats.clone(), nonemptymgi, ion_k,
                        stats.ION_MACROATOM_ENERGYIN_COLLEXC, st.e_cmf, ma_mask_k))

        # 5: gamma packets
        if bool(((st.prop_time < t2) & (st.ptype == TYPE_GAMMA)).any()):
            st, est = gamma_step(rng.fold_in(k, 106), st, est, ctx, grid, cells.rho,
                                 cells.nnetot, cells.ffegrp, gamma_kappagrey, opts)

        # 6: r-packets through the crossing kernel
        st, est, ma_mask_r, ma_level_r, _, nadv_r = rpkt_step(
            rng.fold_in(k, 107), st, est, ctx, grid, dad, cells, opts, opacity_case,
            tables=tables)
        nsteps += nadv_r

        # 7: macro-atoms (at most ma_max_jumps_per_iter jumps per iteration;
        # unresolved atoms keep their level and continue next iteration)
        ma_carried = (st.ptype == TYPE_MA) & (st.prop_time < t2)
        ma_mask = ma_mask_k | ma_mask_r | ma_carried
        if bool(ma_mask.any()):
            ma_level = torch.where(ma_mask_k, ma_level_k,
                                   torch.where(ma_mask_r, ma_level_r, st.ma_level))
            idx = torch.nonzero(ma_mask)[:, 0]
            res = do_macroatom_batch(
                rng.fold_in(k, 108), dad, aux, rc, rates, ctx.levelpops, safe_mgi[idx],
                ma_level[idx], torch.ones(idx.numel(), dtype=torch.bool, device=idx.device),
                cells.Te, cells.TR, cells.W, cells.nne, ctx.t_mid,
                max_jumps=opts.ma_max_jumps_per_iter)
            n = st.npkts

            def expand(x, fill):
                r = torch.full((n,), fill, dtype=x.dtype, device=x.device)
                r[idx] = x
                return r

            ma_res = dict(kind=expand(res["kind"], 0),
                          nu_cmf=expand(res["nu_cmf"].to(st.nu_cmf.dtype), 0.0),
                          emissiontype=expand(res["emissiontype"], 0),
                          next_trans=expand(res["next_trans"], 0))
            st2 = apply_macroatom_results(rng.fold_in(k, 109), 110, st, ma_res, ma_mask, opts)
            kindf = _w(ma_mask, ma_res["kind"], torch.zeros_like(ma_res["kind"]))
            if opts.vpkt_on:
                # a bound-bound deactivation's virtual packet leaves at its
                # line's frequency in the line list: there the JAX package's
                # float64 (E_u - E_l)/h is the list's value bit for bit, so
                # the segment sum counts the emitting line itself; a float32
                # level-energy difference would miss it by rounding
                line = torch.clamp(ma_res["emissiontype"], 0, dad.nlines - 1)
                nu_v = torch.where(kindf == 1, dad.line_nu.to(st.nu_cmf.dtype)[line],
                                   ma_res["nu_cmf"])
                est = vpkt_spawn(st, est, ctx, grid, dad, cells, opts, (kindf == 1) | (kindf == 2),
                                 False, nu_v, opacity_case)
            cnt = est.counters.clone()
            stats.bump(cnt, stats.MA_STAT_DEACTIVATION_BB, kindf == 1)
            stats.bump(cnt, stats.MA_STAT_DEACTIVATION_FB, kindf == 2)
            stats.bump(cnt, stats.MA_STAT_DEACTIVATION_COLLDEEXC, kindf == 3)
            est = est.replace(counters=cnt)
            if opts.record_linestat:
                # per-line emission counts (macroatom.cc:404-410 ecounter)
                em = res["emissiontype"][res["kind"] == 1]
                le = index_add_(est.line_emisscount.clone(), 0,
                                torch.clamp(em, 0, est.line_emisscount.shape[0] - 1),
                                torch.ones_like(em, dtype=est.line_emisscount.dtype))
                est = est.replace(line_emisscount=le)
            if opts.log_macroatom:
                # the bounded macro-atom log (LOG_MACROATOM,
                # macroatom.cc:413-421), one row per radiative bound-bound
                # deactivation, kept on the device
                malog, malog_n = macroatom_log_rows(
                    est.malog, est.malog_n, res["kind"] == 1,
                    (safe_mgi[idx], ma_level[idx], res["level"], res["emissiontype"],
                     st.nu_cmf[idx], res["nu_cmf"], st.nu_rf[idx], st2.nu_rf[idx]))
                est = est.replace(malog=malog, malog_n=malog_n)
            if opts.track_ion_stats:
                # energy into the macro-atom at activation, out by the
                # deactivation channel (macroatom.cc:341, 405-433)
                ist = est.ion_stats.clone()
                mgi_s = grid.nonemptymgi_of_cell[st.where]
                e = st.e_cmf
                nlev1 = dad.nlevels_total - 1
                ion_act = dad.level_ion[torch.clamp(ma_level, 0, nlev1)]
                stats.ion_add(ist, mgi_s, ion_act, stats.ION_MACROATOM_ENERGYIN_TOTAL, e, ma_mask)
                ion_out = dad.level_ion[torch.clamp(expand(res["level"], 0), 0, nlev1)]
                is_bb, is_fb, is_cd = kindf == 1, kindf == 2, kindf == 3
                emline = ma_res["emissiontype"]
                eps_line = (H * dad.line_nu[torch.clamp(emline, 0, dad.nlines - 1)]).to(e.dtype)
                for ion, stat, val, mask in (
                        (ion_out, stats.ION_MACROATOM_ENERGYOUT_RADDEEXC, e, is_bb),
                        (ion_out, stats.ION_BOUNDBOUND_MACROATOM,
                         e / torch.clamp(eps_line, min=1e-300), is_bb & (emline >= 0)),
                        (torch.clamp(ion_out + 1, max=dad.nions_total - 1),
                         stats.ION_RADRECOMB_MACROATOM, e, is_fb),
                        (ion_out, stats.ION_MACROATOM_ENERGYOUT_COLLDEEXC, e, is_cd),
                        (ion_out, stats.ION_MACROATOM_ENERGYOUT_TOTAL, e, is_bb | is_fb | is_cd)):
                    stats.ion_add(ist, mgi_s, ion, stat, val, mask)
                est = est.replace(ion_stats=ist)
            pending = ma_mask & expand(res["unresolved"], False)
            pend_level = expand(res["level"], 0)
            st = st2.replace(ptype=_w(pending, TYPE_MA, st2.ptype),
                             ma_level=_w(pending, pend_level, st2.ma_level))
    return st, est, it, nsteps

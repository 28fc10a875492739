"""NLTE level populations: per-element statistical equilibrium, batched over
cells (reference: nltepop.cc:750-1058 solve_nlte_pops_element, 383-464 the
bound-bound matrix, 466-523 ionisation / recombination, 555-589 the column
normalisation by LTE populations, 623-746 the LU solve with refinement and
the negative-population fallback, 892-916 the normalisation row and the
forced-Saha ion rows).

Each element's rate matrix is assembled for all cells at once by index-adds
over the element's transition and continuum lists (built once on the host,
``build_indices``), and solved by one batched LU factorisation
(``torch.linalg.lu_factor`` / ``lu_solve``) with iterative refinement that
keeps the iterate of least residual. The JAX package leaves this solve to
``jax.scipy``; it is a plain matrix solve, not a kernel.

Superlevels (reference: input.cc:1418-1460 setup_nlte_levels,
nltepop.cc:850-870, 1061-1072): the levels of an ion above its NLTE cap
share one matrix column whose internal distribution is Boltzmann at T_exc;
rates out of a member level carry its Boltzmann share of the superlevel, and
the column's normalisation is the sum of its members' LTE populations.

Radiation-field sources of the rates: upward bound-bound rates use the
dilute blackbody (T_R, W) or, for lines with one, the normalised detailed
J_b_lu estimator; photoionisation uses W LUT(T_R), or the LUT-off
coefficients against the current radiation field, and the detailed
bf-rate estimators replace either where given (ratecoeff.cc:1218-1226).
The non-thermal solver adds its ionisation rates (to the ground state of
the upper ion, with the Auger upper-ion probabilities) and its excitation
rates per deposited energy (nltepop.cc:445-449, 525-554).

The solve runs in the dtype of the populations it is given; the driver
gives float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..atomic import DeviceAtomicData
from ..constants import CLIGHTSQUARED, H, HCLIGHTOVERFOURPI, KB, MH
from ..devutil import index_add_
from ..options import Options
from .ltepop import (
    calculate_ionfractions_log, calculate_partfuncts, find_uppermost_ion, log_phi_saha,
)
from .radfield import dbb
from .ratecoeff import RateCoeffTables, interpolate_lut
from .transitionrates import (
    beta_sobolev, col_deexcitation_ratecoeff, col_excitation_ratecoeff,
    col_ionization_ratecoeff, col_recombination_ratecoeff,
)


@dataclasses.dataclass(frozen=True)
class ElementNlteIndex:
    """Host-side index lists of one element's rate matrix (numpy)."""

    element: int
    lstart: int  # first global level index
    dim: int  # levels of this element
    # down-block transitions of this element (each line once)
    trans_upper_local: np.ndarray
    trans_lower_local: np.ndarray
    trans_A: np.ndarray
    trans_coll_str: np.ndarray
    trans_forbidden: np.ndarray
    trans_osc_strength: np.ndarray
    trans_lineidx: np.ndarray  # global line index of each down entry
    # continua of this element
    cont_idx: np.ndarray  # into the global continuum arrays
    cont_lower_local: np.ndarray
    cont_upper_local: np.ndarray
    # per ion
    ion_local_start: np.ndarray
    ion_nlevels: np.ndarray
    nions: int
    first_global_ion: int = 0
    # superlevels: local level -> matrix column; members of an ion's
    # superlevel share one column
    colmap: np.ndarray | None = None
    dim_reduced: int = 0
    sl_member: np.ndarray | None = None
    e_slref: np.ndarray | None = None  # energy of the ion's first member


def nlte_level_cap(z: int, ionstage: int, opts) -> int:
    """Highest level index of an ion treated in full NLTE (reference:
    artisoptions_nltenebular.h:19-24 LEVEL_IS_NLTE; the christinenonthermal
    preset caps by Z band, artisoptions_christinenonthermal.h:19-24)."""
    if opts is None or opts.nlte_all_levels:
        return 1 << 30
    if opts.nlte_maxlevel_lowz >= 0 and z < 22:
        return opts.nlte_maxlevel_lowz
    if z == 26 and ionstage == 2:
        return opts.nlte_maxlevel_fe2
    return opts.nlte_maxlevel


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_indices(dad: DeviceAtomicData, opts=None) -> list[ElementNlteIndex]:
    """Per-element index lists (host, once per run)."""
    level_ion = _np(dad.level_ion)
    ion_element = _np(dad.ion_element)
    ion_level_start = _np(dad.ion_level_start)
    ion_nlevels = _np(dad.ion_nlevels)
    ion_stage = _np(dad.ion_stage)
    trans_owner = _np(dad.trans_owner)
    trans_is_down = _np(dad.trans_is_down).astype(bool)
    trans_target = _np(dad.trans_target)
    cont_lower = _np(dad.cont_uniquelower)
    cont_upper = _np(dad.cont_uniqueupper)
    cont_elem = _np(dad.cont_element)
    level_energy = _np(dad.level_energy).astype(np.float64)
    elem_z = _np(dad.elem_z)
    level_elem = ion_element[level_ion]
    out = []
    for el in range(dad.nelements):
        ions = np.nonzero(ion_element == el)[0]
        if len(ions) == 0:
            continue
        lstart = int(ion_level_start[ions[0]])
        dim = int(ion_nlevels[ions].sum())
        sel = trans_is_down & (level_elem[trans_owner] == el)
        owner = trans_owner[sel]
        target_global = ion_level_start[level_ion[owner]] + trans_target[sel]
        csel = cont_elem == el
        z = int(elem_z[el])
        colmap = np.zeros(dim, dtype=np.int64)
        sl_member = np.zeros(dim, dtype=bool)
        e_slref = np.zeros(dim)
        col = 0
        for k, gi in enumerate(ions):
            ls = int(ion_level_start[gi]) - lstart
            nl = int(ion_nlevels[gi])
            n_full = min(nl, nlte_level_cap(z, int(ion_stage[gi]), opts) + 1)
            colmap[ls:ls + n_full] = col + np.arange(n_full)
            col += n_full
            if nl > n_full:
                colmap[ls + n_full:ls + nl] = col
                sl_member[ls + n_full:ls + nl] = True
                e_slref[ls + n_full:ls + nl] = level_energy[lstart + ls + n_full]
                col += 1
        out.append(ElementNlteIndex(
            element=el, lstart=lstart, dim=dim,
            trans_upper_local=(owner - lstart).astype(np.int64),
            trans_lower_local=(target_global - lstart).astype(np.int64),
            trans_A=_np(dad.trans_A)[sel], trans_coll_str=_np(dad.trans_coll_str)[sel],
            trans_forbidden=_np(dad.trans_forbidden)[sel],
            trans_osc_strength=_np(dad.trans_osc_strength)[sel],
            trans_lineidx=_np(dad.trans_lineindex)[sel],
            cont_idx=np.nonzero(csel)[0].astype(np.int64),
            cont_lower_local=(cont_lower[csel] - lstart).astype(np.int64),
            cont_upper_local=(cont_upper[csel] - lstart).astype(np.int64),
            ion_local_start=(ion_level_start[ions] - lstart).astype(np.int64),
            ion_nlevels=ion_nlevels[ions].astype(np.int64), nions=len(ions),
            first_global_ion=int(ions[0]), colmap=colmap, dim_reduced=col,
            sl_member=sl_member, e_slref=e_slref))
    return out


def _add(m, dimr, rows, cols, vals):
    """m[:, rows, cols] += vals with repeated (row, col) pairs summed."""
    index_add_(m.view(m.shape[0], dimr * dimr), 1, rows * dimr + cols, vals)


def solve_element(idx: ElementNlteIndex, dad: DeviceAtomicData, rc: RateCoeffTables, cells,
                  opts: Options, levelpops_boltzmann, nnelement, t_mid: float,
                  nt_ion_rate=None, nt_prob_auger=None, ntd=None, nt_exc_perdep=None,
                  nt_dep_rate_density=None, bfrate_normed=None, jblue_normed=None,
                  corr_photoion_cells=None):
    """One element's statistical equilibrium in every cell. Returns the
    (ncells, dim) level populations [1/cm3]. ``nt_ion_rate`` (ncells,
    nions_total): non-thermal ionisation rates [1/s], with
    ``nt_prob_auger`` (ncells, nions_total, naug) the probabilities of
    0, 1, ... Auger electrons (None: single ionisation); ``nt_exc_perdep``
    (ncells, nexc): non-thermal excitation rate coefficients per deposited
    energy of ``ntd``'s transitions, times ``nt_dep_rate_density``
    (ncells,) [erg/cm3/s]; ``bfrate_normed`` (ncells, ncont): detailed
    photoionisation rates; ``jblue_normed`` (jb_line (nlines,), jb_arr
    (ncells, njblue)): detailed J_b_lu; ``corr_photoion_cells`` (ncells,
    ncont): LUT-off photoionisation coefficients."""
    dt = levelpops_boltzmann.dtype
    dev = levelpops_boltzmann.device
    ncells = nnelement.shape[0]
    dim, lstart = idx.dim, idx.lstart
    t_e, nne = cells.Te.to(dt), cells.nne.to(dt)
    t_r = torch.clamp(cells.TR.to(dt), min=1.0)
    w = cells.W.to(dt)
    lp = levelpops_boltzmann[:, lstart:lstart + dim]
    level_energy = dad.level_energy.to(dt)
    level_g = dad.level_g.to(dt)

    def t(a, dtype=None):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    cm = t(idx.colmap, torch.int64)
    dimr = idx.dim_reduced
    s_renorm = torch.ones((ncells, dim), dtype=dt, device=dev)
    if bool(np.any(idx.sl_member)):
        member = t(idx.sl_member)
        t_exc = (cells.TJ if opts.ltepop_excitation_use_tj else cells.Te).to(dt)
        e_lvl = level_energy[lstart:lstart + dim]
        boltz = torch.where(member[None, :], level_g[lstart:lstart + dim][None, :] * torch.exp(
            -torch.clamp(e_lvl - t(idx.e_slref, dt), min=0.0)[None, :]
            / (KB * torch.clamp(t_exc, min=1.0))[:, None]), torch.zeros((), dtype=dt, device=dev))
        sl_partfunc = index_add_(torch.zeros((ncells, dimr), dtype=dt, device=dev), 1, cm, boltz)
        s_renorm = torch.where(member[None, :],
                               boltz / torch.clamp(sl_partfunc[:, cm], min=1e-300), s_renorm)

    m = torch.zeros((ncells, dimr, dimr), dtype=dt, device=dev)

    # --- bound-bound (nltepop.cc:383-464) ---
    if len(idx.trans_A) > 0:
        up = t(idx.trans_upper_local, torch.int64)
        lo = t(idx.trans_lower_local, torch.int64)
        eps_trans = level_energy[lstart + up] - level_energy[lstart + lo]
        nu_trans = torch.clamp(eps_trans / H, min=1e-30)
        a_ul = t(idx.trans_A, dt)
        b_ul = a_ul * (CLIGHTSQUARED / (nu_trans * nu_trans)) / (2.0 * H * nu_trans)
        g_u = level_g[lstart + up]
        g_l = level_g[lstart + lo]
        b_lu = g_u / g_l * b_ul
        n_u, n_l = lp[:, up], lp[:, lo]
        tau = torch.clamp((b_lu[None, :] * n_l - b_ul[None, :] * n_u) * HCLIGHTOVERFOURPI
                          * t_mid, min=0.0)
        beta = beta_sobolev(tau)
        coll = (t(idx.trans_coll_str, dt)[None, :], t(idx.trans_forbidden).bool()[None, :],
                t(idx.trans_osc_strength, dt)[None, :], g_u[None, :], g_l[None, :])
        r_down = a_ul[None, :] * beta
        c_down = col_deexcitation_ratecoeff(t_e[:, None], nne[:, None], eps_trans[None, :], *coll)
        r_over_j = torch.where(
            n_l > 0, (b_lu[None, :] - b_ul[None, :] * n_u / torch.clamp(n_l, min=1e-300)) * beta,
            b_lu[None, :] * beta)
        j_nu = dbb(nu_trans[None, :], t_r[:, None], w[:, None])
        if jblue_normed is not None:
            # the detailed line estimator replaces the dilute blackbody for
            # the selected lines (macroatom.cc:713-720)
            jb_line, jb_arr = jblue_normed
            li = t(idx.trans_lineidx, torch.int64)
            jb_idx = jb_line.long()[torch.clamp(li, 0, jb_line.shape[0] - 1)]
            has_jb = (li >= 0) & (jb_idx >= 0)
            j_nu = torch.where(has_jb[None, :], jb_arr.to(dt)[:, torch.clamp(jb_idx, min=0)],
                               j_nu)
        r_up = torch.clamp(r_over_j * j_nu, min=0.0)
        c_up = col_excitation_ratecoeff(t_e[:, None], nne[:, None], eps_trans[None, :], *coll)
        # rates out of a level carry its superlevel Boltzmann share
        down = (r_down + c_down) * s_renorm[:, up]
        upr = (r_up + c_up) * s_renorm[:, lo]
        cu, cl = cm[up], cm[lo]
        _add(m, dimr, cu, cu, -down)
        _add(m, dimr, cl, cu, down)
        _add(m, dimr, cl, cl, -upr)
        _add(m, dimr, cu, cl, upr)

    # --- bound-free (nltepop.cc:466-523) ---
    if len(idx.cont_idx) > 0:
        ci = t(idx.cont_idx, torch.int64)
        ll = t(idx.cont_lower_local, torch.int64)
        ul = t(idx.cont_upper_local, torch.int64)
        eps_trans = level_energy[lstart + ul] - level_energy[lstart + ll]
        sigma_edge = (dad.allphixs[dad.cont_phixsrow[ci], 0].to(dt)
                      * dad.cont_probability[ci].to(dt))
        lower_stage = dad.ion_stage[dad.cont_ion[ci]]
        g_l, g_u = level_g[lstart + ll], level_g[lstart + ul]
        if corr_photoion_cells is not None:
            # LUT-off: the integral over the current field (ratecoeff.cc:731-817)
            r_ion = corr_photoion_cells[:, ci].to(dt)
        else:
            r_ion = w[:, None] * interpolate_lut(rc.corrphotoion, rc, ci[None, :],
                                                 t_r[:, None]).to(dt)
        if bfrate_normed is not None:
            # the detailed Monte Carlo estimator is the photoionisation rate
            # coefficient (ratecoeff.cc:1218-1226)
            r_ion = bfrate_normed[:, ci].to(dt)
        c_ion = col_ionization_ratecoeff(t_e[:, None], nne[:, None], sigma_edge[None, :],
                                         eps_trans[None, :], lower_stage[None, :])
        r_rec = nne[:, None] * interpolate_lut(rc.spontrecomb, rc, ci[None, :],
                                               t_e[:, None]).to(dt)
        c_rec = col_recombination_ratecoeff(t_e[:, None], nne[:, None], sigma_edge[None, :],
                                            eps_trans[None, :], (lower_stage + 1)[None, :],
                                            g_l[None, :], g_u[None, :])
        ion = (r_ion + c_ion) * s_renorm[:, ll]
        rec = (r_rec + c_rec) * s_renorm[:, ul]
        cll, cul = cm[ll], cm[ul]
        _add(m, dimr, cll, cll, -ion)
        _add(m, dimr, cul, cll, ion)
        _add(m, dimr, cul, cul, -rec)
        _add(m, dimr, cll, cul, rec)

    # --- non-thermal ionisation (nltepop.cc:525-554): one Gamma_NT for
    # every level of an ion; the electron lands in the ground state of ion
    # + 1 + a with the Auger-electron probability P(a), the last reachable
    # ion taking what the lower ones leave (nonthermal.cc:2157-2203) ---
    if nt_ion_rate is not None:
        naug = nt_prob_auger.shape[2] if nt_prob_auger is not None else 1
        for k in range(idx.nions - 1):
            lsl = int(idx.ion_local_start[k])
            gion = idx.first_global_ion + k
            rate = nt_ion_rate[:, gion].to(dt)
            lv = torch.arange(lsl, lsl + int(idx.ion_nlevels[k]), device=dev)
            clv = cm[lv]
            slv = s_renorm[:, lv]
            _add(m, dimr, clv, clv, -rate[:, None] * slv)
            maxa = min(naug, idx.nions - 1 - k)
            for a in range(maxa):
                gup = torch.full_like(clv, int(idx.colmap[idx.ion_local_start[k + 1 + a]]))
                if nt_prob_auger is None:
                    p = torch.ones_like(rate) if a == 0 else torch.zeros_like(rate)
                elif a == maxa - 1:
                    p = 1.0 - nt_prob_auger[:, gion, :a].to(dt).sum(dim=1)
                else:
                    p = nt_prob_auger[:, gion, a].to(dt)
                _add(m, dimr, gup, clv, (rate * p)[:, None] * slv)

    # --- non-thermal excitation (nltepop.cc:445-449; nonthermal.cc:2272-2297) ---
    if nt_exc_perdep is not None and ntd is not None and nt_dep_rate_density is not None:
        exc_lower = _np(ntd.exc_lower)
        in_elem = (exc_lower >= lstart) & (exc_lower < lstart + dim)
        if np.any(in_elem):
            tsel = t(np.nonzero(in_elem)[0], torch.int64)
            lo_l = t(exc_lower[in_elem] - lstart, torch.int64)
            up_l = ntd.exc_upper[tsel] - lstart
            ntc = (nt_exc_perdep[:, tsel].to(dt) * nt_dep_rate_density.to(dt)[:, None]
                   * s_renorm[:, lo_l])
            clo, cup = cm[lo_l], cm[up_l]
            _add(m, dimr, clo, clo, -ntc)
            _add(m, dimr, cup, clo, ntc)

    # --- normalisation row and column scaling (nltepop.cc:892-930): the
    # constraint rows hold the column norms, so they constrain the physical
    # populations; a superlevel column's norm is the sum of its members'
    # LTE populations (nltepop.cc:568-577)
    lpc = torch.clamp(lp, min=opts.minpop)
    norm = index_add_(torch.zeros((ncells, dimr), dtype=dt, device=dev), 1, cm, lpc)
    m = m * norm[:, None, :]
    balance = torch.zeros((ncells, dimr), dtype=dt, device=dev)
    balance[:, 0] = nnelement.to(dt)
    m[:, 0, :] = norm
    if opts.force_saha_ion_balance:
        # each ion's first row becomes the Saha ion-population constraint
        # (nltepop.cc:904-921)
        t_exc = cells.TJ if opts.ltepop_excitation_use_tj else cells.Te
        partfuncts = calculate_partfuncts(dad, t_exc.to(dt))
        logphi = log_phi_saha(dad, partfuncts, t_e)
        uppermost = find_uppermost_ion(dad, logphi, cells.rho.to(dt) / MH)
        frac = calculate_ionfractions_log(dad, logphi, nne, uppermost)
        for k in range(1, idx.nions):
            g0 = int(idx.ion_local_start[k])
            c0 = int(idx.colmap[g0])
            c1 = int(idx.colmap[g0 + int(idx.ion_nlevels[k]) - 1]) + 1
            row = torch.zeros((ncells, dimr), dtype=dt, device=dev)
            row[:, c0:c1] = norm[:, c0:c1]
            m[:, c0, :] = row
            balance[:, c0] = nnelement.to(dt) * frac[:, idx.element, k]

    # --- batched LU with iterative refinement, keeping the iterate of least
    # residual (nltepop.cc:623-746) ---
    lu, piv = torch.linalg.lu_factor(m)

    def lusolve(rhs):
        return torch.linalg.lu_solve(lu, piv, rhs[:, :, None])[:, :, 0]

    def residual(xv):
        r = balance - torch.einsum("cij,cj->ci", m, xv)
        return r, torch.max(torch.abs(r), dim=1).values

    x = lusolve(balance)
    r, best_err = residual(x)
    best_x = x
    for _ in range(max(int(opts.nlte_refine_iters), 0)):
        x = x + lusolve(r)
        r, err = residual(x)
        better = err < best_err
        best_x = torch.where(better[:, None], x, best_x)
        best_err = torch.minimum(err, best_err)
    # superlevel members share their column's solution scaled by their own
    # LTE population (nltepop.cc:993-1005)
    pops = best_x[:, cm] * lpc
    # a non-finite solve or a negative population falls back to LTE
    # (nltepop.cc:632-636, 735-742)
    bad = ~torch.isfinite(pops) | (pops < 0)
    return torch.where(bad, lpc, pops)


def solve_all_elements(indices, dad: DeviceAtomicData, rc: RateCoeffTables, cells,
                       opts: Options, levelpops_boltzmann, t_mid: float, nt_ion_rate=None,
                       nt_prob_auger=None, ntd=None, nt_exc_perdep=None,
                       nt_dep_rate_density=None, bfrate_normed=None, jblue_normed=None,
                       corr_photoion_cells=None):
    """Solve every element (the sources as ``solve_element`` takes them);
    returns (cells with the ion ground populations, partition functions and
    nne re-derived from the populations, the (ncells, nlevels_total)
    populations)."""
    nnelement = cells.elem_numberdens()
    levelpops = levelpops_boltzmann.clone()
    for idx in indices:
        levelpops[:, idx.lstart:idx.lstart + idx.dim] = solve_element(
            idx, dad, rc, cells, opts, levelpops_boltzmann, nnelement[:, idx.element], t_mid,
            nt_ion_rate=nt_ion_rate, nt_prob_auger=nt_prob_auger, ntd=ntd,
            nt_exc_perdep=nt_exc_perdep, nt_dep_rate_density=nt_dep_rate_density,
            bfrate_normed=bfrate_normed, jblue_normed=jblue_normed,
            corr_photoion_cells=corr_photoion_cells)
    dt = levelpops.dtype
    ncells = levelpops.shape[0]
    ionpop = index_add_(torch.zeros((ncells, dad.nions_total), dtype=dt,
                                    device=levelpops.device), 1, dad.level_ion, levelpops)
    groundpops = levelpops[:, dad.ion_level_start]
    g0 = dad.ion_g0.to(dt)[None, :]
    partfuncts = torch.where(groundpops > 0, ionpop / torch.clamp(groundpops, min=1e-300) * g0,
                             g0.expand_as(groundpops))
    charge = (dad.ion_stage - 1).to(dt)[None, :]
    nne = torch.clamp(torch.sum(ionpop * charge, dim=1), min=opts.minpop)
    return cells.replace(ion_groundlevelpops=groundpops, ion_partfuncts=partfuncts,
                         nne=nne), levelpops

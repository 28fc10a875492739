"""Macro-atom process-rate sums and k-packet cooling channel tables
(reference: macroatom.cc:39-152 calculate_macroatom_transitionrates,
macroatom.cc:649-947 rate coefficient functions, kpkt.cc:49-211
calculate_cooling_rates_ion).

All (cell, level) sums are produced once per timestep by chunked passes over
the flat transition/continuum axes; per-transition selection values are
recomputed lazily by ``trans_values_at`` for the windows a walk touches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..atomic import DeviceAtomicData
from ..constants import (
    C_0, CLIGHTSQUARED, EULERGAMMA, H, H_IONPOT, HCLIGHTOVERFOURPI, KB,
)
from ..devutil import exp_clipped, index_add, index_add_
from .radfield import dbb
from .ratecoeff import RateCoeffTables, interpolate_lut

# macro-atom actions (reference: globals.h MA_ACTION enum order)
MA_ACTION_RADDEEXC = 0
MA_ACTION_COLDEEXC = 1
MA_ACTION_RADRECOMB = 2
MA_ACTION_COLRECOMB = 3
MA_ACTION_INTERNALDOWNSAME = 4
MA_ACTION_INTERNALDOWNLOWER = 5
MA_ACTION_INTERNALUPSAME = 6
MA_ACTION_INTERNALUPHIGHER = 7
MA_ACTION_INTERNALUPHIGHERNT = 8
MA_ACTION_COUNT = 9


@dataclasses.dataclass(frozen=True)
class ProcessRates:
    ma_rates: torch.Tensor  # (ncells, nlevels, MA_ACTION_COUNT)
    cool_exc_level: torch.Tensor  # (ncells, nlevels)
    cool_ion_cont: torch.Tensor  # (ncells, ncont)
    cool_fb_cont: torch.Tensor  # (ncells, ncont)
    cool_ff_ion: torch.Tensor  # (ncells, nions)
    ion_cooling: torch.Tensor  # (ncells, nions)
    totalcooling: torch.Tensor  # (ncells,)
    cool_exc_ion: torch.Tensor
    cool_ion_ion: torch.Tensor
    cool_fb_ion: torch.Tensor
    cont_rad: torch.Tensor  # (ncells, ncont) R_rec*eps_trans
    cont_tot_down: torch.Tensor  # (ncells, ncont) (R+C)_rec*eps_lower
    cont_tot_up: torch.Tensor  # (ncells, ncont) (R+C)_ion*eps_owner
    jb_line: torch.Tensor  # (nlines,) line -> J_b_lu column, -1 none ((1,) when off)
    jb_arr: torch.Tensor  # (ncells, njblue) normalised J_b_lu ((ncells, 1) when off)


def beta_sobolev(tau):
    """Escape probability (1 - exp(-tau))/tau (reference: macroatom.cc:669-672)."""
    return torch.where(tau > 1e-100, -torch.expm1(-tau) / torch.clamp(tau, min=1e-100),
                       torch.zeros_like(tau))


def col_deexcitation_ratecoeff(t_e, nne, eps_trans, coll_str, forbidden, osc_strength, g_u, g_l):
    """(reference: macroatom.cc:855-902) — per n_upper."""
    eoverkt = eps_trans / (KB * t_e)
    gauntfac = torch.where(
        eoverkt > 0.33421, torch.full_like(eoverkt, 0.2),
        0.276 * torch.exp(eoverkt) * (-EULERGAMMA - torch.log(torch.clamp(eoverkt, min=1e-100))))
    permitted = (C_0 * 14.51039491 * nne * torch.sqrt(t_e) * osc_strength
                 * (H_IONPOT / eps_trans) ** 2 * eoverkt * (g_l / g_u) * gauntfac)
    forbidden_rate = nne * 8.629e-6 * 0.01 * g_l / torch.sqrt(t_e)
    negative = torch.where(forbidden, forbidden_rate, permitted)
    positive = nne * 8.629e-6 * coll_str / g_u / torch.sqrt(t_e)
    return torch.where(coll_str < 0, negative, positive)


def col_excitation_ratecoeff(t_e, nne, eps_trans, coll_str, forbidden, osc_strength, g_u, g_l):
    """(reference: macroatom.cc:906-947) — per n_lower."""
    eoverkt = eps_trans / (KB * t_e)
    exp_eoverkt = exp_clipped(eoverkt)
    test = 0.276 * exp_eoverkt * (-EULERGAMMA - torch.log(torch.clamp(eoverkt, min=1e-100)))
    gamma = torch.clamp(test, min=0.2)
    permitted = (C_0 * nne * torch.sqrt(t_e) * 14.51039491 * osc_strength
                 * (H_IONPOT / eps_trans) ** 2 * eoverkt / exp_eoverkt * gamma)
    forbidden_rate = nne * 8.629e-6 * 0.01 * torch.exp(-eoverkt) * g_u / torch.sqrt(t_e)
    negative = torch.where(forbidden, forbidden_rate, permitted)
    positive = nne * 8.629e-6 * coll_str * torch.exp(-eoverkt) / g_l / torch.sqrt(t_e)
    return torch.where(coll_str < 0, negative, positive)


def _stage_g(stage, dtype):
    """Seaton g factor 0.1 / 0.2 / 0.3 by ion stage, in ``dtype``."""
    g = torch.full(stage.shape, 0.3, dtype=dtype, device=stage.device)
    g = torch.where(stage == 2, torch.tensor(0.2, dtype=dtype, device=stage.device), g)
    return torch.where(stage == 1, torch.tensor(0.1, dtype=dtype, device=stage.device), g)


def col_ionization_ratecoeff(t_e, nne, sigma_bf_edge, eps_trans, ionstage):
    """Seaton approximation (reference: macroatom.cc:823-851) — per n_lower."""
    g = _stage_g(ionstage, t_e.dtype)
    fac1 = eps_trans / (KB * t_e)
    return (nne * 1.55e13 * t_e**-0.5 * g * sigma_bf_edge * torch.exp(-fac1)
            / torch.clamp(fac1, min=1e-100))


def col_recombination_ratecoeff(t_e, nne, sigma_bf_edge, eps_trans, upper_ionstage, g_l, g_u):
    """Seaton + Saha detailed balance, exponentials cancelled analytically
    (reference: macroatom.cc:782-818) — per n_upper."""
    charge = upper_ionstage - 1
    g = _stage_g(charge, t_e.dtype)
    fac1 = eps_trans / (KB * t_e)
    sahaconst_no_exp = 2.0706659e-16 * (g_l / g_u) * t_e**-1.5
    return (nne * nne * sahaconst_no_exp * 1.55e13 * t_e**-0.5 * g * sigma_bf_edge
            / torch.clamp(fac1, min=1e-100))


def _trans_geometry(dad: DeviceAtomicData, kidx, dtype):
    """Per-transition owner/upper/lower/eps/B coefficients for flat indices."""
    nlevels = dad.nlevels_total
    owner = torch.clamp(dad.trans_owner[kidx], 0, nlevels - 1)
    is_down = dad.trans_is_down[kidx]
    owner_ion = dad.level_ion[owner]
    target = dad.ion_level_start[owner_ion] + dad.trans_target[kidx]
    e_owner = dad.level_energy.to(dtype)[owner]
    e_target = dad.level_energy.to(dtype)[target]
    g_owner = dad.level_g.to(dtype)[owner]
    g_target = dad.level_g.to(dtype)[target]
    upper = torch.where(is_down, owner, target)
    lower = torch.where(is_down, target, owner)
    eps_trans = torch.abs(e_owner - e_target)
    nu_trans = torch.clamp(eps_trans / H, min=1e-30)
    g_u = torch.where(is_down, g_owner, g_target)
    g_l = torch.where(is_down, g_target, g_owner)
    a_ul = dad.trans_A.to(dtype)[kidx]
    b_ul = a_ul * (CLIGHTSQUARED / (nu_trans * nu_trans)) / (2.0 * H * nu_trans)
    b_lu = g_u / g_l * b_ul
    return dict(owner=owner, is_down=is_down, e_owner=e_owner, e_target=e_target,
                upper=upper, lower=lower, eps_trans=eps_trans, nu_trans=nu_trans,
                g_u=g_u, g_l=g_l, a_ul=a_ul, b_ul=b_ul, b_lu=b_lu,
                coll_str=dad.trans_coll_str.to(dtype)[kidx],
                forb=dad.trans_forbidden[kidx].bool(),
                osc=dad.trans_osc_strength.to(dtype)[kidx])


def _j_nu(dad: DeviceAtomicData, g, kidx, tr, w, jb_line, jb_arr, rows=None):
    """J_nu at each transition's frequency: the dilute blackbody (T_R, W)
    of each row, replaced by the normalised detailed J_b_lu estimator for
    the lines that have one (reference: macroatom.cc:713-720). ``rows``
    picks the estimator row of each row of a (N, K) window; without it the
    rows are the cells of a (ncells, K) chunk."""
    j_nu = dbb(g["nu_trans"], torch.clamp(tr, min=1.0)[:, None], w[:, None])
    if jb_line is None:
        return j_nu
    li = dad.trans_lineindex[kidx]
    jb_idx = jb_line[torch.clamp(li, 0, jb_line.shape[0] - 1)]
    has_jb = (li >= 0) & (jb_idx >= 0)
    col = torch.clamp(jb_idx, min=0)
    j_detail = jb_arr[:, col] if rows is None else jb_arr[rows[:, None], col]
    return torch.where(has_jb, j_detail.to(j_nu.dtype), j_nu)


def trans_values_at(dad: DeviceAtomicData, levelpops, rows, kidx, te, ne, tr, w,
                    t_mid: float, jb_line=None, jb_arr=None):
    """Per-(row, transition) selection values computed on the fly for the
    (N, K) windows a macro-atom/k-packet walk touches (the fill-on-demand
    cellcache of macroatom.cc:39-152).

    Returns (v_rad, v_tot, v_coolexc):
      v_rad     down slots: R*eps_trans (0 on up slots)
      v_tot     down: (R+C)*eps_target; up: (R+C)*eps_owner
      v_coolexc up slots: n_l*C*eps_trans (0 on down slots)
    ``jb_line`` / ``jb_arr``: the detailed J_b_lu estimators of
    ``ProcessRates`` (None: the dilute blackbody for every line).
    """
    dtype = te.dtype
    kidx = torch.clamp(kidx, 0, max(dad.ntrans_total - 1, 0))
    g = _trans_geometry(dad, kidx, dtype)
    rowsk = rows[:, None]
    n_u = levelpops[rowsk, g["upper"]].to(dtype)
    n_l = levelpops[rowsk, g["lower"]].to(dtype)
    tau = torch.clamp((g["b_lu"] * n_l - g["b_ul"] * n_u) * HCLIGHTOVERFOURPI * t_mid, min=0.0)
    beta = beta_sobolev(tau)
    tec = te[:, None]
    nec = ne[:, None]
    is_down = g["is_down"]
    r_down = g["a_ul"] * beta
    c_down = col_deexcitation_ratecoeff(tec, nec, g["eps_trans"], g["coll_str"], g["forb"],
                                        g["osc"], g["g_u"], g["g_l"])
    wdown = is_down.to(dtype)
    v_rad = wdown * r_down * g["eps_trans"]
    v_tot_down = wdown * (r_down + c_down) * g["e_target"]
    r_over_j = torch.where(
        n_l > 0, (g["b_lu"] - g["b_ul"] * n_u / torch.clamp(n_l, min=1e-300)) * beta,
        g["b_lu"] * beta)
    j_nu = _j_nu(dad, g, kidx, tr, w, jb_line, jb_arr, rows)
    r_up = torch.clamp(r_over_j * j_nu, min=0.0)
    c_up = col_excitation_ratecoeff(tec, nec, g["eps_trans"], g["coll_str"], g["forb"],
                                    g["osc"], g["g_u"], g["g_l"])
    wup = 1.0 - wdown
    v_tot_up = wup * (r_up + c_up) * g["e_owner"]
    v_coolexc = wup * n_l * c_up * g["eps_trans"]
    return v_rad.to(dtype), (v_tot_down + v_tot_up).to(dtype), v_coolexc.to(dtype)


def compute_process_rates(dad: DeviceAtomicData, rc: RateCoeffTables, levelpops, nnion,
                          t_e, t_r, w, nne, t_mid: float, corrphotoionrenorm=None,
                          jblue_normed=None, corr_photoion_cells=None,
                          trans_chunk: int = 16384) -> ProcessRates:
    """The (cell, level) macro-atom action sums, the cooling channels and
    the per-continuum recombination / ionisation selection values.
    ``jblue_normed`` (jb_line (nlines,), jb_arr (ncells, njblue)): the
    detailed J_b_lu estimators replace the dilute blackbody in the upward
    radiative rates of their lines; ``corr_photoion_cells`` (ncells,
    ncont): the LUT-off photoionisation coefficients replace
    W LUT(T_R) corrphotoionrenorm (reference: ratecoeff.cc:731-817)."""
    jb_line, jb_arr = jblue_normed if jblue_normed is not None else (None, None)
    dtype = t_e.dtype
    dev = t_e.device
    ncells = t_e.shape[0]
    nlevels = dad.nlevels_total
    nions = dad.nions_total
    ma = torch.zeros((ncells, nlevels, MA_ACTION_COUNT), dtype=dtype, device=dev)
    cool_exc_level = torch.zeros((ncells, nlevels), dtype=dtype, device=dev)
    te = t_e[:, None]
    ne = nne[:, None]
    lp = levelpops.to(dtype)

    ntrans = dad.ntrans_total
    for k0 in range(0, ntrans, trans_chunk):
        kidx = torch.arange(k0, min(k0 + trans_chunk, ntrans), device=dev)
        g = _trans_geometry(dad, kidx, dtype)
        n_u = lp[:, g["upper"]]
        n_l = lp[:, g["lower"]]
        tau = torch.clamp((g["b_lu"][None, :] * n_l - g["b_ul"][None, :] * n_u)
                          * HCLIGHTOVERFOURPI * t_mid, min=0.0)
        beta = beta_sobolev(tau)
        is_down = g["is_down"]
        wdown = is_down.to(dtype)[None, :]
        wup = 1.0 - wdown
        eps = g["eps_trans"][None, :]
        r_down = g["a_ul"][None, :] * beta
        c_down = col_deexcitation_ratecoeff(te, ne, eps, g["coll_str"][None, :],
                                            g["forb"][None, :], g["osc"][None, :],
                                            g["g_u"][None, :], g["g_l"][None, :])
        r_over_j = torch.where(
            n_l > 0,
            (g["b_lu"][None, :] - g["b_ul"][None, :] * n_u / torch.clamp(n_l, min=1e-300)) * beta,
            g["b_lu"][None, :] * beta)
        j_nu = _j_nu(dad, dict(g, nu_trans=g["nu_trans"][None, :]), kidx, t_r, w, jb_line,
                     jb_arr)
        r_up = torch.clamp(r_over_j * j_nu, min=0.0)
        c_up = col_excitation_ratecoeff(te, ne, eps, g["coll_str"][None, :],
                                        g["forb"][None, :], g["osc"][None, :],
                                        g["g_u"][None, :], g["g_l"][None, :])
        owner = g["owner"]
        index_add_(ma[:, :, MA_ACTION_RADDEEXC], 1, owner, wdown * r_down * eps)
        index_add_(ma[:, :, MA_ACTION_COLDEEXC], 1, owner, wdown * c_down * eps)
        index_add_(ma[:, :, MA_ACTION_INTERNALDOWNSAME], 1, owner,
                   wdown * (r_down + c_down) * g["e_target"][None, :])
        index_add_(ma[:, :, MA_ACTION_INTERNALUPSAME], 1, owner,
                   wup * (r_up + c_up) * g["e_owner"][None, :])
        index_add_(cool_exc_level, 1, owner, wup * n_l * c_up * eps)

    ncont = dad.nbfcontinua
    ncw = max(ncont, 1)
    cool_ion_cont = torch.zeros((ncells, ncw), dtype=dtype, device=dev)
    cool_fb_cont = torch.zeros((ncells, ncw), dtype=dtype, device=dev)
    cont_rad = torch.zeros((ncells, ncw), dtype=dtype, device=dev)
    cont_tot_down = torch.zeros((ncells, ncw), dtype=dtype, device=dev)
    cont_tot_up = torch.zeros((ncells, ncw), dtype=dtype, device=dev)
    if ncont > 0:
        if corrphotoionrenorm is None:
            corrphotoionrenorm = torch.ones((ncells, max(dad.nbfcontinua_ground, 1)),
                                            dtype=dtype, device=dev)
        idx = torch.arange(ncont, device=dev)
        ll = dad.cont_uniquelower
        ul = dad.cont_uniqueupper
        ion = dad.cont_ion
        level_energy = dad.level_energy.to(dtype)
        eps_trans = (level_energy[ul] - level_energy[ll])[None, :]
        g_l = dad.level_g.to(dtype)[ll][None, :]
        g_u = dad.level_g.to(dtype)[ul][None, :]
        sigma_edge = (dad.allphixs[dad.cont_phixsrow, 0].to(dtype)
                      * dad.cont_probability.to(dtype))[None, :]
        upper_stage = (dad.ion_stage[ion] + 1)[None, :]
        lower_stage = dad.ion_stage[ion][None, :]
        alpha_sp = interpolate_lut(rc.spontrecomb.to(dtype), rc, idx[None, :], te)
        r_rec = ne * alpha_sp
        c_rec = col_recombination_ratecoeff(te, ne, sigma_edge, eps_trans, upper_stage, g_l, g_u)
        v_rec_rad = r_rec * eps_trans
        v_rec_tot = (r_rec + c_rec) * level_energy[ll][None, :]
        index_add_(ma[:, :, MA_ACTION_RADRECOMB], 1, ul, v_rec_rad)
        index_add_(ma[:, :, MA_ACTION_COLRECOMB], 1, ul, c_rec * eps_trans)
        index_add_(ma[:, :, MA_ACTION_INTERNALDOWNLOWER], 1, ul, v_rec_tot)
        if corr_photoion_cells is not None:
            r_ion = corr_photoion_cells.to(dtype)
        else:
            gamma_lut = interpolate_lut(rc.corrphotoion.to(dtype), rc, idx[None, :],
                                        torch.clamp(t_r, min=rc.mintemp)[:, None])
            gidx = torch.clamp(dad.cont_groundindex, 0, max(dad.nbfcontinua_ground - 1, 0))
            r_ion = w[:, None] * gamma_lut * corrphotoionrenorm[:, gidx]
        c_ion = col_ionization_ratecoeff(te, ne, sigma_edge, eps_trans, lower_stage)
        v_ion_tot = (r_ion + c_ion) * level_energy[ll][None, :]
        index_add_(ma[:, :, MA_ACTION_INTERNALUPHIGHER], 1, ll, v_ion_tot)
        cool_ion_cont = lp[:, ll] * c_ion * eps_trans
        bfcool = interpolate_lut(rc.bfcooling.to(dtype), rc, idx[None, :], te)
        nnupperion = nnion[:, torch.clamp(ion + 1, max=nions - 1)].to(dtype)
        cool_fb_cont = bfcool * nnupperion * ne
        cont_rad, cont_tot_down, cont_tot_up = v_rec_rad, v_rec_tot, v_ion_tot

    charge = (dad.ion_stage - 1).to(dtype)
    cool_ff_ion = torch.where(
        charge[None, :] > 0,
        1.426e-27 * torch.sqrt(t_e)[:, None] * charge[None, :] ** 2 * nnion.to(dtype) * ne,
        torch.zeros((), dtype=dtype, device=dev))
    zi = torch.zeros((ncells, nions), dtype=dtype, device=dev)
    cool_exc_ion = index_add(zi, 1, dad.level_ion, cool_exc_level)
    cont_ion_idx = dad.cont_ion if ncont else torch.zeros(1, dtype=torch.int64, device=dev)
    cool_ion_ion = index_add(zi, 1, cont_ion_idx, cool_ion_cont)
    cool_fb_ion = index_add(zi, 1, cont_ion_idx, cool_fb_cont)
    ion_cooling = cool_ff_ion + cool_exc_ion + cool_ion_ion + cool_fb_ion
    return ProcessRates(
        ma_rates=ma, cool_exc_level=cool_exc_level, cool_ion_cont=cool_ion_cont,
        cool_fb_cont=cool_fb_cont, cool_ff_ion=cool_ff_ion, ion_cooling=ion_cooling,
        totalcooling=torch.sum(ion_cooling, dim=1), cool_exc_ion=cool_exc_ion,
        cool_ion_ion=cool_ion_ion, cool_fb_ion=cool_fb_ion, cont_rad=cont_rad,
        cont_tot_down=cont_tot_down, cont_tot_up=cont_tot_up,
        jb_line=(jb_line.long() if jb_line is not None
                 else torch.full((1,), -1, dtype=torch.int64, device=dev)),
        jb_arr=(jb_arr.to(dtype) if jb_arr is not None
                else torch.zeros((ncells, 1), dtype=dtype, device=dev)))

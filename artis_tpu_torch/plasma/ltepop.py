"""LTE / Saha ionisation balance and level populations, batched over cells
(reference: ltepop.cc:49-60 phi_saha, 229-276 calculate_partfunct, 278-320
find_uppermost_ion, 359-415 find_converged_nne, 421-454
calculate_ionfractions, 473-502 calculate_levelpop, 562-640
calculate_ion_balance_nne).

Each per-cell root-find is one lane of a batched bisection; phi factors are
computed in log space (the reference's float64-overflow clip at log(DBL_MAX)
is reproduced exactly).
"""

from __future__ import annotations

import torch

from ..atomic import DeviceAtomicData
from ..constants import KB, MH, SAHACONST
from ..devutil import assert_testmodeonly, index_add
from ..options import Options
from .cellstate import CellState
from .ratecoeff import interpolate_lut

LOG_DBL_MAX = 709.782712893384


def calculate_partfuncts(dad: DeviceAtomicData, t_exc):
    """(ncells, nions_total) partition functions at t_exc
    (reference: ltepop.cc:229-276)."""
    dt = t_exc.dtype
    boltz = dad.level_g.to(dt)[None, :] * torch.exp(
        -dad.level_e_aboveground.to(dt)[None, :] / (KB * t_exc[:, None]))
    out = torch.zeros((t_exc.shape[0], dad.nions_total), dtype=dt, device=t_exc.device)
    return index_add(out, 1, dad.level_ion, boltz)


def log_phi_saha(dad: DeviceAtomicData, partfuncts, t_e):
    """log Saha factor per (cell, ion) (reference: ltepop.cc:49-60)."""
    upper_pf = torch.roll(partfuncts, -1, dims=1)
    log_ratio = torch.log(partfuncts) - torch.log(torch.clamp(upper_pf, min=1e-300))
    return (log_ratio + torch.log(torch.tensor(SAHACONST, dtype=t_e.dtype))
            - 1.5 * torch.log(t_e)[:, None]
            + dad.ion_ionpot_eff.to(t_e.dtype)[None, :] / (KB * t_e[:, None]))


def _ion_index_grid(dad: DeviceAtomicData):
    """(nelements, max_nions) uniqueionindex (0-padded) and validity mask."""
    pos = torch.arange(dad.max_nions, device=dad.elem_ion_start.device)
    ionidx = dad.elem_ion_start[:, None] + pos[None, :]
    valid = pos[None, :] < dad.elem_nions[:, None]
    return torch.where(valid, ionidx, torch.zeros_like(ionidx)), valid


def find_uppermost_ion(dad: DeviceAtomicData, logphi, nne_hi):
    """(ncells, nelements) uppermost ion before cumprod(nne_hi*phi)
    overflows float64 (reference: ltepop.cc:278-320)."""
    ionidx, valid = _ion_index_grid(dad)
    lf = torch.log(torch.clamp(nne_hi, min=1e-300))[:, None, None] + logphi[:, ionidx]
    pos = torch.arange(dad.max_nions, device=logphi.device)
    below = ((pos[None, :] < (dad.elem_nions - 1)[:, None]) & valid)[None, :, :]
    lf = torch.where(below, lf, torch.zeros_like(lf))
    cum = torch.cumsum(lf, dim=2)
    finite = cum < LOG_DBL_MAX
    consec = torch.cumprod(torch.where(below, finite, torch.ones_like(finite)).long(), dim=2)
    n_ok = torch.sum(torch.where(below, consec, torch.zeros_like(consec)), dim=2)
    return torch.minimum(n_ok, dad.elem_nions[None, :] - 1)


def calculate_ionfractions_log(dad: DeviceAtomicData, logphi, nne, uppermost_ion):
    """(ncells, nelements, max_nions) ion fractions, 0 beyond uppermost
    (reference: ltepop.cc:421-454, in log space)."""
    ionidx, valid = _ion_index_grid(dad)
    lognne = torch.log(torch.clamp(nne, min=1e-300))
    lstep = lognne[:, None, None] + logphi[:, ionidx]
    pos = torch.arange(dad.max_nions, device=logphi.device)
    in_chain = (pos[None, None, :] < uppermost_ion[:, :, None]) & valid[None, :, :]
    lstep = torch.where(in_chain, lstep, torch.zeros_like(lstep))
    suffix = torch.flip(torch.cumsum(torch.flip(lstep, [2]), dim=2), [2])
    ninf = torch.full_like(suffix, -torch.inf)
    logfrac = torch.where(pos[None, None, :] <= uppermost_ion[:, :, None], suffix, ninf)
    logfrac = torch.where(valid[None, :, :], logfrac, ninf)
    m = torch.max(logfrac, dim=2, keepdim=True).values
    w = torch.exp(logfrac - m)
    return w / torch.sum(w, dim=2, keepdim=True)


def nne_bisection(dad: DeviceAtomicData, logphi, nnelement, uppermost_ion, nne_hi,
                  niter: int = 64):
    """Solve nne = sum_ions charge * n_ion(nne) by batched bisection
    (reference: ltepop.cc:359-415)."""
    ionidx, valid = _ion_index_grid(dad)
    charge = torch.where(valid, dad.ion_stage[ionidx] - 1,
                         torch.zeros_like(ionidx)).to(logphi.dtype)

    def nne_after(nne):
        frac = calculate_ionfractions_log(dad, logphi, nne, uppermost_ion)
        nnion = nnelement[:, :, None] * frac
        return torch.clamp(torch.sum(nnion * charge[None, :, :], dim=(1, 2)), min=1e-300)

    lo = torch.zeros_like(nne_hi) + 1e-300
    hi = nne_hi
    for _ in range(niter):
        mid = 0.5 * (lo + hi)
        pos = (nne_after(mid) - mid) > 0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def set_groundlevelpops(dad: DeviceAtomicData, partfuncts, logphi, nnelement,
                        uppermost_ion, nne, minpop: float):
    """(ncells, nions_total) ground-level pops (reference: ltepop.cc:562-603)."""
    ionidx, valid = _ion_index_grid(dad)
    frac = calculate_ionfractions_log(dad, logphi, nne, uppermost_ion)
    pos = torch.arange(dad.max_nions, device=logphi.device)
    mp = torch.full_like(frac, minpop)
    nnion = torch.where(pos[None, None, :] <= uppermost_ion[:, :, None],
                        torch.clamp(nnelement[:, :, None] * frac, min=minpop), mp)
    nnion = torch.where(nnelement[:, :, None] > 0, nnion, torch.zeros_like(nnion))
    groundpop_grid = nnion * dad.ion_g0.to(frac.dtype)[ionidx][None, :, :] / partfuncts[:, ionidx]
    ncells = nne.shape[0]
    vals = torch.where(valid.reshape(-1)[None, :], groundpop_grid.reshape(ncells, -1),
                       torch.zeros((), dtype=frac.dtype, device=frac.device))
    out = torch.zeros((ncells, dad.nions_total), dtype=frac.dtype, device=frac.device)
    return index_add(out, 1, ionidx.reshape(-1), vals)


def calculate_ion_balance_nne(dad: DeviceAtomicData, cells: CellState, opts: Options,
                              gamma_ion=None, nt_ion_rate=None, rc=None) -> CellState:
    """LTE/Saha nne + ground-pop solve for all cells at once
    (reference: ltepop.cc:607-640).

    When ``gamma_ion`` (the photoionisation rate per ground-level
    population, from the LUT gamma estimators) and ``rc`` are given and
    ``force_saha_ion_balance`` is off, non-thick cells with a positive rate
    use the nebular rate balance phi = alpha_sp / Gamma_ion (reference:
    ltepop.cc:64-120 phi_rate_balance), with the non-thermal ionisation
    rate ``nt_ion_rate`` (ncells, nions_total) [1/s] added to the
    photoionisation rate."""
    dt = cells.Te.dtype
    t_exc = cells.TJ if opts.ltepop_excitation_use_tj else cells.Te
    partfuncts = calculate_partfuncts(dad, t_exc)
    logphi = log_phi_saha(dad, partfuncts, cells.Te)
    if gamma_ion is not None and not opts.force_saha_ion_balance and rc is not None:
        ionidx = torch.arange(dad.nions_total, device=logphi.device)
        alpha_sp = interpolate_lut(rc.ion_alpha_sp, rc, ionidx[None, :],
                                   cells.Te[:, None]).to(dt)  # (ncells, nions)
        gtot = gamma_ion * dad.ion_g0.to(dt)[None, :] / torch.clamp(partfuncts, min=1e-300)
        if nt_ion_rate is not None:
            gtot = gtot + nt_ion_rate.to(dt)
        logphi_rate = (torch.log(torch.clamp(alpha_sp, min=1e-300))
                       - torch.log(torch.clamp(gtot, min=1e-300)))
        use_rate = (gtot > 0) & (cells.thick[:, None] != 1)
        logphi = torch.where(use_rate, logphi_rate, logphi)
    nne_hi = cells.rho / MH
    nnelement = cells.elem_numberdens()
    uppermost = find_uppermost_ion(dad, logphi, nne_hi)
    nne = nne_bisection(dad, logphi, nnelement, uppermost, nne_hi)
    nne = torch.clamp(nne, min=opts.minpop)
    groundpops = set_groundlevelpops(dad, partfuncts, logphi, nnelement, uppermost,
                                     nne, opts.minpop)
    nnion = groundpops * partfuncts / dad.ion_g0.to(dt)[None, :]
    charge = (dad.ion_stage - 1).to(dt)[None, :]
    nne_calculated = torch.clamp(torch.sum(nnion * charge, dim=1), min=opts.minpop)
    assert_testmodeonly(torch.isfinite(nne_calculated) & (nne_calculated > 0.0),
                        "ion-balance nne finite and positive")
    return cells.replace(ion_partfuncts=partfuncts, ion_groundlevelpops=groundpops,
                         elements_uppermost_ion=uppermost, nne=nne_calculated)


def get_nnion(dad: DeviceAtomicData, cells: CellState):
    """(ncells, nions_total) total ion populations (reference: ltepop.cc:550-558)."""
    return cells.ion_groundlevelpops * cells.ion_partfuncts / dad.ion_g0.to(cells.Te.dtype)[None, :]


def calculate_levelpops(dad: DeviceAtomicData, cells: CellState, opts: Options):
    """Dense (ncells, nlevels_total) Boltzmann level populations
    (reference: ltepop.cc:473-502)."""
    dt = cells.Te.dtype
    t_exc = cells.TJ if opts.ltepop_excitation_use_tj else cells.Te
    groundpop = cells.ion_groundlevelpops[:, dad.level_ion]
    g0 = dad.ion_g0.to(dt)[dad.level_ion][None, :]
    nn = groundpop * dad.level_g.to(dt)[None, :] / g0 * torch.exp(
        -dad.level_e_aboveground.to(dt)[None, :] / (KB * t_exc[:, None]))
    elem_of_level = dad.ion_element[dad.level_ion]
    has_elem = cells.elem_massfrac[:, elem_of_level] > 0
    mp = torch.full_like(nn, opts.minpop)
    return torch.where(nn < opts.minpop, torch.where(has_elem, mp, torch.zeros_like(nn)), nn)

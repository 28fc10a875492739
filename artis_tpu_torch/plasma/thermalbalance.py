"""Electron-temperature solver: heating == cooling, batched over cells.

Port of the JAX package's thermal balance (reference: thermalbalance.cc:187-241
T_e_eqn_heating_minus_cooling, 291-378 call_T_e_finder, 108-184 heating
rates, 43-106 bf-heating coefficients). The reference solves each cell with
a GSL Brent search whose every evaluation re-solves the ionisation balance
and re-sums every rate; here one bisection step does that work for all cells
at once: the Saha/nne balance, the level populations, the transition sums in
chunks of (cells x transitions) and the continuum sums.

Dtype: the solve runs in float64 whatever the transport dtype
(``driver._plasma_update_device`` promotes the cells before calling
``call_t_e_finder``). The JAX package runs
it in the cells' dtype, float32 under float32 transport; in cold, nearly
neutral cells the collisional rates and the populations of excited levels
underflow float32 (the rate tables' fault, ROADMAP Queue 3), which moves
heating minus cooling and with it the bracket the bisection keeps.

Cost: one evaluation is the 64-step nne bisection plus about
ntrans / chunk chunk launches; a grid update takes 26 evaluations. The
chunk holds ``CHUNK_ELEMENTS`` (cell, transition) pairs, 32 MB per float64
temporary; the chunks' transition geometry is gathered once per solve
(``collisional_chunks``), and the bisection itself never waits for the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..atomic import DeviceAtomicData
from ..constants import KB
from ..options import Options
from .ltepop import calculate_ion_balance_nne, calculate_levelpops, get_nnion
from .ratecoeff import RateCoeffTables, interpolate_lut
from .transitionrates import (
    _trans_geometry, col_deexcitation_ratecoeff, col_excitation_ratecoeff,
    col_ionization_ratecoeff,
)

CHUNK_ELEMENTS = 1 << 22  # (cell, transition) pairs per chunk of the sums
BISECTION_STEPS = 24


class HeatingCoolingRates(NamedTuple):
    heating_collisional: torch.Tensor  # (ncells,)
    heating_bf: torch.Tensor
    heating_ff: torch.Tensor
    heating_dep: torch.Tensor
    cooling_ff: torch.Tensor
    cooling_fb: torch.Tensor
    cooling_collisional: torch.Tensor
    cooling_adiabatic: torch.Tensor


def collisional_chunks(dad: DeviceAtomicData, ncells: int, dtype):
    """The transitions' geometry in chunks of at most CHUNK_ELEMENTS
    (cell, transition) pairs, down-block entries first: a list of
    (down, geometry) built once per solve, so that no evaluation gathers it
    again or waits for the host."""
    if dad.ntrans_total == 0:
        return []
    chunk = max(256, CHUNK_ELEMENTS // max(ncells, 1))
    out = []
    for down in (True, False):
        kall = torch.nonzero(dad.trans_is_down == down)[:, 0]
        out += [(down, _trans_geometry(dad, kall[c0:c0 + chunk], dtype))
                for c0 in range(0, kall.numel(), chunk)]
    return out


def _collisional_sums(levelpops, t_e, nne, chunks):
    """Collisional de-excitation heating over the down-block entries and
    collisional excitation cooling over the up-block entries
    (thermalbalance.cc:108-131; kpkt.cc:84-114): each line counts once."""
    heat = torch.zeros(levelpops.shape[0], dtype=levelpops.dtype, device=levelpops.device)
    cool = torch.zeros_like(heat)
    te, ne = t_e[:, None], nne[:, None]
    for down, g in chunks:
        args = (te, ne, g["eps_trans"][None, :], g["coll_str"][None, :],
                g["forb"][None, :], g["osc"][None, :], g["g_u"][None, :],
                g["g_l"][None, :])
        if down:
            rate = col_deexcitation_ratecoeff(*args)
            heat = heat + torch.sum(levelpops[:, g["upper"]] * rate * args[2], dim=1)
        else:
            rate = col_excitation_ratecoeff(*args)
            cool = cool + torch.sum(levelpops[:, g["lower"]] * rate * args[2], dim=1)
    return heat, cool


def compute_heating_cooling(dad: DeviceAtomicData, rc: RateCoeffTables, cells, opts: Options,
                            levelpops, nnion, t_current: float, ffheating_norm, dep_heating,
                            chunks, bfheating_cells=None) -> HeatingCoolingRates:
    """Heating and cooling rates of every cell at its T_e (reference:
    thermalbalance.cc:108-241, kpkt.cc:66-171): collisional de-excitation
    heating, bf heating n_level W LUT(T_R), the normalised ff-heating
    estimator and the deposition; free-free, free-bound, collisional
    (excitation and ionisation) and adiabatic cooling. ``chunks``: the
    transitions from ``collisional_chunks``. ``bfheating_cells`` (ncells,
    ncont), the LUT-off bf-heating coefficients against the current
    radiation field (``ratecoeff.radfield_bf_integrals_cells``), replaces
    W LUT(T_R) (thermalbalance.cc:43-106)."""
    dt = levelpops.dtype
    t_e, nne = cells.Te, cells.nne
    t_r = torch.clamp(cells.TR, min=1.0)
    w = cells.W
    ncells = levelpops.shape[0]
    heat_coldeexc, cool_colexc = _collisional_sums(levelpops, t_e, nne, chunks)

    heat_bf = torch.zeros(ncells, dtype=dt, device=levelpops.device)
    cool_fb = torch.zeros_like(heat_bf)
    cool_colion = torch.zeros_like(heat_bf)
    ncont = dad.nbfcontinua
    if ncont > 0:
        chunk = max(64, CHUNK_ELEMENTS // max(ncells, 1))
        for c0 in range(0, ncont, chunk):
            ci = torch.arange(c0, min(c0 + chunk, ncont), device=levelpops.device)
            ll = dad.cont_uniquelower[ci]
            ion = dad.cont_ion[ci]
            eps_trans = (dad.level_energy.to(dt)[dad.cont_uniqueupper[ci]]
                         - dad.level_energy.to(dt)[ll])
            sigma_edge = (dad.allphixs[dad.cont_phixsrow[ci], 0].to(dt)
                          * dad.cont_probability.to(dt)[ci])
            n_ll = levelpops[:, ll]
            # bf heating: n_level * W * LUT(T_R) (thermalbalance.cc:246-289;
            # the bf-heating renormalisation is 1 as in the JAX package), or
            # LUT-off n_level * the on-the-fly coefficient
            if bfheating_cells is not None:
                heat_bf = heat_bf + torch.sum(n_ll * bfheating_cells[:, ci].to(dt), dim=1)
            else:
                bfh = interpolate_lut(rc.bfheating, rc, ci[None, :], t_r[:, None]).to(dt)
                heat_bf = heat_bf + torch.sum(n_ll * w[:, None] * bfh, dim=1)
            # fb cooling (kpkt.cc:147-171)
            bfcool = interpolate_lut(rc.bfcooling, rc, ci[None, :], t_e[:, None]).to(dt)
            nnupperion = nnion[:, torch.clamp(ion + 1, max=dad.nions_total - 1)]
            cool_fb = cool_fb + torch.sum(bfcool * nnupperion * nne[:, None], dim=1)
            # collisional ionisation cooling (kpkt.cc:116-145)
            c_ion = col_ionization_ratecoeff(t_e[:, None], nne[:, None], sigma_edge[None, :],
                                             eps_trans[None, :], dad.ion_stage[ion][None, :])
            cool_colion = cool_colion + torch.sum(n_ll * c_ion * eps_trans[None, :], dim=1)

    # free-free cooling (kpkt.cc:66-82)
    charge = (dad.ion_stage - 1).to(dt)
    cool_ff = torch.sum(torch.where(
        charge[None, :] > 0,
        1.426e-27 * torch.sqrt(t_e)[:, None] * charge[None, :] ** 2 * nnion * nne[:, None],
        torch.zeros_like(nnion)), dim=1)
    # adiabatic cooling p dV/V with dV/V = 3/t (thermalbalance.cc:226-233)
    nntot = torch.sum(nnion, dim=1) + nne
    cool_adiabatic = nntot * KB * t_e * 3.0 / t_current
    return HeatingCoolingRates(
        heating_collisional=heat_coldeexc, heating_bf=heat_bf, heating_ff=ffheating_norm,
        heating_dep=dep_heating, cooling_ff=cool_ff, cooling_fb=cool_fb,
        cooling_collisional=cool_colexc + cool_colion, cooling_adiabatic=cool_adiabatic)


def call_t_e_finder(dad: DeviceAtomicData, rc: RateCoeffTables, cells, opts: Options,
                    t_current: float, ffheating_norm, dep_heating, bfheating_cells=None):
    """Batched bisection for T_e in [mintemp, maxtemp] with the reference's
    out-of-bracket pin and 2x / 0.5x damping (thermalbalance.cc:291-378).
    Each evaluation re-solves the Saha/nne balance at the trial T_e, as the
    reference's root-finder callback does (thermalbalance.cc:209-216).
    ``bfheating_cells``: LUT-off bf-heating coefficients (see
    ``compute_heating_cooling``). Returns the new T_e; the caller solves the
    populations at it."""
    t_e_old = cells.Te
    chunks = collisional_chunks(dad, t_e_old.shape[0], t_e_old.dtype)

    def heating_minus_cooling(t_e):
        out = calculate_ion_balance_nne(dad, cells.replace(Te=t_e), opts)
        levelpops = calculate_levelpops(dad, out, opts)
        hc = compute_heating_cooling(dad, rc, out, opts, levelpops, get_nnion(dad, out),
                                     t_current, ffheating_norm, dep_heating, chunks,
                                     bfheating_cells)
        return (hc.heating_ff + hc.heating_bf + hc.heating_collisional + hc.heating_dep
                - hc.cooling_ff - hc.cooling_fb - hc.cooling_collisional
                - hc.cooling_adiabatic)

    lo = torch.full_like(t_e_old, opts.mintemp)
    hi = torch.full_like(t_e_old, opts.maxtemp)
    f_min = heating_minus_cooling(lo)
    f_max = heating_minus_cooling(hi)
    has_root = f_min * f_max < 0
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        # f falls with T_e (more cooling when hotter): move the bound whose
        # sign f_mid shares with f_min
        go_up = torch.sign(heating_minus_cooling(mid)) == torch.sign(f_min)
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    t_e = 0.5 * (lo + hi)
    # no bracket: pin to the boundary (thermalbalance.cc:347-361)
    pin = torch.where(f_max < 0, torch.full_like(t_e, opts.mintemp),
                      torch.full_like(t_e, opts.maxtemp))
    t_e = torch.where(has_root, t_e, pin)
    # 2x / 0.5x damping (thermalbalance.cc:363-371)
    t_e = torch.minimum(torch.maximum(t_e, 0.5 * t_e_old), 2.0 * t_e_old)
    return torch.clamp(t_e, opts.mintemp, opts.maxtemp)

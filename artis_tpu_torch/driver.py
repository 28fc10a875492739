"""The simulation driver: setup + per-timestep grid update and transport.

Port of the JAX package's driver (reference: sn3d.cc:686-946 main,
sn3d.cc:554-682 do_timestep, update_grid.cc:869-1072 update_grid_cell,
update_grid.cc:1076-1158 update_grid, grid.cc:2206-2325 grid_init ordering).

Per timestep: the plasma state of all non-empty cells is solved as batched
tensor ops, then the transport loop advances every packet to the end of the
timestep, then the estimators come back for the next grid update. Every
tensor lives on the Simulation's ``device``; the r-packet crossing kernel
runs as CUDA when that device is a GPU and as its plain version on the CPU.

Ported slice: the ``first``, ``lte`` and ``nlte`` grid updates (the
timesteps from ``num_lte_timesteps`` on: the full-spectrum T_R / W fit,
the multibin fits, the LUT-off photoionisation and bf-heating integrals,
the thermal-balance T_e solve, the thick-cell T_J override, the
rate-balance ionisation from the LUT gamma estimators with
``force_saha_ion_balance`` off, and, with ``nlte_enabled``, the NLTE outer
loop [Spencer-Fano solve -> T_e solve -> NLTE populations -> ion balance /
nne] per cell to ``nlte_convergence_tol`` or ``nlte_outer_iters``), with
the non-thermal solver (``nt_on``: the Spencer-Fano solve of
``plasma/nonthermal.py`` with ``nt_solve_spencerfano``, its solution kept
across timesteps up to ``sf_max_ts_between_solutions``, or else the
work-function approximation), so the kilonova_lte, classic and
nltenebular presets run; on
SPHERICAL1D, CYLINDRICAL2D and CARTESIAN3D grids, optionally with the
detailed bf-rate and J_b_lu line estimators, the multibin radiation field,
binned expansion opacities and dipole / polarised electron scattering;
particle thermalisation INSTANT, DETAILED, BARNES or WOLLAEGER, gamma
thermalisation by detailed transport or the BARNES, WOLLAEGER or GUTTMAN
scheme. Other modes raise NotImplementedError.

With ``expansionopacities_on`` the grid update also builds the binned
opacities and their Planck-weighted cumulative, and, for
``rpkt_boundbound_thermalisation_probability`` < 0, the per-cell cumulative
line weights that resolve a bound-bound event's line. These tables are
rebuilt every timestep from the level populations, so checkpoints carry
none of them.

The detailed bf-rate estimators (``detailed_bf_estimators_on``, per
(nonempty cell, bf continuum)), the multibin J / nuJ / count (per (cell,
bin)) and the detailed J_b_lu sums (per (cell, selected line)) are
accumulated by the crossing kernel, carried through checkpoints and
normalised into the next grid update as the JAX driver does: the bf-rates
from ``detailed_bf_estimators_usefromtimestep`` on and the J_b_lu sums feed
the NLTE populations (and the J_b_lu sums the macro-atom's upward rates),
the bins the multibin fits, whose J_nu the LUT-off integrals use from
``first_nlte_radfield_timestep`` on. The NLTE populations and the multibin
fits are written to ``nlte_0000.out`` and ``radfield_0000.out``.

The NLTE solve, like the thermal balance and the Spencer-Fano solve, runs
in float64 whatever the transport dtype (the JAX package runs it in the
cells' dtype and demotes the Spencer-Fano tables to float32). The
Spencer-Fano tables are built from the data directory's ``collion.txt``,
binding energies and optional Auger table (``synthdata.
write_synthetic_nonthermal_data`` writes synthetic ones).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time

import numpy as np
import torch
import torch.distributed as dist

from . import decay as decay_mod
from . import grid as grid_mod
from . import packets as packets_mod
from . import spectrum as spectrum_mod
from . import stats as stats_mod
from .atomic import to_device
from .constants import CLIGHT, DAY, EV, FOURPI, H, LSUN, ME, MEV, MH, ONEOVER4PI, PI, QE
from .devutil import demote_to_f32, index_add, map_tensors
from .estimators import Estimators, zero_estimators
from .io import atomicdata as atomicdata_io
from .io import gammadata as gammadata_io
from .io import inputparams as inputparams_io
from .io import model as model_io
from .options import Options, kilonova_lte
from .packets import TYPE_ESCAPE, TYPE_RPKT
from .parallel import mesh as mesh_mod
from .plasma import cellstate as cellstate_mod
from .plasma import ltepop as ltepop_mod
from .plasma import nltepop as nltepop_mod
from .plasma import nonthermal as nonthermal_mod
from .plasma import radfield as radfield_mod
from .plasma import ratecoeff as ratecoeff_mod
from .plasma import thermalbalance as thermalbalance_mod
from .plasma import transitionrates as transitionrates_mod
from .transport import engine as engine_mod
from .transport import linewalk as linewalk_mod
from .transport import macroatom as macroatom_mod
from .transport import expansionopacity as expo_mod
from .transport import opacity as opacity_mod
from .transport import rpkt_kernel
from .transport import thermalisation as therm_mod
from .transport import vpkt as vpkt_mod

GREY_OP = 0.1  # reference: globals.h:240
# the packet checkpoint's write attempts and the pause before the n-th
# retry, n times this (artis_tpu/driver.py:2009-2025 sleeps 1 + n s)
CHECKPOINT_ATTEMPTS = 3
CHECKPOINT_RETRY_S = 1.0


def _remove_pidfile(path):
    """Remove a run directory's lockfile (artis.pid), if it is still there."""
    try:
        os.remove(path)
    except OSError:
        pass


def printout(logfile, msg):
    line = f"{_time.strftime('%H:%M:%S')} {msg}"
    print(line, flush=True)
    if logfile is not None:
        logfile.write(line + "\n")
        logfile.flush()


def _kappagrey_just2022(x_lan, t_r):
    """Just+2022 grey kappa (reference: grid.cc:1790-1820)."""
    x_lan = np.asarray(x_lan, dtype=np.float64)
    t_r = np.asarray(t_r, dtype=np.float64)
    kappa = np.where(
        x_lan < 1e-7, 0.2,
        np.where(x_lan < 1e-3, 3.0 * (x_lan / 1e-3) ** 0.3,
                 np.where(x_lan < 1e-1, 3.0 * (x_lan / 1e-3) ** 0.5,
                          30.0 * (x_lan / 1e-1) ** 0.1)))
    return np.where(t_r < 2000.0, kappa * (t_r / 2000.0) ** 5, kappa)


def _cast(x, dtype):
    """The float tensors of ``x`` (a dataclass of tensors) in ``dtype``."""
    return map_tensors(lambda t: t.to(dtype) if t.is_floating_point() else t, x)


def _plasma_update_device(dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffheating_norm,
                          dep_heating, mode: str, gammaest_norm=None, binj_norm=None,
                          binnuj_norm=None, bincount=None, bfrate_normed=None,
                          jblue_normed=None, radfield_use_bins: bool = False,
                          nlte_indices=None, ntd=None, nt_wf=None, sf_carry=None, nts=None,
                          nt_sf_skip: bool = False, num_lte_timesteps: int = 0):
    """All tensor work of one grid update: the temperatures, the Saha /
    rate-balance nne solve or the NLTE populations, level populations,
    ff-opacity parts, macro-atom / cooling rate tables, and the
    per-timestep transport tables (reference: update_grid.cc:869-1072).

    mode: "first" (temperatures pre-assigned), "lte" (T_J from J, the LTE
    branch 961-978) or "nlte" (979-1002: the full-spectrum T_R / W fit, the
    thermal-balance T_e solve, the T_J path for thick cells, and the per-ion
    photoionisation rates and ``corrphotoionrenorm`` from the normalised
    LUT gamma estimators ``gammaest_norm`` (ncells, ngc), which feed the
    rate-balance ionisation and the rate tables). With ``multibin_radfield``
    the normalised bin estimators (``binj_norm``, ``binnuj_norm``,
    ``bincount``) are fitted first (radfield.cc:834-911); under LUT-off
    photoionisation / bf heating the on-the-fly integrals against the
    current field (the binned one when ``radfield_use_bins``) replace the
    LUTs in the T_e solve, the NLTE populations and the rate tables. With
    ``nlte_enabled`` and ``nlte_indices`` the NLTE outer loop (reference:
    update_grid.cc:670-763 solve_Te_nltepops) iterates [T_e solve -> NLTE
    populations (``nltepop.solve_all_elements``, with the normalised
    bf-rate estimators ``bfrate_normed`` and J_b_lu estimators
    ``jblue_normed`` = (jblue_of_line, (ncells, njblue))) -> ion balance /
    nne] until the fractional changes of T_e and nne fall to
    ``nlte_convergence_tol`` or ``nlte_outer_iters`` is reached; each cell
    freezes once converged, grey cells are never solved. Returns (cells,
    levelpops, nnion, chi_ff_part, rates, tau_sob, bf_a, bf_dep, expo,
    extra), expo the expansion-opacity tables (kappa, planck_cum, wcum,
    binoffsets), None when that mode is off (wcum and binoffsets None unless
    rpkt_boundbound_thermalisation_probability < 0); extra a dict of the
    multibin fits ``tr_bins`` / ``w_bins`` (None unless fitted) and the NLTE
    loop's per-cell ``nlte_fracdiff`` and ``nlte_iters`` (None without it).

    The non-thermal solver (``ntd``, the Spencer-Fano tables; ``nt_wf``, the
    work-function (1/W factor per ion, Z per element)): in ``nlte`` updates
    its ionisation rates enter the NLTE populations, and its heating
    fraction scales the deposition that heats the gas (``_SFState``).
    ``sf_carry`` is the solution carried from earlier timesteps (None: the
    default state of ``sf_default_carry``), ``nts``
    this timestep; ``nt_sf_skip`` keeps the carried solution (the first
    non-LTE timestep, artis_tpu/driver.py:1338). ``extra`` then also holds
    ``sf_carry`` (the carry to keep), ``nt`` (the fractions of the
    deposition split for the transport: frac_ion_by_ion, frac_ionization,
    frac_excitation, ionenfrac_num_auger, exc_fracdep_cum), ``sf_solves``
    and ``sf_seconds``."""
    f64 = torch.float64
    if mode == "lte":
        t_j = radfield_mod.get_t_j_from_j(j_norm, opts.mintemp, opts.maxtemp)
        valid = torch.isfinite(t_j) & (j_norm > 0)
        t_j = torch.where(valid, t_j, cells.TJ)
        cells = cells.replace(TJ=t_j, TR=t_j, Te=t_j, W=torch.ones_like(t_j))
    elif mode == "nlte":
        t_j, t_r, w, valid = radfield_mod.fit_params_fullspec(j_norm, nuj_norm, opts.mintemp,
                                                              opts.maxtemp)
        cells = cells.replace(TJ=torch.where(valid, t_j, cells.TJ),
                              TR=torch.where(valid, t_r, cells.TR),
                              W=torch.where(valid, w, cells.W))
    elif mode != "first":
        raise NotImplementedError(f"plasma update mode {mode!r}")
    # multibin fits before the solvers, so that the LUT-off integrals can
    # take J_nu from the binned model (update_grid_cell fits first too)
    tr_bins = w_bins = None
    if opts.multibin_radfield and mode != "first" and binj_norm is not None:
        tr_bins, w_bins = radfield_mod.fit_bin_params(
            binj_norm.to(f64), binnuj_norm.to(f64), bincount.to(f64), cells.Te.to(f64),
            opts.radfieldbincount, opts.mintemp, opts.maxtemp)
    # LUT-off photoionisation / bf-heating coefficients against the current
    # field (ratecoeff.cc:685-817, thermalbalance.cc:43-106), in float64
    corr_otf = bfh_otf = None
    if (mode == "nlte" and dad.nbfcontinua > 0
            and not (opts.use_lut_photoion and opts.use_lut_bfheating)):
        c64 = _cast(cells, f64)
        _, bf_dep0 = opacity_mod.build_bf_tables(
            dad, ltepop_mod.calculate_levelpops(dad, c64, opts), ltepop_mod.get_nnion(dad, c64),
            c64.nne, c64.nnetot, c64.Te)
        use_bins = radfield_use_bins and tr_bins is not None
        corr_all, bfh_all = ratecoeff_mod.radfield_bf_integrals_cells(
            dad, c64.Te, c64.TR, c64.W, bf_dep0, tr_bins=tr_bins if use_bins else None,
            w_bins=w_bins if use_bins else None,
            nbins=opts.radfieldbincount if use_bins else 0)
        corr_otf = None if opts.use_lut_photoion else corr_all
        bfh_otf = None if opts.use_lut_bfheating else bfh_all
    if mode == "nlte":
        # the thermal balance in float64 whatever the cells' dtype (see
        # plasma/thermalbalance.py); the populations are solved below
        t_e = thermalbalance_mod.call_t_e_finder(
            dad, rc, _cast(cells, f64), opts, t_mid, ffheating_norm.to(f64), dep_heating.to(f64),
            bfheating_cells=bfh_otf)
        cells = cells.replace(Te=t_e.to(cells.Te.dtype))
        # thick cells take the grey / LTE T_J path in non-LTE timesteps too
        # (update_grid.cc:961-978)
        t_j = radfield_mod.get_t_j_from_j(j_norm, opts.mintemp, opts.maxtemp)
        thick_j = (cells.thick == 1) & torch.isfinite(t_j) & (j_norm > 0)
        cells = cells.replace(TJ=torch.where(thick_j, t_j, cells.TJ),
                              TR=torch.where(thick_j, t_j, cells.TR),
                              Te=torch.where(thick_j, t_j, cells.Te),
                              W=torch.where(cells.thick == 1, torch.ones_like(t_j), cells.W))
    # LUT gamma estimators -> per-ion Gamma and corrphotoionrenorm
    # (update_grid.cc:765-830)
    gamma_ion = corrphotoionrenorm = None
    if (mode == "nlte" and gammaest_norm is not None and opts.use_lut_photoion
            and dad.nbfcontinua_ground > 0):
        gest = gammaest_norm[:, :dad.nbfcontinua_ground]
        corr_lut = ratecoeff_mod.interpolate_lut(
            rc.corrphotoion, rc, dad.groundcont_contindex[None, :],
            torch.clamp(cells.TR, min=rc.mintemp)[:, None]).to(gest.dtype)
        corr_ana = cells.W[:, None] * corr_lut
        corrphotoionrenorm = torch.where(corr_ana > 0, gest / torch.clamp(corr_ana, min=1e-300),
                                         torch.ones_like(gest))
        gamma_ion = index_add(torch.zeros((gest.shape[0], dad.nions_total), dtype=gest.dtype,
                                          device=gest.device), 1, dad.groundcont_uniqueion, gest)
    cells = ltepop_mod.calculate_ion_balance_nne(dad, cells, opts, gamma_ion=gamma_ion, rc=rc)
    extra = dict(tr_bins=tr_bins, w_bins=w_bins, nlte_fracdiff=None, nlte_iters=None,
                 sf_carry=None, nt=None, sf_solves=0, sf_seconds=0.0)
    sfs = _SFState(dad, cells, opts, ntd, nt_wf, sf_carry, nts, nt_sf_skip, num_lte_timesteps,
                   dep_heating) if (ntd is not None or nt_wf is not None) else None
    if mode == "nlte" and opts.nlte_enabled and nlte_indices:
        cells, levelpops, extra["nlte_fracdiff"], extra["nlte_iters"] = _nlte_outer_loop(
            dad, rc, cells, opts, t_mid, ffheating_norm, dep_heating, nlte_indices,
            bfrate_normed, jblue_normed, corr_otf, bfh_otf, sfs=sfs)
    else:
        if mode == "nlte" and sfs is not None:
            # no NLTE levels: one Spencer-Fano, T_e and ion-balance pass
            # (update_grid.cc:710-721; artis_tpu/driver.py:480-518)
            c64 = _cast(cells, f64)
            nnion0 = ltepop_mod.get_nnion(dad, c64)
            nniontot = torch.clamp(nnion0.sum(dim=1), min=1e-300)
            if sfs.skip:
                sfs.sfst = {k: v for k, v in sfs.defaults.items() if k not in _SF_BOOKKEEPING}
            else:
                sfs.resolve(c64, nnion0, nniontot, torch.ones_like(c64.nne, dtype=torch.bool))
                sfs.keep = True
            t_e = thermalbalance_mod.call_t_e_finder(
                dad, rc, c64, opts, t_mid, ffheating_norm.to(f64),
                dep_heating.to(f64) * sfs.heatfrac(), bfheating_cells=bfh_otf)
            cells = _cast(ltepop_mod.calculate_ion_balance_nne(dad, c64.replace(Te=t_e), opts),
                          cells.Te.dtype)
        levelpops = ltepop_mod.calculate_levelpops(dad, cells, opts)
    if sfs is not None:
        extra.update(sfs.outputs(mode == "nlte"))
    nnion = ltepop_mod.get_nnion(dad, cells)
    chi_ff_part = opacity_mod.chi_ff_nnionpart_cells(dad, nnion, cells.Te)
    # the rate tables are float64 whatever the transport dtype: in cold,
    # nearly neutral cells (nne ~ 1e-36) the collisional and cooling rates
    # underflow float32 to zero, which would send every k-packet there to
    # free-free emission; the k-packet and macro-atom selections run in the
    # tables' dtype
    rates = transitionrates_mod.compute_process_rates(
        dad, rc, levelpops.to(f64), nnion.to(f64), cells.Te.to(f64), cells.TR.to(f64),
        cells.W.to(f64), cells.nne.to(f64), t_mid,
        corrphotoionrenorm=None if corrphotoionrenorm is None else corrphotoionrenorm.to(f64),
        jblue_normed=(None if jblue_normed is None
                      else (jblue_normed[0], jblue_normed[1].to(f64))),
        corr_photoion_cells=corr_otf)
    cells = cells.replace(totalcooling=rates.totalcooling.to(cells.Te.dtype),
                          ion_cooling_contribs=rates.ion_cooling.to(cells.Te.dtype))
    tau_sob = linewalk_mod.build_tau_factor(dad, levelpops)
    bf_a, bf_dep = opacity_mod.build_bf_tables(dad, levelpops, nnion, cells.nne,
                                               cells.nnetot, cells.Te)
    expo = None
    if opts.expansionopacities_on:
        kappa, pc = expo_mod.build_expansion_opacities(tau_sob, dad.line_nu, cells.rho,
                                                       cells.TR, t_mid)
        wcum = binoff = None
        if opts.rpkt_boundbound_thermalisation_probability < 0:
            # float64 whatever the transport dtype: a float32 cumulative over
            # ~1e5 lines keeps about 7 digits of the row's total, so a bin
            # whose lines weigh less than ~1e-7 of it would get no weight
            # (tests/test_torch_expansion.py). 988 cells x 101,010 lines
            # take 798 MB.
            wcum, binoff = expo_mod.build_line_selection(tau_sob.to(torch.float64),
                                                         dad.line_nu, t_mid)
        expo = (kappa, pc, wcum, binoff)
    return cells, levelpops, nnion, chi_ff_part, rates, tau_sob, bf_a, bf_dep, expo, extra


def sf_default_carry(ncells, nions, naug, nexc, device):
    """The Spencer-Fano state before any solve, float64: the values of a
    skipped solution (nonthermal.cc:2393-2419: the Axelrod heating fraction
    0.97 and zero eff_ionpot, so the ionisation rates fall back to the
    work function; frac_ionization 0 sends every deposit to heating), and
    the reuse bookkeeping (x_e at the last solve, its timestep;
    nonthermal.cc:2421-2442)."""
    f64 = torch.float64
    base = torch.zeros(naug, dtype=f64, device=device)
    base[0] = 1.0
    z = lambda *shape: torch.zeros(shape, dtype=f64, device=device)
    return dict(eff_ionpot=z(ncells, nions), frac_heating=z(ncells) + 0.97,
                frac_ionization=z(ncells), frac_excitation=z(ncells),
                frac_ion_by_ion=z(ncells, nions),
                prob_num_auger=base.expand(ncells, nions, naug).clone(),
                ionenfrac_num_auger=base.expand(ncells, nions, naug).clone(),
                exc_ratecoeff_perdep=z(ncells, max(nexc, 1)),
                exc_fracdep_cum=z(ncells, max(nexc, 1)),
                xe_when_solved=z(ncells) - 1.0,
                ts_last_solved=torch.full((ncells,), -1, dtype=torch.int64, device=device))


_SF_BOOKKEEPING = ("xe_when_solved", "ts_last_solved")


def _freeze_dict(mask, new, old):
    return {k: torch.where(mask.view((-1,) + (1,) * (new[k].dim() - 1)), new[k], old[k])
            for k in old}


class _SFState:
    """The non-thermal solver's state through one grid update (reference:
    nonthermal.cc:2391-2442; artis_tpu/driver.py:258-518): the solution in
    force per cell (``sfst``), x_e at its solve, and the solve count and
    seconds. In float64."""

    def __init__(self, dad, cells, opts, ntd, nt_wf, sf_carry, nts, nt_sf_skip,
                 num_lte_timesteps, dep_heating):
        self.dad, self.opts, self.ntd, self.nt_wf = dad, opts, ntd, nt_wf
        self.skip = nt_sf_skip
        self.dep = dep_heating.to(torch.float64)
        ncells, dev = cells.Te.shape[0], cells.Te.device
        self.nexc = ntd.nexc if (ntd is not None and opts.nt_excitation_on) else 1
        self.defaults = sf_default_carry(ncells, dad.nions_total, opts.nt_max_auger_electrons + 1,
                                         self.nexc, dev)
        self.solves, self.seconds = 0, 0.0
        self.nts = nts
        # the carried solution where still valid: a solution older than
        # sf_max_ts_between_solutions timesteps, or solved in the LTE
        # phase, gets x_e = -1, so that the x_e gate re-solves it
        # (nonthermal.cc:2432-2442)
        if sf_carry is None or ntd is None or nts is None:
            sf_carry = self.defaults
        self.sfst = {k: v for k, v in sf_carry.items() if k not in _SF_BOOKKEEPING}
        self.ts_last = sf_carry["ts_last_solved"]
        stale = ((nts - self.ts_last > opts.sf_max_ts_between_solutions)
                 | (self.ts_last <= num_lte_timesteps)) if nts is not None else True
        self.xe_last = torch.where(torch.as_tensor(stale, device=dev),
                                   torch.full_like(sf_carry["xe_when_solved"], -1.0),
                                   sf_carry["xe_when_solved"])
        self.solved = torch.zeros(ncells, dtype=torch.bool, device=dev)
        # whether the update returns a carry (the NLTE loop always does; the
        # pass without NLTE levels only when it solved)
        self.keep = False

    def _solve(self, c, nnion0):
        """A fresh Spencer-Fano solution of every cell of ``c``."""
        ntd, opts = self.ntd, self.opts
        boltz0 = ltepop_mod.calculate_levelpops(self.dad, c, opts)
        sf = nonthermal_mod.solve_spencerfano_cells(
            ntd, self.dad, boltz0, nnion0, c.nne,
            sf_auger_contribution_on=opts.sf_auger_contribution_on,
            nt_use_valence_ionpotential=opts.nt_use_valence_ionpotential)
        out = {k: v for k, v in self.defaults.items() if k not in _SF_BOOKKEEPING}
        for k in ("eff_ionpot", "frac_heating", "frac_ionization", "frac_excitation",
                  "frac_ion_by_ion", "prob_num_auger", "ionenfrac_num_auger"):
            out[k] = sf[k]
        if opts.nt_excitation_on and ntd.nexc > 0:
            out["exc_ratecoeff_perdep"] = sf["exc_ratecoeff_perdep"]
            # cumulative per-transition deposition fractions for the NT
            # excitation channel (nonthermal.cc:1608-1625 frac_deposition)
            fracdep = (boltz0[:, ntd.exc_lower] * ntd.exc_eps_ev[None, :] * EV
                       * out["exc_ratecoeff_perdep"])
            out["exc_fracdep_cum"] = torch.cumsum(fracdep, dim=1)
        return out

    def resolve(self, c, nnion0, nniontot, active):
        """Re-solve the active cells whose x_e moved by 5 % or more since
        their last solution (the NT_MAX_FRACDIFF_NNEPERION gate,
        nonthermal.cc:2426-2442), if any does."""
        if self.ntd is None or self.skip:
            return
        xe = c.nne / nniontot
        need = active & ((self.xe_last <= 0)
                         | (torch.abs(self.xe_last / torch.clamp(xe, min=1e-300) - 1.0) >= 0.05))
        if bool(need.any()):
            sync = c.Te.is_cuda
            if sync:
                torch.cuda.synchronize(c.Te.device)
            t0 = _time.time()
            self.sfst = _freeze_dict(need, self._solve(c, nnion0), self.sfst)
            if sync:
                torch.cuda.synchronize(c.Te.device)
            self.seconds += _time.time() - t0
            self.solves += 1
        self.xe_last = torch.where(need, xe, self.xe_last)
        self.solved = self.solved | need

    def _wf_rate(self, c, nniontot):
        """The work-function rate, Gamma = deposition / nnion_tot / W
        (nonthermal.cc:1172-1178, 2246-2269)."""
        wf_factor, elem_z = self.nt_wf
        zbar = torch.clamp((c.elem_massfrac.to(torch.float64) * elem_z[None, :]).sum(dim=1),
                           min=1e-30)
        r = (self.dep / nniontot / zbar)[:, None] * wf_factor[None, :]
        return torch.where(self.dep[:, None] > 0, r, torch.zeros_like(r))

    def ion_rate(self, c, nniontot):
        """Gamma_NT per ion [1/s]: the Spencer-Fano rate, the work-function
        one where that is not positive or not finite."""
        wf = self._wf_rate(c, nniontot) if self.nt_wf is not None else None
        if self.ntd is None:
            return wf
        rate = nonthermal_mod.nt_ionization_ratecoeff(self.dep, nniontot, self.sfst["eff_ionpot"])
        if wf is not None:
            rate = torch.where(torch.isfinite(rate) & (rate > 0), rate, wf)
        return rate

    def heatfrac(self):
        """The share of the deposition that heats the gas
        (thermalbalance.cc:135-241): the solution's, or 0.97 under the work
        function."""
        return self.sfst["frac_heating"] if self.ntd is not None else 0.97

    def outputs(self, nlte_mode: bool):
        """``extra`` entries of the update: the carry to keep, the split
        fractions for the transport (the defaults outside ``nlte``
        updates), the solve count and seconds."""
        if self.ntd is None:
            return {}
        if self.keep and self.nts is not None:
            ts_last = torch.where(self.solved, torch.full_like(self.ts_last, self.nts),
                                  self.ts_last)
            carry = dict(self.sfst, xe_when_solved=self.xe_last, ts_last_solved=ts_last)
        else:
            carry = None
        src = self.sfst if nlte_mode else self.defaults
        nt = {k: src[k] for k in ("frac_ion_by_ion", "frac_ionization", "frac_excitation",
                                  "ionenfrac_num_auger", "exc_fracdep_cum")}
        return dict(sf_carry=carry, nt=nt, sf_solves=self.solves, sf_seconds=self.seconds)


def _nlte_outer_loop(dad, rc, cells, opts, t_mid, ffheating_norm, dep_heating, nlte_indices,
                     bfrate_normed, jblue_normed, corr_otf, bfh_otf, sfs=None):
    """The NLTE outer loop of an ``nlte`` grid update (reference:
    update_grid.cc:670-763 solve_Te_nltepops): per iteration, with the
    non-thermal solver (``sfs``), the Spencer-Fano solve of the active cells
    whose x_e moved, then the T_e solve with the heating share of the
    deposition (each trial re-solving the Saha balance), the Saha balance
    at the new T_e, the NLTE populations from its Boltzmann populations
    (with the non-thermal ionisation and excitation rates), and the ion
    ground populations, partition functions and nne from the NLTE
    populations. A cell freezes once the larger of its fractional T_e and
    nne changes falls to ``nlte_convergence_tol``; grey cells are never
    solved. In float64. Returns (cells, levelpops, fracdiff, iterations)
    with the cells and populations in the cells' dtype."""
    f64 = torch.float64
    dtype = cells.Te.dtype
    c = _cast(cells, f64)
    ffh, dep = ffheating_norm.to(f64), dep_heating.to(f64)
    jbn = None if jblue_normed is None else (jblue_normed[0], jblue_normed[1].to(f64))
    bfr = None if bfrate_normed is None else bfrate_normed.to(f64)
    ncells = c.Te.shape[0]
    converged = c.thick == 1
    lp = ltepop_mod.calculate_levelpops(dad, c, opts)
    fracdiff = torch.zeros(ncells, dtype=f64, device=c.Te.device)
    iters = torch.zeros(ncells, dtype=torch.int64, device=c.Te.device)

    def freeze(mask, new, old):
        return dataclasses.replace(old, **{
            f.name: torch.where(mask.view((-1,) + (1,) * (getattr(new, f.name).dim() - 1)),
                                getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)})

    if sfs is not None:
        sfs.keep = True
    for it in range(max(opts.nlte_outer_iters, 1)):
        if bool(converged.all()):
            break
        active = ~converged
        nt = {}
        heatfrac = 1.0
        if sfs is not None:
            nnion0 = ltepop_mod.get_nnion(dad, c)
            nniontot = torch.clamp(nnion0.sum(dim=1), min=1e-300)
            sfs.resolve(c, nnion0, nniontot, active)
            heatfrac = sfs.heatfrac()
            nt = dict(nt_ion_rate=sfs.ion_rate(c, nniontot), nt_dep_rate_density=dep)
            if sfs.ntd is not None:
                nt.update(nt_prob_auger=sfs.sfst["prob_num_auger"], ntd=sfs.ntd,
                          nt_exc_perdep=(sfs.sfst["exc_ratecoeff_perdep"]
                                         if opts.nt_excitation_on else None))
        t_e = thermalbalance_mod.call_t_e_finder(dad, rc, c, opts, t_mid, ffh, dep * heatfrac,
                                                 bfheating_cells=bfh_otf)
        cn = ltepop_mod.calculate_ion_balance_nne(dad, c.replace(Te=t_e), opts)
        fd_te = torch.abs(cn.Te / torch.clamp(c.Te, min=1e-300) - 1.0)
        nne_saha = cn.nne
        cn, lp_n = nltepop_mod.solve_all_elements(
            nlte_indices, dad, rc, cn, opts, ltepop_mod.calculate_levelpops(dad, cn, opts), t_mid,
            bfrate_normed=bfr, jblue_normed=jbn, corr_photoion_cells=corr_otf, **nt)
        fd_new = torch.maximum(fd_te, torch.abs(cn.nne / torch.clamp(nne_saha, min=1e-300) - 1.0))
        c = freeze(active, cn, c)
        lp = torch.where(active[:, None], lp_n, lp)
        fracdiff = torch.where(active, fd_new, fracdiff)
        iters = torch.where(active, torch.full_like(iters, it + 1), iters)
        converged = converged | (fd_new <= opts.nlte_convergence_tol)
    return _cast(c, dtype), lp.to(dtype), fracdiff, iters


def _np(x):
    return x.detach().cpu().numpy()


def _ionstats_row(z, stage, row):
    """One ion's ``ionstats`` line of an estimator file (the JAX package's
    columns, artis_tpu/driver.py:2210-2219)."""
    return (f"ionstats Z {int(z)} ionstage {int(stage)} "
            f"photoion_mc {row[stats_mod.ION_PHOTOION]:g} ntion_mc {row[stats_mod.ION_NTION]:g} "
            f"bb_absorbed {row[stats_mod.ION_BOUNDBOUND_ABSORBED]:g} "
            f"bb_emitted {row[stats_mod.ION_BOUNDBOUND_MACROATOM]:g} "
            f"ma_energy_in {row[stats_mod.ION_MACROATOM_ENERGYIN_TOTAL]:g} "
            f"ma_energy_out {row[stats_mod.ION_MACROATOM_ENERGYOUT_TOTAL]:g}\n")


class Simulation:
    """Owns all static data and the evolving state of one run."""

    def __init__(self, rundir: str, opts: Options | None = None, datadir: str | None = None,
                 device="cuda", lockfile: bool = False, mesh=None):
        self.device = torch.device(device)
        self.rundir = rundir
        self.datadir = datadir or os.path.join(rundir, "data")
        if not os.path.isdir(self.datadir):
            self.datadir = rundir
        self.mesh = self._setup_mesh(mesh)
        # on a mesh rank 0 alone writes the run directory's files
        self._writes = self.mesh is None or self.mesh.rank == 0
        self._lockpath = None
        if lockfile and self._writes:
            self._acquire_lockfile()
        self.logfile = open(os.path.join(rundir, "output_0-0.txt"), "w") if self._writes else None
        self.log = (lambda msg: printout(self.logfile, msg)) if self._writes else (lambda msg: None)
        p = inputparams_io.read_parameterfile(os.path.join(rundir, "input.txt"))
        self.params = p
        self.opts = opts if opts is not None else kilonova_lte()
        engine_mod.check_supported(self.opts, p.opacity_case)
        self._check_mesh()
        if self.opts.transport_dtype not in ("float64", "float32"):
            raise ValueError(f"transport_dtype must be 'float64' or 'float32', "
                             f"got {self.opts.transport_dtype!r}")
        self._f32 = self.opts.transport_dtype == "float32"
        self.fdtype = torch.float32 if self._f32 else torch.float64
        dev = self.device
        self.ts = inputparams_io.time_init(
            p.tmin, p.tmax, p.ntimesteps, self.opts.timestep_size_method,
            self.opts.fixed_timestep_width, self.opts.timestep_transition_time)

        self.log("reading atomic data...")
        self.ad = atomicdata_io.read_atomicdata(
            rundir, single_level_top_ion=self.opts.single_level_top_ion,
            single_ground_level=self.opts.single_ground_level)
        from .plasma import recombcalibration as _recomb
        _sl_first = None
        if self.opts.nlte_enabled and not self.opts.nlte_all_levels:
            # the first superlevel member of an ion, as the JAX driver passes
            # it (artis_tpu/driver.py:677-688: the nlte_maxlevel cap)
            def _sl_first(element, ion, _ad=self.ad, _o=self.opts):
                nlev = int(_ad.ion_nlevels[int(_ad.elem_ion_start[element] + ion)])
                cap = min(_o.nlte_maxlevel, nlev)
                return cap + 1 if cap + 1 < nlev else None
        _recomb.apply_recombrate_calibration(self.ad, rundir,
                                             t_elec=self.opts.recombcalibration_t_elec,
                                             superlevel_first_level=_sl_first, log=self.log)
        # the grid update takes the atomic data in float64 whatever the
        # transport dtype: float32 level energies lose the small energy
        # differences of close levels in a large atom (260 levels per ion),
        # and the NLTE populations and T_e then go elsewhere than in float64
        # (tests/test_torch_nt_chains.py)
        self.dad_f64 = to_device(self.ad, dev)
        self.dad = demote_to_f32(self.dad_f64) if self._f32 else self.dad_f64
        self.log(f"nelements {self.ad.nelements} ions {self.ad.nions_total} "
                 f"levels {self.ad.nlevels_total} nlines {self.ad.nlines} "
                 f"nbfcontinua {self.ad.nbfcontinua}")

        self.model = model_io.read_model(os.path.join(rundir, "model.txt"), p.tmin)
        self.grid, self.grid_host = grid_mod.grid_init(
            self.model, p.tmin, self.opts.grid_type,
            (self.opts.ncoordgrid_x, self.opts.ncoordgrid_y, self.opts.ncoordgrid_z),
            with_host=True, device=dev)
        self.log(f"model dim {self.model.dim} npts {self.model.npts_model} "
                 f"grid {self.grid.ncoordgrid} nonempty {self.grid.nonempty_npts}")

        self.dec = decay_mod.init_nuclides(list(self.model.nuc_z), list(self.model.nuc_a),
                                           self.datadir)
        self.dec.t_model = self.model.t_model
        self.gamma = gammadata_io.init_gamma_data(self.dec, folder=rundir, datadir=self.datadir)
        self.log(f"nuclides {self.dec.num_nuclides} decaypaths {self.dec.npaths}")

        colmap = np.array([self.dec.get_nucindex(z, a)
                           for z, a in zip(self.model.nuc_z, self.model.nuc_a)])
        self.initnucmassfrac = np.zeros((self.model.npts_model, self.dec.num_nuclides))
        ok = colmap >= 0
        self.initnucmassfrac[:, colmap[ok]] = self.model.initnucmassfrac[:, ok]
        mgi_of_nonempty = self.grid_host.mgi_of_cell[self.grid_host.cell_of_nonemptymgi]
        self.mgi_of_nonempty = mgi_of_nonempty
        ncells = self.grid.nonempty_npts
        abund = model_io.read_abundances(os.path.join(rundir, "abundances.txt"),
                                         self.model.npts_model, self.model.first_cellindex)
        norm = abund.sum(axis=1)
        norm = np.where((self.model.dim == 3) | (norm <= 0), 1.0, norm)
        elem_total = abund[:, self.ad.elem_z - 1] / norm[:, None]
        iso_by_elem = np.zeros((self.model.npts_model, self.ad.nelements))
        for el, z in enumerate(self.ad.elem_z):
            sel = self.dec.nuc_z == z
            if sel.any():
                iso_by_elem[:, el] = self.initnucmassfrac[:, sel].sum(axis=1)
        self.stable_initabund_mgi = np.maximum(elem_total - iso_by_elem, 0.0)
        self.stable_initabund = self.stable_initabund_mgi[mgi_of_nonempty]

        self.log("building rate coefficient tables...")
        _rc_cache = os.environ.get("ARTIS_RATECOEFF_CACHE_DIR") or rundir
        os.makedirs(_rc_cache, exist_ok=True)
        # on a mesh rank 0 builds (and caches) the tables before the other
        # ranks read them
        if not self._writes:
            mesh_mod.barrier(self.mesh)
        self.rc = ratecoeff_mod.build_tables(
            self.dad, self.opts.tablesize, self.opts.mintemp, self.opts.maxtemp,
            self.opts.use_lut_photoion, self.opts.use_lut_bfheating, cache_dir=_rc_cache)
        if self.mesh is not None and self._writes:
            mesh_mod.barrier(self.mesh)
        self.aux = macroatom_mod.build_aux(self.dad)
        if self._f32:
            self.rc = demote_to_f32(self.rc)

        rho_tmin = self.model.rho_tmin[mgi_of_nonempty]
        self.rho_tmin_nonempty = rho_tmin
        self.cells = cellstate_mod.init_cellstate(
            self.dad, ncells, rho_tmin, self.model.ffegrp[mgi_of_nonempty],
            self.opts.mintemp, self.opts.maxtemp)
        self._calculate_kappagrey_initial()
        endecay = decay_mod.endecay_t0_to_time_withexpansion(
            self.dec, self.initnucmassfrac[mgi_of_nonempty], self.ts.mid[0])
        if (self.opts.initial_packets_on and self.opts.use_model_initial_energy
                and self.model.initenergyq is not None):
            endecay = endecay + self.model.initenergyq[mgi_of_nonempty]
        self.cells = cellstate_mod.assign_initial_temperatures(
            self.cells, self._t(rho_tmin), self._t(endecay), p.tmin,
            float(self.ts.mid[0]), self.opts.mintemp, self.opts.maxtemp)
        if self._f32:
            self.cells = demote_to_f32(self.cells)

        self.log("placing pellets...")
        self.pellet_tables = packets_mod.make_pellet_tables(
            self.grid, self.dec, self.initnucmassfrac, self.model.initenergyq, self.opts,
            p.tmin, p.tmax, grid_host=self.grid_host, device=dev)
        # packet energies live in units of e0 (erg values overflow float32)
        self._e0 = float(self.pellet_tables.e0)
        self.seed = p.pre_zseed if p.pre_zseed > 0 else 42
        # every rank builds the global initial packets and keeps its shard
        self.state = self._shard(packets_mod.packet_init((self.seed, 0), self.grid,
                                                         self.pellet_tables, self.opts,
                                                         device=dev))
        self.log(f"packets {self.opts.npkts} etot {self.pellet_tables.norm:g} erg")

        if self._writes:
            self._write_gridfiles()
        if self._writes and not p.simulation_continued_from_saved:
            self._write_listfiles()
            if self.opts.record_linestat:
                self._write_linestat_header()

        self.nlte_indices = (nltepop_mod.build_indices(self.dad_f64, self.opts)
                             if self.opts.nlte_enabled else None)
        # the non-thermal solver's tables from the data directory
        # (artis_tpu/driver.py:1021-1040), float64 whatever the transport dtype
        self.ntd = self.nt_wf = self._sf_carry = None
        if self.opts.nt_on:
            self.nt_wf = (self._t(nonthermal_mod.wf_oneoverw_factor(self.ad, self.dad, self.datadir),
                                  torch.float64),
                          self._t(self.ad.elem_z, torch.float64))
        if self.opts.nt_on and self.opts.nt_solve_spencerfano:
            t0 = _time.time()
            o = self.opts
            self.ntd = nonthermal_mod.build_nonthermal_data(
                self.ad, self.dad, self.datadir, sf_points=o.sf_points, sf_emin=o.sf_emin,
                sf_emax=o.sf_emax, nt_max_auger=o.nt_max_auger_electrons,
                maxnlevels_lower=o.ntexcitation_maxnlevels_lower,
                maxnlevels_upper=o.ntexcitation_maxnlevels_upper, device=dev)
            self.log(f"non-thermal solver: {self.ntd.nshells} shells, {self.ntd.nexc} excitation "
                     f"transitions, sf_points {o.sf_points}, tables built in "
                     f"{_time.time() - t0:.3f}s")
        # XCOM gamma photoionisation tables (gammapkt.cc:209-256;
        # artis_tpu/driver.py:971-980), float64 whatever the transport dtype,
        # with each element's row count; at least two columns
        self.xcom = None
        if self.opts.use_xcom_gammaphotoion:
            xe, xs, xl = gammadata_io.read_xcom_photoion(
                os.path.join(self.datadir, "xcom_photoion_data.txt"), list(self.ad.elem_z))
            if xe.shape[1] < 2:
                xe = np.pad(xe, ((0, 0), (0, 1)), constant_values=1e99)
                xs = np.pad(xs, ((0, 0), (0, 1)), constant_values=1e-99)
            self.xcom = (self._t(xe, torch.float64), self._t(xs, torch.float64),
                         torch.as_tensor(xl).long().to(dev))
            self.log(f"XCOM photoionisation tables: rows per element {xl.tolist()}")
        self._select_jblue_lines()
        # virtual packets: the configuration from vpkt.txt in the run
        # directory, else the default, and the accumulators' shapes
        # (artis_tpu/driver.py:1041-1084); the totals over the timesteps are
        # float64 on the host
        self.vpkt_cfg = None
        self._vspec_shape = self._vgrid_shape = (1, 1, 1, 1, 3)
        if self.opts.vpkt_on:
            o = self.opts
            path = os.path.join(rundir, "vpkt.txt")
            self.vpkt_cfg = (
                vpkt_mod.read_vpkt_config(path, p.tmin, p.tmax, o.vpkt_vmtbins, o.vpkt_vmnubins)
                if os.path.exists(path) else
                vpkt_mod.default_vpkt_config(p.tmin, p.tmax, o.vpkt_nobs, o.vpkt_vmtbins,
                                             o.vpkt_vmnubins))
            cfg = self.vpkt_cfg
            self._vspec_shape = (cfg.nobs, cfg.nspectra, o.vpkt_vmtbins, o.vpkt_vmnubins, 3)
            if cfg.vgrid_on:
                self._vgrid_shape = (cfg.nobs, int(cfg.vgrid_numin.shape[0]), cfg.vgrid_ny,
                                     cfg.vgrid_nz, 3)
            self.log(f"vpkt: {cfg.nobs} observers, {cfg.nspectra} spectra each"
                     + (f", velocity-grid maps {self._vgrid_shape}" if cfg.vgrid_on else ""))
        self._vspec_total = np.zeros(self._vspec_shape)
        self._vgrid_total = np.zeros(self._vgrid_shape)
        self.radfieldbin_tr = self.radfieldbin_w = None
        self.est = self._zero_est()
        self.prev_est: Estimators | None = None
        self.prev_bfrate_normed = None
        self.lc_lum = np.zeros(p.ntimesteps)
        self.lc_lumcmf = np.zeros(p.ntimesteps)
        self.gamma_dep_ts = np.zeros(p.ntimesteps)
        self.cmf_lum_ts = np.zeros(p.ntimesteps)
        self.dep_ts = {k: np.zeros(p.ntimesteps) for k in (
            "electron", "positron", "alpha", "electron_discrete", "positron_discrete",
            "alpha_discrete", "gamma_emission", "positron_emission", "electron_emission",
            "alpha_emission")}
        self.spec = spectrum_mod.init_spectra(self.opts.nu_min_r, self.opts.nu_max_r,
                                              p.ntimesteps)
        # per packet of this rank's shard
        self._escaped_counted = np.zeros(self.state.npkts, dtype=bool)
        vol_tmin_all = grid_mod.get_cell_volume_tmin(self.grid, self.grid_host)
        assoc_vol_mgi = np.zeros(self.grid.npts_model + 1)
        np.add.at(assoc_vol_mgi, self.grid_host.mgi_of_cell, vol_tmin_all)
        self._assoc_vol = assoc_vol_mgi
        self._assoc_vol_model = assoc_vol_mgi[: self.model.npts_model]
        m_cell = self.model.rho_tmin * self._assoc_vol_model
        self.mtot_input = float(m_cell.sum())
        # Barnes et al. 2016 time scales from the ejecta mass and kinetic
        # energy (artis_tpu/driver.py:985-999)
        npts = self.model.npts_model
        radial_pos_avg = (self.grid_host.initial_radial_pos_sum_mgi[:npts]
                          / np.maximum(self.grid_host.numpropcells_mgi[:npts], 1))
        e_kin = max(float(np.sum(0.5 * m_cell * (radial_pos_avg / p.tmin) ** 2)), 1e-30)
        mtot = max(self.mtot_input, 1e-30)
        self._barnes = (therm_mod.barnes_t_ineff(mtot, e_kin),
                        therm_mod.barnes_tau_ineff_particle(mtot, e_kin, alpha=False),
                        therm_mod.barnes_tau_ineff_particle(mtot, e_kin, alpha=True))
        self.gammaline_energy = self._t(self.gamma.line_energy)
        self.gammaline_cumfrac = self._t(self.gamma.line_cumfrac)
        self.gammaline_nlines = torch.as_tensor(np.asarray(self.gamma.nuc_nlines)).long().to(dev)
        self.total_rpkt_steps = 0
        self.total_transport_seconds = 0.0
        self.transport_log = []
        # the grid update, split over the mesh's ranks on a mesh (the JAX
        # driver swaps _plasma_jit for the cell-domain dispatch); the mesh's
        # collective seconds of the timestep
        self._mesh_timing = {}
        self._plasma_fn = (_plasma_update_device if self.mesh is None else
                           mesh_mod.make_plasma_dispatch(self.mesh, _plasma_update_device,
                                                         timing=self._mesh_timing))
        if p.simulation_continued_from_saved:
            self.log(f"resuming from checkpoint at timestep {p.timestep_start}")
            self.load_checkpoint(p.timestep_start)

    def close(self):
        """Close the run's log file (output_0-0.txt) and release the run
        directory's lockfile, if this run took it."""
        if self.logfile is not None:
            self.logfile.close()
        self._release_lockfile()

    def _setup_mesh(self, req):
        """The mesh of the run (reference: MPI inside every timestep,
        sn3d.cc:197-348; artis_tpu/driver.py:1106-1162): ``None`` runs on
        this process alone; ``"auto"`` the world the
        launcher started (``parallel.distributed``), if it has more than
        one rank; an int ``n`` a world of ``n`` ranks, which must have been
        started (``cli.main_sn3d --mesh n`` starts one; 1 or fewer: off);
        a ``parallel.mesh.Mesh`` is used as it is. A Simulation starts no
        process itself."""

        if req is None:
            return None
        if isinstance(req, mesh_mod.Mesh):
            dev = self.device
            if req.device.type != dev.type or (dev.index is not None
                                               and req.device.index != dev.index):
                raise ValueError(f"mesh on {req.device}, Simulation on {dev}")
            return req
        world = dist.get_world_size() if dist.is_initialized() else 1
        if req == "auto":
            return mesh_mod.make_mesh(self.device) if world > 1 else None
        n = int(req)
        if n <= 1:
            return None
        if n != world:
            raise ValueError(f"mesh={n} ranks requested but the world has {world} "
                             f"(start it with cli.main_sn3d --mesh {n}, torchrun or the "
                             f"ARTIS_* variables)")
        return mesh_mod.make_mesh(self.device)

    def _check_mesh(self):
        """The mesh run's conditions on the options
        (artis_tpu/driver.py:1140-1153)."""
        if self.mesh is None:
            return
        world = self.mesh.world
        if self.opts.npkts % world != 0:
            raise ValueError(f"npkts={self.opts.npkts} must divide the mesh size {world}")
        if self.opts.log_macroatom:
            # the event-row buffer is positional: a sum over ranks would add
            # unrelated rows (the reference's log is per rank too)
            self.opts = self.opts.replace(log_macroatom=False)
            self.log("WARNING: log_macroatom is single-device only; disabled for the mesh run")
        self.log(f"mesh: {world} ranks, packet axis {self.opts.npkts // world} packets/rank "
                 f"({self.mesh.backend}, rank 0 on {self.mesh.device})")

    def _shard(self, st):
        """This rank's shard of a global packet state (all of it off a
        mesh)."""
        return st if self.mesh is None else mesh_mod.shard_packets(st, self.mesh)

    def _global_packets(self):
        """(packet state, escaped-counted flags) in global packet order: on
        a mesh gathered to rank 0 (None on the others)."""
        if self.mesh is None:
            return self.state, self._escaped_counted
        st = mesh_mod.gather_packets(self.state, self.mesh)
        esc = mesh_mod.all_gather_rows(self.mesh, [torch.as_tensor(self._escaped_counted)],
                                       self.opts.npkts)[0].numpy()
        return st, (esc if st is not None else None)

    def _acquire_lockfile(self):
        """Guard against two drivers on one run directory (reference:
        check_already_running, sn3d.h:277-309; artis_tpu/driver.py:1943-1970):
        refuse to start when artis.pid names a process that is still alive;
        otherwise take the file over. Released by ``close`` or at exit (the
        exit hook holds the path alone, so that it keeps no run alive)."""
        import atexit
        import functools

        path = os.path.join(self.rundir, "artis.pid")
        if os.path.exists(path):
            try:
                oldpid = int(open(path).read().split()[0])
            except (ValueError, IndexError):
                oldpid = -1
            alive = False
            if oldpid > 0:
                try:
                    os.kill(oldpid, 0)
                    alive = True
                except (ProcessLookupError, PermissionError):
                    pass
            if alive:
                raise RuntimeError(f"ABORTING: another simulation (pid {oldpid}) is already "
                                   f"running in {self.rundir} (lockfile {path})")
        with open(path, "w") as f:
            f.write(f"{os.getpid()}\n")
        self._lockpath = path
        self._lock_release = functools.partial(_remove_pidfile, path)
        atexit.register(self._lock_release)

    def _release_lockfile(self):
        if self._lockpath:
            import atexit

            atexit.unregister(self._lock_release)
            _remove_pidfile(self._lockpath)
        self._lockpath = self._lock_release = None

    # ------------------------------------------------------------------
    def _t(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=self.device, dtype=dtype or self.fdtype)

    def _write_listfiles(self):
        """gammalinelist.out (gammapkt.cc:194-206) and bflist.out
        (input.cc:1373-1414)."""
        gd = self.gamma
        with open(os.path.join(self.rundir, "gammalinelist.out"), "w") as f:
            f.write("#index nucindex Z A nucgammmaindex en_gamma_mev gammaline_probability\n")
            for i in range(len(gd.sorted_energy)):
                ni = int(gd.sorted_nucindex[i])
                gi = int(gd.sorted_nucgammaindex[i])
                f.write(f"{i} {ni} {int(self.dec.nuc_z[ni])} {int(self.dec.nuc_a[ni])} {gi} "
                        f"{gd.sorted_energy[i] / MEV:g} {gd.line_prob[ni, gi]:g}\n")
        ad = self.ad
        with open(os.path.join(self.rundir, "bflist.out"), "w") as f:
            f.write(f"{ad.nbfcontinua}\n")
            if ad.nbfcontinua:
                cont_uii = ad.elem_ion_start[ad.cont_element].astype(np.int64) + ad.cont_ion
                lower_unique = ad.ion_level_start[cont_uii] + ad.cont_level
                for k, ci in enumerate(np.argsort(lower_unique, kind="stable")):
                    f.write(f"{k} {int(ad.cont_element[ci])} {int(ad.cont_ion[ci])} "
                            f"{int(ad.cont_level[ci])} {int(ad.cont_upperlevel[ci])}\n")

    def _write_gridfiles(self):
        """timesteps.out and grid.out."""
        p = self.params
        with open(os.path.join(self.rundir, "timesteps.out"), "w") as f:
            f.write("#timestep tstart_days tmid_days twidth_days\n")
            for n in range(p.ntimesteps):
                f.write(f"{n} {self.ts.start[n] / DAY:g} {self.ts.mid[n] / DAY:g} "
                        f"{self.ts.width[n] / DAY:g}\n")
        with open(os.path.join(self.rundir, "grid.out"), "w") as f:
            mgi_all = self.grid_host.mgi_of_cell
            for n in range(int(self.grid.ngrid)):
                if mgi_all[n] != self.model.npts_model:
                    f.write(f"{n} {int(mgi_all[n])}\n")

    def _write_linestat_header(self):
        """linestat.out's five header rows, one column per line: wavelength
        [cm], Z, ion stage, upper and lower level (1-based) (reference:
        sn3d.cc:64-98; artis_tpu/driver.py:877-893); ``do_timestep``
        appends each timestep's emission and absorption counts."""
        ad = self.ad
        uii = ad.elem_ion_start[ad.line_element] + ad.line_ion
        with open(os.path.join(self.rundir, "linestat.out"), "w") as f:
            for row in (CLIGHT / np.asarray(ad.line_nu), np.asarray(ad.elem_z)[ad.line_element],
                        _np(self.dad.ion_stage)[uii], np.asarray(ad.line_upper) + 1,
                        np.asarray(ad.line_lower) + 1):
                f.write(" ".join(f"{v:g}" for v in row) + "\n")

    def _calculate_kappagrey_initial(self):
        """Grey opacities at t=tmin (reference: grid.cc:1722-1834;
        artis_tpu/driver.py:1165-1216): case 0 the constant GREY_OP, cases 1
        and 4 the Fe-group weighting over the total masses, case 2 over the
        cell count, case 3 the same normalised by the density-weighted sum
        (``opcase3_normal``; ``update_grid`` switches it at rho_crit every
        timestep), case 5 by Y_e, case 6 Just et al. 2022 (recomputed every
        timestep); any other case GREY_OP."""
        p = self.params
        mgi = self.mgi_of_nonempty
        rho_tmin = self.model.rho_tmin[mgi]
        ffegrp = self.model.ffegrp[mgi]
        case = p.opacity_case
        if case == 0:
            kappa = np.full_like(rho_tmin, GREY_OP)
        elif case in (1, 4):
            vol = model_io.model_cell_volume_at_tmin(self.model, p.tmin)
            mtot = (self.model.rho_tmin * vol).sum()
            mfegroup = (self.model.rho_tmin * vol * self.model.ffegrp).sum()
            kappa = (0.9 * ffegrp + 0.1) * GREY_OP / (0.9 * mfegroup / mtot + 0.1)
        elif case == 2:
            opcase2_normal = GREY_OP * rho_tmin.sum() / (0.9 * ffegrp.sum()
                                                         + 0.1 * int(self.grid.ngrid))
            kappa = opcase2_normal / rho_tmin * (0.9 * ffegrp + 0.1)
        elif case == 3:
            kappagrey = 0.9 * ffegrp + 0.1
            self.opcase3_normal = GREY_OP * rho_tmin.sum() / (kappagrey * rho_tmin).sum()
            kappa = kappagrey * self.opcase3_normal
        elif case == 5:
            ye = (self.model.init_ye[mgi] if self.model.init_ye is not None
                  else np.full(len(mgi), 0.3))
            kappa = np.select([ye <= 0.1, ye <= 0.15, ye <= 0.2, ye <= 0.25, ye <= 0.3,
                               ye <= 0.35], [19.5, 32.2, 22.3, 5.6, 5.36, 3.3], default=0.96)
        elif case == 6:
            elem_massfrac0, _ = decay_mod.update_abundances(
                self.dec, self.initnucmassfrac[mgi], self.stable_initabund,
                self.ad.elem_meanweight_init, np.asarray(self.ad.elem_z), p.tmin)
            kappa = _kappagrey_just2022(self._lanthanide_massfrac(elem_massfrac0),
                                        _np(self.cells.TR))
        else:
            kappa = np.full_like(rho_tmin, GREY_OP)
        self._kappagrey_np = np.asarray(kappa, np.float64)
        self.cells = self.cells.replace(kappagrey=self._t(kappa, self.cells.rho.dtype))

    def _lanthanide_massfrac(self, elem_massfrac):
        zarr = np.asarray(self.ad.elem_z)
        lan = (zarr >= 57) & (zarr <= 71)
        return np.asarray(elem_massfrac)[:, lan].sum(axis=1)

    def _select_jblue_lines(self):
        """The lines of the detailed J_b_lu estimators (radfield.cc:520-552;
        artis_tpu/driver.py:904-926): lines with A > 0 out of lower levels up
        to ``jblue_max_lowerlevel``, of element Z = ``jblue_elem_z`` (0: all).
        Sets ``jblue_of_line`` (line -> column, -1 none) and ``_njblue``."""
        ad = self.ad
        if self.opts.detailed_line_estimators_on and ad.nlines > 0:
            line_z = np.asarray(ad.elem_z)[np.asarray(ad.line_element)]
            pick = ((np.asarray(ad.line_lower) <= self.opts.jblue_max_lowerlevel)
                    & (np.asarray(ad.line_A) > 0))
            if self.opts.jblue_elem_z > 0:
                pick &= line_z == self.opts.jblue_elem_z
            self.jblue_lineindices = np.nonzero(pick)[0]
            jb = np.full(ad.nlines, -1, np.int64)
            jb[self.jblue_lineindices] = np.arange(len(self.jblue_lineindices))
            self._njblue = max(len(self.jblue_lineindices), 1)
            self.log(f"detailed line estimators: {len(self.jblue_lineindices)} lines")
        else:
            self.jblue_lineindices = np.zeros(0, np.int64)
            jb = np.full(1, -1, np.int64)
            self._njblue = 1
        self.jblue_of_line = torch.as_tensor(jb).to(self.device)

    def _zero_est(self):
        # detailed bf-rate estimators: one row per nonempty cell, one column
        # per bf continuum; multibin rows per (cell, bin); J_b_lu rows per
        # (cell, selected line); the run diagnostics: per (cell, ion) stats,
        # per-line counts and the bounded macro-atom log
        # (artis_tpu/driver.py:893-953)
        ncells = self.grid.nonempty_npts
        o = self.opts
        bfr = o.detailed_bf_estimators_on
        jbl = o.detailed_line_estimators_on
        ist = o.track_ion_stats
        return zero_estimators(ncells, max(self.ad.nbfcontinua_ground, 1),
                               dtype=self.fdtype, device=self.device,
                               nradfieldbins=o.radfieldbincount if o.multibin_radfield else 1,
                               nbfrate=max(self.ad.nbfcontinua, 1) if bfr else 1,
                               nbfrate_cells=ncells if bfr else 1,
                               njblue=self._njblue if jbl else 1,
                               njblue_cells=ncells if jbl else 1,
                               nion_stats_cells=ncells if ist else 1,
                               nion_stats_ions=max(self.ad.nions_total, 1) if ist else 1,
                               nion_stats=stats_mod.N_ION_STATS if ist else 1,
                               nlinestat=max(self.ad.nlines, 1) if o.record_linestat else 1,
                               nmalog=max(o.log_macroatom_capacity, 1) if o.log_macroatom else 1,
                               vspec_shape=self._vspec_shape, vgrid_shape=self._vgrid_shape)

    # ------------------------------------------------------------------
    def _plasma_call(self, nts: int):
        """Normalise the previous timestep's estimators and run the grid
        update. Returns (mode, results)."""
        p = self.params
        ncells = self.grid.nonempty_npts
        mgi = self.mgi_of_nonempty
        prev_est = self.prev_est
        first_ts = prev_est is None
        zeros = torch.zeros(ncells, dtype=self.fdtype, device=self.device)
        gammaest_norm = bfrate_normed = jblue_normed = None
        binj_norm = binnuj_norm = bincount = None
        if first_ts:
            j_norm = nuj_norm = ffheating_norm = dep_heating = zeros
            mode = "first"
        else:
            nts_prev = nts - 1
            deltat = float(self.ts.width[nts_prev])
            deltav = self._assoc_vol[mgi] * (float(self.ts.mid[nts_prev]) / p.tmin) ** 3
            norm4pi = self._e0 * ONEOVER4PI / (deltav * deltat)
            n4 = self._t(norm4pi)
            j_norm = prev_est.j * n4
            nuj_norm = prev_est.nuj * n4
            ffheating_norm = prev_est.ffheating * self._t(norm4pi * FOURPI)
            dep_heating = (prev_est.dep_gamma + prev_est.dep_positron + prev_est.dep_electron
                           + prev_est.dep_alpha) * self._t(norm4pi * FOURPI)
            if (self.opts.detailed_bf_estimators_on
                    and nts >= self.opts.detailed_bf_estimators_usefromtimestep):
                # bfrate_raw * estimator_normfactor / H (radfield.cc:946;
                # artis_tpu/driver.py:1305-1316), for the NLTE solve
                self.prev_bfrate_normed = prev_est.bfrate * self._t(norm4pi * FOURPI / H)[:, None]
                bfrate_normed = self.prev_bfrate_normed
            if self.opts.multibin_radfield:
                # J and nuJ per bin * estimator_normfactor_over4pi, raw counts
                # (artis_tpu/driver.py:1286-1295)
                binj_norm = prev_est.radfieldbin_j * n4[:, None]
                binnuj_norm = prev_est.radfieldbin_nuj * n4[:, None]
                bincount = prev_est.radfieldbin_count
            if self.opts.detailed_line_estimators_on:
                # prev_Jb_lu_normed = raw * estimator_normfactor_over4pi
                # (radfield.cc:919; artis_tpu/driver.py:1319-1327)
                jblue_normed = (self.jblue_of_line, prev_est.jblue_raw * n4[:, None])
            if self.opts.use_lut_photoion:
                # photoionisation rate estimator * normfactor / H
                # (artis_tpu/driver.py:1296-1304)
                gammaest_norm = prev_est.gammaestimator * self._t(norm4pi * FOURPI / H)[:, None]
            lte_mode = nts < p.num_lte_timesteps
            mode = "lte" if lte_mode or bool(np.all(_np(self.cells.thick) == 1)) else "nlte"
        results = self._plasma_fn(
            self.dad_f64, self.rc, self.cells, self.opts, j_norm, nuj_norm,
            float(self.ts.mid[nts]), ffheating_norm, dep_heating, mode=mode,
            gammaest_norm=gammaest_norm, binj_norm=binj_norm, binnuj_norm=binnuj_norm,
            bincount=bincount, bfrate_normed=bfrate_normed, jblue_normed=jblue_normed,
            radfield_use_bins=nts >= self.opts.first_nlte_radfield_timestep,
            nlte_indices=self.nlte_indices, ntd=self.ntd, nt_wf=self.nt_wf,
            sf_carry=self._sf_carry, nts=nts, nt_sf_skip=nts == p.num_lte_timesteps,
            num_lte_timesteps=int(p.num_lte_timesteps))
        return mode, results

    def update_grid(self, nts: int):
        """Per-timestep plasma update (reference: update_grid.cc:869-1072).
        Returns the StepContext of the timestep."""
        p = self.params
        tmid = float(self.ts.mid[nts])
        tratmid = tmid / p.tmin
        mgi = self.mgi_of_nonempty
        rho = self.rho_tmin_nonempty / tratmid**3
        self.cells = self.cells.replace(rho=self._t(rho))
        if p.opacity_case == 3:
            # the critical density where tau_sobolev(3000 A) is 1 at t_mid:
            # above it kappagrey leaves the rho-independent regime for
            # kappagrey * rho = const (update_grid.cc:1090-1097, 893-907;
            # artis_tpu/driver.py:1411-1423)
            self.rho_crit = (ME * CLIGHT * 56.0 * MH
                             / (PI * QE**2 * p.rho_crit_para * 3000e-8 * tmid))
            kgrey = self.opcase3_normal * (0.9 * self.model.ffegrp[mgi] + 0.1)
            kgrey = np.where(rho > self.rho_crit, kgrey * self.rho_crit / rho, kgrey)
            self._kappagrey_np = np.asarray(kgrey)
            self.cells = self.cells.replace(kappagrey=self._t(kgrey))
            self.log(f"timestep {nts}: rho_crit {self.rho_crit!r} g/cm^3, "
                     f"{int((rho > self.rho_crit).sum())} of {rho.size} cells above it")
        elem_massfrac, elem_meanweight = decay_mod.update_abundances(
            self.dec, self.initnucmassfrac[mgi], self.stable_initabund,
            self.ad.elem_meanweight_init, np.asarray(self.ad.elem_z), tmid)
        self.cells = self.cells.replace(elem_massfrac=self._t(elem_massfrac),
                                        elem_meanweight=self._t(elem_meanweight))
        self.cells = self.cells.replace(nnetot=cellstate_mod.calculate_nnetot(self.cells, self.dad))
        if p.opacity_case == 6:
            kgrey6 = _kappagrey_just2022(self._lanthanide_massfrac(elem_massfrac),
                                         _np(self.cells.TR))
            self._kappagrey_np = np.asarray(kgrey6)
            self.cells = self.cells.replace(kappagrey=self._t(kgrey6))

        mode, results = self._plasma_call(nts)
        self.plasma_mode = mode
        (self.cells, levelpops, nnion, chi_ff_part, self.rates, tau_sob, bf_a,
         bf_dep, expo, extra) = results
        if self.opts.multibin_radfield:
            zb = torch.zeros((self.grid.nonempty_npts, self.opts.radfieldbincount),
                             dtype=torch.float64, device=self.device)
            self.radfieldbin_tr = zb if extra["tr_bins"] is None else extra["tr_bins"]
            self.radfieldbin_w = zb if extra["w_bins"] is None else extra["w_bins"]
        self.nlte_iters = None
        self.sf_solves, self.sf_seconds = extra["sf_solves"], extra["sf_seconds"]
        if extra["sf_carry"] is not None:
            self._sf_carry = extra["sf_carry"]
        if self.ntd is not None and mode == "nlte":
            self.log(f"timestep {nts}: Spencer-Fano {self.sf_solves} solves in "
                     f"{self.sf_seconds:.4f}s")
        if extra["nlte_fracdiff"] is not None:
            fdmax = float(extra["nlte_fracdiff"].max())
            self.nlte_iters = int(extra["nlte_iters"].max())
            tol = self.opts.nlte_convergence_tol
            # a cell stops short of tol only at the iteration cap
            self.log(f"timestep {nts}: NLTE outer loop max fracdiff {fdmax:.4g} after <= "
                     f"{self.nlte_iters} iterations"
                     + ("" if fdmax <= tol else
                        f" (stopped at the nlte_outer_iters cap "
                        f"({max(self.opts.nlte_outer_iters, 1)}), not converged to {tol})"))

        # grey optical depth and thick flags (update_grid.cc:1007-1035)
        assoc_cells = self.grid_host.numpropcells_mgi[mgi]
        radial_pos = self.grid_host.initial_radial_pos_sum_mgi[mgi] * tratmid / assoc_cells
        dist_to_obs = np.maximum(0.0, self.grid.rmax * tratmid - radial_pos)
        grey_depth = self._kappagrey_np * rho * dist_to_obs
        # 1: grey transport; 2: vpkt-only thick (virtual packets die there,
        # real packets transport in full; artis_tpu/driver.py:1478-1489)
        grey1 = (grey_depth >= p.cell_is_optically_thick) & (nts < p.num_grey_timesteps)
        thick = grey1.astype(np.int64)
        if self.vpkt_cfg is not None:
            tv = (self.vpkt_cfg.thick_vpkt if self.vpkt_cfg.thick_vpkt >= 0
                  else p.cell_is_optically_thick)
            thick[~grey1 & (grey_depth > tv)] = 2
        self.cells = self.cells.replace(
            thick=torch.as_tensor(thick).to(self.device), grey_depth=self._t(grey_depth))
        self._last_levelpops = levelpops
        dev, fd = self.device, self.fdtype
        one = torch.zeros(1, dtype=fd, device=dev)
        onei = torch.zeros(1, dtype=torch.int64, device=dev)
        ncells = self.grid.nonempty_npts
        rho_mgi = np.concatenate([self.model.rho_tmin, [0.0]])
        kappa, pc, wcum, binoff = expo if expo is not None else (one, one, None, None)
        nt = extra["nt"] or dict(frac_ion_by_ion=one, frac_ionization=one,
                                      frac_excitation=one, ionenfrac_num_auger=one,
                                      exc_fracdep_cum=one)
        nt_exc_upper = (self.ntd.exc_upper if self.ntd is not None and self.opts.nt_excitation_on
                        else onei)
        vcum_tau = vcum_taunu = one
        if self.vpkt_cfg is not None:
            # the cumulative line tables of the vpkt segment tau, float64
            # (vpkt.build_vpkt_tables; artis_tpu/driver.py:558-561)
            vcum_tau, vcum_taunu = vpkt_mod.build_vpkt_tables(tau_sob, self.dad_f64,
                                                              exclude=self.vpkt_cfg.exclude)
        return engine_mod.StepContext(
            levelpops=levelpops, nnion=nnion, chi_ff_nnionpart=chi_ff_part,
            tau_sob_factor=tau_sob, bf_a=bf_a, bf_dep=bf_dep,
            expopac_kappa=kappa, expopac_planck_cum=pc,
            expopac_wcum=one if wcum is None else wcum,
            expopac_binoffsets=onei if binoff is None else binoff,
            elem_numberdens=(self.cells.elem_massfrac.double() * self.cells.rho.double()[:, None]
                             / self.cells.elem_meanweight.double()
                             if self.xcom is not None
                             else torch.zeros((ncells, 1), dtype=fd, device=dev)),
            xcom_energy=self.xcom[0] if self.xcom is not None else one,
            xcom_sigma=self.xcom[1] if self.xcom is not None else one,
            xcom_nrows=self.xcom[2] if self.xcom is not None else None,
            vpkt_cum_tau=vcum_tau, vpkt_cum_taunu=vcum_taunu, vpkt_cfg=self.vpkt_cfg,
            nt_frac_ion_by_ion=nt["frac_ion_by_ion"],
            nt_frac_ionization=nt["frac_ionization"], nt_ionenfrac_auger=nt["ionenfrac_num_auger"],
            nt_frac_excitation=nt["frac_excitation"], nt_exc_fracdep_cum=nt["exc_fracdep_cum"],
            nt_exc_upper=nt_exc_upper,
            nt_ion_topion=self.ntd.ion_topion if self.ntd is not None else onei,
            jblue_of_line=self.jblue_of_line,
            gammaline_energy=self.gammaline_energy, gammaline_cumfrac=self.gammaline_cumfrac,
            gammaline_nlines=self.gammaline_nlines,
            nuc_engamma=self._t(self.dec.nuc_endecay_gamma),
            barnes_t_ineff=self._t(self._barnes[0]),
            barnes_tau_ineff_lepton=self._t(self._barnes[1]),
            barnes_tau_ineff_alpha=self._t(self._barnes[2]),
            rho_t_mgi=self._t(rho_mgi * (p.tmin / tmid) ** 3), rho_tmin_mgi=self._t(rho_mgi),
            tmin=float(p.tmin), ts=float(self.ts.start[nts]),
            t2=float(self.ts.start[nts] + self.ts.width[nts]), t_mid=tmid,
            is_first_timestep=nts == 0)

    # ------------------------------------------------------------------
    def _transport_kwargs(self, nts: int):
        p = self.params
        return dict(gamma_kappagrey=float(p.gamma_kappagrey), opacity_case=int(p.opacity_case),
                    kpktdiffusion_timescale=float(p.kpktdiffusion_timescale),
                    apply_kpkt_diffusion=bool(nts < p.n_kpktdiffusion_timesteps))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def do_timestep(self, nts: int):
        self._mesh_timing.clear()
        t0 = _time.time()
        ctx = self.update_grid(nts)
        self._sync()
        dt_grid = _time.time() - t0
        self.log(f"timestep {nts}: grid update ({self.plasma_mode}) took {dt_grid}s")
        self.est = self._zero_est()
        t0 = _time.time()
        n_act0 = int((self.state.ptype != TYPE_ESCAPE).sum())
        args = ((self.seed, 1000 + nts), self.state, self.est, self.grid, self.dad, self.aux,
                self.rc, self.rates, self.cells, ctx, self.opts)
        kw = dict(wall_budget=self.opts.transport_wall_budget, **self._transport_kwargs(nts))
        if self.mesh is None:
            self.state, self.est, iters, nsteps = engine_mod.transport_timestep(*args, **kw)
        else:
            # each rank stops at its own wall budget or iteration cap; the
            # log and the record count the world's packets
            launched = dict(rpkt_kernel.propagate.launches)
            self.state, self.est, iters, nsteps = mesh_mod.transport_timestep_sharded(
                self.mesh, *args, timing=self._mesh_timing, **kw)
            launched = {k: v - launched[k] for k, v in rpkt_kernel.propagate.launches.items()
                        if v != launched[k]}
        n_act = int(((self.state.prop_time < ctx.t2) & (self.state.ptype != TYPE_ESCAPE)).sum())
        self._sync()
        dt_transport = _time.time() - t0
        n_act0, n_act, n_escaped = self._bin_timestep([n_act0, n_act])
        completed = n_act == 0
        if not completed:
            self.log(f"timestep {nts}: transport stopped after {iters} iterations with {n_act} "
                     f"packets still active (wall budget or iteration cap)")
        self.log(f"timestep {nts}: transport took {dt_transport:.1f}s ({iters} wavefront "
                 f"iterations, {nsteps} rpkt steps, "
                 f"{nsteps / max(dt_transport, 1e-9):.3g} rpkt steps/s)")
        self.total_rpkt_steps += nsteps
        self.total_transport_seconds += dt_transport
        rec = dict(nts=nts, steps=nsteps, seconds=dt_transport, iters=iters,
                   active_start=n_act0, completed=completed, grid_mode=self.plasma_mode,
                   grid_seconds=dt_grid, nlte_iters=self.nlte_iters, sf_solves=self.sf_solves,
                   sf_seconds=self.sf_seconds)
        if self.mesh is not None:
            # the collectives' wall seconds on rank 0: the estimators'
            # all-reduce (with the transport) and the grid update's gather;
            # each rank's kernel launches in its transport, by configuration
            rank_launches = [None] * self.mesh.world
            dist.all_gather_object(rank_launches, launched, group=self.mesh.group)
            rec.update(ranks=self.mesh.world,
                       allreduce_seconds=self._mesh_timing.get("allreduce_seconds", 0.0),
                       allgather_seconds=self._mesh_timing.get("allgather_seconds", 0.0),
                       rank_launches=rank_launches)
            self.log(f"timestep {nts}: mesh of {self.mesh.world} ranks: all-reduce "
                     f"{rec['allreduce_seconds']}s, all-gather {rec['allgather_seconds']}s")
        self.transport_log.append(rec)
        self.prev_est = self.est
        e = self.est
        if self.vpkt_cfg is not None:
            self._vspec_total = self._vspec_total + _np(e.vspec).astype(np.float64)
            self._vgrid_total = self._vgrid_total + _np(e.vgrid).astype(np.float64)
        self.gamma_dep_ts[nts] = float(e.dep_gamma.sum()) * self._e0
        self.cmf_lum_ts[nts] = float(e.cmf_lum) * self._e0
        for k, v in (("electron", e.dep_electron.sum()), ("positron", e.dep_positron.sum()),
                     ("alpha", e.dep_alpha.sum()), ("electron_discrete", e.electron_dep_discrete),
                     ("positron_discrete", e.positron_dep_discrete),
                     ("alpha_discrete", e.alpha_dep_discrete),
                     ("gamma_emission", e.gamma_emission),
                     ("positron_emission", e.positron_emission),
                     ("electron_emission", e.electron_emission),
                     ("alpha_emission", e.alpha_emission)):
            self.dep_ts[k][nts] = float(v) * self._e0

        if not self._writes:
            return
        if self.opts.write_estimator_files:
            self.write_estimators(nts)
            if self.opts.nlte_enabled:
                self.write_nltepops(nts)
            if self.opts.multibin_radfield:
                self.write_radfield(nts)
        if self.opts.record_linestat:
            # this timestep's emission and absorption counts per line
            # (sn3d.cc:640-660)
            with open(os.path.join(self.rundir, "linestat.out"), "a") as f:
                for row in (_np(self.est.line_emisscount), _np(self.est.line_absorbcount)):
                    f.write(" ".join(str(int(v)) for v in row) + "\n")
        if self.opts.log_macroatom:
            self.write_macroatom_log(nts)
        counter_txt = stats_mod.format_counters(self.est.counters)
        if counter_txt:
            self.log(f"timestep {nts} event counters:\n{counter_txt}")
        self.log(f"timestep {nts}: escaped rpkts so far {n_escaped} "
                 f"(cmf_lum {self.cmf_lum_ts[nts] / LSUN / max(float(self.ts.width[nts]), 1e-30):.3e} Lsun)")

    def _bin_timestep(self, counts):
        """Bin the packets that escaped this timestep into the light curve
        and spectra, and count the escaped packets so far. Returns
        ``counts`` and that count. On a mesh each rank bins its own escapes
        into deltas, which are summed over the ranks with ``counts`` and
        the escaped count in one reduction, so every rank holds the world's
        light curve, spectra and counts."""
        st = self.state
        esc = ((_np(st.ptype) == TYPE_ESCAPE) & (_np(st.escape_type) == TYPE_RPKT)
               & ~self._escaped_counted)
        lum, lumcmf = np.zeros_like(self.lc_lum), np.zeros_like(self.lc_lumcmf)
        spec = spectrum_mod.init_spectra(self.opts.nu_min_r, self.opts.nu_max_r,
                                         self.params.ntimesteps)
        if esc.any():
            self._bin_escaped(esc, lum, lumcmf, spec)
        parts = [torch.from_numpy(a) for a in (lum, lumcmf, spec.flux)] + [
            torch.tensor(list(counts) + [int(self._escaped_counted.sum())])]
        if self.mesh is not None:
            parts = mesh_mod.all_reduce(self.mesh, parts)
        for arr, delta in zip((self.lc_lum, self.lc_lumcmf, self.spec.flux), parts):
            arr += delta.numpy()
        return [int(v) for v in parts[-1]]

    def _bin_escaped(self, esc, lum, lumcmf, spec):
        """Bin the packets ``esc`` picks (escaped this timestep) into the
        light curve ``lum`` / ``lumcmf`` and the spectra ``spec``, and count
        them as escaped."""
        p, st = self.params, self.state
        pos = _np(st.pos).astype(np.float64)[esc]
        dirv = _np(st.dir).astype(np.float64)[esc]
        esct = _np(st.escape_time).astype(np.float64)[esc]
        nurf = _np(st.nu_rf).astype(np.float64)[esc]
        erf = _np(st.e_rf).astype(np.float64)[esc] * self._e0
        ecmf = _np(st.e_cmf).astype(np.float64)[esc] * self._e0
        spectrum_mod.add_packets_to_lightcurve(lum, lumcmf, pos, dirv, esct, erf, ecmf,
                                               self.ts.start[:-1], p.tmin, p.tmax,
                                               self.grid.vmax)
        spectrum_mod.add_packets_to_spectra(spec, pos, dirv, esct, nurf, erf,
                                            self.ts.start[:-1], p.tmin, p.tmax)
        self._escaped_counted |= esc

    # ------------------------------------------------------------------
    def run(self, walltime_hours: float = -1.0):
        """Main timestep loop with walltime-aware soft exit
        (reference: sn3d.cc:879-922, 398-425)."""
        p = self.params
        start_wall = _time.time()
        ts_durations = []
        for nts in range(p.timestep_start, p.timestep_finish):
            ts_t0 = _time.time()
            self.do_timestep(nts)
            ts_durations.append(_time.time() - ts_t0)
            self.write_outputs(partial=True)
            if nts < p.timestep_finish - 1:
                self.save_checkpoint(nts + 1)
            if walltime_hours > 0:
                remaining = walltime_hours * 3600 - (_time.time() - start_wall)
                stop = remaining < 1.5 * max(ts_durations)
                if self.mesh is not None:
                    # every rank stops when one would
                    stop = bool(mesh_mod.all_reduce(self.mesh, [torch.tensor([int(stop)])],
                                                    dist.ReduceOp.MAX)[0])
                if stop:
                    self.log(f"RESTART_NEEDED: walltime insufficient for timestep {nts + 1}")
                    return
        self.finish()

    def save_checkpoint(self, next_nts: int):
        """Checkpoint packets + the carried simulation state and rewrite
        input.txt to resume at next_nts (reference: sn3d.cc:427-487); same
        file layout as the JAX package (packets_0000_ts<n>.npz and
        gridsave_ts<n>.npz). The packet file is written up to three times,
        each read back and compared (sn3d.cc:356-375 write retry loop,
        packet.cc:205-233 VERIFY_WRITTEN_PACKETS_FILES;
        artis_tpu/driver.py:2009-2025); the third failure raises. On a mesh
        rank 0 writes the packets in global order (the other ranks' shards
        gathered to it) and the escaped-packet flags likewise."""
        st, escaped = self._global_packets()
        if not self._writes:
            return
        pktpath = os.path.join(self.rundir, f"packets_0000_ts{next_nts}.npz")
        for attempt in range(CHECKPOINT_ATTEMPTS):
            try:
                packets_mod.save_packets_npz(pktpath, st)
                reread = packets_mod.load_packets_npz(pktpath)
                if np.array_equal(_np(reread.e_cmf), _np(st.e_cmf)):
                    break
                raise IOError("packet file read-back mismatch")
            except Exception as exc:  # noqa: BLE001 - a full disk or a network file system
                self.log(f"packet checkpoint write attempt {attempt} failed: {exc}")
                _time.sleep(CHECKPOINT_RETRY_S * (1 + attempt))
        else:
            raise IOError(f"could not write packet checkpoint {pktpath}")
        blob = {f"cells_{f.name}": _np(getattr(self.cells, f.name))
                for f in dataclasses.fields(self.cells)}
        if self.prev_est is not None:
            for f in dataclasses.fields(self.prev_est):
                blob[f"est_{f.name}"] = _np(getattr(self.prev_est, f.name))
        for k, v in self.dep_ts.items():
            blob[f"dep_ts_{k}"] = v
        # the carried Spencer-Fano solution, for a bit-exact resume
        # (artis_tpu/driver.py:2034-2039)
        for k, v in (self._sf_carry or {}).items():
            blob[f"sfcarry_{k}"] = _np(v)
        np.savez_compressed(
            os.path.join(self.rundir, f"gridsave_ts{next_nts}.npz"),
            lc_lum=self.lc_lum, lc_lumcmf=self.lc_lumcmf, gamma_dep_ts=self.gamma_dep_ts,
            cmf_lum_ts=self.cmf_lum_ts, escaped_counted=escaped,
            spec_flux=self.spec.flux, vspec_total=self._vspec_total,
            vgrid_total=self._vgrid_total, **blob)
        inputparams_io.update_parameterfile(os.path.join(self.rundir, "input.txt"), next_nts,
                                            self.params.timestep_finish, 1)
        for prefix in ("packets_0000_ts", "gridsave_ts"):
            path = os.path.join(self.rundir, f"{prefix}{next_nts - 1}.npz")
            if os.path.exists(path):
                os.remove(path)

    def load_checkpoint(self, nts: int):
        """Resume from a checkpoint (reference: grid.cc:825-916); with the
        counter-derived random numbers the resumed run is bit-exact. On a
        mesh every rank takes its shard of the packets."""
        dev = self.device
        self.state = self._shard(packets_mod.load_packets_npz(
            os.path.join(self.rundir, f"packets_0000_ts{nts}.npz"), device=dev))
        g = np.load(os.path.join(self.rundir, f"gridsave_ts{nts}.npz"))

        def t(a, like):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=like.dtype)

        self.cells = self.cells.replace(**{
            f.name: t(g[f"cells_{f.name}"], getattr(self.cells, f.name))
            for f in dataclasses.fields(self.cells) if f"cells_{f.name}" in g})
        est = self._zero_est()
        if "est_j" in g:
            est = est.replace(**{f.name: t(g[f"est_{f.name}"], getattr(est, f.name))
                                 for f in dataclasses.fields(est) if f"est_{f.name}" in g})
        self.prev_est = est
        self.lc_lum = g["lc_lum"]
        self.lc_lumcmf = g["lc_lumcmf"]
        self.gamma_dep_ts = g["gamma_dep_ts"]
        self.cmf_lum_ts = g["cmf_lum_ts"]
        escaped = g["escaped_counted"]
        self._escaped_counted = (escaped if self.mesh is None
                                 else escaped[mesh_mod.shard_slice(escaped.shape[0], self.mesh)])
        self.spec.flux[:] = g["spec_flux"]
        for k in self.dep_ts:
            if f"dep_ts_{k}" in g:
                self.dep_ts[k] = g[f"dep_ts_{k}"]
        if "vspec_total" in g:
            self._vspec_total = np.asarray(g["vspec_total"], dtype=np.float64)
            self._vgrid_total = np.asarray(g["vgrid_total"], dtype=np.float64)
        sfkeys = [k for k in g.files if k.startswith("sfcarry_")]
        if sfkeys:
            self._sf_carry = {k[len("sfcarry_"):]: torch.as_tensor(g[k]).to(dev) for k in sfkeys}

    def finish(self):
        """Final outputs: packets file for exspec (reference: sn3d.cc:860-877),
        on a mesh rank 0's of the gathered packets, in global order."""
        st, _ = self._global_packets()
        if not self._writes:
            return
        packets_mod.write_packets_text(os.path.join(self.rundir, "packets00_0000.out"),
                                       st, e_scale=self._e0)
        if self.vpkt_cfg is not None:
            vpkt_mod.write_vspecpol(os.path.join(self.rundir, "specpol_virtual.out"),
                                    self.vpkt_cfg, self._vspec_total * self._e0)
            if self.vpkt_cfg.vgrid_on:
                vpkt_mod.write_vpkt_grid(os.path.join(self.rundir, "vpkt_grid.out"),
                                         self.vpkt_cfg, self._vgrid_total * self._e0,
                                         float(self.grid.vmax))
        self.write_outputs(partial=False)

    def write_deposition(self):
        """deposition.out in the reference's 22-column layout (sn3d.cc:157-191)."""
        p = self.params
        path = os.path.join(self.rundir, "deposition.out")
        mtot = max(self.mtot_input, 1e-30)
        m_cell = self.model.rho_tmin * self._assoc_vol_model
        with open(path + ".tmp", "w") as f:
            f.write(
                "#ts tmid_days tmid_s total_dep_Lsun gammadep_discrete_Lsun gammadep_Lsun "
                "positrondep_Lsun eps_positron_ana_Lsun elecdep_Lsun eps_elec_Lsun "
                "eps_elec_ana_Lsun alphadep_Lsun eps_alpha_Lsun eps_alpha_ana_Lsun "
                "eps_gamma_Lsun Qdot_betaminus_ana_erg/s/g Qdotalpha_ana_erg/s/g "
                "eps_erg/s/g Qdot_ana_erg/s/g positrondep_discrete_Lsun "
                "elecdep_discrete_Lsun alphadep_discrete_Lsun\n")
            for i in range(p.ntimesteps):
                tmid = float(self.ts.mid[i])
                tw = max(float(self.ts.width[i]), 1e-30)
                d = self.dep_ts
                total = self.gamma_dep_ts[i] + d["positron"][i] + d["electron"][i] + d["alpha"][i]

                def ana(kind):
                    return float(np.sum(m_cell * decay_mod.get_particle_power_pergram(
                        self.dec, self.initnucmassfrac, tmid, kind)))

                eps_pos = ana(decay_mod.DECAYTYPE_BETAPLUS)
                eps_el = ana(decay_mod.DECAYTYPE_BETAMINUS)
                eps_al = ana(decay_mod.DECAYTYPE_ALPHA)
                qdot_bm = float(np.mean(decay_mod.get_qdot(
                    self.dec, self.initnucmassfrac, tmid, decay_mod.DECAYTYPE_BETAMINUS)))
                qdot_a = float(np.mean(decay_mod.get_qdot(
                    self.dec, self.initnucmassfrac, tmid, decay_mod.DECAYTYPE_ALPHA)))
                eps_per_g = (d["gamma_emission"][i] + d["positron_emission"][i]
                             + d["electron_emission"][i] + d["alpha_emission"][i]) / mtot / tw
                f.write(
                    f"{i} {tmid / DAY:g} {tmid:g} {total / tw / LSUN:g} "
                    f"{self.gamma_dep_ts[i] / tw / LSUN:g} {self.gamma_dep_ts[i] / tw / LSUN:g} "
                    f"{d['positron'][i] / tw / LSUN:g} {eps_pos / LSUN:g} "
                    f"{d['electron'][i] / tw / LSUN:g} {d['electron_emission'][i] / tw / LSUN:g} "
                    f"{eps_el / LSUN:g} {d['alpha'][i] / tw / LSUN:g} "
                    f"{d['alpha_emission'][i] / tw / LSUN:g} {eps_al / LSUN:g} "
                    f"{d['gamma_emission'][i] / tw / LSUN:g} {qdot_bm:g} {qdot_a:g} "
                    f"{eps_per_g:g} {qdot_bm + qdot_a:g} "
                    f"{d['positron_discrete'][i] / tw / LSUN:g} "
                    f"{d['electron_discrete'][i] / tw / LSUN:g} "
                    f"{d['alpha_discrete'][i] / tw / LSUN:g}\n")
        os.replace(path + ".tmp", path)

    def write_estimators(self, nts: int):
        """Per-cell estimator snapshot (reference: update_grid.cc:34-118)."""
        c = self.cells
        te, tr, tj, w = _np(c.Te), _np(c.TR), _np(c.TJ), _np(c.W)
        nne, thick, rho = _np(c.nne), _np(c.thick), _np(c.rho)
        cool, gd = _np(c.totalcooling), _np(c.grey_depth)
        # the per-ion Monte Carlo statistics of the timestep just run
        # (update_grid.cc:424-620 TRACK_ION_STATS; artis_tpu/driver.py:2200-2221)
        ist = None
        if self.opts.track_ion_stats and self.prev_est is not None:
            ist = _np(self.prev_est.ion_stats).astype(np.float64)
            if ist.shape[0] != self.grid.nonempty_npts:
                ist = None
            z_of_ion = np.asarray(self.ad.elem_z)[_np(self.dad.ion_element)]
            stage = _np(self.dad.ion_stage)
        with open(os.path.join(self.rundir, f"estimators_{nts:04d}.out"), "w") as f:
            for i in range(self.grid.nonempty_npts):
                f.write(f"timestep {nts} modelgridindex {int(self.mgi_of_nonempty[i])} "
                        f"titeration 0 TR {tr[i]:g} Te {te[i]:g} W {w[i]:g} TJ {tj[i]:g} "
                        f"grey_depth {float(gd[i]):g} nne {nne[i]:g} rho {rho[i]:g} "
                        f"thick {int(thick[i])} totalcooling {cool[i]:g}\n")
                if ist is not None:
                    f.write("".join(_ionstats_row(z_of_ion[u], stage[u], ist[i, u])
                                    for u in range(ist.shape[1]) if np.any(ist[i, u])))

    def write_macroatom_log(self, nts: int):
        """Drain the timestep's bounded macro-atom log into
        macroatom_0000.out, one row per radiative bound-bound deactivation
        (reference: LOG_MACROATOM, macroatom.cc:413-421, 630-641, file
        macroatom_%.4d.out of rank 0; artis_tpu/driver.py:1896-1941). The
        rows name the model grid cell (the JAX package writes the
        nonemptymgi and names the file macroatom_0-0.out: ROADMAP Queue
        3). The header starts the file at timestep 0; a log that overflowed
        ``log_macroatom_capacity`` says so in output_0-0.txt."""
        n_seen = int(self.est.malog_n)
        cap = int(self.est.malog.shape[0])
        n = min(n_seen, cap)
        path = os.path.join(self.rundir, "macroatom_0000.out")
        if nts == 0 or not os.path.exists(path):
            with open(path, "w") as f:
                f.write(f"{'timestep':>8} {'modelgridindex':>14} {'Z':>2} {'ionstage_in':>12} "
                        f"{'ionstage_out':>12} {'level_in':>9} {'level_out':>9} "
                        f"{'activline':>9} {'nu_cmf_in':>11} {'nu_cmf_out':>11} "
                        f"{'nu_rf_in':>11} {'nu_rf_out':>11}\n")
        if n == 0:
            return
        rows = _np(self.est.malog[:n]).astype(np.float64)
        lvl_ion = _np(self.dad.level_ion)
        ion_z = np.asarray(self.ad.elem_z)[_np(self.dad.ion_element)]
        ion_stage = _np(self.dad.ion_stage)
        ion_lvl0 = _np(self.dad.ion_level_start)
        mgi = self.mgi_of_nonempty[rows[:, 0].astype(np.int64)]
        li = np.clip(rows[:, 1].astype(np.int64), 0, lvl_ion.shape[0] - 1)
        lo = np.clip(rows[:, 2].astype(np.int64), 0, lvl_ion.shape[0] - 1)
        ion_in, ion_out = lvl_ion[li], lvl_ion[lo]
        with open(path, "a") as f:
            f.write("".join(
                f"{nts:>8d} {int(mgi[k]):>14d} {int(ion_z[ion_in[k]]):>2d} "
                f"{int(ion_stage[ion_in[k]]):>12d} {int(ion_stage[ion_out[k]]):>12d} "
                f"{int(li[k] - ion_lvl0[ion_in[k]]):>9d} {int(lo[k] - ion_lvl0[ion_out[k]]):>9d} "
                f"{int(rows[k, 3]):>9d} {rows[k, 4]:>11.5e} {rows[k, 5]:>11.5e} "
                f"{rows[k, 6]:>11.5e} {rows[k, 7]:>11.5e}\n" for k in range(n)))
        if n_seen > cap:
            self.log(f"timestep {nts}: macroatom log overflow: {n_seen - cap} of {n_seen} "
                     f"events dropped (log_macroatom_capacity={cap})")

    def write_nltepops(self, nts: int):
        """nlte_0000.out (reference: nltepop.cc:1076-1130): per cell, ion and
        level the LTE (Boltzmann at the final ion populations) and the
        solved populations and the ion's share of all ion populations, in
        the JAX package's columns (artis_tpu/driver.py:2223-2251)."""
        path = os.path.join(self.rundir, "nlte_0000.out")
        if self._last_levelpops is None:
            return
        mode = "a" if nts > 0 and os.path.exists(path) else "w"
        lp = _np(self._last_levelpops).astype(np.float64)
        boltz = _np(ltepop_mod.calculate_levelpops(self.dad, self.cells, self.opts)).astype(
            np.float64)
        ad = self.ad
        level_ion = _np(self.dad.level_ion)
        z_of_ion = np.asarray(ad.elem_z)[_np(self.dad.ion_element)]
        stage = _np(self.dad.ion_stage)
        ionpop = np.zeros((lp.shape[0], ad.nions_total))
        np.add.at(ionpop.T, level_ion, lp.T)
        tot = ionpop.sum(axis=1)
        level_in_ion = np.arange(ad.nlevels_total) - _np(self.dad.ion_level_start)[level_ion]
        with open(path, mode) as f:
            if mode == "w":
                f.write("timestep modelgridindex Z ionstage level n_LTE n_NLTE ion_popfrac\n")
            for i in range(lp.shape[0]):
                mgi = int(self.mgi_of_nonempty[i])
                frac = ionpop[i] / tot[i] if tot[i] > 0 else np.zeros(ad.nions_total)
                f.write("".join(
                    f"{nts} {mgi} {int(z_of_ion[u])} {int(stage[u])} {int(level_in_ion[g])} "
                    f"{boltz[i, g]:.5e} {lp[i, g]:.5e} {frac[u]:.4e}\n"
                    for g, u in enumerate(level_ion)))

    def write_radfield(self, nts: int):
        """radfield_0000.out (reference: radfield.cc:427-487): per cell the
        full-spectrum fit (bin -1), then per bin its edges, nuJ, J, J per
        unit frequency, contributions and fitted T_R and W
        (artis_tpu/driver.py:2253-2284)."""
        path = os.path.join(self.rundir, "radfield_0000.out")
        if self.prev_est is None or self.radfieldbin_tr is None:
            return
        mode = "a" if nts > 0 and os.path.exists(path) else "w"
        nb = self.opts.radfieldbincount
        e = self.prev_est
        jb, nujb, cb = (_np(x).astype(np.float64) for x in
                        (e.radfieldbin_j, e.radfieldbin_nuj, e.radfieldbin_count))
        trb, wb = _np(self.radfieldbin_tr), _np(self.radfieldbin_w)
        lower = _np(radfield_mod.bin_nu_lower(nb))
        upper = _np(radfield_mod.bin_nu_upper(nb))
        dnu = np.maximum(upper - lower, 1e-30)
        tr_full, w_full = _np(self.cells.TR), _np(self.cells.W)
        with open(path, mode) as f:
            if mode == "w":
                f.write("timestep modelgridindex bin_num nu_lower nu_upper nuJ J J_nu_avg "
                        "ncontrib T_R W\n")
            for i in range(jb.shape[0]):
                mgi = int(self.mgi_of_nonempty[i])
                f.write(f"{nts} {mgi} -1 0 0 0 0 0 0 {tr_full[i]:.1f} {w_full[i]:.5e}\n")
                f.write("".join(
                    f"{nts} {mgi} {b} {lower[b]:.5e} {upper[b]:.5e} {nujb[i, b]:.3e} "
                    f"{jb[i, b]:.3e} {jb[i, b] / dnu[b]:.3e} {int(cb[i, b])} {trb[i, b]:.1f} "
                    f"{wb[i, b]:.5e}\n" for b in range(nb)))

    def write_outputs(self, partial: bool):
        import json

        if not self._writes:
            return
        width = np.asarray(self.ts.width[:-1])
        # per-timestep transport record (rpkt crossing steps and wall
        # seconds, unrounded) for tools that measure the run
        with open(os.path.join(self.rundir, "transport_log.json"), "w") as f:
            json.dump(self.transport_log, f)
        self.write_deposition()
        spectrum_mod.write_light_curve(
            os.path.join(self.rundir, "light_curve.out"), self.ts.mid[:-1], self.lc_lum,
            self.lc_lumcmf, self.gamma_dep_ts, self.cmf_lum_ts, width)
        spectrum_mod.write_spectrum(os.path.join(self.rundir, "spec.out"), self.spec,
                                    self.ts.mid[:-1])

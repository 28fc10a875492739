"""Photoionisation/recombination rate-coefficient lookup tables
(reference: ratecoeff.cc:343-476 precalculate_rate_coefficient_integrals,
951-972 get_spontrecombcoeff, 896-950 select_continuum_nu).

The tables are integrated on the host in float64 with a Simpson rule on the
phixs grid (the reference's GPU build does the same, sn3d.h:77-85) and
cached in an md5-gated ``ratecoeff.<md5>.npz`` in the JAX package's file
format.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from .. import rng
from ..atomic import DeviceAtomicData
from ..constants import (
    FOURPI, HOVERKB, ONEOVERH, SAHACONST, TWOHOVERCLIGHTSQUARED,
    TWOOVERCLIGHTSQUARED,
)


@dataclasses.dataclass(frozen=True)
class RateCoeffTables:
    t_grid: torch.Tensor  # (TABLESIZE,)
    spontrecomb: torch.Tensor  # (ncont, TABLESIZE)
    corrphotoion: torch.Tensor
    bfheating: torch.Tensor
    bfcooling: torch.Tensor
    ion_alpha_sp: torch.Tensor  # (nions, TABLESIZE)
    tablesize: int
    mintemp: float
    maxtemp: float
    t_step_log: float


def _simpson_weights(n: int) -> np.ndarray:
    """Composite Simpson weights on n uniform points."""
    w = np.zeros(n)
    if n < 3:
        return np.ones(n) / max(n - 1, 1)
    m = n if n % 2 == 1 else n - 1
    w[0:m:2] += 1.0 / 3.0
    w[1:m:2] += 4.0 / 3.0
    w[2:m:2] += 1.0 / 3.0
    w[0] = 1.0 / 3.0
    w[m - 1] = 1.0 / 3.0
    if n % 2 == 0:
        w[n - 2] += 0.5
        w[n - 1] += 0.5
    return w


def _np(x):
    return x.detach().cpu().numpy()


def build_tables(dad: DeviceAtomicData, tablesize: int, mintemp: float, maxtemp: float,
                 use_lut_photoion: bool = True, use_lut_bfheating: bool = True,
                 cache_dir: str | None = None) -> RateCoeffTables:
    """Precompute the four LUTs for every bf continuum (float64 tensors on
    the atomic data's device)."""
    dev = dad.cont_nu_edge.device
    t_step_log = float(np.log(maxtemp / mintemp) / (tablesize - 1))

    def make(t_grid, spont, corr, bfheat, bfcool, ion_alpha):
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64)).to(dev)
        return RateCoeffTables(
            t_grid=t(t_grid), spontrecomb=t(spont), corrphotoion=t(corr),
            bfheating=t(bfheat), bfcooling=t(bfcool), ion_alpha_sp=t(ion_alpha),
            tablesize=tablesize, mintemp=mintemp, maxtemp=maxtemp,
            t_step_log=t_step_log)

    cache_path = None
    if cache_dir is not None:
        h = hashlib.md5()
        for arr in (dad.cont_nu_edge, dad.cont_probability, dad.cont_phixsrow,
                    dad.cont_uniquelower, dad.cont_uniqueupper, dad.allphixs,
                    dad.level_g):
            h.update(_np(arr).tobytes())
        h.update(np.asarray([tablesize, mintemp, maxtemp,
                             int(use_lut_photoion), int(use_lut_bfheating)]).tobytes())
        cache_md5 = h.hexdigest()
        cache_path = os.path.join(cache_dir, f"ratecoeff.{cache_md5[:16]}.npz")
        if os.path.exists(cache_path):
            data = np.load(cache_path)
            if data["md5"].item() == cache_md5:
                return make(data["t_grid"], data["spontrecomb"], data["corrphotoion"],
                            data["bfheating"], data["bfcooling"], data["ion_alpha_sp"])

    t_grid = mintemp * np.exp(np.arange(tablesize) * t_step_log)
    ncont = dad.nbfcontinua
    npts = dad.nphixspoints
    inc = dad.nphixsnuincrement
    if ncont == 0:
        z = np.zeros((0, tablesize))
        return make(t_grid, z, z, z, z, np.zeros((dad.nions_total, tablesize)))

    nu_edge = _np(dad.cont_nu_edge).astype(np.float64)
    level_g = _np(dad.level_g).astype(np.float64)
    g_l = level_g[_np(dad.cont_uniquelower)]
    g_u = level_g[_np(dad.cont_uniqueupper)]
    prob = _np(dad.cont_probability).astype(np.float64)
    sigma = _np(dad.allphixs).astype(np.float64)[_np(dad.cont_phixsrow)]
    kgrid = 1.0 + inc * np.arange(npts)
    nu = nu_edge[:, None] * kgrid[None, :]
    dnu = nu_edge * inc
    w = _simpson_weights(npts)
    spont = np.zeros((ncont, tablesize))
    corr = np.zeros((ncont, tablesize))
    bfheat = np.zeros((ncont, tablesize))
    bfcool = np.zeros((ncont, tablesize))
    for it, T in enumerate(t_grid):
        expfac = np.exp(-HOVERKB * (nu - nu_edge[:, None]) / T)
        exp_nu = np.exp(-HOVERKB * nu / T)
        sahaconst_part = SAHACONST * (g_l / g_u) * T**-1.5 * prob
        integ = np.sum(w[None, :] * sigma * TWOOVERCLIGHTSQUARED * nu**2 * expfac, axis=1) * dnu
        spont[:, it] = FOURPI * sahaconst_part * integ
        if use_lut_photoion or use_lut_bfheating:
            dbbval = TWOHOVERCLIGHTSQUARED * nu**3 / np.expm1(np.minimum(HOVERKB * nu / T, 700.0))
            dbbval = np.where(HOVERKB * nu / T > 700.0, 0.0, dbbval)
        if use_lut_photoion:
            integ = np.sum(w[None, :] * sigma * ONEOVERH / nu * dbbval * (1 - exp_nu), axis=1) * dnu
            corr[:, it] = FOURPI * prob * integ
        if use_lut_bfheating:
            integ = np.sum(w[None, :] * sigma * (1 - nu_edge[:, None] / nu) * dbbval
                           * (1 - exp_nu), axis=1) * dnu
            bfheat[:, it] = FOURPI * prob * integ
        integ = np.sum(w[None, :] * sigma * (nu - nu_edge[:, None]) * TWOHOVERCLIGHTSQUARED
                       * nu**2 * expfac, axis=1) * dnu
        bfcool[:, it] = FOURPI * sahaconst_part * integ

    ion_alpha = np.zeros((dad.nions_total, tablesize))
    cont_upperion = _np(dad.cont_ion) + 1
    for i in range(ncont):
        ion_alpha[int(cont_upperion[i])] += spont[i]

    if cache_path is not None:
        try:
            np.savez_compressed(
                cache_path, md5=cache_md5, t_grid=t_grid, spontrecomb=spont,
                corrphotoion=corr, bfheating=bfheat, bfcooling=bfcool,
                ion_alpha_sp=ion_alpha)
        except OSError:
            pass
    return make(t_grid, spont, corr, bfheat, bfcool, ion_alpha)


def interpolate_lut(table, rc: RateCoeffTables, contindex, t_e):
    """Linear interpolation on the log-spaced T grid, batched
    (reference: ratecoeff.cc:951-972)."""
    lower = torch.floor(torch.log(t_e / rc.mintemp) / rc.t_step_log).long()
    lower = torch.clamp(lower, 0, rc.tablesize - 1)
    upper = torch.clamp(lower + 1, max=rc.tablesize - 1)
    t_lower = rc.mintemp * torch.exp(lower.to(t_e.dtype) * rc.t_step_log)
    t_upper = rc.mintemp * torch.exp(upper.to(t_e.dtype) * rc.t_step_log)
    f_lower = table[contindex, lower]
    f_upper = table[contindex, upper]
    frac = torch.where(upper > lower,
                       (t_e - t_lower) / torch.clamp(t_upper - t_lower, min=1e-30),
                       torch.zeros_like(t_e))
    return f_lower + (f_upper - f_lower) * torch.clamp(frac, 0.0, 1.0)


def select_continuum_nu_batch(key, dad: DeviceAtomicData, contindex, t_e, mask):
    """Sample the free-bound emission frequency from each packet's selected
    continuum (reference: ratecoeff.cc:896-950): the alpha_sp_E integrand
    sigma nu^3/nu_edge exp(-hnu/kT) on the phixs grid, inverted on its
    trapezoid cumulative. ``key`` is a counter tuple."""
    npts = dad.nphixspoints
    inc = dad.nphixsnuincrement
    dtype = t_e.dtype
    ci = torch.clamp(contindex, 0, max(dad.nbfcontinua - 1, 0))
    nu_edge = dad.cont_nu_edge[ci].to(dtype)
    sigma = dad.allphixs[dad.cont_phixsrow[ci]].to(dtype)
    kgrid = 1.0 + inc * torch.arange(npts, dtype=dtype, device=t_e.device)
    nu = nu_edge[:, None] * kgrid[None, :]
    f = sigma * kgrid[None, :] ** 3 * torch.exp(
        -HOVERKB * (nu - nu_edge[:, None]) / t_e[:, None])
    seg = 0.5 * (f[:, 1:] + f[:, :-1])
    cum = torch.cat([torch.zeros_like(f[:, :1]), torch.cumsum(seg, dim=1)], dim=1)
    total = torch.clamp(cum[:, -1], min=1e-300)
    zrand = rng.uniform(key, 0, t_e.shape[0], dtype, t_e.device)
    target = zrand * total
    seg_idx = torch.clamp((cum <= target[:, None]).sum(dim=1) - 1, 0, npts - 2)
    c0 = torch.gather(cum, 1, seg_idx[:, None])[:, 0]
    c1 = torch.gather(cum, 1, seg_idx[:, None] + 1)[:, 0]
    n0 = torch.gather(nu, 1, seg_idx[:, None])[:, 0]
    n1 = torch.gather(nu, 1, seg_idx[:, None] + 1)[:, 0]
    fracseg = torch.where(c1 > c0, (target - c0) / torch.clamp(c1 - c0, min=1e-300),
                          torch.zeros_like(c0))
    nu_lower = n0 + fracseg * (n1 - n0)
    return torch.where(mask, nu_lower, torch.zeros_like(nu_lower))


# (cell, continuum, phixs point) elements per chunk of the LUT-off integrals
OTF_CHUNK_ELEMENTS = 1 << 23


def radfield_bf_integrals_cells(dad: DeviceAtomicData, t_e, t_r, w_full, bf_dep,
                                tr_bins=None, w_bins=None, nbins: int = 0):
    """LUT-off photoionisation and bf-heating coefficients against the
    current radiation-field model, batched over cells and chunked over
    continua (reference: ratecoeff.cc:731-817
    calculate_corrphotoioncoeff_integral with J from radfield::radfield;
    thermalbalance.cc:43-106 calculate_bfheatingcoeff). With ``tr_bins`` /
    ``w_bins`` (the multibin fits) J_nu comes from the binned model (zero
    outside the bins), else from the full-spectrum dilute blackbody
    (T_R, W). ``bf_dep`` is the LOG stimulated-recombination departure of
    ``opacity.build_bf_tables``. Returns (corrphotoion, bfheating), each
    (ncells, ncont):

        corr = 4 pi p INT sigma / (h nu) J_nu max(1 - dep e^{-h nu/k T_e}, 0) dnu
        bfh  = 4 pi p INT sigma (1 - nu_edge / nu) J_nu (1 - e^{-h nu/k T_R}) dnu

    by Simpson's rule on the uniform phixs grid."""
    from .radfield import dbb, select_bin

    ncont = dad.nbfcontinua
    ncells = t_e.shape[0]
    dtype, dev = t_e.dtype, t_e.device
    corr = torch.zeros((ncells, ncont), dtype=dtype, device=dev)
    bfh = torch.zeros_like(corr)
    if ncont == 0:
        return corr, bfh
    npts = dad.nphixspoints
    inc = dad.nphixsnuincrement
    kgrid = 1.0 + inc * torch.arange(npts, dtype=dtype, device=dev)
    wsimp = torch.as_tensor(_simpson_weights(npts), dtype=dtype, device=dev)
    t_r_s = torch.clamp(t_r, min=1.0)
    t_e_s = torch.clamp(t_e, min=1.0)
    use_bins = tr_bins is not None and nbins > 0
    chunk = max(1, min(256, OTF_CHUNK_ELEMENTS // max(ncells * npts, 1)))
    for c0 in range(0, ncont, chunk):
        ci = torch.arange(c0, min(c0 + chunk, ncont), device=dev)
        nu_edge = dad.cont_nu_edge[ci].to(dtype)
        sigma = dad.allphixs[dad.cont_phixsrow[ci]].to(dtype)  # (k, npts)
        prob = dad.cont_probability[ci].to(dtype)
        nu = nu_edge[:, None] * kgrid[None, :]  # (k, npts)
        dnu = nu_edge * inc
        if use_bins:
            b = select_bin(nu, nbins)
            bsafe = torch.clamp(b, 0, nbins - 1)
            trb = tr_bins[:, bsafe]  # (ncells, k, npts)
            wb = w_bins[:, bsafe]
            bin_ok = (b >= 0)[None, :, :] & (wb >= 0) & (trb > 0)
            j_nu = torch.where(bin_ok, dbb(nu[None, :, :], torch.clamp(trb, min=1.0),
                                           torch.clamp(wb, min=0.0)),
                               torch.zeros((), dtype=dtype, device=dev))
        else:
            j_nu = dbb(nu[None, :, :], t_r_s[:, None, None], w_full[:, None, None])
        hnu_kte = HOVERKB * nu[None, :, :] / t_e_s[:, None, None]
        corrfac = torch.clamp(1.0 - torch.exp(torch.clamp(bf_dep[:, ci, None].to(dtype) - hnu_kte,
                                                          -80.0, 80.0)), min=0.0)
        integ_c = torch.sum(wsimp[None, None, :] * sigma[None, :, :] * ONEOVERH
                            / nu[None, :, :] * j_nu * corrfac, dim=2) * dnu[None, :]
        corr[:, ci] = FOURPI * prob[None, :] * integ_c
        stimfac = -torch.expm1(-torch.clamp(HOVERKB * nu[None, :, :] / t_r_s[:, None, None],
                                            max=80.0))
        integ_b = torch.sum(wsimp[None, None, :] * sigma[None, :, :]
                            * (1.0 - nu_edge[None, :, None] / nu[None, :, :]) * j_nu * stimfac,
                            dim=2) * dnu[None, :]
        bfh[:, ci] = FOURPI * prob[None, :] * integ_b
    return corr, bfh

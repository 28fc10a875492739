"""Radiation-field model: J/nuJ estimators -> T_J, the full-spectrum
dilute-blackbody (T_R, W) fit, the multibin model (bin layout, per-bin
(T_R, W) fits, the binned J_nu lookup) and Planck sampling (reference:
radfield.cc:42-52 bin layout, 96-130 bin boundaries, 258-366 find_T_R,
369-417, 774-793, 834-911, 971-991; kpkt.cc:246-257)."""

from __future__ import annotations

import torch

from .. import rng
from ..constants import H, HOVERKB, KB, PI, STEBO, TWOHOVERCLIGHTSQUARED

# nu**3 at optical frequencies (1e45) overflows float32; scaling nu by an
# exact power of two keeps every intermediate in range and is bit-identical
# in float64.
_NU_SCALE = 2.0**-50
_DBB_COEFF = TWOHOVERCLIGHTSQUARED * 2.0**150


def dbb(nu, t, w):
    """Dilute blackbody J_nu = W * 2 h nu^3/c^2 / (exp(hnu/kT)-1)."""
    return w * _DBB_COEFF * (nu * _NU_SCALE) ** 3 / torch.expm1(HOVERKB * nu / t)


def fit_params_fullspec(j, nuj, mintemp, maxtemp):
    """Full-spectrum fit of T_J, T_R, W from normalised J and nuJ
    estimators, batched over cells (reference: radfield.cc:369-417).
    Returns (T_J, T_R, W, valid); where nubar is not finite or zero the
    caller keeps the previous values."""
    nubar = nuj / j
    t_j = torch.clamp((j * PI / STEBO) ** 0.25, mintemp, maxtemp)
    t_r = torch.clamp(H * nubar / KB / 3.832229494, mintemp, maxtemp)
    w = j * PI / STEBO / t_r**4
    return t_j, t_r, w, torch.isfinite(nubar) & (nubar != 0)


def get_t_j_from_j(j, mintemp, maxtemp):
    """T_J = (pi J / sigma)^(1/4), clamped (reference: radfield.cc:971-991)."""
    return torch.clamp((j * PI / STEBO) ** 0.25, mintemp, maxtemp)


# multibin layout (artisoptions_nltenebular.h:73-77): the bins split
# [NU_LOWER_FIRST, NU_UPPER_LAST] evenly; the last bin (the superbin) runs
# on to NU_UPPER_SUPERBIN. The JAX package keeps these as module constants.
NU_LOWER_FIRST = 2.99792458e10 / (40000e-8)  # lambda 40000 A
NU_UPPER_LAST = 2.99792458e10 / (1085e-8)  # lambda 1085 A
NU_UPPER_SUPERBIN = 2.99792458e10 / (10e-8)  # lambda 10 A


def bin_delta_nu(nbins: int) -> float:
    return (NU_UPPER_LAST - NU_LOWER_FIRST) / (nbins - 1)


def bin_nu_lower(nbins: int, device=None):
    """(nbins,) float64 lower edges; the last bin is the superbin."""
    return NU_LOWER_FIRST + torch.arange(nbins, dtype=torch.float64,
                                         device=device) * bin_delta_nu(nbins)


def bin_nu_upper(nbins: int, device=None):
    uppers = NU_LOWER_FIRST + (torch.arange(nbins, dtype=torch.float64, device=device)
                               + 1) * bin_delta_nu(nbins)
    uppers[nbins - 1] = NU_UPPER_SUPERBIN
    return uppers


def select_bin(nu, nbins: int):
    """Bin index of each frequency, -1 outside [NU_LOWER_FIRST,
    NU_UPPER_SUPERBIN) (reference: radfield.cc:113-130)."""
    idx = torch.floor((nu - NU_LOWER_FIRST) / bin_delta_nu(nbins)).long()
    idx = torch.where(nu >= NU_UPPER_LAST, torch.full_like(idx, nbins - 1), idx)
    inside = (nu >= NU_LOWER_FIRST) & (nu < NU_UPPER_SUPERBIN)
    return torch.where(inside, torch.clamp(idx, 0, nbins - 1), torch.full_like(idx, -1))


def planck_integral(t_r, nu_lower, nu_upper, times_nu: bool, npts: int = 64):
    """Trapezoid integral of B_nu (or nu B_nu) over [nu_lower, nu_upper] on
    npts points, batched over the broadcast of the three arguments
    (reference: radfield.cc:235-256 integrates with GSL)."""
    t_r = torch.as_tensor(t_r, dtype=nu_lower.dtype, device=nu_lower.device)
    t_r, nu_lower, nu_upper = torch.broadcast_tensors(t_r, nu_lower, nu_upper)
    frac = torch.linspace(0.0, 1.0, npts, dtype=t_r.dtype, device=t_r.device)
    nu = nu_lower[..., None] + (nu_upper - nu_lower)[..., None] * frac
    f = dbb(nu, torch.clamp(t_r, min=1.0)[..., None], 1.0)
    if times_nu:
        f = f * nu
    return torch.trapezoid(f, nu, dim=-1)


def fit_bin_params(j_bin, nuj_bin, contribcount, t_e, nbins: int, mintemp: float,
                   maxtemp: float, iters: int = 40):
    """Per-(cell, bin) dilute-blackbody fits (reference: radfield.cc:834-911):
    T_R solves nu_bar_planck(T) = nuJ / J by bisection (the reference's
    Brent solve, radfield.cc:302-366), the superbin takes T_R = T_e, W =
    J / planck_integral; bins without contributions get W = 0, and a W
    above 1e4 is refitted at maxtemp (radfield.cc:883-895). Returns
    (T_R, W), each (ncells, nbins)."""
    dev = j_bin.device
    nu_l = bin_nu_lower(nbins, dev)[None, :].to(j_bin.dtype)
    nu_u = bin_nu_upper(nbins, dev)[None, :].to(j_bin.dtype)
    nubar = nuj_bin / torch.clamp(j_bin, min=1e-300)

    def nubar_planck(t):
        num = planck_integral(t, nu_l, nu_u, True)
        return num / torch.clamp(planck_integral(t, nu_l, nu_u, False), min=1e-300)

    lo = torch.full_like(nubar, mintemp)
    hi = torch.full_like(nubar, maxtemp)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_cold = nubar_planck(mid) < nubar  # the Planck nu_bar rises with T
        lo, hi = torch.where(too_cold, mid, lo), torch.where(too_cold, hi, mid)
    t_r_bin = 0.5 * (lo + hi)
    t_r_bin[:, nbins - 1] = t_e.to(t_r_bin.dtype)  # radfield.cc:870-875
    pint = torch.clamp(planck_integral(t_r_bin, nu_l, nu_u, False), min=1e-300)
    w_bin = torch.where(contribcount > 0, j_bin / pint, torch.zeros_like(j_bin))
    too_high = w_bin > 1e4
    pint_max = torch.clamp(planck_integral(torch.full_like(t_r_bin, maxtemp), nu_l, nu_u,
                                           False), min=1e-300)
    w_bin = torch.where(too_high, j_bin / pint_max, w_bin)
    t_r_bin = torch.where(too_high, torch.full_like(t_r_bin, maxtemp), t_r_bin)
    return t_r_bin, w_bin


def radfield_dbb_binned(nu, cellidx, t_r_bins, w_bins, t_r_full, w_full, nbins: int):
    """J_nu from the binned model, falling back to the full-spectrum fit
    outside the bins or where a bin has W = 0 (reference: radfield.cc:774-793)."""
    b = select_bin(nu, nbins)
    safe_b = torch.clamp(b, min=0)
    t = t_r_bins[cellidx, safe_b]
    w = w_bins[cellidx, safe_b]
    use_bin = (b >= 0) & (w > 0)
    t_eff = torch.where(use_bin, t, t_r_full[cellidx])
    w_eff = torch.where(use_bin, w, w_full[cellidx])
    return dbb(nu, torch.clamp(t_eff, min=1.0), w_eff)


def sample_planck_montecarlo(key, t, nu_min, nu_max, maxiter: int = 512):
    """Batched rejection sampling of the Planck distribution on
    [nu_min, nu_max] (reference: kpkt.cc:246-257)."""
    nu_peak = 5.879e10 * t
    b_peak = dbb(torch.clamp(nu_peak, nu_min, nu_max), t, 1.0)
    nu = torch.zeros_like(t) + nu_min
    accepted = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for it in range(maxiter):
        u = rng.uniform(key, it, (2,) + tuple(t.shape), t.dtype, t.device)
        nu_try = nu_min + u[0] * (nu_max - nu_min)
        ok = u[1] * b_peak <= dbb(nu_try, t, 1.0)
        nu = torch.where(ok & ~accepted, nu_try, nu)
        accepted = accepted | ok
        if bool(accepted.all()):
            break
    return nu

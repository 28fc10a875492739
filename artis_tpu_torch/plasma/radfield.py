"""Radiation-field model: J/nuJ estimators -> T_J, the full-spectrum
dilute-blackbody (T_R, W) fit, and Planck sampling (reference:
radfield.cc:369-417, 971-991; kpkt.cc:246-257). The multibin model is not
on the ported path."""

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

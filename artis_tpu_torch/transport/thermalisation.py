"""Analytic gamma-ray and particle thermalisation (Barnes, Wollaeger,
Guttman).

Port of the JAX package's thermalisation module (reference:
gammapkt.cc:819-971, update_packets.cc:42-75): instead of Compton,
photoelectric and pair transport, a new gamma packet is absorbed locally
with probability equal to an analytic thermalisation efficiency f_gamma(t),
or escapes.

- BARNES (Barnes et al. 2016, ApJ 829:110): global efficiency
  f = 1 - exp(-(t_ineff/t)^2), t_ineff from the ejecta mass and mean kinetic
  velocity (gammapkt.cc:819-853).
- WOLLAEGER: the optical depth is the radially outward column density
  through the expanding ejecta times a mean gamma opacity
  (gammapkt.cc:855-897).
- GUTTMAN (Guttman et al. 2024, arXiv:2403.08769): the average over
  emission directions of the Wollaeger-style column density
  (gammapkt.cc:899-971).

The column densities are loops of cell crossings of a virtual ray
(``grid.boundary_distance``) until every ray leaves the grid, batched over
the rays, on every grid type. Guttman's directions are an argument, so the
caller decides where the random numbers come from.
"""

from __future__ import annotations

import torch

from .. import geometry
from ..constants import CLIGHT_PROP
from ..grid import BOUNDARY_ESCAPE, GridData, boundary_distance
from ..options import GridType

MEAN_GAMMA_OPAC_WOLLAEGER = 0.1  # cm^2/g (gammapkt.cc:857)
MEAN_GAMMA_OPAC_GUTTMAN = 0.03  # cm^2/g (gammapkt.cc:905)
GUTTMAN_NDIRS = 16


def barnes_t_ineff(mtot_grams: float, e_kin_erg: float) -> float:
    """t_ineff of Barnes et al. 2016 (gammapkt.cc:832-837)."""
    v_ej = (2.0 * e_kin_erg / mtot_grams) ** 0.5
    return (1.4 * 86400.0 * (mtot_grams / (5.0e-3 * 1.989e33)) ** 0.5
            * (0.2 * 29979200000.0) / v_ej)


def barnes_tau_ineff_particle(mtot_grams: float, e_kin_erg: float, alpha: bool) -> float:
    """Particle-scheme tau_ineff (update_packets.cc:44-48)."""
    v_ej = (2.0 * e_kin_erg / mtot_grams) ** 0.5
    prefactor = 7.74 if alpha else 7.4
    return (prefactor * 86400.0 * (mtot_grams / (5.0e-3 * 1.989e33)) ** 0.5
            * ((0.2 * 29979200000.0) / v_ej) ** 1.5)


def barnes_f_gamma(prop_time, t_ineff):
    return 1.0 - torch.exp(-((t_ineff / prop_time) ** 2))


def column_density_ray(grid: GridData, pos, dirvec, prop_time, where, rho_mgi,
                       time_scaling: bool, max_crossings: int = 4096):
    """Column density [g/cm^2] along each ray to where it leaves the grid
    (reference: gammapkt.cc:862-880 / 923-940), (N, 3) positions and unit
    directions. ``rho_mgi`` is the (npts_model + 1,) density per model cell
    that the caller picks (at the ray's start time for Wollaeger, at tmin
    for Guttman); time_scaling applies the reference's s t0^3 / t^3 factor
    (the ray moves at c while the ejecta expands). Only rays still inside
    the grid are advanced.

    A ray also stops once it lies outside the grid's extent (``_outside``),
    which the JAX package does not check: in float32 a ray that comes to
    rest within the boundary guard (2e-6 of the radius) short of its
    shell's boundary sees no crossing, takes a capped step past it and
    keeps its cell; it then never meets an escape boundary and runs to
    ``max_crossings``, adding its cell's density all the way (ROADMAP
    Queue 3)."""
    col = torch.zeros_like(prop_time)
    t0 = prop_time
    p, t, w = pos, prop_time, where.long()
    live = torch.arange(pos.shape[0], device=pos.device)
    for _ in range(max_crossings):
        if live.numel() == 0:
            break
        d = dirvec[live]
        sdist, snext = boundary_distance(grid, d, p, t, w)
        sdist = torch.clamp(sdist, min=0.0)
        s_cont = sdist * ((t0[live] / t) ** 3 if time_scaling else 1.0)
        mgi = grid.mgi_of_cell[w]
        rho = rho_mgi[torch.clamp(mgi, max=grid.npts_model)]
        col[live] += rho * s_cont
        p = p + d * sdist[:, None]
        t = t + sdist / CLIGHT_PROP
        stay = (snext != BOUNDARY_ESCAPE) & ~_outside(grid, p, t)
        live, p, t = live[stay], p[stay], t[stay]
        w = torch.clamp(snext[stay], min=0)
    return col


def _outside(grid: GridData, pos, t):
    """Rays beyond the grid's extent at time t (a sphere of radius vmax t,
    a cylinder of radius and half-height vmax t, or a cube of half-width
    vmax t), with a 1e-5 margin."""
    reach = grid.vmax * t * (1.0 + 1e-5)
    if grid.grid_type == GridType.SPHERICAL1D:
        return torch.sqrt((pos * pos).sum(dim=1)) > reach
    if grid.grid_type == GridType.CYLINDRICAL2D:
        rcyl = torch.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
        return (rcyl > reach) | (pos[:, 2].abs() > reach)
    return pos.abs().amax(dim=1) > reach


def wollaeger_f_gamma(grid: GridData, pos, prop_time, where, rho_t_mgi):
    """Radially outward optical depth -> absorption probability
    (gammapkt.cc:855-884); ``rho_t_mgi`` is the density at the current
    time."""
    dirvec = geometry.vec_norm(pos)
    col = column_density_ray(grid, pos, dirvec, prop_time, where, rho_t_mgi, True)
    return 1.0 - torch.exp(-MEAN_GAMMA_OPAC_WOLLAEGER * col)


def guttman_f_gamma(dirs, grid: GridData, pos, prop_time, where, rho_tmin_mgi, tmin: float):
    """Directionally averaged Guttman+2024 efficiency (gammapkt.cc:899-963)
    over the (ndirs, N, 3) unit directions ``dirs``.

    f = <1 - exp(-(t_gamma/t)^2 cd_i / <cd>)> with t_gamma^2 = kappa <cd>
    tmin^2 and cd_i the column density in direction i, integrated through
    rho_tmin from the position scaled back to tmin. The rays of every
    direction go through one column-density batch."""
    ndirs, n = dirs.shape[0], pos.shape[0]
    t0 = torch.full_like(prop_time, tmin)
    pos0 = pos * (tmin / torch.clamp(prop_time, min=1e-30))[:, None]
    cols = column_density_ray(grid, pos0.repeat(ndirs, 1), dirs.reshape(ndirs * n, 3),
                              t0.repeat(ndirs), where.repeat(ndirs), rho_tmin_mgi,
                              True).reshape(ndirs, n)
    avg = torch.clamp(cols.sum(dim=0) / ndirs, min=1e-300)
    t_gamma_sq = MEAN_GAMMA_OPAC_GUTTMAN * avg * tmin * tmin
    f = torch.mean(1.0 - torch.exp(-t_gamma_sq[None, :] / (prop_time[None, :] ** 2)
                                   * cols / avg[None, :]), dim=0)
    return torch.clamp(f, 0.0, 1.0)

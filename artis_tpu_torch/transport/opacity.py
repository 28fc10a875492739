"""r-packet continuum opacity tables (reference: rpkt.cc:739-780 free-free,
rpkt.cc:783-898 bound-free with stimulated recombination correction).

The per-packet continuum evaluation of real packets lives inside the
crossing kernel (``rpkt_kernel``); this module builds the per-timestep
per-cell tables it reads, and evaluates the continuum of other rays
(virtual packets) from them.
"""

from __future__ import annotations

import math

import torch

from ..atomic import DeviceAtomicData
from ..constants import HOVERKB, SAHACONST, SIGMA_T


def chi_ff_nnionpart_cells(dad: DeviceAtomicData, nnion_cells, t_e):
    """(ncells,) ion-charge part of the ff opacity (reference: rpkt.cc:739-754)."""
    charge = (dad.ion_stage - 1).to(nnion_cells.dtype)
    part = torch.sum(nnion_cells * (charge * charge)[None, :], dim=1)
    return part * 3.69255e8 / torch.sqrt(t_e)


def build_bf_tables(dad: DeviceAtomicData, levelpops, nnion_cells, nne, nnetot, t_e):
    """Per-timestep (ncells, nbfcontinua) bound-free tables: A = nnlevel*prob
    under the keep rule (rpkt.h:128-134) and LD = LOG stimulated-recombination
    departure (rpkt.cc:855-872). The log form keeps float32 pipelines in
    range; consumers apply corr = 1 - exp(LD - h nu / k T_e)."""
    ncont = dad.nbfcontinua
    dt = t_e.dtype
    if ncont == 0:
        z = torch.zeros((t_e.shape[0], 0), dtype=dt, device=t_e.device)
        return z, z
    nnlevel = levelpops[:, dad.cont_uniquelower]
    nnupper = levelpops[:, dad.cont_uniqueupper]
    nnion_p = nnion_cells[:, dad.cont_ion]
    is_ground = dad.cont_uniquelower == dad.ion_level_start[dad.cont_ion]
    keep = (nnion_p / torch.clamp(nnetot[:, None], min=1e-300) > 1e-6) | is_ground[None, :]
    g_l = dad.level_g.to(dt)[dad.cont_uniquelower]
    g_u = dad.level_g.to(dt)[dad.cont_uniqueupper]
    ldep = (torch.log(torch.clamp(nnupper, min=1e-300))
            - torch.log(torch.clamp(nnlevel, min=1e-300))
            + torch.log(torch.clamp(nne, min=1e-300))[:, None]
            + math.log(SAHACONST)
            + torch.log(g_l / g_u)[None, :]
            - 1.5 * torch.log(t_e)[:, None]
            + HOVERKB * dad.cont_nu_edge.to(dt)[None, :] / t_e[:, None])
    bf_ldep = torch.where(nnupper > 0, ldep, torch.full_like(ldep, -1e30))
    a_tab = torch.where(keep & (nnlevel > 0),
                        nnlevel * dad.cont_probability.to(dt)[None, :],
                        torch.zeros_like(nnlevel))
    return a_tab, bf_ldep


def calculate_chi_ffheating(chi_ff_nnionpart, nne, t_e, nu):
    """Free-free absorption coefficient [1/cm] (reference: rpkt.cc:768-780),
    with the exact power-of-two rescale that keeps nu**-3 in float32 range."""
    nu3_scaled = (nu * 2.0 ** -50) ** 3
    return ((chi_ff_nnionpart * 2.0 ** -75) * (nne * 2.0 ** -75) / nu3_scaled
            * -torch.expm1(-HOVERKB * nu / t_e))


def calculate_chi_bf(dad: DeviceAtomicData, nu, cellidx, active, bf_a, bf_dep, t_e,
                     chunk: int = 512):
    """(n,) total bound-free opacity at cmf frequency ``nu`` of lanes in
    model cells ``cellidx`` (reference: rpkt.cc:783-898), from the
    per-timestep tables of ``build_bf_tables``; the continua in chunks of
    ``chunk`` bound the (n, chunk) temporaries."""
    from ..atomic import photoionization_crosssection

    ncont = dad.nbfcontinua
    chi_bf = torch.zeros_like(nu)
    if ncont == 0:
        return chi_bf
    hnu_kt = HOVERKB * nu / t_e[cellidx]
    nu_c = torch.clamp(nu, min=1e-30)[:, None]
    for c0 in range(0, ncont, chunk):
        c1 = min(c0 + chunk, ncont)
        nu_edge = dad.cont_nu_edge[c0:c1].to(nu.dtype)[None, :]
        in_window = ((nu[:, None] >= nu_edge) & (nu_edge * dad.last_phixs_nuovernuedge
                                                 >= nu[:, None]) & active[:, None])
        sigma = photoionization_crosssection(dad, dad.cont_phixsrow[c0:c1][None, :], nu_edge,
                                             nu_c)
        corr = torch.clamp(1.0 - torch.exp(torch.clamp(
            bf_dep[:, c0:c1].to(nu.dtype)[cellidx] - hnu_kt[:, None], -80.0, 80.0)), min=0.0)
        contrib = bf_a[:, c0:c1].to(nu.dtype)[cellidx] * sigma * corr
        chi_bf = chi_bf + torch.where(in_window, contrib, torch.zeros_like(contrib)).sum(dim=1)
    return chi_bf


def calculate_chi_rpkt_cont(dad: DeviceAtomicData, nu_cmf, cellidx, active, bf_a, bf_dep,
                            chi_ff_nnionpart, nne, t_e, opacity_case: int):
    """Electron-scattering, free-free and bound-free continuum opacities
    (chi_es, chi_ff, chi_bf) [1/cm] at ``nu_cmf`` (reference:
    rpkt.cc:972-1032; the JAX package's calculate_chi_rpkt_cont), in the
    dtype of ``nu_cmf``: the continuum of rays outside the crossing kernel,
    e.g. virtual packets. Below ``opacity_case`` 4 the continuum is
    free-free only (chi_es = chi_bf = 0)."""
    dt = nu_cmf.dtype
    nne_p = nne.to(dt)[cellidx]
    t_e_p = t_e.to(dt)[cellidx]
    chi_ff = calculate_chi_ffheating(chi_ff_nnionpart.to(dt)[cellidx], nne_p, t_e_p,
                                     torch.clamp(nu_cmf, min=1e-30))
    if opacity_case < 4:
        return torch.zeros_like(chi_ff), chi_ff, torch.zeros_like(chi_ff)
    chi_bf = calculate_chi_bf(dad, nu_cmf, cellidx, active, bf_a, bf_dep, t_e.to(dt))
    return SIGMA_T * nne_p, chi_ff, chi_bf

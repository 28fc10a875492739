"""Binned expansion opacities (the EXPANSIONOPACITIES_ON mode).

Port of the JAX package's expansionopacity module (reference: rpkt.cc:30-75
bin layout, 199-290 get_event_expansion_opacity,
calculate_expansion_opacities, 905-935 Planck-weighted bin sampling).

Per timestep, each cell's Sobolev line opacities collapse into wavelength
bins: kappa_bin = sum_{lines in bin} (lambda_line/delta_lambda)
(1 - exp(-tau)) / (c t_mid rho). Transport then walks bins of constant
opacity instead of individual lines. A bound-bound event either resolves
the line it hits within its bin and activates the macro-atom
(``rpkt_boundbound_thermalisation_probability`` < 0, every reference
preset) or thermalises with a fixed probability and scatters coherently
otherwise.

The samplers take their uniforms as arguments, so a caller (or a test)
decides where the random numbers come from.
"""

from __future__ import annotations

import torch

from ..constants import CLIGHT, CLIGHT_PROP
from ..devutil import index_add_
from ..plasma.radfield import dbb

LAMBDA_MIN = 534.5  # Angstrom (rpkt.cc:32)
LAMBDA_MAX = 35000.0
DELTA_LAMBDA = 35.5
NBINS = int((LAMBDA_MAX - LAMBDA_MIN) / DELTA_LAMBDA)
# (events x columns) elements a chunk of sample_bb_line may hold
_CHUNK_ELEMS = 1 << 24


def bin_nu_upper(binindex):
    return 1e8 * CLIGHT / (LAMBDA_MIN + binindex * DELTA_LAMBDA)


def bin_nu_lower(binindex):
    return 1e8 * CLIGHT / (LAMBDA_MIN + (binindex + 1) * DELTA_LAMBDA)


def build_expansion_opacities(tau_sob_factor, line_nu, rho, t_r, t_mid: float):
    """(ncells, NBINS) kappa [cm^2/g] and its Planck-weighted cumulative
    (reference: calculate_expansion_opacities). Lines outside
    [LAMBDA_MIN, LAMBDA_MAX) are dropped."""
    lam = 1e8 * CLIGHT / line_nu  # [A], in the line list's dtype
    dt = tau_sob_factor.dtype
    ncells = tau_sob_factor.shape[0]
    binidx = torch.floor((lam - LAMBDA_MIN) / DELTA_LAMBDA).long()
    # out-of-range lines go to an extra column that is dropped
    binidx = torch.where((binidx >= 0) & (binidx < NBINS), binidx, NBINS)
    tau = tau_sob_factor * t_mid
    w = (lam / DELTA_LAMBDA).to(dt)[None, :] * -torch.expm1(-tau)
    binsum = torch.zeros((ncells, NBINS + 1), dtype=dt, device=tau.device)
    index_add_(binsum, 1, binidx, w)
    kappa = binsum[:, :NBINS] / (CLIGHT * t_mid * torch.clamp(rho.to(dt), min=1e-300)[:, None])
    b = torch.arange(NBINS, device=tau.device, dtype=torch.float64)
    nu_lo = bin_nu_lower(b).to(dt)
    nu_hi = bin_nu_upper(b).to(dt)
    nu_mid = 0.5 * (nu_lo + nu_hi)
    planck = dbb(nu_mid[None, :], torch.clamp(t_r.to(dt), min=1.0)[:, None], 1.0)
    pc = torch.cumsum(kappa * planck * (nu_hi - nu_lo)[None, :], dim=1)
    return kappa, pc


def build_line_selection(tau_sob_factor, line_nu, t_mid: float):
    """Per-cell cumulative line weights for resolving which line a
    bound-bound expansion-opacity event activates: the weight of a line is
    its contribution (lambda/dlambda)(1 - exp(-tau)) to its bin's opacity
    (the summand of ``build_expansion_opacities``).

    Returns (wcum, binoffsets): wcum is the (ncells, nlines) per-cell
    cumulative of the weights along the nu-descending line list, in the
    dtype of ``tau_sob_factor``; binoffsets is (NBINS+1,) line-index offsets
    of each wavelength bin's contiguous segment in that list."""
    lam = 1e8 * CLIGHT / line_nu  # ascending: the line list is nu-descending
    tau = tau_sob_factor * t_mid
    in_range = (lam >= LAMBDA_MIN) & (lam < LAMBDA_MAX)
    w = torch.where(in_range[None, :], (lam / DELTA_LAMBDA).to(tau.dtype)[None, :]
                    * -torch.expm1(-tau), torch.zeros((), dtype=tau.dtype, device=tau.device))
    wcum = torch.cumsum(w, dim=1)
    edges = LAMBDA_MIN + DELTA_LAMBDA * torch.arange(NBINS + 1, dtype=lam.dtype,
                                                     device=lam.device)
    binoffsets = torch.searchsorted(lam.contiguous(), edges).to(torch.int32)
    return wcum, binoffsets


def sample_bb_line(u, wcum, binoffsets, cellidx, nu_cmf, mask):
    """Draw the activating line of a bound-bound expansion-opacity event
    with uniforms ``u`` in [0, 1).

    The event's wavelength bin comes from the packet's comoving frequency;
    the line is drawn within that bin's contiguous segment of the line list
    in proportion to its bin-opacity weight. Returns (lineidx, ok): ok is
    False where the bin holds no line weight (the caller scatters
    coherently instead).

    Only the hit bin's segment [binoffsets[b], binoffsets[b+1]) is read, for
    the lanes with an event, in column chunks of at most _CHUNK_ELEMS
    elements; no (events, nlines) tensor is built."""
    nlines = wcum.shape[1]
    lam = 1e8 * CLIGHT / torch.clamp(nu_cmf, min=1.0)
    b = torch.clamp(torch.floor((lam - LAMBDA_MIN) / DELTA_LAMBDA).long(), 0, NBINS - 1)
    off = binoffsets.long()
    start, end = off[b], off[b + 1]
    cellc = torch.clamp(cellidx, min=0).long()
    zero = torch.zeros((), dtype=wcum.dtype, device=wcum.device)
    w_lo = torch.where(start > 0, wcum[cellc, torch.clamp(start - 1, min=0)], zero)
    w_hi = torch.where(end > 0, wcum[cellc, torch.clamp(end - 1, min=0)], zero)
    ok = mask & (w_hi > w_lo)
    target = w_lo + u.to(wcum.dtype) * (w_hi - w_lo)
    # the selected line is start + #(entries of the segment with wcum <= target)
    cnt = torch.zeros_like(start)
    idx = torch.nonzero(mask)[:, 0]
    if idx.numel():
        s, e, c, tg = start[idx], end[idx], cellc[idx], target[idx]
        seglen = int((e - s).max())
        width = max(1, min(seglen, _CHUNK_ELEMS // idx.numel()))
        col = torch.arange(width, device=wcum.device)
        acc = torch.zeros_like(s)
        for j0 in range(0, seglen, width):
            g = s[:, None] + j0 + col[None, :]
            inseg = g < e[:, None]
            vals = wcum[c[:, None], torch.clamp(g, max=nlines - 1)]
            acc += (inseg & (vals <= tg[:, None])).sum(dim=1)
        cnt[idx] = acc
    lineidx = torch.clamp(start + cnt, 0, nlines - 1)
    return lineidx, ok


def get_event_expansion_batch(kappa_rho_dop, nu_cmf0, prop_time0, chi_cont, tau_rnd,
                              abort_dist, nu_cmf_abort, d_nu_on_d_l, active,
                              relativistic: bool, big: float = float("inf")):
    """Vectorised bin walk (reference: rpkt.cc:199-290).

    kappa_rho_dop: (npkts, NBINS) kappa[cell] * (rho * doppler). Bin 0 has
    no upper edge: it starts at distance 0, so a packet bluer than
    LAMBDA_MIN accrues bin 0's opacity from where it stands; a packet redder
    than the last bin's lower edge has no path length in any bin and sees no
    event. ``abort_dist`` and ``nu_cmf_abort`` are unused (the walk spans
    every bin). Returns (edist, bb_frac): the distance to the next event
    (``big`` where none) and chi_bb / chi_tot at the event bin, against
    which the caller draws the bound-bound / continuum split."""
    del abort_dist, nu_cmf_abort
    w = bin_walk(kappa_rho_dop, nu_cmf0, prop_time0, chi_cont, tau_rnd, d_nu_on_d_l,
                 active, relativistic, big)
    return w["edist"], w["bb_frac"]


def bin_walk(kappa_rho_dop, nu_cmf0, prop_time0, chi_cont, tau_rnd, d_nu_on_d_l, active,
             relativistic: bool, big: float):
    """``get_event_expansion_batch`` with its intermediates: a dict of
    edist, bb_frac, the event bin ``j`` and ``anyhit`` (N,), and the
    (N, NBINS) ``seg`` (path length in each bin) and ``d_prev`` (distance
    to each bin's upper edge)."""
    # distance to each bin's lower-nu edge; edges already passed are at 0
    b = torch.arange(NBINS, device=nu_cmf0.device, dtype=torch.float64)
    nu_lo_edges = bin_nu_lower(b).to(nu_cmf0.dtype)[None, :]
    if relativistic:
        d_edge = (nu_lo_edges - nu_cmf0[:, None]) / d_nu_on_d_l[:, None]
    else:
        d_edge = CLIGHT_PROP * prop_time0[:, None] * (nu_cmf0[:, None] / nu_lo_edges - 1.0)
    # when the d_nu_on_d_l secant degenerates, d_edge overflows to +inf and
    # seg/cum would give inf - inf = NaN; a large finite cap keeps the whole
    # remaining optical depth in the current bin instead
    d_edge = torch.clamp(d_edge, 0.0, 1e30)
    d_prev = torch.cat([torch.zeros_like(d_edge[:, :1]), d_edge[:, :-1]], dim=1)
    seg = torch.clamp(d_edge - d_prev, min=0.0)
    chi_tot = chi_cont[:, None] + kappa_rho_dop
    dtau = chi_tot * seg
    # exclusive prefix, accumulated directly (inclusive minus last can round
    # below the true prefix: the "immortal packet" note of the kernel)
    cum = torch.cat([torch.zeros_like(dtau[:, :1]), torch.cumsum(dtau, dim=1)[:, :-1]], dim=1)
    hit = (cum + dtau >= tau_rnd[:, None]) & (seg > 0)
    anyhit = hit.any(dim=1)
    j = torch.argmax(hit.to(torch.int8), dim=1, keepdim=True)
    pick = lambda x: x.gather(1, j)[:, 0]
    chi_j = torch.clamp(pick(chi_tot), min=1e-30)
    edist = pick(d_prev) + (tau_rnd - pick(cum)) / chi_j
    edist = torch.where(anyhit & active, torch.clamp(edist, min=0.0),
                        torch.full_like(edist, big))
    bb_frac = torch.where(anyhit, pick(kappa_rho_dop) / chi_j, torch.zeros_like(chi_j))
    return dict(edist=edist, bb_frac=bb_frac, j=j[:, 0], anyhit=anyhit, seg=seg,
                d_prev=d_prev)


def sample_planck_times_expansion_opacity(u_bin, u_nu, planck_cum, cellidx, mask):
    """Thermalised re-emission frequency (reference: rpkt.cc:918-935): a bin
    drawn from the cell's Planck x kappa cumulative with ``u_bin``, a
    frequency uniform within it with ``u_nu``; 0 where ``mask`` is off.
    Only the masked lanes' rows are read."""
    nu = torch.zeros(cellidx.shape, dtype=planck_cum.dtype, device=planck_cum.device)
    idx = torch.nonzero(mask)[:, 0]
    if idx.numel():
        rows = planck_cum[cellidx[idx].long()]
        total = torch.clamp(rows[:, -1], min=1e-300)
        u = u_bin[idx].to(rows.dtype) * total
        binindex = torch.clamp((rows <= u[:, None]).sum(dim=1), max=NBINS - 1)
        nu_lo = bin_nu_lower(binindex.double()).to(rows.dtype)
        nu_hi = bin_nu_upper(binindex.double()).to(rows.dtype)
        nu[idx] = nu_lo + u_nu[idx].to(rows.dtype) * (nu_hi - nu_lo)
    return nu

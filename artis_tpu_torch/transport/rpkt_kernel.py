"""The r-packet crossing kernel: its CUDA wrapper and its plain version.

``propagate`` advances every moving r-packet through up to ``max_inner``
cell crossings: optical-depth draw, cell boundary distance (spherical
shells, cylindrical (rcyl, z) cells or Cartesian cubes), Doppler and abort
frequency, continuum opacity (electron scattering + free-free + bound-free
with phixs interpolation and log departure; free-free alone with
``ff_only``, the grey opacity cases 0-3), continuum selection, the
Sobolev line walk from each packet's cursor (or, in expansion-opacity mode,
the walk over wavelength bins of binned line opacity), in-kernel isotropic
electron / thick-grey scattering (or, in the deferred mode, every event
handed to the event pass), two half-moves with midpoint J, nuJ, ffheating,
LUT photoionisation / bf-heating and, optionally, detailed per-continuum
bf-rate estimators and the multibin J / nuJ / count per (cell,
radiation-field bin), the detailed J_b_lu sums over the lines each walk
sweeps (optional too), a Kahan-summed time and the boundary overshoot guard
(reference: rpkt.cc:604-737 do_rpkt_step without the event application;
radfield.cc:731-771).

Two precisions: float32 lanes and tables (the Pallas kernel's) or float64
ones (the JAX package's XLA ``_rpkt_propagate_once``, which it runs at
``transport_dtype="float64"``, the default). A float64 launch runs the
double instantiation of the kernel (``launch_f64``), whose crossing differs
from the float32 one where the XLA path's does: no 3e-6 r boundary
overshoot and no Kahan compensation of the time (t advances by the two
half-moves, as ``geometry.move_pkt`` does), the float64 h/k, float64
multibin edges (``radbin_edges``), the expansion-opacity bin edges computed
in float64, and float64 uniforms (``rng.philox_uniform2d``: two a draw,
three draws a crossing).

It replaces the Pallas kernel ``propagate_blocked``
(artis_tpu/transport/pallas_rpkt.py:1837, body ``_kernel`` :314-1822) in its
resident-table configurations: 1D spherical (:863-942), ``cart3d``
(:588-631, :712-750), ``cyl2d`` (:751-862), ``want_bfrate`` (:1515-1532),
``expansion_mode`` (:1136-1200), ``inkernel_scatter=False`` (:1416-1435,
the deferred events of dipole scattering), ``multibin`` (:1491-1514) and
``want_jblue`` (:1254-1265, :1346-1363, :1392). The cylindrical distance
scales the rcyl bounds to the step's start time as the XLA path does
(artis_tpu/grid.py:372-390); the Pallas branch passes them at tmin. For CUDA
tensors it launches ``csrc/rpkt_crossing.cu`` (built by ``build()``); for
CPU tensors it runs ``propagate_reference``, the same computation written
as a per-crossing loop over tensors. There is no fallback between the two.

Random numbers: Philox4x32-10 keyed by (seed, lane id) with the crossing
index as counter, drawn identically by both versions (``rng.philox_uniform4``
in float32, ``rng.philox_uniform2d`` in float64), so results do not depend
on block size or on lane order. Test mode takes
``test_tau`` (one optical depth per lane, reused every crossing) and
``test_sel`` (continuum selection and scatter split), and the fixed redirect
uniforms z1=0.37, z2=0.81 — exactly the JAX kernel's injection contract
(``test_sel`` is also the bound-bound split of an expansion-opacity event).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..constants import CLIGHT, CLIGHTSQUARED, CLIGHT_PROP, HOVERKB, SIGMA_T
from ..grid import BOUNDARY_ESCAPE, cell_boundary
from ..plasma.radfield import NU_LOWER_FIRST, NU_UPPER_LAST, NU_UPPER_SUPERBIN
from .expansionopacity import NBINS, bin_nu_lower, bin_walk

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
# "no event" distance: above any distance of either precision, and finite
# in both
BIG = 3.0e38
HOVERKB_F32 = 4.799243681e-11
# h/k of each precision's crossing (float64: the constant the XLA path uses)
HOVERKB_OF = {F32: HOVERKB_F32, F64: HOVERKB}

LANE_F32 = ("posx", "posy", "posz", "dirx", "diry", "dirz", "nu_rf", "nu_cmf",
            "e_rf", "e_cmf", "prop_time")
LANE_I32 = ("where", "next_trans", "moving", "lane_id")
OUT_F32 = ("posx", "posy", "posz", "dirx", "diry", "dirz", "nu_rf", "nu_cmf",
           "e_rf", "e_cmf", "prop_time", "chi_escat", "chi_ff", "chi_bf",
           "chi_cont", "em_x", "em_y", "em_z", "em_t")
OUT_I32 = ("where", "next_trans", "evented", "escaped", "thick", "is_bb",
           "act_line", "bf_idx", "mgi", "nsc", "inkscat")
TABLES_F32 = ("cellmin", "cellmax", "nne", "Te", "kappagrey", "rho",
              "chiffpart", "line_nu", "tau_factor", "cont_nu_edge", "bf_a",
              "bf_dep", "cont_phixs", "cont_prob", "gc_nu_edge", "expo_kappa")
TABLES_I32 = ("mgi_of_cell", "thick", "cont_gidx", "jblue_of_line")
# misc (float64): crossing steps, escapes, escaped cmf energy, in-kernel
# electron scatters, thick-cell scatters, boundary crossings, lines read by
# the walk (cursor advance; in expansion mode, wavelength bins read) and bf
# continua in the opacity windows
MISC = ("nadv", "nesc", "cmf_lum", "n_escat", "n_thickscat", "ncross", "nwalk", "nbfwin")
NMISC = 8
# the Estimators fields the kernel's rows (and misc) feed through float
# atomics, whose order changes from launch to launch: same-seed runs on the
# card differ in these in their last bits from timestep 0 on (counts are
# exact)
ATOMIC_SUMS = ("j", "nuj", "ffheating", "gammaestimator", "bfheatingestimator", "bfrate",
               "radfieldbin_j", "radfieldbin_nuj", "jblue_raw", "cmf_lum")
# how far two float64 runs on the same inputs may differ in ATOMIC_SUMS:
# relative to each entry, and absolute relative to the field's largest
ATOMIC_RTOL_F64 = 1e-12
ATOMIC_ATOL_F64 = 1e-15


def atomic_sums_agree(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether a float64 ATOMIC_SUMS field ``got`` agrees with ``want``
    within ATOMIC_RTOL_F64 / ATOMIC_ATOL_F64."""
    scale = float(want.abs().max().clamp(min=1e-300)) if want.numel() else 0.0
    return bool(torch.allclose(got.to(want.device), want, rtol=ATOMIC_RTOL_F64,
                               atol=ATOMIC_ATOL_F64 * scale))
# grid geometry of a launch (the GridType values): the kernel is compiled
# once per geometry
GEOM_SPH, GEOM_CYL, GEOM_CART = 1, 2, 3
GEOM_NDIM = {GEOM_SPH: 1, GEOM_CYL: 2, GEOM_CART: 3}


def radbin_edges(nradbins: int, dtype=F32):
    """The multibin layout as the kernel computes with it: (first lower
    edge, NU_UPPER_LAST, superbin upper edge, bin width), in float32 each
    rounded from the float64 constant (pallas_rpkt.py:1497-1503), in
    float64 the constants (the XLA path's radfield.select_bin)."""
    edges = (NU_LOWER_FIRST, NU_UPPER_LAST, NU_UPPER_SUPERBIN,
             (NU_UPPER_LAST - NU_LOWER_FIRST) / max(nradbins - 1, 1))
    return tuple(float(np.float32(v)) for v in edges) if dtype == F32 else edges


def radbin_index(nu, nradbins: int):
    """(bin, inside) of frequencies with the kernel's expression in their
    precision: floor((nu - lower) / width), nu >= NU_UPPER_LAST in the
    last bin (the superbin), clipped; inside [lower, superbin upper)."""
    lo, last, sup, delta = (torch.tensor(v, dtype=nu.dtype, device=nu.device)
                            for v in radbin_edges(nradbins, nu.dtype))
    b = torch.floor((nu - lo) / delta)
    b = torch.where(nu >= last, torch.full_like(b, nradbins - 1), b)
    b = torch.clamp(b, 0.0, float(nradbins - 1)).long()
    return b, (nu >= lo) & (nu < sup)


def ff_only_tables(tables: dict, want_bfrate: bool = False) -> dict:
    """The tables of a launch with the free-free continuum of the grey
    opacity cases 0-3 (the JAX package's opacity_case < 4,
    artis_tpu/transport/opacity.py:242-258): no bound-free opacity (and so
    no continuum selection) and no LUT gamma or bf-heating contribution.
    Without the detailed bf-rate rows the continuum window is empty (no
    continuum table, as for an atom without bound-free continua); with them
    a zero bf_a table takes the opacity out and ground-continuum indices of
    -1 the LUT rows, and the bf-rate rows, which read neither, accumulate as
    in every case. The kernel's electron scattering goes with its
    ``sigma_es`` field."""
    if not want_bfrate:
        return dict(tables, cont_nu_edge=tables["cont_nu_edge"][:0],
                    bf_a=tables["bf_a"][:, :0], bf_dep=tables["bf_dep"][:, :0],
                    cont_phixs=tables["cont_phixs"][:0], cont_prob=tables["cont_prob"][:0],
                    cont_gidx=tables["cont_gidx"][:0])
    return dict(tables, bf_a=torch.zeros_like(tables["bf_a"]),
                cont_gidx=torch.full_like(tables["cont_gidx"], -1))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _doppler_at(dx, dy, dz, px, py, pz, t, relativistic):
    ndotv = (dx * px + dy * py + dz * pz) / t
    dop = 1.0 - ndotv / CLIGHT
    if relativistic:
        betasq = (px * px + py * py + pz * pz) / (t * t) / CLIGHTSQUARED
        dop = dop / torch.sqrt(torch.clamp(1.0 - betasq, min=1e-30))
    return dop


def _bf_terms(nu, need_chi, tables, ngc, nphixs, phixs_dnu, last_nuovernuedge):
    """(B, C) window mask, cross-section and stimulated correction pieces."""
    edge = tables["cont_nu_edge"][None, :]
    in_w = (nu[:, None] >= edge) & (edge * last_nuovernuedge >= nu[:, None]) & need_chi[:, None]
    ireal = (nu[:, None] / edge - 1.0) / phixs_dnu
    i0 = torch.clamp(torch.floor(ireal), 0, nphixs - 2).long()
    frac = ireal - i0.to(nu.dtype)
    phixs = tables["cont_phixs"]
    ncont = phixs.shape[0]
    rowsel = torch.arange(ncont, device=nu.device)[None, :]
    sig_a = phixs[rowsel, i0]
    sig_b = phixs[rowsel, i0 + 1]
    interp = (1.0 - frac) * sig_a + frac * sig_b
    numax = edge * last_nuovernuedge
    kram = phixs[:, nphixs - 1][None, :] * (numax / torch.clamp(nu[:, None], min=1e-30)) ** 3
    sigma = torch.where(ireal < 0, torch.zeros_like(ireal),
                        torch.where(ireal < nphixs - 1, interp, kram))
    return in_w, sigma


def _expansion_event(kappa_rho_dop, nu, tstart, safe_chi, tau_next, abort_dist, dnudl,
                     need_chi, u_bb, relativistic):
    """The kernel's expansion-opacity event: the bin walk
    (``expansionopacity.bin_walk``) with the continuum opacity floored at
    1e-30 as the Pallas branch floors it, and the bound-bound split
    u_bb <= bb_frac. The cursor is set to -1 and the activating line to -99
    (pallas_rpkt.py:1198-1199). Returns (EventResult, first bin read, bins
    read): a lane reads the bins with path length from the first up to its
    event bin, stopping after the first bin whose lower edge lies beyond the
    abort distance, where the kernel leaves its loop (an event there would
    lie beyond the boundary or the time limit and is never taken)."""
    from .linewalk import EventResult

    w = bin_walk(kappa_rho_dop, nu, tstart, safe_chi, tau_next, dnudl, need_chi,
                 relativistic, BIG)
    seg, d_prev = w["seg"], w["d_prev"]
    b = torch.arange(NBINS, device=nu.device)[None, :]
    last = torch.where(w["anyhit"], w["j"], torch.full_like(w["j"], NBINS - 1))
    read = (seg > 0) & (d_prev <= abort_dist[:, None]) & (b <= last[:, None])
    first = torch.argmax((seg > 0).to(torch.int8), dim=1)
    ev = EventResult(edist=w["edist"], next_trans=torch.full_like(first, -1),
                     is_boundbound=w["anyhit"] & need_chi & (u_bb <= w["bb_frac"]),
                     activating_line=torch.full_like(first, -99))
    return ev, first, read.sum(dim=1)


def propagate_reference(seed: int, lanes: dict, tables: dict, test_tau, test_sel,
                        t2: float, tmin: float, max_path_step: float, *, nlines: int,
                        ncells: int, ngc: int, nphixs: int, max_inner: int,
                        relativistic: bool, phixs_dnu: float,
                        last_nuovernuedge: float, test_mode: bool,
                        geom: int = GEOM_SPH, ncoord=None, want_bfrate: bool = False,
                        expansion: bool = False, defer_scatter: bool = False,
                        nradbins: int = 0, njblue: int = 0, want_gamma: bool = True,
                        want_bfheat: bool = True, ff_only: bool = False,
                        line_chunk: int = 128, walk_log: list | None = None,
                        crossing_log: list | None = None, stage: int | None = None) -> dict:
    """The crossing kernel as a per-crossing loop over (N,) float32 or
    float64 tensors, computing in their precision. Same signature and
    outputs as ``propagate``; ``stage``, the table groups a launch of the
    1D walk stages in shared memory, changes no result and is not read
    here. ``walk_log``, where given,
    gets one (model cell, first entry, end entry) triple of tensors per
    crossing: the lines (in expansion mode, the wavelength bins) each lane's
    walk read there. ``crossing_log``, where given, gets one (boundary
    taken, cell, next cell, cmf frequency at the boundary, cmf frequency
    at the end of the move) tuple of tensors per crossing."""
    from .linewalk import get_event_batch, initial_cursor

    if ff_only:
        tables = ff_only_tables(tables, want_bfrate)
    s = {k: lanes[k].clone() for k in LANE_F32}
    px, py, pz = s["posx"], s["posy"], s["posz"]
    dx, dy, dz = s["dirx"], s["diry"], s["dirz"]
    nurf, nucmf, erf, ecmf, t = s["nu_rf"], s["nu_cmf"], s["e_rf"], s["e_cmf"], s["prop_time"]
    cell = lanes["where"].long()
    ntr = lanes["next_trans"].long()
    moving = lanes["moving"] > 0
    lane_id = lanes["lane_id"]
    n = px.shape[0]
    dev = px.device
    fd = px.dtype
    f32 = fd == F32
    hoverkb = HOVERKB_OF[fd]
    zf = torch.zeros(n, dtype=fd, device=dev)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    terr = zf.clone()
    evented, escaped, ev_thick, ev_isbb = zb.clone(), zb.clone(), zb.clone(), zb.clone()
    ev_act = torch.full_like(zi, -99)
    ev_bfidx, ev_mgi = zi.clone(), zi.clone()
    ev_esc, ev_ff, ev_bf, ev_cont = zf.clone(), zf.clone(), zf.clone(), zf.clone()
    em_x, em_y, em_z, em_t = zf.clone(), zf.clone(), zf.clone(), zf.clone()
    nsc = zi.clone()
    inkscat = zb.clone()
    ncont = tables["cont_nu_edge"].shape[0]
    est = torch.zeros((ncells, 4), dtype=fd, device=dev)
    gam = torch.zeros((ncells, ngc if want_gamma else 0), dtype=fd, device=dev)
    bfh = torch.zeros((ncells, ngc if want_bfheat else 0), dtype=fd, device=dev)
    bfr = torch.zeros((ncells, ncont if want_bfrate else 0), dtype=fd, device=dev)
    rb = torch.zeros((ncells, 3, nradbins), dtype=fd, device=dev)
    jb = torch.zeros((ncells, 2, 0 if expansion else njblue), dtype=fd, device=dev)
    jb_of_line = tables["jblue_of_line"]
    misc = torch.zeros(NMISC, dtype=torch.float64, device=dev)

    mgi_of_cell = tables["mgi_of_cell"].long()
    nprop = mgi_of_cell.shape[0]
    ncoord = ncoord or (nprop, 1, 1)
    cellmin = tables["cellmin"].view(nprop, GEOM_NDIM[geom])
    cellmax = tables["cellmax"].view(nprop, GEOM_NDIM[geom])
    line_nu = tables["line_nu"]
    tau_factor = tables["tau_factor"]
    gidx = tables["cont_gidx"].long()
    gmap = ((gidx[:, None] == torch.arange(ngc, device=dev)[None, :]) & (gidx[:, None] >= 0)).to(fd)
    cont_prob = tables["cont_prob"]
    gc_nu_edge = tables["gc_nu_edge"]

    for it in range(max_inner):
        mask = moving
        if not bool(mask.any()):
            break
        tstart = t
        mgi = mgi_of_cell[cell]
        nonempty = mgi >= 0
        safe_mgi = torch.clamp(mgi, min=0)
        nne_p = tables["nne"][safe_mgi]
        te_p = tables["Te"][safe_mgi]
        kgrey_p = tables["kappagrey"][safe_mgi]
        rho_p = tables["rho"][safe_mgi]
        chiffpart_p = tables["chiffpart"][safe_mgi]
        thick = nonempty & (tables["thick"][safe_mgi] == 1)

        if test_mode:
            tau_next = test_tau
            sel_u = u_split = u_bb = test_sel
            z1 = torch.full_like(zf, 0.37)
            z2 = torch.full_like(zf, 0.81)
        elif f32:
            u = rng.philox_uniform4(seed, lane_id, it, 0)
            tau_next = -torch.log(u[0])
            sel_u, z1, z2 = u[1], u[2], u[3]
            u_split, u_bb = rng.philox_uniform4(seed, lane_id, it, 1)[:2]
        else:
            u_tau, sel_u = rng.philox_uniform2d(seed, lane_id, it, 0)
            tau_next = -torch.log(u_tau)
            z1, z2 = rng.philox_uniform2d(seed, lane_id, it, 1)
            u_split, u_bb = rng.philox_uniform2d(seed, lane_id, it, 2)

        pos2 = px * px + py * py + pz * pz
        sdist, snext = cell_boundary(geom, ncoord, cellmin[cell], cellmax[cell], cell,
                                     (px, py, pz), (dx, dy, dz), tstart, tmin, max_path_step)

        tdist = torch.clamp((t2 - tstart) * CLIGHT_PROP, min=0.0)
        abort_dist = torch.minimum(sdist, tdist)
        doppler = _doppler_at(dx, dy, dz, px, py, pz, tstart, relativistic)
        atime = tstart + abort_dist / CLIGHT_PROP
        nu_cmf_abort = nurf * _doppler_at(dx, dy, dz, px + dx * abort_dist, py + dy * abort_dist,
                                          pz + dz * abort_dist, atime, relativistic)
        dnudl = (nu_cmf_abort - nucmf) / torch.clamp(abort_dist, min=1e-30)
        dnudl = torch.where(dnudl < 0, dnudl, torch.full_like(dnudl, -1e-30))

        need_chi = mask & nonempty & ~thick
        nu = torch.where(need_chi, nucmf, torch.full_like(nucmf, 1e15))
        chi_escat = zf if ff_only else SIGMA_T * nne_p
        nu3_scaled = (nu * 2.0 ** -50) ** 3
        hnu_kt = hoverkb * nu / te_p
        chi_ff = (chiffpart_p * 2.0 ** -75) * (nne_p * 2.0 ** -75) / nu3_scaled * (
            1.0 - torch.exp(-hnu_kt))
        if ncont > 0:
            in_w, sigma = _bf_terms(nu, need_chi, tables, ngc, nphixs, phixs_dnu,
                                    last_nuovernuedge)
            a_g = tables["bf_a"][safe_mgi]
            dep_g = tables["bf_dep"][safe_mgi]
            corr = torch.clamp(1.0 - torch.exp(torch.clamp(dep_g - hnu_kt[:, None], -80.0, 80.0)),
                               min=0.0)
            contrib_bf = torch.where(in_w, a_g * sigma * corr, torch.zeros_like(sigma))
            chi_bf = contrib_bf.sum(dim=1)
            target = sel_u * chi_bf
            hit = torch.cumsum(contrib_bf, dim=1) > target[:, None]
            bf_idx = torch.where(hit.any(dim=1), torch.argmax(hit.to(torch.int8), dim=1), zi)
            contr_nl = torch.where(in_w, sigma * corr * cont_prob[None, :], torch.zeros_like(sigma))
            gamma_contr = contr_nl @ gmap
            misc[7] += in_w.sum()
        else:
            chi_bf = zf
            bf_idx = zi
            gamma_contr = torch.zeros((n, ngc), dtype=fd, device=dev)
        chi_cont_cmf = chi_escat + chi_ff + chi_bf
        chi_cont = chi_cont_cmf * doppler

        if expansion:
            ev, first, walked = _expansion_event(
                tables["expo_kappa"][safe_mgi] * (rho_p * doppler)[:, None], nu, tstart,
                torch.clamp(chi_cont, min=1e-30), tau_next, abort_dist, dnudl, need_chi,
                u_bb, relativistic)
        else:
            jblue = None
            if jb.shape[2]:
                # c e_cmf / nu_cmf, invariant along the free flight
                # (pallas_rpkt.py:1255-1262)
                e_over_nu = torch.where(need_chi, CLIGHT * ecmf / torch.clamp(nu, min=1.0), zf)
                jblue = (jb_of_line, e_over_nu, safe_mgi, jb)
            ev = get_event_batch(
                line_nu, lambda l: tau_factor[safe_mgi[:, None], l], nlines, nu, tstart, ntr,
                chi_cont, tau_next, abort_dist, nu_cmf_abort, dnudl, need_chi, relativistic,
                BIG, chunk=line_chunk, jblue=jblue)
            # line-list cursor advance of the walk (the lines it read)
            first = initial_cursor(line_nu, nu, ntr, nlines)
            walked = torch.clamp(torch.clamp(ev.next_trans, max=nlines) - first, min=0)
        misc[6] += torch.where(need_chi, walked, zi).sum()
        if walk_log is not None:
            read = need_chi & (walked > 0)
            walk_log.append((safe_mgi[read], first[read], (first + walked)[read]))

        chi_grey = kgrey_p * rho_p * doppler
        edist_thick = tau_next / torch.clamp(chi_grey, min=1e-30)
        bigt = torch.full_like(zf, BIG)
        edist = torch.where(thick, edist_thick, torch.where(nonempty, ev.edist, bigt))
        next_trans = torch.where(thick, torch.full_like(ntr, -1),
                                 torch.where(nonempty, ev.next_trans, torch.full_like(ntr, -1)))
        is_bb = ~thick & nonempty & ev.is_boundbound

        take_boundary = mask & (sdist <= tdist) & (sdist <= edist)
        take_event = mask & ~take_boundary & (edist <= tdist)
        take_tlimit = mask & ~take_boundary & ~take_event
        # float32 overshoots a boundary by a few ulps of the radius, so the
        # packet lands inside the next cell (the XLA path's float32-only
        # term, artis_tpu/transport/engine.py:1486-1493)
        over = sdist + 3e-6 * torch.sqrt(pos2) if f32 else sdist
        dist = torch.where(take_boundary, over, torch.where(take_event, edist, tdist))
        dist = torch.clamp(dist, min=0.0)

        crossing_pre = take_boundary & (snext >= 0)
        if defer_scatter:
            # K6: every event, electron and thick-cell grey scattering
            # included, leaves for the event pass (pallas_rpkt.py:1429-1433)
            is_escat = ev_thick_k = zb
        else:
            ev_cont_any = take_event & ~thick & ~is_bb & nonempty
            is_escat = ev_cont_any & (u_split * chi_cont_cmf < chi_escat)
            ev_thick_k = take_event & thick
        scat = is_escat | ev_thick_k
        take_event = take_event & ~scat

        h = dist * 0.5
        mx, my, mz = px + dx * h, py + dy * h, pz + dz * h
        mt = tstart + h / CLIGHT_PROP
        dop_mid = _doppler_at(dx, dy, dz, mx, my, mz, mt, relativistic)
        nucmf1 = torch.minimum(nurf * dop_mid, nucmf)
        ecmf1 = erf * dop_mid
        seg = mask & nonempty
        contrib = torch.where(seg, dist * ecmf1, zf)
        rows = torch.stack([contrib, contrib * nucmf1,
                            torch.where(seg & ~thick, contrib * chi_ff, zf)], dim=1)
        est[:, :3].index_add_(0, safe_mgi, rows)
        est[:, 3].index_add_(0, safe_mgi, (crossing_pre & nonempty).to(fd))
        seg_ok = seg & ~thick
        de = torch.where(seg_ok[:, None], contrib[:, None] * gamma_contr,
                         torch.zeros_like(gamma_contr))
        nuc1 = torch.clamp(nucmf1, min=1e-30)[:, None]
        if want_gamma:
            gam.index_add_(0, safe_mgi, de / nuc1)
        if want_bfheat:
            bfh.index_add_(0, safe_mgi, de * torch.clamp(1.0 - gc_nu_edge[None, :] / nuc1,
                                                         min=0.0))
        if nradbins:
            # J, nuJ and a count per (cell, bin) at the segment midpoint, thick
            # cells included (pallas_rpkt.py:1491-1514)
            b, inside = radbin_index(nucmf1, nradbins)
            sel = seg & inside
            flat = (safe_mgi * (3 * nradbins) + b)[sel]
            rbf = rb.view(-1)
            rbf.index_add_(0, flat, contrib[sel])
            rbf.index_add_(0, flat + nradbins, (contrib * nucmf1)[sel])
            rbf.index_add_(0, flat + 2 * nradbins, torch.ones_like(contrib[sel]))
        if want_bfrate and ncont > 0:
            # detailed photoionisation-rate estimators per (cell, continuum)
            # (radfield.cc:204-233): sigma * corr * probability at the
            # segment-start frequency, weighted by contrib / nu_cmf * doppler
            w_bfr = torch.where(seg_ok, contrib / nuc1[:, 0] * doppler, zf)
            bfr.index_add_(0, safe_mgi, torch.where(in_w, sigma * corr * cont_prob[None, :],
                                                    torch.zeros_like(sigma)) * w_bfr[:, None])

        fx, fy, fz = mx + dx * h, my + dy * h, mz + dz * h
        ft = mt + h / CLIGHT_PROP
        dop2 = _doppler_at(dx, dy, dz, fx, fy, fz, ft, relativistic)
        nucmf2 = torch.minimum(nurf * dop2, nucmf1)
        ecmf2 = erf * dop2
        if f32:
            # compensated t += dist/c (diffusion steps fall below the float32
            # ulp of t; without compensation such packets never advance)
            kah_y = dist / CLIGHT_PROP - terr
            kah_t = tstart + kah_y
            kah_err = (kah_t - tstart) - kah_y
            terr = torch.where(take_tlimit, zf, torch.where(mask, kah_err, terr))
        else:
            # float64: the two half-moves' time, as the XLA path's move_pkt
            kah_t = ft
        t_new = torch.where(take_tlimit, torch.full_like(t, t2), torch.where(mask, kah_t, t))
        px, py, pz = torch.where(mask, fx, px), torch.where(mask, fy, py), torch.where(mask, fz, pz)
        nucmf_out = torch.where(mask, nucmf2, nucmf)
        ecmf_out = torch.where(mask, ecmf2, ecmf)
        ntr = torch.where(mask & ~thick & nonempty, next_trans, ntr)
        ntr = torch.where(mask & ~nonempty, torch.full_like(ntr, -1), ntr)
        escaping = take_boundary & (snext == BOUNDARY_ESCAPE)
        crossing = take_boundary & (snext >= 0)
        if crossing_log is not None:
            crossing_log.append((take_boundary, cell, snext, nu_cmf_abort, nucmf2))
        cell = torch.where(crossing, snext, cell)

        # isotropic cmf re-emission at the post-move position (rpkt.cc:945-970)
        zmu = 2.0 * z1 - 1.0
        zphi = (2.0 * torch.pi) * z2
        sinm = torch.sqrt(torch.clamp(1.0 - zmu * zmu, min=0.0))
        cdx, cdy, cdz = sinm * torch.cos(zphi), sinm * torch.sin(zphi), zmu
        inv_t = 1.0 / ft
        vx, vy, vz = -fx * inv_t, -fy * inv_t, -fz * inv_t
        vsqr = (vx * vx + vy * vy + vz * vz) / CLIGHTSQUARED
        grel = 1.0 / torch.sqrt(torch.clamp(1.0 - vsqr, min=1e-30))
        ndotv = cdx * vx + cdy * vy + cdz * vz
        fact1 = grel * (1.0 - ndotv / CLIGHT)
        fact2 = (grel - grel * grel * ndotv / (grel + 1.0) / CLIGHT) / CLIGHT
        ndx, ndy, ndz = (cdx - vx * fact2) / fact1, (cdy - vy * fact2) / fact1, (cdz - vz * fact2) / fact1
        nlen = torch.sqrt(ndx * ndx + ndy * ndy + ndz * ndz)
        ndx, ndy, ndz = ndx / nlen, ndy / nlen, ndz / nlen
        dop_sc = _doppler_at(ndx, ndy, ndz, fx, fy, fz, ft, relativistic)

        dx, dy, dz = torch.where(scat, ndx, dx), torch.where(scat, ndy, dy), torch.where(scat, ndz, dz)
        nurf = torch.where(scat, nucmf_out / dop_sc, nurf)
        erf = torch.where(scat, ecmf_out / dop_sc, erf)
        nucmf, ecmf, t = nucmf_out, ecmf_out, t_new
        em_x, em_y = torch.where(scat, fx, em_x), torch.where(scat, fy, em_y)
        em_z, em_t = torch.where(scat, fz, em_z), torch.where(scat, ft, em_t)
        nsc = nsc + scat.long()
        inkscat = inkscat | scat
        moving = mask & ~take_event & ~take_tlimit & ~escaping
        evented = evented | take_event
        escaped = escaped | escaping
        ev_thick = (take_event & thick) | (~take_event & ev_thick)
        ev_isbb = (take_event & is_bb) | (~take_event & ev_isbb)
        ev_act = torch.where(take_event, ev.activating_line, ev_act)
        ev_bfidx = torch.where(take_event, bf_idx, ev_bfidx)
        ev_esc = torch.where(take_event, chi_escat, ev_esc)
        ev_ff = torch.where(take_event, chi_ff, ev_ff)
        ev_bf = torch.where(take_event, chi_bf, ev_bf)
        ev_cont = torch.where(take_event, chi_cont_cmf, ev_cont)
        ev_mgi = torch.where(take_event, mgi, ev_mgi)
        misc[0] += mask.sum()
        misc[1] += escaping.sum()
        misc[2] += torch.where(escaping, ecmf_out, zf).double().sum()
        misc[3] += is_escat.sum()
        misc[4] += ev_thick_k.sum()
        misc[5] += crossing.sum()

    out = dict(posx=px, posy=py, posz=pz, dirx=dx, diry=dy, dirz=dz, nu_rf=nurf,
               nu_cmf=nucmf, e_rf=erf, e_cmf=ecmf, prop_time=t, chi_escat=ev_esc,
               chi_ff=ev_ff, chi_bf=ev_bf, chi_cont=ev_cont, em_x=em_x, em_y=em_y,
               em_z=em_z, em_t=em_t, where=cell, next_trans=ntr, evented=evented,
               escaped=escaped, thick=ev_thick, is_bb=ev_isbb, act_line=ev_act,
               bf_idx=ev_bfidx, mgi=ev_mgi, nsc=nsc, inkscat=inkscat)
    out = {k: (v.to(I32) if k in OUT_I32 else v) for k, v in out.items()}
    out["est"] = est
    out["gamma"] = gam
    out["bfheat"] = bfh
    out["bfrate"] = bfr
    out["radbin"] = rb
    out["jblue"] = jb
    out["misc"] = misc
    return out


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_HERE, "csrc", "rpkt_crossing.cu")
_BUILD_DIR = os.path.join(_HERE, "_build")
# the float32 and the float64 instantiations: one library each, built from
# the one source by two nvcc processes at once (RPKT_F64 selects the double
# ones and their entry point)
_LIB = None
_LIB64 = None
BUILD_SECONDS = None
# multiply-add contraction of each library: off in float32, so that the
# kernel rounds like the element-wise plain version it is checked against
# (a near-tie tips the other way less often); on in float64, whose
# contracted roundings stay far inside TOL_F64
FMAD = {"": "-fmad=false", "f64_": "-fmad=true"}


def build() -> ctypes.CDLL:
    """Compile csrc/rpkt_crossing.cu for sm_90a into _build/ (once per
    source hash), its float32 and its float64 instantiations into a library
    each, in parallel, and load both. Returns the float32 library (the
    float64 one is ``_LIB64``). Raises if nvcc fails."""
    global _LIB, _LIB64, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(FMAD).encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    t0 = time.time()
    jobs = []
    for tag, defs in (("", []), ("f64_", ["-DRPKT_F64"])):
        so = os.path.join(_BUILD_DIR, f"librpkt_crossing_{tag}{digest}.so")
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   FMAD[tag], "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defs,
                   "-o", tmp, _SOURCE]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            jobs.append((proc, tmp, so, os.path.join(_BUILD_DIR, f"ptxas_{tag}{digest}.log")))
    for proc, tmp, so, ptxas_log in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
        with open(ptxas_log, "w") as f:
            f.write(err)
        os.replace(tmp, so)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    libs = []
    for tag, entry, prm in (("", "rpkt_crossing_launch", _Params),
                            ("f64_", "rpkt_crossing_launch_f64", _Params64)):
        lib = ctypes.CDLL(os.path.join(_BUILD_DIR, f"librpkt_crossing_{tag}{digest}.so"))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(prm), ptrs, ptrs, ptrs, ctypes.c_void_p]
        libs.append(lib)
    BUILD_SECONDS = time.time() - t0
    _LIB, _LIB64 = libs
    return _LIB


_INT_FIELDS = [
    ("n", ctypes.c_int), ("ncells", ctypes.c_int), ("nprop", ctypes.c_int),
    ("nlines", ctypes.c_int), ("ncont", ctypes.c_int), ("ngc", ctypes.c_int),
    ("nphixs", ctypes.c_int), ("max_inner", ctypes.c_int),
    ("relativistic", ctypes.c_int), ("test_mode", ctypes.c_int),
    ("geom", ctypes.c_int), ("nx", ctypes.c_int), ("ny", ctypes.c_int),
    ("nz", ctypes.c_int), ("want_bfrate", ctypes.c_int), ("shared_rows", ctypes.c_int),
    ("expansion", ctypes.c_int), ("nbins", ctypes.c_int),
    ("defer_scatter", ctypes.c_int), ("nradbins", ctypes.c_int), ("njblue", ctypes.c_int),
    ("want_gamma", ctypes.c_int), ("want_bfheat", ctypes.c_int), ("nrow", ctypes.c_int),
    ("stage", ctypes.c_int),
    ("seed_lo", ctypes.c_uint32), ("seed_hi", ctypes.c_uint32)]
# the real-valued fields, in the launch's precision (RpktParamsT<R> in the
# .cu): t2 of about 7.8e5 s has a 0.06 s ulp in float32
_REAL_FIELDS = ("t2", "tmin", "max_path_step", "phixs_dnu", "last_nuovernuedge", "rb_lo",
                "rb_last", "rb_super", "rb_delta", "sigma_es")


class _Params(ctypes.Structure):
    """Scalar parameters of a float32 launch; field order matches
    RpktParamsT<float> in the .cu."""

    _fields_ = _INT_FIELDS + [(k, ctypes.c_float) for k in _REAL_FIELDS]


class _Params64(ctypes.Structure):
    """Scalar parameters of a float64 launch (RpktParamsT<double>)."""

    _fields_ = _INT_FIELDS + [(k, ctypes.c_double) for k in _REAL_FIELDS]


def _ptrs(names, d):
    arr = (ctypes.c_void_p * len(names))()
    for i, k in enumerate(names):
        arr[i] = d[k].data_ptr()
    return arr


SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper
# Largest estimator rows kept in shared memory. Measured on an H100 at
# N=65536, max_inner=64 (``python3 chip_smoke.py --rows-sweep``: 1D shells,
# 3D models and cylinders of growing cell counts): shared rows won up to
# 24640 B of rows, global atomics from 26560 B: every block zeroes and
# flushes its whole copy, and large copies cut the blocks per SM, while few
# cells make global atomics contend.
SHARED_ROWS_MAX = 25 * 1024


def row_floats(ngc: int, nbfr: int, nradbins: int = 0, njblue: int = 0,
               want_gamma: bool = True, want_bfheat: bool = True) -> int:
    """Estimator floats per cell, in the kernel's order: J, nuJ, ffheating,
    crossings; gamma and bf-heat per ground continuum where on; bf-rate per
    continuum; J, nuJ and count per radiation-field bin; J_b_lu sum and
    count per selected line. The launch passes it to the kernel (``nrow``),
    which sizes its shared rows by it."""
    return (4 + ngc * (int(want_gamma) + int(want_bfheat)) + nbfr + 3 * nradbins
            + 2 * njblue)


def row_bytes(ncells: int, ngc: int, nbfr: int, elem: int = 4, **kw) -> int:
    """Shared memory of one block's estimator rows (``elem`` bytes an
    entry: 4 in a float32 launch, 8 in a float64 one) plus the eight double
    counters; ``kw`` as ``row_floats``."""
    return 8 * NMISC + elem * ncells * row_floats(ngc, nbfr, **kw)


def pick_shared_rows(ncells: int, ngc: int, nbfr: int, elem: int = 4, **kw) -> bool:
    """Whether a launch keeps its estimator rows in shared memory (few
    cells) rather than adding straight into the global rows (many cells);
    ``elem`` and ``kw`` as ``row_bytes``."""
    return row_bytes(ncells, ngc, nbfr, elem, **kw) <= SHARED_ROWS_MAX


def nlte_fields(nradbins: int = 0, njblue: int = 0, want_gamma: bool = True,
                want_bfheat: bool = True) -> bool:
    """Whether a launch takes the kernel's NLTE instantiation (launch_geom)."""
    return bool(nradbins or njblue or not want_gamma or not want_bfheat)


class Redesigns(NamedTuple):
    """Which redesign of the kernel a launch runs (``redesigned``)."""

    k1: bool  # the 1D line walk: staged tables, warp sums (both precisions)
    k3: bool  # the cylindrical line walk's XYDir and row reduction (both precisions)
    k4: bool  # the bin walk's edge table in shared memory (both precisions)
    w64: bool  # the double line loop without fixed divides: K1, the 3D walk (K2 / K5 / K6), K3


def redesigned(geom: int, expansion: bool, nlte: bool, f64: bool = False) -> Redesigns:
    """Whether a launch runs the redesigned 1D line walk (K1), the
    redesigned cylindrical line walk (K3) or the redesigned bin walk of the
    1D and cylindrical grids (K4), each without the NLTE fields
    (k1_redesign / k3_redesign / k4_redesign in the .cu), and whether it
    runs a redesigned double line walk (w64_redesign, line_walk_w64: the 1D
    and cylindrical line walks and the 3D one, which always takes the NLTE
    instantiation). The double bin walk of the 1D and cylindrical grids is
    K4's (bin_walk_w64); the 3D bin walk and the NLTE instantiations of the
    1D and cylindrical grids run the generic body."""
    line = not expansion
    k1 = geom == GEOM_SPH and line and not nlte
    k3 = geom == GEOM_CYL and line and not nlte
    return Redesigns(k1=k1, k3=k3, k4=expansion and not nlte and geom != GEOM_CART,
                     w64=f64 and (k1 or k3 or (geom == GEOM_CART and line)))


_GEOM_NAME = {GEOM_SPH: "GEOM_SPH", GEOM_CYL: "GEOM_CYL", GEOM_CART: "GEOM_CART"}


def kernel_name(geom: int, expansion: bool, nlte: bool, f64: bool = False) -> str:
    """The CUDA kernel of csrc/rpkt_crossing.cu a launch runs (``launch`` /
    ``launch_geom`` there): the redesigned float32 1D line walk's kernel of
    its own, else the generic kernel's instantiation <real type, geometry,
    bin walk, NLTE fields> (the redesigned double 1D walk's too); the 3D
    line walk always takes the NLTE fields."""
    real = "double" if f64 else "float"
    if redesigned(geom, expansion, nlte, f64).k1 and not f64:
        return "rpkt_crossing_kernel_1d<float>"
    nlte = nlte or (geom == GEOM_CART and not expansion)
    return (f"rpkt_crossing_kernel<{real}, {_GEOM_NAME[geom]}, {str(expansion).lower()}, "
            f"{str(nlte).lower()}>")


def dispatchable_kernels() -> set:
    """Every kernel that ``launch_geom`` in csrc/rpkt_crossing.cu can
    dispatch, by ``kernel_name``: each geometry with the line or bin walk,
    with or without the NLTE fields, in both precisions (eleven a precision,
    the 3D line walk always with the NLTE fields): 21 instantiations of the
    generic kernel and the float32 1D line walk's kernel of its own."""
    return {kernel_name(geom, expansion, nlte, f64) for geom in _GEOM_NAME
            for expansion in (False, True) for nlte in (False, True) for f64 in (False, True)}


# Table groups the redesigned 1D line walk copies into shared memory at block
# start, in the order they fill the budget (STAGE_* in the .cu): the cell
# tables, the per-continuum bf tables, the per-(cell, continuum) bf tables,
# the line list with its tau_factor rows. Every entry takes a slot of the
# launch's precision (an int table's too). The default scene's tables take
# 16,560 bytes in float32 and 33,120 in float64, which STAGE_MAX and
# STAGE_MAX_F64 hold; the 101,010-line list fits neither, and that walk reads
# it from global memory. At the double 1D walk's 2 blocks an SM (192
# registers) 40 KB a block leaves most of the SM's shared memory to the L1
# cache.
STAGE_CELL, STAGE_BF, STAGE_BFCELL, STAGE_LINES = 1, 2, 4, 8
STAGE_MAX = 32 * 1024
STAGE_MAX_F64 = 40 * 1024


def stage_words(nprop: int, ncells: int, ncont: int, nphixs: int, ngc: int,
                nlines: int) -> dict:
    """Slots (elements) of each staged table group of a 1D launch, 4 bytes
    each in a float32 launch and 8 in a float64 one."""
    return {STAGE_CELL: 3 * nprop + 6 * ncells, STAGE_BF: ncont * (3 + nphixs) + ngc,
            STAGE_BFCELL: 2 * ncells * ncont, STAGE_LINES: nlines * (1 + ncells)}


def stage_plan(nprop: int, ncells: int, ncont: int, nphixs: int, ngc: int, nlines: int,
               budget: int = None, elem: int = 4) -> tuple[int, int]:
    """(groups, bytes) a 1D launch with ``elem``-byte floats stages: each
    group in order that still fits ``budget`` bytes (STAGE_MAX, in float64
    STAGE_MAX_F64), the others read from global memory."""
    if budget is None:
        budget = STAGE_MAX_F64 if elem == 8 else STAGE_MAX
    mask, used = 0, 0
    for g, words in stage_words(nprop, ncells, ncont, nphixs, ngc, nlines).items():
        if used + elem * words <= budget:
            mask |= g
            used += elem * words
    return mask, used


def smem_bytes(ncells: int, ngc: int, nbfr: int, shared_rows: bool, k1: bool, k4: bool,
               stage_bytes: int = 0, elem: int = 4, **kw) -> int:
    """Dynamic shared memory of a launch (smem_bytes in the .cu): the
    counters, the estimator rows in shared mode, and the staged tables of
    the redesigned 1D walk (K1, ``stage_bytes`` from ``stage_plan``) or the
    bin edges of the redesigned bin walk (K4, ``expo_edges``), in
    ``elem``-byte floats; ``elem`` and ``kw`` as ``row_bytes``."""
    rows = row_bytes(ncells, ngc, nbfr, elem, **kw) if shared_rows else 8 * NMISC
    return rows + (stage_bytes if k1 else 0) + (elem * NBINS if k4 else 0)


_EDGES = {}


def expo_edges(device, dtype=F32) -> torch.Tensor:
    """The lower frequency edges of the NBINS expansion-opacity bins as the
    bin walk compares with them: computed in float64 and rounded to the
    launch's precision, exactly as ``expansionopacity.bin_walk`` computes
    them (cached per device and dtype). The redesigned bin walk of either
    precision reads them from this table in shared memory."""
    if (device, dtype) not in _EDGES:
        b = torch.arange(NBINS, dtype=torch.float64)
        _EDGES[device, dtype] = bin_nu_lower(b).to(dtype).to(device).contiguous()
    return _EDGES[device, dtype]


def estimator_buffers(ncells: int, ngc: int, nbfr: int, nradbins: int = 0, njblue: int = 0,
                      want_gamma: bool = True, want_bfheat: bool = True,
                      device=None, dtype=F32) -> dict:
    """The zeroed outputs a launch accumulates into, as views of one buffer
    filled by one zero fill: misc (NMISC float64 counters) and the est,
    gamma, bfheat, bfrate, radbin and jblue rows (in the launch's
    precision ``dtype``, shapes as ``propagate`` returns them)."""
    shapes = {"est": (ncells, 4), "gamma": (ncells, ngc if want_gamma else 0),
              "bfheat": (ncells, ngc if want_bfheat else 0), "bfrate": (ncells, nbfr),
              "radbin": (ncells, 3, nradbins), "jblue": (ncells, 2, njblue)}
    sizes = [NMISC * 8 // dtype.itemsize] + [math.prod(v) for v in shapes.values()]
    parts = torch.zeros(sum(sizes), dtype=dtype, device=device).split(sizes)
    out = {"misc": parts[0].view(torch.float64)}
    out.update((k, part.view(shape)) for (k, shape), part in zip(shapes.items(), parts[1:]))
    return out


def _launch(seed, lanes, tables, test_tau, test_sel, t2, tmin, max_path_step, *, nlines,
            ncells, ngc, nphixs, max_inner, relativistic, phixs_dnu, last_nuovernuedge,
            test_mode, geom=GEOM_SPH, ncoord=None, want_bfrate=False, expansion=False,
            defer_scatter=False, nradbins=0, njblue=0, want_gamma=True, want_bfheat=True,
            ff_only=False, shared_rows=None, stage=None):
    lib = build()
    dev = lanes["posx"].device
    n = lanes["posx"].shape[0]
    # the launch's precision: the lanes' float dtype, which every float
    # input must share
    fd = lanes["posx"].dtype
    if fd not in (F32, F64):
        raise ValueError(f"the crossing runs in float32 or float64, not {fd}")
    f64 = fd == F64
    if f64:
        lib = _LIB64
    if ff_only:
        tables = ff_only_tables(tables, want_bfrate)
    ncont = tables["cont_nu_edge"].shape[0]
    nprop = tables["mgi_of_cell"].shape[0]
    for k in LANE_F32:
        _check(lanes[k], fd, (n,), k)
    for k in LANE_I32:
        _check(lanes[k], I32, (n,), k)
    for k in TABLES_F32:
        _check(tables[k], fd, None, k)
    for k in TABLES_I32:
        _check(tables[k], I32, None, k)
    _check(test_tau, fd, (n,), "test_tau")
    _check(test_sel, fd, (n,), "test_sel")
    if tables["tau_factor"].shape != (ncells, tables["line_nu"].shape[0]):
        raise ValueError("tau_factor must be (ncells, nlines)")
    if expansion and tables["expo_kappa"].shape != (ncells, NBINS):
        raise ValueError(f"expo_kappa must be (ncells, {NBINS}) in expansion mode")
    njblue = 0 if expansion else njblue  # no line walk in expansion mode
    if njblue and tables["jblue_of_line"].shape != (nlines,):
        raise ValueError("jblue_of_line must be (nlines,) with the J_b_lu estimators on")
    if nradbins == 1:
        raise ValueError("the multibin model needs at least 2 bins")
    if geom not in GEOM_NDIM:
        raise ValueError(f"geometry {geom} is not one the kernel takes")
    ndim = GEOM_NDIM[geom]
    for k in ("cellmin", "cellmax"):
        if tables[k].numel() != nprop * ndim:
            raise ValueError(f"{k} must hold ({nprop}, {ndim}) cell bounds")
    nx, ny, nz = (int(v) for v in (ncoord or (nprop, 1, 1)))
    if {GEOM_SPH: nx, GEOM_CYL: nx * ny, GEOM_CART: nx * ny * nz}[geom] != nprop:
        raise ValueError(f"grid {ncoord} does not have {nprop} cells")
    if geom == GEOM_CART and not nx == ny == nz:
        raise ValueError(f"the 3D geometry needs a cubic grid, got {ncoord}")
    nbfr = ncont if want_bfrate else 0
    rows_kw = dict(nradbins=nradbins, njblue=njblue, want_gamma=want_gamma,
                   want_bfheat=want_bfheat)
    k1, _, k4, _ = redesigned(geom, expansion, nlte_fields(**rows_kw), f64)
    elem = fd.itemsize
    # the staged table groups (stage_plan); a caller may force a mask to
    # test it
    if not k1:
        stage, stage_bytes = 0, 0
    elif stage is None:
        stage, stage_bytes = stage_plan(nprop, ncells, ncont, nphixs, ngc, nlines, elem=elem)
    else:
        words = stage_words(nprop, ncells, ncont, nphixs, ngc, nlines)
        stage_bytes = elem * sum(w for g, w in words.items() if stage & g)
    # estimator rows in shared memory (pick_shared_rows), else atomics
    # straight into the global rows; a caller may force either mode to
    # measure it
    if shared_rows is None:
        shared_rows = pick_shared_rows(ncells, ngc, nbfr, elem, **rows_kw)
    smem = smem_bytes(ncells, ngc, nbfr, shared_rows, k1, k4, stage_bytes, elem, **rows_kw)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the launch needs {smem} bytes of shared memory (> 227 KB)")
    timing = propagate.timing
    if timing is not None and n > 0:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
    # the lane outputs as rows of one float and one int32 buffer, and the
    # accumulated outputs from one zero fill
    fbuf = torch.empty((len(OUT_F32), n), dtype=fd, device=dev)
    ibuf = torch.empty((len(OUT_I32), n), dtype=I32, device=dev)
    out = dict(zip(OUT_F32, fbuf.unbind(0)))
    out.update(zip(OUT_I32, ibuf.unbind(0)))
    out.update(estimator_buffers(ncells, ngc, nbfr, device=dev, dtype=fd, **rows_kw))
    if out["est"].data_ptr() % 16:  # K3's vector reductions need aligned rows
        raise RuntimeError("the estimator rows are not 16-byte aligned")
    rb_lo, rb_last, rb_super, rb_delta = radbin_edges(max(nradbins, 2), fd)
    prm = (_Params64 if f64 else _Params)(n=n, ncells=ncells, nprop=nprop, nlines=nlines,
                  ncont=ncont, ngc=ngc, nphixs=nphixs, max_inner=max_inner,
                  relativistic=int(relativistic), test_mode=int(test_mode), geom=geom,
                  nx=nx, ny=ny, nz=nz, want_bfrate=int(nbfr > 0), shared_rows=int(shared_rows),
                  expansion=int(expansion), nbins=NBINS,
                  defer_scatter=int(defer_scatter), nradbins=nradbins, njblue=njblue,
                  want_gamma=int(want_gamma), want_bfheat=int(want_bfheat),
                  nrow=row_floats(ngc, nbfr, **rows_kw), stage=stage,
                  seed_lo=seed & 0xFFFFFFFF, seed_hi=(seed >> 32) & 0xFFFFFFFF,
                  t2=t2, tmin=tmin, max_path_step=max_path_step, phixs_dnu=phixs_dnu,
                  last_nuovernuedge=last_nuovernuedge, rb_lo=rb_lo, rb_last=rb_last,
                  rb_super=rb_super, rb_delta=rb_delta, sigma_es=0.0 if ff_only else SIGMA_T)
    in_lanes = dict(lanes, test_tau=test_tau, test_sel=test_sel)
    lane_ptrs = _ptrs(LANE_F32 + LANE_I32 + ("test_tau", "test_sel"), in_lanes)
    table_ptrs = _ptrs(TABLES_F32 + TABLES_I32 + ("expo_nu_lo",),
                       dict(tables, expo_nu_lo=expo_edges(dev, fd)))
    out_ptrs = _ptrs(OUT_F32 + OUT_I32 + ("est", "gamma", "bfheat", "bfrate", "radbin", "jblue",
                                          "misc"), out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n > 0:
        if timing is not None:
            ev[1].record()
        launch = lib.rpkt_crossing_launch_f64 if f64 else lib.rpkt_crossing_launch
        err = launch(ctypes.byref(prm), lane_ptrs, table_ptrs, out_ptrs, ctypes.c_void_p(stream))
        if timing is not None:
            ev[2].record()
        if err != 0:
            raise RuntimeError(f"rpkt_crossing launch failed: cudaError {err}")
        configs = [CONFIG_OF_GEOM[geom]] + [c for c, on in (
            (CONFIG_BFRATE, nbfr), (CONFIG_EXPANSION, expansion),
            (CONFIG_DEFERRED, defer_scatter), (CONFIG_MULTIBIN, nradbins),
            (CONFIG_JBLUE, njblue), (CONFIG_FFONLY, ff_only)) if on]
        if f64:
            configs = [c + F64_SUFFIX for c in configs]
        name = kernel_name(geom, expansion, nlte_fields(**rows_kw), f64)
        for c in configs:
            propagate.launches[c] += 1
            propagate.kernels.setdefault(c, set()).add(name)
        if timing is not None:
            ev[3].record()
            timing.append(dict(configs=configs, n=n, events=(ev[0], ev[3]),
                               kernel_events=(ev[1], ev[2])))
    return out


def _check(x, dtype, shape, name):
    if x.dtype != dtype or not x.is_contiguous() or not x.is_cuda:
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                         f"{x.dtype} on {x.device}")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {shape}")


def propagate(seed: int, lanes: dict, tables: dict, test_tau, test_sel, t2: float,
              tmin: float, max_path_step: float, **kw) -> dict:
    """Advance moving r-packets through up to ``max_inner`` crossings.

    lanes: LANE_F32 (N,) float32 or float64 and LANE_I32 (N,) int32
    tensors; tables: TABLES_F32 tensors of the lanes' float dtype /
    TABLES_I32 int32 tensors (see ``kernel_tables``), test_tau / test_sel
    of the lanes' float dtype: float32 launches the float32 instantiation,
    float64 the double one (the float outputs and rows then float64 too);
    ``geom`` / ``ncoord`` the grid (``kernel_geometry``; 1D shells by
    default, as many as ``mgi_of_cell`` has cells); ``want_bfrate``
    turns on the detailed bf-rate estimators; ``defer_scatter`` (K6, the
    dipole mode) hands electron and thick-cell grey scattering events to
    the event pass instead of redirecting them in the kernel; ``nradbins``
    > 0 turns on the multibin estimators, ``njblue`` > 0 the J_b_lu
    estimators of the lines whose ``jblue_of_line`` column is below it;
    ``want_gamma`` / ``want_bfheat`` off skip the LUT estimators;
    ``ff_only`` (the grey opacity cases 0-3, the JAX package's
    opacity_case < 4) takes a free-free continuum (``ff_only_tables`` and
    the kernel's ``sigma_es``): no electron scattering, no bound-free
    opacity, zero LUT gamma / bf-heating contributions, the detailed bf-rate
    rows as in every case (the continuum window empty without them). Returns OUT_F32/OUT_I32 lane tensors plus est
    (ncells, 4: J, nuJ, ffheating, boundary crossings out of the cell),
    gamma and bfheat (ncells, ngc, or ncells x 0 when off), bfrate (ncells, ncont, or
    ncells x 0 when off), radbin (ncells, 3, nradbins: J, nuJ, count),
    jblue (ncells, 2, njblue: raw sum, count) and misc (MISC). ``expansion``
    walks the (ncells, NBINS) ``expo_kappa`` table's
    wavelength bins in place of the line list. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    if lanes["posx"].is_cuda:
        return _launch(seed, lanes, tables, test_tau, test_sel, t2, tmin, max_path_step, **kw)
    return propagate_reference(seed, lanes, tables, test_tau, test_sel, t2, tmin,
                               max_path_step, **kw)


# kernel launches since the last reset, per kernel configuration: plain
# integers that a run resets and reads to show that its main path went
# through the kernel (a bf-rate, expansion, deferred-scatter or free-free
# continuum launch counts for its geometry too). ``propagate.timing``, off (None) unless a caller
# sets a list, gets one record per launch: its configurations, its lanes,
# the CUDA events around the whole wrapper call (``events``: allocations,
# zero fill, host work and kernel) and those right around the ctypes call
# (``kernel_events``: the kernel).
CONFIG_OF_GEOM = {GEOM_SPH: "rpkt_crossing_sph1d", GEOM_CYL: "rpkt_crossing_cyl2d",
                  GEOM_CART: "rpkt_crossing_cart3d"}
CONFIG_BFRATE = "rpkt_crossing_bfrate"
CONFIG_EXPANSION = "rpkt_crossing_expansion"
CONFIG_DEFERRED = "rpkt_crossing_deferred"
CONFIG_MULTIBIN = "rpkt_crossing_multibin"
CONFIG_JBLUE = "rpkt_crossing_jblue"
CONFIG_FFONLY = "rpkt_crossing_ffonly"
CONFIGS_F32 = (*CONFIG_OF_GEOM.values(), CONFIG_BFRATE, CONFIG_EXPANSION, CONFIG_DEFERRED,
               CONFIG_MULTIBIN, CONFIG_JBLUE, CONFIG_FFONLY)
# a float64 launch counts for the double forms of its configurations
F64_SUFFIX = "_f64"
propagate.launches = dict.fromkeys(CONFIGS_F32 + tuple(c + F64_SUFFIX for c in CONFIGS_F32), 0)
# the CUDA kernels (``kernel_name``) each configuration's launches ran since
# the last reset
propagate.kernels = {}
propagate.timing = None


def reset_launches() -> None:
    for k in propagate.launches:
        propagate.launches[k] = 0
    propagate.kernels.clear()


def kernel_geometry(grid) -> dict:
    """The ``geom`` and ``ncoord`` keywords of ``propagate`` for a grid."""
    return dict(geom=int(grid.grid_type.value), ncoord=tuple(int(v) for v in grid.ncoordgrid))


# Tolerances of compare_outputs. Both versions draw the same Philox numbers,
# so they differ only by float32 rounding (CUDA's math functions against
# torch's), which can tip a rare near-tie (boundary against event, a line at
# the walk's optical-depth threshold) the other way. Such lanes end in
# another cell or as another packet type: at most 6 of 65536 on an H100, so
# a launch may have DIVERGED_MIN of them or a DIVERGED_FRAC share of its
# lanes, whichever is more; a geometry fault that sends lanes to a wrong
# neighbour misroutes far more.
DIVERGED_MIN = 16
DIVERGED_FRAC = 2.5e-4
FIELD_AGREE = 0.999  # every other integer output, and floats within FIELD_RTOL
FIELD_RTOL = 1e-4  # float32 rounding differences are ~1e-6 relative
STATE_RTOL = 2e-3  # max over lanes: prop_time, nu_cmf, e_cmf, position
# per-cell estimator rows: float32 atomics add in an order that changes from
# run to run; J / nuJ / ffheating / crossings and the multibin and J_b_lu
# sums to 5e-3, LUT gamma and bf-heating to 1e-2 (the JAX package's sum
# tolerances), each cell plus a 1e-6 share of its column's total for cells
# that hold almost nothing.
EST_RTOL = {"j": 5e-3, "nuj": 5e-3, "ffheating": 5e-3, "ncross": 5e-3, "gamma": 1e-2,
            "bfheat": 1e-2, "bfrate": 1e-2, "radbin": 5e-3, "jblue": 5e-3}
# The multibin and J_b_lu rows count whole events, and their counts are held
# exactly, except for what a float32 near-tie moves in a lane whose outcome
# agrees (the kernel's expf / logf against torch's move a distance by an
# ulp): a segment midpoint within rounding of a bin edge lands its J, nuJ and
# count in the neighbouring bin (a bin flip), and a line within rounding of
# a crossing's abort frequency is passed in the crossing before or after
# the boundary, so its J_b_lu pass lands in the neighbouring cell (a moved
# pass). At most DIVERGED_MIN of each per comparison; the entries they touch
# are held through their sums (over bins per cell, over cells per line).
VECTORS = {"pos": ("posx", "posy", "posz"), "dir": ("dirx", "diry", "dirz"),
           "em": ("em_x", "em_y", "em_z")}


class Tolerance(NamedTuple):
    diverged_min: int  # lanes that may end in another cell or packet type
    diverged_frac: float  # or this share of the lanes, whichever is more
    field_agree: float  # share of lanes whose every other output agrees
    field_rtol: float  # a float output agrees within this
    state_rtol: float  # max over lanes: prop_time, nu_cmf, e_cmf, position
    est_rtol: dict  # per estimator, each cell
    est_share: float  # plus this share of its column's total
    misc_rtol: float  # counters, plus 3 packets


TOL_F32 = Tolerance(DIVERGED_MIN, DIVERGED_FRAC, FIELD_AGREE, FIELD_RTOL, STATE_RTOL, EST_RTOL,
                    1e-6, 0.02)
# float64 launches: the kernel and its plain version evaluate the same
# double expressions in the same order, so they differ by the last bits of
# CUDA's math functions against torch's (lane outputs within 4.9e-13 on an
# H100) and by the order of the estimator atomics, which round each of up
# to some 1e7 adds an entry by 1.1e-16 (multibin entries within 5.9e-10):
# every float output to 1e-9, every estimator cell to 1e-8, at most 4
# lanes tipped by a near-tie, and the counters of the launch with those
# lanes held still to 1e-9 (check_kernel)
TOL_F64 = Tolerance(4, 0.0, 0.9999, 1e-9, 1e-9, dict.fromkeys(EST_RTOL, 1e-8), 1e-12, 1e-9)
TOLERANCE = {F32: TOL_F32, F64: TOL_F64}


def compare_outputs(k: dict, p: dict, est: tuple | None = None) -> tuple[bool, dict]:
    """Hold the kernel's outputs ``k`` to the plain version's ``p`` (same
    inputs, same draws): every lane output, every estimator cell and every
    counter. The estimators are taken from the (kernel, plain) outputs
    ``est`` when given (see ``check_kernel``). Returns (ok, report); ``report["nonzero"]`` says
    which plain estimator columns accumulated anything, so a caller can
    require each to be exercised by at least one case. The tolerances are
    those of the outputs' precision (``TOLERANCE``); in float64 the
    counters too come from ``est``."""
    tol = TOLERANCE[p["posx"].dtype]
    gk = {f: v.detach().cpu().numpy() for f, v in k.items()}
    gp = {f: v.detach().cpu().numpy() for f, v in p.items()}
    rep, ok = {}, True
    same_cell = gk["where"] == gp["where"]
    same_type = (gk["escaped"] == gp["escaped"]) & (gk["evented"] == gp["evented"])
    both = same_cell & same_type
    rep["cell_agree"] = float(same_cell.mean())
    rep["ptype_agree"] = float(same_type.mean())
    rep["diverged_lanes"] = int((~both).sum())
    ok &= rep["diverged_lanes"] <= max(tol.diverged_min, tol.diverged_frac * both.size)
    same = both.copy()
    for f in OUT_I32:
        if f in ("where", "escaped", "evented"):
            continue
        eq = gk[f][both] == gp[f][both]
        rep[f"{f}_agree"] = float(eq.mean()) if eq.size else 1.0
        ok &= rep[f"{f}_agree"] >= tol.field_agree
        same &= gk[f] == gp[f]

    def err(names):
        a = np.stack([gp[f][same].astype(np.float64) for f in names], 1)
        b = np.stack([gk[f][same].astype(np.float64) for f in names], 1)
        scale = np.maximum(np.maximum(np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)),
                           1e-30)
        return np.linalg.norm(b - a, axis=1) / scale

    in_vec = {f for names in VECTORS.values() for f in names}
    groups = dict(VECTORS, **{f: (f,) for f in OUT_F32 if f not in in_vec})
    for name, names in groups.items():
        e = err(names)
        rep[f"{name}_maxrel"] = float(e.max()) if e.size else 0.0
        rep[f"{name}_within"] = float((e <= tol.field_rtol).mean()) if e.size else 1.0
        ok &= rep[f"{name}_within"] >= tol.field_agree
        if name in ("pos", "prop_time", "nu_cmf", "e_cmf"):
            ok &= rep[f"{name}_maxrel"] <= tol.state_rtol

    def columns(g):
        return {"j": g["est"][:, 0], "nuj": g["est"][:, 1], "ffheating": g["est"][:, 2],
                "ncross": g["est"][:, 3], "gamma": g["gamma"], "bfheat": g["bfheat"],
                "bfrate": g["bfrate"]}

    def host(pair):
        if pair is None:
            return gp, gk
        return tuple({f: v.detach().cpu().numpy() for f, v in d.items()} for d in pair[::-1])

    ge_p, ge_k = host(est)
    cols, colk = columns(ge_p), columns(ge_k)
    rep["nonzero"] = {}
    for name, a in cols.items():
        a = a.astype(np.float64)
        b = colk[name].astype(np.float64)
        if a.shape != b.shape:
            raise ValueError(f"{name}: kernel {b.shape} against plain {a.shape}")
        total = np.abs(a).sum(axis=0)
        excess = np.abs(b - a) - tol.est_rtol[name] * np.abs(a) - tol.est_share * total
        rep[f"{name}_cellmaxrel"] = (float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-300)))
                                     if a.size else 0.0)
        rep["nonzero"][name] = bool(total.sum() > 0)
        ok &= bool(np.all(excess <= 0))
    for name, fn in (("radbin", _compare_radbins), ("jblue", _compare_jblue)):
        a = ge_p[name].astype(np.float64)
        b = ge_k[name].astype(np.float64)
        if a.shape != b.shape:
            raise ValueError(f"{name}: kernel {b.shape} against plain {a.shape}")
        rep["nonzero"][name] = bool(np.abs(a).sum() > 0)
        if a.size:
            ok_c, rep_c = fn(a, b, tol)
            rep.update(rep_c)
            ok &= ok_c
    # counters within 2% + 3 packets (the JAX package's crossing-count
    # tolerance; float64: 1e-9 + 3 packets, with the tipped lanes held
    # still); the escaped energy within as much + 3 packets' energy
    e_pkt = float(np.max(np.abs(gp["e_cmf"]))) if gp["e_cmf"].size else 0.0
    mp, mk = (ge_p, ge_k) if p["posx"].dtype == F64 else (gp, gk)
    for i, name in enumerate(MISC):
        a, b = float(mp["misc"][i]), float(mk["misc"][i])
        rep[f"{name}_plain"], rep[f"{name}_kernel"] = a, b
        ok &= abs(b - a) <= tol.misc_rtol * abs(a) + 3 * (e_pkt if name == "cmf_lum" else 1.0)
    return bool(ok), rep


def _held_close(a, b, clean, axis, rtol, share):
    """Sums ``a`` (plain) and ``b`` (kernel) of one estimator: every entry
    where ``clean`` to ``rtol`` plus a ``share`` of its column's total,
    and the sums over ``axis`` to ``rtol`` plus a ``share`` of their
    total. Returns (ok, the largest relative difference of a clean entry)."""
    ta, tb = a.sum(axis=axis), b.sum(axis=axis)
    ok = bool(np.all(np.abs(tb - ta) <= rtol * np.abs(ta) + share * np.abs(ta).sum()))
    excess = np.abs(b - a) - rtol * np.abs(a) - share * np.abs(a).sum(axis=0)[None, :]
    ok &= bool(np.all(excess[clean] <= 0))
    with np.errstate(over="ignore"):
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-300)
    return ok, float(rel[clean].max()) if clean.any() else 0.0


def _compare_radbins(a, b, tol):
    """The multibin rows (ncells, 3, nbins: J, nuJ, count) of the kernel
    ``b`` against the plain version's ``a`` (see EST_RTOL; ``tol`` the
    precision's Tolerance): the running sum
    over bins of a cell's count difference is nonzero exactly at its bin
    flips; at most ``tol.diverged_min`` of them (with multiplicity), every cell's
    count over bins exact, every (cell, bin) entry that no flip touches
    exact in its count and within the rtol in J and nuJ, and every cell's J
    and nuJ over bins within the rtol."""
    rep = {}
    cum = np.cumsum(b[:, 2] - a[:, 2], axis=1)  # (ncells, nbins)
    rep["radbin_flips"] = int(np.abs(cum[:, :-1]).sum())
    ok = rep["radbin_flips"] <= tol.diverged_min and bool(np.all(cum[:, -1] == 0))
    prev = np.concatenate([np.zeros_like(cum[:, :1]), cum[:, :-1]], axis=1)
    clean = (cum == 0) & (prev == 0)
    for k, name in ((0, "radbin_j"), (1, "radbin_nuj")):
        ok_k, rep[f"{name}_cellmaxrel"] = _held_close(a[:, k], b[:, k], clean, 1,
                                                      tol.est_rtol["radbin"], tol.est_share)
        ok &= ok_k
    return bool(ok), rep


def _compare_jblue(a, b, tol):
    """The J_b_lu rows (ncells, 2, njblue: sum, count) of the kernel ``b``
    against the plain version's ``a`` (see EST_RTOL; ``tol`` the
    precision's Tolerance): every line's count over cells exact, at most
    ``tol.diverged_min`` moved passes (half the summed
    count differences), every (cell, line) entry that no moved pass
    touches exact in its count and within the rtol in its sum, and every
    line's sum over cells within the rtol."""
    rep = {}
    diff = b[:, 1] - a[:, 1]
    rep["jblue_moved"] = int(np.abs(diff).sum()) // 2
    ok = rep["jblue_moved"] <= tol.diverged_min and bool(np.all(diff.sum(axis=0) == 0))
    ok_s, rep["jblue_cellmaxrel"] = _held_close(a[:, 0], b[:, 0], diff == 0, 0,
                                                tol.est_rtol["jblue"], tol.est_share)
    return bool(ok & ok_s), rep


def held_lanes(k: dict, p: dict) -> torch.Tensor:
    """The lanes ``check_kernel`` holds still for its estimator comparison:
    every lane on which any integer output of the kernel's outputs ``k``
    differs from the plain version's ``p`` (cell, escape, event, cursor,
    line, continuum, scatter counts...). A lane tipped by a near-tie adds
    other crossings, scatters or line passes to the rows even where it ends
    in the same cell as a packet of the same type."""
    differs = torch.zeros(k["where"].shape, dtype=torch.bool, device=k["where"].device)
    for f in OUT_I32:
        differs |= k[f].to(differs.device) != p[f].to(differs.device)
    return differs


def _jblue_counts(out: dict) -> torch.Tensor:
    """The J_b_lu pass counts of a launch, flat over (estimator row, line)."""
    return out["jblue"][:, 1].reshape(-1)


def count_lanes(launch_pair, lanes: torch.Tensor, diff: torch.Tensor, limit: int):
    """Among ``lanes`` (indices), those whose own J_b_lu counts differ
    between the kernel and the plain version; ``diff`` is the kernel's
    counts less the plain version's for all of them (``_jblue_counts``).
    Found by halves: ``launch_pair(indices)`` gives the (kernel, plain)
    outputs of those lanes alone, and a half's difference is its group's
    less the other half's (lanes add into the rows independently). Returns
    a list of (index, that lane's difference), or None when more than
    ``limit`` lanes differ."""
    found, groups = [], [(lanes, diff)]
    while groups:
        group, d = groups.pop()
        if not bool(d.any()):
            continue
        if group.numel() == 1:
            found.append((group, d))
            if len(found) > limit:
                return None
            continue
        half = group.numel() // 2
        k, p = launch_pair(group[:half])
        d1 = _jblue_counts(k) - _jblue_counts(p)
        groups += [(group[:half], d1), (group[half:], d - d1)]
    return found


# a line within this many ulps of the cmf frequencies a boundary spans is a
# near-tie with it (the kernel's expf / logf against torch's move a
# distance, and with it a frequency, by an ulp or two)
TIE_ULPS = 16


def _counts_nothing(c: torch.Tensor, tables: dict) -> torch.Tensor:
    """Whether lines passed in cell ``c`` (an index of the propagation grid,
    negative past the grid's edge) add to no J_b_lu row: past the edge, in
    an empty cell (no estimator row, ``mgi_of_cell`` -1) or in an optically
    thick one (no line walk)."""
    mgi = tables["mgi_of_cell"].long()[c.clamp(min=0)]
    thick = tables["thick"].long()[mgi.clamp(min=0)] == 1
    return (c < 0) | (mgi < 0) | thick


def moved_to_nothing(d: torch.Tensor, crossings: list, tables: dict) -> bool:
    """Whether one lane's J_b_lu count difference ``d`` (kernel less plain,
    (estimator rows, J_b_lu columns)) is a near-tie at a boundary to a cell
    that counts nothing (``_counts_nothing``): each differing (row, column)
    differs by one pass, and on some boundary of the lane's path
    (``crossings``: the plain version's ``crossing_log`` of the lane alone)
    one side is that row's cell and the other counts nothing, and a line
    of that column lies within ``TIE_ULPS`` of the cmf frequencies the
    boundary spans (the frequency at the boundary and the one after the
    move past it). The line is then passed before the boundary by one
    version and after it, where no row counts it, by the other."""
    mgi_of_cell = tables["mgi_of_cell"].long()
    line_nu = tables["line_nu"].double()
    jb_of_line = tables["jblue_of_line"].long()
    eps = TIE_ULPS * torch.finfo(tables["line_nu"].dtype).eps
    bounds = []
    for taken, cell, snext, nu_at, nu_after in crossings:
        if bool(taken[0]):
            lo, hi = sorted((float(nu_at[0]), float(nu_after[0])))
            sides = (int(cell[0]), int(snext[0]))
            nothing = _counts_nothing(torch.tensor(sides, device=cell.device), tables).tolist()
            bounds.append((sides, nothing, lo * (1 - eps), hi * (1 + eps)))

    def tie(row, nus, sides, nothing, lo, hi):
        # one side counts into ``row``, the other counts nothing, and a line
        # of the column lies at the boundary's frequency
        return (any(nothing[1 - i] and not nothing[i] and int(mgi_of_cell[sides[i]]) == row
                    for i in (0, 1))
                and bool(((nus >= lo) & (nus <= hi)).any()))

    for row, col in torch.nonzero(d).tolist():
        nus = line_nu[jb_of_line == col]
        if abs(float(d[row, col])) != 1.0 or not any(tie(row, nus, *b) for b in bounds):
            return False
    return True


def check_kernel(seed: int, lanes: dict, tables: dict, test_tau, test_sel, t2: float,
                 tmin: float, max_path_step: float, shared_rows=None, stage=None, **kw):
    """Launch the kernel on CUDA lanes, run its plain version on the same
    inputs and compare them (``compare_outputs``). Float32 rounding (CUDA's
    math functions against torch's) can tip a near-tie, after which a lane
    follows another path, through other cells or with other events;
    ``compare_outputs`` allows only a few lanes whose cell or packet type
    differs (DIVERGED_MIN, DIVERGED_FRAC) and a small share with another
    integer output, but even those move the estimators of cells that few
    lanes visit by more than their rounding tolerance. Every lane with a
    differing integer output (``held_lanes``) is therefore held still
    (``moving`` = 0) in a second launch of both versions, whose estimators
    (and, in float64, counters) are compared cell by cell; lane outputs come
    from the first. A lane's J_b_lu pass counts are integer outputs too:
    where the comparison fails and the J_b_lu counts of that
    launch differ, the lanes whose own counts gain or lose a pass
    (``count_lanes``, at most the tolerance's ``diverged_min`` lanes whose
    counts differ) are held still as well and the estimators compared
    again, but only if each is a near-tie at a boundary to a cell that
    counts nothing (``moved_to_nothing``): a line within
    rounding of the boundary's cmf frequency, passed before it by one
    version and after it, where no row counts it, by the other. Any other
    such lane leaves the comparison failed. ``report["held_lanes"]``
    counts the lanes held, ``report["count_held_lanes"]`` those of them
    (the second launch is made where the first is not 0),
    ``report["count_lanes_unexplained"]`` the count lanes without that
    cause (-1: more than ``diverged_min``), ``report["launches"]`` the
    kernel launches made. Returns (ok, report, kernel outputs, plain
    outputs)."""
    launches = []

    def pair(*a):
        launches.append(1)
        return (_launch(*a, shared_rows=shared_rows, stage=stage, **kw),
                propagate_reference(*a, **kw))

    def held_pair():
        still = dict(lanes, moving=torch.where(mask, torch.zeros_like(lanes["moving"]),
                                               lanes["moving"]).contiguous())
        return pair(seed, still, *args[2:])

    def sub(idx):
        return (seed, {f: v[idx].contiguous() for f, v in lanes.items()}, tables,
                test_tau[idx].contiguous(), test_sel[idx].contiguous()) + args[5:]

    def crossings(idx):
        out = []
        propagate_reference(*sub(idx), crossing_log=out, **kw)
        return out

    args = (seed, lanes, tables, test_tau, test_sel, t2, tmin, max_path_step)
    k, p = pair(*args)
    mask = held_lanes(k, p)
    est = held_pair() if bool(mask.any()) else None
    ok, rep = compare_outputs(k, p, est)
    counted, unexplained = 0, 0
    ek, ep = est or (k, p)
    diff = _jblue_counts(ek) - _jblue_counts(ep)
    if not ok and bool(diff.any()):
        found = count_lanes(lambda idx: pair(*sub(idx)),
                            torch.nonzero(~mask & (lanes["moving"] > 0))[:, 0], diff,
                            TOLERANCE[lanes["posx"].dtype].diverged_min)
        # a lane whose passes only moved between cells with rows is
        # compare_outputs' to judge; one that gained or lost a pass must be
        # such a near-tie
        shape = p["jblue"][:, 1].shape
        lost = [(idx, d.view(shape)) for idx, d in found or ()
                if bool(d.view(shape).sum(dim=0).any())]
        unexplained = -1 if found is None else sum(
            not moved_to_nothing(d, crossings(idx), tables) for idx, d in lost)
        if lost and not unexplained:
            counted = len(lost)
            mask[torch.cat([idx for idx, _ in lost])] = True
            est = held_pair()
            ok, rep = compare_outputs(k, p, est)
    rep["held_lanes"] = int(mask.sum())
    rep["count_held_lanes"] = counted
    rep["count_lanes_unexplained"] = unexplained
    rep["launches"] = len(launches)
    return ok, rep, k, p


def kernel_tables(dad, grid, cells, ctx, dtype=F32) -> dict:
    """The per-timestep table set of the kernel, ``dtype`` (the run's
    transport dtype, float32 or float64) / int32 contiguous on the cells'
    device (the wrapper-side counterpart of rpkt_step_pallas's table dict). The cell bounds are the grid's (ngrid, ndim) tables at
    tmin; the model cell of each propagation cell is the grid's host-built
    ``nonemptymgi_of_cell``, so every model dimensionality maps as the XLA
    path maps it. ``expo_kappa`` is the context's (ncells, NBINS) expansion
    opacity table (a placeholder when that mode is off)."""
    dev = cells.Te.device
    ncells = cells.Te.shape[0]
    ngc = max(dad.nbfcontinua_ground, 1)

    def f(x):
        return x.to(device=dev, dtype=dtype).contiguous()

    def i(x):
        return x.to(device=dev, dtype=I32).contiguous()

    if dad.nbfcontinua:
        gidx = torch.where(dad.cont_groundindex < ngc, dad.cont_groundindex,
                           torch.full_like(dad.cont_groundindex, -1))
        cont = dict(
            cont_nu_edge=f(dad.cont_nu_edge), bf_a=f(ctx.bf_a), bf_dep=f(ctx.bf_dep),
            cont_phixs=f(dad.allphixs[torch.clamp(dad.cont_phixsrow, 0,
                                                  dad.allphixs.shape[0] - 1)]),
            cont_prob=f(dad.cont_probability), cont_gidx=i(gidx))
    else:
        cont = dict(
            cont_nu_edge=torch.zeros(0, dtype=dtype, device=dev),
            bf_a=torch.zeros((ncells, 0), dtype=dtype, device=dev),
            bf_dep=torch.zeros((ncells, 0), dtype=dtype, device=dev),
            cont_phixs=torch.zeros((0, dad.nphixspoints), dtype=dtype, device=dev),
            cont_prob=torch.zeros(0, dtype=dtype, device=dev),
            cont_gidx=torch.zeros(0, dtype=I32, device=dev))
    return dict(
        mgi_of_cell=i(grid.nonemptymgi_of_cell),
        cellmin=f(grid.cell_pos_min), cellmax=f(grid.cell_pos_max),
        nne=f(cells.nne), Te=f(cells.Te), kappagrey=f(cells.kappagrey), rho=f(cells.rho),
        thick=i(cells.thick), chiffpart=f(ctx.chi_ff_nnionpart), line_nu=f(dad.line_nu),
        tau_factor=f(ctx.tau_sob_factor), gc_nu_edge=f(dad.groundcont_nu_edge[:ngc]),
        expo_kappa=f(ctx.expopac_kappa), jblue_of_line=i(ctx.jblue_of_line), **cont)

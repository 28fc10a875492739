"""The Sobolev line walk (`get_event`), batched over packets.

Port of the JAX package's line walk (reference: rpkt.cc:77-197 get_event,
rpkt.h:55-117 get_linedistance/closest_transition) with the outcome rules of
the crossing kernel it serves (``rpkt_kernel``). Each packet walks its own
window of the nu-descending linelist, starting at its cursor, one chunk of
lines per step for the whole batch.

Closed forms for the cumulative distance to line k:
- relativistic mode: nu is linear in distance (rpkt.cc:141-149), so
  D_k = (nu_k - nu_cur) / d_nu_on_d_l;
- first-order mode: t nu_cmf is conserved along the ray (rpkt.h:72), so
  D_k = c t_cur (nu_cur/nu_k - 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..atomic import DeviceAtomicData
from ..constants import CLIGHT_PROP, HCLIGHTOVERFOURPI


class EventResult(NamedTuple):
    edist: torch.Tensor  # distance to event; `big` if none before abort
    next_trans: torch.Tensor  # updated linelist cursor
    is_boundbound: torch.Tensor  # bool
    activating_line: torch.Tensor  # lineindex for bb events, -99 otherwise


def build_tau_factor(dad: DeviceAtomicData, levelpops):
    """(ncells, nlines) Sobolev opacity factor tau_sobolev / t, built once
    per timestep from the level populations (the reference's per-cell
    cellcache of tau_sobolevs, update_grid.cc:62-110)."""
    dt = levelpops.dtype
    n_l = levelpops[:, dad.line_lowerunique]
    n_u = levelpops[:, dad.line_upperunique]
    return torch.clamp((dad.line_blu.to(dt)[None, :] * n_l - dad.line_bul.to(dt)[None, :] * n_u)
                       * HCLIGHTOVERFOURPI, min=0.0)


def initial_cursor(line_nu, nu, next_trans, nlines: int):
    """Linelist cursor at the start of a walk: the packet's own cursor when
    it holds one (> 0), else the count of lines bluer than nu; nlines when
    the packet is past the list or redder than its last line."""
    searched = torch.searchsorted(-line_nu, -nu.contiguous(), right=False)
    cursor = torch.where(next_trans > 0, next_trans, searched)
    no_lines = (next_trans > nlines - 1) | (nu < line_nu[nlines - 1])
    return torch.where(no_lines, torch.full_like(cursor, nlines),
                       torch.clamp(cursor, max=nlines))


def get_event_batch(line_nu, tau_rows, nlines: int, nu, tstart, next_trans, chi_cont,
                    tau_next, abort_dist, nu_cmf_abort, dnudl, need, relativistic: bool,
                    big: float, chunk: int = 128, jblue=None) -> EventResult:
    """Walk each packet's line window until its first terminal event.

    line_nu: (L,) descending; tau_rows: callable(lines (B, K)) -> (B, K)
    Sobolev factors of each packet's cell; need: packets that walk.
    Outcome rules follow the crossing kernel: a continuum event (optical
    depth reached between lines), an abort (frequency passes the abort
    point), a bound-bound event (the line's own tau reaches the target), or
    the end of the list.

    ``jblue`` = (jblue_of_line (L,) int, e_over_nu (B,), cell (B,), acc
    (ncells, 2, njblue)) turns on the detailed J_b_lu estimators (reference:
    rpkt.cc:151-167, radfield.cc:761-771): every line a packet sweeps before
    its terminal line, and the activating line of a bound-bound event, adds
    (tstart + D / c) * e_over_nu to acc[cell, 0, column] and 1 to
    acc[cell, 1, column] when its column (jblue_of_line) is below njblue.
    ``e_over_nu`` is c e_cmf / nu_cmf at the walk's start, invariant along
    the free flight. acc is added to in place.
    """
    dtype = nu.dtype
    dev = nu.device
    cursor0 = initial_cursor(line_nu, nu, next_trans, nlines)
    no_lines = cursor0 >= nlines
    safe_chi = torch.clamp(chi_cont, min=1e-30)
    nl_contdist = torch.clamp(tau_next / safe_chi, min=0.0)
    nl_cont = no_lines & need & (nl_contdist <= abort_dist)

    zf = torch.zeros_like(nu)
    tau_cum = zf.clone()
    lastD = zf.clone()
    done = ~need | no_lines
    edist = torch.where(nl_cont, nl_contdist, torch.full_like(nu, big))
    ntr = torch.where(nl_cont, torch.full_like(next_trans, nlines + 1), next_trans)
    isbb = torch.zeros_like(need)
    act = torch.full_like(next_trans, -99)
    karange = torch.arange(chunk, device=dev)
    c = 0
    while bool((~done).any()):
        base = cursor0 + c * chunk
        l_glob = base[:, None] + karange[None, :]
        beyond = l_glob > nlines - 1
        lsafe = torch.clamp(l_glob, 0, nlines - 1)
        nu_k = line_nu[lsafe]
        tau_blk = tau_rows(lsafe)
        validk = ~beyond & ~done[:, None]
        if relativistic:
            relD = (nu_k - nu[:, None]) / dnudl[:, None]
        else:
            relD = CLIGHT_PROP * tstart[:, None] * (nu[:, None] / nu_k - 1.0)
        relD = torch.clamp(relD, 0.0, 1e30)
        relD = torch.where(validk, relD, zf[:, None])
        # tau_sobolev at the time of the previous line (rpkt.cc:123)
        relD_prev = torch.cat([lastD[:, None], relD[:, :-1]], dim=1)
        t_prev = tstart[:, None] + relD_prev / CLIGHT_PROP
        tau_line = torch.where(validk, tau_blk * t_prev, zf[:, None])
        # exclusive running sum computed directly: inclusive-minus-last leaves
        # a rounding residue that once made a thick line unreachable
        excl = torch.cat([zf[:, None], torch.cumsum(tau_line[:, :-1], dim=1)], dim=1)
        s_cum = excl + tau_cum[:, None]
        contdist = torch.clamp((tau_next[:, None] - s_cum) / safe_chi[:, None], min=0.0)
        ev_cont = (validk & (contdist <= relD)) | (~validk & (contdist <= abort_dist[:, None]))
        ev_abort = validk & (nu_k < nu_cmf_abort[:, None])
        ev_bb = validk & (tau_next[:, None] - s_cum <= safe_chi[:, None] * relD + tau_line)
        terminal = (ev_cont | ev_abort | ev_bb | beyond) & ~done[:, None]
        any_term = terminal.any(dim=1)
        jsel = torch.argmax(terminal.to(torch.int8), dim=1)[:, None]

        def pick(x):
            return torch.gather(x, 1, jsel)[:, 0]

        j_valid = pick(validk)
        j_cont = pick(ev_cont)
        j_abort = pick(ev_abort) & ~j_cont
        j_bb = pick(ev_bb) & ~j_cont & ~j_abort & j_valid
        j_cont_invalid = ~j_valid & j_cont
        j_noevent = ~j_valid & ~j_cont
        lineindex_j = torch.clamp(base + jsel[:, 0], 0, nlines - 1)
        newly = any_term & ~done
        edist = torch.where(newly & (j_cont | j_cont_invalid), pick(contdist), edist)
        edist = torch.where(newly & j_bb, pick(relD), edist)
        ntr = torch.where(newly & j_valid & (j_cont | j_abort), lineindex_j, ntr)
        ntr = torch.where(newly & j_bb, lineindex_j + 1, ntr)
        ntr = torch.where(newly & j_cont_invalid, torch.full_like(ntr, nlines + 1), ntr)
        ntr = torch.where(newly & j_noevent, lineindex_j, ntr)
        isbb = isbb | (newly & j_bb)
        act = torch.where(newly & j_bb, lineindex_j, act)
        if jblue is not None:
            jb_of_line, e_over_nu, cell, acc = jblue
            kk = karange[None, :]
            passed = validk & (~any_term[:, None] | (kk < jsel) | ((kk == jsel) & j_bb[:, None]))
            col = jb_of_line[lsafe].long()
            njb = acc.shape[2]
            passed = passed & (col >= 0) & (col < njb)
            t_line = tstart[:, None] + relD / CLIGHT_PROP
            inc = t_line * e_over_nu[:, None]
            flat = (cell[:, None] * (2 * njb) + col)[passed]
            accf = acc.view(-1)
            accf.index_add_(0, flat, inc[passed].to(acc.dtype))
            accf.index_add_(0, flat + njb, torch.ones_like(flat, dtype=acc.dtype))
        not_term = ~any_term & ~done
        tau_cum = torch.where(not_term, tau_cum + tau_line.sum(dim=1), tau_cum)
        lastD = torch.where(not_term, torch.maximum(lastD, relD.max(dim=1).values), lastD)
        done = done | any_term
        c += 1
    return EventResult(edist=edist.to(dtype), next_trans=ntr, is_boundbound=isbb,
                       activating_line=act)

"""Batched Lucy macro-atom: internal transitions until deactivation
(reference: macroatom.cc:309-628 do_macroatom, 39-152
calculate_macroatom_transitionrates, 154-304 selection helpers).

Per-(cell, level) process-rate sums come from plasma.transitionrates; each
jump re-walks only the active level's transition block in fixed chunks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..atomic import DeviceAtomicData
from ..constants import H
from ..plasma.ratecoeff import RateCoeffTables, select_continuum_nu_batch
from ..plasma.transitionrates import (
    MA_ACTION_COLDEEXC, MA_ACTION_COLRECOMB, MA_ACTION_COUNT,
    MA_ACTION_INTERNALDOWNLOWER, MA_ACTION_INTERNALDOWNSAME,
    MA_ACTION_INTERNALUPHIGHER, MA_ACTION_INTERNALUPHIGHERNT,
    MA_ACTION_INTERNALUPSAME, MA_ACTION_RADDEEXC, MA_ACTION_RADRECOMB,
    ProcessRates, trans_values_at,
)


@dataclasses.dataclass(frozen=True)
class MacroAtomAux:
    """Continuum-list regroupings by upper/lower level for MA selection."""

    recomb_cont_of_upper: torch.Tensor
    level_recomb_start: torch.Tensor
    level_recomb_count: torch.Tensor
    ioncont_cont_of_lower: torch.Tensor
    level_ioncont_start: torch.Tensor
    level_ioncont_count: torch.Tensor
    cont_emtype: torch.Tensor
    ion_cont_start: torch.Tensor
    ion_cont_count: torch.Tensor
    max_ndowntrans: int
    max_nuptrans: int
    max_recomb: int
    max_ioncont: int
    max_ioncont_ion: int
    max_nlevels_ion: int


def build_aux(dad: DeviceAtomicData) -> MacroAtomAux:
    nlev = dad.nlevels_total
    ncont = dad.nbfcontinua
    upper = dad.cont_uniqueupper.cpu().numpy()
    lower = dad.cont_uniquelower.cpu().numpy()
    order_u = np.argsort(upper, kind="stable") if ncont else np.zeros(1, np.int64)
    order_l = np.argsort(lower, kind="stable") if ncont else np.zeros(1, np.int64)
    count_u = np.bincount(upper, minlength=nlev) if ncont else np.zeros(nlev, np.int64)
    count_l = np.bincount(lower, minlength=nlev) if ncont else np.zeros(nlev, np.int64)
    start_u = np.concatenate([[0], np.cumsum(count_u)[:-1]])
    start_l = np.concatenate([[0], np.cumsum(count_l)[:-1]])
    # continuum emission type -1 - cont_index(level) - phixstargetindex
    # (reference: atomic.h:444-448)
    emtype = np.zeros(max(ncont, 1), np.int64)
    if ncont:
        for k, ci in enumerate(order_l):
            lev = lower[ci]
            emtype[ci] = -1 - (start_l[lev] + (k - start_l[lev]))
    lvl_ion = dad.level_ion.cpu().numpy()
    nions = dad.nions_total
    cont_ion_sorted = lvl_ion[lower[order_l]] if ncont else np.zeros(0, np.int64)
    ion_cont_count = (np.bincount(cont_ion_sorted, minlength=nions) if ncont
                      else np.zeros(nions, np.int64))
    ion_cont_start = np.concatenate([[0], np.cumsum(ion_cont_count)[:-1]])
    dev = dad.cont_uniqueupper.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64)).to(dev)

    return MacroAtomAux(
        recomb_cont_of_upper=t(order_u), level_recomb_start=t(start_u),
        level_recomb_count=t(count_u), ioncont_cont_of_lower=t(order_l),
        level_ioncont_start=t(start_l), level_ioncont_count=t(count_l),
        cont_emtype=t(emtype), ion_cont_start=t(ion_cont_start),
        ion_cont_count=t(ion_cont_count),
        max_ndowntrans=int(dad.level_ndowntrans.max().item()) if nlev else 0,
        max_nuptrans=int(dad.level_nuptrans.max().item()) if nlev else 0,
        max_recomb=int(count_u.max(initial=0)), max_ioncont=int(count_l.max(initial=0)),
        max_ioncont_ion=int(ion_cont_count.max(initial=0)),
        max_nlevels_ion=int(dad.ion_nlevels.max().item()),
    )


def _select_chunked(target, count, maxcount, value_at, chunk: int = 64):
    """First k in [0, count) with cumulative(value) > target (the
    reference's upper_bound on cumulative arrays, macroatom.cc:163-168);
    clipped to count-1 when rounding overshoots."""
    chunk = max(min(chunk, maxcount), 1)
    nchunks = max(-(-maxcount // chunk), 1)
    cum = torch.zeros_like(target)
    chosen = torch.full(target.shape, -1, dtype=torch.int64, device=target.device)
    for c in range(nchunks):
        k = c * chunk + torch.arange(chunk, device=target.device)
        inb = k[None, :] < count[:, None]
        vals = torch.where(inb, value_at(k), torch.zeros((), dtype=target.dtype,
                                                          device=target.device))
        cumchunk = torch.cumsum(vals, dim=1) + cum[:, None]
        hit = (cumchunk > target[:, None]) & (chosen[:, None] < 0) & inb
        anyhit = hit.any(dim=1)
        first = torch.argmax(hit.to(torch.int8), dim=1) + c * chunk
        chosen = torch.where((chosen < 0) & anyhit, first, chosen)
        cum = cumchunk[:, -1]
    res = torch.where(chosen < 0, count - 1, chosen)
    return torch.clamp(res, min=0)


def do_macroatom_batch(key, dad: DeviceAtomicData, aux: MacroAtomAux, rc: RateCoeffTables,
                       rates: ProcessRates, levelpops, cellidx, level_in, active_in,
                       t_e_c, t_r_c, w_c, nne_c, t_mid: float, max_jumps: int = 1024):
    """Run the macro-atom to deactivation for the flagged packets.

    Returns dict: kind (0 none, 1 rad-bb, 2 rad-fb, 3 kpkt), nu_cmf,
    emissiontype, next_trans, level, unresolved. ``key`` is a counter tuple.
    """
    # selection values in the rate tables' dtype (float64, see
    # driver._plasma_update_device); the caller casts nu_cmf to its state
    dtype = rates.ma_rates.dtype
    dev = t_e_c.device
    t_e = t_e_c[cellidx].to(dtype)
    t_r = torch.clamp(t_r_c[cellidx], min=1.0).to(dtype)
    w = w_c[cellidx].to(dtype)
    nne = nne_c[cellidx].to(dtype)
    nlev = dad.nlevels_total
    T = max(dad.ntrans_total, 1)
    C = max(dad.nbfcontinua, 1)
    cont_rad_u = rates.cont_rad[:, aux.recomb_cont_of_upper]
    cont_down_u = rates.cont_tot_down[:, aux.recomb_cont_of_upper]
    cont_up_l = rates.cont_tot_up[:, aux.ioncont_cont_of_lower]
    off_rad, off_tot, off_crad, off_cdown, off_cup = 0, T, 2 * T, 2 * T + C, 2 * T + 2 * C
    vwidth = 2 * T + 3 * C
    maxblock = max(aux.max_ndowntrans, aux.max_nuptrans, aux.max_recomb, aux.max_ioncont, 1)
    ncont_m1 = max(dad.nbfcontinua - 1, 0)
    level_energy = dad.level_energy.to(dtype)

    zi = torch.zeros_like(level_in)
    level = torch.clamp(level_in, 0, nlev - 1)
    active = active_in.clone()
    kind = zi.clone()
    nu_cmf = torch.zeros_like(t_e)
    emissiontype = zi.clone()
    next_trans = zi.clone()
    fb_cont = zi.clone()
    for it in range(max_jumps):
        if not bool(active.any()):
            break
        k = rng.fold_in(key, it)
        pr = rates.ma_rates[cellidx, level]
        cum = torch.cumsum(pr, dim=1)
        total = torch.clamp(cum[:, -1], min=1e-300)
        zrand = rng.uniform(k, 1, level.shape[0], dtype, dev) * total
        action = torch.clamp((cum <= zrand[:, None]).sum(dim=1), max=MA_ACTION_COUNT - 1)
        stuck = active & (cum[:, -1] <= 0)
        u2 = rng.uniform(k, 2, level.shape[0], dtype, dev)

        downstart = dad.level_alltrans_start[level]
        ndown = dad.level_ndowntrans[level]
        nup = dad.level_nuptrans[level]
        rstart = aux.level_recomb_start[level]
        rcount = aux.level_recomb_count[level]
        istart = aux.level_ioncont_start[level]
        icount = aux.level_ioncont_count[level]
        choices = [
            (MA_ACTION_RADDEEXC, off_rad + downstart, ndown),
            (MA_ACTION_INTERNALDOWNSAME, off_tot + downstart, ndown),
            (MA_ACTION_INTERNALUPSAME, off_tot + downstart + ndown, nup),
            (MA_ACTION_RADRECOMB, off_crad + rstart, rcount),
            (MA_ACTION_INTERNALDOWNLOWER, off_cdown + rstart, rcount),
            (MA_ACTION_INTERNALUPHIGHER, off_cup + istart, icount),
        ]
        base = zi.clone()
        count = zi.clone()
        for a, b, c in reversed(choices):
            base = torch.where(action == a, b, base)
            count = torch.where(action == a, c, count)
        pr_sel = torch.gather(pr, 1, action[:, None])[:, 0]
        tgt = u2 * pr_sel

        def walk_values(kk):
            idxv = torch.clamp(base[:, None] + kk[None, :], 0, vwidth - 1)
            rows = cellidx[:, None]
            ltr = torch.where(idxv >= off_tot, idxv - off_tot, idxv)
            v_rad_k, v_tot_k, _ = trans_values_at(
                dad, levelpops, cellidx, torch.clamp(ltr, 0, T - 1), t_e, nne, t_r, w, t_mid,
                rates.jb_line, rates.jb_arr)
            v = torch.where(idxv >= off_tot, v_tot_k, v_rad_k)
            v = torch.where(idxv >= off_crad,
                            cont_rad_u[rows, torch.clamp(idxv - off_crad, 0, C - 1)], v)
            v = torch.where(idxv >= off_cdown,
                            cont_down_u[rows, torch.clamp(idxv - off_cdown, 0, C - 1)], v)
            v = torch.where(idxv >= off_cup,
                            cont_up_l[rows, torch.clamp(idxv - off_cup, 0, C - 1)], v)
            return v

        ksel = _select_chunked(tgt, count, maxblock, walk_values)

        def act(a):
            return active & (action == a)

        m = act(MA_ACTION_RADDEEXC)
        tidx = torch.clamp(downstart + ksel, 0, dad.ntrans_total - 1)
        lineindex = dad.trans_lineindex[tidx]
        # a level without downward transitions (the single level of a top
        # ion) reads another level's transition here: clamped, as the JAX
        # package's gather clamps, and used only where the action takes it
        target_d = torch.clamp(dad.ion_level_start[dad.level_ion[level]] + dad.trans_target[tidx],
                               0, nlev - 1)
        nu_line = (level_energy[level] - level_energy[target_d]) / H
        kind = torch.where(m, 1, kind)
        nu_cmf = torch.where(m, nu_line, nu_cmf)
        emissiontype = torch.where(m, lineindex, emissiontype)
        next_trans = torch.where(m, lineindex + 1, next_trans)
        done = m

        m = act(MA_ACTION_COLDEEXC) | act(MA_ACTION_COLRECOMB) | stuck
        kind = torch.where(m, 3, kind)
        done = done | m

        m = act(MA_ACTION_INTERNALDOWNSAME) & ~stuck
        newlevel = torch.where(m, target_d, level)

        m = act(MA_ACTION_RADRECOMB)
        bidx = torch.clamp(rstart + ksel, 0, ncont_m1)
        ci = aux.recomb_cont_of_upper[bidx]
        kind = torch.where(m, 2, kind)
        fb_cont = torch.where(m, ci, fb_cont)
        emissiontype = torch.where(m, aux.cont_emtype[ci], emissiontype)
        next_trans = torch.where(m, -1, next_trans)
        done = done | m

        m = act(MA_ACTION_INTERNALDOWNLOWER) & ~stuck
        newlevel = torch.where(m, dad.cont_uniquelower[ci], newlevel)

        m = act(MA_ACTION_INTERNALUPSAME) & ~stuck
        tidx_u = torch.clamp(downstart + ndown + ksel, 0, dad.ntrans_total - 1)
        target_u = dad.ion_level_start[dad.level_ion[level]] + dad.trans_target[tidx_u]
        newlevel = torch.where(m, target_u, newlevel)

        m = act(MA_ACTION_INTERNALUPHIGHER) & ~stuck
        bidx_i = torch.clamp(istart + ksel, 0, ncont_m1)
        ci_i = aux.ioncont_cont_of_lower[bidx_i]
        newlevel = torch.where(m, dad.cont_uniqueupper[ci_i], newlevel)

        m = act(MA_ACTION_INTERNALUPHIGHERNT) & ~stuck
        kind = torch.where(m, 3, kind)
        done = done | m

        level = newlevel
        active = active & ~done

    fb_mask = kind == 2
    nu_fb = select_continuum_nu_batch(rng.fold_in(key, 999), dad, fb_cont, t_e, fb_mask)
    nu_cmf = torch.where(fb_mask, nu_fb, nu_cmf)
    return dict(kind=kind, nu_cmf=nu_cmf, emissiontype=emissiontype,
                next_trans=next_trans, level=level, unresolved=active)


def macroatom_log_rows(malog, malog_n, logged, columns):
    """Append one row of ``columns`` (each (K,) over a batch's macro-atoms:
    the cell's nonemptymgi, the activating level, the deactivating level,
    the emitted line, nu_cmf in and out, nu_rf in and out) for each
    macro-atom in ``logged`` (a radiative bound-bound deactivation) to the
    bounded log ``malog`` (capacity rows of 8) after its first ``malog_n``
    rows (reference: LOG_MACROATOM, macroatom.cc:413-421; the JAX
    package's rows at engine.py:2189-2214). Rows past the capacity are
    dropped but counted, so the writer can report the overflow. Device ops
    only: no host synchronise. Returns (malog, malog_n)."""
    cap = malog.shape[0]
    pos = malog_n + torch.cumsum(logged.long(), 0) - 1
    pos = torch.where(logged & (pos < cap), pos, torch.full_like(pos, cap))
    rows = torch.stack([c.to(malog.dtype) for c in columns], dim=1)
    # the dropped rows land in a spare row past the capacity
    buf = torch.cat([malog, malog.new_zeros((1, malog.shape[1]))])
    buf.index_put_((pos,), rows)
    return buf[:cap], malog_n + logged.sum().to(malog_n.dtype)

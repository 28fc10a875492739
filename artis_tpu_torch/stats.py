"""Event statistics counters (reference: stats.h:47-82 eventcounters enum,
stats.cc:156-234): one (N_COUNTERS,) tensor inside the estimators, bumped
with masked sums; and the per-ion statistics of ``track_ion_stats``
(stats.h:12-44), one (ncells, nions, N_ION_STATS) tensor."""

from __future__ import annotations

import torch

from .devutil import index_add_

MA_STAT_ACTIVATION_COLLEXC = 0
MA_STAT_ACTIVATION_COLLION = 1
MA_STAT_ACTIVATION_NTCOLLEXC = 2
MA_STAT_ACTIVATION_NTCOLLION = 3
MA_STAT_ACTIVATION_BB = 4
MA_STAT_ACTIVATION_BF = 5
MA_STAT_ACTIVATION_FB = 6
MA_STAT_DEACTIVATION_COLLDEEXC = 7
MA_STAT_DEACTIVATION_COLLRECOMB = 8
MA_STAT_DEACTIVATION_BB = 9
MA_STAT_DEACTIVATION_FB = 10
MA_STAT_INTERNALUPHIGHER = 11
MA_STAT_INTERNALUPHIGHERNT = 12
MA_STAT_INTERNALDOWNLOWER = 13
K_STAT_TO_MA_COLLEXC = 14
K_STAT_TO_MA_COLLION = 15
K_STAT_TO_R_FF = 16
K_STAT_TO_R_FB = 17
K_STAT_TO_R_BB = 18
K_STAT_FROM_FF = 19
K_STAT_FROM_BF = 20
NT_STAT_FROM_GAMMA = 21
NT_STAT_TO_IONIZATION = 22
NT_STAT_TO_EXCITATION = 23
NT_STAT_TO_KPKT = 24
K_STAT_FROM_EARLIERDECAY = 25
INTERACTIONS = 26
ESCOUNTER = 27
RESONANCESCATTERINGS = 28
CELLCROSSINGS = 29
UPSCATTER = 30
DOWNSCATTER = 31
UPDATECELL = 32
N_COUNTERS = 33

COUNTER_NAMES = [
    "ma_stat_activation_collexc", "ma_stat_activation_collion",
    "ma_stat_activation_ntcollexc", "ma_stat_activation_ntcollion",
    "ma_stat_activation_bb", "ma_stat_activation_bf", "ma_stat_activation_fb",
    "ma_stat_deactivation_colldeexc", "ma_stat_deactivation_collrecomb",
    "ma_stat_deactivation_bb", "ma_stat_deactivation_fb",
    "ma_stat_internaluphigher", "ma_stat_internaluphighernt",
    "ma_stat_internaldownlower", "k_stat_to_ma_collexc",
    "k_stat_to_ma_collion", "k_stat_to_r_ff", "k_stat_to_r_fb",
    "k_stat_to_r_bb", "k_stat_from_ff", "k_stat_from_bf",
    "nt_stat_from_gamma", "nt_stat_to_ionization", "nt_stat_to_excitation",
    "nt_stat_to_kpkt", "k_stat_from_earlierdecay", "interactions",
    "escounter", "resonancescatterings", "cellcrossings", "upscatter",
    "downscatter", "updatecell",
]


def bump(counters, index: int, mask):
    """counters[index] += count(mask), in place (the counters tensor is owned
    by the estimators of the running timestep)."""
    counters[index] += mask.sum().to(counters.dtype)
    return counters


def format_counters(counters) -> str:
    """Per-timestep printout (reference: stats.cc:177-227)."""
    vals = counters.detach().cpu().numpy()
    return "\n".join(
        f"  {name}: {int(v)}" for name, v in zip(COUNTER_NAMES, vals) if v != 0)


# Per-ion-per-cell statistics (reference: stats.h:12-44 ionstattypes),
# accumulated into the (ncells, nions, N_ION_STATS) estimator when
# Options.track_ion_stats is on; the indices are the reference enum's.
ION_RADRECOMB_MACROATOM = 0
ION_RADRECOMB_KPKT = 1
ION_RADRECOMB_ABSORBED = 2
ION_BOUNDBOUND_MACROATOM = 3
ION_BOUNDBOUND_ABSORBED = 4
ION_NTION = 5
ION_PHOTOION = 6
ION_PHOTOION_FROMBOUNDFREE = 7
ION_PHOTOION_FROMBFSAMEELEMENT = 8
ION_PHOTOION_FROMBFIONPLUSONE = 9
ION_PHOTOION_FROMBFIONPLUSTWO = 10
ION_PHOTOION_FROMBFIONPLUSTHREE = 11
ION_PHOTOION_FROMBFLOWERSUPERLEVEL = 12
ION_PHOTOION_FROMBOUNDBOUND = 13
ION_PHOTOION_FROMBOUNDBOUNDIONPLUSONE = 14
ION_PHOTOION_FROMBOUNDBOUNDIONPLUSTWO = 15
ION_PHOTOION_FROMBOUNDBOUNDIONPLUSTHREE = 16
ION_MACROATOM_ENERGYOUT_RADDEEXC = 17
ION_MACROATOM_ENERGYOUT_RADRECOMB = 18
ION_MACROATOM_ENERGYOUT_COLLDEEXC = 19
ION_MACROATOM_ENERGYOUT_COLLRECOMB = 20
ION_MACROATOM_ENERGYIN_RADEXC = 21
ION_MACROATOM_ENERGYIN_PHOTOION = 22
ION_MACROATOM_ENERGYIN_COLLEXC = 23
ION_MACROATOM_ENERGYIN_COLLION = 24
ION_MACROATOM_ENERGYIN_NTCOLLEXC = 25
ION_MACROATOM_ENERGYIN_NTCOLLION = 26
ION_MACROATOM_ENERGYIN_TOTAL = 27
ION_MACROATOM_ENERGYOUT_TOTAL = 28
ION_MACROATOM_ENERGYIN_INTERNAL = 29
ION_MACROATOM_ENERGYOUT_INTERNAL = 30
N_ION_STATS = 31


def ion_add(ion_stats, mgi, ion, stat: int, value, active):
    """ion_stats[mgi, ion, stat] += value over the ``active`` lanes with a
    model cell, in place (replaces the reference's atomicadd,
    stats.cc:147-154); the other lanes add 0 to the first entry. The sum
    goes through ``devutil.index_add_``: on the card a sorted index_put_,
    so same-seed runs give the same bits."""
    ok = active & (mgi >= 0)
    nions = ion_stats.shape[1]
    flat = (torch.clamp(mgi.long(), min=0) * nions + ion.long()) * N_ION_STATS + stat
    flat = torch.where(ok, flat, torch.zeros_like(flat))
    vals = torch.where(ok, value.to(ion_stats.dtype), torch.zeros((), dtype=ion_stats.dtype,
                                                                  device=ion_stats.device))
    index_add_(ion_stats.view(-1), 0, flat, vals)
    return ion_stats

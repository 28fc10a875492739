"""Monte Carlo estimator accumulators (reference: globals.h:206-232
J/nuJ/ffheating/deposition arrays, stats.h:47-82 event counters).

Per-packet contributions are index-added into (ncells,) tensors; the
crossing kernel adds its per-cell rows (J, nuJ, the LUT, detailed bf-rate,
multibin and J_b_lu estimators). The estimators of modes that are off
(virtual packets, and the run diagnostics: per-ion statistics, per-line
counts, the macro-atom log) keep placeholder shapes, so the field set
matches the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

from .devutil import index_add


@dataclasses.dataclass(frozen=True)
class Estimators:
    j: torch.Tensor  # (ncells,)
    nuj: torch.Tensor
    ffheating: torch.Tensor
    dep_gamma: torch.Tensor
    dep_electron: torch.Tensor
    dep_positron: torch.Tensor
    dep_alpha: torch.Tensor
    gammaestimator: torch.Tensor  # (ncells, nbfcontinua_ground)
    bfheatingestimator: torch.Tensor  # (ncells, nbfcontinua_ground)
    cmf_lum: torch.Tensor
    pellet_decays: torch.Tensor
    nesc: torch.Tensor
    gamma_emission: torch.Tensor
    counters: torch.Tensor  # (stats.N_COUNTERS,)
    radfieldbin_j: torch.Tensor
    radfieldbin_nuj: torch.Tensor
    radfieldbin_count: torch.Tensor
    vspec: torch.Tensor
    positron_emission: torch.Tensor
    electron_emission: torch.Tensor
    alpha_emission: torch.Tensor
    gamma_dep_discrete: torch.Tensor
    positron_dep_discrete: torch.Tensor
    electron_dep_discrete: torch.Tensor
    alpha_dep_discrete: torch.Tensor
    bfrate: torch.Tensor
    jblue_raw: torch.Tensor
    jblue_count: torch.Tensor
    ion_stats: torch.Tensor
    vgrid: torch.Tensor
    line_emisscount: torch.Tensor
    line_absorbcount: torch.Tensor
    malog: torch.Tensor
    malog_n: torch.Tensor

    def replace(self, **kw) -> "Estimators":
        return dataclasses.replace(self, **kw)


def zero_estimators(ncells: int, nbfcontinua_ground: int, dtype=torch.float64,
                    device="cpu", nradfieldbins: int = 1,
                    vspec_shape=(1, 1, 1, 1, 3), nbfrate: int = 1,
                    nbfrate_cells: int = 1, njblue: int = 1,
                    njblue_cells: int = 1, nion_stats_cells: int = 1,
                    nion_stats_ions: int = 1, nion_stats: int = 1,
                    vgrid_shape=(1, 1, 1, 1, 3), nlinestat: int = 1,
                    nmalog: int = 1) -> Estimators:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Estimators(
        j=z(ncells), nuj=z(ncells), ffheating=z(ncells), dep_gamma=z(ncells),
        dep_electron=z(ncells), dep_positron=z(ncells), dep_alpha=z(ncells),
        gammaestimator=z(ncells, nbfcontinua_ground),
        bfheatingestimator=z(ncells, nbfcontinua_ground),
        cmf_lum=z(), pellet_decays=z(dt=torch.int64), nesc=z(dt=torch.int64),
        gamma_emission=z(), counters=z(33),
        radfieldbin_j=z(ncells, nradfieldbins),
        radfieldbin_nuj=z(ncells, nradfieldbins),
        radfieldbin_count=z(ncells, nradfieldbins),
        vspec=z(*vspec_shape), positron_emission=z(), electron_emission=z(),
        alpha_emission=z(), gamma_dep_discrete=z(), positron_dep_discrete=z(),
        electron_dep_discrete=z(), alpha_dep_discrete=z(),
        bfrate=z(nbfrate_cells, nbfrate), jblue_raw=z(njblue_cells, njblue),
        jblue_count=z(njblue_cells, njblue),
        ion_stats=z(nion_stats_cells, nion_stats_ions, nion_stats),
        vgrid=z(*vgrid_shape), line_emisscount=z(nlinestat, dt=torch.int64),
        line_absorbcount=z(nlinestat, dt=torch.int64), malog=z(nmalog, 8),
        malog_n=z(dt=torch.int64),
    )


def all_reduce_estimators(est: Estimators, est0: Estimators, mesh) -> Estimators:
    """The estimators of a mesh's ranks summed (the reference's
    MPI_Allreduce of its estimators, sn3d.cc:263-348; the JAX package's
    ``psum_estimators``): every field is ``est0``, the accumulator every
    rank started from, plus the sum over the ranks of ``est - est0``, so
    what ``est0`` held is counted once. One collective per dtype; integer
    fields add exactly."""
    from .parallel.mesh import all_reduce

    names = [f.name for f in dataclasses.fields(est)]
    deltas = all_reduce(mesh, [getattr(est, k) - getattr(est0, k) for k in names])
    return est.replace(**{k: getattr(est0, k) + d for k, d in zip(names, deltas)})


def cell_add(array, nonemptymgi, contrib, active):
    """Segment-sum per-packet contributions into a per-cell tensor
    (replaces the reference's atomicadd, sn3d.h:164-184)."""
    ok = active & (nonemptymgi >= 0)
    safe_idx = torch.where(ok, nonemptymgi, torch.zeros_like(nonemptymgi))
    vals = torch.where(ok, contrib, torch.zeros_like(contrib)).to(array.dtype)
    return index_add(array, 0, safe_idx, vals)

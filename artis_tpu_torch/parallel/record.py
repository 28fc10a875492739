"""A world's run recorded to a file, to hold a mesh against runs on one
process.

``record_run`` (and ``record_runs``, several in turn) is a rank function
for ``mesh.spawn``: every rank builds
the Simulation on the mesh and runs the named timesteps; rank 0 saves
(``torch.save``) what the world computed, on the CPU: the estimators and
the light curve after each timestep (all-reduced), the transport log and
the escaped cmf luminosity per timestep, and, for one grid update, its
inputs, its gathered
outputs and the same update computed by rank 0 alone on the same inputs
(``driver._plasma_update_device``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

from ..devutil import map_tensors
from .mesh import barrier

# the update's arguments kept in the record: the rest (atomic data, rate
# tables, options, the NLTE and non-thermal tables) a Simulation on the same
# run directory rebuilds
_UPDATE_ARGS = ("cells", "j_norm", "nuj_norm", "t_mid", "ffheating_norm", "dep_heating")
_UPDATE_STATIC = ("nlte_indices", "ntd", "nt_wf")


def _cpu(x):
    return map_tensors(lambda t: t.detach().cpu(), x)


def record_run(mesh, rundir, opts, timesteps, out, checkpoint_at=None, capture_update=None):
    """Run ``timesteps`` of the run directory on ``mesh`` (a checkpoint
    written before timestep ``checkpoint_at``, if given); with
    ``capture_update`` record that timestep's grid update. Rank 0 writes
    the record to ``out``."""
    from ..driver import Simulation, _plasma_update_device

    sim = Simulation(rundir, opts, device=mesh.device, mesh=mesh)
    rec = dict(est={}, lc_lum={}, update=None)
    world_update = sim._plasma_fn

    def capture(dad, rc, cells, o, j_norm, nuj_norm, t_mid, ffheating_norm, dep_heating, **kw):
        args = (dad, rc, cells, o, j_norm, nuj_norm, t_mid, ffheating_norm, dep_heating)
        world = world_update(*args, **kw)
        if kw.get("nts") == capture_update:
            alone = _plasma_update_device(*args, **kw) if mesh.rank == 0 else None
            rec["update"] = dict(
                args=_cpu(dict(zip(_UPDATE_ARGS, args[2:3] + args[4:]))),
                kwargs=_cpu({k: v for k, v in kw.items() if k not in _UPDATE_STATIC}),
                world=_cpu(world), alone=_cpu(alone))
        return world

    sim._plasma_fn = capture
    for nts in timesteps:
        if nts == checkpoint_at:
            sim.save_checkpoint(nts)
        sim.do_timestep(nts)
        rec["est"][nts] = {f.name: getattr(sim.prev_est, f.name).detach().cpu()
                           for f in dataclasses.fields(sim.prev_est)}
        rec["lc_lum"][nts] = sim.lc_lum.copy()
    rec.update(transport_log=sim.transport_log, cmf_lum_ts=sim.cmf_lum_ts.copy())
    sim.close()
    if mesh.rank == 0:
        # whole or not at all: a reader may wait for the file
        torch.save(rec, out + ".tmp")
        os.replace(out + ".tmp", out)


def record_runs(mesh, runs):
    """``record_run`` for each dict of its keyword arguments in ``runs``,
    in turn; a run with ``copy_from`` starts in a copy of that run
    directory, made by rank 0 once the runs before it have ended."""
    for kw in runs:
        kw = dict(kw)
        src = kw.pop("copy_from", None)
        if src is not None:
            if mesh.rank == 0:
                shutil.copytree(src, kw["rundir"])
            barrier(mesh)
        record_run(mesh, **kw)


def rank_tables(rank: int, ncells: int = 6, seed: int = 7):
    """The tables ``record_collectives`` gives rank ``rank``, on the CPU:
    estimators of ``ncells`` cells with seeded values (integers in the
    integer fields) and a (2, 3) float64 and an int64 table of per-cell
    rows."""
    import numpy as np

    from ..estimators import zero_estimators

    g = np.random.default_rng([seed, rank])
    est = zero_estimators(ncells, 3)
    est = est.replace(**{
        f.name: torch.as_tensor(
            g.integers(0, 1000, tuple(getattr(est, f.name).shape)) if not
            getattr(est, f.name).is_floating_point()
            else g.random(tuple(getattr(est, f.name).shape))).to(getattr(est, f.name).dtype)
        for f in dataclasses.fields(est)})
    return est, torch.as_tensor(g.random((2, 3))), torch.as_tensor(g.integers(0, 99, (2, 5)))


def record_collectives(mesh, out, ncells: int = 6):
    """The mesh's collectives on its device: the all-reduce of every rank's
    ``rank_tables`` estimators over zero accumulators, and the all-gather
    of its per-cell rows (the world's ``2 * world`` rows, the last cut, as
    the grid update's padding is). Rank 0 writes the results to ``out``."""
    from ..estimators import all_reduce_estimators, zero_estimators
    from .mesh import all_gather_rows

    est, rows, irows = map_tensors(lambda t: t.to(mesh.device), rank_tables(mesh.rank, ncells))
    zero = map_tensors(lambda t: t.to(mesh.device), zero_estimators(ncells, 3))
    reduced = all_reduce_estimators(est, zero, mesh)
    gathered = all_gather_rows(mesh, [rows, irows], 2 * mesh.world - 1)
    if mesh.rank == 0:
        torch.save(dict(est=_cpu(reduced), rows=_cpu(gathered),
                        device=str(reduced.j.device)), out)

"""The mesh: packet-sharded transport and the cell-domain grid update over
``torch.distributed``.

Port of ``artis_tpu/parallel/mesh.py`` (reference: SURVEY.md section 2
'Parallelism'). The reference runs one MPI rank per core group: each rank
transports its own packets, the estimators are summed with MPI_Allreduce
(sn3d.cc:263-348), and the grid update is split by cell ownership
(grid.cc:977-1046, update_grid.cc:1116-1124) with the solved cells
broadcast to all (sn3d.cc:197-261). The JAX package runs one controller
over a ``jax.sharding.Mesh`` and ``shard_map``; the port runs the same
semantics with one process per rank and ``torch.distributed``
collectives:

- transport: every rank runs ``engine.transport_timestep`` on its
  contiguous shard of the packets with the key ``rng.fold_in(key, rank)``,
  then the estimators' delta of the call is all-reduced (its sum over the
  ranks is added to the incoming accumulator, which every rank holds);
- grid update: the nonempty cells are edge-padded to a multiple of the
  world size, each rank solves its contiguous slice, and every per-cell
  output is all-gathered (``CELL_OUTPUTS`` declares which).

The world is one axis of ranks, used by the packets and then by the
cells (the JAX package's ``PACKET_AXIS`` and ``CELL_AXIS`` meshes over
the same devices). NCCL carries the collectives between cards; gloo on
the CPU and where ranks share a card. On gloo the all-reduce takes the
tensors where they are (gloo reduces CUDA tensors through the host
itself); the all-gather goes through explicit host copies
(``_gather_on_host``: gloo's support of CUDA tensors in its all-gather
is not relied on). Buffers of one dtype travel in one collective.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch
import torch.distributed as dist

from .. import rng
from ..transport import engine as engine_mod

@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the world: its process group (None: the default
    group), rank, world size, device and the group's backend."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of an initialised process group (default: the world) on
    ``device`` (default: the current card under NCCL, else the CPU)."""
    backend = dist.get_backend(group)
    device = torch.device(device if device is not None else
                          "cuda" if backend == "nccl" else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=group, rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=device, backend=backend)


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(timing, key, mesh, fn):
    """``fn()``, its wall seconds (device work before and after it waited
    for) added to ``timing[key]``."""
    _sync(mesh)
    t0 = time.time()
    out = fn()
    _sync(mesh)
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + time.time() - t0
    return out


def _by_dtype(tensors):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce(mesh: Mesh, tensors: list, op=dist.ReduceOp.SUM) -> list:
    """``tensors`` (same shapes on every rank) reduced over the ranks by
    ``op`` (default the sum), one collective per dtype; each result where
    its tensor was."""
    out = list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if mesh.backend == "nccl":
            flat = flat.to(mesh.device)
        dist.all_reduce(flat, op=op, group=mesh.group)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape).to(tensors[i].device)
    return out


def barrier(mesh: Mesh):
    dist.barrier(group=mesh.group,
                 device_ids=[mesh.device.index] if mesh.backend == "nccl" else None)


def _gather_on_host(mesh, t):
    """gloo's all-gather, on a host copy of ``t``; the result where ``t``
    was."""
    parts = [torch.empty_like(t, device="cpu") for _ in range(mesh.world)]
    dist.all_gather(parts, t.cpu(), group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_gather_rows(mesh: Mesh, tensors: list, nrows: int) -> list:
    """Every rank's ``tensors`` (each with the same leading dimension on
    every rank) concatenated along it in rank order, the first ``nrows``
    rows kept; one collective per dtype."""
    out = list(tensors)
    for dtype, idx in _by_dtype(tensors).items():
        nloc = tensors[idx[0]].shape[0]
        cols = [tensors[i].reshape(nloc, -1) for i in idx]
        flat = torch.cat(cols, dim=1)
        if dtype == torch.bool:
            flat = flat.to(torch.uint8)
        if mesh.backend == "nccl":
            parts = [torch.empty_like(flat, device=mesh.device) for _ in range(mesh.world)]
            dist.all_gather(parts, flat.to(mesh.device), group=mesh.group)
            full = torch.cat(parts).to(flat.device)
        else:
            full = _gather_on_host(mesh, flat)
        full = full[:nrows].to(dtype)
        for i, part in zip(idx, torch.split(full, [c.shape[1] for c in cols], dim=1)):
            out[i] = part.reshape((nrows,) + tuple(tensors[i].shape[1:]))
    return out


# ---------------------------------------------------------------------------
# packets


def shard_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of ``n`` rows (``n`` a multiple of the
    world size): the global order is the shards' in rank order, as the
    JAX package's NamedSharding lays the packet axis out (:94-100)."""
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_packets(st, mesh: Mesh):
    """This rank's slice of a global packet state."""
    sl = shard_slice(st.npkts, mesh)
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[sl].clone()
                                      for f in dataclasses.fields(st)})


def gather_packets(st, mesh: Mesh):
    """The global packet state, in packet order, on rank 0 (None on the
    others)."""
    names = [f.name for f in dataclasses.fields(st)]
    full = all_gather_rows(mesh, [getattr(st, k) for k in names], st.npkts * mesh.world)
    return dataclasses.replace(st, **dict(zip(names, full))) if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# transport


def transport_timestep_sharded(mesh: Mesh, key, st_shard, est, grid, dad, aux, rc, rates, cells,
                               ctx, opts, gamma_kappagrey: float, opacity_case: int,
                               kpktdiffusion_timescale: float, apply_kpkt_diffusion: bool,
                               max_iters: int = 4096, wall_budget: float = -1.0, timing=None):
    """One timestep's transport of this rank's packet shard
    (``engine.transport_timestep`` with the key ``rng.fold_in(key, rank)``,
    the reference's rank-offset seed, input.cc:1599-1607), then the
    all-reduce of the estimators: every field is ``est`` plus the sum over
    the ranks of this call's delta (:147-150), so an accumulator that
    already held counts is not multiplied by the world size; integer
    counters add exactly. Returns (st_shard, est, iters, nsteps) with
    ``iters`` the ranks' largest and ``nsteps`` their sum. With ``timing``
    the collectives' seconds add to ``timing["allreduce_seconds"]``."""
    from ..estimators import all_reduce_estimators

    st_out, est_out, iters, nsteps = engine_mod.transport_timestep(
        rng.fold_in(key, mesh.rank), st_shard, est, grid, dad, aux, rc, rates, cells, ctx, opts,
        gamma_kappagrey, opacity_case, kpktdiffusion_timescale, apply_kpkt_diffusion,
        max_iters=max_iters, wall_budget=wall_budget)

    def reduce():
        top = all_reduce(mesh, [torch.tensor([iters])], dist.ReduceOp.MAX)[0]
        total = all_reduce(mesh, [torch.tensor([nsteps])])[0]
        return all_reduce_estimators(est_out, est, mesh), int(top), int(total)

    est_out, iters, nsteps = _timed(timing, "allreduce_seconds", mesh, reduce)
    return st_out, est_out, iters, nsteps


# ---------------------------------------------------------------------------
# the cell-domain grid update

# The inputs of ``driver._plasma_update_device`` with one row per nonempty
# cell (each rank takes its slice; the rest are replicated); of
# ``jblue_normed`` = (jblue_of_line, (ncells, njblue)) the second element.
CELL_INPUTS = ("cells", "j_norm", "nuj_norm", "ffheating_norm", "dep_heating",
               "gammaest_norm", "binj_norm", "binnuj_norm", "bincount", "bfrate_normed",
               "jblue_normed", "sf_carry")
# Its outputs (cells, levelpops, nnion, chi_ff_part, rates, tau_sob, bf_a,
# bf_dep, expo, extra): those with one row per nonempty cell, gathered
# across the ranks. A dataclass output is gathered field by field but for
# the replicated fields named in REPLICATED_OUTPUTS; expo = (kappa,
# planck_cum, wcum, binoffsets); extra's dicts entry by entry. Of extra's
# per-rank scalars, sf_solves is summed and sf_seconds the largest taken.
CELL_OUTPUTS = ("cells", "levelpops", "nnion", "chi_ff_part", "rates", "tau_sob", "bf_a",
                "bf_dep", "expo.kappa", "expo.planck_cum", "expo.wcum", "extra.tr_bins",
                "extra.w_bins", "extra.nlte_fracdiff", "extra.nlte_iters", "extra.sf_carry",
                "extra.nt")
# outputs every rank computes alike, taken as computed
REPLICATED_OUTPUTS = ("rates.jb_line", "expo.binoffsets")
_PLASMA_OUTPUTS = ("cells", "levelpops", "nnion", "chi_ff_part", "rates", "tau_sob", "bf_a",
                   "bf_dep", "expo", "extra")
_EXPO = ("kappa", "planck_cum", "wcum", "binoffsets")


def _map_cells(fn, value, keep=()):
    """``fn`` on every tensor of a per-cell value: a tensor, a dataclass of
    tensors (but its fields named in ``keep``) or a dict of them; None
    stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map_cells(fn, v) for k, v in value.items()}
    return dataclasses.replace(value, **{f.name: fn(getattr(value, f.name))
                                         for f in dataclasses.fields(value)
                                         if f.name not in keep})


def _map_cell_outputs(fn, out):
    """The grid update's outputs with ``fn`` applied to every tensor that
    ``CELL_OUTPUTS`` declares per cell, in a fixed order."""
    named = dict(zip(_PLASMA_OUTPUTS, out))
    for name in CELL_OUTPUTS:
        head, _, field = name.partition(".")
        if not field:
            keep = [r.partition(".")[2] for r in REPLICATED_OUTPUTS if r.startswith(head + ".")]
            named[head] = _map_cells(fn, named[head], keep)
        elif head == "expo" and named["expo"] is not None:
            expo = list(named["expo"])
            i = _EXPO.index(field)
            expo[i] = _map_cells(fn, expo[i])
            named["expo"] = tuple(expo)
        elif head == "extra":
            named["extra"] = dict(named["extra"], **{field: _map_cells(fn, named["extra"][field])})
    return tuple(named[k] for k in _PLASMA_OUTPUTS)


def _cell_index(ncells: int, mesh: Mesh, device) -> torch.Tensor:
    """This rank's cells of the padded batch: the nonempty cells edge-padded
    to a multiple of the world size by repeating the last one (its solve is
    benign, :277-303), cut into contiguous slices."""
    nlocal = -(-ncells // mesh.world)
    idx = torch.arange(mesh.rank * nlocal, (mesh.rank + 1) * nlocal, device=device)
    return torch.clamp(idx, max=ncells - 1)


def plasma_update_sharded(mesh: Mesh, plasma_fn, dad, rc, cells, opts, j_norm, nuj_norm, t_mid,
                          ffheating_norm, dep_heating, timing=None, **kwargs):
    """The grid update ``plasma_fn`` (``driver._plasma_update_device``) with
    the cells split over the ranks (reference cell ownership:
    grid.cc:977-1046, update_grid.cc:1116-1124): each rank solves its slice
    of the edge-padded cells, then every per-cell output (``CELL_OUTPUTS``)
    is all-gathered and the padding cut off, so every rank returns the
    whole update, as the reference broadcasts the solved cells
    (sn3d.cc:197-261). Replicated outputs are taken as computed;
    ``extra["sf_solves"]`` is summed over the ranks and
    ``extra["sf_seconds"]`` the largest. Each declared input and output
    must have one row per cell (else RuntimeError). With ``timing`` the
    gather's seconds add to ``timing["allgather_seconds"]``."""
    ncells = int(cells.Te.shape[0])
    idx = _cell_index(ncells, mesh, cells.Te.device)
    nlocal = int(idx.shape[0])

    def take(t):
        if t.shape[0] != ncells:
            raise RuntimeError(f"cell-domain update: an input has {t.shape[0]} rows, "
                               f"not the {ncells} cells")
        return t.index_select(0, idx.to(t.device))

    args = dict(cells=cells, j_norm=j_norm, nuj_norm=nuj_norm, ffheating_norm=ffheating_norm,
                dep_heating=dep_heating, **kwargs)
    for name in CELL_INPUTS:
        v = args.get(name)
        if name == "jblue_normed" and v is not None:
            args[name] = (v[0], take(v[1]))
        else:
            args[name] = _map_cells(take, v)
    out = plasma_fn(dad, rc, opts=opts, t_mid=t_mid, **args)

    local = []

    def collect(t):
        if t.shape[0] != nlocal:
            raise RuntimeError(f"cell-domain update: a per-cell output has {t.shape[0]} rows, "
                               f"not this rank's {nlocal} cells")
        local.append(t)
        return t

    _map_cell_outputs(collect, out)

    def gather():
        extra = out[-1]
        solves = all_reduce(mesh, [torch.tensor([int(extra.get("sf_solves", 0))])])[0]
        seconds = all_reduce(mesh, [torch.tensor([float(extra.get("sf_seconds", 0.0))],
                                                 dtype=torch.float64)], dist.ReduceOp.MAX)[0]
        return all_gather_rows(mesh, local, ncells), int(solves), float(seconds)

    full, solves, seconds = _timed(timing, "allgather_seconds", mesh, gather)
    it = iter(full)
    out = _map_cell_outputs(lambda _: next(it), out)
    return out[:-1] + (dict(out[-1], sf_solves=solves, sf_seconds=seconds),)


def make_plasma_dispatch(mesh: Mesh, plasma_fn, timing=None):
    """The cell-domain grid update with ``plasma_fn``'s call signature, so
    that the driver's ``_plasma_call`` runs unchanged on a mesh (the JAX
    driver swaps ``_plasma_jit`` for it)."""
    def dispatch(dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffheating_norm, dep_heating,
                 **kwargs):
        return plasma_update_sharded(mesh, plasma_fn, dad, rc, cells, opts, j_norm, nuj_norm,
                                     t_mid, ffheating_norm, dep_heating, timing=timing, **kwargs)
    return dispatch


# ---------------------------------------------------------------------------
# worlds of processes on this host


def spawn(fn, nranks: int, init_method: str, device="cpu", args=()):
    """Run ``fn(mesh, *args)`` in ``nranks`` new processes of this host
    (start method ``spawn``), joined through the store at ``init_method``
    (e.g. ``file://`` a path that does not exist yet). Rank ``r`` runs on
    ``distributed.rank_device(device, r)``. Returns when every rank has;
    a rank that raises makes this raise (the other ranks are stopped)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(nranks, init_method, str(device), fn, tuple(args)),
                       nprocs=nranks, join=True, start_method="spawn")


def _rank_main(rank, nranks, init_method, device, fn, args):
    from .distributed import init_world

    dev = init_world(init_method, nranks, rank, device=device,
                     log=print if rank == 0 else (lambda _msg: None))
    if dev.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nranks))
    try:
        fn(make_mesh(dev), *args)
    finally:
        dist.destroy_process_group()

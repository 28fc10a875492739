"""Joining a launcher's world: the MPI_Init analogue of the driver.

Port of ``artis_tpu/parallel/distributed.py`` (reference: globals.h:319-358
setup_mpi_vars, sn3d.cc:686-733 MPI_Init and rank bookkeeping). The JAX
package joins one process per host through ``jax.distributed.initialize``;
the port runs one process per rank and joins them with
``torch.distributed.init_process_group``:

- MPI ranks            -> processes, one per card (or several on one card,
                          or on the CPU)
- MPI_Allreduce/Bcast  -> ``torch.distributed`` collectives of the mesh
                          (``parallel/mesh.py``): NCCL between cards, gloo
                          on the CPU or where ranks share a card (NCCL
                          refuses two ranks on one device)

Configuration is by environment, as for the JAX package:

- ``ARTIS_COORDINATOR``   host:port of rank 0's store (absent: single
                          process, no-op); ``auto``: the variables that
                          ``torchrun`` sets (``init_method="env://"``)
- ``ARTIS_NUM_PROCESSES`` world size (int)
- ``ARTIS_PROCESS_ID``    this process's rank (int)

Every rank of a world runs on the same kind of device. On cards the ranks
agree on the backend through the rendezvous store before the group starts:
each publishes its host and card (``join_layout``), and NCCL is taken only
when no two ranks of a host share a card.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: a bare ``cuda`` becomes the card
    ``local_rank % device_count`` (one process per card; ranks beyond the
    card count share cards); anything else is kept as given (a CUDA device
    that does not exist raises where the run first uses it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def choose_backend(placement: list[tuple[str, str]]) -> str:
    """The world's backend from every rank's (host, device): NCCL when
    every rank has a card of its own on its host, gloo otherwise (on the
    CPU, or when ranks share a card)."""
    on_cards = all(torch.device(dev).type == "cuda" and torch.device(dev).index is not None
                   for _, dev in placement)
    return "nccl" if on_cards and len(set(placement)) == len(placement) else "gloo"


def _exchange(store, key: str, rank: int, world: int, value: str) -> list[str]:
    """Every rank's ``value``, in rank order, through the store (each read
    waits for that rank's write)."""
    store.set(f"artis/{key}/{rank}", value)
    return [store.get(f"artis/{key}/{r}").decode() for r in range(world)]


def join_layout(store, rank: int, world: int, device, host: str | None = None):
    """This rank's device and the world's backend, agreed through the
    rendezvous ``store``: each rank publishes its host, takes the card of
    its index among its host's ranks (``LOCAL_RANK`` where the launcher set
    it; ``rank_device``), publishes the card, and every rank chooses the
    backend from the same list (``choose_backend``)."""
    host = host or socket.gethostname()
    hosts = _exchange(store, "host", rank, world, host)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", hosts[:rank].count(host))))
    placement = [tuple(v.split("\t")) for v in
                 _exchange(store, "device", rank, world, f"{host}\t{dev}")]
    return dev, choose_backend(placement)


def init_world(init_method: str, world: int, rank: int, device="cuda", log=print) -> torch.device:
    """Join a world of ``world`` ranks as ``rank`` through the store at
    ``init_method`` (``tcp://host:port``, ``file://path`` or ``env://``).
    On the CPU the world runs over gloo; on cards ``join_layout`` gives the
    rank's card, which becomes the process's current card, and the
    backend. Returns the rank's device."""
    if torch.device(device).type != "cuda":
        dev, backend = torch.device(device), "gloo"
        dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                                rank=rank)
    else:
        store, _, _ = next(dist.rendezvous(init_method, rank=rank, world_size=world))
        dev, backend = join_layout(store, rank, world, device)
        if dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend=backend, store=dist.PrefixStore("default_pg", store),
                                world_size=world, rank=rank)
    log(f"distributed: rank {rank} of {world}, backend {backend}, device {dev}")
    return dev


def maybe_init_distributed(log=print, device="cuda") -> bool:
    """Join the world the launcher configured (the ``ARTIS_*`` variables),
    if any. Must run before anything touches a device. Returns True when a
    world was joined. ``device`` is the run's device (the CLI's
    ``--device``): on the CPU the world runs over gloo."""
    coord = os.environ.get("ARTIS_COORDINATOR")
    if not coord:
        return False
    if coord == "auto":
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method = f"tcp://{coord}"
        world = int(os.environ["ARTIS_NUM_PROCESSES"])
        rank = int(os.environ["ARTIS_PROCESS_ID"])
    init_world(init_method, world, rank, device=device, log=log)
    return True

"""Command-line drivers: sn3d (simulation) and exspec (spectra).

Port of the JAX package's CLI (reference: sn3d.cc:686-946 main,
exspec.cc:155-248 main). The preset is selected at runtime with --preset
plus field overrides (--set key=value); --device picks where the tensors
live (a CUDA device runs the crossing kernel). sn3d takes the run
directory's pid lockfile (artis.pid) for the run.

    python -m artis_tpu_torch.cli --rundir RUN --preset kilonova_lte \
        --set npkts=65536 --device cuda

--mesh runs on many ranks, one process each (the reference's MPI ranks,
sn3d.cc:197-348; ``parallel/mesh.py``): each transports its shard of the
packets and solves its share of the cells. ``--mesh N`` starts N ranks on
this host (rank r on card r % device_count, or all on the CPU with
``--device cpu``; ranks that share a card talk over gloo), ``--mesh auto``
(the default) one per visible card when there is more than one, ``--mesh
off`` one process. Under a launcher (``torchrun`` with
``ARTIS_COORDINATOR=auto``, or ``ARTIS_COORDINATOR`` / ``ARTIS_NUM_PROCESSES``
/ ``ARTIS_PROCESS_ID`` per process) every process runs this command and
joins the launcher's world;

runs at the preset's transport_dtype, float64 (the crossing kernel's
double instantiation); ``--set transport_dtype=float32`` runs the float32
one;

    python -c "from artis_tpu_torch.cli import main_exspec; \
        main_exspec(['--rundir', 'RUN', '--preset', 'classic'])"

Enum fields take their member names: --set grid_type=CYLINDRICAL2D,
--set particle_thermalisation_scheme=BARNES.
"""

from __future__ import annotations

import argparse
import ast
import os
import shutil
import sys
import tempfile

from . import options as options_mod


def _build_opts(args) -> "options_mod.Options":
    preset_fn = {
        "kilonova_lte": options_mod.kilonova_lte,
        "classic": options_mod.classic,
        "nltenebular": options_mod.nltenebular,
        "nltewithoutnonthermal": options_mod.nltewithoutnonthermal,
        "christinenonthermal": options_mod.christinenonthermal,
    }[args.preset]
    overrides = {}
    for item in args.set or []:
        key, _, val = item.partition("=")
        try:
            parsed = ast.literal_eval(val)
        except (SyntaxError, ValueError):
            parsed = val
        if key == "grid_type":
            parsed = options_mod.GridType[str(val)]
        elif key in ("particle_thermalisation_scheme", "gamma_thermalisation_scheme"):
            parsed = options_mod.ThermalisationScheme[str(parsed)]
        overrides[key] = parsed
    return preset_fn(**overrides)


def mesh_request(value: str):
    """--mesh as the Simulation takes it: None (off), "auto" or a rank
    count (artis_tpu/cli.py:63-64)."""
    return None if value == "off" else ("auto" if value == "auto" else int(value))


def main_sn3d(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="artis-sn3d-torch",
                                 description="ARTIS simulation (PyTorch/CUDA)")
    ap.add_argument("--rundir", default=".", help="directory with input.txt, model.txt, atomic data")
    ap.add_argument("--datadir", default=None, help="decay/gamma-line data directory")
    ap.add_argument("--preset", default="kilonova_lte",
                    choices=["kilonova_lte", "classic", "nltenebular",
                             "nltewithoutnonthermal", "christinenonthermal"])
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="override an Options field, e.g. --set npkts=100000")
    ap.add_argument("-w", "--walltimehours", type=float, default=-1.0,
                    help="soft walltime limit; checkpoint and exit in time (sn3d.cc:749-760)")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ap.add_argument("--mesh", default="auto",
                    help="ranks: 'auto' = the launcher's world, else one per visible card "
                         "when there is more than one (the reference's MPI ranks, "
                         "sn3d.cc:197-348), 'off' = one process, or an integer rank count")
    args = ap.parse_args(argv)
    mesh = mesh_request(args.mesh)

    import torch
    import torch.distributed as dist

    from .parallel import mesh as mesh_mod
    from .parallel.distributed import maybe_init_distributed

    # the launcher's world, if it configured one: before anything touches a
    # device (the MPI_Init analogue, sn3d.cc:693)
    if maybe_init_distributed(device=args.device):
        try:
            world = dist.get_world_size()
            if mesh is None and world > 1:
                raise ValueError(f"--mesh off in a launched world of {world} ranks")
            # the rank's card, current since it joined
            dev = torch.device(args.device)
            if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
                dev = torch.device("cuda", torch.cuda.current_device())
            _run_sn3d(args, mesh, dev, world, round_npkts=mesh == "auto")
        finally:
            dist.destroy_process_group()
        return 0
    auto = mesh == "auto"
    if auto:
        ncards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
        mesh = ncards if ncards > 1 else None
    if mesh is not None and mesh > 1:
        # one process per rank on this host, joined through a file store
        store = tempfile.mkdtemp(prefix="artis_mesh_")
        try:
            mesh_mod.spawn(_sn3d_rank, mesh, "file://" + os.path.join(store, "store"),
                           device=args.device, args=(args, auto))
        finally:
            shutil.rmtree(store, ignore_errors=True)
        return 0
    _run_sn3d(args, None, args.device, 1)
    return 0


def _sn3d_rank(mesh, args, auto):
    _run_sn3d(args, mesh, mesh.device, mesh.world, round_npkts=auto)


def _run_sn3d(args, mesh, device, world, round_npkts=False):
    """One process's share of the run on ``device``: alone, or as a rank of
    a world of ``world`` (``mesh`` the Simulation's mesh request). With
    ``round_npkts`` (--mesh auto) npkts is rounded up to a multiple of the
    world size (artis_tpu/cli.py:67-72)."""
    from .driver import Simulation

    opts = _build_opts(args)
    if round_npkts and opts.npkts % world:
        opts = opts.replace(npkts=-(-opts.npkts // world) * world)
    # the run directory's pid lockfile, as the JAX package's sn3d takes it
    # (artis_tpu/cli.py:73); released when the run closes
    sim = Simulation(args.rundir, opts, datadir=args.datadir, device=device, lockfile=True,
                     mesh=mesh)
    try:
        sim.run(walltime_hours=args.walltimehours)
    finally:
        sim.close()


def main_exspec(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="artis-exspec-torch",
                                 description="spectrum/light-curve extraction")
    ap.add_argument("--rundir", default=".")
    ap.add_argument("--preset", default="kilonova_lte",
                    choices=["kilonova_lte", "classic", "nltenebular",
                             "nltewithoutnonthermal", "christinenonthermal"])
    ap.add_argument("--set", action="append", metavar="KEY=VALUE")
    args = ap.parse_args(argv)

    from .exspec import run_exspec

    run_exspec(args.rundir, _build_opts(args))
    return 0


if __name__ == "__main__":
    sys.exit(main_sn3d())

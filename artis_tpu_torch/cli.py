"""Command-line drivers: sn3d (simulation) and exspec (spectra).

Port of the JAX package's CLI (reference: sn3d.cc:686-946 main,
exspec.cc:155-248 main). The preset is selected at runtime with --preset
plus field overrides (--set key=value); --device picks where the tensors
live (a CUDA device runs the crossing kernel). sn3d takes the run
directory's pid lockfile (artis.pid) for the run. Multi-device runs
(--mesh) are not ported.

    python -m artis_tpu_torch.cli --rundir RUN --preset kilonova_lte \
        --set npkts=65536 --device cuda

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
import sys

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
    args = ap.parse_args(argv)

    from .driver import Simulation

    # the run directory's pid lockfile, as the JAX package's sn3d takes it
    # (artis_tpu/cli.py:73); released when the run closes
    sim = Simulation(args.rundir, _build_opts(args), datadir=args.datadir, device=args.device,
                     lockfile=True)
    try:
        sim.run(walltime_hours=args.walltimehours)
    finally:
        sim.close()
    return 0


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

"""Smoke test of the PyTorch/CUDA port (artis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero and no result
line is printed):
  1. device check: a CUDA device is required; prints nvidia-smi's name and
     power limit;
  2. build: compiles the r-packet crossing kernel from csrc/ with nvcc, its
     float32 instantiations and their float64 forms, two nvcc processes
     at once;
  3. kernel vs plain version on the card, injected and Philox draws, the
     tolerances of the JAX package's kernel parity tests
     (rpkt_kernel.compare_outputs, every estimator cell by cell):
     - 1D spherical: the default scene's shapes (65536 r-packets, 16 shells,
       196 lines) with timestep-0 tables, and the r-packets the port's own
       timestep 0 leaves in flight at the default and the 128-shell /
       101k-line sizes;
     - 3D Cartesian with detailed bf-rate estimators: a 1D model on the
       50^3 grid (max_inner 1, 4, 64), a 2D model on a 12^3 grid, the big
       scene (16^3 3D model, 2176 cells, 101k lines) with its own
       timestep-0 tables and the lanes its timestep 0 leaves in flight
       (timestep 1's non-grey tables), and a 32^3 model whose estimator
       rows exceed shared memory;
     - 2D cylindrical (K3): the 25 x 50 kilonova_2d_2dgrid model, and the
       same cylinder with the 101,010-line Fe atom;
     - binned expansion opacities (K4): a dense 8-shell 1D scene (max_inner
       1, 4, 64), the 25 x 50 cylinder with the 101k-line Fe atom and the
       big scene's 16^3 model with its own opacity bins; bound-bound bin
       events must occur;
     - the deferred events of dipole scattering (K6): the classic scene's
       16^3 model with its own timestep-0 tables, then ionised and denser,
       without and with grey cells (max_inner 1, 4, 64); in each of the
       latter cases bound-bound, electron-scattering, free-free, bound-free
       and (with grey cells) thick events must all leave the kernel, and
       none scatters inside it;
     - the multibin and J_b_lu estimators (K5-multibin, K5-jblue): the
       nebular scene (the 128-shell profile on the 50^3 grid, the Fe atom,
       nltenebular without the non-thermal solver: LUT estimators off,
       bf-rate estimators on) with its own timestep-0 tables (max_inner 1,
       4, 64) and the lanes its timestep 0 leaves in flight, and the
       default 16-shell scene with both estimators (and the LUT ones); a
       bin row or J_b_lu row that stays zero in every case fails;
     - the free-free continuum of the grey opacity cases 0-3 (``ff_only``):
       K1 on the default scene's non-grey and denser ionised shells, and
       the 3D walk on the 1D model on 50^3 with bf-rate estimators; no
       lane may take an electron-scattering or bound-free event and the
       kernel's electron-scattering and bound-free opacities and LUT rows
       must be zero, and free-free events must occur;
     the double form of every configuration (the float64 instantiations,
     ``transport_dtype="float64"``) on the same cases in float64
     (``as_f64``: K1's non-grey, ionised and captured lanes, ff-only, the
     1D model on 50^3 and the big scene's captured lanes for K2 and
     K5-bfrate, the cylinder, the Fe-atom cylinder's cases and captured
     lanes (the 101,010-line list), the three K4 scenes (the big scene's:
     the double 3D bin walk), K6 with grey cells, the nebular cases and
     the default scene with the K5 fields), held to the float64 tolerances
     (rpkt_kernel.TOL_F64: 1e-9, estimators 1e-8); the NLTE instantiations
     of the bin walks (the dense 1D scene, the Fe-atom and the big scene's
     bins) and of the cylindrical line walk, with the multibin rows (and
     the J_b_lu rows on the line walk), max_inner 1 and 64 on ionised
     cells, in both precisions, every estimator accumulating; phase 3 logs
     the kernels it held (rpkt_kernel.kernel_name, as the wrapper recorded
     its launches) and raises unless they are every kernel the dispatcher
     can launch (rpkt_kernel.dispatchable_kernels: 21 instantiations of the
     generic kernel and the float32 1D walk's kernel);
     then the time of each kernel configuration and of its double form
     against its plain version at N=65536, max_inner=64 (plain, kernel,
     kernel, plain), wrapper-inclusive and kernel-only, the kernel in both
     estimator-row modes (shared memory, global atomics) where the rows
     fit shared memory, each beside its bound (the double forms' in 8-byte
     floats over the float64 peak);
  4. end to end through ``artis_tpu_torch.cli.main_sn3d``, each run with the
     launch counts reset just before it and read just after (a float32
     run must launch no double form, a run at the preset's float64 only
     double forms; ``SCENES``); the presets' float64 (``_f64``, no
     transport_dtype override) carries the depth and the checks, and each
     float32 twin (the same name without ``_f64``) runs its path at its
     cheapest depth (timestep 0, or 0-1 where timestep 0 is grey, 0-3 for
     the Spencer-Fano solve; NPKTS_TWIN packets where its float64 run has
     more; ``TWIN_BUDGET_S`` where that run stops at a wall budget) with
     the checks that hold at that depth: the default 1D scene (65536
     packets, timesteps 0-4) and default_scene_f64 (this slice's path,
     the double K1; every timestep's escaped cmf luminosity within
     4/sqrt(n) of the float32 default's), default_opacity3 (grey opacity
     case 3 with rho_crit_para 5e-7 and the run diagnostics: K1 with the
     free-free continuum; timestep 1 has shells on both sides of
     rho_crit, no electron-scattering or bound-free event is counted,
     linestat.out's counts equal the bound-bound counters,
     macroatom_0000.out has rows, the lockfile is gone) and its float64
     run, realistic_scene_f64 (the 128-shell / 101,010-line scene, 2^20
     packets, timesteps 0-1; the twin timestep 0), kilonova_2d_2dgrid at
     25 x 50 (2^18 packets, timesteps 0-1) and its float64 run,
     big_scene_f64 (the 16^3 model with bf-rate estimators, timestep 0,
     2^20 packets; the twin the same), kilonova_2d_2dgrid_fe_f64 (the
     cylinder with the Fe atom's lines walked, 2^18 packets, timesteps
     0-1; the twin the same), the cylinder with expansion opacities in
     both precisions (timesteps 0-1; macro-atom bound-bound activations
     must occur), the default scene with Barnes particle and Guttman
     gamma thermalisation (gamma lines for Ni56 and Co56, gamma packets
     must be emitted: the float64 run timesteps 0-4, the twin 0-1),
     nebular_1d_3dgrid_nont_f64 (nltenebular without the non-thermal
     solver on the 128-shell profile on 50^3 with the Fe atom, 2^20
     packets, timesteps 0-2, NLTE populations in 2 with the CI's one NLTE
     outer iteration: the log shows the NLTE outer loop, nlte_0000.out and
     radfield_0000.out are finite, a population departs from its
     Boltzmann value, the bin and J_b_lu estimators accumulated; the twin
     timestep 0), nebular_1d_3dgrid_f64 (the same with the non-thermal
     solver, timesteps 0-3, the Spencer-Fano solve at 256 points with
     Auger electrons in 3: the same checks, the NT outcome counters of
     every timestep sum to the leptons that reached the deposition split,
     as many go to ionisation as its fractions make likely, every
     frac_heating in (0, 1]; then the first solve again on the CPU from
     its captured inputs, every output within rtol 1e-9; the twin the
     same timesteps, its NLTE checks and the CPU solve), classic_3d_f64
     (the classic preset on the 16^3 model, 2^20 packets, timesteps 0-2,
     the last two with the nlte update: electron scatterings are counted,
     T_e leaves T_J in some cell, an escaped packet carries Q or U
     exactly when it was electron-scattered since its emission; the twin
     timestep 0, its polarisation, then exspec through its CLI in its
     default mode, the 100 direction bins: specpol.out finite with
     spec.out as its Stokes I, every direction bin's spectrum finite and
     their mean spec.out), classic_3d_vpkt_f64 (its scene with virtual
     packets, timestep 0, 2^20 packets: ``VPKT_TXT``'s three observers,
     six exclusion channels, vpkt-thick cells and velocity-grid maps;
     timestep 0's rpkt steps and packets are classic_3d_f64's bit for
     bit, the spectra and maps are finite, every observer's I non-zero,
     every channel's I at least channel 0's, one spawn traced again on
     the card and the CPU agrees, the float32-table error of the
     closed-form segment tau is measured; the twin the same checks against
     classic_3d), kilonova_2d_2dgrid_xcomgammaphotoion_f64 (XCOM on the
     synthetic table and gamma lines, 2^18 packets, timestep 0: every
     opacity and deposition finite, one call's opacities on the card and
     the CPU within rtol 1e-12; the twin the same) and classic_dense_f64
     (a dense, hot 8-shell classic scene on 8^3, 8192 packets, timesteps
     0-1 each at the ``CLASSIC_DENSE_BUDGET_S`` wall budget: some escaped
     packet was electron-scattered and carries the Q / U it gave it; the
     twin timestep 0, its polarisation); the checks of each run are
     ``POST_RUN``; every timestep completes or stops at its run's wall
     budget (flagged in the log), every output is finite and packets
     escape; each run logs its kernel launches, their summed CUDA-event ms
     (``propagate.timing``), the lane-count range and their
     share of the run's transport seconds, and every float64 run its
     escaped luminosity beside its twin's and 4/sqrt(n); then the default
     scene's timesteps 0-1 without and with the run diagnostics, in
     lockstep: packet states and cells bitwise, and every estimator but
     the kernel's float-atomic sums and the diagnostics' own
     (``check_diagnostics_observe``); then timestep 0 of the default
     scene's shells at 1e4 times the density with no grey timestep, cut
     after 32 transport iterations, under case 4 without and with the
     diagnostics and under case 3 with them (``check_opacity_cases_differ``:
     the diagnostics leave case 4's packets and cells bitwise, case 4
     scatters on electrons and case 3 does not, both absorb in lines and
     count them as their counters do); then the mesh (``phase_mesh``,
     this slice's path on ``artis_tpu_torch.parallel``): default_scene_f64,
     timesteps 0-3, through ``cli.main_sn3d --mesh 2``, whose two ranks
     share the card over gloo, 32768 packets each: timesteps 0-1, the run
     continued from its checkpoint of timestep 1 to timestep 3, and a copy
     resumed from its checkpoint of timestep 3; each rank's launch counts
     in every timestep (the double K1 alone, ``rank_launches`` of
     transport_log.json), the world's escaped cmf luminosity within
     4/sqrt(n) of default_scene_f64's in every timestep, timestep 0's
     all-reduced estimators equal to the two shards run one after another
     in this process with the keys fold_in(key, 0) and fold_in(key, 1)
     (bitwise but for rpkt_kernel.ATOMIC_SUMS, which agree within
     rpkt_kernel.atomic_sums_agree), each resume repeating its first
     timestep, and the collectives' seconds per timestep; then a one-rank
     NCCL world in this process, timesteps 0-1, each held to one shard
     with the key fold_in(key, 0) from the same state (``--scenes
     mesh_default_scene_f64`` runs the phase alone, after
     default_scene_f64);
  5. prints the kernel records, the card and, last, the device record.

    python3 chip_smoke.py --rows-sweep

times the kernel's two estimator-row modes over growing cell counts
(``rows_sweep``), the measurement behind rpkt_kernel.SHARED_ROWS_MAX, and
prints no result line.

    python3 chip_smoke.py --repeat

runs same-seed pairs of the nebular, default, kilonova_2d_2dgrid and
expansion-opacity scenes in lockstep (``repeat_runs``): whether a
scattered host sum gives two results on the same inputs, whether timestep
0 repeats bit for bit but for the sums the kernel adds with float atomics,
and how far those sums and the later timesteps differ; prints no result
line.

    python3 chip_smoke.py --scenes NAME [NAME...]

runs the named main-path scenes of phase 4 alone and logs their records
(per-timestep grid-update seconds, wall, peak device memory, kernel
share), ``mesh_default_scene_f64`` the mesh phase; prints no result line.

    python3 chip_smoke.py --kernel-ab ROOT [ROOT...] [--replays NAME...] [--forced LABEL...]

compares the float32 kernels' SASS of other checkouts of the port (e.g. a
parent commit unpacked with ``git archive`` into a gitignored directory)
with this checkout's, instruction for instruction, then times this
checkout's kernel against theirs
on the same inputs, configuration by configuration (``AB_SCENES``, each
in float32 and float64), with the
lanes in packet order (the main path's) and sorted by (model cell,
cursor), in alternating rounds (``kernel_ab``): wrapper-inclusive and
kernel-only CUDA-event times, ptxas registers, stack and spills of both
libraries and the work per crossing;
then the launches of the main paths in ``REPLAYS`` (the default and
128-shell 1D scenes, the big 3D scene, the cylinder at the synthetic and at the Fe line
list, the expansion-opacity cylinder, nebular, classic_3d, and the float64
runs big_scene_f64, nebular_1d_3dgrid_nont_f64, classic_3d_f64,
kilonova_2d_2dgrid_f64, default_scene_f64, default_opacity3_f64 and the
float64 expansion-opacity cylinder) replayed through
each kernel in both orders, with each version's counters (advances and
boundary crossings per lane, lines or bins walked and bf continua per
advance); with ``--replays`` and / or ``--forced`` only the named replays
and forced-lane configurations (the labels of ``AB_SCENES``); prints no
result line.
"""

from __future__ import annotations

import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NPKTS_DEFAULT = 65536
NPKTS_REAL = 1 << 20
NPKTS_2D = 1 << 18
NPKTS_DENSE = 8192
# the float32 twins of the deep float64 runs of phase 4 (classic_3d,
# classic_3d_vpkt, nebular_1d_3dgrid_nont)
NPKTS_TWIN = 1 << 16
KERNEL_SOURCE = "artis_tpu_torch/csrc/rpkt_crossing.cu"
PALLAS = "artis_tpu/transport/pallas_rpkt.py"
# kernel configuration -> (record name, the Pallas branch it replaces)
CONFIGS = {
    "rpkt_crossing_sph1d": ("K1", f"{PALLAS}:863"),
    "rpkt_crossing_cart3d": ("K2", f"{PALLAS}:712"),
    "rpkt_crossing_cyl2d": ("K3", f"{PALLAS}:751"),
    "rpkt_crossing_bfrate": ("K5-bfrate", f"{PALLAS}:1515"),
    "rpkt_crossing_expansion": ("K4", f"{PALLAS}:1136"),
    "rpkt_crossing_deferred": ("K6", f"{PALLAS}:1426"),
    "rpkt_crossing_multibin": ("K5-multibin", f"{PALLAS}:1491"),
    "rpkt_crossing_jblue": ("K5-jblue", f"{PALLAS}:1254"),
    # the free-free continuum of the grey opacity cases 0-3 (a runtime field
    # of every instantiation): the continuum of _kernel, which the JAX
    # package runs outside Pallas below case 4 (opacity.py:242-258)
    "rpkt_crossing_ffonly": ("ff-only", f"{PALLAS}:980"),
}
# the double form of each (transport_dtype float64, the default): the same
# branch, the float64 instantiation of csrc/rpkt_crossing.cu
F64 = "_f64"
CONFIGS.update({k + F64: (f"{label} float64", where) for k, (label, where) in CONFIGS.items()})
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)


def log(msg):
    print(msg, flush=True)


def default_scene(d):
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=16, ntimesteps=6, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             logrho0=-9.0, logrho_slope=-0.15)


# default_opacity3: the default scene under opacity case 3 with a
# rho_crit_para that moves the regime switch into the run: at 5e-7 the inner
# shells lie above rho_crit in timesteps 1-2 and none by timestep 3
OPACITY3_RHO_CRIT_PARA = 5e-7


def default_opacity3_scene(d):
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=16, ntimesteps=6, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             logrho0=-9.0, logrho_slope=-0.15, opacity_case=3,
             rho_crit_para=OPACITY3_RHO_CRIT_PARA)


# the run diagnostics' options
DIAGNOSTICS = dict(record_linestat=True, track_ion_stats=True, log_macroatom=True)


def real_scene(d):
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    # the default scene's density profile stretched over 128 shells, with the
    # ~1e5-line Fe atom of the JAX package's big bench scene (3 x C(260, 2))
    make_run(d, ncells=128, ntimesteps=3, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             logrho0=-9.0, logrho_slope=-0.15 * 15 / 127)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=260)


def big_scene(d, ntimesteps=4):
    """The JAX package's bench `big` scene (bench.py:161-188): a 16^3 3D
    model (2176 nonempty cells) with the 101,010-line Fe atom, timesteps 0
    to ``ntimesteps`` - 2."""
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    make_run(d, ncells=16, ntimesteps=ntimesteps, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             model_dim=3, logrho0=-9.0, logrho_slope=-0.15)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=260)


def classic_scene(d):
    """The big scene's 16^3 model and Fe atom for the classic preset, run as
    tests/test_configmatrix.py runs the classic configurations: no grey
    timestep, and ``num_lte_timesteps=1`` so timesteps 1-2 take the
    non-LTE grid update."""
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    make_run(d, ncells=16, ntimesteps=4, tmin_days=5.0, tmax_days=9.0, ngreyts=0,
             model_dim=3, logrho0=-9.0, logrho_slope=-0.15, num_lte_timesteps=1)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=260)


# vpkt.txt of classic_3d_vpkt (reference: vpkt.cc:611-790): three
# observers at cos theta 1, 0 and -1 (clipped to +-0.9999) and phi 0, 90
# and 0 degrees; six spectra: all opacity, no bound-bound, no bound-free,
# no free-free, no electron scattering, no Fe (the second line table); the
# run's time window and the default frequency window; cells deeper than the
# grey depth {thick} become vpkt-thick (thick=2: virtual packets die there,
# real ones transport in full); tau_max 10; the velocity-grid maps on for
# the days {vg_t0}-{vg_t1} and one window of 600-30000 Angstrom (the
# spectra's frequency window)
VPKT_TXT = ("3\n1 0 -1\n0 90 0\n1\n6\n0 -1 -2 -3 -4 26\n0 0 0\n0\n1 {thick!r}\n10\n"
            "1\n{vg_t0} {vg_t1}\n1\n600 30000\n")
# the share of classic_3d_vpkt's nonempty cells made vpkt-thick in
# timestep 0: the deepest tenth by grey depth
VPKT_THICK_SHARE = 0.1
# classic_3d_vpkt's last timestep, whose one spawn is traced again on the
# CPU (1 until the smoke was cut in depth: timestep 1 cost 35 s of its 72)
VPKT_SPAWN_TS = 0


def _grey_depth(d, grid_type, ncoord, nts):
    """The grey depth of each nonempty cell at timestep ``nts``'s middle,
    as ``Simulation.update_grid`` computes it for opacity case 4 (the
    kappagrey of grid.cc:1722-1834 over the model's Fe-group mass), from
    the run directory's model alone."""
    from artis_tpu_torch import grid as grid_mod
    from artis_tpu_torch.driver import GREY_OP
    from artis_tpu_torch.io import inputparams as ip
    from artis_tpu_torch.io import model as model_io
    from artis_tpu_torch.options import GridType

    p = ip.read_parameterfile(os.path.join(d, "input.txt"))
    assert p.opacity_case == 4
    model = model_io.read_model(os.path.join(d, "model.txt"), p.tmin)
    grid, host = grid_mod.grid_init(model, p.tmin, GridType[grid_type], ncoord, with_host=True,
                                    device="cpu")
    mgi = host.mgi_of_cell[host.cell_of_nonemptymgi]
    vol = model_io.model_cell_volume_at_tmin(model, p.tmin)
    mtot = (model.rho_tmin * vol).sum()
    mfegroup = (model.rho_tmin * vol * model.ffegrp).sum()
    kappa = (0.9 * model.ffegrp[mgi] + 0.1) * GREY_OP / (0.9 * mfegroup / mtot + 0.1)
    ts = ip.time_init(p.tmin, p.tmax, p.ntimesteps)
    tratmid = float(ts.mid[nts]) / p.tmin
    radial_pos = host.initial_radial_pos_sum_mgi[mgi] * tratmid / host.numpropcells_mgi[mgi]
    dist = np.maximum(0.0, grid.rmax * tratmid - radial_pos)
    return kappa * model.rho_tmin[mgi] / tratmid ** 3 * dist


def stop_after(d, last):
    """Cuts the run of directory ``d`` after timestep ``last`` (input.txt's
    timestep_finish), its timesteps and everything else unchanged."""
    path = os.path.join(d, "input.txt")
    lines = open(path).read().splitlines(True)
    i = next(k for k, line in enumerate(lines) if "timestep_start timestep_finish" in line)
    lines[i] = f"000 {last + 1:03d}                  # timestep_start timestep_finish\n"
    open(path, "w").writelines(lines)


def upto(make_scene, last):
    """``make_scene`` with its run stopped after timestep ``last`` (the
    scene itself is the maker's ``scene``)."""
    def make(d):
        make_scene(d)
        stop_after(d, last)
    make.scene = make_scene
    return make


def uncut(make_scene):
    """A scene maker without its ``upto`` cut, for a caller that runs its
    own timesteps (``REPLAYS``, ``REPEAT_SCENES``)."""
    return getattr(make_scene, "scene", make_scene)


def classic_vpkt_scene(d):
    """classic_3d's scene (the same timesteps; the run stops after timestep
    ``VPKT_SPAWN_TS``, 0, since the smoke's cut in depth) with ``VPKT_TXT``:
    the deepest ``VPKT_THICK_SHARE`` of the cells by timestep 0's grey
    depth are vpkt-thick."""
    classic_scene(d)
    stop_after(d, VPKT_SPAWN_TS)
    depth = _grey_depth(d, "CARTESIAN3D", (16, 16, 16), 0)
    thick = float(np.quantile(depth[depth > 0], 1.0 - VPKT_THICK_SHARE))
    with open(os.path.join(d, "vpkt.txt"), "w") as f:
        f.write(VPKT_TXT.format(thick=thick, vg_t0=5.0, vg_t1=9.0))


def xcom_scene(d):
    """kilonova_2d_2dgrid (``cyl_scene``) with the synthetic XCOM table and
    Ni56 / Co56 gamma lines (synthdata)."""
    from artis_tpu_torch.synthdata import write_synthetic_gamma_lines, write_synthetic_xcom_data

    cyl_scene(d)
    write_synthetic_xcom_data(d)
    write_synthetic_gamma_lines(d)


def classic_dense_scene(d):
    """A dense, hot classic scene in which electron scattering is common
    (the 8 shells, 1-2 days and logrho0 -6 of tests/test_torch_deferred.py):
    escaped packets that were electron-scattered since their emission, so
    that the Stokes vectors of dipole scattering reach the packet output.
    The classic_3d model is cold (a few scatterings in 2^20 packets)."""
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=8, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-6.0, num_lte_timesteps=1)


def nebular_scene(d):
    """nebular_1d_3dgrid (tests/test_configmatrix.py) at the realistic
    scene's size: its 128-shell 1D profile, mapped onto the 50^3 Cartesian
    grid, and the 101,010-line Fe atom; no grey timestep, LTE timesteps 0-1
    and NLTE populations from timestep 2 (``NEBULAR`` cuts the rest)."""
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    make_run(d, ncells=128, ntimesteps=5, tmin_days=5.0, tmax_days=9.0, ngreyts=0,
             logrho0=-9.0, logrho_slope=-0.15 * 15 / 127, num_lte_timesteps=2)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=260)


def nebular_nt_scene(d):
    """The nebular scene with the synthetic non-thermal data files
    (collion.txt, binding energies, Auger table) for its Fe atom in the run
    directory, which the Spencer-Fano solver reads."""
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    nebular_scene(d)
    write_synthetic_nonthermal_data(d, elements=((26, 3),))


# nltenebular cut in depth so that in four timesteps every consumer runs:
# the bf-rate estimators from timestep 2 (the CI's nebular entries use 1-2)
# and the binned field from timestep 3; with the non-thermal solver
# (the preset's Spencer-Fano solve at sf_points 256, Auger electrons on:
# timestep 2, the first non-LTE one, keeps the default solution, timestep 3
# solves) and without it
#
# In the NLTE timesteps the Fe leaves Fe I (with the solver mostly for
# Fe III), and its macro-atoms then take thousands of jumps before they
# deactivate, as the JAX package's do (tests/test_torch_nt_chains.py): the
# transport of timestep 2 did not end within the smoke's time limit
# (PERF.md, section 6). Timesteps 2-3 of both scenes stop at a wall budget,
# and the macro-atoms still active go on in the next timestep. 20 s, not
# 30 s: with 30 s the whole smoke took 1040 s of its 1200 s on one card
# once the grey opacity cases and the run diagnostics were in it (and
# timestep 0 alone takes 12 s, so the budget must stay above that). Without
# the solver the scene's NLTE outer loop never converges (30 iterations, 31-42
# s a grid update): it runs the CI's one outer iteration
# (tests/test_configmatrix.py), so that the smoke stays inside its limit
# with the float64 phases
NT_WALL_BUDGET_S = 20.0
NEBULAR = dict(nt_on=False, nt_solve_spencerfano=False, nlte_outer_iters=1,
               detailed_bf_estimators_usefromtimestep=2, first_nlte_radfield_timestep=3,
               transport_wall_budget=NT_WALL_BUDGET_S)
NEBULAR_NT = dict(detailed_bf_estimators_usefromtimestep=2, first_nlte_radfield_timestep=3,
                  transport_wall_budget=NT_WALL_BUDGET_S)


def cyl_scene(d):
    """kilonova_2d_2dgrid (tests/test_configmatrix.py) at 25 x 50 cells."""
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=25, ntimesteps=3, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             model_dim=2, logrho0=-9.0, logrho_slope=-0.15)


def cyl_fe_scene(d):
    """kilonova_2d_2dgrid_expansionopac (tests/test_configmatrix.py) at
    25 x 50 cells with the 101,010-line Fe atom."""
    from artis_tpu_torch.synthdata import make_run, write_synthetic_atomicdata

    make_run(d, ncells=25, ntimesteps=4, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             model_dim=2, logrho0=-9.0, logrho_slope=-0.15)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=260)


def expo_dense_scene(d):
    """tests/test_pallas_rpkt.py::scene_expo: 8 dense shells, so the binned
    line opacity drives events."""
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=8, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-6.8)


# synthetic gamma-line lists (MeV, photons per decay): a few of the
# strongest Ni56 and Co56 lines, so that decays make gamma packets
GAMMA_LINES = {"ni56": ((0.158, 0.988), (0.750, 0.495), (0.812, 0.860)),
               "co56": ((0.847, 1.000), (1.238, 0.670), (2.598, 0.170))}


def default_gamma_scene(d):
    default_scene(d)
    for nuc, lines in GAMMA_LINES.items():
        with open(os.path.join(d, f"{nuc}_lines.txt"), "w") as f:
            f.write(f"{len(lines)}\n" + "".join(f"{e} {p}\n" for e, p in lines))


def model2d_scene(d):
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=3, ntimesteps=6, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             model_dim=2, logrho0=-9.0, logrho_slope=-0.15)


def model32_scene(d):
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=32, ntimesteps=6, tmin_days=5.0, tmax_days=9.0, ngreyts=1,
             model_dim=3, logrho0=-9.0, logrho_slope=-0.15 * 15 / 31)


# the main path's options (besides npkts and the grid)
OPTS = dict(transport_dtype="float32", mintemp=1000.0, maxtemp=20000.0, tablesize=20,
            rpkt_crossings_per_dispatch=64)


def cli_args(d, npkts, grid_type, preset="kilonova_lte", **extra):
    """The CLI's arguments; an option set to None is not passed (the
    preset's own value: ``transport_dtype=None`` runs the preset's float64)."""
    args = ["--rundir", d, "--device", "cuda", "--preset", preset, "--set", f"npkts={npkts}",
            "--set", f"grid_type={grid_type}"]
    for k, v in dict(OPTS, **extra).items():
        if v is not None:
            args += ["--set", f"{k}={v!r}"]
    return args


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from artis_tpu_torch.transport import rpkt_kernel

    t0 = time.time()
    rpkt_kernel.build()
    secs = time.time() - t0
    log(f"build: rpkt_crossing.cu built and loaded in {secs:.2f} s")
    _log_ptxas(rpkt_kernel, "this")
    return secs


def _log_ptxas(mod, tag):
    """Registers, stack frame and spills of each kernel of a wrapper's two
    libraries (nvcc -Xptxas -v, the ptxas logs its build wrote), each line
    tagged with its library's precision: f32, or f64 for the double forms
    (their entry names carry ``Id`` where the float32 ones carry ``If``)."""
    for path in sorted(glob.glob(os.path.join(mod._BUILD_DIR, "ptxas_*.log"))):
        prec = "f64" if os.path.basename(path).startswith("ptxas_f64_") else "f32"
        for line in open(path):
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"ptxas[{tag}, {prec}]: {line.strip()}")


def _sass(source, workdir, tag):
    """Each float32 kernel of a crossing-kernel source as its list of SASS
    instructions: the source compiled with the wrapper's flags to a cubin
    and disassembled (cuobjdump -sass); each kernel named by its template
    arguments, with the real-type argument the float32 form gained in the
    float64 slice left out, so that both versions' kernels match."""
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    cubin = os.path.join(workdir, f"sass_{tag}.cubin")
    subprocess.run([os.path.join(cuda, "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-fmad=false", "-cubin", "-o", cubin, source],
                   check=True, capture_output=True)
    dump = subprocess.run([os.path.join(cuda, "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = re.sub(r"kernelIf", "kernelI", m.group(1))
            key = re.sub(r"kernel_1d(If)?E.*", "kernel_1d", key)
            key = re.sub(r"E(E)?v.*", "", key)
            cur = funcs.setdefault(re.sub(r".*rpkt_crossing_", "", key), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return funcs


def _sass_compare(versions, workdir):
    """Logs, for each other version of ``kernel_ab``, whether each float32
    kernel's SASS is this checkout's instruction for instruction."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(versions)) as pool:
        sass = list(pool.map(lambda iv: _sass(iv[1][1]._SOURCE, workdir, iv[0]),
                             enumerate(versions)))
    this = sass[0]
    for (tag, _), funcs in zip(versions[1:], sass[1:]):
        same = 0
        for k in sorted(this):
            a, b = this[k], funcs.get(k)
            same += a == b
            ndiff = (None if b is None
                     else sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))
            log(f"sass[{tag}, {k}]: this {len(a)} instructions, {tag} "
                f"{None if b is None else len(b)}, identical {a == b}, differing {ndiff}")
        log(f"sass[{tag}]: {same} of {len(this)} float32 kernels identical to this checkout's "
            f"(kernels only in {tag}: {sorted(set(funcs) - set(this))})")


def forced_lanes(sim, t0, n, seed, dtype=np.float32):
    """In-flight r-packets spread over the grid at time t0 (the JAX parity
    tests' _force_rpkt_state; shells for 1D, a volume for 2D/3D), as
    ``dtype`` / int32 CUDA lane tensors, with numpy-made injected draws."""
    import torch

    from artis_tpu_torch.grid import get_cellindex_from_pos
    from artis_tpu_torch.options import GridType

    rng = np.random.default_rng(seed)
    grid = sim.grid
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    if grid.grid_type == GridType.SPHERICAL1D:
        ncell = int(grid.ncoordgrid[0])
        cell = rng.integers(0, ncell, n)
        rmin = sim.grid_host.cell_pos_min[:ncell, 0] * t0 / grid.tmin
        rmax = sim.grid_host.cell_pos_max[:ncell, 0] * t0 / grid.tmin
        r = rmin[cell] + (rmax[cell] - rmin[cell]) * rng.uniform(0.02, 0.98, n)
        pos = u * r[:, None]
    else:
        rmax_t = grid.rmax * t0 / grid.tmin
        pos = u * (rmax_t * rng.uniform(0.0, 0.95, n) ** (1 / 3))[:, None]
        cell = get_cellindex_from_pos(grid, torch.as_tensor(pos),
                                      torch.full((n,), t0, dtype=torch.float64)).numpy()
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(14.2, 15.9, n)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype)).cuda()
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32)).cuda()
    lanes = dict(posx=f(pos[:, 0]), posy=f(pos[:, 1]), posz=f(pos[:, 2]),
                 dirx=f(dv[:, 0]), diry=f(dv[:, 1]), dirz=f(dv[:, 2]), nu_rf=f(nu),
                 nu_cmf=f(nu * 0.98), e_rf=f(np.ones(n)), e_cmf=f(np.full(n, 0.98)),
                 prop_time=f(np.full(n, t0)), where=i(cell), next_trans=i(np.zeros(n)),
                 moving=i(np.ones(n)), lane_id=i(np.arange(n)))
    tau = f(-np.log(rng.uniform(0.05, 0.95, n)))
    sel = f(rng.uniform(0.0, 1.0, n))
    return lanes, tau, sel


def ionised_tables(tables):
    """The same shells, not grey, singly ionised at 1e4 K. At timestep 0's
    1000 K the electron density is so low that the free-free term underflows
    float32 to zero; here free-free heating accumulates."""
    import torch

    te = torch.full_like(tables["Te"], 1.0e4)
    nne = tables["rho"] / (56.0 * 1.66054e-24)
    return dict(tables, thick=torch.zeros_like(tables["thick"]), Te=te, nne=nne,
                chiffpart=nne * 3.69255e8 / torch.sqrt(te))


def dense_tables(tables):
    """``ionised_tables`` at 1e2, 1e4 and 1e6 times the electron and ion
    densities, cell by cell in turn: in the Fe-atom models electron
    scattering (linear in nne) and free-free (quadratic) then take a share
    of the continuum events beside bound-free in some cells, while lines
    still catch packets in the thinner ones."""
    import torch

    t = ionised_tables(tables)
    cell = torch.arange(t["nne"].numel(), device=t["nne"].device)
    factor = 10.0 ** (2.0 * (1 + cell % 3)).to(t["nne"].dtype)
    return dict(t, nne=t["nne"] * factor, chiffpart=t["chiffpart"] * factor)


def as_f64(case):
    """A phase-3 case (tag, lanes, tables, tau, sel, t2, max_inner) with its
    float lanes, tables and draws in float64: the inputs of the double
    form."""
    import torch

    tag, lanes, tables, tau, sel, t2, mi = case
    up = lambda d: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
    return (f"{tag} float64", up(lanes), up(tables), tau.double(), sel.double(), t2, mi)


def _kernel_kw(sim, want_bfrate, expansion=False, defer=False, **extra):
    """The crossing's keywords for a phase-3 simulation; ``extra`` (the
    K5-multibin / K5-jblue ones: nradbins, njblue, want_gamma,
    want_bfheat; ff_only) on top; ``relativistic`` in ``extra`` overrides
    the scene's Doppler factors."""
    from artis_tpu_torch.transport import rpkt_kernel

    dad = sim.dad
    rel = extra.pop("relativistic", sim.opts.use_relativistic_doppler_shift)
    return dict(extra, nlines=dad.nlines, ncells=sim.cells.Te.shape[0],
                ngc=max(dad.nbfcontinua_ground, 1), nphixs=dad.nphixspoints,
                relativistic=rel,
                phixs_dnu=float(dad.nphixsnuincrement),
                last_nuovernuedge=float(dad.last_phixs_nuovernuedge),
                want_bfrate=want_bfrate, expansion=expansion, defer_scatter=defer,
                **rpkt_kernel.kernel_geometry(sim.grid))


def _captured_case(sim, seed):
    """The lanes the main path hands the kernel: the port's own timestep 0,
    run on the card, leaves r-packets in flight at its end, and timestep
    1's grid update gives their (non-grey) tables."""
    import torch

    from artis_tpu_torch.transport import rpkt_kernel
    from artis_tpu_torch.transport.engine import rpkt_lanes

    sim.do_timestep(0)
    ctx1 = sim.update_grid(1)
    _, cap = rpkt_lanes(sim.state, ctx1.t2)
    ncap = cap["posx"].shape[0]
    if ncap == 0:
        raise RuntimeError("timestep 0 left no r-packet in flight")
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(-np.log(rng.uniform(0.05, 0.95, ncap)).astype(np.float32)).cuda()
    sel = torch.as_tensor(rng.uniform(0.0, 1.0, ncap).astype(np.float32)).cuda()
    tables = rpkt_kernel.kernel_tables(sim.dad, sim.grid, sim.cells, ctx1)
    return (f"captured(N={ncap}) max_inner=64", cap, tables, tau, sel, float(ctx1.t2), 64)


def _event_kinds(p, sel):
    """Counts of the kinds of event the plain version's lanes took: bound-
    bound, thick-cell grey, and the continuum events split as the event
    pass splits them (a uniform ``sel`` times the continuum opacity against
    electron scattering, then free-free, then bound-free)."""
    ev = p["evented"] > 0
    bb = ev & (p["is_bb"] > 0)
    thick = ev & (p["thick"] > 0)
    cont = ev & ~bb & ~thick
    x = sel * p["chi_cont"]
    escat = cont & (x < p["chi_escat"])
    ff = cont & ~escat & (x < p["chi_escat"] + p["chi_ff"])
    return dict(bb=int(bb.sum()), thick=int(thick.sum()), escat=int(escat.sum()),
                ff=int(ff.sum()), bf=int((cont & ~escat & ~ff).sum()))


# the options of a phase-3 simulation whose main path has the multibin and
# J_b_lu estimators (every line a J_b_lu column)
K5 = dict(multibin_radfield=True, detailed_line_estimators_on=True, jblue_elem_z=0)


def _k5_kw(sim, multibin=True, jblue=True):
    """The multibin and J_b_lu keywords of a simulation's main path (the
    LUT estimators as its options have them)."""
    from artis_tpu_torch.transport.engine import crossing_estimators

    kw = crossing_estimators(sim.opts, sim.est)
    return dict(kw, nradbins=kw["nradbins"] if multibin else 0,
                njblue=kw["njblue"] if jblue else 0)


# the kernels (rpkt_kernel.kernel_name) that phase 3 held against their
# plain version, as the wrapper recorded its launches, and the comparisons
# that held lanes still for a J_b_lu pass tied with a boundary to a cell
# that counts nothing (rpkt_kernel.moved_to_nothing): (case, lanes)
HELD = set()
COUNT_HELD = []


def _check_cases(sim, cases, nonzero, want_bfrate=False, expansion=False, defer=False,
                 every_kind=False, require=False, **extra):
    """Kernel against plain version on each case, injected and Philox draws
    (rpkt_kernel.compare_outputs); raises on any disagreement. Adds the
    kernels it launched to ``HELD``. Marks in
    ``nonzero`` each estimator the plain version accumulated (and, for the
    expansion mode, whether a bound-bound bin event occurred); with
    ``require`` every estimator the launches allocate must accumulate on the
    plain side in one of the cases. In the
    deferred mode (K6) each case's event kinds are logged and the kernel's
    in-kernel scatter counters must stay 0; with ``every_kind`` each case
    must send events of every kind to the pass: bound-bound,
    electron-scattering, free-free, bound-free and, where its tables have
    thick cells, thick-cell grey. With ``ff_only`` (the free-free
    continuum of the grey opacity cases 0-3) no lane may take an
    electron-scattering or bound-free event, in the kernel or after it, and
    the kernel's electron-scattering and bound-free opacities and LUT gamma
    and bf-heating rows must be zero. Returns the prop_time max_abs_err of
    each."""
    import torch

    from artis_tpu_torch.transport import rpkt_kernel

    kw = _kernel_kw(sim, want_bfrate, expansion, defer, **extra)
    tmin, mps = float(sim.grid.tmin), float(sim.grid.max_path_step)
    before = dict(rpkt_kernel.propagate.launches)
    kernels_before = {c: set(v) for c, v in rpkt_kernel.propagate.kernels.items()}
    rpkt_kernel.propagate.kernels.clear()
    ok_all, errs, accumulated = True, [], {}
    for tag, ln, tb, ta, se, t2, max_inner in cases:
        for test_mode in (True, False):
            ok, rep, k, p = rpkt_kernel.check_kernel(
                12345, ln, tb, ta, se, t2, tmin, mps,
                max_inner=max_inner, test_mode=test_mode, **kw)
            torch.cuda.synchronize()
            # the estimators this launch allocates (rows of zero width are off)
            on = {"j", "nuj", "ffheating", "ncross"} | {
                f for f in ("gamma", "bfheat", "bfrate", "radbin", "jblue") if p[f].numel()}
            for name in on:
                accumulated[name] = accumulated.get(name, False) or rep["nonzero"][name]
            both = (k["where"] == p["where"]) & (k["escaped"] == p["escaped"])
            err = float((k["prop_time"].double() - p["prop_time"].double())[both].abs().max()) \
                if bool(both.any()) else 0.0
            rep["prop_time_max_abs_err_s"] = err
            case = f"{tag} {'injected' if test_mode else 'philox'}"
            log(f"compare[{case}] ok={ok}: {json.dumps(rep)}")
            if rep["count_held_lanes"]:
                COUNT_HELD.append((case, rep["count_held_lanes"]))
            if "nradbins" in extra:
                log(f"compare[{tag}]: radbin count {float(p['radbin'][:, 2].sum())}, J_b_lu "
                    f"count {float(p['jblue'][:, 1].sum())}, bin flips "
                    f"{rep.get('radbin_flips')}, moved J_b_lu passes {rep.get('jblue_moved')}")
            for name, nz in rep["nonzero"].items():
                nonzero[name] = nonzero.get(name, False) or nz
            if expansion:
                nbb = int(((p["is_bb"] > 0) & (p["evented"] > 0)).sum())
                log(f"compare[{tag}]: {nbb} bound-bound bin events")
                nonzero["expansion_bb_events"] = nonzero.get("expansion_bb_events",
                                                             False) or nbb > 0
            if defer:
                kinds = _event_kinds(p, se)
                scat = [float(k["misc"][3]), float(k["misc"][4])]
                log(f"compare[{tag}]: deferred events {kinds}, in-kernel scatters {scat}")
                if any(scat):
                    raise RuntimeError(f"{tag}: the deferred mode scattered in the kernel")
                missing = [kind for kind, count in kinds.items() if count == 0
                           and (kind != "thick" or bool((tb["thick"] != 0).any()))]
                if every_kind and missing:
                    raise RuntimeError(f"{tag}: no {missing} event left the kernel")
            if extra.get("ff_only"):
                kinds = _event_kinds(p, se)
                largest = {f: float(k[f].abs().max()) if k[f].numel() else 0.0
                           for f in ("chi_escat", "chi_bf", "gamma", "bfheat")}
                largest["in-kernel electron scatters"] = float(k["misc"][3])
                log(f"compare[{tag}]: ff-only events {kinds}, the kernel's largest {largest}")
                if kinds["escat"] or kinds["bf"] or any(largest.values()):
                    raise RuntimeError(f"{tag}: the free-free continuum took electron "
                                       f"scattering or bound-free opacity")
                nonzero["ff_only_ff_events"] = (nonzero.get("ff_only_ff_events", False)
                                                or kinds["ff"] > 0)
            ok_all &= ok
            errs.append(err)
    # comparison launches (and the timesteps run to capture lanes) are not
    # main-path launches
    rpkt_kernel.propagate.launches.update(before)
    held = set().union(*rpkt_kernel.propagate.kernels.values())
    HELD.update(held)
    rpkt_kernel.propagate.kernels.clear()
    rpkt_kernel.propagate.kernels.update(kernels_before)
    if not ok_all:
        raise RuntimeError(f"kernel disagrees with its plain version ({sim.rundir})")
    if require and not all(accumulated.values()):
        raise RuntimeError(f"{cases[0][0]}: {sorted(held)}: an estimator never accumulated "
                           f"on the plain side: {accumulated}")
    return errs


# the lanes of the NLTE instantiations' phase-3 cases: no main path of
# phase 4 launches them, and the plain version's time grows with the lanes
NLTE_FORM_LANES = 1 << 14


def _check_nlte_forms(sim, cases, errs, nonzero, keys, f32_lanes=NLTE_FORM_LANES, **kw):
    """The NLTE instantiation of a walk (the estimator fields of the
    simulation's main path, ``_k5_kw``: the multibin rows, and the J_b_lu
    rows where the walk has lines) on ``cases`` in float32 and, ``as_f64``,
    in float64, every estimator accumulating (``_check_cases``): the first
    ``f32_lanes`` lanes of each case in float32 (None: all of them) and the
    first ``NLTE_FORM_LANES`` in float64, those at max_inner 64 on their
    cells ionised (``ionised_tables``: at timestep 0's temperatures
    free-free heating underflows float32); the errors go to the ``keys``
    rows and the K5 rows of the fields."""
    def cut(n):
        return [(f"{tag} N={ta[:n].numel()}{' ionised' * (mi == 64)}",
                 {k: v[:n] for k, v in ln.items()}, ionised_tables(tb) if mi == 64 else tb,
                 ta[:n], se[:n], t2, mi)
                for tag, ln, tb, ta, se, t2, mi in cases]

    nkw = _k5_kw(sim)
    keys = tuple(keys) + ("rpkt_crossing_multibin",) * bool(nkw["nradbins"]) + (
        "rpkt_crossing_jblue",) * bool(nkw["njblue"] and not kw.get("expansion"))
    for f64 in (False, True):
        held = [as_f64(c) for c in cut(NLTE_FORM_LANES)] if f64 else cut(f32_lanes)
        e = _check_cases(sim, held, nonzero, require=True, **kw, **nkw)
        for k in keys:
            errs[k + F64 * f64] += e


def _scene_opts(npkts, grid_type="SPHERICAL1D", preset="kilonova_lte", **extra):
    """The options ``cli_args`` gives the CLI: an option set to None takes
    the preset's own value (transport_dtype None: the preset's float64)."""
    from artis_tpu_torch import options

    kw = {k: v for k, v in dict(OPTS, **extra).items() if v is not None}
    return getattr(options, preset)(npkts=npkts, grid_type=options.GridType[grid_type], **kw)


def _phase3_sim(workdir, name, make_scene, npkts, grid_type="SPHERICAL1D",
                preset="kilonova_lte", mesh=None, **extra):
    from artis_tpu_torch.driver import Simulation

    d = os.path.join(workdir, name)
    os.makedirs(d)
    make_scene(d)
    return Simulation(d, _scene_opts(npkts, grid_type, preset, **extra), device="cuda",
                      mesh=mesh)


def _cases(name, sim, tables, t0, t2, mis, seed, n=NPKTS_DEFAULT):
    lanes, tau, sel = forced_lanes(sim, t0, n, seed)
    return [(f"{name} max_inner={mi}", lanes, tables, tau, sel, t2, mi) for mi in mis]


def _nongrey_tables(sim, ctx):
    import torch

    from artis_tpu_torch.transport import rpkt_kernel

    tables = rpkt_kernel.kernel_tables(sim.dad, sim.grid, sim.cells, ctx)
    return tables, dict(tables, thick=torch.zeros_like(tables["thick"]))


def _timed(fn, reps):
    import torch

    out = fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, out


def _union_len(start, end):
    """Length of the union of the intervals [start, end)."""
    import torch

    if start.numel() == 0:
        return 0
    order = torch.argsort(start)
    s, e = start[order], end[order]
    # each interval adds what lies beyond the farthest end before it
    reach = torch.cat([s[:1], torch.cummax(e, 0).values[:-1]])
    return int(torch.clamp(e - torch.maximum(s, reach), min=0).sum())


def _walk_entries(walk_log, nentries):
    """(distinct entries, distinct (model cell, entry) pairs) that the walks
    of a plain-version run read: lines of a line walk, wavelength bins of
    an expansion-opacity walk; ``nentries`` entries per cell."""
    import torch

    mgi, lo, hi = (torch.cat([w[i] for w in walk_log]).long() for i in range(3))
    base = mgi * (nentries + 1)
    return _union_len(lo, hi), _union_len(base + lo, base + hi)


def _bound_ms(out, walk_log, tables, kw, test_mode, elem=4):
    """The least time the card could take for one call with these inputs,
    each input read once and each output written once: the lane inputs the
    call reads (the injected draws only in test mode) and its lane outputs;
    the cell, bound and continuum tables at most once (no more than the
    crossings and opacity windows read of them); of the line tables, the
    distinct lines and (model cell, line) entries that the walks of this
    run read (``walk_log`` of a plain-version run on the same inputs; in
    expansion mode the distinct (model cell, bin) kappa entries, and no line
    table), and with the J_b_lu estimators the same distinct entries of
    ``jblue_of_line``; every estimator row the launch allocates (multibin
    and J_b_lu rows included) and the counters out once. That over the HBM
    rate, against an operation count (about 400 float32 operations per
    crossing, 20 per line read, 30 per bin read and 40 per bf continuum in
    a window, counted from the source; with the multibin estimators 2 more
    per crossing for the range test and 12 per midpoint that lands in a
    bin; with the J_b_lu estimators 2 more per line read for the column
    test and 6 per pass that adds to a selected line's row, the passes
    this run's data made) over the float32 peak. ``elem`` 8 (a float64
    launch): every float read and written takes 8 bytes, and the operations
    go over the float64 peak outside the tensor cores. Returns (ms, 'bytes'
    or 'operations', bytes)."""
    from artis_tpu_torch.transport import rpkt_kernel

    misc = out["misc"].double().cpu().numpy()
    nadv, nwalk, nbfwin = misc[0], misc[6], misc[7]
    n = out["posx"].shape[0]
    size = lambda *names: sum(tables[k].element_size() * tables[k].numel() for k in names)
    ndim = rpkt_kernel.GEOM_NDIM[kw["geom"]]
    # mgi and the thick flag, five cell values, the cell's bounds
    cell_row = 4 * 2 + elem * (5 + 2 * ndim)
    cell_tables = size("mgi_of_cell", "cellmin", "cellmax", "nne", "Te", "kappagrey", "rho",
                       "chiffpart", "thick")
    bf_row = elem * (1 + 2 + 3) + 4  # edge, two phixs points, a/dep/prob, ground index
    bf_tables = size("cont_nu_edge", "cont_phixs", "cont_prob", "cont_gidx", "bf_a", "bf_dep",
                     "gc_nu_edge")
    expansion = kw.get("expansion", False)
    lines, entries = _walk_entries(walk_log, rpkt_kernel.NBINS if expansion else kw["nlines"])
    if expansion:
        lines = 0  # the bin edges are computed, not read
    njb, nrb = out["jblue"].shape[2], out["radbin"].shape[2]
    rows = sum(out[k].numel() for k in ("est", "gamma", "bfheat", "bfrate", "radbin", "jblue"))
    # a lane reads 11 floats (13 with the injected draws) and 4 ints, and
    # writes 19 floats and 11 ints
    lane_bytes = elem * (11 + (2 if test_mode else 0) + 19) + 4 * (4 + 11)
    nbytes = (n * lane_bytes + min(nadv * cell_row, cell_tables)
              + min(nbfwin * bf_row, bf_tables) + lines * (elem + 4 * (njb > 0))
              + elem * (entries + rows) + 8 * len(misc))
    bin_adds = float(out["radbin"][:, 2].sum()) if nrb else 0.0
    jb_passes = float(out["jblue"][:, 1].sum()) if njb else 0.0
    ops = (400.0 * nadv + (30.0 if expansion else 20.0) * nwalk + 40.0 * nbfwin
           + (2.0 * nadv + 12.0 * bin_adds) * (nrb > 0)
           + (2.0 * nwalk + 6.0 * jb_passes) * (njb > 0))
    peak = FP64_OPS_PER_S if elem == 8 else FP32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (nbytes,)


def _timing_inputs(sim, tables, t0, t2, want_bfrate, seed, expansion=False, defer=False,
                   dtype=np.float32, **extra):
    lanes, tau, sel = forced_lanes(sim, t0, NPKTS_DEFAULT, seed, dtype)
    args = (12345, lanes, tables, tau, sel, t2, float(sim.grid.tmin),
            float(sim.grid.max_path_step))
    return args, dict(_kernel_kw(sim, want_bfrate, expansion, defer, **extra), max_inner=64,
                      test_mode=False)


def _time_modes(args, kw, modes):
    """CUDA-event means of the kernel in each estimator-row mode (True:
    shared memory, False: global atomics), in turns and then in reverse:
    wrapper-inclusive (events around the wrapper calls), then kernel-only
    (the wrapper's ``propagate.timing`` events right around each ctypes
    call, in a pass of its own, so that their recording is not in the
    first); also returns the last launch's outputs."""
    from artis_tpu_torch.transport import rpkt_kernel

    times = {m: [] for m in modes}
    konly = {m: [] for m in modes}
    for m in modes + modes[::-1]:
        launch = lambda: rpkt_kernel._launch(*args, shared_rows=m, **kw)
        t, out = _timed(launch, 10)
        times[m].append(t)
        rpkt_kernel.propagate.timing = []
        try:
            _timed(launch, 10)
            recs = rpkt_kernel.propagate.timing[1:]  # the 10 timed launches
        finally:
            rpkt_kernel.propagate.timing = None
        konly[m].append(sum(r["kernel_events"][0].elapsed_time(r["kernel_events"][1])
                            for r in recs) / len(recs))
    return times, konly, out


ROW_MODE = {True: "shared", False: "global"}


def _time_config(sim, tables, t0, t2, want_bfrate, label, seed=7, expansion=False,
                 defer=False, f64=False, **extra):
    """Kernel against plain version at N=65536, max_inner=64, Philox draws:
    CUDA-event means in turns, plain, each estimator-row mode the rows
    allow (shared, global), the same in reverse, plain. ``ms`` is the mode
    the wrapper picks (wrapper-inclusive; ``kernel_only_ms`` the same
    launches' kernel alone); ``extra`` the K5-multibin / K5-jblue keywords.
    ``f64``: the double form, on the same lanes and tables in float64, its
    bound counted in 8-byte floats at the float64 peak."""
    from artis_tpu_torch.transport import rpkt_kernel

    if f64:
        tables = {k: v.double() if v.is_floating_point() else v for k, v in tables.items()}
    args, kw = _timing_inputs(sim, tables, t0, t2, want_bfrate, seed, expansion, defer,
                              np.float64 if f64 else np.float32, **extra)
    elem = 8 if f64 else 4
    ncont = sim.dad.nbfcontinua if want_bfrate else 0
    rows_kw = {k: extra[k] for k in ("nradbins", "njblue", "want_gamma", "want_bfheat")
               if k in extra}
    rows = rpkt_kernel.row_bytes(kw["ncells"], kw["ngc"], ncont, elem, **rows_kw)
    modes = [True, False] if rows <= rpkt_kernel.SMEM_LIMIT else [False]
    picked = rpkt_kernel.pick_shared_rows(kw["ncells"], kw["ngc"], ncont, elem, **rows_kw)
    before = dict(rpkt_kernel.propagate.launches)
    run_p = lambda: rpkt_kernel.propagate_reference(*args, **kw)
    p1, _ = _timed(run_p, 1)
    times, konly, out = _time_modes(args, kw, modes)
    p2, _ = _timed(run_p, 1)
    rpkt_kernel.propagate.launches.update(before)
    walk_log = []
    rpkt_kernel.propagate_reference(*args, walk_log=walk_log, **kw)
    # the tables the launch read (with the free-free continuum and no
    # bf-rate rows: no continuum)
    launch_tables = (rpkt_kernel.ff_only_tables(tables, want_bfrate) if extra.get("ff_only")
                     else tables)
    bound, by, nbytes = _bound_ms(out, walk_log, launch_tables, kw, test_mode=False, elem=elem)
    misc = out["misc"].double().cpu().numpy()
    log(f"timing[{label}] (N={NPKTS_DEFAULT}, max_inner=64): "
        + ", ".join(f"kernel with {ROW_MODE[m]} rows "
                    f"{' / '.join(f'{t:.4f}' for t in times[m])} ms (kernel-only "
                    f"{' / '.join(f'{t:.4f}' for t in konly[m])} ms)" for m in modes)
        + f", plain version {p1:.4f} / {p2:.4f} ms, bound {bound:.6f} ms ({by}, {nbytes:.0f} "
        f"bytes); crossings {misc[0]:.0f}, {'bins' if expansion else 'lines'} read "
        f"{misc[6]:.0f}, bf continua "
        f"{misc[7]:.0f}, estimator rows {rows} bytes, the wrapper picks {ROW_MODE[picked]} rows")
    rec = dict(ms=min(times[picked]), kernel_only_ms=min(konly[picked]), plain_ms=min(p1, p2),
               bound_ms=bound, bound_by=by, library_ms=None, rows=ROW_MODE[picked])
    for m in modes:
        rec[f"{ROW_MODE[m]}_rows_ms"] = min(times[m])
    return rec


def phase_kernel_vs_plain(workdir):
    import torch

    from artis_tpu_torch.transport import rpkt_kernel

    rec = {k: {} for k in CONFIGS}
    errs = {k: [] for k in CONFIGS}
    nonzero = {}
    HELD.clear()
    COUNT_HELD.clear()
    t_start = time.time()
    lap = lambda what: log(f"phase 3: {what} at {time.time() - t_start:.1f} s")

    # --- K1: 1D spherical ---
    lap("K1")
    sim = _phase3_sim(workdir, "phase3", default_scene, NPKTS_DEFAULT)
    ctx = sim.update_grid(0)
    tables, tables_ng = _nongrey_tables(sim, ctx)
    # timestep 0 of this scene is grey (every shell thick); the second table
    # set clears the grey flag so the continuum and line walk run too, the
    # third ionises the shells so free-free heating accumulates
    lanes, tau, sel = forced_lanes(sim, float(ctx.ts), NPKTS_DEFAULT, seed=0)
    log(f"phase 3 shapes: N={NPKTS_DEFAULT} ncells={sim.cells.Te.shape[0]} "
        f"nlines={sim.dad.nlines} ncont={sim.dad.nbfcontinua}")
    cases = [(f"{name} max_inner={mi}", lanes, tb, tau, sel, float(ctx.t2), mi)
             for name, tb, mis in (("grey", tables, (1, 4, 64)),
                                   ("nongrey", tables_ng, (1, 4, 64)),
                                   ("ionised", ionised_tables(tables), (4, 64)))
             for mi in mis]
    timing_1d = (tables_ng, float(ctx.ts), float(ctx.t2))
    cases.append(_captured_case(sim, seed=1))
    errs["rpkt_crossing_sph1d"] += _check_cases(sim, cases, nonzero)
    rec["rpkt_crossing_sph1d"] = _time_config(sim, *timing_1d, False, "K1 sph1d")
    # the double form (the redesigned double K1) on the same cases: the
    # non-grey and ionised shells at max_inner 1 and 64, the captured lanes
    f64_cases = [as_f64(c) for c in cases if c[0].split()[0] in ("nongrey", "ionised")
                 and c[-1] in (1, 64)] + [as_f64(cases[-1])]
    errs["rpkt_crossing_sph1d" + F64] += _check_cases(sim, f64_cases, nonzero)
    rec["rpkt_crossing_sph1d" + F64] = _time_config(sim, *timing_1d, False, "K1 sph1d float64",
                                                    f64=True)
    # the free-free continuum of the grey opacity cases 0-3 in K1's kernel:
    # the same lanes on the non-grey and the ionised, denser shells (where
    # free-free absorbs)
    ff_cases = [(f"ff_only {name} max_inner={mi}", lanes, tb, tau, sel, float(ctx.t2), mi)
                for name, tb in (("nongrey", tables_ng), ("dense", dense_tables(tables)))
                for mi in (1, 4, 64)]
    errs["rpkt_crossing_ffonly"] += _check_cases(sim, ff_cases, nonzero, ff_only=True)
    rec["rpkt_crossing_ffonly"] = _time_config(sim, *timing_1d, False, "ff_only sph1d",
                                               ff_only=True)
    errs["rpkt_crossing_ffonly" + F64] += _check_cases(
        sim, [as_f64(c) for c in ff_cases if c[-1] in (1, 64)], nonzero, ff_only=True)
    rec["rpkt_crossing_ffonly" + F64] = _time_config(sim, *timing_1d, False,
                                                     "ff_only sph1d float64", ff_only=True,
                                                     f64=True)
    real = _phase3_sim(workdir, "phase3_real", real_scene, NPKTS_REAL)
    log(f"phase 3 realistic shapes: ncells={real.cells.Te.shape[0]} "
        f"nlines={real.dad.nlines} ncont={real.dad.nbfcontinua}")
    captured = _captured_case(real, seed=2)
    errs["rpkt_crossing_sph1d"] += _check_cases(real, [captured], nonzero)
    # the double K1 on the same lanes: its cell and bf tables staged, its
    # 101,010 lines beyond the double budget in global memory
    errs["rpkt_crossing_sph1d" + F64] += _check_cases(real, [as_f64(captured)], nonzero)
    del captured
    for s in (sim, real):
        s.close()
    del sim, real
    gc.collect()

    # --- K2 + K5-bfrate: the 3D Cartesian grid ---
    lap("K2 + K5-bfrate")
    cart = ("rpkt_crossing_cart3d", "rpkt_crossing_bfrate")
    for name, scene, ncoord in (("1dmodel_50cube", default_scene, 50),
                                ("2dmodel_12cube", model2d_scene, 12)):
        sim = _phase3_sim(workdir, f"phase3_{name}", scene, NPKTS_DEFAULT, "CARTESIAN3D",
                          ncoordgrid_x=ncoord, ncoordgrid_y=ncoord, ncoordgrid_z=ncoord,
                          detailed_bf_estimators_on=True)
        ctx = sim.update_grid(0)
        _, tb = _nongrey_tables(sim, ctx)
        log(f"phase 3 {name}: grid {sim.grid.ncoordgrid} ncells={sim.cells.Te.shape[0]}")
        cases = _cases(name, sim, tb, float(ctx.ts), float(ctx.t2), (1, 4, 64), seed=3)
        e = _check_cases(sim, cases, nonzero, want_bfrate=True)
        for k in cart:
            errs[k] += e
        if name == "1dmodel_50cube":
            e = _check_cases(sim, [as_f64(c) for c in cases if c[-1] in (1, 64)], nonzero,
                             want_bfrate=True)
            for k in cart:
                errs[k + F64] += e
        if name == "1dmodel_50cube":
            # the free-free continuum in the 3D walk (<CART, false, true>),
            # whose bf-rate rows accumulate as in every case
            ff_cases = _cases(f"ff_only {name}", sim, dense_tables(tb), float(ctx.ts),
                              float(ctx.t2), (1, 64), seed=17)
            errs["rpkt_crossing_ffonly"] += _check_cases(sim, ff_cases, nonzero,
                                                         want_bfrate=True, ff_only=True)
            errs["rpkt_crossing_ffonly" + F64] += _check_cases(
                sim, [as_f64(c) for c in ff_cases], nonzero, want_bfrate=True, ff_only=True)
        sim.close()
        del sim
        gc.collect()

    big = _phase3_sim(workdir, "phase3_big", big_scene, NPKTS_REAL, "CARTESIAN3D",
                      detailed_bf_estimators_on=True, multibin_radfield=True)
    ctx = big.update_grid(0)
    tables, tables_ng = _nongrey_tables(big, ctx)
    ncells = big.cells.Te.shape[0]
    rows = rpkt_kernel.row_bytes(ncells, max(big.dad.nbfcontinua_ground, 1),
                                 big.dad.nbfcontinua)
    log(f"phase 3 big scene: grid {big.grid.ncoordgrid} ncells={ncells} "
        f"nlines={big.dad.nlines} ncont={big.dad.nbfcontinua} tau table "
        f"{tables['tau_factor'].numel() * 4} bytes, estimator rows {rows} bytes")
    t0, t2 = float(ctx.ts), float(ctx.t2)
    e = _check_cases(big, _cases("big", big, tables_ng, t0, t2, (1, 64), seed=4), nonzero,
                     want_bfrate=True)
    rec["rpkt_crossing_cart3d"] = _time_config(big, tables_ng, t0, t2, False, "K2 cart3d")
    rec["rpkt_crossing_bfrate"] = _time_config(big, tables_ng, t0, t2, True,
                                               "K5-bfrate cart3d")
    rec["rpkt_crossing_cart3d" + F64] = _time_config(big, tables_ng, t0, t2, False,
                                                     "K2 cart3d float64", f64=True)
    rec["rpkt_crossing_bfrate" + F64] = _time_config(big, tables_ng, t0, t2, True,
                                                     "K5-bfrate cart3d float64", f64=True)
    captured = _captured_case(big, seed=5)
    e += _check_cases(big, [captured], nonzero, want_bfrate=True)
    for k in cart:
        errs[k] += e
    # the double form on the lanes the main path leaves in flight, with the
    # big scene's 101,010 lines
    e = _check_cases(big, [as_f64(captured)], nonzero, want_bfrate=True)
    for k in cart:
        errs[k + F64] += e
    # K4 on the same 16^3 model: its own opacity bins from timestep 1's
    # tables (the captured case ran timestep 0), with bf-rate estimators
    from artis_tpu_torch.transport.expansionopacity import build_expansion_opacities

    ctx1 = big.update_grid(1)
    kappa, _ = build_expansion_opacities(ctx1.tau_sob_factor, big.dad.line_nu, big.cells.rho,
                                         big.cells.TR, ctx1.t_mid)
    tb = dict(_nongrey_tables(big, ctx1)[1], expo_kappa=kappa.float().contiguous())
    lap("K4 on the big model")
    k4 = "rpkt_crossing_expansion"
    expo_cases = _cases("big_expansion", big, tb, float(ctx1.ts), float(ctx1.t2), (1, 64), seed=9)
    errs[k4] += _check_cases(big, expo_cases, nonzero, want_bfrate=True, expansion=True)
    # the double 3D bin walk (the generic body: kilonova_*_3dgrid with
    # expansion opacities at the default float64) on the same cases
    errs[k4 + F64] += _check_cases(big, [as_f64(c) for c in expo_cases], nonzero,
                                   want_bfrate=True, expansion=True, require=True)
    # the NLTE forms of the 3D bin walk: the same cases with the multibin rows
    _check_nlte_forms(big, expo_cases, errs, nonzero, (k4,), want_bfrate=True, expansion=True)
    big.close()
    del big
    gc.collect()

    m32 = _phase3_sim(workdir, "phase3_32cube", model32_scene, NPKTS_DEFAULT, "CARTESIAN3D",
                      detailed_bf_estimators_on=True)
    ctx = m32.update_grid(0)
    ncells = m32.cells.Te.shape[0]
    rows = rpkt_kernel.row_bytes(ncells, max(m32.dad.nbfcontinua_ground, 1),
                                 m32.dad.nbfcontinua)
    log(f"phase 3 32^3 model: ncells={ncells}, estimator rows {rows} bytes")
    if rows <= rpkt_kernel.SMEM_LIMIT:
        raise RuntimeError("the 32^3 model's estimator rows fit shared memory: the "
                           "global-atomics mode is not exercised")
    _, tb = _nongrey_tables(m32, ctx)
    e = _check_cases(m32, _cases("32cube", m32, tb, float(ctx.ts), float(ctx.t2), (1, 16, 64),
                                 seed=6), nonzero, want_bfrate=True)
    for k in cart:
        errs[k] += e
    m32.close()
    del m32
    gc.collect()

    # --- K3: the 2D cylindrical grid ---
    lap("K3")
    cyl = _phase3_sim(workdir, "phase3_cyl", cyl_scene, NPKTS_DEFAULT, "CYLINDRICAL2D",
                      detailed_bf_estimators_on=True, **K5)
    ctx = cyl.update_grid(0)
    _, tb = _nongrey_tables(cyl, ctx)
    log(f"phase 3 cylindrical: grid {cyl.grid.ncoordgrid} ncells={cyl.cells.Te.shape[0]}")
    cases = _cases("cyl2d", cyl, tb, float(ctx.ts), float(ctx.t2), (1, 4, 64), seed=8)
    errs["rpkt_crossing_cyl2d"] += _check_cases(cyl, cases, nonzero, want_bfrate=True)
    lap("the cylinder's NLTE forms")
    # the NLTE forms of the cylindrical line walk (multibin on a cylinder,
    # or nltenebular's LUT-off estimators): the multibin and J_b_lu rows,
    # the float32 form on every lane (where a J_b_lu pass tied with a
    # boundary into an empty cell, rpkt_kernel.moved_to_nothing)
    _check_nlte_forms(cyl, [c for c in cases if c[-1] in (1, 64)], errs, nonzero,
                      ("rpkt_crossing_cyl2d",), f32_lanes=None, want_bfrate=True)
    rec["rpkt_crossing_cyl2d"] = _time_config(cyl, tb, float(ctx.ts), float(ctx.t2), False,
                                              "K3 cyl2d")
    errs["rpkt_crossing_cyl2d" + F64] += _check_cases(
        cyl, [as_f64(c) for c in _cases("cyl2d", cyl, tb, float(ctx.ts), float(ctx.t2), (1, 64),
                                        seed=8)], nonzero, want_bfrate=True)
    rec["rpkt_crossing_cyl2d" + F64] = _time_config(cyl, tb, float(ctx.ts), float(ctx.t2),
                                                    False, "K3 cyl2d float64", f64=True)
    cyl.close()
    del cyl
    gc.collect()
    # the same cylinder with the 101,010-line Fe atom (kilonova_2d_2dgrid_fe)
    lap("K3 on the Fe atom")
    cylfe = _phase3_sim(workdir, "phase3_cyl_fe", cyl_fe_scene, NPKTS_DEFAULT, "CYLINDRICAL2D")
    ctx = cylfe.update_grid(0)
    _, tb = _nongrey_tables(cylfe, ctx)
    log(f"phase 3 cylindrical, Fe atom: grid {cylfe.grid.ncoordgrid} "
        f"ncells={cylfe.cells.Te.shape[0]} nlines={cylfe.dad.nlines}")
    t0, t2 = float(ctx.ts), float(ctx.t2)
    fe_cases = _cases("cyl2d_fe", cylfe, tb, t0, t2, (1, 64), seed=16)
    errs["rpkt_crossing_cyl2d"] += _check_cases(cylfe, fe_cases, nonzero)
    _time_config(cylfe, tb, t0, t2, False, "K3 cyl2d Fe")
    # the double K3 on the 101,010-line list (kilonova_2d_2dgrid_fe_f64):
    # the same cases and the lanes the scene's timestep 0 leaves in flight
    captured = _captured_case(cylfe, seed=18)
    errs["rpkt_crossing_cyl2d"] += _check_cases(cylfe, [captured], nonzero)
    errs["rpkt_crossing_cyl2d" + F64] += _check_cases(
        cylfe, [as_f64(c) for c in fe_cases + [captured]], nonzero, require=True)
    del captured
    cylfe.close()
    del cylfe
    gc.collect()

    # --- K4: binned expansion opacities ---
    lap("K4")
    k4 = "rpkt_crossing_expansion"
    dense = _phase3_sim(workdir, "phase3_expo_dense", expo_dense_scene, NPKTS_DEFAULT,
                        expansionopacities_on=True, multibin_radfield=True)
    ctx = dense.update_grid(0)
    tb = _nongrey_tables(dense, ctx)[1]
    log(f"phase 3 expansion 1D: ncells={dense.cells.Te.shape[0]} kappa table "
        f"{tuple(tb['expo_kappa'].shape)}")
    cases = _cases("expo_dense", dense, tb, float(ctx.ts), float(ctx.t2), (1, 4, 64), seed=10)
    errs[k4] += _check_cases(dense, cases, nonzero, expansion=True)
    errs[k4 + F64] += _check_cases(dense, [as_f64(c) for c in cases if c[-1] in (1, 64)],
                                   nonzero, expansion=True)
    # the double bin walk with the non-relativistic Doppler factors (nu /
    # nu_lo a bin) too
    errs[k4 + F64] += _check_cases(dense, [as_f64(c) for c in cases if c[-1] == 64], nonzero,
                                   expansion=True, relativistic=False)
    # the NLTE forms of the 1D bin walk: the multibin rows
    _check_nlte_forms(dense, [c for c in cases if c[-1] in (1, 64)], errs, nonzero, (k4,),
                      expansion=True)
    dense.close()
    del dense
    gc.collect()
    cylfe = _phase3_sim(workdir, "phase3_expo_cyl", cyl_fe_scene, NPKTS_DEFAULT, "CYLINDRICAL2D",
                        expansionopacities_on=True, multibin_radfield=True)
    ctx = cylfe.update_grid(0)
    tb = _nongrey_tables(cylfe, ctx)[1]
    log(f"phase 3 expansion cylinder: grid {cylfe.grid.ncoordgrid} "
        f"ncells={cylfe.cells.Te.shape[0]} nlines={cylfe.dad.nlines} kappa table "
        f"{tb['expo_kappa'].numel() * 4} bytes, line cumulative "
        f"{ctx.expopac_wcum.numel() * ctx.expopac_wcum.element_size()} bytes")
    t0, t2 = float(ctx.ts), float(ctx.t2)
    cases = _cases("expo_cyl_fe", cylfe, tb, t0, t2, (1, 64), seed=11)
    errs[k4] += _check_cases(cylfe, cases, nonzero, expansion=True)
    # the NLTE forms of the cylindrical bin walk: the multibin rows
    _check_nlte_forms(cylfe, cases, errs, nonzero, (k4,), expansion=True)
    del cases
    rec[k4] = _time_config(cylfe, tb, t0, t2, False, "K4 expansion cyl2d", expansion=True)
    f64_cases = [as_f64(c) for c in _cases("expo_cyl_fe", cylfe, tb, t0, t2, (64,), seed=11)]
    errs[k4 + F64] += _check_cases(cylfe, f64_cases, nonzero, expansion=True)
    errs[k4 + F64] += _check_cases(cylfe, f64_cases, nonzero, expansion=True,
                                   relativistic=False)
    rec[k4 + F64] = _time_config(cylfe, tb, t0, t2, False, "K4 expansion cyl2d float64",
                                 expansion=True, f64=True)
    cylfe.close()
    del cylfe
    gc.collect()

    # --- K6: the deferred events of the classic preset, on its 16^3 model ---
    lap("K6")
    k6 = "rpkt_crossing_deferred"
    cls = _phase3_sim(workdir, "phase3_classic", classic_scene, NPKTS_REAL, "CARTESIAN3D",
                      preset="classic")
    ctx = cls.update_grid(0)
    tb = _nongrey_tables(cls, ctx)[1]
    t0, t2 = float(ctx.ts), float(ctx.t2)
    # the model's own timestep-0 tables (this cold model has almost no free
    # electrons), then the same cells ionised and denser (dense_tables),
    # and the same with every other cell grey at a grey opacity equal to
    # its electron scattering
    from artis_tpu_torch.constants import SIGMA_T

    dense = dense_tables(tb)
    half = torch.arange(tb["thick"].numel(), device=tb["thick"].device) % 2
    halfgrey = dict(dense, thick=half.to(torch.int32),
                    kappagrey=SIGMA_T * dense["nne"] / torch.clamp(dense["rho"], min=1e-30))
    log(f"phase 3 classic: grid {cls.grid.ncoordgrid} ncells={cls.cells.Te.shape[0]} "
        f"nlines={cls.dad.nlines} relativistic={cls.opts.use_relativistic_doppler_shift}")
    lanes, tau, sel = forced_lanes(cls, t0, NPKTS_DEFAULT, seed=12)
    cases = lambda table_sets: [(f"{name} max_inner={mi}", lanes, tables, tau, sel, t2, mi)
                                for name, tables in table_sets for mi in (1, 4, 64)]
    errs[k6] += _check_cases(cls, cases([("classic", tb)]), nonzero, defer=True)
    dense_cases = cases([("classic_dense", dense), ("classic_dense_halfgrey", halfgrey)])
    errs[k6] += _check_cases(cls, dense_cases, nonzero, defer=True, every_kind=True)
    rec[k6] = _time_config(cls, tb, t0, t2, False, "K6 deferred cart3d", defer=True)
    errs[k6 + F64] += _check_cases(cls, [as_f64(c) for c in dense_cases if c[-1] in (1, 64)],
                                   nonzero, defer=True, every_kind=True)
    rec[k6 + F64] = _time_config(cls, tb, t0, t2, False, "K6 deferred cart3d float64",
                                 defer=True, f64=True)
    cls.close()
    del cls
    gc.collect()

    # --- K5-multibin and K5-jblue: the nebular scene's own tables and
    # in-flight lanes, then the default scene with both estimators ---
    lap("K5-multibin and K5-jblue")
    k5 = ("rpkt_crossing_multibin", "rpkt_crossing_jblue")
    neb = _phase3_sim(workdir, "phase3_nebular", nebular_scene, NPKTS_DEFAULT, "CARTESIAN3D",
                      preset="nltenebular", **NEBULAR)
    ctx = neb.update_grid(0)
    tb = _nongrey_tables(neb, ctx)[1]
    t0, t2 = float(ctx.ts), float(ctx.t2)
    nkw = _k5_kw(neb)
    rows = rpkt_kernel.row_bytes(neb.cells.Te.shape[0], max(neb.dad.nbfcontinua_ground, 1),
                                 neb.dad.nbfcontinua, **nkw)
    log(f"phase 3 nebular: grid {neb.grid.ncoordgrid} ncells={neb.cells.Te.shape[0]} "
        f"nlines={neb.dad.nlines} radiation-field bins {nkw['nradbins']}, J_b_lu lines "
        f"{nkw['njblue']}, LUT estimators {nkw['want_gamma']}, estimator rows {rows} bytes")
    cases = _cases("nebular", neb, tb, t0, t2, (1, 4, 64), seed=13)
    e = _check_cases(neb, cases, nonzero, want_bfrate=True, **nkw)
    captured = _captured_case(neb, seed=14)
    e += _check_cases(neb, [captured], nonzero, want_bfrate=True, **nkw)
    for k in k5 + cart:
        errs[k] += e
    e = _check_cases(neb, [as_f64(c) for c in cases if c[-1] in (1, 64)] + [as_f64(captured)],
                     nonzero, want_bfrate=True, **nkw)
    for k in k5 + cart:
        errs[k + F64] += e
    # each estimator alone on the nebular tables (the geometry with bf-rate
    # estimators and without the LUT ones, as the nebular main path), then
    # all of it as the main path launches it
    base = dict(nkw, nradbins=0, njblue=0)
    _time_config(neb, tb, t0, t2, True, "nebular cart3d + bfrate, LUT off", **base)
    rec["rpkt_crossing_multibin"] = _time_config(neb, tb, t0, t2, True, "K5-multibin nebular",
                                                 **_k5_kw(neb, jblue=False))
    rec["rpkt_crossing_jblue"] = _time_config(neb, tb, t0, t2, True, "K5-jblue nebular",
                                              **_k5_kw(neb, multibin=False))
    rec["rpkt_crossing_multibin" + F64] = _time_config(
        neb, tb, t0, t2, True, "K5-multibin nebular float64", f64=True,
        **_k5_kw(neb, jblue=False))
    rec["rpkt_crossing_jblue" + F64] = _time_config(
        neb, tb, t0, t2, True, "K5-jblue nebular float64", f64=True,
        **_k5_kw(neb, multibin=False))
    _time_config(neb, tb, t0, t2, True, "nebular main path (K5-multibin + K5-jblue)", **nkw)
    neb.close()
    del neb
    gc.collect()
    dflt = _phase3_sim(workdir, "phase3_k5_default", default_scene, NPKTS_DEFAULT, **K5)
    ctx = dflt.update_grid(0)
    tb = _nongrey_tables(dflt, ctx)[1]
    cases = _cases("k5_default", dflt, tb, float(ctx.ts), float(ctx.t2), (1, 4, 64), seed=15)
    e = _check_cases(dflt, cases, nonzero, **_k5_kw(dflt))
    errs["rpkt_crossing_sph1d"] += e
    for k in k5:
        errs[k] += e
    e = _check_cases(dflt, [as_f64(cases[-1])], nonzero, **_k5_kw(dflt))
    for k in ("rpkt_crossing_sph1d",) + k5:
        errs[k + F64] += e
    dflt.close()
    del dflt
    gc.collect()

    lap("done")
    # a comparison of estimators that stayed zero on both sides tests nothing
    if not all(nonzero.values()):
        raise RuntimeError(f"an estimator never accumulated in phase 3: {nonzero}")
    # every kernel the dispatcher can launch was held, so that a change to
    # it cannot leave an instantiation unchecked
    missing = rpkt_kernel.dispatchable_kernels() - HELD
    log(f"phase 3 held {len(HELD)} kernels: {json.dumps(sorted(HELD))}")
    log(f"phase 3: comparisons that held J_b_lu near-tie lanes still: {json.dumps(COUNT_HELD)}")
    if missing:
        raise RuntimeError(f"phase 3 held no case of {sorted(missing)}")
    for k in CONFIGS:
        rec[k]["max_abs_err"] = max(errs[k])
    torch.cuda.synchronize()
    return rec


def _run_scene(workdir, name, make_scene, npkts, grid_type, expect, **extra):
    """One end-to-end run through the CLI with the launch counts reset just
    before it; fails unless every configuration in ``expect`` launched.
    Returns its record (``dir``: the run directory)."""
    import torch

    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = os.path.join(workdir, name)
    os.makedirs(d)
    make_scene(d)
    # free earlier phases' simulations (a Simulation holds a reference
    # cycle) so the peak below is this run's own
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    rpkt_kernel.reset_launches()
    rpkt_kernel.propagate.timing = []
    t0 = time.time()
    try:
        with _RunProbe(keep_ts0=name in KEEP_TS0) as probe:
            rc = main_sn3d(cli_args(d, npkts, grid_type, **extra))
            torch.cuda.synchronize()
    finally:
        timing, rpkt_kernel.propagate.timing = rpkt_kernel.propagate.timing, None
    wall = time.time() - t0
    launches = dict(rpkt_kernel.propagate.launches)
    kernels = {k: sorted(v) for k, v in rpkt_kernel.propagate.kernels.items()}
    if rc != 0:
        raise RuntimeError(f"{name}: main_sn3d returned {rc}")
    for k in expect:
        if launches[k] <= 0:
            raise RuntimeError(f"{name}: the main path never launched {k}: {launches}")
    # a run at the preset's transport dtype (float64) launches only double
    # forms, a float32 run none: no demotion either way
    f64_run = "transport_dtype" in extra and extra["transport_dtype"] is None
    other = {k: v for k, v in launches.items() if v and k.endswith(F64) != f64_run}
    if other:
        raise RuntimeError(f"{name}: launched the other precision's kernels {other}")
    tlog = json.load(open(os.path.join(d, "transport_log.json")))
    # a timestep may stop short only at the run's wall budget
    budget = extra.get("transport_wall_budget", -1.0)
    if not tlog or not all(r["completed"] or 0 < budget <= r["seconds"] for r in tlog):
        raise RuntimeError(f"{name}: not every timestep ran to completion: {tlog}")
    files = ["light_curve.out", "spec.out", "deposition.out"] + sorted(
        glob.glob(os.path.join(d, "estimators_*.out")))
    for fname in files:
        path = fname if os.path.isabs(fname) else os.path.join(d, fname)
        if not os.path.exists(path):
            raise RuntimeError(f"{name}: missing output {path}")
        vals = []
        for line in open(path):
            if line.startswith("#"):
                continue
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
        if not vals or not np.all(np.isfinite(vals)):
            raise RuntimeError(f"{name}: non-finite or empty values in {path}")
    if len(glob.glob(os.path.join(d, "estimators_*.out"))) != len(tlog):
        raise RuntimeError(f"{name}: estimator files do not cover every timestep")
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    if not np.any(lc[:, 1] > 0):
        raise RuntimeError(f"{name}: no packet escaped (light curve is zero)")
    steps = sum(r["steps"] for r in tlog)
    secs = sum(r["seconds"] for r in tlog)
    # the timesteps stopped at the wall budget: their steps/s are not
    # comparable with those of timesteps that ran to their end
    stopped = [r["nts"] for r in tlog if not r["completed"]]
    for r in tlog:
        log(f"{name}: timestep {r['nts']}: {r['steps']} rpkt steps in {r['seconds']} s = "
            f"{r['steps'] / max(r['seconds'], 1e-12)} rpkt steps/s ({r['iters']} iterations"
            f"{f', stopped at the {budget} s wall budget' if r['nts'] in stopped else ''}); "
            f"grid update ({r['grid_mode']}) {r['grid_seconds']} s, Spencer-Fano "
            f"{r['sf_solves']} solves in {r['sf_seconds']} s, grid-update peak memory "
            f"{probe.update_peak.get(r['nts'])} bytes")
    # event counters summed over the timesteps, from the run's log
    counters = {}
    for line in open(os.path.join(d, "output_0-0.txt")):
        key, sep, val = line.strip().partition(": ")
        if sep and key.isidentifier() and val.isdigit():
            counters[key] = counters.get(key, 0) + int(val)
    dep = np.loadtxt(os.path.join(d, "deposition.out"), ndmin=2)
    rec = dict(name=name, dir=d, npkts=npkts, launches=launches, kernels=kernels, wall_s=wall,
               steps=steps, transport_s=secs, steps_per_s=steps / max(secs, 1e-12),
               peak_mem_bytes=max([torch.cuda.max_memory_allocated()] + probe.earlier_peaks),
               timesteps=tlog, budget_stopped=stopped, counters=counters,
               gamma_emission_lsun=float(dep[:, 14].sum()),
               gamma_dep_lsun=float(dep[:, 5].sum()), probe=probe)
    log(f"{name}: {npkts} packets, {len(tlog)} timesteps, kernel launches {launches}, "
        f"work-weighted {rec['steps_per_s']} rpkt steps/s, wall {wall:.1f} s, peak memory "
        f"{rec['peak_mem_bytes']} bytes, timesteps stopped at the wall budget {stopped}")
    rec["kernel"] = _kernel_share(name, timing, secs)
    if name in POST_RUN:
        more = POST_RUN[name](rec)
        if isinstance(more, dict):
            rec.update(more)
    # the captured spawn holds the run's tables on the card
    probe.vpkt_spawn = probe.tau_sob_spawn = None
    return rec


class _RunProbe:
    """What an end-to-end run does besides its outputs, recorded by wrapping
    driver and engine functions for the run's length: each grid update's
    peak device memory (the peak counter is reset at each update; the peaks
    before the resets are kept for the run's own); per timestep the
    leptons that reach the non-thermal deposition split and the NT outcome
    counters it bumps, the ionisations its fractions make likely, and
    whether a deposited lepton was left over; each Spencer-Fano solve's
    inputs and outputs, copied to the CPU (the first solve's, for phase 5)
    and its frac_heating range; with ``keep_ts0`` the packets after
    timestep 0; the virtual packets' seconds per timestep (a synchronised
    wall around each spawn), one spawn of timestep ``VPKT_SPAWN_TS`` and the trace's
    ``STATS``, and the run's Stokes totals; the XCOM opacities' non-finite
    count and first call."""

    def __init__(self, keep_ts0=False):
        self.keep_ts0 = keep_ts0

    def __enter__(self):
        import torch

        from artis_tpu_torch import driver, stats
        from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_KPKT, TYPE_MA
        from artis_tpu_torch.plasma import nonthermal
        from artis_tpu_torch.transport import engine, vpkt

        self.update_peak, self.earlier_peaks, self.left_active = {}, [], {}
        self.deposits, self.nt_counts, self.left_over, self.ion_expected = {}, {}, 0, {}
        self.sf_first, self.sf_fh = None, []
        self.nts = None
        # classic_3d / classic_3d_vpkt: the packets after timestep 0; the
        # virtual packets' seconds per timestep, one spawn of timestep
        # VPKT_SPAWN_TS (its sites' inputs and the tables it read) and that
        # timestep's line opacity factors; XCOM: non-finite opacities and
        # the first call
        self.state_ts0, self.vpkt_s, self.vpkt_spawn, self.tau_sob_spawn = None, {}, None, None
        self.xcom_nonfinite, self.xcom_first = 0, None
        vpkt.reset_stats()
        probe = self
        nt_stats = (stats.NT_STAT_TO_IONIZATION, stats.NT_STAT_TO_EXCITATION,
                    stats.NT_STAT_TO_KPKT)
        self._orig = [(driver.Simulation, "update_grid", driver.Simulation.update_grid),
                      (driver.Simulation, "do_timestep", driver.Simulation.do_timestep),
                      (engine, "nt_deposit_split", engine.nt_deposit_split),
                      (nonthermal, "solve_spencerfano_cells", nonthermal.solve_spencerfano_cells),
                      (engine, "vpkt_spawn", engine.vpkt_spawn),
                      (engine, "xcom_photoion_chi", engine.xcom_photoion_chi),
                      (driver.Simulation, "finish", driver.Simulation.finish)]
        upd, step, split, solve, spawn, xcom, fin = (o[2] for o in self._orig)
        self.vspec_total = self.vgrid_total = None

        def update_grid(sim, nts):
            probe.nts = nts
            probe.earlier_peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = upd(sim, nts)
            torch.cuda.synchronize()
            probe.update_peak[nts] = torch.cuda.max_memory_allocated()
            return out

        def do_timestep(sim, nts):
            step(sim, nts)
            st = sim.state
            if probe.keep_ts0 and nts == 0:
                probe.state_ts0 = {f: getattr(st, f).cpu().clone()
                                   for f in st.__dataclass_fields__}
            t2 = float(sim.ts.start[nts] + sim.ts.width[nts])
            act = (st.prop_time < t2) & (st.ptype != TYPE_ESCAPE)
            probe.left_active[nts] = {int(t): int((act & (st.ptype == t)).sum())
                                      for t in torch.unique(st.ptype[act]).tolist()}

        def nt_deposit_split(key, st, est, nt_dep, *a):
            before = est.counters[list(nt_stats)].clone()
            st2, est2 = split(key, st, est, nt_dep, *a)
            n = int(nt_dep.sum())
            after = est2.counters[list(nt_stats)]
            ok = (st2.ptype[nt_dep] == TYPE_MA) | (st2.ptype[nt_dep] == TYPE_KPKT)
            probe.left_over += int((~ok).sum())
            probe.deposits[probe.nts] = probe.deposits.get(probe.nts, 0) + n
            delta = (after - before).cpu().numpy().astype(np.int64)
            probe.nt_counts[probe.nts] = probe.nt_counts.get(probe.nts, 0) + delta
            # the ionisations the split's fractions make likely: the sum of
            # frac_ionization over the deposits outside thick cells
            ctx, grid, cells = a[0], a[1], a[3]
            mgi = torch.clamp(grid.nonemptymgi_of_cell[st.where[nt_dep]], min=0)
            p_ion = torch.where(cells.thick[mgi] == 1, 0.0, ctx.nt_frac_ionization[mgi].double())
            probe.ion_expected[probe.nts] = (probe.ion_expected.get(probe.nts, 0.0)
                                             + float(p_ion.sum()))
            return st2, est2

        def solve_spencerfano_cells(ntd, dad, levelpops, nnion, nne, **kw):
            out = solve(ntd, dad, levelpops, nnion, nne, **kw)
            fh = out["frac_heating"]
            probe.sf_fh.append((float(fh.min()), float(fh.max()),
                                bool(torch.isfinite(fh).all())))
            if probe.sf_first is None:
                cpu = lambda x: x.detach().cpu().clone()
                probe.sf_first = dict(ntd=ntd, nions=int(dad.nions_total), kw=kw,
                                      args=tuple(cpu(x) for x in (levelpops, nnion, nne)),
                                      out={k: cpu(v) for k, v in out.items()})
            return out

        def vpkt_spawn(st, est, ctx, grid, dad, cells, opts, mask, is_scatter, nu_cmf,
                       opacity_case):
            torch.cuda.synchronize()
            t0 = time.time()
            out = spawn(st, est, ctx, grid, dad, cells, opts, mask, is_scatter, nu_cmf,
                        opacity_case)
            torch.cuda.synchronize()
            probe.vpkt_s[probe.nts] = probe.vpkt_s.get(probe.nts, 0.0) + time.time() - t0
            if probe.nts == VPKT_SPAWN_TS:
                probe.tau_sob_spawn = (ctx.tau_sob_factor, ctx.t_mid)
            # one spawn of timestep VPKT_SPAWN_TS, an electron-scattering one
            # if any
            first = probe.vpkt_spawn
            if (probe.nts == VPKT_SPAWN_TS and bool(mask.any())
                    and (first is None or (is_scatter and not first["is_scatter"]))):
                idx = torch.nonzero(mask)[:, 0]
                probe.vpkt_spawn = dict(
                    is_scatter=bool(is_scatter), ctx=ctx, dad=dad, grid=grid, cells=cells,
                    opacity_case=opacity_case, cfg=ctx.vpkt_cfg,
                    sites={k: v[idx].clone() for k, v in (
                        ("pos", st.pos), ("dir", st.dir), ("prop_time", st.prop_time),
                        ("where", st.where), ("nu_cmf", nu_cmf), ("e_cmf", st.e_cmf),
                        ("stokes_qu", st.stokes[:, 1:3]))})
            return out

        def xcom_photoion_chi(*a):
            out = xcom(*a)
            probe.xcom_nonfinite += int((~torch.isfinite(out)).sum())
            if probe.xcom_first is None and out.numel():
                probe.xcom_first = ([x.detach().cpu().clone() for x in a], out.cpu().clone())
            return out

        def finish(sim):
            fin(sim)
            if sim.vpkt_cfg is not None:
                probe.vspec_total = sim._vspec_total.copy()
                probe.vgrid_total = sim._vgrid_total.copy()

        driver.Simulation.finish = finish
        engine.vpkt_spawn = vpkt_spawn
        engine.xcom_photoion_chi = xcom_photoion_chi
        driver.Simulation.update_grid = update_grid
        driver.Simulation.do_timestep = do_timestep
        engine.nt_deposit_split = nt_deposit_split
        nonthermal.solve_spencerfano_cells = solve_spencerfano_cells
        return self

    def __exit__(self, *exc):
        from artis_tpu_torch.transport import vpkt

        for owner, name, fn in self._orig:
            setattr(owner, name, fn)
        self.vpkt_stats = dict(vpkt.STATS)
        return False


def _kernel_share(name, timing, transport_s):
    """Logs and returns what the main path's kernel launches cost
    (``propagate.timing`` records, CUDA events): per configuration the
    launches, summed ms (wrapper-inclusive, and kernel-only: the events
    around the ctypes call) and lane-count range, and the kernel's share of
    the transport seconds."""
    by = {}
    for r in timing:
        ms = r["events"][0].elapsed_time(r["events"][1])
        kms = r["kernel_events"][0].elapsed_time(r["kernel_events"][1])
        for c in r["configs"]:
            b = by.setdefault(c, dict(launches=0, ms=0.0, kernel_only_ms=0.0, lanes_min=r["n"],
                                      lanes_max=r["n"]))
            b["launches"] += 1
            b["ms"] += ms
            b["kernel_only_ms"] += kms
            b["lanes_min"], b["lanes_max"] = min(b["lanes_min"], r["n"]), max(b["lanes_max"],
                                                                             r["n"])
    kernel_ms = sum(r["events"][0].elapsed_time(r["events"][1]) for r in timing)
    kernel_only_ms = sum(r["kernel_events"][0].elapsed_time(r["kernel_events"][1])
                         for r in timing)
    out = dict(launches=len(timing), kernel_ms=kernel_ms, kernel_only_ms=kernel_only_ms,
               lanes_min=min((r["n"] for r in timing), default=0),
               lanes_max=max((r["n"] for r in timing), default=0),
               share=kernel_ms / 1e3 / max(transport_s, 1e-12), configs=by)
    log(f"{name}: kernel {out['launches']} launches, {kernel_ms:.3f} ms summed "
        f"(wrapper-inclusive; kernel-only {kernel_only_ms:.3f} ms), lanes "
        f"{out['lanes_min']}-{out['lanes_max']}, share of the {transport_s:.3f} transport s "
        f"{out['share']:.5f}; per configuration {json.dumps(by)}")
    return out


# the estimator-row sweep: (geometry, make_run keywords, grid type) of
# each scene, cell counts growing from a few hundred bytes of rows to most
# of the 227 KB a block may hold
SWEEP = ([("sph1d", dict(ncells=n, logrho_slope=-0.15 * 15 / (n - 1)), "SPHERICAL1D")
          for n in (64, 256, 512, 1024, 2048)]
         + [("3dmodel", dict(ncells=n, model_dim=3), "CARTESIAN3D") for n in (6, 8, 10, 12)]
         + [("cyl2d", dict(ncells=n, model_dim=2), "CYLINDRICAL2D") for n in (10, 15, 20)])


def rows_sweep(workdir):
    """The kernel with its estimator rows in shared memory against global
    atomics (N=65536, max_inner=64, Philox draws, no bf-rate estimators) on
    each SWEEP scene, timed in turns and then in reverse; logs each point,
    the largest rows at which shared memory won and the smallest at which
    global atomics won (where rpkt_kernel.SHARED_ROWS_MAX belongs)."""
    from artis_tpu_torch.synthdata import make_run
    from artis_tpu_torch.transport import rpkt_kernel

    points = []
    for i, (geo, mk, grid) in enumerate(SWEEP):
        keys = dict(ntimesteps=3, tmin_days=5.0, tmax_days=9.0, ngreyts=1, logrho0=-9.0,
                    logrho_slope=-0.15)
        sim = _phase3_sim(workdir, f"sweep{i}", lambda d: make_run(d, **dict(keys, **mk)),
                          NPKTS_DEFAULT, grid)
        ctx = sim.update_grid(0)
        args, kw = _timing_inputs(sim, _nongrey_tables(sim, ctx)[1], float(ctx.ts),
                                  float(ctx.t2), False, seed=7)
        rows = rpkt_kernel.row_bytes(kw["ncells"], kw["ngc"], 0)
        times, _, out = _time_modes(args, kw, [True, False])
        shared, glob_ = min(times[True]), min(times[False])
        points.append(dict(geometry=geo, ncells=kw["ncells"], rows=rows, shared_ms=shared,
                           global_ms=glob_))
        log(f"sweep[{geo} ncells={kw['ncells']}] rows {rows} bytes: shared "
            f"{' / '.join(f'{t:.4f}' for t in times[True])} ms, global "
            f"{' / '.join(f'{t:.4f}' for t in times[False])} ms, global/shared "
            f"{glob_ / shared:.3f}; crossings {float(out['misc'][0]):.0f}")
        sim.close()
        del sim
        gc.collect()
    won = {m: [p["rows"] for p in points if (p["shared_ms"] < p["global_ms"]) == m]
           for m in (True, False)}
    log(f"sweep: shared rows won up to {max(won[True], default=None)} bytes, global atomics "
        f"from {min(won[False], default=None)} bytes; SHARED_ROWS_MAX is "
        f"{rpkt_kernel.SHARED_ROWS_MAX}")
    log(json.dumps({"rows_sweep": points}))


AB_ROUNDS = 12


def _load_wrapper(root):
    """The crossing kernel's wrapper (transport/rpkt_kernel.py) of another
    checkout of the port at ``root``, loaded beside this one's: it builds
    its own csrc/ into its own _build/, and the helpers it imports are this
    checkout's."""
    import importlib.util

    path = os.path.join(os.path.abspath(root), "artis_tpu_torch", "transport", "rpkt_kernel.py")
    name = f"artis_tpu_torch.transport._ab{len(sys.modules)}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class _EventLib:
    """A wrapper's kernel library (either precision's) whose launches, while
    ``events`` is a list, record a pair of CUDA events right around the
    ctypes call: the kernel's own time, without the wrapper's allocations,
    zero fill and host work."""

    def __init__(self, lib):
        self.lib, self.events = lib, None

    def __getattr__(self, entry):
        fn = getattr(self.lib, entry)

        def launch(*args):
            if self.events is None:
                return fn(*args)
            import torch

            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            err = fn(*args)
            ev[1].record()
            self.events.append(ev)
            return err
        return launch


def _event_libs(mod):
    """Both kernel libraries of a built wrapper as ``_EventLib``s."""
    mod._LIB, mod._LIB64 = _EventLib(mod._LIB), _EventLib(mod._LIB64)


def _kernel_only(mod, fn):
    """The summed kernel-only ms of the launches ``fn`` makes through the
    wrapper ``mod`` (its libraries ``_EventLib``s)."""
    import torch

    events = mod._LIB.events = mod._LIB64.events = []
    try:
        fn()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events)
    finally:
        mod._LIB.events = mod._LIB64.events = None


def _work_per_crossing(misc):
    """Lines (bins) walked and bf continua in windows per crossing, from a
    launch's counters."""
    nadv = max(float(misc[0]), 1.0)
    return float(misc[6]) / nadv, float(misc[7]) / nadv


def _counts(misc, lanes, walked="lines"):
    """The work of one launch or of a sequence of launches on ``lanes``
    lanes in all, from their summed counters: crossing-loop advances and
    cell-boundary crossings per lane, lines (bins) walked and bf continua
    per advance, and the counters past rpkt_kernel.MISC that a measurement
    copy of the kernel may add."""
    from artis_tpu_torch.transport import rpkt_kernel

    n = max(int(lanes), 1)
    walk, bfw = _work_per_crossing(misc)
    own = [float(v) for v in misc[len(rpkt_kernel.MISC):]]
    return (f"lanes {lanes}, advances {float(misc[0]):.0f} ({float(misc[0]) / n:.4f} a lane), "
            f"boundary crossings {float(misc[5]):.0f} ({float(misc[5]) / n:.4f} a lane), "
            f"{walked} walked per advance {walk:.4f}, bf continua per advance {bfw:.4f}"
            + (f", the copy's own counters {own}" if own else ""))


def kernel_ab(workdir, roots):
    """The kernel of this checkout against the kernels of the checkouts at
    ``roots`` on the same inputs (N=65536, max_inner=64, Philox draws, each
    wrapper's own row mode): for each configuration, AB_ROUNDS rounds of a
    10-launch CUDA-event mean of every version (wrapper-inclusive: the
    events around the wrapper calls), in turns, every other round in
    reverse order, then as many rounds of the kernel-only time (the events
    around each ctypes call, ``_EventLib``). Logs every mean and, per
    version, the median and the median ratio to this checkout's kernel
    within a round, each version's ptxas registers and spills, and each
    configuration's lines (bins) walked and bf continua per crossing. A
    version whose wrapper lacks a keyword a configuration needs is left out
    of it. Then the main paths' launches are replayed (``_replay_main_path``).
    First each version's float32 kernels are compared with this checkout's
    in SASS (``_sass_compare``). ``--replays NAME...`` after the roots
    replays only those main paths (REPLAYS), ``--forced LABEL...`` times
    only those forced-lane configurations (AB_SCENES); with either, nothing
    the other does not name."""
    import inspect
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from artis_tpu_torch.transport import rpkt_kernel

    # the roots, then the names after each option
    opts, names, args = {}, None, roots
    roots = []
    for a in args:
        if a.startswith("--"):
            names = opts.setdefault(a, [])
        else:
            (roots if names is None else names).append(a)
    for opt, known in (("--replays", [r[0] for r in REPLAYS]),
                       ("--forced", [sc[0] for sc in AB_SCENES])):
        given = opts.get(opt)
        if given is not None and (not given or set(given) - set(known)):
            raise SystemExit(f"{opt}: unknown {sorted(set(given) - set(known))}; "
                             f"known: {known}")
    if set(opts) - {"--replays", "--forced"}:
        raise SystemExit(f"--kernel-ab: unknown options {sorted(set(opts))}")
    # without either option every forced configuration and every replay;
    # with one or both only the named ones
    only = opts.get("--replays", [] if opts else None)
    forced = opts.get("--forced", [] if opts else None)
    versions = [("this", rpkt_kernel)] + [(r, _load_wrapper(r)) for r in roots]
    _sass_compare(versions, workdir)
    t0 = time.time()
    with ThreadPoolExecutor(len(versions)) as pool:  # one nvcc per version at once
        list(pool.map(lambda v: v[1].build(), versions))
    log(f"ab: built {len(versions)} versions in {time.time() - t0:.2f} s")
    for tag, mod in versions:
        _event_libs(mod)
        _log_ptxas(mod, tag)

    def launcher(mod, args, kw):
        accepted = inspect.signature(mod._launch).parameters
        if any(v for k, v in kw.items() if k not in accepted):
            return None
        kw = {k: v for k, v in kw.items() if k in accepted}
        return lambda: mod._launch(*args, **kw)

    def time_config(label, sim, tables, t0, t2, want_bfrate, f64=False, **extra):
        if f64:  # the double form, on the same lanes and tables in float64
            tables = {k: v.double() if v.is_floating_point() else v for k, v in tables.items()}
        args, kw = _timing_inputs(sim, tables, t0, t2, want_bfrate, seed=7,
                                  dtype=np.float64 if f64 else np.float32, **extra)
        # the forced lanes as drawn (packet order, the main path's) and
        # sorted by (model cell, cursor)
        for order, a in (("packet order", args),
                         ("sorted", _sorted_args(args, sim.grid.nonemptymgi_of_cell))):
            runs = [(tag, mod, launcher(mod, a, kw)) for tag, mod in versions]
            runs = [r for r in runs if r[2] is not None]
            times = {tag: [] for tag, _, _ in runs}
            konly = {tag: [] for tag, _, _ in runs}
            for r in range(AB_ROUNDS):
                for tag, _, fn in (runs if r % 2 == 0 else runs[::-1]):
                    times[tag].append(_timed(fn, 10)[0])
            for r in range(AB_ROUNDS):
                for tag, mod, fn in (runs if r % 2 == 0 else runs[::-1]):
                    konly[tag].append(_kernel_only(mod, lambda: [fn() for _ in range(10)]) / 10)
            base, kbase = np.array(times["this"]), np.array(konly["this"])
            for tag, ts in times.items():
                log(f"ab[{label}, {order}] {tag}: median {np.median(ts):.4f} ms, per round "
                    f"{' '.join(f'{t:.4f}' for t in ts)} ms; median ratio to this "
                    f"{np.median(np.array(ts) / base):.4f}; kernel-only median "
                    f"{np.median(konly[tag]):.4f} ms, ratio to this "
                    f"{np.median(np.array(konly[tag]) / kbase):.4f}")
            if order == "packet order":
                for tag, _, fn in runs:
                    out = fn()
                    log(f"ab[{label}] work[{tag}]: "
                        + _counts(out["misc"].double().cpu().numpy(), out["posx"].shape[0],
                                  "bins" if extra.get("expansion") else "lines"))
            torch.cuda.synchronize()

    for i, (label, sc, configs) in enumerate(AB_SCENES):
        if forced is not None and label not in forced:
            continue
        sim = _phase3_sim(workdir, f"ab{i}", **sc)
        ctx = sim.update_grid(0)
        tb = _nongrey_tables(sim, ctx)[1]
        for extra, bfr in configs:
            extra = _k5_kw(sim) if extra == "k5" else extra
            for f64 in (False, True):
                name = (f"{label}{' float64' if f64 else ''} "
                        f"{' '.join(f'{k}={v}' for k, v in extra.items())}").strip()
                time_config(name, sim, tb, float(ctx.ts), float(ctx.t2), bfr, f64=f64, **extra)
        sim.close()
        del sim
        gc.collect()
    for name, npkts, timesteps in REPLAYS:
        if only is not None and name not in only:
            continue
        sc = {s[0]: s for s in SCENES}[name]
        _replay_main_path(workdir, name, dict(make_scene=uncut(sc[1]), grid_type=sc[3], **sc[5]),
                          versions, launcher, npkts, timesteps)


# the forced-lane configurations of --kernel-ab, each timed in float32 and
# float64: label, scene keywords (_phase3_sim) and (keywords, bf-rate rows)
# of each configuration timed on the scene; the non-relativistic bin walks
# (the classic and nebular presets' Doppler factors) beside kilonova_lte's
# relativistic ones
AB_SCENES = [
    ("K1 sph1d", dict(make_scene=default_scene, npkts=NPKTS_DEFAULT),
     [({}, False), (dict(ff_only=True), False)]),
    ("K3 cyl2d", dict(make_scene=cyl_scene, npkts=NPKTS_DEFAULT,
                      grid_type="CYLINDRICAL2D"), [({}, False)]),
    ("K3 cyl2d Fe", dict(make_scene=cyl_fe_scene, npkts=NPKTS_DEFAULT,
                         grid_type="CYLINDRICAL2D"), [({}, False)]),
    ("K4 expansion sph1d", dict(make_scene=expo_dense_scene, npkts=NPKTS_DEFAULT,
                                expansionopacities_on=True),
     [(dict(expansion=True), False), (dict(expansion=True, relativistic=False), False)]),
    ("K4 expansion cyl2d", dict(make_scene=cyl_fe_scene, npkts=NPKTS_DEFAULT,
                                grid_type="CYLINDRICAL2D", expansionopacities_on=True),
     [(dict(expansion=True), False), (dict(expansion=True, relativistic=False), False)]),
    ("K2 / K6 classic cart3d", dict(make_scene=classic_scene, npkts=NPKTS_REAL,
                                    grid_type="CARTESIAN3D", preset="classic"),
     [({}, False), (dict(defer=True), False)]),
    ("K5 nebular cart3d", dict(make_scene=nebular_scene, npkts=NPKTS_DEFAULT,
                               grid_type="CARTESIAN3D", preset="nltenebular", **NEBULAR),
     [(dict(nradbins=0, njblue=0, want_gamma=True, want_bfheat=True), True),
      ("k5", True)]),
]
# the main paths whose kernel launches --kernel-ab replays: scene (SCENES,
# ``uncut``), packets and timesteps; K1's (the default and 128-shell 1D scenes), K2 /
# K5-bfrate's (the big 3D scene), K3's
# (the cylinder at the synthetic and at the Fe line list), K4's (the
# expansion-opacity cylinder) and the 3D line walk's (nebular, classic_3d);
# then float64 runs at their own packets and timesteps: the double
# 3D line walk's (big_scene_f64: K2 / K5-bfrate, nebular_1d_3dgrid_nont_f64:
# K5-multibin / K5-jblue, classic_3d_f64: K6), the double K3's
# (kilonova_2d_2dgrid_f64), K1's (default_scene_f64, and with the
# free-free continuum default_opacity3_f64) and K4's (the expansion-opacity
# cylinder at float64)
REPLAYS = (("default_scene", NPKTS_DEFAULT, 5), ("realistic_scene", NPKTS_REAL, 2),
           ("big_scene", NPKTS_REAL, 2),
           ("kilonova_2d_2dgrid", NPKTS_2D, 2), ("kilonova_2d_2dgrid_fe", NPKTS_2D, 3),
           ("kilonova_2d_2dgrid_expansionopac", NPKTS_2D, 3),
           ("nebular_1d_3dgrid_nont", NPKTS_REAL, 2), ("classic_3d", NPKTS_REAL, 2),
           ("big_scene_f64", NPKTS_REAL, 2), ("nebular_1d_3dgrid_nont_f64", NPKTS_2D, 1),
           ("classic_3d_f64", NPKTS_2D, 1), ("kilonova_2d_2dgrid_f64", NPKTS_2D, 2),
           ("default_scene_f64", NPKTS_DEFAULT, 5), ("default_opacity3_f64", NPKTS_DEFAULT, 5),
           ("kilonova_2d_2dgrid_expansionopac_f64", NPKTS_2D, 2))


def _sorted_args(args, mgi_of_cell, sort=True):
    """Launch arguments with the lanes (and their injected draws) sorted
    by (model cell, cursor), the order measured against packet order
    (``sort`` False: gathered in their own order, at the same cost but the
    key and the sort)."""
    import torch

    seed, lanes, tables, tau, sel = args[:5]
    if sort:
        key = ((mgi_of_cell[lanes["where"].long()].long() + 1) * 2 ** 32
               + (lanes["next_trans"].long() + 1))
        order = torch.sort(key, stable=True).indices
    else:
        order = torch.arange(tau.numel(), device=tau.device)
    lanes = {k: v[order].contiguous() for k, v in lanes.items()}
    return (seed, lanes, tables, tau[order].contiguous(), sel[order].contiguous()) + args[5:]


def _lane_histogram(ns):
    """{"2^k-2^(k+1)-1": launches} of launch lane counts, by powers of two."""
    hist = {}
    for n in ns:
        k = max(int(n), 1).bit_length() - 1
        key = f"{2 ** k}-{2 ** (k + 1) - 1}"
        hist[key] = hist.get(key, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: int(kv[0].split("-")[0])))


def _replay_main_path(workdir, name, scene_kw, versions, launcher, npkts=NPKTS_REAL,
                      timesteps=2):
    """Runs the first ``timesteps`` timesteps of a scene's main path
    recording the arguments and counters of every kernel launch, then
    replays those launches through each version (``kernel_ab``) in
    AB_ROUNDS alternating rounds, with the lanes in packet order (the main
    path's) and sorted by (model cell, cursor) (the gather of the lanes, and
    the key and sort of the sorted order, timed with the launches):
    CUDA-event ms of the whole sequence (wrapper-inclusive), then as many
    rounds of the launches' summed kernel-only ms (``_EventLib``). Logs the
    launches' lane-count range and histogram, the lines (bins) walked and bf
    continua per crossing of each launch, and per version and order the
    medians, every round, and the share of the recorded run's transport
    seconds."""
    import inspect

    import torch

    from artis_tpu_torch.transport import rpkt_kernel

    sim = _phase3_sim(workdir, f"ab_main_{name}", npkts=npkts, **scene_kw)
    calls, work = [], []
    propagate = rpkt_kernel.propagate

    def record(*args, **kw):
        calls.append((args, kw))
        out = propagate(*args, **kw)
        work.append((args[1]["posx"].shape[0], float(out["misc"][0]), float(out["misc"][5]))
                    + _work_per_crossing(out["misc"].double().cpu().numpy()))
        return out

    record.launches, record.kernels, record.timing = (propagate.launches, propagate.kernels,
                                                      propagate.timing)
    rpkt_kernel.propagate = record
    try:
        for nts in range(timesteps):
            sim.do_timestep(nts)
    finally:
        rpkt_kernel.propagate = propagate
    transport_s = sum(r["seconds"] for r in sim.transport_log)
    mgi_of_cell = sim.grid.nonemptymgi_of_cell
    packet = calls
    sim.close()
    del sim, calls
    gc.collect()
    ns = [a[1]["posx"].shape[0] for a, _ in packet]
    log(f"ab main path[{name}] timesteps 0-{timesteps - 1}: {len(ns)} launches of "
        f"{min(ns)}-{max(ns)} lanes, lane-count histogram {json.dumps(_lane_histogram(ns))}")
    log(f"ab main path[{name}] per launch (lanes, advances, boundary crossings, lines or bins "
        f"walked per advance, bf continua per advance): "
        + " ".join(f"({n}, {c:.0f}, {x:.0f}, {w:.3f}, {b:.3f})" for n, c, x, w, b in work))

    def sequence(mod, sort):
        if any(launcher(mod, args, kw) is None for args, kw in packet):
            return None
        params = inspect.signature(mod._launch).parameters
        seq = [(args, {k: v for k, v in kw.items() if k in params}) for args, kw in packet]

        def run():
            for args, kw in seq:
                mod._launch(*_sorted_args(args, mgi_of_cell, sort), **kw)
        return run

    runs = [(f"{tag}, {'sorted' if sort else 'packet order'}", mod, sequence(mod, sort))
            for tag, mod in versions for sort in (True, False)]
    runs = [r for r in runs if r[2] is not None]
    times = {tag: [] for tag, _, _ in runs}
    konly = {tag: [] for tag, _, _ in runs}
    for r in range(AB_ROUNDS):
        for tag, _, fn in (runs if r % 2 == 0 else runs[::-1]):
            times[tag].append(_timed(fn, 1)[0])
    for r in range(AB_ROUNDS):
        for tag, mod, fn in (runs if r % 2 == 0 else runs[::-1]):
            konly[tag].append(_kernel_only(mod, fn))
    base, kbase = np.array(times[runs[0][0]]), np.array(konly[runs[0][0]])
    for tag, ts in times.items():
        log(f"ab main path[{name}] {tag}: median {np.median(ts):.3f} ms summed, share of the "
            f"{transport_s:.3f} transport s {np.median(ts) / 1e3 / transport_s:.5f}; per round "
            f"{' '.join(f'{t:.3f}' for t in ts)} ms; median ratio to {runs[0][0]} "
            f"{np.median(np.array(ts) / base):.4f}; kernel-only median "
            f"{np.median(konly[tag]):.3f} ms, per round "
            f"{' '.join(f'{t:.3f}' for t in konly[tag])} ms, ratio "
            f"{np.median(np.array(konly[tag]) / kbase):.4f}")
    # each version's counters over the whole sequence, packet order
    walked = "bins" if scene_kw.get("expansionopacities_on") else "lines"
    for tag, mod in versions:
        if sequence(mod, False) is None:
            continue
        params = inspect.signature(mod._launch).parameters
        misc = 0.0
        for args, kw in packet:
            out = mod._launch(*args, **{k: v for k, v in kw.items() if k in params})
            misc = misc + out["misc"].double().cpu().numpy()
        log(f"ab main path[{name}] work[{tag}], summed over the launches: "
            f"{_counts(misc, sum(ns), walked)}")
    del packet
    gc.collect()
    torch.cuda.synchronize()


def _tensor_fields(obj):
    import dataclasses

    import torch

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def _differing(a, b):
    """{field: differing elements} of two dataclasses of tensors, bitwise
    (NaN equal to NaN)."""
    import torch

    out = {}
    for k, x in _tensor_fields(a).items():
        y = getattr(b, k)
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() \
            else x == y
        n = int((~same).sum())
        if n:
            out[k] = n
    return out


def _index_add_probe(fn):
    """Runs ``fn`` with every Tensor.index_add / index_add_ and every
    ``devutil.sorted_index_add_`` (the port's host sums on CUDA) computed
    twice on the same inputs; returns {caller file:line: [calls, calls
    whose two results differ]}, the caller being the first frame outside
    devutil.py."""
    import traceback

    import torch

    from artis_tpu_torch import devutil

    sites = {}

    def count(r1, r2):
        fr = next(fr for fr in reversed(traceback.extract_stack()[:-2])
                  if not fr.filename.endswith("devutil.py"))
        site = sites.setdefault(f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}", [0, 0])
        site[0] += 1
        site[1] += int(not torch.equal(r1, r2))

    orig = {m: getattr(torch.Tensor, m) for m in ("index_add", "index_add_")}
    orig_sorted = devutil.sorted_index_add_

    def wrap(m):
        def f(self, *a, **k):
            r1 = orig["index_add"](self, *a, **k)
            count(r1, orig["index_add"](self, *a, **k))
            return self.copy_(r1) if m == "index_add_" else r1
        return f

    def sorted_twice(x, *a):
        r1 = orig_sorted(x.clone(), *a)
        count(r1, orig_sorted(x.clone(), *a))
        return x.copy_(r1)

    for m in orig:
        setattr(torch.Tensor, m, wrap(m))
    devutil.sorted_index_add_ = sorted_twice
    try:
        fn()
    finally:
        for m, f in orig.items():
            setattr(torch.Tensor, m, f)
        devutil.sorted_index_add_ = orig_sorted
    return sites


# same-seed pairs: the nebular scene (the 3D line walk), and the 1D (K1),
# cylindrical (K3) and expansion-opacity (K4) scenes; timesteps run
REPEAT_SCENES = (("nebular_1d_3dgrid_nont", 4), ("default_scene", 5),
                 ("kilonova_2d_2dgrid", 2), ("kilonova_2d_2dgrid_expansionopac", 3))


def repeat_runs(workdir):
    """Whether same-seed runs repeat on the card. (1) The nebular scene's
    timesteps 0-2 with every scattered host sum computed twice on the same
    inputs (``_index_add_probe``): raises if a site gives two results. (2)
    For each of REPEAT_SCENES two simulations with the same seed, in
    lockstep; after each timestep their rpkt steps, packet states,
    estimators and cells are compared bitwise, and for each rpkt_kernel.ATOMIC_SUMS
    field that differs its largest difference over its largest entry is
    logged (two runs may differ in those from timestep 0 on, ROADMAP Queue
    3, and in everything from timestep 1 on). Raises if timestep 0's
    steps, packet state or cells differ, or an estimator outside
    rpkt_kernel.ATOMIC_SUMS does."""
    from artis_tpu_torch.transport import rpkt_kernel

    table = {sc[0]: sc for sc in SCENES}
    _, make, npkts, grid, _, extra = table["nebular_1d_3dgrid_nont"]
    sim = _phase3_sim(workdir, "repeat_probe", uncut(make), npkts, grid, **extra)
    bad = {}
    for nts in range(3):
        sites = _index_add_probe(lambda: sim.do_timestep(nts))
        log(f"repeat: nebular timestep {nts}: scattered-sum sites [calls, calls with two "
            f"results] {json.dumps(sites)}")
        bad.update({f"ts{nts} {k}": v for k, v in sites.items() if v[1]})
    sim.close()
    del sim
    gc.collect()
    if bad:
        raise RuntimeError(f"scattered host sums give two results on the same inputs: {bad}")
    differing = []
    for name, nsteps in REPEAT_SCENES:
        _, make, npkts, grid, _, extra = table[name]
        sims = [_phase3_sim(workdir, f"repeat_{name}_{i}", uncut(make), npkts, grid, **extra)
                for i in range(2)]
        for nts in range(nsteps):
            for sim in sims:
                sim.do_timestep(nts)
            a, b = sims
            steps = [sim.transport_log[-1]["steps"] for sim in sims]
            diff = {"state": _differing(a.state, b.state), "est": _differing(a.est, b.est),
                    "cells": _differing(a.cells, b.cells)}
            rel = {}
            for k in diff["est"]:
                x, y = getattr(a.est, k).double(), getattr(b.est, k).double()
                rel[k] = float((x - y).abs().max() / x.abs().max().clamp(min=1e-300))
            log(f"repeat[{name}]: timestep {nts} ({a.plasma_mode}): rpkt steps {steps[0]} / "
                f"{steps[1]}, differing elements {json.dumps(diff)}; largest difference over "
                f"largest entry {json.dumps(rel)}")
            if nts == 0 and (steps[0] != steps[1] or diff["state"] or diff["cells"]
                             or set(diff["est"]) - set(rpkt_kernel.ATOMIC_SUMS)):
                differing.append(f"{name} timestep 0: steps {steps}, {diff}")
        for sim in sims:
            sim.close()
        del sims
        gc.collect()
    if differing:
        raise RuntimeError(f"same-seed runs differ beyond the kernel's sums: {differing}")
    log("repeat: timestep 0 repeats bit for bit but for the kernel's sums in every scene")


# the estimators that only the run diagnostics fill
DIAGNOSTIC_FIELDS = ("ion_stats", "line_emisscount", "line_absorbcount", "malog", "malog_n")


def check_diagnostics_observe(workdir):
    """The run diagnostics observe and do not perturb: the default scene's
    timesteps 0-1 without and with ``DIAGNOSTICS``, in lockstep. After each
    timestep the packet states and cells must be bitwise equal, and so
    every estimator but the kernel's float-atomic sums
    (rpkt_kernel.ATOMIC_SUMS, whose adds change order from launch to
    launch) and the diagnostics' own; timestep 1 starts both runs from the
    first run's atomic sums, so that its inputs are the same. The
    diagnostics' counts must equal the counters. Returns the record."""
    from artis_tpu_torch import stats
    from artis_tpu_torch.transport import rpkt_kernel

    sims = [_phase3_sim(workdir, f"observe_{i}", default_scene, NPKTS_DEFAULT, **kw)
            for i, kw in enumerate(({}, DIAGNOSTICS))]
    a, b = sims
    rec = {}
    for nts in range(2):
        if nts:
            b.prev_est = b.prev_est.replace(**{k: getattr(a.prev_est, k)
                                               for k in rpkt_kernel.ATOMIC_SUMS})
        for sim in sims:
            sim.do_timestep(nts)
        diff = {"state": _differing(a.state, b.state), "cells": _differing(a.cells, b.cells),
                "est": {k: n for k, n in _differing(a.est, b.est).items()
                        if k not in DIAGNOSTIC_FIELDS}}
        c = b.est.counters
        counts = dict(emitted=int(b.est.line_emisscount.sum()),
                      deactivation_bb=int(c[stats.MA_STAT_DEACTIVATION_BB]),
                      absorbed=int(b.est.line_absorbcount.sum()),
                      activation_bb=int(c[stats.MA_STAT_ACTIVATION_BB]),
                      malog_rows=int(b.est.malog_n),
                      ion_stats_nonzero=int((b.est.ion_stats != 0).sum()))
        rec[nts] = dict(differing=diff, **counts)
        log(f"observe: timestep {nts} ({a.plasma_mode}): without / with the diagnostics, "
            f"differing elements {json.dumps(diff)}; diagnostics {json.dumps(counts)}")
        if diff["state"] or diff["cells"] or set(diff["est"]) - set(rpkt_kernel.ATOMIC_SUMS):
            raise RuntimeError(f"observe: the diagnostics changed timestep {nts}: {diff}")
        if (counts["emitted"] != counts["deactivation_bb"]
                or counts["absorbed"] != counts["activation_bb"]):
            raise RuntimeError(f"observe: timestep {nts}: line counts {counts} differ from the "
                               f"counters")
    if not rec[1]["emitted"] or not rec[1]["ion_stats_nonzero"]:
        raise RuntimeError(f"observe: the diagnostics recorded nothing: {rec}")
    for sim in sims:
        sim.close()
    del sims, a, b
    gc.collect()
    return rec


# the default scene's 16 shells and atom at 1e4 times its density and
# without its grey timestep: electron scattering and line absorption are
# common there under case 4 (the default scene takes neither in a non-grey
# timestep), and its k-packets and macro-atoms cycle for about a thousand
# iterations of timestep 0, so the runs below stop after OPACITY_CASES_ITERS
# iterations (a count, not a wall budget, so what they cover does not depend
# on the host)
OPACITY_CASES_ITERS = 32


def dense_default_scene(d, opacity_case):
    from artis_tpu_torch.synthdata import make_run

    make_run(d, ncells=16, ntimesteps=2, tmin_days=5.0, tmax_days=9.0, ngreyts=0,
             logrho0=-5.0, logrho_slope=-0.15, opacity_case=opacity_case,
             rho_crit_para=OPACITY3_RHO_CRIT_PARA)


def check_opacity_cases_differ(workdir, npkts=NPKTS_DEFAULT):
    """The free-free continuum and the run diagnostics end to end, where
    they make a difference: timestep 0 of ``dense_default_scene`` through
    ``Simulation.do_timestep``, its transport cut after OPACITY_CASES_ITERS
    iterations, under case 4 without and with ``DIAGNOSTICS`` and under
    case 3 with them. The two case-4 runs must end in bitwise the same
    packet states and cells (the diagnostics observe and do not perturb).
    Case 4 must take electron scatterings and case 3 none, nor a bound-free
    event; both must absorb in lines, and each run's line_absorbcount and
    line_emisscount must equal its bound-bound activation and deactivation
    counters, with the bound-bound terms of ion_stats filled and macro-atom
    log rows. Case 3 launches the kernel with the free-free continuum in
    every launch, case 4 never. Returns the record."""
    import functools

    from artis_tpu_torch import stats
    from artis_tpu_torch.transport import engine, rpkt_kernel

    rec, sims, orig = {}, {}, engine.transport_timestep
    engine.transport_timestep = functools.partial(orig, max_iters=OPACITY_CASES_ITERS)
    try:
        for key, case, extra in (("case4", 4, {}), ("case4_diagnostics", 4, DIAGNOSTICS),
                                 ("case3_diagnostics", 3, DIAGNOSTICS)):
            sim = _phase3_sim(workdir, f"opacity_{key}",
                              functools.partial(dense_default_scene, opacity_case=case), npkts,
                              **extra)
            before = dict(rpkt_kernel.propagate.launches)
            sim.do_timestep(0)
            launched = {k: v - before[k] for k, v in rpkt_kernel.propagate.launches.items()}
            rpkt_kernel.propagate.launches.update(before)
            c, est = sim.est.counters, sim.est
            r = rec[key] = dict(
                escounter=int(c[stats.ESCOUNTER]), k_stat_from_bf=int(c[stats.K_STAT_FROM_BF]),
                activation_bf=int(c[stats.MA_STAT_ACTIVATION_BF]),
                activation_bb=int(c[stats.MA_STAT_ACTIVATION_BB]),
                deactivation_bb=int(c[stats.MA_STAT_DEACTIVATION_BB]),
                ffonly_launches=launched["rpkt_crossing_ffonly"],
                sph1d_launches=launched["rpkt_crossing_sph1d"])
            if extra:
                ist = est.ion_stats.double().sum(dim=(0, 1))
                r.update(absorbed=int(est.line_absorbcount.sum()),
                         emitted=int(est.line_emisscount.sum()), malog_rows=int(est.malog_n),
                         ion_energyin_radexc=float(ist[stats.ION_MACROATOM_ENERGYIN_RADEXC]),
                         ion_boundbound_absorbed=float(ist[stats.ION_BOUNDBOUND_ABSORBED]))
            log(f"opacity cases: {key}, timestep 0 cut after {OPACITY_CASES_ITERS} iterations: "
                f"{json.dumps(r)}")
            sims[key] = sim
    finally:
        engine.transport_timestep = orig
    a, b = sims["case4"], sims["case4_diagnostics"]
    diff = {"state": _differing(a.state, b.state), "cells": _differing(a.cells, b.cells)}
    rec["observe_differing"] = diff
    log(f"opacity cases: case 4 without / with the diagnostics, differing elements "
        f"{json.dumps(diff)}")
    for sim in sims.values():
        sim.close()
    del sims, a, b
    gc.collect()
    c4, c3 = rec["case4_diagnostics"], rec["case3_diagnostics"]
    faults = [msg for msg, bad in (
        ("the diagnostics changed case 4's timestep", diff["state"] or diff["cells"]),
        ("case 4 took no electron scattering", c4["escounter"] <= 0),
        ("case 3 took electron scatterings or bound-free events",
         c3["escounter"] or c3["k_stat_from_bf"] or c3["activation_bf"]),
        ("a case absorbed in no line", c4["activation_bb"] <= 0 or c3["activation_bb"] <= 0),
        ("line counts differ from the counters",
         any(r["absorbed"] != r["activation_bb"] or r["emitted"] != r["deactivation_bb"]
             for r in (c4, c3))),
        ("ion_stats miss the bound-bound absorptions, or the macro-atom log is empty",
         any(r["ion_energyin_radexc"] <= 0 or r["malog_rows"] <= 0 for r in (c4, c3))),
        ("the launches do not follow the case",
         c4["ffonly_launches"] or not 0 < c3["ffonly_launches"] == c3["sph1d_launches"]))
        if bad]
    if faults:
        raise RuntimeError(f"opacity cases: {faults}: {rec}")
    return rec


def check_nebular(rec):
    """What a nebular run must show beyond _run_scene's checks:
    timesteps 2 on (2-3, or 2 alone for the _nont scene since the smoke's
    cut in depth) took the nlte update and the log shows the NLTE outer
    loop's iterations and max fracdiff; nlte_0000.out and
    radfield_0000.out are finite; some NLTE population departs from its
    Boltzmann value by more than 1e-3; the bin and J_b_lu estimators
    accumulated (the run's last checkpoint carries the timestep before its
    last)."""
    d, name = rec["dir"], rec["name"]
    modes = [r["grid_mode"] for r in rec["timesteps"]]
    last = len(modes) - 1
    for r in rec["timesteps"]:
        log(f"{name}: timestep {r['nts']}: grid update ({r['grid_mode']}) "
            f"{r['grid_seconds']} s, NLTE outer iterations {r['nlte_iters']}")
    if len(modes) < 3 or modes != ["first", "lte"] + ["nlte"] * (last - 1):
        raise RuntimeError(f"{name}: grid updates {modes}")
    loop = [line.strip() for line in open(os.path.join(d, "output_0-0.txt"))
            if "NLTE outer loop" in line]
    for line in loop:
        log(f"{name}: {line}")
    if len(loop) != last - 1:
        raise RuntimeError(f"{name}: the log does not show the NLTE outer loop of timesteps "
                           f"2-{last}")
    rows = {}
    for fname in ("nlte_0000.out", "radfield_0000.out"):
        with open(os.path.join(d, fname)) as f:
            f.readline()
            rows[fname] = np.loadtxt(f, ndmin=2)
        if not np.all(np.isfinite(rows[fname])):
            raise RuntimeError(f"{name}: non-finite values in {fname}")
    nl = rows["nlte_0000.out"]
    sel = (nl[:, 0] >= 2) & (nl[:, 5] > 1e-30)
    dep = float(np.max(np.abs(nl[sel, 6] / nl[sel, 5] - 1.0))) if sel.any() else 0.0
    rb = rows["radfield_0000.out"]
    g = np.load(os.path.join(d, f"gridsave_ts{last}.npz"))
    sums = {k: float(g[f"est_{k}"].sum()) for k in ("radfieldbin_count", "radfieldbin_j",
                                                    "jblue_count", "jblue_raw")}
    log(f"{name}: max |n_NLTE / n_LTE - 1| in timesteps 2-{last} {dep}; "
        f"radfield_0000.out contributions {float(rb[rb[:, 2] >= 0, 8].sum())}; timestep-"
        f"{last - 1} estimator sums {sums}")
    if dep <= 1e-3:
        raise RuntimeError(f"{name}: no NLTE population departs from LTE")
    if min(sums.values()) <= 0:
        raise RuntimeError(f"{name}: a bin or J_b_lu estimator is zero {sums}")


def check_nebular_nt(rec):
    """The nebular run with the non-thermal solver: ``check_nebular``, and
    in every timestep the three NT outcome counters sum to the leptons that
    reached the deposition split, none of which stays a deposited packet;
    the leptons that went to ionisation are as many as the split's
    frac_ionization makes likely (within 4 sqrt(n) + 4: with the grid
    update on float64 atomic data, frac_ionization is so small
    here that none may go); timestep 3 solved Spencer-Fano, and
    every solve's frac_heating is finite and in (0, 1] (the scene has no
    grey cell); timesteps 0-1 completed, and a timestep stopped at the wall
    budget left only macro-atoms and packets they made active. Logs each
    update's solves, seconds and peak memory, and the packets each
    timestep left active."""
    name = rec["name"]
    check_nebular(rec)
    probe = rec["probe"]
    for r in rec["timesteps"]:
        left = probe.left_active.get(r["nts"], {})
        log(f"{name}: timestep {r['nts']}: completed {r['completed']} in {r['iters']} iterations "
            f"and {r['seconds']} s; packets still active by type {left}")
    if not all(r["completed"] for r in rec["timesteps"][:2]):
        raise RuntimeError(f"{name}: timesteps 0-1 did not complete")
    from artis_tpu_torch.packets import TYPE_MA

    for nts, left in probe.left_active.items():
        if sum(left.values()) and left.get(TYPE_MA, 0) < 0.9 * sum(left.values()):
            raise RuntimeError(f"{name}: timestep {nts} left other packets than macro-atoms "
                               f"active: {left}")
    for r in rec["timesteps"]:
        nts = r["nts"]
        counts = probe.nt_counts.get(nts, np.zeros(3, np.int64))
        log(f"{name}: timestep {nts}: {probe.deposits.get(nts, 0)} deposited leptons, NT "
            f"outcomes (ionisation, excitation, k-packet) {counts.tolist()}; grid update "
            f"{r['grid_seconds']} s with {r['sf_solves']} Spencer-Fano solves in "
            f"{r['sf_seconds']} s, peak memory {probe.update_peak.get(nts)} bytes")
        if int(counts.sum()) != probe.deposits.get(nts, 0):
            raise RuntimeError(f"{name}: timestep {nts}: NT outcomes {counts.tolist()} do not sum "
                               f"to the {probe.deposits.get(nts, 0)} deposited leptons")
    if probe.left_over:
        raise RuntimeError(f"{name}: {probe.left_over} deposited leptons left the split as such")
    n_ion = sum(int(c[0]) for c in probe.nt_counts.values())
    exp_ion = sum(probe.ion_expected.values())
    solves = [r["sf_solves"] for r in rec["timesteps"]]
    log(f"{name}: {n_ion} leptons to ionisation, {exp_ion} expected from the split's "
        f"frac_ionization; Spencer-Fano solves per timestep {solves}; frac_heating (min, max, "
        f"finite) per solve {probe.sf_fh}")
    if abs(n_ion - exp_ion) > 4.0 * np.sqrt(exp_ion) + 4.0:
        raise RuntimeError(f"{name}: {n_ion} leptons went to ionisation, {exp_ion} expected")
    if solves[3] <= 0 or not probe.sf_fh:
        raise RuntimeError(f"{name}: timestep 3 solved no Spencer-Fano system: {solves}")
    if not all(ok and lo > 0 and hi <= 1 for lo, hi, ok in probe.sf_fh):
        raise RuntimeError(f"{name}: a frac_heating outside (0, 1]: {probe.sf_fh}")


def phase_sf_card_vs_cpu(rec):
    """The scene's first Spencer-Fano solve on the card (its captured
    float64 inputs and outputs) against the same function on the CPU:
    every output at rtol 1e-9. Returns the largest relative difference."""
    import torch

    from artis_tpu_torch.devutil import map_tensors
    from artis_tpu_torch.plasma import nonthermal

    first = rec["probe"].sf_first
    ntd = map_tensors(lambda t: t.cpu(), first["ntd"])

    class _Ions:
        nions_total = first["nions"]

    t0 = time.time()
    out = nonthermal.solve_spencerfano_cells(ntd, _Ions, *first["args"], **first["kw"])
    cpu_s = time.time() - t0
    worst = 0.0
    for k, card in first["out"].items():
        cpu = out[k]
        if card.shape != cpu.shape or card.dtype != torch.float64:
            raise RuntimeError(f"Spencer-Fano card vs CPU: {k} {card.shape} {card.dtype}")
        scale = torch.clamp(cpu.abs(), min=1e-300)
        rel = float(((card - cpu).abs() / scale).max())
        worst = max(worst, rel)
        log(f"Spencer-Fano card vs CPU: {k} {tuple(cpu.shape)} max rel diff {rel}")
        if not torch.allclose(card, cpu, rtol=1e-9, atol=0.0):
            raise RuntimeError(f"Spencer-Fano card vs CPU: {k} differs beyond rtol 1e-9 ({rel})")
    log(f"Spencer-Fano card vs CPU: {first['args'][0].shape[0]} cells, sf_points "
        f"{ntd.sf_points}, {ntd.nshells} shells, {ntd.nexc} excitation transitions; CPU solve "
        f"{cpu_s:.3f} s; worst rel diff {worst}")
    return worst


def check_classic(rec):
    """What the classic run must show beyond _run_scene's checks: the event
    pass counted electron scatterings; timesteps 1-2 took the non-LTE grid
    update and its thermal balance left T_e away from T_J in some cell;
    ``check_polarisation`` holds (the scene is cold: its escaped packets
    may all be unscattered, which ``check_classic_dense`` does not allow).
    Returns the escaped packets that were electron-scattered."""
    d, name = rec["dir"], rec["name"]
    n_es = rec["counters"].get("escounter", 0)
    modes = [r["grid_mode"] for r in rec["timesteps"]]
    log(f"{name}: {n_es} electron scatterings counted by the event pass; grid updates "
        f"{modes}")
    if n_es <= 0:
        raise RuntimeError(f"{name}: the event pass counted no electron scattering")
    if modes[1:] != ["nlte", "nlte"]:
        raise RuntimeError(f"{name}: timesteps 1-2 did not take the nlte update: {modes}")
    te_tj = []
    for nts in (1, 2):
        rows = [line.split() for line in open(os.path.join(d, f"estimators_{nts:04d}.out"))]
        te = np.array([float(r[r.index("Te") + 1]) for r in rows])
        tj = np.array([float(r[r.index("TJ") + 1]) for r in rows])
        te_tj.append(float(np.max(np.abs(te / tj - 1.0))))
    log(f"{name}: max |T_e / T_J - 1| over cells, timesteps 1-2: {te_tj}")
    if max(te_tj) <= 0.0:
        raise RuntimeError(f"{name}: T_e equals T_J in every cell (no thermal balance)")
    return check_polarisation(name, d)


def exspec_input(d, last):
    """A copy of the run directory ``d`` for exspec that holds the
    timesteps the run ran, 0 to ``last``: input.txt's ntimesteps cut to
    them and tmax_days to the end of timestep ``last``, which leaves those
    timesteps' grid as it was (the spectra of the timesteps the run never
    reached are not written). Returns the copy's path."""
    from artis_tpu_torch import options
    from artis_tpu_torch.constants import DAY
    from artis_tpu_torch.io import inputparams

    out = d + "_exspec"
    shutil.copytree(d, out, ignore=shutil.ignore_patterns("*.npz", "artis.pid"))
    path = os.path.join(out, "input.txt")
    p = inputparams.read_parameterfile(path)
    method = options.classic().timestep_size_method
    ts = inputparams.time_init(p.tmin, p.tmax, p.ntimesteps, method)
    tmax_days = float(ts.start[last + 1]) / DAY
    lines, k = open(path).read().splitlines(True), -1
    for i, line in enumerate(lines):
        if line.strip() and not line.strip().startswith("#"):
            k += 1
            if k in (1, 3):
                comment = line[line.index("#"):] if "#" in line else "\n"
                value = (f"{last + 1}" if k == 1 else
                         f"{p.tmin / DAY!r} {tmax_days!r}")
                lines[i] = f"{value}  {comment}"
    open(path, "w").writelines(lines)
    q = inputparams.read_parameterfile(path)
    cut = inputparams.time_init(q.tmin, q.tmax, q.ntimesteps, method)
    if q.ntimesteps != last + 1 or not np.allclose(cut.start[:last + 2], ts.start[:last + 2],
                                                   rtol=1e-12, atol=0.0):
        raise RuntimeError(f"exspec input: the cut timestep grid {cut.start} is not the run's "
                           f"{ts.start}")
    return out


def check_exspec_classic(rec):
    """The port's exspec, through its CLI with its default mode, on a
    classic run (a 3D run with the emission breakdown, so exspec also
    writes the ``mabins`` direction bins, exspec.py:122-125), its input
    cut to the timesteps the run ran (``exspec_input``; the smoke gives it
    classic_3d's timestep 0 at NPKTS_TWIN packets: the direction bins'
    files took 66 s on three timesteps of 2^20 packets, 51.5 s on one):
    spec.out and specpol.out finite, specpol.out's Stokes I is spec.out,
    and every
    direction bin's spectrum is written and finite, their mean spec.out
    within the files' 6 digits."""
    from artis_tpu_torch import options
    from artis_tpu_torch.cli import main_exspec

    name, last = rec["name"], max(r["nts"] for r in rec["timesteps"])
    t0 = time.time()
    d = exspec_input(rec["dir"], last)
    if main_exspec(["--rundir", d, "--preset", "classic"]) != 0:
        raise RuntimeError(f"{name}: exspec failed")
    took = time.time() - t0
    spec = np.loadtxt(os.path.join(d, "spec.out"))
    sp = np.loadtxt(os.path.join(d, "specpol.out"))
    nts = spec.shape[1] - 1
    if sp.shape != (spec.shape[0], 1 + 3 * nts) or not np.all(np.isfinite(sp)):
        raise RuntimeError(f"{name}: specpol.out malformed or not finite {sp.shape}")
    if not np.allclose(sp[1:, 1:1 + nts], spec[1:, 1:], rtol=1e-5, atol=1e-30):
        raise RuntimeError(f"{name}: the Stokes I of specpol.out is not spec.out")
    nbins = options.classic().mabins
    res = [np.loadtxt(os.path.join(d, f"spec_res_{b:02d}.out")) for b in range(nbins)]
    if any(r.shape != spec.shape or not np.all(np.isfinite(r)) for r in res):
        raise RuntimeError(f"{name}: a direction bin's spectrum is malformed or not finite")
    mean = np.mean([r[1:, 1:] for r in res], axis=0)
    scale = float(np.abs(spec[1:, 1:]).max())
    worst = float(np.abs(mean - spec[1:, 1:]).max() / max(scale, 1e-300))
    log(f"{name}: exspec of timesteps 0-{last} ({nts} written) with {nbins} direction bins "
        f"took {took:.1f} s; the direction bins' mean against spec.out, worst difference "
        f"{worst} of the largest bin; specpol Q/U flux sum "
        f"{float(np.abs(sp[1:, 1 + nts:]).sum())}")
    if nts != last + 1 or scale <= 0 or not np.allclose(mean, spec[1:, 1:], rtol=1e-4,
                                                        atol=1e-5 * scale):
        raise RuntimeError(f"{name}: the direction bins' mean is not spec.out ({worst})")
    return took


def check_polarisation(name, d):
    """Every escaped r-packet of a run carries a nonzero Stokes Q or U
    exactly when it was electron-scattered since its last emission (an
    emission resets the Stokes vector and the scattering count, and these
    scenes have no grey cells). Returns how many escaped packets were."""
    from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_RPKT, read_packets_text

    pk = read_packets_text(os.path.join(d, "packets00_0000.out"))
    esc = (pk["ptype"] == TYPE_ESCAPE) & (pk["escape_type"] == TYPE_RPKT)
    pol = (np.abs(pk["stokes"][:, 1:]) > 0).any(axis=1)
    scattered = pk["nscatterings"] > 0
    log(f"{name}: {int(esc.sum())} escaped r-packets, {int((esc & scattered).sum())} scattered "
        f"since their emission, {int((esc & pol).sum())} polarised")
    if np.any(esc & (pol != scattered)):
        raise RuntimeError(f"{name}: an escaped packet's polarisation does not match its "
                           "electron scatterings")
    return int((esc & scattered).sum())


def check_classic_dense(rec):
    """The dense classic run: the event pass counted electron scatterings,
    and some escaped packet was electron-scattered since its emission and
    carries the Q / U that dipole scattering gave it."""
    name, n_es = rec["name"], rec["counters"].get("escounter", 0)
    log(f"{name}: {n_es} electron scatterings counted by the event pass")
    if n_es <= 0:
        raise RuntimeError(f"{name}: the event pass counted no electron scattering")
    if check_polarisation(name, rec["dir"]) <= 0:
        raise RuntimeError(f"{name}: no escaped packet was electron-scattered since its "
                           "emission (its Stokes vector is untested)")


# classic_3d_vpkt: a channel's Stokes I bin may fall below channel 0's by
# this share of it (the closed-form segment tau subtracts two cumulative
# sums, each scaled by nu / (c dnu/dl); tests/test_torch_vpkt.py sees
# 1.9e-8 in float64), and the card's trace of a captured spawn may differ
# from the CPU's by this share of the largest bin (float32 rays)
VPKT_CHANNEL_RTOL = 1e-5
VPKT_CARD_CPU_TOL = 1e-3
# the float32 cumulative line tables are kept if their segment sums stay
# within this of a float64 per-line sum for segment taus in [0.01, 10]
VPKT_F32_TABLE_TOL = 1e-3


def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    import torch

    if a.is_floating_point():
        it = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.contiguous().view(it), b.contiguous().view(it)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _f32_table_error(tau_sob, t_mid, nsamples=4096, maxlen=2048, seed=5):
    """Segment sums of a float32 cumulative line table (vpkt's closed form
    with float32 tables: the difference of two running sums over the
    nu-descending list) against float64 per-line sums, on the card, for
    ``nsamples`` random (cell, first line, length <= maxlen) segments of
    the captured timestep's tau factors: returns (segments with tau in [0.01, 10],
    their largest and median relative error, the share above
    ``VPKT_F32_TABLE_TOL``)."""
    import torch

    g = torch.Generator(device=tau_sob.device).manual_seed(seed)
    ncells, nlines = tau_sob.shape
    maxlen = min(maxlen, nlines)
    cell = torch.randint(0, ncells, (nsamples,), generator=g, device=tau_sob.device)
    length = torch.randint(1, maxlen + 1, (nsamples,), generator=g, device=tau_sob.device)
    j1 = (torch.rand(nsamples, generator=g, device=tau_sob.device)
          * (nlines - length)).long()
    cum32 = torch.cat([torch.zeros((ncells, 1), dtype=torch.float32, device=tau_sob.device),
                       torch.cumsum(tau_sob.float(), dim=1)], dim=1)
    seg32 = (cum32[cell, j1 + length] - cum32[cell, j1]).double() * t_mid
    del cum32
    k = torch.arange(maxlen, device=tau_sob.device)
    cols = torch.clamp(j1[:, None] + k[None, :], max=nlines - 1)
    vals = tau_sob[cell[:, None], cols].double()
    seg64 = torch.where(k[None, :] < length[:, None], vals, torch.zeros_like(vals)).sum(1) * t_mid
    sel = (seg64 >= 0.01) & (seg64 <= 10.0)
    rel = ((seg32 - seg64).abs() / seg64)[sel]
    if rel.numel() == 0:
        return 0, 0.0, 0.0, 0.0
    return (int(sel.sum()), float(rel.max()), float(rel.median()),
            float((rel > VPKT_F32_TABLE_TOL).double().mean()))


def post_vpkt(rec):
    """classic_3d_vpkt, right after its run: the trace's seconds per
    timestep and share of the transport seconds, the rays, crossings per
    ray; the Stokes spectra finite, every observer's I non-zero and every
    exclusion channel's I at least channel 0's in every bin
    (``VPKT_CHANNEL_RTOL``), the maps finite and non-zero; the captured
    spawn of timestep ``VPKT_SPAWN_TS`` traced again on the card and on the CPU from the
    same inputs, the worst difference within ``VPKT_CARD_CPU_TOL`` of the
    largest bin; the float32-table error (``_f32_table_error``). Returns
    the record's additions and drops the probe's references to the run's
    tables."""
    import types

    import torch

    from artis_tpu_torch.devutil import map_tensors
    from artis_tpu_torch.transport import vpkt

    name, probe = rec["name"], rec["probe"]
    out = {}
    per_ts = []
    for r in rec["timesteps"]:
        vs = probe.vpkt_s.get(r["nts"], 0.0)
        per_ts.append(dict(nts=r["nts"], trace_s=vs, transport_s=r["seconds"],
                           share=vs / max(r["seconds"], 1e-12)))
        log(f"{name}: timestep {r['nts']}: virtual packets {vs} s of the {r['seconds']} s of "
            f"transport ({vs / max(r['seconds'], 1e-12)})")
    st = probe.vpkt_stats
    out["vpkt"] = dict(per_timestep=per_ts, sites=st["sites"], rays=st["rays"],
                       crossings=st["crossings"],
                       crossings_per_ray=st["crossings"] / max(st["rays"], 1),
                       peak_mem_bytes=rec["peak_mem_bytes"], ray_chunk=vpkt.RAY_CHUNK)
    log(f"{name}: {st['sites']} spawn sites, {st['rays']} rays traced, {st['crossings']} "
        f"crossings ({out['vpkt']['crossings_per_ray']} per ray, rays traced "
        f"{vpkt.RAY_CHUNK} at most at once); peak memory {rec['peak_mem_bytes']} bytes")
    vs, vg = probe.vspec_total, probe.vgrid_total
    if vs is None:
        raise RuntimeError(f"{name}: the run wrote no virtual spectra")
    bad = int((~np.isfinite(vs)).sum() + (~np.isfinite(vg)).sum())
    if bad:
        raise RuntimeError(f"{name}: {bad} non-finite bins in the virtual spectra or maps")
    tot = vs[..., 0].sum(axis=(2, 3))  # (nobs, nspec)
    log(f"{name}: Stokes I per observer and channel {tot.tolist()}; |Q|, |U| sums "
        f"{float(np.abs(vs[..., 1]).sum())} {float(np.abs(vs[..., 2]).sum())}; map I "
        f"{float(vg[..., 0].sum())}")
    if vs.shape[:2] != (3, 6) or not np.all(tot[:, 0] > 0) or not vg[..., 0].sum() > 0:
        raise RuntimeError(f"{name}: an observer's Stokes I or the map is zero: {tot}")
    low = vs[:, 1:, :, :, 0] - vs[:, :1, :, :, 0]
    worst = float((low / np.maximum(vs[:, :1, :, :, 0], 1e-300)).min())
    log(f"{name}: the lowest channel bin against channel 0, relative: {worst}")
    if worst < -VPKT_CHANNEL_RTOL:
        raise RuntimeError(f"{name}: an exclusion channel's I is below channel 0's ({worst})")
    for fname in ("specpol_virtual.out", "vpkt_grid.out"):
        v = np.loadtxt(os.path.join(rec["dir"], fname), skiprows=1)
        if not np.all(np.isfinite(v)):
            raise RuntimeError(f"{name}: non-finite values in {fname}")
    cap = probe.vpkt_spawn
    if cap is None:
        raise RuntimeError(f"{name}: no spawn captured in timestep {VPKT_SPAWN_TS}")
    sites = cap["sites"]
    n = sites["pos"].shape[0]
    ctx = cap["ctx"]

    def trace(to):
        cfg = cap["cfg"]
        c = types.SimpleNamespace(bf_a=to(ctx.bf_a), bf_dep=to(ctx.bf_dep),
                                  chi_ff_nnionpart=to(ctx.chi_ff_nnionpart))
        shp = (cfg.nobs, int(cfg.vgrid_numin.shape[0]), cfg.vgrid_ny, cfg.vgrid_nz, 3)
        dev = to(sites["pos"]).device
        t0 = time.time()
        v, g = vpkt.trace_vpkts(
            cfg, vpkt.zero_vspectra(cfg, sites["pos"].dtype, dev),
            map_tensors(to, cap["dad"]), map_tensors(to, cap["grid"]),
            map_tensors(to, cap["cells"]), c, to(ctx.vpkt_cum_tau), to(ctx.vpkt_cum_taunu),
            *(to(sites[k]) for k in ("pos", "dir", "prop_time", "where", "nu_cmf", "e_cmf",
                                     "stokes_qu")),
            cap["is_scatter"], torch.ones(n, dtype=torch.bool, device=dev), cap["opacity_case"],
            vgrid_acc=torch.zeros(shp, dtype=sites["pos"].dtype, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return v.double().cpu(), g.double().cpu(), time.time() - t0

    card_v, card_g, card_s = trace(lambda x: x)
    cpu_v, cpu_g, cpu_s = trace(lambda x: x.cpu())
    diff = max(float((card_v - cpu_v).abs().max() / cpu_v.abs().max().clamp(min=1e-300)),
               float((card_g - cpu_g).abs().max() / cpu_g.abs().max().clamp(min=1e-300)))
    tot_diff = float(((card_v[..., 0].sum((2, 3)) - cpu_v[..., 0].sum((2, 3))).abs()
                      / cpu_v[..., 0].sum((2, 3)).abs().clamp(min=1e-300)).max())
    out["vpkt"].update(card_vs_cpu=diff, card_vs_cpu_totals=tot_diff, captured_sites=n,
                       captured_is_scatter=cap["is_scatter"], card_trace_s=card_s,
                       cpu_trace_s=cpu_s)
    log(f"{name}: captured spawn of timestep {VPKT_SPAWN_TS} ({n} sites, electron scattering "
        f"{cap['is_scatter']}): card {card_s:.3f} s, CPU {cpu_s:.3f} s; worst bin difference "
        f"{diff} of the largest bin, worst (observer, channel) I total {tot_diff}; Stokes I "
        f"{float(cpu_v[..., 0].sum())}")
    if not cpu_v[..., 0].sum() > 0 or diff > VPKT_CARD_CPU_TOL:
        raise RuntimeError(f"{name}: the card's trace differs from the CPU's ({diff})")
    tau_sob, t_mid = probe.tau_sob_spawn
    nseg, worst32, med32, over = _f32_table_error(tau_sob, float(t_mid))
    out["vpkt"].update(f32_table_segments=nseg, f32_table_max_rel=worst32,
                       f32_table_median_rel=med32, f32_table_share_over_tol=over)
    log(f"{name}: float32 cumulative line tables against float64 per-line sums, {nseg} "
        f"segments with tau in [0.01, 10] of timestep {VPKT_SPAWN_TS}: max rel {worst32}, "
        f"median {med32}, "
        f"share above {VPKT_F32_TABLE_TOL}: {over}")
    return out


def post_xcom(rec):
    """kilonova_2d_2dgrid_xcomgammaphotoion, right after its run: every
    XCOM opacity of the run finite; every timestep's gamma deposition
    finite, and some positive; the first call's inputs again on the CPU,
    every opacity within rtol 1e-12 of the card's."""
    import torch

    from artis_tpu_torch.transport.engine import xcom_photoion_chi

    name, probe = rec["name"], rec["probe"]
    dep = np.loadtxt(os.path.join(rec["dir"], "deposition.out"), ndmin=2)[:, 5]
    log(f"{name}: {probe.xcom_nonfinite} non-finite XCOM opacities; gamma deposition per "
        f"timestep {dep.tolist()} Lsun")
    if probe.xcom_nonfinite or probe.xcom_first is None:
        raise RuntimeError(f"{name}: non-finite or no XCOM opacities")
    if not np.all(np.isfinite(dep)) or not np.any(dep > 0):
        raise RuntimeError(f"{name}: gamma deposition not finite or zero: {dep}")
    args, card = probe.xcom_first
    cpu = xcom_photoion_chi(*args)
    rel = float(((card - cpu).abs() / cpu.abs().clamp(min=1e-300)).max())
    log(f"{name}: XCOM opacity of {card.numel()} gamma packets, card against CPU: max rel "
        f"{rel} (energies {float(args[4].min()) / 2.41326e20:.4g}-"
        f"{float(args[4].max()) / 2.41326e20:.4g} MeV)")
    if not torch.allclose(card, cpu, rtol=1e-12, atol=0.0):
        raise RuntimeError(f"{name}: the card's XCOM opacity differs from the CPU's ({rel})")
    return dict(xcom=dict(card_vs_cpu=rel, packets=card.numel(), gamma_dep_lsun=dep.tolist()))


def check_vpkt_ts0(classic, vrec):
    """Timestep 0 of the vpkt run is the classic run's: the same rpkt steps
    and every packet field bit for bit (only the kernel's float-atomic
    estimator sums may differ between two runs; the packets do not)."""
    a, b = classic["probe"].state_ts0, vrec["probe"].state_ts0
    sa, sb = classic["timesteps"][0]["steps"], vrec["timesteps"][0]["steps"]
    bad = [f for f in a if not _same_bits(a[f], b[f])]
    log(f"{vrec['name']}: timestep 0 rpkt steps {sb} ({classic['name']} {sa}); packet fields "
        f"that differ from {classic['name']}'s: {bad}")
    if sa != sb or bad:
        raise RuntimeError(f"{vrec['name']}: timestep 0 differs from {classic['name']}'s: "
                           f"steps {sa} {sb}, fields {bad}")


# the runs whose packets after timestep 0 are kept, and what runs right
# after a run (before the next frees its memory)
KEEP_TS0 = {"classic_3d", "classic_3d_vpkt", "classic_3d_f64", "classic_3d_vpkt_f64"}
def _counters_by_timestep(d):
    """{timestep: {counter: value}} from a run's output_0-0.txt."""
    out, cur = {}, None
    for line in open(os.path.join(d, "output_0-0.txt")):
        words = line.split()
        if len(words) == 5 and words[1] == "timestep" and words[3:] == ["event", "counters:"]:
            cur = out.setdefault(int(words[2]), {})
        elif cur is not None and line.startswith("  ") and ": " in line:
            key, val = line.strip().split(": ")
            cur[key] = int(val)
        else:
            cur = None
    return out


def post_opacity3(rec):
    """default_opacity3 (grey opacity case 3, the run diagnostics on,
    through the CLI): timestep 1 has shells on both sides of rho_crit (the
    driver's log line), no electron-scattering or bound-free event was
    taken in any timestep, linestat.out's counts of each timestep equal
    its bound-bound activation and deactivation counters, the macro-atom
    log has rows, and the lockfile is gone."""
    d = rec["dir"]
    above = {}
    for line in open(os.path.join(d, "output_0-0.txt")):
        # "HH:MM:SS timestep N: rho_crit R g/cm^3, K of M cells above it"
        words = line.split()
        if len(words) == 12 and words[3] == "rho_crit" and words[-2:] == ["above", "it"]:
            above[int(words[2].rstrip(":"))] = (float(words[4]), int(words[6]), int(words[8]))
    log(f"default_opacity3: rho_crit and shells above it by timestep {json.dumps(above)}")
    if not 0 < above[1][1] < above[1][2]:
        raise RuntimeError(f"default_opacity3: timestep 1 has shells on one side of rho_crit "
                           f"only: {above[1]}")
    counters = _counters_by_timestep(d)
    rows = open(os.path.join(d, "linestat.out")).read().splitlines()[5:]
    if len(rows) != 2 * len(rec["timesteps"]):
        raise RuntimeError(f"default_opacity3: linestat.out has {len(rows)} count rows")
    lines = {}
    for nts, c in sorted(counters.items()):
        bad = {k: c.get(k, 0) for k in ("escounter", "k_stat_from_bf", "ma_stat_activation_bf")}
        emitted, absorbed = (sum(int(v) for v in rows[2 * nts + i].split()) for i in (0, 1))
        lines[nts] = (emitted, c.get("ma_stat_deactivation_bb", 0), absorbed,
                      c.get("ma_stat_activation_bb", 0))
        if any(bad.values()):
            raise RuntimeError(f"default_opacity3: timestep {nts} took {bad}")
        if emitted != lines[nts][1] or absorbed != lines[nts][3]:
            raise RuntimeError(f"default_opacity3: timestep {nts}: linestat.out counts "
                               f"{lines[nts]} differ from the counters")
    log(f"default_opacity3: (emitted, ma_stat_deactivation_bb, absorbed, "
        f"ma_stat_activation_bb) by timestep {json.dumps(lines)}")
    if not sum(v[0] for v in lines.values()):
        raise RuntimeError("default_opacity3: linestat.out counts no emission")
    malog = open(os.path.join(d, "macroatom_0000.out")).read().splitlines()
    log(f"default_opacity3: macroatom_0000.out has {len(malog) - 1} rows")
    if len(malog) < 2:
        raise RuntimeError("default_opacity3: macroatom_0000.out has no row")
    if os.path.exists(os.path.join(d, "artis.pid")):
        raise RuntimeError("default_opacity3: artis.pid is left after the run")
    return {"opacity3": dict(rho_crit=above, lines=lines, malog_rows=len(malog) - 1)}


def _escaped_by_timestep(d):
    """Per timestep of a run's log: (escaped r-packets so far, escaped cmf
    luminosity of the timestep in Lsun)."""
    out = []
    for line in open(os.path.join(d, "output_0-0.txt")):
        if "escaped rpkts so far" in line:
            n = int(line.split("so far ")[1].split()[0])
            out.append((n, float(line.split("cmf_lum ")[1].split()[0])))
    return out


def _f64_against_f32(name, rec32, rec64, against="float32"):
    """Logs each timestep's escaped cmf luminosity of the float64 run
    ``name`` against its float32 run in the same call (or the run
    ``against`` names), for the timesteps both ran, beside 4/sqrt(n), n the
    packets the float32 run saw escape in that timestep, or the float64 run
    where that ran fewer packets (the same physics at two precisions; the
    float64 run may run more timesteps than its float32 twin;
    tests/test_physics_validation.py's rule; the float64 run's escapes by
    timestep are ``rec64["escaped"]`` where its log does not hold them all).
    Returns the timesteps outside it."""
    a = _escaped_by_timestep(rec32["dir"])
    b = rec64["escaped"] if "escaped" in rec64 else _escaped_by_timestep(rec64["dir"])
    if not a or not b:
        raise RuntimeError(f"{name}: {len(b)} timesteps logged against {len(a)}")
    prev, bad = (0, 0), []
    for ts, ((n32, l32), (n64, l64)) in enumerate(zip(a, b)):
        n = n32 - prev[0] if rec64["npkts"] >= rec32["npkts"] else n64 - prev[1]
        prev = (n32, n64)
        tol = 4.0 / np.sqrt(max(n, 1))
        rel = abs(l64 - l32) / max(abs(l32), 1e-300)
        log(f"{name}: timestep {ts}: escaped cmf luminosity {l64} Lsun against "
            f"{against} {l32} Lsun (rel {rel:.5f}, tol 4/sqrt({n}) = {tol:.5f}); escaped so "
            f"far {n64} against {n32}")
        if n <= 0 or rel > tol:
            bad.append(ts)
    log(f"{name}: wall {rec64['wall_s']:.1f} s against {rec32['wall_s']:.1f} s, "
        f"work-weighted {rec64['steps_per_s']} against {rec32['steps_per_s']} rpkt steps/s "
        f"(the {against} run over {len(a)} timesteps, the float64 run over {len(b)})")
    return bad


def check_f64_default(rec32, rec64):
    """The default scene at the preset's float64 against its float32 run in
    the same call: every timestep's escaped cmf luminosity within
    4/sqrt(n) (``_f64_against_f32``)."""
    bad = _f64_against_f32("default_scene_f64", rec32, rec64)
    if bad:
        raise RuntimeError(f"default_scene_f64: escaped luminosity of timesteps {bad} outside "
                           f"4/sqrt(n) of the float32 run")


def log_f64_twins(runs):
    """The other float64 runs against their float32 twins (the run of the
    same name without ``_f64``): their luminosities are logged beside
    4/sqrt(n) (not a gate: the twins are cut in depth and packets, some
    timesteps stop at a wall budget, and the twins compare the same physics
    through other random draws); each run's own checks (_run_scene) and
    phase 3 hold them."""
    for name64 in runs:
        name32 = name64[:-len(F64)]
        if name64.endswith(F64) and name32 in runs and name64 != "default_scene_f64":
            bad = _f64_against_f32(name64, runs[name32], runs[name64])
            log(f"{name64}: timesteps outside 4/sqrt(n) of the float32 run: {bad}")


# ---------------------------------------------------------------------------
# the mesh: this slice's path (default_scene_f64, timesteps 0-3) through
# cli.main_sn3d --mesh 2, which starts two ranks sharing the one card over
# gloo (32768 packets each), then a one-rank NCCL world

MESH_RANKS = 2
MESH_SCENE = "mesh_default_scene_f64"
# the first run's last timestep, its resume's first; and the run's last
# timestep, the second resume's
MESH_FIRST_LAST_TS = 1
MESH_RESUME_TS = 3


def _held_to(name, got, want, exact=()):
    """Every tensor field of ``want`` against ``got`` ({field: tensor}):
    bitwise, but for the float fields of rpkt_kernel.ATOMIC_SUMS (not
    named in ``exact``), which two runs on the same inputs add in other
    orders: those within rpkt_kernel.atomic_sums_agree. Returns the
    ATOMIC_SUMS fields that are not bitwise equal."""
    from artis_tpu_torch.transport import rpkt_kernel

    loose = []
    for k, w in want.items():
        g = got[k].to(w.device)
        if _same_bits(g, w):
            continue
        if k not in rpkt_kernel.ATOMIC_SUMS or k in exact or not w.is_floating_point():
            raise RuntimeError(f"{name}: {k} differs: {int((g != w).sum())} elements")
        loose.append(k)
        if not rpkt_kernel.atomic_sums_agree(g, w):
            raise RuntimeError(f"{name}: {k} differs beyond rtol {rpkt_kernel.ATOMIC_RTOL_F64}: "
                               f"{float((g - w).abs().max())}")
    return loose


def _ts_records(d):
    """Per timestep of a run directory: its transport_log.json record, the
    escaped count of its log, its event counters, its escaped cmf
    luminosity (light_curve.out's second block, 6 digits) and its
    estimators file."""
    tlog = {r["nts"]: r for r in json.load(open(os.path.join(d, "transport_log.json")))}
    esc = dict(enumerate(_escaped_by_timestep(d)))
    counters = _counters_by_timestep(d)
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    cmf = lc[lc.shape[0] // 2:, 2]
    return {nts: dict(log=r, escaped=esc.get(nts - min(tlog))[0], counters=counters.get(nts),
                      cmf_lum=float(cmf[nts]),
                      estimators=open(os.path.join(d, f"estimators_{nts:04d}.out")).read())
            for nts, r in tlog.items()}


def _mesh_cli_run(d, label, key):
    """``cli.main_sn3d --mesh 2 --device cuda`` on the run directory ``d``
    (the CLI starts the ranks, each on card r % device_count, joined through
    a file store): (its records by timestep, its escapes by timestep, each
    rank's kernel launches from transport_log.json's ``rank_launches``,
    its wall seconds). Raises unless every rank launched ``key`` and no
    other kernel in every timestep."""
    from artis_tpu_torch.cli import main_sn3d

    argv = cli_args(d, NPKTS_DEFAULT, "SPHERICAL1D", **PRESET_DTYPE) + ["--mesh", str(MESH_RANKS)]
    t0 = time.time()
    rc = main_sn3d(argv)
    wall = time.time() - t0
    recs = _ts_records(d)
    per_rank = [0] * MESH_RANKS
    for nts, r in recs.items():
        launched = r["log"]["rank_launches"]
        if rc or len(launched) != MESH_RANKS or any(set(x) != {key} for x in launched):
            raise RuntimeError(f"{MESH_SCENE} {label}: timestep {nts}: rc {rc}, launches by rank "
                               f"{launched}")
        per_rank = [n + x[key] for n, x in zip(per_rank, launched)]
        log(f"{MESH_SCENE} {label}: timestep {nts}: {r['log']['steps']} rpkt steps in "
            f"{r['log']['seconds']} s = {r['log']['steps'] / max(r['log']['seconds'], 1e-12)} "
            f"rpkt steps/s ({r['log']['iters']} iterations, {r['log']['ranks']} ranks, launches "
            f"by rank {launched}); all-reduce {r['log']['allreduce_seconds']} s, all-gather "
            f"{r['log']['allgather_seconds']} s; grid update {r['log']['grid_seconds']} s")
    log(f"{MESH_SCENE} {label}: wall {wall:.1f} s, {key} launches by rank {per_rank}")
    return recs, _escaped_by_timestep(d), per_rank, wall


def _same_timestep(name, a, b):
    """A resumed run's timestep ``b`` against the run's ``a``: rpkt steps,
    iterations, active packets, escapes and event counters equal, the
    estimators file bitwise, the cmf luminosity within the file's 6
    digits."""
    same = {k: a["log"][k] == b["log"][k] for k in ("steps", "iters", "active_start")}
    same.update(escaped=a["escaped"] == b["escaped"], counters=a["counters"] == b["counters"],
                estimators=a["estimators"] == b["estimators"])
    lum_rel = abs(a["cmf_lum"] - b["cmf_lum"]) / max(abs(a["cmf_lum"]), 1e-300)
    log(f"{name}: equal {same}; cmf luminosity {b['cmf_lum']} against {a['cmf_lum']} Lsun (rel "
        f"{lum_rel}, the file's 6 digits)")
    if not all(same.values()) or lum_rel > 1e-5:
        raise RuntimeError(f"{name}: the resume differs: {same}, cmf rel {lum_rel}")


def phase_mesh(workdir, ref):
    """The mesh on the card. (a) ``cli.main_sn3d --mesh 2 --device cuda`` on
    default_scene_f64, as a user runs it: timesteps 0-1; then the run
    continued from its checkpoint of timestep 1 to timestep 3 (input.txt's
    timestep_finish raised); then a copy of it resumed from its checkpoint
    of timestep 3. Every rank of every run launched the double K1 and no
    other kernel in every timestep; the world's escaped cmf luminosity is
    within 4/sqrt(n) of default_scene_f64's (``ref``) in timesteps 0-3;
    timestep 0's all-reduced estimators (the checkpoint of timestep 1)
    equal the two shards run one after another in this process with the
    keys fold_in(key, 0) and fold_in(key, 1) (``_held_to``); each resume
    repeats its first timestep as the run before it did
    (``_same_timestep``). (b) a one-rank NCCL world passed to the
    Simulation as a Mesh, timesteps 0-1, each held to one shard with the
    key fold_in(key, 0) in this process from the same state. Returns the
    kernel records' additions."""
    import torch
    import torch.distributed as dist

    from artis_tpu_torch import rng
    from artis_tpu_torch.devutil import map_tensors
    from artis_tpu_torch.io.inputparams import update_parameterfile
    from artis_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_packets
    from artis_tpu_torch.transport import engine, rpkt_kernel

    t_start = time.time()
    # the ranks' processes share the card with this one: free its cached
    # memory of the earlier phases
    gc.collect()
    torch.cuda.empty_cache()
    key = "rpkt_crossing_sph1d" + F64
    d = os.path.join(workdir, MESH_SCENE)
    os.makedirs(d)
    default_scene(d)
    stop_after(d, MESH_FIRST_LAST_TS)
    rpkt_kernel.reset_launches()
    first, esc_first, launches_first, wall_first = _mesh_cli_run(d, "ts0-1", key)
    g = np.load(os.path.join(d, f"gridsave_ts{MESH_FIRST_LAST_TS}.npz"))
    world_est = {k[len("est_"):]: torch.as_tensor(g[k]) for k in g.files if k.startswith("est_")}
    update_parameterfile(os.path.join(d, "input.txt"), MESH_FIRST_LAST_TS, MESH_RESUME_TS + 1, 1)
    cont, esc_cont, launches_cont, wall_cont = _mesh_cli_run(d, "ts1-3", key)
    shutil.copytree(d, d + "_resume")
    again, _, launches_again, wall_again = _mesh_cli_run(d + "_resume", "ts3", key)
    if rpkt_kernel.propagate.launches[key]:
        raise RuntimeError(f"{MESH_SCENE}: this process launched the kernel during the mesh runs")
    tlog = [first[0]["log"]] + [cont[nts]["log"] for nts in sorted(cont)]
    if not all(r["completed"] for r in tlog):
        raise RuntimeError(f"{MESH_SCENE}: not every timestep completed: {tlog}")
    steps, secs = sum(r["steps"] for r in tlog), sum(r["seconds"] for r in tlog)
    log(f"{MESH_SCENE}: {MESH_RANKS} ranks of {NPKTS_DEFAULT // MESH_RANKS} packets on one card "
        f"(gloo), walls {wall_first:.1f} / {wall_cont:.1f} / {wall_again:.1f} s, "
        f"work-weighted over timesteps 0-3 {steps / max(secs, 1e-12)} rpkt steps/s against "
        f"default_scene_f64's {ref['steps_per_s']}")
    bad = _f64_against_f32(MESH_SCENE, ref, dict(
        dir=d, escaped=esc_first[:1] + esc_cont, npkts=NPKTS_DEFAULT,
        wall_s=wall_first + wall_cont, steps_per_s=steps / max(secs, 1e-12)),
        against="default_scene_f64")
    if bad:
        raise RuntimeError(f"{MESH_SCENE}: escaped luminosity of timesteps {bad} outside "
                           f"4/sqrt(n) of default_scene_f64")
    # timestep 0 against two shards run one after another in this process
    sim = _phase3_sim(workdir, "mesh_shards", default_scene, NPKTS_DEFAULT, **PRESET_DTYPE)
    ctx = sim.update_grid(0)
    summed, nsteps = None, 0
    for r in range(MESH_RANKS):
        fake = Mesh(group=None, rank=r, world=MESH_RANKS, device=sim.device, backend="gloo")
        _, e, _, n = engine.transport_timestep(
            rng.fold_in((sim.seed, 1000), r), shard_packets(sim.state, fake), sim._zero_est(),
            sim.grid, sim.dad, sim.aux, sim.rc, sim.rates, sim.cells, ctx, sim.opts,
            wall_budget=sim.opts.transport_wall_budget, **sim._transport_kwargs(0))
        nsteps += n
        e = _tensor_fields(e)
        summed = e if summed is None else {k: summed[k] + v for k, v in e.items()}
    sim.close()
    loose = _held_to(f"{MESH_SCENE} timestep 0", world_est, summed)
    log(f"{MESH_SCENE}: timestep 0's all-reduced estimators against the {MESH_RANKS} shards "
        f"summed: {tlog[0]['steps']} against {nsteps} rpkt steps; ATOMIC_SUMS fields not "
        f"bitwise (within rtol {rpkt_kernel.ATOMIC_RTOL_F64}): {loose}")
    if tlog[0]["steps"] != nsteps:
        raise RuntimeError(f"{MESH_SCENE}: timestep 0's rpkt steps {tlog[0]['steps']} against "
                           f"the shards' {nsteps}")
    # each resume repeats its first timestep
    _same_timestep(f"{MESH_SCENE}: the run continued from the checkpoint of timestep "
                   f"{MESH_FIRST_LAST_TS}", first[MESH_FIRST_LAST_TS], cont[MESH_FIRST_LAST_TS])
    _same_timestep(f"{MESH_SCENE}: the copy resumed from the checkpoint of timestep "
                   f"{MESH_RESUME_TS}", cont[MESH_RESUME_TS], again[MESH_RESUME_TS])
    rec = dict(launches_mesh_default_scene_f64={"ts0-1": launches_first, "ts1-3": launches_cont,
                                                "ts3": launches_again},
               mesh_allreduce_s=[r["allreduce_seconds"] for r in tlog],
               mesh_allgather_s=[r["allgather_seconds"] for r in tlog])
    # (b) a one-rank NCCL world, in this process
    store = os.path.join(workdir, "nccl_store")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + store, world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda")
        msim = _phase3_sim(workdir, "mesh_nccl", default_scene, NPKTS_DEFAULT, mesh=mesh,
                           **PRESET_DTYPE)
        twin = _phase3_sim(workdir, "mesh_nccl_twin", default_scene, NPKTS_DEFAULT,
                           **PRESET_DTYPE)
        nccl, launched = [], 0
        for nts in range(2):
            # the twin starts the timestep from the mesh run's state
            twin.state, twin.cells, twin.prev_est = (
                map_tensors(torch.clone, x) for x in (msim.state, msim.cells, msim.prev_est))
            # the world's launches alone (the twin's compare)
            rpkt_kernel.reset_launches()
            msim.do_timestep(nts)
            launched += rpkt_kernel.propagate.launches[key]
            tctx = twin.update_grid(nts)
            st, e, _, n = engine.transport_timestep(
                rng.fold_in((twin.seed, 1000 + nts), 0), twin.state, twin._zero_est(),
                twin.grid, twin.dad, twin.aux, twin.rc, twin.rates, twin.cells, tctx,
                twin.opts, wall_budget=twin.opts.transport_wall_budget,
                **twin._transport_kwargs(nts))
            r = msim.transport_log[-1]
            _held_to(f"NCCL world timestep {nts}", _tensor_fields(msim.state),
                     _tensor_fields(st), exact=tuple(_tensor_fields(st)))
            loose = _held_to(f"NCCL world timestep {nts}", _tensor_fields(msim.est),
                             _tensor_fields(e))
            nccl.append(dict(nts=nts, steps=r["steps"], allreduce_s=r["allreduce_seconds"],
                             allgather_s=r["allgather_seconds"]))
            log(f"{MESH_SCENE}: one-rank NCCL world, timestep {nts}: {r['steps']} rpkt steps "
                f"(the shard {n}), packets bitwise, ATOMIC_SUMS fields not bitwise (within rtol "
                f"{rpkt_kernel.ATOMIC_RTOL_F64}): {loose}; all-reduce {r['allreduce_seconds']} s, "
                f"all-gather {r['allgather_seconds']} s")
            if r["steps"] != n:
                raise RuntimeError(f"NCCL world timestep {nts}: {r['steps']} against {n} steps")
        if mesh.backend != "nccl" or launched <= 0:
            raise RuntimeError(f"NCCL world: backend {mesh.backend}, {launched} launches")
        rec["launches_mesh_nccl_world"] = launched
        rec["mesh_nccl"] = nccl
        for s_ in (msim, twin):
            s_.close()
    finally:
        dist.destroy_process_group()
    log(f"{MESH_SCENE}: mesh phase {time.time() - t_start:.1f} s")
    return rec


def post_nebular_nt(rec):
    check_nebular_nt(rec)
    return dict(sf_card_vs_cpu=phase_sf_card_vs_cpu(rec))


def post_nebular_nt_twin(rec):
    """The twin of nebular_1d_3dgrid_f64 at its short wall budget:
    ``check_nebular`` (its timesteps 0-1 may stop at the budget, which
    ``check_nebular_nt`` does not allow), and its first Spencer-Fano solve
    on the card against the CPU."""
    check_nebular(rec)
    return dict(sf_card_vs_cpu=phase_sf_card_vs_cpu(rec))


def post_polarisation(rec):
    """A classic run cut in depth: every escaped packet's Stokes Q / U
    matches its electron scatterings (at this depth none need have been
    scattered)."""
    check_polarisation(rec["name"], rec["dir"])


def post_classic_twin(rec):
    """classic_3d_f64's twin: ``post_polarisation``, then the port's exspec
    on its timestep 0 (``check_exspec_classic``)."""
    post_polarisation(rec)
    return dict(exspec_s=check_exspec_classic(rec))


def post_expansion_bb(rec):
    """Bin events activated the macro-atom on lines of their bins."""
    n_bb = rec["counters"].get("ma_stat_activation_bb", 0)
    log(f"{rec['name']}: {n_bb} macro-atom bound-bound activations")
    if n_bb <= 0:
        raise RuntimeError(f"{rec['name']}: no macro-atom bound-bound activation")


def post_gamma(rec):
    """The analytic schemes resolved gamma packets."""
    log(f"{rec['name']}: gamma emission {rec['gamma_emission_lsun']} Lsun, gamma deposition "
        f"{rec['gamma_dep_lsun']} Lsun (summed over timesteps)")
    if rec["gamma_emission_lsun"] <= 0:
        raise RuntimeError(f"{rec['name']}: no gamma packet was emitted")


# what must hold of a run beyond _run_scene's checks, checked right after it
# (before the next run frees its memory); a dict returned joins its record.
# The float64 runs carry the checks at full depth, each float32 twin those
# that hold at its depth.
POST_RUN = {"default_opacity3": post_opacity3,
            "kilonova_2d_2dgrid_expansionopac": post_expansion_bb,
            "default_scene_barnes_guttman": post_gamma,
            "default_scene_barnes_guttman_f64": post_gamma,
            "nebular_1d_3dgrid_nont_f64": check_nebular,
            "nebular_1d_3dgrid": post_nebular_nt_twin,
            "nebular_1d_3dgrid_f64": post_nebular_nt,
            "classic_3d": post_classic_twin,
            "classic_3d_f64": check_classic,
            "classic_3d_vpkt": post_vpkt,
            "classic_3d_vpkt_f64": post_vpkt,
            "kilonova_2d_2dgrid_xcomgammaphotoion": post_xcom,
            "kilonova_2d_2dgrid_xcomgammaphotoion_f64": post_xcom,
            "classic_dense": post_polarisation,
            "classic_dense_f64": check_classic_dense}


def check_pairs(runs):
    """The checks that hold one run against another of the same call."""
    for f64 in ("", F64):
        if "classic_3d" + f64 in runs and "classic_3d_vpkt" + f64 in runs:
            check_vpkt_ts0(runs["classic_3d" + f64], runs["classic_3d_vpkt" + f64])
    if "default_scene" in runs and "default_scene_f64" in runs:
        check_f64_default(runs["default_scene"], runs["default_scene_f64"])
    log_f64_twins(runs)


# the main-path runs of phase 4: name, scene, packets, grid, the kernel
# configurations the run must launch, and its options; transport_dtype
# None: the preset's own, float64 (the other scenes run float32, OPTS)
CART = ["rpkt_crossing_cart3d"]
PRESET_DTYPE = dict(transport_dtype=None)
EXPANSION = dict(expansionopacities_on=True, rpkt_boundbound_thermalisation_probability=-1.0)
# classic_dense's timestep 0 took 106-180 s to complete (1306 iterations of
# k-packet / macro-atom cycling, host-bound); at this budget the packets
# still cycling go on in timestep 1, whose electron-scattered escapes the
# check needs (timestep 0 scatters few: classic_3d's electron scatterings
# come only in timestep 2). The smoke took 1335.9 s of its 1200 s on a slow
# host with the float64 runs, so the budget makes room for them: 20 s
# until the smoke was cut in depth for the mesh phase (timestep 1 then
# ran 265 iterations and 232 of its 2400 escapes were electron-scattered)
CLASSIC_DENSE_BUDGET_S = 12.0
CLASSIC_DENSE = dict(preset="classic", ncoordgrid_x=8, ncoordgrid_y=8, ncoordgrid_z=8,
                     transport_wall_budget=CLASSIC_DENSE_BUDGET_S)
BARNES_GUTTMAN = dict(particle_thermalisation_scheme="BARNES",
                      gamma_thermalisation_scheme="GUTTMAN")
# The presets' float64 (the ``_f64`` runs) carries the depth and the
# checks. Each float32 twin (the same name without ``_f64``) runs its path
# through the CLI at its cheapest depth: timestep 0 (0-1 where timestep 0
# is grey, 0-3 for the Spencer-Fano solve), NPKTS_TWIN packets, and where
# its float64 run stops at a wall budget, this shorter one
TWIN_BUDGET_S = 6.0
NEBULAR_FIELDS = CART + ["rpkt_crossing_bfrate", "rpkt_crossing_multibin", "rpkt_crossing_jblue"]


def big_scene_ts3(d):
    big_scene(d, ntimesteps=3)


SCENES = [
    ("default_scene", default_scene, NPKTS_DEFAULT, "SPHERICAL1D", ["rpkt_crossing_sph1d"], {}),
    # this slice's path: the default scene at the preset's float64, the
    # double K1
    ("default_scene_f64", default_scene, NPKTS_DEFAULT, "SPHERICAL1D",
     ["rpkt_crossing_sph1d" + F64], PRESET_DTYPE),
    # the default scene under grey opacity case 3 with the run diagnostics:
    # K1 with the free-free continuum
    ("default_opacity3", default_opacity3_scene, NPKTS_DEFAULT, "SPHERICAL1D",
     ["rpkt_crossing_sph1d", "rpkt_crossing_ffonly"], DIAGNOSTICS),
    # the same at the preset's float64: the double ff-only form
    ("default_opacity3_f64", default_opacity3_scene, NPKTS_DEFAULT, "SPHERICAL1D",
     ["rpkt_crossing_sph1d" + F64, "rpkt_crossing_ffonly" + F64],
     dict(PRESET_DTYPE, **DIAGNOSTICS)),
    # the 128-shell / 101,010-line scene: the twin timestep 0 (grey), the
    # preset's float64 timesteps 0-1 at 2^20 packets, the double K1 with
    # the line list in global memory
    ("realistic_scene", upto(real_scene, 0), NPKTS_TWIN, "SPHERICAL1D",
     ["rpkt_crossing_sph1d"], {}),
    ("realistic_scene_f64", upto(real_scene, 1), NPKTS_REAL, "SPHERICAL1D",
     ["rpkt_crossing_sph1d" + F64], PRESET_DTYPE),
    ("kilonova_2d_2dgrid", cyl_scene, NPKTS_2D, "CYLINDRICAL2D", ["rpkt_crossing_cyl2d"], {}),
    ("kilonova_2d_2dgrid_f64", cyl_scene, NPKTS_2D, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d" + F64], PRESET_DTYPE),
    # the big 3D model with bf-rate estimators, timestep 0 (grey): K2 with
    # K5-bfrate, the float64 run at 2^20 packets the double forms
    ("big_scene", upto(big_scene_ts3, 0), NPKTS_TWIN, "CARTESIAN3D",
     CART + ["rpkt_crossing_bfrate"], dict(detailed_bf_estimators_on=True)),
    ("big_scene_f64", upto(big_scene_ts3, 0), NPKTS_REAL, "CARTESIAN3D",
     ["rpkt_crossing_cart3d" + F64, "rpkt_crossing_bfrate" + F64],
     dict(PRESET_DTYPE, detailed_bf_estimators_on=True)),
    # kilonova_2d_2dgrid at the production line list: the 25 x 50 cylinder
    # with the 101,010-line Fe atom, lines walked (no expansion opacities),
    # timesteps 0-1 (0 is grey): K3 on the Fe line list, the float64 run at
    # 2^18 packets the double K3
    ("kilonova_2d_2dgrid_fe", upto(cyl_fe_scene, 1), NPKTS_TWIN, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d"], {}),
    ("kilonova_2d_2dgrid_fe_f64", upto(cyl_fe_scene, 1), NPKTS_2D, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d" + F64], PRESET_DTYPE),
    ("kilonova_2d_2dgrid_expansionopac", upto(cyl_fe_scene, 1), NPKTS_2D, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d", "rpkt_crossing_expansion"], EXPANSION),
    # the same at the preset's float64, timesteps 0-1: the double K4
    ("kilonova_2d_2dgrid_expansionopac_f64", upto(cyl_fe_scene, 1), NPKTS_2D, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d" + F64, "rpkt_crossing_expansion" + F64],
     dict(PRESET_DTYPE, **EXPANSION)),
    # Barnes particle and Guttman gamma thermalisation: the float32 twin
    # timesteps 0-1, the float64 run 0-4
    ("default_scene_barnes_guttman", upto(default_gamma_scene, 1), NPKTS_DEFAULT, "SPHERICAL1D",
     ["rpkt_crossing_sph1d"], BARNES_GUTTMAN),
    ("default_scene_barnes_guttman_f64", default_gamma_scene, NPKTS_DEFAULT, "SPHERICAL1D",
     ["rpkt_crossing_sph1d" + F64], dict(PRESET_DTYPE, **BARNES_GUTTMAN)),
    # nltenebular without the non-thermal solver: the twin timestep 0, the
    # preset's float64 timesteps 0-2 at 2^20 packets, NLTE populations in
    # timestep 2 (at the wall budget): the 3D walk with the multibin and
    # J_b_lu fields, the double forms with 8-byte estimator rows
    ("nebular_1d_3dgrid_nont", upto(nebular_scene, 0), NPKTS_TWIN, "CARTESIAN3D",
     NEBULAR_FIELDS, dict(preset="nltenebular", **NEBULAR)),
    ("nebular_1d_3dgrid_nont_f64", upto(nebular_scene, 2), NPKTS_REAL, "CARTESIAN3D",
     [k + F64 for k in NEBULAR_FIELDS], dict(PRESET_DTYPE, preset="nltenebular", **NEBULAR)),
    # the same with the non-thermal solver (the CI's nebular_1d_3dgrid),
    # timesteps 0-3, the Spencer-Fano solve in 3: the twin at the short
    # budget, the preset's float64 at 2^20 packets
    ("nebular_1d_3dgrid", nebular_nt_scene, NPKTS_TWIN, "CARTESIAN3D", NEBULAR_FIELDS,
     dict(preset="nltenebular", **dict(NEBULAR_NT, transport_wall_budget=TWIN_BUDGET_S))),
    ("nebular_1d_3dgrid_f64", nebular_nt_scene, NPKTS_REAL, "CARTESIAN3D",
     [k + F64 for k in NEBULAR_FIELDS], dict(PRESET_DTYPE, preset="nltenebular", **NEBULAR_NT)),
    # the classic preset on the big model: the twin timestep 0 (then the
    # port's exspec on it), the preset's float64 timesteps 0-2 at 2^20
    # packets with the nlte grid update from timestep 1: K6 and the double K6
    ("classic_3d", upto(classic_scene, 0), NPKTS_TWIN, "CARTESIAN3D",
     CART + ["rpkt_crossing_deferred"], dict(preset="classic")),
    ("classic_3d_f64", classic_scene, NPKTS_REAL, "CARTESIAN3D",
     ["rpkt_crossing_cart3d" + F64, "rpkt_crossing_deferred" + F64],
     dict(PRESET_DTYPE, preset="classic")),
    # classic_3d's scene with virtual packets, timestep VPKT_SPAWN_TS: the
    # twin held to classic_3d's timestep 0, the float64 run at 2^20 to
    # classic_3d_f64's
    ("classic_3d_vpkt", classic_vpkt_scene, NPKTS_TWIN, "CARTESIAN3D",
     CART + ["rpkt_crossing_deferred"], dict(preset="classic", vpkt_on=True)),
    ("classic_3d_vpkt_f64", classic_vpkt_scene, NPKTS_REAL, "CARTESIAN3D",
     ["rpkt_crossing_cart3d" + F64, "rpkt_crossing_deferred" + F64],
     dict(PRESET_DTYPE, preset="classic", vpkt_on=True)),
    # kilonova_2d_2dgrid with XCOM gamma photoionisation, timestep 0
    ("kilonova_2d_2dgrid_xcomgammaphotoion", upto(xcom_scene, 0), NPKTS_TWIN, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d"], dict(use_xcom_gammaphotoion=True)),
    ("kilonova_2d_2dgrid_xcomgammaphotoion_f64", upto(xcom_scene, 0), NPKTS_2D, "CYLINDRICAL2D",
     ["rpkt_crossing_cyl2d" + F64], dict(PRESET_DTYPE, use_xcom_gammaphotoion=True)),
    # the dense classic scene on an 8^3 grid, at few packets: its k-packets
    # and macro-atoms cycle for about 1300 iterations in timestep 0, which
    # stops at a wall budget: the twin timestep 0 at the short budget, the
    # preset's float64 timesteps 0-1 at CLASSIC_DENSE_BUDGET_S each
    ("classic_dense", upto(classic_dense_scene, 0), NPKTS_DENSE, "CARTESIAN3D",
     CART + ["rpkt_crossing_deferred"], dict(CLASSIC_DENSE, transport_wall_budget=TWIN_BUDGET_S)),
    ("classic_dense_f64", classic_dense_scene, NPKTS_DENSE, "CARTESIAN3D",
     ["rpkt_crossing_cart3d" + F64, "rpkt_crossing_deferred" + F64],
     dict(PRESET_DTYPE, **CLASSIC_DENSE)),
]


def _redesigns(kernel):
    """The redesigns (the fields of rpkt_kernel.Redesigns that are on: k1,
    k3, k4, w64) of the code a kernel named by rpkt_kernel.kernel_name
    runs."""
    from artis_tpu_torch.transport import rpkt_kernel

    m = re.fullmatch(r"rpkt_crossing_kernel(_1d)?<(float|double)(?:, GEOM_(\w+), (\w+), (\w+))?>",
                     kernel)
    if m.group(1):  # the float32 1D line walk's kernel of its own
        geom, expansion, nlte = rpkt_kernel.GEOM_SPH, False, False
    else:
        geom = getattr(rpkt_kernel, f"GEOM_{m.group(3)}")
        expansion, nlte = m.group(4) == "true", m.group(5) == "true"
    r = rpkt_kernel.redesigned(geom, expansion, nlte, m.group(2) == "double")
    return [field for field, on in r._asdict().items() if on]


def scene_runs(workdir, names):
    """Runs the named main-path scenes (SCENES) and logs their records
    (``_run_scene``: per-timestep grid-update seconds, wall, peak device
    memory, kernel share); raises on an unknown name."""
    table = {sc[0]: sc for sc in SCENES}
    runs = {}
    for name in names:
        if name == MESH_SCENE:
            # the mesh phase against default_scene_f64's run
            if "default_scene_f64" not in runs:
                runs["default_scene_f64"] = _run_scene(workdir, "default_scene_f64",
                                                       *table["default_scene_f64"][1:5],
                                                       **table["default_scene_f64"][5])
            phase_mesh(workdir, runs["default_scene_f64"])
            continue
        if name not in table:
            raise SystemExit(f"unknown scene {name}; scenes: {sorted(table) + [MESH_SCENE]}")
        _, make, npkts, grid, expect, extra = table[name]
        runs[name] = _run_scene(workdir, name, make, npkts, grid, expect, **extra)
        if name == "default_opacity3":
            check_opacity_cases_differ(workdir)
    check_pairs(runs)


def main():
    if (sys.argv[1:] not in ([], ["--rows-sweep"], ["--repeat"])
            and sys.argv[1:2] not in (["--kernel-ab"], ["--scenes"])):
        raise SystemExit("usage: python3 chip_smoke.py [--rows-sweep | --repeat | "
                         "--kernel-ab ROOT... [--replays NAME...] [--forced LABEL...] | "
                         "--scenes NAME...]")
    card = phase_device()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    if sys.argv[1:]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            phase_build()
            if sys.argv[1] == "--rows-sweep":
                rows_sweep(workdir)
            elif sys.argv[1] == "--repeat":
                repeat_runs(workdir)
            elif sys.argv[1] == "--scenes":
                scene_runs(workdir, sys.argv[2:])
            else:
                kernel_ab(workdir, sys.argv[2:])
        log(f"total {time.time() - t_start:.1f} s")
        log(f"card: {card}")
        return
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        build_s = phase_build()
        rec = phase_kernel_vs_plain(workdir)
        log(f"phase 3 done at {time.time() - t_start:.1f} s")
        runs = {name: _run_scene(workdir, name, make, npkts, grid, expect, **extra)
                for name, make, npkts, grid, expect, extra in SCENES}
        check_pairs(runs)
        check_diagnostics_observe(workdir)
        check_opacity_cases_differ(workdir)
        mesh_rec = phase_mesh(workdir, runs["default_scene_f64"])
    # each configuration's launches come from the run of the main path that
    # drives it: each double form's from its float64 run at the preset's own
    # dtype (the deep run where there is one), each float32 form's from that
    # run's float32 twin
    main_run = {"rpkt_crossing_sph1d": "default_scene", "rpkt_crossing_cart3d": "classic_3d",
                "rpkt_crossing_bfrate": "nebular_1d_3dgrid_nont",
                "rpkt_crossing_cyl2d": "kilonova_2d_2dgrid",
                "rpkt_crossing_expansion": "kilonova_2d_2dgrid_expansionopac",
                "rpkt_crossing_deferred": "classic_3d",
                "rpkt_crossing_multibin": "nebular_1d_3dgrid_nont",
                "rpkt_crossing_jblue": "nebular_1d_3dgrid_nont",
                "rpkt_crossing_ffonly": "default_opacity3"}
    main_run.update({k + F64: v + F64 for k, v in main_run.items()})
    # K2's launches come from the classic run, the main path that launches
    # the cart3d geometry without bf-rate estimators (in the deferred mode);
    # its time is the big scene's in-kernel-scatter mode
    for f64 in ("", F64):
        rec["rpkt_crossing_cart3d" + f64]["note"] = (
            f"ms, plain_ms and bound_ms: the big scene, in-kernel scattering; launches: "
            f"classic_3d{f64}'s, each also a K6 launch")
    # this slice's path on the mesh: the double K1's launches on each rank
    # of the two-rank world and in the one-rank NCCL world, and the
    # collectives' seconds per timestep (rank 0)
    rec["rpkt_crossing_sph1d" + F64].update(mesh_rec)
    # each configuration's launches in the other runs of its precision,
    # beside the main path's
    for key in CONFIGS:
        for name, run in runs.items():
            if (name.endswith(F64) == key.endswith(F64) and name != main_run[key]
                    and run["launches"][key]):
                rec[key][f"launches_{name}"] = run["launches"][key]
    kernels = []
    for key, (label, replaces) in CONFIGS.items():
        r = rec[key]
        ran = runs[main_run[key]]["kernels"].get(key, ())
        kernels.append(dict(name=f"{label} {key}", route="cuda", source=KERNEL_SOURCE,
                            cuda_kernel=" / ".join(ran),
                            redesigns=sorted({t for k in ran for t in _redesigns(k)}),
                            replaces=replaces, launches=runs[main_run[key]]["launches"][key],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], build_s=build_s,
                            **{k: v for k, v in r.items()
                               if k.endswith("rows_ms") or k in ("note", "kernel_only_ms")
                               or k.startswith(("launches_", "mesh_"))}))
    # the virtual packets' trace is torch ops, not a kernel: its numbers
    # beside the kernels'
    for f64 in ("", F64):
        log(f"trace_vpkts{f64}: " + json.dumps(runs["classic_3d_vpkt" + f64]["vpkt"]))
        log(f"xcom{f64}: " + json.dumps(runs["kilonova_2d_2dgrid_xcomgammaphotoion" + f64]["xcom"]))
    log(f"total {time.time() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

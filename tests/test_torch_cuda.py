"""The CUDA r-packet crossing kernel on the card: against its plain version
(every geometry, the bf-rate estimators, both estimator-row modes, the
binned expansion-opacity walk K4, the deferred events of dipole
scattering K6, and the multibin and J_b_lu estimators K5-multibin and
K5-jblue with the LUT estimators off; the 3D line walk with the lanes in
packet order and sorted by cell; the redesigned cylindrical walk K3 on the
25 x 50 cylinder with the synthetic and a Fe atom at lane counts up to
2^18, in both row modes and with grey scatters), on the main path through the CLI, two same-seed runs of a small nebular scene
(timestep 0 bitwise identical but for the sums the kernel adds with float
atomics) and the host sums' CUDA formulation (the same bits on every
call); the Spencer-Fano solve on the card against the CPU in float64,
and a nebular timestep with the non-thermal solver on the card; the
closed-form oracles of tests/test_torch_oracles.py through K1; two
same-seed runs with virtual packets (the same virtual spectra bit for
bit); the XCOM photoelectric opacity on the card against the CPU; and the
double form of every configuration (``transport_dtype="float64"``, the
default) against its plain version in float64 (the redesigned double 1D,
3D and cylindrical line walks and the double bin walk with relativistic
and non-relativistic Doppler factors, the double 1D walk with every subset
of its tables staged and with a line list beyond its staging budget, the
double K3 at 2^18 lanes), a float64 main path that
launches only double forms, and two same-seed float64 runs;
check_kernel on a dense probe whose lanes scatter many times; and the
mesh's collectives (artis_tpu_torch/parallel) with two ranks sharing the
card over gloo and in a one-rank NCCL world, whose timestep 0 equals one
shard run in the test's process.

Every test here needs an NVIDIA GPU and skips where there is none. The file
imports no jax, so it runs where only PyTorch is installed; the
repository's tests/conftest.py configures jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The comparison is rpkt_kernel.check_kernel (compare_outputs on the kernel's
and the plain version's outputs; the estimators of a second launch in which
the few lanes with a differing integer output are held still,
rpkt_kernel.held_lanes), which holds every output:
cell and packet type differ on at most 16 lanes (or 2.5e-4 of them, if
more); every other integer output (activating line, bf continuum, grey flag,
cursor, scatter counts) on >= 99.9% of the agreeing lanes, and every float
output within rel 1e-4 there; prop_time, nu_cmf, e_cmf and position to
rtol 2e-3 on every agreeing lane; J / nuJ / ffheating / crossings cell by
cell to rel 5e-3 and LUT gamma / bf-heating / detailed bf-rate to rel 1e-2
(float32 atomics add in an order that changes from run to run); the
multibin and J_b_lu sums to rel 5e-3 and their counts exactly, apart from
at most 16 segments whose midpoint lies within rounding of a bin edge;
counters within 2% + 3. Both sides draw the same Philox numbers, so what remains is
float32 rounding (CUDA's math functions against torch's)."""

import glob
import os

import numpy as np
import pytest
import torch

from artis_tpu_torch.synthdata import make_run

NPKTS = 4096

# name -> (make_run keywords, Options keywords) of the kernel-check scenes
SCENES = {
    "sph1d": (dict(ncells=8), dict(grid_type="SPHERICAL1D")),
    "1dmodel_3dgrid": (dict(ncells=8), dict(grid_type="CARTESIAN3D", ncoordgrid_x=8,
                                            ncoordgrid_y=8, ncoordgrid_z=8)),
    "2dmodel_3dgrid": (dict(ncells=3, model_dim=2),
                       dict(grid_type="CARTESIAN3D", ncoordgrid_x=12, ncoordgrid_y=12,
                            ncoordgrid_z=12)),
    "3dmodel": (dict(ncells=6, model_dim=3), dict(grid_type="CARTESIAN3D")),
    "cyl2d": (dict(ncells=4, model_dim=2), dict(grid_type="CYLINDRICAL2D")),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _opts(npkts, grid_type="SPHERICAL1D", **kw):
    from artis_tpu_torch.options import GridType, kilonova_lte

    return kilonova_lte(grid_type=GridType[grid_type], npkts=npkts, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=20, **{"transport_dtype": "float32", **kw})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    _need_cuda()
    from artis_tpu_torch.driver import Simulation

    out = {}
    for name, (mk, okw) in SCENES.items():
        d = str(tmp_path_factory.mktemp(f"cuda_{name}"))
        make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0, **mk)
        sim = Simulation(d, _opts(NPKTS, detailed_bf_estimators_on=True, **okw), device="cuda")
        out[name] = (sim, sim.update_grid(0))
    return out


def _forced_lanes(sim, ctx, seed, npkts=NPKTS):
    """In-flight r-packets spread over the grid, with numpy-made draws."""
    from artis_tpu_torch.grid import get_cellindex_from_pos

    rng = np.random.default_rng(seed)
    t0 = float(ctx.ts)
    rmax_t = sim.grid.rmax * t0 / sim.grid.tmin
    u = rng.normal(size=(npkts, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * (rmax_t * rng.uniform(0.05, 0.9, npkts) ** (1 / 3))[:, None]
    cell = get_cellindex_from_pos(sim.grid, torch.as_tensor(pos, device="cuda"),
                                  torch.full((npkts,), t0, dtype=torch.float64, device="cuda"))
    dv = rng.normal(size=(npkts, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(14.2, 15.9, npkts)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda")
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32), device="cuda")
    lanes = dict(posx=f(pos[:, 0]), posy=f(pos[:, 1]), posz=f(pos[:, 2]),
                 dirx=f(dv[:, 0]), diry=f(dv[:, 1]), dirz=f(dv[:, 2]), nu_rf=f(nu),
                 nu_cmf=f(nu * 0.98), e_rf=f(np.ones(npkts)), e_cmf=f(np.full(npkts, 0.98)),
                 prop_time=f(np.full(npkts, t0)), where=cell.to(torch.int32).contiguous(),
                 next_trans=i(np.zeros(npkts)), moving=i(np.ones(npkts)),
                 lane_id=i(np.arange(npkts)))
    return lanes, f(-np.log(rng.uniform(0.05, 0.95, npkts))), f(rng.uniform(0.0, 1.0, npkts))


def _check(sim, ctx, max_inner, test_mode, want_bfrate=True, shared_rows=None,
           expansion=False, defer=False, nradbins=0, njblue=0, lut=True, order="packet",
           n=None, grey=False, ff_only=False, dtype=torch.float32, relativistic=None,
           dense=False, stage=None):
    """Kernel against plain version on the scene's forced lanes (the first
    ``n`` of them where given; more than NPKTS drawn where ``n`` asks for
    them). ``grey``: every other cell thick, at a grey opacity that makes
    thick-cell scatters in the kernel, which turn the lanes' directions.
    ``dense``: the cells ionised at 1e4 K and at 1e2, 1e4 and 1e6 times
    that electron density in turn (electron scattering and free-free take
    the continuum). ``dtype`` float64: the double form, on the same lanes
    and tables in float64 (the tolerances of rpkt_kernel.TOL_F64).
    ``relativistic`` overrides the scene's Doppler factors; ``stage`` forces
    the table groups a 1D line walk stages (rpkt_kernel.STAGE_*)."""
    from artis_tpu_torch.transport import rpkt_kernel

    dad = sim.dad
    lanes, tau, sel = _forced_lanes(sim, ctx, seed=max_inner, npkts=max(n or 0, NPKTS))
    lanes = {k: v.to(dtype) if v.is_floating_point() else v for k, v in lanes.items()}
    tau, sel = tau.to(dtype), sel.to(dtype)
    if n is not None:
        lanes = {k: v[:n].contiguous() for k, v in lanes.items()}
        tau, sel = tau[:n].contiguous(), sel[:n].contiguous()
    if order == "sorted":  # the main path's order (engine.rpkt_lanes)
        key = ((sim.grid.nonemptymgi_of_cell[lanes["where"].long()].long() + 1) * 2 ** 32
               + lanes["next_trans"].long() + 1)
        perm = torch.sort(key, stable=True).indices
        lanes = {k: v[perm].contiguous() for k, v in lanes.items()}
        tau, sel = tau[perm].contiguous(), sel[perm].contiguous()
    tables = rpkt_kernel.kernel_tables(dad, sim.grid, sim.cells, ctx, dtype)
    # timestep 0 of these scenes is not grey; clear the flag regardless so
    # the continuum and the line walk run in every cell
    tables["thick"] = torch.zeros_like(tables["thick"])
    if grey:
        tables["thick"] = (torch.arange(tables["thick"].numel(), device="cuda") % 2).to(
            torch.int32)
        tables["kappagrey"] = 1e-14 / torch.clamp(tables["rho"], min=1e-30)
    if dense:
        te = torch.full_like(tables["Te"], 1.0e4)
        factor = 10.0 ** (2.0 * (1 + torch.arange(te.numel(), device="cuda") % 3)).to(dtype)
        nne = tables["rho"] / (56.0 * 1.66054e-24) * factor
        tables.update(Te=te, nne=nne, chiffpart=nne * 3.69255e8 / torch.sqrt(te))
    if njblue:
        tables["jblue_of_line"] = torch.arange(dad.nlines, dtype=torch.int32, device="cuda")
    kw = dict(nlines=dad.nlines, ncells=sim.cells.Te.shape[0],
              ngc=max(dad.nbfcontinua_ground, 1), nphixs=dad.nphixspoints,
              max_inner=max_inner,
              relativistic=(sim.opts.use_relativistic_doppler_shift if relativistic is None
                            else relativistic),
              phixs_dnu=float(dad.nphixsnuincrement),
              last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=test_mode,
              want_bfrate=want_bfrate, expansion=expansion, defer_scatter=defer,
              nradbins=nradbins, njblue=njblue, want_gamma=lut, want_bfheat=lut,
              ff_only=ff_only, **rpkt_kernel.kernel_geometry(sim.grid))
    f64 = dtype == torch.float64
    counted = lambda: sum(v for k, v in rpkt_kernel.propagate.launches.items()
                          if k.endswith(rpkt_kernel.F64_SUFFIX) == f64)
    before, before_all = counted(), sum(rpkt_kernel.propagate.launches.values())
    ok, rep, _, plain = rpkt_kernel.check_kernel(
        99, lanes, tables, tau, sel, float(ctx.t2), float(ctx.tmin),
        float(sim.grid.max_path_step), shared_rows=shared_rows, stage=stage, **kw)
    torch.cuda.synchronize()
    # the second launch pair holds still every lane with a differing
    # integer output (more launches find lanes whose counts alone differ)
    launches = rep["launches"]
    assert launches == 1 + (rep["held_lanes"] > 0) or rep["count_held_lanes"] > 0
    # the launches count for the configurations of the launch's precision
    # only
    added = launches * (1 + want_bfrate + expansion + defer + bool(nradbins) + bool(njblue)
                        + ff_only)
    assert counted() == before + added
    assert sum(rpkt_kernel.propagate.launches.values()) == before_all + added
    assert ok, rep
    # the estimators accumulated, so their comparison tested something (a
    # launch of a few lanes: they moved)
    names = (("j", "nuj", "ncross") + (("bfrate",) if want_bfrate else ())
             + (("radbin",) if nradbins else ()) + (("jblue",) if njblue else ()))
    if n is not None and n < 64:
        assert rep["nadv_plain"] > 0, rep
    else:
        for name in names:
            assert rep["nonzero"][name], (name, rep)
    if grey:
        assert rep["n_thickscat_plain"] > 0, rep
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
def test_kernel_matches_plain_version(scenes, max_inner, test_mode):
    """The 1D spherical configuration without bf-rate estimators."""
    _check(*scenes["sph1d"], max_inner, test_mode, want_bfrate=False)


@pytest.mark.cuda
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_geometries_with_bfrate(scenes, name, max_inner):
    """Every geometry and model mapping with the detailed bf-rate estimators,
    Philox draws."""
    _check(*scenes[name], max_inner, test_mode=False)


@pytest.mark.cuda
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", ["3dmodel", "cyl2d"])
def test_kernel_global_atomics_mode(scenes, name, max_inner):
    """Estimator rows added straight into global memory (the mode the
    wrapper takes for many cells), forced on a small grid."""
    _check(*scenes[name], max_inner, test_mode=True, shared_rows=False)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", ["sph1d", "1dmodel_3dgrid"])
def test_ff_only_kernel_matches_plain_version(scenes, name, max_inner, test_mode):
    """The free-free continuum of the grey opacity cases 0-3 (``ff_only``) in
    K1's kernel (without bf-rate rows) and in the 3D walk (with them, which
    accumulate in every case): the kernel against its plain version, and
    no electron-scattering or bound-free opacity, no LUT gamma or
    bf-heating row, in either."""
    plain = _check(*scenes[name], max_inner, test_mode, want_bfrate=name != "sph1d",
                   ff_only=True)
    for f in ("chi_escat", "chi_bf", "gamma", "bfheat"):
        assert not bool(plain[f].any()), f


# the double form of each kernel configuration: (fixture, scene, _check
# keywords); njblue None: every line a J_b_lu column
DOUBLE_CASES = {
    "k1": ("scenes", "sph1d", dict(want_bfrate=False)),
    "k2_bfrate": ("scenes", "1dmodel_3dgrid", {}),
    "k2_3dmodel_global_rows": ("scenes", "3dmodel", dict(shared_rows=False)),
    "k3": ("scenes", "cyl2d", {}),
    "k3_global_rows": ("scenes", "cyl2d", dict(shared_rows=False)),
    "k4_sph1d": ("expo_scenes", "sph1d", dict(want_bfrate=False, expansion=True)),
    "k4_cyl2d": ("expo_scenes", "cyl2d", dict(want_bfrate=False, expansion=True)),
    "k4_3dmodel": ("expo_scenes", "3dmodel", dict(want_bfrate=False, expansion=True)),
    "k6": ("defer_scenes", "1dmodel_3dgrid", dict(want_bfrate=False, defer=True)),
    "k5_multibin_jblue": ("scenes", "1dmodel_3dgrid", dict(nradbins=64, njblue=None,
                                                            lut=False)),
    "k5_sph1d": ("scenes", "sph1d", dict(nradbins=64, njblue=None)),
    "ff_only": ("scenes", "sph1d", dict(want_bfrate=False, ff_only=True)),
    "ff_only_bfrate": ("scenes", "1dmodel_3dgrid", dict(ff_only=True)),
    "k1_grey": ("scenes", "sph1d", dict(want_bfrate=False, grey=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("case", list(DOUBLE_CASES))
def test_double_kernel_matches_plain_version(request, case, test_mode):
    """The float64 instantiation of each configuration against its plain
    version in float64 (rpkt_kernel.TOL_F64: 1e-9, at most 4 tipped
    lanes); its launches count for the ``_f64`` configurations."""
    fixture, name, kw = DOUBLE_CASES[case]
    sim, ctx = request.getfixturevalue(fixture)[name]
    if kw.get("njblue", 0) is None:
        kw = dict(kw, njblue=sim.dad.nlines)
    plain = _check(sim, ctx, 16, test_mode, dtype=torch.float64, **kw)
    assert plain["posx"].dtype == torch.float64 and plain["est"].dtype == torch.float64


# every kernel that launch_geom in csrc/rpkt_crossing.cu can dispatch, by
# (geometry, walk, NLTE fields): (fixture, scene, _check keywords); the NLTE
# instantiations take the multibin rows (and the J_b_lu rows, LUT estimators
# off, on the line walks); njblue None: every line a J_b_lu column
INSTANTIATIONS = {
    ("sph", "lines", False): ("scenes", "sph1d", dict(want_bfrate=False)),
    ("sph", "lines", True): ("scenes", "sph1d", dict(nradbins=64, njblue=None)),
    ("sph", "bins", False): ("expo_scenes", "sph1d", dict(want_bfrate=False, expansion=True)),
    ("sph", "bins", True): ("expo_scenes", "sph1d", dict(want_bfrate=False, expansion=True,
                                                        nradbins=64)),
    ("cyl", "lines", False): ("scenes", "cyl2d", {}),
    ("cyl", "lines", True): ("scenes", "cyl2d", dict(nradbins=64, njblue=None, lut=False)),
    ("cyl", "bins", False): ("expo_scenes", "cyl2d", dict(want_bfrate=False, expansion=True)),
    ("cyl", "bins", True): ("expo_scenes", "cyl2d", dict(want_bfrate=False, expansion=True,
                                                        nradbins=64)),
    ("cart", "lines", True): ("scenes", "3dmodel", {}),
    ("cart", "bins", False): ("expo_scenes", "3dmodel", dict(want_bfrate=False, expansion=True)),
    ("cart", "bins", True): ("expo_scenes", "3dmodel", dict(want_bfrate=False, expansion=True,
                                                           nradbins=64)),
}
INSTANTIATION_LANES = 384


def _instantiation_name(case, dtype):
    from artis_tpu_torch.transport import rpkt_kernel

    geom, walk, nlte = case
    return rpkt_kernel.kernel_name(getattr(rpkt_kernel, f"GEOM_{geom.upper()}"), walk == "bins",
                                   nlte, f64=dtype == torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(INSTANTIATIONS),
                         ids=lambda c: f"{c[0]}_{c[1]}{'_nlte' if c[2] else ''}")
def test_every_instantiation_matches_plain_version(request, case, dtype):
    """Each kernel the dispatcher can launch, in both precisions, at a few
    hundred lanes against its plain version (Philox draws); the launch ran
    the kernel the case names."""
    from artis_tpu_torch.transport import rpkt_kernel

    fixture, name, kw = INSTANTIATIONS[case]
    sim, ctx = request.getfixturevalue(fixture)[name]
    if kw.get("njblue", 0) is None:
        kw = dict(kw, njblue=sim.dad.nlines)
    rpkt_kernel.propagate.kernels.clear()
    _check(sim, ctx, 16, False, n=INSTANTIATION_LANES, dtype=dtype, **kw)
    assert set().union(*rpkt_kernel.propagate.kernels.values()) == {
        _instantiation_name(case, dtype)}


def test_instantiation_cases_cover_the_dispatcher():
    """The cases above name every kernel launch_geom can dispatch
    (rpkt_kernel.dispatchable_kernels: 21 generic instantiations and the
    float32 1D line walk's kernel), so that a change to the dispatcher cannot
    leave one unchecked on the card."""
    from artis_tpu_torch.transport import rpkt_kernel

    covered = {_instantiation_name(c, d) for c in INSTANTIATIONS
               for d in (torch.float32, torch.float64)}
    assert covered == rpkt_kernel.dispatchable_kernels() and len(covered) == 22


# the redesigned double line walks (line_walk_w64):
# the 3D walk with bf-rate rows (K2 / K5-bfrate), with multibin and J_b_lu
# rows (K5), deferred (K6), and the cylindrical walk K3 (XYDir, four scalar
# row atomics) at the 2340-line Fe atom and with grey scatters that turn
# its directions: (fixture, scene, _check keywords); njblue None: every line
# a J_b_lu column
W64_CASES = {
    "k2_bfrate": ("scenes", "3dmodel", {}),
    "k5_multibin_jblue": ("scenes", "3dmodel", dict(nradbins=64, njblue=None, lut=False)),
    "k6": ("defer_scenes", "1dmodel_3dgrid", dict(want_bfrate=False, defer=True)),
    "k3_fe": ("k3_cylinders", "fe", dict(want_bfrate=False)),
    "k3_grey": ("k3_cylinders", "synthetic", dict(want_bfrate=False, grey=True,
                                                  shared_rows=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("relativistic", [True, False])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("case", list(W64_CASES))
def test_double_line_walks_match_plain_version(request, case, test_mode, relativistic):
    """Each redesigned double line walk against its plain version in
    float64 (rpkt_kernel.TOL_F64), with the relativistic Doppler factors of
    kilonova_lte and the non-relativistic ones of the classic and nebular
    presets (whose line loop keeps its divide by the line's frequency)."""
    from artis_tpu_torch.transport import rpkt_kernel

    fixture, name, kw = W64_CASES[case]
    sim, ctx = request.getfixturevalue(fixture)[name]
    if kw.get("njblue", 0) is None:
        kw = dict(kw, njblue=sim.dad.nlines)
    geom = rpkt_kernel.kernel_geometry(sim.grid)["geom"]
    assert rpkt_kernel.redesigned(geom, False, case.startswith("k5"), f64=True).w64
    _check(sim, ctx, 16, test_mode, dtype=torch.float64, relativistic=relativistic, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
def test_double_k3_at_the_main_paths_lanes(k3_cylinders, test_mode):
    """The double K3 at the 2^18 lanes of kilonova_2d_2dgrid_f64's
    launches."""
    _check(*k3_cylinders["synthetic"], 16, test_mode, want_bfrate=False, n=1 << 18,
           dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("name", ["sph1d", "1dmodel_3dgrid"])
def test_check_kernel_holds_tipped_lanes_on_a_dense_probe(scenes, name, test_mode, dtype):
    """The 8 shells ionised and at 1e2-1e6 times the electron density,
    64 crossings: lanes scatter on electrons many times, and a float32
    near-tie that changes only a lane's scatter count, cursor or continuum
    changes its cell's rows by a whole crossing; check_kernel holds every
    lane with a differing integer output still for the estimator
    comparison, which then holds at the unchanged tolerances."""
    _check(*scenes[name], 64, test_mode, dense=True, dtype=dtype)


@pytest.mark.cuda
def test_main_path_float64_launches_the_double_forms(tmp_path):
    """The default transport dtype (float64) through the CLI on the card:
    only the double forms launch, and the run writes its outputs."""
    _need_cuda()
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    make_run(d, ncells=8, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=1)
    rpkt_kernel.reset_launches()
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--set", "npkts=4000",
                      "--set", "grid_type=SPHERICAL1D", "--set", "mintemp=1000.0",
                      "--set", "maxtemp=20000.0", "--set", "tablesize=20"]) == 0
    launched = rpkt_kernel.propagate.launches
    assert launched["rpkt_crossing_sph1d_f64"] > 0
    assert not any(v for k, v in launched.items() if not k.endswith("_f64")), launched
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    assert np.all(np.isfinite(lc)) and lc[:, 1].sum() > 0


@pytest.mark.cuda
def test_same_seed_float64_runs_repeat(tmp_path):
    """Two float64 runs of the default slice's shells with the same seed:
    after timestep 0 the rpkt steps, packet state, cells and every
    estimator but the kernel's double-atomic sums (rpkt_kernel.ATOMIC_SUMS)
    bitwise identical, and those sums within 1e-12."""
    _need_cuda()
    import dataclasses

    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.transport.rpkt_kernel import ATOMIC_SUMS

    sims = []
    for i in range(2):
        d = tmp_path / f"run{i}"
        d.mkdir()
        make_run(str(d), ncells=8, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0,
                 logrho0=-8.0)
        sims.append(Simulation(str(d), _opts(20000, transport_dtype="float64"),
                               device="cuda"))
    for sim in sims:
        sim.do_timestep(0)
    a, b = sims
    assert a.state.pos.dtype == torch.float64
    assert a.transport_log[-1]["steps"] == b.transport_log[-1]["steps"] > 0
    for what in ("state", "est", "cells"):
        for f in dataclasses.fields(getattr(a, what)):
            x = getattr(getattr(a, what), f.name)
            if not isinstance(x, torch.Tensor):
                continue
            y = getattr(getattr(b, what), f.name)
            if what == "est" and f.name in ATOMIC_SUMS:
                torch.testing.assert_close(y, x, rtol=1e-12, atol=1e-15 * float(x.abs().max()),
                                           msg=f"{what}.{f.name}")
            else:
                torch.testing.assert_close(y, x, rtol=0, atol=0, equal_nan=True,
                                           msg=f"{what}.{f.name}")
    for sim in sims:
        sim.close()


@pytest.mark.cuda
def test_main_path_opacity_case3_with_diagnostics(tmp_path):
    """Grey opacity case 3 with the run diagnostics through the CLI on the
    card: K1 launches with the free-free continuum, no electron scattering
    or bound-free event is counted, linestat.out's counts equal the
    counters, the macro-atom log and the ion statistics are written, and
    the lockfile is released."""
    _need_cuda()
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    make_run(d, ncells=8, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=1, logrho0=-8.0,
             opacity_case=3, rho_crit_para=1e-7)
    rpkt_kernel.reset_launches()
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--set", "npkts=4000",
                      "--set", "transport_dtype=float32", "--set", "grid_type=SPHERICAL1D",
                      "--set", "mintemp=1000.0", "--set", "maxtemp=20000.0",
                      "--set", "tablesize=20", "--set", "record_linestat=True",
                      "--set", "track_ion_stats=True", "--set", "log_macroatom=True"]) == 0
    launched = rpkt_kernel.propagate.launches
    assert launched["rpkt_crossing_sph1d"] == launched["rpkt_crossing_ffonly"] > 0
    assert not os.path.exists(os.path.join(d, "artis.pid"))
    log = open(os.path.join(d, "output_0-0.txt")).read()
    for name in ("escounter", "k_stat_from_bf", "ma_stat_activation_bf"):
        assert f"  {name}:" not in log, name
    rows = open(os.path.join(d, "linestat.out")).read().splitlines()
    emitted = sum(int(v) for r in rows[5::2] for v in r.split())
    assert len(rows) == 5 + 2 * 3 and emitted > 0
    counted = sum(int(line.split(": ")[1]) for line in log.splitlines()
                  if line.startswith("  ma_stat_deactivation_bb: "))
    assert emitted == counted
    assert len(open(os.path.join(d, "macroatom_0000.out")).read().splitlines()) > 1
    assert "ionstats Z" in open(os.path.join(d, "estimators_0002.out")).read()


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["SPHERICAL1D", "CARTESIAN3D"])
def test_main_path_launches_the_kernel(tmp_path, grid):
    _need_cuda()
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    mk = dict(model_dim=3, ncells=6) if grid == "CARTESIAN3D" else dict(ncells=8)
    make_run(d, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=1, **mk)
    rpkt_kernel.reset_launches()
    extra = ["--set", "detailed_bf_estimators_on=True"] if grid == "CARTESIAN3D" else []
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--set", "npkts=2000",
                      "--set", "transport_dtype=float32", "--set", f"grid_type={grid}",
                      "--set", "mintemp=1000.0", "--set", "maxtemp=20000.0",
                      "--set", "tablesize=20", *extra]) == 0
    launched = rpkt_kernel.propagate.launches
    if grid == "CARTESIAN3D":
        assert launched["rpkt_crossing_cart3d"] > 0 and launched["rpkt_crossing_bfrate"] > 0
    else:
        assert launched["rpkt_crossing_sph1d"] > 0
    assert len(glob.glob(os.path.join(d, "estimators_*.out"))) == 2
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    assert np.all(np.isfinite(lc)) and lc[:, 1].sum() > 0


# name -> (make_run keywords, Options keywords) of the expansion-opacity
# scenes: dense enough that the binned line opacity drives events
EXPO_SCENES = {
    "sph1d": (dict(ncells=8, logrho0=-6.8), dict(grid_type="SPHERICAL1D")),
    "cyl2d": (dict(ncells=4, model_dim=2, logrho0=-7.5), dict(grid_type="CYLINDRICAL2D")),
    "3dmodel": (dict(ncells=6, model_dim=3, logrho0=-7.5), dict(grid_type="CARTESIAN3D")),
}


@pytest.fixture(scope="module")
def expo_scenes(tmp_path_factory):
    _need_cuda()
    from artis_tpu_torch.driver import Simulation

    out = {}
    for name, (mk, okw) in EXPO_SCENES.items():
        d = str(tmp_path_factory.mktemp(f"cuda_expo_{name}"))
        make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, **mk)
        sim = Simulation(d, _opts(NPKTS, expansionopacities_on=True, **okw), device="cuda")
        out[name] = (sim, sim.update_grid(0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", list(EXPO_SCENES))
def test_expansion_kernel_matches_plain_version(expo_scenes, name, max_inner, test_mode):
    """K4: the expansion-opacity bin walk in every geometry; bound-bound
    events occur, so the bin walk is what decides the outcome."""
    plain = _check(*expo_scenes[name], max_inner, test_mode, want_bfrate=False,
                   expansion=True)
    assert int(((plain["is_bb"] > 0) & (plain["evented"] > 0)).sum()) > 0


@pytest.mark.cuda
def test_main_path_launches_the_expansion_kernel(tmp_path):
    _need_cuda()
    from artis_tpu_torch import stats
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0, model_dim=2, ncells=4,
             logrho0=-7.5)
    rpkt_kernel.reset_launches()
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--set", "npkts=2000",
                      "--set", "transport_dtype=float32", "--set", "grid_type=CYLINDRICAL2D",
                      "--set", "mintemp=1000.0", "--set", "maxtemp=20000.0",
                      "--set", "tablesize=20", "--set", "expansionopacities_on=True"]) == 0
    launched = rpkt_kernel.propagate.launches
    assert launched["rpkt_crossing_cyl2d"] > 0 and launched["rpkt_crossing_expansion"] > 0
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    assert np.all(np.isfinite(lc)) and lc[:, 1].sum() > 0
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert stats.COUNTER_NAMES[stats.MA_STAT_ACTIVATION_BB] in log


# the redesigned walks: K1 (the 1D line walk) and K4 (the bin walk on the
# 1D and cylindrical grids), each with its own fixture's scene
def _redesigned_case(kernel, scenes, expo_scenes):
    if kernel == "k1":
        return scenes["sph1d"], dict(want_bfrate=False)
    return expo_scenes[kernel.split("_")[1]], dict(want_bfrate=False, expansion=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 129])
@pytest.mark.parametrize("kernel", ["k1", "k4_sph1d", "k4_cyl2d"])
def test_redesigned_walks_partial_warps(scenes, expo_scenes, kernel, n):
    """Launches of a partial warp, one lane past a warp and one past a
    block: the warp-summed rows, the shared-memory staging and the bf
    window kept per thread with lanes missing."""
    sc, kw = _redesigned_case(kernel, scenes, expo_scenes)
    _check(*sc, 16, False, n=n, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("kernel", ["k1", "k4_sph1d", "k4_cyl2d"])
def test_redesigned_walks_row_modes(scenes, expo_scenes, kernel, shared_rows):
    """Both estimator-row modes of the redesigned walks."""
    sc, kw = _redesigned_case(kernel, scenes, expo_scenes)
    _check(*sc, 16, True, shared_rows=shared_rows, **kw)


# K3, the redesigned cylindrical line walk, on both of its main paths'
# cylinders: 25 x 50 cells with the synthetic atom (kilonova_2d_2dgrid) and
# with a 2340-line Fe atom (kilonova_2d_2dgrid_fe at a test's list length)
K3_CYLINDERS = {"synthetic": None, "fe": dict(elements=((26, 3),), nlevels_per_ion=40)}


@pytest.fixture(scope="module")
def k3_cylinders(tmp_path_factory):
    _need_cuda()
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.synthdata import write_synthetic_atomicdata

    out = {}
    for name, atom in K3_CYLINDERS.items():
        d = str(tmp_path_factory.mktemp(f"cuda_k3_{name}"))
        make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0,
                 ncells=25, model_dim=2)
        if atom is not None:
            write_synthetic_atomicdata(d, **atom)
        sim = Simulation(d, _opts(NPKTS, grid_type="CYLINDRICAL2D"), device="cuda")
        out[name] = (sim, sim.update_grid(0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("n", [1, 31, 4097, 1 << 18])
@pytest.mark.parametrize("cylinder", list(K3_CYLINDERS))
def test_k3_lane_counts(k3_cylinders, cylinder, n, test_mode):
    """K3 at a partial warp, one lane past a warp, one past a block, and the
    main path's 2^18 lanes."""
    _check(*k3_cylinders[cylinder], 16, test_mode, want_bfrate=False, n=n)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("cylinder", list(K3_CYLINDERS))
def test_k3_row_modes(k3_cylinders, cylinder, shared_rows, test_mode):
    """Both estimator-row modes of K3: the global rows (the wrapper's pick at
    both cylinders' sizes, a cell's four floats in one vector reduction) and
    shared memory."""
    from artis_tpu_torch.transport import rpkt_kernel

    sim = k3_cylinders[cylinder][0]
    assert not rpkt_kernel.pick_shared_rows(sim.cells.Te.shape[0],
                                            max(sim.dad.nbfcontinua_ground, 1), 0)
    _check(*k3_cylinders[cylinder], 16, test_mode, want_bfrate=False, shared_rows=shared_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("cylinder", list(K3_CYLINDERS))
def test_k3_grey_scatters(k3_cylinders, cylinder, shared_rows):
    """K3 with thick cells: grey scatters in the kernel turn the lanes'
    directions, and the thick cells' rows take no free-free heating."""
    _check(*k3_cylinders[cylinder], 16, False, want_bfrate=False, shared_rows=shared_rows,
           grey=True)


@pytest.fixture(scope="module")
def long_list_scene(tmp_path_factory):
    """The 1D scene with a 2340-line Fe atom: its line tables exceed the
    staging budget, so K1 walks the lines in global memory."""
    _need_cuda()
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.synthdata import write_synthetic_atomicdata

    d = str(tmp_path_factory.mktemp("cuda_long_list"))
    make_run(d, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0, ncells=8)
    write_synthetic_atomicdata(d, elements=((26, 3),), nlevels_per_ion=40)
    sim = Simulation(d, _opts(NPKTS, grid_type="SPHERICAL1D"), device="cuda")
    return sim, sim.update_grid(0)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
def test_k1_line_walk_beyond_the_staging(long_list_scene, max_inner, test_mode):
    from artis_tpu_torch.transport import rpkt_kernel

    sim = long_list_scene[0]
    dad = sim.dad
    stage, _ = rpkt_kernel.stage_plan(sim.grid.nonemptymgi_of_cell.shape[0],
                                      sim.cells.Te.shape[0], dad.nbfcontinua,
                                      dad.nphixspoints, max(dad.nbfcontinua_ground, 1),
                                      dad.nlines)
    assert not stage & rpkt_kernel.STAGE_LINES and stage & rpkt_kernel.STAGE_CELL
    _check(*long_list_scene, max_inner, test_mode, want_bfrate=False)


# the redesigned double 1D line walk (K1 in float64: its tables staged in
# 8-byte slots, warp-summed rows, line_walk_w64) and
# the redesigned double bin walk (K4 in float64: the staged double edge
# table, 1/dnudl once a crossing)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("stage", range(16))
def test_double_k1_staging_masks(scenes, stage, test_mode):
    """The double K1 with every subset of its table groups in shared
    memory (the others read from global memory) against its plain version
    in float64 (rpkt_kernel.TOL_F64)."""
    from artis_tpu_torch.transport import rpkt_kernel

    assert rpkt_kernel.redesigned(rpkt_kernel.GEOM_SPH, False, False, f64=True).k1
    _check(*scenes["sph1d"], 16, test_mode, want_bfrate=False, dtype=torch.float64,
           stage=stage)


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
def test_double_k1_line_walk_beyond_the_staging(long_list_scene, max_inner, test_mode):
    """The double K1 on the 2340-line Fe atom, whose line tables exceed the
    double staging budget: the walk reads them from global memory, the
    other groups from shared memory."""
    from artis_tpu_torch.transport import rpkt_kernel

    sim = long_list_scene[0]
    dad = sim.dad
    stage, _ = rpkt_kernel.stage_plan(sim.grid.nonemptymgi_of_cell.shape[0],
                                      sim.cells.Te.shape[0], dad.nbfcontinua,
                                      dad.nphixspoints, max(dad.nbfcontinua_ground, 1),
                                      dad.nlines, elem=8)
    assert not stage & rpkt_kernel.STAGE_LINES and stage & rpkt_kernel.STAGE_CELL
    _check(*long_list_scene, max_inner, test_mode, want_bfrate=False, dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("relativistic", [True, False])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("dense", [False, True])
def test_double_ff_only_k1(scenes, dense, test_mode, relativistic):
    """The double ff-only form (the free-free continuum of the grey opacity
    cases 0-3 in the double K1) on the scene's shells and on ionised,
    denser ones where free-free absorbs, with both Doppler factors: no
    electron-scattering or bound-free opacity and no LUT row."""
    plain = _check(*scenes["sph1d"], 16, test_mode, want_bfrate=False, ff_only=True,
                   dtype=torch.float64, dense=dense, relativistic=relativistic)
    for f in ("chi_escat", "chi_bf", "gamma", "bfheat"):
        assert not bool(plain[f].any()), f


@pytest.mark.cuda
@pytest.mark.parametrize("relativistic", [True, False])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", ["sph1d", "cyl2d"])
def test_double_bin_walks_match_plain_version(expo_scenes, name, max_inner, test_mode,
                                              relativistic):
    """The double K4 on the 1D grid's and the cylinder's lanes, with the
    relativistic Doppler factors of kilonova_lte (1/dnudl once a crossing)
    and the non-relativistic ones (nu / nu_lo a bin), against its plain
    version in float64; bound-bound bin events occur."""
    from artis_tpu_torch.transport import rpkt_kernel

    geom = rpkt_kernel.kernel_geometry(expo_scenes[name][0].grid)["geom"]
    assert rpkt_kernel.redesigned(geom, True, False, f64=True).k4
    plain = _check(*expo_scenes[name], max_inner, test_mode, want_bfrate=False, expansion=True,
                   dtype=torch.float64, relativistic=relativistic)
    assert int(((plain["is_bb"] > 0) & (plain["evented"] > 0)).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 129])
@pytest.mark.parametrize("kernel", ["k1", "k4_sph1d", "k4_cyl2d"])
def test_double_redesigned_walks_partial_warps(scenes, expo_scenes, kernel, n):
    """The double K1 and K4 at a partial warp, one lane past a warp and one
    past a block: the warp-summed double rows and the staged tables with
    lanes missing."""
    sc, kw = _redesigned_case(kernel, scenes, expo_scenes)
    _check(*sc, 16, False, n=n, dtype=torch.float64, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("kernel", ["k1", "k4_sph1d", "k4_cyl2d"])
def test_double_redesigned_walks_row_modes(scenes, expo_scenes, kernel, shared_rows):
    """Both estimator-row modes of the double K1 and K4."""
    sc, kw = _redesigned_case(kernel, scenes, expo_scenes)
    _check(*sc, 16, True, shared_rows=shared_rows, dtype=torch.float64, **kw)


# the deferred-event scenes (K6): dense and hot enough for electron
# scattering (tests/test_torch_deferred.py)
DEFER_SCENES = {
    "sph1d": (dict(ncells=8), dict(grid_type="SPHERICAL1D")),
    "1dmodel_3dgrid": (dict(ncells=5), dict(grid_type="CARTESIAN3D", ncoordgrid_x=8,
                                            ncoordgrid_y=8, ncoordgrid_z=8)),
}


@pytest.fixture(scope="module")
def defer_scenes(tmp_path_factory):
    _need_cuda()
    from artis_tpu_torch.driver import Simulation

    out = {}
    for name, (mk, okw) in DEFER_SCENES.items():
        d = str(tmp_path_factory.mktemp(f"cuda_defer_{name}"))
        make_run(d, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-6.0, **mk)
        sim = Simulation(d, _opts(NPKTS, dipole=True, pol_on=True, **okw), device="cuda")
        out[name] = (sim, sim.update_grid(0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", list(DEFER_SCENES))
def test_deferred_kernel_matches_plain_version(defer_scenes, name, max_inner, test_mode):
    """K6: every event leaves the kernel for the event pass; electron
    scattering events occur, and the in-kernel scatter counters stay 0."""
    plain = _check(*defer_scenes[name], max_inner, test_mode, want_bfrate=False, defer=True)
    ev = (plain["evented"] > 0) & (plain["is_bb"] == 0) & (plain["thick"] == 0)
    assert int(ev.sum()) > 0
    assert float(plain["misc"][3]) == 0 and float(plain["misc"][4]) == 0


@pytest.mark.cuda
def test_main_path_launches_the_deferred_kernel(tmp_path):
    """The classic preset through the CLI: K6 launches, the event pass
    counts electron scatterings, timestep 1 takes the non-LTE update."""
    _need_cuda()
    from artis_tpu_torch import stats
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, ncells=8,
             logrho0=-7.0, num_lte_timesteps=1)
    rpkt_kernel.reset_launches()
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--preset", "classic",
                      "--set", "npkts=20000", "--set", "transport_dtype=float32",
                      "--set", "grid_type=SPHERICAL1D", "--set", "mintemp=1000.0",
                      "--set", "maxtemp=20000.0", "--set", "tablesize=20"]) == 0
    launched = rpkt_kernel.propagate.launches
    assert launched["rpkt_crossing_sph1d"] > 0 and launched["rpkt_crossing_deferred"] > 0
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert "timestep 1: grid update (nlte)" in log
    assert stats.COUNTER_NAMES[stats.ESCOUNTER] in log


@pytest.mark.cuda
@pytest.mark.parametrize("shared_rows", [True, False])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", ["sph1d", "1dmodel_3dgrid"])
def test_multibin_jblue_kernel_matches_plain_version(scenes, name, max_inner, test_mode,
                                                     shared_rows):
    """K5-multibin and K5-jblue (64 bins, every line a J_b_lu column) with
    the LUT estimators off, as the nebular presets run them, in both
    estimator-row modes; with the rows empty, the LUT ones stay empty."""
    plain = _check(*scenes[name], max_inner, test_mode, shared_rows=shared_rows, nradbins=64,
                   njblue=scenes[name][0].dad.nlines, lut=False)
    assert plain["gamma"].numel() == 0 and plain["bfheat"].numel() == 0


@pytest.mark.cuda
def test_main_path_launches_the_nlte_kernels(tmp_path):
    """nltenebular without the non-thermal solver through the CLI: the
    multibin and J_b_lu configurations launch, timestep 1 solves the NLTE
    populations and the run writes nlte_0000.out and radfield_0000.out."""
    _need_cuda()
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.transport import rpkt_kernel

    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, ncells=5,
             logrho0=-7.0, num_lte_timesteps=1)
    rpkt_kernel.reset_launches()
    assert main_sn3d(["--rundir", d, "--device", "cuda", "--preset", "nltenebular",
                      "--set", "nt_on=False", "--set", "nt_solve_spencerfano=False",
                      "--set", "npkts=20000", "--set", "transport_dtype='float32'",
                      "--set", "ncoordgrid_x=8", "--set", "ncoordgrid_y=8",
                      "--set", "ncoordgrid_z=8", "--set", "mintemp=1000.0",
                      "--set", "maxtemp=20000.0", "--set", "tablesize=20",
                      "--set", "detailed_bf_estimators_usefromtimestep=1",
                      "--set", "first_nlte_radfield_timestep=1"]) == 0
    launched = rpkt_kernel.propagate.launches
    for k in ("rpkt_crossing_cart3d", "rpkt_crossing_bfrate", "rpkt_crossing_multibin",
              "rpkt_crossing_jblue"):
        assert launched[k] > 0, (k, launched)
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert "timestep 1: grid update (nlte)" in log and "NLTE outer loop" in log
    for fn in ("nlte_0000.out", "radfield_0000.out"):
        assert os.path.getsize(os.path.join(d, fn)) > 0


# the 3D line walk: the nebular launch's fields and K6, lanes in packet
# order and sorted by (model cell, cursor)
@pytest.mark.cuda
@pytest.mark.parametrize("order", ["packet", "sorted"])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
@pytest.mark.parametrize("name", ["1dmodel_3dgrid", "3dmodel"])
def test_3d_line_walk_nlte_lane_orders(scenes, name, max_inner, test_mode, order):
    _check(*scenes[name], max_inner, test_mode, nradbins=64,
           njblue=scenes[name][0].dad.nlines, lut=False, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["packet", "sorted"])
@pytest.mark.parametrize("test_mode", [True, False])
@pytest.mark.parametrize("max_inner", [1, 16])
def test_3d_line_walk_deferred_lane_orders(defer_scenes, max_inner, test_mode, order):
    plain = _check(*defer_scenes["1dmodel_3dgrid"], max_inner, test_mode, want_bfrate=False,
                   defer=True, order=order)
    assert int(((plain["evented"] > 0) & (plain["is_bb"] == 0)).sum()) > 0


@pytest.mark.cuda
def test_same_seed_nebular_runs_repeat(tmp_path):
    """Two runs of a small nebular scene (nltenebular without the
    non-thermal solver, 8^3 grid, NLTE populations from timestep 1) with
    the same seed: after timestep 0 the rpkt steps, packet state, cells and
    every estimator but the kernel's float-atomic sums
    (rpkt_kernel.ATOMIC_SUMS, exempt) bitwise identical, and those sums
    within float32 rounding; timesteps 1-2 run."""
    _need_cuda()
    import dataclasses

    from artis_tpu_torch import options
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.transport.rpkt_kernel import ATOMIC_SUMS

    sims = []
    for i in range(2):
        d = tmp_path / f"run{i}"
        d.mkdir()
        make_run(str(d), ncells=5, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
                 logrho0=-7.0, num_lte_timesteps=1)
        sims.append(Simulation(str(d), options.nltenebular(
            nt_on=False, nt_solve_spencerfano=False, npkts=20000,
            grid_type=options.GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
            ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
            transport_dtype="float32", detailed_bf_estimators_usefromtimestep=1,
            first_nlte_radfield_timestep=1), device="cuda"))
    for nts in range(3):
        for sim in sims:
            sim.do_timestep(nts)
        a, b = sims
        assert a.transport_log[-1]["steps"] > 0 and b.transport_log[-1]["steps"] > 0
        if nts:
            continue
        assert a.transport_log[-1]["steps"] == b.transport_log[-1]["steps"]
        for what in ("state", "est", "cells"):
            for f in dataclasses.fields(getattr(a, what)):
                x = getattr(getattr(a, what), f.name)
                if not isinstance(x, torch.Tensor):
                    continue
                y = getattr(getattr(b, what), f.name)
                if what == "est" and f.name in ATOMIC_SUMS:
                    torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-6 * float(x.abs().max()),
                                               msg=f"{what}.{f.name}")
                else:
                    torch.testing.assert_close(y, x, rtol=0, atol=0, equal_nan=True,
                                               msg=f"{what}.{f.name}")
    assert float(sims[0].est.jblue_count.sum()) > 0
    for sim in sims:
        sim.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_sums_repeat_on_card(dtype):
    """devutil.index_add on the card: the same bits on every call (many
    values per index, as the partition functions sum levels into ions), and
    the CPU's index_add to the dtype's rounding."""
    _need_cuda()
    from artis_tpu_torch.devutil import index_add

    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (37, 50)), dtype=dtype)
    index = torch.as_tensor(rng.integers(0, 50, 20000))
    src = torch.as_tensor(rng.uniform(0.0, 1.0, (37, 20000)), dtype=dtype)
    a = index_add(x.cuda(), 1, index.cuda(), src.cuda())
    b = index_add(x.cuda(), 1, index.cuda(), src.cuda())
    assert torch.equal(a, b)
    ref = x.double().index_add(1, index, src.double())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(a.cpu().double(), ref, rtol=tol, atol=tol * float(ref.max()))


def _nt_atom(folder):
    """The 3-element synthetic atom and its synthetic non-thermal files,
    read by the port (host tables)."""
    from artis_tpu_torch.atomic import to_device
    from artis_tpu_torch.io import atomicdata
    from artis_tpu_torch.synthdata import (write_synthetic_atomicdata,
                                           write_synthetic_nonthermal_data)

    elements = ((26, 3), (27, 2), (28, 2))
    write_synthetic_atomicdata(folder, elements=elements, nlevels_per_ion=7)
    write_synthetic_nonthermal_data(folder, elements)
    ad = atomicdata.read_atomicdata(folder)
    return ad, to_device(ad)


@pytest.mark.cuda
@pytest.mark.parametrize("auger", [True, False])
def test_spencerfano_solve_on_card_matches_cpu(tmp_path, auger):
    """The Spencer-Fano solve on the card against the same function on the
    CPU, in float64, at rtol 1e-9: the scatter over several shells of an
    ion and the batched triangular solve give the CPU's numbers."""
    _need_cuda()
    from artis_tpu_torch.devutil import map_tensors
    from artis_tpu_torch.plasma import nonthermal

    ad, dad = _nt_atom(str(tmp_path))
    ntd = nonthermal.build_nonthermal_data(ad, dad, str(tmp_path), sf_points=128)
    rng = np.random.default_rng(5)
    ncells = 16
    nnion = 10 ** rng.uniform(4.0, 8.0, (ncells, dad.nions_total))
    lp = torch.as_tensor(10 ** rng.uniform(-2.0, 6.0, (ncells, dad.nlevels_total)))
    nne = torch.as_tensor(nnion.sum(axis=1) * np.logspace(-3.0, 0.0, ncells))
    nnion = torch.as_tensor(nnion)
    cpu = nonthermal.solve_spencerfano_cells(ntd, dad, lp, nnion, nne,
                                             sf_auger_contribution_on=auger)
    card = nonthermal.solve_spencerfano_cells(
        map_tensors(lambda t: t.cuda(), ntd), map_tensors(lambda t: t.cuda(), dad), lp.cuda(),
        nnion.cuda(), nne.cuda(), sf_auger_contribution_on=auger)
    for k, v in cpu.items():
        assert card[k].is_cuda and card[k].dtype == torch.float64, k
        torch.testing.assert_close(card[k].cpu(), v, rtol=1e-9, atol=0, msg=k)
    assert float(cpu["frac_ionization"].min()) > 0


@pytest.mark.cuda
def test_nebular_timestep_with_the_solver_on_card(tmp_path):
    """nltenebular with the Spencer-Fano solver on the card: timestep 1
    solves it (the first non-LTE timestep here is 1, num_lte_timesteps 0),
    its transport splits the deposited leptons (none left over, some to
    ionisation), and the run stays finite."""
    _need_cuda()
    from artis_tpu_torch import options, stats
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.packets import TYPE_NTALPHA_DEPOSITED, TYPE_NTLEPTON_DEPOSITED
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    d = str(tmp_path)
    make_run(d, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, ncells=5,
             logrho0=-9.0, num_lte_timesteps=0)
    write_synthetic_nonthermal_data(d, ((26, 3), (27, 2), (28, 2)))
    sim = Simulation(d, options.nltenebular(
        npkts=20000, grid_type=options.GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
        ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
        transport_dtype="float32", radfieldbincount=32, nlte_outer_iters=4,
        detailed_bf_estimators_usefromtimestep=1, first_nlte_radfield_timestep=1),
        device="cuda")
    assert sim.ntd is not None and sim.ntd.shell_xs.is_cuda
    for nts in range(2):
        sim.do_timestep(nts)
    sim.close()
    assert sim.plasma_mode == "nlte" and sim.sf_solves >= 1
    fh = sim._sf_carry["frac_heating"]
    assert fh.is_cuda and bool(torch.all((fh > 0) & (fh <= 1)))
    c = sim.est.counters.cpu().numpy()
    assert c[stats.NT_STAT_TO_IONIZATION] > 0 and c[stats.NT_STAT_TO_KPKT] > 0
    p = sim.state.ptype
    assert not bool(((p == TYPE_NTLEPTON_DEPOSITED) | (p == TYPE_NTALPHA_DEPOSITED)).any())
    assert bool(torch.isfinite(sim.cells.Te).all())


@pytest.fixture(scope="module")
def oracle_sim_cuda(tmp_path_factory):
    _need_cuda()
    from test_torch_oracles import oracle_sim

    return oracle_sim(str(tmp_path_factory.mktemp("cuda_oracle")), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("oracle", ["pcygni_check", "planck_check"])
def test_oracles_through_k1(oracle_sim_cuda, oracle):
    """tests/test_torch_oracles.py's closed forms (the P-Cygni profile of a
    two-level atom, the Planck spectrum of the thermalisation limit) with
    the crossing kernel K1 on the card."""
    import test_torch_oracles
    from artis_tpu_torch.transport import rpkt_kernel

    rpkt_kernel.reset_launches()
    getattr(test_torch_oracles, oracle)(*oracle_sim_cuda)
    assert rpkt_kernel.propagate.launches["rpkt_crossing_sph1d"] > 0


@pytest.mark.cuda
def test_same_seed_vpkt_runs_repeat(tmp_path):
    """Two same-seed classic runs with virtual packets (the six exclusion
    channels and the velocity-grid maps) write the same
    specpol_virtual.out and vpkt_grid.out after timestep 0: the trace and
    its binning (sorted index_put_) repeat bit for bit on the card."""
    _need_cuda()
    from artis_tpu_torch.driver import Simulation

    vpkt_txt = ("3\n1 0 -1\n0 90 0\n1\n6\n0 -1 -2 -3 -4 26\n0 0 0\n0\n1 1e9\n10\n"
                "1\n0.5 3.0\n1\n3500 8000\n")
    out = []
    for k in range(2):
        d = tmp_path / f"run{k}"
        d.mkdir()
        make_run(str(d), ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, ncells=8,
                 logrho0=-7.0)
        (d / "vpkt.txt").write_text(vpkt_txt)
        sim = Simulation(str(d), _opts(20000, grid_type="CARTESIAN3D", ncoordgrid_x=8,
                                       ncoordgrid_y=8, ncoordgrid_z=8, dipole=True,
                                       pol_on=True, vpkt_on=True), device="cuda")
        sim.do_timestep(0)
        sim.finish()
        sim.close()
        assert sim._vspec_total[..., 0].sum() > 0
        out.append([(d / f).read_bytes() for f in ("specpol_virtual.out", "vpkt_grid.out")])
    assert out[0] == out[1]


@pytest.mark.cuda
def test_xcom_opacity_card_matches_cpu(tmp_path):
    """The XCOM photoelectric opacity of gamma_step on the card against the
    CPU, float64, for energies across and beyond every table."""
    _need_cuda()
    from artis_tpu_torch.io.gammadata import read_xcom_photoion
    from artis_tpu_torch.synthdata import write_synthetic_xcom_data
    from artis_tpu_torch.transport.engine import xcom_photoion_chi

    write_synthetic_xcom_data(str(tmp_path))
    e, s, n = read_xcom_photoion(str(tmp_path / "xcom_photoion_data.txt"), [26, 27, 28])
    rng = np.random.default_rng(3)
    nu = torch.as_tensor(10.0 ** rng.uniform(-2.5, 1.3, 100000) * 2.41326e20)
    nd = torch.as_tensor(10.0 ** rng.uniform(0, 8, (100000, 3)))
    args = [torch.as_tensor(x) for x in (e, s, n)] + [nd, nu]
    cpu = xcom_photoion_chi(*args)
    card = xcom_photoion_chi(*[x.cuda() for x in args]).cpu()
    assert torch.isfinite(card).all() and (card > 0).all()
    torch.testing.assert_close(card, cpu, rtol=1e-12, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_expansion_opacity_bins_repeat_on_card(dtype):
    """The expansion-opacity bin sums (devutil.index_add_, a sorted
    index_put_ on the card) give the same bits in two builds from the same
    inputs, and the CPU's sums within rounding."""
    _need_cuda()
    from artis_tpu_torch.transport.expansionopacity import build_expansion_opacities

    rng = np.random.default_rng(8)
    ncells, nlines = 64, 20000
    line_nu = torch.as_tensor(np.sort(10.0 ** rng.uniform(14.0, 15.8, nlines))[::-1].copy())
    tau = torch.as_tensor(10.0 ** rng.uniform(-4, 3, (ncells, nlines)) / 4e5)
    rho = torch.as_tensor(10.0 ** rng.uniform(-15, -12, ncells))
    t_r = torch.as_tensor(rng.uniform(3e3, 2e4, ncells))
    args = [x.to(dtype) for x in (tau, line_nu, rho, t_r)]
    cuda = [x.cuda() for x in args]
    k1, p1 = build_expansion_opacities(*cuda, 4e5)
    k2, p2 = build_expansion_opacities(*cuda, 4e5)
    assert torch.equal(k1, k2) and torch.equal(p1, p2)
    assert float(k1.sum()) > 0
    kc, _ = build_expansion_opacities(*args, 4e5)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(k1.cpu(), kc, rtol=rtol, atol=rtol * float(kc.abs().max()))


class _Captured(Exception):
    pass


@pytest.mark.cuda
def test_polarised_vpkt_spawn_card_matches_cpu(tmp_path):
    """Virtual packets from electron scatterings on the card: the dense, hot
    classic scene (chip_smoke.classic_dense_scene's) with virtual packets,
    4096 packets; the first electron-scattering spawns of timestep 0 (at
    least 16 sites) are traced on the card and, from the same inputs, on
    the CPU: the virtual I, Q and U of every bin within 1e-5 of the largest
    bin, and Q or U non-zero (dipole scattering polarises)."""
    _need_cuda()
    import types

    from artis_tpu_torch.devutil import map_tensors
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.transport import engine, vpkt

    d = tmp_path / "dense"
    d.mkdir()
    make_run(str(d), ncells=8, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-6.0, num_lte_timesteps=1)
    (d / "vpkt.txt").write_text("3\n1 0 -1\n0 90 0\n1\n6\n0 -1 -2 -3 -4 26\n0 0 0\n0\n1 1e9\n"
                                "10\n1\n0.5 3.0\n1\n3500 8000\n")
    from artis_tpu_torch.options import GridType, classic

    opts = classic(npkts=4096, grid_type=GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
                   ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
                   transport_dtype="float32", vpkt_on=True)
    sim = Simulation(str(d), opts, device="cuda")
    spawn, sites, cap = engine.vpkt_spawn, [], {}

    def capture(st, est, ctx, grid, dad, cells, o, mask, is_scatter, nu_cmf, oc):
        if is_scatter and bool(mask.any()):
            idx = torch.nonzero(mask)[:, 0]
            sites.append({k: v[idx].clone() for k, v in (
                ("pos", st.pos), ("dir", st.dir), ("prop_time", st.prop_time),
                ("where", st.where), ("nu_cmf", nu_cmf), ("e_cmf", st.e_cmf),
                ("stokes_qu", st.stokes[:, 1:3]))})
            cap.update(ctx=ctx, grid=grid, dad=dad, cells=cells, oc=oc)
            if sum(s["pos"].shape[0] for s in sites) >= 16:
                raise _Captured()
        return spawn(st, est, ctx, grid, dad, cells, o, mask, is_scatter, nu_cmf, oc)

    engine.vpkt_spawn = capture
    try:
        with pytest.raises(_Captured):
            sim.do_timestep(0)
    finally:
        engine.vpkt_spawn = spawn
        sim.close()
    site = {k: torch.cat([s[k] for s in sites]) for k in sites[0]}
    n = site["pos"].shape[0]
    cfg, ctx = sim.vpkt_cfg, cap["ctx"]

    def trace(to):
        c = types.SimpleNamespace(bf_a=to(ctx.bf_a), bf_dep=to(ctx.bf_dep),
                                  chi_ff_nnionpart=to(ctx.chi_ff_nnionpart))
        dev = to(site["pos"]).device
        v, _ = vpkt.trace_vpkts(
            cfg, vpkt.zero_vspectra(cfg, site["pos"].dtype, dev), map_tensors(to, cap["dad"]),
            map_tensors(to, cap["grid"]), map_tensors(to, cap["cells"]), c,
            to(ctx.vpkt_cum_tau), to(ctx.vpkt_cum_taunu),
            *(to(site[k]) for k in ("pos", "dir", "prop_time", "where", "nu_cmf", "e_cmf",
                                    "stokes_qu")),
            True, torch.ones(n, dtype=torch.bool, device=dev), cap["oc"])
        return v.double().cpu().numpy()

    card = trace(lambda x: x.cuda())
    cpu = trace(lambda x: x.cpu())
    assert np.all(np.isfinite(card)) and card[..., 0].sum() > 0
    assert np.abs(card[..., 1:]).sum() > 0, "no Q or U from the electron scatterings"
    assert np.abs(card - cpu).max() <= 1e-5 * np.abs(cpu).max()


# ---------------------------------------------------------------------------
# the mesh on the card (artis_tpu_torch/parallel): two ranks sharing the one
# card over gloo, and a one-rank NCCL world; each collective held bitwise to
# the same sums and concatenations of the ranks' tables on the CPU (a sum
# of two float64 values is the same in either order)


def _mesh_expected(world, ncells=6):
    """Every rank's tables of parallel.record.rank_tables, summed and
    concatenated on the CPU as the collectives must."""
    import dataclasses

    from artis_tpu_torch.parallel.record import rank_tables

    tabs = [rank_tables(r, ncells) for r in range(world)]
    est = {f.name: sum(getattr(t[0], f.name) for t in tabs)
           for f in dataclasses.fields(tabs[0][0])}
    rows = [torch.cat([t[i] for t in tabs])[:2 * world - 1] for i in (1, 2)]
    return est, rows


def _mesh_check(path, world):
    import dataclasses

    got = torch.load(path, weights_only=False)
    assert got["device"].startswith("cuda")
    est, rows = _mesh_expected(world)
    for f in dataclasses.fields(got["est"]):
        assert torch.equal(getattr(got["est"], f.name), est[f.name]), f.name
    for g, w in zip(got["rows"], rows):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_mesh_gloo_collectives_of_cuda_tables(tmp_path):
    """Two ranks on the one card (gloo): the all-reduce of CUDA estimators
    and the all-gather of CUDA per-cell rows against the CPU's sums and
    concatenation."""
    _need_cuda()
    from artis_tpu_torch.parallel import mesh as mesh_mod
    from artis_tpu_torch.parallel.record import record_collectives

    out = str(tmp_path / "coll.pt")
    mesh_mod.spawn(record_collectives, 2, "file://" + str(tmp_path / "store"), device="cuda",
                   args=(out,))
    _mesh_check(out, 2)


@pytest.mark.cuda
def test_mesh_nccl_one_rank_world(tmp_path):
    """A one-rank NCCL world in this process: its collectives give back the
    rank's own tables, and timestep 0 of a Simulation on it equals one
    shard with the key fold_in(key, 0) (packets and estimators bitwise but
    for the kernel's float atomic sums, rpkt_kernel.ATOMIC_SUMS, held by
    rpkt_kernel.atomic_sums_agree)."""
    _need_cuda()
    import dataclasses

    import torch.distributed as dist

    from artis_tpu_torch import rng
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.parallel import make_mesh
    from artis_tpu_torch.parallel.record import record_collectives
    from artis_tpu_torch.transport import engine, rpkt_kernel

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + str(tmp_path / "store"),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda")
        assert mesh.backend == "nccl" and mesh.world == 1
        record_collectives(mesh, str(tmp_path / "coll.pt"))
        _mesh_check(str(tmp_path / "coll.pt"), 1)
        sims = []
        for name, m in (("mesh", mesh), ("alone", None)):
            d = tmp_path / name
            d.mkdir()
            make_run(str(d), ncells=8, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0,
                     logrho0=-8.0)
            sims.append(Simulation(str(d), _opts(8192, transport_dtype="float64"),
                                   device="cuda", mesh=m))
        a, b = sims
        a.do_timestep(0)
        ctx = b.update_grid(0)
        st, est, _, n = engine.transport_timestep(
            rng.fold_in((b.seed, 1000), 0), b.state, b._zero_est(), b.grid, b.dad, b.aux, b.rc,
            b.rates, b.cells, ctx, b.opts, **b._transport_kwargs(0))
        assert a.transport_log[0]["steps"] == n > 0
        for f in dataclasses.fields(st):
            x, y = getattr(a.state, f.name), getattr(st, f.name)
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), f.name
        for f in dataclasses.fields(est):
            x, y = getattr(a.est, f.name), getattr(est, f.name)
            if f.name in rpkt_kernel.ATOMIC_SUMS:
                assert rpkt_kernel.atomic_sums_agree(x, y), f.name
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=f.name)
        for s in sims:
            s.close()
    finally:
        dist.destroy_process_group()

"""The mesh of the port (``artis_tpu_torch/parallel``, ``Simulation(mesh=)``,
``cli.main_sn3d --mesh``) on the CPU, against in-process runs of the port
and the JAX package's mesh (``artis_tpu/parallel/mesh.py``).

One gloo world of 4 ranks (``parallel.mesh.spawn``, a ``file://`` store
under the module's temporary directory) runs
``parallel.record.record_runs`` on the scenes of tests/test_multichip.py
(6 cells, so 4 ranks pad the cells to 8; 512 packets; float64):

- kilonova_lte, timesteps 0-3, a checkpoint before timestep 3, timestep 1's
  grid update recorded; then a resume from that checkpoint runs timestep 3;
- nltenebular with the synthetic non-thermal files and the NLTE outer loop
  (``nlte_outer_iters=2``), timesteps 0-2, timestep 2's update recorded
  (the first one after the LTE phase keeps the default Spencer-Fano
  solution, the next solves it).

While the world runs, the test process runs the JAX package's
``Simulation(mesh=4)`` on the same scene (4 of the 8 virtual CPU devices of
tests/conftest.py). The two packages draw different random streams, so
their transports agree within Monte Carlo noise, 4/sqrt(n) relative
(tests/test_physics_validation.py); the port's world against the port in
one process is exact but for the order of the reduction's float64 sums
(rtol 1e-12).
"""

import dataclasses
import functools
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import artis_tpu_torch.options as to
from artis_tpu_torch import rng
from artis_tpu_torch.synthdata import make_run, write_synthetic_nonthermal_data

torch.set_num_threads(1)

WORLD = 4
NPKTS = 512
SCENE = dict(ncells=6, ntimesteps=4, tmax_days=2.0, ngreyts=2)
OPT_KW = dict(npkts=NPKTS, grid_type=to.GridType.SPHERICAL1D, mintemp=1000.0, maxtemp=20000.0,
              tablesize=12)
# nltenebular as tests/test_multichip.py::test_cell_domain_nlte_solve_nondegenerate
# runs it, with the solver's synthetic files for the synthetic atom
NEB_SCENE = dict(ncells=6, ntimesteps=4, tmax_days=2.0, ngreyts=0, num_lte_timesteps=1)
NEB_KW = dict(npkts=NPKTS, grid_type=to.GridType.SPHERICAL1D, mintemp=1000.0, maxtemp=200000.0,
              tablesize=12, radfieldbincount=16, first_nlte_radfield_timestep=0,
              nlte_outer_iters=2, sf_points=64)
NT_ELEMENTS = ((26, 3), (27, 2), (28, 2))
RTOL_REDUCE = 1e-12
# the grid update of a slice of the cells against the update of all of them:
# batched float64 linear algebra rounds by batch (the NLTE and Spencer-Fano
# solves differ by up to 1.5e-12 relative; the LTE update is bitwise)
RTOL_BATCH = 1e-11


def _kn_opts(**kw):
    return to.kilonova_lte(**dict(OPT_KW, **kw))


def _run_dir(root, name, **scene):
    d = os.path.join(root, name)
    os.makedirs(d)
    make_run(d, **dict(SCENE, **scene))
    return d


def _load(path):
    return torch.load(path, weights_only=False)


def _jax_run(root):
    """The JAX package's Simulation(mesh=4) on the scene, timesteps 0-2:
    timestep 2's estimators and escapes (the first non-grey timestep), the
    light curve, and the simulation (its cell-domain grid update is
    compiled)."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    from artis_tpu.synthdata import make_run as jmake_run

    d = os.path.join(root, "jax")
    os.makedirs(d)
    jmake_run(d, **SCENE)
    sj = jd.Simulation(d, jo.kilonova_lte(npkts=NPKTS, grid_type=jo.GridType.SPHERICAL1D,
                                          mintemp=1000.0, maxtemp=20000.0, tablesize=12,
                                          linewalk_chunk=64),
                       datadir="/nonexistent", mesh=WORLD)
    assert sj.mesh is not None and sj.mesh.devices.size == WORLD
    n_esc = []
    for nts in range(3):
        sj.do_timestep(nts)
        n_esc.append(int(sj._escaped_counted.sum()))
    return dict(sim=sj, j=np.asarray(sj.prev_est.j), nuj=np.asarray(sj.prev_est.nuj),
                cmf_lum=float(sj.cmf_lum_ts[2]), n_escaped_ts2=n_esc[2] - n_esc[1],
                lc_lum=sj.lc_lum.copy(), n_escaped=n_esc[2])


def _jax_update(sj, cells, est):
    """The JAX package's grid update of timestep 1 (its driver's
    cell-domain dispatch) on the port's ``cells`` and estimators ``est``
    of timestep 0, each array placed as the simulation's own (committed to
    its devices or not), so that the update compiled for its timesteps
    1-2 serves: (mode, outputs)."""
    def put(obj, like):
        def one(v, x):
            v = np.asarray(v).astype(x.dtype)
            return jax.device_put(v, x.sharding) if x._committed else jax.numpy.asarray(v)
        return like.replace(**{k: one(v, getattr(like, k))
                               for k, v in obj.items() if hasattr(like, k)})

    sj.cells = put({f.name: getattr(cells, f.name).numpy() for f in dataclasses.fields(cells)},
                   sj.cells)
    sj.prev_est = put({k: v.numpy() for k, v in est.items()}, sj.prev_est)
    jit, seen = sj._plasma_jit, []

    def capture(*a, **kw):
        seen.append((kw["mode"], jit(*a, **kw)))
        return seen[-1][1]

    sj._plasma_jit = capture
    try:
        sj.update_grid(1)
    finally:
        sj._plasma_jit = jit
    return seen[0]


def _cli_run(d):
    """``cli.main_sn3d --mesh 2 --device cpu`` on the scene's timesteps 0-1."""
    from artis_tpu_torch.cli import main_sn3d

    return main_sn3d(["--rundir", d, "--device", "cpu", "--mesh", "2", "--set", "npkts=256",
                      "--set", "grid_type=SPHERICAL1D", "--set", "mintemp=1000.0",
                      "--set", "maxtemp=20000.0", "--set", "tablesize=12"])


def _alone(fresh):
    """The port in this process on the same scene: timestep 0's transport
    as the world's four shards, one after another with the keys
    ``fold_in(key, r)`` (summed), and as one shard with ``fold_in(key, 0)``;
    then timesteps 0-2 of the run."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.parallel.mesh import Mesh, shard_packets
    from artis_tpu_torch.transport import engine

    sim = Simulation(fresh, _kn_opts(), device="cpu")
    ctx = sim.update_grid(0)
    key = (sim.seed, 1000)

    def run(k, st):
        return engine.transport_timestep(k, st, sim._zero_est(), sim.grid, sim.dad, sim.aux,
                                         sim.rc, sim.rates, sim.cells, ctx, sim.opts,
                                         **sim._transport_kwargs(0))

    shards, nsteps = None, 0
    for r in range(WORLD):
        fake = Mesh(group=None, rank=r, world=WORLD, device=sim.device, backend="gloo")
        _, est, _, n = run(rng.fold_in(key, r), shard_packets(sim.state, fake))
        nsteps += n
        shards = est if shards is None else dataclasses.replace(shards, **{
            f.name: getattr(shards, f.name) + getattr(est, f.name)
            for f in dataclasses.fields(est)})
    one = run(rng.fold_in(key, 0), sim.state)[1]
    for nts in range(3):
        sim.do_timestep(nts)
    out = dict(shards=shards, nsteps=nsteps, one=one, lc_lum=sim.lc_lum.copy(),
               n_escaped=int(sim._escaped_counted.sum()))
    sim.close()
    return out


def _cli_then_alone(cli_dir, fresh):
    """The CLI's world (its failure is returned, for the CLI's test), then
    ``_alone``."""
    try:
        assert _cli_run(cli_dir) == 0
        cli_error = None
    except Exception as exc:  # noqa: BLE001 - raised again by the CLI's test
        cli_error = exc
    return cli_error, _alone(fresh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's records, the JAX package's mesh run beside them, the run
    directories, the CLI's two-rank run (its directory and error) and
    ``_alone``: the world in one thread and the CLI's world then ``_alone``
    in another, while this one runs the JAX package."""
    from artis_tpu_torch.parallel import mesh as mesh_mod
    from artis_tpu_torch.parallel.record import record_runs

    root = str(tmp_path_factory.mktemp("mesh"))
    kn = _run_dir(root, "kn")
    neb = os.path.join(root, "neb")
    os.makedirs(neb)
    make_run(neb, **NEB_SCENE)
    write_synthetic_nonthermal_data(neb, NT_ELEMENTS)
    fresh = _run_dir(root, "fresh")  # the scene again, for runs in this process
    runs = [dict(rundir=kn, opts=_kn_opts(), timesteps=[0, 1, 2, 3], checkpoint_at=3,
                 capture_update=1, out=os.path.join(root, "kn.pt")),
            dict(copy_from=kn, rundir=os.path.join(root, "kn_resume"), opts=_kn_opts(),
                 timesteps=[3], out=os.path.join(root, "resume.pt")),
            dict(rundir=neb, opts=to.nltenebular(**NEB_KW), timesteps=[0, 1, 2],
                 capture_update=2, out=os.path.join(root, "neb.pt"))]
    world = functools.partial(mesh_mod.spawn, record_runs, WORLD,
                              "file://" + os.path.join(root, "store"), device="cpu",
                              args=(runs,))
    with ThreadPoolExecutor(2) as pool:
        spawned = pool.submit(world)
        after = pool.submit(_cli_then_alone, _run_dir(root, "cli", ntimesteps=3), fresh)
        jax_run = _jax_run(root)
        spawned.result()
        cli_error, alone = after.result()
    return dict(kn=_load(runs[0]["out"]), resume=_load(runs[1]["out"]),
                neb=_load(runs[2]["out"]), jax=jax_run, fresh=fresh, root=root,
                cli=(os.path.join(root, "cli"), cli_error), alone=alone)


@pytest.fixture(scope="module")
def alone(world):
    return world["alone"]


def _rel_close(a, b, n, name):
    assert n > 0, name
    tol = 4.0 / np.sqrt(n)
    assert abs(b - a) <= tol * abs(a), f"{name}: {a} vs {b} (tol {tol}, n={n})"


def test_sharded_transport_matches_shard_emulation(world, alone):
    """Timestep 0's all-reduced estimators equal the four shards run one
    after another and summed: counters and integer fields exactly, floats
    to rtol 1e-12 (the reduction adds in another order); the rpkt steps
    are the shards' sum."""
    est = world["kn"]["est"][0]
    assert world["kn"]["transport_log"][0]["steps"] == alone["nsteps"] > 0
    assert world["kn"]["transport_log"][0]["ranks"] == WORLD
    for f in dataclasses.fields(alone["shards"]):
        want, got = getattr(alone["shards"], f.name), est[f.name]
        if f.name == "counters" or not want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f.name)
        else:
            torch.testing.assert_close(got, want, rtol=RTOL_REDUCE, atol=0, msg=f.name)
    assert float(est["j"].sum()) > 0 and float(est["counters"].sum()) > 0


def test_sharded_transport_against_jax(world):
    """The transport of the port's world of 4 ranks and of the JAX
    package's 4-device mesh in timestep 2, the scene's first non-grey one
    (timestep 0's few r-packets, in grey cells, make its J too noisy for
    the rule): J and nuJ over the cells within 4/sqrt(npkts), the escaped
    luminosity within 4/sqrt(n) of the packets that escaped."""
    est, jx = world["kn"]["est"][2], world["jax"]
    for k in ("j", "nuj"):
        _rel_close(float(jx[k].sum()), float(est[k].sum()), NPKTS, k)
    _rel_close(jx["cmf_lum"], float(world["kn"]["cmf_lum_ts"][2]), jx["n_escaped_ts2"],
               "cmf_lum")


def _flat(out):
    """The tensors of a grid update's outputs, named by their place."""
    names = ("cells", "levelpops", "nnion", "chi_ff_part", "rates", "tau_sob", "bf_a", "bf_dep",
             "expo", "extra")
    flat = {}
    for name, v in zip(names, out):
        if v is None:
            continue
        if name == "expo":
            v = dict(zip(("kappa", "planck_cum", "wcum", "binoffsets"), v))
        if isinstance(v, dict):
            for k, x in v.items():
                if isinstance(x, (torch.Tensor, dict)):
                    for kk, xx in (x.items() if isinstance(x, dict) else [("", x)]):
                        flat[f"{name}.{k}.{kk}".rstrip(".")] = xx
                elif x is not None:
                    flat[f"{name}.{k}"] = torch.as_tensor(x)
        elif isinstance(v, torch.Tensor):
            flat[name] = v
        else:
            for f in dataclasses.fields(v):
                flat[f"{name}.{f.name}"] = getattr(v, f.name)
    return flat


@pytest.mark.parametrize("scene", ["kn", "neb"])
def test_cell_domain_plasma_matches_single_process(world, scene):
    """The grid update split over the 4 ranks (cells padded from 6 to 8)
    and gathered: every output field equals the update of one process on
    the same inputs. The nltenebular update ran the NLTE outer loop and a
    Spencer-Fano solve, so its iterations, fractional changes and carry are
    not the defaults."""
    upd = world[scene]["update"]
    got, want = _flat(upd["world"]), _flat(upd["alone"])
    assert set(got) == set(want)
    ncells = upd["args"]["cells"].Te.shape[0]
    assert ncells == 6
    for k in want:
        if k in ("extra.sf_seconds", "extra.sf_solves"):  # per rank: the largest, the sum
            continue
        assert got[k].shape == want[k].shape, k
        if got[k].is_floating_point():
            torch.testing.assert_close(got[k], want[k], rtol=RTOL_BATCH, atol=0, equal_nan=True,
                                       msg=k)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    if scene == "neb":
        assert upd["kwargs"]["mode"] == "nlte"
        assert int(want["extra.nlte_iters"].max()) == 2
        assert float(want["extra.nlte_fracdiff"].max()) > 0
        assert int(want["extra.sf_solves"]) > 0
        assert int(got["extra.sf_solves"]) >= int(want["extra.sf_solves"])
        assert float(want["extra.sf_carry.xe_when_solved"].max()) > 0
        assert int(want["extra.sf_carry.ts_last_solved"].max()) == 2


def test_cell_domain_plasma_against_jax(world):
    """Timestep 1's grid update of the port's world against the JAX
    package's cell-domain update (``plasma_update_sharded`` on 4 devices,
    its driver's mesh dispatch) on the port's estimators and cells: the
    cells, level and ion populations and Sobolev factors to rtol 1e-6, atol
    1e-12 (tests/test_multichip.py:191-197)."""
    upd = world["kn"]["update"]
    mode, res = _jax_update(world["jax"]["sim"], upd["args"]["cells"], world["kn"]["est"][0])
    assert mode == upd["kwargs"]["mode"] == "lte"
    cells_p, levelpops, nnion = upd["world"][0], upd["world"][1], upd["world"][2]
    tau = upd["world"][5]
    checked = 0
    for f in dataclasses.fields(cells_p):
        if hasattr(res[0], f.name):
            np.testing.assert_allclose(getattr(cells_p, f.name).numpy(),
                                       np.asarray(getattr(res[0], f.name)), rtol=1e-6,
                                       atol=1e-12, err_msg=f.name)
            checked += 1
    for got, want, name in ((levelpops, res[1], "levelpops"), (nnion, res[2], "nnion"),
                            (tau, res[5], "tau_sob")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12,
                                   err_msg=name)
    assert checked > 10


def test_mesh_production_run_and_resume(world, alone):
    """Simulation(mesh=4) ran timesteps 0-2 and checkpointed; the resume
    from that checkpoint repeats timestep 3 as the run continuing in its
    processes did (J to rtol 1e-12). The light curve after timesteps 0-2
    agrees with the port in one process and with the JAX package's
    Simulation(mesh=4) within 4/sqrt(n)."""
    kn, resume = world["kn"], world["resume"]
    torch.testing.assert_close(resume["est"][3]["j"], kn["est"][3]["j"], rtol=RTOL_REDUCE, atol=0)
    assert resume["transport_log"][0]["steps"] == kn["transport_log"][3]["steps"]
    lc = kn["lc_lum"][2]
    n_esc = alone["n_escaped"]
    _rel_close(float(alone["lc_lum"].sum()), float(lc.sum()), n_esc, "light curve, one process")
    _rel_close(float(world["jax"]["lc_lum"].sum()), float(lc.sum()), world["jax"]["n_escaped"],
               "light curve, JAX mesh")


def test_cli_mesh_ranks_write_one_run(world):
    """``cli.main_sn3d --mesh 2 --device cpu`` starts two ranks: rank 0
    alone writes the run directory (the log, outputs, lockfile released),
    with the world's counts; the packets file holds every packet in
    global order."""
    d, error = world["cli"]
    if error is not None:
        raise error
    tlog = json.load(open(os.path.join(d, "transport_log.json")))
    assert [r["ranks"] for r in tlog] == [2, 2] and all(r["completed"] for r in tlog)
    # the ranks' kernel launches: none on the CPU
    assert [r["rank_launches"] for r in tlog] == [[{}, {}]] * 2
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert "mesh: 2 ranks, packet axis 128 packets/rank" in log
    pk = np.loadtxt(os.path.join(d, "packets00_0000.out"), ndmin=2)
    assert pk.shape[0] == 256 and np.array_equal(pk[:, 0], np.arange(256))
    assert np.all(np.isfinite(np.loadtxt(os.path.join(d, "light_curve.out"))))
    assert not os.path.exists(os.path.join(d, "artis.pid"))


@pytest.fixture
def one_rank_world(tmp_path):
    """A gloo world of one rank, this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_world_is_one_shard(world, alone, one_rank_world, tmp_path):
    """A Mesh of a one-rank world, passed to the Simulation, runs timestep
    0 as one shard with the key fold_in(key, 0): every estimator equal."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.parallel import make_mesh

    d = str(tmp_path / "run")
    shutil.copytree(world["fresh"], d, ignore=shutil.ignore_patterns("*.out", "*.json"))
    sim = Simulation(d, _kn_opts(), device="cpu", mesh=make_mesh("cpu"))
    assert sim.mesh.world == 1
    sim.do_timestep(0)
    for f in dataclasses.fields(alone["one"]):
        torch.testing.assert_close(getattr(sim.prev_est, f.name), getattr(alone["one"], f.name),
                                   rtol=0, atol=0, msg=f.name)
    sim.close()


def test_mesh_turns_off_log_macroatom(one_rank_world, tmp_path):
    """log_macroatom is turned off on a mesh, with the JAX package's
    warning."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.parallel import make_mesh

    d = str(tmp_path)
    make_run(d, **SCENE)
    sim = Simulation(d, _kn_opts(log_macroatom=True), device="cpu", mesh=make_mesh("cpu"))
    assert not sim.opts.log_macroatom
    sim.close()
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert "WARNING: log_macroatom is single-device only; disabled for the mesh run" in log
    assert "mesh: 1 ranks, packet axis 512 packets/rank" in log


def test_npkts_must_divide_the_world(tmp_path):
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.parallel.mesh import Mesh

    d = str(tmp_path)
    make_run(d, **SCENE)
    mesh = Mesh(group=None, rank=0, world=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="npkts=512 must divide the mesh size 3"):
        Simulation(d, _kn_opts(), device="cpu", mesh=mesh)


def test_mesh_request_needs_a_started_world(tmp_path):
    """mesh=n ranks needs a world of n started; "auto", "off", None and 1
    run alone."""
    from artis_tpu_torch.driver import Simulation

    d = str(tmp_path)
    make_run(d, **SCENE)
    with pytest.raises(ValueError, match="mesh=4 ranks requested but the world has 1"):
        Simulation(d, _kn_opts(), device="cpu", mesh=4)
    for req in ("auto", 1):
        sim = Simulation(d, _kn_opts(), device="cpu", mesh=req)
        assert sim.mesh is None
        sim.close()


@pytest.mark.parametrize("value", ["off", "auto", "1", "3"])
def test_mesh_option_parses_like_the_jax_cli(value, tmp_path, monkeypatch):
    """--mesh off / auto / n reach the Simulation as the JAX package's CLI
    passes them."""
    import artis_tpu.cli as jcli
    import artis_tpu.driver as jd
    from artis_tpu_torch.cli import mesh_request

    seen = {}

    class Recorder:
        def __init__(self, *a, mesh=None, **kw):
            seen["mesh"] = mesh

        def run(self, **kw):
            pass

    monkeypatch.setattr(jd, "Simulation", Recorder)
    make_run(str(tmp_path), **SCENE)
    assert jcli.main_sn3d(["--rundir", str(tmp_path), "--mesh", value]) == 0
    assert mesh_request(value) == seen["mesh"]


def test_maybe_init_distributed(monkeypatch):
    """No launcher: False and no world. With the ARTIS_* variables the
    world reaches init_process_group (tests/test_multichip.py:414-438);
    on the CPU over gloo. ARTIS_COORDINATOR=auto takes torchrun's
    variables (env://)."""
    import torch.distributed as dist

    from artis_tpu_torch.parallel.distributed import maybe_init_distributed

    monkeypatch.delenv("ARTIS_COORDINATOR", raising=False)
    assert maybe_init_distributed(log=lambda *_: None) is False
    assert not dist.is_initialized()
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setenv("ARTIS_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("ARTIS_NUM_PROCESSES", "4")
    monkeypatch.setenv("ARTIS_PROCESS_ID", "2")
    assert maybe_init_distributed(log=lambda *_: None, device="cpu") is True
    monkeypatch.setenv("ARTIS_COORDINATOR", "auto")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert maybe_init_distributed(log=lambda *_: None, device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:8476", world_size=4, rank=2),
                     dict(backend="gloo", init_method="env://", world_size=8, rank=5)]


@pytest.mark.parametrize("hosts, device, ncards, cards, backend", [
    (("a", "a"), "cuda", 2, ["cuda:0", "cuda:1"], "nccl"),
    (("a", "a"), "cuda", 1, ["cuda:0", "cuda:0"], "gloo"),
    # an explicit card, which every rank of the host takes
    (("a", "a"), "cuda:0", 2, ["cuda:0", "cuda:0"], "gloo"),
    # two hosts and no LOCAL_RANK: each rank the first card of its host
    (("a", "b"), "cuda", 1, ["cuda:0", "cuda:0"], "nccl"),
])
def test_backend_follows_the_ranks_cards(hosts, device, ncards, cards, backend, monkeypatch):
    """Two ranks agree through their rendezvous store on their cards and the
    backend (``join_layout``, here with pretended cards): NCCL only when no
    two ranks of a host share a card."""
    import torch.distributed as dist

    from artis_tpu_torch.parallel.distributed import join_layout

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: ncards)
    store = dist.HashStore()
    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(lambda r: join_layout(store, r, 2, device, host=hosts[r]), range(2)))
    assert [str(dev) for dev, _ in got] == cards
    assert [b for _, b in got] == [backend] * 2

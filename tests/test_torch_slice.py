"""The ported slice end to end on the CPU: one full timestep of both
packages from the same packet state, the CLI's outputs, bit-exact
checkpoint resume, and that the port never imports jax.

Timestep parity is statistical: the two packages draw different random
numbers, so each total is held to 4/sqrt(n) relative, with n the number of
packets contributing to it (the criterion of
tests/test_physics_validation.py)."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_KW = dict(mintemp=1000.0, maxtemp=20000.0, tablesize=20, rpkt_crossings_per_dispatch=16)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def timestep_pair(tmp_path_factory):
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    import artis_tpu_torch.options as to
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    dj = str(tmp_path_factory.mktemp("slice_jax"))
    dt = str(tmp_path_factory.mktemp("slice_torch"))
    for d in (dj, dt):
        make_run(d, ncells=8, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0,
                 logrho0=-8.0)
    sj = jd.Simulation(dj, jo.kilonova_lte(grid_type=jo.GridType.SPHERICAL1D, npkts=2000,
                                           **OPT_KW), datadir="/nonexistent")
    # the port's crossing runs in float32 (the JAX side stays float64)
    st = td.Simulation(dt, to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, npkts=2000,
                                           transport_dtype="float32", **OPT_KW),
                       datadir="/nonexistent", device="cpu")
    # identical initial pellets for both: the JAX package's state as numpy
    st.state = interop.from_numpy(PacketState, _np_fields(sj.state), dtype=torch.float32)
    sj.do_timestep(0)
    st.do_timestep(0)
    return sj, st


def _rel_close(a, b, n, name):
    assert n > 0, name
    tol = 4.0 / np.sqrt(n)
    assert abs(b - a) <= tol * abs(a), f"{name}: {a} vs {b} (tol {tol}, n={n})"


def test_timestep_escaped_luminosity(timestep_pair):
    sj, st = timestep_pair
    n_esc = int(sj._escaped_counted.sum())
    _rel_close(sj.cmf_lum_ts[0], st.cmf_lum_ts[0], n_esc, "cmf_lum")
    _rel_close(float(sj.lc_lum.sum()), float(st.lc_lum.sum()), n_esc, "lc_lum")


def test_timestep_gamma_deposition(timestep_pair):
    """Without decay data the nuclides carry no gamma lines, so both
    packages must agree that nothing is emitted or deposited as gammas; the
    particle (positron + electron) deposition carries the decay energy."""
    sj, st = timestep_pair
    n_gamma = float(sj.est.gamma_emission)  # gamma pellets decayed (e0 units)
    if n_gamma > 0:
        _rel_close(sj.gamma_dep_ts[0], st.gamma_dep_ts[0], n_gamma, "gamma_dep")
    else:
        assert float(st.est.gamma_emission) == 0.0 and st.gamma_dep_ts[0] == 0.0
    n_part = float(sj.est.positron_emission + sj.est.electron_emission)
    dep = lambda s: s.dep_ts["positron"][0] + s.dep_ts["electron"][0]
    _rel_close(dep(sj), dep(st), n_part, "particle deposition")
    _rel_close(n_part, float(st.est.positron_emission + st.est.electron_emission), n_part,
               "particle emission")


@pytest.mark.parametrize("name", ["j", "nuj"])
def test_timestep_radiation_field_estimators(timestep_pair, name):
    from artis_tpu.packets import TYPE_ESCAPE, TYPE_RPKT

    sj, st = timestep_pair
    ptype = np.asarray(sj.state.ptype)
    n_r = int(np.sum((ptype == TYPE_RPKT) | ((ptype == TYPE_ESCAPE)
                                              & (np.asarray(sj.state.escape_type) == TYPE_RPKT))))
    a = np.asarray(getattr(sj.est, name))
    b = getattr(st.est, name).numpy()
    _rel_close(float(a.sum()), float(b.sum()), n_r, name)
    # the inner half of the shells carries most of the path length
    for c in range(a.shape[0] // 2):
        _rel_close(float(a[c]), float(b[c]), n_r / a.shape[0], f"{name}[{c}]")


def test_timestep_packet_census(timestep_pair):
    """Same fractions of escaped and still-pellet packets at the timestep end."""
    from artis_tpu.packets import TYPE_ESCAPE, TYPE_RADIOACTIVE_PELLET

    sj, st = timestep_pair
    pj, pt = np.asarray(sj.state.ptype), st.state.ptype.numpy()
    n = pj.size
    for kind in (TYPE_ESCAPE, TYPE_RADIOACTIVE_PELLET):
        a, b = np.sum(pj == kind), np.sum(pt == kind)
        assert abs(a - b) <= 4.0 * np.sqrt(max(a, 1)) + 0.01 * n, (kind, a, b)


def _cli_run(d, npkts=300, extra=()):
    from artis_tpu_torch.cli import main_sn3d

    make_run(d, ncells=6, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=1)
    return main_sn3d(["--rundir", d, "--device", "cpu", "--set", f"npkts={npkts}",
                      "--set", "grid_type=SPHERICAL1D", "--set", "mintemp=1000.0",
                      "--set", "maxtemp=20000.0", "--set", "tablesize=20",
                      "--set", "transport_dtype='float32'", *extra])


def test_main_sn3d_writes_every_output(tmp_path):
    d = str(tmp_path)
    assert _cli_run(d) == 0
    for name in ("output_0-0.txt", "timesteps.out", "grid.out", "gammalinelist.out",
                 "bflist.out", "light_curve.out", "spec.out", "deposition.out",
                 "packets00_0000.out", "transport_log.json"):
        assert os.path.getsize(os.path.join(d, name)) > 0, name
    est = sorted(glob.glob(os.path.join(d, "estimators_*.out")))
    assert [os.path.basename(p) for p in est] == ["estimators_0000.out", "estimators_0001.out"]
    lc = np.loadtxt(os.path.join(d, "light_curve.out"), ndmin=2)
    assert np.all(np.isfinite(lc)) and lc[:, 1].sum() > 0
    dep = np.loadtxt(os.path.join(d, "deposition.out"), ndmin=2)
    assert np.all(np.isfinite(dep))


def _opts_ckpt():
    import artis_tpu_torch.options as to

    return to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, npkts=400, mintemp=1000.0,
                           maxtemp=20000.0, tablesize=20, transport_dtype="float32")


@pytest.fixture(scope="module")
def straight_and_resumed(tmp_path_factory):
    from artis_tpu_torch.driver import Simulation

    d1 = str(tmp_path_factory.mktemp("tckpt_straight"))
    d2 = str(tmp_path_factory.mktemp("tckpt_resumed"))
    for d in (d1, d2):
        make_run(d, ncells=6, ntimesteps=3, tmax_days=2.0, ngreyts=1)
    sim_a = Simulation(d1, _opts_ckpt(), device="cpu")
    for ts in range(3):
        sim_a.do_timestep(ts)
    sim_b1 = Simulation(d2, _opts_ckpt(), device="cpu")
    for ts in range(2):
        sim_b1.do_timestep(ts)
    sim_b1.save_checkpoint(2)
    del sim_b1
    sim_b2 = Simulation(d2, _opts_ckpt(), device="cpu")
    assert sim_b2.params.simulation_continued_from_saved
    assert sim_b2.params.timestep_start == 2
    sim_b2.do_timestep(2)
    return sim_a, sim_b2


def _assert_bitwise(a, b, part):
    oa, ob = getattr(a, part), getattr(b, part)
    for f in dataclasses.fields(oa):
        torch.testing.assert_close(getattr(ob, f.name), getattr(oa, f.name), rtol=0, atol=0,
                                   equal_nan=True, msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(a.lc_lum, b.lc_lum)
    np.testing.assert_array_equal(a.spec.flux, b.spec.flux)


@pytest.mark.parametrize("part", ["state", "cells", "est"])
def test_checkpoint_resume_bitwise_identical(straight_and_resumed, part):
    _assert_bitwise(*straight_and_resumed, part)


@pytest.fixture(scope="module")
def straight_and_resumed_nlte(tmp_path_factory):
    """The classic preset with num_lte_timesteps=1: the resumed timestep 2
    takes the non-LTE grid update (T_R / W fit, thermal balance,
    rate-balance ionisation from the checkpointed gamma estimators) and
    the deferred-event crossing."""
    import artis_tpu_torch.options as to
    from artis_tpu_torch.driver import Simulation

    opts = to.classic(grid_type=to.GridType.SPHERICAL1D, npkts=400, mintemp=1000.0,
                      maxtemp=20000.0, tablesize=20, transport_dtype="float32")
    d1 = str(tmp_path_factory.mktemp("tckpt_nlte_straight"))
    d2 = str(tmp_path_factory.mktemp("tckpt_nlte_resumed"))
    for d in (d1, d2):
        make_run(d, ncells=6, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
                 logrho0=-7.0, num_lte_timesteps=1)
    sim_a = Simulation(d1, opts, device="cpu")
    for ts in range(3):
        sim_a.do_timestep(ts)
    assert sim_a.plasma_mode == "nlte"
    sim_b1 = Simulation(d2, opts, device="cpu")
    for ts in range(2):
        sim_b1.do_timestep(ts)
    sim_b1.save_checkpoint(2)
    del sim_b1
    sim_b2 = Simulation(d2, opts, device="cpu")
    assert sim_b2.params.timestep_start == 2
    sim_b2.do_timestep(2)
    assert sim_b2.plasma_mode == "nlte"
    return sim_a, sim_b2


@pytest.mark.parametrize("part", ["state", "cells", "est"])
def test_checkpoint_resume_through_nlte_bitwise_identical(straight_and_resumed_nlte, part):
    _assert_bitwise(*straight_and_resumed_nlte, part)


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter runs CPU timesteps of the slice (a kilonova_lte
    timestep, then a classic run through its non-LTE grid update and the
    port's exspec); jax must not be loaded."""
    code = (
        "import os, sys\n"
        "from artis_tpu_torch.synthdata import make_run\n"
        "from artis_tpu_torch.driver import Simulation\n"
        "from artis_tpu_torch.exspec import run_exspec\n"
        "from artis_tpu_torch.options import GridType, classic, kilonova_lte\n"
        f"d = {str(tmp_path)!r}\n"
        "kw = dict(grid_type=GridType.SPHERICAL1D, npkts=200, mintemp=1000.0, "
        "maxtemp=20000.0, tablesize=20, transport_dtype='float32')\n"
        "make_run(d, ncells=4, ntimesteps=2, tmax_days=2.0, ngreyts=1)\n"
        "s = Simulation(d, kilonova_lte(**kw), device='cpu')\n"
        "s.do_timestep(0)\n"
        "assert s.total_rpkt_steps > 0\n"
        "d2 = os.path.join(d, 'classic')\n"
        "os.makedirs(d2)\n"
        "make_run(d2, ncells=4, ntimesteps=3, tmax_days=2.0, ngreyts=0, num_lte_timesteps=1)\n"
        "s = Simulation(d2, classic(**kw), device='cpu')\n"
        "s.run()\n"
        "assert s.plasma_mode == 'nlte'\n"
        "run_exspec(d2, classic(**kw))\n"
        "assert os.path.exists(os.path.join(d2, 'specpol.out'))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NOJAX-OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout

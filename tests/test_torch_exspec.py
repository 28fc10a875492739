"""The port's exspec against the JAX package's, on the packets of a port run.

A classic-preset run of the port on the CPU (SPHERICAL1D, dense enough for
electron scattering, ``num_lte_timesteps=1`` so timestep 1 takes the
non-LTE grid update) writes its packets file; the port's ``run_exspec`` and
the JAX package's ``run_exspec`` then post-process copies of the same run
directory with ``pol_on``. Every file either writes is held to the other's
to rtol 1e-12 (both are the same host numpy on the same packets; the text
files differ in nothing), and the Stokes-I block of specpol.out equals
spec.out, as tests/test_endtoend.py asserts for the JAX package.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    from artis_tpu_torch.cli import main_sn3d

    d = str(tmp_path_factory.mktemp("exspec_run"))
    make_run(d, ncells=8, ntimesteps=4, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-7.0, num_lte_timesteps=1)
    main_sn3d(["--rundir", d, "--device", "cpu", "--preset", "classic",
               "--set", "npkts=2000", "--set", "grid_type=SPHERICAL1D",
               "--set", "mintemp=1000.0", "--set", "maxtemp=20000.0", "--set", "tablesize=20",
               "--set", "transport_dtype='float32'"])
    return d


@pytest.fixture(scope="module")
def outputs(rundir, tmp_path_factory):
    import artis_tpu.exspec as jex
    import artis_tpu.options as jo
    import artis_tpu_torch.exspec as tex
    import artis_tpu_torch.options as to

    out = {}
    for name, run, opts in (("jax", jex.run_exspec, jo.classic()),
                            ("port", tex.run_exspec, to.classic())):
        d = str(tmp_path_factory.mktemp(f"exspec_{name}"))
        shutil.copytree(rundir, d, dirs_exist_ok=True)
        before = set(os.listdir(d))
        run(d, opts)
        out[name] = (d, sorted(set(os.listdir(d)) - before
                               | {"spec.out", "light_curve.out"}))
    return out


def test_run_has_polarised_escapes(rundir):
    from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_RPKT, read_packets_text

    p = read_packets_text(os.path.join(rundir, "packets00_0000.out"))
    esc = (p["ptype"] == TYPE_ESCAPE) & (p["escape_type"] == TYPE_RPKT)
    assert esc.sum() > 100
    # electron scattering is rare at this density (a denser scene costs
    # minutes on the CPU): this run escapes one polarised packet
    assert (np.abs(p["stokes"][esc, 1:]) > 0).any()
    with open(os.path.join(rundir, "output_0-0.txt")) as f:
        assert "timestep 1: grid update (nlte)" in f.read()


def test_exspec_writes_the_same_files(outputs):
    (dj, fj), (dt, ft) = outputs["jax"], outputs["port"]
    assert fj == ft
    for name in ("specpol.out", "spec.out", "light_curve.out", "gamma_spec.out",
                 "gamma_light_curve.out", "emission.out", "absorption.out"):
        assert name in ft


@pytest.mark.parametrize("name", ["spec.out", "light_curve.out", "specpol.out",
                                  "gamma_spec.out", "gamma_light_curve.out", "emission.out",
                                  "emissiontrue.out", "absorption.out", "emissionpol.out",
                                  "absorptionpol.out"])
def test_exspec_file_matches_jax(outputs, name):
    dj, dt = outputs["jax"][0], outputs["port"][0]
    a = np.loadtxt(os.path.join(dj, name), ndmin=2)
    b = np.loadtxt(os.path.join(dt, name), ndmin=2)
    assert a.shape == b.shape, name
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=name)


def test_specpol_stokes_i_is_spec(outputs):
    d = outputs["port"][0]
    spec = np.loadtxt(os.path.join(d, "spec.out"))
    nts = spec.shape[1] - 1
    sp = np.loadtxt(os.path.join(d, "specpol.out"))
    assert sp.shape[1] == 1 + 3 * nts
    flux = spec[1:, 1:]
    assert flux.sum() > 0
    np.testing.assert_allclose(sp[1:, 1:1 + nts], flux, rtol=1e-5, atol=1e-30)
    # Q and U carry the escaped packets' polarisation
    assert np.abs(sp[1:, 1 + nts:]).sum() > 0

"""The run diagnostics on the port (``record_linestat``, ``track_ion_stats``,
``log_macroatom``), on the CPU.

- The per-line counts against the event counters, exactly: in every
  timestep the absorptions sum to ``ma_stat_activation_bb`` and the
  emissions to ``ma_stat_deactivation_bb``, and linestat.out holds the
  header rows and those counts; the per-ion energies out of the macro-atom
  sum over their channels.
- Against the JAX package, two timesteps of the same scene from the same
  pellets: every line's emission and absorption count within 5 sigma of
  Poisson noise, and the per-ion macro-atom energies (in, out, out by
  radiative de-excitation) within 4/sqrt(n) relative, n the events
  (tests/test_physics_validation.py).
- tests/test_macroatom_log.py's assertions on the port, under the
  reference's file name (macroatom_0000.out, not the JAX package's
  macroatom_0-0.out) and with the model grid index in the rows (not the
  nonempty-cell index); a capacity of 8 rows keeps 8 rows a timestep and
  reports the overflow.
- The nltewithoutnonthermal preset (record_linestat on) runs two
  timesteps through ``cli.main_sn3d --device cpu`` and writes
  linestat.out."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts

torch.set_num_threads(1)

# the classic miniature's density at days 1-2, under kilonova_lte: lines
# absorb, macro-atoms deactivate in every timestep
SCENE = dict(ncells=6, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-7.5)
DIAG = dict(record_linestat=True, track_ion_stats=True, log_macroatom=True,
            log_macroatom_capacity=4096)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Timesteps 0-1 of both packages with the three diagnostics on, from
    the JAX package's pellets; each timestep's estimators of both."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    dj, dt = (str(tmp_path_factory.mktemp(f"diag_{k}")) for k in ("jax", "torch"))
    for d in (dj, dt):
        make_run(d, **SCENE)
    jopts = jo.kilonova_lte(npkts=1000, grid_type=jo.GridType.SPHERICAL1D, mintemp=1000.0,
                            maxtemp=20000.0, tablesize=12, linewalk_chunk=64, **DIAG)
    sj = jd.Simulation(dj, jopts, datadir="/nonexistent")
    st = td.Simulation(dt, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    ests = []
    for ts in range(2):
        sj.do_timestep(ts)
        st.do_timestep(ts)
        ests.append((np_fields(sj.est), {f.name: getattr(st.est, f.name).double().numpy()
                                         for f in dataclasses.fields(st.est)}))
    st.close()
    return sj, st, ests


def test_line_counts_equal_the_counters(runs):
    from artis_tpu_torch import stats

    _, st, ests = runs
    rows = open(os.path.join(st.rundir, "linestat.out")).read().splitlines()
    assert len(rows) == 5 + 2 * len(ests)
    header = [np.array(r.split(), float) for r in rows[:5]]
    assert all(h.size == st.ad.nlines for h in header)
    np.testing.assert_allclose(header[0], 2.99792458e10 / np.asarray(st.ad.line_nu), rtol=1e-5)
    n_abs = 0
    for ts, (_, e) in enumerate(ests):
        c = e["counters"]
        assert e["line_absorbcount"].sum() == c[stats.MA_STAT_ACTIVATION_BB]
        assert e["line_emisscount"].sum() == c[stats.MA_STAT_DEACTIVATION_BB] > 0
        np.testing.assert_array_equal(np.array(rows[5 + 2 * ts].split(), int),
                                      e["line_emisscount"])
        np.testing.assert_array_equal(np.array(rows[6 + 2 * ts].split(), int),
                                      e["line_absorbcount"])
        n_abs += c[stats.MA_STAT_ACTIVATION_BB]
        ist = e["ion_stats"].sum(axis=0)
        out = ist[:, stats.ION_MACROATOM_ENERGYOUT_TOTAL].sum()
        parts = ist[:, [stats.ION_MACROATOM_ENERGYOUT_RADDEEXC,
                        stats.ION_MACROATOM_ENERGYOUT_COLLDEEXC,
                        stats.ION_RADRECOMB_MACROATOM]].sum()
        assert out > 0 and parts == pytest.approx(out, rel=1e-5)
    assert n_abs > 0


def test_line_histograms_match_jax(runs):
    _, _, ests = runs
    for name in ("line_emisscount", "line_absorbcount"):
        a = sum(j[name] for j, _ in ests).astype(np.float64)
        b = sum(t[name] for _, t in ests)
        assert a.sum() > 0 and b.sum() > 0, name
        assert np.all(np.abs(b - a) <= 5.0 * np.sqrt(np.maximum(a + b, 1.0))), name


def test_ion_stats_match_jax(runs):
    from artis_tpu import stats as jstats
    from artis_tpu_torch import stats

    _, _, ests = runs
    # each statistic with the counters of the events that add to it
    act = (jstats.MA_STAT_ACTIVATION_BB, jstats.K_STAT_TO_MA_COLLEXC, jstats.MA_STAT_ACTIVATION_BF)
    deact = (jstats.MA_STAT_DEACTIVATION_BB, jstats.MA_STAT_DEACTIVATION_FB,
             jstats.MA_STAT_DEACTIVATION_COLLDEEXC)
    for k, events in ((stats.ION_MACROATOM_ENERGYIN_TOTAL, act),
                      (stats.ION_MACROATOM_ENERGYOUT_TOTAL, deact),
                      (stats.ION_MACROATOM_ENERGYOUT_RADDEEXC, deact[:1]),
                      (stats.ION_MACROATOM_ENERGYIN_COLLEXC, act[1:2])):
        a = sum(j["ion_stats"][..., k].sum(axis=0) for j, _ in ests)
        b = sum(t["ion_stats"][..., k].sum(axis=0) for _, t in ests)
        n = sum(j["counters"][list(events)].sum() for j, _ in ests)
        assert a.sum() > 0 and n > 0, k
        assert abs(b.sum() - a.sum()) <= 4.0 / np.sqrt(n) * a.sum(), (k, a.sum(), b.sum(), n)
        # per ion, its share of the events
        for ion in np.nonzero(a)[0]:
            n_ion = n * a[ion] / a.sum()
            assert abs(b[ion] - a[ion]) <= 4.0 / np.sqrt(max(n_ion, 1.0)) * a[ion], (k, ion)


@pytest.mark.parametrize("capacity", [4096, 8])
def test_macroatom_log_rows(tmp_path, capacity):
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.options import GridType, kilonova_lte

    d = str(tmp_path)
    make_run(d, ncells=6, ntimesteps=4, tmax_days=2.0, ngreyts=0)
    opts = kilonova_lte(npkts=384, grid_type=GridType.SPHERICAL1D, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=12, linewalk_chunk=64,
                        transport_dtype="float32", log_macroatom=True,
                        log_macroatom_capacity=capacity)
    sim = Simulation(d, opts, datadir="/nonexistent", device="cpu")
    seen = []
    for nts in range(3):
        sim.do_timestep(nts)
        seen.append(int(sim.est.malog_n))
    sim.close()
    assert not os.path.exists(os.path.join(d, "macroatom_0-0.out"))
    with open(os.path.join(d, "macroatom_0000.out")) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    assert header[:3] == ["timestep", "modelgridindex", "Z"]
    assert len(rows) > 0, "no bb deactivations logged in 3 timesteps"
    line_nu = sim.dad.line_nu.double().numpy()
    mgis = set(int(m) for m in sim.mgi_of_nonempty)
    zs = set(int(z) for z in np.asarray(sim.ad.elem_z))
    for r in rows:
        nts, mgi, z = int(r[0]), int(r[1]), int(r[2])
        ion_in, ion_out = int(r[3]), int(r[4])
        lvl_in, lvl_out, actline = int(r[5]), int(r[6]), int(r[7])
        assert 0 <= nts < 3 and mgi in mgis and z in zs
        assert ion_in >= 1 and ion_out >= 1 and lvl_in >= 0 and lvl_out >= 0
        assert 0 <= actline < sim.ad.nlines
        np.testing.assert_allclose(float(r[9]), line_nu[actline], rtol=2e-5)
        assert lvl_out < lvl_in or ion_out <= ion_in
    for nts in range(3):
        assert sum(1 for r in rows if int(r[0]) == nts) == min(seen[nts], capacity)
    log = open(os.path.join(d, "output_0-0.txt")).read()
    assert ("macroatom log overflow" in log) == (max(seen) > capacity)
    if capacity == 8:
        assert max(seen) > capacity


def test_nltewithoutnonthermal_preset_writes_linestat(tmp_path):
    """The preset's record_linestat (artisoptions_nltewithoutnonthermal.h:40)
    through the CLI, with the non-thermal solver's synthetic data files: two
    timesteps (the second a non-LTE one), linestat.out with its five header
    rows and two rows a timestep; the lockfile is gone after the run."""
    from artis_tpu_torch.cli import main_sn3d
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    d = str(tmp_path)
    make_run(d, ncells=5, ntimesteps=3, tmin_days=5.0, tmax_days=9.0, ngreyts=0,
             logrho0=-9.0, logrho_slope=-0.15, num_lte_timesteps=1)
    write_synthetic_nonthermal_data(d, ((26, 3), (27, 2), (28, 2)))
    assert main_sn3d(["--rundir", d, "--device", "cpu", "--preset", "nltewithoutnonthermal",
                      "--set", "npkts=300", "--set", "grid_type=SPHERICAL1D",
                      "--set", "tablesize=20", "--set", "transport_dtype='float32'",
                      "--set", "sf_points=64"]) == 0
    rows = open(os.path.join(d, "linestat.out")).read().splitlines()
    assert len(rows) == 5 + 2 * 2
    nlines = len(rows[0].split())
    assert nlines > 0 and all(len(r.split()) == nlines for r in rows)
    assert sum(int(v) for r in rows[5:] for v in r.split()) > 0
    assert "grid update (nlte)" in open(os.path.join(d, "output_0-0.txt")).read()
    assert not os.path.exists(os.path.join(d, "artis.pid"))

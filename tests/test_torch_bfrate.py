"""The detailed bf-rate estimators (``detailed_bf_estimators_on``) of the
port against the JAX package on the CPU, and their life in the driver.

- The crossing's per-(cell, continuum) accumulation against the XLA path
  (opacity.accumulate_bf_estimators) and the Pallas kernel in interpret
  mode, on the settings of tests/test_pallas_rpkt.py::scene_bfr (8 shells,
  frequencies in the bf windows, max_inner 1), and on a 3D 6^3 model
  against the XLA path. Tolerances of that test: the sums within rel 5e-2,
  per entry rel 1e-2 on > 0.9 of the entries either side filled; the
  reference sum is > 0.
- The driver allocates (nonempty cells, nbfcontinua) rows when the option
  is on and (1, 1) when off, normalises them into ``prev_bfrate_normed`` as
  bfrate * e0 / (4 pi dV dt) * 4 pi / h (radfield.cc:946), and a resumed
  run carries them bit-exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import NPKTS, forced_state, jax_scene, run_pallas, run_port, run_xla

torch.set_num_threads(1)


def _assert_bfrate_close(bx, bp):
    assert bx.sum() > 0
    assert bp.sum() == pytest.approx(bx.sum(), rel=5e-2)
    sel = (bx > 0) | (bp > 0)
    denom = np.maximum(np.abs(bx[sel]), np.abs(bp[sel]))
    rel = np.abs(bx[sel] - bp[sel]) / np.maximum(denom, 1e-300)
    assert np.mean(rel < 1e-2) > 0.9, np.mean(rel < 1e-2)


def _compare(sc, seed, pallas):
    st0 = forced_state(sc, seed=seed, nu_logrange=(15.45, 15.95))
    rng = np.random.default_rng(seed)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    bp = run_port(sc, st0, tau, sel, 1)[1].bfrate.numpy().astype(np.float64)
    _assert_bfrate_close(np.asarray(run_xla(sc, st0, tau_u, 1)[1].bfrate), bp)
    if pallas:
        _assert_bfrate_close(np.asarray(run_pallas(sc, st0, tau, sel, 1)[1].bfrate), bp)


@pytest.fixture(scope="module")
def scene_bfr(tmp_path_factory):
    import artis_tpu.options as jo

    return jax_scene(tmp_path_factory, "tbfr_1d", dict(ncells=8),
                     dict(grid_type=jo.GridType.SPHERICAL1D, detailed_bf_estimators_on=True,
                          detailed_bf_estimators_usefromtimestep=0))


def test_bfrate_matches_jax(scene_bfr):
    _compare(scene_bfr, seed=29, pallas=True)


def test_bfrate_3dmodel_matches_xla(tmp_path_factory):
    import artis_tpu.options as jo

    sc = jax_scene(tmp_path_factory, "tbfr_3d", dict(ncells=6, model_dim=3),
                   dict(grid_type=jo.GridType.CARTESIAN3D, detailed_bf_estimators_on=True))
    _compare(sc, seed=31, pallas=False)


def _opts(bfr=True):
    """A 15000 K floor: at the synthetic scenes' own 1000-2000 K no packet
    reaches a bf window, and the estimators would stay zero."""
    import artis_tpu_torch.options as to

    return to.kilonova_lte(grid_type=to.GridType.CARTESIAN3D, npkts=300, mintemp=15000.0,
                           maxtemp=40000.0, tablesize=20, transport_dtype="float32",
                           detailed_bf_estimators_on=bfr,
                           detailed_bf_estimators_usefromtimestep=0)


def test_bfrate_rows_and_normalisation(tmp_path):
    from artis_tpu_torch.constants import FOURPI, H, ONEOVER4PI
    from artis_tpu_torch.driver import Simulation

    d = str(tmp_path)
    make_run(d, ncells=4, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0, model_dim=3)
    sim = Simulation(d, _opts(False), device="cpu")
    assert tuple(sim.est.bfrate.shape) == (1, 1)
    sim.close()
    sim = Simulation(d, _opts(True), device="cpu")
    shape = (sim.grid.nonempty_npts, sim.ad.nbfcontinua)
    assert tuple(sim.est.bfrate.shape) == shape
    sim.do_timestep(0)
    raw = sim.est.bfrate.double().numpy()
    assert tuple(raw.shape) == shape and raw.sum() > 0
    assert sim.prev_bfrate_normed is None
    sim.update_grid(1)
    p = sim.params
    deltav = sim._assoc_vol[sim.mgi_of_nonempty] * (float(sim.ts.mid[0]) / p.tmin) ** 3
    norm = sim._e0 * ONEOVER4PI / (deltav * float(sim.ts.width[0])) * FOURPI / H
    np.testing.assert_allclose(sim.prev_bfrate_normed.double().numpy(), raw * norm[:, None],
                               rtol=1e-6)
    sim.close()


def test_bfrate_checkpoint_resume_bitwise(tmp_path_factory):
    from artis_tpu_torch.driver import Simulation

    d1 = str(tmp_path_factory.mktemp("tbfr_straight"))
    d2 = str(tmp_path_factory.mktemp("tbfr_resumed"))
    for d in (d1, d2):
        make_run(d, ncells=4, ntimesteps=3, tmin_days=2.0, tmax_days=4.0, ngreyts=0,
                 model_dim=3)
    a = Simulation(d1, _opts(), device="cpu")
    for ts in range(3):
        a.do_timestep(ts)
    b1 = Simulation(d2, _opts(), device="cpu")
    for ts in range(2):
        b1.do_timestep(ts)
    b1.save_checkpoint(2)
    b1.close()
    b = Simulation(d2, _opts(), device="cpu")
    assert b.params.timestep_start == 2
    torch.testing.assert_close(b.prev_est.bfrate, b1.est.bfrate, rtol=0, atol=0)
    b.do_timestep(2)
    assert float(a.est.bfrate.sum()) > 0
    for f in dataclasses.fields(a.est):
        torch.testing.assert_close(getattr(b.est, f.name), getattr(a.est, f.name), rtol=0,
                                   atol=0, equal_nan=True, msg=f.name)
    torch.testing.assert_close(b.prev_bfrate_normed, a.prev_bfrate_normed, rtol=0, atol=0)
    torch.testing.assert_close(b.state.pos, a.state.pos, rtol=0, atol=0)

"""Runs of the port with the non-thermal solver on (the CPU, float32
transport, the synthetic atom and non-thermal files), rebuilt from the JAX
package's own cases (tests/test_nonthermal.py:166-316) on the port; the
two whole runs also at the presets' float64 transport:

- ``test_nt_excitation_channel_end_to_end``: with ``nt_excitation_on``
  deposited leptons also activate macro-atoms at the upper levels of the
  excitation transitions; the run stays finite and the three NT outcome
  counters account for every deposited lepton;
- ``test_wf_mode_end_to_end``: ``nt_on`` without ``nt_solve_spencerfano``,
  the work-function approximation: no Spencer-Fano table, the NLTE
  ionisation balance takes the work-function rate, and every deposited
  lepton becomes a k-packet (none is counted as an NT outcome);
- ``test_sf_solution_reuse_across_timesteps``: a carried solution is kept
  while x_e moved less than 5 %, it is within ``sf_max_ts_between_solutions``
  and it was not solved in the LTE phase (nonthermal.cc:2432-2442);
- ``test_checkpoint_resume_bitwise``: with ``sf_max_ts_between_solutions >
  0`` the carry goes through the checkpoint, and a resumed run is bit for
  bit the straight one (tests/test_checkpoint.py contract).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ELEMENTS = ((26, 3), (27, 2), (28, 2))
MAKE = dict(ncells=4, ntimesteps=4, tmax_days=2.0, ngreyts=0, num_lte_timesteps=1)


def _opts(**kw):
    import artis_tpu_torch.options as to

    base = dict(npkts=512, grid_type=to.GridType.SPHERICAL1D, mintemp=1000.0, maxtemp=20000.0,
                tablesize=16, linewalk_chunk=64, sf_points=48, radfieldbincount=32,
                detailed_bf_estimators_usefromtimestep=1, nlte_outer_iters=3,
                transport_dtype="float32")
    base.update(kw)
    return to.nltenebular(**base)


def _run_dir(tmp_path, **kw):
    from artis_tpu_torch.synthdata import make_run, write_synthetic_nonthermal_data

    d = str(tmp_path)
    make_run(d, **dict(MAKE, **kw))
    write_synthetic_nonthermal_data(d, ELEMENTS)
    return d


def _nt_counts(sim):
    from artis_tpu_torch import stats

    c = sim.est.counters.numpy()
    return np.array([c[stats.NT_STAT_TO_IONIZATION], c[stats.NT_STAT_TO_EXCITATION],
                     c[stats.NT_STAT_TO_KPKT]], np.int64)


def _no_deposit_left(sim):
    from artis_tpu_torch.packets import TYPE_NTALPHA_DEPOSITED, TYPE_NTLEPTON_DEPOSITED

    p = sim.state.ptype.numpy()
    return not np.any((p == TYPE_NTLEPTON_DEPOSITED) | (p == TYPE_NTALPHA_DEPOSITED))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nt_excitation_channel_end_to_end(tmp_path, dtype):
    from artis_tpu_torch import stats
    from artis_tpu_torch.driver import Simulation

    sim = Simulation(_run_dir(tmp_path), _opts(nt_excitation_on=True, transport_dtype=dtype),
                     device="cpu")
    assert sim.ntd is not None and sim.ntd.nexc > 0
    total = np.zeros(3, np.int64)
    for ts in range(3):
        sim.do_timestep(ts)
        n = _nt_counts(sim)
        c = sim.est.counters.numpy()
        assert c[stats.MA_STAT_ACTIVATION_NTCOLLION] == n[0]
        assert c[stats.MA_STAT_ACTIVATION_NTCOLLEXC] == n[1]
        assert _no_deposit_left(sim)
        total += n
    sim.close()
    assert np.all(np.isfinite(sim.cells.Te.numpy()))
    assert total[0] > 0 and total[1] > 0 and total[2] > 0
    # the stored excitation fractions are cumulative and end at the
    # solution's excitation share
    cum = sim._sf_carry["exc_fracdep_cum"].numpy()
    assert np.all(np.diff(cum, axis=1) >= 0)
    np.testing.assert_allclose(cum[:, -1], sim._sf_carry["frac_excitation"].numpy(), rtol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wf_mode_end_to_end(tmp_path, dtype):
    from artis_tpu_torch.driver import Simulation

    sim = Simulation(_run_dir(tmp_path), _opts(nt_solve_spencerfano=False, transport_dtype=dtype),
                     device="cpu")
    assert sim.ntd is None and sim.nt_wf is not None
    assert np.all(sim.nt_wf[0].numpy() > 0)
    total = np.zeros(3, np.int64)
    for ts in range(3):
        sim.do_timestep(ts)
        total += _nt_counts(sim)
        assert _no_deposit_left(sim)
    sim.close()
    assert sim.plasma_mode == "nlte" and sim._sf_carry is None
    assert np.all(np.isfinite(sim.cells.Te.numpy()))
    # every deposited lepton goes straight to a k-packet, outside the NT
    # outcome counters (as in the JAX package)
    assert total.sum() == 0
    assert sim.dep_ts["positron"].sum() + sim.dep_ts["electron"].sum() > 0


def test_sf_solution_reuse_across_timesteps(tmp_path):
    """The same grid update, evaluated on identical inputs with a carried
    solution of different ages and knob values (nlte_enabled off: the
    single-pass branch, deterministic)."""
    from artis_tpu_torch.driver import Simulation

    sim = Simulation(_run_dir(tmp_path, ntimesteps=6, tmax_days=2.5),
                     _opts(npkts=256, nlte_enabled=False, sf_max_ts_between_solutions=0),
                     device="cpu")
    sim.do_timestep(0)
    sim.do_timestep(1)  # nts == num_lte_timesteps: the solve is skipped
    assert sim._sf_carry is None and sim.sf_solves == 0
    # timestep 3 from the default carry: stale, every cell solves
    mode, res = sim._plasma_call(3)
    assert mode == "nlte"
    carry = res[-1]["sf_carry"]
    assert np.all(carry["ts_last_solved"].numpy() == 3)
    assert np.all(carry["xe_when_solved"].numpy() > 0)
    aged = dict(carry, ts_last_solved=torch.full_like(carry["ts_last_solved"], 2))
    # knob 0: age 3 - 2 > 0, stale, re-solved everywhere
    sim._sf_carry = aged
    _, res0 = sim._plasma_call(3)
    assert np.all(res0[-1]["sf_carry"]["ts_last_solved"].numpy() == 3)
    assert res0[-1]["sf_solves"] == 1
    # knob 5: within the age cap and x_e unchanged: reused, no solve
    sim.opts = sim.opts.replace(sf_max_ts_between_solutions=5)
    sim._sf_carry = aged
    _, res5 = sim._plasma_call(3)
    assert np.all(res5[-1]["sf_carry"]["ts_last_solved"].numpy() == 2)
    assert res5[-1]["sf_solves"] == 0
    # the same physics either way
    for k in ("frac_heating", "frac_ionization"):
        np.testing.assert_allclose(res5[-1]["sf_carry"][k].numpy(),
                                   res0[-1]["sf_carry"][k].numpy(), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(res5[0].Te.numpy(), res0[0].Te.numpy(), rtol=1e-6)
    # a solution of the LTE phase (ts_last <= num_lte_timesteps) is never kept
    sim._sf_carry = dict(carry, ts_last_solved=torch.full_like(carry["ts_last_solved"], 1))
    _, res_lte = sim._plasma_call(3)
    assert np.all(res_lte[-1]["sf_carry"]["ts_last_solved"].numpy() == 3)
    sim.close()


def test_checkpoint_resume_bitwise(tmp_path_factory):
    """Four timesteps straight against three, a checkpoint and a resumed
    fourth: the estimators, cells, populations and the Spencer-Fano carry
    agree bit for bit."""
    from artis_tpu_torch.driver import Simulation

    opts = _opts(npkts=300, sf_max_ts_between_solutions=2)
    d1 = _run_dir(tmp_path_factory.mktemp("nt_straight"), ntimesteps=5)
    d2 = _run_dir(tmp_path_factory.mktemp("nt_resumed"), ntimesteps=5)
    a = Simulation(d1, opts, device="cpu")
    for ts in range(4):
        a.do_timestep(ts)
    b1 = Simulation(d2, opts, device="cpu")
    for ts in range(3):
        b1.do_timestep(ts)
    b1.save_checkpoint(3)
    b1.close()
    b = Simulation(d2, opts, device="cpu")
    assert b.params.timestep_start == 3 and b._sf_carry is not None
    b.do_timestep(3)
    assert _nt_counts(a)[0] > 0
    for f in dataclasses.fields(a.est):
        torch.testing.assert_close(getattr(b.est, f.name), getattr(a.est, f.name), rtol=0,
                                   atol=0, equal_nan=True, msg=f.name)
    for f in ("Te", "nne", "ion_groundlevelpops", "ion_partfuncts"):
        torch.testing.assert_close(getattr(b.cells, f), getattr(a.cells, f), rtol=0, atol=0,
                                   msg=f)
    torch.testing.assert_close(b._last_levelpops, a._last_levelpops, rtol=0, atol=0)
    assert set(b._sf_carry) == set(a._sf_carry)
    for k in a._sf_carry:
        torch.testing.assert_close(b._sf_carry[k], a._sf_carry[k], rtol=0, atol=0, msg=k)
    a.close()
    b.close()

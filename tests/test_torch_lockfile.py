"""The port's runtime substrate (tests/test_lockfile.py on the port): the
run directory's pid lockfile, and the packet checkpoint's write retried
with read-back (artis_tpu/driver.py:2009-2025)."""

import os

import pytest
import torch

from artis_tpu_torch.synthdata import make_run

torch.set_num_threads(1)


def _opts():
    from artis_tpu_torch.options import GridType, kilonova_lte

    return kilonova_lte(npkts=64, grid_type=GridType.SPHERICAL1D, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=8, transport_dtype="float32")


def test_lockfile_blocks_second_driver(tmp_path):
    from artis_tpu_torch.driver import Simulation

    d = str(tmp_path)
    make_run(d, ncells=4, ntimesteps=2, tmax_days=1.0, ngreyts=0)
    pid = os.path.join(d, "artis.pid")
    sim = Simulation(d, _opts(), datadir="/nonexistent", device="cpu", lockfile=True)
    assert int(open(pid).read()) == os.getpid()
    with pytest.raises(RuntimeError, match="already"):
        Simulation(d, _opts(), datadir="/nonexistent", device="cpu", lockfile=True)
    sim.close()
    assert not os.path.exists(pid)
    # a stale lockfile (a dead pid) is taken over, not fatal
    with open(pid, "w") as f:
        f.write("999999999\n")
    sim2 = Simulation(d, _opts(), datadir="/nonexistent", device="cpu", lockfile=True)
    assert int(open(pid).read()) == os.getpid()
    sim2.close()
    assert not os.path.exists(pid)
    # without the lockfile (the library's default) the directory is not locked
    Simulation(d, _opts(), datadir="/nonexistent", device="cpu").close()
    assert not os.path.exists(pid)


def test_lockfile_keeps_no_closed_run_alive(tmp_path):
    """The exit hook holds the lockfile's path alone: a closed run's
    Simulation (and its device tensors) can be freed."""
    import gc
    import weakref

    from artis_tpu_torch.driver import Simulation

    d = str(tmp_path)
    make_run(d, ncells=4, ntimesteps=2, tmax_days=1.0, ngreyts=0)
    sim = Simulation(d, _opts(), datadir="/nonexistent", device="cpu", lockfile=True)
    ref = weakref.ref(sim)
    sim.close()
    del sim
    gc.collect()
    assert ref() is None
    # an open run's hook removes the lockfile at exit
    sim = Simulation(d, _opts(), datadir="/nonexistent", device="cpu", lockfile=True)
    sim._lock_release()
    assert not os.path.exists(os.path.join(d, "artis.pid"))
    sim.close()


@pytest.fixture
def sim(tmp_path, monkeypatch):
    from artis_tpu_torch import driver
    from artis_tpu_torch.driver import Simulation

    monkeypatch.setattr(driver, "CHECKPOINT_RETRY_S", 0.0)
    make_run(str(tmp_path), ncells=4, ntimesteps=3, tmax_days=1.0, ngreyts=0)
    s = Simulation(str(tmp_path), _opts(), datadir="/nonexistent", device="cpu")
    yield s
    s.close()


def _failing_save(monkeypatch, nfail):
    """save_packets_npz raising on its first ``nfail`` calls (a full disk)."""
    from artis_tpu_torch import packets

    real, calls = packets.save_packets_npz, []

    def save(path, state):
        calls.append(path)
        if len(calls) <= nfail:
            raise OSError("No space left on device")
        return real(path, state)

    monkeypatch.setattr(packets, "save_packets_npz", save)
    return calls


def test_checkpoint_write_retried(sim, monkeypatch):
    from artis_tpu_torch import packets

    calls = _failing_save(monkeypatch, 1)
    sim.save_checkpoint(1)
    assert len(calls) == 2
    path = os.path.join(sim.rundir, "packets_0000_ts1.npz")
    assert os.path.exists(path) and os.path.exists(os.path.join(sim.rundir, "gridsave_ts1.npz"))
    torch.testing.assert_close(packets.load_packets_npz(path).e_cmf, sim.state.e_cmf,
                               rtol=0, atol=0)
    sim.logfile.flush()
    log = open(os.path.join(sim.rundir, "output_0-0.txt")).read()
    assert "packet checkpoint write attempt 0 failed: No space left on device" in log


def test_checkpoint_write_raises_after_three_failures(sim, monkeypatch):
    calls = _failing_save(monkeypatch, 3)
    with pytest.raises(IOError, match="could not write packet checkpoint"):
        sim.save_checkpoint(1)
    assert len(calls) == 3
    assert not os.path.exists(os.path.join(sim.rundir, "gridsave_ts1.npz"))

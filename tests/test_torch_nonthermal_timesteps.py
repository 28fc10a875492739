"""Whole timesteps of the nebular miniature with the non-thermal solver on,
the port (float32 transport, the CPU) against the JAX package (float64)
from the same pellets, within Monte Carlo noise (the 4/sqrt(n) rule of
tests/test_physics_validation.py).

The scene is tests/test_torch_nonthermal_update.py's: a 5-shell 1D model on
an 8^3 grid, days 1-2, ``num_lte_timesteps=0``, nltenebular with the
Spencer-Fano solve at ``sf_points=64`` and the synthetic non-thermal files.
Timestep 0 is the ``first`` update (every deposited lepton a k-packet),
timestep 1 solves Spencer-Fano and its transport splits the deposited
leptons: the NT outcome counters (to ionisation, to k-packet) of each
timestep, their sum (every deposited lepton accounted for), the escaped
luminosity, J, and T_e and nne of the cells that hold most of J agree
within 4/sqrt(n). The JAX run takes its Spencer-Fano solve eagerly
(``test_torch_nonthermal_update.eager_spencerfano``, ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts, rel_close
from test_torch_nonthermal_update import ELEMENTS, MAKE, _jopts, eager_spencerfano

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td
    from artis_tpu import stats as jstats
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    dj = str(tmp_path_factory.mktemp("nt_ts_jax"))
    dt = str(tmp_path_factory.mktemp("nt_ts_port"))
    for d in (dj, dt):
        make_run(d, **MAKE)
        write_synthetic_nonthermal_data(d, ELEMENTS)
    jopts = _jopts()
    sj = jd.Simulation(dj, jopts, datadir="/nonexistent")
    st = td.Simulation(dt, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    keys = (jstats.NT_STAT_TO_IONIZATION, jstats.NT_STAT_TO_EXCITATION, jstats.NT_STAT_TO_KPKT)
    counts = {"jax": [], "port": []}
    with eager_spencerfano(sj):
        for nts in range(2):
            sj.do_timestep(nts)
            st.do_timestep(nts)
            counts["jax"].append(np.asarray(sj.est.counters)[list(keys)].astype(np.int64))
            counts["port"].append(st.est.counters.numpy()[list(keys)].astype(np.int64))
    st.close()
    return dict(sj=sj, st=st, counts=counts)


def test_nt_counters_match_in_mc_noise(runs):
    cj, ct = runs["counts"]["jax"], runs["counts"]["port"]
    # timestep 0 (first update): every deposit a k-packet on both sides
    assert cj[0][0] == ct[0][0] == 0 and cj[0][2] > 0 and ct[0][2] > 0
    # timestep 1: the split; no NT excitation channel in the preset
    assert ct[1][0] > 0 and cj[1][0] > 0 and ct[1][1] == cj[1][1] == 0
    for ts in range(2):
        rel_close(float(cj[ts].sum()), float(ct[ts].sum()), int(cj[ts].sum()), f"deposits ts{ts}")
        for i, name in ((0, "to_ionization"), (2, "to_kpkt")):
            if cj[ts][i] > 0:
                rel_close(float(cj[ts][i]), float(ct[ts][i]), int(cj[ts][i]), f"{name} ts{ts}")


def test_deposits_are_accounted_for(runs):
    """The three outcome counters sum to the leptons deposited in the
    timestep: the port's NT split leaves no deposited packet behind."""
    from artis_tpu_torch.packets import TYPE_NTALPHA_DEPOSITED, TYPE_NTLEPTON_DEPOSITED

    st = runs["st"]
    ptype = st.state.ptype.numpy()
    assert not np.any((ptype == TYPE_NTLEPTON_DEPOSITED) | (ptype == TYPE_NTALPHA_DEPOSITED))
    c = runs["counts"]["port"][1]
    from artis_tpu_torch import stats

    n = st.est.counters.numpy()
    assert n[stats.MA_STAT_ACTIVATION_NTCOLLION] == c[0]
    assert c.sum() == c[0] + c[1] + c[2] > 0


def test_timesteps_match_jax_in_mc_noise(runs):
    from artis_tpu.packets import TYPE_ESCAPE, TYPE_RPKT

    sj, st = runs["sj"], runs["st"]
    assert st.plasma_mode == "nlte" and st.sf_solves >= 1
    n_esc = int(sj._escaped_counted.sum())
    rel_close(float(sj.lc_lum.sum()), float(st.lc_lum.sum()), n_esc, "lc_lum")
    ptype = np.asarray(sj.state.ptype)
    n_r = int(np.sum((ptype == TYPE_RPKT) | ((ptype == TYPE_ESCAPE)
                                              & (np.asarray(sj.state.escape_type) == TYPE_RPKT))))
    a, b = np.asarray(sj.est.j), st.est.j.double().numpy()
    rel_close(float(a.sum()), float(b.sum()), n_r, "J")
    for c in np.argsort(a)[::-1][: max(1, a.size // 2)]:
        n_c = n_r * a[c] / a.sum()
        rel_close(float(a[c]), float(b[c]), n_c, f"J[{c}]")
        for f in ("Te", "nne"):
            fa = float(np.asarray(getattr(sj.cells, f))[c])
            fb = float(getattr(st.cells, f)[c])
            assert abs(np.log(fb / fa)) <= 4.0 / np.sqrt(n_c), (f, c, fa, fb)

"""The k-packet / macro-atom cycling of a hot, dense classic scene: the port
against the JAX package, on the CPU.

On the dense 8-shell model of tests/test_torch_deferred.py (logrho0 -6 at
1-2 days) the classic preset's timestep 0 takes over a thousand transport
iterations. A k-packet turns into a macro-atom by collisional excitation,
the macro-atom deactivates collisionally back into a k-packet, and only a
few tenths of a percent of the macro-atom activations end radiatively; a
packet can cycle for hundreds of iterations at one time, and the timestep
lasts as long as its longest chain. Here both packages run timestep 0 from
the same pellets (the JAX package in float64, the port in float32) on a 4^3
grid, for ``NCAP`` transport iterations each, and what decides the cost is
held within Monte Carlo noise (the 4/sqrt(n) rule of
tests/test_physics_validation.py): the packets still cycling at the cap,
the macro-atom activations, the share of them that ends radiatively, the
internal jumps per activation and the k-packet to r-packet conversions
(both packages keep the same counters, ``stats``).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_classic_cycling.py [NPKTS]

runs the same comparison without the cap, to the end of timestep 0, and
prints the iterations and counters of both (a few minutes)."""

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts

torch.set_num_threads(1)

NPKTS = 200
NCAP = 250
MODEL = dict(ncells=8, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-6.0,
             num_lte_timesteps=1)
GRID = dict(ncoordgrid_x=4, ncoordgrid_y=4, ncoordgrid_z=4)


def run_pair(tmp, npkts, ncap=None):
    """Timestep 0 of the classic preset in both packages from the same
    pellets, each transport loop stopped after ``ncap`` iterations (None:
    run to the end). Returns {"jax": ..., "port": ...} with each side's
    iterations, packets still active and counters."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.transport import engine as teng

    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp / side
        dirs[side].mkdir()
        make_run(str(dirs[side]), **MODEL)
    kw = dict(npkts=npkts, grid_type=jo.GridType.CARTESIAN3D, mintemp=1000.0, maxtemp=20000.0,
              tablesize=20, **GRID)
    if ncap is not None:
        # one transport chunk of ncap iterations, then the wall budget ends
        # the timestep (no tail buffers below 1024 packets)
        kw.update(dispatch_chunk_iters=ncap, transport_wall_budget=1e-9)
    jopts = jo.classic(**kw)
    sj = jd.Simulation(str(dirs["jax"]), jopts, datadir="/nonexistent")
    st = td.Simulation(str(dirs["port"]), port_opts(jopts, transport_dtype="float32",
                                                    transport_wall_budget=-1.0),
                       datadir="/nonexistent", device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    sj.do_timestep(0)
    orig = teng.transport_timestep
    if ncap is not None:
        teng.transport_timestep = lambda *a, **k: orig(*a, **dict(k, max_iters=ncap))
    try:
        st.do_timestep(0)
    finally:
        teng.transport_timestep = orig
    from artis_tpu.packets import TYPE_ESCAPE as J_ESC
    from artis_tpu_torch.packets import TYPE_ESCAPE as T_ESC

    t2 = float(sj.ts.start[0] + sj.ts.width[0])
    active = {"jax": int(np.sum((np.asarray(sj.state.ptype) != J_ESC)
                                & (np.asarray(sj.state.prop_time) < t2))),
              "port": int(((st.state.ptype != T_ESC) & (st.state.prop_time.double() < t2)).sum())}
    return {side: dict(iters=sim.transport_log[-1]["iters"], active=active[side],
                       counters=np.asarray(sim.est.counters, dtype=np.int64))
            for side, sim in (("jax", sj), ("port", st))}


def summary(c):
    """What decides the cost, from a side's counters."""
    from artis_tpu_torch import stats as s

    act = int(sum(c[i] for i in range(s.MA_STAT_ACTIVATION_COLLEXC, s.MA_STAT_ACTIVATION_FB + 1))
              + c[s.K_STAT_TO_MA_COLLEXC] + c[s.K_STAT_TO_MA_COLLION])
    rad = int(c[s.MA_STAT_DEACTIVATION_BB] + c[s.MA_STAT_DEACTIVATION_FB])
    jumps = int(c[s.MA_STAT_INTERNALUPHIGHER] + c[s.MA_STAT_INTERNALUPHIGHERNT]
                + c[s.MA_STAT_INTERNALDOWNLOWER])
    k2r = int(c[s.K_STAT_TO_R_FF] + c[s.K_STAT_TO_R_FB] + c[s.K_STAT_TO_R_BB])
    kfates = k2r + int(c[s.K_STAT_TO_MA_COLLEXC] + c[s.K_STAT_TO_MA_COLLION])
    return dict(activations=act, radiative=rad, jumps=jumps, k_to_r=k2r, kpkt_fates=kfates)


def rel_close(a, b, n, name):
    """|b - a| <= 4/sqrt(n) |a| (tests/test_torch_grid3d.py)."""
    assert n > 0, name
    tol = 4.0 / np.sqrt(n)
    assert abs(b - a) <= tol * abs(a), f"{name}: {a} vs {b} (tol {tol}, n={n})"


def same_rate(kj, nj, kt, nt, name):
    """Rates kj / nj (the JAX package) and kt / nt (the port) within the
    4/sqrt(n) rule, n the JAX package's count; where that count is 0, the
    port's is at most 16 (a count of 0 against one of n fails the rule
    above n = 16)."""
    assert nj > 0 and nt > 0, name
    if kj == 0:
        assert kt <= 16, f"{name}: 0 of {nj} vs {kt} of {nt}"
    else:
        rel_close(kj / nj, kt / nt, kj, name)


@pytest.fixture(scope="module")
def capped(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("cycling"), NPKTS, NCAP)


def test_both_packages_still_cycle_at_the_cap(capped):
    """Both loops ran the NCAP iterations with packets still in flight, as
    many on each side within noise: the timestep's cost, hundreds of
    iterations of cycling, is the JAX package's too."""
    j, t = capped["jax"], capped["port"]
    assert j["iters"] == t["iters"] == NCAP
    assert j["active"] > 0 and t["active"] > 0
    rel_close(j["active"], t["active"], j["active"], "packets active at the cap")


def test_macroatom_cycling_matches(capped):
    """Activations, their radiative share, internal jumps per activation and
    k-packet to r-packet conversions agree within Monte Carlo noise."""
    j, t = summary(capped["jax"]["counters"]), summary(capped["port"]["counters"])
    assert j["activations"] > 10 * NPKTS, j
    # the chains in flight and those that ended radiatively are the
    # independent draws behind the activation count
    rel_close(j["activations"], t["activations"], j["radiative"] + capped["jax"]["active"],
              "macro-atom activations")
    same_rate(j["radiative"], j["activations"], t["radiative"], t["activations"],
              "radiative deactivations per activation")
    same_rate(j["jumps"], j["activations"], t["jumps"], t["activations"],
              "internal jumps per activation")
    same_rate(j["k_to_r"], j["kpkt_fates"], t["k_to_r"], t["kpkt_fates"],
              "k-packet to r-packet conversions per k-packet")


if __name__ == "__main__":
    import sys
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_platforms", "cpu")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else NPKTS
    with tempfile.TemporaryDirectory() as d:
        res = run_pair(Path(d), n)
    for side, r in res.items():
        print(f"{side}: {r['iters']} transport iterations, {r['active']} packets active at the "
              f"end; {summary(r['counters'])}")

"""The macro-atom chains of the nebular scene with the non-thermal solver:
the port against the JAX package, on the CPU.

With the Spencer-Fano solve, the non-thermal ionisation moves the Fe of
the nebular scenes from Fe I to Fe II and Fe III, and its macro-atoms then
jump between the 260 levels of their ion for hundreds of jumps before they
deactivate. Here both packages run the nebular miniature with the Fe atom
of the chip scene (260 levels per ion, 101,010 lines) and the synthetic
non-thermal files: a 4-shell 1D model at 5-9 days on a 4^3 grid (two
nonempty cells), ``num_lte_timesteps=0``, so that timestep 0 is the
``first`` update and timestep 1 the first that solves Spencer-Fano, from
the same pellets (the JAX package in float64 with its Spencer-Fano solve
taken eagerly, ``test_torch_nonthermal_update.eager_spencerfano``; the port
in float32). Timestep 1 goes to ``NCAP`` transport iterations on each
side, one macro-atom jump an iteration (``ma_max_jumps_per_iter=1``) and
every macro-atom resolved in each iteration (``ma_compact_divisor=1``), so
that the jumps are the macro-atom passes that both sides count.

That the Fe goes to Fe III was checked by printing the ion fractions of
timestep 1's grid update (``python tests/test_torch_nt_chains.py``): Fe III
holds about 0.47 and 0.82 of the Fe in the two cells, Fe I about 0.03 and
0.006, in both packages; ``test_fe_goes_to_fe_iii`` holds it.

Held within Monte Carlo noise (the 4/sqrt(n) rule of
tests/test_physics_validation.py): the macro-atoms still active at the
cap, the activations, their radiative share, the jumps per activation,
and the ion fractions and T_e of the grid update. Before this test the
port's float32 grid update took the float32 atomic data: its T_e came out
near 4850 K where the JAX package's is 20000 K (maxtemp), and its chains
ended radiatively far more often; the grid update now takes the atomic
data in float64 (ROADMAP Queue 3).

    python tests/test_torch_nt_chains.py [NPKTS] [--cap N] [--no-nt]

(with PYTHONPATH=. and JAX_PLATFORMS=cpu) runs the same comparison
without the cap (or with ``--cap``), to the end of timestep 1, and prints
the iterations, ion fractions and counters of both; ``--no-nt`` runs it
without the non-thermal solver (the chip's nebular_1d_3dgrid_nont)."""

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run, write_synthetic_atomicdata
from test_torch_classic_cycling import rel_close, same_rate, summary
from test_torch_grid3d import np_fields, port_opts
from test_torch_nonthermal_update import eager_spencerfano

torch.set_num_threads(1)

NPKTS = 200
NCAP = 100
ATOM = dict(elements=((26, 3),), nlevels_per_ion=260)
MODEL = dict(ncells=4, ntimesteps=3, tmin_days=5.0, tmax_days=9.0, ngreyts=0, logrho0=-9.0,
             num_lte_timesteps=0)
OPT_KW = dict(ncoordgrid_x=4, ncoordgrid_y=4, ncoordgrid_z=4, mintemp=1000.0, maxtemp=20000.0,
              tablesize=20, rpkt_crossings_per_dispatch=16,
              detailed_bf_estimators_usefromtimestep=1, first_nlte_radfield_timestep=1,
              nlte_outer_iters=4, sf_points=64, ma_max_jumps_per_iter=1, ma_compact_divisor=1)


def _ion_fractions(levelpops, ad):
    """(ncells, nions) share of each ion in its element, from the levels."""
    lp = np.asarray(levelpops, dtype=np.float64)
    ls, nl = np.asarray(ad.ion_level_start), np.asarray(ad.ion_nlevels)
    pops = np.stack([lp[:, ls[i]:ls[i] + nl[i]].sum(axis=1) for i in range(len(nl))], axis=1)
    return pops / pops.sum(axis=1, keepdims=True)


def run_pair(tmp, npkts, ncap=None):
    """Timesteps 0-1 of both packages from the same pellets, timestep 1's
    transport stopped after ``ncap`` iterations (None: to its end).
    Returns {"jax": ..., "port": ...} with each side's timestep-1
    iterations, macro-atoms still active, macro-atom jumps, counters, ion
    fractions and T_e."""
    import jax
    import jax.numpy as jnp

    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu.transport.macroatom as jma
    import artis_tpu_torch.driver as td
    import artis_tpu_torch.transport.macroatom as tma
    from artis_tpu.packets import TYPE_ESCAPE as J_ESC
    from artis_tpu.packets import TYPE_MA as J_MA
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import TYPE_ESCAPE, TYPE_MA, PacketState
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data
    from artis_tpu_torch.transport import engine as teng

    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp / side
        dirs[side].mkdir()
        make_run(str(dirs[side]), **MODEL)
        write_synthetic_atomicdata(str(dirs[side]), **ATOM)
        write_synthetic_nonthermal_data(str(dirs[side]), ATOM["elements"])
    kw = dict(OPT_KW, npkts=npkts, grid_type=jo.GridType.CARTESIAN3D)
    if ncap is not None:
        # one transport chunk of ncap iterations, then the wall budget ends
        # the timestep (no tail buffers below 1024 packets)
        kw.update(dispatch_chunk_iters=ncap, transport_wall_budget=1e-9)
    jopts = jo.nltenebular(**kw)
    # one jump a pass: the jumps are the macro-atoms each pass takes
    jumps = {"jax": [], "port": []}
    j_orig, t_orig = jma.do_macroatom_batch, tma.do_macroatom_batch

    def j_counted(*a, **k):
        jax.debug.callback(lambda n: jumps["jax"].append(int(n)), jnp.sum(a[8]))
        return j_orig(*a, **k)

    def t_counted(*a, **k):
        jumps["port"].append(int(a[8].sum()))
        return t_orig(*a, **k)

    jma.do_macroatom_batch, tma.do_macroatom_batch = j_counted, t_counted
    try:
        sj = jd.Simulation(str(dirs["jax"]), jopts, datadir="/nonexistent")
        st = td.Simulation(str(dirs["port"]), port_opts(jopts, transport_dtype="float32",
                                                        transport_wall_budget=-1.0),
                           datadir="/nonexistent", device="cpu")
        st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
        orig = teng.transport_timestep
        with eager_spencerfano(sj):
            for nts in range(2):
                for v in jumps.values():
                    v.clear()
                sj.do_timestep(nts)
                if nts == 1 and ncap is not None:
                    teng.transport_timestep = lambda *a, **k: orig(*a, **dict(k, max_iters=ncap))
                try:
                    st.do_timestep(nts)
                finally:
                    teng.transport_timestep = orig
    finally:
        jma.do_macroatom_batch, tma.do_macroatom_batch = j_orig, t_orig
    st.close()
    t2 = float(sj.ts.start[1] + sj.ts.width[1])
    pj, tj = np.asarray(sj.state.ptype), np.asarray(sj.state.prop_time)
    pt, tt = st.state.ptype.numpy(), st.state.prop_time.double().numpy()
    out = {}
    for side, sim, ma, act in (
            ("jax", sj, (pj == J_MA) & (tj < t2), (pj != J_ESC) & (tj < t2)),
            ("port", st, (pt == TYPE_MA) & (tt < t2), (pt != TYPE_ESCAPE) & (tt < t2))):
        lp = sim._last_levelpops
        lp = lp.double().numpy() if torch.is_tensor(lp) else np.asarray(lp)
        te = sim.cells.Te
        out[side] = dict(iters=sim.transport_log[-1]["iters"], ma_active=int(ma.sum()),
                         active=int(act.sum()), jumps=int(sum(jumps[side])),
                         counters=np.asarray(sim.est.counters, dtype=np.int64),
                         ionfrac=_ion_fractions(lp, sim.ad),
                         Te=te.double().numpy() if torch.is_tensor(te) else np.asarray(te))
    return out


@pytest.fixture(scope="module")
def capped(tmp_path_factory):
    return run_pair(tmp_path_factory.mktemp("nt_chains"), NPKTS, NCAP)


def test_fe_goes_to_fe_iii(capped):
    """The non-thermal ionisation moves the Fe up, as on the card: in both
    packages Fe III holds over a third of the Fe of some cell, Fe I under a
    tenth of every cell's."""
    for side in ("jax", "port"):
        f = capped[side]["ionfrac"]
        assert f[:, 2].max() > 1 / 3 and f[:, 0].max() < 0.1, (side, f)


def test_grid_update_matches(capped):
    """Timestep 1's ion fractions and T_e agree within the noise of the
    timestep-0 estimators they come from (n = packets per nonempty cell)."""
    j, t = capped["jax"], capped["port"]
    n = NPKTS / j["Te"].size
    for c in range(j["Te"].size):
        rel_close(float(j["Te"][c]), float(t["Te"][c]), n, f"Te[{c}]")
        for i in range(j["ionfrac"].shape[1]):
            if j["ionfrac"][c, i] > 0.05:
                rel_close(float(j["ionfrac"][c, i]), float(t["ionfrac"][c, i]), n,
                          f"ion fraction [{c}, {i}]")


def test_both_packages_still_jump_at_the_cap(capped):
    """Both loops ran the NCAP iterations with macro-atoms still jumping,
    as many on each side within noise: the long chains are the JAX
    package's too."""
    j, t = capped["jax"], capped["port"]
    assert j["iters"] == t["iters"] == NCAP
    assert j["ma_active"] > 0 and t["ma_active"] > 0
    rel_close(j["ma_active"], t["ma_active"], j["ma_active"], "macro-atoms active at the cap")


def test_chains_match(capped):
    """Activations, their radiative share and the jumps per activation
    agree within Monte Carlo noise."""
    j, t = capped["jax"], capped["port"]
    sj, stt = summary(j["counters"]), summary(t["counters"])
    # the chains in flight and those that ended radiatively are the
    # independent draws behind the activation count
    rel_close(sj["activations"], stt["activations"], sj["radiative"] + j["ma_active"],
              "macro-atom activations")
    same_rate(sj["radiative"], sj["activations"], stt["radiative"], stt["activations"],
              "radiative deactivations per activation")
    assert j["jumps"] > 10 * sj["activations"], (j["jumps"], sj)
    rel_close(j["jumps"] / sj["activations"], t["jumps"] / stt["activations"],
              sj["activations"], "jumps per activation")


if __name__ == "__main__":
    import sys
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    if "--no-nt" in args:
        args.remove("--no-nt")
        OPT_KW.update(nt_on=False, nt_solve_spencerfano=False)
    cap = None
    if "--cap" in args:
        i = args.index("--cap")
        cap = int(args[i + 1])
        del args[i:i + 2]
    n = int(args[0]) if args else NPKTS
    with tempfile.TemporaryDirectory() as d:
        res = run_pair(Path(d), n, cap)
    for side, r in res.items():
        print(f"{side}: timestep 1 took {r['iters']} transport iterations and "
              f"{r['jumps']} macro-atom jumps; {r['ma_active']} macro-atoms and {r['active']} "
              f"packets active at the end; T_e {r['Te'].tolist()}; ion fractions "
              f"{np.round(r['ionfrac'], 4).tolist()}; {summary(r['counters'])}")

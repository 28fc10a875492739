"""Parity of the port's r-packet crossing kernel (its plain PyTorch version,
reached through the port's rpkt_step) with the JAX package: the Pallas
kernel in interpret mode with injected draws (_PALLAS_TEST_INJECT), and the
XLA propagation path with injected tag-51 optical depths.

Tolerances are those of tests/test_pallas_rpkt.py: lane outcomes (cell,
packet type, macro-atom activation) agree on > 97% of lanes, float state on
agreeing lanes to rtol 2e-3 (float32 port vs float64 reference), estimator
totals to 5e-3, LUT gamma / bf-heating to 1e-2 and crossing counts within
2% + 3. The residual disagreement comes from float32 boundary ties and from
the event pass, whose own draws (bf -> macro-atom split) come from each
package's generator. The CUDA kernel itself is checked against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artis_tpu.transport.engine as jeng
from artis_tpu.packets import TYPE_RPKT
from artis_tpu.synthdata import make_run

torch.set_num_threads(1)

NPKTS = 512
OPT_KW = dict(npkts=NPKTS, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
              linewalk_chunk=128, rpkt_crossings_per_dispatch=4)


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    d = str(tmp_path_factory.mktemp("torch_rpkt"))
    make_run(d, ncells=8, ntimesteps=4, tmin_days=2.0, tmax_days=4.0, ngreyts=0, logrho0=-8.0)
    opts = jo.kilonova_lte(grid_type=jo.GridType.SPHERICAL1D, pallas_block=256, **OPT_KW)
    sim = jd.Simulation(d, opts, datadir="/nonexistent")
    ctx = sim.update_grid(0)
    return dict(sim=sim, opts=opts, ctx=ctx, est=sim._zero_est())


def _forced_state(sc, seed=0, nu_logrange=(14.2, 15.4)):
    """In-flight r-packets spread over the grid (tests/test_pallas_rpkt.py)."""
    rng = np.random.default_rng(seed)
    sim, ctx = sc["sim"], sc["ctx"]
    grid = sim.grid
    st = sim.state
    n = st.npkts
    t0 = float(ctx.ts)
    ncell = int(grid.ncoordgrid[0])
    cell = rng.integers(0, ncell, n)
    rmin = np.asarray(grid.cell_pos_min[:ncell, 0]) * t0 / float(grid.tmin)
    rmax = np.asarray(grid.cell_pos_max[:ncell, 0]) * t0 / float(grid.tmin)
    r = rmin[cell] + (rmax[cell] - rmin[cell]) * rng.uniform(0.02, 0.98, n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(*nu_logrange, n)
    f64 = np.float64
    return st.replace(
        ptype=jnp.full(n, TYPE_RPKT, jnp.int32), pos=jnp.asarray(u * r[:, None], f64),
        dir=jnp.asarray(d, f64), where=jnp.asarray(cell, jnp.int32),
        prop_time=jnp.full(n, t0, f64), nu_rf=jnp.asarray(nu, f64),
        nu_cmf=jnp.asarray(nu * 0.98, f64), e_rf=jnp.ones(n, f64),
        e_cmf=jnp.full(n, 0.98, f64), next_trans=jnp.zeros(n, jnp.int32))


def _port_inputs(sc, st):
    import artis_tpu_torch.options as to
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.estimators import Estimators
    from artis_tpu_torch.grid import GridData
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.transport.engine import StepContext

    # the port's crossing in float32: its state, estimators and tables are
    # demoted as its driver demotes them; the grid stays float64
    sim = sc["sim"]
    f32 = torch.float32
    return dict(
        st=interop.from_numpy(PacketState, _np_fields(st), dtype=f32),
        est=interop.from_numpy(Estimators, _np_fields(sc["est"]), dtype=f32),
        ctx=interop.from_numpy(StepContext, _np_fields(sc["ctx"]), dtype=f32),
        grid=interop.from_numpy(GridData, _np_fields(sim.grid), dtype=torch.float64),
        dad=interop.from_numpy(DeviceAtomicData, _np_fields(sim.dad), dtype=f32),
        cells=interop.from_numpy(CellState, _np_fields(sim.cells), dtype=f32),
        opts=to.kilonova_lte(grid_type=to.GridType.SPHERICAL1D, transport_dtype="float32",
                             **OPT_KW))


def _run_port(sc, st, tau, sel, max_inner):
    from artis_tpu_torch.transport import engine as teng

    p = _port_inputs(sc, st)
    opts = p["opts"].replace(rpkt_crossings_per_dispatch=max_inner)
    draws = (torch.as_tensor(tau, dtype=torch.float32), torch.as_tensor(sel, dtype=torch.float32))
    return teng.rpkt_step((7,), p["st"], p["est"], p["ctx"], p["grid"], p["dad"], p["cells"],
                          opts, 4, test_draws=draws)


def test_float64_crossing_raises(scene):
    """The crossing runs in float32 and in float64 (the default
    transport_dtype): a float64 step runs in float64, not in float32 behind
    the caller's back, and any other transport dtype still raises
    (tests/test_torch_float64.py holds the float64 crossing to the XLA
    path)."""
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.transport import engine as teng

    st0 = _forced_state(scene)
    p = _port_inputs(scene, st0)
    st64 = interop.from_numpy(PacketState, _np_fields(st0), dtype=torch.float64)
    st, est, *_, nadv = teng.rpkt_step((7,), st64, p["est"], p["ctx"], p["grid"], p["dad"],
                                       p["cells"], p["opts"].replace(transport_dtype="float64"),
                                       4)
    assert st.pos.dtype == torch.float64 and nadv > 0
    assert (st.where != st64.where).any()
    with pytest.raises(NotImplementedError, match="transport_dtype"):
        teng.rpkt_step((7,), p["st"], p["est"], p["ctx"], p["grid"], p["dad"], p["cells"],
                       p["opts"].replace(transport_dtype="float16"), 4)


def _run_pallas(sc, st, tau, sel, max_inner):
    opts = sc["opts"].replace(rpkt_crossings_per_dispatch=max_inner, use_pallas_rpkt=True)
    jeng._PALLAS_TEST_INJECT = (jnp.asarray(tau), jnp.asarray(sel))
    try:
        return jeng.rpkt_step_pallas(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"],
                                     sc["sim"].grid, sc["sim"].dad, sc["sim"].cells, opts, 4)
    finally:
        jeng._PALLAS_TEST_INJECT = None


def _run_xla(sc, st, tau_u, max_inner):
    opts = sc["opts"].replace(rpkt_crossings_per_dispatch=max_inner)
    orig = jeng._uniform

    def patched(key, tag, n, dtype):
        if tag == 51:
            return jnp.asarray(tau_u, dtype)
        return orig(key, tag, n, dtype)

    jeng._uniform = patched
    try:
        return jeng.rpkt_step(jax.random.PRNGKey(1), st, sc["est"], sc["ctx"], sc["sim"].grid,
                              sc["sim"].dad, sc["sim"].cells, opts, 4)
    finally:
        jeng._uniform = orig


def _assert_parity(out_j, out_t, est_names=("j", "nuj", "ffheating")):
    st_j, est_j, mam_j = out_j[0], out_j[1], np.asarray(out_j[2])
    st_t, est_t, mam_t = out_t[0], out_t[1], out_t[2].numpy()
    nadv_j, nadv_t = int(out_j[-1]), int(out_t[-1])
    wj, wt = np.asarray(st_j.where), st_t.where.numpy()
    pj, pt = np.asarray(st_j.ptype), st_t.ptype.numpy()
    assert np.mean(wj == wt) > 0.97, np.mean(wj == wt)
    assert np.mean(pj == pt) > 0.97, np.mean(pj == pt)
    both = (wj == wt) & (pj == pt)
    for name in ("prop_time", "nu_cmf", "e_cmf"):
        a = np.asarray(getattr(st_j, name))[both]
        b = getattr(st_t, name).numpy()[both]
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=1e-30, err_msg=name)
    px, pp = np.asarray(st_j.pos)[both], st_t.pos.numpy()[both]
    scale = np.maximum(np.linalg.norm(px, axis=1, keepdims=True), 1e-30)
    assert np.max(np.abs(px - pp) / scale) < 2e-3
    assert np.mean(mam_j[both] == mam_t[both]) > 0.97
    for name in est_names:
        a = np.asarray(getattr(est_j, name)).sum()
        b = getattr(est_t, name).numpy().sum()
        assert b == pytest.approx(a, rel=5e-3), name
    assert abs(nadv_j - nadv_t) <= max(3, 0.02 * nadv_j + 3)


@pytest.mark.parametrize("max_inner", [1, 4])
def test_plain_kernel_matches_pallas_kernel(scene, max_inner):
    st0 = _forced_state(scene)
    rng = np.random.default_rng(42)
    tau = -np.log(rng.uniform(0.05, 0.95, NPKTS)).astype(np.float32)
    sel = np.full(NPKTS, 0.5, np.float32)
    _assert_parity(_run_pallas(scene, st0, tau, sel, max_inner),
                   _run_port(scene, st0, tau, sel, max_inner))


@pytest.mark.parametrize("max_inner", [1, 4])
def test_plain_kernel_matches_xla_path(scene, max_inner):
    st0 = _forced_state(scene)
    rng = np.random.default_rng(42)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    _assert_parity(_run_xla(scene, st0, tau_u, max_inner),
                   _run_port(scene, st0, tau, sel, max_inner))


def test_lut_estimators_match_pallas(scene):
    """Frequencies inside the bf windows so the LUT estimators accumulate."""
    st0 = _forced_state(scene, seed=3, nu_logrange=(15.45, 15.95))
    tau = np.full(NPKTS, -np.log(0.5), np.float32)
    sel = np.full(NPKTS, 0.5, np.float32)
    _, est_j, *_ = _run_pallas(scene, st0, tau, sel, 2)
    _, est_t, *_ = _run_port(scene, st0, tau, sel, 2)
    for name in ("gammaestimator", "bfheatingestimator"):
        a = np.asarray(getattr(est_j, name)).sum()
        b = getattr(est_t, name).numpy().sum()
        assert a > 0, name
        assert b == pytest.approx(a, rel=1e-2), name


def test_thick_line_just_passed_activates_macroatom(scene):
    """Immortal-packet regression (tests/test_pallas_rpkt.py): a packet a few
    float32 ulps below an optically thick line it is cursored on takes a
    zero-distance bound-bound event instead of scattering forever."""
    sim, ctx = scene["sim"], scene["ctx"]
    tau_fac = np.asarray(ctx.tau_sob_factor)
    cell, line = np.unravel_index(np.argmax(tau_fac), tau_fac.shape)
    t0 = float(ctx.ts)
    assert tau_fac[cell, line] * t0 > 100.0, "scene has no thick line"
    st0 = _forced_state(scene)
    nu_line = float(np.asarray(sim.dad.line_nu)[line])
    r = 0.5 * (float(sim.grid.cell_pos_min[cell, 0]) + float(sim.grid.cell_pos_max[cell, 0])) \
        * t0 / float(sim.grid.tmin)
    pos = np.array([0.0, 0.0, r])
    dirv = np.array([0.6, 0.0, 0.8])
    from artis_tpu.constants import CLIGHT

    dop = (1.0 - float(dirv @ pos) / t0 / CLIGHT) / np.sqrt(1.0 - (r / t0) ** 2 / CLIGHT**2)
    nu_cmf = np.float32(nu_line) * (1.0 - 3e-7)

    def set0(arr, val):
        a = np.asarray(arr).copy()
        a[0] = val
        return jnp.asarray(a)

    st0 = st0.replace(pos=set0(st0.pos, pos), dir=set0(st0.dir, dirv),
                      where=set0(st0.where, cell), nu_cmf=set0(st0.nu_cmf, nu_cmf),
                      nu_rf=set0(st0.nu_rf, nu_cmf / dop), next_trans=set0(st0.next_trans, line),
                      prop_time=set0(st0.prop_time, t0))
    tau = np.full(NPKTS, -np.log(0.5), np.float32)
    sel = np.full(NPKTS, 0.5, np.float32)
    _, _, mam_j, _, mal_j, _ = _run_pallas(scene, st0, tau, sel, 1)
    st_t, _, mam_t, _, mal_t, _ = _run_port(scene, st0, tau, sel, 1)
    assert bool(np.asarray(mam_j)[0]) and bool(mam_t[0])
    assert int(np.asarray(mal_j)[0]) == line == int(mal_t[0])
    assert int(st_t.next_trans[0]) == line + 1



def _mutate(out, kind):
    """A copy of the crossing outputs with one fault a wrong kernel could
    make; compare_outputs must reject each."""
    o = {f: v.clone() for f, v in out.items()}
    bb = o["is_bb"] > 0
    if kind == "act_line":  # the line after the activating one
        o["act_line"] = torch.where(bb, o["act_line"] + 1, o["act_line"])
    elif kind == "bf_idx":
        o["bf_idx"] = torch.where(o["evented"] > 0, o["bf_idx"] + 1, o["bf_idx"])
    elif kind == "chi_bf":
        o["chi_bf"] = torch.where(o["evented"] > 0, o["chi_bf"] * 1.01 + 1e-30, o["chi_bf"])
    elif kind == "dir":
        o["dirx"], o["diry"] = o["diry"].clone(), o["dirx"].clone()
    elif kind == "j_wrong_cell":  # J of each cell added to its neighbour
        o["est"][:, 0] = torch.roll(o["est"][:, 0], 1)
    elif kind == "gamma":
        o["gamma"] = o["gamma"] * 1.05
    elif kind == "nesc":
        o["misc"][1] += 10
    elif kind == "cell_1pct":  # every 100th lane sent on to the next cell
        o["where"][::100] += 1
    elif kind == "radbin_shift":  # every bin's J, nuJ and count in the next bin
        o["radbin"] = torch.roll(o["radbin"], 1, dims=2)
    elif kind == "jblue_column":  # every line's J_b_lu in the next line's column
        o["jblue"] = torch.roll(o["jblue"], 1, dims=2)
    elif kind == "jblue_no_activating_line":  # bound-bound events miss their own line
        ev = bb & (o["evented"] > 0)
        o["jblue"][o["mgi"][ev].long(), 1, o["act_line"][ev].long()] -= 1.0
    return o


def _tiled(out, reps):
    """The crossing outputs of ``reps`` copies of every lane (the per-cell
    rows and counters as they were)."""
    from artis_tpu_torch.transport import rpkt_kernel

    lane = set(rpkt_kernel.OUT_F32 + rpkt_kernel.OUT_I32)
    return {f: (v.repeat(reps) if f in lane else v) for f, v in out.items()}


def _faulty_launch(rpkt_kernel, bad_ids, j_ids):
    """A stand-in for the card's launch: the plain version, except that the
    moving lanes whose lane_id is in ``bad_ids`` end one line further on
    (a lane tipped by a near-tie, which check_kernel holds still), and the
    moving lanes in ``j_ids`` count their cell's J 5 % high while every
    integer output of theirs agrees (a fault that no lane output shows)."""
    def launch(seed, lanes, tables, *args, shared_rows=None, **kw):
        o = rpkt_kernel.propagate_reference(seed, lanes, tables, *args, **kw)
        moving = lanes["moving"] > 0
        bad = torch.nonzero(moving & torch.isin(lanes["lane_id"], bad_ids))[:, 0]
        o["next_trans"][bad] += 1
        jl = torch.nonzero(moving & torch.isin(lanes["lane_id"], j_ids))[:, 0]
        mgi = tables["mgi_of_cell"][o["where"][jl].clamp(min=0).long()].long()
        o["est"][mgi[mgi >= 0], 0] *= 1.05
        return o
    return launch


@pytest.mark.parametrize("kind", [None, "act_line", "bf_idx", "chi_bf", "dir", "j_wrong_cell",
                                  "gamma", "nesc", "cell_1pct", "radbin_shift", "jblue_column",
                                  "jblue_no_activating_line", "j_on_next_trans_lanes"])
def test_compare_outputs_rejects_each_fault(scene, kind, monkeypatch):
    """The kernel-vs-plain check of the card (rpkt_kernel.compare_outputs)
    accepts identical outputs and rejects a wrong activating line, bf
    continuum, opacity, direction, per-cell J, gamma estimator or counter,
    1% of 65536 lanes sent to a wrong cell (a geometry fault that a 97% cell
    agreement would let pass), a wrong radiation-field bin, a wrong J_b_lu
    column and J_b_lu sums that miss the activating line of bound-bound
    events (every line is a J_b_lu column here); and check_kernel accepts
    a few lanes that end on another line (held still for the estimator
    comparison, ``held_lanes``) but rejects, beside them, a J error of a
    few lanes whose every integer output agrees."""
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport import rpkt_kernel

    # frequencies across the bf windows, so bf opacities and gamma accumulate
    p = _port_inputs(scene, _forced_state(scene, seed=3, nu_logrange=(14.2, 15.95)))
    ctx, dad = p["ctx"], p["dad"]
    _, lanes = teng.rpkt_lanes(p["st"], ctx.t2)
    n = lanes["posx"].shape[0]
    rng = np.random.default_rng(5)
    tables = rpkt_kernel.kernel_tables(dad, p["grid"], p["cells"], ctx)
    tables["jblue_of_line"] = torch.arange(dad.nlines, dtype=torch.int32)
    args = (1, lanes, tables,
            torch.as_tensor(-np.log(rng.uniform(0.05, 0.95, n)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0.0, 1.0, n).astype(np.float32)), float(ctx.t2),
            float(ctx.tmin), float(p["grid"].max_path_step))
    kw = dict(nlines=dad.nlines, ncells=p["cells"].Te.shape[0],
              ngc=max(dad.nbfcontinua_ground, 1), nphixs=dad.nphixspoints, max_inner=4,
              relativistic=p["opts"].use_relativistic_doppler_shift,
              phixs_dnu=float(dad.nphixsnuincrement),
              last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=True, nradbins=32,
              njblue=dad.nlines)
    if kind == "j_on_next_trans_lanes":
        # 8 copies of every lane, so that 2 faulty lanes stay within the
        # 0.1 % of lanes whose integer outputs may differ
        big = {f: v.repeat(8) for f, v in lanes.items()}
        big["lane_id"] = torch.arange(8 * n, dtype=torch.int32)
        args = args[:1] + (big, tables, args[3].repeat(8), args[4].repeat(8)) + args[5:]
        moving_ids = big["lane_id"][big["moving"] > 0]
        bad_ids, j_ids = moving_ids[:2], moving_ids[2:4]
        for faulty_j, expect_ok in ((j_ids[:0], True), (j_ids, False)):
            monkeypatch.setattr(rpkt_kernel, "_launch",
                                _faulty_launch(rpkt_kernel, bad_ids, faulty_j))
            ok, rep, k, out = rpkt_kernel.check_kernel(*args, **kw)
            assert int((k["next_trans"] != out["next_trans"]).sum()) == 2
            assert rep["diverged_lanes"] == 0 and rep["next_trans_agree"] >= 0.999
            assert rep["held_lanes"] == 2
            assert ok == expect_ok, rep
        return
    out = rpkt_kernel.propagate_reference(*args, **kw)
    assert int((out["is_bb"] > 0).sum()) > 0 and float(out["gamma"].sum()) > 0
    assert float(out["radbin"][:, 2].sum()) > 0 and float(out["jblue"][:, 1].sum()) > 0
    if kind == "cell_1pct":
        out = _tiled(out, 65536 // n)
    ok, rep = rpkt_kernel.compare_outputs(_mutate(out, kind), out)
    assert ok == (kind is None), rep


def _count_moving_launch(rpkt_kernel, adds):
    """A stand-in for the card's launch: the plain version, except that for
    each (lane_ids, row, line, passes) of ``adds`` each moving lane whose
    lane_id is among them counts ``passes`` J_b_lu passes more of ``line``
    (in estimator row ``row``, or where None in the row of the cell it ends
    in) while every lane output of its agrees."""
    def launch(seed, lanes, tables, *args, shared_rows=None, **kw):
        o = rpkt_kernel.propagate_reference(seed, lanes, tables, *args, **kw)
        for ids, row, line, passes in adds:
            lane = torch.nonzero((lanes["moving"] > 0) & torch.isin(lanes["lane_id"], ids))[:, 0]
            mgi = tables["mgi_of_cell"][o["where"][lane].clamp(min=0).long()].long()
            if row is not None:
                mgi = torch.full_like(mgi, row)
            o["jblue"][:, 1, line].index_add_(0, mgi[mgi >= 0],
                                              torch.full((int((mgi >= 0).sum()),), passes))
        return o
    return launch


# the shell the near-tie case empties (no estimator row)
EMPTY_SHELL = 5


def _near_tie(rpkt_kernel, args, kw):
    """Tables on which a lane's J_b_lu pass can tie with a boundary to an
    empty cell: shell EMPTY_SHELL emptied (``mgi_of_cell`` -1), and the
    first line below the cmf frequency at which some lane crosses into it
    from a shell with rows moved onto that frequency and made transparent
    (the lane's path is unchanged). Returns (tables, the lane's lane_id,
    the row of the shell it leaves, the line)."""
    tables = dict(args[2], mgi_of_cell=args[2]["mgi_of_cell"].clone(),
                  line_nu=args[2]["line_nu"].clone(), tau_factor=args[2]["tau_factor"].clone())
    mgi = tables["mgi_of_cell"].long()
    tables["mgi_of_cell"][EMPTY_SHELL] = -1
    log = []
    rpkt_kernel.propagate_reference(args[0], args[1], tables, *args[3:], crossing_log=log, **kw)
    for taken, cell, snext, nu_at, _ in log:
        hit = torch.nonzero(taken & (snext == EMPTY_SHELL) & (cell != EMPTY_SHELL))[:, 0]
        if hit.numel():
            i = int(hit[0])
            break
    line_nu = tables["line_nu"]
    assert bool((line_nu[:-1] >= line_nu[1:]).all())
    line = int(torch.searchsorted(-line_nu, -nu_at[i]))
    line_nu[line] = nu_at[i]
    tables["tau_factor"][:, line] = 0.0
    return tables, args[1]["lane_id"][i:i + 1], int(mgi[cell[i]]), line


@pytest.mark.parametrize("case, nfaulty", [("tie", 1), ("tie+moved", 2), ("tie off the line", 1),
                                           ("elsewhere", 2), ("tie+elsewhere", 2),
                                           ("elsewhere", 17)])
def test_check_kernel_holds_lanes_whose_counts_alone_differ(scene, case, nfaulty, monkeypatch):
    """check_kernel finds the lanes whose own J_b_lu count differs while
    every lane output agrees (``count_lanes``, by halves) and holds them
    still only where each is a near-tie at a boundary to a cell that counts
    nothing (``moved_to_nothing``): a line at the frequency where the lane
    enters an empty shell, counted in the shell it leaves. A lane whose
    pass only moved between two shells is left to compare_outputs, which
    allows it. A pass of
    another line in that shell, a pass added anywhere else (line 0 in the
    lane's last cell), alone or beside such a tie, fails the comparison,
    as do more such lanes than the tolerance's diverged lanes (16 in
    float32)."""
    from artis_tpu_torch.transport import engine as teng
    from artis_tpu_torch.transport import rpkt_kernel

    p = _port_inputs(scene, _forced_state(scene, seed=3, nu_logrange=(14.2, 15.95)))
    ctx, dad = p["ctx"], p["dad"]
    _, lanes = teng.rpkt_lanes(p["st"], ctx.t2)
    n = lanes["posx"].shape[0]
    rng = np.random.default_rng(5)
    tables = rpkt_kernel.kernel_tables(dad, p["grid"], p["cells"], ctx)
    tables["jblue_of_line"] = torch.arange(dad.nlines, dtype=torch.int32)
    args = (1, lanes, tables,
            torch.as_tensor(-np.log(rng.uniform(0.05, 0.95, n)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0.0, 1.0, n).astype(np.float32)), float(ctx.t2),
            float(ctx.tmin), float(p["grid"].max_path_step))
    kw = dict(nlines=dad.nlines, ncells=p["cells"].Te.shape[0],
              ngc=max(dad.nbfcontinua_ground, 1), nphixs=dad.nphixspoints, max_inner=4,
              relativistic=p["opts"].use_relativistic_doppler_shift,
              phixs_dnu=float(dad.nphixsnuincrement),
              last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=True, nradbins=32,
              njblue=dad.nlines)
    moving = lanes["lane_id"][lanes["moving"] > 0]
    adds = []
    if case.startswith("tie"):
        tables, tie_id, row, line = _near_tie(rpkt_kernel, args, kw)
        args = args[:2] + (tables,) + args[3:]
        if case.endswith("off the line"):
            line = dad.nlines - 1 if line == 0 else 0
        adds.append((tie_id, row, line, 1.0))
        moving = moving[moving != tie_id]
    if case.endswith("moved"):
        adds += [(moving[:1], 0, 0, 1.0), (moving[:1], 1, 0, -1.0)]
    if case.endswith("elsewhere"):
        adds.append((moving[:nfaulty - len(adds)], None, 0, 1.0))
    monkeypatch.setattr(rpkt_kernel, "_launch", _count_moving_launch(rpkt_kernel, adds))
    ok, rep, k, out = rpkt_kernel.check_kernel(*args, **kw)
    assert rep["diverged_lanes"] == 0 and rep["next_trans_agree"] == 1.0
    assert ok == (case in ("tie", "tie+moved")), rep
    assert rep["count_held_lanes"] == (1 if ok else 0)
    assert rep["held_lanes"] == rep["count_held_lanes"]
    unexplained = {"tie": 0, "tie+moved": 0, "tie off the line": 1, "tie+elsewhere": 1}
    assert rep["count_lanes_unexplained"] == unexplained.get(
        case, -1 if nfaulty > rpkt_kernel.DIVERGED_MIN else nfaulty)

"""Runs of the port that repeat, and the host sums that make timestep 0
of two same-seed runs repeat on the card (the CUDA kernel itself is
checked on the card by tests/test_torch_cuda.py and chip_smoke.py).

The scenes are the nebular miniature of tests/test_torch_nlte.py (a 5-shell
1D model on an 8^3 Cartesian grid, nltenebular without the non-thermal
solver, the multibin field and the bf-rate and J_b_lu estimators) and the
same model on its 1D grid under kilonova_lte, cut to a few hundred
packets:

- two runs with the same seed are bitwise identical: packet state,
  estimators and cells after each of timesteps 0-1;
- ``engine.rpkt_step`` with the lanes sorted by (model cell, cursor)
  gives every packet the same state, bit for bit, as with the lanes in
  packet order, the main path's (each lane draws from its own packet
  number); the estimators agree to rel 1e-5, as ``index_add_`` sums them
  in another order;
- ``devutil.sorted_index_add_`` (the host sums' CUDA formulation, whose
  order does not change from call to call) matches index_add_ to rtol
  1e-12 in float64 (1e-5 in float32), into whole tensors and into strided
  views, along any dimension.
"""

import dataclasses

import numpy as np
import pytest
import torch

from artis_tpu_torch import options
from artis_tpu_torch.synthdata import make_run

torch.set_num_threads(1)

MAKE = dict(ncells=5, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-7.0,
            num_lte_timesteps=1)
OPT_KW = dict(npkts=300, grid_type=options.GridType.CARTESIAN3D, ncoordgrid_x=8,
              ncoordgrid_y=8, ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20,
              linewalk_chunk=64, rpkt_crossings_per_dispatch=16, radfieldbincount=32,
              detailed_bf_estimators_usefromtimestep=1, first_nlte_radfield_timestep=1,
              nlte_outer_iters=3, transport_dtype="float32")


def _sim(d, scene="nebular", **kw):
    from artis_tpu_torch.driver import Simulation

    d.mkdir()
    make_run(str(d), **MAKE)
    if scene == "lte_1d":
        opts = options.kilonova_lte(**dict(OPT_KW, grid_type=options.GridType.SPHERICAL1D,
                                           **kw))
    else:
        opts = options.nltenebular(nt_on=False, nt_solve_spencerfano=False,
                                   **dict(OPT_KW, **kw))
    return Simulation(str(d), opts, device="cpu")


def _assert_bitwise(a, b, what):
    for f in dataclasses.fields(a):
        x = getattr(a, f.name)
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(getattr(b, f.name), x, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{what}.{f.name}")


def _repeat(tmp_path, scene):
    sims = [_sim(tmp_path / f"run{i}", scene) for i in range(2)]
    for nts in range(2):
        for s in sims:
            s.do_timestep(nts)
        a, b = sims
        assert a.transport_log[-1]["steps"] == b.transport_log[-1]["steps"] > 0
        _assert_bitwise(a.state, b.state, "state")
        _assert_bitwise(a.est, b.est, "est")
        _assert_bitwise(a.cells, b.cells, "cells")
    if scene == "nebular":
        assert float(sims[0].est.jblue_count.sum()) > 0
    for s in sims:
        s.close()


def test_same_seed_runs_repeat_bitwise(tmp_path):
    _repeat(tmp_path, "nebular")


def test_same_seed_lte_1d_runs_repeat_bitwise(tmp_path):
    _repeat(tmp_path, "lte_1d")


@pytest.fixture(scope="module")
def inflight(tmp_path_factory):
    """The miniature after timestep 0, with timestep 1's grid update: the
    r-packets timestep 0 left in flight."""
    sim = _sim(tmp_path_factory.mktemp("inflight") / "run", npkts=600)
    sim.do_timestep(0)
    ctx = sim.update_grid(1)
    yield sim, ctx
    sim.close()


def test_rpkt_step_lane_order(inflight, monkeypatch):
    from artis_tpu_torch.transport import engine

    sim, ctx = inflight
    args = (sim.grid, sim.dad, sim.cells, sim.opts, int(sim.params.opacity_case))
    key = (sim.seed, 4242)
    packet_out = engine.rpkt_step(key, sim.state, sim._zero_est(), ctx, *args)
    packet_order = engine.rpkt_lanes
    mgi_of_cell = sim.grid.nonemptymgi_of_cell
    sorted_idx = []

    def sorted_lanes(st, t2):
        """The lanes sorted by (model cell, cursor)."""
        idx, _ = packet_order(st, t2)
        perm = torch.sort((mgi_of_cell[st.where[idx]] + 1) * 2 ** 32 + st.next_trans[idx] + 1,
                          stable=True).indices
        sorted_idx.append(idx[perm])
        lanes = {k: v[perm].contiguous() for k, v in packet_order(st, t2)[1].items()}
        return idx[perm], lanes

    monkeypatch.setattr(engine, "rpkt_lanes", sorted_lanes)
    sorted_out = engine.rpkt_step(key, sim.state, sim._zero_est(), ctx, *args)
    idx_p, _ = packet_order(sim.state, ctx.t2)
    assert idx_p.numel() > 20 and not torch.equal(sorted_idx[0], idx_p)
    _assert_bitwise(sorted_out[0], packet_out[0], "state")
    for a, b in zip(sorted_out[2:5], packet_out[2:5]):
        assert torch.equal(a, b)
    assert sorted_out[5] == packet_out[5] > 0
    est_s, est_p = sorted_out[1], packet_out[1]
    for f in dataclasses.fields(est_s):
        x, y = getattr(est_s, f.name), getattr(est_p, f.name)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max() + 1e-300),
                                       msg=f.name)
    assert float(est_s.j.sum()) > 0 and float(est_s.jblue_count.sum()) > 0


@pytest.mark.parametrize("shape,dim,view,dtype", [
    ((5, 40), 1, None, torch.float64), ((300, 3), 0, None, torch.float64),
    ((4, 30, 6), 1, 2, torch.float64), ((6, 7, 7), 1, "flat", torch.float64),
    ((3, 4, 50), 2, None, torch.float64), ((64,), 0, None, torch.float64),
    ((8, 20), 1, None, torch.float32)])
def test_sorted_index_add_matches(shape, dim, view, dtype):
    """Into a whole tensor along any dimension, into a strided view as
    transitionrates adds into ma[:, :, action], into a flattened view as
    nltepop._add does, and in float32."""
    from artis_tpu_torch.devutil import index_add, sorted_index_add_

    rng = np.random.default_rng(4)
    base = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
    ref = base.clone()
    if view == "flat":
        tgt = lambda b: b.view(b.shape[0], -1)
    elif view is not None:
        tgt = lambda b: b[:, :, view]
    else:
        tgt = lambda b: b
    n = tgt(base).shape[dim]
    index = torch.as_tensor(rng.integers(0, n, 3 * n))
    src_shape = list(tgt(base).shape)
    src_shape[dim] = index.numel()
    source = torch.as_tensor(rng.normal(size=src_shape), dtype=dtype)
    tgt(ref).index_add_(dim, index, source)
    out = sorted_index_add_(tgt(base), dim, index, source)
    assert out.data_ptr() == tgt(base).data_ptr()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(base, ref, rtol=tol, atol=tol)
    # the CPU keeps index_add
    assert torch.equal(index_add(tgt(base), dim, index, source),
                       tgt(base).index_add(dim, index, source))

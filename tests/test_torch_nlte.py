"""The ``nlte`` grid update with NLTE populations (nltenebular with the
non-thermal solver off) and the runs around it, the port against the JAX
package on the CPU.

The scene is the reference CI's nebular_1d_3dgrid in miniature: a 5-shell
1D model on an 8^3 Cartesian grid, days 1-2 (dense, so that the thermal
balance and the photoionisation have work to do), ``num_lte_timesteps=1``,
the multibin field (32 bins), the detailed bf-rate and J_b_lu estimators
used from timestep 1 on, LUT-off photoionisation and bf heating. The JAX
package runs it in float64 (its float32 mode fails in timestep 0 with NLTE
on, ROADMAP Queue 3); the port runs it in float32 from the same pellets.

- The JAX run's timestep-1 ``nlte`` call is captured and the port's
  ``_plasma_update_device`` gets identical float64 copies of its inputs
  (with bf-rates made from a seed: no packet of this cool scene reaches a
  bf window, so the run's own are zero):
  the multibin fits to rtol 1e-9, T_e to rtol 1e-5 (as
  tests/test_torch_thermalbalance.py), nne and the NLTE populations to
  rtol 1e-5 on the levels holding more than 1e-10 of their element, the
  per-cell outer-loop iterations equal;
- the whole timesteps 0-1 of both runs agree within Monte Carlo noise (the
  4/sqrt(n) rule of tests/test_physics_validation.py): escaped
  luminosity, per-cell J, and per-cell T_e and nne after the NLTE update
  within their run-to-run spread of 4/sqrt(n) of J's packets;
- ``nlte_0000.out`` and ``radfield_0000.out`` have the JAX writer's header
  and columns, line for line;
- a resumed run is bit-exact with the bin and J_b_lu estimators and the
  NLTE populations (tests/test_checkpoint.py contract);
- ``check_supported`` takes nltenebular without the non-thermal solver
  (and, since the solver is ported, with it) and still raises for
  ``vpkt_on``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts, rel_close

torch.set_num_threads(1)

MAKE = dict(ncells=5, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-7.0,
            num_lte_timesteps=1)
OPT_KW = dict(npkts=1000, grid_type="CARTESIAN3D", ncoordgrid_x=8, ncoordgrid_y=8,
              ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20, linewalk_chunk=64,
              rpkt_crossings_per_dispatch=16, radfieldbincount=32,
              detailed_bf_estimators_usefromtimestep=1, first_nlte_radfield_timestep=1,
              nlte_outer_iters=8)


def _jopts(**kw):
    import artis_tpu.options as jo

    o = dict(OPT_KW, **kw)
    o["grid_type"] = jo.GridType[o["grid_type"]]
    return jo.nltenebular(nt_on=False, nt_solve_spencerfano=False, **o)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Timesteps 0-1 of the JAX package (float64) and of the port (float32,
    the same pellets), with the JAX run's timestep-1 grid update captured."""
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    dj = str(tmp_path_factory.mktemp("nlte_jax"))
    dt = str(tmp_path_factory.mktemp("nlte_port"))
    for d in (dj, dt):
        make_run(d, **MAKE)
    jopts = _jopts()
    sj = jd.Simulation(dj, jopts, datadir="/nonexistent")
    calls = []
    orig = sj._plasma_jit

    def capture(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    sj._plasma_jit = capture
    st = td.Simulation(dt, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    for nts in range(2):
        sj.do_timestep(nts)
        st.do_timestep(nts)
    assert [c[1]["mode"] for c in calls] == ["first", "nlte"]
    st.close()
    return dict(sj=sj, st=st, call=calls[1], jit=orig, dt=dt, dj=dj)


@pytest.fixture(scope="module")
def update(runs):
    """The captured update on both sides, from identical float64 inputs."""
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    import jax.numpy as jnp

    a, kw = runs["call"]
    # the run's own bf-rate estimators are zero (no packet of this cool
    # scene reaches a bf window); seeded rates exercise their path
    rng = np.random.default_rng(17)
    kw = dict(kw, bfrate_normed=jnp.asarray(10 ** rng.uniform(
        -12.0, -8.0, np.asarray(kw["bfrate_normed"]).shape)))
    out_j = runs["jit"](*a, **kw)
    dad, rc, cells, opts, j_norm, nuj_norm, t_mid, ffh, dep = a[:9]
    f64 = torch.float64
    t = lambda x: None if x is None else torch.as_tensor(np.array(x, np.float64))
    tdad = interop.from_numpy(DeviceAtomicData, np_fields(dad), dtype=f64)
    topts = port_opts(opts, transport_dtype="float64")
    jb_line, jb_arr = kw["jblue_normed"]
    out_t = td._plasma_update_device(
        tdad, interop.from_numpy(RateCoeffTables, np_fields(rc), dtype=f64),
        interop.from_numpy(CellState, np_fields(cells), dtype=f64), topts, t(j_norm),
        t(nuj_norm), float(t_mid), t(ffh), t(dep), mode=kw["mode"],
        gammaest_norm=t(kw["gammaest_norm"]), binj_norm=t(kw["binj_norm"]),
        binnuj_norm=t(kw["binnuj_norm"]), bincount=t(kw["bincount"]),
        bfrate_normed=t(kw["bfrate_normed"]),
        jblue_normed=(torch.as_tensor(np.array(jb_line)).long(), t(jb_arr)),
        radfield_use_bins=bool(kw["radfield_use_bins"]),
        nlte_indices=interop.nlte_indices_from_numpy(
            [np_fields(ix) for ix in runs["sj"].nlte_indices]))
    return out_j, out_t


def test_update_inputs_carry_every_estimator(runs):
    _, kw = runs["call"]
    for name in ("binj_norm", "bincount"):
        assert np.asarray(kw[name]).sum() > 0, name
    assert np.asarray(kw["jblue_normed"][1]).sum() > 0
    assert np.asarray(kw["bfrate_normed"]).shape[1] > 1
    assert kw["gammaest_norm"] is None and kw["radfield_use_bins"]


def test_update_bin_fits_match(update):
    out_j, out_t = update
    for name, i in (("tr_bins", 13), ("w_bins", 14)):
        np.testing.assert_allclose(out_t[9][name].numpy(), np.asarray(out_j[i]), rtol=1e-9,
                                   atol=0, err_msg=name)


def test_update_te_and_iterations_match(update):
    out_j, out_t = update
    np.testing.assert_allclose(out_t[0].Te.numpy(), np.asarray(out_j[0].Te), rtol=1e-5)
    np.testing.assert_array_equal(out_t[9]["nlte_iters"].numpy(), np.asarray(out_j[22]))
    # the outer loop ran, and T_e left its starting value
    assert int(np.asarray(out_j[22]).max()) >= 2


@pytest.mark.parametrize("name", ["nne", "levelpops", "ion_groundlevelpops"])
def test_update_populations_match(runs, update, name):
    out_j, out_t = update
    dad = runs["call"][0][0]
    if name == "nne":
        np.testing.assert_allclose(out_t[0].nne.numpy(), np.asarray(out_j[0].nne), rtol=1e-5)
        return
    lp_j = np.asarray(out_j[1])
    elem = np.asarray(dad.ion_element)[np.asarray(dad.level_ion)]
    elem_tot = np.stack([lp_j[:, elem == e].sum(axis=1) for e in range(dad.nelements)], axis=1)
    if name == "levelpops":
        a, b, floor = lp_j, out_t[1].numpy(), 1e-10 * elem_tot[:, elem]
    else:
        ground = np.asarray(dad.ion_level_start)
        a, b = np.asarray(out_j[0].ion_groundlevelpops), out_t[0].ion_groundlevelpops.numpy()
        floor = 1e-10 * elem_tot[:, elem[ground]]
    big = a > floor
    np.testing.assert_allclose(b[big], a[big], rtol=1e-5, atol=0)
    assert np.all(np.abs(b - a)[~big] <= floor[~big])


def test_update_departs_from_lte(runs, update):
    """Some level's NLTE population departs from its Boltzmann value at the
    solved ion populations by more than 1e-3."""
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma import ltepop

    _, out_t = update
    a = runs["call"][0]
    tdad = interop.from_numpy(DeviceAtomicData, np_fields(a[0]), dtype=torch.float64)
    boltz = ltepop.calculate_levelpops(tdad, out_t[0], port_opts(a[3])).numpy()
    lp = out_t[1].numpy()
    sel = boltz > 1e-20
    assert np.max(np.abs(lp[sel] / boltz[sel] - 1.0)) > 1e-3


def test_timesteps_match_jax_in_mc_noise(runs):
    from artis_tpu.packets import TYPE_ESCAPE, TYPE_RPKT

    sj, st = runs["sj"], runs["st"]
    assert st.plasma_mode == "nlte" and st.nlte_iters >= 1
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


@pytest.mark.parametrize("fname", ["nlte_0000.out", "radfield_0000.out"])
def test_output_files_match_jax_format(runs, fname):
    lines_j = open(os.path.join(runs["dj"], fname)).read().splitlines()
    lines_t = open(os.path.join(runs["dt"], fname)).read().splitlines()
    assert lines_t[0] == lines_j[0]
    assert len(lines_t) == len(lines_j) > 1
    # the key columns (timestep, modelgridindex, Z, ion stage, level; or
    # timestep, modelgridindex, bin, its edges) agree token for token
    for lj, lt in zip(lines_j[1:], lines_t[1:]):
        tj, tt = lj.split(), lt.split()
        assert len(tt) == len(tj)
        assert tt[:5] == tj[:5]
        assert np.all(np.isfinite([float(v) for v in tt]))
    assert {line.split()[0] for line in lines_t[1:]} == {"0", "1"}


def test_checkpoint_resume_bitwise(tmp_path_factory):
    """Three timesteps straight against two, a checkpoint and a resumed
    third: the estimators (multibin and J_b_lu rows included), the cells
    and the populations agree bit for bit."""
    import artis_tpu_torch.driver as td

    opts = port_opts(_jopts(npkts=300, grid_type="SPHERICAL1D", nlte_outer_iters=3),
                     transport_dtype="float32")
    d1 = str(tmp_path_factory.mktemp("nlte_straight"))
    d2 = str(tmp_path_factory.mktemp("nlte_resumed"))
    for d in (d1, d2):
        make_run(d, **dict(MAKE, ntimesteps=4))
    a = td.Simulation(d1, opts, device="cpu")
    for ts in range(3):
        a.do_timestep(ts)
    b1 = td.Simulation(d2, opts, device="cpu")
    for ts in range(2):
        b1.do_timestep(ts)
    b1.save_checkpoint(2)
    b1.close()
    b = td.Simulation(d2, opts, device="cpu")
    assert b.params.timestep_start == 2
    b.do_timestep(2)
    assert float(a.est.radfieldbin_count.sum()) > 0 and float(a.est.jblue_count.sum()) > 0
    for f in dataclasses.fields(a.est):
        torch.testing.assert_close(getattr(b.est, f.name), getattr(a.est, f.name), rtol=0,
                                   atol=0, equal_nan=True, msg=f.name)
    for f in ("Te", "nne", "ion_groundlevelpops", "ion_partfuncts"):
        torch.testing.assert_close(getattr(b.cells, f), getattr(a.cells, f), rtol=0, atol=0,
                                   msg=f)
    torch.testing.assert_close(b._last_levelpops, a._last_levelpops, rtol=0, atol=0)
    a.close()
    b.close()


def test_check_supported_takes_nebular_without_nonthermal():
    import artis_tpu_torch.options as to
    from artis_tpu_torch.transport.engine import check_supported

    check_supported(to.nltenebular(nt_on=False, nt_solve_spencerfano=False))
    for kw in (dict(nt_on=True, nt_solve_spencerfano=False),
               dict(nt_on=False, nt_solve_spencerfano=True), {}):
        check_supported(to.nltenebular(**kw))
    # virtual packets run with it too, and so do the run diagnostics
    for kw in (dict(nt_on=False, nt_solve_spencerfano=False, vpkt_on=True), dict(vpkt_on=True)):
        check_supported(to.nltenebular(**kw))
        check_supported(to.nltenebular(record_linestat=True, track_ion_stats=True,
                                       log_macroatom=True, **kw))

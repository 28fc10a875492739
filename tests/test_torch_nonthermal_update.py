"""One ``nlte`` grid update with the non-thermal solver on (nltenebular with
the Spencer-Fano solve), the port against the JAX package on identical
float64 inputs, on the CPU.

The scene is the reference CI's nebular_1d_3dgrid in miniature: a 5-shell
1D model on an 8^3 Cartesian grid, days 1-2, ``num_lte_timesteps=0`` (so
timestep 1 is the first non-LTE timestep that solves Spencer-Fano; the
skip belongs to timestep ``num_lte_timesteps``, here the ``first``
update), the synthetic atom with the synthetic non-thermal files, the
multibin field, the detailed bf-rate and J_b_lu estimators, LUT-off rates,
``sf_points=64``. The port runs timestep 0; its estimators, as float64,
become the JAX run's previous estimators, and the JAX run's timestep-1 grid
update is captured. The port's ``_plasma_update_device`` then gets float64
copies of every captured input (the Spencer-Fano tables carried across
with ``interop.nonthermal_data_from_numpy``, the work-function factors
and the default carry). The JAX update takes its Spencer-Fano solve run
eagerly (``eager_spencerfano``): compiled whole, that solve drops diagonal
terms of its ionisation matrix, which the port keeps (ROADMAP Queue 3):

- with NLTE levels (the outer loop, 4 iterations): T_e to rtol 1e-5 (as
  tests/test_torch_nlte.py), nne and the populations to rtol 1e-5 on the
  levels holding more than 1e-10 of their element, the carry
  (frac_heating, frac_ionization, frac_ion_by_ion, eff_ionpot, the Auger
  tables, x_e at the solve and its timestep) to rtol 1e-5, and the
  deposition-split fractions handed to the transport;
- without NLTE levels (``nlte_enabled=False``: one Spencer-Fano, T_e and
  ion-balance pass): T_e and nne to rtol 1e-5, the carry likewise;
- the solver ran and mattered: frac_heating at most 1 (below it in some
  cell) and frac_ionization above 0 in every cell, and nne differs from
  the same update without the solver.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts

torch.set_num_threads(1)

RTOL = 1e-5
ELEMENTS = ((26, 3), (27, 2), (28, 2))
MAKE = dict(ncells=5, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-9.0,
            num_lte_timesteps=0)
OPT_KW = dict(npkts=1000, grid_type="CARTESIAN3D", ncoordgrid_x=8, ncoordgrid_y=8,
              ncoordgrid_z=8, mintemp=1000.0, maxtemp=20000.0, tablesize=20, linewalk_chunk=64,
              rpkt_crossings_per_dispatch=16, radfieldbincount=32,
              detailed_bf_estimators_usefromtimestep=1, first_nlte_radfield_timestep=1,
              nlte_outer_iters=4, sf_points=64)


def _jopts(**kw):
    import artis_tpu.options as jo

    o = dict(OPT_KW, **kw)
    o["grid_type"] = jo.GridType[o["grid_type"]]
    return jo.nltenebular(**o)


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The JAX run's timestep-1 update call, its estimators the port's
    timestep 0's."""
    import jax.numpy as jnp

    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    d = str(tmp_path_factory.mktemp("nt_update"))
    make_run(d, **MAKE)
    write_synthetic_nonthermal_data(d, ELEMENTS)
    jopts = _jopts()
    st = td.Simulation(d, port_opts(jopts, transport_dtype="float32"), datadir="/nonexistent",
                       device="cpu")
    st.do_timestep(0)
    st.close()
    sj = jd.Simulation(d, jopts, datadir="/nonexistent")
    sj.update_grid(0)
    sj.prev_est = sj.est.replace(**{
        f.name: jnp.asarray(np.asarray(getattr(st.est, f.name).double().numpy()
                                       if getattr(st.est, f.name).is_floating_point()
                                       else getattr(st.est, f.name).numpy()))
        for f in dataclasses.fields(st.est)})
    calls, results = [], []
    orig = sj._plasma_jit

    def capture(*a, **kw):
        calls.append((a, kw))
        results.append(orig(*a, **kw))
        return results[-1]

    sj._plasma_jit = capture
    with eager_spencerfano(sj):
        sj.update_grid(1)
    assert [c[1]["mode"] for c in calls] == ["nlte"]
    assert not calls[0][1]["nt_sf_skip"]
    return dict(sj=sj, call=calls[0], jit=orig, out=results[0])


@contextlib.contextmanager
def eager_spencerfano(sj):
    """Within it, the JAX Simulation ``sj``'s compiled grid updates take the
    JAX package's Spencer-Fano solve run eagerly (a host callback). Compiled
    whole, that solve drops diagonal terms of its ionisation matrix
    (tests/test_torch_nonthermal.py::test_jax_jitted_solve_drops_diagonal_terms;
    ROADMAP Queue 3), which the reference's solve has and the port keeps."""
    import jax
    import jax.numpy as jnp

    from artis_tpu.plasma import nonthermal as jnt

    orig = jnt.solve_spencerfano_cells

    def eager(ntd, dad, levelpops, nnion, nne, **kw):
        def host(lp, nn, ne):
            out = orig(sj.ntd, sj.dad, jnp.asarray(lp), jnp.asarray(nn), jnp.asarray(ne), **kw)
            return {k: np.asarray(v) for k, v in out.items()}

        shapes = jax.eval_shape(lambda lp, nn, ne: orig(sj.ntd, sj.dad, lp, nn, ne, **kw),
                                levelpops, nnion, nne)
        return jax.pure_callback(host, shapes, levelpops, nnion, nne)

    jnt.solve_spencerfano_cells = eager
    try:
        yield
    finally:
        jnt.solve_spencerfano_cells = orig


def _port_update(captured, opts, nt=True):
    """The port's update on float64 copies of the captured inputs, with the
    JAX package's ``opts`` (the solver's tables left out unless ``nt``)."""
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.cellstate import CellState
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    a, kw = captured["call"]
    sj = captured["sj"]
    dad, rc, cells, _, j_norm, nuj_norm, t_mid, ffh, dep = a[:9]
    f64 = torch.float64
    t = lambda x: None if x is None else torch.as_tensor(np.array(x, np.float64))
    tdad = interop.from_numpy(DeviceAtomicData, np_fields(dad), dtype=f64)
    jb_line, jb_arr = kw["jblue_normed"]
    carry = {k: torch.as_tensor(np.array(v)) for k, v in kw["sf_carry"].items()}
    carry["ts_last_solved"] = carry["ts_last_solved"].long()
    return td._plasma_update_device(
        tdad, interop.from_numpy(RateCoeffTables, np_fields(rc), dtype=f64),
        interop.from_numpy(CellState, np_fields(cells), dtype=f64),
        port_opts(opts, transport_dtype="float64"), t(j_norm), t(nuj_norm), float(t_mid),
        t(ffh), t(dep), mode=kw["mode"], gammaest_norm=t(kw["gammaest_norm"]),
        binj_norm=t(kw["binj_norm"]), binnuj_norm=t(kw["binnuj_norm"]),
        bincount=t(kw["bincount"]), bfrate_normed=t(kw["bfrate_normed"]),
        jblue_normed=(torch.as_tensor(np.array(jb_line)).long(), t(jb_arr)),
        radfield_use_bins=bool(kw["radfield_use_bins"]),
        nlte_indices=interop.nlte_indices_from_numpy([np_fields(ix) for ix in sj.nlte_indices]),
        ntd=interop.nonthermal_data_from_numpy(np_fields(sj.ntd), tdad.ion_element) if nt
        else None, nt_wf=tuple(t(x) for x in sj.nt_wf) if nt else None,
        sf_carry=carry if nt else None, nts=int(kw["nts_dev"]),
        nt_sf_skip=bool(kw["nt_sf_skip"]), num_lte_timesteps=int(sj.params.num_lte_timesteps))


def _both(captured, **opt_kw):
    """The captured update on both sides (with ``opt_kw`` replacing
    options of both), from identical float64 inputs."""
    a, kw = captured["call"]
    opts = a[3].replace(**opt_kw)
    with eager_spencerfano(captured["sj"]):
        out_j = captured["jit"](*(tuple(a[:3]) + (opts,) + tuple(a[4:])), **kw)
    return out_j, _port_update(captured, opts)


@pytest.fixture(scope="module")
def with_levels(captured):
    return captured["out"], _port_update(captured, captured["call"][0][3])


@pytest.fixture(scope="module")
def without_levels(captured):
    return _both(captured, nlte_enabled=False)


CARRY_KEYS = ("frac_heating", "frac_ionization", "frac_excitation", "frac_ion_by_ion",
              "eff_ionpot", "prob_num_auger", "ionenfrac_num_auger", "xe_when_solved")


def _assert_carry(out_j, out_t):
    cj, ct = out_j[-1], out_t[9]["sf_carry"]
    for k in CARRY_KEYS:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=RTOL, atol=1e-300,
                                   err_msg=k)
    np.testing.assert_array_equal(ct["ts_last_solved"].numpy(), np.asarray(cj["ts_last_solved"]))
    assert np.all(ct["ts_last_solved"].numpy() == 1)
    fh, fi = ct["frac_heating"].numpy(), ct["frac_ionization"].numpy()
    assert np.all((fh > 0) & (fh <= 1)) and np.any(fh < 1) and np.all(fi > 0)
    # the fractions the transport's deposition split reads
    nt = out_t[9]["nt"]
    for name, i in (("frac_ion_by_ion", 8), ("frac_ionization", 9), ("frac_excitation", 10),
                    ("ionenfrac_num_auger", 11)):
        np.testing.assert_allclose(nt[name].numpy(), np.asarray(out_j[i]), rtol=RTOL,
                                   atol=1e-300, err_msg=name)
    assert out_t[9]["sf_solves"] >= 1


def test_update_with_nlte_levels_matches(captured, with_levels):
    out_j, out_t = with_levels
    np.testing.assert_allclose(out_t[0].Te.numpy(), np.asarray(out_j[0].Te), rtol=RTOL)
    np.testing.assert_allclose(out_t[0].nne.numpy(), np.asarray(out_j[0].nne), rtol=RTOL)
    np.testing.assert_array_equal(out_t[9]["nlte_iters"].numpy(), np.asarray(out_j[22]))
    dad = captured["call"][0][0]
    lp_j, lp_t = np.asarray(out_j[1]), out_t[1].numpy()
    elem = np.asarray(dad.ion_element)[np.asarray(dad.level_ion)]
    elem_tot = np.stack([lp_j[:, elem == e].sum(axis=1) for e in range(dad.nelements)], axis=1)
    floor = 1e-10 * elem_tot[:, elem]
    big = lp_j > floor
    np.testing.assert_allclose(lp_t[big], lp_j[big], rtol=RTOL, atol=0)
    assert np.all(np.abs(lp_t - lp_j)[~big] <= floor[~big])
    _assert_carry(out_j, out_t)


def test_update_without_nlte_levels_matches(without_levels):
    out_j, out_t = without_levels
    assert out_t[9]["nlte_iters"] is None
    np.testing.assert_allclose(out_t[0].Te.numpy(), np.asarray(out_j[0].Te), rtol=RTOL)
    np.testing.assert_allclose(out_t[0].nne.numpy(), np.asarray(out_j[0].nne), rtol=RTOL)
    _assert_carry(out_j, out_t)
    assert out_t[9]["sf_solves"] == 1


def test_solver_moves_the_update(captured, with_levels):
    """The non-thermal ionisation changes the populations: the port's same
    update without the solver gives another nne in some cell."""
    _, out_t = with_levels
    opts = captured["call"][0][3].replace(nt_on=False, nt_solve_spencerfano=False)
    off = _port_update(captured, opts, nt=False)
    assert off[9]["sf_carry"] is None and off[9]["nt"] is None
    on, off = out_t[0].nne.numpy(), off[0].nne.numpy()
    assert np.max(np.abs(on / off - 1.0)) > 1e-3

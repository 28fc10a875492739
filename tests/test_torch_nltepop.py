"""The port's NLTE population solver (``plasma/nltepop.py``) and the LUT-off
radiation-field integrals (``ratecoeff.radfield_bf_integrals_cells``)
against the JAX package on the CPU, in float64.

- ``build_indices``: every index list equal, with all levels in NLTE and
  with superlevels (the caps of ``nlte_maxlevel`` / ``nlte_maxlevel_fe2``);
- ``solve_all_elements`` from the same populations and cells (made from a
  seed: four cells at 5000-16000 K in dilute fields) against JAX's, with
  superlevels, with the detailed bf-rate and J_b_lu estimators, with the
  LUT-off photoionisation coefficients and with the forced-Saha ion rows:
  populations to rtol 1e-6 on every level that holds more than 1e-10 of
  its element's number density (the rest within 1e-10 of it: the LU
  solve's absolute accuracy is set by the normalisation row, so the
  populations of levels 1e-17 below their element's carry the two
  libraries' rounding), nne to rtol 1e-6;
- the port's versions of tests/test_nltepop.py: detailed balance (W = 1,
  T_R = T_e) and the same with superlevels reproduce the Boltzmann
  populations, a diluted field underpopulates excited levels, and the
  refinement never worsens the residual;
- ``radfield_bf_integrals_cells`` with the full-spectrum and the binned
  field, rtol 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL = 1e-6
T_MID = 5.0 * 86400.0
TEMPS = np.array([5000.0, 8000.0, 12000.0, 16000.0])


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x)).to(dtype)


@pytest.fixture(scope="module")
def atom(tmp_path_factory):
    """The JAX package's atomic data, rate tables and Saha cells of four
    temperatures, and the port's copies."""
    import jax.numpy as jnp

    from artis_tpu import atomic
    from artis_tpu.io import atomicdata
    from artis_tpu.options import kilonova_lte
    from artis_tpu.plasma import cellstate, ltepop, ratecoeff
    from artis_tpu.synthdata import write_synthetic_atomicdata
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables

    folder = tmp_path_factory.mktemp("nlte_atom")
    write_synthetic_atomicdata(folder, elements=((26, 3), (27, 2)), nlevels_per_ion=6)
    ad = atomicdata.read_atomicdata(str(folder), nlevels_requiretransitions=lambda z, s: 0)
    dad = atomic.to_device(ad)
    opts = kilonova_lte(mintemp=1000.0, maxtemp=30000.0, tablesize=40)
    rc = ratecoeff.build_tables(dad, opts.tablesize, opts.mintemp, opts.maxtemp)
    n = len(TEMPS)
    cells = cellstate.init_cellstate(dad, n, np.full(n, 1e-13), np.ones(n), opts.mintemp,
                                     opts.maxtemp)
    t = jnp.asarray(TEMPS)
    cells = cells.replace(Te=t, TR=t, TJ=t, W=jnp.ones(n),
                          elem_massfrac=jnp.asarray(np.tile([0.7, 0.3], (n, 1))))
    cells = ltepop.calculate_ion_balance_nne(dad, cells, opts)
    return dict(dad=dad, rc=rc, cells=cells, opts=opts,
                tdad=interop.from_numpy(DeviceAtomicData, _np_fields(dad), dtype=torch.float64),
                trc=interop.from_numpy(RateCoeffTables, _np_fields(rc), dtype=torch.float64))


def _port_opts(jopts):
    from test_torch_grid3d import port_opts

    return port_opts(jopts)


SL = dict(nlte_all_levels=False, nlte_maxlevel=2, nlte_maxlevel_fe2=3)


@pytest.mark.parametrize("caps", [dict(nlte_all_levels=True), SL], ids=["all", "superlevels"])
def test_build_indices_equal(atom, caps):
    from artis_tpu.plasma import nltepop as jn
    from artis_tpu_torch.plasma import nltepop as tn

    jopts = atom["opts"].replace(**caps)
    ij = jn.build_indices(atom["dad"], jopts)
    it = tn.build_indices(atom["tdad"], _port_opts(jopts))
    assert len(ij) == len(it) == 2
    for a, b in zip(ij, it):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f.name)
    if caps is SL:
        assert all(ix.dim_reduced < ix.dim for ix in it)
    # the JAX package's lists carried across are the port's own
    from artis_tpu_torch import interop

    for a, b in zip(interop.nlte_indices_from_numpy([_np_fields(ix) for ix in ij]), it):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                          np.asarray(getattr(b, f.name)), err_msg=f.name)


def _case_inputs(atom, case):
    """(JAX opts, cells, keyword inputs as numpy) of one solve case."""
    rng = np.random.default_rng(11)
    dad, cells = atom["dad"], atom["cells"]
    n = len(TEMPS)
    jopts = atom["opts"].replace(**SL) if case != "all_levels" else atom["opts"]
    cells = cells.replace(W=cells.W * np.array([1e-3, 1e-2, 0.1, 0.5]),
                          TR=cells.TR * np.array([1.0, 0.9, 1.1, 0.8]))
    kw = {}
    if case == "bfrate":
        kw["bfrate_normed"] = 10 ** rng.uniform(-14.0, -8.0, (n, dad.nbfcontinua))
    elif case == "jblue":
        jb_line = np.where(rng.uniform(size=dad.nlines) < 0.6, np.arange(dad.nlines), -1)
        kw["jblue_normed"] = (jb_line, 10 ** rng.uniform(-9.0, -4.0, (n, dad.nlines)))
    elif case == "lut_off":
        kw["corr_photoion_cells"] = 10 ** rng.uniform(-13.0, -7.0, (n, dad.nbfcontinua))
    elif case == "force_saha":
        jopts = jopts.replace(force_saha_ion_balance=True)
    return jopts, cells, kw


def _solve_both(atom, jopts, cells, kw):
    import jax.numpy as jnp

    from artis_tpu.plasma import ltepop as jl
    from artis_tpu.plasma import nltepop as jn
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma import nltepop as tn
    from artis_tpu_torch.plasma.cellstate import CellState

    lp = jl.calculate_levelpops(atom["dad"], cells, jopts)
    jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in kw.items()}
    cj, pj = jn.solve_all_elements(jn.build_indices(atom["dad"], jopts), atom["dad"], atom["rc"],
                                   cells, jopts, lp, t_mid=T_MID, **jkw)
    topts = _port_opts(jopts)
    tkw = {k: ((_t(v[0], torch.int64), _t(v[1])) if isinstance(v, tuple) else _t(v))
           for k, v in kw.items()}
    ct, pt = tn.solve_all_elements(
        tn.build_indices(atom["tdad"], topts), atom["tdad"], atom["trc"],
        interop.from_numpy(CellState, _np_fields(cells), dtype=torch.float64), topts,
        _t(lp), T_MID, **tkw)
    return (cj, np.asarray(pj), np.asarray(lp)), (ct, pt.numpy())


def _assert_pops_close(dad, pj, pt):
    elem = np.asarray(dad.ion_element)[np.asarray(dad.level_ion)]
    elem_tot = np.stack([pj[:, elem == e].sum(axis=1) for e in range(dad.nelements)], axis=1)
    floor = 1e-10 * elem_tot[:, elem]
    big = pj > floor
    np.testing.assert_allclose(pt[big], pj[big], rtol=RTOL, atol=0)
    assert np.all(np.abs(pt - pj)[~big] <= floor[~big])
    assert big.sum() > 0.3 * big.size


CASES = ["all_levels", "superlevels", "bfrate", "jblue", "lut_off", "force_saha"]


@pytest.mark.parametrize("case", CASES)
def test_solve_all_elements_matches(atom, case):
    jopts, cells, kw = _case_inputs(atom, case)
    (cj, pj, lp), (ct, pt) = _solve_both(atom, jopts, cells, kw)
    _assert_pops_close(atom["dad"], pj, pt)
    np.testing.assert_allclose(ct.nne.numpy(), np.asarray(cj.nne), rtol=RTOL, atol=0)
    # ground populations and partition functions of the ions whose ground
    # level the populations above resolve
    ground = np.asarray(atom["dad"].ion_level_start)
    elem = np.asarray(atom["dad"].ion_element)[np.asarray(atom["dad"].level_ion)]
    elem_tot = np.stack([pj[:, elem == e].sum(axis=1) for e in range(2)], axis=1)
    big = pj[:, ground] > 1e-10 * elem_tot[:, elem[ground]]
    for f in ("ion_groundlevelpops", "ion_partfuncts"):
        np.testing.assert_allclose(getattr(ct, f).numpy()[big], np.asarray(getattr(cj, f))[big],
                                   rtol=RTOL, atol=0, err_msg=f)
    # the case departs from LTE
    assert np.max(np.abs(pt / np.maximum(lp, 1e-300) - 1.0)[lp > 1e-20]) > 1e-3


def _port_solve(atom, w=1.0, caps=None, refine=None):
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma import ltepop, nltepop
    from artis_tpu_torch.plasma.cellstate import CellState

    topts = _port_opts(atom["opts"].replace(**(caps or {})))
    if refine is not None:
        topts = topts.replace(nlte_refine_iters=refine)
    cells = interop.from_numpy(CellState, _np_fields(atom["cells"]), dtype=torch.float64)
    cells = cells.replace(W=torch.full_like(cells.W, w))
    lte = ltepop.calculate_levelpops(atom["tdad"], cells, topts)
    _, pops = nltepop.solve_all_elements(nltepop.build_indices(atom["tdad"], topts), atom["tdad"],
                                         atom["trc"], cells, topts, lte, T_MID)
    return lte.numpy(), pops.numpy(), cells


@pytest.mark.parametrize("caps", [None, SL], ids=["all", "superlevels"])
def test_detailed_balance_reproduces_lte(atom, caps):
    """W = 1, T_R = T_e: every rate pair is in detailed balance, so the
    solve returns the Boltzmann / Saha populations, to the accuracy of the
    fixed-grid rate integrals (tests/test_nltepop.py)."""
    lte, nlte, cells = _port_solve(atom, caps=caps)
    mask = lte > 1e-20
    ratio = nlte[mask] / lte[mask]
    assert np.all(np.isfinite(ratio))
    assert np.quantile(np.abs(np.log(ratio)), 0.95) < 0.12
    elem = atom["tdad"].ion_element[atom["tdad"].level_ion].numpy()
    nn = cells.elem_numberdens().numpy()
    for e in range(2):
        np.testing.assert_allclose(nlte[:, elem == e].sum(axis=1), nn[:, e], rtol=1e-6)


def test_diluted_field_underpopulates_excited_levels(atom):
    lte, nlte, _ = _port_solve(atom, w=1e-3)
    ground = np.zeros(lte.shape[1], bool)
    ground[atom["tdad"].ion_level_start.numpy()] = True
    dep = nlte[:, ~ground] / np.maximum(lte[:, ~ground], 1e-300)
    assert np.median(dep[lte[:, ~ground] > 1e-10]) < 1.0


def test_refinement_does_not_worsen(atom):
    _, p0, _ = _port_solve(atom, w=1e-3, refine=0)
    _, p4, _ = _port_solve(atom, w=1e-3, refine=4)
    for p in (p0, p4):
        assert np.all(np.isfinite(p)) and np.all(p >= 0)
    sel = p0 > 1e-6
    np.testing.assert_allclose(p4[sel], p0[sel], rtol=0.05)


@pytest.mark.parametrize("binned", [False, True], ids=["fullspec", "binned"])
def test_radfield_bf_integrals_match(atom, binned):
    import jax.numpy as jnp

    from artis_tpu.plasma import ratecoeff as jrc
    from artis_tpu_torch.plasma import ratecoeff as trc

    rng = np.random.default_rng(13)
    n, nb = 4, 32
    te = TEMPS * 1.05
    tr, w = TEMPS * 0.9, np.array([1e-3, 0.05, 0.3, 1.0])
    dep = rng.normal(0.0, 2.0, (n, atom["dad"].nbfcontinua))
    bins = {}
    if binned:
        bins = dict(tr_bins=rng.uniform(3000.0, 20000.0, (n, nb)),
                    w_bins=np.where(rng.uniform(size=(n, nb)) < 0.2, 0.0,
                                    10 ** rng.uniform(-4.0, 0.0, (n, nb))), nbins=nb)
    a = jrc.radfield_bf_integrals_cells(
        atom["dad"], jnp.asarray(te), jnp.asarray(tr), jnp.asarray(w), jnp.asarray(dep),
        **{k: (jnp.asarray(v) if k != "nbins" else v) for k, v in bins.items()})
    b = trc.radfield_bf_integrals_cells(
        atom["tdad"], _t(te), _t(tr), _t(w), _t(dep),
        **{k: (_t(v) if k != "nbins" else v) for k, v in bins.items()})
    for name, x, y in zip(("corrphotoion", "bfheating"), a, b):
        x = np.asarray(x)
        assert np.abs(x).max() > 0, name
        np.testing.assert_allclose(y.numpy(), x, rtol=1e-9, atol=0, err_msg=name)

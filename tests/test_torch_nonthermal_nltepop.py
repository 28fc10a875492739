"""The non-thermal terms of the port's NLTE populations and ion balance
against the JAX package on the CPU, in float64, on captured inputs: the
synthetic Fe I-III / Co I-II atom (6 levels per ion) with its synthetic
non-thermal files, four Saha cells at 5000-16000 K in dilute fields (as
tests/test_torch_nltepop.py), and seeded non-thermal inputs.

- ``nltepop.solve_all_elements`` with the non-thermal ionisation rates
  (single ionisation, and with the Auger upper-ion probabilities, whose
  last reachable ion takes what the lower ones leave), with superlevels,
  and with the non-thermal excitation rates of the Spencer-Fano table:
  populations to rtol 1e-6 on every level holding more than 1e-10 of its
  element (tests/test_torch_nltepop.py's rule), nne to rtol 1e-6; each case
  moves the populations away from the solve without the terms;
- ``ltepop.calculate_ion_balance_nne`` with the photoionisation rates and
  the non-thermal rates added to them, rtol 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL = 1e-6
T_MID = 5.0 * 86400.0
TEMPS = np.array([5000.0, 8000.0, 12000.0, 16000.0])
ELEMENTS = ((26, 3), (27, 2))
SL = dict(nlte_all_levels=False, nlte_maxlevel=2, nlte_maxlevel_fe2=3)


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x)).to(dtype)


@pytest.fixture(scope="module")
def atom(tmp_path_factory):
    """The JAX package's atom, rate tables, Saha cells and Spencer-Fano
    table, and the port's copies."""
    import jax.numpy as jnp

    from artis_tpu import atomic
    from artis_tpu.io import atomicdata
    from artis_tpu.options import kilonova_lte
    from artis_tpu.plasma import cellstate, ltepop, ratecoeff
    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu.synthdata import write_synthetic_atomicdata
    from artis_tpu_torch import interop
    from artis_tpu_torch.atomic import DeviceAtomicData
    from artis_tpu_torch.plasma.ratecoeff import RateCoeffTables
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    folder = str(tmp_path_factory.mktemp("nt_nlte_atom"))
    write_synthetic_atomicdata(folder, elements=ELEMENTS, nlevels_per_ion=6)
    write_synthetic_nonthermal_data(folder, ELEMENTS)
    ad = atomicdata.read_atomicdata(folder, nlevels_requiretransitions=lambda z, s: 0)
    dad = atomic.to_device(ad)
    opts = kilonova_lte(mintemp=1000.0, maxtemp=30000.0, tablesize=40)
    rc = ratecoeff.build_tables(dad, opts.tablesize, opts.mintemp, opts.maxtemp)
    n = len(TEMPS)
    cells = cellstate.init_cellstate(dad, n, np.full(n, 1e-13), np.ones(n), opts.mintemp,
                                     opts.maxtemp)
    t = jnp.asarray(TEMPS)
    cells = cells.replace(Te=t, TR=t * np.array([1.0, 0.9, 1.1, 0.8]), TJ=t,
                          W=jnp.asarray([1e-3, 1e-2, 0.1, 0.5]),
                          elem_massfrac=jnp.asarray(np.tile([0.7, 0.3], (n, 1))))
    cells = ltepop.calculate_ion_balance_nne(dad, cells, opts)
    ntd = jnt.build_nonthermal_data(ad, dad, folder, sf_points=64)
    tdad = interop.from_numpy(DeviceAtomicData, _np_fields(dad), dtype=torch.float64)
    return dict(dad=dad, rc=rc, cells=cells, opts=opts, ntd=ntd, tdad=tdad,
                trc=interop.from_numpy(RateCoeffTables, _np_fields(rc), dtype=torch.float64),
                tntd=interop.nonthermal_data_from_numpy(_np_fields(ntd), tdad.ion_element))


def _nt_inputs(atom, case):
    """Seeded non-thermal inputs of one case (numpy): ionisation rates
    comparable to the photoionisation rates of these cells, Auger
    probabilities from a Dirichlet draw, excitation rate coefficients per
    deposition and a deposition rate density."""
    rng = np.random.default_rng(23)
    n, nions = len(TEMPS), atom["dad"].nions_total
    kw = dict(nt_ion_rate=10 ** rng.uniform(-5.0, -2.0, (n, nions)))
    if case != "ion":
        kw["nt_prob_auger"] = rng.dirichlet([4.0, 2.0, 1.0], size=(n, nions))
    if case == "excitation":
        nexc = atom["ntd"].nexc
        kw["nt_exc_perdep"] = 10 ** rng.uniform(2.0, 5.0, (n, nexc))
        kw["nt_dep_rate_density"] = 10 ** rng.uniform(-9.0, -7.0, n)
    return kw


def _solve(atom, jopts, kw):
    import jax.numpy as jnp

    from artis_tpu.plasma import ltepop as jl
    from artis_tpu.plasma import nltepop as jn
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma import nltepop as tn
    from artis_tpu_torch.plasma.cellstate import CellState
    from test_torch_grid3d import port_opts

    cells = atom["cells"]
    lp = jl.calculate_levelpops(atom["dad"], cells, jopts)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    if "nt_exc_perdep" in kw:
        jkw["ntd"] = atom["ntd"]
    cj, pj = jn.solve_all_elements(jn.build_indices(atom["dad"], jopts), atom["dad"], atom["rc"],
                                   cells, jopts, lp, t_mid=T_MID, **jkw)
    topts = port_opts(jopts)
    tkw = {k: _t(v) for k, v in kw.items()}
    if "nt_exc_perdep" in kw:
        tkw["ntd"] = atom["tntd"]
    ct, pt = tn.solve_all_elements(
        tn.build_indices(atom["tdad"], topts), atom["tdad"], atom["trc"],
        interop.from_numpy(CellState, _np_fields(cells), dtype=torch.float64), topts, _t(lp),
        T_MID, **tkw)
    return (cj, np.asarray(pj)), (ct, pt.numpy())


CASES = ["ion", "auger", "auger_superlevels", "excitation"]


@pytest.mark.parametrize("case", CASES)
def test_solve_all_elements_with_nt_terms_matches(atom, case):
    jopts = atom["opts"].replace(**SL) if case in ("auger_superlevels", "excitation") \
        else atom["opts"]
    kw = _nt_inputs(atom, case)
    (cj, pj), (ct, pt) = _solve(atom, jopts, kw)
    dad = atom["dad"]
    elem = np.asarray(dad.ion_element)[np.asarray(dad.level_ion)]
    elem_tot = np.stack([pj[:, elem == e].sum(axis=1) for e in range(dad.nelements)], axis=1)
    floor = 1e-10 * elem_tot[:, elem]
    big = pj > floor
    np.testing.assert_allclose(pt[big], pj[big], rtol=RTOL, atol=0)
    assert np.all(np.abs(pt - pj)[~big] <= floor[~big])
    assert big.sum() > 0.3 * big.size
    np.testing.assert_allclose(ct.nne.numpy(), np.asarray(cj.nne), rtol=RTOL, atol=0)
    # the terms change the solution
    drop = ("nt_exc_perdep",) if case == "excitation" else tuple(kw)
    (_, p0), _ = _solve(atom, jopts, {k: v for k, v in kw.items() if k not in drop})
    assert np.max(np.abs(pj[big] / p0[big] - 1.0)) > 1e-3


def test_ion_balance_with_nt_rate_matches(atom):
    import jax.numpy as jnp

    from artis_tpu.plasma import ltepop as jl
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma import ltepop as tl
    from artis_tpu_torch.plasma.cellstate import CellState
    from test_torch_grid3d import port_opts

    rng = np.random.default_rng(29)
    n, nions = len(TEMPS), atom["dad"].nions_total
    jopts = atom["opts"].replace(force_saha_ion_balance=False)
    gamma = 10 ** rng.uniform(-6.0, -3.0, (n, nions))
    nt = 10 ** rng.uniform(-5.0, -2.0, (n, nions))
    cells = atom["cells"].replace(thick=jnp.asarray([0, 0, 1, 0]))
    a0 = jl.calculate_ion_balance_nne(atom["dad"], cells, jopts, gamma_ion=jnp.asarray(gamma),
                                      rc=atom["rc"])
    a = jl.calculate_ion_balance_nne(atom["dad"], cells, jopts, gamma_ion=jnp.asarray(gamma),
                                     nt_ion_rate=jnp.asarray(nt), rc=atom["rc"])
    b = tl.calculate_ion_balance_nne(
        atom["tdad"], interop.from_numpy(CellState, _np_fields(cells), dtype=torch.float64),
        port_opts(jopts), gamma_ion=_t(gamma), nt_ion_rate=_t(nt), rc=atom["trc"])
    for f in ("nne", "ion_groundlevelpops", "ion_partfuncts"):
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)), rtol=1e-12,
                                   atol=0, err_msg=f)
    assert not np.allclose(np.asarray(a.nne), np.asarray(a0.nne), rtol=1e-3)

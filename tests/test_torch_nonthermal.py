"""The port's non-thermal solver (``plasma/nonthermal.py``) against the JAX
package on the CPU, in float64, on the synthetic data files that
``artis_tpu_torch.synthdata.write_synthetic_nonthermal_data`` writes for the
3-element synthetic atom (Fe I-III, Co I-II, Ni I-II, 7 levels per ion):

- the readers (``read_collion``, ``read_binding_energies``,
  ``read_auger_data``) and ``approx_shell_occupancies`` /
  ``xs_ionization_lotz`` give the JAX package's values;
- ``build_nonthermal_data`` field by field at rtol 1e-12 (the shell table
  and its order, the synthesised Lotz rows, the Auger probabilities, the
  capped excitation table) at two grid sizes and two level caps, and
  ``wf_oneoverw_factor``; the table carried across with
  ``interop.nonthermal_data_from_numpy`` is the port's own;
- what the synthetic files must exercise: Younger rows for Fe I-III and
  Ni I, Lotz rows for the rest, several shells per ion, a collion row below
  ``sf_emin`` dropped, Auger rows matched to K and L shells and summing to
  one, excitation caps honoured;
- ``solve_spencerfano_cells`` on the same seeded level populations, ion
  populations and nne (six cells, x_e from 1e-3 to 1) at rtol 1e-9: the
  spectrum y, the three fractions, frac_ion_by_ion, eff_ionpot, both
  Auger tables and the excitation rate coefficients, with the Auger
  contribution on and off and the valence ionisation potential on and
  off; the sums over the several shells of one ion against a numpy
  ``add.at`` of the per-shell terms;
- ``nt_ionization_ratecoeff``; and the Kozma & Fransson behaviour of
  tests/test_nonthermal.py on the port (heating falls as x_e falls).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ELEMENTS = ((26, 3), (27, 2), (28, 2))
RTOL_TABLE = 1e-12
RTOL_SOLVE = 1e-9


def _np_fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape") else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def atom(tmp_path_factory):
    """The synthetic atom and non-thermal files, read by both packages."""
    from artis_tpu import atomic
    from artis_tpu.io import atomicdata
    from artis_tpu.synthdata import write_synthetic_atomicdata
    from artis_tpu_torch.atomic import to_device
    from artis_tpu_torch.io import atomicdata as tad
    from artis_tpu_torch.synthdata import write_synthetic_nonthermal_data

    folder = str(tmp_path_factory.mktemp("nt_atom"))
    write_synthetic_atomicdata(folder, elements=ELEMENTS, nlevels_per_ion=7)
    write_synthetic_nonthermal_data(folder, ELEMENTS)
    ad = atomicdata.read_atomicdata(folder)
    tad_ = tad.read_atomicdata(folder)
    return dict(folder=folder, ad=ad, dad=atomic.to_device(ad), tad=tad_, tdad=to_device(tad_))


def _tables(atom, **kw):
    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    return (jnt.build_nonthermal_data(atom["ad"], atom["dad"], atom["folder"], **kw),
            tnt.build_nonthermal_data(atom["tad"], atom["tdad"], atom["folder"], **kw))


def test_readers_match(atom):
    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    f = atom["folder"]
    assert tnt.read_collion(f"{f}/collion.txt") == jnt.read_collion(f"{f}/collion.txt")
    np.testing.assert_array_equal(tnt.read_binding_energies(f), jnt.read_binding_energies(f))
    for nt_max in (1, 2, 3):
        a = jnt.read_auger_data(f"{f}/auger-km1993-table2.txt", nt_max)
        b = tnt.read_auger_data(f"{f}/auger-km1993-table2.txt", nt_max)
        assert len(a) == len(b) == 12
        for ra, rb in zip(a, b):
            assert ra[:6] == rb[:6] and ra[7] == rb[7]
            np.testing.assert_array_equal(rb[6], ra[6])
            assert rb[6].sum() == pytest.approx(1.0, abs=1e-12)
    for nbound, charge in ((26, 0), (25, 1), (24, 2), (27, 0), (26, 2), (1, 0), (10, 0)):
        np.testing.assert_array_equal(tnt.approx_shell_occupancies(nbound, charge),
                                      jnt.approx_shell_occupancies(nbound, charge))
    en = 0.1 + np.arange(96) * 10.0
    for ionpot, q in ((14.6, 2), (80.0, 6), (700.0, 4)):
        np.testing.assert_array_equal(tnt.xs_ionization_lotz(en, ionpot, q),
                                      jnt.xs_ionization_lotz(en, ionpot, q))


@pytest.mark.parametrize("kw", [dict(sf_points=64), dict(sf_points=128),
                                dict(sf_points=96, maxnlevels_lower=2, maxnlevels_upper=4,
                                     nt_max_auger=3)],
                         ids=["s64", "s128", "caps"])
def test_build_nonthermal_data_matches(atom, kw):
    jt, tt = _tables(atom, **kw)
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if hasattr(a, "shape"):
            b = b.numpy()
            assert b.shape == np.asarray(a).shape, f.name
            if np.asarray(a).dtype.kind == "f":
                assert b.dtype == np.float64, f.name
                np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL_TABLE, atol=0,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(b, np.asarray(a), err_msg=f.name)
        else:
            assert a == b, f.name
    # the excitation table honours the level caps (nonthermal.cc:1785-1806)
    start = atom["tad"].ion_level_start[tt.exc_ion.numpy()]
    assert np.all(tt.exc_lower.numpy() - start < kw.get("maxnlevels_lower", 5))
    assert np.all(tt.exc_upper.numpy() - start < kw.get("maxnlevels_upper", 250))
    assert np.all(tt.exc_eps_ev.numpy() >= tt.sf_emin) and tt.nexc > 0


def test_synthetic_files_exercise_the_table(atom):
    """Younger rows for Fe I-III and Ni I, Lotz rows for Co I-II and Ni II;
    several shells per ion; the row below sf_emin dropped; Auger rows
    matched to K and L shells, each shell's probabilities summing to 1."""
    from artis_tpu_torch.plasma import nonthermal as tnt

    _, tt = _tables(atom, sf_points=64)
    rows = tnt.read_collion(f"{atom['folder']}/collion.txt")
    assert any(r[4] < tt.sf_emin for r in rows)
    shell_ion = tt.shell_ion.numpy()
    counts = np.bincount(shell_ion, minlength=atom["tad"].nions_total)
    assert np.all(counts >= 2)  # every ion has several shells: duplicates in the sums
    ionpot = tt.shell_ionpot_ev.numpy()
    assert ionpot.min() >= tt.sf_emin
    # Younger ions (Fe I-III = 0-2, Ni I = 5) have the 5 rows written for
    # them above sf_emin; the others a Lotz row per occupied shell
    assert list(counts[[0, 1, 2, 5]]) == [5, 5, 5, 5]
    assert all(counts[i] > 5 for i in (3, 4, 6))
    valence = tt.shell_valence_ionpot_ev.numpy()
    for i in range(atom["tad"].nions_total):
        sel = shell_ion == i
        assert np.all(valence[sel] == ionpot[sel].min())
    pa = tt.shell_prob_auger.numpy()
    np.testing.assert_allclose(pa.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    multi = pa[:, 1:].sum(axis=1) > 0.5
    assert multi.sum() == 8  # the K and L2/L3 rows of the four Younger ions
    assert np.all(tt.shell_en_auger_ev.numpy()[multi] > 0)
    xs = tt.shell_xs.numpy()
    assert np.all(np.isfinite(xs)) and np.all(xs >= 0) and np.all(xs.max(axis=1) > 0)
    np.testing.assert_array_equal(tt.ion_topion.numpy(), [2, 2, 2, 4, 4, 6, 6])


def test_wf_oneoverw_factor_matches(atom):
    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    a = jnt.wf_oneoverw_factor(atom["ad"], atom["dad"], atom["folder"])
    b = tnt.wf_oneoverw_factor(atom["tad"], atom["tdad"], atom["folder"])
    np.testing.assert_allclose(b, a, rtol=RTOL_TABLE, atol=0)
    assert np.all(b > 0)
    # a loosely bound neutral has a larger 1/W than its element's top ion
    ion_elem = atom["tad"].ion_element
    for el in np.unique(ion_elem):
        rows = np.nonzero(ion_elem == el)[0]
        assert b[rows[0]] > b[rows[-1]]


def test_interop_carries_the_jax_table(atom):
    from artis_tpu_torch import interop

    jt, tt = _tables(atom, sf_points=64)
    ct = interop.nonthermal_data_from_numpy(_np_fields(jt), atom["tad"].ion_element)
    for f in dataclasses.fields(tt):
        a, b = getattr(tt, f.name), getattr(ct, f.name)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype, f.name
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=f.name)
        else:
            assert a == b, f.name


def _solve_inputs(dad, ncells=6, seed=5):
    """Seeded level populations, ion populations and nne: the ions' totals
    span 1e4-1e8 cm^-3, x_e runs from 1e-3 to 1."""
    rng = np.random.default_rng(seed)
    nnion = 10 ** rng.uniform(4.0, 8.0, (ncells, dad.nions_total))
    nnion[1, 3] = 1e-6  # below MINIONFRACTION of its cell: left out
    lp = 10 ** rng.uniform(-2.0, 6.0, (ncells, dad.nlevels_total))
    nne = nnion.sum(axis=1) * np.logspace(-3.0, 0.0, ncells)
    return lp, nnion, nne


SOLVE_CASES = [dict(sf_auger_contribution_on=a, nt_use_valence_ionpotential=v)
               for a in (True, False) for v in (False, True)]


@pytest.mark.parametrize("case", SOLVE_CASES,
                         ids=[f"auger{int(c['sf_auger_contribution_on'])}-"
                              f"valence{int(c['nt_use_valence_ionpotential'])}"
                              for c in SOLVE_CASES])
def test_solve_spencerfano_matches(atom, case):
    import jax.numpy as jnp

    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    jt, tt = _tables(atom, sf_points=64)
    lp, nnion, nne = _solve_inputs(atom["tad"])
    oj = jnt.solve_spencerfano_cells(jt, atom["dad"], jnp.asarray(lp), jnp.asarray(nnion),
                                     jnp.asarray(nne), **case)
    ot = tnt.solve_spencerfano_cells(tt, atom["tdad"], torch.as_tensor(lp),
                                     torch.as_tensor(nnion), torch.as_tensor(nne), **case)
    assert set(ot) == set(oj)
    for k in oj:
        a, b = np.asarray(oj[k]), ot[k].numpy()
        assert b.dtype == np.float64 and b.shape == a.shape, k
        assert np.all(np.isfinite(b)), k
        np.testing.assert_allclose(b, a, rtol=RTOL_SOLVE, atol=1e-300, err_msg=k)
    fi, fh, fe = (ot[k].numpy() for k in ("frac_ionization", "frac_heating", "frac_excitation"))
    assert np.all((fh > 0) & (fh <= 1)) and np.all(fi > 0) and np.all(fe > 0)
    # the ions of an element's top stage are not ionised further
    assert np.all(ot["frac_ion_by_ion"].numpy()[:, [2, 4, 6]] == 0)


def test_shell_sums_keep_every_shell(atom):
    """frac_ion_by_ion sums all shells of an ion (several per ion here),
    against numpy's add.at of the per-shell fractions; an indexed ``+=``
    would keep one shell per ion."""
    from artis_tpu_torch.plasma import nonthermal as tnt

    _, tt = _tables(atom, sf_points=64)
    lp, nnion, nne = _solve_inputs(atom["tad"])
    out = tnt.solve_spencerfano_cells(tt, atom["tdad"], torch.as_tensor(lp),
                                      torch.as_tensor(nnion), torch.as_tensor(nne))
    y = out["y"].numpy()
    e_init, _ = tnt._source_rhs(tt)
    shell_ion = tt.shell_ion.numpy()
    frac_sh = (nnion[:, shell_ion] * tt.shell_ionpot_ev.numpy()[None, :]
               * (y @ tt.shell_xs.numpy().T) * tt.delta_e / e_init)
    want = np.zeros_like(nnion)
    np.add.at(want.T, shell_ion, frac_sh.T)
    want[:, tt.ion_topion.numpy() == np.arange(nnion.shape[1])] = 0.0
    np.testing.assert_allclose(out["frac_ion_by_ion"].numpy(), want, rtol=1e-12, atol=0)
    last = np.zeros_like(nnion)
    last[:, shell_ion] = frac_sh  # one shell per ion survives
    last[:, tt.ion_topion.numpy() == np.arange(nnion.shape[1])] = 0.0
    assert not np.allclose(last, want, rtol=1e-3)


def test_nt_ionization_ratecoeff_matches():
    import jax.numpy as jnp

    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    rng = np.random.default_rng(9)
    dep = np.array([0.0, 1e-9, 3e-8, 2e-6])
    tot = 10 ** rng.uniform(5.0, 9.0, 4)
    eff = np.where(rng.uniform(size=(4, 7)) < 0.2, 0.0, 10 ** rng.uniform(-10.0, -8.0, (4, 7)))
    a = np.asarray(jnt.nt_ionization_ratecoeff(jnp.asarray(dep), jnp.asarray(tot),
                                               jnp.asarray(eff)))
    b = tnt.nt_ionization_ratecoeff(torch.as_tensor(dep), torch.as_tensor(tot),
                                    torch.as_tensor(eff)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-15, atol=0)
    assert np.all(b[0] == 0) and np.all(b[eff == 0] == 0) and np.all(b[1:][eff[1:] > 0] > 0)


def test_heating_fraction_drops_with_xe(atom):
    """Kozma & Fransson: as x_e = nne / nnion_tot falls, less of the
    deposition heats the gas (tests/test_nonthermal.py). The fractions'
    sum is not held to 1 here: with these made-up cross sections it is
    1.0-1.1, in both packages alike."""
    from artis_tpu_torch.plasma import nonthermal as tnt

    _, tt = _tables(atom, sf_points=128)
    dad = atom["tdad"]
    nnion = torch.zeros((3, dad.nions_total), dtype=torch.float64)
    nnion[:, 0] = 1e8
    pops = torch.zeros((3, dad.nlevels_total), dtype=torch.float64)
    pops[:, int(dad.ion_level_start[0])] = 1e8
    heats = []
    for xe in (1.0, 0.1, 0.01):
        out = tnt.solve_spencerfano_cells(tt, dad, pops, nnion,
                                          torch.full((3,), 1e8 * xe, dtype=torch.float64))
        h, i, e = (float(out[k][0]) for k in ("frac_heating", "frac_ionization",
                                               "frac_excitation"))
        assert 0 <= h <= 1 and 0 <= i <= 1 and 0 <= e <= 1
        heats.append(h)
    assert heats[0] > 0.9 and heats[0] > heats[1] > heats[2]


def test_jax_jitted_solve_drops_diagonal_terms(atom):
    """A reference fault the port does not copy (ROADMAP Queue 3): compiled
    with ``jax.jit``, the JAX package's solve gives another spectrum than
    the same code run eagerly (which the port matches above): XLA computes
    the energy grid of the two broadcasts E and E' with different rounding,
    so ``E' >= E`` fails on parts of the diagonal and those ionisation
    terms drop out of the matrix."""
    import jax
    import jax.numpy as jnp

    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    jt, tt = _tables(atom, sf_points=64)
    lp, nnion, nne = _solve_inputs(atom["tad"])
    args = (jnp.asarray(lp), jnp.asarray(nnion), jnp.asarray(nne))
    jitted = jax.jit(lambda *a: jnt.solve_spencerfano_cells(jt, atom["dad"], *a))(*args)
    port = tnt.solve_spencerfano_cells(tt, atom["tdad"], *(torch.as_tensor(np.array(x))
                                                           for x in args))
    y_j, y_t = np.asarray(jitted["y"]), port["y"].numpy()
    sel = y_t > 0
    assert sel.sum() > 0.9 * y_t.size
    assert np.max(np.abs(y_j[sel] / y_t[sel] - 1.0)) > 1e-3


def test_xs_impactionization_matches():
    """The Younger 1981 fit as a tensor function (the table build inlines
    the same expression on the host)."""
    import jax.numpy as jnp

    from artis_tpu.plasma import nonthermal as jnt
    from artis_tpu_torch.plasma import nonthermal as tnt

    en = 0.1 + np.arange(128) * 125.0
    for ionpot, coef in ((14.6, (2.2, -1.0, 1.6, -0.5)), (720.0, (3.1, -1.2, 1.9, -0.6))):
        a = np.asarray(jnt.xs_impactionization(jnp.asarray(en), ionpot, *coef))
        b = tnt.xs_impactionization(torch.as_tensor(en), ionpot, *coef).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
        assert np.all(b[en <= ionpot] == 0) and np.all(b[en > 1.1 * ionpot] > 0)

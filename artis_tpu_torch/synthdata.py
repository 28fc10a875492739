"""Synthetic atomic datasets and demo run directories.

Used for tests, benchmarks, and the compile-check entry points (the real
atomic datasets are downloaded tarballs in the reference CI, unavailable in a
zero-egress environment). File formats follow the reference parsers
(input.cc:912-1255, 228-327).
"""

import numpy as np


def _ionpot_ev(z, ionstage):
    """The synthetic atom's ionisation potential [eV] of ion (Z, ionstage)."""
    return 7.0 + 5.0 * ionstage + 0.1 * z


def write_synthetic_atomicdata(
    folder,
    elements=((26, 3), (27, 2)),  # (Z, nions)
    nlevels_per_ion=5,
    nphixspoints=20,
    nphixsnuincrement=0.1,
    seed=42,
    nphixs_levels=2,  # lower levels per ion pair given phixs tables
    trans_lo_max=None,  # cap the lower level of written transitions
):
    rng = np.random.default_rng(seed)
    folder = str(folder)

    # compositiondata.txt
    with open(f"{folder}/compositiondata.txt", "w") as f:
        f.write(f"{len(elements)}\n0\n0\n")
        for z, nions in elements:
            mass = 2.0 * z  # rough A ~ 2Z
            f.write(f"{z} {nions} 1 {nions} -1 0.0 {mass}\n")

    # adata.txt: per-(Z, ionstage) blocks; also include an extra ionstage
    # beyond uppermost to exercise skipping
    with open(f"{folder}/adata.txt", "w") as f:
        for z, nions in elements:
            for ionstage in range(1, nions + 2):  # one extra block to skip at end
                nlev = nlevels_per_ion if ionstage <= nions else 2
                ionpot_ev = _ionpot_ev(z, ionstage)
                f.write(f"{z} {ionstage} {nlev} {ionpot_ev:.4f}\n")
                # random (but deterministic) level energies below the
                # ionpot: regular ladder spacings make many transitions
                # exactly or nearly degenerate, which creates unphysical
                # zero-distance resonance-interlocking loops that real
                # atomic data cannot produce
                fracs = np.sort(rng.uniform(0.08, 0.93, nlev - 1))
                for lev in range(1, nlev + 1):
                    energy = 0.0 if lev == 1 else ionpot_ev * fracs[lev - 2]
                    g = 2.0 * lev  # distinct stat weights
                    f.write(f"{lev} {energy:.8f} {g:.1f} {max(lev - 1, 0)}\n")

    # transitiondata.txt: same block order; downward transitions with random A
    with open(f"{folder}/transitiondata.txt", "w") as f:
        for z, nions in elements:
            for ionstage in range(1, nions + 2):
                nlev = nlevels_per_ion if ionstage <= nions else 2
                rows = []
                lo_hi = nlev if trans_lo_max is None else min(
                    trans_lo_max, nlev)
                for lo in range(1, lo_hi + 1):
                    for up in range(lo + 1, nlev + 1):
                        A = 10.0 ** rng.uniform(4, 8)
                        coll_str = -1.0
                        forbidden = 0
                        rows.append(f"{lo} {up} {A:.4e} {coll_str} {forbidden}")
                f.write(f"{z} {ionstage} {len(rows)}\n")
                f.write("\n".join(rows) + "\n")

    # phixsdata_v2.txt: ground + excited-level tables for each non-top ion
    with open(f"{folder}/phixsdata_v2.txt", "w") as f:
        f.write(f"{nphixspoints}\n{nphixsnuincrement}\n")
        for z, nions in elements:
            for ionstage in range(1, nions):  # lower ion of each pair
                nlo = min(max(nphixs_levels, 1), nlevels_per_ion)
                for lowerlevel in range(1, nlo + 1):  # 1-based
                    if lowerlevel == 1:
                        # multi-target table
                        f.write(f"{z} {ionstage + 1} -1 {ionstage} {lowerlevel} 10.0\n")
                        f.write("2\n1 0.7\n2 0.3\n")
                    else:
                        f.write(f"{z} {ionstage + 1} 1 {ionstage} {lowerlevel} 10.0\n")
                    sigma0 = rng.uniform(1.0, 10.0)  # Mb
                    xs = sigma0 * (1.0 + np.arange(nphixspoints) * nphixsnuincrement) ** -3
                    f.write("\n".join(f"{x:.6e}" for x in xs) + "\n")

    return folder


# x-ray shells of the synthetic collion.txt rows: (n, l, binding energy of
# neutral Fe [eV], the shell's index in the binding-energy table, whose
# hydrogenic scaling moves it with Z), inner to outer; the valence shell
# takes the synthetic atom's ionisation potential
_COLLION_SHELLS = ((1, 0, 7112.0, 0), (2, 1, 721.0, 2), (3, 1, 56.0, 5), (3, 2, 9.0, 7))
# Kaastra & Mewe 1993 table 2 style rows: x-ray shell number (1 = K,
# 3 = L2, 4 = L3), mean Auger-electron energy as a fraction of the shell's
# binding energy, and the probabilities of 0..9 Auger electrons in units of
# 1e-4 (each row sums to 10000; the reader takes the first nine)
_AUGER_ROWS = ((1, 0.85, (40, 1310, 7420, 1130, 100, 0, 0, 0, 0, 0)),
               (3, 0.70, (120, 8650, 1180, 50, 0, 0, 0, 0, 0, 0)),
               (4, 0.72, (150, 8710, 1100, 40, 0, 0, 0, 0, 0, 0)))
_SHELL_N = (1, 2, 2, 2, 3, 3, 3, 3, 3, 4)  # K L1 L2 L3 M1-M5 N1
_SHELL_CAP = (2, 2, 2, 4, 2, 2, 4, 4, 6, 2)


def _binding_energy_ev(z, shellindex):
    """Hydrogenic binding energy [eV] of x-ray shell ``shellindex`` (K L1
    L2 L3 M1 M2 M3 M4 M5 N1) of element Z, screened by the electrons of
    the shells inside it; 0 where the neutral atom has no electron in it."""
    inner = sum(_SHELL_CAP[:shellindex])
    if inner >= z:
        return 0.0
    zeff = z - inner
    n = _SHELL_N[shellindex]
    # split the sub-shells of one n a little, outer sub-shells less bound
    return 13.6057 * zeff**2 / n**2 * (1.0 - 0.02 * shellindex)


def write_synthetic_nonthermal_data(folder, elements=((26, 3), (27, 2))):
    """Synthetic versions of the three data files the non-thermal solver
    reads, for the atom ``write_synthetic_atomicdata(folder, elements)``
    writes (reference formats: nonthermal.cc:598-660 collion.txt,
    240-285 binding_energies.txt, 345-470 auger-km1993-table2.txt):

    - ``collion.txt``: Younger-fit rows (K, L2/L3, M2/M3 and M4/M5 shells
      scaled from neutral Fe, and the valence shell at the atom's
      ionisation potential) for every ion of the first element and the
      neutral of the last, so that the other ions take the Lotz rows the
      solver synthesises; one row below ``sf_emin`` (dropped) and one for
      an ion the atom lacks (skipped);
    - ``binding_energies.txt`` (the old format: ``nshells n_z``, then one
      row of 10 shells per Z up to 30), hydrogenic with inner-shell
      screening;
    - ``auger-km1993-table2.txt``: the fixed-width table with K, L2 and L3
      rows for the ions with Younger rows.

    The values are made up to exercise the readers and the solver; they
    are not the ARTIS atomic tables. Returns ``folder``."""
    folder = str(folder)
    younger = [(elements[0][0], s) for s in range(1, elements[0][1] + 1)]
    if len(elements) > 1:
        younger.append((elements[-1][0], 1))
    rows = []
    for z, stage in younger:
        scale = ((z - stage + 1) / 26.0) ** 2
        valence = _ionpot_ev(z, stage)
        for k, (n, l, e_fe, _) in enumerate(_COLLION_SHELLS):
            ionpot = max(e_fe * scale, valence * (1.2 + 0.3 * k))
            a, b, c, d = 2.2 + 0.3 * k, -1.0 - 0.1 * k, 1.6 + 0.2 * stage, -0.5
            rows.append(f"{z} {stage} {n} {l} {ionpot:.4f} {a:.4f} {b:.4f} {c:.4f} {d:.4f}")
        rows.append(f"{z} {stage} 4 0 {valence:.4f} 3.1 -1.2 1.9 -0.6")
    z0, n0 = elements[0]
    rows.append(f"{z0} 1 5 0 0.0500 1.0 0.0 1.0 0.0")  # below sf_emin: dropped
    rows.append(f"{z0} {n0 + 2} 4 0 {_ionpot_ev(z0, n0 + 2):.4f} 1.0 0.0 1.0 0.0")  # no ion
    with open(f"{folder}/collion.txt", "w") as f:
        f.write(f"{len(rows)}\n")
        f.write("# synthetic Younger-fit rows, not ARTIS data\n")
        f.write("\n".join(rows) + "\n")

    nz = max(30, max(z for z, _ in elements))
    with open(f"{folder}/binding_energies.txt", "w") as f:
        f.write("# synthetic hydrogenic binding energies [eV], not ARTIS data:\n")
        f.write("# one row per Z = 1..n_z, shells K L1 L2 L3 M1 M2 M3 M4 M5 N1\n")
        f.write(f"10 {nz}\n")
        for z in range(1, nz + 1):
            f.write(" ".join(f"{_binding_energy_ev(z, s):.3f}" for s in range(10)) + "\n")

    with open(f"{folder}/auger-km1993-table2.txt", "w") as f:
        f.write("# synthetic Auger probabilities, not Kaastra & Mewe 1993\n")
        for z, stage in younger:
            scale = ((z - stage + 1) / 26.0) ** 2
            for shellnum, enfrac, probs in _AUGER_ROWS:
                e_fe = 7112.0 if shellnum == 1 else 721.0
                ionpot = e_fe * scale
                f.write(f"{z:2d}{stage:3d}{shellnum:3d}{ionpot:7.1f}{enfrac * ionpot:7.1f}"
                        f"{100:3d} " + "".join(f"{p:5d}" for p in probs) + "\n")
    return folder


# a few of the strongest Ni56 and Co56 gamma lines (MeV, photons per decay)
GAMMA_LINES = {"ni56": ((0.158, 0.988), (0.750, 0.495), (0.812, 0.860)),
               "co56": ((0.847, 1.000), (1.238, 0.670), (2.598, 0.170))}


def write_synthetic_gamma_lines(folder):
    """``ni56_lines.txt`` and ``co56_lines.txt`` (``GAMMA_LINES``), so that
    decays make gamma packets. Returns ``folder``."""
    for nuc, lines in GAMMA_LINES.items():
        with open(f"{folder}/{nuc}_lines.txt", "w") as f:
            f.write(f"{len(lines)}\n" + "".join(f"{e} {p}\n" for e, p in lines))
    return folder


def write_synthetic_xcom_data(folder, elements=((26, 3), (27, 2), (28, 2))):
    """A synthetic ``xcom_photoion_data.txt`` (reference format,
    gammapkt.cc:209-256: rows ``Z  E[MeV]  sigma[barn]``) for the atom
    ``write_synthetic_atomicdata(folder, elements)`` writes: photoelectric
    cross-sections falling as E^-3.2 from 10 keV, scaled as Z^4.5 from
    20 barn for Fe at 100 keV. The first element's table covers 0.01-10 MeV
    in 41 rows; the second's ends at 1 MeV (21 rows), below the strongest
    Co56 lines, so that the tables have different lengths; with more than
    one element the last is left out (its table has no row), and one row
    is for an element the atom lacks. The values are made up to exercise
    the reader and the interpolation; they are not NIST XCOM data.
    Returns ``folder``."""
    folder = str(folder)
    zs = [z for z, _ in elements]
    written = zs[:-1] if len(zs) > 1 else zs
    rows = ["# synthetic photoelectric cross-sections, not NIST XCOM data",
            "# Z  E[MeV]  sigma[barn/atom]"]
    for k, z in enumerate(written + [1]):
        hi = 10.0 if k == 0 or z == 1 else 1.0
        for e in np.logspace(-2.0, np.log10(hi), 41 if hi == 10.0 else 21):
            sigma = 20.0 * (z / 26.0) ** 4.5 * (e / 0.1) ** -3.2
            rows.append(f"{z} {e:.6e} {sigma:.6e}")
    with open(f"{folder}/xcom_photoion_data.txt", "w") as f:
        f.write("\n".join(rows) + "\n")
    return folder


import numpy as np


INPUT_TXT = """\
42                       # pre_zseed
{ntimesteps}             # ntimesteps
000 {tsfinish:03d}       # timestep_start timestep_finish
{tmin_days} {tmax_days}  # tmin_days tmax_days
1.33  1.330000001        # UNUSED
80                       # UNUSED
3. 0.037                 # UNUSED
1                        # UNUSED
4                        # UNUSED
1                        # UNUSED
1.0                      # UNUSED
-1                       # gamma grey opacity (<0: detailed)
0 0 1                    # UNUSED syn_dir
{opacity_case}                        # opacity_case
{rho_crit_para}                  # rho_crit_para
-1                       # UNUSED debug
0                        # continue
1e-6                     # UNUSED rfcut
{nltets}                  # num_lte_timesteps
0.0 {ngreyts}            # cell_is_optically_thick num_grey_timesteps
-1                       # UNUSED max_bf_continua
1                        # nprocs_exspec
1                        # do_emission_res
0.001 1000               # kpkt diffusion
"""


def make_run(folder, ncells=10, ntimesteps=8, tmin_days=0.4, tmax_days=3.0,
             ngreyts=3, vmax_kmps=30000.0, t_model_days=0.05, x_ni56=0.5,
             num_lte_timesteps=999, logrho0=-9.0, logrho_slope=-0.25,
             model_dim=1, opacity_case=4, rho_crit_para=1.0e-10):
    """Write a synthetic Ni56-powered run directory.

    model_dim selects the model.txt dimensionality (mirroring the reference's
    auto-detected formats, grid.cc:1841-1886): 1 = radial shells (ncells
    shells), 2 = cylindrical (ncells x 2*ncells grid of (rcyl, z) cells),
    3 = Cartesian cube (ncells^3 cells). The 2D/3D density fields are the
    same radial power-law profile evaluated at the cell midpoint.
    """
    folder = str(folder)
    with open(f"{folder}/input.txt", "w") as f:
        f.write(INPUT_TXT.format(ntimesteps=ntimesteps, tsfinish=ntimesteps - 1,
                                 tmin_days=tmin_days, tmax_days=tmax_days, ngreyts=ngreyts,
                                 nltets=num_lte_timesteps,
                                 opacity_case=opacity_case,
                                 rho_crit_para=rho_crit_para))

    vmax_cms = vmax_kmps * 1e5
    t_model_s = t_model_days * 86400.0

    def rho_at(vfrac):
        """Density at t_model for a cell whose midpoint speed is vfrac*vmax,
        matching the 1D shells' 10**(logrho0 + slope*i) ladder."""
        return 10.0 ** (logrho0 + logrho_slope * vfrac * (ncells - 1))

    if model_dim == 1:
        npts = ncells
        with open(f"{folder}/model.txt", "w") as f:
            f.write(f"{ncells}\n{t_model_days}\n")
            f.write("#inputcellid velocity_outer logrho X_Fegroup X_Ni56 X_Co56 X_Fe52 X_Cr48\n")
            for i in range(ncells):
                vout = vmax_kmps * (i + 1) / ncells
                logrho = logrho0 + logrho_slope * i
                f.write(f"{i + 1} {vout} {logrho} 1.0 {x_ni56} 0.0 0.0 0.0\n")
    elif model_dim == 2:
        n_rcyl, n_z = ncells, 2 * ncells
        npts = n_rcyl * n_z
        d_rcyl = vmax_cms * t_model_s / n_rcyl
        d_z = 2.0 * vmax_cms * t_model_s / n_z
        with open(f"{folder}/model.txt", "w") as f:
            f.write(f"{n_rcyl} {n_z}\n{t_model_days}\n{vmax_cms:.6e}\n")
            f.write("#inputcellid pos_rcyl_mid pos_z_mid rho X_Fegroup X_Ni56 X_Co56 X_Fe52 X_Cr48\n")
            cid = 1
            for iz in range(n_z):
                for ir in range(n_rcyl):
                    rmid = (ir + 0.5) * d_rcyl
                    zmid = -vmax_cms * t_model_s + (iz + 0.5) * d_z
                    vfrac = min(np.hypot(rmid, zmid) / (vmax_cms * t_model_s), 1.0)
                    rho = rho_at(vfrac) if vfrac < 1.0 else 0.0
                    f.write(f"{cid} {rmid:.6e} {zmid:.6e} {rho:.6e} "
                            f"1.0 {x_ni56} 0.0 0.0 0.0\n")
                    cid += 1
    elif model_dim == 3:
        n = ncells
        npts = n ** 3
        wid = 2.0 * vmax_cms * t_model_s / n
        with open(f"{folder}/model.txt", "w") as f:
            f.write(f"{npts}\n{t_model_days}\n{vmax_cms:.6e}\n")
            f.write("#inputcellid pos_x_min pos_y_min pos_z_min rho X_Fegroup X_Ni56 X_Co56 X_Fe52 X_Cr48\n")
            cid = 1
            for iz in range(n):
                for iy in range(n):
                    for ix in range(n):
                        xm = -vmax_cms * t_model_s + (ix + 0.5) * wid
                        ym = -vmax_cms * t_model_s + (iy + 0.5) * wid
                        zm = -vmax_cms * t_model_s + (iz + 0.5) * wid
                        vfrac = np.sqrt(xm * xm + ym * ym + zm * zm) / (vmax_cms * t_model_s)
                        rho = rho_at(vfrac) if vfrac < 1.0 else 0.0
                        f.write(f"{cid} {xm - 0.5 * wid:.6e} {ym - 0.5 * wid:.6e} "
                                f"{zm - 0.5 * wid:.6e} {rho:.6e} "
                                f"1.0 {x_ni56} 0.0 0.0 0.0\n")
                        cid += 1
    else:
        raise ValueError(f"model_dim must be 1, 2 or 3, got {model_dim}")

    # pure Fe/Co/Ni-ish gas: element Z=26,27,28 fractions (abundances.txt
    # columns are Z=1..30); all mass in Ni (Z=28) to match X_Ni56 decaying
    with open(f"{folder}/abundances.txt", "w") as f:
        for i in range(npts):
            ab = np.zeros(30)
            ab[27] = 0.6  # Z=28 Ni (>= X_Ni56 so stable Ni remains)
            ab[25] = 0.3  # Z=26 Fe
            ab[26] = 0.1  # Z=27 Co
            f.write(f"{i + 1} " + " ".join(f"{v:g}" for v in ab) + "\n")

    write_synthetic_atomicdata(
        folder, elements=((26, 3), (27, 2), (28, 2)), nlevels_per_ion=8
    )
    return folder

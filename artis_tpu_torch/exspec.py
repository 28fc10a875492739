"""exspec: post-process escaped packets into spectra and light curves.

A copy of the JAX package's exspec (host numpy, no device work), the
port of the reference post-processor (reference:
exspec.cc:28-151 do_angle_bin, exspec.cc:155-248 main). Reads every rank's
packets file and produces angle-averaged (and, for 3D models, angle-resolved)
spec.out / light_curve.out / gamma_spec.out / gamma_light_curve.out with the
reference's file layout; with ``pol_on`` also the Stokes I / Q / U
spectra, specpol.out.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np

from . import spectrum as spectrum_mod
from .constants import DAY, H, MEV
from .io import inputparams as inputparams_io
from .packets import TYPE_ESCAPE, TYPE_GAMMA, TYPE_RPKT, read_packets_text

NU_MIN_GAMMA = 0.05 * MEV / H  # reference: exspec.cc:44-45
NU_MAX_GAMMA = 4.0 * MEV / H


def _escape_dir_bins(dirvec, ncosthetabins=10, nphibins=10):
    """Host-side escape-direction binning (reference: vectors.h:172-202)."""
    syn_dir = np.array([0.0, 0.0, 1.0])
    xhat = np.array([1.0, 0.0, 0.0])
    d = dirvec / np.linalg.norm(dirvec, axis=-1, keepdims=True)
    costheta = d @ syn_dir
    costhetabin = np.minimum(((costheta + 1.0) * nphibins / 2.0).astype(int), ncosthetabins - 1)
    vec1 = np.cross(d, syn_dir)
    vec2 = np.cross(np.broadcast_to(xhat, d.shape), syn_dir)
    n1 = np.linalg.norm(vec1, axis=-1)
    n2 = np.linalg.norm(vec2, axis=-1)
    cosphi = np.clip(np.sum(vec1 * vec2, axis=-1) / np.maximum(n1 * n2, 1e-300), -1, 1)
    vec3 = np.cross(vec2, syn_dir)
    testphi = np.sum(vec1 * vec3, axis=-1)
    phi = np.where(testphi >= 0, np.arccos(cosphi), np.arccos(cosphi) + np.pi)
    phibin = np.minimum((phi / 2.0 / np.pi * nphibins).astype(int), nphibins - 1)
    return costhetabin * nphibins + phibin


def build_emission_columns(ad):
    """Column maps for the per-process emission and per-ion absorption
    breakdown (reference: spectrum_lightcurve.cc:135-183
    get_proccount/columnindex_from_emissiontype/get_absindex).

    Emission columns: [0, nelements*max_nions) bb by (element, ion),
    [nelements*max_nions, 2*nelements*max_nions) bf by (element, ion),
    last column = free-free. Absorption columns: (element, ion) of the
    absorbing line.
    """
    from .packets import EMTYPE_FREEFREE, EMTYPE_NOTSET

    max_nions = ad.max_nions
    nelements = ad.nelements
    ioncount = nelements * max_nions
    proccount = 2 * ioncount + 1

    line_col = ad.line_element.astype(np.int64) * max_nions + ad.line_ion.astype(np.int64)

    # bf emission types are -1-k with k ordered by lower unique level
    # (macroatom.build_aux emtype encoding == reference level_cont_index)
    cont_uii = ad.elem_ion_start[ad.cont_element].astype(np.int64) + ad.cont_ion
    cont_lower_unique = ad.ion_level_start[cont_uii] + ad.cont_level
    order_l = np.argsort(cont_lower_unique, kind="stable")
    bf_col_by_k = (
        ioncount
        + ad.cont_element[order_l].astype(np.int64) * max_nions
        + ad.cont_ion[order_l].astype(np.int64)
    )
    ncont = len(bf_col_by_k)

    def emission_column(et):
        et = np.asarray(et, np.int64)
        col = np.full(et.shape, -1, np.int64)
        bb = et >= 0
        col[bb] = line_col[np.clip(et[bb], 0, len(line_col) - 1)]
        col[et == EMTYPE_FREEFREE] = 2 * ioncount
        bf = (et < 0) & (et != EMTYPE_FREEFREE) & (et != EMTYPE_NOTSET)
        k = -1 - et[bf]
        valid = (k >= 0) & (k < ncont)
        bfcol = np.where(valid, bf_col_by_k[np.clip(k, 0, max(ncont - 1, 0))], 2 * ioncount)
        col[bf] = bfcol
        return col

    def absorption_column(at):
        at = np.asarray(at, np.int64)
        return line_col[np.clip(at, 0, len(line_col) - 1)]

    return emission_column, absorption_column, proccount, ioncount


def run_exspec(rundir: str, opts, angle_resolved: bool | None = None) -> None:
    p = inputparams_io.read_parameterfile(os.path.join(rundir, "input.txt"))
    ts = inputparams_io.time_init(p.tmin, p.tmax, p.ntimesteps, opts.timestep_size_method,
                                  opts.fixed_timestep_width, opts.timestep_transition_time)
    ts_start = ts.start[:-1]
    width = ts.width[:-1]

    files = sorted(glob.glob(os.path.join(rundir, "packets00_*.out")))
    assert files, f"no packets00_*.out files in {rundir}"
    pkts = [read_packets_text(f) for f in files]
    nprocs = len(files)

    allp = {k: np.concatenate([d[k] for d in pkts]) for k in pkts[0]}
    esc = allp["ptype"] == TYPE_ESCAPE
    esc_r = esc & (allp["escape_type"] == TYPE_RPKT)
    esc_g = esc & (allp["escape_type"] == TYPE_GAMMA)
    # vmax from escape positions is not known here: re-read model header
    from .io import model as model_io
    model = model_io.read_model(os.path.join(rundir, "model.txt"), p.tmin)
    vmax = model.vmax

    # in 1D, only the angle-averaged bin is used (reference: exspec.cc:231)
    abins = [-1]
    if angle_resolved is None:
        angle_resolved = model.dim == 3 and p.do_emission_res
    if angle_resolved:
        abins += list(range(opts.mabins))

    # per-process emission / per-ion absorption breakdown needs the atomic
    # data for the (element, ion) of each line and bf continuum
    do_emission_res = bool(p.do_emission_res)
    emission_column = absorption_column = None
    proccount = ioncount = 0
    if do_emission_res:
        from .io import atomicdata as atomicdata_io

        ad = atomicdata_io.read_atomicdata(rundir)
        emission_column, absorption_column, proccount, ioncount = build_emission_columns(ad)

    def spectra_kwargs(sel):
        if not do_emission_res:
            return {}
        return dict(
            emissiontype=allp["emissiontype"][sel],
            trueemissiontype=allp["trueemissiontype"][sel],
            emission_column=emission_column,
            absorptiontype=allp["absorptiontype"][sel],
            absorptionfreq=allp["absorptionfreq"][sel],
            absorption_column=absorption_column,
        )

    for abin in abins:
        if abin == -1:
            sel_r, sel_g = esc_r, esc_g
            anglefactor = 1.0
            suffix = ""
        else:
            bins = _escape_dir_bins(allp["dir"], opts.ncosthetabins, opts.nphibins)
            sel_r = esc_r & (bins == abin)
            sel_g = esc_g & (bins == abin)
            anglefactor = float(opts.mabins)
            suffix = f"_res_{abin:02d}"

        spec = spectrum_mod.init_spectra(
            opts.nu_min_r, opts.nu_max_r, p.ntimesteps,
            do_emission_res=do_emission_res, proccount=proccount, ioncount=ioncount,
        )
        lum = np.zeros(p.ntimesteps)
        lumcmf = np.zeros(p.ntimesteps)
        spectrum_mod.add_packets_to_spectra(
            spec, allp["pos"][sel_r], allp["dir"][sel_r], allp["escape_time"][sel_r],
            allp["nu_rf"][sel_r], allp["e_rf"][sel_r], ts_start, p.tmin, p.tmax,
            nprocs=nprocs, anglefactor=anglefactor, **spectra_kwargs(sel_r),
        )
        if abin == -1:
            spectrum_mod.add_packets_to_lightcurve(
                lum, lumcmf, allp["pos"][sel_r], allp["dir"][sel_r],
                allp["escape_time"][sel_r], allp["e_rf"][sel_r], allp["e_cmf"][sel_r],
                ts_start, p.tmin, p.tmax, vmax, nprocs=nprocs,
            )
        # reference filename convention: emission.out / emissiontrue.out /
        # absorption.out (+_res_NN for angle bins), exspec.cc:100-133
        sep = "_res_" + suffix.rsplit("_", 1)[-1] if suffix else ""
        spectrum_mod.write_spectrum(
            os.path.join(rundir, f"spec{suffix}.out"), spec, ts.mid[:-1],
            emission_path=os.path.join(rundir, f"emission{sep}.out") if do_emission_res else None,
            trueemission_path=os.path.join(rundir, f"emissiontrue{sep}.out") if do_emission_res else None,
            absorption_path=os.path.join(rundir, f"absorption{sep}.out") if do_emission_res else None,
        )
        spectrum_mod.write_light_curve(
            os.path.join(rundir, f"light_curve{suffix}.out"), ts.mid[:-1], lum, lumcmf
        )

        if opts.pol_on:
            stokes = allp["stokes"]
            sps = []
            for comp in range(3):
                sp = spectrum_mod.init_spectra(
                    opts.nu_min_r, opts.nu_max_r, p.ntimesteps,
                    do_emission_res=do_emission_res, proccount=proccount, ioncount=ioncount,
                )
                spectrum_mod.add_packets_to_spectra(
                    sp, allp["pos"][sel_r], allp["dir"][sel_r], allp["escape_time"][sel_r],
                    allp["nu_rf"][sel_r], allp["e_rf"][sel_r], ts_start, p.tmin, p.tmax,
                    nprocs=nprocs, anglefactor=anglefactor, weight=stokes[sel_r, comp],
                    **spectra_kwargs(sel_r),
                )
                sps.append(sp)
            spectrum_mod.write_specpol(
                os.path.join(rundir, f"specpol{suffix}.out"), *sps, ts.mid[:-1],
                emission_path=os.path.join(rundir, f"emissionpol{sep}.out") if do_emission_res else None,
                absorption_path=os.path.join(rundir, f"absorptionpol{sep}.out") if do_emission_res else None,
            )

        if abin == -1:
            gspec = spectrum_mod.init_spectra(NU_MIN_GAMMA, NU_MAX_GAMMA, p.ntimesteps)
            glum = np.zeros(p.ntimesteps)
            glumcmf = np.zeros(p.ntimesteps)
            spectrum_mod.add_packets_to_spectra(
                gspec, allp["pos"][sel_g], allp["dir"][sel_g], allp["escape_time"][sel_g],
                allp["nu_rf"][sel_g], allp["e_rf"][sel_g], ts_start, p.tmin, p.tmax,
                nprocs=nprocs,
            )
            spectrum_mod.add_packets_to_lightcurve(
                glum, glumcmf, allp["pos"][sel_g], allp["dir"][sel_g],
                allp["escape_time"][sel_g], allp["e_rf"][sel_g], allp["e_cmf"][sel_g],
                ts_start, p.tmin, p.tmax, vmax, nprocs=nprocs,
            )
            spectrum_mod.write_spectrum(os.path.join(rundir, "gamma_spec.out"), gspec, ts.mid[:-1])
            spectrum_mod.write_light_curve(
                os.path.join(rundir, "gamma_light_curve.out"), ts.mid[:-1], glum, glumcmf
            )

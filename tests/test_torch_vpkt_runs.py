"""Virtual packets in whole runs of the port against the JAX package, on
the CPU, from the same pellets (the JAX package in float64, the port in
float32 and in float64, the presets' default; the JAX run is made once
for both), two timesteps each: the classic miniature's 6-shell model (days
1-2, logrho0 -7.5) under kilonova_lte on a 1D grid (two observers, all
opacity, and the thick-cell override: the synthetic input.txt's
cell_is_optically_thick of 0 would make every cell vpkt-thick) and under
classic on a 6^3 grid (the chip scene's vpkt.txt: three observers, the
six exclusion channels, the velocity-grid maps). The Stokes I of
specpol_virtual.out summed per observer and channel agrees within
4/sqrt(n), n the effective number of rays behind the JAX run's total,
(sum I)^2 / sum I^2 over its time-frequency bins (a bin holds one or more
rays, so this is at most the rays' count: most rays of these cold scenes
die on a thick line, and a few escaping ones carry the total).

The real packets' independence of vpkt_on and the checkpoint are in
tests/test_torch_vpkt.py."""

import os

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts, rel_close
from test_torch_vpkt import CLASSIC, VPKT_TXT

torch.set_num_threads(1)

# the JAX package's run of each case (its pellets, the Stokes I totals
# (nobs, nspec) of its specpol accumulators in erg and its effective ray
# counts), made once for both transport dtypes of the port
_JAX_RUNS = {}


def _run_dir(tmp, name, make_kw, vpkt_txt):
    d = tmp / name
    d.mkdir()
    make_run(str(d), **make_kw)
    if vpkt_txt:
        (d / "vpkt.txt").write_text(vpkt_txt)
    return str(d)


def _jax_run(tmp, name, make_kw, jopts, vpkt_txt):
    import artis_tpu.driver as jd

    if name not in _JAX_RUNS:
        sj = jd.Simulation(_run_dir(tmp, f"{name}_jax", make_kw, vpkt_txt), jopts,
                           datadir="/nonexistent")
        pellets = np_fields(sj.state)
        for nts in range(2):
            sj.do_timestep(nts)
        bins = np.asarray(sj._vspec_total)[..., 0]
        n_eff = bins.sum(axis=(2, 3)) ** 2 / np.maximum((bins ** 2).sum(axis=(2, 3)), 1e-300)
        _JAX_RUNS[name] = (pellets, bins.sum(axis=(2, 3)) * sj._e0, n_eff)
    return _JAX_RUNS[name]


def _pair(tmp, name, make_kw, jopts, vpkt_txt=None, dtype="float32"):
    """Two timesteps of both packages from the same pellets, the port at
    transport ``dtype``. Returns the Stokes I totals (nobs, nspec) of each
    side's specpol accumulators (erg), the JAX run's effective ray counts
    (nobs, nspec) and the port's Simulation."""
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    pellets, tot_jax, n_eff = _jax_run(tmp, name, make_kw, jopts, vpkt_txt)
    d = _run_dir(tmp, f"{name}_port", make_kw, vpkt_txt)
    st = td.Simulation(d, port_opts(jopts, transport_dtype=dtype), datadir="/nonexistent",
                       device="cpu")
    st.state = interop.from_numpy(PacketState, pellets, dtype=getattr(torch, dtype))
    for nts in range(2):
        st.do_timestep(nts)
    st.finish()
    st.close()
    tot = {"jax": tot_jax, "port": np.asarray(st._vspec_total)[..., 0].sum(axis=(2, 3)) * st._e0}
    out = np.loadtxt(os.path.join(d, "specpol_virtual.out"), skiprows=1)
    assert np.all(np.isfinite(out)) and out.shape[0] == tot["port"].size * 3 * 1000
    return tot, n_eff, st


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["kilonova_1d", "classic_3d"])
def test_whole_run_matches_jax(case, dtype, tmp_path):
    import artis_tpu.options as jo

    if case == "kilonova_1d":
        jopts = jo.kilonova_lte(npkts=1000, grid_type=jo.GridType.SPHERICAL1D, mintemp=1000.0,
                                maxtemp=20000.0, tablesize=12, vpkt_on=True)
        tot, n, _ = _pair(tmp_path, case, CLASSIC, jopts,
                          "2\n0.5 -0.5\n0 180\n0\n0 0 0\n0\n1 1e9\n10\n0\n", dtype)
        assert tot["port"].shape == (2, 1)
    else:
        jopts = jo.classic(npkts=300, grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=6,
                           ncoordgrid_y=6, ncoordgrid_z=6, mintemp=1000.0, maxtemp=20000.0,
                           tablesize=12, vpkt_on=True)
        tot, n, st = _pair(tmp_path, case, CLASSIC, jopts, VPKT_TXT, dtype)
        assert tot["port"].shape == (3, 6)
        assert st._vgrid_total[..., 0].sum() > 0
    assert np.all(n > 10) and np.all(tot["jax"] > 0), (n, tot)
    for (o, c), a in np.ndenumerate(tot["jax"]):
        rel_close(float(a), float(tot["port"][o, c]), float(n[o, c]),
                  f"{case} observer {o} channel {c}")

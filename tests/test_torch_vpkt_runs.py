"""Virtual packets in whole runs of the port against the JAX package, on
the CPU, from the same pellets (the JAX package in float64, the port in
float32), two timesteps each: the classic miniature's 6-shell model (days
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

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts, rel_close
from test_torch_vpkt import CLASSIC, VPKT_TXT

torch.set_num_threads(1)

def _pair(tmp, name, make_kw, jopts, vpkt_txt=None):
    """Two timesteps of both packages from the same pellets. Returns the
    Stokes I totals (nobs, nspec) of each side's specpol accumulators
    (erg), the JAX run's effective ray counts (nobs, nspec) and the port's
    Simulation."""
    import artis_tpu.driver as jd
    import artis_tpu_torch.driver as td
    from artis_tpu_torch import interop
    from artis_tpu_torch.packets import PacketState

    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp / f"{name}_{side}"
        dirs[side].mkdir()
        make_run(str(dirs[side]), **make_kw)
        if vpkt_txt:
            (dirs[side] / "vpkt.txt").write_text(vpkt_txt)
    sj = jd.Simulation(str(dirs["jax"]), jopts, datadir="/nonexistent")
    st = td.Simulation(str(dirs["port"]), port_opts(jopts, transport_dtype="float32"),
                       datadir="/nonexistent", device="cpu")
    st.state = interop.from_numpy(PacketState, np_fields(sj.state), dtype=torch.float32)
    for nts in range(2):
        sj.do_timestep(nts)
        st.do_timestep(nts)
    st.finish()
    st.close()
    tot = {side: np.asarray(sim._vspec_total)[..., 0].sum(axis=(2, 3)) * sim._e0
           for side, sim in (("jax", sj), ("port", st))}
    bins = np.asarray(sj._vspec_total)[..., 0]
    n_eff = bins.sum(axis=(2, 3)) ** 2 / np.maximum((bins ** 2).sum(axis=(2, 3)), 1e-300)
    out = np.loadtxt(dirs["port"] / "specpol_virtual.out", skiprows=1)
    assert np.all(np.isfinite(out)) and out.shape[0] == tot["port"].size * 3 * 1000
    return tot, n_eff, st


@pytest.mark.parametrize("case", ["kilonova_1d", "classic_3d"])
def test_whole_run_matches_jax(case, tmp_path):
    import artis_tpu.options as jo

    if case == "kilonova_1d":
        jopts = jo.kilonova_lte(npkts=1000, grid_type=jo.GridType.SPHERICAL1D, mintemp=1000.0,
                                maxtemp=20000.0, tablesize=12, vpkt_on=True)
        tot, n, _ = _pair(tmp_path, case, CLASSIC, jopts,
                          "2\n0.5 -0.5\n0 180\n0\n0 0 0\n0\n1 1e9\n10\n0\n")
        assert tot["port"].shape == (2, 1)
    else:
        jopts = jo.classic(npkts=300, grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=6,
                           ncoordgrid_y=6, ncoordgrid_z=6, mintemp=1000.0, maxtemp=20000.0,
                           tablesize=12, vpkt_on=True)
        tot, n, st = _pair(tmp_path, case, CLASSIC, jopts, VPKT_TXT)
        assert tot["port"].shape == (3, 6)
        assert st._vgrid_total[..., 0].sum() > 0
    assert np.all(n > 10) and np.all(tot["jax"] > 0), (n, tot)
    for (o, c), a in np.ndenumerate(tot["jax"]):
        rel_close(float(a), float(tot["port"][o, c]), float(n[o, c]),
                  f"{case} observer {o} channel {c}")

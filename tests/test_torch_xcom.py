"""XCOM gamma photoionisation (``use_xcom_gammaphotoion``) on the port
against the JAX package, on the CPU.

The table is ``synthdata.write_synthetic_xcom_data``'s: Fe over 0.01-10 MeV
(41 rows), Co over 0.01-1 MeV (21 rows, ending below the strongest Co56
lines), Ni left out (no row) and a row for H, which the atom lacks.

- Both readers read the file the same way (energies, cross-sections and
  the row counts).
- ``gamma_step`` in float64 on both sides, with one gamma packet in each
  shell of a 40-shell 1D model, no electrons and no density (so the
  photoelectric opacity is the only one) and a path cut by the end of the
  timestep 3 cm on: the deposition of each shell is the packet's
  photoelectric opacity times its path, and it agrees to 1e-12 for
  energies inside every table.
- Above the Co table's last row the port clamps Co's cross-section to
  that row; the JAX package interpolates into the padding of the table
  (energy 1e99 MeV, sigma 1e-99 barn), which in float32 is inf and 0 and
  gives a NaN slope (ROADMAP Queue 3, a deliberate divergence).
- A whole run of kilonova_2d_2dgrid_xcomgammaphotoion in miniature (with
  synthetic Ni56 / Co56 gamma lines) by both packages from the same
  pellets: every gamma opacity finite, and the gamma deposition of each
  timestep within 4/sqrt(n) of the JAX package's.

The port runs each case at transport dtype float32 and at the presets'
float64; the JAX package's side is computed once for both."""

import dataclasses

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts, rel_close

torch.set_num_threads(1)

ELEMENTS = ((26, 3), (27, 2), (28, 2))
MEV_HZ = 2.41326e20  # the nu of 1 MeV, as both packages divide by it


def test_readers_agree(tmp_path):
    from artis_tpu.io.gammadata import read_xcom_photoion as jread
    from artis_tpu_torch.io.gammadata import read_xcom_photoion as tread
    from artis_tpu_torch.synthdata import write_synthetic_xcom_data

    write_synthetic_xcom_data(str(tmp_path), ELEMENTS)
    path = str(tmp_path / "xcom_photoion_data.txt")
    zs = [z for z, _ in ELEMENTS]
    je, js, jl = jread(path, zs)
    te, ts, tl = tread(path, zs)
    assert list(tl) == list(jl) == [41, 21, 0]
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(ts, js)
    # the cross-sections fall steeply with energy
    assert np.all(np.diff(np.log(ts[0, :41])) < 0)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """gamma_step of the JAX package on 40 gamma packets, one per shell of a
    40-shell model, for each of two energy sets: inside every table (10 keV
    - 1 MeV) and above the Co table (1-9 MeV). Returns the run directory,
    the options, the number densities, each set's packets and per-shell
    deposition."""
    import jax
    import jax.numpy as jnp

    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    from artis_tpu.packets import TYPE_GAMMA
    from artis_tpu.transport import engine as jeng
    from artis_tpu_torch.synthdata import write_synthetic_xcom_data

    d = str(tmp_path_factory.mktemp("xcom_step"))
    make_run(d, ncells=40, ntimesteps=3, tmin_days=1.5, tmax_days=3.0, ngreyts=0)
    write_synthetic_xcom_data(d, ELEMENTS)
    jopts = jo.kilonova_lte(npkts=64, grid_type=jo.GridType.SPHERICAL1D, mintemp=1000.0,
                            maxtemp=20000.0, tablesize=12, use_xcom_gammaphotoion=True)
    sj = jd.Simulation(d, jopts, datadir="/nonexistent")
    jctx = sj.update_grid(0)
    nd = np.asarray(jctx.elem_numberdens, dtype=np.float64)
    ncells = int(sj.grid.nonempty_npts)
    n = 40
    rng = np.random.default_rng(7)
    r_mid = 0.5 * (np.asarray(sj.grid.cell_pos_min)[:n, 0]
                   + np.asarray(sj.grid.cell_pos_max)[:n, 0])
    t2 = float(jctx.t2)
    prop_time = t2 - 1e-10  # the time limit ends every path 3 cm on
    pos = np.zeros((64, 3))
    pos[:n, 0] = r_mid * prop_time / float(sj.params.tmin)
    dirs = np.tile([1.0, 0.0, 0.0], (64, 1))
    out = dict(dir=d, jopts=jopts, nd=nd, ncells=ncells, n=n)
    for label, (lo, hi) in (("inside", (0.0101, 0.99)), ("above", (1.01, 9.0))):
        e_mev = np.exp(rng.uniform(np.log(lo), np.log(hi), 64))
        js = sj.state.replace(
            ptype=jnp.where(jnp.arange(64) < n, TYPE_GAMMA, sj.state.ptype),
            prop_time=jnp.full(64, prop_time), pos=jnp.asarray(pos), dir=jnp.asarray(dirs),
            where=jnp.asarray(np.minimum(np.arange(64), n - 1), jnp.int32),
            nu_cmf=jnp.asarray(e_mev * MEV_HZ), nu_rf=jnp.asarray(e_mev * MEV_HZ),
            e_cmf=jnp.ones(64), e_rf=jnp.ones(64))
        zero = jnp.zeros(ncells)
        _, jest = jeng.gamma_step(jax.random.PRNGKey(0), js, sj.est, jctx, sj.grid, zero, zero,
                                  zero, -1.0, jopts)
        out[label] = dict(state=np_fields(js), e_mev=e_mev[:n],
                          jax=np.asarray(jest.dep_gamma, dtype=np.float64)[:n])
    return out


@pytest.fixture(scope="module", params=["float32", "float64"])
def steps(jax_steps, request):
    """The port's gamma_step on the JAX package's packets, in float64, with
    its grid update at transport dtype ``request.param`` (float32, or the
    presets' float64). Returns the per-shell deposition of both packages
    and the inputs."""
    from artis_tpu_torch import interop
    from artis_tpu_torch import driver as td
    from artis_tpu_torch.estimators import zero_estimators
    from artis_tpu_torch.packets import PacketState
    from artis_tpu_torch.transport import engine as teng

    j = jax_steps
    st = td.Simulation(j["dir"], port_opts(j["jopts"], transport_dtype=request.param),
                       datadir="/nonexistent", device="cpu")
    tctx = st.update_grid(0)
    # the same number densities on both sides, in float64
    tctx = dataclasses.replace(tctx, elem_numberdens=torch.as_tensor(j["nd"]))
    ncells, n = j["ncells"], j["n"]
    out = {}
    for label in ("inside", "above"):
        ts = interop.from_numpy(PacketState, j[label]["state"], dtype=torch.float64)
        z = torch.zeros(ncells, dtype=torch.float64)
        _, test = teng.gamma_step((1, 2), ts, zero_estimators(ncells, 1), tctx, st.grid, z, z, z,
                                  -1.0, st.opts)
        out[label] = dict(jax=j[label]["jax"], port=test.dep_gamma.numpy()[:n],
                          e_mev=j[label]["e_mev"], nd=j["nd"][:n], path=3.0)
    st.close()
    out["tables"] = tctx.xcom_energy.numpy(), tctx.xcom_sigma.numpy(), tctx.xcom_nrows.numpy()
    return out


def test_opacity_inside_every_table_matches(steps):
    s = steps["inside"]
    assert np.all(s["jax"] > 0) and np.all(np.isfinite(s["port"]))
    np.testing.assert_allclose(s["port"], s["jax"], rtol=1e-12, atol=0.0)


def test_port_clamps_above_a_short_table(steps):
    """Above Co's last row (1 MeV) the port's Co cross-section is that
    row's; the JAX package's interpolates toward the padding and falls far
    below it in float64, and its slope is NaN in float32."""
    from artis_tpu_torch.transport.engine import xcom_photoion_chi

    energy, sigma, nrows = (torch.as_tensor(x) for x in steps["tables"])
    s = steps["above"]
    nu = torch.as_tensor(s["e_mev"] * MEV_HZ)
    nd = torch.as_tensor(s["nd"])
    full = xcom_photoion_chi(energy, sigma, nrows, nd, nu).numpy()
    no_co = xcom_photoion_chi(energy, sigma, nrows, nd * torch.tensor([1.0, 0.0, 1.0]), nu).numpy()
    co_last = float(sigma[1, 20]) * 1e-24
    np.testing.assert_allclose(full - no_co, co_last * s["nd"][:, 1], rtol=1e-12)
    # the per-shell depositions share one factor (path, energy and the
    # Doppler terms), so their ratio is that of the opacities: the port's
    # exceeds the JAX package's by Co's clamp, at most by all of Co's
    ratio = s["port"] / s["jax"]
    assert np.all(ratio > 1.0 + 1e-6), ratio
    assert np.all(ratio <= full / no_co * (1.0 + 1e-12)), ratio
    # the JAX interpolation against the float32 padding: a NaN slope
    e32 = np.asarray(energy[1], np.float32)
    s32 = np.asarray(sigma[1], np.float32)
    with np.errstate(all="ignore"):
        x0, x1 = np.log10(e32[20]), np.log10(e32[21])
        y0, y1 = np.log10(s32[20]), np.log10(s32[21])
        slope = (y1 - y0) / np.maximum(x1 - x0, np.float32(1e-30))
    assert np.isnan(slope)


@pytest.fixture(scope="module")
def jax_whole_run(tmp_path_factory):
    """kilonova_2d_2dgrid_xcomgammaphotoion in miniature (3 x 6 cylinder,
    1000 packets, days 1.5-3, synthetic gamma lines), timesteps 0-1 of the
    JAX package: its pellets and gamma deposition per timestep."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo

    jopts = jo.kilonova_lte(npkts=1000, grid_type=jo.GridType.CYLINDRICAL2D, mintemp=1000.0,
                            maxtemp=20000.0, tablesize=12, use_xcom_gammaphotoion=True)
    sj = jd.Simulation(_xcom_run_dir(tmp_path_factory.mktemp("xcom_jax")), jopts,
                       datadir="/nonexistent")
    pellets = np_fields(sj.state)
    for nts in range(2):
        sj.do_timestep(nts)
    return jopts, pellets, [float(sj.gamma_dep_ts[nts]) for nts in range(2)]


def _xcom_run_dir(d):
    from artis_tpu_torch.synthdata import write_synthetic_gamma_lines, write_synthetic_xcom_data

    make_run(str(d), ncells=3, model_dim=2, ntimesteps=3, tmin_days=1.5, tmax_days=3.0,
             ngreyts=0)
    write_synthetic_xcom_data(str(d), ELEMENTS)
    write_synthetic_gamma_lines(str(d))
    return str(d)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_whole_run_matches_jax(jax_whole_run, dtype, tmp_path):
    """The JAX package's run (``jax_whole_run``) and the port's at transport
    ``dtype`` (float32, and the presets' float64) from the same pellets: the
    port's gamma deposition is finite and positive in each timestep and
    within 4/sqrt(n) of the JAX package's, n a quarter of the packets (the
    gamma packets' share of the pellets is about half)."""
    from artis_tpu_torch import interop
    from artis_tpu_torch import driver as td
    from artis_tpu_torch.packets import PacketState

    jopts, pellets, jax_dep = jax_whole_run
    st = td.Simulation(_xcom_run_dir(tmp_path), port_opts(jopts, transport_dtype=dtype),
                       datadir="/nonexistent", device="cpu")
    st.state = interop.from_numpy(PacketState, pellets, dtype=getattr(torch, dtype))
    for nts in range(2):
        st.do_timestep(nts)
        b = float(st.gamma_dep_ts[nts])
        assert np.isfinite(b) and b > 0, (nts, b)
        rel_close(jax_dep[nts], b, jopts.npkts // 4, f"gamma deposition ts{nts}")
    st.close()

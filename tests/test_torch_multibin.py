"""The multibin radiation field of the port (K5-multibin) against the JAX
package on the CPU.

- The bin layout (``bin_nu_lower`` / ``bin_nu_upper`` exact, ``select_bin``
  equal on 4000 frequencies), ``planck_integral``, ``fit_bin_params`` (the
  40-step bisection, the superbin pinned to T_e, W = 0 without
  contributions, the W > 1e4 refit) and ``radfield_dbb_binned``, float64,
  rtol 1e-9; the kernel's float32 bin index (``rpkt_kernel.radbin_index``)
  equal to the Pallas expression evaluated in numpy float32;
- the plain crossing's per-(cell, bin) J / nuJ / count against the XLA path
  and the Pallas kernel in interpret mode (tests/test_pallas_rpkt.py::
  test_kernel_multibin_radfield_matches_xla's scene and tolerances: J,
  nuJ and count sums within rel 5e-2, the populated-bin masks overlapping
  on > 0.8 of their union), on the 8-shell 1D scene at max_inner 1, and on
  a 1D model mapped onto an 8^3 grid against the XLA path.
"""

import numpy as np
import pytest
import torch

from test_torch_grid3d import NPKTS, forced_state, jax_scene, run_pallas, run_port, run_xla

torch.set_num_threads(1)

RTOL = 1e-9
NBINS = 64


def _t(x):
    return torch.as_tensor(np.array(x, np.float64))


def test_bin_layout_matches():
    import jax.numpy as jnp

    import artis_tpu.plasma.radfield as jr
    import artis_tpu_torch.plasma.radfield as tr

    for nb in (16, NBINS, 256):
        np.testing.assert_array_equal(tr.bin_nu_lower(nb).numpy(), np.asarray(jr.bin_nu_lower(nb)))
        np.testing.assert_array_equal(tr.bin_nu_upper(nb).numpy(), np.asarray(jr.bin_nu_upper(nb)))
    nu = 10 ** np.random.default_rng(0).uniform(14.0, 17.0, 4000)
    np.testing.assert_array_equal(tr.select_bin(_t(nu), NBINS).numpy(),
                                  np.asarray(jr.select_bin(jnp.asarray(nu), NBINS)))


def test_kernel_bin_index_is_the_pallas_expression():
    """pallas_rpkt.py:1497-1503 in numpy float32 against the plain
    version's float32 bin, on frequencies across the range and next to
    every bin edge."""
    from artis_tpu.plasma.radfield import NU_LOWER_FIRST, NU_UPPER_LAST, NU_UPPER_SUPERBIN
    from artis_tpu_torch.plasma.radfield import bin_nu_lower
    from artis_tpu_torch.transport.rpkt_kernel import radbin_index

    f32 = np.float32
    edges = bin_nu_lower(NBINS).numpy()
    nu = np.concatenate([10 ** np.random.default_rng(1).uniform(14.0, 16.7, 4000),
                         edges * (1 - 1e-7), edges, edges * (1 + 1e-7)]).astype(f32)
    delta = f32((NU_UPPER_LAST - NU_LOWER_FIRST) / (NBINS - 1))
    b = np.floor((nu - f32(NU_LOWER_FIRST)) / delta)
    b = np.where(nu >= f32(NU_UPPER_LAST), f32(NBINS - 1), b)
    b = np.clip(b, 0.0, NBINS - 1).astype(np.int64)
    inside = (nu >= f32(NU_LOWER_FIRST)) & (nu < f32(NU_UPPER_SUPERBIN))
    bt, it = radbin_index(torch.as_tensor(nu), NBINS)
    np.testing.assert_array_equal(it.numpy(), inside)
    np.testing.assert_array_equal(bt.numpy()[inside], b[inside])


def test_planck_integral_and_fit_match():
    import jax.numpy as jnp

    import artis_tpu.plasma.radfield as jr
    import artis_tpu_torch.plasma.radfield as tr

    rng = np.random.default_rng(2)
    lo, up = jr.bin_nu_lower(NBINS), jr.bin_nu_upper(NBINS)
    t = rng.uniform(2000.0, 25000.0, (3, NBINS))
    for times_nu in (False, True):
        a = np.asarray(jr.planck_integral(jnp.asarray(t), lo[None, :], up[None, :], times_nu))
        b = tr.planck_integral(_t(t), _t(lo)[None, :], _t(up)[None, :], times_nu).numpy()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    # a dilute field at a few temperatures, bins scaled at random, some
    # without contributions and some far above any Planck shape (W > 1e4)
    t0 = np.array([4000.0, 7500.0, 12000.0])
    w0 = np.array([1e-3, 0.4, 1.0])
    jb = w0[:, None] * np.asarray(jr.planck_integral(jnp.asarray(t0)[:, None], lo[None, :],
                                                     up[None, :], False))
    njb = w0[:, None] * np.asarray(jr.planck_integral(jnp.asarray(t0)[:, None], lo[None, :],
                                                      up[None, :], True))
    scale = rng.uniform(0.5, 2.0, jb.shape)
    scale[1, :4] = 1e9
    jb, njb = jb * scale, njb * rng.uniform(0.7, 1.4, jb.shape) * scale
    cnt = rng.integers(0, 4, jb.shape).astype(np.float64)
    te = np.array([9000.0, 5000.0, 15000.0])
    a = jr.fit_bin_params(jnp.asarray(jb), jnp.asarray(njb), jnp.asarray(cnt), jnp.asarray(te),
                          NBINS, 1000.0, 30000.0)
    b = tr.fit_bin_params(_t(jb), _t(njb), _t(cnt), _t(te), NBINS, 1000.0, 30000.0)
    for name, x, y in zip(("T_R", "W"), a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=RTOL, atol=0, err_msg=name)
    t_r, w = (y.numpy() for y in b)
    np.testing.assert_array_equal(t_r[:, -1][w[:, -1] <= 1e4], te[w[:, -1] <= 1e4])
    assert np.all(w[cnt == 0] == 0) and np.any(t_r == 30000.0)


def test_binned_lookup_matches():
    import jax.numpy as jnp

    import artis_tpu.plasma.radfield as jr
    import artis_tpu_torch.plasma.radfield as tr

    rng = np.random.default_rng(3)
    trb = rng.uniform(3000.0, 15000.0, (4, 16))
    wb = np.where(rng.uniform(size=(4, 16)) < 0.3, 0.0, rng.uniform(0.0, 1.0, (4, 16)))
    nu = 10 ** rng.uniform(14.0, 16.5, 500)
    cell = rng.integers(0, 4, 500)
    trf, wf = rng.uniform(3000.0, 9000.0, 4), rng.uniform(0.01, 1.0, 4)
    a = jr.radfield_dbb_binned(jnp.asarray(nu), jnp.asarray(cell), jnp.asarray(trb),
                               jnp.asarray(wb), jnp.asarray(trf), jnp.asarray(wf), 16)
    b = tr.radfield_dbb_binned(_t(nu), torch.as_tensor(cell), _t(trb), _t(wb), _t(trf), _t(wf), 16)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)


def _assert_bins_close(est_j, est_t):
    """tests/test_pallas_rpkt.py::test_kernel_multibin_radfield_matches_xla."""
    jx = np.asarray(est_j.radfieldbin_j)
    jp = est_t.radfieldbin_j.double().numpy()
    assert jx.shape == jp.shape == (jx.shape[0], NBINS)
    assert jx.sum() > 0
    assert jp.sum() == pytest.approx(jx.sum(), rel=5e-2)
    cx = np.asarray(est_j.radfieldbin_count)
    cp = est_t.radfieldbin_count.double().numpy()
    assert cp.sum() == pytest.approx(cx.sum(), rel=5e-2)
    inter = ((cx > 0) & (cp > 0)).sum()
    union = ((cx > 0) | (cp > 0)).sum()
    assert inter / max(union, 1) > 0.8, inter / max(union, 1)
    nujx = np.asarray(est_j.radfieldbin_nuj).sum()
    assert est_t.radfieldbin_nuj.double().sum().item() == pytest.approx(nujx, rel=5e-2)
    # several bins and cells are populated
    assert (cp.sum(axis=0) > 0).sum() > 4 and (cp.sum(axis=1) > 0).sum() > 1


def _compare(sc, seed, pallas):
    st0 = forced_state(sc, seed=seed)
    rng = np.random.default_rng(seed)
    tau_u = rng.uniform(0.05, 0.95, NPKTS)
    tau = -np.log(np.maximum(tau_u.astype(np.float32), 1e-30))
    sel = np.full(NPKTS, 0.5, np.float32)
    est_t = run_port(sc, st0, tau, sel, 1)[1]
    _assert_bins_close(run_xla(sc, st0, tau_u, 1)[1], est_t)
    if pallas:
        _assert_bins_close(run_pallas(sc, st0, tau, sel, 1)[1], est_t)


def test_crossing_bins_match_jax(tmp_path_factory):
    import artis_tpu.options as jo

    sc = jax_scene(tmp_path_factory, "tmb_1d", dict(ncells=8),
                   dict(grid_type=jo.GridType.SPHERICAL1D, multibin_radfield=True,
                        radfieldbincount=NBINS))
    _compare(sc, seed=23, pallas=True)


def test_crossing_bins_1dmodel_3dgrid_match_xla(tmp_path_factory):
    import artis_tpu.options as jo

    sc = jax_scene(tmp_path_factory, "tmb_3d", dict(ncells=5),
                   dict(grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=8, ncoordgrid_y=8,
                        ncoordgrid_z=8, multibin_radfield=True, radfieldbincount=NBINS))
    _compare(sc, seed=24, pallas=False)

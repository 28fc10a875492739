"""Polarised / dipole electron scattering of the port against the JAX package.

- the Stokes frame machinery (``meridian``, ``get_rot_angle``, ``lorentz``,
  ``frame_transform``) on random directions and velocities, directions on
  the polar axis and 1e-9 off it and the special Stokes angles (Q or U
  zero) included: rtol 1e-10 in float64 (the same formulas on the same
  inputs; the 0/0 on the axis is NaN on both sides);
- ``electron_scatter_batch`` with ``dipole`` on and off, on the JAX
  package's own draws rebuilt with ``jax.random`` (``fold_in(key, tag)``,
  then ``fold_in(k, i)``) and fed to the port's ``electron_scatter_lanes``:
  directions, nu_rf, e_rf and Stokes Q / U to rtol 1e-9 in float64, and the
  same lanes with float32 inputs to 1e-3 (the Stokes tolerance of
  tests/test_pallas_rpkt.py::test_kernel_dipole_mode_defers_events);
- the five properties of tests/test_escatter.py, on the port's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artis_tpu import geometry as jgeo
from artis_tpu.constants import CLIGHT
from artis_tpu.options import kilonova_lte as jkilonova_lte
from artis_tpu.transport import engine as jeng

torch.set_num_threads(1)

RTOL64 = 1e-10
RTOL_SCATTER = 1e-9
TOL32 = 1e-3


def _dirs(rng, n, polar=0):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if polar:
        # exactly on the polar axis, and 1e-9 off it
        d[:polar // 2] = [0.0, 0.0, 1.0]
        d[polar // 2:polar] = np.array([1e-9, 0.0, -1.0]) / np.sqrt(1.0 + 1e-18)
    return d


def _close(b, a, rtol, name):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=name)
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=rtol, atol=rtol * np.max(np.abs(a[ok])),
                               err_msg=name)


def test_stokes_frame_functions_match_jax():
    from artis_tpu_torch import geometry as tgeo

    rng = np.random.default_rng(1)
    n = 4096
    n1 = _dirs(rng, n, polar=16)
    n2 = _dirs(rng, n)
    v = rng.normal(size=(n, 3)) * 0.1 * CLIGHT
    q = rng.uniform(-0.7, 0.7, n)
    u = rng.uniform(-0.7, 0.7, n)
    q[:8], u[:8] = 0.0, 0.0  # unpolarised: the p > 0 guard
    q[16:20] = 0.0  # cos2 == 0 and sin2 == 0 branches
    u[20:24] = 0.0
    t = lambda x: torch.as_tensor(x)
    r1j, r2j = jgeo.meridian(jnp.asarray(n1))
    r1t, r2t = tgeo.meridian(t(n1))
    _close(r1t, r1j, RTOL64, "meridian ref1")
    _close(r2t, r2j, RTOL64, "meridian ref2")
    _close(tgeo.get_rot_angle(t(n1), t(n2), r1t, r2t),
           jgeo.get_rot_angle(jnp.asarray(n1), jnp.asarray(n2), r1j, r2j), RTOL64, "rot_angle")
    e = _dirs(rng, n)
    _close(tgeo.lorentz(t(e), t(n1), t(v)), jgeo.lorentz(jnp.asarray(e), jnp.asarray(n1),
                                                          jnp.asarray(v)), RTOL64, "lorentz")
    outj = jgeo.frame_transform(jnp.asarray(n1), jnp.asarray(q), jnp.asarray(u), jnp.asarray(v))
    outt = tgeo.frame_transform(t(n1), t(q), t(u), t(v))
    for name, a, b in zip(("n_cmf", "Q", "U"), outj, outt):
        _close(b, a, RTOL64, f"frame_transform {name}")
    # the polar-axis lanes are the NaN cases the scatter turns unpolarised
    assert np.isnan(np.asarray(outj[1])[:8]).all()


def _jax_state(n, seed, polarised=True, polar=0):
    from artis_tpu import packets as jpk

    rng = np.random.default_rng(seed)
    t = 2.0 * 86400.0
    pos = _dirs(rng, n) * (0.05 * CLIGHT * t)
    d = _dirs(rng, n, polar=polar)
    stokes = np.zeros((n, 3))
    stokes[:, 0] = 1.0
    if polarised:
        stokes[:, 1] = rng.uniform(-0.6, 0.6, n)
        stokes[:, 2] = rng.uniform(-0.6, 0.6, n)
    nu = 10 ** rng.uniform(14.5, 15.5, n)
    st = jpk.empty_state(n)
    return st.replace(ptype=jnp.full(n, jpk.TYPE_RPKT, jnp.int32), prop_time=jnp.full(n, t),
                      pos=jnp.asarray(pos), dir=jnp.asarray(d), nu_cmf=jnp.asarray(nu),
                      nu_rf=jnp.asarray(nu * 1.01), e_cmf=jnp.full(n, 1.0),
                      e_rf=jnp.full(n, 1.01), stokes=jnp.asarray(stokes))


def _jax_draws(key, tag, n):
    """The uniforms jeng.electron_scatter_batch draws (engine.py:163-174)."""
    k = jax.random.fold_in(key, tag)
    u0 = np.asarray(jax.random.uniform(jax.random.fold_in(k, 0), (2, n), jnp.float64))
    trials = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, i + 1), (3, n),
                                                     jnp.float64)) for i in range(48)])
    return u0, trials


@pytest.mark.parametrize("dipole", [True, False])
def test_electron_scatter_matches_jax(dipole):
    from artis_tpu_torch.transport.engine import electron_scatter_lanes

    n = 2048
    st = _jax_state(n, seed=3, polar=8)
    mask = np.arange(n) % 3 != 0
    key = jax.random.PRNGKey(5)
    out = jeng.electron_scatter_batch(key, 59, st, jnp.asarray(mask),
                                      jkilonova_lte(dipole=dipole))
    u0, trials = _jax_draws(key, 59, n)
    sel = np.nonzero(mask)[0]
    lanes = [np.asarray(x)[sel] for x in (st.pos, st.dir, st.prop_time, st.stokes)]
    ref = dict(dir=np.asarray(out.dir)[sel], nu_rf=np.asarray(out.nu_rf)[sel],
               e_rf=np.asarray(out.e_rf)[sel], q=np.asarray(out.stokes)[sel, 1],
               u=np.asarray(out.stokes)[sel, 2])
    assert np.isfinite(ref["q"]).all()
    for dtype, tol in ((torch.float64, RTOL_SCATTER), (torch.float32, TOL32)):
        t = lambda x: torch.as_tensor(x).to(dtype)
        new_dir, dop, q, u = electron_scatter_lanes(
            *[t(x) for x in lanes], t(u0[:, sel]), t(trials[:, :, sel]), dipole, True)
        nu_cmf = np.asarray(st.nu_cmf)[sel]
        got = dict(dir=new_dir, nu_rf=nu_cmf / dop.double().numpy(),
                   e_rf=1.0 / dop.double().numpy(), q=q, u=u)
        for name in ref:
            b = np.asarray(got[name], np.float64)
            assert np.isfinite(b).all(), (name, dtype)
            if dtype == torch.float64:
                np.testing.assert_allclose(b, ref[name], rtol=tol, atol=tol,
                                           err_msg=name)
            else:
                # float32, as the JAX kernel test holds its Stokes vectors:
                # within 1e-3 (relative for nu_rf / e_rf) on nearly every
                # lane; a dipole trial whose acceptance test 2 z <= p rounds
                # the other way takes another angle
                scale = np.abs(ref[name]) if name in ("nu_rf", "e_rf") else 1.0
                err = np.abs(b - ref[name]) / scale
                within = np.all(err.reshape(len(sel), -1) < tol, axis=1)
                assert np.mean(within) > 0.99, (name, np.mean(within))
    # the unscattered lanes are left alone by both
    keep = ~mask
    np.testing.assert_array_equal(np.asarray(out.dir)[keep], np.asarray(st.dir)[keep])


# --- tests/test_escatter.py's properties, on the port -----------------------


def _state(n, seed=0, polarised=False):
    from artis_tpu_torch import packets as tpk

    rng = np.random.default_rng(seed)
    t = 2.0 * 86400.0
    pos = _dirs(rng, n) * (0.05 * CLIGHT * t)
    d = _dirs(rng, n)
    stokes = np.zeros((n, 3))
    stokes[:, 0] = 1.0
    if polarised:
        stokes[:, 1], stokes[:, 2] = 0.6, 0.2
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    return tpk.empty_state(n).replace(
        ptype=torch.full((n,), tpk.TYPE_RPKT, dtype=torch.int64), prop_time=f(np.full(n, t)),
        pos=f(pos), dir=f(d), nu_cmf=f(np.full(n, 1e15)), nu_rf=f(np.full(n, 1e15)),
        e_cmf=f(np.ones(n)), e_rf=f(np.ones(n)), stokes=f(stokes))


def _scatter(n, dipole, seed, polarised=False, mask=None):
    from artis_tpu_torch.options import kilonova_lte
    from artis_tpu_torch.transport.engine import electron_scatter_batch

    st = _state(n, polarised=polarised)
    mask = torch.ones(n, dtype=torch.bool) if mask is None else mask
    return st, electron_scatter_batch((seed,), 1, st, mask, kilonova_lte(dipole=dipole))


def _mu(st, out):
    from artis_tpu_torch import geometry as tgeo

    vel = st.pos / st.prop_time[:, None]
    return tgeo.dot(tgeo.angle_ab(st.dir, vel), tgeo.angle_ab(out.dir, vel)).numpy()


def test_unit_direction_and_coherence():
    from artis_tpu_torch import geometry as tgeo

    st, out = _scatter(4096, True, 7, polarised=True)
    np.testing.assert_allclose(np.linalg.norm(out.dir.numpy(), axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(out.nu_cmf.numpy(), 1e15)
    dop = tgeo.doppler_nucmf_on_nurf(out.pos, out.dir, out.prop_time, True).numpy()
    np.testing.assert_allclose(out.nu_rf.numpy() * dop, 1e15, rtol=1e-12)
    s = out.stokes.numpy()
    assert np.all(np.isfinite(s))
    np.testing.assert_allclose(s[:, 0], 1.0)
    assert np.all(s[:, 1] ** 2 + s[:, 2] ** 2 <= 1.0 + 1e-9)


@pytest.mark.parametrize("dipole,mu2", [(True, 0.4), (False, 1.0 / 3.0)])
def test_phase_function_moments(dipole, mu2):
    """Unpolarised input: the dipole cosine follows 1 + mu^2 (E[mu^2] = 2/5),
    the isotropic one is uniform (E[mu^2] = 1/3)."""
    st, out = _scatter(200_000, dipole, 3)
    mu = _mu(st, out)
    assert abs(np.mean(mu)) < 0.01
    assert abs(np.mean(mu**2) - mu2) < 0.01


def test_ninety_degree_scatter_fully_polarised():
    """Unpolarised light scattered by angle theta: P = (1-mu^2)/(1+mu^2)."""
    st, out = _scatter(50_000, True, 11)
    mu = _mu(st, out)
    s = out.stokes.numpy()
    p = np.sqrt(s[:, 1] ** 2 + s[:, 2] ** 2)
    np.testing.assert_allclose(p, (1.0 - mu**2) / (1.0 + mu**2), atol=1e-6)


def test_mask_leaves_unscattered_lanes():
    n = 64
    mask = torch.arange(n) % 2 == 0
    st, out = _scatter(n, True, 1, polarised=True, mask=mask)
    keep = ~mask
    assert torch.equal(out.dir[keep], st.dir[keep])
    assert torch.equal(out.stokes[keep], st.stokes[keep])
    assert not torch.equal(out.dir[mask], st.dir[mask])

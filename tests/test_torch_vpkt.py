"""Virtual packets (``transport/vpkt.py``) on the port against the JAX
package, on the CPU, in float64.

- The vpkt.txt parser: the cases of tests/test_vpkt.py, the chip scene's
  file (three observers, six exclusion channels, the thick-cell override,
  the velocity-grid maps), a file that ends after the thick-cell flag, and
  the default configuration: every field as the JAX reader's.
- The cumulative line tables (with an element's exclusion table) and the
  closed-form segment tau against the JAX functions to 1e-12, and against
  the per-line sum tau_l (t + D_l / c) to 1e-9 (the closed form takes the
  difference of two cumulative sums, each scaled by nu / (c dnu/dl)).
- ``trace_vpkts`` against the JAX ``trace_vpkts`` on the same rays: 48
  sites from a numpy seed (random positions, directions, Stokes vectors,
  frequencies and energies; half scatters, half thermal emission) toward
  three observers, through the classic miniature's 6^3 grid with its own
  timestep-0 opacity (one of its four model cells made vpkt-thick), the six exclusion
  channels and the velocity-grid maps: every bin of the Stokes spectra
  and maps to rtol 1e-9 (atol 1e-12 of the largest bin).
- The closed forms of tests/test_vpkt.py: an isotropic emission in a
  transparent medium gives n/(4 pi) with Q = U = 0; a ray starting in a
  thick=2 cell dies there, while the real packets' transport with thick=2
  is bitwise that with thick=0.
- The writers: ``write_vspecpol`` and ``write_vpkt_grid`` write the same
  bytes as the JAX writers for the same arrays.

- Real packets untouched: the spawn draws no random number and changes no
  packet, so a same-seed run of the classic miniature (the classic preset
  defers its events with or without vpkt_on) with ``vpkt_on`` leaves every
  real packet and every estimator but ``vspec`` / ``vgrid`` bitwise as the
  run without it, over two timesteps.
- Checkpoint: a run resumed after timestep 0 writes the same
  specpol_virtual.out and vpkt_grid.out, and holds the same totals, as
  the straight run, bit for bit.

Whole runs against the JAX package are in tests/test_torch_vpkt_runs.py."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from artis_tpu.synthdata import make_run
from test_torch_grid3d import np_fields, port_opts

torch.set_num_threads(1)

F64 = torch.float64
# the chip scene's vpkt.txt (chip_smoke.VPKT_TXT's layout): three observers,
# six channels, the default time and frequency windows, the thick-cell
# override, tau_max 10 and one velocity-grid window
VPKT_TXT = ("3\n1 0 -1\n0 90 0\n1\n6\n0 -1 -2 -3 -4 26\n0 0 0\n0\n1 1e9\n10\n"
            "1\n0.5 3.0\n1\n3500 8000\n")
# the classic miniature of the whole-run tests: 6 shells, days 1-2
CLASSIC = dict(ncells=6, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0, logrho0=-7.5)
CONFIG_TEXTS = {
    "test_vpkt_basic": "2\n0.5 -0.5\n0.0 90.0\n1\n2\n0 -1\n1 1.0 3.0\n0\n8.0\n",
    "test_vpkt_vgrid": ("1\n0.0\n0.0\n1\n2\n0 26\n1 1.0 3.0\n0\n0 100\n8.0\n1\n1.2 2.8\n"
                        "2\n3000 6000\n6000 10000\n"),
    "chip_scene": VPKT_TXT,
    "custom_nu_thick_only": "1\n0.3\n45\n0\n0 0 0\n1\n2\n3000 5000\n6000 9000\n1 2.5\n",
    "tau_max_only": "1\n0.0\n0.0\n0\n1 0.5 2.0\n0\n7.5\n",
}


def _jcfg_fields(cfg):
    return {f.name: (np.asarray(getattr(cfg, f.name)) if hasattr(getattr(cfg, f.name), "shape")
                     else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(CONFIG_TEXTS) + ["default1", "default3"])
def test_config_matches_jax(name, tmp_path):
    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch.transport import vpkt as tv

    if name.startswith("default"):
        n = int(name[-1])
        jc, tc = jv.default_vpkt_config(1e5, 1e6, n), tv.default_vpkt_config(1e5, 1e6, n)
    else:
        p = tmp_path / "vpkt.txt"
        p.write_text(CONFIG_TEXTS[name])
        jc = jv.read_vpkt_config(str(p), 1e5, 1e6, 30, 1000)
        tc = tv.read_vpkt_config(str(p), 1e5, 1e6, 30, 1000)
    jf = _jcfg_fields(jc)
    for f in dataclasses.fields(tc):
        a, b = jf[f.name], getattr(tc, f.name)
        if torch.is_tensor(b):
            assert b.dtype == F64, f.name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f.name)
        else:
            assert b == a, (f.name, a, b)


@pytest.fixture(scope="module")
def atom(tmp_path_factory):
    from artis_tpu import atomic
    from artis_tpu.io import atomicdata
    from artis_tpu.synthdata import write_synthetic_atomicdata
    from artis_tpu_torch.atomic import to_device
    from artis_tpu_torch.io.atomicdata import read_atomicdata

    d = tmp_path_factory.mktemp("vpkt_atom")
    write_synthetic_atomicdata(d, elements=((26, 2), (27, 2)), nlevels_per_ion=6)
    jdad = atomic.to_device(atomicdata.read_atomicdata(str(d)))
    tdad = to_device(read_atomicdata(str(d)), "cpu")
    rng = np.random.default_rng(1)
    tf = 10.0 ** rng.uniform(-22, -18, (3, tdad.nlines))
    return jdad, tdad, tf


def test_tables_match_jax(atom):
    import jax.numpy as jnp

    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch.transport import vpkt as tv

    jdad, tdad, tf = atom
    jt, jn = jv.build_vpkt_tables(jnp.asarray(tf), jdad, exclude=(0, 26, -1))
    tt, tn = tv.build_vpkt_tables(torch.as_tensor(tf), tdad, exclude=(0, 26, -1))
    assert tt.dtype == tn.dtype == F64 and tt.shape == (2, 3, tdad.nlines + 1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-12, atol=0.0)
    # the Fe-excluded table holds the Co lines only
    line_z = tdad.elem_z[tdad.ion_element[tdad.line_ion]].numpy()
    np.testing.assert_allclose(tt[1, :, -1].numpy(), tf[:, line_z != 26].sum(axis=1),
                               rtol=1e-12)


def test_segment_tau_matches_jax_and_the_line_sum(atom):
    import jax.numpy as jnp

    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch.transport import vpkt as tv

    jdad, tdad, tf = atom
    line_nu = tdad.line_nu.numpy()
    rng = np.random.default_rng(3)
    m = 40
    i1 = rng.integers(0, len(line_nu), m)
    i2 = rng.integers(0, len(line_nu), m)
    nu_start = line_nu[np.minimum(i1, i2)] * rng.choice([1.0, 1.0001], m)
    nu_end = line_nu[np.maximum(i1, i2)] * rng.choice([1.0, 0.9999], m)
    t0 = rng.uniform(1e5, 3e5, m)
    # |dnu/dl| of homologous flow: nu v / (c r) ~ 1e15 * 0.01 / 1e13 per cm
    dndl = -(10.0 ** rng.uniform(-3, 0, m))
    cell = rng.integers(0, 3, m)
    jt, jn = jv.build_vpkt_tables(jnp.asarray(tf), jdad)
    tt, tn = tv.build_vpkt_tables(torch.as_tensor(tf), tdad)
    want = np.asarray(jv._segment_bb_tau(jdad, jt[0], jn[0], jnp.asarray(cell),
                                         jnp.asarray(nu_start), jnp.asarray(nu_end),
                                         jnp.asarray(t0), jnp.asarray(dndl)))
    got = tv._segment_bb_tau(-tdad.line_nu.to(F64), tt[0], tn[0], torch.as_tensor(cell),
                             torch.as_tensor(nu_start), torch.as_tensor(nu_end),
                             torch.as_tensor(t0), torch.as_tensor(dndl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    c = 2.99792458e10
    for i in range(m):
        # a line exactly at either end counts (searchsorted left / right)
        sel = (line_nu <= nu_start[i]) & (line_nu >= nu_end[i])
        d_l = (line_nu[sel] - nu_start[i]) / dndl[i]
        line_sum = max(np.sum(tf[cell[i], sel] * (t0[i] + d_l / c)), 0.0)
        assert got[i] == pytest.approx(line_sum, rel=1e-9, abs=1e-300)
    assert np.count_nonzero(got) > m // 2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The classic miniature (6 shells on a 6^3 grid, days 1-2) with the
    chip scene's vpkt.txt, its timestep-0 grid update by the JAX package
    in float64, and the port's Simulation on the same directory."""
    import artis_tpu.driver as jd
    import artis_tpu.options as jo
    import artis_tpu_torch.driver as td

    d = tmp_path_factory.mktemp("vpkt_scene")
    make_run(str(d), ncells=6, ntimesteps=3, tmin_days=1.0, tmax_days=2.0, ngreyts=0,
             logrho0=-7.0)
    (d / "vpkt.txt").write_text(VPKT_TXT)
    jopts = jo.classic(npkts=64, grid_type=jo.GridType.CARTESIAN3D, ncoordgrid_x=6,
                       ncoordgrid_y=6, ncoordgrid_z=6, mintemp=1000.0, maxtemp=20000.0,
                       tablesize=12, vpkt_on=True)
    sj = jd.Simulation(str(d), jopts, datadir="/nonexistent")
    jctx = sj.update_grid(0)
    st = td.Simulation(str(d), port_opts(jopts, transport_dtype="float64"),
                       datadir="/nonexistent", device="cpu")
    st.close()
    return dict(sj=sj, jctx=jctx, st=st, jopts=jopts)


def _rays(st, t, k=48, seed=11):
    from artis_tpu_torch.grid import get_cellindex_from_pos

    rng = np.random.default_rng(seed)
    vmax = float(st.grid.vmax)
    u = rng.normal(size=(k, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * (0.75 * vmax * t * rng.uniform(0, 1, k) ** (1 / 3))[:, None]
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    p = rng.uniform(0, 0.9, k)
    ang = rng.uniform(0, 2 * np.pi, k)
    where = get_cellindex_from_pos(st.grid, torch.as_tensor(pos), torch.full((k,), t,
                                                                            dtype=F64))
    return dict(pos=pos, dir=dirs, t=np.full(k, t), where=where.numpy().astype(np.int64),
                nu=10.0 ** rng.uniform(14.3, 15.4, k), e=rng.uniform(0.5, 1.5, k),
                qu=np.stack([p * np.cos(ang), p * np.sin(ang)], axis=1),
                scatter=np.arange(k) % 2 == 0, active=np.arange(k) % 7 != 3)


def _port_inputs(scene, jcells, jctx):
    from artis_tpu_torch import interop
    from artis_tpu_torch.plasma.cellstate import CellState

    cells = interop.from_numpy(CellState, np_fields(jcells), dtype=F64)
    ctx = types.SimpleNamespace(**{k: torch.as_tensor(np.asarray(getattr(jctx, k)))
                                   for k in ("bf_a", "bf_dep", "chi_ff_nnionpart")})
    return cells, ctx


def _trace_both(scene, rays, jcells, jctx, cum=None):
    """Both packages' trace_vpkts on the same rays; returns ((vspec, vgrid)
    of the JAX package, of the port)."""
    import jax.numpy as jnp

    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch.transport import vpkt as tv

    sj, st = scene["sj"], scene["st"]
    jcfg, tcfg = sj.vpkt_cfg, st.vpkt_cfg
    jcum = (jctx.vpkt_cum_tau, jctx.vpkt_cum_taunu) if cum is None else cum[0]
    shp = (jcfg.nobs, int(jcfg.vgrid_numin.shape[0]), jcfg.vgrid_ny, jcfg.vgrid_nz, 3)
    jvs, jvg = jv.trace_vpkts(
        jcfg, jv.zero_vspectra(jcfg, jnp.float64), sj.dad, sj.grid, jcells, jctx, *jcum,
        jnp.asarray(rays["pos"]), jnp.asarray(rays["dir"]), jnp.asarray(rays["t"]),
        jnp.asarray(rays["where"], jnp.int32), jnp.asarray(rays["nu"]), jnp.asarray(rays["e"]),
        jnp.asarray(rays["qu"]), jnp.asarray(rays["scatter"]), jnp.asarray(rays["active"]),
        opacity_case=4, vgrid_acc=jnp.zeros(shp))
    cells, ctx = _port_inputs(scene, jcells, jctx)
    # the JAX package's own tables, so that what is compared is the trace
    # (test_tables_match_jax holds the tables; two cumsum orders differ in
    # the last bits, which the closed form's cancellation amplifies)
    tcum = (tuple(torch.as_tensor(np.asarray(x)) for x in jcum) if cum is None else cum[1])
    tvs, tvg = tv.trace_vpkts(
        tcfg, tv.zero_vspectra(tcfg, F64), st.dad, st.grid, cells, ctx, *tcum,
        torch.as_tensor(rays["pos"]), torch.as_tensor(rays["dir"]), torch.as_tensor(rays["t"]),
        torch.as_tensor(rays["where"]), torch.as_tensor(rays["nu"]), torch.as_tensor(rays["e"]),
        torch.as_tensor(rays["qu"]), torch.as_tensor(rays["scatter"]),
        torch.as_tensor(rays["active"]), 4, vgrid_acc=torch.zeros(shp, dtype=F64))
    return (np.asarray(jvs), np.asarray(jvg)), (tvs.numpy(), tvg.numpy())


def test_trace_matches_jax(scene):
    """Every Stokes bin of every observer and channel, and every map bin,
    to rtol 1e-9; some rays die in the vpkt-thick cells, some by tau_max,
    and every channel and both Q and U get flux."""
    import jax.numpy as jnp

    sj, jctx = scene["sj"], scene["jctx"]
    thick = np.zeros(int(sj.grid.nonempty_npts), np.int32)
    thick[2] = 2
    jcells = sj.cells.replace(thick=jnp.asarray(thick))
    rays = _rays(scene["st"], float(sj.ts.mid[0]))
    (jvs, jvg), (tvs, tvg) = _trace_both(scene, rays, jcells, jctx)
    assert jvs.shape == tvs.shape == (3, 6, 30, 1000, 3)
    for a, b, name in ((jvs, tvs, "vspec"), (jvg, tvg, "vgrid")):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12 * np.abs(a).max(), err_msg=name)
    tot = tvs[..., 0].sum(axis=(2, 3))  # (nobs, nspec)
    assert np.all(tot > 0), tot
    assert np.abs(tvs[..., 1]).sum() > 0 and np.abs(tvs[..., 2]).sum() > 0
    assert tvg[..., 0].sum() > 0
    # removing opacity can only raise exp(-tau): every channel >= channel 0
    # (up to the rounding of the closed-form segment tau, a difference of
    # two cumulative sums each scaled by nu / (c dnu/dl))
    # (the worst bin here is 1.9e-8 below)
    assert np.all(tvs[:, 1:, :, :, 0] >= tvs[:, :1, :, :, 0] * (1 - 1e-7))


def test_isotropic_thin_total_and_thick2(scene):
    """tests/test_vpkt.py's closed forms on the port: four isotropic
    emissions at 1e13 cm in a medium with no opacity give 4/(4 pi) (up to
    the Doppler factor) and Q = U = 0 in total; from a cell made thick=2
    they give nothing."""
    from artis_tpu_torch.grid import get_cellindex_from_pos
    from artis_tpu_torch.transport import vpkt as tv

    sj, st, jctx = scene["sj"], scene["st"], scene["jctx"]
    cfg = dataclasses.replace(st.vpkt_cfg, nobs=1, nspectra=1, exclude=(0,),
                              obsdirs=st.vpkt_cfg.obsdirs[1:2], vgrid_on=False)
    cells, ctx = _port_inputs(scene, sj.cells, jctx)
    cells = dataclasses.replace(cells, nne=torch.zeros_like(cells.nne),
                                thick=torch.zeros_like(cells.thick))
    ctx = types.SimpleNamespace(bf_a=torch.zeros_like(ctx.bf_a), bf_dep=ctx.bf_dep,
                                chi_ff_nnionpart=torch.zeros_like(ctx.chi_ff_nnionpart))
    n = 4
    t = float(sj.ts.mid[1])
    pos = torch.tensor([[1e13, 0.0, 0.0]], dtype=F64).repeat(n, 1)
    where = get_cellindex_from_pos(st.grid, pos, torch.full((n,), t, dtype=F64))
    zcum = torch.zeros((1, cells.Te.shape[0], st.dad.nlines + 1), dtype=F64)
    args = (pos, torch.tensor([[0.0, 0.0, 1.0]], dtype=F64).repeat(n, 1),
            torch.full((n,), t, dtype=F64), where, torch.full((n,), 5e14, dtype=F64),
            torch.ones(n, dtype=F64), torch.zeros((n, 2), dtype=F64),
            torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool), 4)
    v, _ = tv.trace_vpkts(cfg, tv.zero_vspectra(cfg, F64), st.dad, st.grid, cells, ctx, zcum,
                          zcum, *args)
    assert float(v[..., 0].sum()) == pytest.approx(n / (4 * np.pi), rel=1e-2)
    assert abs(float(v[..., 1].sum())) < 1e-12 and abs(float(v[..., 2].sum())) < 1e-12
    mgi = st.grid.nonemptymgi_of_cell[where[0]]
    thick = torch.zeros_like(cells.thick)
    thick[mgi] = 2
    v2, _ = tv.trace_vpkts(cfg, tv.zero_vspectra(cfg, F64), st.dad, st.grid,
                           dataclasses.replace(cells, thick=thick), ctx, zcum, zcum, *args)
    assert float(v2[..., 0].sum()) == 0.0


def test_thick2_leaves_real_packets_alone(tmp_path):
    """Real packets transport through thick=2 cells as through thick=0
    ones, bitwise (the flag must not engage the grey path)."""
    import artis_tpu_torch.options as to
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.transport import engine

    make_run(str(tmp_path), ncells=4, ntimesteps=3, tmax_days=2.0, ngreyts=0)
    (tmp_path / "vpkt.txt").write_text("1\n0.0\n0.0\n0\n1 0.01 3.0\n0\n1 1e-6\n8.0\n0\n")
    opts = to.kilonova_lte(npkts=128, grid_type=to.GridType.SPHERICAL1D, mintemp=1000.0,
                           maxtemp=20000.0, tablesize=12, vpkt_on=True, vpkt_vmnubins=100,
                           vpkt_vmtbins=8, transport_dtype="float32")
    sim = Simulation(str(tmp_path), opts, device="cpu")
    assert sim.vpkt_cfg.thick_vpkt == pytest.approx(1e-6)
    ctx = sim.update_grid(0)
    assert (sim.cells.thick == 2).any() and not (sim.cells.thick == 1).any()
    p = sim.params

    def run(cells):
        return engine.transport_timestep(
            (7, 0), sim.state, sim._zero_est(), sim.grid, sim.dad, sim.aux, sim.rc, sim.rates,
            cells, ctx, opts, gamma_kappagrey=float(p.gamma_kappagrey),
            opacity_case=int(p.opacity_case),
            kpktdiffusion_timescale=float(p.kpktdiffusion_timescale), apply_kpkt_diffusion=True,
            max_iters=24)[:2]

    st2, est2 = run(sim.cells)
    st0, est0 = run(dataclasses.replace(sim.cells, thick=torch.zeros_like(sim.cells.thick)))
    sim.close()
    for f in ("pos", "nu_rf", "e_rf", "ptype", "where"):
        assert torch.equal(getattr(st2, f), getattr(st0, f)), f
    assert torch.equal(est2.j, est0.j)
    # the virtual packets did die there
    assert float(est2.vspec.sum()) < float(est0.vspec.sum())


def test_writers_write_the_same_bytes(tmp_path):
    from artis_tpu.transport import vpkt as jv
    from artis_tpu_torch.transport import vpkt as tv

    p = tmp_path / "vpkt.txt"
    p.write_text(VPKT_TXT)
    jc = jv.read_vpkt_config(str(p), 86400.0, 3 * 86400.0, 4, 6)
    tc = tv.read_vpkt_config(str(p), 86400.0, 3 * 86400.0, 4, 6)
    rng = np.random.default_rng(5)
    vs = rng.normal(size=(3, 6, 4, 6, 3)) * 1e40
    vg = rng.normal(size=(3, 1, 5, 4, 3)) * 1e38
    for writer, args in (("write_vspecpol", (vs,)), ("write_vpkt_grid", (vg, 3.3e9))):
        a, b = tmp_path / f"jax_{writer}", tmp_path / f"port_{writer}"
        getattr(jv, writer)(str(a), jc, *args)
        getattr(tv, writer)(str(b), tc, *args)
        assert a.read_bytes() == b.read_bytes(), writer


def _classic_opts(npkts, **kw):
    import artis_tpu_torch.options as to

    return to.classic(npkts=npkts, grid_type=to.GridType.CARTESIAN3D, ncoordgrid_x=6,
                      ncoordgrid_y=6, ncoordgrid_z=6, mintemp=1000.0, maxtemp=20000.0,
                      tablesize=12, transport_dtype="float32", **kw)


def _same_bits(a, b):
    """Equal bit for bit (NaN fields included: an unset emission position)."""
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.int32 if a.element_size() == 4 else torch.int64), \
            b.contiguous().view(torch.int32 if b.element_size() == 4 else torch.int64)
    return torch.equal(a, b)


def test_real_packets_untouched(tmp_path):
    from artis_tpu_torch.driver import Simulation

    sims = {}
    for vpkt_on in (False, True):
        d = tmp_path / f"vpkt_{vpkt_on}"
        d.mkdir()
        make_run(str(d), **CLASSIC)
        (d / "vpkt.txt").write_text(VPKT_TXT)
        sim = Simulation(str(d), _classic_opts(300, vpkt_on=vpkt_on), device="cpu")
        for nts in range(2):
            sim.do_timestep(nts)
        sim.close()
        sims[vpkt_on] = sim
    a, b = sims[False], sims[True]
    assert b._vspec_total[..., 0].sum() > 0
    for f in a.state.__dataclass_fields__:
        assert _same_bits(getattr(a.state, f), getattr(b.state, f)), f
    for f in a.est.__dataclass_fields__:
        if f not in ("vspec", "vgrid"):
            assert _same_bits(getattr(a.est, f), getattr(b.est, f)), f
    for f in a.cells.__dataclass_fields__:
        assert _same_bits(getattr(a.cells, f), getattr(b.cells, f)), f


def test_checkpoint_resume_bitwise(tmp_path):
    from artis_tpu_torch.driver import Simulation

    opts = _classic_opts(300, vpkt_on=True)
    d1, d2 = tmp_path / "straight", tmp_path / "resumed"
    for d in (d1, d2):
        d.mkdir()
        make_run(str(d), **CLASSIC)
        (d / "vpkt.txt").write_text(VPKT_TXT)
    a = Simulation(str(d1), opts, device="cpu")
    for nts in range(2):
        a.do_timestep(nts)
    a.finish()
    a.close()
    b1 = Simulation(str(d2), opts, device="cpu")
    b1.do_timestep(0)
    b1.save_checkpoint(1)
    b1.close()
    b2 = Simulation(str(d2), opts, device="cpu")
    assert b2.params.timestep_start == 1 and b2._vspec_total[..., 0].sum() > 0
    b2.do_timestep(1)
    b2.finish()
    b2.close()
    assert np.array_equal(a._vspec_total, b2._vspec_total)
    assert np.array_equal(a._vgrid_total, b2._vgrid_total)
    for f in ("specpol_virtual.out", "vpkt_grid.out"):
        assert (d1 / f).read_bytes() == (d2 / f).read_bytes(), f

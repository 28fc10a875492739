"""The host helpers of the crossing kernel's wrapper, on the CPU: the bin
edge tables (float32 and float64) the redesigned bin walk (K4) reads,
against the plain version's and the JAX package's edges bitwise; the packed
estimator outputs of a launch, against the shapes the plain version
returns; the shared-memory staging plan of the redesigned 1D line walk (K1)
at the main path's sizes in both precisions;
the row mode of the redesigned cylindrical walk (K3) at both cylinders'
sizes and the alignment its vector reductions need; and each launch's
shared memory within the card's limit."""

import numpy as np
import pytest
import torch

from artis_tpu_torch.transport import rpkt_kernel as rk
from artis_tpu_torch.transport.expansionopacity import NBINS, bin_walk


def test_expo_edges_match_the_plain_and_jax_edges():
    """The kernel's edge table is the float32 rounding of the float64 edges,
    bit for bit the edges the plain version's bin walk and the JAX
    package's compare with; strictly descending."""
    from artis_tpu.transport import expansionopacity as jexpo

    edges = rk.expo_edges(torch.device("cpu"))
    assert edges.dtype == torch.float32 and edges.shape == (NBINS,) and edges.is_contiguous()
    # the plain version's bin walk: a packet with nu just above edge b has
    # its first path length in bin b (a zero optical-depth target takes the
    # event there)
    b = np.arange(NBINS, dtype=np.float64)
    jax_edges = np.asarray(jexpo.bin_nu_lower(b)).astype(np.float32)
    assert np.array_equal(edges.numpy().view(np.int32), jax_edges.view(np.int32))
    assert bool((edges[1:] < edges[:-1]).all())
    probe = torch.tensor([3, 250, 969])
    nu = torch.nextafter(edges[probe], torch.tensor(np.inf, dtype=torch.float32))
    n = nu.shape[0]
    one = torch.ones(n, dtype=torch.float32)
    w = bin_walk(torch.zeros((n, NBINS), dtype=torch.float32), nu, 1e5 * one, one,
                 torch.full((n,), 1e-30, dtype=torch.float32), -one, torch.ones(n, dtype=bool),
                 False, 3e38)
    assert torch.equal(w["j"], probe) and bool(w["anyhit"].all())
    # the same nu exactly on the edge has no path length in that bin (and,
    # on the last edge, none in any: the packet is redder than every bin)
    w = bin_walk(torch.zeros((n, NBINS), dtype=torch.float32), edges[probe], 1e5 * one, one,
                 torch.full((n,), 1e-30, dtype=torch.float32), -one, torch.ones(n, dtype=bool),
                 False, 3e38)
    assert torch.equal(w["j"][:2], probe[:2] + 1)
    assert w["anyhit"].tolist() == [True, True, False]


@pytest.mark.parametrize("relativistic", [True, False])
def test_expo_edges_float64_match_the_plain_and_jax_edges(relativistic):
    """The double bin walk's edge table: the float64 edges themselves, bit
    for bit the ones the plain version's float64 bin walk compares with,
    within an ulp of the JAX package's (torch divides a scalar by a tensor
    through the reciprocal, which rounds 272 of the 970 edges one ulp away
    from the quotient), strictly descending; the first bin with path
    length of a packet just above edge b is b, of one exactly on it b + 1,
    in the relativistic and the non-relativistic walk."""
    from artis_tpu.transport import expansionopacity as jexpo

    edges = rk.expo_edges(torch.device("cpu"), torch.float64)
    assert edges.dtype == torch.float64 and edges.shape == (NBINS,) and edges.is_contiguous()
    b = np.arange(NBINS, dtype=np.float64)
    jax_edges = np.asarray(jexpo.bin_nu_lower(b), dtype=np.float64)
    assert np.all(np.abs(edges.numpy().view(np.int64) - jax_edges.view(np.int64)) <= 1)
    from artis_tpu_torch.transport.expansionopacity import bin_nu_lower

    plain = bin_nu_lower(torch.arange(NBINS, dtype=torch.float64))
    assert torch.equal(edges.view(torch.int64), plain.view(torch.int64))
    assert bool((edges[1:] < edges[:-1]).all())
    probe = torch.tensor([0, 3, 250, 968])
    one = torch.ones(probe.shape[0], dtype=torch.float64)
    walk = lambda nu: bin_walk(torch.zeros((nu.shape[0], NBINS), dtype=torch.float64), nu,
                               1e5 * one, one, torch.full_like(one, 1e-300), -one,
                               torch.ones(nu.shape[0], dtype=bool), relativistic, 3e38)
    w = walk(torch.nextafter(edges[probe], torch.tensor(np.inf, dtype=torch.float64)))
    assert torch.equal(w["j"], probe) and bool(w["anyhit"].all())
    w = walk(edges[probe])
    assert torch.equal(w["j"], probe + 1) and bool(w["anyhit"].all())


# (ngc, nbfr, nradbins, njblue, LUT estimators) of the launches the main
# paths make: the default scene, bf-rate estimators, the nebular fields
ROWS = [(7, 0, 0, 0, True), (7, 12, 0, 0, True), (1, 12, 64, 196, False), (3, 0, 8, 0, True)]


@pytest.mark.parametrize("ngc,nbfr,nradbins,njblue,lut", ROWS)
def test_estimator_buffers_match_the_plain_outputs(ngc, nbfr, nradbins, njblue, lut):
    """One zero fill holds every accumulated output: the shapes and dtypes
    the plain version returns for the same keywords, zeros, contiguous and
    disjoint views."""
    ncells = 5
    bufs = rk.estimator_buffers(ncells, ngc, nbfr, nradbins=nradbins, njblue=njblue,
                                want_gamma=lut, want_bfheat=lut)
    ref = {"est": (ncells, 4), "gamma": (ncells, ngc if lut else 0),
           "bfheat": (ncells, ngc if lut else 0), "bfrate": (ncells, nbfr),
           "radbin": (ncells, 3, nradbins), "jblue": (ncells, 2, njblue), "misc": (rk.NMISC,)}
    assert set(bufs) == set(ref)
    for k, shape in ref.items():
        v = bufs[k]
        assert tuple(v.shape) == shape and v.is_contiguous(), k
        assert v.dtype == (torch.float64 if k == "misc" else torch.float32), k
        assert bool((v == 0).all()), k
    # writing each view leaves every other one as it was
    for i, k in enumerate(sorted(ref)):
        bufs[k].fill_(i + 1)
    for i, k in enumerate(sorted(ref)):
        assert bool((bufs[k] == i + 1).all()), k
    assert bufs["misc"].data_ptr() % 8 == 0


def test_estimator_buffers_shapes_are_the_plain_versions():
    """The shapes the plain version itself returns, on a one-lane launch of
    each row layout."""
    ncells, nlines, ncont, nphixs, ngc = 3, 4, 2, 3, 2
    f = lambda *s: torch.zeros(s, dtype=torch.float32)
    i = lambda *s: torch.zeros(s, dtype=torch.int32)
    lanes = {k: f(1) for k in rk.LANE_F32}
    lanes.update({k: i(1) for k in rk.LANE_I32})
    lanes.update(posx=torch.tensor([1e14]), prop_time=torch.tensor([1e6]),
                 nu_rf=torch.tensor([1e15]), nu_cmf=torch.tensor([1e15]))
    tables = dict(cellmin=torch.tensor([0.0, 1e14, 2e14]), cellmax=torch.tensor([1e14, 2e14, 3e14]),
                  nne=f(ncells) + 1.0, Te=f(ncells) + 1e4, kappagrey=f(ncells),
                  rho=f(ncells) + 1e-14, chiffpart=f(ncells),
                  line_nu=torch.tensor([4e15, 3e15, 2e15, 1e15]), tau_factor=f(ncells, nlines),
                  cont_nu_edge=torch.tensor([1e14, 2e14]), bf_a=f(ncells, ncont),
                  bf_dep=f(ncells, ncont), cont_phixs=f(ncont, nphixs), cont_prob=f(ncont) + 1.0,
                  gc_nu_edge=torch.tensor([1e14, 2e14]), expo_kappa=f(ncells, NBINS),
                  mgi_of_cell=torch.arange(ncells, dtype=torch.int32), thick=i(ncells),
                  cont_gidx=torch.arange(ncont, dtype=torch.int32),
                  jblue_of_line=torch.arange(nlines, dtype=torch.int32))
    for _, nbfr, nradbins, njblue, lut in ROWS:
        p = rk.propagate_reference(
            1, lanes, tables, f(1) + 1.0, f(1) + 0.5, 2e6, 1e6, 1e30, nlines=nlines,
            ncells=ncells, ngc=ngc, nphixs=nphixs, max_inner=1, relativistic=True,
            phixs_dnu=0.1, last_nuovernuedge=10.0, test_mode=True, want_bfrate=nbfr > 0,
            nradbins=nradbins, njblue=njblue, want_gamma=lut, want_bfheat=lut)
        bufs = rk.estimator_buffers(ncells, ngc, ncont if nbfr else 0, nradbins=nradbins,
                                    njblue=njblue, want_gamma=lut, want_bfheat=lut)
        for k, v in bufs.items():
            assert v.shape == p[k].shape and v.dtype == p[k].dtype, k


# (nprop, ncells, ncont, nphixs, ngc, nlines) of the 1D main paths: the
# default scene (16 shells, 196 lines) and the 128-shell Fe-atom scene
DEFAULT = (16, 16, 12, 20, 4, 196)
REALISTIC = (128, 128, 6, 20, 2, 101010)


def test_stage_plan_at_the_main_path_sizes():
    """Every group of the default scene's tables fits the budget; of the
    128-shell scene's all but the lines (its walk reads global memory); no
    budget, no staging; the bytes are the groups' words."""
    mask, used = rk.stage_plan(*DEFAULT)
    words = rk.stage_words(*DEFAULT)
    assert mask == (rk.STAGE_CELL | rk.STAGE_BF | rk.STAGE_BFCELL | rk.STAGE_LINES)
    assert used == 4 * sum(words.values()) <= rk.STAGE_MAX
    mask, used = rk.stage_plan(*REALISTIC)
    rwords = rk.stage_words(*REALISTIC)
    assert mask == rk.STAGE_CELL | rk.STAGE_BF | rk.STAGE_BFCELL
    assert used == 4 * (sum(rwords.values()) - rwords[rk.STAGE_LINES])
    assert rk.stage_plan(*DEFAULT, budget=0) == (0, 0)
    # a group that does not fit is passed over, later ones that do are taken
    dims = (4, 4, 10, 20, 2, 10)  # the bf tables larger than the rest together
    w = rk.stage_words(*dims)
    budget = 4 * (w[rk.STAGE_CELL] + w[rk.STAGE_BFCELL] + w[rk.STAGE_LINES])
    assert w[rk.STAGE_BF] > w[rk.STAGE_BFCELL] + w[rk.STAGE_LINES]
    assert rk.stage_plan(*dims, budget=budget) == (
        rk.STAGE_CELL | rk.STAGE_BFCELL | rk.STAGE_LINES, budget)


ALL_GROUPS = rk.STAGE_CELL | rk.STAGE_BF | rk.STAGE_BFCELL | rk.STAGE_LINES


@pytest.mark.parametrize("dims,expect", [(DEFAULT, ALL_GROUPS),
                                         (REALISTIC, ALL_GROUPS & ~rk.STAGE_LINES)])
def test_stage_plan_in_double(dims, expect):
    """A float64 launch counts 8 bytes a slot against STAGE_MAX_F64: the
    default scene stages all four groups (33,120 bytes, beyond the float32
    budget), the 128-shell scene all but its lines; the bytes are 8 a slot,
    twice the float32 plan's for the same groups, and the launch's shared
    memory holds them beside the rows."""
    words = rk.stage_words(*dims)
    mask, used = rk.stage_plan(*dims, elem=8)
    assert mask == expect
    assert used == 8 * sum(w for g, w in words.items() if mask & g) <= rk.STAGE_MAX_F64
    if dims == DEFAULT:
        assert used == 33120 > rk.STAGE_MAX
        assert rk.stage_plan(*dims)[1] == used // 2
    nprop, ncells, ncont, nphixs, ngc, nlines = dims
    shared = rk.pick_shared_rows(ncells, ngc, 0, 8)
    smem = rk.smem_bytes(ncells, ngc, 0, shared, True, False, used, 8)
    assert smem == (rk.row_bytes(ncells, ngc, 0, 8) if shared else 8 * rk.NMISC) + used
    # even three blocks of the double walk fit an SM's shared memory
    assert 3 * smem <= rk.SMEM_LIMIT
    assert rk.stage_plan(*dims, budget=0, elem=8) == (0, 0)


def test_double_edge_table_bytes():
    """A float64 expansion launch's edge table takes 8 * NBINS bytes of
    shared memory after the rows (4 * NBINS in float32)."""
    for shared in (True, False):
        rows = rk.row_bytes(16, 7, 0, 8) if shared else 8 * rk.NMISC
        assert rk.smem_bytes(16, 7, 0, shared, False, True, elem=8) == rows + 8 * NBINS
    assert (rk.smem_bytes(1250, 3, 0, False, False, True, elem=8)
            - rk.smem_bytes(1250, 3, 0, False, False, True)) == 4 * NBINS


@pytest.mark.parametrize("geom,expansion,nlte,expect", [
    (rk.GEOM_SPH, False, False, (True, False, False, False)),
    (rk.GEOM_SPH, False, True, (False, False, False, False)),
    (rk.GEOM_SPH, True, False, (False, False, True, False)),
    (rk.GEOM_CYL, True, False, (False, False, True, False)),
    (rk.GEOM_CART, True, False, (False, False, False, False)),
    (rk.GEOM_CYL, False, False, (False, True, False, False)),
    (rk.GEOM_CART, False, True, (False, False, False, False)),
    (rk.GEOM_CYL, False, True, (False, False, False, False)),
    (rk.GEOM_CYL, True, True, (False, False, False, False)),
    (rk.GEOM_SPH, True, True, (False, False, False, False)),
    (rk.GEOM_CART, True, True, (False, False, False, False))])
def test_redesigned_instantiations(geom, expansion, nlte, expect):
    """(K1, K3, K4, double walk) of a float32 launch: the 1D line walk, the
    cylindrical line walk and the 1D and cylindrical bin walks without the
    NLTE fields run the redesigned code; the 3D walks and every
    instantiation with the NLTE fields keep theirs (11 instantiations, the
    3D line walk only with the fields); no float32 launch runs a double
    walk; the redesigned 1D line walk runs its kernel of its own."""
    assert rk.redesigned(geom, expansion, nlte) == expect
    assert rk.kernel_name(geom, expansion, nlte).startswith(
        "rpkt_crossing_kernel_1d<float>" if expect[0] else "rpkt_crossing_kernel<float, ")


def test_shared_memory_of_the_main_path_launches():
    """The default and 128-shell K1 launches, the expansion-opacity
    cylinder's K4 launch and a forced shared-row launch fit the card's
    shared memory; the rows of 6000 cells in shared memory do not."""
    for dims in (DEFAULT, REALISTIC):
        nprop, ncells, ncont, nphixs, ngc, nlines = dims
        _, staged = rk.stage_plan(*dims)
        shared = rk.pick_shared_rows(ncells, ngc, 0)
        assert rk.smem_bytes(ncells, ngc, 0, shared, True, False, staged) <= rk.SMEM_LIMIT
    assert rk.smem_bytes(1250, 3, 0, False, False, True) <= rk.SMEM_LIMIT
    assert rk.smem_bytes(16, 7, 0, True, True, False, 4096) == rk.row_bytes(16, 7, 0) + 4096
    assert rk.smem_bytes(16, 7, 0, False, False, True) == 8 * rk.NMISC + 4 * NBINS
    assert rk.smem_bytes(6000, 3, 0, True, False, True) > rk.SMEM_LIMIT


# (ncells, ngc) of the cylinders K3 walks on its main paths: 25 x 50 cells
# with the synthetic atom (4 ground continua) and with the Fe atom (2)
CYLINDERS = [(1250, 4), (1250, 2)]


@pytest.mark.parametrize("ncells,ngc", CYLINDERS)
def test_k3_row_mode_at_the_cylinders(ncells, ngc):
    """Both cylinders' rows (60 KB and 40 KB) are above SHARED_ROWS_MAX, so
    the wrapper adds them straight into the global rows, where K3 adds a
    cell's four floats with one vector reduction; the rows in shared memory,
    as a caller may force, fit the card's limit; a launch on global rows
    takes only the counters' shared memory."""
    rows = rk.row_bytes(ncells, ngc, 0)
    assert rows == 8 * rk.NMISC + 4 * ncells * (4 + 2 * ngc)
    assert not rk.pick_shared_rows(ncells, ngc, 0)
    k1, k3, k4, _ = rk.redesigned(rk.GEOM_CYL, False, False)
    assert k3 and not (k1 or k4)
    assert rk.smem_bytes(ncells, ngc, 0, True, k1, k4) == rows <= rk.SMEM_LIMIT
    assert rk.smem_bytes(ncells, ngc, 0, False, k1, k4) == 8 * rk.NMISC


def test_k3_rows_beyond_shared_memory():
    """A cylinder of 6000 cells with the synthetic atom's 4 ground continua
    has rows beyond the card's shared memory: no row mode but the global
    one can take it."""
    assert rk.row_bytes(6000, 4, 0) > rk.SMEM_LIMIT
    assert rk.smem_bytes(6000, 4, 0, True, False, False) > rk.SMEM_LIMIT
    assert not rk.pick_shared_rows(6000, 4, 0)


@pytest.mark.parametrize("ngc,nbfr,nradbins,njblue,lut", ROWS)
def test_estimator_rows_are_16_byte_aligned(ngc, nbfr, nradbins, njblue, lut):
    """The est rows start 16 bytes past a multiple of 16 from the packed
    buffer's start (after the eight double counters), so a cell's four
    floats are one aligned vector for K3's reduction."""
    bufs = rk.estimator_buffers(1250, ngc, nbfr, nradbins=nradbins, njblue=njblue,
                                want_gamma=lut, want_bfheat=lut)
    offset = bufs["est"].data_ptr() - bufs["misc"].data_ptr()
    assert offset == 8 * rk.NMISC and offset % 16 == 0
    assert bufs["est"].stride() == (4, 1)


def test_ff_only_empty_window_matches_zero_bf_tables(tmp_path):
    """The free-free continuum of the grey opacity cases 0-3 in its two
    forms: without the detailed bf-rate rows the launch has no continuum
    (an empty window), with them a zero bf_a table and no ground-continuum
    index. On the same lanes both give the same lanes, J / nuJ / ffheating
    rows, zero LUT rows and counters, but for the bf continua that the
    bf-rate form's windows hold."""
    from artis_tpu_torch.driver import Simulation
    from artis_tpu_torch.options import GridType, kilonova_lte
    from artis_tpu_torch.synthdata import make_run

    d = str(tmp_path)
    make_run(d, ncells=8, ntimesteps=2, tmin_days=5.0, tmax_days=9.0, ngreyts=0,
             logrho0=-9.0, logrho_slope=-0.15)
    opts = kilonova_lte(npkts=64, grid_type=GridType.SPHERICAL1D, mintemp=1000.0,
                        maxtemp=20000.0, tablesize=8, transport_dtype="float32")
    sim = Simulation(d, opts, datadir="/nonexistent", device="cpu")
    ctx = sim.update_grid(0)
    tables = rk.kernel_tables(sim.dad, sim.grid, sim.cells, ctx)
    # singly ionised at 1e4 K and 1e4 times denser, so that free-free absorbs
    te = torch.full_like(tables["Te"], 1.0e4)
    nne = tables["rho"] * 1e4 / (56.0 * 1.66054e-24)
    tables = dict(tables, thick=torch.zeros_like(tables["thick"]), Te=te, nne=nne,
                  chiffpart=nne * 3.69255e8 / torch.sqrt(te))
    rng = np.random.default_rng(5)
    n, t0 = 256, float(ctx.ts)
    cell = rng.integers(0, 8, n)
    rmin = sim.grid_host.cell_pos_min[:8, 0] * t0 / sim.grid.tmin
    rmax = sim.grid_host.cell_pos_max[:8, 0] * t0 / sim.grid.tmin
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = u * (rmin[cell] + (rmax[cell] - rmin[cell]) * rng.uniform(0.02, 0.98, n))[:, None]
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    nu = 10 ** rng.uniform(14.2, 15.9, n)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    i = lambda x: torch.as_tensor(np.asarray(x, np.int32))
    lanes = dict(posx=f(pos[:, 0]), posy=f(pos[:, 1]), posz=f(pos[:, 2]), dirx=f(dv[:, 0]),
                 diry=f(dv[:, 1]), dirz=f(dv[:, 2]), nu_rf=f(nu), nu_cmf=f(nu * 0.98),
                 e_rf=f(np.ones(n)), e_cmf=f(np.full(n, 0.98)), prop_time=f(np.full(n, t0)),
                 where=i(cell), next_trans=i(np.zeros(n)), moving=i(np.ones(n)),
                 lane_id=i(np.arange(n)))
    dad = sim.dad
    kw = dict(nlines=dad.nlines, ncells=8, ngc=max(dad.nbfcontinua_ground, 1),
              nphixs=dad.nphixspoints, max_inner=16, relativistic=True,
              phixs_dnu=float(dad.nphixsnuincrement),
              last_nuovernuedge=float(dad.last_phixs_nuovernuedge), test_mode=True,
              ff_only=True)
    args = (3, lanes, tables, f(-np.log(rng.uniform(0.05, 0.95, n))),
            f(rng.uniform(0.0, 1.0, n)), float(ctx.t2), float(sim.grid.tmin),
            float(sim.grid.max_path_step))
    empty = rk.propagate_reference(*args, want_bfrate=False, **kw)
    zero = rk.propagate_reference(*args, want_bfrate=True, **kw)
    sim.close()
    assert dad.nbfcontinua > 0 and float(zero["misc"][7]) > 0 and float(empty["misc"][7]) == 0
    assert float(zero["bfrate"].sum()) > 0 and empty["bfrate"].numel() == 0
    assert float(empty["est"][:, 2].sum()) > 0  # free-free heating
    assert int((empty["evented"] > 0).sum()) > 0
    for k in rk.OUT_F32 + rk.OUT_I32 + ("est", "gamma", "bfheat"):
        torch.testing.assert_close(empty[k], zero[k], rtol=0, atol=0, msg=k)
    for k in ("gamma", "bfheat"):
        assert not empty[k].any(), k
    torch.testing.assert_close(empty["misc"][:7], zero["misc"][:7], rtol=0, atol=0)


# the double forms: the host side of a float64 launch


@pytest.mark.parametrize("ngc,nbfr,nradbins,njblue,lut", ROWS)
def test_float64_estimator_buffers(ngc, nbfr, nradbins, njblue, lut):
    """A float64 launch's accumulated outputs: float64 rows after the
    NMISC float64 counters, the rows 16-byte aligned as in float32, every
    view zero and disjoint, 8 bytes an entry in the row budget."""
    ncells = 5
    kw = dict(nradbins=nradbins, njblue=njblue, want_gamma=lut, want_bfheat=lut)
    bufs = rk.estimator_buffers(ncells, ngc, nbfr, dtype=torch.float64, **kw)
    f32 = rk.estimator_buffers(ncells, ngc, nbfr, **kw)
    assert bufs["misc"].dtype == torch.float64 and bufs["misc"].shape == (rk.NMISC,)
    for k, v in bufs.items():
        assert v.dtype == torch.float64 and v.shape == f32[k].shape and not v.any(), k
    assert bufs["est"].data_ptr() % 16 == 0
    ptrs = sorted((v.data_ptr(), v.data_ptr() + 8 * v.numel()) for v in bufs.values())
    assert all(a[1] <= b[0] for a, b in zip(ptrs, ptrs[1:]))
    assert rk.row_bytes(ncells, ngc, nbfr, 8, **kw) - 8 * rk.NMISC == 2 * (
        rk.row_bytes(ncells, ngc, nbfr, **kw) - 8 * rk.NMISC)


# (K1, K3, K4, double walk) of a float64 launch, per geometry, walk (lines
# or expansion-opacity bins) and NLTE fields, and the CUDA kernel it runs:
# the 1D line walk (staged tables, warp sums), the 3D line walk (which
# always takes the NLTE instantiation) and the cylindrical line walk
# without the fields run the redesigned double line loop, K3 with its
# XYDir; the bin walks of the 1D and cylindrical grids without the fields
# read the staged double edge table (K4); the 3D bin walk and the other
# NLTE instantiations run the generic body; every double form is an
# instantiation of the generic kernel (the float32 K1 has a kernel of its
# own)
_D = "rpkt_crossing_kernel<double, "
F64_REDESIGNS = {
    (rk.GEOM_SPH, False, False): ((True, False, False, True), _D + "GEOM_SPH, false, false>"),
    (rk.GEOM_SPH, False, True): ((False, False, False, False), _D + "GEOM_SPH, false, true>"),
    (rk.GEOM_SPH, True, False): ((False, False, True, False), _D + "GEOM_SPH, true, false>"),
    (rk.GEOM_SPH, True, True): ((False, False, False, False), _D + "GEOM_SPH, true, true>"),
    (rk.GEOM_CYL, False, False): ((False, True, False, True), _D + "GEOM_CYL, false, false>"),
    (rk.GEOM_CYL, False, True): ((False, False, False, False), _D + "GEOM_CYL, false, true>"),
    (rk.GEOM_CYL, True, False): ((False, False, True, False), _D + "GEOM_CYL, true, false>"),
    (rk.GEOM_CYL, True, True): ((False, False, False, False), _D + "GEOM_CYL, true, true>"),
    (rk.GEOM_CART, False, False): ((False, False, False, True), _D + "GEOM_CART, false, true>"),
    (rk.GEOM_CART, False, True): ((False, False, False, True), _D + "GEOM_CART, false, true>"),
    (rk.GEOM_CART, True, False): ((False, False, False, False), _D + "GEOM_CART, true, false>"),
    (rk.GEOM_CART, True, True): ((False, False, False, False), _D + "GEOM_CART, true, true>"),
}


@pytest.mark.parametrize("geom,expansion,nlte", list(F64_REDESIGNS))
def test_float64_launches_take_the_generic_body(geom, expansion, nlte):
    """The redesigns a float64 launch runs and its kernel: the double 1D,
    3D and cylindrical line walks and the 1D and cylindrical bin walks
    without the NLTE fields run redesigned code, only the 3D bin walk and
    the other NLTE instantiations the generic body; K1 and K4 are the same
    redesigns as in float32 (the staged tables, the edge table), which no
    double walk of another geometry or with the NLTE fields takes; no
    float32 launch runs a double line loop."""
    r = rk.redesigned(geom, expansion, nlte, f64=True)
    expect, kernel = F64_REDESIGNS[geom, expansion, nlte]
    assert r == expect
    f32 = rk.redesigned(geom, expansion, nlte)
    assert (r.k1, r.k3, r.k4) == (f32.k1, f32.k3, f32.k4)
    assert f32.w64 is False
    assert rk.kernel_name(geom, expansion, nlte, f64=True) == kernel


def test_float64_radbins_are_the_xla_paths():
    """The multibin layout of a float64 launch is the JAX package's XLA
    select_bin in float64: the same bin for frequencies across and beyond
    the range (the float32 layout rounds each edge to float32)."""
    from artis_tpu.plasma import radfield as jrad

    nbins = 64
    nu = torch.tensor(np.concatenate([10 ** np.linspace(13.5, 16.5, 4001),
                                      np.array(rk.radbin_edges(nbins, torch.float64)[:3])]))
    b, inside = rk.radbin_index(nu, nbins)
    j = np.asarray(jrad.select_bin(nu.numpy(), nbins))
    assert np.array_equal(np.where(inside.numpy(), b.numpy(), -1), j)
    assert rk.radbin_edges(nbins, torch.float32) != rk.radbin_edges(nbins, torch.float64)


def test_philox_uniform2d_bits():
    """The float64 draws: 53 bits from each pair of Philox words, in (0, 1),
    the words the float32 draws take their 24 high bits from."""
    from artis_tpu_torch import rng

    lane = torch.arange(20000)
    u = rng.philox_uniform2d(0x1234_5678_9ABC, lane, 3, 2)
    w = rng._philox_words(0x1234_5678_9ABC, lane, 3, 2)
    v = rng.philox_uniform4(0x1234_5678_9ABC, lane, 3, 2)
    for i in (0, 1):
        assert u[i].dtype == torch.float64
        assert bool((u[i] > 0).all()) and bool((u[i] < 1).all())
        bits = (u[i] * 2.0 ** 53).long()
        assert torch.equal(bits >> 26, w[2 * i] >> 5) and torch.equal(bits & ((1 << 26) - 1),
                                                                       w[2 * i + 1] >> 6)
        # the float32 uniform of the first word is its 24 high bits
        assert torch.equal((u[i] * 2.0 ** 24).floor(), (v[2 * i] * 2.0 ** 24).double())
        assert abs(float(u[i].mean()) - 0.5) < 0.01


@pytest.mark.parametrize("field", rk.OUT_I32)
def test_held_lanes_are_every_lane_with_a_differing_integer_output(field):
    """check_kernel holds still, for its estimator comparison, every lane on
    which any integer output differs (``held_lanes``): a differing cell,
    escape or event as much as a differing cursor, line, continuum or
    scatter count; lanes that differ only in a float output stay moving."""
    n = 64
    gen = torch.Generator().manual_seed(3)
    p = {f: torch.randint(-3, 50, (n,), generator=gen, dtype=torch.int32) for f in rk.OUT_I32}
    p.update({f: torch.rand(n, generator=gen, dtype=torch.float64) for f in rk.OUT_F32})
    k = {f: v.clone() for f, v in p.items()}
    assert not bool(rk.held_lanes(k, p).any())
    k[field][[5, 17, 40]] += 1
    k["prop_time"][[2, 17, 60]] *= 1.5  # a float output alone holds no lane
    mask = rk.held_lanes(k, p)
    assert mask.dtype == torch.bool and mask.shape == (n,)
    assert torch.nonzero(mask)[:, 0].tolist() == [5, 17, 40]
    k["nsc"][9] += 2  # a second field adds its lanes
    assert torch.nonzero(rk.held_lanes(k, p))[:, 0].tolist() == sorted({5, 9, 17, 40})

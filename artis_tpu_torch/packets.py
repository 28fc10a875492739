"""Packet state as a struct-of-arrays + pellet initialisation.

Port of the JAX package's packet model (reference: packet.h:32-68,
packet.cc:86-162 packet_init, packet.cc:30-82 place_pellet,
decay.cc:1311-1402 setup_radioactive_pellet, decay.cc:475-490
sample_decaytime). Sampling draws from counter-derived generators
(``rng``), so initialisation depends only on the seed tuple.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry, rng
from .constants import H, PI
from .grid import GridData, get_cell_volume_tmin
from .options import GridType, Options

# packet types (reference: packet.h:7-20)
TYPE_ESCAPE = 32
TYPE_RADIOACTIVE_PELLET = 100
TYPE_GAMMA = 10
TYPE_RPKT = 11
TYPE_KPKT = 12
TYPE_MA = 13
TYPE_NTLEPTON_DEPOSITED = 20
TYPE_NONTHERMAL_PREDEPOSIT_BETAMINUS = 21
TYPE_NONTHERMAL_PREDEPOSIT_BETAPLUS = 22
TYPE_NONTHERMAL_PREDEPOSIT_ALPHA = 23
TYPE_NTALPHA_DEPOSITED = 24
TYPE_PRE_KPKT = 120
TYPE_INACTIVE = 0

EMTYPE_NOTSET = -9999000
EMTYPE_FREEFREE = -9999999


@dataclasses.dataclass(frozen=True)
class PacketState:
    """Struct-of-arrays over the packet batch (reference: packet.h:32-68).
    Integer fields are int64 tensors; float fields carry the transport dtype."""

    ptype: torch.Tensor
    prop_time: torch.Tensor
    where: torch.Tensor
    nscatterings: torch.Tensor
    pos: torch.Tensor  # (n, 3)
    dir: torch.Tensor  # (n, 3)
    e_cmf: torch.Tensor
    e_rf: torch.Tensor
    nu_cmf: torch.Tensor
    nu_rf: torch.Tensor
    next_trans: torch.Tensor
    emissiontype: torch.Tensor
    em_pos: torch.Tensor  # (n, 3)
    em_time: torch.Tensor
    absorptiontype: torch.Tensor
    absorptionfreq: torch.Tensor
    trueemissiontype: torch.Tensor
    trueem_time: torch.Tensor
    stokes: torch.Tensor  # (n, 3)
    tdecay: torch.Tensor
    escape_type: torch.Tensor
    escape_time: torch.Tensor
    number: torch.Tensor
    originated_from_particlenotgamma: torch.Tensor  # bool
    pellet_decaytype: torch.Tensor
    pellet_nucindex: torch.Tensor
    trueemissionvelocity: torch.Tensor
    ma_level: torch.Tensor

    @property
    def npkts(self) -> int:
        return self.ptype.shape[0]

    def replace(self, **kw) -> "PacketState":
        return dataclasses.replace(self, **kw)


def empty_state(npkts: int, dtype=torch.float64, device="cpu") -> PacketState:
    z = torch.zeros(npkts, dtype=dtype, device=device)
    zi = torch.zeros(npkts, dtype=torch.int64, device=device)
    z3 = torch.zeros((npkts, 3), dtype=dtype, device=device)
    stokes = torch.zeros((npkts, 3), dtype=dtype, device=device)
    stokes[:, 0] = 1.0
    return PacketState(
        ptype=zi, prop_time=z - 1.0, where=zi - 1, nscatterings=zi, pos=z3,
        dir=z3, e_cmf=z, e_rf=z, nu_cmf=z, nu_rf=z, next_trans=zi - 1,
        emissiontype=zi + EMTYPE_NOTSET, em_pos=torch.full_like(z3, float("nan")),
        em_time=z - 1.0, absorptiontype=zi, absorptionfreq=z,
        trueemissiontype=zi + EMTYPE_NOTSET, trueem_time=z - 1.0, ma_level=zi,
        stokes=stokes, tdecay=z - 1.0, escape_type=zi, escape_time=z - 1.0,
        number=torch.arange(npkts, device=device),
        originated_from_particlenotgamma=torch.zeros(npkts, dtype=torch.bool, device=device),
        pellet_decaytype=zi - 1, pellet_nucindex=zi - 1,
        trueemissionvelocity=z - 1.0,
    )


@dataclasses.dataclass(frozen=True)
class PelletTables:
    """Precomputed sampling tables for pellet placement."""

    en_cumulative_cell: torch.Tensor  # (ngrid,) in [0, 1]
    chan_cumulative: torch.Tensor  # (nonempty, nchannels) in [0, 1]
    path_meanlife: torch.Tensor  # (npaths, maxlen) [s], 0 padded
    path_len: torch.Tensor
    end_engamma: torch.Tensor
    end_enparticle: torch.Tensor
    end_nucindex: torch.Tensor
    end_decaytype: torch.Tensor
    norm: float
    e0: float
    t_model: float
    tmin: float
    tmax: float
    has_initial_energy_channel: bool
    initial_packets_on: bool


def make_pellet_tables(grid: GridData, decdata, initnucmassfrac_mgi,
                       initenergyq_mgi, opts: Options, tmin: float, tmax: float,
                       grid_host=None, device="cpu") -> PelletTables:
    """Build sampling tables (reference: packet.cc:103-128,
    decay.cc:1311-1334); host float64."""
    from . import decay as decay_mod

    time_min_decay = decdata.t_model if opts.initial_packets_on else tmin
    epm = decay_mod.setup_decaypath_energy_per_mass(
        decdata, initnucmassfrac_mgi, time_min_decay, tmax)
    mgi_of_cell = grid_host.mgi_of_cell
    npts = grid.npts_model
    q_mgi = epm.sum(axis=1)
    has_init_en = (opts.initial_packets_on and opts.use_model_initial_energy
                   and initenergyq_mgi is not None)
    if has_init_en:
        q_mgi = q_mgi + initenergyq_mgi
    vol = np.asarray(get_cell_volume_tmin(grid, grid_host), dtype=np.float64)
    rho = grid.rho_tmin_mgi.double().cpu().numpy()[mgi_of_cell]
    q_cell = np.where(mgi_of_cell < npts, np.concatenate([q_mgi, [0.0]])[mgi_of_cell], 0.0)
    en_cumulative = np.cumsum(vol * rho * q_cell)
    norm = float(en_cumulative[-1])
    if not norm > 0:
        raise ValueError("model has no decay energy to place pellets")
    en_cumulative = en_cumulative / norm

    mgi_of_nonempty = mgi_of_cell[grid_host.cell_of_nonemptymgi]
    chan_en = epm[mgi_of_nonempty]
    if has_init_en:
        chan_en = np.concatenate([chan_en, initenergyq_mgi[mgi_of_nonempty][:, None]], axis=1)
    chan_cumulative = np.cumsum(chan_en, axis=1)
    chan_total = chan_cumulative[:, -1:]
    chan_cumulative = np.where(chan_total > 0,
                               chan_cumulative / np.maximum(chan_total, 1e-300), 1.0)

    lam = decdata.path_lambdas[:, : decdata.maxlen]
    lenmask = np.arange(decdata.maxlen)[None, :] < decdata.path_len[:, None]
    meanlife = np.where(lenmask & (lam > 0), 1.0 / np.where(lam > 0, lam, 1.0), 0.0)
    end_nuc = decdata.path_end_nucindex
    end_dt = decdata.path_end_decaytype

    def t(x, dt=None):
        x = np.asarray(x)
        if dt is None:
            dt = torch.int64 if np.issubdtype(x.dtype, np.integer) else torch.float64
        return torch.as_tensor(x).to(device=device, dtype=dt)

    return PelletTables(
        en_cumulative_cell=t(en_cumulative), chan_cumulative=t(chan_cumulative),
        path_meanlife=t(meanlife), path_len=t(decdata.path_len),
        end_engamma=t(decdata.nuc_endecay_gamma[end_nuc]),
        end_enparticle=t(decdata.nuc_endecay_particle[end_nuc, end_dt]),
        end_nucindex=t(end_nuc.astype(np.int64)),
        end_decaytype=t(end_dt.astype(np.int64)),
        norm=norm, e0=norm / opts.npkts, t_model=float(decdata.t_model),
        tmin=float(tmin), tmax=float(tmax),
        has_initial_energy_channel=bool(has_init_en),
        initial_packets_on=bool(opts.initial_packets_on),
    )


def _sample_decaytimes(key, pathindex, tables: PelletTables, dtype):
    """Rejection-sample decay times (reference: decay.cc:475-490)."""
    meanlives = tables.path_meanlife.to(dtype)[pathindex]
    tdecaymin = tables.t_model if tables.initial_packets_on else tables.tmin
    n = pathindex.shape[0]
    tdecay = torch.zeros(n, dtype=dtype, device=pathindex.device)
    accepted = torch.zeros(n, dtype=torch.bool, device=pathindex.device)
    tiny = torch.finfo(dtype).tiny
    for it in range(100000):
        u = rng.uniform(key, it, meanlives.shape, dtype, pathindex.device)
        u = torch.clamp(u, min=tiny)
        t = tables.t_model + torch.sum(-meanlives * torch.log(u), dim=-1)
        ok = (t > tdecaymin) & (t < tables.tmax)
        tdecay = torch.where(ok & ~accepted, t, tdecay)
        accepted = accepted | ok
        if bool(accepted.all()):
            break
    return tdecay, accepted


def _sample_pos_in_cell(key, grid: GridData, cellindex, dtype):
    """Uniform position within each packet's cell at tmin (reference:
    packet.cc:37-64)."""
    n = cellindex.shape[0]
    dev = cellindex.device
    pmin = grid.cell_pos_min.to(dtype)[cellindex]
    pmax = grid.cell_pos_max.to(dtype)[cellindex]
    if grid.grid_type == GridType.SPHERICAL1D:
        # ratio form: r**3 at CGS radii overflows float32
        z = rng.uniform(key, 2, n, dtype, dev)
        r_inner, r_outer = pmin[:, 0], pmax[:, 0]
        ratio3 = torch.where(r_outer > 0, r_inner / torch.clamp(r_outer, min=1.0),
                             torch.zeros_like(r_outer)) ** 3
        radius = r_outer * (z * ratio3 + (1.0 - z)) ** (1.0 / 3.0)
        return rng.isotropic(key, 3, n, dtype, dev) * radius[:, None]
    if grid.grid_type == GridType.CYLINDRICAL2D:
        z = rng.uniform(key, 2, n, dtype, dev)
        rcyl = torch.sqrt(z * pmin[:, 0] ** 2 + (1.0 - z) * pmax[:, 0] ** 2)
        theta = rng.uniform(key, 3, n, dtype, dev) * 2.0 * PI
        zpos = pmin[:, 1] + rng.uniform(key, 7, n, dtype, dev) * (pmax[:, 1] - pmin[:, 1])
        return torch.stack([torch.cos(theta) * rcyl, torch.sin(theta) * rcyl, zpos], dim=-1)
    # CARTESIAN3D
    return pmin + rng.uniform(key, 2, (n, 3), dtype, dev) * (pmax - pmin)


def packet_init(key, grid: GridData, tables: PelletTables, opts: Options,
                device="cpu") -> PacketState:
    """Place all pellets (reference: packet.cc:86-162)."""
    dtype = torch.float64 if opts.transport_dtype == "float64" else torch.float32
    npkts = opts.npkts
    st = empty_state(npkts, dtype, device)

    target = rng.uniform(key, 1, npkts, torch.float64, device)
    cellindex = torch.searchsorted(tables.en_cumulative_cell, target, right=True)
    cellindex = torch.clamp(cellindex, max=grid.ngrid - 1)
    pos = _sample_pos_in_cell(key, grid, cellindex, dtype)

    nonemptymgi = grid.nonemptymgi_of_cell[cellindex]
    chan_rows = tables.chan_cumulative[nonemptymgi]
    ztarget = rng.uniform(key, 4, npkts, torch.float64, device)
    chanindex = torch.searchsorted(chan_rows, ztarget[:, None], right=True)[:, 0]
    npaths = tables.path_meanlife.shape[0]
    is_initial_energy = chanindex >= npaths
    pathindex = torch.clamp(chanindex, max=npaths - 1)

    tdecay, _ = _sample_decaytimes(rng.fold_in(key, 5), pathindex, tables, dtype)
    tdecay = torch.where(is_initial_energy, torch.full_like(tdecay, tables.tmin), tdecay)

    # packet energies are carried in units of e0 = etot/npkts (erg values
    # overflow float32; host-side output code rescales)
    e_cmf = torch.ones(npkts, dtype=dtype, device=device)
    engamma = tables.end_engamma[pathindex]
    enparticle = tables.end_enparticle[pathindex]
    ug = rng.uniform(key, 6, npkts, dtype, device)
    frac_gamma = torch.where(engamma + enparticle > 0, engamma / (engamma + enparticle),
                             torch.zeros_like(engamma))
    from_particle = (ug >= frac_gamma) & ~is_initial_energy
    nu_init_en = min(tables.e0 / H, 3.0e38) if dtype == torch.float32 else tables.e0 / H
    nu_cmf = torch.where(is_initial_energy, torch.full_like(enparticle, nu_init_en),
                         enparticle / H).to(dtype)
    minus1 = torch.full_like(pathindex, -1)
    pellet_nucindex = torch.where(is_initial_energy, minus1, tables.end_nucindex[pathindex])
    pellet_decaytype = torch.where(is_initial_energy, minus1, tables.end_decaytype[pathindex])

    dirvec = geometry.vec_norm(pos)
    prop_time = torch.full((npkts,), grid.tmin, dtype=dtype, device=device)
    doppler = geometry.doppler_nucmf_on_nurf(pos, dirvec, prop_time,
                                             opts.use_relativistic_doppler_shift)
    return st.replace(
        ptype=torch.full((npkts,), TYPE_RADIOACTIVE_PELLET, dtype=torch.int64, device=device),
        prop_time=prop_time, where=cellindex, pos=pos, dir=dirvec, e_cmf=e_cmf,
        e_rf=e_cmf / doppler, nu_cmf=nu_cmf,
        nu_rf=torch.zeros(npkts, dtype=dtype, device=device), tdecay=tdecay,
        pellet_nucindex=pellet_nucindex, pellet_decaytype=pellet_decaytype,
        originated_from_particlenotgamma=from_particle,
        trueemissiontype=torch.full((npkts,), EMTYPE_NOTSET, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# packet file I/O (reference: packet.cc:164-301)
# ---------------------------------------------------------------------------

_TEXT_HEADER = (
    "#number where type_id posx posy posz dirx diry dirz tdecay e_cmf e_rf nu_cmf nu_rf "
    "escape_type_id escape_time emissiontype trueemissiontype "
    "em_posx em_posy em_posz absorption_type absorption_freq nscatterings em_time stokes1 stokes2 "
    "stokes3 originated_from_positron "
    "true_emission_velocity trueem_time pellet_nucindex"
)


def _np(x):
    return x.detach().cpu().numpy()


def write_packets_text(filename: str, st: PacketState, e_scale: float = 1.0) -> None:
    """Write the packets*.out text format (reference: packet.cc:165-190)."""
    cols = [
        _np(st.number), _np(st.where), _np(st.ptype), *_np(st.pos).T,
        *_np(st.dir).T, _np(st.tdecay),
        _np(st.e_cmf).astype(np.float64) * e_scale,
        _np(st.e_rf).astype(np.float64) * e_scale,
        _np(st.nu_cmf), _np(st.nu_rf), _np(st.escape_type), _np(st.escape_time),
        _np(st.emissiontype), _np(st.trueemissiontype), *_np(st.em_pos).T,
        _np(st.absorptiontype), _np(st.absorptionfreq), _np(st.nscatterings),
        _np(st.em_time), *_np(st.stokes).T,
        _np(st.originated_from_particlenotgamma).astype(int),
        _np(st.trueemissionvelocity), _np(st.trueem_time), _np(st.pellet_nucindex),
    ]
    kinds = "".join("i" if c.dtype.kind in "ib" else "f" for c in cols)
    from .io import packetio

    if packetio.write_text_table(filename, _TEXT_HEADER, cols, kinds):
        return
    with open(filename, "w") as f:
        f.write(_TEXT_HEADER + "\n")
        for row in zip(*cols):
            f.write(" ".join(
                str(int(v)) if v.dtype.kind in "ib" else f"{float(v):g}" for v in row
            ) + "\n")


def read_packets_text(filename: str) -> dict:
    """Read packets*.out (reference: packet.cc:235-301). Returns a numpy dict."""
    data = np.loadtxt(filename, ndmin=2)
    return dict(
        number=data[:, 0].astype(np.int64), where=data[:, 1].astype(np.int64),
        ptype=data[:, 2].astype(np.int64), pos=data[:, 3:6], dir=data[:, 6:9],
        tdecay=data[:, 9], e_cmf=data[:, 10], e_rf=data[:, 11],
        nu_cmf=data[:, 12], nu_rf=data[:, 13],
        escape_type=data[:, 14].astype(np.int64), escape_time=data[:, 15],
        emissiontype=data[:, 16].astype(np.int64),
        trueemissiontype=data[:, 17].astype(np.int64),
        em_pos=data[:, 18:21], absorptiontype=data[:, 21].astype(np.int64),
        absorptionfreq=data[:, 22], nscatterings=data[:, 23].astype(np.int64),
        em_time=data[:, 24], stokes=data[:, 25:28],
        originated_from_particlenotgamma=data[:, 28].astype(bool),
        trueemissionvelocity=data[:, 29], trueem_time=data[:, 30],
        pellet_nucindex=data[:, 31].astype(np.int64),
    )


def save_packets_npz(filename: str, st: PacketState) -> None:
    """Binary checkpoint of the full packet state (same file format as the
    JAX package: one array per field)."""
    np.savez_compressed(
        filename, **{f.name: _np(getattr(st, f.name)) for f in dataclasses.fields(st)})


def load_packets_npz(filename: str, device="cpu") -> PacketState:
    data = np.load(filename)

    def t(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        return torch.as_tensor(a).to(device)

    return PacketState(**{f.name: t(data[f.name]) for f in dataclasses.fields(PacketState)})

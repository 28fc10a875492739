"""Propagation grid: 1D spherical shells, 2D cylindrical (rcyl, z) cells
and 3D Cartesian cubes.

Port of the JAX package's grid layer (reference: grid.cc:1048-1137 setup,
grid.cc:470-527 model->grid mapping, grid.cc:2332-2597
get_cellindex_from_pos / boundary_distance, grid.cc:1222-1312
expanding_shell_intersection). Per-cell quantities are flat (ngrid, ...)
tensors; the geometric routines are vectorised over packet batches.

Cells are indexed x-fastest ("increment X first, then Y, then Z",
reference: grid.cc:1419-1445). snext == -99 encodes escape from the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import CLIGHT_PROP, PI
from .io.model import ModelData
from .options import GridType

BOUNDARY_ESCAPE = -99

META_FIELDS = ("grid_type", "ncoordgrid", "ngrid", "npts_model",
               "nonempty_npts", "tmin", "rmax", "vmax", "model_dim",
               "model_ncoord")


@dataclasses.dataclass(frozen=True)
class GridData:
    """Static propagation-grid geometry + model-cell association."""

    cell_pos_min: torch.Tensor  # (ngrid, ndim) at tmin, grid coordinates
    cell_pos_max: torch.Tensor  # (ngrid, ndim)
    mgi_of_cell: torch.Tensor  # (ngrid,); == npts_model for empty cells
    nonemptymgi_of_cell: torch.Tensor  # (ngrid,); -1 for empty
    cell_of_nonemptymgi: torch.Tensor  # (nonempty_npts,)
    rho_tmin_mgi: torch.Tensor  # (npts_model+1,)
    numpropcells_mgi: torch.Tensor  # (npts_model+1,)
    vout_model: torch.Tensor  # (npts_model,) 1D shells' outer velocity (zeros otherwise)
    initial_radial_pos_sum_mgi: torch.Tensor  # (npts_model+1,)

    grid_type: GridType
    ncoordgrid: tuple
    ngrid: int
    npts_model: int
    nonempty_npts: int
    tmin: float
    rmax: float
    vmax: float
    model_dim: int = 0  # dimensionality of the INPUT model
    model_ncoord: tuple = ()

    @property
    def max_path_step(self) -> float:
        # reference: update_grid.cc:1147
        return min(1e35, self.rmax / 10.0)


class GridHost:
    """Host (numpy) mirrors of the grid index/geometry arrays."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _geometry(model: ModelData, tmin: float, grid_type: GridType, ncoordgrid_xyz):
    """(ncoordgrid, pos_min, pos_max, mgi_of_cell) at tmin for one grid type
    and model dimensionality (reference: grid.cc:1048-1137, 470-527)."""
    vmax = model.vmax
    rmax = vmax * tmin
    npts = model.npts_model
    if grid_type == GridType.SPHERICAL1D:
        if model.dim != 1:
            raise ValueError(f"a {model.dim}D model on a SPHERICAL1D grid")
        v_inner = np.concatenate([[0.0], model.vout_model[:-1]])
        pos_min = (v_inner * tmin)[:, None]
        pos_max = (model.vout_model * tmin)[:, None]
        mgi_of_cell = np.where(model.rho_tmin > 0, np.arange(npts), npts)
        return (npts, 1, 1), pos_min, pos_max, mgi_of_cell
    if grid_type == GridType.CYLINDRICAL2D:
        if model.dim != 2:
            raise ValueError(f"a {model.dim}D model on a CYLINDRICAL2D grid")
        n_rcyl, n_z = model.ncoord_model
        ngrid = n_rcyl * n_z
        i_r = np.arange(ngrid) % n_rcyl
        i_z = np.arange(ngrid) // n_rcyl
        pos_min = np.stack([i_r * rmax / n_rcyl, rmax * (-1.0 + i_z * 2.0 / n_z)], axis=-1)
        pos_max = np.stack([(i_r + 1) * rmax / n_rcyl,
                            rmax * (-1.0 + (i_z + 1) * 2.0 / n_z)], axis=-1)
        mgi_of_cell = np.where(model.rho_tmin > 0, np.arange(ngrid), npts)
        return (n_rcyl, n_z, 1), pos_min, pos_max, mgi_of_cell
    if grid_type != GridType.CARTESIAN3D:
        raise ValueError(grid_type)
    ncoordgrid = tuple(int(v) for v in (model.ncoord_model if model.dim == 3
                                         else ncoordgrid_xyz))
    nx, ny, nz = ncoordgrid
    if not nx == ny == nz:
        raise ValueError(f"the 3D grid needs cubic cells (grid.cc:1069-1070), got {ncoordgrid}")
    ngrid = nx * ny * nz
    idx = np.arange(ngrid)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    wid = 2.0 * rmax / nx
    pos_min = np.stack([-rmax + 2.0 * ix * rmax / nx, -rmax + 2.0 * iy * rmax / ny,
                        -rmax + 2.0 * iz * rmax / nz], axis=-1)
    pos_max = pos_min + wid
    pos_mid = pos_min + 0.5 * wid
    if model.dim == 3:
        mgi_of_cell = np.where(model.rho_tmin > 0, idx, npts)
    elif model.dim == 1:
        # radial shell of the cell-centre velocity (grid.cc:470-487)
        cellvmid = np.linalg.norm(pos_mid, axis=-1) / tmin
        mgi = np.searchsorted(model.vout_model, cellvmid, side="left")
        inside = mgi < npts
        rho_ok = np.where(inside, model.rho_tmin[np.minimum(mgi, npts - 1)] > 0, False)
        mgi_of_cell = np.where(inside & rho_ok, mgi, npts)
    elif model.dim == 2:
        # (rcyl, z) bin of the cell centre (grid.cc:489-517)
        rcyl = np.sqrt(pos_mid[:, 0] ** 2 + pos_mid[:, 1] ** 2)
        n_rcyl_model, n_z_model = model.ncoord_model
        i_r = (rcyl / tmin / vmax * n_rcyl_model).astype(np.int64)
        i_z = ((pos_mid[:, 2] / tmin + vmax) / (2 * vmax) * n_z_model).astype(np.int64)
        valid = (i_r >= 0) & (i_r < n_rcyl_model) & (i_z >= 0) & (i_z < n_z_model)
        mgi = np.where(valid, i_z * n_rcyl_model + i_r, npts)
        rho_ok = model.rho_tmin[np.minimum(mgi, npts - 1)] > 0
        mgi_of_cell = np.where(valid & rho_ok, mgi, npts)
    else:
        raise ValueError(model.dim)
    return ncoordgrid, pos_min, pos_max, mgi_of_cell


def grid_init(model: ModelData, tmin: float, grid_type: GridType,
              ncoordgrid_xyz=(50, 50, 50), with_host: bool = False,
              device="cpu"):
    """Build the propagation grid and map model cells onto it
    (reference: grid.cc:2206-2325 grid_init, 1048-1137 setup_grid_*).
    ``ncoordgrid_xyz`` sizes the 3D grid of a 1D or 2D model; a 3D model
    keeps its own grid."""
    vmax = model.vmax
    rmax = vmax * tmin
    ncoordgrid, pos_min, pos_max, mgi_of_cell = _geometry(model, tmin, grid_type,
                                                          ncoordgrid_xyz)
    mgi_of_cell = np.asarray(mgi_of_cell, dtype=np.int64)
    ngrid = mgi_of_cell.shape[0]

    npts = model.npts_model
    numpropcells = np.bincount(mgi_of_cell, minlength=npts + 1).astype(np.int64)
    # nonempty model cells: associated propcells AND rho > 0
    # (reference: grid.cc:304-468 allocate_nonemptymodelcells)
    is_nonempty = (numpropcells[:npts] > 0) & (model.rho_tmin > 0)
    nonemptymgi_of_mgi = np.full(npts + 1, -1, dtype=np.int64)
    nonemptymgi_of_mgi[:npts][is_nonempty] = np.arange(is_nonempty.sum())
    nonemptymgi_of_cell = nonemptymgi_of_mgi[mgi_of_cell]
    nonempty_npts = int(is_nonempty.sum())

    # a representative propagation cell for each nonempty model cell: the
    # first one in cell order
    cells_ne = np.nonzero(nonemptymgi_of_cell >= 0)[0]
    uniq, first = np.unique(nonemptymgi_of_cell[cells_ne], return_index=True)
    cell_of_nonemptymgi = np.zeros(nonempty_npts, dtype=np.int64)
    cell_of_nonemptymgi[uniq] = cells_ne[first]

    rho_tmin_mgi = np.concatenate([model.rho_tmin, [0.0]])
    vout = model.vout_model if model.vout_model is not None else np.zeros(npts)

    # per-model-cell sum of propcell radial midpoints at tmin
    # (reference: grid.cc:304-333, get_cellradialposmid)
    mid = 0.5 * (pos_min + pos_max)
    if grid_type == GridType.SPHERICAL1D:
        radial_mid = mid[:, 0]
    else:
        radial_mid = np.linalg.norm(mid, axis=1)
    initial_radial_pos_sum = np.zeros(npts + 1)
    np.add.at(initial_radial_pos_sum, mgi_of_cell, radial_mid)

    host = GridHost(
        cell_pos_min=np.asarray(pos_min, dtype=np.float64),
        cell_pos_max=np.asarray(pos_max, dtype=np.float64),
        mgi_of_cell=mgi_of_cell,
        nonemptymgi_of_cell=nonemptymgi_of_cell,
        cell_of_nonemptymgi=cell_of_nonemptymgi,
        numpropcells_mgi=numpropcells,
        initial_radial_pos_sum_mgi=initial_radial_pos_sum,
    )

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    gd = GridData(
        cell_pos_min=t(host.cell_pos_min),
        cell_pos_max=t(host.cell_pos_max),
        mgi_of_cell=t(mgi_of_cell),
        nonemptymgi_of_cell=t(nonemptymgi_of_cell),
        cell_of_nonemptymgi=t(cell_of_nonemptymgi),
        rho_tmin_mgi=t(rho_tmin_mgi),
        numpropcells_mgi=t(numpropcells),
        vout_model=t(np.asarray(vout, np.float64)),
        initial_radial_pos_sum_mgi=t(initial_radial_pos_sum),
        grid_type=grid_type, ncoordgrid=tuple(int(v) for v in ncoordgrid), ngrid=int(ngrid),
        npts_model=npts, nonempty_npts=nonempty_npts, tmin=float(tmin),
        rmax=float(rmax), vmax=float(vmax), model_dim=int(model.dim),
        model_ncoord=tuple(int(v) for v in model.ncoord_model),
    )
    if with_host:
        return gd, host
    return gd


def _expanding_shell_intersection(px, py, pz, dx, dy, dz, tstart, radius_t, inner: bool,
                                  speed=CLIGHT_PROP):
    """Closest forward distance to a shell (or, with the z parts zero, a
    circle) of radius ``radius_t`` at ``tstart`` expanding homologously; -1
    where there is no valid intersection (reference: grid.cc:1222-1312).
    (dx, dy, dz) is a unit vector and ``speed`` the packet's speed along it:
    c for a sphere, the xy-plane speed for a cylinder. The radial-velocity
    test compares squares rescaled by an exact 2^-33, so float32 neither
    overflows nor underflows there; in float32 a root within 2e-6 of the
    radius is dropped, which keeps a packet from re-intersecting the shell it
    has just crossed."""
    kgeo = 2.0 ** -33
    pos2 = px * px + py * py + pz * pz
    pdotd = px * dx + py * dy + pz * dz
    st_k = (speed * kgeo) * tstart
    a = 1.0 - (radius_t / tstart / speed) ** 2
    b = 2.0 * (pdotd - radius_t ** 2 / tstart / speed)
    c = pos2 - radius_t ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / a
    d1 = (-b + sq) * inv2a
    d2 = (-b - sq) * inv2a
    rk = radius_t * kgeo

    def vr_gt(d):
        fx = px + d * dx
        fy = py + d * dy
        fz = pz + d * dz
        r2k = torch.clamp(fx * fx + fy * fy + fz * fz, min=1.0) * (kgeo * kgeo)
        dotf = (dx * fx + dy * fy + dz * fz) * kgeo
        return dotf, (dotf * dotf) * (st_k * st_k), (rk * rk) * r2k

    dotf1, a21, b21 = vr_gt(d1)
    dotf2, a22, b22 = vr_gt(d2)
    if inner:
        bad1 = (dotf1 > 0) & (a21 > b21)
        bad2 = (dotf2 > 0) & (a22 > b22)
    else:
        bad1 = (dotf1 <= 0) | (a21 < b21)
        bad2 = (dotf2 <= 0) | (a22 < b22)
    eps = 2e-6 * radius_t if px.dtype == torch.float32 else 0.0
    neg = torch.full_like(d1, -1.0)
    d1 = torch.where(bad1 | (d1 < eps), neg, d1)
    d2 = torch.where(bad2 | (d2 < eps), neg, d2)
    both_neg = (d1 < 0) & (d2 < 0)
    dmin = torch.where((d1 >= 0) & ((d2 < 0) | (d1 <= d2)), d1, d2)
    res = torch.where(both_neg, neg, dmin)
    return torch.where(disc > 0, res, neg)


def _plane_crossing(posd, veld, tstart, coordbound, tmin):
    """Distance to a homologously expanding plane at ``coordbound`` (at
    tmin) (reference: grid.cc:2448-2597); a zero denominator (a packet
    moving with the plane, which never reaches it) is guarded."""
    denom = coordbound - veld * tmin
    denom = torch.where(denom != 0, denom, torch.full_like(denom, 1e-30))
    return CLIGHT_PROP * ((posd - veld * tstart) / denom * tmin - tstart)


def cell_boundary(grid_type, ncoord, pos_min, pos_max, cell, pos, dirv, tstart, tmin: float,
                  max_path_step: float):
    """Distance to the boundary of each packet's cell and the next cell
    index, in any float dtype: the one geometry of the crossing kernel's
    plain version and of ``boundary_distance``.

    ``pos`` and ``dirv`` are (x, y, z) tuples of (N,) tensors, (dirv a unit
    vector); ``pos_min`` / ``pos_max`` the (N, ndim) bounds of each packet's
    cell at ``tmin``; ``ncoord`` the grid's cells per axis. snext == -99
    where the packet leaves the grid; snext == cell with the distance
    ``max_path_step`` where the step is capped (reference:
    grid.cc:2349-2597)."""
    grid_type = GridType(grid_type)
    px, py, pz = pos
    dx, dy, dz = dirv
    big = torch.full_like(px, torch.finfo(px.dtype).max)
    neg = torch.full_like(px, -1.0)
    esc = torch.full_like(cell, BOUNDARY_ESCAPE)
    if grid_type == GridType.SPHERICAL1D:
        d_max = _expanding_shell_intersection(px, py, pz, dx, dy, dz, tstart,
                                              pos_max[:, 0] * tstart / tmin, False)
        distance = torch.where(d_max >= 0, d_max, big)
        snext = torch.where(d_max >= 0, torch.where(cell == ncoord[0] - 1, esc, cell + 1),
                            torch.full_like(cell, -1))
        r_inner = pos_min[:, 0] * tstart / tmin
        d_min = torch.where(r_inner > 0,
                            _expanding_shell_intersection(px, py, pz, dx, dy, dz, tstart,
                                                          r_inner, True), neg)
        take_min = (d_min >= 0) & (d_min < distance)
        distance = torch.where(take_min, d_min, distance)
        snext = torch.where(take_min, torch.where(cell == 0, esc, cell - 1), snext)
    elif grid_type == GridType.CYLINDRICAL2D:
        # expanding circles in the xy plane for the rcyl bounds (the planar
        # distance over the direction's xy length), planes in z; a packet
        # moving (almost) along z meets no circle
        n0, n1 = ncoord[0], ncoord[1]
        i_r, i_z = cell % n0, cell // n0
        dirxylen = torch.sqrt(dx * dx + dy * dy)
        has_xy = dirxylen > 1e-8
        sdl = torch.clamp(dirxylen, min=1e-8)
        dxn, dyn = dx / sdl, dy / sdl
        xyspeed = sdl * CLIGHT_PROP
        zero = torch.zeros_like(px)
        distance, snext = big, torch.full_like(cell, -1)
        d_rc = _expanding_shell_intersection(px, py, zero, dxn, dyn, zero, tstart,
                                             pos_max[:, 0] * tstart / tmin, False,
                                             speed=xyspeed)
        d_out = d_rc / sdl
        ok = has_xy & (d_rc >= 0) & (d_out > 0) & (d_out < distance)
        distance = torch.where(ok, d_out, distance)
        snext = torch.where(ok, torch.where(i_r == n0 - 1, esc, cell + 1), snext)
        r_inner = pos_min[:, 0] * tstart / tmin
        d_rc = torch.where(r_inner > 0,
                           _expanding_shell_intersection(px, py, zero, dxn, dyn, zero, tstart,
                                                         r_inner, True, speed=xyspeed), neg)
        d_in = d_rc / sdl
        ok = has_xy & (d_rc >= 0) & (d_in < distance)
        distance = torch.where(ok, d_in, distance)
        snext = torch.where(ok, torch.where(i_r == 0, esc, cell - 1), snext)
        velz = dz * CLIGHT_PROP
        up = (velz * tstart) > pz
        d_z = _plane_crossing(pz, velz, tstart, torch.where(up, pos_max[:, 1], pos_min[:, 1]),
                              tmin)
        ok = (d_z >= 0) & (d_z < distance)
        at_edge = torch.where(up, i_z == n1 - 1, i_z == 0)
        distance = torch.where(ok, d_z, distance)
        snext = torch.where(ok, torch.where(at_edge, esc, cell + torch.where(up, n0, -n0)),
                            snext)
    elif grid_type == GridType.CARTESIAN3D:
        nx, ny, nz = ncoord
        coords = (cell % nx, (cell // nx) % ny, cell // (nx * ny))
        distance, snext = big, torch.full_like(cell, -1)
        for ax, (posd, dird, inc, nax) in enumerate(((px, dx, 1, nx), (py, dy, nx, ny),
                                                     (pz, dz, nx * ny, nz))):
            veld = dird * CLIGHT_PROP
            up = (veld * tstart) > posd
            d_bound = _plane_crossing(posd, veld, tstart,
                                      torch.where(up, pos_max[:, ax], pos_min[:, ax]), tmin)
            ok = (d_bound >= 0) & (d_bound < distance)
            at_edge = torch.where(up, coords[ax] == nax - 1, coords[ax] == 0)
            distance = torch.where(ok, d_bound, distance)
            snext = torch.where(ok, torch.where(at_edge, esc, cell + torch.where(up, inc, -inc)),
                                snext)
    else:
        raise ValueError(grid_type)

    # cap step length; stay in the same cell (reference: grid.cc:2592-2594)
    capped = distance > max_path_step
    distance = torch.where(capped, torch.full_like(distance, max_path_step), distance)
    snext = torch.where(capped, cell, snext)
    return distance, snext


def boundary_distance(grid: GridData, dirvec, pos, tstart, cellindex):
    """Distance to the current cell's boundary and the next cell index
    (``cell_boundary`` on the grid's cell bounds), vectorised over (N, 3)
    packet positions and unit directions."""
    dt = pos.dtype
    return cell_boundary(grid.grid_type, grid.ncoordgrid, grid.cell_pos_min.to(dt)[cellindex],
                         grid.cell_pos_max.to(dt)[cellindex], cellindex, pos.unbind(-1),
                         dirvec.unbind(-1), tstart, grid.tmin, grid.max_path_step)


def get_cellindex_from_pos(grid: GridData, pos, time):
    """Propagation cell containing an xyz position (reference:
    grid.cc:2332-2346)."""
    if grid.grid_type == GridType.CARTESIAN3D:
        nx = grid.ncoordgrid[0]
        ii = ((pos / time[..., None] + grid.vmax) / (2 * grid.vmax) * nx).to(torch.int64)
        ii = torch.clamp(ii, 0, nx - 1)
        return ii[..., 0] + nx * ii[..., 1] + nx * nx * ii[..., 2]
    if grid.grid_type == GridType.CYLINDRICAL2D:
        n0, n1 = grid.ncoordgrid[0], grid.ncoordgrid[1]
        rcyl = torch.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2)
        i_r = torch.clamp((rcyl / time / grid.vmax * n0).to(torch.int64), 0, n0 - 1)
        i_z = torch.clamp(((pos[..., 2] / time + grid.vmax) / (2 * grid.vmax) * n1)
                          .to(torch.int64), 0, n1 - 1)
        return i_z * n0 + i_r
    # SPHERICAL1D: non-uniform shells
    r = torch.sqrt(torch.sum(pos * pos, dim=-1))
    v = (r / time).to(torch.float64)
    idx = torch.searchsorted(grid.vout_model.to(v.device), v, side="left")
    return torch.clamp(idx, 0, grid.ngrid - 1)


def get_cell_volume_tmin(grid: GridData, host=None) -> np.ndarray:
    """Propagation-cell volumes at tmin, (ngrid,), host float64 (reference:
    grid.cc:1358-1366)."""
    if grid.grid_type == GridType.CARTESIAN3D:
        wid = 2.0 * float(grid.rmax) / grid.ncoordgrid[0]
        return np.full((grid.ngrid,), wid**3)
    if host is not None:
        pos_min, pos_max = host.cell_pos_min, host.cell_pos_max
    else:
        pos_min = grid.cell_pos_min.double().cpu().numpy()
        pos_max = grid.cell_pos_max.double().cpu().numpy()
    if grid.grid_type == GridType.CYLINDRICAL2D:
        dz = pos_max[:, 1] - pos_min[:, 1]
        return dz * PI * (pos_max[:, 0] ** 2 - pos_min[:, 0] ** 2)
    return 4.0 / 3.0 * PI * (pos_max[:, 0] ** 3 - pos_min[:, 0] ** 3)

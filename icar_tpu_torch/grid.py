"""Copy of icar_tpu/grid.py, kept identical by tests/test_torch_setup.py.

Grid decomposition math and terrain-following vertical coordinate.

Host-side (numpy) replacement for:
  * grid_t decomposition bookkeeping (src/objects/grid_obj.f90:39-222)
  * vertical coordinate setup: simple/Gal-Chen (domain_obj.f90:1200-1316 setup_simple_z)
    and SLEVE (domain_obj.f90:953-1198 setup_sleve, :1465+ split_topography)
  * staggered jacobians and dzdx/dzdy metric terms (domain_obj.f90:1356-1463)
  * grid-rotation angles (wind.f90:516-596 init_winds)

Array layout: 3D fields are (z, y, x); x is the fastest dimension.
The decomposition functions are pure index math usable for any rank without
communication (the property the reference's LUT distribution relies on,
grid_obj.f90:52-53) — in the TPU rebuild they are used to compute per-device
tile shapes for sharded IO and to validate mesh shardings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from . import constants as C
from .config import Options

# ---------------------------------------------------------------------------
# decomposition index math (grid_obj.f90)
# ---------------------------------------------------------------------------


def decompose_images(nimages: int, nx: int, ny: int, ratio: float = 1.0) -> Tuple[int, int]:
    """Factor ``nimages`` into (ximages, yimages) closest to the domain aspect
    ratio (domain_decomposition, grid_obj.f90:39-103)."""

    def cost(xsplit, ysplit):
        x = nx / xsplit
        y = ny / ysplit
        return abs(1 - y / (ratio * x)) if y > ratio * x else abs(1 - (ratio * x) / y)

    best = (1, nimages)
    best_cost = cost(1, nimages)
    for ysplit in range(nimages, 0, -1):
        if nimages % ysplit == 0:
            xsplit = nimages // ysplit
            cur = cost(xsplit, ysplit)
            if cur < best_cost:
                best_cost = cur
                best = (xsplit, ysplit)
    return best


def my_n(n_global: int, img: int, nimg: int) -> int:
    """Tile size along one dim for 0-based image index ``img``; the remainder
    cells are spread over the first images (my_n, grid_obj.f90:116-122)."""
    return n_global // nimg + (1 if img < n_global % nimg else 0)


def my_start(n_global: int, img: int, nimg: int) -> int:
    """0-based global start index of image ``img``'s tile
    (my_start, grid_obj.f90:128-138)."""
    base = n_global // nimg
    return img * base + min(img, n_global % nimg)


@dataclass(frozen=True)
class TileInfo:
    """WRF-style index triple-set for one image (set_grid_dimensions,
    grid_obj.f90:144-255), 0-based and exclusive-end.

    its/ite = tile owned by this image; ims/ime = memory incl. halo."""
    ximages: int
    yimages: int
    ximg: int
    yimg: int
    # global domain size
    nx: int
    ny: int
    nz: int
    halo: int
    # tile (owned) region, global coords [start, end)
    xts: int = 0
    xte: int = 0
    yts: int = 0
    yte: int = 0
    # memory region incl halo, global coords [start, end)
    xms: int = 0
    xme: int = 0
    yms: int = 0
    yme: int = 0


def tile_info(nimages: int, image: int, nx: int, ny: int, nz: int,
              halo: int = 1, ratio: float = 1.0,
              nx_extra: int = 0, ny_extra: int = 0) -> TileInfo:
    """Index bookkeeping for one image (0-based). ``nx_extra/ny_extra=1``
    give the staggered u/v grids an extra column/row on the last tile
    (grid_obj.f90:160-193)."""
    xim, yim = decompose_images(nimages, nx, ny, ratio)
    ximg = image % xim
    yimg = image // xim
    xn = my_n(nx, ximg, xim)
    yn = my_n(ny, yimg, yim)
    xs = my_start(nx, ximg, xim)
    ys = my_start(ny, yimg, yim)
    if nx_extra and ximg == xim - 1:
        xn += nx_extra
    if ny_extra and yimg == yim - 1:
        yn += ny_extra
    gx = nx + nx_extra
    gy = ny + ny_extra
    return TileInfo(
        ximages=xim, yimages=yim, ximg=ximg, yimg=yimg,
        nx=gx, ny=gy, nz=nz, halo=halo,
        xts=xs, xte=xs + xn, yts=ys, yte=ys + yn,
        xms=max(0, xs - halo), xme=min(gx, xs + xn + halo),
        yms=max(0, ys - halo), yme=min(gy, ys + yn + halo),
    )


# ---------------------------------------------------------------------------
# array helpers (array_utilities.f90)
# ---------------------------------------------------------------------------


def offset_x(a: np.ndarray) -> np.ndarray:
    """Stagger a (..., y, x) field to the u grid: midpoint average with linear
    extrapolation past the ends (array_offset_x_2d, array_utilities.f90:144-161)."""
    first = 1.5 * a[..., :1] - 0.5 * a[..., 1:2]
    mid = 0.5 * (a[..., :-1] + a[..., 1:])
    last = 1.5 * a[..., -1:] - 0.5 * a[..., -2:-1]
    return np.concatenate([first, mid, last], axis=-1)


def offset_y(a: np.ndarray) -> np.ndarray:
    """Stagger a (..., y, x) field to the v grid (array_offset_y_2d)."""
    first = 1.5 * a[..., :1, :] - 0.5 * a[..., 1:2, :]
    mid = 0.5 * (a[..., :-1, :] + a[..., 1:, :])
    last = 1.5 * a[..., -1:, :] - 0.5 * a[..., -2:-1, :]
    return np.concatenate([first, mid, last], axis=-2)


def smooth_array(a: np.ndarray, windowsize: int, cycles: int = 1) -> np.ndarray:
    """Separable (2w+1)-point box filter with replicate padding, matching the
    running-mean smoother (smooth_array_2d, array_utilities.f90:308-505)."""
    out = a.astype(np.float64, copy=True)
    # true mean of the replicate-padded (2w+1) window (the reference divides
    # by min(n, 2w+1), which over-weights when the window exceeds the dim)
    n_y = 2 * windowsize + 1
    n_x = 2 * windowsize + 1
    for _ in range(cycles):
        p = np.pad(out, windowsize, mode="edge")
        # smooth along y then x with fixed divisors (reference divides by the
        # full window size even at clamped edges because padding replicates)
        csum = np.cumsum(p, axis=0)
        ys = (csum[2 * windowsize:, :] -
              np.concatenate([np.zeros((1, p.shape[1])), csum[:-2 * windowsize - 1, :]], axis=0)) / n_y
        csum = np.cumsum(ys, axis=1)
        out = (csum[:, 2 * windowsize:] -
               np.concatenate([np.zeros((ys.shape[0], 1)), csum[:, :-2 * windowsize - 1]], axis=1)) / n_x
    return out.astype(a.dtype)


def find_flat_model_level(flat_z_height: float, nz: int, dz: np.ndarray) -> int:
    """Number of levels that follow the terrain (find_flat_model_level,
    domain_obj.f90:838-867). Returns a 1-based level count (== index of the
    last terrain-following level)."""
    if flat_z_height > nz:
        height = 0.0
        max_level = 1
        for j in range(nz):
            if height <= flat_z_height:
                height += dz[j]
                max_level = j + 1
        return max_level
    if flat_z_height <= 0:
        return int(nz + flat_z_height)
    return int(flat_z_height)


# ---------------------------------------------------------------------------
# vertical coordinate
# ---------------------------------------------------------------------------


@dataclass
class Geometry:
    """Static grid geometry passed to the jitted step (replaces the z/dz/
    jacobian/rotation members of domain_t, domain_h.f90:286-311)."""
    dx: float
    nz: int
    ny: int
    nx: int
    terrain: np.ndarray          # (ny, nx)
    lat: np.ndarray              # (ny, nx)
    lon: np.ndarray              # (ny, nx)
    dz_levels: np.ndarray        # (nz,)
    z: np.ndarray                # (nz, ny, nx) height of mass levels
    z_interface: np.ndarray      # (nz+1, ny, nx)
    dz_mass: np.ndarray          # (nz, ny, nx)
    dz_interface: np.ndarray     # (nz, ny, nx)
    jacobian: np.ndarray         # (nz, ny, nx)
    jacobian_u: np.ndarray       # (nz, ny, nx+1)
    jacobian_v: np.ndarray       # (nz, ny+1, nx)
    jacobian_w: np.ndarray       # (nz, ny, nx)
    dzdx: np.ndarray             # (nz, ny, nx+1)
    dzdy: np.ndarray             # (nz, ny+1, nx)
    advection_dz: np.ndarray     # (nz, ny, nx)
    zr_u: np.ndarray             # (nz, ny, nx+1) level compression on u grid
    zr_v: np.ndarray             # (nz, ny+1, nx)
    z_u: np.ndarray              # (nz, ny, nx+1) mass-level heights on u grid
    z_v: np.ndarray              # (nz, ny+1, nx)
    sintheta: np.ndarray         # (ny, nx)
    costheta: np.ndarray         # (ny, nx)
    smooth_height: float = 0.0
    h1: Optional[np.ndarray] = None   # SLEVE large-scale terrain
    h2: Optional[np.ndarray] = None   # SLEVE small-scale terrain

    def astype(self, dtype):
        import dataclasses
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.astype(dtype) if isinstance(v, np.ndarray) else v
        return Geometry(**kw)


def _simple_z(terrain, terrain_u, terrain_v, dz, opts: Options):
    """Gal-Chen / simple terrain-following levels (setup_simple_z,
    domain_obj.f90:1200-1316)."""
    nz = opts.domain.nz
    ny, nx = terrain.shape
    d = opts.domain

    if d.space_varying_dz:
        max_level = find_flat_model_level(d.flat_z_height, nz, dz)
        smooth_height = float(np.sum(dz[:max_level]))
        if float(terrain.max()) >= smooth_height:
            raise ValueError(
                f"terrain (max {terrain.max():.0f} m) reaches the flat-z "
                f"height ({smooth_height:.0f} m = sum of the first "
                f"{max_level} dz levels); the terrain-following jacobian "
                f"would be <= 0. Raise flat_z_height or deepen dz_levels.")
        jac0 = (smooth_height - terrain) / smooth_height
        zr_u0 = (smooth_height - terrain_u) / smooth_height
        zr_v0 = (smooth_height - terrain_v) / smooth_height
    else:
        max_level = nz
        smooth_height = float(np.sum(dz[:nz]))
        jac0 = np.ones_like(terrain)
        zr_u0 = np.ones_like(terrain_u)
        zr_v0 = np.ones_like(terrain_v)

    # jacobian is constant over terrain-following levels, 1 above
    jacobian = np.ones((nz, ny, nx), terrain.dtype)
    zr_u = np.ones((nz,) + terrain_u.shape, terrain.dtype)
    zr_v = np.ones((nz,) + terrain_v.shape, terrain.dtype)
    jacobian[:max_level] = jac0[None]
    zr_u[:max_level] = zr_u0[None]
    zr_v[:max_level] = zr_v0[None]

    dzc = dz[:, None, None]
    dz_interface = dzc * jacobian
    dz_mass = np.empty_like(dz_interface)
    dz_mass[0] = dz[0] / 2 * jacobian[0]
    dz_mass[1:] = dzc[1:] / 2 * jacobian[1:] + dzc[:-1] / 2 * jacobian[:-1]

    z_interface = np.empty((nz + 1, ny, nx), terrain.dtype)
    z_interface[0] = terrain
    np.cumsum(dz_interface, axis=0, out=z_interface[1:])
    z_interface[1:] += terrain[None]
    z = terrain[None] + np.cumsum(dz_mass, axis=0)

    dzu = dz[:, None, None]
    dzm_u = np.empty_like(zr_u)
    dzm_u[0] = dz[0] / 2 * zr_u[0]
    dzm_u[1:] = dzu[1:] / 2 * zr_u[1:] + dzu[:-1] / 2 * zr_u[:-1]
    z_u = terrain_u[None] + np.cumsum(dzm_u, axis=0)
    dzm_v = np.empty_like(zr_v)
    dzm_v[0] = dz[0] / 2 * zr_v[0]
    dzm_v[1:] = dzu[1:] / 2 * zr_v[1:] + dzu[:-1] / 2 * zr_v[:-1]
    z_v = terrain_v[None] + np.cumsum(dzm_v, axis=0)

    return (jacobian, dz_mass, dz_interface, z, z_interface, zr_u, zr_v,
            z_u, z_v, smooth_height, None, None)


def _sleve_z(terrain, terrain_u, terrain_v, dz, opts: Options):
    """SLEVE vertical coordinate (setup_sleve, domain_obj.f90:953-1198;
    Schar et al 2002 eqn 2 as generalized by Leuenberger et al 2009):
        z(Z) = Z + h1*sinh((H/s1)^n - (Z/s1)^n)/sinh((H/s1)^n)
                 + h2*sinh((H/s2)^n - (Z/s2)^n)/sinh((H/s2)^n)
    where h1/h2 are the large/small-scale terrain from split_topography."""
    d = opts.domain
    nz = d.nz
    ny, nx = terrain.shape

    # split_topography (domain_obj.f90:1465+): h1 = smoothed terrain, h2 = rest
    h1 = smooth_array(terrain, d.terrain_smooth_windowsize, d.terrain_smooth_cycles)
    h2 = terrain - h1
    h1_u = smooth_array(terrain_u, d.terrain_smooth_windowsize, d.terrain_smooth_cycles)
    h2_u = terrain_u - h1_u
    h1_v = smooth_array(terrain_v, d.terrain_smooth_windowsize, d.terrain_smooth_cycles)
    h2_v = terrain_v - h1_v

    max_level = find_flat_model_level(d.flat_z_height, nz, dz)
    H = float(np.sum(dz[:max_level]))
    s1 = H / d.decay_rate_l_topo
    s2 = H / d.decay_rate_s_topo
    n = d.sleve_n
    # dz scaled so the terrain-following part spans exactly [0, H]
    dz_scl = dz[:nz] * H / np.sum(dz[:max_level])

    def sleve(Z, hh1, hh2):
        t1 = np.sinh((H / s1) ** n - (Z / s1) ** n) / np.sinh((H / s1) ** n)
        t2 = np.sinh((H / s2) ** n - (Z / s2) ** n) / np.sinh((H / s2) ** n)
        return Z + hh1 * t1 + hh2 * t2

    # interface heights: Z levels are cumulative dz_scl
    Zi = np.concatenate([[0.0], np.cumsum(dz_scl)])
    z_interface = np.empty((nz + 1, ny, nx), terrain.dtype)
    dz_interface = np.empty((nz, ny, nx), terrain.dtype)
    z_interface[0] = terrain
    for k in range(1, nz + 1):
        if k <= max_level:
            if k == max_level:
                z_interface[k] = H
            else:
                z_interface[k] = sleve(Zi[k], h1, h2)
        else:
            z_interface[k] = z_interface[k - 1] + dz_scl[k - 1]
    dz_interface = np.diff(z_interface, axis=0)
    if np.any(dz_interface <= 0):
        raise ValueError("SLEVE transform not invertible: dz_interface <= 0; "
                         "reduce decay rates or increase flat_z_height")

    jacobian = dz_interface / dz_scl[:, None, None]
    dz_mass = np.empty_like(dz_interface)
    dz_mass[0] = dz_interface[0] / 2
    dz_mass[1:] = (dz_interface[:-1] + dz_interface[1:]) / 2
    z = terrain[None] + np.cumsum(dz_mass, axis=0)

    # u/v mass-level heights directly from the transform at Z = mid-levels
    Zm = Zi[:-1] + dz_scl / 2
    z_u = np.empty((nz,) + terrain_u.shape, terrain.dtype)
    z_v = np.empty((nz,) + terrain_v.shape, terrain.dtype)
    zr_u = np.ones_like(z_u)
    zr_v = np.ones_like(z_v)
    for k in range(nz):
        if k < max_level:
            z_u[k] = sleve(Zm[k], h1_u, h2_u)
            z_v[k] = sleve(Zm[k], h1_v, h2_v)
            if k == 0:
                zr_u[0] = (z_u[0] - terrain_u) / (dz_scl[0] / 2)
                zr_v[0] = (z_v[0] - terrain_v) / (dz_scl[0] / 2)
            else:
                zr_u[k] = (z_u[k] - z_u[k - 1]) / (dz_scl[k] / 2 + dz_scl[k - 1] / 2)
                zr_v[k] = (z_v[k] - z_v[k - 1]) / (dz_scl[k] / 2 + dz_scl[k - 1] / 2)
        else:
            z_u[k] = z_u[k - 1] + (dz[k] / 2 * zr_u[k] + dz[k - 1] / 2 * zr_u[k - 1])
            z_v[k] = z_v[k - 1] + (dz[k] / 2 * zr_v[k] + dz[k - 1] / 2 * zr_v[k - 1])

    return (jacobian, dz_mass, dz_interface, z, z_interface, zr_u, zr_v,
            z_u, z_v, H, h1, h2)


def compute_rotation(lat: np.ndarray, lon: np.ndarray):
    """Grid-relative rotation angles from lat/lon gradients along x
    (init_winds, wind.f90:553-584)."""
    ny, nx = lat.shape
    lat64 = lat.astype(np.float64)
    lon64 = lon.astype(np.float64)
    idx = np.arange(nx)
    start = np.maximum(0, idx - 2)
    end = np.minimum(nx - 1, idx + 2)
    dlat = lat64[:, end] - lat64[:, start]
    dlon = (lon64[:, end] - lon64[:, start]) * np.cos(C.DEG2RAD * lat64)
    dist = np.sqrt(dlat ** 2 + dlon ** 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        costheta = np.abs(dlon / dist)
        sintheta = -dlat / dist
    costheta = np.where(dist == 0, 1.0, costheta)
    sintheta = np.where(dist == 0, 0.0, sintheta)
    return sintheta.astype(lat.dtype), costheta.astype(lat.dtype)


def build_geometry(terrain: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                   opts: Options, dtype=np.float32) -> Geometry:
    """Build the full static grid geometry (initialize_core_variables,
    domain_obj.f90:1324-1463)."""
    d = opts.domain
    nz = d.nz
    ny, nx = terrain.shape
    terrain = terrain.astype(np.float64)
    dz = np.asarray(d.dz_levels[:nz], np.float64)

    terrain_u = offset_x(terrain)
    terrain_v = offset_y(terrain)

    setup = _sleve_z if d.sleve else _simple_z
    (jacobian, dz_mass, dz_interface, z, z_interface, zr_u, zr_v,
     z_u, z_v, smooth_height, h1, h2) = setup(terrain, terrain_u, terrain_v, dz, opts)

    # staggered jacobians: midpoint average, edge-replicated
    # (initialize_core_variables, domain_obj.f90:1372-1392)
    jacobian_u = np.concatenate([
        jacobian[:, :, :1],
        0.5 * (jacobian[:, :, 1:] + jacobian[:, :, :-1]),
        jacobian[:, :, -1:]], axis=2)
    jacobian_v = np.concatenate([
        jacobian[:, :1, :],
        0.5 * (jacobian[:, 1:, :] + jacobian[:, :-1, :]),
        jacobian[:, -1:, :]], axis=1)
    jacobian_w = np.concatenate([
        0.5 * (jacobian[:-1] + jacobian[1:]),
        jacobian[-1:]], axis=0)

    # dzdx/dzdy metric terms on staggered grids, zero at domain edges
    # (setup_dzdxy, domain_obj.f90:1417-1463)
    dzdx = np.zeros((nz, ny, nx + 1), np.float64)
    dzdx[:, :, 1:-1] = (z[:, :, 1:] - z[:, :, :-1]) / d.dx
    dzdy = np.zeros((nz, ny + 1, nx), np.float64)
    dzdy[:, 1:-1, :] = (z[:, 1:, :] - z[:, :-1, :]) / d.dx

    if d.fixed_dz_advection:
        advection_dz = np.broadcast_to(dz[:, None, None], (nz, ny, nx)).copy()
    else:
        advection_dz = dz_interface.copy()

    sintheta, costheta = compute_rotation(lat.astype(np.float64), lon.astype(np.float64))

    g = Geometry(
        dx=float(d.dx), nz=nz, ny=ny, nx=nx,
        terrain=terrain, lat=lat, lon=lon, dz_levels=dz,
        z=z, z_interface=z_interface, dz_mass=dz_mass,
        dz_interface=dz_interface, jacobian=jacobian,
        jacobian_u=jacobian_u, jacobian_v=jacobian_v, jacobian_w=jacobian_w,
        dzdx=dzdx, dzdy=dzdy, advection_dz=advection_dz,
        zr_u=zr_u, zr_v=zr_v, z_u=z_u, z_v=z_v,
        sintheta=sintheta, costheta=costheta,
        smooth_height=smooth_height, h1=h1, h2=h2,
    )
    return g.astype(dtype)

"""Horizontal and vertical interpolation look-up tables
(icar_tpu/forcing/interpolation.py).

The tables are built on the host with numpy and scipy, by copies of the
JAX package's functions (held to them by tests/test_torch_setup.py). A
table's indices and weights then move once to the model's device as
tensors (``to_device``: int64 indices), when the regridder is built, and
each forcing step applies them there as gathers (``geo_interp``,
``vinterp``) in the JAX package's order of operations: the four products
summed p = 0..3, and ``w1 * d1 + (1 - w1) * d2``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops.indexing import take_level
from ..ops.pointwise import cumsum, div


# ---------------------------------------------------------------------------
# horizontal geo interpolation
# ---------------------------------------------------------------------------


@dataclass
class GeoLUT:
    """4-point horizontal interpolation table: for each hi-res cell, flat
    indices into the (ny_lo*nx_lo) forcing grid and weights
    (geo_look_up_table, data_structures.f90:103-109); numpy on the host,
    tensors on a device after ``to_device``."""
    idx: np.ndarray      # (4, ny, nx) int32 flat indices
    w: np.ndarray        # (4, ny, nx) float32
    lo_shape: Tuple[int, int]


def _is_regular(lat2d, lon2d, tol=1e-4):
    """Copy of icar_tpu/forcing/interpolation.py.
    True when lat varies only along y and lon only along x."""
    return (np.abs(lat2d - lat2d[:, :1]).max() < tol
            and np.abs(lon2d - lon2d[:1, :]).max() < tol)


def _idw_lut(lo_lat, lo_lon, hi_lat_flat, hi_lon_flat):
    """Copy of icar_tpu/forcing/interpolation.py.
    4-nearest inverse-distance weights (idw_weights,
    geo_reader.f90:193-212) — used only as a fallback for target points
    outside the forcing grid's convex hull (where the reference hard-stops,
    find_surrounding geo_reader.f90:893-899; falling back instead is a
    deliberate robustness divergence)."""
    from scipy.spatial import cKDTree
    pts = np.column_stack([lo_lat.ravel(), lo_lon.ravel()])
    tree = cKDTree(pts)
    q = np.column_stack([hi_lat_flat, hi_lon_flat])
    dist, idx = tree.query(q, k=4)
    dist = np.maximum(dist, 1e-12)
    w = 1.0 / dist
    w = w / w.sum(axis=1, keepdims=True)
    return idx.T, w.T


def _tri_weights(yi, xi, y1, x1, y2, x2, y3, x3):
    """Copy of icar_tpu/forcing/interpolation.py.
    Vectorized barycentric weights on the triangle (p1, p2, p3)
    (tri_weights, geo_reader.f90:113-178). Returns (w1, w2, w3, denom);
    degenerate triangles get denom == 0."""
    denom = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3)
    safe = np.where(denom == 0, 1.0, denom)
    w1 = ((y2 - y3) * (xi - x3) + (x3 - x2) * (yi - y3)) / safe
    w2 = ((y3 - y1) * (xi - x3) + (x1 - x3) * (yi - y3)) / safe
    w3 = 1.0 - w1 - w2
    return w1, w2, w3, denom


def _curvilinear_quad_lut(lo_lat, lo_lon, hi_lat_flat, hi_lon_flat):
    """Copy of icar_tpu/forcing/interpolation.py.
    Enclosing-quad triangulation weights for curvilinear forcing grids
    (find_location + find_surrounding + tri_weights + geo_interp,
    geo_reader.f90:293-489, 793-901, 113-178, 1069-1139), fully vectorized
    over target points:

    1. nearest forcing point per target (the reference's walking search +
       local minimum scan finds the same Euclidean-degree-space nearest
       point; a KD-tree finds it exactly),
    2. of the four quadrant boxes around it, the first (in the reference's
       (dx,dy) = (-1,-1),(-1,1),(1,-1),(1,1) order) whose corner-triangle
       fan contains the target,
    3. barycentric weights on the triangle (corner1, corner2, centroid),
       tried in the reference's preference order (find_surrounding
       geo_reader.f90:816-860),
    4. folded into 4-point form: the reference applies
       w1*f1 + w2*f2 + w3*mean(f1..f4) (geo_interp, geo_reader.f90:1110-1124),
       which equals the weight vector [w1+w3/4, w2+w3/4, w3/4, w3/4].

    Returns (idx (4, N), w (4, N), resolved (N,) bool)."""
    ny_lo, nx_lo = lo_lat.shape
    from scipy.spatial import cKDTree
    tree = cKDTree(np.column_stack([lo_lat.ravel(), lo_lon.ravel()]))
    _, nearest = tree.query(np.column_stack([hi_lat_flat, hi_lon_flat]), k=1)
    yc = nearest // nx_lo
    xc = nearest % nx_lo
    n = yc.shape[0]

    yi = np.asarray(hi_lat_flat, np.float64)
    xi = np.asarray(hi_lon_flat, np.float64)
    lat = np.asarray(lo_lat, np.float64)
    lon = np.asarray(lo_lon, np.float64)

    idx_out = np.zeros((4, n), np.int64)
    w_out = np.zeros((4, n), np.float64)
    resolved = np.zeros(n, bool)

    # two containment passes: strict first (the reference's point_in_poly
    # containment test, geo_reader.f90:714-791), then the loose -1e-2
    # barycentric tolerance tri_weights itself accepts for edge cases
    # (geo_reader.f90:147-157), whose slightly-negative weights are clipped
    for TOL in (-1e-7, -1e-2):
        idx_out, w_out, resolved = _quad_pass(
            lat, lon, yi, xi, yc, xc, ny_lo, nx_lo,
            idx_out, w_out, resolved, TOL)
    return idx_out, w_out, resolved


def _quad_pass(lat, lon, yi, xi, yc, xc, ny_lo, nx_lo,
               idx_out, w_out, resolved, TOL):
    """Copy of icar_tpu/forcing/interpolation.py: one containment pass
    of ``_curvilinear_quad_lut`` at the tolerance ``TOL``."""
    n = yc.shape[0]
    for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        y0 = np.clip(yc, 0 if dy > 0 else 1, ny_lo - (2 if dy > 0 else 1))
        x0 = np.clip(xc, 0 if dx > 0 else 1, nx_lo - (2 if dx > 0 else 1))
        in_bounds = (y0 == yc) & (x0 == xc)
        y1g, x1g = y0, x0
        y2g, x2g = y0, x0 + dx          # x neighbor
        y3g, x3g = y0 + dy, x0          # y neighbor
        y4g, x4g = y0 + dy, x0 + dx     # diagonal
        corners_y = np.stack([lat[y1g, x1g], lat[y2g, x2g],
                              lat[y3g, x3g], lat[y4g, x4g]])
        corners_x = np.stack([lon[y1g, x1g], lon[y2g, x2g],
                              lon[y3g, x3g], lon[y4g, x4g]])
        cy = corners_y.mean(axis=0)
        cx = corners_x.mean(axis=0)
        # the reference's candidate triangles in preference order
        # (find_surrounding, geo_reader.f90:816-860): (p, x-nbr), (p, y-nbr),
        # then the edge-case fallbacks (y-nbr, diag), (x-nbr, diag) — each
        # with the 4-corner centroid as the third vertex
        cand = ((0, 1), (0, 2), (2, 3), (1, 3))
        corner_idx = np.stack([y1g * nx_lo + x1g, y2g * nx_lo + x2g,
                               y3g * nx_lo + x3g, y4g * nx_lo + x4g])
        for a, b in cand:
            w1, w2, w3, denom = _tri_weights(
                yi, xi, corners_y[a], corners_x[a],
                corners_y[b], corners_x[b], cy, cx)
            ok = (~resolved & in_bounds & (denom != 0)
                  & (w1 >= TOL) & (w2 >= TOL) & (w3 >= TOL))
            if not ok.any():
                continue
            # clip + renormalize exactly as tri_weights (geo_reader.f90:157-172)
            w1c = np.maximum(w1, 0.0)
            w2c = np.maximum(w2, 0.0)
            w3c = np.maximum(w3, 0.0)
            tot = w1c + w2c + w3c
            w1c, w2c, w3c = w1c / tot, w2c / tot, w3c / tot
            others = [p for p in range(4) if p not in (a, b)]
            full_w = np.zeros((4, n))
            full_w[a] = w1c + w3c / 4
            full_w[b] = w2c + w3c / 4
            full_w[others[0]] = w3c / 4
            full_w[others[1]] = w3c / 4
            idx_out = np.where(ok, corner_idx, idx_out)
            w_out = np.where(ok, full_w, w_out)
            resolved = resolved | ok
    return idx_out, w_out, resolved


def build_geo_lut(lo_lat, lo_lon, hi_lat, hi_lon) -> GeoLUT:
    """Copy of icar_tpu/forcing/interpolation.py.
    Build the 4-point weight table from forcing (lo) to model (hi) grid.

    Regular forcing grids get exact bilinear weights (geo_reader's
    bilin_weights path); curvilinear grids use the reference's
    enclosing-quad triangulation (geo_LUT, geo_reader.f90:903-980) with a
    4-nearest IDW fallback for points outside the forcing hull."""
    ny_lo, nx_lo = lo_lat.shape
    ny, nx = hi_lat.shape

    if _is_regular(lo_lat, lo_lon):
        lat1d = lo_lat[:, 0]
        lon1d = lo_lon[0, :]
        ysign = 1 if lat1d[-1] >= lat1d[0] else -1
        xs = np.searchsorted(lon1d, hi_lon.ravel()) - 1
        xs = np.clip(xs, 0, nx_lo - 2)
        ys = np.searchsorted(lat1d[::ysign], hi_lat.ravel()) - 1
        ys = np.clip(ys, 0, ny_lo - 2)
        if ysign < 0:
            ys = ny_lo - 2 - ys
        x0 = lon1d[xs]
        y0 = lat1d[ys]
        fx = np.clip((hi_lon.ravel() - x0) / (lon1d[xs + 1] - x0), 0.0, 1.0)
        fy = np.clip((hi_lat.ravel() - y0) / (lat1d[ys + 1] - y0), 0.0, 1.0)
        i00 = ys * nx_lo + xs
        idx = np.stack([i00, i00 + 1, i00 + nx_lo, i00 + nx_lo + 1])
        w = np.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                      fy * (1 - fx), fy * fx])
    else:
        hi_lat_f = hi_lat.ravel()
        hi_lon_f = hi_lon.ravel()
        idx, w, resolved = _curvilinear_quad_lut(lo_lat, lo_lon,
                                                 hi_lat_f, hi_lon_f)
        if not resolved.all():
            idw_idx, idw_w = _idw_lut(lo_lat, lo_lon, hi_lat_f, hi_lon_f)
            idx = np.where(resolved, idx, idw_idx)
            w = np.where(resolved, w, idw_w)
            n_fallback = int((~resolved).sum())
            import sys
            print(f"geo LUT: {n_fallback}/{resolved.size} model points fall "
                  "outside the forcing grid; using inverse-distance weights "
                  "there", file=sys.stderr)

    return GeoLUT(idx=idx.reshape(4, ny, nx).astype(np.int32),
                  w=w.reshape(4, ny, nx).astype(np.float32),
                  lo_shape=(ny_lo, nx_lo))


def geo_interp(data_lo: torch.Tensor, lut: GeoLUT) -> torch.Tensor:
    """Apply a device geo LUT (geo_interp/geo_interp2d,
    geo_reader.f90:1069-1204): data_lo (..., ny_lo, nx_lo) ->
    (..., ny_hi, nx_hi), any leading dims; the four weighted corners summed
    in order p = 0..3."""
    lead = data_lo.shape[:-2]
    flat = data_lo.reshape(lead + (-1,))
    ny, nx = lut.w.shape[-2:]
    out = None
    for p in range(4):
        term = torch.index_select(flat, -1, lut.idx[p]).reshape(
            lead + (ny, nx)) * lut.w[p]
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# vertical interpolation
# ---------------------------------------------------------------------------


@dataclass
class VertLUT:
    """Per-cell 2-point vertical interpolation (vert_look_up_table,
    data_structures.f90:114-120); numpy on the host, tensors on a device
    after ``to_device``."""
    k1: np.ndarray     # (nz_hi, ny, nx) int32
    k2: np.ndarray
    w1: np.ndarray     # (nz_hi, ny, nx) float32 (w2 = 1 - w1)


def build_vlut(hi_z: np.ndarray, lo_z: np.ndarray,
               extrapolate: bool = True) -> VertLUT:
    """Copy of icar_tpu/forcing/interpolation.py.
    Bracketing levels + weights to interpolate a field on ``lo_z`` levels
    to ``hi_z`` levels, per column (vLUT/vLUT_forcing, vinterp.f90:101-221).

    ``extrapolate``: linear extrapolation outside the source column
    (vLUT_forcing behavior); otherwise clamp with 0.5/0.5 weights (vLUT)."""
    nz_hi = hi_z.shape[0]
    nz_lo = lo_z.shape[0]
    # pos = number of lo levels strictly below the target
    pos = (lo_z[None, :, :, :] < hi_z[:, None, :, :]).sum(axis=1)

    inside = (pos >= 1) & (pos <= nz_lo - 1)
    below = pos < 1
    above = pos > nz_lo - 1

    k1 = np.clip(pos - 1, 0, nz_lo - 2)
    k2 = k1 + 1
    z1 = np.take_along_axis(np.broadcast_to(lo_z[None], (nz_hi,) + lo_z.shape),
                            k1[:, None], axis=1)[:, 0]
    z2 = np.take_along_axis(np.broadcast_to(lo_z[None], (nz_hi,) + lo_z.shape),
                            k2[:, None], axis=1)[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        w1 = (z2 - hi_z) / np.where(z2 == z1, 1.0, z2 - z1)

    if extrapolate:
        # out-of-range weights fall out of the same formula with the edge
        # bracketing pair (can exceed [0,1] -> linear extrapolation)
        pass
    else:
        w1 = np.where(below | above, 0.5, w1)
        k1 = np.where(below, 0, k1)
        k2 = np.where(below, 0, k2)
        k1 = np.where(above, nz_lo - 1, k1)
        k2 = np.where(above, nz_lo - 1, k2)

    return VertLUT(k1=k1.astype(np.int32), k2=k2.astype(np.int32),
                   w1=w1.astype(np.float32))


def vinterp(data_lo: torch.Tensor, lut: VertLUT) -> torch.Tensor:
    """Apply a device vertical LUT (vinterp, vinterp.f90:223-318):
    data_lo (nz_lo, ny, nx) -> (nz_hi, ny, nx)."""
    d1 = take_level(data_lo, lut.k1)
    d2 = take_level(data_lo, lut.k2)
    return lut.w1 * d1 + (1 - lut.w1) * d2


def to_device(lut, device):
    """A GeoLUT or VertLUT whose arrays are tensors on ``device``: the
    indices int64 (flat, (4, ny*nx), for a GeoLUT), the weights float32."""
    if isinstance(lut, GeoLUT):
        idx = torch.as_tensor(np.asarray(lut.idx, np.int64).reshape(4, -1),
                              device=device)
        return GeoLUT(idx=idx, w=torch.as_tensor(lut.w, device=device),
                      lo_shape=lut.lo_shape)
    return VertLUT(*(torch.as_tensor(np.asarray(a, t), device=device)
                     for a, t in ((lut.k1, np.int64), (lut.k2, np.int64),
                                  (lut.w1, np.float32))))


# ---------------------------------------------------------------------------
# wind smoothing during interpolation (domain_obj.f90:2709+)
# ---------------------------------------------------------------------------


def smooth_horizontal(a: torch.Tensor, n: int) -> torch.Tensor:
    """(2n+1)-point box smoothing over the last two dims with replicate
    padding -- applied to u/v during forcing interpolation
    (smooth_wind_distance, domain_obj.f90:2152-2154, 2709).
    ``ops/linear_winds._box_smooth_2d`` with one difference: the JAX
    driver runs this eagerly, so each pass divides by 2n + 1 as one IEEE
    division (``ops/pointwise.div``, on both devices), where the jitted
    wind update multiplies by the reciprocal. The cumulative sums take
    XLA's order (``ops/pointwise.cumsum``)."""
    if n <= 0:
        return a
    p = torch.nn.functional.pad(a[None], (n, n, n, n), mode="replicate")[0]
    cs = cumsum(p, -2)
    zero = torch.zeros_like(cs[..., :1, :])
    ys = div(cs[..., 2 * n:, :] - torch.cat([zero, cs[..., :-2 * n - 1, :]],
                                            dim=-2), 2 * n + 1)
    cs = cumsum(ys, -1)
    zero = torch.zeros_like(cs[..., :, :1])
    return div(cs[..., :, 2 * n:] - torch.cat([zero, cs[..., :, :-2 * n - 1]],
                                              dim=-1), 2 * n + 1)


# longitude coordinate systems (icar_constants.f90:328-331)
LON_MAINTAIN = 0
LON_PRIME_CENTERED = 1        # 0..360
LON_DATELINE_CENTERED = 2     # -180..180
LON_GUESS = 3


def standardize_longitudes(lon, system: int):
    """Copy of icar_tpu/forcing/interpolation.py.
    Convert a longitude array to the requested coordinate system
    (standardize_coordinates, geo_reader.f90:1242-1263). NOTE the
    reference's constant names are swapped relative to their behavior:
    kDATELINE_CENTERED maps into 0..360 and kPRIME_CENTERED into
    -180..180; the behavior (not the naming) is reproduced."""
    lon = np.asarray(lon, np.float64).copy()
    if system == LON_MAINTAIN:
        return lon
    if system == LON_DATELINE_CENTERED:
        lon[lon < 0] += 360.0
    elif system == LON_PRIME_CENTERED:
        lon[lon > 180] -= 360.0
    elif system == LON_GUESS:
        lon[lon > 180] -= 360.0
        if lon.min() < -150 or lon.max() > 150:
            lon[lon < 0] += 360.0
    else:
        raise ValueError(
            f"unknown longitude_system {system}; use 0 (maintain), "
            "1 (0..360), 2 (-180..180) or 3 (guess)")
    return lon

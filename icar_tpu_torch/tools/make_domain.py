"""Build an init-conditions (domain) file from a DEM.

The port's counterpart of tools/make_domain.py (the reference's
helpers/make_domain.py), with its arguments and outputs: reads a NetCDF
DEM (elevation + lat/lon, 1D or 2D; NetCDF-4 or CDF-1/2), optionally
subsets it to a lat/lon box, coarsens it by an integer factor, smooths
the terrain, derives a simple land mask, and writes the
`init_conditions_file` that ``python -m icar_tpu_torch`` reads (hgt_hi /
lat_hi / lon_hi, plus landmask): NetCDF-4 where h5py imports, CDF-2 where
it does not.

Usage:
    python -m icar_tpu_torch.tools.make_domain dem.nc -o domain.nc \
        --elev-var elevation --lat 38 42 --lon -109 -104 \
        --coarsen 3 --smooth 2
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def smooth2d(a: np.ndarray, passes: int) -> np.ndarray:
    """Copy of tools/make_domain.py smooth2d: simple 3x3 box smoothing,
    edge-preserving (smooth_array_2d,
    array_utilities.f90:308-505 equivalent)."""
    a = np.asarray(a, np.float64)
    for _ in range(passes):
        p = np.pad(a, 1, mode="edge")
        a = sum(p[i:i + a.shape[0], j:j + a.shape[1]]
                for i in range(3) for j in range(3)) / 9.0
    return a


def make_domain(dem_path, out_path, elev_var="elevation", lat_var="lat",
                lon_var="lon", lat_range=None, lon_range=None,
                coarsen=1, smooth=0, sea_level=0.5, verbose=True):
    """Copy of tools/make_domain.py make_domain: the domain file
    ``out_path`` from the DEM ``dem_path``; returns ``out_path``."""
    from icar_tpu_torch.io.netcdf import NCFile, write_vars

    with NCFile(dem_path) as f:
        elev = np.asarray(f.read(elev_var), np.float64)
        lat = np.asarray(f.read(lat_var), np.float64)
        lon = np.asarray(f.read(lon_var), np.float64)
    if elev.ndim == 3:
        elev = elev[0]
    if lat.ndim == 1:
        lon, lat = np.meshgrid(lon, lat)

    if lat_range:
        rows = (lat[:, 0] >= lat_range[0]) & (lat[:, 0] <= lat_range[1])
        elev, lat, lon = elev[rows], lat[rows], lon[rows]
    if lon_range:
        cols = (lon[0, :] >= lon_range[0]) & (lon[0, :] <= lon_range[1])
        elev, lat, lon = elev[:, cols], lat[:, cols], lon[:, cols]
    if elev.size == 0:
        raise ValueError("lat/lon subset selects no DEM cells")

    if coarsen > 1:
        ny, nx = elev.shape
        ny2, nx2 = ny // coarsen * coarsen, nx // coarsen * coarsen

        def block(a):
            return a[:ny2, :nx2].reshape(
                ny2 // coarsen, coarsen, nx2 // coarsen, coarsen
            ).mean(axis=(1, 3))
        elev, lat, lon = block(elev), block(lat), block(lon)

    # ICAR landmask convention: 1=land, 2=water (kLC_LAND/kLC_WATER)
    landmask = np.where(elev > sea_level, 1.0, 2.0).astype(np.float32)
    if smooth > 0:
        elev = smooth2d(elev, smooth)
    elev = np.maximum(elev, 0.0)

    write_vars(out_path, {
        "hgt_hi": (("y", "x"), elev.astype(np.float32),
                   {"units": "m", "standard_name": "surface_altitude"}),
        "lat_hi": (("y", "x"), lat.astype(np.float32),
                   {"units": "degrees_north"}),
        "lon_hi": (("y", "x"), lon.astype(np.float32),
                   {"units": "degrees_east"}),
        "landmask": (("y", "x"), landmask,
                     {"comment": "1=land 2=water (ICAR convention)"})},
        attrs={"title": "icar_tpu domain", "source_dem": os.path.basename(
            dem_path)})
    if verbose:
        ny, nx = elev.shape
        print(f"wrote {out_path}: {ny} x {nx}, elevation "
              f"{elev.min():.0f}..{elev.max():.0f} m, "
              f"{100 * (landmask == 1).mean():.0f}% land")
    return out_path


def main(argv=None):
    """Copy of tools/make_domain.py main: the command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dem")
    ap.add_argument("-o", "--output", default="icar_domain.nc")
    ap.add_argument("--elev-var", default="elevation")
    ap.add_argument("--lat-var", default="lat")
    ap.add_argument("--lon-var", default="lon")
    ap.add_argument("--lat", nargs=2, type=float, default=None)
    ap.add_argument("--lon", nargs=2, type=float, default=None)
    ap.add_argument("--coarsen", type=int, default=1,
                    help="block-average by this integer factor")
    ap.add_argument("--smooth", type=int, default=0,
                    help="3x3 smoothing passes on the terrain")
    ap.add_argument("--sea-level", type=float, default=0.5,
                    help="elevation below this is water in the landmask")
    args = ap.parse_args(argv)
    make_domain(args.dem, args.output, elev_var=args.elev_var,
                lat_var=args.lat_var, lon_var=args.lon_var,
                lat_range=args.lat, lon_range=args.lon,
                coarsen=args.coarsen, smooth=args.smooth,
                sea_level=args.sea_level)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Copy of icar_tpu/forcing/ideal.py, kept identical by tests/test_torch_setup.py.

Idealized test-case generation (terrain + atmospheric profiles).

Host-side port of the reference's ideal-case tooling
(helpers/genNetCDF/Topography.py, Forcing.py and
tests/gen_ideal_test.py): cosine hills, the Schar 2002 advection-test ridge,
the Weisman-Klemp theta profile, and hydrostatic pressure — everything needed
to initialize and force a run without real data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C

# ---------------------------------------------------------------------------
# terrain (Topography.py:143-212)
# ---------------------------------------------------------------------------


def hill_topography(nx: int, ny: int, hill_height: float) -> np.ndarray:
    """Single broad cosine hill (genHill)."""
    i = (np.arange(nx) - nx / 2) / nx * np.pi * 2
    j = (np.arange(ny) - ny / 2) / ny * np.pi * 2
    ig, jg = np.meshgrid(i, j)
    return ((np.cos(ig) + 1) * (np.cos(jg) + 1)) / 4 * hill_height


def n_hills_topography(nx: int, ny: int, hill_height: float, n_hills: float) -> np.ndarray:
    """A range of cosine hills under a Gaussian envelope (gen_n_Hills)."""
    i = (np.arange(nx) - nx / 2) / nx * np.pi * 2
    j = (np.arange(ny) - ny / 2) / ny * np.pi * 2
    ig, jg = np.meshgrid(i, j)
    c = 0.15
    sigma = n_hills ** 2
    return (np.cos(ig / c) ** 2 * np.exp(-((ig / c) ** 2) / sigma)
            * np.cos(jg / c) ** 2 * np.exp(-((jg / c) ** 2) / sigma)) * hill_height


def schaer_topography(nx: int, ny: int, hill_height: float, dx: float,
                      lmbda: float = 8000.0, a: float = 25000.0) -> np.ndarray:
    """The Schar et al 2002 advection-test ridge (gen_adv_test_topo):
    h(x) = h0 * cos^2(pi x / lambda) * cos^2(pi x / (2a)), zero for |x| > a."""
    i = (np.arange(nx) - nx / 2) * dx
    ig = np.broadcast_to(i, (ny, nx)).copy()
    hgt = hill_height * np.cos(np.pi * ig / lmbda) ** 2 \
        * np.cos(np.pi * ig / (2 * a)) ** 2
    hgt[:, np.abs(i) > a] = 0.0
    return hgt


def ideal_latlon(nx: int, ny: int, dx: float, lat0=39.5, lon0=-105.0):
    """Regular lat/lon grid centered on (lat0, lon0) (Topography.py:50-57)."""
    mper = 111111.0
    lon = lon0 + (np.arange(nx) - nx / 2) * dx / mper / np.cos(np.radians(lat0))
    lat = lat0 + (np.arange(ny) - ny / 2) * dx / mper
    return np.meshgrid(lon, lat)[1], np.meshgrid(lon, lat)[0]  # lat2d, lon2d


# ---------------------------------------------------------------------------
# atmospheric profiles (Forcing.py)
# ---------------------------------------------------------------------------


def weisman_klemp_theta(z: np.ndarray) -> np.ndarray:
    """Weisman & Klemp analytic sounding (calc_wk_theta, Forcing.py:337-351)."""
    z_tr, theta_0, theta_tr, t_tr, wk_cp = 12000.0, 300.0, 343.0, 213.0, 1000.0
    below = theta_0 + (theta_tr - theta_0) * (np.minimum(z, z_tr) / z_tr) ** 1.25
    above = theta_tr * np.exp((C.GRAVITY / (wk_cp * t_tr)) * (z - z_tr))
    return np.where(z <= z_tr, below, above)


def pressure_from_sea_level(z: np.ndarray, p0: float = 100000.0) -> np.ndarray:
    """Standard-atmosphere pressure (calc_pressure_from_sea, Forcing.py:368)."""
    return p0 * (1 - 2.25577e-5 * z) ** 5.25588


def constant_n2_theta(z: np.ndarray, theta0: float = 300.0,
                      n2: float = 1e-4) -> np.ndarray:
    """theta profile with constant Brunt-Vaisala frequency squared."""
    return theta0 * np.exp(n2 / C.GRAVITY * z)


@dataclass
class IdealCase:
    """An analytically-initialized model state on the hi-res grid, replacing
    the forcing-file ingest for idealized runs (test_caf_no_forcing.f90)."""
    u: np.ndarray          # (nz, ny, nx+1)
    v: np.ndarray          # (nz, ny+1, nx)
    theta: np.ndarray      # (nz, ny, nx)
    pressure: np.ndarray   # (nz, ny, nx)
    qv: np.ndarray         # (nz, ny, nx)


def make_ideal_case(geom, u_profile=10.0, v_profile=0.0, theta_profile="wk",
                    rh=None, qv_val: float = 0.001,
                    sea_level_pressure: float = 100000.0) -> IdealCase:
    """Build initial fields on the terrain-following grid.

    ``u_profile``/``v_profile`` may be scalars or (nz,) arrays (gen_ideal's
    ``u_test_val``); theta_profile is 'wk' (Weisman-Klemp), a scalar, or a
    callable z->theta; qv is constant unless ``rh`` is given."""
    nz, ny, nx = geom.nz, geom.ny, geom.nx
    z = np.asarray(geom.z, np.float64)

    def profile_to_3d(p, shape):
        p = np.asarray(p, np.float64)
        if p.ndim == 0:
            return np.full(shape, float(p))
        return np.broadcast_to(p[:, None, None], shape).copy()

    u = profile_to_3d(u_profile, (nz, ny, nx + 1)).astype(np.float32)
    v = profile_to_3d(v_profile, (nz, ny + 1, nx)).astype(np.float32)

    if theta_profile == "wk":
        theta = weisman_klemp_theta(z)
    elif callable(theta_profile):
        theta = theta_profile(z)
    else:
        theta = np.full((nz, ny, nx), float(theta_profile))

    pressure = pressure_from_sea_level(z, sea_level_pressure)

    if rh is not None:
        exner = (pressure / C.P0) ** C.ROVCP
        t = theta * exner
        a = np.where(t < 273.16, 21.8745584, 17.2693882)
        b = np.where(t < 273.16, 7.66, 35.86)
        e_s = 610.78 * np.exp(a * (t - 273.16) / (t - b))
        qv = rh * 0.6219907 * e_s / (pressure - e_s)
    else:
        qv = np.full((nz, ny, nx), qv_val)

    return IdealCase(u=u, v=v, theta=theta.astype(np.float32),
                     pressure=pressure.astype(np.float32),
                     qv=qv.astype(np.float32))


# ---------------------------------------------------------------------------
# ideal NetCDF file generation (gen_ideal_test.py / genNetCDF equivalents)
# ---------------------------------------------------------------------------


def write_ideal_files(out_dir: str, nx=60, ny=16, nz_lo=30, dx=1000.0,
                      hill_height=500.0, schaer=True, u_profile=10.0,
                      qv_val=0.002, nt=4, dz_lo=500.0, buffer_cells=5,
                      lat0=39.5, lon0=-105.0):
    """Generate 'init.nc' (hi-res terrain/lat/lon) and 'forcing.nc'
    (nt steps of u, v, theta, qv, p, z on a coarser/larger grid), the
    TPU-native equivalent of helpers/genNetCDF Topography+Forcing driven by
    tests/gen_ideal_test.py. Returns (init_path, forcing_path)."""
    import os

    from ..io.netcdf import NCFile

    if schaer:
        terrain = schaer_topography(nx, ny, hill_height, dx)
    else:
        terrain = hill_topography(nx, ny, hill_height)
    lat, lon = ideal_latlon(nx, ny, dx, lat0, lon0)

    init_path = os.path.join(out_dir, "init.nc")
    with NCFile(init_path, "w") as f:
        f.create_var("hgt_hi", ("y", "x"), terrain.astype(np.float32))
        f.create_var("lat_hi", ("y", "x"), lat.astype(np.float32))
        f.create_var("lon_hi", ("y", "x"), lon.astype(np.float32))
        f.set_attrs({"TITLE": "icar_tpu ideal init", "DX": dx, "DY": dx})

    # forcing grid: slightly larger than the hi-res domain (gen_ideal adds
    # +10 cells), flat terrain, uniform dz
    nx_lo, ny_lo = nx + 10, ny + 10
    lat_f, lon_f = ideal_latlon(nx_lo, ny_lo, dx, lat0, lon0)
    z_1d = (np.arange(nz_lo) + 0.5) * dz_lo
    z = np.broadcast_to(z_1d[:, None, None], (nz_lo, ny_lo, nx_lo)).copy()
    theta = weisman_klemp_theta(z)
    p = pressure_from_sea_level(z)
    u_prof = np.asarray(u_profile, np.float64)
    if u_prof.ndim == 0:
        u = np.full((nz_lo, ny_lo, nx_lo), float(u_prof))
    else:
        u = np.broadcast_to(u_prof[:nz_lo, None, None],
                            (nz_lo, ny_lo, nx_lo)).copy()
    v = np.zeros_like(u)
    qv = np.full_like(u, qv_val)

    def times(a):
        return np.broadcast_to(a[None], (nt,) + a.shape).astype(np.float32)

    forcing_path = os.path.join(out_dir, "forcing.nc")
    with NCFile(forcing_path, "w") as f:
        dims4 = ("time", "level", "y", "x")
        f.create_var("u", dims4, times(u))
        f.create_var("v", dims4, times(v))
        f.create_var("theta", dims4, times(theta))
        f.create_var("qv", dims4, times(qv))
        f.create_var("p", dims4, times(p))
        f.create_var("z", dims4, times(z))
        f.create_var("lat", ("y", "x"), lat_f.astype(np.float32))
        f.create_var("lon", ("y", "x"), lon_f.astype(np.float32))
        f.create_var("hgt", ("y", "x"),
                     np.zeros((ny_lo, nx_lo), np.float32))
        f.set_attrs({"TITLE": "icar_tpu ideal forcing"})
    return init_path, forcing_path

"""The port's forcing ingest and regridding (icar_tpu_torch/forcing) against
the JAX package's, on the CPU.

Two forcing datasets on one small model domain (the port's
``write_ideal_files``, which the JAX package reads too):
- the ideal files themselves: a regular lat/lon grid, constant in time;
- a curvilinear one: the forcing grid rotated by 20 degrees about the
  domain's centre, its heights rising by 40 m a step (``time_varying_z``)
  and its winds, theta and humidity changing from step to step.
Both packages read each step, build their tables and regrid
(``Regridder.to_model_grid``); the tables must be equal, the regridded
fields equal up to the pressure's exp and pow (rtol 2e-6 there), and the
tendencies equal. The external-conditions reader likewise.
"""

import numpy as np
import pytest
import torch

import icar_tpu.config as jconfig
import icar_tpu.forcing.boundary as jb
import icar_tpu.grid as jgrid
import icar_tpu_torch.config as tconfig
import icar_tpu_torch.forcing.boundary as tb
import icar_tpu_torch.grid as tgrid
from icar_tpu.io.netcdf import NCFile as JaxNCFile
from icar_tpu_torch.convert import geometry_to_torch
from icar_tpu_torch.forcing.ideal import (ideal_latlon, pressure_from_sea_level,
                                          weisman_klemp_theta,
                                          write_ideal_files)
from icar_tpu_torch.io.netcdf import write_vars

torch.set_num_threads(1)

NX, NY, NZ_LO, DX = 40, 14, 20, 1000.0
STEPS = 3
# fields the regridding computes with exp and pow (the hydrostatic shift
# of the pressure): XLA's and torch's libraries may differ in an ulp
TRANSCENDENTAL = ("pressure",)


def _rotated_forcing(path, lat_hi, lon_hi):
    """A forcing file on a grid rotated by 20 degrees about the model
    domain's centre (spacing 0.9 of the model's, 10 cells of margin), with
    time-varying heights, winds, theta and humidity."""
    n = 70
    a = np.deg2rad(20.0)
    lat0, lon0 = float(lat_hi.mean()), float(lon_hi.mean())
    step = 0.9 * float(np.abs(np.diff(lat_hi[:, 0])).mean())
    s = (np.arange(n) - (n - 1) / 2) * step
    yy, xx = np.meshgrid(s, s, indexing="ij")
    lat = lat0 + yy * np.cos(a) - xx * np.sin(a)
    lon = lon0 + (yy * np.sin(a) + xx * np.cos(a)) / np.cos(np.deg2rad(lat0))
    z1 = (np.arange(NZ_LO) + 0.5) * 500.0
    rng = np.random.default_rng(11)
    shape = (STEPS, NZ_LO, n, n)
    z = np.empty(shape)
    for k in range(STEPS):
        z[k] = z1[:, None, None] + 40.0 * k + rng.uniform(-5, 5, (1, n, n))
    theta = weisman_klemp_theta(z) + rng.uniform(-0.5, 0.5, shape)
    p = pressure_from_sea_level(z)
    u = 8.0 + 2.0 * np.arange(STEPS)[:, None, None, None] \
        + rng.uniform(-1, 1, shape)
    v = rng.uniform(-2, 2, shape)
    qv = 0.004 + rng.uniform(-1e-3, 1e-3, shape)
    dims = ("time", "level", "y", "x")
    f32 = lambda x: x.astype(np.float32)
    write_vars(path, {"u": (dims, f32(u)), "v": (dims, f32(v)),
                      "theta": (dims, f32(theta)), "qv": (dims, f32(qv)),
                      "p": (dims, f32(p)), "z": (dims, f32(z)),
                      "lat": (("y", "x"), f32(lat)),
                      "lon": (("y", "x"), f32(lon)),
                      "hgt": (("y", "x"), np.zeros((n, n), np.float32))})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("forcing")
    init, regular = write_ideal_files(str(tmp), nx=NX, ny=NY, nz_lo=NZ_LO,
                                      dx=DX, hill_height=400.0, u_profile=8.0,
                                      qv_val=0.004, nt=STEPS)
    with JaxNCFile(init) as f:
        lat, lon = f.read("lat_hi"), f.read("lon_hi")
    rotated = str(tmp / "rotated.nc")
    _rotated_forcing(rotated, lat, lon)
    return init, {"regular": regular, "rotated": rotated}


def _options(cfg, init, forcing, varying):
    o = cfg.Options()
    o.forcing.init_conditions_file = init
    o.forcing.boundary_files = [forcing]
    o.forcing.input_interval = 1800.0
    o.forcing.time_varying_z = varying
    o.domain.dx = DX
    o.domain.nz = 10
    o.domain.dz_levels = [50.0, 75, 125, 200, 300, 400] + [500.0] * 4
    o.domain.flat_z_height = -3
    return o


@pytest.fixture(scope="module", params=["regular", "rotated"])
def regridded(request, files):
    """Both packages' forcing readers, regridders and targets of every
    step (the rotated case with time-varying heights)."""
    init, forcing = files
    varying = request.param == "rotated"
    with JaxNCFile(init) as f:
        terrain = f.read("hgt_hi").astype(np.float64)
        lat = f.read("lat_hi").astype(np.float64)
        lon = f.read("lon_hi").astype(np.float64)
    out = {}
    for pkg, cfg, grid, bnd in (("jax", jconfig, jgrid, jb),
                                ("torch", tconfig, tgrid, tb)):
        o = _options(cfg, init, forcing[request.param], varying)
        o.domain.ny, o.domain.nx = terrain.shape
        o.validate()
        geom = grid.build_geometry(terrain, lat, lon, o)
        fd = bnd.ForcingData(o)
        raws = [fd.read_step(k) for k in range(STEPS)]
        kw = {} if pkg == "jax" else {"device": "cpu"}
        rg = bnd.Regridder.build(geom, fd.lat, fd.lon, raws[0].get("z"), o,
                                 f_stag=fd.stagger_coords, **kw)
        g = geom if pkg == "jax" else geometry_to_torch(geom, "cpu")
        targets = [rg.to_model_grid(r, g) for r in raws]
        out[pkg] = dict(options=o, geom=geom, raws=raws, rg=rg,
                        targets=targets)
    return request.param, out


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def test_forcing_reads_equal(regridded):
    _, r = regridded
    for rj, rt in zip(r["jax"]["raws"], r["torch"]["raws"]):
        assert sorted(rj) == sorted(rt)
        for k in rj:
            np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)


def test_tables_equal(regridded):
    """The geo tables (flat indices, weights) and the vertical tables of
    the last step (rebuilt each step with time-varying heights) are the
    JAX package's, bit for bit."""
    case, r = regridded
    rj, rt = r["jax"]["rg"], r["torch"]["rg"]
    assert rt.nsmooth == rj.nsmooth == 2
    assert rt.time_varying_z == (case == "rotated")
    for name in ("geo", "geo_u", "geo_v", "geo_u_mass", "geo_v_mass"):
        lj, lt = getattr(rj, name), getattr(rt, name)
        assert lt.idx.dtype == torch.int64
        np.testing.assert_array_equal(_np(lt.idx), lj.idx.reshape(4, -1))
        np.testing.assert_array_equal(_np(lt.w), lj.w)
    for name in ("vlut", "vlut_u", "vlut_v"):
        lj, lt = getattr(rj, name), getattr(rt, name)
        for f in ("k1", "k2", "w1"):
            np.testing.assert_array_equal(_np(getattr(lt, f)),
                                          getattr(lj, f), err_msg=name)
    if case == "rotated":
        # the weights of a rotated grid are no bilinear ones
        assert (rj.geo.w > 0).sum(axis=0).max() >= 3


def test_to_model_grid_matches(regridded):
    """Every target field of every step equals the JAX package's; the
    pressure within rtol 2e-6 (exp and pow)."""
    case, r = regridded
    for k, (tj, tt) in enumerate(zip(r["jax"]["targets"],
                                     r["torch"]["targets"])):
        assert sorted(tj) == sorted(tt)
        for name in tj:
            got, want = _np(tt[name]), np.asarray(tj[name])
            assert got.shape == want.shape and np.isfinite(got).all()
            if name in TRANSCENDENTAL:
                np.testing.assert_allclose(got, want, rtol=2e-6, atol=0,
                                           err_msg=f"{name} step {k}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name} step {k}")
    if case == "rotated":
        # the forcing moves from step to step
        u0, u2 = (_np(r["torch"]["targets"][k]["u"]) for k in (0, 2))
        assert np.abs(u2 - u0).mean() > 2.0


def test_tendencies_match(regridded):
    """(target - current) / interval: one IEEE division, as the eager JAX
    driver divides, bit for bit."""
    _, r = regridded
    rng = np.random.default_rng(4)
    tj, tt = r["jax"]["targets"][1], r["torch"]["targets"][1]
    current = {k: (np.asarray(v) * (1 + rng.uniform(-1e-3, 1e-3, v.shape))
                   ).astype(np.float32) for k, v in tj.items()}
    import jax.numpy as jnp
    want = jb.compute_tendencies({k: jnp.asarray(v)
                                  for k, v in current.items()}, tj, 1800.0)
    got = tb.compute_tendencies({k: torch.tensor(v)
                                 for k, v in current.items()}, tt, 1800.0)
    assert sorted(got) == sorted(want)
    for k in want:
        if k in TRANSCENDENTAL:
            # the targets' own ulps, divided by the interval
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_external_conditions_match(files, tmp_path):
    """SWE and skin temperature from a coarser external file, geo-regridded
    (init_external), equal in both packages."""
    init, _ = files
    lat, lon = ideal_latlon(30, 20, 2000.0)
    rng = np.random.default_rng(6)
    ext = str(tmp_path / "ext.nc")
    write_vars(ext, {"lat": (("y", "x"), lat.astype(np.float32)),
                     "lon": (("y", "x"), lon.astype(np.float32)),
                     "swe": (("y", "x"), rng.uniform(0, 50, (20, 30)).astype(
                         np.float32)),
                     "TSK": (("y", "x"), rng.uniform(260, 280, (20, 30))
                             .astype(np.float32))})
    with JaxNCFile(init) as f:
        terrain = f.read("hgt_hi").astype(np.float64)
        hlat = f.read("lat_hi").astype(np.float64)
        hlon = f.read("lon_hi").astype(np.float64)
    got = {}
    for pkg, cfg, grid, bnd in (("jax", jconfig, jgrid, jb),
                                ("torch", tconfig, tgrid, tb)):
        o = _options(cfg, init, init, False)
        o.forcing.external_files = ext
        o.domain.ny, o.domain.nx = terrain.shape
        geom = grid.build_geometry(terrain, hlat, hlon, o.validate())
        kw = {} if pkg == "jax" else {"device": "cpu"}
        got[pkg] = bnd.load_external_conditions(o, geom, **kw)
    assert sorted(got["torch"]) == sorted(got["jax"]) == [
        "skin_temperature", "swe"]
    for k, want in got["jax"].items():
        np.testing.assert_array_equal(got["torch"][k].numpy(),
                                      np.asarray(want), err_msg=k)

"""RRTMG shortwave (icar_tpu_torch/physics/rrtmg_sw.py) against the JAX
package's rrtmg_sw run op by op (``jax.disable_jit()``), on the seeded
columns of tests/test_torch_rrtmg_lw.py (troposphere and stratosphere,
cloudy and clear), with the synthetic SW k-tables of both packages (equal
array by array) and the JAX package's McICA draws (``JaxCdf``): columns
with the sun below the horizon (cosz <= 0) among them, and the driver's
direct/diffuse split. Floats are held to relative bounds stated per test
(the port's products with float32 reciprocals where the op-by-op JAX run
divides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import rrtmg_lw as jlw
from icar_tpu.physics import rrtmg_sw as jsw
from icar_tpu.physics import rrtmg_sw_tables as jswt
from icar_tpu_torch.physics import rrtmg_lw as tlw
from icar_tpu_torch.physics import rrtmg_sw as tsw
from icar_tpu_torch.physics import rrtmg_sw_tables as tswt
from test_torch_rrtmg_lw import (JaxCdf, columns, fields3d, jx,
                                 _namespace_to_torch, rel, tt)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    """The synthetic SW k-tables (bench.py's seed 1) of each package."""
    return jswt.synthetic_sw_tables(), tlw.device_tables(
        tswt.synthetic_sw_tables(), "cpu")


def test_synthetic_tables_are_identical():
    """The port's copy of rrtmg_sw_tables gives the JAX package's
    synthetic tables entry by entry, bit for bit."""
    want, got = jswt.synthetic_sw_tables(), tswt.synthetic_sw_tables()
    assert len(got) == len(want) == 14
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _profile(c):
    dpg = c["plev"][:-1] - c["plev"][1:]
    h2o = jx(c["h2ovmr"])
    coldry = jx(dpg) * 1e3 * jlw.AVOGAD / (
        1e2 * jlw.GRAV * jlw.AMD * (1.0 + h2o * jlw.AMW / jlw.AMD))
    wkl = jnp.stack([h2o * coldry, jlw.CO2VMR * coldry,
                     jx(c["o3vmr"]) * coldry, jlw.N2OVMR * coldry,
                     jnp.zeros_like(coldry), jlw.CH4VMR * coldry,
                     jlw.O2VMR * coldry])
    return coldry, wkl


@pytest.fixture(scope="module")
def setcoef_pair():
    c = columns(seed=10)
    coldry, wkl = _profile(c)
    with jax.disable_jit():
        want = jsw.setcoef_sw(jx(c["play"]), jx(c["tlay"]), coldry, wkl)
    got = tsw.setcoef_sw(tt(c["play"]), tt(c["tlay"]), tt(coldry), tt(wkl))
    return want, got


def test_setcoef_sw_matches(setcoef_pair):
    """setcoef_sw: indices equal, floats within 1e-5 of their largest
    magnitude (the fac fractions after a reciprocal; observed 2.6e-6)."""
    want, got = setcoef_pair
    assert np.asarray(want.tropo).any() and not np.asarray(want.tropo).all()
    for k, w in vars(want).items():
        g = getattr(got, k)
        if np.asarray(w).dtype.kind in "ib":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)
        else:
            assert rel(g, w) <= 1e-5, k


@pytest.fixture(scope="module")
def taumol_pair(tables, setcoef_pair):
    jt, tt_ = tables
    cj, _ = setcoef_pair
    with jax.disable_jit():
        want = jsw.taumol_sw(jt, cj)
    got = tsw.taumol_sw(tt_, _namespace_to_torch(cj))
    return want, got


@pytest.mark.parametrize("band", range(16, 30))
def test_taumol_sw_band_matches(taumol_pair, band):
    """taumol_sw per band: gas and Rayleigh optical depths and the solar
    source of the band's g-points within 1e-5 of their largest magnitudes
    (observed bit for bit but band 22, 2.7e-8)."""
    want, got = taumol_pair
    b = band - 16
    lo, hi = int(tswt.NGS[b] - tswt.NGC[b]), int(tswt.NGS[b])
    for w, g in zip(want, got):
        assert rel(g[..., lo:hi], np.asarray(w)[..., lo:hi]) <= 1e-5


def test_cldprmc_sw_matches():
    """The in-cloud optical properties on McICA masks from one draw (ice,
    snow and liquid paths, radii across and beyond the tables): within
    1e-5 of their largest magnitudes (observed 1.9e-7)."""
    c = columns(seed=11)
    key = jax.random.PRNGKey(5)
    draw = jax.random.uniform(key, (10, 12, tswt.NGPTSW), jnp.float32)
    with jax.disable_jit():
        mj = jsw.mcica_subcol_sw(key, jx(c["cldfrac"]), jx(c["ciwp"]),
                                 jx(c["clwp"]), jx(c["cswp"]))
        want = jsw.cldprmc_sw(*mj, jx(c["rei"]), jx(c["rel"]),
                              jx(c["res"]))
    mt = tsw.mcica_subcol(tt(draw), tt(c["cldfrac"]), tt(c["ciwp"]),
                          tt(c["clwp"]), tt(c["cswp"]))
    for w, g in zip(mj, mt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tsw.cldprmc_sw(*mt, tt(c["rei"]), tt(c["rel"]), tt(c["res"]))
    assert np.asarray(want[0]).max() > 0
    for w, g in zip(want, got):
        assert rel(g, w) <= 1e-5


def _two_stream_inputs(seed):
    r = np.random.default_rng(seed)
    f = np.float32
    shape = (10, 12, 16)
    g = r.uniform(0, 0.95, shape).astype(f)
    g[0, 0, :4] = 1.0                     # the g == 1 guard
    w = r.uniform(0, 1, shape).astype(f)
    w[1, :, :8] = 1.0                     # conservative scattering
    tau = r.gamma(1.0, 2.0, shape).astype(f)
    tau[2, :, :3] = 300.0                 # thick: the exponent caps
    mu = r.uniform(0.05, 1, (1, 12, 1)).astype(f)
    active = r.uniform(size=shape) < 0.6
    return g, mu, tau, w, active


def test_reftra_sw_matches():
    """The two-stream layer reflectance/transmittance (conservative and
    not, g == 1, thick layers, inactive layers): within 1e-5 of their
    largest magnitudes (observed 8.2e-7)."""
    g, mu, tau, w, active = _two_stream_inputs(12)
    with jax.disable_jit():
        want = jsw.reftra_sw(jx(g), jx(mu), jx(tau), jx(w), jx(active))
    got = tsw.reftra_sw(tt(g), tt(mu), tt(tau), tt(w), tt(active))
    for a, b in zip(want, got):
        assert rel(b, a) <= 1e-5


def test_vrtqdr_sw_matches():
    """The vertical adding's two level loops against the JAX scans:
    within 1e-5 of the largest flux (observed bit for bit)."""
    r = np.random.default_rng(13)
    f = np.float32
    nlay, n, g = 10, 12, 16
    lay = lambda lo, hi: r.uniform(lo, hi, (nlay, n, g)).astype(f)
    lev = lambda lo, hi: r.uniform(lo, hi, (nlay + 1, n, g)).astype(f)
    args = (lay(0, 0.4), lay(0, 0.4), lay(0.5, 1), lay(0.5, 1), lev(0, 1),
            lev(0, 1), r.uniform(0.1, 0.3, (n, 1)).astype(f),
            r.uniform(0.1, 0.3, (n, 1)).astype(f))
    with jax.disable_jit():
        want = jsw.vrtqdr_sw(*[jx(a) for a in args])
    got = tsw.vrtqdr_sw(*[tt(a) for a in args])
    for a, b in zip(want, got):
        assert rel(b, a) <= 1e-5


@pytest.mark.parametrize("cloud", [True, False], ids=["cloudy", "clear"])
def test_rrtmg_sw_rad_matches(tables, cloud):
    """The whole SW column calculation with the JAX draw, the sun above
    the horizon in some columns and below (cosz <= 0) in others: fluxes
    within 1e-5 of their largest magnitudes, the heating rate within 1e-4
    (observed at most 2.8e-5, the heating rate of the clear columns)."""
    jt, tt_ = tables
    c = columns(seed=14, cloud=cloud)
    r = np.random.default_rng(15)
    cosz = r.uniform(-0.5, 1.0, 12).astype(np.float32)
    cosz[:3] = [-0.2, 0.0, 1e-3]
    alb = r.uniform(0.1, 0.4, 12).astype(np.float32)
    key = jax.random.PRNGKey(4)
    draw = jax.random.uniform(key, (10, 12, tswt.NGPTSW), jnp.float32)
    names = ("h2ovmr", "o3vmr", "cldfrac", "ciwp", "clwp", "cswp", "rei",
             "rel", "res")
    with jax.disable_jit():
        want = jsw.rrtmg_sw_rad(jt, jx(c["play"]), jx(c["plev"]),
                                jx(c["tlay"]), jx(cosz), jx(alb),
                                *[jx(c[k]) for k in names], key, 1366.0)
    got = tsw.rrtmg_sw_rad(tt_, tt(c["play"]), tt(c["plev"]),
                           tt(c["tlay"]), tt(cosz), tt(alb),
                           *[tt(c[k]) for k in names], tt(draw), 1366.0)
    for k in ("swdflx", "swuflx", "swdflxc", "swuflxc", "swddir"):
        assert rel(getattr(got, k), getattr(want, k)) <= 1e-5, k
    assert rel(got.swhr, want.swhr) <= 1e-4
    assert np.asarray(want.swdflx).max() > 100.0


def _driver_args(f, conv):
    return ([conv(f[k]) for k in ("p", "p8w", "t", "t8w", "cosz", "albedo",
                                  "qv", "qc", "qi", "qs", "cf", "re_c",
                                  "re_i", "re_s", "rho", "dz", "exner")])


@pytest.mark.parametrize("chunk", [None, 12], ids=["one_chunk", "chunked"])
def test_driver_matches_with_the_jax_draws(tables, chunk, monkeypatch):
    """rrtmg_sw_driver (the extra layer to the TOA, night columns masked,
    the direct/diffuse split) on cloudy fields at interval time 40 s with
    the JAX draws: 12 columns in one chunk, 15 in chunks of 12 (the
    chunked JAX driver's split keys; 12 columns, so that the op-by-op JAX
    run reuses compiled operations). The theta tendency within 1e-4 of
    its largest magnitude; swdown, gsw, swcf and the direct flux within
    1e-5 (observed at most 9.2e-6 over both, with the longwave driver's
    test); the night columns exactly 0 on both."""
    jt, tt_ = tables
    f = fields3d(nz=9, ny=3, nx=5 if chunk else 4, seed=16)
    if chunk:
        monkeypatch.setattr(jlw, "RRTMG_COL_CHUNK", chunk)
        monkeypatch.setattr(tlw, "RRTMG_COL_CHUNK", chunk)
    with jax.disable_jit():
        want = jsw.rrtmg_sw_driver(jt, JaxCdf.key("sw", 40.0),
                                   *_driver_args(f, jx),
                                   xland=jx(f["xland"]))
    cdf = JaxCdf()
    got = tsw.rrtmg_sw_driver(tt_, cdf, np.float32(40.0),
                              *_driver_args(f, tt), xland=tt(f["xland"]))
    assert [c[0] for c in cdf.calls] == ["sw"] * (2 if chunk else 1)
    assert rel(got[0], want[0]) <= 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert rel(g, w) <= 1e-5
    night = f["cosz"] <= 0
    assert night.any() and (~night).any()
    for g in got[1:]:
        assert (g.numpy()[night] == 0).all()
    swdir = got[4].numpy()
    assert (swdir <= got[1].numpy()).all() and swdir.max() > 0

"""RRTMG longwave (icar_tpu_torch/physics/rrtmg_lw.py) against the JAX
package's rrtmg_lw run op by op (``jax.disable_jit()``), on seeded
columns: ten layers from the surface to 50 hPa (troposphere and
stratosphere), cloudy and clear columns, the synthetic k-tables of both
packages (equal array by array).

The JAX package draws McICA's uniform numbers with ``jax.random``, which
torch cannot reproduce, so the port takes its draw from a source object:
here ``JaxCdf``, which returns exactly what the JAX package draws for the
same interval time, shortwave flag and chunk. With it every output,
cloudy columns included, is held to the JAX package's. The port divides
by a constant as a product with its float32 reciprocal (as the compiled
JAX step does) where the op-by-op JAX run divides, so floats are held to
a relative bound stated per test; integer indices exactly.

``JaxCdf`` and the column cases are shared with the other RRTMG test
files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import rrtmg_lw as jlw
from icar_tpu.physics import rrtmg_lw_tables as jlwt
from icar_tpu_torch.physics import rrtmg_lw as tlw
from icar_tpu_torch.physics import rrtmg_lw_tables as tlwt

torch.set_num_threads(1)


class JaxCdf:
    """The JAX package's McICA draw as the port's cdf source: the uniform
    draw of ``fold_in(PRNGKey(88), int32(t))`` (folded with 1 for the
    shortwave; split per chunk when the columns take more than one),
    icar_tpu/core/step.py:300 and rrtmg_lw.py column_chunked."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def key(kind, t):
        key = jax.random.fold_in(jax.random.PRNGKey(88), np.int32(int(t)))
        return jax.random.fold_in(key, 1) if kind == "sw" else key

    def __call__(self, kind, t, chunk, n_chunks, shape, device):
        self.calls.append((kind, float(t), chunk, n_chunks))
        key = self.key(kind, t)
        if n_chunks > 1:
            key = jax.random.split(key, n_chunks)[chunk]
        draw = jax.random.uniform(key, shape, jnp.float32)
        return torch.tensor(np.asarray(draw), device=device)


def columns(n=12, nlay=10, seed=0, cloud=True):
    """Seeded (nlay, n) columns: pressure from ~1000 to 50 hPa,
    temperature 290 to 210 K with noise, water vapour, and (``cloud``)
    cloud fractions in 0..1 with liquid, ice and snow paths; half the
    columns clear."""
    r = np.random.default_rng(seed)
    f = np.float32
    plev = np.exp(np.linspace(np.log(1000.0), np.log(40.0), nlay + 1))
    plev = (plev[:, None] * r.uniform(0.97, 1.03, n)).astype(f)
    play = (0.5 * (plev[:-1] + plev[1:])).astype(f)
    tlay = (np.linspace(290.0, 210.0, nlay)[:, None]
            + r.normal(0, 2, (nlay, n))).astype(f)
    tlev = np.concatenate([tlay[:1] + 1.0, 0.5 * (tlay[:-1] + tlay[1:]),
                           tlay[-1:] - 2.0]).astype(f)
    h2o = (0.02 * np.exp(-np.arange(nlay) / 3.0)[:, None]
           * r.uniform(0.3, 1.0, (nlay, n))).astype(f)
    cf = r.uniform(0, 1, (nlay, n)) * (r.uniform(size=(nlay, n)) < 0.5)
    if not cloud:
        cf[:] = 0
    cf[:, n // 2:] = 0
    cf = cf.astype(f)
    wp = lambda s: np.where(cf > 0, r.uniform(0, s, (nlay, n)), 0).astype(f)
    return dict(play=play, plev=plev, tlay=tlay, tlev=tlev,
                tsfc=(tlev[0] + r.normal(0, 1, n)).astype(f), h2ovmr=h2o,
                o3vmr=np.full((nlay, n), 5e-8, f), cldfrac=cf,
                ciwp=wp(20.0), clwp=wp(60.0), cswp=wp(10.0),
                rei=r.uniform(5, 140, (nlay, n)).astype(f),
                rel=r.uniform(2.5, 60, (nlay, n)).astype(f),
                res=r.uniform(10, 140, (nlay, n)).astype(f),
                emis=r.uniform(0.9, 1.0, n).astype(f))


def fields3d(nz=10, ny=3, nx=5, seed=2, cloud=True):
    """Seeded (nz, ny, nx) fields for the drivers (p in Pa)."""
    r = np.random.default_rng(seed)
    f = np.float32
    dz = np.full((nz, ny, nx), 400.0, f)
    z = np.cumsum(dz, axis=0) - 200.0
    p = (1e5 * np.exp(-z / 8000.0) * r.uniform(0.99, 1.01, (ny, nx))).astype(f)
    p8w = (1e5 * np.exp(-(z - 200.0) / 8000.0)).astype(f)
    t = (288.0 - 0.0065 * z + r.normal(0, 1, z.shape)).astype(f)
    t8w = (288.0 - 0.0065 * (z - 200.0)).astype(f)
    qv = (0.012 * np.exp(-z / 2500.0)).astype(f)
    cf = (r.uniform(0, 1, z.shape) * (r.uniform(size=z.shape) < 0.4)
          * cloud).astype(f)
    q = lambda s: np.where(cf > 0, r.uniform(0, s, z.shape), 0).astype(f)
    return dict(p=p, p8w=p8w, t=t, t8w=t8w, qv=qv, qc=q(5e-4), qi=q(2e-4),
                qs=q(1e-4), cf=cf, re_c=np.full(z.shape, 2.49e-6, f),
                re_i=np.full(z.shape, 4.99e-6, f),
                re_s=np.full(z.shape, 9.99e-6, f),
                rho=(p / (287.0 * t)).astype(f), dz=dz,
                exner=((p / 1e5) ** 0.2857).astype(f),
                tsk=(t[0] + 1.0).astype(f),
                emiss=np.full((ny, nx), 0.95, f),
                xland=np.where(r.uniform(size=(ny, nx)) < 0.3, 2.0,
                               1.0).astype(f),
                cosz=r.uniform(-0.3, 1.0, (ny, nx)).astype(f),
                albedo=r.uniform(0.1, 0.3, (ny, nx)).astype(f))


def jx(a):
    return jnp.asarray(a)


def tt(a):
    return torch.tensor(np.asarray(a))


def rel(got, want):
    """max |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    return d / max(np.abs(want).max(), 1e-30) if d else 0.0


@pytest.fixture(scope="module")
def tables():
    """The synthetic LW k-tables (bench.py's seed 0) of each package."""
    return jlwt.synthetic_lw_tables(), tlw.device_tables(
        tlwt.synthetic_lw_tables(), "cpu")


def test_synthetic_tables_are_identical():
    """The port's copy of rrtmg_lw_tables gives the JAX package's
    synthetic tables array by array, bit for bit."""
    want, got = jlwt.synthetic_lw_tables(), tlwt.synthetic_lw_tables()
    assert len(got) == len(want) == 16
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _jax_profile(c):
    """coldry, wkl, wbroad, wx and pwvcm as jlw.rrtmg_lw_rad forms them."""
    dpg = c["plev"][:-1] - c["plev"][1:]
    h2o = jx(c["h2ovmr"])
    coldry = jx(dpg) * 1e3 * jlw.AVOGAD / (
        1e2 * jlw.GRAV * jlw.AMD * (1.0 + h2o * jlw.AMW / jlw.AMD))
    o3 = jx(c["o3vmr"])
    wkl = jnp.stack([h2o * coldry, jlw.CO2VMR * coldry, o3 * coldry,
                     jlw.N2OVMR * coldry, jnp.zeros_like(coldry),
                     jlw.CH4VMR * coldry, jlw.O2VMR * coldry])
    wbroad = coldry * (1.0 - (h2o + jlw.CO2VMR + o3 + jlw.N2OVMR
                              + jlw.CH4VMR + jlw.O2VMR))
    wx = [v * coldry * 1e-20 for v in (jlw.CCL4VMR, jlw.CFC11VMR,
                                       jlw.CFC12VMR, jlw.CFC22VMR)]
    return coldry, wkl, wbroad, wx


def _namespace_to_torch(c):
    from types import SimpleNamespace
    return SimpleNamespace(**{k: (_namespace_to_torch(v) if isinstance(
        v, SimpleNamespace) else tt(v)) for k, v in vars(c).items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_setcoef_matches(seed):
    """setcoef: every index equal, every float within 1e-5 of its largest
    magnitude (observed at most 2.3e-6: the port's fac and frac products
    after a reciprocal where the op-by-op JAX divides)."""
    c = columns(seed=seed)
    coldry, wkl, wbroad, _ = _jax_profile(c)
    semiss = np.broadcast_to(c["emis"][:, None], (12, 16)).copy()
    with jax.disable_jit():
        want = jlw.setcoef(jx(c["play"]), jx(c["tlay"]), jx(c["tlev"]),
                           jx(c["tsfc"]), jx(semiss), coldry, wkl, wbroad)
    got = tlw.setcoef(tt(c["play"]), tt(c["tlay"]), tt(c["tlev"]),
                      tt(c["tsfc"]), tt(semiss), tt(coldry), tt(wkl),
                      tt(wbroad))
    assert np.asarray(want.tropo).any() and not np.asarray(want.tropo).all()
    for k, w in vars(want).items():
        if k == "rat":
            for kk, ww in vars(w).items():
                assert rel(getattr(got.rat, kk), ww) <= 2e-6, kk
            continue
        g = getattr(got, k)
        if np.asarray(w).dtype.kind in "ib":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)
        else:
            assert rel(g, w) <= 1e-5, k


@pytest.fixture(scope="module")
def taumol_pair(tables):
    """taumol of both packages on the JAX package's setcoef output."""
    jt, tt_ = tables
    c = columns(seed=3)
    coldry, wkl, wbroad, wx = _jax_profile(c)
    semiss = np.broadcast_to(c["emis"][:, None], (12, 16)).copy()
    with jax.disable_jit():
        cj = jlw.setcoef(jx(c["play"]), jx(c["tlay"]), jx(c["tlev"]),
                         jx(c["tsfc"]), jx(semiss), coldry, wkl, wbroad)
        want = jlw.taumol(jax.tree_util.tree_map(jnp.asarray, jt), cj, wx)
    got = tlw.taumol(tt_, _namespace_to_torch(cj), [tt(w) for w in wx])
    return want, got


@pytest.mark.parametrize("band", range(1, 17))
def test_taumol_band_matches(taumol_pair, band):
    """taumol per band: the gas optical depths and Planck fractions of
    the band's g-points within 1e-5 of their largest magnitude (observed
    bit for bit but band 1, 1.6e-9)."""
    (taug_j, frac_j), (taug_t, frac_t) = taumol_pair
    lo = int(tlwt.NGS[band - 1] - tlwt.NGC[band - 1])
    hi = int(tlwt.NGS[band - 1])
    assert rel(taug_t[..., lo:hi], np.asarray(taug_j)[..., lo:hi]) <= 1e-5
    assert rel(frac_t[..., lo:hi], np.asarray(frac_j)[..., lo:hi]) <= 1e-5


def test_mcica_and_cldprmc_match():
    """McICA on the JAX draw (random and maximum-random overlap) gives the
    JAX package's masks and paths exactly; cldprmc's optical depths
    within 1e-6 of their largest value (observed 7.2e-9)."""
    c = columns(seed=4)
    key = jax.random.PRNGKey(7)
    draw = jax.random.uniform(key, (10, 12, tlwt.NGPTLW), jnp.float32)
    for icld in (1, 2):
        with jax.disable_jit():
            want = jlw.mcica_subcol_lw(key, jx(c["cldfrac"]), jx(c["ciwp"]),
                                       jx(c["clwp"]), jx(c["cswp"]), icld)
        got = tlw.mcica_subcol(tt(draw), tt(c["cldfrac"]), tt(c["ciwp"]),
                               tt(c["clwp"]), tt(c["cswp"]), icld)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[0]).any()
    with jax.disable_jit():
        tj = jlw.cldprmc(*want, jx(c["rei"]), jx(c["rel"]), jx(c["res"]))
    tg = tlw.cldprmc(*got, tt(c["rei"]), tt(c["rel"]), tt(c["res"]))
    assert rel(tg, tj) <= 1e-6


@pytest.mark.parametrize("cloud", [True, False], ids=["cloudy", "clear"])
def test_rtrnmc_matches(cloud):
    """rtrnmc's level loops against the JAX scans: up and down fluxes,
    all-sky and clear-sky, within 2e-6 of their largest magnitude
    (observed 1.7e-7)."""
    r = np.random.default_rng(5)
    nlay, n, g = 10, 12, tlwt.NGPTLW
    f = np.float32
    cldf = ((r.uniform(size=(nlay, n, g)) < 0.3) * cloud).astype(f)
    args = (r.uniform(0.9, 1, (n, 16)).astype(f),
            r.uniform(0.1, 4, n).astype(f), cldf,
            (cldf * r.uniform(0, 5, (nlay, n, g))).astype(f),
            r.uniform(0.1, 1, (nlay, n, 16)).astype(f),
            r.uniform(0.1, 1, (nlay + 1, n, 16)).astype(f),
            r.uniform(0.1, 1, (n, 16)).astype(f),
            r.uniform(0, 0.1, (nlay, n, g)).astype(f),
            r.gamma(1.0, 0.5, (nlay, n, g)).astype(f))
    with jax.disable_jit():
        want = jlw.rtrnmc(*[jx(a) for a in args])
    got = tlw.rtrnmc(*[tt(a) for a in args])
    for w, gg in zip(want, got):
        assert rel(gg, w) <= 2e-6


@pytest.mark.parametrize("cloud", [True, False], ids=["cloudy", "clear"])
def test_rrtmg_lw_rad_matches(tables, cloud):
    """The whole column calculation with the JAX draw: fluxes within 1e-5
    of their largest magnitude, the heating rate within 1e-4 (a
    difference of fluxes over the layer's pressure depth); observed at
    most 3.0e-6 over both."""
    jt, tt_ = tables
    c = columns(seed=6, cloud=cloud)
    key = jax.random.PRNGKey(3)
    draw = jax.random.uniform(key, (10, 12, tlwt.NGPTLW), jnp.float32)
    names = ("play", "plev", "tlay", "tlev", "tsfc", "h2ovmr", "o3vmr",
             "cldfrac", "ciwp", "clwp", "cswp", "rei", "rel", "res", "emis")
    with jax.disable_jit():
        want = jlw.rrtmg_lw_rad(jt, *[jx(c[k]) for k in names], key)
    got = tlw.rrtmg_lw_rad(tt_, *[tt(c[k]) for k in names], tt(draw))
    for k in ("uflx", "dflx", "uflxc", "dflxc"):
        assert rel(getattr(got, k), getattr(want, k)) <= 1e-5, k
    assert rel(got.htr, want.htr) <= 1e-4


def _driver_args(f, lib):
    conv = jx if lib is jlw else tt
    return [conv(f[k]) for k in (
        "p", "p8w", "t", "t8w", "tsk", "qv", "qc", "qi", "qs", "cf", "re_c",
        "re_i", "re_s", "rho", "dz", "emiss", "exner")]


@pytest.mark.parametrize("chunk", [None, 12], ids=["one_chunk", "chunked"])
def test_driver_matches_with_the_jax_draws(tables, chunk, monkeypatch):
    """rrtmg_lw_driver on cloudy (nz, ny, nx) fields at interval time 40 s,
    with the port's draws from JaxCdf: 12 columns in one chunk, and 15
    columns in chunks of 12 (two chunks, the last edge-padded by 9)
    against the JAX chunked driver with its per-chunk split keys (chunks
    of the other tests' 12 columns, so that the op-by-op JAX run reuses
    their compiled operations). The theta tendency within 1e-4 of its
    largest magnitude, the fluxes within 1e-5 (observed at most 9.2e-6
    over both, and over the shortwave driver's test)."""
    jt, tt_ = tables
    f = fields3d(nx=5 if chunk else 4)
    if chunk:
        monkeypatch.setattr(jlw, "RRTMG_COL_CHUNK", chunk)
        monkeypatch.setattr(tlw, "RRTMG_COL_CHUNK", chunk)
    cdf = JaxCdf()
    with jax.disable_jit():
        want = jlw.rrtmg_lw_driver(jt, JaxCdf.key("lw", 40.0),
                                   *_driver_args(f, jlw),
                                   xland=jx(f["xland"]))
    got = tlw.rrtmg_lw_driver(tt_, cdf, np.float32(40.0),
                              *_driver_args(f, tlw), xland=tt(f["xland"]))
    assert [c[2:] for c in cdf.calls] == (
        [(0, 2), (1, 2)] if chunk else [(0, 1)])
    assert rel(got[0], want[0]) <= 1e-4
    for g, w in zip(got[1:], want[1:]):
        assert rel(g, w) <= 1e-5


def test_chunked_equals_unchunked_for_clear_columns(tables, monkeypatch):
    """Cloud-free columns (tests/test_rrtmg_lw.py's case): the McICA
    draw is irrelevant, so chunks of 5 give one call's result within
    2e-6 (observed bit for bit)."""
    _, tt_ = tables
    f = fields3d(cloud=False)
    args = _driver_args(f, tlw)
    full = tlw.rrtmg_lw_driver(tt_, tlw.TorchCdf(), 0.0, *args)
    monkeypatch.setattr(tlw, "RRTMG_COL_CHUNK", 5)
    chunked = tlw.rrtmg_lw_driver(tt_, tlw.TorchCdf(), 0.0, *args)
    for a, b in zip(full, chunked):
        assert rel(b, a) <= 2e-6


def test_o3_profile_matches():
    """The climatological ozone interpolation against jnp.interp, across
    and beyond the profile's pressure range: within 1e-6 of its largest
    value (observed 6.2e-8)."""
    p = np.geomspace(0.3, 1200.0, 200).astype(np.float32)
    with jax.disable_jit():
        want = jlw._o3_profile(jx(p))
    assert rel(tlw._o3_profile(tt(p)), want) <= 1e-6


def test_missing_tables_raise_the_jax_message(monkeypatch, tmp_path):
    """Without injected tables and without rrtmg_support files, the port
    raises FileNotFoundError with the JAX package's message."""
    monkeypatch.setattr(tlw, "_TABLES", None)
    with pytest.raises(FileNotFoundError, match="RRTMG k-distribution data "
                                                "not found"):
        tlw.get_lw_tables(str(tmp_path / "rrtmg_support"))
    from icar_tpu_torch.physics import rrtmg_sw as tsw
    monkeypatch.setattr(tsw, "_TABLES", None)
    with pytest.raises(FileNotFoundError, match="RRTMG-SW k-distribution"):
        tsw.get_sw_tables(str(tmp_path / "rrtmg_support"))


def _within(share, p, n, sigmas=5.0):
    """|share - p| inside ``sigmas`` binomial standard deviations of n."""
    return abs(share - p) <= sigmas * np.sqrt(p * (1 - p) / n)


def test_port_mcica_draw_statistics():
    """The port's own McICA draw (TorchCdf on the CPU generator): uniform
    in [0, 1), the same for the same (kind, t, chunk) and another for
    another; with random overlap each layer's cloudy-subcolumn share and
    each adjacent pair's joint share within 5 binomial sigmas of cf and of
    cf_k cf_k+1; with maximum-random overlap (scanned from the top) the
    top layer's share within 5 sigmas of its cf, the joint share of the
    top two layers of min(cf), and the next layer's share under a clear
    top of its own cf."""
    nlay, n, g = 6, 2048, tlwt.NGPTLW
    cf = np.array([0.1, 0.3, 0.5, 0.7, 0.2, 0.6], np.float32)
    cfr = torch.tensor(np.repeat(cf[:, None], n, axis=1))
    cdf = tlw.TorchCdf(on="cpu")
    draw = cdf("lw", np.float32(40.0), 0, 1, (nlay, n, g), "cpu")
    assert draw.dtype == torch.float32 and draw.shape == (nlay, n, g)
    assert float(draw.min()) >= 0.0 and float(draw.max()) < 1.0
    assert torch.equal(draw, cdf("lw", np.float32(40.5), 0, 1,
                                 (nlay, n, g), "cpu"))
    for other in (("sw", 40.0, 0), ("lw", 41.0, 0), ("lw", 40.0, 1)):
        assert not torch.equal(draw, cdf(other[0], np.float32(other[1]),
                                         other[2], 2, (nlay, n, g), "cpu"))
    zero = torch.zeros((nlay, n))
    samples = n * g
    rand = tlw.mcica_subcol(draw, cfr, zero, zero, zero, icld=1)[0]
    rand = rand.numpy().astype(bool)
    for k in range(nlay):
        assert _within(rand[k].mean(), cf[k], samples), k
    for k in range(nlay - 1):
        assert _within((rand[k] & rand[k + 1]).mean(), cf[k] * cf[k + 1],
                       samples), k
    mxr = tlw.mcica_subcol(draw, cfr, zero, zero, zero, icld=2)[0]
    mxr = mxr.numpy().astype(bool)
    top, nxt = mxr[-1], mxr[-2]
    assert _within(top.mean(), cf[-1], samples)
    assert _within((top & nxt).mean(), min(cf[-1], cf[-2]), samples)
    assert _within(nxt[~top].mean(), cf[-2], int((~top).sum()))

"""YSU (icar_tpu_torch/physics/ysu.py) against the JAX package's ysu run
op by op (``jax.disable_jit()``): the surface layer in each stability
regime (over land and water), and the scheme on idealised columns
(tests/test_ysu.py's: unstable, stable, a heated moist column with cloud
water for the moist Richardson correction); then tests/test_ysu.py's
physical checks on the port's own output.

The port divides by a constant as a product with its float32 reciprocal
where the op-by-op JAX run divides, and its powers round apart, so floats
are held to a relative bound stated per test; kpbl exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.physics import ysu as jysu
from icar_tpu_torch.physics import ysu as tysu

torch.set_num_threads(1)


def column(nz=15, ny=4, nx=4, t_sfc=290.0, lapse=0.0098, qv0=0.008,
           u0=5.0, tskin_excess=0.0, seed=None):
    """tests/test_ysu.py's idealised column as numpy arrays; with ``seed``
    noise on theta and the winds, a random land/water mask and cloud
    water in a third of the cells."""
    f = np.float32
    dz = np.full((nz, ny, nx), 200.0, f)
    zi = np.concatenate([np.zeros((1, ny, nx)), np.cumsum(dz, axis=0)])
    z = 0.5 * (zi[:-1] + zi[1:])
    p = (1e5 * np.exp(-z / 8000.0)).astype(f)
    t = (t_sfc - lapse * z).astype(f)
    exner = ((p / 1e5) ** JC.ROVCP).astype(f)
    u = np.full((nz, ny, nx), u0, f)
    v = np.zeros_like(u)
    qc = np.zeros_like(u)
    xland = np.ones((ny, nx), f)
    if seed is not None:
        r = np.random.default_rng(seed)
        t = (t + r.normal(0, 0.3, t.shape)).astype(f)
        u = (u + r.normal(0, 2, u.shape)).astype(f)
        v = r.normal(0, 2, u.shape).astype(f)
        qc = np.where(r.uniform(size=u.shape) < 0.3,
                      r.uniform(0, 5e-4, u.shape), 0).astype(f)
        xland = np.where(r.uniform(size=(ny, nx)) < 0.4, 2.0, 1.0).astype(f)
    th = (t / exner).astype(f)
    p_i = np.concatenate([[p[0] + (p[0] - p[1]) / 2],
                          0.5 * (p[:-1] + p[1:])]).astype(f)
    return dict(u=u, v=v, th=th, t=t,
                qv=(qv0 * np.exp(-z / 3000.0)).astype(f), qc=qc,
                qi=np.zeros_like(u), p=p, p_i=p_i, exner=exner, dz=dz,
                z=z.astype(f), terrain=np.zeros((ny, nx), f),
                psfc=(p[0] + (p[0] - p[1]) / 2).astype(f),
                tskin=np.full((ny, nx), t_sfc + tskin_excess, f),
                znt=np.full((ny, nx), 0.1, f), xland=xland,
                ust=np.full((ny, nx), 0.3, f),
                u10=(u[0] * 0.8).astype(f), v10=(v[0] * 0.8).astype(f))


def run(lib, c, hfx=100.0, qfx=3e-5, dt=60.0):
    """tests/test_ysu.py's run_ysu on ``lib`` (the JAX module or the
    port's), its inputs converted."""
    conv = jnp.asarray if lib is jysu else torch.tensor
    c = {k: conv(v) for k, v in c.items()}
    ny, nx = c["tskin"].shape
    hfx_a = conv(np.full((ny, nx), hfx, np.float32))
    qfx_a = conv(np.full((ny, nx), qfx, np.float32))
    t1 = c["t"][0]
    z_atm = c["z"][0] - c["terrain"]
    wspd = (c["u10"] ** 2 + c["v10"] ** 2) ** 0.5
    wspd10 = wspd.clip(1e-5) if lib is tysu else jnp.maximum(wspd, 1e-5)
    ri = JC.GRAVITY / t1 * (t1 - c["tskin"]) * z_atm / wspd10 ** 2
    sfc = lib.surface_layer(c["psfc"], c["tskin"], c["p"][0], t1,
                            c["qc"][0], c["u"][0], c["v"][0], z_atm,
                            c["znt"], c["xland"], 1000.0, c["ust"], hfx_a,
                            qfx_a)
    dt = jnp.float32(dt) if lib is jysu else torch.tensor(dt)
    return lib.ysu(c["u"], c["v"], c["th"], c["t"], c["qv"], c["qc"],
                   c["qi"], c["p"], c["p_i"], c["exner"], c["dz"], c["z"],
                   c["terrain"], c["psfc"], c["tskin"], c["znt"],
                   c["xland"], hfx_a, qfx_a, c["ust"], c["u10"], c["v10"],
                   sfc.psim, sfc.psih, ri, dt)


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want).max()
    return d / max(np.abs(want).max(), 1e-30) if d else 0.0


def _surface_args(r, tskin, ts1, us, ust, hfx, qfx, xland):
    f = np.float32
    ny, nx = 3, 4
    full = lambda v: np.full((ny, nx), v, f)
    # noise on the winds and fluxes only: the temperatures set the regime
    mk = lambda v: full(v) * r.uniform(0.9, 1.1, (ny, nx)).astype(f)
    return (full(1e5), full(tskin), full(99000.0), full(ts1), full(1e-4),
            mk(us), mk(1.0), full(50.0), full(0.1), full(xland), 2500.0,
            mk(ust), mk(hfx), mk(qfx))


@pytest.mark.parametrize("case,regimes", [
    ("unstable", {4}), ("stable", {1}), ("weakly_stable", {2}),
    ("unstable_water", {4}), ("calm_unstable", {4})])
def test_surface_layer_matches(case, regimes):
    """The surface layer in each regime (1: rib >= 0.2, 2: 0 < rib < 0.2,
    4: unstable; land and water; ust below 0.01, the free-convection
    limit): psim, psih, the 10 m winds, t2 and q2 within 2e-6 of their
    largest magnitudes (observed at most 1.9e-7), the regime equal."""
    r = np.random.default_rng(len(case))
    args = {"unstable": (295.0, 290.0, 5.0, 0.4, 150.0, 5e-5, 1.0),
            "stable": (282.0, 290.0, 2.0, 0.1, -30.0, 0.0, 1.0),
            "weakly_stable": (286.0, 290.0, 12.0, 0.3, -5.0, 1e-6, 1.0),
            "unstable_water": (295.0, 290.0, 6.0, 0.3, 80.0, 8e-5, 2.0),
            "calm_unstable": (296.0, 290.0, 0.5, 0.005, 60.0, 3e-5, 1.0),
            }[case]
    a = _surface_args(r, *args)
    with jax.disable_jit():
        want = jysu.surface_layer(*[jnp.asarray(x) if isinstance(
            x, np.ndarray) else x for x in a])
    got = tysu.surface_layer(*[torch.tensor(x) if isinstance(
        x, np.ndarray) else x for x in a])
    assert set(np.round(np.asarray(want.regime)).astype(int).ravel()) \
        == regimes
    np.testing.assert_array_equal(got.regime.numpy(),
                                  np.asarray(want.regime))
    for k in ("psim", "psih", "u10", "v10", "t2", "q2"):
        assert rel(getattr(got, k), getattr(want, k)) <= 2e-6, k


@pytest.mark.parametrize("case", ["unstable", "stable", "moist_noisy"])
def test_ysu_matches(case):
    """The scheme on tests/test_ysu.py's columns (and a noisy one with
    cloud water over land and water): theta, moisture and the condensate
    within 1e-6 of their largest magnitudes, hpbl within 1e-5, kpbl
    equal, exch_h within 1e-4 (observed at most 6.0e-8 over all of
    them)."""
    c, hfx, qfx = {
        "unstable": (column(lapse=0.0098, tskin_excess=3.0), 200.0, 3e-5),
        "stable": (column(lapse=0.004, tskin_excess=-3.0), -20.0, 0.0),
        "moist_noisy": (column(lapse=0.0098, tskin_excess=1.0, seed=3),
                        120.0, 6e-5)}[case]
    with jax.disable_jit():
        want = run(jysu, c, hfx, qfx)
    got = run(tysu, c, hfx, qfx)
    for name, g, w in zip(("th", "qv", "qc", "qi"), got[:4], want[:4]):
        assert rel(g, w) <= 1e-6, name
    assert rel(got[4], want[4]) <= 1e-5
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert rel(got[6], want[6]) <= 1e-4


def test_unstable_column_grows_pbl():
    th, qv, qc, qi, hpbl, kpbl, exch = run(
        tysu, column(lapse=0.0098, tskin_excess=3.0), hfx=200.0)
    assert float(hpbl.min()) > 100.0
    assert int(kpbl.max()) >= 2
    assert torch.isfinite(th).all()


def test_stable_column_shallow_pbl():
    hpbl_s = run(tysu, column(lapse=0.004, tskin_excess=-3.0), hfx=-20.0,
                 qfx=0.0)[4]
    hpbl_u = run(tysu, column(lapse=0.0098, tskin_excess=3.0),
                 hfx=200.0)[4]
    assert float(hpbl_s.mean()) < float(hpbl_u.mean())


def test_surface_heating_warms_lowest_layer():
    c = column(lapse=0.0098)
    th, qv, *_ = run(tysu, c, hfx=300.0, qfx=1e-4, dt=120.0)
    dth = th.numpy() - c["th"]
    assert dth[0].min() > 0
    _, qv_noflux, *_ = run(tysu, column(lapse=0.0098), hfx=300.0, qfx=0.0,
                           dt=120.0)
    assert float((qv[0] - qv_noflux[0]).min()) > 0
    np.testing.assert_allclose(dth[-1], 0.0, atol=1e-7)


def test_heat_conservation_without_surface_flux():
    c = column(lapse=0.012, tskin_excess=-1.0)
    delp = c["p_i"][:-1] - c["p_i"][1:]
    th = run(tysu, c, hfx=0.0, qfx=0.0, dt=60.0)[0].numpy()
    nzt = th.shape[0] - 1
    np.testing.assert_allclose((th[:nzt] * delp[:nzt]).sum(axis=0),
                               (c["th"][:nzt] * delp[:nzt]).sum(axis=0),
                               rtol=2e-5)

"""The JAX package's own Noah-MP scenarios (tests/test_noahmp.py
TestPieces, TestEnergyBalance and TestSnow) on the port against the JAX
package's: each piece on both (op by op, ``jax.disable_jit()``); each
chained scenario on one (4, 6) grid of scenario blocks against the JAX
driver jitted (compiled once for both groups: a many-step run op by op
would take minutes), every snapshot within JIT_TOL; then the scenario's
own physical checks on the port's output. A file of its own so that a
second test worker runs it beside tests/test_torch_noahmp.py's routines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import noahmp as J
from icar_tpu.physics.noah_params import load_tables as jax_noah_tables
from icar_tpu.physics.noahmp_params import load_mp_tables as jax_mp_tables
from icar_tpu.physics.noahmp_params import resolve_params as jax_resolve
from icar_tpu_torch.physics import noahmp as T
from icar_tpu_torch.physics.noah_params import load_tables
from icar_tpu_torch.physics.noahmp_params import (load_mp_tables,
                                                  resolve_params)
from test_torch_noahmp import (NX, NY, ORDER, TOL, _run_driver,
                               assert_match)

torch.set_num_threads(1)


# ---- the JAX package's scenarios (tests/test_noahmp.py), on both ------

def _scenario_state(groups):
    """noahmp_init_state of the scenarios' cells: ``groups`` is a list of
    (ncells, tsk, swe, soil_t, soil_m) filling the grid row by row."""
    cells = [g for g in groups for _ in range(g[0])]
    assert len(cells) == NY * NX
    g = lambda i: np.array([c[i] for c in cells], np.float32).reshape(
        NY, NX)
    veg = np.full((NY, NX), 10, np.int32)
    soil = np.full((NY, NX), 6, np.int32)
    st = J.noahmp_init_state(
        g(1), g(2), np.zeros((NY, NX), np.float32),
        np.broadcast_to(g(3), (4, NY, NX)).astype(np.float32),
        np.broadcast_to(g(4), (4, NY, NX)).astype(np.float32), soil, veg,
        jax_mp_tables(), jax_noah_tables())
    return st, veg, soil


def _scenario_args(groups, dt, names):
    """tests/test_noahmp.py drive()'s forcing per cell (``names``: the
    per-group keyword values of t_air, qv, sw, lw, prcp_mm, cosz)."""
    cells = [g for g in groups for _ in range(g[0])]
    col = lambda k: np.array([c[5][k] for c in cells], np.float32
                             ).reshape(NY, NX)
    full = lambda v: np.full((NY, NX), v, np.float32)
    return dict(lat=full(45.0), yearlen=365.0, julian=full(180.0),
                cosz=col("cosz"), dt=dt, shdfac=full(0.7),
                vegtype=np.full((NY, NX), 10, np.int32),
                sfctmp=col("t_air"), sfcprs=full(95000.0),
                psfc=full(95300.0), uu=full(3.0), vv=full(0.0),
                q2=col("qv"), soldn=col("sw"), lwdn=col("lw"),
                prcp_mm=col("prcp_mm"), tbot=full(284.0), zlvl=full(30.0))


def _forcing(t_air=285.0, qv=0.008, sw=400.0, lw=320.0, prcp_mm=0.0,
             cosz=0.7):
    return dict(t_air=t_air, qv=qv, sw=sw, lw=lw, prcp_mm=prcp_mm,
                cosz=cosz)


# the scenarios' largest difference against the jitted JAX driver,
# relative to each field's largest magnitude (observed 1.6e-4: the jitted
# driver contracts multiply-adds, which the steps carry on)
JIT_TOL = 1e-3


@pytest.fixture(scope="module")
def jax_driver():
    """The JAX noahmp_driver jitted on the scenarios' parameters (every
    scenario cell is vegetation 10 on soil 6): (args, state) -> numpy
    (outputs, state)."""
    veg = np.full((NY, NX), 10, np.int32)
    pj = jax_resolve(jax_mp_tables(), jax_noah_tables(), jnp.asarray(veg),
                     jnp.asarray(np.full((NY, NX), 6, np.int32)))
    step = jax.jit(lambda a, st: J.noahmp_driver(pj, *a, st))

    def run(args, st):
        out, new = step([jnp.asarray(args[k], jnp.float32)
                         if k != "vegtype" else jnp.asarray(args[k])
                         for k in ORDER],
                        {k: jnp.asarray(v) for k, v in st.items()})
        return ({k: np.asarray(v) for k, v in out.items()},
                {k: np.asarray(v) for k, v in new.items()})
    return run


def _run_scenarios(jax_driver, groups, dt, nsteps, snaps):
    """Both drivers ``nsteps`` steps on the scenario grid; the outputs and
    states after each step in ``snaps``."""
    st0, veg, soil = _scenario_state(groups)
    args = _scenario_args(groups, dt, None)
    pt = resolve_params(load_mp_tables(), load_tables(),
                        torch.as_tensor(veg), torch.as_tensor(soil))
    sj = st = st0
    res = {}
    for n in range(1, nsteps + 1):
        outj, sj = jax_driver(args, sj)
        outt, st = _run_driver(T, pt, args, st)
        if n in snaps:
            res[n] = (outj, sj, outt, st)
    return st0, pt, res


# (cells, tsk, swe, soil_t, soil_m, forcing) per scenario
ENERGY = [(6, 290.0, 0.0, 288.0, 0.3,
           _forcing(t_air=293.0, sw=600.0, lw=350.0, cosz=0.8)),
          (6, 285.0, 0.0, 285.0, 0.3,
           _forcing(t_air=280.0, sw=0.0, lw=280.0, cosz=-0.3)),
          (12, 288.0, 0.0, 285.0, 0.3,
           _forcing(t_air=290.0, sw=500.0, lw=340.0, cosz=0.7))]
SNOW = [(12, 265.0, 0.0, 268.0, 0.3,
         _forcing(t_air=263.0, qv=1e-3, sw=50.0, lw=200.0, prcp_mm=3.0,
                  cosz=0.3)),
        (12, 270.0, 60.0, 272.0, 0.3,
         _forcing(t_air=290.0, qv=6e-3, sw=700.0, lw=380.0, cosz=0.9))]


@pytest.fixture(scope="module")
def energy_runs(jax_driver):
    return _run_scenarios(jax_driver, ENERGY, 600.0, 12, {4, 6, 12})


@pytest.fixture(scope="module")
def snow_runs(jax_driver):
    return _run_scenarios(jax_driver, SNOW, 1800.0, 60, {20, 60})


def _cells(a, lo, hi):
    return np.asarray(a).reshape(a.shape[:-2] + (-1,))[..., lo:hi]


def test_sunny_day_fluxes(energy_runs):
    """TestEnergyBalance.test_sunny_day_fluxes (6 steps): the port equals
    the JAX package's steps and passes the scenario's checks."""
    _, _, res = energy_runs
    outj, sj, out, st = res[6]
    assert_match((outj, sj), (out, st), JIT_TOL)
    for k in ("fsa", "fsh", "fgev", "fctr", "ssoil", "trad", "t2m"):
        assert np.all(np.isfinite(_cells(out[k], 0, 6))), k
    fsa = _cells(out["fsa"], 0, 6)[0]
    fsr = _cells(out["fsr"], 0, 6)[0]
    assert 0.0 < fsr < 600.0 * 0.5
    assert abs(fsa + fsr - 600.0) < 1.0
    assert _cells(out["fctr"], 0, 6)[0] >= 0.0
    trad = _cells(out["trad"], 0, 6)
    assert np.all((trad > 270.0) & (trad < 320.0))


def test_night_cooling(energy_runs):
    """TestEnergyBalance.test_night_cooling (12 steps)."""
    _, _, res = energy_runs
    outj, sj, out, st = res[12]
    assert_match((outj, sj), (out, st), JIT_TOL)
    assert _cells(out["fsa"], 6, 12).max() == 0.0
    assert _cells(st["tg"], 6, 12).mean() < 285.0


def test_energy_closure(energy_runs):
    """TestEnergyBalance.test_energy_closure (4 steps)."""
    _, _, res = energy_runs
    outj, sj, out, st = res[4]
    assert_match((outj, sj), (out, st), JIT_TOL)
    g = lambda k: _cells(out[k], 12, 24).astype(np.float64)
    err = g("fsa") - (g("fira") + g("fsh") + g("fcev") + g("fgev")
                      + g("fctr") + g("ssoil"))
    assert np.all(np.abs(err) < 12.0), err


def test_snow_accumulation(snow_runs):
    """TestSnow.test_snow_accumulation (20 steps of 3 mm snow at -10 C):
    from no snow to layers, the layer masses summing to the pack."""
    _, _, res = snow_runs
    outj, sj, out, st = res[20]
    assert_match((outj, sj), (out, st), JIT_TOL)
    sneqv = _cells(st["sneqv"], 0, 12)
    assert np.all(sneqv > 30.0)
    isnow = torch.as_tensor(st["isnow"])
    assert np.all(_cells(st["isnow"], 0, 12) < 0)
    smask = T._snow_mask(isnow)[:T.NSNOW].numpy()
    layer = np.where(smask, st["snice"] + st["snliq"], 0.0).sum(axis=0)
    np.testing.assert_allclose(_cells(layer, 0, 12), sneqv, rtol=1e-3)
    assert _cells(out["fsno"], 0, 12).min() > 0.5


def test_snowmelt_warm(snow_runs):
    """TestSnow.test_snowmelt_warm (60 steps at 290 K)."""
    st0, _, res = snow_runs
    outj, sj, out, st = res[60]
    assert_match((outj, sj), (out, st), JIT_TOL)
    assert _cells(st["sneqv"], 12, 24).mean() \
        < _cells(st0["sneqv"], 12, 24).mean()
    assert np.all(np.isfinite(st["stc"]))


def test_init_snow_bands():
    """TestSnow.test_init_snow_bands on the port's copy of the init:
    200 mm of snow makes three layers holding it all."""
    tables, nt = load_mp_tables(), load_tables()
    veg = np.full((2, 3), 10, np.int32)
    st = T.noahmp_init_state(
        np.full((2, 3), 285.0, np.float32), np.full((2, 3), 200.0,
                                                    np.float32),
        np.zeros((2, 3), np.float32), np.full((4, 2, 3), 285.0, np.float32),
        np.full((4, 2, 3), 0.3, np.float32), np.full((2, 3), 6, np.int32),
        veg, tables, nt)
    assert np.all(st["isnow"] == -3)
    smask = T._snow_mask(torch.as_tensor(st["isnow"]))[:T.NSNOW].numpy()
    np.testing.assert_allclose(np.where(smask, st["snice"], 0.0).sum(0),
                               200.0, rtol=1e-3)


# ---- TestPieces ---------------------------------------------------------

def test_esat_piece():
    """TestPieces.test_esat on both (op by op)."""
    t = np.array([20.0, 0.0, -20.0], np.float32)
    with jax.disable_jit():
        want = J.esat(jnp.asarray(t))
    got = T.esat(torch.as_tensor(t))
    assert_match(want, got, TOL["default"])
    esw, esi = got[0].numpy(), got[1].numpy()
    assert abs(esw[0] - 2339.0) < 10.0
    assert abs(esw[1] - 611.0) < 2.0
    assert esi[2] < esw[2]


def _piece_params(veg=10, soil=6):
    v = np.full((2, 3), veg, np.int32)
    s = np.full((2, 3), soil, np.int32)
    pj = jax_resolve(jax_mp_tables(), jax_noah_tables(), jnp.asarray(v),
                     jnp.asarray(s))
    pt = resolve_params(load_mp_tables(), load_tables(),
                        torch.as_tensor(v), torch.as_tensor(s))
    return pj, pt, v


def test_phenology_piece():
    """TestPieces.test_phenology_tables: midsummer grassland LAI, both
    hemispheres' month index (remainder of the southern day)."""
    pj, pt, v = _piece_params()
    lat = np.array([[45.0, -45.0, 45.0], [-45.0, 45.0, -10.0]], np.float32)
    a = (np.zeros((2, 3), np.float32), np.full((2, 3), 290.0, np.float32),
         lat)
    for julian in (200.0, 10.0, 360.0):
        with jax.disable_jit():
            want = J.phenology(pj, jnp.asarray(v), *map(jnp.asarray, a),
                               365.0, jnp.full((2, 3), julian))
        got = T.phenology(pt, torch.as_tensor(v), *map(torch.as_tensor, a),
                          365.0, torch.full((2, 3), julian))
        assert_match(want, got, TOL["default"])
    got = T.phenology(pt, torch.as_tensor(v), *map(torch.as_tensor, a),
                      365.0, torch.full((2, 3), 200.0))
    assert got[0][0, 0] > 0.5 and got[4][0, 0] == 1.0


def test_stomata_piece():
    """TestPieces.test_stomata_daylight: sunlit and dark leaves."""
    pj, pt, _ = _piece_params()
    vals = (100.0, 1.0, 295.0, 2000.0, 1500.0, 293.0, 95000.0,
            0.209 * 95000.0, 3.95e-4 * 95000.0, 1.0, 0.8, 30.0)
    res = []
    for apar in (100.0, 0.0):
        a = [np.full((2, 3), x, np.float32) for x in (apar,) + vals[1:]]
        with jax.disable_jit():
            want = J.stomata(pj, *map(jnp.asarray, a))
        got = T.stomata(pt, *map(torch.as_tensor, a))
        assert_match(want, got, TOL["default"])
        res.append(got)
    (rs, psn), (rs_dark, psn_dark) = res
    assert 10.0 < rs[0, 0] < 5000.0 and psn[0, 0] > 0.0
    assert psn_dark[0, 0] == 0.0 and rs_dark[0, 0] > rs[0, 0]


def test_thomas_piece():
    """TestPieces.test_thomas_solver: the stack solve against the JAX
    one and numpy's dense solve."""
    rng = np.random.RandomState(2)
    n = T.NSS
    a = np.zeros((n, 1, 1), np.float32)
    b = np.full((n, 1, 1), 2.0, np.float32)
    c = np.zeros((n, 1, 1), np.float32)
    r = rng.rand(n, 1, 1).astype(np.float32)
    a[1:] = -0.4
    c[:-1] = -0.4
    act = np.ones((n, 1, 1), bool)
    with jax.disable_jit():
        want = J._thomas_stack(*map(jnp.asarray, (a, b, c, r, act)))
    got = T._thomas_stack(*map(torch.as_tensor, (a, b, c, r, act)))
    assert_match(want, got, TOL["default"])
    m = np.diag(b[:, 0, 0]) + np.diag(a[1:, 0, 0], -1) \
        + np.diag(c[:-1, 0, 0], 1)
    np.testing.assert_allclose(got.numpy()[:, 0, 0],
                               np.linalg.solve(m, r[:, 0, 0]), rtol=2e-4)


def test_stack_masks():
    """_active and _snow_mask for every layer count."""
    isnow = np.array([[0, -1], [-2, -3]], np.int32)
    for name in ("_active", "_snow_mask"):
        want = np.asarray(getattr(J, name)(jnp.asarray(isnow)))
        got = getattr(T, name)(torch.as_tensor(isnow)).numpy()
        np.testing.assert_array_equal(got, want)

"""The port's Noah-MP glacier column (icar_tpu_torch/physics/
noahmp_glacier.py) against the JAX package's.

A seeded glacier grid (snow free, one- and three-layer packs, cold and
melting ice, snowfall, rain, night and day) records the arguments of each
glacier routine within one JAX ``glacier_sflx`` call, and each runs on
them in the JAX package op by op (``jax.disable_jit()``) and in the port,
every output within ``TOL`` of its field's largest magnitude (about ten
times the largest difference observed; integer outputs equal). Then the
JAX package's TestGlacier scenarios (tests/test_noahmp.py: frozen init,
cold stable, summer melt, snowfall on glacier) run side by side on one
grid with the JAX column eager, each step compared, and their checks run
on the port's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import noahmp as JN
from icar_tpu.physics import noahmp_glacier as JG
from icar_tpu.physics.noah_params import load_tables as jax_noah_tables
from icar_tpu.physics.noahmp_params import load_mp_tables as jax_mp_tables
from icar_tpu.physics.noahmp_params import resolve_params as jax_resolve
from icar_tpu_torch.physics import noahmp_glacier as TG
from icar_tpu_torch.physics.noah_params import load_tables
from icar_tpu_torch.physics.noahmp_params import (load_mp_tables,
                                                  resolve_params)
from test_torch_noahmp import assert_match, port_args

torch.set_num_threads(1)

NY, NX = 3, 6
ISICE = 15
ORDER = ("cosz dt zsoil sfctmp sfcprs uu vv q2 soldn lwdn prcp tbot "
         "ficeold zlvl").split()
FUNCS = ("thermoprop_glacier radiation_glacier glacier_flux "
         "phasechange_glacier water_glacier snowfall_acc compact_snow "
         "combine_snow divide_snow snowh2o tsnosoi").split()
# largest difference allowed, relative to each output's largest magnitude
# (observed in parentheses)
TOL = dict(default=1e-6,            # (8.4e-8)
           glacier_flux=2e-5,       # (1.0e-6)
           phasechange_glacier=2e-5,   # (1.1e-6)
           glacier_sflx=2e-5)       # (1.0e-6)
SCENARIO_TOL = 2e-6                 # over the scenarios' steps (1.2e-7)


def params(shape):
    veg = np.full(shape, ISICE, np.int32)
    soil = np.full(shape, 6, np.int32)
    pj = jax_resolve(jax_mp_tables(), jax_noah_tables(), jnp.asarray(veg),
                     jnp.asarray(soil))
    pt = resolve_params(load_mp_tables(), load_tables(),
                        torch.as_tensor(veg), torch.as_tensor(soil))
    return pj, pt, veg, soil


def init(tsk, swe, soil_t=262.0, snow_height=None, veg=ISICE):
    veg = np.full(tsk.shape, veg, np.int32)
    return JN.noahmp_init_state(
        tsk, swe, np.zeros(tsk.shape, np.float32) if snow_height is None
        else snow_height, np.broadcast_to(soil_t, (4,) + tsk.shape).astype(
            np.float32),
        np.full((4,) + tsk.shape, 0.3, np.float32),
        np.full(tsk.shape, 6, np.int32), veg, jax_mp_tables(),
        jax_noah_tables())


def run(lib, p, args, st):
    """One glacier step of ``lib`` (JG or TG) on numpy inputs; outputs and
    state as numpy."""
    if lib is JG:
        out, new = JG.glacier_sflx(p, *[jnp.asarray(args[k]) if isinstance(
            args[k], np.ndarray) else args[k] for k in ORDER],
            {k: jnp.asarray(v) for k, v in st.items()})
        return ({k: np.asarray(v) for k, v in out.items()},
                {k: np.asarray(v) for k, v in new.items()})
    a = [torch.as_tensor(args[k]) if isinstance(args[k], np.ndarray)
         else args[k] for k in ORDER]
    a[ORDER.index("dt")] = torch.tensor(float(args["dt"]))
    out, new = TG.glacier_sflx(p, *a, {k: torch.as_tensor(np.array(v))
                                       for k, v in st.items()})
    for k, v in list(out.items()) + list(new.items()):
        assert v.dtype == (torch.int32 if k == "isnow"
                           else torch.float32), k
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new.items()})


def mixed_case(seed=5):
    r = np.random.default_rng(seed)
    f = lambda lo, hi: r.uniform(lo, hi, (NY, NX)).astype(np.float32)
    depth = r.choice([0.0, 0.04, 0.08, 0.5], (NY, NX)).astype(np.float32)
    warm = r.uniform(size=(NY, NX)) < 0.5
    tsk = np.where(warm, f(272, 276), f(250, 268)).astype(np.float32)
    # the snow layers of a land init (the glacier init gives every cell
    # two or more), over ice with some melt water near the top
    st = init(tsk, (depth * 250.0).astype(np.float32), soil_t=f(255, 273),
              snow_height=depth, veg=10)
    st["smc"] = np.ones_like(st["smc"])
    st["sh2o"] = np.where(warm[None] & (np.arange(4) < 2)[:, None, None],
                          0.05, 0.0).astype(np.float32)
    st["stc"][3] = np.where(warm, 273.3, st["stc"][3])   # melting ice
    sfctmp = np.where(warm, f(274, 285), f(250, 270)).astype(np.float32)
    args = dict(cosz=np.where(r.uniform(size=(NY, NX)) < 0.3, 0.0,
                              f(0.1, 0.9)).astype(np.float32),
                dt=1800.0, zsoil=np.asarray(JN.ZSOIL), sfctmp=sfctmp,
                sfcprs=f(7e4, 9e4), uu=f(-8, 8), vv=f(-8, 8),
                q2=f(5e-4, 5e-3), soldn=f(0, 900), lwdn=f(180, 350),
                prcp=np.where(r.uniform(size=(NY, NX)) < 0.6,
                              f(0, 2e-2), 0).astype(np.float32),
                tbot=f(255, 270),
                ficeold=np.ones((JN.NSNOW, NY, NX), np.float32),
                zlvl=f(20, 40))
    return args, st


@pytest.fixture(scope="module")
def recorded():
    args, st = mixed_case()
    pj, pt, _, _ = params((NY, NX))
    calls = {n: [] for n in FUNCS}
    orig = {n: getattr(JG, n) for n in FUNCS}

    def recorder(name):
        def wrap(*a, **kw):
            if not calls[name]:
                calls[name].append((a, kw))
            return orig[name](*a, **kw)
        return wrap
    for n in FUNCS:
        setattr(JG, n, recorder(n))
    try:
        run(JG, pj, args, st)
    finally:
        for n in FUNCS:
            setattr(JG, n, orig[n])
    return dict(args=args, st=st, pj=pj, pt=pt, calls=calls)


@pytest.mark.parametrize("name", FUNCS)
def test_glacier_routine_matches(recorded, name):
    """Each routine on the arguments it got within the glacier step
    (the shared snow routines with the glacier's thresholds)."""
    (a, kw), = recorded["calls"][name]
    with jax.disable_jit():
        want = getattr(JG, name)(*a, **kw)
    fn = getattr(TG, name)
    ta, tkw = port_args(fn, a, kw, recorded["pj"], recorded["pt"])
    assert_match(want, fn(*ta, **tkw), TOL.get(name, TOL["default"]))


def test_glacier_sflx_matches_op_by_op(recorded):
    """glacier_sflx whole against the JAX one run op by op; the grid
    melts, refreezes and changes layer counts."""
    args, st = recorded["args"], recorded["st"]
    with jax.disable_jit():
        want = run(JG, recorded["pj"], args, st)
    got = run(TG, recorded["pt"], args, st)
    assert_match(want, got, TOL["glacier_sflx"])
    assert want[0]["qmelt"].max() > 0
    assert (want[1]["isnow"] != st["isnow"]).any()
    assert (args["cosz"] == 0).any()


# ---- tests/test_noahmp.py TestGlacier, side by side -------------------

# (tsk, swe, t_air, sw, lw, prcp_mm, cosz, steps) per 6-cell block
SCEN = dict(cold_stable=(255.0, 500.0, 250.0, 100.0, 180.0, 0.0, 0.3, 12),
            summer_melt=(271.0, 30.0, 283.0, 600.0, 340.0, 0.0, 0.8, 24),
            snowfall=(260.0, 20.0, 263.0, 50.0, 200.0, 3.0, 0.3, 20))


@pytest.fixture(scope="module")
def scenarios():
    """The three scenarios on one (3, 6) grid, a row each, stepped 24
    times at 1800 s; the outputs and states at each scenario's step
    count."""
    rows = list(SCEN.values())
    col = lambda i: np.repeat(np.array([r[i] for r in rows], np.float32),
                              NX).reshape(NY, NX)
    st0 = init(col(0), col(1))
    pj, pt, _, _ = params((NY, NX))
    full = lambda v: np.full((NY, NX), v, np.float32)
    dt = 1800.0
    args = dict(cosz=col(6), dt=dt, zsoil=np.asarray(JN.ZSOIL),
                sfctmp=col(2), sfcprs=full(85000.0), uu=full(5.0),
                vv=full(0.0), q2=full(0.002), soldn=col(3), lwdn=col(4),
                prcp=(col(5) / dt).astype(np.float32), tbot=full(260.0),
                ficeold=np.ones((JN.NSNOW, NY, NX), np.float32),
                zlvl=full(30.0))
    sj = st = st0
    res = {}
    for n in range(1, 25):
        oj, sj = run(JG, pj, args, sj)
        ot, st = run(TG, pt, args, st)
        assert_match((oj, sj), (ot, st), SCENARIO_TOL)
        for i, (name, r) in enumerate(SCEN.items()):
            if n == r[7]:
                res[name] = (i, ot, st)
    return st0, res


def _row(a, i):
    return np.asarray(a)[..., i, :]


def test_init_frozen(scenarios):
    """TestGlacier.test_init_frozen: the init freezes glacier ice."""
    st0, _ = scenarios
    assert np.all(st0["smc"] == 1.0) and np.all(st0["sh2o"] == 0.0)
    assert np.all(st0["stc"][JN.NSNOW:] <= 263.15)
    assert np.all(st0["sneqv"] >= 10.0)


def test_cold_stable(scenarios):
    """TestGlacier.test_cold_stable (12 steps)."""
    i, out, st = scenarios[1]["cold_stable"]
    tg = _row(st["tg"], i)
    assert np.all(np.isfinite(tg)) and np.all((tg > 230) & (tg < 274))
    assert _row(out["albedo"], i).min() > 0.4
    assert np.all(_row(st["smc"], i) <= 1.0 + 1e-6)


def test_summer_melt_runoff(scenarios):
    """TestGlacier.test_summer_melt_runoff (24 steps)."""
    i, out, st = scenarios[1]["summer_melt"]
    assert _row(st["tg"], i).max() <= 273.2
    assert _row(st["sneqv"], i).max() < 30.0
    assert _row(out["qmelt"], i).max() > 0.0
    assert _row(out["runsrf"], i).max() > 0.0
    assert np.all(np.isfinite(_row(st["stc"], i)))


def test_snowfall_on_glacier(scenarios):
    """TestGlacier.test_snowfall_on_glacier (20 steps)."""
    i, out, st = scenarios[1]["snowfall"]
    assert _row(st["sneqv"], i).min() > 20.0
    assert np.all(_row(st["isnow"], i) < 0)

"""The CLM lake (water=3): icar_tpu_torch/physics/water_lake.py against
icar_tpu/physics/water_lake.py on the CPU.

- Routine by routine: one eager JAX run of ``lake_driver`` (op by op,
  ``jax.disable_jit``) over two steps of a mixed grid -- warm, cold and
  deep lakes, no snow and one to five snow layers, snowfall and rain --
  records every routine's arguments and results; the port's routine runs
  on the same arguments. Float results within ROUTINE_BOUND of the
  field's largest value; the layer count and the ice fraction by the
  share of cells (LEVEL_SHARE); the energy-residual fluxes within
  ENERGY_ULPS of the column energy's float32 spacing over the step (the
  residual correction, water_lake.f90:2089-2123, folds the rounding of
  the column's energy, ~1e9-1e10 J m-2, into the sensible heat).
- The scenarios of tests/test_lake.py (its parity list): warm
  equilibrium, freezing cold air, snow accumulating into layers, melt,
  rain, the energy residual -- the port against the JAX ``lake_driver``
  jitted (one compilation for all), each within SCENARIO_BOUND, and the
  port held to the test's own checks.
- The pieces of tests/test_lake.py (QSat, the friction velocity, the
  tridiagonal solve) and lake_init's structure, on the port.
- tests/test_lake.py's ideal model with its lake strip run by the port:
  that test's own checks; and one substep of the port's model against one
  of the JAX model run op by op, the surface stage's fields within
  ROUTINE_BOUND (the energy-residual fluxes as above).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import water_lake as jwl
from icar_tpu_torch.physics import water_lake as twl

torch.set_num_threads(1)

# the routines recorded and replayed, inner ones first
ROUTINES = ("qsat", "monin_obukhov_init", "_profile_psi",
            "friction_velocity", "soil_therm_prop", "phase_change_lake",
            "_tridiag_column", "_lake_density", "combo",
            "_rebuild_snow_geometry", "snow_water", "snow_compaction",
            "combine_snow_layers", "divide_snow_layers", "shal_lake_fluxes",
            "shal_lake_temperature", "shal_lake_hydrology", "lake_main")
# |port - JAX| over the JAX result's largest magnitude, per routine call
ROUTINE_BOUND = 2e-5
# the share of cells whose layer count or ice fraction may differ
LEVEL_SHARE = 0.05
LEVEL_FIELDS = ("snl", "snl2d", "lake_icefrac", "lake_icefrac3d", "imelt")
# results carrying the energy residual (and what follows from it)
ENERGY_FIELDS = ("eflx_sh_grnd", "eflx_sh_tot", "eflx_soil_grnd",
                 "eflx_gnet", "errsoi", "hfx", "grdflx")
ENERGY_ULPS = 16
# the scenarios over many steps: port against the jitted JAX driver
# (the JAX package's own jitted and op-by-op runs of the warm scenario
# differ by 6.0e-5 in the latent heat; the port by 1.8e-4)
SCENARIO_BOUND = 5e-4


def _energy_bound(depth, dtime):
    """ENERGY_ULPS float32 spacings of the deepest column's latent heat
    of fusion (the largest term of its energy content) over ``dtime``."""
    e = np.float32(jwl.HFUS * jwl.DENH2O * float(np.max(depth)))
    return ENERGY_ULPS * float(np.spacing(e)) / float(dtime)


def _to_torch(x):
    if isinstance(x, (jax.Array, np.ndarray)):
        return torch.as_tensor(np.array(x))
    if callable(x) and getattr(x, "__module__", "") == jwl.__name__:
        return getattr(twl, x.__name__)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_torch(v) for v in x)
    return x


def _leaves(x, path=""):
    """(path, numpy array) of every array in a result."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, k)
    elif hasattr(x, "_fields"):
        for k in x._fields:
            yield from _leaves(getattr(x, k), k)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]" if path else str(i))
    elif torch.is_tensor(x):
        yield path, x.numpy()
    else:
        yield path, np.asarray(x)


def mixed_state():
    """A 3x8 grid of lakes from the JAX lake_init: rows warm (285 K, 20 m
    deep), cold (270 K, 5 m) and deep (275 K, 200 m); columns no snow and
    snow of one to five layers (LAKE_SMALL_SWE's values)."""
    ny, nx = 3, 8
    swe = np.array([0.0, 4.0, 7.0, 20.0, 45.0, 100.0, 200.0, 0.0],
                   np.float32)
    fields = {
        "veg_type": np.full((ny, nx), 21.0, np.float32),
        "soil_type": np.array([[6.0] * nx, [3.0] * nx, [9.0] * nx],
                              np.float32),
        "skin_temperature": np.repeat(np.array(
            [[285.0], [270.0], [275.0]], np.float32), nx, 1),
        "swe": np.repeat(swe[None], ny, 0),
        "snow_height": np.zeros((ny, nx), np.float32),
        "lake_depth": np.repeat(np.array([[20.0], [5.0], [200.0]],
                                         np.float32), nx, 1),
        "emissivity": np.full((ny, nx), 0.99, np.float32),
        "albedo": np.full((ny, nx), 0.08, np.float32),
    }
    jwl.lake_init(fields, np.full((ny, nx), 100.0, np.float32),
                  np.full((ny, nx), 45.0, np.float32))
    return {k: np.asarray(v) for k, v in fields.items()}


def mixed_forcing(ny, nx):
    """Per-row air: warm and moist with rain, cold with snow, near
    freezing with sleet; light wind, some sun."""
    row = lambda *v: np.repeat(np.array(v, np.float32)[:, None], nx, 1)
    return dict(t_1=row(285.0, 255.0, 273.5),
                p_if0=np.full((ny, nx), 101325.0, np.float32),
                p_if1=np.full((ny, nx), 100800.0, np.float32),
                dz8w_1=np.full((ny, nx), 50.0, np.float32),
                qv_1=row(0.008, 0.001, 0.004),
                u_1=np.full((ny, nx), 3.0, np.float32),
                v_1=np.full((ny, nx), 1.0, np.float32),
                glw=row(340.0, 200.0, 300.0),
                swdown=row(200.0, 50.0, 100.0),
                prec_mm=np.full((ny, nx), 2.0, np.float32),
                lat_deg=np.full((ny, nx), 45.0, np.float32))


@pytest.fixture(scope="module")
def recorded():
    """Every routine call of two eager JAX lake_driver steps on the mixed
    grid: {name: [(args, kwargs, result)]}, and the driver's own calls."""
    state = mixed_state()
    ny, nx = state["skin_temperature"].shape
    forcing = mixed_forcing(ny, nx)
    calls = {n: [] for n in ROUTINES}
    originals = {n: getattr(jwl, n) for n in ROUTINES}

    def recorder(name):
        fn = originals[name]

        def rec(*a, **k):
            out = fn(*a, **k)
            calls[name].append((a, k, out))
            return out
        return rec
    driver_calls = []
    s = {k: jnp.asarray(v) for k, v in state.items()}
    try:
        for n in ROUTINES:
            setattr(jwl, n, recorder(n))
        with jax.disable_jit():
            for _ in range(2):
                args = [s] + [jnp.asarray(forcing[k]) for k in (
                    "t_1", "p_if0", "p_if1", "dz8w_1", "qv_1", "u_1", "v_1",
                    "glw", "swdown", "prec_mm", "lat_deg")] + [
                    jnp.float32(900.0)]
                out, fields = jwl.lake_driver(*args)
                driver_calls.append((args, (out, fields)))
                s = dict(s)
                s.update(fields)
    finally:
        for n, fn in originals.items():
            setattr(jwl, n, fn)
    return dict(calls=calls, driver=driver_calls,
                depth=state["lakedepth2d"])


def _beyond(got, want, bound):
    """The share of cells where ``got`` differs from ``want`` by more than
    ``bound`` of ``want``'s largest magnitude (a layer count: at all)."""
    if not want.size:
        return 0.0
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float((np.abs(got - want) > bound * scale).mean())


def _hold(name, got, want, depth, dtime):
    """Hold a routine's result to the JAX one's; returns the largest
    relative difference of its float results (energy fields aside)."""
    worst = 0.0
    pairs = dict(_leaves(want))
    for path, g in _leaves(got):
        w = pairs[path]
        assert g.shape == w.shape, (name, path)
        field = path.split("[")[0]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer) \
                or field in LEVEL_FIELDS:
            assert _beyond(g, w, ROUTINE_BOUND) <= LEVEL_SHARE, (name, path)
            continue
        d = np.abs(g.astype(np.float64) - w)
        finite = np.isfinite(w)
        assert (np.isfinite(g) == finite).all(), (name, path)
        if not finite.any():
            continue
        if field in ENERGY_FIELDS:
            assert d[finite].max() <= _energy_bound(depth, dtime), \
                (name, path, d[finite].max())
            continue
        rel = float(d[finite].max() / max(np.abs(w[finite]).max(), 1e-30))
        assert rel <= ROUTINE_BOUND, (name, path, rel)
        worst = max(worst, rel)
    return worst


@pytest.mark.parametrize("name", ROUTINES)
def test_routine_matches_jax(recorded, name):
    """Each recorded call of ``name`` (all of the two steps') replayed in
    the port on the same arguments: float results within ROUTINE_BOUND of
    the largest magnitude, the layer count and the ice fraction by the
    share of cells, the energy-residual fluxes within ENERGY_ULPS of the
    column energy's spacing over the step."""
    calls = recorded["calls"][name]
    assert calls, name
    for a, k, want in calls:
        got = getattr(twl, name)(*_to_torch(a), **_to_torch(k))
        _hold(name, got, want, recorded["depth"], 900.0)


def test_driver_matches_jax(recorded):
    """``lake_driver`` over the two steps, each from the JAX step's
    inputs; the snow layers of every count occur in the grid."""
    for args, want in recorded["driver"]:
        got = twl.lake_driver(*_to_torch(args))
        _hold("lake_driver", got, want, recorded["depth"], 900.0)
    snl = np.asarray(recorded["driver"][0][0][0]["snl2d"])
    assert set(np.unique(snl).tolist()) == {0.0, -1.0, -2.0, -3.0, -4.0,
                                            -5.0}


# --------------------------------------------------------------------------
# the scenarios of tests/test_lake.py
# --------------------------------------------------------------------------

def make_lake_state(tsk=285.0, depth=20.0, swe=0.0, ny=2, nx=3):
    """tests/test_lake.py's make_lake_state (the JAX lake_init), numpy."""
    fields = {
        "veg_type": np.full((ny, nx), 21.0, np.float32),
        "soil_type": np.full((ny, nx), 6.0, np.float32),
        "skin_temperature": np.full((ny, nx), tsk, np.float32),
        "swe": np.full((ny, nx), swe, np.float32),
        "snow_height": np.zeros((ny, nx), np.float32),
        "lake_depth": np.full((ny, nx), depth, np.float32),
        "emissivity": np.full((ny, nx), 0.99, np.float32),
        "albedo": np.full((ny, nx), 0.08, np.float32),
    }
    jwl.lake_init(fields, np.full((ny, nx), 100.0, np.float32),
                  np.full((ny, nx), 45.0, np.float32))
    return {k: np.asarray(v) for k, v in fields.items()}


_JIT = {}


def _jax_driver():
    if "driver" not in _JIT:
        _JIT["driver"] = jax.jit(jwl.lake_driver)
    return _JIT["driver"]


class Pair:
    """The JAX (jitted) and the port's lake driver stepped side by side
    from one state, as tests/test_lake.py's ``drive`` steps them."""

    def __init__(self, state):
        self.j = {k: jnp.asarray(v) for k, v in state.items()}
        self.t = {k: torch.as_tensor(np.array(v)) for k, v in state.items()}
        self.out_j = self.out_t = None

    def drive(self, t_air=285.0, qv=0.008, wind=3.0, sw=200.0, lw=320.0,
              prec_mm=0.0, dt=600.0, nsteps=1, lat=45.0):
        ny, nx = self.t["skin_temperature"].shape
        vals = (t_air, 101325.0, 100800.0, 50.0, qv, wind, 0.0, lw, sw,
                prec_mm, lat)
        fj = [jnp.full((ny, nx), v, jnp.float32) for v in vals]
        ft = [torch.full((ny, nx), v, dtype=torch.float32) for v in vals]
        for _ in range(nsteps):
            self.out_j, fields = _jax_driver()(self.j, *fj, jnp.float32(dt))
            self.j = {**self.j, **fields}
            self.out_t, fields = twl.lake_driver(self.t, *ft,
                                                 torch.tensor(dt))
            self.t = {**self.t, **fields}
        return self

    def hold(self, dt):
        """The port's state and last outputs within SCENARIO_BOUND of the
        JAX driver's (layer count and ice fraction by share, the energy
        fluxes by the column's energy spacing); returns the worst
        relative difference."""
        worst = 0.0
        depth = np.asarray(self.j["lakedepth2d"])
        for want, got in ((self.j, self.t), (self.out_j, self.out_t)):
            for k, w in want.items():
                w = np.asarray(w, np.float64)
                g = got[k].numpy().astype(np.float64)
                assert np.isfinite(g).all() == np.isfinite(w).all(), k
                if k in LEVEL_FIELDS:
                    assert _beyond(g, w, SCENARIO_BOUND) <= LEVEL_SHARE, k
                    continue
                d = np.abs(g - w).max()
                if k in ENERGY_FIELDS:
                    assert d <= _energy_bound(depth, dt), (k, d)
                    continue
                rel = d / max(np.abs(w).max(), 1e-30)
                assert rel <= SCENARIO_BOUND, (k, rel)
                worst = max(worst, rel)
        return worst

    def port(self, k):
        return self.t[k].numpy()

    def copy(self):
        """A pair that goes on from this one's state (its own tensors; the
        JAX arrays are immutable)."""
        p = Pair.__new__(Pair)
        p.j, p.out_j = dict(self.j), self.out_j
        p.t = {k: v.clone() for k, v in self.t.items()}
        p.out_t = {k: v.clone() for k, v in self.out_t.items()}
        return p


def test_warm_equilibrium():
    p = Pair(make_lake_state(tsk=285.0)).drive(t_air=285.0, sw=200.0,
                                               lw=340.0, nsteps=12)
    p.hold(600.0)
    tsk = p.out_t["tsk"].numpy()
    assert np.all(np.isfinite(tsk)) and np.all((tsk > 275) & (tsk < 295))
    for k in ("hfx", "lh", "grdflx", "t2", "q2"):
        assert np.all(np.isfinite(p.out_t[k].numpy())), k
    assert np.all(np.abs(p.out_t["hfx"].numpy()) < 600.0)
    np.testing.assert_allclose(p.out_t["albedo"].numpy(), 0.08, atol=1e-5)


def test_freezing_cold_air():
    p = Pair(make_lake_state(tsk=274.0, depth=5.0)).drive(
        t_air=243.0, qv=2e-4, sw=0.0, lw=150.0, dt=1800.0, nsteps=100)
    p.hold(1800.0)
    icef = p.port("lake_icefrac3d")
    assert np.all(np.isfinite(icef)) and icef[0].min() > 0.0
    assert float(p.out_t["tsk"].max()) < 273.16
    assert np.all(np.diff(icef, axis=0) <= 1e-5)


# the snowfall both snow scenarios drive
SNOW = dict(t_air=260.0, qv=1e-3, sw=0.0, lw=200.0, prec_mm=2.0, dt=1800.0)


@pytest.fixture(scope="module")
def snowy():
    """A lake frozen over 60 cold steps, then 20 steps of snowfall: the
    state both snow scenarios start from, run once."""
    p = Pair(make_lake_state(tsk=270.0, depth=5.0)).drive(
        t_air=248.0, qv=2e-4, sw=0.0, lw=140.0, dt=1800.0, nsteps=60)
    assert float(p.port("lake_icefrac3d")[0].min()) > 0.5
    return p.drive(**SNOW, nsteps=20)


def test_snow_accumulation_and_layers(snowy):
    """30 steps of snowfall on the frozen lake: the snowy state's 20 and
    10 more."""
    p = snowy.copy().drive(**SNOW, nsteps=10)
    p.hold(1800.0)
    swe = p.port("swe").astype(np.float64)
    snl = p.port("snl2d")
    assert np.all(swe > 20.0) and np.all(snl < 0.0)
    smask = twl._snow_mask(torch.as_tensor(snl).to(torch.int32)).numpy()
    layer_mass = np.where(smask, p.port("h2osoi_ice3d")
                          + p.port("h2osoi_liq3d"), 0.0).sum(axis=0)
    np.testing.assert_allclose(layer_mass, swe, rtol=1e-3)


def test_snow_melts_in_warmth(snowy):
    p = snowy.copy()
    swe0 = float(p.port("swe").mean())
    assert swe0 > 10.0
    p.drive(t_air=295.0, qv=8e-3, sw=600.0, lw=380.0, dt=1800.0,
            nsteps=200)
    p.hold(1800.0)
    assert float(p.port("swe").mean()) < swe0 * 0.2
    assert np.all(np.isfinite(p.port("t_lake3d")))


def test_rain_passthrough():
    p = Pair(make_lake_state(tsk=285.0)).drive(t_air=285.0, prec_mm=5.0,
                                               nsteps=5)
    p.hold(600.0)
    assert np.all(np.isfinite(p.out_t["tsk"].numpy()))


def test_energy_residual_small():
    """tests/test_lake.py's TestConservation on the port: one hand-rolled
    flux and temperature step; the raw residual is below 2 W m-2."""
    s = {k: torch.as_tensor(np.array(v))
         for k, v in make_lake_state(tsk=283.0, depth=20.0).items()}
    ny, nx = 2, 3
    full = lambda v: torch.full((ny, nx), v, dtype=torch.float32)
    snl = torch.zeros((ny, nx), dtype=torch.int32)
    fx = twl.shal_lake_fluxes(
        full(285.0), full(100800.0), full(101325.0), full(25.0),
        full(0.008), full(3.0), full(0.0), full(320.0), full(150.0),
        full(45.0 * np.pi / 180), s["dz3d"], s["dz_lake3d"],
        s["t_soisno3d"], s["t_lake3d"], snl, s["h2osoi_liq3d"],
        s["h2osoi_ice3d"], s["savedtke12d"], s["t_grnd2d"], full(0.0))
    out = twl.shal_lake_temperature(
        fx.t_grnd, full(0.0), full(150.0), s["dz3d"], s["dz_lake3d"],
        s["z3d"], s["zi3d"], s["z_lake3d"], fx.ws, fx.ks, snl,
        fx.eflx_gnet, s["lakedepth2d"], s["lake_icefrac3d"],
        s["snow_height"], s["t_lake3d"], s["t_soisno3d"],
        s["h2osoi_liq3d"], s["h2osoi_ice3d"], s["watsat3d"],
        s["tkmg3d"], s["tkdry3d"], s["tksatu3d"], s["csol3d"],
        fx.eflx_sh_grnd, fx.eflx_sh_tot, fx.eflx_soil_grnd, 600.0)
    assert np.all(np.abs(out["errsoi"].numpy()) < 2.0)


# --------------------------------------------------------------------------
# the pieces and the init
# --------------------------------------------------------------------------

def test_pieces():
    """tests/test_lake.py's TestPieces on the port: QSat's Flatau values,
    the neutral friction velocity, the tridiagonal solve against a dense
    one with a full and a variable top."""
    es, esdT, qs, qsdT = twl.qsat(torch.tensor([293.16, 273.16]),
                                  torch.tensor([1e5, 1e5]))
    assert abs(float(es[0]) - 2339.0) < 10.0
    assert abs(float(es[1]) - 611.2) < 2.0
    assert float(esdT[0]) > 0 and float(qsdT[1]) > 0
    one = lambda v: torch.full((1, 1), v)
    ustar = twl.friction_velocity(one(10.0), one(10.0), one(10.0),
                                  one(0.001), one(0.001), one(0.001),
                                  one(1e6), one(5.0))[0]
    expected = 0.4 * 5.0 / math.log(10.0 / 0.001)
    assert abs(float(ustar[0, 0]) - expected) < 1e-3 * expected
    rng = np.random.RandomState(1)
    n = 19
    for jt in (0, 4):
        a = np.zeros((n, 1, 1), np.float32)
        b = np.full((n, 1, 1), 3.0, np.float32)
        c = np.zeros((n, 1, 1), np.float32)
        r = rng.rand(n, 1, 1).astype(np.float32)
        a[jt + 1:] = -1.0
        c[jt:-1] = -1.0
        active = np.arange(n)[:, None, None] >= jt
        is_top = np.arange(n)[:, None, None] == jt
        u = twl._tridiag_column(*(torch.as_tensor(x) for x in (
            a, b, c, r, active, is_top))).numpy()
        m = (np.diag(np.full(n - jt, 3.0)) - np.eye(n - jt, k=1)
             - np.eye(n - jt, k=-1))
        np.testing.assert_allclose(u[jt:, 0, 0],
                                   np.linalg.solve(m, r[jt:, 0, 0]),
                                   rtol=2e-4)


def test_lake_init_structure():
    """tests/test_lake.py's TestInit on the port's copy of lake_init."""
    f = {"veg_type": np.full((2, 3), 21.0), "soil_type": np.full((2, 3), 6.0),
         "skin_temperature": np.full((2, 3), 285.0, np.float32),
         "swe": np.zeros((2, 3), np.float32),
         "snow_height": np.zeros((2, 3), np.float32),
         "lake_depth": np.full((2, 3), 20.0, np.float32)}
    twl.lake_init(f, np.full((2, 3), 100.0), np.full((2, 3), 45.0))
    assert np.all(np.diff(f["z_lake3d"], axis=0) > 0)
    assert np.all(np.abs(f["dz_lake3d"].sum(axis=0) - 18.1) < 1e-3)
    assert np.all(f["lakemask"] == 1.0) and np.all(f["snl2d"] == 0.0)
    assert np.allclose(f["t_lake3d"][0], 285.0)
    np.testing.assert_allclose(f["h2osoi_vol3d"][twl.NLEVSNOW:],
                               np.minimum(1.0, f["watsat3d"]), atol=1e-6)
    s = {"veg_type": np.full((1, 4), 21.0), "soil_type": np.full((1, 4), 6.0),
         "skin_temperature": np.full((1, 4), 270.0, np.float32),
         "swe": np.array([[0.0, 4.0, 30.0, 200.0]], np.float32),
         "snow_height": np.zeros((1, 4), np.float32)}
    twl.lake_init(s, np.full((1, 4), 100.0), np.full((1, 4), 45.0))
    assert list(s["snl2d"][0]) == [0.0, -1.0, -3.0, -5.0]


# --------------------------------------------------------------------------
# the ideal model with a lake strip (tests/test_lake.py:263)
# --------------------------------------------------------------------------

STRIP = (4, 8)


def _jax_strip_model():
    from icar_tpu import constants as JC
    from icar_tpu.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=24, ny=8, nz=10, hill_height=300.0, rh=0.5,
                          water=JC.WATER_LAKE)
    s = {k: np.array(v) for k, v in m.state.items()}
    s["veg_type"][:, STRIP[0]:STRIP[1]] = 21.0
    s["skin_temperature"] = np.asarray(m.state["temperature"][0],
                                       np.float32).copy()
    s["sst"] = s["skin_temperature"].copy()
    jwl.lake_init(s, np.asarray(m.geom.terrain), np.asarray(m.geom.lat))
    st = dict(m.state)
    for k, v in s.items():
        if k in st:
            st[k] = jnp.asarray(v, st[k].dtype)
    st["land_mask"] = jnp.where(jnp.asarray(s["lakemask"]) > 0.5, 2.0,
                                st["land_mask"])
    m.state = st
    return m


def _port_strip_model(state=None):
    """The strip model in the port (chip_smoke.install_lake), or with
    ``state`` (numpy arrays) that state installed instead."""
    import chip_smoke
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=24, ny=8, nz=10, hill_height=300.0, rh=0.5,
                          water=C.WATER_LAKE, device="cpu")
    if state is None:
        return chip_smoke.install_lake(m, STRIP)
    m.state = {k: torch.as_tensor(np.array(v), dtype=m.state[k].dtype)
               for k, v in state.items()}
    return m


def test_ideal_model_with_lake():
    """tests/test_lake.py's ideal model with its lake strip, run by the
    port on the CPU over 1800 s: finite lake temperatures on the lake,
    finite sensible heat everywhere, the lake state untouched outside the
    mask."""
    m = _port_strip_model()
    m.advance(1800.0)
    lake = m.field("lakemask") > 0.5
    assert lake.sum() == 8 * (STRIP[1] - STRIP[0])
    assert np.all(np.isfinite(m.field("t_lake3d")[:, lake]))
    assert np.all(np.isfinite(m.field("sensible_heat")))
    assert np.all(m.field("snl2d")[~lake] == 0.0)


SURFACE_FIELDS = ("sensible_heat", "latent_heat", "skin_temperature",
                  "ground_heat_flux", "albedo", "t_grnd2d", "t_lake3d",
                  "lake_icefrac3d", "t_soisno3d", "savedtke12d", "swe",
                  "snow_height", "snl2d", "h2osoi_liq3d", "h2osoi_ice3d",
                  "rainbl", "temperature_2m", "humidity_2m")


def test_surface_stage_matches_jax():
    """One substep of the strip model (its surface stage: simple water on
    the water cells, then the lake) in the port and in the JAX package run
    op by op, from the same state: the surface's fields within
    ROUTINE_BOUND of their largest magnitude (the energy-residual fluxes
    within ENERGY_ULPS of the column energy's spacing over the step)."""
    import chip_smoke
    mj = _jax_strip_model()
    ref = _port_strip_model()
    # the two packages' lowest temperature (the skin's, the lake init's)
    # differs by an ulp in places: the port starts from the JAX state
    mt = _port_strip_model({k: np.asarray(v) for k, v in mj.state.items()})
    for k in chip_smoke.CATEGORIES + ("lakemask", "dz_lake3d"):
        np.testing.assert_array_equal(ref.field(k), np.asarray(mj.state[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ref.field("t_lake3d"),
                               np.asarray(mj.state["t_lake3d"]), rtol=1e-6)
    with jax.disable_jit():
        mj.advance(60.0)
    mt.advance(60.0)
    assert mj.last_n_substeps == mt.last_n_substeps == 1
    lake = mt.field("lakemask") > 0.5
    dt = 60.0 + float(mt.options.lsm.update_interval)
    for k in SURFACE_FIELDS:
        got, want = mt.field(k), np.asarray(mj.state[k], np.float64)
        d = np.abs(got - want)
        if k in ("sensible_heat", "ground_heat_flux"):
            assert d[lake].max() <= _energy_bound(
                mt.field("lakedepth2d"), dt), k
            d = d[~lake]
        assert d.max() <= ROUTINE_BOUND * max(np.abs(want).max(), 1e-30), \
            (k, d.max())
    assert (mt.field("albedo")[lake] != mt.field("albedo")[~lake][0]).all()


def test_the_lake_runs_on_the_card_by_default():
    """water=3 builds on the card unless the caller asks for the CPU:
    without a card the default raises, with one the state lives there."""
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import ideal_ridge_model
    kw = dict(nx=24, ny=8, nz=10, hill_height=300.0, rh=0.5,
              water=C.WATER_LAKE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ideal_ridge_model(**kw)
        return
    assert ideal_ridge_model(**kw).state["t_lake3d"].is_cuda

"""bench.py --config fullphys_rrtmg as bench.py builds it (models.icar
RIDGE_PATHS ``fullphys_rrtmg``: Thompson with upwind advection, wind=2,
RRTMG longwave and shortwave on the synthetic k-tables, YSU, Noah-MP with
its glacier column, simple water, Tiedtke) through the port against the
JAX package's model, on the CPU: the small case of
tests/test_torch_rrtmg_model.py (30x12x10, all land, starting at local
noon), with a strip of glacier (vegetation category 15, MODIS ice) along
the domain's south edge and snow on a few cells, so that Noah-MP starts
with one, two and three snow layers and the glacier column overrides its
cells.

- ``init_noahmp_state`` (bench.py's ``_init_noahmp_state``) equals the
  JAX sequence array for array from the same state.
- bench.py's init installs no snow-layer ice (ROADMAP section 3): from it
  one substep turns the soil under every snow-covered cell non-finite in
  the JAX package, and in the port in the same cells; 600 s spread it
  through the atmosphere. So the runs compared here start from bench.py's
  init with the fields a snow pack needs added as the file-driven driver
  installs them (chip_smoke.NOAHMP_SNOW_FIELDS).
- The JAX general loop runs jitted (``fast_path=False``); the port starts
  from the JAX model's initialised state and takes McICA's draws from
  ``JaxCdf``. One substep is held to FULLPHYS_BOUNDS; 600 s to the larger
  of FULLPHYS_BOUNDS and twice the JAX package's own spread under a
  one-ulp nudge of its initial state (tests/test_torch_rrtmg_model.py's
  rule); the snow layer count by the share of cells that differ (at most
  twice the share the nudge moves, or 2%). Both run the same substeps,
  RRTMG and Noah-MP the same number of times (a ``jax.debug.callback``
  in the JAX step, a counting wrapper in the port).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu.physics import noahmp as jnmp
from icar_tpu.physics.noah_params import load_tables as jax_noah_tables
from icar_tpu.physics.noahmp_params import load_mp_tables as jax_mp_tables
from icar_tpu.physics import rrtmg_lw as jlw
from icar_tpu.physics import rrtmg_sw as jsw
from icar_tpu.physics.rrtmg_lw_tables import synthetic_lw_tables
from icar_tpu.physics.rrtmg_sw_tables import synthetic_sw_tables
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.models.icar import (FULLPHYS_RRTMG, NOAHMP_BENCH_FIELDS,
                                        ideal_ridge_model, init_noahmp_state,
                                        synthetic_rrtmg_tables)
from icar_tpu_torch.physics import noahmp as tnmp
from test_torch_rrtmg_lw import JaxCdf
from test_torch_rrtmg_model import NOON, hold, nudged, relative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402  (its _init_noahmp_state; no jax at import)
import chip_smoke  # noqa: E402  (the small case and its bounds, no jax)

torch.set_num_threads(1)

CASE = chip_smoke.FULLPHYS_SMALL
JAX_PATH = dict(mp=JC.MP_THOMPSON, windtype=JC.WIND_CONSERVE_MASS,
                rad=JC.RA_RRTMG, pbl=JC.PBL_YSU, lsm=JC.LSM_NOAHMP,
                water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE)
# the snow layer count: the share of cells where the port's differs
LAYER_SHARE = 0.02


def prepare(state):
    """The small case's state (numpy) with the glacier strip and the snow
    (chip_smoke.noahmp_small_surface), before the Noah-MP init."""
    s = dict(state)
    s["veg_type"], s["swe"] = chip_smoke.noahmp_small_surface(
        s["veg_type"], s["swe"])
    return s


def snow_fields(before, bench_init):
    """``bench_init`` (numpy) with chip_smoke.NOAHMP_SNOW_FIELDS taken from
    the JAX noahmp_init_state on bench.py's inputs from ``before``."""
    skin = np.asarray(before["temperature"][0], np.float32)
    init = jnmp.noahmp_init_state(
        skin, before["swe"].astype(np.float32), before["snow_height"],
        np.broadcast_to(skin, before["soil_temperature"].shape).copy(),
        before["soil_water_content"], before["soil_type"],
        before["veg_type"], jax_mp_tables(), jax_noah_tables())
    out = dict(bench_init)
    for f, k in chip_smoke.NOAHMP_SNOW_FIELDS.items():
        out[f] = np.asarray(init[k], np.float32)
    return out


def _noon(o):
    o.run.start_date = NOON


def port_model():
    """The port's model of the case on the CPU, starting at local noon
    (its state is replaced before each run)."""
    def cb(o):
        synthetic_rrtmg_tables(o)
        _noon(o)
    return ideal_ridge_model(**CASE, **dict(FULLPHYS_RRTMG, options_cb=cb),
                             device="cpu")


class Pair:
    """The case on both packages: the JAX model initialised as bench.py
    does, its step jitted once (RRTMG and Noah-MP calls counted by
    jax.debug callbacks), and the port from the JAX model's state."""

    def __init__(self):
        self.calls = {"rrtmg": [], "noahmp": []}
        jlw.set_lw_tables(synthetic_lw_tables())
        jsw.set_sw_tables(synthetic_sw_tables())
        counted = {}
        for mod, name, key in ((jlw, "rrtmg_lw_driver", "rrtmg"),
                               (jnmp, "noahmp_driver", "noahmp")):
            counted[key] = (mod, name, getattr(mod, name))

        def counter(fn, key):
            def wrap(*a, **kw):
                jax.debug.callback(lambda: self.calls[key].append(1))
                return fn(*a, **kw)
            return wrap
        try:
            for key, (mod, name, fn) in counted.items():
                setattr(mod, name, counter(fn, key))
            self.jax = jax_model(**CASE, **JAX_PATH, options_cb=_noon)
            self.before = prepare({k: np.asarray(v)
                                   for k, v in self.jax.state.items()})
            self.jax.state = {k: jnp.asarray(v)
                              for k, v in self.before.items()}
            bench._init_noahmp_state(self.jax)
            self.bench = {k: np.asarray(v)
                          for k, v in self.jax.state.items()}
            self.initial = snow_fields(self.before, self.bench)
            self.step = make_step_fn(self.jax.options, self.jax.geom,
                                     self.jax.advect_names, False,
                                     fast_path=False)
            self.step({k: jnp.array(v) for k, v in self.initial.items()},
                      {}, jnp.float32(0.0), jnp.float32(1.0),
                      self.jax._time_aux(), self.jax.geom_args())
            jax.effects_barrier()
        finally:
            for key, (mod, name, fn) in counted.items():
                setattr(mod, name, fn)

    def run_jax(self, seconds, state=None):
        """The JAX step over ``seconds``: (state as numpy, substeps,
        {scheme: calls})."""
        for v in self.calls.values():
            v.clear()
        state = self.initial if state is None else state
        out, _, n = self.step({k: jnp.array(v) for k, v in state.items()},
                              {}, jnp.float32(0.0), jnp.float32(seconds),
                              self.jax._time_aux(), self.jax.geom_args())
        jax.effects_barrier()
        return ({k: np.asarray(v) for k, v in out.items()}, int(n),
                {k: len(v) for k, v in self.calls.items()})

    def run_port(self, seconds, monkeypatch, state=None):
        """The port over ``seconds`` from the JAX model's initialised
        state, with the JAX draws: (model, {scheme: calls})."""
        m = port_model()
        assert sorted(m.state) == sorted(self.initial)
        m.state = state_from_numpy(
            self.initial if state is None else state, "cpu")
        m.mcica_cdf = JaxCdf()
        n_nmp = []
        driver = tnmp.noahmp_driver

        def counted(*a, **kw):
            n_nmp.append(1)
            return driver(*a, **kw)
        monkeypatch.setattr(tnmp, "noahmp_driver", counted)
        m.advance(seconds)
        monkeypatch.setattr(tnmp, "noahmp_driver", driver)
        return m, {"rrtmg": sum(c[0] == "lw" for c in m.mcica_cdf.calls),
                   "noahmp": len(n_nmp)}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_init_matches_bench(pair):
    """init_noahmp_state from the JAX model's prepared state equals
    bench.py's _init_noahmp_state array for array (and with the snow
    fields, the JAX init's); one, two and three snow layers and the
    glacier strip are there, its soil frozen."""
    for fields, want_state in ((None, pair.bench), (dict(
            NOAHMP_BENCH_FIELDS, **chip_smoke.NOAHMP_SNOW_FIELDS),
            pair.initial)):
        m = port_model()
        m.state = state_from_numpy(pair.before, "cpu")
        init_noahmp_state(m, fields)
        assert sorted(m.state) == sorted(want_state)
        for k, want in want_state.items():
            got = m.field(k)
            assert got.dtype == np.float32, k
            np.testing.assert_array_equal(got, want, err_msg=k)
    layers = set(np.unique(pair.initial["snow_nlayers"]))
    assert {0.0, -1.0, -2.0, -3.0} <= layers, layers
    ice = pair.initial["veg_type"] == 15
    assert ice.any() and (pair.initial["soil_liquid_water"][:, ice]
                          == 0).all()
    assert (pair.initial["soil_water_content"][:, ice] == 1).all()
    assert (pair.initial["soil_temperature"][:, ice] <= 263.15).all()
    snowy = pair.initial["snow_nlayers"] < 0
    assert (pair.bench["snow_layer_ice"].sum(0)[snowy] == 0).all()
    assert (pair.initial["snow_layer_ice"].sum(0)[snowy] > 0).all()


def test_bench_init_fault_reproduced(pair, monkeypatch):
    """One substep from bench.py's own init: the soil under every cell
    that starts with snow layers turns non-finite in the JAX package
    (its snow layers hold no ice; ROADMAP section 3) and in the port in
    the same cells; every finite value within FULLPHYS_BOUNDS (cloud
    water absolutely, as below)."""
    want, _, _ = pair.run_jax(25.0, state=pair.bench)
    port, _ = pair.run_port(25.0, monkeypatch, state=pair.bench)
    bad = ~np.isfinite(want["soil_temperature"])
    snowy = pair.bench["snow_nlayers"] < 0
    assert (bad == snowy[None]).all()
    for k, w in want.items():
        g = port.field(k)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=k)
        ok = np.isfinite(w)
        if k == "cloud_water" or not ok.any():
            continue
        rel = np.abs(g[ok] - w[ok]) / max(np.abs(w[ok]).max(), 1e-30)
        bound = chip_smoke.FULLPHYS_BOUNDS[
            "species" if k in port.advect_names else "other"]
        assert rel.max() <= bound, (k, rel.max())


def _hold_with_layers(port, want, spread=None, layer_share=None):
    """``hold`` on every field but the snow layer count, which is held by
    the share of cells where it differs."""
    got = port.field("snow_nlayers")
    share = float((got != want["snow_nlayers"]).mean())
    bound = max(LAYER_SHARE, 2 * (layer_share or 0.0))
    assert share <= bound, (share, bound)
    rest = {k: v for k, v in want.items() if k != "snow_nlayers"}
    return hold(port, rest, spread)


def test_one_substep_matches(pair, monkeypatch):
    """One 25 s substep at local noon: every field within FULLPHYS_BOUNDS
    of the JAX step's (observed at most 0.60 of its bound, iwl), the cloud
    water within 2e-8 kg/kg (observed 8.0e-9), the layer counts equal;
    RRTMG and Noah-MP once on both."""
    want, n, calls = pair.run_jax(25.0)
    port, port_calls = pair.run_port(25.0, monkeypatch)
    assert all(np.isfinite(v).all() for v in want.values())
    assert port.last_n_substeps == n == 1
    assert port_calls == calls == {"rrtmg": 1, "noahmp": 1}
    np.testing.assert_array_equal(port.field("snow_nlayers"),
                                  want["snow_nlayers"])
    hold(port, {k: v for k, v in want.items() if k != "cloud_water"})
    assert np.abs(port.field("cloud_water")
                  - want["cloud_water"]).max() <= 2e-8


@pytest.fixture(scope="module")
def interval(pair):
    """600 s: the JAX run, its own spread over three one-ulp nudges (and
    the share of cells where the layer count moved), the port's run."""
    want, n, calls = pair.run_jax(600.0)
    assert all(np.isfinite(v).all() for v in want.values())
    spread = {k: 0.0 for k in want}
    layer_share = 0.0
    for seed in range(3):
        ulp, _, _ = pair.run_jax(600.0, state=nudged(pair.initial, seed))
        for k in want:
            spread[k] = max(spread[k],
                            float(relative(ulp[k], want[k]).max()))
        layer_share = max(layer_share, float(
            (ulp["snow_nlayers"] != want["snow_nlayers"]).mean()))
    mp = pytest.MonkeyPatch()
    try:
        port, port_calls = pair.run_port(600.0, mp)
    finally:
        mp.undo()
    return want, n, calls, spread, layer_share, port, port_calls


def test_same_substeps_and_calls(interval):
    """The same 24 substeps; RRTMG once, Noah-MP every 300 s of its
    counter (on the first substep and once more), on both."""
    _, n, calls, _, _, port, port_calls = interval
    assert port.last_n_substeps == n == 24
    assert port_calls == calls == {"rrtmg": 1, "noahmp": 2}


def test_fields_within_the_bounds(interval):
    """Every field within FULLPHYS_BOUNDS of the JAX model's after 600 s,
    or within twice the JAX package's own spread where that is larger
    (observed at most 0.52 of its bound, hpbl; exch_h 0.50); the layer
    counts by their share (observed: none differs; the nudged JAX runs
    move 9.2% of them). Noah-MP and the glacier column did
    work: the glacier strip's ground stays at or below freezing under
    its snow while the land around it warms, and the surface fluxes
    moved."""
    want, _, _, spread, layer_share, port, _ = interval
    _hold_with_layers(port, want, spread, layer_share)
    ice = want["veg_type"] == 15
    assert (port.field("ground_surf_temperature")[ice] <= 273.16).all()
    assert port.field("ground_surf_temperature")[~ice].max() > 280.0
    for k in ("sensible_heat", "latent_heat", "canopy_temperature",
              "snow_layer_depth"):
        assert np.abs(port.field(k)).max() > 0, k
    assert port.field("precipitation").max() > 0


def test_the_cuda_path():
    """The path launches K5 and K1 on the card; without a card the
    default device raises."""
    from icar_tpu_torch.core.step import path_kernels
    m = port_model()
    assert path_kernels(m.options) == ("mp_thompson", "advect_upwind")
    assert m.options.physics.landsurface == C.LSM_NOAHMP
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ideal_ridge_model(**CASE, **FULLPHYS_RRTMG)


def test_count_ops_noahmp(monkeypatch):
    """tools/count_ops.py ``noahmp_ops`` on the CPU: one Noah-MP call and
    one glacier call within one surface stage, each the same number of
    aten operations on another state (no column reads the host)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import count_ops
    m = chip_smoke.noahmp_small_model("cpu")
    ops = count_ops.noahmp_ops(m)
    assert ops["noahmp_driver"] > ops["glacier_sflx"] > 1000
    assert ops["surface stage (Noah-MP, glacier, simple water)"] \
        > ops["noahmp_driver"] + ops["glacier_sflx"]
    m.advance(60.0)
    assert count_ops.noahmp_ops(m) == ops

"""The RRTMG + YSU column physics (models.icar RIDGE_PATHS
``fullphys_rrtmg_noah``: bench.py --config fullphys_rrtmg with Noah in
Noah-MP's place -- Thompson with upwind advection, wind=2, RRTMG longwave
and shortwave every 1800 s with icloud 3 on the synthetic k-tables, Noah
with simple water, YSU and Tiedtke) through the port against the JAX
package's model, on the CPU, over one 600 s interval of the small case of
tests/test_torch_fullphys.py (30x12x10, hill 600 m, u 9 m/s, rh 1.0) with
the run starting at local noon (2020-12-01 19:00 UTC at 105 W), so that
the shortwave does work.

The small case runs all land here: with that test's strip of open water
the JAX package's own run turns non-finite within the interval (at the
domain's edge, where ustar is 0, the water surface's latent heat runs
away once YSU mixes it; ROADMAP section 3), and the port reproduces it.

The JAX general loop runs jitted (``fast_path=False``); the port starts
from the JAX model's own state and takes McICA's draws from ``JaxCdf``,
the JAX package's own. Both run RRTMG on the interval's first substep
(its counter starts full) and the same number of times in all (counted
by a ``jax.debug.callback`` in the JAX step and by the draws in the
port). Each field is held to chip_smoke.py's FULLPHYS_BOUNDS: the largest
difference over the largest magnitude, 1e-4 for the advected species and
1e-3 for every other field, the cloud fraction and the longwave by the
share of columns past 1e-3 (at most 5%): after one substep (at noon and
at bench.py's start, after sunset), and after 600 s where the JAX
package's own spread under a one-ulp nudge of its initial state does not
pass it (else twice that spread).
``Pair`` is shared with tests/test_torch_rrtmg_simple_sw.py.
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
from icar_tpu.physics import rrtmg_lw as jlw
from icar_tpu.physics import rrtmg_sw as jsw
from icar_tpu.physics.rrtmg_lw_tables import synthetic_lw_tables
from icar_tpu.physics.rrtmg_sw_tables import synthetic_sw_tables
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.models.icar import (FULLPHYS_RRTMG_NOAH,
                                        ideal_ridge_model,
                                        synthetic_rrtmg_tables)
from test_torch_rrtmg_lw import JaxCdf

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the small case and its bounds, no jax)

torch.set_num_threads(1)

CASE = chip_smoke.FULLPHYS_SMALL
NOON = "2020-12-01 19:00:00"
JAX_RRTMG = dict(mp=JC.MP_THOMPSON, windtype=JC.WIND_CONSERVE_MASS,
                 rad=JC.RA_RRTMG, pbl=JC.PBL_YSU, lsm=JC.LSM_NOAH,
                 water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE)


# fields the one-ulp nudge leaves alone: categories stored as floats
CATEGORIES = ("land_mask", "veg_type", "soil_type")


def nudged(state, seed=0):
    """``state`` with every nonzero value of every float field but the
    CATEGORIES one ulp up or down (seeded): rounding-sized differences
    everywhere, as two builds of the same arithmetic differ."""
    r = np.random.default_rng(seed)
    out = dict(state)
    for k, a in state.items():
        if a.dtype != np.float32 or k in CATEGORIES:
            continue
        up = r.uniform(size=a.shape) < 0.5
        out[k] = np.where(a != 0, np.nextafter(a, np.where(
            up, np.inf, -np.inf).astype(a.dtype)), a)
    return out


class Pair:
    """The case on both packages: the JAX model (its step jitted once,
    fast_path=False, on the synthetic k-tables, its RRTMG calls counted by
    a jax.debug.callback) and the port's, both from the JAX model's
    initial state; ``simple_sw`` selects use_simple_sw. Each run starts
    at the interval's beginning with the solar geometry of ``start``."""

    def __init__(self, simple_sw=False):
        self.simple_sw = simple_sw
        self.calls = []
        jlw.set_lw_tables(synthetic_lw_tables())
        jsw.set_sw_tables(synthetic_sw_tables())
        driver = jlw.rrtmg_lw_driver

        def counted(*args, **kw):
            jax.debug.callback(lambda: self.calls.append(1))
            return driver(*args, **kw)
        try:
            jlw.rrtmg_lw_driver = counted
            self.jax = jax_model(**CASE, **JAX_RRTMG, options_cb=self._cb)
            self.step = make_step_fn(self.jax.options, self.jax.geom,
                                     self.jax.advect_names, False,
                                     fast_path=False)
            self.initial = {k: np.asarray(v)
                            for k, v in self.jax.state.items()}
            self.step({k: jnp.array(v) for k, v in self.initial.items()},
                      {}, jnp.float32(0.0), jnp.float32(1.0),
                      self.jax._time_aux(), self.jax.geom_args())
        finally:
            jlw.rrtmg_lw_driver = driver
        self.calls.clear()

    def _cb(self, o, start=NOON):
        o.run.start_date = start
        o.rad.use_simple_sw = self.simple_sw

    def run_jax(self, seconds, start=NOON, state=None):
        """The JAX step over ``seconds``: (state as numpy, substeps, RRTMG
        calls)."""
        self.jax.options.run.start_date = start
        self.calls.clear()
        state = self.initial if state is None else state
        out, _, n = self.step({k: jnp.array(v) for k, v in state.items()},
                              {}, jnp.float32(0.0), jnp.float32(seconds),
                              self.jax._time_aux(), self.jax.geom_args())
        jax.effects_barrier()
        return ({k: np.asarray(v) for k, v in out.items()}, int(n),
                len(self.calls))

    def run_port(self, seconds, start=NOON):
        """The port over ``seconds`` with the JAX draws: (model, RRTMG
        calls)."""
        def cb(o):
            synthetic_rrtmg_tables(o)
            self._cb(o, start)
        m = ideal_ridge_model(**CASE, **dict(FULLPHYS_RRTMG_NOAH,
                                             options_cb=cb), device="cpu")
        assert sorted(m.state) == sorted(self.initial)
        m.state = state_from_numpy(self.initial, "cpu")
        m.mcica_cdf = JaxCdf()
        m.advance(seconds)
        return m, sum(c[0] == "lw" for c in m.mcica_cdf.calls)


# the 600 s comparison's bound on a field, in units of the JAX package's
# own spread (interval_runs), as tests/test_torch_column_general.py holds
# the SB04 paths
SPREAD_FACTOR = 2


def relative(got, want):
    """|got - want| / max |want| per cell."""
    want = np.asarray(want, np.float64)
    return np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)


def hold(port, final, spread=None, absolute=None):
    """Every field of ``port`` within FULLPHYS_BOUNDS of ``final`` (the
    ill-conditioned two by the share of columns), or within
    SPREAD_FACTOR times its ``spread`` where that is larger, or within its
    ``absolute`` bound; returns {field: (largest relative difference,
    bound)}."""
    worst = {}
    for k, want in final.items():
        got = port.field(k)
        assert np.isfinite(got).all(), k
        if absolute and k in absolute:
            assert np.abs(got - want).max() <= absolute[k], k
            continue
        rel = relative(got, want)
        bound = chip_smoke.FULLPHYS_BOUNDS[
            "species" if k in port.advect_names else "other"]
        if spread is not None:
            bound = max(bound, SPREAD_FACTOR * spread[k])
        if k in chip_smoke.FULLPHYS_ILL_CONDITIONED:
            assert (rel > bound).mean() <= chip_smoke.FULLPHYS_ILL_SHARE, k
        else:
            assert rel.max() <= bound, (k, rel.max(), bound)
        worst[k] = (float(rel.max()), bound)
    return worst


# the first substep's cloud water is a few 1e-6 kg/kg just condensing,
# held absolutely (kg/kg; observed 9.9e-9 at noon, 1.0e-9 at night)
ONE_SUBSTEP_ABS = {"cloud_water": 2e-8}
NIGHT = "2020-12-01 00:00:00"


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.mark.parametrize("start", [NOON, NIGHT], ids=["noon", "night"])
def test_one_substep_matches(pair, start):
    """One 25 s substep at local noon and at bench.py's start (17:00
    local, after sunset): every field within FULLPHYS_BOUNDS of the JAX
    step's (observed at most 4.4e-4 of a field's largest value but for
    the cloud water), the cloud water within ONE_SUBSTEP_ABS; RRTMG once
    on both; the shortwave and its heating nonzero at noon, exactly 0 at
    night on both."""
    want, n, calls = pair.run_jax(25.0, start)
    port, port_calls = pair.run_port(25.0, start)
    assert port.last_n_substeps == n == 1
    assert port_calls == calls == 1
    hold(port, want, absolute=ONE_SUBSTEP_ABS)
    for k in ("shortwave", "tend_th_swrad", "shortwave_direct"):
        if start == NOON:
            assert want[k].max() > 0, k
        else:
            assert (want[k] == 0).all() and (port.field(k) == 0).all(), k


def interval_runs(pair, seconds=600.0, start=NOON):
    """``seconds`` from the JAX model's state: the JAX run, its own spread
    (the largest relative difference of each field over runs started one
    ulp away, ``nudged``, three seeds), the port's run:
    (want, substeps, RRTMG calls, spread, port, port's RRTMG calls)."""
    want, n, calls = pair.run_jax(seconds, start)
    spread = {k: 0.0 for k in want}
    for seed in range(3):
        first = nudged(pair.initial, seed)
        assert (first["potential_temperature"]
                != pair.initial["potential_temperature"]).all()
        ulp, _, _ = pair.run_jax(seconds, start, state=first)
        for k in want:
            spread[k] = max(spread[k],
                            float(relative(ulp[k], want[k]).max()))
    port, port_calls = pair.run_port(seconds, start)
    return want, n, calls, spread, port, port_calls


@pytest.fixture(scope="module")
def interval(pair):
    return interval_runs(pair)


def test_same_substeps_and_rrtmg_calls(interval):
    """The same 24 substeps; RRTMG once, on the first (its counter starts
    full, and 600 s is short of the next 1800 s); the port's draws for
    interval time 0, one chunk each of the shortwave and the longwave."""
    _, n, calls, _, port, port_calls = interval
    assert port.last_n_substeps == n == 24
    assert port_calls == calls == 1
    assert [c[:2] for c in port.mcica_cdf.calls] == [("sw", 0.0),
                                                     ("lw", 0.0)]


def test_fields_within_the_fullphys_bounds(interval):
    """Every field within FULLPHYS_BOUNDS of the JAX model's after 600 s,
    or within twice the JAX package's own spread where that is larger
    (SPREAD_FACTOR). At rh 1.0 YSU's PBL top (a level index) and the
    thresholds of Thompson and Tiedtke turn rounding into finite changes
    within a few substeps: one ulp on the initial state moves the JAX
    package's own precipitation by 96% of its largest value, exch_h by
    53%, its rain mass by 7.0% and its water vapour by 1.6% (the largest
    of three seeds), and on the domain's edge, where ustar and the 10 m
    winds are 0, YSU's hpbl follows the compiler's rounding (ROADMAP
    section 3). The port lies as far from the JAX run as the nudged JAX
    runs do: observed at most 0.52 of its bound (latent heat; rain mass
    0.50). The radiation did work: longwave cooling, shortwave heating
    and sunshine at the surface, its direct part below the total."""
    want, _, _, spread, port, _ = interval
    hold(port, want, spread)
    for k in ("tend_th_lwrad", "tend_th_swrad", "shortwave",
              "shortwave_direct", "longwave", "cloud_fraction", "hpbl",
              "exch_h"):
        assert np.abs(want[k]).max() > 0, k
    assert want["shortwave"].max() > 20.0         # under 0.8 cloud cover
    assert want["tend_th_swrad"].max() > 0 > want["tend_th_lwrad"].min()
    np.testing.assert_array_less(want["shortwave_direct"],
                                 want["shortwave"] + 1e-3)
    for k in ("convective_precipitation", "precipitation"):
        assert port.field(k).max() > 0, k


def test_the_cuda_path_and_a_mesh():
    """The path launches K5 and K1 on the card (K5 at most 1565 levels);
    without a card the default device raises; on a mesh (refused until the
    column loop ran on blocks) the case takes the unsharded run's
    substeps and every bit of every field, RRTMG's McICA draws
    included."""
    from icar_tpu_torch.core.step import path_kernels
    from icar_tpu_torch.parallel.mesh import make_mesh
    models = []
    for mesh in (None, make_mesh(CASE["nx"], CASE["ny"],
                                 devices=["cpu"] * 4)):
        m = ideal_ridge_model(**CASE, **FULLPHYS_RRTMG_NOAH, device="cpu")
        assert path_kernels(m.options) == ("mp_thompson", "advect_upwind")
        if mesh is not None:
            m.attach_mesh(mesh)
        m.advance(40.0)
        models.append(m)
    one, sharded = models
    assert sharded.last_n_substeps == one.last_n_substeps >= 2
    for k in one.state:
        np.testing.assert_array_equal(sharded.field(k).view(np.uint32),
                                      one.field(k).view(np.uint32),
                                      err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ideal_ridge_model(**CASE, **FULLPHYS_RRTMG_NOAH)


@pytest.mark.parametrize("option,value,match", [
    # two cases whose ids are kept from their earlier examples, Noah-MP
    # and then the forcing's surface fluxes, then WSM6, and the lake (each
    # ported since: tests/test_torch_noahmp_model.py, tests/test_torch_
    # mp_models.py, tests/test_torch_lake_driver.py), holding the other
    # convection schemes, which are ported since too (match None)
    pytest.param("convection", C.CU_BMJ, None,
                 id="landsurface-4-Slice F \\(Noah-MP"),
    pytest.param("convection", C.CU_NSAS, None,
                 id="watersurface-3-Slice F \\(lake\\)"),
    # Thompson-aerosol, refused until it was ported (its id kept): it now
    # runs too (match None), its radii reaching RRTMG
    pytest.param("microphysics", C.MP_THOMPSON_AER, None,
                 id="microphysics-5-Slice F \\(Thompson-aerosol"),
    pytest.param("convection", C.CU_KF, None,
                 id="convection-3-Slice F \\(the other schemes\\)")])
def test_the_rest_of_slice_f_still_raises(option, value, match):
    """What Slice F left runs under RRTMG and YSU now (``match`` None):
    the other convection schemes and Thompson-aerosol build and run one
    60 s interval with finite fields, NSAS reading the PBL height YSU
    forms; with Thompson-aerosol the effective radii the microphysics
    formed move off the registry's defaults somewhere."""
    def cb(o):
        synthetic_rrtmg_tables(o)
        setattr(o.physics, option, value)
    if match is None:
        m = ideal_ridge_model(**CASE, **dict(FULLPHYS_RRTMG_NOAH,
                                             options_cb=cb), device="cpu")
        m.advance(60.0)
        assert m.last_n_substeps > 0
        for k in m.state:
            assert np.isfinite(m.field(k)).all(), k
        assert float(m.field("hpbl").max()) > 0
        if value == C.MP_THOMPSON_AER:
            assert float(m.field("re_cloud").max()) > 2.49e-6 or \
                float(m.field("re_ice").max()) > 4.99e-6
        return
    with pytest.raises(NotImplementedError, match=match):
        ideal_ridge_model(**CASE, **dict(FULLPHYS_RRTMG_NOAH,
                                         options_cb=cb), device="cpu")

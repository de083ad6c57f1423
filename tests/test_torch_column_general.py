"""The column physics with MPDATA or with SB04 (models.icar RIDGE_PATHS
``fullphys_mpdata`` and ``fullphys_sb04``) through the port against the
JAX package's model, on the CPU, at tests/test_torch_fullphys.py's size
and water strip.

fullphys_mpdata is the fullphys schemes with MPDATA advection: the column
stages, Thompson (K5's plain version) and MPDATA (K4's) on the nine
species. fullphys_sb04 is the fullphys schemes with SB04 and without
Tiedtke (the options refuse SB04 with a deep convection scheme, in both
packages): the column stages, SB04 (K3's) with the refreshed density and
K1's on the five species; the PBL mixes the cloud ice SB04's state does
not hold as zeros, as the JAX loop does. The JAX general loop runs jitted
(its step built with ``fast_path=False``), the port from the JAX model's
own state, and each field is held as tests/test_torch_fullphys.py holds
the fullphys ridge: the largest difference over the largest magnitude,
1e-4 for the advected species and 1e-3 for every other field
(chip_smoke.py FULLPHYS_BOUNDS), the cloud fraction and longwave by the
share of columns past 1e-3 (at most 5%). SB04 at rh 1.0 sits on its
saturation revert edge (ROADMAP section 3), so where the JAX package's own
one-ulp spread passes a bound, the port is held to twice that spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import path_kernels, run_interval
from icar_tpu_torch.models.icar import RIDGE_PATHS, ideal_ridge_model
from icar_tpu_torch.ops import kernels

torch.set_num_threads(1)

CASE = dict(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0, u_speed=9.0,
            rh=1.0)
JAX_PATHS = {
    "fullphys_mpdata": dict(mp=JC.MP_THOMPSON, adv=JC.ADV_MPDATA,
                            windtype=JC.WIND_CONSERVE_MASS, rad=JC.RA_SIMPLE,
                            pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH,
                            water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE),
    "fullphys_sb04": dict(mp=JC.MP_SIMPLE, windtype=JC.WIND_CONSERVE_MASS,
                          rad=JC.RA_SIMPLE, pbl=JC.PBL_SIMPLE,
                          lsm=JC.LSM_NOAH, water=JC.WATER_SIMPLE)}
KERNELS = {"fullphys_mpdata": ("mp_thompson", "advect_mpdata"),
           "fullphys_sb04": ("mp_simple_rho", "advect_upwind")}
ILL_CONDITIONED = ("cloud_fraction", "longwave")
# tests/test_torch_fullphys.py's absolute bounds after one substep for the
# fields the first surface call forms from nearly cancelling terms or from
# nothing, in the field's units
ONE_SUBSTEP_ABS = {"ground_heat_flux": 2e-3, "sensible_heat": 0.05,
                   "canopy_water": 2e-9, "runoff_surface": 1e-10}


@pytest.fixture(scope="module", params=sorted(JAX_PATHS))
def jax_general(request):
    """(path, the JAX model with its step built with fast_path=False, its
    initial state as numpy arrays with the water strip set)."""
    m = jax_model(**CASE, **JAX_PATHS[request.param])
    lm = np.asarray(m.state["land_mask"]).copy()
    lm[:, :10] = 2.0
    m.state = dict(m.state)
    m.state["land_mask"] = jnp.asarray(lm)
    m._step_fn = make_step_fn(m.options, m.geom, m.advect_names, False,
                              fast_path=False)
    return request.param, m, {k: np.asarray(v) for k, v in m.state.items()}


def _port(path, initial):
    m = ideal_ridge_model(**CASE, **RIDGE_PATHS[path], device="cpu")
    m.state = state_from_numpy(initial, "cpu")
    return m


def _worst(got, want):
    """max |got - want| / max |want| (0 where both are all zero)."""
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def _hold(got, want, advected, absolute=None, spread=None):
    """Each field of ``got`` against ``want``: finite; the fields of
    ``absolute`` within their bound; ILL_CONDITIONED by the share of
    cells past 1e-3 of the largest value; the others within
    FULLPHYS_BOUNDS of their largest value, or within twice ``spread``
    (the JAX package's own one-ulp spread, the same measure) where that is
    larger."""
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert np.isfinite(g).all(), k
        if absolute and k in absolute:
            assert np.abs(g - w).max() <= absolute[k], k
        elif k in ILL_CONDITIONED:
            rel = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
            assert (rel > 1e-3).mean() <= 0.05, k
        else:
            bound = 1e-4 if k in advected else 1e-3
            if spread is not None:
                bound = max(bound, 2 * spread[k])
            assert _worst(g, w) <= bound, (k, _worst(g, w), bound)


def test_path_and_state(jax_general):
    """The port starts where the JAX model starts (each field within 1e-6
    of its largest magnitude, the water strip apart), holds the same
    fields (SB04's state no cloud ice without Tiedtke), and launches the
    path's kernels on the card: K5 and K4, or K3 and K1."""
    path, _, initial = jax_general
    mt = ideal_ridge_model(**CASE, **RIDGE_PATHS[path], device="cpu")
    assert sorted(mt.state) == sorted(initial)
    for k, want in initial.items():
        if k != "land_mask":
            assert _worst(mt.state[k].numpy(), want) <= 1e-6, k
    assert path_kernels(mt.options) == KERNELS[path]
    assert ("cloud_ice" in mt.state) == (path == "fullphys_mpdata")


def _jax_run(mj, initial, seconds):
    """The JAX step over one interval of ``seconds`` from ``initial``:
    (state as numpy arrays, substeps)."""
    out, _, n = mj._step_fn({k: jnp.array(v) for k, v in initial.items()},
                            {}, jnp.float32(0.0), jnp.float32(seconds),
                            mj._time_aux(), mj.geom_args())
    return {k: np.asarray(v) for k, v in out.items()}, int(n)


def _spread(mj, initial, want, seconds):
    """The JAX package's own one-ulp spread: each field's largest change
    over its largest magnitude when theta and water vapour start one ulp
    up or down per cell (seeded), as chip_smoke.py's golden ensemble
    perturbs them."""
    r = np.random.default_rng(0)
    nudged = dict(initial)
    for k in ("potential_temperature", "water_vapor"):
        a = initial[k]
        to = np.where(r.uniform(size=a.shape) < 0.5, np.inf, -np.inf)
        nudged[k] = np.nextafter(a, to.astype(np.float32))
    other, _ = _jax_run(mj, nudged, seconds)
    return {k: _worst(other[k], want[k]) for k in want}


@pytest.mark.parametrize("seconds", [20.0, 600.0])
def test_interval_matches(jax_general, seconds):
    """One substep of 20 s (the fields of ONE_SUBSTEP_ABS within their
    absolute bounds) and one interval of 600 s: the same substeps, no
    kernel launched by the plain versions, every field within
    FULLPHYS_BOUNDS of the JAX model's, or within twice the JAX package's
    own one-ulp spread where SB04's saturation revert makes that larger
    (fullphys_sb04 at rh 1.0: after 600 s the port's rain mass differs by
    1.5e-3 of its largest value, 2.9e-6 kg/kg, and a one-ulp nudge moves
    the JAX package's own by 2.6e-3); cloud in both and, over the
    interval, sensible heat of both signs and convective rain with
    Tiedtke (fullphys_mpdata)."""
    path, mj, initial = jax_general
    want, n = _jax_run(mj, initial, seconds)
    mt = _port(path, initial)
    before = dict(kernels.LAUNCHES)
    got, n_t = run_interval(mt.state, mt.geom_t, mt.options,
                            mt.advect_names, seconds,
                            time_aux=mt._time_aux())
    assert n_t == n == (1 if seconds == 20.0 else 24)
    assert kernels.LAUNCHES == before
    assert sorted(got) == sorted(want)
    got = {k: v.numpy() for k, v in got.items()}
    _hold(got, want, mt.advect_names,
          absolute=ONE_SUBSTEP_ABS if seconds == 20.0 else None,
          spread=_spread(mj, initial, want, seconds))
    for m in (got, want):
        assert m["cloud_water"].max() > 0
        if seconds > 20.0:
            assert m["sensible_heat"].min() < 0 < m["sensible_heat"].max()
        if seconds > 20.0 and path == "fullphys_mpdata":
            assert m["convective_precipitation"].max() > 0

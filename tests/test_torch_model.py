"""The port's model and interval loop against the JAX package's.

(a) The golden ridge case (tools/make_golden.py CASE) through the port on
the CPU: the same substep count as tests/golden/ideal_ridge_100.npz, and
fields within the bounds chip_smoke.py holds the card to. (b) A JAX
model's state carried across with convert.state_from_numpy, then one
interval in both packages, without and with boundary forcing.

This case branches on one-ulp differences (the 15-sweep saturation revert
of SB04), so over a whole 1800 s interval the two packages agree in the
substep count and within the spread the JAX package itself shows under
one-ulp perturbations, not cell by cell; over a short interval of three
substeps (the near-end clamp and a shortened last substep included) they
agree cell by cell at rtol 1e-5, atol 1e-7 (precipitation rtol 1e-4).
"""

import os
import sys

import numpy as np
import pytest
import torch

from icar_tpu import constants as C
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import quantized_dt
from icar_tpu_torch.models.icar import ICARModel, ideal_ridge_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (golden case and bounds, no jax)

PROGNOSTICS = ("potential_temperature", "water_vapor", "cloud_water",
               "rain_mass", "snow_mass")
TEST_CASE = dict(nx=64, ny=20, nz=12, dx=1000.0, hill_height=800.0,
                 u_speed=11.0, rh=1.0)   # tests/test_fast_path.py's model


def test_golden_case_on_cpu():
    ref = np.load(chip_smoke.GOLDEN)
    m = ideal_ridge_model(**chip_smoke.GOLDEN_CASE, device="cpu")
    steps = 0
    while steps < chip_smoke.GOLDEN_MIN_STEPS:
        m.advance(chip_smoke.GOLDEN_INTERVAL)
        steps += m.last_n_substeps
    assert steps == int(ref["steps"])
    report, failed = chip_smoke.golden_mismatches(
        {f: m.field(f) for f in chip_smoke.GOLDEN_ATOL}, ref)
    assert not failed, "\n".join(report)


def _pair(forcing):
    mj = jax_model(**TEST_CASE)
    mt = ideal_ridge_model(**TEST_CASE, device="cpu")
    mt.state = state_from_numpy({k: np.asarray(v)
                                 for k, v in mj.state.items()}, "cpu")
    if forcing:
        r = np.random.default_rng(3)
        shp = mt.state["water_vapor"].shape
        dqdt = {"potential_temperature":
                r.uniform(-1e-4, 1e-4, shp).astype(np.float32),
                "water_vapor": r.uniform(-1e-6, 2e-8, shp).astype(np.float32)}
        mj.set_forcing_tendencies(dqdt)
        mt.set_forcing_tendencies(dqdt)
    return mj, mt


@pytest.mark.parametrize("forcing", [False, True])
def test_short_interval_matches_jax(forcing):
    mj, mt = _pair(forcing)
    s, g = mt.state, mt.geom_t
    dt = quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx, 0.9, 3)
    seconds = float(np.float32(2.5) * dt)
    mj.advance(seconds)
    mt.advance(seconds)
    assert mt.last_n_substeps == mj.last_n_substeps == 3
    for k in PROGNOSTICS:
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("precipitation", "snowfall"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("forcing", [False, True])
def test_interval_matches_jax(forcing):
    mj, mt = _pair(forcing)
    mj.advance(1800.0)
    mt.advance(1800.0)
    assert mt.last_n_substeps == mj.last_n_substeps
    for k, bound in chip_smoke.ENSEMBLE_MAX.items():
        got, want = mt.field(k), np.asarray(mj.field(k))
        d = np.abs(got - want)
        assert np.isfinite(got).all(), k
        assert (d <= bound + 1e-4 * np.abs(want)).all(), (k, d.max())
        assert d.mean() <= chip_smoke.ENSEMBLE_MEAN[k], (k, d.mean())
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("option,value", [
    ("microphysics", C.MP_THOMPSON), ("microphysics", C.MP_NONE),
    ("advection", C.ADV_MPDATA), ("windtype", C.WIND_LINEAR),
    ("windtype", C.WIND_ITERATIVE), ("radiation", C.RA_SIMPLE),
    ("boundarylayer", C.PBL_SIMPLE), ("landsurface", C.LSM_NOAH),
    ("watersurface", C.WATER_LAKE), ("convection", C.CU_TIEDTKE),
])
def test_unported_options_raise(option, value):
    def cb(o):
        setattr(o.physics, option, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ideal_ridge_model(nx=20, ny=8, nz=10, options_cb=cb, device="cpu")


@pytest.mark.parametrize("what", ["advect_density", "mp_update_interval"])
def test_unported_run_options_raise(what):
    def cb(o):
        if what == "advect_density":
            o.run.advect_density = True
        else:
            o.mp.update_interval = 300.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ideal_ridge_model(nx=20, ny=8, nz=10, options_cb=cb, device="cpu")


def test_wind_forcing_not_ported():
    m = ideal_ridge_model(nx=20, ny=8, nz=12, hill_height=800.0, device="cpu")
    with pytest.raises(NotImplementedError, match="Slice E"):
        m.set_forcing_tendencies({"u": np.zeros((12, 8, 21), np.float32)})


def test_device_is_required():
    from icar_tpu_torch.config import Options
    with pytest.raises(TypeError):
        ideal_ridge_model(nx=20, ny=8, nz=10)
    with pytest.raises(TypeError):
        ICARModel(Options(), np.zeros((8, 20)), np.zeros((8, 20)),
                  np.zeros((8, 20)))

"""The Thompson ridge (mp=1 with MPDATA advection) of the port against the
JAX package's model, on the CPU.

The JAX model runs its general loop jitted (Thompson through the jnp path,
as on a CPU); the port's model starts from the JAX model's state
(convert.state_from_numpy) and runs its plain versions of K5 and K4. The
bounds over a whole interval are those the JAX package allows between its
own kernel and jnp paths (tests/test_step_thompson_stack.py): species rtol
1e-3, atol 1e-6; precipitation, snowfall and graupel rtol 1e-4, atol 1e-7.
"""

import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import kernels

torch.set_num_threads(1)

# tests/test_step_thompson_stack.py's case
CASE = dict(nx=48, ny=20, nz=12, dx=1000.0, hill_height=800.0, u_speed=11.0,
            rh=1.0)
# bench.py --config mpdata_thompson's parameters at a small size
BENCH = dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1000.0,
             u_speed=10.0, rh=0.95, flat_z_height=-5)
ACCUMULATORS = ("precipitation", "snowfall", "graupel")


# the JAX step of each case, compiled once: a later model of the same case
# (the same options and geometry) takes the first one's
_STEPS = {}


def _pair(kw):
    mj = jax_model(**kw, mp=JC.MP_THOMPSON, adv=JC.ADV_MPDATA)
    key = tuple(sorted(kw.items()))
    if key not in _STEPS:
        mj._build_step()
        _STEPS[key] = mj._step_fn
    mj._step_fn = _STEPS[key]
    mt = ideal_ridge_model(**kw, mp=C.MP_THOMPSON, adv=C.ADV_MPDATA,
                           device="cpu")
    mt.state = state_from_numpy({k: np.asarray(v)
                                 for k, v in mj.state.items()}, "cpu")
    return mj, mt


def _check(mj, mt, rtol, atol, number_atol, accum_rtol, accum_atol):
    """Species within (rtol, atol) -- the number mixing ratios (kg-1, up to
    ~1e4 here) within (rtol, number_atol) -- and the accumulators within
    (accum_rtol, accum_atol)."""
    assert mt.last_n_substeps == mj.last_n_substeps
    for k in mt.advect_names:
        a = number_atol if k.endswith("_number") else atol
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=rtol, atol=a, err_msg=k)
    for k in ACCUMULATORS:
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=accum_rtol, atol=accum_atol,
                                   err_msg=k)


@pytest.mark.parametrize("kw,seconds,substeps,number_atol", [
    (CASE, 900.0, 17, 1e-6), (BENCH, 1200.0, 22, 1e-4)])
def test_thompson_ridge_interval_matches_jax(kw, seconds, substeps,
                                             number_atol):
    """One whole interval. Observed on the CPU: theta max |d| 1.2e-4 K,
    rain number 0.3 kg-1 of 1.6e4, precipitation 7.5e-7 mm of 0.048. At
    the bench's parameters rain number differs by up to 2.3e-5 kg-1 where
    it is ~2e-3 (1e-3 relative there, 7e-10 of its maximum of 3.4e4), so
    its atol is 1e-4 there."""
    mj, mt = _pair(kw)
    mj.advance(seconds)
    mt.advance(seconds)
    assert mt.last_n_substeps == substeps
    _check(mj, mt, 1e-3, 1e-6, number_atol, 1e-4, 1e-7)
    assert mt.field("cloud_water").max() > 0
    assert mt.field("precipitation").max() > 0


def test_thompson_ridge_three_substeps_match_tightly():
    """Three substeps (157.5 s), held tighter: species atol 1e-7 (observed
    3.0e-8, cloud water), rain number atol 2e-2 (observed 8.8e-3 of 131),
    accumulators atol 1e-9 (observed 7.1e-10), rtol 1e-3 and 1e-4 as
    above."""
    mj, mt = _pair(CASE)
    mj.advance(157.5)
    mt.advance(157.5)
    assert mt.last_n_substeps == 3
    _check(mj, mt, 1e-3, 1e-7, 2e-2, 1e-4, 1e-9)


def test_thompson_ridge_takes_the_plain_versions_on_the_cpu():
    m = ideal_ridge_model(nx=24, ny=8, nz=12, hill_height=800.0,
                          mp=C.MP_THOMPSON, adv=C.ADV_MPDATA, device="cpu")
    assert len(m.advect_names) == 9
    kernels.reset_launches()
    m.advance(300.0)
    assert m.last_n_substeps > 0
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mp,adv,match", [
    # Thompson without advection, refused until it was ported (its id
    # kept): it now builds and runs one interval (match None), K5's plain
    # version on the unadvected stack
    pytest.param(C.MP_THOMPSON, C.ADV_NONE, None,
                 id="1-0-Slice B \\(advection options\\)"),
    # Thompson-aerosol, refused until it was ported (its id kept): it now
    # builds and runs one interval with MPDATA (match None), K5 then the
    # effective radii, giving mp=1's fields
    pytest.param(C.MP_THOMPSON_AER, C.ADV_MPDATA, None,
                 id="5-2-Thompson-aerosol"),
])
def test_unported_thompson_options_raise(mp, adv, match):
    if match is None and mp == C.MP_THOMPSON_AER:
        kw = dict(nx=20, ny=8, nz=12, hill_height=800.0, adv=adv,
                  device="cpu")
        m = ideal_ridge_model(**kw, mp=mp)
        ref = ideal_ridge_model(**kw, mp=C.MP_THOMPSON)
        m.advance(300.0)
        ref.advance(300.0)
        assert m.last_n_substeps == ref.last_n_substeps > 1
        for k in ref.state:
            np.testing.assert_array_equal(m.field(k), ref.field(k),
                                          err_msg=k)
        for k in ("re_cloud", "re_ice", "re_snow"):
            assert np.isfinite(m.field(k)).all(), k
        return
    if match is None:
        m = ideal_ridge_model(nx=20, ny=8, nz=12, hill_height=800.0,
                              mp=mp, adv=adv, device="cpu")
        before = m.field("water_vapor")
        m.advance(300.0)
        assert m.last_n_substeps > 1
        for k in m.state:
            assert np.isfinite(m.field(k)).all(), k
        # nothing advects, and the ridge's subsaturated air at rest gives
        # the microphysics nothing to do
        np.testing.assert_array_equal(m.field("water_vapor"), before)
        return
    with pytest.raises(NotImplementedError, match=match):
        ideal_ridge_model(nx=20, ny=8, nz=10, mp=mp, adv=adv, device="cpu")


@pytest.mark.parametrize("names,adv", [(slice(0, 5), C.ADV_MPDATA),
                                       (slice(0, 5), C.ADV_UPWIND)])
def test_run_interval_refuses_what_it_does_not_run(names, adv):
    """The loop runs Thompson only on its nine species, with either
    advection; anything else is refused before a substep."""
    from icar_tpu_torch.core.step import run_interval
    m = ideal_ridge_model(nx=20, ny=8, nz=12, hill_height=800.0,
                          mp=C.MP_THOMPSON, adv=C.ADV_MPDATA, device="cpu")
    m.options.physics.advection = adv
    with pytest.raises(ValueError, match="not a configuration it runs"):
        run_interval(m.state, m.geom_t, m.options, m.advect_names[names],
                     60.0)

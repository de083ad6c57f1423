"""The port's Noah land-surface model (``physics/lsm_noah.py``) against
the JAX package's ``noah_driver``, on seeded grids of cells that cover
bare, vegetated, urban and glacier land, water cells outside the land
mask, snow and no snow (fresh snowfall, melting and cold packs), frozen
and thawing soil, rain and dry air, day and night.

The JAX driver runs op by op (``jax.disable_jit()``); both sides take the
built-in tables (``noah_params.load_tables``; the port's copy is held to
the original by tests/test_torch_setup.py). Every output field is held to
rtol 1e-5 and an atol of 1e-5 of the field's largest magnitude: the
largest difference observed is 1.7e-6 of a field's largest value
(sensible heat and snowmelt; exp, log and pow differ between the
libraries by an ulp,
and the port divides by a constant as a product with its float32
reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import lsm_noah as J
from icar_tpu.physics.noah_params import load_tables as jax_tables
from icar_tpu_torch.physics import lsm_noah as T
from icar_tpu_torch.physics.noah_params import load_tables

torch.set_num_threads(1)

RTOL, ATOL_FRAC = 1e-5, 1e-5

ARGS = ("dz0 qv0 p_i0 p_i1 t0 exner0 psfc tsk chs glw swdown albedo_prev "
        "emiss_prev precip_delta dt vegtyp soiltyp shdfac snoalb tbot land "
        "cmc stc smc sh2o sneqv_mm snowh sncovr_prev snotime1 "
        "z0brd_state").split()
# bare (16), urban (13), glacier (15) and vegetated classes
VEG = [2, 5, 7, 10, 12, 13, 14, 15, 16, 18]
SOIL = [1, 3, 4, 6, 8, 11, 12, 14, 16]


def inputs(seed, ny=8, nx=12):
    """Seeded driver inputs (numpy)."""
    r = np.random.default_rng(seed)

    def f(lo, hi):
        return r.uniform(lo, hi, (ny, nx)).astype(np.float32)

    def some(frac):
        return r.uniform(size=(ny, nx)) < frac
    t0 = np.where(some(0.4), f(255, 272), f(275, 305)).astype(np.float32)
    snow = some(0.4)
    swe = np.where(snow, f(0.5, 60), 0).astype(np.float32)
    stc_top = np.where(some(0.4), f(262, 272.5), f(274, 300))
    stc = np.stack([stc_top + d for d in (0, 1.0, 2.5, 4.0)]
                   ).astype(np.float32)
    smc = r.uniform(0.08, 0.42, (4, ny, nx)).astype(np.float32)
    sh2o = np.where(stc < 273.15, smc * r.uniform(0.2, 0.9, smc.shape),
                    smc).astype(np.float32)
    p0 = f(9.2e4, 1.01e5)
    return dict(
        dz0=f(40, 60), qv0=f(1e-3, 1.5e-2), p_i0=p0,
        p_i1=(p0 - f(400, 700)).astype(np.float32), t0=t0,
        exner0=f(0.97, 1.0), psfc=p0, tsk=(t0 + f(-3, 4)).astype(np.float32),
        chs=f(0.002, 0.05), glw=f(200, 400),
        swdown=np.where(some(0.3), 0, f(50, 900)).astype(np.float32),
        albedo_prev=f(0.12, 0.6), emiss_prev=f(0.9, 0.99),
        precip_delta=np.where(some(0.5), f(0.0, 3.0), 0).astype(np.float32),
        dt=np.float32(300.0), vegtyp=r.choice(VEG, (ny, nx)).astype(np.int32),
        soiltyp=r.choice(SOIL, (ny, nx)).astype(np.int32),
        shdfac=f(0.0, 1.0), snoalb=f(0.5, 0.8), tbot=f(280, 290),
        land=some(0.85),
        cmc=np.where(some(0.5), f(0, 5e-4), 0).astype(np.float32),
        stc=stc, smc=smc, sh2o=sh2o, sneqv_mm=swe,
        snowh=np.where(snow & some(0.7), swe * 0.004, 0).astype(np.float32),
        sncovr_prev=np.where(snow, f(0.2, 1.0), 0).astype(np.float32),
        snotime1=np.where(snow, f(0, 5e5), 0).astype(np.float32),
        z0brd_state=f(0.01, 0.5))


def run_both(d):
    with jax.disable_jit():
        want = J.noah_driver(jax_tables(), *[jnp.asarray(d[k])
                                             for k in ARGS])
    got = T.noah_driver(load_tables(), *[torch.as_tensor(d[k])
                                         for k in ARGS])
    return ({k: np.array(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def check(want, got):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=RTOL,
            atol=ATOL_FRAC * max(float(np.abs(w).max()), 1e-30), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noah_driver_matches(seed):
    d = inputs(seed)
    want, got = run_both(d)
    check(want, got)
    land = d["land"] & (d["vegtyp"] != 15)
    # the inputs reach every branch the docstring lists
    assert (land & (d["sneqv_mm"] > 0)).any()
    assert (land & (d["sneqv_mm"] == 0)).any()
    assert (land & (d["stc"][0] < 273.15)).any()
    assert (land & (d["vegtyp"] == 16)).any()
    assert ((~land) & d["land"]).any() and (~d["land"]).any()
    # ... and the outputs show them: melt, runoff, frozen-soil phase change
    assert want["snowmelt"].max() > 0
    assert want["runoff_surface"].max() > 0
    sh2o = want["soil_liquid_water"]
    assert ((sh2o != d["sh2o"]) & (d["stc"] < 273.15)).any()
    # cells outside the land (or on glacier) keep their state
    keep = ~land
    np.testing.assert_array_equal(got["soil_temperature"][:, keep],
                                  d["stc"][:, keep])
    np.testing.assert_array_equal(got["hfx"][keep], 0.0)


def test_noah_driver_matches_over_chained_steps():
    """Four 300 s steps, each starting from the last one's state, on one
    seeded grid (snow accumulating and melting, soil freezing)."""
    d = inputs(3)
    state_keys = dict(tsk="skin_temperature", cmc="canopy_water",
                      sneqv_mm="swe", snowh="snow_height",
                      sncovr_prev="snow_cover", albedo_prev="albedo",
                      emiss_prev="emissivity", snotime1="snotime",
                      stc="soil_temperature", smc="soil_water_content",
                      sh2o="soil_liquid_water")
    dj, dt_ = dict(d), dict(d)
    for _ in range(4):
        want, _unused = run_both(dj)
        _unused, got = run_both(dt_)
        check(want, got)
        for a, b in state_keys.items():
            dj[a] = want[b]
            dt_[a] = got[b]


def test_noah_helpers_match():
    """frh2o (10 Newton steps) and rosr12 (the tridiagonal solve) alone,
    within rtol 1e-6."""
    r = np.random.default_rng(4)
    shape = (5, 7)
    t = r.uniform(255, 280, shape).astype(np.float32)
    smc = r.uniform(0.1, 0.45, shape).astype(np.float32)
    sh2o = (smc * r.uniform(0.2, 1.0, shape)).astype(np.float32)
    smcmax = np.full(shape, 0.45, np.float32)
    bexp = r.uniform(3, 11, shape).astype(np.float32)
    psis = r.uniform(0.03, 0.7, shape).astype(np.float32)
    args = (t, smc, sh2o, smcmax, bexp, psis)
    with jax.disable_jit():
        want = np.asarray(J.frh2o(*[jnp.asarray(a) for a in args]))
    got = T.frh2o(*[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert ((want < smc) & (t < 273.0)).any()
    a = np.zeros((4,) + shape, np.float32)
    a[1:] = r.uniform(-0.2, 0, (3,) + shape)
    b = (1 + r.uniform(0, 0.5, (4,) + shape)).astype(np.float32)
    c = np.zeros((4,) + shape, np.float32)
    c[:-1] = r.uniform(-0.2, 0, (3,) + shape)
    d = r.uniform(-1, 1, (4,) + shape).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(J.rosr12(*[jnp.asarray(x) for x in (a, b, c, d)]))
    got = T.rosr12(*[torch.as_tensor(x) for x in (a, b, c, d)]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

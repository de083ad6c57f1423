"""The port's model and interval loop against the JAX package's.

(a) The golden ridge case (tools/make_golden.py CASE) through the port on
the CPU: the same substep count as tests/golden/ideal_ridge_100.npz, and
fields within the bounds chip_smoke.py holds the card to. (b) A JAX
model's state carried across with convert.state_from_numpy, then one
interval in both packages, without and with boundary forcing. (c) The same
for the MPDATA ridge (SB04 + MPDATA, the JAX package's general loop):
cell by cell off SB04's revert edge (rh 0.9), and within the spread bounds
below on it (the bench's rh 0.95).

This case branches on one-ulp differences (the 15-sweep saturation revert
of SB04), so over a whole 1800 s interval the two packages agree in the
substep count and within the spread the JAX package itself shows under
one-ulp perturbations, not cell by cell; over a short interval of three
substeps (the near-end clamp and a shortened last substep included) they
agree cell by cell at rtol 1e-5, atol 1e-7 (precipitation rtol 1e-4).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as C
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import quantized_dt
from icar_tpu_torch.models.icar import (ICARModel, ideal_ridge_model,
                                        synthetic_rrtmg_tables)

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


def _pair(forcing, case=TEST_CASE, options_cb=None):
    mj = jax_model(**case, options_cb=options_cb)
    mt = ideal_ridge_model(**case, options_cb=options_cb, device="cpu")
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
    ("microphysics", C.MP_MORRISON), ("microphysics", C.MP_NONE),
    ("advection", C.ADV_NONE), ("microphysics", C.MP_WSM6),
    ("radiation", C.RA_RRTMG), ("radiation", C.RA_SIMPLE),
    ("boundarylayer", C.PBL_SIMPLE), ("landsurface", C.LSM_NOAH),
    ("watersurface", C.WATER_LAKE), ("convection", C.CU_TIEDTKE),
])
def test_unported_options_raise(option, value):
    """Options outside the port raise NotImplementedError naming their
    ROADMAP slice. The column physics with SB04 (radiation, the PBL and
    Noah here, and RRTMG on the synthetic k-tables), no microphysics, no
    advection, the CLM lake (here without lake cells) and Morrison and
    WSM6 have been ported since: those options build and run one interval
    with finite fields; Tiedtke with SB04 is refused by the options' own
    validation (ValueError), as in the JAX package."""
    def cb(o):
        if value == C.RA_RRTMG and option == "radiation":
            synthetic_rrtmg_tables(o)
        setattr(o.physics, option, value)
    if (option, value) in (COLUMN_WITH_SB04 | NO_SCHEME_OR_LAKE
                           | OTHER_MICROPHYSICS):
        _runs_one_interval(cb)
        return
    if (option, value) == ("convection", C.CU_TIEDTKE):
        with pytest.raises(ValueError, match="not tuned for use with deep "
                                             "convection"):
            ideal_ridge_model(nx=20, ny=8, nz=10, options_cb=cb,
                              device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ideal_ridge_model(nx=20, ny=8, nz=10, options_cb=cb, device="cpu")


# the column physics with SB04, ported since test_unported_options_raise
# listed it
COLUMN_WITH_SB04 = {("radiation", C.RA_SIMPLE),
                    ("boundarylayer", C.PBL_SIMPLE),
                    ("landsurface", C.LSM_NOAH),
                    ("radiation", C.RA_RRTMG)}


# no microphysics, no advection and the lake, ported since
# test_unported_options_raise listed them
NO_SCHEME_OR_LAKE = {("microphysics", C.MP_NONE),
                     ("advection", C.ADV_NONE),
                     ("watersurface", C.WATER_LAKE)}


# Morrison and WSM6, ported since test_unported_options_raise listed them
# (tests/test_torch_mp_models.py holds them to the JAX package's model)
OTHER_MICROPHYSICS = {("microphysics", C.MP_MORRISON),
                      ("microphysics", C.MP_WSM6)}


def _runs_one_interval(options_cb):
    """The ridge with ``options_cb`` builds on the CPU and runs one 300 s
    interval with finite fields."""
    m = ideal_ridge_model(nx=20, ny=8, nz=12, hill_height=800.0,
                          options_cb=options_cb, device="cpu")
    m.advance(300.0)
    assert m.last_n_substeps > 1
    for k in m.state:
        assert np.isfinite(m.field(k)).all(), k


@pytest.mark.parametrize("what", ["advect_density", "mp_update_interval"])
def test_unported_run_options_raise(what):
    """Density advection and the microphysics throttle, which raised until
    they were ported: each builds and runs one interval with finite
    fields (their parity with the JAX package: tests/test_torch_density.py
    and tests/test_torch_mp_throttle.py)."""
    def cb(o):
        if what == "advect_density":
            o.run.advect_density = True
        else:
            o.mp.update_interval = 300.0
    _runs_one_interval(cb)


def test_wind_forcing_not_ported():
    """Forcing tendencies outside the advected species (here u), refused
    on a sharded model until they ran on blocks (the name is kept): set
    before attach_mesh or after it, an interval on a mesh of four CPU
    devices equals the unsharded run's in every bit of every field."""
    from icar_tpu_torch.parallel.mesh import make_mesh
    u = {"u": np.random.default_rng(3).uniform(
        1e-3, 3e-3, (12, 8, 21)).astype(np.float32)}
    runs = []
    for mesh, late in ((None, False), (make_mesh(20, 8, devices=[
            "cpu"] * 4), False), (make_mesh(20, 8, devices=["cpu"] * 4),
                                  True)):
        m = ideal_ridge_model(nx=20, ny=8, nz=12, hill_height=800.0,
                              device="cpu")
        if not late:
            m.set_forcing_tendencies(u)
        if mesh is not None:
            m.attach_mesh(mesh)
        if late:
            m.set_forcing_tendencies(u)
        m.advance(300.0)
        runs.append(m)
    one = runs[0]
    for other in runs[1:]:
        assert other.last_n_substeps == one.last_n_substeps > 1
        for k in one.state:
            np.testing.assert_array_equal(
                other.field(k).view(np.uint32),
                one.field(k).view(np.uint32), err_msg=k)


def test_device_is_required():
    """The device defaults to the card; without one the model refuses to
    start rather than run on the CPU."""
    import inspect
    from icar_tpu_torch.config import Options
    for fn in (ideal_ridge_model, ICARModel):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ideal_ridge_model(nx=20, ny=8, nz=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ICARModel(Options(), np.zeros((8, 20)), np.zeros((8, 20)),
                  np.zeros((8, 20)))


# each path and the kernel of it that takes the fewest levels
# (kernels.MAX_NZ: 64 for K4, the most a one-column tile of K2/K3 holds)
PATHS = [(C.MP_SIMPLE, C.ADV_UPWIND, "mp_simple"),
         (C.MP_SIMPLE, C.ADV_MPDATA, "advect_mpdata"),
         (C.MP_THOMPSON, C.ADV_MPDATA, "advect_mpdata")]


@pytest.mark.parametrize("mp,adv,kernel", PATHS)
def test_card_model_deeper_than_its_kernels_is_refused(mp, adv, kernel):
    """On the card, one level more than the path's shallowest kernel takes
    is refused at construction with a ValueError naming that kernel,
    before the no-card check and before any state is built; on the CPU a
    model deeper than 64 levels builds."""
    from icar_tpu_torch.ops import kernels
    top = kernels.MAX_NZ[kernel]
    with pytest.raises(ValueError, match=f"nz={top + 1} exceeds the {top} "
                                         f"levels kernel {kernel} takes"):
        ideal_ridge_model(nx=20, ny=8, nz=top + 1, mp=mp, adv=adv,
                          device="cuda")
    m = ideal_ridge_model(nx=20, ny=8, nz=65, mp=mp, adv=adv, device="cpu")
    assert m.state["pressure"].shape == (65, 8, 20)


@pytest.mark.parametrize("mp,adv,kernel", PATHS)
def test_card_model_at_64_levels_passes_the_level_check(mp, adv, kernel):
    """nz = 64, and the limit of the path's shallowest kernel, pass every
    kernel's limit on each path, one level more raises naming that kernel;
    without a card the model then stops at the no-card check."""
    from icar_tpu_torch.core.step import path_kernels
    from icar_tpu_torch.ops import kernels
    m = ideal_ridge_model(nx=20, ny=8, nz=64, mp=mp, adv=adv, device="cpu")
    path = path_kernels(m.options)
    assert kernel in path
    top = kernels.MAX_NZ[kernel]
    assert top == min(kernels.MAX_NZ[k] for k in path
                      if kernels.MAX_NZ[k] is not None)
    kernels.check_levels(path, 64)
    kernels.check_levels(path, top)
    with pytest.raises(ValueError, match=kernel):
        kernels.check_levels(path, top + 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ideal_ridge_model(nx=20, ny=8, nz=64, mp=mp, adv=adv)


@pytest.mark.parametrize("mp,adv,kernel", PATHS)
def test_card_model_at_80_levels_needs_the_upwind_path(mp, adv, kernel):
    """K2 takes more than 64 levels since its tiled redesign: a card-path
    upwind model at nz = 80 passes the level check (without a card it then
    stops at the no-card check), and the MPDATA paths still refuse it,
    naming K4."""
    from icar_tpu_torch.core.step import path_kernels
    from icar_tpu_torch.ops import kernels
    m = ideal_ridge_model(nx=20, ny=8, nz=80, mp=mp, adv=adv, device="cpu")
    path = path_kernels(m.options)
    if adv == C.ADV_UPWIND:
        kernels.check_levels(path, 80)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ideal_ridge_model(nx=20, ny=8, nz=80, mp=mp, adv=adv)
    else:
        with pytest.raises(ValueError, match="nz=80 exceeds the 64 levels "
                                             "kernel advect_mpdata takes"):
            ideal_ridge_model(nx=20, ny=8, nz=80, mp=mp, adv=adv,
                              device="cuda")


# ---------------------------------------------------------------------------
# (c) the MPDATA ridge: SB04 with the state's density (K3) + MPDATA (K4)
# ---------------------------------------------------------------------------

# rh 0.9 keeps the case off SB04's 15-sweep revert edge, so the two
# packages agree to a few ulp over a whole interval. The bench's rh 0.95
# (BENCH_MPDATA_CASE) sits on that edge: there the JAX package itself,
# rerun with theta and qv nudged by one ulp, leaves the tight tolerance
# (asserted in test_mpdata_bench_case_interval_within_the_spread).
MPDATA_CASE = dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1200.0,
                   u_speed=10.0, rh=0.9, adv=C.ADV_MPDATA)
# bench.py's MPDATA ridge (its defaults: hill 1000 m, u 10 m/s, rh 0.95)
# cut to 40x12x12
BENCH_MPDATA_CASE = dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1000.0,
                         u_speed=10.0, rh=0.95, adv=C.ADV_MPDATA)


def _mpdata_options(order, fct):
    def cb(o):
        o.adv.mpdata_order = order
        o.adv.flux_corrected_transport = fct
    return cb


def _assert_fields_match(mt, mj, rtol, atol, precip_rtol, precip_atol):
    for k in PROGNOSTICS:
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in ("precipitation", "snowfall"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=precip_rtol, atol=precip_atol,
                                   err_msg=k)


@pytest.mark.parametrize("order,fct,forcing", [
    (2, True, False), (2, True, True), (3, True, False), (2, False, False)])
def test_mpdata_short_interval_matches_jax(order, fct, forcing):
    """Three substeps (a shortened last one and the near-end clamp
    included), cell by cell at rtol 1e-5, atol 1e-7 (precipitation rtol
    1e-4): SB04's exp differs by an ulp between the libraries."""
    mj, mt = _pair(forcing, MPDATA_CASE, _mpdata_options(order, fct))
    s, g = mt.state, mt.geom_t
    dt = quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx, 0.9, 3)
    seconds = float(np.float32(2.5) * dt)
    mj.advance(seconds)
    mt.advance(seconds)
    assert mt.last_n_substeps == mj.last_n_substeps == 3
    _assert_fields_match(mt, mj, 1e-5, 1e-7, 1e-4, 1e-7)


def test_mpdata_interval_matches_jax():
    """One 1200 s interval (24 substeps): the same substep count, fields at
    rtol 1e-5, atol 1e-7, precipitation at rtol 1e-4, atol 2e-5 (24
    float32 additions per cell; 8.5e-6 mm seen on cells of 0.05 mm), and a
    cloud that rains."""
    mj, mt = _pair(False, MPDATA_CASE)
    mj.advance(1200.0)
    mt.advance(1200.0)
    assert mt.last_n_substeps == mj.last_n_substeps == 24
    _assert_fields_match(mt, mj, 1e-5, 1e-7, 1e-4, 2e-5)
    assert mt.field("cloud_water").max() > 1e-4
    assert mt.field("precipitation").max() > 0.5
    for k in ("u", "v", "w"):
        np.testing.assert_array_equal(mt.field(k), np.asarray(mj.field(k)))


def _nudged_jax_model(case, seed):
    """The JAX model of ``case`` with theta and qv each moved one ulp up or
    down per cell (seeded)."""
    m = jax_model(**case)
    r = np.random.default_rng(seed)
    m.state = dict(m.state)
    for k in ("potential_temperature", "water_vapor"):
        a = np.asarray(m.state[k])
        to = np.where(r.uniform(size=a.shape) < 0.5, np.inf, -np.inf)
        m.state[k] = jnp.asarray(np.nextafter(a, to.astype(np.float32)))
    return m


def _leaves_tight_tolerance(got, want):
    """Whether ``got`` leaves test_mpdata_interval_matches_jax's tolerance
    of ``want`` in some field."""
    for k in PROGNOSTICS + ("precipitation",):
        rtol, atol = (1e-4, 2e-5) if k == "precipitation" else (1e-5, 1e-7)
        if not np.allclose(got[k], want[k], rtol=rtol, atol=atol):
            return True
    return False


def test_mpdata_bench_case_interval_within_the_spread():
    """bench.py's MPDATA ridge (rh 0.95) over one 1200 s interval. It sits
    on SB04's revert edge: the JAX package rerun with theta and qv nudged
    by one ulp leaves the tight tolerance. So, as for the golden case, the
    port is held to the same substep count (22), the winds, and twice the
    JAX package's one-ulp spread of the golden case (chip_smoke.py
    ENSEMBLE_MAX per cell, ENSEMBLE_MEAN as a domain mean)."""
    mj, mt = _pair(False, BENCH_MPDATA_CASE)
    nudged = _nudged_jax_model(BENCH_MPDATA_CASE, 0)
    mj._build_step()
    nudged._step_fn = mj._step_fn  # the same case: one compilation
    for m in (mj, mt, nudged):
        m.advance(1200.0)
    assert (mt.last_n_substeps == mj.last_n_substeps
            == nudged.last_n_substeps == 22)
    fields = PROGNOSTICS + ("precipitation",)
    want = {k: np.asarray(mj.field(k)) for k in fields}
    assert _leaves_tight_tolerance(
        {k: np.asarray(nudged.field(k)) for k in fields}, want)
    for k, bound in chip_smoke.ENSEMBLE_MAX.items():
        got = mt.field(k)
        d = np.abs(got - want[k])
        assert np.isfinite(got).all(), k
        assert (d <= bound + 1e-4 * np.abs(want[k])).all(), (k, d.max())
        assert d.mean() <= chip_smoke.ENSEMBLE_MEAN[k], (k, d.mean())
    for k in ("u", "v", "w", "snowfall"):
        np.testing.assert_array_equal(mt.field(k), np.asarray(mj.field(k)))

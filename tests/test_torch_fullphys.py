"""The full-physics ridge (bench.py --config fullphys: Thompson with upwind
advection, wind=2, simple radiation, Noah with simple water, the simple
PBL and Tiedtke convection) through the port against the JAX package's
model, on the CPU, at a test size: 30x12x10, hill 600 m, u 9 m/s, rh 1.0,
with a strip of open water (land_mask 2 in the first ten columns, as
tests/test_composed_substep.py sets one) so that both surface schemes
work. Every scheme does real work there: convective rain, sensible heat
of both signs, soil temperatures that move.

The JAX general loop runs jitted (its step built by ``make_step_fn``
with ``fast_path=False``); the port starts from the JAX model's own state
(``convert.state_from_numpy``, the land and soil fields included) and
runs the plain versions of K5 and K1. The jitted JAX loop contracts
multiply-adds and folds divisions by constants; the port folds the
divisions alike but not the multiply-adds, and the schemes branch on
thresholds, so each field is held to a bound on its largest difference
relative to its largest magnitude, stated per group with what was
observed.

Also: options outside the slice raise naming their ROADMAP slice, the
case on a mesh equals its unsharded run, and the path's kernels and
level limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import path_kernels, run_interval
from icar_tpu_torch.models.icar import (FULLPHYS, ideal_ridge_model,
                                        synthetic_rrtmg_tables)
from icar_tpu_torch.ops import kernels

torch.set_num_threads(1)

CASE = dict(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0, u_speed=9.0,
            rh=1.0)
JAX_FULLPHYS = dict(mp=JC.MP_THOMPSON, windtype=JC.WIND_CONSERVE_MASS,
                    rad=JC.RA_SIMPLE, pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH,
                    water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE)

# the fields the comparisons single out, besides every advected species
SURFACE = ("convective_precipitation", "precipitation", "sensible_heat",
           "latent_heat", "soil_temperature", "skin_temperature",
           "soil_water_content", "ground_heat_flux", "tend_qv_adv",
           "tend_qv_pbl")


@pytest.fixture(scope="module")
def jax_fullphys():
    """The JAX model (its step built with fast_path=False) and its initial
    state as numpy arrays, the water strip set."""
    m = jax_model(**CASE, **JAX_FULLPHYS)
    lm = np.asarray(m.state["land_mask"]).copy()
    lm[:, :10] = 2.0
    m.state = dict(m.state)
    m.state["land_mask"] = jnp.asarray(lm)
    m._step_fn = make_step_fn(m.options, m.geom, m.advect_names, False,
                              fast_path=False)
    return m, {k: np.asarray(v) for k, v in m.state.items()}


def _port(initial):
    m = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    m.state = state_from_numpy(initial, "cpu")
    return m


def _worst(got, want):
    """max |got - want| / max |want| (0 where want is all zero and got
    equals it)."""
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def test_port_starts_where_the_jax_model_starts(jax_fullphys):
    """The port's own initial state (geometry, sounding, wind=2 winds, the
    surface start at the lowest level's temperature) equals the JAX
    model's, apart from the water strip set above: each field within
    1e-6 of its largest magnitude."""
    _, initial = jax_fullphys
    mt = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    assert sorted(mt.state) == sorted(initial)
    for k, want in initial.items():
        if k != "land_mask":
            assert _worst(mt.state[k].numpy(), want) <= 1e-6, k
    for k in ("skin_temperature", "sst", "soil_temperature",
              "soil_deep_temperature"):
        assert mt.state[k].min() > 280.0, k


# Xu-Randall's cloud fraction (and the longwave, which scales with it) is
# ill-conditioned where a column holds almost no condensate: it takes the
# 0.25 power of (1 - rh) * qc, so a column sum of about 1e-12 kg/kg (which
# the near-end clamp has not yet removed) against an exact 0 moves it
# between ~0.2 and ~0.6. These two are held by the share of columns that
# differ.
ILL_CONDITIONED = ("cloud_fraction", "longwave")

# the fields the first substep's surface call forms from nearly
# cancelling terms (or that start there from nothing), held to an
# absolute bound after one substep: the largest difference observed, then
# the bound, in the field's units
ONE_SUBSTEP_ABS = {"ground_heat_flux": (3.0e-4, 2e-3),    # W m-2
                   "sensible_heat": (7.0e-3, 0.05),       # W m-2
                   "canopy_water": (2.3e-10, 2e-9),       # kg m-2
                   "runoff_surface": (2.8e-13, 1e-10),    # mm
                   "cloud_water": (8.2e-10, 1e-8),        # kg kg-1
                   "iwl": (3.1e-7, 3e-6)}                 # kg m-2


def test_one_substep_matches(jax_fullphys):
    """One 20 s substep (a): JAX's step against ``run_interval``. The
    fields of ONE_SUBSTEP_ABS within their absolute bounds; every other
    field within 5e-5 of its largest magnitude (observed at most 1.5e-5,
    the PBL's moisture tendency; theta and water vapour below 1.3e-7)."""
    mj, initial = jax_fullphys
    state = {k: jnp.array(v) for k, v in initial.items()}
    want, _, n = mj._step_fn(state, {}, jnp.float32(0.0), jnp.float32(20.0),
                             mj._time_aux(), mj.geom_args())
    assert int(n) == 1
    mt = _port(initial)
    got, n = run_interval(mt.state, mt.geom_t, mt.options, mt.advect_names,
                          20.0, time_aux=mt._time_aux())
    assert n == 1
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ONE_SUBSTEP_ABS:
            d = np.abs(got[k].numpy() - np.asarray(want[k])).max()
            assert d <= ONE_SUBSTEP_ABS[k][1], (k, d)
        else:
            assert _worst(got[k].numpy(), want[k]) <= 5e-5, k


def test_interval_matches(jax_fullphys):
    """One 600 s interval (b): the same 24 substeps, convective rain in
    both. Bounds on the largest difference over the largest magnitude:
    the advected species 1e-4 (observed at most 1.3e-5, cloud water),
    every other field 1e-3 (observed at most 2.6e-4, convective
    precipitation), except the cloud fraction and longwave
    (ILL_CONDITIONED), which may pass 1e-3 in at most 5% of the columns
    (observed in none; the cloud fraction's largest difference 6.9e-4)."""
    mj, initial = jax_fullphys
    mt = _port(initial)
    mj.advance(600.0)
    mt.advance(600.0)
    assert mt.last_n_substeps == mj.last_n_substeps == 24
    for k in mt.state:
        got, want = mt.field(k), np.asarray(mj.field(k))
        if k in ILL_CONDITIONED:
            rel = np.abs(got - want) / np.abs(want).max()
            assert (rel > 1e-3).mean() <= 0.05, k
        else:
            bound = 1e-4 if k in mt.advect_names else 1e-3
            assert _worst(got, want) <= bound, k
    for k in SURFACE:
        assert np.abs(np.asarray(mj.field(k))).max() > 0, k
    for m in (mt.field, mj.field):
        assert np.asarray(m("convective_precipitation")).max() > 0
        sh = np.asarray(m("sensible_heat"))
        assert sh.min() < 0 < sh.max()
        assert np.asarray(m("cloud_water")).max() > 0



def test_short_interval_with_forcing_matches(jax_fullphys):
    """An 80 s interval (four substeps, the near-end clamp after the
    boundary relaxation, a shortened last substep) with seeded forcing
    tendencies of theta and water vapour: JAX's step built with forcing
    against ``run_interval``. The surface fields of ONE_SUBSTEP_ABS
    (ground and sensible heat, canopy water, runoff) within their
    absolute bounds; the cloud fraction and longwave beyond 1e-3 of their
    largest values in at most 5% of the columns (observed 10 of 360,
    2.8%: one ridge column with no condensate, ILL_CONDITIONED); every
    other field within 3e-4 of its largest magnitude (observed at most
    1.3e-4, the PBL's moisture tendency; rain number 1.0e-4, rain mass
    8.1e-5)."""
    mj, initial = jax_fullphys
    r = np.random.default_rng(5)
    shape = initial["potential_temperature"].shape
    dqdt = {"potential_temperature":
            r.uniform(-2e-4, 2e-4, shape).astype(np.float32),
            "water_vapor": r.uniform(-1e-7, 1e-7, shape).astype(np.float32)}
    step = make_step_fn(mj.options, mj.geom, mj.advect_names, True,
                        fast_path=False)
    want, _, n = step({k: jnp.array(v) for k, v in initial.items()},
                      {k: jnp.asarray(v) for k, v in dqdt.items()},
                      jnp.float32(0.0), jnp.float32(80.0), mj._time_aux(),
                      mj.geom_args())
    mt = _port(initial)
    got, n_t = run_interval(mt.state, mt.geom_t, mt.options,
                            mt.advect_names, 80.0,
                            {k: torch.tensor(v) for k, v in dqdt.items()},
                            time_aux=mt._time_aux())
    assert n_t == int(n) == 4
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("ground_heat_flux", "sensible_heat", "canopy_water",
                 "runoff_surface"):
            assert np.abs(g - w).max() <= ONE_SUBSTEP_ABS[k][1], k
        elif k in ILL_CONDITIONED:
            rel = np.abs(g - w) / np.abs(w).max()
            assert (rel > 1e-3).mean() <= 0.05, k
        else:
            assert _worst(g, w) <= 3e-4, k


@pytest.mark.parametrize("option,value,match", [
    # Thompson-aerosol, refused until it was ported (its id kept): it now
    # runs (match None), K5 then the effective radii
    pytest.param("microphysics", C.MP_THOMPSON_AER, None,
                 id="microphysics-5-Slice F \\(Thompson-aerosol"),
    # the other convection schemes, refused until they were ported (their
    # ids kept): each now runs (match None)
    pytest.param("convection", C.CU_NSAS, None,
                 id="convection-4-Slice F \\(the other schemes\\)"),
    # the forcing's surface fluxes (lsm=1) and the lake, refused until
    # they were ported (their ids kept): each now runs (match None)
    pytest.param("landsurface", C.LSM_BASIC, None,
                 id="landsurface-1-Slice F \\(the other land surfaces\\)"),
    pytest.param("watersurface", C.WATER_LAKE, None,
                 id="watersurface-3-Slice F \\(lake\\)"),
    # options these cases refused until they were ported (their ids kept):
    # each now runs (match None), and SB04 with Tiedtke is refused by the
    # options' own validation, as in the JAX package (ValueError)
    pytest.param("landsurface", C.LSM_NOAHMP, None,
                 id="landsurface-4-Slice F \\(Noah-MP"),
    pytest.param("boundarylayer", C.PBL_YSU, None,
                 id="boundarylayer-3-Slice F \\(YSU\\)"),
    pytest.param("radiation", C.RA_RRTMG, None,
                 id="radiation-3-Slice F \\(RRTMG\\)"),
    pytest.param("convection", C.CU_KF, None,
                 id="convection-3-Slice F \\(the other schemes\\)"),
    pytest.param("convection", C.CU_BMJ, None,
                 id="convection-5-Slice F \\(the other schemes\\)"),
    pytest.param("microphysics", C.MP_SIMPLE,
                 "mp_simple is not tuned for use with deep convection",
                 id="microphysics-2-Slice C \\(the column physics with"),
    pytest.param("advection", C.ADV_MPDATA, None,
                 id="advection-2-Slice C \\(the column physics with"),
    pytest.param("advect_density", True, None,
                 id="advect_density-True-Slice B \\(density "
                    "advection\\)"),
    pytest.param("mp_update_interval", 300.0, None,
                 id="mp_update_interval-300.0-Slice C \\(the "
                    "microphysics throttle"),
])
def test_options_outside_the_slice_raise(option, value, match):
    """(c) Every option outside the slice raises NotImplementedError naming
    its ROADMAP slice, on the fullphys configuration. The options ported
    since (``match`` None: MPDATA, density advection, the microphysics
    throttle, YSU, RRTMG on the synthetic k-tables, Noah-MP, the forcing's
    surface fluxes, the lake -- here without lake cells --, Kain-Fritsch,
    NSAS, BMJ, Thompson-aerosol) build and run one 60 s interval with
    finite fields; SB04 with Tiedtke raises the options' ValueError."""
    def cb(o):
        if value == C.RA_RRTMG:
            synthetic_rrtmg_tables(o)
        if option == "advect_density":
            o.run.advect_density = value
        elif option == "mp_update_interval":
            o.mp.update_interval = value
        else:
            setattr(o.physics, option, value)
    if match is None:
        m = ideal_ridge_model(**CASE, **FULLPHYS, options_cb=cb,
                              device="cpu")
        m.advance(60.0)
        assert m.last_n_substeps == 3
        for k in m.state:
            assert np.isfinite(m.field(k)).all(), k
        return
    error = ValueError if option == "microphysics" and \
        value == C.MP_SIMPLE else NotImplementedError
    with pytest.raises(error, match=match):
        ideal_ridge_model(**CASE, **FULLPHYS, options_cb=cb, device="cpu")


def test_a_mesh_is_refused_with_the_column_physics():
    """A mesh refused the column physics until its loop ran on blocks (the
    name is kept): the case on a mesh of four CPU devices now takes the
    unsharded run's two substeps and every bit of every field
    (tests/test_torch_sharded_physics.py holds every column option so)."""
    from icar_tpu_torch.parallel.mesh import make_mesh
    one = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    m = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    m.attach_mesh(make_mesh(CASE["nx"], CASE["ny"], devices=["cpu"] * 4))
    for model in (one, m):
        model.advance(40.0)
    assert m.last_n_substeps == one.last_n_substeps == 2
    for k in one.state:
        np.testing.assert_array_equal(m.field(k).view(np.uint32),
                                      one.field(k).view(np.uint32),
                                      err_msg=k)


def test_path_kernels_and_levels():
    """(d) The fullphys path launches K5 and K1; K5 takes at most 1565
    levels on the card and K1 any number, so 1565 passes and 1566 is
    refused naming K5."""
    m = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    path = path_kernels(m.options)
    assert path == ("mp_thompson", "advect_upwind")
    kernels.check_levels(path, 1565)
    with pytest.raises(ValueError, match="kernel mp_thompson"):
        kernels.check_levels(path, 1566)
    with pytest.raises(ValueError, match="kernel mp_thompson"):
        ideal_ridge_model(nx=20, ny=8, nz=1566, mp=C.MP_THOMPSON,
                          device="cuda")


def test_fullphys_takes_the_plain_versions_on_the_cpu():
    """On CPU tensors no kernel launches; one short interval runs."""
    m = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    kernels.reset_launches()
    m.advance(60.0)
    assert m.last_n_substeps > 0
    assert set(kernels.LAUNCHES.values()) == {0}


def test_profile_interval_takes_the_fullphys_path(capsys):
    """profile_interval --path fullphys runs end to end on the CPU at a
    small size: one JSON line naming the path, no device time."""
    import json
    from icar_tpu_torch import profile_interval
    times = profile_interval.main(["--path", "fullphys", "--nx", "24",
                                   "--ny", "8", "--nz", "12", "--interval",
                                   "120", "--device", "cpu"])
    assert times == {}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["path"] == "fullphys" and out["substeps"] > 0
    assert out["device_idle_share"] is None


def test_count_ops_runs_on_the_cpu(capsys, monkeypatch):
    """tools/count_ops.py counts each column-physics stage's operations
    on the CPU: one JSON line, Tiedtke by far the most."""
    import json
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(root, "tools"))
    import count_ops
    monkeypatch.setattr(sys, "argv", ["count_ops.py", "--nz", "10"])
    count_ops.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ops = out["ops_per_call"]
    assert ops["convection (Tiedtke)"] == max(ops.values())
    assert min(ops.values()) > 0 and out["interval_substeps"] > 0

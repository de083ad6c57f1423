"""The port's linear-theory ridge (ideal_ridge_model(windtype=WIND_LINEAR),
bench.py --config linear at a small size) against the JAX model, on the
CPU: the initial winds and N^2, two intervals with a wind update before
each (as bench.py runs them), wind=5 and flow blocking at their initial
winds, the options' checks, and a mesh under them (the sharded ridge of
bench.py --config linear --sharded against the JAX package's sharded
model too).

One JAX model (module fixture) serves every comparison: wind=5 and
blocking take the same geometry as wind=1 (Options.validate sets
fixed_dz_advection=False for each), so its solver is switched in place and
run from its initial state.

Bounds. The port's log N^2 lies within 2.5e-5 of the JAX package's at
this size (tests/test_torch_linear_winds.py holds the smoothed stability
to the JAX package's own one-ulp spread plus log's rounding, 2.4e-5 at
most here); N^2 = exp of it, so relatively as close. The winds then move
by that over the table's N^2 spacing times the largest change of an entry
from one N^2 value to the next, plus 8 ulps of the largest wind (the
lookup's own rounding); w, their balance, by twice that times the
column's depth over dx. The iterative solver adds one ulp of the largest
wind per correction (tests/test_torch_wind_solvers.py); blocking adds its
Froude number's error (same file) times its gain and its table's largest
value. Over two intervals the prognostic fields are held to the spread
bounds of the ridge tests (chip_smoke.ENSEMBLE_MAX/MEAN, as
tests/test_torch_model.py holds the SB04 ridge) and take the same
substeps.
"""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as C
from icar_tpu.config import Options as JaxOptions
from icar_tpu.forcing.ideal import make_ideal_case
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from jax.sharding import Mesh as JaxMesh
from icar_tpu_torch.config import Options
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the small case and the spread bounds)

EPS32 = float(np.finfo(np.float32).eps)
NSQ_LOG = 2.5e-5
CASE = chip_smoke.LINEAR_SMALL
small_lt = chip_smoke.linear_small_options


@pytest.fixture(scope="module")
def pair():
    """The JAX wind=1 model, its initial state and case winds, and the
    port's model."""
    mj = jax_model(**CASE, windtype=C.WIND_LINEAR, options_cb=small_lt)
    mt = ideal_ridge_model(**CASE, windtype=C.WIND_LINEAR,
                           options_cb=small_lt, device="cpu")
    case = make_ideal_case(mj.geom, u_profile=CASE["u_speed"],
                           rh=CASE["rh"])
    # the initial state as numpy: the JAX step donates its state's buffers
    init = {k: np.array(v) for k, v in mj.state.items()}
    return mj, init, (jnp.asarray(case.u), jnp.asarray(case.v)), mt


def _restore(mj, init):
    mj.state = {k: jnp.asarray(v) for k, v in init.items()}


def _jax_winds(mj, init, winds, windtype, block=False):
    """The JAX model's wind solution from its initial state with another
    solver, the model left as it was."""
    ph, saved = mj.options.physics, mj.options.block
    _restore(mj, init)
    mj._wind_fn = None
    ph.windtype = windtype
    if block:
        mj.options.block = dataclasses.replace(saved)
        chip_smoke.linear_blocking_options(mj.options)
    try:
        return [np.asarray(a) for a in mj.compute_winds(*winds, rotate=True)]
    finally:
        ph.windtype, mj.options.block = C.WIND_LINEAR, saved
        mj._wind_fn = mj._blocking = None


def wind_bounds(mt, winds):
    """(bound for u and v, bound for w) of the linear-theory winds: the
    N^2 difference over the table's N^2 spacing times the largest change
    of an entry between neighbouring N^2 values, plus the lookup's 8
    ulps."""
    lt = mt.options.lt
    spacing = (lt.nsqmax - lt.nsqmin) / (lt.n_nsq_values - 1)
    step = 0.0
    for lut in mt._lut:
        t = lut.reshape(lt.n_spd_values * lt.n_dir_values, lt.n_nsq_values,
                        -1)
        step = max(step, float((t[:, 1:] - t[:, :-1]).abs().max()))
    uv = NSQ_LOG / spacing * step + 8 * EPS32 * max(
        float(np.abs(w).max()) for w in winds)
    depth = float(np.sum(mt.options.domain.dz_levels[:CASE["nz"]]))
    return uv, 2 * uv * depth / CASE["dx"]


def _assert_winds(mt, want, uv, w, what):
    for k, b, x in zip("uvw", (uv, uv, w), want):
        d = np.abs(mt.field(k) - x).max()
        assert d <= b, f"{what}: {k} differs by {d} > {b}"


def test_initial_winds_and_nsquared_match_jax(pair):
    mj, _, _, mt = pair
    want = [np.asarray(mj.field(k)) for k in "uvw"]
    uv, w = wind_bounds(mt, want[:2])
    _assert_winds(mt, want, uv, w, "initial")
    nsq_t, nsq_j = mt.field("nsquared"), np.asarray(mj.field("nsquared"))
    assert np.abs(np.log(nsq_t) - np.log(nsq_j)).max() <= NSQ_LOG
    for got, ref in ((mt.u_perturbation, mj.u_perturbation),
                     (mt.v_perturbation, mj.v_perturbation)):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= uv
    # linear theory moved the winds: u off its 10 m/s profile, v from 0
    assert np.abs(want[0] - 10.0).max() > 1.0
    assert np.abs(mt.field("v")).max() > 0.1


def test_two_intervals_with_wind_updates_match_jax(pair):
    """bench.py's linear loop: the winds solved anew from the case's winds
    on the present state, then a 1200 s interval, twice. The same
    substeps, the prognostics within the ridge tests' spread bounds, the
    winds and N^2 as above."""
    mj, init, winds, mt = pair
    _restore(mj, init)
    mj._wind_fn = None
    mt_state = dict(mt.state)
    try:
        for _ in range(2):
            u, v, w = mj.compute_winds(*winds, rotate=True)
            mj.state = {**mj.state, "u": u, "v": v, "w": w}
            mj.advance(1200.0)
            mt.update_winds()
            mt.advance(1200.0)
            _assert_interval(mt, mj)
    finally:
        mt.state = mt_state
        _restore(mj, init)


def _assert_interval(mt, mj):
    """The port's model after an interval against the JAX model's: the
    same substeps, the prognostics within the ridge tests' spread bounds,
    the winds and N^2 as at set-up."""
    assert mt.last_n_substeps == mj.last_n_substeps
    for k, bound in chip_smoke.ENSEMBLE_MAX.items():
        got, want = mt.field(k), np.asarray(mj.field(k))
        d = np.abs(got - want)
        assert np.isfinite(got).all(), k
        assert (d <= bound + 1e-4 * np.abs(want)).all(), (k, d.max())
        assert d.mean() <= chip_smoke.ENSEMBLE_MEAN[k], k
    want = [np.asarray(mj.field(k)) for k in "uvw"]
    _assert_winds(mt, want, *wind_bounds(mt, want[:2]), "interval")
    assert np.abs(np.log(mt.field("nsquared")) - np.log(np.asarray(
        mj.field("nsquared")))).max() <= NSQ_LOG


# the fields formed from the winds (diagnostic_update), which a sharded
# model's set-up leaves as the case's winds gave them
WIND_DIAGNOSTICS = ("ivt", "u_10m", "u_mass", "ustar", "v_10m", "v_mass",
                    "w_real")
# those fields at set-up: the same winds and state in both packages, so
# only the diagnostics' own rounding (ivt a column sum of products) parts
# them; 4 ulps of each field's largest magnitude
WIND_DIAGNOSTICS_ULPS = 4


def test_sharded_linear_ridge_matches_the_jax_sharded_model(pair):
    """``ideal_ridge_model(mesh=...)`` on a 2x2 CPU mesh against the JAX
    package's on a 2x2 mesh of four of its CPU devices (bench.py --config
    linear --sharded): at set-up the winds and N^2 within the unsharded
    bounds, and the wind-derived diagnostics those of the case's winds in
    both (within WIND_DIAGNOSTICS_ULPS; v_mass 0, the solved v not); after
    one 1200 s interval the same bounds as the unsharded runs."""
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    mj = jax_model(**CASE, windtype=C.WIND_LINEAR, options_cb=small_lt,
                   mesh=mesh)
    mt = ideal_ridge_model(**CASE, windtype=C.WIND_LINEAR,
                           options_cb=small_lt, mesh=Mesh(["cpu"] * 4, (2, 2)),
                           device="cpu")
    want = [np.asarray(mj.field(k)) for k in "uvw"]
    _assert_winds(mt, want, *wind_bounds(mt, want[:2]), "sharded set-up")
    assert np.abs(np.log(mt.field("nsquared")) - np.log(np.asarray(
        mj.field("nsquared")))).max() <= NSQ_LOG
    for k in WIND_DIAGNOSTICS:
        got, ref = mt.field(k), np.asarray(mj.field(k))
        d = float(np.abs(got - ref).max())
        assert d <= WIND_DIAGNOSTICS_ULPS * EPS32 * np.abs(ref).max(), (k, d)
    assert np.abs(mt.field("v_mass")).max() == 0.0
    assert np.abs(mt.field("v")).max() > 0.1
    mj.advance(1200.0)
    mt.advance(1200.0)
    _assert_interval(mt, mj)


@pytest.mark.parametrize("windtype,block", [
    (C.WIND_LINEAR_ITERATIVE, False), (C.WIND_LINEAR, True),
    (C.WIND_LINEAR_ITERATIVE, True)])
def test_iterative_and_blocking_initial_winds_match_jax(pair, windtype,
                                                        block):
    mj, init, winds, mt1 = pair
    want = _jax_winds(mj, init, winds, windtype, block)

    cb = chip_smoke.linear_blocking_options if block else small_lt
    mt = ideal_ridge_model(**CASE, windtype=windtype, options_cb=cb,
                           device="cpu")
    uv, w = wind_bounds(mt1, want[:2])
    if windtype == C.WIND_LINEAR_ITERATIVE:
        it = (mt.options.run.wind_iterations + 1) * EPS32 * max(
            float(np.abs(a).max()) for a in want[:2])
        uv, w = uv + it, w + 2 * it * float(np.sum(
            mt.options.domain.dz_levels[:CASE["nz"]])) / CASE["dx"]
    if block:
        # the Froude number's relative error (n ulps of the boundary means
        # over the difference of the logs of theta's), where it is below
        # block_fr_max, times the gain and the blocked table's largest
        # value
        bo = mt.options.block
        th = mt.field("potential_temperature").astype(np.float64)
        dlog = np.log(th[-1, [0, -1]].mean()) - np.log(th[0, [0, -1]].mean())
        fr = CASE["nx"] * EPS32 * (1 + 1 / dlog) * bo.block_fr_max
        lut = max(float(a.abs().max()) for a in mt._blocking[:2])
        extra = (fr / (bo.block_fr_max - bo.block_fr_min) * lut
                 * bo.blocking_contribution)
        uv, w = uv + extra, w + 2 * extra * float(np.sum(
            mt.options.domain.dz_levels[:CASE["nz"]])) / CASE["dx"]
    _assert_winds(mt, want, uv, w, f"wind={windtype} block_flow={block}")
    other = _jax_winds(mj, init, winds, C.WIND_LINEAR)
    # each solver gave winds of its own
    assert np.abs(want[0] - other[0]).max() > 1e-3


@pytest.mark.parametrize("windtype", [C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE])
def test_validate_linear_winds_matches_jax(windtype, capsys):
    """Options.validate with linear-theory winds and the domain's size set
    gives the JAX package's warnings (the solver's fixed_dz_advection and
    the table's size against max_lut_gb) and options, and raises nothing
    (it read the table's size from a module the port lacked before)."""
    results = []
    for cls in (JaxOptions, Options):
        o = cls()
        o.physics.windtype = windtype
        o.domain.nx, o.domain.ny, o.domain.nz = 400, 300, 20
        o.domain.dz_levels = [200.0] * 20
        capsys.readouterr()
        o.validate()
        results.append((capsys.readouterr().err, dataclasses.asdict(o)))
    assert results[0] == results[1]
    assert "max_lut_gb" in results[1][0]
    assert "fixed_dz_advection" in results[1][0]


def test_attach_mesh_refuses_linear_winds_and_blocking(pair):
    """A mesh, once refused for linear-theory winds and flow blocking,
    now takes both (tests/test_torch_sharded_linear.py holds every linear
    solver on 2x2 and 1x4): copies of the port's wind=1 model, and of it
    with blocking switched on, one of each pair on a 1x2 CPU mesh, take a
    wind update and an interval, every bit of every field equal to the
    unsharded copy's."""
    for block in (False, True):
        one = copy.deepcopy(pair[3])
        if block:
            chip_smoke.linear_blocking_options(one.options)
        two = copy.deepcopy(one)
        two.attach_mesh(Mesh(["cpu"] * 2, (1, 2)))
        for m in (one, two):
            m.update_winds()
            m.advance(300.0)
        assert two.last_n_substeps == one.last_n_substeps > 0
        assert (one._blocking is not None) == block
        assert chip_smoke.bit_mismatches(one, two) == []


def test_disk_cache_through_the_model(pair, tmp_path):
    """A model that writes the table's cache (write_lut) and one that reads
    it (read_lut) hold the same table, and the JAX package reads it."""
    from icar_tpu.ops import linear_winds as jlw
    path = str(tmp_path / "lut.npz")

    def cb(read):
        def f(o):
            small_lt(o)
            o.lt.lut_filename = path
            o.lt.read_lut, o.lt.write_lut = read, not read
        return f
    writer = ideal_ridge_model(**CASE, windtype=C.WIND_LINEAR,
                               options_cb=cb(False), device="cpu")
    reader = ideal_ridge_model(**CASE, windtype=C.WIND_LINEAR,
                               options_cb=cb(True), device="cpu")
    dz = np.asarray(writer.options.domain.dz_levels[:CASE["nz"]], np.float32)
    back = jlw.load_lut(path, dz, writer.options.lt)
    for a, b, c, d in zip(writer._lut, reader._lut, back, pair[3]._lut):
        assert torch.equal(a, b) and torch.equal(a, d)
        np.testing.assert_array_equal(np.asarray(c), a.numpy())
    np.testing.assert_array_equal(reader.field("u"), writer.field("u"))


def test_too_large_a_table_raises():
    def cb(o):
        small_lt(o)
        o.lt.max_lut_gb = 1e-4
    with pytest.raises(ValueError, match="max_lut_gb"):
        ideal_ridge_model(**CASE, windtype=C.WIND_LINEAR, options_cb=cb,
                          device="cpu")

"""The port's iterative wind solver (wind=3) and flow blocking
(icar_tpu_torch/ops/wind.py, ops/blocking.py) against the JAX package's,
on the CPU: each function on the same inputs, the dispatch, and the
wind=3 ridge's initial winds (one JAX model), unsharded and on a mesh.

The iterative solver runs 101 corrections whose rounding differs from the
JAX package's compiled loop body (XLA folds its divisions by constants and
contracts products into fused multiply-adds) by an ulp or two each; the
differences add up over the iterations, so the bound is one float32 ulp
of the largest wind per iteration. Blocking's table is built like the
linear-theory table (bound as there); its Froude number and interpolation
round like the JAX package's but for the means and the box sums' order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as C
from icar_tpu.config import BlockOptions, LtOptions
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu.ops import blocking as jblk
from icar_tpu.ops import wind as jwind
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import blocking as tblk
from icar_tpu_torch.ops import wind as twind
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
CASE = dict(nx=48, ny=12, nz=10, dx=1000.0, hill_height=600.0,
            u_speed=10.0, rh=0.8)
DZ = np.array([50.0, 75.0, 125.0, 200.0, 300.0, 400.0] + [500.0] * 4,
              np.float32)


def small_lt():
    return LtOptions(buffer=10, n_dir_values=8, n_spd_values=4,
                     n_nsq_values=3, variable_n=True, vert_smooth=5)


@pytest.fixture(scope="module")
def iterative():
    """The JAX wind=3 ridge (its geometry has fixed_dz_advection, as
    Options.validate sets for wind=3) and the port's."""
    mj = jax_model(**CASE, windtype=C.WIND_ITERATIVE)
    mt = ideal_ridge_model(**CASE, windtype=C.WIND_ITERATIVE, device="cpu")
    return mj, mt


def _t(a):
    return torch.tensor(np.asarray(a))


def _winds(seed, nz=10, ny=12, nx=48):
    r = np.random.default_rng(seed)
    u = (10 + 2 * r.standard_normal((nz, ny, nx + 1))).astype(np.float32)
    v = (2 * r.standard_normal((nz, ny + 1, nx))).astype(np.float32)
    return u, v


def iteration_bound(n_iterations, *winds):
    """One float32 ulp of the largest wind per correction."""
    return (n_iterations + 1) * EPS32 * max(np.abs(w).max() for w in winds)


@pytest.mark.parametrize("n_iterations", [0, 5, 100])
def test_iterative_winds_match_jax(iterative, n_iterations):
    mj, mt = iterative
    u, v = _winds(1)
    want = jwind.iterative_winds(u, v, mj.geom, n_iterations)
    got = twind.iterative_winds(_t(u), _t(v), mt.geom_t, n_iterations)
    bound = iteration_bound(n_iterations, u, v)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= bound
    # the inputs are not written to
    np.testing.assert_array_equal(u, _winds(1)[0])


def test_wind3_ridge_matches_jax(iterative):
    """The wind=3 ridge's initial winds: u and v within the iteration
    bound of the JAX model's, w (their balance) within it times the
    column's depth over dx (the divergence summed over the levels)."""
    mj, mt = iterative
    depth = float(np.sum(DZ)) / CASE["dx"]
    u, v = (np.asarray(mj.field(k)) for k in "uv")
    bound = iteration_bound(100, u, v)
    for k, b in (("u", bound), ("v", bound), ("w", 2 * depth * bound)):
        assert np.abs(mt.field(k) - np.asarray(mj.field(k))).max() <= b, k
    assert np.abs(mt.field("v")).max() > 0.1     # the solver moved v


def test_wind3_on_a_mesh_keeps_the_unsharded_digest(iterative):
    """wind=3 on a 2x2 CPU mesh: the winds are solved on the whole domain
    before the shards take them, so an interval gives the unsharded
    digest exactly."""
    _, mt = iterative
    ref = ideal_ridge_model(**CASE, windtype=C.WIND_ITERATIVE, device="cpu")
    sharded = ideal_ridge_model(**CASE, windtype=C.WIND_ITERATIVE,
                                device="cpu")
    sharded.attach_mesh(Mesh(["cpu"] * 4, (2, 2)))
    ref.advance(300.0)
    sharded.advance(300.0)
    assert sharded.last_n_substeps == ref.last_n_substeps
    assert sharded.digest() == ref.digest()
    np.testing.assert_array_equal(sharded.field("u"), mt.field("u"))


@pytest.fixture(scope="module")
def blocking_case(iterative):
    mj, _ = iterative
    terrain = np.asarray(mj.geom.terrain, np.float64)
    jb = jblk.init_blocking(terrain, mj.geom.dx, DZ, small_lt(),
                            BlockOptions())
    return terrain, jb


def test_terrain_blocking_heights_bit_equal(blocking_case):
    terrain, jb = blocking_case
    np.testing.assert_array_equal(tblk.terrain_blocking_heights(terrain, 3),
                                  np.asarray(jb.terrain_blocking))


def test_blocking_lut_matches_jax(blocking_case):
    """The table within 1e-6 of its largest value (the FFTs, as the
    linear-theory table; the key levels agree, or whole levels would
    differ)."""
    terrain, jb = blocking_case
    lu, lv, dirv, spdv = tblk.build_blocking_lut(terrain, 1000.0, DZ,
                                                 small_lt(), "cpu")
    np.testing.assert_array_equal(dirv, np.asarray(jb.dir_values))
    np.testing.assert_array_equal(spdv, np.asarray(jb.spd_values))
    for got, want in ((lu, jb.lut_u), (lv, jb.lut_v)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def _blocking_inputs(mj, seed):
    r = np.random.default_rng(seed)
    th = np.asarray(mj.field("potential_temperature"))
    u, v = _winds(seed)
    v = v * 0.3
    # a weak, stable flow somewhere: some cells blocked, some not
    u[:, :, :20] *= 0.2
    return th, u, v, np.asarray(mj.geom.z), r


def test_froude_and_apply_blocking_match_jax(iterative, blocking_case):
    """The Froude number, and the blocked winds from the JAX package's
    table and Froude number, against the JAX package's. The Froude number
    scales with the boundary-mean wind over the root of a difference of
    the logs of two boundary means of theta, which the two packages sum
    in other orders: each mean of n cells may be off by n ulps, which the
    difference of the logs divides by its size, so the bound relative to
    the largest Froude number is n ulps times (1 + 1 / that difference).
    The blocked winds within 8 ulps of the largest wind."""
    mj, _ = iterative
    _, jb = blocking_case
    bo = BlockOptions(block_fr_max=5.0, block_fr_min=3.5)
    th, u, v, z, _ = _blocking_inputs(mj, 5)
    nsmooth = max(1, int(round(bo.smooth_froude_distance / 1000.0)))
    fr_j = np.asarray(jblk.update_froude(th, u, v, z, jb.terrain_blocking,
                                         nsmooth, bo.n_smoothing_passes,
                                         bo.block_fr_max))
    tb = tblk.BlockingData(*(_t(a) for a in jb))
    fr_t = tblk.update_froude(_t(th), _t(u), _t(v), _t(z),
                              tb.terrain_blocking, nsmooth,
                              bo.n_smoothing_passes, bo.block_fr_max)
    th64 = th.astype(np.float64)
    dlog = (np.log(0.5 * (th64[-1, 0].mean() + th64[-1, -1].mean()))
            - np.log(0.5 * (th64[0, 0].mean() + th64[0, -1].mean())))
    rel = th.shape[2] * EPS32 * (1 + 1 / dlog)
    assert np.abs(fr_t.numpy() - fr_j).max() <= rel * np.abs(fr_j).max()
    assert (fr_j < bo.block_fr_max).any() and (fr_j > bo.block_fr_max).any()
    want = jblk.apply_blocking(u, v, jnp.asarray(fr_j), jb, 3,
                               bo.blocking_contribution, bo.block_fr_max,
                               bo.block_fr_min)
    got = tblk.apply_blocking(_t(u), _t(v), _t(fr_j), tb, 3,
                              bo.blocking_contribution, bo.block_fr_max,
                              bo.block_fr_min)
    bound = 8 * EPS32 * np.abs(u).max()
    for g, w, x in zip(got, want, (u, v)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= bound
        assert np.abs(g.numpy() - x).max() > 1e-3     # blocking acted

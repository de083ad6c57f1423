"""The port's diagnostics and CFL timestep against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as C
from icar_tpu.core import diagnostics as jdiag
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch.convert import geometry_to_torch, state_from_numpy
from icar_tpu_torch.core import diagnostics as tdiag
from icar_tpu_torch.core.step import quantized_dt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ridge():
    """A JAX ridge model's state with seeded clouds and precipitation
    added, so every integrated diagnostic is non-trivial."""
    m = jax_model(nx=36, ny=10, nz=12, dx=1000.0, hill_height=900.0,
                  u_speed=12.0, rh=0.9)
    r = np.random.default_rng(7)
    s = {k: np.asarray(v) for k, v in m.state.items()}
    shape = s["water_vapor"].shape
    for k, hi in (("cloud_water", 1e-3), ("rain_mass", 5e-4),
                  ("snow_mass", 5e-4)):
        s[k] = np.where(r.uniform(size=shape) < 0.5,
                        r.uniform(0, hi, shape), 0.0).astype(np.float32)
    s["potential_temperature"] = (s["potential_temperature"]
                                  + r.uniform(-2, 2, shape)
                                  ).astype(np.float32)
    return m.geom, s


@pytest.mark.parametrize("full", [True, False])
def test_diagnostic_update_matches(ridge, full):
    geom, s = ridge
    want = jdiag.diagnostic_update({k: jnp.asarray(v) for k, v in s.items()},
                                   geom, full=full)
    got = tdiag.diagnostic_update(state_from_numpy(s, "cpu"),
                                  geometry_to_torch(geom, "cpu"), full=full)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6 * float(
                                       np.abs(np.asarray(want[k])).max()),
                                   err_msg=k)


def test_density_refresh_matches(ridge):
    """The general loop's per-substep refresh (needs={"density"}, and
    RRTMG's {"temperature_interface"}) from a state whose theta moved
    since its exner was computed."""
    geom, s = ridge
    s = dict(s)
    s["potential_temperature"] = (s["potential_temperature"] + 0.5
                                  ).astype(np.float32)
    want = jdiag.diagnostic_update({k: jnp.asarray(v) for k, v in s.items()},
                                   geom, full=False, needs={"density"})
    got = tdiag.diagnostic_update(state_from_numpy(s, "cpu"),
                                  geometry_to_torch(geom, "cpu"),
                                  needs={"density"})
    assert sorted(got) == sorted(s)
    np.testing.assert_allclose(got["density"].numpy(),
                               np.asarray(want["density"]), rtol=1e-6)
    for k in s:
        if k != "density":
            np.testing.assert_array_equal(got[k].numpy(), s[k], err_msg=k)
    # RRTMG's interface temperature refreshes alike; a field outside the
    # partial refresh is refused
    want = jdiag.diagnostic_update({k: jnp.asarray(v) for k, v in s.items()},
                                   geom, full=False,
                                   needs={"temperature_interface"})
    got = tdiag.diagnostic_update(state_from_numpy(s, "cpu"),
                                  geometry_to_torch(geom, "cpu"),
                                  needs={"temperature_interface"})
    np.testing.assert_allclose(got["temperature_interface"].numpy(),
                               np.asarray(want["temperature_interface"]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="PARTIAL_FIELDS"):
        tdiag.diagnostic_update(state_from_numpy(s, "cpu"), None,
                                needs={"iwv"})


def test_exner_matches_compiled_reference():
    """The Exner function gives the bits the JAX package's compiled step
    gives in all but a handful of cells (XLA turns p/P0 into p*(1/P0))."""
    p = np.random.default_rng(0).uniform(2e4, 1.05e5, 100000).astype(
        np.float32)
    want = np.asarray(jax.jit(jdiag.exner_function)(jnp.asarray(p)))
    got = tdiag.exner_function(torch.tensor(p)).numpy()
    assert (got != want).sum() < 1e-3 * p.size
    np.testing.assert_allclose(got, want, rtol=2.5e-7)


def _jax_quantized_dt(u, v, w, dz_levels, dx, strictness):
    # icar_tpu/core/step.py quantized_dt
    dt = jdiag.compute_dt(u, v, w, dz_levels, dx, 0.9, strictness)
    dt = jnp.minimum(dt, C.MAX_DT)
    return jnp.maximum(jnp.floor(dt * 64.0) / 64.0, 1.0 / 64.0)


@pytest.mark.parametrize("strictness", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_dt_bit_equal(strictness, seed):
    r = np.random.default_rng(seed)
    nz, ny, nx = 9, 11, 13
    scale = (5.0, 20.0, 60.0)[seed]
    u = r.normal(0, scale, (nz, ny, nx + 1)).astype(np.float32)
    v = r.normal(0, scale, (nz, ny + 1, nx)).astype(np.float32)
    w = r.normal(0, scale / 10, (nz, ny, nx)).astype(np.float32)
    dz = np.asarray([50, 75, 125, 200, 300, 400, 500, 500, 500], np.float32)
    dx = 1000.0
    got = quantized_dt(torch.tensor(u), torch.tensor(v), torch.tensor(w),
                       torch.tensor(dz), dx, 0.9, strictness)
    eager = _jax_quantized_dt(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
                              dz, dx, strictness)
    compiled = jax.jit(lambda u, v, w: _jax_quantized_dt(
        u, v, w, dz, dx, strictness))(jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(w))
    assert isinstance(got, np.float32)
    assert got == np.float32(eager) == np.float32(compiled)

"""The port's plain upwind advection (the plain version of kernel K1)
against the JAX package's jnp path and its Pallas kernel (interpret mode).

Tolerance rtol 5e-6, atol 1e-7, as tests/test_pallas.py: the plain version
keeps the jnp path's operation order, the Pallas kernel scales the winds in
another order, so a few float32 ulp separate them.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.ops import advection as jadv
from icar_tpu.ops import pallas_kernels as pk
from icar_tpu_torch.ops import advection as tadv
from icar_tpu_torch.ops import kernels

torch.set_num_threads(1)

RTOL, ATOL = 5e-6, 1e-7


def _inputs(seed, S=5, nz=8, ny=11, nx=13):
    r = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return dict(
        q=f(r.uniform(0.1, 1.0, (S, nz, ny, nx))),
        u=f(r.uniform(-6, 6, (nz, ny, nx + 1))),
        v=f(r.uniform(-6, 6, (nz, ny + 1, nx))),
        w=f(r.uniform(-1, 1, (nz, ny, nx))),
        dz=f(np.full((nz, ny, nx), 200.0) * r.uniform(0.5, 1.5, (nz, 1, 1))),
        jaco=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        jaco_u=f(r.uniform(0.8, 1.2, (nz, ny, nx + 1))),
        jaco_v=f(r.uniform(0.8, 1.2, (nz, ny + 1, nx))),
        jaco_w=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        dt=np.float32((20.0, 37.5, 61.25)[seed % 3]), dx=1000.0,
        # floors as the model sets them: theta unclamped, species at 0; the
        # last species gets a floor the field crosses
        floors=f([-np.inf, 0.0, 0.0, 0.0, 0.5][:S]))


def _jnp(d, near_end, use_pallas=False):
    a = {k: jnp.asarray(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    if use_pallas:
        return pk.advect_upwind_tpu(
            a["q"], a["u"], a["v"], a["w"], d["dx"], a["jaco_u"],
            a["jaco_v"], a["jaco_w"], a["dz"], a["jaco"], d["dt"],
            floors=d["floors"], near_end=jnp.float32(near_end))
    return jadv.advect_upwind(
        a["q"], a["u"], a["v"], a["w"], d["dt"], d["dx"], a["jaco_u"],
        a["jaco_v"], a["jaco_w"], a["jaco"], None, a["dz"], False,
        use_pallas=False, floors=d["floors"],
        near_end=jnp.float32(near_end))


def _torch(d, near_end):
    t = {k: torch.tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    return tadv.advect_upwind(
        t["q"], t["u"], t["v"], t["w"], d["dt"], d["dx"], t["jaco_u"],
        t["jaco_v"], t["jaco_w"], t["jaco"], t["dz"], floors=t["floors"],
        near_end=near_end)


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_upwind_matches_jnp(seed, near_end):
    d = _inputs(seed)
    np.testing.assert_allclose(_torch(d, near_end).numpy(),
                               np.asarray(_jnp(d, near_end)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("near_end", [False, True])
def test_plain_upwind_matches_pallas_kernel(near_end):
    d = _inputs(4, S=3, nz=6, ny=19, nx=21)
    d["floors"] = d["floors"][:3]
    prev = pk.force_interpret(True)
    try:
        want = np.asarray(_jnp(d, near_end, use_pallas=True))
    finally:
        pk.force_interpret(prev)
    np.testing.assert_allclose(_torch(d, near_end).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_boundary_cells_pass_through():
    d = _inputs(5)
    out = _torch(d, False).numpy()
    q = d["q"]
    for sl in ((Ellipsis, 0, slice(None)), (Ellipsis, -1, slice(None)),
               (Ellipsis, slice(None), 0), (Ellipsis, slice(None), -1)):
        np.testing.assert_array_equal(out[sl], q[sl])


def test_wrapper_on_cpu_runs_plain_version():
    d = _inputs(6)
    t = {k: torch.tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    geom = SimpleNamespace(dx=d["dx"], jacobian=t["jaco"],
                           jacobian_u=t["jaco_u"], jacobian_v=t["jaco_v"],
                           jacobian_w=t["jaco_w"], advection_dz=t["dz"])
    winds = kernels.prepare_advect_winds(t["u"], t["v"], t["w"], geom)
    before = dict(kernels.LAUNCHES)
    out = torch.empty_like(t["q"])
    got = kernels.advect_upwind(t["q"], winds, d["dt"], t["floors"], True,
                                out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), _torch(d, True).numpy())
    assert kernels.LAUNCHES == before

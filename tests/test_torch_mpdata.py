"""The port's plain MPDATA advection (the plain version of kernel K4)
against the JAX package's jnp path and its Pallas kernel (interpret mode),
on the shapes of tests/test_pallas.py's MPDATA test (odd sizes).

Tolerances: against the jnp path rtol 1e-6, atol 1e-8 -- the plain version
keeps the jnp operation order (the two agree bit for bit on this
repository's CPU); against the Pallas kernel rtol 2e-5, atol 1e-6, what
tests/test_pallas.py allows the kernel against jnp, because the kernel
scales the winds in another order.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.ops import advection as jadv
from icar_tpu.ops import mpdata as jmd
from icar_tpu.ops import pallas_kernels as pk
from icar_tpu_torch.ops import advection as tadv
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.ops import mpdata as tmd

torch.set_num_threads(1)

JNP_RTOL, JNP_ATOL = 1e-6, 1e-8
KERNEL_RTOL, KERNEL_ATOL = 2e-5, 1e-6


def _inputs(seed=17, S=4, nz=8, ny=37, nx=41):
    r = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    q = r.uniform(0.1, 1.0, (S, nz, ny, nx))
    q[1, :, 5:12, 7:15] = 0.0          # a species with a zero patch
    return dict(
        q=f(q),
        u=f(r.uniform(-6, 6, (nz, ny, nx + 1))),
        v=f(r.uniform(-6, 6, (nz, ny + 1, nx))),
        w=f(r.uniform(-1, 1, (nz, ny, nx))),
        dz=f(r.uniform(200, 400, (nz, ny, nx))),
        jaco=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        jaco_u=f(r.uniform(0.8, 1.2, (nz, ny, nx + 1))),
        jaco_v=f(r.uniform(0.8, 1.2, (nz, ny + 1, nx))),
        jaco_w=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        dt=np.float32(20.0), dx=1000.0,
        # theta-like species unclamped; the last floor cuts into the field
        floors=f([-np.inf, 0.0, 0.0, 0.5][:S]))


def _jax(d, order, fct, near_end, use_pallas=False):
    a = {k: jnp.asarray(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    if use_pallas:
        return pk.advect_mpdata_tpu(
            a["q"], a["u"], a["v"], a["w"], d["dx"], a["jaco_u"],
            a["jaco_v"], a["jaco_w"], a["dz"], a["jaco"], d["dt"], order,
            fct, floors=d["floors"], near_end=jnp.float32(near_end))
    return jmd.advect_mpdata(
        a["q"], a["u"], a["v"], a["w"], d["dt"], d["dx"], a["jaco_u"],
        a["jaco_v"], a["jaco_w"], a["jaco"], None, a["dz"], order=order,
        use_fct=fct, use_pallas=False, floors=d["floors"],
        near_end=jnp.float32(near_end))


def _tensors(d):
    return {k: torch.tensor(v) for k, v in d.items()
            if isinstance(v, np.ndarray)}


def _torch(d, order, fct, near_end):
    t = _tensors(d)
    return tmd.advect_mpdata(
        t["q"], t["u"], t["v"], t["w"], d["dt"], d["dx"], t["jaco_u"],
        t["jaco_v"], t["jaco_w"], t["jaco"], t["dz"], order=order,
        use_fct=fct, floors=t["floors"], near_end=near_end)


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("order,fct", [(2, True), (2, False), (3, True),
                                       (4, True)])
def test_plain_mpdata_matches_jnp(order, fct, near_end):
    d = _inputs()
    np.testing.assert_allclose(_torch(d, order, fct, near_end).numpy(),
                               np.asarray(_jax(d, order, fct, near_end)),
                               rtol=JNP_RTOL, atol=JNP_ATOL)


@pytest.mark.parametrize("order,fct,near_end", [
    (2, True, False), (2, True, True), (2, False, False), (3, True, True)])
def test_plain_mpdata_matches_pallas_kernel(order, fct, near_end):
    d = _inputs()
    prev = pk.force_interpret(True)
    try:
        want = np.asarray(_jax(d, order, fct, near_end, use_pallas=True))
    finally:
        pk.force_interpret(prev)
    np.testing.assert_allclose(_torch(d, order, fct, near_end).numpy(),
                               want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_order_one_is_upwind():
    d = _inputs(3, ny=11, nx=13)
    t = _tensors(d)
    want = tadv.advect_upwind(
        t["q"], t["u"], t["v"], t["w"], d["dt"], d["dx"], t["jaco_u"],
        t["jaco_v"], t["jaco_w"], t["jaco"], t["dz"], floors=t["floors"],
        near_end=True)
    np.testing.assert_array_equal(_torch(d, 1, True, True).numpy(),
                                  want.numpy())


def test_upwind_takes_per_species_winds():
    """advect3d_upwind with per-species (S, nz, ...) winds, as MPDATA's
    corrective pass hands it, against the JAX function; winds that repeat
    one (nz, ...) field per species give the 3D winds' result bit for
    bit."""
    d = _inputs(5, ny=11, nx=13)
    r = np.random.default_rng(8)
    S, nz, ny, nx = d["q"].shape
    f = lambda a: np.asarray(a, np.float32)
    w4 = (f(r.uniform(-0.3, 0.3, (S, nz, ny, nx - 1))),
          f(r.uniform(-0.3, 0.3, (S, nz, ny - 1, nx))),
          f(r.uniform(-0.2, 0.2, (S, nz, ny, nx))))
    got = tadv.advect3d_upwind(torch.tensor(d["q"]), tadv.CourantWinds(
        *map(torch.tensor, w4)), torch.tensor(d["dz"]),
        torch.tensor(d["jaco"]))
    want = jadv.advect3d_upwind(jnp.asarray(d["q"]), jadv.CourantWinds(
        *map(jnp.asarray, w4)), None, jnp.asarray(d["dz"]),
        jnp.asarray(d["jaco"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=JNP_RTOL, atol=JNP_ATOL)
    w3 = [torch.tensor(a[0]) for a in w4]
    rep = [a.expand(S, *a.shape) for a in w3]
    q, dz, jaco = (torch.tensor(d[k]) for k in ("q", "dz", "jaco"))
    np.testing.assert_array_equal(
        tadv.advect3d_upwind(q, tadv.CourantWinds(*rep), dz, jaco).numpy(),
        tadv.advect3d_upwind(q, tadv.CourantWinds(*w3), dz, jaco).numpy())


@pytest.mark.parametrize("near_end", [False, True])
def test_wrapper_on_cpu_runs_plain_version(near_end):
    d = _inputs(6, ny=11, nx=13)
    t = _tensors(d)
    geom = SimpleNamespace(dx=d["dx"], jacobian=t["jaco"],
                           jacobian_u=t["jaco_u"], jacobian_v=t["jaco_v"],
                           jacobian_w=t["jaco_w"], advection_dz=t["dz"])
    winds = kernels.prepare_advect_winds(t["u"], t["v"], t["w"], geom)
    before = dict(kernels.LAUNCHES)
    out = torch.empty_like(t["q"])
    got = kernels.advect_mpdata(t["q"], winds, d["dt"], 2, True,
                                t["floors"], near_end, out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(),
                                  _torch(d, 2, True, near_end).numpy())
    assert kernels.LAUNCHES == before


def test_advect_density_not_ported():
    """Density advection, which raised here until it was ported, runs:
    with a density of one everywhere it gives the result without density
    bit for bit (every wind and the jacobian times 1), and another density
    moves it (tests/test_torch_density.py holds it to the JAX jnp
    path)."""
    d = _inputs(7, ny=11, nx=13)
    t = _tensors(d)
    args = (t["q"], t["u"], t["v"], t["w"], d["dt"], d["dx"], t["jaco_u"],
            t["jaco_v"], t["jaco_w"], t["jaco"], t["dz"])
    plain = tmd.advect_mpdata(*args).numpy()
    np.testing.assert_array_equal(
        tmd.advect_mpdata(*args, advect_density=True,
                          rho=torch.ones_like(t["jaco"])).numpy(), plain)
    moved = tmd.advect_mpdata(*args, advect_density=True,
                              rho=t["jaco"] * 0.9).numpy()
    assert np.isfinite(moved).all()
    assert np.abs(moved - plain).max() > 1e-4

"""Per-shard kernel wrappers (icar_tpu_torch/parallel/shard_kernels.py)
against the unsharded kernel wrappers, on CPU devices.

On the CPU every wrapper runs its kernel's plain version block by block,
so each is held bit for bit (assert_array_equal) to the unsharded plain
version at every owned cell, on 2x2, 4x1, 1x3 and 3x2 meshes with uneven
last blocks. The MPDATA halo ``mpdata_halo(order, use_fct)`` is pinned:
exact at that width and not at one less, for orders 1-4 with FCT on and
off. K4's CUDA source, built for the CPU with g++ as
tests/test_torch_mpdata_kernel.py builds it, is held bit for bit per block
to its own run on the whole domain (the per-shard launch that replaces the
TPU's ``advect_mpdata_padded``). And the port's sharded MPDATA matches the
JAX package's ``advect_mpdata_sharded`` on a 4x1 mesh of the 8 virtual CPU
devices, its Pallas kernel in interpret mode as tests/test_shard_kernels.py
runs it, at rtol 2e-5, atol 1e-6: the tolerance tests/test_pallas.py
allows the TPU kernel against the jnp path, whose copy the port's plain
version is (the kernel scales the winds in another order).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from icar_tpu_torch import constants as C
from icar_tpu_torch.core.step import MP_SPECIES, limit_floors
from icar_tpu_torch.forcing.ideal import make_ideal_case
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel import shard_kernels as sk
from icar_tpu_torch.parallel.mesh import Layout, Mesh, scatter_geometry
from icar_tpu_torch.physics import mp_thompson, thompson_cases
from icar_tpu_torch.physics.mp_simple import formation_rates
from test_torch_mpdata_kernel import (SHAPES, _case,  # noqa: F401
                                      _run_cpu_kernel, cpu_kernel,
                                      cpu_source)

torch.set_num_threads(1)

MESHES = [(2, 2), (4, 1), (1, 3), (3, 2)]
NY, NX = 21, 26


def _layout(my, mx, halo, ny=NY, nx=NX, device="cpu"):
    return Layout(Mesh([device] * (my * mx), (my, mx)), ny, nx, halo)


@pytest.fixture(scope="module")
def ridge():
    """A port ridge model on the CPU after one interval with a cross-shard
    v flow: clouds, rain and snow, and the geometry."""
    m = ideal_ridge_model(nx=NX, ny=NY, nz=10, hill_height=700.0,
                          u_speed=10.0, rh=1.0, device="cpu")
    m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                             v_profile=4.0, rh=1.0))
    m.advance(300.0)
    assert m.field("cloud_water").max() > 0 and abs(m.field("v")).max() > 1
    return m


def _winds(layout, u, v, w, geom):
    """Per-block advection operands from global winds and geometry."""
    return [kernels.prepare_advect_winds(ub, vb, wb, g) for ub, vb, wb, g
            in zip(layout.scatter(u), layout.scatter(v), layout.scatter(w),
                   scatter_geometry(geom, layout))]


def _floors(layout, names):
    return [torch.as_tensor(limit_floors(names)) for _ in layout.shards]


@pytest.mark.parametrize("with_rho", [False, True])
@pytest.mark.parametrize("my,mx", MESHES)
def test_mp_simple_sharded_bit_exact(ridge, my, mx, with_rho):
    """SB04 per block (K2; K3 with the density blocks) against one call on
    the whole domain: species and accumulators."""
    s, g = ridge.state, ridge.geom_t
    fields = [s[k] for k in MP_SPECIES]
    p, ex, rho, dz = s["pressure"], s["exner"], s["density"], g.dz_interface
    rain = s["precipitation"] + 0.5
    snow = s["snowfall"] + 0.1
    c2r, c2s = formation_rates(40.0)
    want = [t.clone() for t in fields + [rain, snow]]
    if with_rho:
        kernels.mp_simple_rho(*want[:5], p, ex, rho, dz, *want[5:], 40.0,
                              c2r, c2s)
    else:
        kernels.mp_simple(*want[:5], p, ex, dz, *want[5:], 40.0, c2r, c2s)
    layout = _layout(my, mx, 1)
    got = [layout.scatter(t) for t in fields + [rain, snow]]
    sk.mp_simple_sharded(*got[:5], layout.scatter(p), layout.scatter(ex),
                         layout.scatter(dz), *got[5:], 40.0, c2r, c2s,
                         rho=layout.scatter(rho) if with_rho else None)
    for name, b, w in zip(MP_SPECIES + ("rain", "snow"), got, want):
        np.testing.assert_array_equal(layout.gather(b).numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("my,mx", MESHES)
def test_thompson_stack_sharded_bit_exact(my, mx):
    """Thompson per block against one call on the whole domain, on
    randomized mixed-regime columns and a permuted stack order."""
    stack, ex, p, dz = thompson_cases.as_stack(
        thompson_cases.mixed_state(3, 8, NY, NX))
    order = (4, 0, 8, 2, 6, 1, 3, 5, 7)
    stack = stack[list(order)].contiguous()
    smap = [order.index(i) for i in range(9)]
    acc = [torch.full((NY, NX), v) for v in (0.5, 0.1, 0.05)]
    want = [stack.clone()] + [a.clone() for a in acc]
    kernels.mp_thompson_stack(want[0], smap, ex, p, dz, 60.0, *want[1:])
    layout = _layout(my, mx, 2)
    got = [layout.scatter(t) for t in [stack] + acc]
    sk.thompson_stack_sharded(got[0], smap, layout.scatter(ex),
                              layout.scatter(p), layout.scatter(dz), 60.0,
                              *got[1:], mp_thompson.ThompsonParams())
    for name, b, w in zip(("stack", "rain", "snow", "graupel"), got, want):
        np.testing.assert_array_equal(layout.gather(b).numpy(), w.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("my,mx", MESHES)
def test_advect_upwind_sharded_bit_exact(ridge, my, mx, near_end):
    s, g = ridge.state, ridge.geom_t
    names = ridge.advect_names
    stack = torch.stack([s[k] for k in names])
    floors = torch.as_tensor(limit_floors(names))
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    want = kernels.advect_upwind(stack, winds, 20.0, floors, near_end)
    layout = _layout(my, mx, sk.UPWIND_HALO)
    q = layout.scatter(stack)
    out = [torch.empty_like(b) for b in q]
    sk.advect_upwind_sharded(layout, q, _winds(layout, s["u"], s["v"],
                                               s["w"], ridge.geom),
                             20.0, _floors(layout, names), near_end, out)
    np.testing.assert_array_equal(layout.gather(out).numpy(), want.numpy())


@pytest.mark.parametrize("order,fct", [(2, True), (3, False)])
@pytest.mark.parametrize("my,mx", MESHES)
def test_advect_mpdata_sharded_bit_exact(ridge, my, mx, order, fct):
    """The ridge's stack with hydrometeor blobs, near-end clamp on."""
    s, g = ridge.state, ridge.geom_t
    names = ridge.advect_names
    r = np.random.default_rng(0)
    stack = torch.stack([s[k] for k in names]) + torch.tensor(np.where(
        r.uniform(size=(len(names),) + s["u"].shape[:1] + (NY, NX)) < 0.3,
        1e-3, 0.0).astype(np.float32))
    floors = torch.as_tensor(limit_floors(names))
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    want = kernels.advect_mpdata(stack, winds, 20.0, order, fct, floors,
                                 True)
    layout = _layout(my, mx, sk.mpdata_halo(order, fct))
    q = layout.scatter(stack)
    out = [torch.empty_like(b) for b in q]
    sk.advect_mpdata_sharded(layout, q, _winds(layout, s["u"], s["v"],
                                               s["w"], ridge.geom),
                             20.0, order, fct, _floors(layout, names), True,
                             out)
    np.testing.assert_array_equal(layout.gather(out).numpy(), want.numpy())


def _random_case(seed, S=3, nz=4, ny=22, nx=27):
    """Random species with sharp gradients, strong winds of both signs on
    both axes and metrics off one: every corrective pass and every FCT
    limit is active somewhere."""
    r = np.random.default_rng(seed)
    f = lambda *shape, lo, hi: torch.tensor(
        r.uniform(lo, hi, shape).astype(np.float32))
    g = SimpleNamespace(dx=1000.0, dz_levels=None,
                        jacobian_u=f(nz, ny, nx + 1, lo=0.8, hi=1.2),
                        jacobian_v=f(nz, ny + 1, nx, lo=0.8, hi=1.2),
                        jacobian_w=f(nz, ny, nx, lo=0.8, hi=1.2),
                        jacobian=f(nz, ny, nx, lo=0.8, hi=1.2),
                        advection_dz=f(nz, ny, nx, lo=200, hi=400))
    q = f(S, nz, ny, nx, lo=0.0, hi=1.0) ** 3
    return (q, f(nz, ny, nx + 1, lo=-25, hi=25), f(nz, ny + 1, nx, lo=-25,
                                                    hi=25),
            f(nz, ny, nx, lo=-2, hi=2), g)


def _per_block_plain(layout, q, u, v, w, g, order, fct):
    """MPDATA on each block of ``layout`` (as the wrapper runs it, without
    its halo check: the plain version on the CPU, K4 on the card),
    gathered."""
    floors = torch.tensor([-np.inf, 0.0, 0.0][:q.shape[0]], device=q.device)
    gb = [SimpleNamespace(dx=g.dx, **{k: b for k, b in zip(
        ("jacobian_u", "jacobian_v", "jacobian_w", "jacobian",
         "advection_dz"), blk)}) for blk in zip(
        *(layout.scatter(getattr(g, k)) for k in (
            "jacobian_u", "jacobian_v", "jacobian_w", "jacobian",
            "advection_dz")))]
    out = [kernels.advect_mpdata(qb, kernels.prepare_advect_winds(
        ub, vb, wb, gg), 30.0, order, fct, floors, True)
        for qb, ub, vb, wb, gg in zip(layout.scatter(q), layout.scatter(u),
                                      layout.scatter(v), layout.scatter(w),
                                      gb)]
    return layout.gather(out)


@pytest.mark.parametrize("fct", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_mpdata_halo_is_tight(order, fct):
    """Every owned cell is exact with a halo of ``mpdata_halo(order,
    fct)`` on a 2x2 mesh, for each of a few random states; with one cell
    less, some owned cell differs for at least one of them (a wrong value
    at the front of the reach does not always cross a limiter: at order 4
    with FCT two of six seeds need the full width). The wrapper refuses
    the narrower layout."""
    h = sk.mpdata_halo(order, fct)
    assert h == 1 + (order - 1) * (2 if fct else 1)
    floors = torch.tensor([-np.inf, 0.0, 0.0])
    short_differs = False
    for seed in range(100, 106):
        q, u, v, w, g = _random_case(seed)
        want = kernels.advect_mpdata(
            q, kernels.prepare_advect_winds(u, v, w, g), 30.0, order, fct,
            floors, True)
        exact = _per_block_plain(_layout(2, 2, h, 22, 27), q, u, v, w, g,
                                 order, fct)
        np.testing.assert_array_equal(exact.numpy(), want.numpy())
        short = _per_block_plain(_layout(2, 2, h - 1, 22, 27), q, u, v, w,
                                 g, order, fct)
        short_differs |= bool((short != want).any())
    assert short_differs, f"a halo of {h - 1} is enough"
    narrow = _layout(2, 2, h - 1, 22, 27)
    with pytest.raises(ValueError, match="halo"):
        sk.advect_mpdata_sharded(narrow, [None] * 4, [None] * 4, 30.0, order,
                                 fct, [None] * 4, True, [None] * 4)


def _case_blocks(layout, d):
    """The blocks of a test_torch_mpdata_kernel ``_case``: stack, winds
    prepared per block, floors."""
    g = SimpleNamespace(dx=1000.0, jacobian_u=d["jaco_u"],
                        jacobian_v=d["jaco_v"], jacobian_w=d["jaco_w"],
                        jacobian=d["jaco"], advection_dz=d["dz"])
    gb = [SimpleNamespace(dx=1000.0, **dict(zip(
        ("jacobian_u", "jacobian_v", "jacobian_w", "jacobian",
         "advection_dz"), blk))) for blk in zip(*(layout.scatter(getattr(
             g, k)) for k in ("jacobian_u", "jacobian_v", "jacobian_w",
                              "jacobian", "advection_dz")))]
    return [dict(q=qb, floors=d["floors"], winds=kernels.prepare_advect_winds(
        ub, vb, wb, gg)) for qb, ub, vb, wb, gg in zip(
        layout.scatter(d["q"]), layout.scatter(d["u"]),
        layout.scatter(d["v"]), layout.scatter(d["w"]), gb)]


@pytest.mark.parametrize("my,mx", [(2, 2), (4, 1)])
@pytest.mark.parametrize("fct", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_kernel_source_per_block_keeps_the_bits(cpu_kernel, my, mx, order,
                                                fct):
    """K4's source (g++ build, one thread per block) on each haloed block
    gives every owned cell the bits of its run on the whole domain; the
    case has a tile window where a species is zero (the skips)."""
    S, nz, ny, nx, zw = SHAPES["tiles"]
    d = _case(21, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    want = _run_cpu_kernel(cpu_kernel, d, dt, order, fct, True)
    layout = _layout(my, mx, sk.mpdata_halo(order, fct), ny, nx)
    got = [_run_cpu_kernel(cpu_kernel, b, dt, order, fct, True)
           for b in _case_blocks(layout, d)]
    assert torch.equal(layout.gather(got).view(torch.int32),
                       want.view(torch.int32))


def test_advect_mpdata_sharded_matches_jax():
    """The port's sharded MPDATA (order 2, FCT) on a 4x1 mesh against the
    JAX package's on 4 of the 8 virtual CPU devices (Pallas in interpret
    mode), from the JAX test's operands."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from icar_tpu.ops import pallas_kernels as pk
    from icar_tpu.parallel import shard_kernels as jsk
    from test_shard_kernels import _advect_operands

    m, stack, (u, v, w, dt, dx, ju, jv, jw, jc, dz) = _advect_operands(
        adv=C.ADV_MPDATA, mp=C.MP_THOMPSON)
    prev = pk.force_interpret(True)
    try:
        want = np.asarray(jsk.advect_mpdata_sharded(
            JaxMesh(np.array(jax.devices()[:4]).reshape(4, 1), ("y", "x")),
            stack, u, v, w, dt, dx, ju, jv, jw, jc, dz, order=2,
            use_fct=True))
    finally:
        pk.force_interpret(prev)
    ny, nx = np.asarray(w).shape[-2:]
    layout = _layout(4, 1, sk.mpdata_halo(2, True), ny, nx)
    q = layout.scatter(np.asarray(stack))
    out = [torch.empty_like(b) for b in q]
    sk.advect_mpdata_sharded(
        layout, q, _winds(layout, np.asarray(u), np.asarray(v),
                          np.asarray(w), m.geom),
        dt, 2, True, [torch.full((len(q[0]),), -np.inf)] * 4, False, out)
    np.testing.assert_allclose(layout.gather(out).numpy(), want, rtol=2e-5,
                               atol=1e-6)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("fct", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_card_per_shard_mpdata_keeps_the_bits(cuda, order, fct):
    """On the card, K4 launched per block of a 2x2 and a 4x1 mesh (every
    shard on one card) gives every owned cell the unsharded K4's bits."""
    q, u, v, w, g = _random_case(7, S=5, nz=6, ny=41, nx=70)
    q, u, v, w = (t.to(cuda) for t in (q, u, v, w))
    g = SimpleNamespace(dx=g.dx, **{k: getattr(g, k).to(cuda) for k in (
        "jacobian_u", "jacobian_v", "jacobian_w", "jacobian",
        "advection_dz")})
    floors = torch.tensor([-np.inf, 0.0, 0.0], device=cuda)
    want = kernels.advect_mpdata(q[:3], kernels.prepare_advect_winds(
        u, v, w, g), 30.0, order, fct, floors, True)
    for my, mx in ((2, 2), (4, 1)):
        got = _per_block_plain(_layout(my, mx, sk.mpdata_halo(order, fct),
                                       41, 70, cuda), q[:3], u, v, w, g,
                               order, fct)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))

"""The CUDA kernels K1 (advect_upwind), K2 (mp_simple), K3 (mp_simple_rho),
K4 (advect_mpdata) and K5 (mp_thompson) against their plain PyTorch
versions, on the card; and, on the CPU, that the kernel module imports and
dispatches without building anything.

The card tests carry the ``gpu`` marker and skip where
torch.cuda.is_available() is False (decided inside the fixture). On the
card: ``python -m pytest tests/test_torch_kernels.py -q``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icar_tpu_torch import constants as C
from icar_tpu_torch.core.step import limit_floors
from icar_tpu_torch.ops import advection as adv_plain
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.ops import mpdata as mpdata_plain
from icar_tpu_torch.physics import mp_simple as mp_plain
from icar_tpu_torch.physics import mp_thompson as thompson_plain
from icar_tpu_torch.physics import thompson_cases

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("potential_temperature", "water_vapor", "cloud_water",
         "rain_mass", "snow_mass")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture()
def ridge_state(cuda):
    """A ridge model on the card after one interval: clouds, rain, snow."""
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=70, ny=24, nz=16, dx=1000.0, hill_height=1200.0,
                          u_speed=12.0, rh=1.0, device=cuda)
    m.advance(1200.0)
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("near_end", [False, True])
def test_advect_kernel_matches_plain(ridge_state, near_end):
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in m.advect_names])
    floors = torch.as_tensor(limit_floors(m.advect_names), device=s["u"].device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    dt = np.float32(37.25)
    kernels.reset_launches()
    got = kernels.advect_upwind(stack, winds, dt, floors, near_end)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["advect_upwind"] == 1
    want = adv_plain.advect_upwind(stack, s["u"], s["v"], s["w"], dt, g.dx,
                                   g.jacobian_u, g.jacobian_v, g.jacobian_w,
                                   g.jacobian, g.advection_dz, floors=floors,
                                   near_end=near_end)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=5e-6, atol=1e-7)


@pytest.mark.gpu
def test_mp_kernel_matches_plain(ridge_state):
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in NAMES])
    p, ex, dz = s["pressure"], s["exner"], g.dz_interface
    rain = torch.rand_like(s["precipitation"])
    snow = torch.rand_like(rain)
    dt = np.float32(41.5)
    c2r, c2s = mp_plain.formation_rates(dt)
    rho = p / (C.RD * (stack[0] * ex))
    want = mp_plain.mp_simple(p, stack[0], ex, rho, *stack[1:], rain, snow,
                              dt, dz, c2r, c2s)
    work = stack.clone()
    acc = [rain.clone(), snow.clone()]
    kernels.reset_launches()
    kernels.mp_simple(*work, p, ex, dz, *acc, dt, c2r, c2s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mp_simple"] == 1
    for name, got, ref in zip(NAMES + ("rain", "snow"), list(work) + acc,
                              want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)


@pytest.mark.gpu
def test_main_path_launches_each_kernel_per_substep(cuda):
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=40, ny=12, nz=12, dx=1000.0, hill_height=800.0,
                          device=cuda)
    kernels.reset_launches()
    m.advance(900.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"advect_upwind": m.last_n_substeps,
                                "mp_simple": m.last_n_substeps,
                                "mp_simple_rho": 0, "advect_mpdata": 0,
                                "mp_thompson": 0, "density_fold": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("species", [5, 9])
@pytest.mark.parametrize("order,fct,near_end", [
    (1, True, True), (2, True, False), (2, True, True), (2, False, False),
    (3, True, True), (4, True, False)])
def test_mpdata_kernel_matches_plain(ridge_state, order, fct, near_end,
                                     species):
    """K4 against its plain version, rtol 2e-5, atol 1e-6 (the Pallas
    kernel's tolerance against jnp in tests/test_pallas.py), on the ridge's
    5 species and on a 9-species stack like the Thompson path's (the 5,
    two species that are zero everywhere, which the kernel skips, and two
    scaled copies)."""
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in m.advect_names])
    floors = torch.as_tensor(limit_floors(m.advect_names), device=s["u"].device)
    if species == 9:
        zero = torch.zeros_like(stack[2])
        stack = torch.cat([stack, torch.stack(
            [zero, 0.5 * stack[2], zero, 1e3 * stack[3]])])
        floors = torch.cat([floors, torch.zeros_like(floors[:4])])
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    dt = np.float32(37.25)
    kernels.reset_launches()
    got = kernels.advect_mpdata(stack, winds, dt, order, fct, floors,
                                near_end)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["advect_mpdata"] == 1
    want = mpdata_plain.advect_mpdata(
        stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u, g.jacobian_v,
        g.jacobian_w, g.jacobian, g.advection_dz, order=order, use_fct=fct,
        floors=floors, near_end=near_end)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.gpu
def test_mpdata_division_keeps_the_bits(cuda):
    """K4's branch-free division (hardware reciprocal estimate, two residual
    corrections, IEEE division outside its range) gives PyTorch's IEEE
    a / b bit for bit on 2^24 pairs over the whole float32 range."""
    from test_torch_mpdata_kernel import div_operands, same_bits
    a, b = (torch.tensor(x, device=cuda) for x in div_operands(9, 1 << 24))
    q = torch.empty_like(a)
    err = kernels.library().icar_mpdata_div(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), a.numel(),
        torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    want = a / b
    torch.cuda.synchronize()
    assert same_bits(q.cpu().numpy(), want.cpu().numpy()).all()


@pytest.mark.gpu
def test_mp_rho_kernel_matches_plain(ridge_state):
    """K3 with a density that is not p/(Rd*T), against its plain version
    (K2's tolerance)."""
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in NAMES])
    p, ex, dz = s["pressure"], s["exner"], g.dz_interface
    gen = torch.Generator(device=p.device).manual_seed(5)
    rho = (p / (C.RD * (stack[0] * ex))) * (
        0.7 + 0.6 * torch.rand(p.shape, generator=gen, device=p.device))
    rain = torch.rand_like(s["precipitation"])
    snow = torch.rand_like(rain)
    dt = np.float32(41.5)
    c2r, c2s = mp_plain.formation_rates(dt)
    want = mp_plain.mp_simple(p, stack[0], ex, rho, *stack[1:], rain, snow,
                              dt, dz, c2r, c2s)
    work = stack.clone()
    acc = [rain.clone(), snow.clone()]
    kernels.reset_launches()
    kernels.mp_simple_rho(*work, p, ex, rho, dz, *acc, dt, c2r, c2s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mp_simple_rho"] == 1
    for name, got, ref in zip(NAMES + ("rain", "snow"), list(work) + acc,
                              want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)


def _mp_kernel_matches_plain(state, dt, rho_operand):
    """K2 (or K3 with the state's density) on ``state`` (a list in the order
    of chip_smoke.ridge_columns) against the plain version, K2's
    tolerance."""
    p, th, ex, rho, qv, qc, qr, qs, rain, snow, dz = (
        torch.tensor(a, device="cuda") for a in state)
    c2r, c2s = mp_plain.formation_rates(dt)
    if not rho_operand:
        rho = p / (C.RD * (th * ex))
    want = mp_plain.mp_simple(p, th, ex, rho, qv, qc, qr, qs, rain, snow, dt,
                              dz, c2r, c2s)
    work = [t.clone() for t in (th, qv, qc, qr, qs, rain, snow)]
    kernels.reset_launches()
    if rho_operand:
        kernels.mp_simple_rho(*work[:5], p, ex, rho, dz, *work[5:], dt, c2r,
                              c2s)
    else:
        kernels.mp_simple(*work[:5], p, ex, dz, *work[5:], dt, c2r, c2s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mp_simple_rho" if rho_operand
                            else "mp_simple"] == 1
    for name, got, ref in zip(NAMES + ("rain", "snow"), work, want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("rho_operand", [False, True])
def test_mp_kernel_at_max_nz(cuda, rho_operand):
    """K2 and K3 take more levels than K4 since their tiled redesign: at 96
    levels (8-column tiles, a ragged last tile) and at their own limit
    (one-column tiles that fill a block's shared memory) they match the
    plain version; one level more raises, and a card model on the MPDATA
    path is still refused for K4."""
    from icar_tpu_torch.models.icar import ideal_ridge_model
    from chip_smoke import ridge_columns
    _mp_kernel_matches_plain(ridge_columns(5, 96, 3, 9), np.float32(40.0),
                             rho_operand)
    nz = kernels.library().icar_mp_simple_max_nz()
    assert nz == kernels.MAX_NZ["mp_simple"] > 64
    assert kernels.library().icar_mp_simple_tile_columns(nz) == 1
    _mp_kernel_matches_plain(ridge_columns(5, nz, 1, 3, depth=12000.0),
                             np.float32(1.0), rho_operand)
    big = [torch.tensor(a, device=cuda)
           for a in ridge_columns(5, nz + 1, 1, 2, depth=12000.0)]
    with pytest.raises(ValueError, match="exceeds"):
        kernels.mp_simple(big[1], *big[4:8], big[0], big[2], big[10],
                          *big[8:10], 1.0, 0.9, 0.99)
    with pytest.raises(ValueError, match="advect_mpdata"):
        ideal_ridge_model(nx=20, ny=8, nz=65, adv=C.ADV_MPDATA, device=cuda)


@pytest.mark.gpu
def test_mpdata_path_launches_each_kernel_per_substep(cuda):
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=40, ny=12, nz=12, dx=1000.0, hill_height=800.0,
                          adv=C.ADV_MPDATA, device=cuda)
    kernels.reset_launches()
    m.advance(900.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"advect_upwind": 0, "mp_simple": 0,
                                "mp_simple_rho": m.last_n_substeps,
                                "advect_mpdata": m.last_n_substeps,
                                "mp_thompson": 0, "density_fold": 0}


def _k5_matches_plain(state, dt, order=tuple(range(9))):
    """K5 on the stack rows ``order`` against the plain version, held to
    chip_smoke.py's tolerance (thompson_cases.compare; on the card the two
    agree bit for bit in its runs)."""
    q, ex, p, dz = thompson_cases.as_stack(state, "cuda")
    stack = torch.empty_like(q)
    for i, row in enumerate(order):
        stack[row] = q[i]
    acc = [torch.rand(q.shape[2:], device=q.device) for _ in range(3)]
    want = thompson_plain.mp_thompson(*q, ex, p, dz, dt, *acc)
    got_acc = [a.clone() for a in acc]
    kernels.reset_launches()
    kernels.mp_thompson_stack(stack, order, ex, p, dz, dt, *got_acc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mp_thompson"] == 1
    thompson_cases.compare([stack[row] for row in order] + got_acc, want)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,dt", [(1, 30.0), (2, 90.0), (3, 150.0)])
def test_thompson_kernel_matches_plain(cuda, seed, dt):
    """Mixed regimes; 7 x 13 columns, so the grid's last block is ragged;
    a permuted stack order."""
    _k5_matches_plain(thompson_cases.mixed_state(seed), np.float32(dt),
                      order=(3, 0, 8, 1, 2, 7, 4, 6, 5))


@pytest.mark.gpu
def test_thompson_kernel_at_max_nz(cuda):
    """K5 takes more levels than K2-K4: at 80 levels (8-column tiles, a
    ragged last tile) and at its own limit (one-column tiles) it matches
    the plain version; one level more raises. A model deeper than its
    path's kernels take is refused before it is built."""
    from icar_tpu_torch.models.icar import ideal_ridge_model
    _k5_matches_plain(thompson_cases.mixed_state(4, 80, 5, 9, 100.0),
                      np.float32(60.0))
    nz = kernels.library().icar_mp_thompson_max_nz()
    assert nz == kernels.MAX_NZ["mp_thompson"] > 64
    _k5_matches_plain(thompson_cases.mixed_state(4, nz, 1, 3, 8000.0 / nz),
                      np.float32(60.0))
    big = thompson_cases.as_stack(
        thompson_cases.mixed_state(4, nz + 1, 2, 3, 8000.0 / (nz + 1)), cuda)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.mp_thompson_stack(big[0], tuple(range(9)), *big[1:], 60.0,
                                  *(torch.zeros((2, 3), device=cuda),) * 3)
    with pytest.raises(ValueError, match="advect_mpdata"):
        ideal_ridge_model(nx=20, ny=8, nz=65, mp=C.MP_THOMPSON,
                          adv=C.ADV_MPDATA, device=cuda)


@pytest.mark.gpu
def test_thompson_kernel_inert_state(cuda):
    _k5_matches_plain(thompson_cases.inert_state(20, 7, 13),
                      np.float32(45.0))


@pytest.mark.gpu
def test_thompson_path_launches_each_kernel_per_substep(cuda):
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=40, ny=12, nz=12, dx=1000.0, hill_height=800.0,
                          mp=C.MP_THOMPSON, adv=C.ADV_MPDATA, device=cuda)
    kernels.reset_launches()
    m.advance(900.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"advect_upwind": 0, "mp_simple": 0,
                                "mp_simple_rho": 0,
                                "advect_mpdata": m.last_n_substeps,
                                "mp_thompson": m.last_n_substeps,
                                "density_fold": 0}


def test_thompson_wrapper_on_cpu_tensors_builds_and_launches_nothing(
        tmp_path):
    """K5's wrapper on CPU tensors runs the plain version: the same values
    as the plain function, no launch counted, no library built (nvcc is
    not on the path)."""
    code = ("import pathlib, sys, numpy as np, torch\n"
            "import icar_tpu_torch.ops.kernels as k\n"
            "from icar_tpu_torch.physics import mp_thompson as tp\n"
            "k.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "r = np.random.default_rng(0)\n"
            "q = torch.tensor(r.uniform(0, 1e-3, (9, 6, 4, 5)),\n"
            "                 dtype=torch.float32)\n"
            "q[0] = 290.0; q[1] = 0.01; q[7] = 1e5; q[8] = 1e5\n"
            "ex = torch.full((6, 4, 5), 0.95); p = torch.full((6, 4, 5), 8e4)\n"
            "dz = torch.full((6, 4, 5), 300.0)\n"
            "z = torch.zeros(4, 5)\n"
            "want = tp.mp_thompson_stack(q, tp.SPECIES, ex, p, dz, 30.0,\n"
            "                            z, z, z)\n"
            "acc = [z.clone() for _ in range(3)]\n"
            "k.mp_thompson_stack(q, tuple(range(9)), ex, p, dz, 30.0, *acc)\n"
            "assert torch.equal(q, want[0])\n"
            "assert all(torch.equal(a, w) for a, w in zip(acc, want[1:]))\n"
            "assert set(k.LAUNCHES.values()) == {0}\n"
            "assert k._LIB is None and k.BUILD_INFO == {}\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH=os.path.dirname(
        sys.executable), CUDA_HOME=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert not list(tmp_path.iterdir())


def test_kernel_module_builds_nothing_at_import(tmp_path):
    code = ("import pathlib, sys\n"
            "import icar_tpu_torch.ops.kernels as k\n"
            "assert k._LIB is None and k.BUILD_INFO == {}\n"
            "k.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "try:\n"
            "    k.build()\n"
            "except RuntimeError as e:\n"
            "    assert 'nvcc not found' in str(e), e\n"
            "else:\n"
            "    raise AssertionError('built without nvcc')\n")
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert not list(tmp_path.iterdir())


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=24, ny=8, nz=12, hill_height=800.0,
                          device="cpu")
    kernels.reset_launches()
    m.advance(300.0)
    assert m.last_n_substeps > 0
    assert set(kernels.LAUNCHES.values()) == {0}


def test_cpu_tensors_take_the_plain_versions_on_the_mpdata_path():
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(nx=24, ny=8, nz=12, hill_height=800.0,
                          adv=C.ADV_MPDATA, device="cpu")
    kernels.reset_launches()
    m.advance(300.0)
    assert m.last_n_substeps > 0
    assert set(kernels.LAUNCHES.values()) == {0}


def test_wrappers_reject_other_devices():
    q = torch.zeros((5, 4, 6, 7), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.advect_upwind(q, None, 1.0, None, False)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.advect_mpdata(q, None, 1.0, 2, True, None, False)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mp_thompson_stack(torch.zeros((9, 4, 6, 7), device="meta"),
                                  tuple(range(9)), None, None, None, 1.0,
                                  None, None, None)
    t = torch.zeros((4, 6, 7), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mp_simple(t, t, t, t, t, t, t, t, t[0], t[0], 1.0, 0.9, 0.9)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mp_simple_rho(t, t, t, t, t, t, t, t, t, t[0], t[0], 1.0,
                              0.9, 0.9)


@pytest.mark.gpu
@pytest.mark.parametrize("near_end", [False, True])
def test_advect_kernel_equals_kernel_order_oracle(ridge_state, near_end):
    """K1 gives every bit of the plain update formed from its own scaled
    winds (chip_smoke.upwind_oracle), on the ridge's state and on a random
    stack of 9 species and 96 levels."""
    from chip_smoke import random_mpdata_case, upwind_oracle
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in m.advect_names])
    floors = torch.as_tensor(limit_floors(m.advect_names), device=s["u"].device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    cases = [(stack, winds, floors)]
    q, u, v, w, rg, fl = random_mpdata_case(s["u"].device, (9, 96, 23, 41))
    cases.append((q, kernels.prepare_advect_winds(u, v, w, rg), fl))
    for q, wd, fl in cases:
        got = kernels.advect_upwind(q, wd, np.float32(37.25), fl, near_end)
        want = upwind_oracle(q, wd, np.float32(37.25), fl, near_end)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) == 0.0


@pytest.mark.gpu
def test_advect_kernel_on_an_empty_stack_launches_nothing(cuda):
    """K1 on a stack of no species returns an empty result and counts no
    launch."""
    from chip_smoke import random_mpdata_case
    q, u, v, w, rg, fl = random_mpdata_case(cuda, (2, 4, 9, 13))
    winds = kernels.prepare_advect_winds(u, v, w, rg)
    before = kernels.LAUNCHES["advect_upwind"]
    got = kernels.advect_upwind(q[:0], winds, np.float32(20.0), fl[:0], True)
    torch.cuda.synchronize()
    assert got.shape == (0, 4, 9, 13)
    assert kernels.LAUNCHES["advect_upwind"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("near_end", [False, True])
def test_advect_kernels_on_density_weighted_operands(ridge_state, near_end):
    """Density advection: the fold kernel (``density_winds``, one launch)
    gives its plain version's bits; K1 and K4 on the operands it weights
    by the state's density, against the plain versions with that density
    (K1 at rtol 5e-6, atol 1e-7 and every bit of its kernel-order oracle
    on the weighted operands; K4 at order 2 with FCT, rtol 2e-5, atol
    1e-6), one launch each."""
    from chip_smoke import upwind_oracle
    m = ridge_state
    s, g = m.state, m.geom_t
    stack = torch.stack([s[k] for k in m.advect_names])
    floors = torch.as_tensor(limit_floors(m.advect_names), device=s["u"].device)
    rho = s["density"]
    kernels.reset_launches()
    plain = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    winds = kernels.density_winds(plain, rho)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["density_fold"] == 1
    for got, want in zip((winds.uj, winds.vj, winds.wj, winds.jaco),
                         kernels.fold_plain(plain, rho)):
        assert torch.equal(got, want)
    dt = np.float32(37.25)
    raw = (stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u,
           g.jacobian_v, g.jacobian_w, g.jacobian, g.advection_dz)
    got1 = kernels.advect_upwind(stack, winds, dt, floors, near_end)
    got4 = kernels.advect_mpdata(stack, winds, dt, 2, True, floors, near_end)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["advect_upwind"] == 1
    assert kernels.LAUNCHES["advect_mpdata"] == 1
    want1 = adv_plain.advect_upwind(*raw, floors=floors, near_end=near_end,
                                    rho=rho, advect_density=True)
    np.testing.assert_allclose(got1.cpu().numpy(), want1.cpu().numpy(),
                               rtol=5e-6, atol=1e-7)
    assert float((got1 - upwind_oracle(stack, winds, dt, floors, near_end))
                 .abs().max()) == 0.0
    want4 = mpdata_plain.advect_mpdata(*raw, order=2, use_fct=True,
                                       advect_density=True, floors=floors,
                                       near_end=near_end, rho=rho)
    np.testing.assert_allclose(got4.cpu().numpy(), want4.cpu().numpy(),
                               rtol=2e-5, atol=1e-6)

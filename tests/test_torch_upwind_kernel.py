"""The CUDA source of kernel K1 (icar_tpu_torch/csrc/advect_upwind.cu, whose
tiled kernel in upwind.cuh is also K4's upwind pass), compiled for the CPU
with g++ against the stub CUDA headers of test_torch_mpdata_kernel and run
one thread per block (that thread takes every column of a tile; cp.async
becomes a plain copy).

Held two ways: to the plain version (icar_tpu_torch/ops/advection.py) at
K1_RTOL/K1_ATOL of chip_smoke.py (rtol 5e-6, atol 1e-7: the kernel scales
the winds as (u*J_u/dx)*dt, the plain version as u*(dt/dx)*J_u), and to
the kernel-order oracle (chip_smoke.upwind_oracle: the plain update from
the kernel's own scaled winds) at max_abs_err 0.0. The near-end clamp on
and off, planes whose sizes are not multiples of a tile, nz = 2, 96
levels, 3, 9 and 11 species (one group smaller than the block's, then
two and three groups), species that are +0 over whole tiles, and an empty
stack.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import upwind_oracle
from icar_tpu_torch.ops import advection as adv_plain
from test_torch_mpdata_kernel import (SHAPES, _STUB_RUNTIME, _case,
                                      with_density, write_upwind_header)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_RTOL, K1_ATOL = 5e-6, 1e-7
# (S, nz, ny, nx, zero window of species 1) beyond SHAPES: 3, 9 and 11
# species (groups of 3; 5 and 4; 4, 4 and 3); 96 levels; a plane that no
# tile of 2 or 4 rows by 32, 64 or 128 columns divides; a species so small
# (tiny: scaled by 1e-25) that its divisions leave the branch-free
# division's range
ORACLE_SHAPES = dict(SHAPES, species3=(3, 5, 11, 29, None),
                     species9=(9, 6, 23, 41, None),
                     species11=(11, 4, 9, 27, None),
                     levels96=(4, 96, 13, 37, None),
                     ragged=(5, 7, 37, 99, (slice(17, 34), slice(33, 66))),
                     tiny=(4, 5, 19, 37, None))


def _build(d, name):
    lib = d / f"lib{name}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC",
                    "-shared", f"-I{d}", "-o", str(lib),
                    str(d / "k1.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.icar_advect_upwind.argtypes = [P] * 8 + [I, I, I, I, F, I, P]
    so.icar_advect_upwind.restype = I
    so.icar_advect_upwind_config.argtypes = [I, P]
    so.icar_advect_upwind_config.restype = I
    return so


@pytest.fixture(scope="module")
def k1_dir(tmp_path_factory):
    """advect_upwind.cu and upwind.cuh prepared for g++ against the stub
    runtime."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("k1cpu")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    write_upwind_header(d)
    shutil.copy(os.path.join(REPO, "icar_tpu_torch", "csrc",
                             "advect_upwind.cu"), d / "k1.cpp")
    return d


@pytest.fixture(scope="module")
def cpu_k1(k1_dir):
    return _build(k1_dir, "k1")


def _run(so, d, dt, near_end):
    q, w = d["q"], d["winds"]
    S, nz, ny, nx = q.shape
    out = torch.full_like(q, float("nan"))
    err = so.icar_advect_upwind(
        q.data_ptr(), out.data_ptr(), w.uj.data_ptr(), w.vj.data_ptr(),
        w.wj.data_ptr(), w.dz.data_ptr(), w.jaco.data_ptr(),
        d["floors"].data_ptr(), S, nz, ny, nx, float(dt), int(near_end),
        None)
    assert err == 0
    return out


def _oracle_err(got, d, dt, near_end):
    want = upwind_oracle(d["q"], d["winds"], dt, d["floors"], near_end)
    assert torch.isfinite(got).all()
    return float((got - want).abs().max())


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("shape", ["tiles", "nz2", "small"])
def test_k1_source_matches_plain(cpu_k1, shape, near_end):
    S, nz, ny, nx, zw = SHAPES[shape]
    d = _case(21, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    got = _run(cpu_k1, d, dt, near_end)
    want = adv_plain.advect_upwind(
        d["q"], d["u"], d["v"], d["w"], dt, 1000.0, d["jaco_u"],
        d["jaco_v"], d["jaco_w"], d["jaco"], d["dz"], floors=d["floors"],
        near_end=near_end)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K1_RTOL,
                               atol=K1_ATOL)


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("shape", sorted(ORACLE_SHAPES))
def test_k1_source_equals_kernel_order_oracle(cpu_k1, shape, near_end):
    """Every cell, species and level gives the oracle's value exactly; a
    species +0 everywhere gives max(0, floor) or 0."""
    S, nz, ny, nx, zw = ORACLE_SHAPES[shape]
    d = _case(23, S, nz, ny, nx, zw)
    if shape == "tiny":
        d["q"][3] *= 1e-25
    dt = np.float32(20.0)
    got = _run(cpu_k1, d, dt, near_end)
    assert _oracle_err(got, d, dt, near_end) == 0.0
    floor = float(d["floors"][2]) if near_end else 0.0
    assert torch.equal(got[2], torch.full_like(got[2], max(0.0, floor)))


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("shape", ["tiles", "ragged", "species9"])
def test_k1_source_on_density_weighted_operands(cpu_k1, shape, near_end):
    """Density advection runs K1 unchanged on the density-weighted
    operands (``kernels.density_winds``): every bit of the kernel-order
    oracle on them, and the plain upwind with density within
    K1_RTOL/K1_ATOL."""
    S, nz, ny, nx, zw = ORACLE_SHAPES[shape]
    d = with_density(_case(27, S, nz, ny, nx, zw), 5)
    dt = np.float32(20.0)
    got = _run(cpu_k1, d, dt, near_end)
    assert _oracle_err(got, d, dt, near_end) == 0.0
    want = adv_plain.advect_upwind(
        d["q"], d["u"], d["v"], d["w"], dt, 1000.0, d["jaco_u"],
        d["jaco_v"], d["jaco_w"], d["jaco"], d["dz"], floors=d["floors"],
        near_end=near_end, rho=d["rho"], advect_density=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K1_RTOL,
                               atol=K1_ATOL)


def test_k1_empty_stack_launches_nothing(cpu_k1):
    """A stack of no species returns success without a launch; its launch
    shape has a group of 0."""
    d = _case(26, 3, 4, 9, 13)
    d["q"], d["floors"] = d["q"][:0], d["floors"][:0]
    assert _run(cpu_k1, d, np.float32(20.0), True).numel() == 0
    cfg = (ctypes.c_int * 6)()
    assert cpu_k1.icar_advect_upwind_config(0, cfg) == 0
    assert cfg[3] == 0


def test_k1_config_reports_the_launch(cpu_k1):
    """icar_advect_upwind_config: the tile, the threads (one per block in
    this build), the species group (5 and 4 for 9 species, as even as
    they go) and the shared memory of three q levels of the group and two
    face levels."""
    cfg = (ctypes.c_int * 6)()
    for S, group in ((1, 1), (5, 5), (9, 5), (11, 4)):
        assert cpu_k1.icar_advect_upwind_config(S, cfg) == 0
        tx, ty, threads, g, smem, _ = list(cfg)
        assert (tx, ty, threads, g) == (128, 2, 1, group)
        planes = 3 * g * (ty + 2) * (tx + 2) + 2 * (ty * (tx + 1)
                                                     + (ty + 1) * tx)
        assert smem == 4 * planes

"""The CUDA source of kernel K1 (icar_tpu_torch/csrc/advect_upwind.cu, whose
tiled kernel in upwind.cuh is also K4's upwind pass), compiled for the CPU
with g++ against the stub CUDA headers of test_torch_mpdata_kernel and run
one thread per block, against the plain version
(icar_tpu_torch/ops/advection.py).

The near-end clamp on and off, planes whose sizes are not multiples of the
kernel's 32 x 8 tile, nz = 2, and species that are +0 over a whole tile
window (the skip, which must keep the bits of a build without it).
Tolerance K1_RTOL/K1_ATOL of chip_smoke.py (rtol 5e-6, atol 1e-7): the
kernel scales the winds as (u*J_u/dx)*dt, the plain version as
u*(dt/dx)*J_u.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from icar_tpu_torch.ops import advection as adv_plain
from test_torch_mpdata_kernel import SHAPES, _STUB_RUNTIME, _case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_RTOL, K1_ATOL = 5e-6, 1e-7
_LAUNCH = ("upwind_tile_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(",
           "UPWIND_LAUNCH(")


def _build(d, name, defines=()):
    lib = d / f"lib{name}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC",
                    "-shared", f"-I{d}", *defines, "-o", str(lib),
                    str(d / "k1.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.icar_advect_upwind.argtypes = [P] * 8 + [I, I, I, I, F, I, P]
    so.icar_advect_upwind.restype = I
    return so


@pytest.fixture(scope="module")
def cpu_k1(tmp_path_factory):
    """advect_upwind.cu (with upwind.cuh) built by g++ against the stub
    runtime, with and without the skip of +0 tiles."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("k1cpu")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    csrc = os.path.join(REPO, "icar_tpu_torch", "csrc")
    shutil.copy(os.path.join(csrc, "upwind.cuh"), d / "upwind.cuh")
    src = open(os.path.join(csrc, "advect_upwind.cu")).read()
    assert src.count(_LAUNCH[0]) == 1
    (d / "k1.cpp").write_text(src.replace(*_LAUNCH))
    return _build(d, "k1"), _build(d, "k1noskip", ["-DADVECT_NO_SKIP"])


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


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("shape", ["tiles", "nz2", "small"])
def test_k1_source_matches_plain(cpu_k1, shape, near_end):
    S, nz, ny, nx, zw = SHAPES[shape]
    d = _case(21, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    got = _run(cpu_k1[0], d, dt, near_end)
    want = adv_plain.advect_upwind(
        d["q"], d["u"], d["v"], d["w"], dt, 1000.0, d["jaco_u"],
        d["jaco_v"], d["jaco_w"], d["jaco"], d["dz"], floors=d["floors"],
        near_end=near_end)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K1_RTOL,
                               atol=K1_ATOL)


@pytest.mark.parametrize("near_end", [False, True])
def test_k1_skip_keeps_the_bits(cpu_k1, near_end):
    """A species that is +0 over a tile's window is only stored: the same
    bits as a build without the skip, max(0, floor) or 0 there."""
    S, nz, ny, nx, zw = SHAPES["tiles"]
    d = _case(22, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    on = _run(cpu_k1[0], d, dt, near_end)
    off = _run(cpu_k1[1], d, dt, near_end)
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    floor = float(d["floors"][2]) if near_end else 0.0
    assert torch.equal(on[2], torch.full_like(on[2], max(0.0, floor)))

"""The CUDA source of kernel K4 (icar_tpu_torch/csrc/mpdata.cu), compiled
for the CPU with g++ against stub CUDA headers and run one thread per
block, against the plain version (icar_tpu_torch/ops/mpdata.py).

The kernel's tile loops are block-stride between barriers, so one thread
per block runs the same arithmetic as the card does; the launches are
replaced by loops over the blocks. Orders 1-4, FCT on and off, the near-end
clamp on and off, nz = 2, planes whose sizes are not multiples of the
kernel's 32 x 8 tile, and species that are zero over a whole tile window
(the skip). Tolerance K4_RTOL/K4_ATOL of chip_smoke.py (rtol 2e-5, atol
1e-6): the kernel scales the winds as (u*J_u/dx)*dt, the plain version as
u*(dt/dx)*J_u, so the two differ by a few float32 ulp.
"""

import ctypes
import os
import re
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from icar_tpu_torch.ops import kernels
from icar_tpu_torch.ops import mpdata as mpdata_plain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4_RTOL, K4_ATOL = 2e-5, 1e-6

_STUB_RUNTIME = """#pragma once
#include <math.h>
#include <string.h>
#include <algorithm>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
static dim3 blockIdx, threadIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F,
                                                                 int, int) {
  *n = 1;
  return cudaSuccess;
}
inline unsigned long __cvta_generic_to_shared(const void*) { return 0; }
// K1's kernel (upwind.cuh) with one thread per block: that thread takes
// every column of the tile
#define UPWIND_THREADS 1
// one thread per block for the upwind and corrective passes (they have
// barriers); every thread in turn for the elementwise division
#define PASS_LAUNCH(...)                                          \\
  do {                                                            \\
    blockDim.x = 1; threadIdx.x = 0;                              \\
    for (unsigned by_ = 0; by_ < tiles.y; ++by_)                  \\
      for (unsigned bx_ = 0; bx_ < tiles.x; ++bx_) {              \\
        blockIdx.x = bx_; blockIdx.y = by_;                       \\
        mpdata_pass_kernel(__VA_ARGS__);                          \\
      }                                                           \\
  } while (0)
#define DIV_LAUNCH(...)                                           \\
  do {                                                            \\
    blockDim.x = THREADS; threadIdx.x = 0;                        \\
    for (long b_ = 0; b_ < blocks * THREADS; ++b_) {              \\
      blockIdx.x = (unsigned)(b_ / THREADS);                      \\
      threadIdx.x = (unsigned)(b_ % THREADS);                     \\
      div_kernel(__VA_ARGS__);                                    \\
    }                                                             \\
  } while (0)
#define UPWIND_LAUNCH(...)                                        \\
  do {                                                            \\
    blockDim.x = 1; threadIdx.x = 0;                              \\
    for (unsigned by_ = 0; by_ < grid.y; ++by_)                   \\
      for (unsigned bx_ = 0; bx_ < grid.x; ++bx_) {               \\
        blockIdx.x = bx_; blockIdx.y = by_;                       \\
        upwind_tile_kernel(__VA_ARGS__);                          \\
      }                                                           \\
  } while (0)
"""
_REPLACE = (
    ("extern __shared__ float mpdata_smem[];",
     "static float mpdata_smem[1 << 16];"),
    ("div_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(",
     "DIV_LAUNCH("),
    ("mpdata_pass_kernel<<<tiles, THREADS, smem, st>>>(", "PASS_LAUNCH("),
)
# upwind.cuh (K1's kernel, also K4's upwind pass) for g++: the launch
# becomes a loop over the blocks, the dynamic shared memory a static array
# and each cp.async a plain copy (commit and wait have nothing to do)
_UPWIND_REPLACE = (
    ("upwind_tile_kernel<<<grid, UP_THREADS, smem, st>>>(", "UPWIND_LAUNCH("),
    ("extern __shared__ float upwind_smem[];",
     "static float upwind_smem[1 << 16];"),
)
_UPWIND_ASYNC = (
    (r'asm volatile\("cp\.async\.ca\.shared\.global .*?\);',
     "*dst = *src;"),
    (r'asm volatile\("cp\.async\.commit_group.*?\);', ""),
    (r'asm volatile\("cp\.async\.wait_group.*?\);', ""),
)


def write_upwind_header(d):
    """csrc/upwind.cuh prepared for g++, into the directory ``d``."""
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "upwind.cuh")).read()
    for old, new in _UPWIND_REPLACE:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    for pattern, new in _UPWIND_ASYNC:
        src, n = re.subn(pattern, new, src, flags=re.S)
        assert n == 1, pattern
    (d / "upwind.cuh").write_text(src)


def _build(d, src, name, defines=()):
    lib = d / f"lib{name}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC",
                    "-shared", f"-I{d}", *defines, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.icar_advect_mpdata.argtypes = [P] * 9 + [I, I, I, I, F, I, I, I, P]
    so.icar_advect_mpdata.restype = I
    so.icar_advect_mpdata_max_nz.restype = I
    so.icar_mpdata_div.argtypes = [P, P, P, ctypes.c_long, P]
    so.icar_mpdata_div.restype = I
    return so


@pytest.fixture(scope="module")
def cpu_source(tmp_path_factory):
    """csrc/mpdata.cu (with upwind.cuh) prepared for g++: the stub runtime
    beside it, the launches replaced by loops over the blocks."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("k4cpu")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    write_upwind_header(d)
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "mpdata.cu")).read()
    for old, new in _REPLACE:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (d / "k4.cpp").write_text(src)
    return d


@pytest.fixture(scope="module")
def cpu_kernel(cpu_source):
    """The kernel source built by g++ against the stub runtime: no FMA
    contraction, no fast math, as nvcc builds it."""
    return _build(cpu_source, cpu_source / "k4.cpp", "k4")


@pytest.fixture(scope="module")
def cpu_kernel_no_skip(cpu_source):
    """The same, built with the skips of +0 tiles and levels turned off."""
    return _build(cpu_source, cpu_source / "k4.cpp", "k4noskip",
                  ["-DADVECT_NO_SKIP"])


def _case(seed, S, nz, ny, nx, zero_window=None):
    """A random stack with winds and metrics; species 2 is zero everywhere,
    species 1 from level 3 up, and with ``zero_window`` (rows, cols) also
    there at every level."""
    r = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    q = r.uniform(0.1, 1.0, (S, nz, ny, nx))
    q[2] = 0.0
    q[1, 3:] = 0.0
    if zero_window is not None:
        q[1, :, zero_window[0], zero_window[1]] = 0.0
    d = dict(q=f(q), u=f(r.uniform(-6, 6, (nz, ny, nx + 1))),
             v=f(r.uniform(-6, 6, (nz, ny + 1, nx))),
             w=f(r.uniform(-1, 1, (nz, ny, nx))),
             dz=f(r.uniform(200, 400, (nz, ny, nx))),
             jaco=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
             jaco_u=f(r.uniform(0.8, 1.2, (nz, ny, nx + 1))),
             jaco_v=f(r.uniform(0.8, 1.2, (nz, ny + 1, nx))),
             jaco_w=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
             floors=f(np.resize([-np.inf, 0.0, 0.0, 0.5], S)))
    d["winds"] = kernels.prepare_advect_winds(d["u"], d["v"], d["w"],
                                              SimpleNamespace(
        dx=1000.0, jacobian_u=d["jaco_u"], jacobian_v=d["jaco_v"],
        jacobian_w=d["jaco_w"], advection_dz=d["dz"], jacobian=d["jaco"]))
    return d


def _run_cpu_kernel(so, d, dt, order, fct, near_end):
    q, w = d["q"], d["winds"]
    S, nz, ny, nx = q.shape
    out = torch.full_like(q, float("nan"))
    scratch = torch.full((min(order - 1, 2),) + tuple(q.shape), float("nan"))
    err = so.icar_advect_mpdata(
        q.data_ptr(), out.data_ptr(), scratch.data_ptr(), w.uj.data_ptr(),
        w.vj.data_ptr(), w.wj.data_ptr(), w.dz.data_ptr(), w.jaco.data_ptr(),
        d["floors"].data_ptr(), S, nz, ny, nx, float(dt), order, int(fct),
        int(near_end), None)
    assert err == 0
    return out


def _plain(d, dt, order, fct, near_end):
    return mpdata_plain.advect_mpdata(
        d["q"], d["u"], d["v"], d["w"], dt, 1000.0, d["jaco_u"],
        d["jaco_v"], d["jaco_w"], d["jaco"], d["dz"], order=order,
        use_fct=fct, floors=d["floors"], near_end=near_end)


# (S, nz, ny, nx, zero window of species 1): a plane of 3 x 2 tiles whose
# middle tile's haloed window is zero in species 1; nz = 2; a plane
# smaller than one tile
SHAPES = {"tiles": (4, 6, 30, 70, (slice(6, 19), slice(30, 67))),
          "nz2": (4, 2, 19, 37, None),
          "small": (3, 4, 9, 13, None)}


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("fct", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_kernel_source_matches_plain(cpu_kernel, order, fct, near_end):
    S, nz, ny, nx, zw = SHAPES["tiles"]
    d = _case(11, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    got = _run_cpu_kernel(cpu_kernel, d, dt, order, fct, near_end)
    want = _plain(d, dt, order, fct, near_end)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K4_RTOL,
                               atol=K4_ATOL)


def with_density(d, seed):
    """``d`` with a seeded density falling with height (``rho``) and its
    kernel operands weighted by it (``kernels.density_winds``)."""
    r = np.random.default_rng(seed)
    nz, ny, nx = d["dz"].shape
    rho = (np.linspace(1.2, 0.6, nz)[:, None, None]
           * r.uniform(0.9, 1.1, (nz, ny, nx)))
    d = dict(d, rho=torch.tensor(rho.astype(np.float32)))
    d["winds"] = kernels.density_winds(d["winds"], d["rho"])
    return d


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("order,fct", [(1, False), (2, True), (2, False),
                                       (3, True)])
def test_kernel_source_on_density_weighted_operands(cpu_kernel, order, fct,
                                                    near_end):
    """Density advection runs K4 unchanged on the density-weighted
    operands: held to the plain MPDATA with density (G = J*rho) at K4's
    tolerance."""
    S, nz, ny, nx, zw = SHAPES["tiles"]
    d = with_density(_case(12, S, nz, ny, nx, zw), 3)
    dt = np.float32(20.0)
    got = _run_cpu_kernel(cpu_kernel, d, dt, order, fct, near_end)
    want = mpdata_plain.advect_mpdata(
        d["q"], d["u"], d["v"], d["w"], dt, 1000.0, d["jaco_u"],
        d["jaco_v"], d["jaco_w"], d["jaco"], d["dz"], order=order,
        use_fct=fct, advect_density=True, floors=d["floors"],
        near_end=near_end, rho=d["rho"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K4_RTOL,
                               atol=K4_ATOL)
    assert not np.allclose(got.numpy(), _plain(d, dt, order, fct,
                                               near_end).numpy(),
                           rtol=K4_RTOL, atol=K4_ATOL)


@pytest.mark.parametrize("shape", ["nz2", "small"])
@pytest.mark.parametrize("order,fct,near_end", [(2, True, True),
                                                (3, False, False),
                                                (4, True, False)])
def test_kernel_source_small_shapes(cpu_kernel, shape, order, fct,
                                    near_end):
    S, nz, ny, nx, zw = SHAPES[shape]
    d = _case(12, S, nz, ny, nx, zw)
    dt = np.float32(25.0)
    got = _run_cpu_kernel(cpu_kernel, d, dt, order, fct, near_end)
    want = _plain(d, dt, order, fct, near_end)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K4_RTOL,
                               atol=K4_ATOL)


@pytest.mark.parametrize("near_end", [False, True])
def test_skipping_empty_species_keeps_the_bits(cpu_kernel, cpu_kernel_no_skip,
                                              near_end):
    """Tiles and levels whose window is zero in a species take what the
    full computation gives: the same bits as a build without the skips;
    the skipped tiles hold max(0, floor) or 0."""
    S, nz, ny, nx, zw = SHAPES["tiles"]
    d = _case(13, S, nz, ny, nx, zw)
    dt = np.float32(20.0)
    on = _run_cpu_kernel(cpu_kernel, d, dt, 2, True, near_end)
    off = _run_cpu_kernel(cpu_kernel_no_skip, d, dt, 2, True, near_end)
    assert torch.equal(on.view(torch.int32), off.view(torch.int32))
    floor = float(d["floors"][2]) if near_end else 0.0
    assert torch.equal(on[2], torch.full_like(on[2], max(0.0, floor)))
    assert torch.equal(on[1, :, 8:16, 32:64],
                       torch.zeros_like(on[1, :, 8:16, 32:64]))


def test_kernel_source_refuses_what_it_cannot_take(cpu_kernel):
    """nz above the kernel's maximum, and an order below 1, return
    cudaErrorInvalidValue without touching the output."""
    so = cpu_kernel
    too_deep = so.icar_advect_mpdata_max_nz() + 1
    for nz, order in ((too_deep, 2), (4, 0)):
        assert so.icar_advect_mpdata(None, None, None, None, None, None, None,
                                     None, None, 1, nz, 8, 8, 1.0, order, 1,
                                     0, None) == 1


def div_operands(seed, n):
    """Float32 pairs over the whole range: normal magnitudes from 2^-149 to
    2^127 of either sign, subnormals, zeros of both signs, infinities and
    NaN, and pairs whose quotient over- or underflows."""
    r = np.random.default_rng(seed)
    mag = lambda: np.exp2(r.uniform(-149, 127, n)) * r.choice([-1, 1], n)
    a, b = mag().astype(np.float32), mag().astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 1e-38,
                        3e38, 1e-10, 1e-15], np.float32)
    pick = r.random(n) < 0.05
    a[pick] = r.choice(special, int(pick.sum()))
    pick = r.random(n) < 0.05
    b[pick] = r.choice(special, int(pick.sum()))
    return a, b


def same_bits(got, want):
    """Equal bits, or both NaN."""
    g, w = got.view(np.int32), want.view(np.int32)
    return (g == w) | (np.isnan(got) & np.isnan(want))


def test_kernel_division_keeps_the_bits(cpu_kernel):
    """The corrective pass's branch-free division, with its fallback, gives
    IEEE a / b bit for bit (here with an exact reciprocal estimate; on the
    card tests/test_torch_kernels.py checks it with the hardware's)."""
    a, b = div_operands(5, 200_000)
    q = np.empty_like(a)
    assert cpu_kernel.icar_mpdata_div(a.ctypes.data, b.ctypes.data,
                                      q.ctypes.data, a.size, None) == 0
    with np.errstate(all="ignore"):
        want = a / b
    assert same_bits(q, want).all()

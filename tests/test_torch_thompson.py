"""Thompson microphysics (mp=1) of the port against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX module
(icar_tpu/physics/mp_thompson.py) and the port's plain version
(icar_tpu_torch/physics/mp_thompson.py, the CPU side of kernel K5).

The oracle is the JAX jnp path evaluated operation by operation
(``jax.disable_jit``), which is what the port transcribes. The jitted jnp
path is not a per-cell oracle: XLA:CPU contracts multiplies and adds into
fused multiply-adds inside its fusions, and the scheme turns those ulps into
branch flips (a sedimentation step count, a presence threshold) that move
whole columns. Measured on the mixed-regime state (seeds 1-3, dt 30/90/150):
the JAX package's own jitted and op-by-op runs of the same call differ by
more than 1e-2 relative in up to 19% of the rain cells. The port against the
op-by-op run differs only where a transcendental function rounds otherwise
(PyTorch's against XLA's), which moves a bin or a threshold in a column or
two. The whole-interval model test (tests/test_torch_thompson_model.py)
holds the port to the jitted JAX model.

The CUDA source of K5 is also compiled for the CPU with g++ (stub CUDA
definitions, one thread per block) and held against the plain version, so
its arithmetic is checked here although the kernel itself runs only on the
card (tests/test_torch_kernels.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icar_tpu.ops import pallas_kernels as pk
from icar_tpu.physics import mp_thompson as mj
from icar_tpu.physics.thompson_tables import ThompsonParams as JParams
from icar_tpu.physics.thompson_tables import get_tables as jget_tables
from icar_tpu_torch.physics import mp_thompson as mt
from icar_tpu_torch.physics.thompson_cases import (
    FIELDS, OUTPUTS, column, compare, ice_supersaturated_state, inert_state,
    mixed_state)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES, OUT_NAMES = FIELDS, OUTPUTS


def riming_state(seed=5, nz=12, ny=5, nx=9):
    """Cold (253-268 K), supercooled cloud water with snow and graupel in
    every cell: snow and graupel rime, Hallett-Mossop splinters, rimed snow
    converts to graupel."""
    r = np.random.default_rng(seed)
    dz, _, p, exner = column(nz, ny, nx)
    t = r.uniform(253.0, 268.0, (nz, ny, nx)).astype(np.float32)
    qvs = mt.rslf(torch.tensor(p), torch.tensor(t)).numpy()
    f = lambda a: np.asarray(a, np.float32)
    return dict(th=f(t / exner), qv=f(qvs * r.uniform(0.95, 1.05, t.shape)),
                qc=f(r.uniform(2e-4, 1.5e-3, t.shape)),
                qi=f(r.uniform(0, 5e-5, t.shape)),
                qr=f(np.where(r.uniform(size=t.shape) < 0.3,
                              r.uniform(0, 2e-4, t.shape), 0.0)),
                qs=f(r.uniform(1e-4, 8e-4, t.shape)),
                qg=f(r.uniform(1e-4, 5e-4, t.shape)),
                ni=f(r.uniform(0, 1e5, t.shape)),
                nr=f(r.uniform(0, 1e4, t.shape)), exner=exner, p=p, dz=dz)


def rain_only_state(seed=9, nz=12, ny=5, nx=9):
    """Warm and cold columns with rain and cloud water but no snow and no
    graupel anywhere: JAX's whole-domain gates (_gated_take) skip the
    rain-snow and rain-graupel gathers and hand the core zeros."""
    s = mixed_state(seed, nz, ny, nx)
    z = np.zeros_like(s["qs"])
    return dict(s, qs=z, qg=z)


def run_jax(c, dt, use_pallas=False, eager=True):
    acc = jnp.zeros(c["p"].shape[1:], jnp.float32)
    args = [jnp.asarray(c[k]) for k in NAMES + ("exner", "p", "dz")]

    def call():
        return mj.mp_thompson(*args, np.float32(dt), acc, acc, acc,
                              use_pallas=use_pallas)
    if eager:
        with jax.disable_jit():
            out = call()
    else:
        out = call()
    return [np.asarray(o) for o in out]


def run_port(c, dt):
    T = {k: torch.tensor(v) for k, v in c.items()}
    acc = torch.zeros(T["p"].shape[1:])
    out = mt.mp_thompson(*(T[k] for k in NAMES), T["exner"], T["p"],
                         T["dz"], np.float32(dt), acc, acc, acc)
    return [o.numpy() for o in out]


def fractions(g, w):
    """(share of cells beyond 1e-4 relative, beyond 1e-2 relative), with
    the atol of tests/test_thompson_pallas.py (1e-6 of the field's
    largest magnitude)."""
    atol = 1e-12 + 1e-6 * float(np.abs(w).max())
    rel = np.abs(g - w) / (np.abs(w) + atol)
    return float(np.mean(rel > 1e-4)), float(np.mean(rel > 1e-2))


def assert_fractions(got, want, bound, what, bound_2d=0.025, qg=None):
    """Every field's shares beyond 1e-4 and beyond 1e-2 relative at most
    ``bound`` (``qg`` for graupel where given); the surface accumulators
    at most ``bound_2d`` (2 columns of 91 is 2.2%)."""
    for n, g, w in zip(OUT_NAMES, got, want):
        assert np.isfinite(g).all(), f"{what}: non-finite {n}"
        b = bound_2d if g.ndim == 2 else (qg if n == "qg" and qg else bound)
        ft, ff = fractions(g, w)
        assert ft <= b, f"{what} {n}: {ft:.2%} beyond 1e-4"
        assert ff <= b, f"{what} {n}: {ff:.2%} beyond 1e-2"


# ---------------------------------------------------------------------------
# (a) the tables


def test_prep_tables_match_the_jax_package():
    """The port's stacks equal the JAX package's: the bf16 ones compared as
    float32 (both round the float32 tables to nearest even)."""
    tj = mj._prep_tables(JParams())
    tp = mt._prep_tables(mt.ThompsonParams())
    for g in ("racs", "racg", "qrfz"):
        a = np.asarray(tj["_stk_" + g]).astype(np.float32)
        b = tp["_stk_" + g].float().numpy()
        np.testing.assert_array_equal(b, a, err_msg=g)
    for g in ("qcfz", "iaus", "efrw", "efsw"):
        np.testing.assert_array_equal(tp["_stk_" + g], tj["_stk_" + g],
                                      err_msg=g)
    for name in ("tmr_racg", "tpi_qcfz", "t_Efrw"):
        np.testing.assert_array_equal(tp[name], tj[name], err_msg=name)


def test_kernel_constants_follow_the_kernel_enum():
    """kernel_constants() lists its values in the order of the CUDA
    source's enum Kc, which the kernel indexes."""
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "mp_thompson.cu")).read()
    body = src[src.index("enum Kc {") + len("enum Kc {"):]
    body = body[:body.index("}")]
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "N_CONSTS"
    assert names[:-1] == ["K_" + k for k in mt.kernel_constants()]


# ---------------------------------------------------------------------------
# (b) prep fields and bins

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prep_and_index_blocks_match(seed):
    """_prep_block fields within rtol 1e-5 (observed: at most 1.4e-6, where
    a power rounds otherwise), and the bins of _index_block: at most 0.5% of
    cells may move by one bin, none by more (observed: none move)."""
    c = mixed_state(seed)
    _, cj = jget_tables(JParams())
    args = [c[k] for k in NAMES + ("exner", "p")]
    with jax.disable_jit():
        Pj = mj._prep_block(*(jnp.asarray(a) for a in args), cj, JParams())
        Ij = mj._index_block(Pj, cj)
    Pt = mt._prep_block(*(torch.tensor(a) for a in args), cj,
                        mt.ThompsonParams())
    It = mt._index_block(Pt, cj)
    for k, v in Pt.items():
        w = np.asarray(Pj[k])
        np.testing.assert_allclose(v.numpy().astype(w.dtype), w, rtol=1e-5,
                                   atol=0, err_msg=k)
    for k, v in It.items():
        d = np.abs(v.numpy().astype(np.int64) - np.asarray(Ij[k]))
        assert d.max() <= 1, k
        assert np.mean(d == 1) <= 0.005, k


# ---------------------------------------------------------------------------
# (c) the whole step against the jnp path

@pytest.mark.parametrize("seed,dt", [(1, 30.0), (2, 90.0), (3, 150.0)])
def test_mp_thompson_matches_the_jnp_path(seed, dt):
    """Mixed-regime columns (warm, cold, mixed-phase, riming); dt 150 takes
    the dt > 120 s warm-collection branch. Bounds: at most 1% of the cells
    of a field beyond 1e-4 relative and 1% beyond 1e-2, and two of the 91
    columns of a surface accumulator. Observed maxima: 0.7% / 0.2% (cloud
    ice, seed 3), rain 2.2% / 2.2% (seed 2: two columns' surface fluxes);
    graupel at seed 3, 2.3% / 2.0% (a presence flip changes a column's
    sedimentation step count), gets 2.5%. The JAX test of its own kernel
    against this path allows 2% / 0.2%, but there both sides use XLA's
    transcendentals; here the column flips come from PyTorch's against
    XLA's."""
    c = mixed_state(seed)
    want = run_jax(c, dt)
    got = run_port(c, dt)
    assert_fractions(got, want, 0.01, f"seed {seed}", qg=0.025)


def test_mp_thompson_inert_state_matches():
    """Clear air: the qv >= 1e-7 floor, sub-R1 zeroing and the theta round
    trip, to rtol 3e-7 (the JAX package's inert-tile tolerance)."""
    c = inert_state()
    want = run_jax(c, 45.0)
    got = run_port(c, 45.0)
    for n, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=3e-7, atol=1e-30, err_msg=n)
    assert float(np.abs(got[2]).max()) == 0.0
    assert float(got[1].min()) >= 1e-7


def test_mp_thompson_ice_supersaturated_state_matches():
    c = ice_supersaturated_state()
    want = run_jax(c, 45.0)
    got = run_port(c, 45.0)
    assert float(got[3].max()) > 0.0, "no ice nucleated"
    for n, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-30, err_msg=n)


def test_mp_thompson_riming_state_matches():
    """Cold cloud water with snow and graupel everywhere: the riming rates
    (snow and graupel collecting cloud water, Hallett-Mossop, rimed snow to
    graupel) have no other oracle. Bounds 0.5% (observed: no cell beyond
    1e-4)."""
    c = riming_state()
    want = run_jax(c, 60.0)
    got = run_port(c, 60.0)
    # teeth: cloud water was rimed onto snow and graupel
    assert float((got[2] < c["qc"]).mean()) > 0.5
    assert_fractions(got, want, 0.005, "riming", bound_2d=0.005)


# ---------------------------------------------------------------------------
# (d) against the TPU kernel, interpreted

def test_mp_thompson_matches_the_interpreted_tpu_kernel():
    """The Pallas kernel through its interpreter (what the TPU computes,
    inert-tile skip included), jitted: held to the bounds of the JAX
    package's jit-vs-op-by-op spread on this case (seed 1, dt 30: up to
    7.8% of cells beyond 1e-4 and 6% beyond 1e-2, measured)."""
    c = mixed_state(1)
    prev = pk.force_interpret(True)
    try:
        want = run_jax(c, 30.0, use_pallas=True, eager=False)
    finally:
        pk.force_interpret(prev)
    got = run_port(c, 30.0)
    assert_fractions(got, want, 0.1, "interpreted kernel", bound_2d=0.1)


# ---------------------------------------------------------------------------
# (e) the stack entry point, (f) the gates

def test_stack_entry_point_with_permuted_order_matches_fields():
    c = mixed_state(4, nz=8, ny=3, nx=5)
    T = {k: torch.tensor(v) for k, v in c.items()}
    acc = torch.zeros(3, 5)
    want = mt.mp_thompson(*(T[k] for k in NAMES), T["exner"], T["p"],
                          T["dz"], np.float32(60.0), acc, acc + 1.0,
                          acc + 2.0)
    order = [mt.SPECIES[i] for i in (4, 0, 8, 2, 6, 1, 3, 7, 5)]
    stack = torch.stack([T[NAMES[mt.SPECIES.index(n)]] for n in order])
    assert mt.stack_smap(order) is not None
    out, rain, snow, graupel = mt.mp_thompson_stack(
        stack, order, T["exner"], T["p"], T["dz"], np.float32(60.0), acc,
        acc + 1.0, acc + 2.0)
    for row, n in enumerate(order):
        torch.testing.assert_close(out[row], want[mt.SPECIES.index(n)],
                                   rtol=0, atol=0)
    for g, w in zip((rain, snow, graupel), want[9:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert mt.stack_smap(order[:8]) is None
    with pytest.raises(ValueError):
        mt.mp_thompson_stack(stack[:8], order[:8], T["exner"], T["p"],
                             T["dz"], 60.0, acc, acc, acc)


def test_direct_lookups_match_the_gated_gathers():
    """Rain without snow or graupel: JAX's _gated_take returns zeros for the
    rain-snow and rain-graupel groups, the port reads the real values; every
    consumer is masked by the same predicates, so the results agree."""
    c = rain_only_state()
    rr = c["qr"] > 0
    assert rr.any() and not (c["qs"] > 0).any()
    want = run_jax(c, 60.0)
    got = run_port(c, 60.0)
    # the port's looked-up racs values are not all zero here
    _, cj = jget_tables(JParams())
    P = mt._prep_block(*(torch.tensor(c[k]) for k in NAMES + ("exner", "p")),
                       cj, mt.ThompsonParams())
    G = mt._lookup(mt.device_tables(mt.ThompsonParams(), "cpu"),
                   mt._index_block(P, cj))
    assert float(G["tcs_racs1"].abs().max()) > 0.0
    assert_fractions(got, want, 0.01, "rain only", bound_2d=0.005)


def test_compare_holds_the_share_of_cells_beyond_rtol():
    """thompson_cases.compare, K5's tolerance against its plain version:
    equal inputs pass with no share; one cell of 1000 off by 1e-3 passes
    at share 1e-3 and fails at 1e-4, naming the field; a NaN fails."""
    want = [torch.full((10, 10, 10), 2.0) for _ in OUT_NAMES]
    worst, shares = compare(want, want)
    assert worst == 0.0 and set(shares.values()) == {0.0}
    got = [w.clone() for w in want]
    got[4][3, 3, 3] *= 1.001
    assert compare(got, want, share=1e-3)[1]["qr"] == 1e-3
    with pytest.raises(AssertionError, match="qr"):
        compare(got, want, share=1e-4)
    got[4][3, 3, 3] = float("nan")
    with pytest.raises(AssertionError, match="non-finite qr"):
        compare(got, want, share=1.0)


def test_aerosol_scheme_raises():
    """The aerosol-aware scheme, which raised until it was ported (its
    name kept), runs on the mixed-regime state with droplet and aerosol
    numbers: fifteen finite outputs of the fields' and accumulators'
    shapes, the nine fields off the constant-Nc step's, the droplet
    number moved (tests/test_torch_thompson_aer.py holds it to the JAX
    package)."""
    c = mixed_state(4, nz=8, ny=3, nx=5)
    T = {k: torch.tensor(v) for k, v in c.items()}
    acc = torch.zeros(3, 5)
    nc = torch.full_like(T["qc"], 1e8)
    nwfa = torch.full_like(T["qc"], 5e8)
    nifa = torch.full_like(T["qc"], 1e6)
    out = mt.mp_thompson_aer(*(T[k] for k in NAMES), nc, nwfa, nifa,
                             T["exner"], T["p"], T["dz"], 60.0, acc, acc,
                             acc)
    assert len(out) == 15
    for o, ref in zip(out, [T["qc"]] * 12 + [acc] * 3):
        assert o.shape == ref.shape and torch.isfinite(o).all()
    plain = mt.mp_thompson(*(T[k] for k in NAMES), T["exner"], T["p"],
                           T["dz"], 60.0, acc, acc, acc)
    assert any(not torch.equal(a, b) for a, b in zip(out[:9], plain[:9]))
    assert not torch.equal(out[9], nc)


# ---------------------------------------------------------------------------
# the CUDA source of K5, compiled for the CPU

_STUB_RUNTIME = """#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, threadIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
inline int atomicAdd(int* a, int v) { int old = *a; *a += v; return old; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// two SMs holding one active-pass block each: the blocks claim the
// listed tiles in turn
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// each launch is a loop over its blocks, one thread per block (the
// kernels' loops are block-stride between barriers)
#define BLOCKS_LAUNCH(blocks, kernel, ...)                          \\
  do {                                                              \\
    blockDim.x = 1; threadIdx.x = 0;                                \\
    for (unsigned b_ = 0; b_ < (unsigned)(blocks); ++b_) {          \\
      blockIdx.x = b_;                                              \\
      kernel(__VA_ARGS__);                                          \\
    }                                                               \\
  } while (0)
"""
_STUB_BF16 = """#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; std::memcpy(&f, &u, 4);
  return f;
}
"""
_REPLACE = (
    ("extern __shared__ float k5_smem[];", "static float k5_smem[1 << 16];"),
    ("mp_thompson_classify_kernel<<<(unsigned)ntiles, K5_CLASSIFY_THREADS, "
     "0,\n                                st>>>(",
     "BLOCKS_LAUNCH(ntiles, mp_thompson_classify_kernel, "),
    ("mp_thompson_active_kernel<<<grid, K5_THREADS, smem, st>>>(",
     "BLOCKS_LAUNCH(grid, mp_thompson_active_kernel, "),
)


def _build_cpu_kernel(d, defines=()):
    lib = d / f"libk5{''.join(defines)}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC", "-shared",
                    f"-I{d}", *defines, "-o", str(lib), str(d / "k5.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    so.icar_mp_thompson.argtypes = [P] * 18 + [I, L, F, P]
    so.icar_mp_thompson.restype = I
    so.icar_mp_thompson_tile_columns.argtypes = [I]
    so.icar_mp_thompson_tile_columns.restype = I
    so.icar_mp_thompson_max_nz.restype = I
    return so


@pytest.fixture(scope="module")
def cpu_builds(tmp_path_factory):
    """csrc/mp_thompson.cu built by g++ with stub CUDA definitions, each
    launch a loop over its blocks, one thread per block (no FMA
    contraction, glibc's libm): {"skip": the source as it is, "no_skip":
    built with -DTHOMPSON_NO_SKIP, which classifies every tile active}."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("k5cpu")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    (d / "cuda_bf16.h").write_text(_STUB_BF16)
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "mp_thompson.cu")).read()
    for old, new in _REPLACE:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (d / "k5.cpp").write_text(src)
    return {"skip": _build_cpu_kernel(d),
            "no_skip": _build_cpu_kernel(d, ("-DTHOMPSON_NO_SKIP",))}


@pytest.fixture(scope="module")
def cpu_kernel(cpu_builds):
    return cpu_builds["skip"]


def _run_cpu_kernel(so, stack, smap, c, dt, acc):
    """K5's C entry on the CPU build; returns (active tiles, tiles)."""
    tabs = mt.device_tables(mt.ThompsonParams(), "cpu")
    T = {k: torch.tensor(c[k]) for k in ("exner", "p", "dz")}
    sm = (ctypes.c_int * 9)(*smap)
    _, nz, ny, nx = stack.shape
    cols = so.icar_mp_thompson_tile_columns(nz)
    ntiles = -(-(ny * nx) // cols)
    counts = torch.full((2,), -1, dtype=torch.int32)
    tiles = torch.full((ntiles,), -1, dtype=torch.int32)
    err = so.icar_mp_thompson(
        stack.data_ptr(), ctypes.addressof(sm), T["exner"].data_ptr(),
        T["p"].data_ptr(), T["dz"].data_ptr(),
        *(tabs[g].data_ptr() for g in mt.BIG_STACKS + mt.SMALL_STACKS),
        tabs["consts"].data_ptr(), *(a.data_ptr() for a in acc),
        counts.data_ptr(), tiles.data_ptr(), nz, ny * nx, float(dt), None)
    assert err == 0
    n = int(counts[0])
    # every listed tile was claimed once, and each block that started (at
    # most the two the stub's card holds) ended on one failed claim
    assert int(counts[1]) == n + min(2, ntiles, n)
    assert sorted(tiles[:n].tolist()) == sorted(set(tiles[:n].tolist()))
    return n, ntiles


@pytest.mark.parametrize("seed,dt", [(1, 30.0), (2, 90.0), (3, 150.0)])
def test_kernel_source_on_the_cpu_matches_the_plain_version(cpu_kernel, seed,
                                                            dt):
    """The kernel's column code against the plain version, with a permuted
    stack: they differ only where glibc's and PyTorch's transcendentals
    round otherwise. Bounds 1.5% per field, two columns of 91 for the
    accumulators (observed at most 1.2%, graupel at seed 3)."""
    c = mixed_state(seed)
    order = (2, 0, 1, 8, 3, 4, 5, 6, 7)        # stack row of field i
    stack = torch.empty((9,) + c["p"].shape)
    for i, row in enumerate(order):
        stack[row] = torch.tensor(c[NAMES[i]])
    acc = [torch.zeros(c["p"].shape[1:]) for _ in range(3)]
    _run_cpu_kernel(cpu_kernel, stack, order, c, dt, acc)
    want = run_port(c, dt)
    got = [stack[row].numpy() for row in order]
    got += [a.numpy() for a in acc]
    assert_fractions(got, want, 0.015, "kernel source")


def interleaved_state(seed=5, nz=10, ny=8, nx=32):
    """Rows of inert columns (thompson_cases.inert_state) between rows of
    mixed-regime ones: at nx = 32 the kernel's 32-column tiles alternate
    inert and active."""
    inert = inert_state(nz, ny, nx)
    mixed = mixed_state(seed, nz, ny, nx)
    odd = (np.arange(ny) % 2 == 1)[None, :, None]
    return {k: np.where(odd, mixed[k], inert[k]).astype(np.float32)
            if k in NAMES else inert[k] for k in inert}


def trigger_edge_state(nz=6, nx=32):
    """One cell per row of 32 columns (one tile) moved to either side of a
    trigger of the activity predicate, in otherwise inert columns: a
    hydrometeor at R1 and one float32 step above it; qv at the plain
    rslf, and one to three steps either side of it (water saturation); in
    a 228 K cell, qv at 1.25 times the plain rsif and two steps either
    side (the ice nucleation trigger)."""
    steps = [("qc", 0), ("qc", 1), ("qr", 0), ("qg", 1), ("qi", 1),
             ("qs", 0)]
    steps += [("w", j) for j in (-3, -1, 0, 1, 3)]
    steps += [("i", j) for j in (-2, -1, 0, 1, 2)]
    ny = len(steps)
    s = inert_state(nz, ny, nx)
    for k in NAMES[2:]:
        s[k] = np.zeros_like(s[k])
    k, x = 2, 7
    r1 = np.float32(1e-12)
    up = lambda v, n: v if n == 0 else np.float32(
        np.nextafter(v, np.float32(np.inf if n > 0 else -np.inf))) \
        if abs(n) == 1 else up(up(v, np.sign(n)), n - np.sign(n))
    p = torch.tensor(s["p"][k, 0, x])
    for row, (what, n) in enumerate(steps):
        if what in NAMES:
            s[what][k, row, x] = up(r1, n)
            continue
        t = np.float32(228.0) if what == "i" else np.float32(
            s["th"][k, row, x] * s["exner"][k, row, x])
        s["th"][k, row, x] = t / s["exner"][k, row, x]
        t = np.float32(s["th"][k, row, x] * s["exner"][k, row, x])
        sat = (mt.rslf(p, torch.tensor(t)) if what == "w"
               else mt.rsif(p, torch.tensor(t)) * np.float32(1.25))
        s["qv"][k, row, x] = up(np.float32(sat), n)
    return s


def _stack_of(c):
    return torch.stack([torch.tensor(c[k]) for k in NAMES])


def _cpu_kernel_outputs(so, c, dt, seed=0):
    """The CPU build's fields and accumulators (random accumulators made
    from ``seed``, one of them -0.0) and its (active tiles, tiles)."""
    stack = _stack_of(c)
    r = np.random.default_rng(seed)
    acc = [torch.tensor(r.uniform(0, 5, c["p"].shape[1:]).astype(np.float32))
           for _ in range(3)]
    acc[0][0, 0] = -0.0
    counts = _run_cpu_kernel(so, stack, tuple(range(9)), c, dt, acc)
    return list(stack) + acc, counts


BIT_STATES = {
    "inert": lambda: inert_state(),
    "mixed 1": lambda: mixed_state(1),
    "mixed 2": lambda: mixed_state(2),
    "mixed 3": lambda: mixed_state(3),
    "ice supersaturated": lambda: ice_supersaturated_state(),
    "riming": lambda: riming_state(),
    "interleaved": lambda: interleaved_state(),
    "trigger edges": lambda: trigger_edge_state(),
}


@pytest.mark.parametrize("name", list(BIT_STATES))
def test_inert_tile_skip_keeps_the_bits(cpu_builds, name):
    """The kernel with its inert-tile skip against a build that classifies
    every tile active (-DTHOMPSON_NO_SKIP): every field and accumulator
    equal bit for bit (-0.0 and +0.0 told apart). The inert state skips
    every tile and the interleaved one every other; at the trigger edges
    some tiles skip and some do not."""
    c = BIT_STATES[name]()
    got, (n, ntiles) = _cpu_kernel_outputs(cpu_builds["skip"], c, 45.0)
    want, (n_all, _) = _cpu_kernel_outputs(cpu_builds["no_skip"], c, 45.0)
    assert n_all == ntiles
    for field, g, w in zip(OUT_NAMES, got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), field
    if name == "inert":
        assert n == 0
    elif name == "interleaved":
        assert n == ntiles // 2
    elif name == "trigger edges":
        assert 0 < n < ntiles
    else:
        assert n == ntiles


@pytest.mark.parametrize("ny,active", [(6, 6), (7, 6)])
def test_kernel_source_at_80_levels_on_a_ragged_tile_grid(cpu_builds, ny,
                                                          active):
    """nz = 80 takes tiles of 8 columns (the shared memory of a 32-column
    tile would not fit); rows of 7 columns, inert and mixed in turn, leave
    the last tile ragged: active at ny = 6, inert at ny = 7. Held to the
    plain version as the kernel-source test above, and to the build without
    the skip bit for bit."""
    so = cpu_builds["skip"]
    assert so.icar_mp_thompson_tile_columns(80) == 8
    c = interleaved_state(4, 80, ny, 7)
    c["dz"] = np.full_like(c["dz"], 100.0)
    got, (n, ntiles) = _cpu_kernel_outputs(so, c, 30.0)
    assert (n, ntiles) == (active, -(-ny * 7 // 8))
    want, _ = _cpu_kernel_outputs(cpu_builds["no_skip"], c, 30.0)
    for field, g, w in zip(OUT_NAMES, got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), field
    r = np.random.default_rng(0)
    acc0 = [r.uniform(0, 5, c["p"].shape[1:]).astype(np.float32)
            for _ in range(3)]
    acc0[0][0, 0] = -0.0
    T = {k: torch.tensor(v) for k, v in c.items()}
    plain = mt.mp_thompson(*(T[k] for k in NAMES), T["exner"], T["p"],
                           T["dz"], np.float32(30.0),
                           *(torch.tensor(a) for a in acc0))
    assert_fractions([g.numpy() for g in got], [w.numpy() for w in plain],
                     0.015, "kernel source, nz 80")


def test_kernel_level_limits_follow_the_sources(cpu_builds, tmp_path):
    """ops/kernels.MAX_NZ, which a model on the card is checked against
    before it is built, equals each source's limit: the MAX_NZ of
    mpdata.cu (K4) read from the text, and K2/K3's and K5's from their CPU
    builds, where the tile shrinks with depth down to one column and stops
    there."""
    import re
    from icar_tpu_torch.ops import kernels
    from tests.test_torch_mp_simple_kernel import build_cpu_kernel
    csrc = os.path.join(REPO, "icar_tpu_torch", "csrc")
    text = open(os.path.join(csrc, "mpdata.cu")).read()
    limits = re.findall(r"^(?:#define MAX_NZ|constexpr int MAX_NZ =)"
                        r"\s+(\d+)", text, re.M)
    assert len(limits) == 1
    assert kernels.MAX_NZ["advect_mpdata"] == int(limits[0])
    k2 = build_cpu_kernel(tmp_path)
    top = k2.icar_mp_simple_max_nz()
    assert kernels.MAX_NZ["mp_simple"] == kernels.MAX_NZ["mp_simple_rho"] \
        == top > 64
    assert k2.icar_mp_simple_tile_columns(20) == 32
    assert k2.icar_mp_simple_tile_columns(top) == 1
    assert k2.icar_mp_simple_tile_columns(top + 1) == 0
    so = cpu_builds["skip"]
    top = so.icar_mp_thompson_max_nz()
    assert kernels.MAX_NZ["mp_thompson"] == top
    assert so.icar_mp_thompson_tile_columns(20) == 32
    assert so.icar_mp_thompson_tile_columns(top) == 1
    assert so.icar_mp_thompson_tile_columns(top + 1) == 0
    assert kernels.MAX_NZ["advect_upwind"] is None

// Fused donor-cell (upwind) advection of a species stack: kernel K1
// (upwind_tile_kernel in upwind.cuh, whose launch is also K4's upwind
// pass).
//
// Replaces the Pallas TPU kernel icar_tpu/ops/pallas_kernels.py:167
// (_advect_kernel, launched by _advect_call). Same update as
// advect3d_upwind (advect.f90:107-178) from the metric winds u*J_u/dx,
// v*J_v/dx and w*J_w, scaled by dt in the kernel; with near_end set, each
// species is clamped to its floor.
//
// What bounds it on an H100: device-memory bytes. Per cell it reads q and
// five wind/metric operands and writes one value, a few dozen flops, far
// below the card's flop-per-byte balance. The design is one block per tile
// of 8 x 32 columns, looping over the levels and species, one thread per
// column, so every load and the store coalesce across a warp; the
// neighbour reads (x+-1, y+-1, z+-1 of q, the neighbouring faces) come from
// L1/L2, and a species that is +0 over a tile's window is only stored. The
// output is a separate buffer because neighbours are read. The TPU
// kernel's 128-lane padded frame, 16-row tiles and DMA halo windows are
// TPU constraints and are gone.
//
// Arithmetic follows the TPU kernel's order ((u*J_u/dx)*dt); the plain
// PyTorch version follows the jnp path's (u*(dt/dx)*J_u), so the two agree
// to a few float32 ulp. The library is built with -fmad=false (no FMA
// contraction) and without --use_fast_math, so divisions stay IEEE.

#include "upwind.cuh"

extern "C" int icar_advect_upwind(const float* q, float* out,
                                  const float* uj, const float* vj,
                                  const float* wj, const float* dz,
                                  const float* jaco, const float* floors,
                                  int S, int nz, int ny, int nx, float dt,
                                  int near_end, void* stream) {
  if (!fits_int_index(nz, ny, nx)) return (int)cudaErrorInvalidValue;
  const dim3 tiles = upwind_tiles(ny, nx);
  upwind_tile_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      q, out, uj, vj, wj, dz, jaco, floors, S, nz, ny, nx, dt, near_end);
  return (int)cudaGetLastError();
}

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
// below the card's flop-per-byte balance. The design (upwind.cuh) is one
// block per tile of 2 x 128 columns marching up the levels: each level's
// plane of q (with its halo) and face winds are staged in shared memory by
// asynchronous copies two levels ahead, the vertical neighbours are
// carried in registers, so each value is read from device memory once and
// a warp's loads and stores coalesce. On the card the update's arithmetic
// (two IEEE-exact divisions a cell and species), not the bytes, sets its
// pace (PERF.md). The output is a separate buffer because neighbours are
// read. The TPU kernel's 128-lane padded frame, 16-row tiles and DMA halo
// windows are TPU constraints and are gone.
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
  return (int)upwind_launch(q, out, uj, vj, wj, dz, jaco, floors, S, nz, ny,
                            nx, dt, near_end, (cudaStream_t)stream);
}

// The launch's shape for a stack of S species, into cfg: the tile's
// columns along x and y, the threads of a block, the species a block
// marches together, its dynamic shared memory in bytes and the blocks
// that fit on one multiprocessor of the current device. Returns the
// error of the occupancy query, or 0.
extern "C" int icar_advect_upwind_config(int S, int* cfg) {
  const int smem = upwind_smem_bytes(S);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, upwind_tile_kernel, UP_THREADS, smem);
  const int out[6] = {UP_TX, UP_TY, UP_THREADS, upwind_group(S), smem,
                      blocks};
  for (int n = 0; n < 6; ++n) cfg[n] = out[n];
  return (int)err;
}

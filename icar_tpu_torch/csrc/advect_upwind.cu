// Fused donor-cell (upwind) advection of a species stack: kernel K1.
//
// Replaces the Pallas TPU kernel icar_tpu/ops/pallas_kernels.py:167
// (_advect_kernel, launched by _advect_call). Same update as
// advect3d_upwind (advect.f90:107-178): x, y and z upwind fluxes from the
// metric winds u*J_u/dx, v*J_v/dx and w*J_w, scaled by dt here; divided by
// J and by dz*J; the top layer flushes q*W out of the model top; interior
// cells (1..n-2 in x and y) are updated and boundary cells pass through;
// with near_end set, each species is clamped to its floor.
//
// What bounds it on an H100: device-memory bytes. Per cell it reads q and
// five wind/metric operands and writes one value, a few dozen flops, far
// below the card's flop-per-byte balance. The design is one thread per
// cell of the natural (S, nz, ny, nx) float32 stack with x fastest, so
// every load and the store coalesce across a warp; each operand is read
// once from DRAM and the neighbour reads (x+-1, y+-1, z+-1 of q, the
// neighbouring faces) come from L1/L2. The output is a separate buffer
// because neighbours are read. The TPU kernel's 128-lane padded frame,
// 16-row tiles and DMA halo windows are TPU constraints and are gone.
//
// Arithmetic follows the TPU kernel's order ((u*J_u/dx)*dt); the plain
// PyTorch version follows the jnp path's (u*(dt/dx)*J_u), so the two agree
// to a few float32 ulp. The library is built with -fmad=false (no FMA
// contraction) and without --use_fast_math, so divisions stay IEEE.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float upwind_flux(float l, float r, float c) {
  return ((c + fabsf(c)) * l + (c - fabsf(c)) * r) * 0.5f;
}

// grid: x = tiles of the (ny*nx) plane, y = species*nz + level
__global__ void advect_upwind_kernel(
    const float* __restrict__ q, float* __restrict__ out,
    const float* __restrict__ uj,   // (nz, ny, nx-1) internal x faces
    const float* __restrict__ vj,   // (nz, ny-1, nx) internal y faces
    const float* __restrict__ wj,   // (nz, ny, nx)   top face of each layer
    const float* __restrict__ dz,   // (nz, ny, nx)
    const float* __restrict__ jaco, // (nz, ny, nx)
    const float* __restrict__ floors,  // (S,)
    int nz, int ny, int nx, float dt, int near_end) {
  const long plane = (long)ny * nx;
  const long cell = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  const int sk = blockIdx.y;            // species * nz + level
  const int s = sk / nz;
  const int k = sk - s * nz;
  const int j = (int)(cell / nx);
  const int i = (int)(cell - (long)j * nx);

  const float* qs = q + (long)s * nz * plane;   // this species
  const long c = (long)k * plane + cell;        // (k, j, i) in a 3D field
  const float qc = qs[c];
  float res = qc;

  if (j >= 1 && j <= ny - 2 && i >= 1 && i <= nx - 2) {
    // x: faces i-1 (between cells i-1, i) and i (between i, i+1)
    const long fxrow = ((long)k * ny + j) * (nx - 1);
    const float u_l = uj[fxrow + i - 1] * dt;
    const float u_r = uj[fxrow + i] * dt;
    const float xdiv = upwind_flux(qc, qs[c + 1], u_r)
                       - upwind_flux(qs[c - 1], qc, u_l);
    // y: face j-1 (below row j) and face j (above row j)
    const long fy = ((long)k * (ny - 1) + j) * nx + i;
    const float v_a = vj[fy] * dt;
    const float v_b = vj[fy - nx] * dt;
    const float ydiv = upwind_flux(qc, qs[c + nx], v_a)
                       - upwind_flux(qs[c - nx], qc, v_b);
    // z: fz[k] is the flux through the top face of layer k
    float vert;
    if (k == nz - 1) {
      const float fz_below = upwind_flux(qs[c - plane], qc,
                                         wj[c - plane] * dt);
      vert = qc * (wj[c] * dt) - fz_below;
    } else {
      const float fz_above = upwind_flux(qc, qs[c + plane], wj[c] * dt);
      if (k == 0) {
        vert = fz_above;
      } else {
        vert = fz_above - upwind_flux(qs[c - plane], qc, wj[c - plane] * dt);
      }
    }
    const float jc = jaco[c];
    const float dq = (xdiv + ydiv) / jc + vert / (dz[c] * jc);
    res = qc - dq;
  }
  if (near_end) res = fmaxf(res, floors[s]);
  out[(long)s * nz * plane + c] = res;
}

}  // namespace

extern "C" int icar_advect_upwind(const float* q, float* out,
                                  const float* uj, const float* vj,
                                  const float* wj, const float* dz,
                                  const float* jaco, const float* floors,
                                  int S, int nz, int ny, int nx, float dt,
                                  int near_end, void* stream) {
  const long plane = (long)ny * nx;
  const int threads = 256;
  dim3 grid((unsigned)((plane + threads - 1) / threads), (unsigned)(S * nz));
  advect_upwind_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      q, out, uj, vj, wj, dz, jaco, floors, nz, ny, nx, dt, near_end);
  return (int)cudaGetLastError();
}

// A probe, not a kernel of any path: the least time the card takes to
// move kernel K1's bytes, with no stencil. Each thread takes one cell:
// reads q of every species and the five wind and metric operands (uj, vj
// where the cell has that face) once, and writes each species once, out =
// q + 0 * (the operands' sum), so that no read can be left out (without
// fast math the compiler may not fold the product). Loads and stores
// coalesce across a warp. Its time is the floor that K1's time is read
// against (PERF.md), beside the bound from the card's data-sheet rate.

#include <cuda_runtime.h>

namespace {

constexpr int FLOOR_THREADS = 256;

__global__ void __launch_bounds__(FLOOR_THREADS) upwind_floor_kernel(
    const float* __restrict__ q, float* __restrict__ out,
    const float* __restrict__ uj, const float* __restrict__ vj,
    const float* __restrict__ wj, const float* __restrict__ dz,
    const float* __restrict__ jaco, int S, int nz, int ny, int nx) {
  const int n3 = nz * ny * nx;
  const int c = blockIdx.x * FLOOR_THREADS + threadIdx.x;
  if (c >= n3) return;
  const int k = c / (ny * nx), e = c - k * ny * nx;
  const int j = e / nx, i = e - j * nx;
  float m = wj[c] + dz[c] + jaco[c];
  if (i < nx - 1) m += uj[(k * ny + j) * (nx - 1) + i];
  if (j < ny - 1) m += vj[(k * (ny - 1) + j) * nx + i];
  m *= 0.0f;
  for (int s = 0; s < S; ++s) out[(long)s * n3 + c] = q[(long)s * n3 + c] + m;
}

}  // namespace

extern "C" int icar_advect_upwind_floor(const float* q, float* out,
                                        const float* uj, const float* vj,
                                        const float* wj, const float* dz,
                                        const float* jaco, int S, int nz,
                                        int ny, int nx, void* stream) {
  if ((long)nz * ny * nx > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n3 = nz * ny * nx;
  upwind_floor_kernel<<<(n3 + FLOOR_THREADS - 1) / FLOOR_THREADS,
                        FLOOR_THREADS, 0, (cudaStream_t)stream>>>(
      q, out, uj, vj, wj, dz, jaco, S, nz, ny, nx);
  return (int)cudaGetLastError();
}

// The density fold of density advection (ops/kernels.py density_winds):
// the four operands kernels K1 and K4 read -- the metric face winds uj, vj,
// wj and the jacobian -- weighted by the density as the JAX package weights
// them (icar_tpu/ops/advection.py:33-50, 83-84; ops/mpdata.py:206): each
// internal x and y face wind by the mean of the two cells beside it, each
// layer-top wind by the mean of the layers below and above it (the model
// top's by its own layer's), the jacobian by the cell's density. K1 and K4
// then run unchanged on the weighted operands.
//
// Each thread takes one cell (k, j, i) and writes its right x face (i <
// nx - 1), its upper y face (j < ny - 1), its top face and its jacobian, so
// every output is written once; loads and stores coalesce across a warp.
// The arithmetic is the plain PyTorch fold's, operation by operation,
// (rho_a + rho_b) * 0.5f times the operand (built with -fmad=false, so
// nothing is contracted): the two give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int FOLD_THREADS = 256;

__global__ void __launch_bounds__(FOLD_THREADS) density_fold_kernel(
    const float* __restrict__ rho, const float* __restrict__ uj,
    const float* __restrict__ vj, const float* __restrict__ wj,
    const float* __restrict__ jaco, float* __restrict__ uj_out,
    float* __restrict__ vj_out, float* __restrict__ wj_out,
    float* __restrict__ jaco_out, int nz, int ny, int nx) {
  const int n3 = nz * ny * nx;
  const int c = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (c >= n3) return;
  const int plane = ny * nx;
  const int k = c / plane, e = c - k * plane;
  const int j = e / nx, i = e - j * nx;
  const float r = rho[c];
  if (i < nx - 1) {
    const int f = (k * ny + j) * (nx - 1) + i;
    uj_out[f] = uj[f] * ((rho[c + 1] + r) * 0.5f);
  }
  if (j < ny - 1) {
    const int f = (k * (ny - 1) + j) * nx + i;
    vj_out[f] = vj[f] * ((rho[c + nx] + r) * 0.5f);
  }
  wj_out[c] = wj[c] * (k < nz - 1 ? (rho[c + plane] + r) * 0.5f : r);
  jaco_out[c] = jaco[c] * r;
}

}  // namespace

extern "C" int icar_density_fold(const float* rho, const float* uj,
                                 const float* vj, const float* wj,
                                 const float* jaco, float* uj_out,
                                 float* vj_out, float* wj_out,
                                 float* jaco_out, int nz, int ny, int nx,
                                 void* stream) {
  if ((long)nz * ny * nx > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n3 = nz * ny * nx;
  if (n3 == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n3 + FOLD_THREADS - 1) / FOLD_THREADS);
  density_fold_kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      rho, uj, vj, wj, jaco, uj_out, vj_out, wj_out, jaco_out, nz, ny, nx);
  return (int)cudaGetLastError();
}

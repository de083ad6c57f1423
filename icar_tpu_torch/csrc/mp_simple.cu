// SB04 "simple" microphysics, one column per thread: kernels K2 and K3.
//
// Replaces the Pallas TPU kernels icar_tpu/ops/pallas_kernels.py:679
// (_mp_padded_kernel, K2, on the padded species stack; density computed in
// the kernel) and :591 (_mp_simple_kernel, K3, on flat fields; density an
// operand); both run _mp_tile (:511). One templated kernel serves both:
// K2 (icar_mp_simple) forms the density p/(Rd*theta*exner) from the entry
// state as the diagnostics do, K3 (icar_mp_simple_rho) reads it from its
// rho operand, whatever that holds. Same scheme as physics/mp_simple.py
// (mp_simple.f90:595-646): saturation adjustment (at most 15 sweeps, each
// cell until its own vapour change is below MAXERR, non-converged cells
// revert); cloud->rain/snow, melting, rain evaporation, snow sublimation;
// then two CFL-substepped upstream fall loops (rain, snow) with evaporation
// between substeps; the surface outflow adds to the rain/snow accumulators.
//
// What bounds it on an H100: latency and registers, not bytes. It reads
// ten (K3: eleven) and writes seven values per cell, but does tens of
// sweeps of transcendental math per cell, with data-dependent loop counts
// per cell and per column. The design keeps one column per thread in
// registers and local memory (at most MAX_NZ levels), so every sweep and
// fall step runs out of registers/L1 and nothing between the entry load and
// the final store touches device memory. The scheme is column-local, so the species
// are updated in place: no thread reads another thread's column. The five
// species arrive as separate pointers, so the same kernel serves a species
// stack (views of one tensor) and separate fields.
//
// Per-cell convergence is exact against the TPU's tile-wide sweep loop:
// there every update is masked by the cell's own `active` flag, and a cell
// that stops being active never becomes active again; a cell reverts iff
// it was still active in the 15th sweep (niter >= 15 in mp_simple.py).
// Sedimentation runs ceil(max_k dt*v/dz) substeps per column; a column
// holding no precipitate (all zero) skips them, which is exact because
// every flux and every phase change is then zero. The plain version skips
// a species' fall loop only when no cell of the whole domain exceeds 1e-30
// (the TPU kernel decides per tile); the three differ only when the domain
// holds at most 1e-30 of a species yet some column holds a nonzero amount.
//
// Constants are written as (float)<double> to round like the JAX
// package's Python scalars, and every expression keeps the plain version's
// operation order. The library is built with -fmad=false (no FMA
// contraction) and without --use_fast_math, so the kernel differs from the
// plain version only where expf does: the scheme's 15-sweep revert turns
// one-ulp differences into branch flips, so rounding like the plain
// version matters more here than the few cycles contraction would save.

#include <cuda_runtime.h>

#define MAX_NZ 64

namespace {

constexpr float RD = (float)287.058;
constexpr float LH_VAPOR = (float)2.26e6;
constexpr float DLHVDT = (float)2400.0;
constexpr float HEAT_CAPACITY = (float)1006.0;
constexpr float T_BOIL = (float)373.15;
constexpr float FREEZING = (float)273.15;
constexpr float SMALL = (float)1e-30;
constexpr float MAXERR = (float)1e-4;
constexpr float TWO_MAXERR = (float)(2 * 1e-4);
constexpr float L_MELT = (float)(-3.34e5);
// lheat / HEAT_CAPACITY for melting, formed in double like the JAX code
constexpr float MELT_HEAT = (float)(-3.34e5 / 1006.0);
constexpr float RAIN_FALL_RATE = (float)10.0;
constexpr float SNOW_FALL_RATE = (float)1.5;
constexpr float SNOW_CLOUD_INIT = (float)1e-4;
constexpr float RAIN_CLOUD_INIT = (float)1e-4;
constexpr int N_SAT_ITERS = 15;

__device__ __forceinline__ float sat_mr(float t, float p) {
  const bool cold = t < FREEZING;
  const float a = cold ? (float)21.8745584 : (float)17.2693882;
  const float b = cold ? (float)7.66 : (float)35.86;
  float e_s = (float)610.78 * expf(a * (t - (float)273.16) / (t - b));
  if (p - e_s <= 0.0f) e_s = p * (float)0.99999;
  return (float)0.6219907 * e_s / (p - e_s);
}

__device__ __forceinline__ float l_evap(float t) {
  return -(LH_VAPOR + (T_BOIL - t) * DLHVDT);
}

// phase_change (mp_simple.f90:333-362): q1 -> q2 with latent heating;
// `heat` is lheat / HEAT_CAPACITY
__device__ __forceinline__ void phase_change(float& t, float& q1, float qmax,
                                             float& q2, float heat,
                                             float rate) {
  float delta = (qmax - q2) * rate;
  delta = fminf(delta, q1);
  delta = fminf(delta, (qmax - q2) * (float)0.99);
  delta = fmaxf(delta, 0.0f);
  q1 = fmaxf(q1 - delta, 0.0f);
  q2 = q2 + delta;
  t = t + delta * heat;
}

// cloud2hydrometeor (mp_simple.f90:295-315)
__device__ __forceinline__ void cloud2hydrometeor(float& qc, float& q,
                                                  float conversion,
                                                  float qcmin) {
  const float delta = qc > qcmin ? qc - qc * conversion : 0.0f;
  const float transfer = fminf(delta, qc);
  qc = fmaxf(qc - transfer, 0.0f);
  q = q + transfer;
}

// CFL-substepped upstream fall + evaporation for one species of one
// column (mp_simple.f90:507-564); returns the surface outflow
__device__ float sediment(float* q, float* qv, float* t, const float* p,
                          const float* rho, const float* dz, int nz, float dt,
                          float fall_rate, float evap_base, bool snow) {
  bool any = false;
  float cfl = 0.0f;
  for (int k = 0; k < nz; ++k) {
    any = any || (q[k] != 0.0f);
    cfl = fmaxf(cfl, dt / dz[k] * fall_rate);
  }
  if (!any) return 0.0f;
  cfl = ceilf(cfl);
  const float fall_dist = dt * fall_rate / cfl;
  const float evap_rate = evap_base / (2.0f * cfl);
  const int n = (int)cfl;
  float precip = 0.0f;
  for (int s = 0; s < n; ++s) {
    // one upstream fall step (sediment, mp_simple.f90:437-459); fluxes use
    // the values from before this step, so walk upward carrying the flux
    // through the bottom face of the current layer
    const float sed = fall_dist * q[0] * rho[0];
    float loss = 0.0f;   // flux from layer k into k-1
    for (int k = 0; k < nz; ++k) {
      const float gain = (k + 1 < nz) ? fall_dist * q[k + 1] * rho[k + 1]
                                      : 0.0f;
      float qn = q[k] + (gain - loss) / (rho[k] * dz[k]);
      if (k == 0) qn = qn + (-sed / (dz[0] * rho[0]));
      loss = gain;
      q[k] = qn;
    }
    precip = precip + sed;
    // evaporate/sublimate fallen precipitation in subsaturated layers
    for (int k = 0; k < nz; ++k) {
      const float qvsat = sat_mr(t[k], p[k]);
      if (qv[k] < qvsat && q[k] > SMALL) {
        const float le = l_evap(t[k]);
        const float heat = (snow ? le - (float)3.34e5 : le) / HEAT_CAPACITY;
        phase_change(t[k], q[k], qvsat, qv[k], heat, evap_rate);
      }
    }
  }
  return precip;
}

// kRhoOperand: read the density from rho_g (K3), else form it (K2)
template <bool kRhoOperand>
__global__ void mp_simple_kernel(float* __restrict__ th,
                                 float* __restrict__ qv_g,
                                 float* __restrict__ qc_g,
                                 float* __restrict__ qr_g,
                                 float* __restrict__ qs_g,
                                 const float* __restrict__ p_g,
                                 const float* __restrict__ exner_g,
                                 const float* __restrict__ dz_g,
                                 const float* __restrict__ rho_g,
                                 float* __restrict__ rain,
                                 float* __restrict__ snow, int nz, long ncol,
                                 float dt, float cloud2rain,
                                 float cloud2snow) {
  const long col = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;

  float t[MAX_NZ], qv[MAX_NZ], qr[MAX_NZ], qs[MAX_NZ];
  float p[MAX_NZ], rho[MAX_NZ], dz[MAX_NZ];

  for (int k = 0; k < nz; ++k) {
    const long c = (long)k * ncol + col;
    const float pk = p_g[c];
    float tk = th[c] * exner_g[c];
    // density: the operand, or p/(Rd*T) from the entry temperature, as
    // the diagnostics compute it
    rho[k] = kRhoOperand ? rho_g[c] : pk / (RD * tk);
    p[k] = pk;
    dz[k] = dz_g[c];
    float qvk = qv_g[c];
    float qck = qc_g[c];
    float qrk = qr_g[c];
    float qsk = qs_g[c];

    // latent heats from the pre-adjustment temperature (mp_simple.f90:381)
    const float le = l_evap(tk);
    const float ls = L_MELT + le;

    // --- saturation adjustment (cloud_conversion, mp_simple.f90:198-280)
    const float t0 = tk, qc0 = qck;
    const float vapor2temp = (LH_VAPOR + (T_BOIL - t0) * DLHVDT)
                             / HEAT_CAPACITY;
    float lastqv = qvk + TWO_MAXERR;
    float qvsat = 0.0f;
    bool failed = false;
    for (int it = 0; it < N_SAT_ITERS; ++it) {
      if (!(fabsf(lastqv - qvk) > MAXERR)) break;
      failed = (it == N_SAT_ITERS - 1);
      lastqv = qvk;
      const float qvs = sat_mr(tk, pk);
      qvsat = qvs;
      float dq;
      if (qvk > qvs) {
        dq = -((qvk - qvs) * 0.5f);
      } else if (qck > 0.0f) {
        const float exc_un = (qvs - qvk) * 0.5f;
        dq = exc_un >= qck ? qck : exc_un;
      } else {
        dq = 0.0f;
      }
      tk = tk - dq * vapor2temp;
      qvk = qvk + dq;
      qck = qck - dq;
    }
    if (failed) {
      tk = t0;
      qvk = sat_mr(t0, pk);
      qck = qc0;
    }
    qck = fmaxf(qck, 0.0f);

    // --- conversions (mp_conversions, mp_simple.f90:381-420)
    const bool any_species = (qck + qrk + qsk) > SMALL;
    const bool qc_big = qck > SMALL;
    const bool warm = tk > FREEZING;
    if (any_species && qc_big && warm) {
      cloud2hydrometeor(qck, qrk, cloud2rain, RAIN_CLOUD_INIT);
      if (qsk > SMALL)   // melt snow into rain
        phase_change(tk, qsk, (float)100.0, qrk, MELT_HEAT, cloud2rain);
    }
    if (any_species && qc_big && !warm)
      cloud2hydrometeor(qck, qsk, cloud2snow, SNOW_CLOUD_INIT);
    if (any_species && qvk < qvsat) {
      if (qrk > SMALL)
        phase_change(tk, qrk, qvsat, qvk, le / HEAT_CAPACITY,
                     cloud2rain / 2.0f);
      if (qsk > SMALL)
        phase_change(tk, qsk, qvsat, qvk, ls / HEAT_CAPACITY,
                     cloud2snow / 2.0f);
    }

    qc_g[c] = qck;   // sedimentation does not touch cloud water
    t[k] = tk;
    qv[k] = qvk;
    qr[k] = qrk;
    qs[k] = qsk;
  }

  // --- sedimentation; snowfall adds to both snow and total rain
  const float sed_r = sediment(qr, qv, t, p, rho, dz, nz, dt, RAIN_FALL_RATE,
                               cloud2rain, false);
  const float sed_s = sediment(qs, qv, t, p, rho, dz, nz, dt, SNOW_FALL_RATE,
                               cloud2snow, true);

  for (int k = 0; k < nz; ++k) {
    const long c = (long)k * ncol + col;
    th[c] = t[k] / exner_g[c];
    qv_g[c] = qv[k];
    qr_g[c] = qr[k];
    qs_g[c] = qs[k];
  }
  rain[col] = rain[col] + sed_r + sed_s;
  snow[col] = snow[col] + sed_s;
}

template <bool kRhoOperand>
int launch_mp_simple(float* th, float* qv, float* qc, float* qr, float* qs,
                     const float* p, const float* exner, const float* dz,
                     const float* rho, float* rain, float* snow, int nz,
                     long ncol, float dt, float cloud2rain, float cloud2snow,
                     void* stream) {
  if (nz < 1 || nz > MAX_NZ) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((ncol + threads - 1) / threads);
  mp_simple_kernel<kRhoOperand>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(
          th, qv, qc, qr, qs, p, exner, dz, rho, rain, snow, nz, ncol, dt,
          cloud2rain, cloud2snow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int icar_mp_simple_max_nz() { return MAX_NZ; }

// K2: density from the entry state
extern "C" int icar_mp_simple(float* th, float* qv, float* qc, float* qr,
                              float* qs, const float* p, const float* exner,
                              const float* dz, float* rain, float* snow,
                              int nz, long ncol, float dt, float cloud2rain,
                              float cloud2snow, void* stream) {
  return launch_mp_simple<false>(th, qv, qc, qr, qs, p, exner, dz, nullptr,
                                 rain, snow, nz, ncol, dt, cloud2rain,
                                 cloud2snow, stream);
}

// K3: density as an operand
extern "C" int icar_mp_simple_rho(float* th, float* qv, float* qc, float* qr,
                                  float* qs, const float* p,
                                  const float* exner, const float* rho,
                                  const float* dz, float* rain, float* snow,
                                  int nz, long ncol, float dt,
                                  float cloud2rain, float cloud2snow,
                                  void* stream) {
  return launch_mp_simple<true>(th, qv, qc, qr, qs, p, exner, dz, rho, rain,
                                snow, nz, ncol, dt, cloud2rain, cloud2snow,
                                stream);
}

// SB04 "simple" microphysics on tiles of columns: kernels K2 and K3.
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
// What bounds it on an H100: latency, not bytes. It reads ten (K3: eleven)
// and writes seven values per cell, but runs up to 15 sweeps of
// transcendental math per cell and, in columns that hold rain, a fall loop
// of 10-15 substeps that couples a column's levels. Only the fall loops
// couple cells; everything else is per cell. So a block owns a tile of C
// consecutive columns (C = tile_columns(nz), a power of two) with all
// their levels in shared memory, cell (k, j) at k*C + j, so that a warp
// loads and stores 32 neighbouring columns of one level:
//   A. load the tile, a thread's cells all at once, then per cell in
//      block-stride loops: saturation adjustment, conversions; cloud water
//      goes straight back to device memory (the fall loops never touch
//      it); the block votes whether any cell holds rain, and snow;
//   B. each species' fall loop, only in a tile that holds some: per
//      column its substep count, fall distance and evaporation rate; the
//      columns that hold some are listed, and each substep spreads their
//      cells over the threads twice, a barrier after each: the fall step
//      from the values before it, then evaporation, only in cells that
//      hold some (the others skip expf) and with each cell's saturation
//      mixing ratio kept until its temperature changes;
//   C. store theta = t / exner, qv, qr, qs; add the surface outflow.
// On the 500x500x20 ridge after one interval 13-14% of the tiles fall
// (none on its initial state); their fall loops cost about as much as the
// rest of the kernel (PERF.md section 6). MP_SIMPLE_NO_SKIP makes every
// tile run both loops, to hold the skip's bits in the CPU tests.
//
// Every cell gets the bits of the scheme walked column by column, level by
// level: the saturation sweeps and conversions are per cell; a fall step
// reads only the values from before the step, the surface outflow adds to
// its column in substep order, and a column takes part in a substep only
// while it is below its own count and holds a nonzero amount. Per-cell convergence is exact
// against the TPU's tile-wide sweep loop: there every update is masked by
// the cell's own `active` flag, and a cell that stops being active never
// becomes active again; a cell reverts iff it was still active in the 15th
// sweep (niter >= 15 in mp_simple.py). The plain version skips a species'
// fall loop only when no cell of the whole domain exceeds 1e-30 (the TPU
// kernel decides per tile, this one per column); they differ only when
// the domain holds at most 1e-30 of a species yet some column holds a
// nonzero amount.
//
// Constants are written as (float)<double> to round like the JAX
// package's Python scalars, and every expression keeps the plain version's
// operation order. The library is built with -fmad=false (no FMA
// contraction) and without --use_fast_math, so the kernel rounds like the
// plain version step by step (on the card the two agree bit for bit; a CPU
// build differs only where glibc's expf does from PyTorch's): the scheme's
// 15-sweep revert turns one-ulp differences into branch flips, so rounding
// like the plain version matters more here than the few cycles contraction
// would save.

#include <cuda_runtime.h>

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

#ifdef MP_SIMPLE_NO_SKIP
constexpr bool kSkip = false;
#else
constexpr bool kSkip = true;
#endif

// The block: 256 threads over a tile of up to 32 columns (PERF.md section
// 6 has the measured alternatives: 128, 320 and 640 threads, 16- and
// 64-column tiles). A tile's shared memory is 10 floats per cell (t, qv,
// qr, qs, p, rho, dz, exner, the saturation mixing ratio kept between
// fall substeps, and the fall step's new values) and per column 6 words (fall
// distance, evaporation rate, substep count, the list of falling columns,
// the two surface outflows), plus the list's two counts. Tiles narrow with
// depth so that a block stays within 48 KB; a column alone may take a
// block's whole 227 KB.
constexpr int K2_THREADS = 256;
constexpr int K2_TILE_MAX = 32;
constexpr int CELL_WORDS = 10;
constexpr int COL_WORDS = 6;
constexpr long K2_SMEM_TARGET = 48L * 1024;
constexpr long K2_SMEM_MAX = 232448;

__host__ __device__ inline long tile_smem(int cols, int nz) {
  return 4L * ((long)CELL_WORDS * cols * nz + (long)COL_WORDS * cols + 2);
}

// columns per tile at nz levels (a power of two), 0 if one column's tile
// does not fit in a block's shared memory
inline int tile_columns(int nz) {
  if (nz < 1) return 0;
  for (int cols = K2_TILE_MAX; cols > 1; cols /= 2)
    if (tile_smem(cols, nz) <= K2_SMEM_TARGET) return cols;
  return tile_smem(1, nz) <= K2_SMEM_MAX ? 1 : 0;
}

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

// The shared-memory tile: cell (k, j) of a field at [k * C + j], C =
// 1 << lg columns; per-column words at [j], except that a fall loop moves
// a falling column's fall distance, evaporation rate and substep count to
// its place f in the list falling[]; counts[0] the columns listed,
// counts[1] the most substeps of any of them.
struct Tile {
  float *t, *qv, *qr, *qs, *p, *rho, *dz, *ex, *sat, *spare;
  float *fall_dist, *evap_rate, *sed_r, *sed_s;
  int *steps, *falling, *counts;
  int lg, ntc;
};

// CFL-substepped upstream fall + evaporation of one species over the
// tile's columns (mp_simple.f90:507-564), in place in q (T.spare holds the
// fall step's new values); adds each column's surface outflow to sed[j].
__device__ void sediment_tile(const Tile& T, float* q, float* sed, int nz,
                              float dt, float fall_rate, float evap_base,
                              bool snow) {
  // per column: the substeps ceil(max_k dt*v/dz), or 0 where the column
  // holds none of the species (every flux and phase change is then zero)
  for (int j = threadIdx.x; j < T.ntc; j += blockDim.x) {
    bool any = false;
    float cfl = 0.0f;
    for (int k = 0; k < nz; ++k) {
      const int c = (k << T.lg) + j;
      any = any || (q[c] != 0.0f);
      cfl = fmaxf(cfl, dt / T.dz[c] * fall_rate);
    }
    cfl = ceilf(cfl);
    T.fall_dist[j] = dt * fall_rate / cfl;
    T.evap_rate[j] = evap_base / (2.0f * cfl);
    T.steps[j] = any ? (int)cfl : 0;
  }
  __syncthreads();
  // list the columns that fall; their words move to the f-th place of
  // each per-column array (f <= j, so in place)
  if (threadIdx.x == 0) {
    int nf = 0, n_tile = 0;
    for (int j = 0; j < T.ntc; ++j) {
      const int n = T.steps[j];
      if (n > 0) {
        T.fall_dist[nf] = T.fall_dist[j];
        T.evap_rate[nf] = T.evap_rate[j];
        T.steps[nf] = n;
        T.falling[nf++] = j;
        n_tile = max(n_tile, n);
      }
    }
    T.counts[0] = nf;
    T.counts[1] = n_tile;
  }
  __syncthreads();
  // the falling columns' cells: (k, f) at k * nf + f for the f-th listed
  // column; a thread's cells step by blockDim.x, i.e. dk levels and df
  // places
  const int nf = T.counts[0], n_tile = T.counts[1];
  if (nf == 0) return;
  const int C = 1 << T.lg;
  const int k0 = threadIdx.x / nf, f0 = threadIdx.x - k0 * nf;
  const int dk = blockDim.x / nf, df = blockDim.x - dk * nf;
  float* const nxt = T.spare;
  for (int s = 0; s < n_tile; ++s) {
    // one upstream fall step (sediment, mp_simple.f90:437-459) from the
    // values before the step into nxt
    for (int k = k0, f = f0; k < nz;) {
      if (s < T.steps[f]) {
        const int j = T.falling[f];
        const int c = (k << T.lg) + j;
        const float fd = T.fall_dist[f];
        const float rho = T.rho[c], dz = T.dz[c];
        // flux from layer k+1 into k, and from k into k-1
        const float gain = (k + 1 < nz) ? fd * q[c + C] * T.rho[c + C]
                                        : 0.0f;
        const float loss = (k > 0) ? fd * q[c] * rho : 0.0f;
        float qn = q[c] + (gain - loss) / (rho * dz);
        if (k == 0) {
          const float out = fd * q[c] * rho;
          qn = qn + (-out / (dz * rho));
          sed[j] = sed[j] + out;
        }
        nxt[c] = qn;
      }
      k += dk;
      f += df;
      if (f >= nf) {
        f -= nf;
        ++k;
      }
    }
    __syncthreads();
    // evaporate/sublimate fallen precipitation in subsaturated layers; a
    // cell's saturation mixing ratio is kept until its temperature changes
    for (int k = k0, f = f0; k < nz;) {
      if (s < T.steps[f]) {
        const int c = (k << T.lg) + T.falling[f];
        float qn = nxt[c];
        if (qn > SMALL) {
          float tk = T.t[c];
          float qvsat = T.sat[c];
          if (!(qvsat >= 0.0f)) {   // not known (sat_mr is positive)
            qvsat = sat_mr(tk, T.p[c]);
            T.sat[c] = qvsat;
          }
          float qvk = T.qv[c];
          if (qvk < qvsat) {
            const float le = l_evap(tk);
            const float heat = (snow ? le - (float)3.34e5 : le)
                               / HEAT_CAPACITY;
            phase_change(tk, qn, qvsat, qvk, heat, T.evap_rate[f]);
            T.t[c] = tk;
            T.qv[c] = qvk;
            T.sat[c] = -1.0f;
          }
        }
        q[c] = qn;
      }
      k += dk;
      f += df;
      if (f >= nf) {
        f -= nf;
        ++k;
      }
    }
    __syncthreads();
  }
}

// kRhoOperand: read the density from rho_g (K3), else form it (K2).
// fall_tiles, where not null, counts the tiles that ran each fall loop.
template <bool kRhoOperand>
__global__ void __launch_bounds__(K2_THREADS)
    mp_simple_kernel(float* __restrict__ th, float* __restrict__ qv_g,
                     float* __restrict__ qc_g, float* __restrict__ qr_g,
                     float* __restrict__ qs_g, const float* __restrict__ p_g,
                     const float* __restrict__ exner_g,
                     const float* __restrict__ dz_g,
                     const float* __restrict__ rho_g,
                     float* __restrict__ rain, float* __restrict__ snow,
                     int* __restrict__ fall_tiles, int nz, long ncol, int lg,
                     float dt, float cloud2rain, float cloud2snow) {
  extern __shared__ float k2_smem[];
  const int C = 1 << lg;
  const int n = nz << lg;
  const long col0 = (long)blockIdx.x << lg;
  const long left = ncol - col0;
  Tile T;
  T.t = k2_smem;
  T.qv = T.t + n;
  T.qr = T.qv + n;
  T.qs = T.qr + n;
  T.p = T.qs + n;
  T.rho = T.p + n;
  T.dz = T.rho + n;
  T.ex = T.dz + n;
  T.sat = T.ex + n;
  T.spare = T.sat + n;
  T.fall_dist = T.spare + n;
  T.evap_rate = T.fall_dist + C;
  T.sed_r = T.evap_rate + C;
  T.sed_s = T.sed_r + C;
  T.steps = (int*)(T.sed_s + C);
  T.falling = T.steps + C;
  T.counts = T.falling + C;
  T.lg = lg;
  T.ntc = left < C ? (int)left : C;

  for (int j = threadIdx.x; j < T.ntc; j += blockDim.x) {
    T.sed_r[j] = 0.0f;
    T.sed_s[j] = 0.0f;
  }

  // --- A: load the tile (every load of a thread's cells in flight at
  // once; cloud water waits in the spare buffer), then per cell
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int j = c & (C - 1);
    if (j >= T.ntc) continue;
    const long g = (long)(c >> lg) * ncol + col0 + j;
    const float ex = exner_g[g];
    T.ex[c] = ex;
    T.t[c] = th[g] * ex;
    T.p[c] = p_g[g];
    T.dz[c] = dz_g[g];
    if (kRhoOperand) T.rho[c] = rho_g[g];
    T.qv[c] = qv_g[g];
    T.spare[c] = qc_g[g];
    T.qr[c] = qr_g[g];
    T.qs[c] = qs_g[g];
    T.sat[c] = -1.0f;   // the saturation mixing ratio is not known yet
  }
  int has_r = 0, has_s = 0;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int j = c & (C - 1);
    if (j >= T.ntc) continue;
    const long g = (long)(c >> lg) * ncol + col0 + j;
    const float pk = T.p[c];
    float tk = T.t[c];
    // density: the operand, or p/(Rd*T) from the entry temperature, as
    // the diagnostics compute it
    if (!kRhoOperand) T.rho[c] = pk / (RD * tk);
    float qvk = T.qv[c];
    float qck = T.spare[c];
    float qrk = T.qr[c];
    float qsk = T.qs[c];

    // latent heats from the pre-adjustment temperature (mp_simple.f90:381)
    const float le = l_evap(tk);
    const float ls = L_MELT + le;

    // saturation adjustment (cloud_conversion, mp_simple.f90:198-280)
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

    // conversions (mp_conversions, mp_simple.f90:381-420)
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

    qc_g[g] = qck;   // the fall loops do not touch cloud water
    T.t[c] = tk;
    T.qv[c] = qvk;
    T.qr[c] = qrk;
    T.qs[c] = qsk;
    has_r |= qrk != 0.0f;
    has_s |= qsk != 0.0f;
  }
  // the votes are also the barrier after phase A
  const bool fall_r = __syncthreads_or(has_r) || !kSkip;
  const bool fall_s = __syncthreads_or(has_s) || !kSkip;
  if (fall_tiles != nullptr && threadIdx.x == 0) {
    if (fall_r) atomicAdd(&fall_tiles[0], 1);
    if (fall_s) atomicAdd(&fall_tiles[1], 1);
  }

  // --- B: the fall loops; snowfall adds to both snow and total rain
  if (fall_r)
    sediment_tile(T, T.qr, T.sed_r, nz, dt, RAIN_FALL_RATE, cloud2rain,
                  false);
  if (fall_s)
    sediment_tile(T, T.qs, T.sed_s, nz, dt, SNOW_FALL_RATE, cloud2snow,
                  true);

  // --- C: store (the per-column outflows were last written before the
  // fall loops' final barrier, or in no loop at all before the votes)
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int j = c & (C - 1);
    if (j >= T.ntc) continue;
    const long g = (long)(c >> lg) * ncol + col0 + j;
    th[g] = T.t[c] / T.ex[c];
    qv_g[g] = T.qv[c];
    qr_g[g] = T.qr[c];
    qs_g[g] = T.qs[c];
  }
  for (int j = threadIdx.x; j < T.ntc; j += blockDim.x) {
    const long col = col0 + j;
    rain[col] = rain[col] + T.sed_r[j] + T.sed_s[j];
    snow[col] = snow[col] + T.sed_s[j];
  }
}

template <bool kRhoOperand>
int launch_mp_simple(float* th, float* qv, float* qc, float* qr, float* qs,
                     const float* p, const float* exner, const float* dz,
                     const float* rho, float* rain, float* snow,
                     int* fall_tiles, int nz, long ncol, float dt,
                     float cloud2rain, float cloud2snow, void* stream) {
  const int cols = tile_columns(nz);
  if (cols == 0 || ncol < 1) return (int)cudaErrorInvalidValue;
  int lg = 0;
  while ((1 << lg) < cols) ++lg;
  const long smem = tile_smem(cols, nz);
  if (smem > 48L * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mp_simple_kernel<kRhoOperand>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((ncol + cols - 1) / cols);
  mp_simple_kernel<kRhoOperand>
      <<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
          th, qv, qc, qr, qs, p, exner, dz, rho, rain, snow, fall_tiles, nz,
          ncol, lg, dt, cloud2rain, cloud2snow);
  return (int)cudaGetLastError();
}

}  // namespace

// the deepest column K2/K3 take: one column's tile fills a block's shared
// memory
extern "C" int icar_mp_simple_max_nz() {
  return (int)((K2_SMEM_MAX / 4 - COL_WORDS - 2) / CELL_WORDS);
}

// columns per tile at nz levels (0: nz is too deep)
extern "C" int icar_mp_simple_tile_columns(int nz) {
  return tile_columns(nz);
}

// a block's dynamic shared memory at nz levels
extern "C" long icar_mp_simple_smem_bytes(int nz) {
  const int cols = tile_columns(nz);
  return cols == 0 ? 0 : tile_smem(cols, nz);
}

// K2: density from the entry state
extern "C" int icar_mp_simple(float* th, float* qv, float* qc, float* qr,
                              float* qs, const float* p, const float* exner,
                              const float* dz, float* rain, float* snow,
                              int nz, long ncol, float dt, float cloud2rain,
                              float cloud2snow, void* stream) {
  return launch_mp_simple<false>(th, qv, qc, qr, qs, p, exner, dz, nullptr,
                                 rain, snow, nullptr, nz, ncol, dt,
                                 cloud2rain, cloud2snow, stream);
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
                                snow, nullptr, nz, ncol, dt, cloud2rain,
                                cloud2snow, stream);
}

// K2 (rho null) or K3, counting into fall_tiles[0] / [1] (device ints the
// caller zeroes) the tiles that ran the rain / the snow fall loop; the
// tiles number ceil(ncol / icar_mp_simple_tile_columns(nz))
extern "C" int icar_mp_simple_fall_tiles(float* th, float* qv, float* qc,
                                         float* qr, float* qs, const float* p,
                                         const float* exner, const float* rho,
                                         const float* dz, float* rain,
                                         float* snow, int* fall_tiles,
                                         int nz, long ncol, float dt,
                                         float cloud2rain, float cloud2snow,
                                         void* stream) {
  if (rho == nullptr)
    return launch_mp_simple<false>(th, qv, qc, qr, qs, p, exner, dz, nullptr,
                                   rain, snow, fall_tiles, nz, ncol, dt,
                                   cloud2rain, cloud2snow, stream);
  return launch_mp_simple<true>(th, qv, qc, qr, qs, p, exner, dz, rho, rain,
                                snow, fall_tiles, nz, ncol, dt, cloud2rain,
                                cloud2snow, stream);
}

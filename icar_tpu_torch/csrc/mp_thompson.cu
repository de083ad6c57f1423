// Thompson two-moment microphysics (mp=1) on column tiles: kernel K5.
//
// Replaces the Pallas TPU kernel icar_tpu/ops/thompson_kernel.py:107
// (_core_kernel, launched by thompson_core_call :213), which runs the
// scheme's prep, small-table lookups, core and post blocks on (nz, 128)
// column tiles, with the three big table stacks gathered by XLA before
// it. Same scheme as physics/mp_thompson.py (the plain version, which
// follows the JAX package's jnp path expression by expression): prep (loads
// and clamps, thermodynamics, saturation, snow moments, size
// distributions), the lookup-table bins and values, the core (process rates,
// conservation, the TAU+1 update, condensation, rain evaporation, terminal
// velocities) and the post block (four CFL-substepped sedimentation loops,
// instant melt and freeze, final update). It updates the (9, nz, ncol)
// species stack in place -- row smap[i] holds the scheme's i-th field of
// (th, qv, qc, qi, qr, qs, qg, ni, nr) -- and adds the surface
// precipitation to the rain/snow/graupel accumulators in the JAX order:
// rain + ppt_rain + ppt_snow + ppt_graupel + ppt_ice, snow + ppt_snow +
// ppt_ice, graupel + ppt_graupel. It allocates nothing.
//
// What bounds it on an H100: by bytes, reading the 9 species and exner, p,
// dz and writing the 9 species is 84 bytes per cell, 0.42 GB at 500x500x20
// (with the accumulators 0.426 GB), 0.127 ms at 3.35 TB/s; the table entries
// a cell reads only where a predicate holds are not counted. By operations
// (the scheme's, on every cell, whatever skips them),
// chip_smoke.py counts this source's float32 operations per cell (1652,
// each transcendental call -- expf, logf, log10f, powf, sqrtf -- counted as
// one, so that bound errs low) and per sedimentation step: about 8.7 G on
// the 500x500x20 ridge's state, 0.130 ms at 67 TFLOP/s. Operations bound
// it, barely. In practice it is latency and registers: a few hundred live
// values per cell, data-dependent loops per column, and the table values
// each cell reads fall in the L2 (the bf16 stacks, 19.5 MB, fit its 50 MB).
// Most columns of a ridge state hold no cloud and are inert, so the
// design spends the scheme's work only on active tiles, and spreads
// those tiles' cells over threads instead of walking each column serially.
//
// Design. The scheme is coupled along the column three times: the
// top-down running minimum of the graupel intercept (in prep and again after
// the update), the top-down fill of the terminal velocities (where the rain
// velocity feeds snow's and graupel's), and the four sedimentation loops,
// whose step count is per column. Two launches:
// - the classify pass, one block per tile of C consecutive columns (x
//   fastest, so each level's loads coalesce), tests the TPU kernel's
//   activity predicate on every cell (thompson_kernel.py:136-150) and votes.
//   An inert tile -- no hydrometeor above R1, no water supersaturation, ice
//   supersaturation under the nucleation trigger -- is finished there: the
//   final update with every tendency zero, which is what the full scheme
//   computes on it, bit for bit (theta goes through th*exner/exner as the
//   full path forms it; the TPU's branch keeps theta). An active tile is
//   appended to a device list through an atomic counter;
// - the active pass, as many blocks as the card holds at once, each
//   claiming listed tiles in turn, keeps a tile's per-cell intermediates
//   (N_SF floats a cell) in dynamic shared memory and runs the scheme in
//   phases separated by barriers: (A) one thread per cell: a cell that fails
//   the predicate takes the core's result (every tendency zero) without
//   computing it, the others are listed with their prep graupel intercept,
//   whose running minimum follows, one thread per column; (B) prep, bins,
//   table values and core, one thread per listed cell; (C) the top-down
//   fills and the second running minimum, one thread per column, with
//   graupel's fall speed one per cell; (D) the four sedimentation loops,
//   one thread per (species, column), since each species adds only into its
//   own tendencies; the surface sums, one per column; (E) melt/freeze and
//   the final update, one per cell, re-reading the entry state (the stack
//   is written only there, so the update is in place).
// C is 32 where two tiles fit an SM's shared memory and halves with depth,
// so any nz whose one-column tile fits is taken. Every loop is
// block-stride, so the source also runs one thread per block on a CPU.
// Each cell reads its big-table values directly (bf16, widened with
// __bfloat162float) where the predicate that consumes them holds, and the
// small float32 tables directly: the values the TPU's one-hot contractions
// return. The phases reorder no arithmetic within a cell or a column.
//
// Numerics. The constants that depend on the Thompson parameters arrive as
// one float32 array built in Python (mp_thompson.kernel_constants, in the
// order of enum Kc), each grouped as the plain version groups it; plain
// literals are written (float)<double> to round as numpy does. Every
// expression keeps the plain version's operation order: x / c for a
// constant c is x times the float32 reciprocal (XLA's fold, and PyTorch's
// on the card), c / x one division, and powers of 1, 2, 3 and -1 are
// products (XLA's rewrites). The library is built with -fmad=false and
// without fast math, so no multiply-add is contracted; max/min propagate
// NaN as jnp.maximum does, and each jnp.where is a branch that computes only
// the selected side. Bins (floor of log10, truncation, rounding) can move
// by one where a transcendental differs by an ulp from PyTorch's; those are
// the expected per-cell differences.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// the table shapes (thompson_tables.py NTB_*, NBC/NBR/NBS)
#define NTB_C 37
#define NTB_I 64
#define NTB_R 37
#define NTB_S 28
#define NTB_G 28
#define NTB_G1 28
#define NTB_R1 37
#define NTB_I1 55
#define NTB_T 9
#define NBC 100
#define NBR 100
#define NBS 100
#define NTC_FZ 45

namespace {

#define F(x) ((float)(x))

// the parameter-derived constants, in the order of
// physics/mp_thompson.py kernel_constants
enum Kc {
  K_RHO_NOT, K_R273, K_ORV, K_AMI_CIG1_OIG1, K_OBMI, K_XDI_NUM, K_CIG0_OIG2,
  K_RAMI, K_LAMILO3, K_LAMIHI3, K_LAMI_LO, K_LAMI_HI, K_AMR_CRG2_ORG2,
  K_OBMR, K_MVDNUM_R, K_MVD_LO, K_CRG1_ORG3, K_RAMR, K_OAMS, K_SA0, K_SA1,
  K_SA3, K_SA4, K_SA6, K_SA7, K_SA8, K_SB0, K_SB1, K_SB3, K_SB4, K_SB6,
  K_SB7, K_SB8, K_FN0, K_SA2N0, K_SA5NN0, K_SA9N30, K_SB2N0, K_SB5NN0,
  K_SB9N30, K_FN1, K_SA2N1, K_SA5NN1, K_SA9N31, K_SB2N1, K_SB5NN1, K_SB9N31,
  K_FN2, K_SA2N2, K_SA5NN2, K_SA9N32, K_SB2N2, K_SB5NN2, K_SB9N32, K_FN3,
  K_SA2N3, K_SA5NN3, K_SA9N33, K_SB2N3, K_SB5NN3, K_SB9N33, K_AMG, K_CGG0,
  K_OGE1, K_LAMG_FAC, K_CGG1, K_CGE1, K_ORG2, K_CRE1, K_R_AMR_NTC,
  K_NTC_AMR_CCG1_OCG1, K_MVDNUM_C, K_DCG_NUM, K_D0C_E6, K_RC0, K_RI0, K_NTI0,
  K_RR0, K_RS0, K_RG0, K_NIC2, K_NII2, K_NII3, K_NIR2, K_NIR3, K_NIS2,
  K_NIG2, K_NIG3, K_R_D0R, K_R_LOGDR, K_R_D0S, K_R_LOGDS, K_R5,
  K_LAMEXPR_FAC, K_ORG1, K_CRE0, K_LAMEXPG_FAC, K_OGG1, K_RAMG, K_CGE0,
  K_R_PNRWAU, K_T1QRQC, K_NCRE8, K_M2LSUB, K_FOURPI, K_TWOPI, K_T1QSQC,
  K_XDG_NUM, K_AVG, K_CGG5, K_OGG3, K_BVG, K_T1QGQC, K_CGE8, K_R_2XM0I,
  K_NTC, K_R_XM0I, K_TNO, K_D0I, K_OIG1, K_CIG4, K_CSQRD, K_CDIFF, K_R_M15,
  K_CLO, K_CHI, K_T1QSSD, K_T2QSSD, K_CGE9, K_CGE10, K_T1QGSD, K_T2QGSD,
  K_T1QSQI, K_EFSI, K_T1QRQI, K_EFRI, K_T2QRQI, K_NCRE7, K_R3, K_IAU_BIG,
  K_IAU_NONE, K_T1QSME, K_T2QSME, K_C4218OLFUS, K_CCUBES, K_T1QGME, K_T2QGME,
  K_LFUS, K_T1QREV, K_T2QREV, K_CRE9, K_NCRE10, K_HALF_FVR, K_CRG5, K_ORG3,
  K_CRE2, K_NCRE5, K_CRG6, K_R_CRG11, K_CRE11, K_NCRE6, K_AVI, K_CIG2,
  K_OIG2, K_CIG5, K_R_CIG6, K_FVS, K_KAP0_CSG3, K_CSE3, K_CSG9, K_CSE9,
  K_KAP0_CSG0, K_CSE0, K_CSG6, K_CSE6, K_AVS, K_SIXTH, N_CONSTS
};

// module constants of thompson_tables.py that are plain literals
constexpr float R1 = F(1e-12);
constexpr float R2 = F(1e-6);
constexpr float EPS = F(1e-15);
constexpr float T_0 = F(273.15);
constexpr float HGFR = F(235.16);
constexpr float XM0I = F(1e-12);
constexpr float D0C = F(1e-6);
constexpr float D0R = F(50e-6);
constexpr float D0S = F(200e-6);
constexpr float D0G = F(250e-6);
constexpr float RR2 = F(287.04);
constexpr float CP2 = F(1004.0);
constexpr float LSUB = F(2.834e6);
constexpr float LVAP0 = F(2.5e6);
constexpr float FV_R = F(195.0);
constexpr float AV_R = F(4854.0);
constexpr float RHO_W = F(1000.0);
constexpr float ATO = F(0.304);
constexpr float GONV_MIN = F(1e4);
constexpr float GONV_MAX = F(3e6);
constexpr float LAM0 = F(20.78);
constexpr float LAM1 = F(3.29);
constexpr float KAP1 = F(17.46);
constexpr float MU_S = F(0.6357);
constexpr float AM_I = F(3.1415926536 * 890.0 / 6.0);   // PI*RHO_I/6

// jnp.maximum / jnp.minimum: NaN in, NaN out
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float sq(float x) { return x * x; }
__device__ __forceinline__ float cube(float x) { return x * (x * x); }
__device__ __forceinline__ float p10(float x) { return powf(10.0f, x); }
// x ** e for a constant e, with XLA's rewrites of 1, 2, 3 and -1
__device__ __forceinline__ float cpow(float x, float e) {
  if (e == 1.0f) return x;
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * (x * x);
  if (e == -1.0f) return 1.0f / x;
  return powf(x, e);
}
__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ float rslf(float p, float t) {
  const float x = jmax(t - F(273.16), F(-80.0));
  float e = F(-0.321582393e-13);
  e = F(0.379534310e-11) + x * e;
  e = F(0.702620698e-8) + x * e;
  e = F(0.203154182e-5) + x * e;
  e = F(0.299291081e-3) + x * e;
  e = F(0.264224321e-1) + x * e;
  e = F(0.143177157e1) + x * e;
  e = F(0.444606896e2) + x * e;
  e = F(0.611583699e3) + x * e;
  return F(0.622) * e / (p - e);
}

__device__ float rsif(float p, float t) {
  const float x = jmax(t - F(273.16), F(-80.0));
  float e = F(0.161444444e-12);
  e = F(0.105785160e-9) + x * e;
  e = F(0.307839583e-7) + x * e;
  e = F(0.521693933e-5) + x * e;
  e = F(0.565392987e-3) + x * e;
  e = F(0.402737184e-1) + x * e;
  e = F(0.184672631e1) + x * e;
  e = F(0.499320233e2) + x * e;
  e = F(0.609868993e3) + x * e;
  return F(0.622) * e / (p - e);
}

__device__ __forceinline__ float air_density(float p, float t, float qv) {
  return F(0.622) * p / (RR2 * t * (qv + F(0.622)));
}

struct Thermo {
  float rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond;
};

__device__ Thermo thermo(const float* K, float temp, float pres, float qv) {
  Thermo h;
  const float tempc = temp - F(273.15);
  h.rho = air_density(pres, temp, qv);
  h.rhof = sqrtf(K[K_RHO_NOT] / h.rho);
  h.rhof2 = sqrtf(h.rhof);
  h.diffu = F(2.11e-5) * cpow(temp * K[K_R273], F(1.94))
            * (F(101325.0) / pres);
  h.visco = tempc >= 0.0f
                ? (F(1.718) + F(0.0049) * tempc) * F(1e-5)
                : (F(1.718) + F(0.0049) * tempc - F(1.2e-5) * tempc * tempc)
                      * F(1e-5);
  h.ocp = 1.0f / (CP2 * (1.0f + F(0.887) * qv));
  h.vsc2 = sqrtf(h.rho / h.visco);
  h.lvap = LVAP0 + F(2106.0 - 4218.0) * tempc;
  h.tcond = (F(5.69) + F(0.0168) * tempc) * F(1e-5) * F(418.936);
  return h;
}

// Field et al. (2005) moment j of the kernel's four (n = 1, cse[0],
// cse[12], cse[15]) from the second moment
__device__ float field_moment(const float* K, int j, float tc, float smo2) {
  const float* f = K + K_FN0 + 7 * j;
  const float n = f[0];
  const float loga = K[K_SA1] * tc + K[K_SA0] + f[1] + K[K_SA3] * tc * n
                     + K[K_SA4] * tc * tc + f[2] + K[K_SA6] * tc * tc * n
                     + K[K_SA7] * tc * n * n + K[K_SA8] * cube(tc) + f[3];
  const float b = K[K_SB1] * tc + K[K_SB0] + f[4] + K[K_SB3] * tc * n
                  + K[K_SB4] * tc * tc + f[5] + K[K_SB6] * tc * tc * n
                  + K[K_SB7] * tc * n * n + K[K_SB8] * cube(tc) + f[6];
  return p10(loga) * powf(smo2, b);
}

struct Snow {
  float smob, smo0, smo1, smoc, smoe, smof;
};

__device__ Snow snow_moments(const float* K, float rs, float temp) {
  Snow s;
  const float tc0 = jmin(temp - F(273.15), F(-0.1));
  s.smob = rs * K[K_OAMS];
  const float smo2 = s.smob;
  const float loga0 = K[K_SA1] * tc0 + K[K_SA0] + K[K_SA4] * (tc0 * tc0)
                      + K[K_SA8] * cube(tc0);
  const float b0 = K[K_SB1] * tc0 + K[K_SB0] + K[K_SB4] * (tc0 * tc0)
                   + K[K_SB8] * cube(tc0);
  s.smo0 = p10(loga0) * powf(smo2, b0);
  s.smo1 = field_moment(K, 0, tc0, smo2);
  s.smoc = field_moment(K, 1, tc0, smo2);
  s.smoe = field_moment(K, 2, tc0, smo2);
  s.smof = field_moment(K, 3, tc0, smo2);
  return s;
}

// the graupel intercept before the column's running minimum
__device__ float graupel_n0_exp(float rg, float temp, float mvd_r,
                                bool has_rain) {
  const float xslw1 = (temp < F(270.65) && has_rain && mvd_r > F(100e-6))
                          ? F(4.01) + log10f(mvd_r)
                          : F(0.01);
  const float ygra1 = F(4.31) + log10f(jmax(rg, F(5e-5)));
  const float zans1 =
      F(3.1) + F(100.0) / (F(300.0) * xslw1 * ygra1
                               / (F(10.0) / xslw1 + 1.0f + F(0.25) * ygra1)
                           + F(30.0) + F(10.0) * ygra1);
  return clip(p10(zans1), GONV_MIN, GONV_MAX);
}

// (ilamg, N0_g) from the running-minimum intercept
__device__ void graupel_slope(const float* K, float n0min, float rg,
                              float* ilamg, float* n0g) {
  const float lam_exp = cpow(n0min * K[K_AMG] * K[K_CGG0] / rg, K[K_OGE1]);
  const float lamg = lam_exp * K[K_LAMG_FAC];
  *ilamg = 1.0f / lamg;
  *n0g = n0min / (K[K_CGG1] * lam_exp) * cpow(lamg, K[K_CGE1]);
}

__device__ __forceinline__ float rain_nr_from_mvd(const float* K, float rr,
                                                  float mvd) {
  const float lamr = K[K_MVDNUM_R] / mvd;
  return K[K_CRG1_ORG3] * rr * cube(lamr) * K[K_RAMR];
}

__device__ __forceinline__ int mantissa_idx(float r, int lo_exp, int ntb) {
  const float n = floorf(log10f(jmax(r, F(1e-30))));
  const float mant = r / p10(n);
  const int idx = (int)truncf(mant) + 9 * ((int)n - lo_exp) - 1;
  return min(max(idx, 0), ntb - 1);
}

__device__ __forceinline__ int nint(float x) { return (int)floorf(x + 0.5f); }

// one level's entry state, as the stack holds it
struct Level {
  float th, qv, qc, qi, qr, qs, qg, ni, nr, exner, p;
};

// the prep block of one level (mp_thompson.f90:1160-1494); with kFull
// false it stops once the graupel intercept before the running minimum
// (n0exp) is known
struct Prep {
  float t1d, temp, tempc, qv, pres, rho, rhof, rhof2, diffu, visco, ocp,
      vsc2, lvap, tcond, qvs, delQvs, qvsi, ssatw, ssati;
  bool L_qc, L_qi, L_qr, L_qs, L_qg;
  float qc1d, qi1d, ni1d, qr1d, nr1d, qs1d, qg1d, qv1d;
  float rc, ri, ni, rr, nr, mvd_r, rs, rg, n0exp;
  Snow sn;
  float ilamg, N0_g, ilamr, N0_r, xDc, mvd_c, Dc_g, xDs;
};

template <bool kFull>
__device__ void prep_level(const float* K, const Level& in, float n0min,
                           Prep& P) {
  P.t1d = in.th * in.exner;
  P.temp = P.t1d;
  P.qv1d = in.qv;
  P.qv = jmax(in.qv, F(1e-10));
  P.pres = in.p;
  const float rho = air_density(P.pres, P.temp, P.qv);

  P.L_qc = in.qc > R1;
  P.qc1d = P.L_qc ? in.qc : 0.0f;
  P.rc = P.L_qc ? P.qc1d * rho : R1;

  P.L_qi = in.qi > R1;
  P.qi1d = P.L_qi ? in.qi : 0.0f;
  P.ni1d = P.L_qi ? in.ni : 0.0f;
  P.ri = P.L_qi ? P.qi1d * rho : R1;
  float ni = P.L_qi ? jmax(P.ni1d * rho, R2) : R2;
  {
    const float lami = cpow(K[K_AMI_CIG1_OIG1] * ni / P.ri, K[K_OBMI]);
    const float xDi = K[K_XDI_NUM] / lami;
    if (P.L_qi && xDi < F(20e-6))
      ni = jmin(K[K_CIG0_OIG2] * P.ri * K[K_RAMI] * K[K_LAMILO3], F(250e3));
    else if (P.L_qi && xDi > F(300e-6))
      ni = K[K_CIG0_OIG2] * P.ri * K[K_RAMI] * K[K_LAMIHI3];
  }
  P.ni = ni;

  P.L_qr = in.qr > R1;
  P.qr1d = P.L_qr ? in.qr : 0.0f;
  P.nr1d = P.L_qr ? in.nr : 0.0f;
  P.rr = P.L_qr ? P.qr1d * rho : R1;
  float nr = P.L_qr ? jmax(P.nr1d * rho, R2) : R2;
  {
    const float lamr = cpow(K[K_AMR_CRG2_ORG2] * nr / P.rr, K[K_OBMR]);
    const float mvd_r = K[K_MVDNUM_R] / lamr;
    const float mvd_cl = clip(mvd_r, K[K_MVD_LO], F(2.5e-3));
    if (P.L_qr && mvd_r != mvd_cl) nr = rain_nr_from_mvd(K, P.rr, mvd_cl);
    P.mvd_r = P.L_qr ? mvd_cl : 0.0f;
  }
  P.nr = nr;

  P.L_qs = in.qs > R1;
  P.qs1d = P.L_qs ? in.qs : 0.0f;
  P.rs = P.L_qs ? P.qs1d * rho : R1;
  P.L_qg = in.qg > R1;
  P.qg1d = P.L_qg ? in.qg : 0.0f;
  P.rg = P.L_qg ? P.qg1d * rho : R1;
  P.n0exp = graupel_n0_exp(P.rg, P.temp, P.mvd_r, P.L_qr);
  if (!kFull) return;

  // thermodynamics
  P.tempc = P.temp - F(273.15);
  const Thermo h = thermo(K, P.temp, P.pres, P.qv);
  P.rho = h.rho; P.rhof = h.rhof; P.rhof2 = h.rhof2; P.diffu = h.diffu;
  P.visco = h.visco; P.ocp = h.ocp; P.vsc2 = h.vsc2; P.lvap = h.lvap;
  P.tcond = h.tcond;
  P.qvs = rslf(P.pres, P.temp);
  P.delQvs = jmax(rslf(P.pres, F(273.15)) - P.qv, 0.0f);
  P.qvsi = P.tempc <= 0.0f ? rsif(P.pres, P.temp) : P.qvs;
  const float satw = P.qv / P.qvs;
  const float sati = P.qv / P.qvsi;
  P.ssatw = fabsf(satw - 1.0f) < EPS ? 0.0f : satw - 1.0f;
  P.ssati = fabsf(sati - 1.0f) < EPS ? 0.0f : sati - 1.0f;

  // snow moments, graupel and rain size distributions
  P.sn = snow_moments(K, P.rs, P.temp);
  graupel_slope(K, n0min, P.rg, &P.ilamg, &P.N0_g);
  {
    const float lamr = cpow(K[K_AMR_CRG2_ORG2] * P.nr / P.rr, K[K_OBMR]);
    P.ilamr = 1.0f / lamr;
    P.mvd_r = K[K_MVDNUM_R] / lamr;
    P.N0_r = P.nr * K[K_ORG2] * cpow(lamr, K[K_CRE1]);
  }

  // cloud-droplet size distribution (mp_thompson.f90:1500-1511)
  P.xDc = jmax(cpow(P.rc * K[K_R_AMR_NTC], K[K_OBMR]) * F(1e6), K[K_D0C_E6]);
  const float lamc = cpow(K[K_NTC_AMR_CCG1_OCG1] / P.rc, K[K_OBMR]);
  P.mvd_c = P.L_qc ? K[K_MVDNUM_C] / lamc : D0C;
  P.Dc_g = K[K_DCG_NUM] / lamc * F(1e6);
  P.xDs = P.L_qs ? P.sn.smoc / jmax(P.sn.smob, R1) : 0.0f;
}

// the table values the core consumes
struct Tables {
  float racs[12], racg[5], qrfz[4];
  float Ef_rw, Ef_sw, tpi_qcfz, tni_qcfz, tpi_ide, tps_iaus, tni_iaus;
  int idx_i;
};

struct TabPtrs {
  const __nv_bfloat16* racs;
  const __nv_bfloat16* racg;
  const __nv_bfloat16* qrfz;
  const float* efrw;
  const float* efsw;
  const float* qcfz;
  const float* iaus;
};

// bins (mp_thompson.f90:1560-1736) and direct lookups; a big group is read
// where the predicate of its consumers holds (else 0, never consumed)
__device__ void lookup(const float* K, const Prep& P, const TabPtrs& tp,
                       Tables& T) {
  const int idx_tc = min(max(nint(-P.tempc), 1), NTC_FZ) - 1;
  const int idx_c = P.rc > K[K_RC0]
                        ? mantissa_idx(P.rc, (int)K[K_NIC2], NTB_C) : 0;
  const int idx_i = P.ri > K[K_RI0]
                        ? mantissa_idx(P.ri, (int)K[K_NII2], NTB_I) : 0;
  const int idx_i1 = P.ni > K[K_NTI0]
                         ? mantissa_idx(P.ni, (int)K[K_NII3], NTB_I1) : 0;
  const int idx_efr = min(max(
      (int)(F(NBR) * logf(P.mvd_r * K[K_R_D0R]) * K[K_R_LOGDR]), 0), NBR - 1);
  const int idx_efc = min(max((int)(P.mvd_c * F(1e6)) - 1, 0), NBC - 1);
  const int idx_efs = min(max(
      (int)(F(NBS) * logf(jmax(P.xDs, D0S) * K[K_R_D0S]) * K[K_R_LOGDS]), 0),
      NBS - 1);

  const int idx_t_raw = (int)truncf((P.tempc - F(2.5)) * K[K_R5]) - 1;
  const int idx_t = min(max(max(1, -idx_t_raw), 1), NTB_T) - 1;
  const bool has_r = P.rr > K[K_RR0];
  const int idx_r = has_r ? mantissa_idx(P.rr, (int)K[K_NIR2], NTB_R) : 0;
  const float lam_exp_r = 1.0f / P.ilamr * K[K_LAMEXPR_FAC];
  const float N0_exp_r =
      K[K_ORG1] * P.rr * K[K_RAMR] * cpow(lam_exp_r, K[K_CRE0]);
  const int idx_r1 = has_r ? mantissa_idx(N0_exp_r, (int)K[K_NIR3], NTB_R1)
                           : NTB_R1 - 1;
  const int idx_s = P.rs > K[K_RS0]
                        ? mantissa_idx(P.rs, (int)K[K_NIS2], NTB_S) : 0;
  const bool has_g = P.rg > K[K_RG0];
  const int idx_g = has_g ? mantissa_idx(P.rg, (int)K[K_NIG2], NTB_G) : 0;
  const float lam_exp_g = 1.0f / P.ilamg * K[K_LAMEXPG_FAC];
  const float N0_exp_g =
      K[K_OGG1] * P.rg * K[K_RAMG] * cpow(lam_exp_g, K[K_CGE0]);
  const int idx_g1 = has_g ? mantissa_idx(N0_exp_g, (int)K[K_NIG3], NTB_G1)
                           : NTB_G1 - 1;

  const bool rs_on = P.rr >= K[K_RR0] && P.rs >= K[K_RS0];
  const long n_racs = (long)NTB_S * NTB_T * NTB_R1 * NTB_R;
  const long l_racs = (((long)idx_s * NTB_T + idx_t) * NTB_R1 + idx_r1)
                      * NTB_R + idx_r;
  for (int j = 0; j < 12; ++j)
    T.racs[j] = rs_on ? __bfloat162float(tp.racs[j * n_racs + l_racs]) : 0.f;
  const bool rg_on = P.rr >= K[K_RR0] && P.rg >= K[K_RG0];
  const long n_racg = (long)NTB_G1 * NTB_G * NTB_R1 * NTB_R;
  const long l_racg = (((long)idx_g1 * NTB_G + idx_g) * NTB_R1 + idx_r1)
                      * NTB_R + idx_r;
  for (int j = 0; j < 5; ++j)
    T.racg[j] = rg_on ? __bfloat162float(tp.racg[j * n_racg + l_racg]) : 0.f;
  const long n_qrfz = (long)NTB_R * NTB_R1 * NTC_FZ;
  const long l_qrfz = ((long)idx_r * NTB_R1 + idx_r1) * NTC_FZ + idx_tc;
  for (int j = 0; j < 4; ++j)
    T.qrfz[j] = has_r ? __bfloat162float(tp.qrfz[j * n_qrfz + l_qrfz]) : 0.f;

  T.Ef_rw = tp.efrw[idx_efr * NBC + idx_efc];
  T.Ef_sw = tp.efsw[idx_efs * NBC + idx_efc];
  T.tpi_qcfz = tp.qcfz[idx_c * NTC_FZ + idx_tc];
  T.tni_qcfz = tp.qcfz[NTB_C * NTC_FZ + idx_c * NTC_FZ + idx_tc];
  T.tpi_ide = tp.iaus[idx_i * NTB_I1 + idx_i1];
  T.tps_iaus = tp.iaus[NTB_I * NTB_I1 + idx_i * NTB_I1 + idx_i1];
  T.tni_iaus = tp.iaus[2 * NTB_I * NTB_I1 + idx_i * NTB_I1 + idx_i1];
  T.idx_i = idx_i;
}

// what the core leaves for the column passes and the post block
struct Core {
  float rr, nr, ri, ni, rs, rg, rho, ocp, lvap, temp, rhof;
  float vtr, vtnr, vti, vtni, vts, n0exp;   // vts: vts * vts_boost
  float tten, qvten, qcten, qiten, niten, qrten, nrten, qsten, qgten;
};

// process rates, conservation, tendencies, the TAU+1 update, condensation,
// rain evaporation and terminal velocities of one level
// (mp_thompson.f90:1496-2655; physics/mp_thompson.py _core_block)
__device__ void core_level(const float* K, const Prep& P, const Tables& T,
                           float dt, float odt, Core& O) {
  const float t1d = P.t1d, pres = P.pres, qv1d = P.qv1d;
  float temp = P.temp, tempc = P.tempc, qv = P.qv, rho = P.rho;
  float rhof = P.rhof, rhof2 = P.rhof2, diffu = P.diffu, visco = P.visco;
  float ocp = P.ocp, vsc2 = P.vsc2, lvap = P.lvap, tcond = P.tcond;
  float qvs = P.qvs, ssatw = P.ssatw;
  const float qvsi = P.qvsi, ssati = P.ssati, delQvs = P.delQvs;
  bool L_qc = P.L_qc, L_qi = P.L_qi, L_qr = P.L_qr, L_qs = P.L_qs,
       L_qg = P.L_qg;
  const float qc1d = P.qc1d, qi1d = P.qi1d, ni1d = P.ni1d, qr1d = P.qr1d,
              nr1d = P.nr1d, qs1d = P.qs1d, qg1d = P.qg1d;
  float rc = P.rc, ri = P.ri, ni = P.ni, rr = P.rr, nr = P.nr;
  float mvd_r = P.mvd_r, rs = P.rs, rg = P.rg;
  Snow sn = P.sn;
  float ilamg = P.ilamg, N0_g = P.N0_g, ilamr = P.ilamr, N0_r = P.N0_r;
  const float xDc = P.xDc, mvd_c = P.mvd_c, Dc_g = P.Dc_g, xDs = P.xDs;

  // ---- warm rain
  const float Ef_rr =
      2.0f - expf(jmin(F(2300.0) * (mvd_r - F(1600.0e-6)), F(50.0)));
  const float pnr_rcr = (L_qr && mvd_r > D0R) ? Ef_rr * 4.0f * nr * rr : 0.f;
  const float xDc3 = cube(xDc), xDc2 = xDc * xDc;
  const float Dc_b = cpow(jmax(xDc3 * cube(Dc_g) - xDc2 * (xDc2 * xDc2),
                               0.0f), K[K_SIXTH]);
  const float zeta1 = jmax(F(6.25e-6) * xDc * cube(Dc_b) - F(0.4), 0.0f);
  const float zeta = F(0.027) * rc * zeta1;
  const float taud = jmax(F(0.5) * Dc_b - F(7.5), 0.0f) + R1;
  const float tau = F(3.72) / (rc * taud);
  const bool wau_on = L_qc && rc > F(0.01e-3);
  float prr_wau = wau_on ? jmin(rc * odt, zeta / tau) : 0.0f;
  const float pnr_wau = prr_wau * K[K_R_PNRWAU];

  const bool rcw_on = L_qc && L_qr && mvd_r > D0R && mvd_c > D0C;
  float prr_rcw =
      rcw_on ? jmin(rc * odt, rhof * K[K_T1QRQC] * T.Ef_rw * rc * N0_r
                                  * cpow(1.0f / ilamr + FV_R, K[K_NCRE8]))
             : 0.0f;

  // deposition/sublimation prefactor (Srivastava & Coen 1992)
  float otemp = 1.0f / temp;
  float rvs = rho * qvsi;
  const float a_s = LSUB * otemp * K[K_ORV] - 1.0f;
  float rvs_p = rvs * otemp * a_s;
  float rvs_pp = rvs * (otemp * a_s * otemp * a_s
                        + K[K_M2LSUB] * cube(otemp) * K[K_ORV]
                        + otemp * otemp);
  float gamsc = LSUB * diffu / tcond * rvs_p;
  float alphsc = jmax(F(0.5) * sq(gamsc / (1.0f + gamsc)) * rvs_pp / rvs_p
                          * rvs / rvs_p, F(1e-9));
  float xsat = fabsf(ssati) < F(1e-9) ? 0.0f : ssati;
  const float t1_subl =
      K[K_FOURPI]
      * (1.0f - alphsc * xsat + 2.0f * sq(alphsc) * sq(xsat)
         - 5.0f * cube(alphsc) * cube(xsat))
      / (1.0f + gamsc);

  // snow/graupel collecting cloud water
  const bool scw_on = L_qc && mvd_c > D0C && xDs > D0S;
  float prs_scw =
      scw_on ? rhof * K[K_T1QSQC] * T.Ef_sw * rc * sn.smoe : 0.0f;
  const float xDg = K[K_XDG_NUM] * ilamg;
  const float vtg_c = rhof * K[K_AVG] * K[K_CGG5] * K[K_OGG3]
                      * cpow(ilamg, K[K_BVG]);
  const float stoke_g = mvd_c * mvd_c * vtg_c * RHO_W
                        / (F(9.0) * visco * xDg);
  const float Ef_gw =
      stoke_g >= F(0.4)
          ? (stoke_g <= F(10.0) ? F(0.55) * log10f(F(2.51) * stoke_g)
                                : F(0.77))
          : 0.0f;
  const bool gcw_on = L_qc && mvd_c > D0C && rg >= K[K_RG0] && xDg > D0G;
  float prg_gcw = gcw_on ? rhof * K[K_T1QGQC] * Ef_gw * rc * N0_g
                               * cpow(ilamg, K[K_CGE8])
                         : 0.0f;

  // ---- rain collecting snow / graupel (tables)
  const bool rs_on = rr >= K[K_RR0] && rs >= K[K_RS0];
  const bool cold = temp < T_0;
  const bool warm = !cold;
  const float racs1 = T.racs[0], mracs1 = T.racs[2],   // [1], [7] unused
              mracs2 = T.racs[3], sacr1 = T.racs[4], sacr2 = T.racs[5],
              msacr1 = T.racs[6], nracs1 = T.racs[8], nracs2 = T.racs[9],
              nsacr1 = T.racs[10], nsacr2 = T.racs[11];
  float prr_rcs = 0.0f, prs_rcs = 0.0f, prg_rcs = 0.0f, pnr_rcs = 0.0f;
  if (rs_on) {
    if (cold) {
      prr_rcs = jmax(-rr * odt, -(mracs2 + sacr2 + mracs1 + sacr1));
      prs_rcs = jmax(-rs * odt, mracs2 + sacr2 - racs1 - msacr1);
      prg_rcs = jmin((rr + rs) * odt, mracs1 + sacr1 + racs1 + msacr1);
      pnr_rcs = jmin(nr * odt, nracs1 + nracs2 + nsacr1 + nsacr2);
    } else {
      prs_rcs = jmax(-rs * odt, -racs1 - msacr1 + mracs2 + sacr2);
      prr_rcs = -prs_rcs;
      pnr_rcs = jmin(nr * odt, nracs2 + nsacr2);
    }
  }
  const bool rg_on = rr >= K[K_RR0] && rg >= K[K_RG0];
  float prg_rcg = 0.0f, prr_rcg = 0.0f, pnr_rcg = 0.0f;
  if (rg_on) {
    if (cold) {
      const float prg_rcg_c = jmin(rr * odt, T.racg[0] + T.racg[1]);
      prg_rcg = prg_rcg_c;
      prr_rcg = -prg_rcg_c;
      pnr_rcg = jmin(nr * odt, T.racg[2] + T.racg[3]);
    } else {
      const float prr_rcg_w = jmin(rg * odt, T.racg[4]);
      prg_rcg = -prr_rcg_w;
      prr_rcg = prr_rcg_w;
    }
  }

  // ---- processes below 0C
  const float rate_max_i = (qv - qvsi) * rho * odt * F(0.999);
  const bool frz_tab = rr > K[K_RR0];
  const bool frz_h = rr > R1 && temp < HGFR;
  float prg_rfz = (cold && frz_tab) ? T.qrfz[0] * odt : 0.0f;
  float pri_rfz = cold ? (frz_tab ? T.qrfz[1] * odt
                                  : (frz_h ? rr * odt : 0.0f))
                       : 0.0f;
  const float pni_rfz = cold ? (frz_tab ? T.qrfz[2] * odt
                                        : (frz_h ? nr * odt : 0.0f))
                             : 0.0f;
  const float pnr_rfz = (cold && frz_tab)
                            ? jmin(nr * odt, T.qrfz[3] * odt)
                            : ((cold && frz_h) ? nr * odt : 0.0f);
  const bool wfz_tab = rc > K[K_RC0];
  float pri_wfz = cold ? (wfz_tab ? jmin(rc * odt, T.tpi_qcfz * odt)
                                  : ((rc > R1 && temp < HGFR) ? rc * odt
                                                              : 0.0f))
                       : 0.0f;
  const float pni_wfz =
      (cold && wfz_tab)
          ? jmin(jmin(pri_wfz * K[K_R_2XM0I], K[K_NTC] * odt),
                 T.tni_qcfz * odt)
          : 0.0f;

  // ice nucleation: Cooper (1986)
  const bool nuc_on =
      cold && (ssati >= F(0.25) || (ssatw > EPS && temp < F(261.15)));
  const float xnc = jmin(K[K_TNO] * expf(ATO * (T_0 - temp)), F(250e3));
  const float xni_c = ni + (pni_rfz + pni_wfz) * dt;
  float pni_inu = nuc_on ? jmax(xnc - xni_c, 0.0f) * odt : 0.0f;
  float pri_inu = nuc_on ? jmin(rate_max_i, XM0I * pni_inu) : 0.0f;
  pni_inu = pri_inu * K[K_R_XM0I];

  // ice deposition / sublimation
  const float lami0 = cpow(K[K_AMI_CIG1_OIG1] * ni / ri, K[K_OBMI]);
  const float ilami = 1.0f / lami0;
  const float xDi = jmax(K[K_XDI_NUM] * ilami, K[K_D0I]);
  const float xmi = AM_I * cube(xDi);
  const float oxmi = 1.0f / xmi;
  const float ide_raw = F(0.5) * t1_subl * diffu * ssati * rvs * K[K_OIG1]
                        * K[K_CIG4] * ni * ilami;
  const bool ide_on = cold && L_qi;
  const float pri_ide_neg = jmax(jmax(-ri * odt, ide_raw), rate_max_i);
  float pni_ide = (ide_on && ide_raw < 0.0f)
                      ? jmax(-ni * odt, pri_ide_neg * oxmi) : 0.0f;
  const float pri_ide_pos = jmin(ide_raw, rate_max_i);
  float prs_ide = (ide_on && ide_raw >= 0.0f)
                      ? (1.0f - T.tpi_ide) * pri_ide_pos : 0.0f;
  float pri_ide = ide_on ? (ide_raw < 0.0f ? pri_ide_neg
                                           : T.tpi_ide * pri_ide_pos)
                         : 0.0f;

  // ice -> snow autoconversion
  const bool iau_big = T.idx_i == NTB_I - 1 || xDi > K[K_IAU_BIG];
  const bool iau_none = xDi < K[K_IAU_NONE];
  float prs_iau = ide_on ? (iau_big ? ri * F(0.99) * odt
                                    : (iau_none ? 0.0f
                                                : jmin(ri * F(0.99) * odt,
                                                       T.tps_iaus * odt)))
                         : 0.0f;
  const float pni_iau =
      ide_on ? (iau_big ? ni * F(0.95) * odt
                        : (iau_none ? 0.0f
                                    : jmin(ni * F(0.95) * odt,
                                           T.tni_iaus * odt)))
             : 0.0f;

  // snow deposition / sublimation
  const float C_snow = clip(
      (tempc + F(15.0)) * K[K_CDIFF] * K[K_R_M15] + K[K_CSQRD], K[K_CLO],
      K[K_CHI]);
  const float snow_sd = K[K_T1QSSD] * sn.smo1
                        + K[K_T2QSSD] * rhof2 * vsc2 * sn.smof;
  const float sde_raw = C_snow * t1_subl * diffu * ssati * rvs * snow_sd;
  float prs_sde = 0.0f;
  if (cold && L_qs)
    prs_sde = sde_raw < 0.0f ? jmax(jmax(-rs * odt, sde_raw), rate_max_i)
                             : jmin(sde_raw, rate_max_i);
  const float ilamg9 = cpow(ilamg, K[K_CGE9]);
  const float ilamg10 = cpow(ilamg, K[K_CGE10]);
  const float gde_raw = F(0.5) * t1_subl * diffu * ssati * rvs * N0_g
                        * (K[K_T1QGSD] * ilamg9
                           + K[K_T2QGSD] * vsc2 * rhof2 * ilamg10);
  float prg_gde = 0.0f;
  if (cold && L_qg && ssati < -EPS)
    prg_gde = gde_raw < 0.0f ? jmax(jmax(-rg * odt, gde_raw), rate_max_i)
                             : jmin(gde_raw, rate_max_i);

  // snow/rain collecting cloud ice
  const bool sci_on = cold && L_qi && rs >= K[K_RS0];
  float prs_sci = sci_on ? K[K_T1QSQI] * rhof * K[K_EFSI] * ri * sn.smoe
                         : 0.0f;
  const float pni_sci = prs_sci * oxmi;
  const bool rci_on = cold && L_qi && rr >= K[K_RR0] && mvd_r > 4.0f * xDi;
  const float lamr_c = 1.0f / ilamr;
  float pri_rci = rci_on ? rhof * K[K_T1QRQI] * K[K_EFRI] * ri * N0_r
                               * cpow(lamr_c + FV_R, K[K_NCRE8])
                         : 0.0f;
  const float pnr_rci = rci_on ? rhof * K[K_T1QRQI] * K[K_EFRI] * ni * N0_r
                                     * cpow(lamr_c + FV_R, K[K_NCRE8])
                               : 0.0f;
  const float pni_rci = pri_rci * oxmi;
  float prr_rci =
      rci_on ? jmin(rr * odt, rhof * K[K_T2QRQI] * K[K_EFRI] * ni * N0_r
                                  * cpow(lamr_c + FV_R, K[K_NCRE7]))
             : 0.0f;
  const float prg_rci = pri_rci + prr_rci;

  // Hallet-Mossop rime splintering
  const float tf = (tempc >= F(-5.0) && tempc < F(-3.0))
                       ? F(0.5) * (F(-3.0) - tempc)
                       : ((tempc > F(-8.0) && tempc < F(-5.0))
                              ? (F(8.0) + tempc) * K[K_R3] : 0.0f);
  const bool ihm_on = cold && prg_gcw > EPS && tempc > F(-8.0);
  const float pni_ihm = ihm_on ? F(3.5e8) * tf * prg_gcw : 0.0f;
  float pri_ihm = XM0I * pni_ihm;
  const float denom_hm = jmax(prs_scw + prg_gcw, F(1e-30));
  float prs_ihm = prs_scw / denom_hm * pri_ihm;
  float prg_ihm = prg_gcw / denom_hm * pri_ihm;

  // rimed snow -> graupel conversion and fallspeed boost
  const bool conv_on = cold && prs_scw > 5.0f * prs_sde && prs_sde > EPS;
  const float r_frac = jmin(prs_scw / jmax(prs_sde, F(1e-30)), F(30.0));
  const float g_frac = jmin(F(0.05) + (r_frac - 5.0f) * F(0.028), F(0.75));
  const float vts_boost =
      cold ? (conv_on ? jmin(F(1.1) + (r_frac - 5.0f) * F(0.016), F(1.5))
                      : 1.0f)
           : F(1.5);
  float prg_scw = conv_on ? g_frac * prs_scw : 0.0f;
  if (conv_on) prs_scw = (1.0f - g_frac) * prs_scw;

  // ---- melting (T >= 0C)
  const float melt_heat = tempc * tcond - LVAP0 * diffu * delQvs;
  const float sml_raw = melt_heat * (K[K_T1QSME] * sn.smo1
                                     + K[K_T2QSME] * rhof2 * vsc2 * sn.smof);
  const float sml = sml_raw + K[K_C4218OLFUS] * tempc * (prr_rcs + prs_scw);
  float prr_sml = (warm && L_qs) ? jmin(rs * odt, jmax(sml, 0.0f)) : 0.0f;
  float pnr_sml =
      (warm && L_qs) ? jmin(sn.smo0 * odt, sn.smo0 / jmax(rs, R1) * prr_sml
                                               * p10(F(-0.75) * tempc))
                     : 0.0f;
  if (tempc > F(3.5) || rs < F(0.005e-3)) pnr_sml = 0.0f;
  const float sde_w = K[K_CCUBES] * t1_subl * diffu * ssati * rvs * snow_sd;
  if (warm && L_qs && ssati < 0.0f) prs_sde = jmax(-rs * odt, sde_w);
  const float gml_raw = melt_heat * N0_g
                        * (K[K_T1QGME] * ilamg9
                           + K[K_T2QGME] * rhof2 * vsc2 * ilamg10);
  float prr_gml = (warm && L_qg) ? jmin(rg * odt, jmax(gml_raw, 0.0f))
                                 : 0.0f;
  float pnr_gml = (warm && L_qg)
                      ? N0_g * K[K_CGG1] * cpow(ilamg, K[K_CGE1])
                            / jmax(rg, R1) * prr_gml * p10(F(-1.5) * tempc)
                      : 0.0f;
  if (tempc > F(7.5) || rg < F(0.005e-3)) pnr_gml = 0.0f;
  if (warm && L_qg && ssati < 0.0f) prg_gde = jmax(-rg * odt, gde_raw);

  // dt > 120 s: collected cloud water goes to rain above freezing
  if (dt > F(120.0)) {
    prr_rcw = prr_rcw + (warm ? prs_scw + prg_gcw : 0.0f);
    if (warm) {
      prs_scw = 0.0f;
      prg_gcw = 0.0f;
    }
  } else {
    prr_rcw = prr_rcw + 0.0f;
  }

  // ---- conservation scalings (mp_thompson.f90:2016-2105)
  float sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde;
  float rate_max = (qv - qvsi) * odt * F(0.999);   // no rho, as the reference
  float rat = ((sump > EPS && sump > rate_max)
               || (sump < -EPS && sump < rate_max))
                  ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  pri_inu = pri_inu * rat; pri_ide = pri_ide * rat; pni_ide = pni_ide * rat;
  prs_ide = prs_ide * rat; prs_sde = prs_sde * rat; prg_gde = prg_gde * rat;

  sump = -prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw;
  rate_max = -rc * odt;
  rat = (sump < rate_max && L_qc)
            ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  prr_wau = prr_wau * rat; pri_wfz = pri_wfz * rat; prr_rcw = prr_rcw * rat;
  prs_scw = prs_scw * rat; prg_scw = prg_scw * rat; prg_gcw = prg_gcw * rat;

  sump = pri_ide - prs_iau - prs_sci - pri_rci;
  rate_max = -ri * odt;
  rat = (sump < rate_max && L_qi)
            ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  pri_ide = pri_ide * rat; prs_iau = prs_iau * rat;
  prs_sci = prs_sci * rat; pri_rci = pri_rci * rat;

  sump = -prg_rfz - pri_rfz - prr_rci + prr_rcs + prr_rcg;
  rate_max = -rr * odt;
  rat = (sump < rate_max && L_qr)
            ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  prg_rfz = prg_rfz * rat; pri_rfz = pri_rfz * rat; prr_rci = prr_rci * rat;
  prr_rcs = prr_rcs * rat; prr_rcg = prr_rcg * rat;

  sump = prs_sde - prs_ihm - prr_sml + prs_rcs;
  rate_max = -rs * odt;
  rat = (sump < rate_max && L_qs)
            ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  prs_sde = prs_sde * rat; prs_ihm = prs_ihm * rat;
  prr_sml = prr_sml * rat; prs_rcs = prs_rcs * rat;

  sump = prg_gde - prg_ihm - prr_gml + prg_rcg;
  rate_max = -rg * odt;
  rat = (sump < rate_max && L_qg)
            ? rate_max / (sump == 0.0f ? 1.0f : sump) : 1.0f;
  prg_gde = prg_gde * rat; prg_ihm = prg_ihm * rat;
  prr_gml = prr_gml * rat; prg_rcg = prg_rcg * rat;

  pri_ihm = prs_ihm + prg_ihm;
  float ratio = jmin(fabsf(prr_rcg), fabsf(prg_rcg));
  prr_rcg = ratio * sgn(prr_rcg);
  prg_rcg = -prr_rcg;
  ratio = jmin(fabsf(prr_rcs), fabsf(prs_rcs));
  if (warm) {
    prr_rcs = ratio * sgn(prr_rcs);
    prs_rcs = -prr_rcs;
  }

  // ---- tendencies (the aerosol-only terms pri_iha, pni_iha are zero)
  const float orho = 1.0f / rho;
  const float lfus2 = LSUB - lvap;
  float qvten = (-pri_inu - 0.0f - pri_ide - prs_ide - prs_sde - prg_gde)
                * orho;
  float qcten = (-prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw)
                * orho;
  float qiten = (pri_inu + 0.0f + pri_ihm + pri_wfz + pri_rfz + pri_ide
                 - prs_iau - prs_sci - pri_rci) * orho;
  float niten = (pni_inu + 0.0f + pni_ihm + pni_wfz + pni_rfz + pni_ide
                 - pni_iau - pni_sci - pni_rci) * orho;

  // ice number/mass balance
  {
    const float xri = jmax((qi1d + qiten * dt) * rho, R1);
    const float xni = jmax((ni1d + niten * dt) * rho, R2);
    const float lami = cpow(K[K_AMI_CIG1_OIG1] * xni / xri, K[K_OBMI]);
    const float xDi_b = K[K_XDI_NUM] / lami;
    const float xni_lo =
        jmin(K[K_CIG0_OIG2] * xri * K[K_RAMI] * K[K_LAMILO3], F(250e3));
    const float xni_hi = K[K_CIG0_OIG2] * xri * K[K_RAMI] * K[K_LAMIHI3];
    if (xri > R1) {
      if (xDi_b < F(20e-6))
        niten = (xni_lo - ni1d * rho) * odt * orho;
      else if (xDi_b > F(300e-6))
        niten = (xni_hi - ni1d * rho) * odt * orho;
    } else {
      niten = -ni1d * odt;
    }
    const float xni2 = jmax((ni1d + niten * dt) * rho, 0.0f);
    if (xni2 > F(250e3)) niten = (F(250e3) - ni1d * rho) * odt * orho;
  }

  float qrten = (prr_wau + prr_rcw + prr_sml + prr_gml + prr_rcs + prr_rcg
                 - prg_rfz - pri_rfz - prr_rci) * orho;
  float nrten = (pnr_wau + pnr_sml + pnr_gml
                 - (pnr_rfz + pnr_rcr + pnr_rcg + pnr_rcs + pnr_rci)) * orho;

  // rain number/mass balance
  {
    const float xrr = jmax((qr1d + qrten * dt) * rho, R1);
    const float xnr = jmax((nr1d + nrten * dt) * rho, R2);
    const float lamr_b = cpow(K[K_AMR_CRG2_ORG2] * xnr / xrr, K[K_OBMR]);
    const float mvd_b = K[K_MVDNUM_R] / lamr_b;
    const float mvd_cl = clip(mvd_b, K[K_MVD_LO], F(2.5e-3));
    if (xrr > R1) {
      if (mvd_b != mvd_cl)
        nrten = (rain_nr_from_mvd(K, xrr, mvd_cl) - nr1d * rho) * odt * orho;
    } else {
      nrten = -nr1d * odt;
      qrten = -qr1d * odt;
    }
  }

  float qsten = (prs_iau + prs_sde + prs_sci + prs_scw + prs_rcs + prs_ide
                 - prs_ihm - prr_sml) * orho;
  float qgten = (prg_scw + prg_rfz + prg_gde + prg_rcg + prg_gcw + prg_rci
                 + prg_rcs - prg_ihm - prr_gml) * orho;
  float tten =
      cold ? (LSUB * ocp * (pri_inu + 0.0f + pri_ide + prs_ide + prs_sde
                            + prg_gde)
              + lfus2 * ocp * (pri_wfz + pri_rfz + prg_rfz + prs_scw
                               + prg_scw + prg_gcw + prg_rcs + prs_rcs
                               + prr_rci + prg_rcg)) * orho
           : (K[K_LFUS] * ocp * (-prr_sml - prr_gml - prr_rcg - prr_rcs)
              + LSUB * ocp * (prs_sde + prg_gde)) * orho;

  // ---- update to TAU+1 (mp_thompson.f90:2245-2330)
  temp = t1d + dt * tten;
  qv = jmax(qv1d + dt * qvten, F(1e-10));
  Thermo h = thermo(K, temp, pres, qv);
  rho = h.rho; rhof = h.rhof; rhof2 = h.rhof2; diffu = h.diffu;
  visco = h.visco; ocp = h.ocp; vsc2 = h.vsc2; lvap = h.lvap;
  tcond = h.tcond;
  tempc = temp - F(273.15);
  otemp = 1.0f / temp;
  qvs = rslf(pres, temp);
  ssatw = qv / qvs - 1.0f;
  if (fabsf(ssatw) < EPS) ssatw = 0.0f;
  const float lvt2 = lvap * lvap * ocp * K[K_ORV] * otemp * otemp;

  L_qc = (qc1d + qcten * dt) > R1;
  rc = L_qc ? (qc1d + qcten * dt) * rho : R1;
  L_qi = (qi1d + qiten * dt) > R1;
  ri = L_qi ? (qi1d + qiten * dt) * rho : R1;
  ni = L_qi ? jmax((ni1d + niten * dt) * rho, R2) : R2;
  L_qr = (qr1d + qrten * dt) > R1;
  rr = L_qr ? (qr1d + qrten * dt) * rho : R1;
  nr = L_qr ? jmax((nr1d + nrten * dt) * rho, R2) : R2;
  {
    const float lamr_u = cpow(K[K_AMR_CRG2_ORG2] * nr / rr, K[K_OBMR]);
    const float mvd_u = K[K_MVDNUM_R] / lamr_u;
    const float mvd_ucl = clip(mvd_u, K[K_MVD_LO], F(2.5e-3));
    if (L_qr && mvd_u != mvd_ucl) nr = rain_nr_from_mvd(K, rr, mvd_ucl);
    mvd_r = L_qr ? mvd_ucl : 0.0f;
  }
  L_qs = (qs1d + qsten * dt) > R1;
  rs = L_qs ? (qs1d + qsten * dt) * rho : R1;
  L_qg = (qg1d + qgten * dt) > R1;
  rg = L_qg ? (qg1d + qgten * dt) * rho : R1;

  sn = snow_moments(K, rs, temp);
  // the graupel intercept again: only the terminal velocity reads it, after
  // the column's running minimum (pass C)
  O.n0exp = graupel_n0_exp(rg, temp, mvd_r, L_qr);
  {
    const float lamr = cpow(K[K_AMR_CRG2_ORG2] * nr / rr, K[K_OBMR]);
    ilamr = 1.0f / lamr;
    N0_r = nr * K[K_ORG2] * cpow(lamr, K[K_CRE1]);
  }

  // ---- cloud water condensation/evaporation (Newton-Raphson)
  const bool cond_on = ssatw > EPS || (ssatw < -EPS && L_qc);
  float clap = (qv - qvs) / (1.0f + lvt2 * qvs);
  for (int it = 0; it < 3; ++it) {
    const float e = expf(lvt2 * clap);
    const float fcd = qvs * e - qv + clap;
    const float dfcd = qvs * lvt2 * e + 1.0f;
    clap = clap - fcd / dfcd;
  }
  const float xrc = rc + clap;
  const float prw_vcd =
      cond_on ? (xrc > 0.0f ? clap * odt : -rc / rho * odt) : 0.0f;
  qcten = qcten + prw_vcd;
  qvten = qvten - prw_vcd;
  tten = tten + lvap * ocp * prw_vcd;
  if (cond_on) {
    rc = jmax((qc1d + dt * qcten) * rho, R1);
    qv = jmax(qv1d + dt * qvten, F(1e-10));
    temp = t1d + dt * tten;
  }
  rho = air_density(pres, temp, qv);
  qvs = rslf(pres, temp);
  if (cond_on) ssatw = qv / qvs - 1.0f;

  // ---- rain evaporation (mp_thompson.f90:2410-2475)
  const bool rev_on = ssatw < -EPS && L_qr && !(prw_vcd > 0.0f);
  tempc = temp - F(273.15);
  otemp = 1.0f / temp;
  h = thermo(K, temp, pres, qv);
  rhof = h.rhof; rhof2 = h.rhof2; diffu = h.diffu; visco = h.visco;
  ocp = h.ocp; vsc2 = h.vsc2; lvap = h.lvap; tcond = h.tcond;
  rvs = rho * qvs;
  const float a_e = lvap * otemp * K[K_ORV] - 1.0f;
  rvs_p = rvs * otemp * a_e;
  rvs_pp = rvs * (otemp * a_e * otemp * a_e
                  + F(-2.0) * lvap * cube(otemp) * K[K_ORV]
                  + otemp * otemp);
  gamsc = lvap * diffu / tcond * rvs_p;
  alphsc = jmax(F(0.5) * sq(gamsc / (1.0f + gamsc)) * rvs_pp / rvs_p * rvs
                    / rvs_p, F(1e-9));
  xsat = jmin(ssatw, F(-1e-9));
  const float t1_evap =
      K[K_TWOPI]
      * (1.0f - alphsc * xsat + 2.0f * sq(alphsc) * sq(xsat)
         - 5.0f * cube(alphsc) * cube(xsat))
      / (1.0f + gamsc);
  const float lamr_e = 1.0f / ilamr;
  const bool tiny_r = qv / qvs < F(0.95) && rr / rho <= F(1e-8);
  float prv_rev = 0.0f, pnr_rev = 0.0f;
  if (rev_on) {
    if (tiny_r) {
      prv_rev = rr / rho * odt;
    } else {
      const float rev_big =
          t1_evap * diffu * (-ssatw) * N0_r * rvs
          * (K[K_T1QREV] * cpow(ilamr, K[K_CRE9])
             + K[K_T2QREV] * vsc2 * rhof2
                   * cpow(lamr_e + K[K_HALF_FVR], K[K_NCRE10]));
      const float rate_max_e = jmin(rr / rho * odt, (qvs - qv) * odt);
      prv_rev = jmin(rate_max_e, rev_big / rho);
    }
    pnr_rev = jmin(nr * F(0.99) / rho * odt, prv_rev * nr / jmax(rr, R1));
  }
  qrten = qrten - prv_rev;
  qvten = qvten + prv_rev;
  nrten = nrten - pnr_rev;
  tten = tten - lvap * ocp * prv_rev;
  if (rev_on) {
    rr = jmax((qr1d + dt * qrten) * rho, R1);
    qv = jmax(qv1d + dt * qvten, F(1e-10));
    nr = jmax((nr1d + dt * nrten) * rho, R2);
    temp = t1d + dt * tten;
  }
  rho = air_density(pres, temp, qv);
  rhof = sqrtf(K[K_RHO_NOT] / rho);

  // ---- terminal velocities before the column fills (pass C)
  const bool has_rr = rr > R1;
  {
    const float lamr_v = cpow(K[K_AMR_CRG2_ORG2] * nr / rr, K[K_OBMR]);
    O.vtr = has_rr ? rhof * AV_R * K[K_CRG5] * K[K_ORG3]
                         * cpow(lamr_v, K[K_CRE2])
                         * cpow(lamr_v + FV_R, K[K_NCRE5])
                   : 0.0f;
    O.vtnr = has_rr ? rhof * AV_R * K[K_CRG6] * K[K_R_CRG11]
                          * cpow(lamr_v, K[K_CRE11])
                          * cpow(lamr_v + FV_R, K[K_NCRE6])
                    : 0.0f;
  }
  const bool has_ri = ri > R1;
  {
    const float lami_v = cpow(K[K_AMI_CIG1_OIG1] * ni / ri, K[K_OBMI]);
    const float ilami_v = 1.0f / lami_v;   // ** BV_I = 1
    O.vti = has_ri ? rhof * K[K_AVI] * K[K_CIG2] * K[K_OIG2] * ilami_v
                   : 0.0f;
    O.vtni = has_ri ? rhof * K[K_AVI] * K[K_CIG5] * K[K_R_CIG6] * ilami_v
                    : 0.0f;
  }
  {
    const float xDs_v = sn.smoc / jmax(sn.smob, R1);
    const float Mrat = 1.0f / jmax(xDs_v, F(1e-12));
    const float ils1 = 1.0f / (Mrat * LAM0 + K[K_FVS]);
    const float ils2 = 1.0f / (Mrat * LAM1 + K[K_FVS]);
    const float mrat_mu = cpow(Mrat, MU_S);
    const float t1_vts = K[K_KAP0_CSG3] * cpow(ils1, K[K_CSE3]);
    const float t2_vts = KAP1 * mrat_mu * K[K_CSG9] * cpow(ils2, K[K_CSE9]);
    const float ils1b = 1.0f / (Mrat * LAM0);
    const float ils2b = 1.0f / (Mrat * LAM1);
    const float t3_vts = K[K_KAP0_CSG0] * cpow(ils1b, K[K_CSE0]);
    const float t4_vts = KAP1 * mrat_mu * K[K_CSG6] * cpow(ils2b, K[K_CSE6]);
    const float vts = rhof * K[K_AVS] * (t1_vts + t2_vts) / (t3_vts + t4_vts);
    O.vts = vts * vts_boost;
  }

  O.rr = rr; O.nr = nr; O.ri = ri; O.ni = ni; O.rs = rs; O.rg = rg;
  O.rho = rho; O.ocp = ocp; O.lvap = lvap; O.temp = temp; O.rhof = rhof;
  O.tten = tten; O.qvten = qvten; O.qcten = qcten; O.qiten = qiten;
  O.niten = niten; O.qrten = qrten; O.nrten = nrten; O.qsten = qsten;
  O.qgten = qgten;
}

// explicit flux-form sedimentation of one species of one column over its
// own step count (mp_thompson.f90:2657-2780; _sediment): updates rx (and
// nx with kNumber), accumulates the tendencies into qsed/nsed, returns the
// surface flux sum. Level k of each array is at [k * st]; odz and orho
// hold 1/dz and 1/rho.
template <bool kNumber>
__device__ float sediment(float* rx, float* nx, const float* vtm,
                          const float* vtn, const float* dz, const float* odz,
                          const float* orho, float* qsed, float* nsed, int nz,
                          int st, float dt, bool cfl_max) {
  int nstep = 1;
  for (int k = 0; k < nz; ++k) {
    qsed[k * st] = 0.0f;
    if (kNumber) nsed[k * st] = 0.0f;
    const float v = cfl_max ? jmax(vtm[k * st], vtn[k * st]) : vtm[k * st];
    const int per_k = v > F(1e-3) ? (int)truncf(dt * v / dz[k * st]) + 1 : 0;
    nstep = max(nstep, per_k);
  }
  const float onstep = 1.0f / (float)nstep;
  float sfc = 0.0f;
  for (int s = 0; s < nstep; ++s) {
    float sed_m = vtm[0] * rx[0];
    float sed_n = kNumber ? vtn[0] * nx[0] : 0.0f;
    const float sed_m0 = sed_m;
    float rx0 = 0.0f;
    for (int k = 0; k < nz; ++k) {
      const int i = k * st, up = i + st;
      const float odzq = odz[i];
      const float up_m = k + 1 < nz ? vtm[up] * rx[up] : 0.0f;
      const float div_m = up_m - sed_m;
      qsed[i] = qsed[i] + div_m * odzq * onstep * orho[i];
      rx[i] = jmax(rx[i] + div_m * odzq * dt * onstep, R1);
      if (k == 0) rx0 = rx[0];
      sed_m = up_m;
      if (kNumber) {
        const float up_n = k + 1 < nz ? vtn[up] * nx[up] : 0.0f;
        const float div_n = up_n - sed_n;
        nsed[i] = nsed[i] + div_n * odzq * onstep * orho[i];
        nx[i] = jmax(nx[i] + div_n * odzq * dt * onstep, R2);
        sed_n = up_n;
      }
    }
    sfc = sfc + (rx0 > F(1e-12 * 10.0) ? sed_m0 * dt * onstep : 0.0f);
  }
  return sfc;
}

struct Smap {
  int row[9];
};

__device__ __forceinline__ Level load_level(const float* q, Smap sm,
                                            const float* exner,
                                            const float* p, long c,
                                            long plane) {
  Level in;
  in.th = q[sm.row[0] * plane + c];
  in.qv = q[sm.row[1] * plane + c];
  in.qc = q[sm.row[2] * plane + c];
  in.qi = q[sm.row[3] * plane + c];
  in.qr = q[sm.row[4] * plane + c];
  in.qs = q[sm.row[5] * plane + c];
  in.qg = q[sm.row[6] * plane + c];
  in.ni = q[sm.row[7] * plane + c];
  in.nr = q[sm.row[8] * plane + c];
  in.exner = exner[c];
  in.p = p[c];
  return in;
}

// a level's tendencies after sedimentation
struct Tend {
  float t, qv, qc, qi, ni, qr, nr, qs, qg;
};

// instant melt / homogeneous freeze and the final update of one level, in
// place (mp_thompson.f90:2782-2870 and the driver's qv floor); re-reads
// nothing but the entry state ``in``
__device__ void final_level(const float* K, float* q, Smap sm, long c,
                            long plane, const Level& in, Tend d, float ocp,
                            float lvap, float rk, float dt, float odt) {
  const float t1d = in.th * in.exner;
  const bool L_qc = in.qc > R1, L_qi = in.qi > R1, L_qr = in.qr > R1;
  const float qc1d = L_qc ? in.qc : 0.0f;
  const float qi1d = L_qi ? in.qi : 0.0f;
  const float ni1d = L_qi ? in.ni : 0.0f;
  const float qr1d = L_qr ? in.qr : 0.0f;
  const float nr1d = L_qr ? in.nr : 0.0f;
  const float qs1d = in.qs > R1 ? in.qs : 0.0f;
  const float qg1d = in.qg > R1 ? in.qg : 0.0f;
  float tt = d.t, qct = d.qc, qit = d.qi, nit = d.ni;
  const float temp = t1d + dt * tt;

  const float xri = jmax(qi1d + qit * dt, 0.0f);
  if (temp > T_0 && xri > 0.0f) {
    qct = qct + xri * odt;
    qit = qit - xri * odt;
    nit = -ni1d * odt;
    tt = tt - K[K_LFUS] * ocp * xri * odt;
  }
  const float xrc = jmax(qc1d + qct * dt, 0.0f);
  if (temp < HGFR && xrc > 0.0f) {
    const float lfus2 = LSUB - lvap;
    qit = qit + xrc * odt;
    nit = nit + xrc * K[K_R_XM0I] * odt;
    qct = qct - xrc * odt;
    tt = tt + lfus2 * ocp * xrc * odt;
  }

  const float t_out = t1d + tt * dt;
  float qv_out = jmax(in.qv + d.qv * dt, F(1e-10));
  float qc_out = qc1d + qct * dt;
  if (qc_out <= R1) qc_out = 0.0f;
  float qi_out = qi1d + qit * dt;
  float ni_out = jmax(R2 / rk, ni1d + nit * dt);
  if (qi_out <= R1) {
    qi_out = 0.0f;
    ni_out = 0.0f;
  } else {
    float lami_f = cpow(K[K_AMI_CIG1_OIG1] * ni_out / jmax(qi_out, R1),
                        K[K_OBMI]);
    const float xDi_f = K[K_XDI_NUM] / lami_f;
    lami_f = xDi_f < F(20e-6) ? K[K_LAMI_LO]
                              : (xDi_f > F(300e-6) ? K[K_LAMI_HI] : lami_f);
    ni_out = jmin(K[K_CIG0_OIG2] * qi_out * K[K_RAMI] * cube(lami_f),
                  F(250e3) / rk);
  }
  float qr_out = qr1d + d.qr * dt;
  float nr_out = jmax(R2 / rk, nr1d + d.nr * dt);
  if (qr_out <= R1) {
    qr_out = 0.0f;
    nr_out = 0.0f;
  } else {
    const float lamr_f = cpow(K[K_AMR_CRG2_ORG2] * nr_out
                                  / jmax(qr_out, R1), K[K_OBMR]);
    const float mvd_f = clip(K[K_MVDNUM_R] / lamr_f, K[K_MVD_LO],
                             F(2.5e-3));
    nr_out = rain_nr_from_mvd(K, qr_out, mvd_f);
  }
  float qs_out = qs1d + d.qs * dt;
  if (qs_out <= R1) qs_out = 0.0f;
  float qg_out = qg1d + d.qg * dt;
  if (qg_out <= R1) qg_out = 0.0f;
  qv_out = jmax(qv_out, F(1e-7));   // the driver's qv floor

  q[sm.row[0] * plane + c] = t_out / in.exner;
  q[sm.row[1] * plane + c] = qv_out;
  q[sm.row[2] * plane + c] = qc_out;
  q[sm.row[3] * plane + c] = qi_out;
  q[sm.row[4] * plane + c] = qr_out;
  q[sm.row[5] * plane + c] = qs_out;
  q[sm.row[6] * plane + c] = qg_out;
  q[sm.row[7] * plane + c] = ni_out;
  q[sm.row[8] * plane + c] = nr_out;
}

// the TPU kernel's activity predicate (thompson_kernel.py:136-150) on one
// cell: a hydrometeor above R1, water supersaturation above EPS, or ice
// supersaturation at the nucleation trigger. Where it fails on every cell
// of a column, the scheme's rates, condensation, evaporation and fall
// speeds are all zero there (each is gated by one of these), so the column
// gets exactly final_level with zero tendencies.
__device__ __forceinline__ bool cell_active(const Level& in) {
  const float temp = in.th * in.exner;
  const float qv_c = jmax(in.qv, F(1e-10));
  const float hyd = jmax(jmax(jmax(in.qc, in.qi), jmax(in.qr, in.qs)), in.qg);
  return hyd > R1 || qv_c / rslf(in.p, temp) - 1.0f > EPS
         || qv_c / rsif(in.p, temp) >= F(1.25);
}

// what core_level leaves on a cell where cell_active fails: no process
// runs there, so every tendency is zero and each species sits at its
// floor with no fall speed; the graupel intercept is n0_inert (that of
// graupel_n0_exp without rain or graupel, whatever the temperature); rho,
// ocp, lvap and temp are those of the entry state. The fall-speed factor
// rhof is read only where graupel falls, so it is not formed.
__device__ void inert_core(const Level& in, float n0_inert, Core& O) {
  const float temp = in.th * in.exner;
  const float qv = jmax(in.qv, F(1e-10));
  O.rho = air_density(in.p, temp, qv);
  O.ocp = 1.0f / (CP2 * (1.0f + F(0.887) * qv));
  O.lvap = LVAP0 + F(2106.0 - 4218.0) * (temp - F(273.15));
  O.temp = temp;
  O.rhof = 0.0f;
  O.n0exp = n0_inert;
  O.rr = R1; O.nr = R2; O.ri = R1; O.ni = R2; O.rs = R1; O.rg = R1;
  O.vtr = 0.0f; O.vtnr = 0.0f; O.vti = 0.0f; O.vtni = 0.0f; O.vts = 0.0f;
  O.tten = 0.0f; O.qvten = 0.0f; O.qcten = 0.0f; O.qiten = 0.0f;
  O.niten = 0.0f; O.qrten = 0.0f; O.nrten = 0.0f; O.qsten = 0.0f;
  O.qgten = 0.0f;
}

// the per-cell values the active tile keeps in shared memory, one array
// of (nz, C) each
enum Sf {
  S_N0, S_RHO, S_OCP, S_LVAP, S_TEMP, S_RHOF, S_DZ,
  S_TTEN, S_QVTEN, S_QCTEN, S_QITEN, S_NITEN, S_QRTEN, S_NRTEN, S_QSTEN,
  S_QGTEN, S_RR, S_NR, S_RI, S_NI, S_RS, S_RG,
  S_VTR, S_VTNR, S_VTI, S_VTNI, S_VTS, S_VTG,
  S_QSED_R, S_NSED_R, S_QSED_I, S_NSED_I, S_QSED_S, S_QSED_G, S_ODZ,
  S_ORHO, N_SF
};

// the fields pass D reads and writes for one falling species
struct SedSpecies {
  int m, n, vm, vn, qsed, nsed, tm, tn;
  bool number, cfl_max;   // a number to fall too; steps from max(vm, vn)
};

__device__ __forceinline__ SedSpecies sed_species(int sp) {
  switch (sp) {
    case 0:   // rain
      return {S_RR, S_NR, S_VTR, S_VTNR, S_QSED_R, S_NSED_R, S_QRTEN,
              S_NRTEN, true, true};
    case 1:   // ice
      return {S_RI, S_NI, S_VTI, S_VTNI, S_QSED_I, S_NSED_I, S_QITEN,
              S_NITEN, true, false};
    case 2:   // snow
      return {S_RS, S_RS, S_VTS, S_VTS, S_QSED_S, S_QSED_S, S_QSTEN, S_QSTEN,
              false, false};
    default:  // graupel
      return {S_RG, S_RG, S_VTG, S_VTG, S_QSED_G, S_QSED_G, S_QGTEN, S_QGTEN,
              false, false};
  }
}

// The active pass's block: 320 threads, two blocks per SM. Its core is
// held by one cell's latency, so more resident threads help until the
// register cap (102 at 640 threads per SM) makes them spill; 32-column
// tiles, since narrower ones repeat the serial per-column phases more
// often (PERF.md section 6 has the measured alternatives).
constexpr int K5_THREADS = 320;
constexpr int K5_MIN_BLOCKS = 2;
constexpr int K5_TILE_MAX = 32;
// the constants and two spare words
constexpr int KC_PAD = (N_CONSTS + 2 + 3) / 4 * 4;
// a tile's shared memory: K5_MIN_BLOCKS blocks per SM where it fits (an
// SM has 228 KB, 1 KB of it reserved per block), else one
constexpr long K5_SMEM_TARGET = 228L * 1024 / K5_MIN_BLOCKS - 1024;
constexpr long K5_SMEM_MAX = 232448;

__host__ __device__ inline long active_smem(int cols, int nz) {
  return 4L * (KC_PAD + 4L * cols + (N_SF + 1L) * cols * nz);
}

// columns per tile at nz levels (a power of two), 0 if one column's tile
// does not fit in a block's shared memory
inline int tile_columns(int nz) {
  for (int cols = K5_TILE_MAX; cols > 1; cols /= 2)
    if (active_smem(cols, nz) <= K5_SMEM_TARGET) return cols;
  return active_smem(1, nz) <= K5_SMEM_MAX ? 1 : 0;
}

// Classify pass: one block per tile of C consecutive columns, one thread
// per cell (x fastest), each thread loading K5_BATCH cells before it
// computes on them. The block votes; an active tile is appended to the
// list, an inert tile is finished here.
constexpr int K5_CLASSIFY_THREADS = 128;
constexpr int K5_BATCH = 2;

__global__ void __launch_bounds__(K5_CLASSIFY_THREADS)
mp_thompson_classify_kernel(float* __restrict__ q, Smap sm,
                            const float* __restrict__ exner_g,
                            const float* __restrict__ p_g,
                            const float* __restrict__ kc,
                            float* __restrict__ rain,
                            float* __restrict__ snow,
                            float* __restrict__ graupel, int nz, long ncol,
                            int cols, float dt, int* __restrict__ counts,
                            int* __restrict__ tiles) {
  const long plane = (long)nz * ncol;
  const long col0 = (long)blockIdx.x * cols;
  const int cn = (int)min((long)cols, ncol - col0);
  const int cells = cols * nz;
  const int step = K5_BATCH * blockDim.x;
  // the stack index of the batch's u-th cell from i0, -1 past the tile
  auto cell = [&](int i0, int u) -> long {
    const int i = i0 + u * blockDim.x;
    const int k = i / cols, c = i - k * cols;
    return i < cells && c < cn ? (long)k * ncol + col0 + c : -1;
  };
  int act = 0;
#ifdef THOMPSON_NO_SKIP
  act = 1;
#else
  for (int i0 = threadIdx.x; i0 < cells; i0 += step) {
    Level in[K5_BATCH] = {};
    bool ok[K5_BATCH];
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u) {
      const long g = cell(i0, u);
      ok[u] = g >= 0;
      if (ok[u]) in[u] = load_level(q, sm, exner_g, p_g, g, plane);
    }
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u)
      if (ok[u] && cell_active(in[u])) act = 1;
  }
#endif
  if (__syncthreads_or(act)) {
    if (threadIdx.x == 0) tiles[atomicAdd(counts, 1)] = (int)blockIdx.x;
    return;
  }
  const float odt = 1.0f / dt;
  const Tend zero{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i0 = threadIdx.x; i0 < cells; i0 += step) {
    Level in[K5_BATCH] = {};
    long g[K5_BATCH];
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u) {
      g[u] = cell(i0, u);
      if (g[u] >= 0) in[u] = load_level(q, sm, exner_g, p_g, g[u], plane);
    }
    // the melt/freeze branches and the number diagnostics that read ocp,
    // lvap and rho are not taken on an inert cell
#pragma unroll
    for (int u = 0; u < K5_BATCH; ++u)
      if (g[u] >= 0)
        final_level(kc, q, sm, g[u], plane, in[u], zero, 1.0f, 1.0f, 1.0f,
                    dt, odt);
  }
  for (int c = threadIdx.x; c < cn; c += blockDim.x) {
    const long col = col0 + c;
    rain[col] = rain[col] + 0.0f + 0.0f + 0.0f + 0.0f;
    snow[col] = snow[col] + 0.0f + 0.0f;
    graupel[col] = graupel[col] + 0.0f;
  }
}

// Active pass: as many blocks as the card holds at once; each claims the
// listed tiles one by one (counts[1]) until the list is done. A tile's C
// columns x nz levels keep their intermediates in shared memory; the
// passes are separated by barriers and every loop is block-stride.
__global__ void __launch_bounds__(K5_THREADS, K5_MIN_BLOCKS)
mp_thompson_active_kernel(float* __restrict__ q, Smap sm,
                          const float* __restrict__ exner_g,
                          const float* __restrict__ p_g,
                          const float* __restrict__ dz_g, TabPtrs tp,
                          const float* __restrict__ kc,
                          float* __restrict__ rain, float* __restrict__ snow,
                          float* __restrict__ graupel, int nz, long ncol,
                          int cols, float dt, int* __restrict__ counts,
                          const int* __restrict__ tiles) {
  const int n_active = counts[0];
  if ((int)blockIdx.x >= n_active) return;
  extern __shared__ float k5_smem[];
  float* K = k5_smem;
  int* slot = (int*)(K + KC_PAD - 1);        // the claimed list entry
  int* n_listed = (int*)(K + KC_PAD - 2);    // active cells of the tile
  float* ppt = K + KC_PAD;   // (4, C): rain, ice, snow, graupel
  float* S = ppt + 4 * cols;
  const int cells = cols * nz;
  auto f = [&](int field) { return S + field * cells; };
  int* listed = (int*)(S + N_SF * cells);   // their cell indices
  const long plane = (long)nz * ncol;
  const float odt = 1.0f / dt;
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < N_CONSTS; i += nth) K[i] = kc[i];
  const float n0_inert = graupel_n0_exp(R1, 0.0f, 0.0f, false);
  for (;;) {
    if (tid == 0) *slot = atomicAdd(counts + 1, 1);
    __syncthreads();
    const int t = *slot;
    if (t >= n_active) return;
    const long col0 = (long)tiles[t] * cols;
    const int cn = (int)min((long)cols, ncol - col0);

    // (A) one thread per cell: a cell where the activity predicate fails
    // takes what the core would leave there (inert_core); the others are
    // listed, with their prep graupel intercept. Then the intercept's
    // running minimum from the model top down, one thread per column.
    float* n0 = f(S_N0);
    float* n0min = f(S_QSED_R);   // free until pass D
    auto keep = [&](int i, const Core& O, float dz) {
      f(S_DZ)[i] = dz;
      f(S_RHO)[i] = O.rho; f(S_OCP)[i] = O.ocp; f(S_LVAP)[i] = O.lvap;
      f(S_TEMP)[i] = O.temp; f(S_RHOF)[i] = O.rhof; n0[i] = O.n0exp;
      f(S_TTEN)[i] = O.tten; f(S_QVTEN)[i] = O.qvten;
      f(S_QCTEN)[i] = O.qcten; f(S_QITEN)[i] = O.qiten;
      f(S_NITEN)[i] = O.niten; f(S_QRTEN)[i] = O.qrten;
      f(S_NRTEN)[i] = O.nrten; f(S_QSTEN)[i] = O.qsten;
      f(S_QGTEN)[i] = O.qgten;
      f(S_RR)[i] = O.rr; f(S_NR)[i] = O.nr; f(S_RI)[i] = O.ri;
      f(S_NI)[i] = O.ni; f(S_RS)[i] = O.rs; f(S_RG)[i] = O.rg;
      f(S_VTR)[i] = O.vtr; f(S_VTNR)[i] = O.vtnr; f(S_VTI)[i] = O.vti;
      f(S_VTNI)[i] = O.vtni; f(S_VTS)[i] = O.vts;
    };
    if (tid == 0) *n_listed = 0;
    __syncthreads();
    for (int i = tid; i < cells; i += nth) {
      const int k = i / cols, c = i - k * cols;
      if (c >= cn) continue;
      const long g = (long)k * ncol + col0 + c;
      const Level in = load_level(q, sm, exner_g, p_g, g, plane);
#ifndef THOMPSON_NO_SKIP
      if (!cell_active(in)) {
        Core O;
        inert_core(in, n0_inert, O);
        keep(i, O, dz_g[g]);
        continue;
      }
#endif
      Prep P;
      prep_level<false>(K, in, 0.0f, P);
      n0[i] = P.n0exp;
      listed[atomicAdd(n_listed, 1)] = i;
    }
    __syncthreads();
    for (int c = tid; c < cn; c += nth) {
      float m = 0.0f;
      for (int k = nz - 1; k >= 0; --k) {
        const int i = k * cols + c;
        m = k == nz - 1 ? n0[i] : jmin(n0[i], m);
        n0min[i] = m;
      }
    }
    __syncthreads();

    // (B) prep, bins, table values and core of each listed cell
    const int n_cells = *n_listed;
    for (int j = tid; j < n_cells; j += nth) {
      const int i = listed[j];
      const int k = i / cols, c = i - k * cols;
      const long g = (long)k * ncol + col0 + c;
      Prep P;
      prep_level<true>(K, load_level(q, sm, exner_g, p_g, g, plane),
                       n0min[i], P);
      Tables T;
      lookup(K, P, tp, T);
      Core O;
      core_level(K, P, T, dt, odt, O);
      keep(i, O, dz_g[g]);
    }
    __syncthreads();

    // (C) top-down, one thread per column: fill each velocity from the level
    // above where the species is absent; snow above freezing falls at
    // least as fast as the filled rain; graupel's intercept takes its
    // running minimum. Then graupel's fall speed from that minimum, one
    // thread per cell, and its fill, one thread per column.
    for (int c = tid; c < cn; c += nth) {
      float a_r = 0.0f, a_nr = 0.0f, a_i = 0.0f, a_ni = 0.0f, a_s = 0.0f,
            n0min = 0.0f;
      for (int k = nz - 1; k >= 0; --k) {
        const int i = k * cols + c;
        if (f(S_RR)[i] > R1) { a_r = f(S_VTR)[i]; a_nr = f(S_VTNR)[i]; }
        f(S_VTR)[i] = a_r;
        f(S_VTNR)[i] = a_nr;
        if (f(S_RI)[i] > R1) { a_i = f(S_VTI)[i]; a_ni = f(S_VTNI)[i]; }
        f(S_VTI)[i] = a_i;
        f(S_VTNI)[i] = a_ni;
        const float vts = f(S_VTS)[i];
        const float vts_full = f(S_TEMP)[i] > T_0 ? jmax(vts, a_r) : vts;
        if (f(S_RS)[i] > R1) a_s = vts_full;
        f(S_VTS)[i] = a_s;
        n0min = k == nz - 1 ? n0[i] : jmin(n0[i], n0min);
        n0[i] = n0min;
      }
    }
    __syncthreads();
    for (int i = tid; i < cells; i += nth) {
      if (i % cols >= cn) continue;
      float ilamg, n0g;
      graupel_slope(K, n0[i], f(S_RG)[i], &ilamg, &n0g);
      const float v = f(S_RHOF)[i] * K[K_AVG] * K[K_CGG5] * K[K_OGG3]
                      * cpow(ilamg, K[K_BVG]);
      f(S_VTG)[i] = f(S_TEMP)[i] > T_0 ? jmax(v, f(S_VTR)[i]) : v;
      f(S_ODZ)[i] = 1.0f / f(S_DZ)[i];
      f(S_ORHO)[i] = 1.0f / f(S_RHO)[i];
    }
    __syncthreads();
    for (int c = tid; c < cn; c += nth) {
      float a_g = 0.0f;
      for (int k = nz - 1; k >= 0; --k) {
        const int i = k * cols + c;
        if (f(S_RG)[i] > R1) a_g = f(S_VTG)[i];
        f(S_VTG)[i] = a_g;
      }
    }
    __syncthreads();

    // (D) sedimentation of rain, ice, snow and graupel, one thread per
    // (species, column): each species' fall adds only into its own
    // tendencies
    for (int j = tid; j < 4 * cols; j += nth) {
      const int sp = j / cols, c = j - sp * cols;
      if (c >= cn) continue;
      const SedSpecies e = sed_species(sp);
      float *m = f(e.m) + c, *n = f(e.n) + c, *qs = f(e.qsed) + c,
            *ns = f(e.nsed) + c;
      const float *vm = f(e.vm) + c, *vn = f(e.vn) + c, *dz = f(S_DZ) + c,
                  *odz = f(S_ODZ) + c, *orho = f(S_ORHO) + c;
      ppt[j] = e.number ? sediment<true>(m, n, vm, vn, dz, odz, orho, qs, ns,
                                         nz, cols, dt, e.cfl_max)
                        : sediment<false>(m, n, vm, vn, dz, odz, orho, qs,
                                          ns, nz, cols, dt, e.cfl_max);
      for (int k = 0; k < nz; ++k) {
        const int i = k * cols + c;
        f(e.tm)[i] = f(e.tm)[i] + f(e.qsed)[i];
        if (e.number) f(e.tn)[i] = f(e.tn)[i] + f(e.nsed)[i];
      }
    }
    __syncthreads();

    // the surface accumulators, in the JAX order
    for (int c = tid; c < cn; c += nth) {
      const long col = col0 + c;
      const float p_rain = ppt[c], p_ice = ppt[cols + c],
                  p_snow = ppt[2 * cols + c], p_graupel = ppt[3 * cols + c];
      rain[col] = rain[col] + p_rain + p_snow + p_graupel + p_ice;
      snow[col] = snow[col] + p_snow + p_ice;
      graupel[col] = graupel[col] + p_graupel;
    }

    // (E) instant melt / homogeneous freeze and the final update of each cell
    for (int i = tid; i < cells; i += nth) {
      const int k = i / cols, c = i - k * cols;
      if (c >= cn) continue;
      const long g = (long)k * ncol + col0 + c;
      const Tend d{f(S_TTEN)[i], f(S_QVTEN)[i], f(S_QCTEN)[i], f(S_QITEN)[i],
                   f(S_NITEN)[i], f(S_QRTEN)[i], f(S_NRTEN)[i], f(S_QSTEN)[i],
                   f(S_QGTEN)[i]};
      final_level(K, q, sm, g, plane,
                  load_level(q, sm, exner_g, p_g, g, plane), d, f(S_OCP)[i],
                  f(S_LVAP)[i], f(S_RHO)[i], dt, odt);
    }
    __syncthreads();   // the next tile reuses the shared memory
  }
}

}  // namespace

// the deepest column K5 takes: one column's tile fills a block's shared
// memory
extern "C" int icar_mp_thompson_max_nz() {
  return (int)((K5_SMEM_MAX / 4 - KC_PAD - 4) / (N_SF + 1));
}

// columns per tile at nz levels (0: nz is too deep)
extern "C" int icar_mp_thompson_tile_columns(int nz) {
  return nz < 1 ? 0 : tile_columns(nz);
}

// the active pass's dynamic shared memory per block at nz levels
extern "C" long icar_mp_thompson_smem_bytes(int nz) {
  const int cols = icar_mp_thompson_tile_columns(nz);
  return cols == 0 ? 0 : active_smem(cols, nz);
}

extern "C" int icar_mp_thompson_n_consts() { return N_CONSTS; }

// K5: Thompson microphysics on the (9, nz, ncol) stack, in place; smap is a
// host array of 9 stack rows; the seven tables and the constants are device
// arrays (see physics/mp_thompson.py device_tables, kernel_constants);
// counts (two ints) and tiles (ceil(ncol / C) ints, C =
// icar_mp_thompson_tile_columns(nz)) are device scratch: the number of
// active tiles and of tiles claimed, and the list of active tiles
extern "C" int icar_mp_thompson(float* stack, const int* smap,
                                const float* exner, const float* p,
                                const float* dz, const void* racs,
                                const void* racg, const void* qrfz,
                                const float* efrw, const float* efsw,
                                const float* qcfz, const float* iaus,
                                const float* consts, float* rain, float* snow,
                                float* graupel, int* counts, int* tiles,
                                int nz, long ncol, float dt, void* stream) {
  const int cols = nz < 1 ? 0 : tile_columns(nz);
  if (cols == 0 || ncol < 1) return (int)cudaErrorInvalidValue;
  Smap sm;
  for (int i = 0; i < 9; ++i) sm.row[i] = smap[i];
  TabPtrs tp{(const __nv_bfloat16*)racs, (const __nv_bfloat16*)racg,
             (const __nv_bfloat16*)qrfz, efrw, efsw, qcfz, iaus};
  const cudaStream_t st = (cudaStream_t)stream;
  const long ntiles = (ncol + cols - 1) / cols;
  const long smem = active_smem(cols, nz);
  cudaError_t err = cudaFuncSetAttribute(
      mp_thompson_active_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mp_thompson_active_kernel, K5_THREADS, (size_t)smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  mp_thompson_classify_kernel<<<(unsigned)ntiles, K5_CLASSIFY_THREADS, 0,
                                st>>>(
      stack, sm, exner, p, consts, rain, snow, graupel, nz, ncol, cols, dt,
      counts, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long resident = (long)per_sm * sms;
  const unsigned grid = (unsigned)(ntiles < resident ? ntiles : resident);
  mp_thompson_active_kernel<<<grid, K5_THREADS, smem, st>>>(
      stack, sm, exner, p, dz, tp, consts, rain, snow, graupel, nz, ncol,
      cols, dt, counts, tiles);
  return (int)cudaGetLastError();
}

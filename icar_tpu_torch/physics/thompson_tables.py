"""Copy of icar_tpu/physics/thompson_tables.py, kept identical by
tests/test_torch_setup.py.

Thompson microphysics lookup tables (host-side, numpy).

The reference (mp_thompson.f90:2853-3611) builds its collision/freezing
tables with quadruple nested Fortran loops over explicit size bins, which
takes minutes and is cached in unformatted .dat files. Here every table is
a vectorized numpy contraction: the collision kernels factorize into
(distribution x kernel x distribution) einsums, so the full table set
builds in a couple of seconds at model init — no disk cache needed.

All arrays are float64 during the build (matching the reference's DOUBLE
PRECISION) and exported as float32 for the device.

Tables (names follow the reference):
  tcg_racg, tmr_racg, tcr_gacr, tmg_gacr, tnr_racg, tnr_gacr
      (ntb_g1, ntb_g, ntb_r1, ntb_r)  rain/graupel collection
  tcs_racs1/2, tmr_racs1/2, tcr_sacr1/2, tms_sacr1/2, tnr_racs1/2,
  tnr_sacr1/2  (ntb_s, ntb_t, ntb_r1, ntb_r)  rain/snow collection
  tpi_qrfz, tpg_qrfz, tni_qrfz, tnr_qrfz (ntb_r, ntb_r1, 45) rain freezing
  tpi_qcfz, tni_qcfz (ntb_c, 45)          cloud water freezing
  tps_iaus, tni_iaus, tpi_ide (ntb_i, ntb_i1) ice autoconversion/depos.
  t_Efrw (nbr, nbc), t_Efsw (nbs, nbc)    collision efficiencies

The reference's tnr_rev table (table_dropEvap) is never built — the call
is commented out at mp_thompson.f90:725 and the column scheme computes
pnr_rev from prv_rev directly — so it is omitted here too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from scipy.special import gammainc

PI = 3.1415926536          # the scheme's own PI2 (mp_thompson.f90:54)

# fixed scheme parameters (mp_thompson.f90:56-210)
RHO_W = 1000.0
RHO_S = 100.0
RHO_I = 890.0
MU_S = 0.6357
KAP0, KAP1 = 490.6, 17.46
LAM0, LAM1 = 20.78, 3.29
GONV_MIN, GONV_MAX = 1e4, 3e6
AM_R = PI * RHO_W / 6.0
BM_R = 3.0
BM_S = 2.0
BM_G = 3.0
AM_I = PI * RHO_I / 6.0
BM_I = 3.0
AV_R, BV_R, FV_R = 4854.0, 1.0, 195.0
BV_I = 1.0
C_CUBE = 0.5
R1, R2 = 1e-12, 1e-6
EPS = 1e-15
ATO = 0.304
RHO_NOT = 101325.0 / (287.05 * 298.0)
SC = 0.632
SC3 = SC ** (1.0 / 3.0)
HGFR = 235.16
RV = 461.5
RR2 = 287.04
CP2 = 1004.0
LSUB = 2.834e6
LVAP0 = 2.5e6
LFUS = LSUB - LVAP0
OLFUS = 1.0 / LFUS
XM0I = 1e-12
D0C, D0R, D0S, D0G = 1e-6, 50e-6, 200e-6, 250e-6

NBINS = 100
NBC = NBR = NBS = NBG = NBI = NBINS
NTB_C, NTB_I, NTB_R, NTB_S, NTB_G = 37, 64, 37, 28, 28
NTB_G1, NTB_R1, NTB_I1, NTB_T = 28, 37, 55, 9

def _decade(lo_exp, hi_exp):
    out = []
    for e in range(lo_exp, hi_exp):
        out.extend([m * 10.0 ** e for m in range(1, 10)])
    out.append(10.0 ** hi_exp)
    return np.array(out)

r_c = _decade(-6, -2)           # 37
r_i = _decade(-10, -3)          # 64
r_r = _decade(-6, -2)           # 37
r_g = _decade(-5, -2)           # 28
r_s = _decade(-5, -2)           # 28
N0r_exp = _decade(6, 10)        # 37
N0g_exp = _decade(4, 7)         # 28
Nt_i = _decade(0, 6)            # 55

# Field et al. (2005) snow moment coefficients
SA = np.array([5.065339, -0.062659, -3.032362, 0.029469, -0.000285,
               0.31255, 0.000204, 0.003199, 0.0, -0.015952])
SB = np.array([0.476221, -0.015896, 0.165977, 0.007468, -0.000141,
               0.060366, 0.000079, 0.000594, 0.0, -0.003577])
Tc_tab = np.array([-0.01, -5., -10., -15., -20., -25., -30., -35., -40.])


def field_moment_coeffs(tc, n):
    """log10(a) and b for the Field et al. (2005) moment relation
    M_n = a(n,Tc) * M_2^b(n,Tc)."""
    terms = np.stack([np.ones_like(tc), tc, np.full_like(tc, n), tc * n,
                      tc * tc, np.full_like(tc, n * n), tc * tc * n,
                      tc * n * n, tc ** 3, np.full_like(tc, n ** 3)], -1)
    return 10.0 ** (terms @ SA), terms @ SB


def _wgamma(y):
    return math.gamma(y)


@dataclass
class ThompsonParams:
    """Tunable parameters (mp_parameters namelist defaults,
    options_obj.f90:1258-1281)."""
    Nt_c: float = 100e6
    TNO: float = 5.0
    am_s: float = 0.069
    rho_g: float = 500.0
    av_s: float = 40.0
    bv_s: float = 0.55
    fv_s: float = 100.0
    av_g: float = 442.0
    bv_g: float = 0.89
    av_i: float = 1847.5
    Ef_si: float = 0.05
    Ef_rs: float = 0.95
    Ef_rg: float = 0.75
    Ef_ri: float = 0.95
    C_cubes: float = 0.5
    C_sqrd: float = 0.3
    mu_r: float = 0.0
    t_adjust: float = 0.0
    Ef_rw_l: bool = False
    Ef_sw_l: bool = False


class ThompsonConstants:
    """All derived constants + gamma-function arrays (thompson_init,
    mp_thompson.f90:420-540). 1-based Fortran arrays are stored 0-based;
    cre[n] in the reference is self.cre[n-1] here."""

    def __init__(self, p: ThompsonParams):
        self.p = p
        self.mu_c = min(15.0, 1000e6 / p.Nt_c + 2.0)
        self.mu_g = 0.0
        self.mu_i = 0.0
        self.mu_r = p.mu_r
        self.am_g = PI * p.rho_g / 6.0
        self.D0i = (XM0I / AM_I) ** (1.0 / BM_I)
        self.xm0s = p.am_s * D0S ** BM_S
        self.xm0g = self.am_g * D0G ** BM_G

        mu_c, mu_r, mu_i, mu_g = self.mu_c, p.mu_r, 0.0, 0.0
        self.cce = np.array([mu_c + 1., BM_R + mu_c + 1., BM_R + mu_c + 4.])
        self.ccg = np.array([_wgamma(x) for x in self.cce])
        self.ocg1, self.ocg2 = 1. / self.ccg[0], 1. / self.ccg[1]

        self.cie = np.array([mu_i + 1., BM_I + mu_i + 1.,
                             BM_I + mu_i + BV_I + 1., mu_i + BV_I + 1.,
                             mu_i + 2., BM_I * .5 + mu_i + BV_I + 1.,
                             BM_I * .5 + mu_i + 1.])
        self.cig = np.array([_wgamma(x) for x in self.cie])
        self.oig1, self.oig2 = 1. / self.cig[0], 1. / self.cig[1]
        self.obmi = 1. / BM_I

        self.cre = np.array([
            BM_R + 1., mu_r + 1., BM_R + mu_r + 1., BM_R * 2. + mu_r + 1.,
            mu_r + BV_R + 1., BM_R + mu_r + BV_R + 1.,
            BM_R * .5 + mu_r + BV_R + 1., BM_R + mu_r + BV_R + 3.,
            mu_r + BV_R + 3., mu_r + 2., .5 * (BV_R + 5. + 2. * mu_r),
            BM_R * .5 + mu_r + 1., BM_R * 2. + mu_r + BV_R + 1.])
        self.crg = np.array([_wgamma(x) for x in self.cre])
        self.obmr = 1. / BM_R
        self.ore1 = 1. / self.cre[0]
        self.org1, self.org2, self.org3 = (1. / self.crg[0],
                                           1. / self.crg[1], 1. / self.crg[2])

        bv_s = p.bv_s
        self.cse = np.array([
            BM_S + 1., BM_S + 2., BM_S * 2., BM_S + bv_s + 1.,
            BM_S * 2. + bv_s + 1., BM_S * 2. + 1., BM_S + MU_S + 1.,
            BM_S + MU_S + 2., BM_S + MU_S + 3., BM_S + MU_S + bv_s + 1.,
            BM_S * 2. + MU_S + bv_s + 1., BM_S * 2. + MU_S + 1.,
            bv_s + 2., BM_S + bv_s, MU_S + 1., 1.0 + (1.0 + bv_s) / 2.,
            (1.0 + (1.0 + bv_s) / 2.) + MU_S + 1., bv_s + MU_S + 3.])
        self.csg = np.array([_wgamma(x) for x in self.cse])
        self.oams = 1. / p.am_s
        self.obms = 1. / BM_S
        self.ocms = self.oams ** self.obms

        bv_g = p.bv_g
        self.cge = np.array([
            BM_G + 1., mu_g + 1., BM_G + mu_g + 1., BM_G * 2. + mu_g + 1.,
            BM_G * 2. + mu_g + bv_g + 1., BM_G + mu_g + bv_g + 1.,
            BM_G + mu_g + bv_g + 2., BM_G + mu_g + bv_g + 3.,
            mu_g + bv_g + 3., mu_g + 2., .5 * (bv_g + 5. + 2. * mu_g),
            .5 * (bv_g + 5.) + mu_g])
        self.cgg = np.array([_wgamma(x) for x in self.cge])
        self.oamg = 1. / self.am_g
        self.obmg = 1. / BM_G
        self.ocmg = self.oamg ** self.obmg
        self.oge1 = 1. / self.cge[0]
        self.ogg1, self.ogg2, self.ogg3 = (1. / self.cgg[0],
                                           1. / self.cgg[1], 1. / self.cgg[2])

        # simplified rate prefactors (mp_thompson.f90:536-566)
        self.t1_qr_qc = PI * .25 * AV_R * self.crg[8]
        self.t1_qr_qi = PI * .25 * AV_R * self.crg[8]
        self.t2_qr_qi = PI * .25 * AM_R * AV_R * self.crg[7]
        self.t1_qg_qc = PI * .25 * p.av_g * self.cgg[8]
        self.t1_qs_qc = PI * .25 * p.av_s
        self.t1_qs_qi = PI * .25 * p.av_s
        self.t1_qr_ev = 0.78 * self.crg[9]
        self.t2_qr_ev = 0.308 * SC3 * math.sqrt(AV_R) * self.crg[10]
        self.t1_qs_sd = 0.86
        self.t2_qs_sd = 0.28 * SC3 * math.sqrt(p.av_s)
        self.t1_qs_me = PI * 4. * p.C_sqrd * OLFUS * 0.86
        self.t2_qs_me = PI * 4. * p.C_sqrd * OLFUS * 0.28 * SC3 \
            * math.sqrt(p.av_s)
        self.t1_qg_sd = 0.86 * self.cgg[9]
        self.t2_qg_sd = 0.28 * SC3 * math.sqrt(p.av_g) * self.cgg[10]
        self.t1_qg_me = PI * 4. * C_CUBE * OLFUS * 0.86 * self.cgg[9]
        self.t2_qg_me = PI * 4. * C_CUBE * OLFUS * 0.28 * SC3 \
            * math.sqrt(p.av_g) * self.cgg[10]

        # decade offsets for mantissa table indexing
        self.nic2 = round(math.log10(r_c[0]))
        self.nii2 = round(math.log10(r_i[0]))
        self.nii3 = round(math.log10(Nt_i[0]))
        self.nir2 = round(math.log10(r_r[0]))
        self.nir3 = round(math.log10(N0r_exp[0]))
        self.nis2 = round(math.log10(r_s[0]))
        self.nig2 = round(math.log10(r_g[0]))
        self.nig3 = round(math.log10(N0g_exp[0]))

        self._make_bins()

    def _make_bins(self):
        """Size bins (thompson_init, mp_thompson.f90:585-640)."""
        self.Dc = D0C + 1e-6 * np.arange(NBC)
        self.dtc = np.full(NBC, 1e-6)
        self.dtc[0] = D0C

        def log_bins(d_lo, d_hi, n):
            edges = np.exp(np.arange(n + 1) / n * np.log(d_hi / d_lo)
                           + np.log(d_lo))
            mids = np.sqrt(edges[:-1] * edges[1:])
            return mids, np.diff(edges)

        self.Di, self.dti = log_bins(self.D0i, 5.0 * D0S, NBI)
        self.Dr, self.dtr = log_bins(D0R, 0.005, NBR)
        self.Ds, self.dts = log_bins(D0S, 0.02, NBS)
        self.Dg, self.dtg = log_bins(D0G, 0.05, NBG)


def _vr_poly(D):
    """Rain fallspeed polynomial used inside the table builds
    (mp_thompson.f90:2895)."""
    return (-0.1021 + 4.932e3 * D - 0.9551e6 * D ** 2
            + 0.07934e9 * D ** 3 - 0.002362e12 * D ** 4)


def build_tables(params: ThompsonParams):
    """Build every lookup table; returns dict[str, np.ndarray f32]."""
    c = ThompsonConstants(params)
    p = params
    out = {}

    # rain distributions indexed [k (ntb_r1), m (ntb_r), bin]
    n0e = N0r_exp[:, None]
    lam_exp = (n0e * AM_R * c.crg[0] / r_r[None, :]) ** c.ore1
    lamr = lam_exp * (c.crg[2] * c.org2 * c.org1) ** c.obmr
    N0_r = n0e / (c.crg[1] * lam_exp) * lamr ** c.cre[1]
    Nr = (N0_r[..., None] * c.Dr ** p.mu_r
          * np.exp(-lamr[..., None] * c.Dr) * c.dtr)   # (ntb_r1, ntb_r, nbr)

    vr = _vr_poly(c.Dr)

    # ---- qr_acr_qg (mp_thompson.f90:2853-3007) -------------------------
    lam_exp_g = (N0g_exp[:, None] * c.am_g * c.cgg[0] / r_g[None, :]) \
        ** c.oge1
    lamg = lam_exp_g * (c.cgg[2] * c.ogg2 * c.ogg1) ** c.obmg
    N0_g = N0g_exp[:, None] / (c.cgg[1] * lam_exp_g) * lamg ** c.cge[1]
    Ng = (N0_g[..., None] * c.Dg ** 0.0
          * np.exp(-lamg[..., None] * c.Dg) * c.dtg)   # (ntb_g1, ntb_g, nbg)

    vg = p.av_g * c.Dg ** p.bv_g
    dvg = np.maximum(vr[:, None] - vg[None, :], 0.0)   # (nbr, nbg)
    dvr = np.maximum(vg[None, :] - vr[:, None], 0.0)
    geom = PI * .25 * p.Ef_rg * (c.Dg[None, :] + c.Dr[:, None]) ** 2
    massr = AM_R * c.Dr ** BM_R
    massg = c.am_g * c.Dg ** BM_G

    def contract_rg(kernel):
        # kernel (nbr, nbg) -> table (ntb_g1, ntb_g, ntb_r1, ntb_r)
        t = np.einsum('kmr,rg,ijg->ijkm', Nr, kernel, Ng, optimize=True)
        return t

    out["tcg_racg"] = contract_rg(geom * dvg * massg[None, :])
    tmr = contract_rg(geom * dvg * massr[:, None])
    out["tmr_racg"] = np.minimum(tmr, r_r[None, None, None, :])
    out["tcr_gacr"] = contract_rg(geom * dvr * massr[:, None])
    out["tmg_gacr"] = contract_rg(geom * dvr * massg[None, :])
    out["tnr_racg"] = contract_rg(geom * dvg)
    out["tnr_gacr"] = contract_rg(geom * dvr)

    # ---- qr_acr_qs (mp_thompson.f90:3014-3264) -------------------------
    # snow distribution: Field et al. 2-gamma, per (r_s, Tc) pair
    M2 = (r_s[:, None] * c.oams).repeat(NTB_T, 1)      # (ntb_s, ntb_t)
    tc = np.broadcast_to(Tc_tab, (NTB_S, NTB_T))
    # bm_s == 2 -> second moment is M2 itself
    a3, b3 = field_moment_coeffs(tc, c.cse[0])
    M3 = a3 * M2 ** b3
    oM3 = 1.0 / M3
    Mrat = M2 * (M2 * oM3) ** 3
    M0 = (M2 * oM3) ** MU_S
    slam1 = M2 * oM3 * LAM0
    slam2 = M2 * oM3 * LAM1
    Ns = (Mrat[..., None]
          * (KAP0 * np.exp(-slam1[..., None] * c.Ds)
             + KAP1 * M0[..., None] * c.Ds ** MU_S
             * np.exp(-slam2[..., None] * c.Ds)) * c.dts)  # (ntb_s,ntb_t,nbs)

    vs = 1.5 * p.av_s * c.Ds ** p.bv_s * np.exp(-p.fv_s * c.Ds)
    dvs = np.maximum(vr[:, None] - vs[None, :], 0.0)   # (nbr, nbs)
    dvr_s = np.maximum(vs[None, :] - vr[:, None], 0.0)
    geom_s = PI * .25 * p.Ef_rs * (c.Ds[None, :] + c.Dr[:, None]) ** 2
    masss = p.am_s * c.Ds ** BM_S
    big_r = massr[:, None] > 1.5 * masss[None, :]      # rain-dominant mask

    def contract_rs(kernel):
        # kernel (nbr, nbs) -> (ntb_s, ntb_t, ntb_r1, ntb_r)
        return np.einsum('kmr,rs,its->itkm', Nr, kernel, Ns, optimize=True)

    k_ms = geom_s * dvs * masss[None, :]
    k_mr = geom_s * dvs * massr[:, None]
    k_n = geom_s * dvs
    out["tcs_racs1"] = contract_rs(k_ms * big_r)
    out["tmr_racs1"] = np.minimum(contract_rs(k_mr * big_r),
                                  r_r[None, None, None, :])
    out["tcs_racs2"] = contract_rs(k_ms * ~big_r)
    out["tmr_racs2"] = contract_rs(k_mr * ~big_r)
    out["tnr_racs1"] = contract_rs(k_n * big_r)
    out["tnr_racs2"] = contract_rs(k_n * ~big_r)
    k2_mr = geom_s * dvr_s * massr[:, None]
    k2_ms = geom_s * dvr_s * masss[None, :]
    k2_n = geom_s * dvr_s
    out["tcr_sacr1"] = contract_rs(k2_mr * big_r)
    out["tms_sacr1"] = contract_rs(k2_ms * big_r)
    out["tcr_sacr2"] = contract_rs(k2_mr * ~big_r)
    out["tms_sacr2"] = contract_rs(k2_ms * ~big_r)
    out["tnr_sacr1"] = contract_rs(k2_n * big_r)
    out["tnr_sacr2"] = contract_rs(k2_n * ~big_r)

    # ---- freezeH2O (mp_thompson.f90:3273-3399) -------------------------
    # Bigg freezing with top-down bin accumulation capped at the total
    # water content (the reference EXITs once the running sum reaches r).
    ks = np.arange(1, 46)
    Texp = np.exp(ks.astype(np.float64) - p.t_adjust) - 1.0    # (45,)
    orho_w = 1.0 / RHO_W
    prob_r = np.maximum(
        1.0 - np.exp(-120.0 * (massr * orho_w)[None, :]
                     * 5.2e-4 * Texp[:, None]), 0.0)           # (45, nbr)

    # rain part: iterate bins largest->smallest; include a bin only if the
    # running total before it is < r_r (the reference EXITs the bin loop
    # once the sum reaches r).  Chunked over temperature to bound memory.
    Nr_t = Nr.transpose(1, 0, 2)                   # (ntb_r, ntb_r1, nbr)
    small = (massr < c.xm0g)
    tpi = np.empty((NTB_R, NTB_R1, 45))
    tpg = np.empty_like(tpi)
    tni = np.empty_like(tpi)
    tnr = np.empty_like(tpi)
    for kk in range(45):
        contrib_n = prob_r[kk] * Nr_t               # (ntb_r, ntb_r1, nbr)
        contrib_m = contrib_n * massr
        rev_m = contrib_m[..., ::-1]
        cum_before = np.concatenate(
            [np.zeros_like(rev_m[..., :1]),
             np.cumsum(rev_m, axis=-1)[..., :-1]], axis=-1)
        include = (cum_before < r_r[:, None, None])[..., ::-1]
        tpi[:, :, kk] = (contrib_m * include * small).sum(-1)
        tpg[:, :, kk] = (contrib_m * include * ~small).sum(-1)
        tni[:, :, kk] = (contrib_n * include * small).sum(-1)
        tnr[:, :, kk] = (contrib_n * include * ~small).sum(-1)
    out["tpi_qrfz"] = tpi
    out["tpg_qrfz"] = tpg
    out["tni_qrfz"] = tni
    out["tnr_qrfz"] = tnr

    # cloud part
    massc = AM_R * c.Dc ** BM_R
    lamc = 1e-6 * (p.Nt_c * AM_R * c.ccg[1] * c.ocg1 / r_c) ** c.obmr
    N0_c = 1e-18 * p.Nt_c * c.ocg1 * lamc ** c.cce[0]
    y = c.Dc * 1e6
    Nc = 1e24 * (N0_c[:, None] * y ** c.mu_c
                 * np.exp(-lamc[:, None] * y) * c.dtc)       # (ntb_c, nbc)
    prob_c = np.maximum(
        1.0 - np.exp(-120.0 * (massc * orho_w)[None, :]
                     * 5.2e-4 * Texp[:, None]), 0.0)         # (45, nbc)
    contrib_cm = prob_c[:, None, :] * Nc[None, ...] * massc  # (45,ntb_c,nbc)
    contrib_cn = prob_c[:, None, :] * Nc[None, ...]
    rev_cm = contrib_cm[..., ::-1]
    cum_before = np.concatenate(
        [np.zeros_like(rev_cm[..., :1]),
         np.cumsum(rev_cm, axis=-1)[..., :-1]], axis=-1)
    include_c = (cum_before < r_c[None, :, None])[..., ::-1]
    out["tpi_qcfz"] = (contrib_cm * include_c).sum(-1).T     # (ntb_c, 45)
    out["tni_qcfz"] = (contrib_cn * include_c).sum(-1).T

    # ---- qi_aut_qs (mp_thompson.f90:3413-3456) -------------------------
    lami = (AM_I * c.cig[1] * c.oig1 * Nt_i[None, :]
            / r_i[:, None]) ** c.obmi                         # (ntb_i, ntb_i1)
    Di_mean = (BM_I + c.mu_i + 1.0) / lami
    N0_i = Nt_i[None, :] * c.oig1 * lami ** c.cie[0]
    Ni_b = (N0_i[..., None] * c.Di ** c.mu_i
            * np.exp(-lami[..., None] * c.Di) * c.dti)        # (...,nbi)
    mass_i = AM_I * c.Di ** BM_I
    big = c.Di >= D0S
    t1 = (Ni_b * mass_i * big).sum(-1)
    t2 = (Ni_b * big).sum(-1)
    tpi_ide = gammainc(c.mu_i + 2.0, lami * D0S)
    hi = Di_mean > 5.0 * D0S
    lo = Di_mean < c.D0i
    out["tps_iaus"] = np.where(hi, r_i[:, None],
                               np.where(lo, 0.0, t1))
    out["tni_iaus"] = np.where(hi, Nt_i[None, :],
                               np.where(lo, 0.0, t2))
    out["tpi_ide"] = np.where(hi, 0.0, np.where(lo, 1.0, tpi_ide))

    # ---- t_Efrw (mp_thompson.f90:3464-3525) ----------------------------
    Dr_b, Dc_b = c.Dr[:, None], c.Dc[None, :]
    pr = Dc_b / Dr_b
    X = Dc_b * 1e6 + np.zeros_like(Dr_b)
    poly = np.select(
        [Dr_b < 75e-6, Dr_b < 125e-6, Dr_b < 175e-6, Dr_b < 250e-6,
         Dr_b < 350e-6],
        [0.026794 * X - 0.20604,
         -0.00066842 * X ** 2 + 0.061542 * X - 0.37089,
         4.091e-06 * X ** 4 - 0.00030908 * X ** 3 + 0.0066237 * X ** 2
         - 0.0013687 * X - 0.073022,
         9.6719e-5 * X ** 3 - 0.0068901 * X ** 2 + 0.17305 * X - 0.65988,
         9.0488e-5 * X ** 3 - 0.006585 * X ** 2 + 0.16606 * X - 0.56125],
        0.00010721 * X ** 3 - 0.0072962 * X ** 2 + 0.1704 * X - 0.46929)
    vtr = _vr_poly(Dr_b)
    stokes = Dc_b ** 2 * vtr * RHO_W / (9. * 1.718e-5 * Dr_b)
    reyn = 9. * stokes / (pr ** 2 * RHO_W)
    F = np.log(np.maximum(reyn, 1e-300))
    G = -0.1007 - 0.358 * F + 0.0261 * F * F
    K0 = np.exp(G)
    z = np.log(np.maximum(stokes / (K0 + 1e-15), 1e-300))
    H = 0.1465 + 1.302 * z - 0.607 * z * z + 0.293 * z ** 3
    yc0 = 2.0 / PI * np.arctan(H)
    beard = (yc0 + pr) ** 2 / ((1. + pr) ** 2)
    ef = np.where(pr > 0.25, poly, beard)
    ef = np.where((Dr_b < 50e-6) | (Dc_b < 3e-6), 0.0, ef)
    efrw = np.clip(ef, 0.0, 0.95)
    if p.Ef_rw_l:
        efrw = np.where(ef != 0.0, 1.0, efrw)
    out["t_Efrw"] = efrw

    # ---- t_Efsw (mp_thompson.f90:3533-3578) ----------------------------
    Ds_b = c.Ds[:, None]
    vtc = 1.19e4 * (1e4 * Dc_b ** 2 * 0.25)
    vts = p.av_s * Ds_b ** p.bv_s * np.exp(-p.fv_s * Ds_b) - vtc
    Ds_m = (p.am_s * Ds_b ** BM_S / AM_R) ** c.obmr
    ps = Dc_b / Ds_m
    stokes = Dc_b ** 2 * np.maximum(vts, 1e-12) * RHO_W \
        / (9. * 1.718e-5 * Ds_m)
    reyn = 9. * stokes / (ps ** 2 * RHO_W)
    F = np.log(np.maximum(reyn, 1e-300))
    G = -0.1007 - 0.358 * F + 0.0261 * F * F
    K0 = np.exp(G)
    z = np.log(np.maximum(stokes / (K0 + 1e-15), 1e-300))
    H = 0.1465 + 1.302 * z - 0.607 * z * z + 0.293 * z ** 3
    yc0 = 2.0 / PI * np.arctan(H)
    ef = (yc0 + ps) ** 2 / ((1. + ps) ** 2)
    ef = np.clip(ef, 0.0, 0.95)
    bad = (ps > 0.25) | (Ds_b < D0S) | (Dc_b < 6e-6) | (vts < 1e-3)
    efsw = np.where(bad, 0.0, ef)
    if p.Ef_sw_l:
        efsw = np.where(~bad & (ef != 0.0), 1.0, efsw)
    out["t_Efsw"] = efsw

    return {k: v.astype(np.float32) for k, v in out.items()}, c


_CACHE = {}


def get_tables(params: ThompsonParams = None):
    """Memoized table build (first call ~2 s of numpy)."""
    params = params or ThompsonParams()
    key = tuple(sorted(vars(params).items()))
    if key not in _CACHE:
        _CACHE[key] = build_tables(params)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# Thompson-Eidhammer aerosol-aware additions (mp_thompson_aer.f90)
# ---------------------------------------------------------------------------

# the rain fallspeed polynomial is pure arithmetic: usable on jnp arrays
# inside the scheme (Eff_aero species 'r', mp_thompson_aer.f90:5003-5005)
vr_poly_jnp = _vr_poly

AV_C = 0.316946e8                 # cloud droplet fallspeed (aer :141-142)
BV_C = 2.0
NT_C_MAX = 1999.0e6               # aer :81
# background CCN / IN profile constants (aer :83-89)
NA_CCN0, NA_CCN1 = 300.0e6, 50.0e6
NA_IN0, NA_IN1 = 1.5e6, 0.5e6
RHO_NOT0 = 101325.0 / (287.05 * 273.15)   # iceDeMott rho_not0 (aer :4902)
AR_VOLUME = 4.0 / 3.0 * PI * (2.5e-6) ** 3  # iceKoop aerosol vol (aer :192)

# cloud droplet diameter bins, D0c..D0c+99 um (aer :779-784)
Dc_bins = D0C + np.arange(NBC) * 1.0e-6
dtc_bins = np.full(NBC, 1.0e-6)
dtc_bins[0] = D0C
# cloud droplet number bins, 1..3000 per cc geometric (aer :835-844)
_xDx_nc = np.exp(np.linspace(np.log(1.0), np.log(3000.0), NBC + 1))
t_Nc = np.sqrt(_xDx_nc[:-1] * _xDx_nc[1:]) * 1.0e6
NIC1 = float(np.log(t_Nc[-1] / t_Nc[0]))


def _nu_c_of(nc):
    """Per-value cloud PSD shape parameter nu_c = MIN(15, NINT(1e9/nc)+2)
    (aer :1655 and passim)."""
    return np.minimum(15, np.rint(1000.0e6 / nc).astype(np.int64) + 2)


def build_aer_tables():
    """Cloud-droplet evaporation number table tnc_wev[i, j, k]: number of
    droplets smaller than Dc(i) in a PSD with mass r_c(j) and number
    t_Nc(k) (table_dropEvap, mp_thompson_aer.f90:4443-4480). Unlike the
    CCN activation table (whose file read is fully commented out in the
    reference, leaving an all-ones table — see mp_thompson.py
    _activ_ncloud), this one IS computed at init."""
    from scipy.special import gamma as _gamma
    nu = _nu_c_of(t_Nc)                                       # (k,)
    g1 = _gamma(nu + 1.0)
    g2 = _gamma(BM_R + nu + 1.0)
    lamc = (t_Nc[None, :] * AM_R * (g2 / g1)[None, :]
            / r_c[:, None]) ** (1.0 / BM_R)                   # (j, k)
    N0_c = t_Nc[None, :] / g1[None, :] * lamc ** (nu + 1.0)[None, :]
    # N_c[i, j, k] then cumulative sum over i
    N_c = (N0_c[None] * Dc_bins[:, None, None] ** nu[None, None, :]
           * np.exp(-lamc[None] * Dc_bins[:, None, None])
           * dtc_bins[:, None, None])
    tnc_wev = np.cumsum(N_c, axis=0)
    return {"tnc_wev": tnc_wev.astype(np.float32)}


_AER_CACHE = {}


def get_aer_tables():
    if "t" not in _AER_CACHE:
        _AER_CACHE["t"] = build_aer_tables()
    return _AER_CACHE["t"]

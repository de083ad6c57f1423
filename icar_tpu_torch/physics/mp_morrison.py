"""Morrison 2-moment bulk microphysics (mp=3, Morrison et al. 2009;
icar_tpu/physics/mp_morrison.py): cloud droplets, cloud ice, rain,
snow and graupel (or hail, ``hail_opt``) with prognostic number
concentrations for ice, snow, rain and graupel and a constant droplet
number; the reference's compile-time switches as the JAX package keeps
them (IACT=2, IBASE=2, ISUB=0, ILIQ=0, INUC=0, IGRAUP=0).

Plain PyTorch over the whole (z, y, x) grid, section by section under the
JAX package's names and in its operation order: thermodynamics and the
sub-saturation cleanup, the size distributions, the warm and the cold
process-rate branches each with its conservation rescaling, blended by
temperature, the liquid saturation adjustment, the CFL-substepped
sedimentation of the ten species (one stacked (10, z, y, x) tensor; the
"fall speed below precipitation" fill is a loop over the levels from the
top down) and the final instantaneous melting, freezing and size
clamping. No TPU kernel, so no CUDA kernel. The rounding rules of
mp_wsm3 hold (divisions by constants as float32-reciprocal products, a
constant over a field as one division, ``dt`` a 0-d tensor, exp, log and
pow through ``ops/pointwise.py`` with XLA's rewrites of constant powers);
``jax.lax.lgamma`` is ``torch.lgamma``.

Host read: one a call, the largest sedimentation substep count over the
domain (``nmax``), which the substep loop runs (each trip masked per
column). Nothing else is read back.

``_Consts``, the module constants and the saturation tables are host
Python, copies of the JAX package's held by tests/test_torch_setup.py.

Layout (z, y, x) float32; level 0 is the surface (KTS).
"""

from __future__ import annotations

from math import gamma as _gamma_f, pi

import torch

from .. import constants as Cn
from ..ops import pointwise as pw
from ..ops.pointwise import inv
from .mp_thompson import _ipow, _pow, _rd
from .mp_wsm3 import _clip, _dt_tensor

# the species the registry advects with Morrison, in its order
# (icar_tpu/registry.py:350-364)
SPECIES = ("potential_temperature", "water_vapor", "cloud_water",
           "cloud_ice", "rain_mass", "snow_mass", "graupel_mass",
           "ice_number", "snow_number", "rain_number", "graupel_number")

# WRF/ICAR constants (mp_morrison.f90:93-94 via data_structures)
CP = Cn.CP
G = Cn.GRAVITY
R = Cn.RD
RV = Cn.RW
EP_2 = Cn.EP2
PI = pi

# physical constants (MORR_TWO_MOMENT_INIT, mp_morrison.f90:364-470)
AI, AC, AS_, AR = 700.0, 3e7, 11.72, 841.99667
BI, BC, BS, BR = 1.0, 2.0, 0.41, 0.8
RHOSU = 85000.0 / (287.15 * 273.15)
RHOW, RHOI, RHOSN = 997.0, 500.0, 100.0
AIMM, BIMM, ECR = 0.66, 100.0, 1.0
DCS = 125e-6
MI0 = 4.0 / 3.0 * PI * RHOI * (10e-6) ** 3
MG0 = 1.6e-10
F1S, F2S, F1R, F2R = 0.86, 0.28, 0.78, 0.308
QSMALL = 1e-14
EII, ECI = 0.1, 0.7
RIN = 0.1e-6
CPW = 4187.0
CI_, DI = RHOI * PI / 6.0, 3.0
CS_, DS = RHOSN * PI / 6.0, 3.0
DG = 3.0
MMULT = 4.0 / 3.0 * PI * RHOI * (5e-6) ** 3
LAMMAXI, LAMMINI = 1.0 / 1e-6, 1.0 / (2.0 * DCS + 100e-6)
LAMMAXR, LAMMINR = 1.0 / 20e-6, 1.0 / 2800e-6
LAMMAXS, LAMMINS = 1.0 / 10e-6, 1.0 / 2000e-6
LAMMAXG, LAMMING = 1.0 / 20e-6, 1.0 / 2000e-6
NDCNST = 250.0  # cm-3 (mp_morrison.f90:278)


class _Consts:
    """Copy of icar_tpu/physics/mp_morrison.py _Consts: hail_opt-dependent
    parameters + the CONS1..41 efficiency constants
    (mp_morrison.f90:371-378,385-391,440-482)."""

    def __init__(self, hail_opt: int):
        if hail_opt == 1:
            self.AG, self.BG, self.RHOG = 114.5, 0.5, 900.0
        else:
            self.AG, self.BG, self.RHOG = 19.3, 0.37, 400.0
        AG, BG, RHOG = self.AG, self.BG, self.RHOG
        self.CG = RHOG * PI / 6.0
        g = _gamma_f
        self.CONS1 = g(1.0 + DS) * CS_
        self.CONS2 = g(1.0 + DG) * self.CG
        self.CONS3 = g(4.0 + BS) / 6.0
        self.CONS4 = g(4.0 + BR) / 6.0
        self.CONS5 = g(1.0 + BS)
        self.CONS6 = g(1.0 + BR)
        self.CONS7 = g(4.0 + BG) / 6.0
        self.CONS8 = g(1.0 + BG)
        self.CONS9 = g(5.0 / 2.0 + BR / 2.0)
        self.CONS10 = g(5.0 / 2.0 + BS / 2.0)
        self.CONS11 = g(5.0 / 2.0 + BG / 2.0)
        self.CONS12 = g(1.0 + DI) * CI_
        self.CONS13 = g(BS + 3.0) * PI / 4.0 * ECI
        self.CONS14 = g(BG + 3.0) * PI / 4.0 * ECI
        self.CONS15 = (-1108.0 * EII * PI ** ((1.0 - BS) / 3.0)
                       * RHOSN ** ((-2.0 - BS) / 3.0) / (4.0 * 720.0))
        self.CONS16 = g(BI + 3.0) * PI / 4.0 * ECI
        self.CONS17 = (4.0 * 2.0 * 3.0 * RHOSU * PI * ECI * ECI
                       * g(2.0 * BS + 2.0) / (8.0 * (RHOG - RHOSN)))
        self.CONS18 = RHOSN * RHOSN
        self.CONS19 = RHOW * RHOW
        self.CONS20 = 20.0 * PI * PI * RHOW * BIMM
        self.CONS21 = 4.0 / (DCS * RHOI)
        self.CONS22 = PI * RHOI * DCS ** 3 / 6.0
        self.CONS23 = PI / 4.0 * EII * g(BS + 3.0)
        self.CONS24 = PI / 4.0 * ECR * g(BR + 3.0)
        self.CONS25 = PI * PI / 24.0 * RHOW * ECR * g(BR + 6.0)
        self.CONS26 = PI / 6.0 * RHOW
        self.CONS27 = g(1.0 + BI)
        self.CONS28 = g(4.0 + BI) / 6.0
        self.CONS29 = 4.0 / 3.0 * PI * RHOW * (25e-6) ** 3
        self.CONS31 = PI * PI * ECR * RHOSN
        self.CONS32 = PI / 2.0 * ECR
        self.CONS34 = 5.0 / 2.0 + BR / 2.0
        self.CONS35 = 5.0 / 2.0 + BS / 2.0
        self.CONS36 = 5.0 / 2.0 + BG / 2.0
        self.CONS37 = 4.0 * PI * 1.38e-23 / (6.0 * PI * RIN)
        self.CONS38 = PI * PI / 3.0 * RHOW
        self.CONS39 = PI * PI / 36.0 * RHOW * BIMM
        self.CONS40 = PI / 6.0 * BIMM
        self.CONS41 = PI * PI * ECR * RHOW


_CONSTS = {0: _Consts(0), 1: _Consts(1)}

# Flatau et al. (1992) polynomial saturation vapor pressure
# (POLYSVP, mp_morrison.f90:4053-4119)
_SVP_LIQ = (6.11239921, 0.443987641, 0.142986287e-1, 0.264847430e-3,
            0.302950461e-5, 0.206739458e-7, 0.640689451e-10,
            -0.952447341e-13, -0.976195544e-15)
_SVP_ICE = (6.11147274, 0.503160820, 0.188439774e-1, 0.420895665e-3,
            0.615021634e-5, 0.602588177e-7, 0.385852041e-9,
            0.146898966e-11, 0.252751365e-14)


def polysvp(t, ice: bool):
    """Saturation vapor pressure [Pa] (mp_morrison.f90:4053-4119)."""
    a = _SVP_ICE if ice else _SVP_LIQ
    dt = torch.clamp(t - 273.16, min=-80.0)
    p = a[8]
    for c in a[7::-1]:
        p = c + dt * p
    return p * 100.0


def _gam(x):
    """Euler gamma of a positive field (GAMMA, mp_morrison.f90:4123):
    exp(lgamma(x))."""
    return pw.exp(torch.lgamma(x))


def _sd(x, y, eps=1e-35):
    """Safe divide: x/y with a tiny-denominator guard (results are always
    consumed behind threshold masks)."""
    return x / torch.where(torch.abs(y) < eps,
                           torch.where(y < 0, -eps, eps).to(y.dtype), y)


def _psd(q, n, coef, d, lammin, lammax):
    """Inverse-exponential PSD slope with lambda clamping.

    lam = (coef*n/q)**(1/d); on clamp n is re-derived from
    n0 = lam**4 q / coef (e.g. rain, mp_morrison.f90:1540-1566).
    Returns (lam, n0, n_adjusted) -- valid only where q >= QSMALL.
    """
    qs_ = torch.clamp(q, min=QSMALL)
    ns_ = torch.clamp(n, min=0.0)
    lam = _pow(coef * ns_ / qs_, 1.0 / d)
    clamped = (lam < lammin) | (lam > lammax)
    lam = _clip(lam, lammin, lammax)
    n0_clamp = _ipow(lam, 4) * qs_ * inv(coef)
    n0 = torch.where(clamped, n0_clamp, ns_ * lam)
    n_adj = torch.where(clamped, n0 / lam, ns_)
    return lam, n0, n_adj


def _psd_cloud(qc, nc, t, p, cons26):
    """Droplet gamma-PSD parameters: Martin et al. (1994) shape pgam,
    lamc with diameter clamps (mp_morrison.f90:1570-1607).
    Returns (lamc, pgam, nc_adjusted) -- valid where qc >= QSMALL."""
    qs_ = torch.clamp(qc, min=QSMALL)
    ns_ = torch.clamp(nc, min=1e-6)
    dum = p / (287.15 * t)
    pgam = 0.0005714 * (ns_ * inv(1e6) * dum) + 0.2714
    pgam = torch.clamp(_rd(1.0, pgam * pgam) - 1.0, 2.0, 10.0)
    g1 = _gam(pgam + 1.0)
    g4 = _gam(pgam + 4.0)
    lamc = _pow(cons26 * ns_ * g4 / (qs_ * g1), 1.0 / 3.0)
    lammin = (pgam + 1.0) * inv(60e-6)
    lammax = (pgam + 1.0) * inv(1e-6)
    clamped = (lamc < lammin) | (lamc > lammax)
    lamc = _clip(lamc, lammin, lammax)
    nc_clamp = pw.exp(3.0 * pw.log(lamc) + pw.log(qs_)
                      + pw.log(g1) - pw.log(g4)) * inv(cons26)
    nc_adj = torch.where(clamped, nc_clamp, ns_)
    return lamc, pgam, nc_adj


def _fallspeed_limits(rho):
    return _pow(_rd(RHOSU, rho), 0.54)


def _absorb(qx, qv, t, lheat, cond, cpm):
    """Trace water (< 1e-8) where ``cond`` returned to vapour with its
    latent heat: (qx, qv, t)."""
    take = cond & (qx < 1e-8)
    qv = qv + torch.where(take, qx, 0.0)
    t = t - torch.where(take, qx * lheat / cpm, 0.0)
    return torch.where(take, 0.0, qx), qv, t


def _zero_small(qx, nx):
    small = qx < QSMALL
    return torch.where(small, 0.0, qx), torch.where(small, 0.0, nx)


def _ratio(dum, qx):
    need = (dum > qx) & (qx >= QSMALL)
    return torch.where(need, _sd(qx, dum), 1.0), need


def _max0(x):
    return torch.clamp(x, min=0.0)


def _sq(x):
    """``x ** 2`` as jax.lax.integer_pow forms it."""
    return x * x


def mp_morrison(th, qv, qc, qi, qr, qs, qg, ni, ns, nr, ng, exner, p, dz,
                w, dt, rain_acc, snow_acc, graupel_acc, hail_opt: int = 0,
                qrcu=None, qscu=None, qicu=None):
    """One Morrison 2-moment step over the whole grid.

    All 3D fields (z, y, x) with level 0 at the surface; ``dz`` is the mass
    level thickness [m]; ``w`` (the grid-scale vertical velocity) is not
    read, as in the JAX package; ``dt`` a number or a 0-d tensor.
    ``rain_acc``/``snow_acc``/``graupel_acc`` are (y, x) accumulators [mm]
    (RAINNC/SNOWNC/GRAUPELNC): rain gets the total surface precipitation,
    snow the ice+snow part, graupel the graupel part.

    Returns (th, qv, qc, qi, qr, qs, qg, ni, ns, nr, ng, rain_acc,
    snow_acc, graupel_acc).
    """
    C = _CONSTS[int(hail_opt)]
    dt = _dt_tensor(dt, th)
    zero = torch.zeros_like(qv)

    t = th * exner
    if qrcu is None:
        qrcu = zero
    if qscu is None:
        qscu = zero
    if qicu is None:
        qicu = zero

    # ---- thermodynamics varying in time/height (":1305-1352") ----------
    xxlv = 3.1484e6 - 2370.0 * t
    xxls = 3.15e6 - 2370.0 * t + 0.3337e6
    cpm = CP * (1.0 + 0.887 * qv)
    xlf = xxls - xxlv

    def _sat(t_, qv_):
        evs = torch.minimum(0.99 * p, polysvp(t_, False))
        eis = torch.minimum(0.99 * p, polysvp(t_, True))
        eis = torch.minimum(eis, evs)
        qvs_ = EP_2 * evs / (p - evs)
        qvi_ = EP_2 * eis / (p - eis)
        return qvs_, qvi_, qv_ / qvs_, qv_ / qvi_

    qvs, qvi, qvqvs, qvqvsi = _sat(t, qv)
    rho = p / (R * t)
    rho3 = _ipow(rho, 3)

    # cumulus detrainment number sources (":1355-1370")
    add_r = qrcu >= 1e-10
    nr = nr + torch.where(add_r, _pow(
        _max0(qrcu) * dt / (PI * RHOW * rho3), 0.25) * 1.8e5, 0.0)
    add_s = qscu >= 1e-10
    ns = ns + torch.where(add_s, _pow(
        _max0(qscu) * dt / (C.CONS1 * rho3), 1.0 / (DS + 1.0)) * 3e5, 0.0)
    add_i = qicu >= 1e-10
    ni = ni + torch.where(add_i, _max0(qicu) * dt
                          * inv(CI_ * (80e-6) ** DI), 0.0)

    # sub-saturation cleanup of trace water (":1373-1400")
    liq_dry = qvqvs < 0.9
    ice_dry = qvqvsi < 0.9
    qr, qv, t = _absorb(qr, qv, t, xxlv, liq_dry, cpm)
    qc, qv, t = _absorb(qc, qv, t, xxlv, liq_dry, cpm)
    qi, qv, t = _absorb(qi, qv, t, xxls, ice_dry, cpm)
    qs, qv, t = _absorb(qs, qv, t, xxls, ice_dry, cpm)
    qg, qv, t = _absorb(qg, qv, t, xxls, ice_dry, cpm)

    # QSMALL zeroing (":1405-1430")
    nc = zero
    qc, nc = _zero_small(qc, nc)
    qr, nr = _zero_small(qr, nr)
    qi, ni = _zero_small(qi, ni)
    qs, ns = _zero_small(qs, ns)
    qg, ng = _zero_small(qg, ng)

    # air viscosity + density-corrected fallspeed prefactors (":1440-1460")
    mu = 1.496e-6 * _pow(t, 1.5) / (t + 120.0)
    dum54 = _fallspeed_limits(rho)
    ain = _pow(_rd(RHOSU, rho), 0.35) * AI
    arn = dum54 * AR
    asn = dum54 * AS_
    acn = _rd(G * RHOW, 18.0 * mu)  # Stokes droplets
    agn = dum54 * C.AG

    # per-level skip mask (GOTO 200, ":1468-1472")
    any_q = ((qc >= QSMALL) | (qi >= QSMALL) | (qs >= QSMALL)
             | (qr >= QSMALL) | (qg >= QSMALL))
    warm = t >= 273.15
    near_sat = torch.where(warm, qvqvs >= 0.999, qvqvsi >= 0.999)
    active = any_q | near_sat

    kap = 1.414e3 * mu
    dv = 8.794e-5 * _pow(t, 1.81) / p
    sc = mu / (rho * dv)
    dqsdt = xxlv * qvs / (RV * t * t)
    dqsidt = xxls * qvi / (RV * t * t)
    abi = 1.0 + dqsidt * xxls / cpm
    ab = 1.0 + dqsdt * xxlv / cpm

    # ---- branch-specific pre-mutations ---------------------------------
    warm_act = active & warm
    cold_act = active & ~warm

    # constant droplet number (INUM=1, ":1515-1518")
    nc = torch.where(active, _rd(NDCNST * 1e6, rho), nc)

    # warm: melt trace snow/graupel into rain (":1523-1537")
    def _melt_small(qx, nx, qr_, nr_, t_):
        melt = warm_act & (qx < 1e-6)
        qr_ = qr_ + torch.where(melt, qx, 0.0)
        nr_ = nr_ + torch.where(melt, nx, 0.0)
        t_ = t_ - torch.where(melt, qx * xlf / cpm, 0.0)
        return (torch.where(melt, 0.0, qx), torch.where(melt, 0.0, nx),
                qr_, nr_, t_)

    qs, ns, qr, nr, t = _melt_small(qs, ns, qr, nr, t)
    qg, ng, qr, nr, t = _melt_small(qg, ng, qr, nr, t)

    # warm GOTO 300: no condensed water at all (":1539")
    w_nowater = (qc < QSMALL) & (qs < 1e-8) & (qr < QSMALL) & (qg < 1e-8)
    warm_proc = warm_act & ~w_nowater

    ni = _max0(ni)
    ns = _max0(ns)
    nc = _max0(nc)
    nr = _max0(nr)
    ng = _max0(ng)

    # ---- PSD parameters (shared formulas, branch-gated N adjustment) ---
    lamr, n0rr, nr_adj = _psd(qr, nr, PI * RHOW, 3.0, LAMMINR, LAMMAXR)
    lams, n0s, ns_adj = _psd(qs, ns, C.CONS1, DS, LAMMINS, LAMMAXS)
    lamg, n0g, ng_adj = _psd(qg, ng, C.CONS2, DG, LAMMING, LAMMAXG)
    lami, n0i, ni_adj = _psd(qi, ni, C.CONS12, DI, LAMMINI, LAMMAXI)
    lamc, pgam, nc_adj = _psd_cloud(qc, nc, t, p, C.CONS26)

    psd_gate = warm_proc | cold_act
    nr = torch.where(psd_gate & (qr >= QSMALL), nr_adj, nr)
    ns = torch.where(psd_gate & (qs >= QSMALL), ns_adj, ns)
    ng = torch.where(psd_gate & (qg >= QSMALL), ng_adj, ng)
    nc = torch.where(psd_gate & (qc >= QSMALL), nc_adj, nc)
    ni = torch.where(cold_act & (qi >= QSMALL), ni_adj, ni)
    # lami stays 0 outside the cold branch (hm 4/7/09 fix, ":1462")
    lami_state = torch.where(cold_act & (qi >= QSMALL), lami, 0.0)
    cdist1 = _sd(nc, _gam(pgam + 1.0))

    # mass/number-weighted fall speeds with realistic caps (shared helper)
    def _vel_rs(lam_, a_, b_, cm, cn, cap):
        lb = _pow(lam_, b_)
        um = a_ * cm / lb
        un = a_ * cn / lb
        return torch.minimum(um, cap * dum54), torch.minimum(un, cap * dum54)

    # powers of the slopes the rates share (jax.lax.integer_pow's forms)
    lamr2, lamr3 = _sq(lamr), _ipow(lamr, 3)
    lams2, lams3 = _sq(lams), _ipow(lams, 3)
    lamg2, lamg3 = _sq(lamg), _ipow(lamg, 3)

    # ================= WARM branch (T >= 273.15, ":1509-2040") ==========
    # autoconversion KK2000 (":1642-1664"; identical in cold ":2392-2414")
    has_qc6 = qc >= 1e-6
    prc_all = torch.where(has_qc6,
                          1350.0 * _pow(torch.clamp(qc, min=1e-12), 2.47)
                          * _pow(torch.clamp(nc * inv(1e6) * rho, min=1e-12),
                                 -1.79), 0.0)
    nprc1_all = prc_all * inv(C.CONS29)
    nprc_all = torch.minimum(_sd(prc_all, _sd(qc, nc)), nc / dt)
    nprc1_all = torch.minimum(nprc1_all, nprc_all)

    # accretion of cloud by rain KK2000 (":1781-1796"; cold ":2706-2721")
    has_rc = (qr >= 1e-8) & (qc >= 1e-8)
    pra_all = torch.where(has_rc,
                          67.0 * _pow(torch.clamp(qc * qr, min=1e-30), 1.15),
                          0.0)
    npra_all = _sd(pra_all, _sd(qc, nc))

    # rain self-collection + breakup (":1798-1815"; cold ":2723-2737")
    has_r8 = qr >= 1e-8
    inv_lamr = _rd(1.0, lamr)
    brk = torch.where(inv_lamr < 300e-6, 1.0,
                      2.0 - pw.exp(torch.clamp(2300.0 * (inv_lamr - 300e-6),
                                               max=50.0)))
    nragg_all = torch.where(has_r8, -5.78 * brk * nr * qr * rho, 0.0)

    # rain evaporation (":1817-1838"; cold ":2953-2971")
    sc13 = _pow(sc, 1.0 / 3.0)
    epsr = torch.where(qr >= QSMALL,
                       2.0 * PI * n0rr * rho * dv
                       * (_rd(F1R, lamr2)
                          + F2R * torch.sqrt(arn * rho / mu)
                          * sc13 * C.CONS9 / _pow(lamr, C.CONS34)),
                       0.0)
    pre_all = torch.where(qv < qvs,
                          torch.clamp(epsr * (qv - qvs) / ab, max=0.0), 0.0)

    # --- warm-only: melting of snow / graupel (":1694-1775")
    ums_m, uns_m = _vel_rs(lams, asn, BS, C.CONS3, C.CONS5, 1.2)
    umr_m, unr_m = _vel_rs(lamr, arn, BR, C.CONS4, C.CONS6, 9.1)
    umg_m, ung_m = _vel_rs(lamg, agn, C.BG, C.CONS7, C.CONS8, 20.0)

    # the rain-snow and rain-graupel collection kernels the warm and the
    # cold branch share
    rs_speed = torch.sqrt(_sq(1.2 * umr_m - 0.95 * ums_m)
                          + 0.08 * ums_m * umr_m)
    rs_moments = (_rd(5.0, lamr3 * lams) + _rd(2.0, lamr2 * lams2)
                  + _rd(0.5, lamr * lams3))
    rg_speed = torch.sqrt(_sq(1.2 * umr_m - 0.95 * umg_m)
                          + 0.08 * umg_m * umr_m)
    rg_moments = (_rd(5.0, lamr3 * lamg) + _rd(2.0, lamr2 * lamg2)
                  + _rd(0.5, lamr * lamg3))

    has_rs = (qr >= 1e-8) & (qs >= 1e-8)
    pracs_raw = C.CONS41 * (rs_speed * rho * n0rr * n0s / lamr3
                            * rs_moments)
    pracs_m = torch.where(has_rs, pracs_raw, 0.0)

    has_rg = (qr >= 1e-8) & (qg >= 1e-8)
    pracg_raw = C.CONS41 * (rg_speed * rho * n0rr * n0g / lamr3
                            * rg_moments)
    pracg_m = torch.where(has_rg, pracg_raw, 0.0)
    # shed 1mm drops (":1752-1768")
    rg_number = (C.CONS32 * rho * torch.sqrt(
        1.7 * _sq(unr_m - ung_m) + 0.3 * unr_m * ung_m)
        * n0rr * n0g * (_rd(1.0, lamr3 * lamg) + _rd(1.0, lamr2 * lamg2)
                        + _rd(1.0, lamr * lamg3)))
    npracg_w = torch.where(has_rg, rg_number - pracg_m * inv(5.2e-7), 0.0)

    # snow melting (Rutledge & Hobbs; accelerated by rain collisions)
    has_s8 = qs >= 1e-8
    vent_s = (_rd(F1S, lams2) + F2S * torch.sqrt(asn * rho / mu)
              * sc13 * C.CONS10 / _pow(lams, C.CONS35))
    psmlt = torch.where(has_s8,
                        2.0 * PI * n0s * kap * (273.15 - t) / xlf * vent_s
                        - _rd(CPW, xlf) * (t - 273.15) * pracs_m, 0.0)
    epss_m = 2.0 * PI * n0s * rho * dv * vent_s
    evpms = torch.where(has_s8 & (qvqvs < 1.0),
                        torch.maximum((qv - qvs) * epss_m / ab, psmlt), 0.0)
    psmlt = psmlt - evpms

    has_g8 = qg >= 1e-8
    vent_g = (_rd(F1S, lamg2) + F2S * torch.sqrt(agn * rho / mu)
              * sc13 * C.CONS11 / _pow(lamg, C.CONS36))
    pgmlt = torch.where(has_g8,
                        2.0 * PI * n0g * kap * (273.15 - t) / xlf * vent_g
                        - _rd(CPW, xlf) * (t - 273.15) * pracg_m, 0.0)
    epsg_m = 2.0 * PI * n0g * rho * dv * vent_g
    evpmg = torch.where(has_g8 & (qvqvs < 1.0),
                        torch.maximum((qv - qvs) * epsg_m / ab, pgmlt), 0.0)
    pgmlt = pgmlt - evpmg
    # PRACS/PRACG reset to 0 after enhancing melting (":1871-1876")

    # warm conservation (":1884-1951")
    rt, _ = _ratio((prc_all + pra_all) * dt, qc)
    prc_w, pra_w = prc_all * rt, pra_all * rt
    rt, _ = _ratio((-psmlt - evpms) * dt, qs)
    psmlt_w, evpms_w = psmlt * rt, evpms * rt
    rt, _ = _ratio((-pgmlt - evpmg) * dt, qg)
    pgmlt_w, evpmg_w = pgmlt * rt, evpmg * rt
    dum_r = (-pre_all - pra_w - prc_w + psmlt_w + pgmlt_w) * dt
    need = (dum_r > qr) & (qr >= QSMALL)
    rt = torch.where(need, _sd(qr / dt + pra_w + prc_w - psmlt_w - pgmlt_w,
                               -pre_all), 1.0)
    pre_w = pre_all * rt

    # warm number melt/evap adjustments (":1977-2008")
    nsubr_w = torch.where(pre_w < 0.0,
                          torch.clamp(_sd(pre_w * dt, qr), min=-1.0) * nr
                          / dt, 0.0)
    nsmlts = torch.where(evpms_w + psmlt_w < 0.0,
                         torch.clamp(_sd((evpms_w + psmlt_w) * dt, qs),
                                     min=-1.0) * ns / dt, 0.0)
    nsmltr = torch.where(psmlt_w < 0.0,
                         torch.clamp(_sd(psmlt_w * dt, qs), min=-1.0) * ns
                         / dt, 0.0)
    ngmltg = torch.where(evpmg_w + pgmlt_w < 0.0,
                         torch.clamp(_sd((evpmg_w + pgmlt_w) * dt, qg),
                                     min=-1.0) * ng / dt, 0.0)
    ngmltr = torch.where(pgmlt_w < 0.0,
                         torch.clamp(_sd(pgmlt_w * dt, qg), min=-1.0) * ng
                         / dt, 0.0)

    warm_ten = dict(
        qv=-pre_w - evpms_w - evpmg_w,
        t=(pre_w * xxlv + (evpms_w + evpmg_w) * xxls
           + (psmlt_w + pgmlt_w) * xlf) / cpm,
        qc=-pra_w - prc_w,
        qr=pre_w + pra_w + prc_w - psmlt_w - pgmlt_w,
        qi=zero,
        qs=psmlt_w + evpms_w,
        qg=pgmlt_w + evpmg_w,
        nc=-npra_all - nprc_all,
        ni=zero,
        ns=nsmlts,
        nr=nprc1_all + nragg_all - npracg_w + nsubr_w - nsmltr - ngmltr,
        ng=ngmltg,
    )

    # ================= COLD branch (T < 273.15, ":2121-3305") ===========
    # contact + immersion freezing of droplets (":2327-2386")
    frz_c = (qc >= QSMALL) & (t < 269.15)
    nacnt = pw.exp(-2.80 + 0.262 * (273.15 - t)) * 1000.0
    mfp = 7.37 * t / (288.0 * 10.0 * p) * inv(100.0)
    dap = C.CONS37 * t * (1.0 + mfp * inv(RIN)) / mu
    log_cdist1 = pw.log(torch.clamp(cdist1, min=1e-35))
    log_lamc = pw.log(lamc)
    mnucc_contact = (C.CONS38 * dap * nacnt
                     * pw.exp(log_cdist1 + torch.lgamma(pgam + 5.0)
                              - 4.0 * log_lamc))
    nnucc_contact = (2.0 * PI * dap * nacnt * cdist1
                     * _gam(pgam + 2.0) / lamc)
    eimm = pw.exp(torch.clamp(AIMM * (273.15 - t), max=50.0)) - 1.0
    mnucc_imm = (C.CONS39
                 * pw.exp(log_cdist1 + torch.lgamma(7.0 + pgam)
                          - 6.0 * log_lamc) * eimm)
    nnucc_imm = (C.CONS40
                 * pw.exp(log_cdist1 + torch.lgamma(pgam + 4.0)
                          - 3.0 * log_lamc) * eimm)
    mnuccc = torch.where(frz_c, mnucc_contact + mnucc_imm, 0.0)
    nnuccc = torch.where(frz_c,
                         torch.minimum(nnucc_contact + nnucc_imm, nc / dt),
                         0.0)

    # snow aggregation (":2417-2425")
    nsagg = torch.where(qs >= 1e-8,
                        C.CONS15 * asn * _pow(rho, (2.0 + BS) / 3.0)
                        * _pow(torch.clamp(qs, min=1e-12), (2.0 + BS) / 3.0)
                        * _pow(torch.clamp(ns, min=1e-12) * rho,
                               (4.0 - BS) / 3.0)
                        / rho, 0.0)

    # droplet accretion by snow / graupel / ice (":2427-2480")
    lams_b3 = _pow(lams, BS + 3.0)
    has_sc = (qs >= 1e-8) & (qc >= QSMALL)
    psacws = torch.where(has_sc,
                         C.CONS13 * asn * qc * rho * n0s / lams_b3, 0.0)
    npsacws = torch.where(has_sc,
                          C.CONS13 * asn * nc * rho * n0s / lams_b3, 0.0)
    lamg_b3 = _pow(lamg, C.BG + 3.0)
    has_gc = (qg >= 1e-8) & (qc >= QSMALL)
    psacwg = torch.where(has_gc,
                         C.CONS14 * agn * qc * rho * n0g / lamg_b3, 0.0)
    npsacwg = torch.where(has_gc,
                          C.CONS14 * agn * nc * rho * n0g / lamg_b3, 0.0)
    lami_b3 = _pow(lami, BI + 3.0)
    has_ic = (qi >= 1e-8) & (qc >= QSMALL) & (_rd(1.0, lami) >= 100e-6)
    psacwi = torch.where(has_ic,
                         C.CONS16 * ain * qc * rho * n0i / lami_b3, 0.0)
    npsacwi = torch.where(has_ic,
                          C.CONS16 * ain * nc * rho * n0i / lami_b3, 0.0)

    # rain-snow collection (":2482-2540")
    pracs = torch.where(has_rs, torch.minimum(pracs_raw, qr / dt), 0.0)
    rs_number = (C.CONS32 * rho * torch.sqrt(
        1.7 * _sq(unr_m - uns_m) + 0.3 * unr_m * uns_m)
        * n0rr * n0s * (_rd(1.0, lamr3 * lams) + _rd(1.0, lamr2 * lams2)
                        + _rd(1.0, lamr * lams3)))
    npracs = torch.where(has_rs, rs_number, 0.0)
    # snow collected by rain, for graupel conversion (":2524-2537")
    psacr = torch.where(has_rs & (qs >= 0.1e-3) & (qr >= 0.1e-3),
                        C.CONS31 * (rs_speed * rho * n0rr * n0s / lams3
                                    * (_rd(5.0, lams3 * lamr)
                                       + _rd(2.0, lams2 * lamr2)
                                       + _rd(0.5, lams * lamr3))), 0.0)

    # rain-graupel collection (":2542-2580")
    pracg = torch.where(has_rg, torch.minimum(pracg_raw, qr / dt), 0.0)
    npracg_c = torch.where(has_rg, rg_number, 0.0)

    # Hallett-Mossop rime splintering: snow (":2582-2640")
    fmult = torch.clamp(torch.where(t > 268.16, (270.16 - t) * inv(2.0),
                                    (t - 265.16) * inv(3.0)), 0.0, 1.0)
    fmult = torch.where((t < 270.16) & (t > 265.16), fmult, 0.0)
    hm_gate_s = ((qs >= 0.1e-3) & ((qc >= 0.5e-3) | (qr >= 0.1e-3))
                 & (t < 270.16) & (t > 265.16))
    can_s = hm_gate_s & (psacws > 0.0)
    qmults = torch.where(can_s,
                         torch.minimum(35e4 * psacws * fmult * 1000.0
                                       * MMULT, psacws), 0.0)
    nmults = torch.where(can_s, 35e4 * psacws * fmult * 1000.0, 0.0)
    psacws = psacws - qmults
    can_sr = hm_gate_s & (pracs > 0.0)
    qmultr = torch.where(can_sr,
                         torch.minimum(35e4 * pracs * fmult * 1000.0 * MMULT,
                                       pracs), 0.0)
    nmultr = torch.where(can_sr, 35e4 * pracs * fmult * 1000.0, 0.0)
    pracs = pracs - qmultr

    # rime splintering: graupel (":2642-2700")
    hm_gate_g = ((qg >= 0.1e-3) & ((qc >= 0.5e-3) | (qr >= 0.1e-3))
                 & (t < 270.16) & (t > 265.16))
    can_g = hm_gate_g & (psacwg > 0.0)
    qmultg = torch.where(can_g,
                         torch.minimum(35e4 * psacwg * fmult * 1000.0
                                       * MMULT, psacwg), 0.0)
    nmultg = torch.where(can_g, 35e4 * psacwg * fmult * 1000.0, 0.0)
    psacwg = psacwg - qmultg
    can_gr = hm_gate_g & (pracg > 0.0)
    qmultrg = torch.where(can_gr,
                          torch.minimum(35e4 * pracg * fmult * 1000.0
                                        * MMULT, pracg), 0.0)
    nmultrg = torch.where(can_gr, 35e4 * pracg * fmult * 1000.0, 0.0)
    pracg = pracg - qmultrg

    # graupel conversion from rimed snow (":2703-2750")
    conv_w = (psacws > 0.0) & (qs >= 0.1e-3) & (qc >= 0.5e-3)
    pgsacw = torch.where(conv_w,
                         torch.minimum(psacws,
                                       C.CONS17 * dt * n0s * qc * qc * asn
                                       * asn / (rho * _pow(
                                           lams, 2.0 * BS + 2.0))), 0.0)
    nscng = torch.where(conv_w,
                        torch.minimum(_max0(RHOSN / (C.RHOG - RHOSN)
                                            * pgsacw) * inv(MG0) * rho,
                                      ns / dt), 0.0)
    psacws = psacws - pgsacw

    conv_r = (pracs > 0.0) & (qs >= 0.1e-3) & (qr >= 0.1e-3)
    ls4 = _ipow(_rd(4.0, lams), 3)
    lr4 = _ipow(_rd(4.0, lamr), 3)
    frac_s = torch.clamp(_sd(C.CONS18 * ls4 * ls4,
                             C.CONS18 * ls4 * ls4 + C.CONS19 * lr4 * lr4),
                         0.0, 1.0)
    pgracs = torch.where(conv_r, (1.0 - frac_s) * pracs, 0.0)
    ngracs = torch.where(conv_r,
                         torch.minimum(torch.minimum((1.0 - frac_s) * npracs,
                                                     nr / dt), ns / dt), 0.0)
    pracs = torch.where(conv_r, pracs - pgracs, pracs)
    npracs = torch.where(conv_r, npracs - ngracs, npracs)
    psacr = torch.where(conv_r, psacr * (1.0 - frac_s), psacr)

    # immersion freezing of rain (":2752-2774")
    frz_r = (t < 269.15) & (qr >= QSMALL)
    mnuccr = torch.where(frz_r, C.CONS20 * nr * eimm / _ipow(lamr, 6), 0.0)
    nnuccr = torch.where(frz_r,
                         torch.minimum(PI * nr * BIMM * eimm / lamr3,
                                       nr / dt), 0.0)

    # ice autoconversion to snow (":2739-2757" Harrington)
    auto_i = (qi >= 1e-8) & (qvqvsi >= 1.0)
    nprci = torch.where(auto_i,
                        C.CONS21 * (qv - qvi) * rho * n0i
                        * pw.exp(-lami * DCS) * dv / abi, 0.0)
    prci = C.CONS22 * nprci
    nprci = torch.minimum(nprci, ni / dt)

    # ice accretion by snow (":2759-2771")
    acc_is = (qs >= 1e-8) & (qi >= QSMALL)
    prai = torch.where(acc_is,
                       C.CONS23 * asn * qi * rho * n0s / lams_b3, 0.0)
    nprai = torch.where(acc_is,
                        torch.minimum(C.CONS23 * asn * ni * rho * n0s
                                      / lams_b3, ni / dt), 0.0)

    # rain-ice collisions (":2773-2805")
    ri = (qr >= 1e-8) & (qi >= 1e-8) & (t <= 273.15)
    ri_g = ri & (qr >= 0.1e-3)
    ri_s = ri & ~ri_g
    lamr_b3 = _pow(lamr, BR + 3.0)
    niacr_raw = C.CONS24 * ni * n0rr * arn / lamr_b3 * rho
    piacr_raw = C.CONS25 * ni * n0rr * arn / lamr_b3 / lamr3 * rho
    praci_raw = C.CONS24 * qi * n0rr * arn / lamr_b3 * rho
    ncap = torch.minimum(torch.minimum(niacr_raw, nr / dt), ni / dt)
    niacr = torch.where(ri_g, ncap, 0.0)
    piacr = torch.where(ri_g, piacr_raw, 0.0)
    praci = torch.where(ri_g, praci_raw, 0.0)
    niacrs = torch.where(ri_s, ncap, 0.0)
    piacrs = torch.where(ri_s, piacr_raw, 0.0)
    pracis = torch.where(ri_s, praci_raw, 0.0)

    # primary ice nucleation, INUC=0 Cooper curve (":2807-2841")
    nuc = ((qvqvs >= 0.999) & (t <= 265.15)) | (qvqvsi >= 1.08)
    kc2 = 0.005 * pw.exp(torch.clamp(0.304 * (273.15 - t), max=50.0)) \
        * 1000.0
    kc2 = _max0(torch.clamp(kc2, max=500e3) / rho)
    can_nuc = nuc & (kc2 > ni + ns + ng)
    nnuccd = torch.where(can_nuc, (kc2 - ni - ns - ng) / dt, 0.0)
    mnuccd = nnuccd * MI0

    # deposition/sublimation (":2850-2962")
    epsi = torch.where(qi >= QSMALL,
                       2.0 * PI * n0i * rho * dv / (lami * lami), 0.0)
    epss = torch.where(qs >= QSMALL, 2.0 * PI * n0s * rho * dv * vent_s,
                       0.0)
    epsg = torch.where(qg >= QSMALL, 2.0 * PI * n0g * rho * dv * vent_g,
                       0.0)
    tail = torch.where(qi >= QSMALL,
                       1.0 - pw.exp(-lami * DCS) * (1.0 + lami * DCS), 0.0)
    dep_fac = (qv - qvi) / abi
    prd = torch.where(qi >= QSMALL, epsi * dep_fac * tail, 0.0)
    has_snow = qs >= QSMALL
    prds = torch.where(has_snow,
                       epss * dep_fac + epsi * dep_fac * (1.0 - tail), 0.0)
    prd = torch.where(has_snow | (qi < QSMALL), prd,
                      prd + epsi * dep_fac * (1.0 - tail))
    prdg = epsg * dep_fac
    pre_c = pre_all  # same evaporation formula as the warm branch

    # Reisner-2 anti-overshoot (":2975-3005")
    dum_vi = (qv - qvi) / dt
    sum_dep = prd + prds + mnuccd + prdg
    fudge = 0.9999
    over = (((dum_vi > 0.0) & (sum_dep > dum_vi * fudge))
            | ((dum_vi < 0.0) & (sum_dep < dum_vi * fudge)))
    scale_dep = torch.where(over, fudge * _sd(dum_vi, sum_dep), 1.0)
    prd, prds = prd * scale_dep, prds * scale_dep
    prdg, mnuccd = prdg * scale_dep, mnuccd * scale_dep
    eprd = torch.clamp(prd, max=0.0)
    prd = _max0(prd)
    eprds = torch.clamp(prds, max=0.0)
    prds = _max0(prds)
    eprdg = torch.clamp(prdg, max=0.0)
    prdg = _max0(prdg)

    # cold conservation (":3080-3200")
    rt, _ = _ratio((prc_all + pra_all + mnuccc + psacws + psacwi + qmults
                    + psacwg + pgsacw + qmultg) * dt, qc)
    prc_c, pra_c = prc_all * rt, pra_all * rt
    mnuccc, psacws, psacwi = mnuccc * rt, psacws * rt, psacwi * rt
    qmults, qmultg = qmults * rt, qmultg * rt
    psacwg, pgsacw = psacwg * rt, pgsacw * rt

    dum_i = (-prd - mnuccc + prci + prai - qmults - qmultg - qmultr
             - qmultrg - mnuccd + praci + pracis - eprd - psacwi) * dt
    need = (dum_i > qi) & (qi >= QSMALL)
    rt = torch.where(need, _sd(qi / dt + prd + mnuccc + qmults + qmultg
                               + qmultr + qmultrg + mnuccd + psacwi,
                               prci + prai + praci + pracis - eprd), 1.0)
    prci, prai = prci * rt, prai * rt
    praci, pracis, eprd = praci * rt, pracis * rt, eprd * rt

    dum_r2 = ((pracs - pre_c) + (qmultr + qmultrg - prc_c)
              + (mnuccr - pra_c) + piacr + piacrs + pgracs + pracg) * dt
    need = (dum_r2 > qr) & (qr >= QSMALL)
    rt = torch.where(need, _sd(qr / dt + prc_c + pra_c,
                               -pre_c + qmultr + qmultrg + pracs + mnuccr
                               + piacr + piacrs + pgracs + pracg), 1.0)
    pre_c, pracs = pre_c * rt, pracs * rt
    qmultr, qmultrg = qmultr * rt, qmultrg * rt
    mnuccr, piacr, piacrs = mnuccr * rt, piacr * rt, piacrs * rt
    pgracs, pracg = pgracs * rt, pracg * rt

    dum_s = (-prds - psacws - prai - prci - pracs - eprds + psacr - piacrs
             - pracis) * dt
    need = (dum_s > qs) & (qs >= QSMALL)
    rt = torch.where(need, _sd(qs / dt + prds + psacws + prai + prci + pracs
                               + piacrs + pracis, -eprds + psacr), 1.0)
    eprds, psacr = eprds * rt, psacr * rt

    dum_g = (-psacwg - pracg - pgsacw - pgracs - prdg - mnuccr - eprdg
             - piacr - praci - psacr) * dt
    need = (dum_g > qg) & (qg >= QSMALL)
    rt = torch.where(need, _sd(qg / dt + psacwg + pracg + pgsacw + pgracs
                               + prdg + mnuccr + psacr + piacr + praci,
                               -eprdg), 1.0)
    eprdg = eprdg * rt

    cold_qv = (-pre_c - prd - prds - mnuccd - eprd - eprds - prdg - eprdg)
    cold_t = (pre_c * xxlv
              + (prd + prds + mnuccd + eprd + eprds + prdg + eprdg) * xxls
              + (psacws + psacwi + mnuccc + mnuccr + qmults + qmultg
                 + qmultr + qmultrg + pracs + psacwg + pracg + pgsacw
                 + pgracs + piacr + piacrs) * xlf) / cpm
    cold_qc = (-pra_c - prc_c - mnuccc - psacws - psacwi - qmults - qmultg
               - psacwg - pgsacw)
    cold_qi = (prd + eprd + psacwi + mnuccc - prci - prai + qmults + qmultg
               + qmultr + qmultrg + mnuccd - praci - pracis)
    cold_qr = (pre_c + pra_c + prc_c - pracs - mnuccr - qmultr - qmultrg
               - piacr - piacrs - pracg - pgracs)
    cold_qs = (prai + psacws + prds + pracs + prci + eprds - psacr + piacrs
               + pracis)
    cold_ns = nsagg + nprci - nscng - ngracs + niacrs
    cold_qg = (pracg + psacwg + pgsacw + pgracs + prdg + eprdg + mnuccr
               + piacr + praci + psacr)
    cold_ng = nscng + ngracs + nnuccr + niacr
    cold_nc = (-nnuccc - npsacws - npra_all - nprc_all - npsacwi - npsacwg)
    cold_ni = (nnuccc - nprci - nprai + nmults + nmultg + nmultr + nmultrg
               + nnuccd - niacr - niacrs)
    cold_nr = (nprc1_all - npracs - nnuccr + nragg_all - niacr - niacrs
               - npracg_c - ngracs)

    # number sublimation/evaporation adjustments (":3290-3330")
    nsubi = torch.where(eprd < 0.0,
                        torch.clamp(_sd(eprd * dt, qi), min=-1.0) * ni / dt,
                        0.0)
    nsubs = torch.where(eprds < 0.0,
                        torch.clamp(_sd(eprds * dt, qs), min=-1.0) * ns
                        / dt, 0.0)
    nsubr_c = torch.where(pre_c < 0.0,
                          torch.clamp(_sd(pre_c * dt, qr), min=-1.0) * nr
                          / dt, 0.0)
    nsubg = torch.where(eprdg < 0.0,
                        torch.clamp(_sd(eprdg * dt, qg), min=-1.0) * ng
                        / dt, 0.0)
    cold_ni = cold_ni + nsubi
    cold_ns = cold_ns + nsubs
    cold_nr = cold_nr + nsubr_c
    cold_ng = cold_ng + nsubg

    cold_ten = dict(qv=cold_qv, t=cold_t, qc=cold_qc, qi=cold_qi,
                    qr=cold_qr, qs=cold_qs, qg=cold_qg, nc=cold_nc,
                    ni=cold_ni, ns=cold_ns, nr=cold_nr, ng=cold_ng)

    # ---- blend branches, gate by skip masks -----------------------------
    ten = {}
    for key in warm_ten:
        wv = torch.where(w_nowater, 0.0, warm_ten[key])
        ten[key] = torch.where(active,
                               torch.where(warm, wv, cold_ten[key]), 0.0)

    # ---- liquid saturation adjustment (both branches, ":2013-2031") ----
    dumt = t + dt * ten["t"]
    dumqv = qv + dt * ten["qv"]
    es_d = torch.minimum(0.99 * p, polysvp(dumt, False))
    dumqss = EP_2 * es_d / (p - es_d)
    dumqc = _max0(qc + dt * ten["qc"])
    pcc = ((dumqv - dumqss)
           / (1.0 + xxlv * xxlv * dumqss / (cpm * RV * dumt * dumt)) / dt)
    pcc = torch.maximum(pcc, -dumqc / dt)
    pcc = torch.where(active, pcc, 0.0)
    ten["qv"] = ten["qv"] - pcc
    ten["t"] = ten["t"] + pcc * xxlv / cpm
    ten["qc"] = ten["qc"] + pcc

    # ================= sedimentation (":3341-3584") ======================
    dums = {
        "qr": qr + ten["qr"] * dt, "qi": qi + ten["qi"] * dt,
        "qs": qs + ten["qs"] * dt, "qc": qc + ten["qc"] * dt,
        "qg": qg + ten["qg"] * dt,
        "ni": _max0(ni + ten["ni"] * dt),
        "ns": _max0(ns + ten["ns"] * dt),
        "nr": _max0(nr + ten["nr"] * dt),
        "ng": _max0(ng + ten["ng"] * dt),
        "nc": _max0(nc),  # iinum=1 (":3380-3383")
    }

    def _dlam(q_, n_, coef, d, lmin, lmax):
        qs_ = torch.clamp(q_, min=QSMALL)
        return torch.clamp(_pow(coef * _max0(n_) / qs_, 1.0 / d),
                           lmin, lmax)

    dlami = _dlam(dums["qi"], dums["ni"], C.CONS12, DI, LAMMINI, LAMMAXI)
    dlamr = _dlam(dums["qr"], dums["nr"], PI * RHOW, 3.0, LAMMINR, LAMMAXR)
    dlams = _dlam(dums["qs"], dums["ns"], C.CONS1, DS, LAMMINS, LAMMAXS)
    dlamg = _dlam(dums["qg"], dums["ng"], C.CONS2, DG, LAMMING, LAMMAXG)
    # droplets: pgam from the pre-tendency nc (":3395-3407")
    dqc = torch.clamp(dums["qc"], min=QSMALL)
    pg_d = torch.clamp(_rd(1.0, _sq(0.0005714 * (_max0(nc) * inv(1e6)
                                                 * (p / (287.15 * t)))
                                    + 0.2714)) - 1.0, 2.0, 10.0)
    g_pg4 = _gam(pg_d + 4.0)
    g_pg1 = _gam(pg_d + 1.0)
    dlamc = _clip(_pow(C.CONS26 * torch.clamp(dums["nc"], min=1e-6) * g_pg4
                       / (dqc * g_pg1), 1.0 / 3.0),
                  (pg_d + 1.0) * inv(60e-6), (pg_d + 1.0) * inv(1e-6))

    def _vpair(cond, um, un):
        return (torch.where(cond, um, 0.0), torch.where(cond, un, 0.0))

    has = {k: dums[k] >= QSMALL for k in ("qc", "qi", "qr", "qs", "qg")}
    dlamc_b = _pow(dlamc, BC)
    umc, unc = _vpair(has["qc"],
                      acn * _gam(4.0 + BC + pg_d) / (dlamc_b * g_pg4),
                      acn * _gam(1.0 + BC + pg_d) / (dlamc_b * g_pg1))
    dlami_b = _pow(dlami, BI)
    umi, uni = _vpair(has["qi"], ain * C.CONS28 / dlami_b,
                      ain * C.CONS27 / dlami_b)
    dlamr_b = _pow(dlamr, BR)
    umr, unr = _vpair(has["qr"], arn * C.CONS4 / dlamr_b,
                      arn * C.CONS6 / dlamr_b)
    dlams_b = _pow(dlams, BS)
    ums, uns = _vpair(has["qs"], asn * C.CONS3 / dlams_b,
                      asn * C.CONS5 / dlams_b)
    dlamg_b = _pow(dlamg, C.BG)
    umg, ung = _vpair(has["qg"], agn * C.CONS7 / dlamg_b,
                      agn * C.CONS8 / dlamg_b)
    # realistic caps (":3500-3512")
    cap35 = 1.2 * _pow(_rd(RHOSU, rho), 0.35)
    ums, uns = (torch.minimum(ums, 1.2 * dum54),
                torch.minimum(uns, 1.2 * dum54))
    umi, uni = torch.minimum(umi, cap35), torch.minimum(uni, cap35)
    umr, unr = (torch.minimum(umr, 9.1 * dum54),
                torch.minimum(unr, 9.1 * dum54))
    umg, ung = (torch.minimum(umg, 20.0 * dum54),
                torch.minimum(ung, 20.0 * dum54))

    # fallspeed below the lowest precip level: downward propagation
    # (":3516-3547") -- F(k) = F(k+1) when F(k) < 1e-10, cascading
    # top-down, one level at a time over the stacked species
    fstack = torch.stack([umr, umi, uni, ums, uns, unr, umc, unc, umg, ung])
    nz = fstack.shape[1]
    for k in range(nz - 2, -1, -1):
        fk = fstack[:, k]
        fstack[:, k] = torch.where(fk < 1e-10, fstack[:, k + 1], fk)

    # per-column substep count NSTEP = max_k INT(v dt/dz + 1) (":3550-3553")
    rgvm = torch.amax(fstack, dim=0)
    nstep = torch.amax((rgvm * dt / dz + 1.0).to(torch.int32), dim=0)
    nstep = torch.clamp(nstep, min=1)              # (ny, nx)
    nstep_f = nstep.to(torch.float32)
    nmax = int(torch.amax(nstep).item())           # the one host read

    # multiply dummies by rho (":3556-3566"), in the order of fstack
    order = ("qr", "qi", "ni", "qs", "ns", "nr", "qc", "nc", "qg", "ng")
    dum_rho = torch.stack([dums[k] * rho for k in order])
    ix = {k: i for i, k in enumerate(order)}
    sten = torch.zeros_like(dum_rho)
    precrt = torch.zeros(qv.shape[1:], dtype=qv.dtype, device=qv.device)
    snowprt = torch.zeros_like(precrt)
    grplprt = torch.zeros_like(precrt)
    top = torch.zeros_like(dum_rho[:, :1])
    for n in range(nmax):
        act = (nstep > n).to(torch.float32)       # (ny, nx)
        falout = fstack * dum_rho
        fal_above = torch.cat([falout[:, 1:], top], dim=1)
        faltnd = (fal_above - falout) / dz
        sten = sten + act * faltnd / nstep_f / rho
        dum_rho = dum_rho + act * faltnd * dt / nstep_f
        bot = falout[:, 0]
        precrt = precrt + act * (bot[ix["qr"]] + bot[ix["qc"]]
                                 + bot[ix["qs"]] + bot[ix["qi"]]
                                 + bot[ix["qg"]]) * dt / nstep_f
        snowprt = snowprt + act * (bot[ix["qi"]] + bot[ix["qs"]]) \
            * dt / nstep_f
        grplprt = grplprt + act * bot[ix["qg"]] * dt / nstep_f

    for k in ("qr", "qi", "qs", "qc", "qg"):
        ten[k] = ten[k] + sten[ix[k]]
    for k in ("ni", "ns", "nr", "ng"):
        ten[k] = ten[k] + sten[ix[k]]

    # ================= final section (":3589-4040") ======================
    # migrate over-sized cloud ice into snow (":3596-3607")
    big_ice = ((qi >= QSMALL) & (t < 273.15) & (lami_state >= 1e-10)
               & (_rd(1.0, torch.clamp(lami_state, min=1e-10)) >= 2.0 * DCS))
    ten["qs"] = ten["qs"] + torch.where(big_ice, qi / dt + ten["qi"], 0.0)
    ten["ns"] = ten["ns"] + torch.where(big_ice, ni / dt + ten["ni"], 0.0)
    ten["qi"] = torch.where(big_ice, -qi / dt, ten["qi"])
    ten["ni"] = torch.where(big_ice, -ni / dt, ten["ni"])

    # apply tendencies (":3612-3630")
    qc = qc + ten["qc"] * dt
    qi = qi + ten["qi"] * dt
    qs = qs + ten["qs"] * dt
    qr = qr + ten["qr"] * dt
    ni = ni + ten["ni"] * dt
    ns = ns + ten["ns"] * dt
    nr = nr + ten["nr"] * dt
    qg = qg + ten["qg"] * dt
    ng = ng + ten["ng"] * dt
    t = t + ten["t"] * dt
    qv = qv + ten["qv"] * dt

    # refresh saturation, absorb trace water again (":3700-3750")
    qvs, qvi, qvqvs, qvqvsi = _sat(t, qv)
    liq_dry = qvqvs < 0.9
    ice_dry = qvqvsi < 0.9
    qr, qv, t = _absorb(qr, qv, t, xxlv, liq_dry, cpm)
    qc, qv, t = _absorb(qc, qv, t, xxlv, liq_dry, cpm)
    qi, qv, t = _absorb(qi, qv, t, xxls, ice_dry, cpm)
    qs, qv, t = _absorb(qs, qv, t, xxls, ice_dry, cpm)
    qg, qv, t = _absorb(qg, qv, t, xxls, ice_dry, cpm)

    qc, nc = _zero_small(qc, nc)
    qr, nr = _zero_small(qr, nr)
    qi, ni = _zero_small(qi, ni)
    qs, ns = _zero_small(qs, ns)
    qg, ng = _zero_small(qg, ng)

    # instantaneous melting of cloud ice (":3790-3800")
    melt_i = (qi >= QSMALL) & (t >= 273.15)
    qr = qr + torch.where(melt_i, qi, 0.0)
    t = t - torch.where(melt_i, qi * xlf / cpm, 0.0)
    nr = nr + torch.where(melt_i, ni, 0.0)
    qi = torch.where(melt_i, 0.0, qi)
    ni = torch.where(melt_i, 0.0, ni)

    # homogeneous freezing (":3805-3835")
    frz_qc = (t <= 233.15) & (qc >= QSMALL)
    qi = qi + torch.where(frz_qc, qc, 0.0)
    t = t + torch.where(frz_qc, qc * xlf / cpm, 0.0)
    ni = ni + torch.where(frz_qc, nc, 0.0)
    qc = torch.where(frz_qc, 0.0, qc)

    frz_qr = (t <= 233.15) & (qr >= QSMALL)
    qg = qg + torch.where(frz_qr, qr, 0.0)
    t = t + torch.where(frz_qr, qr * xlf / cpm, 0.0)
    ng = ng + torch.where(frz_qr, nr, 0.0)
    qr = torch.where(frz_qr, 0.0, qr)
    nr = torch.where(frz_qr, 0.0, nr)

    ni = _max0(ni)
    ns = _max0(ns)
    nr = _max0(nr)
    ng = _max0(ng)

    # final PSD lambda clamping, adjusting N (":3845-3990")
    _, _, ni_f = _psd(qi, ni, C.CONS12, DI, LAMMINI, LAMMAXI)
    _, _, nr_f = _psd(qr, nr, PI * RHOW, 3.0, LAMMINR, LAMMAXR)
    _, _, ns_f = _psd(qs, ns, C.CONS1, DS, LAMMINS, LAMMAXS)
    _, _, ng_f = _psd(qg, ng, C.CONS2, DG, LAMMING, LAMMAXG)
    ni = torch.where(qi >= QSMALL, ni_f, ni)
    nr = torch.where(qr >= QSMALL, nr_f, nr)
    ns = torch.where(qs >= QSMALL, ns_f, ns)
    ng = torch.where(qg >= QSMALL, ng_f, ng)

    # anvil-cirrus ice number cap (":4010-4016")
    ni = torch.minimum(ni, _rd(0.3e6, rho))

    th_out = t / exner

    # accumulate precipitation [mm] (":871-878")
    rain_acc = rain_acc + precrt
    snow_acc = snow_acc + snowprt
    graupel_acc = graupel_acc + grplprt

    return (th_out, qv, qc, qi, qr, qs, qg, ni, ns, nr, ng,
            rain_acc, snow_acc, graupel_acc)

"""WSM6 6-class graupel microphysics (mp=4; icar_tpu/physics/mp_wsm6.py,
Hong & Lim 2006): vapour, cloud water, cloud ice, rain, snow and graupel,
with warm rain, the HDC ice processes, snow/graupel accretion and
conversion, Biggs freezing, melting and enhanced melting, evaporation of
melting snow/graupel, the cumulative ``ifsat`` saturation ordering as
masks and the category-dependent conservation scaling; sedimentation is
the WSM3 port's CFL-substepped upwind fall (snow and graupel at their
mass-weighted velocity).

Plain PyTorch over the whole (z, y, x) grid, routine by routine under the
JAX package's names and in its operation order, with mp_wsm3's rules for
rounding (divisions by constants as float32-reciprocal products, a
constant over a field as one division, ``dt`` a 0-d tensor, exp and pow
through ``ops/pointwise.py``). No TPU kernel, so no CUDA kernel.

Host reads: three a call, each the largest CFL count of a sedimentation
(``mp_wsm3._cfl``): rain; snow and graupel, which fall at one velocity and
share it; cloud ice. Nothing else is read back. One minor loop whatever
``dt``, as in the JAX package (mp_wsm3's docstring).

Layout (z, y, x); level 0 is the surface layer.
"""

from __future__ import annotations

from math import gamma as _gamma

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.pointwise import inv
from .mp_thompson import _ipow, _pow, _rd
from .mp_wsm3 import (CLIQ, CPD, CPV, DEN0, DENR, EP2, PSAT, QMIN, RV, T0C,
                      XLF0, XLS, XLV0, _cfl, _clip, _div, _dt_tensor,
                      _saturation, _sediment)

# the species the registry advects with WSM6, in its order
# (icar_tpu/registry.py:365-372)
SPECIES = ("potential_temperature", "water_vapor", "cloud_water",
           "cloud_ice", "rain_mass", "snow_mass", "graupel_mass")

# scheme parameters (mp_wsm6.f90:16-43)
N0R = 8e6
N0G = 4e6
AVTR, BVTR = 841.9, 0.8
R0 = 0.8e-5
PEAUT = 0.55
XNCR = 3e8
XMYU = 1.718e-5
AVTS, BVTS = 11.72, 0.41
AVTG, BVTG = 330.0, 0.8
DENG = 500.0
N0SMAX = 1e11
LAMDARMAX, LAMDASMAX, LAMDAGMAX = 8e4, 1e5, 6e4
DICON = 11.9
DIMAX = 500e-6
N0S = 2e6
ALPHA = 0.12
PFRZ1, PFRZ2 = 100.0, 0.66
QCRMIN = 1e-9
EACRC = 1.0
DENS = 100.0
QS0 = 6e-4

PI = np.pi
XLV1 = CLIQ - CPV

QC0 = 4.0 / 3.0 * PI * DENR * R0 ** 3 * XNCR / DEN0
QCK1 = 0.104 * 9.8 * PEAUT / (XNCR * DENR) ** (1.0 / 3.0) / XMYU \
    * DEN0 ** (4.0 / 3.0)
G3PBR = _gamma(3 + BVTR)
G4PBR = _gamma(4 + BVTR)
G5PBRO2 = _gamma(2.5 + 0.5 * BVTR)
G6PBR = _gamma(6 + BVTR)
PVTR = AVTR * G4PBR / 6.0
PACRR = PI * N0R * AVTR * G3PBR * 0.25
PRECR1 = 2.0 * PI * N0R * 0.78
PRECR2 = 2.0 * PI * N0R * 0.31 * AVTR ** 0.5 * G5PBRO2
ROQIMAX = 2.08e22 * DIMAX ** 8
G3PBS = _gamma(3 + BVTS)
G4PBS = _gamma(4 + BVTS)
G5PBSO2 = _gamma(2.5 + 0.5 * BVTS)
PVTS = AVTS * G4PBS / 6.0
PACRS = PI * N0S * AVTS * G3PBS * 0.25
PRECS1 = 4.0 * N0S * 0.65
PRECS2 = 4.0 * N0S * 0.44 * AVTS ** 0.5 * G5PBSO2
PACRC = PI * N0S * AVTS * G3PBS * 0.25 * EACRC
G3PBG = _gamma(3 + BVTG)
G4PBG = _gamma(4 + BVTG)
G5PBGO2 = _gamma(2.5 + 0.5 * BVTG)
PVTG = AVTG * G4PBG / 6.0
PACRG = PI * N0G * AVTG * G3PBG * 0.25
PRECG1 = 2.0 * PI * N0G * 0.78
PRECG2 = 2.0 * PI * N0G * 0.31 * AVTG ** 0.5 * G5PBGO2
PIDN0R = PI * DENR * N0R
PIDN0S = PI * DENS * N0S
PIDN0G = PI * DENG * N0G
RSLOPERMAX = 1.0 / LAMDARMAX
RSLOPESMAX = 1.0 / LAMDASMAX
RSLOPEGMAX = 1.0 / LAMDAGMAX


def _slope_one(q, pidn0, rmax, bvt, pvt, denfac, den, n0fac=None):
    pid = pidn0 * (n0fac if n0fac is not None else 1.0)
    lam = _pow(_div(pid, torch.clamp(q, min=QCRMIN) * den), 0.25)
    rs = torch.where(q <= QCRMIN, rmax, _rd(1.0, lam))
    rsb = _pow(rs, bvt)
    vt = torch.where(q <= 0.0, 0.0, pvt * rsb * denfac)
    return rs, rsb, rs * rs, rs * rs * rs, vt


def _slopes6(qr, qs_, qg, den, denfac, t):
    """Slope parameters + terminal velocities for rain/snow/graupel
    (slope_wsm6, mp_wsm6.f90:1508-1583)."""
    n0sfac = torch.clamp(pw.exp(ALPHA * (T0C - t)), 1.0, N0SMAX / N0S)
    r = _slope_one(qr, PIDN0R, RSLOPERMAX, BVTR, PVTR, denfac, den)
    s = _slope_one(qs_, PIDN0S, RSLOPESMAX, BVTS, PVTS, denfac, den, n0sfac)
    g = _slope_one(qg, PIDN0G, RSLOPEGMAX, BVTG, PVTG, denfac, den)
    return r, s, g, n0sfac


def _diffus(x, y):
    return 8.794e-5 * _pow(x, 1.81) / y


def _viscos(x, y):
    return 1.496e-6 * (x * torch.sqrt(x)) / (x + 120.0) / y


def _xka(x, y):
    return 1.414e3 * _viscos(x, y) * y


def _diffac(a, b, c, d, e):
    return d * a * a / (_xka(c, d) * RV * c * c) \
        + _rd(1.0, e * _diffus(c, b))


def _venfac(a, b, c):
    return _pow(_viscos(b, c) / _diffus(b, a), 1.0 / 3.0) \
        / torch.sqrt(_viscos(b, c)) * torch.sqrt(torch.sqrt(_rd(DEN0, c)))


def _scale(value, source_terms, dtcld):
    """Conservation scaling: shrink all listed rates when their net sink
    exceeds the available mass (mp_wsm6.f90:1140+)."""
    source = sum(source_terms) * dtcld
    factor = torch.where(source > value,
                         value / torch.where(source == 0, 1.0, source), 1.0)
    return factor


def _max0(x):
    return torch.clamp(x, min=0.0)


def wsm6(th, qv, qc, qi, qr, qs_, qg, exner, p, dz, den, dt,
         rain, snow, graupel):
    """One WSM6 step (wsm62D, mp_wsm6.f90:185-1384); ``dt`` a number or a
    0-d tensor. One minor loop whatever ``dt`` (the module docstring).

    Returns (th, qv, qc, qi, qr, qs, qg, rain, snow, graupel)."""
    dtcld = _dt_tensor(dt, th)
    t = th * exner
    q = qv

    qc = _max0(qc)
    qi = _max0(qi)
    qr = _max0(qr)
    qs_ = _max0(qs_)
    qg = _max0(qg)

    cpm = CPD * (1.0 - torch.clamp(q, min=QMIN)) \
        + torch.clamp(q, min=QMIN) * CPV
    xl = XLV0 - XLV1 * (t - T0C)
    denfac = torch.sqrt(_rd(DEN0, den))

    qsat_i, _ = _saturation(t, p)        # ice-mixed saturation
    # water saturation (always wrt liquid)
    ttp = T0C + 0.01
    tr = _rd(ttp, t)
    xa = -(CPV - CLIQ) / RV
    xb = xa + XLV0 / (RV * ttp)
    es_w = torch.minimum(PSAT * _pow(tr, xa) * pw.exp(xb * (1.0 - tr)),
                         0.99 * p)
    qsat_w = torch.clamp(EP2 * es_w / (p - es_w), min=QMIN)
    rh_w = torch.clamp(q / qsat_w, min=QMIN)
    rh_i = torch.clamp(q / qsat_i, min=QMIN)

    xni = torch.clamp(5.38e7 * _pow(den * torch.clamp(qi, min=QMIN), 0.75),
                      1e3, 1e6)

    # ---- sedimentation (joint snow+graupel velocity; mp_wsm6.f90:570-610)
    r_sl, s_sl, g_sl, n0sfac = _slopes6(qr, qs_, qg, den, denfac, t)
    vt_r = r_sl[4]
    qsum = torch.clamp(qs_ + qg, min=1e-15)
    vt_sg = torch.where(qsum > 1e-15,
                        (s_sl[4] * qs_ + g_sl[4] * qg) / qsum, 0.0)
    qr, sfc_r, _ = _sediment(qr, vt_r, den, dz, dtcld)
    cfl_sg = _cfl(vt_sg, dz, dtcld)
    qs_, sfc_s, _ = _sediment(qs_, vt_sg, den, dz, dtcld, cfl_sg)
    qg, sfc_g, _ = _sediment(qg, vt_sg, den, dz, dtcld, cfl_sg)

    # ---- melting of falling snow/graupel (psmlt/pgmlt, :625-660)
    r_sl, s_sl, g_sl, n0sfac = _slopes6(qr, qs_, qg, den, denfac, t)
    warm = t > T0C
    work2v = _venfac(p, t, den)
    coeres_s = s_sl[2] * torch.sqrt(s_sl[0] * s_sl[1])
    psmlt = _xka(t, den) * inv(XLF0) * (T0C - t) * PI * inv(2.0) * n0sfac \
        * (PRECS1 * s_sl[2] + PRECS2 * work2v * coeres_s)
    psmlt = torch.where(warm & (qs_ > 0),
                        _clip(psmlt * dtcld, -qs_, 0.0), 0.0)
    qs_ = qs_ + psmlt
    qr = qr - psmlt
    t = t + _rd(XLF0, cpm) * psmlt
    coeres_g = g_sl[2] * torch.sqrt(g_sl[0] * g_sl[1])
    pgmlt = _xka(t, den) * inv(XLF0) * (T0C - t) \
        * (PRECG1 * g_sl[2] + PRECG2 * work2v * coeres_g)
    pgmlt = torch.where(warm & (qg > 0),
                        _clip(pgmlt * dtcld, -qg, 0.0), 0.0)
    qg = qg + pgmlt
    qr = qr - pgmlt
    t = t + _rd(XLF0, cpm) * pgmlt

    # ---- cloud ice sedimentation (:662-690)
    xmi = den * qi / xni
    diam_i = torch.clamp(DICON * torch.sqrt(_max0(xmi)), 1e-25, DIMAX)
    vt_i = torch.where(qi > 0.0, 1.49e4 * _pow(diam_i, 1.31), 0.0)
    qi, sfc_i, _ = _sediment(qi, vt_i, den, dz, dtcld)

    # ---- surface precipitation (:698-720); fluxes already in kg/m^2 = mm
    rain = rain + sfc_r + sfc_s + sfc_g + sfc_i
    snow = snow + sfc_s + sfc_i
    graupel = graupel + sfc_g

    # ---- instantaneous conversions (:723-778)
    supcol = T0C - t
    xlf_i = torch.where(supcol < 0, XLF0, XLS - xl)
    # pimlt: melt all cloud ice above 0C
    m = (supcol < 0) & (qi > 0)
    qc = torch.where(m, qc + qi, qc)
    t = torch.where(m, t - xlf_i / cpm * qi, t)
    qi = torch.where(m, 0.0, qi)
    # pihmf: homogeneous freezing below -40C
    m = (supcol > 40) & (qc > 0)
    qi = torch.where(m, qi + qc, qi)
    t = torch.where(m, t + xlf_i / cpm * qc, t)
    qc = torch.where(m, 0.0, qc)
    # pihtf: Biggs heterogeneous freezing of cloud water
    supcolt = torch.clamp(supcol, max=50.0)
    pfrzdtc = torch.minimum(
        PFRZ1 * (pw.exp(PFRZ2 * supcolt) - 1.0) * den * inv(DENR)
        * inv(XNCR) * qc * qc * dtcld, qc)
    m = (supcol > 0) & (qc > QMIN)
    qi = torch.where(m, qi + pfrzdtc, qi)
    t = torch.where(m, t + xlf_i / cpm * pfrzdtc, t)
    qc = torch.where(m, qc - pfrzdtc, qc)
    # pgfrz: Biggs freezing of rain to graupel
    r_sl, s_sl, g_sl, n0sfac = _slopes6(qr, qs_, qg, den, denfac, t)
    temp_r = r_sl[3] * r_sl[3] * r_sl[0]
    pfrzdtr = torch.minimum(
        _rd(20.0 * PI * PI * PFRZ1 * N0R * DENR, den)
        * (pw.exp(PFRZ2 * supcolt) - 1.0) * temp_r * dtcld, qr)
    m = (supcol > 0) & (qr > 0)
    qg = torch.where(m, qg + pfrzdtr, qg)
    t = torch.where(m, t + xlf_i / cpm * pfrzdtr, t)
    qr = torch.where(m, qr - pfrzdtr, qr)

    # ---- process rates (:780-1130)
    r_sl, s_sl, g_sl, n0sfac = _slopes6(qr, qs_, qg, den, denfac, t)
    rsl, rslb, rsl2, rsl3, _ = r_sl
    ssl, sslb, ssl2, ssl3, _ = s_sl
    gsl, gslb, gsl2, gsl3, _ = g_sl
    supcol = T0C - t
    work1_w = _diffac(xl, p, t, den, qsat_w)
    work1_i = _diffac(XLS, p, t, den, qsat_i)
    work2v = _venfac(p, t, den)
    zero = torch.zeros_like(t)

    supsat_w = torch.clamp(q, min=QMIN) - qsat_w
    satdt_w = supsat_w / dtcld
    # warm rain
    praut = torch.where(qc > QC0,
                        torch.minimum(QCK1 * _pow(qc, 7.0 / 3.0),
                                      qc / dtcld), 0.0)
    pracw = torch.where((qr > QCRMIN) & (qc > QMIN),
                        torch.minimum(PACRR * rsl3 * rslb * qc * denfac,
                                      qc / dtcld), 0.0)
    coeres_r = rsl2 * torch.sqrt(rsl * rslb)
    prevp_raw = (rh_w - 1.0) * (PRECR1 * rsl2
                                + PRECR2 * work2v * coeres_r) / work1_w
    half_w = satdt_w * inv(2.0)
    prevp = torch.where(qr > 0,
                        torch.where(prevp_raw < 0,
                                    torch.maximum(torch.maximum(
                                        prevp_raw, -qr / dtcld), half_w),
                                    torch.minimum(prevp_raw, half_w)), 0.0)

    # cold processes
    supsat_i = torch.clamp(q, min=QMIN) - qsat_i
    satdt = supsat_i / dtcld
    half = satdt * inv(2.0)
    eacrs = pw.exp(0.07 * (-supcol))
    xni = torch.clamp(5.38e7 * _pow(den * torch.clamp(qi, min=QMIN), 0.75),
                      1e3, 1e6)
    xmi = den * qi / xni
    diameter = torch.clamp(DICON * torch.sqrt(_max0(xmi)), max=DIMAX)
    vt2i = 1.49e4 * _pow(torch.clamp(diameter, min=1e-25), 1.31)
    vt2r = PVTR * rslb * denfac
    vt2s = PVTS * sslb * denfac
    vt2g = PVTG * gslb * denfac
    qsum = torch.clamp(qs_ + qg, min=1e-15)
    vt2ave = torch.where(qsum > 1e-15, (vt2s * qs_ + vt2g * qg) / qsum, 0.0)

    cold_i = (supcol > 0) & (qi > QMIN)
    d2 = _ipow(diameter, 2)
    acr_r = 2.0 * rsl3 + 2.0 * diameter * rsl2 + d2 * rsl
    praci = torch.where(cold_i & (qr > QCRMIN),
                        torch.minimum(PI * qi * N0R * torch.abs(vt2r - vt2i)
                                      * acr_r * inv(4.0), qi / dtcld), 0.0)
    piacr = torch.where(cold_i & (qr > QCRMIN),
                        torch.minimum(PI ** 2 * AVTR * N0R * DENR * xni
                                      * denfac * G6PBR * rsl3 * rsl3 * rslb
                                      * inv(24.0) / den, qr / dtcld), 0.0)
    acr_s = 2.0 * ssl3 + 2.0 * diameter * ssl2 + d2 * ssl
    psaci = torch.where(cold_i & (qs_ > QCRMIN),
                        torch.minimum(PI * qi * eacrs * N0S * n0sfac
                                      * torch.abs(vt2ave - vt2i) * acr_s
                                      * inv(4.0), qi / dtcld), 0.0)
    acr_g = 2.0 * gsl3 + 2.0 * diameter * gsl2 + d2 * gsl
    pgaci = torch.where(cold_i & (qg > QCRMIN),
                        torch.minimum(PI * eacrs * qi * N0G
                                      * torch.abs(vt2ave - vt2i) * acr_g
                                      * inv(4.0), qi / dtcld), 0.0)
    psacw = torch.where((qs_ > QCRMIN) & (qc > QMIN),
                        torch.minimum(PACRC * n0sfac * ssl3 * sslb * qc
                                      * denfac, qc / dtcld), 0.0)
    pgacw = torch.where((qg > QCRMIN) & (qc > QMIN),
                        torch.minimum(PACRG * gsl3 * gslb * qc * denfac,
                                      qc / dtcld), 0.0)
    paacw = torch.where(qsum > 1e-15,
                        (qs_ * psacw + qg * pgacw) / qsum, 0.0)
    acr_rs = (5.0 * ssl3 * ssl3 * rsl + 2.0 * ssl3 * ssl2 * rsl2
              + 0.5 * ssl2 * ssl2 * rsl3)
    pracs = torch.where((qs_ > QCRMIN) & (qr > QCRMIN) & (supcol > 0),
                        torch.minimum(PI ** 2 * N0R * N0S * n0sfac
                                      * torch.abs(vt2r - vt2ave)
                                      * _rd(DENS, den) * acr_rs,
                                      qs_ / dtcld), 0.0)
    acr_sr = (5.0 * rsl3 * rsl3 * ssl + 2.0 * rsl3 * rsl2 * ssl2
              + 0.5 * rsl2 * rsl2 * ssl3)
    psacr = torch.where((qs_ > QCRMIN) & (qr > QCRMIN),
                        torch.minimum(PI ** 2 * N0R * N0S * n0sfac
                                      * torch.abs(vt2ave - vt2r)
                                      * _rd(DENR, den) * acr_sr,
                                      qr / dtcld), 0.0)
    acr_gr = (5.0 * rsl3 * rsl3 * gsl + 2.0 * rsl3 * rsl2 * gsl2
              + 0.5 * rsl2 * rsl2 * gsl3)
    pgacr = torch.where((qg > QCRMIN) & (qr > QCRMIN),
                        torch.minimum(PI ** 2 * N0R * N0G
                                      * torch.abs(vt2ave - vt2r)
                                      * _rd(DENR, den) * acr_gr,
                                      qr / dtcld), 0.0)
    pgacs = zero   # eliminated in V3.0 (combined snow/graupel fall speed)

    # enhanced melting (supcol <= 0)
    melt_zone = supcol <= 0
    pseml = torch.where(melt_zone & (qs_ > 0),
                        _clip(CLIQ * supcol * (paacw + psacr) * inv(XLF0),
                              -qs_ / dtcld, 0.0), 0.0)
    pgeml = torch.where(melt_zone & (qg > 0),
                        _clip(CLIQ * supcol * (paacw + pgacr) * inv(XLF0),
                              -qg / dtcld, 0.0), 0.0)

    # deposition chain with cumulative saturation flags (supcol > 0)
    cold = supcol > 0
    pidep_raw = 4.0 * diameter * xni * (rh_i - 1.0) / work1_i
    supice1 = satdt - prevp
    pidep = torch.where(cold & (qi > 0),
                        torch.where(pidep_raw < 0,
                                    torch.maximum(torch.maximum(
                                        torch.maximum(pidep_raw, half),
                                        supice1), -qi / dtcld),
                                    torch.minimum(torch.minimum(
                                        pidep_raw, half), supice1)), 0.0)
    ifsat1 = torch.abs(prevp + pidep) >= torch.abs(satdt)
    coeres_s = ssl2 * torch.sqrt(ssl * sslb)
    psdep_raw = (rh_i - 1.0) * n0sfac * (PRECS1 * ssl2
                                         + PRECS2 * work2v * coeres_s) \
        / work1_i
    supice2 = satdt - prevp - pidep
    psdep = torch.where(cold & (qs_ > 0) & ~ifsat1,
                        torch.where(psdep_raw < 0,
                                    torch.maximum(torch.maximum(
                                        torch.maximum(psdep_raw,
                                                      -qs_ / dtcld),
                                        half), supice2),
                                    torch.minimum(torch.minimum(
                                        psdep_raw, half), supice2)), 0.0)
    ifsat2 = ifsat1 | (torch.abs(prevp + pidep + psdep) >= torch.abs(satdt))
    coeres_g = gsl2 * torch.sqrt(gsl * gslb)
    pgdep_raw = (rh_i - 1.0) * (PRECG1 * gsl2
                                + PRECG2 * work2v * coeres_g) / work1_i
    supice3 = satdt - prevp - pidep - psdep
    pgdep = torch.where(cold & (qg > 0) & ~ifsat2,
                        torch.where(pgdep_raw < 0,
                                    torch.maximum(torch.maximum(
                                        torch.maximum(pgdep_raw,
                                                      -qg / dtcld),
                                        half), supice3),
                                    torch.minimum(torch.minimum(
                                        pgdep_raw, half), supice3)), 0.0)
    ifsat3 = ifsat2 | (torch.abs(prevp + pidep + psdep + pgdep)
                       >= torch.abs(satdt))
    supice4 = satdt - prevp - pidep - psdep - pgdep
    xni0 = 1e3 * pw.exp(0.1 * supcol)
    roqi0 = 4.92e-11 * _pow(xni0, 1.33)
    pigen = torch.where(cold & (supsat_i > 0) & ~ifsat3,
                        torch.minimum(torch.minimum(_max0(
                            (roqi0 / den - _max0(qi)) / dtcld),
                            satdt), supice4), 0.0)
    psaut = torch.where(cold & (qi > 0),
                        _max0((qi - _rd(ROQIMAX, den)) / dtcld), 0.0)
    alpha2 = 1e-3 * pw.exp(0.09 * (-supcol))
    pgaut = torch.where(cold & (qs_ > 0),
                        torch.minimum(_max0(alpha2 * (qs_ - QS0)),
                                      qs_ / dtcld), 0.0)

    # evaporation of melting snow/graupel (supcol < 0)
    warm_e = supcol < 0
    psevp = torch.where(warm_e & (qs_ > 0) & (rh_w < 1),
                        _clip((rh_w - 1.0) * n0sfac
                              * (PRECS1 * ssl2 + PRECS2 * work2v * coeres_s)
                              / work1_w, -qs_ / dtcld, 0.0), 0.0)
    pgevp = torch.where(warm_e & (qg > 0) & (rh_w < 1),
                        _clip((rh_w - 1.0)
                              * (PRECG1 * gsl2 + PRECG2 * work2v * coeres_g)
                              / work1_w, -qg / dtcld, 0.0), 0.0)

    # ---- conservation scaling + updates (:1135-1320) -------------------
    delta2 = torch.where((qr < 1e-4) & (qs_ < 1e-4), 1.0, 0.0)
    delta3 = torch.where(qr < 1e-4, 1.0, 0.0)
    coldT = t <= T0C

    # cold branch scalings
    fc_c = _scale(torch.clamp(qc, min=QMIN), [praut, pracw, paacw, paacw],
                  dtcld)
    praut_c, pracw_c, paacw_c = praut * fc_c, pracw * fc_c, paacw * fc_c
    fi_c = _scale(torch.clamp(qi, min=QMIN),
                  [psaut, -pigen, -pidep, praci, psaci, pgaci], dtcld)
    psaut_c, pigen_c, pidep_c = psaut * fi_c, pigen * fi_c, pidep * fi_c
    praci_c, psaci_c, pgaci_c = praci * fi_c, psaci * fi_c, pgaci * fi_c
    fr_c = _scale(torch.clamp(qr, min=QMIN),
                  [-praut_c, -prevp, -pracw_c, piacr, psacr, pgacr], dtcld)
    praut_c, prevp_c, pracw_c = praut_c * fr_c, prevp * fr_c, pracw_c * fr_c
    piacr_c, psacr_c, pgacr_c = piacr * fr_c, psacr * fr_c, pgacr * fr_c
    fs_c = _scale(torch.clamp(qs_, min=QMIN),
                  [-(psdep + psaut_c - pgaut + paacw_c + piacr_c * delta3
                     + praci_c * delta3 - pracs * (1 - delta2)
                     + psacr_c * delta2 + psaci_c - pgacs)], dtcld)
    psdep_c, psaut_c, pgaut_c = psdep * fs_c, psaut_c * fs_c, pgaut * fs_c
    paacw_c2, piacr_c, praci_c = paacw_c * fs_c, piacr_c * fs_c, praci_c * fs_c
    psaci_c, pracs_c, psacr_c = psaci_c * fs_c, pracs * fs_c, psacr_c * fs_c
    pgacs_c = pgacs * fs_c
    fg_c = _scale(torch.clamp(qg, min=QMIN),
                  [-(pgdep + pgaut_c + piacr_c * (1 - delta3)
                     + praci_c * (1 - delta3) + psacr_c * (1 - delta2)
                     + pracs_c * (1 - delta2) + pgaci_c + paacw_c2 + pgacr_c
                     + pgacs_c)], dtcld)
    pgdep_c, pgaut_c, piacr_c = pgdep * fg_c, pgaut_c * fg_c, piacr_c * fg_c
    praci_c, psacr_c, pracs_c = praci_c * fg_c, psacr_c * fg_c, pracs_c * fg_c
    paacw_c3, pgaci_c = paacw_c2 * fg_c, pgaci_c * fg_c
    pgacr_c = pgacr_c * fg_c
    pgacs_c = pgacs_c * fg_c

    dqv_c = -(prevp_c + psdep_c + pgdep_c + pigen_c + pidep_c)
    qc_c = _max0(qc - (praut_c + pracw_c + paacw_c3 + paacw_c3) * dtcld)
    qr_c = _max0(qr + (praut_c + pracw_c + prevp_c - piacr_c - pgacr_c
                       - psacr_c) * dtcld)
    qi_c = _max0(qi - (psaut_c + praci_c + psaci_c + pgaci_c - pigen_c
                       - pidep_c) * dtcld)
    qs_c = _max0(qs_ + (psdep_c + psaut_c + paacw_c3 - pgaut_c
                        + piacr_c * delta3 + praci_c * delta3
                        + psaci_c - pgacs_c - pracs_c * (1 - delta2)
                        + psacr_c * delta2) * dtcld)
    qg_c = _max0(qg + (pgdep_c + pgaut_c + piacr_c * (1 - delta3)
                       + praci_c * (1 - delta3)
                       + psacr_c * (1 - delta2)
                       + pracs_c * (1 - delta2) + pgaci_c + paacw_c3
                       + pgacr_c + pgacs_c) * dtcld)
    xlf = XLS - xl
    xlwork2_c = (-XLS * (psdep_c + pgdep_c + pidep_c + pigen_c)
                 - xl * prevp_c - xlf * (piacr_c + paacw_c3 + paacw_c3
                                         + pgacr_c + psacr_c))
    t_c = t - xlwork2_c / cpm * dtcld
    q_c = q + dqv_c * dtcld

    # warm branch scalings
    fc_w = _scale(torch.clamp(qc, min=QMIN), [praut, pracw, paacw, paacw],
                  dtcld)
    praut_w, pracw_w, paacw_w = praut * fc_w, pracw * fc_w, paacw * fc_w
    fr_w = _scale(torch.clamp(qr, min=QMIN),
                  [-paacw_w, -praut_w, pseml, pgeml, -pracw_w, -paacw_w,
                   -prevp], dtcld)
    praut_w, prevp_w, pracw_w = praut_w * fr_w, prevp * fr_w, pracw_w * fr_w
    paacw_w, pseml_w, pgeml_w = paacw_w * fr_w, pseml * fr_w, pgeml * fr_w
    fs_w = _scale(torch.clamp(qs_, min=QCRMIN), [pgacs - pseml_w - psevp],
                  dtcld)
    pgacs_w, psevp_w, pseml_w = pgacs * fs_w, psevp * fs_w, pseml_w * fs_w
    fg_w = _scale(torch.clamp(qg, min=QCRMIN),
                  [-(pgacs_w + pgevp + pgeml_w)], dtcld)
    pgacs_w, pgevp_w, pgeml_w = pgacs_w * fg_w, pgevp * fg_w, pgeml_w * fg_w

    dqv_w = -(prevp_w + psevp_w + pgevp_w)
    qc_w = _max0(qc - (praut_w + pracw_w + paacw_w + paacw_w) * dtcld)
    qr_w = _max0(qr + (praut_w + pracw_w + prevp_w + paacw_w + paacw_w
                       - pseml_w - pgeml_w) * dtcld)
    qs_w = _max0(qs_ + (psevp_w - pgacs_w + pseml_w) * dtcld)
    qg_w = _max0(qg + (pgacs_w + pgevp_w + pgeml_w) * dtcld)
    xlwork2_w = (-xl * (prevp_w + psevp_w + pgevp_w)
                 - xlf * (pseml_w + pgeml_w))
    t_w = t - xlwork2_w / cpm * dtcld
    q_w = q + dqv_w * dtcld

    q = torch.where(coldT, q_c, q_w)
    qc = torch.where(coldT, qc_c, qc_w)
    qi = torch.where(coldT, qi_c, qi)
    qr = torch.where(coldT, qr_c, qr_w)
    qs_ = torch.where(coldT, qs_c, qs_w)
    qg = torch.where(coldT, qg_c, qg_w)
    t = torch.where(coldT, t_c, t_w)

    # ---- cloud condensation (pcond, :1355-1370) ------------------------
    tr = _rd(ttp, t)
    es_w = torch.minimum(PSAT * _pow(tr, xa) * pw.exp(xb * (1.0 - tr)),
                         0.99 * p)
    qsat_w = torch.clamp(EP2 * es_w / (p - es_w), min=QMIN)
    work1c = (torch.clamp(q, min=QMIN) - qsat_w) \
        / (1.0 + xl * xl / (RV * cpm) * qsat_w / (t * t))
    pcond = torch.minimum(_max0(work1c / dtcld), _max0(q) / dtcld)
    pcond = torch.where((qc > 0) & (work1c < 0),
                        torch.maximum(work1c, -qc) / dtcld, pcond)
    q = q - pcond * dtcld
    qc = _max0(qc + pcond * dtcld)
    t = t + pcond * xl / cpm * dtcld

    qc = torch.where(qc <= QMIN, 0.0, qc)
    qi = torch.where(qi <= QMIN, 0.0, qi)

    th = t / exner
    return th, q, qc, qi, qr, qs_, qg, rain, snow, graupel

"""Noah land-surface model (unified NoahLSM v1.0, 2007)
(icar_tpu/physics/lsm_noah.py: SFLX and its subtree of lsm_noahlsm.f90,
and the per-point driver of lsm_noahdrv.f90), over the whole (ny, nx) grid
with masked selects instead of the reference's per-column branches: 4-layer
soil heat diffusion with phase change (HRT/HSTEP/SNKSRC/FRH2O), the
Richards equation with Schaake/Koren infiltration and the Kalnay-Kanamitsu
two-pass scheme (SRT/SSTEP), Penman potential evaporation, the Jarvis
canopy resistance (CANRES), the evaporation split (EVAPO) and the snowpack
(SNOPAC). The snow and no-snow branches share one solve of EVAPO, SMFLX and
SHFLX on branch-selected inputs, as in the JAX package.

Plain PyTorch: on the card each line is a whole-grid operation. The four
soil layers are Python loops over rows of (4, ny, nx) tensors, FRH2O takes
its fixed 10 Newton steps and ROSR12 solves the tridiagonal system row by
row. Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), as in the JAX package's compiled step, so the CPU and
the card compute alike; ``dt`` is a 0-d float32 tensor (a number in the
tests).

Layout: 2D fields (ny, nx); soil fields (4, ny, nx), layer 0 at the top.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.pointwise import inv
from . import noah_params as NP
from .noah_params import NSOIL

# module constants (lsm_noahlsm.f90:11-21)
CP = 1004.5
RD = 287.04
SIGMA = 5.67e-8
CPH2O = 4.218e3
CPICE = 2.106e3
LSUBF = 3.335e5
EMISSI_S = 0.95
XLV = 2.5e6
XLF = 3.5e5
RHOWATER = 1000.0
TFREEZ = 273.15
LVH2O = 2.501e6
LSUBS = 2.83e6
LSUBC = 2.501e6
R = 287.04
KARMAN = 0.4

# (4,) negative depths of the layer bottoms, float32 as the JAX package
# holds them; constants formed from them stay float32 numpy scalars
ZSOIL = (-np.cumsum(NP.DZS)).astype(np.float32)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), each bound a number or a tensor."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else \
        torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else \
        torch.clamp(x, max=hi)


def _layer_dz(k):
    """The thickness of soil layer ``k`` (float32)."""
    return -ZSOIL[0] if k == 0 else ZSOIL[k - 1] - ZSOIL[k]


# ---------------------------------------------------------------------------
# small physics helpers
# ---------------------------------------------------------------------------

def csnow(sndens):
    """Snow thermal conductivity, doubled Dyachkova form
    (lsm_noahlsm.f90:1119-1158)."""
    return 2.0 * 0.11631 * 0.328 * pw.pow(10.0, 2.25 * sndens)


def tdfcnd(smc, qz, smcmax, sh2o):
    """Peters-Lidard soil thermal conductivity
    (lsm_noahlsm.f90:3849-3956)."""
    satratio = smc / smcmax
    thks = pw.pow(7.7, qz) * pw.pow(2.0, 1.0 - qz)
    xunfroz = sh2o / torch.clamp(smc, min=1e-9)
    xu = xunfroz * smcmax
    thksat = pw.pow(thks, 1. - smcmax) * pw.pow(2.2, smcmax - xu) \
        * pw.pow(0.57, xu)
    gammd = (1. - smcmax) * 2700.
    thkdry = (0.135 * gammd + 64.7) / (2700. - 0.947 * gammd)
    ake_unfr = torch.where(
        satratio > 0.1, torch.log10(torch.clamp(satratio, min=1e-10)) + 1.0,
        0.0)
    ake = torch.where((sh2o + 0.0005) < smc, satratio, ake_unfr)
    return ake * (thksat - thkdry) + thkdry


def wdfcnd(smc, smcmax, bexp, dksat, dwsat, sicemax):
    """Soil water diffusivity and hydraulic conductivity
    (lsm_noahlsm.f90:4170-4228)."""
    factr2 = smc / smcmax
    factr1 = torch.minimum(0.05 / smcmax, factr2)
    expon = bexp + 2.0
    wdf = dwsat * pw.pow(factr2, expon)
    s5 = 500. * sicemax
    vkwgt = 1. / (1. + s5 * s5 * s5)
    wdf = torch.where(sicemax > 0.0,
                      vkwgt * wdf + (1. - vkwgt) * dwsat * pw.pow(factr1, expon),
                      wdf)
    wcnd = dksat * pw.pow(factr2, (2.0 * bexp) + 3.0)
    return wdf, wcnd


def frh2o(tkelv, smc, sh2o, smcmax, bexp, psis):
    """Supercooled liquid water (Koren et al. 1999 eqn 17): a Newton
    iteration of a fixed 10 steps on every cell (lsm_noahlsm.f90:1405-1543;
    the JAX package drops the Flerchinger fallback)."""
    bx = torch.clamp(bexp, max=5.5)
    CK = 8.0
    HLICE, GS, T0 = 3.335e5, 9.81, 273.15
    swl = _clip(smc - sh2o, 0.0, smc - 0.02)
    frozen = tkelv <= (T0 - 1e-3)
    tk = torch.where(frozen, tkelv, T0 - 1.0)    # a dummy where unfrozen
    c0 = psis * GS * inv(HLICE)
    tlog = torch.log(-(tk - T0) / tk)
    for _ in range(10):
        a = 1. + CK * swl
        df = torch.log(c0 * (a * a) * pw.pow(smcmax / (smc - swl), bx)) \
            - tlog
        denom = 2. * CK / a + bx / (smc - swl)
        swl = _clip(swl - df / denom, 0.0, smc - 0.02)
    return torch.where(frozen, smc - swl, smc)


def snfrac(sneqv, snup, salp, snowh):
    """Fractional snow cover (lsm_noahlsm.f90:2635-2737, non-UA path)."""
    rsnow = sneqv / torch.clamp(snup, min=1e-9)
    return torch.where(sneqv < snup,
                       1. - (torch.exp(-salp * rsnow)
                             - rsnow * float(np.exp(-salp))), 1.0)


def alcalc(alb, snoalb, sncovr, snowng, snotime1, dt, embrd):
    """Livneh snow-albedo decay (lsm_noahlsm.f90:862-977)."""
    SNACCA, SNACCB = 0.94, 0.58
    emissi = embrd + sncovr * (EMISSI_S - embrd)
    snoalb1 = snoalb + NP.LVCOEF * (0.85 - snoalb)
    snotime1 = torch.where(snowng, 0.0, snotime1 + dt)
    snoalb2 = torch.where(
        snowng, snoalb1,
        snoalb1 * pw.pow(SNACCA, pw.pow(snotime1 * inv(86400.0), SNACCB)))
    snoalb2 = torch.maximum(snoalb2, alb)
    albedo = torch.minimum(alb + sncovr * (snoalb2 - alb), snoalb2)
    return albedo, emissi, snotime1


def snow_new(temp, newsn, snowh, sndens):
    """New-snowfall density and depth (lsm_noahlsm.f90:3400-3454)."""
    snowhc = snowh * 100.
    newsnc = newsn * 100.
    tempc = temp - 273.15
    dsnew = torch.where(
        tempc <= -15., 0.05,
        0.05 + 0.0017 * pw.pow(torch.clamp(tempc + 15., min=0.), 1.5))
    hnewc = newsnc / dsnew
    sndens = torch.where(snowhc + hnewc < 1e-3,
                         torch.maximum(dsnew, sndens),
                         (snowhc * sndens + hnewc * dsnew)
                         / torch.clamp(snowhc + hnewc, min=1e-10))
    snowh = (snowhc + hnewc) * 0.01
    return snowh, sndens


def snowpack_compact(esd, dtsec, snowh, sndens, tsnow, tsoil):
    """Snow compaction, Koren/Anderson (lsm_noahlsm.f90:3210-3340)."""
    C1, C2 = 0.01, 21.0
    esdc = esd * 100.
    dthr = dtsec * inv(3600.)
    tsnowc = tsnow - 273.15
    tsoilc = tsoil - 273.15
    tavgc = 0.5 * (tsnowc + tsoilc)
    esdcx = torch.clamp(esdc, min=1e-2)
    bfac = dthr * C1 * torch.exp(0.08 * tavgc - C2 * sndens)
    # 4-term polynomial expansion of (e^x - 1)/x
    pexp = torch.zeros_like(esdcx)
    for j in range(4, 0, -1):
        pexp = (1. + pexp) * bfac * esdcx * inv(j + 1)
    pexp = pexp + 1.
    dsx = torch.clamp(sndens * pexp, 0.05, 0.40)
    dw = 0.13 * dthr * inv(24.)
    sndens = torch.where(tsnowc >= 0.,
                         torch.clamp(dsx * (1. - dw) + dw, max=0.40), dsx)
    snowhc = esdc / torch.clamp(sndens, min=1e-9)
    return snowhc * 0.01, sndens


def snowz0(sncovr, z0brd, snowh):
    """Roughness under snow (lsm_noahlsm.f90:3345-3395, non-UA)."""
    Z0S = 0.001
    burial = 7.0 * z0brd - snowh
    z0eff = torch.where(burial <= 0.0007, Z0S, burial * inv(7.0))
    return (1. - sncovr) * z0brd + sncovr * z0eff


def rosr12(a, b, c, d):
    """Tridiagonal solve over the leading soil axis
    (lsm_noahlsm.f90:2374-2433); returns the solution."""
    n = a.shape[0]
    p = [None] * n
    delta = [None] * n
    p[0] = -c[0] / b[0]
    delta[0] = d[0] / b[0]
    for k in range(1, n):
        denom = 1.0 / (b[k] + a[k] * p[k - 1])
        # the last row's upper coefficient (c[n-1] := 0) is never read
        if k < n - 1:
            p[k] = -c[k] * denom
        delta[k] = (d[k] - a[k] * delta[k - 1]) * denom
    out = [None] * n
    out[n - 1] = delta[n - 1]
    for k in range(n - 2, -1, -1):
        out[k] = p[k] * out[k + 1] + delta[k]
    return torch.stack(out)


def tbnd(tu, tb, k, zbot):
    """Layer-boundary temperature (lsm_noahlsm.f90:3800-3846)."""
    zup = 0.0 if k == 0 else ZSOIL[k - 1]
    zb = 2. * zbot - ZSOIL[k] if k == NSOIL - 1 else ZSOIL[k + 1]
    return tu + (tb - tu) * (zup - ZSOIL[k]) * inv(zup - zb)


def tmpavg(tup, tm, tdn, k):
    """Freezing-aware layer-average temperature
    (lsm_noahlsm.f90:3958-4060)."""
    T0 = 273.15
    dz = _layer_dz(k)
    dzh = dz * 0.5
    eps = 1e-9
    rdz = inv(dz)

    def safe_inv(b_):
        return 1.0 / torch.where(torch.abs(b_) < eps,
                                 torch.sign(b_) * eps + eps, b_)
    r_dn = safe_inv(tdn - tm)
    r_up = safe_inv(tm - tup)
    x0 = (T0 - tm) * dzh * r_dn
    xup_a = (T0 - tup) * dzh * r_up
    xdn_a = dzh - (T0 - tm) * dzh * r_dn
    xup_b = dzh - (T0 - tup) * dzh * r_up
    xdn_b = (T0 - tm) * dzh * r_dn
    all4 = (tup + 2.0 * tm + tdn) * 0.25

    cold_up = tup < T0
    cold_m = tm < T0
    cold_dn = tdn < T0
    W = torch.where
    return W(
        cold_up,
        W(cold_m,
          W(cold_dn, all4,
            0.5 * (tup * dzh + tm * (dzh + x0) + T0 * (2. * dzh - x0))
            * rdz),
          W(cold_dn,
            0.5 * (tup * xup_a + T0 * (2. * dz - xup_a - xdn_a)
                   + tdn * xdn_a) * rdz,
            0.5 * (tup * xup_a + T0 * (2. * dz - xup_a)) * rdz)),
        W(cold_m,
          W(cold_dn,
            0.5 * (T0 * (dz - xup_b) + tm * (dzh + xup_b) + tdn * dzh)
            * rdz,
            0.5 * (T0 * (2. * dz - xup_b - xdn_b) + tm * (xup_b + xdn_b))
            * rdz),
          W(cold_dn,
            (T0 * (dz - (dzh - xdn_b)) + 0.5 * (T0 + tdn) * (dzh - xdn_b))
            * rdz,
            all4)))


def snksrc(tavg, smc, sh2o, smcmax, psisat, bexp, dt, k, qtot):
    """Phase-change heat source or sink and the updated liquid water
    (lsm_noahlsm.f90:2740-2825)."""
    DH2O, HLICE = 1e3, 3.335e5
    dz = _layer_dz(k)
    free = frh2o(tavg, smc, sh2o, smcmax, bexp, psisat)
    xh2o = sh2o + qtot * dt * inv(DH2O * HLICE * dz)
    # freezing: not below the equilibrium free water
    xh2o = torch.where((xh2o < sh2o) & (xh2o < free),
                       torch.where(free > sh2o, sh2o, free), xh2o)
    # thawing: not above it
    xh2o = torch.where((xh2o > sh2o) & (xh2o > free),
                       torch.where(free < sh2o, sh2o, free), xh2o)
    xh2o = _clip(xh2o, 0.0, smc)
    tsnsr = -DH2O * HLICE * dz * (xh2o - sh2o) / dt
    return tsnsr, xh2o


# ---------------------------------------------------------------------------
# soil column solvers
# ---------------------------------------------------------------------------

def hrt_hstep(stc, smc, sh2o, smcmax, yy, zz1, tbot, zbot, psisat, dt,
              bexp, df1, quartz, csoil_loc):
    """Soil thermal diffusion with freeze/thaw source terms (HRT + HSTEP,
    lsm_noahlsm.f90:1546-1844). Returns (stc_new, sh2o_new)."""
    CAIR, CICE_V, CH2O_V = 1004.0, 2.106e6, 4.2e6
    ai = [None] * NSOIL
    bi = [None] * NSOIL
    ci = [None] * NSOIL
    rhsts = [None] * NSOIL
    sh2o_new = [None] * NSOIL

    hcpct = sh2o[0] * CH2O_V + (1. - smcmax) * csoil_loc \
        + (smcmax - smc[0]) * CAIR + (smc[0] - sh2o[0]) * CICE_V
    ddz = 1.0 / (-0.5 * ZSOIL[1])
    ai[0] = torch.zeros_like(stc[0])
    ci[0] = (df1 * ddz) / (ZSOIL[0] * hcpct)
    bi[0] = -ci[0] + df1 / (0.5 * ZSOIL[0] * ZSOIL[0] * hcpct * zz1)
    dtsdz = (stc[0] - stc[1]) * inv(-0.5 * ZSOIL[1])
    ssoil = df1 * (stc[0] - yy) / (0.5 * ZSOIL[0] * zz1)
    denom = ZSOIL[0] * hcpct
    rhsts[0] = (df1 * dtsdz - ssoil) / denom
    qtot = -1.0 * rhsts[0] * denom

    # freeze/thaw source of layer 0 (the ITAVG=.true. path)
    sice = smc[0] - sh2o[0]
    tsurf = (yy + (zz1 - 1) * stc[0]) / zz1
    tbk = tbnd(stc[0], stc[1], 0, zbot)
    need = (sice > 0.) | (stc[0] < TFREEZ) | (tsurf < TFREEZ) \
        | (tbk < TFREEZ)
    tavg = tmpavg(tsurf, stc[0], tbk, 0)
    tsnsr, xh2o = snksrc(tavg, smc[0], sh2o[0], smcmax, psisat, bexp,
                         dt, 0, qtot)
    rhsts[0] = torch.where(need, rhsts[0] - tsnsr / denom, rhsts[0])
    sh2o_new[0] = torch.where(need, xh2o, sh2o[0])

    df1k = df1
    ddz2 = 0.0
    for k in range(1, NSOIL):
        hcpct = sh2o[k] * CH2O_V + (1. - smcmax) * csoil_loc \
            + (smcmax - smc[k]) * CAIR + (smc[k] - sh2o[k]) * CICE_V
        df1n = tdfcnd(smc[k], quartz, smcmax, sh2o[k])
        if k != NSOIL - 1:
            denom2 = 0.5 * (ZSOIL[k - 1] - ZSOIL[k + 1])
            dtsdz2 = (stc[k] - stc[k + 1]) * inv(denom2)
            ddz2 = 2. / (ZSOIL[k - 1] - ZSOIL[k + 1])
            ci[k] = -df1n * ddz2 / ((ZSOIL[k - 1] - ZSOIL[k]) * hcpct)
            tbk1 = tbnd(stc[k], stc[k + 1], k, zbot)
        else:
            denom2 = 0.5 * (ZSOIL[k - 1] + ZSOIL[k]) - zbot
            dtsdz2 = (stc[k] - tbot) * inv(denom2)
            ci[k] = torch.zeros_like(stc[k])
            tbk1 = tbnd(stc[k], tbot, k, zbot)
        denom = (ZSOIL[k] - ZSOIL[k - 1]) * hcpct
        rhsts[k] = (df1n * dtsdz2 - df1k * dtsdz) / denom
        qtot = -1.0 * denom * rhsts[k]
        sice = smc[k] - sh2o[k]
        tavg = tmpavg(tbk, stc[k], tbk1, k)
        need = (sice > 0.) | (stc[k] < TFREEZ) | (tbk < TFREEZ) \
            | (tbk1 < TFREEZ)
        tsnsr, xh2o = snksrc(tavg, smc[k], sh2o[k], smcmax, psisat,
                             bexp, dt, k, qtot)
        rhsts[k] = torch.where(need, rhsts[k] - tsnsr / denom, rhsts[k])
        sh2o_new[k] = torch.where(need, xh2o, sh2o[k])
        ai[k] = -df1k * ddz / ((ZSOIL[k - 1] - ZSOIL[k]) * hcpct)
        bi[k] = -(ai[k] + ci[k])
        tbk = tbk1
        df1k = df1n
        dtsdz = dtsdz2
        ddz = ddz2

    # HSTEP: the implicit update
    dtemp = rosr12(torch.stack([x * dt for x in ai]),
                   torch.stack([1. + x * dt for x in bi]),
                   torch.stack([x * dt for x in ci]),
                   torch.stack([x * dt for x in rhsts]))
    return stc + dtemp, torch.stack(sh2o_new)


def srt_sstep(sh2o, sh2oa, smc, sice, cmc, pcpdrp, edir, et, dt,
              smcmax, smcwlt, bexp, dksat, dwsat, slope, kdt, frzx,
              shdfac, rhsct):
    """One Richards-equation solve (SRT + SSTEP, lsm_noahlsm.f90:3460-3800).
    Returns (sh2o_new, smc_new, cmc_new, runoff1, runoff2, runoff3)."""
    CVFRZ = 3
    sicemax = torch.amax(sice, dim=0)

    # Schaake/Koren infiltration
    dt1 = dt * inv(86400.)
    smcav = smcmax - smcwlt
    dmax0 = -ZSOIL[0] * smcav * (1.0 - (sh2oa[0] + sice[0] - smcwlt)
                                 / smcav)
    dice = -ZSOIL[0] * sice[0]
    dd = dmax0
    for k in range(1, NSOIL):
        dzk = ZSOIL[k - 1] - ZSOIL[k]
        dice = dice + dzk * sice[k]
        dd = dd + dzk * smcav * (1.0 - (sh2oa[k] + sice[k] - smcwlt)
                                 / smcav)
    val = 1. - torch.exp(-kdt * dt1)
    ddt = dd * val
    px = torch.clamp(pcpdrp * dt, min=0.0)
    infmax = (px * (ddt / torch.clamp(px + ddt, min=1e-20))) / dt
    # frozen-ground reduction (the gamma-series correction)
    acrt = CVFRZ * frzx / torch.clamp(dice, min=1e-10)
    # sum over j = 1, 2 of acrt^(CVFRZ - j) / (j+1)...(CVFRZ - 1)
    s = 1.0 + (acrt * acrt) * 0.5 + acrt
    fcr = torch.where(dice > 1e-2, 1. - torch.exp(-acrt) * s, 1.0)
    infmax = infmax * fcr
    wdf0, wcnd0 = wdfcnd(sh2oa[0], smcmax, bexp, dksat, dwsat, sicemax)
    infmax = torch.minimum(torch.maximum(infmax, wcnd0), px / dt)
    runoff1 = torch.where(pcpdrp > infmax, pcpdrp - infmax, 0.0)
    pddum = torch.where(pcpdrp > infmax, infmax, pcpdrp)

    ai = [None] * NSOIL
    bi = [None] * NSOIL
    ci = [None] * NSOIL
    rhstt = [None] * NSOIL
    ddz = 1. / (-.5 * ZSOIL[1])
    ai[0] = torch.zeros_like(sh2o[0])
    bi[0] = wdf0 * ddz * inv(-ZSOIL[0])
    ci[0] = -bi[0]
    dsmdz = (sh2o[0] - sh2o[1]) * inv(-.5 * ZSOIL[1])
    rhstt[0] = (wdf0 * dsmdz + wcnd0 - pddum + edir + et[0]) \
        * inv(ZSOIL[0])

    wdf, wcnd = wdf0, wcnd0
    runoff2 = None
    for k in range(1, NSOIL):
        denom2 = ZSOIL[k - 1] - ZSOIL[k]
        if k != NSOIL - 1:
            slopx = 1.0
            wdf2, wcnd2 = wdfcnd(sh2oa[k], smcmax, bexp, dksat, dwsat,
                                 sicemax)
            denom = ZSOIL[k - 1] - ZSOIL[k + 1]
            dsmdz2 = (sh2o[k] - sh2o[k + 1]) * inv(denom * 0.5)
            ddz2 = 2.0 / denom
            ci[k] = -wdf2 * ddz2 * inv(denom2)
        else:
            slopx = slope
            wdf2, wcnd2 = wdfcnd(sh2oa[NSOIL - 1], smcmax, bexp, dksat,
                                 dwsat, sicemax)
            dsmdz2 = 0.0
            ci[k] = torch.zeros_like(sh2o[k])
        numer = wdf2 * dsmdz2 + slopx * wcnd2 - wdf * dsmdz - wcnd + et[k]
        rhstt[k] = numer * inv(-denom2)
        ai[k] = -wdf * ddz * inv(denom2)
        bi[k] = -(ai[k] + ci[k])
        if k == NSOIL - 1:
            runoff2 = slopx * wcnd2
        wdf, wcnd = wdf2, wcnd2
        dsmdz = dsmdz2
        ddz = ddz2

    # SSTEP
    incr = rosr12(torch.stack([x * dt for x in ai]),
                  torch.stack([1. + x * dt for x in bi]),
                  torch.stack([x * dt for x in ci]),
                  torch.stack([x * dt for x in rhstt]))

    sh2o_out = []
    smc_out = []
    wplus = torch.zeros_like(sh2o[0])
    for k in range(NSOIL):
        ddzk = _layer_dz(k)
        val = sh2o[k] + incr[k] + wplus * inv(ddzk)
        stot = val + sice[k]
        wplus = torch.where(stot > smcmax, (stot - smcmax) * ddzk, 0.0)
        smck = torch.minimum(torch.clamp(stot, min=0.02), smcmax)
        smc_out.append(smck)
        sh2o_out.append(torch.clamp(smck - sice[k], min=0.0))
    runoff3 = wplus
    cmc_new = cmc + dt * rhsct
    cmc_new = torch.where(cmc_new < 1e-20, 0.0, cmc_new)
    cmc_new = torch.clamp(cmc_new, max=NP.CMCMAX)
    return (torch.stack(sh2o_out), torch.stack(smc_out), cmc_new,
            runoff1, runoff2, runoff3)


# FAC2MIT (lsm_noahlsm.f90:1382-1402): the second pass's saturation limit,
# keyed on the exact smcmax of a soil class
FAC2MIT = ((0.395, 0.59), (0.434, 0.85), (0.404, 0.85), (0.465, 0.86),
           (0.406, 0.86), (0.476, 0.74), (0.439, 0.74), (0.200, 0.80),
           (0.464, 0.80))


def smflx(smc, cmc, dt, prcp1, sh2o, slope, kdt, frzfact, smcmax, bexp,
          smcwlt, dksat, dwsat, shdfac, edir, ec, et):
    """Canopy water and the two-pass Richards solve (SMFLX,
    lsm_noahlsm.f90:2496-2631)."""
    rhsct = shdfac * prcp1 - ec
    excess = cmc + dt * rhsct
    drip = torch.clamp(excess - NP.CMCMAX, min=0.0)
    pcpdrp = (1. - shdfac) * prcp1 + drip / dt
    sice = smc - sh2o

    fac2 = torch.amax(sh2o / smcmax, dim=0)
    flimit = torch.full_like(fac2, 0.90)
    for val, lim in FAC2MIT:
        flimit = torch.where(torch.abs(smcmax - val) < 1e-6, lim, flimit)

    two_pass = ((pcpdrp * dt) > (0.0001 * 1000.0 * (-ZSOIL[0]) * smcmax)) \
        | (fac2 > flimit)

    # pass A (always; the single-call scheme)
    a = srt_sstep(sh2o, sh2o, smc, sice, cmc, pcpdrp, edir, et, dt, smcmax,
                  smcwlt, bexp, dksat, dwsat, slope, kdt, frzfact, shdfac,
                  rhsct)
    # pass B (the Kalnay-Kanamitsu averaged-coefficient second call)
    sh2oa = (sh2o + a[0]) * 0.5
    b = srt_sstep(sh2o, sh2oa, smc, sice, cmc, pcpdrp, edir, et, dt,
                  smcmax, smcwlt, bexp, dksat, dwsat, slope, kdt, frzfact,
                  shdfac, rhsct)
    return tuple(torch.where(two_pass, vb, va) for va, vb in zip(a, b)) \
        + (drip,)


# ---------------------------------------------------------------------------
# evaporation components
# ---------------------------------------------------------------------------

def devap(etp1, smc0, shdfac, smcmax, smcdry, fxexp):
    """Direct soil evaporation (lsm_noahlsm.f90:1160-1199)."""
    sratio = (smc0 - smcdry) / (smcmax - smcdry)
    fx = torch.where(
        sratio > 0.,
        torch.clamp(pw.pow(torch.clamp(sratio, min=1e-9), fxexp), 0., 1.),
        0.)
    return fx * (1.0 - shdfac) * etp1


def transp(etp1, sh2o, cmc, shdfac, smcwlt, pc, smcref, nroot_mask,
           rtdis):
    """Transpiration per layer (lsm_noahlsm.f90:4064-4167). ``nroot_mask``
    (4, ny, nx) is 1.0 where the layer lies in the root zone."""
    cmc_ratio = torch.clamp(cmc * inv(NP.CMCMAX), 0.0, 1.0)
    etp1a = torch.where(cmc != 0.0,
                        shdfac * pc * etp1 * (1.0 - cmc_ratio ** NP.CFACTR),
                        shdfac * pc * etp1)
    gx = torch.clamp((sh2o - smcwlt) / (smcref - smcwlt), 0., 1.) \
        * nroot_mask
    nroot = torch.clamp(pw.sum0(nroot_mask), min=1.0)
    sgx = pw.sum0(gx) / nroot
    rtx = rtdis + gx - sgx[None]
    gx = gx * torch.clamp(rtx, min=0.) * nroot_mask
    denom = pw.sum0(gx)
    denom = torch.where(denom <= 0.0, 1.0, denom)
    return etp1a[None] * gx / denom[None]


def evapo(smc, cmc, etp1, sh2o, pc, shdfac, smcmax, smcwlt, smcref,
          smcdry, fxexp, dt, nroot_mask, rtdis):
    """The split of evapotranspiration (EVAPO, lsm_noahlsm.f90:1294-1379).
    Returns (eta1, edir, ec, et)."""
    pos = etp1 > 0.0
    edir = torch.where(pos & (shdfac < 1.),
                       devap(etp1, smc[0], shdfac, smcmax, smcdry, fxexp),
                       0.0)
    et = torch.where(pos[None] & (shdfac[None] > 0.0),
                     transp(etp1, sh2o, cmc, shdfac, smcwlt, pc, smcref,
                            nroot_mask, rtdis), 0.0)
    ett = pw.sum0(et)
    ec = torch.where(pos & (shdfac > 0.0) & (cmc > 0.0),
                     shdfac * torch.clamp(cmc * inv(NP.CMCMAX), 0., 1.)
                     ** NP.CFACTR * etp1, 0.0)
    ec = torch.minimum(cmc / dt, ec)
    return edir + ett + ec, edir, ec, et


def canres(solar, ch, sfctmp, q2, sfcprs, sh2o, smcwlt, smcref, rsmin,
           rgl, hs, xlai, emissi, dqsdt2, q2sat, nroot_mask, topt,
           rsmax):
    """Jarvis canopy resistance and the plant coefficient (CANRES,
    lsm_noahlsm.f90:980-1116)."""
    SLV = 2.501e6
    lai = torch.clamp(xlai, min=1e-6)
    ff = 0.55 * 2.0 * solar / (rgl * lai)
    rcs = torch.clamp((ff + rsmin * inv(rsmax)) / (1.0 + ff), min=0.0001)
    dtop = topt - sfctmp
    rct = torch.clamp(1.0 - 0.0016 * (dtop * dtop), min=0.0001)
    rcq = torch.clamp(1.0 / (1.0 + hs * (q2sat - q2)), min=0.01)
    gx = torch.clamp((sh2o - smcwlt) / (smcref - smcwlt), 0., 1.)
    # soil-depth weights over the root zone
    dz_frac = torch.as_tensor(np.concatenate([[ZSOIL[0]], np.diff(ZSOIL)]),
                              dtype=smcwlt.dtype, device=smcwlt.device)
    wz = dz_frac[:, None, None] * nroot_mask
    zroot = pw.sum0(wz)
    w = wz / torch.where(zroot == 0, 1.0, zroot)[None]
    rcsoil = torch.clamp(pw.sum0(w * gx), min=0.0001)
    rc = rsmin / (lai * rcs * rct * rcq * rcsoil)
    t2 = sfctmp * sfctmp
    rr = (4. * emissi * SIGMA * RD * inv(CP)) * (t2 * t2) / (sfcprs * ch) \
        + 1.0
    delta = (SLV / CP) * dqsdt2
    pc = (rr + delta) / (rr * (1. + rc * ch) + delta)
    return rc, pc


def penman(sfctmp, sfcprs, ch, t2v, th2, prcp, fdown, ssoil, q2, q2sat,
           dqsdt2, snowng, frzgra, emissi, sncovr):
    """Potential evaporation (PENMAN, lsm_noahlsm.f90:2034-2149).
    Returns (etp, rch, epsca, rr, t24, flx2)."""
    ELCP = 2.4888e3
    CP_P = 1004.6
    elcp1 = (1.0 - sncovr) * ELCP + sncovr * ELCP * LSUBS * inv(LSUBC)
    lvs = (1.0 - sncovr) * LSUBC + sncovr * LSUBS
    delta = elcp1 * dqsdt2
    t2 = sfctmp * sfctmp
    t24 = t2 * t2
    rr = emissi * t24 * 6.48e-8 / (sfcprs * ch) + 1.0
    rho = sfcprs / (RD * t2v)
    rch = rho * CP_P * ch
    rr = rr + torch.where(snowng, CPICE * prcp / rch,
                          torch.where(prcp > 0.0, CPH2O * prcp / rch, 0.0))
    fnet = fdown - emissi * SIGMA * t24 - ssoil
    flx2 = torch.where(frzgra, -LSUBF * prcp, 0.0)
    fnet = fnet - flx2
    rad = fnet / rch + th2 - sfctmp
    a = elcp1 * (q2sat - q2)
    epsca = (a * rr + rad * delta) / (delta + rr)
    etp = epsca * rch / lvs
    return etp, rch, epsca, rr, t24, flx2


# ---------------------------------------------------------------------------
# the land-surface step (SFLX, lsm_noahlsm.f90:64-859)
# ---------------------------------------------------------------------------

def device_tables(tables, device) -> Dict[str, torch.Tensor]:
    """The vegetation and soil columns of ``tables`` (a
    ``noah_params.NoahTables``) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in vars(tables).items() if isinstance(v, np.ndarray)}


def sflx(tables, ffrozp, dt, zlvl, lwdn, soldn, solnet, sfcprs, prcp,
         sfctmp, q2, th2, q2sat, dqsdt2, vegtyp, soiltyp, shdfac_in,
         alb_in, snoalb, tbot, ch, cmc, t1, stc, smc, sh2o, snowh,
         sneqv, snotime1):
    """One Noah step on every cell (the caller applies the land mask).
    Every argument is (ny, nx) except stc, smc, sh2o (4, ny, nx);
    ``vegtyp`` and ``soiltyp`` are integer category tensors. Returns a
    dict of the updated state and the fluxes."""
    T = device_tables(tables, stc.device)
    slopetyp = 1   # lsm_noahdrv.f90:610
    veg = vegtyp.long()
    soil = soiltyp.long()

    # --- REDPRM (lsm_noahlsm.f90:2152-2372) -----------------------------
    bexp = T["bb"][soil]
    dksat = T["satdk"][soil]
    dwsat = T["satdw"][soil]
    psisat = T["satpsi"][soil]
    quartz = T["qtz"][soil]
    smcdry = T["drysmc"][soil]
    smcmax = T["maxsmc"][soil]
    smcref = T["refsmc"][soil]
    smcwlt = T["wltsmc"][soil]
    kdt = NP.REFKDT * dksat * inv(NP.REFDK)
    slope = float(np.float32(NP.SLOPE_DATA[slopetyp]))
    frzfact = (smcmax / smcref) * (0.412 / 0.468)
    frzx = NP.FRZK * frzfact
    nroot = T["nroot"][veg]
    snup = T["snup"][veg]
    rsmin = T["rs"][veg]
    rgl = T["rgl"][veg]
    hs = T["hs"][veg]
    emissmin, emissmax = T["emissmin"][veg], T["emissmax"][veg]
    laimin, laimax = T["laimin"][veg], T["laimax"][veg]
    z0min, z0max = T["z0min"][veg], T["z0max"][veg]
    albedomin, albedomax = T["albedomin"][veg], T["albedomax"][veg]
    shdfac = torch.where(vegtyp == NP.BARE, 0.0, shdfac_in)

    # urban overrides (lsm_noahlsm.f90:418-425)
    urban = vegtyp == NP.ISURBAN
    shdfac = torch.where(urban, 0.05, shdfac)
    rsmin = torch.where(urban, 400.0, rsmin)
    smcmax = torch.where(urban, 0.45, smcmax)
    smcref = torch.where(urban, 0.42, smcref)
    smcwlt = torch.where(urban, 0.40, smcwlt)
    smcdry = torch.where(urban, 0.40, smcdry)

    # emissivity, LAI, albedo and z0 interpolated by shdfac (SHDMIN=0,
    # SHDMAX=1 as allocated in lsm_driver.f90:504-507)
    frac = torch.clamp(shdfac, 0.0, 1.0)
    embrd = (1. - frac) * emissmin + frac * emissmax
    xlai = (1. - frac) * laimin + frac * laimax
    alb = (1. - frac) * albedomax + frac * albedomin
    z0brd = (1. - frac) * z0min + frac * z0max

    kidx = torch.arange(NSOIL, device=stc.device)[:, None, None]
    nroot_mask = (kidx < nroot[None]).to(stc.dtype)
    zsoil_t = torch.as_tensor(ZSOIL, device=stc.device)
    znroot = zsoil_t[torch.clamp(nroot - 1, min=0).long()]
    rtdis = (torch.as_tensor(NP.DZS, dtype=stc.dtype,
                             device=stc.device)[:, None, None]
             / (-znroot)[None]) * nroot_mask

    # --- snowpack init (lsm_noahlsm.f90:476-540) ------------------------
    no_snow0 = sneqv <= 1e-7
    sneqv = torch.where(no_snow0, 0.0, sneqv)
    snowh = torch.where(no_snow0, 0.0, snowh)
    sndens = torch.where(no_snow0, 0.0,
                         sneqv / torch.clamp(snowh, min=1e-9))
    sncond = torch.where(no_snow0, 1.0, csnow(sndens))

    precip_on = prcp > 0.0
    snowng = precip_on & (ffrozp > 0.5)
    frzgra = precip_on & ~snowng & (t1 <= TFREEZ)
    any_fr = snowng | frzgra
    sn_new = prcp * dt * 0.001
    sneqv = torch.where(any_fr, sneqv + sn_new, sneqv)
    snowh_n, sndens_n = snow_new(sfctmp, sn_new, snowh, sndens)
    snowh = torch.where(any_fr, snowh_n, snowh)
    sndens = torch.where(any_fr, sndens_n, sndens)
    sncond = torch.where(any_fr, csnow(sndens), sncond)
    prcpf = torch.where(any_fr, 0.0, prcp)

    # --- snow cover and albedo (lsm_noahlsm.f90:543-576) ----------------
    snowpack = sneqv > 0.0
    sncovr = torch.where(snowpack,
                         torch.clamp(snfrac(sneqv, snup, NP.SALP, snowh),
                                     max=0.98), 0.0)
    alb_snow, emissi_snow, snotime1 = alcalc(alb, snoalb, sncovr, snowng,
                                             snotime1, dt, embrd)
    albedo = torch.where(snowpack, alb_snow, alb)
    emissi = torch.where(snowpack, emissi_snow, embrd)

    # --- thermal conductivity and the first soil heat flux (:577-650) ---
    df1 = tdfcnd(smc[0], quartz, smcmax, sh2o[0])
    df1 = torch.where(urban, 3.24, df1)
    df1 = df1 * torch.exp(NP.SBETA * shdfac)
    df1 = torch.where(sncovr > 0.97, sncond, df1)
    dsoil = -0.5 * ZSOIL[0]
    dtot = snowh + dsoil
    frcsno = snowh / dtot
    frcsoi = dsoil / dtot
    df1a = frcsno * sncond + frcsoi * df1
    df1_snow = df1a * sncovr + df1 * (1.0 - sncovr)
    df1 = torch.where(snowpack, df1_snow, df1)
    ssoil = torch.where(snowpack,
                        df1 * (t1 - stc[0]) / dtot,
                        df1 * (t1 - stc[0]) * inv(dsoil))

    z0 = torch.where(sncovr > 0., snowz0(sncovr, z0brd, snowh), z0brd)

    # --- PENMAN + CANRES (:655-720) -------------------------------------
    fdown = solnet + lwdn
    t2v = sfctmp * (1.0 + 0.61 * q2)
    etp, rch, epsca, rr, t24, flx2 = penman(
        sfctmp, sfcprs, ch, t2v, th2, prcp, fdown, ssoil, q2, q2sat,
        dqsdt2, snowng, frzgra, emissi, sncovr)
    veg_on = (shdfac > 0.) & (xlai > 0.)
    _, pc = canres(soldn, ch, sfctmp, q2, sfcprs, sh2o[0], smcwlt,
                   smcref, rsmin, rgl, hs, xlai, emissi, dqsdt2, q2sat,
                   nroot_mask, NP.TOPT, NP.RSMAX)
    pc = torch.where(veg_on, pc, 0.0)

    # --- NOPAC / SNOPAC fused (:725-775; 1847-2031; 2828-3206) ----------
    prcp1_no = prcp * 0.001
    prcp1_sno = prcpf * 0.001
    etp1 = etp * 0.001
    dew = torch.where(etp <= 0.0, -etp1, 0.0)
    prcp1_no = prcp1_no + dew

    # one EVAPO (positive-etp cells; zero elsewhere)
    eta1, edir1, ec1, et1 = evapo(
        smc, cmc, etp1, sh2o, pc, shdfac, smcmax, smcwlt, smcref,
        smcdry, NP.FXEXP, dt, nroot_mask, rtdis)
    # SNOPAC scales the soil and canopy evaporation by the snow-free part
    snofrac = torch.where(snowpack, 1. - sncovr, 1.0)
    edir1 = edir1 * snofrac
    ec1 = ec1 * snofrac
    et1 = et1 * snofrac[None]
    etns1 = eta1 * snofrac
    esnow = torch.where(snowpack & (etp > 0.), etp * sncovr, 0.0)
    esnow1 = esnow * 0.001
    esnow2 = torch.where(snowpack,
                         torch.where(etp > 0., esnow1 * dt, etp1 * dt), 0.0)
    etanrg = torch.where(etp > 0.,
                         esnow * LSUBS + etns1 * 1000.0 * LSUBC,
                         etp * ((1. - sncovr) * LSUBC + sncovr * LSUBS))

    # SNOPAC snowmelt energy balance (:3008-3135)
    flx1_sno = torch.where(snowng, CPICE * prcp * (t1 - sfctmp),
                           torch.where(precip_on,
                                       CPH2O * prcp * (t1 - sfctmp), 0.0))
    denom_t12 = 1.0 + df1 / (dtot * rr * rch)
    t12a = ((fdown - flx1_sno - flx2 - emissi * SIGMA * t24) / rch
            + th2 - sfctmp - etanrg / rch) / rr
    t12b = df1 * stc[0] / (dtot * rr * rch)
    t12 = (sfctmp + t12a + t12b) / denom_t12
    frozen12 = t12 <= TFREEZ
    SNOEXP = 2.0
    ESDMIN = 1e-6
    t1_sno_frz = t12
    esd_frz = torch.clamp(sneqv - esnow2, min=0.0)
    cov2 = sncovr ** SNOEXP
    t1_sno_mlt = TFREEZ * cov2 + t12 * (1.0 - cov2)
    ssoil_sno_frz = df1 * (t1_sno_frz - stc[0]) / dtot
    ssoil_sno_mlt = df1 * (t1_sno_mlt - stc[0]) / dtot
    # the melting branch
    gone = (sneqv - esnow2) <= ESDMIN
    esd_m = sneqv - esnow2
    seh = rch * (t1_sno_mlt - th2)
    tm2 = t1_sno_mlt * t1_sno_mlt
    t14 = tm2 * tm2
    flx3_raw = torch.clamp(
        fdown - flx1_sno - flx2 - emissi * SIGMA * t14
        - ssoil_sno_mlt - seh - etanrg, min=0.0)
    ex_raw = flx3_raw * 0.001 * inv(LSUBF)
    snomlt_raw = ex_raw * dt
    melts_all = (esd_m - snomlt_raw) < ESDMIN
    ex_mlt = torch.where(gone, 0.0,
                         torch.where(melts_all, esd_m / dt, ex_raw))
    flx3 = torch.where(gone, 0.0,
                       torch.where(melts_all, ex_mlt * 1000.0 * LSUBF,
                                   flx3_raw))
    snomlt_sno = torch.where(gone, 0.0,
                             torch.where(melts_all, esd_m, snomlt_raw))
    esd_mlt = torch.where(gone, 0.0,
                          torch.where(melts_all, 0.0, esd_m - snomlt_raw))
    esd_sno = torch.where(frozen12, esd_frz, esd_mlt)
    t1_sno = torch.where(frozen12, t1_sno_frz, t1_sno_mlt)
    ssoil_sno = torch.where(frozen12, ssoil_sno_frz, ssoil_sno_mlt)
    ex = torch.where(frozen12, 0.0, ex_mlt)
    flx3 = torch.where(frozen12, 0.0, flx3)
    snomlt = torch.where(snowpack & ~frozen12, snomlt_sno, 0.0)
    prcp1_sno = prcp1_sno + ex

    # --- one SMFLX ------------------------------------------------------
    prcp1 = torch.where(snowpack, prcp1_sno, prcp1_no)
    sh2o, smc, cmc, runoff1, runoff2, runoff3, drip = smflx(
        smc, cmc, dt, prcp1, sh2o, slope, kdt, frzx, smcmax, bexp,
        smcwlt, dksat, dwsat, shdfac, edir1, ec1, et1)

    # --- one SHFLX ------------------------------------------------------
    # NOPAC's yy and zz1 (lsm_noahlsm.f90:2000-2015)
    df1_no = tdfcnd(smc[0], quartz, smcmax, sh2o[0])
    df1_no = torch.where(urban, 3.24, df1_no)
    df1_no = df1_no * torch.exp(NP.SBETA * shdfac)
    beta_no = torch.where(etp <= 0.0,
                          torch.where(etp < 0.0, 1.0, 0.0),
                          eta1 * 1000.0 / torch.clamp(etp, min=1e-20))
    yynum = fdown - emissi * SIGMA * t24
    yy_no = sfctmp + (yynum / rch + th2 - sfctmp - beta_no * epsca) / rr
    zz1_no = df1_no / (-0.5 * ZSOIL[0] * rch * rr) + 1.0
    # SNOPAC's (lsm_noahlsm.f90:3140-3165)
    yy_sno = stc[0] - 0.5 * ssoil_sno * ZSOIL[0] * 1.0 / df1
    yy = torch.where(snowpack, yy_sno, yy_no)
    zz1 = torch.where(snowpack, 1.0, zz1_no)
    df1_eff = torch.where(snowpack, df1, df1_no)
    csoil_loc = torch.where(urban, 3.0e6, NP.CSOIL)

    stc, sh2o = hrt_hstep(stc, smc, sh2o, smcmax, yy, zz1, tbot, NP.ZBOT,
                          psisat, dt, bexp, df1_eff, quartz, csoil_loc)

    # skin temperature and soil heat flux (SHFLX tail, :2480-2492)
    t1_no = (yy_no + (zz1_no - 1.0) * stc[0]) / zz1_no
    ssoil_no = df1_no * (stc[0] - t1_no) * inv(0.5 * ZSOIL[0])
    t1 = torch.where(snowpack, t1_sno, t1_no)
    ssoil = torch.where(snowpack, ssoil_sno, ssoil_no)
    sneqv = torch.where(snowpack, esd_sno, sneqv)

    # snow compaction or removal (SNOPAC tail, :3180-3200)
    has_snow = snowpack & (sneqv > 0.)
    snowh_c, _ = snowpack_compact(sneqv, dt, snowh, sndens, t1, yy)
    snowh = torch.where(has_snow, snowh_c,
                        torch.where(snowpack, 0.0, snowh))
    sncovr = torch.where(snowpack & ~has_snow, 0.0, sncovr)

    # --- the flux accounting (SFLX tail, :775-855) ----------------------
    etns = etns1 * 1000.0
    eta_kinematic = torch.where(snowpack, esnow + etns, eta1 * 1000.0)
    flx1 = torch.where(snowpack, flx1_sno, CPH2O * prcp * (t1 - sfctmp))
    flx3 = torch.where(snowpack, flx3, 0.0)
    q1 = q2 + eta_kinematic * CP / rch
    sheat = -(ch * CP * sfcprs) / (R * t2v) * (th2 - t1)

    edir = edir1 * 1000.0 * LVH2O
    ec = ec1 * 1000.0 * LVH2O
    ett = pw.sum0(et1) * 1000.0 * LVH2O
    esnow_w = esnow * LSUBS
    etp_w = etp * ((1. - sncovr) * LVH2O + sncovr * LSUBS)
    eta = torch.where(etp_w > 0., edir + ec + ett + esnow_w, etp_w)
    beta = torch.where(etp_w == 0.0, 0.0, eta / etp_w)
    ssoil = -1.0 * ssoil
    runoff3 = runoff3 / dt
    runoff2 = runoff2 + runoff3
    soilm = pw.sum0(smc * torch.as_tensor(
        NP.DZS, dtype=smc.dtype, device=smc.device)[:, None, None])

    return dict(cmc=cmc, t1=t1, stc=stc, smc=smc, sh2o=sh2o, snowh=snowh,
                sneqv=sneqv, sncovr=sncovr, albedo=albedo, emissi=emissi,
                z0=z0, snotime1=snotime1, eta=eta, sheat=sheat,
                eta_kinematic=eta_kinematic, etp=etp_w, ssoil=ssoil,
                runoff1=runoff1, runoff2=runoff2, snomlt=snomlt, q1=q1,
                soilm=soilm, beta=beta, drip=drip, flx1=flx1, flx2=flx2,
                flx3=flx3)


# ---------------------------------------------------------------------------
# the grid driver (lsm_noah, lsm_noahdrv.f90:36-1018 + lsm_driver.f90 glue)
# ---------------------------------------------------------------------------

def sat_spec_hum(t, p):
    """Saturation specific humidity via the driver's A2/A3/A4 form
    (lsm_noahdrv.f90:401 + sat_mr)."""
    from .mp_simple import sat_mr
    mr = sat_mr(t, p)
    return mr / (1.0 + mr)


def noah_driver(tables, dz0, qv0, p_i0, p_i1, t0, exner0, psfc, tsk, chs,
                glw, swdown, albedo_prev, emiss_prev, precip_delta, dt,
                vegtyp, soiltyp, shdfac, snoalb, tbot, land,
                cmc, stc, smc, sh2o, sneqv_mm, snowh, sncovr_prev,
                snotime1, z0brd_state):
    """One Noah step over the grid (lsm_noah, lsm_noahdrv.f90:612-1010).

    dz0/qv0/t0/exner0: the lowest atmospheric layer; p_i0/p_i1 the
    interface pressures below and above it; precip_delta [kg m-2] since the
    last call; chs the conductance [m/s] (already times the wind speed);
    sneqv_mm the SWE in mm; ``vegtyp``/``soiltyp`` integer tensors.
    ``land`` is a boolean mask; other cells pass through unchanged.

    Returns a dict of the updated fields and fluxes (hfx, qfx
    [kg m-2 s-1], lh)."""
    A2, A3, A4 = 17.67, 273.15, 29.65
    A23M4 = A2 * (A3 - A4)

    psfc_eff = p_i0
    sfcprs = 0.5 * (p_i0 + p_i1)
    q2k = qv0 / (1.0 + qv0)
    sfctmp = t0
    zlvl = 0.5 * dz0
    capa = RD / CP
    apes = pw.pow(1e5 / psfc_eff, capa)
    apelm = pw.pow(1e5 / sfcprs, capa)
    th2 = sfctmp * apelm / apes

    emissi = emiss_prev
    lwdn = glw * emissi
    soldn = swdown
    solnet = soldn * (1. - albedo_prev)
    prcp = precip_delta / dt

    q2sat = sat_spec_hum(sfctmp, sfcprs)
    da = sfctmp - A4
    dqsdt2 = q2sat * A23M4 / (da * da)

    # snow-on-ground saturation adjustments (lsm_noahdrv.f90:744-762)
    snow_mask = sneqv_mm > 0.0
    e2sat = 611.2 * torch.exp(6174. * (1. / 273.15 - 1. / sfctmp))
    q2sati = 0.622 * e2sat / (sfcprs - e2sat)
    q2sati = q2sati / (1.0 + q2sati)
    warm_gr = tsk > 273.14
    q2sat = torch.where(snow_mask,
                        torch.where(warm_gr,
                                    q2sat * (1. - sncovr_prev)
                                    + q2sati * sncovr_prev, q2sati), q2sat)
    t_sq = sfctmp * sfctmp
    dqsdt2_sno = torch.where(
        warm_gr,
        dqsdt2 * (1. - sncovr_prev) + q2sati * 6174. / t_sq * sncovr_prev,
        q2sati * 6174. / t_sq)
    dqsdt2 = torch.where(snow_mask, dqsdt2_sno, dqsdt2)
    dqsdt2 = torch.where(snow_mask & (tsk > 273.) & (sncovr_prev > 0.),
                         dqsdt2 * (1. - sncovr_prev), dqsdt2)

    ffrozp = torch.where(sfctmp <= 273.15, 1.0, 0.0)
    # snow depth re-derived where missing or thinner than its own SWE
    # (lsm_noahdrv.f90:803-806)
    sneqv_m = sneqv_mm * 0.001
    snowh = torch.where(((sneqv_m != 0.) & (snowh == 0.))
                        | (snowh <= sneqv_m), 5.0 * sneqv_m, snowh)
    soiltyp = torch.where(soiltyp == 14, 7, soiltyp)   # water soil on land
    shdfac = torch.where((vegtyp == 25) | (vegtyp == 26) | (vegtyp == 27),
                         0.0, shdfac)
    glacier = vegtyp == NP.ISICE

    out = sflx(tables, ffrozp, dt, zlvl, lwdn, soldn, solnet, sfcprs,
               prcp, sfctmp, q2k, th2, q2sat, dqsdt2, vegtyp, soiltyp,
               shdfac, albedo_prev, snoalb, tbot, chs, cmc, tsk, stc,
               smc, sh2o, snowh, sneqv_m, snotime1)

    apply = land & ~glacier

    def sel2(new, old):
        return torch.where(apply, new, old)

    def sel3(new, old):
        return torch.where(apply[None], new, old)

    q1 = out["q1"]
    qsfc_mr = q1 / (1.0 - q1)
    return dict(
        skin_temperature=sel2(out["t1"], tsk),
        canopy_water=sel2(out["cmc"], cmc),
        swe=sel2(out["sneqv"] * 1000.0, sneqv_mm),
        snow_height=sel2(out["snowh"], snowh),
        snow_cover=sel2(out["sncovr"], sncovr_prev),
        albedo=sel2(out["albedo"], albedo_prev),
        emissivity=sel2(out["emissi"], emiss_prev),
        roughness=sel2(out["z0"], z0brd_state),
        snotime=sel2(out["snotime1"], snotime1),
        soil_temperature=sel3(out["stc"], stc),
        soil_water_content=sel3(out["smc"], smc),
        soil_liquid_water=sel3(out["sh2o"], sh2o),
        hfx=torch.where(apply, out["sheat"], 0.0),
        qfx=torch.where(apply, out["eta_kinematic"], 0.0),
        lh=torch.where(apply, out["eta"], 0.0),
        ground_heat_flux=torch.where(apply, out["ssoil"], 0.0),
        qsfc=torch.where(apply, qsfc_mr, qv0),
        runoff_surface=torch.where(apply, out["runoff1"] * dt * 1000.0,
                                   0.0),
        runoff_subsurface=torch.where(apply,
                                      out["runoff2"] * dt * 1000.0, 0.0),
        snowmelt=torch.where(apply, out["snomlt"] * 1000.0, 0.0),
    )

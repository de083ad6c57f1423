"""Noah-MP land-surface model (lsm=4) (icar_tpu/physics/noahmp.py:
MODULE_SF_NOAHMPLSM for the option set ICAR hardwires, lsm_driver.f90
:773-793): dveg=1 (table LAI, FVEG=SHDFAC), Ball-Berry stomata, Noah
beta, SIMGM runoff and groundwater, Monin-Obukhov surface exchange
(SFCDIF1), NY06 supercooled water and frozen-soil permeability, iopt_rad=1
canopy gaps, BATS snow albedo, the Jordan91 rain/snow partition, Noah
TBOT and semi-implicit snow/soil temperature.

Plain PyTorch: each routine is masked array math over the (ny, nx) grid
with the snow/soil stack on axis 0 (3 snow + 4 soil = 7 layers; stack
index m = j + NSNOW - 1 for the reference's layer index j in [-2..4]).
The flux solvers keep their fixed trip counts (VEGE_FLUX's 20 canopy and
5 ground Newton steps, BARE_FLUX's 5) and the per-column EXITs stay
masks, as in the JAX package, so nothing is read back to the host. The
JAX package's ``.at[...]`` updates are out-of-place writes here (a clone
with one row replaced, or a select). Divisions by a constant are products
with its float32 reciprocal (``pointwise.inv``), as the JAX package's
compiled step divides; ``dt`` is a 0-d float32 tensor (a number in the
tests).

``noahmp_init_state`` is numpy, a copy of the JAX package's held by
tests/test_torch_setup.py.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .noahmp_params import NSNOW, NSOIL

NSS = NSNOW + NSOIL          # 7-layer snow+soil stack

# module constants (lsm_noahmplsm.f90:192-208)
GRAV = 9.80616
SB = 5.67e-8
VKC = 0.40
TFRZ = 273.16
HSUB = 2.8440e6
HVAP = 2.5104e6
HFUS = 0.3336e6
CWAT = 4.188e6
CICE = 2.094e6
CPAIR = 1004.64
TKWAT = 0.6
TKICE = 2.2
TKAIR = 0.023
RAIR = 287.04
RW = 461.269
DENH2O = 1000.0
DENICE = 917.0

MPE = 1e-6    # prevents division by zero (used throughout the reference)


# --------------------------------------------------------------------------
# small helpers: the JAX package's jnp forms, rounded as XLA rounds them
# --------------------------------------------------------------------------

def _rdiv(c, x):
    """``c / x`` for a number ``c``: one IEEE division (torch forms a
    number over a tensor as the reciprocal times the number)."""
    return torch.tensor(c, dtype=x.dtype, device=x.device) / x


def _cube(x):
    """``x ** 3`` as jax.lax.integer_pow forms it."""
    return x * (x * x)


def _pow4(x):
    """``x ** 4`` as jax.lax.integer_pow forms it."""
    x2 = x * x
    return x2 * x2


def _where(c, a, b):
    """``jnp.where``; either branch may be a number (both: float32)."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        a = torch.full(c.shape, a, dtype=torch.float32, device=c.device)
    return torch.where(c, a, b)


def _set(a, i, v):
    """``a.at[i].set(v)``: a new tensor, ``a`` untouched."""
    out = a.clone()
    out[i] = v
    return out


def _add(a, i, v):
    """``a.at[i].add(v)``."""
    return _set(a, i, a[i] + v)


def _sum0(x):
    """``jnp.sum(x, axis=0)``: the rows added in order, as XLA's CPU
    reduction of a leading axis adds."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _i32(x):
    return x.to(torch.int32)


def _stack_j(dev):
    """CLM layer index j = m - NSNOW + 1 for stack axis m in [0..NSS-1]:
    j in [-2..0] snow, [1..4] soil."""
    return (torch.arange(NSS, dtype=torch.int32, device=dev)
            - (NSNOW - 1))[:, None, None]


def _active(isnow):
    """(NSS, ny, nx) mask of layers in use (j >= isnow+1)."""
    return _stack_j(isnow.device) >= isnow[None] + 1


def _snow_mask(isnow):
    j = _stack_j(isnow.device)
    return (j >= isnow[None] + 1) & (j <= 0)


def _gather_m(arr, midx):
    return take_level(arr, _i32(midx))


def _scatter_m(arr, midx, val, do):
    L = arr.shape[0]
    lay = torch.arange(L, dtype=torch.int32, device=arr.device)[:, None, None]
    hit = (lay == _i32(midx)[None]) & do[None]
    return torch.where(hit, val[None], arr)


def _dt_tensor(dt, like):
    """``dt`` as a 0-d float32 tensor on ``like``'s device."""
    return dt if torch.is_tensor(dt) else torch.tensor(
        float(dt), dtype=torch.float32, device=like.device)


# ==========================================================================
# forcing pre-processing (ATM, lsm_noahmplsm.f90:1025-1199)
# ==========================================================================

def atm(p, sfcprs, sfctmp, q2, prcp, soldn, cosz):
    """Re-process atmospheric forcing. OPT_SNF=1 (Jordan 1991) rain/snow
    partition; ICAR passes total precip only (prcpconv=0)."""
    thair = sfctmp      # PAIR == SFCPRS in the reference (jref comment)
    qair = q2
    eair = qair * sfcprs / (0.622 + 0.378 * qair)
    rhoair = (sfcprs - 0.378 * eair) / (RAIR * sfctmp)
    swdown = torch.where(cosz <= 0.0, 0.0, soldn)
    solad = torch.stack([swdown * 0.35, swdown * 0.35])   # direct vis/nir
    solai = torch.stack([swdown * 0.15, swdown * 0.15])   # diffuse vis/nir
    qprecc = 0.10 * prcp
    qprecl = 0.90 * prcp
    fp = torch.where(qprecc + qprecl > 0.0,
                     (qprecc + qprecl) / (10.0 * qprecc + qprecl + MPE), 0.0)
    # Jordan (1991) partition
    fpice = torch.where(
        sfctmp > TFRZ + 2.5, 0.0,
        _where(sfctmp <= TFRZ + 0.5, 1.0,
               torch.where(sfctmp <= TFRZ + 2.0,
                           1.0 - (-54.632 + 0.2 * sfctmp), 0.6)))
    # Hedstrom & Pomeroy (1998) fresh snow density
    bdfall = torch.clamp(67.92 + 51.25
                         * pw.exp((sfctmp - TFRZ) * inv(2.59)), max=120.0)
    rain = prcp * (1.0 - fpice)
    snow = prcp * fpice
    return SimpleNamespace(thair=thair, qair=qair, eair=eair, rhoair=rhoair,
                           swdown=swdown, solad=solad, solai=solai,
                           qprecc=qprecc, qprecl=qprecl, fp=fp, fpice=fpice,
                           bdfall=bdfall, rain=rain, snow=snow, prcp=prcp)


# ==========================================================================
# vegetation phenology (PHENOLOGY, :1201-1307)
# ==========================================================================

def phenology(p, vegtype, snowh, tv, lat, yearlen, julian):
    """Monthly-table LAI/SAI (dveg=1) + burial by snow. Returns
    (lai, sai, elai, esai, igs). ``yearlen`` and ``julian`` are numbers or
    tensors (0-d or per cell)."""
    yearlen = _dt_tensor(yearlen, lat)
    julian = _dt_tensor(julian, lat)
    day = torch.where(lat >= 0.0, julian,
                      torch.remainder(julian + 0.5 * yearlen, yearlen))
    t = 12.0 * day / yearlen
    it1 = _i32(torch.floor(t + 0.5))
    it2 = it1 + 1
    wt1 = (it1.to(torch.float32) + 0.5) - t
    wt2 = 1.0 - wt1
    it1 = torch.where(it1 < 1, 12, it1)
    it2 = torch.where(it2 > 12, 1, it2)
    # p.laim is (12, ny, nx), month index 1-based
    lai = (wt1 * take_level(p.laim, it1 - 1)
           + wt2 * take_level(p.laim, it2 - 1))
    sai = (wt1 * take_level(p.saim, it1 - 1)
           + wt2 * take_level(p.saim, it2 - 1))
    sai = torch.where(sai < 0.05, 0.0, sai)
    lai = torch.where((lai < 0.05) | (sai == 0.0), 0.0, lai)
    novegcell = ((vegtype == p.iswater) | (vegtype == p.isbarren)
                 | (vegtype == p.isice) | p.urban_flag)
    lai = torch.where(novegcell, 0.0, lai)
    sai = torch.where(novegcell, 0.0, sai)

    # burial by snow
    db = torch.minimum(torch.clamp(snowh - p.hvb, min=0.0), p.hvt - p.hvb)
    fb = db / torch.clamp(p.hvt - p.hvb, min=1e-6)
    snowhc = p.hvt * pw.exp(-snowh * inv(0.2))
    fb = torch.where((p.hvt > 0.0) & (p.hvt <= 1.0),
                     torch.minimum(snowh, snowhc)
                     / torch.clamp(snowhc, min=MPE), fb)
    elai = lai * (1.0 - fb)
    esai = sai * (1.0 - fb)
    esai = torch.where(esai < 0.05, 0.0, esai)
    elai = torch.where((elai < 0.05) | (esai == 0.0), 0.0, elai)
    igs = (tv > p.tmin).to(torch.float32)
    return lai, sai, elai, esai, igs


# ==========================================================================
# canopy interception + advected precip heat (PRECIP_HEAT, :1309-1536)
# ==========================================================================

def precip_heat(p, dt, uu, vv, elai, esai, fveg, bdfall, rain, snow, fp,
                canliq, canice, tv, sfctmp, tg):
    """Split of rain/snow into interception, drip and throughfall, and the
    heat they advect to canopy/ground. Returns a namespace + updated
    canliq/canice/fwet."""
    hasveg = (elai + esai) > 0.0
    maxliq = p.ch2op * (elai + esai)

    qintr = fveg * rain * fp
    qintr = torch.minimum(
        qintr, (maxliq - canliq) / dt
        * (1.0 - pw.exp(-rain * dt / torch.clamp(maxliq, min=MPE))))
    qintr = torch.clamp(qintr, min=0.0)
    qintr = torch.where(hasveg, qintr, 0.0)
    qdripr = torch.where(hasveg, fveg * rain - qintr,
                         torch.where(canliq > 0.0, canliq / dt, 0.0))
    qthror = torch.where(hasveg, (1.0 - fveg) * rain, rain)
    canliq = torch.where(hasveg, torch.clamp(canliq + qintr * dt, min=0.0),
                         0.0)

    pah_ac = fveg * rain * (CWAT / 1000.0) * (sfctmp - tv)
    pah_cg = qdripr * (CWAT / 1000.0) * (tv - tg)
    pah_ag = qthror * (CWAT / 1000.0) * (sfctmp - tg)

    maxsno = 6.6 * (0.27 + _rdiv(46.0, bdfall)) * (elai + esai)
    qints = fveg * snow * fp
    qints = torch.minimum(
        qints, (maxsno - canice) / dt
        * (1.0 - pw.exp(-snow * dt / torch.clamp(maxsno, min=MPE))))
    qints = torch.clamp(qints, min=0.0)
    qints = torch.where(hasveg, qints, 0.0)
    ft = torch.clamp((tv - 270.15) * inv(1.87e5), min=0.0)
    fv = torch.sqrt(uu * uu + vv * vv) * inv(1.56e5)
    icedrip = torch.where(hasveg, torch.clamp(canice, min=0.0) * (fv + ft),
                          0.0)
    qdrips = torch.where(hasveg, (fveg * snow - qints) + icedrip,
                         torch.where(canice > 0.0, canice / dt, 0.0))
    qthros = torch.where(hasveg, (1.0 - fveg) * snow, snow)
    canice = torch.where(hasveg,
                         torch.clamp(canice + (qints - icedrip) * dt,
                                     min=0.0), 0.0)

    fwet = torch.where(canice > 0.0,
                       torch.clamp(canice, min=0.0)
                       / torch.clamp(maxsno, min=1e-6),
                       torch.clamp(canliq, min=0.0)
                       / torch.clamp(maxliq, min=1e-6))
    fwet = pw.pow(torch.clamp(fwet, max=1.0), 0.667)
    cmc = canliq + canice

    pah_ac = pah_ac + fveg * snow * (CICE / 1000.0) * (sfctmp - tv)
    pah_cg = pah_cg + qdrips * (CICE / 1000.0) * (tv - tg)
    pah_ag = pah_ag + qthros * (CICE / 1000.0) * (sfctmp - tg)

    pahv = pah_ac - pah_cg
    pahg = pah_cg
    pahb = pah_ag
    mid = (fveg > 0.0) & (fveg < 1.0)
    pahg = torch.where(mid, pahg / torch.clamp(fveg, min=MPE), pahg)
    pahb = torch.where(mid, pahb / torch.clamp(1.0 - fveg, min=MPE), pahb)
    noveg = fveg <= 0.0
    pahb = torch.where(noveg, pahg + pahb, pahb)
    pahg = torch.where(noveg, 0.0, pahg)
    pahv = torch.where(noveg, 0.0, pahv)
    pahb = torch.where(fveg >= 1.0, 0.0, pahb)
    pahv = torch.clamp(pahv, -20.0, 20.0)
    pahg = torch.clamp(pahg, -20.0, 20.0)
    pahb = torch.clamp(pahb, -20.0, 20.0)

    qrain = qdripr + qthror
    qsnow = qdrips + qthros
    snowhin = qsnow / bdfall
    return SimpleNamespace(
        qintr=qintr, qdripr=qdripr, qthror=qthror, qints=qints,
        qdrips=qdrips, qthros=qthros, pahv=pahv, pahg=pahg, pahb=pahb,
        qrain=qrain, qsnow=qsnow, snowhin=snowhin, fwet=fwet, cmc=cmc,
        canliq=canliq, canice=canice)


# ==========================================================================
# thermal properties (THERMOPROP/CSNOW/TDFCND, :2336-2615)
# ==========================================================================

def csnow(isnow, snice, snliq, dzsnso):
    """Snow bulk density -> volumetric heat capacity + conductivity
    (CSNOW; Stieglitz / Yen 1965). Snow arrays are the top NSNOW rows of
    the stack."""
    dz = torch.clamp(dzsnso[:NSNOW], min=MPE)
    snicev = torch.clamp(snice / (dz * DENICE), max=1.0)
    epore = 1.0 - snicev
    snliqv = torch.minimum(epore, snliq / (dz * DENH2O))
    bdsnoi = (snice + snliq) / dz
    cvsno = CICE * snicev + CWAT * snliqv
    tksno = 3.2217e-6 * (bdsnoi * bdsnoi)
    return tksno, cvsno, snicev, snliqv, epore


def tdfcnd(p, smc, sh2o):
    """Soil thermal conductivity, Johansen as in Noah (TDFCND).
    smc/sh2o: (NSOIL, ny, nx); p.smcmax/quartz: (ny, nx)."""
    satratio = smc / p.smcmax[None]
    thks = pw.pow(7.7, p.quartz[None]) * pw.pow(2.0, 1.0 - p.quartz[None])
    xunfroz = torch.where(smc > 0.0, sh2o / torch.clamp(smc, min=MPE), 1.0)
    xu = xunfroz * p.smcmax[None]
    thksat = (pw.pow(thks, 1.0 - p.smcmax[None])
              * pw.pow(TKICE, p.smcmax[None] - xu) * pw.pow(0.57, xu))
    gammd = (1.0 - p.smcmax[None]) * 2700.0
    thkdry = (0.135 * gammd + 64.7) / (2700.0 - 0.947 * gammd)
    ake_unfrozen = torch.where(
        satratio > 0.1, pw.log10(torch.clamp(satratio, min=0.1)) + 1.0, 0.0)
    ake = torch.where((sh2o + 0.0005) < smc, satratio, ake_unfrozen)
    return ake * (thksat - thkdry) + thkdry


def _blend_top(df, dzsnso, isnow, snowh):
    """The top-soil conductivity blended with thin (layerless) snow, or
    with the bottom snow layer (:2418-2422)."""
    m0 = NSNOW - 1   # stack index of snow layer j=0
    df1_nosnow = ((df[NSNOW] * dzsnso[NSNOW] + 0.35 * snowh)
                  / (snowh + dzsnso[NSNOW]))
    df1_snow = ((df[NSNOW] * dzsnso[NSNOW] + df[m0] * dzsnso[m0])
                / torch.clamp(dzsnso[m0] + dzsnso[NSNOW], min=MPE))
    return _set(df, NSNOW, torch.where(isnow == 0, df1_nosnow, df1_snow))


def thermoprop(p, isnow, dzsnso, dt, snowh, snice, snliq, smc, sh2o):
    """Layer conductivities/heat capacities + FACT (THERMOPROP). IST=1
    (soil). Returns (df, hcpct, snicev, snliqv, epore, fact), all on the
    7-layer stack (snow part masked by isnow)."""
    tksno, cvsno, snicev, snliqv, epore = csnow(isnow, snice, snliq, dzsnso)
    sice = smc - sh2o
    hcpct_soil = (sh2o * CWAT + (1.0 - p.smcmax[None]) * p.csoil
                  + (p.smcmax[None] - smc) * CPAIR + sice * CICE)
    df_soil = tdfcnd(p, smc, sh2o)
    df_soil = torch.where(p.urban_flag[None], 3.24, df_soil)
    df = torch.cat([tksno, df_soil], 0)
    hcpct = torch.cat([cvsno, hcpct_soil], 0)
    fact = dt / (torch.clamp(hcpct, min=MPE) * torch.clamp(dzsnso, min=MPE))
    df = _blend_top(df, dzsnso, isnow, snowh)
    return df, hcpct, snicev, snliqv, epore, fact


# ==========================================================================
# radiation (RADIATION/ALBEDO/TWOSTREAM/SURRAD etc., :2617-3525)
# ==========================================================================

def snow_age(p, dt, tg, sneqvo, sneqv, tauss):
    """BATS non-dimensional snow age (SNOW_AGE; Yang et al. 1997)."""
    dela0 = dt * inv(p.tau0)
    arg = p.grain_growth * (1.0 / TFRZ - 1.0 / tg)
    age1 = pw.exp(arg)
    age2 = pw.exp(torch.clamp(p.extra_growth * arg, max=0.0))
    tage = age1 + age2 + p.dirt_soot
    dela = dela0 * tage
    dels = torch.clamp(sneqv - sneqvo, min=0.0) * inv(p.swemx)
    sge = (tauss + dela) * (1.0 - dels)
    tauss = torch.where(sneqv <= 0.0, 0.0, torch.clamp(sge, min=0.0))
    fage = tauss / (tauss + 1.0)
    return tauss, fage


def snowalb_bats(p, cosz, fage):
    """BATS snow albedo, direct/diffuse x vis/nir (SNOWALB_BATS)."""
    sl = p.bats_cosz
    cf1 = _rdiv(1.0 + 1.0 / sl, 1.0 + 2.0 * sl * cosz) - 1.0 / sl
    fzen = torch.clamp(cf1, min=0.0)
    albsni = torch.stack([p.bats_vis_new * (1.0 - p.bats_vis_age * fage),
                          p.bats_nir_new * (1.0 - p.bats_nir_age * fage)])
    albsnd = albsni + p.bats_vis_dir * fzen[None] * (1.0 - albsni)
    return albsnd, albsni


def groundalb(p, fsno, smc1, albsnd, albsni):
    """Bare ground + snow composite albedo (GROUNDALB, IST=1 soil)."""
    inc = torch.clamp(0.11 - 0.40 * smc1, min=0.0)
    albsod = torch.minimum(p.albsat + inc[None], p.albdry)
    albgrd = albsod * (1.0 - fsno[None]) + albsnd * fsno[None]
    albgri = albsod * (1.0 - fsno[None]) + albsni * fsno[None]
    return albgrd, albgri


def twostream(p, ib, ic, cosz, vai, fwet, t, albg, rho, tau, fveg):
    """Dickinson/Sellers two-stream canopy radiative transfer with the
    Niu & Yang (2004) gap treatment (TWOSTREAM, :3276-3523; OPT_RAD=1).

    albg: relevant ground albedo (direct for ic=0, diffuse for ic=1),
    rho/tau: band values (ny, nx). Returns (fab, fre, ftd, fti, gdir,
    frev, freg, bgap, wgap)."""
    pai = np.pi
    rc2 = p.rc * p.rc
    denfveg = -pw.log(torch.clamp(1.0 - fveg, min=0.01)) / (pai * rc2)
    hd = p.hvt - p.hvb
    bb = 0.5 * hd
    thetap = torch.atan(bb / torch.clamp(p.rc, min=MPE)
                        * torch.tan(torch.acos(torch.clamp(cosz,
                                                           min=0.01))))
    bgap = pw.exp(-denfveg * pai * rc2
                  / torch.clamp(torch.cos(thetap), min=MPE))
    fa = vai / torch.clamp(
        1.33 * pai * _cube(p.rc) * (bb / torch.clamp(p.rc, min=MPE))
        * denfveg, min=MPE)
    newvai = hd * fa
    wgap = (1.0 - bgap) * pw.exp(-0.5 * newvai
                                 / torch.clamp(cosz, min=0.001))
    gap = torch.minimum(1.0 - fveg, bgap + wgap)
    kopen = torch.full_like(gap, 0.05)
    novai = vai == 0.0
    gap = torch.where(novai, 1.0, gap)
    kopen = torch.where(novai, 1.0, kopen)

    coszi = torch.clamp(cosz, min=0.001)
    chil = torch.clamp(p.xl, -0.4, 0.6)
    chil = torch.where(torch.abs(chil) <= 0.01, 0.01, chil)
    phi1 = 0.5 - 0.633 * chil - 0.330 * chil * chil
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    gdir = phi1 + phi2 * coszi
    ext = gdir / coszi
    avmu = (1.0 - phi1 / phi2 * pw.log((phi1 + phi2)
                                       / torch.clamp(phi1, min=MPE))) / phi2
    omegal = rho + tau
    tmp0 = gdir + phi2 * coszi
    tmp1 = phi1 * coszi
    asu = (0.5 * omegal * gdir / tmp0
           * (1.0 - tmp1 / tmp0
              * pw.log((tmp1 + tmp0) / torch.clamp(tmp1, min=MPE))))
    betadl = (1.0 + avmu * ext) / (omegal * avmu * ext) * asu
    betail = 0.5 * (rho + tau + (rho - tau)
                    * (((1.0 + chil) * 0.5) * ((1.0 + chil) * 0.5))) \
        / omegal
    # adjust for intercepted snow (frozen canopy)
    omegas_b = float(p.omegas[ib])
    frozen = t <= TFRZ
    om_f = (1.0 - fwet) * omegal + fwet * omegas_b
    bd_f = ((1.0 - fwet) * omegal * betadl
            + fwet * omegas_b * p.betads) / om_f
    bi_f = ((1.0 - fwet) * omegal * betail
            + fwet * omegas_b * p.betais) / om_f
    omega = torch.where(frozen, om_f, omegal)
    betad = torch.where(frozen, bd_f, betadl)
    betai = torch.where(frozen, bi_f, betail)

    b = 1.0 - omega + omega * betai
    c = omega * betai
    tmp0 = avmu * ext
    d = tmp0 * omega * betad
    f = tmp0 * omega * (1.0 - betad)
    tmp1 = b * b - c * c
    h = torch.sqrt(torch.clamp(tmp1, min=0.0)) / avmu
    sigma = tmp0 * tmp0 - tmp1
    sigma = torch.where(torch.abs(sigma) < 1e-6,
                        _where(sigma >= 0, 1e-6, -1e-6), sigma)
    p1 = b + avmu * h
    p2 = b - avmu * h
    p3 = b + tmp0
    p4 = b - tmp0
    s1 = pw.exp(-torch.clamp(h * vai, max=50.0))
    s2 = pw.exp(-torch.clamp(ext * vai, max=50.0))
    u1 = b - c / torch.clamp(albg, min=MPE)
    u2 = b - c * albg
    u3 = f + c * albg
    tmp2 = u1 - avmu * h
    tmp3 = u1 + avmu * h
    d1 = p1 * tmp2 / s1 - p2 * tmp3 * s1
    tmp4 = u2 + avmu * h
    tmp5 = u2 - avmu * h
    d2 = tmp4 / s1 - tmp5 * s1
    h1 = -d * p4 - c * f
    tmp6 = d - h1 * p3 / sigma
    tmp7 = (d - c - h1 / sigma * (u1 + tmp0)) * s2
    h2 = (tmp6 * tmp2 / s1 - p2 * tmp7) / d1
    h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1
    h4 = -f * p3 - c * d
    tmp8 = h4 / sigma
    tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2
    h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2
    h6 = (tmp8 * tmp5 * s1 + tmp9) / d2
    h7 = (c * tmp2) / (d1 * s1)
    h8 = (-c * tmp3 * s1) / d1
    h9 = tmp4 / (d2 * s1)
    h10 = (-tmp5 * s1) / d2

    if ic == 0:
        ftd = s2 * (1.0 - gap) + gap
        fti = (h4 * s2 / sigma + h5 * s1 + h6 / s1) * (1.0 - gap)
        fre = (h1 / sigma + h2 + h3) * (1.0 - gap) + albg * gap
        frev = (h1 / sigma + h2 + h3) * (1.0 - gap)
        freg = albg * gap
    else:
        ftd = torch.zeros_like(s2)
        fti = (h9 * s1 + h10 / s1) * (1.0 - kopen) + kopen
        fre = (h7 + h8) * (1.0 - kopen) + albg * kopen
        frev = fre
        freg = torch.zeros_like(fre)
    fab = 1.0 - fre - (1.0 - albg) * ftd - (1.0 - albg) * fti
    return SimpleNamespace(fab=fab, fre=fre, ftd=ftd, fti=fti, gdir=gdir,
                           frev=frev, freg=freg, bgap=bgap, wgap=wgap)


def albedo_rad(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet, smc1,
               sneqvo, sneqv, fveg, tauss, vegtype):
    """Surface albedos + canopy fluxes per unit radiation (ALBEDO) and
    the absorbed-flux partition (SURRAD wiring happens in radiation()).
    Returns a namespace; all band arrays are (2, ny, nx)."""
    vai = elai + esai
    wl = elai / torch.clamp(vai, min=MPE)
    ws = esai / torch.clamp(vai, min=MPE)
    rho = torch.clamp(p.rhol * wl[None] + p.rhos * ws[None], min=MPE)
    tau = torch.clamp(p.taul * wl[None] + p.taus * ws[None], min=MPE)

    tauss, fage = snow_age(p, dt, tg, sneqvo, sneqv, tauss)
    albsnd, albsni = snowalb_bats(p, cosz, fage)
    albgrd, albgri = groundalb(p, fsno, smc1, albsnd, albsni)

    keys = ("fabd", "albd", "ftdd", "ftid", "frevd", "fregd",
            "fabi", "albi", "ftdi", "ftii", "frevi", "fregi")
    bands = {k: [] for k in keys}
    gdir = bgap = wgap = None
    for ib in range(2):
        td = twostream(p, ib, 0, cosz, vai, fwet, tv, albgrd[ib],
                       rho[ib], tau[ib], fveg)
        ti = twostream(p, ib, 1, cosz, vai, fwet, tv, albgri[ib],
                       rho[ib], tau[ib], fveg)
        # FAB mixes direct & diffuse ground albedo terms (:3500-3501)
        fab_d = (1.0 - td.fre - (1.0 - albgrd[ib]) * td.ftd
                 - (1.0 - albgri[ib]) * td.fti)
        fab_i = (1.0 - ti.fre - (1.0 - albgrd[ib]) * ti.ftd
                 - (1.0 - albgri[ib]) * ti.fti)
        for k, v in zip(keys, (fab_d, td.fre, td.ftd, td.fti, td.frev,
                               td.freg, fab_i, ti.fre, ti.ftd, ti.fti,
                               ti.frev, ti.freg)):
            bands[k].append(v)
        if ib == 0:
            gdir = td.gdir
            bgap, wgap = td.bgap, td.wgap
    out = SimpleNamespace(albgrd=albgrd, albgri=albgri, albsnd=albsnd,
                          albsni=albsni, tauss=tauss, bgap=bgap, wgap=wgap,
                          **{k: torch.stack(v) for k, v in bands.items()
                             if k != "ftdi"})

    # sunlit canopy fraction
    ext = gdir / torch.clamp(cosz, min=0.001) * torch.sqrt(
        torch.clamp(1.0 - rho[0] - tau[0], min=0.0))
    fsun = (1.0 - pw.exp(-torch.clamp(ext * vai, max=50.0))) \
        / torch.clamp(ext * vai, min=MPE)
    fsun = torch.where(fsun < 0.01, 0.0, fsun)
    # zero everything when the sun is down (:2860-2874 GOTO 100)
    dark = cosz <= 0.0
    for k in ("albd", "albi", "fabd", "fabi", "ftdd", "ftid", "ftii",
              "albgrd", "albgri", "albsnd", "albsni", "frevd", "fregd",
              "frevi", "fregi"):
        out.__dict__[k] = torch.where(dark[None], 0.0, out.__dict__[k])
    out.fsun = torch.where(dark, 0.0, fsun)
    return out


def radiation(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet, smc1,
              sneqvo, sneqv, fveg, tauss, vegtype, solad, solai):
    """Absorbed/reflected solar partition (RADIATION + SURRAD)."""
    a = albedo_rad(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet,
                   smc1, sneqvo, sneqv, fveg, tauss, vegtype)
    fsun = a.fsun
    fsha = 1.0 - fsun
    laisun = elai * fsun
    laisha = elai * fsha
    vai = elai + esai

    cad = solad * a.fabd
    cai = solai * a.fabi
    sav = _sum0(cad + cai)
    trd = solad * a.ftdd
    tri = solad * a.ftid + solai * a.ftii
    absg = trd * (1.0 - a.albgrd) + tri * (1.0 - a.albgri)
    sag = _sum0(absg)
    fsa = sav + sag

    laifra = elai / torch.clamp(vai, min=MPE)
    parsun = torch.where(
        fsun > 0.0,
        (cad[0] + fsun * cai[0]) * laifra / torch.clamp(laisun, min=MPE),
        0.0)
    parsha = torch.where(
        fsun > 0.0,
        (fsha * cai[0]) * laifra / torch.clamp(laisha, min=MPE),
        (cad[0] + cai[0]) * laifra / torch.clamp(laisha, min=MPE))
    fsr = _sum0(a.albd * solad + a.albi * solai)
    fsrv = _sum0(a.frevd * solad + a.frevi * solai)
    fsrg = _sum0(a.fregd * solad + a.fregi * solai)
    return SimpleNamespace(
        fsun=fsun, laisun=laisun, laisha=laisha, parsun=parsun,
        parsha=parsha, sav=sav, sag=sag, fsa=fsa, fsr=fsr, fsrv=fsrv,
        fsrg=fsrg, tauss=a.tauss, albd=a.albd, albi=a.albi,
        albsnd=a.albsnd, albsni=a.albsni, bgap=a.bgap, wgap=a.wgap)


# ==========================================================================
# saturation vapor pressure (ESAT, :4900-4951)
# ==========================================================================

_ESAT_A = [6.107799961, 4.436518521e-01, 1.428945805e-02, 2.650648471e-04,
           3.031240396e-06, 2.034080948e-08, 6.136820929e-11]
_ESAT_B = [6.109177956, 5.034698970e-01, 1.886013408e-02, 4.176223716e-04,
           5.824720280e-06, 4.838803174e-08, 1.838826904e-10]
_ESAT_C = [4.438099984e-01, 2.857002636e-02, 7.938054040e-04,
           1.215215065e-05, 1.036561403e-07, 3.532421810e-10,
           -7.090244804e-13]
_ESAT_D = [5.030305237e-01, 3.773255020e-02, 1.267995369e-03,
           2.477563108e-05, 3.005693132e-07, 2.158542548e-09,
           7.131097725e-12]


def esat(t):
    """Flatau polynomial esat & d(esat)/dT over water and ice; t in deg C
    (clamped to +-50 by callers)."""
    def poly(cf):
        r = t * float(np.float32(cf[-1]))
        r = cf[-2] + r
        for v in cf[-3::-1]:
            r = v + t * r
        return 100.0 * r
    return poly(_ESAT_A), poly(_ESAT_B), poly(_ESAT_C), poly(_ESAT_D)


def _estg(t_k):
    """esat and d/dT at temperature t_k, water above 0 C else ice."""
    t = torch.clamp(t_k - TFRZ, -50.0, 50.0)
    esw, esi, dsw, dsi = esat(t)
    warm = t > 0.0
    return torch.where(warm, esw, esi), torch.where(warm, dsw, dsi)


# ==========================================================================
# Monin-Obukhov surface exchange (SFCDIF1, :4529-4692; OPT_SFC=1)
# ==========================================================================

def _nz(x):
    return torch.where(torch.abs(x) <= MPE, MPE, x)


def _stab(m):
    t1 = pw.pow(1.0 - 16.0 * torch.clamp(m, max=0.0), 0.25)
    t2 = pw.log((1.0 + t1 * t1) * 0.5)
    t3 = pw.log((1.0 + t1) * 0.5)
    fm_u = 2.0 * t3 + t2 - 2.0 * torch.atan(t1) + 1.5707963
    fh_u = 2.0 * t2
    fm_s = -5.0 * m
    return (torch.where(m < 0.0, fm_u, fm_s),
            torch.where(m < 0.0, fh_u, fm_s))


def sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m, z0h, ur):
    """One iteration of the M-O exchange-coefficient update. ``st`` is the
    per-column iteration state dict (moz, mozsgn, fm, fh, fm2, fh2, fv);
    ``it`` is the 1-based static iteration index."""
    mozold = st["moz"]
    tmpcm = pw.log((zlvl - zpd) / z0m)
    tmpch = pw.log((zlvl - zpd) / z0h)
    tmpcm2 = pw.log((2.0 + z0m) / z0m)
    tmpch2 = pw.log((2.0 + z0h) / z0h)

    if it == 1:
        fv = torch.zeros_like(sfctmp)
        moz = torch.zeros_like(sfctmp)
        moz2 = torch.zeros_like(sfctmp)
    else:
        fv = st["fv"]
        tvir = (1.0 + 0.61 * qair) * sfctmp
        tmp1 = VKC * _rdiv(GRAV, tvir) * h / (rhoair * CPAIR)
        tmp1 = torch.where(torch.abs(tmp1) <= MPE, MPE, tmp1)
        mol = -1.0 * _cube(fv) / tmp1
        moz = torch.clamp((zlvl - zpd) / mol, max=1.0)
        moz2 = torch.clamp((2.0 + z0h) / mol, max=1.0)

    mozsgn = st["mozsgn"] + _i32(mozold * moz < 0.0)
    flip2 = mozsgn >= 2
    moz = torch.where(flip2, 0.0, moz)
    moz2 = torch.where(flip2, 0.0, moz2)
    fm = torch.where(flip2, 0.0, st["fm"])
    fh = torch.where(flip2, 0.0, st["fh"])
    fm2 = torch.where(flip2, 0.0, st["fm2"])
    fh2 = torch.where(flip2, 0.0, st["fh2"])

    fmnew, fhnew = _stab(moz)
    fm2new, fh2new = _stab(moz2)
    if it == 1:
        fm, fh, fm2, fh2 = fmnew, fhnew, fm2new, fh2new
    else:
        fm = 0.5 * (fm + fmnew)
        fh = 0.5 * (fh + fhnew)
        fm2 = 0.5 * (fm2 + fm2new)
        fh2 = 0.5 * (fh2 + fh2new)
    fh = torch.minimum(fh, 0.9 * tmpch)
    fm = torch.minimum(fm, 0.9 * tmpcm)
    fh2 = torch.minimum(fh2, 0.9 * tmpch2)
    fm2 = torch.minimum(fm2, 0.9 * tmpcm2)

    cmfm = _nz(tmpcm - fm)
    chfh = _nz(tmpch - fh)
    ch2fh2 = _nz(tmpch2 - fh2)
    cm = _rdiv(VKC * VKC, cmfm * cmfm)
    ch = _rdiv(VKC * VKC, cmfm * chfh)
    fv = ur * torch.sqrt(cm)
    ch2 = VKC * fv / ch2fh2
    return dict(moz=moz, mozsgn=mozsgn, fm=fm, fh=fh, fm2=fm2, fh2=fh2,
                fv=fv, cm=cm, ch=ch, ch2=ch2)


def ragrb(p, it, st, vai, rhoair, hg, tah, zpd, z0mg, z0hg, hcan, uc,
          z0h, fv, tv):
    """Below-canopy aerodynamic + leaf boundary-layer resistance
    (RAGRB, :4429-4527)."""
    if it == 1:
        fhg_prev = None
        mozg = torch.zeros_like(tah)
    else:
        tmp1 = VKC * _rdiv(GRAV, tah) * hg / (rhoair * CPAIR)
        tmp1 = torch.where(torch.abs(tmp1) <= MPE, MPE, tmp1)
        molg = -1.0 * _cube(fv) / tmp1
        mozg = torch.clamp((zpd - z0mg) / molg, max=1.0)
        fhg_prev = st["fhg"]
    fhgnew = torch.where(mozg < 0.0,
                         pw.pow(1.0 - 15.0 * mozg, -0.25),
                         1.0 + 4.7 * mozg)
    fhg = fhgnew if it == 1 else 0.5 * (fhg_prev + fhgnew)

    cwpc = torch.sqrt(torch.clamp(p.cwpvt * vai * hcan * fhg, min=MPE))
    tmp1 = pw.exp(-cwpc * z0hg / hcan)
    tmp2 = pw.exp(-cwpc * (z0h + zpd) / hcan)
    tmprah2 = hcan * pw.exp(torch.clamp(cwpc, max=50.0)) / cwpc \
        * (tmp1 - tmp2)
    kh = torch.clamp(VKC * fv * (hcan - zpd), min=MPE)
    rahg = tmprah2 / kh
    tmprb = cwpc * 50.0 / (1.0 - pw.exp(-cwpc * 0.5))
    rb = tmprb * torch.sqrt(p.dleaf / torch.clamp(uc, min=MPE))
    rb = torch.clamp(rb, 5.0, 50.0)
    return dict(fhg=fhg, ramg=torch.zeros_like(rahg), rahg=rahg, rawg=rahg,
                rb=rb)


# ==========================================================================
# Ball-Berry stomatal resistance (STOMATA, :4953-5084; OPT_CRS=1)
# ==========================================================================

def stomata(p, apar, foln, tv, ei, ea, sfctmp, sfcprs, o2, co2, igs,
            btran, rb):
    """Ball-Berry / Collatz photosynthesis-conductance model. Returns
    (rs, psn)."""
    cf = sfcprs / (8.314 * sfctmp) * 1e6
    rs0 = 1.0 / p.bp * cf
    fnf = torch.clamp(foln / torch.clamp(p.folnmx, min=MPE), max=1.0)
    tc = tv - TFRZ
    ppf = 4.6 * apar
    j = ppf * p.qe25

    def f1(ab, bc):
        return pw.pow(ab, (bc - 25.0) * inv(10.0))

    def f2(ab):
        return 1.0 + pw.exp((-2.2e5 + 710.0 * (ab + 273.16))
                            / (8.314 * (ab + 273.16)))

    kc = p.kc25 * f1(p.akc, tc)
    ko = p.ko25 * f1(p.ako, tc)
    awc = kc * (1.0 + o2 / ko)
    cp = 0.5 * kc / ko * o2 * 0.21
    vcmx = p.vcmx25 / f2(tc) * fnf * btran * f1(p.avcmx, tc)
    ci = 0.7 * co2 * p.c3psn + 0.4 * co2 * (1.0 - p.c3psn)
    rlb = rb / cf
    cea = torch.maximum(0.25 * ei * p.c3psn + 0.40 * ei * (1.0 - p.c3psn),
                        torch.minimum(ea, ei))

    rs, psn = rs0, torch.zeros_like(rs0)
    for _ in range(3):
        wj = (torch.clamp(ci - cp, min=0.0) * j / (ci + 2.0 * cp) * p.c3psn
              + j * (1.0 - p.c3psn))
        wc = (torch.clamp(ci - cp, min=0.0) * vcmx / (ci + awc) * p.c3psn
              + vcmx * (1.0 - p.c3psn))
        we = 0.5 * vcmx * p.c3psn + 4000.0 * vcmx * ci / sfcprs \
            * (1.0 - p.c3psn)
        psn = torch.minimum(torch.minimum(wj, wc), we) * igs
        cs = torch.clamp(co2 - 1.37 * rlb * sfcprs * psn, min=MPE)
        a = p.mp * psn * sfcprs * cea / (cs * ei) + p.bp
        b = (p.mp * psn * sfcprs / cs + p.bp) * rlb - 1.0
        c = -rlb
        disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        q = torch.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
        rs = torch.maximum(q / a, c / q)
        ci = torch.clamp(cs - psn * sfcprs * 1.65 * rs, min=0.0)

    dark = apar <= 0.0
    return (torch.where(dark, rs0, rs * cf),
            torch.where(dark, 0.0, psn))


# ==========================================================================
# canopy energy balance (VEGE_FLUX, :3526-4118)
# ==========================================================================

NITERC = 20
NITERG = 5
NITERB = 5


def _top_layer(isnow, stc, df, dzsnso):
    """Temperature, conductivity and thickness of the top active layer
    (m = isnow + NSNOW)."""
    mtop = isnow + NSNOW
    return (_gather_m(stc, mtop), _gather_m(df, mtop),
            _gather_m(dzsnso, mtop))


def _mo_state(like, with_fhg):
    st = dict(moz=torch.zeros_like(like),
              mozsgn=torch.zeros_like(like, dtype=torch.int32),
              fm=torch.zeros_like(like), fh=torch.zeros_like(like),
              fm2=torch.zeros_like(like), fh2=torch.zeros_like(like),
              fv=torch.full_like(like, 0.1))
    if with_fhg:
        st["fhg"] = torch.ones_like(like)
    return st


def vege_flux(p, isnow, dt, sav, sag, lwdn, ur, uu, vv, sfctmp, thair,
              qair, eair, rhoair, snowh, vai, gammav, gammag, fwet,
              laisun, laisha, dzsnso, zlvl, zpd, z0m, fveg, z0mg,
              canliq, canice, stc, df, rsurf, latheav, latheag, parsun,
              parsha, igs, foln, co2air, o2air, btran, sfcprs, rhsur,
              q2, pahv, pahg, eah, tah, tv, tg, cm, ch, fsno, emv, emg):
    """Vegetated-fraction energy balance: iterative solution for leaf
    temperature TV (NITERC Newton steps with M-O exchange updates) then
    ground temperature TG under the canopy (NITERG steps).

    The reference's early-exit (LITER) becomes a freeze mask: once
    |dTV| <= 0.01 after iteration 5, one more full iteration runs and
    subsequent ones stop updating that column (matching loop1's
    exit-at-top-of-next-iteration semantics).
    """
    vaie = torch.clamp(vai, max=6.0)
    laisune = torch.clamp(laisun, max=6.0)
    laishae = torch.clamp(laisha, max=6.0)

    estg, _ = _estg(tg)
    qsfc = 0.622 * eair / (sfcprs - 0.378 * eair)
    hcan = p.hvt
    uc = ur * pw.log((hcan - zpd + z0m) / z0m) / pw.log(zlvl / z0m)

    air = -emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * lwdn \
        - emv * emg * SB * _pow4(tg)
    cir = (2.0 - emv * (1.0 - emg)) * emv * SB

    st = _mo_state(tv, True)
    h = torch.zeros_like(tv)
    hg = torch.zeros_like(tv)
    dtv = torch.zeros_like(tv)
    liter = torch.zeros_like(tv, dtype=torch.bool)   # converged: one more
    exited = torch.zeros_like(tv, dtype=torch.bool)  # stop updating
    irc = shc = evc = tr = torch.zeros_like(tv)
    rssun = torch.full_like(tv, 1e5)
    rssha = torch.full_like(tv, 1e5)
    psnsun = torch.zeros_like(tv)
    psnsha = torch.zeros_like(tv)
    rb = torch.full_like(tv, 50.0)
    rahc = rahg_ = rawg_ = torch.ones_like(tv)
    cah2 = torch.zeros_like(tv)
    z0h = z0m
    z0hg = z0mg

    stc_top, df_top, dz_top = _top_layer(isnow, stc, df, dzsnso)

    for it in range(1, NITERC + 1):
        upd = ~exited
        sd = sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m,
                     z0h, ur)
        for k in ("moz", "mozsgn", "fm", "fh", "fm2", "fh2", "fv"):
            st[k] = torch.where(upd, sd[k], st[k])
        cm = torch.where(upd, sd["cm"], cm)
        ch = torch.where(upd, sd["ch"], ch)
        cah2 = torch.where(upd, st["fv"] * VKC
                           / (pw.log((2.0 + z0h) / z0h) - st["fh2"]), cah2)
        rahc_n = torch.clamp(1.0 / (ch * ur), min=1.0)
        rahc = torch.where(upd, rahc_n, rahc)
        rawc = rahc

        rg = ragrb(p, it, st, vaie, rhoair, hg, tah, zpd, z0mg, z0hg,
                   hcan, uc, z0h, st["fv"], tv)
        st["fhg"] = torch.where(upd, rg["fhg"], st["fhg"])
        rahg_ = torch.where(upd, rg["rahg"], rahg_)
        rawg_ = torch.where(upd, rg["rawg"], rawg_)
        rb = torch.where(upd, rg["rb"], rb)

        estv, destv = _estg(tv)

        if it == 1:
            rssun, psnsun = stomata(p, parsun, foln, tv, estv, eah,
                                    sfctmp, sfcprs, o2air, co2air, igs,
                                    btran, rb)
            rssha, psnsha = stomata(p, parsha, foln, tv, estv, eah,
                                    sfctmp, sfcprs, o2air, co2air, igs,
                                    btran, rb)

        cah = 1.0 / rahc
        cvh = 2.0 * vaie / rb
        cgh = 1.0 / rahg_
        cond = cah + cvh + cgh
        ata = (sfctmp * cah + tg * cgh) / cond
        bta = cvh / cond
        csh = (1.0 - bta) * rhoair * CPAIR * cvh
        caw = 1.0 / rawc
        cew = fwet * vaie / rb
        ctw = (1.0 - fwet) * (laisune / (rb + rssun)
                              + laishae / (rb + rssha))
        cgw = 1.0 / (rawg_ + rsurf)
        cond = caw + cew + ctw + cgw
        aea = (eair * caw + estg * cgw) / cond
        bea = (cew + ctw) / cond
        cev = (1.0 - bea) * cew * rhoair * CPAIR / gammav
        ctr = (1.0 - bea) * ctw * rhoair * CPAIR / gammav

        tah_n = ata + bta * tv
        eah_n = aea + bea * estv
        irc_n = fveg * (air + cir * _pow4(tv))
        shc_n = fveg * rhoair * CPAIR * cvh * (tv - tah_n)
        evc_n = fveg * rhoair * CPAIR * cew * (estv - eah_n) / gammav
        tr_n = fveg * rhoair * CPAIR * ctw * (estv - eah_n) / gammav
        evc_n = torch.where(tv > TFRZ,
                            torch.minimum(canliq * latheav / dt, evc_n),
                            torch.minimum(canice * latheav / dt, evc_n))
        b = sav - irc_n - shc_n - evc_n - tr_n + pahv
        a = fveg * (4.0 * cir * _cube(tv) + csh + (cev + ctr) * destv)
        dtv_n = b / a
        irc_n = irc_n + fveg * 4.0 * cir * _cube(tv) * dtv_n
        shc_n = shc_n + fveg * csh * dtv_n
        evc_n = evc_n + fveg * cev * destv * dtv_n
        tr_n = tr_n + fveg * ctr * destv * dtv_n
        tv_n = tv + dtv_n
        h_n = rhoair * CPAIR * (tah_n - sfctmp) / rahc
        hg_n = rhoair * CPAIR * (tg - tah_n) / rahg_
        qsfc_n = (0.622 * eah_n) / (sfcprs - 0.378 * eah_n)

        tah = torch.where(upd, tah_n, tah)
        eah = torch.where(upd, eah_n, eah)
        irc = torch.where(upd, irc_n, irc)
        shc = torch.where(upd, shc_n, shc)
        evc = torch.where(upd, evc_n, evc)
        tr = torch.where(upd, tr_n, tr)
        tv = torch.where(upd, tv_n, tv)
        h = torch.where(upd, h_n, h)
        hg = torch.where(upd, hg_n, hg)
        qsfc = torch.where(upd, qsfc_n, qsfc)
        dtv = torch.where(upd, dtv_n, dtv)

        exited = exited | liter
        if it >= 5:
            liter = liter | (~exited & (torch.abs(dtv) <= 0.01))

    # under-canopy ground temperature (loop2)
    air = -emg * (1.0 - emv) * lwdn - emg * emv * SB * _pow4(tv)
    cir = emg * SB
    csh = rhoair * CPAIR / rahg_
    cev = rhoair * CPAIR / (gammag * (rawg_ + rsurf))
    cgh = 2.0 * df_top / dz_top
    irg = shg = evg = gh = torch.zeros_like(tg)
    for _ in range(NITERG):
        estg, destg = _estg(tg)
        irg = cir * _pow4(tg) + air
        shg = csh * (tg - tah)
        evg = cev * (estg * rhsur - eah)
        gh = cgh * (tg - stc_top)
        b = sag - irg - shg - evg - gh + pahg
        a = 4.0 * cir * _cube(tg) + csh + cev * destg + cgh
        dtg = b / a
        irg = irg + 4.0 * cir * _cube(tg) * dtg
        shg = shg + csh * dtg
        evg = evg + cev * destg * dtg
        gh = gh + cgh * dtg
        tg = tg + dtg

    # OPT_STC=1: cap TG at freezing while snow on ground (:4038-4048)
    estg, _ = _estg(tg)
    cap = (snowh > 0.05) & (tg > TFRZ)
    tg = torch.where(cap, TFRZ, tg)
    irg = torch.where(cap, cir * _pow4(tg) - emg * (1.0 - emv) * lwdn
                      - emg * emv * SB * _pow4(tv), irg)
    shg = torch.where(cap, csh * (tg - tah), shg)
    evg = torch.where(cap, cev * (estg * rhsur - eah), evg)
    gh = torch.where(cap, sag + pahg - (irg + shg + evg), gh)

    tauxv = -rhoair * cm * ur * uu
    tauyv = -rhoair * cm * ur * vv
    cq2v = cah2
    small = cah2 < 1e-5
    t2mv = torch.where(small, tah,
                       tah - (shg + shc / torch.clamp(fveg, min=MPE))
                       / (rhoair * CPAIR) / torch.clamp(cah2, min=MPE))
    q2v = torch.where(small, qsfc,
                      qsfc - ((evc + tr) / torch.clamp(fveg, min=MPE) + evg)
                      / (latheav * rhoair) / torch.clamp(cq2v, min=MPE))
    ch = 1.0 / rahc
    chleaf = 2.0 * vaie / rb
    chuc = 1.0 / rahg_
    return SimpleNamespace(
        eah=eah, tah=tah, tv=tv, tg=tg, cm=cm, ch=ch, tauxv=tauxv,
        tauyv=tauyv, irg=irg, irc=irc, shg=shg, shc=shc, evg=evg, evc=evc,
        tr=tr, gh=gh, t2mv=t2mv, q2v=q2v, psnsun=psnsun, psnsha=psnsha,
        rssun=rssun, rssha=rssha, qsfc=qsfc, chleaf=chleaf, chuc=chuc,
        chv2=cah2, rb=rb)


def bare_flux(p, isnow, dt, sag, lwdn, ur, uu, vv, sfctmp, thair, qair,
              eair, rhoair, snowh, dzsnso, zlvl, zpd, z0m, fsno, emg,
              stc, df, rsurf, lathea, gamma, rhsur, q2, pahb, tgb, cm,
              ch, sfcprs):
    """Bare-ground energy balance, NITERB Newton iterations (BARE_FLUX,
    :4120-4427)."""
    cir = emg * SB
    stc_top, df_top, dz_top = _top_layer(isnow, stc, df, dzsnso)
    cgh = 2.0 * df_top / dz_top

    st = _mo_state(tgb, False)
    h = torch.zeros_like(tgb)
    z0h = z0m
    qsfc = 0.622 * eair / (sfcprs - 0.378 * eair)
    irb = shb = evb = ghb = torch.zeros_like(tgb)
    csh = cev = torch.ones_like(tgb)
    ehb2 = torch.zeros_like(tgb)
    for it in range(1, NITERB + 1):
        sd = sfcdif1(st, it, sfctmp, rhoair, h, qair, zlvl, zpd, z0m,
                     z0h, ur)
        for k in ("moz", "mozsgn", "fm", "fh", "fm2", "fh2", "fv"):
            st[k] = sd[k]
        cm, ch = sd["cm"], sd["ch"]
        ehb2 = st["fv"] * VKC / (pw.log((2.0 + z0h) / z0h) - st["fh2"])
        rahb = torch.clamp(1.0 / (ch * ur), min=1.0)
        rawb = rahb
        estg, destg = _estg(tgb)
        csh = rhoair * CPAIR / rahb
        cev = rhoair * CPAIR / gamma / (rsurf + rawb)
        irb = cir * _pow4(tgb) - emg * lwdn
        shb = csh * (tgb - sfctmp)
        evb = cev * (estg * rhsur - eair)
        ghb = cgh * (tgb - stc_top)
        b = sag - irb - shb - evb - ghb + pahb
        a = 4.0 * cir * _cube(tgb) + csh + cev * destg + cgh
        dtg = b / a
        irb = irb + 4.0 * cir * _cube(tgb) * dtg
        shb = shb + csh * dtg
        evb = evb + cev * destg * dtg
        ghb = ghb + cgh * dtg
        tgb = tgb + dtg
        h = csh * (tgb - sfctmp)
        estg, _ = _estg(tgb)
        qsfc = 0.622 * (estg * rhsur) / (sfcprs - 0.378 * (estg * rhsur))

    cap = (snowh > 0.05) & (tgb > TFRZ)
    tgb = torch.where(cap, TFRZ, tgb)
    irb = torch.where(cap, cir * _pow4(tgb) - emg * lwdn, irb)
    shb = torch.where(cap, csh * (tgb - sfctmp), shb)
    evb = torch.where(cap, cev * (estg * rhsur - eair), evb)
    ghb = torch.where(cap, sag + pahb - (irb + shb + evb), ghb)

    tauxb = -rhoair * cm * ur * uu
    tauyb = -rhoair * cm * ur * vv
    cq2b = ehb2
    small = ehb2 < 1e-5
    t2mb = torch.where(small, tgb,
                       tgb - shb / (rhoair * CPAIR)
                       / torch.clamp(ehb2, min=MPE))
    q2b = torch.where(small, qsfc,
                      qsfc - evb / (lathea * rhoair)
                      * (1.0 / torch.clamp(cq2b, min=MPE) + rsurf))
    ehb = 1.0 / torch.clamp(1.0 / (ch * ur), min=1.0)
    return SimpleNamespace(
        tgb=tgb, cm=cm, ch=ehb, tauxb=tauxb, tauyb=tauyb, irb=irb,
        shb=shb, evb=evb, ghb=ghb, t2mb=t2mb, q2b=q2b, qsfc=qsfc,
        chb2=ehb2)


# ==========================================================================
# snow/soil temperature (TSNOSOI/HRT/HSTEP/ROSR12, :5201-5541)
# ==========================================================================

def _thomas_stack(a, b, c, r, active):
    """Thomas solve over the 7-layer stack with variable top; inactive
    rows are identity rows with zero rhs (ROSR12, :5482-5539)."""
    a = torch.where(active, a, 0.0)
    b = torch.where(active, b, 1.0)
    c = torch.where(active, c, 0.0)
    r = torch.where(active, r, 0.0)
    n = a.shape[0]
    gam = [None] * n
    u = [None] * n
    bet = b[0]
    u[0] = r[0] / bet
    gam[0] = torch.zeros_like(bet)
    for k in range(1, n):
        gam[k] = c[k - 1] / bet
        bet = b[k] - a[k] * gam[k]
        u[k] = (r[k] - a[k] * u[k - 1]) / bet
    for k in range(n - 2, -1, -1):
        u[k] = u[k] - gam[k + 1] * u[k + 1]
    return torch.stack(u)


def _down1(x):
    """The stack shifted down one row, its first row repeated
    (``concatenate([x[:1], x[:-1]])``)."""
    return torch.cat([x[:1], x[:-1]], 0)


def _up1(x):
    """The stack shifted up one row, its last row repeated."""
    return torch.cat([x[1:], x[-1:]], 0)


def tsnosoi(p, isnow, tbot, zsnso, ssoil, df, hcpct, dt, snowh, dzsnso,
            stc):
    """Semi-implicit snow/soil heat diffusion (TSNOSOI + HRT + HSTEP).
    OPT_TBOT=2 (Noah lower boundary at ZBOT), OPT_STC=1."""
    zbotsno = p.zbot - snowh          # ZBOT measured from snow surface
    act = _active(isnow)
    is_top = _stack_j(isnow.device) == (isnow[None] + 1)

    zs_m1 = torch.cat([torch.zeros_like(zsnso[:1]), zsnso[:-1]], 0)
    zs_p1 = _up1(zsnso)
    stc_p1 = _up1(stc)
    df_m1 = _down1(df)

    denom = torch.where(is_top, -zsnso * hcpct, (zs_m1 - zsnso) * hcpct)
    temp1 = torch.where(is_top, -zs_p1, zs_m1 - zs_p1)
    temp1 = torch.where(torch.abs(temp1) < MPE, MPE, temp1)
    ddz = _rdiv(2.0, temp1)
    dtsdz = 2.0 * (stc - stc_p1) / temp1
    # bottom row (soil layer NSOIL)
    dtsdz_bot = (stc[-1] - tbot) / (0.5 * (zsnso[-2] + zsnso[-1]) - zbotsno)
    botflx = -df[-1] * dtsdz_bot
    dtsdz = _set(dtsdz, -1, dtsdz_bot)
    dtsdz_m1 = _down1(dtsdz)
    ddz_m1 = _down1(ddz)

    eflux = torch.where(is_top, df * dtsdz - ssoil[None],
                        df * dtsdz - df_m1 * dtsdz_m1)
    eflux = _set(eflux, -1,
                 torch.where(is_top[-1], eflux[-1],
                             -botflx - df_m1[-1] * dtsdz_m1[-1]))

    ai = torch.where(is_top, 0.0, -df_m1 * ddz_m1 / denom)
    ci = -df * ddz / denom
    ci = _set(ci, -1, 0.0)
    bi = torch.where(is_top, -ci, -(ai + ci))
    rhsts = eflux / (-denom)

    # HSTEP: (1 + bi*dt) dT ... = rhs*dt
    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    r = rhsts * dt
    dstc = _thomas_stack(a, b, c, r, act)
    return torch.where(act, stc + dstc, stc)


# ==========================================================================
# melting/freezing of snow & soil (PHASECHANGE, :5543-5756; OPT_FRZ=1)
# ==========================================================================

def phasechange(p, isnow, dt, fact, dzsnso, stc, snice, snliq, sneqv,
                snowh, smc, sh2o):
    """Energy-residual phase change with NY06 supercooled liquid water.
    Returns updated (stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt,
    imelt, ponding)."""
    act = _active(isnow)
    j_ax = _stack_j(isnow.device)

    mice = torch.cat([snice, (smc - sh2o) * dzsnso[NSNOW:] * 1000.0], 0)
    mliq = torch.cat([snliq, sh2o * dzsnso[NSNOW:] * 1000.0], 0)
    wice0 = mice
    wmass0 = mice + mliq

    # NY06 supercooled water (soil only)
    smp = HFUS * (TFRZ - stc[NSNOW:]) / (GRAV * stc[NSNOW:])
    supercool_soil = (p.smcmax[None]
                      * pw.pow(smp / p.psisat[None],
                               _rdiv(-1.0, p.bexp[None])))
    supercool_soil = torch.where(stc[NSNOW:] < TFRZ,
                                 supercool_soil * dzsnso[NSNOW:] * 1000.0,
                                 0.0)
    supercool = torch.cat([torch.zeros_like(snice), supercool_soil], 0)

    imelt = torch.zeros_like(stc, dtype=torch.int32)
    imelt = torch.where(act & (mice > 0.0) & (stc >= TFRZ), 1, imelt)
    imelt = torch.where(act & (mliq > supercool) & (stc < TFRZ), 2, imelt)
    # layerless snowpack melts through the first soil layer (:5626-5631)
    thin = (isnow == 0) & (sneqv > 0.0)
    first_soil = j_ax == 1
    imelt = torch.where(first_soil & thin[None] & (stc >= TFRZ), 1, imelt)

    melting = imelt > 0
    hm = torch.where(melting, (stc - TFRZ) / fact, 0.0)
    stc = torch.where(melting, TFRZ, stc)
    bad = ((imelt == 1) & (hm < 0.0)) | ((imelt == 2) & (hm > 0.0))
    hm = torch.where(bad, 0.0, hm)
    imelt = torch.where(bad, 0, imelt)
    xm = hm * dt * inv(HFUS)

    # bulk (layerless) snowpack melt (:5652-5669)
    qmelt = torch.zeros_like(sneqv)
    ponding = torch.zeros_like(sneqv)
    do_thin = thin & (xm[NSNOW] > 0.0)
    temp1 = sneqv
    sneqv_n = torch.clamp(temp1 - xm[NSNOW], min=0.0)
    propor = sneqv_n / torch.clamp(temp1, min=MPE)
    snowh_n = torch.clamp(propor * snowh, min=0.0)
    snowh_n = torch.minimum(torch.maximum(snowh_n, sneqv_n * inv(500.0)),
                            sneqv_n * inv(50.0))
    heatr = hm[NSNOW] - HFUS * (temp1 - sneqv_n) / dt
    xm1 = torch.where(heatr > 0.0, heatr * dt * inv(HFUS), 0.0)
    hm1 = torch.where(heatr > 0.0, heatr, 0.0)
    qmelt = torch.where(do_thin,
                        torch.clamp(temp1 - sneqv_n, min=0.0) / dt, qmelt)
    ponding = torch.where(do_thin, temp1 - sneqv_n, ponding)
    sneqv = torch.where(do_thin, sneqv_n, sneqv)
    snowh = torch.where(do_thin, snowh_n, snowh)
    hm = _set(hm, NSNOW, torch.where(do_thin, hm1, hm[NSNOW]))
    xm = _set(xm, NSNOW, torch.where(do_thin, xm1, xm[NSNOW]))

    # layer-by-layer phase change; sequential because a fully-melted snow
    # layer passes residual heat to the layer below (BARLAGE, :5700-5707)
    stc_rows = list(stc.unbind(0))
    mice_rows = list(mice.unbind(0))
    mliq_rows = list(mliq.unbind(0))
    hm_rows = list(hm.unbind(0))
    xm_rows = list(xm.unbind(0))
    for m in range(NSS):
        j = m - (NSNOW - 1)
        do = act[m] & (imelt[m] > 0) & (torch.abs(hm_rows[m]) > 0.0)
        mice_m = mice_rows[m]
        melt_pos = xm_rows[m] > 0.0
        mice_pos = torch.clamp(wice0[m] - xm_rows[m], min=0.0)
        if j <= 0:
            mice_neg = torch.minimum(wmass0[m], wice0[m] - xm_rows[m])
        else:
            mice_neg = torch.where(
                wmass0[m] < supercool[m], 0.0,
                torch.clamp(torch.minimum(wmass0[m] - supercool[m],
                                          wice0[m] - xm_rows[m]), min=0.0))
        mice_new = torch.where(melt_pos, mice_pos,
                               torch.where(xm_rows[m] < 0.0, mice_neg,
                                           mice_m))
        heatr = hm_rows[m] - HFUS * (wice0[m] - mice_new) / dt
        mliq_new = torch.clamp(wmass0[m] - mice_new, min=0.0)
        has_res = torch.abs(heatr) > 0.0
        stc_m = torch.where(do & has_res, stc_rows[m] + fact[m] * heatr,
                            stc_rows[m])
        if j <= 0:
            both = (mliq_new * mice_new) > 0.0
            gone = mice_new == 0.0
            stc_m = torch.where(do & has_res & both, TFRZ, stc_m)
            stc_m = torch.where(do & has_res & gone, TFRZ, stc_m)
            # pass the residual down one layer
            pass_heat = do & has_res & gone
            hm_rows[m + 1] = torch.where(pass_heat, hm_rows[m + 1] + heatr,
                                         hm_rows[m + 1])
            xm_rows[m + 1] = torch.where(
                pass_heat, hm_rows[m + 1] * dt * inv(HFUS), xm_rows[m + 1])
            qmelt = qmelt + torch.where(
                do, torch.clamp(wice0[m] - mice_new, min=0.0) / dt, 0.0) \
                * (1.0 if j < 1 else 0.0)
        stc_rows[m] = stc_m
        mice_rows[m] = torch.where(do, mice_new, mice_rows[m])
        mliq_rows[m] = torch.where(do, mliq_new, mliq_rows[m])

    stc = torch.stack(stc_rows)
    mice = torch.stack(mice_rows)
    mliq = torch.stack(mliq_rows)
    snice = mice[:NSNOW]
    snliq = mliq[:NSNOW]
    sh2o = mliq[NSNOW:] / (1000.0 * dzsnso[NSNOW:])
    smc = (mliq[NSNOW:] + mice[NSNOW:]) / (1000.0 * dzsnso[NSNOW:])
    return stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt, ponding


# ==========================================================================
# energy driver (ENERGY, :1695-2334)
# ==========================================================================

def energy(p, vegtype, isnow, dt, rhoair, sfcprs, qair, sfctmp, thair,
           lwdn, uu, vv, zref, solad, solai, cosz, igs, eair, tbot,
           zsnso, zsoil, elai, esai, fwet, foln, fveg, pahv, pahg, pahb,
           qsnow, dzsnso, lat, canliq, canice, tv, tg, stc, snowh, eah,
           tah, sneqvo, sneqv, sh2o, smc, snice, snliq, albold, cm, ch,
           q2, tauss, psfc):
    """Energy budget: thermal properties, radiation, canopy + bare-ground
    flux solutions, snow/soil diffusion, phase change. IST=1, ICE=0."""
    ur = torch.clamp(torch.sqrt(uu * uu + vv * vv), min=1.0)
    vai = elai + esai
    veg = vai > 0.0

    # snow cover fraction (:1964-1969, Niu & Yang 2007)
    bdsno = sneqv / torch.clamp(snowh, min=MPE)
    fmelt = pw.pow(bdsno * inv(100.0), p.mfsno)
    fsno = torch.where(snowh > 0.0,
                       torch.tanh(snowh / (p.scffac * fmelt)), 0.0)

    z0 = 0.002
    z0mg = z0 * (1.0 - fsno) + fsno * p.z0sno
    zpdg = snowh
    z0m = torch.where(veg, p.z0mvt, z0mg)
    zpd = torch.where(veg, torch.maximum(0.65 * p.hvt, snowh), zpdg)
    zlvl = torch.maximum(zpd, p.hvt) + zref
    zlvl = torch.where(zpdg >= zlvl, zpdg + zref, zlvl)

    df, hcpct, snicev, snliqv, epore, fact = thermoprop(
        p, isnow, dzsnso, dt, snowh, snice, snliq, smc, sh2o)

    rad = radiation(p, dt, cosz, elai, esai, tg, tv, fsno, qsnow, fwet,
                    smc[0], sneqvo, sneqv, fveg, tauss, vegtype,
                    solad, solai)

    emv = 1.0 - pw.exp(-(elai + esai) / 1.0)
    emg = float(p.eg[0]) * (1.0 - fsno) + p.snow_emis * fsno

    # soil moisture transpiration factor (OPT_BTR=1 Noah, :2036-2053)
    dev = tv.device
    nroot_mask = (torch.arange(NSOIL, device=dev)[:, None, None]
                  < p.nroot[None])
    zroot = -take_level(
        zsoil[:, None, None].expand((NSOIL,) + tuple(p.nroot.shape)),
        torch.clamp(p.nroot, 1, NSOIL) - 1)
    gx = torch.clamp((sh2o - p.smcwlt[None])
                     / torch.clamp(p.smcref[None] - p.smcwlt[None],
                                   min=MPE), 0.0, 1.0)
    btrani = torch.clamp(dzsnso[NSNOW:] / zroot[None] * gx, min=MPE)
    btrani = torch.where(nroot_mask, btrani, 0.0)
    btran = torch.clamp(_sum0(btrani), min=MPE)
    btrani = btrani / btran

    # surface resistance, Sakaguchi & Zeng 2009 (OPT_RSF=1, :2060-2081)
    l_rsurf = (-zsoil[0]) * (
        pw.exp(pw.pow(1.0 - torch.clamp(sh2o[0] / p.smcmax, max=1.0),
                      p.rsurf_exp)) - 1.0) * inv(2.71828 - 1.0)
    d_rsurf = 2.2e-5 * p.smcmax * p.smcmax \
        * pw.pow(1.0 - p.smcwlt / p.smcmax, 2.0 + _rdiv(3.0, p.bexp))
    rsurf = l_rsurf / d_rsurf
    rsurf = torch.where((sh2o[0] < 0.01) & (snowh == 0.0), 1e6, rsurf)
    psi = -p.psisat * pw.pow(torch.clamp(sh2o[0], min=0.01) / p.smcmax,
                             -p.bexp)
    rhsur = fsno + (1.0 - fsno) * pw.exp(psi * GRAV / (RW * tg))

    frozen_canopy = tv <= TFRZ
    latheav = _where(frozen_canopy, HSUB, HVAP)
    gammav = CPAIR * sfcprs / (0.622 * latheav)
    frozen_ground = tg <= TFRZ
    latheag = _where(frozen_ground, HSUB, HVAP)
    gammag = CPAIR * sfcprs / (0.622 * latheag)

    vf = vege_flux(
        p, isnow, dt, rad.sav, rad.sag, lwdn, ur, uu, vv, sfctmp, thair,
        qair, eair, rhoair, snowh, vai, gammav, gammag, fwet, rad.laisun,
        rad.laisha, dzsnso, zlvl, zpd, z0m, fveg, z0mg, canliq, canice,
        stc, df, rsurf, latheav, latheag, rad.parsun, rad.parsha, igs,
        foln, p.co2 * sfcprs, p.o2 * sfcprs, btran, sfcprs, rhsur, q2,
        pahv, pahg, eah, tah, tv, tg, cm, ch, fsno, emv, emg)
    bf = bare_flux(
        p, isnow, dt, rad.sag, lwdn, ur, uu, vv, sfctmp, thair, qair,
        eair, rhoair, snowh, dzsnso, zlvl, zpdg, z0mg, fsno, emg, stc,
        df, rsurf, latheag, gammag, rhsur, q2, pahb, tg, cm, ch, sfcprs)

    vegcell = veg & (fveg > 0.0)
    w = torch.where(vegcell, fveg, 0.0)
    tgv, tgb = vf.tg, bf.tgb
    taux = w * vf.tauxv + (1.0 - w) * bf.tauxb
    tauy = w * vf.tauyv + (1.0 - w) * bf.tauyb
    fira = torch.where(vegcell, w * vf.irg + (1.0 - w) * bf.irb + vf.irc,
                       bf.irb)
    fsh = torch.where(vegcell, w * vf.shg + (1.0 - w) * bf.shb + vf.shc,
                      bf.shb)
    fgev = torch.where(vegcell, w * vf.evg + (1.0 - w) * bf.evb, bf.evb)
    ssoil = torch.where(vegcell, w * vf.gh + (1.0 - w) * bf.ghb, bf.ghb)
    fcev = torch.where(vegcell, vf.evc, 0.0)
    fctr = torch.where(vegcell, vf.tr, 0.0)
    pah = torch.where(vegcell, w * pahg + (1.0 - w) * pahb + pahv, pahb)
    tg = torch.where(vegcell, w * tgv + (1.0 - w) * tgb, tgb)
    t2m = torch.where(vegcell, w * vf.t2mv + (1.0 - w) * bf.t2mb, bf.t2mb)
    ts = torch.where(vegcell, w * vf.tv + (1.0 - w) * tgb, tg)
    cm = torch.where(vegcell, w * vf.cm + (1.0 - w) * bf.cm, bf.cm)
    ch = torch.where(vegcell, w * vf.ch + (1.0 - w) * bf.ch, bf.ch)
    q1 = torch.where(vegcell,
                     w * (vf.eah * 0.622 / (sfcprs - 0.378 * vf.eah))
                     + (1.0 - w) * bf.qsfc, bf.qsfc)
    q2e = torch.where(vegcell, w * vf.q2v + (1.0 - w) * bf.q2b, bf.q2b)
    z0wrf = torch.where(vegcell, z0m, z0mg)
    tv = torch.where(vegcell, vf.tv, tg)
    eah = torch.where(vegcell, vf.eah, eah)
    tah = torch.where(vegcell, vf.tah, tah)
    qsfc = torch.where(vegcell, vf.qsfc, bf.qsfc)
    rssun = torch.where(vegcell, vf.rssun, 0.0)
    rssha = torch.where(vegcell, vf.rssha, 0.0)

    fire = lwdn + fira
    emissi = fveg * (emg * (1.0 - emv) + emv
                     + emv * (1.0 - emv) * (1.0 - emg)) \
        + (1.0 - fveg) * emg
    trad = pw.pow(torch.clamp(fire - (1.0 - emissi) * lwdn, min=1.0)
                  / (emissi * SB), 0.25)
    apar = rad.parsun * rad.laisun + rad.parsha * rad.laisha
    psn = torch.where(vegcell,
                      vf.psnsun * rad.laisun + vf.psnsha * rad.laisha, 0.0)

    stc = tsnosoi(p, isnow, tbot, zsnso, ssoil, df, hcpct, dt, snowh,
                  dzsnso, stc)

    (stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt,
     ponding) = phasechange(p, isnow, dt, fact, dzsnso, stc, snice,
                            snliq, sneqv, snowh, smc, sh2o)

    return SimpleNamespace(
        tv=tv, tg=tg, stc=stc, snowh=snowh, eah=eah, tah=tah,
        sneqv=sneqv, sh2o=sh2o, smc=smc, snice=snice, snliq=snliq,
        cm=cm, ch=ch, tauss=rad.tauss, qsfc=qsfc, imelt=imelt,
        snicev=snicev, snliqv=snliqv, epore=epore, t2m=t2m, fsno=fsno,
        sav=rad.sav, sag=rad.sag, qmelt=qmelt, fsa=rad.fsa, fsr=rad.fsr,
        taux=taux, tauy=tauy, fira=fira, fsh=fsh, fcev=fcev, fgev=fgev,
        fctr=fctr, trad=trad, psn=psn, apar=apar, ssoil=ssoil,
        btrani=btrani, btran=btran, ponding=ponding, ts=ts,
        latheav=latheav, latheag=latheag, frozen_canopy=frozen_canopy,
        frozen_ground=frozen_ground, t2mv=vf.t2mv, t2mb=bf.t2mb,
        q2v=vf.q2v, q2b=bf.q2b, q2e=q2e, q1=q1, emissi=emissi,
        z0wrf=z0wrf, fsrv=rad.fsrv, fsrg=rad.fsrg, rssun=rssun,
        rssha=rssha, albsnd=rad.albsnd, albsni=rad.albsni,
        bgap=rad.bgap, wgap=rad.wgap, tgv=tgv, tgb=tgb, chv=vf.ch,
        chb=bf.ch, shg=vf.shg, shc=vf.shc, shb=bf.shb, evg=vf.evg,
        evb=bf.evb, ghv=vf.gh, ghb=bf.ghb, irg=vf.irg, irc=vf.irc,
        irb=bf.irb, tr=vf.tr, evc=vf.evc, chleaf=vf.chleaf,
        chuc=vf.chuc, chv2=vf.chv2, chb2=bf.chb2, pah=pah,
        laisun=rad.laisun, laisha=rad.laisha, rb=vf.rb, fveg_out=fveg)


# ==========================================================================
# canopy water (CANWATER, :6168-6298)
# ==========================================================================

def canwater(p, dt, fcev, fctr, elai, esai, bdfall, frozen_canopy,
             canliq, canice, tv):
    """Canopy hydrology + canopy snow melt/refreeze."""
    maxliq = p.ch2op * (elai + esai)
    fc = frozen_canopy
    etran = torch.where(fc, torch.clamp(fctr * inv(HSUB), min=0.0),
                        torch.clamp(fctr * inv(HVAP), min=0.0))
    qevac = torch.where(fc, 0.0, torch.clamp(fcev * inv(HVAP), min=0.0))
    qdewc = torch.where(fc, 0.0,
                        torch.abs(torch.clamp(fcev * inv(HVAP), max=0.0)))
    qsubc = torch.where(fc, torch.clamp(fcev * inv(HSUB), min=0.0), 0.0)
    qfroc = torch.where(fc, torch.abs(torch.clamp(fcev * inv(HSUB),
                                                  max=0.0)), 0.0)

    qevac = torch.minimum(canliq / dt, qevac)
    canliq = torch.clamp(canliq + (qdewc - qevac) * dt, min=0.0)
    canliq = torch.where(canliq <= 1e-6, 0.0, canliq)
    maxsno = 6.6 * (0.27 + _rdiv(46.0, bdfall)) * (elai + esai)
    qsubc = torch.minimum(canice / dt, qsubc)
    canice = torch.clamp(canice + (qfroc - qsubc) * dt, min=0.0)
    canice = torch.where(canice <= 1e-6, 0.0, canice)

    fwet = torch.where(canice > 0.0,
                       canice / torch.clamp(maxsno, min=1e-6),
                       canliq / torch.clamp(maxliq, min=1e-6))
    fwet = pw.pow(torch.clamp(fwet, max=1.0), 0.667)

    melt = (canice > 1e-6) & (tv > TFRZ)
    qmeltc = torch.where(melt, torch.minimum(
        canice / dt,
        (tv - TFRZ) * CICE * canice * inv(DENICE) / (dt * HFUS)), 0.0)
    canice = torch.clamp(canice - qmeltc * dt, min=0.0)
    canliq = torch.clamp(canliq + qmeltc * dt, min=0.0)
    tv = torch.where(melt, fwet * TFRZ + (1.0 - fwet) * tv, tv)
    frz = (canliq > 1e-6) & (tv < TFRZ)
    qfrzc = torch.where(frz, torch.minimum(
        canliq / dt,
        (TFRZ - tv) * CWAT * canliq * inv(DENH2O) / (dt * HFUS)), 0.0)
    canliq = torch.clamp(canliq - qfrzc * dt, min=0.0)
    canice = torch.clamp(canice + qfrzc * dt, min=0.0)
    tv = torch.where(frz, fwet * TFRZ + (1.0 - fwet) * tv, tv)

    cmc = canliq + canice
    ecan = qevac + qsubc - qdewc - qfroc
    return canliq, canice, tv, cmc, ecan, etran, fwet


# ==========================================================================
# snow hydrology (SNOWWATER chain, :6300-7126)
# ==========================================================================

def _shift_down_nmp(arrs, shift_mask):
    return [torch.where(shift_mask, _down1(a), a) for a in arrs]


def _combo_nmp(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy merge of two snow elements (COMBO, :6819-6871)."""
    dzc = dz1 + dz2
    wicec = ice1 + ice2
    wliqc = liq1 + liq2
    h = (CICE * ice1 + CWAT * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CICE * ice2 + CWAT * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cpc = torch.clamp(CICE * wicec + CWAT * wliqc, min=MPE)
    tc = torch.where(hc < 0.0, TFRZ + hc / cpc,
                     _where(hc <= HFUS * wliqc, TFRZ,
                            TFRZ + (hc - HFUS * wliqc) / cpc))
    return dzc, wliqc, wicec, tc


def snowfall_acc(p, dt, qsnow, snowhin, sfctmp, isnow, snowh, sneqv,
                 dzsnso, stc, snice, snliq, new_layer_thresh=0.025):
    """Snow accumulation and new-layer initiation (SNOWFALL,
    :6433-6501). dzsnso here is the POSITIVE thickness stack."""
    bulk = (isnow == 0) & (qsnow > 0.0)
    snowh = torch.where(bulk, snowh + snowhin * dt, snowh)
    sneqv = torch.where(bulk, sneqv + qsnow * dt, sneqv)

    newnode = bulk & (snowh >= new_layer_thresh)
    m0 = NSNOW - 1
    isnow = torch.where(newnode, -1, isnow)
    dzsnso = _set(dzsnso, m0, torch.where(newnode, snowh, dzsnso[m0]))
    snowh = torch.where(newnode, 0.0, snowh)
    stc = _set(stc, m0, torch.where(newnode, torch.clamp(sfctmp, max=273.16),
                                    stc[m0]))
    snice = _set(snice, m0, torch.where(newnode, sneqv, snice[m0]))
    snliq = _set(snliq, m0, torch.where(newnode, 0.0, snliq[m0]))

    accrete = (isnow < 0) & ~newnode & (qsnow > 0.0)
    mtop = isnow + NSNOW   # stack index of layer isnow+1
    ice_t = _gather_m(snice, mtop)
    dz_t = _gather_m(dzsnso, mtop)
    snice = _scatter_m(snice, mtop, ice_t + qsnow * dt, accrete)
    dzsnso = _scatter_m(dzsnso, mtop, dz_t + snowhin * dt, accrete)
    return isnow, snowh, sneqv, dzsnso, stc, snice, snliq


def compact_snow(p, dt, stc, snice, snliq, imelt, ficeold, isnow, dzsnso):
    """Snow compaction (COMPACT, :6873-6977); positive-thickness stack."""
    c2, c3, c4, c5 = 21.0e-3, 2.5e-6, 0.04, 2.0
    dm, eta0 = 100.0, 0.8e6
    smask = _snow_mask(isnow)[:NSNOW]
    burden = torch.zeros_like(isnow, dtype=torch.float32)
    rows = list(dzsnso.unbind(0))
    for m in range(NSNOW):
        act = smask[m]
        wx = snice[m] + snliq[m]
        fice = snice[m] / torch.clamp(wx, min=MPE)
        dzm = torch.clamp(rows[m], min=MPE)
        void = 1.0 - (snice[m] * inv(DENICE) + snliq[m] * inv(DENH2O)) / dzm
        do = act & (void > 0.001) & (snice[m] > 0.1)
        bi = snice[m] / dzm
        td = torch.clamp(TFRZ - stc[m], min=0.0)
        ddz1 = -c3 * pw.exp(-c4 * td)
        ddz1 = torch.where(bi > dm, ddz1 * pw.exp(-46.0e-3 * (bi - dm)),
                           ddz1)
        ddz1 = torch.where(snliq[m] > 0.01 * dzm, ddz1 * c5, ddz1)
        ddz2 = -(burden + 0.5 * wx) * pw.exp(
            -0.08 * td - c2 * bi) * inv(eta0)
        fio = torch.clamp(ficeold[m], min=1e-6)
        ddz3 = torch.where(imelt[m] == 1,
                           -torch.clamp((fio - fice) / fio, min=0.0) / dt,
                           0.0)
        pdzdtc = torch.clamp((ddz1 + ddz2 + ddz3) * dt, min=-0.5)
        newdz = torch.maximum(rows[m] * (1.0 + pdzdtc),
                              snice[m] * inv(DENICE)
                              + snliq[m] * inv(DENH2O))
        rows[m] = torch.where(do, newdz, rows[m])
        burden = burden + torch.where(act, wx, 0.0)
    return torch.stack(rows)


def combine_snow(p, isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh,
                 sneqv, dzsnso_soil1, dzmin_vals=(0.025, 0.025, 0.1),
                 gone_thresh=0.025, glacier=False):
    """Merge thin/ice-poor snow layers (COMBINE, :6503-6689); positive
    thickness stack. dzmin = [0.025, 0.025, 0.1]."""
    dev = isnow.device
    m_ax = torch.arange(NSNOW, dtype=torch.int32, device=dev)[:, None, None]
    j_ax3 = m_ax - (NSNOW - 1)
    ponding1 = torch.zeros_like(sneqv)
    ponding2 = torch.zeros_like(sneqv)

    # pass 1: remove ice-poor layers
    isnow_old = isnow
    for j in range(-NSNOW + 1, 1):
        m = j + NSNOW - 1
        has = (j >= isnow_old + 1) & (j >= isnow + 1)
        low = has & (snice[m] <= 0.1)
        if j != 0:
            snliq = _add(snliq, m + 1, torch.where(low, snliq[m], 0.0))
            snice = _add(snice, m + 1, torch.where(low, snice[m], 0.0))
            dzsnso = _add(dzsnso, m + 1, torch.where(low, dzsnso[m], 0.0))
        else:
            multi = isnow_old < -1
            up = low & multi
            snliq = _add(snliq, m - 1, torch.where(up, snliq[m], 0.0))
            snice = _add(snice, m - 1, torch.where(up, snice[m], 0.0))
            dzsnso = _add(dzsnso, m - 1, torch.where(up, dzsnso[m], 0.0))
            solo = low & ~multi
            pos = (snice[m] >= 0.0) | glacier
            ponding1 = torch.where(
                solo & pos,
                (ponding1 + snliq[m]) if glacier else snliq[m], ponding1)
            sneqv = torch.where(solo & pos, snice[m], sneqv)
            snowh = torch.where(solo & pos, dzsnso[m], snowh)
            p1n = snliq[m] + snice[m]
            sice = _set(sice, 0, torch.where(
                solo & ~pos & (p1n < 0.0),
                torch.clamp(sice[0] + p1n / (dzsnso_soil1 * 1000.0),
                            min=0.0),
                sice[0]))
            ponding1 = torch.where(solo & ~pos, torch.clamp(p1n, min=0.0),
                                   ponding1)
            sneqv = torch.where(solo & ~pos, 0.0, sneqv)
            snowh = torch.where(solo & ~pos, 0.0, snowh)
            snliq = _set(snliq, m, torch.where(solo, 0.0, snliq[m]))
            snice = _set(snice, m, torch.where(solo, 0.0, snice[m]))
            dzsnso = _set(dzsnso, m, torch.where(solo, 0.0, dzsnso[m]))
        shift = low[None] & (j_ax3 <= j) & (j_ax3 >= isnow[None] + 2)
        stc_s = stc[:NSNOW]
        stc_s, snliq, snice, dzsnso = _shift_down_nmp(
            (stc_s, snliq, snice, dzsnso), shift)
        stc = torch.cat([stc_s, stc[NSNOW:]], 0)
        isnow = torch.where(low, isnow + 1, isnow)

    neg_ice = sice[0] < 0.0
    sh2o = _set(sh2o, 0, torch.where(neg_ice, sh2o[0] + sice[0], sh2o[0]))
    sice = _set(sice, 0, torch.where(neg_ice, 0.0, sice[0]))

    multi = isnow < 0
    smask = _snow_mask(isnow)[:NSNOW]
    sneqv_s = _sum0(torch.where(smask, snice + snliq, 0.0))
    snowh_s = _sum0(torch.where(smask, dzsnso, 0.0))
    zwice = _sum0(torch.where(smask, snice, 0.0))
    zwliq = _sum0(torch.where(smask, snliq, 0.0))
    sneqv = torch.where(multi, sneqv_s, sneqv)
    snowh = torch.where(multi, snowh_s, snowh)

    gone = multi & (snowh < gone_thresh)
    isnow = torch.where(gone, 0, isnow)
    sneqv = torch.where(gone, zwice, sneqv)
    ponding2 = torch.where(gone, zwliq, ponding2)
    snowh = torch.where(gone & (sneqv <= 0.0), 0.0, snowh)

    # pass 2: combine below-minimum layers
    dzmin = torch.tensor(list(dzmin_vals), dtype=torch.float32, device=dev)
    isnow_old2 = isnow
    mssi = torch.ones_like(isnow)
    for i in range(-NSNOW + 1, 1):
        mi = i + NSNOW - 1
        act = (isnow < -1) & (i >= isnow_old2 + 1)
        thin = dzsnso[mi] < dzmin[torch.clamp(mssi - 1, 0, NSNOW - 1).long()]
        do = act & thin
        is_top = i == (isnow + 1)
        is_bot = i == 0
        dz_m1 = dzsnso[max(mi - 1, 0)]
        dz_p1 = dzsnso[min(mi + 1, NSNOW - 1)]
        if is_bot:
            neibor = torch.where(is_top, i + 1, i - 1)
        else:
            neibor = torch.where(
                is_top, i + 1,
                torch.where(dz_m1 + dzsnso[mi] < dz_p1 + dzsnso[mi],
                            i - 1, i + 1))
        neibor = _i32(neibor)
        jidx = torch.clamp(neibor, min=i) + NSNOW - 1
        lidx = torch.clamp(neibor, max=i) + NSNOW - 1
        stc_s = stc[:NSNOW]
        dzc, liqc, icec, tc = _combo_nmp(
            _gather_m(dzsnso, jidx), _gather_m(snliq, jidx),
            _gather_m(snice, jidx), _gather_m(stc_s, jidx),
            _gather_m(dzsnso, lidx), _gather_m(snliq, lidx),
            _gather_m(snice, lidx), _gather_m(stc_s, lidx))
        dzsnso = _scatter_m(dzsnso, jidx, dzc, do)
        snliq = _scatter_m(snliq, jidx, liqc, do)
        snice = _scatter_m(snice, jidx, icec, do)
        stc_s = _scatter_m(stc_s, jidx, tc, do)
        shift = do[None] & (m_ax <= jidx[None] - 1) \
            & (j_ax3 >= isnow[None] + 2)
        stc_s, snliq, snice, dzsnso = _shift_down_nmp(
            (stc_s, snliq, snice, dzsnso), shift)
        stc = torch.cat([stc_s, stc[NSNOW:]], 0)
        isnow = torch.where(do, isnow + 1, isnow)
        mssi = torch.where(act & ~thin, mssi + 1, mssi)

    return (isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh, sneqv,
            ponding1, ponding2)


def divide_snow(p, isnow, stc, snice, snliq, dzsnso, split2_thresh=0.20):
    """Subdivide thick layers (DIVIDE, :6691-6817); NoahMP's 3-layer
    cascade in top-down compressed coordinates."""
    dev = isnow.device
    msno = -isnow
    k_ax = torch.arange(1, NSNOW + 1, dtype=torch.int32,
                        device=dev)[:, None, None]
    gidx = k_ax + isnow[None] + (NSNOW - 1)

    def gath(a):
        return list(take_level(a, gidx).unbind(0))
    stc_s = stc[:NSNOW]
    dz, swice, swliq, tsno = (gath(dzsnso), gath(snice), gath(snliq),
                              gath(stc_s))

    c = (msno == 1) & (dz[0] > 0.05)
    half = 0.5 * dz[0]
    dz[1] = torch.where(c, half, dz[1])
    dz[0] = torch.where(c, half, dz[0])
    swice[1] = torch.where(c, 0.5 * swice[0], swice[1])
    swice[0] = torch.where(c, 0.5 * swice[0], swice[0])
    swliq[1] = torch.where(c, 0.5 * swliq[0], swliq[1])
    swliq[0] = torch.where(c, 0.5 * swliq[0], swliq[0])
    tsno[1] = torch.where(c, tsno[0], tsno[1])
    msno = torch.where(c, 2, msno)

    # trim layer 1 to 0.05 m, merge excess into layer 2
    c1 = (msno > 1) & (dz[0] > 0.05)
    drr = dz[0] - 0.05
    propor = drr / torch.clamp(dz[0], min=MPE)
    zwice = propor * swice[0]
    zwliq = propor * swliq[0]
    keep = _rdiv(0.05, torch.clamp(dz[0], min=MPE))
    dzc, liqc, icec, tc = _combo_nmp(dz[1], swliq[1], swice[1], tsno[1],
                                     drr, zwliq, zwice, tsno[0])
    swice[0] = torch.where(c1, keep * swice[0], swice[0])
    swliq[0] = torch.where(c1, keep * swliq[0], swliq[0])
    dz[0] = torch.where(c1, 0.05, dz[0])
    dz[1] = torch.where(c1, dzc, dz[1])
    swliq[1] = torch.where(c1, liqc, swliq[1])
    swice[1] = torch.where(c1, icec, swice[1])
    tsno[1] = torch.where(c1, tc, tsno[1])
    # split layer 2 with temperature gradient (:6769-6783)
    c2 = c1 & (msno <= 2) & (dz[1] > split2_thresh)
    dtdz = (tsno[0] - tsno[1]) / torch.clamp((dz[0] + dz[1]) * 0.5,
                                             min=MPE)
    half2 = 0.5 * dz[1]
    t3 = tsno[1] - dtdz * half2 * 0.5
    warm3 = t3 >= TFRZ
    dz[2] = torch.where(c2, half2, dz[2])
    swice[2] = torch.where(c2, 0.5 * swice[1], swice[2])
    swliq[2] = torch.where(c2, 0.5 * swliq[1], swliq[2])
    tsno[2] = torch.where(c2, torch.where(warm3, tsno[1], t3), tsno[2])
    tsno[1] = torch.where(c2 & ~warm3, tsno[1] + dtdz * half2 * 0.5,
                          tsno[1])
    dz[1] = torch.where(c2, half2, dz[1])
    swice[1] = torch.where(c2, 0.5 * swice[1], swice[1])
    swliq[1] = torch.where(c2, 0.5 * swliq[1], swliq[1])
    msno = torch.where(c2, 3, msno)

    # trim layer 2 to 0.2 m, excess into layer 3
    c3 = (msno > 2) & (dz[1] > 0.2)
    drr = dz[1] - 0.2
    propor = drr / torch.clamp(dz[1], min=MPE)
    zwice = propor * swice[1]
    zwliq = propor * swliq[1]
    keep = _rdiv(0.2, torch.clamp(dz[1], min=MPE))
    dzc, liqc, icec, tc = _combo_nmp(dz[2], swliq[2], swice[2], tsno[2],
                                     drr, zwliq, zwice, tsno[1])
    swice[1] = torch.where(c3, keep * swice[1], swice[1])
    swliq[1] = torch.where(c3, keep * swliq[1], swliq[1])
    dz[1] = torch.where(c3, 0.2, dz[1])
    dz[2] = torch.where(c3, dzc, dz[2])
    swliq[2] = torch.where(c3, liqc, swliq[2])
    swice[2] = torch.where(c3, icec, swice[2])
    tsno[2] = torch.where(c3, tc, tsno[2])

    isnow = -msno
    m_ax = torch.arange(NSNOW, dtype=torch.int32, device=dev)[:, None, None]
    j_ax3 = m_ax - (NSNOW - 1)
    cidx = torch.clamp(j_ax3 - isnow[None] - 1, 0, NSNOW - 1)
    smask3 = j_ax3 >= isnow[None] + 1

    def scat(stack, comp):
        return torch.where(smask3, take_level(torch.stack(comp), cidx),
                           stack)
    dzsnso = scat(dzsnso, dz)
    snice = scat(snice, swice)
    snliq = scat(snliq, swliq)
    stc = torch.cat([scat(stc[:NSNOW], tsno), stc[NSNOW:]], 0)
    return isnow, stc, snice, snliq, dzsnso


def _fix_soil_ice(sh2o, sice):
    """Negative top-layer soil ice taken from the liquid water."""
    fix = sice[0] < 0.0
    sh2o = _set(sh2o, 0, torch.where(fix, sh2o[0] + sice[0], sh2o[0]))
    sice = _set(sice, 0, torch.where(fix, 0.0, sice[0]))
    return sh2o, sice


def snowh2o(p, dt, qsnfro, qsnsub, qrain, isnow, dzsnso, snowh, sneqv,
            snice, snliq, sh2o, sice, stc, dzsnso_soil1):
    """Snowpack liquid percolation (SNOWH2O, :6979-7126); positive
    thickness stack. Returns updated arrays + qsnbot, ponding1/2."""
    ponding1 = torch.zeros_like(sneqv)
    ponding2 = torch.zeros_like(sneqv)
    # no snowpack: frost/sublimation go to soil ice
    none_ = sneqv == 0.0
    sice = _set(sice, 0, torch.where(
        none_, sice[0] + (qsnfro - qsnsub) * dt / (dzsnso_soil1 * 1000.0),
        sice[0]))
    sh2o, sice = _fix_soil_ice(sh2o, sice)

    # bulk (layerless) snowpack
    bulk = (isnow == 0) & (sneqv > 0.0)
    temp = sneqv
    sneqv_n = sneqv - qsnsub * dt + qsnfro * dt
    propor = sneqv_n / torch.clamp(temp, min=MPE)
    snowh_n = torch.clamp(propor * snowh, min=0.0)
    snowh_n = torch.minimum(torch.maximum(snowh_n, sneqv_n * inv(500.0)),
                            sneqv_n * inv(50.0))
    neg = sneqv_n < 0.0
    sice = _set(sice, 0, torch.where(
        bulk & neg, sice[0] + sneqv_n / (dzsnso_soil1 * 1000.0), sice[0]))
    sneqv = torch.where(bulk, torch.clamp(sneqv_n, min=0.0), sneqv)
    snowh = torch.where(bulk, torch.where(neg, 0.0, snowh_n), snowh)
    sh2o, sice = _fix_soil_ice(sh2o, sice)

    tiny = (snowh <= 1e-8) | (sneqv <= 1e-6)
    snowh = torch.where(tiny, 0.0, snowh)
    sneqv = torch.where(tiny, 0.0, sneqv)

    # multilayer: sublimation from top layer, then a possible combine
    multi = isnow < 0
    mtop = isnow + NSNOW
    ice_t = _gather_m(snice, mtop)
    wgdif = ice_t - qsnsub * dt + qsnfro * dt
    snice = _scatter_m(snice, mtop, wgdif, multi)
    # the reference re-runs COMBINE for over-sublimated layers; calling it
    # unconditionally is equivalent (it no-ops when nothing qualifies)
    (isnow, sh2o, sice, stc, snice, snliq, dzsnso, snowh, sneqv,
     p1c, p2c) = combine_snow(p, isnow, sh2o, sice, stc, snice, snliq,
                              dzsnso, snowh, sneqv, dzsnso_soil1)
    ponding1 = ponding1 + p1c
    ponding2 = ponding2 + p2c
    multi = isnow < 0
    mtop = isnow + NSNOW
    liq_t = _gather_m(snliq, mtop)
    snliq = _scatter_m(snliq, mtop,
                       torch.clamp(liq_t + qrain * dt, min=0.0), multi)

    # gravitational percolation, top-down
    smask = _snow_mask(isnow)[:NSNOW]
    dz_s = torch.clamp(dzsnso[:NSNOW], min=MPE)
    vol_ice = torch.clamp(snice / (dz_s * DENICE), max=1.0)
    epore = 1.0 - vol_ice
    qin = torch.zeros_like(sneqv)
    qout = torch.zeros_like(sneqv)
    max_liq_frac = 0.4
    rows = list(snliq.unbind(0))
    for m in range(NSNOW):
        act = smask[m]
        liq_m = torch.where(act, rows[m] + qin, rows[m])
        vol_liq = liq_m / (dz_s[m] * DENH2O)
        q = torch.clamp((vol_liq - p.ssi * epore[m]) * dzsnso[m], min=0.0)
        if m == NSNOW - 1:   # j == 0, bottom snow layer
            q = torch.maximum((vol_liq - epore[m]) * dzsnso[m],
                              p.snow_ret_fac * dt * q)
        q = q * DENH2O
        liq_m = liq_m - torch.where(act, q, 0.0)
        # cap liquid mass fraction at 0.4
        over = act & (liq_m / torch.clamp(snice[m] + liq_m, min=MPE)
                      > max_liq_frac)
        cap = max_liq_frac / (1.0 - max_liq_frac) * snice[m]
        q = q + torch.where(over, liq_m - cap, 0.0)
        liq_m = torch.where(over, cap, liq_m)
        rows[m] = liq_m
        qin = torch.where(act, q, qin)
        qout = torch.where(act, q, qout)
    snliq = torch.stack(rows)
    dz3 = torch.where(smask, torch.maximum(dzsnso[:NSNOW],
                                           snliq * inv(DENH2O)
                                           + snice * inv(DENICE)),
                      dzsnso[:NSNOW])
    dzsnso = torch.cat([dz3, dzsnso[NSNOW:]], 0)
    qsnbot = qout / dt
    return (isnow, dzsnso, snowh, sneqv, snice, snliq, sh2o, sice, stc,
            qsnbot, ponding1, ponding2)


def _snow_cleanup(isnow, sneqv, snice, snliq, stc, dz3, dt, cap_mm):
    """Zero the dead layers, then the glacier flow above ``cap_mm``
    (SNOWWATER :6398-6405)."""
    smask = _snow_mask(isnow)[:NSNOW]
    snice = torch.where(smask, snice, 0.0)
    snliq = torch.where(smask, snliq, 0.0)
    stc = torch.cat([torch.where(smask, stc[:NSNOW], 0.0), stc[NSNOW:]], 0)
    dz3 = torch.where(smask, dz3, 0.0)
    over = sneqv > cap_mm
    m0 = NSNOW - 1
    bdsnow = snice[m0] / torch.clamp(dz3[m0], min=MPE)
    flow = torch.where(over, sneqv - cap_mm, 0.0)
    snice = _set(snice, m0, torch.where(over, snice[m0] - flow, snice[m0]))
    dz3 = _set(dz3, m0, torch.where(
        over, dz3[m0] - flow / torch.clamp(bdsnow, min=MPE), dz3[m0]))
    snoflow = flow / dt
    multi = isnow < 0
    sneqv = torch.where(multi, _sum0(torch.where(smask, snice + snliq, 0.0)),
                        sneqv)
    return sneqv, snice, snliq, stc, dz3, snoflow


def _layer_depths(isnow, dzsnso):
    """zsnso, the layer-bottom depths (negative downward) of the active
    layers (:6407-6429)."""
    act = _active(isnow)
    zsnso = pw.cumsum(torch.where(act, dzsnso, 0.0), 0)
    top_off = _gather_m(zsnso, isnow + NSNOW) - _gather_m(
        dzsnso, isnow + NSNOW)
    return -(zsnso - top_off[None])


def _soil_dz(zsoil):
    """(NSOIL, 1, 1) soil layer thicknesses from the layer-bottom depths."""
    return torch.cat([-zsoil[:1], -(zsoil[1:] - zsoil[:-1])])[:, None, None]


def snowwater(p, dt, zsoil, sfctmp, snowhin, qsnow, qsnfro, qsnsub,
              qrain, ficeold, imelt, isnow, snowh, sneqv, snice, snliq,
              sh2o, sice, stc, dzsnso):
    """Snow hydrology driver (SNOWWATER, :6300-6431). dzsnso arrives as
    the positive-thickness stack; returns it rebuilt along with zsnso."""
    dz3 = dzsnso[:NSNOW]
    isnow, snowh, sneqv, dz3, stc, snice, snliq = snowfall_acc(
        p, dt, qsnow, snowhin, sfctmp, isnow, snowh, sneqv, dz3, stc,
        snice, snliq)
    dz3 = compact_snow(p, dt, stc, snice, snliq, imelt, ficeold, isnow,
                       dz3)
    (isnow, sh2o, sice, stc, snice, snliq, dz3, snowh, sneqv, p1a,
     p2a) = combine_snow(p, isnow, sh2o, sice, stc, snice, snliq, dz3,
                         snowh, sneqv, dzsnso[NSNOW])
    isnow, stc, snice, snliq, dz3 = divide_snow(p, isnow, stc, snice,
                                                snliq, dz3)
    (isnow, dz3, snowh, sneqv, snice, snliq, sh2o, sice, stc, qsnbot,
     p1b, p2b) = snowh2o(p, dt, qsnfro, qsnsub, qrain, isnow, dz3,
                         snowh, sneqv, snice, snliq, sh2o, sice, stc,
                         dzsnso[NSNOW])
    ponding1 = p1a + p1b
    ponding2 = p2a + p2b

    # zero dead layers; glacier flow cap at 5000 mm (:6398-6405)
    sneqv, snice, snliq, stc, dz3, snoflow = _snow_cleanup(
        isnow, sneqv, snice, snliq, stc, dz3, dt, 5000.0)

    # rebuild zsnso/dzsnso (negative-downward bookkeeping, :6407-6429)
    dzsnso = torch.cat([dz3, _soil_dz(zsoil).expand(
        (NSOIL,) + tuple(dz3.shape[1:]))], 0)
    zsnso = _layer_depths(isnow, dzsnso)
    return (isnow, snowh, sneqv, snice, snliq, sh2o, sice, stc, zsnso,
            dzsnso, qsnbot, snoflow, ponding1, ponding2)


# ==========================================================================
# soil water (SOILWATER/SRT/SSTEP/WDFCND1, :7128-7894; OPT_RUN=1/OPT_INF=1)
# ==========================================================================

def wdfcnd1(p, smc, fcr):
    """Soil water diffusivity/conductivity, NY06-impedance (WDFCND1)."""
    factr = torch.clamp(smc / p.smcmax[None], min=0.01)
    wdf = p.dwsat[None] * pw.pow(factr, p.bexp[None] + 2.0) * (1.0 - fcr)
    wcnd = p.dksat[None] * pw.pow(factr, 2.0 * p.bexp[None] + 3.0) \
        * (1.0 - fcr)
    return wdf, wcnd


def srt_sstep(p, dt, zsoil, dzsoil, pddum, etrani, qseva, sh2o, smc,
              zwt, fcr, smcwtd=None):
    """One Richards substep: SRT matrix + SSTEP tridiagonal update with
    saturation-excess push-up. Returns (sh2o, smc, wplus, wcnd)."""
    wdf, wcnd = wdfcnd1(p, smc, fcr)
    sice = torch.clamp(smc - sh2o, min=0.0)   # constant through the substep
    smx = smc
    zs = zsoil[:, None, None]
    zs_m1 = torch.cat([torch.zeros_like(zs[:1]), zs[:-1]], 0)
    smx_p1 = _up1(smx)
    denom = zs_m1 - zs                      # (z(k-1)-z(k)); row 1: -z(1)
    # per-row temp1: row 1: -z(2); rows k<NSOIL: z(k-1)-z(k+1);
    # bottom row: z(n-1)-z(n)
    temp1 = torch.cat(
        [(-zs[1])[None]] + [(zs[k - 1] - zs[k + 1])[None]
                            for k in range(1, NSOIL - 1)]
        + [(zs[NSOIL - 2] - zs[NSOIL - 1])[None]], 0)
    ddz = _rdiv(2.0, temp1)
    dsmdz = 2.0 * (smx - smx_p1) / temp1
    wdf_m1 = _down1(wdf)
    wcnd_m1 = _down1(wcnd)
    dsmdz_m1 = _down1(dsmdz)
    ddz_m1 = _down1(ddz)

    wflux_top = (wdf[0] * dsmdz[0] + wcnd[0] - pddum + etrani[0] + qseva)
    wflux_mid = (wdf * dsmdz + wcnd - wdf_m1 * dsmdz_m1 - wcnd_m1
                 + etrani)
    qdrain = torch.zeros_like(pddum)          # OPT_RUN = 1
    wflux_bot = (-(wdf_m1[-1] * dsmdz_m1[-1]) - wcnd_m1[-1]
                 + etrani[-1] + qdrain)
    wflux = _set(_set(wflux_mid, 0, wflux_top), -1, wflux_bot)

    ai = -wdf_m1 * ddz_m1 / denom
    ai = _set(ai, 0, 0.0)
    ci = -wdf * ddz / denom
    ci = _set(ci, -1, 0.0)
    bi_top = wdf[0] * ddz[0] / denom[0]
    bi = -(ai + ci)
    bi = _set(bi, 0, bi_top)
    ci = _set(ci, 0, -bi_top)
    rhstt = wflux / (-denom)

    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    r = rhstt * dt
    active = torch.ones(sh2o.shape, dtype=torch.bool, device=sh2o.device)
    dsh = _thomas_stack(a, b, c, r, active)
    sh = list((sh2o + dsh).unbind(0))

    # push saturation excess upward then downward (SSTEP :7760-7790)
    for k in range(NSOIL - 1, 0, -1):
        epore = torch.clamp(p.smcmax - sice[k], min=1e-4)
        wp = torch.clamp(sh[k] - epore, min=0.0) * dzsoil[k]
        sh[k] = torch.minimum(epore, sh[k])
        sh[k - 1] = sh[k - 1] + wp / dzsoil[k - 1]
    epore = torch.clamp(p.smcmax - sice[0], min=1e-4)
    wplus = torch.clamp(sh[0] - epore, min=0.0) * dzsoil[0]
    sh[0] = torch.minimum(epore, sh[0])
    overflow = wplus > 0.0
    sh[1] = sh[1] + torch.where(overflow, wplus / dzsoil[1], 0.0)
    for k in range(1, NSOIL - 1):
        epore = torch.clamp(p.smcmax - sice[k], min=1e-4)
        wp = torch.clamp(sh[k] - epore, min=0.0) * dzsoil[k]
        sh[k] = torch.minimum(epore, sh[k])
        sh[k + 1] = sh[k + 1] + wp / dzsoil[k + 1]
    epore = torch.clamp(p.smcmax - sice[-1], min=1e-4)
    sh[-1] = torch.minimum(epore, sh[-1])
    # the reference's final WPLUS is the top-layer excess
    sh2o = torch.stack(sh)
    smc = sh2o + sice
    return sh2o, smc, wplus, wcnd


# exp(-4) in float32, the constant of SOILWATER's frozen fraction
_EXP_M4 = np.exp(np.float32(-4.0))


def soilwater(p, dt, zsoil, dzsoil, qinsur, qseva, etrani, sice, sh2o,
              smc, zwt):
    """Soil moisture driver (SOILWATER; OPT_RUN=1 SIMGM surface runoff +
    Richards substeps). Returns (sh2o, smc, runsrf, wcnd, fcrmax)."""
    # saturation excess clamp (:7205-7209)
    epore = torch.clamp(p.smcmax[None] - sice, min=1e-4)
    rsat = _sum0(torch.clamp(sh2o - epore, min=0.0)
                 * dzsoil[:, None, None])
    sh2o = torch.minimum(epore, sh2o)

    a_ = 4.0
    fice = torch.clamp(sice / p.smcmax[None], max=1.0)
    fcr = torch.clamp(pw.exp(-a_ * (1.0 - fice)) - float(_EXP_M4),
                      min=0.0) * inv(np.float32(1.0) - _EXP_M4)
    fcrmax = torch.amax(fcr, dim=0)

    # SIMGM surface runoff (:7241-7248)
    fff = 6.0
    fsat = p.fsatmx * pw.exp(-0.5 * fff * (zwt - 2.0))
    runsrf = torch.where(qinsur > 0.0,
                         qinsur * ((1.0 - fcr[0]) * fsat + fcr[0]), 0.0)
    pddum = torch.where(qinsur > 0.0, qinsur - runsrf, 0.0)

    niter = 3   # the reference doubles to 6 for heavy infiltration;
    # use the worst case uniformly (same scheme, finer substeps)
    dtfine = dt * inv(niter)
    wcnd = None
    for _ in range(niter):
        sh2o, smc, wplus, wcnd = srt_sstep(
            p, dtfine, zsoil, dzsoil, pddum, etrani, qseva, sh2o, smc,
            zwt, fcr)
        rsat = rsat + wplus
    runsrf = runsrf * 1000.0 + rsat * 1000.0 / dt
    return sh2o, smc, runsrf, wcnd, fcrmax


def groundwater(p, dt, sice, zsoil, dzsoil, stc, wcnd, fcrmax, sh2o,
                zwt, wa, wt):
    """SIMGM unconfined-aquifer groundwater (GROUNDWATER, :8243-8428)."""
    rous = 0.2
    cmic = 0.20
    dzmm = dzsoil[:, None, None] * 1e3
    zs = zsoil
    znode = torch.cat(
        [(-zs[0] * 0.5)[None]]
        + [(-zs[iz - 1] + 0.5 * (zs[iz - 1] - zs[iz]))[None]
           for iz in range(1, NSOIL)])

    smc = sh2o + sice
    mliq = sh2o * dzmm
    epore = torch.clamp(p.smcmax[None] - sice, min=0.01)
    hk = 1e3 * wcnd

    # layer index above the water table (1-based iwt in [1..NSOIL])
    iwt = torch.full_like(zwt, NSOIL, dtype=torch.int32)
    for iz in range(NSOIL, 1, -1):     # reverse so the FIRST match wins
        iwt = torch.where(zwt <= -zs[iz - 1], iz - 1, iwt)
    i0 = iwt - 1   # 0-based

    fff, rsbmx = 6.0, 5.0
    qdis = (1.0 - fcrmax) * rsbmx * float(np.exp(np.float32(-p.timean))) \
        * pw.exp(-fff * (zwt - 2.0))
    smc_i = _gather_m(smc, i0)
    hk_i = _gather_m(hk, i0)
    znode_i = znode[torch.clamp(i0, 0, NSOIL - 1).long()]
    s_node = torch.clamp(smc_i / p.smcmax, 0.01, 1.0)
    smpfz = -p.psisat * 1000.0 * pw.pow(s_node, -p.bexp)
    smpfz = torch.clamp(cmic * smpfz, min=-120000.0)
    wh_zwt = -zwt * 1e3
    wh = smpfz - znode_i * 1e3
    qin = -hk_i * (wh_zwt - wh) / torch.clamp((zwt - znode_i) * 1e3,
                                              min=MPE)
    qin = torch.minimum(torch.maximum(qin, _rdiv(-10.0, dt)),
                        _rdiv(10.0, dt))
    wt = wt + (qin - qdis) * dt

    deep = iwt == NSOIL
    wa_d = wa + (qin - qdis) * dt
    zwt_d = (-zs[-1] + 25.0) - wa_d * inv(1000.0) * inv(rous)
    mliq_last_d = mliq[-1] - qin * dt + torch.clamp(wa_d - 5000.0, min=0.0)
    wa_new = torch.where(deep, torch.clamp(wa_d, max=5000.0), wa)
    wt = torch.where(deep, torch.clamp(wa_d, max=5000.0), wt)

    # shallow water table (:8382-8397)
    epore_sum = torch.zeros_like(zwt)
    for iz in range(NSOIL):
        # sum epore over layers iwt+2..NSOIL (1-based) = 0-based > i0+1
        epore_sum = epore_sum + torch.where(
            iz > i0 + 1, epore[iz] * dzmm[iz], 0.0)
    zwt_s1 = -zs[-1] - (wt - rous * 1000.0 * 25.0) / epore[-1] \
        * inv(1000.0)
    zs_ext = torch.cat([zs, zs[-1:]])
    zwt_sn = (-zs_ext[torch.clamp(i0 + 1, 0, NSOIL - 1).long()]
              - (wt - rous * 1000.0 * 25.0 - epore_sum)
              / _gather_m(epore, i0 + 1) * inv(1000.0))
    zwt = torch.where(deep, zwt_d,
                      torch.where(iwt == NSOIL - 1, zwt_s1, zwt_sn))
    wa = wa_new

    wtsub = _sum0(hk * dzmm)
    mliq_shallow = mliq - qdis * dt * hk * dzmm / torch.clamp(wtsub,
                                                              min=MPE)
    mliq = torch.where(deep[None], _set(mliq, -1, mliq_last_d),
                       mliq_shallow)

    zwt = torch.clamp(zwt, min=1.5)

    # minimum-water redistribution (:8403-8420)
    watmin = 0.01
    rows = list(mliq.unbind(0))
    for iz in range(NSOIL - 1):
        xs = torch.where(rows[iz] < 0.0, watmin - rows[iz], 0.0)
        rows[iz] = rows[iz] + xs
        rows[iz + 1] = rows[iz + 1] + (-xs)
    xs = torch.where(rows[-1] < watmin, watmin - rows[-1], 0.0)
    rows[-1] = rows[-1] + xs
    wa = wa - xs
    wt = wt - xs
    sh2o = torch.stack(rows) / dzmm
    return sh2o, zwt, wa, wt, qin, qdis


# ==========================================================================
# water driver (WATER, :5902-6166)
# ==========================================================================

def water(p, dt, fcev, fctr, elai, esai, sfctmp, qvap, qdew, zsoil,
          dzsoil, btrani_frac, ficeold, ponding, tg, fveg, bdfall,
          qsnow, qrain, snowhin, frozen_canopy, frozen_ground, imelt,
          isnow, canliq, canice, tv, snowh, sneqv, snice, snliq, stc,
          zsnso, sh2o, smc, zwt, wa, wt, dzsnso):
    """Water budget: canopy -> snowpack -> soil -> groundwater."""
    (canliq, canice, tv, cmc, ecan, etran_rate, fwet) = canwater(
        p, dt, fcev, fctr, elai, esai, bdfall, frozen_canopy,
        canliq, canice, tv)
    # etran_rate is mm/s total transpiration (ETRAN in the reference)
    has_snow = sneqv > 0.0
    qsnsub = torch.where(has_snow, torch.minimum(qvap, sneqv / dt), 0.0)
    qseva = qvap - qsnsub
    qsnfro = torch.where(has_snow, qdew, 0.0)
    qsdew = qdew - qsnfro

    sice = torch.clamp(smc - sh2o, min=0.0)
    (isnow, snowh, sneqv, snice, snliq, sh2o, sice, stc, zsnso, dzsnso,
     qsnbot, snoflow, ponding1, ponding2) = snowwater(
        p, dt, zsoil, sfctmp, snowhin, qsnow, qsnfro, qsnsub, qrain,
        ficeold, imelt, isnow, snowh, sneqv, snice, snliq, sh2o, sice,
        stc, dzsnso)

    # frozen ground: dew/evap exchange with soil ice (:5999-6007)
    fg = frozen_ground
    sice = _add(sice, 0, torch.where(
        fg, (qsdew - qseva) * dt / (dzsoil[0] * 1000.0), 0.0))
    qsdew = torch.where(fg, 0.0, qsdew)
    qseva = torch.where(fg, 0.0, qseva)
    sh2o, sice = _fix_soil_ice(sh2o, sice)

    qinsur = (ponding + ponding1 + ponding2) / dt * 0.001
    qinsur = qinsur + torch.where(
        isnow == 0, (qsnbot + qsdew + qrain) * 0.001,
        (qsnbot + qsdew) * 0.001)
    qseva_m = qseva * 0.001
    etrani = etran_rate[None] * btrani_frac * 0.001   # (NSOIL, ny, nx) m/s

    smc = sh2o + sice
    sh2o, smc, runsrf, wcnd, fcrmax = soilwater(
        p, dt, zsoil, dzsoil, qinsur, qseva_m, etrani, sice, sh2o, smc,
        zwt)
    sh2o, zwt, wa, wt, qin, qdis = groundwater(
        p, dt, sice, zsoil, dzsoil, stc, wcnd, fcrmax, sh2o, zwt, wa, wt)
    runsub = qdis + snoflow
    smc = sh2o + sice
    return SimpleNamespace(
        isnow=isnow, canliq=canliq, canice=canice, tv=tv, snowh=snowh,
        sneqv=sneqv, snice=snice, snliq=snliq, stc=stc, zsnso=zsnso,
        sh2o=sh2o, smc=smc, sice=sice, zwt=zwt, wa=wa, wt=wt,
        dzsnso=dzsnso, cmc=cmc, ecan=ecan, etran=etran_rate, fwet=fwet,
        runsrf=runsrf, runsub=runsub, qin=qin, qdis=qdis,
        ponding1=ponding1, ponding2=ponding2, qsnbot=qsnbot)


# ==========================================================================
# top-level column driver (NOAHMP_SFLX, :417-605)
# ==========================================================================

def _thicknesses(zsnso, isnow, zsoil):
    """The positive layer thicknesses of the stack from zsnso, the soil's
    from zsoil (:344-350)."""
    zs_m1 = torch.cat([torch.zeros_like(zsnso[:1]), zsnso[:-1]], 0)
    is_top = _stack_j(isnow.device) == (isnow[None] + 1)
    dz = torch.where(is_top, -zsnso, zs_m1 - zsnso)
    dz = torch.where(_active(isnow), dz, 0.0)
    return torch.cat([dz[:NSNOW], _soil_dz(zsoil).expand(
        (NSOIL,) + tuple(dz.shape[1:]))], 0)


def sflx(p, lat, yearlen, julian, cosz, dt, zsoil, dzsoil, shdfac,
         vegtype, sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn, prcp,
         tbot, foln, ficeold, zlvl, state):
    """One NoahMP step over the grid. ``state`` is a dict of prognostic
    fields (albold, sneqvo, stc, sh2o, smc, tah, eah, fwet, canliq,
    canice, tv, tg, qsfc, isnow, zsnso, snowh, sneqv, snice, snliq, zwt,
    wa, wt, lai, sai, cm, ch, tauss). Returns (outputs, new_state)."""
    s = dict(state)
    isnow = s["isnow"]
    dzsnso_all = _thicknesses(s["zsnso"], isnow, zsoil)
    dz_soil_static = _soil_dz(zsoil)

    at = atm(p, sfcprs, sfctmp, q2, prcp, soldn, cosz)

    lai, sai, elai, esai, igs = phenology(
        p, vegtype, s["snowh"], s["tv"], lat, yearlen, julian)
    fveg = torch.clamp(shdfac, min=0.05)    # DVEG == 1
    fveg = torch.where(p.urban_flag | (vegtype == p.isbarren), 0.0, fveg)
    fveg = torch.where(elai + esai == 0.0, 0.0, fveg)

    ph = precip_heat(p, dt, uu, vv, elai, esai, fveg, at.bdfall, at.rain,
                     at.snow, at.fp, s["canliq"], s["canice"], s["tv"],
                     sfctmp, s["tg"])

    en = energy(
        p, vegtype, isnow, dt, at.rhoair, sfcprs, at.qair, sfctmp,
        at.thair, lwdn, uu, vv, zlvl, at.solad, at.solai, cosz, igs,
        at.eair, tbot, s["zsnso"], zsoil, elai, esai, ph.fwet, foln,
        fveg, ph.pahv, ph.pahg, ph.pahb, ph.qsnow, dzsnso_all, lat,
        ph.canliq, ph.canice, s["tv"], s["tg"], s["stc"], s["snowh"],
        s["eah"], s["tah"], s["sneqvo"], s["sneqv"], s["sh2o"], s["smc"],
        s["snice"], s["snliq"], s["albold"], s["cm"], s["ch"], q2,
        s["tauss"], psfc)

    sneqvo = en.sneqv
    qvap = torch.clamp(en.fgev / en.latheag, min=0.0)
    qdew = torch.abs(torch.clamp(en.fgev / en.latheag, max=0.0))
    edir = qvap - qdew

    wt_ = water(
        p, dt, en.fcev, en.fctr, elai, esai, sfctmp, qvap, qdew, zsoil,
        dz_soil_static[:, 0, 0], en.btrani, ficeold, en.ponding, en.tg,
        fveg, at.bdfall, ph.qsnow, ph.qrain, ph.snowhin,
        en.frozen_canopy, en.frozen_ground, en.imelt, isnow, ph.canliq,
        ph.canice, en.tv, en.snowh, en.sneqv, en.snice, en.snliq,
        en.stc, s["zsnso"], en.sh2o, en.smc, s["zwt"], s["wa"], s["wt"],
        dzsnso_all)

    snowh = wt_.snowh
    sneqv = wt_.sneqv
    tiny = (snowh <= 1e-6) | (sneqv <= 1e-3)
    snowh = torch.where(tiny, 0.0, snowh)
    sneqv = torch.where(tiny, 0.0, sneqv)
    albedo = torch.where(at.swdown > 0.0,
                         en.fsr / torch.clamp(at.swdown, min=MPE), -999.9)
    qfx = wt_.etran + wt_.ecan + edir

    new_state = dict(
        albold=s["albold"], sneqvo=sneqvo, stc=wt_.stc, sh2o=wt_.sh2o,
        smc=wt_.smc, tah=en.tah, eah=en.eah, fwet=wt_.fwet,
        canliq=wt_.canliq, canice=wt_.canice, tv=wt_.tv, tg=en.tg,
        qsfc=en.qsfc, isnow=wt_.isnow, zsnso=wt_.zsnso, snowh=snowh,
        sneqv=sneqv, snice=wt_.snice, snliq=wt_.snliq, zwt=wt_.zwt,
        wa=wt_.wa, wt=wt_.wt, lai=lai, sai=sai, cm=en.cm, ch=en.ch,
        tauss=en.tauss)
    outputs = dict(
        fsa=en.fsa, fsr=en.fsr, fira=en.fira, fsh=en.fsh, fcev=en.fcev,
        fgev=en.fgev, fctr=en.fctr, ssoil=en.ssoil, trad=en.trad,
        ecan=wt_.ecan, etran=wt_.etran, edir=edir, runsrf=wt_.runsrf,
        runsub=wt_.runsub, apar=en.apar, psn=en.psn, sav=en.sav,
        sag=en.sag, fsno=en.fsno, fveg=fveg, albedo=albedo,
        qsnbot=wt_.qsnbot, ponding=en.ponding, t2m=en.t2m, q2e=en.q2e,
        q1=en.q1, emissi=en.emissi, z0wrf=en.z0wrf, qfx=qfx,
        qmelt=en.qmelt, t2mv=en.t2mv, t2mb=en.t2mb, q2v=en.q2v,
        q2b=en.q2b, chv=en.chv, chb=en.chb, tgv=en.tgv, tgb=en.tgb,
        rssun=en.rssun, rssha=en.rssha, lai=lai, sai=sai,
        elai=elai, esai=esai, fpice=at.fpice, laisun=en.laisun,
        laisha=en.laisha)
    return outputs, new_state


# ==========================================================================
# host-side state initialization (NOAHMP_INIT + SNOW_INIT,
# lsm_noahmpdrv.f90:1443-2149)
# ==========================================================================

ZSOIL = -np.cumsum(np.array([0.1, 0.3, 0.6, 1.0], np.float32))
DZSOIL = np.array([0.1, 0.3, 0.6, 1.0], np.float32)


def noahmp_init_state(tsk, swe, snow_height, soil_t, soil_m, soiltype,
                      vegtype, mp_tables, noah_tables) -> Dict[str, np.ndarray]:
    """Copy of icar_tpu/physics/noahmp.py noahmp_init_state.

    Initial NoahMP prognostic state from ICAR's surface fields.
    All inputs numpy (ny, nx) except soil_t/soil_m (NSOIL, ny, nx)."""
    ny, nx = tsk.shape
    snow = np.asarray(swe, np.float64).copy()
    snowh = np.asarray(snow_height, np.float64).copy()
    nosnowh = (snowh == 0.0) & (snow > 0.0)
    snowh = np.where(nosnowh, snow * 0.005, snowh)
    over = snow > 5000.0
    snowh = np.where(over, snowh * 5000.0 / np.maximum(snow, 1.0), snowh)
    snow = np.minimum(snow, 5000.0)

    si = np.clip(soiltype.astype(np.int32), 1, 19)
    from .noah_params import load_tables
    nt = noah_tables
    bexp = np.asarray(nt.bb)[si]
    smcmax = np.asarray(nt.maxsmc)[si]
    psisat = np.asarray(nt.satpsi)[si]
    smois = np.minimum(np.asarray(soil_m, np.float32), smcmax[None])
    tslb = np.asarray(soil_t, np.float32)
    hlice, grav_, t0 = 3.335e5, 9.81, 273.15
    with np.errstate(invalid="ignore", divide="ignore"):
        fk = ((hlice / (grav_ * (-psisat[None])))
              * ((tslb - t0) / tslb)) ** (-1.0 / bexp[None]) * smcmax[None]
    fk = np.maximum(np.where(np.isfinite(fk), fk, 0.02), 0.02)
    sh2o = np.where(tslb < 273.149, np.minimum(fk, smois), smois)

    # glacier cells start fully frozen (noahmp_init, :1792-1800)
    isice = np.asarray(vegtype) == mp_tables.isice
    smois = np.where(isice[None], 1.0, smois)
    sh2o = np.where(isice[None], 0.0, sh2o)
    tslb = np.where(isice[None], np.minimum(tslb, 263.15), tslb)
    snow = np.where(isice, np.maximum(snow, 10.0), snow)
    snowh = np.where(isice, snow * 0.01, snowh)

    cold = (snow > 0.0) & (tsk > 273.15)
    t_init = np.where(cold, 273.15, tsk).astype(np.float32)

    s = {}
    s["tv"] = t_init.copy()
    s["tg"] = t_init.copy()
    s["canliq"] = np.zeros((ny, nx), np.float32)
    s["canice"] = np.zeros((ny, nx), np.float32)
    s["eah"] = np.full((ny, nx), 2000.0, np.float32)
    s["tah"] = t_init.copy()
    s["cm"] = np.zeros((ny, nx), np.float32)
    s["ch"] = np.zeros((ny, nx), np.float32)
    s["fwet"] = np.zeros((ny, nx), np.float32)
    s["sneqvo"] = np.zeros((ny, nx), np.float32)
    s["albold"] = np.full((ny, nx), 0.65, np.float32)
    s["qsfc"] = np.zeros((ny, nx), np.float32)
    s["tauss"] = np.zeros((ny, nx), np.float32)
    # SIMGM aquifer start (:1824-1828)
    s["wa"] = np.full((ny, nx), 4900.0, np.float32)
    s["wt"] = s["wa"].copy()
    s["zwt"] = np.full((ny, nx), (25.0 + 2.0) - 4900.0 / 1000.0 / 0.2,
                       np.float32)
    t = mp_tables
    noveg = ((vegtype == t.isbarren) | (vegtype == t.isice)
             | (vegtype == t.isurban) | (vegtype == t.iswater))
    lai0 = np.where(noveg, 0.0, 0.5)
    s["lai"] = lai0.astype(np.float32)
    s["sai"] = np.where(noveg, 0.0,
                        np.maximum(0.1 * lai0, 0.05)).astype(np.float32)
    s["smc"] = smois.astype(np.float32)
    s["sh2o"] = sh2o.astype(np.float32)

    # snow layer structure (SNOW_INIT, :2047-2149)
    sd = snowh
    isnow = np.zeros((ny, nx), np.int32)
    dzsno = np.zeros((NSNOW, ny, nx), np.float64)   # m index: j + 2
    m0, m1, m2 = NSNOW - 1, NSNOW - 2, NSNOW - 3

    b1 = (sd >= 0.025) & (sd <= 0.05)
    isnow = np.where(b1, -1, isnow)
    dzsno[m0] = np.where(b1, sd, dzsno[m0])
    b2 = (sd > 0.05) & (sd <= 0.10)
    isnow = np.where(b2, -2, isnow)
    dzsno[m1] = np.where(b2, sd / 2.0, dzsno[m1])
    dzsno[m0] = np.where(b2, sd / 2.0, dzsno[m0])
    b3 = (sd > 0.10) & (sd <= 0.25)
    isnow = np.where(b3, -2, isnow)
    dzsno[m1] = np.where(b3, 0.05, dzsno[m1])
    dzsno[m0] = np.where(b3, sd - 0.05, dzsno[m0])
    b4 = (sd > 0.25) & (sd <= 0.45)
    isnow = np.where(b4, -3, isnow)
    dzsno[m2] = np.where(b4, 0.05, dzsno[m2])
    dzsno[m1] = np.where(b4, 0.5 * (sd - 0.05), dzsno[m1])
    dzsno[m0] = np.where(b4, 0.5 * (sd - 0.05), dzsno[m0])
    b5 = sd > 0.45
    isnow = np.where(b5, -3, isnow)
    dzsno[m2] = np.where(b5, 0.05, dzsno[m2])
    dzsno[m1] = np.where(b5, 0.20, dzsno[m1])
    dzsno[m0] = np.where(b5, sd - 0.25, dzsno[m0])

    tsno = np.zeros((NSNOW, ny, nx), np.float32)
    snice = np.zeros((NSNOW, ny, nx), np.float32)
    snliq = np.zeros((NSNOW, ny, nx), np.float32)
    for m in range(NSNOW):
        j = m - (NSNOW - 1)
        active = j >= isnow + 1
        tsno[m] = np.where(active, s["tg"], 0.0)
        snice[m] = np.where(
            active, dzsno[m] * (snow / np.maximum(sd, 1e-12)), 0.0)

    # zsnso: cumulative layer-bottom depths (negative down)
    dzsnso = np.zeros((NSS, ny, nx), np.float64)
    dzsnso[:NSNOW] = dzsno
    dzsnso[NSNOW:] = DZSOIL[:, None, None]
    zsnso = np.zeros((NSS, ny, nx), np.float32)
    run = np.zeros((ny, nx), np.float64)
    for m in range(NSS):
        j = m - (NSNOW - 1)
        active = j >= isnow + 1
        run = np.where(active, run + dzsnso[m], run)
        zsnso[m] = np.where(active, -run, 0.0)

    s["isnow"] = isnow
    s["snowh"] = snowh.astype(np.float32)
    s["sneqv"] = snow.astype(np.float32)
    s["snice"] = snice
    s["snliq"] = snliq
    s["zsnso"] = zsnso
    # snow temperatures occupy the snow part of stc
    s["stc"] = np.concatenate([tsno, tslb], axis=0).astype(np.float32)
    return s


def noahmp_driver(p, lat, yearlen, julian, cosz, dt, shdfac, vegtype,
                  sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn,
                  prcp_mm, tbot, zlvl, state):
    """Grid-level NoahMP step (noahmplsm, lsm_noahmpdrv.f90:520-1160):
    unit conversions + sflx + output packaging. ``prcp_mm`` is the precip
    accumulated since the last call (mm); q2 is mixing ratio (converted
    to specific humidity as in the WRF driver). ``dt``, ``yearlen`` and
    ``julian`` are numbers or 0-d tensors; ``state['isnow']`` is int32.
    Reads nothing back to the host."""
    dt = _dt_tensor(dt, sfctmp)
    qair = q2 / (1.0 + q2)
    prcp = prcp_mm / dt
    ficeold = torch.where(
        state["snice"] + state["snliq"] > 0.0,
        state["snice"] / torch.clamp(state["snice"] + state["snliq"],
                                     min=MPE), 0.0)
    foln = torch.ones_like(sfctmp)
    dev = sfctmp.device
    out, new = sflx(p, lat, yearlen, julian, cosz, dt,
                    torch.as_tensor(ZSOIL, device=dev),
                    torch.as_tensor(DZSOIL, device=dev), shdfac,
                    vegtype, sfctmp, sfcprs, psfc, uu, vv, qair, soldn,
                    lwdn, prcp, tbot, foln, ficeold, zlvl, state)
    # fluxes back to ICAR conventions (lsm_driver takes W/m2 up)
    out["hfx"] = out["fsh"]
    out["lh"] = out["fcev"] + out["fgev"] + out["fctr"]
    out["grdflx"] = out["ssoil"]
    out["tsk"] = out["trad"]
    return out, new

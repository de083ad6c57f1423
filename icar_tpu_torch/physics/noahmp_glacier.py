"""Noah-MP glacier column (vegtype == isice cells under lsm=4)
(icar_tpu/physics/noahmp_glacier.py: MODULE_SF_NOAHMP_GLACIER for ICAR's
option set -- iopt_gla=1 phase change, BATS albedo, semi-implicit
temperature, Noah TBOT). The snow machinery is the main Noah-MP module's
with the glacier's thresholds: new-layer initiation at 0.05 m, combine
minima (0.045, 0.05, 0.2), snowpack-gone threshold 0.05 m, layer-2 split
at 0.10 m, glacier-flow cap at 2000 mm.

Plain PyTorch over the (ny, nx) grid as ``noahmp.py``; nothing is read
back to the host.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.pointwise import inv
from .noahmp import (CPAIR, HFUS, HSUB, MPE, NSNOW, NSOIL, RAIR, SB, TFRZ,
                     VKC, _blend_top, _cube, _dt_tensor, _estg,
                     _layer_depths, _mo_state, _pow4, _set, _snow_cleanup,
                     _sum0, _thicknesses, _top_layer, combine_snow,
                     compact_snow, csnow, divide_snow, esat, sfcdif1,
                     snow_age, snowalb_bats, snowfall_acc, snowh2o, tsnosoi)

ALBICE = np.array([0.80, 0.55], np.float32)   # land-ice albedo vis/nir


def thermoprop_glacier(p, isnow, dzsnso, dt, snowh, snice, snliq):
    """Glacier thermal properties: snow from CSNOW, ice below with
    depth-dependent capacity/conductivity (THERMOPROP_GLACIER,
    lsm_noahmp_glacier.f90:537-608)."""
    tksno, cvsno, snicev, snliqv, epore = csnow(isnow, snice, snliq, dzsnso)
    # mid-point depth of each ice layer
    zmid = pw.cumsum(dzsnso[NSNOW:], 0) - 0.5 * dzsnso[NSNOW:]
    hcpct_ice = 1e6 * (0.8194 + 0.1309 * zmid)
    df_ice = 0.32333 + 0.10073 * zmid
    df = torch.cat([tksno, df_ice], 0)
    hcpct = torch.cat([cvsno, hcpct_ice], 0)
    fact = dt / (torch.clamp(hcpct, min=MPE) * torch.clamp(dzsnso, min=MPE))
    df = _blend_top(df, dzsnso, isnow, snowh)
    return df, hcpct, fact


def radiation_glacier(p, dt, tg, sneqvo, sneqv, cosz, qsnow, solad, solai,
                      tauss):
    """Snow/ice albedo mix (RADIATION_GLACIER, :666-754)."""
    tauss, fage = snow_age(p, dt, tg, sneqvo, sneqv, tauss)
    albsnd, albsni = snowalb_bats(p, cosz, fage)
    dark = cosz <= 0.0
    albsnd = torch.where(dark[None], 0.0, albsnd)
    albsni = torch.where(dark[None], 0.0, albsni)
    fsno = torch.where(sneqv > 0.0, 1.0, torch.zeros_like(sneqv))
    albice = torch.as_tensor(ALBICE, device=tg.device)[:, None, None]
    albsnd = albice * (1.0 - fsno[None]) + albsnd * fsno[None]
    albsni = albice * (1.0 - fsno[None]) + albsni * fsno[None]
    absd = solad * (1.0 - albsnd) + solai * (1.0 - albsni)
    sag = _sum0(absd)
    fsr = _sum0(solad * albsnd + solai * albsni)
    return sag, sag, fsr, tauss   # fsa == sag for glacier


def glacier_flux(p, isnow, df, dzsnso, z0m, zlvl, zpd, qair, sfctmp,
                 rhoair, sfcprs, ur, gamma, rsurf, lwdn, rhsur, smc,
                 eair, stc, sag, snowh, lathea, sh2o, cm, ch, tgb, uu,
                 vv):
    """Glacier surface energy balance (GLACIER_FLUX, :904-1119); a
    bare-ground Newton solve with EMG = 0.98 and a freezing cap tied to
    the presence of ice/snow."""
    emg = 0.98
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
    for it in range(1, 6):
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
        b = sag - irb - shb - evb - ghb
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

    sice = torch.clamp(smc - sh2o, min=0.0)
    cap = ((torch.amax(sice, dim=0) > 0.0) | (snowh > 0.0)) & (tgb > TFRZ)
    tgb = torch.where(cap, TFRZ, tgb)
    # the reference re-evaluates ESTG over ice at the capped TG (:1035)
    _, estg_i, _, _ = esat(torch.clamp(tgb - TFRZ, -50.0, 50.0))
    qsfc = torch.where(cap,
                       0.622 * (estg_i * rhsur)
                       / (sfcprs - 0.378 * (estg_i * rhsur)), qsfc)
    irb = torch.where(cap, cir * _pow4(tgb) - emg * lwdn, irb)
    shb = torch.where(cap, csh * (tgb - sfctmp), shb)
    evb = torch.where(cap, cev * (estg_i * rhsur - eair), evb)
    ghb = torch.where(cap, sag - (irb + shb + evb), ghb)

    small = ehb2 < 1e-5
    t2mb = torch.where(small, tgb,
                       tgb - shb / (rhoair * CPAIR)
                       / torch.clamp(ehb2, min=MPE))
    q2b = torch.where(small, qsfc,
                      qsfc - evb / (lathea * rhoair)
                      * (1.0 / torch.clamp(ehb2, min=MPE) + rsurf))
    ehb = 1.0 / torch.clamp(1.0 / (ch * ur), min=1.0)
    return SimpleNamespace(tgb=tgb, cm=cm, ch=ehb, irb=irb, shb=shb,
                           evb=evb, ghb=ghb, t2mb=t2mb, q2b=q2b,
                           qsfc=qsfc, ehb2=ehb2)


def phasechange_glacier(p, isnow, dt, fact, dzsnso, stc, snice, snliq,
                        sneqv, snowh, smc, sh2o):
    """Glacier phase change, OPT_GLA=1 (PHASECHANGE_GLACIER, :1608-1995):
    snow layers like the land version (no supercooling), ice layers with
    inter-layer heat and ice/liquid redistribution passes."""
    qmelt = torch.zeros_like(sneqv)
    ponding = torch.zeros_like(sneqv)

    # --- snow layers
    mice_s = snice
    mliq_s = snliq
    wice0 = mice_s
    wmass0 = mice_s + mliq_s
    j = torch.arange(NSNOW, dtype=torch.int32,
                     device=isnow.device)[:, None, None] - (NSNOW - 1)
    smask = j >= isnow[None] + 1
    stc_snow = stc[:NSNOW]
    imelt_s = torch.zeros_like(snice, dtype=torch.int32)
    imelt_s = torch.where(smask & (mice_s > 0.0) & (stc_snow >= TFRZ),
                          1, imelt_s)
    imelt_s = torch.where(smask & (mliq_s > 0.0) & (stc_snow < TFRZ),
                          2, imelt_s)
    melting = imelt_s > 0
    hm = torch.where(melting, (stc_snow - TFRZ) / fact[:NSNOW], 0.0)
    stc_snow = torch.where(melting, TFRZ, stc_snow)
    bad = ((imelt_s == 1) & (hm < 0.0)) | ((imelt_s == 2) & (hm > 0.0))
    hm = torch.where(bad, 0.0, hm)
    imelt_s = torch.where(bad, 0, imelt_s)
    xm = hm * dt * inv(HFUS)
    do = (imelt_s > 0) & (torch.abs(hm) > 0.0)
    mice_new = torch.where(xm > 0.0, torch.clamp(wice0 - xm, min=0.0),
                           torch.where(xm < 0.0,
                                       torch.minimum(wmass0, wice0 - xm),
                                       mice_s))
    heatr = hm - HFUS * (wice0 - mice_new) / dt
    mliq_new = torch.clamp(wmass0 - mice_new, min=0.0)
    stc_s = torch.where(do & (torch.abs(heatr) > 0.0),
                        stc_snow + fact[:NSNOW] * heatr, stc_snow)
    stc_s = torch.where(do & (torch.abs(heatr) > 0.0)
                        & (mliq_new * mice_new > 0.0), TFRZ, stc_s)
    snice = torch.where(do, mice_new, mice_s)
    snliq = torch.where(do, mliq_new, mliq_s)
    qmelt = qmelt + _sum0(
        torch.where(do, torch.clamp(wice0 - mice_new, min=0.0), 0.0)) / dt

    # --- ice (soil) layers
    mliq = sh2o * dzsnso[NSNOW:] * 1000.0
    mice = (smc - sh2o) * dzsnso[NSNOW:] * 1000.0
    wice0g = mice
    wmass0g = mice + mliq
    stc_g = stc[NSNOW:]
    imelt_g = torch.zeros_like(mice, dtype=torch.int32)
    imelt_g = torch.where((mice > 0.0) & (stc_g >= TFRZ), 1, imelt_g)
    imelt_g = torch.where((mliq > 0.0) & (stc_g < TFRZ), 2, imelt_g)
    thin = (isnow == 0) & (sneqv > 0.0)
    imelt_g = _set(imelt_g, 0, torch.where(thin & (stc_g[0] >= TFRZ), 1,
                                           imelt_g[0]))
    melting = imelt_g > 0
    hmg = torch.where(melting, (stc_g - TFRZ) / fact[NSNOW:], 0.0)
    stc_g = torch.where(melting, TFRZ, stc_g)
    bad = ((imelt_g == 1) & (hmg < 0.0)) | ((imelt_g == 2) & (hmg > 0.0))
    hmg = torch.where(bad, 0.0, hmg)
    imelt_g = torch.where(bad, 0, imelt_g)
    xmg = hmg * dt * inv(HFUS)

    # layerless snowpack melt over ice (:1745-1766)
    do_thin = thin & (xmg[0] > 0.0)
    temp1 = sneqv
    sneqv_n = torch.clamp(temp1 - xmg[0], min=0.0)
    propor = sneqv_n / torch.clamp(temp1, min=MPE)
    snowh_n = torch.clamp(propor * snowh, min=0.0)
    heatr0 = hmg[0] - HFUS * (temp1 - sneqv_n) / dt
    xm0 = torch.where(heatr0 > 0.0, heatr0 * dt * inv(HFUS), 0.0)
    hm0 = torch.where(heatr0 > 0.0, heatr0, 0.0)
    im0 = torch.where(heatr0 > 0.0, 1, 0).to(torch.int32)
    qmelt = torch.where(do_thin,
                        qmelt + torch.clamp(temp1 - sneqv_n, min=0.0) / dt,
                        qmelt)
    ponding = torch.where(do_thin, temp1 - sneqv_n, ponding)
    sneqv = torch.where(do_thin, sneqv_n, sneqv)
    snowh = torch.where(do_thin, snowh_n, snowh)
    hmg = _set(hmg, 0, torch.where(do_thin, hm0, hmg[0]))
    xmg = _set(xmg, 0, torch.where(do_thin, xm0, xmg[0]))
    imelt_g = _set(imelt_g, 0, torch.where(do_thin, im0, imelt_g[0]))

    do = (imelt_g > 0) & (torch.abs(hmg) > 0.0)
    mice_new = torch.where(xmg > 0.0, torch.clamp(wice0g - xmg, min=0.0),
                           torch.where(xmg < 0.0,
                                       torch.minimum(wmass0g, wice0g - xmg),
                                       mice))
    heatrg = hmg - HFUS * (wice0g - mice_new) / dt
    mliq_new = torch.clamp(wmass0g - mice_new, min=0.0)
    stc_g = torch.where(do & (torch.abs(heatrg) > 0.0),
                        stc_g + fact[NSNOW:] * heatrg, stc_g)
    mice = torch.where(do, mice_new, mice)
    mliq = torch.where(do, mliq_new, mliq)

    # inter-layer heat redistribution (warm layers vs cold layers,
    # :1838-1917), then melt against other layers' ice / refreeze
    # against other layers' liquid (:1918-1993). Static 4x4 loops.
    factg = fact[NSNOW:]
    tg_rows = list(stc_g.unbind(0))
    for sign in (1.0, -1.0):
        stack = torch.stack(tg_rows)
        mixed = (torch.amax(stack, dim=0) > TFRZ) \
            & (torch.amin(stack, dim=0) < TFRZ)
        for jj in range(NSOIL):
            if sign > 0:
                active_j = tg_rows[jj] > TFRZ
            else:
                active_j = tg_rows[jj] < TFRZ
            heat_j = torch.where(mixed & active_j,
                                 (tg_rows[jj] - TFRZ) / factg[jj], 0.0)
            for k in range(NSOIL):
                if k == jj:
                    continue
                if sign > 0:
                    cond = mixed & active_j & (tg_rows[k] < TFRZ) \
                        & (heat_j > 0.1)
                else:
                    cond = mixed & active_j & (tg_rows[k] > TFRZ) \
                        & (heat_j < -0.1)
                heat_k = (tg_rows[k] - TFRZ) / factg[k]
                absorbs = torch.abs(heat_k) > torch.abs(heat_j)
                hk_new = torch.where(absorbs, heat_k + heat_j, 0.0)
                tg_rows[k] = torch.where(
                    cond, torch.where(absorbs, TFRZ + hk_new * factg[k],
                                      TFRZ), tg_rows[k])
                heat_j = torch.where(cond,
                                     torch.where(absorbs, 0.0,
                                                 heat_j + heat_k), heat_j)
            tg_rows[jj] = torch.where(mixed & active_j,
                                      TFRZ + heat_j * factg[jj], tg_rows[jj])

    mice_rows = list(mice.unbind(0))
    mliq_rows = list(mliq.unbind(0))
    # warm layers melt other layers' ice
    any_warm = torch.amax(torch.stack(tg_rows), dim=0) > TFRZ
    any_ice = torch.amax(mice, dim=0) > 0.0
    for jj in range(NSOIL):
        active_j = any_warm & any_ice & (tg_rows[jj] > TFRZ)
        xm_j = torch.where(active_j,
                           (tg_rows[jj] - TFRZ) / factg[jj] * dt
                           * inv(HFUS), 0.0)
        for k in range(NSOIL):
            if k == jj:
                continue
            cond = active_j & (mice_rows[k] > 0.0) & (xm_j > 0.1)
            absorbs = mice_rows[k] > xm_j
            mice_k = torch.where(absorbs, mice_rows[k] - xm_j, 0.0)
            tg_rows[k] = torch.where(cond, TFRZ, tg_rows[k])
            xm_j = torch.where(cond,
                               torch.where(absorbs, 0.0,
                                           xm_j - mice_rows[k]), xm_j)
            mice_rows[k] = torch.where(cond, mice_k, mice_rows[k])
            mliq_rows[k] = torch.where(
                cond, torch.clamp(wmass0g[k] - mice_rows[k], min=0.0),
                mliq_rows[k])
        tg_rows[jj] = torch.where(
            active_j, TFRZ + xm_j * HFUS / dt * factg[jj], tg_rows[jj])

    # cold layers refreeze other layers' liquid
    any_cold = torch.amin(torch.stack(tg_rows), dim=0) < TFRZ
    any_liq = torch.amax(torch.stack(mliq_rows), dim=0) > 0.0
    for jj in range(NSOIL):
        active_j = any_cold & any_liq & (tg_rows[jj] < TFRZ)
        xm_j = torch.where(active_j,
                           (tg_rows[jj] - TFRZ) / factg[jj] * dt
                           * inv(HFUS), 0.0)
        for k in range(NSOIL):
            if k == jj:
                continue
            cond = active_j & (mliq_rows[k] > 0.0) & (xm_j < -0.1)
            absorbs = mliq_rows[k] > torch.abs(xm_j)
            mice_k = torch.where(absorbs, mice_rows[k] - xm_j,
                                 mice_rows[k] + mliq_rows[k])
            tg_rows[k] = torch.where(cond, TFRZ, tg_rows[k])
            xm_j = torch.where(cond,
                               torch.where(absorbs, 0.0,
                                           xm_j + mliq_rows[k]), xm_j)
            mice_rows[k] = torch.where(cond, mice_k, mice_rows[k])
            mliq_rows[k] = torch.where(
                cond, torch.clamp(wmass0g[k] - mice_rows[k], min=0.0),
                mliq_rows[k])
        tg_rows[jj] = torch.where(
            active_j, TFRZ + xm_j * HFUS / dt * factg[jj], tg_rows[jj])

    mice = torch.stack(mice_rows)
    mliq = torch.stack(mliq_rows)
    stc = torch.cat([stc_s, torch.stack(tg_rows)], 0)
    sh2o = mliq / (1000.0 * dzsnso[NSNOW:])
    smc = (mliq + mice) / (1000.0 * dzsnso[NSNOW:])
    imelt = torch.cat([imelt_s, imelt_g], 0)
    return stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt, ponding


def water_glacier(p, dt, prcp, sfctmp, qvap, qdew, ficeold, zsoil, imelt,
                  isnow, snowh, sneqv, snice, snliq, stc, dzsnso, sh2o,
                  smc, ponding, zsnso, fsh):
    """Glacier water: snowpack + ice replenishment (WATER_GLACIER,
    :1997-2172; OPT_GLA=1)."""
    sice = torch.clamp(smc - sh2o, min=0.0)
    sice_save = sice
    sh2o_save = sh2o

    fpice = torch.where(
        sfctmp > TFRZ + 2.5, 0.0,
        torch.where(sfctmp <= TFRZ + 0.5, torch.ones_like(sfctmp),
                    torch.where(sfctmp <= TFRZ + 2.0,
                                1.0 - (-54.632 + 0.2 * sfctmp), 0.6)))
    bdfall = torch.clamp(67.92 + 51.25
                         * pw.exp((sfctmp - TFRZ) * inv(2.59)), max=120.0)
    qrain = prcp * (1.0 - fpice)
    qsnow = prcp * fpice
    snowhin = qsnow / bdfall
    qsnsub = qvap
    qsnfro = qdew

    # FSH correction when frost/sublimation bypasses the snowpack
    # (SNOWH2O_GLACIER :2868-2892): applied where there are no layers
    fsh = fsh - torch.where((sneqv == 0.0) | (isnow == 0),
                            (qsnfro - qsnsub) * HSUB, 0.0)

    dz3 = dzsnso[:NSNOW]
    isnow, snowh, sneqv, dz3, stc, snice, snliq = snowfall_acc(
        p, dt, qsnow, snowhin, sfctmp, isnow, snowh, sneqv, dz3, stc,
        snice, snliq, new_layer_thresh=0.05)
    dz3 = compact_snow(p, dt, stc, snice, snliq, imelt, ficeold, isnow,
                       dz3)
    (isnow, sh2o, sice, stc, snice, snliq, dz3, snowh, sneqv, p1a,
     p2a) = combine_snow(p, isnow, sh2o, sice, stc, snice, snliq, dz3,
                         snowh, sneqv, dzsnso[NSNOW],
                         dzmin_vals=(0.045, 0.05, 0.2),
                         gone_thresh=0.05, glacier=True)
    isnow, stc, snice, snliq, dz3 = divide_snow(
        p, isnow, stc, snice, snliq, dz3, split2_thresh=0.10)
    (isnow, dz3, snowh, sneqv, snice, snliq, sh2o, sice, stc, qsnbot,
     p1b, p2b) = snowh2o(p, dt, qsnfro, qsnsub, qrain, isnow, dz3,
                         snowh, sneqv, snice, snliq, sh2o, sice, stc,
                         dzsnso[NSNOW])
    ponding1 = p1a + p1b
    ponding2 = p2a + p2b

    # glacier flow above 2000 mm (:2239-2246)
    sneqv, snice, snliq, stc, dz3, snoflow = _snow_cleanup(
        isnow, sneqv, snice, snliq, stc, dz3, dt, 2000.0)

    dzsnso = torch.cat([dz3, dzsnso[NSNOW:]], 0)
    zsnso = _layer_depths(isnow, dzsnso)

    runsrf = (ponding + ponding1 + ponding2) / dt
    runsrf = runsrf + torch.where(isnow == 0, qsnbot + qrain, qsnbot)

    # ice replenishment (OPT_GLA=1, :2149-2158): glacier ice below is
    # bottomless; restore the saved profile and book the difference
    replace = _sum0(dzsnso[NSNOW:] * (sice - sice_save + sh2o - sh2o_save))
    replace = replace * 1000.0 / dt
    sice = torch.clamp(sice_save, max=1.0)
    sh2o = 1.0 - sice
    smc = sice + sh2o
    runsub = snoflow + replace
    return SimpleNamespace(
        isnow=isnow, snowh=snowh, sneqv=sneqv, snice=snice, snliq=snliq,
        stc=stc, zsnso=zsnso, dzsnso=dzsnso, sh2o=sh2o, smc=smc,
        runsrf=runsrf, runsub=runsub, qsnow=qsnow, qsnbot=qsnbot,
        fpice=fpice, fsh=fsh, ponding1=ponding1, ponding2=ponding2)


def glacier_sflx(p, cosz, dt, zsoil, sfctmp, sfcprs, uu, vv, q2, soldn,
                 lwdn, prcp, tbot, ficeold, zlvl, state):
    """One glacier step (NOAHMP_GLACIER, :105-297). ``state`` uses the
    same keys as the main NoahMP state (``isnow`` int32); ``dt`` is a
    number or a 0-d tensor. Returns (outputs, new_state); reads nothing
    back to the host."""
    s = dict(state)
    isnow = s["isnow"]
    dt = _dt_tensor(dt, sfctmp)
    qair = q2   # already specific humidity from the caller

    eair = qair * sfcprs / (0.622 + 0.378 * qair)
    rhoair = (sfcprs - 0.378 * eair) / (RAIR * sfctmp)
    swdown = torch.where(cosz <= 0.0, 0.0, soldn)
    solad = torch.stack([swdown * 0.35, swdown * 0.35])
    solai = torch.stack([swdown * 0.15, swdown * 0.15])

    dzsnso = _thicknesses(s["zsnso"], isnow, zsoil)

    df, hcpct, fact = thermoprop_glacier(p, isnow, dzsnso, dt,
                                         s["snowh"], s["snice"],
                                         s["snliq"])
    sag, fsa, fsr, tauss = radiation_glacier(
        p, dt, s["tg"], s["sneqvo"], s["sneqv"], cosz,
        torch.zeros_like(cosz), solad, solai, s["tauss"])

    z0mg = p.z0sno
    zpd = s["snowh"]
    zlvl_g = zpd + zlvl
    lathea = HSUB
    gamma = CPAIR * sfcprs * inv(0.622 * lathea)
    ones = torch.ones_like(s["tg"])
    gf = glacier_flux(p, isnow, df, dzsnso, torch.full_like(s["tg"], z0mg),
                      zlvl_g, zpd, qair, sfctmp, rhoair, sfcprs,
                      torch.clamp(torch.sqrt(uu * uu + vv * vv), min=1.0),
                      gamma, ones, lwdn, ones, s["smc"], eair, s["stc"],
                      sag, s["snowh"], lathea, s["sh2o"], s["cm"],
                      s["ch"], s["tg"], uu, vv)
    emissi = 0.98
    fire = lwdn + gf.irb
    trad = pw.pow(torch.clamp(fire - (1.0 - emissi) * lwdn, min=1.0)
                  * inv(emissi * SB), 0.25)

    stc = tsnosoi(p, isnow, tbot, s["zsnso"], gf.ghb, df, hcpct, dt,
                  s["snowh"], dzsnso, s["stc"])

    (stc, snice, snliq, sneqv, snowh, smc, sh2o, qmelt, imelt,
     ponding) = phasechange_glacier(p, isnow, dt, fact, dzsnso, stc,
                                    s["snice"], s["snliq"], s["sneqv"],
                                    s["snowh"], s["smc"], s["sh2o"])

    sneqvo = sneqv
    qvap = torch.clamp(gf.evb * inv(lathea), min=0.0)
    qdew = torch.abs(torch.clamp(gf.evb * inv(lathea), max=0.0))
    edir = qvap - qdew

    w = water_glacier(p, dt, prcp, sfctmp, qvap, qdew, ficeold, zsoil,
                      imelt, isnow, snowh, sneqv, snice, snliq, stc,
                      dzsnso, sh2o, smc, ponding, s["zsnso"], gf.shb)

    snowh, sneqv = w.snowh, w.sneqv
    tiny = (snowh <= 1e-6) | (sneqv <= 1e-3)
    snowh = torch.where(tiny, 0.0, snowh)
    sneqv = torch.where(tiny, 0.0, sneqv)
    albedo = torch.where(swdown > 0.0, fsr / torch.clamp(swdown, min=MPE),
                         -999.9)

    new_state = dict(state)
    new_state.update(
        sneqvo=sneqvo, stc=w.stc, sh2o=w.sh2o, smc=w.smc, tg=gf.tgb,
        qsfc=gf.qsfc, isnow=w.isnow, zsnso=w.zsnso, snowh=snowh,
        sneqv=sneqv, snice=w.snice, snliq=w.snliq, cm=gf.cm, ch=gf.ch,
        tauss=tauss)
    outputs = dict(
        fsa=fsa, fsr=fsr, fira=gf.irb, fsh=w.fsh, fgev=gf.evb,
        ssoil=gf.ghb, trad=trad, edir=edir, runsrf=w.runsrf,
        runsub=w.runsub, sag=sag, albedo=albedo, qsnbot=w.qsnbot,
        ponding=ponding, t2m=gf.t2mb, q2e=gf.q2b, q1=gf.qsfc,
        emissi=torch.full_like(gf.tgb, emissi), fpice=w.fpice,
        qmelt=qmelt)
    return outputs, new_state

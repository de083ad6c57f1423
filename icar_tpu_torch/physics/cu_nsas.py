"""NSAS (New Simplified Arakawa-Schubert) cumulus convection
(icar_tpu/physics/cu_nsas.py, the reference's cu_nsas.f90): the NCEP SAS
deep scheme (nsas2d; Han & Pan 2011) and the companion non-precipitating
shallow scheme (nscv2d; Han & Pan 2010). One cloud type with an
entraining updraft, a saturated downdraft, a cloud-work-function closure
against climatological critical values (deep) and a PBL buoyancy-flux
mass closure after Grant (2001) (shallow).

NSAS works bottom-up (k = 0 at the surface) like the model, in mb, with
mixing ratios. Over the (ny, nx) columns at once: each of the JAX
package's ``fori_loop`` level recurrences is a Python loop over the
levels, whose level index is the same for every column (a per-column
start or stop is a mask), so a level is one row of the profiles; the
per-column level selections are ``ops/indexing.take_level``. ICAR applies
only the theta, qv, qc and qi tendencies and the rain (the momentum
tendencies' application is disabled in the reference driver,
cu_driver.f90:502-508), so u and v enter only through the wind shear.
Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), a constant over a field one division; ``dt`` is a
0-d float32 tensor (a number in the tests). Plain PyTorch, no read back
to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level as _lev
from ..ops.pointwise import inv
from .mp_thompson import _rd
from .mp_wsm3 import _dt_tensor

# physical constants as passed by ICAR's cu_driver (mod_wrf_constants)
CP = 1004.6
CLIQ = 4190.0
CPV = 1846.0
G = 9.81
HVAP = 2.5e6
RD = 287.0
RV = 461.6
FV = RV / RD - 1.0
CICE = 2106.0
XLS = 2.85e6
PSAT = 610.78
T0C = 273.15
QMIN = 1e-30

EL2ORC = HVAP * HVAP / (RV * CP)
EPS = RD / RV
FACT1 = (CPV - CLIQ) / RV
FACT2 = HVAP / RV - FACT1 * T0C

# deep-scheme tunables (cu_nsas.f90:410-430)
PDETRN = 200.0
C0, C1 = 0.002, 0.002
XLAMDD, XLAMDE = 1.0e-4, 1.0e-4
CLAM, CXLAMU = 0.1, 1.0e-4
AAFAC = 0.1
DTHK = 25.0
CINCRMAX, CINCRMIN = 180.0, 120.0
MBDT = 10.0
EDTMAXL, EDTMAXS = 0.3, 0.3
EVFACTS, EVFACTL = 0.3, 0.3
ALPHAL, ALPHAS = 0.5, 0.5
BETAL, BETAS = 0.05, 0.05
TF, TCR = 233.16, 263.16
TCRF = 1.0 / (TCR - TF)
PGCON = 0.55

PCRIT = np.array([850., 800., 750., 700., 650., 600., 550., 500., 450.,
                  400., 350., 300., 250., 200., 150.])
ACRITT = np.array([.0633, .0445, .0553, .0664, .075, .1082, .1521,
                   .2216, .3151, .3677, .41, .5255, .7663, 1.1686,
                   1.6851])
ACRIT = ACRITT * (975.0 - PCRIT)


def _full(c, a, b):
    """``jnp.where(c, a, b)`` for two numbers (float32)."""
    return torch.where(c, torch.full(c.shape, a, device=c.device),
                       torch.full(c.shape, b, device=c.device))


def _where0(c, a):
    """``jnp.where(c, a, 0.0)``."""
    return torch.where(c, a, torch.zeros((), dtype=a.dtype, device=a.device))


def _nz(x, v=1.0):
    """``jnp.where(x == 0, v, x)``: a divisor kept off zero."""
    return torch.where(x == 0, torch.full_like(x, v), x)


def _km1(a):
    """The level below each level (the lowest repeats)."""
    return torch.cat([a[:1], a[:-1]], 0)


def fpvs_mb(t):
    """Saturation vapor pressure [mb], mixed phase below the triple
    point (inlined fpvs as in wrf_constants / mp_wsm3)."""
    ttp = T0C + 0.01
    dldt = CPV - CLIQ
    xa = -dldt / RV
    xb = xa + HVAP / (RV * ttp)
    dldti = CPV - CICE
    xai = -dldti / RV
    xbi = xai + XLS / (RV * ttp)
    tr = _rd(ttp, t)
    es_w = PSAT * pw.pow(tr, xa) * torch.exp(xb * (1.0 - tr))
    es_i = PSAT * pw.pow(tr, xai) * torch.exp(xbi * (1.0 - tr))
    return 0.01 * torch.where(t < ttp, es_i, es_w)


def _qes(t, p_mb):
    es = fpvs_mb(t)
    qs = EPS * es / (p_mb + (EPS - 1.0) * es)
    return torch.clamp(qs, min=QMIN)


def _first_above(cond, k0, default, lo=1):
    """Lowest k in [lo, KLEV) with cond[k]; ``default`` where none."""
    KLEV = cond.shape[0]
    karr = torch.arange(KLEV, device=cond.device)[:, None, None]
    valid = cond & (karr >= lo)
    first = torch.argmax(valid.to(torch.uint8), dim=0)
    return torch.where(torch.any(valid, dim=0), first, default)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for increasing float32 ``xp``: constant
    outside, linear inside, in jnp.interp's arithmetic."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _half_level_env(to, qo, zl, p, kmax_mask_dummy, KLEV):
    """Shift environment to half levels (the common to/qo/heo half-level
    construction, cu_nsas.f90:733-780 / 2560-2600). Returns
    (to, qo, qeso, heo, heso, po) with levels 0..KLEV-2 at interfaces."""
    tkp = torch.cat([to[1:], to[-1:]], 0)
    qkp = torch.cat([qo[1:], qo[-1:]], 0)
    pkp = torch.cat([p[1:], p[-1:]], 0)
    zkp = torch.cat([zl[1:], zl[-1:]], 0)
    qeskp = _qes(tkp, pkp)
    dz = 0.5 * (zkp - zl)
    dp = 0.5 * (pkp - p)
    es = fpvs_mb(tkp)
    pprime = pkp + (EPS - 1.0) * es
    qs = EPS * es / pprime
    dqsdp = -qs / pprime
    tkp2 = tkp * tkp
    desdt = es * (_rd(FACT1, tkp) + _rd(FACT2, tkp2))
    dqsdt = qs * pkp * desdt / (es * pprime)
    gamma = EL2ORC * qeskp / tkp2
    dt = (G * dz + HVAP * dqsdp * dp) / (CP * (1.0 + gamma))
    dq = dqsdt * dt + dqsdp * dp
    to_h = tkp + dt
    qo_h = torch.clamp(qkp + dq, min=1e-10)
    po = 0.5 * (p + pkp)
    qeso_h = _qes(to_h, po)
    zmid = 0.5 * (zl + zkp)
    heo_h = G * zmid + CP * to_h + HVAP * qo_h
    heso_h = G * zmid + CP * to_h + HVAP * qeso_h
    # top level keeps full-level values
    last = KLEV - 1
    to_h[last] = to[last]
    qo_h[last] = qo[last]
    qeso_h[last] = _qes(to[last], p[last])
    heo_h[last] = G * zl[last] + CP * to[last] + HVAP * qo[last]
    heso_h[last] = G * zl[last] + CP * to[last] + HVAP * qeso_h[last]
    return to_h, qo_h, qeso_h, heo_h, heso_h, po


def _updraft_recur(kb, lo_arr, mix_coef, xlamud, zi, start_val, env_mid,
                   active):
    """Generic upward in-cloud mixing recurrence
    f(k) = ((1-tem1) f(k-1) + tem*env_mid(k)) / (1+tem-tem1)
    from level kb upward (cu_nsas.f90:915-935)."""
    KLEV = zi.shape[0] - 1
    karr = torch.arange(KLEV, device=zi.device)[:, None, None]
    f = _where0(karr == kb[None], start_val[None].expand_as(env_mid))
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        tem = 0.5 * (mix_coef[k] + mix_coef[k - 1]) * dz
        tem1 = 0.5 * xlamud * dz
        factor = 1.0 + tem - tem1
        val = ((1.0 - tem1) * f[k - 1] + tem * env_mid[k]) / factor
        f[k] = torch.where(active & (k > kb), val, f[k])
    return f


def _cincr(pdot, w3, w4):
    """The convective-inhibition factor of the cloud-base omega (the
    deep scheme's cincr and acrtfct, the shallow's cincr)."""
    tem = torch.where(pdot <= w4, (pdot - w4) / (w3 - w4),
                      torch.where(pdot >= -w4, -(pdot + w4) / (w4 - w3),
                                  torch.zeros_like(pdot)))
    return 1.0 - torch.clamp(tem, -1.0, 1.0)


def _cwf_term(dz, to, dby, qeso, qo, gamma, down=False):
    """One level's cloud-work-function term (buoyancy and virtual
    moisture), with the updraft's ``dby`` or, ``down``, the downdraft's
    (whose quotient by 1 + gamma the JAX package forms first)."""
    rfact = 1.0 + FV * CP * gamma * to * inv(HVAP)
    a = dz * _rd(G, CP * to)
    buoy = a * (dby / (1.0 + gamma)) if down else a * dby / (1.0 + gamma)
    return buoy * rfact + dz * G * FV * torch.clamp(qeso - qo, min=0.0)


def nsas_deep(delt, dx, del_, prsl_mb, prsi_mb, zl, ncloud, qc2, qi2,
              q1, t1, slimsk, dot, u1, v1, dx_factor_nsas):
    """Deep SAS (nsas2d). All (KLEV, ny, nx) bottom-up, pressures in mb.
    Returns (t1, q1, qc2, qi2, rain_m, kbot, ktop, icps)."""
    KLEV = t1.shape[0]
    shape2 = t1.shape[1:]
    dev = t1.device
    karr = torch.arange(KLEV, device=dev)[:, None, None]
    dt2 = _dt_tensor(delt, t1)
    dtmin = torch.clamp(dt2, min=1200.0)
    dtmax = torch.clamp(dt2, min=3600.0)
    zero2 = torch.zeros(shape2, dtype=t1.dtype, device=dev)
    zero3 = torch.zeros_like(t1)

    if dx_factor_nsas == 1:
        dxf = 250.0 / dx
        w1l = w4l = -0.1 * dxf
        w2l = w3l = -dxf
        w1s, w2s, w3s, w4s = w1l, w2l, w3l, w4l
    else:
        w1l, w2l, w3l, w4l = -8e-3, -4e-2, -5e-3, -5e-4
        w1s, w2s, w3s, w4s = -2e-4, -2e-3, -1e-3, -2e-5
    land = slimsk == 1.0
    w1 = _full(land, w1l, w1s)
    w2 = _full(land, w2l, w2s)
    w3 = _full(land, w3l, w3s)
    w4 = _full(land, w4l, w4s)

    p = prsl_mb
    psfc0 = prsi_mb[0]
    # search-depth caps (cu_nsas.f90:690-700); per-column highest level
    # satisfying the pressure fraction
    kbmax = torch.clamp(torch.sum(p > psfc0[None] * 0.45, 0), max=KLEV - 1)
    kbm = torch.clamp(torch.sum(p > psfc0[None] * 0.70, 0), max=KLEV - 1)
    kmaxc = torch.clamp(torch.sum(p > psfc0[None] * 0.04, 0), max=KLEV - 1)

    to = t1
    qo = torch.clamp(q1, min=1e-10)
    uo = u1
    vo = v1
    qeso = _qes(to, p)
    heo = G * zl + CP * to + HVAP * qo

    # updraft starting level: max moist static energy below kbm
    # (full-level heo, cu_nsas.f90:698-710)
    kb = torch.argmax(torch.where(karr <= kbm[None], heo,
                                  torch.full_like(heo, -np.inf)), dim=0)

    # half-level environment; hkbo/qkbo read from the shifted profiles
    # (cu_nsas.f90:712-750)
    to, qo, qeso, heo, heso, po = _half_level_env(to, qo, zl, p, None,
                                                  KLEV)
    frh = torch.clamp(1.0 - qo / qeso, min=0.0)
    hkbo = _lev(heo, kb)
    qkbo = _lev(qo, kb)

    # level of free convection
    lfc_cond = (karr > kb[None]) & (hkbo[None] > heso) \
        & (karr <= kbmax[None])
    kbcon = _first_above(lfc_cond, None, KLEV - 1)
    cnvflg = kbcon < KLEV - 1

    # critical convective inhibition vs cloud-base omega
    pdot = 10.0 * _lev(dot, kbcon)
    tem = _cincr(pdot, w3, w4)
    cincr = CINCRMAX - tem * 0.5 * (CINCRMAX - CINCRMIN)
    pbcdif = -_lev(p, kbcon) + _lev(p, kb)
    cnvflg = cnvflg & (pbcdif <= cincr)

    # interface heights + entrainment profile
    zi = torch.cat([zl[:1] * 0.0, 0.5 * (zl[:-1] + zl[1:]), zl[-1:]], 0)
    xlamb = _rd(CLAM, zi[1:KLEV + 1])
    xlamb_b = _lev(xlamb, kbcon)
    xlamb = torch.where(karr > kbcon[None], xlamb_b[None], xlamb)
    xlamud = xlamb_b
    above_b = karr > kbcon[None]
    ratio = qeso / _lev(qeso, kbcon)[None]
    ratio2 = ratio * ratio
    one3 = torch.ones_like(ratio)
    fent1 = torch.where(above_b, ratio2, one3)
    fent2 = torch.where(above_b, ratio * ratio2, one3)
    xlamb = torch.where(karr >= kbcon[None],
                        xlamb * fent1 + CXLAMU * frh * fent2, xlamb)

    # updraft normalized mass flux eta
    eta = torch.ones_like(t1)
    for it in range(KLEV - 2):
        k = KLEV - 2 - it
        dz = zi[k + 2] - zi[k + 1]
        ptem = 0.5 * (xlamb[k] + xlamb[k + 1]) - xlamud
        val = eta[k + 1] / (1.0 + ptem * dz)
        use = cnvflg & (k < kbcon) & (k >= kb)
        eta[k] = torch.where(use, val, eta[k])
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        ptem = 0.5 * (xlamb[k] + xlamb[k - 1]) - xlamud
        val = eta[k - 1] * (1.0 + ptem * dz)
        eta[k] = torch.where(cnvflg & (k > kbcon), val, eta[k])

    # updraft static energy (momentum is left out: its tendencies are not
    # applied)
    heo_mid = 0.5 * (heo + _km1(heo))
    hcko = _updraft_recur(kb, None, xlamb, xlamud, zi, hkbo, heo_mid,
                          cnvflg)
    dbyo = hcko - heso

    # dry-layer inhibition
    kbcon1 = _first_above((karr >= kbcon[None]) & (dbyo > 0.0), None,
                          KLEV - 1)
    cnvflg = cnvflg & (kbcon1 < KLEV - 1)
    cnvflg = cnvflg & ((_lev(p, kbcon) - _lev(p, kbcon1)) <= DTHK)

    # first-guess cloud top: inversion above kbcon1
    ktcon = _first_above((karr > kbcon1[None]) & (dbyo < 0.0), None, 1)
    cnvflg = cnvflg & ((_lev(p, kbcon) - _lev(p, ktcon)) >= 150.0)

    # downdraft origination level (theta-e minimum)
    he_masked = torch.where((karr > kbcon1[None]) & (karr <= kbmax[None]),
                            heo, torch.full_like(heo, np.inf))
    lmin = torch.argmin(he_masked, dim=0) + 1
    jmin_ = torch.minimum(torch.maximum(lmin, kbcon1 + 1), ktcon - 1)
    cnvflg = cnvflg & (jmin_ < ktcon)

    xmbmax = 1000.0 * _lev(del_, kbcon) / (G * dt2)

    # cloud moisture + condensation along ascent (fused recurrence)
    qo_mid = 0.5 * (qo + _km1(qo))
    qcko = _where0(karr == kb[None], qkbo[None].expand_as(t1))
    qcirs, pwo, dellal = zero3.clone(), zero3.clone(), zero3.clone()
    pwavo, aa1 = zero2, zero2
    for k in range(1, KLEV - 1):
        dz1 = zi[k + 1] - zi[k]
        gamma = EL2ORC * qeso[k] / (to[k] * to[k])
        qrch = qeso[k] + gamma * dbyo[k] / (HVAP * (1.0 + gamma))
        tem = 0.5 * (xlamb[k] + xlamb[k - 1]) * dz1
        tem1 = 0.5 * xlamud * dz1
        factor = 1.0 + tem - tem1
        qk = ((1.0 - tem1) * qcko[k - 1] + tem * qo_mid[k]) / factor
        in_cloud = cnvflg & (k > kb) & (k < ktcon)
        qk = torch.where(in_cloud, qk, qcko[k])
        qci = eta[k] * (qk - qrch)
        etah = 0.5 * (eta[k] + eta[k - 1])
        dp = 1000.0 * del_[k]
        wet = in_cloud & (qci > 0.0) & (k >= kbcon)
        use_c1 = wet & (k > jmin_) if ncloud > 0 else torch.zeros_like(wet)
        qlk = torch.where(use_c1, qci / (eta[k] + etah * (C0 + C1) * dz1),
                          qci / (eta[k] + etah * C0 * dz1))
        dlal = _where0(use_c1, etah * C1 * dz1 * qlk * G / dp)
        aa1 = aa1 - _where0(wet, dz1 * G * qlk)
        pw_k = _where0(wet, etah * C0 * dz1 * qlk)
        qk = torch.where(wet, qlk + qrch, qk)
        pwavo = pwavo + pw_k
        qcko[k] = qk
        qcirs[k] = _where0(in_cloud, qci)
        pwo[k] = pw_k
        dellal[k] = dlal

    # cloud work function (buoyancy integral kbcon..ktcon)
    cwf_zone = (karr >= kbcon[None]) & (karr < ktcon[None])
    dz1_arr = torch.cat([zl[1:] - zl[:-1], zl[-1:] * 0 + 1.0], 0)
    gamma_a = EL2ORC * qeso / (to * to)
    cwf_term = _cwf_term(dz1_arr, to, dbyo, qeso, qo, gamma_a)
    aa1 = aa1 + pw.sum0(_where0(cwf_zone & cnvflg[None], cwf_term))
    cnvflg = cnvflg & (aa1 > 0.0)

    # convective overshooting: extend top while aafac*aa1 stays positive
    aa2 = AAFAC * aa1
    ktcon1 = torch.full(shape2, KLEV - 2, dtype=torch.long, device=dev)
    flg = cnvflg
    for k in range(1, KLEV - 1):
        act = flg & (k >= ktcon) & (k < kmaxc)
        aa2 = aa2 + _where0(act, cwf_term[k])
        hit = act & (aa2 < 0.0)
        ktcon1 = torch.where(hit, k, ktcon1)
        flg = flg & ~hit

    # moisture in overshooting layers (ktcon..ktcon1)
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        gamma = EL2ORC * qeso[k] / (to[k] * to[k])
        qrch = qeso[k] + gamma * dbyo[k] / (HVAP * (1.0 + gamma))
        tem = 0.5 * (xlamb[k] + xlamb[k - 1]) * dz
        tem1 = 0.5 * xlamud * dz
        factor = 1.0 + tem - tem1
        qk = ((1.0 - tem1) * qcko[k - 1] + tem * qo_mid[k]) / factor
        zone = cnvflg & (k >= ktcon) & (k < ktcon1)
        qk = torch.where(zone, qk, qcko[k])
        qci = eta[k] * (qk - qrch)
        etah = 0.5 * (eta[k] + eta[k - 1])
        dp = 1000.0 * del_[k]
        wet = zone & (qci > 0.0)
        use_c1 = wet if ncloud > 0 else torch.zeros_like(wet)
        qlk = torch.where(use_c1, qci / (eta[k] + etah * (C0 + C1) * dz),
                          qci / (eta[k] + etah * C0 * dz))
        dellal[k] = torch.where(use_c1, etah * C1 * dz * qlk * G / dp,
                                dellal[k])
        pwo[k] = torch.where(wet, etah * C0 * dz * qlk, pwo[k])
        qcko[k] = torch.where(wet, qlk + qrch, qk)
        pwavo = torch.where(wet, pwavo + etah * C0 * dz * qlk, pwavo)

    # exchange ktcon <-> ktcon1
    ktcon, ktcon1 = ktcon1, ktcon

    # liquid/vapor separation at cloud top
    ktm1 = torch.clamp(ktcon - 1, min=0)
    to_t = _lev(to, ktm1)
    gamma_t = EL2ORC * _lev(qeso, ktm1) / (to_t * to_t)
    qrch_t = _lev(qeso, ktm1) + gamma_t * _lev(dbyo, ktm1) \
        / (HVAP * (1.0 + gamma_t))
    dq_t = _lev(qcko, ktm1) - qrch_t
    top_fix = cnvflg & (dq_t > 0.0) if ncloud > 0 \
        else torch.zeros_like(cnvflg)
    qlko_ktcon = _where0(top_fix, dq_t)
    qcko = torch.where((karr == ktm1[None]) & top_fix[None], qrch_t[None],
                       qcko)

    # downdraft strength from wind shear
    edt = _edt(uo, vo, zi, kb, ktcon, karr, KLEV)
    edto = edt
    edtx = edt

    # downdraft detrainment profile below cloud base
    sum_zone = karr < kbcon[None]
    dz_if = zi[2:KLEV + 1] - zi[1:KLEV]
    sumx = pw.sum0(_where0(sum_zone[:KLEV - 1], dz_if))
    beta = _full(land, BETAL, BETAS)
    kbcon_f = torch.clamp(kbcon, min=1).to(t1.dtype)
    dzm = (sumx + zi[1]) / kbcon_f
    xlamd = (1.0 - pw.pow(beta, 1.0 / kbcon_f)) / dzm

    etad = torch.ones_like(t1)
    for it in range(KLEV - 1):
        k = KLEV - 2 - it
        dz = zi[k + 2] - zi[k + 1]
        ptem_hi = XLAMDD - XLAMDE
        ptem_lo = xlamd + XLAMDD - XLAMDE
        val_hi = etad[k + 1] * (1.0 - ptem_hi * dz)
        val_lo = etad[k + 1] * (1.0 - ptem_lo * dz)
        use_hi = cnvflg & (k < jmin_) & (k >= kbcon)
        use_lo = cnvflg & (k < kbcon)
        etad[k] = torch.where(use_hi, val_hi,
                              torch.where(use_lo, val_lo, etad[k]))

    # downdraft properties (descent from jmin)
    hcdo, qcdo, qrcdo, pwdo, pwevo = _downdraft(
        heo, qo, heso, qeso, to, etad, zi, xlamd, kbcon, jmin_, cnvflg,
        karr, KLEV, with_pw=True)

    edtmax = _full(slimsk == 2.0, EDTMAXS, EDTMAXL)
    edto = _where0(pwevo < 0.0, torch.minimum(
        -edto * pwavo / _nz(pwevo, -1.0), edtmax))

    # downdraft cloud work function contribution
    dd_zone = karr < jmin_[None]
    dz_dn = -(torch.cat([zl[1:], zl[-1:]], 0) - zl)
    dd_term = _cwf_term(dz_dn, to, hcdo - heso, qeso, qo, gamma_a, True)
    aa1 = aa1 + edto * pw.sum0(_where0(dd_zone & cnvflg[None], dd_term))
    cnvflg = cnvflg & (aa1 > 0.0)

    # ---- unit-mass-flux environmental change (dellah/q/l) --------------
    heo_km1 = _km1(heo)
    qo_km1 = _km1(qo)
    eta_km1 = _km1(eta)
    etad_km1 = _km1(etad)
    hcko_km1 = _km1(hcko)
    qcko_km1 = _km1(qcko)
    hcdo_km1 = _km1(hcdo)
    qrcdo_km1 = _km1(qrcdo)
    xlamb_km1 = _km1(xlamb)
    aup = (karr > kb[None]).to(t1.dtype)
    adw = (karr <= jmin_[None]).to(t1.dtype)
    dp3 = 1000.0 * del_
    dzi3 = zi[1:KLEV + 1] - zi[:KLEV]
    tem3 = 0.5 * (xlamb + xlamb_km1)
    ptem3 = XLAMDE
    ptem13 = torch.where(karr <= kbcon[None], xlamd[None] + XLAMDD,
                         torch.full_like(t1, XLAMDD))
    mid = lambda a, b: 0.5 * (a + b)
    adw_e = adw * edto[None]

    def della(f, f_km1, fcu, fcu_km1, fcd, fcd_km1):
        return (((aup * eta - adw_e * etad) * f
                 - (aup * eta_km1 - adw_e * etad_km1) * f_km1
                 - (aup * tem3 * eta_km1 + adw_e * ptem3 * etad)
                 * mid(f, f_km1) * dzi3
                 + aup * xlamud[None] * eta_km1 * mid(fcu, fcu_km1) * dzi3
                 + adw_e * ptem13 * etad * mid(fcd, fcd_km1) * dzi3)
                * G / dp3)

    dellah = della(heo, heo_km1, hcko, hcko_km1, hcdo, hcdo_km1)
    dellaq = della(qo, qo_km1, qcko, qcko_km1, qrcdo, qrcdo_km1)
    interior = (karr >= 1) & (karr < ktcon[None])
    dellah = _where0(interior, dellah)
    dellaq = _where0(interior, dellaq)
    # surface layer: downdraft detrainment only
    dp0 = 1000.0 * del_[0]
    dellah[0] = edto * etad[0] * (hcdo[0] - heo[0]) * G / dp0
    dellaq[0] = edto * etad[0] * (qcdo[0] - qo[0]) * G / dp0
    # cloud top
    at_top = karr == ktcon[None]
    dellah = torch.where(at_top, eta_km1 * (hcko_km1 - heo_km1) * G / dp3,
                         dellah)
    dellaq = torch.where(at_top, eta_km1 * (qcko_km1 - qo_km1) * G / dp3,
                         dellaq)
    dellal = torch.where(at_top, eta_km1 * qlko_ktcon[None] * G / dp3,
                         dellal)

    # ---- trial state with unit mass flux (mbdt) ------------------------
    in_cloud_le = karr <= ktcon[None]
    qo_x = torch.where(in_cloud_le,
                       torch.clamp(dellaq * MBDT + q1, min=1e-10), q1)
    dellat3 = (dellah - HVAP * dellaq) * inv(CP)
    to_x = torch.where(in_cloud_le, dellat3 * MBDT + t1, t1)
    to_xh, qo_xh, qeso_xh, heo_xh, heso_xh, _ = _half_level_env(
        to_x, qo_x, zl, p, None, KLEV)

    xhkb = _lev(heo_xh, kb)
    xqkb = _lev(qo_xh, kb)
    heox_mid = 0.5 * (heo_xh + _km1(heo_xh))
    hcko_x = _updraft_recur(kb, None, xlamb, xlamud, zi, xhkb, heox_mid,
                            cnvflg)
    qox_mid = 0.5 * (qo_xh + _km1(qo_xh))

    qcko_x = _where0(karr == kb[None], xqkb[None].expand_as(t1))
    xpwav, xaa0 = zero2, zero2
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        gamma = EL2ORC * qeso_xh[k] / (to_xh[k] * to_xh[k])
        xdby = hcko_x[k] - heso_xh[k]
        xqrch = qeso_xh[k] + gamma * xdby / (HVAP * (1.0 + gamma))
        tem = 0.5 * (xlamb[k] + xlamb[k - 1]) * dz
        tem1 = 0.5 * xlamud * dz
        factor = 1.0 + tem - tem1
        qk = ((1.0 - tem1) * qcko_x[k - 1] + tem * qox_mid[k]) / factor
        zone = cnvflg & (k > kb) & (k <= ktcon)
        qk = torch.where(zone, qk, qcko_x[k])
        dq = eta[k] * (qk - xqrch)
        etah = 0.5 * (eta[k] + eta[k - 1])
        wet = zone & (k >= kbcon) & (dq > 0.0)
        use_c1 = wet & (k > jmin_) if ncloud > 0 else torch.zeros_like(wet)
        qlk = torch.where(use_c1, dq / (eta[k] + etah * (C0 + C1) * dz),
                          dq / (eta[k] + etah * C0 * dz))
        xaa0 = xaa0 - _where0(wet & (k < ktcon1), dz * G * qlk)
        qk = torch.where(wet, qlk + xqrch, qk)
        xpw = _where0(wet, etah * C0 * dz * qlk)
        xpwav = xpwav + xpw
        # buoyancy part kbcon..ktcon1
        dz1 = zl[min(k + 1, KLEV - 1)] - zl[k]
        buoy_on = cnvflg & (k >= kbcon) & (k < ktcon1)
        xaa0 = xaa0 + _where0(buoy_on, _cwf_term(
            dz1, to_xh[k], xdby, qeso_xh[k], qo_xh[k], gamma))
        qcko_x[k] = qk

    # x-pass downdraft
    xhcd, _, _, _, xpwev = _downdraft(
        heo_xh, qo_xh, heso_xh, qeso_xh, to_xh, etad, zi, xlamd, kbcon,
        jmin_, cnvflg, karr, KLEV, with_pw=False)

    edtx = _where0(xpwev < 0.0, torch.minimum(
        -edtx * xpwav / _nz(xpwev, -1.0), edtmax))
    gamma_x = EL2ORC * qeso_xh / (to_xh * to_xh)
    xdd_term = _cwf_term(dz_dn, to_xh, xhcd - heso_xh, qeso_xh, qo_xh,
                         gamma_x, True)
    xaa0 = xaa0 + edtx * pw.sum0(_where0(dd_zone & cnvflg[None],
                                           xdd_term))

    # ---- closure -------------------------------------------------------
    p_top = _lev(p, ktcon)
    xp = torch.as_tensor(PCRIT[::-1].copy(), dtype=t1.dtype, device=dev)
    fp = torch.as_tensor(ACRIT[::-1].copy(), dtype=t1.dtype, device=dev)
    acrit_c = _interp(p_top, xp, fp)
    acrit_c = torch.where(p_top < PCRIT[-1], float(ACRIT[-1])
                          * (975.0 - p_top)
                          * inv(975.0 - PCRIT[-1]), acrit_c)
    acrtfct = _cincr(pdot, w3, w4)
    dtconv = torch.minimum(torch.maximum(
        dt2 + torch.clamp(1800.0 - dt2, min=0.0) * (pdot - w2) / (w1 - w2),
        dtmin), dtmax)
    f_cl = (aa1 - acrit_c * acrtfct) / dtconv
    cnvflg = cnvflg & (f_cl > 0.0)
    xk = (xaa0 - aa1) * inv(MBDT)
    cnvflg = cnvflg & (xk < 0.0)
    xmb = torch.minimum(-f_cl / _nz(xk, -1.0), xmbmax)

    # ---- feedback ------------------------------------------------------
    apply = cnvflg[None] & in_cloud_le
    t1n = torch.where(apply, t1 + dellat3 * xmb[None] * dt2, t1)
    q1n = torch.where(apply, q1 + dellaq * xmb[None] * dt2, q1)

    # rain contributions per layer; adw for rain is k<jmin
    # (cu_nsas.f90 rain loop uses adw=0 for k.ge.jmin)
    adw_rain = (karr < jmin_[None]).to(t1.dtype)
    contrib = (aup * pwo + adw_rain * edto[None] * pwdo) \
        * xmb[None] * .001 * dt2
    contrib = _where0(cnvflg[None] & (karr < ktcon[None]), contrib)
    rntot = pw.sum0(contrib)

    # rain evaporation sweep (top-down with running rain)
    evef = torch.where(land, edt * EVFACTL, edt * EVFACTS)
    rain, delqev, flg = zero2, zero2, cnvflg
    t1n, q1n = t1n.clone(), q1n.clone()
    for it in range(KLEV):
        k = KLEV - 1 - it
        rain = rain + contrib[k]
        qeso_k = _qes(t1n[k], p[k])
        qcond = evef * (q1n[k] - qeso_k) \
            / (1.0 + EL2ORC * qeso_k / (t1n[k] * t1n[k]))
        dp = 1000.0 * del_[k]
        active = cnvflg & flg & (k < ktcon)
        has_rain = active & (rain > 0.0) & (qcond < 0.0)
        rain0 = torch.clamp(rain, min=0.0)
        qevap = _where0(has_rain, -qcond * (1.0 - torch.exp(
            -.32 * torch.sqrt(dt2 * rain0))))
        qevap = torch.minimum(qevap, rain0 * 1000. * G / dp)
        delq2 = delqev + .001 * qevap * dp * inv(G)
        over = has_rain & (delq2 > rntot)
        qevap = torch.where(over, 1000. * G * (rntot - delqev) / dp, qevap)
        flg = flg & ~over
        doit = (rain > 0.0) & (qevap > 0.0) & active
        q1n[k] = torch.where(doit, q1n[k] + qevap, q1n[k])
        t1n[k] = torch.where(doit, t1n[k] - (HVAP / CP) * qevap, t1n[k])
        rain = torch.where(doit, rain - .001 * qevap * dp * inv(G), rain)
        delqev = delqev + _where0(doit, .001 * dp * qevap * inv(G))

    rain = torch.where(cnvflg & (rain < 0.) & ~flg, zero2, rain)
    rain = torch.clamp(rain, min=0.0)
    has_rain = cnvflg & (rain > 0.0)
    ktop = _where0(has_rain, ktcon)
    kbot = torch.where(has_rain, kbcon, KLEV)
    icps = has_rain.to(torch.int32)

    # convection without rain is cancelled entirely
    t1n = torch.where(has_rain[None], t1n, t1)
    q1n = torch.where(has_rain[None], q1n, q1)

    # detrained cloud water / ice
    det_zone = has_rain[None] & (karr >= kbcon[None]) \
        & (karr <= ktcon[None])
    qc2, qi2 = _detrain(det_zone, dellal * xmb[None] * dt2, t1n, qc2, qi2,
                        ncloud)
    return t1n, q1n, qc2, qi2, rain, kbot, ktop, icps


def _edt(uo, vo, zi, kb, ktcon, karr, KLEV):
    """The precipitation efficiency from the wind shear between kb and
    ktcon (vshear, e1, edt)."""
    du = uo - _km1(uo)
    dv = vo - _km1(vo)
    shear3 = torch.sqrt(du * du + dv * dv)
    sh_zone = (karr > kb[None]) & (karr <= ktcon[None])
    vshear = pw.sum0(_where0(sh_zone, shear3))
    zdenom = _lev(zi, torch.clamp(ktcon + 1, max=KLEV)) \
        - _lev(zi, torch.clamp(kb + 1, max=KLEV))
    vshear = 1e3 * vshear / _nz(zdenom)
    v2 = vshear * vshear
    e1 = 1.591 - .639 * vshear + .0953 * v2 - .00496 * (vshear * v2)
    return torch.clamp(1.0 - e1, 0.0, 0.9)


def _downdraft(heo, qo, heso, qeso, to, etad, zi, xlamd, kbcon, jmin_,
               cnvflg, karr, KLEV, with_pw):
    """The saturated downdraft's descent from jmin (the deep scheme's
    dd_props and its x pass): (hcdo, qcdo, qrcdo, pwdo, pwevo); pwdo None
    without ``with_pw``."""
    hcdo = _where0(karr == jmin_[None], _lev(heo, jmin_)[None]
                   .expand_as(heo))
    qcdo = _where0(karr == jmin_[None], _lev(qo, jmin_)[None]
                   .expand_as(heo))
    qrcdo = _where0(karr == jmin_[None], _lev(qeso, jmin_)[None]
                    .expand_as(heo))
    pwdo = torch.zeros_like(heo) if with_pw else None
    pwevo = torch.zeros_like(heo[0])
    for it in range(KLEV - 1):
        k = KLEV - 2 - it
        dz = zi[k + 2] - zi[k + 1]
        tem = XLAMDE * dz
        tem1 = torch.where(k >= kbcon, (0.5 * XLAMDD) * dz,
                           0.5 * (xlamd + XLAMDD) * dz)
        factor = 1.0 + tem - tem1
        heo_up = 0.5 * (heo[k] + heo[min(k + 1, KLEV - 1)])
        qo_up = 0.5 * (qo[k] + qo[min(k + 1, KLEV - 1)])
        hk = ((1.0 - tem1) * hcdo[k + 1] + tem * heo_up) / factor
        act = cnvflg & (k < jmin_)
        hk = torch.where(act, hk, hcdo[k])
        dby = hk - heso[k]
        gamma = EL2ORC * qeso[k] / (to[k] * to[k])
        qrcd_k = qeso[k] + (1.0 / HVAP) * (gamma / (1.0 + gamma)) * dby
        qk = ((1.0 - tem1) * qcdo[k + 1] + tem * qo_up) / factor
        pwd = etad[k + 1] * (qk - qrcd_k)
        if with_pw:
            pwdo[k] = _where0(act, pwd)
        pwevo = pwevo + _where0(act, pwd)
        hcdo[k] = hk
        qcdo[k] = torch.where(act, qrcd_k, qcdo[k])
        qrcdo[k] = torch.where(act, qrcd_k, qrcdo[k])
    return hcdo, qcdo, qrcdo, pwdo, pwevo


def _detrain(det_zone, tem_d, t1n, qc2, qi2, ncloud):
    """The detrained condensate, split into ice below TCR (ncloud 2) or
    all cloud water (ncloud 1)."""
    fice = torch.clamp((TCR - t1n) * TCRF, 0.0, 1.0)
    if ncloud >= 2:
        qi2 = qi2 + _where0(det_zone, tem_d * fice)
        qc2 = qc2 + _where0(det_zone, tem_d * (1.0 - fice))
    elif ncloud > 0:
        qc2 = qc2 + _where0(det_zone, tem_d)
    return qc2, qi2


def nsas_shallow(delt, del_, prsl_mb, prsi_mb, zl, ncloud, qc2, qi2,
                 q1, t1, slimsk, dot, u1, v1, hpbl, hfx, qfx, icps,
                 theta1):
    """Shallow SAS (nscv2d). Non-precipitating shallow convection for
    columns where deep convection did not act; PBL-buoyancy-flux mass
    closure (Grant 2001). Returns (t1, q1, qc2, qi2, rain_m)."""
    KLEV = t1.shape[0]
    shape2 = t1.shape[1:]
    dev = t1.device
    karr = torch.arange(KLEV, device=dev)[:, None, None]
    dt2 = _dt_tensor(delt, t1)
    zero2 = torch.zeros(shape2, dtype=t1.dtype, device=dev)
    zero3 = torch.zeros_like(t1)
    C1S = 5e-4
    CLAM_S = 0.3
    BETAW = 0.03
    land = slimsk == 1.0
    w3 = _full(land, -5e-3, -1e-3)
    w4 = _full(land, -5e-4, -2e-5)

    p = prsl_mb
    # surface buoyancy flux (cu_nsas.f90:2349-2368); p is mb -> *100 Pa
    rhox = p[0] * 100.0 / (RD * t1[0] * (1.0 + FV * q1[0]))
    sflx = hfx / rhox * inv(CP) + qfx / rhox * FV * theta1
    cnvflg = (icps != 1) & (sflx > 0.0)

    kbm = torch.clamp(torch.sum(p > prsi_mb[0][None] * 0.70, 0),
                      max=KLEV - 1)
    kmaxc = torch.clamp(torch.sum(p > prsi_mb[0][None] * 0.60, 0),
                        max=KLEV - 1)
    kbm = torch.minimum(kbm, kmaxc)

    zi = torch.cat([zl[:1] * 0.0, 0.5 * (zl[:-1] + zl[1:]), zl[-1:]], 0)
    xlamue = _rd(CLAM_S, zi[1:KLEV + 1])
    xlamue[KLEV - 1] = xlamue[KLEV - 2]

    # pbl top index
    below = (zl <= hpbl[None]).to(torch.int32)
    kpbl = torch.clamp(torch.sum(torch.cumprod(below, 0), 0) - 1, min=0)
    kpbl = torch.minimum(kpbl, kbm)

    to = t1
    qo = torch.clamp(q1, min=1e-10)
    uo = u1
    vo = v1
    qeso = torch.clamp(_qes(to, p), min=1e-8)
    heo = G * zl + CP * to + HVAP * qo

    kb = torch.argmax(torch.where(karr <= kpbl[None], heo,
                                  torch.full_like(heo, -np.inf)), dim=0)

    to, qo, qeso, heo, heso, po = _half_level_env(to, qo, zl, p, None,
                                                  KLEV)
    qeso = torch.clamp(qeso, min=1e-8)
    hkb = _lev(heo, kb)

    lfc = (karr > kb[None]) & (hkb[None] > heso) & (karr < kbm[None])
    kbcon = _first_above(lfc, None, KLEV - 1)
    cnvflg = cnvflg & (kbcon < KLEV - 1)

    pdot = 10.0 * _lev(dot, kbcon)
    ptem = _cincr(pdot, w3, w4)
    cincr = CINCRMAX - ptem * 0.5 * (CINCRMAX - CINCRMIN)
    cnvflg = cnvflg & ((_lev(p, kb) - _lev(p, kbcon)) <= cincr)

    xlamud = _lev(xlamue, kbcon)
    eta = torch.ones_like(t1)
    for it in range(KLEV - 2):
        k = KLEV - 2 - it
        dz = zi[k + 2] - zi[k + 1]
        ptem_ = 0.5 * (xlamue[k] + xlamue[k + 1]) - xlamud
        val = eta[k + 1] / (1.0 + ptem_ * dz)
        use = cnvflg & (k < kbcon) & (k >= kb)
        eta[k] = torch.where(use, val, eta[k])
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        ptem_ = 0.5 * (xlamue[k] + xlamue[k - 1]) - xlamud
        val = eta[k - 1] * (1.0 + ptem_ * dz)
        use = cnvflg & (k > kbcon) & (k < kmaxc)
        eta[k] = torch.where(use, val, eta[k])

    heo_mid = 0.5 * (heo + _km1(heo))
    hcko = _updraft_recur(kb, None, xlamue, xlamud, zi, hkb, heo_mid,
                          cnvflg)
    dbyo = hcko - heso

    kbcon1 = _first_above((karr >= kbcon[None]) & (dbyo > 0.0)
                          & (karr < kbm[None]), None, KLEV - 1)
    cnvflg = cnvflg & (kbcon1 < KLEV - 1)
    cnvflg = cnvflg & ((_lev(p, kbcon) - _lev(p, kbcon1)) <= DTHK)

    ktcon = _first_above((karr > kbcon1[None]) & (dbyo < 0.0)
                         & (karr < kbm[None]), None, kbm)

    xmbmax = 1000.0 * _lev(del_, kbcon) / (G * dt2)

    qo_mid = 0.5 * (qo + _km1(qo))
    c_liq = C0 + C1S if ncloud > 0 else C0
    qcko = _where0(karr == kb[None], _lev(qo, kb)[None].expand_as(t1))
    pwo, dellal, aa1 = zero3.clone(), zero3.clone(), zero2
    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        gamma = EL2ORC * qeso[k] / (to[k] * to[k])
        qrch = qeso[k] + gamma * dbyo[k] / (HVAP * (1.0 + gamma))
        tem = 0.5 * (xlamue[k] + xlamue[k - 1]) * dz
        tem1 = 0.5 * xlamud * dz
        factor = 1.0 + tem - tem1
        qk = ((1.0 - tem1) * qcko[k - 1] + tem * qo_mid[k]) / factor
        zone = cnvflg & (k > kb) & (k < ktcon)
        qk = torch.where(zone, qk, qcko[k])
        dq = eta[k] * (qk - qrch)
        etah = 0.5 * (eta[k] + eta[k - 1])
        dp = 1000.0 * del_[k]
        wet = zone & (k >= kbcon) & (dq > 0.0)
        qlk = dq / (eta[k] + etah * c_liq * dz)
        if ncloud > 0:
            dellal[k] = _where0(wet, etah * C1S * dz * qlk * G / dp)
        aa1 = aa1 - _where0(wet, dz * G * qlk)
        qcko[k] = torch.where(wet, qlk + qrch, qk)
        pwo[k] = _where0(wet, etah * C0 * dz * qlk)

    dz1_arr = torch.cat([zl[1:] - zl[:-1], zl[-1:] * 0 + 1.0], 0)
    gamma_a = EL2ORC * qeso / (to * to)
    cwf_term = _cwf_term(dz1_arr, to, dbyo, qeso, qo, gamma_a)
    cwf_zone = (karr >= kbcon[None]) & (karr < ktcon[None])
    aa1 = aa1 + pw.sum0(_where0(cwf_zone & cnvflg[None], cwf_term))
    cnvflg = cnvflg & (aa1 > 0.0)

    # overshoot
    aa, ktcon1, flg = AAFAC * aa1, kbm, cnvflg
    for k in range(1, KLEV - 1):
        act = flg & (k >= ktcon) & (k < kbm)
        aa = aa + _where0(act, cwf_term[k])
        hit = act & (aa < 0.0)
        ktcon1 = torch.where(hit, k, ktcon1)
        flg = flg & ~hit

    for k in range(1, KLEV - 1):
        dz = zi[k + 1] - zi[k]
        gamma = EL2ORC * qeso[k] / (to[k] * to[k])
        qrch = qeso[k] + gamma * dbyo[k] / (HVAP * (1.0 + gamma))
        tem = 0.5 * (xlamue[k] + xlamue[k - 1]) * dz
        tem1 = 0.5 * xlamud * dz
        factor = 1.0 + tem - tem1
        qk = ((1.0 - tem1) * qcko[k - 1] + tem * qo_mid[k]) / factor
        zone = cnvflg & (k >= ktcon) & (k < ktcon1)
        qk = torch.where(zone, qk, qcko[k])
        dq = eta[k] * (qk - qrch)
        etah = 0.5 * (eta[k] + eta[k - 1])
        dp = 1000.0 * del_[k]
        wet = zone & (dq > 0.0)
        qlk = dq / (eta[k] + etah * c_liq * dz)
        if ncloud > 0:
            dellal[k] = torch.where(wet, etah * C1S * dz * qlk * G / dp,
                                    dellal[k])
        qcko[k] = torch.where(wet, qlk + qrch, qk)
        pwo[k] = torch.where(wet, etah * C0 * dz * qlk, pwo[k])
    ktcon, ktcon1 = ktcon1, ktcon

    ktm1 = torch.clamp(ktcon - 1, min=0)
    to_t = _lev(to, ktm1)
    gamma_t = EL2ORC * _lev(qeso, ktm1) / (to_t * to_t)
    qrch_t = _lev(qeso, ktm1) + gamma_t * _lev(dbyo, ktm1) \
        / (HVAP * (1.0 + gamma_t))
    dq_t = _lev(qcko, ktm1) - qrch_t
    qlko_ktcon = _where0(cnvflg & (dq_t > 0.0), dq_t) if ncloud > 0 \
        else zero2

    # precipitation efficiency (evaporation factor only)
    edt = _edt(uo, vo, zi, kb, ktcon, karr, KLEV)

    # unit-mass-flux environment change (updraft only)
    heo_km1 = _km1(heo)
    qo_km1 = _km1(qo)
    eta_km1 = _km1(eta)
    hcko_km1 = _km1(hcko)
    qcko_km1 = _km1(qcko)
    xlam_km1 = _km1(xlamue)
    dp3 = 1000.0 * del_
    dzi3 = zi[1:KLEV + 1] - zi[:KLEV]
    tem3 = 0.5 * (xlamue + xlam_km1)

    def della(f, f_km1, fcu, fcu_km1):
        return ((eta * f - eta_km1 * f_km1
                 - tem3 * eta_km1 * 0.5 * (f + f_km1) * dzi3
                 + xlamud[None] * eta_km1 * 0.5 * (fcu + fcu_km1) * dzi3)
                * G / dp3)

    dellah = della(heo, heo_km1, hcko, hcko_km1)
    dellaq = della(qo, qo_km1, qcko, qcko_km1)
    interior = (karr > kb[None]) & (karr < ktcon[None])
    dellah = _where0(interior, dellah)
    dellaq = _where0(interior, dellaq)
    at_top = karr == ktcon[None]
    dellah = torch.where(at_top, eta_km1 * (hcko_km1 - heo_km1) * G / dp3,
                         dellah)
    dellaq = torch.where(at_top, eta_km1 * (qcko_km1 - qo_km1) * G / dp3,
                         dellaq)
    dellal = torch.where(at_top, eta_km1 * qlko_ktcon[None] * G / dp3,
                         dellal)

    # Grant (2001) mass flux closure
    wstar = pw.pow(torch.clamp(G * sflx * hpbl / t1[0], min=1e-20),
                   1.0 / 3.0)
    tem_rho = _lev(po, kbcon) * 100.0 / (RD * _lev(t1, kbcon))
    xmb = torch.minimum(BETAW * tem_rho * wstar, xmbmax)

    apply = cnvflg[None] & (karr > kb[None]) & (karr <= ktcon[None])
    dellat3 = (dellah - HVAP * dellaq) * inv(CP)
    t1n = torch.where(apply, t1 + dellat3 * xmb[None] * dt2, t1)
    q1n = torch.where(apply, q1 + dellaq * xmb[None] * dt2, q1)

    contrib = _where0(cnvflg[None] & (karr < ktcon[None])
                      & (karr > kb[None]), pwo * xmb[None] * .001 * dt2)
    rntot = pw.sum0(contrib)
    evef_fac = torch.where(land, edt * EVFACTL, edt * EVFACTS)

    rain, delqev, flg = zero2, zero2, cnvflg
    for it in range(KLEV):
        k = KLEV - 1 - it
        rain = rain + contrib[k]
        qeso_k = torch.clamp(_qes(t1n[k], p[k]), min=1e-8)
        qcond = evef_fac * (q1n[k] - qeso_k) \
            / (1.0 + EL2ORC * qeso_k / (t1n[k] * t1n[k]))
        dp = 1000.0 * del_[k]
        active = flg & (k < ktcon)
        has = active & (rain > 0.0) & (qcond < 0.0)
        rain0 = torch.clamp(rain, min=0.0)
        qevap = _where0(has, -qcond * (1.0 - torch.exp(
            -.32 * torch.sqrt(dt2 * rain0))))
        qevap = torch.minimum(qevap, rain0 * 1000. * G / dp)
        delq2 = delqev + .001 * qevap * dp * inv(G)
        over = has & (delq2 > rntot)
        qevap = torch.where(over, 1000. * G * (rntot - delqev) / dp, qevap)
        flg = flg & ~over
        doit = has & (qevap > 0.0)
        tem_m = .001 * dp * inv(G)
        exceeds = doit & (qevap * tem_m > rain)
        qevap = torch.where(exceeds, rain / tem_m, qevap)
        rain = torch.where(doit, torch.where(exceeds, zero2,
                                             rain - qevap * tem_m), rain)
        q1n[k] = torch.where(doit, q1n[k] + qevap, q1n[k])
        t1n[k] = torch.where(doit, t1n[k] - (HVAP / CP) * qevap, t1n[k])
        delqev = delqev + _where0(doit, .001 * dp * qevap * inv(G))
    rain = torch.where(cnvflg & ((rain < 0.0) | ~flg), zero2, rain)

    det_zone = cnvflg[None] & (karr >= kbcon[None]) \
        & (karr <= ktcon[None])
    qc2, qi2 = _detrain(det_zone, dellal * xmb[None] * dt2, t1n, qc2, qi2,
                        ncloud)
    return t1n, q1n, qc2, qi2, rain


def nsas(u, v, w_if, t, qv, qc, qi, rho, p, p_i, dz, exner, hpbl, hfx,
         qfx, xland, dx, dt, mp_physics=5, dx_factor_nsas=None):
    """Full NSAS step: deep then shallow (cu_nsas wrapper,
    cu_nsas.f90:8-308). Inputs bottom-up (z, y, x); returns
    (th_new, qv_new, qc_new, qi_new, rain_delta_mm)."""
    ncloud = 0 if mp_physics == 0 else (1 if mp_physics in (1, 3) else 2)
    if dx_factor_nsas is None:
        dx_factor_nsas = 1 if dx <= 1000.0 else 2
    dt = _dt_tensor(dt, t)
    dot = -5.0e-4 * G * rho * (w_if[:-1] + w_if[1:])
    zii = torch.cat([torch.zeros_like(dz[:1]), pw.cumsum(dz, 0)], 0)
    zl = 0.5 * (zii[:-1] + zii[1:])
    prsl_cb = p * 0.001          # cb
    prsi_cb = p_i * 0.001
    del_cb = prsl_cb * G * inv(RD) * dz / t
    prsl_mb = prsl_cb * 10.0
    prsi_mb = prsi_cb * 10.0
    slimsk = torch.abs(xland - 2.0)

    t1, q1, qc2, qi2, rain_d, kbot, ktop, icps = nsas_deep(
        dt, dx, del_cb, prsl_mb, prsi_mb, zl, ncloud, qc, qi, qv, t,
        slimsk, dot, u, v, dx_factor_nsas)
    t1, q1, qc2, qi2, rain_s = nsas_shallow(
        dt, del_cb, prsl_mb, prsi_mb, zl, ncloud, qc2, qi2, q1, t1,
        slimsk, dot, u, v, hpbl, hfx, qfx, icps, t1[0] / exner[0])
    rain_mm = (rain_d + rain_s) * 1000.0
    th_new = t1 / exner
    return th_new, q1, qc2, qi2, rain_mm

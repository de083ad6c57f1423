"""Tiedtke mass-flux cumulus convection (Tiedtke 1989, ECMWF)
(icar_tpu/physics/cu_tiedtke.py: CU_TIEDTKE -> TIECNV -> CUMASTR_NEW and
its subtree of cu_tiedtke.f90), over the (ny, nx) columns at once. The
scheme runs in the reference's vertical order -- index 0 the model top,
KLEV-1 the lowest layer -- so each k+1/k-1 of the Fortran maps verbatim;
``tiedtke`` flips the model's bottom-up arrays at entry and exit.

Components: the half-level environment (CUINI), the non-entraining
sub-cloud ascent to the lifting condensation level (CUBASE), the
moisture-convergence trigger, the entraining/detraining updraft with
organized entrainment and the Nordeng CAPE closure (CUASC/CUENTR),
mid-level onset (CUBASMC), downdrafts (CUDLFS/CUDDRAF), the flux
finalization with snow melt and sub-cloud evaporation (CUFLX) and the T/q
tendencies (CUDTDQ). Momentum tendencies are left out, as in the JAX
package (ICAR never applies them, cu_driver.f90:502-508).

Plain PyTorch: each level of a vertical scan is a whole-grid operation,
the scans are Python loops over the levels (the updraft's level loop of
the JAX package's ``fori_loop`` writes the rows of its profiles in place).
Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), as in the JAX package's compiled step; ``dt`` is a
0-d float32 tensor (a number in the tests). All humidities inside are
specific humidities.
"""

from __future__ import annotations

import torch

from ..ops.indexing import take_level as _lev
from ..ops import pointwise as pw
from ..ops.pointwise import inv

# constants (cu_tiedtke.f90:38-148)
G = 9.806
ZRG = 1.0 / G
CPD = 1005.46
RCPD = 1.0 / CPD
RD = 287.05
RV = 461.51
ALV = 2.5008e6
ALS = 2.8345e6
ALF = ALS - ALV
TMELT = 273.16
C1ES = 610.78
C2ES = C1ES * RD / RV
C3LES, C4LES = 17.269, 35.86
C3IES, C4IES = 21.875, 7.66
C5LES = C3LES * (TMELT - C4LES)
C5IES = C3IES * (TMELT - C4IES)
VTMPC1 = RV / RD - 1.0
T000 = 273.15
HGFR = 233.15

ENTRPEN = 1.0e-4
ENTRSCV = 1.2e-3
ENTRMID = 1.0e-4
ENTRDD = 2.0e-4
CMFCTOP = 0.30
CMFCMAX = 1.0
CMFCMIN = 1e-10
CMFDEPS = 0.30
CPRCON = 1.1e-3 / G
ZDNOPRC = 1.5e4
RHC, RHM = 0.80, 1.0
ZBUO0 = 0.50
CRIRH = 0.70
FDBK = 1.0
ZTAU = 1800.0
CEVAPCU1 = 1.93e-6 * 261.0 * 0.5 / G
CEVAPCU2 = 1e3 / (38.3 * 0.293)


def tlucua(tt):
    warm = (tt - TMELT) > 0.0
    zcvm3 = torch.where(warm, C3LES, C3IES)
    zcvm4 = torch.where(warm, C4LES, C4IES)
    return C2ES * torch.exp(zcvm3 * (tt - TMELT) / (tt - zcvm4))


def tlucub(tt):
    warm = (tt - TMELT) > 0.0
    zcvm4 = torch.where(warm, C4LES, C4IES)
    zcvm5 = torch.where(warm, C5LES * ALV / CPD, C5IES * ALS / CPD)
    r = 1.0 / (tt - zcvm4)
    return zcvm5 * (r * r)


def tlucuc(tt):
    return torch.where((tt - TMELT) > 0.0, ALV / CPD, ALS / CPD)


def _qsat(tt, p):
    qs = torch.clamp(tlucua(tt) / p, max=0.5)
    return qs / (1.0 - VTMPC1 * qs)


def cuadjtq(t, q, p, mask, kcall):
    """Two-iteration saturation adjustment at one level (CUADJTQ,
    cu_tiedtke.f90:3170-3325). kcall: 1 condensation only (>= 0), 2
    evaporation only (<= 0), 0/4 both signs. The second iteration touches
    only cells the first one changed (kcall 1/2)."""
    def one_pass(t, q, m):
        zqsat = torch.clamp(tlucua(t) / p, max=0.5)
        zcor = 1.0 / (1.0 - VTMPC1 * zqsat)
        zqsat = zqsat * zcor
        cond = (q - zqsat) / (1.0 + zqsat * zcor * tlucub(t))
        return torch.where(m, cond, 0.0)

    cond1 = one_pass(t, q, mask)
    if kcall == 1:
        cond1 = torch.clamp(cond1, min=0.0)
    elif kcall == 2:
        cond1 = torch.clamp(cond1, max=0.0)
    t = t + tlucuc(t) * cond1
    q = q - cond1
    mask2 = mask if kcall in (0, 4) else (mask & (cond1 != 0.0))
    cond2 = one_pass(t, q, mask2)
    t = t + tlucuc(t) * cond2
    q = q - cond2
    return t, q


def _last_near(p_hpa, target, klev, otherwise):
    """The lowest level k in 1..klev-1 (largest index) whose pressure
    ``p_hpa[k]`` lies within 50 hPa of ``target``, else ``otherwise``."""
    near = torch.abs(p_hpa[1:klev] - target) < 50.0
    last = (klev - 1) - torch.argmax(torch.flip(near, [0]).to(torch.uint8),
                                     dim=0)
    return torch.where(torch.any(near, dim=0), last, otherwise)


def cumastr(ten, qen, uen, ven, verv, qsen, qhfl, dt, pap, paph, geo,
            qte_in, lndj, sig1):
    """CUMASTR_NEW (cu_tiedtke.f90:721-1244). Every array top-down.

    Returns (tte, qte_add, cte, rsfc, ssfc, ldcum)."""
    KLEV = ten.shape[0]
    shape2 = ten.shape[1:]
    dev = ten.device
    zcons2 = 1.0 / (G * dt)
    zero2 = torch.zeros(shape2, dtype=ten.dtype, device=dev)
    zero3 = torch.zeros_like(ten)
    karr = torch.arange(KLEV, device=dev)[:, None, None]

    # ---- CUINI (cu_tiedtke.f90:1256-1388) ------------------------------
    geoh = torch.cat([geo[:1], geo[1:] + (geo[:-1] - geo[1:]) * 0.5], 0)
    tenh_mid = (torch.maximum(CPD * ten[:-1] + geo[:-1],
                              CPD * ten[1:] + geo[1:]) - geoh[1:]) * RCPD
    tenh = torch.cat([ten[:1], tenh_mid], 0)
    qsenh = torch.cat([qsen[:1], qsen[:-1]], 0)
    # saturation at half levels via CUADJTQ(kcall=0)
    all_cells = torch.ones(shape2, dtype=torch.bool, device=dev)
    th_list = [tenh[0]]
    qsh_list = [qsenh[0]]
    for k in range(1, KLEV):
        tk, qk = cuadjtq(tenh[k], qsenh[k], paph[k], all_cells, 0)
        th_list.append(tk)
        qsh_list.append(qk)
    qsenh = torch.stack(qsh_list)
    qenh_mid = torch.clamp(torch.minimum(qen[:-1], qsen[:-1])
                           + (qsenh[1:] - qsen[:-1]), min=0.0)
    qenh = torch.cat([qen[:1], qenh_mid], 0)
    qenh[KLEV - 1] = qen[KLEV - 1]
    th_list[KLEV - 1] = (CPD * ten[KLEV - 1] + geo[KLEV - 1]
                         - geoh[KLEV - 1]) * RCPD
    # static-stability adjustment sweep (bottom-up)
    for k in range(KLEV - 2, 0, -1):
        zzs = torch.maximum(CPD * th_list[k] + geoh[k],
                            CPD * th_list[k + 1] + geoh[k + 1])
        th_list[k] = (zzs - geoh[k]) * RCPD
    tenh = torch.stack(th_list)
    # the level of minimum omega
    klwmin = torch.argmin(torch.where(karr >= 2, verv, float("inf")), dim=0)

    ptu = tenh
    pqu = qenh
    plu = zero3

    # ---- CUBASE (cu_tiedtke.f90:1393-1537) -----------------------------
    kcbot = torch.full(shape2, KLEV - 2, dtype=torch.long, device=dev)
    ldcum = torch.zeros(shape2, dtype=torch.bool, device=dev)
    ptu_rows = list(ptu.unbind(0))
    pqu_rows = list(pqu.unbind(0))
    plu_rows = list(plu.unbind(0))
    klab_rows = [torch.full(shape2, int(k == KLEV - 1), dtype=torch.long,
                            device=dev) for k in range(KLEV)]
    for k in range(KLEV - 2, 0, -1):
        lo = klab_rows[k + 1] == 1
        pqu_k = torch.where(lo, pqu_rows[k + 1], pqu_rows[k])
        ptu_k = torch.where(lo, (CPD * ptu_rows[k + 1] + geoh[k + 1]
                                 - geoh[k]) * RCPD, ptu_rows[k])
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k) \
            - tenh[k] * (1. + VTMPC1 * qenh[k]) + ZBUO0
        klab_rows[k] = torch.where(lo & (zbuo > 0.), 1, klab_rows[k])
        zqold = pqu_k
        ptu_k, pqu_k = cuadjtq(ptu_k, pqu_k, paph[k], lo, 1)
        condensed = lo & (pqu_k != zqold)
        klab_rows[k] = torch.where(condensed, 2, klab_rows[k])
        plu_rows[k] = torch.where(condensed, plu_rows[k] + zqold - pqu_k,
                                  plu_rows[k])
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k) \
            - tenh[k] * (1. + VTMPC1 * qenh[k]) + ZBUO0
        newbase = condensed & (zbuo > 0.)
        kcbot = torch.where(newbase, k, kcbot)
        ldcum = ldcum | newbase
        ptu_rows[k] = ptu_k
        pqu_rows[k] = pqu_k
    ptu = torch.stack(ptu_rows)
    pqu = torch.stack(pqu_rows)
    plu = torch.stack(plu_rows)
    klab = torch.stack(klab_rows)

    # ---- trigger: moisture convergence (cutrigger=1; :885-905) ---------
    dpaph = paph[1:] - paph[:-1]                   # (KLEV, ...)
    zdqcv = pw.sum0(qte_in * dpaph)
    zdqpbl = pw.sum0(torch.where(karr >= kcbot[None], qte_in * dpaph,
                                 0.0))
    ktype = torch.where(zdqcv > torch.clamp(1.1 * qhfl * G, min=0.0), 1, 2)

    # ---- cloud-base mass flux (:920-935) -------------------------------
    qu_b = _lev(pqu, kcbot)
    lu_b = _lev(plu, kcbot)
    qenh_b = _lev(qenh, kcbot)
    zqumqe = qu_b + lu_b - qenh_b
    zdqmin = torch.clamp(0.01 * qenh_b, min=1e-10)
    ok = (zdqpbl > 0.) & (zqumqe > zdqmin) & ldcum
    zmfub = torch.where(ok, zdqpbl / (G * torch.maximum(zqumqe, zdqmin)),
                        0.01)
    ldcum = ldcum & ok
    zmfmax = (_lev(paph, kcbot) - _lev(paph, kcbot - 1)) * zcons2
    zmfub = torch.minimum(zmfub, zmfmax)

    # ---- cloud height estimate and hhat (:940-975) ---------------------
    tu_b = _lev(ptu, kcbot)
    geoh_b = _lev(geoh, kcbot)
    zhcbase = CPD * tu_b + geoh_b + ALV * qu_b
    zalvdcp = ALV / CPD
    zqalv = 1.0 / ALV
    zhsat = CPD * tenh + geoh + ALV * qsenh
    dtc = tenh - C4LES
    zgam = C5LES * zalvdcp * qsenh / ((1. - VTMPC1 * qsenh) * (dtc * dtc))
    zzz = CPD * tenh * 0.608
    zhhat = zhsat - (zzz + zgam * zzz) / (1. + zgam * zzz * zqalv) \
        * torch.clamp(qsenh - qenh, min=0.0)
    zhhatt = zhhat
    # ictop0: the lowest k (scanning up from the base) where
    # zhcbase > zhhat
    ictop0 = kcbot - 1
    for k in range(KLEV - 2, 1, -1):
        hit = (k < ictop0) & (zhcbase > zhhat[k])
        ictop0 = torch.where(hit, k, ictop0)

    # ---- the lowest organized detrainment level (:976-1010) ------------
    deep = ldcum & (ktype == 1)
    ihmin = torch.where(deep, kcbot, -1)
    zhmin = zero2
    zbi = 1.0 / (25.0 * G)
    ihmin_out = ihmin
    found = ~deep
    geoh_base = geoh_b
    for k in range(KLEV - 1, 0, -1):
        act = deep & (k < kcbot) & (k >= ictop0) & ~found
        zro = RD * tenh[k] / (G * paph[k])
        zdz = (paph[k] - paph[k - 1]) * zro
        dgeo = geo[k - 1] - geo[k]
        zdhdz = (CPD * (ten[k - 1] - ten[k])
                 + ALV * (qen[k - 1] - qen[k]) + dgeo) * G \
            / torch.where(dgeo == 0, 1.0, dgeo)
        zdepth = geoh[k] - geoh_base
        zfac = torch.sqrt(1. + zdepth * zbi)
        zhmin = torch.where(act, zhmin + zdhdz * zfac * zdz, zhmin)
        zrh = -ALV * (qsenh[k] - qenh[k]) * zfac
        hit = act & (zhmin > zrh)
        ihmin_out = torch.where(hit & ~found, k, ihmin_out)
        found = found | hit
    ihmin = torch.where(deep, torch.maximum(ihmin_out, ictop0), ihmin)
    zentr = torch.where(ktype == 1, ENTRPEN, ENTRSCV)
    zentr = torch.where(lndj == 1, zentr * 1.05, zentr)

    def ascent(zmfub, zentr, ktype, klab_in, ldcum_in, kcbot, ictop0,
               ptu_in, pqu_in):
        return cuasc(tenh, qenh, ten, qen, qsen, geo, geoh, pap, paph,
                     verv, klwmin, ldcum_in, zhcbase, ktype, klab_in,
                     ptu_in, pqu_in, zmfub, zentr, kcbot, ictop0, dt,
                     ihmin, zhhatt, qsenh)

    # ---- first ascent (:1012-1031) -------------------------------------
    (ldcum1, ktype1, kcbot1, kctop, ptu1, pqu1, plu1, pmfu, zmfus,
     zmfuq, zmful, plude, zdmfup, klab1) = ascent(
        zmfub, zentr, ktype, klab, ldcum, kcbot, ictop0, ptu, pqu)

    # check the cloud depth; shallow -> re-classify (:1032-1045)
    zpbmpt = _lev(paph, kcbot1) - _lev(paph, kctop)
    ictop0 = torch.where(ldcum1, kctop, ictop0)
    ktype1 = torch.where(ldcum1 & (ktype1 == 1) & (zpbmpt < ZDNOPRC), 2,
                         ktype1)
    zentr = torch.where(ktype1 == 2,
                        torch.where(lndj == 1, ENTRSCV * 1.05, ENTRSCV),
                        zentr)
    zrfl = pw.sum0(zdmfup)

    # ---- downdrafts (:1050-1065) ---------------------------------------
    (ztd, zqd, pmfd, zmfds, zmfdq, zdmfdp, idtop,
     loddraf) = cudlfs_cuddraf(tenh, qenh, geoh, paph, ptu1, pqu1,
                               ldcum1, kcbot1, kctop, zmfub, zrfl)

    # ---- CAPE closure of deep convection (:1070-1135) ------------------
    zheat = zero2
    zcape = zero2
    zrelh = zero2
    # ktop0: the lowest level with p within 50 hPa of 300 hPa
    kk300 = _last_near(paph * 0.01, 300.0, KLEV, KLEV - 1)
    ktop0 = torch.maximum(kk300, kctop)
    paph_cb1 = _lev(paph, kcbot1)
    paph_kt0 = _lev(paph, ktop0)
    for k in range(1, KLEV):
        inside = (k <= kcbot1) & (k > kctop)
        zro = paph[k] / (RD * tenh[k])
        zdz = (paph[k] - paph[k - 1]) / (G * zro)
        zheat = zheat + torch.where(
            inside & ldcum1,
            ((ten[k - 1] - ten[k] + G * zdz * inv(CPD)) / tenh[k]
             + 0.608 * (qen[k - 1] - qen[k]))
            * (pmfu[k] + pmfd[k]) * G / zro, 0.0)
        zcape = zcape + torch.where(
            inside & ldcum1,
            G * ((ptu1[k] * (1. + .608 * pqu1[k] - plu1[k]))
                 / (tenh[k] * (1. + .608 * qenh[k])) - 1.0) * zdz, 0.0)
        in_rh = (k <= kcbot1) & (k > ktop0)
        dept = (paph[k] - paph[k - 1]) \
            / torch.clamp(paph_cb1 - paph_kt0, min=1e-10)
        zrelh = zrelh + torch.where(in_rh & ldcum1,
                                    dept * qen[k] / qsen[k], 0.0)
    crirh1 = torch.where(lndj == 1, CRIRH * 0.8, CRIRH)
    deep1 = ldcum1 & (ktype1 == 1)
    cape_ok = (zrelh >= crirh1) & (zcape > 100.0)
    zht = zcape / (ZTAU * torch.where(zheat == 0, 1.0, zheat))
    zmfub1_deep = torch.clamp(zmfub * zht, min=0.01)
    zmfmax = (_lev(paph, kcbot1) - _lev(paph, kcbot1 - 1)) * zcons2
    zmfub1_deep = torch.minimum(zmfub1_deep, zmfmax)
    zmfub1 = torch.where(deep1, torch.where(cape_ok, zmfub1_deep, 0.01),
                         zmfub)
    zmfub = torch.where(deep1 & ~cape_ok, 0.01, zmfub)
    ldcum1 = ldcum1 & ~(deep1 & ~cape_ok)

    # shallow/mid: PBL equilibrium with downdraft moistening (:1137-1165)
    notdeep = ktype1 != 1
    zeps = torch.where((_lev(pmfd, kcbot1) < 0.0) & loddraf, CMFDEPS, 0.0)
    qd_b = _lev(zqd, kcbot1)
    qenh_b1 = _lev(qenh, kcbot1)
    zqumqe2 = _lev(pqu1, kcbot1) + _lev(plu1, kcbot1) \
        - zeps * qd_b - (1. - zeps) * qenh_b1
    zdqmin2 = torch.clamp(0.01 * qenh_b1, min=1e-10)
    cond_s = (zdqpbl > 0.) & (zqumqe2 > zdqmin2) & ldcum1 \
        & (zmfub < zmfmax)
    zmfub1_sh = torch.where(
        cond_s, zdqpbl / (G * torch.maximum(zqumqe2, zdqmin2)), zmfub)
    keep = (ktype1 == 2) & (torch.abs(zmfub1_sh - zmfub) < 0.2 * zmfub)
    zmfub1_sh = torch.where(keep, zmfub1_sh, zmfub)
    zmfub1_sh = torch.minimum(zmfub1_sh, zmfmax)
    zmfub1 = torch.where(notdeep, zmfub1_sh, zmfub1)

    zfac = (zmfub1 / torch.clamp(zmfub, min=1e-10))[None]
    on = ldcum1[None]
    pmfd = torch.where(on, pmfd * zfac, 0.0)
    zmfds = torch.where(on, zmfds * zfac, 0.0)
    zmfdq = torch.where(on, zmfdq * zfac, 0.0)
    zdmfdp = torch.where(on, zdmfdp * zfac, 0.0)
    zmfub = torch.where(ldcum1, zmfub1, 0.0)

    # ---- final ascent (:1170-1185) -------------------------------------
    (ldcum2, ktype2, kcbot2, kctop, ptu2, pqu2, plu2, pmfu, zmfus,
     zmfuq, zmful, plude, zdmfup, _) = ascent(
        zmfub, zentr, ktype1, klab1, ldcum1, kcbot1, ictop0, ptu1, pqu1)

    # ---- CUFLX (:2670-2860) --------------------------------------------
    (pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq, zmful, plude, zdmfup,
     zdmfdp, zrfl2, zsfl, zdpmel, prain, ldcum3,
     ktype3) = cuflx(qen, qsen, tenh, qenh, paph, geoh, kcbot2, kctop,
                     idtop, ktype2, loddraf, ldcum2, pmfu, pmfd, zmfus,
                     zmfds, zmfuq, zmfdq, zmful, plude, zdmfup, zdmfdp,
                     ten, dt, sig1)

    # ---- CUDTDQ (:2862-2975) -------------------------------------------
    tte, qte_add, cte = cudtdq(paph, ldcum3, ten, zmfus, zmfds, zmfuq,
                               zmfdq, zmful, zdmfup, zdmfdp, zdpmel,
                               qen, qsen, plude)
    return tte, qte_add, cte, zrfl2, zsfl, ldcum3


def cuasc(tenh, qenh, ten, qen, qsen, geo, geoh, pap, paph, verv,
          klwmin, ldcum, zhcbase, ktype, klab, ptu, pqu, zmfub, zentr,
          kcbot, ictop0, dt, khmin, zhhatt, qsenh):
    """CUASC_NEW: the entraining/detraining updraft ascent
    (cu_tiedtke.f90:1882-2382). The level loop writes each level's rows of
    the profiles in place (the profiles are copies made here)."""
    KLEV = tenh.shape[0]
    shape2 = tenh.shape[1:]
    dev = tenh.device
    zcons2 = 1.0 / (G * dt)
    karr = torch.arange(KLEV, device=dev)[:, None, None]

    ktype = torch.where(~ldcum, 0, ktype)
    klab = torch.where((~ldcum | (ktype == 3))[None], 0, klab)
    below4e4 = paph[:KLEV] < 4e4
    for k in range(KLEV):
        ictop0 = torch.where(~ldcum & below4e4[k], k, ictop0)

    kctop = torch.full(shape2, KLEV - 2, dtype=torch.long, device=dev)
    kcbot = torch.where(~ldcum, KLEV - 2, kcbot)
    zmfub = torch.where(~ldcum, 0.0, zmfub)
    ptu = ptu.clone()
    pqu = pqu.clone()
    pqu[KLEV - 1] = torch.where(~ldcum, 0.0, pqu[KLEV - 1])

    plu = torch.zeros_like(tenh)
    pmfu = torch.zeros_like(tenh)
    zmfus = torch.zeros_like(tenh)
    zmfuq = torch.zeros_like(tenh)
    zmful = torch.zeros_like(tenh)
    plude = torch.zeros_like(tenh)
    zdmfup = torch.zeros_like(tenh)
    odetr = torch.zeros_like(tenh)
    pmfu[KLEV - 1] = zmfub
    zmfus[KLEV - 1] = zmfub * (CPD * ptu[KLEV - 1] + geoh[KLEV - 1])
    zmfuq[KLEV - 1] = zmfub * pqu[KLEV - 1]

    # organized entrainment at cloud base (orgen=1; :2050-2075)
    deep = ktype == 1
    tu_b = _lev(ptu, kcbot)
    qu_b = _lev(pqu, kcbot)
    tenh_b = _lev(tenh, kcbot)
    qenh_b = _lev(qenh, kcbot)
    zbuoy = G * ((tu_b - tenh_b) / tenh_b + 0.608 * (qu_b - qenh_b))
    zbuoy = torch.where(deep, zbuoy, 0.0)
    base_m1 = torch.clamp(kcbot - 1, min=0)
    geo_bm1 = _lev(geo, base_m1)
    geo_b = _lev(geo, kcbot)
    ten_bm1 = _lev(ten, base_m1)
    ten_b = _lev(ten, kcbot)
    zdz0 = (geo_bm1 - geo_b) * ZRG
    zdrodz0 = -torch.log(ten_bm1 / ten_b) \
        / torch.where(zdz0 == 0, 1., zdz0) - G / (RD * tenh_b)
    oentr_base = torch.clamp(zbuoy * 0.5 / (1. + zbuoy * zdz0) + zdrodz0,
                             0.0, 1e-3)
    oentr_base = torch.where(deep & (zbuoy > 0.), oentr_base, 0.0)
    oentr = torch.where(karr == base_m1[None], oentr_base[None], 0.0)

    # mid-level onset bounds (:2116-2127); leveltop per column
    leveltop = torch.clamp(_last_near(paph * 0.01, 250.0, KLEV, KLEV - 2),
                           max=KLEV - 15)
    levelbot = KLEV - 2 - 4

    # loop invariants (ictop0 and khmin do not change inside the loop)
    paph_top = _lev(paph, ictop0)
    ikt_geoh = _lev(geoh, ictop0)
    ikh_geoh = _lev(geoh, torch.clamp(khmin, min=0))
    iklwmin = torch.maximum(klwmin, ictop0 + 2)
    ztmzk = -(ikh_geoh - ikt_geoh) * ZRG
    ztmzk_safe = torch.where(ztmzk == 0, 1.0, ztmzk)
    zpbase = _lev(paph, kcbot)
    ldcum_next = torch.zeros(shape2, dtype=torch.bool, device=dev)

    for jk in range(KLEV - 2, 0, -1):
        # CUBASMC mid-level onset (:3087-3164)
        mid = (~ldcum) & (klab[jk + 1] == 0) \
            & (qen[jk] > 0.80 * qsen[jk]) \
            & (jk < levelbot) & (jk > leveltop)
        ptu_jk1 = torch.where(mid, (CPD * ten[jk] + geo[jk]
                                    - geoh[jk + 1]) * RCPD, ptu[jk + 1])
        pqu_jk1 = torch.where(mid, qen[jk], pqu[jk + 1])
        plu_jk1 = torch.where(mid, 0.0, plu[jk + 1])
        zzzmb = torch.clamp(-verv[jk] * inv(G), CMFCMIN, CMFCMAX)
        zmfub = torch.where(mid, zzzmb, zmfub)
        pmfu_jk1 = torch.where(mid, zmfub, pmfu[jk + 1])
        mfus_jk1 = torch.where(mid, zmfub * (CPD * ptu_jk1 + geoh[jk + 1]),
                               zmfus[jk + 1])
        mfuq_jk1 = torch.where(mid, zmfub * pqu_jk1, zmfuq[jk + 1])
        mful_jk1 = torch.where(mid, 0.0, zmful[jk + 1])
        dmfup_jk1 = torch.where(mid, 0.0, zdmfup[jk + 1])
        kcbot = torch.where(mid, jk, kcbot)
        zpbase = torch.where(mid, paph[jk], zpbase)
        klab_jk1 = torch.where(mid, 1, klab[jk + 1])
        ktype = torch.where(mid, 3, ktype)
        zentr = torch.where(mid, ENTRMID, zentr)

        loflag = klab_jk1 > 0
        klab_jk = torch.where(klab_jk1 == 0, 0, klab[jk])
        # ktype=3 cloud-base mass-flux cap
        cap = (ktype == 3) & (kcbot == jk)
        zmfmax = (paph[jk] - paph[jk - 1]) * zcons2
        over = cap & (zmfub > zmfmax)
        zfac_c = torch.where(over, zmfmax / torch.clamp(zmfub, min=1e-20),
                             1.0)
        pmfu_jk1 = pmfu_jk1 * zfac_c
        mfus_jk1 = mfus_jk1 * zfac_c
        mfuq_jk1 = mfuq_jk1 * zfac_c
        zmfub = torch.where(over, zmfmax, zmfub)

        # CUENTR_NEW (:3331-3443), orgen/nturben = 1
        zrrho = (RD * tenh[jk + 1]) / paph[jk + 1]
        zdprho = (paph[jk + 1] - paph[jk]) * ZRG
        zpmid = 0.5 * (zpbase + paph_top)
        zentr_k = zentr * pmfu_jk1 * zdprho * zrrho
        llo1 = (jk < kcbot) & ldcum
        zdmfde = torch.where(llo1, zentr_k, 0.0)
        llo2_s = llo1 & (ktype == 2) \
            & (((zpbase - paph[jk]) < ZDNOPRC) | (paph[jk] > zpmid))
        zdmfen = torch.where(llo2_s, zentr_k, 0.0)
        llo2_m = llo1 & (ktype == 3) & ((jk >= iklwmin) | (pap[jk] > zpmid))
        zdmfen = torch.where(llo2_m, zentr_k, zdmfen)
        llo2_d = llo1 & (ktype == 1)
        zdmfen = torch.where(llo2_d, zentr_k, zdmfen)
        od_on = llo2_d & (jk <= khmin) & (jk >= ictop0)
        zzmzk = -(ikh_geoh - geoh[jk]) * ZRG
        valid = od_on & (khmin > ictop0)
        arg = 3.1415 * (zzmzk / ztmzk_safe) * 0.5
        zorgde = torch.tan(arg) * 3.1415 * 0.5 / ztmzk_safe
        zdprho2 = (paph[jk + 1] - paph[jk]) * (ZRG * zrrho)
        odetr_k = torch.where(valid, torch.clamp(zorgde, max=1e-3)
                              * pmfu_jk1 * zdprho2, 0.0)

        # the ascent (:2160-2260)
        in_cloud = jk < kcbot
        zmftest = pmfu_jk1 + zdmfen - zdmfde
        zmfmax2 = torch.minimum(zmftest, (paph[jk] - paph[jk - 1]) * zcons2)
        zdmfen = torch.where(
            loflag & in_cloud,
            torch.clamp(zdmfen - torch.clamp(zmftest - zmfmax2, min=0.),
                        min=0.), zdmfen)
        zdmfde = torch.minimum(zdmfde, 0.75 * pmfu_jk1)
        pmfu_k = pmfu_jk1 + zdmfen - zdmfde
        zdprho3 = (geoh[jk] - geoh[jk + 1]) * ZRG
        oentr_k = oentr[jk] * zdprho3 * pmfu_jk1
        zmftest2 = pmfu_k + oentr_k - odetr_k
        zmfmax3 = torch.minimum(zmftest2,
                                (paph[jk] - paph[jk - 1]) * zcons2)
        oentr_k = torch.where(
            loflag & in_cloud,
            torch.clamp(oentr_k - torch.clamp(zmftest2 - zmfmax3, min=0.),
                        min=0.),
            torch.where(loflag, oentr_k, 0.0))
        lim = loflag & (ktype == 1) & in_cloud & (jk <= khmin)
        zmse = CPD * ptu_jk1 + ALV * pqu_jk1 + geoh[jk + 1]
        znevn = (ikt_geoh - geoh[jk + 1]) * (zmse - zhhatt[jk + 1]) * ZRG
        znevn = torch.where(znevn <= 0., 1.0, znevn)
        zodmax = torch.clamp(((zhcbase - zmse) / znevn) * zdprho3
                             * pmfu_jk1, min=0.0)
        odetr_k = torch.where(lim, torch.minimum(odetr_k, zodmax), odetr_k)
        odetr_k = torch.minimum(odetr_k, 0.75 * pmfu_k)
        pmfu_k = pmfu_k + oentr_k - odetr_k

        qenh_jk1 = qenh[jk + 1]
        tenh_jk1 = tenh[jk + 1]
        geoh_jk1 = geoh[jk + 1]
        qsenh_jk1 = qsenh[jk + 1]
        zqeen = qenh_jk1 * (zdmfen + oentr_k)
        zseen = (CPD * tenh_jk1 + geoh_jk1) * (zdmfen + oentr_k)
        zscde = (CPD * ptu_jk1 + geoh_jk1) * zdmfde
        zga = ALV * qsenh_jk1 / (RV * (tenh_jk1 * tenh_jk1))
        zdt = (plu_jk1 - 0.608 * (qsenh_jk1 - qenh_jk1)) \
            / (1. / tenh_jk1 + 0.608 * zga)
        zscod = CPD * tenh_jk1 + geoh_jk1 + CPD * zdt
        zscde = zscde + odetr_k * zscod
        zqude = pqu_jk1 * zdmfde + odetr_k * (qsenh_jk1 + zga * zdt)
        plude_k = plu_jk1 * (zdmfde + odetr_k)
        zmfusk = mfus_jk1 + zseen - zscde
        zmfuqk = mfuq_jk1 + zqeen - zqude
        zmfulk = mful_jk1 - plude_k
        denom = 1.0 / torch.clamp(pmfu_k, min=CMFCMIN)
        plu_k = torch.where(loflag, zmfulk * denom, plu[jk])
        pqu_k = torch.where(loflag, zmfuqk * denom, pqu[jk])
        ptu_k = torch.where(loflag,
                            torch.clamp((zmfusk * denom - geoh[jk]) * RCPD,
                                        100., 400.), ptu[jk])
        pmfu_k = torch.where(loflag, pmfu_k, pmfu[jk])
        plude_k = torch.where(loflag, plude_k, plude[jk])
        zqold = pqu_k

        ptu_k, pqu_k = cuadjtq(ptu_k, pqu_k, paph[jk], loflag, 1)

        condensed = loflag & (pqu_k != zqold)
        klab_jk = torch.where(condensed, 2, klab_jk)
        plu_k = torch.where(condensed, plu_k + zqold - pqu_k, plu_k)
        zbuo = ptu_k * (1. + VTMPC1 * pqu_k - plu_k) \
            - tenh[jk] * (1. + VTMPC1 * qenh[jk])
        zbuo = torch.where(klab_jk1 == 1, zbuo + ZBUO0, zbuo)
        grows = condensed & (zbuo > 0.) & (pmfu_k > 0.01 * zmfub) \
            & (jk >= ictop0)
        kctop = torch.where(grows, jk, kctop)
        ldcum_next = ldcum_next | grows
        zprcon = torch.where(zpbase - paph[jk] >= ZDNOPRC, CPRCON, 0.0)
        zlnew = plu_k / (1. + zprcon * (geoh[jk] - geoh_jk1))
        dmfup_k = torch.where(grows,
                              torch.clamp((plu_k - zlnew) * pmfu_k, min=0.),
                              0.0)
        plu_k = torch.where(grows, zlnew, plu_k)
        killed = condensed & ~grows
        klab_jk = torch.where(killed, 0, klab_jk)
        pmfu_k = torch.where(killed, 0.0, pmfu_k)

        mful_k = torch.where(loflag, plu_k * pmfu_k, zmful[jk])
        mfus_k = torch.where(loflag, (CPD * ptu_k + geoh[jk]) * pmfu_k,
                             zmfus[jk])
        mfuq_k = torch.where(loflag, pqu_k * pmfu_k, zmfuq[jk])

        # organized entrainment of the next level up (orgen=1)
        act = loflag & (ktype == 1)
        zbuoyz = G * ((ptu_k - tenh[jk]) / tenh[jk]
                      + 0.608 * (pqu_k - qenh[jk]) - plu_k)
        zbuoyz = torch.clamp(zbuoyz, min=0.0)
        zdzl = (geo[jk - 1] - geo[jk]) * ZRG
        zdrodzl = -torch.log(ten[jk - 1] / ten[jk]) \
            / torch.where(zdzl == 0, 1., zdzl) - G / (RD * tenh[jk])
        zbuoy = torch.where(act, zbuoy + zbuoyz * zdzl, zbuoy)
        oentr_next = torch.clamp(zbuoyz * 0.5 / (1. + zbuoy) + zdrodzl,
                                 0.0, 1e-3)
        oentr[jk - 1] = torch.where(act, oentr_next, oentr[jk - 1])

        # the rows this level updated
        ptu[jk] = ptu_k
        ptu[jk + 1] = ptu_jk1
        pqu[jk] = pqu_k
        pqu[jk + 1] = pqu_jk1
        plu[jk] = plu_k
        plu[jk + 1] = plu_jk1
        pmfu[jk] = pmfu_k
        pmfu[jk + 1] = pmfu_jk1
        zmfus[jk] = mfus_k
        zmfus[jk + 1] = mfus_jk1
        zmfuq[jk] = mfuq_k
        zmfuq[jk + 1] = mfuq_jk1
        zmful[jk] = mful_k
        zmful[jk + 1] = mful_jk1
        plude[jk] = plude_k
        zdmfup[jk] = dmfup_k
        zdmfup[jk + 1] = dmfup_jk1
        odetr[jk] = odetr_k
        klab[jk] = klab_jk
        klab[jk + 1] = klab_jk1

    # ---- fluxes above the non-buoyancy level (:2335-2375) --------------
    ldcum = ldcum_next & ~(kctop == KLEV - 2)
    kcbot = torch.maximum(kcbot, kctop)
    topm1 = torch.clamp(kctop - 1, min=0)
    topm2 = torch.clamp(kctop - 2, min=0)
    mfu_top = _lev(pmfu, kctop)
    zdmfde_t = (1.0 - CMFCTOP) * mfu_top
    plu_top = _lev(plu, kctop)
    mfu_new = mfu_top - zdmfde_t
    ptu_m1 = _lev(ptu, topm1)
    pqu_m1 = _lev(pqu, topm1)
    plu_m1 = _lev(plu, topm1)
    mful_new = plu_m1 * mfu_new
    at_m1 = (karr == topm1[None]) & ldcum[None]
    geoh_m1 = _lev(geoh, topm1)
    pmfu = torch.where(at_m1, mfu_new[None], pmfu)
    zmfus = torch.where(at_m1, ((CPD * ptu_m1 + geoh_m1) * mfu_new)[None],
                        zmfus)
    zmfuq = torch.where(at_m1, (pqu_m1 * mfu_new)[None], zmfuq)
    zmful = torch.where(at_m1, mful_new[None], zmful)
    zdmfup = torch.where(at_m1, 0.0, zdmfup)
    plude = torch.where(at_m1, (zdmfde_t * plu_top)[None], plude)
    at_m2 = (karr == topm2[None]) & ldcum[None] & (topm2 != topm1)[None]
    plude = torch.where(at_m2, mful_new[None], plude)
    at_edge = at_m1 & (topm1 == 0)[None]
    plude = torch.where(at_edge, mful_new[None], plude)
    return (ldcum, ktype, kcbot, kctop, ptu, pqu, plu, pmfu, zmfus,
            zmfuq, zmful, plude, zdmfup, klab)


def cudlfs_cuddraf(tenh, qenh, geoh, paph, ptu, pqu, ldcum, kcbot,
                   kctop, zmfub, zrfl_in):
    """Downdraft LFS detection and moist descent (CUDLFS :2388-2524 and
    CUDDRAF :2531-2664)."""
    KLEV = tenh.shape[0]
    shape2 = tenh.shape[1:]
    dev = tenh.device
    zero2 = torch.zeros(shape2, dtype=tenh.dtype, device=dev)
    lddraf = torch.zeros(shape2, dtype=torch.bool, device=dev)
    kdtop = torch.full(shape2, KLEV, dtype=torch.long, device=dev)
    zrfl = zrfl_in

    ztd_r = list(tenh.unbind(0))
    zqd_r = list(qenh.unbind(0))
    pmfd_r = [zero2] * KLEV
    mfds_r = [zero2] * KLEV
    mfdq_r = [zero2] * KLEV
    dmfdp_r = [zero2] * KLEV

    # CUDLFS: scan from the cloud top down
    for jk in range(2, KLEV - 3):
        llo2 = ldcum & (zrfl > 0.) & ~lddraf & (jk < kcbot) & (jk > kctop)
        ztenwb, zqenwb = cuadjtq(tenh[jk], qenh[jk], paph[jk], llo2, 2)
        zttest = 0.5 * (ptu[jk] + ztenwb)
        zqtest = 0.5 * (pqu[jk] + zqenwb)
        zbuo = zttest * (1. + VTMPC1 * zqtest) \
            - tenh[jk] * (1. + VTMPC1 * qenh[jk])
        zcond = qenh[jk] - zqenwb
        zmftop = -CMFDEPS * zmfub
        hit = llo2 & (zbuo < 0.) & (zrfl > 10. * zmftop * zcond)
        kdtop = torch.where(hit, jk, kdtop)
        lddraf = lddraf | hit
        ztd_r[jk] = torch.where(hit, zttest, ztd_r[jk])
        zqd_r[jk] = torch.where(hit, zqtest, zqd_r[jk])
        pmfd_r[jk] = torch.where(hit, zmftop, pmfd_r[jk])
        mfds_r[jk] = torch.where(hit, zmftop * (CPD * zttest + geoh[jk]),
                                 mfds_r[jk])
        mfdq_r[jk] = torch.where(hit, zmftop * zqtest, mfdq_r[jk])
        dp = -0.5 * zmftop * zcond
        dmfdp_r[jk - 1] = torch.where(hit, dp, dmfdp_r[jk - 1])
        zrfl = zrfl + torch.where(hit, dp, 0.0)

    # CUDDRAF: the moist descent
    itopde = KLEV - 3   # 1-based KLEV-2
    for jk in range(2, KLEV):
        llo2 = lddraf & (pmfd_r[jk - 1] < 0.)
        zentr = ENTRDD * pmfd_r[jk - 1] * RD * tenh[jk - 1] \
            / (G * paph[jk - 1]) * (paph[jk] - paph[jk - 1])
        zdmfen = zentr
        zdmfde = zentr
        if jk > itopde:
            zdmfen = torch.zeros_like(zentr)
            zdmfde = pmfd_r[itopde] * (paph[jk] - paph[jk - 1]) \
                / (paph[KLEV] - paph[itopde])
        pmfd_k = pmfd_r[jk - 1] + zdmfen - zdmfde
        # entrain environment values, detrain downdraft values
        zseen = (CPD * tenh[jk - 1] + geoh[jk - 1]) * zdmfen
        zqeen = qenh[jk - 1] * zdmfen
        zsdde = (CPD * ztd_r[jk - 1] + geoh[jk - 1]) * zdmfde
        zqdde = zqd_r[jk - 1] * zdmfde
        zmfdsk = mfds_r[jk - 1] + zseen - zsdde
        zmfdqk = mfdq_r[jk - 1] + zqeen - zqdde
        denom = 1.0 / torch.clamp(pmfd_k, max=-CMFCMIN)
        zqd_k = zmfdqk * denom
        ztd_k = torch.clamp((zmfdsk * denom - geoh[jk]) * RCPD, 100., 400.)
        zqd_k = torch.where(llo2, zqd_k, zqd_r[jk])
        ztd_k = torch.where(llo2, ztd_k, ztd_r[jk])
        pmfd_k = torch.where(llo2, pmfd_k, pmfd_r[jk])
        zcond = zqd_k
        ztd_k, zqd_k = cuadjtq(ztd_k, zqd_k, paph[jk], llo2, 2)
        zcond = torch.where(llo2, zcond - zqd_k, 0.0)
        zbuo = ztd_k * (1. + VTMPC1 * zqd_k) \
            - tenh[jk] * (1. + VTMPC1 * qenh[jk])
        kill = llo2 & ((zbuo >= 0.) | (zrfl <= (pmfd_k * zcond)))
        pmfd_k = torch.where(kill, 0.0, pmfd_k)
        mfds_k = torch.where(llo2, (CPD * ztd_k + geoh[jk]) * pmfd_k,
                             mfds_r[jk])
        mfdq_k = torch.where(llo2, zqd_k * pmfd_k, mfdq_r[jk])
        zdmfdp = torch.where(llo2, -pmfd_k * zcond, 0.0)
        dmfdp_r[jk - 1] = torch.where(llo2, zdmfdp, dmfdp_r[jk - 1])
        zrfl = zrfl + zdmfdp
        ztd_r[jk] = ztd_k
        zqd_r[jk] = zqd_k
        pmfd_r[jk] = pmfd_k
        mfds_r[jk] = mfds_k
        mfdq_r[jk] = mfdq_k

    return (torch.stack(ztd_r), torch.stack(zqd_r), torch.stack(pmfd_r),
            torch.stack(mfds_r), torch.stack(mfdq_r), torch.stack(dmfdp_r),
            kdtop, lddraf)


def cuflx(qen, qsen, tenh, qenh, paph, geoh, kcbot, kctop, kdtop,
          ktype, lddraf, ldcum, pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq,
          zmful, plude, zdmfup, zdmfdp, ten, dt, sig1):
    """The final flux adjustments, melt and sub-cloud evaporation (CUFLX,
    cu_tiedtke.f90:2670-2860)."""
    KLEV = qen.shape[0]
    shape2 = qen.shape[1:]
    dev = qen.device
    zcons1 = CPD / (ALF * G * dt)
    zcons2 = 1.0 / (G * dt)
    zcucov = 0.05
    ztmelp2 = TMELT + 2.0
    karr = torch.arange(KLEV, device=dev)[:, None, None]

    lddraf = lddraf & ldcum & ~(kdtop < kctop)
    ktype = torch.where(~ldcum, 0, ktype)

    in_up = ldcum[None] & (karr >= (kctop - 1)[None])
    sref = CPD * tenh + geoh
    zmfus = torch.where(in_up, zmfus - pmfu * sref, 0.0)
    zmfuq = torch.where(in_up, zmfuq - pmfu * qenh, 0.0)
    in_dd = in_up & lddraf[None] & (karr >= kdtop[None])
    zmfds = torch.where(in_dd, zmfds - pmfd * sref, 0.0)
    zmfdq = torch.where(in_dd, zmfdq - pmfd * qenh, 0.0)
    pmfd = torch.where(in_dd, pmfd, 0.0)
    pmfu = torch.where(in_up, pmfu, 0.0)
    zmful = torch.where(in_up, zmful, 0.0)
    # the precipitation and detrainment sources outside the cloud column
    zdmfup = torch.where(in_up, zdmfup, 0.0)
    zdmfdp = torch.where(in_dd, zdmfdp, 0.0)
    plude = torch.where(in_up, plude, 0.0)

    # the linear decrease of the fluxes in the sub-cloud layer (:2782-2800)
    below = ldcum[None] & (karr > kcbot[None])
    paph_s = paph[KLEV]
    paph_b = _lev(paph, kcbot)
    zzp = (paph_s[None] - paph[:KLEV]) \
        / torch.clamp(paph_s - paph_b, min=1e-10)[None]
    zzp = torch.where((ktype == 3)[None], zzp * zzp, zzp)
    pmfu = torch.where(below, _lev(pmfu, kcbot)[None] * zzp, pmfu)
    zmfus = torch.where(below, _lev(zmfus, kcbot)[None] * zzp, zmfus)
    zmfuq = torch.where(below, _lev(zmfuq, kcbot)[None] * zzp, zmfuq)
    zmful = torch.where(below, _lev(zmful, kcbot)[None] * zzp, zmful)

    # the rain/snow split with snowmelt (:2802-2830), top down
    prain = pw.sum0(torch.where(ldcum[None], zdmfup, 0.0))
    prfl = torch.zeros(shape2, dtype=qen.dtype, device=dev)
    psfl = torch.zeros(shape2, dtype=qen.dtype, device=dev)
    zdpmel_r = []
    for jk in range(KLEV):
        act = ldcum
        warm = ten[jk] > TMELT
        src = zdmfup[jk] + zdmfdp[jk]
        melt_on = warm & (psfl > 0.) & (ten[jk] > ztmelp2)
        zfac = zcons1 * (paph[jk + 1] - paph[jk])
        zsnmlt = torch.where(act & melt_on,
                             torch.minimum(psfl, zfac * (ten[jk] - ztmelp2)),
                             0.0)
        zdpmel_r.append(zsnmlt)
        prfl = prfl + torch.where(act & warm, src + zsnmlt, 0.0)
        psfl = psfl + torch.where(act & warm, -zsnmlt,
                                  torch.where(act, src, 0.0))
    zdpmel = torch.stack(zdpmel_r)
    prfl = torch.clamp(prfl, min=0.0)
    psfl = torch.clamp(psfl, min=0.0)

    # sub-cloud evaporation of the precipitation (:2832-2858)
    zpsubcl = prfl + psfl
    for jk in range(KLEV):
        act = ldcum & (jk >= kcbot) & (zpsubcl > 1e-20)
        zrfl_l = zpsubcl
        cevapcu = CEVAPCU1 * torch.sqrt(CEVAPCU2 * torch.sqrt(sig1[jk]))
        zrnew = torch.clamp(torch.sqrt(zrfl_l * inv(zcucov))
                            - cevapcu * (paph[jk + 1] - paph[jk])
                            * torch.clamp(qsen[jk] - qen[jk], min=0.),
                            min=0.)
        zrnew = zrnew * zrnew * zcucov
        zrmin = zrfl_l - zcucov \
            * torch.clamp(0.8 * qsen[jk] - qen[jk], min=0.) * zcons2 \
            * (paph[jk + 1] - paph[jk])
        zrfln = torch.clamp(torch.maximum(zrnew, zrmin), min=0.0)
        zdrfl = torch.clamp(zrfln - zrfl_l, max=0.)
        zdmfup[jk] = zdmfup[jk] + torch.where(act, zdrfl, 0.0)
        zpsubcl = torch.where(act, zrfln, zpsubcl)
    zdpevap = zpsubcl - (prfl + psfl)
    tot = torch.clamp(prfl + psfl, min=1e-20)
    prfl = prfl + zdpevap * prfl / tot
    psfl = psfl + zdpevap * psfl / tot

    return (pmfu, pmfd, zmfus, zmfds, zmfuq, zmfdq, zmful, plude,
            zdmfup, zdmfdp, prfl, psfl, zdpmel, prain, ldcum, ktype)


def cudtdq(paph, ldcum, ten, zmfus, zmfds, zmfuq, zmfdq, zmful, zdmfup,
           zdmfdp, zdpmel, qen, qsen, plude):
    """The T/q tendencies from the flux divergence (CUDTDQ,
    cu_tiedtke.f90:2862-2975). Returns (tte, qte, cte)."""
    KLEV = ten.shape[0]
    zalv = torch.where(ten > TMELT, ALV, ALS)
    rhk = torch.clamp(qen / qsen, max=1.0)
    rhcoe = torch.clamp((rhk - RHC) * inv(RHM - RHC), min=0.0)
    pldfd = torch.clamp(rhcoe * FDBK * plude, min=0.0)
    dp = paph[1:] - paph[:-1]
    godp = G / dp

    def above(f):
        return torch.cat([f[1:], torch.zeros_like(f[:1])], 0)
    # interior levels take flux differences, the lowest level the fluxes
    mfus1, mfds1, mfuq1, mfdq1, mful1 = (above(f) for f in (
        zmfus, zmfds, zmfuq, zmfdq, zmful))
    interior = (torch.arange(KLEV, device=ten.device)
                < (KLEV - 1))[:, None, None]
    dtdt_i = godp * RCPD * (mfus1 - zmfus + mfds1 - zmfds
                            - ALF * zdpmel
                            - zalv * (mful1 - zmful - pldfd
                                      - (zdmfup + zdmfdp)))
    dqdt_i = godp * (mfuq1 - zmfuq + mfdq1 - zmfdq + mful1 - zmful
                     - pldfd - (zdmfup + zdmfdp))
    dtdt_b = -godp * RCPD * (zmfus + zmfds + ALF * zdpmel
                             - zalv * (zmful + zdmfup + zdmfdp + pldfd))
    dqdt_b = -godp * (zmfuq + zmfdq + pldfd
                      + (zmful + zdmfup + zdmfdp))
    on = ldcum[None]
    tte = torch.where(on, torch.where(interior, dtdt_i, dtdt_b), 0.0)
    qte = torch.where(on, torch.where(interior, dqdt_i, dqdt_b), 0.0)
    cte = torch.where(on, godp * pldfd, 0.0)
    return tte, qte, cte


def tiedtke(u, v, w_if, t, qv, qc, qi, exner, rho, qv_tend_adv,
            qv_tend_pbl, p, p_i, dz, qfx, hfx, xland, dt):
    """One Tiedtke step on the model's (z, y, x) bottom-up arrays
    (CU_TIEDTKE + TIECNV, cu_tiedtke.f90:148-711). ``w_if`` is the real
    vertical velocity at the nz+1 layer interfaces, ``p_i`` the nz+1
    interface pressures. Returns (th_new, qv_new, qc_new, qi_new,
    rain_delta_mm)."""
    nz = t.shape[0]
    # omega at the mass levels
    omg_mass = -0.5 * G * rho * (w_if[:-1] + w_if[1:])
    # mid-layer heights
    zi = torch.cat([torch.zeros_like(dz[:1]), torch.cumsum(dz, 0)], 0)
    zl = 0.5 * (zi[:-1] + zi[1:])

    def flip(a):
        return torch.flip(a, [0])
    ten = flip(t)
    qen_mr = flip(qv)
    pap = flip(p)
    paph = flip(p_i)                  # (nz+1, ...) index 0 the top
    geo = flip(zl) * G
    verv = flip(omg_mass)
    uen = flip(u)
    ven = flip(v)
    qte = flip(qv_tend_adv + qv_tend_pbl)   # mixing ratios, as ICAR passes

    # specific humidity (TIECNV :640-662)
    qen = qen_mr / (1.0 + qen_mr)
    qsen = _qsat(ten, pap)
    lndj = torch.where(xland == 1.0, 1, 0)
    sig1 = pap / paph[nz][None]

    tte, qte_add, cte, rsfc, ssfc, ldcum = cumastr(
        ten, qen, uen, ven, verv, qsen, qfx, dt, pap, paph, geo, qte,
        lndj, sig1)

    # the split of detrained cloud water and ice (TIECNV :676-700)
    ztpp1 = ten + tte * dt
    ztc = ztpp1 - T000
    fliq = torch.where(ztpp1 >= T000, 1.0,
                       torch.where(ztpp1 <= HGFR, 0.0,
                                   0.0059 + 0.9941
                                   * torch.exp(-0.003102 * ztc * ztc)))
    zalf = torch.where(ztpp1 >= T000, 0.0, ALF)
    has_cte = cte > 0.0
    qc_f = flip(qc) + torch.where(has_cte, fliq * cte * dt, 0.0)
    qi_f = flip(qi) + torch.where(has_cte, (1. - fliq) * cte * dt, 0.0)
    tte = tte - torch.where(has_cte, zalf * RCPD * fliq * cte, 0.0)

    t_new = ten + tte * dt
    qsp1 = qen + qte_add * dt
    qv_new_mr = qsp1 / (1.0 - qsp1)
    rain = torch.clamp((rsfc + ssfc) * dt, min=0.0)

    th_new = flip(t_new) / exner
    return th_new, flip(qv_new_mr), flip(qc_f), flip(qi_f), rain

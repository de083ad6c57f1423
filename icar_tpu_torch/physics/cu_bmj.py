"""Betts-Miller-Janjic (BMJ) cumulus convection (icar_tpu/physics/
cu_bmj.py, the reference's cu_bmj.f90): the Janjic (1994, 2000)
convective adjustment. Deep convection relaxes T and q toward reference
profiles anchored at cloud base, whose moisture deficit follows a
prognostic cloud efficiency (CLDEFI), with an enthalpy correction that
makes the adjustment precipitate the column's enthalpy surplus; shallow
convection is a mixing-line adjustment with no net column heating.

The scheme works top-down (index 0 the model top), so ``bmj`` flips the
model's bottom-up arrays at entry and turns specific humidity back into a
mixing ratio on exit. Over the (ny, nx) columns at once: each of the JAX
package's ``fori_loop`` level recurrences is a Python loop over the
levels, whose level index is the same for every column (a per-column
start or stop is a mask), so a level is one row of the profiles. The
search for the most unstable parcel walks its source levels bottom-up,
and for each runs the CAPE integral only over the levels above it (the
JAX loop's trips below the model top change nothing). The saturation-
point and moist-adiabat tables (``bmj_tables.py``, built once on the
host) are uploaded once per device (``device_tables``); their lookups
floor float32 positions with the Fortran's edge clamping, in the JAX
package's arithmetic. Divisions by a constant are products with its
float32 reciprocal (``pointwise.inv``), a constant over a field one
division; ``dt`` is a 0-d float32 tensor (a number in the tests). Plain
PyTorch, no read back to the host.
"""

from __future__ import annotations

import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level as _lev
from ..ops.pointwise import inv
from .bmj_tables import (A2, A3, A4, CAPA, ELOCP, ITB, ITBQ, JTB, JTBQ,
                         PL, PLQ, PQ0, RDP, RDPQ, RDQ, RDTH, RDTHE, RDTHEQ,
                         THL, get_tables)
from .cu_nsas import _nz, _where0
from .mp_thompson import _rd

CP = 1004.6
RD = 287.0
G = 9.81
ELWV = 2.5e6
ROW = 1.0e3
RCP = 1.0 / CP
CPRLG = CP / (ROW * G * ELWV)

# scheme parameters (cu_bmj.f90:15-47)
DSPC = -3000.0
DTTOP = 0.0
EFIFC = 5.0
EFIMN = 0.20
EFMNT = 0.70
EPSDN = 1.05
EPSDT = 0.0
EPSNTP = 1e-4
EPSPR = 1e-7
FR = 1.0
FSL = 0.85
FSS = 0.85
PBM = 13000.0
PFRZ = 15000.0
PNO = 1000.0
PONE = 2500.0
PQM = 20000.0
PSH = 20000.0
PSHU = 45000.0
RHLSC = 0.0
RHHSC = 1.10
STABDF = 0.90
STABDS = 0.90
STABS = 1.0
DTSHAL = -1.0
TREL = 2400.0
RSFCP = 1.0 / 101300.0
AVGEFI = (EFIMN + 1.0) * 0.5
TFRZ = 273.15
EPSQ = 1e-12
ITREFI_MAX = 3

DSPBFL = -3875.0 * FR
DSP0FL = -5875.0 * FR
DSPTFL = -1875.0 * FR
DSPBFS, DSP0FS, DSPTFS = -3875.0, -5875.0, -1875.0
DSPBSL, DSP0SL, DSPTSL = DSPBFL * FSL, DSP0FL * FSL, DSPTFL * FSL
DSPBSS, DSP0SS, DSPTSS = DSPBFS * FSS, DSP0FS * FSS, DSPTFS * FSS
ELEVFC = 0.6
STEFI = 1.0
SLOPBL = (DSPBFL - DSPBSL) / (1.0 - EFIMN)
SLOP0L = (DSP0FL - DSP0SL) / (1.0 - EFIMN)
SLOPTL = (DSPTFL - DSPTSL) / (1.0 - EFIMN)
SLOPBS = (DSPBFS - DSPBSS) / (1.0 - EFIMN)
SLOP0S = (DSP0FS - DSP0SS) / (1.0 - EFIMN)
SLOPTS = (DSPTFS - DSPTSS) / (1.0 - EFIMN)
SLOPST = (STABDF - STABDS) / (1.0 - EFIMN)
SLOPE = (1.0 - EFMNT) / (1.0 - EFIMN)
A23M4L = A2 * (A3 - A4) * ELWV

# the tables on a device: (id of the host tables, device) -> (host, device)
_DEVICE_TABLES = {}


def device_tables(dev):
    """``bmj_tables.get_tables()`` as float32 tensors on ``dev``, uploaded
    once per table set and device."""
    tables = get_tables()
    key = (id(tables), str(torch.device(dev)))
    if key not in _DEVICE_TABLES or _DEVICE_TABLES[key][0] is not tables:
        _DEVICE_TABLES[key] = (tables, {
            k: torch.as_tensor(v, device=dev) for k, v in tables.items()})
    return _DEVICE_TABLES[key][1]


def _qs(t, p):
    return _rd(PQ0, p) * torch.exp(A2 * (t - A3) / (t - A4))


def _floor_index(x, n):
    """``jnp.clip(jnp.floor(x).astype(int32), 0, n - 2)`` as an int64
    index: the clamp in float, so that an infinite position saturates and
    NaN gives 0, as XLA converts (the card and the CPU alike)."""
    f = torch.clamp(torch.floor(x), 0.0, float(n - 2))
    return torch.nan_to_num(f, nan=0.0).long()


def _frac(x, i, n):
    """The position's fraction past its cell ``i``, 0 outside the table
    (``_interp1``'s clip and edge test)."""
    frac = torch.clamp(x - i.to(x.dtype), min=0.0)
    return torch.where((x < 0.0) | (x >= n - 1), torch.zeros_like(frac),
                       frac)


def _interp1(base, idx_f, n):
    """Linear 1-D table lookup with Fortran-style edge clamping: idx_f is
    the real-valued 0-based position."""
    i0 = _floor_index(idx_f, n)
    return base[i0], base[i0 + 1], _frac(idx_f, i0, n), i0


def _ptbl_lookup(thbt, qbt, tables):
    """Saturation-point pressure from PTBL (cu_bmj.f90:565-608)."""
    tables = tables if torch.is_tensor(tables["ptbl"]) \
        else device_tables(thbt.device)
    ptbl = tables["ptbl"]
    tth = (thbt - THL) * RDTH
    b0, b1, qq1, it = _interp1(tables["qs0"], tth, JTB)
    s0, s1, _, _ = _interp1(tables["sqs"], tth, JTB)
    bq = (b1 - b0) * qq1 + b0
    sq = (s1 - s0) * qq1 + s0
    tq = (qbt - bq) / sq * RDQ
    iq = _floor_index(tq, ITB)
    pp1 = _frac(tq, iq, ITB)
    p00 = ptbl[iq, it]
    p10 = ptbl[iq + 1, it]
    p01 = ptbl[iq, it + 1]
    p11 = ptbl[iq + 1, it + 1]
    return p00 + (p10 - p00) * pp1 + (p01 - p00) * qq1 \
        + (p00 - p10 - p01 + p11) * pp1 * qq1


def _ttblex(p, thesp, tables):
    """Moist-adiabat temperature from the coarse or fine theta_e table
    (TTBLEX, cu_bmj.f90:1737-1820), blended on p < PLQ."""
    tables = tables if torch.is_tensor(tables["ttbl"]) \
        else device_tables(p.device)

    def one(plx, rdpx, rdthex, the0, sthe, ttbl, nI, nJ):
        tpk = (p - plx) * rdpx
        ip = _floor_index(tpk, nI)
        qq = _frac(tpk, ip, nI)
        bth = (the0[ip + 1] - the0[ip]) * qq + the0[ip]
        sth = (sthe[ip + 1] - sthe[ip]) * qq + sthe[ip]
        tth = (thesp - bth) / sth * rdthex
        ith = _floor_index(tth, nJ)
        pp = _frac(tth, ith, nJ)
        t00 = ttbl[ith, ip]
        t10 = ttbl[ith + 1, ip]
        t01 = ttbl[ith, ip + 1]
        t11 = ttbl[ith + 1, ip + 1]
        return t00 + (t10 - t00) * pp + (t01 - t00) * qq \
            + (t00 - t10 - t01 + t11) * pp * qq

    t_coarse = one(PL, RDP, RDTHE, tables["the0"], tables["sthe"],
                   tables["ttbl"], ITB, JTB)
    t_fine = one(PLQ, RDPQ, RDTHEQ, tables["the0q"], tables["stheq"],
                 tables["ttblq"], ITBQ, JTBQ)
    return torch.where(p < PLQ, t_coarse, t_fine)


def _bmj_column(dtcnvc, sm, cldefi, dprs, p, q, t, psfc, tables):
    """The BMJ adjustment (cu_bmj.f90:393-1731) over (ny, nx) columns.
    Arrays are TOP-DOWN (index 0 = model top); q is specific humidity.
    Returns (dtdt, dqdt, pcpcol[m], cldefi)."""
    tables = tables if torch.is_tensor(tables["ptbl"]) \
        else device_tables(t.device)
    KLEV = t.shape[0]
    LMH = KLEV - 1                   # lowest layer index (sigma mode)
    shape2 = t.shape[1:]
    dev = t.device
    karr = torch.arange(KLEV, device=dev)[:, None, None]
    zero2 = torch.zeros(shape2, dtype=t.dtype, device=dev)
    zero3 = torch.zeros_like(t)
    true2 = torch.ones(shape2, dtype=torch.bool, device=dev)
    tauk = dtcnvc * inv(TREL)
    tauksc = tauk
    rdtcnvc = 1.0 / dtcnvc
    depmin = PSH * psfc * RSFCP
    sm1 = 1.0 - sm

    ape = pw.pow(_rd(1.0e5, p), CAPA)
    plmh = p[LMH]
    pelevfc = plmh * ELEVFC
    pbtmx = plmh - PONE
    tv_env = t * (q * 0.608 + 1.0)

    # ---- search over trial parcel levels for maximum instability -------
    # (max_buoy_loop, cu_bmj.f90:556-882); the source level kb is the same
    # for every column in each trip
    def parcel_props(kb):
        qbt = q[kb]
        thbt = t[kb] * ape[kb]
        psp = _ptbl_lookup(thbt, qbt, tables)
        apes = pw.pow(_rd(1.0e5, psp), CAPA)
        thesp = thbt * torch.exp(ELOCP * qbt * apes / thbt)
        # cloud base: level just below psp (and below PQM)
        cond = (p < psp) & (p >= PQM) & (karr < LMH)
        lbot0 = torch.amax(torch.where(cond, karr + 1, 0), dim=0)
        lbot0 = torch.where(torch.any(cond, dim=0), lbot0, LMH)
        pbot0 = _lev(p, lbot0)
        # keep base at least PONE above ground
        need_fix = (pbot0 >= pbtmx) | (lbot0 >= LMH)
        alt = torch.amax(torch.where((p < pbtmx[None]) & (karr < LMH),
                                     karr, 0), dim=0)
        lbot = torch.where(need_fix, alt, lbot0)
        pbot = _lev(p, lbot)
        return qbt, thbt, psp, apes, thesp, lbot, pbot

    def cape_profile(kb, qbt, thbt, psp, apes, thesp, lbot, pbot):
        """Entropy integral along the parcel path (cu_bmj.f90:718-860),
        from kb upward, stopping where the running integral drops below
        CAPEtrigr (0: DTtrigr = -0.0 in the reference)."""
        tup_cloud = _ttblex(p, thesp[None], tables)
        qup_cloud = _qs(tup_cloud, p)
        qwat = qbt[None] - qup_cloud
        # term above cloud base (in-cloud, moist adiabat w/ water loading)
        trm_cloud = (tup_cloud * (qup_cloud * 0.608 + 1.0 - qwat)
                     - tv_env) * 0.5 / tv_env
        # term below cloud base (dry parcel)
        tup_dry = thbt[None] / ape
        trm_dry = (tup_dry * (qbt[None] * 0.608 + 1.0) - tv_env) * 0.5 \
            / tv_env
        tup_b = thbt / apes
        p_lb1 = _lev(p, torch.clamp(lbot + 1, max=LMH))
        dtv_base = torch.where(p_lb1 == pbot, torch.ones_like(pbot),
                               p_lb1 - pbot)
        cpe = zero3.clone()
        dtv = zero3.clone()
        dentpy = zero2
        plo = p[kb]
        trmlo = zero2
        alive = true2
        # the JAX loop's trips past the model top (l < 0) change nothing
        for l in range(kb - 1, -1, -1):
            pup_mid = p[l]
            below = l > lbot
            at_base = l == lbot
            # at cloud base the parcel first rises dry to psp then moist
            # to the level's midpoint (two sub-segments)
            t_lp1 = t[min(l + 1, LMH)]
            q_lp1 = q[min(l + 1, LMH)]
            t_l = t[l]
            q_l = q[l]
            dpb = torch.where(plo == pbot, torch.ones_like(plo),
                              plo - pbot)
            tsp = (t_lp1 - t_l) / dpb * (psp - pbot) + t_l
            qsp = (q_lp1 - q_l) / dpb * (psp - pbot) + q_l
            tvsp = tsp * (qsp * 0.608 + 1.0)
            trm_b1 = (tup_b * (qbt * 0.608 + 1.0) - tvsp) * 0.5 / tvsp
            trm_cl = trm_cloud[l]
            trm_dr = trm_dry[l]

            # segment contributions
            dp_std = plo - pup_mid
            d_below = (trmlo + trm_dr) * dp_std
            # base: dry part (plo -> psp) + moist part (psp -> p(lbot))
            d_base = (trmlo + trm_b1) * (plo - psp) \
                + (trm_b1 + trm_cl) * (psp - pup_mid)
            d_above = (trmlo + trm_cl) * dp_std
            contrib = torch.where(below, d_below,
                                  torch.where(at_base, d_base, d_above))
            dentpy_new = torch.where(alive, dentpy + contrib, dentpy)
            dtv_l = torch.where(below, trmlo + trm_dr,
                                torch.where(at_base, d_base / dtv_base,
                                            trm_cl + trmlo))
            cpe[l] = torch.where(alive, dentpy_new, cpe[l])
            dtv[l] = torch.where(alive, dtv_l, dtv[l])
            trmlo = torch.where(alive, torch.where(below, trm_dr, trm_cl),
                                trmlo)
            plo = torch.where(alive, pup_mid, plo)
            alive = alive & ~(dentpy_new < 0.0)
            dentpy = dentpy_new
        # cloud top at CAPE maximum, stopping at first cpe < trigger
        cape = zero2
        ltp1 = torch.full(shape2, kb, dtype=torch.long, device=dev)
        flg = true2
        for l in range(kb, -1, -1):
            cl = cpe[l]
            stop = flg & (cl < 0.0)
            better = flg & ~stop & (cl > cape)
            cape = torch.where(better, cl, cape)
            ltp1 = torch.where(better, l, ltp1)
            flg = flg & ~stop
        ltop = torch.minimum(ltp1, lbot)
        return cpe, dtv, cape, ltop

    lmh_i = torch.full(shape2, LMH, dtype=torch.long, device=dev)
    capec, pspc, thbtc, thespc = zero2, zero2, zero2, zero2
    lbotc, ltopc = lmh_i, lmh_i
    cpec, dtvc = zero3, zero3
    for it in range(KLEV):
        kb = LMH - it
        active = p[kb] >= pelevfc
        qbt, thbt, psp, apes, thesp, lbot, pbot = parcel_props(kb)
        cpe, dtv, cape, ltop = cape_profile(kb, qbt, thbt, psp, apes,
                                            thesp, lbot, pbot)
        better = active & (cape > capec)
        capec = torch.where(better, cape, capec)
        pspc = torch.where(better, psp, pspc)
        thbtc = torch.where(better, thbt, thbtc)
        thespc = torch.where(better, thesp, thespc)
        lbotc = torch.where(better, lbot, lbotc)
        ltopc = torch.where(better, ltop, ltopc)
        cpec = torch.where(better[None], cpe, cpec)
        dtvc = torch.where(better[None], dtv, dtvc)
    cape, psp, thbt, lbot, ltop, cpe, dtv, thesp = (
        capec, pspc, thbtc, lbotc, ltopc, cpec, dtvc, thespc)

    pbot = _lev(p, lbot)
    ptop = _lev(p, ltop)

    # ---- no-convection exit (cu_bmj.f90:907-917) -----------------------
    no_cnv = (ptop > pbot - PNO) | (ltop > lbot - 2) | (cape <= 0.0)
    cldefi_nc = AVGEFI * sm + STEFI * sm1
    depth = pbot - ptop
    deep = ~no_cnv & (depth >= depmin)
    shallow0 = ~no_cnv & ~deep

    # ======================= DEEP CONVECTION ===========================
    tref = _ttblex(p, thesp[None], tables)
    therk = tref * ape
    efi = cldefi
    stabdl = (efi - EFIMN) * SLOPST + STABDS

    # reference T below freezing level: upward recurrence from lb-1
    # (cu_bmj.f90:996-1016); stops when T(l+1) < TFRZ
    t_lbot = _lev(t, lbot)
    ape_lbot = _lev(ape, lbot)
    therk_lbot = _lev(therk, lbot)
    trefk = t.clone()
    trefkx, apekxx, therkx, l0 = zero2, zero2 + 1.0, zero2, lbot
    stopped = torch.zeros(shape2, dtype=torch.bool, device=dev)
    for it in range(KLEV):
        l = LMH - 1 - it
        lc = max(l, 0)
        # seed carry at l = lbot-1
        seed = l == (lbot - 1)
        trefkx = torch.where(seed, t_lbot, trefkx)
        apekxx = torch.where(seed, ape_lbot, apekxx)
        therkx = torch.where(seed, therk_lbot, therkx)
        stopped = stopped & ~seed
        l0 = torch.where(seed, lbot, l0)
        in_range = (l <= lbot - 1) & (l >= ltop) & deep
        frz = t[min(lc + 1, LMH)] < TFRZ
        stopped = stopped | (in_range & frz)
        act = in_range & ~stopped
        therky = therk[lc]
        apekxy = ape[lc]
        newv = ((therky - therkx) * stabdl + trefkx * apekxx) / apekxy
        trefk[lc] = torch.where(act, newv, trefk[lc])
        trefkx = torch.where(act, newv, trefkx)
        apekxx = torch.where(act, apekxy, apekxx)
        therkx = torch.where(act, therky, therkx)
        l0 = torch.where(act, lc, l0)

    # above freezing level: linear-in-p theta-deficit profile
    # (cu_bmj.f90:1023-1031)
    pk0 = _lev(p, l0)
    pkt = ptop
    rdp0t = 1.0 / torch.where(pk0 == pkt, torch.ones_like(pk0), pk0 - pkt)
    dthem = _lev(therk, l0) - _lev(trefk, l0) * _lev(ape, l0)
    above_frz = (karr >= ltop[None]) & (karr < l0[None]) & deep[None]
    trefk = torch.where(above_frz,
                        (therk - (p - pkt[None]) * dthem[None]
                         * rdp0t[None]) / ape, trefk)

    depwl = pbot - pk0
    depth_frz = PFRZ * psfc * RSFCP

    # cloud-efficiency iteration (cu_bmj.f90:1064-1209)
    in_deep = (karr >= ltop[None]) & (karr <= lbot[None])
    # LQM: lowest level with p <= PQM
    lqm = torch.amax(torch.where((p <= PQM) & (karr <= lbot[None]), karr,
                                 0), dim=0)
    t_only = (karr > ltop[None]) & (karr <= lqm[None])
    t_and_q = (karr > torch.maximum(ltop, lqm)[None]) & (karr <= lbot[None])
    sumdp = pw.sum0(_where0(in_deep, dprs))
    ec_denom = _nz(sumdp - _lev(dprs, ltop))
    avrgt_den = 2.0 * _nz(sumdp)
    pbot_pk0 = torch.where(pbot == pk0, torch.ones_like(pbot), pbot - pk0)

    qrefk, preck, dentpy = q, zero2, zero2
    for _ in range(ITREFI_MAX):
        dspbk = ((efi - EFIMN) * SLOPBS + DSPBSS) * sm \
            + ((efi - EFIMN) * SLOPBL + DSPBSL) * sm1
        dsp0k = ((efi - EFIMN) * SLOP0S + DSP0SS) * sm \
            + ((efi - EFIMN) * SLOP0L + DSP0SL) * sm1
        dsptk = ((efi - EFIMN) * SLOPTS + DSPTSS) * sm \
            + ((efi - EFIMN) * SLOPTL + DSPTSL) * sm1
        # saturation-pressure departure profile
        upper = ((pk0[None] - p) * dsptk[None]
                 + (p - pkt[None]) * dsp0k[None]) * rdp0t[None]
        lower = ((pbot[None] - p) * dsp0k[None]
                 + (p - pk0[None]) * dspbk[None]) / pbot_pk0[None]
        below_l0 = karr < l0[None]
        dsp = torch.where(depwl[None] >= depth_frz[None],
                          torch.where(below_l0, upper, lower),
                          torch.where(below_l0, upper, dsp0k[None]))
        psk = p + dsp
        apesk = pw.pow(_rd(1.0e5, psk), CAPA)
        thsk = trefk * ape
        qref_new = _rd(PQ0, psk) * torch.exp(
            A2 * (thsk - A3 * apesk) / (thsk - A4 * apesk))
        qrefk = torch.where(in_deep & (p > PQM), qref_new, q)

        # enthalpy conservation (2 passes, cu_bmj.f90:1118-1157)
        for _ in range(2):
            sumde = pw.sum0(_where0(
                in_deep, ((t - trefk) * CP + (q - qrefk) * ELWV) * dprs))
            dd = (trefk * ape / apesk) - A4
            dhdt = pw.sum0(_where0(
                in_deep, (qrefk * A23M4L / (dd * dd) + CP) * dprs))
            hcorr = sumde / ec_denom
            dhdt = dhdt / ec_denom
            # above LQM: temperature only; below: T and q
            trefk = torch.where(t_only, trefk + hcorr[None] * RCP, trefk)
            trefk = torch.where(t_and_q, trefk + hcorr[None]
                                / _nz(dhdt)[None], trefk)
            thskl = trefk * ape
            qnew = _rd(PQ0, psk) * torch.exp(
                A2 * (thskl - A3 * apesk) / (thskl - A4 * apesk))
            qrefk = torch.where(t_and_q, qnew, qrefk)

        # heating / moistening / precipitation (cu_bmj.f90:1163-1196)
        diftl = (trefk - t) * tauk
        difql = (qrefk - q) * tauk
        avrgtl = t + t + diftl
        dpot = dprs / avrgtl
        dst = 2.0 * pw.sum0(_where0(in_deep, diftl * dpot)) * CP
        dsq = 2.0 * pw.sum0(_where0(in_deep, difql * ELWV * dpot))
        preck = pw.sum0(_where0(in_deep, diftl * dprs))
        avrgt_sum = pw.sum0(_where0(in_deep, avrgtl * dprs))
        avrgt = avrgt_sum / avrgt_den
        dentpy = dst + dsq
        drheat = (preck * sm + torch.clamp(preck, min=1e-7) * sm1) * CP \
            / _nz(avrgt)
        drheat = torch.clamp(drheat, min=1e-20)
        efi = torch.clamp(EFIFC * dentpy / drheat, EFIMN, 1.0)
    trefk_d, qrefk_d = trefk, qrefk

    deep_ok = deep & (dentpy >= EPSNTP) & (preck > EPSPR)
    fefi = EFMNT + SLOPE * (efi - EFIMN)
    fefi = (dentpy - EPSNTP) * fefi / _nz(dentpy)
    preck_eff = preck * fefi
    dtdt_deep = (trefk_d - t) * tauk * fefi[None] * rdtcnvc
    dqdt_deep = (qrefk_d - q) * tauk * fefi[None] * rdtcnvc
    pcp_deep = preck_eff * CPRLG

    # deep failure -> shallow with DTV-based cloud top
    # (cu_bmj.f90:1312-1330)
    ltp1_dtv, flg = lbot, true2
    for it in range(KLEV):
        l = lbot - 1 - it
        lc = torch.clamp(l, min=0)
        ok = flg & (l >= ltop) & (l >= 0)
        pos = _lev(dtv, lc) > 0.0
        ltp1_dtv = torch.where(ok & pos, lc, ltp1_dtv)
        flg = flg & ~(ok & ~pos)
    ltop_fail = torch.minimum(ltp1_dtv, lbot)

    deep_failed = deep & ~deep_ok
    shallow = shallow0 | deep_failed
    ltop_sh = torch.where(deep_failed, ltop_fail, ltop)
    cldefi_deepfail = EFIMN * sm + STEFI * sm1

    # ====================== SHALLOW CONVECTION =========================
    # (cu_bmj.f90:1379-1726)
    qsatk = _qs(t, p)
    thvref_env = t * ape * (q * 0.608 + 1.0)

    # raise cloud top if avg RH > RHSHmax and CAPE > 0
    tlev2 = t_lbot * pw.pow((pbot - PONE) / pbot, CAPA)
    qsat1 = _qs(t_lbot, pbot)
    qsat2 = _rd(PQ0, pbot - PONE) * torch.exp(A2 * (tlev2 - A3)
                                              / (tlev2 - A4))
    rhshmax = qsat2 / qsat1
    in_top = (karr <= lbot[None]) & (karr >= ltop_sh[None])
    rhavg0 = pw.sum0(_where0(in_top, dprs * q / qsatk))
    sumdp0 = pw.sum0(_where0(in_top, dprs))
    need_raise = (rhavg0 / _nz(sumdp0)) > rhshmax

    ltsh, rhavg, sumdp_r, flg = ltop_sh, rhavg0, sumdp0, true2
    for it in range(KLEV):
        l = ltop_sh - 1 - it
        lc = torch.clamp(l, min=0)
        ok = flg & (l >= 0) & need_raise & shallow
        dprs_l = _lev(dprs, lc)
        rhavg = rhavg + _where0(ok, dprs_l * _lev(q, lc) / _lev(qsatk, lc))
        sumdp_r = sumdp_r + _where0(ok, dprs_l)
        pos_cpe = _lev(cpe, lc) > 0.0
        ltsh = torch.where(ok & pos_cpe, lc, ltsh)
        stop = ok & (~pos_cpe | (rhavg / _nz(sumdp_r) <= rhshmax)
                     | (_lev(p, lc) <= PSHU))
        flg = flg & ~stop
    ltop_sh = torch.where(need_raise & shallow, ltsh, ltop_sh)
    ltop_sh = torch.clamp(ltop_sh, min=1)        # low-model-top guard
    ptop_sh = _lev(p, ltop_sh)

    sh_ok = shallow & ~((ptop_sh > pbot - PNO) | (ltop_sh > lbot - 2))

    # cloud-top saturation point from PTBL at the level above the top
    ltp1s = torch.clamp(ltop_sh - 1, min=0)
    thtpk = _lev(t, ltp1s) * _lev(ape, ltp1s)
    ptpk = _ptbl_lookup(thtpk, _lev(q, ltp1s), tables)
    dpmix = ptpk - psp
    dpmix = torch.where(torch.abs(dpmix) < 3000.0,
                        torch.full_like(dpmix, -3000.0), dpmix)
    smix = (thtpk - thbt) / dpmix * STABS

    # reference T: slope profile from lbot upward (cu_bmj.f90:1537-1553)
    lb1 = torch.clamp(lbot + 1, max=LMH)
    t_lb1, p_lb1, ape_lb1 = _lev(t, lb1), _lev(p, lb1), _lev(ape, lb1)
    lmid = torch.div(lbot + ltop_sh, 2, rounding_mode="floor")
    trefk_s = t.clone()
    trefkx, pkxxxx, pkxxxy = zero2, zero2, zero2
    apekxx, apekxy = zero2 + 1.0, zero2 + 1.0
    for it in range(KLEV + 1):
        l = LMH - it
        lc = max(l, 0)
        seed = l == lbot
        trefkx = torch.where(seed, t_lb1, trefkx)
        pkxxxx = torch.where(seed, p_lb1, pkxxxx)
        pkxxxy = torch.where(seed, pbot, pkxxxy)
        apekxx = torch.where(seed, ape_lb1, apekxx)
        apekxy = torch.where(seed, ape_lbot, apekxy)
        act = (l <= lbot) & (l >= ltop_sh) & sh_ok
        newv = ((pkxxxy - pkxxxx) * smix + trefkx * apekxx) / apekxy
        newv = torch.where(l <= lmid,
                           torch.maximum(newv, t[lc] + DTSHAL), newv)
        trefk_s[lc] = torch.where(act, newv, trefk_s[lc])
        lm1 = max(lc - 1, 0)
        trefkx = torch.where(act, newv, trefkx)
        apekxx = torch.where(act, apekxy, apekxx)
        pkxxxx = torch.where(act, pkxxxy, pkxxxx)
        apekxy = torch.where(act, ape[lm1], apekxy)
        pkxxxy = torch.where(act, p[lm1], pkxxxy)

    in_sh = (karr >= ltop_sh[None]) & (karr <= lbot[None])
    sumdt = pw.sum0(_where0(in_sh, (t - trefk_s) * dprs))
    sumdp = pw.sum0(_where0(in_sh, dprs))
    rdpsum = 1.0 / _nz(sumdp)
    tcorr = sumdt * rdpsum
    trefk_s = torch.where(in_sh, trefk_s + tcorr[None], trefk_s)
    fpk = trefk_s

    # humidity profile solve (cu_bmj.f90:1572-1640)
    fptk = _lev(fpk, ltop_sh)
    dpkl = fpk - fptk[None]
    rtbar = 2.0 / (trefk_s + t)
    psum = pw.sum0(_where0(in_sh, dpkl * dprs)) * rdpsum
    qsum = pw.sum0(_where0(in_sh, q * dprs)) * rdpsum
    otsum = pw.sum0(_where0(in_sh, dprs * rtbar))
    rotsum = 1.0 / _nz(otsum)
    potsum = pw.sum0(_where0(in_sh, dpkl * rtbar * dprs)) * rotsum
    qotsum = pw.sum0(_where0(in_sh, q * rtbar * dprs)) * rotsum
    dst = pw.sum0(_where0(in_sh, (trefk_s - t) * rtbar * dprs
                            * inv(ELWV))) * rotsum * CP
    sh_ok = sh_ok & (dst <= 0.0)            # positive entropy change
    dstq = dst * EPSDN
    den = potsum - psum
    sh_ok = sh_ok & (-den / _nz(psum) >= 5e-5)
    dqref = (qotsum - dstq - qsum) / _nz(den)
    sh_ok = sh_ok & (dqref >= 0.0)
    qrftp = qsum - dqref * psum
    qrfkl = (fpk - fptk[None]) * dqref[None] + qrftp[None]

    # cloud moisture sanity limits
    tnew = (trefk_s - t) * tauksc + t
    qsat_new = _qs(tnew, p)
    qnew = (qrfkl - q) * tauksc + q
    bad = in_sh & ((qnew < qsat_new * RHLSC) | (qnew > qsat_new * RHHSC))
    sh_ok = sh_ok & ~torch.any(bad, 0)
    thvref = trefk_s * ape * (qrfkl * 0.608 + 1.0)
    thvref = torch.where(in_sh, thvref, thvref_env)
    # impossible slopes (d theta_v / dp must exceed EPSDT)
    th_up = torch.cat([thvref[:1], thvref[:-1]], 0)
    p_up = torch.cat([p[:1], p[:-1]], 0)
    dtdp = (th_up - thvref) / torch.where(p == p_up, torch.ones_like(p),
                                          p - p_up)
    sh_ok = sh_ok & ~torch.any(in_sh & (karr > 0) & (dtdp < EPSDT), 0)

    dtdt_sh = (trefk_s - t) * tauksc * rdtcnvc
    dqdt_sh = (qrfkl - q) * tauksc * rdtcnvc

    # ---- combine -------------------------------------------------------
    deep3 = deep_ok[None] & in_deep
    sh3 = sh_ok[None] & in_sh
    dtdt = torch.where(sh3, dtdt_sh, _where0(deep3, dtdt_deep))
    dqdt = torch.where(sh3, dqdt_sh, _where0(deep3, dqdt_deep))
    pcpcol = _where0(deep_ok, torch.clamp(pcp_deep, min=0.0))
    cldefi_new = torch.where(no_cnv, cldefi_nc,
                             torch.where(deep_ok, efi,
                                         torch.where(deep_failed,
                                                     cldefi_deepfail,
                                                     cldefi)))
    return dtdt, dqdt, pcpcol, cldefi_new


def bmj(t, th, qv, p, exner, rho, dz, xland, cldefi, dt, psfc=None):
    """Full BMJ step (BMJDRV, cu_bmj.f90:80-389). Inputs bottom-up
    (z, y, x) with qv a mixing ratio; returns (th_new, qv_new,
    rain_delta_mm, cldefi_new)."""
    tables = device_tables(t.device)
    flip = lambda a: torch.flip(a, [0])
    q_spec = torch.clamp(qv / (1.0 + qv), min=EPSQ)
    tcol = flip(t)
    qcol = flip(q_spec)
    pcol = flip(p)
    dpcol = flip(rho * G * dz)
    if psfc is None:
        psfc = p[0] + 0.5 * rho[0] * G * dz[0]
    landmask = xland - 1.0           # BMJ: 1 sea, 0 land
    sm = torch.clamp(landmask, 0.0, 1.0)

    dtdt, dqdt, pcp_m, cldefi_new = _bmj_column(
        dt, sm, cldefi, dpcol, pcol, qcol, tcol, psfc, tables)

    dtdt = flip(dtdt)
    omq = 1.0 - q_spec
    dqdt_mix = flip(dqdt) / (omq * omq)
    th_new = th + dtdt * dt / exner
    qv_new = qv + dqdt_mix * dt
    rain_mm = pcp_m * 1000.0
    return th_new, qv_new, rain_mm, cldefi_new

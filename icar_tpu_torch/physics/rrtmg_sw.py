"""RRTMG shortwave radiation (rad=3, use_simple_sw=false)
(icar_tpu/physics/rrtmg_sw.py, ra_rrtmg_sw.f90): correlated-k gas optics
over 14 bands / 112 g-points, McICA cloud sampling, delta-scaled
two-stream (PIFM) reflectance/transmittance per layer and vertical
adding, on (nlay, N) columns.

The JAX package's arithmetic, as ``rrtmg_lw``: jnp's gather semantics,
its two adding scans as level loops in its order, its cumulative
products in XLA's order (``pointwise.cumprod``), divisions by constants
as products with their float32 reciprocals, and the McICA draw from the
caller's source. Plain PyTorch on the card (no TPU kernel exists).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .rrtmg_lw import (AMD, AMW, AVOGAD, CH4VMR, CO2VMR, GRAV, HEATFAC,
                       N2OVMR, O2VMR, ONEMINUS, _f32, _int_floor, _o3_profile,
                       _rdiv, _take, column_chunked, consts, flat_columns,
                       mcica_subcol)
from .rrtmg_sw_tables import NGB, NGC, NGPTSW, NSPA, NSPB

_DATA = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "rrtmg_sw_data.npz"))

RRSW_SCON = 1368.22        # internal solar constant (rrsw_con :115)
ZEPZEN = 1e-10             # zenith cosine floor (rrtmg_sw :9291)
CLDMIN = 1e-20             # cldprmc_sw threshold
REPCLC = 1e-12             # spcvmc cloud fraction epsilon

_CONSTS = {}


def sw_consts(device):
    """The cloud-optics tables on ``device`` (uploaded once per device)."""
    key = str(torch.device(device))
    if key not in _CONSTS:
        c = {k: _f32(_DATA[k]).to(device) for k in (
            "extliq1", "ssaliq1", "asyliq1", "extice3", "ssaice3",
            "asyice3", "fdlice3")}
        c["ngb0"] = torch.as_tensor(NGB - 1, device=device)
        _CONSTS[key] = SimpleNamespace(**c)
    return _CONSTS[key]


# ==========================================================================
# setcoef (setcoef_sw, ra_rrtmg_sw.f90:2767-3023)
# ==========================================================================

def setcoef_sw(pavel, tavel, coldry, wkl):
    """Pressure/temperature interpolation indices + column amounts;
    pavel/tavel (nlay, N); wkl (7, nlay, N); jp/jt 1-based."""
    k = consts(pavel.device)
    stpfac = 296.0 / 1013.0
    plog = torch.log(pavel)
    jp = torch.clamp(_int_floor(36.0 - 5.0 * (plog + 0.04)), 1, 58)
    jp0 = jp - 1
    fp = 5.0 * (_take(k.preflog, jp0) - plog)
    dt0 = (tavel - _take(k.tref, jp0)) * inv(15.0)
    jt = torch.clamp(_int_floor(3.0 + dt0), 1, 4)
    ft = dt0 - (jt - 3).to(torch.float32)
    dt1 = (tavel - _take(k.tref, jp0 + 1)) * inv(15.0)
    jt1 = torch.clamp(_int_floor(3.0 + dt1), 1, 4)
    ft1 = dt1 - (jt1 - 3).to(torch.float32)

    water = wkl[0] / coldry
    scalefac = pavel * stpfac / tavel
    tropo = plog > 4.56

    forfac = scalefac / (1.0 + water)
    factor_t = (332.0 - tavel) * inv(36.0)
    indfor = torch.where(tropo, torch.clamp(_int_floor(factor_t), 1, 2),
                         torch.full_like(jp, 3))
    forfrac = torch.where(tropo, factor_t - indfor.to(torch.float32),
                          (tavel - 188.0) * inv(36.0) - 1.0)
    selffac = water * forfac
    factor_s = (tavel - 188.0) * inv(7.2)
    indself = torch.clamp(_int_floor(factor_s) - 7, 1, 9)
    selffrac = factor_s - (indself + 7).to(torch.float32)

    def col(i):
        c = 1e-20 * wkl[i]
        return torch.where(c == 0.0, 1e-32 * coldry, c)

    colh2o = 1e-20 * wkl[0]
    colmol = 1e-20 * coldry + colh2o
    compfp = 1.0 - fp
    return SimpleNamespace(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1,
        fac10=compfp * ft, fac00=compfp * (1.0 - ft),
        fac11=fp * ft1, fac01=fp * (1.0 - ft1),
        forfac=colh2o * forfac, forfrac=forfrac, indfor=indfor,
        selffac=colh2o * selffac, selffrac=selffrac, indself=indself,
        colh2o=colh2o, colco2=col(1), colo3=col(2), coln2o=col(3),
        colch4=col(5), colo2=col(6), colmol=colmol, pavel=pavel)


# ==========================================================================
# taumol (taumol_sw + taugb16..29, ra_rrtmg_sw.f90:3114-4574)
# ==========================================================================

def _g(table, idx):
    return _take(table, torch.clamp(idx, 0, table.shape[0] - 1))


def _spec(col1, rat, col2, mult):
    speccomb = col1 + rat * col2
    specparm = torch.clamp(col1 / speccomb, max=ONEMINUS)
    specmult = mult * specparm
    js = 1 + _int_floor(specmult)
    fs = torch.fmod(specmult, 1.0)
    return speccomb, js, fs


def _ind_a(c, band, js=1):
    nsp = max(int(NSPA[band - 1]), 1)
    return (((c.jp - 1) * 5 + (c.jt - 1)) * nsp + js - 1,
            (c.jp * 5 + (c.jt1 - 1)) * nsp + js - 1)


def _ind_b(c, band, js=1):
    nsp = max(int(NSPB[band - 1]), 1)
    return (((c.jp - 13) * 5 + (c.jt - 1)) * nsp + js - 1,
            ((c.jp - 12) * 5 + (c.jt1 - 1)) * nsp + js - 1)


def _major_1sp(table, ind0, ind1, c):
    return (c.fac00[..., None] * _g(table, ind0)
            + c.fac10[..., None] * _g(table, ind0 + 1)
            + c.fac01[..., None] * _g(table, ind1)
            + c.fac11[..., None] * _g(table, ind1 + 1))


def _major_2sp(table, ind0, ind1, fs, c, stride):
    fse = fs[..., None]

    def part(ind, fA, fB):
        return (fA[..., None] * ((1 - fse) * _g(table, ind)
                                 + fse * _g(table, ind + 1))
                + fB[..., None] * ((1 - fse) * _g(table, ind + stride)
                                   + fse * _g(table, ind + stride + 1)))
    return part(ind0, c.fac00, c.fac10) + part(ind1, c.fac01, c.fac11)


def _selffor(t, c):
    selfref, forref = t["selfref"], t["forref"]
    inds0, indf0 = c.indself - 1, c.indfor - 1
    s0 = _g(selfref, inds0)
    f0 = _g(forref, indf0)
    tauself = c.selffac[..., None] * (
        s0 + c.selffrac[..., None] * (_g(selfref, inds0 + 1) - s0))
    taufor = c.forfac[..., None] * (
        f0 + c.forfrac[..., None] * (_g(forref, indf0 + 1) - f0))
    return tauself, taufor


def _laysolfr_lower(c, layreffr, laytrop0):
    """0-based solar-source layer for lower-atmosphere bands
    (laysolfr = min(lay+1, laytrop), last matching lay; default
    laytrop)."""
    nlay = c.jp.shape[0]
    kk = torch.arange(nlay, dtype=torch.int32,
                      device=c.jp.device)[:, None].expand_as(c.jp)
    jp_next = torch.cat([c.jp[1:], c.jp[-1:]], dim=0)
    cond = (c.jp < layreffr) & (jp_next >= layreffr) & c.tropo
    lay = torch.amax(torch.where(cond, kk, torch.full_like(kk, -1)), dim=0)
    return torch.where(lay >= 0, torch.minimum(lay + 1, laytrop0), laytrop0)


def _laysolfr_upper(c, layreffr):
    """0-based solar-source layer for upper-atmosphere bands (default
    nlayers; last lay with jp(lay-1) < layreffr <= jp(lay))."""
    nlay = c.jp.shape[0]
    kk = torch.arange(nlay, dtype=torch.int32,
                      device=c.jp.device)[:, None].expand_as(c.jp)
    jp_prev = torch.cat([c.jp[:1], c.jp[:-1]], dim=0)
    cond = (jp_prev < layreffr) & (c.jp >= layreffr) & ~c.tropo
    lay = torch.amax(torch.where(cond, kk, torch.full_like(kk, -1)), dim=0)
    return torch.where(lay >= 0, lay, torch.full_like(lay, nlay - 1))


def _sflux_eta(sfluxref, js, fs):
    """sfluxref (g, neta); js (N,) 1-based; -> (N, g)."""
    neta = sfluxref.shape[1]
    j0 = torch.clamp(js - 1, 0, neta - 2)
    f = sfluxref.T
    lo = _take(f, j0)
    return lo + fs[..., None] * (_take(f, j0 + 1) - lo)


def taumol_sw(tables, c):
    """Gas + Rayleigh optical depth and the solar source for all 112
    g-points (``tables`` on the columns' device). Returns (taug, taur)
    (nlay, N, 112) and sfluxzen (N, 112)."""
    tropo = c.tropo[..., None]
    laytrop0 = torch.clamp(level_count(c.tropo) - 1, min=0)
    taug_parts, taur_parts, sflux_parts = [], [], []
    shape3 = c.colh2o.shape

    def where_tropo(lower, upper):
        return torch.where(tropo, lower, upper)

    def tauray_scalar(t, ng):
        return (c.colmol[..., None] * t["rayl"]).expand(*shape3, ng)

    def tauray_g(t):
        return c.colmol[..., None] * t["rayl"][None, None, :]

    def sflux_const(t, scale=1.0):
        return (t["sfluxref"][None] * scale).expand(
            shape3[-1], t["sfluxref"].shape[0])

    def sflux_lower_eta(t, col1, col2, rat, layreffr):
        lay = _laysolfr_lower(c, layreffr, laytrop0)
        c1, c2 = take_level(col1, lay), take_level(col2, lay)
        _, js, fs = _spec(c1, rat, c2, 8.0)
        return _sflux_eta(t["sfluxref"], js, fs)

    def sflux_upper_eta(t, col1, col2, rat, layreffr):
        lay = _laysolfr_upper(c, layreffr)
        c1, c2 = take_level(col1, lay), take_level(col2, lay)
        _, js, fs = _spec(c1, rat, c2, 4.0)
        return _sflux_eta(t["sfluxref"], js, fs)

    def two_species(t, band, col2, rat, upper2=False):
        """Lower atmosphere h2o + ``col2`` (eta), and where ``upper2``
        the upper atmosphere alike."""
        tauself, taufor = _selffor(t, c)
        speccomb = c.colh2o + rat * col2
        _, js, fs = _spec(c.colh2o, rat, col2, 8.0)
        i0, i1 = _ind_a(c, band, js)
        lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c,
                                                 9) + tauself + taufor
        if not upper2:
            return lower
        _, jsb, fsb = _spec(c.colh2o, rat, col2, 4.0)
        b0, b1 = _ind_b(c, band, jsb)
        upper = speccomb[..., None] * _major_2sp(t["absb"], b0, b1, fsb, c,
                                                 5) + taufor
        return lower, upper

    # ---- band 16: low h2o,ch4; high ch4 -------------------------------
    t = tables[0]
    lower = two_species(t, 1, c.colch4, t["strrat1"])
    b0, b1 = _ind_b(c, 1)
    upper = c.colch4[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[0]))
    sflux_parts.append(sflux_const(t))

    # ---- band 17: low h2o,co2; high h2o,co2 ----------------------------
    t = tables[1]
    lower, upper = two_species(t, 2, c.colco2, t["strrat"], upper2=True)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[1]))
    sflux_parts.append(sflux_upper_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 18: low h2o,ch4; high ch4 --------------------------------
    t = tables[2]
    lower = two_species(t, 3, c.colch4, t["strrat"])
    b0, b1 = _ind_b(c, 3)
    upper = c.colch4[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[2]))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colch4, t["strrat"],
                                       t["layreffr"]))

    # ---- band 19: low h2o,co2; high co2 --------------------------------
    t = tables[3]
    lower = two_species(t, 4, c.colco2, t["strrat"])
    b0, b1 = _ind_b(c, 4)
    upper = c.colco2[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[3]))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 20: low h2o (+ch4 minor); high h2o -----------------------
    t = tables[4]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 5)
    ch4 = c.colch4[..., None] * t["absch4"][None, None]
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + tauself + taufor + ch4
    b0, b1 = _ind_b(c, 5)
    upper = c.colh2o[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + taufor + ch4
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[4]))
    sflux_parts.append(sflux_const(t))

    # ---- band 21: low h2o,co2; high h2o,co2 ----------------------------
    t = tables[5]
    lower, upper = two_species(t, 6, c.colco2, t["strrat"], upper2=True)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[5]))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colco2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 22: low h2o,o2; high o2 ----------------------------------
    t = tables[6]
    o2adj = 1.6
    o2cont = (4.35e-4 * c.colo2 * inv(700.0))[..., None]
    rat22 = o2adj * t["strrat"]
    lower = two_species(t, 7, c.colo2, rat22)
    lower = lower + o2cont
    b0, b1 = _ind_b(c, 7)
    upper = (c.colo2 * o2adj)[..., None] * _major_1sp(t["absb"], b0, b1,
                                                      c) + o2cont
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[6]))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colo2, rat22,
                                       t["layreffr"]))

    # ---- band 23: low h2o; high nothing --------------------------------
    t = tables[7]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 8)
    lower = c.colh2o[..., None] * (
        t["givfac"] * _major_1sp(t["absa"], i0, i1, c)) + tauself + taufor
    taug_parts.append(where_tropo(lower, torch.zeros_like(lower)))
    taur_parts.append(tauray_g(t).expand(lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 24: low h2o,o2 (+o3); high o2 (+o3) ----------------------
    t = tables[8]
    tauself, taufor = _selffor(t, c)
    speccomb = c.colh2o + t["strrat"] * c.colo2
    _, js, fs = _spec(c.colh2o, t["strrat"], c.colo2, 8.0)
    i0, i1 = _ind_a(c, 9, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9) \
        + c.colo3[..., None] * t["abso3a"][None, None] + tauself + taufor
    b0, b1 = _ind_b(c, 9)
    upper = c.colo2[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + c.colo3[..., None] * t["abso3b"][None, None]
    taug_parts.append(where_tropo(lower, upper))
    # Rayleigh: eta-interpolated below laytrop (rayla (g, 9))
    rayla = t["rayla"].T
    j0 = torch.clamp(js - 1, 0, rayla.shape[0] - 2)
    r0 = _take(rayla, j0)
    ray_lo = r0 + fs[..., None] * (_take(rayla, j0 + 1) - r0)
    taur_parts.append(where_tropo(c.colmol[..., None] * ray_lo,
                                  c.colmol[..., None]
                                  * t["raylb"][None, None]))
    sflux_parts.append(sflux_lower_eta(t, c.colh2o, c.colo2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 25: low h2o (+o3); high o3 -------------------------------
    t = tables[9]
    i0, i1 = _ind_a(c, 10)
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + c.colo3[..., None] * t["abso3a"][None, None]
    upper = c.colo3[..., None] * t["abso3b"][None, None]
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_g(t).expand(lower.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 26: pure Rayleigh ----------------------------------------
    t = tables[10]
    zero = torch.zeros(*shape3, int(NGC[10]), device=c.colh2o.device)
    taug_parts.append(zero)
    taur_parts.append(tauray_g(t).expand(zero.shape))
    sflux_parts.append(sflux_const(t))

    # ---- band 27: o3 ----------------------------------------------------
    t = tables[11]
    i0, i1 = _ind_a(c, 12)
    lower = c.colo3[..., None] * _major_1sp(t["absa"], i0, i1, c)
    b0, b1 = _ind_b(c, 12)
    upper = c.colo3[..., None] * _major_1sp(t["absb"], b0, b1, c)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_g(t).expand(lower.shape))
    sflux_parts.append(sflux_const(t, scale=t["scalekur"]))

    # ---- band 28: o3,o2 -------------------------------------------------
    t = tables[12]
    speccomb = c.colo3 + t["strrat"] * c.colo2
    _, js, fs = _spec(c.colo3, t["strrat"], c.colo2, 8.0)
    i0, i1 = _ind_a(c, 13, js)
    lower = speccomb[..., None] * _major_2sp(t["absa"], i0, i1, fs, c, 9)
    _, jsb, fsb = _spec(c.colo3, t["strrat"], c.colo2, 4.0)
    b0, b1 = _ind_b(c, 13, jsb)
    upper = speccomb[..., None] * _major_2sp(t["absb"], b0, b1, fsb, c, 5)
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[12]))
    sflux_parts.append(sflux_upper_eta(t, c.colo3, c.colo2, t["strrat"],
                                       t["layreffr"]))

    # ---- band 29: low h2o (+co2); high co2 (+h2o) -----------------------
    t = tables[13]
    tauself, taufor = _selffor(t, c)
    i0, i1 = _ind_a(c, 14)
    lower = c.colh2o[..., None] * _major_1sp(t["absa"], i0, i1, c) \
        + tauself + taufor + c.colco2[..., None] * t["absco2"][None, None]
    b0, b1 = _ind_b(c, 14)
    upper = c.colco2[..., None] * _major_1sp(t["absb"], b0, b1, c) \
        + c.colh2o[..., None] * t["absh2o"][None, None]
    taug_parts.append(where_tropo(lower, upper))
    taur_parts.append(tauray_scalar(t, NGC[13]))
    sflux_parts.append(sflux_const(t))

    # the JAX package's clamp of a negative gas optical depth
    taug = torch.clamp(torch.cat(taug_parts, dim=-1), min=0.0)
    return taug, torch.cat(taur_parts, dim=-1), torch.cat(sflux_parts,
                                                          dim=-1)


def level_count(mask):
    """The number of True levels of each column, as int32."""
    return torch.sum(mask.to(torch.int32), dim=0, dtype=torch.int32)


# ==========================================================================
# cloud optics (cldprmc_sw, ra_rrtmg_sw.f90:1990-2422)
# ==========================================================================

def cldprmc_sw(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res):
    """In-cloud SW optical properties per g-point, delta-scaled as in the
    iceflag=5 / liqflag=1 path; radii clipped into the table range.
    Returns (taucmc, ssacmc, asmcmc, taormc), each (nlay, N, ngpt)."""
    k = sw_consts(cldfmc.device)
    zero = torch.zeros((), dtype=cldfmc.dtype, device=cldfmc.device)
    cwp = ciwpmc + clwpmc + cswpmc
    cloudy = (cldfmc >= CLDMIN) & (cwp >= CLDMIN)

    def ice_props(rad):
        factor = (torch.clamp(rad, 5.0, 140.0) - 2.0) * inv(3.0)
        idx = torch.clamp(_int_floor(factor), max=45)
        fint = factor - idx.to(torch.float32)
        idx0 = idx - 1

        def interp_g(tab):
            lo = _g(tab, idx0)
            v = lo + fint[..., None] * (_g(tab, idx0 + 1) - lo)
            return v[..., k.ngb0]
        ext = interp_g(k.extice3)
        ssa = interp_g(k.ssaice3)
        asy = interp_g(k.asyice3)
        fdelta = torch.clamp(interp_g(k.fdlice3), 0.0, 1.0)
        forw = torch.minimum(fdelta + _rdiv(0.5, torch.clamp(ssa,
                                                              min=1e-12)),
                             asy)
        return ext, ssa, asy, forw

    exti, ssai, asyi, forwi = ice_props(rei)
    exts, ssas, asys, forws = ice_props(res)

    radliq = torch.clamp(rel, 1.5, 60.0)
    idxl = torch.clamp(_int_floor(radliq - 1.5), 1, 57)
    fintl = radliq - 1.5 - idxl.to(torch.float32)
    idxl0 = idxl - 1

    def interp_liq(tab):
        lo = _take(tab, idxl0)
        v = lo + fintl[..., None] * (_g(tab, idxl0 + 1) - lo)
        return v[..., k.ngb0]
    extl = interp_liq(k.extliq1)
    ssal = torch.clamp(interp_liq(k.ssaliq1), max=1.0)
    asyl = interp_liq(k.asyliq1)
    forwl = asyl * asyl

    def mask(m, *props):
        return [torch.where(m, p, zero) for p in props]
    exti, ssai, asyi, forwi = mask((ciwpmc + cswpmc) > 0.0, exti, ssai,
                                   asyi, forwi)
    exts, ssas, asys, forws = mask(cswpmc > 0.0, exts, ssas, asys, forws)
    extl, ssal, asyl, forwl = mask(clwpmc > 0.0, extl, ssal, asyl, forwl)

    tauliqorig = clwpmc * extl
    tauiceorig = ciwpmc * exti
    tausnoorig = cswpmc * exts
    taormc = tauliqorig + tauiceorig + tausnoorig

    def dscale(ssa0, forw, tau0):
        denom = torch.clamp(1.0 - forw * ssa0, min=1e-12)
        return ssa0 * (1.0 - forw) / denom, (1.0 - forw * ssa0) * tau0
    ssaliq, tauliq = dscale(ssal, forwl, tauliqorig)
    ssaice, tauice = dscale(ssai, forwi, tauiceorig)
    ssasno, tausno = dscale(ssas, forws, tausnoorig)
    scatliq = ssaliq * tauliq
    scatice = ssaice * tauice
    scatsno = ssasno * tausno
    taucmc = tauliq + tauice + tausno
    taucmc = torch.where(taucmc == 0.0, torch.full_like(taucmc, CLDMIN),
                         taucmc)
    scatice = torch.where(scatice == 0.0, torch.full_like(scatice, CLDMIN),
                          scatice)
    scatsno = torch.where(scatsno == 0.0, torch.full_like(scatsno, CLDMIN),
                          scatsno)
    ssacmc = (scatliq + scatice + scatsno) / taucmc
    asmcmc = (scatliq * (asyl - forwl) / torch.clamp(1.0 - forwl, min=1e-12)
              + scatice * (asyi - forwi) / torch.clamp(1.0 - forwi,
                                                       min=1e-12)
              + scatsno * (asys - forws) / torch.clamp(1.0 - forws,
                                                       min=1e-12)
              ) / (scatliq + scatice + scatsno)
    return tuple(torch.where(cloudy, v, zero)
                 for v in (taucmc, ssacmc, asmcmc, taormc))


# ==========================================================================
# two-stream reflectance/transmittance (reftra_sw, :2454-2734)
# ==========================================================================

def reftra_sw(pgg, prmuz, ptau, pw_, active):
    """PIFM (kmodts=2) two-stream layer reflectance/transmittance for
    direct and diffuse incidence; ``active`` (a mask, or True) selects
    the layers that need it (inactive: r=0, t=1)."""
    eps = 1e-8
    w, g, mu = pw_, pgg, prmuz
    zero = torch.zeros((), dtype=ptau.dtype, device=ptau.device)
    one = torch.ones((), dtype=ptau.dtype, device=ptau.device)

    gamma1 = (8.0 - w * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (w * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * g * mu) * 0.25
    gamma4 = 1.0 - gamma3

    gr = g / torch.clamp(1.0 - g, min=1e-12)
    denom_w = 1.0 - (1.0 - w) * torch.where(g == 1.0, zero, gr * gr)
    zwo = torch.where((w > 0.0) & (denom_w != 0.0),
                      w / torch.where(denom_w == 0.0, one, denom_w), zero)
    conserv = zwo >= 0.9999995

    ze2_dir = torch.exp(-torch.clamp(ptau / mu, max=500.0))

    # conservative branch (:2608-2640)
    za = gamma1 * mu
    za1 = za - gamma3
    zgt = gamma1 * ptau
    ref_c = (zgt - za1 * (1.0 - ze2_dir)) / (1.0 + zgt)
    tra_c = 1.0 - ref_c
    refd_c = zgt / (1.0 + zgt)
    trad_c = 1.0 - refd_c

    # non-conservative branch (:2644-2732)
    za1n = gamma1 * gamma4 + gamma2 * gamma3
    za2n = gamma1 * gamma3 + gamma2 * gamma4
    zrk = torch.sqrt(torch.clamp(gamma1 * gamma1 - gamma2 * gamma2,
                                 min=1e-12))
    zrp = zrk * mu
    zrp1, zrm1 = 1.0 + zrp, 1.0 - zrp
    zrk2 = 2.0 * zrk
    zrpp = 1.0 - zrp * zrp
    zrkg = zrk + gamma1
    zr1 = zrm1 * (za2n + zrk * gamma3)
    zr2 = zrp1 * (za2n - zrk * gamma3)
    zr3 = zrk2 * (gamma3 - za2n * mu)
    zr4 = zrpp * zrkg
    zr5 = zrpp * (zrk - gamma1)
    zt1 = zrp1 * (za1n + zrk * gamma4)
    zt2 = zrm1 * (za1n - zrk * gamma4)
    zt3 = zrk2 * (gamma4 + za1n * mu)
    zbeta = (gamma1 - zrk) / zrkg

    ze1 = torch.clamp(zrk * ptau, max=40.0)
    ze2 = torch.clamp(ptau / mu, max=40.0)
    zem1 = torch.exp(-ze1)
    zep1 = torch.exp(ze1)
    zem2 = torch.exp(-ze2)
    zep2 = torch.exp(ze2)

    zden = zr4 * zep1 + zr5 * zem1
    small = torch.abs(zden) <= eps
    zden1 = torch.where(small, one, zden)
    ref_n = torch.where(small, torch.full_like(zden, eps),
                        w * (zr1 * zep1 - zr2 * zem1 - zr3 * zem2) / zden1)
    tra_n = torch.where(
        small, zem2,
        zem2 - zem2 * w * (zt1 * zep1 - zt2 * zem1 - zt3 * zep2) / zden1)
    zemm = zem1 * zem1
    zdend = 1.0 / torch.clamp((1.0 - zbeta * zemm) * zrkg, min=1e-12)
    refd_n = gamma2 * (1.0 - zemm) * zdend
    trad_n = zrk2 * zem1 * zdend

    pref = torch.where(conserv, ref_c, ref_n)
    ptra = torch.where(conserv, tra_c, tra_n)
    prefd = torch.where(conserv, refd_c, refd_n)
    ptrad = torch.where(conserv, trad_c, trad_n)
    # the JAX package's float32 guard against prefd rounding to 1
    prefd = torch.clamp(prefd, 0.0, 1.0 - 1e-6)
    if active is True:
        return pref, prefd, ptra, ptrad
    return (torch.where(active, pref, zero), torch.where(active, prefd, zero),
            torch.where(active, ptra, one), torch.where(active, ptrad, one))


# ==========================================================================
# vertical adding (vrtqdr_sw, :7956-8080)
# ==========================================================================

def vrtqdr_sw(pref, prefd, ptra, ptrad, pdbt, ptdbt, palbp, palbd):
    """Vertical quadrature; layer arrays (nlay, ..., ng) ordered TOP to
    BOTTOM, level arrays (nlay+1, ...) with index 0 = TOA; the two
    passes as level loops in the JAX scans' order. Returns (pfd, pfu)."""
    nlay = pref.shape[0]
    ref_s = palbp.expand(pref.shape[1:])
    refd_s = palbd.expand(pref.shape[1:])

    # bottom-up pass: prup/prupd
    rup, rupd = ref_s, refd_s
    prup, prupd = [None] * nlay, [None] * nlay
    for k in range(nlay - 1, -1, -1):
        zreflect = 1.0 / torch.clamp(1.0 - rupd * prefd[k], min=1e-6)
        rup, rupd = (
            pref[k] + (ptrad[k] * ((ptra[k] - pdbt[k]) * rupd
                                   + pdbt[k] * rup)) * zreflect,
            prefd[k] + ptrad[k] * ptrad[k] * rupd * zreflect)
        prup[k], prupd[k] = rup, rupd
    prup = torch.stack(prup + [ref_s])
    prupd = torch.stack(prupd + [refd_s])

    # top-down pass: ztdn / prdnd
    tdn = torch.ones_like(ref_s)
    rdnd = torch.zeros_like(ref_s)
    ztdn, prdnd = [tdn], [rdnd]
    for k in range(nlay):
        zreflect = 1.0 / torch.clamp(1.0 - prefd[k] * rdnd, min=1e-6)
        tdn, rdnd = (
            ptdbt[k] * ptra[k] + (ptrad[k] * ((tdn - ptdbt[k])
                                              + ptdbt[k] * pref[k] * rdnd))
            * zreflect,
            prefd[k] + ptrad[k] * ptrad[k] * rdnd * zreflect)
        ztdn.append(tdn)
        prdnd.append(rdnd)
    ztdn = torch.stack(ztdn)
    prdnd = torch.stack(prdnd)

    zreflect = 1.0 / torch.clamp(1.0 - prdnd * prupd, min=1e-6)
    pfu = (ptdbt * prup + (ztdn - ptdbt) * prupd) * zreflect
    pfd = ptdbt + (ztdn - ptdbt + ptdbt * prup * prdnd) * zreflect
    return pfd, pfu


# ==========================================================================
# spectral solver (spcvmc_sw, :8117-8684)
# ==========================================================================

def _cumprod_levels(a):
    return torch.cat([torch.ones_like(a[:1]), pw.cumprod(a, 0)], dim=0)


def spcvmc_sw(taug, taur, sfluxzen, cldfmc, taucmc, ssacmc, asmcmc,
              taormc, albdir, albdif, prmu0, adjflux):
    """Two-stream fluxes for every g-point at once. taug/taur/cloud
    arrays (nlay, N, ng) BOTTOM to TOP; albdir/albdif/prmu0 (N,). Returns
    (nlay+1, N) total-sky and clear-sky down/up fluxes and the direct
    down fluxes, bottom to top."""
    mu = prmu0[None, :, None]

    def flip(a):
        return torch.flip(a, dims=(0,))
    taug_t, taur_t = flip(taug), flip(taur)
    cldf_t = flip(cldfmc)
    tauc_t, ssac_t = flip(taucmc), flip(ssacmc)
    asmc_t, taor_t = flip(asmcmc), flip(taormc)

    # clear-sky optical parameters (aerosol-free: ICAR passes tauaer=0)
    ztauc = taur_t + taug_t
    zomcc = taur_t / torch.clamp(ztauc, min=1e-20)
    zgcc = torch.zeros_like(ztauc)

    # direct transmittance with UNSCALED cloud optical depth (:8490-8524)
    zdbtc_nodel = torch.exp(-torch.clamp(ztauc / mu, max=500.0))
    zdbt_nodel = (1.0 - cldf_t) * zdbtc_nodel + cldf_t * torch.exp(
        -torch.clamp((ztauc + taor_t) / mu, max=500.0))
    ztdbtc_nodel = _cumprod_levels(zdbtc_nodel)
    ztdbt_nodel = _cumprod_levels(zdbt_nodel)

    # delta-scale clear sky (zf = g^2 = 0, kept for parity)
    zf = zgcc * zgcc
    zwf = zomcc * zf
    ztauc = (1.0 - zwf) * ztauc
    zomcc = (zomcc - zwf) / torch.clamp(1.0 - zwf, min=1e-12)
    zgcc = (zgcc - zf) / torch.clamp(1.0 - zf, min=1e-12)

    # total-sky optical parameters (icpr=1: cloud already delta-scaled)
    ztauo = ztauc + tauc_t
    zomco_n = ztauc * zomcc + tauc_t * ssac_t
    zgco = (tauc_t * ssac_t * asmc_t + ztauc * zomcc * zgcc) \
        / torch.clamp(zomco_n, min=1e-20)
    zomco = zomco_n / torch.clamp(ztauo, min=1e-20)

    refc, refdc, trac, tradc = reftra_sw(zgcc, mu, ztauc, zomcc, True)
    refo, refdo, trao, trado = reftra_sw(zgco, mu, ztauo, zomco,
                                         cldf_t > REPCLC)
    zclear = 1.0 - cldf_t
    zref = zclear * refc + cldf_t * refo
    zrefd = zclear * refdc + cldf_t * refdo
    ztra = zclear * trac + cldf_t * trao
    ztrad = zclear * tradc + cldf_t * trado

    # direct beam with delta-scaled optical depths (:8585-8620)
    zdbtc = torch.exp(-torch.clamp(ztauc / mu, max=500.0))
    zdbt = zclear * zdbtc + cldf_t * torch.exp(
        -torch.clamp(ztauo / mu, max=500.0))
    ztdbtc = _cumprod_levels(zdbtc)
    ztdbt = _cumprod_levels(zdbt)

    albp = albdir[..., None]
    albd = albdif[..., None]
    fd_c, fu_c = vrtqdr_sw(refc, refdc, trac, tradc,
                           torch.cat([zdbtc, torch.zeros_like(zdbtc[:1])]),
                           ztdbtc, albp, albd)
    fd, fu = vrtqdr_sw(zref, zrefd, ztra, ztrad,
                       torch.cat([zdbt, torch.zeros_like(zdbt[:1])]),
                       ztdbt, albp, albd)

    zincflx = adjflux * sfluxzen * prmu0[..., None]      # (N, ng)

    def tot(f):
        return flip(torch.sum(zincflx[None] * f, dim=-1))
    return (tot(fd), tot(fu), tot(fd_c), tot(fu_c), tot(ztdbt_nodel),
            tot(ztdbtc_nodel))


# ==========================================================================
# top-level column model (rrtmg_sw, :8766-9521)
# ==========================================================================

def rrtmg_sw_rad(tables, play, plev, tlay, cosz, albedo, h2ovmr, o3vmr,
                 cldfrac, ciwp, clwp, cswp, rei, rel, res, cdf, scon,
                 icld=1, co2vmr=CO2VMR, n2ovmr=N2OVMR, ch4vmr=CH4VMR):
    """Full SW calculation on (nlay, N) columns, bottom to top
    (icar_tpu/physics/rrtmg_sw.py ``rrtmg_sw_rad``, its PRNG key replaced
    by the McICA draw ``cdf`` (nlay, N, 112)). Returns a namespace with
    swdflx/swuflx/swdflxc/swuflxc (nlay+1, N) (index 0 = surface), the
    heating rate swhr (nlay, N) [K/day] and the direct down flux."""
    dpg = plev[:-1] - plev[1:]
    coldry = dpg * 1e3 * AVOGAD / (1e2 * GRAV * AMD * (
        1.0 + h2ovmr * AMW * inv(AMD)))
    wkl = torch.stack([h2ovmr * coldry, co2vmr * coldry, o3vmr * coldry,
                       n2ovmr * coldry, torch.zeros_like(coldry),
                       ch4vmr * coldry, O2VMR * coldry])
    c = setcoef_sw(play, tlay, coldry, wkl)
    taug, taur, sfluxzen = taumol_sw(tables, c)

    cldfmc, ciwpmc, clwpmc, cswpmc = mcica_subcol(
        cdf, cldfrac, ciwp, clwp, cswp, icld=icld)
    taucmc, ssacmc, asmcmc, taormc = cldprmc_sw(
        cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res)

    mu0 = torch.clamp(cosz, min=ZEPZEN)
    adjflux = scon / RRSW_SCON          # adjes=1, dyofyr=0 (wrapper)
    swdflx, swuflx, swdflxc, swuflxc, swddir, swddirc = spcvmc_sw(
        taug, taur, sfluxzen, cldfmc, taucmc, ssacmc, asmcmc, taormc,
        albedo, albedo, mu0, adjflux)

    fnet = swdflx - swuflx
    fnetc = swdflxc - swuflxc
    swhr = HEATFAC * (fnet[1:] - fnet[:-1]) / dpg
    swhrc = HEATFAC * (fnetc[1:] - fnetc[:-1]) / dpg
    # top layer heating zeroed (:9464-9465)
    swhr = torch.cat([swhr[:-1], torch.zeros_like(swhr[-1:])])
    swhrc = torch.cat([swhrc[:-1], torch.zeros_like(swhrc[-1:])])
    return SimpleNamespace(swdflx=swdflx, swuflx=swuflx, swdflxc=swdflxc,
                           swuflxc=swuflxc, swhr=swhr, swhrc=swhrc,
                           swddir=swddir)


# ==========================================================================
# ICAR-facing driver (RRTMG_SWRAD, ra_rrtmg_sw.f90:9933-11303)
# ==========================================================================

def rrtmg_sw_driver(tables, cdf, t, p3d, p8w, t3d, t8w, cosz2d, albedo2d,
                    qv3d, qc3d, qi3d, qs3d, cldfra3d, re_cloud, re_ice,
                    re_snow, rho3d, dz8w, exner, xland=None,
                    solar_constant=1366.0, mp_option=0, ghg=None):
    """(z, y, x) fields -> columns -> ``rrtmg_sw_rad`` per chunk -> theta
    tendency (icar_tpu/physics/rrtmg_sw.py ``rrtmg_sw_driver``). Adds the
    extra layer from the model top to the TOA (plev = 1e-5 hPa) as the
    wrapper does (:10700-10760); night columns (cosz <= 0) are masked to
    zero afterwards. ``cdf`` as in ``rrtmg_lw.rrtmg_lw_driver`` (kind
    "sw"). Returns (th_tend [K/s on theta], swdown, gsw, swcf, swdir)."""
    from . import rrtmg_lw
    nz, ny, nx = p3d.shape
    N = ny * nx
    flat = flat_columns
    play = flat(p3d) * inv(100.0)
    ptop_if = torch.maximum(2.0 * p3d[-1] - p8w[-1],
                            p8w[-1] * 0.5) * inv(100.0)
    plev = torch.cat([flat(p8w) * inv(100.0), ptop_if.reshape(1, N)])
    tlay = flat(t3d)
    ttop_if = 2.0 * t3d[-1] - t8w[-1]
    # extra layer to TOA (:10700-10707)
    play = torch.cat([play, 0.5 * plev[-1:]])
    plev = torch.cat([plev, torch.full((1, N), 1.0e-5, device=plev.device)])
    tlay = torch.cat([tlay, ttop_if.reshape(1, N)])

    def ext(a):
        return torch.cat([flat(a), flat(a)[-1:]])
    h2ovmr = ext(qv3d) * (AMD / AMW)
    o3vmr = _o3_profile(play) * (AMD / 47.9982)

    cf = torch.clamp(flat(cldfra3d), 0.0, 1.0)
    zero = torch.zeros((), dtype=cf.dtype, device=cf.device)

    def gwp(q):
        return torch.where(cf > 0.0, 1000.0 * flat(q * rho3d * dz8w)
                           / torch.clamp(cf, min=1e-3), zero)

    def pad(a):
        return torch.cat([a, torch.zeros_like(a[:1])])
    clwp = pad(gwp(qc3d))
    ciwp = pad(gwp(qi3d))
    cswp = pad(gwp(qs3d))
    cf = pad(cf)

    # NOTE reference quirk preserved: with mp_options /= 5 the wrapper
    # forces re_cloud=10.5, re_ice=30, re_snow=500 um (:10578-10650); 500
    # clips to the 140 um table edge
    if mp_option != 5:
        rel = torch.full_like(cf, 10.5)
        rei = torch.full_like(cf, 30.0)
        res = torch.full_like(cf, 140.0)
    else:
        rel = torch.clamp(pad(flat(re_cloud)) * 1e6, min=2.5)
        if xland is None:
            rel_fb = torch.full_like(rel, 10.5)
        else:
            rel_fb = torch.where(flat(xland)[None] > 1.5,
                                 torch.full_like(rel, 10.5),
                                 torch.full_like(rel, 7.5))
        rel = torch.where((rel <= 2.5) & (cf > 0.0), rel_fb, rel)
        rei = torch.clamp(pad(flat(re_ice)) * 1e6, min=5.0)
        res = torch.clamp(torch.clamp(pad(flat(re_snow)) * 1e6, min=10.0),
                          5.0, 140.0)

    cosz = flat(cosz2d)
    gkw = {} if ghg is None else dict(co2vmr=float(ghg.co2),
                                      n2ovmr=float(ghg.n2o),
                                      ch4vmr=float(ghg.ch4))

    def rad_chunk(chunk, n_chunks, play_c, plev_c, tlay_c, cosz_c, alb_c,
                  h2o, o3, cfc, ciw, clw, csw, rei_c, rel_c, res_c):
        draw = cdf("sw", t, chunk, n_chunks, (play_c.shape[0],
                                              play_c.shape[1], NGPTSW),
                   play_c.device)
        o = rrtmg_sw_rad(tables, play_c, plev_c, tlay_c, cosz_c, alb_c,
                         h2o, o3, cfc, ciw, clw, csw, rei_c, rel_c,
                         res_c, draw, scon=solar_constant, **gkw)
        return dict(swhr=o.swhr[:nz], swd0=o.swdflx[0],
                    swu0=o.swuflx[0], swdT=o.swdflx[-1],
                    swuT=o.swuflx[-1], swdcT=o.swdflxc[-1],
                    swucT=o.swuflxc[-1], swddir0=o.swddir[0])

    out = column_chunked(
        rad_chunk,
        (play, plev, tlay, cosz, flat(albedo2d), h2ovmr, o3vmr, cf, ciwp,
         clwp, cswp, rei, rel, res), N, rrtmg_lw.RRTMG_COL_CHUNK)

    day2 = cosz > 0.0
    swhr = torch.where(day2[None], out["swhr"], zero)
    swd0 = torch.where(day2, out["swd0"], zero)
    swu0 = torch.where(day2, out["swu0"], zero)
    swddir = torch.where(day2, out["swddir0"], zero)

    swdown = swd0.reshape(ny, nx)
    gsw = (swd0 - swu0).reshape(ny, nx)
    swcf = torch.where(
        day2, (out["swdT"] - out["swuT"]) - (out["swdcT"] - out["swucT"]),
        zero).reshape(ny, nx)
    # the direct-beam surface flux, clamped to swdown (the unscaled-tau
    # direct transmittance can pass the delta-scaled total under thick
    # cloud); the diffuse part is swdown - swdir
    swdir = torch.minimum(swddir.reshape(ny, nx), swdown)
    th_tend = (swhr * inv(86400.0)).reshape(nz, ny, nx) / exner
    return th_tend, swdown, gsw, swcf, swdir


# --------------------------------------------------------------------------
# table resolution for model runs
# --------------------------------------------------------------------------

_TABLES = None


def set_sw_tables(tables):
    global _TABLES
    _TABLES = tables


def get_sw_tables(support_dir="rrtmg_support"):
    global _TABLES
    if _TABLES is None:
        from .rrtmg_sw_tables import load_sw_tables
        try:
            _TABLES = load_sw_tables(support_dir)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"RRTMG-SW k-distribution data not found in "
                f"'{support_dir}'. rad=3 with use_simple_sw=false needs "
                "the external rrtmg_support files. Tests can inject "
                "synthetic tables via icar_tpu.physics.rrtmg_sw."
                "set_sw_tables(rrtmg_sw_tables.synthetic_sw_tables())."
            ) from e
    return _TABLES

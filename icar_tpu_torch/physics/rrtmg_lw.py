"""RRTMG longwave radiation (rad=3) (icar_tpu/physics/rrtmg_lw.py,
ra_rrtmg_lw.f90): correlated-k gas optics over 16 bands / 140 g-points,
McICA cloud sampling and the RRTM radiative transfer with the
secant-diffusivity-angle approximation, on (nlay, N) columns.

The JAX package's arithmetic, expression by expression: its table
gathers keep jnp's index semantics (a negative index counts from the end,
then every index clamps into the table; ``_take``), its two level scans
are Python loops in its order, its reductions over the levels are
sequential as XLA's, and a division by a constant is a product with the
constant's float32 reciprocal (``pointwise.inv``), as the compiled JAX
step forms it. The McICA uniform draw comes from a source passed in by
the caller (``TorchCdf`` by default; the tests inject the JAX package's
draws): torch cannot reproduce ``jax.random``. None of this has a TPU
kernel: it is plain PyTorch on the card.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.pointwise import inv
from .rrtmg_lw_tables import DELWAVE, NGB, NGPTLW, NSPA, NSPB

_DATA = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "rrtmg_lw_data.npz"))

GRAV = 9.8066
AVOGAD = 6.02214199e23
AMD = 28.9660          # molecular weight dry air
AMW = 18.0160          # molecular weight water
FLUXFAC = np.pi * 2.e4
HEATFAC = 8.4391       # K/day per (W/m2 / (hPa)) (rrlw_con)
ONEMINUS = 1.0 - 1e-6
SECDIFF_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                       1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66])
SECDIFF_A1 = np.array([0.0, 0.25, 0.22, 0.0, 0.13, 0.446, -0.10, 0.40,
                       -0.006, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
SECDIFF_A2 = np.array([0.0, -12.0, -11.7, 0.0, -0.72, -0.243, 0.19,
                       -0.062, 0.414, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
SECDIFF_FIXED = np.array([True, False, False, True, False, False, False,
                          False, False] + [True] * 7)
WTDIFF = 0.5

# default trace-gas volume mixing ratios (inatm/WRF rrtmg_lwrad defaults)
CO2VMR = 379e-6
N2OVMR = 319e-9
CH4VMR = 1774e-9
O2VMR = 0.209488
CFC11VMR = 0.251e-9
CFC12VMR = 0.538e-9
CFC22VMR = 0.169e-9
CCL4VMR = 0.093e-9

# climatological ozone profile (O3DATA, ra_rrtmg_lw.f90:12808-12870)
_O3SUM = np.array([5.297e-8, 5.852e-8, 6.579e-8, 7.505e-8, 8.577e-8,
                   9.895e-8, 1.175e-7, 1.399e-7, 1.677e-7, 2.003e-7,
                   2.571e-7, 3.325e-7, 4.438e-7, 6.255e-7, 8.168e-7,
                   1.036e-6, 1.366e-6, 1.855e-6, 2.514e-6, 3.240e-6,
                   4.033e-6, 4.854e-6, 5.517e-6, 6.089e-6, 6.689e-6,
                   1.106e-5, 1.462e-5, 1.321e-5, 9.856e-6, 5.960e-6,
                   5.960e-6])
_PPSUM = np.array([955.890, 850.532, 754.599, 667.742, 589.841, 519.421,
                   455.480, 398.085, 347.171, 301.735, 261.310, 225.360,
                   193.419, 165.490, 141.032, 120.125, 102.689, 87.829,
                   75.123, 64.306, 55.086, 47.209, 40.535, 34.795,
                   29.865, 19.122, 9.277, 4.660, 2.421, 1.294, 0.647])

# columns per RRTMG call (icar_tpu/physics/rrtmg_lw.py RRTMG_COL_CHUNK):
# the g-point temporaries of one chunk at 20 levels are (20, 16384, 140)
# float32, 183 MB each; read at call time, so tests can change it
RRTMG_COL_CHUNK = 16384

_CONSTS = {}


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def consts(device):
    """The module's tables on ``device`` (uploaded once per device)."""
    key = str(torch.device(device))
    if key not in _CONSTS:
        tot = np.concatenate([_DATA["totplnk"][:, :15],
                              _DATA["totplk16"][:, None]], axis=1)
        c = dict(tot=tot, preflog=_DATA["preflog"], tref=_DATA["tref"],
                 chi_mls=_DATA["chi_mls"], absliq1=_DATA["absliq1"],
                 absice3=_DATA["absice3"], a0=SECDIFF_A0, a1=SECDIFF_A1,
                 a2=SECDIFF_A2, delwave=DELWAVE,
                 o3_ref=_O3SUM[::-1].copy(), ppsum=_PPSUM[::-1].copy())
        c = {k: _f32(v).to(device) for k, v in c.items()}
        c["logp_ref"] = torch.log(c.pop("ppsum"))
        c["ngb0"] = torch.as_tensor(NGB - 1, device=device)
        c["fixed"] = torch.as_tensor(SECDIFF_FIXED, device=device)
        _CONSTS[key] = SimpleNamespace(**c)
    return _CONSTS[key]


def device_tables(tables, device):
    """The k-distribution tables (a list of per-band dicts of numpy arrays
    and numbers, ``rrtmg_lw_tables`` or ``rrtmg_sw_tables``) with every
    array on ``device`` as a float32 tensor; numbers stay numbers."""
    return [{k: (_f32(v).to(device) if isinstance(v, np.ndarray) else v)
             for k, v in t.items()} for t in tables]


def _take(table, idx):
    """``table[idx]`` on axis 0 with jnp's gather semantics: a negative
    index counts from the end, then every index clamps into the table."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def _take2(table, i, j):
    """``table[i, j]`` with jnp's gather semantics on both axes."""
    n, m = table.shape[:2]
    i, j = i.long(), j.long()
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    j = torch.where(j < 0, j + m, j).clamp(0, m - 1)
    return table[i, j]


def _rdiv(c, x):
    """``c / x`` for a number ``c``: one IEEE division (torch forms a
    number over a tensor as the reciprocal times the number)."""
    return torch.tensor(c, dtype=x.dtype, device=x.device) / x


def _pow4(x):
    """``x ** 4`` as jax.lax.integer_pow forms it."""
    x2 = x * x
    return x2 * x2


def level_sum(x):
    """``x`` summed over its first axis in order, as XLA's CPU reduction
    of a leading axis adds."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _tfn(od):
    """Linear-in-tau Planck transition function (the tfn_tbl contents,
    rrtmg_lw_ini :7958-7976)."""
    tr = torch.exp(-od)
    big = 1.0 - 2.0 * (1.0 / torch.clamp(od, min=1e-12)
                       - tr / torch.clamp(1.0 - tr, min=1e-12))
    return torch.where(od < 0.06, od * inv(6.0), big)


def _int_floor(x):
    return torch.floor(x).to(torch.int32)


# ==========================================================================
# setcoef (ra_rrtmg_lw.f90:3430-3930)
# ==========================================================================

def setcoef(pavel, tavel, tz, tbound, semiss, coldry, wkl, wbroad):
    """Interpolation indices/fractions + Planck functions
    (icar_tpu/physics/rrtmg_lw.py ``setcoef``). pavel/tavel: (nlay, N);
    tz: (nlay+1, N); tbound: (N,); semiss (N, 16); wkl: (7, nlay, N)."""
    k = consts(pavel.device)
    stpfac = 296.0 / 1013.0

    def planck_index(t):
        ind = torch.clamp(_int_floor(t - 159.0), 1, 180)
        frac = t - 159.0 - ind.to(torch.float32)
        return ind - 1, frac        # 0-based

    indbound, tbndfrac = planck_index(tbound)
    indlay, tlayfrac = planck_index(tavel)
    indlev, tlevfrac = planck_index(tz)

    def planck_interp(ind, frac):
        v0 = _take(k.tot, ind)
        v1 = _take(k.tot, ind + 1)
        return v0 + frac[..., None] * (v1 - v0)

    plankbnd = semiss * planck_interp(indbound, tbndfrac)
    planklay = planck_interp(indlay, tlayfrac)       # (nlay, N, 16)
    planklev = planck_interp(indlev, tlevfrac)       # (nlay+1, N, 16)

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
    tropo = plog > 4.56          # lower atmosphere mask

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
    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wkl[0]))
    factor_m = (tavel - 180.8) * inv(7.2)
    indminor = torch.clamp(_int_floor(factor_m), 1, 18)
    minorfrac = factor_m - indminor.to(torch.float32)

    def chi_rat(i, j, off=0):
        return (_take(k.chi_mls[i], jp0 + off)
                / _take(k.chi_mls[j], jp0 + off))

    rat = SimpleNamespace(
        h2oco2=chi_rat(0, 1), h2oco2_1=chi_rat(0, 1, 1),
        h2oo3=chi_rat(0, 2), h2oo3_1=chi_rat(0, 2, 1),
        h2on2o=chi_rat(0, 3), h2on2o_1=chi_rat(0, 3, 1),
        h2och4=chi_rat(0, 5), h2och4_1=chi_rat(0, 5, 1),
        n2oco2=chi_rat(3, 1), n2oco2_1=chi_rat(3, 1, 1),
        o3co2=chi_rat(2, 1), o3co2_1=chi_rat(2, 1, 1))

    def col(i):
        c = 1e-20 * wkl[i]
        return torch.where(c == 0.0, 1e-32 * coldry, c)

    colh2o = 1e-20 * wkl[0]
    compfp = 1.0 - fp
    return SimpleNamespace(
        tropo=tropo, jp=jp, jt=jt, jt1=jt1, fac00=compfp * (1.0 - ft),
        fac01=fp * (1.0 - ft1), fac10=compfp * ft, fac11=fp * ft1,
        forfac=colh2o * forfac, forfrac=forfrac, indfor=indfor,
        selffac=colh2o * selffac, selffrac=selffrac, indself=indself,
        indminor=indminor, minorfrac=minorfrac, scaleminor=scaleminor,
        scaleminorn2=scaleminorn2, rat=rat, colh2o=colh2o,
        colco2=col(1), colo3=col(2), coln2o=col(3), colco=col(4),
        colch4=col(5), colo2=1e-20 * wkl[6], colbrd=1e-20 * wbroad,
        plankbnd=plankbnd, planklay=planklay, planklev=planklev,
        pavel=pavel, coldry=coldry)


# ==========================================================================
# taumol helpers
# ==========================================================================

def _selffor(t, c):
    """Self + foreign continuum (shared by every band)."""
    selfref, forref = t["selfref"], t["forref"]
    inds0 = c.indself - 1
    indf0 = c.indfor - 1
    s0 = _take(selfref, inds0)
    f0 = _take(forref, indf0)
    tauself = c.selffac[..., None] * (
        s0 + c.selffrac[..., None] * (_take(selfref, inds0 + 1) - s0))
    taufor = c.forfac[..., None] * (
        f0 + c.forfrac[..., None] * (_take(forref, indf0 + 1) - f0))
    return tauself, taufor


def _ind_a(c, band):
    nsp = int(NSPA[band - 1])
    return (((c.jp - 1) * 5 + (c.jt - 1)) * nsp,
            (c.jp * 5 + (c.jt1 - 1)) * nsp)


def _ind_b(c, band):
    nsp = max(int(NSPB[band - 1]), 1)
    return (((c.jp - 13) * 5 + (c.jt - 1)) * nsp,
            ((c.jp - 12) * 5 + (c.jt1 - 1)) * nsp)


def _spec(col1, rat, col2, mult):
    """Binary-species parameters (speccomb, specparm, js (1-based), fs)."""
    speccomb = col1 + rat * col2
    specparm = torch.clamp(col1 / speccomb, max=ONEMINUS)
    specmult = mult * specparm
    js = 1 + _int_floor(specmult)
    fs = torch.fmod(specmult, 1.0)
    return speccomb, specparm, js, fs


def _major_1sp_c(table, ind0, ind1, c):
    """4-point (p, T) interpolation for single-species bands."""
    return (c.fac00[..., None] * _take(table, ind0)
            + c.fac10[..., None] * _take(table, ind0 + 1)
            + c.fac01[..., None] * _take(table, ind1)
            + c.fac11[..., None] * _take(table, ind1 + 1))


def _major_9sp_clipped(table, ind, fs, specparm, facA, facB, stride):
    """Lower-atmosphere eta interpolation with the specparm < 0.125 /
    > 0.875 end treatments (e.g. taugb3, ra_rrtmg_lw.f90:5159-5320)."""
    lo = specparm < 0.125
    hi = specparm > 0.875
    p = torch.where(lo, fs - 1.0, -fs)
    p4 = _pow4(p)
    fk0, fk1, fk2 = p4, 1.0 - p - 2.0 * p4, p + p4
    fA, fB = facA[..., None], facB[..., None]
    fk0e, fk1e, fk2e = fk0[..., None], fk1[..., None], fk2[..., None]
    fse = fs[..., None]

    def t(off):
        return _take(table, ind + off)
    mid = (fA * ((1.0 - fse) * t(0) + fse * t(1))
           + fB * ((1.0 - fse) * t(stride) + fse * t(stride + 1)))
    lo_v = (fA * (fk0e * t(0) + fk1e * t(1) + fk2e * t(2))
            + fB * (fk0e * t(stride) + fk1e * t(stride + 1)
                    + fk2e * t(stride + 2)))
    hi_v = (fA * (fk2e * t(-1) + fk1e * t(0) + fk0e * t(1))
            + fB * (fk2e * t(stride - 1) + fk1e * t(stride)
                    + fk0e * t(stride + 1)))
    return torch.where(lo[..., None], lo_v,
                       torch.where(hi[..., None], hi_v, mid))


def _minor_eta(kminor, jm, fm, indm, minorfrac):
    """Minor gas with eta + temperature interpolation; kminor
    (neta, 19, g)."""
    jm0 = jm - 1
    im0 = indm - 1
    mfe = minorfrac[..., None]
    fme = fm[..., None]
    a = _take2(kminor, jm0, im0)
    m1 = a + fme * (_take2(kminor, jm0 + 1, im0) - a)
    b = _take2(kminor, jm0, im0 + 1)
    m2 = b + fme * (_take2(kminor, jm0 + 1, im0 + 1) - b)
    return m1 + mfe * (m2 - m1)


def _minor_t(kminor, indm, minorfrac):
    """Minor gas with temperature-only interpolation; kminor (19, g)."""
    im0 = indm - 1
    a = _take(kminor, im0)
    return a + minorfrac[..., None] * (_take(kminor, im0 + 1) - a)


def _planck_eta(fracref, jpl, fpl):
    """Eta-interpolated Planck fraction; fracref (g, 9) or (g, 5)."""
    f = fracref.T     # (eta, g)
    j0 = jpl - 1
    a = _take(f, j0)
    return a + fpl[..., None] * (_take(f, j0 + 1) - a)


def _adjcol(colgas, coldry, jp, chi_index, thresh, base, expo, chi_mls,
            chi_ref=None):
    """Empirical high-concentration adjustment for minor-gas columns
    (e.g. n2o in band 3, :5124-5131)."""
    q = 1e20 * (colgas / coldry)
    if chi_ref is None:
        chi = _take(chi_mls[chi_index], jp)
        ratio = q / chi
    else:
        chi = chi_ref
        ratio = q * inv(chi_ref)
    adjfac = base + torch.pow(ratio - base, expo)
    adj = adjfac * chi * coldry * 1e-20
    return torch.where(ratio > thresh, adj, colgas)


def _band_2sp_lower(t, c, band, col1, col2, rat0, rat1, mult=8.0):
    """Shared lower-atmosphere two-species major absorption."""
    nsp = int(NSPA[band - 1])
    sc0, sp0, js0, fs0 = _spec(col1, rat0, col2, mult)
    sc1, sp1, js1, fs1 = _spec(col1, rat1, col2, mult)
    base0, base1 = _ind_a(c, band)
    tmaj0 = sc0[..., None] * _major_9sp_clipped(
        t["absa"], base0 + js0 - 1, fs0, sp0, c.fac00, c.fac10, nsp)
    tmaj1 = sc1[..., None] * _major_9sp_clipped(
        t["absa"], base1 + js1 - 1, fs1, sp1, c.fac01, c.fac11, nsp)
    return tmaj0 + tmaj1


def _band_2sp_upper(t, c, band, col1, col2, rat0, rat1, mult=4.0):
    """Upper-atmosphere two-species (5-bin eta, linear interpolation)."""
    nsp = max(int(NSPB[band - 1]), 1)
    sc0, sp0, js0, fs0 = _spec(col1, rat0, col2, mult)
    sc1, sp1, js1, fs1 = _spec(col1, rat1, col2, mult)
    base0, base1 = _ind_b(c, band)
    ind0 = base0 + js0 - 1
    ind1 = base1 + js1 - 1
    fA0, fB0 = c.fac00[..., None], c.fac10[..., None]
    fA1, fB1 = c.fac01[..., None], c.fac11[..., None]
    fs0e, fs1e = fs0[..., None], fs1[..., None]
    absb = t["absb"]
    tmaj0 = sc0[..., None] * (
        fA0 * ((1 - fs0e) * _take(absb, ind0)
               + fs0e * _take(absb, ind0 + 1))
        + fB0 * ((1 - fs0e) * _take(absb, ind0 + nsp)
                 + fs0e * _take(absb, ind0 + nsp + 1)))
    tmaj1 = sc1[..., None] * (
        fA1 * ((1 - fs1e) * _take(absb, ind1)
               + fs1e * _take(absb, ind1 + 1))
        + fB1 * ((1 - fs1e) * _take(absb, ind1 + nsp)
                 + fs1e * _take(absb, ind1 + nsp + 1)))
    return tmaj0 + tmaj1


def _planck_spec(col1, refrat, col2, mult, fracref):
    _, _, jpl, fpl = _spec(col1, refrat, col2, mult)
    return _planck_eta(fracref, jpl, fpl)


def taumol(tables, c, wx):
    """Gas optical depth + Planck fractions for all 140 g-points
    (taumol + taugb1..16, ra_rrtmg_lw.f90:4714-7930). ``tables`` on the
    columns' device (``device_tables``). Returns taug, fracs with shape
    (nlay, N, 140)."""
    dev = c.pavel.device
    chi_mls = consts(dev).chi_mls
    tropo = c.tropo[..., None]
    parts_tau, parts_frac = [], []
    chi_np = np.asarray(_DATA["chi_mls"])

    def refrat(i1, i2, jref):
        return float(chi_np[i1, jref - 1] / chi_np[i2, jref - 1])

    def vec(values):
        return torch.tensor(values, dtype=torch.float32, device=dev)

    def where_tropo(lower, upper):
        return torch.where(tropo, lower, upper)

    # ---- band 1: h2o, minor n2 (lower+upper) --------------------------
    t = tables[0]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 1)
    b0b, b1b = _ind_b(c, 1)
    pp = c.pavel
    corradj_l = torch.where(pp < 250.0,
                            1.0 - 0.15 * (250.0 - pp) * inv(154.4),
                            torch.ones_like(pp))
    corradj_u = 1.0 - 0.15 * (pp * inv(95.6))
    scalen2 = c.colbrd * c.scaleminorn2
    taun2_l = scalen2[..., None] * _minor_t(t["ka_mn2"], c.indminor,
                                            c.minorfrac)
    taun2_u = scalen2[..., None] * _minor_t(t["kb_mn2"], c.indminor,
                                            c.minorfrac)
    tau_l = corradj_l[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
        + tauself + taufor + taun2_l)
    tau_u = corradj_u[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
        + taufor + taun2_u)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 2: h2o ---------------------------------------------------
    t = tables[1]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 2)
    b0b, b1b = _ind_b(c, 2)
    corradj = 1.0 - 0.05 * (c.pavel - 100.0) * inv(900.0)
    tau_l = corradj[..., None] * (
        c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
        + tauself + taufor)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 3: h2o+co2, minor n2o ------------------------------------
    t = tables[2]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 3, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 3, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    _, _, jmn2o_l, fmn2o_l = _spec(c.colh2o, refrat(0, 1, 3), c.colco2,
                                   8.0)
    _, _, jmn2o_u, fmn2o_u = _spec(c.colh2o, refrat(0, 1, 13), c.colco2,
                                   4.0)
    absn2o_l = _minor_eta(t["ka_mn2o"], jmn2o_l, fmn2o_l, c.indminor,
                          c.minorfrac)
    absn2o_u = _minor_eta(t["kb_mn2o"], jmn2o_u, fmn2o_u, c.indminor,
                          c.minorfrac)
    adjcoln2o = _adjcol(c.coln2o, c.coldry, c.jp, 3, 1.5, 0.5, 0.65,
                        chi_mls)
    tau_l = tmaj_l + tauself + taufor + adjcoln2o[..., None] * absn2o_l
    tau_u = tmaj_u + taufor + adjcoln2o[..., None] * absn2o_u
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 9), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colh2o, refrat(0, 1, 13), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, fr_u))

    # ---- band 4: h2o+co2 lower, o3+co2 upper ---------------------------
    t = tables[3]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 4, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 4, c.colo3, c.colco2,
                             c.rat.o3co2, c.rat.o3co2_1)
    tau_l = tmaj_l + tauself + taufor
    # stratospheric empirical adjustments on g-points 8-14 (:5551-5557)
    tau_u = tmaj_u * vec([1.0] * 7 + [0.92, 0.88, 1.07, 1.1, 0.99, 0.88,
                                      0.943])
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 11), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colo3, refrat(2, 1, 13), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, fr_u))

    # ---- band 5: h2o+co2 lower (minor o3, ccl4), o3+co2 upper ----------
    t = tables[4]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 5, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tmaj_u = _band_2sp_upper(t, c, 5, c.colo3, c.colco2,
                             c.rat.o3co2, c.rat.o3co2_1)
    _, _, jmo3, fmo3 = _spec(c.colh2o, refrat(0, 1, 7), c.colco2, 8.0)
    abso3 = _minor_eta(t["ka_mo3"], jmo3, fmo3, c.indminor, c.minorfrac)
    tau_ccl4 = wx[0][..., None] * t["ccl4"]
    tau_l = tmaj_l + tauself + taufor \
        + c.colo3[..., None] * abso3 + tau_ccl4
    tau_u = tmaj_u + tau_ccl4
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 5), c.colco2, 8.0,
                        t["fracrefa"])
    fr_u = _planck_spec(c.colo3, refrat(2, 1, 43), c.colco2, 4.0,
                        t["fracrefb"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, fr_u))

    # ---- band 6: h2o lower (minor co2, cfc11, cfc12); nothing upper ----
    t = tables[5]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 6)
    adjcolco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.77,
                        chi_mls)
    absco2 = _minor_t(t["ka_mco2"], c.indminor, c.minorfrac)
    tau_cfc = (wx[1][..., None] * t["cfc11adj"]
               + wx[2][..., None] * t["cfc12"])
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + adjcolco2[..., None] * absco2
             + tau_cfc)
    parts_tau.append(where_tropo(tau_l, tau_cfc))
    parts_frac.append(t["fracrefa"].expand(tau_l.shape))

    # ---- band 7: h2o+o3 lower (minor co2), o3 upper (minor co2) --------
    t = tables[6]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 7, c.colh2o, c.colo3,
                             c.rat.h2oo3, c.rat.h2oo3_1)
    _, _, jmco2, fmco2 = _spec(c.colh2o, refrat(0, 2, 3), c.colo3, 8.0)
    absco2_l = _minor_eta(t["ka_mco2"], jmco2, fmco2, c.indminor,
                          c.minorfrac)
    adjco2_l = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 3.0, 0.79,
                       chi_mls)
    adjco2_u = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.79,
                       chi_mls)
    absco2_u = _minor_t(t["kb_mco2"], c.indminor, c.minorfrac)
    b0b, b1b = _ind_b(c, 7)
    tau_l = tmaj_l + tauself + taufor + adjco2_l[..., None] * absco2_l
    tau_u = (c.colo3[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjco2_u[..., None] * absco2_u) \
        * vec([1.0] * 5 + [0.92, 0.88, 1.07, 1.1, 0.99, 0.855, 1.0])
    fr_l = _planck_spec(c.colh2o, refrat(0, 2, 3), c.colo3, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, t["fracrefb"]))

    # ---- band 8: h2o lower / o3 upper; minors co2,o3,n2o + cfcs --------
    t = tables[7]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 8)
    b0b, b1b = _ind_b(c, 8)
    adjco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.65, chi_mls)
    absco2_l = _minor_t(t["ka_mco2"], c.indminor, c.minorfrac)
    abso3_l = _minor_t(t["ka_mo3"], c.indminor, c.minorfrac)
    absn2o_l = _minor_t(t["ka_mn2o"], c.indminor, c.minorfrac)
    absco2_u = _minor_t(t["kb_mco2"], c.indminor, c.minorfrac)
    absn2o_u = _minor_t(t["kb_mn2o"], c.indminor, c.minorfrac)
    tau_cfc = (wx[2][..., None] * t["cfc12"]
               + wx[3][..., None] * t["cfc22adj"])
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + adjco2[..., None] * absco2_l
             + c.colo3[..., None] * abso3_l
             + c.coln2o[..., None] * absn2o_l + tau_cfc)
    tau_u = (c.colo3[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjco2[..., None] * absco2_u
             + c.coln2o[..., None] * absn2o_u + tau_cfc)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 9: h2o+ch4 lower (minor n2o), ch4 upper (minor n2o) ------
    t = tables[8]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 9, c.colh2o, c.colch4,
                             c.rat.h2och4, c.rat.h2och4_1)
    _, _, jmn2o, fmn2o = _spec(c.colh2o, refrat(0, 5, 3), c.colch4, 8.0)
    absn2o_l = _minor_eta(t["ka_mn2o"], jmn2o, fmn2o, c.indminor,
                          c.minorfrac)
    absn2o_u = _minor_t(t["kb_mn2o"], c.indminor, c.minorfrac)
    adjn2o = _adjcol(c.coln2o, c.coldry, c.jp, 3, 1.5, 0.5, 0.65, chi_mls)
    b0b, b1b = _ind_b(c, 9)
    tau_l = tmaj_l + tauself + taufor + adjn2o[..., None] * absn2o_l
    tau_u = (c.colch4[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + adjn2o[..., None] * absn2o_u)
    fr_l = _planck_spec(c.colh2o, refrat(0, 5, 9), c.colch4, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, t["fracrefb"]))

    # ---- band 10: h2o both ---------------------------------------------
    t = tables[9]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 10)
    b0b, b1b = _ind_b(c, 10)
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 11: h2o both, minor o2 -----------------------------------
    t = tables[10]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 11)
    b0b, b1b = _ind_b(c, 11)
    scaleo2 = (c.colo2 * c.scaleminor)[..., None]
    tauo2_l = scaleo2 * _minor_t(t["ka_mo2"], c.indminor, c.minorfrac)
    tauo2_u = scaleo2 * _minor_t(t["kb_mo2"], c.indminor, c.minorfrac)
    tau_l = (c.colh2o[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor + tauo2_l)
    tau_u = (c.colh2o[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
             + taufor + tauo2_u)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 12: h2o+co2 lower; nothing upper -------------------------
    t = tables[11]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 12, c.colh2o, c.colco2,
                             c.rat.h2oco2, c.rat.h2oco2_1)
    tau_l = tmaj_l + tauself + taufor
    fr_l = _planck_spec(c.colh2o, refrat(0, 1, 10), c.colco2, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, torch.zeros_like(tau_l)))
    parts_frac.append(where_tropo(fr_l, torch.zeros_like(fr_l)))

    # ---- band 13: h2o+n2o lower (minors co2, co); o3 minor upper -------
    t = tables[12]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 13, c.colh2o, c.coln2o,
                             c.rat.h2on2o, c.rat.h2on2o_1)
    _, _, jmco2, fmco2 = _spec(c.colh2o, refrat(0, 3, 1), c.coln2o, 8.0)
    absco2 = _minor_eta(t["ka_mco2"], jmco2, fmco2, c.indminor,
                        c.minorfrac)
    adjco2 = _adjcol(c.colco2, c.coldry, c.jp, 1, 3.0, 2.0, 0.68, chi_mls,
                     chi_ref=3.55e-4)
    _, _, jmco, fmco = _spec(c.colh2o, refrat(0, 3, 3), c.coln2o, 8.0)
    absco = _minor_eta(t["ka_mco"], jmco, fmco, c.indminor, c.minorfrac)
    tau_l = tmaj_l + tauself + taufor \
        + adjco2[..., None] * absco2 + c.colco[..., None] * absco
    tau_u = c.colo3[..., None] * _minor_t(t["kb_mo3"], c.indminor,
                                          c.minorfrac)
    fr_l = _planck_spec(c.colh2o, refrat(0, 3, 5), c.coln2o, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, t["fracrefb"]))

    # ---- band 14: co2 both ----------------------------------------------
    t = tables[13]
    tauself, taufor = _selffor(t, c)
    b0a, b1a = _ind_a(c, 14)
    b0b, b1b = _ind_b(c, 14)
    tau_l = (c.colco2[..., None] * _major_1sp_c(t["absa"], b0a, b1a, c)
             + tauself + taufor)
    tau_u = c.colco2[..., None] * _major_1sp_c(t["absb"], b0b, b1b, c)
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(t["fracrefa"], t["fracrefb"]))

    # ---- band 15: n2o+co2 lower (minor n2); nothing upper ---------------
    t = tables[14]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 15, c.coln2o, c.colco2,
                             c.rat.n2oco2, c.rat.n2oco2_1)
    _, _, jmn2, fmn2 = _spec(c.coln2o, refrat(3, 1, 1), c.colco2, 8.0)
    absn2 = _minor_eta(t["ka_mn2"], jmn2, fmn2, c.indminor, c.minorfrac)
    scalen2 = (c.colbrd * c.scaleminor)[..., None]
    tau_l = tmaj_l + tauself + taufor + scalen2 * absn2
    fr_l = _planck_spec(c.coln2o, refrat(3, 1, 1), c.colco2, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, torch.zeros_like(tau_l)))
    parts_frac.append(where_tropo(fr_l, torch.zeros_like(fr_l)))

    # ---- band 16: h2o+ch4 lower, ch4 upper -------------------------------
    t = tables[15]
    tauself, taufor = _selffor(t, c)
    tmaj_l = _band_2sp_lower(t, c, 16, c.colh2o, c.colch4,
                             c.rat.h2och4, c.rat.h2och4_1)
    tau_l = tmaj_l + tauself + taufor
    # NOTE reference quirk preserved: nspb(16) = 0 collapses the upper
    # index to absb row 1 regardless of (jp, jt) (lwdatinit :8078)
    z16 = torch.zeros_like(c.jp)
    tau_u = c.colch4[..., None] * _major_1sp_c(t["absb"], z16, z16, c)
    fr_l = _planck_spec(c.colh2o, refrat(0, 5, 6), c.colch4, 8.0,
                        t["fracrefa"])
    parts_tau.append(where_tropo(tau_l, tau_u))
    parts_frac.append(where_tropo(fr_l, t["fracrefb"]))

    # the JAX package's clamp of a negative gas optical depth (a
    # T-extrapolation outside the k-table range)
    taug = torch.clamp(torch.cat(parts_tau, dim=-1), min=0.0)
    fracs = torch.cat([f.expand(taug.shape[:-1] + f.shape[-1:])
                       for f in parts_frac], dim=-1)
    return taug, fracs


# ==========================================================================
# McICA subcolumn cloud sampling (mcica_subcol_lw)
# ==========================================================================

def mcica_subcol(cdf, cldfrac, ciwp, clwp, cswp, icld=1):
    """Stochastic subcolumn cloud generator on the uniform draw ``cdf``
    (nlay, N, ngpt) (icar_tpu/physics/rrtmg_lw.py ``mcica_subcol_lw`` and
    rrtmg_sw.py ``mcica_subcol_sw``, the same but for their g-point count
    and their draw, ``jax.random.uniform``); cldfrac etc. (nlay, N).
    icld=1: random overlap; icld >= 2: maximum-random, the layer above's
    draw reused where it was cloudy, scanned from the top down (the first
    step compares the top layer with itself, as the JAX scan's roll
    does). Returns the cloud masks and in-cloud paths (nlay, N, ngpt)."""
    if icld >= 2:
        nlay = cldfrac.shape[0]
        out = [None] * nlay
        above = cdf[nlay - 1]
        out[nlay - 1] = above
        for k in range(nlay - 2, -1, -1):
            above = torch.where(above > 1.0 - cldfrac[k + 1][..., None],
                                above, cdf[k])
            out[k] = above
        cdf = torch.stack(out)
    cldy = cdf > (1.0 - cldfrac[..., None])
    zero = torch.zeros((), dtype=cdf.dtype, device=cdf.device)
    return (cldy.to(torch.float32),
            torch.where(cldy, ciwp[..., None], zero),
            torch.where(cldy, clwp[..., None], zero),
            torch.where(cldy, cswp[..., None], zero))


# ==========================================================================
# cloud optical depths (cldprmc, ra_rrtmg_lw.f90:2673-2968)
# ==========================================================================

def cldprmc(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res):
    """In-cloud LW optical depth per g-point; inflag>=2, iceflag=4
    (absice3), liqflag=1 (absliq1), the snow path with the ice
    coefficients."""
    k = consts(cldfmc.device)
    a3 = k.absice3[:, k.ngb0]             # (46, ngpt)

    def ice(rad):
        factor = (torch.clamp(rad, 5.0, 140.0) - 2.0) * inv(3.0)
        index = torch.clamp(factor.to(torch.int32), 1, 45)
        fint = factor - index.to(torch.float32)
        lo = _take(a3, index - 1)
        return lo + fint[..., None] * (_take(a3, index) - lo)

    absco_ice = ice(rei)
    absco_sno = ice(res)
    radliq = torch.clamp(rel, 2.5, 60.0)
    il = torch.clamp((radliq - 1.5).to(torch.int32), 1, 57)
    fintl = radliq - 1.5 - il.to(torch.float32)
    l1 = k.absliq1[:, k.ngb0]             # (58, ngpt)
    lo = _take(l1, il - 1)
    absco_liq = lo + fintl[..., None] * (_take(l1, il) - lo)

    taucmc = (ciwpmc * absco_ice + clwpmc * absco_liq
              + cswpmc * absco_sno)
    cwp = ciwpmc + clwpmc + cswpmc
    active = (cldfmc >= 1e-20) & (cwp >= 1e-20)
    return torch.where(active, taucmc, torch.zeros_like(taucmc))


# ==========================================================================
# radiative transfer (rtrnmc, ra_rrtmg_lw.f90:2972-3458)
# ==========================================================================

def rtrnmc(semiss_bnd, pwvcm, cldfmc, taucmc, planklay, planklev,
           plankbnd, fracs, taut):
    """Upward/downward LW fluxes with McICA cloud sampling; the JAX
    package's two level scans as loops in its order. Shapes:
    taut/fracs/cldfmc/taucmc (nlay, N, ngpt); planklay (nlay, N, 16);
    planklev (nlay+1, N, 16); plankbnd/semiss_bnd (N, 16). Returns
    (totuflux, totdflux, totuclfl, totdclfl) at (nlay+1, N)."""
    nlay, N, ngpt = taut.shape
    k = consts(taut.device)
    ngb0 = k.ngb0

    sec = k.a0[None] + k.a1[None] * torch.exp(k.a2[None] * pwvcm[:, None])
    sec = torch.clamp(sec, 1.50, 1.80)
    secdiff = torch.where(k.fixed[None], torch.full_like(sec, 1.66), sec)
    secg = secdiff[:, ngb0]                          # (N, ngpt)

    planklay_g = planklay[:, :, ngb0]
    planklev_g = planklev[:, :, ngb0]
    plankbnd_g = plankbnd[:, ngb0]

    zero = torch.zeros((), dtype=taut.dtype, device=taut.device)
    odepth = torch.clamp(secg[None] * taut, min=0.0)
    odcld = secg[None] * taucmc
    cloudy = cldfmc == 1.0
    abscld = torch.where(cloudy, 1.0 - torch.exp(-odcld), zero)
    efclfrac = abscld * cldfmc
    icldlyr = torch.any(cloudy, dim=-1)              # (nlay, N)

    odtot = odepth + torch.where(cloudy, odcld, zero)
    atrans = 1.0 - torch.exp(-odepth)
    atot = 1.0 - torch.exp(-odtot)
    tfacgas = _tfn(odepth)
    tfactot = _tfn(odtot)

    blay = planklay_g
    dplankup = planklev_g[1:] - blay
    dplankdn = planklev_g[:-1] - blay
    bbdgas = fracs * (blay + tfacgas * dplankdn)
    bbugas = fracs * (blay + tfacgas * dplankup)
    bbdtot = fracs * (blay + tfactot * dplankdn)
    bbutot = fracs * (blay + tfactot * dplankup)
    gassrc_dn = bbdgas * atrans
    cld = icldlyr[..., None].expand(nlay, N, ngpt)

    # downward sweep (surface-directed), from the top layer
    radld = torch.zeros((N, ngpt), dtype=taut.dtype, device=taut.device)
    radclrd = radld
    iclddn = torch.zeros((N, ngpt), dtype=torch.bool, device=taut.device)
    drad, dclr = [None] * nlay, [None] * nlay
    for lev in range(nlay - 1, -1, -1):
        at, efcl, cf = atrans[lev], efclfrac[lev], cldfmc[lev]
        gsrc = gassrc_dn[lev]
        rad_cld = (radld - radld * (at + efcl * (1.0 - at)) + gsrc
                   + cf * (bbdtot[lev] * atot[lev] - gsrc))
        rad_clr = radld + (bbdgas[lev] - radld) * at
        radld = torch.where(cld[lev], rad_cld, rad_clr)
        iclddn = iclddn | cld[lev]
        radclrd = torch.where(iclddn,
                              radclrd + (bbdgas[lev] - radclrd) * at, radld)
        drad[lev], dclr[lev] = radld, radclrd

    # surface reflection + upward sweep
    rad0 = fracs[0] * plankbnd_g
    reflect = 1.0 - semiss_bnd[:, ngb0]
    radlu = rad0 + reflect * drad[0]
    radclru = rad0 + reflect * dclr[0]
    urad, uclr = [radlu], [radclru]
    for lev in range(nlay):
        at, efcl, cf = atrans[lev], efclfrac[lev], cldfmc[lev]
        gassrc = bbugas[lev] * at
        rad_cld = (radlu - radlu * (at + efcl * (1.0 - at)) + gassrc
                   + cf * (bbutot[lev] * atot[lev] - gassrc))
        rad_clr = radlu + (bbugas[lev] - radlu) * at
        radlu = torch.where(cld[lev], rad_cld, rad_clr)
        radclru = radclru + (bbugas[lev] - radclru) * at
        urad.append(radlu)
        uclr.append(radclru)

    # band-integrated fluxes (wtdiff * delwave summed over g-points)
    delw_g = k.delwave[ngb0]

    def flux(rad):
        return torch.sum(rad * WTDIFF * delw_g, dim=-1) * FLUXFAC

    top = torch.zeros_like(radlu)
    return (flux(torch.stack(urad)), flux(torch.stack(drad + [top])),
            flux(torch.stack(uclr)), flux(torch.stack(dclr + [top])))


# ==========================================================================
# profile construction + top-level driver (inatm + rrtmg_lw + the WRF
# rrtmg_lwrad wrapper, ra_rrtmg_lw.f90:10600-12800)
# ==========================================================================

def _o3_profile(pavel_hpa):
    """The climatological O3 mass mixing ratio on layer pressures (O3DATA
    + the wrapper's o3 fill; annual-mean profile), interpolated in log p
    as jnp.interp does."""
    k = consts(pavel_hpa.device)
    xp, fp = k.logp_ref, k.o3_ref
    x = torch.log(torch.clamp(pavel_hpa, float(_PPSUM[-1]),
                              float(_PPSUM[0])))
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def rrtmg_lw_rad(tables, play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr,
                 cldfrac, ciwp, clwp, cswp, rei, rel, res, emis, cdf,
                 icld=1, co2vmr=CO2VMR, n2ovmr=N2OVMR, ch4vmr=CH4VMR,
                 cfc11vmr=CFC11VMR, cfc12vmr=CFC12VMR, cfc22vmr=CFC22VMR,
                 ccl4vmr=CCL4VMR):
    """Full LW calculation on (nlay, N) columns (icar_tpu/physics/
    rrtmg_lw.py ``rrtmg_lw_rad``, its PRNG key replaced by the McICA draw
    ``cdf`` (nlay, N, 140)). play/tlay: (nlay, N) [hPa]/[K]; plev/tlev:
    (nlay+1, N) interfaces (index 0 = surface); water paths in g/m2;
    effective radii in microns; emis (N,). Returns a namespace with fluxes
    (nlay+1, N) and the heating rate (nlay, N) [K/day]."""
    nlay, N = play.shape
    dpg = plev[:-1] - plev[1:]
    coldry = dpg * 1e3 * AVOGAD / (1e2 * GRAV * AMD * (
        1.0 + h2ovmr * AMW * inv(AMD)))
    wkl = torch.stack([
        h2ovmr * coldry, co2vmr * coldry, o3vmr * coldry,
        n2ovmr * coldry, torch.zeros_like(coldry),     # CO neglected
        ch4vmr * coldry, O2VMR * coldry])
    wbroad = coldry * (1.0 - (h2ovmr + co2vmr + o3vmr + n2ovmr + ch4vmr
                              + O2VMR))
    wx = [ccl4vmr * coldry * 1e-20, cfc11vmr * coldry * 1e-20,
          cfc12vmr * coldry * 1e-20, cfc22vmr * coldry * 1e-20]
    amttl = level_sum(wkl[0])
    pwvcm = amttl * (AMW / AVOGAD) * inv(0.9982)

    semiss = emis[:, None].expand(N, 16)
    c = setcoef(play, tlay, tlev, tsfc, semiss, coldry, wkl, wbroad)
    taug, fracs = taumol(tables, c, wx)

    cldfmc, ciwpmc, clwpmc, cswpmc = mcica_subcol(
        cdf, cldfrac, ciwp, clwp, cswp, icld)
    taucmc = cldprmc(cldfmc, ciwpmc, clwpmc, cswpmc, rei, rel, res)

    uf, df, ufc, dfc = rtrnmc(semiss, pwvcm, cldfmc, taucmc, c.planklay,
                              c.planklev, c.plankbnd, fracs, taug)
    fnet = uf - df
    htr = HEATFAC * (fnet[:-1] - fnet[1:]) / dpg
    return SimpleNamespace(uflx=uf, dflx=df, uflxc=ufc, dflxc=dfc,
                           htr=htr, glw=df[0], olr=uf[-1])


def column_chunked(fn, cols, n, chunk):
    """Run ``fn(c, n_chunks, *col_chunks) -> dict`` over column chunks
    (icar_tpu/physics/rrtmg_lw.py ``column_chunked``): ``cols`` are
    tensors whose last axis is the column axis (1-D or 2-D); the last
    chunk is padded with the edge column, as jnp.pad's "edge" mode; the
    outputs are joined back on the column axis. ``n_chunks`` is 1 when
    the columns fit one chunk (the JAX package then draws with the
    interval's key unsplit)."""
    if n <= chunk:
        return fn(0, 1, *cols)
    C = -(-n // chunk)
    npad = C * chunk - n

    def part(a, c):
        if npad:
            a = torch.cat([a, a[..., -1:].expand(
                *a.shape[:-1], npad)], dim=-1)
        return a[..., c * chunk:(c + 1) * chunk]

    outs = [fn(c, C, *(part(a, c) for a in cols)) for c in range(C)]
    return {k: torch.cat([o[k] for o in outs], dim=-1)[..., :n]
            for k in outs[0]}


class TorchCdf:
    """The port's own McICA draw: a uniform float32 draw of the shape
    asked, from a ``torch.Generator`` seeded from what the JAX package's
    key folds (88, the int32 substep time ``t``, 1 for the shortwave) and
    the chunk index, so a run repeats itself with no global RNG. The
    generator lives on the device the draw is for, or on ``on`` (e.g.
    "cpu": the draw is then moved, so that the CPU and the card see the
    same values)."""

    def __init__(self, on=None):
        self.on = on

    def __call__(self, kind, t, chunk, n_chunks, shape, device):
        src = torch.device(self.on if self.on is not None else device)
        seed = (((88 << 32) + (int(t) & 0xFFFFFFFF)) * 2
                + (kind == "sw")) * 65536 + chunk
        g = torch.Generator(device=src)
        g.manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
        draw = torch.rand(shape, generator=g, device=src,
                          dtype=torch.float32)
        return draw.to(device)


class BlockCdf:
    """The McICA draws of a block of a sharded domain: each of the block's
    columns takes the draw it takes in the whole domain's call. ``cdf`` is
    the domain's source (``TorchCdf``, or the tests' JAX draws),
    ``columns`` the domain's row-major index of each block column (in the
    block's row-major order, ``parallel.mesh.Shard.columns``), ``n`` the
    domain's column count. The block's drivers call it with their own
    chunks (``column_chunked`` over the block's columns); for each, the
    domain's chunks that hold those columns are drawn at the domain's
    chunk shape and index, and their columns gathered. Never draw per
    block: a draw's values follow its chunk and shape."""

    def __init__(self, cdf, columns, n):
        self.cdf, self.columns, self.n = cdf, np.asarray(columns), int(n)

    def __call__(self, kind, t, chunk, n_chunks, shape, device):
        ch = RRTMG_COL_CHUNK
        # the block's columns of this chunk; the last chunk is padded with
        # the edge column, as column_chunked pads it
        local = np.minimum(np.arange(chunk * ch, chunk * ch + shape[1]),
                           len(self.columns) - 1)
        cols = self.columns[local]
        one = self.n <= ch
        whole = self.n if one else ch
        n_whole = 1 if one else -(-self.n // ch)
        gchunk, pos = cols // whole, cols % whole
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for c in np.unique(gchunk):
            sel = np.nonzero(gchunk == c)[0]
            draw = self.cdf(kind, t, int(c), n_whole,
                            (shape[0], whole) + tuple(shape[2:]), device)
            out[:, torch.as_tensor(sel, device=device)] = draw[
                :, torch.as_tensor(pos[sel], device=device)]
        return out


def flat_columns(a):
    """(n, ny, nx) or (ny, nx) -> (n, N) or (N,)."""
    return a.reshape(*a.shape[:-2], a.shape[-2] * a.shape[-1])


def rrtmg_lw_driver(tables, cdf, t, p3d, p8w, t3d, t8w, tsk, qv3d, qc3d,
                    qi3d, qs3d, cldfra3d, re_cloud, re_ice, re_snow,
                    rho3d, dz8w, emiss, exner, xland=None,
                    snow_optics=False, ghg=None):
    """ICAR-facing wrapper (RRTMG_LWRAD, ra_rrtmg_lw.f90:10600-12800;
    icar_tpu/physics/rrtmg_lw.py ``rrtmg_lw_driver``): (z, y, x) fields
    -> columns, unit conversions, cloud water paths, effective-radius
    floors -> ``rrtmg_lw_rad`` per chunk of ``RRTMG_COL_CHUNK`` columns ->
    theta tendency. ``tables`` on the fields' device (``device_tables``);
    ``cdf(kind, t, chunk, n_chunks, shape, device)`` gives each chunk's
    McICA draw (kind "lw"; ``t`` the substep's time in the interval,
    whose int32 the JAX key folds). Returns (th_tendency [K/s on theta],
    glw, olr, lwcf)."""
    nz, ny, nx = p3d.shape
    N = ny * nx
    flat = flat_columns
    play = flat(p3d) * inv(100.0)
    tlay = flat(t3d)
    ptop = torch.maximum(2.0 * p3d[-1] - p8w[-1], p8w[-1] * 0.5)
    plev = torch.cat([flat(p8w), flat(ptop)[None]], dim=0) * inv(100.0)
    ttop = 2.0 * t3d[-1] - t8w[-1]
    tlev = torch.cat([flat(t8w), flat(ttop)[None]], dim=0)
    tsfc = flat(tsk)
    h2ovmr = flat(qv3d) * (AMD / AMW)
    o3vmr = _o3_profile(play) * (AMD / 47.9982)   # mass mr -> vmr

    cf = torch.clamp(flat(cldfra3d), 0.0, 1.0)
    zero = torch.zeros((), dtype=cf.dtype, device=cf.device)

    def gwp(q):
        return torch.where(cf > 0.0, 1000.0 * flat(q * rho3d * dz8w)
                           / torch.clamp(cf, min=1e-3), zero)
    clwp = gwp(qc3d)
    ciwp = gwp(qi3d)
    # NOTE reference quirk preserved: the wrapper zeroes qs1d, so snow
    # never reaches the LW cloud optics (ra_rrtmg_lw.f90:12082-12088)
    cswp = gwp(qs3d) if snow_optics else torch.zeros_like(clwp)

    rel = torch.clamp(flat(re_cloud) * 1e6, min=2.5)
    if xland is None:
        rel_fb = torch.full_like(rel, 7.5)
    else:
        rel_fb = torch.where(flat(xland)[None] > 1.5,
                             torch.full_like(rel, 10.5),
                             torch.full_like(rel, 7.5))
    rel = torch.where((rel <= 2.5) & (cf > 0.0), rel_fb, rel)
    rei = torch.clamp(flat(re_ice) * 1e6, min=5.0)
    res = torch.clamp(flat(re_snow) * 1e6, min=10.0)

    gkw = {} if ghg is None else dict(
        co2vmr=float(ghg.co2), n2ovmr=float(ghg.n2o),
        ch4vmr=float(ghg.ch4), cfc11vmr=float(ghg.cfc11),
        cfc12vmr=float(ghg.cfc12))

    def rad_chunk(chunk, n_chunks, play, plev, tlay, tlev, tsfc, h2o, o3,
                  cfc, ciw, clw, csw, rei_c, rel_c, res_c, em):
        draw = cdf("lw", t, chunk, n_chunks, (play.shape[0],
                                              play.shape[1], NGPTLW),
                   play.device)
        o = rrtmg_lw_rad(tables, play, plev, tlay, tlev, tsfc, h2o, o3,
                         cfc, ciw, clw, csw, rei_c, rel_c, res_c, em, draw,
                         **gkw)
        # LWCF = clear-sky OLR minus all-sky OLR (ra_rrtmg_lw.f90:12731)
        return dict(htr=o.htr, glw=o.glw, olr=o.olr,
                    lwcf=o.uflxc[-1] - o.uflx[-1])

    out = column_chunked(
        rad_chunk,
        (play, plev, tlay, tlev, tsfc, h2ovmr, o3vmr, cf, ciwp, clwp,
         cswp, rei, rel, res, flat(emiss)), N, RRTMG_COL_CHUNK)
    # tendency on potential temperature (rthratenlw = htr/86400/pii)
    th_tend = (out["htr"] * inv(86400.0)).reshape(nz, ny, nx) / exner
    return (th_tend, out["glw"].reshape(ny, nx),
            out["olr"].reshape(ny, nx), out["lwcf"].reshape(ny, nx))


# --------------------------------------------------------------------------
# table resolution for model runs (rrtmg_lwinit, ra_driver.f90:67-75)
# --------------------------------------------------------------------------

_TABLES = None


def set_lw_tables(tables):
    """Inject k-distribution tables (tests and the bench use
    synthetic_lw_tables)."""
    global _TABLES
    _TABLES = tables


def get_lw_tables(support_dir="rrtmg_support"):
    """Tables for a model run: whatever was injected via set_lw_tables,
    else loaded (and cached) from the rrtmg_support data directory."""
    global _TABLES
    if _TABLES is None:
        from .rrtmg_lw_tables import load_lw_tables
        try:
            _TABLES = load_lw_tables(support_dir)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"RRTMG k-distribution data not found in '{support_dir}'. "
                "rad=3 needs the external rrtmg_support files the "
                "reference also downloads separately (set "
                "rad_parameters/rrtmg_support_dir). Tests can inject "
                "synthetic tables: icar_tpu.physics.rrtmg_lw."
                "set_lw_tables(rrtmg_lw_tables.synthetic_lw_tables())."
            ) from e
    return _TABLES

"""Kain-Fritsch cumulus parameterization (conv=3; icar_tpu/physics/
cu_kf.py, the reference's cu_kf.f90, WRF's KFCPS): the Fritsch-Chappell
trigger on a 60-mb mixed source layer, an entraining/detraining plume
updraft with Ogura-Cho fallout and linear glaciation between 268.16 K and
248.16 K, a single-detrainment-layer downdraft tied to the precipitation
efficiency, and a CAPE-removal closure that rescales the mass fluxes until
90% of the mixed parcel's CAPE is removed over the convective time scale,
followed by the compensating-subsidence feedback of theta, qv and the four
hydrometeors. The JAX package wires it as the reference's commented calls
would (qi/qs feedback on, FBFRC = 0, STEPCU = 1); the state keeps the
running-mean w (W0AVG), the countdown NCA, during which the tendencies
stay frozen, and the rain rate.

The JAX package writes the scheme per column and vmaps it, with three
data-dependent loops. Here the columns are one batch, (nz, ncol) with
level 0 at the surface, and every loop has a fixed number of trips, a
column that is done keeping its carry:
  * the trigger search over source layers stops at the first source
    level that triggers or gives up, and gives up past ``llfc``, so it
    needs at most nz trips; each trip depends only on its source level,
    so the nz trips run at once as a second batch axis and each column
    takes its first trip that ended the search (``_search``);
  * the updraft from the LCL's level kk to nz - 2 is a loop over the
    levels masked by nk >= kk, the downdraft from LFS - 1 down to LDB one
    masked by the column's range;
  * TPMIX's and TPDD's secant iterations take 11 steps (the JAX count);
  * the CAPE closure takes at most 14 trips.
The feedback substeps (``_substeps``) run the domain-wide maximum of the
columns' own counts, each column stepping only its own: that maximum is
read to the host once per ``_substeps`` call (one in each closure trip,
one for the hydrometeors), as the microphysics' sedimentation reads its
trips; a CUDA graph would take the bound the JAX package caps it at, 200.
The closure loop ends after the trip whose read finds no column left in
it (a later trip changes nothing). ``.at[k].set`` with a per-column k is
a ``torch.where`` on the level index; ``jnp.round`` and ``torch.round``
both round half to even. Columns that do not trigger carry NaN until the
final select and ``nan_to_num``, never a product. The three abort paths
(the TOPOMG mass check, a closure that cannot reduce the CAPE, a factor
below 0.05) disable the column, as the JAX package does.

Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), a constant over a field one division; ``dt`` is a
0-d float32 tensor (a number in the tests).
"""

from __future__ import annotations

from math import pi as _PI

import numpy as np
import torch

from .. import constants as Cn
from ..ops import pointwise as pw
from ..ops.indexing import take_level as _lev
from ..ops.pointwise import inv
from .mp_thompson import _rd
from .mp_wsm3 import _dt_tensor

# physical constants as passed by the (commented) ICAR call
# (cu_driver.f90:332-352 -> icar_constants.f90:391-420)
CP = Cn.CP
R = Cn.RD
G = Cn.GRAVITY
EP2 = Cn.EP2
XLV0, XLV1 = Cn.XLV0, Cn.XLV1
XLS0, XLS1 = Cn.XLS0, Cn.XLS1
ALIQ = Cn.SVP1 * 1000.0
BLIQ = Cn.SVP2
CLIQK = Cn.SVP2 * Cn.SVPT0
DLIQ = Cn.SVP3
AICE, BICE, CICEK, DICE = 613.2, 22.452, 6133.0, 0.61

# scheme data (cu_kf.f90:12, 421-428)
RAD_KF = 1500.0
P00, T00 = 1e5, 273.16
B61 = 0.608
RLF = 3.339e5
RHBC = 0.90
TTFRZ, TBFRZ = 268.16, 248.16
C5 = 1.0723e-3
RATE = 0.01
FBFRC = 0.0
GDRY = -G / CP
AU0 = _PI * RAD_KF * RAD_KF
STAB = 0.95

# the JAX package's cap on a column's feedback substeps (cu_kf.py
# _substeps)
MAX_SUBSTEPS = 200
# the closure's trips and the secant iterations (cu_kf.py)
CLOSURE_TRIPS = 14
SECANT_STEPS = 11

# the updraft's profiles (cu_kf.py arr_names)
ARR_NAMES = ("umf", "uer", "udr", "detlq", "detic", "pptliq", "pptice",
             "qliq", "qice", "qlqout", "qicout", "ratio2", "theteu",
             "thetee", "thtes", "tua", "tvu", "qua", "wua", "qdt", "eqfrc")


def _w(c, a, b):
    """``jnp.where(c, a, b)``; either branch may be a number."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        return torch.where(c, torch.full(c.shape, float(a), device=c.device),
                           torch.full(c.shape, float(b), device=c.device))
    if not torch.is_tensor(a):
        a = torch.full((), float(a), dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
    return torch.where(c, a, b)


def _down(a, first=None):
    """``a`` shifted up one level: level k holds a[k-1], level 0
    ``first`` (a[0] when None)."""
    return torch.cat([a[:1] if first is None else first, a[:-1]], 0)


def _esl(t):
    return ALIQ * torch.exp((BLIQ * t - CLIQK) / (t - DLIQ))


def _esi(t):
    return AICE * torch.exp((BICE * t - CICEK) / (t - DICE))


def _sd(x, y, eps=1e-10):
    d = torch.where(torch.abs(y) < eps,
                    torch.where(y < 0, torch.full_like(y, -eps),
                                torch.full_like(y, eps)), y)
    return x / d if torch.is_tensor(x) else _rd(x, d)


def _rocp(q):
    """0.2854 (1 - 0.28 q): the exponent of the moist Exner function."""
    return 0.2854 * (1.0 - 0.28 * q)


def _thtgs(t, p, ratio2, rl):
    """Saturated theta-e at temperature t for glaciation fraction ratio2
    (TPMIX regimes, cu_kf.f90:2280-2338). Returns (thtgs, qs)."""
    esl, esi = _esl(t), _esi(t)
    reg0 = ratio2 < 1e-6
    reg1 = torch.abs(ratio2 - 1.0) < 1e-6
    es = torch.where(reg0, esl, torch.where(
        reg1, esi, (1.0 - ratio2) * esl + ratio2 * esi))
    es = torch.minimum(es, 0.99 * p)
    qs = EP2 * es / (p - es)
    pi_ = pw.pow(_rd(1e5, p), _rocp(qs))
    wet = 1.0 + 0.81 * qs
    expo = torch.where(
        reg0, (_rd(3374.6525, t) - 2.5403) * qs * wet,
        torch.where(reg1, (_rd(3114.834, t) - 0.278296) * qs * wet,
                    rl * qs * C5 / t * wet))
    return t * pi_ * torch.exp(expo), qs


def _wetbulb(p, thtu, tu, ratio2, rl, tol):
    """Secant iteration for wet-bulb T from theta-e (TPMIX loop,
    cu_kf.f90:2300-2345; also TPDD with ratio2=0): SECANT_STEPS steps, a
    cell that has converged keeping its result. Returns (t, qs)."""
    thtgs0, qs0 = _thtgs(tu, p, ratio2, rl)
    f0 = thtgs0 - thtu
    t_cur = tu - 0.5 * f0
    t_prev, f_prev, t_res, qs_res = tu, f0, t_cur, qs0
    done = torch.zeros(torch.broadcast_shapes(t_cur.shape, thtu.shape),
                       dtype=torch.bool, device=t_cur.device)
    for _ in range(SECANT_STEPS):
        thtgs, qs_e = _thtgs(t_cur, p, ratio2, rl)
        f1 = thtgs - thtu
        t_res = torch.where(done, t_res, t_cur)
        qs_res = torch.where(done, qs_res, qs_e)
        done = done | (torch.abs(f1) < tol)
        t_next = t_cur - f1 * _sd(t_cur - t_prev, f1 - f_prev)
        t_prev = torch.where(done, t_prev, t_cur)
        f_prev = torch.where(done, f_prev, f1)
        t_cur = torch.where(done, t_cur, t_next)
    return t_res, qs_res


def _tpmix(p, thtu, tu, qu, qliq, qice, ratio2, rl):
    """Wet-bulb extraction + condensation/evaporation bookkeeping
    (TPMIX, cu_kf.f90:2245-2440).

    Returns (tu, qu, qliq, qice, qnewlq, qnewic)."""
    t1, qs = _wetbulb(p, thtu, tu, ratio2, rl, 0.01)
    reg0 = ratio2 < 1e-6
    reg1 = torch.abs(ratio2 - 1.0) < 1e-6

    sup = qs <= qu
    qnew = _w(sup, qu - qs, 0.0)

    # sub-saturated: evaporate available liquid/ice (":2360-2430")
    dq = qs - qu
    qtot = qliq + qice
    enough = qtot >= dq
    ql_e = qliq - (1.0 - ratio2) * dq
    dqice = torch.clamp(-ql_e, min=0.0)
    ql_e = torch.clamp(ql_e, min=0.0)
    qi_e = qice - ratio2 * dq + dqice
    dqliq = torch.clamp(-qi_e, min=0.0)
    qi_e = torch.clamp(qi_e, min=0.0)
    ql_e = ql_e + dqliq

    rll = torch.where(reg0, XLV0 - XLV1 * t1,
                      torch.where(reg1, XLS0 - XLS1 * t1, rl))
    ccp = 1005.7 * (1.0 + 0.89 * qu)
    no_cond = qtot < 1e-10
    t_nc = t1 + rll * (dq / (1.0 + dq)) / ccp
    t_sc = t1 + rll * ((dq - qtot) / (1.0 + dq - qtot)) / ccp
    qu_sc = qu + qtot

    sub_ok = sup | enough
    t_out = torch.where(sub_ok, t1, torch.where(no_cond, t_nc, t_sc))
    qu_out = torch.where(sub_ok, qs, torch.where(no_cond, qu, qu_sc))
    ql_out = torch.where(sup, qliq, _w(enough, ql_e, 0.0))
    qi_out = torch.where(sup, qice, _w(enough, qi_e, 0.0))
    return (t_out, qu_out, ql_out, qi_out,
            (1.0 - ratio2) * qnew, ratio2 * qnew)


def _condload(qliq, qice, wtw, dzz, boterm, enterm, qnewlq, qnewic):
    """Ogura-Cho precipitation fallout + vertical velocity update
    (CONDLOAD, cu_kf.f90:2023-2088).

    Returns (qliq, qice, wtw, qlqout, qicout)."""
    qtot = qliq + qice
    qnew = qnewlq + qnewic
    qest = 0.5 * (qtot + qnew)
    g1 = torch.clamp(wtw + boterm - enterm
                     - 2.0 * G * dzz * qest * inv(1.5), min=0.0)
    wavg = (torch.sqrt(torch.clamp(wtw, min=0.0)) + torch.sqrt(g1)) * 0.5
    conv = RATE * dzz / torch.clamp(wavg, min=1e-10)
    ratio3 = qnewlq / (qnew + 1e-10)
    qtot = qtot + 0.6 * qnew
    oldq = qtot
    ratio4 = (0.6 * qnewlq + qliq) / (qtot + 1e-10)
    qtot = qtot * torch.exp(-conv)
    dq = oldq - qtot
    qlqout = ratio4 * dq
    qicout = (1.0 - ratio4) * dq
    pptdrg = 0.5 * (oldq + qtot - 0.2 * qnew)
    wtw = wtw + boterm - enterm - 2.0 * G * dzz * pptdrg * inv(1.5)
    qliq = ratio4 * qtot + ratio3 * 0.4 * qnew
    qice = (1.0 - ratio4) * qtot + (1.0 - ratio3) * 0.4 * qnew
    return qliq, qice, wtw, qlqout, qicout


def _dtfrznew(tu, p, qvap, qliq, qice, qnwfrz, frc1, effq, iflag):
    """Linear glaciation of the updraft between TTFRZ and TBFRZ
    (DTFRZNEW, cu_kf.f90:2091-2190).

    Returns (tu, theteu, qvap, qliq, qice, ratio2, rl, iflag)."""
    qlqfrz = qliq * effq
    qnew = qnwfrz * effq * 0.5
    esliq = _esl(tu)
    esice = _esi(tu)
    rls = 2833922.0 - 259.532 * (tu - 273.16)
    rlf = rls - (2.5e6 - 2369.276 * (tu - 273.16))
    ccp = 1005.7 * (1.0 + 0.89 * qvap)
    a = (CICEK - BICE * DICE) / ((tu - DICE) * (tu - DICE))
    b = rls * EP2 / p
    c = a * b * esice / ccp
    dqvap = (b * (esliq - esice) / (rls + rls * c)
             - rlf * (qlqfrz + qnew) / (rls + rls / c))
    dtfrz = (rlf * (qlqfrz + qnew) + b * (esliq - esice)) / (ccp + a * b
                                                             * esice)
    tu1, qvap1 = tu, qvap
    tu = tu + frc1 * dtfrz
    qvap = qvap - frc1 * dqvap
    es = qvap * p / (EP2 + qvap)
    esl_n = _esl(tu)
    ratio2 = _sd(esl_n - es, esl_n - _esi(tu))

    # adjust FRC1 so glaciation is neither under- nor over-counted
    # (":2152-2170"); both paths force ratio2=1, iflag=1
    cond1 = (iflag > 0) & (ratio2 < 1.0)
    cond2 = (~cond1) & (ratio2 > 1.0)
    frc1_adj = torch.where(cond1, frc1 + (1.0 - ratio2),
                           torch.where(cond2, torch.clamp(
                               frc1 - (ratio2 - 1.0), min=0.0), frc1))
    adj = cond1 | cond2
    tu = torch.where(adj, tu1 + frc1_adj * dtfrz, tu)
    qvap = torch.where(adj, qvap1 - frc1_adj * dqvap, qvap)
    ratio2 = _w(adj, 1.0, ratio2)
    iflag = _w(adj, 1, iflag)
    frc1 = frc1_adj

    rlc = XLV0 - XLV1 * tu
    rls = XLS0 - XLS1 * tu
    rl = ratio2 * rls + (1.0 - ratio2) * rlc
    pi_ = pw.pow(_rd(1e5, p), _rocp(qvap))
    theteu = tu * pi_ * torch.exp(rl * qvap * C5 / tu * (1.0 + 0.81 * qvap))
    full = iflag == 1
    qice_out = torch.where(full, qice + frc1 * dqvap + qliq,
                           qice + frc1 * (dqvap + qlqfrz))
    qliq_out = _w(full, 0.0, qliq - frc1 * qlqfrz)
    return tu, theteu, qvap, qliq_out, qice_out, ratio2, rl, iflag


def _prof5(eq):
    """Gaussian mixing profile integral (PROF5, cu_kf.f90:2194-2235).
    Returns (ee, ud). The JAX package forms exp(-4.5) and its product
    with the constant c1 as float32 scalars."""
    sqrt2p, a1, a2, a3 = 2.506628, 0.4361836, -0.1201676, 0.9372980
    pp, sigma, fe = 0.33267, 0.166666667, 0.202765151
    y = 6.0 * eq - 3.0
    ey = torch.exp(y * y * inv(-2.0))
    e45 = np.exp(np.float32(-4.5))
    t2 = 1.0 / (1.0 + pp * torch.abs(y))
    t1 = 0.500498
    c1 = a1 * t1 + a2 * t1 * t1 + a3 * t1 ** 3
    c2 = a1 * t2 + a2 * t2 * t2 + a3 * (t2 * (t2 * t2))
    pos = y >= 0.0
    e45c1 = e45 * np.float32(c1)
    head = float(np.float32(sqrt2p) - e45c1)
    e45c1, e45 = float(e45c1), float(e45)
    ee = torch.where(
        pos,
        sigma * (0.5 * (head - ey * c2) + sigma * (e45 - ey))
        - e45 * eq * eq * 0.5,
        sigma * (0.5 * (ey * c2 - e45c1) + sigma * (e45 - ey))
        - e45 * eq * eq * 0.5)
    ud = torch.where(
        pos,
        sigma * (0.5 * (ey * c2 - e45c1) + sigma * (e45 - ey))
        - e45 * (0.5 + eq * eq * 0.5 - eq),
        sigma * (0.5 * (head - ey * c2) + sigma * (e45 - ey))
        - e45 * (0.5 + eq * eq * 0.5 - eq))
    return ee * inv(fe), ud * inv(fe)


def _envirtht(p1, t1, q1, r1, rl):
    """Environmental theta-e for glaciation fraction r1
    (ENVIRTHT, cu_kf.f90:2443-2490)."""
    ee = q1 * p1 / (EP2 + q1)
    ee = torch.clamp(ee, min=1e-10)
    tlog = torch.log(ee * inv(ALIQ))
    tdpt = (CLIQK - DLIQ * tlog) / (BLIQ - tlog)
    tsatlq = tdpt - (0.212 + 1.571e-3 * (tdpt - T00)
                     - 4.36e-4 * (t1 - T00)) * (t1 - tdpt)
    tlogic = torch.log(ee * inv(AICE))
    tfpt = (CICEK - DICE * tlogic) / (BICE - tlogic)
    tsatic = tfpt - (0.182 + 1.13e-3 * (tfpt - T00)
                     - 3.58e-4 * (t1 - T00)) * (t1 - tfpt)
    tht = t1 * pw.pow(_rd(P00, p1), _rocp(q1))
    r1 = r1 if torch.is_tensor(r1) else torch.full_like(t1, float(r1))
    reg0 = r1 < 1e-6
    reg1 = torch.abs(r1 - 1.0) < 1e-6
    tsat = r1 * tsatic + (1.0 - r1) * tsatlq
    wet = 1.0 + 0.81 * q1
    expo = torch.where(
        reg0, (_rd(3374.6525, tsatlq) - 2.5403) * q1 * wet,
        torch.where(reg1, (_rd(3114.834, tsatic) - 0.278296) * q1 * wet,
                    rl * q1 * C5 / tsat * wet))
    return tht * torch.exp(expo)


def _theta_e(t, p, q, tsat):
    """theta-e given saturation temperature (Bolton form used throughout
    KFPARA, e.g. cu_kf.f90:617-619)."""
    return (t * pw.pow(_rd(1e5, p), _rocp(q))
            * torch.exp((_rd(3374.6525, tsat) - 2.5403) * q
                        * (1.0 + 0.81 * q)))


def _row_set(a, k, cond, v):
    """``a`` with level ``k`` (one for every column) set to ``v`` where
    ``cond``."""
    a[k] = torch.where(cond, v, a[k])


def _kset(a, kidx, k, v, cond=None):
    """``a.at[k].set(v)`` with a per-column level ``k`` (where ``cond``)."""
    m = kidx == k[None]
    if cond is not None:
        m = m & cond[None]
    return torch.where(m, v[None] if torch.is_tensor(v) else v, a)


class _Column:
    """The sounding of a batch of columns (nz, ncol), level 0 at the
    surface, and what the scheme derives from it once (":478-516")."""

    def __init__(self, u0, v0, t0, qv0, p0, rho, dzq, w0avg, dx):
        nz = t0.shape[0]
        dev = t0.device
        self.nz = nz
        self.kidx = torch.arange(nz, device=dev)[:, None]
        self.u0, self.v0, self.t0, self.p0 = u0, v0, t0, p0
        self.w0avg = w0avg
        self.dx = dx
        self.dxsq = dx * dx
        es = _esl(t0)
        self.qes = EP2 * es / (p0 - es)
        self.q0 = torch.minimum(torch.clamp(qv0, min=1e-6), self.qes)
        self.tv0 = t0 * (1.0 + B61 * self.q0)
        self.dp = rho * G * dzq
        self.z0 = pw.cumsum(dzq, 0) - 0.5 * dzq
        self.dza = torch.cat([self.z0[1:] - self.z0[:-1],
                              torch.zeros_like(self.z0[:1])], 0)
        p300 = p0[0] - 30000.0
        kidx = self.kidx
        self.ml = torch.amax(torch.where(t0 > T00, kidx + 1, 0), 0)
        self.l5 = torch.clamp(torch.amax(torch.where(p0 >= 500e2, kidx, 0),
                                         0), min=0)
        self.llfc = torch.amax(torch.where(p0 >= p300[None], kidx, 0), 0)
        self.ems = self.dp * self.dxsq * inv(G)
        self.emsd = 1.0 / self.ems
        # (P00 / p0) ** rocpq_k: the mixture's theta factor
        self.exn0 = pw.pow(_rd(P00, p0), _rocp(self.q0))
        self.thta0 = t0 * self.exn0
        # theta-es of the environment at each level (the updraft's and
        # the sub-cloud layers' thtes)
        self.thtes = _theta_e(t0, p0, self.qes, t0)


def _search(col: _Column):
    """The trigger search with its updraft (":517-918", the GOTO 25
    loop), every source level at once: the JAX loop's trip for source
    level lc depends on lc alone, so the nz trips are a batch (nz, ncol)
    of per-trip values and (nz, nz, ncol) of profiles (level, trip,
    column). Returns the trips' status (0 continue, 1 triggered, 2 give
    up), their profiles and their scalars."""
    nz = col.nz
    ncol = col.t0.shape[1]
    dev = col.t0.device
    f32 = col.t0.dtype
    kidx3 = torch.arange(nz, device=dev)[:, None, None]
    lc = torch.arange(nz, device=dev)[:, None].expand(nz, ncol)
    X = lambda a: a[:, None]          # a column profile against the trips
    t0, q0, p0, z0, dp = X(col.t0), X(col.q0), X(col.p0), X(col.z0), \
        X(col.dp)
    fail_llfc = lc > col.llfc[None]

    # 60-mb source layer (":522-531")
    above = kidx3 >= lc[None]
    cum = pw.cumsum(torch.where(above, dp, torch.zeros((), device=dev)), 0)
    deep = above & (cum > 6e3)
    kpbl = torch.amin(torch.where(deep, kidx3, nz), 0)
    fail_depth = kpbl >= nz
    kpbl = torch.clamp(kpbl, max=nz - 1)

    # mass-weighted mixture (":533-556")
    msk = above & (kidx3 <= kpbl[None])
    mw = torch.where(msk, dp, torch.zeros((), device=dev))
    dpthmx = pw.sum0(mw)
    thmix = pw.sum0(mw * t0 * X(col.exn0)) / dpthmx
    qmix = pw.sum0(mw * q0) / dpthmx
    zmix = pw.sum0(mw * z0) / dpthmx
    pmix = pw.sum0(mw * p0) / dpthmx
    rocpq = _rocp(qmix)
    tmix = thmix * pw.pow(pmix * inv(P00), rocpq)
    emix = qmix * pmix / (EP2 + qmix)
    tlog = torch.log(emix * inv(ALIQ))
    tdpt = (CLIQK - DLIQ * tlog) / (BLIQ - tlog)
    tlcl = tdpt - (0.212 + 1.571e-3 * (tdpt - T00)
                   - 4.36e-4 * (tmix - T00)) * (tmix - tdpt)
    tlcl = torch.minimum(tlcl, tmix)
    tvlcl = tlcl * (1.0 + 0.608 * qmix)
    plcl = P00 * pw.pow(tlcl / thmix, 1.0 / rocpq)

    # LCL level (":560-566")
    hit = above & (plcl[None] >= p0)
    klcl = torch.amin(torch.where(hit, kidx3, nz), 0)
    fail_lcl = klcl >= nz
    klcl = torch.clamp(klcl, 1, nz - 1)
    kk = klcl - 1
    lv = lambda a, k: _lev(a, k)      # a column profile at a trip's level
    p_kk, p_kl = lv(p0, kk), lv(p0, klcl)
    dlp = torch.log(plcl / p_kk) / torch.log(p_kl / p_kk)
    t_kk, t_kl = lv(t0, kk), lv(t0, klcl)
    q_kk, q_kl = lv(q0, kk), lv(q0, klcl)
    z_kk, z_kl = lv(z0, kk), lv(z0, klcl)
    tenv = t_kk + (t_kl - t_kk) * dlp
    qenv = q_kk + (q_kl - q_kk) * dlp
    tven = tenv * (1.0 + 0.608 * qenv)
    zlcl = z_kk + (z_kl - z_kk) * dlp

    # Fritsch-Chappell trigger (":594-612")
    w_kk, w_kl = lv(X(col.w0avg), kk), lv(X(col.w0avg), klcl)
    wklcl = 0.02 * zlcl * inv(2.5e3)
    wkl = (w_kk + (w_kl - w_kk) * dlp) * col.dx * inv(25e3) - wklcl
    wabs = torch.abs(wkl) + 1e-10
    wsigne = wkl / wabs
    dtlcl = 4.64 * wsigne * pw.pow(wabs, 0.33)
    tv0 = X(col.tv0)
    gdt = G * dtlcl * (zlcl - lv(z0, lc)) / (lv(tv0, lc) + tven)
    wlcl = 1.0 + 0.5 * wsigne * torch.sqrt(torch.abs(gdt) + 1e-10)
    no_trigger = tlcl + dtlcl <= tenv

    theteu_k = _theta_e(tmix, pmix, qmix, tlcl)
    es_env = _esl(tenv)
    tvavg = 0.5 * (lv(tv0, klcl) + tenv * (1.0 + 0.608 * qenv))
    plcl2 = p_kl * torch.exp(_rd(G, R * tvavg) * (z_kl - zlcl))
    qese = EP2 * es_env / (plcl2 - es_env)
    thtes_k = _theta_e(tenv, plcl2, qese, tenv)
    wtw = wlcl * wlcl
    neg_wlcl = wlcl < 0.0
    rholcl = plcl2 / (R * tvlcl)

    # --- updraft ascent loop (":660-918") -------------------------------
    zeros3 = torch.zeros((nz, nz, ncol), dtype=f32, device=dev)
    u = {n: zeros3.clone() for n in ARR_NAMES}
    vmflcl = rholcl * AU0
    at_kk = kidx3 == kk[None]
    for name, v in (("wua", wlcl), ("umf", vmflcl), ("tua", tlcl),
                    ("tvu", tvlcl), ("qua", qmix), ("theteu", theteu_k),
                    ("thtes", thtes_k)):
        u[name] = torch.where(at_kk, v[None], u[name])
    u["eqfrc"] = torch.where(at_kk, torch.ones((), device=dev), u["eqfrc"])
    full = lambda v, dtype=f32: torch.full((nz, ncol), v, dtype=dtype,
                                           device=dev)
    ttemp = full(TTFRZ)
    iflag = full(0, torch.long)
    abe = full(0.0)
    trppt = full(0.0)
    upold, upnew = vmflcl, vmflcl
    ee1, ud1 = full(1.0), full(0.0)
    let = klcl
    ltop = full(nz - 1, torch.long)
    rl = full(2.5e6)
    alive = torch.ones((nz, ncol), dtype=torch.bool, device=dev)

    for nk in range(nz - 1):
        nk1 = nk + 1
        run = alive & (nk >= kk)
        p_n1, t_n1, q_n1, tv_n1 = col.p0[nk1], col.t0[nk1], col.q0[nk1], \
            col.tv0[nk1]

        theteu_n = u["theteu"][nk]
        tu_n, qu_n, ql_n, qi_n, qnewlq, qnewic = _tpmix(
            p_n1, theteu_n, t_n1, u["qua"][nk], u["qliq"][nk],
            u["qice"][nk], u["ratio2"][nk], rl)
        r2_n = u["ratio2"][nk]
        tvu_n = tu_n * (1.0 + 0.608 * qu_n)

        # glaciation interval bookkeeping (":722-737")
        in_frz = (tu_n <= TTFRZ) & (iflag < 1)
        upper = tu_n > TBFRZ
        ttemp_c = _w(ttemp > TTFRZ, TTFRZ, ttemp)
        frc1 = _w(in_frz, torch.where(upper, (ttemp_c - tu_n)
                                      * inv(TTFRZ - TBFRZ),
                                      (ttemp_c - TBFRZ)
                                      * inv(TTFRZ - TBFRZ)), 0.0)
        span = torch.clamp(ttemp_c - TBFRZ, min=1e-10)
        r1 = _w(upper, (ttemp_c - tu_n) / span, 1.0)
        iflag_new = _w(in_frz & ~upper, 1, iflag)
        qnwfrz = _w(in_frz, qnewlq, 0.0)
        qnewic = torch.where(in_frz, qnewic + qnewlq * r1 * 0.5, qnewic)
        qnewlq = torch.where(in_frz, qnewlq - qnewlq * r1 * 0.5, qnewlq)
        effq = _w(in_frz, _rd(TTFRZ - TBFRZ, span), 1.0)
        ttemp_new = torch.where(in_frz, tu_n, ttemp)

        # buoyancy + fallout (":739-756")
        first = nk == kk
        be = torch.where(first, (tvlcl + tvu_n) / (tven + tv_n1) - 1.0,
                         (u["tvu"][nk] + tvu_n)
                         / (col.tv0[nk] + tv_n1) - 1.0)
        dzz = torch.where(first, col.z0[nk1] - zlcl,
                          col.dza[nk].expand_as(zlcl))
        boterm = 2.0 * dzz * G * be * inv(1.5)
        enterm = _w(first, 0.0, 2.0 * u["uer"][nk] * wtw / upold)
        ql_n, qi_n, wtw_n, qlqout_n, qicout_n = _condload(
            ql_n, qi_n, wtw, dzz, boterm, enterm, qnewlq, qnewic)
        exit_a = wtw_n <= 0.0

        wu_n = wtw_n / torch.sqrt(torch.abs(wtw_n) + 1e-20)
        thtes_n = col.thtes[nk1]
        udlbe = ((2.0 * theteu_k) / (u["thtes"][nk] + thtes_n) - 1.0) * dzz
        abe_n = abe + _w(udlbe > 0.0, udlbe * G, 0.0)

        # glaciation adjustment (":770-776")
        do_frz = frc1 > 1e-6
        (tu_f, theteu_f, qu_f, ql_f, qi_f, r2_f, rl_f,
         iflag_f) = _dtfrznew(tu_n, p_n1, qu_n, ql_n, qi_n, qnwfrz, frc1,
                              effq, iflag_new)
        tu_n = torch.where(do_frz, tu_f, tu_n)
        theteu_n = torch.where(do_frz, theteu_f, theteu_n)
        qu_n = torch.where(do_frz, qu_f, qu_n)
        ql_n = torch.where(do_frz, ql_f, ql_n)
        qi_n = torch.where(do_frz, qi_f, qi_n)
        r2_n = torch.where(do_frz, r2_f, r2_n)
        rl_n = torch.where(do_frz, rl_f, rl)
        iflag_new = torch.where(do_frz, iflag_f, iflag_new)

        thetee_n = _envirtht(p_n1, t_n1, q_n1, r2_n, rl_n)

        rei = vmflcl * col.dp[nk1] * 0.03 * inv(RAD_KF)
        tvqu_n = tu_n * (1.0 + 0.608 * qu_n - ql_n - qi_n)

        # entrainment/detrainment from the critical mixed fraction
        # (":793-861"): the 95% and the 10% mixtures in one TPMIX call
        cold = tvqu_n <= tv_n1
        f1 = torch.tensor([0.95, 0.10], device=dev)[:, None, None]
        f1c = torch.tensor([1.0 - 0.95, 1.0 - 0.10], device=dev)[:, None,
                                                                   None]
        tmx, qmx, tlx, tix, _, _ = _tpmix(
            p_n1, f1 * thetee_n + f1c * theteu_n, tvqu_n,
            f1 * q_n1 + f1c * qu_n, f1c * ql_n, f1c * qi_n, r2_n, rl_n)
        tu95 = tmx[0] * (1.0 + 0.608 * qmx[0])
        tu10 = tmx[1] * (1.0 + 0.608 * qmx[1] - tlx[1] - tix[1])
        eqfrc_raw = torch.clamp((tv_n1 - tvqu_n) * 0.10
                                * _sd(1.0, tu10 - tvqu_n), 0.0, 1.0)
        all_ent = (tu95 > tv_n1) | (tu10 == tvqu_n) | (eqfrc_raw == 1.0)
        all_det = (~all_ent) & (eqfrc_raw == 0.0)
        ee5, ud5 = _prof5(eqfrc_raw)
        ee2 = _w(all_ent, 1.0, _w(all_det, 0.0, ee5))
        ud2 = _w(all_ent, 0.0, _w(all_det, 1.0, ud5))
        eqfrc_n = _w(all_ent, 1.0, _w(all_det, 0.0, eqfrc_raw))
        ee2 = _w(cold, 0.0, ee2)
        ud2 = _w(cold, 1.0, ud2)
        eqfrc_n = _w(cold, 0.0, eqfrc_n)
        let_n = _w(cold, let, nk1)

        ee1_n = _w(first, 1.0, ee1)
        ud1_n = _w(first, 0.0, ud1)
        uer_n = _w(cold, 0.0, 0.5 * rei * (ee1_n + ee2))
        udr_n = torch.where(cold, rei, 0.5 * rei * (ud1_n + ud2))

        # detrainment exceeds flux: total detrainment exit (":864-875")
        umf_nk = u["umf"][nk]
        exit_b = (umf_nk - udr_n) < 10.0
        abe_n = torch.where(exit_b & (udlbe > 0.0), abe_n - udlbe * G,
                            abe_n)
        # exit_a (w <= 0) skips the ABE/LET updates entirely (":757")
        abe_n = torch.where(exit_a, abe, abe_n)
        let_n = _w(exit_b, nk, let_n)
        let_n = torch.where(exit_a, let, let_n)

        upold_n = umf_nk - udr_n
        upnew_n = upold_n + uer_n
        detlq_n = ql_n * udr_n
        detic_n = qi_n * udr_n
        qu_mix = (upold_n * qu_n + uer_n * q_n1) / upnew_n
        theteu_mix = (theteu_n * upold_n + thetee_n * uer_n) / upnew_n
        ql_mix = ql_n * upold_n / upnew_n
        qi_mix = qi_n * upold_n / upnew_n
        pptliq_n = qlqout_n * upold_n
        pptice_n = qicout_n * upold_n
        trppt_n = trppt + pptliq_n + pptice_n
        uer_n = torch.where(nk1 <= kpbl, uer_n + vmflcl * col.dp[nk1]
                            / dpthmx, uer_n)

        stop = exit_a | exit_b
        ok = run & ~stop
        # level nk1 writes: tua/tvu/ratio2 were set before the w<=0
        # check (":700-737"); the rest only after it (GOTO 65 skips)
        wr_a = run & ~exit_a
        _row_set(u["ratio2"], nk1, run,
                 torch.where(exit_a, u["ratio2"][nk], r2_n))
        for name, val in (("tua", tu_n), ("tvu", tvu_n),
                          ("qlqout", qlqout_n), ("qicout", qicout_n),
                          ("wua", wu_n), ("uer", uer_n), ("udr", udr_n),
                          ("thtes", thtes_n.expand_as(tu_n)),
                          ("thetee", thetee_n), ("eqfrc", eqfrc_n)):
            _row_set(u[name], nk1, wr_a, val)
        for name, val in (("umf", upnew_n), ("detlq", detlq_n),
                          ("detic", detic_n), ("qdt", qu_n),
                          ("qua", qu_mix), ("theteu", theteu_mix),
                          ("qliq", ql_mix), ("qice", qi_mix),
                          ("pptliq", pptliq_n), ("pptice", pptice_n)):
            _row_set(u[name], nk1, ok, val)
        # on exit the nk1 slots keep the just-computed (pre-mixing)
        # parcel state, as the Fortran in-place arrays do
        ended = run & stop
        for name, val in (("qliq", ql_n), ("qice", qi_n), ("qua", qu_n),
                          ("theteu", theteu_n)):
            _row_set(u[name], nk1, ended, val)

        wtw = torch.where(ok, wtw_n, wtw)
        ttemp = torch.where(ok, ttemp_new, ttemp)
        iflag = torch.where(ok, iflag_new, iflag)
        abe = torch.where(run, abe_n, abe)
        trppt = torch.where(ok, trppt_n, trppt)
        upold = torch.where(ok, upold_n, upold)
        upnew = torch.where(ok, upnew_n, upnew)
        ee1 = torch.where(ok, ee2, ee1)
        ud1 = torch.where(ok, ud2, ud1)
        let = torch.where(run, let_n, let)
        rl = torch.where(ok, rl_n, rl)
        ltop = _w(ended, nk, ltop)
        alive = alive & ~ended

    cldhgt = lv(z0, ltop) - zlcl
    shallow = (cldhgt < 3e3) | (abe < 1.0)
    trig = (~no_trigger) & (~neg_wlcl)
    this_fail = fail_llfc | fail_depth | fail_lcl
    success = trig & ~shallow & ~this_fail
    give_up = this_fail | (no_trigger & (kpbl >= col.llfc[None]))
    status = _w(success, 1, _w(give_up, 2, 0))
    scalars = dict(lc=lc, kpbl=kpbl, klcl=klcl, kk=kk, dpthmx=dpthmx,
                   tmix=tmix, qmix=qmix, zmix=zmix, zlcl=zlcl,
                   vmflcl=vmflcl, abe=abe, trppt=trppt, upold=upold,
                   upnew=upnew, ltop=ltop, let=torch.minimum(let, ltop),
                   rl=rl)
    return status, u, scalars


def _substeps(sub_fns, init, nstep, active):
    """Run the upstream/forward-in-time advection substeps
    (":1496-1540") of the columns ``active``: each column its own
    ``nstep`` capped at MAX_SUBSTEPS. The loop runs the largest of those
    over the active columns, read to the host here (the one read of the
    scheme; a CUDA graph would take MAX_SUBSTEPS). Returns the fields and
    the number of columns that were active."""
    nmax = torch.clamp(nstep, max=MAX_SUBSTEPS)
    trips, n_active = torch.stack([
        torch.amax(torch.where(active, nmax, 0)),
        active.sum()]).tolist()
    state = tuple(init)
    for n in range(trips):
        step = active & (n < nmax)
        state = tuple(torch.where(step[None], f(s), s)
                      for f, s in zip(sub_fns, state))
    return state, n_active


def _kf_column(u0, v0, t0, qv0, p0, rho, dzq, w0avg, dt, dx):
    """KFPARA (cu_kf.f90:308-2020) over a batch of columns: every profile
    (nz, ncol) with level 0 at the surface. Returns a dict with the
    tendencies dtdt/dqdt/dqcdt/dqrdt/dqidt/dqsdt [per s] (nz, ncol),
    pratec [mm/s], nca [s] and triggered (ncol,)."""
    col = _Column(u0, v0, t0, qv0, p0, rho, dzq, w0avg, dx)
    nz = col.nz
    kidx = col.kidx
    dt = _dt_tensor(dt, t0)
    dxsq = col.dxsq
    zeros = torch.zeros_like(t0)
    q0, z0, dp, ems, emsd = col.q0, col.z0, col.dp, col.ems, col.emsd
    qes, dza = col.qes, col.dza

    # ======== trigger search + updraft (":517-918") =====================
    status, ua, sa = _search(col)
    # the first trip that ended the search (the JAX loop's last)
    ended = status != 0
    sel = torch.argmax(ended.to(torch.uint8), 0)
    triggered = torch.any(ended, 0) & (_lev(status, sel) == 1)
    pick = lambda a: torch.take_along_dim(a, sel[None, None], dim=1)[:, 0]
    (umf, uer, udr, detlq, detic, pptliq, pptice, qliq, qice, qlqout,
     qicout, ratio2, theteu, thetee, thtes, tua, _, qua, _, qdt,
     eqfrc) = [pick(ua[n]) for n in ARR_NAMES]
    s = {k: _lev(v, sel) for k, v in sa.items()}
    lc, kpbl, klcl, kk = s["lc"], s["kpbl"], s["klcl"], s["kk"]
    ltop, let = s["ltop"], s["let"]
    dpthmx, tmix, qmix, zmix = s["dpthmx"], s["tmix"], s["qmix"], s["zmix"]
    vmflcl, zlcl = s["vmflcl"], s["zlcl"]
    abe, trppt = s["abe"], s["trppt"]
    upold, upnew, rl_c = s["upold"], s["upnew"], s["rl"]
    at = lambda a, k: _lev(a, k)

    # --- mass-flux profile adjustments above the LET (":925-962") -------
    same = let == ltop
    at_lt = kidx == ltop[None]
    udr_lt = torch.where(same, at(umf, ltop) + at(udr, ltop)
                         - at(uer, ltop), at(udr, ltop))
    detlq_lt = torch.where(same, at(qliq, ltop) * udr_lt * upnew / upold,
                           at(detlq, ltop))
    detic_lt = torch.where(same, at(qice, ltop) * udr_lt * upnew / upold,
                           at(detic, ltop))
    trppt = torch.where(same, trppt - at(pptliq, ltop) - at(pptice, ltop),
                        trppt)
    udr = torch.where(at_lt, udr_lt[None], udr)
    detlq = torch.where(at_lt, detlq_lt[None], detlq)
    detic = torch.where(at_lt, detic_lt[None], detic)
    same_lt = same[None] & at_lt
    uer, umf, pptliq, pptice = [_w(same_lt, 0.0, x)
                                for x in (uer, umf, pptliq, pptice)]

    top_msk = (~same[None]) & (kidx > let[None]) & (kidx <= ltop[None])
    dptt = pw.sum0(_w(top_msk, dp, 0.0))
    umf_let = at(umf, let)
    dumfdp = umf_let / torch.clamp(dptt, min=1e-10)
    udr_top = dp * dumfdp[None]
    umf_top = umf_let[None] - pw.cumsum(_w(top_msk, udr_top, 0.0), 0)
    trppt = trppt + pw.sum0(_w(
        top_msk, umf_top * (qlqout + qicout) - pptliq - pptice, 0.0))
    udr = torch.where(top_msk, udr_top, udr)
    umf = torch.where(top_msk, umf_top, umf)
    detlq = torch.where(top_msk, qliq * udr, detlq)
    detic = torch.where(top_msk, qice * udr, detic)
    pptliq = torch.where(top_msk, umf * qlqout, pptliq)
    pptice = torch.where(top_msk, umf * qicout, pptice)

    # --- extend below the LCL / zero above cloud top (":966-1050";
    # DO 90 runs over levels 1..K inclusive) ------------------------------
    below = kidx <= kk[None]
    src = below & (kidx >= lc[None])
    in_pbl = src & (kidx <= kpbl[None])
    uer_b = _w(in_pbl, vmflcl[None] * dp / dpthmx[None], 0.0)
    umf_b = _w(src, torch.minimum(pw.cumsum(uer_b, 0), vmflcl[None]), 0.0)
    umf_b = torch.where(src & (kidx > kpbl[None]), vmflcl[None], umf_b)
    tua = torch.where(below, _w(src, tmix[None] + (z0 - zmix[None]) * GDRY,
                                0.0), tua)
    qua = torch.where(below, _w(src, qmix[None].expand_as(qua), 0.0), qua)
    umf = torch.where(below, umf_b, umf)
    uer = torch.where(below, uer_b, uer)
    (udr, qdt, qliq, qice, qlqout, qicout, pptliq, pptice, detlq, detic,
     ratio2) = [_w(below, 0.0, x) for x in (
         udr, qdt, qliq, qice, qlqout, qicout, pptliq, pptice, detlq, detic,
         ratio2)]
    # theta-e of the sub-cloud environment (":1007-1017")
    ee_b = torch.clamp(q0 * p0 / (EP2 + q0), min=1e-10)
    tlog_b = torch.log(ee_b * inv(ALIQ))
    tdpt_b = (CLIQK - DLIQ * tlog_b) / (BLIQ - tlog_b)
    tsat_b = tdpt_b - (0.212 + 1.571e-3 * (tdpt_b - T00)
                       - 4.36e-4 * (t0 - T00)) * (t0 - tdpt_b)
    thetee = torch.where(below, _theta_e(t0, p0, q0, tsat_b), thetee)
    thtes = torch.where(below, col.thtes, thtes)
    eqfrc = _w(below, 1.0, eqfrc)

    above_top = kidx > ltop[None]
    (umf, uer, udr, qdt, qliq, qice, qlqout, qicout, detlq, detic, pptliq,
     pptice) = [_w(above_top, 0.0, x) for x in
                (umf, uer, udr, qdt, qliq, qice, qlqout, qicout, detlq,
                 detic, pptliq, pptice)]
    above_top1 = kidx > (ltop + 1)[None]
    tua = _w(above_top1, 0.0, tua)
    qua = _w(above_top1, 0.0, qua)

    thtau = tua * pw.pow(_rd(P00, p0), _rocp(qdt))

    # moisture-flux level for precipitation efficiency (":1040-1055")
    p150 = at(p0, klcl) - 1.5e4
    lvf = torch.amax(_w((kidx <= ltop[None]) & (p0 > p150[None]), kidx,
                        0), 0)
    lvf = torch.clamp(torch.minimum(lvf, let), max=nz - 2)
    lvf1 = lvf + 1
    usr = at(umf, lvf1) * (at(qua, lvf1) + at(qliq, lvf1) + at(qice, lvf1))
    usr = torch.minimum(usr, trppt)
    usr = torch.where(usr < 1e-8, trppt, usr)

    # --- convective time scale + precipitation efficiency (":1100-1150")
    def wspd(k):
        uk, vk = at(u0, k), at(v0, k)
        return torch.sqrt(uk * uk + vk * vk)
    wspd_klcl = wspd(klcl)
    wspd_l5 = wspd(col.l5)
    wspd_ltop = wspd(ltop)
    vconv = 0.5 * (wspd_klcl + wspd_l5)
    timec = _w(vconv > 0.0, _rd(dx, torch.clamp(vconv, min=1e-10)), 3600.0)
    tadvec = timec
    timec = torch.clamp(timec, 1800.0, 3600.0)
    nic = torch.round(timec / dt)
    timec = nic * dt

    shsign = _w(wspd_ltop > wspd_klcl, 1.0, -1.0)
    du = at(u0, ltop) - at(u0, klcl)
    dv = at(v0, ltop) - at(v0, klcl)
    vws = du * du + dv * dv
    vws = 1e3 * shsign * torch.sqrt(vws) / torch.clamp(
        at(z0, ltop) - at(z0, klcl), min=1.0)
    pef = torch.clamp(1.591 + vws * (-0.639 + vws * (9.53e-2
                                                      - vws * 4.96e-3)),
                      0.2, 0.9)
    cbh = (zlcl - z0[0]) * 3.281e-3
    rcbh = _w(cbh < 3.0, 0.02,
              0.96729352 + cbh * (-0.70034167 + cbh * (0.162179896
              + cbh * (-1.2569798e-2 + cbh * (4.2772e-4
                                              - cbh * 5.44e-6)))))
    rcbh = _w(cbh > 25.0, 2.4, rcbh)
    pefcbh = torch.clamp(1.0 / (1.0 + rcbh), max=0.9)
    peff = 0.5 * (pef + pefcbh)
    peff2 = peff

    # ================= downdraft (":1152-1410") ==========================
    kstart = torch.clamp(torch.maximum(kpbl, klcl), max=nz - 3)
    dd_rng = (kidx >= (kstart + 1)[None]) & (kidx <= (ltop - 1)[None])
    thtes_m = _w(dd_rng, thtes, 1e10)
    # last occurrence of the running minimum (":1166-1171")
    kmin = (nz - 1) - torch.argmin(torch.flip(thtes_m, [0]), 0)
    lfs = torch.clamp(kmin, 1, nz - 2)

    p_lfs, t_lfs, q_lfs = at(p0, lfs), at(t0, lfs), at(q0, lfs)
    thetee_lfs = torch.where(at(ratio2, lfs) > 0.0,
                             _envirtht(p_lfs, t_lfs, q_lfs, 0.0, rl_c),
                             at(thetee, lfs))
    theteu_lfs = at(theteu, lfs)
    eqfrc_lfs = torch.clamp(_sd(at(thtes, lfs) - theteu_lfs,
                                thetee_lfs - theteu_lfs), 0.0, 1.0)
    dtmltd = _w(col.ml > 0, 0.5 * (at(qua, klcl) - at(qua, ltop)) * RLF
                * inv(CP), 0.0)
    tz_lfs = t_lfs - dtmltd
    es_lfs = _esl(tz_lfs)
    qs_lfs = EP2 * es_lfs / (p_lfs - es_lfs)
    qd_lfs = eqfrc_lfs * q_lfs + (1.0 - eqfrc_lfs) * at(qua, lfs)
    thtad_lfs = tz_lfs * pw.pow(_rd(P00, p_lfs), _rocp(qd_lfs))
    theted_lfs = torch.where(
        qd_lfs >= qs_lfs,
        thtad_lfs * torch.exp((_rd(3374.6525, tz_lfs) - 2.5403) * qs_lfs
                              * (1.0 + 0.81 * qs_lfs)),
        _envirtht(p_lfs, tz_lfs, qd_lfs, 0.0, rl_c))

    # LDB: highest level below LFS where the downdraft is negatively
    # buoyant (":1197-1212")
    cand = (kidx < lfs[None]) & ((theted_lfs[None] > thtes) | (kidx == 0))
    ldb = torch.clamp(torch.amax(_w(cand, kidx, 0), 0), min=0)
    p_ldb = at(p0, ldb)
    no_dd_geom = (ldb == lfs - 1) | ((p_ldb - p_lfs) < 50e2)
    dpdd = at(dp, ldb)

    # first-guess downdraft mass flux (":1232-1262")
    tvd_lfs = t_lfs * (1.0 + 0.608 * at(qes, lfs))
    rdd = p_lfs / (R * tvd_lfs)
    dmf0 = -(1.0 - peff) * AU0 * rdd

    at_lfs = kidx == lfs[None]
    dmf = _w(at_lfs, dmf0[None].expand_as(t0), 0.0)
    der = _w(at_lfs, (eqfrc_lfs * dmf0)[None].expand_as(t0), 0.0)
    ddr = zeros.clone()
    theted = _w(at_lfs, theted_lfs[None].expand_as(t0), 0.0)
    qd = _w(at_lfs, qd_lfs[None].expand_as(t0), 0.0)
    # from LFS - 1 down to LDB, one level a trip (the JAX loop's nd =
    # lfs - 1 - i), masked by each column's range
    for nd in range(nz - 2, -1, -1):
        nd1 = nd + 1
        run = (nd <= lfs - 1) & (nd >= ldb)
        is_det = nd <= ldb
        dp_nd = dp[nd]
        der_n = _w(is_det, 0.0, dmf0 * 0.03 * dp_nd * inv(RAD_KF))
        ddr_n = _w(is_det, -dmf[nd1] * dp_nd / dpdd, 0.0)
        dmf_n = dmf[nd1] + ddr_n + der_n
        thetee_nd = torch.where(
            ratio2[nd] > 0.0, _envirtht(p0[nd], t0[nd], q0[nd], 0.0, rl_c),
            thetee[nd])
        theted_n = torch.where(is_det, theted[nd1],
                               (theted[nd1] * dmf[nd1] + thetee_nd * der_n)
                               / dmf_n)
        qd_n = torch.where(is_det, qd[nd1],
                           (qd[nd1] * dmf[nd1] + q0[nd] * der_n) / dmf_n)
        _row_set(dmf, nd, run, dmf_n)
        _row_set(der, nd, run, der_n)
        _row_set(ddr, nd, run, ddr_n)
        _row_set(theted, nd, run, theted_n)
        _row_set(qd, nd, run, qd_n)

    # evaporation in the (single) detrainment layer (":1266-1292")
    t_ldb = at(t0, ldb)
    zero1 = torch.zeros_like(t_ldb)
    tz_ldb, qs_e = _wetbulb(p_ldb, at(theted, ldb), t_ldb, zero1,
                            torch.full_like(t_ldb, 2.5e6), 0.05)
    dssdt = (CLIQK - BLIQ * DLIQ) / ((tz_ldb - DLIQ) * (tz_ldb - DLIQ))
    rl_e = XLV0 - XLV1 * tz_ldb
    dtmp = rl_e * qs_e * (1.0 - RHBC) / (CP + rl_e * RHBC * qs_e * dssdt)
    t1rh = tz_ldb + dtmp
    es_rh = RHBC * _esl(t1rh)
    qsrh = EP2 * es_rh / (p_ldb - es_rh)
    qd_ldb = at(qd, ldb)
    dry = qsrh < qd_ldb
    qsrh = torch.where(dry, qd_ldb, qsrh)
    t1rh = torch.where(dry, tz_ldb, t1rh)
    tder = (qsrh - qd_ldb) * at(ddr, ldb)
    qd = _kset(qd, kidx, ldb, qsrh)
    tz_arr = _kset(zeros, kidx, ldb, t1rh)
    thtad = _kset(zeros, kidx, lfs, thtad_lfs)
    thtad = _kset(thtad, kidx, ldb,
                  t1rh * pw.pow(_rd(P00, p_ldb), _rocp(qsrh)))

    # precipitation-efficiency consistency (":1294-1345")
    ppr = pw.sum0(_w((kidx >= klcl[None]) & (kidx <= lfs[None]),
                       pptliq + pptice, 0.0))
    pptflx_dd = peff * usr
    rced = trppt - pptflx_dd
    devdmf = _sd(tder, dmf0)
    umf_lfs = at(umf, lfs)
    up_lfs = lfs >= klcl
    dpptdf = _w(up_lfs, (1.0 - peff) * ppr * (1.0 - eqfrc_lfs)
                * _sd(1.0, umf_lfs), 0.0)
    cndtnf = (at(qliq, lfs) + at(qice, lfs)) * (1.0 - eqfrc_lfs)
    dmflfs = rced * _sd(1.0, devdmf + dpptdf + cndtnf)

    no_dd = no_dd_geom | (tder < 1.0) | (dmflfs > 0.0)

    updinc_raw = _w(up_lfs, (umf_lfs - (1.0 - eqfrc_lfs) * dmflfs)
                    * _sd(1.0, umf_lfs), 1.0)
    cap = updinc_raw > 1.5
    updinc = _w(cap, 1.5, updinc_raw)
    dmflfs2 = umf_lfs * (updinc - 1.0) * _sd(1.0, eqfrc_lfs - 1.0)
    rced2 = dmflfs2 * (devdmf + dpptdf + cndtnf)
    pptflx_dd = torch.where(cap, pptflx_dd + (rced - rced2), pptflx_dd)
    peff2 = torch.where(cap, pptflx_dd / torch.clamp(usr, min=1e-10),
                        peff2)
    dmflfs = torch.where(cap, dmflfs2, dmflfs)
    ddinc = _sd(dmflfs, dmf0)

    dd_msk = (kidx >= ldb[None]) & (kidx <= lfs[None])
    no_dd3 = no_dd[None]
    dmf, der, ddr = [_w(no_dd3, 0.0, _w(dd_msk, x * ddinc[None], 0.0))
                     for x in (dmf, der, ddr)]
    thtad, qd, tz_arr = [_w(no_dd3, 0.0, x) for x in (thtad, qd, tz_arr)]

    pptflx = torch.where(no_dd, trppt, pptflx_dd + peff * ppr
                         * (updinc - 1.0))
    tder = _w(no_dd, 0.0, tder * ddinc)
    updinc = _w(no_dd, 1.0, updinc)

    up_msk = (kidx >= lc[None]) & (kidx <= lfs[None]) & ~no_dd3
    umf, udr, uer, pptliq, pptice, detlq, detic = [
        torch.where(up_msk, x * updinc[None], x)
        for x in (umf, udr, uer, pptliq, pptice, detlq, detic)]

    # ================= CAPE-removal closure (":1412-1740") ===============
    lmax = torch.maximum(klcl, lfs)
    inflow = uer - der
    aincm1 = _w((kidx >= lc[None]) & (kidx <= lmax[None]) & (inflow > 0.0),
                ems / torch.clamp(inflow * timec[None], min=1e-10), 1000.0)
    aincmx = torch.clamp(torch.amin(aincm1, 0), max=1000.0)
    ainc0 = torch.clamp(aincmx, max=1.0)

    pptfl2 = pptflx
    base = dict(umf=umf, dmf=dmf, detlq=detlq, detic=detic, udr=udr,
                uer=uer, der=der, ddr=ddr)
    # pre-scale when the available-mass limit binds (":1470-1476")
    pre_fac = _w(aincmx < 1.0, ainc0, 1.0)
    sc = {k: v * pre_fac[None] for k, v in base.items()}
    abort0 = ainc0 < 0.05

    cu_msk = kidx <= ltop[None]
    cu_mskf = cu_msk.to(t0.dtype)
    top_in = cu_msk & (kidx >= 1)
    dp_dn = _down(dp, torch.full_like(dp[:1], 1e10))
    dza_dn = _down(dza)
    fxm_of = lambda omg: omg * dxsq * inv(G)

    def adv_sub(sources, dtime, fxm):
        def sub(pa):
            donor = torch.where(fxm <= 0.0, _down(pa), pa)
            fxbot = _w(kidx >= 1, -fxm * donor, 0.0)
            fxtop = torch.cat([-fxbot[1:], torch.zeros_like(fxbot[:1])], 0)
            upd = (fxbot + sources + fxtop) * dtime[None] * emsd
            return torch.where(cu_msk, pa + upd, pa)
        return sub

    # the closure's carry, frozen in a column that is done (its trips
    # stop) or did not trigger (its results are never used)
    ncount = torch.zeros_like(lc)
    done = abort0
    abort = abort0
    noitr = torch.zeros_like(lc)
    ainc, aincold = ainc0, ainc0
    fabeold = torch.ones_like(ainc0)
    tg, qg = t0, q0
    fxm = zeros
    nstep = torch.ones_like(lc)
    dtime = timec
    mw = _w((kidx >= lc[None]) & (kidx <= kpbl[None]), dp, 0.0)
    for _ in range(CLOSURE_TRIPS):
        active = triggered & ~done
        ncount_n = ncount + 1
        domgdp = -(sc["uer"] - sc["der"] - sc["udr"] - sc["ddr"]) * emsd
        omg = torch.cat([torch.zeros_like(dp[:1]),
                         -pw.cumsum((dp * domgdp)[:-1], 0)], 0) * cu_mskf
        dtt_lv = 0.75 * dp_dn / (torch.abs(omg) + 1e-10)
        dtt = torch.minimum(timec, torch.amin(_w(top_in, dtt_lv, 1e10), 0))
        nstep_f = torch.round(timec / dtt + 1.0)
        nstep_n = torch.nan_to_num(torch.clamp(nstep_f, -2.0 ** 31,
                                               2.0 ** 31 - 1), nan=0.0) \
            .to(torch.long)
        dtime_n = timec / nstep_n.to(t0.dtype)
        fxm_n = fxm_of(omg)

        th_src = (sc["udr"] * thtau + sc["ddr"] * thtad
                  - (sc["uer"] - sc["der"]) * col.thta0)
        q_src = (sc["udr"] * qdt + sc["ddr"] * qd
                 - (sc["uer"] - sc["der"]) * q0)
        (thpa, qpa), n_active = _substeps(
            (adv_sub(th_src, dtime_n, fxm_n),
             adv_sub(q_src, dtime_n, fxm_n)), (col.thta0, q0), nstep_n,
            active)
        if n_active == 0:
            # no column left in the closure: this trip and every later
            # one change nothing
            break

        # borrow moisture to fix negative qv (":1543-1567")
        for nk in range(nz):
            bad = (qpa[nk] < 0.0) & (nk >= 1) & cu_msk[nk]
            nk1 = torch.where(ltop == nk, klcl, min(nk + 1, nz - 1))
            tma = at(qpa, nk1) * at(ems, nk1)
            tmb = qpa[nk - 1] * ems[nk - 1]
            tmm = (qpa[nk] - 1e-9) * ems[nk]
            bcoeff = -tmm * _sd(1.0, (tma * tma) * _sd(1.0, tmb) + tmb)
            acoeff = bcoeff * tma * _sd(1.0, tmb)
            tmb = tmb * (1.0 - bcoeff)
            tma = tma * (1.0 - acoeff)
            qg_n = qpa.clone()
            qg_n[nk] = 1e-9
            qg_n = _kset(qg_n, kidx, nk1, tma * at(emsd, nk1))
            qg_n[nk - 1] = tmb * emsd[nk - 1]
            qpa = torch.where(bad[None], qg_n, qpa)

        topomg = (at(sc["udr"], ltop) - at(sc["uer"], ltop)) \
            * at(dp, ltop) * at(emsd, ltop)
        bad_mass = torch.abs(topomg - at(omg, ltop)) > 1e-3

        exn_g = pw.pow(_rd(P00, p0), _rocp(qpa))
        tg_n = thpa / exn_g

        # new mixed parcel + ABEG (":1594-1680")
        thmix_g = pw.sum0(mw * tg_n * exn_g) / dpthmx
        qmix_g = pw.sum0(mw * qpa) / dpthmx
        pmix_g = pw.sum0(mw * p0) / dpthmx
        tmix_g = thmix_g * pw.pow(pmix_g * inv(P00), _rocp(qmix_g))
        es_g = _esl(tmix_g)
        qs_g = EP2 * es_g / (pmix_g - es_g)
        supsat = qmix_g > qs_g
        rl_g = XLV0 - XLV1 * tmix_g
        cpm_g = CP * (1.0 + 0.887 * qmix_g)
        tdl = tmix_g - DLIQ
        dssdt_g = qs_g * (CLIQK - BLIQ * DLIQ) / (tdl * tdl)
        dq_g = (qmix_g - qs_g) / (1.0 + rl_g * dssdt_g / cpm_g)
        tmix_s = tmix_g + rl_g * inv(CP) * dq_g
        qmix_s = qmix_g - dq_g
        qmix_0 = torch.clamp(qmix_g, min=0.0)
        emix_g = qmix_0 * pmix_g / (EP2 + qmix_0)
        tlog_g = torch.log(torch.clamp(emix_g, min=1e-10) * inv(ALIQ))
        tdpt_g = (CLIQK - DLIQ * tlog_g) / (BLIQ - tlog_g)
        tlcl_u = tdpt_g - (0.212 + 1.571e-3 * (tdpt_g - T00)
                           - 4.36e-4 * (tmix_g - T00)) * (tmix_g - tdpt_g)
        tlcl_g = torch.where(supsat, tmix_s, torch.minimum(tlcl_u, tmix_g))
        qmix_f = torch.where(supsat, qmix_s, qmix_0)
        tmix_f = torch.where(supsat, tmix_s, tmix_g)
        thmix_f = torch.where(supsat, tmix_s * pw.pow(
            _rd(P00, pmix_g), _rocp(qmix_s)), thmix_g)
        plcl_g = torch.where(supsat, pmix_g, P00 * pw.pow(
            tlcl_g / thmix_f, 1.0 / _rocp(qmix_f)))
        hit_g = (kidx >= lc[None]) & (plcl_g[None] >= p0)
        klcl_g = torch.clamp(torch.amin(_w(hit_g, kidx, nz - 1), 0), 1,
                             nz - 1)
        k_g = klcl_g - 1
        p_kg, p_klg = at(p0, k_g), at(p0, klcl_g)
        dlp_g = torch.log(plcl_g / p_kg) / torch.log(p_klg / p_kg)
        tg_k, tg_kl = at(tg_n, k_g), at(tg_n, klcl_g)
        q_kg, q_klg = at(qpa, k_g), at(qpa, klcl_g)
        z_kg, z_klg = at(z0, k_g), at(z0, klcl_g)
        tenv_g = tg_k + (tg_kl - tg_k) * dlp_g
        qenv_g = q_kg + (q_klg - q_kg) * dlp_g
        tven_g = tenv_g * (1.0 + 0.608 * qenv_g)
        zlcl_g = z_kg + (z_klg - z_kg) * dlp_g
        tvavg_g = 0.5 * (tven_g + tg_kl * (1.0 + 0.608 * q_klg))
        plcl_g2 = p_klg * torch.exp(_rd(G, R * tvavg_g) * (z_klg - zlcl_g))
        theteu_g = _theta_e(tmix_f, pmix_g, qmix_f, tlcl_g)
        es_eg = _esl(tenv_g)
        qese_g = EP2 * es_eg / (plcl_g2 - es_eg)
        thtesg_k = _theta_e(tenv_g, plcl_g2, qese_g, tenv_g)

        es_lv = _esl(tg_n)
        qese_lv = EP2 * es_lv / (p0 - es_lv)
        thtesg = _theta_e(tg_n, p0, qese_lv, tg_n)
        thtesg = _kset(thtesg, kidx, k_g, thtesg_k)
        dzz_g = torch.where(kidx == klcl_g[None], (z_klg - zlcl_g)[None],
                            dza_dn)
        be_g = ((2.0 * theteu_g)[None] / (thtesg + _down(thtesg)) - 1.0) \
            * dzz_g
        abeg = pw.sum0(_w((kidx > k_g[None]) & (kidx <= ltop[None])
                            & (be_g > 0.0), be_g * G, 0.0))

        done_noitr = (noitr == 1) | bad_mass
        dabe = torch.maximum(abe - abeg, 0.1 * abe)
        fabe = abeg / (abe + 1e-8)
        abort_fabe = fabe > 1.0

        dfda = _sd(fabe - fabeold, ainc - aincold)
        revert = (ncount_n != 1) & (dfda > 0.0) & ~done_noitr & ~abort_fabe
        ainc_r = torch.where(revert, aincold, ainc)

        conv1 = (ainc_r / aincmx > 0.999) & (fabe > 1.05 - STAB)
        conv2 = (fabe <= 1.05 - STAB) & (fabe >= 0.95 - STAB)
        conv3 = ncount_n > 10
        done_n = done_noitr | abort_fabe | ((conv1 | conv2 | conv3)
                                            & ~revert)

        ainc_new = torch.where(fabe == 0.0, ainc_r * 0.5,
                               ainc_r * STAB * abe / (dabe + 1e-8))
        ainc_new = torch.where(revert, ainc_r, ainc_new)
        ainc_new = torch.minimum(aincmx, ainc_new)
        abort_small = (ainc_new < 0.05) & ~done_n
        ainc_next = torch.where(done_n, ainc, ainc_new)
        sc_next = {k: torch.where(done_n[None], sc[k], base[k]
                                  * ainc_next[None]) for k in base}

        a3 = active[None]
        ncount = torch.where(active, ncount_n, ncount)
        abort = torch.where(active, abort | abort_fabe | abort_small
                            | bad_mass, abort)
        noitr = torch.where(active & revert, 1, noitr)
        aincold = torch.where(active & ~done_n, ainc, aincold)
        fabeold = torch.where(active & ~done_n, fabe, fabeold)
        ainc = torch.where(active, ainc_next, ainc)
        sc = {k: torch.where(a3, sc_next[k], sc[k]) for k in sc}
        tg = torch.where(a3, tg_n, tg)
        qg = torch.where(a3, qpa, qg)
        fxm = torch.where(a3, fxm_n, fxm)
        nstep = torch.where(active, nstep_n, nstep)
        dtime = torch.where(active, dtime_n, dtime)
        done = torch.where(active, done_n | abort_small, done)
        # a column is in the closure for at most CLOSURE_TRIPS trips: the
        # loop's own count

    ok = triggered & ~abort
    pptflx_f = pptfl2 * ainc

    # --- hydrometeor feedback advection (":1742-1810") -------------------
    (qlg, qig, qrg, qsg), _ = _substeps(
        (adv_sub(sc["detlq"], dtime, fxm), adv_sub(sc["detic"], dtime, fxm),
         adv_sub(qlqout * sc["udr"], dtime, fxm),
         adv_sub(qicout * sc["udr"], dtime, fxm)),
        (zeros, zeros, zeros, zeros), nstep, ok)

    # --- feedback tendencies (qi_flag & qs_flag true, ":1878-1944") -----
    timec_s = torch.clamp(timec, min=1.0)[None]
    dqcdt = qlg / timec_s
    dqidt = qig / timec_s
    dqrdt = qrg / timec_s
    dqsdt = qsg / timec_s
    dtdt = (tg - t0) / timec_s
    dqdt = (qg - q0) / timec_s

    nic_f = torch.where(tadvec < timec, torch.round(tadvec / dt), nic)
    nca_new = nic_f * dt
    pratec = pptflx_f * (1.0 - FBFRC) * inv(dxsq)

    # where-select (not multiply): non-triggered columns may carry NaN
    # garbage from failed trigger-search iterations
    def m(x):
        keep = ok[None] if x.dim() == 2 else ok
        return _w(keep, torch.nan_to_num(x, nan=0.0, posinf=0.0,
                                         neginf=0.0), 0.0)

    return dict(dtdt=m(dtdt), dqdt=m(dqdt), dqcdt=m(dqcdt),
                dqrdt=m(dqrdt), dqidt=m(dqidt), dqsdt=m(dqsdt),
                pratec=m(pratec), nca=m(nca_new), triggered=ok)


def _kf_columns(u, v, t, qv, p, rho, dz, w0avg, dt, dx):
    """``_kf_column`` over every (y, x) column of (z, y, x) fields."""
    nz, ny, nx = t.shape

    def flat(a):
        return a.reshape(nz, ny * nx)

    out = _kf_column(flat(u), flat(v), flat(t), flat(qv), flat(p),
                     flat(rho), flat(dz), flat(w0avg), dt, dx)
    return {k: a.reshape(nz, ny, nx) if a.dim() == 2 else a.reshape(ny, nx)
            for k, a in out.items()}


def kfcps(u, v, th, qv, p, rho, dz, w_real, exner, dt, dx,
          w0avg, nca, pratec, tend_th, tend_qv, tend_qc, tend_qr,
          tend_qi, tend_qs):
    """KFCPS driver step (cu_kf.f90:17-305): update the W0AVG running
    mean, re-trigger columns whose NCA countdown expired, and return the
    (persistent) convective tendencies plus this step's convective rain.

    Columns with NCA > dt/2 keep their stored tendencies untouched
    (cu_kf.f90:224-230); re-checked columns get fresh tendencies (zero if
    convection does not trigger). All 3D args (z, y, x); nca/pratec are
    (y, x) state. Returns (tend_th, tend_qv, tend_qc, tend_qr, tend_qi,
    tend_qs, raincv, w0avg, nca, pratec); raincv [mm] = dt*pratec.
    """
    dt = _dt_tensor(dt, th)
    t = th * exner
    # W0AVG running mean with TST = 2*STEPCU = 2 (cu_kf.f90:155-207)
    w0 = 0.5 * (_down(w_real, torch.zeros_like(w_real[:1])) + w_real)
    w0avg = (w0avg + w0) * 0.5

    check = nca <= 0.5 * dt
    out = _kf_columns(u, v, t, qv, p, rho, dz, w0avg, dt, dx)
    c3 = check[None]
    # RTHCUTEN = DTDT/exner (cu_kf.f90:268-271)
    tend_th = torch.where(c3, out["dtdt"] / exner, tend_th)
    tend_qv = torch.where(c3, out["dqdt"], tend_qv)
    tend_qc = torch.where(c3, out["dqcdt"], tend_qc)
    tend_qr = torch.where(c3, out["dqrdt"], tend_qr)
    tend_qi = torch.where(c3, out["dqidt"], tend_qi)
    tend_qs = torch.where(c3, out["dqsdt"], tend_qs)
    pratec = torch.where(check, out["pratec"], pratec)
    nca = torch.where(check, out["nca"], nca)

    raincv = dt * pratec
    nca = nca - dt
    return (tend_th, tend_qv, tend_qc, tend_qr, tend_qi, tend_qs,
            raincv, w0avg, nca, pratec)

"""WSM3 3-class simple-ice microphysics (mp=6; icar_tpu/physics/mp_wsm3.py,
Hong, Dudhia & Chen 2004): one cloud/ice class (qci) and one rain/snow
class (qrs) whose phase follows the local temperature, with warm-rain and
cold process rates, melting/freezing at the 0C level and CFL-substepped
upwind sedimentation (the JAX package's documented stand-in for the
reference's semi-Lagrangian remap).

Plain PyTorch over the whole (z, y, x) grid, routine by routine under the
JAX package's names and in its operation order. The scheme has no TPU
kernel (XLA runs it in the JAX package), so it has no CUDA kernel here:
on the card its operations run as PyTorch's. Divisions by a constant are
products with its float32 reciprocal (``pointwise.inv``), as the JAX
package's compiled step divides; a constant over a field is one division
(``_rd``); ``dt`` is a 0-d float32 tensor; exp and pow go through
``ops/pointwise.py`` with XLA's rewrites of constant powers (``_pow``,
``_ipow``). So the CPU and the card differ only in exp/pow.

Host reads: ``_sediment``'s substep loop runs the domain's largest CFL
count of trips (each trip masked per column, so extra trips change
nothing), read to the host once a call (``_cfl``): two reads a ``wsm3``
call (rain/snow, then cloud/ice). Nothing else is read back.

As in the JAX package, one minor loop runs whatever ``dt``: the model's
MAX_DT is 120 s (= DTCLDCR), but under the microphysics throttle the
scheme integrates the counter's time, which may be longer.

Layout (z, y, x); level 0 is the surface layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .mp_thompson import _ipow, _pow, _rd

# the species the registry advects with WSM3, in its order
# (icar_tpu/registry.py:340-349)
SPECIES = ("potential_temperature", "water_vapor", "cloud_water",
           "rain_mass")

# physical constants as the ICAR driver passes them
# (mp_driver.f90:554-575, wrf_constants.f90)
G = 9.81
CPD = 1012.0
RD = 287.058
RV = 461.5
CPV = 4.0 * RV
T0C = 273.15
EP1 = RV / RD - 1.0
EP2 = RD / RV
QMIN = 1e-15           # wrf_constants epsilon
XLS = 2.85e6
XLV0 = 2.5e6
XLF0 = 3.5e5
CLIQ = 4190.0
CICE = 2106.0
PSAT = 610.78
DEN0 = 1.28            # rhoair0
DENR = 1000.0          # rhowater
DENS = 100.0           # rhosnow

# scheme parameters (mp_wsm3.f90:37-55)
DTCLDCR = 120.0
N0R = 8e6
AVTR = 841.9
BVTR = 0.8
R0 = 0.8e-5
PEAUT = 0.55
XNCR = 3e8
XMYU = 1.718e-5
AVTS = 11.72
BVTS = 0.41
N0SMAX = 1e11
LAMDARMAX = 8e4
LAMDASMAX = 1e5
DICON = 11.9
DIMAX = 500e-6
N0S = 2e6
ALPHA = 0.12
QCRMIN = 1e-9

PI = np.pi
XLV1 = CLIQ - CPV

# derived constants (wsm3init, mp_wsm3.f90:951-1006)
from math import gamma as _gamma  # noqa: E402 (the JAX module's order)

QC0 = 4.0 / 3.0 * PI * DENR * R0 ** 3 * XNCR / DEN0
QCK1 = 0.104 * 9.8 * PEAUT / (XNCR * DENR) ** (1.0 / 3.0) / XMYU \
    * DEN0 ** (4.0 / 3.0)
_G3PBR = _gamma(3 + BVTR)
_G4PBR = _gamma(4 + BVTR)
_G5PBRO2 = _gamma(2.5 + 0.5 * BVTR)
PVTR = AVTR * _G4PBR / 6.0
PACRR = PI * N0R * AVTR * _G3PBR * 0.25
PRECR1 = 2.0 * PI * N0R * 0.78
PRECR2 = 2.0 * PI * N0R * 0.31 * AVTR ** 0.5 * _G5PBRO2
ROQIMAX = 2.08e22 * DIMAX ** 8
_G3PBS = _gamma(3 + BVTS)
_G4PBS = _gamma(4 + BVTS)
_G5PBSO2 = _gamma(2.5 + 0.5 * BVTS)
PVTS = AVTS * _G4PBS / 6.0
PACRS = PI * N0S * AVTS * _G3PBS * 0.25
PRECS1 = 4.0 * N0S * 0.65
PRECS2 = 4.0 * N0S * 0.44 * AVTS ** 0.5 * _G5PBSO2
PIDN0R = PI * DENR * N0R
PIDN0S = PI * DENS * N0S
RSLOPERMAX = 1.0 / LAMDARMAX
RSLOPESMAX = 1.0 / LAMDASMAX


# --------------------------------------------------------------------------
# helpers: the jnp forms the schemes use, rounded as the JAX package's
# compiled step rounds them (shared with mp_wsm6 and mp_morrison)
# --------------------------------------------------------------------------

def _dt_tensor(dt, like):
    """``dt`` as a 0-d float32 tensor on ``like``'s device."""
    return dt if torch.is_tensor(dt) else torch.tensor(
        float(dt), dtype=torch.float32, device=like.device)


def _div(a, b):
    """``a / b`` where ``a`` may be a number: a constant over a field is
    one division (``_rd``)."""
    return a / b if torch.is_tensor(a) else _rd(a, b)


def _max(a, b):
    """``jnp.maximum`` (propagates NaN); ``b`` a tensor or a number."""
    return torch.maximum(a, b) if torch.is_tensor(b) else \
        torch.clamp(a, min=b)


def _min(a, b):
    return torch.minimum(a, b) if torch.is_tensor(b) else \
        torch.clamp(a, max=b)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi); the bounds tensors or numbers."""
    return _min(_max(x, lo), hi)


def _where(c, a, b):
    """``jnp.where``; either branch may be a number (both: float32)."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        return torch.where(c, torch.full(c.shape, a, device=c.device), b)
    return torch.where(c, a, b)


def _saturation(t, p):
    """Inlined fpvs: mixing-ratio saturation wrt ice below the triple point
    and water above (mp_wsm3.f90:455-483). Returns (qs_mixed, qs0_ratio)."""
    ttp = T0C + 0.01
    dldt = CPV - CLIQ
    xa = -dldt / RV
    xb = xa + XLV0 / (RV * ttp)
    dldti = CPV - CICE
    xai = -dldti / RV
    xbi = xai + XLS / (RV * ttp)
    tr = _rd(ttp, t)
    es_w = PSAT * _pow(tr, xa) * pw.exp(xb * (1.0 - tr))
    es_i = PSAT * _pow(tr, xai) * pw.exp(xbi * (1.0 - tr))
    es = torch.where(t < ttp, es_i, es_w)
    qs0 = (es_w - es) / es
    es = torch.minimum(es, 0.99 * p)
    qs = EP2 * es / (p - es)
    qs = torch.clamp(qs, min=QMIN)
    return qs, qs0


def _slopes(qrs, den, denfac, t):
    """Marshall-Palmer slope parameters + terminal velocity for the
    rain-or-snow class (slope_wsm3, mp_wsm3.f90:1008-1068)."""
    supcol = T0C - t
    n0sfac = torch.clamp(pw.exp(ALPHA * supcol), 1.0, N0SMAX / N0S)
    warm = t >= T0C

    lamda_r = _pow(_rd(PIDN0R, torch.clamp(qrs, min=QCRMIN) * den), 0.25)
    lamda_s = _pow(PIDN0S * n0sfac / (torch.clamp(qrs, min=QCRMIN) * den),
                   0.25)
    rslope_r = _where(qrs <= QCRMIN, RSLOPERMAX, _rd(1.0, lamda_r))
    rslope_s = _where(qrs <= QCRMIN, RSLOPESMAX, _rd(1.0, lamda_s))
    rslope = torch.where(warm, rslope_r, rslope_s)
    # rslope ** where(warm, BVTR, BVTS): one pow with a field exponent
    bvt = _where(warm, BVTR, BVTS)
    rslopeb = pw.pow(rslope, bvt)
    rslope2 = rslope * rslope
    rslope3 = rslope2 * rslope
    pvt = _where(warm, PVTR, PVTS)
    vt = pvt * rslopeb * denfac
    vt = torch.where(qrs <= 0.0, 0.0, vt)
    return rslope, rslopeb, rslope2, rslope3, vt, n0sfac


def _cfl(vt, dz, dtcld):
    """(per-column CFL substep count, its largest value over the domain
    read to the host) of a fall at ``vt`` over ``dtcld``: the one host
    read of a ``_sediment`` call."""
    cfl = torch.ceil(torch.amax(dtcld * vt / dz, dim=0))
    cfl = torch.clamp(cfl, min=1.0)
    return cfl, int(torch.amax(cfl).item())


def _sediment(q, vt, den, dz, dtcld, cfl=None):
    """CFL-substepped upwind sedimentation. Returns (q_new, surface_flux
    [kg/m^2 over dtcld], flux_divergence [kg/kg/s] per level).

    The JAX while_loop runs the domain's largest count of substeps, each
    masked by column; here that count is read to the host (``_cfl``, or
    given as ``cfl`` when two fields fall at one velocity)."""
    cfl, n_max = _cfl(vt, dz, dtcld) if cfl is None else cfl
    fall_frac = dtcld / cfl                      # (ny, nx) substep dt

    dist = vt * fall_frac[None]                  # fall distance a substep
    sfc = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    zeros = torch.zeros_like(q[:1])
    for s in range(n_max):
        active = cfl > s
        sed = dist[0] * q[0] * den[0]
        flux = dist[1:] * q[1:] * den[1:]
        gain = torch.cat([flux, zeros], dim=0)
        loss = torch.cat([zeros, flux], dim=0)
        q_new = q + (gain - loss) / (den * dz)
        q_new[0] = q_new[0] + -sed / (dz[0] * den[0])
        q = torch.where(active[None], q_new, q)
        sfc = sfc + torch.where(active, sed, 0.0)
    # flux proxy used by the melting term (fall = den*q*vt/dz)
    fall = den * q * vt / dz
    return q, sfc, fall


def _diffus(x, y):
    return 8.794e-5 * _pow(x, 1.81) / y


def _viscos(x, y):
    return 1.496e-6 * (x * torch.sqrt(x)) / (x + 120.0) / y


def _xka(x, y):
    return 1.414e3 * _viscos(x, y) * y


def wsm3(th, qv, qci, qrs, w_real, exner, p, dz, den, dt, rain, snow):
    """One WSM3 step (wsm32D, mp_wsm3.f90:218-903). All 3D args (z, y, x);
    rain/snow are (y, x) accumulators [mm]; ``dt`` a number or a 0-d
    tensor. One minor loop whatever ``dt`` (the module docstring).

    Returns (th, qv, qci, qrs, rain, snow)."""
    dtcld = _dt_tensor(dt, th)
    t = th * exner
    q = qv

    qci = torch.clamp(qci, min=0.0)
    qrs = torch.clamp(qrs, min=0.0)
    cpm = CPD * (1.0 - torch.clamp(q, min=QMIN)) \
        + torch.clamp(q, min=QMIN) * CPV
    xl = XLV0 - XLV1 * (t - T0C)
    denfac = torch.sqrt(_rd(DEN0, den))

    qs, qs0 = _saturation(t, p)
    rh = torch.clamp(q / qs, min=QMIN)

    # ---- sedimentation -------------------------------------------------
    _, _, _, _, vt_rs, _ = _slopes(qrs, den, denfac, t)
    qrs, sfc_rs, fall = _sediment(qrs, vt_rs, den, dz, dtcld)

    # ice crystal fall velocity [HDC 5a] (mp_wsm3.f90:546-556)
    xni = torch.clamp(5.38e7 * _pow(den * torch.clamp(qci, min=QMIN), 0.75),
                      1e3, 1e6)
    xmi = den * qci / xni
    diameter_i = torch.clamp(DICON * torch.sqrt(xmi), min=1e-25)
    vt_i = torch.where((t < T0C) & (qci > 0.0),
                       1.49e4 * _pow(diameter_i, 1.31), 0.0)
    qci, sfc_i, _ = _sediment(qci, vt_i, den, dz, dtcld)

    # ---- freezing / melting at the 0C level [D89 B16-B17] --------------
    nz = t.shape[0]
    karr = torch.arange(nz, device=t.device)[:, None, None]
    warm3 = t >= T0C
    mstep = torch.amax(torch.where(warm3, karr, -1), dim=0)      # (ny, nx)
    has_melt = mstep >= 0
    m0 = torch.clamp(mstep, min=0)
    w_at = take_level(w_real, m0)
    k1 = torch.where((w_at > 0) & has_melt,
                     torch.clamp(m0 + 1, max=nz - 1), m0)        # freeze lvl
    k2 = m0                                                      # melt lvl

    def gat(a, kk):
        return take_level(a, kk)

    qrsci = gat(qrs, k1) + gat(qci, k1)
    dz1 = gat(dz, k1)
    frzmlt = torch.clamp(-gat(w_real, k1) * qrsci / dz1,
                         -qrsci / dtcld, qrsci / dtcld)
    qrs_k1 = gat(qrs, k1)
    snomlt = torch.clamp(gat(fall, k2) / gat(den, k2),
                         -qrs_k1 / dtcld, qrs_k1 / dtcld)
    apply_m = has_melt & ((qrsci > 0) | (gat(fall, k2) > 0))
    dT1 = torch.where(apply_m, _rd(-XLF0, gat(cpm, k1)) * frzmlt * dtcld,
                      0.0)
    dT2 = torch.where(apply_m, _rd(-XLF0, gat(cpm, k2)) * snomlt * dtcld,
                      0.0)
    onehot1 = (karr == k1[None]).to(t.dtype)
    onehot2 = (karr == k2[None]).to(t.dtype)
    t = t + onehot1 * dT1[None] + onehot2 * dT2[None]

    # ---- surface precipitation ----------------------------------------
    # upwind sedimentation yields the surface mass flux directly [kg/m^2=mm]
    cold_sfc = (T0C - t[0]) > 0
    rain = rain + sfc_rs + torch.where(cold_sfc, sfc_i, 0.0)
    snow = snow + torch.where(cold_sfc, sfc_rs + sfc_i, 0.0)

    # ---- process rates -------------------------------------------------
    rslope, rslopeb, rslope2, rslope3, _, n0sfac = _slopes(qrs, den, denfac,
                                                           t)

    warm = t >= T0C
    xlx = _where(warm, xl, XLS)
    work1 = (xlx * xlx * den / (_xka(t, den) * RV * t * t)
             + _rd(1.0, qs * _diffus(t, p)))                # diffac
    work2 = _pow(_viscos(t, den) / _diffus(t, p), 1.0 / 3.0) \
        / torch.sqrt(_viscos(t, den)) \
        * torch.sqrt(torch.sqrt(_rd(DEN0, den)))            # venfac

    supsat = torch.clamp(q, min=QMIN) - qs
    satdt = supsat / dtcld
    zero = torch.zeros_like(t)

    # warm-rain processes [HDC 16, HL A40, HDC 14]
    paut_w = torch.where(qci > QC0,
                         torch.minimum(QCK1 * _pow(qci, 7.0 / 3.0),
                                       qci / dtcld),
                         0.0)
    pacr_w = torch.where((qrs > QCRMIN) & (qci > QMIN),
                         torch.minimum(PACRR * rslope3 * rslopeb * qci
                                       * denfac, qci / dtcld), 0.0)
    coeres = rslope2 * torch.sqrt(rslope * rslopeb)
    pres_raw = (rh - 1.0) * (PRECR1 * rslope2
                             + PRECR2 * work2 * coeres) / work1
    half_satdt = satdt * inv(2.0)
    pres_w = torch.where(qrs > 0,
                         torch.where(pres_raw < 0,
                                     torch.maximum(torch.maximum(
                                         pres_raw, -qrs / dtcld), half_satdt),
                                     torch.minimum(pres_raw, half_satdt)),
                         0.0)

    # cold processes [HDC 5-16]
    supcol = T0C - t
    eacrs = pw.exp(0.07 * (-supcol))
    xmi = den * qci / xni
    diameter = torch.clamp(DICON * torch.sqrt(torch.clamp(xmi, min=0.0)),
                           max=DIMAX)
    vt2i = 1.49e4 * _pow(torch.clamp(diameter, min=1e-25), 1.31)
    vt2s = PVTS * rslopeb * denfac
    acrfac = 2.0 * rslope3 + 2.0 * diameter * rslope2 \
        + _ipow(diameter, 2) * rslope
    pacr_c = torch.where((qrs > QCRMIN) & (qci > QMIN),
                         torch.minimum(PI * qci * eacrs * N0S * n0sfac
                                       * torch.abs(vt2s - vt2i) * acrfac
                                       * inv(4.0), qci / dtcld), 0.0)
    # pidep: ice deposition/sublimation [HDC 9]
    pisd_raw = 4.0 * diameter * xni * (rh - 1.0) / work1
    pisd_c = torch.where(qci > 0,
                         torch.where(pisd_raw < 0,
                                     torch.maximum(torch.maximum(
                                         pisd_raw, half_satdt),
                                         -qci / dtcld),
                                     torch.minimum(pisd_raw, half_satdt)),
                         0.0)
    ifsat1 = torch.abs(pisd_c) >= torch.abs(satdt)
    # psdep: snow deposition/sublimation [HDC 14]
    supice1 = satdt - pisd_c
    psdep_raw = (rh - 1.0) * n0sfac * (PRECS1 * rslope2
                                       + PRECS2 * work2 * coeres) / work1
    pres_c = torch.where((qrs > 0) & ~ifsat1,
                         torch.where(psdep_raw < 0,
                                     torch.maximum(torch.maximum(
                                         psdep_raw, -qrs / dtcld),
                                         torch.maximum(half_satdt, supice1)),
                                     torch.minimum(torch.minimum(
                                         psdep_raw, half_satdt), supice1)),
                         0.0)
    ifsat2 = ifsat1 | (torch.abs(pisd_c + pres_c) >= torch.abs(satdt))
    # pigen: ice nucleation [HDC 7-8]
    supice2 = satdt - pisd_c - pres_c
    xni0 = 1e3 * pw.exp(0.1 * supcol)
    roqi0 = 4.92e-11 * _pow(xni0, 1.33)
    pgen_c = torch.where((supsat > 0) & ~ifsat2,
                         torch.minimum(torch.minimum(torch.clamp(
                             (roqi0 / den - torch.clamp(qci, min=0.0))
                             / dtcld, min=0.0), satdt), supice2),
                         0.0)
    # psaut: ice aggregation to snow [HDC 12]
    qimax = _rd(ROQIMAX, den)
    paut_c = torch.where(qci > 0,
                         torch.clamp((qci - qimax) / dtcld, min=0.0), 0.0)

    paut = torch.where(warm, paut_w, paut_c)
    pacr = torch.where(warm, pacr_w, pacr_c)
    pres = torch.where(warm, pres_w, pres_c)
    pisd = torch.where(warm, zero, pisd_c)
    pgen = torch.where(warm, zero, pgen_c)

    # ---- conservation scaling (mp_wsm3.f90:822-858) --------------------
    qciik = torch.clamp(qci, min=QMIN)
    delqci = (paut + pacr - pgen - pisd) * dtcld
    facqci = torch.where(delqci >= qciik,
                         qciik / torch.where(delqci == 0, 1.0, delqci), 1.0)
    paut, pacr, pgen, pisd = (x * facqci for x in (paut, pacr, pgen, pisd))
    qik = torch.clamp(q, min=QMIN)
    delq = (pres + pgen + pisd) * dtcld
    facq = torch.where(delq >= qik,
                       qik / torch.where(delq == 0, 1.0, delq), 1.0)
    pres, pgen, pisd = (x * facq for x in (pres, pgen, pisd))

    dq = -(pres + pgen + pisd)
    q = q + dq * dtcld
    qci = torch.clamp(qci - (paut + pacr - pgen - pisd) * dtcld, min=0.0)
    qrs = torch.clamp(qrs + (paut + pacr + pres) * dtcld, min=0.0)
    t = t - _where(t < T0C, XLS, xl) * dq / cpm * dtcld

    # ---- condensation of cloud water (pcond) ---------------------------
    ttp = T0C + 0.01
    tr = _rd(ttp, t)
    dldt = CPV - CLIQ
    xa = -dldt / RV
    xb = xa + XLV0 / (RV * ttp)
    es_w = PSAT * _pow(tr, xa) * pw.exp(xb * (1.0 - tr))
    es_w = torch.minimum(es_w, 0.99 * p)
    qs_w = torch.clamp(EP2 * es_w / (p - es_w), min=QMIN)
    work1c = (torch.clamp(q, min=QMIN) - qs_w) \
        / (1.0 + xl * xl / (RV * cpm) * qs_w / (t * t))     # conden
    pcon = torch.minimum(torch.clamp(work1c, min=0.0),
                         torch.clamp(q, min=0.0)) / dtcld
    pcon = torch.where((qci > 0) & (work1c < 0) & (t > T0C),
                       torch.maximum(work1c, -qci) / dtcld, pcon)
    q = q - pcon * dtcld
    qci = torch.clamp(qci + pcon * dtcld, min=0.0)
    t = t + pcon * xl / cpm * dtcld

    # padding for small values
    qci = torch.where(qci <= QMIN, 0.0, qci)
    qrs = torch.where(qrs <= QCRMIN, 0.0, qrs)

    th = t / exner
    return th, q, qci, qrs, rain, snow

"""G. Thompson cloud-fraction scheme (icloud=3) (icar_tpu/physics/
cloud_fraction.py; cal_cldfra3 and its deck adjustments,
atm_utilities.f90:727-1146): a scale-aware cloud fraction per level,
then a water path spread over each contiguous cloud deck, for the RRTMG
call only (the prognostic qc and qi are not modified).

The JAX package's vectorised deck walk, expression by expression: the
per-level run extents are level loops, the deck sums cumulative sums in
XLA's order (``pointwise.cumsum``), the column sums sequential, and a
division by a constant a product with its float32 reciprocal. Plain
PyTorch on the card (no TPU kernel exists).
"""

from __future__ import annotations

import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .mp_thompson import rsif, rslf
from .rrtmg_lw import _rdiv, level_sum

ENTRAINMENT = 0.5   # entrmnt (atm_utilities.f90:744)


def _run_extents(mask):
    """For the boolean mask (nz, ...): per level, the index of the top and
    of the bottom of the contiguous True run holding it (-1 where
    False)."""
    nz = mask.shape[0]
    minus1 = torch.full(mask.shape[1:], -1, dtype=torch.int32,
                        device=mask.device)

    def own(k):
        return torch.full_like(minus1, k)
    tops = [None] * nz
    tops[nz - 1] = torch.where(mask[nz - 1], own(nz - 1), minus1)
    for k in range(nz - 2, -1, -1):
        start = mask[k] & ~mask[k + 1]
        tops[k] = torch.where(mask[k], torch.where(start, own(k),
                                                   tops[k + 1]), minus1)
    bots = [None] * nz
    bots[0] = torch.where(mask[0], own(0), minus1)
    for k in range(1, nz):
        start = mask[k] & ~mask[k - 1]
        bots[k] = torch.where(mask[k], torch.where(start, own(k),
                                                   bots[k - 1]), minus1)
    return torch.stack(tops), torch.stack(bots)


def _deck_adjust(cfr, q_in, extra, qvs, t, dz, mask, top, bot, t_min):
    """The shared body of adjust_cloudIce/adjust_cloudH2O
    (atm_utilities.f90:1005-1082) for all decks at once: the per-level
    increment of the species ``q_in`` (``extra`` is the further sink the
    deck's budget subtracts: snow for ice, zeros for water)."""
    nz = cfr.shape[0]
    dzb3 = dz.expand(cfr.shape)
    csum_dz = pw.cumsum(dzb3, 0)
    qx = q_in + extra
    csum_q = pw.cumsum(qx, 0)

    topc = torch.clamp(top, 0, nz - 1)
    botc = torch.clamp(bot, 0, nz - 1)
    g = take_level
    dz_bot = g(dzb3, botc)
    tdz = g(csum_dz, topc) - g(csum_dz, botc) + dz_bot
    sum_q = g(csum_q, topc) - g(csum_q, botc) + g(qx, botc)
    max_wc = torch.abs(g(qvs, topc) - g(qvs, botc))
    max_wc = torch.clamp(max_wc - sum_q, min=1e-6)
    max_wc = torch.clamp(max_wc, max=1e-3)

    this_dz = csum_dz - g(csum_dz, botc) + 0.5 * dz_bot
    wc = torch.clamp(max_wc * this_dz / torch.clamp(tdz, min=1e-12)
                     * (1.0 - ENTRAINMENT), min=1e-6)
    return torch.where(mask & (cfr > 0.0) & (cfr < 1.0) & (t >= t_min),
                       cfr * cfr * wc, torch.zeros_like(cfr))


def frac_between(cfr):
    return (cfr > 0.0) & (cfr < 1.0)


def cal_cldfra3(qv, qc, qi, qs, dz, p, t, xland, gridkm, max_relh=1.5):
    """Cloud fraction + subgrid condensate for radiation (cal_cldfra3,
    atm_utilities.f90:727-843, called with modify_qvapor=.False.,
    max_relh=1.5 from ra_driver.f90:328). Inputs (nz, ny, nx) but xland
    (ny, nx) and the number gridkm. Returns (cldfra, qc_rad, qi_rad)."""
    nz = qv.shape[0]
    dev = qv.device
    zero = torch.zeros((), dtype=qv.dtype, device=dev)
    qvsw = rslf(p, t)
    qvsi = rsif(p, t)
    tc = t - 273.15
    qvs = torch.where(tc >= -12.0, qvsw,
                      torch.where(tc < -35.0, qvsi,
                                  qvsw - (qvsw - qvsi) * (-12.0 - tc)
                                  * inv(23.0)))
    rh = torch.clamp(qv / qvs, min=0.01)
    rhoa = p / (287.0 * t)

    # first-cut scale-aware cldfra (:774-825)
    delz = torch.clamp(dz, min=100.0)
    g2 = gridkm * gridkm
    rh_00l = 0.65 + torch.sqrt(1.0 / (25.0 + g2 * delz * 0.01))
    rh_00o = 0.81 + torch.sqrt(1.0 / (50.0 + g2 * delz * 0.01))
    explicit = (qc > 1e-7) | (qi >= 1e-7) | ((qs > 1e-6) & (t < 273.0))
    rh_00 = torch.where((xland[None] - 1.5) > 0.0, rh_00o, rh_00l)
    rh_00 = torch.where(tc < -12.0, rh_00l, rh_00)

    # tc >= -12: Sundqvist form against 1.005
    rhum_w = torch.clamp(rh, max=1.0)
    cf_warm = torch.clamp(1.0 - torch.sqrt(torch.clamp(
        (1.005 - rhum_w) / (1.005 - rh_00), min=0.0)), min=0.0)
    # tc < -12: HRRR branch (max_relh=1.5 > 1.12, :806-812)
    rhum_c = torch.clamp(rh, max=1.45)
    rh_00c = torch.clamp(rh_00 + (1.45 - rh_00) * (-12.0 - tc)
                         * inv(88.0), max=1.45)
    cf_cold = torch.clamp(1.0 - torch.sqrt(torch.clamp(
        (1.5 - rhum_c) / (1.5 - rh_00c), min=0.0)), min=0.0)
    cldfra = torch.where(tc >= 20.0, zero,
                         torch.where(tc >= -12.0, cf_warm, cf_cold))
    cldfra = torch.where(cldfra > 0.0, torch.clamp(cldfra, 0.01, 0.9),
                         cldfra)
    cldfra = torch.where(explicit, torch.ones_like(cldfra), cldfra)
    # qvs(k) = qv(k) inside explicit cloud feeds the deck budgets (:787)
    qvs = torch.where(explicit, qv, qvs)

    # --- find_cloudLayers (:846-1001), 0-based indices ------------------
    kk = torch.arange(nz, dtype=torch.int32, device=dev)[:, None, None]
    kk = kk.expand(qv.shape)
    theta = t * pw.pow(_rdiv(100000.0, p), 287.05 / 1004.0)

    # highest level warmer than -12C below ~100 hPa (:869-873)
    m12 = (t - 273.16 > -12.0) & (p > 10100.0)
    k_m12c = torch.amax(torch.where(m12, kk, torch.zeros_like(kk)), dim=0)

    # tropopause surrogate: highest k in [0, nz-4] with weak
    # d(theta)/dz (:893-901)
    th2 = torch.cat([theta[2:], theta[-1:], theta[-1:]], dim=0)
    dz3 = dz + torch.cat([dz[1:], dz[-1:]], dim=0) \
        + torch.cat([dz[2:], dz[-1:], dz[-1:]], dim=0)
    trop = (((th2 - theta) / dz3 < 10.0 / 1500.0) & (p > 8500.0)) \
        | (p > 70000.0)
    trop = trop & (kk < nz - 3)
    k_match = torch.amax(torch.where(trop, kk, torch.full_like(kk, -1)),
                         dim=0)
    k_tropo = torch.clamp(k_match + 2, 2, nz - 2)

    # no fractional clouds above the tropopause (:911-915)
    frac = frac_between(cldfra)
    cldfra = torch.where(frac & (kk > k_tropo[None]), zero, cldfra)

    # LCL-ish base: first stable level above k=2 (:921-928)
    dth = theta - torch.cat([theta[:1], theta[:-1]], dim=0)
    stable = (dth > 0.025e-3 * dz) & (kk >= 2) & (kk <= k_m12c[None])
    first_k = torch.amin(torch.where(stable, kk, (k_m12c[None] + 1)
                                     .expand_as(kk)), dim=0)
    kbot = torch.clamp(first_k - 2, min=1)
    frac = frac_between(cldfra)
    cldfra = torch.where(frac & (kk <= kbot[None]), zero, cldfra)

    # --- cloud decks (runs of cldfra >= 0.01) ---------------------------
    base = cldfra >= 0.01
    ice_band = base & (kk >= k_m12c[None] + 1) & (kk <= k_tropo[None])
    itop, ibot = _run_extents(ice_band)
    examined_i = itop >= k_m12c[None] + 2
    multi_i = examined_i & (itop - ibot >= 1)
    single_i = examined_i & (itop == ibot)
    qi_inc = _deck_adjust(cldfra, qi, qs, qvs, t, dz, ice_band & multi_i,
                          itop, ibot, 203.16)
    qi_rad = qi + qi_inc
    qi_rad = torch.where(ice_band & single_i & frac_between(cldfra),
                         0.05 * qvs, qi_rad)

    # water decks from min(nz-1, k_m12C+2) down to kbot+1 (:973-999)
    wtop_start = torch.clamp(k_m12c + 2, max=nz - 1)
    water_band = base & (kk >= kbot[None] + 1) & (kk <= wtop_start[None])
    wtop, wbot = _run_extents(water_band)
    examined_w = wtop > kbot[None]
    multi_w = examined_w & (wtop - wbot >= 1)
    single_w = examined_w & (wtop == wbot)
    qc_inc = _deck_adjust(cldfra, qc, torch.zeros_like(qc), qvs, t, dz,
                          water_band & multi_w, wtop, wbot, 253.16)
    qc_rad = qc + qc_inc
    qc_rad = torch.where(water_band & single_w & frac_between(cldfra),
                         0.05 * qvs, qc_rad)

    # --- adjust_cloudFinal: cap the column LWP/IWP the scheme added at
    # 1.5 mm by scaling the fractional-cloud levels (:1089-1146)
    cloudy = cldfra > 0.0
    lwp = level_sum(torch.where(cloudy, qc_rad * rhoa * dz, zero))
    iwp = level_sum(torch.where(cloudy, qi_rad * rhoa * dz, zero))
    fracl = frac_between(cldfra)
    qc_rad = torch.where(fracl & (lwp[None] > 1.5),
                         qc_rad * _rdiv(1.5, torch.clamp(lwp[None],
                                                         min=1.5)), qc_rad)
    qi_rad = torch.where(fracl & (iwp[None] > 1.5),
                         qi_rad * _rdiv(1.5, torch.clamp(iwp[None],
                                                         min=1.5)), qi_rad)
    return cldfra, qc_rad, qi_rad

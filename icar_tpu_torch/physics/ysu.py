"""YSU nonlocal planetary-boundary-layer scheme (Hong, Noh & Dudhia 2006)
(icar_tpu/physics/ysu.py; pbl_ysu.f90 ysu2d and the surface-layer
similarity of pbl_utilities.f90:69-544, as pbl_driver.f90:223-346 drives
them). Columns are the trailing (ny, nx) axes, level 0 the lowest; the
lowest ``nz - 1`` levels are diffused. As in the reference driver the
momentum tendencies are dropped, so the momentum solve is skipped.

The JAX package's vectorised form, expression by expression: the
bulk-Richardson PBL-top searches and the tridiagonal solve are Python
level loops over whole fields, the heights a cumulative sum in XLA's
order (``pointwise.cumsum``), a division by a constant a product with its
float32 reciprocal; no value is read back to the host. Plain PyTorch on
the card (no TPU kernel exists).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .rrtmg_lw import _rdiv

# scheme parameters (pbl_ysu.f90:316-337)
XKZMIN, XKZMAX = 0.01, 1000.0
RIMIN = -100.0
RLAM = 30.0
PRMIN, PRMAX = 0.25, 4.0
BRCR_UB, BRCR_SB = 0.0, 0.25
CORI = 1e-4
AFAC = 6.8
BFAC = 6.8
PFAC = 2.0
PHIFAC = 8.0
SFCFRAC = 0.1
D1, D2, D3 = 0.02, 0.05, 0.001
H1, H2 = 0.33333335, 0.6666667
CKZ = 0.001
ZFMIN = 1e-8
APHI5, APHI16 = 5.0, 16.0
TMIN = 1e-2
GAMCRT, GAMCRQ = 3.0, 2e-3


class SurfaceLayer(NamedTuple):
    psim: torch.Tensor
    psih: torch.Tensor
    regime: torch.Tensor
    u10: torch.Tensor
    v10: torch.Tensor
    t2: torch.Tensor
    q2: torch.Tensor


def _sat_q(t, p):
    """Saturated specific humidity (da_tp_to_qs equivalent)."""
    es = 611.2 * torch.exp(17.67 * (t - 273.15) / (t - 29.65))
    return 0.622 * es / (p - 0.378 * es)


def _theta(t, p, rcp):
    """t (1000 hPa / p) ** rcp, with p in Pa."""
    return t * pw.pow(_rdiv(1000.0, p * inv(100.0)), rcp)


def surface_layer(psfc, tg, ps1, ts1, qs1, us1, vs1, hs, roughness, xland,
                  dx, ust, hfx, qfx):
    """Similarity stability functions + 10 m / 2 m diagnostics (da_sfc_wtq,
    pbl_utilities.f90:69-544). ``xland``: 1 land, 2 water; ``ust`` the
    friction velocity supplied from outside (the use_ust_wrf path); ``dx``
    a number."""
    rcp = C.RD / C.CP
    k_kar = 0.4
    ka = 2.4e-5
    zero = torch.zeros((), dtype=tg.dtype, device=tg.device)

    z0 = torch.clamp(roughness, min=0.0001)
    zq0 = torch.where(xland >= 1.5, z0, torch.full_like(z0, 0.01))
    gzsoz0 = torch.log(hs / z0)
    gz10oz0 = torch.log(_rdiv(10.0, z0))
    gz2oz0 = torch.log(_rdiv(2.0, z0))

    tvs = ts1 * (1.0 + 0.608 * qs1)
    qg_s = _sat_q(tg, psfc)
    qg = qg_s * (1.0 - qg_s)       # specific humidity -> mixing ratio
    tvg = tg * (1.0 + 0.608 * qg)
    ths = _theta(ts1, ps1, rcp)
    thg = _theta(tg, psfc, rcp)
    thvs = _theta(tvs, ps1, rcp)
    thvg = _theta(tvg, psfc, rcp)

    va2 = us1 * us1 + vs1 * vs1
    vc2 = torch.clamp(thvg - thvs, min=0.0)
    vsgd = 0.32 * torch.pow(torch.tensor(max(dx / 5000.0 - 1.0, 0.0),
                                         device=tg.device), 0.33)
    wspd = torch.clamp(torch.sqrt(va2 + vc2 + vsgd * vsgd), min=0.1)
    v2 = wspd * wspd

    rib = (C.GRAVITY * hs / ths) * (thvs - thvg) / v2
    mol = k_kar * (ths - thg) / gzsoz0

    # regimes (pbl_utilities.f90:325-343)
    regime = torch.where(rib >= 0.2, torch.full_like(rib, 1.1),
                         torch.where(rib > 0.0, torch.full_like(rib, 2.1),
                                     torch.where(rib == 0.0,
                                                 torch.full_like(rib, 3.1),
                                                 torch.full_like(rib, 4.1))))

    psim_1 = torch.clamp(-10.0 * gzsoz0, min=-10.0)
    psim_2 = torch.clamp((-5.0 * rib) * gzsoz0 / (1.1 - 5.0 * rib),
                         min=-10.0)
    # free convection (regime 4)
    cc = 2.0 * torch.atan(torch.ones_like(rib))
    hol = torch.where(ust < 0.01, rib * gzsoz0,
                      k_kar * C.GRAVITY * hs * mol / (ths * ust * ust))
    hol = torch.clamp(hol, -9.9999, 0.0)
    holz = torch.clamp(_rdiv(10.0, hs) * hol, -9.9999, 0.0)
    hol2 = torch.clamp(_rdiv(2.0, hs) * hol, -9.9999, 0.0)

    def psi_unstable(h):
        xx = pw.pow(1.0 - 16.0 * h, 0.25)
        yy = torch.log((1.0 + xx * xx) * inv(2.0))
        psim = 2.0 * torch.log((1.0 + xx) * inv(2.0)) + yy \
            - 2.0 * torch.atan(xx) + cc
        return psim, 2.0 * yy

    psim_4, psih_4 = psi_unstable(hol)
    psimz4, psihz4 = psi_unstable(holz)
    psim24, psih24 = psi_unstable(hol2)
    psim_4 = torch.minimum(psim_4, 0.9 * gzsoz0)
    psih_4 = torch.minimum(psih_4, 0.9 * gzsoz0)
    psimz4 = torch.minimum(psimz4, 0.9 * gz10oz0)
    psim24 = torch.minimum(psim24, 0.9 * gz2oz0)
    psih24 = torch.minimum(psih24, 0.9 * gz2oz0)

    reg = torch.round(regime)
    r1, r2, r3 = reg == 1, reg == 2, reg == 3
    psim = torch.where(r1, psim_1, torch.where(
        r2, psim_2, torch.where(r3, zero, psim_4)))
    psih = torch.where(r1 | r2, psim, torch.where(r3, zero, psih_4))
    psimz = torch.where(r1 | r2, torch.clamp(_rdiv(10.0, hs) * psim,
                                             min=-10.0),
                        torch.where(r3, zero, psimz4))
    psih2 = torch.where(r1 | r2, torch.clamp(_rdiv(2.0, hs) * psim,
                                             min=-10.0),
                        torch.where(r3, zero, psih24))

    psiw = gzsoz0 - psim
    psiz = gz10oz0 - psimz
    psit = torch.clamp(gzsoz0 - psih, min=2.0)
    psit2 = gz2oz0 - psih2
    psiq = torch.log(k_kar * ust * hs * inv(ka) + hs / zq0) - psih
    psiq2 = torch.log(k_kar * ust * 2.0 * inv(ka) + _rdiv(2.0, zq0)) \
        - psih2

    # over water: viscous sublayer roughness (pbl_utilities.f90:489-503)
    visc = (1.32 + 0.009 * (ts1 - 273.15)) * 1e-5
    restar = ust * z0 / torch.clamp(visc, min=1e-10)
    z0t = torch.clamp(5.5e-5 * pw.pow(torch.clamp(restar, min=1e-10),
                                      -0.60), 2e-9, 1e-4)
    water = xland >= 1.5
    lt_h = torch.clamp(torch.log((hs + z0t) / z0t) - psih, min=2.0)
    lt_2 = torch.clamp(torch.log((2.0 + z0t) / z0t) - psih2, min=2.0)
    psiq = torch.where(water, lt_h, psiq)
    psit = torch.where(water, lt_h, psit)
    psiq2 = torch.where(water, lt_2, psiq2)
    psit2 = torch.where(water, lt_2, psit2)

    u10 = us1 * psiz / psiw
    v10 = vs1 * psiz / psiw
    # has_lsm flux-based 2m diagnostics (pbl_utilities.f90:517-541)
    cqs2 = ust * k_kar / psiq2
    chs2 = torch.where(water, ust * k_kar / psit2, cqs2)
    rho = psfc / (C.RD * tg)
    q2 = torch.where(cqs2 < 1e-5, qg, qg - qfx / (rho * cqs2))
    t2 = torch.where(chs2 < 1e-5, tg, tg - hfx / (rho * C.CP * chs2))
    return SurfaceLayer(psim, psih, regime, u10, v10, t2, q2)


# ---------------------------------------------------------------------------
# the PBL scheme (ysu2d)
# ---------------------------------------------------------------------------


def _pbl_height_scan(thvx, thermal, ux, vx, za, br0, brcr, active, klpbl):
    """The bulk-Richardson PBL-top search (pbl_ysu.f90:626-652 and
    repeats) as a masked sweep up the levels. Returns (kpbl, brdn,
    brup)."""
    stable = ~active
    brup = br0
    brdn = torch.zeros_like(br0)
    kpbl = torch.ones(br0.shape, dtype=torch.int32, device=br0.device)
    g_over_thv1 = _rdiv(C.GRAVITY, thvx[0])
    for k in range(1, klpbl):
        upd = ~stable
        spdk2 = torch.clamp(ux[k] * ux[k] + vx[k] * vx[k], min=1.0)
        brup_new = (thvx[k] - thermal) * (g_over_thv1 * za[k]) / spdk2
        brdn = torch.where(upd, brup, brdn)
        brup = torch.where(upd, brup_new, brup)
        kpbl = torch.where(upd, torch.full_like(kpbl, k), kpbl)
        stable = stable | (upd & (brup > brcr))
    return kpbl, brdn, brup


def _interp_hpbl(kpbl, brdn, brup, brcr, za):
    """hpbl from the bracketing Richardson values (pbl_ysu.f90:654-666)."""
    zero = torch.zeros_like(brdn)
    brint = torch.where(brdn >= brcr, zero, torch.where(
        brup <= brcr, torch.ones_like(brdn),
        (brcr - brdn) / torch.where(brup == brdn, torch.ones_like(brdn),
                                    brup - brdn)))
    za_km1 = take_level(za, torch.clamp(kpbl - 1, min=0))
    za_k = take_level(za, kpbl)
    return za_km1 + brint * (za_k - za_km1)


def _tridiag_solve(lower, diag, upper, rhs_list, nzt):
    """The Thomas algorithm of tridin (pbl_ysu.f90:1154-1234), vectorised
    over the columns: lower[k] multiplies x[k-1] in row k, upper[k]
    x[k+1]."""
    au = [None] * nzt
    fs = [[None] * nzt for _ in rhs_list]
    fk = 1.0 / diag[0]
    au[0] = fk * upper[0]
    for n, r in enumerate(rhs_list):
        fs[n][0] = fk * r[0]
    for k in range(1, nzt):
        fk = 1.0 / (diag[k] - lower[k] * au[k - 1])
        au[k] = fk * upper[k] if k < nzt - 1 else None
        for n, r in enumerate(rhs_list):
            fs[n][k] = fk * (r[k] - lower[k] * fs[n][k - 1])
    for k in range(nzt - 2, -1, -1):
        for n in range(len(rhs_list)):
            fs[n][k] = fs[n][k] - au[k] * fs[n][k + 1]
    return [torch.stack(f) for f in fs]


def ysu(ux, vx, th, t, qv, qc, qi, p, p_i, exner, dz8w, z, terrain, psfc,
        tsk, znt, xland, hfx, qfx, ust, u10, v10, psim, psih, br, dt):
    """One YSU step (ysu2d, pbl_ysu.f90:266-1152), the scalar tendencies
    applied (pbl_driver.f90:343-346). 3-D arguments (nz, ny, nx), 2-D
    (ny, nx); ``dt`` a 0-d float32 tensor. Returns (th, qv, qc, qi, hpbl,
    kpbl, exch_h)."""
    nz = th.shape[0]
    nzt = nz - 1                      # levels diffused (driver passes kte-1)
    klpbl = nzt
    karman = C.KARMAN
    # the diagnostic ustar is unset (0) on the domain's edge
    ust = torch.clamp(ust, min=1e-4)

    thx = th
    tvcon = 1.0 + C.EP1 * qv
    thvx = thx * tvcon
    rhox = psfc / (C.RD * t[0])
    govrth = _rdiv(C.GRAVITY, thx[0])
    cpm = C.CP * (1.0 + 0.8 * qv[0])

    # heights above ground (zq at interfaces incl. surface=0)
    zq = torch.cat([torch.zeros_like(dz8w[:1]), pw.cumsum(dz8w, 0)], dim=0)
    za = 0.5 * (zq[:-1] + zq[1:])
    del_p = p_i[:-1] - p_i[1:]
    dza = torch.cat([za[:1], za[1:] - za[:-1]], dim=0)
    zl1 = za[0]

    dt2 = 2.0 * dt
    rdt = 1.0 / dt2
    zero = torch.zeros((), dtype=th.dtype, device=th.device)

    sfcflg = br <= 0.0
    thermal0 = thvx[0]

    # first guess of pbl height (pbl_ysu.f90:626-666)
    kpbl, brdn, brup = _pbl_height_scan(
        thvx, thermal0, ux, vx, za, br, BRCR_UB,
        torch.ones_like(br, dtype=torch.bool), klpbl)
    hpbl = _interp_hpbl(kpbl, brdn, brup, BRCR_UB, za)
    one_i = torch.ones_like(kpbl)
    kpbl = torch.where(hpbl < zq[1], one_i, kpbl)
    pblflg = kpbl > 1

    # surface scales (pbl_ysu.f90:668-696)
    lz = torch.log(za[0] / torch.clamp(znt, min=1e-4))
    fm = lz - psim
    fh = lz - psih
    hol = torch.clamp(br * fm * fm / torch.where(
        fh == 0, torch.full_like(fh, 1e-10), fh), min=RIMIN)
    hol = torch.where(sfcflg, torch.clamp(hol, max=-ZFMIN),
                      torch.clamp(hol, min=ZFMIN))
    hol1 = hol * hpbl / zl1 * SFCFRAC
    phim = torch.where(sfcflg, pw.pow(1.0 - APHI16 * hol1, -0.25),
                       1.0 + APHI5 * hol1)
    phih = torch.where(sfcflg, pw.pow(1.0 - APHI16 * hol1, -0.5), phim)
    bfx0 = torch.clamp(hfx / rhox / cpm + C.EP1 * thx[0] * qfx / rhox,
                       min=0.0)
    wstar3 = torch.where(sfcflg, govrth * bfx0 * hpbl, zero)
    ust3 = ust * (ust * ust)
    wscale = pw.pow(ust3 + PHIFAC * karman * wstar3 * 0.5, H1)
    wscale = torch.minimum(torch.maximum(wscale, ust * inv(APHI5)),
                           ust * APHI16)

    # countergradient terms + thermal excess (pbl_ysu.f90:698-716)
    gamfac = _rdiv(BFAC, rhox) / wscale
    hgamt = torch.where(sfcflg, torch.clamp(gamfac * hfx / cpm, 0.0,
                                            GAMCRT), zero)
    hgamq = torch.where(sfcflg, torch.clamp(gamfac * qfx, 0.0, GAMCRQ),
                        zero)
    vpert = (hgamt + C.EP1 * thx[0] * hgamq) * inv(BFAC) * AFAC
    thermal = thermal0 + torch.where(sfcflg, torch.clamp(vpert, min=0.0),
                                     zero)
    pblflg = pblflg & sfcflg

    # enhanced pbl height with thermal excess (pbl_ysu.f90:718-760)
    kpbl2, brdn2, brup2 = _pbl_height_scan(
        thvx, thermal, ux, vx, za, br, BRCR_UB, pblflg, klpbl)
    hpbl2 = _interp_hpbl(kpbl2, brdn2, brup2, BRCR_UB, za)
    kpbl = torch.where(pblflg, kpbl2, kpbl)
    hpbl = torch.where(pblflg, hpbl2, hpbl)
    kpbl = torch.where(pblflg & (hpbl < zq[1]), one_i, kpbl)
    pblflg = pblflg & (kpbl > 1)

    # stable boundary layer height (pbl_ysu.f90:762-813)
    need_sbl = (~sfcflg) & (hpbl < zq[1])
    wspd10 = torch.sqrt(u10 * u10 + v10 * v10)
    ross = wspd10 / (CORI * torch.clamp(znt, min=1e-6))
    brcr_sbro = torch.clamp(0.16 * pw.pow(1e-7 * torch.clamp(
        ross, min=1e-10), -0.18), max=0.3)
    brcr_sb = torch.where(xland >= 1.5, brcr_sbro,
                          torch.full_like(brcr_sbro, BRCR_SB))
    kpbl3, brdn3, brup3 = _pbl_height_scan(
        thvx, thermal, ux, vx, za, br, brcr_sb, need_sbl, klpbl)
    hpbl3 = _interp_hpbl(kpbl3, brdn3, brup3, brcr_sb, za)
    kpbl = torch.where(need_sbl, kpbl3, kpbl)
    hpbl = torch.where(need_sbl, hpbl3, hpbl)
    kpbl = torch.where(need_sbl & (hpbl < zq[1]), one_i, kpbl)
    pblflg = pblflg & torch.where(need_sbl, kpbl > 1,
                                  torch.ones_like(pblflg))

    # entrainment parameters (pbl_ysu.f90:815-850)
    km1 = torch.clamp(kpbl - 1, min=0)
    gat = take_level
    wm3 = wstar3 + 5.0 * ust3
    wm2 = pw.pow(wm3, H2)
    bfxpbl = -0.15 * thvx[0] * inv(C.GRAVITY) * wm3 \
        / torch.clamp(hpbl, min=1.0)
    dthvx = torch.clamp(gat(thvx, km1 + 1) - gat(thvx, km1), min=TMIN)
    dthx = torch.clamp(gat(thx, km1 + 1) - gat(thx, km1), min=TMIN)
    dqx = torch.clamp(gat(qv, km1 + 1) - gat(qv, km1), max=0.0)
    we = torch.maximum(bfxpbl / dthvx, -torch.sqrt(wm2))
    hfxpbl = torch.where(pblflg, we * dthx, zero)
    qfxpbl = torch.where(pblflg, we * dqx, zero)
    delb = govrth * D3 * hpbl
    delta = torch.clamp(D1 * hpbl + D2 * wm2 / torch.clamp(delb, min=1e-10),
                        max=100.0)

    karr = torch.arange(nzt, device=th.device)[:, None, None]
    kp = kpbl[None]
    in_pbl = pblflg[None] & (karr < kp)
    zq_f = zq[1:nzt + 1]
    ez = (zq_f - hpbl[None]) / torch.clamp(delta[None], min=1e-10)
    entfac = torch.where(pblflg[None] & (karr >= kp), ez * ez,
                         torch.full_like(ez, 1e30))

    # diffusivities below pbl top (pbl_ysu.f90:852-876)
    zfac = torch.clamp(1.0 - (zq_f - zl1[None]) / torch.clamp(
        hpbl[None] - zl1[None], min=1e-10), ZFMIN, 1.0)
    xkzo = CKZ * dza[1:nzt + 1]
    omz = 1.0 - zfac
    zfacent = omz * (omz * omz)
    pz = torch.clamp(zq_f - SFCFRAC * hpbl[None], min=0.0)
    hz = torch.clamp(hpbl[None], min=1.0)
    prnumfac = -3.0 * (pz * pz) / (hz * hz)
    prnum0 = phih / phim + BFAC * karman * SFCFRAC
    prnum = 1.0 + (prnum0[None] - 1.0) * torch.exp(prnumfac)
    prnum = torch.clamp(prnum, PRMIN, PRMAX)
    wscalek = pw.pow(ust3[None] + PHIFAC * karman * wstar3[None]
                     * (1.0 - zfac), H1)
    xkzm_pbl = xkzo + wscalek * karman * zq_f * (zfac * zfac)
    xkzh_pbl = xkzm_pbl / prnum
    xkzm_pbl = torch.clamp(xkzm_pbl, XKZMIN, XKZMAX)
    xkzh_pbl = torch.clamp(xkzh_pbl, XKZMIN, XKZMAX)

    # free-atmosphere diffusivities (pbl_ysu.f90:878-930)
    du = ux[1:nzt + 1] - ux[:nzt]
    dv = vx[1:nzt + 1] - vx[:nzt]
    dzap = dza[1:nzt + 1]
    ss = (du * du + dv * dv) / (dzap * dzap) + 1e-9
    govrthv = _rdiv(C.GRAVITY, 0.5 * (thvx[1:nzt + 1] + thvx[:nzt]))
    ri = govrthv * (thvx[1:nzt + 1] - thvx[:nzt]) / (ss * dzap)
    # moist adiabatic correction inside cloud (imvdif)
    cloudy = ((qc[:nzt] + qi[:nzt]) > 0.01e-3) \
        & ((qc[1:nzt + 1] + qi[1:nzt + 1]) > 0.01e-3)
    qmean = 0.5 * (qv[:nzt] + qv[1:nzt + 1])
    tmean = 0.5 * (t[:nzt] + t[1:nzt + 1])
    alph = C.LH_VAPORIZATION * qmean * inv(C.RD) / tmean
    chi = (C.LH_VAPORIZATION ** 2) * qmean * inv(C.CP) * inv(C.RW) \
        / (tmean * tmean)
    ri_moist = (1.0 + alph) * (
        ri - _rdiv(C.GRAVITY ** 2, ss) / tmean * inv(C.CP)
        * ((chi - alph) / (1.0 + chi)))
    ri = torch.where(cloudy, ri_moist, ri)
    zk = karman * zq_f
    rl = zk * RLAM / (RLAM + zk)
    rl2 = rl * rl
    dk = rl2 * torch.sqrt(ss)
    sri = torch.sqrt(torch.clamp(-ri, min=0.0))
    xkzm_free_u = xkzo + dk * (1 + 8.0 * (-ri) / (1 + 1.746 * sri))
    xkzh_free_u = xkzo + dk * (1 + 8.0 * (-ri) / (1 + 1.286 * sri))
    r5 = 1 + 5.0 * ri
    xkzh_free_s = xkzo + dk / (r5 * r5)
    prnum_s = torch.clamp(1.0 + 2.1 * ri, max=PRMAX)
    xkzm_free_s = (xkzh_free_s - xkzo) * prnum_s + xkzo
    unstable_f = ri < 0
    xkzm_free = torch.where(unstable_f, xkzm_free_u, xkzm_free_s)
    xkzh_free = torch.where(unstable_f, xkzh_free_u, xkzh_free_s)
    xkzm_free = torch.clamp(xkzm_free, XKZMIN, XKZMAX)
    xkzh_free = torch.clamp(xkzh_free, XKZMIN, XKZMAX)

    xkzh = torch.where(in_pbl, xkzh_pbl, xkzh_free)
    # entrainment-layer blending (pbl_ysu.f90:986-990); NOTE reference
    # quirk preserved: the heat matrix uses xkzh from before this
    # overwrite, so the blend reaches only the exch_h diagnostic
    ent_layer = pblflg[None] & (karr >= kp) & (entfac < 4.6)
    dza_kpbl = gat(dza, kpbl)
    xkzh_ent = torch.sqrt(torch.clamp(
        -we[None] * dza_kpbl[None] * torch.exp(-entfac), min=0.0)
        * xkzh_free)
    xkzh_ent = torch.clamp(xkzh_ent, XKZMIN, XKZMAX)
    xkzh_out = torch.where(ent_layer, xkzh_ent, xkzh)

    # ---- implicit diffusion matrix for heat/moisture (:932-1010)
    dtodsd = dt2 / del_p[:nzt]
    dtodsu_shift = dt2 / torch.cat([del_p[1:nzt], del_p[nzt - 1:nzt]],
                                   dim=0)
    dsig = p[:nzt] - p[1:nzt + 1]
    rdz = 1.0 / dza[1:nzt + 1]
    tem1 = dsig * xkzh * rdz
    xk = torch.clamp(xkzh, min=XKZMIN)
    dsdzt = torch.where(in_pbl, tem1 * (-hgamt[None] / torch.clamp(
        hpbl[None], min=1.0) - hfxpbl[None] * zfacent / xk), zero)
    dsdzq = torch.where(in_pbl, tem1 * (-qfxpbl[None] * zfacent / xk),
                        zero)
    dsdz2 = tem1 * rdz
    au_f = -dtodsd * dsdz2            # faces k = 0..nzt-1
    al_f = -dtodsu_shift * dsdz2

    # right-hand sides, with the surface fluxes and the countergradient/
    # entrainment sources at the faces below nzt - 1
    f1 = (thx[:nzt] - 300.0).clone()
    f1[0] = f1[0] + hfx / (rhox * cpm) / zq[1] * dt2
    fq = qv[:nzt].clone()
    fq[0] = fq[0] + qfx / rhox / zq[1] * dt2
    face = slice(0, nzt - 1)
    f1[:nzt - 1] = f1[:nzt - 1] + dtodsd[face] * dsdzt[face]
    f1[1:nzt] = f1[1:nzt] + (-dtodsu_shift[face] * dsdzt[face])
    fq[:nzt - 1] = fq[:nzt - 1] + dtodsd[face] * dsdzq[face]
    fq[1:nzt] = fq[1:nzt] + (-dtodsu_shift[face] * dsdzq[face])
    fc = qc[:nzt]
    fi = qi[:nzt]

    # tridiagonal coefficients: row k has lower al_f[k-1], upper au_f[k]
    zero2 = torch.zeros_like(au_f[:1])
    lower = torch.cat([zero2, al_f[:nzt - 1]], dim=0)
    upper = torch.cat([au_f[:nzt - 1], zero2], dim=0)
    diag = 1.0 - lower - upper

    f1s, fqs, fcs, fis = _tridiag_solve(lower, diag, upper,
                                        [f1, fq, fc, fi], nzt)

    ttend = (f1s - (thx[:nzt] - 300.0)) * rdt
    qtend = (fqs - qv[:nzt]) * rdt
    qctend = (fcs - qc[:nzt]) * rdt
    qitend = (fis - qi[:nzt]) * rdt

    def add(x, tend):
        return x + torch.cat([tend, torch.zeros_like(x[:1])], dim=0) * dt
    exch_h = torch.cat([xkzh_out, torch.zeros_like(th[:1])], dim=0)
    return (add(th, ttend), add(qv, qtend), add(qc, qctend),
            add(qi, qitend), hpbl, kpbl, exch_h)

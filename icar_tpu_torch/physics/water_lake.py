"""CLM4.5 shallow-lake model (water=3) (icar_tpu/physics/water_lake.py:
the WRF/CLM lake scheme of Subin et al. 2012 / Gu et al. 2013 as adapted
for ICAR): a one-dimensional mass-and-energy-balance column with 10 lake
layers, up to 5 snow layers and 4 soil layers beneath the lake bed.

Plain PyTorch over the (ny, nx) grid, routine by routine under the JAX
package's names. The layer convention is the JAX package's: the
snow+soil stack on axis 0 with offset m = j + NLEVSNOW - 1 for the
reference's layer j in [-4..4] (m in [0..8]), interfaces zi at m = j +
NLEVSNOW (m in [0..9]), lake layers k in [1..10] at index k - 1. The
dynamic snow stack (snl in [-5, 0], int32) is a set of masks over the
fixed layers; the reference's per-column exits are fixed-trip masked loops
(the flux solver's 3 stability passes, the 9 convective-mixing sweeps,
the snow combine and divide passes), so nothing is read back to the host.
The JAX package's ``.at[...]`` updates are out-of-place writes here.
Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), as the JAX package's compiled step divides; ``dtime``
is a 0-d float32 tensor (a number in the tests), so the CPU and the card
differ only in exp/log/pow/atan/sin.

``lake_init`` is host numpy, a copy of the JAX package's held by
tests/test_torch_setup.py together with the module constants it reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..ops import pointwise as pw
from ..ops.indexing import take_level
from ..ops.pointwise import inv
from .noahmp import (_add, _cube, _dt_tensor, _i32, _pow4, _rdiv, _set,
                     _sum0, _where)

NLEVLAKE = 10   # water_lake.f90:45
NLEVSNOW = 5    # :46
NLEVSOIL = 4    # :44 (reduced from CLM's 10 by the ICAR port)
NSOISNO = NLEVSNOW + NLEVSOIL        # 9 snow+soil layers
NCOL = NLEVSNOW + NLEVLAKE + NLEVSOIL  # 19-level combined column

# physical constants (water_lake.f90:76-95)
VKC = 0.4
GRAV = 9.80616
SB = 5.67e-8
TFRZ = 273.16
DENH2O = 1.000e3
DENICE = 0.917e3
CPICE = 2.11727e3
CPLIQ = 4.188e3
HFUS = 3.337e5
HVAP = 2.501e6
HSUB = HVAP + HFUS
RAIR = 287.0423
CPAIR = 1.00464e3
TCRIT = 2.5
TKWAT = 0.6
TKICE = 2.290
TKAIRC = 0.023
BDSNO = 250.0
SPVAL = 1.0e36
DEPTH_C = 50.0        # :97 below this level t_lake init is 277 K

# tunable constants (:100-103)
WIMP = 0.05
SSI = 0.033
CNFAC = 0.5

# surface-flux scheme constants (ShalLakeFluxes, :722-737)
EMG = 0.97
ZII = 1000.0
BETA1 = 1.0
TDMAX = 277.0
BETA_LAKE = 0.4       # fraction of solar absorbed at surface (:791)
ZA_LAKE = 0.6         # base of surface absorption layer (:1385)

# soil texture lookup (percent sand/clay by soil type, :121-126)
SAND = np.array([92., 80., 66., 20., 5., 43., 60., 10., 32., 51., 6., 22.,
                 39.7, 0., 100., 54., 17., 100., 92.])
CLAY = np.array([3., 5., 10., 15., 5., 18., 27., 33., 33., 41., 47., 58.,
                 14.7, 0., 0., 8.5, 54., 0., 3.])

# CombineSnowLayers minimum thickness per (top-down) layer rank (:3884)
DZMIN = np.array([0.010, 0.015, 0.025, 0.055, 0.115])


# --------------------------------------------------------------------------
# layer helpers
# --------------------------------------------------------------------------

def _axis(n, like, offset=0):
    """(n, 1, 1) int32 layer index (minus ``offset``) on ``like``'s
    device."""
    return (torch.arange(n, dtype=torch.int32, device=like.device)
            - offset)[:, None, None]


def _full(x, v):
    """An int32 tensor of ``x``'s shape and device holding ``v``."""
    return torch.full_like(x, v)


def _gather_m(arr, midx):
    """arr[(L, ny, nx)] selected at per-column layer index midx[(ny, nx)]."""
    return take_level(arr, _i32(midx))


def _scatter_m(arr, midx, val, do):
    """Write val into arr at layer index midx where do (both (ny, nx))."""
    hit = (_axis(arr.shape[0], arr) == _i32(midx)[None]) & do[None]
    return torch.where(hit, val[None], arr)


def _snow_mask(snl):
    """(NSOISNO, ny, nx) True where stack layer m is an active snow layer:
    j = m - 4 >= snl + 1 and j <= 0 (snow part)."""
    j = _axis(NSOISNO, snl, NLEVSNOW - 1)
    return (j >= snl[None] + 1) & (j <= 0)


def _sum_where(mask, x):
    """``jnp.sum(jnp.where(mask, x, 0.0), axis=0)``."""
    return _sum0(torch.where(mask, x, 0.0))


# --------------------------------------------------------------------------
# saturation, stability and the surface layer
# --------------------------------------------------------------------------

def qsat(T, p):
    """Saturation vapor pressure / specific humidity + T-derivatives
    (QSat, water_lake.f90:3327-3439; Flatau et al. 1992 polynomial fits)."""
    a = [6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
         0.305903558e-05, 0.196237241e-07, 0.892344772e-10,
         -0.373208410e-12, 0.209339997e-15]
    b = [0.444017302, 0.286064092e-01, 0.794683137e-03, 0.121211669e-04,
         0.103354611e-06, 0.404125005e-09, -0.788037859e-12,
         -0.114596802e-13, 0.381294516e-16]
    c = [6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
         0.614396778e-05, 0.602780717e-07, 0.387940929e-09,
         0.149436277e-11, 0.262655803e-14]
    d = [0.503277922, 0.377289173e-01, 0.126801703e-02, 0.249468427e-04,
         0.313703411e-06, 0.257180651e-08, 0.133268878e-10,
         0.394116744e-13, 0.498070196e-16]

    td = torch.clamp(T - TFRZ, -75.0, 100.0)

    def poly(coefs):
        r = torch.full_like(td, coefs[-1])
        for cf in coefs[-2::-1]:
            r = cf + td * r
        return r

    warm = td >= 0.0
    es = torch.where(warm, poly(a), poly(c)) * 100.0
    esdT = torch.where(warm, poly(b), poly(d)) * 100.0
    vp = 1.0 / (p - 0.378 * es)
    vp1 = 0.622 * vp
    qs = es * vp1
    qsdT = esdT * vp1 * vp * p
    return es, esdT, qs, qsdT


def _const(x, like):
    """A number as a 0-d float32 tensor on ``like``'s device (the JAX
    package's weakly typed scalars)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _stability_func1(zeta, like=None):
    """Unstable momentum stability integral (StabilityFunc1, :4748-4781).
    ``zeta`` a tensor, or a number (then the result is a 0-d tensor on
    ``like``'s device)."""
    if torch.is_tensor(zeta):
        chik2 = torch.sqrt(torch.clamp(1.0 - 16.0 * zeta, min=1e-12))
    else:
        chik2 = torch.sqrt(_const(max(1.0 - 16.0 * zeta, 1e-12), like))
    chik = torch.sqrt(chik2)
    return (2.0 * pw.log((1.0 + chik) * 0.5)
            + pw.log((1.0 + chik2) * 0.5)
            - 2.0 * torch.atan(chik) + np.pi * 0.5)


def _stability_func2(zeta, like=None):
    """Unstable scalar stability integral (StabilityFunc2, :4786-4820)."""
    if torch.is_tensor(zeta):
        chik2 = torch.sqrt(torch.clamp(1.0 - 16.0 * zeta, min=1e-12))
    else:
        chik2 = torch.sqrt(_const(max(1.0 - 16.0 * zeta, 1e-12), like))
    return 2.0 * pw.log((1.0 + chik2) * 0.5)


def monin_obukhov_init(ur, thv, dthv, zldis, z0m):
    """Initial Monin-Obukhov length (MoninObukIni, :4828-4893)."""
    wc = 0.5
    um = torch.where(dthv >= 0.0, torch.clamp(ur, min=0.1),
                     torch.sqrt(ur * ur + wc * wc))
    rib = GRAV * zldis * dthv / (thv * um * um)
    zeta_s = rib * pw.log(zldis / z0m) / (1.0 - 5.0 * torch.clamp(rib,
                                                                  max=0.19))
    zeta_s = torch.clamp(zeta_s, 0.01, 2.0)
    zeta_u = torch.clamp(rib * pw.log(zldis / z0m), -100.0, -0.01)
    zeta = torch.where(rib >= 0.0, zeta_s, zeta_u)
    return um, zldis / zeta


def _profile_psi(zldis, z0, obu, zeta_lim, sfunc, coef, expo):
    """Shared 4-regime flux-profile factor (FrictionVelocity, :4486-4595).

    Returns the denominator D such that scale = vkc * X / D.
    """
    zeta = zldis / obu

    def safe_log(x):
        return pw.log(torch.clamp(x, min=1e-12))
    neg = pw.pow(torch.clamp(-zeta, min=1e-12), expo)
    # zeta < -zeta_lim (very unstable)
    d1 = (safe_log(-zeta_lim * obu / z0) - sfunc(-zeta_lim, obu)
          + sfunc(z0 / obu)
          + coef * (neg - zeta_lim ** expo if expo > 0 else
                    (zeta_lim ** expo - neg)))
    # -zeta_lim <= zeta < 0 (unstable)
    d2 = (safe_log(zldis / z0) - sfunc(torch.clamp(zeta, max=-1e-12))
          + sfunc(z0 / obu))
    # 0 <= zeta <= 1 (stable)
    d3 = safe_log(zldis / z0) + 5.0 * zeta - 5.0 * z0 / obu
    # zeta > 1 (very stable)
    d4 = (safe_log(torch.clamp(obu, min=1e-12) / z0) + 5.0 - 5.0 * z0 / obu
          + (5.0 * safe_log(torch.clamp(zeta, min=1.0)) + zeta - 1.0))
    return torch.where(zeta < -zeta_lim, d1,
                       torch.where(zeta < 0.0, d2,
                                   torch.where(zeta <= 1.0, d3, d4)))


def friction_velocity(forc_hgt_u, forc_hgt_t, forc_hgt_q, z0m, z0h, z0q,
                      obu, um):
    """Friction velocity + scalar profile relations (FrictionVelocity,
    water_lake.f90:4394-4746; Zeng et al. 1998). displa = 0 over lakes.

    Returns (ustar, temp1, temp2, temp12m, temp22m)."""
    zetam, zetat = 1.574, 0.465
    ustar = VKC * um / _profile_psi(forc_hgt_u, z0m, obu, zetam,
                                    _stability_func1, 1.14, 0.333)
    temp1 = _rdiv(VKC, _profile_psi(forc_hgt_t, z0h, obu, zetat,
                                    _stability_func2, 0.8, -0.333))
    temp2 = _rdiv(VKC, _profile_psi(forc_hgt_q, z0q, obu, zetat,
                                    _stability_func2, 0.8, -0.333))
    temp12m = _rdiv(VKC, _profile_psi(2.0 + z0h, z0h, obu, zetat,
                                      _stability_func2, 0.8, -0.333))
    temp22m = _rdiv(VKC, _profile_psi(2.0 + z0q, z0q, obu, zetat,
                                      _stability_func2, 0.8, -0.333))
    return ustar, temp1, temp2, temp12m, temp22m


class LakeFluxOut(NamedTuple):
    t_grnd: torch.Tensor
    eflx_sh_grnd: torch.Tensor
    eflx_lwrad_out: torch.Tensor
    eflx_lwrad_net: torch.Tensor
    eflx_soil_grnd: torch.Tensor
    eflx_sh_tot: torch.Tensor
    eflx_lh_tot: torch.Tensor
    qflx_evap_soi: torch.Tensor
    t_ref2m: torch.Tensor
    q_ref2m: torch.Tensor
    ws: torch.Tensor
    ks: torch.Tensor
    eflx_gnet: torch.Tensor
    htvp: torch.Tensor


def shal_lake_fluxes(forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q,
                     forc_u, forc_v, forc_lwrad, sabg, lat_rad,
                     dz, dz_lake, t_soisno, t_lake, snl,
                     h2osoi_liq, h2osoi_ice, savedtke1, t_grnd, h2osno):
    """Lake surface energy balance with Monin-Obukhov iteration
    (ShalLakeFluxes, water_lake.f90:632-1170): the stability iteration
    (:906) runs its fixed 3 passes with the nmozsgn < 3 filter as a
    mask."""
    niters = 3
    jtop_m = snl + NLEVSNOW        # stack index of top layer (j = snl+1)

    forc_th = forc_t * pw.pow(forc_psrf / forc_pbot, RAIR / CPAIR)
    forc_vp = forc_q * forc_pbot / (0.622 + 0.378 * forc_q)
    forc_rho = (forc_pbot - 0.378 * forc_vp) / (RAIR * forc_t)

    snow_layers = snl < 0
    dz_top = _gather_m(dz, jtop_m)
    betaprime = _where(snow_layers, 1.0, BETA_LAKE)
    dzsur = torch.where(snow_layers, dz_top, dz_lake[0]) * 0.5

    _, _, qsatg, qsatgdT = qsat(t_grnd, forc_pbot)

    thm = forc_t + 0.0098 * forc_hgt
    thv = forc_th * (1.0 + 0.61 * forc_q)

    # roughness (:867-885 as modified by Hongping Gu)
    z0mg = torch.where(t_grnd >= TFRZ, 0.001,
                       _where(snl == 0, 0.005, 0.0024))
    z0hg = z0mg
    z0qg = z0mg
    htvp = _where(t_grnd > TFRZ, HVAP, HSUB)

    ur = torch.clamp(torch.sqrt(forc_u * forc_u + forc_v * forc_v),
                     min=1.0)
    dth = thm - t_grnd
    dqh = forc_q - qsatg
    dthv = dth * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * dqh
    zldis = forc_hgt

    um, obu = monin_obukhov_init(ur, thv, dthv, zldis, z0mg)

    # per-column iteration state
    nmozsgn = torch.zeros_like(um, dtype=torch.int32)
    obuold = torch.zeros_like(um)
    # surface-layer conductivity/temperature (:928-944)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    bw = (ice_top + liq_top) / torch.clamp(dz_top, min=1e-12)
    tk_snow = TKAIRC + (7.75e-5 * bw + 1.105e-6 * bw * bw) \
        * (TKICE - TKAIRC)
    t_soisno_top = _gather_m(t_soisno, jtop_m)

    unfrozen_nosnow = (t_grnd > TFRZ) & (t_lake[0] > TFRZ) & (snl == 0)
    tksur = torch.where(unfrozen_nosnow, savedtke1,
                        torch.where(snl == 0, TKICE, tk_snow))
    tsur = torch.where(snow_layers, t_soisno_top, t_lake[0])

    eflx_sh_grnd = torch.zeros_like(um)
    qflx_evap_soi = torch.zeros_like(um)
    stftg3 = torch.zeros_like(um)
    tgbef = t_grnd
    ram = torch.ones_like(um)
    rah = torch.ones_like(um)
    raw = torch.ones_like(um)
    temp1 = torch.ones_like(um)
    temp2 = torch.ones_like(um)
    temp12m = torch.ones_like(um)
    temp22m = torch.ones_like(um)
    ustar = torch.full_like(um, 0.06)

    for it in range(niters):
        act = nmozsgn < 3  # filter rebuild (:1012-1025)
        us_n, t1_n, t2_n, t12_n, t22_n = friction_velocity(
            forc_hgt, forc_hgt, forc_hgt, z0mg, z0hg, z0qg, obu, um)
        ustar = torch.where(act, us_n, ustar)
        temp1 = torch.where(act, t1_n, temp1)
        temp2 = torch.where(act, t2_n, temp2)
        temp12m = torch.where(act, t12_n, temp12m)
        temp22m = torch.where(act, t22_n, temp22m)

        tgbef_n = t_grnd
        ram_n = 1.0 / (ustar * ustar / um)
        rah_n = 1.0 / (temp1 * ustar)
        raw_n = 1.0 / (temp2 * ustar)
        stftg3_n = EMG * SB * _cube(tgbef_n)

        # Newton step for ground temperature (:956-966)
        ax = (betaprime * sabg + EMG * forc_lwrad + 3.0 * stftg3_n * tgbef_n
              + forc_rho * CPAIR / rah_n * thm
              - htvp * forc_rho / raw_n
              * (qsatg - qsatgdT * tgbef_n - forc_q)
              + tksur * tsur / dzsur)
        bx = (4.0 * stftg3_n + forc_rho * CPAIR / rah_n
              + htvp * forc_rho / raw_n * qsatgdT + tksur / dzsur)
        t_grnd_n = ax / bx
        htvp_n = _where(t_grnd_n > TFRZ, HVAP, HSUB)

        sh_n = forc_rho * CPAIR * (t_grnd_n - thm) / rah_n
        ev_n = forc_rho * (qsatg + qsatgdT * (t_grnd_n - tgbef_n)
                           - forc_q) / raw_n

        _, _, qsatg_n, qsatgdT_n = qsat(t_grnd_n, forc_pbot)
        dth_n = thm - t_grnd_n
        dqh_n = forc_q - qsatg_n
        tstar = temp1 * dth_n
        qstar = temp2 * dqh_n
        thvstar = tstar * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * qstar
        zeta = zldis * VKC * GRAV * thvstar / (ustar * ustar * thv)
        zeta_s = torch.clamp(zeta, 0.01, 2.0)
        zeta_u = torch.clamp(zeta, -100.0, -0.01)
        wc = BETA1 * pw.pow(torch.clamp(
            -GRAV * ustar * thvstar * ZII / thv, min=0.0), 0.333)
        um_s = torch.clamp(ur, min=0.1)
        um_u = torch.sqrt(ur * ur + wc * wc)
        stable = zeta >= 0.0
        um_n = torch.where(stable, um_s, um_u)
        obu_n = zldis / torch.where(stable, zeta_s, zeta_u)
        nmoz_n = nmozsgn + (obuold * obu_n < 0.0).to(torch.int32)

        # commit only for active columns
        t_grnd = torch.where(act, t_grnd_n, t_grnd)
        tgbef = torch.where(act, tgbef_n, tgbef)
        htvp = torch.where(act, htvp_n, htvp)
        eflx_sh_grnd = torch.where(act, sh_n, eflx_sh_grnd)
        qflx_evap_soi = torch.where(act, ev_n, qflx_evap_soi)
        qsatg = torch.where(act, qsatg_n, qsatg)
        qsatgdT = torch.where(act, qsatgdT_n, qsatgdT)
        dth = torch.where(act, dth_n, dth)
        dqh = torch.where(act, dqh_n, dqh)
        um = torch.where(act, um_n, um)
        obu = torch.where(act, obu_n, obu)
        obuold = torch.where(act, obu, obuold)
        nmozsgn = torch.where(act, nmoz_n, nmozsgn)
        ram = torch.where(act, ram_n, ram)
        rah = torch.where(act, rah_n, rah)
        raw = torch.where(act, raw_n, raw)
        stftg3 = torch.where(act, stftg3_n, stftg3)

    # post-iteration corrections (:1055-1076)
    snow_freeze_fix = (((h2osno > 0.5) | (t_lake[0] <= TFRZ))
                       & (t_grnd > TFRZ))
    conv_mix = (((t_lake[0] > t_grnd) & (t_grnd > TDMAX))
                | ((t_lake[0] < t_grnd) & (t_lake[0] > TFRZ)
                   & (t_grnd < TDMAX))) & ~snow_freeze_fix
    t_grnd_new = torch.where(snow_freeze_fix, TFRZ,
                             torch.where(conv_mix, t_lake[0], t_grnd))
    fix = snow_freeze_fix | conv_mix
    eflx_sh_grnd = torch.where(
        fix, forc_rho * CPAIR * (t_grnd_new - thm) / rah, eflx_sh_grnd)
    qflx_evap_soi = torch.where(
        fix, forc_rho * (qsatg + qsatgdT * (t_grnd_new - t_grnd)
                         - forc_q) / raw, qflx_evap_soi)
    t_grnd = t_grnd_new
    htvp = _where(t_grnd > TFRZ, HVAP, HSUB)

    eflx_lwrad_out = (1.0 - EMG) * forc_lwrad + EMG * SB * _pow4(t_grnd)
    eflx_soil_grnd = (sabg + forc_lwrad - eflx_lwrad_out
                      - eflx_sh_grnd - htvp * qflx_evap_soi)
    eflx_sh_tot = eflx_sh_grnd
    eflx_lh_tot = htvp * qflx_evap_soi
    t_ref2m = thm + temp1 * dth * (1.0 / temp12m - 1.0 / temp1)
    q_ref2m = forc_q + temp2 * dqh * (1.0 / temp22m - 1.0 / temp2)
    eflx_gnet = (betaprime * sabg + forc_lwrad
                 - (eflx_lwrad_out + eflx_sh_tot + eflx_lh_tot))
    u2m = torch.clamp(ustar * inv(VKC) * pw.log(_rdiv(2.0, z0mg)), min=0.1)
    ws = 1.2e-03 * u2m
    ks = 6.6 * torch.sqrt(torch.abs(torch.sin(lat_rad))) \
        * pw.pow(u2m, -1.84)

    return LakeFluxOut(
        t_grnd=t_grnd, eflx_sh_grnd=eflx_sh_grnd,
        eflx_lwrad_out=eflx_lwrad_out,
        eflx_lwrad_net=eflx_lwrad_out - forc_lwrad,
        eflx_soil_grnd=eflx_soil_grnd, eflx_sh_tot=eflx_sh_tot,
        eflx_lh_tot=eflx_lh_tot, qflx_evap_soi=qflx_evap_soi,
        t_ref2m=t_ref2m, q_ref2m=q_ref2m, ws=ws, ks=ks,
        eflx_gnet=eflx_gnet, htvp=htvp)


# --------------------------------------------------------------------------
# thermal properties, phase change, the column solve
# --------------------------------------------------------------------------

def soil_therm_prop(snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
                    watsat, tkmg, tkdry, tksatu, csol):
    """Snow/soil thermal conductivity and heat capacity
    (SoilThermProp_Lake, water_lake.f90:2144-2332).

    Soil follows Johansen/Farouki with the lake bed assumed saturated
    (satw = 1); snow follows Jordan (1991). Returns (tk, cv, tktopsoillay)
    where tk[m] is the interface conductivity below stack layer m.
    """
    # soil layers (j = 1..4 -> m = 5..8); satw = 1 (:2247)
    liq_s = h2osoi_liq[NLEVSNOW:]
    ice_s = h2osoi_ice[NLEVSNOW:]
    t_s = t_soisno[NLEVSNOW:]
    fl = liq_s / torch.clamp(ice_s + liq_s, min=1e-12)
    dksat_fr = tkmg * pw.pow(0.249, fl * watsat) * pw.pow(2.29, watsat)
    # unfrozen: dke = max(0, log10(1)+1) = 1 -> thk = tksatu
    thk_soil = torch.where(t_s >= TFRZ, tksatu,
                           1.0 * dksat_fr + 0.0 * tkdry)
    thk = torch.cat([torch.zeros_like(dz[:NLEVSNOW]), thk_soil], 0)

    # snow layers (Jordan 1991, :2264-2268)
    smask = _snow_mask(snl)
    bw = (h2osoi_ice + h2osoi_liq) / torch.clamp(dz, min=1e-12)
    thk_snow = TKAIRC + (7.75e-5 * bw + 1.105e-6 * bw * bw) \
        * (TKICE - TKAIRC)
    thk = torch.where(smask, thk_snow, thk)

    # interface conductivity below each layer (:2280-2295): harmonic mean
    # except j == 0 (bottom snow, bordered by lake -> the mid-layer value)
    # and j == nlevsoil (tk = 0)
    thk_p1 = torch.cat([thk[1:], thk[-1:]], 0)
    z_p1 = torch.cat([z[1:], z[-1:]], 0)
    tk_h = (thk * thk_p1 * (z_p1 - z)
            / torch.clamp(thk * (z_p1 - zi[1:]) + thk_p1 * (zi[1:] - z),
                          min=1e-12))
    j = _axis(NSOISNO, snl, NLEVSNOW - 1)
    tk = torch.where(j == 0, thk, torch.where(j == NLEVSOIL, 0.0, tk_h))
    active = j >= snl[None] + 1
    tk = torch.where(active, tk, 0.0)
    tktopsoillay = thk[NLEVSNOW]

    # heat capacities (:2300-2330)
    cv_soil = (csol * (1.0 - watsat) * dz[NLEVSNOW:]
               + h2osoi_ice[NLEVSNOW:] * CPICE
               + h2osoi_liq[NLEVSNOW:] * CPLIQ)
    cv_snow = CPLIQ * h2osoi_liq + CPICE * h2osoi_ice
    cv = torch.where(smask, cv_snow, 0.0)
    cv = torch.cat([cv[:NLEVSNOW], cv_soil], 0)
    return tk, cv, tktopsoillay


def phase_change_lake(snl, h2osno, dz, dz_lake, t_soisno, h2osoi_liq,
                      h2osoi_ice, lake_icefrac, t_lake, snowdp, cv, cv_lake):
    """Melting/freezing within snow, soil and lake layers
    (PhaseChange_Lake, water_lake.f90:2341-2559).

    Returns updated (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice,
    lake_icefrac, t_lake, cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt,
    lhabs)."""
    small = 1e-7
    qflx_snomelt = torch.zeros_like(h2osno)
    lhabs = torch.zeros_like(h2osno)

    # snow without layers atop an unfrozen top lake layer (:2466-2483)
    c0 = (snl == 0) & (h2osno > 0.0) & (t_lake[0] > TFRZ)
    heatavail = (t_lake[0] - TFRZ) * cv_lake[0]
    melt0 = torch.minimum(h2osno, heatavail * inv(HFUS))
    heatrem0 = torch.clamp(heatavail - melt0 * HFUS, min=0.0)
    t_lake0 = torch.where(c0, TFRZ + heatrem0 / cv_lake[0], t_lake[0])
    snowdp = torch.where(
        c0, snowdp * (1.0 - melt0 / torch.clamp(h2osno, min=small)), snowdp)
    h2osno = torch.where(c0, h2osno - melt0, h2osno)
    lhabs = lhabs + torch.where(c0, melt0 * HFUS, 0.0)
    qflx_snomelt = qflx_snomelt + torch.where(c0, melt0, 0.0)
    h2osno = torch.where(c0 & (h2osno < small), 0.0, h2osno)
    snowdp = torch.where(c0 & (snowdp < small), 0.0, snowdp)
    t_lake = _set(t_lake, 0, t_lake0)

    # lake layer phase change (:2487-2521)
    heatavail_l = (t_lake - TFRZ) * cv_lake
    melting = (t_lake > TFRZ) & (lake_icefrac > 0.0)
    freezing = (t_lake < TFRZ) & (lake_icefrac < 1.0)
    melt_l = torch.where(
        melting,
        torch.minimum(lake_icefrac * DENH2O * dz_lake,
                      heatavail_l * inv(HFUS)),
        torch.where(freezing,
                    torch.maximum(-(1.0 - lake_icefrac) * DENH2O * dz_lake,
                                  heatavail_l * inv(HFUS)), 0.0))
    heatrem_l = torch.where(
        melting, torch.clamp(heatavail_l - melt_l * HFUS, min=0.0),
        torch.clamp(heatavail_l - melt_l * HFUS, max=0.0))
    change_l = melting | freezing
    lake_icefrac = torch.where(
        change_l, lake_icefrac - melt_l / (DENH2O * dz_lake), lake_icefrac)
    lhabs = lhabs + _sum_where(change_l, melt_l * HFUS)
    cv_lake = torch.where(change_l, cv_lake + melt_l * (CPLIQ - CPICE),
                          cv_lake)
    t_lake = torch.where(change_l, TFRZ + heatrem_l / cv_lake, t_lake)
    lake_icefrac = torch.where(lake_icefrac > 1.0 - small, 1.0,
                               lake_icefrac)
    lake_icefrac = torch.where(lake_icefrac < small, 0.0, lake_icefrac)

    # snow & soil phase change (:2525-2568)
    j = _axis(NSOISNO, snl, NLEVSNOW - 1)
    active = j >= snl[None] + 1
    is_snow = j <= 0
    heatavail_s = (t_soisno - TFRZ) * cv
    melt_cond = active & (t_soisno > TFRZ) & (h2osoi_ice > 0.0)
    frz_cond = active & (t_soisno < TFRZ) & (h2osoi_liq > 0.0) & ~melt_cond
    melt_s = torch.where(
        melt_cond, torch.minimum(h2osoi_ice, heatavail_s * inv(HFUS)),
        torch.where(frz_cond,
                    torch.maximum(-h2osoi_liq, heatavail_s * inv(HFUS)),
                    0.0))
    heatrem_s = torch.where(
        melt_cond, torch.clamp(heatavail_s - melt_s * HFUS, min=0.0),
        torch.clamp(heatavail_s - melt_s * HFUS, max=0.0))
    change_s = melt_cond | frz_cond
    imelt = torch.where(melt_cond & is_snow, 1,
                        torch.where(frz_cond & is_snow, 2, 0)).to(
                            torch.int32)
    qflx_snomelt = qflx_snomelt + _sum_where(change_s & is_snow, melt_s)
    h2osoi_ice = torch.where(change_s, h2osoi_ice - melt_s, h2osoi_ice)
    h2osoi_liq = torch.where(change_s, h2osoi_liq + melt_s, h2osoi_liq)
    lhabs = lhabs + _sum_where(change_s, melt_s * HFUS)
    cv = torch.where(change_s, cv + melt_s * (CPLIQ - CPICE), cv)
    t_soisno = torch.where(
        change_s, TFRZ + heatrem_s / torch.clamp(cv, min=1e-12), t_soisno)
    h2osoi_ice = torch.where(change_s & (h2osoi_ice < small), 0.0,
                             h2osoi_ice)
    h2osoi_liq = torch.where(change_s & (h2osoi_liq < small), 0.0,
                             h2osoi_liq)

    # NOTE reference units quirk preserved: qflx_snomelt accumulates melt
    # MASS (kg/m2) over the step, never divided by dtime
    # (water_lake.f90:2479,2540,2551)
    eflx_snomelt = qflx_snomelt * HFUS
    return (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice, lake_icefrac,
            t_lake, cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt, lhabs)


def _tridiag_column(a, b, c, r, active, is_top):
    """Thomas solve over the static layer axis with per-column variable top
    (Tridiagonal, water_lake.f90:3442-3524).

    Inactive rows (above jtop) are replaced by identity rows, which leaves
    the filtered recurrence exactly intact because the top active row has
    a = 0 and identity rows have c = 0."""
    a = torch.where(active, a, 0.0)
    b = torch.where(active, b, 1.0)
    c = torch.where(active, c, 0.0)
    # sanitize r too: inactive rows can hold NaN/inf from zeroed geometry,
    # and 0 * NaN at the first active row would poison the sweep
    r = torch.where(active, r, 0.0)
    n = a.shape[0]
    # forward sweep
    gam = [None] * n
    u = [None] * n
    bet = b[0]
    u[0] = r[0] / bet
    for k in range(1, n):
        gam[k] = c[k - 1] / bet
        bet = b[k] - a[k] * gam[k]
        u[k] = (r[k] - a[k] * u[k - 1]) / bet
    for k in range(n - 2, -1, -1):
        u[k] = u[k] - gam[k + 1] * u[k + 1]
    return torch.stack(u)


def _lake_density(t_lake, lake_icefrac):
    """Water density with ice weighting (water_lake.f90:1463-1470)."""
    return ((1.0 - lake_icefrac) * 1000.0
            * (1.0 - 1.9549e-05 * pw.pow(torch.abs(t_lake - 277.0), 1.68))
            + lake_icefrac * DENICE)


def _frozen_conductivity(icef, tkice_eff):
    """The conductivity of a partly frozen lake layer (:1531-1550)."""
    return _rdiv(TKWAT * tkice_eff,
                 (1.0 - icef) * tkice_eff + TKWAT * icef)


def _energy(cv_lake, t_lake, dz_lake, lake_icefrac, act9, cv, t_soisno,
            h2osoi_liq, snl, h2osno, cfus):
    """The column's energy content (ocvts/ncvts, :1640-1653, :2080-2088):
    lake layers, the active snow and soil layers, less the latent heat of
    snow without layers (the thin-snow correction, :1649: j == 1 is never
    jtop for a lake column with snow layers, so it reduces to snl == 0)."""
    e = _sum0(cv_lake * (t_lake - TFRZ)
              + cfus * dz_lake * (1.0 - lake_icefrac))
    e = e + _sum_where(act9, cv * (t_soisno - TFRZ) + HFUS * h2osoi_liq)
    return e - torch.where((snl == 0) & (h2osno > 0.0), h2osno * HFUS, 0.0)


def shal_lake_temperature(t_grnd, h2osno, sabg, dz, dz_lake, z, zi, z_lake,
                          ws, ks, snl, eflx_gnet, lakedepth, lake_icefrac,
                          snowdp, t_lake, t_soisno, h2osoi_liq, h2osoi_ice,
                          watsat, tkmg, tkdry, tksatu, csol,
                          eflx_sh_grnd, eflx_sh_tot, eflx_soil_grnd, dtime):
    """Crank-Nicolson diffusion through the snow/lake/soil column with
    Hostetler eddy diffusivity, solar absorption, phase change and
    convective mixing (ShalLakeTemperature, water_lake.f90:1172-2135).

    Returns a dict of the updated state + flux corrections."""
    dtime = _dt_tensor(dtime, t_grnd)
    cwat = CPLIQ * DENH2O
    cice_eff = CPICE * DENH2O
    cfus = HFUS * DENH2O
    tkice_eff = TKICE * DENICE / DENH2O
    km = TKWAT / cwat

    j9 = _axis(NSOISNO, snl, NLEVSNOW - 1)
    act9 = j9 >= snl[None] + 1
    smask = _snow_mask(snl)

    # previous-step ice fraction of snow (:1424-1434)
    frac_iceold = torch.where(
        smask, h2osoi_ice / torch.clamp(h2osoi_liq + h2osoi_ice, min=1e-12),
        0.0)

    fin = eflx_gnet

    # 2) lake density / 3) diffusivity (:1457-1531)
    rhow = _lake_density(t_lake, lake_icefrac)
    drhodz = (rhow[1:] - rhow[:-1]) / (z_lake[1:] - z_lake[:-1])
    n2 = _rdiv(GRAV, rhow[:-1]) * drhodz
    zl = z_lake[:-1]
    vz = VKC * zl
    num = 40.0 * n2 * (vz * vz)
    den = torch.clamp((ws * ws) * pw.exp(-2.0 * ks * zl), min=1e-10)
    ri = (-1.0 + torch.sqrt(torch.clamp(1.0 + num / den, min=0.0))) \
        * inv(20.0)
    unfrozen = (t_grnd > TFRZ) & (t_lake[0] > TFRZ) & (snl == 0)
    ke_base = VKC * ws * zl * pw.exp(-ks * zl) / (1.0 + 37.0 * ri * ri)
    # enhanced mixing factors for deep lakes (:1506-1525, mchen)
    warm = t_lake[0] > 277.15
    fac_warm = _where(lakedepth > 15.0, 1.0e2, 1.0)
    fac_cold = torch.where(lakedepth > 150.0, 1.0e5,
                           _where(lakedepth > 15.0, 1.0e4, 1.0))
    ke = ke_base * torch.where(warm, fac_warm, fac_cold)
    tk_frozen = _frozen_conductivity(lake_icefrac[:-1], tkice_eff)
    kme_i = torch.where(unfrozen, km + ke, km)
    tk_lake_i = torch.where(unfrozen, (km + ke) * cwat, tk_frozen)
    # bottom lake layer (:1535-1550)
    kme = torch.cat([kme_i, kme_i[-1:]], 0)
    tk_bot_frozen = _frozen_conductivity(lake_icefrac[-1:], tkice_eff)
    tk_lake = torch.cat(
        [tk_lake_i, torch.where(unfrozen, tk_lake_i[-1:], tk_bot_frozen)],
        0)
    savedtke1 = kme[0] * cwat

    # 4) solar source (:1554-1596); eta from Hakanson 1995
    eta = 1.1925 * pw.pow(torch.clamp(lakedepth, min=1e-3), -0.424)
    zin = z_lake - 0.5 * dz_lake
    zout = z_lake + 0.5 * dz_lake
    rsfin = pw.exp(-eta * torch.clamp(zin - ZA_LAKE, min=0.0))
    rsfout = pw.exp(-eta * torch.clamp(zout - ZA_LAKE, min=0.0))
    frozen_nosnow = (~unfrozen) & (snl == 0)
    k1 = _axis(NLEVLAKE, snl) == 0
    phi = torch.where(unfrozen[None],
                      (rsfin - rsfout) * sabg[None] * (1.0 - BETA_LAKE),
                      torch.where(frozen_nosnow[None] & k1,
                                  sabg[None] * (1.0 - BETA_LAKE), 0.0))
    phi_soil = torch.where(unfrozen, rsfout[-1] * sabg * (1.0 - BETA_LAKE),
                           0.0)

    # 5) thermal properties + old energy content (:1600-1653)
    cv_lake = dz_lake * (cwat * (1.0 - lake_icefrac)
                         + cice_eff * lake_icefrac)
    tk, cv, tktopsoillay = soil_therm_prop(
        snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
        watsat, tkmg, tkdry, tksatu, csol)
    ocvts = _energy(cv_lake, t_lake, dz_lake, lake_icefrac, act9, cv,
                    t_soisno, h2osoi_liq, snl, h2osno, cfus)

    # 6) whole-column assembly (:1662-1775); column index cidx = jcol+4,
    # jcol in [-4..14]: snow jcol<=0 -> stack m=jcol+4; lake 1..10 ->
    # k=jcol-1; soil 11..14 -> stack m=jcol-10+4
    z_soil_base = z_lake[-1] + 0.5 * dz_lake[-1]
    zx = torch.cat([z[:NLEVSNOW], z_lake, z_soil_base[None] + z[NLEVSNOW:]],
                   0)
    cvx = torch.cat([cv[:NLEVSNOW], cv_lake, cv[NLEVSNOW:]], 0)
    zero = torch.zeros_like(phi_soil)[None]
    phix = torch.cat([zero.expand(NLEVSNOW, -1, -1), phi, phi_soil[None],
                      zero.expand(NLEVSOIL - 1, -1, -1)], 0)
    tx = torch.cat([t_soisno[:NLEVSNOW], t_lake, t_soisno[NLEVSNOW:]], 0)

    # interface conductivities tkix (:1697-1723): the snow layers above the
    # bottom one take tk at their stack index; the bottom snow layer (jcol
    # == 0) the snow-lake interface; the lake layers but the bottom one
    # the dz-weighted harmonic mean; the bottom lake layer the lake-soil
    # interface; the soil layers their tk
    dzp0 = zx[NLEVSNOW] - zx[NLEVSNOW - 1]
    tk_bot_snow = (tk_lake[0] * tk[NLEVSNOW - 1] * dzp0
                   / (tk[NLEVSNOW - 1] * z_lake[0]
                      + tk_lake[0] * torch.clamp(-z[NLEVSNOW - 1],
                                                 min=1e-12)))
    tk_lk = (tk_lake[:-1] * tk_lake[1:] * (dz_lake[1:] + dz_lake[:-1])
             / (tk_lake[:-1] * dz_lake[1:] + tk_lake[1:] * dz_lake[:-1]))
    dzp_b = zx[NLEVSNOW + NLEVLAKE] - zx[NLEVSNOW + NLEVLAKE - 1]
    tk_lake_soil = (tktopsoillay * tk_lake[-1] * dzp_b
                    / (tktopsoillay * dz_lake[-1] * 0.5
                       + tk_lake[-1] * z[NLEVSNOW]))
    tkix = torch.cat([tk[:NLEVSNOW - 1], tk_bot_snow[None], tk_lk,
                      tk_lake_soil[None], tk[NLEVSNOW:]], 0)

    # active column mask: cidx >= jtop+4, jtop = snl+1
    cidx = _axis(NCOL, snl)
    top_cidx = (snl + NLEVSNOW)[None]
    act = cidx >= top_cidx
    is_top = cidx == top_cidx

    # heat flux factors (:1730-1747)
    factx = dtime / torch.clamp(cvx, min=1e-12)
    dz_below = torch.cat([zx[1:] - zx[:-1], torch.ones_like(zx[:1])], 0)
    tx_p1 = torch.cat([tx[1:], tx[-1:]], 0)
    not_bottom = cidx < NCOL - 1
    fnx = torch.where(not_bottom, tkix * (tx_p1 - tx) / dz_below, 0.0)

    # tridiagonal coefficients (:1749-1775)
    dzm = torch.cat([torch.ones_like(zx[:1]), zx[1:] - zx[:-1]], 0)
    dzp = dz_below
    fnx_m1 = torch.cat([torch.zeros_like(fnx[:1]), fnx[:-1]], 0)
    tkix_m1 = torch.cat([torch.zeros_like(tkix[:1]), tkix[:-1]], 0)
    a_mid = -(1.0 - CNFAC) * factx * torch.where(cidx > 0, tkix_m1,
                                                 0.0) / dzm
    b_mid = 1.0 + (1.0 - CNFAC) * factx * (
        torch.where(not_bottom, tkix / dzp, 0.0) + tkix_m1 / dzm)
    c_mid = -(1.0 - CNFAC) * factx * torch.where(not_bottom, tkix / dzp,
                                                 0.0)
    r_mid = (tx + CNFAC * factx * (torch.where(not_bottom, fnx, 0.0)
                                   - fnx_m1)
             + factx * phix)
    # top row overrides
    b_top = 1.0 + (1.0 - CNFAC) * factx * tkix / dzp
    c_top = -(1.0 - CNFAC) * factx * tkix / dzp
    r_top = tx + factx * (fin[None] + phix + CNFAC * fnx)
    a = torch.where(is_top, 0.0, a_mid)
    b = torch.where(is_top, b_top, b_mid)
    c = torch.where(is_top, c_top, c_mid)
    r = torch.where(is_top, r_top, r_mid)

    # 7) solve + scatter back (:1781-1811)
    tx_new = _tridiag_column(a, b, c, r, act, is_top)
    t_soisno = torch.cat([
        torch.where(act[:NLEVSNOW], tx_new[:NLEVSNOW], t_soisno[:NLEVSNOW]),
        tx_new[NLEVSNOW + NLEVLAKE:]], 0)
    t_lake = tx_new[NLEVSNOW:NLEVSNOW + NLEVLAKE]

    # 9) phase change (:1861-1867)
    (h2osno, snowdp, t_soisno, h2osoi_liq, h2osoi_ice, lake_icefrac, t_lake,
     cv, cv_lake, qflx_snomelt, eflx_snomelt, imelt, lhabs) = \
        phase_change_lake(snl, h2osno, dz, dz_lake, t_soisno, h2osoi_liq,
                          h2osoi_ice, lake_icefrac, t_lake, snowdp,
                          cv, cv_lake)

    # 10) convective mixing (:1945-2032): sequential down the lake column,
    # every layer at or above jmix + 1 mixed where triggered; the depth
    # above each layer is the same every sweep
    rhow = _lake_density(t_lake, lake_icefrac)
    lay = _axis(NLEVLAKE, snl)
    zsum = pw.cumsum(dz_lake, 0) - dz_lake
    for jmix in range(NLEVLAKE - 1):
        trig = ((rhow[jmix] > rhow[jmix + 1])
                | ((lake_icefrac[jmix] < 1.0)
                   & (lake_icefrac[jmix + 1] > 0.0)))
        in_mix = lay <= jmix + 1
        cvw = (1.0 - lake_icefrac) * cwat + lake_icefrac * cice_eff
        qav = _sum_where(in_mix, dz_lake * (t_lake - TFRZ) * cvw)
        iceav_t = _sum_where(in_mix, lake_icefrac * dz_lake)
        nav = _sum_where(in_mix, dz_lake)
        qav = qav / nav
        iceav = iceav_t / nav
        tav_froz = torch.where(
            qav < 0.0, qav / torch.clamp(iceav * cice_eff, min=1e-12), 0.0)
        tav_unfr = torch.where(
            qav > 0.0, qav / torch.clamp((1.0 - iceav) * cwat, min=1e-12),
            0.0)
        # redistribute: all ice at the top (:1993-2030)
        frac_hi = (zsum + dz_lake) / nav[None] <= iceav[None]
        frac_part = (zsum / nav[None] < iceav[None]) & ~frac_hi
        icef_new = torch.where(
            frac_hi, 1.0,
            torch.where(frac_part,
                        (iceav[None] * nav[None] - zsum) / dz_lake, 0.0))
        t_part = ((icef_new * tav_froz[None] * cice_eff
                   + (1.0 - icef_new) * tav_unfr[None] * cwat)
                  / (icef_new * cice_eff + (1.0 - icef_new) * cwat) + TFRZ)
        t_new = torch.where(frac_hi, tav_froz[None] + TFRZ,
                            torch.where(frac_part, t_part,
                                        tav_unfr[None] + TFRZ))
        apply = trig[None] & in_mix
        lake_icefrac = torch.where(apply, icef_new, lake_icefrac)
        t_lake = torch.where(apply, t_new, t_lake)
        rhow = torch.where(apply, _lake_density(t_lake, lake_icefrac), rhow)

    # 11) re-evaluate properties, new energy content, residual fix
    # (:2037-2123)
    cv_lake = dz_lake * (cwat * (1.0 - lake_icefrac)
                         + cice_eff * lake_icefrac)
    tk, cv, tktopsoillay = soil_therm_prop(
        snl, dz, zi, z, t_soisno, h2osoi_liq, h2osoi_ice,
        watsat, tkmg, tkdry, tksatu, csol)
    ncvts = _energy(cv_lake, t_lake, dz_lake, lake_icefrac, act9, cv,
                    t_soisno, h2osoi_liq, snl, h2osno, cfus)
    fin_tot = fin + _sum0(phi) + phi_soil
    errsoi = (ncvts - ocvts) / dtime - fin_tot
    fixable = torch.abs(errsoi) < 10.0
    fix = torch.where(fixable, errsoi, 0.0)
    eflx_sh_tot = eflx_sh_tot - fix
    eflx_sh_grnd = eflx_sh_grnd - fix
    eflx_soil_grnd = eflx_soil_grnd + fix
    eflx_gnet = eflx_gnet + fix

    return dict(
        t_lake=t_lake, t_soisno=t_soisno, h2osoi_liq=h2osoi_liq,
        h2osoi_ice=h2osoi_ice, lake_icefrac=lake_icefrac, h2osno=h2osno,
        snowdp=snowdp, savedtke1=savedtke1, frac_iceold=frac_iceold,
        qflx_snomelt=qflx_snomelt, imelt=imelt,
        eflx_sh_grnd=eflx_sh_grnd, eflx_sh_tot=eflx_sh_tot,
        eflx_soil_grnd=eflx_soil_grnd, eflx_gnet=eflx_gnet,
        errsoi=errsoi)


# --------------------------------------------------------------------------
# the snow stack
# --------------------------------------------------------------------------

def snow_water(snl, qflx_snomelt, qflx_rain_grnd, qflx_sub_snow,
               qflx_evap_grnd, qflx_dew_snow, qflx_dew_grnd, dz,
               h2osoi_ice, h2osoi_liq, dtime):
    """Snow mass change + gravitational percolation (SnowWater,
    water_lake.f90:3527-3689). do_capsnow is always false in the ICAR
    driver (lsm_driver.f90: do_capsnow(c)=.false.), so the capping branch
    is omitted. Returns (h2osoi_ice, h2osoi_liq, qflx_top_soil)."""
    dtime = _dt_tensor(dtime, dz)
    has_snow = snl < 0
    jtop_m = snl + NLEVSNOW

    # top-layer sublimation / dew (:3601-3618)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    wgdif = ice_top + (qflx_dew_snow - qflx_sub_snow) * dtime
    liq_new = torch.where(wgdif < 0.0, liq_top + wgdif, liq_top)
    ice_new = torch.clamp(wgdif, min=0.0)
    liq_new = liq_new + (qflx_rain_grnd + qflx_dew_grnd
                         - qflx_evap_grnd) * dtime
    liq_new = torch.clamp(liq_new, min=0.0)
    h2osoi_ice = _scatter_m(h2osoi_ice, jtop_m, ice_new, has_snow)
    h2osoi_liq = _scatter_m(h2osoi_liq, jtop_m, liq_new, has_snow)

    # porosity & partial volumes over snow layers (:3622-3633)
    smask = _snow_mask(snl)
    dz_s = torch.clamp(dz, min=1e-12)
    vol_ice = torch.clamp(h2osoi_ice / (dz_s * DENICE), max=1.0)
    eff_por = 1.0 - vol_ice
    vol_liq = torch.minimum(eff_por, h2osoi_liq / (dz_s * DENH2O))

    # gravitational drainage, top-down sequential (:3644-3669)
    qin = torch.zeros_like(dz[0])
    rows = list(h2osoi_liq)
    for m in range(NLEVSNOW):         # j = m - 4 in [-4 .. 0]
        act = smask[m]
        lm = torch.where(act, rows[m] + qin, rows[m])
        if m < NLEVSNOW - 1:
            blocked = (eff_por[m] < WIMP) | (eff_por[m + 1] < WIMP)
            qout = torch.where(
                blocked, 0.0,
                torch.clamp((vol_liq[m] - SSI * eff_por[m]) * dz[m],
                            min=0.0))
            qout = torch.minimum(
                qout, (1.0 - vol_ice[m + 1] - vol_liq[m + 1]) * dz[m + 1])
        else:
            qout = torch.clamp((vol_liq[m] - SSI * eff_por[m]) * dz[m],
                               min=0.0)
        qout = qout * 1000.0
        rows[m] = lm - torch.where(act, qout, 0.0)
        qin = torch.where(act, qout, qin)
    liq = torch.stack(rows)

    qflx_top_soil = torch.where(has_snow, qin / dtime,
                                qflx_rain_grnd + qflx_snomelt)
    return h2osoi_ice, liq, qflx_top_soil


def snow_compaction(snl, imelt, frac_iceold, t_soisno, h2osoi_ice,
                    h2osoi_liq, dz, dtime):
    """Destructive / overburden / melt metamorphism (SnowCompaction,
    water_lake.f90:3691-3819; SNTHERM.89)."""
    dtime = _dt_tensor(dtime, dz)
    c2, c3, c4, c5 = 23.0e-3, 2.777e-6, 0.04, 2.0
    dm, eta0 = 100.0, 9.0e5
    smask = _snow_mask(snl)
    burden = torch.zeros_like(dz[0])
    rows = list(dz)
    for m in range(NLEVSNOW):
        act = smask[m]
        wx = h2osoi_ice[m] + h2osoi_liq[m]
        dzm = torch.clamp(dz[m], min=1e-12)
        void = 1.0 - (h2osoi_ice[m] * inv(DENICE)
                      + h2osoi_liq[m] * inv(DENH2O)) / dzm
        compact = act & (void > 0.001) & (h2osoi_ice[m] > 0.1)
        bi = h2osoi_ice[m] / dzm
        fi = h2osoi_ice[m] / torch.clamp(wx, min=1e-12)
        td = TFRZ - t_soisno[m]
        dexpf = pw.exp(-c4 * td)
        ddz1 = -c3 * dexpf
        ddz1 = torch.where(bi > dm, ddz1 * pw.exp(-46.0e-3 * (bi - dm)),
                           ddz1)
        ddz1 = torch.where(h2osoi_liq[m] > 0.01 * dzm, ddz1 * c5, ddz1)
        ddz2 = -burden * pw.exp(-0.08 * td - c2 * bi) * inv(eta0)
        fio = torch.clamp(frac_iceold[m], min=1e-12)
        ddz3 = torch.where(
            imelt[m] == 1,
            -1.0 / dtime * torch.clamp((fio - fi) / fio, min=0.0), 0.0)
        pdzdtc = ddz1 + ddz2 + ddz3
        rows[m] = torch.where(compact, dz[m] * (1.0 + pdzdtc * dtime),
                              rows[m])
        burden = burden + torch.where(act, wx, 0.0)
    return torch.stack(rows)


def combo(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy-conserving merge of two snow elements (Combo,
    water_lake.f90:4272-4335). Element 2 merges INTO element 1."""
    dzc = dz1 + dz2
    wicec = ice1 + ice2
    wliqc = liq1 + liq2
    h = (CPICE * ice1 + CPLIQ * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CPICE * ice2 + CPLIQ * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cpc = torch.clamp(CPICE * wicec + CPLIQ * wliqc, min=1e-12)
    tc = torch.where(hc < 0.0, TFRZ + hc / cpc,
                     torch.where(hc <= HFUS * wliqc, TFRZ,
                                 TFRZ + (hc - HFUS * wliqc) / cpc))
    return dzc, wliqc, wicec, tc


def _shift_down(arrs, shift_mask):
    """layer[m] <- layer[m-1] where shift_mask[m] (a masked roll)."""
    return [torch.where(shift_mask, torch.cat([a[:1], a[:-1]], 0), a)
            for a in arrs]


def combine_snow_layers(snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice,
                        h2osoi_liq, z):
    """Merge snow layers below minimum thickness/mass (CombineSnowLayers,
    water_lake.f90:3821-4042). The reference's sequential per-column layer
    shifts become static loops of masked rolls."""
    j_ax = _axis(NSOISNO, snl, NLEVSNOW - 1)
    m_ax = _axis(NSOISNO, snl)

    # -- pass 1: remove ice-poor layers (:3902-3928)
    msn_old = snl
    for j in range(-NLEVSNOW + 1, 1):        # j = -4..0
        m = j + NLEVSNOW - 1
        do = (j >= msn_old + 1) & (h2osoi_ice[m] <= 0.1)
        # dump into layer below (j+1; j=0 dumps into the top soil layer)
        h2osoi_liq = _add(h2osoi_liq, m + 1,
                          torch.where(do, h2osoi_liq[m], 0.0))
        h2osoi_ice = _add(h2osoi_ice, m + 1,
                          torch.where(do, h2osoi_ice[m], 0.0))
        # shift layers snl+1..j-1 down one slot (into snl+2..j)
        shift = do[None] & (j_ax <= j) & (j_ax >= snl[None] + 2)
        t_soisno, h2osoi_liq, h2osoi_ice, dz = _shift_down(
            (t_soisno, h2osoi_liq, h2osoi_ice, dz), shift)
        snl = torch.where(do, snl + 1, snl)

    # -- totals (:3930-3953)
    smask = _snow_mask(snl)
    h2osno = _sum_where(smask, h2osoi_ice + h2osoi_liq)
    snowdp = _sum_where(smask, dz)
    zwice = _sum_where(smask, h2osoi_ice)

    # -- all snow gone (:3959-3967); NOTE the liquid is dropped for lake
    # columns exactly as in the reference (the istsoil recovery is
    # commented out at :3966)
    gone = (snowdp < 0.01) & (snowdp > 0.0)
    snl = torch.where(gone, 0, snl)
    h2osno = torch.where(gone, zwice, h2osno)
    snowdp = torch.where(gone & (h2osno <= 0.0), 0.0, snowdp)

    # -- pass 2: combine layers thinner than dzmin (:3972-4040)
    msn_old2 = snl
    mssi = torch.ones_like(snl)
    dzmin = torch.as_tensor(DZMIN, dtype=torch.float32, device=dz.device)
    for i in range(-NLEVSNOW + 1, 1):        # i = -4..0
        mi = i + NLEVSNOW - 1
        act = (snl < -1) & (i >= msn_old2 + 1)
        thin = dz[mi] < dzmin[torch.clamp(mssi - 1, 0, NLEVSNOW - 1).long()]
        do = act & thin
        is_top = i == (snl + 1)
        dz_m1 = dz[max(mi - 1, 0)]
        dz_p1 = dz[min(mi + 1, NSOISNO - 1)]
        if i == 0:
            # the bottom snow layer combines with the one above
            inner = _full(snl, i - 1)
        else:
            inner = torch.where(dz_m1 + dz[mi] < dz_p1 + dz[mi],
                                _full(snl, i - 1), _full(snl, i + 1))
        neibor = torch.where(is_top, _full(snl, i + 1), inner)
        jidx = torch.clamp(neibor, min=i) + NLEVSNOW - 1   # combined here
        lidx = torch.clamp(neibor, max=i) + NLEVSNOW - 1
        dzc, liqc, icec, tc = combo(
            _gather_m(dz, jidx), _gather_m(h2osoi_liq, jidx),
            _gather_m(h2osoi_ice, jidx), _gather_m(t_soisno, jidx),
            _gather_m(dz, lidx), _gather_m(h2osoi_liq, lidx),
            _gather_m(h2osoi_ice, lidx), _gather_m(t_soisno, lidx))
        dz = _scatter_m(dz, jidx, dzc, do)
        h2osoi_liq = _scatter_m(h2osoi_liq, jidx, liqc, do)
        h2osoi_ice = _scatter_m(h2osoi_ice, jidx, icec, do)
        t_soisno = _scatter_m(t_soisno, jidx, tc, do)
        # shift layers snl+1..j-2 down into snl+2..j-1 (vacating l)
        shift = do[None] & (m_ax <= jidx[None] - 1) & (j_ax >= snl[None] + 2)
        t_soisno, h2osoi_liq, h2osoi_ice, dz = _shift_down(
            (t_soisno, h2osoi_liq, h2osoi_ice, dz), shift)
        snl = torch.where(do, snl + 1, snl)
        mssi = torch.where(act & ~thin, mssi + 1, mssi)

    # -- reset node depths from interfaces (:4027-4040)
    z, zi = _rebuild_snow_geometry(snl, dz, z, zi)
    return snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z


def _rebuild_snow_geometry(snl, dz, z, zi):
    """z/zi from dz for active snow layers, downward from the surface
    (water_lake.f90:4027-4040 and :4274-4287): z[j] = zi[j] - dz[j]/2,
    zi[j-1] = zi[j] - dz[j], with zi(0) = 0 at the snow/lake interface."""
    smask = _snow_mask(snl)
    zr, zir = list(z), list(zi)
    for m in range(NLEVSNOW - 1, -1, -1):    # j = 0 down to -4
        act = smask[m]
        # zi index of "below layer m" is m+1
        zr[m] = torch.where(act, zir[m + 1] - 0.5 * dz[m], zr[m])
        zir[m] = torch.where(act, zir[m + 1] - dz[m], zir[m])
    return torch.stack(zr), torch.stack(zir)


def divide_snow_layers(snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z):
    """Subdivide over-thick snow layers (DivideSnowLayers,
    water_lake.f90:4044-4270). Runs in top-down compressed coordinates
    (rank k = j - snl), then scatters back to the CLM stack."""
    msno = -snl   # 0..5

    # gather into compressed top-down arrays: comp[k-1] = stack[j=k+snl]
    k_ax = _axis(NLEVSNOW, snl, -1)
    gidx = k_ax + snl[None] + (NLEVSNOW - 1)   # stack m for rank k

    def gath(a):
        return list(take_level(a, gidx))
    dzsno, swice, swliq, tsno = (gath(dz), gath(h2osoi_ice),
                                 gath(h2osoi_liq), gath(t_soisno))

    # msno == 1 and dz1 > 0.03 -> split into 2 (:4167-4178)
    c = (msno == 1) & (dzsno[0] > 0.03)
    half = 0.5 * dzsno[0]
    dzsno[0] = torch.where(c, half, dzsno[0])
    dzsno[1] = torch.where(c, half, dzsno[1])
    swice[1] = torch.where(c, 0.5 * swice[0], swice[1])
    swice[0] = torch.where(c, 0.5 * swice[0], swice[0])
    swliq[1] = torch.where(c, 0.5 * swliq[0], swliq[1])
    swliq[0] = torch.where(c, 0.5 * swliq[0], swliq[0])
    tsno[1] = torch.where(c, tsno[0], tsno[1])
    msno = torch.where(c, _full(msno, 2), msno)

    def shave(msno, k, maxdz, split_thresh, split_if_msno_le):
        """Trim rank k to maxdz, Combo the excess into rank k+1, then
        split rank k+1 if it grew beyond split_thresh (:4180-4268)."""
        c1 = (msno > k + 1) & (dzsno[k] > maxdz)
        drr = dzsno[k] - maxdz
        propor = drr / torch.clamp(dzsno[k], min=1e-12)
        zwice = propor * swice[k]
        zwliq = propor * swliq[k]
        keep = _rdiv(maxdz, torch.clamp(dzsno[k], min=1e-12))
        swice_k = keep * swice[k]
        swliq_k = keep * swliq[k]
        dzc, liqc, icec, tc = combo(
            dzsno[k + 1], swliq[k + 1], swice[k + 1], tsno[k + 1],
            drr, zwliq, zwice, tsno[k])
        dzsno[k] = torch.where(c1, maxdz, dzsno[k])
        swice[k] = torch.where(c1, swice_k, swice[k])
        swliq[k] = torch.where(c1, swliq_k, swliq[k])
        dzsno[k + 1] = torch.where(c1, dzc, dzsno[k + 1])
        swice[k + 1] = torch.where(c1, icec, swice[k + 1])
        swliq[k + 1] = torch.where(c1, liqc, swliq[k + 1])
        tsno[k + 1] = torch.where(c1, tc, tsno[k + 1])
        if split_thresh is not None:
            c2 = c1 & (msno <= split_if_msno_le) \
                & (dzsno[k + 1] > split_thresh)
            half = 0.5 * dzsno[k + 1]
            dzsno[k + 2] = torch.where(c2, half, dzsno[k + 2])
            swice[k + 2] = torch.where(c2, 0.5 * swice[k + 1], swice[k + 2])
            swliq[k + 2] = torch.where(c2, 0.5 * swliq[k + 1], swliq[k + 2])
            tsno[k + 2] = torch.where(c2, tsno[k + 1], tsno[k + 2])
            dzsno[k + 1] = torch.where(c2, half, dzsno[k + 1])
            swice[k + 1] = torch.where(c2, 0.5 * swice[k + 1], swice[k + 1])
            swliq[k + 1] = torch.where(c2, 0.5 * swliq[k + 1], swliq[k + 1])
            msno = torch.where(c2, _full(msno, k + 3), msno)
        return msno

    msno = shave(msno, 0, 0.02, 0.07, 2)
    msno = shave(msno, 1, 0.05, 0.18, 3)
    msno = shave(msno, 2, 0.11, 0.41, 4)
    msno = shave(msno, 3, 0.23, None, None)

    snl = -msno

    # scatter back: stack[j] = comp[j - snl - 1] for active layers
    j_ax = _axis(NSOISNO, snl, NLEVSNOW - 1)
    cidx = torch.clamp(j_ax - snl[None] - 1, 0, NLEVSNOW - 1)
    smask = _snow_mask(snl)

    def scat(stack, comp):
        return torch.where(smask, take_level(torch.stack(comp), cidx), stack)
    dz = scat(dz, dzsno)
    h2osoi_ice = scat(h2osoi_ice, swice)
    h2osoi_liq = scat(h2osoi_liq, swliq)
    t_soisno = scat(t_soisno, tsno)

    z, zi = _rebuild_snow_geometry(snl, dz, z, zi)
    return snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z


def shal_lake_hydrology(dz_lake, forc_rain, forc_snow, qflx_evap_tot,
                        forc_t, t_grnd, qflx_evap_soi, qflx_snomelt, imelt,
                        frac_iceold, z, dz, zi, snl, h2osno, snowdp,
                        lake_icefrac, t_lake, t_soisno, h2osoi_ice,
                        h2osoi_liq, h2osoi_vol, watsat, dtime):
    """Snow-layer hydrology over the lake (ShalLakeHydrology,
    water_lake.f90:2562-3325): snowfall accumulation & layer initiation,
    sublimation/dew, percolation, compaction, combine/divide, the
    snow-over-unfrozen-lake dump, and the saturated-soil bookkeeping.
    do_capsnow = .false. as in the ICAR driver."""
    dtime = _dt_tensor(dtime, dz)

    # precipitation onto ground (:2756-2797)
    qflx_prec_grnd_snow = forc_snow
    qflx_prec_grnd_rain = forc_rain
    qflx_prec_grnd = qflx_prec_grnd_snow + qflx_prec_grnd_rain
    qflx_snow_grnd = qflx_prec_grnd_snow
    qflx_rain_grnd = qflx_prec_grnd_rain

    # snowfall accumulation; Alta density relationship (:2804-2825)
    bifall = torch.where(
        forc_t > TFRZ + 2.0, 50.0 + 1.7 * 17.0 ** 1.5,
        torch.where(forc_t > TFRZ - 15.0,
                    50.0 + 1.7 * pw.pow(torch.clamp(forc_t - TFRZ + 15.0,
                                                    min=0.0), 1.5),
                    50.0))
    dz_snowf = qflx_snow_grnd / bifall
    snowdp = snowdp + dz_snowf * dtime
    h2osno = h2osno + qflx_snow_grnd * dtime

    # new snow-layer initiation (:2834-2846)
    newnode = (snl == 0) & (qflx_snow_grnd > 0.0) & (snowdp >= 0.01)
    m0 = NLEVSNOW - 1    # stack index of j = 0
    snl = torch.where(newnode, -1, snl)
    dz = _set(dz, m0, torch.where(newnode, snowdp, dz[m0]))
    z = _set(z, m0, torch.where(newnode, -0.5 * snowdp, z[m0]))
    zi = _set(zi, m0, torch.where(newnode, -snowdp, zi[m0]))
    t_soisno = _set(t_soisno, m0, torch.where(
        newnode, torch.clamp(forc_t, max=TFRZ), t_soisno[m0]))
    h2osoi_ice = _set(h2osoi_ice, m0,
                      torch.where(newnode, h2osno, h2osoi_ice[m0]))
    h2osoi_liq = _set(h2osoi_liq, m0,
                      torch.where(newnode, 0.0, h2osoi_liq[m0]))
    frac_iceold = _set(frac_iceold, m0,
                       torch.where(newnode, 1.0, frac_iceold[m0]))

    # accretion onto existing top layer (:2852-2855)
    accrete = (snl < 0) & ~newnode
    jtop_m = snl + NLEVSNOW
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    dz_top = _gather_m(dz, jtop_m)
    h2osoi_ice = _scatter_m(h2osoi_ice, jtop_m,
                            ice_top + dtime * qflx_snow_grnd, accrete)
    dz = _scatter_m(dz, jtop_m, dz_top + dz_snowf * dtime, accrete)

    # sublimation / dew partition (:2861-2941)
    has_layers = snl < 0
    liq_top = _gather_m(h2osoi_liq, jtop_m)
    ice_top = _gather_m(h2osoi_ice, jtop_m)
    tot_top = liq_top + ice_top
    evap_pos = qflx_evap_soi >= 0.0
    # with snow layers:
    evap_lim = torch.minimum(qflx_evap_soi, tot_top / dtime)
    qflx_evap_grnd_l = torch.where(
        tot_top > 0.0,
        torch.clamp(evap_lim * liq_top / torch.clamp(tot_top, min=1e-12),
                    min=0.0),
        0.0)
    qflx_sub_snow_l = evap_lim - qflx_evap_grnd_l
    qflx_dew_snow_l = torch.where(t_grnd < TFRZ, torch.abs(qflx_evap_soi),
                                  0.0)
    qflx_dew_grnd_l = torch.where(t_grnd >= TFRZ, torch.abs(qflx_evap_soi),
                                  0.0)
    # without snow layers:
    qflx_sub_snow_n = torch.minimum(qflx_evap_soi, h2osno / dtime)
    qflx_evap_grnd_n = qflx_evap_soi - qflx_sub_snow_n
    qflx_dew_snow_n = torch.where(t_grnd < TFRZ - 0.1,
                                  torch.abs(qflx_evap_soi), 0.0)
    qflx_dew_grnd_n = torch.where(t_grnd >= TFRZ - 0.1,
                                  torch.abs(qflx_evap_soi), 0.0)

    qflx_evap_grnd = torch.where(
        evap_pos, torch.where(has_layers, qflx_evap_grnd_l,
                              qflx_evap_grnd_n), 0.0)
    qflx_sub_snow = torch.where(
        evap_pos, torch.where(has_layers, qflx_sub_snow_l, qflx_sub_snow_n),
        0.0)
    qflx_dew_snow = torch.where(
        ~evap_pos, torch.where(has_layers, qflx_dew_snow_l,
                               qflx_dew_snow_n), 0.0)
    qflx_dew_grnd = torch.where(
        ~evap_pos, torch.where(has_layers, qflx_dew_grnd_l,
                               qflx_dew_grnd_n), 0.0)

    # no snow layers: update bulk pack for dew & sublimation (:2922-2938)
    h2osno_temp = h2osno
    h2osno_n = h2osno + (-qflx_sub_snow + qflx_dew_snow) * dtime
    snowdp_n = torch.where(
        h2osno_temp > 0.0,
        snowdp * h2osno_n / torch.clamp(h2osno_temp, min=1e-12),
        h2osno_n * inv(250.0))
    h2osno = torch.where(has_layers, h2osno, torch.clamp(h2osno_n, min=0.0))
    snowdp = torch.where(has_layers, snowdp, snowdp_n)

    # snow water / percolation
    h2osoi_ice, h2osoi_liq, qflx_top_soil = snow_water(
        snl, qflx_snomelt, qflx_rain_grnd, qflx_sub_snow, qflx_evap_grnd,
        qflx_dew_snow, qflx_dew_grnd, dz, h2osoi_ice, h2osoi_liq, dtime)

    # keep lake-bed soil saturated (:2970-2984)
    liq_soil = h2osoi_liq[NLEVSNOW:]
    ice_soil = h2osoi_ice[NLEVSNOW:]
    vol_soil = h2osoi_vol[NLEVSNOW:]
    dz_soil = dz[NLEVSNOW:]
    liq_sat = (watsat * dz_soil - ice_soil * inv(DENICE)) * DENH2O
    liq_cap = watsat * DENH2O * dz_soil
    liq_soil = torch.where(vol_soil < watsat, liq_sat,
                           torch.minimum(liq_soil, liq_cap))
    h2osoi_liq = torch.cat([h2osoi_liq[:NLEVSNOW], liq_soil], 0)

    # compaction / combine / divide
    dz = snow_compaction(snl, imelt, frac_iceold, t_soisno, h2osoi_ice,
                         h2osoi_liq, dz, dtime)
    (snl, h2osno, snowdp, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z) = \
        combine_snow_layers(snl, h2osno, snowdp, dz, zi, t_soisno,
                            h2osoi_ice, h2osoi_liq, z)
    (snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z) = \
        divide_snow_layers(snl, dz, zi, t_soisno, h2osoi_ice, h2osoi_liq, z)

    # snow layers above an unfrozen lake fall in and melt (:3032-3097)
    smask = _snow_mask(snl)
    unfrozen = (t_lake[0] > TFRZ) & (lake_icefrac[0] == 0.0) & (snl < 0)
    sumsnowice = _sum_where(smask, h2osoi_ice)
    heatsum = _sum_where(
        smask, h2osoi_ice * CPICE * (TFRZ - t_soisno)
        + h2osoi_liq * CPLIQ * (TFRZ - t_soisno))
    heatsum = heatsum + sumsnowice * HFUS
    heatrem = ((t_lake[0] - TFRZ) * CPLIQ * DENH2O * dz_lake[0] - heatsum)
    dump = unfrozen & (heatrem + DENH2O * dz_lake[0] * HFUS > 0.0)
    h2osno = torch.where(dump, 0.0, h2osno)
    snl = torch.where(dump, 0, snl)
    t_lake0_cool = t_lake[0] - heatrem / (CPLIQ * DENH2O * dz_lake[0])
    icef0_frz = -heatrem / (DENH2O * dz_lake[0] * HFUS)
    t_lake = _set(t_lake, 0, torch.where(
        dump, torch.where(heatrem > 0.0, t_lake0_cool, TFRZ), t_lake[0]))
    lake_icefrac = _set(lake_icefrac, 0, torch.where(
        dump & (heatrem <= 0.0), icef0_frz, lake_icefrac[0]))

    # zero out layers no longer in use (:3114-3130); snowdp bookkeeping
    smask = _snow_mask(snl)
    is_snow_slot = _axis(NSOISNO, snl, NLEVSNOW - 1) <= 0
    dead = is_snow_slot & ~smask
    h2osoi_ice = torch.where(dead, 0.0, h2osoi_ice)
    h2osoi_liq = torch.where(dead, 0.0, h2osoi_liq)
    t_soisno = torch.where(dead, 0.0, t_soisno)
    dz = torch.where(dead, 0.0, dz)
    z = torch.where(dead, 0.0, z)
    zi = torch.cat([torch.where(dead[:NLEVSNOW], 0.0, zi[:NLEVSNOW]),
                    zi[NLEVSNOW:]], 0)
    # NOTE reference quirk preserved: snowdp is NOT reset when the snow
    # stack dumps into an unfrozen lake (water_lake.f90:3081-3084); the
    # stale value self-corrects in the next step's no-layer dew branch.

    # volumetric soil water (:3178-3186)
    h2osoi_vol = torch.cat([
        h2osoi_vol[:NLEVSNOW],
        h2osoi_liq[NLEVSNOW:] / (dz[NLEVSNOW:] * DENH2O)
        + h2osoi_ice[NLEVSNOW:] / (dz[NLEVSNOW:] * DENICE)], 0)

    return dict(z=z, dz=dz, zi=zi, snl=snl, h2osno=h2osno, snowdp=snowdp,
                lake_icefrac=lake_icefrac, t_lake=t_lake, t_soisno=t_soisno,
                h2osoi_ice=h2osoi_ice, h2osoi_liq=h2osoi_liq,
                h2osoi_vol=h2osoi_vol, qflx_prec_grnd=qflx_prec_grnd)


# --------------------------------------------------------------------------
# one step, and the grid-level driver
# --------------------------------------------------------------------------

def lake_main(forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q, forc_u,
              forc_v, forc_lwrad, prec, sabg, lat_rad, z_lake, dz_lake,
              lakedepth, h2osno, snowdp, snl, z, dz, zi, h2osoi_vol,
              h2osoi_liq, h2osoi_ice, t_grnd, t_soisno, t_lake, savedtke1,
              lake_icefrac, watsat, tkmg, tkdry, tksatu, csol, dtime):
    """One lake timestep: fluxes -> temperature -> hydrology (LakeMain,
    water_lake.f90:444-629). Returns (outputs dict, new state dict)."""
    # rain/snow partition at tcrit (:590-610)
    is_snow = forc_t <= TFRZ + TCRIT
    forc_rain = torch.where(is_snow, 0.0, prec)
    forc_snow = torch.where(is_snow, prec, 0.0)

    fx = shal_lake_fluxes(
        forc_t, forc_pbot, forc_psrf, forc_hgt, forc_q, forc_u, forc_v,
        forc_lwrad, sabg, lat_rad, dz, dz_lake, t_soisno, t_lake, snl,
        h2osoi_liq, h2osoi_ice, savedtke1, t_grnd, h2osno)

    tout = shal_lake_temperature(
        fx.t_grnd, h2osno, sabg, dz, dz_lake, z, zi, z_lake, fx.ws, fx.ks,
        snl, fx.eflx_gnet, lakedepth, lake_icefrac, snowdp, t_lake,
        t_soisno, h2osoi_liq, h2osoi_ice, watsat, tkmg, tkdry, tksatu,
        csol, fx.eflx_sh_grnd, fx.eflx_sh_tot, fx.eflx_soil_grnd, dtime)

    hout = shal_lake_hydrology(
        dz_lake, forc_rain, forc_snow, fx.qflx_evap_soi, forc_t, fx.t_grnd,
        fx.qflx_evap_soi, tout["qflx_snomelt"], tout["imelt"],
        tout["frac_iceold"], z, dz, zi, snl, tout["h2osno"],
        tout["snowdp"], tout["lake_icefrac"], tout["t_lake"],
        tout["t_soisno"], tout["h2osoi_ice"], tout["h2osoi_liq"],
        h2osoi_vol, watsat, dtime)

    outputs = dict(
        eflx_sh_tot=tout["eflx_sh_tot"], eflx_lh_tot=fx.eflx_lh_tot,
        eflx_gnet=tout["eflx_gnet"], t_grnd=fx.t_grnd,
        t_ref2m=fx.t_ref2m, q_ref2m=fx.q_ref2m,
        qflx_evap_soi=fx.qflx_evap_soi, htvp=fx.htvp)
    state = dict(
        savedtke1=tout["savedtke1"], snowdp=hout["snowdp"],
        h2osno=hout["h2osno"], snl=hout["snl"], t_grnd=fx.t_grnd,
        t_lake=hout["t_lake"], lake_icefrac=hout["lake_icefrac"],
        z=hout["z"], dz=hout["dz"], zi=hout["zi"],
        t_soisno=hout["t_soisno"], h2osoi_liq=hout["h2osoi_liq"],
        h2osoi_ice=hout["h2osoi_ice"], h2osoi_vol=hout["h2osoi_vol"])
    return outputs, state


def lake_driver(s, t_1, p_if0, p_if1, dz8w_1, qv_1, u_1, v_1, glw, swdown,
                prec_mm, lat_deg, dtime):
    """Grid-level lake step (Lake, water_lake.f90:139-441).

    ``s`` carries the lake state fields from the model state dict (names as
    in the registry); forcing arguments are the lowest-model-level fields;
    ``dtime`` the time since the last call (a 0-d float32 tensor, or a
    number). Returns (outputs, new_state_fields) -- the caller applies
    them under ``lakemask``.
    """
    dtime = _dt_tensor(dtime, t_1)
    q2k = qv_1 / (1.0 + qv_1)                # mixing ratio -> spec. humidity
    emissi = s["emissivity"]
    lwdn = glw * emissi
    prec_rate = prec_mm / dtime              # mm -> mm/s
    solnet = swdown * (1.0 - s["albedo"])
    zlvl = 0.5 * dz8w_1
    lat_rad = lat_deg * (np.pi / 180.0)

    # stored as a float field
    snl = -_i32(torch.abs(s["snl2d"]))

    outputs, new = lake_main(
        forc_t=t_1, forc_pbot=p_if1, forc_psrf=p_if0, forc_hgt=zlvl,
        forc_q=q2k, forc_u=u_1, forc_v=v_1, forc_lwrad=lwdn,
        prec=prec_rate, sabg=solnet, lat_rad=lat_rad,
        z_lake=s["z_lake3d"], dz_lake=s["dz_lake3d"],
        lakedepth=s["lakedepth2d"], h2osno=s["swe"].to(torch.float32),
        snowdp=s["snow_height"], snl=snl,
        z=s["z3d"], dz=s["dz3d"], zi=s["zi3d"],
        h2osoi_vol=s["h2osoi_vol3d"], h2osoi_liq=s["h2osoi_liq3d"],
        h2osoi_ice=s["h2osoi_ice3d"], t_grnd=s["t_grnd2d"],
        t_soisno=s["t_soisno3d"], t_lake=s["t_lake3d"],
        savedtke1=s["savedtke12d"], lake_icefrac=s["lake_icefrac3d"],
        watsat=s["watsat3d"], tkmg=s["tkmg3d"], tkdry=s["tkdry3d"],
        tksatu=s["tksatu3d"], csol=s["csol3d"], dtime=dtime)

    tsk = outputs["t_grnd"]
    qfx = outputs["eflx_lh_tot"] / _where(tsk >= TFRZ, HVAP, HSUB)
    icef0 = new["lake_icefrac"][0]
    albedo = 0.6 * icef0 + (1.0 - icef0) * 0.08
    th2 = outputs["t_ref2m"] * pw.pow(_rdiv(1.0e5, p_if0), RAIR / CPAIR)

    out = dict(hfx=outputs["eflx_sh_tot"], lh=outputs["eflx_lh_tot"],
               grdflx=outputs["eflx_gnet"], tsk=tsk, qfx=qfx,
               t2=outputs["t_ref2m"], th2=th2, q2=outputs["q_ref2m"],
               albedo=albedo)
    fields = dict(
        savedtke12d=new["savedtke1"], snow_height=new["snowdp"],
        swe=new["h2osno"], snl2d=new["snl"].to(torch.float32),
        t_grnd2d=new["t_grnd"], t_lake3d=new["t_lake"],
        lake_icefrac3d=new["lake_icefrac"], z3d=new["z"], dz3d=new["dz"],
        zi3d=new["zi"], t_soisno3d=new["t_soisno"],
        h2osoi_liq3d=new["h2osoi_liq"], h2osoi_ice3d=new["h2osoi_ice"],
        h2osoi_vol3d=new["h2osoi_vol"])
    return out, fields


# --------------------------------------------------------------------------
# host-side initialization (lakeini, water_lake.f90:4904-5431)
# --------------------------------------------------------------------------

def lake_init(fields: Dict[str, np.ndarray], terrain: np.ndarray,
              lat: np.ndarray, lake_category: int = 21,
              water_category: int = 17,
              lakedepth_default: float = 50.0,
              lake_min_elev: float = 5.0) -> None:
    """Copy of icar_tpu/physics/water_lake.py lake_init: initialize the
    lake state in-place on host numpy arrays (lakeini).

    Mirrors the ICAR driver's call (lsm_driver.f90:948-989): lakemask from
    the land-use lake category when available (lakeflag=1), otherwise from
    water cells above lake_min_elev; lake depth from the hi-res
    ``lake_depth`` field when present, else lakedepth_default.
    """
    veg = fields["veg_type"]
    tsk = fields["skin_temperature"]
    ny, nx = terrain.shape

    if lake_category != -1:
        # lakeflag = 1: land-use data provides a lake category (:5062-5076)
        lakemask = (veg == lake_category)
    else:
        # lakeflag = 0: guess lakes = water cells above lake_min_elev
        lakemask = (veg == water_category) & (terrain >= lake_min_elev)
    fields["lakemask"] = lakemask.astype(np.float32)

    snow = np.asarray(fields["swe"], np.float64)
    snowdp = snow * 0.005                       # kg/m2 -> m (:5009)
    fields["snow_height"] = np.where(lakemask, snowdp,
                                     fields["snow_height"]).astype(np.float32)

    lake_depth = fields.get("lake_depth")
    if lake_depth is not None and np.any(lake_depth > 0):
        depth = np.where(lake_depth > 0, lake_depth, lakedepth_default)
    else:
        depth = np.full((ny, nx), lakedepth_default, np.float32)
    # non-lake cells keep a benign default depth so the masked grid math
    # stays finite (their results are never applied)
    fields["lakedepth2d"] = np.where(lakemask, depth,
                                     lakedepth_default).astype(np.float32)

    # lake layer grid: 10 uniform fractional layers (:5168-5189, the
    # ICAR/BK revision) scaled by depth via depthratio
    dzlak = np.full(NLEVLAKE, 0.1)
    zlak = 0.05 + 0.1 * np.arange(NLEVLAKE)
    std_depth = zlak[-1] + 0.5 * dzlak[-1]      # = 1.0
    depthratio = fields["lakedepth2d"] / std_depth
    dz_lake = dzlak[:, None, None] * depthratio[None]
    z_lake = np.empty_like(dz_lake)
    z_lake[0] = zlak[0]
    dz_lake[0] = dzlak[0]
    z_lake[1:] = (zlak[1:, None, None] * depthratio[None]
                  + dzlak[0] * (1.0 - depthratio[None]))
    fields["z_lake3d"] = z_lake.astype(np.float32)
    fields["dz_lake3d"] = dz_lake.astype(np.float32)

    # soil node grid (:5193-5209)
    scalez = 0.025
    js = np.arange(1, NLEVSOIL + 1)
    zsoi = scalez * (np.exp(0.5 * (js - 0.5)) - 1.0)
    dzsoi = np.empty(NLEVSOIL)
    dzsoi[0] = 0.5 * (zsoi[0] + zsoi[1])
    dzsoi[1:-1] = 0.5 * (zsoi[2:] - zsoi[:-2])
    dzsoi[-1] = zsoi[-1] - zsoi[-2]
    zisoi = np.empty(NLEVSOIL + 1)
    zisoi[0] = 0.0
    zisoi[1:-1] = 0.5 * (zsoi[:-1] + zsoi[1:])
    zisoi[-1] = zsoi[-1] + 0.5 * dzsoi[-1]

    # soil hydraulic/thermal properties from texture (:5219-5240)
    isl = np.clip(fields["soil_type"].astype(np.int32), 1, 19)
    isl = np.where(isl == 14, 15, isl)
    sand = SAND[isl - 1]
    clay = CLAY[isl - 1]
    watsat = 0.489 - 0.00126 * sand
    bd = (1.0 - watsat) * 2.7e3
    tkm = (8.80 * sand + 2.92 * clay) / (sand + clay)
    tkmg = tkm ** (1.0 - watsat)
    tksatu = tkmg * 0.57 ** watsat
    tkdry = (0.135 * bd + 64.7) / (2.7e3 - 0.947 * bd)
    csol = (2.128 * sand + 2.385 * clay) / (sand + clay) * 1.0e6
    for name, arr in (("watsat3d", watsat), ("tkmg3d", tkmg),
                      ("tksatu3d", tksatu), ("tkdry3d", tkdry),
                      ("csol3d", csol)):
        fields[name] = np.broadcast_to(
            arr[None], (NLEVSOIL, ny, nx)).astype(np.float32).copy()

    # initial temperatures (:5243-5272)
    t_lake = np.where(z_lake <= DEPTH_C,
                      tsk[None] + (277.0 - tsk[None]) / DEPTH_C * z_lake,
                      277.0)
    t_lake[0] = tsk
    fields["t_lake3d"] = t_lake.astype(np.float32)
    fields["t_grnd2d"] = np.full((ny, nx), 277.0, np.float32)

    t_soisno = np.zeros((NSOISNO, ny, nx), np.float32)
    t_soisno[NLEVSNOW] = tsk
    for k in range(1, NLEVSOIL):
        zl = z_lake[min(k, NLEVLAKE - 1)]
        t_soisno[NLEVSNOW + k] = np.where(
            zl <= DEPTH_C, tsk + (277.0 - tsk) / DEPTH_C * zl, 277.0)

    # soil/snow node geometry
    z3d = np.zeros((NSOISNO, ny, nx), np.float32)
    dz3d = np.zeros((NSOISNO, ny, nx), np.float32)
    zi3d = np.zeros((NSOISNO + 1, ny, nx), np.float32)
    z3d[NLEVSNOW:] = zsoi[:, None, None]
    dz3d[NLEVSNOW:] = dzsoi[:, None, None]
    zi3d[NLEVSNOW:] = zisoi[:, None, None]

    # snow layer structure from snow depth (:5297-5352)
    sd = snowdp
    snl = np.zeros((ny, nx), np.int32)
    # dz assignment per snow-depth band (lakeini's explicit cascade)
    def setdz(mask, vals):
        for j, v in vals.items():
            m = j + NLEVSNOW - 1
            dz3d[m] = np.where(mask, v, dz3d[m])
    sd64 = sd
    m0 = (sd >= 0.01) & (sd <= 0.03)
    setdz(m0, {0: sd64})
    snl = np.where(m0, -1, snl)
    m1 = (sd > 0.03) & (sd <= 0.04)
    setdz(m1, {-1: sd64 / 2.0, 0: sd64 / 2.0})
    snl = np.where(m1, -2, snl)
    m2 = (sd > 0.04) & (sd <= 0.07)
    setdz(m2, {-1: 0.02, 0: sd64 - 0.02})
    snl = np.where(m2, -2, snl)
    m3 = (sd > 0.07) & (sd <= 0.12)
    setdz(m3, {-2: 0.02, -1: (sd64 - 0.02) / 2.0, 0: (sd64 - 0.02) / 2.0})
    snl = np.where(m3, -3, snl)
    m4 = (sd > 0.12) & (sd <= 0.18)
    setdz(m4, {-2: 0.02, -1: 0.05, 0: sd64 - 0.07})
    snl = np.where(m4, -3, snl)
    m5 = (sd > 0.18) & (sd <= 0.29)
    setdz(m5, {-3: 0.02, -2: 0.05, -1: (sd64 - 0.07) / 2.0,
               0: (sd64 - 0.07) / 2.0})
    snl = np.where(m5, -4, snl)
    m6 = (sd > 0.29) & (sd <= 0.41)
    setdz(m6, {-3: 0.02, -2: 0.05, -1: 0.11, 0: sd64 - 0.18})
    snl = np.where(m6, -4, snl)
    m7 = (sd > 0.41) & (sd <= 0.64)
    setdz(m7, {-4: 0.02, -3: 0.05, -2: 0.11, -1: (sd64 - 0.18) / 2.0,
               0: (sd64 - 0.18) / 2.0})
    snl = np.where(m7, -5, snl)
    m8 = sd > 0.64
    setdz(m8, {-4: 0.02, -3: 0.05, -2: 0.11, -1: 0.23, 0: sd64 - 0.41})
    snl = np.where(m8, -5, snl)

    # snow node z/zi downward from the surface (:5355-5358)
    for j in range(0, -NLEVSNOW, -1):
        m = j + NLEVSNOW - 1
        active = snl <= j - 1
        z3d[m] = np.where(active, zi3d[m + 1] - 0.5 * dz3d[m], z3d[m])
        zi3d[m] = np.where(active, zi3d[m + 1] - dz3d[m], zi3d[m])

    # arbitrary initial snow/soil temperatures and water (:5363-5420)
    for j in range(-NLEVSNOW + 1, 1):
        m = j + NLEVSNOW - 1
        t_soisno[m] = np.where(snl <= j - 1, 250.0, t_soisno[m])
    lake_icefrac = np.where(t_lake >= TFRZ, 0.0, 1.0)
    fields["lake_icefrac3d"] = lake_icefrac.astype(np.float32)

    h2osoi_vol = np.zeros((NSOISNO, ny, nx), np.float32)
    h2osoi_vol[NLEVSNOW:] = np.minimum(1.0, watsat[None])
    h2osoi_ice = np.zeros((NSOISNO, ny, nx), np.float32)
    h2osoi_liq = np.zeros((NSOISNO, ny, nx), np.float32)
    soil_frozen = t_soisno[NLEVSNOW:] <= TFRZ
    h2osoi_ice[NLEVSNOW:] = np.where(
        soil_frozen, dz3d[NLEVSNOW:] * DENICE * h2osoi_vol[NLEVSNOW:], 0.0)
    h2osoi_liq[NLEVSNOW:] = np.where(
        soil_frozen, 0.0, dz3d[NLEVSNOW:] * DENH2O * h2osoi_vol[NLEVSNOW:])
    for j in range(-NLEVSNOW + 1, 1):
        m = j + NLEVSNOW - 1
        active = snl <= j - 1     # k > snl in reference == j >= snl+1
        h2osoi_ice[m] = np.where(active, dz3d[m] * BDSNO, h2osoi_ice[m])
        h2osoi_liq[m] = np.where(active, 0.0, h2osoi_liq[m])

    fields["t_soisno3d"] = t_soisno
    fields["h2osoi_ice3d"] = h2osoi_ice
    fields["h2osoi_liq3d"] = h2osoi_liq
    fields["h2osoi_vol3d"] = h2osoi_vol
    fields["z3d"] = z3d
    fields["dz3d"] = dz3d
    fields["zi3d"] = zi3d
    fields["snl2d"] = snl.astype(np.float32)
    fields["savedtke12d"] = np.full((ny, nx), TKWAT, np.float32)

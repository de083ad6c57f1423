"""Surface layer: open-water fluxes, flux application and the 2 m
diagnostics (icar_tpu/physics/surface.py: water_simple.f90 and the shared
parts of lsm_driver.f90, exchange coefficients :244-265, apply_fluxes
:361-423, surface_diagnostics :299-359).

Divisions by a constant are products with its float32 reciprocal
(``pointwise.inv``), as in the JAX package's compiled step.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops.pointwise import inv
from .mp_simple import sat_mr

MAX_EXCHANGE_C = 0.5    # lsm_driver.f90:88
MIN_EXCHANGE_C = 0.004
SMALL_QV = 1e-10
SFC_LAYER_THICKNESS = 400.0   # options default (options_obj.f90:1824)


def exchange_coefficient(wind, tskin, airt, z_atm, lnz_atm_term,
                         base_exchange_term):
    """Richardson-number bulk exchange coefficient
    (calc_exchange_coefficient, lsm_driver.f90:244-265 /
    water_simple.f90:59-75)."""
    wind = torch.where(wind == 0, 1e-5, wind)
    ri = C.GRAVITY / airt * (airt - tskin) * z_atm / (wind * wind)
    unstable = lnz_atm_term * (1.0 - (15.0 * ri) / (
        1.0 + base_exchange_term * torch.sqrt(torch.abs(ri))))
    stable = lnz_atm_term / ((1.0 + 15.0 * ri) * torch.sqrt(1.0 + 5.0 * ri))
    ex = torch.where(ri < 0, unstable, stable)
    return torch.clamp(ex, MIN_EXCHANGE_C, MAX_EXCHANGE_C)


def ocean_roughness(ustar):
    """(ocean_roughness, water_simple.f90:77-84)."""
    return 8e-6 / torch.clamp(ustar, min=1e-7)


def water_simple(sst, psfc, wind, ustar, qv_1, t_1, z_atm, water_mask,
                 sensible_heat, latent_heat, z0, tskin):
    """Open-water bulk fluxes over the ``water_mask`` cells (water_simple,
    water_simple.f90:86-141). Returns (sh, lh, z0, tskin, qv_surf)."""
    qv_surf = 0.98 * sat_mr(sst, psfc)   # 0.98: salinity effect
    z0_w = ocean_roughness(ustar)
    lnz = torch.log((z_atm + z0_w) / z0_w)
    base_term = (75 * C.KARMAN ** 2 * torch.sqrt((z_atm + z0_w) / z0_w)) \
        / (lnz * lnz)
    lnz_term = (C.KARMAN / lnz) ** 2
    ex = exchange_coefficient(wind, sst, t_1, z_atm, lnz_term, base_term)

    sh_w = ex * wind * (sst - t_1)
    evap = ex * wind * (qv_surf - qv_1)
    lh_w = evap * C.LH_VAPORIZATION

    m = water_mask
    return (torch.where(m, sh_w, sensible_heat),
            torch.where(m, lh_w, latent_heat),
            torch.where(m, z0_w, z0),
            torch.where(m, sst, tskin),
            qv_surf)


def apply_fluxes(th, qv, density, dz, exner, sensible_heat, latent_heat, dt,
                 sfc_layer_thickness=SFC_LAYER_THICKNESS,
                 sh_feedback_fraction=1.0, lh_feedback_fraction=1.0):
    """Spread the surface fluxes over the lowest ``sfc_layer_thickness`` of
    the atmosphere (apply_fluxes, lsm_driver.f90:361-423). ``dt`` is a 0-d
    float32 tensor or a number."""
    # the fraction of each layer inside the surface layer
    below = torch.cat([torch.zeros_like(dz[:1]),
                       torch.cumsum(dz, dim=0)[:-1]], dim=0)
    layer_fraction = torch.clamp((sfc_layer_thickness - below) / dz,
                                 0.0, 1.0)

    dtemp = (sh_feedback_fraction * sensible_heat * dt * inv(C.CP)) \
        / (density * sfc_layer_thickness)
    th = th + (dtemp / exner) * layer_fraction
    dqv = (lh_feedback_fraction * latent_heat * inv(C.LH_VAPORIZATION)
           * dt) / (density * sfc_layer_thickness)
    qv = qv + dqv * layer_fraction
    qv = torch.clamp(qv, min=SMALL_QV)
    return th, qv


def surface_diagnostics(hfx, qfx, tskin, qsfc, chs2, cqs2, psfc):
    """2 m temperature and humidity from flux-gradient relations
    (surface_diagnostics, lsm_driver.f90:299-359, WRF sfcdiags)."""
    rho = psfc / (C.RD * tskin)
    q2 = torch.where(cqs2 < 1e-3, qsfc, qsfc - qfx / (rho * cqs2))
    t2 = torch.where(chs2 < 1e-3, tskin, tskin - hfx / (rho * C.CP * chs2))
    q2 = torch.clamp(q2, min=SMALL_QV)
    return t2, q2

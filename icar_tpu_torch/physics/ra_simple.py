"""Simple empirical radiation (Reiff 1984 shortwave, Idso & Jackson 1969
longwave) (icar_tpu/physics/ra_simple.py, ra_simple.f90): clear-sky
shortwave from the solar geometry, cloud fraction from Xu & Randall
(1996), longwave from the air temperature, and a fixed ~1.5 K/day
radiative cooling of the atmosphere.

Divisions by a constant are written as products with its float32
reciprocal (``pointwise.inv``), as the JAX package's compiled step forms
them, so the CPU and the card compute alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as C
from ..ops import pointwise as pw
from ..ops.pointwise import inv

SOLAR_CONSTANT = 1367.0     # ra_simple.f90:58
QC_MIN = 1e-6
N_RAD_LAYERS = 5


def relative_humidity(t, qv, p):
    """(relative_humidity, atm_utilities.f90:306-326)."""
    mr = qv / (1 - qv)
    e = mr * p / (0.62197 + mr)
    es = 611.2 * torch.exp(17.67 * (t - 273.15) / (t - 29.65))
    return e / es


def cloudfrac(rh, qc):
    """Xu & Randall (1996) cloud fraction (cloudfrac, ra_simple.f90:125-148)."""
    temporary = torch.clamp(pw.pow((1 - rh) * qc, 0.25), 0.0001, 1.0)
    qc_eff = torch.clamp(qc - QC_MIN, min=5e-8)
    frac = pw.pow(rh, 0.25) * (1 - torch.exp((-2000 * qc_eff) / temporary))
    return torch.clamp(frac, 0.0, 1.0)


def solar_elevation(day_of_year_utc, year_length, lon, sin_lat, cos_lat):
    """Solar elevation and fractional year per cell, local solar time from
    the longitude (calc_solar_elevation, ra_simple.f90:150-190).
    ``day_of_year_utc`` (a 0-d float32 tensor) is the fractional day of
    the year; ``lon``, ``sin_lat`` and ``cos_lat`` are (ny, nx) float32."""
    lon_offset = torch.where(lon > 180, (lon - 360) * inv(360.0),
                             lon * inv(360.0))
    day_of_year = day_of_year_utc + lon_offset
    hour_angle = 2 * math.pi * torch.remainder(day_of_year + 0.5, 1.0)
    day_frac = day_of_year / year_length
    declination = -0.4091 * torch.cos(2.0 * np.pi / 365.0
                                      * (day_of_year + 10))
    elev = (sin_lat * torch.sin(declination)
            + cos_lat * torch.cos(declination) * torch.cos(hour_angle))
    elev = torch.asin(torch.clamp(elev, -1.0, 1.0))
    return torch.clamp(elev, min=0.0), day_frac


def shortwave_down(day_frac, cloud_cover, elev):
    """(shortwave, ra_simple.f90:85-103)."""
    s = torch.sin(elev)
    sw = SOLAR_CONSTANT * (1 + 0.035 * torch.cos(day_frac * 2 * np.pi)) \
        * s * (0.48 + 0.29 * s)
    return sw * (1 - 0.75 * pw.pow(cloud_cover, 3.4))


def longwave_down(t_air, cloud_cover):
    """(longwave, ra_simple.f90:105-120)."""
    d = 273.16 - t_air
    emissivity = 1 - 0.261 * torch.exp(-7.77e-4 * (d * d))
    t2 = t_air * t_air
    lw = emissivity * C.STEFAN_BOLTZMANN * (t2 * t2)
    return torch.clamp(lw * (1 + 0.2 * cloud_cover), max=600.0)


def ra_simple(theta, exner, qv, qc, qs, qr, p, lon, sin_lat, cos_lat,
              day_of_year, year_length, dt, runlw=True):
    """The scheme (ra_simple, ra_simple.f90:192-271). ``dt`` is a 0-d
    float32 tensor or a number. ``runlw=False`` is F_runlw=.False.
    (ra_simple.f90:260-266): only swdown and the cloud cover, no lwdown
    (None) and no radiative cooling, as the RRTMG driver borrows the
    simple shortwave (use_simple_sw, ra_driver.f90:429-449). Returns
    (theta, swdown, lwdown, cloud_cover)."""
    t = theta * exner
    t_air = pw.sum0(t[:N_RAD_LAYERS]) * inv(N_RAD_LAYERS)
    rh = pw.sum0(relative_humidity(t[:N_RAD_LAYERS], qv[:N_RAD_LAYERS],
                                   p[:N_RAD_LAYERS])) * inv(N_RAD_LAYERS)
    rh = torch.clamp(rh, max=1.0)
    hydrometeors = torch.clamp(pw.sum0(qc + qs + qr), min=0.0)

    elev, day_frac = solar_elevation(day_of_year, year_length, lon,
                                     sin_lat, cos_lat)
    cc = cloudfrac(rh, hydrometeors)
    sw = shortwave_down(day_frac, cc, elev)
    if not runlw:
        return theta, sw, None, cc
    lw = longwave_down(t_air, cc)

    # ~1.5 K/day radiative cooling (ra_simple.f90:233)
    coolingrate = 1.5 * (dt * inv(86400.0)) * C.STEFAN_BOLTZMANN \
        * inv(300.0)
    t2 = t * t
    theta = theta - (t2 * t2) * coolingrate
    return theta, sw, lw, cc

"""Copy of icar_tpu/physics/ghg.py, kept identical by
tests/test_torch_setup.py.

Greenhouse-gas concentrations for RRTMG (rad_parameters read_ghg).

Re-implementation of the clWRF support module
(the reference ra_clWRF_support.f90:100-595) plus the
wrappers' built-in annual CO2 formula (ra_rrtmg_lw.f90:11904,
ra_rrtmg_sw.f90:10336).

With read_ghg=false the reference uses the WRF v4.2 annual CO2 function
and fixed RRTMG defaults for the other gases; with read_ghg=true it reads
``CAMtr_volume_mixing_ratio`` (two header lines, then
``year co2[ppm] n2o[ppb] ch4[ppb] cfc11[ppt] cfc12[ppt]`` rows) and
linearly interpolates between mid-year anchors.

Deliberate simplification: values are evaluated once per run from the
simulation start date instead of per radiation call — the reference
re-reads/interpolates every call, but the interpolated values change on a
yearly timescale, far slower than any ICAR run.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

# RRTMG defaults when a gas is missing (orig_val, ra_clWRF_support:563-578)
DEFAULT_N2O = 319e-9
DEFAULT_CH4 = 1774e-9
DEFAULT_CFC11 = 0.251e-9
DEFAULT_CFC12 = 0.538e-9


def annual_co2(year):
    """WRF v4.2 annual-mean CO2 vmr (ra_rrtmg_lw.f90:11904)."""
    return (280.0 + 90.0 * np.exp(0.02 * (year - 2000))) * 1e-6


def _interp_gas(years, vals, frac_year, scale, floor=None):
    """Linear interpolation over valid (>0) entries at mid-year anchors
    (interpolate_CAMgases + valid_years, ra_clWRF_support:372-525)."""
    valid = vals > 0
    if valid.sum() < 2:
        return None
    yv = years[valid] + 0.5
    vv = vals[valid]
    x = float(np.interp(frac_year, yv, vv))
    if floor is not None and x < floor:
        x = floor
    return x * scale


def read_cam_gases(year, julian, path="CAMtr_volume_mixing_ratio"):
    """GHG vmrs for the given date; falls back per-gas to the RRTMG
    defaults (and the annual CO2 formula) exactly like read_CAMgases."""
    co2 = annual_co2(year)
    n2o, ch4 = DEFAULT_N2O, DEFAULT_CH4
    cfc11, cfc12 = DEFAULT_CFC11, DEFAULT_CFC12
    if os.path.exists(path):
        years, cols = [], []
        with open(path) as f:
            lines = f.readlines()[2:]
        for ln in lines:
            parts = ln.split()
            if len(parts) < 2:
                continue
            try:
                yr = int(parts[0])
                row = [float(p) for p in parts[1:6]]
            except ValueError:
                continue
            row += [-9999.0] * (5 - len(row))
            years.append(yr)
            cols.append(row)
        if years:
            years = np.asarray(years, np.float64)
            cols = np.asarray(cols, np.float64)
            frac = year + julian / 365.25
            v = _interp_gas(years, cols[:, 0], frac, 1e-6, floor=270.0)
            if v is not None:
                co2 = v
            # NOTE reference quirk preserved: the 270 floor is applied to
            # N2O in ppb too (ra_clWRF_support:276-279)
            v = _interp_gas(years, cols[:, 1], frac, 1e-9, floor=270.0)
            if v is not None:
                n2o = v
            v = _interp_gas(years, cols[:, 2], frac, 1e-9)
            if v is not None:
                ch4 = v
            v = _interp_gas(years, cols[:, 3], frac, 1e-12)
            if v is not None:
                cfc11 = v
            v = _interp_gas(years, cols[:, 4], frac, 1e-12)
            if v is not None:
                cfc12 = v
    return SimpleNamespace(co2=co2, n2o=n2o, ch4=ch4, cfc11=cfc11,
                           cfc12=cfc12)


def ghg_for_options(options):
    """Resolve GHG concentrations from the run options (start date +
    read_ghg)."""
    t0 = options.start_time()
    year = int(t0.date()[0])
    julian = float(t0.day_of_year())
    if getattr(options.rad, "read_ghg", False):
        return read_cam_gases(year, julian)
    return SimpleNamespace(co2=annual_co2(year), n2o=DEFAULT_N2O,
                           ch4=DEFAULT_CH4, cfc11=DEFAULT_CFC11,
                           cfc12=DEFAULT_CFC12)

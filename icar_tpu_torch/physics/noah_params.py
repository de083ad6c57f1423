"""Copy of icar_tpu/physics/noah_params.py, kept identical by
tests/test_torch_setup.py.

Noah LSM vegetation / soil / general parameter tables. The reference reads
these at init from WRF's VEGPARM.TBL, SOILPARM.TBL and GENPARM.TBL
(SOIL_VEG_GEN_PARM, lsm_noahdrv.f90:1199-1400). The default
MODIFIED_IGBP_MODIS_NOAH vegetation classes (21) and STAS soil classes (19)
are built in; TBL files in the run directory override them (`load_tables`).

Tables are numpy arrays indexed by 1-based category id (row 0 unused).
"""

from __future__ import annotations

import os
import re

import numpy as np

NSOIL = 4
DZS = np.array([0.1, 0.3, 0.6, 1.0], np.float32)   # layer thicknesses [m]

# MODIFIED_IGBP_MODIS_NOAH special categories
# (set_default_LU_categories, options_obj.f90:1677-1682)
ISURBAN = 13
ISICE = 15
ISWATER = 17
ISLAKE = 21
BARE = 16
NATURAL = 14

# general parameters (GENPARM.TBL)
SLOPE_DATA = np.array([0.0, 0.1, 0.6, 1.0, 0.35, 0.55, 0.8, 0.63, 0.0, 0.0])
SBETA = -2.0
FXEXP = 2.0
CSOIL = 2.0e6
SALP = 2.6
REFDK = 2.0e-6
REFKDT = 3.0
FRZK = 0.15
ZBOT = -8.0
CZIL = 0.1
LVCOEF = 0.5
# vegetation-section scalars (VEGPARM.TBL trailing block)
TOPT = 298.0
CMCMAX = 0.5e-3
CFACTR = 0.5
RSMAX = 5000.0

# MODIFIED_IGBP_MODIS_NOAH vegetation parameters, columns:
# shdfac nroot rs rgl hs snup maxalb laimin laimax emissmin emissmax
# albedomin albedomax z0min z0max  (VEGPARM.TBL)
_VEG_ROWS = """
1  .70 4 125.  30. 47.35 0.08  52. 5.00 6.40 .950 .950 .12 .12 .50    .50
2  .95 4 150.  30. 41.69 0.08  35. 3.08 6.48 .950 .950 .12 .12 .50    .50
3  .70 4 150.  30. 47.35 0.08  54. 1.00 5.16 .930 .940 .14 .15 .50    .50
4  .80 4 100.  30. 54.53 0.08  58. 1.85 3.31 .930 .930 .16 .17 .50    .50
5  .80 4 125.  30. 51.93 0.08  53. 2.80 5.50 .930 .970 .17 .25 .20    .50
6  .70 3 300. 100. 42.00 0.03  60. 0.50 3.66 .930 .930 .25 .30 .01    .05
7  .70 3 170. 100. 39.18 0.035 65. 0.60 2.60 .930 .950 .22 .30 .01    .06
8  .70 3 300. 100. 42.00 0.03  60. 0.50 3.66 .930 .930 .25 .30 .01    .05
9  .50 3  70.  65. 54.53 0.04  50. 0.50 3.66 .920 .920 .20 .20 .15    .15
10 .80 3  40. 100. 36.35 0.04  70. 0.52 2.90 .920 .960 .19 .23 .10    .12
11 .60 2  70.  65. 55.97 0.015 59. 1.75 5.72 .950 .950 .14 .14 .30    .30
12 .80 3  40. 100. 36.25 0.04  66. 1.56 5.68 .920 .985 .17 .23 .05    .15
13 .10 1 200. 999. 999.0 0.04  46. 1.00 1.00 .880 .880 .15 .15 .50    .50
14 .80 3  40. 100. 36.25 0.04  68. 2.29 4.29 .920 .980 .18 .23 .05    .14
15 .00 1 999. 999. 999.0 0.02  82. 0.01 0.01 .950 .950 .55 .70 0.001  0.001
16 .01 1 999. 999. 999.0 0.02  75. 0.10 0.75 .900 .900 .38 .38 .01    .01
17 .00 0 100.  30. 51.75 0.01  70. 0.01 0.01 .980 .980 .08 .08 0.0001 0.0001
18 .60 3 150. 100. 42.00 0.025 55. 0.41 3.35 .930 .930 .15 .20 .30    .30
19 .60 3 150. 100. 42.00 0.025 60. 0.41 3.35 .920 .920 .15 .20 .15    .15
20 .30 2 200. 100. 42.00 0.02  75. 0.41 3.35 .900 .900 .25 .25 .05    .10
21 .00 0 100.  30. 51.75 0.01  70. 0.01 0.01 .980 .980 .08 .08 0.0001 0.0001
"""

# STAS soil parameters, columns: bb drysmc f11 maxsmc refsmc satpsi
# satdk satdw wltsmc qtz  (SOILPARM.TBL)
_SOIL_ROWS = """
1   2.79 0.010  -0.472 0.339 0.236 0.069 4.66E-5 0.608E-6 0.010 0.92
2   4.26 0.028  -1.044 0.421 0.383 0.036 1.41E-5 0.514E-5 0.028 0.82
3   4.74 0.047  -0.569 0.434 0.383 0.141 5.23E-6 0.805E-5 0.047 0.60
4   5.33 0.084   0.162 0.476 0.360 0.759 2.81E-6 0.239E-4 0.084 0.25
5   5.33 0.084   0.162 0.476 0.383 0.759 2.81E-6 0.239E-4 0.084 0.10
6   5.25 0.066  -0.327 0.439 0.329 0.355 3.38E-6 0.143E-4 0.066 0.40
7   6.77 0.067  -1.491 0.404 0.314 0.135 4.45E-6 0.990E-5 0.067 0.60
8   8.72 0.120  -1.118 0.464 0.387 0.617 2.03E-6 0.237E-4 0.120 0.10
9   8.17 0.103  -1.297 0.465 0.382 0.263 2.45E-6 0.113E-4 0.103 0.35
10 10.73 0.100  -3.209 0.406 0.338 0.098 7.22E-6 0.187E-4 0.100 0.52
11 10.39 0.126  -1.916 0.468 0.404 0.324 1.34E-6 0.964E-5 0.126 0.10
12 11.55 0.138  -2.138 0.468 0.412 0.468 9.74E-7 0.112E-4 0.138 0.25
13  5.25 0.066  -0.327 0.439 0.329 0.355 3.38E-6 0.143E-4 0.066 0.05
14  0.0  0.0     0.0   1.0   0.0   0.0   0.0     0.0      0.0   0.60
15  2.79 0.006  -1.111 0.20  0.17  0.069 1.41E-4 0.136E-3 0.006 0.07
16  4.26 0.028  -1.044 0.421 0.283 0.036 1.41E-5 0.514E-5 0.028 0.25
17 11.55 0.030 -10.472 0.468 0.454 0.468 9.74E-7 0.112E-4 0.030 0.60
18  2.79 0.006  -0.472 0.200 0.17  0.069 1.41E-4 0.136E-3 0.006 0.52
19  2.79 0.01   -0.472 0.339 0.236 0.069 4.66E-5 0.608E-6 0.01  0.92
"""

_VEG_COLS = ("shdfac", "nroot", "rs", "rgl", "hs", "snup", "maxalb",
             "laimin", "laimax", "emissmin", "emissmax", "albedomin",
             "albedomax", "z0min", "z0max")
_SOIL_COLS = ("bb", "drysmc", "f11", "maxsmc", "refsmc", "satpsi",
              "satdk", "satdw", "wltsmc", "qtz")


def _parse_rows(text, ncols):
    rows = {}
    for line in text.strip().splitlines():
        vals = line.split()
        rows[int(vals[0])] = [float(v) for v in vals[1:1 + ncols]]
    n = max(rows) + 1
    arr = np.zeros((n, ncols))
    for i, v in rows.items():
        arr[i] = v
    return arr


class NoahTables:
    """Column arrays indexed by category id (row 0 unused)."""

    def __init__(self, veg=None, soil=None):
        veg = veg if veg is not None else _parse_rows(_VEG_ROWS,
                                                      len(_VEG_COLS))
        soil = soil if soil is not None else _parse_rows(_SOIL_ROWS,
                                                         len(_SOIL_COLS))
        for i, name in enumerate(_VEG_COLS):
            setattr(self, name, veg[:, i].astype(np.float32))
        for i, name in enumerate(_SOIL_COLS):
            setattr(self, name, soil[:, i].astype(np.float32))
        self.nroot = self.nroot.astype(np.int32)
        self.n_veg = veg.shape[0] - 1
        self.n_soil = soil.shape[0] - 1


def _read_tbl_section(path, section, ncols):
    """Parse the rows of `section` from a WRF .TBL file; None if absent."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    try:
        start = next(i for i, ln in enumerate(lines) if ln == section)
    except StopIteration:
        return None
    ncats = int(re.split(r"[ ,]+", lines[start + 1])[0])
    rows = {}
    for ln in lines[start + 2:start + 2 + ncats + 2]:
        parts = re.split(r"[ ,]+", ln.split("'")[0].strip())
        parts = [p for p in parts if p]
        try:
            cat = int(parts[0])
        except (ValueError, IndexError):
            continue
        try:
            rows[cat] = [float(v) for v in parts[1:1 + ncols]]
        except ValueError:
            continue
        if len(rows) == ncats:
            break
    if not rows:
        return None
    arr = np.zeros((max(rows) + 1, ncols))
    for i, v in rows.items():
        arr[i] = v
    return arr


def load_tables(run_dir: str = ".",
                lu_categories: str = "MODIFIED_IGBP_MODIS_NOAH",
                soil_categories: str = "STAS") -> NoahTables:
    """Built-in defaults, overridden by VEGPARM.TBL / SOILPARM.TBL files
    in `run_dir` when present (matching the reference's table reading)."""
    veg = soil = None
    vp = os.path.join(run_dir, "VEGPARM.TBL")
    if os.path.exists(vp):
        # veg rows have 17 columns; the last two (ztopv/zbotv) are
        # UA-physics only (ua_phys=.false. in ICAR) and are dropped
        full = _read_tbl_section(vp, lu_categories, len(_VEG_COLS))
        if full is not None:
            veg = full
    sp = os.path.join(run_dir, "SOILPARM.TBL")
    if os.path.exists(sp):
        full = _read_tbl_section(sp, soil_categories, len(_SOIL_COLS))
        if full is not None:
            soil = full
    return NoahTables(veg, soil)

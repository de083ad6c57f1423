"""Copy of icar_tpu/physics/noahmp_params.py's numpy part (the Noah-MP
MPTABLE + SOILPARM + GENPARM tables: NSOIL, NSNOW, SOILCOLOR, the embedded
MODIS, radiation and global tables and ``load_mp_tables``), held to the
original by tests/test_torch_setup.py, and ``resolve_params`` in torch:
the per-cell parameters gathered by clipped vegetation and soil index on
the caller's device (TRANSFER_MP_PARAMETERS, lsm_noahmpdrv.f90:1172-1441).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.pointwise import inv
from ..utils.namelist import read_namelist
from . import noah_params

NSOIL = 4
NSNOW = 3           # lsm_noahmpdrv.f90:512 (fixed)
SOILCOLOR = 4       # lsm_noahmpdrv.f90:753 (middle color category)

# MODIS (MODIFIED_IGBP_MODIS_NOAH) NoahMP vegetation parameters,
# values as published in the WRF/NoahMP MPTABLE (read from
# run/MPTABLE.TBL when present; these are the shipped defaults).
_MODIS = {
    "ch2op": [0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,0.1,
0.1,0.1,0.1],
    "dleaf": [0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,0.04,
0.04,0.04,0.04,0.04,0.04,0.04,0.04],
    "z0mvt": [1.09,1.1,0.85,0.8,0.8,0.2,0.06,0.6,0.5,0.12,0.3,0.15,1.,0.14,
0.,0.,0.,0.3,0.2,0.03,0.],
    "hvt": [20.,20.,18.,16.,16.,1.1,1.1,13.,10.,1.,5.,2.,15.,1.5,
0.,0.,0.,4.,2.,0.5,0.],
    "hvb": [8.5,8.,7.,11.5,10.,0.1,0.1,0.1,0.1,0.05,0.1,0.1,
1.,0.1,0.,0.,0.,0.3,0.2,0.1,0.],
    "den": [2.80e-01,2.00e-02,2.80e-01,1.00e-01,1.00e-01,1.00e+01,1.00e+01,1.00e+01,
2.00e-02,1.00e+02,5.05e+00,2.50e+01,1.00e-02,2.50e+01,0.00e+00,1.00e-02,
1.00e-02,1.00e+00,1.00e+00,1.00e+00,0.00e+00],
    "rc": [1.2,3.6,1.2,1.4,1.4,0.12,0.12,0.12,3.,0.03,0.75,0.08,1.,0.08,
0.,0.01,0.01,0.3,0.3,0.3,0.],
    "mfsno": [1.,1.,1.,1.,1.,2.,2.,2.,2.,2.,3.,3.,4.,4.,2.5,3.,3.,3.5,
3.5,3.5,2.5],
    "scffac": [0.008,0.008,0.008,0.008,0.008,0.016,0.016,0.02,0.02,0.02,0.02,0.014,
0.042,0.026,0.03,0.016,0.03,0.03,0.03,0.03,0.03],
    "rhol_vis": [0.07,0.1,0.07,0.1,0.1,0.07,0.07,0.07,0.1,0.11,0.105,0.11,
0.,0.11,0.,0.,0.,0.1,0.1,0.1,0.],
    "rhol_nir": [0.35,0.45,0.35,0.45,0.45,0.35,0.35,0.35,0.45,0.58,0.515,0.58,
0.,0.58,0.,0.,0.,0.45,0.45,0.45,0.],
    "rhos_vis": [0.16,0.16,0.16,0.16,0.16,0.16,0.16,0.16,0.16,0.36,0.26,0.36,0.,0.36,
0.,0.,0.,0.16,0.16,0.16,0.],
    "rhos_nir": [0.39,0.39,0.39,0.39,0.39,0.39,0.39,0.39,0.39,0.58,0.485,0.58,
0.,0.58,0.,0.,0.,0.39,0.39,0.39,0.],
    "taul_vis": [0.05,0.05,0.05,0.05,0.05,0.05,0.05,0.05,0.05,0.07,0.06,0.07,0.,0.07,
0.,0.,0.,0.05,0.05,0.05,0.],
    "taul_nir": [0.1,0.25,0.1,0.25,0.25,0.1,0.1,0.1,0.25,0.25,0.25,0.25,0.,0.25,
0.,0.,0.,0.25,0.25,0.25,0.],
    "taus_vis": [0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.22,
0.1105,0.22,0.,0.22,0.,0.,0.,0.001,0.001,0.001,
0.],
    "taus_nir": [0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.001,0.38,
0.1905,0.38,0.,0.38,0.,0.,0.,0.001,0.001,0.001,
0.],
    "xl": [0.01,0.01,0.01,0.25,0.25,0.01,0.01,0.01,0.01,-0.3,
-0.025,-0.3,0.,-0.3,0.,0.,0.,0.25,0.25,0.25,
0.],
    "cwpvt": [0.18,0.67,0.18,0.67,0.29,1.,2.,1.3,1.,5.,1.17,1.67,1.67,1.67,
0.18,0.18,0.18,0.67,1.,0.18,0.18],
    "c3psn": [1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.],
    "kc25": [30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,30.,
30.,30.,30.],
    "akc": [2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,2.1,
2.1,2.1,2.1],
    "ko25": [30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,
30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,30000.,
30000.],
    "ako": [1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,1.2,
1.2,1.2,1.2],
    "avcmx": [2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,2.4,
2.4,2.4,2.4],
    "aqe": [1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.,1.],
    "ltovrc": [0.5,0.55,0.2,0.55,0.5,0.65,0.65,0.65,0.65,0.5,1.4,1.6,0.,1.2,
0.,0.,0.,1.3,1.4,1.,0.],
    "dilefc": [1.2,0.5,1.8,0.6,0.8,0.2,0.2,0.2,0.5,0.2,0.4,0.5,0.,0.35,
0.,0.,0.,0.3,0.4,0.3,0.],
    "dilefw": [0.2,4.,0.2,0.2,0.2,0.2,0.2,0.2,0.5,0.1,0.2,0.2,0.,0.2,0.,0.,0.,0.2,
0.2,0.2,0.],
    "rmf25": [3.,0.65,4.,3.,3.,0.26,0.26,0.26,0.8,1.8,3.2,1.,0.,1.45,
0.,0.,0.,3.,3.,3.,0.],
    "sla": [80.,80.,80.,80.,80.,60.,60.,60.,50.,60.,80.,80.,60.,80.,0.,0.,0.,80.,
80.,80.,0.],
    "fragr": [0.1,0.2,0.1,0.2,0.1,0.2,0.2,0.2,0.2,0.2,0.1,0.2,0.,0.2,0.,0.1,0.,0.1,
0.1,0.1,0.],
    "tmin": [265.,273.,268.,273.,268.,273.,273.,273.,273.,273.,268.,273.,0.,273.,
0.,0.,0.,268.,268.,268.,0.],
    "vcmx25": [50.,60.,60.,60.,55.,40.,40.,40.,40.,40.,50.,80.,0.,60.,0.,0.,0.,50.,
50.,50.,0.],
    "tdlef": [278.,278.,268.,278.,268.,278.,278.,278.,278.,278.,268.,278.,278.,278.,
0.,0.,0.,268.,268.,268.,0.],
    "bp": [2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,2.e+03,
2.e+03,2.e+03,1.e+15,2.e+03,1.e+15,2.e+03,1.e+15,2.e+03,2.e+03,2.e+03,
1.e+15],
    "mp": [6.,9.,6.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.,9.],
    "qe25": [0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.06,0.,0.06,
0.,0.06,0.,0.06,0.06,0.06,0.],
    "rms25": [0.9,0.3,0.64,0.1,0.8,0.1,0.1,0.1,0.32,0.1,0.1,0.1,0.,0.1,
0.,0.,0.,0.1,0.1,0.,0.],
    "rmr25": [0.36,0.05,0.05,0.01,0.03,0.,0.,0.,0.01,1.2,0.,0.,0.,0.,
0.,0.,0.,2.11,2.11,0.,0.],
    "arm": [2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.,2.],
    "folnmx": [1.5,1.5,1.5,1.5,1.5,1.5,1.5,1.5,1.5,1.5,1.5,1.5,0.,1.5,0.,1.5,0.,1.5,
1.5,1.5,0.],
    "wdpool": [1.,1.,1.,1.,1.,1.,1.,1.,1.,0.,0.5,0.,0.,0.,0.,0.,0.,1.,
1.,0.,0.],
    "wrrat": [30.,30.,30.,30.,30.,3.,3.,3.,3.,0.,15.,0.,0.,0.,0.,0.,0.,3.,
3.,0.,0.],
    "mrp": [0.37,0.23,0.37,0.4,0.3,0.19,0.19,0.19,0.4,0.17,0.285,0.23,
0.,0.23,0.,0.,0.,0.23,0.2,0.,0.],
    "nroot": [4.,4.,4.,4.,4.,3.,3.,3.,3.,3.,2.,3.,1.,3.,1.,1.,0.,3.,3.,2.,1.],
    "rgl": [30.,30.,30.,30.,30.,100.,100.,100.,65.,100.,65.,100.,999.,100.,
999.,999.,30.,100.,100.,100.,999.],
    "rs": [125.,150.,150.,100.,125.,300.,170.,300.,70.,40.,70.,40.,200.,40.,
999.,999.,100.,150.,150.,200.,999.],
    "hs": [47.35,41.69,47.35,54.53,51.93,42.,39.18,42.,54.53,36.35,
55.97,36.25,999.,36.25,999.,999.,51.75,42.,42.,42.,
999.],
    "topt": [298.,298.,298.,298.,298.,298.,298.,298.,298.,298.,298.,298.,298.,298.,
298.,298.,298.,298.,298.,298.,298.],
    "rsmax": [5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,
5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.,5000.],
    "saim": [[0.4,0.5,0.3,0.4,0.4,0.3,0.2,0.4,0.3,0.3,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.1,0.,0.],
[0.4,0.5,0.3,0.4,0.4,0.3,0.2,0.4,0.3,0.3,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.1,0.,0.],
[0.4,0.5,0.3,0.4,0.4,0.3,0.2,0.4,0.3,0.3,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.1,0.,0.],
[0.3,0.5,0.4,0.4,0.4,0.3,0.2,0.4,0.3,0.3,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.1,0.,0.],
[0.4,0.5,0.4,0.4,0.4,0.3,0.2,0.4,0.3,0.3,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.1,0.,0.],
[0.5,0.5,0.7,0.4,0.4,0.3,0.2,0.4,0.4,0.4,0.4,0.3,0.,0.4,0.,0.,0.,
0.2,0.2,0.,0.],
[0.5,0.5,1.3,0.9,0.7,0.6,0.4,0.7,0.8,0.8,0.6,0.4,0.,0.6,0.,0.,0.,
0.4,0.4,0.,0.],
[0.6,0.5,1.2,1.2,0.8,0.9,0.6,1.2,1.2,1.3,0.9,0.5,0.,0.9,0.,0.,0.,
0.6,0.6,0.,0.],
[0.6,0.5,1.,1.6,1.,1.2,0.8,1.4,1.3,1.1,0.9,0.4,0.,0.7,0.,0.,0.,
0.8,0.7,0.,0.],
[0.7,0.5,0.8,1.4,1.,0.9,0.7,1.1,0.7,0.4,0.6,0.3,0.,0.3,0.,0.,0.,
0.7,0.5,0.,0.],
[0.6,0.5,0.6,0.6,0.5,0.4,0.3,0.5,0.4,0.4,0.4,0.3,0.,0.3,0.,0.,0.,
0.3,0.3,0.,0.],
[0.5,0.5,0.5,0.4,0.4,0.3,0.2,0.4,0.4,0.4,0.3,0.3,0.,0.3,0.,0.,0.,
0.2,0.2,0.,0.]],
    "laim": [[4.,4.5,0.,0.,2.,0.,0.,0.2,0.3,0.4,0.2,0.,0.,0.2,0.,0.,0.,
1.,0.6,0.,0.],
[4.,4.5,0.,0.,2.,0.,0.,0.2,0.3,0.5,0.3,0.,0.,0.3,0.,0.,0.,
1.,0.6,0.,0.],
[4.,4.5,0.,0.3,2.2,0.3,0.2,0.4,0.5,0.6,0.3,0.,0.,0.3,0.,0.,0.,
1.1,0.7,0.,0.],
[4.,4.5,0.6,1.2,2.6,0.9,0.6,1.,0.8,0.7,0.5,0.,0.,0.4,0.,0.,0.,
1.3,0.8,0.,0.],
[4.,4.5,1.2,3.,3.5,2.2,1.5,2.4,1.8,1.2,1.5,1.,0.,1.1,0.,0.,0.,
1.7,1.2,0.,0.],
[4.,4.5,2.,4.7,4.3,3.5,2.3,4.1,3.6,3.,2.9,2.,0.,2.5,0.,0.,0.,
2.1,1.8,0.,0.],
[4.,4.5,2.6,4.5,4.3,3.5,2.3,4.1,3.8,3.5,3.5,3.,0.,3.2,0.,0.,0.,
2.1,1.8,0.,0.],
[4.,4.5,1.7,3.4,3.7,2.5,1.7,2.7,2.1,1.5,2.7,3.,0.,2.2,0.,0.,0.,
1.8,1.3,0.,0.],
[4.,4.5,1.,1.2,2.6,0.9,0.6,1.,0.9,0.7,1.2,1.5,0.,1.1,0.,0.,0.,
1.3,0.8,0.,0.],
[4.,4.5,0.5,0.3,2.2,0.3,0.2,0.4,0.5,0.6,0.3,0.,0.,0.3,0.,0.,0.,
1.1,0.7,0.,0.],
[4.,4.5,0.2,0.,2.,0.,0.,0.2,0.3,0.5,0.3,0.,0.,0.3,0.,0.,0.,
1.,0.6,0.,0.],
[4.,4.5,0.,0.,2.,0.,0.,0.2,0.3,0.4,0.2,0.,0.,0.2,0.,0.,0.,
1.,0.6,0.,0.]],
    "isurban": 13,
    "iswater": 17,
    "isbarren": 16,
    "isice": 15,
    "iscrop": 12,
    "eblforest": 2,
}

_RAD = {
    "albsat_vis": [0.15,0.11,0.1,0.09,0.08,0.07,0.06,0.05],
    "albsat_nir": [0.3,0.22,0.2,0.18,0.16,0.14,0.12,0.1],
    "albdry_vis": [0.27,0.22,0.2,0.18,0.16,0.14,0.12,0.1],
    "albdry_nir": [0.54,0.44,0.4,0.36,0.32,0.28,0.24,0.2],
    "albice": [0.8,0.55],
    "alblak": [0.6,0.4],
    "omegas": [0.8,0.4],
    "betads": 0.5,
    "betais": 0.5,
    "eg": [0.97,0.98],
}

_GLOBAL = {
    "co2": 0.000395,
    "o2": 0.209,
    "timean": 10.5,
    "fsatmx": 0.38,
    "z0sno": 0.002,
    "ssi": 0.03,
    "snow_ret_fac": 5e-05,
    "snow_emis": 0.95,
    "swemx": 1.0,
    "tau0": 1000000.0,
    "grain_growth": 5000.0,
    "extra_growth": 10.0,
    "dirt_soot": 0.3,
    "bats_cosz": 2.0,
    "bats_vis_new": 0.95,
    "bats_nir_new": 0.65,
    "bats_vis_age": 0.2,
    "bats_nir_age": 0.5,
    "bats_vis_dir": 0.4,
    "bats_nir_dir": 0.4,
    "rsurf_snow": 50.0,
    "rsurf_exp": 5.0,
}

_VEG_KEYS = [k for k in _MODIS if k not in
             ("isurban", "iswater", "isbarren", "isice", "iscrop",
              "eblforest", "saim", "laim")]


def load_mp_tables(run_dir: str = ".",
                   lu_categories: str = "MODIFIED_IGBP_MODIS_NOAH"):
    """Copy of icar_tpu/physics/noahmp_params.py load_mp_tables.

    Veg/rad/global tables as numpy arrays; MPTABLE.TBL in run_dir
    overrides the embedded MODIS defaults (read_mp_veg_parameters etc.,
    noahmp_tables.f90)."""
    modis, rad, glb = dict(_MODIS), dict(_RAD), dict(_GLOBAL)
    path = os.path.join(run_dir, "MPTABLE.TBL")
    if os.path.exists(path):
        nml = read_namelist(path)
        group = ("noahmp_usgs_parameters" if lu_categories.upper() == "USGS"
                 else "noahmp_modis_parameters")
        src = nml.get(group, {})
        months = ["jan", "feb", "mar", "apr", "may", "jun",
                  "jul", "aug", "sep", "oct", "nov", "dec"]
        for k in list(modis):
            if k in ("saim", "laim"):
                rows = [src.get(f"{k[:3]}_{m}") for m in months]
                if all(r is not None for r in rows):
                    modis[k] = np.asarray(rows)
            elif k in src:
                modis[k] = src[k]
        rad.update({k: v for k, v in
                    nml.get("noahmp_rad_parameters", {}).items()})
        glb.update({k: v for k, v in
                    nml.get("noahmp_global_parameters", {}).items()})

    t = SimpleNamespace()
    for k in _VEG_KEYS:
        t.__dict__[k] = np.asarray(modis[k], np.float32)
    t.saim = np.asarray(modis["saim"], np.float32)   # (12, nveg)
    t.laim = np.asarray(modis["laim"], np.float32)
    for k in ("isurban", "iswater", "isbarren", "isice", "iscrop",
              "eblforest"):
        t.__dict__[k] = int(modis[k])
    for k, v in rad.items():
        t.__dict__[k] = (np.asarray(v, np.float32)
                         if isinstance(v, (list, tuple)) else float(v))
    for k, v in glb.items():
        t.__dict__[k] = float(v)
    t.nveg = len(t.ch2op)
    return t


_GLOBAL_KEYS = ("co2", "o2", "timean", "fsatmx", "z0sno", "ssi",
                "snow_ret_fac", "snow_emis", "swemx", "tau0",
                "grain_growth", "extra_growth", "dirt_soot", "bats_cosz",
                "bats_vis_new", "bats_nir_new", "bats_vis_age",
                "bats_nir_age", "bats_vis_dir", "bats_nir_dir",
                "rsurf_snow", "rsurf_exp")


def resolve_params(tables, noah_tables, vegtype, soiltype, slopetype=1):
    """Per-cell parameter namespace for ICAR's fixed option set (no crop,
    no irrigation, no urban physics), on the device of ``vegtype``.

    vegtype/soiltype are (ny, nx) integer tensors (1-based categories);
    returns (ny, nx) float32 tensors (``saim``/``laim`` (12, ny, nx), the
    two-band leaf and stem optics (2, ny, nx), ``nroot`` int32) and
    scalars, as the JAX package's. Soil properties are uniform over the 4
    layers (iopt_soil = 1)."""
    t = tables
    nt = noah_tables
    dev = vegtype.device
    vi = torch.clamp(vegtype.long(), 1, t.nveg) - 1
    si = torch.clamp(soiltype.long(), 1, nt.n_soil) - 1

    def table(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    p = SimpleNamespace()
    for k in _VEG_KEYS:
        p.__dict__[k] = table(t.__dict__[k])[vi]
    p.saim = table(t.saim)[:, vi]      # (12, ny, nx)
    p.laim = table(t.laim)[:, vi]
    p.nroot = p.nroot.to(torch.int32)
    # two-band leaf/stem optical properties as (2, ny, nx)
    p.rhol = torch.stack([p.rhol_vis, p.rhol_nir])
    p.rhos = torch.stack([p.rhos_vis, p.rhos_nir])
    p.taul = torch.stack([p.taul_vis, p.taul_nir])
    p.taus = torch.stack([p.taus_vis, p.taus_nir])
    p.rsmin = p.rs

    # radiation (soilcolor fixed at 4)
    p.albsat = torch.stack([
        torch.full_like(p.ch2op, float(t.albsat_vis[SOILCOLOR - 1])),
        torch.full_like(p.ch2op, float(t.albsat_nir[SOILCOLOR - 1]))])
    p.albdry = torch.stack([
        torch.full_like(p.ch2op, float(t.albdry_vis[SOILCOLOR - 1])),
        torch.full_like(p.ch2op, float(t.albdry_nir[SOILCOLOR - 1]))])
    p.albice = np.asarray(t.albice, np.float32)
    p.alblak = np.asarray(t.alblak, np.float32)
    p.omegas = np.asarray(t.omegas, np.float32)
    p.betads = float(t.betads)
    p.betais = float(t.betais)
    p.eg = np.asarray(t.eg, np.float32)      # (soil, lake) emissivity

    for k in _GLOBAL_KEYS:
        p.__dict__[k] = float(t.__dict__[k])

    # soil (uniform over layers, iopt_soil=1); (ny, nx) each
    p.bexp = table(nt.bb)[si]
    p.dksat = table(nt.satdk)[si]
    p.dwsat = table(nt.satdw)[si]
    p.psisat = table(nt.satpsi)[si]
    p.quartz = table(nt.qtz)[si]
    p.smcdry = table(nt.drysmc)[si]
    p.smcmax = table(nt.maxsmc)[si]
    p.smcref = table(nt.refsmc)[si]
    p.smcwlt = table(nt.wltsmc)[si]

    # GENPARM
    p.csoil = noah_params.CSOIL
    p.zbot = noah_params.ZBOT
    p.czil = noah_params.CZIL
    p.refdk = noah_params.REFDK
    p.refkdt = noah_params.REFKDT
    p.kdt = p.refkdt * p.dksat * inv(p.refdk)
    p.slope = float(noah_params.SLOPE_DATA[slopetype])
    frzfact = (p.smcmax / p.smcref) * (0.412 / 0.468)
    p.frzx = noah_params.FRZK * frzfact

    # special categories / flags
    p.isurban = t.isurban
    p.iswater = t.iswater
    p.isbarren = t.isbarren
    p.isice = t.isice
    p.eblforest = t.eblforest
    p.urban_flag = vegtype == t.isurban
    return p

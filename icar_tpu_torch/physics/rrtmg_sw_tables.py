"""Copy of icar_tpu/physics/rrtmg_sw_tables.py, kept identical by
tests/test_torch_setup.py.

RRTMG-SW k-distribution tables: loading + g-point reduction.

The reference reads per-band raw 16-g-point absorption/solar-source tables
from ``rrtmg_support/*_sw.nc`` (sw_kgb16..29, ra_rrtmg_sw.f90:11393-12360)
— external data files NOT shipped with either repository — then reduces
them from 224 to 112 g-points (rrtmg_sw_ini + cmbgb16s..29,
ra_rrtmg_sw.f90:4605-6100).  `load_sw_tables` reads the files and applies
the reduction; `synthetic_sw_tables` builds physically-shaped random
tables for machinery tests.

Band structure constants (ngc/ngn/ngb/wt) are in-source data
(swcmbdat, ra_rrtmg_sw.f90:4827-4950); nspa/nspb from rrtmg_sw_ini
(:4761-4762).
"""

from __future__ import annotations

import os

import numpy as np

NBANDS = 14             # SW bands 16..29 -> ibm = 1..14
MG = 16                 # original g-points per band
NGPTSW = 112            # total reduced g-points

# reduced g-points per band (ngc, swcmbdat :4851)
NGC = np.array([6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12])
NGS = np.cumsum(NGC)
# original g-points combined per reduced g-point (ngn, :4880)
NGN = [2, 2, 2, 2, 4, 4,                              # band 16
       1, 1, 1, 1, 1, 2, 1, 2, 1, 2, 1, 2,            # band 17
       1, 1, 1, 1, 2, 2, 4, 4,                        # band 18
       1, 1, 1, 1, 2, 2, 4, 4,                        # band 19
       1, 1, 1, 1, 1, 1, 1, 1, 2, 6,                  # band 20
       1, 1, 1, 1, 1, 1, 1, 1, 2, 6,                  # band 21
       8, 8,                                          # band 22
       2, 2, 1, 1, 1, 1, 1, 1, 2, 4,                  # band 23
       2, 2, 2, 2, 2, 2, 2, 2,                        # band 24
       1, 1, 2, 2, 4, 6,                              # band 25
       1, 1, 2, 2, 4, 6,                              # band 26
       1, 1, 1, 1, 1, 1, 4, 6,                        # band 27
       1, 1, 2, 2, 4, 6,                              # band 28
       1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1]            # band 29
# band (1..14) for each reduced g-point
NGB = np.concatenate([np.full(NGC[b], b + 1) for b in range(NBANDS)])
# lower/upper reference-atmosphere bins per band (rrtmg_sw_ini :4761)
NSPA = np.array([9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1])
NSPB = np.array([1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1])
# 16-point quadrature weights (swcmbdat :4941; same RRTM weights as LW)
WT = np.array([0.1527534276, 0.1491729617, 0.1420961469, 0.1316886544,
               0.1181945205, 0.1019300893, 0.0832767040, 0.0626720116,
               0.0424925000, 0.0046269894, 0.0038279891, 0.0030260086,
               0.0022199750, 0.0014140010, 0.0005330000, 0.0000750000])

# band wavenumber upper limits (wavenum2, swdatinit) — used by the
# Ebert-Curry (iceflag=1) cloud optics regime selection
WAVENUM2 = np.array([3250., 4000., 4650., 5150., 6150., 7700., 8050.,
                     12850., 16000., 22650., 29000., 38000., 50000.,
                     2600.])

# bands with no upper-atmosphere k-table (23, 25, 26)
NO_KB = {8, 10, 11}
# bands with no self/foreign continuum (25, 26, 27, 28)
NO_SELFFOR = {10, 11, 12, 13}
# forref temperature-row count per band (cmbgb loops)
NFORREF = {1: 3, 2: 4, 3: 3, 4: 3, 5: 4, 6: 4, 7: 3, 8: 3, 9: 3, 14: 4}
# sfluxref eta dimension per band: 9 (lower js), 5 (upper js) or 1
SFLUX_ETA = {2: 5, 3: 9, 4: 9, 6: 9, 7: 9, 9: 9, 13: 5}

# per-band scalar/extra arrays read alongside ka/kb (see manifest in
# sw_kgb16..29):  name -> 'scalar' | 'g' (per-g, rwgt-reduced) |
# 'g9' (per-g x 9 eta, rwgt-reduced)
EXTRAS = {
    1: {"rayl": "scalar", "strrat1": "scalar", "layreffr": "scalar"},
    2: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    3: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    4: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    5: {"rayl": "scalar", "layreffr": "scalar", "absch4o": "g"},
    6: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    7: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    8: {"raylo": "g", "givfac": "scalar", "layreffr": "scalar"},
    9: {"raylao": "g9", "raylbo": "g", "abso3ao": "g", "abso3bo": "g",
        "strrat": "scalar", "layreffr": "scalar"},
    10: {"raylo": "g", "abso3ao": "g", "abso3bo": "g",
         "layreffr": "scalar"},
    11: {"raylo": "g"},
    12: {"raylo": "g", "layreffr": "scalar", "scalekur": "scalar"},
    13: {"rayl": "scalar", "strrat": "scalar", "layreffr": "scalar"},
    14: {"rayl": "scalar", "absh2oo": "g", "absco2o": "g",
         "layreffr": "scalar"},
}


def _rwgt():
    """Per-original-g reduction weights (rrtmg_sw_ini,
    ra_rrtmg_sw.f90:4680-4710)."""
    rw = np.ones(NBANDS * MG)
    igc_global = 0
    for b in range(NBANDS):
        if NGC[b] < MG:
            wtsm, ipr = [], 0
            for igc in range(NGC[b]):
                n = NGN[igc_global + igc]
                wtsm.append(WT[ipr:ipr + n].sum())
                ipr += n
            ipr = 0
            for igc in range(NGC[b]):
                n = NGN[igc_global + igc]
                for _ in range(n):
                    rw[b * MG + ipr] = WT[ipr] / wtsm[igc]
                    ipr += 1
        igc_global += NGC[b]
    return rw


RWGT = _rwgt()


def _segments(band):
    igc0 = int(np.sum(NGC[:band - 1]))
    segs, ipr = [], 0
    for igc in range(NGC[band - 1]):
        n = NGN[igc0 + igc]
        segs.append((ipr, n))
        ipr += n
    return segs


def reduce_k(arr, band):
    """Weighted combination along the LAST axis (original 16 g-points)."""
    segs = _segments(band)
    rw = RWGT[(band - 1) * MG:band * MG]
    out = [np.tensordot(arr[..., s:s + n], rw[s:s + n], axes=(-1, 0))
           for (s, n) in segs]
    return np.stack(out, axis=-1)


def reduce_f(arr, band):
    """Plain sums (solar source sfluxref; cmbgbNN sumf loops)."""
    segs = _segments(band)
    out = [arr[..., s:s + n].sum(axis=-1) for (s, n) in segs]
    return np.stack(out, axis=-1)


def _read_nc_var(path, name):
    """Read one variable and return it in FORTRAN declaration order.

    The reference's io_read{1,2,3,4}d allocates its target with the
    file's dimensions in Fortran order (io_routines.f90:407), so the
    file's C/numpy layout is the REVERSE of the Fortran declaration
    (e.g. kao(9,5,13,16) is stored as a (16,13,5,9) variable). Reversing
    the axes here recovers the declaration order the flatteners below
    index by. Contract enforced against reference-shaped fixtures from
    tools/make_rrtmg_fixtures.py in tests/test_rrtmg_fixtures.py."""
    try:
        from scipy.io import netcdf_file
        with netcdf_file(path, mmap=False) as f:
            arr = np.array(f.variables[name].data)
    except Exception:
        import h5py
        with h5py.File(path, "r") as f:
            arr = np.array(f[name])
    return arr.transpose(tuple(reversed(range(arr.ndim))))


def _flatten_ka(kao, nsp):
    """ka(js, jt, jp, g) -> absa(flat, g): ind = ((jp-1)*5+(jt-1))*nsp+js."""
    if nsp == 1:
        jtn, jpn, g = kao.shape
        return kao.transpose(1, 0, 2).reshape(jpn * jtn, g)
    js, jtn, jpn, g = kao.shape
    return kao.transpose(2, 1, 0, 3).reshape(jpn * jtn * js, g)


def _flatten_kb(kbo, nsp):
    if nsp <= 1:
        jtn, jpn, g = kbo.shape
        return kbo.transpose(1, 0, 2).reshape(jpn * jtn, g)
    js, jtn, jpn, g = kbo.shape
    return kbo.transpose(2, 1, 0, 3).reshape(jpn * jtn * js, g)


def build_band(t_raw, band):
    """Reduce + flatten one SW band (1-based ibm index, Fortran band+15)."""
    out = {}
    nspa, nspb = NSPA[band - 1], NSPB[band - 1]
    if "kao" in t_raw:
        out["absa"] = _flatten_ka(reduce_k(t_raw["kao"], band),
                                  max(nspa, 1))
    if "kbo" in t_raw:
        out["absb"] = _flatten_kb(reduce_k(t_raw["kbo"], band),
                                  max(nspb, 1))
    if "selfrefo" in t_raw:
        out["selfref"] = reduce_k(t_raw["selfrefo"], band)
    if "forrefo" in t_raw:
        out["forref"] = reduce_k(t_raw["forrefo"], band)
    sf = t_raw["sfluxrefo"]
    # sfluxrefo is (16,) or (16, neta); reduce along the g axis
    if sf.ndim == 2:
        if sf.shape[0] != MG:          # stored (neta, 16)
            sf = sf.T
        out["sfluxref"] = reduce_f(sf.T, band).T
    else:
        out["sfluxref"] = reduce_f(sf, band)
    for name, kind in EXTRAS.get(band, {}).items():
        if name not in t_raw:
            continue
        key = name[:-1] if name.endswith("o") and kind != "scalar" else name
        if kind == "scalar":
            out[name] = float(np.asarray(t_raw[name]).reshape(-1)[0])
        elif kind == "g":
            out[key] = reduce_k(t_raw[name], band)
        elif kind == "g9":
            out[key] = reduce_k(t_raw[name].T, band).T \
                if t_raw[name].ndim == 2 else reduce_k(t_raw[name], band)
    return out


def _band_files(band):
    """File-variable manifest for one band (sw_kgbNN read list)."""
    fb = band + 15
    names = ["sfluxrefo"]
    if band != 11:
        # band 26 has no gaseous absorption at all: only Rayleigh +
        # solar source are read (sw_kgb26, ra_rrtmg_sw.f90:12140-12150)
        names.append("kao")
    if band not in NO_KB:
        names.append("kbo")
    if band not in NO_SELFFOR:
        names += ["selfrefo", "forrefo"]
    names += list(EXTRAS.get(band, {}).keys())
    return {n: f"{n}_{fb}_sw.nc" for n in names}


def load_sw_tables(support_dir="rrtmg_support"):
    """All 14 bands (list indexed ibm-1), reduced; raises on missing
    files."""
    bands = []
    for b in range(1, NBANDS + 1):
        t_raw = {}
        for name, fn in _band_files(b).items():
            t_raw[name] = _read_nc_var(os.path.join(support_dir, fn), name)
        bands.append(build_band(t_raw, b))
    return bands


# --------------------------------------------------------------------------
# synthetic tables for machinery tests
# --------------------------------------------------------------------------

def synthetic_sw_tables(seed=1, k_scale=1e-5):
    """Physically-shaped random SW tables.  Solar source magnitudes sum to
    roughly the solar constant, and k magnitudes are chosen so a standard
    column is optically thin-to-moderate (clear-sky transmission well
    above zero), so end-to-end fluxes are plausible."""
    rng = np.random.RandomState(seed)
    # apportion ~1368 W/m2 over the 112 g-points
    frac = rng.dirichlet(np.ones(NGPTSW)) * 1368.22
    bands = []
    g0 = 0
    for b in range(1, NBANDS + 1):
        ng = NGC[b - 1]
        nspa, nspb = NSPA[b - 1], NSPB[b - 1]
        t = {}
        if b != 11:
            # band 26 has no gaseous absorption tables (sw_kgb26)
            t["absa"] = rng.gamma(
                1.0, k_scale,
                (13 * 5 * max(nspa, 1), ng)).astype(np.float32)
        if b not in NO_KB:
            t["absb"] = rng.gamma(
                1.0, k_scale, (47 * 5 * max(nspb, 1), ng)).astype(np.float32)
        if b not in NO_SELFFOR:
            t["selfref"] = rng.gamma(1.0, k_scale, (10, ng)).astype(
                np.float32)
            t["forref"] = rng.gamma(1.0, k_scale,
                                    (NFORREF[b], ng)).astype(np.float32)
        neta = SFLUX_ETA.get(b)
        sf = frac[g0:g0 + ng].astype(np.float32)
        t["sfluxref"] = (np.repeat(sf[:, None], neta, 1) if neta
                         else sf)
        ex = EXTRAS.get(b, {})
        for name, kind in ex.items():
            key = name[:-1] if name.endswith("o") and kind != "scalar" \
                else name
            if kind == "scalar":
                if name == "layreffr":
                    t[name] = 30.0 if b in (1, 2, 12, 13, 14) else 6.0
                elif name in ("strrat", "strrat1"):
                    t[name] = float(rng.gamma(2.0, 1.0))
                elif name == "rayl":
                    t[name] = 1e-9
                elif name == "givfac":
                    t[name] = 1.0
                elif name == "scalekur":
                    t[name] = 50.15 / 48.37
            elif kind == "g":
                t[key] = (np.full(ng, 1e-9, np.float32) if "rayl" in name
                          else rng.gamma(1.0, 1e-4, ng).astype(np.float32))
            elif kind == "g9":
                t[key] = np.full((ng, 9), 1e-9, np.float32)
        g0 += ng
        bands.append(t)
    return bands

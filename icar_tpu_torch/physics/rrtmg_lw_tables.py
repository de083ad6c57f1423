"""Copy of icar_tpu/physics/rrtmg_lw_tables.py, kept identical by
tests/test_torch_setup.py.

RRTMG-LW k-distribution tables: loading + g-point reduction.

The reference reads per-band raw 256-g-point absorption tables from
``rrtmg_support/*.nc`` (lw_kgb01..16, ra_rrtmg_lw.f90:12950-13970) — files
distributed with WRF/ICAR data, NOT shipped in the repository — then
reduces them to 140 g-points (rrtmg_lw_ini + cmbgb1..16,
ra_rrtmg_lw.f90:7930-8970).  This module does the same: `load_lw_tables`
reads the NetCDF files (scipy classic reader with an h5py fallback) and
applies the reduction; `synthetic_lw_tables` builds physically-shaped
random tables so the scheme's machinery can be exercised in tests without
the data files.

Band structure constants (g-point counts, combination maps, quadrature
weights) are in-source data (lwcmbdat, ra_rrtmg_lw.f90:8180-8237).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

NBANDS = 16
MG = 16                 # original g-points per band
NGPTLW = 140            # total reduced g-points

# reduced g-points per band (ngc, lwcmbdat)
NGC = np.array([10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2])
NGS = np.cumsum(NGC)    # cumulative (1-based end index per band)
# number of original g-points combined into each reduced g-point (ngn)
NGN = [1, 1, 2, 2, 2, 2, 2, 2, 1, 1,
       1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 3,
       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
       2, 2, 2, 2, 2, 2, 2, 2,
       2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
       2, 2, 2, 2, 2, 2, 2, 2,
       1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
       2, 2, 2, 2, 4, 4,
       1, 1, 2, 2, 2, 2, 3, 3,
       1, 1, 1, 1, 2, 2, 4, 4,
       3, 3, 4, 6,
       8, 8,
       8, 8,
       4, 12]
# band index (1-based) for each reduced g-point
NGB = np.concatenate([np.full(NGC[b], b + 1) for b in range(NBANDS)])
# number of lower/upper reference species bins per band
NSPA = np.array([1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9])
NSPB = np.array([1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0])
# original 16-point quadrature weights (lwcmbdat :8231)
WT = np.array([0.1527534276, 0.1491729617, 0.1420961469, 0.1316886544,
               0.1181945205, 0.1019300893, 0.0832767040, 0.0626720116,
               0.0424925000, 0.0046269894, 0.0038279891, 0.0030260086,
               0.0022199750, 0.0014140010, 0.0005330000, 0.0000750000])

# LW band widths (lwdatinit :8071)
DELWAVE = np.array([340., 150., 130., 70., 120., 160., 100., 100., 210.,
                    90., 320., 280., 170., 130., 220., 650.])

# minor-gas table inventory per band: name -> shape kind
#   'k2'  : (19, g)      temperature x g  (no eta dimension)
#   'k3'  : (9, 19, g)   eta x temperature x g
# entries: band -> list of (array name, kind, applies to lower/upper)
MINOR_TABLES = {
    1: [("ka_mn2", "k2"), ("kb_mn2", "k2")],
    3: [("ka_mn2o", "k3"), ("kb_mn2o", "k3b")],
    5: [("ka_mo3", "k3"), ("ccl4", "g")],
    6: [("ka_mco2", "k2"), ("cfc11adj", "g"), ("cfc12", "g")],
    7: [("ka_mco2", "k3"), ("kb_mco2", "k2")],
    8: [("ka_mco2", "k2"), ("ka_mo3", "k2"), ("ka_mn2o", "k2"),
        ("kb_mco2", "k2"), ("kb_mn2o", "k2"), ("cfc12", "g"),
        ("cfc22adj", "g")],
    9: [("ka_mn2o", "k3"), ("kb_mn2o", "k2")],
    11: [("ka_mo2", "k2"), ("kb_mo2", "k2")],
    13: [("ka_mco2", "k3"), ("ka_mco", "k3"), ("kb_mo3", "k2")],
    15: [("ka_mn2", "k3")],
    16: [],
}

# bands with eta-dependent planck fractions in lower (fracrefa (g, 9))
FRACA_ETA = {3, 4, 5, 7, 9, 12, 13, 15, 16}
# bands with eta-dependent planck fractions in upper (fracrefb (g, 5))
FRACB_ETA = {3, 4, 5}
# bands with NO upper-atmosphere absorption table (band 16 HAS one, but
# its upper index collapses to row 1 because nspb(16)=0 — see taumol)
NO_KB = {6, 12, 13, 15}


def _rwgt():
    """Per-original-g-point reduction weights (rrtmg_lw_ini,
    ra_rrtmg_lw.f90:7995-8020)."""
    rw = np.ones(NBANDS * MG)
    seg = 0
    igc_global = 0
    for b in range(NBANDS):
        if NGC[b] < MG:
            # wtsm per reduced g-point of this band
            wtsm = []
            ipr = 0
            for igc in range(NGC[b]):
                n = NGN[igc_global + igc]
                wtsm.append(WT[ipr:ipr + n].sum())
                ipr += n
            # map original g -> its reduced g
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
    """(start, n) original-g segments for each reduced g of `band`
    (1-based band)."""
    igc0 = int(np.sum(NGC[:band - 1]))
    segs = []
    ipr = 0
    for igc in range(NGC[band - 1]):
        n = NGN[igc0 + igc]
        segs.append((ipr, n))
        ipr += n
    return segs


def reduce_k(arr, band):
    """Weighted g-point combination of a k-table whose LAST axis is the
    original 16 g-points (cmbgbNN: sumk += kao(..,iprsm)*rwgt(iprsm))."""
    segs = _segments(band)
    rw = RWGT[(band - 1) * MG:band * MG]
    out = []
    for (s, n) in segs:
        w = rw[s:s + n]
        out.append(np.tensordot(arr[..., s:s + n], w, axes=(-1, 0)))
    return np.stack(out, axis=-1)


def reduce_f(arr, band):
    """Plain-sum combination for Planck fractions (sumf += fracrefao)."""
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


def _band_tables_raw(support_dir, band):
    """Raw per-band arrays exactly as lw_kgbNN reads them."""
    def rd(name):
        return _read_nc_var(os.path.join(support_dir, f"{name}_{band}.nc"),
                            name)
    t = {}
    t["fracrefao"] = rd("fracrefao")
    # every band except 6 (reuses fracrefa aloft), 12 and 15 (no upper
    # absorption at all) has upper-atmosphere Planck fractions
    if band not in (6, 12, 15):
        t["fracrefbo"] = rd("fracrefbo")
    t["kao"] = rd("kao")
    if band not in NO_KB:
        t["kbo"] = rd("kbo")
    t["selfrefo"] = rd("selfrefo")
    t["forrefo"] = rd("forrefo")
    for name, kind in MINOR_TABLES.get(band, []):
        if kind == "g":
            # cross-section species: ccl4o_5.nc etc. (lw_kgb05 :13320+)
            t[name + "o"] = rd(name + "o")
        else:
            # minor-gas k tables: the reference names put the 'o' after
            # ka/kb, e.g. kao_mn2_1.nc with variable kao_mn2
            # (lw_kgb01, ra_rrtmg_lw.f90:13090-13091)
            raw = name.replace("ka_", "kao_", 1).replace("kb_", "kbo_", 1)
            t[name + "o"] = rd(raw)
    return t


def _flatten_ka(kao, nsp):
    """ka(js, jt, jp, g) -> absa(flat, g) with Fortran index
    ind = ((jp-1)*5 + (jt-1))*nsp + js (1-based)."""
    if nsp == 1:
        # kao is (5, 13, g): jt fastest within jp
        jtn, jpn, g = kao.shape
        return kao.transpose(1, 0, 2).reshape(jpn * jtn, g)
    # kao is (9, 5, 13, g)
    js, jtn, jpn, g = kao.shape
    return kao.transpose(2, 1, 0, 3).reshape(jpn * jtn * js, g)


def _flatten_kb(kbo, nsp):
    if nsp <= 1:
        jtn, jpn, g = kbo.shape      # (5, 47, g)
        return kbo.transpose(1, 0, 2).reshape(jpn * jtn, g)
    js, jtn, jpn, g = kbo.shape      # (5, 5, 47, g)
    return kbo.transpose(2, 1, 0, 3).reshape(jpn * jtn * js, g)


def build_band(t_raw, band):
    """Reduce + flatten one band's tables into the runtime layout."""
    out = {}
    nspa, nspb = NSPA[band - 1], NSPB[band - 1]
    out["absa"] = _flatten_ka(reduce_k(t_raw["kao"], band), nspa)
    if "kbo" in t_raw and t_raw["kbo"] is not None:
        out["absb"] = _flatten_kb(reduce_k(t_raw["kbo"], band),
                                  max(nspb, 1))
    out["selfref"] = reduce_k(t_raw["selfrefo"], band)
    out["forref"] = reduce_k(t_raw["forrefo"], band)
    fa = t_raw["fracrefao"]
    out["fracrefa"] = (reduce_f(fa.T, band).T if fa.ndim == 2
                       else reduce_f(fa, band))
    fb = t_raw.get("fracrefbo")
    if fb is not None:
        out["fracrefb"] = (reduce_f(fb.T, band).T if fb.ndim == 2
                           else reduce_f(fb, band))
    for name, kind in MINOR_TABLES.get(band, []):
        raw = t_raw.get(name + "o")
        if raw is None:
            continue
        if kind == "g":
            out[name] = reduce_k(raw, band)
        else:
            out[name] = reduce_k(raw, band)
    return out


def load_lw_tables(support_dir="rrtmg_support"):
    """All 16 bands, reduced, as a list indexed by band-1; raises
    FileNotFoundError when the data files are absent."""
    bands = []
    for b in range(1, NBANDS + 1):
        bands.append(build_band(_band_tables_raw(support_dir, b), b))
    return bands


# --------------------------------------------------------------------------
# synthetic tables for machinery tests (no data files required)
# --------------------------------------------------------------------------

def synthetic_lw_tables(seed=0, k_scale=1e-2):
    """Physically-shaped random tables: positive absorption coefficients
    with realistic magnitudes so the scheme runs end-to-end in tests."""
    rng = np.random.RandomState(seed)
    bands = []
    for b in range(1, NBANDS + 1):
        ng = NGC[b - 1]
        nspa, nspb = NSPA[b - 1], NSPB[b - 1]
        t = {}
        na = 13 * 5 * nspa
        t["absa"] = rng.gamma(1.0, k_scale, (na, ng)).astype(np.float32)
        if b not in NO_KB:
            nb = 47 * 5 * max(nspb, 1)
            t["absb"] = rng.gamma(1.0, k_scale, (nb, ng)).astype(
                np.float32)
        t["selfref"] = rng.gamma(1.0, k_scale, (10, ng)).astype(np.float32)
        t["forref"] = rng.gamma(1.0, k_scale, (4, ng)).astype(np.float32)
        if b in FRACA_ETA:
            fa = rng.dirichlet(np.ones(ng), 9).astype(np.float32)  # (9, g)
            t["fracrefa"] = fa.T  # (g, 9)
        else:
            t["fracrefa"] = rng.dirichlet(np.ones(ng)).astype(np.float32)
        if b not in NO_KB or b == 13:
            if b in FRACB_ETA:
                t["fracrefb"] = rng.dirichlet(
                    np.ones(ng), 5).astype(np.float32).T
            else:
                t["fracrefb"] = rng.dirichlet(np.ones(ng)).astype(
                    np.float32)
        for name, kind in MINOR_TABLES.get(b, []):
            if kind == "g":
                t[name] = rng.gamma(1.0, 1e-4, ng).astype(np.float32)
            elif kind == "k2":
                t[name] = rng.gamma(1.0, k_scale * 0.1,
                                    (19, ng)).astype(np.float32)
            elif kind == "k3b":   # upper-atmosphere eta has 5 bins
                t[name] = rng.gamma(1.0, k_scale * 0.1,
                                    (5, 19, ng)).astype(np.float32)
            else:   # k3
                t[name] = rng.gamma(1.0, k_scale * 0.1,
                                    (9, 19, ng)).astype(np.float32)
        bands.append(t)
    return bands

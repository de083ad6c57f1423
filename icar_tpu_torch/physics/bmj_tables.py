"""Copy of icar_tpu/physics/bmj_tables.py, kept identical by
tests/test_torch_setup.py.

Lookup tables for the Betts-Miller-Janjic convection scheme.

Host-side numpy construction of the saturation-point and moist-adiabat
tables that BMJINIT builds once at startup
(the reference ICAR source, src/physics/cu_bmj.f90:1823-2086):

- PTBL (ITB, JTB): saturation-point pressure as a function of scaled
  specific humidity (uniform grid) for each potential temperature row;
  built by cubic-spline inversion of qs(p) (natural spline, as in
  Janjic's SPLINE routine).
- TTBL (JTB, ITB): temperature along a moist adiabat as a function of
  scaled theta_e (uniform grid) for each pressure column — the coarse
  table for p < PLQ.
- TTBLQ (JTBQ, ITBQ): the fine table for p >= PLQ (lower troposphere).
- QS0/SQS, THE0/STHE, THE0Q/STHEQ: per-row base and scale factors used
  to normalize the lookup coordinates.

Tables are pure functions of physical constants, so they are built once
at import of the scheme and reused (a few ms of numpy work).
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline

# table shape/range parameters (cu_bmj.f90:45-49, 66-70)
ITB, JTB = 76, 134
ITBQ, JTBQ = 152, 440
PL, PLQ, PH = 2500.0, 70000.0, 105000.0
THL, THH, THHQ = 210.0, 365.0, 325.0
RDP = (ITB - 1.0) / (PH - PL)
RDPQ = (ITBQ - 1.0) / (PH - PLQ)
RDQ = ITB - 1.0
RDTH = (JTB - 1.0) / (THH - THL)
RDTHE = JTB - 1.0
RDTHEQ = JTBQ - 1.0

# saturation constants (mod_wrf_constants)
PQ0 = 379.90516
A2 = 17.2693882
A3 = 273.16
A4 = 35.86
ELIWV = 2.683e6
CP = 1004.6
RD = 287.0
CAPA = RD / CP
ELOCP = ELIWV / CP
_EPS = 1e-9


def _qs_theta(th, p):
    """qs on a (theta, p) grid with the denominator guard
    (cu_bmj.f90:1914-1920)."""
    ape = (1.0e5 / p) ** CAPA
    denom = th - A4 * ape
    qs = np.where(denom > _EPS,
                  PQ0 / p * np.exp(A2 * (th - A3 * ape)
                                   / np.where(denom > _EPS, denom, 1.0)),
                  0.0)
    return qs


def _monotonic_scaled(vals):
    """Normalize to [0, 1] with strictly-increasing enforcement
    (cu_bmj.f90:1933-1940). Returns (scaled, base, scale)."""
    base = vals[0]
    scale = vals[-1] - vals[0]
    s = (vals - base) / scale
    s[0] = 0.0
    s[-1] = 1.0
    for i in range(1, len(s) - 1):
        if s[i] - s[i - 1] < _EPS:
            s[i] = s[i - 1] + _EPS
    return s, base, scale


def _spline_resample(x_old, y_old, x_new):
    """Natural cubic spline through (x_old, y_old) evaluated at x_new
    (SPLINE, cu_bmj.f90:2090-2199)."""
    cs = CubicSpline(x_old, y_old, bc_type="natural")
    return cs(np.clip(x_new, x_old[0], x_old[-1]))


def build_tables():
    """Build all six table sets; returns a dict of numpy arrays."""
    # ---- coarse saturation-point table PTBL + QS0/SQS ------------------
    th_rows = np.linspace(THL, THH, JTB)
    p_cols = np.linspace(PL, PH, ITB)
    qs0 = np.zeros(JTB)
    sqs = np.zeros(JTB)
    ptbl = np.zeros((ITB, JTB))
    qs_new = np.linspace(0.0, 1.0, ITB)
    for j, th in enumerate(th_rows):
        qs_old = _qs_theta(th, p_cols)
        s, base, scale = _monotonic_scaled(qs_old.copy())
        qs0[j] = base
        sqs[j] = scale
        ptbl[:, j] = _spline_resample(s, p_cols, qs_new)

    # ---- coarse moist-adiabat table TTBL + THE0/STHE -------------------
    the0 = np.zeros(ITB)
    sthe = np.zeros(ITB)
    ttbl = np.zeros((JTB, ITB))
    the_new = np.linspace(0.0, 1.0, JTB)
    for i, p in enumerate(p_cols):
        ape = (1.0e5 / p) ** CAPA
        qs = _qs_theta(th_rows, p)
        t_old = th_rows / ape
        the_old = th_rows * np.exp(ELOCP * qs / t_old)
        s, base, scale = _monotonic_scaled(the_old.copy())
        the0[i] = base
        sthe[i] = scale
        ttbl[:, i] = _spline_resample(s, t_old, the_new)

    # ---- fine moist-adiabat table TTBLQ + THE0Q/STHEQ ------------------
    thq_rows = np.linspace(THL, THHQ, JTBQ)
    pq_cols = np.linspace(PLQ, PH, ITBQ)
    the0q = np.zeros(ITBQ)
    stheq = np.zeros(ITBQ)
    ttblq = np.zeros((JTBQ, ITBQ))
    theq_new = np.linspace(0.0, 1.0, JTBQ)
    for i, p in enumerate(pq_cols):
        ape = (1.0e5 / p) ** CAPA
        qs = _qs_theta(thq_rows, p)
        t_old = thq_rows / ape
        the_old = thq_rows * np.exp(ELOCP * qs / t_old)
        s, base, scale = _monotonic_scaled(the_old.copy())
        the0q[i] = base
        stheq[i] = scale
        ttblq[:, i] = _spline_resample(s, t_old, theq_new)

    return {
        "ptbl": ptbl.astype(np.float32),
        "qs0": qs0.astype(np.float32), "sqs": sqs.astype(np.float32),
        "ttbl": ttbl.astype(np.float32),
        "the0": the0.astype(np.float32), "sthe": sthe.astype(np.float32),
        "ttblq": ttblq.astype(np.float32),
        "the0q": the0q.astype(np.float32),
        "stheq": stheq.astype(np.float32),
    }


_CACHE = None


def get_tables():
    global _CACHE
    if _CACHE is None:
        _CACHE = build_tables()
    return _CACHE

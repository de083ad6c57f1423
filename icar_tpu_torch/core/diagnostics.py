"""Diagnostic fields and the CFL timestep (icar_tpu/core/diagnostics.py).

Same formulas and the same float32 operation order as the JAX package, so
``compute_dt`` gives the same bits and the substep count matches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import pointwise as pw


# float32 constants as the JAX package's compiled step holds them: XLA
# rewrites p / P0 into p * (1/P0), and its float32 power is correctly
# rounded in nearly every cell, which a float64 power rounded to float32
# reproduces. The golden ridge trajectory flips on a one-ulp change of the
# Exner function (see PERF.md), so these bits matter.
_INV_P0 = float(np.float32(1.0 / C.P0))
_ROVCP = float(np.float32(C.ROVCP))


def exner_function(pressure):
    """(p/p0)^(Rd/cp) (atm_utilities.f90 exner_function), float32."""
    x = (pressure * _INV_P0).to(torch.float64)
    return pw.pow(x, _ROVCP).to(pressure.dtype)


def interface_from_mass(f):
    """Interface value below each layer: midpoint between layers, linearly
    extrapolated below the lowest (time_step.f90:88-89)."""
    bottom = f[:1] + (f[:1] - f[1:2]) / 2
    return torch.cat([bottom, (f[:-1] + f[1:]) / 2], dim=0)


def compute_iq(q, p_i):
    """Column-integrated mass of q [kg/m^2] (compute_iq,
    atm_utilities.f90:66-99), the top layer bounded by a 500 hPa cap."""
    p_above = torch.cat([p_i[1:], torch.full_like(p_i[:1], 50000.0)], dim=0)
    dp = torch.clamp(p_i - p_above, min=0.0)
    return level_sum(q * dp) / C.GRAVITY


def level_sum(x):
    """``x`` summed over its first axis by a pairwise tree fixed by that
    axis's length, each level of it one elementwise add, so that a
    column's sum has the same bits whatever the other axes' sizes: a
    block of a sharded domain sums as the whole domain does (torch.sum's
    order on the CPU depends on a column's place in its vectorised loop)."""
    while x.shape[0] > 1:
        n = x.shape[0] // 2 * 2
        pairs = x[0:n:2] + x[1:n:2]
        x = torch.cat([pairs, x[n:]]) if n < x.shape[0] else pairs
    return x[0]


def compute_ivt(qv, u_mass, v_mass, p_i):
    """Column-integrated vapor transport (compute_ivt,
    atm_utilities.f90:35-63)."""
    speed = torch.sqrt(u_mass ** 2 + v_mass ** 2)
    return compute_iq(qv * speed, p_i)


# the partial refreshes the substep loop may ask for (``needs``): what the
# ported physics reads that changes within an interval (density and
# temperature follow theta; with forcing, the pressure-derived fields and
# the mass-level winds follow their forcing; icar_tpu/core/step.py
# _substep_needs)
PARTIAL_FIELDS = frozenset(("density", "temperature",
                            "temperature_interface", "exner",
                            "pressure_interface", "surface_pressure",
                            "uv_mass"))


def diagnostic_update(state, geom, full: bool = True, needs=None,
                      with_w_real: bool = False, interior=None):
    """Refresh derived fields (diagnostic_update, time_step.f90:49-198).

    ``full=False`` computes only the fields physics consumes; ``full=True``
    adds the output diagnostics (integrated moisture, 10 m winds, w_real),
    and ``with_w_real`` adds w_real alone to a partial update (the
    convection reads it). ``needs``, a subset of ``PARTIAL_FIELDS``,
    refreshes only those fields, the others taken from the state (the
    general loop's per-substep refresh), with w_real when
    ``with_w_real``. ``geom`` holds torch tensors
    (``convert.geometry_to_torch``). ``interior`` (rows, columns) are the
    cells off the domain's edge ring, where w_real and the 10 m winds are
    formed: every cell but the outer ring by default, a block's
    ``mesh.Shard.interior`` for a block of a sharded domain (its inner
    edge is interior to the domain). Returns a new dict."""
    s = dict(state)
    if interior is None:
        interior = (slice(1, s["pressure"].shape[-2] - 1),
                    slice(1, s["pressure"].shape[-1] - 1))
    if needs is not None:
        unknown = set(needs) - PARTIAL_FIELDS
        if unknown:
            raise ValueError(f"partial refresh of {sorted(unknown)}: not "
                             "among PARTIAL_FIELDS")
        s = _refresh(s, needs)
        if with_w_real and "w_real" in s:
            s["w_real"] = w_real(s["w_real"], s["u"], s["v"], s["w"], geom,
                                 interior)
        return s
    p = s["pressure"]
    theta = s["potential_temperature"]
    u, v, w = s["u"], s["v"], s["w"]

    exner = exner_function(p)
    s["exner"] = exner
    p_i = interface_from_mass(p)
    s["pressure_interface"] = p_i
    temperature = theta * exner
    s["temperature"] = temperature
    s["temperature_interface"] = interface_from_mass(temperature)
    s["density"] = p / (C.RD * temperature)
    u_mass = (u[:, :, :-1] + u[:, :, 1:]) * 0.5
    v_mass = (v[:, :-1, :] + v[:, 1:, :]) * 0.5
    s["u_mass"] = u_mass
    s["v_mass"] = v_mass
    if "surface_pressure" in s:
        s["surface_pressure"] = p_i[0]

    if not full and not with_w_real:
        return s

    if "w_real" in s:
        s["w_real"] = w_real(s["w_real"], u, v, w, geom, interior)

    if not full:
        return s

    # integrated moisture diagnostics
    if "ivt" in s:
        s["ivt"] = compute_ivt(s["water_vapor"], u_mass, v_mass, p_i)
    if "iwv" in s:
        s["iwv"] = compute_iq(s["water_vapor"], p_i)
    if "iwl" in s:
        liquid = torch.zeros_like(p)
        for k in ("cloud_water", "rain_mass"):
            if k in s:
                liquid = liquid + s[k]
        s["iwl"] = compute_iq(liquid, p_i)
    if "iwi" in s:
        ice = torch.zeros_like(p)
        for k in ("cloud_ice", "snow_mass", "graupel_mass"):
            if k in s:
                ice = ice + s[k]
        s["iwi"] = compute_iq(ice, p_i)

    # 10 m winds / ustar via log-law (time_step.f90:144-161), interior cells
    if "u_10m" in s and "roughness_z0" in s:
        z0 = s["roughness_z0"]
        zlev1 = geom.z[0] - geom.terrain
        currw = C.KARMAN / pw.log(zlev1 / z0)
        lastw = pw.log(10.0 / z0) / C.KARMAN
        u10 = u_mass[0] * currw * lastw
        v10 = v_mass[0] * currw * lastw
        ust = torch.sqrt(u_mass[0] ** 2 + v_mass[0] ** 2) * currw
        # the reference fills interior cells only; edges keep their value
        for name, val in (("u_10m", u10), ("v_10m", v10), ("ustar", ust)):
            s[name] = s[name].clone()
            s[name][interior] = val[interior]
    return s


def _refresh(s, needs):
    """The fields of ``needs`` from the state's pressure, theta and winds,
    the others read from the state, in the JAX package's order."""
    p = s["pressure"]
    if "exner" in needs:
        s["exner"] = exner_function(p)
    if "pressure_interface" in needs:
        s["pressure_interface"] = interface_from_mass(p)
    temperature = s["potential_temperature"] * s["exner"]
    if "temperature" in needs:
        s["temperature"] = temperature
    if "temperature_interface" in needs:
        s["temperature_interface"] = interface_from_mass(temperature)
    if "density" in needs:
        s["density"] = p / (C.RD * temperature)
    if "uv_mass" in needs:
        u, v = s["u"], s["v"]
        s["u_mass"] = (u[:, :, :-1] + u[:, :, 1:]) * 0.5
        s["v_mass"] = (v[:, :-1, :] + v[:, 1:, :]) * 0.5
    if "surface_pressure" in needs and "surface_pressure" in s:
        s["surface_pressure"] = s["pressure_interface"][0]
    return s


def w_real(old, u, v, w, geom, interior=None):
    """The real vertical velocity at the interior cells (time_step.f90:
    163-194): the cells ``interior`` (rows, columns; every cell but the
    outer ring by default) of a mass-point field whose staggered u and v
    carry both end faces; the others keep ``old``."""
    ny, nx = w.shape[-2:]
    iy, ix = interior or (slice(1, ny - 1), slice(1, nx - 1))
    # the interior's cells and the faces around them
    fy, fx = slice(iy.start, iy.stop + 1), slice(ix.start, ix.stop + 1)
    uw = u[:, iy, fx] * geom.dzdx[:, iy, fx]
    vw = v[:, fy, ix] * geom.dzdy[:, fy, ix]
    w_below = torch.cat([torch.zeros_like(w[:1]), w[:-1]], dim=0)
    wr = ((uw[:, :, :-1] + uw[:, :, 1:]) * 0.5
          + (vw[:, :-1, :] + vw[:, 1:, :]) * 0.5
          + geom.jacobian[:, iy, ix]
          * (w_below[:, iy, ix] + w[:, iy, ix]) * 0.5)
    out = old.clone()
    out[:, iy, ix] = wr
    return out


def cfl_maxima(u, v, w, dz_levels, dx):
    """The wind maxima the CFL criterion reads, as a (4,) float32 tensor:
    the largest 3-D Courant sum max(|u| faces)/dx + max(|v| faces)/dx +
    max(|w| layer faces)/dz, and max|u|, max|v|, max|w|. The maxima of
    several blocks of one domain reduce by their elementwise maximum to
    the domain's."""
    au, av, aw = torch.abs(u), torch.abs(v), torch.abs(w)
    ufac = torch.maximum(au[:, :, :-1], au[:, :, 1:]) / dx
    vfac = torch.maximum(av[:, :-1, :], av[:, 1:, :]) / dx
    aw_below = torch.cat([aw[:1], aw[:-1]], dim=0)
    wfac = torch.maximum(aw, aw_below) / dz_levels[:, None, None]
    return torch.stack([torch.max(ufac + vfac + wfac), torch.max(au),
                        torch.max(av), torch.max(aw)])


def dt_from_maxima(m, cfl_reduction, cfl_strictness: int = 3):
    """Maximum stable dt from the CFL criterion with the reference's five
    strictness modes (compute_dt, time_step.f90:217-330), given the
    ``cfl_maxima`` of the domain. Returns a 0-d float32 tensor on their
    device."""
    sqrt3 = 3.0 ** 0.5 * 1.001
    three_d_cfl = 0.577350269

    max3d, mu, mv, mw = m[0], m[1], m[2], m[3]
    if cfl_strictness == 1:
        maxwind = torch.maximum(mu, torch.maximum(mv, mw)) * sqrt3
    elif cfl_strictness == 5:
        maxwind = mu + mv + mw
    else:
        maxwind = max3d
        if cfl_strictness == 2:
            max1d = torch.maximum(mu, torch.maximum(mv, mw))
            maxwind = torch.maximum(maxwind * three_d_cfl, max1d)
        elif cfl_strictness == 4:
            maxwind = maxwind * sqrt3

    return cfl_reduction / maxwind


def compute_dt(u, v, w, dz_levels, dx, cfl_reduction,
               cfl_strictness: int = 3):
    """Maximum stable dt from the CFL criterion (``dt_from_maxima`` of
    ``cfl_maxima``). Returns a 0-d float32 tensor on the winds' device."""
    return dt_from_maxima(cfl_maxima(u, v, w, dz_levels, dx), cfl_reduction,
                          cfl_strictness)

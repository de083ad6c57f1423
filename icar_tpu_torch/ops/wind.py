"""Wind field rotation and mass balancing (icar_tpu/ops/wind.py).

All fields are (z, y, x); u is x-staggered (nz, ny, nx+1), v is
y-staggered (nz, ny+1, nx), w sits at the top interface of each layer
(nz, ny, nx). The balance-only solver (wind=0) and the mass-conserving
acceleration (wind=2) are ported.
"""

from __future__ import annotations

import torch

from .. import constants as C

# where each unported wind solver stands in ROADMAP.md
_WIND_SLICES = {
    C.WIND_LINEAR: "Slice D (linear-theory winds)",
    C.WIND_LINEAR_ITERATIVE: "Slice D (linear-theory winds)",
    C.WIND_ITERATIVE: "Slice C (wind=3)",
}


def calc_divergence(u, v, w, jaco_u, jaco_v, jaco_w, dz, dx, jaco,
                    horz_only=False):
    """Divergence on the terrain-following grid (calc_divergence,
    wind.f90:172-228). With ``horz_only`` returns just the metric-weighted
    horizontal flux divergence (used by balance_uvw)."""
    u_met = u * jaco_u
    v_met = v * jaco_v
    div = ((u_met[:, :, 1:] - u_met[:, :, :-1])
           + (v_met[:, 1:, :] - v_met[:, :-1, :])) / dx
    if horz_only:
        return div
    w_met = w * jaco_w
    dw = torch.cat([w_met[:1], w_met[1:] - w_met[:-1]], dim=0)
    return (div + dw / dz) / jaco


def balance_uvw(u, v, jaco_u, jaco_v, jaco_w, dz, dx, jaco):
    """Solve w from the column-integrated horizontal divergence so that
    du/dx + dv/dy + dw/dz = 0 (balance_uvw, wind.f90:81-169); the
    reference's level recurrence is a cumulative sum from w=0 at the
    ground."""
    div = calc_divergence(u, v, None, jaco_u, jaco_v, jaco_w, dz, dx, jaco,
                          horz_only=True)
    w_jaco = -torch.cumsum(div * dz, dim=0)
    return w_jaco / jaco_w


def make_winds_grid_relative(u, v, sintheta, costheta):
    """Rotate staggered forcing winds into the local grid orientation
    (make_winds_grid_relative, wind.f90:236-279): destagger, rotate on the
    mass grid, restagger with the reference's edge extrapolation."""
    nx = u.shape[2] - 1
    ny = v.shape[1] - 1
    um = (u[:, :, :nx] + u[:, :, 1:]) / 2
    vm = (v[:, :ny, :] + v[:, 1:, :]) / 2
    u_rot = um * costheta - vm * sintheta
    v_rot = vm * costheta + um * sintheta
    u_new = torch.cat([
        1.5 * u_rot[:, :, :1] - 0.5 * u_rot[:, :, 1:2],
        (u_rot[:, :, :-1] + u_rot[:, :, 1:]) / 2,
        u_rot[:, :, -1:] + 0.5 * (u_rot[:, :, -2:-1] - u_rot[:, :, -3:-2])],
        dim=2)
    v_new = torch.cat([
        1.5 * v_rot[:, :1, :] - 0.5 * v_rot[:, 1:2, :],
        (v_rot[:, :-1, :] + v_rot[:, 1:, :]) / 2,
        v_rot[:, -1:, :] + 0.5 * (v_rot[:, -2:-1, :] - v_rot[:, -3:-2, :])],
        dim=1)
    return u_new, v_new


def mass_conservative_acceleration(u, v, u_accel, v_accel):
    """Terrain-ratio wind acceleration (mass_conservative_acceleration,
    wind.f90:500-510): divide by the level-compression ratio so that mass
    flux through squeezed levels is conserved."""
    return u / u_accel, v / v_accel


def update_winds(u, v, geom, windtype: int):
    """Wind solver dispatch (update_winds, wind.f90:289-369) for wind=0 and
    wind=2: returns (u, v, w) with w balancing the horizontal divergence.
    ``geom`` holds torch tensors (``convert.geometry_to_torch``)."""
    if windtype == C.WIND_CONSERVE_MASS:
        u, v = mass_conservative_acceleration(u, v, geom.zr_u, geom.zr_v)
    elif windtype != C.WIND_NONE:
        where = _WIND_SLICES.get(windtype, "ROADMAP.md")
        raise NotImplementedError(
            f"wind={windtype} is not ported yet: {where} in ROADMAP.md")
    w = balance_uvw(u, v, geom.jacobian_u, geom.jacobian_v, geom.jacobian_w,
                    geom.advection_dz, geom.dx, geom.jacobian)
    return u, v, w

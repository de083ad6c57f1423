"""Wind field rotation, mass balancing and the iterative solver
(icar_tpu/ops/wind.py).

All fields are (z, y, x); u is x-staggered (nz, ny, nx+1), v is
y-staggered (nz, ny+1, nx), w sits at the top interface of each layer
(nz, ny, nx). Every solver of the JAX package is ported: balance only
(wind=0), linear theory (wind=1, ``ops/linear_winds.py``), the
mass-conserving acceleration (wind=2), the iterative solver (wind=3),
linear theory then the iterative solver (wind=5), and flow blocking
(``ops/blocking.py``) with any of them.
"""

from __future__ import annotations

import contextlib

import torch

from .. import constants as C
from . import pointwise as pw
from .pointwise import inv

WIND_SOLVERS = (C.WIND_NONE, C.WIND_LINEAR, C.WIND_CONSERVE_MASS,
                C.WIND_ITERATIVE, C.WIND_LINEAR_ITERATIVE)


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


def iterative_winds(u, v, geom, n_iterations: int):
    """Divergence-minimizing iterative wind solver (iterative_winds,
    wind.f90:371-498): fixes w (after removing a linearly weighted share
    of the top-level w) and runs ``n_iterations + 1`` corrections that
    distribute the residual divergence onto u and v. The corrections
    divide by dx and the adjustment coefficient as products with their
    float32 reciprocals, as the JAX package's compiled loop body does (it
    also contracts some products and sums into fused multiply-adds, so the
    two agree to a few ulps an iteration)."""
    jaco_u, jaco_v, jaco_w = geom.jacobian_u, geom.jacobian_v, geom.jacobian_w
    dz, dx, jaco = geom.advection_dz, geom.dx, geom.jacobian

    # balance_uvw with the cumulative sum in the JAX package's order
    div = calc_divergence(u, v, None, jaco_u, jaco_v, jaco_w, dz, dx, jaco,
                          horz_only=True)
    w = -pw.cumsum(div * dz, 0) / jaco_w

    # remove the fraction of top-level w that grows linearly with height
    # (wind.f90:432-447)
    smooth_height = dz[0]
    for k in range(1, dz.shape[0]):
        smooth_height = smooth_height + dz[k]
    corr_factor = torch.clamp(pw.cumsum(dz, 0) / smooth_height, max=1.0)
    w = w - corr_factor * w[-1:]

    u_cor = 0.5  # wind.f90:457-458: divergence split evenly between u and v
    adj_coef = -2.0 / dx
    w_met = w * jaco_w
    dw_dz = torch.cat([w_met[:1], w_met[1:] - w_met[:-1]], dim=0) / dz
    u, v = u.clone(), v.clone()
    # the reference loop runs wind_iterations+1 times (do it=0,n)
    for _ in range(n_iterations + 1):
        u_met = u * jaco_u
        v_met = v * jaco_v
        div = ((u_met[:, :, 1:] - u_met[:, :, :-1])
               + (v_met[:, 1:, :] - v_met[:, :-1, :])) * inv(dx)
        adj = (div + dw_dz) / jaco * inv(adj_coef)
        # u(ims+2:ime, jms+1:jme-1) gets +adj(left cell) - adj(right cell)
        du = (adj[:, 1:-1, :-1] - adj[:, 1:-1, 1:]) * u_cor
        u[:, 1:-1, 2:-1] += du[:, :, 1:]
        dv = (adj[:, :-1, 1:-1] - adj[:, 1:, 1:-1]) * u_cor
        v[:, 2:-1, 1:-1] += dv[:, 1:, :]
    return u, v


def update_winds(u, v, geom, windtype: int, wind_iterations: int = 100,
                 linear_perturbation=None, blocking=None, timer=None):
    """Wind solver dispatch (update_winds, wind.f90:289-369) minus the
    rotation: returns (u, v, w) with w balancing the horizontal
    divergence. ``linear_perturbation(u, v)`` applies the linear-theory
    perturbation (wind=1 and 5), ``blocking(u, v)`` the flow-blocking one
    (the reference's commented hook, wind.f90:303-306). ``geom`` holds
    torch tensors (``convert.geometry_to_torch``); ``timer(stage)``
    brackets the blocking, the iterative solver and the balance (as
    ``time_paths.StageTimer`` does)."""
    if windtype not in WIND_SOLVERS:
        raise ValueError(f"wind={windtype} is no wind solver; the solvers "
                         f"are {WIND_SOLVERS}")
    stage = timer or (lambda name: contextlib.nullcontext())
    if windtype in (C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE) \
            and linear_perturbation is not None:
        u, v = linear_perturbation(u, v)
    if blocking is not None:
        with stage("blocking"):
            u, v = blocking(u, v)
    if windtype == C.WIND_CONSERVE_MASS:
        u, v = mass_conservative_acceleration(u, v, geom.zr_u, geom.zr_v)
    if windtype in (C.WIND_ITERATIVE, C.WIND_LINEAR_ITERATIVE):
        with stage("iterative"):
            u, v = iterative_winds(u, v, geom, wind_iterations)
    with stage("balance"):
        w = balance_uvw(u, v, geom.jacobian_u, geom.jacobian_v,
                        geom.jacobian_w, geom.advection_dz, geom.dx,
                        geom.jacobian)
    return u, v, w

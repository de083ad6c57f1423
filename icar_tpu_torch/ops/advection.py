"""Donor-cell (upwind) advection on the terrain-following staggered grid:
the plain PyTorch version of kernel K1 (icar_tpu/ops/advection.py).

Same operation order as the JAX package's jnp path (winds scaled as
``u * (dt/dx) * J_u``), which made the golden trajectory. The CUDA kernel
(``csrc/advect_upwind.cu``) computes the same update from the metric winds
``u * J_u / dx`` times dt, so the two agree to a few float32 ulp. Fields
are (z, y, x); a stacked (nq, nz, ny, nx) species array advects in one
call, with (nz, ...) winds or per-species (nq, nz, ...) winds (MPDATA's
corrective passes, ``mpdata.py``). With ``advect_density`` every face wind
is weighted by the face mean of the density and the jacobian divisor
becomes J*rho, as in the JAX package (advect.f90's density option).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CourantWinds(NamedTuple):
    """dt/dx-normalized metric-weighted winds (setup_module_winds,
    advect.f90:306-351)."""
    U_m: torch.Tensor   # (nz, ny, nx-1)  internal x faces
    V_m: torch.Tensor   # (nz, ny-1, nx)  internal y faces
    W_m: torch.Tensor   # (nz, ny, nx)    top face of each layer


def face_density(rho):
    """The density on the faces the Courant winds live on: the means of
    the two cells beside each internal x and y face, and of the layers
    below and above each layer top, the model top taking its own layer's
    (icar_tpu/ops/advection.py setup_courant_winds)."""
    rho_u = (rho[:, :, 1:] + rho[:, :, :-1]) * 0.5
    rho_v = (rho[:, 1:, :] + rho[:, :-1, :]) * 0.5
    rho_w = torch.cat([(rho[1:] + rho[:-1]) * 0.5, rho[-1:]], dim=0)
    return rho_u, rho_v, rho_w


def setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w, rho=None,
                        advect_density: bool = False):
    """Pre-scale winds for one dt (advect.f90:306-351). U/V are divided by
    dx; W is not divided by dz because dz varies per cell. ``dt`` is a
    float32 value (numpy scalar or Python float holding one). With
    ``advect_density`` each wind is also weighted by ``rho`` on its face
    (``face_density``), multiplied last, in the JAX order."""
    dt_dx = float(np.float32(dt) / np.float32(dx))
    U_m = u[:, :, 1:-1] * dt_dx * jaco_u[:, :, 1:-1]
    V_m = v[:, 1:-1, :] * dt_dx * jaco_v[:, 1:-1, :]
    W_m = w * float(dt) * jaco_w
    if advect_density:
        rho_u, rho_v, rho_w = face_density(rho)
        U_m = U_m * rho_u
        V_m = V_m * rho_v
        W_m = W_m * rho_w
    return CourantWinds(U_m, V_m, W_m)


def _upwind_flux(ql, qr, U):
    return ((U + torch.abs(U)) * ql + (U - torch.abs(U)) * qr) * 0.5


def advect3d_upwind(q, winds: CourantWinds, dz, jaco, rho=None,
                    advect_density: bool = False):
    """Donor-cell update (advect3d, advect.f90:107-178) of a (..., nz, ny,
    nx) field. Interior cells (x, y in [1, n-2]) are updated; boundary
    cells pass through. With ``advect_density`` the divisor is J*rho."""
    U_m, V_m, W_m = winds

    # x faces 1..nx-1 between cells (f-1, f); flux difference for cells 1..nx-2
    fx = _upwind_flux(q[..., :-1], q[..., 1:], U_m)
    xdiv = fx[..., 1:-1, 1:] - fx[..., 1:-1, :-1]

    fy = _upwind_flux(q[..., :-1, :], q[..., 1:, :], V_m)
    ydiv = fy[..., 1:, 1:-1] - fy[..., :-1, 1:-1]

    # vertical faces between layers k and k+1 (W_m[k] = flux at top of k);
    # the winds index batch-generically too (MPDATA's corrective pass
    # passes per-species 4D pseudo-velocities)
    fz = _upwind_flux(q[..., :-1, :, :], q[..., 1:, :, :],
                      W_m[..., :-1, :, :])

    qi = q[..., 1:-1, 1:-1]
    jacoi = jaco[:, 1:-1, 1:-1]
    if advect_density:
        jacoi = jacoi * rho[:, 1:-1, 1:-1]
    dzi = dz[:, 1:-1, 1:-1]
    fzi = fz[..., 1:-1, 1:-1]

    dq = (xdiv + ydiv) / jacoi
    # vertical: the bottom layer loses only through its top face; the top
    # layer flushes q*W out of the model top (advect.f90:164-172)
    vert_in = torch.cat([
        fzi[..., :1, :, :],
        fzi[..., 1:, :, :] - fzi[..., :-1, :, :],
        (qi[..., -1:, :, :] * W_m[..., -1:, 1:-1, 1:-1]) - fzi[..., -1:, :, :]],
        dim=-3)
    dq = dq + vert_in / (dzi * jacoi)

    out = q.clone()
    out[..., 1:-1, 1:-1] = qi - dq
    return out


def advect_upwind(stacked_q, u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                  jaco, dz, floors=None, near_end=False, rho=None,
                  advect_density: bool = False):
    """Advect all species of ``stacked_q`` (nq, nz, ny, nx) at once
    (upwind, advect.f90:380-418), weighted by the density ``rho`` (nz,
    ny, nx) with ``advect_density``. With ``floors`` (nq,) and
    ``near_end``, clamp each species to its floor (the near-end
    enforce_limits clamp)."""
    winds = setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                                rho, advect_density)
    out = advect3d_upwind(stacked_q, winds, dz, jaco, rho, advect_density)
    if floors is not None and near_end:
        floor = torch.as_tensor(floors, dtype=out.dtype, device=out.device)
        out = torch.maximum(out, floor[:, None, None, None])
    return out


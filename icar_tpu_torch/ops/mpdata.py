"""MPDATA advection (Smolarkiewicz) with flux-corrected transport: the
plain PyTorch version of kernel K4 (icar_tpu/ops/mpdata.py).

One upwind pass, then ``order - 1`` corrective passes that advect with
antidiffusive pseudo-velocities computed from the latest solution, each
optionally limited by 1D FCT along its axis (adv_mpdata.f90,
adv_mpdata_FCT_core.f90; Smolarkiewicz & Grabowski 1990). Same functions
and float32 operation order as the JAX package's jnp path, batch-generic
over a leading species dimension. The CUDA kernel (``csrc/mpdata.cu``)
computes the same update; it scales the winds as ``(u*J_u/dx)*dt``, as
kernel K1 does, so the two agree to a few float32 ulp.

Layout: (z, y, x); Courant winds as in ``advection.CourantWinds`` (U on
internal x faces, V on internal y faces, W at layer tops, not divided by
dz). With ``advect_density`` the winds are density-weighted
(``advection.setup_courant_winds``) and every use of the jacobian becomes
G = J*rho: the pseudo-velocities and the divisor of every upwind pass.
"""

from __future__ import annotations

import torch

from .advection import CourantWinds, advect3d_upwind, setup_courant_winds

EPS_Q = 1e-10
EPS_F = 1e-15


def _sl(a, axis, s):
    idx = [slice(None)] * a.ndim
    idx[axis] = s
    return a[tuple(idx)]


def _add_interior(x, delta, axis):
    """x with ``delta`` added on the interior slices of ``axis``."""
    return torch.cat([_sl(x, axis, slice(None, 1)),
                      _sl(x, axis, slice(1, -1)) + delta,
                      _sl(x, axis, slice(-1, None))], dim=axis)


def _pseudo_velocities(q, U, V, Wn, G):
    """Antidiffusive pseudo-velocities (mpdata_fluxes,
    adv_mpdata.f90:107-259). ``Wn`` is the dz-normalized vertical Courant
    wind, ``G`` the jacobian. Returns (u2, v2, w2) shaped like (U, V, W)
    with q's leading dims."""
    # ---- U component: faces between x cells (c, c+1) ----
    ql, qr = q[..., :-1], q[..., 1:]
    Gx = G[:, :, :-1] + G[:, :, 1:]
    u2 = (torch.abs(U) * (1 - torch.abs(U) / (0.5 * Gx)) * (qr - ql)
          / (qr + ql + EPS_Q))
    # UxV cross term (interior y rows only)
    qn, qs = q[..., 2:, :], q[..., :-2, :]       # q at y+1, y-1
    eq = ((qn[..., 1:] - qs[..., 1:] + qn[..., :-1] - qs[..., :-1])
          / (qn[..., 1:] + qs[..., 1:] + qn[..., :-1] + qs[..., :-1] + EPS_Q))
    ev = 0.25 * (V[:, :-1, :-1] + V[:, 1:, :-1] + V[:, :-1, 1:] + V[:, 1:, 1:])
    cross = 0.5 * U[:, 1:-1, :] * ev * eq / Gx[:, 1:-1, :]
    u2 = _add_interior(u2, -cross, axis=-2)
    # UxW cross term (interior z levels)
    qu, qd = q[..., 2:, :, :], q[..., :-2, :, :]
    eq = ((qu[..., 1:] - qd[..., 1:] + qu[..., :-1] - qd[..., :-1])
          / (qu[..., 1:] + qd[..., 1:] + qu[..., :-1] + qd[..., :-1] + EPS_Q))
    ev = 0.25 * (Wn[1:-1, :, :-1] + Wn[:-2, :, :-1]
                 + Wn[1:-1, :, 1:] + Wn[:-2, :, 1:])
    cross = 0.5 * U[1:-1] * ev * eq / Gx[1:-1]
    u2 = _add_interior(u2, -cross, axis=-3)

    # ---- V component: faces between y rows (g, g+1) ----
    ql, qr = q[..., :-1, :], q[..., 1:, :]
    Gy = G[:, :-1, :] + G[:, 1:, :]
    v2 = (torch.abs(V) * (1 - torch.abs(V) / (0.5 * Gy)) * (qr - ql)
          / (qr + ql + EPS_Q))
    # VxU cross (interior x cells)
    qe = q[..., 2:]                              # x+1
    qw = q[..., :-2]                             # x-1
    eq = ((qe[..., :-1, :] - qw[..., 1:, :] + qe[..., 1:, :] - qw[..., :-1, :])
          / (qe[..., 1:, :] + qe[..., :-1, :] + qw[..., 1:, :]
             + qw[..., :-1, :] + EPS_Q))
    ev = 0.25 * (U[:, :-1, :-1] + U[:, 1:, :-1] + U[:, :-1, 1:] + U[:, 1:, 1:])
    cross = 0.5 * V[:, :, 1:-1] * ev * eq / Gy[:, :, 1:-1]
    v2 = _add_interior(v2, -cross, axis=-1)
    # VxW cross (interior z)
    qu, qd = q[..., 2:, :, :], q[..., :-2, :, :]
    eq = ((qu[..., :-1, :] - qd[..., 1:, :] + qu[..., 1:, :] - qd[..., :-1, :])
          / (qu[..., :-1, :] + qd[..., 1:, :] + qu[..., 1:, :]
             + qd[..., :-1, :] + EPS_Q))
    ev = 0.25 * (Wn[1:-1, :-1, :] + Wn[:-2, :-1, :]
                 + Wn[1:-1, 1:, :] + Wn[:-2, 1:, :])
    cross = 0.5 * V[1:-1] * ev * eq / Gy[1:-1]
    v2 = _add_interior(v2, -cross, axis=-3)

    # ---- W component: faces between levels (k, k+1), top = 0 ----
    ql, qr = q[..., :-1, :, :], q[..., 1:, :, :]
    Gz = G[:-1] + G[1:]
    Wf = Wn[:-1]
    w2f = (torch.abs(Wf) * (1 - torch.abs(Wf) / (0.5 * Gz)) * (qr - ql)
           / (qr + ql + EPS_Q))
    # WxU cross (interior x)
    qe, qw = q[..., 2:], q[..., :-2]
    eq = ((qe[..., 1:, :, :] - qw[..., :-1, :, :] + qe[..., :-1, :, :]
           - qw[..., 1:, :, :])
          / (qe[..., :-1, :, :] + qe[..., 1:, :, :] + qw[..., :-1, :, :]
             + qw[..., 1:, :, :] + EPS_Q))
    ev = 0.25 * (U[:-1, :, :-1] + U[1:, :, :-1] + U[:-1, :, 1:] + U[1:, :, 1:])
    cross = 0.5 * Wf[:, :, 1:-1] * ev * eq / Gz[:, :, 1:-1]
    w2f = _add_interior(w2f, -cross, axis=-1)
    # WxV cross (interior y)
    qn, qs = q[..., 2:, :], q[..., :-2, :]
    eq = ((qn[..., 1:, :, :] - qs[..., :-1, :, :] + qn[..., :-1, :, :]
           - qs[..., 1:, :, :])
          / (qn[..., :-1, :, :] + qs[..., 1:, :, :] + qn[..., 1:, :, :]
             + qs[..., :-1, :, :] + EPS_Q))
    ev = 0.25 * (V[:-1, :-1, :] + V[1:, :-1, :] + V[:-1, 1:, :] + V[1:, 1:, :])
    cross = 0.5 * Wf[:, 1:-1, :] * ev * eq / Gz[:, 1:-1, :]
    w2f = _add_interior(w2f, -cross, axis=-2)

    w2 = torch.cat([w2f, torch.zeros_like(w2f[..., :1, :, :])], dim=-3)
    return u2, v2, w2


def _upwind_flux(ql, qr, U):
    return ((U + torch.abs(U)) * ql + (U - torch.abs(U)) * qr) * 0.5


def _fct_limit_axis(q0, q1, U2, axis: int, is_w: bool):
    """1D flux-corrected transport limiter along ``axis`` (x=-1, y=-2,
    z=-3) (adv_mpdata_FCT_core.f90). q0: the field before this corrective
    pass's predecessor; q1: its latest solution; U2: pseudo-velocity on the
    internal faces of ``axis``. Returns the limited U2."""
    sl = lambda a, s: _sl(a, axis, s)
    cat = lambda parts: torch.cat(parts, dim=axis)

    f = _upwind_flux(sl(q1, slice(None, -1)), sl(q1, slice(1, None)), U2)

    # per-cell allowable bounds from the 3-cell window (truncated at the
    # array edges) of both fields
    hi = torch.maximum(q0, q1)
    lo = torch.minimum(q0, q1)
    edge1 = slice(None, 1)
    neg_inf = torch.full_like(sl(hi, edge1), -torch.inf)
    pos_inf = torch.full_like(sl(hi, edge1), torch.inf)
    qmax = torch.maximum(hi, torch.maximum(
        cat([neg_inf, sl(hi, slice(None, -1))]),
        cat([sl(hi, slice(1, None)), neg_inf])))
    qmin = torch.minimum(lo, torch.minimum(
        cat([pos_inf, sl(lo, slice(None, -1))]),
        cat([sl(lo, slice(1, None)), pos_inf])))

    # total antidiffusive flux into / out of each cell
    zero = torch.zeros_like(sl(f, edge1))
    f_left = cat([zero, f])                        # face below/left of cell
    f_right = cat([f, zero])                       # face above/right of cell
    fin = torch.clamp(f_left, min=0.0) - torch.clamp(f_right, max=0.0)
    fout = torch.clamp(f_right, min=0.0) - torch.clamp(f_left, max=0.0)
    if not is_w:
        # no flux limiting at the lateral boundary cells
        # (adv_mpdata_FCT_core.f90 'No flux limitations to the boundary
        # cell')
        n = fin.shape[axis]
        fin = cat([zero, sl(fin, slice(1, n - 1)), zero])
        fout = cat([zero, sl(fout, slice(1, n - 1)), zero])

    beta_in = (qmax - q1) / (fin + EPS_F)
    beta_out = (q1 - qmin) / (fout + EPS_F)

    pos_fac = torch.clamp(torch.minimum(sl(beta_in, slice(1, None)),
                                        sl(beta_out, slice(None, -1))),
                          max=1.0)
    neg_fac = torch.clamp(torch.minimum(sl(beta_in, slice(None, -1)),
                                        sl(beta_out, slice(1, None))),
                          max=1.0)
    return torch.where(U2 > 0, U2 * pos_fac,
                       torch.where(U2 < 0, U2 * neg_fac, U2))


def advect3d_mpdata(q, winds: CourantWinds, dz, jaco, order: int,
                    use_fct: bool, rho=None, advect_density: bool = False):
    """Full MPDATA update of ``q`` (..., nz, ny, nx) (advect3d,
    adv_mpdata.f90:356-419). Interior cells are updated; boundary cells
    pass through. With ``advect_density`` the jacobian is J*rho
    throughout."""
    G = jaco * rho if advect_density else jaco
    q_prev = q
    q_new = advect3d_upwind(q, winds, dz, jaco, rho, advect_density)
    for _ in range(order - 1):
        Wn = winds.W_m / dz
        u2, v2, w2 = _pseudo_velocities(q_new, winds.U_m, winds.V_m, Wn, G)
        # worst-case stability factor (Smolarkiewicz 1984 after eq. 24)
        u2 = u2 * 0.5
        v2 = v2 * 0.5
        w2 = w2 * 0.5 * dz
        if use_fct:
            u2 = _fct_limit_axis(q_prev, q_new, u2, axis=-1, is_w=False)
            v2 = _fct_limit_axis(q_prev, q_new, v2, axis=-2, is_w=False)
            wf = _fct_limit_axis(q_prev, q_new, w2[..., :-1, :, :] / dz[:-1],
                                 axis=-3, is_w=True)
            w2 = torch.cat([wf * dz[:-1], torch.zeros_like(w2[..., :1, :, :])],
                           dim=-3)
        q_prev = q_new
        q_new = advect3d_upwind(q_new, CourantWinds(u2, v2, w2), dz, jaco,
                                rho, advect_density)
    return q_new


def advect_mpdata(stacked_q, u, v, w, dt, dx, jaco_u, jaco_v, jaco_w, jaco,
                  dz, order: int = 2, use_fct: bool = True,
                  advect_density: bool = False, floors=None,
                  near_end: bool = False, rho=None):
    """Advect all species of ``stacked_q`` (nq, nz, ny, nx) with MPDATA in
    one pass (mpdata, adv_mpdata.f90:463-524), weighted by the density
    ``rho`` (nz, ny, nx) with ``advect_density``. With ``floors`` (nq,)
    and ``near_end``, clamp each species to its floor (the near-end
    enforce_limits clamp)."""
    winds = setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                                rho, advect_density)
    out = advect3d_mpdata(stacked_q, winds, dz, jaco, order, use_fct, rho,
                          advect_density)
    if floors is not None and near_end:
        floor = torch.as_tensor(floors, dtype=out.dtype, device=out.device)
        out = torch.maximum(out, floor[:, None, None, None])
    return out

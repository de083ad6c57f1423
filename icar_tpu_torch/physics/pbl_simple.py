"""Simple local-K PBL diffusion (Louis 1979 / Hong & Pan 1996)
(icar_tpu/physics/pbl_simple.py, pbl_simple.f90): gradient-Richardson
stability functions on half levels, an asymptotic mixing length, and
explicit substepped vertical diffusion of theta and the moisture species,
stacked, with one substep count for the whole domain (its largest Kq/dz).

The substep count is read to the host once per call (one synchronisation);
the substeps then run as a host loop of whole-domain operations. A
sharded domain takes the largest of its blocks' counts
(``substep_bound`` per block, ``parallel.mesh.host_max``) and passes it
to each block's call, so that every column diffuses with the domain's
substep length. Divisions
by a constant are products with its float32 reciprocal
(``pointwise.inv``), as in the JAX package's compiled step.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops.pointwise import inv

PR_UPPER = 4.0
PR_LOWER = 0.25
ASYMP_LENGTH_SCALE = 1 / 250.0
N_SUBSTEPS = 10.0
DIFFUSION_REDUCTION = 2.0


def eddy_diffusivity(th, qv, qc, qi, qr, qs, u_mass, v_mass, exner, z,
                     terrain, dz, dt, water_mask=None):
    """The scalar diffusion coefficient Kq*dt/dz on half levels k+1/2
    (simple_pbl, pbl_simple.f90:100-135), shape (nz-1, ny, nx). ``dt`` is
    a 0-d float32 tensor or a number."""
    dz_half = (dz[:-1] + dz[1:]) * 0.5

    du = u_mass[1:] - u_mass[:-1]
    dv = v_mass[1:] - v_mass[:-1]
    shear = torch.sqrt(du * du + dv * dv) / dz_half
    shear = torch.clamp(shear, min=1e-5)

    vth = th * (1 + 0.61 * qv - (qc + qi + qr + qs))
    vth_grad = (vth[1:] - vth[:-1]) / dz_half

    t_half = (th[:-1] * exner[:-1] + th[1:] * exner[1:]) * 0.5
    rig = C.GRAVITY / t_half * vth_grad / (shear * shear)
    rig = torch.clamp(rig, min=-100.0)

    stability = torch.where(
        rig > 0, torch.exp(-8.5 * rig) + 0.15 / (rig + 3),
        1.0 / torch.sqrt(1 - 1.6 * torch.clamp(rig, max=0.0)))
    prandtl = torch.clamp(1.5 + 3.08 * rig, PR_LOWER, PR_UPPER)

    l = 1.0 / (1.0 / (C.KARMAN * (z[:-1] - terrain[None]))
               + ASYMP_LENGTH_SCALE)
    K = l * l * stability * shear
    Kq = K / prandtl * dt / dz_half
    Kq = torch.clamp(Kq, 1.0, 1000.0)
    if water_mask is not None:
        # less mixing over open water (pbl_simple.f90:128)
        Kq = torch.where(water_mask[None], Kq * inv(1000.0), Kq)
    Kq = Kq * inv(DIFFUSION_REDUCTION)
    # cap to keep the explicit substepping bounded (pbl_simple.f90:193-196)
    Kq = torch.minimum(Kq, dz[:-1] * N_SUBSTEPS)
    return Kq


def substep_count(Kq, dz) -> int:
    """ceil(2 max(Kq/dz)) over the whole domain, at least 1: the number of
    explicit diffusion substeps (pbl_simple.f90:193-196), computed in
    float32 on the tensors' device and read to the host."""
    return max(int(substep_bound(Kq, dz).item()), 1)


def substep_bound(Kq, dz):
    """ceil(2 max(Kq/dz)) of ``Kq``'s cells as a 0-d float32 tensor on its
    device (``substep_count`` before the read)."""
    return torch.ceil(2 * torch.max(Kq / dz[:-1]))


def diffuse(q_stack, Kq, rho, dz, nsub=None):
    """Substepped explicit vertical diffusion of the stacked species
    (pbl_diffusion + diffuse_variable, pbl_simple.f90:143-212).
    ``q_stack`` (nq, nz, ny, nx); ``Kq`` on half levels (nz-1, ny, nx);
    ``nsub`` the substep count (``substep_count`` of ``Kq`` by
    default)."""
    rho_dz = rho * dz
    rhomean = (rho[:-1] + rho[1:]) * 0.5

    if nsub is None:
        nsub = substep_count(Kq, dz)
    # an exact division by the count, as the JAX package divides by a
    # traced integer (a number here would become a reciprocal's product
    # on the card)
    Kq = Kq / torch.full_like(Kq[:1, :1, :1], float(nsub))
    for _ in range(nsub):
        # fluxes at half levels; none through the surface (the LSM's)
        flux = Kq * rhomean * (q_stack[:, :-1] - q_stack[:, 1:])
        q0 = q_stack[:, :1] - flux[:, :1] / rho_dz[None, :1]
        # reference quirk kept: the top level gains its flux divided by
        # rho_dz of the level BELOW (pbl_simple.f90:160)
        qtop = q_stack[:, -1:] + flux[:, -1:] / rho_dz[None, -2:-1]
        qmid = q_stack[:, 1:-1] - (flux[:, 1:] - flux[:, :-1]) \
            / rho_dz[None, 1:-1]
        q_stack = torch.cat([q0, qmid, qtop], dim=1)
    return q_stack


def pbl_simple(th, qv, qc, qi, qr, qs, u_mass, v_mass, exner, rho, z,
               dz, terrain, dt, water_mask=None, Kq=None, nsub=None):
    """The scheme (simple_pbl, pbl_simple.f90:71-141); the top model level
    is never diffused. ``Kq``: the ``eddy_diffusivity`` of these inputs
    when the caller has formed it; ``nsub``: the diffusion's substep count
    (``diffuse``). Returns the updated (th, qv, qc, qi, qr, qs)."""
    if Kq is None:
        Kq = eddy_diffusivity(th, qv, qc, qi, qr, qs, u_mass, v_mass, exner,
                              z, terrain, dz, dt, water_mask)
    stack = torch.stack([qv, th, qc, qi, qs, qr])
    stack = diffuse(stack, Kq, rho, dz, nsub)
    qv, th, qc, qi, qs, qr = stack.unbind(0)
    return th, qv, qc, qi, qr, qs

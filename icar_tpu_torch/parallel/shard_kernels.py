"""Per-shard launches of the port's kernels (the counterpart of
icar_tpu/parallel/shard_kernels.py).

Every array operand is a list with one block per shard, in the order of
``Layout.shards``; scalars are shared. Each wrapper calls the
``ops/kernels.py`` wrapper on each block, on the block's device: the
kernel for a CUDA block (it launches there, on that device's current
stream, and counts in ``kernels.LAUNCHES``), the plain version for a CPU
block. A block is a natural subdomain with its halo (``mesh.Layout``), so
the kernels run unchanged.

- The microphysics (K2, K3: ``mp_simple_sharded``; K5:
  ``thompson_stack_sharded``) is column-local and needs no exchange. It
  runs on the whole block: the interval loop keeps every halo column equal
  to its owner's, so a halo column is real air, needs no benign padding
  and comes out equal to the owner's column. (The JAX package pads its
  frame with constants instead; a zero theta there made 1/T infinite,
  ADVICE r5, which cannot arise here.)
- The advection reads neighbours. K1 (``advect_upwind_sharded``) needs
  ``UPWIND_HALO`` cells, K4 (``advect_mpdata_sharded``, the counterpart of
  the TPU's ``advect_mpdata_padded``) ``mpdata_halo(order, use_fct)``.
  Each gives every owned cell the unsharded kernel's bits (its arithmetic
  per cell does not depend on where its tile sits; K4's skips of all-zero
  tiles keep the bits); the halo comes out stale, and the caller's
  exchange refreshes it.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import kernels

# donor-cell upwind reads one neighbour on each side
UPWIND_HALO = 1


def mpdata_halo(order: int, use_fct: bool) -> int:
    """The halo MPDATA (``ops/mpdata.py``) needs for every owned cell of a
    block to equal the unsharded result. A block's inner edge cells pass
    through each pass unchanged (they are the plain operator's boundary
    cells), so they go wrong first. The upwind pass reads one neighbour:
    its result is right from 1 cell in. A corrective pass reads the last
    solution one cell beyond each face (the pseudo-velocities and their
    cross terms); FCT limits a face by the bounds and fluxes of the cells
    beside it, which read one cell further. So each corrective pass moves
    the right cells 1 further in, 2 with FCT. tests/test_torch_shard_
    kernels.py pins this: exact at this width, not at one less."""
    return 1 + (int(order) - 1) * (2 if use_fct else 1)


def _on(device: torch.device):
    """Make ``device`` current, so that a kernel launches there."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check_halo(layout, need: int, what: str):
    if layout.mesh.size > 1 and layout.halo < need:
        raise ValueError(f"{what}: the layout's halo of {layout.halo} cells "
                         f"is less than the {need} it reads")


def mp_simple_sharded(theta, qv, qc, qr, qs, pressure, exner, dz, rain, snow,
                      dt, cloud2rain, cloud2snow, rho=None):
    """SB04 on every block, in place: K2 (``kernels.mp_simple``), or K3
    (``kernels.mp_simple_rho``) with the density blocks ``rho``."""
    if rho is None:
        for blk in zip(theta, qv, qc, qr, qs, pressure, exner, dz, rain,
                       snow):
            with _on(blk[0].device):
                kernels.mp_simple(*blk, dt, cloud2rain, cloud2snow)
        return
    for blk in zip(theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain,
                   snow):
        with _on(blk[0].device):
            kernels.mp_simple_rho(*blk, dt, cloud2rain, cloud2snow)


def thompson_stack_sharded(qstack, smap, exner, pressure, dz_mass, dt, rain,
                           snow, graupel, params):
    """Thompson (K5, ``kernels.mp_thompson_stack``) on every block of the
    9-species stack, in place."""
    for blk in zip(qstack, exner, pressure, dz_mass, rain, snow, graupel):
        with _on(blk[0].device):
            kernels.mp_thompson_stack(blk[0], smap, *blk[1:4], dt, *blk[4:],
                                      params)


def advect_upwind_sharded(layout, q, winds, dt, floors, near_end: bool, out):
    """K1 (``kernels.advect_upwind``) on every haloed block of the stack
    ``q`` into ``out``; ``winds`` and ``floors`` per block. Every owned
    cell of ``out`` is exact when ``layout.halo`` >= UPWIND_HALO."""
    _check_halo(layout, UPWIND_HALO, "advect_upwind_sharded")
    for qb, wb, fb, ob in zip(q, winds, floors, out):
        with _on(qb.device):
            kernels.advect_upwind(qb, wb, dt, fb, near_end, out=ob)
    return out


def advect_mpdata_sharded(layout, q, winds, dt, order: int, use_fct: bool,
                          floors, near_end: bool, out):
    """K4 (``kernels.advect_mpdata``) on every haloed block of the stack
    ``q`` into ``out``: the counterpart of the TPU's per-shard
    ``advect_mpdata_padded``, with no limit on the order or the mesh's
    shape. Every owned cell of ``out`` is exact when ``layout.halo`` >=
    ``mpdata_halo(order, use_fct)``."""
    _check_halo(layout, mpdata_halo(order, use_fct), "advect_mpdata_sharded")
    for qb, wb, fb, ob in zip(q, winds, floors, out):
        with _on(qb.device):
            kernels.advect_mpdata(qb, wb, dt, order, use_fct, fb, near_end,
                                  out=ob)
    return out

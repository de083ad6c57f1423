"""Device mesh, domain decomposition and halo exchange, driven by one
process (the counterpart of icar_tpu/parallel/mesh.py).

The JAX package is single-controller: one Python process drives a
``jax.sharding.Mesh`` through ``shard_map``. The port does the same with
plain tensors: a ``Mesh`` is a (my, mx) grid of ``torch.device``s (a device
may repeat, so one card can hold a 2x2 mesh), and a ``Layout`` says which
natural cells each shard owns and which block of the (ny, nx) plane it
holds: its owned cells plus, on each side that is not a domain edge,
``halo`` cells of its neighbours. There is no padded frame: a block is a
natural subdomain, and at a domain edge its edge is the domain's, so the
"boundary cells pass through" semantics of the plain operators apply there
unchanged. A staggered field carries both end faces of its block (u has
nx + 1 faces, v has ny + 1).

Shard (r, c) owns the natural rows and columns it owns in the JAX package
(``padded_sizes``: ny_l = NYP // my with NYP = ceil((ny + 1) / my) * my,
likewise for x), so the shards of the two packages hold the same cells.
The JAX package's files per shard (output and restarts) name a shard by
its row-major index and place it by its start in that padded frame
(``Layout.shard_id``, ``Layout.frame_start``, ``Layout.frame_piece``).
The halo exchange (``Layout.exchange``) is explicit tensor copies between
blocks in two phases: x on owned rows, then y on whole haloed rows, which
fills the corners. It reaches past a neighbour whose owned range is
narrower than the halo.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..grid import Geometry, decompose_images


class Mesh:
    """A (my, mx) grid of torch devices, row-major: shard (r, c) runs on
    ``devices[r * mx + c]``. Devices may repeat."""

    def __init__(self, devices: Sequence, shape: Tuple[int, int]):
        my, mx = (int(n) for n in shape)
        devices = [torch.device(d) for d in devices]
        if my < 1 or mx < 1 or len(devices) != my * mx:
            raise ValueError(f"Mesh: {len(devices)} devices do not fill a "
                             f"{my}x{mx} grid")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"Mesh: devices of several types {devices}")
        self.shape = (my, mx)
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_mesh(nx: int, ny: int, devices=None) -> Mesh:
    """A mesh over ``devices`` (every visible CUDA device by default),
    their count factored into (yimages, ximages) to match the domain's
    aspect ratio, as the JAX package and the reference factor it
    (decompose_images, grid_obj.f90:39-103)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] (CPU devices in the tests)")
    ximages, yimages = decompose_images(len(devices), nx, ny)
    return Mesh(devices, (yimages, ximages))


def part_size(n: int, parts: int) -> int:
    """The cells of one shard along an axis of the JAX package's padded
    frame: NP // parts with NP = ceil((n + 1) / parts) * parts, the padded
    size of n + 1 cells (icar_tpu/parallel/mesh.py padded_sizes; a C-grid
    mixes n and n + 1 cells, and XLA's shardings divide evenly)."""
    return -(-(n + 1) // parts)


def pad_field(arr, nyp: int, nxp: int):
    """Copy of icar_tpu/parallel/mesh.py pad_field.

    Edge-replicate pad the trailing two dims to (nyp, nxp)."""
    a = np.asarray(arr)
    py = nyp - a.shape[-2]
    px = nxp - a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [(0, py), (0, px)]
    return np.pad(a, pad, mode="edge")


def owned_ranges(n: int, parts: int) -> List[Tuple[int, int]]:
    """The [start, end) of natural cells 0..n-1 that each of ``parts``
    shards owns along one axis: n_l = ``part_size(n, parts)`` each. Raises
    ValueError if a shard would own none."""
    n_l = part_size(n, parts)
    out = [(i * n_l, min((i + 1) * n_l, n)) for i in range(parts)]
    for i, (a, b) in enumerate(out):
        if a >= b:
            raise ValueError(f"{parts} shards over {n} cells: shard {i} "
                             f"would own none (each owns up to {n_l})")
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """One block of a layout: mesh position, device, the global ranges of
    its owned cells (y0, y1, x0, x1) and of its block (by0, by1, bx0,
    bx1), end-exclusive, and the domain's (ny, nx)."""
    r: int
    c: int
    device: torch.device
    own: Tuple[int, int, int, int]
    block: Tuple[int, int, int, int]
    domain: Tuple[int, int]

    @property
    def owned(self) -> Tuple[slice, slice]:
        """The owned cells within the block (rows, columns)."""
        y0, y1, x0, x1 = self.own
        by0, _, bx0, _ = self.block
        return slice(y0 - by0, y1 - by0), slice(x0 - bx0, x1 - bx0)

    @property
    def interior(self) -> Tuple[slice, slice]:
        """The block's cells off the domain's edge ring (rows, columns):
        the fields the reference fills on interior cells only (w_real, the
        10 m winds) are formed there. A side of the block on the domain's
        edge leaves out its outer row or column; an inner side, whose edge
        cells are halo and interior to the domain, keeps them."""
        ny, nx = self.domain
        by0, by1, bx0, bx1 = self.block
        return (slice(int(by0 == 0), by1 - by0 - int(by1 == ny)),
                slice(int(bx0 == 0), bx1 - bx0 - int(bx1 == nx)))

    @property
    def whole(self) -> bool:
        """Whether the block is the whole domain."""
        return self.block == (0, self.domain[0], 0, self.domain[1])

    def columns(self) -> np.ndarray:
        """The domain's row-major index (y * nx + x) of each of the
        block's columns, in the block's row-major order."""
        by0, by1, bx0, bx1 = self.block
        y = np.arange(by0, by1)[:, None]
        x = np.arange(bx0, bx1)[None, :]
        return (y * self.domain[1] + x).reshape(-1)


class Layout:
    """How a (ny, nx) domain lies on ``mesh`` with ``halo`` cells of
    neighbour data on each inner side of a block."""

    def __init__(self, mesh: Mesh, ny: int, nx: int, halo: int):
        if halo < 0:
            raise ValueError(f"Layout: negative halo {halo}")
        my, mx = mesh.shape
        rows, cols = owned_ranges(ny, my), owned_ranges(nx, mx)
        self.mesh, self.ny, self.nx, self.halo = mesh, ny, nx, halo
        self.shards = [
            Shard(r, c, mesh.devices[r * mx + c], rows[r] + cols[c],
                  (max(rows[r][0] - halo, 0), min(rows[r][1] + halo, ny),
                   max(cols[c][0] - halo, 0), min(cols[c][1] + halo, nx)),
                  (ny, nx))
            for r in range(my) for c in range(mx)]
        self._copies = self._plan()

    def _stagger(self, shape) -> Tuple[int, int]:
        ey, ex = shape[-2] - self.ny, shape[-1] - self.nx
        if ey not in (0, 1) or ex not in (0, 1):
            raise ValueError(f"a field of shape {tuple(shape)} is not on the "
                             f"({self.ny}, {self.nx}) grid or its faces")
        return ey, ex

    def block_of(self, a, shard: Shard):
        """The view of global ``a`` (..., ny[+1], nx[+1]) that ``shard``
        holds; a staggered field takes both end faces of the block."""
        ey, ex = self._stagger(a.shape)
        by0, by1, bx0, bx1 = shard.block
        return a[..., by0:by1 + ey, bx0:bx1 + ex]

    def scatter(self, a) -> List[torch.Tensor]:
        """Float32 blocks of global ``a`` (tensor or array), one per shard
        on its device; every cell, halo included, a copy of ``a``'s."""
        t = (a.to(torch.float32) if torch.is_tensor(a)
             else torch.tensor(np.asarray(a), dtype=torch.float32))
        return [self.block_of(t, s).to(s.device, copy=True).contiguous()
                for s in self.shards]

    def gather(self, blocks: Sequence[torch.Tensor],
               device=None) -> torch.Tensor:
        """The global field rebuilt on ``device`` (the first shard's by
        default) from each block's owned cells (``owned_cells``)."""
        ey, ex = self._block_stagger(blocks[0], self.shards[0])
        device = self.shards[0].device if device is None else device
        out = torch.empty(tuple(blocks[0].shape[:-2])
                          + (self.ny + ey, self.nx + ex),
                          dtype=blocks[0].dtype, device=device)
        for s, b in zip(self.shards, blocks):
            y0, _, x0, _ = s.own
            cells = self.owned_cells(b, s)
            out[..., y0:y0 + cells.shape[-2],
                x0:x0 + cells.shape[-1]] = cells
        return out

    @staticmethod
    def _block_stagger(block, shard: Shard) -> Tuple[int, int]:
        """(ey, ex): the extra face rows and columns of ``block``, a
        staggered field's block, over its ``shard``'s block of cells."""
        by0, by1, bx0, bx1 = shard.block
        return block.shape[-2] - (by1 - by0), block.shape[-1] - (bx1 - bx0)

    def owned_cells(self, block, shard: Shard):
        """The view of ``block`` (of ``shard``) holding the cells the shard
        owns; on the last row (column) of shards a staggered field's owned
        faces include the end face."""
        my, mx = self.mesh.shape
        ey, ex = self._block_stagger(block, shard)
        ly, lx = shard.owned
        ty = ey if shard.r == my - 1 else 0
        tx = ex if shard.c == mx - 1 else 0
        return block[..., ly.start:ly.stop + ty, lx.start:lx.stop + tx]

    def exchange(self, blocks: Sequence[torch.Tensor]):
        """Fill the halo of every block of a mass-point field (..., block
        rows, block columns) in place from the blocks that own those
        cells: x first on owned rows, then y on whole haloed rows (which
        carries the x halos into the corners). A copy between two devices
        is ordered against both devices' current streams by PyTorch, so
        no event is recorded here; on one device every copy runs in
        stream order."""
        for i, j, dst, src in self._copies:
            blocks[i][(Ellipsis,) + dst].copy_(blocks[j][(Ellipsis,) + src])

    def _plan(self):
        """The exchange's copies, x phase first: (destination shard,
        source shard, destination rows and columns, source rows and
        columns), for each pair of shards on one mesh row (x) or column
        (y) where the source owns cells of the destination's halo."""
        copies = []
        for k in (2, 0):                # columns (x), then rows (y)
            for i, s in enumerate(self.shards):
                for j, t in enumerate(self.shards):
                    if i == j or (s.r != t.r if k == 2 else s.c != t.c):
                        continue
                    lo = max(t.own[k], s.block[k])
                    hi = min(t.own[k + 1], s.block[k + 1])
                    if lo >= hi:
                        continue
                    d = slice(lo - s.block[k], hi - s.block[k])
                    o = slice(lo - t.block[k], hi - t.block[k])
                    if k == 2:
                        copies.append((i, j, (s.owned[0], d),
                                       (t.owned[0], o)))
                    else:
                        copies.append((i, j, (d, slice(None)),
                                       (o, slice(None))))
        return copies

    def shard_id(self, shard: Shard) -> int:
        """The shard's row-major index on the mesh (its place in
        ``shards``): the device id of the JAX package's shard for a JAX
        mesh over its first my * mx devices."""
        return shard.r * self.mesh.shape[1] + shard.c

    @property
    def frame(self) -> Tuple[int, int]:
        """(NYP, NXP): the JAX package's padded frame of this mesh, in
        which every field of a sharded JAX model lies (``part_size``
        cells a shard)."""
        my, mx = self.mesh.shape
        return part_size(self.ny, my) * my, part_size(self.nx, mx) * mx

    @staticmethod
    def frame_start(shard: Shard) -> Tuple[int, int]:
        """(y_start, x_start) of the shard's piece of the padded frame: its
        first owned row and column (``owned_ranges`` cuts the frame)."""
        return shard.own[0], shard.own[2]

    def frame_piece(self, block, shard: Shard) -> np.ndarray:
        """The shard's piece of the JAX package's padded frame, on the
        host, from its ``block`` of a field: its owned cells
        (``owned_cells``) edge-replicated out to NYP / my rows and NXP /
        mx columns (``pad_field``; only the last row or column of shards
        reaches past the domain), as a shard of a sharded JAX field holds
        it."""
        nyp, nxp = self.frame
        my, mx = self.mesh.shape
        return pad_field(self.owned_cells(block, shard).cpu().numpy(),
                         nyp // my, nxp // mx)

    def boundary_masks(self) -> List[torch.Tensor]:
        """Per block, 1 where the cell lies on the domain's lateral
        boundary ring (global row or column 0 or n - 1), 0 inside."""
        out = []
        for s in self.shards:
            by0, by1, bx0, bx1 = s.block
            y = torch.arange(by0, by1)[:, None]
            x = torch.arange(bx0, bx1)[None, :]
            ring = ((y == 0) | (y == self.ny - 1)
                    | (x == 0) | (x == self.nx - 1))
            out.append(ring.to(torch.float32).to(s.device))
        return out


def scatter_geometry(geom: Geometry, layout: Layout) -> List[Geometry]:
    """One float32 torch ``Geometry`` per shard, on its device: every
    horizontal field sliced to the shard's block (staggered ones with both
    end faces), ``ny``/``nx`` the block's size; vertical profiles and
    scalars as they are."""
    from ..convert import geometry_to_torch
    out = []
    for s in layout.shards:
        by0, by1, bx0, bx1 = s.block
        kw = {"ny": by1 - by0, "nx": bx1 - bx0}
        for f in dataclasses.fields(geom):
            v = getattr(geom, f.name)
            if isinstance(v, np.ndarray) and v.ndim >= 2:
                kw[f.name] = np.ascontiguousarray(layout.block_of(v, s))
        out.append(geometry_to_torch(dataclasses.replace(geom, **kw),
                                     s.device))
    return out


def host_max(counts) -> int:
    """The largest of per-block counts (one tensor per block, on the
    block's device), each block's read to the host once: a count the whole
    domain shares, such as pbl_simple's diffusion substeps. A halo cell
    holds its owner's value, so the blocks' largest is the domain's."""
    return max(int(c.item()) for c in counts)


def single(device, ny: int, nx: int) -> Layout:
    """The one-shard layout of the whole domain on ``device``."""
    return Layout(Mesh([device], (1, 1)), ny, nx, 0)

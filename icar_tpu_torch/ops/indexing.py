"""Per-column level selection (icar_tpu/ops/indexing.py).

The JAX package replaces ``take_along_axis`` by a chain of selects there
because gathers are slow on the TPU; on the GPU a gather along the level
axis is one pass, so this is ``torch.take_along_dim`` with the same clip of
the index.
"""

from __future__ import annotations

import torch


def take_level(arr, idx):
    """``arr`` (n, *spatial) at the level ``idx`` of each column: ``idx`` is
    (*spatial), giving (*spatial), or (m, *spatial), giving (m, *spatial).
    Out-of-range indices clip to [0, n - 1], as take_along_axis does."""
    n = arr.shape[0]
    idx = torch.clamp(idx.long(), 0, n - 1)
    squeeze = idx.dim() == arr.dim() - 1
    if squeeze:
        idx = idx[None]
    shape = torch.broadcast_shapes(idx.shape[1:], arr.shape[1:])
    out = torch.take_along_dim(arr.expand(n, *shape),
                               idx.expand(idx.shape[0], *shape), dim=0)
    return out[0] if squeeze else out

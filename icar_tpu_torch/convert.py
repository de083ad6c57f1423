"""Carry a model state or geometry across from numpy to the port.

``state_from_numpy`` takes a state as numpy arrays — for example a JAX
model's ``{k: np.asarray(v) for k, v in model.state.items()}`` — and gives
the port's state dict of float32 tensors; ``geometry_to_torch`` does the
same for a ``grid.Geometry``. With these the tests run both packages from
the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .grid import Geometry


def state_from_numpy(arrays: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
    """A state dict of float32 tensors on ``device`` (each array copied)."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device)
            for k, v in arrays.items()}


def geometry_to_torch(geom: Geometry, device) -> Geometry:
    """A copy of ``geom`` whose array members are float32 tensors on
    ``device``; scalars (dx, sizes, smooth_height) stay Python numbers."""
    kw = {}
    for f in dataclasses.fields(geom):
        v = getattr(geom, f.name)
        if isinstance(v, np.ndarray):
            kw[f.name] = torch.tensor(v, dtype=torch.float32, device=device)
    return dataclasses.replace(geom, **kw)

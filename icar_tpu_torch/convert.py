"""Carry a model state or geometry across from numpy to the port.

``state_from_numpy`` takes a state as numpy arrays — for example a JAX
model's ``{k: np.asarray(v) for k, v in model.state.items()}`` — and gives
the port's state dict of float32 tensors; ``geometry_to_torch`` does the
same for a ``grid.Geometry``, and ``linear_winds_from_numpy`` for a JAX
model's linear-theory table pair and perturbation state. With these the
tests run both packages from the same state and table.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
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


def table_to_torch(a, device, dtype=torch.float32) -> torch.Tensor:
    """A table as a tensor of ``dtype`` on ``device``: ``a`` is float32 or
    bfloat16 (numpy has no bfloat16 of its own: the JAX package's arrays
    come as ml_dtypes' type, whose bits are carried across unchanged);
    float32 becomes bfloat16 rounded to nearest even."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.tensor(a, dtype=torch.float32)
    return t.to(device=device, dtype=dtype)


def linear_winds_from_numpy(lut_u, lut_v, pert_u, pert_v, device,
                            dtype=torch.float32):
    """A JAX model's linear-theory table pair (``model._lut`` as numpy) in
    ``dtype`` and its perturbation state (``model.u_perturbation``,
    ``model.v_perturbation``) in float32, as tensors on ``device``:
    ((lut_u, lut_v), pert_u, pert_v)."""
    return ((table_to_torch(lut_u, device, dtype),
             table_to_torch(lut_v, device, dtype)),
            table_to_torch(pert_u, device), table_to_torch(pert_v, device))


def noahmp_state_from_numpy(arrays: Dict[str, np.ndarray], device
                            ) -> Dict[str, torch.Tensor]:
    """A Noah-MP column state (``physics.noahmp`` keys, e.g. the JAX
    package's ``noahmp_init_state`` or a JAX column's new state as numpy)
    as tensors on ``device``: float32, the layer count ``isnow`` int32."""
    return {k: torch.tensor(np.asarray(v), device=device,
                            dtype=torch.int32 if k == "isnow"
                            else torch.float32)
            for k, v in arrays.items()}


def params_from_numpy(params: SimpleNamespace, device) -> SimpleNamespace:
    """A resolved parameter namespace (the JAX package's
    ``noahmp_params.resolve_params``, its arrays as numpy or jax arrays)
    with its arrays as tensors on ``device``: float32, integer arrays
    int32, boolean ones bool; numbers and numpy tables kept as they are."""
    out = SimpleNamespace()
    for k, v in vars(params).items():
        if hasattr(v, "dtype") and not isinstance(v, np.ndarray):
            a = np.asarray(v)
            dtype = (torch.bool if a.dtype == bool else torch.int32
                     if a.dtype.kind in "iu" else torch.float32)
            v = torch.tensor(a, device=device, dtype=dtype)
        out.__dict__[k] = v
    return out

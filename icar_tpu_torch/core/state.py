"""Model state: a flat dict of torch tensors (icar_tpu/core/state.py).

Which fields exist is decided by the variable registry's per-scheme
requests, exactly as in the JAX package. Every field is float32, like the
reference state (``icar_tpu/core/state.py:41``), although the registry
declares the precipitation accumulators float64.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..config import Options
from ..registry import REGISTRY, collect_requests

# fields provided by the static Geometry object rather than the state
GEOMETRY_FIELDS = {
    "z", "z_interface", "dz", "dz_interface", "terrain", "latitude",
    "longitude",
}

State = Dict[str, torch.Tensor]


def create_state(options: Options, device) -> State:
    """Allocate all requested fields, filled with their registry default,
    on ``device`` (create_variables, domain_obj.f90:162-433)."""
    req = collect_requests(options)
    d = options.domain
    state: State = {}
    for name in sorted(req.alloc):
        if name in GEOMETRY_FIELDS:
            continue
        spec = REGISTRY[name]
        shape = spec.shape(d.nz, d.ny, d.nx)
        state[name] = torch.full(shape, spec.default, dtype=torch.float32,
                                 device=device)
    return state


def advected_names(options: Options) -> List[str]:
    """Ordered list of advected species (vars_to_advect)."""
    return list(collect_requests(options).advect)


def restart_names(options: Options) -> List[str]:
    """The fields a restart file holds, sorted (the registry's restart
    requests)."""
    return sorted(collect_requests(options).restart)


# the surface accumulators a state may hold
ACCUMULATORS = ("precipitation", "snowfall", "graupel")


def state_digest(state: State, names) -> Dict[str, List[float]]:
    """[sum, sum of squares], in float64, of each field in ``names`` and
    each accumulator the state holds: a fingerprint of a run's final state
    that two runs share when their fields agree bit for bit."""
    out = {}
    for name in list(names) + [a for a in ACCUMULATORS if a in state]:
        x = state[name].double()
        out[name] = [float(x.sum()), float((x * x).sum())]
    return out

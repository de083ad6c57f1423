"""One forcing interval of the ridge configurations: microphysics then
upwind or MPDATA advection, substep by substep (icar_tpu/core/step.py,
which runs the upwind case as ``fast_step`` on the TPU and the MPDATA case
as its general loop ``step``).

The substep loop runs on the host. Per interval: the partial diagnostics,
one CFL dt quantized to 1/64 s (read to the host once), the advected
species stacked in their natural (S, nz, ny, nx) layout, and the
loop-invariant advection winds. Per substep: the microphysics kernel
updates the stack in place, the advection kernel writes into a second
buffer (the two swap), and, when forcing tendencies are set, the boundary
ring relaxes towards them before the near-end floor clamp. With upwind
advection (the fast path, SB04 only) SB04 forms the density in its kernel
(K2) and the surface precipitation of the interval is added to the state
at its end. With MPDATA (the general loop) the state's density is
refreshed each substep, the microphysics accumulates precipitation in the
state substep by substep -- SB04 (K3) on its five species with that
density, or Thompson (K5) on its nine species with the mass-level
thickness -- and MPDATA (K4) advects the stack. Time is carried in float32
as the JAX loop carries it, so the substep lengths and the clamp's timing
match. On CPU tensors the kernels' plain versions run.

The loop runs on a list of blocks (``run_interval_sharded``): the whole
domain is one block, and a model sharded over a device mesh holds one per
shard (``parallel/mesh.py``), each with its halo, exchanged after every
substep; the kernels run per block through ``parallel/shard_kernels.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import kernels
from ..physics import mp_thompson
from ..physics.mp_simple import formation_rates
from ..physics.thompson_tables import ThompsonParams
from ..parallel import shard_kernels as sk
from ..parallel.mesh import Layout, single
from .diagnostics import (cfl_maxima, compute_dt, diagnostic_update,
                          dt_from_maxima)

# fields clamped to >= 0 near the end of an interval (enforce_limits,
# domain_obj.f90:2228)
LIMITED_FIELDS = (
    "water_vapor", "cloud_water", "cloud_ice", "rain_mass", "snow_mass",
    "graupel_mass", "cloud_number", "ice_number", "rain_number",
    "snow_number", "graupel_number",
)

# the derived fields the general loop refreshes every substep: SB04 reads
# the density, which follows theta (icar_tpu/core/step.py _substep_needs
# for this configuration)
SUBSTEP_NEEDS = frozenset(("density",))

# the species SB04 updates, in the kernel's argument order
MP_SPECIES = ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "snow_mass")


def thompson_params(options) -> ThompsonParams:
    """The Thompson parameters of ``options.mp`` (icar_tpu/core/step.py
    builds them the same way)."""
    return ThompsonParams(**{f.name: getattr(options.mp, f.name)
                             for f in dataclasses.fields(ThompsonParams)})


def _check_species(mp: int, mpdata: bool, adv_names):
    """Raise ValueError unless the microphysics, the advection and the
    advected species are a pair that the loop runs (which options are
    ported is ICARModel's decision, models/icar.py ``_unported``)."""
    want = {C.MP_SIMPLE: MP_SPECIES,
            C.MP_THOMPSON: mp_thompson.SPECIES if mpdata else None}.get(mp)
    if want is None or sorted(adv_names) != sorted(want):
        raise ValueError(
            f"run_interval: microphysics={mp} with "
            f"{'MPDATA' if mpdata else 'upwind'} advection and the species "
            f"{tuple(adv_names)} is not a configuration it runs")


def limit_floors(adv_names: Sequence[str]) -> np.ndarray:
    """Per-species near-end floor: 0 for limited fields, -inf otherwise."""
    return np.asarray([0.0 if k in LIMITED_FIELDS else -np.inf
                       for k in adv_names], np.float32)


def quantized_dt(u, v, w, dz_levels, dx, cfl_reduction,
                 cfl_strictness) -> np.float32:
    """The CFL dt capped at MAX_DT and quantized to 1/64 s (exact in f32),
    so the substep count does not depend on reduction order
    (icar_tpu/core/step.py quantized_dt). Returned on the host."""
    return _quantize(compute_dt(u, v, w, dz_levels, dx, cfl_reduction,
                                cfl_strictness))


def sharded_dt(states, geoms, cfl_reduction, cfl_strictness) -> np.float32:
    """``quantized_dt`` of a domain held as blocks: each block's
    ``cfl_maxima``, reduced on the host by their maximum (the domain's
    maxima, whatever the blocks' overlap), then the same dt and
    quantization in float32 as on one device."""
    m = torch.stack([cfl_maxima(s["u"], s["v"], s["w"], g.dz_levels,
                                g.dx).cpu() for s, g in zip(states, geoms)])
    return _quantize(dt_from_maxima(torch.amax(m, dim=0), cfl_reduction,
                                    cfl_strictness))


def _quantize(dt) -> np.float32:
    dt = torch.clamp(dt, max=C.MAX_DT)
    dt = torch.clamp(torch.floor(dt * 64.0) / 64.0, min=1.0 / 64.0)
    return np.float32(dt.item())


def path_kernels(options) -> Tuple[str, ...]:
    """The kernels (names of ``kernels.LAUNCHES``) the interval loop
    launches for ``options`` on the card."""
    mpdata = options.physics.advection == C.ADV_MPDATA
    if options.physics.microphysics == C.MP_THOMPSON:
        return ("mp_thompson", "advect_mpdata")
    if mpdata:
        return ("mp_simple_rho", "advect_mpdata")
    return ("mp_simple", "advect_upwind")


def path_halo(options) -> int:
    """The halo a block of the interval loop needs for ``options``: what
    the path's advection kernel reads (the microphysics reads none)."""
    if options.physics.advection == C.ADV_MPDATA:
        return sk.mpdata_halo(options.adv.mpdata_order,
                              options.adv.flux_corrected_transport)
    return sk.UPWIND_HALO


def run_interval(state: Dict[str, torch.Tensor], geom, options,
                 adv_names: Sequence[str], seconds: float,
                 dqdt: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Integrate ``state`` over one interval of ``seconds``; returns the new
    state and the number of substeps. ``geom`` holds torch tensors;
    ``dqdt`` maps advected species to boundary forcing tendencies. The
    whole domain is one block (``run_interval_sharded`` on a one-shard
    layout)."""
    layout = single(state["pressure"].device, geom.ny, geom.nx)
    (state,), n = run_interval_sharded(layout, [state], [geom], options,
                                       adv_names, seconds, [dqdt or {}])
    return state, n


def run_interval_sharded(layout: Layout, states: List[Dict[str, torch.Tensor]],
                         geoms, options, adv_names: Sequence[str],
                         seconds: float, dqdts=None
                         ) -> Tuple[List[Dict[str, torch.Tensor]], int]:
    """``run_interval`` on a domain held as blocks (``mesh.Layout``):
    ``states``, ``geoms`` and ``dqdts`` hold one block each, with a halo of
    at least ``path_halo(options)`` on every inner side (the counterpart of
    icar_tpu/core/step.py ``fast_step_sharded`` and of the general loop's
    per-shard dispatch). Returns the new blocks and the substep count.

    Every block runs the unsharded loop's work in its order, through the
    per-shard wrappers of ``parallel/shard_kernels.py``; the dt is
    reduced over the blocks on the host, so the substep count is the
    unsharded one. After each substep the stack's halo is exchanged, so
    at the start of every substep every cell of every block, halo
    included, holds the unsharded value, and the column-local and
    elementwise work gives each cell the unsharded bits. The boundary
    ring is taken from global positions. Derived fields that the
    epilogue writes only on a block's interior (w_real, the 10 m winds)
    are exact at owned cells, not at a block's inner edge."""
    adv_names = tuple(adv_names)
    mp = options.physics.microphysics
    mpdata = options.physics.advection == C.ADV_MPDATA
    _check_species(mp, mpdata, adv_names)
    thompson = mp == C.MP_THOMPSON
    dqdts = dqdts or [{} for _ in states]
    adv = options.adv

    states = [diagnostic_update(s, g, full=False)
              for s, g in zip(states, geoms)]
    dt_static = sharded_dt(states, geoms, options.run.cfl_reduction_factor,
                           options.run.cfl_strictness)

    stacks = [torch.stack([s[k] for k in adv_names]) for s in states]
    spares = [torch.empty_like(q) for q in stacks]
    pressure = [s["pressure"].contiguous() for s in states]
    exner = [s["exner"].contiguous() for s in states]
    # SB04 takes the interface thickness, Thompson the mass-level one
    # (icar_tpu/core/step.py:996)
    dz_mp = [(g.dz_mass if thompson else g.dz_interface).contiguous()
             for g in geoms]
    winds = [kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
             for s, g in zip(states, geoms)]
    floors = [torch.as_tensor(limit_floors(adv_names), device=q.device)
              for q in stacks]
    if thompson:
        smap = mp_thompson.stack_smap(adv_names)
        tparams = thompson_params(options)
    else:
        species = [adv_names.index(k) for k in MP_SPECIES]

    tend = None
    if any(k in d for d in dqdts for k in adv_names):
        tend = [torch.stack([d[k] if k in d else torch.zeros_like(s[k])
                             for k in adv_names])
                for s, d in zip(states, dqdts)]
        bmask = layout.boundary_masks()
        floor_b = [f[:, None, None, None] for f in floors]
        no_floor = [torch.full_like(f, -np.inf) for f in floor_b]

    if mpdata:
        # the general loop accumulates in the state, substep by substep
        rain = [s["precipitation"].clone() for s in states]
        snow = [s["snowfall"].clone() for s in states]
        if thompson:
            graupel = [s["graupel"].clone() for s in states]
    else:
        rain = [torch.zeros_like(s["precipitation"]) for s in states]
        snow = [torch.zeros_like(r) for r in rain]
    t = np.float32(0.0)
    end_time = np.float32(seconds)
    n = 0
    while t < end_time - np.float32(1e-3):
        dt = min(dt_static, end_time - t)
        near_end = bool((end_time - t) < dt * np.float32(2))
        # the near-end clamp folds into advection unless forcing follows
        clamp = near_end and tend is None
        if mpdata:
            th = smap[0] if thompson else species[0]
            states = [diagnostic_update({**s, "potential_temperature": q[th]},
                                        g, needs=SUBSTEP_NEEDS)
                      for s, q, g in zip(states, stacks, geoms)]
            if thompson:
                sk.thompson_stack_sharded(stacks, smap, exner, pressure,
                                          dz_mp, dt, rain, snow, graupel,
                                          tparams)
            else:
                c2r, c2s = formation_rates(dt)
                sk.mp_simple_sharded(
                    *([q[i] for q in stacks] for i in species), pressure,
                    exner, dz_mp, rain, snow, dt, c2r, c2s,
                    rho=[s["density"] for s in states])
            sk.advect_mpdata_sharded(layout, stacks, winds, dt,
                                     adv.mpdata_order,
                                     adv.flux_corrected_transport, floors,
                                     clamp, spares)
        else:
            c2r, c2s = formation_rates(dt)
            sk.mp_simple_sharded(*([q[i] for q in stacks] for i in species),
                                 pressure, exner, dz_mp, rain, snow, dt, c2r,
                                 c2s)
            sk.advect_upwind_sharded(layout, stacks, winds, dt, floors, clamp,
                                     spares)
        stacks, spares = spares, stacks
        if tend is not None:
            # boundary-ring relaxation of the advected species (apply_
            # forcing, domain_obj.f90:2400-2428), then the near-end clamp
            stacks = [torch.maximum(q + te * (float(dt) * m),
                                    fb if near_end else nf)
                      for q, te, m, fb, nf in zip(stacks, tend, bmask,
                                                  floor_b, no_floor)]
        layout.exchange(stacks)
        t = np.float32(t + dt)
        n += 1

    out = []
    for b, (s, q, g) in enumerate(zip(states, stacks, geoms)):
        s = dict(s)
        for i, k in enumerate(adv_names):
            s[k] = q[i]
        if mpdata:
            s["precipitation"] = rain[b]
            s["snowfall"] = snow[b]
            if thompson:
                s["graupel"] = graupel[b]
        else:
            s["precipitation"] = s["precipitation"] + rain[b]
            s["snowfall"] = s["snowfall"] + snow[b]
        out.append(diagnostic_update(s, g, full=True))
    return out, n

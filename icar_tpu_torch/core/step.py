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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import kernels
from ..physics import mp_thompson
from ..physics.mp_simple import formation_rates
from ..physics.thompson_tables import ThompsonParams
from .diagnostics import compute_dt, diagnostic_update

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


def boundary_mask(ny: int, nx: int, device) -> torch.Tensor:
    """1 on the lateral domain boundary ring, 0 inside."""
    m = torch.zeros((ny, nx), dtype=torch.float32, device=device)
    m[0, :] = 1.0
    m[-1, :] = 1.0
    m[:, 0] = 1.0
    m[:, -1] = 1.0
    return m


def limit_floors(adv_names: Sequence[str]) -> np.ndarray:
    """Per-species near-end floor: 0 for limited fields, -inf otherwise."""
    return np.asarray([0.0 if k in LIMITED_FIELDS else -np.inf
                       for k in adv_names], np.float32)


def quantized_dt(u, v, w, dz_levels, dx, cfl_reduction,
                 cfl_strictness) -> np.float32:
    """The CFL dt capped at MAX_DT and quantized to 1/64 s (exact in f32),
    so the substep count does not depend on reduction order
    (icar_tpu/core/step.py quantized_dt). Returned on the host."""
    dt = compute_dt(u, v, w, dz_levels, dx, cfl_reduction, cfl_strictness)
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


def run_interval(state: Dict[str, torch.Tensor], geom, options,
                 adv_names: Sequence[str], seconds: float,
                 dqdt: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Integrate ``state`` over one interval of ``seconds``; returns the new
    state and the number of substeps. ``geom`` holds torch tensors;
    ``dqdt`` maps advected species to boundary forcing tendencies."""
    adv_names = tuple(adv_names)
    mp = options.physics.microphysics
    mpdata = options.physics.advection == C.ADV_MPDATA
    _check_species(mp, mpdata, adv_names)
    thompson = mp == C.MP_THOMPSON
    dqdt = dqdt or {}
    device = state["pressure"].device
    adv = options.adv

    state = diagnostic_update(state, geom, full=False)
    dt_static = quantized_dt(state["u"], state["v"], state["w"],
                             geom.dz_levels, geom.dx,
                             options.run.cfl_reduction_factor,
                             options.run.cfl_strictness)

    stack = torch.stack([state[k] for k in adv_names])
    spare = torch.empty_like(stack)
    pressure = state["pressure"].contiguous()
    exner = state["exner"].contiguous()
    # SB04 takes the interface thickness, Thompson the mass-level one
    # (icar_tpu/core/step.py:996)
    dz_mp = (geom.dz_mass if thompson else geom.dz_interface).contiguous()
    winds = kernels.prepare_advect_winds(state["u"], state["v"], state["w"],
                                         geom)
    floors = torch.as_tensor(limit_floors(adv_names), device=device)
    if thompson:
        smap = mp_thompson.stack_smap(adv_names)
        tparams = thompson_params(options)
    else:
        species = [adv_names.index(k) for k in MP_SPECIES]

    tend = None
    if any(k in dqdt for k in adv_names):
        tend = torch.stack([dqdt[k] if k in dqdt
                            else torch.zeros_like(state[k])
                            for k in adv_names])
        bmask = boundary_mask(geom.ny, geom.nx, device)
        floor_b = floors[:, None, None, None]
        no_floor = torch.full_like(floor_b, -np.inf)

    if mpdata:
        # the general loop accumulates in the state, substep by substep
        rain = state["precipitation"].clone()
        snow = state["snowfall"].clone()
        if thompson:
            graupel = state["graupel"].clone()
    else:
        rain = torch.zeros((geom.ny, geom.nx), dtype=torch.float32,
                           device=device)
        snow = torch.zeros_like(rain)
    t = np.float32(0.0)
    end_time = np.float32(seconds)
    n = 0
    while t < end_time - np.float32(1e-3):
        dt = min(dt_static, end_time - t)
        near_end = bool((end_time - t) < dt * np.float32(2))
        # the near-end clamp folds into advection unless forcing follows
        clamp = near_end and tend is None
        if mpdata:
            th = stack[smap[0] if thompson else species[0]]
            state["potential_temperature"] = th
            state = diagnostic_update(state, geom, needs=SUBSTEP_NEEDS)
            if thompson:
                kernels.mp_thompson_stack(stack, smap, exner, pressure,
                                          dz_mp, dt, rain, snow, graupel,
                                          tparams)
            else:
                c2r, c2s = formation_rates(dt)
                kernels.mp_simple_rho(*(stack[i] for i in species),
                                      pressure, exner, state["density"],
                                      dz_mp, rain, snow, dt, c2r, c2s)
            kernels.advect_mpdata(stack, winds, dt, adv.mpdata_order,
                                  adv.flux_corrected_transport, floors,
                                  clamp, out=spare)
        else:
            c2r, c2s = formation_rates(dt)
            kernels.mp_simple(*(stack[i] for i in species), pressure, exner,
                              dz_mp, rain, snow, dt, c2r, c2s)
            kernels.advect_upwind(stack, winds, dt, floors, clamp, out=spare)
        stack, spare = spare, stack
        if tend is not None:
            # boundary-ring relaxation of the advected species (apply_
            # forcing, domain_obj.f90:2400-2428), then the near-end clamp
            stack = torch.maximum(stack + tend * (float(dt) * bmask),
                                  floor_b if near_end else no_floor)
        t = np.float32(t + dt)
        n += 1

    state = dict(state)
    for i, k in enumerate(adv_names):
        state[k] = stack[i]
    if mpdata:
        state["precipitation"] = rain
        state["snowfall"] = snow
        if thompson:
            state["graupel"] = graupel
    else:
        state["precipitation"] = state["precipitation"] + rain
        state["snowfall"] = state["snowfall"] + snow
    state = diagnostic_update(state, geom, full=True)
    return state, n

"""One forcing interval: microphysics then upwind or MPDATA advection,
substep by substep, with or without column physics before them
(icar_tpu/core/step.py, which runs the SB04 + upwind case as ``fast_step``
on the TPU and the others as its general loop ``step``).

The substep loop runs on the host. Per interval: the partial diagnostics,
one CFL dt quantized to 1/64 s (read to the host once), the advected
species stacked in their natural (S, nz, ny, nx) layout, and the
loop-invariant advection winds. Per substep: the microphysics kernel
updates the stack in place, the advection kernel writes into a second
buffer (the two swap), and, when forcing tendencies are set, the boundary
ring relaxes towards them before the near-end floor clamp. SB04 with
upwind advection is the fast path: SB04 forms the density in its kernel
(K2) and the surface precipitation of the interval is added to the state
at its end. Otherwise (the general loop) the state's density is refreshed
each substep and the microphysics accumulates precipitation in the state
substep by substep -- SB04 (K3) on its five species with that density,
Thompson (K5) on its nine species with the mass-level thickness, WSM3,
WSM6 or Morrison (no kernel: plain PyTorch, ``plain_microphysics``) on
their four, seven or eleven, or Thompson-aerosol (mp=5: K5 as Thompson,
or aerosol-aware the plain ``thompson_aer_microphysics`` on its twelve;
then the effective radii, ``effective_radii``) -- and MPDATA (K4) or
upwind (K1) advects the stack. Density advection
(``run.advect_density``) and the microphysics throttle
(``mp.update_interval``) take SB04 + upwind to the general loop too. With
density the advection kernels run unchanged on operands weighted by the
density the substep began with (``kernels.density_winds``); under the
throttle the microphysics runs only on the substeps its float32 counter
makes due, over the counter's time (``Throttle``). Time is carried in
float32 as the JAX loop carries it, so the substep lengths and the
clamp's timing match. On CPU tensors the kernels' plain versions run.

Forcing tendencies of fields other than the advected species (a
file-driven run's u, v, w, pressure and 2-D fields; full-field forcing)
take the general loop, SB04 + upwind included (K3 with the state's density,
then K1), as the JAX step leaves its fast path for them. With forced
winds the CFL dt is computed anew from them every substep (one read to the
host a substep) and the advection's wind operands are prepared anew; with
forced pressure the pressure-derived fields are refreshed every substep
(``substep_needs``). After the advection u, v, w, pressure and the 2-D
fields take ``tend * dt`` over the whole field (``apply_forcing``). On
blocks no field outside the stack needs an exchange for this: the
tendencies are scattered with their halos, so ``apply_forcing`` gives a
halo cell its owner's update; the dt is the blocks' reduced one
(``sharded_dt``); and what is formed from the forced fields (the wind
operands, the pressure-derived fields, w_real on ``Shard.interior``)
reads a cell's own column and the faces its block holds.

Both loops run on a list of blocks (``run_blocks``): the whole domain is
one block, and a model sharded over a device mesh holds one per shard
(``parallel/mesh.py``), each with its halo, exchanged after every
advection; the kernels run per block through
``parallel/shard_kernels.py`` (each block weights its own operands by its
density, halo included). Without column physics the interval runs
``run_interval_sharded``; with it (radiation, the surface, the PBL,
convection; ``core/physics_step.py``) ``run_interval_physics``, with
either microphysics and either advection (bench.py --config conus is
that loop on a mesh over every card). Without
microphysics (mp=0: theta and water vapour advected) or without advection
(advection=0: the species stacked but not advected) either loop runs the
general loop's work without that scheme's kernel, as the JAX step does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import kernels
from ..ops.pointwise import inv
from ..physics import (mp_morrison, mp_thompson, mp_wsm3, mp_wsm6,
                       pbl_simple, rrtmg_lw)
from ..physics.mp_simple import formation_rates
from ..physics.thompson_tables import ThompsonParams
from ..parallel import shard_kernels as sk
from ..parallel.mesh import Layout, host_max, single
from . import physics_step as ps
from .diagnostics import (cfl_maxima, compute_dt, diagnostic_update,
                          dt_from_maxima)

# fields clamped to >= 0 near the end of an interval (enforce_limits,
# domain_obj.f90:2228)
LIMITED_FIELDS = (
    "water_vapor", "cloud_water", "cloud_ice", "rain_mass", "snow_mass",
    "graupel_mass", "cloud_number", "ice_number", "rain_number",
    "snow_number", "graupel_number",
)

# the species SB04 updates, in the kernel's argument order
MP_SPECIES = ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "snow_mass")

# fields whose forcing tendency is applied everywhere; the other 3-D fields,
# the advected species among them, are forced at the lateral boundaries
# only (apply_forcing, domain_obj.f90:2383-2448)
FULL_FIELD_FORCED = ("u", "v", "w", "pressure")


def full_field_forcing(dqdt, adv_names) -> bool:
    """Whether the tendencies ``dqdt`` force a field outside the advected
    species, which takes the JAX step off its fast path."""
    return any(k not in adv_names for k in dqdt)


def forcing_varies(dqdt) -> Tuple[bool, bool]:
    """(pressure_varies, winds_vary): whether ``dqdt`` forces the
    pressure, and any of the winds, so that they change within the
    interval (icar_tpu/core/step.py step)."""
    return "pressure" in dqdt, any(k in dqdt for k in ("u", "v", "w"))


def apply_forcing(state, dqdt, dt, bmask, adv_names):
    """Integrate the forcing tendencies of the fields outside the species
    stack for ``dt`` seconds (icar_tpu/core/step.py apply_forcing): u, v,
    w, pressure and every 2-D field over the whole field, any other 3-D
    field on the boundary ring (``bmask``). The advected species, which
    the stack carries, are left to the caller."""
    s = dict(state)
    dt = float(dt)
    for name, tend in dqdt.items():
        if name not in s or name in adv_names:
            continue
        if name in FULL_FIELD_FORCED or s[name].dim() == 2:
            s[name] = s[name] + tend * dt
        else:
            s[name] = s[name] + tend * dt * bmask
    return s


def thompson_params(options) -> ThompsonParams:
    """The Thompson parameters of ``options.mp`` (icar_tpu/core/step.py
    builds them the same way)."""
    return ThompsonParams(**{f.name: getattr(options.mp, f.name)
                             for f in dataclasses.fields(ThompsonParams)})


# the species the registry advects without microphysics
# (icar_tpu/registry.py:377-378)
NO_MP_SPECIES = ("potential_temperature", "water_vapor")

# Thompson (mp=1) and Thompson-aerosol (mp=5): without the aerosol-aware
# option both run K5, mp=5 then forming the effective radii
THOMPSON_MP = (C.MP_THOMPSON, C.MP_THOMPSON_AER)

# the schemes no TPU kernel runs, plain PyTorch on the card: mp -> module;
# each module's name is the stage the loops time the scheme under
PLAIN_MP = {C.MP_WSM3: mp_wsm3, C.MP_WSM6: mp_wsm6,
            C.MP_MORRISON: mp_morrison}


def aerosol_aware(options) -> bool:
    """Whether ``options`` run the aerosol-aware Thompson-Eidhammer scheme
    (mp=5 with ``mp.use_aerosol_aware``): the registry then adds the
    droplet and aerosol numbers, and the JAX step runs the scheme's jnp
    path (icar_tpu/core/step.py:970-1036)."""
    return (options.physics.microphysics == C.MP_THOMPSON_AER
            and bool(options.mp.use_aerosol_aware))


def plain_mp_stage(mp: int) -> str:
    """The timer's stage of the plain scheme ``mp`` (mp_wsm3, mp_wsm6,
    mp_morrison)."""
    return PLAIN_MP[mp].__name__.rsplit(".", 1)[1]


def plain_microphysics(mp: int, q, adv_names, s, dz, dt, rain, snow,
                       graupel=None):
    """WSM3, WSM6 or Morrison (``mp``) over ``dt`` seconds on the species
    stack ``q`` (rows ``adv_names``), with the state ``s``'s exner and
    pressure, its refreshed density (WSM3, WSM6; Morrison forms its own)
    and w_real (WSM3; Morrison takes it unread) and the mass-level
    thickness ``dz`` (icar_tpu/core/step.py:945-958, 1077-1123). The
    scheme's outputs are copied into the stack's rows and the accumulators
    ``rain``, ``snow`` and (WSM6, Morrison) ``graupel`` are updated in
    place, as the other schemes' kernels update theirs."""
    row = {k: q[i] for i, k in enumerate(adv_names)}
    dt_t = torch.full((), float(dt), dtype=torch.float32, device=q.device)
    ex, p = s["exner"], s["pressure"]
    if mp == C.MP_WSM3:
        out = mp_wsm3.wsm3(*(row[k] for k in mp_wsm3.SPECIES),
                           s["w_real"], ex, p, dz, s["density"], dt_t,
                           rain, snow)
        acc = (rain, snow)
    elif mp == C.MP_WSM6:
        out = mp_wsm6.wsm6(*(row[k] for k in mp_wsm6.SPECIES), ex, p, dz,
                           s["density"], dt_t, rain, snow, graupel)
        acc = (rain, snow, graupel)
    else:
        out = mp_morrison.mp_morrison(
            *(row[k] for k in mp_morrison.SPECIES), ex, p, dz,
            s.get("w_real"), dt_t, rain, snow, graupel)
        acc = (rain, snow, graupel)
    species = PLAIN_MP[mp].SPECIES
    for k, v in zip(species, out):
        row[k].copy_(v)
    for a, v in zip(acc, out[len(species):]):
        a.copy_(v)


def thompson_aer_microphysics(q, adv_names, s, dz, dt, rain, snow, graupel,
                              params):
    """The aerosol-aware Thompson-Eidhammer scheme over ``dt`` seconds on
    the species stack ``q`` (rows ``adv_names``: the twelve of
    ``mp_thompson.AER_SPECIES``), with the state ``s``'s exner, pressure,
    surface CCN flux ``nwfa2d`` (``nwfa2d * dt`` added to the lowest
    level's nwfa the scheme reads) and w_real (zeros where the state has
    none), and the mass-level thickness ``dz`` (icar_tpu/core/step.py:
    1020-1036). Its outputs are copied into the stack's rows and the
    accumulators updated in place, as ``plain_microphysics`` does."""
    row = {k: q[i] for i, k in enumerate(adv_names)}
    nwfa = row["nwfa"]
    if "nwfa2d" in s:
        nwfa = torch.cat([(nwfa[0] + s["nwfa2d"] * float(dt))[None],
                          nwfa[1:]])
    w = s["w_real"] if "w_real" in s else torch.zeros_like(nwfa)
    out = mp_thompson.mp_thompson_aer(
        *(row[k] for k in mp_thompson.SPECIES), row["cloud_number"], nwfa,
        row["nifa"], s["exner"], s["pressure"], dz, float(dt), rain, snow,
        graupel, w=w, params=params)
    for k, v in zip(mp_thompson.AER_SPECIES, out):
        row[k].copy_(v)
    for a, v in zip((rain, snow, graupel), out[12:]):
        a.copy_(v)


def effective_radii(s, q, adv_names, params, aware: bool):
    """``s`` with the effective radii mp=5 forms after its microphysics
    (``mp_thompson.calc_effect_rad`` on the stack's updated rows, with the
    droplet number when ``aware``; icar_tpu/core/step.py:1003-1011,
    1066-1073), which RRTMG reads at its next call."""
    row = {k: q[i] for i, k in enumerate(adv_names)}
    s = dict(s)
    s["re_cloud"], s["re_ice"], s["re_snow"] = mp_thompson.calc_effect_rad(
        row["potential_temperature"] * s["exner"], s["pressure"],
        row["water_vapor"], row["cloud_water"], row["cloud_ice"],
        row["ice_number"], row["snow_mass"], params,
        nc=row["cloud_number"] if aware else None)
    return s


def _check_species(mp: int, adv: int, adv_names, aware: bool = False):
    """Raise ValueError unless the microphysics, the advection and the
    advected species are a pair that the loop runs (which options run is
    the options' validation's decision, ``Options.validate``). With
    advection=0 the registry's species ride the stack unadvected;
    ``aware``: mp=5's aerosol-aware scheme, with its twelve."""
    want = {C.MP_NONE: NO_MP_SPECIES, C.MP_SIMPLE: MP_SPECIES,
            C.MP_THOMPSON: mp_thompson.SPECIES,
            C.MP_THOMPSON_AER: (mp_thompson.AER_SPECIES if aware
                                else mp_thompson.SPECIES),
            **{k: m.SPECIES for k, m in PLAIN_MP.items()}}.get(mp)
    name = {C.ADV_NONE: "no", C.ADV_UPWIND: "upwind",
            C.ADV_MPDATA: "MPDATA"}.get(adv)
    if want is None or name is None or sorted(adv_names) != sorted(want):
        raise ValueError(
            f"run_interval: microphysics={mp} with {name or adv} "
            f"advection and the species {tuple(adv_names)} is not a "
            f"configuration it runs")


def limited_rest(state, adv_names) -> Tuple[str, ...]:
    """The limited fields the state holds outside the species stack,
    which the general loop clamps to >= 0 near an interval's end
    (icar_tpu/core/step.py:1718-1719). Under advection=0 the registry's
    species are excluded too (the JAX loop keeps them off its stack and
    out of this clamp alike)."""
    return tuple(k for k in LIMITED_FIELDS
                 if k in state and k not in adv_names)


def _clamp_rest(state, rest):
    """``state`` with each field of ``rest`` clamped to >= 0."""
    if not rest:
        return state
    s = dict(state)
    for k in rest:
        s[k] = torch.clamp(s[k], min=0.0)
    return s


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


def path_kernels(options, full_forcing: bool = False) -> Tuple[str, ...]:
    """The kernels (names of ``kernels.LAUNCHES``) the interval loop
    launches for ``options`` on the card: the microphysics' (K5 for
    Thompson and mp=5's constant-Nc mode; none with mp=0, nor with WSM3,
    WSM6, Morrison or mp=5's aerosol-aware scheme, which run as plain
    PyTorch), the advection's, then with density advection the fold's
    (``kernels.density_winds``; none of the three with advection=0).
    ``full_forcing``: under forcing tendencies outside the advected
    species (``full_field_forcing``). SB04 + upwind takes the fast loop's
    K2 only without these, density advection, the microphysics throttle
    and the column physics; else the general loop's K3."""
    ph = options.physics
    mpdata = ph.advection == C.ADV_MPDATA
    path = []
    if ph.microphysics in THOMPSON_MP and not aerosol_aware(options):
        path.append("mp_thompson")
    elif ph.microphysics == C.MP_SIMPLE:
        path.append("mp_simple_rho"
                    if mpdata or full_forcing or general_loop(options)
                    else "mp_simple")
    if ph.advection != C.ADV_NONE:
        path.append("advect_mpdata" if mpdata else "advect_upwind")
        if options.run.advect_density:
            path.append("density_fold")
    return tuple(path)


def mp_stage_name(options, full_forcing: bool = False) -> Optional[str]:
    """The timer's stage of the interval loops' microphysics (``timer`` of
    ``run_interval_sharded`` and ``run_interval_physics``): the kernel's
    name (mp_simple, mp_simple_rho, mp_thompson), the plain scheme's
    (mp_wsm3, mp_wsm6, mp_morrison, mp_thompson_aer), or None with mp=0."""
    mp = options.physics.microphysics
    if mp in PLAIN_MP:
        return plain_mp_stage(mp)
    if aerosol_aware(options):
        return "mp_thompson_aer"
    if mp in THOMPSON_MP or mp == C.MP_SIMPLE:
        return path_kernels(options, full_forcing)[0]
    return None


def general_loop(options) -> bool:
    """Whether options of SB04 + upwind leave the fast loop for the general
    one, as the JAX step does (icar_tpu/core/step.py:146-160): density
    advection, the microphysics throttle or the column physics; and any
    loop without microphysics or without advection (the fast path needs
    both), or with a microphysics other than SB04 and Thompson (WSM3,
    WSM6, Morrison: only the general loop runs them)."""
    ph = options.physics
    return (options.run.advect_density
            or float(options.mp.update_interval) > 0
            or column_physics(options)
            or ph.microphysics == C.MP_NONE
            or ph.microphysics in PLAIN_MP
            or ph.advection == C.ADV_NONE)


class Throttle:
    """A scheme's float32 time counter (icar_tpu/core/step.py:1124-1137
    for the microphysics; the surface's likewise). It starts full at every
    interval (:1790-1795), so the first substep runs the scheme; each
    substep adds its dt, and once the counter reaches the update interval
    less 1e-6 s the scheme runs over the counter's time and the counter
    restarts at 0. So the first call of an interval integrates the update
    interval plus dt. With an interval <= 0 the scheme runs every substep
    over its dt."""

    def __init__(self, interval):
        self.interval = float(interval)
        # the JAX loop compares in float32
        self.due = np.float32(self.interval - 1e-6)
        self.elapsed = np.float32(self.interval)

    def step(self, dt):
        """The time the scheme integrates in a substep of ``dt``, or None
        when it does not run."""
        if self.interval <= 0:
            return dt
        self.elapsed = np.float32(self.elapsed + dt)
        if self.elapsed < self.due:
            return None
        ran, self.elapsed = self.elapsed, np.float32(0.0)
        return ran


def path_halo(options) -> int:
    """The halo a block of the interval loop needs for ``options``: what
    the path's advection kernel reads (the microphysics reads none)."""
    if options.physics.advection == C.ADV_MPDATA:
        return sk.mpdata_halo(options.adv.mpdata_order,
                              options.adv.flux_corrected_transport)
    return sk.UPWIND_HALO


def column_physics(options) -> bool:
    """Whether ``options`` run column physics (radiation, a surface
    scheme, a boundary layer or convection) before the microphysics."""
    ph = options.physics
    return (ph.radiation != C.RA_NONE or ph.landsurface != C.LSM_NONE
            or ph.watersurface != C.WATER_NONE
            or ph.boundarylayer != C.PBL_NONE
            or ph.convection != C.CU_NONE)


def substep_needs(options, pressure_varies: bool = False,
                  winds_vary: bool = False) -> frozenset:
    """The derived fields the general loop refreshes each substep: those a
    configured scheme reads whose inputs change within the interval
    (icar_tpu/core/step.py ``_substep_needs``). Density and temperature
    follow theta, and RRTMG's interface temperature; the pressure-derived
    fields follow a forced pressure (``pressure_varies``), the mass-level
    winds forced winds (``winds_vary``). Under YSU the loop refreshes
    every field instead (``run_interval_physics``)."""
    ph = options.physics
    surface = (ph.landsurface != C.LSM_NONE
               or ph.watersurface != C.WATER_NONE)
    rrtmg = ph.radiation == C.RA_RRTMG
    needs = set()
    if (ph.microphysics != C.MP_NONE or ph.boundarylayer != C.PBL_NONE
            or ph.convection != C.CU_NONE or rrtmg or surface
            or options.run.advect_density):
        needs.add("density")
    if (rrtmg or surface or ph.boundarylayer == C.PBL_YSU
            or ph.convection != C.CU_NONE):
        needs.add("temperature")
    if rrtmg:
        needs.add("temperature_interface")
    if pressure_varies:
        needs.add("exner")
        if (surface or ph.convection != C.CU_NONE or rrtmg
                or ph.boundarylayer != C.PBL_NONE):
            needs.add("pressure_interface")
            needs.add("surface_pressure")
    if winds_vary and (surface or ph.convection != C.CU_NONE
                       or ph.boundarylayer != C.PBL_NONE):
        needs.add("uv_mass")
    return frozenset(needs)


def run_interval(state: Dict[str, torch.Tensor], geom, options,
                 adv_names: Sequence[str], seconds: float,
                 dqdt: Optional[Dict[str, torch.Tensor]] = None,
                 time_aux: Optional[Dict[str, float]] = None, timer=None,
                 cdf=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Integrate ``state`` over one interval of ``seconds``; returns the new
    state and the number of substeps. ``geom`` holds torch tensors;
    ``dqdt`` maps advected species to boundary forcing tendencies;
    ``time_aux`` holds the interval's ``day_of_year0`` and
    ``year_length`` (the solar geometry of the radiation and Noah-MP).
    The whole domain is one block (``run_blocks`` on a one-shard layout;
    ``timer`` and ``cdf``: see there)."""
    layout = single(state["pressure"].device, geom.ny, geom.nx)
    (state,), n = run_blocks(layout, [state], [geom], options, adv_names,
                             seconds, [dqdt or {}], time_aux, timer, cdf)
    return state, n


def run_blocks(layout: Layout, states: List[Dict[str, torch.Tensor]],
               geoms, options, adv_names: Sequence[str], seconds: float,
               dqdts=None, time_aux: Optional[Dict[str, float]] = None,
               timer=None, cdf=None
               ) -> Tuple[List[Dict[str, torch.Tensor]], int]:
    """One interval of a domain held as blocks (``mesh.Layout``; one block
    per shard, or the whole domain as one): ``run_interval_physics`` with
    column physics, else ``run_interval_sharded`` (``time_aux`` and
    ``cdf`` are the column physics'). Returns the new blocks and the
    substep count."""
    if column_physics(options):
        return run_interval_physics(layout, states, geoms, options,
                                    adv_names, seconds, dqdts, time_aux,
                                    timer, cdf)
    return run_interval_sharded(layout, states, geoms, options, adv_names,
                                seconds, dqdts, timer)


def run_interval_sharded(layout: Layout, states: List[Dict[str, torch.Tensor]],
                         geoms, options, adv_names: Sequence[str],
                         seconds: float, dqdts=None, timer=None
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
    ring is taken from global positions, and the fields formed on the
    domain's interior only (w_real, the 10 m winds) on each block's part
    of it (``mesh.Shard.interior``), halo included.

    WSM3, WSM6 and Morrison run in the general loop as plain PyTorch
    (``plain_microphysics``) on the stack's rows, with the mass-level
    thickness; WSM3 reads w_real, formed in the interval's first partial
    diagnostics (and each substep under forced winds), as the JAX loop
    forms it for mp=6 (icar_tpu/core/step.py:1639-1645, 1748). So does
    mp=5's aerosol-aware scheme (``thompson_aer_microphysics``, block by
    block: it is column-local) on its twelve rows, reading w_real as the
    state holds it; mp=5 without the option runs K5 as Thompson does.
    Either mode then forms the effective radii (``effective_radii``).
    ``timer(stage)``, when given, returns a context manager around each
    stage's work (``time_paths.StageTimer``: diagnostics, the
    microphysics' -- mp_simple, mp_simple_rho, mp_thompson,
    mp_thompson_aer, mp_wsm3, mp_wsm6 or mp_morrison --, advection)."""
    stage = timer or (lambda name: contextlib.nullcontext())
    adv_names = tuple(adv_names)
    mp = options.physics.microphysics
    mpdata = options.physics.advection == C.ADV_MPDATA
    advect = options.physics.advection != C.ADV_NONE
    aware = aerosol_aware(options)
    _check_species(mp, options.physics.advection, adv_names, aware)
    # K5: Thompson, and mp=5 without the aerosol-aware option
    thompson = mp in THOMPSON_MP and not aware
    radii = mp == C.MP_THOMPSON_AER
    sb04 = mp == C.MP_SIMPLE
    plain = mp in PLAIN_MP
    # the schemes with a graupel accumulator
    graupel_acc = mp in THOMPSON_MP or mp in (C.MP_WSM6, C.MP_MORRISON)
    # WSM3 reads w_real (icar_tpu/core/step.py:1639)
    w_real_cfg = mp == C.MP_WSM3
    dqdts = dqdts or [{} for _ in states]
    adv = options.adv
    full = full_field_forcing(dqdts[0], adv_names)
    pressure_varies, winds_vary = forcing_varies(dqdts[0]) if full \
        else (False, False)

    inner = [sh.interior for sh in layout.shards]
    states = [diagnostic_update(s, g, full=False, with_w_real=w_real_cfg,
                                interior=i)
              for s, g, i in zip(states, geoms, inner)]
    dt_static = sharded_dt(states, geoms, options.run.cfl_reduction_factor,
                           options.run.cfl_strictness)

    stacks = [torch.stack([s[k] for k in adv_names]) for s in states]
    spares = [torch.empty_like(q) for q in stacks]
    pressure = [s["pressure"].contiguous() for s in states]
    exner = [s["exner"].contiguous() for s in states]
    # SB04 takes the interface thickness, the other schemes the mass-level
    # one (icar_tpu/core/step.py:952, 996, 1085, 1113)
    dz_mp = [(g.dz_interface if sb04 else g.dz_mass).contiguous()
             for g in geoms]
    if not winds_vary:
        winds = [kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
                 for s, g in zip(states, geoms)]
    floors = [torch.as_tensor(limit_floors(adv_names), device=q.device)
              for q in stacks]
    if mp in THOMPSON_MP:
        smap = mp_thompson.stack_smap(adv_names)
        tparams = thompson_params(options)
    elif sb04:
        species = [adv_names.index(k) for k in MP_SPECIES]

    tend = None
    if any(k in d for d in dqdts for k in adv_names):
        tend = [torch.stack([d[k] if k in d else torch.zeros_like(s[k])
                             for k in adv_names])
                for s, d in zip(states, dqdts)]
    if tend is not None or full:
        bmask = layout.boundary_masks()
        floor_b = [f[:, None, None, None] for f in floors]
        no_floor = [torch.full_like(f, -np.inf) for f in floor_b]
    rest = limited_rest(states[0], adv_names)

    # the general loop (MPDATA, Thompson, full-field forcing, density
    # advection or the microphysics throttle) accumulates in the state,
    # substep by substep; the upwind fast path adds the interval's sum
    density = options.run.advect_density
    general = mpdata or mp in THOMPSON_MP or full or general_loop(options)
    throttle = Throttle(options.mp.update_interval)
    mp_stage = mp_stage_name(options, full)
    if general:
        # the density follows theta (K3 reads it), the pressure-derived
        # fields a forced pressure
        needs = substep_needs(options, pressure_varies, winds_vary)
        if mp != C.MP_NONE:
            rain = [s["precipitation"].clone() for s in states]
            snow = [s["snowfall"].clone() for s in states]
        graupel = ([s["graupel"].clone() for s in states] if graupel_acc
                   else [None] * len(states))
    else:
        rain = [torch.zeros_like(s["precipitation"]) for s in states]
        snow = [torch.zeros_like(r) for r in rain]
    t = np.float32(0.0)
    end_time = np.float32(seconds)
    n = 0
    while t < end_time - np.float32(1e-3):
        if winds_vary:
            # the CFL dt of the forced winds, read to the host every
            # substep, and their advection operands
            dt_static = sharded_dt(states, geoms,
                                   options.run.cfl_reduction_factor,
                                   options.run.cfl_strictness)
            winds = [kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
                     for s, g in zip(states, geoms)]
        dt = min(dt_static, end_time - t)
        near_end = bool((end_time - t) < dt * np.float32(2))
        # the near-end clamp folds into advection unless forcing follows
        clamp = near_end and tend is None
        if general:
            th = adv_names.index("potential_temperature")
            with stage("diagnostics"):
                states = [diagnostic_update(
                    {**s, "potential_temperature": q[th]}, g, needs=needs,
                    with_w_real=w_real_cfg and winds_vary, interior=i)
                    for s, q, g, i in zip(states, stacks, geoms, inner)]
            if pressure_varies:
                pressure = [s["pressure"].contiguous() for s in states]
                exner = [s["exner"].contiguous() for s in states]
        # the microphysics' time this substep (None: the throttle waits)
        mp_dt = throttle.step(dt) if mp_stage else None
        if mp_dt is not None:
            with stage(mp_stage):
                if thompson:
                    sk.thompson_stack_sharded(stacks, smap, exner, pressure,
                                              dz_mp, mp_dt, rain, snow,
                                              graupel, tparams)
                elif aware:
                    for b, s in enumerate(states):
                        thompson_aer_microphysics(
                            stacks[b], adv_names, s, dz_mp[b], mp_dt,
                            rain[b], snow[b], graupel[b], tparams)
                elif sb04:
                    c2r, c2s = formation_rates(mp_dt)
                    sk.mp_simple_sharded(
                        *([q[i] for q in stacks] for i in species),
                        pressure, exner, dz_mp, rain, snow, mp_dt, c2r, c2s,
                        rho=[s["density"] for s in states] if general
                        else None)
                else:
                    for b, s in enumerate(states):
                        plain_microphysics(mp, stacks[b], adv_names, s,
                                           dz_mp[b], mp_dt, rain[b],
                                           snow[b], graupel[b])
                if radii:
                    states = [effective_radii(s, q, adv_names, tparams,
                                              aware)
                              for s, q in zip(states, stacks)]
        if advect:
            with stage("advection"):
                # density advection: the operands weighted by the density
                # the substep began with (the microphysics does not
                # refresh it)
                awinds = ([kernels.density_winds(w, s["density"])
                           for w, s in zip(winds, states)] if density
                          else winds)
                if mpdata:
                    sk.advect_mpdata_sharded(layout, stacks, awinds, dt,
                                             adv.mpdata_order,
                                             adv.flux_corrected_transport,
                                             floors, clamp, spares)
                else:
                    sk.advect_upwind_sharded(layout, stacks, awinds, dt,
                                             floors, clamp, spares)
            stacks, spares = spares, stacks
        if full:
            states = [apply_forcing(s, d, dt, m, adv_names)
                      for s, d, m in zip(states, dqdts, bmask)]
        if tend is not None:
            stacks = [_relax(q, te, dt, m, fb if near_end else nf, advect)
                      for q, te, m, fb, nf in zip(stacks, tend, bmask,
                                                  floor_b, no_floor)]
        if near_end:
            states = [_clamp_rest(s, rest) for s in states]
        layout.exchange(stacks)
        t = np.float32(t + dt)
        n += 1

    out = []
    for b, (s, q, g) in enumerate(zip(states, stacks, geoms)):
        s = dict(s)
        for i, k in enumerate(adv_names):
            s[k] = q[i]
        if general and mp != C.MP_NONE:
            s["precipitation"] = rain[b]
            s["snowfall"] = snow[b]
            if graupel_acc:
                s["graupel"] = graupel[b]
        elif not general:
            s["precipitation"] = s["precipitation"] + rain[b]
            s["snowfall"] = s["snowfall"] + snow[b]
        out.append(diagnostic_update(s, g, full=True, interior=inner[b]))
    return out, n


def _relax(q, tend, dt, bmask, floor, advected):
    """The boundary-ring relaxation of the species stack ``q`` towards its
    forcing (apply_forcing, domain_obj.f90:2400-2428), then the near-end
    clamp to ``floor``, as the JAX loop does on its stacked carry; under
    advection=0, where the JAX loop keeps the species off its stack,
    ``apply_forcing``'s own order and no clamp
    (icar_tpu/core/step.py:1718-1719)."""
    if not advected:
        return q + tend * float(dt) * bmask
    return torch.maximum(q + tend * (float(dt) * bmask), floor)


def run_interval_physics(layout: Layout,
                         states: List[Dict[str, torch.Tensor]], geoms,
                         options, adv_names: Sequence[str], seconds: float,
                         dqdts=None,
                         time_aux: Optional[Dict[str, float]] = None,
                         timer=None, cdf=None
                         ) -> Tuple[List[Dict[str, torch.Tensor]], int]:
    """One interval of the general loop with column physics on a domain
    held as blocks (``mesh.Layout``: the whole domain as one block, or one
    per shard with a halo of ``path_halo(options)``; icar_tpu/core/step.py
    ``step`` and ``physics_step`` :241-1232, :1613-1814, which the JAX
    package runs sharded under GSPMD). Returns the new blocks and the
    substep count. Before the loop: the partial diagnostics with w_real,
    one CFL dt (``sharded_dt``), the species stack and the advection
    winds. Per substep: the partial refresh (``substep_needs``; under YSU
    the full one), then ``core/physics_step.py``'s stages -- radiation
    (ra_simple; or RRTMG every ``rad.update_interval_rrtmg`` seconds by
    its ``Throttle``, its stored heating applied every substep), the
    surface every ``lsm.update_interval`` seconds of float32 model time
    (``Throttle``: its counter starts full, so the first substep runs it),
    the surface fluxes, the boundary layer (YSU or pbl_simple), convection
    (Tiedtke, Kain-Fritsch, NSAS or BMJ) --, then the rows of the stack a
    stage replaced are written back (Kain-Fritsch's rain and snow too);
    the microphysics (every ``mp.update_interval`` seconds likewise)
    updates the stack and the accumulators in place -- Thompson (K5) on
    its nine species (mp=5 too, then its effective radii, which the next
    RRTMG call reads; with the aerosol-aware option
    ``thompson_aer_microphysics`` on its twelve, w_real as the state
    holds it), SB04 (K3) on its five with the refreshed density
    and the interface thickness (the cloud ice the PBL and convection
    write stays in the state, unadvected, as in the JAX loop), or WSM3,
    WSM6 or Morrison (``plain_microphysics``; WSM3 with w_real, formed
    with the convection's) --, and K1,
    or K4 at the configured order and FCT, advects the stack into the
    second buffer with the near-end clamp folded in unless forcing
    follows, on density-weighted operands with ``advect_density``; the
    stack's halo is exchanged (``Layout.exchange``), then the water
    vapour's advection tendency, which the next substep's convection
    reads, is formed on the whole block.

    Every stage runs block by block through the per-shard wrappers
    (``parallel/shard_kernels.py``), with one set of throttles for the
    model (host counters of model time). The column physics is
    column-local: a halo column is real air whose inputs equal its
    owner's, so it comes out equal to its owner's column, and after the
    exchange every cell of every block holds the unsharded value. What a
    column takes from the domain is taken from the domain: the dt,
    pbl_simple's diffusion substep count (the largest of the blocks',
    ``parallel.mesh.host_max``), the boundary ring and the interior where
    w_real and the 10 m winds are formed (``mesh.Shard.interior``), and
    RRTMG's McICA draws (``physics_step.Statics``). The loops that read a
    count per call (the microphysics' sedimentation, Kain-Fritsch's
    feedback substeps) run each block to its own largest count; they leave
    a column past its own count as it is, so each column keeps its bits.

    Under full-field forcing (``full_field_forcing``) forced winds give a
    new dt (``sharded_dt`` over the blocks) and each block's wind operands
    every substep, and w_real in the refresh, a forced pressure its
    derived fields on each block (``substep_needs``), and
    ``apply_forcing`` follows the advection on each block, halo included
    (see ``run_interval_sharded``). The
    ``time_aux`` of ``run_interval`` is required with the radiation or
    Noah-MP.
    ``cdf`` is RRTMG's McICA draw (``physics.rrtmg_lw.TorchCdf`` by
    default). pbl_simple's substep count is one host read per block and
    substep, WSM3's, WSM6's and Morrison's sedimentation counts two, three
    and one a block's call, Kain-Fritsch's feedback substeps one for each
    closure trip it runs and one more; YSU, RRTMG, NSAS and BMJ read
    nothing back.
    ``timer(stage)``, when given, returns a context manager around each
    stage's work over all blocks (``time_paths.StageTimer``:
    diagnostics, radiation, or RRTMG's cloud_fraction, radiation_sw,
    radiation_lw and radiation (the zenith and the heating), surface --
    with the lake its lake column, with Noah-MP its noahmp and glacier
    columns within it --, pbl or pbl_ysu, convection, restack,
    mp_thompson, mp_thompson_aer, mp_simple_rho, mp_wsm3, mp_wsm6 or
    mp_morrison, advection with the exchange). Without microphysics
    (mp=0) the stack holds theta and water vapour and no microphysics
    runs; without advection (advection=0) the species stay put, neither
    K1 nor K4 launches, and the near-end clamp leaves them alone, as the
    JAX loop leaves species it does not stack (its forcing relaxes them
    on the boundary ring in apply_forcing's order)."""
    stage = timer or (lambda name: contextlib.nullcontext())

    adv_names = tuple(adv_names)
    phys = options.physics
    mp = phys.microphysics
    mpdata = phys.advection == C.ADV_MPDATA
    advect = phys.advection != C.ADV_NONE
    aware = aerosol_aware(options)
    _check_species(mp, phys.advection, adv_names, aware)
    thompson = mp in THOMPSON_MP and not aware
    radii = mp == C.MP_THOMPSON_AER
    sb04 = mp == C.MP_SIMPLE
    plain = mp in PLAIN_MP
    adv = options.adv
    density = options.run.advect_density
    dqdts = dqdts or [{} for _ in states]
    full = full_field_forcing(dqdts[0], adv_names)
    pressure_varies, winds_vary = forcing_varies(dqdts[0]) if full \
        else (False, False)
    needs = substep_needs(options, pressure_varies, winds_vary)
    # YSU reads the 10 m winds and ustar, which only the full refresh
    # forms (icar_tpu/core/step.py:1638, 1745-1749)
    full_each = phys.boundarylayer == C.PBL_YSU
    convect = phys.convection != C.CU_NONE
    # only Tiedtke reads the PBL's moisture tendency (icar_tpu/core/
    # step.py:765-767; the JAX step takes the moisture before the PBL for
    # any scheme, :743-744, and leaves the others without it)
    tiedtke = phys.convection == C.CU_TIEDTKE
    surface = (phys.landsurface != C.LSM_NONE
               or phys.watersurface != C.WATER_NONE)
    # every convection scheme and WSM3 read w_real (icar_tpu/core/
    # step.py:1639-1645)
    w_real_cfg = convect or mp == C.MP_WSM3
    inner = [sh.interior for sh in layout.shards]
    devs = [s["pressure"].device for s in states]

    def scalars(x):
        """``x`` as a 0-d float32 tensor on each block's device."""
        return [torch.full((), float(x), device=d) for d in devs]

    with stage("diagnostics"):
        states = [diagnostic_update(s, g, full=False, with_w_real=w_real_cfg,
                                    interior=i)
                  for s, g, i in zip(states, geoms, inner)]
    dt_static = sharded_dt(states, geoms, options.run.cfl_reduction_factor,
                           options.run.cfl_strictness)
    # the accumulators are updated in place below: own them
    for s in states:
        for k in ("precipitation", "snowfall", "graupel"):
            if k in s:
                s[k] = s[k].clone()
    qs = [torch.stack([s[k] for k in adv_names]) for s in states]
    spares = [torch.empty_like(q) for q in qs]
    if not winds_vary:
        winds = [kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
                 for s, g in zip(states, geoms)]
    floors = [torch.as_tensor(limit_floors(adv_names), device=d)
              for d in devs]
    if mp in THOMPSON_MP:
        smap = mp_thompson.stack_smap(adv_names)
        tparams = thompson_params(options)
    elif sb04:
        species = [adv_names.index(k) for k in MP_SPECIES]
    # SB04 takes the interface thickness, the other schemes the mass-level
    # one
    dz_mp = [(g.dz_interface if sb04 else g.dz_mass).contiguous()
             for g in geoms]
    mp_stage = mp_stage_name(options)
    rest = limited_rest(states[0], adv_names)
    statics = [ps.Statics(g, options, sh)
               for g, sh in zip(geoms, layout.shards)]
    i_qv = adv_names.index("water_vapor")
    tend = None
    if any(k in d for d in dqdts for k in adv_names):
        tend = [torch.stack([d[k] if k in d else torch.zeros_like(q[0])
                             for k in adv_names])
                for q, d in zip(qs, dqdts)]
        floor_b = [f[:, None, None, None] for f in floors]
    if tend is not None or full:
        bmask = layout.boundary_masks()
    rrtmg = phys.radiation == C.RA_RRTMG
    noahmp = phys.landsurface == C.LSM_NOAHMP
    year_length = [None] * len(states)
    if phys.radiation in (C.RA_SIMPLE, C.RA_RRTMG) or noahmp:
        if time_aux is None:
            raise ValueError("run_interval_physics: the radiation and "
                             "Noah-MP need time_aux "
                             "(ICARModel._time_aux)")
        day0 = np.float32(time_aux["day_of_year0"])
        year_length = scalars(np.float32(time_aux["year_length"]))
    if rrtmg:
        cdf = cdf or rrtmg_lw.TorchCdf()
        rad_throttle = Throttle(options.rad.update_interval_rrtmg)
    lsm_throttle = Throttle(options.lsm.update_interval)
    mp_throttle = Throttle(options.mp.update_interval)

    def each(fn, *lists):
        """``fn`` on each block's entries of ``lists``."""
        return [fn(*a) for a in zip(*lists)]

    t = np.float32(0.0)
    end_time = np.float32(seconds)
    n = 0
    while t < end_time - np.float32(1e-3):
        if winds_vary:
            # the CFL dt of the forced winds (one read to the host a
            # substep) and their advection operands
            dt_static = sharded_dt(states, geoms,
                                   options.run.cfl_reduction_factor,
                                   options.run.cfl_strictness)
            winds = [kernels.prepare_advect_winds(s["u"], s["v"], s["w"],
                                                  g)
                     for s, g in zip(states, geoms)]
        dt = min(dt_static, end_time - t)
        near_end = bool((end_time - t) < dt * np.float32(2))
        clamp = near_end and tend is None
        dts = scalars(dt)
        views = [{k: q[i] for i, k in enumerate(adv_names)} for q in qs]
        with stage("diagnostics"):
            if full_each:
                states = each(lambda s, v, g, i: diagnostic_update(
                    {**s, **v}, g, full=True, interior=i),
                    states, views, geoms, inner)
            else:
                states = each(lambda s, v, g, i: diagnostic_update(
                    {**s, **v}, g, needs=needs,
                    with_w_real=w_real_cfg and winds_vary, interior=i),
                    states, views, geoms, inner)
        if phys.radiation == C.RA_SIMPLE:
            doy = scalars(day0 + t * np.float32(inv(86400.0)))
            with stage("radiation"):
                states = each(ps.radiation, states, statics, doy,
                              year_length, dts)
        elif rrtmg:
            doy = scalars(day0 + t * np.float32(inv(86400.0)))
            with stage("radiation"):
                states = each(ps.rrtmg_zenith, states, statics, doy,
                              year_length)
            if rad_throttle.step(dt) is not None:
                states = each(lambda s, g, d, y, h: ps.radiation_rrtmg(
                    s, g, options, t, d, y, h, cdf, stage),
                    states, statics, doy, year_length, dts)
            with stage("radiation"):
                states = each(ps.radiative_heating, states, dts)
        if surface:
            with stage("surface"):
                lsm_dt = lsm_throttle.step(dt)
                if lsm_dt is not None:
                    doys = (scalars(day0 + t * np.float32(inv(86400.0)))
                            if noahmp else [None] * len(states))
                    states = each(lambda s, g, h, d, y: ps.surface_fluxes(
                        s, g, options, h, d, y, stage),
                        states, statics, scalars(lsm_dt), doys, year_length)
                states = each(lambda s, g, h: ps.apply_fluxes(
                    s, g, options, h), states, statics, dts)
        if phys.boundarylayer == C.PBL_YSU:
            with stage("pbl_ysu"):
                states = each(ps.boundary_layer_ysu, states, statics, dts)
                if tiedtke:
                    # the JAX loop takes the moisture before the PBL after
                    # YSU has run (icar_tpu/core/step.py:746-747, 766-767),
                    # so YSU's tendency reaches Tiedtke as 0
                    for s, h in zip(states, dts):
                        s["tend_qv_pbl"] = (s["water_vapor"]
                                            - s["water_vapor"]) / h
        if phys.boundarylayer == C.PBL_SIMPLE:
            with stage("pbl"):
                kqs = each(ps.boundary_layer_diffusivity, states, statics,
                           dts)
                # one substep count for the domain: the blocks' largest
                nsub = max(host_max(each(
                    lambda k, g: pbl_simple.substep_bound(k, g.dz),
                    kqs, statics)), 1)
                qv_before_pbl = [s["water_vapor"] for s in states]
                states = each(lambda s, g, h, k: ps.boundary_layer(
                    s, g, h, k, nsub), states, statics, dts, kqs)
                if tiedtke:
                    for s, q0, h in zip(states, qv_before_pbl, dts):
                        s["tend_qv_pbl"] = (s["water_vapor"] - q0) / h
        if convect:
            with stage("convection"):
                states = each(lambda s, g, h: ps.convection(
                    s, g, options, h), states, statics, dts)
        with stage("restack"):
            # write back the rows a stage replaced (icar_tpu/core/step.py
            # _restack_dirty)
            for s, q, v in zip(states, qs, views):
                for i, k in enumerate(adv_names):
                    if s[k] is not v[k]:
                        q[i].copy_(s[k])
        mp_dt = mp_throttle.step(dt) if mp_stage else None
        if mp_dt is not None:
            with stage(mp_stage):
                rain = [s["precipitation"] for s in states]
                snow = [s["snowfall"] for s in states]
                if thompson:
                    sk.thompson_stack_sharded(
                        qs, smap, [s["exner"] for s in states],
                        [s["pressure"] for s in states], dz_mp, mp_dt, rain,
                        snow, [s["graupel"] for s in states], tparams)
                elif aware:
                    for s, q, dz in zip(states, qs, dz_mp):
                        thompson_aer_microphysics(
                            q, adv_names, s, dz, mp_dt, s["precipitation"],
                            s["snowfall"], s["graupel"], tparams)
                elif plain:
                    for s, q, dz in zip(states, qs, dz_mp):
                        plain_microphysics(mp, q, adv_names, s, dz, mp_dt,
                                           s["precipitation"],
                                           s["snowfall"], s.get("graupel"))
                else:
                    c2r, c2s = formation_rates(mp_dt)
                    sk.mp_simple_sharded(
                        *([q[i] for q in qs] for i in species),
                        [s["pressure"] for s in states],
                        [s["exner"] for s in states], dz_mp, rain, snow,
                        mp_dt, c2r, c2s,
                        rho=[s["density"] for s in states])
                if radii:
                    states = each(lambda s, q: effective_radii(
                        s, q, adv_names, tparams, aware), states, qs)
        if advect:
            with stage("advection"):
                awinds = (each(lambda w, s: kernels.density_winds(
                    w, s["density"]), winds, states) if density else winds)
                if mpdata:
                    sk.advect_mpdata_sharded(layout, qs, awinds, dt,
                                             adv.mpdata_order,
                                             adv.flux_corrected_transport,
                                             floors, clamp, spares)
                else:
                    sk.advect_upwind_sharded(layout, qs, awinds, dt, floors,
                                             clamp, spares)
                layout.exchange(spares)
                if "tend_qv_adv" in states[0]:
                    # the moisture convergence the next substep's trigger
                    # reads
                    for s, new, old, h in zip(states, spares, qs, dts):
                        s["tend_qv_adv"] = (new[i_qv] - old[i_qv]) / h
            qs, spares = spares, qs
        if full:
            states = each(lambda s, d, m: apply_forcing(s, d, dt, m,
                                                        adv_names),
                          states, dqdts, bmask)
        if tend is not None:
            qs = each(lambda q, te, m, fb: _relax(
                q, te, dt, m, fb if near_end else
                torch.full_like(fb, -np.inf), advect),
                qs, tend, bmask, floor_b)
            spares = [torch.empty_like(q) for q in qs]
        if near_end:
            states = [_clamp_rest(s, rest) for s in states]
        t = np.float32(t + dt)
        n += 1

    out = []
    for s, q, g, i in zip(states, qs, geoms, inner):
        for j, k in enumerate(adv_names):
            s[k] = q[j]
        with stage("diagnostics"):
            out.append(diagnostic_update(s, g, full=True, interior=i))
    return out, n

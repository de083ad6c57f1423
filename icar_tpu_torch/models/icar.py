"""The model assembly: geometry + state + the interval loop
(icar_tpu/models/icar.py).

``ICARModel`` runs on the torch device it is given, the card ("cuda") by
default; it never falls back to another. The ported configurations are the
ideal ridge with balance-only winds and no other physics, with SB04
microphysics and upwind or MPDATA advection (any order, with or without
FCT), or with Thompson microphysics (mp=1) and MPDATA advection. Any other
option raises ``NotImplementedError`` naming the ROADMAP slice that ports
it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import constants as C
from ..config import Options
from ..convert import geometry_to_torch
from ..core.diagnostics import diagnostic_update
from ..core.state import advected_names, create_state
from ..core.step import path_kernels, run_interval
from ..forcing.ideal import IdealCase
from ..grid import build_geometry
from ..ops import kernels
from ..ops import wind as wind_ops


def _unported(options: Options):
    """Why ``options`` leaves the ported slice, or None."""
    ph = options.physics
    mp_slice = ("Slice F (Thompson-aerosol, mp=5)"
                if ph.microphysics == C.MP_THOMPSON_AER
                else "Slice F (the other schemes)")
    checks = (
        (ph.microphysics in (C.MP_SIMPLE, C.MP_THOMPSON),
         f"microphysics={ph.microphysics}", mp_slice),
        (ph.microphysics != C.MP_THOMPSON or ph.advection == C.ADV_MPDATA,
         f"microphysics={ph.microphysics} with advection={ph.advection}",
         "Slice B (Thompson + upwind)"),
        (ph.advection in (C.ADV_UPWIND, C.ADV_MPDATA),
         f"advection={ph.advection}", "Slice B (advection options)"),
        (ph.windtype == C.WIND_NONE, f"wind={ph.windtype}",
         "Slice C (wind=2/3) and Slice D (linear winds)"),
        (ph.radiation == C.RA_NONE, f"radiation={ph.radiation}",
         "Slice C (ra_simple) and Slice F (RRTMG)"),
        (ph.boundarylayer == C.PBL_NONE, f"pbl={ph.boundarylayer}",
         "Slice C (pbl_simple) and Slice F (YSU)"),
        (ph.landsurface == C.LSM_NONE, f"lsm={ph.landsurface}",
         "Slice C (Noah) and Slice F (Noah-MP)"),
        (ph.watersurface == C.WATER_NONE, f"water={ph.watersurface}",
         "Slice F (lake)"),
        (ph.convection == C.CU_NONE, f"convection={ph.convection}",
         "Slice C (Tiedtke) and Slice F (the other schemes)"),
        (not options.run.advect_density, "advect_density",
         "Slice B (advection options)"),
        (float(options.mp.update_interval) <= 0, "mp update_interval > 0",
         "Slice C (update-interval throttles)"),
    )
    for ok, what, where in checks:
        if not ok:
            return f"{what} is not ported yet: {where} in ROADMAP.md"
    return None


class ICARModel:
    """An ICAR model instance on one torch device."""

    def __init__(self, options: Options, terrain: np.ndarray,
                 lat: np.ndarray, lon: np.ndarray, *, device="cuda"):
        why = _unported(options)
        if why is not None:
            raise NotImplementedError(why)
        device = torch.device(device)
        if device.type == "cuda":
            # a kernel of the path takes fewer levels: refuse before any
            # state is built
            kernels.check_levels(path_kernels(options),
                                 int(options.domain.nz))
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ICARModel: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        options.domain.ny, options.domain.nx = terrain.shape
        self.options = options.validate()
        self.device = device
        self.geom = build_geometry(terrain, lat, lon, options)
        self.geom_t = geometry_to_torch(self.geom, self.device)
        self.state = create_state(options, self.device)
        self.advect_names = advected_names(options)
        self.model_time = 0.0          # seconds since run start
        self._dqdt: Dict[str, torch.Tensor] = {}
        self._last_n = 0

    def compute_winds(self, u, v, rotate: bool = False):
        """Balanced (u, v, w) for the winds (u, v) (update_winds,
        wind.f90:289-369), rotated to the grid first when ``rotate``."""
        g = self.geom_t
        if rotate:
            u, v = wind_ops.make_winds_grid_relative(u, v, g.sintheta,
                                                     g.costheta)
        return wind_ops.update_winds(u, v, g, self.options.physics.windtype)

    def apply_winds(self, u, v, rotate: bool = True):
        """Install the wind solution for (u, v) into the state."""
        u, v, w = self.compute_winds(self._tensor(u), self._tensor(v),
                                     rotate=rotate)
        self.state = {**self.state, "u": u, "v": v, "w": w}

    def set_initial_conditions(self, case: IdealCase, rotate: bool = True,
                               winds: bool = True):
        """Install an ideal case as the initial state (get_initial_conditions
        + first update_winds, init.f90:85-112)."""
        s = dict(self.state)
        s["potential_temperature"] = self._tensor(case.theta)
        s["pressure"] = self._tensor(case.pressure)
        s["water_vapor"] = self._tensor(case.qv)
        s["u"] = self._tensor(case.u)
        s["v"] = self._tensor(case.v)
        self.state = diagnostic_update(s, self.geom_t)
        if winds:
            u, v, w = self.compute_winds(self._tensor(case.u),
                                         self._tensor(case.v), rotate=rotate)
        else:
            u, v = self._tensor(case.u), self._tensor(case.v)
            w = torch.zeros_like(s["potential_temperature"])
        s = dict(self.state)
        s["u"], s["v"], s["w"] = u, v, w
        self.state = diagnostic_update(s, self.geom_t)

    def set_forcing_tendencies(self, dqdt: Dict[str, np.ndarray]):
        """Install dqdt fields for the next intervals (update_delta_fields,
        domain_obj.f90:2339-2372). Only advected species are ported: they
        relax the domain's boundary ring."""
        other = sorted(set(dqdt) - set(self.advect_names))
        if other:
            raise NotImplementedError(
                f"forcing tendencies for {other} are not ported yet: "
                "Slice E (file-driven runs) in ROADMAP.md")
        self._dqdt = {k: self._tensor(v) for k, v in dqdt.items()}

    def advance(self, seconds: float):
        """Integrate the state forward by ``seconds`` (one forcing/output
        interval; step, time_step.f90:440-551)."""
        self.state, self._last_n = run_interval(
            self.state, self.geom_t, self.options, self.advect_names,
            seconds, self._dqdt)
        self.model_time += float(seconds)
        return self.state

    @property
    def last_n_substeps(self) -> int:
        return self._last_n

    def field(self, name: str) -> np.ndarray:
        """A field as a numpy array."""
        return self.state[name].detach().cpu().numpy()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, dtype=torch.float32,
                               device=self.device)


def ideal_ridge_model(nx=300, ny=20, nz=20, dx=1000.0, hill_height=1000.0,
                      u_speed=10.0, rh=0.95, mp=C.MP_SIMPLE,
                      windtype=C.WIND_NONE, flat_z_height=-5,
                      dz_levels=None, rad=C.RA_NONE, pbl=C.PBL_NONE,
                      lsm=C.LSM_NONE, water=C.WATER_NONE,
                      adv=C.ADV_UPWIND, conv=C.CU_NONE,
                      options_cb=None, *, device="cuda") -> ICARModel:
    """The standard ideal-ridge case (tests/gen_ideal_test.py semantics),
    with the JAX package's defaults, on ``device`` (the card by default).
    ``options_cb(options)`` can adjust scheme sub-options before the model
    is built."""
    from ..forcing.ideal import (ideal_latlon, make_ideal_case,
                                 schaer_topography)

    o = Options()
    o.domain.nx, o.domain.ny, o.domain.nz = nx, ny, nz
    o.domain.dx = dx
    if dz_levels is None:
        dz_levels = ([50.0, 75.0, 125.0, 200.0, 300.0, 400.0]
                     + [500.0] * max(nz - 6, 0))
    o.domain.dz_levels = list(dz_levels)[:nz]
    o.domain.flat_z_height = flat_z_height
    o.physics.microphysics = mp
    o.physics.advection = adv
    o.physics.windtype = windtype
    o.physics.radiation = rad
    o.physics.boundarylayer = pbl
    o.physics.landsurface = lsm
    o.physics.watersurface = water
    o.physics.convection = conv
    if options_cb is not None:
        options_cb(o)

    terrain = schaer_topography(nx, ny, hill_height, dx)
    lat, lon = ideal_latlon(nx, ny, dx)
    model = ICARModel(o, terrain, lat, lon, device=device)
    model.set_initial_conditions(make_ideal_case(model.geom, u_profile=u_speed,
                                                 rh=rh))
    return model

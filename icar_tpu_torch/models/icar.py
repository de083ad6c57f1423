"""The model assembly: geometry + state + the interval loop
(icar_tpu/models/icar.py).

``ICARModel`` runs on the torch device it is given, the card ("cuda") by
default; it never falls back to another. The ported configurations are the
ideal ridge with SB04, Thompson (mp=1), Morrison (mp=3), WSM6 (mp=4),
Thompson-aerosol (mp=5: K5 then the effective radii, or with
``mp.use_aerosol_aware`` the aerosol-aware scheme, its default aerosol
profiles installed at construction), WSM3 (mp=6) or no microphysics and
upwind,
MPDATA (any order, with or without FCT) or no advection, with or without
density advection (``run.advect_density``) and the microphysics throttle
(``mp.update_interval``), and with any subset of the full physics column
of bench.py's fullphys: the forcing's radiation (radiation=1), simple
radiation or RRTMG (longwave and shortwave, or the simple shortwave), the
forcing's surface fluxes (lsm=1), Noah or Noah-MP (with its glacier
column), simple water or the CLM lake (water=3, ``physics/water_lake.py``;
its state from ``lake_init``, as ``core.driver`` does), the simple PBL or
YSU and Tiedtke, Kain-Fritsch, NSAS or BMJ convection.
Every wind solver runs with each: balance only, linear theory (wind=1,
its table built on the model's device at the first wind solve), the
mass-conserving winds (wind=2), the iterative solver (wind=3), linear
then iterative (wind=5), and flow blocking: every scheme option the
options' validation accepts (it raises ValueError for the rest). Forcing
tendencies (``set_forcing_tendencies``) relax the advected species on
the boundary ring and change u, v, w, pressure and the 2-D fields
everywhere (a file-driven run's,
``core/driver.py``); a monthly rain fraction scales each interval's
precipitation (``set_rain_fraction``). ``attach_mesh`` shards a model over
a device mesh (``parallel/mesh.py``); its state then lives in one block
per shard, with every scheme option, every wind solver, forcing
tendencies of any field and a rain fraction (bench.py --config conus is
the full physics column on a mesh over every card, bench.py --config
linear --sharded the linear-theory ridge on a mesh; ``core.driver`` runs
file-driven runs on one). The wind solve stays one solve of the whole
domain on the model's device, its tables there whole.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants as C
from ..config import Options
from ..convert import geometry_to_torch
from ..core.diagnostics import diagnostic_update
from ..core.state import (ACCUMULATORS, advected_names, create_state,
                          state_digest)
from ..core.step import path_halo, path_kernels, run_blocks, run_interval
from ..forcing.ideal import IdealCase
from ..grid import build_geometry
from ..ops import blocking as blk
from ..ops import kernels
from ..ops import linear_winds as lw
from ..ops import pointwise as pw
from ..ops import wind as wind_ops
from ..parallel.mesh import Layout, Mesh, scatter_geometry
from ..physics import rrtmg_lw, rrtmg_sw
from ..physics.rrtmg_lw import TorchCdf
from ..physics.rrtmg_lw_tables import synthetic_lw_tables
from ..physics.rrtmg_sw_tables import synthetic_sw_tables


LINEAR_WINDS = (C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE)


class ICARModel:
    """An ICAR model instance on one torch device."""

    def __init__(self, options: Options, terrain: np.ndarray,
                 lat: np.ndarray, lon: np.ndarray, *, device="cuda"):
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
        # with a mesh: the layout, and the state, geometry and forcing
        # tendencies as one block per shard (``self.state`` is then None)
        self.mesh: Optional[Mesh] = None
        self.layout: Optional[Layout] = None
        self.blocks: Optional[List[Dict[str, torch.Tensor]]] = None
        self._geom_blocks = None
        self._dqdt_blocks = None
        # the linear-theory table with its axis values and the
        # perturbation it relaxes (setup_linwinds; the persistent
        # hi_u/v_perturbation of linear_winds.f90:97-100), and the
        # blocking table: each built at the first wind solve that needs it
        self._lut = None
        self._lut_values = None
        self.u_perturbation: Optional[torch.Tensor] = None
        self.v_perturbation: Optional[torch.Tensor] = None
        self._blocking = None
        # the initial case's winds, which update_winds solves anew
        self._case_winds = None
        # the monthly precipitation bias-correction scale (12, ny, nx), and
        # with a mesh its blocks
        self._rain_frac_months: Optional[torch.Tensor] = None
        self._rain_frac_blocks = None
        # RRTMG's McICA draw (physics.rrtmg_lw.TorchCdf; the tests put the
        # JAX package's draws here)
        self.mcica_cdf = TorchCdf()
        if "nwfa" in self.state:
            self._install_aerosols()

    def _install_aerosols(self):
        """The default CCN/IN profiles of mp=5's aerosol-aware scheme and
        the surface CCN flux from the initial lowest level's nwfa
        (thompson_aer_init, mp_thompson_aer.f90:442-549;
        icar_tpu/models/icar.py:39-58), made on the host and installed (on
        a sharded model, scattered into the blocks); a file-driven run's
        forcing overwrites them where it holds nwfa and nifa
        (core.driver)."""
        from ..physics.mp_thompson import aer_init_profiles, aer_surface_flux
        z_agl = np.asarray(self.geom.z) \
            - np.asarray(self.geom.terrain)[None]
        nwfa, nifa = aer_init_profiles(z_agl, np.asarray(self.geom.terrain))
        s = {"nwfa": self._tensor(np.asarray(nwfa, np.float32)),
             "nifa": self._tensor(np.asarray(nifa, np.float32))}
        if "nwfa2d" in self._held():
            s["nwfa2d"] = self._tensor(np.asarray(
                aer_surface_flux(nwfa[0], self.geom.dx), np.float32))
        self._install_fields(s)

    @property
    def winds_follow_state(self) -> bool:
        """Whether a wind solve depends on the state (linear theory reads
        its N^2), so that the winds are solved anew before each interval
        (``update_winds``, as bench.py --config linear does)."""
        return self.options.physics.windtype in LINEAR_WINDS

    def attach_mesh(self, mesh: Mesh):
        """Shard the model over ``mesh`` (icar_tpu/models/icar.py
        attach_mesh): every field, the geometry and the forcing
        tendencies move into one block per shard (``parallel.mesh.Layout``,
        with the halo the model's path reads), each on its device, and so
        does the rain fraction's table; later ``advance`` calls run
        ``core.step.run_blocks`` on them (the column physics too: bench.py
        --config conus; full-field forcing of a file-driven run). A wind
        solve (``compute_winds``: balance, linear theory and its
        perturbation, blocking, the iterative solver) stays one solve of
        the whole domain on the model's device, on the fields it reads
        gathered, the fields it writes (u, v, w, nsquared) scattered into
        the blocks (``_global_fields``, ``_install_fields``); the
        linear-theory and blocking tables stay there whole (a table per
        shard waits for one shard per card). Raises ValueError for a mesh
        on another device type than the model's, or one that leaves a
        shard without a natural row or column."""
        if mesh.device_type != self.device.type:
            raise ValueError(f"attach_mesh: a mesh of {mesh.device_type} "
                             f"devices for a model on {self.device}")
        if mesh.device_type == "cuda":
            kernels.check_levels(path_kernels(self.options),
                                 int(self.options.domain.nz))
        state = self._global_state()
        layout = Layout(mesh, self.geom.ny, self.geom.nx,
                        path_halo(self.options))
        self.mesh, self.layout = mesh, layout
        self._geom_blocks = scatter_geometry(self.geom, layout)
        self.state = None
        self._install(state)
        self._dqdt_blocks = self._scatter_dict(self._dqdt)
        if self._rain_frac_months is not None:
            self._rain_frac_blocks = layout.scatter(self._rain_frac_months)

    def compute_winds(self, u, v, rotate: bool = False, timer=None):
        """The configured wind solution (u, v, w) for the winds (u, v)
        (update_winds, wind.f90:289-369), rotated to the grid first when
        ``rotate``. Linear theory reads the present state's stability,
        writes ``nsquared`` into the state when it holds it, and relaxes
        the stored perturbation. ``timer(stage)`` brackets the stages
        (nsquared, lookup, blocking, iterative, balance)."""
        g = self.geom_t
        if rotate:
            u, v = wind_ops.make_winds_grid_relative(u, v, g.sintheta,
                                                     g.costheta)
        linear = None
        if self.winds_follow_state:
            def linear(u, v):
                return self._apply_linear_perturbation(u, v, timer)
        blocking = self._apply_blocking if self.options.block.block_flow \
            else None
        return wind_ops.update_winds(u, v, g, self.options.physics.windtype,
                                     self.options.run.wind_iterations,
                                     linear, blocking, timer)

    def apply_winds(self, u, v, rotate: bool = True, timer=None):
        """Install the wind solution for (u, v) into the state."""
        u, v, w = self.compute_winds(self._tensor(u), self._tensor(v),
                                     rotate=rotate, timer=timer)
        self._install_fields({"u": u, "v": v, "w": w})

    def update_winds(self, timer=None):
        """Solve the winds anew from the initial case's winds on the
        present state and install them: the wind update of each forcing
        step (driver.f90:128-138), which bench.py --config linear runs
        before every interval."""
        self.apply_winds(*self._case_winds, rotate=True, timer=timer)

    def _setup_linear_winds(self):
        """Build (or read from the disk cache) the spatial linear-theory
        table on the model's device (setup_linwinds /
        initialize_spatial_winds, linear_winds.f90), after the budget
        check of its size on one device."""
        lt = self.options.lt
        nz, ny, nx = self.geom.nz, self.geom.ny, self.geom.nx
        lw.check_lut_budget(lt, nz, ny, nx, 1)
        dz = np.asarray(self.options.domain.dz_levels[:nz], np.float32)
        E = lt.n_spd_values * lt.n_dir_values * lt.n_nsq_values
        dtype = (torch.bfloat16 if str(lt.lut_dtype) == "bfloat16"
                 else torch.float32)
        chunks = (lw.load_lut_chunks(lt.lut_filename, dz, lt)
                  if lt.read_lut else None)
        writer = None
        if chunks is None:
            chunks = lw.build_lut_chunks(
                np.asarray(self.geom.terrain, np.float64), self.geom.dx, dz,
                lt, self.device)
            if lt.write_lut:
                writer = lw.open_lut_writer(lt.lut_filename, E, nz, ny, nx,
                                            dz, lt)
        self._lut = lw.place_lut_chunks(chunks, E, nz, ny, nx, self.device,
                                        dtype, writer)
        if writer is not None:
            writer[0].flush()
            writer[1].flush()
        self._lut_values = tuple(torch.as_tensor(a, device=self.device)
                                 for a in lw.table_values(lt))
        self.u_perturbation = torch.zeros((nz, ny, nx + 1),
                                          device=self.device)
        self.v_perturbation = torch.zeros((nz, ny + 1, nx),
                                          device=self.device)

    def _apply_linear_perturbation(self, u, v, timer=None):
        """One application of the spatial linear wind field (linear_perturb
        -> spatial_winds): the stability of the present state, then the
        table's lookup."""
        if self._lut is None:
            self._setup_linear_winds()
        stage = timer or (lambda name: contextlib.nullcontext())
        lt = self.options.lt
        s = self._global_fields(
            ["potential_temperature", "exner", "water_vapor"]
            + [k for k in ("cloud_water", "cloud_ice", "rain_mass",
                           "snow_mass") if k in self._held()])
        with stage("nsquared"):
            hydro = torch.zeros_like(s["water_vapor"])
            for k in ("cloud_water", "cloud_ice", "rain_mass", "snow_mass"):
                if k in s:
                    hydro = hydro + s[k]
            nsq_log = lw.compute_nsquared(
                s["potential_temperature"], s["exner"], self.geom_t.z,
                s["water_vapor"], hydro, lt.vert_smooth, lt.variable_n,
                lt.n_squared, lt.min_stability, lt.max_stability,
                lt.smooth_nsq, lt.stability_window_size)
            if "nsquared" in self._held():
                self._install_fields({"nsquared": pw.exp(nsq_log)})
        with stage("lookup"):
            spd, dirv, nsqv = self._lut_values
            u, v, self.u_perturbation, self.v_perturbation = \
                lw.apply_spatial_winds(
                    u, v, nsq_log, self.u_perturbation, self.v_perturbation,
                    self._lut[0], self._lut[1], spd, dirv, nsqv,
                    lt.vert_smooth, lt.linear_update_fraction,
                    lt.linear_contribution)
        return u, v

    def _apply_blocking(self, u, v):
        """Froude-number flow blocking (add_blocked_flow,
        winds_blocking.f90:52-65; off by default, as the reference's
        block_flow switch)."""
        bo = self.options.block
        if self._blocking is None:
            dz = np.asarray(self.options.domain.dz_levels[:self.geom.nz],
                            np.float32)
            self._blocking = blk.init_blocking(
                np.asarray(self.geom.terrain, np.float64), self.geom.dx, dz,
                self.options.lt, bo, self.device)
        froude = blk.update_froude(
            self._global_fields(["potential_temperature"])[
                "potential_temperature"], u, v,
            self.geom_t.z, self._blocking.terrain_blocking,
            max(1, int(round(bo.smooth_froude_distance / self.geom.dx))),
            bo.n_smoothing_passes, bo.block_fr_max)
        return blk.apply_blocking(
            u, v, froude, self._blocking,
            self.options.lt.stability_window_size,
            bo.blocking_contribution, bo.block_fr_max, bo.block_fr_min)

    def set_initial_conditions(self, case: IdealCase, rotate: bool = True,
                               winds: bool = True):
        """Install an ideal case as the initial state (get_initial_conditions
        + first update_winds, init.f90:85-112)."""
        s = self._global_state()
        s["potential_temperature"] = self._tensor(case.theta)
        s["pressure"] = self._tensor(case.pressure)
        s["water_vapor"] = self._tensor(case.qv)
        s["u"] = self._tensor(case.u)
        s["v"] = self._tensor(case.v)
        s = diagnostic_update(s, self.geom_t)
        self._case_winds = (self._tensor(case.u), self._tensor(case.v))
        if winds:
            # the wind solve reads the state (linear theory's stability)
            # and may write to it (nsquared)
            self._install(s)
            u, v, w = self.compute_winds(*self._case_winds, rotate=rotate)
            s = self._global_state()
        else:
            u, v = self._tensor(case.u), self._tensor(case.v)
            w = torch.zeros_like(s["potential_temperature"])
        s["u"], s["v"], s["w"] = u, v, w
        s = diagnostic_update(s, self.geom_t)
        # the surface of an idealised run (no forcing files): skin, sea,
        # soil and deep-soil temperature start at the lowest level's air
        # temperature
        for name in ("skin_temperature", "sst", "soil_temperature",
                     "soil_deep_temperature"):
            if name in s and float(torch.max(torch.abs(s[name]))) == 0.0:
                s[name] = s["temperature"][0].expand(s[name].shape).clone()
        self._install(s)

    def set_forcing_tendencies(self, dqdt: Dict[str, np.ndarray]):
        """Install dqdt fields for the next intervals (update_delta_fields,
        domain_obj.f90:2339-2372): the advected species relax the
        domain's boundary ring, u, v, w, pressure and the 2-D fields
        change over the whole field (``core.step.apply_forcing``); on a
        sharded model each is scattered into the blocks, halo included.
        Raises ValueError for a field the state does not hold."""
        unknown = sorted(set(dqdt) - set(self._held()))
        if unknown:
            raise ValueError(f"forcing tendencies for {unknown}, which the "
                             "state does not hold")
        self._dqdt = {k: self._tensor(v) for k, v in dqdt.items()}
        if self.mesh is not None:
            self._dqdt_blocks = self._scatter_dict(self._dqdt)

    def set_rain_fraction(self, monthly_scale: np.ndarray):
        """Install the monthly precipitation bias-correction scale
        (apply_rain_fraction, mp_driver.f90:350-397): ``monthly_scale`` is
        (12, ny, nx); interior cells of each interval's precipitation
        increment are multiplied by the current month's entry
        (``advance(rain_frac_month=...)``), on the model's device, and on
        a sharded model scattered like a 2-D field, one block per shard
        (the JAX package's ``_place_rain_fraction``)."""
        ny, nx = self.geom.ny, self.geom.nx
        frac = np.ones((monthly_scale.shape[0], ny, nx), np.float32)
        fy = min(monthly_scale.shape[1], ny)
        fx = min(monthly_scale.shape[2], nx)
        frac[:, :fy, :fx] = monthly_scale[:, :fy, :fx]
        # domain-boundary ring is never scaled (mp_driver.f90:361-396
        # operates on its+1..ite-1 interior cells only)
        frac[:, 0, :] = 1.0
        frac[:, -1, :] = 1.0
        frac[:, :, 0] = 1.0
        frac[:, :, -1] = 1.0
        self._rain_frac_months = self._tensor(frac)
        if self.mesh is not None:
            self._rain_frac_blocks = self.layout.scatter(
                self._rain_frac_months)

    def advance(self, seconds: float, rain_frac_month: Optional[int] = None,
                timer=None):
        """Integrate the state forward by ``seconds`` (one forcing/output
        interval; step, time_step.f90:440-551). Returns the state (None
        with a mesh: the blocks are in ``self.blocks``).
        ``rain_frac_month`` selects the bias-correction scale
        (``set_rain_fraction``) applied to this interval's precipitation
        increment at its end. ``timer`` times the interval loop's stages
        (``core.step.run_interval_physics``, or without column physics
        ``run_interval_sharded``'s; on a mesh summed over the blocks)."""
        if rain_frac_month is not None:
            if self._rain_frac_months is None:
                raise ValueError("advance: rain_frac_month needs a prior "
                                 "set_rain_fraction")
            precip0 = [s["precipitation"] for s in self._block_states()]
        if self.mesh is None:
            self.state, self._last_n = run_interval(
                self.state, self.geom_t, self.options, self.advect_names,
                seconds, self._dqdt, self._time_aux(), timer,
                self.mcica_cdf)
        else:
            self.blocks, self._last_n = run_blocks(
                self.layout, self.blocks, self._geom_blocks, self.options,
                self.advect_names, seconds, self._dqdt_blocks,
                self._time_aux(), timer, self.mcica_cdf)
        if rain_frac_month is not None:
            frac = (self._rain_frac_blocks if self.mesh is not None
                    else [self._rain_frac_months])
            for s, p0, f in zip(self._block_states(), precip0, frac):
                s["precipitation"] = p0 + (s["precipitation"] - p0) * \
                    f[rain_frac_month]
        self.model_time += float(seconds)
        return self.state

    def _block_states(self) -> List[Dict[str, torch.Tensor]]:
        """The state as the list of its blocks (the state alone without a
        mesh)."""
        return [self.state] if self.mesh is None else self.blocks

    def _time_aux(self) -> Dict[str, np.float32]:
        """The interval's solar-geometry scalars, in float32: the
        fractional day of the year at its start (small, so float32 keeps
        the hour angle to the second) and the year's length
        (icar_tpu/models/icar.py _time_aux)."""
        from ..utils.calendar import Time, TimeDelta
        now = self.options.start_time() + TimeDelta(self.model_time)
        year_start = Time.from_date(now.date()[0], 1, 1,
                                    calendar=now.calendar)
        return {"day_of_year0": np.float32(now.mjd - year_start.mjd),
                "year_length": np.float32(now.year_length())}

    @property
    def last_n_substeps(self) -> int:
        return self._last_n

    def global_field(self, name: str) -> torch.Tensor:
        """A field of the whole domain as one tensor: the state's own, or
        with a mesh the owned cells of every block gathered on the first
        shard's device."""
        if self.mesh is None:
            return self.state[name]
        return self.layout.gather([b[name] for b in self.blocks])

    def field(self, name: str) -> np.ndarray:
        """A field as a numpy array."""
        return self.global_field(name).detach().cpu().numpy()

    def digest(self) -> Dict[str, List[float]]:
        """``state_digest`` of the whole domain: the advected fields, u, v,
        w and the accumulators the state holds. Equal for a sharded and an
        unsharded run that agree bit for bit."""
        names = list(self.advect_names) + ["u", "v", "w"]
        return state_digest({k: self.global_field(k) for k in names + [
            a for a in ACCUMULATORS if a in self._held()]}, names)

    def _global_state(self) -> Dict[str, torch.Tensor]:
        """The whole state as one dict on the model's device."""
        if self.mesh is None:
            return dict(self.state)
        return {k: self.global_field(k).to(self.device)
                for k in self.blocks[0]}

    def _global_fields(self, names) -> Dict[str, torch.Tensor]:
        """The fields ``names`` of the whole domain on the model's device:
        the state's own, or with a mesh gathered from the blocks."""
        return {k: self.global_field(k).to(self.device) for k in names}

    def _held(self) -> Dict[str, torch.Tensor]:
        """The state's fields by name (with a mesh, the first block's)."""
        return self.state if self.mesh is None else self.blocks[0]

    def _install(self, state: Dict[str, torch.Tensor]):
        """Make ``state`` (the whole domain) the model's state: with a
        mesh, scattered into the blocks."""
        if self.mesh is None:
            self.state = state
        else:
            self.blocks = self._scatter_dict(state)

    def _install_fields(self, fields: Dict[str, torch.Tensor]):
        """Replace the fields ``fields`` (the whole domain) in the model's
        state, the others kept: with a mesh each is scattered into the
        blocks, halo included."""
        if self.mesh is None:
            self.state = {**self.state, **fields}
        else:
            self.blocks = [{**b, **f} for b, f in zip(
                self.blocks, self._scatter_dict(fields))]

    def _scatter_dict(self, fields: Dict[str, torch.Tensor]):
        """{name: field} of the whole domain as one such dict per block."""
        per_field = {k: self.layout.scatter(v) for k, v in fields.items()}
        return [{k: v[i] for k, v in per_field.items()}
                for i in range(len(self.layout.shards))]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, dtype=torch.float32,
                               device=self.device)


# bench.py's ridge case at full width (bench.py:47-51), and the options of
# the ported paths on it: SB04 + upwind, SB04 + MPDATA (order 2 with FCT),
# Thompson + MPDATA (bench.py --config mpdata_thompson), the full physics
# column (bench.py --config fullphys: Thompson with upwind advection,
# wind=2, simple radiation, Noah with simple water, simple PBL and Tiedtke
# convection), SB04 + upwind on linear-theory winds (bench.py --config
# linear, whose winds are solved anew before each interval:
# ICARModel.winds_follow_state); then the general loop's options on them:
# density advection with either advection, SB04 + upwind with the
# microphysics throttled to every 60 s, and the full physics column with
# MPDATA, or with SB04 and without Tiedtke (the options refuse SB04 with a
# deep convection scheme, config.py validate, as the JAX package's do);
# and bench.py --config fullphys_rrtmg with Noah in Noah-MP's place:
# RRTMG (longwave and shortwave every 1800 s, icloud 3, on the synthetic
# k-tables bench.py injects, seeds 0 and 1) and YSU; then that config as
# bench.py builds it, with Noah-MP; and the full physics column with each
# of the other convection schemes (Kain-Fritsch, NSAS, BMJ) in Tiedtke's
# place; then bench.py's --config mpdata_thompson ridge with Thompson-aerosol
# (mp=5) in Thompson's place, without and with the aerosol-aware option
RIDGE = dict(nx=500, ny=500, nz=20, dx=1000.0, hill_height=1000.0,
             u_speed=10.0, rh=0.95, flat_z_height=-5)
FULLPHYS = dict(mp=C.MP_THOMPSON, windtype=C.WIND_CONSERVE_MASS,
                rad=C.RA_SIMPLE, pbl=C.PBL_SIMPLE, lsm=C.LSM_NOAH,
                water=C.WATER_SIMPLE, conv=C.CU_TIEDTKE)
MP_THROTTLE_INTERVAL = 60.0


def linear_lut_options(o):
    """bench.py --config linear's table (bench.py:62-73): 5 speeds x 8
    directions x 3 N^2 (4.8 GB in float32 at 500x500x20) and a buffer of
    48 cells (a 600x600 FFT grid), built at set-up without the disk
    cache."""
    o.lt.n_spd_values, o.lt.n_dir_values, o.lt.n_nsq_values = 5, 8, 3
    o.lt.buffer = 48


def density_options(o):
    """Density advection (the namelist's advect_density = .true.)."""
    o.run.advect_density = True


def mp_throttle_options(o):
    """The microphysics every MP_THROTTLE_INTERVAL seconds (the namelist's
    mp_parameters update_interval)."""
    o.mp.update_interval = MP_THROTTLE_INTERVAL


def aerosol_aware_options(o):
    """mp=5's aerosol-aware scheme (the namelist's mp_parameters
    use_aerosol_aware = .true.)."""
    o.mp.use_aerosol_aware = True


def synthetic_rrtmg_tables(o=None):
    """Inject the synthetic RRTMG k-tables bench.py --config
    fullphys_rrtmg runs on (bench.py:98-102; the real rrtmg_support files
    are not in the repository); as an ``options_cb`` it leaves the options
    at their defaults (update_interval_rrtmg 1800 s, icloud 3, the RRTMG
    shortwave)."""
    rrtmg_lw.set_lw_tables(synthetic_lw_tables())
    rrtmg_sw.set_sw_tables(synthetic_sw_tables())


FULLPHYS_RRTMG_NOAH = dict(FULLPHYS, rad=C.RA_RRTMG, pbl=C.PBL_YSU,
                           options_cb=synthetic_rrtmg_tables)


# state field -> noahmp_init_state key: the fields bench.py's
# _init_noahmp_state installs (bench.py:160-169; the file-driven driver
# installs more, core.driver.ICARDriver._init_noahmp). NOTE reference
# fault kept (ROADMAP section 3): the snow layers' ice and liquid water,
# the snow height and the soil water content are not among them, so a
# cell that starts with snow layers gets layers without mass
NOAHMP_BENCH_FIELDS = {
    "snow_albedo_prev": "albold", "snow_water_eq_prev": "sneqvo",
    "soil_liquid_water": "sh2o", "canopy_temperature": "tah",
    "canopy_vapor_pressure": "eah", "veg_leaf_temperature": "tv",
    "ground_surf_temperature": "tg", "snow_layer_depth": "zsnso",
    "water_table_depth": "zwt", "water_aquifer": "wa",
    "storage_gw": "wt", "lai": "lai", "sai": "sai"}


def init_noahmp_state(model: ICARModel,
                      fields: Optional[Dict[str, str]] = None) -> ICARModel:
    """The Noah-MP initial state of an ideal run as bench.py builds it
    (bench.py:136-175 ``_init_noahmp_state``; the reference reads these
    from its land files): the skin, soil and deep-soil temperatures from
    the lowest air temperature, then ``noahmp_init_state`` on the host,
    then its ``fields`` (NOAHMP_BENCH_FIELDS by default), the layer count
    and the snow and soil temperatures, uploaded to the model's device.
    Returns ``model``."""
    from ..physics.noah_params import load_tables
    from ..physics.noahmp import NSNOW, noahmp_init_state
    from ..physics.noahmp_params import load_mp_tables

    st = model._global_state()
    s = {k: v.detach().cpu().numpy().copy() for k, v in st.items()}
    s["skin_temperature"] = np.asarray(s["temperature"][0],
                                       np.float32).copy()
    s["soil_temperature"][:] = s["skin_temperature"][None]
    s["soil_deep_temperature"] = s["skin_temperature"].copy()
    init = noahmp_init_state(
        s["skin_temperature"], s["swe"].astype(np.float32),
        s["snow_height"], s["soil_temperature"], s["soil_water_content"],
        s["soil_type"], s["veg_type"], load_mp_tables(), load_tables())
    for f, k in (NOAHMP_BENCH_FIELDS if fields is None else fields).items():
        s[f] = init[k]
    s["snow_nlayers"] = init["isnow"]
    s["snow_temperature"] = init["stc"][:NSNOW]
    s["soil_temperature"] = init["stc"][NSNOW:]
    model._install({k: model._tensor(v) for k, v in s.items()})
    return model


# bench.py --config fullphys_rrtmg as bench.py builds it: Noah-MP with its
# glacier column (ideal_ridge_model initialises it as bench.py does)
FULLPHYS_RRTMG = dict(FULLPHYS_RRTMG_NOAH, lsm=C.LSM_NOAHMP)

RIDGE_PATHS = {"upwind": dict(), "MPDATA": dict(adv=C.ADV_MPDATA),
               "Thompson": dict(adv=C.ADV_MPDATA, mp=C.MP_THOMPSON),
               "fullphys": FULLPHYS,
               "linear": dict(windtype=C.WIND_LINEAR,
                              options_cb=linear_lut_options),
               "upwind_density": dict(options_cb=density_options),
               "MPDATA_density": dict(adv=C.ADV_MPDATA,
                                      options_cb=density_options),
               "upwind_mp_throttle": dict(options_cb=mp_throttle_options),
               "fullphys_mpdata": dict(FULLPHYS, adv=C.ADV_MPDATA),
               "fullphys_sb04": dict(FULLPHYS, mp=C.MP_SIMPLE,
                                     conv=C.CU_NONE),
               "fullphys_rrtmg_noah": FULLPHYS_RRTMG_NOAH,
               "fullphys_rrtmg": FULLPHYS_RRTMG,
               # bench.py's ridge with each of the other schemes in SB04's
               # place
               "wsm3": dict(mp=C.MP_WSM3),
               "wsm6": dict(mp=C.MP_WSM6),
               "morrison": dict(mp=C.MP_MORRISON),
               "fullphys_kf": dict(FULLPHYS, conv=C.CU_KF),
               "fullphys_nsas": dict(FULLPHYS, conv=C.CU_NSAS),
               "fullphys_bmj": dict(FULLPHYS, conv=C.CU_BMJ),
               "thompson_aer": dict(adv=C.ADV_MPDATA,
                                    mp=C.MP_THOMPSON_AER),
               "thompson_aer_aware": dict(adv=C.ADV_MPDATA,
                                          mp=C.MP_THOMPSON_AER,
                                          options_cb=aerosol_aware_options)}
# the paths a mesh shards in time_paths --mesh cards: fullphys there is
# bench.py --config conus (the full physics column on a mesh over every
# card), linear bench.py --config linear --sharded
SHARDED_PATHS = ("upwind", "MPDATA", "Thompson", "fullphys", "linear",
                 "upwind_density", "MPDATA_density", "upwind_mp_throttle",
                 "thompson_aer", "thompson_aer_aware")


def ideal_ridge_model(nx=300, ny=20, nz=20, dx=1000.0, hill_height=1000.0,
                      u_speed=10.0, rh=0.95, mp=C.MP_SIMPLE,
                      windtype=C.WIND_NONE, flat_z_height=-5,
                      dz_levels=None, rad=C.RA_NONE, pbl=C.PBL_NONE,
                      lsm=C.LSM_NONE, water=C.WATER_NONE,
                      adv=C.ADV_UPWIND, conv=C.CU_NONE,
                      options_cb=None, mesh=None, *,
                      device="cuda") -> ICARModel:
    """The standard ideal-ridge case (tests/gen_ideal_test.py semantics),
    with the JAX package's defaults, on ``device`` (the card by default).
    ``options_cb(options)`` can adjust scheme sub-options before the model
    is built. With ``mesh`` the model is sharded over it in the JAX
    package's order: the thermodynamic state, then ``attach_mesh``, then
    the initial wind solve (icar_tpu/models/icar.py:680-685; bench.py
    --config linear --sharded). With Noah-MP the land state is initialised
    as bench.py does (``init_noahmp_state``; the JAX package's
    ideal_ridge_model leaves that to its caller, bench.py)."""
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
    case = make_ideal_case(model.geom, u_profile=u_speed, rh=rh)
    if mesh is None:
        model.set_initial_conditions(case)
    else:
        model.set_initial_conditions(case, winds=False)
        model.attach_mesh(mesh)
        model.apply_winds(case.u, case.v, rotate=True)
    if model.options.physics.landsurface == C.LSM_NOAHMP:
        init_noahmp_state(model)
    return model

"""The main model driver: init -> forcing loop -> physics -> output
(icar_tpu/core/driver.py).

Replaces program icar (driver.f90 of the reference) and initialization
(init.f90): reads terrain + forcing files, builds the model on its device
(the card unless ``device="cpu"``; there is no fallback), shards it over a
device mesh when given one, and runs the outer loop -- ingest a forcing
step, regrid it on the device, run the wind solver on the target fields,
install the tendencies of every forced field, integrate to the next
forcing or output event, write output and restarts, or resume from a
checkpoint. ``main`` is the command line,
``python -m icar_tpu_torch options.nml [--device cpu] [--profile DIR]``.
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..config import Options
from ..forcing.boundary import (ForcingData, Regridder, compute_tendencies,
                                load_external_conditions)
from ..io.netcdf import NCFile
from ..io.output import (AsyncStepWriter, OutputWriter, ShardedOutputWriter,
                         read_restart, write_restart)
from ..models.icar import ICARModel
from ..utils.calendar import Time, TimeDelta
from ..utils.diagnostics_debug import Timers, domain_check
from .diagnostics import diagnostic_update


def load_domain(options: Options):
    """Read hi-res terrain/lat/lon from the init-conditions file
    (read_domain_shape + read_core_variables, domain_obj.f90:2144, 1324)."""
    path = options.forcing.init_conditions_file
    names = options.forcing.var_names
    with NCFile(path) as f:
        terrain = f.read(names.get("hgt_hi", "hgt_hi"))
        lat = f.read(names.get("lat_hi", "lat_hi"))
        lon = f.read(names.get("lon_hi", "lon_hi"))
    if terrain.ndim == 3:
        terrain, lat, lon = terrain[0], lat[0], lon[0]
    return (np.asarray(terrain, np.float64), np.asarray(lat, np.float64),
            np.asarray(lon, np.float64))


# reference output-metadata short names -> registry names
# (default_output_metadata.f90 name= entries)
OUTPUT_ALIASES = {
    "ta2m": "temperature_2m", "hus2m": "humidity_2m",
    "qv": "water_vapor", "qc": "cloud_water",
    "qi": "cloud_ice", "qr": "rain_mass", "qs": "snow_mass",
    "qg": "graupel_mass", "ts": "skin_temperature",
    "u10m": "u_10m", "v10m": "v_10m",
    "psfc": "surface_pressure", "hfss": "sensible_heat",
    "hfls": "latent_heat", "rsds": "shortwave",
    "rlds": "longwave", "pressure_i": "pressure_interface",
    "temperature_i": "temperature_interface",
    "cu_precipitation": "convective_precipitation",
    "precip": "precipitation"}


class ICARDriver:
    """Owns the model + forcing machinery and runs the outer loop.
    ``device``: the model's torch device; ``mesh`` (``parallel.mesh``, its
    devices of that type): the model is sharded over it after the
    initial, external, lake and Noah-MP set-up (icar_tpu/core/driver.py:
    67-73), and every interval runs on its blocks. The output engine
    (``output.engine``) is the default one-file writer, "classic-async"
    (one file a step) or "sharded" (one file per shard and step,
    ``io.output.ShardedOutputWriter``); restarts are whole-domain files
    either way, as the JAX driver writes them."""

    def __init__(self, options: Options, device="cuda", mesh=None):
        self.options = options
        self.timers = Timers()
        self.timers["init"].start()
        # the substep count of each advance of ``run``
        self.substeps = []
        terrain, lat, lon = load_domain(options)
        options.domain.ny, options.domain.nx = terrain.shape
        self.model = ICARModel(options, terrain, lat, lon, device=device)

        self.forcing = ForcingData(options)
        raw0 = self.forcing.read_step(0)
        self.regridder = Regridder.build(
            self.model.geom, self.forcing.lat, self.forcing.lon,
            raw0.get("z"), options, f_stag=self.forcing.stagger_coords,
            device=self.model.device)
        self._install_initial_conditions(raw0)
        self._install_external_conditions()
        self._init_lake()
        self._init_noahmp()
        if mesh is not None:
            self.model.attach_mesh(mesh)

        if options.output.engine == "classic-async":
            self.writer = AsyncStepWriter(options.output.output_file,
                                          self._output_names(), options)
        elif options.output.engine == "sharded":
            self.writer = ShardedOutputWriter(options.output.output_file,
                                              self._output_names(), options)
        else:
            out_name = options.output.output_file + "run.nc"
            self.writer = OutputWriter(out_name, self._output_names(), options)
        self.restart_base = options.output.restart_file
        # online precipitation bias correction (setup_bias_correction,
        # init.f90:300-321): monthly rain-fraction climatology, clipped to
        # [0.2, 5] then inverted
        self.use_rain_fraction = False
        if options.bias.use_bias_correction and options.bias.filename:
            with NCFile(options.bias.filename) as f:
                rf = np.asarray(f.read(options.bias.rain_fraction_var),
                                np.float32)
            if rf.ndim != 3:
                raise ValueError("rain_fraction must be (12, ny, nx)")
            self.model.set_rain_fraction(1.0 / np.clip(rf, 0.2, 5.0))
            self.use_rain_fraction = True
        self._stop("init")

    def _stop(self, name: str):
        """Stop a timer once the device has finished the work it times."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        self.timers[name].stop()

    def _output_names(self):
        names = list(self.options.output.names)
        if not names:
            names = ["u", "v", "w", "pressure", "potential_temperature",
                     "water_vapor", "cloud_water", "precipitation"]
        from .. import registry
        resolved = [OUTPUT_ALIASES.get(n, n) for n in names]
        for n in resolved:
            if n not in registry.spec_names():
                print(f"warning: requested output variable '{n}' is not "
                      "known; it will be skipped", file=sys.stderr)
        return resolved

    def _install_initial_conditions(self, raw0):
        """Full-3D initial state from the first forcing step
        (get_initial_conditions, domain_obj.f90:63-98)."""
        m = self.model
        target = self.regridder.to_model_grid(raw0, m.geom_t)
        s = dict(m.state)
        for name in ("potential_temperature", "water_vapor", "pressure",
                     "cloud_water", "cloud_ice",
                     "sst", "shortwave", "longwave",
                     "sensible_heat", "latent_heat", "hpbl",
                     "nwfa", "nifa"):
            if name in target and name in s:
                s[name] = target[name]
        if "nwfa" in target and "nwfa2d" in s:
            # the CCN replenishment flux from the ingested surface nwfa
            # (thompson_aer_init runs after the ingest in the reference;
            # mp_thompson_aer.f90:536-549), made on the host
            from ..physics.mp_thompson import aer_surface_flux
            s["nwfa2d"] = m._tensor(np.asarray(aer_surface_flux(
                target["nwfa"][0].detach().cpu().numpy(), m.geom.dx),
                np.float32))
        m.state = diagnostic_update(s, m.geom_t)
        u, v, w = m.compute_winds(target["u"], target["v"], rotate=True)
        s = dict(m.state)
        s["u"], s["v"], s["w"] = u, v, w
        m.state = diagnostic_update(s, m.geom_t)
        for name in ("skin_temperature", "sst", "soil_temperature",
                     "soil_deep_temperature"):
            if name in s and float(torch.max(torch.abs(s[name]))) == 0.0:
                m.state[name] = s["temperature"][0].expand(
                    s[name].shape).clone()

    def _install_external_conditions(self):
        """Externally-supplied surface/snow state (SWE, snow height, soil/skin
        temperature) overrides the defaults at init (init_external,
        external_bnd.f90)."""
        ext = load_external_conditions(self.options, self.model.geom,
                                       self.model.device)
        if not ext:
            return
        s = dict(self.model.state)
        applied = []
        for name, arr in ext.items():
            if name in s:
                if arr.dim() == 2 and s[name].dim() == 3:
                    arr = arr.expand(s[name].shape)
                s[name] = arr.to(s[name].dtype).clone()
                applied.append(name)
        self.model.state = s
        if applied:
            print("external initial conditions applied:", ", ".join(applied))

    def _init_lake(self):
        """The CLM lake's state (lakeini, water_lake.f90:4904-5431 via
        lsm_init, lsm_driver.f90:884-989; icar_tpu/core/driver.py:181-208):
        ``water_lake.lake_init`` on the host from the model's surface
        fields with the land-use table's lake and water categories, its
        fields uploaded to the model's device; the lake cells become water
        in ``land_mask`` (lsm_driver.f90:710, 880). Skipped on restart,
        whose file holds the lake state."""
        from .. import constants as C
        o = self.options
        if o.physics.watersurface != C.WATER_LAKE or o.run.restart:
            return
        from ..physics.water_lake import lake_init
        m = self.model
        fields = {k: v.detach().cpu().numpy().copy()
                  for k, v in m.state.items()}
        _, _, water_cat, lake_cat = o.lsm.resolved_categories()
        lake_init(fields, np.asarray(m.geom.terrain),
                  np.asarray(m.geom.lat), lake_category=lake_cat,
                  water_category=water_cat,
                  lakedepth_default=o.lsm.lakedepth_default,
                  lake_min_elev=o.lsm.lake_min_elev)
        s = dict(m.state)
        for k, v in fields.items():
            if k in s:
                s[k] = torch.as_tensor(np.asarray(v), dtype=s[k].dtype,
                                       device=m.device)
        lake = torch.as_tensor(fields["lakemask"] > 0.5, device=m.device)
        if "land_mask" in s:
            s["land_mask"] = torch.where(lake, 2.0, s["land_mask"])
        m.state = s
        print(f"lake model initialized: {int(fields['lakemask'].sum())} "
              f"lake cells")

    def _init_noahmp(self):
        """The Noah-MP prognostic state (noahmp_init + snow_init,
        lsm_noahmpdrv.f90:1443-2149; icar_tpu/core/driver.py:210-252):
        ``noahmp.noahmp_init_state`` on the host from the model's surface
        fields, its fields uploaded to the model's device. Skipped on
        restart, whose file holds them."""
        from .. import constants as C
        o = self.options
        if o.physics.landsurface != C.LSM_NOAHMP or o.run.restart:
            return
        from ..physics import noahmp as nmp
        from ..physics.noah_params import load_tables
        from ..physics.noahmp_params import load_mp_tables
        m = self.model
        s = dict(m.state)
        host = {k: s[k].detach().cpu().numpy() for k in (
            "skin_temperature", "swe", "snow_height", "soil_temperature",
            "soil_water_content", "soil_type", "veg_type")}
        init = nmp.noahmp_init_state(
            host["skin_temperature"], np.asarray(host["swe"], np.float32),
            host["snow_height"], host["soil_temperature"],
            host["soil_water_content"], host["soil_type"],
            host["veg_type"],
            load_mp_tables(lu_categories=o.lsm.LU_Categories),
            load_tables())
        mapping = {
            "snow_albedo_prev": "albold", "snow_water_eq_prev": "sneqvo",
            "soil_liquid_water": "sh2o", "soil_water_content": "smc",
            "canopy_temperature": "tah",
            "canopy_vapor_pressure": "eah", "canopy_fwet": "fwet",
            "canopy_water_liquid": "canliq", "canopy_water_ice": "canice",
            "veg_leaf_temperature": "tv", "ground_surf_temperature": "tg",
            "snow_layer_depth": "zsnso", "snow_height": "snowh",
            "snow_layer_ice": "snice",
            "snow_layer_liquid_water": "snliq",
            "water_table_depth": "zwt", "water_aquifer": "wa",
            "storage_gw": "wt", "lai": "lai", "sai": "sai",
            "coeff_momentum_drag": "cm", "coeff_heat_exchange": "ch",
            "snow_age_factor": "tauss", "swe": "sneqv",
        }
        up = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                       device=m.device)
        for field, key in mapping.items():
            if field in s:
                s[field] = up(init[key])
        s["snow_nlayers"] = up(init["isnow"])
        nsn = s["snow_temperature"].shape[0]
        s["snow_temperature"] = up(init["stc"][:nsn])
        s["soil_temperature"] = up(init["stc"][nsn:])
        m.state = s
        print("NoahMP state initialized")

    def _rain_frac_month(self, t):
        """Month index of the bias-correction climatology at model time t
        (apply_rain_fraction month selection, mp_driver.f90:357-359)."""
        date = self.options.start_time() + TimeDelta(t)
        n = self.model._rain_frac_months.shape[0]
        return min(int(n * date.year_fraction()), n - 1)

    def forcing_tendencies(self, raw):
        """Target fields -> wind solve -> tendencies of every forced field
        (update_winds update path + update_delta_fields,
        driver.f90:128-138); the current fields are the whole domain's
        (gathered from the blocks on a mesh)."""
        m = self.model
        target = self.regridder.to_model_grid(raw, m.geom_t)
        u, v, w = m.compute_winds(target["u"], target["v"], rotate=True)
        target["u"], target["v"], target["w"] = u, v, w
        current = m._global_fields([k for k in target if k in m._held()])
        m.set_forcing_tendencies(compute_tendencies(
            current, target, self.options.forcing.input_interval))

    def _pick_restart(self) -> str:
        """The checkpoint to resume from (driver.f90:81-87): an explicit
        &restart_info restart_file, the newest checkpoint at/before
        restart_date, or simply the most recent one
        (init_restart_options, options_obj.f90:476-540)."""
        o = self.options
        if o.run.restart_in_file:
            return o.run.restart_in_file
        cands = sorted(glob.glob(self.restart_base + "*.nc")
                       + glob.glob(self.restart_base + "*.npz"))
        if not cands:
            raise FileNotFoundError(
                f"restart requested but no checkpoint matches "
                f"{self.restart_base}*.nc|npz")
        if not o.run.restart_date:
            return cands[-1]
        want = (Time.from_string(o.run.restart_date, o.run.calendar)
                - o.start_time()).seconds()

        def t_of(p):
            stem = os.path.splitext(p)[0]
            try:
                return int(stem[-8:])
            except ValueError:
                return -1
        eligible = [p for p in cands if 0 <= t_of(p) <= want + 1]
        if not eligible:
            raise FileNotFoundError(
                f"no checkpoint at or before restart_date "
                f"{o.run.restart_date} (t={want:.0f}s) in "
                f"{self.restart_base}*.nc|npz")
        return max(eligible, key=t_of)

    def run(self):
        """The outer loop (driver.f90:119-199)."""
        o = self.options
        total_seconds = (o.end_time() - o.start_time()).seconds()
        input_dt = o.forcing.input_interval
        output_dt = o.output.output_interval
        restart_every = max(1, o.output.restart_count)

        t = 0.0
        n_outputs = 0
        if o.run.restart:
            pick = self._pick_restart()
            t = read_restart(pick, self.model)
            n_outputs = int(round(t / output_dt))
            print(f"restarted from {pick} at t={t:.0f}s")
        else:
            self.timers["output"].start()
            self.writer.write_step(self.model, t)
            self._stop("output")
        next_output = (n_outputs + 1) * output_dt
        n_steps_total = self.forcing.n_steps()
        step_idx = int(t // input_dt) + 1

        debug = self.options.run.debug
        next_progress_pct = 5.0
        while t < total_seconds - 1e-3:
            # ingest the next forcing step (cycling the last one if short)
            self.timers["input"].start()
            idx = min(step_idx, n_steps_total - 1)
            self.forcing_tendencies(self.forcing.read_step(idx))
            self._stop("input")
            step_idx += 1
            input_end = min(t + input_dt, total_seconds)

            while t < input_end - 1e-3:
                target_t = min(next_output, input_end)
                month = (self._rain_frac_month(t)
                         if self.use_rain_fraction else None)
                self.timers["physics"].start()
                self.model.advance(target_t - t, rain_frac_month=month)
                self._stop("physics")
                self.substeps.append(self.model.last_n_substeps)
                t = target_t
                if debug:
                    self.model._install(domain_check(
                        self.model._global_state(), msg=f"t={t:.0f}s",
                        fix=True)[0])
                pct = 100.0 * t / total_seconds
                if pct >= next_progress_pct:
                    # 5% progress ticker (print_progress,
                    # time_step.f90:342-364)
                    print(f"  {pct:5.1f}% complete (t={t:.0f}s)",
                          flush=True)
                    next_progress_pct = (pct // 5.0 + 1) * 5.0
                if abs(t - next_output) < 1e-3:
                    self.timers["output"].start()
                    self.writer.write_step(self.model, t)
                    n_outputs += 1
                    next_output += output_dt
                    if n_outputs % restart_every == 0:
                        write_restart(
                            f"{self.restart_base}{int(t):08d}.nc",
                            self.model, t)
                    self._stop("output")
        if hasattr(self.writer, "wait"):
            errors = self.writer.wait()
            if errors:
                print(f"WARNING: {errors} async output write(s) failed")
        print(self.timers.report())
        return self.model


def _profiler(profile_dir: Optional[str], device: str):
    """A torch.profiler context over the run (CPU, and the card's kernels
    on a CUDA device) whose trace goes to ``profile_dir``, or a null
    context."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def export(prof):
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "icar_trace.json")
        prof.export_chrome_trace(path)
        print(prof.key_averages().table(
            sort_by="self_cuda_time_total" if len(acts) > 1
            else "self_cpu_time_total", row_limit=15))
        print(f"profile trace: {path}")
    return profile(activities=acts, on_trace_ready=export)


USAGE = ("usage: python -m icar_tpu_torch <options_namelist> "
         "[--device cpu|cuda] [--profile DIR]")


def main(argv=None):
    """CLI entry: ``python -m icar_tpu_torch options.nml [--device DEV]
    [--profile DIR]`` (mirrors ./icar icar_options.nml). The run is on the
    card unless ``--device cpu``; ``--profile DIR`` wraps it in a
    torch.profiler trace (Chrome trace format in DIR, and a table of the
    operations with the most time) -- the counterpart of the reference's
    MODE=profile build (src/makefile:14-16). Returns the exit code."""
    args = list(argv if argv is not None else sys.argv[1:])
    opts = {"--device": "cuda", "--profile": None}
    for flag in opts:
        if flag in args:
            i = args.index(flag)
            if i + 1 >= len(args):
                print(USAGE)
                return 1
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    if len(args) != 1:
        print(USAGE)
        return 1
    options = Options.from_namelist(args[0])
    options.validate()
    driver = ICARDriver(options, device=opts["--device"])
    if opts["--profile"]:
        print(f"profiling to {opts['--profile']}")
    with _profiler(opts["--profile"], opts["--device"]):
        driver.run()
    print(f"icar_tpu_torch run complete: {driver.writer.path}")
    return 0

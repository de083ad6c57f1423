"""Copy of icar_tpu/config.py, kept identical by tests/test_torch_setup.py.

Typed model configuration.

Replaces the reference options object tree (src/objects/
opt_types.f90, options_obj.f90): namelist groups become dataclasses, and
``Options.from_namelist`` reads the same ICAR ``.nml`` files the reference
consumes (options_obj.f90:45-86), so existing run configurations port over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from . import constants as C
from .utils.calendar import GREGORIAN, Time, normalize_calendar
from .utils.namelist import read_namelist


@dataclass
class PhysicsOptions:
    """Scheme selectors (opt_types.f90:15-24 physics_type)."""
    microphysics: int = C.MP_SIMPLE
    advection: int = C.ADV_UPWIND
    windtype: int = C.WIND_NONE
    boundarylayer: int = C.PBL_NONE
    radiation: int = C.RA_NONE
    landsurface: int = C.LSM_NONE
    watersurface: int = C.WATER_NONE
    convection: int = C.CU_NONE


@dataclass
class LtOptions:
    """Linear-theory options (opt_types.f90:63-96 lt_options_type)."""
    buffer: int = 50                  # topography FFT buffer cells
    stability_window_size: int = 10
    vert_smooth: int = 10
    max_stability: float = 6e-4
    min_stability: float = 1e-7
    variable_n: bool = True
    n_squared: float = 3e-5           # background Brunt-Vaisala freq. squared
    linear_update_fraction: float = 1.0
    linear_contribution: float = 1.0
    smooth_nsq: bool = True
    # spatial LUT dimensions
    spatial_linear_fields: bool = True
    dirmax: float = 2 * C.PI
    dirmin: float = 0.0
    spdmax: float = 30.0
    spdmin: float = 0.0
    nsqmax: float = -7.42  # log(6e-4) ~ -7.42
    nsqmin: float = -16.12  # log(1e-7)
    n_dir_values: int = 36
    n_spd_values: int = 10
    n_nsq_values: int = 10
    read_lut: bool = False
    write_lut: bool = False
    lut_filename: str = "linear_theory_lut.nc"
    # per-device budget for the spatial LUT (the reference prints the
    # per-image footprint and leaves the user to right-size
    # n_spd/n_dir/n_nsq — linear_winds.f90:664-682; we enforce it)
    max_lut_gb: float = 6.0
    # host-memory budget for the chunked LUT build (the host only ever
    # holds one ~24-entry chunk of buffered-terrain FFT workspace — the
    # GLOBAL table never exists on the host; linear_winds.f90:596-830
    # per-image build+store semantics)
    max_host_gb: float = 16.0
    # LUT storage dtype: "float32" or "bfloat16". bf16 halves both the
    # footprint and the once-per-update table stream; the trilinear
    # interpolation accumulates in f32 either way and the quantization
    # error (~0.4%) is far below the 4% analytic-oracle tolerance and
    # the linear_update_fraction relaxation.
    lut_dtype: str = "float32"


@dataclass
class AdvOptions:
    """Advection options (opt_types.f90:101-105)."""
    mpdata_order: int = 2
    boundary_buffer: bool = False
    flux_corrected_transport: bool = True
    h_order: int = 1
    v_order: int = 1


@dataclass
class MpOptions:
    """Microphysics options (opt_types.f90:30-60; Thompson tunables with
    the mp_parameters namelist defaults, options_obj.f90:1258-1281)."""
    update_interval: float = 0.0      # max seconds between MP calls
    top_mp_level: int = 0             # 0 = all levels
    local_precip_fraction: float = 1.0
    Nt_c: float = 100e6
    TNO: float = 5.0
    am_s: float = 0.069
    rho_g: float = 500.0
    av_s: float = 40.0
    bv_s: float = 0.55
    fv_s: float = 100.0
    av_g: float = 442.0
    bv_g: float = 0.89
    av_i: float = 1847.5
    Ef_si: float = 0.05
    Ef_rs: float = 0.95
    Ef_rg: float = 0.75
    Ef_ri: float = 0.95
    C_cubes: float = 0.5
    C_sqrd: float = 0.3
    mu_r: float = 0.0
    t_adjust: float = 0.0
    Ef_rw_l: bool = False
    Ef_sw_l: bool = False
    # mp=5 only: run the Thompson-Eidhammer scheme aerosol-aware with
    # prognostic nc/nwfa/nifa (is_aerosol_aware, mp_thompson_aer.f90:58).
    # Default off = the reference driver's behavior, which passes no
    # aerosol fields (mp_driver.f90:446-476)
    use_aerosol_aware: bool = False


@dataclass
class CuOptions:
    tendency_fraction: float = 1.0
    tend_qv_fraction: float = 1.0
    tend_qc_fraction: float = 1.0
    tend_th_fraction: float = 1.0
    tend_qi_fraction: float = 1.0


@dataclass
class BlockOptions:
    """Flow-blocking parameterization (block_parameters namelist,
    options_obj.f90:1340-1385)."""
    block_flow: bool = False
    blocking_contribution: float = 0.5
    smooth_froude_distance: float = 6000.0
    n_smoothing_passes: int = 3
    block_fr_max: float = 0.75
    block_fr_min: float = 0.5


@dataclass
class BiasOptions:
    """Online precipitation bias correction (bias_parameters namelist,
    options_obj.f90:1722-1765)."""
    use_bias_correction: bool = False
    filename: str = ""
    rain_fraction_var: str = "rain_fraction"


@dataclass
class LsmOptions:
    update_interval: float = 300.0
    monthly_albedo: bool = False
    monthly_vegfrac: bool = False
    sh_feedback_fraction: float = 1.0
    lh_feedback_fraction: float = 1.0
    max_swe: float = 1e10
    LU_Categories: str = "MODIFIED_IGBP_MODIS_NOAH"
    # land-use special categories; -1 = resolve from LU_Categories
    # (set_default_LU_categories, options_obj.f90:1669-1711)
    urban_category: int = -1
    ice_category: int = -1
    water_category: int = -1
    lake_category: int = -1
    # lake model knobs (lsm_driver.f90:887-893, 952-955)
    lakedepth_default: float = 50.0
    lake_min_elev: float = 5.0

    def resolved_categories(self):
        """(urban, ice, water, lake) with LU-table defaults filled in."""
        lu = self.LU_Categories.upper()
        defaults = {
            "MODIFIED_IGBP_MODIS_NOAH": (13, 15, 17, 21),
            "USGS": (1, 24, 16, -1),            # no separate lake category
            "USGS-RUC": (1, 24, 16, 28),
            "MODI-RUC": (13, 15, 17, 21),
        }.get(lu, (13, 15, 17, 21))
        out = []
        for v, d in zip((self.urban_category, self.ice_category,
                         self.water_category, self.lake_category), defaults):
            out.append(v if v != -1 else d)
        return tuple(out)


@dataclass
class RadOptions:
    update_interval_rrtmg: float = 1800.0
    icloud: int = 3                  # Thompson cal_cldfra3 (reference default)
    read_ghg: bool = False
    tzone: float = 0.0
    use_simple_sw: bool = False      # full RRTMG-SW (reference default);
                                     # true = RRTMG-LW + simple shortwave
    rrtmg_support_dir: str = "rrtmg_support"


@dataclass
class OutputOptions:
    names: List[str] = field(default_factory=list)
    output_interval: float = 3600.0
    output_file: str = "icar_out_"
    restart_count: int = 24           # restarts every N outputs
    restart_file: str = "icar_rst_"
    frames_per_outfile: int = 24
    engine: str = "netcdf4"           # "netcdf4" (h5py, one growing file) or
                                      # "classic-async" (native C++ worker,
                                      # one CDF-2 file per output step)


@dataclass
class DomainOptions:
    """Grid geometry parameters (subset of parameter_options_type)."""
    nx: int = 100
    ny: int = 100
    nz: int = 20
    dx: float = 4000.0
    dz_levels: List[float] = field(default_factory=lambda: [500.0] * 20)
    space_varying_dz: bool = True
    flat_z_height: float = -1         # see find_flat_model_level semantics
    sleve: bool = False
    terrain_smooth_windowsize: int = 4
    terrain_smooth_cycles: int = 5
    decay_rate_l_topo: float = 2.0
    decay_rate_s_topo: float = 5.0
    sleve_n: float = 1.2
    fixed_dz_advection: bool = True   # use dz_levels for advection dz (wind.f90:528-534)
    longitude_system: str = "auto"


@dataclass
class ForcingOptions:
    init_conditions_file: str = ""
    boundary_files: List[str] = field(default_factory=list)
    forcing_file_list: str = ""
    external_files: str = ""
    input_interval: float = 3600.0
    time_varying_z: bool = False
    z_is_geopotential: bool = False
    z_is_on_interface: bool = False
    t_is_potential: bool = True
    t_offset: float = 0.0
    qv_is_relative_humidity: bool = False
    qv_is_spec_humidity: bool = False
    smooth_wind_distance: float = -1.0  # <0: default = dx of forcing
    longitude_system: int = 0           # 0 maintain / 1..2 convert / 3 guess
    # use_agl_height/agl_cap are accepted for namelist compatibility but
    # inert, which is exact parity: the reference's AGL scaling factor
    # ((AGL_nz-i)/AGL_nz, domain_obj.f90:2292-2295) is Fortran INTEGER
    # division and evaluates to 0 for every level i in 1..AGL_nz, so the
    # feature is a no-op in ICAR 2.x.
    use_agl_height: bool = False
    agl_cap: float = 300.0
    limit_rain: bool = False
    # forcing variable names (var_list namelist)
    var_names: dict = field(default_factory=lambda: {
        "p": "p", "theta": "theta", "t": "t", "qv": "qv", "u": "u", "v": "v",
        "qc": "", "qi": "", "qr": "", "qs": "", "qg": "",
        "pb": "", "zb": "",
        "sh": "", "lh": "", "pblh": "",
        "ulat": "", "ulon": "", "vlat": "", "vlon": "",
        "hgt": "hgt", "z": "z", "lat": "lat", "lon": "lon",
        "lat_hi": "lat_hi", "lon_hi": "lon_hi", "hgt_hi": "hgt_hi",
        "sst": "", "swdown": "", "lwdown": "", "sinalpha": "", "cosalpha": "",
        "landmask": "",
    })


@dataclass
class RunOptions:
    start_date: str = "2020-12-01 00:00:00"
    end_date: str = "2020-12-02 00:00:00"
    forcing_start_date: str = ""
    calendar: str = GREGORIAN
    restart: bool = False
    restart_date: str = ""            # restart at/just before this date
    restart_in_file: str = ""         # explicit checkpoint path
    cfl_reduction_factor: float = 0.9
    cfl_strictness: int = 3
    wind_iterations: int = 100        # iterative wind solver steps
    advect_density: bool = False
    use_terrain_difference: bool = False
    debug: bool = False
    interactive: bool = False
    batched_exchange: bool = True     # fuse halo exchanges across species
    warning_level: int = 4


@dataclass
class Options:
    physics: PhysicsOptions = field(default_factory=PhysicsOptions)
    domain: DomainOptions = field(default_factory=DomainOptions)
    forcing: ForcingOptions = field(default_factory=ForcingOptions)
    run: RunOptions = field(default_factory=RunOptions)
    output: OutputOptions = field(default_factory=OutputOptions)
    lt: LtOptions = field(default_factory=LtOptions)
    adv: AdvOptions = field(default_factory=AdvOptions)
    mp: MpOptions = field(default_factory=MpOptions)
    cu: CuOptions = field(default_factory=CuOptions)
    bias: BiasOptions = field(default_factory=BiasOptions)
    block: BlockOptions = field(default_factory=BlockOptions)
    lsm: LsmOptions = field(default_factory=LsmOptions)
    rad: RadOptions = field(default_factory=RadOptions)
    version: str = C.VERSION_STRING
    comment: str = ""

    # ------------------------------------------------------------------
    def start_time(self) -> Time:
        return Time.from_string(self.run.start_date, self.run.calendar)

    def end_time(self) -> Time:
        return Time.from_string(self.run.end_date, self.run.calendar)

    def halo_width(self) -> int:
        """Halo width from the advection stencil order, not hardcoded
        (improves on icar_constants.f90:320 kDEFAULT_HALO_SIZE=1)."""
        return 2 if self.physics.advection == C.ADV_MPDATA else 1

    def validate(self):
        """Config sanity checking (options_check, options_obj.f90:318)."""
        errs = []
        d = self.domain
        if len(d.dz_levels) < d.nz:
            errs.append(f"dz_levels has {len(d.dz_levels)} entries < nz={d.nz}")
        if d.nx < 4 or d.ny < 4 or d.nz < 2:
            errs.append(f"domain too small: {d.nx}x{d.ny}x{d.nz}")
        if self.run.cfl_reduction_factor > 1.0:
            errs.append("cfl_reduction_factor > 1 is unstable")
        if self.physics.microphysics == C.MP_SIMPLE and self.physics.convection not in (C.CU_NONE, C.CU_SIMPLE):
            errs.append("mp_simple is not tuned for use with deep convection schemes")
        if self.mp.top_mp_level > 0:
            import sys
            print("warning: mp top_mp_level is not implemented in icar_tpu; "
                  "microphysics runs on all levels", file=sys.stderr)
        if self.mp.local_precip_fraction != 1.0:
            import sys
            print("warning: mp local_precip_fraction != 1 is not implemented "
                  "in icar_tpu; precipitation is not redistributed",
                  file=sys.stderr)
        known = {
            "mp": (self.physics.microphysics, range(0, 7)),
            "adv": (self.physics.advection, range(0, 3)),
            "wind": (self.physics.windtype, (0, 1, 2, 3, 5)),
            "pbl": (self.physics.boundarylayer, range(0, 4)),
            "rad": (self.physics.radiation, range(0, 4)),
            "lsm": (self.physics.landsurface, range(0, 5)),
            "water": (self.physics.watersurface, range(0, 4)),
            "conv": (self.physics.convection, range(0, 6)),
        }
        implemented = {
            "mp": (C.MP_NONE, C.MP_THOMPSON, C.MP_SIMPLE, C.MP_MORRISON,
                   C.MP_WSM6, C.MP_THOMPSON_AER, C.MP_WSM3),
            "adv": (C.ADV_NONE, C.ADV_UPWIND, C.ADV_MPDATA),
            "wind": (C.WIND_NONE, C.WIND_LINEAR, C.WIND_CONSERVE_MASS,
                     C.WIND_ITERATIVE, C.WIND_LINEAR_ITERATIVE),
            "pbl": (C.PBL_NONE, C.PBL_SIMPLE, C.PBL_YSU),
            "rad": (C.RA_NONE, C.RA_BASIC, C.RA_SIMPLE, C.RA_RRTMG),
            "lsm": (C.LSM_NONE, C.LSM_BASIC, C.LSM_NOAH, C.LSM_NOAHMP),
            "water": (C.WATER_NONE, C.WATER_SIMPLE, C.WATER_LAKE),
            "conv": (C.CU_NONE, C.CU_TIEDTKE, C.CU_KF, C.CU_NSAS,
                     C.CU_BMJ),
        }
        if self.output.engine not in ("netcdf4", "classic-async", "sharded"):
            errs.append(f"unknown output engine {self.output.engine!r} "
                        f"(use 'netcdf4' or 'classic-async')")
        for name, (val, valid) in known.items():
            if val not in valid:
                errs.append(f"unknown {name} scheme id {val}")
            elif val not in implemented[name]:
                errs.append(
                    f"{name}={val} is a valid ICAR scheme but is not "
                    f"implemented in icar_tpu yet (implemented: "
                    f"{sorted(implemented[name])})")
        # graded consistency rules (options_check, options_obj.f90:318-470):
        # warning_level controls whether a rule warns, auto-corrects, or
        # stops the run (warning-level semantics, opt_types.f90:317-325).
        import sys
        wl = self.run.warning_level
        wind = self.physics.windtype

        def warn(msg):
            print(f"WARNING: {msg}", file=sys.stderr)

        if wind == C.WIND_ITERATIVE and not self.domain.fixed_dz_advection:
            if wl == 10:
                errs.append("wind=3 requires fixed_dz_advection=.True. "
                            "(warning_level=10)")
            elif wl > 3:
                warn("wind=3 is best used with fixed_dz_advection=.True.; "
                     "setting it")
                self.domain.fixed_dz_advection = True
        if wind in (C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE) \
                and self.domain.fixed_dz_advection:
            if wl == 10:
                errs.append("wind=1/5 requires fixed_dz_advection=.False. "
                            "(warning_level=10)")
            elif wl > 3:
                warn("wind=1 or 5 is best used with "
                     "fixed_dz_advection=.False.; setting it")
                self.domain.fixed_dz_advection = False
        if wind == C.WIND_NONE and self.domain.fixed_dz_advection:
            warn("setting fixed_dz_advection=False for wind=0")
            self.domain.fixed_dz_advection = False
        if wind == C.WIND_CONSERVE_MASS and not self.domain.fixed_dz_advection:
            warn("setting fixed_dz_advection=True for wind=2")
            self.domain.fixed_dz_advection = True
        if self.physics.landsurface > 1 \
                and self.physics.boundarylayer == C.PBL_NONE:
            if wl >= 7:
                errs.append("LSM without a PBL scheme may overheat the "
                            "surface (set warning_level<7 to continue)")
            elif wl > 2:
                warn("running an LSM without a PBL scheme may overheat "
                     "the surface and crash the model")
        if self.physics.landsurface == 1 \
                and self.physics.boundarylayer == C.PBL_NONE:
            if wl >= 5:
                errs.append("prescribed LSM fluxes without a PBL may "
                            "overheat the surface (set warning_level<5 "
                            "to continue)")
            elif wl > 0:
                warn("prescribed LSM fluxes without a PBL may overheat "
                     "the surface and crash the model")
        if wind in (C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE) \
                and self.lt.spatial_linear_fields \
                and self.domain.nx and self.domain.ny:
            # early size signal; the hard per-device check (which knows
            # the mesh size) runs at LUT build (ops/linear_winds.
            # check_lut_budget; mirrors the reference's per-image size
            # printout, linear_winds.f90:682)
            from .ops.linear_winds import lut_size_bytes
            gb = lut_size_bytes(self.lt, self.domain.nz, self.domain.ny,
                                self.domain.nx) / 2 ** 30
            if gb > self.lt.max_lut_gb:
                warn(f"linear-theory spatial LUT is {gb:.1f} GB total at "
                     f"{self.lt.n_spd_values}x{self.lt.n_dir_values}x"
                     f"{self.lt.n_nsq_values} entries; it must be "
                     f"sharded over >= {-int(-gb // self.lt.max_lut_gb)} "
                     f"devices or shrunk via lt_parameters "
                     f"n_spd/n_dir/n_nsq_values (budget max_lut_gb="
                     f"{self.lt.max_lut_gb})")
        if errs:
            raise ValueError("invalid options:\n  " + "\n  ".join(errs))
        return self

    # ------------------------------------------------------------------
    @classmethod
    def from_namelist(cls, path: str) -> "Options":
        """Build Options from an ICAR-style namelist file
        (groups read: model_version, physics, parameters, z_info,
        output_list, files_list, var_list, lt_parameters, adv_parameters...)."""
        nml = read_namelist(path)
        o = cls()

        mv = nml.get("model_version", {})
        o.version = str(mv.get("version", o.version))
        from .utils.model_tracking import check_version
        check_version(o.version)
        o.comment = str(mv.get("comment", ""))

        ph = nml.get("physics", {})
        o.physics = PhysicsOptions(
            microphysics=int(ph.get("mp", 0)),
            advection=int(ph.get("adv", 1)),
            windtype=int(ph.get("wind", 0)),
            boundarylayer=int(ph.get("pbl", 0)),
            radiation=int(ph.get("rad", 0)),
            landsurface=int(ph.get("lsm", 0)),
            watersurface=int(ph.get("water", 0)),
            convection=int(ph.get("conv", 0)),
        )

        pm = nml.get("parameters", {})
        if "dx" in pm:
            o.domain.dx = float(pm["dx"])
        if "nz" in pm:
            o.domain.nz = int(pm["nz"])
        zi = nml.get("z_info", {})
        if "dz_levels" in zi:
            dz = zi["dz_levels"]
            o.domain.dz_levels = [float(x) for x in (dz if isinstance(dz, list) else [dz])]
            if "nz" not in pm:
                o.domain.nz = len(o.domain.dz_levels)
        if "space_varying" in zi:
            o.domain.space_varying_dz = bool(zi["space_varying"])
        if "flat_z_height" in zi:
            o.domain.flat_z_height = float(zi["flat_z_height"])
        if "sleve" in zi:
            o.domain.sleve = bool(zi["sleve"])
        if "fixed_dz_advection" in zi:
            o.domain.fixed_dz_advection = bool(zi["fixed_dz_advection"])
        for k_nml, k_attr in [("terrain_smooth_windowsize", "terrain_smooth_windowsize"),
                              ("terrain_smooth_cycles", "terrain_smooth_cycles"),
                              ("decay_rate_l_topo", "decay_rate_l_topo"),
                              ("decay_rate_s_topo", "decay_rate_s_topo"),
                              ("sleve_n", "sleve_n")]:
            if k_nml in zi:
                setattr(o.domain, k_attr, type(getattr(o.domain, k_attr))(zi[k_nml]))

        for key, attr, conv in [
            ("start_date", "start_date", str), ("end_date", "end_date", str),
            ("forcing_start_date", "forcing_start_date", str),
            ("cfl_reduction_factor", "cfl_reduction_factor", float),
            ("cfl_strictness", "cfl_strictness", int),
            ("wind_iterations", "wind_iterations", int),
            ("advect_density", "advect_density", bool),
            ("use_terrain_difference", "use_terrain_difference", bool),
            ("debug", "debug", bool), ("interactive", "interactive", bool),
            ("restart", "restart", bool),
            ("warning_level", "warning_level", int),
            ("batched_exchange", "batched_exchange", bool),
        ]:
            if key in pm:
                setattr(o.run, attr, conv(pm[key]))
        if "calendar" in pm:
            o.run.calendar = normalize_calendar(str(pm["calendar"]))

        # &restart_info: which checkpoint to resume from
        # (init_restart_options, options_obj.f90:476-540). restart_step is
        # accepted but unused: icar_tpu checkpoints hold one snapshot each.
        ri = nml.get("restart_info", {})
        if "restart_file" in ri:
            o.run.restart_in_file = str(ri["restart_file"])
        if "restart_date" in ri:
            rd = ri["restart_date"]
            if isinstance(rd, list):
                vals = [int(x) for x in rd] + [0] * (6 - len(rd))
                if min(vals[:3]) > 0:      # reference sentinel: -999 = unset
                    o.run.restart_date = (
                        f"{vals[0]:04d}-{vals[1]:02d}-{vals[2]:02d} "
                        f"{vals[3]:02d}:{vals[4]:02d}:{vals[5]:02d}")
            else:
                o.run.restart_date = str(rd)

        for key, attr, conv in [
            ("inputinterval", "input_interval", float),
            ("time_varying_z", "time_varying_z", bool),
            ("z_is_geopotential", "z_is_geopotential", bool),
            ("z_is_on_interface", "z_is_on_interface", bool),
            ("t_is_potential", "t_is_potential", bool),
            ("t_offset", "t_offset", float),
            ("qv_is_relative_humidity", "qv_is_relative_humidity", bool),
            ("qv_is_spec_humidity", "qv_is_spec_humidity", bool),
            ("smooth_wind_distance", "smooth_wind_distance", float),
            ("use_agl_height", "use_agl_height", bool),
            ("agl_cap", "agl_cap", float),
            ("longitude_system", "longitude_system", int),
        ]:
            if key in pm:
                setattr(o.forcing, attr, conv(pm[key]))

        fl = nml.get("files_list", {})
        if "init_conditions_file" in fl:
            o.forcing.init_conditions_file = str(fl["init_conditions_file"])
        if "boundary_files" in fl:
            bf = fl["boundary_files"]
            o.forcing.boundary_files = bf if isinstance(bf, list) else [bf]
        if "forcing_file_list" in fl:
            o.forcing.forcing_file_list = str(fl["forcing_file_list"])
        if "external_files" in fl:
            o.forcing.external_files = str(fl["external_files"])

        vl = nml.get("var_list", {})
        name_map = {  # namelist key -> canonical forcing slot
            "pvar": "p", "tvar": "t", "qvvar": "qv", "uvar": "u", "vvar": "v",
            "qcvar": "qc", "qivar": "qi",
            "qrvar": "qr", "qsvar": "qs", "qgvar": "qg",
            "pbvar": "pb", "zbvar": "zb",
            "shvar": "sh", "lhvar": "lh", "pblhvar": "pblh",
            "ulat": "ulat", "ulon": "ulon",
            "vlat": "vlat", "vlon": "vlon",
            "hgtvar": "hgt", "zvar": "z", "latvar": "lat", "lonvar": "lon",
            "lat_hi": "lat_hi", "lon_hi": "lon_hi", "hgt_hi": "hgt_hi",
            "sst_var": "sst", "swdown_var": "swdown", "lwdown_var": "lwdown",
            "sinalpha_var": "sinalpha", "cosalpha_var": "cosalpha",
            "landvar": "landmask",
        }
        for k_nml, slot in name_map.items():
            if k_nml in vl:
                o.forcing.var_names[slot] = str(vl[k_nml])

        ol = nml.get("output_list", {})
        if "names" in ol:
            nm = ol["names"]
            o.output.names = nm if isinstance(nm, list) else [nm]
        if "outputinterval" in ol:
            o.output.output_interval = float(ol["outputinterval"])
        if "output_file" in ol:
            o.output.output_file = str(ol["output_file"])
        if "restartinterval" in ol:
            o.output.restart_count = int(ol["restartinterval"])
        if "restart_file" in ol:
            o.output.restart_file = str(ol["restart_file"])
        if "engine" in ol:
            o.output.engine = str(ol["engine"])
        # frames_per_outfile lives in &parameters in the reference
        # (options_obj.f90:1054); accept it in either group
        for grp in (ol, pm):
            if "frames_per_outfile" in grp:
                o.output.frames_per_outfile = int(grp["frames_per_outfile"])

        # Per-physics namelist groups may be redirected to separate files
        # via <prefix>_options_filename in &parameters (defaulting to the
        # main options file; options_obj.f90:64-71,1057-1080). The
        # reference additionally gates each group behind a use_<prefix>_
        # options flag; here a group present in the resolved file is
        # always honored (a superset: setting the flag without the group
        # is a no-op in both).
        import os

        _group_cache: dict = {}

        def _group(name: str) -> dict:
            prefix = name.split("_")[0]
            sub = pm.get(f"{prefix}_options_filename")
            if not sub or os.path.abspath(str(sub)) == os.path.abspath(path):
                return nml.get(name, {})
            sub = str(sub)
            if not os.path.exists(sub):
                # resolve relative to the main options file, as users
                # typically run from elsewhere
                cand = os.path.join(os.path.dirname(os.path.abspath(path)), sub)
                if os.path.exists(cand):
                    sub = cand
            if sub not in _group_cache:
                _group_cache[sub] = read_namelist(sub)
            return _group_cache[sub].get(name, {})

        lt = _group("lt_parameters")
        for f in dataclasses.fields(LtOptions):
            if f.name in lt:
                setattr(o.lt, f.name, type(getattr(o.lt, f.name))(lt[f.name]))
        ad = _group("adv_parameters")
        for f in dataclasses.fields(AdvOptions):
            if f.name in ad:
                setattr(o.adv, f.name, type(getattr(o.adv, f.name))(ad[f.name]))
        bi = _group("bias_parameters")
        if "bias_correction_filename" in bi:
            o.bias.filename = str(bi["bias_correction_filename"])
            o.bias.use_bias_correction = True
        if "rain_fraction_var" in bi:
            o.bias.rain_fraction_var = str(bi["rain_fraction_var"])
        if "use_bias_correction" in pm:
            o.bias.use_bias_correction = bool(pm["use_bias_correction"])
        mp = _group("mp_parameters")
        lowered = {k.lower(): v for k, v in mp.items()}
        for f in dataclasses.fields(MpOptions):
            if f.name.lower() in lowered:
                setattr(o.mp, f.name,
                        type(getattr(o.mp, f.name))(lowered[f.name.lower()]))

        # lsm_parameters / cu_parameters / rad_parameters: plain
        # field-for-field namelist groups (options_obj.f90:1537+,1767+,1860+)
        for group, obj, cls_ in (("lsm_parameters", o.lsm, LsmOptions),
                                 ("cu_parameters", o.cu, CuOptions),
                                 ("rad_parameters", o.rad, RadOptions),
                                 ("block_parameters", o.block,
                                  BlockOptions)):
            grp = {k.lower(): v for k, v in _group(group).items()}
            for f in dataclasses.fields(cls_):
                if f.name.lower() in grp:
                    cur = getattr(obj, f.name)
                    conv = type(cur) if not callable(cur) else str
                    setattr(obj, f.name, conv(grp[f.name.lower()]))

        return o

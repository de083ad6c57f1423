"""Copy of icar_tpu/registry.py, kept identical by tests/test_torch_setup.py.

Declarative variable registry.

One table replaces three reference subsystems:
  * the ``kVARS`` integer registry (src/constants/icar_constants.f90:26-290)
  * per-package ``*_var_request`` calls (src/main/options_obj.f90:95-229)
  * CF output metadata (src/io/default_output_metadata.f90)

Array layout convention for the TPU rebuild: 3D fields are ``(z, y, x)`` —
x is the fastest (128-lane) dimension, (y, x) are the large tiled dims that
map onto the 8x128 VPU registers, z stays unsharded (column physics is
z-local, SURVEY.md section 5).  The reference uses Fortran (i, k, j) =
(x, z, y) with x fastest; both put x innermost in memory.

Staggering: 'x' means nx+1 points (u grid), 'y' means ny+1 (v grid),
'zi' means nz+1 interface levels. Mirrors grid_obj.f90 nx_extra/ny_extra.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class VarSpec:
    name: str
    dims: str                 # '3d' | '2d'
    stagger: Optional[str] = None   # None | 'x' | 'y' | 'zi'
    units: str = ""
    standard_name: str = ""
    forcing_name: Optional[str] = None  # default name in forcing files
    dtype: str = "float32"    # precip accumulators are float64 (variable_h.f90:15)
    default: float = 0.0
    force_boundaries: bool = True  # 3D advected scalars are forced at lateral
                                   # boundaries only (domain_obj.f90:2400-2428)

    def shape(self, nz: int, ny: int, nx: int) -> Tuple[int, ...]:
        if self.dims == "2d":
            return (ny + (self.stagger == "y"), nx + (self.stagger == "x"))
        if self.dims == "soil":
            return (NUM_SOIL_LAYERS, ny, nx)
        if self.dims == "lake":
            return (NUM_LAKE_LAYERS, ny, nx)
        if self.dims == "soisno":
            return (NUM_SNOW_LAYERS + NUM_SOIL_LAYERS, ny, nx)
        if self.dims == "soisno_i":
            return (NUM_SNOW_LAYERS + NUM_SOIL_LAYERS + 1, ny, nx)
        if self.dims == "snowlayer":
            return (NUM_NMP_SNOW_LAYERS, ny, nx)
        if self.dims == "snowsoil":
            return (NUM_NMP_SNOW_LAYERS + NUM_SOIL_LAYERS, ny, nx)
        dz = nz + 1 if self.stagger == "zi" else nz
        return (dz, ny + (self.stagger == "y"), nx + (self.stagger == "x"))


# Noah/NoahMP soil column depth (lsm_driver.f90:517 DZs=[0.1,0.3,0.6,1.0])
NUM_SOIL_LAYERS = 4
# CLM lake model column (water_lake.f90:44-46)
NUM_LAKE_LAYERS = 10
NUM_SNOW_LAYERS = 5
# NoahMP snow stack (lsm_noahmpdrv.f90:512)
NUM_NMP_SNOW_LAYERS = 3


def _v(name, dims="3d", **kw) -> VarSpec:
    return VarSpec(name=name, dims=dims, **kw)


# --- the registry -----------------------------------------------------------
# Prognostic wind / mass fields
_SPECS = [
    _v("u", stagger="x", units="m s-1", standard_name="grid_eastward_wind", forcing_name="u"),
    _v("v", stagger="y", units="m s-1", standard_name="grid_northward_wind", forcing_name="v"),
    _v("w", units="m s-1", standard_name="upward_air_velocity_grid"),
    _v("w_real", units="m s-1", standard_name="upward_air_velocity"),
    _v("pressure", units="Pa", standard_name="air_pressure", forcing_name="p"),
    _v("pressure_interface", stagger=None, units="Pa"),
    _v("potential_temperature", units="K", standard_name="air_potential_temperature", forcing_name="theta"),
    _v("temperature", units="K", standard_name="air_temperature"),
    _v("temperature_interface", units="K"),
    _v("exner", units="1"),
    _v("density", units="kg m-3", standard_name="air_density"),
    _v("nsquared", units="s-2", standard_name="square_of_brunt_vaisala_frequency_in_air"),
    # moisture species
    _v("water_vapor", units="kg kg-1", standard_name="mixing_ratio_of_water_vapor", forcing_name="qv"),
    _v("cloud_water", units="kg kg-1", standard_name="cloud_liquid_water_mixing_ratio"),
    _v("cloud_number", units="kg-1"),
    _v("cloud_ice", units="kg kg-1", standard_name="cloud_ice_mixing_ratio"),
    _v("ice_number", units="kg-1"),
    _v("rain_mass", units="kg kg-1", standard_name="mass_fraction_of_rain_in_air"),
    _v("rain_number", units="kg-1"),
    _v("snow_mass", units="kg kg-1", standard_name="mass_fraction_of_snow_in_air"),
    _v("snow_number", units="kg-1"),
    _v("graupel_mass", units="kg kg-1", standard_name="mass_fraction_of_graupel_in_air"),
    _v("graupel_number", units="kg-1"),
    # water/ice-friendly aerosol numbers (Thompson-Eidhammer aerosol-aware
    # scheme, mp_thompson_aer.f90:417)
    _v("nwfa", units="kg-1", standard_name="number_of_water_friendly_aerosols_in_air", forcing_name="nwfa"),
    _v("nifa", units="kg-1", standard_name="number_of_ice_friendly_aerosols_in_air", forcing_name="nifa"),
    # CCN surface-emission rate derived at init from the lowest-level
    # nwfa (thompson_aer_init, mp_thompson_aer.f90:536-549)
    _v("nwfa2d", dims="2d", units="kg-1 s-1"),
    # effective radii for radiation coupling (Thompson-Eidhammer, mp=5)
    _v("re_cloud", units="m", standard_name="effective_radius_of_cloud_droplets", default=2.49e-6),
    _v("re_ice", units="m", standard_name="effective_radius_of_cloud_ice", default=4.99e-6),
    _v("re_snow", units="m", standard_name="effective_radius_of_snow", default=9.99e-6),
    # surface accumulations (double precision in the reference, variable_h.f90:15)
    _v("precipitation", dims="2d", units="mm", standard_name="precipitation_amount", dtype="float64"),
    _v("snowfall", dims="2d", units="mm", standard_name="snowfall_amount", dtype="float64"),
    _v("graupel", dims="2d", units="mm", dtype="float64"),
    # geometry
    _v("z", units="m", standard_name="height_above_reference_ellipsoid"),
    _v("z_interface", stagger="zi", units="m"),
    _v("dz", units="m"),
    _v("dz_interface", units="m"),
    _v("terrain", dims="2d", units="m", standard_name="surface_altitude", forcing_name="hgt"),
    _v("latitude", dims="2d", units="degrees_north", forcing_name="lat"),
    _v("longitude", dims="2d", units="degrees_east", forcing_name="lon"),
    # diagnostics
    _v("u_mass", units="m s-1", standard_name="eastward_wind"),
    _v("v_mass", units="m s-1", standard_name="northward_wind"),
    _v("surface_pressure", dims="2d", units="Pa", standard_name="surface_air_pressure"),
    _v("u_10m", dims="2d", units="m s-1"),
    _v("v_10m", dims="2d", units="m s-1"),
    _v("temperature_2m", dims="2d", units="K"),
    _v("humidity_2m", dims="2d", units="kg kg-1"),
    _v("ustar", dims="2d", units="m s-1"),
    _v("hpbl", dims="2d", units="m", standard_name="atmosphere_boundary_layer_thickness"),
    _v("exch_h", units="m2 s-1"),
    _v("ivt", dims="2d", units="kg m-1 s-1"),
    _v("iwv", dims="2d", units="kg m-2"),
    _v("iwl", dims="2d", units="kg m-2"),
    _v("iwi", dims="2d", units="kg m-2"),
    # radiation / surface
    _v("shortwave", dims="2d", units="W m-2", standard_name="surface_downwelling_shortwave_flux_in_air", forcing_name="swdown"),
    _v("longwave", dims="2d", units="W m-2", standard_name="surface_downwelling_longwave_flux_in_air", forcing_name="lwdown"),
    _v("cloud_fraction", dims="2d", units="1"),
    _v("skin_temperature", dims="2d", units="K", forcing_name="tskin"),
    _v("sst", dims="2d", units="K", forcing_name="sst"),
    _v("sensible_heat", dims="2d", units="W m-2"),
    _v("latent_heat", dims="2d", units="W m-2"),
    _v("roughness_z0", dims="2d", units="m", default=0.01),
    _v("albedo", dims="2d", units="1", default=0.17),
    _v("vegetation_fraction", dims="2d", units="1", default=0.5),
    _v("land_mask", dims="2d", units="1", default=1.0),
    # BMJ prognostic cloud efficiency (cu_driver.f90:28, cu_bmj.f90 CLDEFI)
    _v("cldefi", dims="2d", units="1", default=0.6),
    # soil / snow state (LSM + external initial conditions)
    _v("soil_water_content", dims="soil", units="m3 m-3", default=0.3),
    _v("soil_temperature", dims="soil", units="K"),
    _v("soil_liquid_water", dims="soil", units="m3 m-3", default=0.3),
    _v("soil_deep_temperature", dims="2d", units="K", forcing_name="tsoil_deep"),
    _v("canopy_water", dims="2d", units="mm"),
    _v("snow_cover", dims="2d", units="1"),
    _v("snow_albedo_max", dims="2d", units="1", default=0.8),
    _v("snow_time", dims="2d", units="s"),
    _v("emissivity", dims="2d", units="1", default=0.99),
    _v("ground_heat_flux", dims="2d", units="W m-2"),
    _v("runoff_surface", dims="2d", units="mm", dtype="float64"),
    _v("runoff_subsurface", dims="2d", units="mm", dtype="float64"),
    _v("veg_type", dims="2d", units="1", default=10.0),
    _v("soil_type", dims="2d", units="1", default=6.0),
    _v("rainbl", dims="2d", units="mm", dtype="float64"),
    # convection (cu_var_request, cu_driver.f90:146-230)
    _v("tend_qv_adv", units="kg kg-1 s-1"),
    _v("tend_qv_pbl", units="kg kg-1 s-1"),
    _v("convective_precipitation", dims="2d", units="mm", dtype="float64"),
    _v("swe", dims="2d", units="mm", standard_name="liquid_water_content_of_surface_snow"),
    _v("snow_height", dims="2d", units="m", standard_name="surface_snow_thickness"),
    # CLM lake model state (water=3; kVARS lake fields, lsm_driver.f90:216-237)
    _v("lake_depth", dims="2d", units="m", forcing_name="lake_depth"),
    _v("lakemask", dims="2d", units="1"),
    _v("lakedepth2d", dims="2d", units="m", default=50.0),
    _v("savedtke12d", dims="2d", units="W m-1 K-1", default=0.6),
    _v("snl2d", dims="2d", units="1"),
    _v("t_grnd2d", dims="2d", units="K", default=277.0),
    _v("t_lake3d", dims="lake", units="K", default=277.0),
    _v("lake_icefrac3d", dims="lake", units="1"),
    _v("z_lake3d", dims="lake", units="m"),
    _v("dz_lake3d", dims="lake", units="m", default=5.0),
    _v("t_soisno3d", dims="soisno", units="K", default=277.0),
    _v("h2osoi_ice3d", dims="soisno", units="kg m-2"),
    _v("h2osoi_liq3d", dims="soisno", units="kg m-2"),
    _v("h2osoi_vol3d", dims="soisno", units="m3 m-3"),
    _v("z3d", dims="soisno", units="m"),
    _v("dz3d", dims="soisno", units="m", default=0.1),
    _v("zi3d", dims="soisno_i", units="m"),
    _v("watsat3d", dims="soil", units="m3 m-3", default=0.42),
    _v("csol3d", dims="soil", units="J m-3 K-1", default=2.2e6),
    _v("tkmg3d", dims="soil", units="W m-1 K-1", default=1.5),
    _v("tkdry3d", dims="soil", units="W m-1 K-1", default=0.2),
    _v("tksatu3d", dims="soil", units="W m-1 K-1", default=1.0),
    # NoahMP prognostic state (lsm=4; kVARS names from the noahmplsm call,
    # lsm_driver.f90:1340-1512)
    _v("snow_nlayers", dims="2d", units="1"),
    _v("veg_leaf_temperature", dims="2d", units="K", default=285.0),
    _v("ground_surf_temperature", dims="2d", units="K", default=285.0),
    _v("canopy_water_ice", dims="2d", units="mm"),
    _v("canopy_water_liquid", dims="2d", units="mm"),
    _v("canopy_vapor_pressure", dims="2d", units="Pa", default=2000.0),
    _v("canopy_temperature", dims="2d", units="K", default=285.0),
    _v("coeff_momentum_drag", dims="2d", units="1"),
    _v("coeff_heat_exchange", dims="2d", units="1"),
    _v("canopy_fwet", dims="2d", units="1"),
    _v("snow_water_eq_prev", dims="2d", units="mm"),
    _v("snow_albedo_prev", dims="2d", units="1", default=0.65),
    _v("snow_age_factor", dims="2d", units="1"),
    _v("water_table_depth", dims="2d", units="m", default=2.5),
    _v("water_aquifer", dims="2d", units="mm", default=4900.0),
    _v("storage_gw", dims="2d", units="mm", default=4900.0),
    _v("lai", dims="2d", units="m2 m-2", default=0.5),
    _v("sai", dims="2d", units="m2 m-2", default=0.1),
    _v("snow_temperature", dims="snowlayer", units="K"),
    _v("snow_layer_depth", dims="snowsoil", units="m"),
    _v("snow_layer_ice", dims="snowlayer", units="mm"),
    _v("snow_layer_liquid_water", dims="snowlayer", units="mm"),
    # RRTMG radiation (rad=3): stored tendencies applied every substep
    # between radiation updates (ra_driver.f90:505) + diagnostics
    _v("tend_th_lwrad", units="K s-1"),
    _v("tend_th_swrad", units="K s-1"),
    _v("out_longwave_rad", dims="2d", units="W m-2"),
    _v("longwave_cloud_forcing", dims="2d", units="W m-2"),
    _v("shortwave_cloud_forcing", dims="2d", units="W m-2"),
    # direct/diffuse split of the downwelling surface shortwave
    # (SWDDIR/SWDDIF of ra_rrtmg_sw; default_output_metadata.f90
    # shortwave_direct/shortwave_diffuse)
    _v("shortwave_direct", dims="2d", units="W m-2",
       standard_name="surface_direct_downwelling_shortwave_flux_in_air"),
    _v("shortwave_diffuse", dims="2d", units="W m-2",
       standard_name="surface_diffuse_downwelling_shortwave_flux_in_air"),
    _v("cosine_zenith_angle", dims="2d", units="1"),
    # Kain-Fritsch (conv=3) persistent state: the W0AVG running-mean w
    # (cu_kf.f90:193-207), the NCA countdown + rain rate frozen between
    # re-triggers (":224-230"), and the stored feedback tendencies
    _v("kf_w0avg", units="m s-1"),
    _v("kf_nca", dims="2d", units="s", default=-100.0),
    _v("kf_prate", dims="2d", units="mm s-1"),
    _v("tend_th_cu", units="K s-1"),
    _v("tend_qv_cu", units="kg kg-1 s-1"),
    _v("tend_qc_cu", units="kg kg-1 s-1"),
    _v("tend_qr_cu", units="kg kg-1 s-1"),
    _v("tend_qi_cu", units="kg kg-1 s-1"),
    _v("tend_qs_cu", units="kg kg-1 s-1"),
]

REGISTRY = {s.name: s for s in _SPECS}


def spec_names():
    """All known variable names (for output-request validation)."""
    return REGISTRY.keys()

# The full hydrometeor set that can be advected (advect.f90:400-410)
HYDROMETEORS = (
    "water_vapor", "cloud_water", "rain_mass", "snow_mass", "cloud_ice",
    "graupel_mass", "ice_number", "rain_number", "snow_number",
    "graupel_number",
)


@dataclass
class VarRequest:
    """Accumulates which variables each physics package needs.

    Mirrors options_obj.f90:145-229 (alloc_vars / advect_vars / restart_vars).
    """
    alloc: set = field(default_factory=set)
    advect: list = field(default_factory=list)   # ordered, advection loops over it
    restart: set = field(default_factory=set)

    def alloc_vars(self, names):
        self.alloc.update(names)

    def advect_vars(self, names):
        for n in names:
            if n not in self.advect:
                self.advect.append(n)
        self.alloc.update(names)

    def restart_vars(self, names):
        self.restart.update(names)
        self.alloc.update(names)


def collect_requests(options) -> VarRequest:
    """Gather variable requests from every enabled physics package.

    Mirrors collect_physics_requests (options_obj.f90:95-107).
    """
    from . import constants as C

    req = VarRequest()
    # core vars always present (domain_obj.f90:2107 var_request)
    req.alloc_vars([
        "u", "v", "w", "pressure", "potential_temperature", "water_vapor",
        "exner", "density", "temperature", "z", "z_interface", "dz",
        "dz_interface", "terrain", "latitude", "longitude",
        "u_mass", "v_mass", "w_real", "pressure_interface",
        "temperature_interface", "surface_pressure",
    ])
    req.restart_vars(["u", "v", "w", "pressure", "potential_temperature", "water_vapor"])

    phys = options.physics
    if phys.advection != C.ADV_NONE:
        req.alloc_vars(["u", "v", "w", "dz_interface"])
    if phys.microphysics == C.MP_SIMPLE:
        # mp_simple_var_request (mp_simple.f90:104-126)
        req.alloc_vars(["pressure", "potential_temperature", "exner", "density",
                        "water_vapor", "cloud_water", "rain_mass", "snow_mass",
                        "precipitation", "snowfall", "dz"])
        req.advect_vars(["potential_temperature", "water_vapor", "cloud_water",
                         "rain_mass", "snow_mass"])
        req.restart_vars(["precipitation", "snowfall", "cloud_water",
                          "rain_mass", "snow_mass"])
    elif phys.microphysics in (C.MP_THOMPSON, C.MP_THOMPSON_AER):
        req.alloc_vars(["pressure", "potential_temperature", "exner", "density",
                        "water_vapor", "cloud_water", "cloud_ice", "rain_mass",
                        "snow_mass", "graupel_mass", "ice_number", "rain_number",
                        "precipitation", "snowfall", "graupel", "dz"])
        req.advect_vars(["potential_temperature", "water_vapor", "cloud_water",
                         "cloud_ice", "rain_mass", "snow_mass", "graupel_mass",
                         "ice_number", "rain_number"])
        req.restart_vars(["precipitation", "snowfall", "graupel", "cloud_water",
                          "cloud_ice", "rain_mass", "snow_mass", "graupel_mass",
                          "ice_number", "rain_number"])
        if phys.microphysics == C.MP_THOMPSON_AER:
            # mp_thompson_aer_var_request (mp_driver.f90:115-144)
            req.alloc_vars(["re_cloud", "re_ice", "re_snow"])
            req.restart_vars(["re_cloud", "re_ice", "re_snow"])
            if getattr(options.mp, "use_aerosol_aware", False):
                # prognostic droplet number + CCN/IN aerosols, advected
                # like the hydrometeors (is_aerosol_aware=.true. path,
                # mp_thompson_aer.f90:440,1188-1194)
                req.alloc_vars(["cloud_number", "nwfa", "nifa", "nwfa2d"])
                req.advect_vars(["cloud_number", "nwfa", "nifa"])
                req.restart_vars(["cloud_number", "nwfa", "nifa",
                                  "nwfa2d"])
    elif phys.microphysics == C.MP_WSM3:
        # 3-class: qci doubles as cloud/ice, qrs as rain/snow
        # (mp_driver.f90:554-575)
        req.alloc_vars(["pressure", "potential_temperature", "exner", "density",
                        "water_vapor", "cloud_water", "rain_mass", "w_real",
                        "precipitation", "snowfall", "dz"])
        req.advect_vars(["potential_temperature", "water_vapor", "cloud_water",
                         "rain_mass"])
        req.restart_vars(["precipitation", "snowfall", "cloud_water",
                          "rain_mass"])
    elif phys.microphysics == C.MP_MORRISON:
        # Morrison 2-moment: 4 prognostic number concentrations advected
        # alongside the 5 hydrometeor species (mp_morrison.f90:553-562);
        # w feeds the (currently diagnostic-only) activation machinery
        req.alloc_vars(["pressure", "potential_temperature", "exner",
                        "density", "water_vapor", "cloud_water", "cloud_ice",
                        "rain_mass", "snow_mass", "graupel_mass",
                        "ice_number", "snow_number", "rain_number",
                        "graupel_number", "w_real", "precipitation",
                        "snowfall", "graupel", "dz"])
        req.advect_vars(["potential_temperature", "water_vapor",
                         "cloud_water", "cloud_ice", "rain_mass", "snow_mass",
                         "graupel_mass", "ice_number", "snow_number",
                         "rain_number", "graupel_number"])
        req.restart_vars(["precipitation", "snowfall", "graupel",
                          "cloud_water", "cloud_ice", "rain_mass",
                          "snow_mass", "graupel_mass", "ice_number",
                          "snow_number", "rain_number", "graupel_number"])
    elif phys.microphysics != C.MP_NONE:
        # WSM6 family
        req.alloc_vars(["pressure", "potential_temperature", "exner", "density",
                        "water_vapor", "cloud_water", "cloud_ice", "rain_mass",
                        "snow_mass", "graupel_mass", "precipitation", "snowfall",
                        "graupel", "dz"])
        req.advect_vars(["potential_temperature", "water_vapor", "cloud_water",
                         "cloud_ice", "rain_mass", "snow_mass", "graupel_mass"])
        req.restart_vars(["precipitation", "snowfall", "cloud_water",
                          "cloud_ice", "rain_mass", "snow_mass", "graupel_mass"])
    else:
        # even with no microphysics, theta and qv are advected (CI Schaer test)
        req.advect_vars(["potential_temperature", "water_vapor"])

    if phys.convection == C.CU_BMJ:
        req.alloc_vars(["temperature", "pressure", "pressure_interface",
                        "exner", "density", "water_vapor",
                        "potential_temperature", "land_mask", "cldefi",
                        "precipitation", "convective_precipitation"])
        req.restart_vars(["convective_precipitation", "cldefi"])
    if phys.convection in (C.CU_TIEDTKE, C.CU_NSAS):
        req.alloc_vars(["temperature", "pressure", "pressure_interface",
                        "exner", "density", "u_mass", "v_mass", "w_real",
                        "water_vapor", "cloud_water", "cloud_ice",
                        "potential_temperature", "sensible_heat",
                        "latent_heat", "tend_qv_adv", "tend_qv_pbl",
                        "land_mask", "precipitation",
                        "convective_precipitation"])
        req.restart_vars(["convective_precipitation"])
    if phys.convection == C.CU_NSAS:
        req.alloc_vars(["hpbl"])
    if phys.convection == C.CU_KF:
        # kfinit + the commented KFCPS call (cu_driver.f90:158-170,332-352)
        req.alloc_vars(["temperature", "pressure", "exner", "density",
                        "u_mass", "v_mass", "w_real", "water_vapor",
                        "cloud_water", "cloud_ice", "rain_mass",
                        "snow_mass", "potential_temperature",
                        "precipitation", "convective_precipitation",
                        "kf_w0avg", "kf_nca", "kf_prate", "tend_th_cu",
                        "tend_qv_cu", "tend_qc_cu", "tend_qr_cu",
                        "tend_qi_cu", "tend_qs_cu"])
        req.restart_vars(["convective_precipitation", "kf_w0avg",
                          "kf_nca", "kf_prate", "tend_th_cu",
                          "tend_qv_cu", "tend_qc_cu", "tend_qr_cu",
                          "tend_qi_cu", "tend_qs_cu"])
    if phys.windtype in (C.WIND_LINEAR, C.WIND_LINEAR_ITERATIVE):
        # wind_linear_var_request (wind.f90:32-56)
        req.alloc_vars(["nsquared", "potential_temperature", "exner",
                        "water_vapor", "cloud_water", "rain_mass",
                        "u", "v", "w", "dz"])
        req.restart_vars(["nsquared"])
    if phys.boundarylayer == C.PBL_SIMPLE:
        req.alloc_vars(["potential_temperature", "water_vapor", "exner",
                        "density", "u_mass", "v_mass", "z"])
    elif phys.boundarylayer == C.PBL_YSU:
        # ysu needs surface fluxes/similarity inputs + cloud ice
        # (pbl_driver.f90:223-346)
        req.alloc_vars(["potential_temperature", "water_vapor", "cloud_water",
                        "cloud_ice", "exner", "density", "u_mass", "v_mass",
                        "temperature", "pressure", "pressure_interface",
                        "surface_pressure", "skin_temperature",
                        "sensible_heat", "latent_heat", "ustar", "u_10m",
                        "v_10m", "roughness_z0", "land_mask", "hpbl",
                        "exch_h"])
        req.restart_vars(["hpbl"])
    if phys.radiation in (C.RA_SIMPLE, C.RA_RRTMG, C.RA_BASIC):
        req.alloc_vars(["shortwave", "longwave", "cloud_fraction",
                        "potential_temperature", "exner", "water_vapor",
                        "cloud_water", "rain_mass", "snow_mass"])
    if phys.radiation == C.RA_RRTMG:
        # rrtmg var requests (ra_driver.f90:104-166)
        req.alloc_vars(["tend_th_lwrad", "tend_th_swrad", "temperature",
                        "temperature_interface", "pressure",
                        "pressure_interface", "density",
                        "skin_temperature", "emissivity", "albedo",
                        "cloud_ice", "re_cloud", "re_ice", "re_snow",
                        "out_longwave_rad", "longwave_cloud_forcing",
                        "shortwave_cloud_forcing",
                        "shortwave_direct", "shortwave_diffuse",
                        "cosine_zenith_angle", "land_mask",
                        "snow_mass"])
        req.restart_vars(["tend_th_lwrad", "tend_th_swrad"])
    if phys.landsurface != C.LSM_NONE:
        req.alloc_vars(["skin_temperature", "sensible_heat", "latent_heat",
                        "temperature_2m", "humidity_2m", "ustar",
                        "roughness_z0", "albedo", "vegetation_fraction",
                        "land_mask", "shortwave", "longwave",
                        "soil_water_content", "soil_temperature",
                        "swe", "snow_height"])
        req.restart_vars(["skin_temperature", "soil_water_content",
                          "soil_temperature", "swe", "snow_height"])
    if phys.landsurface == C.LSM_NOAH:
        # full Noah column state (lsm_var_request, lsm_driver.f90:115-242)
        req.alloc_vars(["soil_liquid_water", "soil_deep_temperature",
                        "canopy_water", "snow_cover", "snow_albedo_max",
                        "snow_time", "emissivity", "ground_heat_flux",
                        "runoff_surface", "runoff_subsurface", "veg_type",
                        "soil_type", "rainbl", "u_10m", "v_10m",
                        "precipitation", "surface_pressure", "temperature",
                        "pressure_interface", "density", "u_mass", "v_mass"])
        req.restart_vars(["soil_liquid_water", "canopy_water", "snow_cover",
                          "snow_time", "albedo", "emissivity",
                          "roughness_z0", "rainbl"])
    if phys.landsurface == C.LSM_NOAHMP:
        # NoahMP prognostic column (lsm_var_request for kLSM_NOAHMP,
        # lsm_driver.f90:145-242)
        req.alloc_vars(["soil_liquid_water", "soil_deep_temperature",
                        "canopy_water", "snow_cover", "emissivity",
                        "ground_heat_flux", "runoff_surface",
                        "runoff_subsurface", "veg_type", "soil_type",
                        "rainbl", "u_10m", "v_10m", "precipitation",
                        "surface_pressure", "temperature",
                        "pressure_interface", "density", "u_mass",
                        "v_mass", "snow_nlayers", "veg_leaf_temperature",
                        "ground_surf_temperature", "canopy_water_ice",
                        "canopy_water_liquid", "canopy_vapor_pressure",
                        "canopy_temperature", "coeff_momentum_drag",
                        "coeff_heat_exchange", "canopy_fwet",
                        "snow_water_eq_prev", "snow_albedo_prev",
                        "snow_age_factor", "water_table_depth",
                        "water_aquifer", "storage_gw", "lai", "sai",
                        "snow_temperature", "snow_layer_depth",
                        "snow_layer_ice", "snow_layer_liquid_water"])
        req.restart_vars(["soil_liquid_water", "canopy_water_ice",
                          "canopy_water_liquid", "canopy_vapor_pressure",
                          "canopy_temperature", "canopy_fwet",
                          "veg_leaf_temperature",
                          "ground_surf_temperature", "snow_nlayers",
                          "snow_water_eq_prev", "snow_albedo_prev",
                          "snow_age_factor", "water_table_depth",
                          "water_aquifer", "storage_gw", "lai", "sai",
                          "snow_temperature", "snow_layer_depth",
                          "snow_layer_ice", "snow_layer_liquid_water",
                          "coeff_momentum_drag", "coeff_heat_exchange",
                          "rainbl"])
    if phys.watersurface != C.WATER_NONE:
        req.alloc_vars(["sst", "skin_temperature", "sensible_heat",
                        "latent_heat", "ustar", "land_mask"])
    if phys.watersurface == C.WATER_LAKE:
        # lake_var_request (lsm_driver.f90:216-237)
        req.alloc_vars(["lake_depth", "lakemask", "lakedepth2d",
                        "savedtke12d", "snl2d", "t_grnd2d", "t_lake3d",
                        "lake_icefrac3d", "z_lake3d", "dz_lake3d",
                        "t_soisno3d", "h2osoi_ice3d", "h2osoi_liq3d",
                        "h2osoi_vol3d", "z3d", "dz3d", "zi3d", "watsat3d",
                        "csol3d", "tkmg3d", "tkdry3d", "tksatu3d",
                        "veg_type", "soil_type", "swe", "snow_height",
                        "emissivity", "albedo", "ground_heat_flux",
                        "temperature_2m", "humidity_2m", "rainbl",
                        "precipitation", "u_mass", "v_mass", "temperature",
                        "pressure_interface", "water_vapor", "shortwave",
                        "longwave", "latitude"])
        req.restart_vars(["lakemask", "lakedepth2d", "savedtke12d", "snl2d",
                          "t_grnd2d", "t_lake3d", "lake_icefrac3d",
                          "z_lake3d", "dz_lake3d", "t_soisno3d",
                          "h2osoi_ice3d", "h2osoi_liq3d", "h2osoi_vol3d",
                          "z3d", "dz3d", "zi3d", "watsat3d", "csol3d",
                          "tkmg3d", "tkdry3d", "tksatu3d", "swe",
                          "snow_height"])

    # diagnostics always useful
    req.alloc_vars(["ivt", "iwv", "iwl", "iwi", "u_10m", "v_10m", "ustar",
                    "roughness_z0"])
    return req


def np_dtype(spec: VarSpec):
    return np.float64 if spec.dtype == "float64" else np.float32

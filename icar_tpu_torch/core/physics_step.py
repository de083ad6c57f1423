"""The column physics of one substep of the general loop: radiation, the
land and water surface, the surface fluxes, the boundary layer and
convection, in the operator order of icar_tpu/core/step.py
``physics_step`` (:241-803): ra_simple or RRTMG (its calls throttled, its
heating applied every substep; with radiation=1 the forcing's radiation
stays), the throttled surface (simple water, the lake, then Noah or
Noah-MP; with lsm=1 the forcing's fluxes stay on land), apply_fluxes, YSU
or pbl_simple, then Tiedtke, Kain-Fritsch, NSAS or BMJ. The microphysics
and the advection that follow run on the species stack
(``core/step.py``).

Each stage takes the state dict ``s`` (the advected species as rows of
the stack, or tensors that replaced them) and returns a new dict with the
fields it replaced. ``dt`` is the substep's length as a 0-d float32 tensor
on the state's device. None of these schemes has a TPU kernel: they are
plain PyTorch on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import constants as C
from ..ops.pointwise import inv
from ..physics import (cloud_fraction, cu_bmj, cu_kf, cu_nsas, cu_tiedtke,
                       lsm_noah, noahmp, noahmp_glacier, pbl_simple,
                       ra_simple, rrtmg_lw, rrtmg_sw, surface, water_lake,
                       ysu)
from ..physics.ghg import ghg_for_options
from ..physics.noah_params import load_tables
from ..physics.noahmp_params import load_mp_tables, resolve_params


class Statics:
    """What the column physics reads besides the state, made once per
    interval on the state's device: the lowest layer's height above the
    ground (z_atm), the interface and mass-level thicknesses, heights and
    terrain, the solar geometry's longitude and sin/cos of the latitude
    (numpy float32 as the JAX package forms them), the Noah tables
    (``noah_params.load_tables``)
    and the grid spacing; with ``options`` that run RRTMG, its k-tables on
    the state's device (``rrtmg_lw.get_lw_tables`` and, unless
    ``use_simple_sw``, ``rrtmg_sw.get_sw_tables``, uploaded once per table
    set and device) and the greenhouse gases of the run's start
    (``ghg.ghg_for_options``). ``geom`` is a block's geometry on a sharded
    domain; ``shard`` (``parallel.mesh.Shard``), where the block is not
    the whole domain, gives its columns' place in the domain (``columns``:
    their row-major indices and the domain's column count), from which
    RRTMG's McICA draws are taken (``rrtmg_lw.BlockCdf``)."""

    def __init__(self, geom, options=None, shard=None):
        self.noah_tables = load_tables()
        self.columns = (None if shard is None or shard.whole else
                        (shard.columns(), shard.domain[0] * shard.domain[1]))
        self.dx = float(geom.dx)
        self.dz = geom.dz_interface
        self.dz_mass = geom.dz_mass
        self.z = geom.z
        self.terrain = geom.terrain
        self.z_atm = geom.z[0] - geom.terrain
        self.lon = geom.lon
        self.lat = geom.lat
        lat = geom.lat.cpu().numpy()
        dev = geom.z.device
        self.mp_tables = self.zsoil = None
        if options is not None \
                and options.physics.landsurface == C.LSM_NOAHMP:
            self.mp_tables = load_mp_tables(
                lu_categories=options.lsm.LU_Categories)
            self.zsoil = torch.as_tensor(noahmp.ZSOIL, device=dev)
        self.sin_lat = torch.as_tensor(np.sin(lat * (np.pi / 180.0)),
                                       device=dev)
        self.cos_lat = torch.as_tensor(np.cos(lat * (np.pi / 180.0)),
                                       device=dev)
        self.lw_tables = self.sw_tables = self.ghg = None
        if options is not None and options.physics.radiation == C.RA_RRTMG:
            rad = options.rad
            self.lw_tables = _on_device(
                rrtmg_lw.get_lw_tables(rad.rrtmg_support_dir), dev,
                rrtmg_lw.device_tables)
            if not rad.use_simple_sw:
                self.sw_tables = _on_device(
                    rrtmg_sw.get_sw_tables(rad.rrtmg_support_dir), dev,
                    rrtmg_lw.device_tables)
            self.ghg = ghg_for_options(options)


# k-tables on a device: (id of the host tables, device) -> (host, device)
_DEVICE_TABLES = {}


def _on_device(tables, dev, upload):
    key = (id(tables), str(dev))
    if key not in _DEVICE_TABLES or _DEVICE_TABLES[key][0] is not tables:
        _DEVICE_TABLES[key] = (tables, upload(tables, dev))
    return _DEVICE_TABLES[key][1]


# the condensate the PBL mixes, in pbl_simple's argument order
HYDROMETEORS = ("cloud_water", "cloud_ice", "rain_mass", "snow_mass")


def radiation(s, g: Statics, doy, year_length, dt):
    """ra_simple (time_step.f90:488): theta, shortwave, longwave and cloud
    fraction. ``doy`` and ``year_length`` are 0-d float32 tensors."""
    s = dict(s)
    theta, sw, lw, cc = ra_simple.ra_simple(
        s["potential_temperature"], s["exner"], s["water_vapor"],
        s["cloud_water"], s["snow_mass"], s["rain_mass"], s["pressure"],
        g.lon, g.sin_lat, g.cos_lat, doy, year_length, dt)
    s["potential_temperature"] = theta
    s["shortwave"] = sw
    s["longwave"] = lw
    s["cloud_fraction"] = cc
    return s


def rrtmg_zenith(s, g: Statics, doy, year_length):
    """The solar geometry of an RRTMG substep: ``cosine_zenith_angle`` is
    the sine of the solar elevation (ra_driver.f90:298; a misnomer the
    JAX package keeps, the value the flux geometry wants)."""
    s = dict(s)
    elev, _ = ra_simple.solar_elevation(doy, year_length, g.lon, g.sin_lat,
                                        g.cos_lat)
    s["cosine_zenith_angle"] = torch.sin(elev)
    return s


def radiation_rrtmg(s, g: Statics, options, t, doy, year_length, dt, cdf,
                    stage=None):
    """One RRTMG call (ra_driver.f90:304-515; icar_tpu/core/step.py
    :281-347 ``do_radiation``): with ``icloud`` 3 the Thompson cloud
    fraction and subgrid condensate for this call only (the column maximum
    of the fraction stored), with 1 or 2 (and 0) a zero fraction; then the
    shortwave -- RRTMG's, with its direct/diffuse split where the state
    holds it, or under ``use_simple_sw`` ra_simple's without its
    longwave, on snow + ice + graupel -- and the longwave. ``t`` is the
    substep's time in the interval (its int32 seeds the McICA draws of
    ``cdf``); ``doy``, ``year_length`` and ``dt`` 0-d float32 tensors.
    Writes the stored heating tendencies and the radiation diagnostics;
    ``stage(name)`` brackets cloud_fraction, radiation_sw and
    radiation_lw."""
    stage = stage or (lambda name: contextlib.nullcontext())
    rad = options.rad
    if g.columns is not None:
        # a block of a sharded domain: each column's draws are the ones it
        # takes in the whole domain's call
        cdf = rrtmg_lw.BlockCdf(cdf, *g.columns)
    s = dict(s)
    zeros = torch.zeros_like(s["potential_temperature"])
    qc = s.get("cloud_water", zeros)
    qi = s.get("cloud_ice", zeros)
    qsn = s.get("snow_mass", zeros)
    t3d = s["temperature"]
    if rad.icloud == 3:
        with stage("cloud_fraction"):
            cldfra, qc, qi = cloud_fraction.cal_cldfra3(
                s["water_vapor"], qc, qi, qsn, g.dz, s["pressure"], t3d,
                s["land_mask"], g.dx / 1000.0)
            s["cloud_fraction"] = torch.amax(cldfra, dim=0)
    else:
        # icloud 1/2: the fraction stays 0, a quirk of the reference flow
        # (cldfra allocated, never filled; ra_driver.f90:237, :452-468)
        cldfra = zeros
    with stage("radiation_sw"):
        if rad.use_simple_sw:
            # simple SW only (F_runlw=.False.; ra_driver.f90:429), its qs
            # snow + ice + graupel (:434-436)
            _, sw, _, cc = ra_simple.ra_simple(
                s["potential_temperature"], s["exner"], s["water_vapor"],
                qc, qsn + qi + s.get("graupel_mass", zeros),
                s.get("rain_mass", zeros), s["pressure"], g.lon, g.sin_lat,
                g.cos_lat, doy, year_length, dt, runlw=False)
            s["shortwave"] = sw
            s["cloud_fraction"] = cc
            s["tend_th_swrad"] = zeros
        else:
            sw_tend, swdown, _, swcf, swdir = rrtmg_sw.rrtmg_sw_driver(
                g.sw_tables, cdf, t, s["pressure"], s["pressure_interface"],
                t3d, s["temperature_interface"], s["cosine_zenith_angle"],
                s["albedo"], s["water_vapor"], qc, qi, qsn, cldfra,
                s["re_cloud"], s["re_ice"], s["re_snow"], s["density"],
                g.dz, s["exner"], xland=s["land_mask"], ghg=g.ghg)
            s["tend_th_swrad"] = sw_tend
            s["shortwave"] = swdown
            s["shortwave_cloud_forcing"] = swcf
            if "shortwave_direct" in s:
                s["shortwave_direct"] = swdir
                s["shortwave_diffuse"] = swdown - swdir
    with stage("radiation_lw"):
        th_tend, glw, olr, lwcf = rrtmg_lw.rrtmg_lw_driver(
            g.lw_tables, cdf, t, s["pressure"], s["pressure_interface"],
            t3d, s["temperature_interface"], s["skin_temperature"],
            s["water_vapor"], qc, qi, qsn, cldfra, s["re_cloud"],
            s["re_ice"], s["re_snow"], s["density"], g.dz, s["emissivity"],
            s["exner"], xland=s["land_mask"], ghg=g.ghg)
        s["tend_th_lwrad"] = th_tend
        s["longwave"] = glw
        s["out_longwave_rad"] = olr
        s["longwave_cloud_forcing"] = lwcf
    return s


def radiative_heating(s, dt):
    """The stored RRTMG tendencies applied to theta, every substep
    (ra_driver.f90:516)."""
    s = dict(s)
    s["potential_temperature"] = s["potential_temperature"] + (
        s["tend_th_lwrad"] + s["tend_th_swrad"]) * dt
    return s


def surface_fluxes(s, g: Statics, options, lsm_dt, doy=None,
                   year_length=None, stage=None):
    """The surface stage (lsm, time_step.f90:491; icar_tpu/core/step.py
    :365-680): simple open-water fluxes on water cells (water=1, and
    water=3 where the state holds an sst), then the CLM lake on the lake
    cells (water=3), then Noah or Noah-MP on land cells over ``lsm_dt``
    (the time since the last call, a 0-d float32 tensor), then the 2 m
    diagnostics. With lsm=1 and radiation=1 the fluxes and radiation are
    the forcing's, left in place but on water and lake cells. Noah-MP
    takes the day of the year and the year's length (0-d float32 tensors)
    for its phenology and solar zenith; ``stage(name)`` brackets the
    lake's column ("lake"), Noah-MP's ("noahmp") and the glacier column's
    ("glacier")."""
    stage = stage or (lambda name: contextlib.nullcontext())
    phys = options.physics
    s = dict(s)
    u0, v0 = s["u_mass"][0], s["v_mass"][0]
    wind = torch.sqrt(u0 * u0 + v0 * v0)
    sh = s["sensible_heat"]
    lh = s["latent_heat"]
    z0 = s["roughness_z0"]
    tskin = s["skin_temperature"]
    t1 = s["temperature"][0]
    qv_surf = s["water_vapor"][0]
    if phys.watersurface in (C.WATER_SIMPLE, C.WATER_LAKE) and "sst" in s:
        # under water=3 the simple scheme still handles the ocean cells
        # (lsm_driver.f90:1063-1072); the lake overwrites its own below
        water = s["land_mask"] == 2.0        # kLC_WATER
        sh, lh, z0, tskin, qv_surf = surface.water_simple(
            s["sst"], s["surface_pressure"], wind, s["ustar"],
            s["water_vapor"][0], t1, g.z_atm, water, sh, lh, z0, tskin)
    if phys.watersurface == C.WATER_LAKE:
        with stage("lake"):
            s, sh, lh, tskin = _lake(s, g, options, lsm_dt, sh, lh, tskin)
    if phys.landsurface == C.LSM_NOAH:
        lnz = torch.log((g.z_atm + z0) / z0)
        base = (75 * C.KARMAN ** 2 * torch.sqrt((g.z_atm + z0) / z0)) \
            / (lnz * lnz)
        chs = surface.exchange_coefficient(wind, tskin, t1, g.z_atm,
                                           (C.KARMAN / lnz) ** 2, base)
        chs = chs * torch.clamp(wind, min=1.0)
        land = s["land_mask"] == 1.0
        precip_delta = torch.clamp(s["precipitation"] - s["rainbl"],
                                   min=0.0)
        p_i = s["pressure_interface"]
        nout = lsm_noah.noah_driver(
            g.noah_tables, g.dz[0], s["water_vapor"][0], p_i[0], p_i[1],
            t1, s["exner"][0], s["surface_pressure"], tskin, chs,
            s["longwave"], s["shortwave"], s["albedo"], s["emissivity"],
            precip_delta, lsm_dt, s["veg_type"].to(torch.int32),
            s["soil_type"].to(torch.int32), s["vegetation_fraction"],
            s["snow_albedo_max"], s["soil_deep_temperature"], land,
            s["canopy_water"], s["soil_temperature"],
            s["soil_water_content"], s["soil_liquid_water"], s["swe"],
            s["snow_height"], s["snow_cover"], s["snow_time"], z0)
        sh = torch.where(land, nout["hfx"], sh)
        lh = torch.where(land, nout["lh"], lh)
        z0 = torch.where(land, nout["roughness"], z0)
        tskin = torch.where(land, nout["skin_temperature"], tskin)
        qv_surf = torch.where(land, nout["qsfc"], qv_surf)
        for name, key in (
                ("canopy_water", "canopy_water"),
                ("soil_temperature", "soil_temperature"),
                ("soil_water_content", "soil_water_content"),
                ("soil_liquid_water", "soil_liquid_water"),
                ("snow_height", "snow_height"),
                ("snow_cover", "snow_cover"),
                ("albedo", "albedo"),
                ("emissivity", "emissivity"),
                ("snow_time", "snotime"),
                ("ground_heat_flux", "ground_heat_flux")):
            s[name] = nout[key]
        s["swe"] = torch.clamp(nout["swe"], max=options.lsm.max_swe)
        s["runoff_surface"] = s["runoff_surface"] + nout["runoff_surface"]
        s["runoff_subsurface"] = (s["runoff_subsurface"]
                                  + nout["runoff_subsurface"])
        # a copy: the microphysics adds to the accumulator in place
        s["rainbl"] = s["precipitation"].clone()
    if phys.landsurface == C.LSM_NOAHMP:
        with stage("noahmp"):
            s, sh, lh, tskin, z0, qv_surf, nstate, pnmp, cosz, \
                precip_delta = _noahmp(s, g, options, lsm_dt, doy,
                                       year_length, sh, lh, tskin, z0,
                                       qv_surf)
        with stage("glacier"):
            s, sh, lh, tskin = _glacier(s, g, options, lsm_dt, nstate, pnmp,
                                        cosz, precip_delta, sh, lh, tskin)
        # a copy: the microphysics adds to the accumulator in place
        s["rainbl"] = s["precipitation"].clone()
    lnz2 = torch.log((2.0 + z0) / z0)
    ex2 = (C.KARMAN / lnz2) ** 2 * wind
    t2, q2 = surface.surface_diagnostics(
        sh, lh * inv(C.LH_VAPORIZATION), tskin, qv_surf, ex2, ex2,
        s["surface_pressure"])
    s["sensible_heat"] = sh
    s["latent_heat"] = lh
    s["roughness_z0"] = z0
    s["skin_temperature"] = tskin
    if "temperature_2m" in s:
        s["temperature_2m"] = t2
        s["humidity_2m"] = q2
    return s


def _lake(s, g: Statics, options, lsm_dt, sh, lh, tskin):
    """The CLM lake on the whole grid, its results written back on the
    lake cells (lsm_driver.f90:1075-1140; icar_tpu/core/step.py:389-420):
    sensible and latent heat, skin temperature, ground heat flux, albedo
    and every lake field. Its precipitation is the accumulation since the
    last call, as Noah's (the JAX package's choice: the reference passes a
    stale value). Then ``rainbl`` follows the accumulator unless Noah runs
    after (ROADMAP section 3: Noah-MP then reads no precipitation).
    Returns the updated state and fluxes."""
    lakemask = s["lakemask"] > 0.5
    precip_delta = torch.clamp(
        (s["precipitation"] - s["rainbl"]).to(torch.float32), min=0.0)
    p_i = s["pressure_interface"]
    lout, lfields = water_lake.lake_driver(
        s, s["temperature"][0], p_i[0], p_i[1], g.dz[0],
        s["water_vapor"][0], s["u_mass"][0], s["v_mass"][0], s["longwave"],
        s["shortwave"], precip_delta, g.lat, lsm_dt)
    sh = torch.where(lakemask, lout["hfx"], sh)
    lh = torch.where(lakemask, lout["lh"], lh)
    tskin = torch.where(lakemask, lout["tsk"], tskin)
    s["ground_heat_flux"] = torch.where(lakemask, lout["grdflx"],
                                        s["ground_heat_flux"])
    s["albedo"] = torch.where(lakemask, lout["albedo"], s["albedo"])
    for k, v in lfields.items():
        m = lakemask[None] if v.dim() == 3 else lakemask
        s[k] = torch.where(m, v.to(s[k].dtype), s[k])
    if options.physics.landsurface != C.LSM_NOAH:
        # a copy: the microphysics adds to the accumulator in place
        s["rainbl"] = s["precipitation"].clone()
    return s, sh, lh, tskin


# state field -> Noah-MP state key, written back on land cells
# (icar_tpu/core/step.py:577-601)
NOAHMP_FIELDS = (
    ("snow_albedo_prev", "albold"), ("snow_water_eq_prev", "sneqvo"),
    ("soil_liquid_water", "sh2o"), ("soil_water_content", "smc"),
    ("canopy_temperature", "tah"), ("canopy_vapor_pressure", "eah"),
    ("canopy_fwet", "fwet"), ("canopy_water_liquid", "canliq"),
    ("canopy_water_ice", "canice"), ("veg_leaf_temperature", "tv"),
    ("ground_surf_temperature", "tg"), ("snow_layer_depth", "zsnso"),
    ("snow_height", "snowh"), ("snow_layer_ice", "snice"),
    ("snow_layer_liquid_water", "snliq"), ("water_table_depth", "zwt"),
    ("water_aquifer", "wa"), ("storage_gw", "wt"), ("lai", "lai"),
    ("sai", "sai"), ("coeff_momentum_drag", "cm"),
    ("coeff_heat_exchange", "ch"), ("snow_age_factor", "tauss"))
# ... and those the glacier column writes back on its cells (:640-651)
GLACIER_FIELDS = (
    ("snow_water_eq_prev", "sneqvo"), ("soil_liquid_water", "sh2o"),
    ("soil_water_content", "smc"), ("ground_surf_temperature", "tg"),
    ("snow_layer_depth", "zsnso"), ("snow_height", "snowh"),
    ("snow_layer_ice", "snice"), ("snow_layer_liquid_water", "snliq"),
    ("coeff_momentum_drag", "cm"), ("coeff_heat_exchange", "ch"),
    ("snow_age_factor", "tauss"))


def _write_back(s, new, mask, fields, options):
    """The columns' new state on ``mask``'s cells: the named fields, the
    snow and soil temperatures out of the stacked ``stc``, the layer count
    (float in the state) and the snow water clamped to ``max_swe``."""
    for name, key in fields:
        v = new[key]
        m = mask[None] if v.dim() == 3 else mask
        s[name] = torch.where(m, v, s[name])
    nsn = s["snow_temperature"].shape[0]
    s["snow_temperature"] = torch.where(mask[None], new["stc"][:nsn],
                                        s["snow_temperature"])
    s["soil_temperature"] = torch.where(mask[None], new["stc"][nsn:],
                                        s["soil_temperature"])
    s["snow_nlayers"] = torch.where(mask, new["isnow"].to(torch.float32),
                                    s["snow_nlayers"])
    s["swe"] = torch.where(mask, torch.clamp(new["sneqv"],
                                             max=options.lsm.max_swe),
                           s["swe"])


def _noahmp(s, g: Statics, options, lsm_dt, doy, year_length, sh, lh,
            tskin, z0, qv_surf):
    """Noah-MP on the land cells (lsm_driver.f90:1293-1517;
    icar_tpu/core/step.py:477-601): the per-cell parameters, cosz as the
    sine of the solar elevation (lsm_driver.f90:1336-1338), the column
    state with the snow temperatures over the soil's, then the fluxes and
    the state written back on land. Returns the updated state and fluxes,
    and the column state, parameters, cosz and precipitation the glacier
    column takes."""
    veg_t = s["veg_type"].to(torch.int32)
    soil_t = s["soil_type"].to(torch.int32)
    pnmp = resolve_params(g.mp_tables, g.noah_tables, veg_t, soil_t)
    elev, _ = ra_simple.solar_elevation(doy, year_length, g.lon, g.sin_lat,
                                        g.cos_lat)
    cosz = torch.sin(elev)
    land = s["land_mask"] == 1.0
    precip_delta = torch.clamp(s["precipitation"] - s["rainbl"], min=0.0)
    nstate = dict(
        albold=s["snow_albedo_prev"], sneqvo=s["snow_water_eq_prev"],
        stc=torch.cat([s["snow_temperature"], s["soil_temperature"]], 0),
        sh2o=s["soil_liquid_water"], smc=s["soil_water_content"],
        tah=s["canopy_temperature"], eah=s["canopy_vapor_pressure"],
        fwet=s["canopy_fwet"], canliq=s["canopy_water_liquid"],
        canice=s["canopy_water_ice"], tv=s["veg_leaf_temperature"],
        tg=s["ground_surf_temperature"], qsfc=s["water_vapor"][0],
        isnow=s["snow_nlayers"].to(torch.int32),
        zsnso=s["snow_layer_depth"], snowh=s["snow_height"],
        sneqv=s["swe"], snice=s["snow_layer_ice"],
        snliq=s["snow_layer_liquid_water"], zwt=s["water_table_depth"],
        wa=s["water_aquifer"], wt=s["storage_gw"], lai=s["lai"],
        sai=s["sai"], cm=s["coeff_momentum_drag"],
        ch=s["coeff_heat_exchange"], tauss=s["snow_age_factor"])
    p_i = s["pressure_interface"]
    nout, nnew = noahmp.noahmp_driver(
        pnmp, g.lat, year_length, doy, cosz, lsm_dt,
        s["vegetation_fraction"], veg_t, s["temperature"][0], p_i[1],
        p_i[0], s["u_mass"][0], s["v_mass"][0], s["water_vapor"][0],
        s["shortwave"], s["longwave"], precip_delta,
        s["soil_deep_temperature"], g.z_atm, nstate)
    sh = torch.where(land, nout["hfx"], sh)
    lh = torch.where(land, nout["lh"], lh)
    tskin = torch.where(land, nout["tsk"], tskin)
    z0 = torch.where(land, nout["z0wrf"], z0)
    qv_surf = torch.where(land, nout["q1"], qv_surf)
    s["ground_heat_flux"] = torch.where(land, nout["grdflx"],
                                        s["ground_heat_flux"])
    s["albedo"] = torch.where(land & (nout["albedo"] > 0.0), nout["albedo"],
                              s["albedo"])
    s["emissivity"] = torch.where(land, nout["emissi"], s["emissivity"])
    s["runoff_surface"] = s["runoff_surface"] + torch.where(
        land, nout["runsrf"] * lsm_dt, 0.0)
    s["runoff_subsurface"] = s["runoff_subsurface"] + torch.where(
        land, nout["runsub"] * lsm_dt, 0.0)
    _write_back(s, nnew, land, NOAHMP_FIELDS, options)
    s["canopy_water"] = torch.where(land, nnew["canliq"] + nnew["canice"],
                                    s["canopy_water"])
    return s, sh, lh, tskin, z0, qv_surf, nstate, pnmp, cosz, precip_delta


def _glacier(s, g: Statics, options, lsm_dt, nstate, pnmp, cosz,
             precip_delta, sh, lh, tskin):
    """The glacier column on land cells of the ice category (noahmplsm,
    lsm_noahmpdrv.f90:876; icar_tpu/core/step.py:604-662), from the column
    state Noah-MP started from, overriding Noah-MP's result there."""
    land = s["land_mask"] == 1.0
    gmask = land & (s["veg_type"].to(torch.int32) == g.mp_tables.isice)
    tot = nstate["snice"] + nstate["snliq"]
    ficeold = torch.where(tot > 0.0, nstate["snice"]
                          / torch.clamp(tot, min=1e-6), 0.0)
    qv0 = s["water_vapor"][0]
    gout, gnew = noahmp_glacier.glacier_sflx(
        pnmp, cosz, lsm_dt, g.zsoil, s["temperature"][0],
        s["pressure_interface"][1], s["u_mass"][0], s["v_mass"][0],
        qv0 / (1.0 + qv0), s["shortwave"], s["longwave"],
        precip_delta / lsm_dt, s["soil_deep_temperature"], ficeold,
        g.z_atm, dict(nstate))
    sh = torch.where(gmask, gout["fsh"], sh)
    lh = torch.where(gmask, gout["fgev"], lh)
    tskin = torch.where(gmask, gout["trad"], tskin)
    s["ground_heat_flux"] = torch.where(gmask, gout["ssoil"],
                                        s["ground_heat_flux"])
    s["albedo"] = torch.where(gmask & (gout["albedo"] > 0.0),
                              gout["albedo"], s["albedo"])
    s["runoff_surface"] = s["runoff_surface"] + torch.where(
        gmask, gout["runsrf"] * lsm_dt, 0.0)
    s["runoff_subsurface"] = s["runoff_subsurface"] + torch.where(
        gmask, gout["runsub"] * lsm_dt, 0.0)
    _write_back(s, gnew, gmask, GLACIER_FIELDS, options)
    return s, sh, lh, tskin


def apply_fluxes(s, g: Statics, options, dt):
    """The surface fluxes into the lowest layers, every substep
    (apply_fluxes, lsm_driver.f90:1549-1552)."""
    s = dict(s)
    s["potential_temperature"], s["water_vapor"] = surface.apply_fluxes(
        s["potential_temperature"], s["water_vapor"], s["density"], g.dz,
        s["exner"], s["sensible_heat"], s["latent_heat"], dt,
        sh_feedback_fraction=options.lsm.sh_feedback_fraction,
        lh_feedback_fraction=options.lsm.lh_feedback_fraction)
    return s


def boundary_layer_diffusivity(s, g: Statics, dt):
    """pbl_simple's eddy diffusivity Kq*dt/dz of the state ``s``, from
    which the domain's diffusion substep count is formed
    (``pbl_simple.substep_bound``) before ``boundary_layer`` runs."""
    water = (s["land_mask"] == 2.0) if "land_mask" in s else None
    zeros = torch.zeros_like(s["potential_temperature"])
    return pbl_simple.eddy_diffusivity(
        s["potential_temperature"], s["water_vapor"],
        *(s.get(k, zeros) for k in HYDROMETEORS), s["u_mass"], s["v_mass"],
        s["exner"], g.z, g.terrain, g.dz, dt, water)


def boundary_layer(s, g: Statics, dt, Kq=None, nsub=None):
    """pbl_simple (pbl, time_step.f90:494), less mixing over open water.
    A species the state does not hold (SB04's has no cloud ice) mixes as
    zeros and is not written, as in the JAX loop. ``Kq``
    (``boundary_layer_diffusivity`` of ``s``) and ``nsub``, the domain's
    diffusion substep count, where the caller formed them: the blocks of a
    sharded domain take the largest of their ``pbl_simple.substep_bound``;
    by default ``s``'s own."""
    s = dict(s)
    water = (s["land_mask"] == 2.0) if "land_mask" in s else None
    zeros = torch.zeros_like(s["potential_temperature"])
    th, qv, qc, qi, qr, qs = pbl_simple.pbl_simple(
        s["potential_temperature"], s["water_vapor"],
        *(s.get(k, zeros) for k in HYDROMETEORS), s["u_mass"], s["v_mass"],
        s["exner"], s["density"], g.z, g.dz, g.terrain, dt, water, Kq,
        nsub)
    s["potential_temperature"] = th
    s["water_vapor"] = qv
    for name, val in zip(HYDROMETEORS, (qc, qi, qr, qs)):
        if name in s:
            s[name] = val
    return s


def boundary_layer_ysu(s, g: Statics, dt):
    """YSU (pbl, time_step.f90:494; icar_tpu/core/step.py:703-744): the
    bulk Richardson number (calc_Richardson_nr, atm_utilities.f90:1131),
    the surface layer -- NOTE reference quirk preserved: it is given the
    lowest level's cloud water as its moisture (pbl_driver.f90:239) --,
    then the scheme; theta, water vapour and the cloud water and ice the
    state holds are written, and hpbl and exch_h where it holds them."""
    s = dict(s)
    zeros = torch.zeros_like(s["potential_temperature"])
    u10, v10 = s["u_10m"], s["v_10m"]
    wspd10 = torch.sqrt(u10 * u10 + v10 * v10)
    wspd10 = torch.where(wspd10 == 0, torch.full_like(wspd10, 1e-5), wspd10)
    tskin = s["skin_temperature"]
    t1 = s["temperature"][0]
    ri = ysu._rdiv(C.GRAVITY, t1) * (t1 - tskin) * g.z_atm \
        / (wspd10 * wspd10)
    qfx = s["latent_heat"] * inv(C.LH_VAPORIZATION)
    qc = s.get("cloud_water", zeros)
    qi = s.get("cloud_ice", zeros)
    sfc = ysu.surface_layer(
        s["surface_pressure"], tskin, s["pressure"][0], t1, qc[0],
        s["u_mass"][0], s["v_mass"][0], g.z_atm, s["roughness_z0"],
        s["land_mask"], g.dx, s["ustar"], s["sensible_heat"], qfx)
    th, qv, qc, qi, hpbl, _, exch_h = ysu.ysu(
        s["u_mass"], s["v_mass"], s["potential_temperature"],
        s["temperature"], s["water_vapor"], qc, qi, s["pressure"],
        s["pressure_interface"], s["exner"], g.dz, g.z, g.terrain,
        s["surface_pressure"], tskin, s["roughness_z0"], s["land_mask"],
        s["sensible_heat"], qfx, s["ustar"], u10, v10, sfc.psim, sfc.psih,
        ri, dt)
    s["potential_temperature"] = th
    s["water_vapor"] = qv
    for name, val in (("cloud_water", qc), ("cloud_ice", qi),
                      ("hpbl", hpbl), ("exch_h", exch_h)):
        if name in s:
            s[name] = val
    return s


def _interface_w_p(s):
    """The interface w with a zero bottom and the interface pressures with
    the model top reflected (pressure_interface holds the interface below
    each layer), as Tiedtke and NSAS take them."""
    w_if = torch.cat([torch.zeros_like(s["w_real"][:1]), s["w_real"]], 0)
    p_if = torch.cat([s["pressure_interface"],
                      2.0 * s["pressure"][-1:]
                      - s["pressure_interface"][-1:]], 0)
    return w_if, p_if


def _blend(s, options, th_c, qv_c, qc_c=None, qi_c=None):
    """The scheme's new theta, vapour and (where given and held) cloud
    water and ice blended in by the tendency fractions."""
    cu = options.cu
    th0, qv0 = s["potential_temperature"], s["water_vapor"]
    if cu.tend_th_fraction > 0:
        s["potential_temperature"] = th0 + (th_c - th0) \
            * cu.tend_th_fraction
    if cu.tend_qv_fraction > 0:
        s["water_vapor"] = qv0 + (qv_c - qv0) * cu.tend_qv_fraction
    if qc_c is not None and cu.tend_qc_fraction > 0 and "cloud_water" in s:
        s["cloud_water"] = s["cloud_water"] \
            + (qc_c - s["cloud_water"]) * cu.tend_qc_fraction
    if qi_c is not None and cu.tend_qi_fraction > 0 and "cloud_ice" in s:
        s["cloud_ice"] = s["cloud_ice"] \
            + (qi_c - s["cloud_ice"]) * cu.tend_qi_fraction


def _convective_rain(s, rain):
    """The convective rain added to both accumulators (before the
    microphysics adds its own)."""
    s["precipitation"] = s["precipitation"] + rain
    s["convective_precipitation"] = s["convective_precipitation"] + rain


def convection(s, g: Statics, options, dt):
    """The convection scheme of ``options`` (convect, time_step.f90:497;
    cu_driver.f90; icar_tpu/core/step.py:763-904): Tiedtke, Kain-Fritsch,
    NSAS or BMJ, each adding its convective rain to both accumulators."""
    conv = options.physics.convection
    if conv == C.CU_KF:
        return convection_kf(s, g, options, dt)
    if conv == C.CU_NSAS:
        return convection_nsas(s, g, options, dt)
    if conv == C.CU_BMJ:
        return convection_bmj(s, g, options, dt)
    return convection_tiedtke(s, g, options, dt)


def convection_tiedtke(s, g: Statics, options, dt):
    """Tiedtke (cu_tiedtke): the interface w and pressures
    (``_interface_w_p``), the tendency fractions' blend when
    ``tendency_fraction`` is on, and the convective rain."""
    s = dict(s)
    w_if, p_if = _interface_w_p(s)
    th_c, qv_c, qc_c, qi_c, rain_c = cu_tiedtke.tiedtke(
        s["u_mass"], s["v_mass"], w_if, s["temperature"], s["water_vapor"],
        s["cloud_water"], s["cloud_ice"], s["exner"], s["density"],
        s["tend_qv_adv"], s["tend_qv_pbl"], s["pressure"], p_if, g.dz,
        s["latent_heat"] * inv(C.LH_VAPORIZATION), s["sensible_heat"],
        s["land_mask"], dt)
    if options.cu.tendency_fraction > 0:
        _blend(s, options, th_c, qv_c, qc_c, qi_c)
    _convective_rain(s, rain_c)
    return s


def convection_kf(s, g: Statics, options, dt):
    """Kain-Fritsch (icar_tpu/core/step.py:805-845): its tendencies
    persist in the state while the NCA countdown runs (``cu_kf.kfcps``);
    with ``tendency_fraction`` on they are applied as t * dt * fraction,
    and the rain and snow tendencies feed the grid-scale rain and snow in
    full (the commented ICAR feedback, cu_driver.f90:494-498)."""
    s = dict(s)
    (t_th, t_qv, t_qc, t_qr, t_qi, t_qs, raincv, w0avg, nca,
     prate) = cu_kf.kfcps(
        s["u_mass"], s["v_mass"], s["potential_temperature"],
        s["water_vapor"], s["pressure"], s["density"], g.dz_mass,
        s["w_real"], s["exner"], dt, g.dx, s["kf_w0avg"], s["kf_nca"],
        s["kf_prate"], s["tend_th_cu"], s["tend_qv_cu"], s["tend_qc_cu"],
        s["tend_qr_cu"], s["tend_qi_cu"], s["tend_qs_cu"])
    s["kf_w0avg"], s["kf_nca"], s["kf_prate"] = w0avg, nca, prate
    s["tend_th_cu"], s["tend_qv_cu"] = t_th, t_qv
    s["tend_qc_cu"], s["tend_qr_cu"] = t_qc, t_qr
    s["tend_qi_cu"], s["tend_qs_cu"] = t_qi, t_qs
    cu = options.cu
    if cu.tendency_fraction > 0:
        for name, tend, frac in (
                ("potential_temperature", t_th, cu.tend_th_fraction),
                ("water_vapor", t_qv, cu.tend_qv_fraction),
                ("cloud_water", t_qc, cu.tend_qc_fraction),
                ("cloud_ice", t_qi, cu.tend_qi_fraction)):
            if frac > 0 and name in s:
                s[name] = s[name] + tend * dt * frac
        for name, tend in (("rain_mass", t_qr), ("snow_mass", t_qs)):
            if name in s:
                s[name] = s[name] + tend * dt
    _convective_rain(s, raincv)
    return s


def convection_nsas(s, g: Statics, options, dt):
    """NSAS (icar_tpu/core/step.py:847-881): the interface w and pressures
    (``_interface_w_p``), the PBL height (0 without one that forms it),
    the tendency fractions' blend and the convective rain. NOTE reference
    quirk preserved: the JAX step calls ``nsas`` without the microphysics
    option, so its detrainment splits cloud water and ice (ncloud 2)
    whatever the microphysics (ROADMAP section 3)."""
    s = dict(s)
    w_if, p_if = _interface_w_p(s)
    zeros = torch.zeros_like(s["potential_temperature"])
    th_c, qv_c, qc_c, qi_c, rain_c = cu_nsas.nsas(
        s["u_mass"], s["v_mass"], w_if, s["temperature"], s["water_vapor"],
        s.get("cloud_water", zeros), s.get("cloud_ice", zeros),
        s["density"], s["pressure"], p_if, g.dz, s["exner"],
        s.get("hpbl", torch.zeros_like(s["sensible_heat"])),
        s["sensible_heat"], s["latent_heat"] * inv(C.LH_VAPORIZATION),
        s["land_mask"], g.dx, dt)
    _blend(s, options, th_c, qv_c, qc_c, qi_c)
    _convective_rain(s, rain_c)
    return s


def convection_bmj(s, g: Statics, options, dt):
    """BMJ (icar_tpu/core/step.py:883-904): the surface pressure from the
    lowest interface, the theta and vapour fractions' blend, the cloud
    efficiency kept in the state and the convective rain."""
    s = dict(s)
    th_c, qv_c, rain_c, cldefi = cu_bmj.bmj(
        s["temperature"], s["potential_temperature"], s["water_vapor"],
        s["pressure"], s["exner"], s["density"], g.dz, s["land_mask"],
        s["cldefi"], dt, psfc=s["pressure_interface"][0])
    _blend(s, options, th_c, qv_c)
    s["cldefi"] = cldefi
    _convective_rain(s, rain_c)
    return s

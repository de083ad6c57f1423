"""Boundary forcing ingest: file cursor, variable reads, derived fields,
and regridding to the model grid (icar_tpu/forcing/boundary.py).

The file reads and the look-up tables run on the host (``ForcingData`` and
the humidity conversions are copies of the JAX package's, held to them by
tests/test_torch_setup.py); a ``Regridder`` moves its tables to the
model's device once, and each forcing step is regridded there with
gathers (``interpolation.geo_interp``, ``vinterp``). The JAX driver runs
this eagerly, op by op, so the port divides where it divides
(``ops/pointwise.div``, one IEEE division on both devices) and keeps its
order of operations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants as C
from ..config import Options
from ..io.netcdf import NCFile
from ..ops import pointwise as pw
from .interpolation import (GeoLUT, VertLUT, build_geo_lut, build_vlut,
                            geo_interp, smooth_horizontal, to_device,
                            vinterp)


def compute_mixing_ratio_from_rh(rh, t, p):
    """Copy of icar_tpu/forcing/boundary.py.
    qv from relative humidity (compute_mixing_ratio,
    boundary_obj.f90:557-596)."""
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    e = rh * es
    return 0.62197 * e / (p - e)


def compute_mixing_ratio_from_sh(sh):
    """Copy of icar_tpu/forcing/boundary.py.
    qv from specific humidity."""
    return sh / (1 - sh)


def update_pressure(p, z_in, z_out, t, qv):
    """Hydrostatically shift pressure from z_in to z_out using virtual
    temperature (update_pressure, atm_utilities.f90:595-620):
        p_out = p * exp(-dz / (Rd/g * Tv))."""
    tv = t * (1 + 0.608 * qv)
    return p * pw.exp(-(z_out - z_in) / (C.ROVG * tv))


class ForcingData:
    """Copy of icar_tpu/forcing/boundary.py.
    File list + time cursor + raw variable reads (boundary_t)."""

    def __init__(self, options: Options):
        self.options = options
        fo = options.forcing
        self.files: List[str] = list(fo.boundary_files)
        if fo.forcing_file_list:
            with open(fo.forcing_file_list) as f:
                self.files = [ln.strip().strip('"') for ln in f
                              if ln.strip()]
        if not self.files:
            raise ValueError("no forcing files specified")
        self.var_names = fo.var_names
        self.input_interval = fo.input_interval
        # steps per file, so read_step() can address a global step index
        # across the whole file list (curfile/curstep cursor,
        # boundary_obj.f90:371-430)
        name = self.var_names["p"]
        self._steps_in_file: List[int] = []
        for path in self.files:
            with NCFile(path) as f:
                self._steps_in_file.append(max(1, f.n_times(name)))
        self._cum_steps = np.cumsum([0] + self._steps_in_file)
        with NCFile(self.files[0]) as f:
            self._first_shape = f.var_shape(name)
        # skip forcing steps before the model start
        # (find_timestep_in_file, time_io.f90)
        self.first_step = 0
        if options.run.forcing_start_date:
            from ..utils.calendar import Time
            ahead = (options.start_time()
                     - Time.from_string(options.run.forcing_start_date,
                                        options.run.calendar)).seconds()
            self.first_step = max(0, int(round(ahead / self.input_interval)))
            if self.first_step >= self._cum_steps[-1]:
                raise ValueError(
                    f"model start is {ahead:.0f}s after forcing_start_date "
                    f"but the forcing files hold only "
                    f"{int(self._cum_steps[-1])} step(s)")
        # forcing grid coordinates
        self.lat = self._read0("lat")
        self.lon = self._read0("lon")
        if self.lat.ndim == 1:
            self.lon, self.lat = np.meshgrid(self.lon, self.lat)
        self.hgt = self._read0("hgt") if self.var_names.get("hgt") else None
        # optional staggered wind-grid coordinates (ulat/ulon/vlat/vlon in
        # &var_list): winds are then interpolated from their native
        # staggered grids instead of assuming mass-grid winds
        self.stagger_coords = {}
        for k in ("ulat", "ulon", "vlat", "vlon"):
            a = self._read0(k)
            if a is not None:
                if a.ndim == 3:
                    a = a[0]
                self.stagger_coords[k] = a

    def _read0(self, slot: str, step: Optional[int] = None):
        name = self.var_names.get(slot)
        if not name:
            return None
        with NCFile(self.files[0]) as f:
            if not f.has_var(name):
                return None
            data = f.read(name)
        if step is not None and data.ndim >= 3:
            data = data[step]
        return np.asarray(data, np.float32)

    def n_steps(self) -> int:
        """Total steps across the whole file list (after first_step)."""
        return int(self._cum_steps[-1]) - self.first_step

    def _locate(self, step: int):
        """Global step index -> (file path, step within that file)."""
        step = min(step + self.first_step, int(self._cum_steps[-1]) - 1)
        fi = int(np.searchsorted(self._cum_steps, step, side="right")) - 1
        return self.files[fi], step - int(self._cum_steps[fi])

    def read_step(self, step: int) -> Dict[str, np.ndarray]:
        """Read all forcing variables at one (global) time step and compute
        derived fields (update_forcing + update_computed_vars,
        boundary_obj.f90:371-681). Returns (z, y, x) arrays."""
        fo = self.options.forcing
        path, step = self._locate(step)
        out: Dict[str, np.ndarray] = {}
        for slot in ("u", "v", "p", "pb", "t", "theta", "qv", "qc", "qi",
                     "qr", "qs", "qg", "z", "zb", "sst", "swdown",
                     "lwdown", "sh", "lh", "pblh"):
            name = self.var_names.get(slot)
            if not name:
                continue
            with NCFile(path) as f:
                if not f.has_var(name):
                    continue
                data = f.read(name)
            a = np.asarray(data, np.float32)
            if a.ndim == 4:          # (time, z, y, x)
                a = a[step]
            elif a.ndim == 3 and slot in ("sst", "swdown", "lwdown",
                                          "sh", "lh", "pblh"):
                a = a[step]
            out[slot] = a

        # derived quantities
        # WRF-style perturbation + base-state splitting (pbvar/zbvar):
        # full field = perturbation + base (options_obj.f90:744-755)
        if "pb" in out:
            out["p"] = out["p"] + out.pop("pb")
        if "zb" in out and "z" in out:
            out["z"] = out["z"] + out.pop("zb")
        if "z" in out and fo.z_is_geopotential:
            out["z"] = out["z"] / C.GRAVITY
        if "qv" in out:
            if fo.qv_is_relative_humidity:
                t = out.get("t")
                out["qv"] = compute_mixing_ratio_from_rh(
                    out["qv"], t, out["p"]).astype(np.float32)
            elif fo.qv_is_spec_humidity:
                out["qv"] = compute_mixing_ratio_from_sh(out["qv"])
        if "theta" not in out and "t" in out:
            t = out["t"] + fo.t_offset
            if fo.t_is_potential:
                out["theta"] = t
            else:
                exner = (out["p"] / C.P0) ** C.ROVCP
                out["theta"] = t / exner
        return out


@dataclass
class Regridder:
    """Forcing-grid -> model-grid interpolation pipeline (geo LUTs for the
    mass/u/v grids + per-variable vertical LUTs; setup_geo_interpolation +
    interpolate_variable, domain_obj.f90:2250, 2709), its tables on the
    model's device."""
    geo: GeoLUT
    geo_u: GeoLUT
    geo_v: GeoLUT
    geo_u_mass: Optional[GeoLUT] = None   # mass-source LUTs to the wind
    geo_v_mass: Optional[GeoLUT] = None   # grids (for z placement)
    vlut: Optional[VertLUT] = None
    vlut_u: Optional[VertLUT] = None
    vlut_v: Optional[VertLUT] = None
    nsmooth: int = 0
    time_varying_z: bool = False
    device: torch.device = torch.device("cpu")

    @classmethod
    def build(cls, geom, f_lat, f_lon, f_z, options: Options,
              f_stag: Optional[Dict[str, np.ndarray]] = None,
              device="cuda"):
        """The tables from the forcing grid (``f_lat``, ``f_lon``, the
        first step's heights ``f_z``) to the model grid ``geom`` (the
        numpy ``grid.Geometry``), built on the host and moved to
        ``device``."""
        from ..grid import offset_x, offset_y
        from .interpolation import standardize_longitudes

        device = torch.device(device)
        # bring forcing and model longitudes into one coordinate system
        # (standardize_coordinates, geo_reader.f90:1205-1267)
        lsys = options.forcing.longitude_system
        f_lon = standardize_longitudes(f_lon, lsys)
        m_lon = standardize_longitudes(np.asarray(geom.lon, np.float64),
                                       lsys)
        lat_u = offset_x(np.asarray(geom.lat, np.float64))
        lon_u = offset_x(m_lon)
        lat_v = offset_y(np.asarray(geom.lat, np.float64))
        lon_v = offset_y(m_lon)
        geo = build_geo_lut(f_lat, f_lon, np.asarray(geom.lat), m_lon)
        geo_u = build_geo_lut(f_lat, f_lon, lat_u, lon_u)
        geo_v = build_geo_lut(f_lat, f_lon, lat_v, lon_v)
        # mass-grid-source LUTs to the model u/v grids, used below to place
        # forcing z on the wind grids even when the winds themselves come
        # from their own staggered grids
        geo_u_mass, geo_v_mass = geo_u, geo_v
        if f_stag and all(k in f_stag for k in ("ulat", "ulon")):
            geo_u = build_geo_lut(
                f_stag["ulat"], standardize_longitudes(f_stag["ulon"], lsys),
                lat_u, lon_u)
        if f_stag and all(k in f_stag for k in ("vlat", "vlon")):
            geo_v = build_geo_lut(
                f_stag["vlat"], standardize_longitudes(f_stag["vlon"], lsys),
                lat_v, lon_v)

        self = cls(geo=to_device(geo, device), geo_u=to_device(geo_u, device),
                   geo_v=to_device(geo_v, device),
                   geo_u_mass=to_device(geo_u_mass, device),
                   geo_v_mass=to_device(geo_v_mass, device), device=device)
        if f_z is not None:
            self._build_vluts(f_z, (geom.z, geom.z_u, geom.z_v))
        smooth_dist = options.forcing.smooth_wind_distance
        if smooth_dist < 0:
            smooth_dist = options.domain.dx * 2
        self.nsmooth = max(1, int(round(smooth_dist / options.domain.dx)))
        self.time_varying_z = bool(options.forcing.time_varying_z)
        return self

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _build_vluts(self, f_z, model_z):
        """The vertical LUTs from the forcing heights ``f_z`` (placed on
        the mass, u and v grids on the device, read back) to the model
        heights ``model_z`` (mass, u, v; numpy), moved to the device."""
        fz = self._tensor(f_z)
        for attr, lut, z in (("vlut", self.geo, model_z[0]),
                             ("vlut_u", self.geo_u_mass, model_z[1]),
                             ("vlut_v", self.geo_v_mass, model_z[2])):
            placed = geo_interp(fz, lut).cpu().numpy()
            setattr(self, attr, to_device(build_vlut(np.asarray(z), placed),
                                          self.device))

    def update_vluts(self, f_z, geom):
        """Rebuild the vertical LUTs from this step's forcing z (``geom``:
        the model geometry, numpy or tensors). The reference instead
        re-interpolates each variable back onto the initial forcing levels
        when z varies in time (boundary_obj.f90:432-478); rebuilding the
        model-grid LUTs from the current levels is the equivalent (and
        direct) transform."""
        self._build_vluts(f_z, tuple(
            z.cpu().numpy() if torch.is_tensor(z) else z
            for z in (geom.z, geom.z_u, geom.z_v)))

    def to_model_grid(self, raw: Dict[str, np.ndarray], geom
                      ) -> Dict[str, torch.Tensor]:
        """Interpolate one forcing step to the model grid. Returns target
        fields keyed by state names, on the device (interpolate_forcing,
        domain_obj.f90:2559-2719). ``geom``: the model geometry as tensors
        on the device (``convert.geometry_to_torch``)."""
        out: Dict[str, torch.Tensor] = {}
        if self.time_varying_z and "z" in raw and self.vlut is not None:
            self.update_vluts(raw["z"], geom)
        on_device: Dict[str, torch.Tensor] = {}

        def horiz(slot, lut):
            if slot not in on_device:
                on_device[slot] = self._tensor(raw[slot])
            return geo_interp(on_device[slot], lut)

        def vert(a, lut):
            return vinterp(a, lut) if lut is not None else a

        # winds: geo-interp, horizontal smoothing, vertical interp
        if "u" in raw:
            u = smooth_horizontal(horiz("u", self.geo_u), self.nsmooth)
            out["u"] = vert(u, self.vlut_u)
        if "v" in raw:
            v = smooth_horizontal(horiz("v", self.geo_v), self.nsmooth)
            out["v"] = vert(v, self.vlut_v)

        # scalars on the mass grid
        th = horiz("theta", self.geo) if "theta" in raw else None
        if th is not None:
            out["potential_temperature"] = vert(th, self.vlut)
        if "qv" in raw:
            out["water_vapor"] = vert(horiz("qv", self.geo), self.vlut)
        # forcing cloud species (qcvar/qivar in &var_list; read as qc/qi in
        # boundary_obj.f90 and forced on the lateral boundaries like any
        # other advected scalar)
        for slot, name in (("qc", "cloud_water"), ("qi", "cloud_ice"),
                           ("qr", "rain_mass"), ("qs", "snow_mass"),
                           ("qg", "graupel_mass")):
            if slot in raw:
                out[name] = vert(horiz(slot, self.geo), self.vlut)

        # pressure: the forcing level matched through the vertical LUT,
        # then a hydrostatic shift to the model height (never a plain
        # vertical interpolation of p; adjust_pressure,
        # domain_obj.f90:2604-2656)
        if "p" in raw:
            p = horiz("p", self.geo)
            if "z" in raw and th is not None:
                fz = horiz("z", self.geo)
                p_on_model = vert(p, self.vlut)
                z_on_model = vert(fz, self.vlut)
                th_on_model = vert(th, self.vlut)
                qv_on_model = out.get("water_vapor",
                                      torch.zeros_like(p_on_model))
                exner = pw.pow(pw.div(p_on_model, C.P0), C.ROVCP)
                t_real = th_on_model * exner
                out["pressure"] = update_pressure(
                    p_on_model, z_on_model, geom.z, t_real, qv_on_model)
            else:
                out["pressure"] = p

        # 2D fields (sh/lh feed the prescribed-fluxes land surface, lsm=1)
        for slot, name in (("sst", "sst"), ("swdown", "shortwave"),
                           ("lwdown", "longwave"),
                           ("sh", "sensible_heat"), ("lh", "latent_heat"),
                           ("pblh", "hpbl")):
            if slot in raw:
                out[name] = horiz(slot, self.geo)
        return out


# model-state name <- common external-file variable names
EXTERNAL_VAR_ALIASES = {
    "swe": ("swe", "SNOW", "swe_ext"),
    "snow_height": ("snow_height", "SNOWH", "hsnow"),
    "skin_temperature": ("skin_temperature", "TSK", "tskin"),
    "soil_temperature": ("soil_temperature", "TSLB", "soil_t"),
}


def load_external_conditions(options: Options, geom, device="cuda"
                             ) -> Dict[str, torch.Tensor]:
    """Read externally-supplied initial surface/snow/soil state (SWE, snow
    height, skin/soil temperature) and geo-interpolate it onto the model
    grid (init_external, external_bnd.f90:70-160; the reference hard-codes
    'swe' -- here any alias in EXTERNAL_VAR_ALIASES is picked up).
    ``geom``: the numpy model geometry.

    Returns {state_name: (ny, nx) tensor on ``device``}; empty if no
    external file set."""
    path = options.forcing.external_files
    if not path:
        return {}
    out: Dict[str, torch.Tensor] = {}
    with NCFile(path) as f:
        lat = lon = None
        for cand in ("lat", "XLAT", "lat_ext"):
            if f.has_var(cand):
                lat = f.read(cand)
                break
        for cand in ("lon", "XLONG", "lon_ext"):
            if f.has_var(cand):
                lon = f.read(cand)
                break
        if lat is None or lon is None:
            raise ValueError(f"external file {path} lacks lat/lon coordinates")
        if lat.ndim == 1:
            lon, lat = np.meshgrid(lon, lat)
        lut = to_device(build_geo_lut(np.asarray(lat), np.asarray(lon),
                                      np.asarray(geom.lat),
                                      np.asarray(geom.lon)), device)
        for state_name, aliases in EXTERNAL_VAR_ALIASES.items():
            for cand in aliases:
                if f.has_var(cand):
                    raw = np.asarray(f.read(cand), np.float32)
                    if raw.ndim == 3:
                        raw = raw[0]
                    out[state_name] = geo_interp(
                        torch.as_tensor(raw, device=device), lut)
                    break
    return out


def compute_tendencies(current: Dict[str, torch.Tensor],
                       target: Dict[str, torch.Tensor],
                       interval_seconds: float) -> Dict[str, torch.Tensor]:
    """dqdt = (target - current) / dt for every forced field
    (update_delta_fields, domain_obj.f90:2339-2372), one IEEE division by
    the interval as the eager JAX driver divides."""
    out = {}
    for name, tgt in target.items():
        if name in current:
            out[name] = pw.div(tgt - current[name], interval_seconds)
    return out

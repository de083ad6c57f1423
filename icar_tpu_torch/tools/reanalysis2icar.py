"""Convert reanalysis / GCM NetCDF (ERA5-style pressure levels, or hybrid
sigma levels) into model forcing files.

The port's counterpart of tools/reanalysis2icar.py (the reference's
per-dataset converters, helpers/erai/*.py, ccsm/ cesm/ cmip/, and
helpers/gen_bc.py), with its arguments, presets and outputs:

  * pressure-level files: a 1D ``level`` coordinate [hPa or Pa] broadcast
    to the 3D pressure field
  * hybrid-sigma files: ``p = a*p0 + b*ps`` from the hyam/hybm (or a/b)
    coefficients and surface pressure (erai/convert.py:20-25)
  * real temperature -> potential temperature via the Exner function
  * geopotential -> geometric height [m]
  * specific humidity -> mixing ratio
  * descending latitude / level axes flipped to ascending

Inputs of either format are read through ``io/netcdf.NCFile``. As in the
JAX tool, a classic (CDF-1/2) input's ``scale_factor`` and ``add_offset``
unpack its values and a NetCDF-4 input's are not applied. The forcing file
is NetCDF-4 where h5py imports and CDF-2 where it does not.

Usage:
    python -m icar_tpu_torch.tools.reanalysis2icar era5.nc -o forcing.nc \
        --preset era5

Variables default to ERA5 names; anything missing is skipped.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GRAVITY = 9.81
P0 = 100000.0
ROVCP = 287.058 / 1012.0


class _Reader:
    """Variable access to an input file of either format through
    ``NCFile`` (the JAX tool's h5py and scipy read paths in one): values
    as float64; a classic file's ``scale_factor`` and ``add_offset``
    applied, a NetCDF-4 file's not, as the JAX tool reads them."""

    def __init__(self, path: str):
        from icar_tpu_torch.io.netcdf import NCFile
        self._f = NCFile(path)

    def has(self, name):
        return bool(name) and self._f.has_var(name)

    def read(self, name):
        data = np.asarray(self._f.read(name), np.float64)
        if not self._f.classic:
            return data
        attrs = self._f.attr_names(name)
        if "scale_factor" in attrs:
            data = data * float(self._f.read_attr(name, "scale_factor"))
        if "add_offset" in attrs:
            data = data + float(self._f.read_attr(name, "add_offset"))
        return data

    def close(self):
        self._f.close()


# per-dataset variable tables, matching the reference's dedicated
# converter suites (helpers/erai, cesm, ccsm, cmip; plus ERA5/MERRA-2):
# --preset NAME fills the variable names and unit conventions, and any
# explicit --Xvar flag still overrides
PRESETS = {
    "era5": dict(u="u", v="v", t="t", q="q", z="z", lev="level",
                 lat="latitude", lon="longitude"),
    # ERA-Interim GRIB-converted names (helpers/erai/io_routines.py:7-14):
    # hybrid-sigma levels with LOG surface pressure
    "erai": dict(u="U_GDS4_HYBL", v="V_GDS4_HYBL", t="T_GDS4_HYBL",
                 q="Q_GDS4_HYBL", z="Z_GDS4_HYBL",
                 hyam="lv_HYBL2_a", hybm="lv_HYBL2_b", p00="P0",
                 ps="LNSP_GDS4_HYBL", ps_is_log=True,
                 lat="g4_lat_0", lon="g4_lon_1", sst="SSTK_GDS4_SFC",
                 swdown="SSRD_GDS4_SFC", lwdown="STRD_GDS4_SFC",
                 hgt="Z_GDS4_SFC"),
    # CESM/CCSM history files (helpers/cesm/io_routines.py:8-9): hybrid
    # sigma with hyam/hybm/P0*PS; Z3 is geometric height
    "cesm": dict(u="U", v="V", t="T", q="Q", z="Z3",
                 hyam="hyam", hybm="hybm", p00="P0", ps="PS",
                 lat="lat", lon="lon", z_is_height=True),
    "ccsm": dict(u="U", v="V", t="T", q="Q", z="Z3",
                 hyam="hyam", hybm="hybm", p00="P0", ps="PS",
                 lat="lat", lon="lon", z_is_height=True),
    # CMOR/CMIP standard names (helpers/cmip): pressure levels in Pa
    "cmip": dict(u="ua", v="va", t="ta", q="hus", z="zg", lev="plev",
                 lat="lat", lon="lon"),
    # MERRA-2 M2I3NVASM (tools/get_merra.py): 3D pressure PL, H is
    # geometric height
    "merra2": dict(u="U", v="V", t="T", q="QV", z="H", p3d="PL",
                   lat="lat", lon="lon", z_is_height=True),
}


def convert(paths, out_path, names, t_is_real=True, q_is_sh=True,
            z_is_geopotential=True, ps_is_log=False, verbose=True):
    """Copy of tools/reanalysis2icar.py convert: the files ``paths``,
    read with the variable names ``names``, as one forcing file
    ``out_path``; returns ``out_path``."""
    acc: dict = {}

    def add(k, a):
        acc.setdefault(k, []).append(np.asarray(a, np.float32))

    lat = lon = None
    flip_lat = False
    for path in paths:
        f = _Reader(path)
        if verbose:
            print(f"reading {path}")
        if lat is None:
            lat = f.read(names["lat"]).squeeze()
            lon = f.read(names["lon"]).squeeze()
            flip_lat = lat.ndim == 1 and lat.size > 1 and lat[1] < lat[0]
            if flip_lat:
                lat = lat[::-1]

        def get(key):
            nm = names.get(key)
            if not nm or not f.has(nm):
                return None
            a = f.read(nm)
            if a.ndim == 4 and flip_lat:
                a = a[:, :, ::-1, :]
            elif a.ndim == 3 and flip_lat:
                a = a[:, ::-1, :]
            return a

        t = get("t")

        # 3D pressure
        if names.get("p3d") and f.has(names["p3d"]):
            p = get("p3d")                           # already (t,z,y,x) Pa
        elif names.get("lev") and f.has(names["lev"]):
            lev = f.read(names["lev"]).squeeze()     # (nz,)
            if lev.max() < 2000:                     # hPa -> Pa
                lev = lev * 100.0
            p = np.broadcast_to(lev[None, :, None, None],
                                t.shape).copy()
        elif names.get("hyam") and f.has(names["hyam"]):
            a = f.read(names["hyam"]).squeeze()
            b = f.read(names["hybm"]).squeeze()
            ps = get("ps")
            if ps_is_log:
                # ERA-I stores LN(surface pressure)
                # (helpers/erai/convert.py ln_p_sfc)
                ps = np.exp(ps)
            if ps is not None and ps.ndim == 4:
                ps = ps[:, 0]
            p0 = f.read(names["p00"]).squeeze() if (
                names.get("p00") and f.has(names["p00"])) else 1.0
            # p(t,k,y,x) = a_k*p0 + b_k*ps  (erai/convert.py:20-25)
            p = (a[None, :, None, None] * p0
                 + b[None, :, None, None] * ps[:, None, :, :])
        else:
            raise ValueError("need either a level coordinate (--levvar) or "
                             "hybrid coefficients (--hyam/--hybm/--psvar)")

        # icar_tpu wants ascending z = pressure decreasing with k
        flip_lev = p[0, 0].mean() < p[0, -1].mean()

        def reorder(a):
            return a[:, ::-1] if (flip_lev and a.ndim == 4) else a

        p = reorder(p)
        t = reorder(t)
        exner = (p / P0) ** ROVCP
        add("pressure", p)
        add("theta", t / exner if t_is_real else t)

        z = get("z")
        if z is not None:
            z = reorder(z)
            add("z", z / GRAVITY if z_is_geopotential else z)
        q = get("q")
        if q is not None:
            q = reorder(q)
            add("qv", q / (1.0 - q) if q_is_sh else q)
        for key in ("u", "v"):
            a = get(key)
            if a is not None:
                add(key, reorder(a))
        for key, out_name in (("sst", "sst"), ("swdown", "swdown"),
                              ("lwdown", "lwdown")):
            a = get(key)
            if a is not None:
                add(out_name, a)
        if "hgt" not in acc:
            hg = get("hgt")
            if hg is not None:
                if hg.ndim == 3:
                    hg = hg[0]
                acc["hgt"] = [np.asarray(
                    hg / GRAVITY if z_is_geopotential else hg, np.float32)]
        f.close()

    if lat.ndim == 1:
        lon2, lat2 = np.meshgrid(lon, lat)
    else:
        lat2, lon2 = lat, lon

    from icar_tpu_torch.io.netcdf import write_vars
    variables = {"lat": (("y", "x"), lat2.astype(np.float32)),
                 "lon": (("y", "x"), lon2.astype(np.float32))}
    for name, chunks in acc.items():
        data = (chunks[0] if name == "hgt"
                else np.concatenate(chunks, axis=0))
        dims = {4: ("time", "level", "y", "x"),
                3: ("time", "y", "x"), 2: ("y", "x")}[data.ndim]
        variables[name] = (dims, np.asarray(data, np.float32))
    write_vars(out_path, variables,
               attrs={"title": "icar_tpu forcing converted from reanalysis",
                      "source_files": " ".join(os.path.basename(p)
                                               for p in paths)})
    if verbose:
        print(f"wrote {out_path}: vars {', '.join(sorted(variables))}")
        print("\nsuggested &var_list:\n"
              "  pvar = \"pressure\", tvar = \"theta\", qvvar = \"qv\",\n"
              "  uvar = \"u\", vvar = \"v\", zvar = \"z\",\n"
              "  latvar = \"lat\", lonvar = \"lon\""
              + (", hgtvar = \"hgt\"" if "hgt" in variables else ""))
    return out_path


def main(argv=None):
    """Copy of tools/reanalysis2icar.py main: the command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("-o", "--output", default="icar_forcing.nc")
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    help="dataset variable table (the reference's "
                         "per-dataset helpers/{erai,cesm,ccsm,cmip} "
                         "suites); explicit --Xvar flags override")
    ap.add_argument("--uvar", default=None)
    ap.add_argument("--vvar", default=None)
    ap.add_argument("--tvar", default=None)
    ap.add_argument("--qvar", default=None)
    ap.add_argument("--zvar", default=None)
    ap.add_argument("--levvar", default=None)
    ap.add_argument("--latvar", default=None)
    ap.add_argument("--lonvar", default=None)
    ap.add_argument("--psvar", default=None)
    ap.add_argument("--pvar", default=None,
                    help="3D pressure variable (e.g. MERRA-2 PL)")
    ap.add_argument("--hyam", default=None)
    ap.add_argument("--hybm", default=None)
    ap.add_argument("--p00", default=None)
    ap.add_argument("--hgtvar", default=None)
    ap.add_argument("--sstvar", default=None)
    ap.add_argument("--t-is-potential", action="store_true",
                    help="input temperature is already potential T")
    ap.add_argument("--q-is-mixing-ratio", action="store_true")
    ap.add_argument("--z-is-height", action="store_true",
                    help="z is geometric height, not geopotential")
    ap.add_argument("--ps-is-log", action="store_true",
                    help="surface pressure is stored as ln(ps) (ERA-I)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    preset = dict(PRESETS.get(args.preset, {})) if args.preset else {}
    defaults = {"u": "u", "v": "v", "t": "t", "q": "q", "z": "z",
                "lev": "level", "lat": "latitude", "lon": "longitude",
                "ps": "", "p3d": "", "hyam": "", "hybm": "", "p00": "",
                "hgt": "", "sst": "", "swdown": "", "lwdown": ""}
    cli = {"u": args.uvar, "v": args.vvar, "t": args.tvar, "q": args.qvar,
           "z": args.zvar, "lev": args.levvar, "lat": args.latvar,
           "lon": args.lonvar, "ps": args.psvar, "p3d": args.pvar,
           "hyam": args.hyam, "hybm": args.hybm, "p00": args.p00,
           "hgt": args.hgtvar, "sst": args.sstvar}
    names = dict(defaults)
    for k, v in preset.items():
        if k in defaults:
            names[k] = v
    if args.preset and preset.get("lev") is None \
            and ("hyam" in preset or "p3d" in preset):
        names["lev"] = ""            # presets without a level coordinate
    for k, v in cli.items():
        if v is not None:
            names[k] = v
    z_is_height = args.z_is_height or preset.get("z_is_height", False)
    ps_is_log = args.ps_is_log or preset.get("ps_is_log", False)
    convert(args.inputs, args.output, names,
            t_is_real=not args.t_is_potential,
            q_is_sh=not args.q_is_mixing_ratio,
            z_is_geopotential=not z_is_height,
            ps_is_log=ps_is_log,
            verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())

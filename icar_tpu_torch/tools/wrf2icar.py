"""Convert WRF output (wrfout) files into model forcing files.

The port's counterpart of tools/wrf2icar.py (the reference's
helpers/wrf/wrf2icar.py + wrf_vars.py and helpers/wrf2icar.sh), with its
arguments and outputs: reads one or more wrfout files, computes the
derived fields ICAR wants, destaggers winds and geopotential to mass
points, and writes a single forcing file that ``python -m icar_tpu_torch``
ingests (``forcing/boundary.ForcingData``) with the var_list names it
prints.

Field derivations (wrf_vars.py:15-34):
    pressure = P + PB                     [Pa]
    z        = (PH + PHB) / g             geopotential height, destaggered
                                          from interfaces to mass levels
    theta    = T + 300                    perturbation -> full potential T
    qv       = QVAPOR
    qc       = QCLOUD + QRAIN             (merged, as the reference does)
    qi       = QICE + QSNOW + QGRAUP
    u, v     = U, V destaggered to mass points (grid-relative; COSALPHA /
               SINALPHA are carried over when present)
    2D       : HGT, XLAT, XLONG, TSK (sst slot), SWDOWN, GLW (lwdown),
               XLAND -> landmask (1=land, 0=water)

WRF writes NetCDF classic (io_form 2) or NetCDF-4 (io_form 11); both are
read through ``io/netcdf.NCFile``. The forcing file is NetCDF-4 where h5py
imports and CDF-2 where it does not.

Usage:
    python -m icar_tpu_torch.tools.wrf2icar wrfout_d01_2000-10-01* \
        -o icar_forcing.nc
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GRAVITY = 9.81


class _Reader:
    """Variable access to a wrfout file of either format through
    ``NCFile``, which reads both: the JAX tool's two read paths (h5py for
    NetCDF-4, scipy for classic files) in one."""

    def __init__(self, path: str):
        from icar_tpu_torch.io.netcdf import NCFile
        self.path = path
        self._f = NCFile(path)

    def has(self, name: str) -> bool:
        return self._f.has_var(name)

    def read(self, name: str) -> np.ndarray:
        return np.asarray(self._f.read(name))

    def close(self):
        self._f.close()


def _destagger(a: np.ndarray, axis: int) -> np.ndarray:
    """Copy of tools/wrf2icar.py _destagger: the means of neighbours
    along ``axis``."""
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(None, -1)
    hi[axis] = slice(1, None)
    return 0.5 * (a[tuple(lo)] + a[tuple(hi)])


def _parse_times(times: np.ndarray):
    """Copy of tools/wrf2icar.py _parse_times: WRF Times char array
    (nt, 19) -> list of 'YYYY-MM-DD HH:MM:SS'."""
    out = []
    for row in times:
        s = b"".join(np.asarray(row, "S1").ravel()).decode()
        out.append(s.replace("_", " "))
    return out


def convert(paths, out_path, verbose=True):
    """Copy of tools/wrf2icar.py convert: the wrfout files ``paths``
    as one forcing file ``out_path``; returns ``out_path``."""
    acc: dict = {}
    times: list = []

    def add(name, data):
        acc.setdefault(name, []).append(np.asarray(data, np.float32))

    for path in paths:
        f = _Reader(path)
        if verbose:
            print(f"reading {path}")
        p = f.read("P") + f.read("PB")
        nt = p.shape[0]
        add("pressure", p)
        add("z", _destagger(f.read("PH") + f.read("PHB"), axis=1) / GRAVITY)
        add("theta", f.read("T") + 300.0)
        add("qv", f.read("QVAPOR"))
        qc = f.read("QCLOUD") if f.has("QCLOUD") else np.zeros_like(p)
        if f.has("QRAIN"):
            qc = qc + f.read("QRAIN")
        add("qc", qc)
        if f.has("QICE") or f.has("QSNOW"):
            qi = np.zeros_like(p)
            for n in ("QICE", "QSNOW", "QGRAUP"):
                if f.has(n):
                    qi = qi + f.read(n)
            add("qi", qi)
        add("u", _destagger(f.read("U"), axis=3))
        add("v", _destagger(f.read("V"), axis=2))
        for wrf_name, out_name in (("TSK", "tsk"), ("SWDOWN", "swdown"),
                                   ("GLW", "glw"), ("PBLH", "pblh"),
                                   ("HFX", "hfx"), ("LH", "lh")):
            if f.has(wrf_name):
                add(out_name, f.read(wrf_name))
        if "lat" not in acc:
            acc["lat"] = [f.read("XLAT")[0]]
            acc["lon"] = [f.read("XLONG")[0]]
            acc["hgt"] = [f.read("HGT")[0]]
            if f.has("XLAND"):
                # XLAND: 1=land, 2=water -> ICAR landmask 1=land, 0=water
                acc["landmask"] = [
                    (f.read("XLAND")[0] < 1.5).astype(np.float32)]
            for n in ("COSALPHA", "SINALPHA"):
                if f.has(n):
                    acc[n.lower()] = [f.read(n)[0]]
        if f.has("Times"):
            times.extend(_parse_times(f.read("Times")))
        else:
            times.extend([""] * nt)
        f.close()

    from icar_tpu_torch.io.netcdf import write_vars

    dims4 = ("time", "level", "y", "x")
    dims3 = ("time", "y", "x")
    dims2 = ("y", "x")
    variables = {}
    for name, chunks in acc.items():
        data = (chunks[0] if name in ("lat", "lon", "hgt", "landmask",
                                      "cosalpha", "sinalpha")
                else np.concatenate(chunks, axis=0))
        dims = {4: dims4, 3: dims3, 2: dims2}[data.ndim]
        variables[name] = (dims, np.asarray(data, np.float32))

    # advisory CF time variable (the icar_tpu driver paces forcing by
    # forcing_start_date + inputinterval, but keep the times on record)
    interval = None
    if times and times[0]:
        from icar_tpu_torch.utils.calendar import Time
        t0 = Time.from_string(times[0])
        hours = np.array([(Time.from_string(s) - t0).seconds() / 3600.0
                          for s in times if s], np.float32)
        variables["time"] = (("time",), hours,
                             {"units": f"hours since {times[0]}"})
        if len(hours) > 1:
            interval = float(hours[1] - hours[0]) * 3600.0

    write_vars(out_path, variables,
               attrs={"title": "icar_tpu forcing converted from WRF",
                      "source_files": " ".join(os.path.basename(p)
                                               for p in paths)})
    if verbose:
        nt = len(times)
        print(f"wrote {out_path}: {nt} steps, "
              f"vars: {', '.join(sorted(variables))}")
        print("\nsuggested namelist entries:")
        print("&files_list\n"
              f"  boundary_files = \"{out_path}\"\n/")
        print("&var_list\n"
              "  pvar = \"pressure\", tvar = \"theta\", qvvar = \"qv\",\n"
              "  uvar = \"u\", vvar = \"v\", zvar = \"z\",\n"
              "  latvar = \"lat\", lonvar = \"lon\", hgtvar = \"hgt\",\n"
              "  sst_var = \"tsk\", swdown_var = \"swdown\", "
              "lwdown_var = \"glw\",\n"
              "  landvar = \"landmask\"\n/")
        if times and times[0]:
            print("&parameters\n"
                  f"  forcing_start_date = \"{times[0]}\""
                  + (f"\n  inputinterval = {interval:.0f}"
                     if interval else "") + "\n/")
    return out_path


def main(argv=None):
    """Copy of tools/wrf2icar.py main: the command line."""
    ap = argparse.ArgumentParser(
        description="convert WRF wrfout files to an icar_tpu forcing file")
    ap.add_argument("inputs", nargs="+", help="wrfout file(s), in time order")
    ap.add_argument("-o", "--output", default="icar_forcing.nc")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    convert(args.inputs, args.output, verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Generate a download script + converter for MERRA-2 forcing data.

The port's counterpart of tools/get_merra.py (the reference's
helpers/get_merra.py, which emits a wget script and relies on nco's
ncpdq/ncrcat for post-processing), with its arguments and outputs: emits
the authenticated-subset wget script for the M2I3NVASM (inst3_3d_asm_Nv)
collection (this tool downloads nothing itself), and its ``--convert``
mode flips the model-level dimension so that level 0 is the surface and
concatenates the daily files into one forcing file, through
``io/netcdf.NCFile``: NetCDF-4 where h5py imports, CDF-2 where it does
not.

Downloads need a ~/.netrc entry for urs.earthdata.nasa.gov.

Usage:
  python -m icar_tpu_torch.tools.get_merra -s 2010-01-01 -e 2010-02-01 \
      > fetch.sh
  bash fetch.sh                      # downloads MERRA2_*.SUB.nc
  python -m icar_tpu_torch.tools.get_merra --convert 'MERRA2_*.SUB.nc' \
      -o merra_forcing.nc

The converted file feeds icar_tpu_torch.tools.reanalysis2icar (``--preset
merra2``) or can be used directly as a forcing file with
  zvar='H' pvar='PL' tvar='T' qvvar='QV' uvar='U' vvar='V'
"""

import argparse
import datetime
import glob
import os
import sys

# the bottom 38 model levels (~0-16 km), as in the reference's LAYERS list
URL = ("https://goldsmr5.gesdisc.eosdis.nasa.gov/daac-bin/OTF/"
       "HTTP_services.cgi?FILENAME=%2Fdata%2FMERRA2%2FM2I3NVASM.5.12.4"
       "%2F{d.year:04}%2F{d.month:02}%2FMERRA2_{version}.inst3_3d_asm_Nv."
       "{d.year:04}{d.month:02}{d.day:02}.nc4&FORMAT=bmM0Lw"
       "&BBOX={south}%2C{west}%2C{north}%2C{east}"
       "&LABEL=MERRA2_{version}.inst3_3d_asm_Nv."
       "{d.year:04}{d.month:02}{d.day:02}.SUB.nc"
       "&SHORTNAME=M2I3NVASM&SERVICE=SUBSET_MERRA2"
       "&LAYERS=LAYER_" + "%2C".join(str(i) for i in range(35, 73)) +
       "&VERSION=1.02&DATASET_VERSION=5.12.4"
       "&VARIABLES=H%2CPHIS%2CPL%2CPS%2CQI%2CQL%2CQV%2CT%2CU%2CV")

VARS_3D = ["H", "PL", "QI", "QL", "QV", "T", "U", "V"]
VARS_2D = ["PHIS", "PS"]


def merra_version(d: datetime.date) -> str:
    """Copy of tools/get_merra.py merra_version: MERRA-2 production-stream
    number (100/200/300/400).

    Deliberate divergence from the reference's get_merra.py, whose
    (year-1971)/10 decade arithmetic maps 1991 to stream 200 — but
    MERRA2_100 covers 1980-1991, so those URLs 404. Uses the actual
    GES DISC stream boundaries instead."""
    if d.year <= 1991:
        return "100"
    if d.year <= 2000:
        return "200"
    if d.year <= 2010:
        return "300"
    return "400"


def emit_script(start, end, north, south, east, west, parallel=4):
    print("#!/bin/bash")
    print("# generated by icar_tpu_torch.tools.get_merra")
    day = datetime.timedelta(days=1)
    n_days = (end - start) // day
    for i in range(n_days):
        d = start + day * i
        url = URL.format(d=d, version=merra_version(d), north=north,
                         south=south, east=east, west=west)
        bg = "&" if (i % parallel) < parallel - 1 else ""
        print(f'wget --auth-no-challenge=on --content-disposition "{url}" {bg}')
    print("wait")
    print("# then: python -m icar_tpu_torch.tools.get_merra "
          f"--convert 'MERRA2_*.SUB.nc' -o merra_forcing_"
          f"{start.year:04}_{start.month:02}_{start.day:02}.nc")


def convert(pattern: str, out_path: str):
    """Copy of tools/get_merra.py convert: flip the lev dimension
    (MERRA-2 stores top-down; ICAR wants surface-up, the reference used
    `ncpdq -a -lev`) and concatenate the daily files along time (ncrcat
    equivalent)."""
    import numpy as np

    from icar_tpu_torch.io.netcdf import NCFile

    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no files match {pattern!r}")
    pieces = {}
    coords = {}
    times = []
    for path in files:
        with NCFile(path) as f:
            for v in ("lat", "lon", "lev"):
                if v not in coords and v in f.variables():
                    coords[v] = np.asarray(f.read(v))
            t = np.asarray(f.read("time"), np.float64)
            # each daily file counts minutes from its own midnight
            base = os.path.basename(path).split(".")[-3]
            day0 = datetime.datetime.strptime(base, "%Y%m%d")
            epoch = datetime.datetime(1900, 1, 1)
            times.append((day0 - epoch).total_seconds() / 3600.0 + t / 60.0)
            for v in VARS_3D + VARS_2D:
                if v in f.variables():
                    pieces.setdefault(v, []).append(np.asarray(f.read(v)))
    if "lev" in coords:
        coords["lev"] = coords["lev"][::-1]
    with NCFile(out_path, "w") as f:
        f.create_var("time", ("time",), np.concatenate(times),
                     attrs={"units": "hours since 1900-01-01 00:00:00"})
        for name in ("lat", "lon", "lev"):
            if name in coords:
                f.create_var(name, (name,), coords[name])
        for v, chunks in pieces.items():
            data = np.concatenate(chunks, axis=0)
            if data.ndim == 4:       # (time, lev, lat, lon): flip lev up
                data = data[:, ::-1]
                dims = ("time", "lev", "lat", "lon")
            else:
                dims = ("time", "lat", "lon")
            f.create_var(v, dims, data.astype(np.float32))
    print(f"wrote {out_path}: {len(files)} files, "
          f"{sum(len(t) for t in times)} steps")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", "--startdate",
                    type=lambda s: datetime.date.fromisoformat(s))
    ap.add_argument("-e", "--enddate",
                    type=lambda s: datetime.date.fromisoformat(s))
    ap.add_argument("--north", default="55.009")
    ap.add_argument("--south", default="21.962")
    ap.add_argument("--east", default="-64.336")
    ap.add_argument("--west", default="-131.133")
    ap.add_argument("--convert", metavar="GLOB",
                    help="post-process downloaded files instead of "
                         "emitting the wget script")
    ap.add_argument("-o", "--out", default="merra_forcing.nc")
    args = ap.parse_args(argv)
    if args.convert:
        convert(args.convert, args.out)
        return
    if not (args.startdate and args.enddate):
        ap.error("-s and -e are required when generating the script")
    emit_script(args.startdate, args.enddate, args.north, args.south,
                args.east, args.west)


if __name__ == "__main__":
    sys.exit(main())

"""Extract daily precipitation totals from model output.

The port's counterpart of tools/extract_daily_precip.py (the reference's
helpers/extract_daily_precip.py), with its arguments and outputs: reads
one or more output files (the single growing file, rotated files, or
classic-async per-step files; NetCDF-4 or CDF-1/2), de-accumulates the
``precipitation`` field (an accumulator in both models), bins it into
whole days from the run start, and writes one small file with (day, y, x)
totals [mm], NetCDF-4 where h5py imports and CDF-2 where it does not.

Usage:
    python -m icar_tpu_torch.tools.extract_daily_precip \
        output/icar_out_run*.nc -o daily.nc
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_steps(paths):
    """Copy of tools/extract_daily_precip.py load_steps: (times[s],
    precip[t, y, x]) concatenated across files."""
    from icar_tpu_torch.io.netcdf import NCFile
    times, precs = [], []
    for p in paths:
        with NCFile(p) as f:
            if f.has_var("model_time"):
                t = np.atleast_1d(np.asarray(f.read("model_time"),
                                             np.float64))
                pr = np.asarray(f.read("precipitation"), np.float64)
                if pr.ndim == 2:
                    pr = pr[None]
            else:                      # classic-async per-step file
                t = np.asarray([float(f.read_attr(None, "model_time"))])
                pr = np.asarray(f.read("precipitation"), np.float64)[None]
        times.append(t)
        precs.append(pr)
    t = np.concatenate(times)
    pr = np.concatenate(precs, axis=0)
    order = np.argsort(t)
    return t[order], pr[order]


def daily_totals(times, precip):
    """Copy of tools/extract_daily_precip.py daily_totals: de-accumulate
    and bin into whole days from t=0. The delta between
    consecutive frames is attributed to the day containing the interval's
    end (a frame exactly on a day boundary closes the previous day)."""
    def day_of(t):
        d = int(t // 86400.0)
        if t % 86400.0 == 0.0 and d > 0:
            d -= 1
        return d

    ndays = day_of(times[-1]) + 1
    out = np.zeros((ndays,) + precip.shape[1:], np.float64)
    for i in range(1, len(times)):
        out[day_of(times[i])] += precip[i] - precip[i - 1]
    return out


def main(argv=None):
    """Copy of tools/extract_daily_precip.py main: the command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+", help="icar output file(s)")
    ap.add_argument("-o", "--output", default="daily_precip.nc")
    args = ap.parse_args(argv)
    t, pr = load_steps(args.inputs)
    daily = daily_totals(t, pr)
    from icar_tpu_torch.io.netcdf import write_vars
    write_vars(args.output, {
        "precipitation": (("day", "y", "x"),
                          daily.astype(np.float32), {"units": "mm"}),
        "day": (("day",), np.arange(daily.shape[0], dtype=np.float32),
                {"units": "days since run start"})},
        attrs={"title": "daily precipitation totals"})
    print(f"wrote {args.output}: {daily.shape[0]} day(s), "
          f"domain total {daily.sum():.1f} mm·cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Aggregate per-step output files into one time-series NetCDF file.

The port's counterpart of tools/aggregate_output.py, with its arguments
and outputs:

    python -m icar_tpu_torch.tools.aggregate_output 'output/icar_out_*.nc' \\
        -o combined.nc

Per-step files of the "classic-async" engine (``io/output.py``
``AsyncStepWriter``) are concatenated along a time axis. Files per shard
of the "sharded" engine (``ShardedOutputWriter``,
``{prefix}img{sid:03d}_{t:08d}.nc``) are grouped by the time in their
names and each shard placed at its ``y_start``, ``x_start``, which gives
back the whole domain (the reference's
helpers/aggregate_parallel_files.py). Every file, NetCDF-4 or CDF-1/2, is
read through ``io/netcdf.NCFile``, and the result is written through it:
NetCDF-4 where h5py imports, CDF-2 where it does not (``time`` the record
dimension, first in every variable). As in the JAX tool, every stitched
field is cast to float32, and the decomposition attributes (``y_start``,
``x_start``, ``shard_id``) are dropped.
"""

import argparse
import glob
import os
import sys

import numpy as np


def read_file(path):
    """({name: (dims, array)}, {global attribute: value}) of one output
    file of either format: the JAX tool's ``read_classic`` and
    ``read_nc4`` in one, through ``NCFile``."""
    from icar_tpu_torch.io.netcdf import NCFile
    with NCFile(path) as f:
        variables = {n: (f.var_dims(n), f.read(n)) for n in f.variables()}
        attrs = {k: f.read_attr(None, k) for k in f.attr_names()}
    return variables, attrs


def aggregate_shards(paths, output):
    """Stitch file-per-shard output (io/output.py ShardedOutputWriter)
    back into one global time-series file using the y_start/x_start
    decomposition attrs (tools/aggregate_output.py aggregate_shards, each
    file read by ``read_file``)."""
    from icar_tpu_torch.io.netcdf import NCFile

    # group by timestamp embedded in the filename suffix
    by_time = {}
    for p in paths:
        stem = os.path.basename(p)
        t = stem.rsplit("_", 1)[-1].replace(".nc", "")
        by_time.setdefault(t, []).append(p)

    times = []
    frames = []          # list of dict name -> global array
    gattrs = {}
    for t in sorted(by_time):
        merged = {}
        for p in sorted(by_time[t]):
            variables, attrs = read_file(p)
            gattrs = attrs
            y0, x0 = int(attrs["y_start"]), int(attrs["x_start"])
            for name, (_, arr) in variables.items():
                if arr.ndim < 2:
                    continue
                if name not in merged:
                    merged[name] = []
                merged[name].append((y0, x0, arr))
        times.append(float(gattrs.get("model_time", len(times))))
        glob_f = {}
        for name, pieces in merged.items():
            ny = max(y0 + a.shape[-2] for y0, _, a in pieces)
            nx = max(x0 + a.shape[-1] for _, x0, a in pieces)
            lead = pieces[0][2].shape[:-2]
            g = np.zeros(lead + (ny, nx), np.float32)
            for y0, x0, a in pieces:
                g[..., y0:y0 + a.shape[-2], x0:x0 + a.shape[-1]] = a
            glob_f[name] = g
        frames.append(glob_f)

    with NCFile(output, "w") as out:
        out.create_dim("time", len(frames), unlimited=True)
        dims_seen = set()
        first = frames[0]
        for name, arr in first.items():
            # canonical dim names, one per size
            canon = (("lev", "lat", "lon") if arr.ndim == 3
                     else ("lat", "lon"))
            dims = tuple(f"{c}_{n}" for c, n in zip(canon, arr.shape))
            for d, n in zip(dims, arr.shape):
                if d not in dims_seen:
                    dims_seen.add(d)
                    out.create_dim(d, n)
            stacked = np.stack([fr[name] for fr in frames], axis=0)
            out.create_var(name, ("time",) + dims, stacked)
        out.create_var("model_time", ("time",),
                       np.asarray(times, np.float64))
        out.set_attrs({k: v for k, v in gattrs.items()
                       if k not in ("y_start", "x_start", "shard_id")})
    print(f"wrote {output}: {len(frames)} steps from "
          f"{len(paths)} shard files")
    return 0


def aggregate_steps(paths, output):
    """Concatenate per-step files (the "classic-async" engine's) along a
    new record dimension ``time``, with ``model_time`` from each file's
    attribute (its index where it has none)."""
    from icar_tpu_torch.io.netcdf import NCFile

    steps = []
    times = []
    attrs = {}
    for i, path in enumerate(paths):
        variables, attrs = read_file(path)
        steps.append(variables)
        times.append(float(attrs.get("model_time", i)))
    times = np.asarray(times, np.float64)

    first = steps[0]
    with NCFile(output, "w") as out:
        out.create_dim("time", len(steps), unlimited=True)
        dims_seen = {}
        for name, (dims, arr) in first.items():
            for d, n in zip(dims, arr.shape):
                if d not in dims_seen:
                    dims_seen[d] = n
                    out.create_dim(d, n)
        out.create_var("model_time", ("time",), times)
        for name, (dims, arr) in first.items():
            stacked = np.stack([s[name][1] for s in steps], axis=0)
            out.create_var(name, ("time",) + tuple(dims), stacked)
        out.set_attrs(attrs)
    print(f"wrote {output}: {len(steps)} steps, "
          f"{len(first)} variables")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pattern", help="glob of per-step files (quote it)")
    p.add_argument("-o", "--output", default="icar_aggregated.nc")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.pattern))
    if not paths:
        print(f"no files match {args.pattern}", file=sys.stderr)
        return 1

    # shard files (ShardedOutputWriter) carry decomposition attrs. As in
    # the JAX tool, any error while stitching them (or reading the first)
    # falls through to the per-step concatenation.
    try:
        _, attrs0 = read_file(paths[0])
        if "shard_id" in attrs0:
            return aggregate_shards(paths, args.output)
    except Exception:
        pass
    return aggregate_steps(paths, args.output)


if __name__ == "__main__":
    sys.exit(main())

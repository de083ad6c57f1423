"""Repair the time axis of a model output file.

The port's counterpart of tools/fix_time.py (the reference's
helpers/fix_icar_time.py), with its arguments and outputs: when a run is
restarted without removing the output file it was restarting into, the
appended frames can carry duplicate or backward-jumping time stamps. This
tool rewrites ``model_time`` as a clean monotonic axis ``t0 + k*dt`` (dt
inferred from the median positive step unless given), or with
``--truncate`` drops every frame at or before the last backward jump
(keeping the post-restart frames, which superseded them).

A NetCDF-4 file is edited in place through h5py, as the JAX tool does. A
NetCDF classic (CDF-1/2) file cannot shrink its record dimension in
place, so it is read through ``io/netcdf.NCFile``, fixed, written as
CDF-2 to a temporary file in the same directory and moved over the
original: the same variables, dimensions and attributes as the JAX tool
gives for the NetCDF-4 file.

Usage:
    python -m icar_tpu_torch.tools.fix_time icar_out.nc [-o fixed.nc] \\
        [--dt SECONDS] [--truncate]
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np


def _kept_frames(t):
    """The frames ``--truncate`` keeps of time axis ``t``: from the last
    backward jump on, and those before it older than every kept time."""
    bad = np.where(np.diff(t) <= 0)[0]
    cut = bad[-1] + 1
    keep = np.arange(t.size) >= cut
    keep |= t < t[cut:].min()
    return np.where(keep)[0]


def _new_axis(t, dt):
    """The rewritten axis ``t0 + k*dt``, and the dt it uses (``dt``, else
    the median positive step, else 3600 s)."""
    steps = np.diff(t)
    dt = dt or float(np.median(steps[steps > 0])) \
        if steps.size else (dt or 3600.0)
    return t[0] + dt * np.arange(t.size), dt


def _fix_netcdf4(h5py, path, name, dt, truncate):
    """The JAX tool's edit, in place through h5py."""
    with h5py.File(path, "r+") as f:
        if "model_time" not in f:
            raise SystemExit(f"{name}: no model_time variable")
        t = f["model_time"][...].astype(np.float64)
        bad = np.where(np.diff(t) <= 0)[0]
        if bad.size == 0 and not dt:
            print(f"{name}: time axis already monotonic ({t.size} frames)")
            return
        if truncate:
            idx = _kept_frames(t)
            for var, ds in list(f.items()):
                if ds.shape and ds.maxshape and ds.maxshape[0] is None:
                    data = ds[...][idx]
                    ds.resize(idx.size, axis=0)
                    ds[...] = data
            print(f"{name}: kept {idx.size}/{t.size} frames")
        else:
            t_new, dt = _new_axis(t, dt)
            f["model_time"][...] = t_new
            print(f"{name}: rewrote {t.size} frames as t0={t[0]:.0f}"
                  f" + k*{dt:.0f} s ({bad.size} non-monotonic steps fixed)")


def _fix_classic(path, name, dt, truncate):
    """The same edit of a classic file: every record variable keeps the
    kept frames (``--truncate``) or ``model_time`` takes the new axis; the
    file is written anew beside ``path`` and replaces it."""
    from icar_tpu_torch.io.netcdf import NCFile

    with NCFile(path) as f:
        if not f.has_var("model_time"):
            raise SystemExit(f"{name}: no model_time variable")
        record = [d for d, n in f.f.dimensions.items() if n is None]
        dims = dict(f._dims)
        variables = {v: (f.var_dims(v), f.read(v),
                         {k: f.read_attr(v, k) for k in f.attr_names(v)})
                     for v in f.variables()}
        attrs = {k: f.read_attr(None, k) for k in f.attr_names()}
    t = variables["model_time"][1].astype(np.float64)
    bad = np.where(np.diff(t) <= 0)[0]
    if bad.size == 0 and not dt:
        print(f"{name}: time axis already monotonic ({t.size} frames)")
        return
    if truncate:
        idx = _kept_frames(t)
        for v, (vdims, data, vattrs) in variables.items():
            if vdims and vdims[0] in record:
                variables[v] = (vdims, data[idx], vattrs)
        for d in record:
            dims[d] = idx.size
        print(f"{name}: kept {idx.size}/{t.size} frames")
    else:
        t_new, dt = _new_axis(t, dt)
        vdims, data, vattrs = variables["model_time"]
        variables["model_time"] = (vdims, t_new.astype(data.dtype), vattrs)
        print(f"{name}: rewrote {t.size} frames as t0={t[0]:.0f}"
              f" + k*{dt:.0f} s ({bad.size} non-monotonic steps fixed)")
    fd, tmp = tempfile.mkstemp(suffix=".nc", dir=os.path.dirname(
        os.path.abspath(path)))
    os.close(fd)
    try:
        with NCFile(tmp, "w", fmt="classic") as out:
            for d, n in dims.items():
                out.create_dim(d, n, unlimited=d in record)
            for v, (vdims, data, vattrs) in variables.items():
                out.create_var(v, vdims, data, vattrs)
            out.set_attrs(attrs)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None,
                   help="write the fixed file here (default: in place)")
    p.add_argument("--dt", type=float, default=None,
                   help="output interval in seconds (default: inferred)")
    p.add_argument("--truncate", action="store_true",
                   help="drop frames superseded after a restart instead "
                        "of rewriting the axis")
    args = p.parse_args(argv)

    from icar_tpu_torch.io import netcdf

    path = args.input
    if args.output and args.output != args.input:
        shutil.copyfile(args.input, args.output)
        path = args.output
    if netcdf.file_format(path) == "classic":
        _fix_classic(path, args.input, args.dt, args.truncate)
    elif netcdf.h5py is None:
        raise RuntimeError(f"{args.input} is a NetCDF-4 (HDF5) file, and "
                           "editing it needs h5py, which is not installed")
    else:
        _fix_netcdf4(netcdf.h5py, path, args.input, args.dt, args.truncate)


if __name__ == "__main__":
    sys.exit(main())

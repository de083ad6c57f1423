"""Model output and restart/checkpoint IO (icar_tpu/io/output.py).

Replaces output_t (output_h.f90, output_obj.f90 of the reference) and its
restart machinery (restart.f90). Output is CF-flavored NetCDF with
per-variable metadata drawn from the registry: NetCDF-4 where h5py is
importable, CDF-2 where it is not (``io/netcdf.py``). Restarts are
registry-driven and decomposition-independent (whole-domain arrays), in
the JAX package's layout, so each package resumes from the other's
checkpoints. File-per-shard output and restarts are not ported (Slice G).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .. import constants as C
from ..registry import REGISTRY
from .netcdf import NCFile

SOURCE = f"icar_tpu_torch {C.VERSION_STRING}"

_DIM_NAMES = {
    (False, False, False): ("lev", "lat", "lon"),
    (True, False, False): ("lev", "lat", "lon_u"),
    (False, True, False): ("lev", "lat_v", "lon"),
    (False, False, True): ("lev_i", "lat", "lon"),
}


def _var_dims(spec, arr):
    if arr.ndim == 2:
        sx = spec.stagger == "x"
        sy = spec.stagger == "y"
        return ("lat_v" if sy else "lat", "lon_u" if sx else "lon")
    key = (spec.stagger == "x", spec.stagger == "y", spec.stagger == "zi")
    return _DIM_NAMES.get(key, ("lev", "lat", "lon"))


class OutputWriter:
    """Appends model state slices to a NetCDF file (output_t::save_file,
    output_obj.f90:41-78)."""

    def __init__(self, path: str, names: List[str], options=None):
        self.base = path
        self.path = path
        self.names = names
        self.options = options
        self._initialized = False
        self._frames = 0
        self._file_idx = 0
        # one file per frames_per_outfile output steps (driver.f90:94-102
        # starts a new per-image file per output period; default 24)
        fpo = getattr(getattr(options, "output", None),
                      "frames_per_outfile", 0) if options else 0
        self.frames_per_file = int(fpo) if fpo else 0

    def _rotate(self):
        self._file_idx += 1
        root, ext = os.path.splitext(self.base)
        self.path = f"{root}_{self._file_idx:03d}{ext}"
        self._initialized = False
        self._frames = 0

    def write_step(self, model, time_seconds: float):
        names = [n for n in self.names if n in model._held()]
        if (self.frames_per_file > 0 and self._initialized
                and self._frames >= self.frames_per_file):
            self._rotate()
        self._frames += 1
        if not self._initialized:
            with NCFile(self.path, "w") as f:
                f.create_dim("time", 0, unlimited=True)
                for n in names:
                    arr = model.field(n)
                    spec = REGISTRY[n]
                    dims = ("time",) + _var_dims(spec, arr)
                    attrs = {"units": spec.units}
                    if spec.standard_name:
                        attrs["standard_name"] = spec.standard_name
                    f.create_var(n, dims, arr[None].astype(np.float32), attrs)
                f.create_var("model_time", ("time",),
                             np.asarray([time_seconds], np.float64),
                             {"units": "seconds since run start"})
                attrs = {"source": SOURCE}
                if self.options is not None:
                    attrs["comment"] = self.options.comment
                g = model.geom
                attrs.update({"nx": g.nx, "ny": g.ny, "nz": g.nz, "dx": g.dx})
                f.set_attrs(attrs)
            self._initialized = True
        else:
            with NCFile(self.path, "a") as f:
                for n in names:
                    f.append_time_slice(n, model.field(n))
                f.append_time_slice("model_time",
                                    np.float64(time_seconds))


class AsyncStepWriter:
    """Per-step output through the native async NetCDF-classic writer
    (csrc/ncwriter.cpp): each output step becomes one CDF-2 file written by
    a C++ worker thread, so the model never blocks on disk. File naming
    mirrors the reference's date-stamped per-step files (driver.f90:94-102)."""

    def __init__(self, prefix: str, names: List[str], options=None):
        from .async_writer import AsyncNCWriter
        self.prefix = prefix
        self.names = names
        self.options = options
        self.paths: List[str] = []
        self._w = AsyncNCWriter()

    @property
    def path(self):
        return self.paths[-1] if self.paths else self.prefix

    def write_step(self, model, time_seconds: float):
        variables = {}
        for n in self.names:
            if n not in model._held():
                continue
            arr = model.field(n)
            variables[n] = (_var_dims(REGISTRY[n], arr), arr)
        g = model.geom
        attrs = {"source": SOURCE,
                 "model_time": f"{time_seconds}",
                 "nx": str(g.nx), "ny": str(g.ny), "nz": str(g.nz),
                 "dx": str(g.dx)}
        path = f"{self.prefix}{int(time_seconds):08d}.nc"
        self._w.write(path, variables, attrs)
        self.paths.append(path)

    def wait(self) -> int:
        return self._w.wait()

    def close(self):
        self._w.close()


def _restart_payload(model, time_seconds: float):
    from ..core.state import restart_names

    data = {"__time__": np.float64(time_seconds)}
    for n in restart_names(model.options):
        if n in model._held():
            data[n] = model.field(n)
    if model.u_perturbation is not None:
        data["__u_perturbation__"] = model.u_perturbation.cpu().numpy()
        data["__v_perturbation__"] = model.v_perturbation.cpu().numpy()
    return data


def write_restart(path: str, model, time_seconds: float):
    """Checkpoint all restart fields + wind-perturbation state
    (driver.f90:181-191 restart writes; whole-domain fields, so any later
    mesh can resume).

    NetCDF for tool interop (the reference's restarts are per-image
    NetCDF, restart.f90:12-89); the legacy .npz format is written when
    ``path`` ends in .npz."""
    data = _restart_payload(model, time_seconds)
    if path.endswith(".npz"):
        np.savez_compressed(path, **data)
        return
    with NCFile(path, "w") as f:
        for n, arr in data.items():
            if n == "__time__":
                continue
            arr = np.asarray(arr)
            dims = tuple(f"d{arr.shape[i]}_{i}" for i in range(arr.ndim))
            for d, size in zip(dims, arr.shape):
                if d not in f._dims:
                    f.create_dim(d, size)
            f.create_var(n, dims, arr)      # native dtype
        f.set_attrs({"restart_time_seconds": float(time_seconds),
                     "source": SOURCE})


def read_restart(path: str, model):
    """Resume model state from a checkpoint (restart_model,
    restart.f90:12-89): NetCDF (either format) or legacy .npz, written by
    this package or the JAX package. Returns the restart time in seconds
    since run start."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            fields = {n: d[n] for n in d.files if not n.startswith("__")}
            pert = ({"u": d["__u_perturbation__"],
                     "v": d["__v_perturbation__"]}
                    if "__u_perturbation__" in d.files else None)
            t = float(d["__time__"])
    else:
        with NCFile(path) as f:
            fields = {}
            pert = {}
            for n in f.variables():
                arr = f.read(n)
                if n == "__u_perturbation__":
                    pert["u"] = arr
                elif n == "__v_perturbation__":
                    pert["v"] = arr
                else:
                    fields[n] = arr
            pert = pert or None
            t = float(f.read_attr(None, "restart_time_seconds"))
    s = model._global_state()
    for n, arr in fields.items():
        if n not in s:
            continue
        if tuple(arr.shape) != tuple(s[n].shape):
            raise ValueError(
                f"restart field {n} has shape {arr.shape}, expected "
                f"{tuple(s[n].shape)}: domain configuration changed")
        s[n] = model._tensor(arr)
    model._install(s)
    if pert is not None:
        model.u_perturbation = model._tensor(pert["u"])
        model.v_perturbation = model._tensor(pert["v"])
    model.model_time = t
    return model.model_time

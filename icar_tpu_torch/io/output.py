"""Model output and restart/checkpoint IO (icar_tpu/io/output.py).

Replaces output_t (output_h.f90, output_obj.f90 of the reference) and its
restart machinery (restart.f90). Output is CF-flavored NetCDF with
per-variable metadata drawn from the registry: NetCDF-4 where h5py is
importable, CDF-2 where it is not (``io/netcdf.py``). Restarts are
registry-driven and decomposition-independent (whole-domain arrays), in
the JAX package's layout, so each package resumes from the other's
checkpoints. A sharded model also writes one output file per shard and
step (``ShardedOutputWriter``) and restarts per shard
(``write_restart_sharded``, ``read_restart_sharded``), in the JAX
package's files per shard: a shard named by its row-major index, placed
by its start in the JAX package's padded frame (``parallel.mesh.Layout``),
so ``tools/aggregate_output.py`` stitches the port's output files and each
package reads the other's restarts of the same decomposition.
"""

from __future__ import annotations

import os
from typing import List, Sequence

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


def _var_attrs(name: str):
    """The registry's units and standard name of output variable
    ``name``."""
    spec = REGISTRY[name]
    attrs = {"units": spec.units}
    if spec.standard_name:
        attrs["standard_name"] = spec.standard_name
    return attrs


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
                    dims = ("time",) + _var_dims(REGISTRY[n], arr)
                    f.create_var(n, dims, arr[None].astype(np.float32),
                                 _var_attrs(n))
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


def _shards(model):
    """(shard id, (y_start, x_start), shard) of each shard of ``model``:
    one per block with a mesh (``Layout.shard_id``, ``frame_start``); the
    whole domain as shard 0 at (0, 0), shard None, without one (the JAX
    package's one device)."""
    if model.mesh is None:
        return [(0, (0, 0), None)]
    lay = model.layout
    return [(lay.shard_id(s), lay.frame_start(s), s) for s in lay.shards]


class ShardedOutputWriter:
    """File-per-shard output (icar_tpu/io/output.py ShardedOutputWriter;
    the reference's file-per-image output, driver.f90:94-102): at each
    output step every shard writes ``{prefix}img{sid:03d}_{t:08d}.nc`` from
    its own block -- each field's cells the shard owns (a staggered
    field's end face on the last row or column of shards), which are the
    JAX writer's shard of its padded frame trimmed to the natural domain
    -- with the JAX writer's global attributes (``nx, ny, nz, dx,
    y_start, x_start, shard_id, model_time``, ``source``).
    ``tools/aggregate_output.py`` stitches the files back into the whole
    domain. Without a mesh one file holds the whole domain (``img000``,
    as the JAX writer's one device). The files go through the native
    async CDF-2 writer (``io/async_writer.py``) when it is built, else
    through ``NCFile``; ``wait`` drains the writer."""

    def __init__(self, prefix: str, names: List[str], options=None):
        from . import async_writer

        self.prefix = prefix
        self.names = names
        self.options = options
        self.paths: List[str] = []
        self._async = (async_writer.AsyncNCWriter()
                       if async_writer.available() else None)

    @property
    def path(self):
        return self.paths[-1] if self.paths else self.prefix

    def write_step(self, model, time_seconds: float):
        names = [n for n in self.names if n in model._held()]
        g = model.geom
        for b, (sid, (y0, x0), shard) in enumerate(_shards(model)):
            path = f"{self.prefix}img{sid:03d}_{int(time_seconds):08d}.nc"
            variables = {}
            for n in names:
                if shard is None:
                    data = model.field(n)
                else:
                    data = model.layout.owned_cells(
                        model.blocks[b][n], shard).cpu().numpy()
                data = data.astype(np.float32)
                variables[n] = (_var_dims(REGISTRY[n], data), data)
            attrs = {"source": SOURCE, "model_time": float(time_seconds),
                     "nx": g.nx, "ny": g.ny, "nz": g.nz, "dx": g.dx,
                     "y_start": int(y0), "x_start": int(x0),
                     "shard_id": int(sid)}
            if self._async is not None:
                self._async.write(path, variables,
                                  {k: str(v) for k, v in attrs.items()})
            else:
                with NCFile(path, "w") as f:
                    for n, (dims, data) in variables.items():
                        for d, size in zip(dims, data.shape):
                            if d not in f._dims:
                                f.create_dim(d, size)
                        f.create_var(n, dims, data, _var_attrs(n))
                    f.set_attrs(attrs)
            self.paths.append(path)

    def wait(self) -> int:
        return self._async.wait() if self._async is not None else 0


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


def _write_native(f, name: str, arr: np.ndarray):
    """A restart variable in its native dtype on dims named
    ``d{size}_{axis}`` (the JAX package's restart layout)."""
    dims = tuple(f"d{arr.shape[i]}_{i}" for i in range(arr.ndim))
    for d, size in zip(dims, arr.shape):
        if d not in f._dims:
            f.create_dim(d, size)
    f.create_var(name, dims, arr)


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
            if n != "__time__":
                _write_native(f, n, np.asarray(arr))
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


def write_restart_sharded(prefix: str, model, time_seconds: float
                          ) -> List[str]:
    """Per-shard restart files (icar_tpu/io/output.py
    write_restart_sharded; the reference's per-image restarts,
    restart.f90:12-89): each shard writes
    ``{prefix}img{sid:03d}_{t:08d}.nc`` holding its piece of the JAX
    package's edge-padded frame of every restart field
    (``Layout.frame_piece``, from its own block; the linear-theory
    perturbations, kept whole, as ``__u_perturbation__`` and
    ``__v_perturbation__``) in its native dtype, on dims named
    ``d{size}_{axis}``, with ``restart_time_seconds``, ``y_start``,
    ``x_start``, ``shard_id`` and ``source``. Without a mesh one file
    holds the whole domain's natural fields, as the JAX package's one
    device writes them. The JAX package reads these files on a mesh of
    the same decomposition, and ``read_restart_sharded`` reads its.
    Returns the paths written."""
    from ..core.state import restart_names

    lay = model.layout
    names = [n for n in restart_names(model.options) if n in model._held()]
    whole = {}
    if model.u_perturbation is not None:
        whole = {"__u_perturbation__": model.u_perturbation,
                 "__v_perturbation__": model.v_perturbation}
    paths = []
    for b, (sid, (y0, x0), shard) in enumerate(_shards(model)):
        if shard is None:
            arrays = {n: model.state[n].cpu().numpy() for n in names}
            arrays.update({n: a.cpu().numpy() for n, a in whole.items()})
        else:
            arrays = {n: lay.frame_piece(model.blocks[b][n], shard)
                      for n in names}
            arrays.update({n: lay.frame_piece(lay.block_of(a, shard), shard)
                           for n, a in whole.items()})
        path = f"{prefix}img{sid:03d}_{int(time_seconds):08d}.nc"
        with NCFile(path, "w") as f:
            for n, arr in arrays.items():
                _write_native(f, n, arr)
            f.set_attrs({"restart_time_seconds": float(time_seconds),
                         "y_start": int(y0), "x_start": int(x0),
                         "shard_id": int(sid), "source": SOURCE})
        paths.append(path)
    return paths


def read_restart_sharded(paths: Sequence[str], model) -> float:
    """Resume ``model`` from per-shard restart files of its own
    decomposition (``write_restart_sharded``'s, or the JAX package's on a
    mesh of the same shape: icar_tpu/io/output.py read_restart_sharded).
    Each field is assembled on the host from the shards' pieces of the
    padded frame, cut to the natural domain and installed
    (``ICARModel._install``: scattered into the blocks); the port runs on
    one card, so placing each piece straight on its device without a
    domain-wide array waits for one shard per card. A field the files do
    not hold keeps its value. Raises ValueError when a shard's piece does
    not match the model's decomposition: aggregate the files and use
    ``read_restart``. Returns the restart time in seconds since run
    start."""
    by_sid = {}
    t = None
    for p in paths:
        with NCFile(p) as f:
            sid = int(f.read_attr(None, "shard_id"))
            by_sid[sid] = {n: f.read(n) for n in f.variables()}
            t = float(f.read_attr(None, "restart_time_seconds"))
    present = next(iter(by_sid.values()))
    if model.mesh is not None:
        nyp, nxp = model.layout.frame
        my, mx = model.mesh.shape
        piece_yx = (nyp // my, nxp // mx)
    s = model._global_state()
    targets = dict(s)
    if model.u_perturbation is not None:
        targets["__u_perturbation__"] = model.u_perturbation
        targets["__v_perturbation__"] = model.v_perturbation
    for n, cur in targets.items():
        if n not in present:
            continue
        natural = tuple(cur.shape)
        frame = None
        for sid, (y0, x0), _ in _shards(model):
            piece = by_sid.get(sid, {}).get(n)
            want = (natural if model.mesh is None
                    else natural[:-2] + piece_yx)
            if piece is None or tuple(piece.shape) != want:
                raise ValueError(
                    f"restart shard for {n} does not match the current "
                    f"mesh decomposition; aggregate the checkpoint files "
                    f"and use read_restart instead")
            if model.mesh is None:
                frame = piece
            else:
                if frame is None:
                    frame = np.empty(natural[:-2] + (nyp, nxp), piece.dtype)
                frame[..., y0:y0 + want[-2], x0:x0 + want[-1]] = piece
        arr = model._tensor(frame[..., :natural[-2], :natural[-1]])
        if n == "__u_perturbation__":
            model.u_perturbation = arr
        elif n == "__v_perturbation__":
            model.v_perturbation = arr
        else:
            s[n] = arr
    model._install(s)
    model.model_time = t
    return t

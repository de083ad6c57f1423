"""NetCDF file IO with the interface of icar_tpu/io/netcdf.py, in two
formats.

NetCDF-4 files are HDF5 files and go through h5py, as in the JAX package.
NetCDF classic files (CDF-1 and CDF-2, the format of the reference's
NetCDF library and of ``csrc/ncwriter.cpp``) go through
``scipy.io.netcdf_file``, which numpy and scipy alone provide. A file is
read in the format its first bytes name; a new file is written as
NetCDF-4 where h5py is importable and as CDF-2 where it is not. The
classic format has one unlimited (record) dimension, which comes first in
each variable that uses it, and no unsigned or 64-bit integer types:
integers are written as int32 there, Python floats as float64.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import h5py
except ImportError:  # optional: classic files need only scipy
    h5py = None

HDF5_MAGIC = b"\x89HDF"
CLASSIC_MAGIC = (b"CDF\x01", b"CDF\x02")


def file_format(path: str) -> str:
    """"netcdf4" or "classic", from the file's first bytes."""
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head == HDF5_MAGIC:
        return "netcdf4"
    if head in CLASSIC_MAGIC:
        return "classic"
    raise ValueError(f"{path}: not a NetCDF-4 or NetCDF classic (CDF-1/2) "
                     f"file (first bytes {head!r})")


def write_format() -> str:
    """The format a new file is written in here."""
    return "netcdf4" if h5py is not None else "classic"


def _native(a) -> np.ndarray:
    """A copy of ``a`` in native byte order (scipy keeps the file's
    big-endian order; torch takes only native arrays)."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="), copy=True)


def _classic_array(a) -> np.ndarray:
    """``a`` in a type the classic format holds: int8, int16, int32,
    float32 and float64 as they are, other integers as int32, other floats
    as float64."""
    a = np.asarray(a)
    if a.dtype.char in "bhifd":
        return a
    if a.dtype.kind in "biu":
        if a.size and (a.max() > np.iinfo(np.int32).max
                       or a.min() < np.iinfo(np.int32).min):
            raise ValueError("integers beyond int32 do not fit a NetCDF "
                             "classic file")
        return a.astype(np.int32)
    return a.astype(np.float64)


def _classic_attr(v):
    """An attribute value for the classic format: text as is, Python
    floats as float64, integers as int32, arrays as ``_classic_array``."""
    if isinstance(v, (str, bytes)):
        return v
    if isinstance(v, (bool, np.bool_)):
        return np.int32(v)
    if isinstance(v, float):
        return np.float64(v)
    if isinstance(v, int):
        return np.int32(v)
    return _classic_array(v)


class NCFile:
    """A NetCDF file handle (NetCDF-4 through h5py, classic through
    scipy). Arrays read are copies that outlive the file."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._dims: Dict[str, int] = {}
        self.format = write_format() if mode == "w" else file_format(path)
        if self.format == "netcdf4":
            if h5py is None:
                raise RuntimeError(f"{path} is a NetCDF-4 (HDF5) file, and "
                                   "reading it needs h5py, which is not "
                                   "installed")
            self.f = h5py.File(path, mode)
            if mode == "r":
                for name, ds in self.f.items():
                    if (isinstance(ds, h5py.Dataset)
                            and ds.attrs.get("CLASS") == b"DIMENSION_SCALE"):
                        self._dims[name] = ds.shape[0]
        else:
            from scipy.io import netcdf_file
            # reading maps the file, and ``read`` copies out only what it
            # returns (the views go with the file at close); appending
            # loads the file and writes it anew at close
            self.f = netcdf_file(path, mode, mmap=(mode == "r"), version=2)
            for name, size in self.f.dimensions.items():
                self._dims[name] = self.f._recs if size is None else size

    @property
    def classic(self) -> bool:
        return self.format == "classic"

    # -- writing -----------------------------------------------------------
    def create_dim(self, name: str, size: int, unlimited: bool = False):
        if self.classic:
            if name in self.f.dimensions:
                return
            if name in self.f.variables:
                raise ValueError(
                    f"dimension name {name!r} collides with an existing "
                    "variable in the file")
            self.f.createDimension(name, None if unlimited else size)
            self._dims[name] = 0 if unlimited else size
            return
        if name in self.f:
            ds = self.f[name]
            if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                self._dims[name] = ds.shape[0]
                return
            raise ValueError(
                f"dimension name {name!r} collides with an existing "
                "variable in the file")
        maxshape = (None,) if unlimited else (size,)
        ds = self.f.create_dataset(name, shape=(size,), maxshape=maxshape,
                                   dtype="f8")
        ds[...] = np.arange(size, dtype=np.float64)
        ds.make_scale(name)
        ds.attrs["axis_placeholder"] = 1
        self._dims[name] = size

    def create_var(self, name: str, dims: Sequence[str], data: np.ndarray,
                   attrs: Optional[Dict] = None, dtype=None):
        data = np.asarray(data)
        for d, n in zip(dims, data.shape):
            if d not in self._dims:
                self.create_dim(d, n, unlimited=(d == "time"))
        if self.classic:
            return self._create_classic(name, dims, data, attrs, dtype)
        if len(dims) == 1 and name == dims[0]:
            # coordinate variable: store values in the dimension-scale
            # dataset itself (netCDF convention) instead of a new dataset
            ds = self.f[name]
            if ds.shape[0] != data.shape[0]:
                ds.resize((data.shape[0],))
            ds[...] = data
            ds.attrs.pop("axis_placeholder", None)
            if attrs:
                for k, v in attrs.items():
                    ds.attrs[k] = v
            return ds
        maxshape = tuple(None if d == "time" else self._dims[d] for d in dims)
        ds = self.f.create_dataset(name, data=data, maxshape=maxshape,
                                   dtype=dtype or data.dtype,
                                   compression=None)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self.f[d])
        if attrs:
            for k, v in attrs.items():
                ds.attrs[k] = v
        return ds

    def _create_classic(self, name, dims, data, attrs, dtype):
        data = _classic_array(data if dtype is None else data.astype(dtype))
        var = self.f.createVariable(name, data.dtype, tuple(dims))
        if var.isrec:
            var[:data.shape[0]] = data
            self._dims[dims[0]] = max(self._dims[dims[0]], data.shape[0])
        elif data.ndim == 0:
            var.assignValue(data)
        else:
            var[:] = data
        for k, v in (attrs or {}).items():
            setattr(var, k, _classic_attr(v))
        return var

    def append_time_slice(self, name: str, data: np.ndarray):
        """Grow a variable (and the time scale) along its first dim."""
        if self.classic:
            var = self.f.variables[name]
            n = var.shape[0]
            var[n] = _classic_array(data).astype(var.data.dtype)
            self._dims["time"] = max(self._dims.get("time", 0), n + 1)
            return
        ds = self.f[name]
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        ds[n] = data
        tdim = self.f["time"]
        if tdim.shape[0] < n + 1:
            tdim.resize(n + 1, axis=0)
            tdim[n] = n
        self._dims["time"] = max(self._dims.get("time", 0), n + 1)

    def set_attrs(self, attrs: Dict):
        for k, v in attrs.items():
            if self.classic:
                setattr(self.f, k, _classic_attr(v))
            else:
                self.f.attrs[k] = v

    # -- reading -----------------------------------------------------------
    def variables(self) -> List[str]:
        if self.classic:
            return list(self.f.variables)
        out = []
        for name, ds in self.f.items():
            if isinstance(ds, h5py.Dataset) and (
                    ds.attrs.get("CLASS") != b"DIMENSION_SCALE"
                    or "axis_placeholder" not in ds.attrs):
                out.append(name)   # plain var, or coordinate variable
        return out

    def has_var(self, name: str) -> bool:
        if self.classic:
            return name in self.f.variables
        return name in self.f and isinstance(self.f[name], h5py.Dataset)

    def read(self, name: str, step: Optional[int] = None) -> np.ndarray:
        if self.classic:
            data = self.f.variables[name].data
            return _native(data if step is None else data[step])
        ds = self.f[name]
        if step is None:
            return np.asarray(ds)
        return np.asarray(ds[step])

    def _attrs(self, var: Optional[str]):
        if self.classic:
            src = self.f if var is None else self.f.variables[var]
            return src._attributes
        return self.f.attrs if var is None else self.f[var].attrs

    def attr_names(self, var: Optional[str] = None) -> List[str]:
        return list(self._attrs(var).keys())

    def read_attr(self, var: Optional[str], name: str):
        v = self._attrs(var)[name]
        if isinstance(v, bytes):
            return v.decode()
        return v

    def var_shape(self, name: str):
        if self.classic:
            return tuple(self.f.variables[name].shape)
        return tuple(self.f[name].shape)

    def n_times(self, name: str = None) -> int:
        if name is not None and self.has_var(name):
            return self.var_shape(name)[0]
        if "time" in self._dims:
            return self._dims["time"]
        return 1

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_var(path: str, name: str, step: Optional[int] = None) -> np.ndarray:
    """One-shot read (io_read, io_routines.f90:30-66)."""
    with NCFile(path) as f:
        return f.read(name, step)


def write_vars(path: str, variables: Dict[str, tuple], attrs: Dict = None):
    """One-shot write: variables = {name: (dims, data[, var_attrs])}."""
    with NCFile(path, "w") as f:
        for name, spec in variables.items():
            dims, data = spec[0], spec[1]
            vattrs = spec[2] if len(spec) > 2 else None
            f.create_var(name, dims, data, vattrs)
        if attrs:
            f.set_attrs(attrs)

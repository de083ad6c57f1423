"""Python binding of the native asynchronous NetCDF-classic writer
(icar_tpu/io/async_writer.py).

``csrc/ncwriter.cpp`` (a copy of the JAX package's ``csrc/ncwriter.cpp``)
is compiled with g++ at first use into ``icar_tpu_torch/_build/``, under a
name that carries a hash of the source and flags, and driven through
ctypes. Its worker thread serializes output snapshots to CDF-2 files while
the model keeps stepping. The JAX package's own ``csrc/libncwriter.so`` is
never read or written here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SRC_PATH = Path(__file__).resolve().parent.parent / "csrc" / "ncwriter.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None


def library_path() -> Path:
    """Where the library built from the present source lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return BUILD_DIR / f"libncwriter_{h.hexdigest()[:16]}.so"


def _build_lib(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(_SRC_PATH), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, path)


def load_library():
    """Load (building if needed) the native writer library."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build_lib(path)
    lib = ctypes.CDLL(str(path))
    lib.ncw_start.restype = ctypes.c_void_p
    lib.ncw_write_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.ncw_write_file.restype = None
    lib.ncw_wait.argtypes = [ctypes.c_void_p]
    lib.ncw_wait.restype = ctypes.c_int
    lib.ncw_files_written.argtypes = [ctypes.c_void_p]
    lib.ncw_files_written.restype = ctypes.c_int
    lib.ncw_stop.argtypes = [ctypes.c_void_p]
    lib.ncw_stop.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


class AsyncNCWriter:
    """Queue NetCDF-classic file writes onto the native worker thread.

    Usage:
        w = AsyncNCWriter()
        w.write("out.nc", {"theta": (("lev","lat","lon"), arr)}, attrs=...)
        ...
        w.close()     # drains the queue
    """

    def __init__(self):
        self._lib = load_library()
        self._ctx = self._lib.ncw_start()

    def write(self, path: str,
              variables: Dict[str, Tuple[Sequence[str], np.ndarray]],
              attrs: Optional[Dict[str, str]] = None):
        dims: List[Tuple[str, int]] = []
        dim_index: Dict[str, int] = {}
        var_names: List[bytes] = []
        var_ndims: List[int] = []
        var_dimids: List[int] = []
        arrays: List[np.ndarray] = []
        for name, (dnames, arr) in variables.items():
            arr = np.ascontiguousarray(arr, np.float32)
            if len(dnames) != arr.ndim:
                raise ValueError(f"{name}: {len(dnames)} dims for rank-{arr.ndim}")
            for dn, size in zip(dnames, arr.shape):
                if dn not in dim_index:
                    dim_index[dn] = len(dims)
                    dims.append((dn, int(size)))
                elif dims[dim_index[dn]][1] != size:
                    raise ValueError(
                        f"dimension {dn}: size {size} vs {dims[dim_index[dn]][1]}")
                var_dimids.append(dim_index[dn])
            var_names.append(name.encode())
            var_ndims.append(arr.ndim)
            arrays.append(arr)

        attrs = attrs or {}
        c_dim_names = (ctypes.c_char_p * len(dims))(*[d[0].encode() for d in dims])
        c_dim_sizes = (ctypes.c_int * len(dims))(*[d[1] for d in dims])
        c_ga_names = (ctypes.c_char_p * max(len(attrs), 1))(
            *[k.encode() for k in attrs])
        c_ga_vals = (ctypes.c_char_p * max(len(attrs), 1))(
            *[str(v).encode() for v in attrs.values()])
        c_var_names = (ctypes.c_char_p * len(arrays))(*var_names)
        c_var_ndims = (ctypes.c_int * len(arrays))(*var_ndims)
        c_var_dimids = (ctypes.c_int * max(len(var_dimids), 1))(*var_dimids)
        c_data = (ctypes.POINTER(ctypes.c_float) * len(arrays))(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrays])

        # the native side copies the arrays before this call returns
        self._lib.ncw_write_file(
            self._ctx, path.encode(),
            len(dims), c_dim_names, c_dim_sizes,
            len(attrs), c_ga_names, c_ga_vals,
            len(arrays), c_var_names, c_var_ndims, c_var_dimids, c_data)

    def wait(self) -> int:
        """Drain the queue; returns the number of failed writes."""
        return self._lib.ncw_wait(self._ctx)

    def files_written(self) -> int:
        return self._lib.ncw_files_written(self._ctx)

    def close(self):
        if self._ctx is not None:
            self._lib.ncw_wait(self._ctx)
            self._lib.ncw_stop(self._ctx)
            self._ctx = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

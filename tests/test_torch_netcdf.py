"""The port's NetCDF layer (icar_tpu_torch/io) against the JAX package's.

``io/netcdf.NCFile`` reads NetCDF-4 (h5py) and NetCDF classic (scipy)
files by their first bytes, and writes NetCDF-4 where h5py is importable
and CDF-2 where it is not (the machine with the card has no h5py): each
case runs in both formats, the classic one with the module's h5py made
absent. The native writer (``io/async_writer.py``) builds its own copy of
``csrc/ncwriter.cpp`` into ``icar_tpu_torch/_build/`` and leaves the JAX
package's ``csrc/libncwriter.so`` as it is.
"""

import hashlib
import os
import warnings

import numpy as np
import pytest

import icar_tpu_torch.io.netcdf as tnc
from icar_tpu.io.netcdf import NCFile as JaxNCFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = {"netcdf4": b"\x89HDF", "classic": b"CDF\x02"}


@pytest.fixture(params=["netcdf4", "classic"])
def fmt(request, monkeypatch):
    """The format new files are written in: classic with h5py absent."""
    if request.param == "classic":
        monkeypatch.setattr(tnc, "h5py", None)
    assert tnc.write_format() == request.param
    return request.param


def _magic(path):
    with open(path, "rb") as f:
        return f.read(4)


def test_roundtrip(tmp_path, fmt):
    """Variables, attributes of the file and of a variable, and one step
    of a variable read back equal, in the format the first bytes name;
    arrays come back as native-order copies that outlive the file (no
    warning at close)."""
    path = str(tmp_path / "t.nc")
    rng = np.random.default_rng(0)
    a = rng.random((3, 4, 5)).astype(np.float32)
    b = rng.random((4, 5))
    tnc.write_vars(path, {"field": (("lev", "lat", "lon"), a, {"units": "m"}),
                          "wide": (("lat", "lon"), b)},
                   attrs={"title": "test", "dx": 1000.0, "nx": 5})
    assert _magic(path) == MAGIC[fmt]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tnc.NCFile(path) as f:
            assert f.format == fmt
            assert sorted(f.variables()) == ["field", "wide"]
            assert f.has_var("field") and not f.has_var("lev_x")
            got = f.read("field")
            assert f.var_shape("field") == (3, 4, 5)
            assert f.read_attr("field", "units") == "m"
            assert f.read_attr(None, "title") == "test"
            assert f.read_attr(None, "dx") == 1000.0
            assert f.read_attr(None, "nx") == 5
            wide = f.read("wide")
    assert got.dtype == np.float32 and got.dtype.isnative
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(wide, b)       # float64 kept
    got[0] = 0.0                                 # a writable copy
    np.testing.assert_array_equal(tnc.read_var(path, "field", step=1), a[1])


def test_record_dimension_append(tmp_path, fmt):
    """The output writer's pattern: a record (time) dimension created
    empty, a first slice written with the variable, then slices appended
    in later openings of the file."""
    path = str(tmp_path / "t.nc")
    with tnc.NCFile(path, "w") as f:
        f.create_dim("time", 0, unlimited=True)
        f.create_var("q", ("time", "lat", "lon"),
                     np.zeros((1, 3, 3), np.float32), {"units": "K"})
        f.create_var("model_time", ("time",), np.asarray([0.0], np.float64))
    for i in (1, 2):
        with tnc.NCFile(path, "a") as f:
            f.append_time_slice("q", np.full((3, 3), i, np.float32))
            f.append_time_slice("model_time", np.float64(1800.0 * i))
    with tnc.NCFile(path) as f:
        q = f.read("q")
        assert q.shape == (3, 3, 3) and f.n_times("q") == 3
        np.testing.assert_array_equal(q.mean(axis=(1, 2)), [0.0, 1.0, 2.0])
        np.testing.assert_array_equal(f.read("model_time"),
                                      [0.0, 1800.0, 3600.0])
        assert f.read_attr("q", "units") == "K"
        np.testing.assert_array_equal(f.read("q", step=2), 2.0)


def test_layout_the_tools_write(tmp_path, fmt):
    """What the tools write: a 2D field before the time series (the
    record dimension made after another one), a scalar beside record
    variables, and coordinate variables; each reads back equal, the
    coordinates as float64 in both formats (the NetCDF-4 layout keeps
    them in the dimension's float64 scale), the record dimension sized by
    the series."""
    path = str(tmp_path / "t.nc")
    rng = np.random.default_rng(3)
    lat = rng.random((4, 5)).astype(np.float32)
    series = rng.random((3, 2, 4, 5)).astype(np.float32)
    tnc.write_vars(path, {
        "lat": (("y", "x"), lat),
        "theta": (("time", "level", "y", "x"), series),
        "P0": ((), np.float32(1e5)),
        "level": (("level",), np.arange(2, dtype=np.int32)),
        "time": (("time",), np.float32([0.0, 1.0, 2.0]))})
    with tnc.NCFile(path) as f:
        assert f.format == fmt
        np.testing.assert_array_equal(f.read("lat"), lat)
        np.testing.assert_array_equal(f.read("theta"), series)
        assert f.read("P0") == np.float32(1e5)
        for n, want in (("level", [0.0, 1.0]), ("time", [0.0, 1.0, 2.0])):
            got = f.read(n)
            assert got.dtype == np.float64 and list(got) == want, n
        assert f.n_times() == 3
        assert f.var_dims("theta") == ("time", "level", "y", "x")
        assert f.var_dims("level") == ("level",)


def test_classic_types(tmp_path, monkeypatch):
    """The classic format holds no 64-bit or unsigned integers: they are
    written as int32 (bool as int8); Python floats as float64."""
    monkeypatch.setattr(tnc, "h5py", None)
    path = str(tmp_path / "t.nc")
    tnc.write_vars(path, {"i": (("n",), np.arange(4, dtype=np.int64)),
                          "b": (("n",), np.array([1, 0, 1, 1], bool))},
                   attrs={"t": 1800.5, "flag": True})
    with tnc.NCFile(path) as f:
        assert f.read("i").dtype == np.int32
        np.testing.assert_array_equal(f.read("i"), np.arange(4))
        np.testing.assert_array_equal(f.read("b"), [1, 0, 1, 1])
        assert f.read_attr(None, "t") == 1800.5
        assert f.read_attr(None, "flag") == 1
    with pytest.raises(ValueError, match="int32"):
        tnc.write_vars(path, {"i": (("n",), np.array([2 ** 40]))})


def test_reads_files_the_jax_package_wrote(tmp_path):
    """A NetCDF-4 file the JAX package's NCFile wrote reads alike through
    the port (a coordinate variable, a record dimension, attributes)."""
    path = str(tmp_path / "j.nc")
    rng = np.random.default_rng(1)
    a = rng.random((2, 3, 4)).astype(np.float32)
    with JaxNCFile(path, "w") as f:
        f.create_dim("time", 0, unlimited=True)
        f.create_var("theta", ("time", "lat", "lon"), a[:1], {"units": "K"})
        f.create_var("lat", ("lat",), np.arange(3.0))
        f.set_attrs({"dx": 500.0, "source": "jax"})
    with JaxNCFile(path, "a") as f:
        f.append_time_slice("theta", a[1])
    with tnc.NCFile(path) as f, JaxNCFile(path) as g:
        assert sorted(f.variables()) == sorted(g.variables())
        for n in g.variables():
            np.testing.assert_array_equal(f.read(n), g.read(n))
        assert f.n_times("theta") == g.n_times("theta") == 2
        assert f.read_attr(None, "source") == "jax"
        assert f.read_attr(None, "dx") == 500.0
        assert f.read_attr("theta", "units") == "K"


def test_netcdf4_without_h5py_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "n4.nc")
    tnc.write_vars(path, {"x": (("n",), np.zeros(3, np.float32))})
    monkeypatch.setattr(tnc, "h5py", None)
    with pytest.raises(RuntimeError, match="n4.nc.*h5py"):
        tnc.NCFile(path)
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"nope" * 4)
    with pytest.raises(ValueError, match="bad.nc"):
        tnc.NCFile(str(bad))


def _stamp(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest(), os.path.getmtime(path)


def _without_header(path):
    """The C++ source without its leading comment block."""
    lines = open(path).read().splitlines()
    while lines[0].startswith("//") or not lines[0].strip():
        lines.pop(0)
    return lines


def test_native_writer_builds_its_own_copy(tmp_path):
    """The port's native writer builds icar_tpu_torch/csrc/ncwriter.cpp (the
    JAX package's source apart from its header comment) into
    icar_tpu_torch/_build/, writes a CDF-2 file that reads back equal,
    and leaves csrc/libncwriter.so untouched."""
    from icar_tpu_torch.io import async_writer as aw
    jax_lib = os.path.join(REPO, "csrc", "libncwriter.so")
    before = _stamp(jax_lib) if os.path.exists(jax_lib) else None
    assert _without_header(os.path.join(REPO, "icar_tpu_torch", "csrc",
                                        "ncwriter.cpp")) == \
        _without_header(os.path.join(REPO, "csrc", "ncwriter.cpp"))
    if not aw.available():
        pytest.skip("no g++ to build the native writer")
    lib = aw.library_path()
    assert lib.parent == aw.BUILD_DIR and lib.exists()
    assert aw.BUILD_DIR.parent.name == "icar_tpu_torch"
    w = aw.AsyncNCWriter()
    a = np.random.default_rng(2).random((3, 5, 7)).astype(np.float32)
    path = str(tmp_path / "native.nc")
    w.write(path, {"theta": (("lev", "lat", "lon"), a)},
            attrs={"title": "t"})
    assert w.wait() == 0 and w.files_written() == 1
    w.close()
    assert _magic(path) == MAGIC["classic"]
    with tnc.NCFile(path) as f:
        np.testing.assert_array_equal(f.read("theta"), a)
        assert f.read_attr(None, "title") == "t"
    assert (_stamp(jax_lib) if before else None) == before

"""The port's user tooling (``icar_tpu_torch/tools/``) against the JAX
package's tools (``tools/``), on the same files, on the CPU.

Every input is made with numpy from a seed. Each JAX tool runs in process,
imported from ``tools/`` as ``tests/test_tools.py`` does, and the port's
tool on the same NetCDF-4 files: every variable's array equal bit for bit
with its dtype, the dimensions and the global attributes. The dtype is
compared in native byte order: the JAX tool keeps a classic input's
big-endian order in its NetCDF-4 output, where the port's ``NCFile``
reads every array in native order. Then the port's tools run again with
h5py made absent (the port machine's condition) on CDF-2 copies of the
inputs: their CDF-2 outputs hold the same arrays (CDF-2 stores 64-bit
integers as int32). No JAX model is built: the JAX tools are numpy and
h5py.
"""

import ast
import contextlib
import copy
import glob
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icar_tpu_torch.io import netcdf as tnc
from icar_tpu_torch.io.netcdf import NCFile, write_vars

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

TOOLS = ("aggregate_output", "extract_daily_precip", "setup_next_run",
         "fix_time", "make_domain", "wrf2icar", "reanalysis2icar",
         "get_merra", "plot_icar")


def jax_tool(name):
    """The JAX package's tool ``tools/{name}.py``."""
    return importlib.import_module(name)


def port_tool(name):
    return importlib.import_module(f"icar_tpu_torch.tools.{name}")


def run_jax_main(monkeypatch, name, argv):
    """The JAX tool's ``main`` on ``argv`` (through ``sys.argv`` where its
    ``main`` takes no arguments); returns (its result, its stdout)."""
    import inspect
    main = jax_tool(name).main
    out = io.StringIO()
    with monkeypatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [name] + list(argv))
        if inspect.signature(main).parameters:
            rc = main(list(argv))
        else:
            rc = main()
    return rc, out.getvalue()


def run_port_main(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_tool(name).main(list(argv))
    return rc, out.getvalue()


def contents(path):
    """(format, {variable: array}, {dimension: size}, {attribute: value})
    of ``path``, read through the port's NCFile."""
    with NCFile(path) as f:
        return (f.format, {n: f.read(n) for n in f.variables()},
                dict(f._dims),
                {k: f.read_attr(None, k) for k in f.attr_names()})


def _native(dtype):
    return np.dtype(dtype).newbyteorder("=")


def assert_same_values(got, want, classic, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if classic and want.dtype.kind in "iu" and want.dtype.itemsize == 8:
        assert got.dtype == np.int32, what
    else:
        assert _native(got.dtype) == _native(want.dtype), what
    assert np.array_equal(got, want), what


def assert_same_file(got_path, want_path, classic=False):
    """The file ``got_path`` holds what ``want_path`` holds: every
    variable's array bit for bit, the dimensions and the global
    attributes; ``classic``: ``got_path`` is CDF-2 (``want_path`` NetCDF-4)."""
    fmt, gv, gd, ga = contents(got_path)
    wfmt, wv, wd, wa = contents(want_path)
    assert fmt == ("classic" if classic else wfmt)
    assert sorted(gv) == sorted(wv)
    for n in wv:
        assert_same_values(gv[n], wv[n], classic, n)
    assert gd == wd
    assert sorted(ga) == sorted(wa)
    for k in wa:
        assert_same_values(ga[k], wa[k], classic, k)


def both_formats(path, variables, attrs=None):
    """``variables`` written to ``path`` as NetCDF-4 and, under the same
    name in a directory ``cdf2`` beside it, as CDF-2; returns the two
    paths."""
    directory, name = os.path.split(path)
    os.makedirs(os.path.join(directory, "cdf2"), exist_ok=True)
    classic = os.path.join(directory, "cdf2", name)
    write_vars(path, variables, attrs, fmt="netcdf4")
    write_vars(classic, variables, attrs, fmt="classic")
    return path, classic


# -- aggregate_output ---------------------------------------------------------

@pytest.fixture(scope="module")
def ridge_runs():
    """The small case of tests/test_torch_sharded_io.py on the CPU: the
    unsharded model and a copy on its 2x2 mesh, each at 0 s and after one
    300 s interval, as (model, copy, [(t, snapshot of both)])."""
    from icar_tpu_torch.models.icar import ideal_ridge_model
    from icar_tpu_torch.parallel.mesh import Mesh
    from test_torch_sharded_io import GRID, MESH

    m = ideal_ridge_model(**GRID, device="cpu")
    s = copy.deepcopy(m)
    s.attach_mesh(Mesh(["cpu"] * 4, MESH))
    snaps = [(0.0, copy.deepcopy(m), copy.deepcopy(s))]
    m.advance(300.0)
    s.advance(300.0)
    snaps.append((300.0, m, s))
    return snaps


def write_shard_run(prefix, snaps, native):
    """The unsharded run's output (``OutputWriter``, ``{prefix}whole.nc``)
    and the sharded run's files per shard (``ShardedOutputWriter``: the
    native async CDF-2 writer when ``native``, else ``NCFile``); returns
    (whole path, shard paths)."""
    from icar_tpu_torch.io import async_writer
    from icar_tpu_torch.io import output as tout
    from test_torch_sharded_io import NAMES

    whole = tout.OutputWriter(prefix + "whole.nc", NAMES)
    available = async_writer.available
    if not native:
        async_writer.available = lambda: False
    try:
        shards = tout.ShardedOutputWriter(prefix + "out_", NAMES)
    finally:
        async_writer.available = available
    assert (shards._async is not None) == native
    for t, m, s in snaps:
        whole.write_step(m, t)
        shards.write_step(s, t)
    assert shards.wait() == 0
    return whole.path, shards.paths


@pytest.mark.parametrize("native", [False, True],
                         ids=["ncfile_shards", "async_cdf2_shards"])
def test_aggregate_shards(ridge_runs, tmp_path, monkeypatch, native):
    """Files per shard of a 2x2 run stitched by both tools: the same file
    (NetCDF-4), and each field at each time equal bit for bit to the
    unsharded run's output; with h5py absent the port writes CDF-2 with
    the same arrays."""
    if native:
        from icar_tpu_torch.io import async_writer
        if not async_writer.available():
            pytest.skip("the native writer does not build here (no g++)")
    prefix = str(tmp_path / "r_")
    whole, paths = write_shard_run(prefix, ridge_runs, native)
    assert len(paths) == 8
    pattern = prefix + "out_img*.nc"
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    assert run_jax_main(monkeypatch, "aggregate_output",
                        [pattern, "-o", jax_out])[0] == 0
    rc, said = run_port_main("aggregate_output", [pattern, "-o", port_out])
    assert rc == 0 and "2 steps from 8 shard files" in said
    assert_same_file(port_out, jax_out)

    _, stitched, dims, attrs = contents(port_out)
    _, want, _, _ = contents(whole)
    assert list(stitched["model_time"]) == [0.0, 300.0]
    for n, a in want.items():
        if n != "model_time":
            assert stitched[n].dtype == np.float32
            np.testing.assert_array_equal(stitched[n].view(np.uint32),
                                          a.view(np.uint32), err_msg=n)
    assert not {"y_start", "x_start", "shard_id"} & set(attrs)

    if native:
        # the native writer's shards are CDF-2: the port reads them and
        # writes CDF-2 with h5py absent
        classic_out = str(tmp_path / "port_cdf2.nc")
        with monkeypatch.context() as mp:
            mp.setattr(tnc, "h5py", None)
            assert run_port_main("aggregate_output",
                                 [pattern, "-o", classic_out])[0] == 0
        assert_same_file(classic_out, jax_out, classic=True)


def write_step_files(directory, seed=11):
    """Three per-step CDF-2 files of the "classic-async" engine (the
    native writer), a 2D and a 3D field each, seeded."""
    from icar_tpu_torch.io.async_writer import AsyncNCWriter
    rng = np.random.default_rng(seed)
    w = AsyncNCWriter()
    for t in (0.0, 600.0, 1200.0):
        w.write(os.path.join(directory, f"out_{int(t):08d}.nc"),
                {"precipitation": (("lat", "lon"), rng.random(
                    (4, 5), dtype=np.float32)),
                 "water_vapor": (("lev", "lat", "lon"), rng.random(
                     (3, 4, 5), dtype=np.float32))},
                {"model_time": str(t), "dx": "1000.0"})
    assert w.wait() == 0
    w.close()


def test_aggregate_steps(tmp_path, monkeypatch):
    """Per-step files concatenated along time by both tools: the same
    file; with h5py absent the port's CDF-2 holds the same arrays."""
    from icar_tpu_torch.io import async_writer
    if not async_writer.available():
        pytest.skip("the native writer does not build here (no g++)")
    write_step_files(str(tmp_path))
    pattern = str(tmp_path / "out_*.nc")
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    run_jax_main(monkeypatch, "aggregate_output", [pattern, "-o", jax_out])
    assert run_port_main("aggregate_output",
                         [pattern, "-o", port_out])[0] == 0
    assert_same_file(port_out, jax_out)
    _, v, dims, attrs = contents(port_out)
    assert list(v["model_time"]) == [0.0, 600.0, 1200.0]
    assert v["water_vapor"].shape == (3, 3, 4, 5)
    assert dims == {"time": 3, "lat": 4, "lon": 5, "lev": 3}
    assert attrs["model_time"] == "1200.0"
    with monkeypatch.context() as mp:
        mp.setattr(tnc, "h5py", None)
        classic_out = str(tmp_path / "port_cdf2.nc")
        assert run_port_main("aggregate_output",
                             [pattern, "-o", classic_out])[0] == 0
    assert_same_file(classic_out, jax_out, classic=True)


def test_aggregate_output_no_match(tmp_path):
    rc, _ = run_port_main("aggregate_output",
                          [str(tmp_path / "none_*.nc")])
    assert rc == 1


# -- fix_time -----------------------------------------------------------------

# a restart-overlapped axis: 0..5 h, then a restart at 3 h
OVERLAP = np.array([0, 3600, 7200, 10800, 14400, 18000,
                    10800, 14400, 18000, 21600], np.float64)


def write_overlapped(path, fmt):
    rng = np.random.default_rng(21)
    write_vars(path, {
        "model_time": (("time",), OVERLAP, {"units": "s"}),
        "precipitation": (("time", "y", "x"),
                          rng.random((10, 3, 4), dtype=np.float32)),
        "lat": (("y", "x"), rng.random((3, 4), dtype=np.float32))},
        attrs={"title": "overlapped", "nx": 4}, fmt=fmt)


@pytest.mark.parametrize("args", [[], ["--truncate"], ["--dt", "1800"]],
                         ids=["rewrite", "truncate", "dt"])
def test_fix_time(tmp_path, monkeypatch, args):
    """Both tools on a NetCDF-4 file give the same file; the port on a
    CDF-2 copy (in place, through a temporary file) gives the same
    arrays, dimensions and attributes, with h5py absent too."""
    src = str(tmp_path / "out.nc")
    write_overlapped(src, "netcdf4")
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    jax_tool("fix_time").main([src, "-o", jax_out] + args)
    port_tool("fix_time").main([src, "-o", port_out] + args)
    assert_same_file(port_out, jax_out)
    t = contents(jax_out)[1]["model_time"]
    assert (np.diff(t) > 0).all()
    for hide in (False, True):
        classic = str(tmp_path / f"out_cdf2_{hide}.nc")
        write_overlapped(classic, "classic")
        with monkeypatch.context() as mp:
            if hide:
                mp.setattr(tnc, "h5py", None)
            port_tool("fix_time").main([classic] + args)
        assert_same_file(classic, jax_out, classic=True)
        assert glob.glob(str(tmp_path / "tmp*")) == []


def test_fix_time_monotonic_axis_untouched(tmp_path, capsys):
    path = str(tmp_path / "ok.nc")
    write_vars(path, {"model_time": (("time",), np.arange(3.0) * 60)},
               fmt="classic")
    before = open(path, "rb").read()
    port_tool("fix_time").main([path])
    assert "already monotonic (3 frames)" in capsys.readouterr().out
    assert open(path, "rb").read() == before


# -- setup_next_run -----------------------------------------------------------

def chain_namelist(directory):
    nml = os.path.join(directory, "options.nml")
    with open(nml, "w") as f:
        f.write(f"""&model_version
    version = "2.1",
/
&parameters
    start_date = "2020-12-01 00:00:00",
    end_date = "2020-12-01 03:00:00",
    nz = 5,
    dz_levels = 200.0, 200.0, 200.0, 200.0, 200.0,
/
&output_list
    restart_file = "{directory}/rst_",
/
""")
    return nml


@pytest.mark.parametrize("layout", ["whole", "per_shard"])
def test_setup_next_run(tmp_path, monkeypatch, layout):
    """Both tools, each on its own copy of a run directory, with ``-s 1``:
    the same files removed, the same resume point and the same namelist.
    With restarts per shard the sorted glob puts the last shard's files
    last, so ``-s 1`` removes one shard's file of the newest checkpoint
    and leaves it with three of its four shards (a fault of the JAX tool,
    reproduced)."""
    dirs = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        for t in (3600, 7200):
            if layout == "whole":
                (d / f"rst_{t:08d}.nc").write_bytes(b"")
            else:
                for sid in range(4):
                    (d / f"rst_img{sid:03d}_{t:08d}.nc").write_bytes(b"")
        dirs[tag] = (str(d), chain_namelist(str(d)))
    rc_j, said_j = run_jax_main(monkeypatch, "setup_next_run",
                                [dirs["jax"][1], "-s", "1"])
    rc_p, said_p = run_port_main("setup_next_run",
                                 [dirs["port"][1], "-s", "1"])
    assert rc_j == rc_p == 0
    assert said_p == said_j.replace(dirs["jax"][0], dirs["port"][0])
    left = {tag: sorted(os.listdir(d)) for tag, (d, _) in dirs.items()}
    assert left["port"] == left["jax"]
    with open(dirs["jax"][1]) as fj, open(dirs["port"][1]) as fp:
        assert fp.read() == fj.read().replace(dirs["jax"][0],
                                              dirs["port"][0])
    from icar_tpu_torch.config import Options
    assert Options.from_namelist(dirs["port"][1]).run.restart is True
    if layout == "whole":
        assert "resume from" in said_p and "rst_00003600.nc" in said_p
        assert "rst_00007200.nc" not in left["port"]
    else:
        newest = [p for p in left["port"] if p.endswith("_00007200.nc")]
        assert newest == [f"rst_img{s:03d}_00007200.nc" for s in range(3)]
        assert said_p.splitlines()[1].endswith("rst_img003_00003600.nc")


def test_setup_next_run_refuses_without_checkpoints(tmp_path, capsys):
    assert port_tool("setup_next_run").main(
        [chain_namelist(str(tmp_path))]) == 1
    assert "no restart checkpoints match" in capsys.readouterr().err


# -- wrf2icar -----------------------------------------------------------------

def forcing_options(pkg, path, names):
    o = pkg.Options()
    o.forcing.boundary_files = [path]
    o.forcing.var_names.update(names)
    return o


WRF_NAMES = {"p": "pressure", "t": "theta", "qv": "qv", "u": "u", "v": "v",
             "z": "z", "lat": "lat", "lon": "lon", "hgt": "hgt",
             "sst": "tsk", "swdown": "swdown", "lwdown": "glw"}


@pytest.mark.parametrize("classic", [False, True],
                         ids=["netcdf4_wrfout", "classic_wrfout"])
def test_wrf2icar(tmp_path, monkeypatch, classic):
    """A wrfout of either format converted by both tools: the same file;
    with h5py absent the port converts a classic wrfout to CDF-2 with the
    same arrays; each output read by the port's ForcingData gives the JAX
    ForcingData's steps."""
    import icar_tpu.config as jc
    import icar_tpu_torch.config as tc
    from icar_tpu.forcing.boundary import ForcingData as JaxForcing
    from icar_tpu_torch.forcing.boundary import ForcingData
    from test_tools import _write_synthetic_wrfout

    src = str(tmp_path / "wrfout.nc")
    _write_synthetic_wrfout(src, classic=classic)
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    jax_tool("wrf2icar").convert([src], jax_out, verbose=False)
    rc, said = run_port_main("wrf2icar", [src, "-o", port_out])
    assert rc == 0 and 'forcing_start_date = "2010-06-01 00:00:00"' in said
    assert_same_file(port_out, jax_out)
    outs = [port_out]
    if classic:
        cdf2_out = str(tmp_path / "port_cdf2.nc")
        with monkeypatch.context() as mp:
            mp.setattr(tnc, "h5py", None)
            assert run_port_main("wrf2icar",
                                 [src, "-o", cdf2_out, "-q"])[0] == 0
        assert_same_file(cdf2_out, jax_out, classic=True)
        outs.append(cdf2_out)
    want = JaxForcing(forcing_options(jc, jax_out, WRF_NAMES))
    for out in outs:
        fd = ForcingData(forcing_options(tc, out, WRF_NAMES))
        assert fd.n_steps() == want.n_steps() == 2
        for i in range(2):
            got, ref = fd.read_step(i), want.read_step(i)
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- reanalysis2icar ----------------------------------------------------------

NT, NZ, NY, NX = 2, 4, 5, 6


def reanalysis_input(preset):
    """A seeded input in the layout and names of ``preset``:
    {name: (dims, array)}."""
    from icar_tpu_torch.tools.reanalysis2icar import PRESETS

    names = PRESETS[preset]
    rng = np.random.default_rng(sorted(PRESETS).index(preset))
    lev_d = "lev"
    dims4 = ("time", lev_d, "lat", "lon")
    shape4 = (NT, NZ, NY, NX)
    top_down = np.array([25000.0, 50000.0, 70000.0, 85000.0])
    lat = np.linspace(45, 40, NY)          # descending, as ERA5 stores it
    v = {names["lat"]: (("lat",), lat.astype(np.float32)),
         names["lon"]: (("lon",), np.linspace(250, 256, NX).astype(
             np.float32))}

    def field(lo, hi):
        return (lo + (hi - lo) * rng.random(shape4)).astype(np.float32)

    v[names["t"]] = (dims4, field(220.0, 290.0))
    v[names["q"]] = (dims4, field(1e-4, 8e-3))
    v[names["u"]] = (dims4, field(-10.0, 20.0))
    v[names["v"]] = (dims4, field(-10.0, 10.0))
    z = np.broadcast_to(np.array([10000.0, 5500, 3000, 1500])[None, :, None,
                                                                 None],
                        shape4) + field(0.0, 50.0)
    geometric = names.get("z_is_height", False)
    v[names["z"]] = (dims4, (z if geometric else 9.81 * z).astype(
        np.float32))
    if "lev" in names:
        plev = top_down / (100.0 if preset == "era5" else 1.0)
        v[names["lev"]] = ((lev_d,), plev.astype(np.float32))
    elif "p3d" in names:
        v[names["p3d"]] = (dims4, np.broadcast_to(
            top_down[None, :, None, None], shape4).astype(np.float32))
    else:
        hyam = np.array([0.2, 0.15, 0.05, 0.0])
        hybm = np.array([0.05, 0.35, 0.65, 0.85])
        p00 = 1.0 if preset == "erai" else 100000.0
        v[names["hyam"]] = ((lev_d,), (hyam * 100000.0 / p00).astype(
            np.float32))
        v[names["hybm"]] = ((lev_d,), hybm.astype(np.float32))
        v[names["p00"]] = ((), np.float32(p00))
        ps = 98000.0 + 3000.0 * rng.random((NT, 1, NY, NX))
        if names.get("ps_is_log"):
            v[names["ps"]] = (("time", "one", "lat", "lon"),
                              np.log(ps).astype(np.float32))
        else:
            v[names["ps"]] = (("time", "lat", "lon"),
                              ps[:, 0].astype(np.float32))
    for key in ("sst", "swdown", "lwdown"):
        if key in names:
            v[names[key]] = (("time", "lat", "lon"),
                             (250 + 50 * rng.random((NT, NY, NX))).astype(
                                 np.float32))
    if "hgt" in names:
        v[names["hgt"]] = (("time", "lat", "lon"), (9.81 * 800 * rng.random(
            (NT, NY, NX))).astype(np.float32))
    return v


@pytest.mark.parametrize("preset", ["ccsm", "cesm", "cmip", "era5", "erai",
                                    "merra2"])
def test_reanalysis2icar_preset(tmp_path, monkeypatch, preset):
    """Each preset's input converted by both tools: the same file; with
    h5py absent the port converts the CDF-2 copy to CDF-2 with the same
    arrays."""
    src, classic = both_formats(str(tmp_path / "in.nc"),
                                reanalysis_input(preset))
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    argv = ["--preset", preset, "-q"]
    assert jax_tool("reanalysis2icar").main([src, "-o", jax_out]
                                            + argv) == 0
    assert run_port_main("reanalysis2icar",
                         [src, "-o", port_out] + argv)[0] == 0
    assert_same_file(port_out, jax_out)
    p = contents(jax_out)[1]["pressure"]
    assert (np.diff(p[0, :, 0, 0]) < 0).all()      # ascending z
    with monkeypatch.context() as mp:
        mp.setattr(tnc, "h5py", None)
        cdf2_out = str(tmp_path / "port_cdf2.nc")
        assert run_port_main("reanalysis2icar",
                             [classic, "-o", cdf2_out] + argv)[0] == 0
    assert_same_file(cdf2_out, jax_out, classic=True)


def test_reanalysis2icar_unpacks_only_classic_inputs(tmp_path):
    """A packed temperature (int16 with scale_factor and add_offset): both
    tools unpack it from a classic input and read the raw integers from a
    NetCDF-4 input (a fault of the JAX tool, reproduced)."""
    v = reanalysis_input("era5")
    packed = np.round((v["t"][1] - 250.0) / 0.01).astype(np.int16)
    v["t"] = (v["t"][0], packed, {"scale_factor": 0.01,
                                   "add_offset": 250.0})
    out = {}
    for fmt in ("netcdf4", "classic"):
        src = str(tmp_path / f"in_{fmt}.nc")
        write_vars(src, v, fmt=fmt)
        for tag, mod in (("jax", jax_tool("reanalysis2icar")),
                         ("port", port_tool("reanalysis2icar"))):
            path = str(tmp_path / f"{tag}_{fmt}.nc")
            assert mod.main([src, "-o", path, "--preset", "era5",
                             "-q"]) == 0
            out[tag, fmt] = contents(path)[1]["theta"]
        np.testing.assert_array_equal(out["port", fmt], out["jax", fmt])
    from icar_tpu_torch.tools.reanalysis2icar import ROVCP
    exner = (np.array([85000.0, 70000, 50000, 25000]) / 1e5)[
        None, :, None, None] ** ROVCP
    unpacked = packed.astype(np.float64) * 0.01 + 250.0
    np.testing.assert_allclose(out["port", "classic"],
                               unpacked[:, ::-1, ::-1] / exner, rtol=1e-6)
    # the NetCDF-4 input's raw integers, taken as kelvin
    np.testing.assert_allclose(out["port", "netcdf4"],
                               packed[:, ::-1, ::-1] / exner, rtol=1e-5)


# -- make_domain --------------------------------------------------------------

def dem_variables():
    rng = np.random.default_rng(31)
    ny, nx = 30, 40
    lat = np.linspace(38, 42, ny)
    lon = np.linspace(-109, -104, nx)
    lon2, lat2 = np.meshgrid(lon, lat)
    elev = 1500 + 800 * np.sin(lon2 * 3) * np.cos(lat2 * 2) \
        + 50 * rng.random((ny, nx))
    elev[:8, :] = 0.0                     # an ocean strip
    return {"elevation": (("lat", "lon"), elev.astype(np.float32)),
            "lat": (("lat",), lat.astype(np.float32)),
            "lon": (("lon",), lon.astype(np.float32))}


def test_make_domain(tmp_path, monkeypatch):
    """A DEM subset, coarsened and smoothed by both tools: the same
    domain file; with h5py absent the port's CDF-2 holds the same arrays;
    the port's load_domain reads each as the JAX load_domain reads the
    JAX tool's."""
    import icar_tpu.config as jc
    import icar_tpu_torch.config as tc
    from icar_tpu.core.driver import load_domain as jax_load
    from icar_tpu_torch.core.driver import load_domain

    dem, dem_cdf2 = both_formats(str(tmp_path / "dem.nc"), dem_variables())
    argv = ["--lat", "38.5", "41.5", "--coarsen", "2", "--smooth", "1"]
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    assert jax_tool("make_domain").main([dem, "-o", jax_out] + argv) == 0
    assert run_port_main("make_domain", [dem, "-o", port_out] + argv)[0] == 0
    assert_same_file(port_out, jax_out)
    cdf2_out = str(tmp_path / "port_cdf2.nc")
    with monkeypatch.context() as mp:
        mp.setattr(tnc, "h5py", None)
        assert run_port_main("make_domain",
                             [dem_cdf2, "-o", cdf2_out] + argv)[0] == 0
    assert_same_file(cdf2_out, jax_out, classic=True)
    o = jc.Options()
    o.forcing.init_conditions_file = jax_out
    want = jax_load(o)
    for out in (port_out, cdf2_out):
        o = tc.Options()
        o.forcing.init_conditions_file = out
        for got, ref in zip(load_domain(o), want):
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, np.asarray(ref))
    assert set(np.unique(contents(cdf2_out)[1]["landmask"])) == {1.0, 2.0}


# -- extract_daily_precip -----------------------------------------------------

def precip_files(directory, fmt):
    """A two-day run's output in two files: a file of frames every 12 h
    over the first day, and a per-step file at 48 h with ``model_time``
    as its attribute; the accumulation seeded."""
    rng = np.random.default_rng(41)
    acc = np.cumsum(rng.random((4, 3, 4)), axis=0)
    first = os.path.join(directory, f"out_a_{fmt}.nc")
    write_vars(first, {
        "model_time": (("time",), np.array([0.0, 43200, 86400])),
        "precipitation": (("time", "lat", "lon"),
                          acc[:3].astype(np.float32))}, fmt=fmt)
    step = os.path.join(directory, f"out_b_{fmt}.nc")
    write_vars(step, {"precipitation": (("lat", "lon"),
                                        acc[3].astype(np.float32))},
               attrs={"model_time": "172800.0"}, fmt=fmt)
    return [first, step]


def test_extract_daily_precip(tmp_path, monkeypatch):
    """Daily totals by both tools: the same file; with h5py absent the
    port's CDF-2 holds the same arrays, and the totals are the
    differences of the accumulation."""
    paths = precip_files(str(tmp_path), "netcdf4")
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    assert jax_tool("extract_daily_precip").main(paths + ["-o",
                                                          jax_out]) == 0
    assert run_port_main("extract_daily_precip",
                         paths + ["-o", port_out])[0] == 0
    assert_same_file(port_out, jax_out)
    classic = precip_files(str(tmp_path), "classic")
    cdf2_out = str(tmp_path / "port_cdf2.nc")
    with monkeypatch.context() as mp:
        mp.setattr(tnc, "h5py", None)
        assert run_port_main("extract_daily_precip",
                             classic + ["-o", cdf2_out])[0] == 0
    assert_same_file(cdf2_out, jax_out, classic=True)
    t, pr = port_tool("extract_daily_precip").load_steps(classic)
    assert list(t) == [0.0, 43200.0, 86400.0, 172800.0]
    daily = contents(cdf2_out)[1]["precipitation"]
    np.testing.assert_allclose(daily, np.stack([pr[2] - pr[0],
                                                pr[3] - pr[2]]), rtol=1e-6)


# -- get_merra ----------------------------------------------------------------

def merra_days(directory, fmt):
    """Two daily MERRA-2 files, levels top-down, seeded."""
    rng = np.random.default_rng(51)
    sub = os.path.join(directory, fmt)
    os.makedirs(sub)
    for day in ("20100101", "20100102"):
        write_vars(os.path.join(
            sub, f"MERRA2_300.inst3_3d_asm_Nv.{day}.SUB.nc"), {
            "time": (("time",), np.arange(0, 1440, 180.0)),
            "lat": (("lat",), np.linspace(30, 40, 4)),
            "lon": (("lon",), np.linspace(-110, -100, 6)),
            "lev": (("lev",), np.arange(5, dtype=np.float64)),
            "T": (("time", "lev", "lat", "lon"),
                  rng.random((8, 5, 4, 6), dtype=np.float32)),
            "PS": (("time", "lat", "lon"),
                   rng.random((8, 4, 6), dtype=np.float32))}, fmt=fmt)
    return os.path.join(sub, "MERRA2_*.SUB.nc")


def test_get_merra(tmp_path, monkeypatch):
    """The download script: the JAX tool's, its closing hint naming the
    port's module; the converted daily files: the same file by both
    tools, and with h5py absent a CDF-2 with the same arrays."""
    argv = ["-s", "2010-01-01", "-e", "2010-01-06", "--north", "45"]
    _, jax_script = run_jax_main(monkeypatch, "get_merra", argv)
    _, script = run_port_main("get_merra", argv)
    jl, pl = jax_script.splitlines(), script.splitlines()
    assert len(pl) == len(jl) == 9
    assert pl[2:-1] == jl[2:-1]
    assert sum(l.startswith("wget") for l in pl) == 5
    assert pl[-1].startswith("# then: python -m icar_tpu_torch.tools."
                             "get_merra --convert")

    pattern = merra_days(str(tmp_path), "netcdf4")
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    run_jax_main(monkeypatch, "get_merra", ["--convert", pattern, "-o",
                                            jax_out])
    run_port_main("get_merra", ["--convert", pattern, "-o", port_out])
    assert_same_file(port_out, jax_out)
    classic = merra_days(str(tmp_path), "classic")
    cdf2_out = str(tmp_path / "port_cdf2.nc")
    with monkeypatch.context() as mp:
        mp.setattr(tnc, "h5py", None)
        run_port_main("get_merra", ["--convert", classic, "-o", cdf2_out])
    assert_same_file(cdf2_out, jax_out, classic=True)
    assert contents(cdf2_out)[1]["T"].shape == (16, 5, 4, 6)


# -- plot_icar ----------------------------------------------------------------

def test_plot_icar(tmp_path, monkeypatch):
    """Where matplotlib imports: both tools render the same image from a
    NetCDF-4 file, and the port from its CDF-2 copy; an unknown variable
    is warned about, not fatal. Without matplotlib both raise naming it."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(61)
    ny, nx = 12, 16
    lat = np.linspace(40, 41, ny)[:, None] + np.zeros((ny, nx))
    lon = np.linspace(-105, -104, nx)[None, :] + np.zeros((ny, nx))
    src, classic = both_formats(str(tmp_path / "out.nc"), {
        "lat": (("y", "x"), lat.astype(np.float32)),
        "lon": (("y", "x"), lon.astype(np.float32)),
        "precipitation": (("time", "y", "x"),
                          rng.random((2, ny, nx), dtype=np.float32)),
        "cloud_water": (("time", "z", "y", "x"),
                        rng.random((2, 3, ny, nx), dtype=np.float32))})
    argv = ["-v", "precipitation", "-v", "cloud_water", "-v", "not_a_var"]
    pngs = {}
    for tag, path in (("jax", src), ("port", src), ("port_cdf2", classic)):
        pngs[tag] = str(tmp_path / f"{tag}.png")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            if tag == "jax":
                rc, _ = run_jax_main(monkeypatch, "plot_icar",
                                     [path, "-o", pngs[tag]] + argv)
            else:
                rc, _ = run_port_main("plot_icar",
                                      [path, "-o", pngs[tag]] + argv)
        assert rc == 0 and "not_a_var" in err.getvalue()
    images = {tag: open(p, "rb").read() for tag, p in pngs.items()}
    assert len(images["port"]) > 1000
    assert images["port"] == images["jax"] == images["port_cdf2"]
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        for run in (lambda: run_jax_main(monkeypatch, "plot_icar", [src]),
                    lambda: run_port_main("plot_icar", [src])):
            with pytest.raises(ImportError, match="matplotlib"):
                run()


# -- the port machine's conditions ------------------------------------------

def test_tools_run_without_jax_or_h5py(tmp_path):
    """With jax and h5py blocked, every tool module imports, and
    aggregate_output stitches CDF-2 files per shard; neither jax nor the
    JAX package is loaded."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["h5py"] = None
import numpy as np
from icar_tpu_torch.io.netcdf import NCFile, write_format
assert write_format() == "classic"
for name in {TOOLS!r}:
    importlib.import_module("icar_tpu_torch.tools." + name)
whole = np.arange(2 * 6 * 8, dtype=np.float32).reshape(2, 6, 8)
for sid, (y0, x0) in enumerate([(0, 0), (0, 4), (3, 0), (3, 4)]):
    with NCFile("{tmp_path}/o_img%03d_00000600.nc" % sid, "w") as f:
        f.create_var("theta", ("lev", "lat", "lon"),
                     whole[:, y0:y0 + 3, x0:x0 + 4])
        f.set_attrs(dict(y_start=y0, x_start=x0, shard_id=sid,
                         model_time=600.0))
from icar_tpu_torch.tools import aggregate_output
assert aggregate_output.main(["{tmp_path}/o_img*.nc", "-o",
                              "{tmp_path}/all.nc"]) == 0
with NCFile("{tmp_path}/all.nc") as f:
    assert f.format == "classic"
    assert np.array_equal(f.read("theta")[0], whole)
    assert list(f.read("model_time")) == [600.0]
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "icar_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_modules(path):
    """The absolute module names ``path`` imports."""
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (read as source, so that an import inside a function is
    seen too)."""
    paths = sorted(glob.glob(os.path.join(REPO, "icar_tpu_torch", "**",
                                          "*.py"), recursive=True))
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert any(p.endswith("tools/wrf2icar.py") for p in paths)
    for path in paths:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "icar_tpu"), (path, name)


def test_every_tool_has_its_counterpart():
    """Each tool the port carries has the JAX tool's file name and runs
    with ``python -m`` (its ``main`` takes ``argv``)."""
    import inspect
    for name in TOOLS:
        assert os.path.exists(os.path.join(REPO, "tools", f"{name}.py"))
        main = port_tool(name).main
        assert list(inspect.signature(main).parameters) == ["argv"], name
    ported = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(
        REPO, "icar_tpu_torch", "tools", "*.py"))} - {"__init__"}
    assert ported == set(TOOLS)


def test_reanalysis2icar_classic_scalar_coefficient(tmp_path):
    """A classic hybrid-sigma input with a scalar P0 (CESM history files
    are classic): the JAX tool's scipy path slices the scalar and raises
    (a fault of the JAX tool); the port reads it through NCFile and gives
    what the JAX tool gives for the NetCDF-4 copy."""
    src, classic = both_formats(str(tmp_path / "in.nc"),
                                reanalysis_input("cesm"))
    argv = ["--preset", "cesm", "-q"]
    with pytest.raises(IndexError):
        jax_tool("reanalysis2icar").main(
            [classic, "-o", str(tmp_path / "jax_cdf2.nc")] + argv)
    jax_out, port_out = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    assert jax_tool("reanalysis2icar").main([src, "-o", jax_out]
                                            + argv) == 0
    assert run_port_main("reanalysis2icar",
                         [classic, "-o", port_out] + argv)[0] == 0
    assert_same_file(port_out, jax_out)

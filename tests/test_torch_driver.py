"""The port's file-driven run (icar_tpu_torch/core/driver.py) against the
JAX package's driver, on the CPU.

The configuration is tests/test_forcing_io.py's ``ideal_run`` (SB04 +
upwind, a 48x14x10 domain under write_ideal_files' forcing, one hour with
forcing and output every 1800 s), with a restart at each output. Both
drivers run it from the same files (the port's ``write_ideal_files``):
- the same substeps in each interval, and every output field at every
  output time cell by cell at rtol 1e-5, atol 1e-7 (this dry case does not
  reach SB04's saturation revert, so the whole hour holds);
- the port resumed from the JAX driver's 1800 s restart against the JAX
  driver's 3600 s state, at the same tolerance, and from the JAX
  package's legacy .npz restart;
- the port resumed from its own 1800 s restart, bit for bit against its
  uninterrupted run.
Also: the command line (``main``) on the CPU; full-field forcing takes
the general loop (K3 and K1 once a substep, K2 never) and matches the JAX
step under strong wind forcing; the rain-fraction bias correction; the
native per-step writer; what is refused. The full-physics loop under
full-field forcing is tests/test_torch_forced_physics.py (its own file,
so that the two JAX compilations run on separate test workers).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.config import Options as JOptions
from icar_tpu.core.driver import ICARDriver as JDriver
from icar_tpu.io.output import write_restart as jax_write_restart
from icar_tpu_torch import constants as C
from icar_tpu_torch.config import Options
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core import step as tstep
from icar_tpu_torch.core.driver import ICARDriver, main
from icar_tpu_torch.forcing.ideal import write_ideal_files
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the small file case, no jax)

OUTPUT = ["u", "v", "w", "pressure", "potential_temperature", "water_vapor",
          "cloud_water", "rain_mass", "precipitation"]
RTOL, ATOL = 1e-5, 1e-7
PROGNOSTICS = ("potential_temperature", "water_vapor", "cloud_water",
               "rain_mass", "snow_mass", "u", "v", "w", "pressure")


def _options(cls, files, prefix):
    """tests/test_forcing_io.py's ideal_run options (chip_smoke's
    FILE_SMALL_Z levels), a restart at each output."""
    init, forcing = files
    o = cls()
    o.forcing.init_conditions_file = init
    o.forcing.boundary_files = [forcing]
    o.forcing.input_interval = chip_smoke.FILE_INTERVAL
    o.domain.dx = 1000.0
    o.domain.nz = chip_smoke.FILE_SMALL_Z["nz"]
    o.domain.dz_levels = list(chip_smoke.FILE_SMALL_Z["dz_levels"])
    o.domain.flat_z_height = chip_smoke.FILE_SMALL_Z["flat_z_height"]
    o.physics.microphysics = C.MP_SIMPLE
    o.physics.advection = C.ADV_UPWIND
    o.run.start_date = "2020-12-01 00:00:00"
    o.run.end_date = "2020-12-01 01:00:00"
    o.output.output_interval = chip_smoke.FILE_INTERVAL
    o.output.output_file = prefix + "out_"
    o.output.restart_file = prefix + "rst_"
    o.output.names = list(OUTPUT)
    o.output.restart_count = 1
    return o


def commit_state(model):
    """Commit a JAX model's state to its device (the same values on the
    same device) before each ``advance``. A jitted step compiles once for
    uncommitted arguments (a set-up's, a restart's) and again for
    committed ones (its own outputs): committed, every interval reuses the
    first one's compilation."""
    advance = model.advance

    def committed(*args, **kw):
        model.state = jax.device_put(model.state, jax.devices()[0])
        return advance(*args, **kw)
    model.advance = committed


def _record_substeps(driver):
    """Record the substeps of each advance of a JAX driver's model."""
    counts = []
    advance = driver.model.advance

    def counted(*args, **kw):
        out = advance(*args, **kw)
        counts.append(int(driver.model.last_n_substeps))
        return out
    driver.model.advance = counted
    return counts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX driver run and one port run of the same files."""
    tmp = tmp_path_factory.mktemp("driver")
    files = write_ideal_files(str(tmp), **chip_smoke.FILE_SMALL)
    jd = JDriver(_options(JOptions, files, str(tmp / "jax_")))
    commit_state(jd.model)
    jax_substeps = _record_substeps(jd)
    jd.run()
    td = ICARDriver(_options(Options, files, str(tmp / "port_")),
                    device="cpu")
    td.run()
    return dict(tmp=tmp, files=files, jax=jd, jax_substeps=jax_substeps,
                port=td)


def _read(path):
    with NCFile(path) as f:
        return {n: f.read(n) for n in f.variables()}


def test_output_matches_jax_driver(runs):
    """The same substeps an interval; every output field at t = 0, 1800
    and 3600 s within rtol 1e-5, atol 1e-7 of the JAX driver's."""
    assert runs["port"].substeps == runs["jax_substeps"] == [21, 21]
    want, got = _read(runs["jax"].writer.path), _read(runs["port"].writer.path)
    assert sorted(got) == sorted(OUTPUT + ["model_time"])
    np.testing.assert_array_equal(got["model_time"], [0.0, 1800.0, 3600.0])
    for name in OUTPUT:
        assert got[name].shape == want[name].shape and len(got[name]) == 3
        for i in range(3):
            np.testing.assert_allclose(got[name][i], want[name][i],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} at output {i}")
    assert 4.0 < np.median(runs["port"].model.field("u")) < 12.0


def _resumed(runs, restart, prefix):
    o = _options(Options, runs["files"], str(runs["tmp"] / prefix))
    o.run.restart = True
    o.run.restart_in_file = str(restart)
    d = ICARDriver(o, device="cpu")
    d.run()
    return d


@pytest.mark.parametrize("form", ["nc", "npz"])
def test_resumes_from_jax_restart(runs, form):
    """The port resumed from the JAX driver's 1800 s checkpoint (its
    NetCDF-4 file, or the legacy .npz the JAX package writes) reaches the
    JAX driver's 3600 s state within rtol 1e-5, atol 1e-7."""
    jd = runs["jax"]
    path = runs["tmp"] / "jax_rst_00001800.nc"
    if form == "npz":
        # the JAX package's own reader, then its .npz writer
        from icar_tpu.io.output import read_restart as jax_read_restart
        m = type(jd.model)(copy.deepcopy(jd.options),
                           np.asarray(jd.model.geom.terrain, np.float64),
                           np.asarray(jd.model.geom.lat),
                           np.asarray(jd.model.geom.lon))
        t = jax_read_restart(str(path), m)
        path = runs["tmp"] / "jax_rst_00001800.npz"
        jax_write_restart(str(path), m, t)
    d = _resumed(runs, path, f"from_jax_{form}_")
    assert d.substeps == runs["jax_substeps"][1:]
    for name in sorted(d.model.state):
        np.testing.assert_allclose(d.model.field(name),
                                   np.asarray(jd.model.field(name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_own_restart_is_bit_exact(runs):
    """Resumed from its own 1800 s checkpoint, the port reaches its
    uninterrupted run's 3600 s state bit for bit."""
    port = runs["port"]
    d = _resumed(runs, runs["tmp"] / "port_rst_00001800.nc", "own_")
    assert d.substeps == port.substeps[1:]
    assert d.model.digest() == port.model.digest()
    for name in port.model.state:
        np.testing.assert_array_equal(d.model.field(name),
                                      port.model.field(name), err_msg=name)


def test_main_on_the_cpu(runs, tmp_path):
    """``main`` with ``--device cpu`` runs the options file (chip_smoke's
    namelist of the same case) and writes the same u and theta as the
    port's run; without ``--device cpu`` it asks for the card and, where
    there is none, raises instead of falling back; without an options file
    it prints its usage and returns 1."""
    init, forcing = runs["files"]
    prefix = str(tmp_path / "cli_")
    nml = chip_smoke.write_namelist(prefix + "options.nml", init, forcing,
                                    prefix, chip_smoke.FILE_SMALL_Z,
                                    dict(mp=2, adv=1))
    assert main([nml, "--device", "cpu"]) == 0
    got, want = _read(prefix + "out_run.nc"), _read(runs["port"].writer.path)
    for name in ("u", "potential_temperature", "water_vapor"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert os.path.exists(prefix + "rst_00003600.nc")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([nml])
    assert main([]) == 1


def test_main_profile_on_the_cpu(runs, tmp_path):
    """``--profile DIR`` wraps the run in a torch.profiler trace written to
    DIR in Chrome's trace format."""
    init, forcing = runs["files"]
    prefix = str(tmp_path / "prof_")
    nml = chip_smoke.write_namelist(prefix + "options.nml", init, forcing,
                                    prefix, chip_smoke.FILE_SMALL_Z,
                                    dict(mp=2, adv=1))
    trace_dir = tmp_path / "trace"
    assert main([nml, "--device", "cpu", "--profile", str(trace_dir)]) == 0
    trace = trace_dir / "icar_trace.json"
    assert trace.stat().st_size > 0 and b"aten::" in trace.read_bytes()
    assert main([nml, "--profile"]) == 1


def _counting(monkeypatch):
    """Count the calls of each kernel wrapper (the CPU runs their plain
    versions, which LAUNCHES does not count)."""
    calls = {"mp_simple": 0, "mp_simple_rho": 0, "advect_upwind": 0,
             "advect_mpdata": 0, "mp_thompson_stack": 0,
             "prepare_advect_winds": 0}
    for name in calls:
        orig = getattr(kernels, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    return calls


def test_full_field_forcing_takes_the_general_loop(runs, monkeypatch):
    """Under strong wind, pressure, theta and humidity forcing, one 600 s
    interval from the JAX driver's final state (cloud and snow in it): K3
    (SB04 with the state's density) and K1 once a substep, K2 never, the
    winds' operands prepared anew each substep
    (``path_kernels(full_forcing=True)``); the substeps (more than
    unforced, as the forced winds grow) equal to the JAX step's; its
    prognostic fields within rtol 1e-5, atol 1e-7 (precipitation rtol
    1e-4), as tests/test_torch_model.py holds the unforced loop; every
    derived field within 1e-4 of its largest magnitude (observed at most
    4.2e-5, the integrated ice, from snow within 9e-9 kg/kg). Tendencies
    of the advected species alone keep the fast loop (K2)."""
    jd = runs["jax"]
    initial = {k: np.asarray(v) for k, v in jd.model.state.items()}
    r = np.random.default_rng(8)

    def rnd(name, lo, hi):
        return r.uniform(lo, hi, initial[name].shape).astype(np.float32)
    dqdt = {"u": rnd("u", 2e-3, 6e-3), "v": rnd("v", -2e-3, 2e-3),
            "w": rnd("w", -1e-5, 1e-5),
            "pressure": rnd("pressure", -0.05, 0.05),
            "potential_temperature": rnd("potential_temperature", -1e-4,
                                         1e-4),
            "water_vapor": rnd("water_vapor", -1e-7, 1e-8)}
    # the JAX driver's compiled step takes dqdt of the same fields
    want, _, n = jd.model._step_fn(
        {k: jnp.array(v) for k, v in initial.items()},
        {k: jnp.asarray(v) for k, v in dqdt.items()}, jnp.float32(0.0),
        jnp.float32(600.0), jd.model._time_aux(), jd.model.geom_args())
    m = runs["port"].model
    calls = _counting(monkeypatch)
    got, n_t = tstep.run_interval(
        state_from_numpy(initial, "cpu"), m.geom_t, m.options,
        m.advect_names, 600.0, {k: torch.tensor(v) for k, v in dqdt.items()})
    assert n_t == int(n) > 7        # 7 substeps without the forcing
    assert calls == {"mp_simple": 0, "mp_simple_rho": n_t,
                     "advect_upwind": n_t, "advect_mpdata": 0,
                     "mp_thompson_stack": 0, "prepare_advect_winds": n_t}
    assert tstep.path_kernels(m.options, full_forcing=True) == (
        "mp_simple_rho", "advect_upwind")
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in PROGNOSTICS:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
        elif k in ("precipitation", "snowfall"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=ATOL, err_msg=k)
        else:
            d = np.abs(g - w).max()
            assert d <= 1e-4 * max(np.abs(w).max(), 1e-30), (k, d)
    calls.update(dict.fromkeys(calls, 0))
    _, n_t = tstep.run_interval(
        state_from_numpy(initial, "cpu"), m.geom_t, m.options,
        m.advect_names, 600.0,
        {"water_vapor": torch.tensor(dqdt["water_vapor"])})
    assert calls["mp_simple"] == calls["advect_upwind"] == n_t
    assert calls["mp_simple_rho"] == 0 and calls["prepare_advect_winds"] == 1


def test_rain_fraction_bias_correction():
    """tests/test_forcing_io.py's bias correction through the port: the
    interval's precipitation increment scaled on interior cells by the
    month's entry, the boundary ring untouched."""
    def run(month):
        m = ideal_ridge_model(nx=24, ny=12, nz=10, dx=1000.0,
                              hill_height=600.0, u_speed=10.0, rh=1.0,
                              device="cpu")
        scale = np.ones((12, 12, 24), np.float32)
        scale[6] = 0.5                          # halve July precip
        m.set_rain_fraction(scale)
        m.advance(600.0, rain_frac_month=month)
        m.advance(600.0, rain_frac_month=month)
        return m.field("precipitation")

    july = run(6)
    january = run(0)
    assert january.max() > 1e-4, "test case did not precipitate"
    np.testing.assert_allclose(july[1:-1, 1:-1], january[1:-1, 1:-1] * 0.5,
                               rtol=1e-6)
    np.testing.assert_allclose(july[0, :], january[0, :], rtol=1e-6)
    np.testing.assert_allclose(july[:, -1], january[:, -1], rtol=1e-6)


def test_classic_async_engine(runs, tmp_path):
    """The native per-step writer: one CDF-2 file per output time, the same
    fields as the growing file's."""
    from icar_tpu_torch.io.async_writer import available
    if not available():
        pytest.skip("no g++ to build the native writer")
    o = _options(Options, runs["files"], str(tmp_path / "a_"))
    o.output.engine = "classic-async"
    d = ICARDriver(o, device="cpu")
    d.run()
    assert d.writer.wait() == 0
    assert [os.path.basename(p) for p in d.writer.paths] == [
        f"a_out_{t:08d}.nc" for t in (0, 1800, 3600)]
    want = _read(runs["port"].writer.path)
    with NCFile(d.writer.paths[-1]) as f:
        assert f.format == "classic"
        np.testing.assert_array_equal(f.read("potential_temperature"),
                                      want["potential_temperature"][-1])


def test_output_file_rotation(runs, tmp_path):
    """frames_per_outfile starts a new file every N frames."""
    o = _options(Options, runs["files"], str(tmp_path / "rot_"))
    o.output.output_interval = 900.0
    o.output.frames_per_outfile = 2
    ICARDriver(o, device="cpu").run()
    for suffix, times in (("", [0.0, 900.0]), ("_001", [1800.0, 2700.0]),
                          ("_002", [3600.0])):
        with NCFile(str(tmp_path / f"rot_out_run{suffix}.nc")) as f:
            np.testing.assert_array_equal(f.read("model_time"), times)


MESH = (2, 2)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _sharded(runs, prefix, engine=None, restart=None):
    """A port driver run of the case on a 2x2 CPU mesh."""
    o = _options(Options, runs["files"], str(runs["tmp"] / prefix))
    if engine:
        o.output.engine = engine
    if restart:
        o.run.restart = True
        o.run.restart_in_file = str(restart)
    d = ICARDriver(o, device="cpu", mesh=Mesh(["cpu"] * 4, MESH))
    assert len(d.model.blocks) == 4
    d.run()
    return d


@pytest.fixture(scope="module")
def sharded(runs):
    """The port's run on a 2x2 CPU mesh with the default engine."""
    return _sharded(runs, "mesh_")


@pytest.mark.parametrize("what", ["mesh", "sharded engine", "rain mesh"])
def test_sharded_runs_are_refused(runs, sharded, tmp_path, what):
    """File-driven runs on a mesh, once refused, now run. "mesh": the
    driver on a 2x2 CPU mesh takes the unsharded run's substeps, and its
    output file and both restarts equal the unsharded run's bit for bit.
    "sharded engine": the "sharded" output engine on that mesh writes
    four files a step (``{prefix}img{sid:03d}_{t:08d}.nc``), which
    tools/aggregate_output.py stitches into the unsharded run's fields
    bit for bit. "rain mesh": the rain fraction on a mesh scales each
    block's precipitation as the unsharded run's: every bit of every
    field equal."""
    from icar_tpu_torch.parallel.mesh import make_mesh
    port = runs["port"]
    if what == "mesh":
        assert sharded.substeps == port.substeps
        got, want = _read(sharded.writer.path), _read(port.writer.path)
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                          err_msg=n)
        for t in (1800, 3600):
            got = _read(runs["tmp"] / f"mesh_rst_{t:08d}.nc")
            want = _read(runs["tmp"] / f"port_rst_{t:08d}.nc")
            assert sorted(got) == sorted(want)
            for n in want:
                np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                              err_msg=f"{n} at {t} s")
    elif what == "sharded engine":
        import subprocess
        d = _sharded(runs, "engine_", engine="sharded")
        assert d.writer.wait() == 0
        assert sorted(os.path.basename(p) for p in d.writer.paths) == [
            f"engine_out_img{i:03d}_{t:08d}.nc" for i in range(4)
            for t in (0, 1800, 3600)]
        out = str(tmp_path / "combined.nc")
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools/aggregate_output.py"),
             str(runs["tmp"] / "engine_out_img*.nc"), "-o", out],
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        got, want = _read(out), _read(port.writer.path)
        np.testing.assert_array_equal(got["model_time"], want["model_time"])
        for n in OUTPUT:
            np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                          err_msg=n)
    else:
        scale = np.random.default_rng(2).uniform(0.5, 1.5, (12, 12, 24))
        models = []
        for mesh in (None, make_mesh(24, 12, devices=["cpu"] * 4)):
            m = ideal_ridge_model(nx=24, ny=12, nz=10, hill_height=600.0,
                                  rh=1.0, device="cpu")
            m.set_rain_fraction(scale.astype(np.float32))
            if mesh is not None:
                m.attach_mesh(mesh)
            m.advance(600.0, rain_frac_month=4)
            models.append(m)
        one, sharded = models
        assert one.field("precipitation").max() > 0
        for k in one.state:
            np.testing.assert_array_equal(sharded.field(k).view(np.uint32),
                                          one.field(k).view(np.uint32),
                                          err_msg=k)


def test_sharded_run_resumes_from_its_own_restart(runs, sharded):
    """The 2x2 run resumed on the mesh from its own 1800 s checkpoint
    reaches its uninterrupted run's 3600 s checkpoint bit for bit."""
    d = _sharded(runs, "mesh_resumed_",
                 restart=runs["tmp"] / "mesh_rst_00001800.nc")
    assert d.substeps == sharded.substeps[1:]
    got = _read(runs["tmp"] / "mesh_resumed_rst_00003600.nc")
    want = _read(runs["tmp"] / "mesh_rst_00003600.nc")
    for n in want:
        np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                      err_msg=n)
    assert d.model.digest() == sharded.model.digest()


def test_full_field_forcing_on_blocks(runs, monkeypatch):
    """The forced ridge of ``test_full_field_forcing_takes_the_general_
    loop`` (from the port run's final state) on a 2x2 CPU mesh: one 600 s
    interval equal to the unsharded model's in every bit of every field,
    K3 and K1 once per shard and substep, each block's wind operands
    prepared every substep."""
    base = runs["port"].model
    r = np.random.default_rng(8)

    def rnd(name, lo, hi):
        return r.uniform(lo, hi, base.state[name].shape).astype(np.float32)
    dqdt = {"u": rnd("u", 2e-3, 6e-3), "v": rnd("v", -2e-3, 2e-3),
            "w": rnd("w", -1e-5, 1e-5),
            "pressure": rnd("pressure", -0.05, 0.05),
            "potential_temperature": rnd("potential_temperature", -1e-4,
                                         1e-4),
            "water_vapor": rnd("water_vapor", -1e-7, 1e-8)}
    one, blocks = copy.deepcopy(base), copy.deepcopy(base)
    for m in (one, blocks):
        m.set_forcing_tendencies(dqdt)
    blocks.attach_mesh(Mesh(["cpu"] * 4, MESH))
    one.advance(600.0)
    calls = _counting(monkeypatch)
    blocks.advance(600.0)
    n = one.last_n_substeps
    assert blocks.last_n_substeps == n > 7
    assert calls == {"mp_simple": 0, "mp_simple_rho": 4 * n,
                     "advect_upwind": 4 * n, "advect_mpdata": 0,
                     "mp_thompson_stack": 0, "prepare_advect_winds": 4 * n}
    assert chip_smoke.bit_mismatches(one, blocks) == []


def test_sharded_fullphys_file_run(runs, tmp_path, monkeypatch):
    """chip_smoke's FILE_PHYSICS full-physics small case (Thompson and
    upwind under full-field forcing, the fullphys column) over its first
    1800 s forcing step on a 2x2 CPU mesh: the unsharded run's substeps,
    K5 and K1 once per shard and substep, its 1800 s output and
    checkpoint bit for bit."""
    init, forcing = runs["files"]
    physics = dict(chip_smoke.FILE_PHYSICS)["Thompson + upwind, fullphys"]
    drivers = []
    for mesh in (None, Mesh(["cpu"] * 4, MESH)):
        prefix = str(tmp_path / ("mesh_" if mesh else "one_"))
        o = Options.from_namelist(chip_smoke.write_namelist(
            prefix + "options.nml", init, forcing, prefix,
            chip_smoke.FILE_SMALL_Z, physics))
        o.run.end_date = "2020-12-01 00:30:00"
        o.validate()
        if mesh is not None:
            calls = _counting(monkeypatch)
        d = ICARDriver(o, device="cpu", mesh=mesh)
        d.run()
        drivers.append(d)
    one, sharded = drivers
    assert sharded.substeps == one.substeps and len(one.substeps) == 1
    n = one.substeps[0]
    assert calls["mp_thompson_stack"] == calls["advect_upwind"] == 4 * n
    for path in (one.writer.path, str(tmp_path / "one_rst_00001800.nc")):
        want = _read(path)
        got = _read(path.replace("one_", "mesh_"))
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=f"{k} in {path}")

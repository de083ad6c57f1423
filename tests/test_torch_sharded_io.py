"""Files per shard: the port's "sharded" output engine
(``io.output.ShardedOutputWriter``) and per-shard restarts
(``write_restart_sharded``, ``read_restart_sharded``) against the JAX
package's, on the CPU.

The JAX model here is built and sharded over a 2x2 mesh of four of the
test's CPU devices but never advanced, so nothing is compiled: its files
are compared in layout (variable names, shapes, global attributes) with
the port's on a 2x2 CPU mesh of the same grid, and its restart files are
read by the port and the port's by it, every field bit for bit. The
port's own round trip is a linear-theory ridge (its perturbations ride in
the files), held bit for bit over the interval after it.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from icar_tpu.io import output as jout
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.core.state import restart_names
from icar_tpu_torch.io import output as tout
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

GRID = dict(nx=48, ny=14, nz=10, dx=1000.0, hill_height=400.0, rh=0.9)
NAMES = ["u", "v", "w", "pressure", "potential_temperature", "water_vapor",
         "precipitation"]
MESH = (2, 2)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def restart_fields(model):
    """The restart fields ``model`` holds, sorted."""
    return sorted(n for n in restart_names(model.options)
                  if n in model._held())


def _read(path):
    with NCFile(path) as f:
        return ({n: f.read(n) for n in f.variables()},
                {k: f.read_attr(None, k) for k in f.attr_names()})


@pytest.fixture(scope="module")
def models():
    """(JAX model on a 2x2 mesh of CPU devices, port model on a 2x2 CPU
    mesh), the same grid, neither advanced."""
    jm = jax_model(**GRID)
    jm.attach_mesh(JaxMesh(np.array(jax.devices()[:4]).reshape(MESH),
                           ("y", "x")))
    tm = ideal_ridge_model(**GRID, mesh=Mesh(["cpu"] * 4, MESH),
                           device="cpu")
    return jm, tm


def test_sharded_output_files_match_the_jax_writer(models, tmp_path,
                                                  monkeypatch):
    """Each of the four files a step: the JAX writer's variable names,
    shapes and global attributes (its own ``source`` aside), through
    ``NCFile`` (the native writer made unavailable); the native async
    engine's files hold the same variables and the same attributes as
    text."""
    from icar_tpu_torch.io import async_writer

    jm, tm = models
    jw = jout.ShardedOutputWriter(str(tmp_path / "jax_"), NAMES,
                                  use_async=False)
    jw.write_step(jm, 0.0)
    built = async_writer.available()
    files = {}
    for tag, native in (("port_", False), ("async_", True)):
        with monkeypatch.context() as mp:
            if not native:
                mp.setattr(async_writer, "available", lambda: False)
            w = tout.ShardedOutputWriter(str(tmp_path / tag), NAMES)
        assert (w._async is not None) == (native and built)
        w.write_step(tm, 0.0)
        assert w.wait() == 0
        files[tag] = w.paths
    assert len(jw.paths) == 4
    for jp, tp, ap in zip(jw.paths, files["port_"], files["async_"]):
        assert tp.replace("port_", "jax_") == jp
        (jv, ja), (tv, ta), (av, aa) = _read(jp), _read(tp), _read(ap)
        assert sorted(tv) == sorted(jv) == sorted(av) == sorted(NAMES)
        for n in NAMES:
            assert tv[n].shape == jv[n].shape == av[n].shape, n
            np.testing.assert_array_equal(_bits(av[n]), _bits(tv[n]))
        assert sorted(ta) == sorted(ja) == sorted(aa)
        assert ta.pop("source").startswith("icar_tpu_torch ")
        ja.pop("source")
        assert ta == ja
        assert {k: v for k, v in aa.items() if k != "source"} == {
            k: str(v) for k, v in ta.items()}


def test_sharded_output_without_a_mesh_is_one_file(tmp_path):
    """Without a mesh the engine writes one file a step, the whole
    domain's fields, as the JAX writer on one device does."""
    m = ideal_ridge_model(**GRID, device="cpu")
    w = tout.ShardedOutputWriter(str(tmp_path / "one_"), NAMES)
    w.write_step(m, 600.0)
    assert w.wait() == 0
    assert [p.rsplit("/", 1)[1] for p in w.paths] == [
        "one_img000_00000600.nc"]
    fields, attrs = _read(w.paths[0])
    assert (attrs["y_start"], attrs["x_start"], attrs["shard_id"]) == (
        "0", "0", "0")
    for n in NAMES:
        np.testing.assert_array_equal(_bits(fields[n]), _bits(m.field(n)))


def test_jax_restart_files_read_by_the_port(models, tmp_path):
    """The JAX package's per-shard restart of its 2x2 model, read by the
    port's 2x2 model: every field the files hold equal to the JAX
    model's bit for bit, the time restored."""
    jm, tm = models
    paths = jout.write_restart_sharded(str(tmp_path / "jax_"), jm, 900.0)
    assert len(paths) == 4
    m = copy.deepcopy(tm)
    assert tout.read_restart_sharded(paths, m) == 900.0
    assert m.model_time == 900.0
    read = [n for n in m.blocks[0] if n in _read(paths[0])[0]]
    assert sorted(read) == restart_fields(tm)
    for n in read:
        np.testing.assert_array_equal(_bits(m.field(n)),
                                      _bits(jm.field(n)), err_msg=n)


def test_port_restart_files_read_by_jax(models, tmp_path):
    """The port's per-shard restart of its 2x2 model, read by the JAX
    package's 2x2 model: every field equal to the port's bit for bit; the
    pieces are the JAX package's padded shards."""
    jm, tm = models
    paths = tout.write_restart_sharded(str(tmp_path / "port_"), tm, 1200.0)
    jm = copy.copy(jm)
    jm.state = dict(jm.state)
    assert jout.read_restart_sharded(paths, jm) == 1200.0
    assert sorted(_read(paths[0])[0]) == restart_fields(tm)
    for n in restart_fields(tm):
        np.testing.assert_array_equal(_bits(jm.field(n)),
                                      _bits(tm.field(n)), err_msg=n)
        assert jm.state[n].shape[-2:] == (16, 50)


def test_mismatched_decomposition_raises(models, tmp_path):
    """Files of a 2x2 decomposition refuse a 1x4 model and an unsharded
    one: aggregate them and use read_restart."""
    _, tm = models
    paths = tout.write_restart_sharded(str(tmp_path / "r_"), tm, 0.0)
    for other in (Mesh(["cpu"] * 4, (1, 4)), None):
        m = ideal_ridge_model(**GRID, mesh=other, device="cpu")
        with pytest.raises(ValueError, match="read_restart"):
            tout.read_restart_sharded(paths, m)


def test_restart_round_trip_with_linear_perturbations(tmp_path):
    """A linear-theory ridge on a 2x2 CPU mesh after one interval, written
    per shard and read into a copy of it as built: every field and both
    perturbations (``__u_perturbation__``, ``__v_perturbation__`` in the
    files, as the JAX package's padded pieces) bit for bit, and every
    field after a wind update and one more interval of each (the derived
    fields, which no restart holds, are formed anew there)."""
    def cb(o):
        o.lt.n_spd_values, o.lt.n_dir_values, o.lt.n_nsq_values = 3, 4, 2
        o.lt.buffer = 10
    m = ideal_ridge_model(**GRID, windtype=C.WIND_LINEAR, options_cb=cb,
                          mesh=Mesh(["cpu"] * 4, MESH), device="cpu")
    fresh = copy.deepcopy(m)
    m.update_winds()
    m.advance(300.0)
    paths = tout.write_restart_sharded(str(tmp_path / "lin_"), m, 300.0)
    fields, attrs = _read(paths[3])
    assert (attrs["shard_id"], attrs["y_start"], attrs["x_start"]) == (
        3, 8, 25)
    assert fields["__u_perturbation__"].shape == (GRID["nz"], 8, 25)
    assert tout.read_restart_sharded(paths, fresh) == 300.0
    for k in ("u_perturbation", "v_perturbation"):
        assert torch.equal(getattr(fresh, k), getattr(m, k)), k
    names = restart_fields(m)
    assert "__u_perturbation__" not in names and len(fields) == len(
        names) + 2
    for n in names:
        np.testing.assert_array_equal(_bits(fresh.field(n)),
                                      _bits(m.field(n)), err_msg=n)
    for x in (m, fresh):
        x.update_winds()
        x.advance(300.0)
    for n in m.blocks[0]:
        np.testing.assert_array_equal(_bits(fresh.field(n)),
                                      _bits(m.field(n)), err_msg=n)
    assert fresh.digest() == m.digest()

"""The port's sharded model (ICARModel.attach_mesh, core/step.py
run_interval_sharded) on CPU devices.

(a) Each ridge path -- SB04 + upwind, SB04 + MPDATA, Thompson + MPDATA --
sharded on a 2x2 and a 4x1 mesh against the same model unsharded: the same
substep count, every field of the state bit for bit and the same
ICARModel.digest, over two intervals with a v flow across the shard
boundaries and boundary forcing. (b) The port's sharded model against the
JAX package's sharded model (4 of the 8 virtual CPU devices), one case per
path, at the JAX package's tolerance between its sharded and single-device
models (tests/test_parallel.py
test_sharded_step_matches_single_device: rtol 2e-5, atol 1e-6,
precipitation atol 1e-5). The cases keep off SB04's saturation revert edge,
where the two packages part by design (PERF.md; tests/test_torch_model.py).
For Thompson that is the bound, not tests/test_shard_kernels.py's atol of
1e-6 of each field's maximum: that one holds the JAX kernel against
itself, and the port's Thompson parts from the JAX package's jitted one by
its FMA contractions (ROADMAP section 3). (c) The sharded interval reaches
every per-shard wrapper of its path, and attach_mesh refuses a mesh of
another device type or one that leaves a shard empty.
"""

import numpy as np
import pytest
import torch

from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.forcing.ideal import make_ideal_case
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel import shard_kernels as sk
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

CASE = dict(nx=48, ny=32, nz=8, dx=1000.0, hill_height=500.0, u_speed=10.0,
            flat_z_height=-2)
PATHS = {"upwind": (C.MP_SIMPLE, C.ADV_UPWIND),
         "mpdata": (C.MP_SIMPLE, C.ADV_MPDATA),
         "thompson": (C.MP_THOMPSON, C.ADV_MPDATA)}


def _cpu_mesh(my, mx):
    return Mesh(["cpu"] * (my * mx), (my, mx))


def _model(path, rh=1.0, v=5.0):
    mp, adv = PATHS[path]
    m = ideal_ridge_model(**CASE, rh=rh, mp=mp, adv=adv, device="cpu")
    m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                             v_profile=v, rh=rh))
    return m


def _forcing(m):
    r = np.random.default_rng(3)
    shape = m.field("water_vapor").shape
    return {"potential_temperature": r.uniform(-1e-4, 1e-4, shape).astype(
                np.float32),
            "water_vapor": r.uniform(-1e-6, 2e-8, shape).astype(np.float32),
            "cloud_water": r.uniform(0, 1e-8, shape).astype(np.float32)}


@pytest.mark.parametrize("my,mx", [(2, 2), (4, 1)])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_sharded_model_is_bit_exact(path, my, mx):
    """Two 300 s intervals; on the 2x2 mesh the forcing is set after
    attach_mesh, on the 4x1 mesh before it."""
    one, sharded = _model(path), _model(path)
    one.set_forcing_tendencies(_forcing(one))
    if (my, mx) == (2, 2):
        sharded.attach_mesh(_cpu_mesh(my, mx))
        sharded.set_forcing_tendencies(_forcing(one))
    else:
        sharded.set_forcing_tendencies(_forcing(one))
        sharded.attach_mesh(_cpu_mesh(my, mx))
    assert sharded.state is None and len(sharded.blocks) == my * mx
    for _ in range(2):
        one.advance(300.0)
        sharded.advance(300.0)
        assert sharded.last_n_substeps == one.last_n_substeps >= 5
    assert np.abs(one.field("v")).max() > 4.0
    assert one.field("cloud_water").max() > 1e-5
    assert one.field("precipitation").max() > 0.0
    for k in sorted(one.state):
        np.testing.assert_array_equal(sharded.field(k), one.field(k),
                                      err_msg=k)
    assert sharded.digest() == one.digest()


def test_state_set_after_attach_mesh_is_scattered():
    """set_initial_conditions and apply_winds on a sharded model gather,
    compute on the whole domain, and scatter: the blocks hold what
    attaching the finished state gives."""
    a, b = _model("mpdata"), _model("mpdata", v=0.0)
    b.attach_mesh(_cpu_mesh(2, 2))
    b.set_initial_conditions(make_ideal_case(b.geom, u_profile=10.0,
                                             v_profile=5.0, rh=1.0))
    a.attach_mesh(_cpu_mesh(2, 2))
    for ba, bb in zip(a.blocks, b.blocks):
        assert sorted(ba) == sorted(bb)
        for k in ba:
            assert torch.equal(ba[k], bb[k]), k
    u, v = a.field("u"), a.field("v")
    a.apply_winds(u * 0.5, v, rotate=False)
    c = _model("mpdata")
    c.apply_winds(u * 0.5, v, rotate=False)
    for k in ("u", "v", "w"):
        np.testing.assert_array_equal(a.field(k), c.field(k), err_msg=k)


@pytest.mark.parametrize("path,mesh,rh,v", [
    ("upwind", (2, 2), 0.9, 4.0),
    ("mpdata", (4, 1), 0.9, 2.0),
    ("thompson", (2, 2), 0.9, 4.0)])
def test_sharded_model_matches_the_jax_sharded_model(path, mesh, rh, v):
    import jax
    from jax.sharding import Mesh as JaxMesh

    from icar_tpu.forcing.ideal import make_ideal_case as jax_case
    from icar_tpu.models.icar import ideal_ridge_model as jax_model

    mp, adv = PATHS[path]
    mj = jax_model(**CASE, rh=rh, mp=mp, adv=adv)
    mj.set_initial_conditions(jax_case(mj.geom, u_profile=10.0, v_profile=v,
                                       rh=rh))
    mt = ideal_ridge_model(**CASE, rh=rh, mp=mp, adv=adv, device="cpu")
    mt.state = state_from_numpy({k: np.asarray(x)
                                 for k, x in mj.state.items()}, "cpu")
    my, mx = mesh
    mj.attach_mesh(JaxMesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                           ("y", "x")))
    mt.attach_mesh(_cpu_mesh(my, mx))
    mj.advance(300.0)
    mt.advance(300.0)
    assert mt.last_n_substeps == int(mj.last_n_substeps)
    assert mt.field("cloud_water").max() > 1e-5
    for k in ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "u", "v", "w", "precipitation"):
        np.testing.assert_allclose(
            mt.field(k), np.asarray(mj.field(k)), rtol=2e-5,
            atol=1e-5 if k == "precipitation" else 1e-6, err_msg=k)


WRAPPERS = {"upwind": ("mp_simple_sharded", "advect_upwind_sharded"),
            "mpdata": ("mp_simple_sharded", "advect_mpdata_sharded"),
            "thompson": ("thompson_stack_sharded", "advect_mpdata_sharded")}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sharded_interval_dispatches_the_shard_kernels(path, monkeypatch):
    """Each substep calls the path's per-shard wrappers once with all four
    blocks (the counterpart of tests/test_shard_kernels.py
    test_sharded_step_dispatches_kernels); on CPU blocks no kernel
    launches."""
    calls = []
    for name in ("mp_simple_sharded", "thompson_stack_sharded",
                 "advect_upwind_sharded", "advect_mpdata_sharded"):
        real = getattr(sk, name)

        def spy(*a, _name=name, _real=real, **k):
            blocks = a[0] if not hasattr(a[0], "shards") else a[1]
            calls.append((_name, len(blocks)))
            return _real(*a, **k)
        monkeypatch.setattr(sk, name, spy)
    m = _model(path)
    m.attach_mesh(_cpu_mesh(2, 2))
    kernels.reset_launches()
    m.advance(120.0)
    n = m.last_n_substeps
    assert n >= 2
    assert sorted(calls) == sorted((w, 4) for w in WRAPPERS[path]
                                   for _ in range(n))
    assert set(kernels.LAUNCHES.values()) == {0}


def test_attach_mesh_refuses_a_mesh_it_cannot_run():
    m = _model("upwind")
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        m.attach_mesh(Mesh(["cuda:0"] * 4, (2, 2)))
    small = ideal_ridge_model(nx=9, ny=8, nz=10, hill_height=300.0,
                              device="cpu")
    with pytest.raises(ValueError, match="would own none"):
        small.attach_mesh(_cpu_mesh(1, 4))
    # the refused meshes left both models as they were
    assert m.mesh is None and small.mesh is None
    small.advance(60.0)
    assert small.last_n_substeps > 0

"""Linear-theory winds (wind=1, wind=5) and flow blocking on a sharded
port model (bench.py --config linear --sharded), on CPU meshes, held bit
for bit to the unsharded port run (which tests/test_torch_linear_model.py
holds to the JAX package).

The case is tests/test_parallel.py's sharded linear-table case (48x16x10,
3 speeds x 4 directions x 2 N^2, buffer 10), with chip_smoke's blocking
bounds for blocking. Each run takes two 300 s intervals with a wind update
before each, as bench.py's linear loop does. A 2x2 mesh is attached by
``ideal_ridge_model(mesh=...)`` (the JAX package's order: the state, the
mesh, then the initial wind solve), a 1x4 one to a copy of the built
unsharded model (its table built once for both).
Each must equal the unsharded run in every bit of every field, in the
digest, the substeps and the perturbations the linear solve relaxes. The
wind solve is one solve of the whole domain on the model's device
(``ICARModel.attach_mesh``), so nothing less than that equality is right.
"""

import copy

import numpy as np
import pytest
import torch

from icar_tpu_torch import constants as C
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

CASE = dict(nx=48, ny=16, nz=10, dx=1000.0, hill_height=600.0,
            u_speed=10.0, rh=0.8)
INTERVAL = 300.0
# (windtype, blocking)
SOLVERS = {"wind=1": (C.WIND_LINEAR, False),
           "wind=5": (C.WIND_LINEAR_ITERATIVE, False),
           "wind=1 with blocking": (C.WIND_LINEAR, True)}
# (mesh shape, attached by ideal_ridge_model(mesh=...) rather than to a copy
# of the built model)
MESHES = {"2x2": ((2, 2), True), "1x4": ((1, 4), False)}
# the fields a wind solve's caller forms from the winds (diagnostic_update)
# and apply_winds leaves to the next interval's refresh, as the JAX
# package's does (icar_tpu/models/icar.py apply_winds)
WIND_DIAGNOSTICS = ("ivt", "u_10m", "u_mass", "ustar", "v_10m", "v_mass",
                    "w_real")


def options_cb(block):
    def cb(o):
        o.lt.n_spd_values, o.lt.n_dir_values, o.lt.n_nsq_values = 3, 4, 2
        o.lt.buffer = 10
        if block:
            o.block.block_flow = True
            o.block.block_fr_max, o.block.block_fr_min = 6.0, 4.0
    return cb


def build(solver, mesh=None):
    windtype, block = SOLVERS[solver]
    return ideal_ridge_model(**CASE, windtype=windtype,
                             options_cb=options_cb(block), mesh=mesh,
                             device="cpu")


def attached(model, mesh):
    """A copy of ``model`` with ``mesh`` attached."""
    m = copy.deepcopy(model)
    m.attach_mesh(mesh)
    return m


def run(m):
    """bench.py's linear loop: a wind update, then an interval, twice."""
    steps = []
    for _ in range(2):
        m.update_winds()
        m.advance(INTERVAL)
        steps.append(m.last_n_substeps)
    return steps


def mismatches(one, other, names):
    return [k for k in names
            if not np.array_equal(one.field(k).view(np.uint32),
                                  other.field(k).view(np.uint32))]


@pytest.fixture(scope="module", params=sorted(SOLVERS))
def unsharded(request):
    """(solver, the unsharded model after its run, its substeps, a copy
    of it as built)."""
    m = build(request.param)
    built = copy.deepcopy(m)
    return request.param, m, run(m), built


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_equals_unsharded(unsharded, mesh):
    solver, one, steps, built = unsharded
    shape, early = MESHES[mesh]
    mesh = Mesh(["cpu"] * 4, shape)
    m = build(solver, mesh) if early else attached(built, mesh)
    assert m.layout is not None and len(m.blocks) == 4
    assert run(m) == steps
    assert mismatches(one, m, sorted(one.state)) == []
    assert m.digest() == one.digest()
    for name in ("u_perturbation", "v_perturbation"):
        a, b = getattr(one, name), getattr(m, name)
        assert b.device == m.device and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    # linear theory moved v off the balance-only ridge's 0; blocking ran
    assert np.abs(m.field("v")).max() > 0.1
    assert (m._blocking is not None) == SOLVERS[solver][1]


def test_mesh_argument_equals_attaching_after_building(unsharded):
    """``ideal_ridge_model(mesh=...)`` against attaching the mesh to the
    built model: at set-up every field equal but those formed from the
    winds, which both packages refresh at the next interval (so equal
    after it; the two-interval runs above hold the rest)."""
    solver, _, _, built = unsharded
    mesh = Mesh(["cpu"] * 4, (2, 2))
    early, late = build(solver, mesh), attached(built, mesh)
    names = sorted(late.blocks[0])
    assert mismatches(early, late, names) == list(WIND_DIAGNOSTICS)
    for m in (early, late):
        m.advance(INTERVAL)
    assert mismatches(early, late, names) == []

"""The port's column physics on a mesh (``ICARModel.attach_mesh`` with
column physics, ``core/step.py`` ``run_interval_physics`` on blocks; the
JAX package's ``attach_mesh`` accepts them all, and ``bench.py --config
conus`` is its full physics column on a mesh) against the same port
model unsharded, on CPU devices, with no JAX computation: the same
substep count, every bit of every field of the state and the same
``ICARModel.digest``, on a 2x2 mesh and a 1x4 mesh (the small cases have
12 rows, too few for four shards in y), with a v flow across the shard
edges.

The cases are ``chip_smoke.sharded_small_cases`` (which phase 19 runs on
the card): sets of options on the small full-physics case that together
run every column option -- bench.py's conus schemes (Thompson, Tiedtke,
Noah, the simple PBL, simple radiation, simple water) with boundary
forcing of the species and a rain fraction, set before attach_mesh on the
1x4 mesh and after it on the 2x2 one; SB04 with MPDATA; Kain-Fritsch with
WSM3; NSAS with WSM6, YSU and RRTMG with Noah; BMJ with Morrison and the
CLM lake; the aerosol-aware Thompson scheme with RRTMG, YSU and Noah-MP.
Every convection scheme rains. RRTMG's
McICA chunks are cut to 64 columns here, so that a block's columns come
from several of the domain's chunks (``rrtmg_lw.BlockCdf``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from icar_tpu_torch import constants as C
from icar_tpu_torch.parallel.mesh import Mesh
from icar_tpu_torch.physics import rrtmg_lw

torch.set_num_threads(1)

MESHES = ((2, 2), (1, 4))
# McICA chunks of this many columns: the small domain's 360 take six
RRTMG_CHUNK = 64


def _run(name, monkeypatch, mesh=None):
    monkeypatch.setattr(rrtmg_lw, "RRTMG_COL_CHUNK", RRTMG_CHUNK)
    return cs.sharded_small_run(
        name, "cpu", mesh and Mesh(["cpu"] * (mesh[0] * mesh[1]), mesh),
        late=mesh == (2, 2))


@pytest.fixture(scope="module")
def unsharded():
    """The cases run unsharded, each once for both meshes."""
    runs = {}
    mp = pytest.MonkeyPatch()

    def get(name):
        if name not in runs:
            runs[name] = _run(name, mp)
            mp.undo()
        return runs[name]
    yield get
    mp.undo()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(cs.sharded_small_cases()))
def test_sharded_column_physics_is_bit_exact(name, mesh, unsharded,
                                             monkeypatch):
    one = unsharded(name)
    sharded = _run(name, monkeypatch, mesh)
    assert sharded.state is None and len(sharded.blocks) == 4
    assert sharded.last_n_substeps == one.last_n_substeps >= 2
    for k in one.state:
        assert np.isfinite(one.field(k)).all(), k
        assert sharded.field(k).dtype == np.float32, k
    assert cs.bit_mismatches(one, sharded) == []
    assert sharded.digest() == one.digest()
    assert np.abs(one.field("v")).max() > 2.0
    assert one.field("precipitation").max() > 0.0
    if one.options.physics.convection != C.CU_NONE:
        assert one.field("convective_precipitation").max() > 0.0

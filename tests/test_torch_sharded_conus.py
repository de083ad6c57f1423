"""bench.py --config conus's schemes on a mesh: the port's sharded model
(``ICARModel.attach_mesh`` with the full physics column: Thompson with
upwind advection, wind=2, simple radiation, Noah with simple water, the
simple PBL and Tiedtke convection) on a 2x2 mesh of CPU devices against
the JAX package's sharded model on a 2x2 mesh of four of the eight
virtual CPU devices (``tests/conftest.py``), jitted once, over one 600 s
interval of tests/test_torch_fullphys.py's small case (its water strip
set), at the bounds that file holds the unsharded port to: the same 24
substeps, the advected species within 1e-4 of their largest magnitude,
every other field within 1e-3, the cloud fraction and longwave
(ill-conditioned where a column holds almost no condensate) beyond 1e-3
in at most 5% of the columns. The port's sharded run equals its
unsharded one bit for bit (tests/test_torch_sharded_physics.py), so this
holds the sharded port to the JAX package's sharded reference under
GSPMD (its padded frame and halo collectives).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh as JaxMesh

from icar_tpu import constants as JC
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.models.icar import FULLPHYS, ideal_ridge_model
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

CASE = dict(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0, u_speed=9.0,
            rh=1.0)
JAX_FULLPHYS = dict(mp=JC.MP_THOMPSON, windtype=JC.WIND_CONSERVE_MASS,
                    rad=JC.RA_SIMPLE, pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH,
                    water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE)
ILL_CONDITIONED = ("cloud_fraction", "longwave")


def _worst(got, want):
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def test_sharded_conus_matches_the_jax_sharded_model():
    mj = jax_model(**CASE, **JAX_FULLPHYS)
    lm = np.asarray(mj.state["land_mask"]).copy()
    lm[:, :10] = 2.0
    mj.state = dict(mj.state)
    mj.state["land_mask"] = jnp.asarray(lm)
    mt = ideal_ridge_model(**CASE, **FULLPHYS, device="cpu")
    mt.state = state_from_numpy({k: np.asarray(v)
                                 for k, v in mj.state.items()}, "cpu")
    mj.attach_mesh(JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                           ("y", "x")))
    mt.attach_mesh(Mesh(["cpu"] * 4, (2, 2)))
    mj.advance(600.0)
    mt.advance(600.0)
    assert mt.last_n_substeps == int(mj.last_n_substeps) == 24
    held = sorted(mt.blocks[0])
    assert len(held) > 40
    for k in held:
        got, want = mt.field(k), np.asarray(mj.field(k))
        assert got.shape == want.shape, k
        if k in ILL_CONDITIONED:
            rel = np.abs(got - want) / np.abs(want).max()
            assert (rel > 1e-3).mean() <= 0.05, k
        else:
            bound = 1e-4 if k in mt.advect_names else 1e-3
            assert _worst(got, want) <= bound, k
    for f in (mt.field, mj.field):
        assert np.asarray(f("convective_precipitation")).max() > 0
        sh = np.asarray(f("sensible_heat"))
        assert sh.min() < 0 < sh.max()

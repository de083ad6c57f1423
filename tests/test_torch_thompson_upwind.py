"""Thompson microphysics with upwind advection (mp=1, adv=1) without the
column physics: the port's general loop with K5 and K1 (their plain
versions on the CPU) against the JAX package's general loop, and sharded
against unsharded.

(a) The port starts from the JAX model's state (convert.state_from_numpy)
and runs one 900 s interval beside it: the same substep count, the species
within rtol 1e-3 and atol 1e-6 (the number mixing ratios atol 1e-2), the
accumulators within rtol 1e-4 and atol 1e-7 -- the bounds
tests/test_torch_thompson_model.py holds the Thompson ridge to (the JAX
loop is jitted and contracts multiply-adds; observed, 17 substeps: theta
9.2e-5 K, cloud water 2.6e-8 of 1.2e-3, rain number 0.093 kg-1 of 1.1e4,
precipitation 3.3e-7 mm of 0.027). (b) The
same model sharded on a 2x2 mesh of CPU devices with a v flow across the
shards gives the unsharded substeps and digest exactly.
"""

import numpy as np
import torch

from icar_tpu import constants as JC
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import path_kernels
from icar_tpu_torch.forcing.ideal import make_ideal_case
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

CASE = dict(nx=48, ny=20, nz=12, dx=1000.0, hill_height=800.0, u_speed=11.0,
            rh=1.0)


def test_thompson_upwind_interval_matches_jax():
    mj = jax_model(**CASE, mp=JC.MP_THOMPSON, adv=JC.ADV_UPWIND)
    mt = ideal_ridge_model(**CASE, mp=C.MP_THOMPSON, device="cpu")
    assert path_kernels(mt.options) == ("mp_thompson", "advect_upwind")
    mt.state = state_from_numpy({k: np.asarray(v)
                                 for k, v in mj.state.items()}, "cpu")
    mj.advance(900.0)
    mt.advance(900.0)
    assert mt.last_n_substeps == mj.last_n_substeps > 10
    for k in mt.advect_names:
        atol = 1e-2 if k.endswith("_number") else 1e-6
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-3, atol=atol, err_msg=k)
    for k in ("precipitation", "snowfall", "graupel"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert mt.field("cloud_water").max() > 0
    assert mt.field("precipitation").max() > 0


def test_thompson_upwind_sharded_equals_unsharded():
    def model():
        m = ideal_ridge_model(nx=32, ny=24, nz=8, dx=1000.0,
                              hill_height=500.0, u_speed=10.0, rh=1.0,
                              flat_z_height=-2, mp=C.MP_THOMPSON,
                              device="cpu")
        m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                                 v_profile=5.0, rh=1.0))
        return m
    one, mesh = model(), model()
    mesh.attach_mesh(Mesh(["cpu"] * 4, (2, 2)))
    for _ in range(2):
        one.advance(300.0)
        mesh.advance(300.0)
        assert mesh.last_n_substeps == one.last_n_substeps
    assert mesh.digest() == one.digest()
    for k in one.advect_names:
        np.testing.assert_array_equal(mesh.field(k), one.field(k),
                                      err_msg=k)

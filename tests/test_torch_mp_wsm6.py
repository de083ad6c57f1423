"""The port's WSM6 (icar_tpu_torch/physics/mp_wsm6.py, mp=4) against the
JAX package's, on the CPU, as tests/test_torch_mp_wsm3.py holds WSM3
(its helpers and bound, with this scheme's ``CALL_SHARE``): tests/test_wsm6.py's columns (supersaturation,
warm rain, a cold column making ice and snow, rain freezing to graupel,
graupel melting, the conservation case, a dry column) and one seeded
mixed-phase 3-D state, on the inputs of the first and the last of each
case's steps; the whole call and every module routine it reaches (WSM3's
saturation and sedimentation among them), op by op.
"""

import jax
import numpy as np
import pytest
import torch

from icar_tpu.physics import mp_wsm6 as J
from icar_tpu_torch.physics import mp_wsm6 as T

from tests.test_torch_mp_wsm3 import (column, hold, mixed_state, record,
                                      replay, to_jax, to_numpy, to_port,
                                      trajectory)

torch.set_num_threads(1)

MIXED_SEED = 4
STEP = jax.jit(J.wsm6)
ROUTINES = ("_saturation", "_sediment", "_slope_one", "_slopes6", "_diffus",
            "_viscos", "_xka", "_diffac", "_venfac", "_scale")
# wsm6's output index -> the share of cells past the bound: in the
# warm-rain column, one level of its 320 cells (5%), where the
# condensation nearly cancels the vapour's excess over saturation (cloud
# water at 1.08 of the bound, 1.2e-6 of its largest value), and the cloud
# ice that level's water freezes into (2.55 of the bound, 2.6e-6), so
# that an ulp of the vapour's saturation value (exp and pow) shows in the
# condensate
CALL_SHARE = {2: 0.05, 3: 0.05}
# tests/test_wsm6.py's cases: (column, dt, steps)
CASES = {
    "supersaturation": (dict(rh=1.2, t_sfc=285.0), 60.0, 3),
    "autoconversion": (dict(rh=1.0, t_sfc=295.0, qc=2e-3), 60.0, 10),
    "cold_column": (dict(rh=1.1, t_sfc=260.0, qc=1e-3), 60.0, 20),
    "rain_to_graupel": (dict(rh=0.9, t_sfc=258.0, qr=2e-3), 120.0, 5),
    "graupel_melts": (dict(rh=0.95, t_sfc=300.0, qg=1e-3), 60.0, 10),
    "conservation": (dict(rh=1.05, t_sfc=285.0, qc=5e-4, qi=1e-4, qs=1e-4,
                          qg=1e-4), 60.0, 5),
    "dry": (dict(rh=0.3), 60.0, 1),
    "mixed3d": (None, 90.0, 2),
}


def _inputs(c, dt):
    zero = np.zeros(c["p"].shape[1:], np.float32)
    return (c["th"], c["qv"], c["qc"], c["qi"], c["qr"], c["qs"], c["qg"],
            c["exner"], c["p"], c["dz"], c["den"], np.float32(dt), zero,
            zero, zero)


def _update(inputs, out):
    out = to_numpy(out)
    i = list(inputs)
    i[0:7], i[12:15] = out[0:7], out[7:10]
    return tuple(i)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, dt, steps = CASES[request.param]
    c = mixed_state(MIXED_SEED) if kw is None else column(**kw)
    return request.param, trajectory(STEP, _inputs(c, dt), steps, _update)


def test_wsm6_call_and_routines_match(case):
    """The whole call and each routine it reaches on the inputs of the
    case's first and last step: within ``hold``'s bound of the JAX
    package op by op; the call's outputs all finite."""
    name, states = case
    for inputs in states:
        with record(J, ROUTINES) as log, jax.disable_jit():
            want = J.wsm6(*to_jax(inputs))
        got = T.wsm6(*to_port(inputs))
        hold(got, want, f"wsm6 {name}", CALL_SHARE)
        assert all(torch.isfinite(g).all() for g in got)
        replay(J, T, log)
    if name == "cold_column":
        # ice and snow form, as tests/test_wsm6.py checks
        assert float(got[3].max()) > 1e-7 and float(got[5].max()) > 1e-8
    if name == "rain_to_graupel":
        assert float(got[6].max()) > 1e-6


def test_snow_and_graupel_share_one_count():
    """Snow and graupel fall at their one mass-weighted velocity, so one
    host read (``_cfl``) gives both their trips: three reads a call
    (rain; snow and graupel; cloud ice)."""
    c = mixed_state(MIXED_SEED)
    reads = []
    cfl = T._cfl

    def counted(*a):
        reads.append(1)
        return cfl(*a)
    T._cfl = counted
    import icar_tpu_torch.physics.mp_wsm3 as W3
    W3_cfl, W3._cfl = W3._cfl, counted
    try:
        T.wsm6(*to_port(_inputs(c, 90.0)))
    finally:
        T._cfl, W3._cfl = cfl, W3_cfl
    assert len(reads) == 3

"""The port's Morrison scheme (icar_tpu_torch/physics/mp_morrison.py,
mp=3) against the JAX package's, on the CPU, as
tests/test_torch_mp_wsm3.py holds WSM3 (its helpers and bound, with
this scheme's ``CALL_SHARE``):
tests/test_morrison.py's columns (supersaturation, warm rain with rain
number, a cold column nucleating ice, supercooled rain freezing to
graupel, graupel melting, homogeneous freezing, the conservation case,
the number case, a dry column, and graupel with ``hail_opt=1``) and one
seeded mixed-phase 3-D state with number concentrations, on the inputs
of the first and the last of each case's steps; the whole call and every
module routine it reaches (the saturation polynomial, the gamma function
through ``lgamma``, the safe division, the size distributions and the
fall-speed factor), op by op.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import mp_morrison as J
from icar_tpu_torch.physics import mp_morrison as T

from tests.test_torch_mp_wsm3 import (column, hold, mixed_state, record,
                                      replay, to_jax, to_numpy, to_port,
                                      trajectory)

torch.set_num_threads(1)

MIXED_SEED = 5
STEP = jax.jit(J.mp_morrison, static_argnames="hail_opt")
ROUTINES = ("polysvp", "_gam", "_sd", "_psd", "_psd_cloud",
            "_fallspeed_limits")
# mp_morrison's output index -> the share of cells past the bound: a
# mass that a step consumes whole is left as rounding noise of an ulp of
# the mass (qr + dt * tendency: 0 in one package, 5.8e-11 in the other),
# which the sedimentation's QSMALL (1e-14) test then sorts, and the
# fall-speed fill cascades that level's fall speed down the column; the
# numbers below, which no size clamp resets, follow (observed: the snow
# number of the mixed state in 3 of 360 cells, the rain number of the
# number case in one level of its 320 cells)
CALL_SHARE = {8: 0.01, 9: 0.05}


def _qsat(t, p):
    """tests/test_morrison.py's saturation over water (the Flatau
    polynomial)."""
    es = np.asarray(J.polysvp(jnp.asarray(t), False))
    return J.EP_2 * es / (p - es)


# tests/test_morrison.py's cases: (column, dt, steps, keywords)
CASES = {
    "supersaturation": (dict(rh=1.2, t_sfc=285.0), 60.0, 3, {}),
    "autoconversion": (dict(rh=1.0, t_sfc=295.0, qc=2e-3), 60.0, 10, {}),
    "cold_column": (dict(rh=1.15, t_sfc=255.0, qc=1e-3), 60.0, 20, {}),
    "supercooled_rain": (dict(rh=0.9, t_sfc=258.0, qr=2e-3, nr=2e6), 120.0,
                         5, {}),
    "graupel_melts": (dict(rh=0.95, t_sfc=300.0, qg=1e-3, ng=1e4), 60.0, 10,
                      {}),
    "homogeneous_freezing": (dict(rh=0.95, t_sfc=230.0, qc=5e-4), 60.0, 1,
                             {}),
    "conservation": (dict(rh=1.05, t_sfc=285.0, qc=5e-4, qi=1e-4, qs=1e-4,
                          qg=1e-4, ni=1e5, ns=1e4, ng=1e3), 60.0, 5, {}),
    "numbers": (dict(rh=1.1, t_sfc=270.0, qc=1e-3, qr=5e-4, qs=5e-4,
                     qg=2e-4, ni=1e4, ns=1e4, nr=1e5, ng=1e3), 90.0, 10, {}),
    "dry": (dict(rh=0.3), 60.0, 1, {}),
    "hail": (dict(rh=0.95, t_sfc=275.0, qg=1e-3, ng=1e4), 60.0, 5,
             dict(hail_opt=1)),
    "mixed3d": (None, 90.0, 2, {}),
}


def _inputs(c, dt):
    zero = np.zeros(c["p"].shape[1:], np.float32)
    return tuple(c[k] for k in ("th", "qv", "qc", "qi", "qr", "qs", "qg",
                                "ni", "ns", "nr", "ng", "exner", "p", "dz",
                                "w")) + (np.float32(dt), zero, zero, zero)


def _update(inputs, out):
    out = to_numpy(out)
    i = list(inputs)
    i[0:11], i[16:19] = out[0:11], out[11:14]
    return tuple(i)


def _state(kw):
    if kw is None:
        return mixed_state(MIXED_SEED, numbers=True)
    return column(**kw, sat=_qsat)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, dt, steps, extra = CASES[request.param]
    step = functools.partial(STEP, **extra)
    return (request.param, extra,
            trajectory(step, _inputs(_state(kw), dt), steps, _update))


def test_morrison_call_and_routines_match(case):
    """The whole call and each routine it reaches on the inputs of the
    case's first and last step: within ``hold``'s bound of the JAX
    package op by op; the call's outputs all finite, the numbers never
    negative."""
    name, extra, states = case
    for inputs in states:
        with record(J, ROUTINES) as log, jax.disable_jit():
            want = J.mp_morrison(*to_jax(inputs), **extra)
        got = T.mp_morrison(*to_port(inputs), **extra)
        hold(got, want, f"mp_morrison {name}", CALL_SHARE)
        assert all(torch.isfinite(g).all() for g in got)
        assert all((g >= 0).all() for g in got[7:11])
        replay(J, T, log)
    if name == "cold_column":
        # ice nucleates, as tests/test_morrison.py checks
        assert float(got[3].max()) > 1e-8 and float(got[7].max()) > 1.0
    if name == "supercooled_rain":
        assert float(got[6].max()) > 1e-6 and float(got[10].max()) > 0


def test_the_hail_constants_differ():
    """hail_opt=1 takes the denser, faster hail parameters (the JAX
    package's _Consts, copied)."""
    assert T._CONSTS[1].RHOG > T._CONSTS[0].RHOG
    assert T._CONSTS[1].AG == J._CONSTS[1].AG and \
        T._CONSTS[0].CONS41 == J._CONSTS[0].CONS41


def test_one_host_read_a_call():
    """The sedimentation's largest substep count is the call's one read
    back to the host (``.item()``; none of ``nonzero``, ``.any()`` or a
    boolean index)."""
    c = mixed_state(MIXED_SEED, numbers=True)
    reads = []
    item = torch.Tensor.item

    def counted(self):
        reads.append(1)
        return item(self)
    torch.Tensor.item = counted
    try:
        T.mp_morrison(*to_port(_inputs(c, 90.0)))
    finally:
        torch.Tensor.item = item
    assert len(reads) == 1

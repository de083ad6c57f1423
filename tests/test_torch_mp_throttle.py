"""The microphysics throttle (``mp.update_interval > 0``) in the port
against the JAX package, on the CPU.

The JAX general loop runs the microphysics under ``lax.cond`` on a float32
counter that starts full at every interval (icar_tpu/core/step.py
:1124-1137, :1790-1795); the port's loops replay it on the host
(``core.step.Throttle``). Each call's dt is recorded on both sides (the
JAX package's scheme wrapped with a ``jax.debug.callback`` before its step
is traced; the port's wrappers in ``ops/kernels.py`` wrapped likewise): the
same calls with the same dt, bit for bit, and the first call of the
interval integrating the update interval plus the first substep. Then the
fields: SB04 + upwind (K3's and K1's plain versions) at rtol 1e-5, atol
1e-7 (precipitation rtol 1e-4) over five substeps, on
tests/test_torch_model.py's MPDATA ridge geometry at rh 0.9 (off SB04's
revert edge); Thompson + MPDATA (K5's and K4's) over three substeps at
tests/test_torch_thompson_model.py's tight bounds. Sharded SB04 + upwind
with the throttle equals the unsharded run bit for bit.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu.physics import mp_simple as jmp_simple
from icar_tpu.physics import mp_thompson as jmp_thompson
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import Throttle, path_kernels, quantized_dt
from icar_tpu_torch.forcing.ideal import make_ideal_case
from icar_tpu_torch.models.icar import (MP_THROTTLE_INTERVAL,
                                        ideal_ridge_model,
                                        mp_throttle_options)
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

SB04_CASE = dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1200.0,
                 u_speed=10.0, rh=0.9)
# tests/test_torch_thompson_model.py's case
THOMPSON_CASE = dict(nx=48, ny=20, nz=12, dx=1000.0, hill_height=800.0,
                     u_speed=11.0, rh=1.0)
PATHS = {"SB04": (SB04_CASE, dict(), jmp_simple, "mp_simple",
                  "mp_simple_rho"),
         "Thompson": (THOMPSON_CASE, dict(mp=C.MP_THOMPSON,
                                          adv=C.ADV_MPDATA),
                      jmp_thompson, "mp_thompson", "mp_thompson_stack")}
JAX_OPTS = {"SB04": dict(), "Thompson": dict(mp=JC.MP_THOMPSON,
                                             adv=JC.ADV_MPDATA)}


def _recording(fn, calls):
    """``fn`` with each call's dt appended to ``calls`` when the step
    runs."""
    sig = inspect.signature(fn)

    def wrapped(*args, **kw):
        dt = sig.bind(*args, **kw).arguments["dt"]
        jax.debug.callback(lambda d: calls.append(np.float32(d)), dt,
                           ordered=True)
        return fn(*args, **kw)
    return wrapped


@pytest.fixture(scope="module", params=sorted(PATHS))
def throttled(request):
    """(path, JAX model with the throttle, its initial state as numpy, the
    list its scheme's calls append their dt to). The scheme is wrapped
    until the module's tests end; the JAX model's step is traced at its
    first advance, with the wrapper in it."""
    path = request.param
    case, _, module, name, _ = PATHS[path]
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(module, name, _recording(getattr(module, name), calls))
    mj = jax_model(**case, **JAX_OPTS[path], options_cb=mp_throttle_options)
    yield path, mj, {k: np.asarray(v) for k, v in mj.state.items()}, calls
    mp.undo()


def _run(throttled, monkeypatch, n_substeps):
    """Both models over ``n_substeps`` substeps less half of one, from the
    JAX model's initial state: (JAX model, port model, JAX calls' dt, the
    port's calls' dt, the port's substep dt)."""
    path, mj, initial, jax_calls = throttled
    case, opts, _, _, kernel = PATHS[path]
    mt = ideal_ridge_model(**case, **opts, options_cb=mp_throttle_options,
                           device="cpu")
    mt.state = state_from_numpy(initial, "cpu")
    mj.state = {k: jnp.array(v) for k, v in initial.items()}
    port_calls = []
    orig = getattr(kernels, kernel)

    def recorded(*args, **kw):
        port_calls.append(np.float32(
            inspect.signature(orig).bind(*args, **kw).arguments["dt"]))
        return orig(*args, **kw)
    monkeypatch.setattr(kernels, kernel, recorded)
    s, g = mt.state, mt.geom_t
    dt = quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx, 0.9, 3)
    seconds = float(np.float32(n_substeps - 0.5) * dt)
    jax_calls.clear()
    mj.advance(seconds)
    jax.effects_barrier()
    mt.advance(seconds)
    assert mt.last_n_substeps == mj.last_n_substeps == n_substeps
    return mj, mt, list(jax_calls), port_calls, dt


def _replay(dt, n_substeps):
    """The dt of each call the port's counter predicts for ``n_substeps``
    substeps of ``dt``, the last of half a substep."""
    th = Throttle(MP_THROTTLE_INTERVAL)
    lengths = [dt] * (n_substeps - 1) + [np.float32(np.float32(
        n_substeps - 0.5) * dt - np.float32(dt * (n_substeps - 1)))]
    return [d for d in map(th.step, lengths) if d is not None]


def test_throttled_calls_match_jax(throttled, monkeypatch):
    """The same calls with the same dt, bit for bit, in both packages, as
    the host's counter predicts; fewer calls than substeps; the first
    call integrates the update interval plus the first substep (the
    counter restarts full at each interval, ROADMAP section 3); the calls
    integrate more time than passes."""
    path = throttled[0]
    n = 5 if path == "SB04" else 3
    mj, mt, jax_calls, port_calls, dt = _run(throttled, monkeypatch, n)
    assert path_kernels(mt.options)[0] in ("mp_simple_rho", "mp_thompson")
    assert port_calls == jax_calls == _replay(dt, n)
    assert 1 < len(port_calls) < n
    assert port_calls[0] == np.float32(MP_THROTTLE_INTERVAL + dt)
    assert sum(port_calls) > (n - 0.5) * dt


def test_throttled_fields_match_jax(throttled, monkeypatch):
    """The fields after the same substeps. SB04 + upwind: prognostics at
    rtol 1e-5, atol 1e-7, precipitation and snowfall rtol 1e-4, atol
    1e-7. Thompson + MPDATA: species rtol 1e-3, atol 1e-7 (number
    mixing ratios atol 2e-2), accumulators rtol 1e-4, atol 1e-9 (the
    Thompson ridge's three-substep bounds)."""
    path = throttled[0]
    n = 5 if path == "SB04" else 3
    mj, mt, *_ = _run(throttled, monkeypatch, n)
    accum = [k for k in ("precipitation", "snowfall", "graupel")
             if k in mt.state]
    if path == "SB04":
        rtol, atol, number_atol, arts, aatol = 1e-5, 1e-7, None, 1e-4, 1e-7
    else:
        rtol, atol, number_atol, arts, aatol = 1e-3, 1e-7, 2e-2, 1e-4, 1e-9
    for k in mt.advect_names:
        a = number_atol if k.endswith("_number") else atol
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=rtol, atol=a, err_msg=k)
    for k in accum:
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=arts, atol=aatol, err_msg=k)
    assert mt.field("cloud_water").max() > 0


def test_throttle_counter():
    """``Throttle``: every substep without an interval; with one, the
    first substep, then whenever the float32 counter reaches the interval
    less 1e-6 s, over the counter's time."""
    off = Throttle(0.0)
    assert [off.step(np.float32(d)) for d in (20.0, 30.0)] == [20.0, 30.0]
    th = Throttle(60.0)
    got = [th.step(np.float32(d)) for d in (25.0, 25.0, 25.0, 10.0, 30.0)]
    assert got == [85.0, None, None, 60.0, None]
    assert all(isinstance(g, np.float32) for g in got if g is not None)


def test_sharded_throttle_is_bit_exact():
    """SB04 + upwind with the throttle, sharded 2x2 over two 300 s
    intervals with a v flow across the shards: the same substeps, every
    field bit for bit and the same digest."""
    case = dict(nx=48, ny=32, nz=8, dx=1000.0, hill_height=500.0,
                u_speed=10.0, flat_z_height=-2, rh=1.0)
    models = []
    for _ in range(2):
        m = ideal_ridge_model(**case, options_cb=mp_throttle_options,
                              device="cpu")
        m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                                 v_profile=5.0, rh=1.0))
        models.append(m)
    one, sharded = models
    sharded.attach_mesh(Mesh(["cpu"] * 4, (2, 2)))
    for _ in range(2):
        one.advance(300.0)
        sharded.advance(300.0)
        assert sharded.last_n_substeps == one.last_n_substeps >= 5
    assert one.field("precipitation").max() > 0.0
    for k in sorted(one.state):
        np.testing.assert_array_equal(sharded.field(k), one.field(k),
                                      err_msg=k)
    assert sharded.digest() == one.digest()

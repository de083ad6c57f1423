"""The port's WSM3 (icar_tpu_torch/physics/mp_wsm3.py, mp=6) against the
JAX package's, on the CPU.

The cases are tests/test_wsm3.py's columns (supersaturation, warm rain,
a cold column making snow, the conservation case, a dry column) with
their time steps and step counts, and one seeded mixed-phase 3-D state
(``mixed_state``: a freezing level inside most columns, w_real of both
signs, so that the melt and freeze levels differ, and every species
zero in some cells). The JAX package steps each case forward jitted; the
inputs of its first and its last step are then run through the JAX
function op by op (``jax.disable_jit()``), which records the arguments of
every module routine it reaches (``record``), and through the port. Each
output of the whole call and of every recorded routine call is held to
``hold``: within rtol 1e-5 plus an atol of 1e-6 of the field's largest
magnitude (exp and pow round apart between the libraries by an ulp, and
the port divides by a constant as a product with its float32 reciprocal,
as the JAX package's compiled step does); the share of cells past that
bound at most ``SHARE`` of the field, or the share ``CALL_SHARE`` states
for an output of the whole call. Integer outputs are equal.

tests/test_torch_mp_wsm6.py and tests/test_torch_mp_morrison.py use the
helpers here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.physics import mp_wsm3 as J
from icar_tpu_torch.physics import mp_wsm3 as T

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# the share of a field's cells allowed past the bound, unless stated
SHARE = 0.0


def column(nz=20, ny=4, nx=4, t_sfc=290.0, rh=0.5, **species):
    """tests/test_wsm3.py's column (and test_wsm6.py's, test_morrison.py's,
    whose humidity follows the Flatau saturation over water: ``sat``):
    numpy fields by name, every species (qc, qi, qr, qs, qg and the
    numbers ni, ns, nr, ng) uniform at its ``species`` value."""
    sat = species.pop("sat", None)
    dz = np.full((nz, ny, nx), 500.0, np.float32)
    z = np.cumsum(dz, axis=0) - 250.0
    p = (1e5 * np.exp(-z / 8000.0)).astype(np.float32)
    t = (t_sfc - 0.0065 * z).astype(np.float32)
    exner = ((p / 1e5) ** (JC.RD / JC.CP)).astype(np.float32)
    th = (t / exner).astype(np.float32)
    den = (p / (J.RD * t)).astype(np.float32)
    if sat is None:
        qs, _ = J._saturation(jnp.asarray(t), jnp.asarray(p))
        qsat = np.asarray(qs)
    else:
        qsat = sat(t, p)
    f = lambda v: np.full((nz, ny, nx), v, np.float32)
    out = dict(th=th, qv=(rh * qsat).astype(np.float32), exner=exner, p=p,
               dz=dz, den=den, w=f(0.0))
    for k in ("qc", "qi", "qr", "qs", "qg", "ni", "ns", "nr", "ng"):
        out[k] = f(species.get(k, 0.0))
    return out


def mixed_state(seed, nz=12, ny=5, nx=6, numbers=False):
    """A seeded mixed-phase state: levels of 200-600 m, surface air of
    268-300 K cooling at 6.5 K/km (a freezing level inside most columns),
    humidity 70-115% of saturation over water, each species zero in about
    half the cells and log-uniform in 1e-7..2e-3 elsewhere (with
    ``numbers``, the number concentrations where their mass is), w of
    +-2 m/s."""
    r = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    dz = np.broadcast_to(r.uniform(200.0, 600.0, (nz, 1, 1)),
                         shape).astype(np.float32)
    z = np.cumsum(dz, axis=0) - dz / 2
    t = (r.uniform(268.0, 300.0, (ny, nx)) - 0.0065 * z).astype(np.float32)
    p = (1e5 * np.exp(-z / 8000.0)).astype(np.float32)
    exner = ((p / 1e5) ** (JC.RD / JC.CP)).astype(np.float32)
    qs, _ = J._saturation(jnp.asarray(t), jnp.asarray(p))
    out = dict(th=(t / exner).astype(np.float32), exner=exner, p=p, dz=dz,
               den=(p / (J.RD * t)).astype(np.float32),
               qv=(r.uniform(0.7, 1.15, shape) * np.asarray(qs))
               .astype(np.float32),
               w=r.uniform(-2.0, 2.0, shape).astype(np.float32))
    for k in ("qc", "qi", "qr", "qs", "qg"):
        q = np.exp(r.uniform(np.log(1e-7), np.log(2e-3), shape))
        out[k] = np.where(r.uniform(size=shape) < 0.5, 0.0, q) \
            .astype(np.float32)
    for k, q, lo, hi in (("ni", "qi", 1e3, 1e6), ("ns", "qs", 1e3, 1e5),
                         ("nr", "qr", 1e3, 1e6), ("ng", "qg", 1e2, 1e4)):
        n = np.exp(r.uniform(np.log(lo), np.log(hi), shape))
        out[k] = np.where((out[q] > 0) & numbers, n, 0.0).astype(np.float32)
    return out


def to_port(x):
    """A JAX argument as the port takes it: arrays as tensors (0-d ones
    too), containers recursively, numbers as they are."""
    if isinstance(x, (jax.Array, np.ndarray, np.generic)):
        return torch.as_tensor(np.array(x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def to_jax(x):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_jax(v) for v in x)
    return x


def to_numpy(x):
    if isinstance(x, (jax.Array, torch.Tensor, np.generic)):
        return np.array(x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


class record:
    """Within the ``with``, every call of the functions ``names`` of the
    JAX module ``module`` appends (name, args, kwargs) as numpy to the
    list it gives, at most ``calls`` of each (the JAX functions call one
    another by their module's globals, so each call is seen)."""

    def __init__(self, module, names, calls=2):
        self.module, self.names, self.calls = module, names, calls
        self.log = []

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            def wrap(*a, _n=n, _fn=fn, **k):
                if sum(e[0] == _n for e in self.log) < self.calls:
                    self.log.append((_n, to_numpy(a), to_numpy(k)))
                return _fn(*a, **k)
            setattr(self.module, n, wrap)
        return self.log

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)
        return False


def hold(got, want, what, share=None):
    """Each output of ``got`` (the port's) within RTOL plus ATOL of the
    largest magnitude of ``want`` (the JAX package's), finite where
    ``want`` is; past that bound in at most ``share`` of the cells (SHARE
    by default; {output index: share} for some); integers equal. Returns
    the largest difference over the largest magnitude."""
    got = got if isinstance(got, (list, tuple)) else (got,)
    want = want if isinstance(want, (list, tuple)) else (want,)
    assert len(got) == len(want), what
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(to_numpy(g)), np.asarray(to_numpy(w))
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
            continue
        assert g.shape == w.shape, (what, i)
        g, w = g.astype(np.float64), w.astype(np.float64)
        assert (np.isfinite(g) == np.isfinite(w)).all(), (what, i)
        ok = np.isfinite(w)
        scale = float(np.abs(w[ok]).max()) if ok.any() else 0.0
        d = np.abs(g - w)[ok]
        beyond = d > RTOL * np.abs(w[ok]) + ATOL * scale
        allowed = (share or {}).get(i, SHARE)
        assert beyond.mean() <= allowed if beyond.size else True, (
            f"{what}[{i}]: {beyond.mean():.4f} of the cells past rtol "
            f"{RTOL} + {ATOL} of {scale:.3e}; largest difference "
            f"{d.max():.3e}")
        if d.size and scale > 0:
            worst = max(worst, float(d.max()) / scale)
    return worst


def trajectory(step, inputs, steps, update):
    """The inputs of the first and the last of ``steps`` calls of
    ``step`` (the JAX function jitted once a module, so that the cases of
    one shape share its compilation; ``update(inputs, outputs)`` gives the
    next call's inputs): [first, last] (one entry for one step)."""
    seen = [inputs]
    for i in range(steps - 1):
        inputs = update(inputs, step(*to_jax(inputs)))
    if steps > 1:
        seen.append(to_numpy(tuple(inputs)))
    return seen


def replay(jax_module, port_module, log, share=None):
    """Run each recorded routine call in the JAX package op by op and in
    the port on the same arguments; hold the outputs (``hold``)."""
    assert log
    for name, a, k in log:
        with jax.disable_jit():
            want = getattr(jax_module, name)(*to_jax(a), **to_jax(k))
        got = getattr(port_module, name)(*to_port(a), **to_port(k))
        hold(got, want, name, (share or {}).get(name))


# ---------------------------------------------------------------------------
# WSM3
# ---------------------------------------------------------------------------

ROUTINES = ("_saturation", "_slopes", "_sediment")
STEP = jax.jit(J.wsm3)
# wsm3's output index -> the share of cells past the bound: the cloud
# water of the warm-rain column, one level of its 320 cells (5%) at 1.09
# of the bound (1.1e-6 of the largest value), where the condensation
# nearly cancels the vapour's excess over saturation, so that an ulp of
# the vapour's saturation value (exp and pow) shows in the condensate
CALL_SHARE = {2: 0.05}
# tests/test_wsm3.py's cases: (column, dt, steps)
CASES = {
    "supersaturation": (dict(rh=1.2, t_sfc=285.0), 60.0, 3),
    "autoconversion": (dict(rh=1.0, t_sfc=295.0, qc=2e-3), 60.0, 10),
    "cold_column": (dict(rh=1.1, t_sfc=265.0, qc=1e-3), 60.0, 20),
    "conservation": (dict(rh=1.05, t_sfc=285.0, qc=5e-4), 60.0, 5),
    "dry": (dict(rh=0.3), 60.0, 1),
    "mixed3d": (None, 90.0, 2),
}


def _inputs(c, dt):
    zero = np.zeros(c["p"].shape[1:], np.float32)
    return (c["th"], c["qv"], c["qc"], c["qr"], c["w"], c["exner"], c["p"],
            c["dz"], c["den"], np.float32(dt), zero, zero)


def _update(inputs, out):
    th, qv, qci, qrs, rain, snow = to_numpy(out)
    i = list(inputs)
    i[0:4], i[10:12] = (th, qv, qci, qrs), (rain, snow)
    return tuple(i)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, dt, steps = CASES[request.param]
    c = mixed_state(3) if kw is None else column(**kw)
    return request.param, trajectory(STEP, _inputs(c, dt), steps, _update)


def test_wsm3_call_and_routines_match(case):
    """The whole call and each routine it reaches on the inputs of the
    case's first and last step: within ``hold``'s bound of the JAX
    package op by op; the call's outputs all finite."""
    name, states = case
    for inputs in states:
        with record(J, ROUTINES) as log, jax.disable_jit():
            want = J.wsm3(*to_jax(inputs))
        got = T.wsm3(*to_port(inputs))
        hold(got, want, f"wsm3 {name}", CALL_SHARE)
        assert all(torch.isfinite(g).all() for g in got)
        replay(J, T, log)
    if name == "cold_column":
        # snow falls and reaches the ground, as tests/test_wsm3.py checks
        assert float(got[3].max()) > 1e-7 and float(got[5].max()) > 0


def test_the_freeze_and_melt_levels_differ_in_the_mixed_state():
    """The mixed state reaches the one-hot writes with the freezing level
    above the melting level (w_real > 0 there) in some columns and equal
    in others, so both writes and their overlap are held above."""
    c = mixed_state(3)
    warm = c["th"] * c["exner"] >= J.T0C
    nz = warm.shape[0]
    mstep = np.where(warm, np.arange(nz)[:, None, None], -1).max(axis=0)
    m0 = np.maximum(mstep, 0)
    w_at = np.take_along_axis(c["w"], m0[None], axis=0)[0]
    lifted = (w_at > 0) & (mstep >= 0) & (m0 < nz - 1)
    assert lifted.any() and (~lifted & (mstep >= 0)).any()


def test_sediment_reads_its_count_once_and_extra_trips_change_nothing():
    """``_sediment`` runs the domain's largest CFL count of trips (one
    host read, ``_cfl``); handed a larger count it gives the same bits,
    each trip being masked per column."""
    c = mixed_state(5)
    q, den, dz = (torch.as_tensor(c[k]) for k in ("qr", "den", "dz"))
    vt = torch.as_tensor(np.random.default_rng(1).uniform(
        0.0, 9.0, q.shape).astype(np.float32))
    dt = torch.tensor(120.0)
    cfl, n = T._cfl(vt, dz, dt)
    assert n == int(cfl.max()) > 1
    a = T._sediment(q, vt, den, dz, dt)
    b = T._sediment(q, vt, den, dz, dt, (cfl, n + 3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)

"""The port's NSAS convection (icar_tpu_torch/physics/cu_nsas.py, conv=4)
against the JAX package's, on the CPU.

The columns are tests/test_nsas.py's: a deep unstable column over land,
the same under subsidence over sea and perturbed from a seed
(temperature +-1 K, humidity 90-110%, w of -0.5..1 m/s, every cell its
own draw), a stable one; and a moist mixed layer capped by an
isothermal layer at 1200 m (``capped_column``), where the deep trigger
fails in every column and the shallow scheme mixes under a PBL of 1200 m
(``hpbl`` > 0, a strong surface buoyancy flux; tests/test_nsas.py's own
shallow column convects deep). Each case's
whole call goes through the JAX function jitted (one compilation, every
case 30 levels deep) and through the port. The JAX function run op by op
(``jax.disable_jit()``, 14 s at 30 levels) runs once, on a 16-level
column with one cloud class (``mp_physics`` 3: ncloud 1), recording the
arguments and results of every routine it reaches (``record_calls``):
the port's call is held to that run, the saturation and level helpers
are replayed op by op, the deep and shallow schemes held to their
recorded results. Outputs are held by ``hold`` (rtol 1e-5 plus
1e-6 of the field's largest magnitude) but the condensate and the rain,
sums of a mass flux over the column, at ``SUM_ATOL``, and the vapour at
``QV_ATOL``; against the jitted runs, whose contractions move the JAX
package's own results by up to 3.1e-4 of a field, at ``JIT_BOUNDS``;
level indices are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import cu_nsas as J
from icar_tpu_torch.physics import cu_nsas as T
from test_nsas import column
from test_torch_mp_wsm3 import hold, replay, to_jax, to_numpy, to_port

torch.set_num_threads(1)

ROUTINES = ("fpvs_mb", "_qes", "_first_above", "_half_level_env",
            "_updraft_recur", "nsas_deep", "nsas_shallow")

# name -> (tests/test_nsas.py column, land_mask value, seed or None,
#          hpbl, hfx, qfx, mp_physics)
CASES = {
    "deep_land": (dict(), 1.0, None, 800.0, 150.0, 6e-5, 5),
    "deep_sea_subsiding": (dict(w_up=-0.5), 2.0, 1, 800.0, 150.0, 6e-5, 5),
    "stable": (dict(t_sfc=288.0, lapse=4.0e-3, rh=0.3, rh_top=0.3,
                    w_up=-0.05), 1.0, None, 800.0, -10.0, 0.0, 5),
    "shallow": (dict(z_inv=1200.0), 1.0, None, 1200.0, 250.0, 1.2e-4, 5),
    "mixed": (dict(), 1.0, 2, 800.0, 150.0, 6e-5, 5),
}
# against the op-by-op run: the vapour (evaporation of the falling rain,
# level by level) within rtol 1e-5 plus QV_ATOL of its largest value
# (6.0e-6 observed), the cloud water and ice (detrained from a column's
# mass flux, whose closure is a quotient of nearly cancelling work
# functions) and the rain (the column's sum of it) plus SUM_ATOL (1.2e-4
# observed)
QV_ATOL = 2e-5
SUM_ATOL = 3e-4
# against the jitted run, whose contractions move it from the op-by-op
# run by up to 1.1e-5 (theta), 7.1e-5 (vapour) and 3.1e-4 (condensate,
# rain) of each output's largest value: these bounds on the largest
# difference over the largest value
JIT_BOUNDS = (3e-5, 2e-4, 1e-3, 1e-3, 1e-3)
JITTED = {}


def capped_column(z_inv, nz=30, n=3, t_sfc=298.0, lapse=9e-3, rh=0.9,
                  rh_top=0.3, dz0=300.0):
    """A mixed layer of ``lapse`` and humidity ``rh`` up to ``z_inv``, an
    isothermal layer 1 km deep above it, then 6.5 K/km, at ``rh_top``; in
    hydrostatic balance from 1000 hPa (tests/test_nsas.py column's
    fields)."""
    dz = np.full((nz, n, n), dz0, np.float32)
    zif = np.concatenate([np.zeros((1, n, n)), np.cumsum(dz, 0)], 0)
    zl = 0.5 * (zif[:-1] + zif[1:])
    t = np.where(zl < z_inv, t_sfc - lapse * zl, t_sfc - lapse * z_inv
                 - 6.5e-3 * np.maximum(zl - z_inv - 1000.0, 0.0))
    t = t.astype(np.float32)
    p_i = np.empty((nz + 1, n, n))
    p_i[0] = 1e5
    for k in range(nz):
        p_i[k + 1] = p_i[k] * np.exp(-9.81 * dz0 / (287.0 * t[k]))
    p = np.sqrt(p_i[:-1] * p_i[1:]).astype(np.float32)
    es = 100.0 * np.asarray(J.fpvs_mb(jnp.asarray(t)))
    qv = 0.622 * es / (p - es) * np.where(zl < z_inv, rh, rh_top)
    return dict(t=t, qv=qv, p=p, p_i=p_i[:-1], rho=p / (287.0 * t),
                exner=(p / 1e5) ** (287.0 / 1004.6), dz=dz,
                w_if=np.zeros((nz + 1, n, n), np.float32))


def nsas_inputs(kw, xland, seed, hpbl, hfx, qfx, mp_physics, dt=600.0):
    """nsas's arguments (numpy, dx 1000 m): the column, perturbed from
    ``seed``; the first row of columns on the other surface."""
    c = capped_column(**kw) if "z_inv" in kw else column(**kw)
    t, qv, w_if = (np.array(c[k]) for k in ("t", "qv", "w_if"))
    if seed is not None:
        r = np.random.default_rng(seed)
        t = t + r.uniform(-1.0, 1.0, t.shape)
        qv = qv * r.uniform(0.9, 1.1, qv.shape)
        w_if = r.uniform(-0.5, 1.0, w_if.shape)
    nz, ny, nx = t.shape
    z = np.zeros((nz, ny, nx), np.float32)
    land = np.full((ny, nx), xland, np.float32)
    land[0] = 3.0 - xland
    f32 = lambda a: np.asarray(a, np.float32)
    full = lambda v: np.full((ny, nx), v, np.float32)
    return (f32(z + 5.0), f32(z + 1.0), f32(w_if), f32(t), f32(qv), z, z,
            f32(c["rho"]), f32(c["p"]), f32(c["p_i"]), f32(c["dz"]),
            f32(c["exner"]), full(hpbl), full(hfx), full(qfx), land,
            1000.0, np.float32(dt)), mp_physics


def jitted_nsas():
    """``nsas`` of the JAX package at dx 1000 m, jitted once a test
    session: (the 16 fields, dt)."""
    if not JITTED:
        JITTED["nsas"] = jax.jit(lambda *a: J.nsas(*a[:16], 1000.0, a[16]))
    return JITTED["nsas"]


class record_calls:
    """Within the ``with``, every call of the functions ``names`` of the
    JAX module ``module`` appends (name, args, kwargs, outputs) as numpy to
    the list it gives, at most ``calls`` of each: the routines' own
    results in the JAX run, to hold the port's against without running
    the routine again."""

    def __init__(self, module, names, calls=1):
        self.module, self.names, self.calls = module, names, calls
        self.log = []

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            def wrap(*a, _n=n, _fn=fn, **k):
                out = _fn(*a, **k)
                if sum(e[0] == _n for e in self.log) < self.calls:
                    self.log.append((_n, to_numpy(a), to_numpy(k),
                                     to_numpy(out)))
                return out
            setattr(self.module, n, wrap)
        return self.log

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)
        return False


def hold_nsas(got, want, what):
    """Against the op-by-op run: T (or theta) by ``hold``, the vapour
    within rtol 1e-5 plus QV_ATOL, the condensate and the rain plus
    SUM_ATOL of their largest value."""
    hold(got[0], want[0], what)
    for i, atol in ((1, QV_ATOL), (2, SUM_ATOL), (3, SUM_ATOL),
                    (4, SUM_ATOL)):
        g = np.asarray(got[i], np.float64)
        w = np.asarray(want[i], np.float64)
        bound = 1e-5 * np.abs(w) + atol * max(np.abs(w).max(), 1e-30)
        assert (np.abs(g - w) <= bound).all(), \
            (what, i, np.abs(g - w).max())


def hold_jitted(got, want, what):
    """Against the jitted run: each output's largest difference within
    its JIT_BOUNDS share of the output's largest value."""
    for i, b in enumerate(JIT_BOUNDS):
        g = np.asarray(got[i], np.float64)
        w = np.asarray(want[i], np.float64)
        assert np.abs(g - w).max() <= b * max(np.abs(w).max(), 1e-30), \
            (what, i, np.abs(g - w).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_nsas_call_matches(name):
    """The whole call (theta, vapour, cloud water, cloud ice, rain) of
    each case against the JAX package jitted (``hold_jitted``), every
    output finite."""
    args, mp = nsas_inputs(*CASES[name])
    want = jitted_nsas()(*to_jax(args[:16]), jnp.float32(args[17]))
    got = T.nsas(*to_port(args[:16]), 1000.0, args[17], mp_physics=mp)
    hold_jitted(got, want, f"nsas {name}")
    for g in got:
        assert torch.isfinite(g).all(), name


def test_nsas_op_by_op():
    """One call on a 16-level version of the perturbed deep case (dz 750
    m), with one cloud class (``mp_physics`` 3: ncloud 1, the branch the
    model never takes, ROADMAP section 3), through the JAX package op by
    op, recording each routine's arguments and results: the port's whole
    call held to it (``hold_nsas``); each routine on its recorded
    arguments -- the saturation, level-search, half-level and updraft
    helpers replayed op by op (``hold``), the deep and the shallow scheme
    held to their recorded results (``hold_nsas`` on their T, q, qc, qi,
    rain; the deep scheme's cloud base, top and flag equal)."""
    kw, xland, _, hpbl, hfx, qfx, _ = CASES["mixed"]
    args, _ = nsas_inputs(dict(kw, nz=16, dz0=750.0, ny=2), xland, 3, hpbl,
                          hfx, qfx, 3)
    with record_calls(J, ROUTINES, calls=2) as log, jax.disable_jit():
        want = J.nsas(*to_jax(args), mp_physics=3)
    got = T.nsas(*to_port(args), mp_physics=3)
    hold_nsas(got, want, "nsas op by op")
    assert float(np.asarray(want[4]).max()) > 0.0
    assert float(np.asarray(want[2]).max()) > 0.0
    assert float(np.asarray(want[3]).max()) == float(got[3].max()) == 0.0
    replay(J, T, [e[:3] for e in log if e[0] not in ("nsas_deep",
                                                     "nsas_shallow")])
    for fn in ("nsas_deep", "nsas_shallow"):
        (_, a, k, want), = [e for e in log if e[0] == fn]
        got = getattr(T, fn)(*to_port(a), **to_port(k))
        hold_nsas(got[:5], want[:5], fn)
        for g, w in zip(got[5:], want[5:]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_regimes_are_covered():
    """The cases reach both schemes: deep rain with detrained cloud water
    and ice (ncloud 2), the shallow scheme moving the
    vapour without deep rain where the deep trigger fails under a deep
    PBL, a quiet stable column; and subsidence weakens the deep rain."""
    out = {}
    for name in ("deep_land", "stable", "shallow"):
        args, mp = nsas_inputs(*CASES[name])
        out[name] = (args, T.nsas(*to_port(args), mp_physics=mp))
    args, (th, qv, qc, qi, rain) = out["deep_land"]
    assert float(rain.min()) > 0.1
    assert float(qc.max()) > 0 and float(qi.max()) > 0
    args, (th, qv, qc, qi, rain) = out["stable"]
    assert float(rain.max()) == 0.0 and float(qc.max()) == 0.0
    args, (th, qv, qc, qi, rain) = out["shallow"]
    t_new = (th * torch.as_tensor(args[11])).numpy()
    assert np.abs(t_new - args[3]).max() > 1e-3
    assert (qv.numpy() != args[4]).any()
    # the deep scheme leaves every column alone there (its flag 0)
    deep = T.nsas_deep(*_deep_args(args))
    assert int(deep[7].max()) == 0
    up, _ = nsas_inputs(*CASES["deep_land"])
    down, _ = nsas_inputs(dict(w_up=-0.5), 1.0, None, 800.0, 150.0, 6e-5,
                          5)
    assert float(T.nsas(*to_port(down))[4].mean()) \
        < float(T.nsas(*to_port(up))[4].mean())


def _deep_args(args):
    """nsas_deep's arguments for nsas's ``args`` (as ``nsas`` forms
    them)."""
    (u, v, w_if, t, qv, qc, qi, rho, p, p_i, dz, exner, hpbl, hfx, qfx,
     xland, dx, dt) = to_port(args)
    dot = -5.0e-4 * T.G * rho * (w_if[:-1] + w_if[1:])
    zii = torch.cat([torch.zeros_like(dz[:1]), torch.cumsum(dz, 0)], 0)
    zl = 0.5 * (zii[:-1] + zii[1:])
    del_cb = p * 0.001 * T.G / T.RD * dz / t
    return (dt, dx, del_cb, p * 0.01, p_i * 0.01, zl, 2, qc, qi, qv, t,
            torch.abs(xland - 2.0), dot, u, v, 1)

"""The port's Kain-Fritsch convection (icar_tpu_torch/physics/cu_kf.py,
conv=3) against the JAX package's, on the CPU.

Routine by routine: each helper of the scheme (saturation pressures, the
safe divide, saturated theta-e, the secant wet bulb, TPMIX, CONDLOAD,
DTFRZNEW, PROF5, ENVIRTHT, theta-e) on seeded values that cover its
regimes -- liquid, ice and mixed glaciation fractions, sub- and
supersaturated parcels, glaciation with and without the full flag,
mixing fractions on both sides of the profile's centre -- through the
JAX function op by op (``jax.disable_jit()``) and through the port,
held by tests/test_torch_mp_wsm3.py ``hold`` (rtol 1e-5 plus 1e-6 of
the largest magnitude). The column scheme vmaps data-dependent
``while_loop``s, which JAX runs compiled even op by op, so the column
scheme and the driver are held to the JAX package jitted: the
tendencies, the rain rate and the countdown within ``COLUMN_BOUNDS`` of
each output's largest value (the closure's iteration divides nearly
cancelling CAPE changes, and the JAX package contracts multiply-adds in
its compiled step), and the triggered columns equal. The columns are
tests/test_kf.py's soundings (unstable, stable), the unstable one
perturbed from a seed (temperature +-2 K, humidity 80-110%, w0avg of
both signs), and the unstable one perturbed under w0avg of 3 m/s on a
500 m grid, where the available mass caps the closure's factor below
0.05 and every triggered column aborts;
and KFCPS (``kfcps``) over three calls, whose NCA countdown freezes the
tendencies and then releases them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import cu_kf as J
from icar_tpu_torch.physics import cu_kf as T
from test_kf import sounding
from test_torch_mp_wsm3 import hold, to_jax, to_port

torch.set_num_threads(1)

OUTPUTS = ("dtdt", "dqdt", "dqcdt", "dqrdt", "dqidt", "dqsdt", "pratec",
           "nca")
# the largest |port - JAX jitted| over the output's largest magnitude
# (observed on these cases: 2.5e-5, 2.2e-5, 1.1e-4, 9.7e-5, 2.9e-5,
# 2.8e-5, 1.6e-5, 0)
COLUMN_BOUNDS = {"dtdt": 1e-4, "dqdt": 1e-4, "dqcdt": 5e-4, "dqrdt": 5e-4,
                 "dqidt": 2e-4, "dqsdt": 2e-4, "pratec": 1e-4, "nca": 0.0}
# case -> (tests/test_kf.py sounding, seed or None, dx)
# (the cases on the 4 km grid share one shape, and so one compilation)
CASES = {
    "unstable": (dict(ny=3, nx=4), None, 4000.0),
    "stable": (dict(t_sfc=285.0, lapse=0.0045, rh_low=0.4, rh_high=0.3,
                    w=-0.05, ny=3, nx=4), None, 4000.0),
    "mixed": (dict(ny=3, nx=4), 0, 4000.0),
    "abort": (dict(w=3.0), 1, 500.0),
}


def kf_inputs(kw, seed):
    """_kf_columns's eight fields (numpy), perturbed from ``seed``."""
    args = [np.array(a) for a in sounding(**kw)]
    if seed is not None:
        r = np.random.default_rng(seed)
        args[2] = args[2] + r.uniform(-2.0, 2.0, args[2].shape)
        args[3] = args[3] * r.uniform(0.8, 1.1, args[3].shape)
        args[7] = args[7] * r.uniform(-1.0, 2.0, args[7].shape)
    return [np.asarray(a, np.float32) for a in args]


def hold_columns(got, want, what):
    """The column outputs within COLUMN_BOUNDS, every one finite; the
    triggered columns equal."""
    for k in OUTPUTS:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        assert np.isfinite(g).all(), (what, k)
        d = np.abs(g - w).max()
        assert d <= COLUMN_BOUNDS[k] * max(np.abs(w).max(), 1e-30), \
            (what, k, d, np.abs(w).max())
    np.testing.assert_array_equal(np.asarray(got["triggered"]),
                                  np.asarray(want["triggered"]))


@pytest.fixture(scope="module")
def jitted():
    return {}


def jax_columns(jitted, args, dx):
    if dx not in jitted:
        jitted[dx] = jax.jit(lambda *a: J._kf_columns(*a[:8], a[8], dx))
    return jitted[dx](*to_jax(args), jnp.float32(90.0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kf_columns_match(name, jitted, monkeypatch):
    """The column scheme on each case: its outputs held to the JAX
    package's (``hold_columns``); the unstable and perturbed cases
    convect, the stable one nowhere, and on the 500 m grid every column
    that triggers aborts in the closure (the port's own search is
    watched for its triggered columns)."""
    kw, seed, dx = CASES[name]
    args = kf_inputs(kw, seed)
    searched = []
    search = T._search

    def watch(col):
        out = search(col)
        searched.append(out[0])
        return out
    monkeypatch.setattr(T, "_search", watch)
    got = T._kf_columns(*to_port(args), 90.0, dx)
    hold_columns(got, jax_columns(jitted, args, dx), f"_kf_columns {name}")
    status = searched[0]
    ended = status != 0
    sel = torch.argmax(ended.to(torch.uint8), 0)
    trig = (torch.take_along_dim(status, sel[None], 0)[0] == 1) \
        & ended.any(0)
    ok = got["triggered"].reshape(-1)
    if name in ("unstable", "mixed"):
        assert bool(ok.all()) and float(got["pratec"].min()) > 0.0
    elif name == "stable":
        assert not bool(trig.any()) and float(got["pratec"].max()) == 0.0
    else:
        assert bool(trig.any()) and not bool(ok.any())


def test_kfcps_countdown(jitted):
    """The driver over three calls on the unstable sounding (w 0.6 m/s):
    the first (90 s) triggers (NCA set, rain, tendencies); the second (90
    s), on a sounding 5 K warmer, keeps the tendencies and the rain rate
    while NCA counts down; the third, 2000 s long, finds NCA below half
    its step and checks the warmer columns anew. Each
    call's outputs held to the JAX package jitted (``hold`` on the
    running mean w, within COLUMN_BOUNDS on the rest)."""
    u, v, t, qv, p, rho, dz, _ = kf_inputs({}, None)
    exner = np.ones_like(t)
    z2 = np.zeros(t.shape[1:], np.float32)
    z3 = np.zeros_like(t)
    w_real = np.full(t.shape, 0.6, np.float32)
    state = [z3, np.full(t.shape[1:], -100.0, np.float32), z2] + [z3] * 6
    step = jax.jit(lambda *a: J.kfcps(*a[:9], a[9], 4000.0, *a[10:]))
    names = ("tend_th", "tend_qv", "tend_qc", "tend_qr", "tend_qi",
             "tend_qs", "raincv", "w0avg", "nca", "pratec")
    bounds = (1e-4, 1e-4, 5e-4, 5e-4, 2e-4, 2e-4, 1e-4, None, 0.0, 1e-4)
    outs = []
    for call, (th, dt) in enumerate(((t, 90.0), (t + 5.0, 90.0),
                                     (t + 5.0, 2000.0))):
        args = (u, v, th, qv, p, rho, dz, w_real, exner, np.float32(dt))
        want = step(*to_jax(args), *to_jax(tuple(state)))
        got = T.kfcps(*to_port(args[:9]), args[9], 4000.0,
                      *to_port(tuple(state)))
        for name, g, w, b in zip(names, got, want, bounds):
            if b is None:
                hold(g, w, name)
                continue
            w = np.asarray(w, np.float64)
            d = np.abs(g.numpy() - w).max()
            assert d <= b * max(np.abs(w).max(), 1e-30), (call, name, d)
        state = [np.asarray(a) for a in (got[7], got[8], got[9]) + got[:6]]
        outs.append([g.numpy() for g in got])
    first, second, third = outs
    assert first[8].min() > 0 and first[9].min() > 0
    np.testing.assert_array_equal(second[0], first[0])
    np.testing.assert_array_equal(second[9], first[9])
    assert second[8].max() < first[8].max()
    # the countdown spent, the warmer sounding is checked anew
    assert not np.array_equal(third[0], first[0])


# ---------------------------------------------------------------------------
# the helpers, op by op
# ---------------------------------------------------------------------------

def _values(seed, n=240):
    """Seeded parcel values: temperature 220-310 K, pressure 200-1000
    hPa, vapour 1e-4..2e-2, liquid and ice 0..3e-3 (a quarter zero), the
    glaciation fraction 0, 1 or between, and the latent heat."""
    r = np.random.default_rng(seed)
    f = lambda lo, hi: r.uniform(lo, hi, n).astype(np.float32)
    cond = lambda: np.where(r.uniform(size=n) < 0.25, 0.0,
                            f(0.0, 3e-3)).astype(np.float32)
    ratio2 = np.choose(r.integers(0, 3, n), [np.zeros(n), np.ones(n),
                                             r.uniform(0, 1, n)])
    return dict(t=f(220.0, 310.0), p=f(2e4, 1e5),
                q=np.exp(f(np.log(1e-4), np.log(2e-2))).astype(np.float32),
                ql=cond(), qi=cond(), r2=ratio2.astype(np.float32),
                rl=f(2.5e6, 2.83e6), w=f(-4.0, 40.0), dz=f(200.0, 600.0),
                eq=np.concatenate([[0.0, 0.5, 1.0], f(0.0, 1.0)[3:]])
                .astype(np.float32))


def _case(name, v):
    """The helper ``name``'s arguments from the values ``v``."""
    thtu = np.asarray(J._theta_e(jnp.asarray(v["t"]), jnp.asarray(v["p"]),
                                 jnp.asarray(v["q"]), jnp.asarray(v["t"])))
    thtu = (thtu + np.float32(2.0)).astype(np.float32)
    return {
        "_esl": (v["t"],),
        "_esi": (v["t"],),
        "_sd": (v["q"] - 0.01, v["ql"] - v["qi"]),
        "_thtgs": (v["t"], v["p"], v["r2"], v["rl"]),
        "_wetbulb": (v["p"], thtu, v["t"], v["r2"], v["rl"], 0.01),
        "_tpmix": (v["p"], thtu, v["t"], v["q"], v["ql"], v["qi"], v["r2"],
                   v["rl"]),
        "_condload": (v["ql"], v["qi"], v["w"], v["dz"],
                      (v["w"] * 0.1).astype(np.float32),
                      (v["w"] * 0.05).astype(np.float32), v["ql"] * 0.5,
                      v["qi"] * 0.5),
        "_dtfrznew": (np.clip(v["t"], 248.0, 269.0), v["p"], v["q"],
                      v["ql"], v["qi"], v["ql"] * 0.3,
                      (v["eq"] * 0.9).astype(np.float32),
                      np.ones_like(v["t"]),
                      (v["r2"] > 0.5).astype(np.int32)),
        "_prof5": (v["eq"],),
        "_envirtht": (v["p"], v["t"], v["q"], v["r2"], v["rl"]),
        "_theta_e": (v["t"], v["p"], v["q"], (v["t"] - 5.0)
                     .astype(np.float32)),
    }[name]


HELPERS = ("_esl", "_esi", "_sd", "_thtgs", "_wetbulb", "_tpmix",
           "_condload", "_dtfrznew", "_prof5", "_envirtht", "_theta_e")


# the secant iteration stops where a residual falls below its tolerance,
# so a cell whose residual lands within an ulp of it stops one step apart
# in the two packages (one cell of 240 in a seed): the share of cells of
# the wet bulb's and TPMIX's outputs allowed past ``hold``'s bound
SECANT_SHARE = 0.01


@pytest.mark.parametrize("name", HELPERS)
def test_helpers_match(name):
    """Each helper on two seeded sets of values, op by op, held by
    ``hold`` (integer outputs equal; the secant's outputs with
    SECANT_SHARE)."""
    for seed in (0, 1):
        a = _case(name, _values(seed))
        with jax.disable_jit():
            want = getattr(J, name)(*to_jax(a))
        got = getattr(T, name)(*to_port(a))
        share = ({i: SECANT_SHARE for i in range(6)}
                 if name in ("_wetbulb", "_tpmix") else None)
        hold(got, want, f"{name} seed {seed}", share)

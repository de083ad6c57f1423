"""The port's BMJ convection (icar_tpu_torch/physics/cu_bmj.py, conv=5)
against the JAX package's, on the CPU.

The columns are tests/test_bmj.py's (a deep conditionally unstable
column over land and over sea, a stable one, a shallow moist layer under
dry air) and each of them perturbed from a seed (temperature +-1.5 K,
humidity 85-110%, every cell its own draw), so that one grid holds
columns that go deep, fail deep and fall back to shallow, mix shallow
without rain and stay quiet. Each case's whole call goes through the JAX
function jitted (one compilation, every case 30 levels deep) and through
the port. The JAX function run op by op (``jax.disable_jit()``) costs a
second per level squared (its source-level search nests two level
loops), so it runs once, on a 12-level column (``test_bmj_op_by_op``),
recording the arguments and results of every routine it reaches
(tests/test_torch_cu_nsas.py ``record_calls``); the port's call is held
to that run, the lookups and the saturation humidity are replayed op by
op, the column adjustment held to its recorded result. Outputs are
held by ``hold`` (rtol 1e-5 plus 1e-6 of the field's largest magnitude)
but the vapour at ``QV_ATOL``, the rain, a column sum, at ``RAIN_RTOL``,
and the column
adjustment's tendencies, differences of nearly equal temperatures, at
``TEND_ATOL``; the table lookups bit for
bit: their floor indices and bilinear weights are float32 arithmetic
without a transcendental, so one float32 input gives one answer, and a
different floor at a cell edge would be a different answer rather than a
rounding difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import bmj_tables as JT
from icar_tpu.physics import cu_bmj as J
from icar_tpu_torch.physics import cu_bmj as T
from test_bmj import column
from test_torch_cu_nsas import record_calls
from test_torch_mp_wsm3 import hold, replay, to_jax, to_port

torch.set_num_threads(1)

ROUTINES = ("_qs", "_interp1", "_ptbl_lookup", "_ttblex", "_bmj_column")

# name -> (tests/test_bmj.py column, land_mask value, seed or None)
CASES = {
    "deep_land": (dict(), 1.0, None),
    "deep_sea": (dict(), 2.0, 3),
    "stable": (dict(t_sfc=288.0, lapse=4.0e-3, rh=0.3, rh_top=0.3), 1.0,
               None),
    # a shallow moist layer: three of its nine columns mix shallow, the
    # others stay quiet
    "shallow": (dict(t_sfc=300.0, lapse=6.5e-3, rh=0.8, rh_top=0.2), 1.0,
                2),
    "mixed": (dict(), 1.0, 1),
    # seven columns deep, one shallow (sea and land)
    "mixed_shallow": (dict(t_sfc=296.0, lapse=7.0e-3, rh=0.9, rh_top=0.3),
                      2.0, 6),
}


def bmj_inputs(kw, xland, seed, dt=600.0):
    """bmj's arguments (numpy): the column, perturbed from ``seed``; the
    first row of columns on the other surface (land <-> sea)."""
    c = column(**kw)
    if seed is not None:
        r = np.random.default_rng(seed)
        sh = c["t"].shape
        c["t"] = (c["t"] + r.uniform(-1.5, 1.5, sh)).astype(np.float32)
        c["qv"] = (c["qv"] * r.uniform(0.85, 1.1, sh)).astype(np.float32)
        c["th"] = c["t"] / c["exner"]
    ny, nx = c["t"].shape[1:]
    land = np.full((ny, nx), xland, np.float32)
    land[0] = 3.0 - xland
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(f32(c[k]) for k in ("t", "th", "qv", "p", "exner", "rho",
                                     "dz")) + (
        land, np.full((ny, nx), 0.6, np.float32), np.float32(dt))


# the rain is a column sum of the adjustment (20-30 levels of float32
# terms of both signs), held at this bound relative to its largest value
# (7.5e-6 mm of 0.16 observed); the other outputs by ``hold``'s
RAIN_RTOL = 1e-4
# _bmj_column's tendencies: (reference - actual) over a few levels, held
# within rtol 1e-5 plus this share of their largest magnitude (4.3e-6
# observed)
TEND_ATOL = 2e-5
JITTED = {}


def jitted(fn):
    """``fn`` of the JAX module jitted once a test session."""
    if fn not in JITTED:
        JITTED[fn] = jax.jit(getattr(J, fn))
    return JITTED[fn]


# the vapour after a shallow adjustment, whose humidity profile solves for
# a slope from sums that nearly cancel: within rtol 1e-5 plus this share
# of its largest value (6.5e-6 observed)
QV_ATOL = 2e-5


def hold_bmj(got, want, what):
    """bmj's outputs: theta and the cloud efficiency by ``hold``; the
    vapour within rtol 1e-5 plus QV_ATOL of its largest value, the rain
    within RAIN_RTOL of its largest value."""
    hold((got[0], got[3]), (want[0], want[3]), what)
    for i, rtol, atol in ((1, 1e-5, QV_ATOL), (2, 0.0, RAIN_RTOL)):
        g = got[i].numpy().astype(np.float64)
        w = np.asarray(want[i], np.float64)
        bound = rtol * np.abs(w) + atol * max(np.abs(w).max(), 1e-30)
        assert (np.abs(g - w) <= bound).all(), \
            (what, i, np.abs(g - w).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_bmj_call_matches(name):
    """The whole call (theta, vapour, rain, cloud efficiency) of each case
    against the JAX package jitted (``hold_bmj``), every output finite."""
    inputs = bmj_inputs(*CASES[name])
    want = jitted("bmj")(*to_jax(inputs))
    got = T.bmj(*to_port(inputs))
    hold_bmj(got, want, f"bmj {name}")
    for g in got:
        assert torch.isfinite(g).all(), name


def test_bmj_op_by_op():
    """One call on a 12-level version of the perturbed deep case (dz 800
    m), land and sea columns, through the JAX package op by op: the
    port's whole call held to it (``hold_bmj``); each routine it reached
    on its recorded arguments -- the saturation humidity and the table
    lookups op by op (``hold``), the column adjustment against its
    recorded result (tendencies at TEND_ATOL, the rain at RAIN_RTOL)."""
    kw, xland, _ = CASES["mixed"]
    inputs = bmj_inputs(dict(kw, nz=12, dz0=800.0, ny=2), xland, 5)
    with record_calls(J, ROUTINES, calls=2) as log, jax.disable_jit():
        want = J.bmj(*to_jax(inputs))
    hold_bmj(T.bmj(*to_port(inputs)), want, "bmj op by op")
    assert float(np.asarray(want[2]).max()) > 0.0
    replay(J, T, [e[:3] for e in log if e[0] != "_bmj_column"])
    (_, a, k, want), = [e for e in log if e[0] == "_bmj_column"]
    got = T._bmj_column(*to_port(a), **to_port(k))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        bound = (RAIN_RTOL * scale if i == 2
                 else 1e-5 * np.abs(w) + TEND_ATOL * scale)
        assert (np.abs(g - w) <= bound).all(), ("_bmj_column", i)


def test_regimes_are_covered():
    """The cases reach every branch: deep rain with the cloud efficiency
    moved off its start, shallow mixing (vapour moved, no rain) and quiet
    columns (nothing moved, the efficiency reset to land's and sea's),
    in both packages alike."""
    out = {n: T.bmj(*to_port(bmj_inputs(*CASES[n])))
           for n in ("deep_land", "stable", "shallow", "mixed")}
    th, qv, rain, cldefi = out["deep_land"]
    assert float(rain.min()) > 0.05
    assert float((cldefi - 0.6).abs().max()) > 0.01
    inputs = bmj_inputs(*CASES["shallow"])
    th, qv, rain, _ = out["shallow"]
    moved = (qv.numpy() != inputs[2]).any(0)
    assert moved.any() and float(rain.max()) == 0.0
    want = jitted("bmj")(*to_jax(inputs))
    np.testing.assert_array_equal((np.asarray(want[1]) != inputs[2]).any(0),
                                  moved)
    th, qv, rain, cldefi = out["stable"]
    inputs = bmj_inputs(*CASES["stable"])
    assert float(rain.max()) == 0.0
    np.testing.assert_array_equal(th.numpy(), inputs[1])
    np.testing.assert_allclose(cldefi[0].numpy(), J.AVGEFI, rtol=1e-6)
    np.testing.assert_allclose(cldefi[1:].numpy(), 1.0)
    rain = out["mixed"][2].numpy()
    assert (rain > 0).any() and (rain == 0).any()


def test_table_lookups_are_bit_equal():
    """``_interp1``, ``_ptbl_lookup`` and ``_ttblex`` equal the JAX
    package's bit for bit (op by op), their indices too, over a grid of
    positions that falls exactly on cell edges, inside cells, below and
    above each table and at NaN; and the port's tables on a device are
    the host tables."""
    tables = JT.get_tables()
    dev = T.device_tables("cpu")
    for k, v in tables.items():
        np.testing.assert_array_equal(dev[k].numpy(), v)
    r = np.random.default_rng(7)
    # positions in units of the table's step: every edge of the coarse
    # theta table, midpoints, and out of range
    edges = np.arange(-2, J.JTB + 2, dtype=np.float32)
    pos = np.concatenate([edges, edges + 0.5, r.uniform(-3, J.JTB + 3, 64)
                          .astype(np.float32), [np.nan]]).astype(np.float32)
    base = tables["qs0"]
    with jax.disable_jit():
        want = J._interp1(jnp.asarray(base), jnp.asarray(pos), J.JTB)
    got = T._interp1(torch.as_tensor(base), torch.as_tensor(pos), J.JTB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # theta on the coarse table's rows (exact edges) and between them,
    # humidities across the scaled range
    thbt = (J.THL + edges[2:-2] / np.float32(J.RDTH)).astype(np.float32)
    thbt = np.concatenate([thbt, r.uniform(200.0, 370.0, 200)]).astype(
        np.float32)
    qbt = r.uniform(0.0, 0.03, thbt.shape).astype(np.float32)
    p = np.concatenate([np.linspace(J.PL - 500.0, 106000.0, 150),
                        J.PLQ + np.arange(-3, 4) / np.float32(J.RDPQ),
                        r.uniform(2000.0, 105500.0, 40)]).astype(np.float32)
    thesp = r.uniform(250.0, 400.0, p.shape).astype(np.float32)
    with jax.disable_jit():
        want_p = J._ptbl_lookup(jnp.asarray(thbt), jnp.asarray(qbt), tables)
        want_t = J._ttblex(jnp.asarray(p), jnp.asarray(thesp), tables)
    np.testing.assert_array_equal(
        T._ptbl_lookup(torch.as_tensor(thbt), torch.as_tensor(qbt),
                       tables).numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(
        T._ttblex(torch.as_tensor(p), torch.as_tensor(thesp),
                  tables).numpy(), np.asarray(want_t))

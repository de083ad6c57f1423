"""The Thompson cloud fraction (icar_tpu_torch/physics/cloud_fraction.py
``cal_cldfra3``) against the JAX package's run op by op
(``jax.disable_jit()``) on seeded columns that hold explicit cloud, warm
and cold subsaturated layers (the Sundqvist and HRRR branches), land and
water, ice and water decks of one and more levels (the deck adjustments
and the single-level rule) and the column water-path cap. The cloud
fraction is held to 1e-6 of its largest value, the augmented condensate
to 1e-5 (the port's reciprocal products and powers; observed at most
6.0e-8 in every test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import cloud_fraction as jcf
from icar_tpu_torch.physics import cloud_fraction as tcf

torch.set_num_threads(1)


def case(seed, nz=20, ny=4, nx=6, wet=1.0):
    """Seeded columns on a 50-500 m level stack up to ~9 km: temperature
    from 295 K down past -35 C, relative humidity 40-105% with wet
    bands, explicit cloud water or ice in some cells, snow aloft."""
    r = np.random.default_rng(seed)
    f = np.float32
    dz1 = np.array([50, 75, 125, 200, 300, 400] + [500] * (nz - 6), f)
    dz = np.broadcast_to(dz1[:, None, None], (nz, ny, nx)).copy()
    z = np.cumsum(dz, axis=0) - dz / 2
    p = (1e5 * np.exp(-z / 8000.0)).astype(f)
    t = (295.0 - 0.0068 * z + r.normal(0, 0.5, z.shape)).astype(f)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qsat = 0.622 * es / (p - es)
    rh = np.clip(r.uniform(0.4, 0.95, z.shape)
                 + wet * 0.15 * (np.sin(z / 900.0 + seed) > 0.3), 0, 1.05)
    qv = (rh * qsat).astype(f)
    qc = np.where((r.uniform(size=z.shape) < 0.15) & (t > 260),
                  r.uniform(1e-7, 5e-4, z.shape), 0).astype(f)
    qi = np.where((r.uniform(size=z.shape) < 0.15) & (t < 265),
                  r.uniform(1e-7, 2e-4, z.shape), 0).astype(f)
    qs = np.where(t < 270, r.uniform(0, 3e-6, z.shape), 0).astype(f)
    xland = np.where(r.uniform(size=(ny, nx)) < 0.4, 2.0, 1.0).astype(f)
    return qv, qc, qi, qs, dz, p, t, xland


def _run(args, gridkm):
    with jax.disable_jit():
        want = jcf.cal_cldfra3(*[jnp.asarray(a) for a in args], gridkm)
    got = tcf.cal_cldfra3(*[torch.tensor(a) for a in args], gridkm)
    return want, got


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want).max()
    return d / max(np.abs(want).max(), 1e-30) if d else 0.0


@pytest.mark.parametrize("seed,gridkm", [(0, 1.0), (1, 3.0), (2, 1.0)])
def test_cal_cldfra3_matches(seed, gridkm):
    """The cloud fraction within 1e-6 of its largest value, the
    radiation's cloud water and ice within 1e-5 of theirs; the cases hold
    fractional cloud, explicit cloud, and decks the adjustments raise."""
    args = case(seed)
    want, got = _run(args, gridkm)
    cf = np.asarray(want[0])
    assert ((cf > 0) & (cf < 1)).any() and (cf == 1).any() and (cf == 0).any()
    assert (np.asarray(want[1]) > args[1]).any()
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1], want[1]) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-5


def test_run_extents_match():
    """The per-level run extents of a seeded mask equal the JAX
    package's."""
    m = np.random.default_rng(3).uniform(size=(20, 5, 7)) < 0.55
    with jax.disable_jit():
        want = jcf._run_extents(jnp.asarray(m))
    got = tcf._run_extents(torch.tensor(m))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_water_path_cap():
    """A very wet column: the added water path hits the 1.5 mm cap, which
    scales the fractional levels (adjust_cloudFinal) on both."""
    args = list(case(4, wet=3.0))
    args[1] = (args[1] * 10.0).astype(np.float32)
    qv, qc, qi, qs, dz, p, t, xland = args
    want, got = _run(args, 1.0)
    # the explicit cloud water alone passes 1.5 mm in a column that also
    # holds fractional cloud, whose levels the cap then scales
    cf = np.asarray(want[0])
    lwp_in = (np.where(cf > 0, qc * p / (287.0 * t) * dz, 0)).sum(axis=0)
    frac = ((cf > 0) & (cf < 1)).any(axis=0)
    assert (frac & (lwp_in > 1.5)).any()
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1], want[1]) <= 1e-5
    assert _rel(got[2], want[2]) <= 1e-5

"""The RRTMG + YSU path with ``use_simple_sw`` (RRTMG longwave, the simple
scheme's shortwave without its longwave, ra_driver.f90:429-449) through
the port against the JAX package's model, as
tests/test_torch_rrtmg_model.py holds the full RRTMG path (its ``Pair``
and bounds), on a JAX model of its own; and ra_simple's ``runlw=False``
against the JAX function run op by op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import ra_simple as jra
from icar_tpu_torch.physics import ra_simple as tra
from test_torch_rrtmg_model import (NIGHT, NOON, ONE_SUBSTEP_ABS, Pair,
                                    hold, interval_runs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return Pair(simple_sw=True)


@pytest.mark.parametrize("start", [NOON, NIGHT], ids=["noon", "night"])
def test_one_substep_matches(pair, start):
    """One substep at local noon and after sunset: every field within
    FULLPHYS_BOUNDS of the JAX step's, the cloud water within
    ONE_SUBSTEP_ABS; RRTMG's longwave once on both; the shortwave heating
    exactly 0 (the simple scheme heats nothing), the shortwave the simple
    scheme's: nonzero at noon, 0 at night."""
    want, n, calls = pair.run_jax(25.0, start)
    port, port_calls = pair.run_port(25.0, start)
    assert port.last_n_substeps == n == 1
    assert port_calls == calls == 1
    assert [c[0] for c in port.mcica_cdf.calls] == ["lw"]
    hold(port, want, absolute=ONE_SUBSTEP_ABS)
    assert (want["tend_th_swrad"] == 0).all()
    assert (port.field("tend_th_swrad") == 0).all()
    if start == NOON:
        assert want["shortwave"].min() > 0
    else:
        assert (want["shortwave"] == 0).all()
        assert (port.field("shortwave") == 0).all()


def test_interval_matches(pair):
    """600 s at noon: the same substeps and RRTMG calls, every field
    within FULLPHYS_BOUNDS or twice the JAX package's own one-ulp spread
    (test_torch_rrtmg_model.py; observed at most 0.50 of the bound,
    hpbl)."""
    want, n, calls, spread, port, port_calls = interval_runs(pair)
    assert port.last_n_substeps == n == 24
    assert port_calls == calls == 1
    hold(port, want, spread)
    assert want["shortwave"].max() > 0


def test_ra_simple_without_longwave_matches():
    """ra_simple(runlw=False): theta unchanged (no radiative cooling), no
    longwave (None), the shortwave and cloud cover within 2e-6 of the JAX
    function's run op by op, on seeded columns at noon."""
    r = np.random.default_rng(8)
    f = np.float32
    nz, ny, nx = 8, 5, 6
    z = np.cumsum(np.full(nz, 300.0)) - 150.0
    p = (1e5 * np.exp(-z / 8000.0))[:, None, None] * np.ones((nz, ny, nx))
    theta = (300.0 + 0.003 * z)[:, None, None] + r.normal(0, 0.5,
                                                         (nz, ny, nx))
    exner = (p / 1e5) ** 0.2857
    qv = 0.01 * np.exp(-z / 3000.0)[:, None, None] * r.uniform(
        0.5, 1.0, (nz, ny, nx))
    q = lambda s: np.where(r.uniform(size=(nz, ny, nx)) < 0.3,
                           r.uniform(0, s, (nz, ny, nx)), 0)
    lat = r.uniform(30, 50, (ny, nx))
    lon = r.uniform(-110, -100, (ny, nx))
    args = [a.astype(f) for a in (theta, exner, qv, q(5e-4), q(2e-4),
                                  q(3e-4), p)]
    geo = [lon.astype(f), np.sin(np.radians(lat)).astype(f),
           np.cos(np.radians(lat)).astype(f)]
    doy, year, dt = f(335.79), f(365.0), f(20.0)
    with jax.disable_jit():
        want = jra.ra_simple(*[jnp.asarray(a) for a in args + geo],
                             jnp.float32(doy), jnp.float32(year),
                             jnp.float32(dt), runlw=False)
    got = tra.ra_simple(*[torch.tensor(a) for a in args + geo],
                        torch.tensor(doy), torch.tensor(year),
                        torch.tensor(dt), runlw=False)
    assert want[2] is None and got[2] is None
    np.testing.assert_array_equal(got[0].numpy(), args[0])
    np.testing.assert_array_equal(np.asarray(want[0]), args[0])
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        w = np.asarray(w, np.float64)
        assert np.abs(g.numpy() - w).max() <= 2e-6 * np.abs(w).max()
    assert np.asarray(want[1]).max() > 100.0

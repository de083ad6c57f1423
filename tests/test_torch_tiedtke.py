"""The port's Tiedtke convection (``physics/cu_tiedtke.py``) against the
JAX package's ``tiedtke``, on seeded grids of columns: warm and cool
surfaces, steep and gentle lapse rates, dry and moist air, rising and
sinking motion, moisture convergence and divergence, land and water, so
that the trigger fires in some columns and not in others.

The JAX scheme runs op by op (``jax.disable_jit()``, its updraft loop a
Python loop then). The set of convecting columns (those with convective
rain) must be the same. Fields are held to rtol 1e-5 and an atol of 1e-4
of each field's largest magnitude: the largest difference observed is
1.3e-5 of the largest cloud ice (the detrained ice), 9e-6 of the largest
cloud water, 2.4e-6 of the largest rain and 6e-7 in theta and vapour
(exp differs between the libraries by an ulp, and the port divides by a
constant as a product with its float32 reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.physics import cu_tiedtke as J
from icar_tpu_torch.physics import cu_tiedtke as T

torch.set_num_threads(1)

NAMES = ("u", "v", "w_if", "t", "qv", "qc", "qi", "exner", "rho",
         "qv_tend_adv", "qv_tend_pbl", "p", "p_i", "dz", "qfx", "hfx",
         "xland")
RTOL, ATOL_FRAC = 1e-5, 1e-4


def columns(seed, nz=20, ny=6, nx=8):
    """Seeded inputs (numpy), bottom-up as the model holds them."""
    r = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    dz = (np.full(shape, 500.0) * r.uniform(0.8, 1.2, (1, ny, nx))
          ).astype(np.float32)
    z = np.cumsum(dz, 0) - dz / 2
    p = (1e5 * np.exp(-z / 8000.0)).astype(np.float32)
    p_i = np.zeros((nz + 1, ny, nx), np.float32)
    p_i[0] = 1.013e5
    p_i[1:-1] = 0.5 * (p[:-1] + p[1:])
    p_i[-1] = p[-1] - (p[-2] - p[-1]) / 2
    t = (r.uniform(285, 305, (ny, nx))
         - r.uniform(0.005, 0.0085, (ny, nx)) * z).astype(np.float32)
    qs = np.asarray(J._qsat(jnp.asarray(t), jnp.asarray(p)))
    qv = (r.uniform(0.3, 0.95, (ny, nx)) * qs / (1 - qs)).astype(np.float32)
    w_if = np.zeros((nz + 1, ny, nx), np.float32)
    w_if[1:8] = r.uniform(-0.2, 0.5, (1, ny, nx))
    qtend = (r.uniform(-1e-7, 4e-7, (1, ny, nx)) * np.ones((nz, 1, 1))
             ).astype(np.float32)
    return dict(
        u=r.normal(5, 2, shape).astype(np.float32),
        v=r.normal(0, 2, shape).astype(np.float32), w_if=w_if, t=t, qv=qv,
        qc=np.where(r.uniform(size=shape) < 0.2, 1e-4, 0).astype(np.float32),
        qi=np.zeros(shape, np.float32),
        exner=((p / 1e5) ** (287.05 / 1005.46)).astype(np.float32),
        rho=(p / (287.05 * t)).astype(np.float32), qv_tend_adv=qtend,
        qv_tend_pbl=(qtend * 0.25).astype(np.float32), p=p, p_i=p_i, dz=dz,
        qfx=r.uniform(0, 2e-4, (ny, nx)).astype(np.float32),
        hfx=r.uniform(-20, 200, (ny, nx)).astype(np.float32),
        xland=np.where(r.uniform(size=(ny, nx)) < 0.3, 2.0, 1.0
                       ).astype(np.float32))


@pytest.mark.parametrize("seed,dt", [(0, 60.0), (1, 25.0), (2, 120.0)])
def test_tiedtke_matches(seed, dt):
    d = columns(seed)
    with jax.disable_jit():
        want = J.tiedtke(*[jnp.asarray(d[k]) for k in NAMES],
                         jnp.float32(dt))
    got = T.tiedtke(*[torch.as_tensor(d[k]) for k in NAMES],
                    torch.tensor(dt))
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    convecting = want[4] > 0
    assert convecting.any() and not convecting.all()
    np.testing.assert_array_equal(got[4] > 0, convecting)
    for g, w, name in zip(got, want, ("th", "qv", "qc", "qi", "rain")):
        np.testing.assert_allclose(
            g, w, rtol=RTOL,
            atol=ATOL_FRAC * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def test_quiet_columns_are_unchanged():
    """A stable, dry column with no convergence: no rain, and theta, qv,
    qc and qi as they came in, in both packages."""
    d = columns(3)
    d["t"] = (290.0 - 0.004 * (np.cumsum(d["dz"], 0) - d["dz"] / 2)
              ).astype(np.float32)
    d["qv"] = (d["qv"] * 0.3).astype(np.float32)
    d["qv_tend_adv"] = np.zeros_like(d["t"])
    d["qv_tend_pbl"] = np.zeros_like(d["t"])
    d["w_if"] = np.zeros_like(d["w_if"])
    got = T.tiedtke(*[torch.as_tensor(d[k]) for k in NAMES],
                    torch.tensor(60.0))
    with jax.disable_jit():
        want = J.tiedtke(*[jnp.asarray(d[k]) for k in NAMES],
                         jnp.float32(60.0))
    assert float(np.asarray(want[4]).max()) == 0.0
    assert float(got[4].max()) == 0.0
    np.testing.assert_allclose(got[1].numpy(), d["qv"], rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy() * d["exner"], d["t"],
                               rtol=1e-6)

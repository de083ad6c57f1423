"""The port's counterparts of two end-to-end checks of the JAX package's
tests/test_model_e2e.py, with their assertions, on the port's model on
the CPU: the boundary forcing of the advected species
(``test_forcing_relaxation_pulls_boundaries``) and the surface's update
interval (``test_lsm_update_interval_throttling``, whose unthrottled run
takes ``core.step.Throttle`` with an interval of 0: the scheme every
substep, over its dt).
"""

import numpy as np
import torch

from icar_tpu_torch import constants as C
from icar_tpu_torch.core.step import Throttle
from icar_tpu_torch.models.icar import ideal_ridge_model

torch.set_num_threads(1)


def test_forcing_relaxation_pulls_boundaries():
    m = ideal_ridge_model(nx=40, ny=12, nz=10, dx=1000.0, hill_height=0.0,
                          u_speed=5.0, rh=0.4, device="cpu")
    qv0 = m.field("water_vapor").copy()
    dqdt = {"water_vapor": np.full_like(qv0, 1e-7)}
    m.set_forcing_tendencies(dqdt)
    m.advance(600.0)
    qv1 = m.field("water_vapor")
    # boundary ring accumulated ~ 1e-7 * 600 s; interior did not (dry run)
    np.testing.assert_allclose(qv1[:, 0, :] - qv0[:, 0, :], 6e-5, rtol=1e-2)
    inner = qv1[:, 5:-5, 5:-5] - qv0[:, 5:-5, 5:-5]
    assert np.abs(inner).max() < 1e-5


def test_lsm_update_interval_throttling(monkeypatch):
    """The surface's fluxes are computed every lsm update_interval (300 s
    by default, lsm_driver.f90:999-1022) and applied every substep; with
    an interval of 0 every substep computes them, and the results stay
    close (not identical). The Throttle of interval 0 returns each
    substep's dt."""
    kw = dict(nx=40, ny=12, nz=12, dx=2000.0, hill_height=400.0,
              u_speed=8.0, rh=0.8, mp=C.MP_SIMPLE, lsm=C.LSM_BASIC,
              water=C.WATER_SIMPLE, rad=C.RA_SIMPLE, device="cpu")
    m_thr = ideal_ridge_model(**kw)        # default: 300 s
    assert m_thr.options.lsm.update_interval == 300.0
    m_all = ideal_ridge_model(**kw)
    m_all.options.lsm.update_interval = 0.0
    steps = []
    step = Throttle.step

    def counted(self, dt):
        out = step(self, dt)
        steps.append((id(self), self.interval, dt, out))
        return out
    monkeypatch.setattr(Throttle, "step", counted)
    m_thr.advance(900.0)
    thr, steps[:] = list(steps), []
    m_all.advance(900.0)
    for m in (m_thr, m_all):
        for n in ("potential_temperature", "sensible_heat",
                  "latent_heat", "skin_temperature"):
            assert np.isfinite(m.field(n)).all(), n
    t1 = np.asarray(m_thr.field("potential_temperature"))
    t2 = np.asarray(m_all.field("potential_temperature"))
    assert np.abs(t1 - t2).max() < 2.0     # modest timing differences
    # the throttles of interval 0 (the surface's; the microphysics' by
    # default) run their scheme every substep over its dt, the surface's
    # of 300 s on fewer substeps
    zero = {}
    for key, interval, dt, out in steps:
        assert interval == 0.0 and out == dt
        zero[key] = zero.get(key, 0) + 1
    assert len(zero) == 2
    assert set(zero.values()) == {m_all.last_n_substeps}
    ran = [out for _, i, _, out in thr if i == 300.0 and out is not None]
    assert 1 <= len(ran) < m_thr.last_n_substeps

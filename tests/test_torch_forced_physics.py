"""One interval of the port's full-physics loop (``run_interval_physics``:
Thompson and upwind after simple radiation, Noah with simple water, the
simple PBL and Tiedtke convection) under full-field forcing, against the
JAX step run op by op, on the CPU: the small case of
tests/test_torch_fullphys.py, two substeps; and on blocks (a 2x2 CPU
mesh) against the unsharded port, bit for bit.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_fullphys as fp
from icar_tpu.core.step import make_step_fn
from icar_tpu_torch.core import step as tstep
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel.mesh import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (bit_mismatches)

torch.set_num_threads(1)


def test_physics_interval_under_full_field_forcing():
    """Two substeps of ``run_interval_physics`` (the fullphys schemes of
    tests/test_torch_fullphys.py's small case) under seeded tendencies of
    u, v, w, pressure, theta, water vapour and the sea-surface temperature,
    against the JAX step run op by op (``jax.disable_jit``): the dt of
    the forced winds, w_real and the pressure's derived fields refreshed,
    the forcing after the advection, the near-end clamp. The bounds of
    tests/test_torch_fullphys.py's forced interval: the surface fields of
    its ONE_SUBSTEP_ABS within their absolute bounds (observed at most
    their one-substep figures); the cloud fraction and longwave beyond
    1e-3 of their largest values in at most 5% of the columns (observed in
    none); every other field within 3e-4 of its largest magnitude
    (observed at most 8.1e-5, iwl; cloud water 3.2e-5)."""
    mj = fp.jax_model(**fp.CASE, **fp.JAX_FULLPHYS)
    lm = np.asarray(mj.state["land_mask"]).copy()
    lm[:, :10] = 2.0
    mj.state = dict(mj.state)
    mj.state["land_mask"] = jnp.asarray(lm)
    initial = {k: np.asarray(v) for k, v in mj.state.items()}
    r = np.random.default_rng(5)

    def rnd(name, lo, hi):
        return r.uniform(lo, hi, initial[name].shape).astype(np.float32)
    dqdt = {"u": rnd("u", -2e-3, 2e-3), "v": rnd("v", -2e-3, 2e-3),
            "w": rnd("w", -1e-4, 1e-4),
            "pressure": rnd("pressure", -0.05, 0.05),
            "potential_temperature": rnd("potential_temperature", -1e-4,
                                         1e-4),
            "water_vapor": rnd("water_vapor", -1e-7, 1e-8),
            "sst": rnd("sst", -1e-4, 1e-4)}
    mt = fp._port(initial)
    s, g = mt.state, mt.geom_t
    dt0 = float(tstep.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels,
                                   g.dx, mt.options.run.cfl_reduction_factor,
                                   mt.options.run.cfl_strictness))
    seconds = float(np.float32(1.5) * np.float32(dt0))
    step = make_step_fn(mj.options, mj.geom, mj.advect_names, True,
                        fast_path=False)
    with jax.disable_jit():
        want, _, n = step({k: jnp.array(v) for k, v in initial.items()},
                          {k: jnp.asarray(v) for k, v in dqdt.items()},
                          jnp.float32(0.0), jnp.float32(seconds),
                          mj._time_aux(), mj.geom_args())
    got, n_t = tstep.run_interval(mt.state, mt.geom_t, mt.options,
                                  mt.advect_names, seconds,
                                  {k: torch.tensor(v)
                                   for k, v in dqdt.items()},
                                  time_aux=mt._time_aux())
    assert n_t == int(n) == 2
    assert sorted(got) == sorted(want)
    for k in want:
        gk, wk = got[k].numpy(), np.asarray(want[k])
        if k in ("ground_heat_flux", "sensible_heat", "canopy_water",
                 "runoff_surface"):
            assert np.abs(gk - wk).max() <= fp.ONE_SUBSTEP_ABS[k][1], k
        elif k in fp.ILL_CONDITIONED:
            rel = np.abs(gk - wk) / np.abs(wk).max()
            assert (rel > 1e-3).mean() <= 0.05, k
        else:
            assert fp._worst(gk, wk) <= 3e-4, k
    # the forced fields moved: the winds and the sea surface everywhere
    for k in ("u", "sst"):
        assert np.abs(got[k].numpy() - initial[k]).min() > 0, k


def test_physics_interval_under_full_field_forcing_on_blocks(monkeypatch):
    """The same forced interval of the port's own small fullphys case (its
    water strip, seeded tendencies of the same fields) on a 2x2 CPU mesh
    (``attach_mesh``, then ``advance``): the substeps of the unsharded
    model, every bit of every field equal to its, and K5 and K1 once per
    shard and substep."""
    one = fp.ideal_ridge_model(**fp.CASE, **fp.FULLPHYS, device="cpu")
    s = one.state
    land = s["land_mask"].clone()
    land[:, :10] = 2.0
    one.state = {**s, "land_mask": land}
    r = np.random.default_rng(5)

    def rnd(name, lo, hi):
        return r.uniform(lo, hi, tuple(s[name].shape)).astype(np.float32)
    one.set_forcing_tendencies({
        "u": rnd("u", -2e-3, 2e-3), "v": rnd("v", -2e-3, 2e-3),
        "w": rnd("w", -1e-4, 1e-4), "pressure": rnd("pressure", -0.05, 0.05),
        "potential_temperature": rnd("potential_temperature", -1e-4, 1e-4),
        "water_vapor": rnd("water_vapor", -1e-7, 1e-8),
        "sst": rnd("sst", -1e-4, 1e-4)})
    g, o = one.geom_t, one.options.run
    dt0 = float(tstep.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels,
                                   g.dx, o.cfl_reduction_factor,
                                   o.cfl_strictness))
    seconds = float(np.float32(1.5) * np.float32(dt0))
    blocks = copy.deepcopy(one)
    blocks.attach_mesh(Mesh(["cpu"] * 4, (2, 2)))
    one.advance(seconds)
    calls = {"mp_thompson_stack": 0, "advect_upwind": 0}
    for name in calls:
        def counted(*a, _orig=getattr(kernels, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    blocks.advance(seconds)
    assert blocks.last_n_substeps == one.last_n_substeps == 2
    assert calls == {"mp_thompson_stack": 8, "advect_upwind": 8}
    assert chip_smoke.bit_mismatches(one, blocks) == []

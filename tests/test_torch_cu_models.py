"""NSAS (conv=4) and BMJ (conv=5) through the port's column-physics loop
against the JAX package's model, on the CPU; Kain-Fritsch's case is
tests/test_torch_cu_models_kf.py, so that it takes another test worker.

The case is chip_smoke.py's small full-physics case (FULLPHYS_SMALL:
30x12x10 with its water strip, one 600 s interval) with each scheme in
Tiedtke's place: Thompson, upwind, wind=2, simple radiation, Noah with
simple water and the simple PBL. One module-scoped JAX model per scheme
runs its general loop jitted (its step built with ``fast_path=False``),
from its initial state and once more from that state one ulp up or down
in theta and water vapour (seeded): the JAX package's own spread of a
field is that run's largest difference from the first over the field's
largest magnitude. The port runs the interval from the JAX model's
initial state (``convert.state_from_numpy``) with no kernel (the plain
versions of K5 and K1): the same substeps, and every field within the
larger of chip_smoke.py's FULLPHYS_BOUNDS (1e-4 for the advected species,
1e-3 for the others; the cloud fraction and the longwave by the share of
cells past 1e-3, at most 5%) and twice that spread, with convective rain
in both. The jitted JAX step alone, against its own op-by-op run, moves
threshold cells (ROADMAP section 3); the schemes' routines are held to
the JAX package op by op in tests/test_torch_cu_bmj.py and
test_torch_cu_nsas.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import path_kernels, run_interval
from icar_tpu_torch.models.icar import RIDGE_PATHS, ideal_ridge_model
from icar_tpu_torch.ops import kernels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the small case and its bounds)

JAX_FULLPHYS = dict(mp=JC.MP_THOMPSON, windtype=JC.WIND_CONSERVE_MASS,
                    rad=JC.RA_SIMPLE, pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH,
                    water=JC.WATER_SIMPLE)
ILL_CONDITIONED = chip_smoke.FULLPHYS_ILL_CONDITIONED


def _worst(got, want):
    """max |got - want| / max |want| (0 where both are all zero)."""
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def with_water_strip(state):
    """``state`` (numpy) with land_mask 2 in the first ten columns, as
    chip_smoke.fullphys_small lays it."""
    lm = np.asarray(state["land_mask"]).copy()
    lm[:, :10] = 2.0
    return dict(state, land_mask=lm)


def jax_reference(conv, grid, seconds):
    """The JAX package's runs of the small case with convection ``conv``
    over ``seconds``: (initial state, the jitted interval's state, its
    substeps, the JAX package's own one-ulp spread of each field), states
    as numpy arrays."""
    mj = jax_model(**grid, **JAX_FULLPHYS, conv=conv)
    mj.state = {k: jnp.asarray(v) for k, v in with_water_strip(
        {k: np.asarray(v) for k, v in mj.state.items()}).items()}
    step = make_step_fn(mj.options, mj.geom, mj.advect_names, False,
                        fast_path=False)

    def run(initial):
        out, _, n = step({k: jnp.array(v) for k, v in initial.items()}, {},
                         jnp.float32(0.0), jnp.float32(seconds),
                         mj._time_aux(), mj.geom_args())
        return {k: np.asarray(v) for k, v in out.items()}, int(n)

    initial = {k: np.asarray(v) for k, v in mj.state.items()}
    want, n = run(initial)
    r = np.random.default_rng(0)
    nudged = dict(initial)
    for k in ("potential_temperature", "water_vapor"):
        a = initial[k]
        to = np.where(r.uniform(size=a.shape) < 0.5, np.inf, -np.inf)
        nudged[k] = np.nextafter(a, to.astype(np.float32))
    other, _ = run(nudged)
    spread = {k: _worst(other[k], want[k]) for k in want}
    return initial, want, n, spread


def check_interval(label, conv, grid, seconds, reference):
    """One interval of the small case with convection ``conv`` in the
    port against the JAX package's ``reference`` (``jax_reference``):
    the same substeps, no kernel launched, every field finite and within
    the larger of FULLPHYS_BOUNDS and twice the JAX package's own spread;
    convective rain in both. Returns the port's state."""
    initial, want, n, spread = reference
    mt = ideal_ridge_model(**grid, **RIDGE_PATHS[label], device="cpu")
    assert path_kernels(mt.options) == ("mp_thompson", "advect_upwind")
    assert sorted(mt.state) == sorted(initial)
    before = dict(kernels.LAUNCHES)
    got, n_t = run_interval(state_from_numpy(initial, "cpu"), mt.geom_t,
                            mt.options, mt.advect_names, seconds,
                            time_aux=mt._time_aux())
    assert n_t == n
    assert kernels.LAUNCHES == before
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert np.isfinite(g).all(), k
        if k in ILL_CONDITIONED:
            rel = np.abs(g - w) / max(float(np.abs(w).max()), 1e-30)
            assert (rel > 1e-3).mean() <= chip_smoke.FULLPHYS_ILL_SHARE, k
            continue
        base = chip_smoke.FULLPHYS_BOUNDS[
            "species" if k in mt.advect_names else "other"]
        bound = max(base, 2 * spread[k])
        assert _worst(g, w) <= bound, (label, k, _worst(g, w), bound)
    for m in (got, want):
        assert float(np.asarray(m["convective_precipitation"]).max()) > 0
    return got


CASES = {"fullphys_nsas": JC.CU_NSAS, "fullphys_bmj": JC.CU_BMJ}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    label = request.param
    return label, jax_reference(CASES[label], chip_smoke.FULLPHYS_SMALL,
                                chip_smoke.FULLPHYS_SMALL_INTERVAL)


def test_interval_matches_the_jax_model(case):
    """NSAS and BMJ in the small full-physics case: ``check_interval``;
    BMJ's cloud efficiency moved off its start in both packages."""
    label, reference = case
    got = check_interval(label, CASES[label], chip_smoke.FULLPHYS_SMALL,
                         chip_smoke.FULLPHYS_SMALL_INTERVAL, reference)
    if label == "fullphys_bmj":
        for m in (got, reference[1]):
            assert float(np.abs(np.asarray(m["cldefi"]) - 0.6).max()) > 0.01


def test_paths_and_unported():
    """The three new paths are the fullphys ridge with the scheme in
    Tiedtke's place (K5 and K1, the 500x500x20 grid); nothing refuses an
    option the options' validation accepts (``_unported`` is gone since
    Thompson-aerosol, the last, was ported), and what it rejects (the
    simple convection scheme, conv=2) raises its ValueError; on a mesh
    (refused until the column loop ran on blocks) BMJ's small case takes
    the unsharded run's substeps and every bit of every field."""
    from icar_tpu_torch.models import icar
    from icar_tpu_torch.models.icar import FULLPHYS
    from icar_tpu_torch.parallel.mesh import make_mesh
    for label, conv in chip_smoke.CU_PATHS:
        assert RIDGE_PATHS[label] == dict(FULLPHYS, conv=conv)
    assert not hasattr(icar, "_unported")
    with pytest.raises(ValueError, match="conv=2"):
        ideal_ridge_model(**chip_smoke.FULLPHYS_SMALL,
                          **dict(FULLPHYS, conv=C.CU_SIMPLE), device="cpu")
    models = []
    for mesh in (None, make_mesh(30, 12, devices=["cpu"] * 4)):
        m = ideal_ridge_model(**chip_smoke.FULLPHYS_SMALL,
                              **RIDGE_PATHS["fullphys_bmj"], device="cpu")
        if mesh is not None:
            m.attach_mesh(mesh)
        m.advance(40.0)
        models.append(m)
    one, sharded = models
    assert sharded.last_n_substeps == one.last_n_substeps >= 2
    for k in one.state:
        np.testing.assert_array_equal(sharded.field(k).view(np.uint32),
                                      one.field(k).view(np.uint32),
                                      err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ideal_ridge_model(**chip_smoke.FULLPHYS_SMALL,
                              **RIDGE_PATHS["fullphys_kf"])

"""WSM3 (mp=6), WSM6 (mp=4) and Morrison (mp=3) through the port's model
and interval loops against the JAX package's model, on the CPU.

The ridges are the JAX package's tests' (tests/test_wsm3.py,
test_wsm6.py, test_morrison.py: 48x12x10, rh 1.0, one 1200 s interval)
with each scheme and upwind advection, and Morrison with MPDATA; the
full-physics case is tests/test_torch_column_general.py's (30x12x10 with
its water strip, one 600 s interval) with WSM3 in Thompson's place, so
that WSM3 and Tiedtke both read w_real. One module-scoped JAX model per
case runs its general loop jitted (its step built with
``fast_path=False``): from its initial state, once more from that state
one ulp up or down in theta and water vapour (seeded), and, on the
ridges, once more op by op (``jax.disable_jit()``: every primitive alone,
without the contractions XLA makes in the compiled step). The JAX
package's own spread of a field is the larger of those two runs' largest
difference from the jitted run over its largest magnitude. The port runs
the interval from the JAX model's initial state
(convert.state_from_numpy) with no kernel (the plain versions of K1 and
K4): the same substeps, and every field within the larger of
chip_smoke.py's FULLPHYS_BOUNDS (1e-4 for the advected species, 1e-3 for
the others; the cloud fraction and the longwave by the share of cells
past 1e-3, at most 5%) and twice that spread of the jitted run, and
within FULLPHYS_BOUNDS of the op-by-op run. The ridges cross thresholds
(Morrison's autoconversion at 1e-6 kg/kg of cloud water in a surface
cell, WSM6's at QC0) where the compiled JAX step's contractions alone
move the precipitation, the cloud and the rain by up to 2.4e-3 of their
largest values, as far as the port does; the op-by-op run, whose
arithmetic the port follows, stays within FULLPHYS_BOUNDS of it.
Morrison's two ridges are in tests/test_torch_mp_models_morrison.py, so
that their op-by-op runs take another test worker.

Also: each scheme runs with MPDATA and in the column-physics loop; the
file-driven run with Morrison through ``python -m icar_tpu_torch
options.nml``; a mesh refused for these schemes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.driver import main
from icar_tpu_torch.core.step import path_kernels, run_interval
from icar_tpu_torch.forcing.ideal import write_ideal_files
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.models.icar import FULLPHYS, ideal_ridge_model
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the bounds and the small file case)

RIDGE = dict(nx=48, ny=12, nz=10, dx=1000.0, hill_height=600.0,
             u_speed=10.0, rh=1.0)
FULLPHYS_CASE = dict(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0,
                     u_speed=9.0, rh=1.0)
# case -> (grid, JAX options, port options, seconds, the path's kernels)
CASES = {
    "wsm3": (RIDGE, dict(mp=JC.MP_WSM3), dict(mp=C.MP_WSM3), 1200.0,
             ("advect_upwind",)),
    "wsm6": (RIDGE, dict(mp=JC.MP_WSM6), dict(mp=C.MP_WSM6), 1200.0,
             ("advect_upwind",)),
    "morrison": (RIDGE, dict(mp=JC.MP_MORRISON), dict(mp=C.MP_MORRISON),
                 1200.0, ("advect_upwind",)),
    "morrison_mpdata": (RIDGE, dict(mp=JC.MP_MORRISON, adv=JC.ADV_MPDATA),
                        dict(mp=C.MP_MORRISON, adv=C.ADV_MPDATA), 1200.0,
                        ("advect_mpdata",)),
    "fullphys_wsm3": (FULLPHYS_CASE, dict(
        mp=JC.MP_WSM3, windtype=JC.WIND_CONSERVE_MASS, rad=JC.RA_SIMPLE,
        pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH, water=JC.WATER_SIMPLE,
        conv=JC.CU_TIEDTKE), dict(FULLPHYS, mp=C.MP_WSM3), 600.0,
        ("advect_upwind",)),
}
ILL_CONDITIONED = chip_smoke.FULLPHYS_ILL_CONDITIONED


def _worst(got, want):
    """max |got - want| / max |want| (0 where both are all zero)."""
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def _jax_run(mj, initial, seconds):
    """The JAX step over one interval of ``seconds`` from ``initial``:
    (state as numpy arrays, substeps)."""
    out, _, n = mj._step_fn({k: jnp.array(v) for k, v in initial.items()},
                            {}, jnp.float32(0.0), jnp.float32(seconds),
                            mj._time_aux(), mj.geom_args())
    return {k: np.asarray(v) for k, v in out.items()}, int(n)


def jax_reference(name):
    """The JAX package's runs of case ``name``: (initial state, the jitted
    interval's state, its substeps, the op-by-op interval's state on a
    ridge or None, the JAX package's own spread of each field), states as
    numpy arrays."""
    grid, jopts, _, seconds, _ = CASES[name]
    mj = jax_model(**grid, **jopts)
    fullphys = "fullphys" in name
    if fullphys:
        lm = np.asarray(mj.state["land_mask"]).copy()
        lm[:, :10] = 2.0
        mj.state = dict(mj.state)
        mj.state["land_mask"] = jnp.asarray(lm)
    mj._step_fn = make_step_fn(mj.options, mj.geom, mj.advect_names, False,
                               fast_path=False)
    initial = {k: np.asarray(v) for k, v in mj.state.items()}
    want, n = _jax_run(mj, initial, seconds)
    r = np.random.default_rng(0)
    nudged = dict(initial)
    for k in ("potential_temperature", "water_vapor"):
        a = initial[k]
        to = np.where(r.uniform(size=a.shape) < 0.5, np.inf, -np.inf)
        nudged[k] = np.nextafter(a, to.astype(np.float32))
    others = [_jax_run(mj, nudged, seconds)[0]]
    op_by_op = None
    if not fullphys:
        with jax.disable_jit():
            op_by_op, n_op = _jax_run(mj, initial, seconds)
        assert n_op == n
        others.append(op_by_op)
    spread = {k: max(_worst(o[k], want[k]) for o in others) for k in want}
    return initial, want, n, op_by_op, spread


def check_interval(name, reference):
    """One interval of case ``name`` in the port against the JAX
    package's ``reference`` (``jax_reference``): the same substeps, no
    kernel launched (the plain versions on the CPU), every field within
    the larger of FULLPHYS_BOUNDS and twice the JAX package's own spread
    of the jitted run, and within FULLPHYS_BOUNDS of the op-by-op run;
    cloud and precipitation in both; the number concentrations never
    negative."""
    initial, want, n, op_by_op, spread = reference
    grid, _, opts, seconds, path = CASES[name]
    mt = ideal_ridge_model(**grid, **opts, device="cpu")
    assert path_kernels(mt.options) == path
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
        assert _worst(g, w) <= bound, (k, _worst(g, w), bound)
        if op_by_op is not None:
            assert _worst(g, op_by_op[k]) <= base, \
                (k, _worst(g, op_by_op[k]), base)
    for m in (got, want):
        assert float(m["cloud_water"].max()) > 0
        assert float(m["precipitation"].max()) > 0
        for k in ("ice_number", "snow_number", "rain_number",
                  "graupel_number"):
            if k in m:
                assert float(m[k].min()) >= 0, k


@pytest.fixture(scope="module",
                params=("fullphys_wsm3", "wsm3", "wsm6"))
def jax_case(request):
    return request.param, jax_reference(request.param)


def test_interval_matches_the_jax_model(jax_case):
    """WSM3 and WSM6 on the ridge, WSM3 in the full-physics case:
    ``check_interval``."""
    check_interval(*jax_case)


@pytest.mark.parametrize("mp", [C.MP_WSM3, C.MP_WSM6, C.MP_MORRISON])
@pytest.mark.parametrize("loop", ["mpdata", "column_physics"])
def test_each_scheme_runs_with_mpdata_and_the_column_physics(mp, loop,
                                                            monkeypatch):
    """Each scheme with MPDATA on the ridge (K4's plain version on its
    stack) and in the small full-physics case (the column-physics loop,
    with Tiedtke): one interval with finite fields and cloud, the scheme
    called every substep and no kernel launched on the CPU; the path's
    only kernel is the advection's."""
    from icar_tpu_torch.core import step
    module = step.PLAIN_MP[mp]
    name = {C.MP_WSM3: "wsm3", C.MP_WSM6: "wsm6",
            C.MP_MORRISON: "mp_morrison"}[mp]
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    if loop == "mpdata":
        m = ideal_ridge_model(**RIDGE, mp=mp, adv=C.ADV_MPDATA,
                              device="cpu")
        assert path_kernels(m.options) == ("advect_mpdata",)
    else:
        m = ideal_ridge_model(**FULLPHYS_CASE, **dict(FULLPHYS, mp=mp),
                              device="cpu")
        assert path_kernels(m.options) == ("advect_upwind",)
    before = dict(kernels.LAUNCHES)
    m.advance(600.0)
    assert len(calls) == m.last_n_substeps > 1
    assert kernels.LAUNCHES == before
    for k in m.state:
        assert np.isfinite(m.field(k)).all(), k
    assert m.field("cloud_water").max() > 0


@pytest.mark.parametrize("mp", [C.MP_WSM3, C.MP_WSM6, C.MP_MORRISON])
def test_a_mesh_is_refused(mp):
    """A mesh refused these schemes until they ran block by block (the
    name is kept): the ridge with each, with a v flow across the shard
    edges, on a mesh of four CPU devices takes the unsharded run's
    substeps and every bit of every field (the sedimentation's trips,
    read per block, leave a column past its own count as it is)."""
    from icar_tpu_torch.forcing.ideal import make_ideal_case
    models = []
    for mesh in (None, make_mesh(20, 8, devices=["cpu"] * 4)):
        m = ideal_ridge_model(nx=20, ny=8, nz=10, hill_height=600.0, mp=mp,
                              rh=1.0, device="cpu")
        m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                                 v_profile=4.0, rh=1.0))
        if mesh is not None:
            m.attach_mesh(mesh)
        m.advance(180.0)
        models.append(m)
    one, sharded = models
    assert sharded.last_n_substeps == one.last_n_substeps >= 4
    assert one.field("cloud_water").max() > 0
    for k in one.state:
        np.testing.assert_array_equal(sharded.field(k).view(np.uint32),
                                      one.field(k).view(np.uint32),
                                      err_msg=k)


def test_file_driven_run_with_morrison(tmp_path):
    """``python -m icar_tpu_torch options.nml`` with mp=3 (``main`` with
    ``--device cpu``) on chip_smoke.py's small file case: it runs the
    hour, writes the four number concentrations at 0, 1800 and 3600 s,
    finite and never negative, and its restart holds them; without
    ``--device cpu`` it asks for the card."""
    init, forcing = write_ideal_files(str(tmp_path), **chip_smoke.FILE_SMALL)
    prefix = str(tmp_path / "morrison_")
    nml = chip_smoke.write_namelist(prefix + "options.nml", init, forcing,
                                    prefix, chip_smoke.FILE_SMALL_Z,
                                    dict(mp=3, adv=1))
    numbers = ("ice_number", "snow_number", "rain_number", "graupel_number")
    names = ("potential_temperature", "water_vapor", "cloud_water",
             "rain_mass") + numbers
    text = open(nml).read().replace(
        "restartinterval = 1,", "restartinterval = 1,\n    names = "
        + ", ".join(f'"{n}"' for n in names) + ",")
    with open(nml, "w") as f:
        f.write(text)
    assert main([nml, "--device", "cpu"]) == 0
    with NCFile(prefix + "out_run.nc") as f:
        assert set(names) <= set(f.variables())
        for n in numbers:
            a = f.read(n)
            assert a.shape[0] == 3 and np.isfinite(a).all() and \
                (a >= 0).all(), n
    with NCFile(prefix + "rst_00003600.nc") as f:
        assert set(numbers) <= set(f.variables())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([nml])

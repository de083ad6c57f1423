"""Thompson-aerosol (mp=5) through the port's model, interval loops, mesh
and file-driven run, on the CPU.

One JAX model: the aerosol-aware ridge of tests/test_thompson_aer.py's
model test (48x12x10, rh 1.0, MPDATA as on bench.py's mpdata_thompson
ridge) over one 600 s interval, its general loop (``fast_path=False``)
jitted from its initial state, once more from that state one ulp up or down
in theta and water vapour (seeded), and once op by op
(``jax.disable_jit()``). The JAX package's own spread of a field is the
larger of those two runs' largest difference from the jitted run over its
largest magnitude. The port runs the interval from the JAX model's initial
state (convert.state_from_numpy) with the plain versions of the kernels:
the same substeps, and every field -- the nine species, the droplet
number, nwfa, nifa, the effective radii, the accumulators -- within the
larger of chip_smoke.py's FULLPHYS_BOUNDS and twice that spread of the
jitted run, and within the larger of FULLPHYS_BOUNDS and twice the
one-ulp run's spread of the op-by-op run (the JAX package's jitted step
alone moves threshold cells, ROADMAP section 3; the droplet radius jumps
from its 2.49e-6 m default where a cloud edge evaporates whole in one run
and not in another, by 22% of its largest value here).

Without a JAX model: the port's default aerosol profiles equal the JAX
model's; mp=5 without the aerosol-aware option gives mp=1's ridge bit for
bit, with the radii of the state its last K5 call left; a 4-device CPU mesh
of either mode equals the unsharded run bit for bit; in the column physics
RRTMG reads the radii of the microphysics before it (mp=1 leaves them at
the registry's defaults); the file-driven run with either mode, resumed
from its checkpoint bit for bit; restart files both ways between the
packages; the driver's nwfa2d after an ingest that carries nwfa.
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
from icar_tpu.physics import mp_thompson as jmt
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core import step as tstep
from icar_tpu_torch.core.driver import ICARDriver, main
from icar_tpu_torch.core.step import path_kernels, run_interval
from icar_tpu_torch.forcing.ideal import write_ideal_files
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.models.icar import (FULLPHYS_RRTMG_NOAH, RIDGE_PATHS,
                                        SHARDED_PATHS, ideal_ridge_model,
                                        synthetic_rrtmg_tables)
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.parallel.mesh import make_mesh
from icar_tpu_torch.physics import mp_thompson as mt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the bounds and the small file case)

RIDGE = dict(nx=48, ny=12, nz=10, dx=1000.0, hill_height=600.0,
             u_speed=10.0, rh=1.0)
SECONDS = 600.0
AWARE = RIDGE_PATHS["thompson_aer_aware"]
CONSTANT_NC = RIDGE_PATHS["thompson_aer"]


def _aware(o):
    o.mp.use_aerosol_aware = True


def _worst(got, want):
    """max |got - want| / max |want| (0 where both are all zero)."""
    want = np.asarray(want, np.float64)
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    return d / max(float(np.abs(want).max()), 1e-30) if d else 0.0


def _jax_run(mj, initial):
    out, _, n = mj._step_fn({k: jnp.array(v) for k, v in initial.items()},
                            {}, jnp.float32(0.0), jnp.float32(SECONDS),
                            mj._time_aux(), mj.geom_args())
    return {k: np.asarray(v) for k, v in out.items()}, int(n)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's runs of the aerosol-aware ridge: (initial state,
    the jitted interval's state, its substeps, the op-by-op interval's
    state, the JAX package's own spread of each field), as numpy arrays."""
    mj = jax_model(**RIDGE, mp=JC.MP_THOMPSON_AER, adv=JC.ADV_MPDATA,
                   options_cb=_aware)
    mj._step_fn = make_step_fn(mj.options, mj.geom, mj.advect_names, False,
                               fast_path=False)
    initial = {k: np.asarray(v) for k, v in mj.state.items()}
    want, n = _jax_run(mj, initial)
    r = np.random.default_rng(0)
    nudged = dict(initial)
    for k in ("potential_temperature", "water_vapor"):
        a = initial[k]
        to = np.where(r.uniform(size=a.shape) < 0.5, np.inf, -np.inf)
        nudged[k] = np.nextafter(a, to.astype(np.float32))
    with jax.disable_jit():
        op_by_op, n_op = _jax_run(mj, initial)
    assert n_op == n
    one_ulp = _jax_run(mj, nudged)[0]
    nudge = {k: _worst(one_ulp[k], want[k]) for k in want}
    spread = {k: max(nudge[k], _worst(op_by_op[k], want[k])) for k in want}
    return initial, want, n, op_by_op, spread, nudge, mj


def test_aware_ridge_matches_the_jax_model(reference):
    """One interval of the aerosol-aware ridge against the JAX model: the
    same substeps, no kernel launched, every field within the larger of
    FULLPHYS_BOUNDS and twice the JAX package's own spread, and of its
    op-by-op run within the larger of FULLPHYS_BOUNDS and twice the
    one-ulp run's spread; cloud, droplets and precipitation in both, nwfa
    moved off its start, the droplet radius off its default."""
    initial, want, n, op_by_op, spread, nudge, _ = reference
    m = ideal_ridge_model(**RIDGE, **AWARE, device="cpu")
    assert path_kernels(m.options) == ("advect_mpdata",)
    assert len(m.advect_names) == 12
    assert sorted(m.state) == sorted(initial)
    before = dict(kernels.LAUNCHES)
    got, n_t = run_interval(state_from_numpy(initial, "cpu"), m.geom_t,
                            m.options, m.advect_names, SECONDS,
                            time_aux=m._time_aux())
    assert n_t == n
    assert kernels.LAUNCHES == before
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        base = chip_smoke.FULLPHYS_BOUNDS[
            "species" if k in m.advect_names else "other"]
        bound = max(base, 2 * spread[k])
        assert _worst(g, want[k]) <= bound, (k, _worst(g, want[k]), bound)
        bound = max(base, 2 * nudge[k])
        assert _worst(g, op_by_op[k]) <= bound, \
            (k, _worst(g, op_by_op[k]), bound)
    for s in (got, want):
        s = {k: np.asarray(v) for k, v in s.items()}
        assert s["cloud_water"].max() > 0 and s["precipitation"].max() > 0
        assert s["cloud_number"].max() > 0
        assert np.abs(s["nwfa"] - initial["nwfa"]).max() > 0
        assert s["re_cloud"].max() > 2.49e-6


def test_default_aerosols_equal_the_jax_models(reference):
    """The port's model installs the JAX model's nwfa, nifa and nwfa2d
    bit for bit at construction (aer_init_profiles, aer_surface_flux on
    the host), and the rest of the initial state it starts from."""
    initial = reference[0]
    m = ideal_ridge_model(**RIDGE, **AWARE, device="cpu")
    for k in ("nwfa", "nifa", "nwfa2d"):
        np.testing.assert_array_equal(m.field(k), initial[k], err_msg=k)
    assert m.field("nwfa2d").min() > 0


def test_restarts_cross_between_the_packages(reference, tmp_path):
    """The aware ridge's restart files go both ways: the JAX package's
    reader takes the port's checkpoint (after one interval) and the
    port's reader the JAX package's, every field of the registry's
    restart list equal -- the same list in both packages, holding the
    droplet number, nwfa, nifa, nwfa2d and the radii."""
    from icar_tpu.core.state import restart_names as jax_restart_names
    from icar_tpu.io.output import read_restart as jax_read
    from icar_tpu.io.output import write_restart as jax_write
    from icar_tpu_torch.core.state import restart_names
    from icar_tpu_torch.io.output import read_restart, write_restart
    mj = reference[-1]
    m = ideal_ridge_model(**RIDGE, **AWARE, device="cpu")
    m.advance(SECONDS)
    names = restart_names(m.options)
    assert names == sorted(jax_restart_names(mj.options))
    assert {"cloud_number", "nwfa", "nifa", "nwfa2d", "re_cloud", "re_ice",
            "re_snow"} <= set(names)
    port_file = str(tmp_path / "port_rst.nc")
    write_restart(port_file, m, SECONDS)
    assert jax_read(port_file, mj) == SECONDS
    for k in names:
        np.testing.assert_array_equal(np.asarray(mj.state[k]), m.field(k),
                                      err_msg=k)
    jax_file = str(tmp_path / "jax_rst.nc")
    jax_write(jax_file, mj, SECONDS)
    back = ideal_ridge_model(**RIDGE, **AWARE, device="cpu")
    assert read_restart(jax_file, back) == SECONDS
    for k in names:
        np.testing.assert_array_equal(back.field(k), m.field(k), err_msg=k)
    assert float(np.abs(back.field("re_cloud")).max()) > 2.49e-6


def _record_k5(monkeypatch):
    """Record the stack each K5 call (``kernels.mp_thompson_stack``) of the
    loop leaves."""
    stacks = []
    fn = kernels.mp_thompson_stack

    def wrap(q, *a, **k):
        out = fn(q, *a, **k)
        stacks.append(q.clone())
        return out
    monkeypatch.setattr(kernels, "mp_thompson_stack", wrap)
    return stacks


def test_constant_nc_is_thompson_with_radii(monkeypatch):
    """mp=5 without the aerosol-aware option: K5 then the radii. Its ridge
    equals mp=1's bit for bit in every field they share, over two
    intervals; its radii are calc_effect_rad (constant Nt_c) of the state
    its last K5 call left, and moved off the defaults."""
    a = ideal_ridge_model(**RIDGE, **CONSTANT_NC, device="cpu")
    b = ideal_ridge_model(**RIDGE, **RIDGE_PATHS["Thompson"], device="cpu")
    assert path_kernels(a.options) == path_kernels(b.options)
    assert set(a.state) - set(b.state) == {"re_cloud", "re_ice", "re_snow"}
    for m in (a, b, b):
        m.advance(SECONDS)
    stacks = _record_k5(monkeypatch)
    a.advance(SECONDS)
    assert len(stacks) == a.last_n_substeps > 1
    for k in b.state:
        assert torch.equal(a.state[k], b.state[k]), k
    row = {n: stacks[-1][i] for i, n in enumerate(a.advect_names)}
    s = a.state
    want = mt.calc_effect_rad(row["potential_temperature"] * s["exner"],
                              s["pressure"], row["water_vapor"],
                              row["cloud_water"], row["cloud_ice"],
                              row["ice_number"], row["snow_mass"])
    for name, w in zip(("re_cloud", "re_ice", "re_snow"), want):
        assert torch.equal(s[name], w), name
    assert float(s["re_cloud"].max()) > 2.49e-6


@pytest.mark.parametrize("label", ["thompson_aer", "thompson_aer_aware"])
def test_a_mesh_equals_the_unsharded_run(label):
    """Either mode on a 4-device CPU mesh (2x2) over two intervals: the
    unsharded run's substeps and every field bit for bit (the aerosol-aware
    scheme runs block by block, with its halo)."""
    assert label in SHARDED_PATHS
    one = ideal_ridge_model(**RIDGE, **RIDGE_PATHS[label], device="cpu")
    four = ideal_ridge_model(**RIDGE, **RIDGE_PATHS[label], device="cpu")
    four.attach_mesh(make_mesh(RIDGE["nx"], RIDGE["ny"],
                               devices=["cpu"] * 4))
    for _ in range(2):
        one.advance(SECONDS)
        four.advance(SECONDS)
        assert four.last_n_substeps == one.last_n_substeps
    for k in one.state:
        assert torch.equal(four.global_field(k), one.state[k]), k
    assert one.digest() == four.digest()


def test_rrtmg_reads_the_radii_of_the_microphysics_before(monkeypatch):
    """The column physics with RRTMG every substep (the small RRTMG + YSU
    case, FULLPHYS_RRTMG_NOAH): under the aerosol-aware mp=5 each RRTMG
    call after the first reads the radii the microphysics of the substep
    before formed (with the droplet number), longwave and shortwave alike;
    under mp=1 the radii stay at the registry's defaults."""
    from icar_tpu_torch.physics import rrtmg_lw, rrtmg_sw
    seen = {"lw": [], "sw": []}
    for name, mod, fn in (("lw", rrtmg_lw, "rrtmg_lw_driver"),
                          ("sw", rrtmg_sw, "rrtmg_sw_driver")):
        orig = getattr(mod, fn)
        where = 13 if name == "lw" else 14

        def wrap(*a, _o=orig, _n=name, _w=where, **k):
            seen[_n].append(a[_w].clone())
            return _o(*a, **k)
        monkeypatch.setattr(mod, fn, wrap)
    formed = []
    radii = mt.calc_effect_rad

    def record(*a, **k):
        out = radii(*a, **k)
        formed.append((out[0].clone(), k.get("nc") is not None))
        return out
    monkeypatch.setattr(mt, "calc_effect_rad", record)

    def every_substep(mp, aware):
        def cb(o):
            synthetic_rrtmg_tables(o)
            o.physics.microphysics = mp
            o.rad.update_interval_rrtmg = 1.0
            o.mp.use_aerosol_aware = aware
        return cb
    m = ideal_ridge_model(**chip_smoke.FULLPHYS_SMALL,
                          **dict(FULLPHYS_RRTMG_NOAH,
                                 options_cb=every_substep(
                                     C.MP_THOMPSON_AER, True)),
                          device="cpu")
    m.advance(60.0)
    n = m.last_n_substeps
    assert n > 2 and len(formed) == n and len(seen["lw"]) == n
    assert all(aware for _, aware in formed)
    for i in range(1, n):
        for k in ("lw", "sw"):
            assert torch.equal(seen[k][i], formed[i - 1][0]), (k, i)
    assert float(formed[-1][0].max()) > 2.49e-6
    for k in ("lw", "sw"):
        seen[k].clear()
    formed.clear()
    m1 = ideal_ridge_model(**chip_smoke.FULLPHYS_SMALL,
                           **dict(FULLPHYS_RRTMG_NOAH,
                                  options_cb=every_substep(
                                      C.MP_THOMPSON, False)),
                           device="cpu")
    m1.advance(60.0)
    assert not formed and len(seen["lw"]) == m1.last_n_substeps
    for k in ("lw", "sw"):
        for r in seen[k]:
            assert float(r.min()) == float(r.max()) == np.float32(2.49e-6)
    for k in m.state:
        assert np.isfinite(m.field(k)).all(), k


def _file_case(tmp_path, aware, prefix, restart_from=None):
    init = str(tmp_path / "init.nc")
    forcing = str(tmp_path / "forcing.nc")
    if not os.path.exists(init):
        write_ideal_files(str(tmp_path), **chip_smoke.FILE_SMALL)
    nml = chip_smoke.write_namelist(
        str(tmp_path / f"{prefix}options.nml"), init, forcing,
        str(tmp_path / prefix), chip_smoke.FILE_SMALL_Z, dict(mp=5, adv=1),
        restart_from=restart_from)
    with open(nml, "a") as f:
        f.write("&mp_parameters\n    use_aerosol_aware = "
                f"{'.true.' if aware else '.false.'},\n/\n")
    return nml


@pytest.mark.parametrize("aware", [False, True])
def test_file_driven_run_resumes_bit_for_bit(tmp_path, aware):
    """``python -m icar_tpu_torch options.nml`` with mp=5 (``main`` with
    ``--device cpu``) on chip_smoke.py's small file case, and the run
    resumed from its 1800 s checkpoint: the 3600 s checkpoint equal to
    the uninterrupted run's bit for bit in every field it holds, which
    include the radii and, aerosol-aware, the droplet number, nwfa, nifa
    and nwfa2d; nwfa moved off its default profile (the surface flux)."""
    a = _file_case(tmp_path, aware, "a_")
    assert main([a, "--device", "cpu"]) == 0
    rst = str(tmp_path / "a_rst_00001800.nc")
    b = _file_case(tmp_path, aware, "b_", restart_from=rst)
    assert main([b, "--device", "cpu"]) == 0
    want = {"re_cloud", "re_ice", "re_snow"}
    if aware:
        want |= {"cloud_number", "nwfa", "nifa", "nwfa2d"}
    with NCFile(str(tmp_path / "a_rst_00003600.nc")) as fa, \
            NCFile(str(tmp_path / "b_rst_00003600.nc")) as fb:
        names = set(fa.variables())
        assert want <= names and names == set(fb.variables())
        for n in names:
            np.testing.assert_array_equal(fb.read(n), fa.read(n),
                                          err_msg=n)
        if aware:
            with NCFile(rst) as f0:
                assert not np.array_equal(fa.read("nwfa"), f0.read("nwfa"))


def test_driver_recomputes_nwfa2d_after_ingest(tmp_path, monkeypatch):
    """An ingest that carries nwfa and nifa (the port's regridder made to
    return them: neither package's regridder reads them from a file,
    ROADMAP section 3): the state takes them, and nwfa2d is the JAX
    driver's aer_surface_flux of the ingested surface level, bit for
    bit."""
    from icar_tpu_torch.config import Options
    from icar_tpu_torch.forcing.boundary import Regridder
    nml = _file_case(tmp_path, True, "c_")
    fields = {}
    orig = Regridder.to_model_grid

    def with_aerosols(self, raw, geom):
        out = orig(self, raw, geom)
        r = np.random.default_rng(3)
        shape = tuple(out["potential_temperature"].shape)
        for k, scale in (("nwfa", 2e9), ("nifa", 2e7)):
            fields[k] = np.asarray(r.uniform(0.1, 1.0, shape) * scale,
                                   np.float32)
            out[k] = torch.tensor(fields[k])
        return out
    monkeypatch.setattr(Regridder, "to_model_grid", with_aerosols)
    d = ICARDriver(Options.from_namelist(nml), device="cpu")
    s = d.model.state
    for k in ("nwfa", "nifa"):
        np.testing.assert_array_equal(s[k].numpy(), fields[k])
    want = np.asarray(jmt.aer_surface_flux(fields["nwfa"][0],
                                           d.model.geom.dx), np.float32)
    np.testing.assert_array_equal(s["nwfa2d"].numpy(), want)
    default = mt.aer_surface_flux(
        mt.aer_init_profiles(np.asarray(d.model.geom.z)
                             - np.asarray(d.model.geom.terrain)[None],
                             np.asarray(d.model.geom.terrain))[0][0],
        d.model.geom.dx)
    assert not np.allclose(want, default)


def test_paths_and_the_loops():
    """The two ridges are bench.py's mpdata_thompson ridge with mp=5: K5
    and K4 without the option, K4 alone with it (the scheme is plain
    PyTorch), timed as the stage mp_thompson_aer; the loops refuse a
    stack that is not the mode's species; without a card the default
    device raises."""
    o = ideal_ridge_model(nx=20, ny=8, nz=10, hill_height=600.0,
                          **CONSTANT_NC, device="cpu").options
    assert path_kernels(o) == ("mp_thompson", "advect_mpdata")
    assert tstep.mp_stage_name(o) == "mp_thompson"
    m = ideal_ridge_model(nx=20, ny=8, nz=10, hill_height=600.0, **AWARE,
                          device="cpu")
    assert path_kernels(m.options) == ("advect_mpdata",)
    assert tstep.mp_stage_name(m.options) == "mp_thompson_aer"
    assert tuple(m.advect_names) == mt.AER_SPECIES
    with pytest.raises(ValueError, match="not a configuration it runs"):
        run_interval(m.state, m.geom_t, m.options, m.advect_names[:9], 60.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ideal_ridge_model(nx=20, ny=8, nz=10, **AWARE)

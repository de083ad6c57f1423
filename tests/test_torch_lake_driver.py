"""The file-driven run with the CLM lake (water=3) and the forcing-only
options (radiation=1, lsm=1): the port's driver
(icar_tpu_torch/core/driver.py, with ``_init_lake``) against the JAX
package's, on the CPU, from the same files: tests/test_torch_driver.py's
small case (48x14x10 under write_ideal_files' forcing, one hour, forcing
and output every 1800 s, a restart at each output) with SB04 + upwind, the
simple PBL, radiation=1, lsm=1 and water=3 (chip_smoke.LAKE_FILE_PHYSICS).
The forcing file gains the shortwave, longwave, sensible and latent heat
and sst that these options read (chip_smoke.add_surface_forcing, named in
the namelist's var_list), and a strip of lake (MODIS category 21, 10 m
deep) is laid on the land use before the lake init
(chip_smoke.lake_land_use: neither driver reads a land-use category from
a file).

- At set-up both drivers run lake_init on the host: from the JAX driver's
  state before its init the port's ``_init_lake`` writes the same arrays.
- The same substeps; every output field at every output time and every
  field of the final state within the larger of FULLPHYS_BOUNDS and twice
  the port's own spread under one-ulp nudges of its state after set-up
  (three seeds)
  (the lake's energy residual folds float32 rounding of the column's
  energy into its sensible heat; the port's spread measures it); the lake
  fields' layer count and ice fraction by the share of cells.
- With lsm=1 and radiation=1 the land keeps the forcing's fluxes and
  radiation.
- Restarts both ways: the port resumed from the JAX driver's 1800 s
  restart (without the lake init) reaches the 3600 s state of the JAX
  driver resumed from it within the same bounds (a resumed lake run
  loses the lakes' water land mask in both packages, ROADMAP section 3);
  the JAX package's reader takes the port's 1800 s restart, every lake
  field equal; the port reads its own restart back bit for bit.
- The command line with the lake.
- mp=0 with advection=0 (no microphysics, no advection: theta and water
  vapour ride unadvected) against the JAX driver, and no kernel launched.
This file compiles the JAX driver's step twice (the lake case, whose
resumed run reuses it, then the small mp=0/advection=0 case, which
compiles neither microphysics nor advection).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from icar_tpu.config import Options as JOptions
from icar_tpu.core.driver import ICARDriver as JDriver
from icar_tpu.io.output import read_restart as jax_read_restart
from icar_tpu_torch.config import Options
from icar_tpu_torch.core import step as tstep
from icar_tpu_torch.core.driver import ICARDriver, main
from icar_tpu_torch.forcing.ideal import write_ideal_files
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.io.output import read_restart
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.physics import water_lake as twl
from test_torch_driver import _record_substeps, commit_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the small file case, no jax)

OUTPUT = ["u", "v", "w", "potential_temperature", "water_vapor",
          "cloud_water", "precipitation", "skin_temperature",
          "sensible_heat", "latent_heat", "shortwave", "longwave",
          "ground_heat_flux", "albedo", "t_grnd2d", "temperature_2m"]
# the fields the lake init writes (lake_init) and land_mask
INIT_FIELDS = ("lakemask", "snow_height", "lakedepth2d", "z_lake3d",
               "dz_lake3d", "watsat3d", "tkmg3d", "tksatu3d", "tkdry3d",
               "csol3d", "t_lake3d", "t_grnd2d", "t_soisno3d",
               "lake_icefrac3d", "h2osoi_vol3d", "h2osoi_ice3d",
               "h2osoi_liq3d", "z3d", "dz3d", "zi3d", "snl2d",
               "savedtke12d", "land_mask")
LAKE_FIELDS = tuple(k for k in INIT_FIELDS if k != "land_mask")
# the seeds of the one-ulp nudges (chip_smoke.nudged_after_init) that
# give the port's own spread
NUDGES = 3
# the loop's accumulators the restart files do not hold
NOT_RESTARTED = ("runoff_surface", "runoff_subsurface")


def _namelist(files, prefix, physics=None, restart_from=None):
    init, forcing = files
    return chip_smoke.write_namelist(
        prefix + "options.nml", init, forcing, prefix,
        chip_smoke.FILE_SMALL_Z,
        chip_smoke.LAKE_FILE_PHYSICS if physics is None else physics,
        restart_from=restart_from, var_list=chip_smoke.LAKE_FILE_VARS)


def _lake_options(cls, files, prefix, **kw):
    o = cls.from_namelist(_namelist(files, prefix, **kw))
    o.output.names = list(OUTPUT)
    return o


def _state(driver):
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in driver.model.state.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX driver's run, the port's and the port's nudged run of the
    same files, with the JAX driver's state before its lake init."""
    tmp = tmp_path_factory.mktemp("lake_driver")
    files = write_ideal_files(str(tmp), **chip_smoke.FILE_SMALL)
    chip_smoke.add_surface_forcing(files[1])
    before = {}
    init = JDriver._init_lake

    def recorded(self):
        before.update({k: np.asarray(v)
                       for k, v in self.model.state.items()})
        return init(self)
    JDriver._init_lake = recorded
    try:
        with chip_smoke.lake_land_use(chip_smoke.LAKE_FILE_BAND, JDriver):
            jd = JDriver(_lake_options(JOptions, files, str(tmp / "jax_")))
    finally:
        JDriver._init_lake = init
    jax_init = _state(jd)
    commit_state(jd.model)
    jax_substeps = _record_substeps(jd)
    jd.run()
    with chip_smoke.lake_land_use(chip_smoke.LAKE_FILE_BAND):
        td = ICARDriver(_lake_options(Options, files, str(tmp / "port_")),
                        device="cpu")
    port_init = _state(td)
    td.run()
    nudged = []
    for seed in range(NUDGES):
        with chip_smoke.lake_land_use(chip_smoke.LAKE_FILE_BAND), \
                chip_smoke.nudged_after_init(seed):
            nd = ICARDriver(_lake_options(Options, files,
                                          str(tmp / f"nudged{seed}_")),
                            device="cpu")
        nd.run()
        nudged.append(nd)
    return dict(tmp=tmp, files=files, jax=jd, jax_before=before,
                jax_init=jax_init, jax_substeps=jax_substeps, port=td,
                port_init=port_init, nudged=nudged)


def _read(path):
    with NCFile(path) as f:
        return {n: f.read(n) for n in f.variables()}


def _spread(runs):
    """The port's own spread: the largest |nudged - port| over the port
    field's largest magnitude of the NUDGES nudged runs, for the final
    state's fields and, under "out:", the output file's."""
    def rel(a, b):
        return float(np.abs(a - b.astype(np.float64)).max()
                     / max(float(np.abs(b).max()), 1e-30))
    port, po = _state(runs["port"]), _read(runs["port"].writer.path)
    out = {}
    for nd in runs["nudged"]:
        state, no = _state(nd), _read(nd.writer.path)
        pairs = [(k, state[k], port[k]) for k in port] + [
            ("out:" + k, no[k], po[k]) for k in OUTPUT]
        for k, a, b in pairs:
            out[k] = max(out.get(k, 0.0), rel(a, b))
    return out


def _bound(name, spread, advected):
    base = chip_smoke.FULLPHYS_BOUNDS["species" if name in advected
                                      else "other"]
    return max(base, 2 * spread.get(name, 0.0))


def _hold(got, want, name, bound):
    """|got - want| within ``bound`` of ``want``'s largest magnitude; a
    level field (chip_smoke.LAKE_LEVEL_FIELDS) in all but
    FULLPHYS_ILL_SHARE of its cells. Returns the ratio to the bound."""
    want = np.asarray(want, np.float64)
    rel = np.abs(np.asarray(got, np.float64) - want) \
        / max(float(np.abs(want).max()), 1e-30)
    if name in chip_smoke.LAKE_LEVEL_FIELDS:
        assert (rel > bound).mean() <= chip_smoke.FULLPHYS_ILL_SHARE, name
        return 0.0
    assert rel.max() <= bound, (name, rel.max(), bound)
    return float(rel.max()) / bound


def test_init_fields_equal(runs):
    """From the JAX driver's state before its lake init, the port's
    ``_init_lake`` writes the JAX init's arrays; both drivers found the
    strip's lake cells, and made them water."""
    td = runs["port"]
    saved = td.model.state
    td.model.state = {k: torch.as_tensor(v, dtype=saved[k].dtype)
                      for k, v in runs["jax_before"].items()}
    try:
        td._init_lake()
        got = _state(td)
    finally:
        td.model.state = saved
    want = runs["jax_init"]
    for k in INIT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lake = want["lakemask"] > 0.5
    b0, b1 = chip_smoke.LAKE_FILE_BAND
    assert lake.sum() == lake.shape[0] * (b1 - b0)
    assert lake[:, b0:b1].all() and (want["land_mask"][lake] == 2.0).all()
    assert (runs["port_init"]["lakemask"] == want["lakemask"]).all()
    np.testing.assert_allclose(runs["port_init"]["t_lake3d"],
                               want["t_lake3d"], rtol=2e-7)


def test_output_matches_jax_driver(runs):
    """The same substeps an interval; every output field at t = 0, 1800
    and 3600 s and every field of the final state within the larger of
    FULLPHYS_BOUNDS and twice the port's own one-ulp spread."""
    assert runs["port"].substeps == runs["jax_substeps"]
    spread = _spread(runs)
    adv = runs["port"].model.advect_names
    want = _read(runs["jax"].writer.path)
    got = _read(runs["port"].writer.path)
    assert sorted(got) == sorted(OUTPUT + ["model_time"])
    for name in OUTPUT:
        assert got[name].shape == want[name].shape and len(got[name]) == 3
        for i in range(3):
            _hold(got[name][i], want[name][i], name,
                  _bound("out:" + name, spread, adv))
    jstate, tstate = _state(runs["jax"]), _state(runs["port"])
    assert sorted(jstate) == sorted(tstate)
    for name in tstate:
        _hold(tstate[name], jstate[name], name, _bound(name, spread, adv))
    # the lake ran: its top layer and its fluxes moved
    lake = tstate["lakemask"] > 0.5
    assert (tstate["t_lake3d"][0][lake]
            != runs["port_init"]["t_lake3d"][0][lake]).all()
    assert np.isfinite(tstate["t_lake3d"][:, lake]).all()


def test_forcing_fluxes_and_radiation_stay_on_land(runs):
    """With lsm=1 and radiation=1 the land keeps the forcing's sensible
    and latent heat, shortwave and longwave (integrated from its
    tendencies to the last forcing step's values); the lake cells get the
    lake's fluxes."""
    s = _state(runs["port"])
    land = s["land_mask"] == 1.0
    lake = s["lakemask"] > 0.5
    for name, key in (("sensible_heat", "sh"), ("latent_heat", "lh"),
                      ("shortwave", "swdown"), ("longwave", "lwdown")):
        want = chip_smoke.LAKE_FILE_SURFACE[key][-1]
        np.testing.assert_allclose(s[name][land], want, rtol=1e-4,
                                   err_msg=name)
    assert (np.abs(s["latent_heat"][lake]
                   - chip_smoke.LAKE_FILE_SURFACE["lh"][-1]) > 1.0).all()


def _resumed_jax(runs):
    """The JAX driver resumed from its own 1800 s checkpoint, run to 3600 s
    on the uninterrupted run's compiled step (the same options, geometry
    and shapes; only the restart flag differs)."""
    if "jax_resumed" not in runs:
        o = _lake_options(JOptions, runs["files"],
                          str(runs["tmp"] / "jres_"))
        o.run.restart = True
        o.run.restart_in_file = str(runs["tmp"] / "jax_rst_00001800.nc")
        jr = JDriver(o)
        jr.model._with_forcing = True
        jr.model._step_fn = runs["jax"].model._step_fn
        commit_state(jr.model)
        runs["jax_resumed_substeps"] = _record_substeps(jr)
        jr.run()
        runs["jax_resumed"] = jr
    return runs["jax_resumed"]


def test_resumes_from_jax_restart(runs, monkeypatch):
    """The port resumed from the JAX driver's 1800 s checkpoint, without
    the lake init, reaches the 3600 s state of the JAX driver resumed from
    it within the bounds of test_output_matches_jax_driver. Both lose the
    lake cells' water land mask (ROADMAP section 3: the restart does not
    hold it and the init is skipped), so neither equals its uninterrupted
    run."""
    o = _lake_options(Options, runs["files"], str(runs["tmp"] / "res_"))
    o.run.restart = True
    o.run.restart_in_file = str(runs["tmp"] / "jax_rst_00001800.nc")
    calls = []
    monkeypatch.setattr(twl, "lake_init",
                        lambda *a, **k: calls.append(1))
    d = ICARDriver(o, device="cpu")
    d.run()
    assert not calls
    jr = _resumed_jax(runs)
    assert d.substeps == runs["jax_resumed_substeps"] \
        == runs["jax_substeps"][1:]
    spread = _spread(runs)
    jstate, tstate = _state(jr), _state(d)
    assert sorted(jstate) == sorted(tstate)
    for name, got in tstate.items():
        _hold(got, jstate[name], name,
              _bound(name, spread, d.model.advect_names))
    lake = tstate["lakemask"] > 0.5
    for state in (jstate, tstate):
        assert (state["land_mask"][lake] == 1.0).all()
    assert not np.array_equal(tstate["land_mask"],
                              _state(runs["port"])["land_mask"])


def test_jax_reads_port_restart(runs):
    """The JAX package's reader takes the port's 1800 s checkpoint: every
    lake field it restores equals the port's restart file's."""
    jd = runs["jax"]
    m = type(jd.model)(copy.deepcopy(jd.options),
                       np.asarray(jd.model.geom.terrain, np.float64),
                       np.asarray(jd.model.geom.lat),
                       np.asarray(jd.model.geom.lon))
    path = runs["tmp"] / "port_rst_00001800.nc"
    assert jax_read_restart(str(path), m) == 1800.0
    saved = _read(str(path))
    restored = [k for k in LAKE_FIELDS if k in saved]
    assert set(restored) >= {"t_lake3d", "lake_icefrac3d", "t_soisno3d",
                             "snl2d", "zi3d", "lakemask", "savedtke12d"}
    for k in restored:
        np.testing.assert_array_equal(
            np.asarray(m.state[k]), np.asarray(saved[k]).reshape(
                m.state[k].shape), err_msg=k)


def test_port_reads_its_restart(runs):
    """The port's driver resuming from its own 1800 s checkpoint reads
    every field the file holds, bit for bit, the lake's among them (a lake
    run
    resumed does not reproduce its uninterrupted run: see
    test_resumes_from_jax_restart)."""
    o = _lake_options(Options, runs["files"], str(runs["tmp"] / "self_"))
    o.run.restart = True
    o.run.restart_in_file = str(runs["tmp"] / "port_rst_00001800.nc")
    d = ICARDriver(o, device="cpu")
    # the driver's run reads its checkpoint first (ICARDriver.run)
    assert read_restart(d._pick_restart(), d.model) == 1800.0
    saved = _read(o.run.restart_in_file)
    state = _state(d)
    assert set(LAKE_FIELDS) - {"snow_height"} <= set(saved)
    for k, v in saved.items():
        if k in state:
            np.testing.assert_array_equal(
                state[k], np.asarray(v).reshape(state[k].shape), err_msg=k)


def test_main_with_lake(runs, tmp_path):
    """``python -m icar_tpu_torch options.nml --device cpu`` with the lake
    and the forcing-only options runs, writing the port's output."""
    nml = _namelist(runs["files"], str(tmp_path / "cli_"))
    with chip_smoke.lake_land_use(chip_smoke.LAKE_FILE_BAND):
        assert main([nml, "--device", "cpu"]) == 0
    got = _read(str(tmp_path / "cli_out_run.nc"))
    assert np.isfinite(got["potential_temperature"]).all()
    rst = _read(str(tmp_path / "cli_rst_00003600.nc"))
    assert rst["lakemask"].sum() > 0


@pytest.fixture(scope="module")
def bare(tmp_path_factory):
    """The small case with mp=0 and advection=0, by the JAX driver and by
    the port's (launch counts from 0)."""
    tmp = tmp_path_factory.mktemp("bare_driver")
    files = write_ideal_files(str(tmp), **chip_smoke.FILE_SMALL)
    physics = dict(mp=0, adv=0)
    init, forcing = files
    out = {}
    for label, cls, driver, kw in (("jax", JOptions, JDriver, {}),
                                   ("port", Options, ICARDriver,
                                    dict(device="cpu"))):
        nml = chip_smoke.write_namelist(
            str(tmp / f"{label}_options.nml"), init, forcing,
            str(tmp / f"{label}_"), chip_smoke.FILE_SMALL_Z, physics)
        o = cls.from_namelist(nml)
        o.output.names = ["u", "v", "w", "potential_temperature",
                          "water_vapor"]
        kernels.reset_launches()
        d = driver(o, **kw)
        if label == "jax":
            out["jax_substeps"] = _record_substeps(d)
        d.run()
        out[label] = d
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def test_no_microphysics_no_advection(bare):
    """mp=0 with advection=0: theta and water vapour ride unadvected, no
    kernel is on the path and none launched, and every field of the final
    state and the output matches the JAX driver's at rtol 1e-5, atol 1e-7
    (no scheme branches on an ulp here)."""
    td, jd = bare["port"], bare["jax"]
    assert tuple(td.model.advect_names) == tstep.NO_MP_SPECIES
    assert tstep.path_kernels(td.model.options) == ()
    assert set(bare["launches"].values()) == {0}
    assert td.substeps == bare["jax_substeps"]
    jstate, tstate = _state(jd), _state(td)
    assert sorted(jstate) == sorted(tstate)
    for name in tstate:
        np.testing.assert_allclose(tstate[name], jstate[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    want, got = _read(jd.writer.path), _read(td.writer.path)
    for name in ("u", "v", "w", "potential_temperature", "water_vapor"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_the_driver_runs_on_the_card_by_default(runs, tmp_path):
    """The lake's file-driven run and mp=0/advection=0 take the card
    unless asked for the CPU: without a card the driver and the command
    line raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card runs are chip_smoke.py's")
    nml = _namelist(runs["files"], str(tmp_path / "card_"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ICARDriver(Options.from_namelist(nml))
    bare = _namelist(runs["files"], str(tmp_path / "bare_"),
                     physics=dict(mp=0, adv=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([bare])

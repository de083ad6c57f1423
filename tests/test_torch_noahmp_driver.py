"""The file-driven run with Noah-MP (lsm=4): the port's driver
(icar_tpu_torch/core/driver.py, with ``_init_noahmp``) against the JAX
package's, on the CPU, from the same files: tests/test_torch_driver.py's
small case (48x14x10 under write_ideal_files' forcing, SB04 + upwind,
one hour, forcing and output every 1800 s, a restart at each output) with
Noah-MP and the simple PBL.

- At set-up both drivers run the Noah-MP init (noahmp_init + snow_init)
  on the host: from the JAX driver's surface fields the port's writes
  the same arrays. (The two drivers' regridded lowest temperature, the
  skin temperature the init starts from, differs by an ulp in 4% of the
  cells.)
- The same substeps; every output field at every output time within
  FULLPHYS_BOUNDS of the JAX driver's (relative to the field's largest
  magnitude: 1e-4 for the advected species, 1e-3 for the rest).
- Restarts both ways: the port resumed from the JAX driver's 1800 s
  restart (skipping the init: it is not called) reaches the JAX driver's
  3600 s state within the same bounds; the JAX package's reader takes
  the port's 1800 s restart, every Noah-MP field equal to the port's
  restart file's.
This file runs the JAX driver, which compiles its own step, apart from
tests/test_torch_noahmp_model.py's jitted model, on another test worker.
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
from icar_tpu_torch import constants as C
from icar_tpu_torch.config import Options
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.driver import ICARDriver, main
from icar_tpu_torch.forcing.ideal import write_ideal_files
from icar_tpu_torch.io.netcdf import NCFile
from icar_tpu_torch.physics import noahmp as tnmp
from icar_tpu_torch.physics.noahmp import NSNOW
from test_torch_driver import _options, _record_substeps, commit_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the small file case, no jax)

OUTPUT = ["u", "v", "w", "potential_temperature", "water_vapor",
          "cloud_water", "precipitation", "skin_temperature",
          "sensible_heat", "latent_heat", "soil_temperature",
          "veg_leaf_temperature", "ground_surf_temperature"]
# accumulators the restart files do not hold (a resumed run counts from 0)
RUNOFF = ("runoff_surface", "runoff_subsurface")
ADVECTED = ("potential_temperature", "water_vapor", "cloud_water",
            "rain_mass", "snow_mass")
# the fields the Noah-MP init writes (icar_tpu/core/driver.py:228-247)
INIT_FIELDS = ("snow_albedo_prev", "snow_water_eq_prev", "soil_liquid_water",
               "soil_water_content", "canopy_temperature",
               "canopy_vapor_pressure", "canopy_fwet", "canopy_water_liquid",
               "canopy_water_ice", "veg_leaf_temperature",
               "ground_surf_temperature", "snow_layer_depth", "snow_height",
               "snow_layer_ice", "snow_layer_liquid_water",
               "water_table_depth", "water_aquifer", "storage_gw", "lai",
               "sai", "coeff_momentum_drag", "coeff_heat_exchange",
               "snow_age_factor", "swe", "snow_nlayers", "snow_temperature",
               "soil_temperature")


def _noahmp_options(cls, files, prefix):
    o = _options(cls, files, prefix)
    o.physics.landsurface = C.LSM_NOAHMP
    o.physics.boundarylayer = C.PBL_SIMPLE
    o.output.names = list(OUTPUT)
    return o


def _counted_init(monkeypatch):
    calls = []
    init = tnmp.noahmp_init_state

    def counted(*a, **k):
        calls.append(1)
        return init(*a, **k)
    monkeypatch.setattr(tnmp, "noahmp_init_state", counted)
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX driver run and one port run of the same files, with each
    driver's state right after set-up."""
    tmp = tmp_path_factory.mktemp("noahmp_driver")
    files = write_ideal_files(str(tmp), **chip_smoke.FILE_SMALL)
    before = {}
    init = JDriver._init_noahmp

    def recorded(self):
        before.update({k: np.asarray(v)
                       for k, v in self.model.state.items()})
        return init(self)
    JDriver._init_noahmp = recorded
    try:
        jd = JDriver(_noahmp_options(JOptions, files, str(tmp / "jax_")))
    finally:
        JDriver._init_noahmp = init
    jax_init = {k: np.asarray(v) for k, v in jd.model.state.items()}
    commit_state(jd.model)
    jax_substeps = _record_substeps(jd)
    jd.run()
    mp = pytest.MonkeyPatch()
    try:
        init_calls = _counted_init(mp)
        td = ICARDriver(_noahmp_options(Options, files, str(tmp / "port_")),
                        device="cpu")
    finally:
        mp.undo()
    port_init = {k: v.numpy().copy() for k, v in td.model.state.items()}
    td.run()
    return dict(tmp=tmp, files=files, jax=jd, jax_before=before,
                jax_init=jax_init, jax_substeps=jax_substeps, port=td,
                port_init=port_init, init_calls=len(init_calls))


def test_init_fields_equal(runs):
    """The port's driver runs the Noah-MP init once at set-up; from the
    JAX driver's state before its init, the port's ``_init_noahmp``
    writes the JAX init's arrays; its own set-up state agrees with the
    JAX driver's within an ulp of the skin temperature's."""
    assert runs["init_calls"] == 1
    td = runs["port"]
    saved = td.model.state
    td.model.state = state_from_numpy(runs["jax_before"], "cpu")
    try:
        td._init_noahmp()
        got = {k: v.numpy() for k, v in td.model.state.items()}
    finally:
        td.model.state = saved
    want = runs["jax_init"]
    assert sorted(got) == sorted(want)
    for k in INIT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["snow_layer_depth"][NSNOW:] < 0).all()
    for k in INIT_FIELDS:
        np.testing.assert_allclose(runs["port_init"][k], want[k],
                                   rtol=2e-7, err_msg=k)


def _hold(got, want, name):
    """|got - want| within FULLPHYS_BOUNDS of ``want``'s largest
    magnitude."""
    bound = chip_smoke.FULLPHYS_BOUNDS[
        "species" if name in ADVECTED else "other"]
    d = np.abs(np.asarray(got, np.float64) - want).max()
    assert d <= bound * max(float(np.abs(want).max()), 1e-30), (name, d)


def _read(path):
    with NCFile(path) as f:
        return {n: f.read(n) for n in f.variables()}


def test_output_matches_jax_driver(runs):
    """The same substeps an interval; every output field at t = 0, 1800
    and 3600 s within FULLPHYS_BOUNDS of the JAX driver's (observed at
    most 0.23 of its bound: sensible heat at 1800 s, 2.3e-4 of its
    largest value)."""
    assert runs["port"].substeps == runs["jax_substeps"]
    want = _read(runs["jax"].writer.path)
    got = _read(runs["port"].writer.path)
    assert sorted(got) == sorted(OUTPUT + ["model_time"])
    for name in OUTPUT:
        assert got[name].shape == want[name].shape and len(got[name]) == 3
        for i in range(3):
            _hold(got[name][i], want[name][i], f"{name} at output {i}")
    # Noah-MP ran: the surface fluxes and the canopy moved
    assert np.abs(got["sensible_heat"][2]).max() > 0
    assert (got["veg_leaf_temperature"][2]
            != got["veg_leaf_temperature"][0]).any()


def test_resumes_from_jax_restart(runs, monkeypatch):
    """The port resumed from the JAX driver's 1800 s checkpoint, without
    the Noah-MP init, reaches the JAX driver's 3600 s state within
    FULLPHYS_BOUNDS (observed at most 0.025 of its bound, the canopy
    vapour pressure); the runoff accumulators, which no restart holds,
    aside."""
    o = _noahmp_options(Options, runs["files"], str(runs["tmp"] / "res_"))
    o.run.restart = True
    o.run.restart_in_file = str(runs["tmp"] / "jax_rst_00001800.nc")
    calls = _counted_init(monkeypatch)
    d = ICARDriver(o, device="cpu")
    d.run()
    assert not calls
    assert d.substeps == runs["jax_substeps"][1:]
    jd = runs["jax"]
    saved = _read(o.run.restart_in_file)
    for name in sorted(d.model.state):
        if name in RUNOFF:
            assert name not in saved
            continue
        _hold(d.model.field(name), np.asarray(jd.model.field(name)), name)


def test_jax_reads_port_restart(runs):
    """The JAX package's reader takes the port's 1800 s checkpoint: every
    Noah-MP field it restores equals the port's restart file's."""
    jd = runs["jax"]
    m = type(jd.model)(copy.deepcopy(jd.options),
                       np.asarray(jd.model.geom.terrain, np.float64),
                       np.asarray(jd.model.geom.lat),
                       np.asarray(jd.model.geom.lon))
    path = runs["tmp"] / "port_rst_00001800.nc"
    t = jax_read_restart(str(path), m)
    assert t == 1800.0
    saved = _read(str(path))
    restart_fields = [k for k in INIT_FIELDS if k in saved]
    assert {"snow_nlayers", "snow_layer_depth", "water_table_depth",
            "snow_temperature"} <= set(restart_fields)
    for k in restart_fields:
        np.testing.assert_array_equal(np.asarray(m.state[k]),
                                      np.asarray(saved[k]).reshape(
                                          m.state[k].shape), err_msg=k)


def test_main_with_noahmp(runs, tmp_path):
    """``python -m icar_tpu_torch options.nml --device cpu`` with lsm=4
    runs, writing the port's driver's output."""
    init, forcing = runs["files"]
    prefix = str(tmp_path / "cli_")
    nml = chip_smoke.write_namelist(prefix + "options.nml", init, forcing,
                                    prefix, chip_smoke.FILE_SMALL_Z,
                                    dict(mp=2, adv=1, lsm=4, pbl=2))
    assert main([nml, "--device", "cpu"]) == 0
    got = _read(prefix + "out_run.nc")
    assert np.isfinite(got["potential_temperature"]).all()
    assert os.path.exists(prefix + "rst_00003600.nc")

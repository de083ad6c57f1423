"""The port's host-side setup against the JAX package's.

icar_tpu_torch carries numpy-only copies of constants, config, the
calendar/namelist/model-tracking utilities, registry, grid and the ideal
case (the machine that runs the port has no jax). These tests hold each
copy to its original, then check geometry, the ideal case, the options and
the initial model state against icar_tpu.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# copied module -> top-level definitions the copy leaves out (they need
# modules the port does not have yet)
COPIES = {
    "constants.py": (),
    "config.py": (),
    "utils/calendar.py": (),
    "utils/namelist.py": (),
    "utils/model_tracking.py": (),
    "registry.py": (),
    "grid.py": (),
    "forcing/ideal.py": (),
    "physics/thompson_tables.py": (),
    "physics/noah_params.py": (),
    "physics/rrtmg_lw_tables.py": (),
    "physics/rrtmg_sw_tables.py": (),
    "physics/ghg.py": (),
    "physics/bmj_tables.py": (),
}

# data files the port reads from its own copies: copy -> original
DATA_COPIES = ("physics/data/rrtmg_lw_data.npz",
               "physics/data/rrtmg_sw_data.npz")


def _body(path):
    """Top-level statements after the module docstring, as AST dumps
    keyed by definition name (or by position for other statements)."""
    tree = ast.parse(open(path).read())
    body = tree.body
    doc = ast.get_docstring(tree)
    if doc is not None:
        body = body[1:]
    return doc, [(getattr(n, "name", None), ast.dump(n)) for n in body]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_matches_original(rel):
    _, orig = _body(os.path.join(REPO, "icar_tpu", rel))
    doc_c, copy = _body(os.path.join(REPO, "icar_tpu_torch", rel))
    assert doc_c.startswith(f"Copy of icar_tpu/{rel}")
    omitted = COPIES[rel]
    want = [n for n in orig if n[0] not in omitted]
    assert copy == want, f"icar_tpu_torch/{rel} drifted from icar_tpu/{rel}"


@pytest.mark.parametrize("rel", DATA_COPIES)
def test_data_copy_is_byte_equal(rel):
    """The port's copy of a JAX-package data file (the RRTMG in-source
    tables) equals its original byte for byte."""
    with open(os.path.join(REPO, "icar_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "icar_tpu_torch", rel), "rb") as f:
        assert f.read() == want


# functions (and host classes) the port copies one by one out of
# JAX-package modules that import jax: JAX module -> (port module, names);
# the JAX package's ``jnp.`` becomes the port's ``np.`` (its spectrum and
# wavenumbers end in numpy arrays where the JAX package's end in jnp
# arrays)
FUNCTION_COPIES = {
    "ops/linear_winds.py": ("ops/linear_winds.py", (
        "add_buffer_topo", "fourier_terrain", "wavenumber_grids",
        "lut_size_bytes", "check_lut_budget", "table_values", "_lut_params",
        "_lut_sidecars", "open_lut_writer", "_load_lut_meta",
        "load_lut_chunks", "save_lut")),
    "ops/blocking.py": ("ops/blocking.py", (
        "terrain_blocking_heights", "_find_max_downward_level")),
    "forcing/interpolation.py": ("forcing/interpolation.py", (
        "_is_regular", "_idw_lut", "_tri_weights", "_curvilinear_quad_lut",
        "_quad_pass", "build_geo_lut", "build_vlut",
        "standardize_longitudes")),
    "forcing/boundary.py": ("forcing/boundary.py", (
        "compute_mixing_ratio_from_rh", "compute_mixing_ratio_from_sh",
        "ForcingData")),
    "utils/diagnostics_debug.py": ("utils/diagnostics_debug.py", (
        "Timer", "Timers")),
    "parallel/mesh.py": ("parallel/mesh.py", ("pad_field",)),
    "physics/noahmp_params.py": ("physics/noahmp_params.py", (
        "NSOIL", "NSNOW", "SOILCOLOR", "_MODIS", "_RAD", "_GLOBAL",
        "_VEG_KEYS", "load_mp_tables")),
    "physics/noahmp.py": ("physics/noahmp.py", (
        "ZSOIL", "DZSOIL", "noahmp_init_state")),
    "physics/mp_thompson.py": ("physics/mp_thompson.py", (
        "aer_surface_flux", "aer_init_profiles")),
    "physics/water_lake.py": ("physics/water_lake.py", (
        "NLEVLAKE", "NLEVSNOW", "NLEVSOIL", "NSOISNO", "NCOL", "VKC", "GRAV",
        "SB", "TFRZ", "DENH2O", "DENICE", "CPICE", "CPLIQ", "HFUS", "HVAP",
        "HSUB", "RAIR", "CPAIR", "TCRIT", "TKWAT", "TKICE", "TKAIRC",
        "BDSNO", "SPVAL", "DEPTH_C", "WIMP", "SSI", "CNFAC", "EMG", "ZII",
        "BETA1", "TDMAX", "BETA_LAKE", "ZA_LAKE", "SAND", "CLAY", "DZMIN",
        "lake_init")),
    # the microphysics schemes' host constants (a name of a tuple
    # assignment holds the whole statement)
    "physics/mp_wsm3.py": ("physics/mp_wsm3.py", tuple("""
        G CPD RD RV CPV T0C EP1 EP2 QMIN XLS XLV0 XLF0 CLIQ CICE PSAT DEN0
        DENR DENS DTCLDCR N0R AVTR BVTR R0 PEAUT XNCR XMYU AVTS BVTS N0SMAX
        LAMDARMAX LAMDASMAX DICON DIMAX N0S ALPHA QCRMIN PI XLV1 QC0 QCK1
        _G3PBR _G4PBR _G5PBRO2 PVTR PACRR PRECR1 PRECR2 ROQIMAX _G3PBS
        _G4PBS _G5PBSO2 PVTS PACRS PRECS1 PRECS2 PIDN0R PIDN0S RSLOPERMAX
        RSLOPESMAX""".split())),
    "physics/mp_wsm6.py": ("physics/mp_wsm6.py", tuple("""
        N0R N0G AVTR R0 PEAUT XNCR XMYU AVTS AVTG DENG N0SMAX LAMDARMAX
        DICON DIMAX N0S ALPHA PFRZ1 QCRMIN EACRC DENS QS0 PI XLV1 QC0 QCK1
        G3PBR G4PBR G5PBRO2 G6PBR PVTR PACRR PRECR1 PRECR2 ROQIMAX G3PBS
        G4PBS G5PBSO2 PVTS PACRS PRECS1 PRECS2 PACRC G3PBG G4PBG G5PBGO2
        PVTG PACRG PRECG1 PRECG2 PIDN0R PIDN0S PIDN0G RSLOPERMAX RSLOPESMAX
        RSLOPEGMAX""".split())),
    "physics/mp_morrison.py": ("physics/mp_morrison.py", tuple("""
        CP G R RV EP_2 PI AI BI RHOSU RHOW AIMM DCS MI0 MG0 F1S QSMALL EII
        RIN CPW CI_ CS_ DG MMULT LAMMAXI LAMMAXR LAMMAXS LAMMAXG NDCNST
        _Consts _CONSTS _SVP_LIQ _SVP_ICE""".split())),
}


def _functions(source):
    """Top-level function and class definitions of ``source`` (text) by
    name: (first docstring line, AST dump without the docstring); and its
    assignments to one name or a tuple of names (tables, constants), by
    each name: (None, AST dump)."""
    out = {}
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            doc = ast.get_docstring(node)
            if doc is not None:
                node.body = node.body[1:]
            out[node.name] = ((doc or "").split("\n")[0], ast.dump(node))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = (None, ast.dump(node))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Tuple):
            for t in node.targets[0].elts:
                out[t.id] = (None, ast.dump(node))
    return out


@pytest.mark.parametrize("orig,name", sorted(
    (o, n) for o, (_, names) in FUNCTION_COPIES.items() for n in names))
def test_function_copy_matches_original(orig, name):
    """Each copied function's (or class's, or named table's) AST equals
    its original's (its own docstring aside, the sources read as text, not
    imported); a function's docstring's first line names the source, a
    table's module docstring does."""
    rel, _ = FUNCTION_COPIES[orig]
    src = open(os.path.join(REPO, "icar_tpu", orig)).read()
    want = _functions(src.replace("jnp.", "np."))[name][1]
    copy_src = open(os.path.join(REPO, "icar_tpu_torch", rel)).read()
    doc, got = _functions(copy_src)[name]
    if doc is None:
        assert f"icar_tpu/{orig}" in ast.get_docstring(ast.parse(copy_src))
    else:
        assert doc.startswith(f"Copy of icar_tpu/{orig}"), doc
    assert got == want, f"icar_tpu_torch/{rel} {name} drifted from " \
                        f"icar_tpu/{orig}"


# functions (and tables) of the JAX package's tools (``tools/``) that the
# port's tools (``icar_tpu_torch/tools/``) copy, their imports of the JAX
# package made imports of the port: tool -> names. The rest of each tool
# (its readers and writers, fix_time, the mains that take no argv) is
# rewritten and held by tests/test_torch_tools.py.
TOOL_COPIES = {
    "extract_daily_precip.py": ("load_steps", "daily_totals", "main"),
    "make_domain.py": ("smooth2d", "make_domain", "main"),
    "wrf2icar.py": ("GRAVITY", "_destagger", "_parse_times", "convert",
                    "main"),
    "reanalysis2icar.py": ("GRAVITY", "P0", "ROVCP", "PRESETS", "convert",
                           "main"),
    "get_merra.py": ("URL", "VARS_3D", "VARS_2D", "merra_version",
                     "convert"),
}


@pytest.mark.parametrize("tool,name", sorted(
    (t, n) for t, names in TOOL_COPIES.items() for n in names))
def test_tool_copy_matches_original(tool, name):
    """Each copied tool function's (or table's) AST equals its original's
    with ``from icar_tpu.`` read as ``from icar_tpu_torch.`` (its own
    docstring aside); a function's docstring's first line names the
    source, a table's module docstring does."""
    src = open(os.path.join(REPO, "tools", tool)).read()
    want = _functions(src.replace("from icar_tpu.",
                                  "from icar_tpu_torch."))[name][1]
    copy_src = open(os.path.join(REPO, "icar_tpu_torch", "tools",
                                 tool)).read()
    doc, got = _functions(copy_src)[name]
    if doc is None:
        assert f"tools/{tool}" in ast.get_docstring(ast.parse(copy_src))
    else:
        assert doc.startswith(f"Copy of tools/{tool}"), doc
    assert got == want, f"icar_tpu_torch/tools/{tool} {name} drifted " \
                        f"from tools/{tool}"


def _options(pkg, **domain):
    o = pkg.Options()
    for k, v in domain.items():
        setattr(o.domain, k, v)
    return o


@pytest.mark.parametrize("case", [
    dict(nx=40, ny=12, nz=12, hill=900.0, flat_z_height=-5, sleve=False),
    dict(nx=33, ny=17, nz=8, hill=600.0, flat_z_height=3000.0,
         sleve=False),
    dict(nx=30, ny=14, nz=12, hill=300.0, flat_z_height=6000.0,
         sleve=True),
])
def test_geometry_matches(case):
    import icar_tpu.config as jc
    import icar_tpu.forcing.ideal as jideal
    import icar_tpu.grid as jgrid
    import icar_tpu_torch.config as tc
    import icar_tpu_torch.forcing.ideal as tideal
    import icar_tpu_torch.grid as tgrid

    nx, ny, nz = case["nx"], case["ny"], case["nz"]
    dz = [50.0, 75.0, 125.0, 200.0, 300.0, 400.0] + [500.0] * (nz - 6)
    geoms = []
    for cfg, ideal, grid in ((jc, jideal, jgrid), (tc, tideal, tgrid)):
        o = _options(cfg, nx=nx, ny=ny, nz=nz, dx=1000.0, dz_levels=dz,
                     flat_z_height=case["flat_z_height"],
                     sleve=case["sleve"])
        terrain = ideal.schaer_topography(nx, ny, case["hill"], 1000.0)
        lat, lon = ideal.ideal_latlon(nx, ny, 1000.0)
        geoms.append(grid.build_geometry(terrain, lat, lon, o))
    gj, gt = geoms
    for f in dataclasses.fields(gj):
        a, b = getattr(gj, f.name), getattr(gt, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_ideal_case_and_options_match():
    import icar_tpu.config as jc
    import icar_tpu.forcing.ideal as jideal
    import icar_tpu.grid as jgrid
    import icar_tpu_torch.config as tc
    import icar_tpu_torch.forcing.ideal as tideal

    assert dataclasses.asdict(jc.Options()) == dataclasses.asdict(
        tc.Options())
    o = _options(jc, nx=24, ny=10, nz=9, dx=1000.0,
                 dz_levels=[50.0, 75.0, 125.0, 200.0, 300.0, 400.0,
                            500.0, 500.0, 500.0])
    terrain = jideal.schaer_topography(24, 10, 700.0, 1000.0)
    lat, lon = jideal.ideal_latlon(24, 10, 1000.0)
    geom = jgrid.build_geometry(terrain, lat, lon, o)
    for kw in (dict(u_profile=12.0, rh=1.0), dict(u_profile=8.0),
               dict(u_profile=np.linspace(5, 15, 9), rh=0.8)):
        a = jideal.make_ideal_case(geom, **kw)
        b = tideal.make_ideal_case(geom, **kw)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


def test_initial_state_matches_jax():
    from icar_tpu.models.icar import ideal_ridge_model as jax_model
    from icar_tpu_torch.models.icar import ideal_ridge_model

    kw = dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=900.0,
              u_speed=12.0, rh=1.0)
    mj = jax_model(**kw)
    mt = ideal_ridge_model(**kw, device="cpu")
    assert sorted(mj.state) == sorted(mt.state)
    assert mj.advect_names == mt.advect_names
    # w comes out of a cumulative sum, which the two libraries may order
    # differently
    for k in ("u", "v", "w", "potential_temperature", "water_vapor",
              "pressure", "exner"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in mt.state.items():
        assert v.dtype == torch.float32, k


def test_port_imports_no_jax():
    """Importing every module of icar_tpu_torch loads neither jax nor the
    JAX package."""
    code = ("import importlib, pkgutil, sys, icar_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    icar_tpu_torch.__path__, 'icar_tpu_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "for m in ('mp_thompson', 'cu_kf', 'cu_nsas', 'cu_bmj',\n"
            "          'bmj_tables'):\n"
            "    assert 'icar_tpu_torch.physics.' + m in names, names\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'icar_tpu' "
            "or m.startswith('icar_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_noahmp_columns_return_float32():
    """noahmp_driver and glacier_sflx on float32 inputs return float32
    (int32 layer counts): no float64 table or constant promotes them."""
    from icar_tpu_torch.physics import noahmp, noahmp_glacier
    from icar_tpu_torch.physics.noah_params import load_tables
    from icar_tpu_torch.physics.noahmp_params import (load_mp_tables,
                                                      resolve_params)
    shape = (1, 2)
    f = lambda v: torch.full(shape, v, dtype=torch.float32)
    for veg, soil in ((10, 6), (15, 6)):
        st = noahmp.noahmp_init_state(
            np.full(shape, 270.0, np.float32),
            np.full(shape, 40.0, np.float32), np.zeros(shape, np.float32),
            np.full((4,) + shape, 271.0, np.float32),
            np.full((4,) + shape, 0.3, np.float32),
            np.full(shape, soil, np.int32), np.full(shape, veg, np.int32),
            load_mp_tables(), load_tables())
        st = {k: torch.as_tensor(v) for k, v in st.items()}
        vt = torch.full(shape, veg, dtype=torch.int32)
        p = resolve_params(load_mp_tables(), load_tables(), vt,
                           torch.full(shape, soil, dtype=torch.int32))
        dt = torch.tensor(600.0)
        out, new = noahmp.noahmp_driver(
            p, f(45.0), torch.tensor(365.0), torch.tensor(100.0), f(0.5),
            dt, f(0.5), vt, f(272.0), f(9e4), f(9.05e4), f(3.0), f(1.0),
            f(3e-3), f(400.0), f(300.0), f(1.0), f(280.0), f(30.0), st)
        gout, gnew = noahmp_glacier.glacier_sflx(
            p, f(0.5), dt, torch.as_tensor(noahmp.ZSOIL), f(272.0), f(9e4),
            f(3.0), f(1.0), f(3e-3), f(400.0), f(300.0), f(1e-3), f(260.0),
            torch.ones((3,) + shape), f(30.0), st)
        for k, v in list(out.items()) + list(new.items()) \
                + list(gout.items()) + list(gnew.items()):
            want = torch.int32 if k == "isnow" else torch.float32
            assert v.dtype == want, k

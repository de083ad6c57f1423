"""The port's column physics of the full-physics path against the JAX
package's functions, on seeded inputs: ``take_level``, the mass-conserving
winds (wind=2), ``ra_simple``, the four ``surface.py`` functions,
``pbl_simple`` (with more than one diffusion substep) and the partial
diagnostic refresh the general loop asks for.

The JAX functions run op by op (``jax.disable_jit()``), as the port does;
the port divides by a constant as a product with its float32 reciprocal
(as the JAX package's compiled step does) and by a number in numerator
position as torch does, so a result may differ by an ulp or two of the
field. Each tolerance is stated where it is used, with what was observed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.core import diagnostics as jdiag
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu.ops import indexing as jidx
from icar_tpu.ops import wind as jwind
from icar_tpu.physics import pbl_simple as jpbl
from icar_tpu.physics import ra_simple as jra
from icar_tpu.physics import surface as jsfc
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import geometry_to_torch, state_from_numpy
from icar_tpu_torch.core import diagnostics as tdiag
from icar_tpu_torch.models.icar import ideal_ridge_model
from icar_tpu_torch.ops import indexing as tidx
from icar_tpu_torch.ops import wind as twind
from icar_tpu_torch.physics import pbl_simple as tpbl
from icar_tpu_torch.physics import ra_simple as tra
from icar_tpu_torch.physics import surface as tsfc

torch.set_num_threads(1)

SHAPE = (10, 6, 9)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, rtol, atol_frac, what):
    """``got`` within rtol, and atol = atol_frac x the largest |want|."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_frac * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _atmosphere(seed, nz=10, ny=6, nx=9):
    """A seeded atmosphere: theta, exner, p, qv, qc, qi, qr, qs, density,
    mass-level winds, heights, interface thickness and terrain."""
    r = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    terrain = r.uniform(0, 500, (ny, nx)).astype(np.float32)
    dz = (np.array([50, 75, 125, 200, 300, 400] + [500] * (nz - 6),
                   np.float32)[:, None, None]
          * r.uniform(0.8, 1.0, (1, ny, nx))).astype(np.float32)
    z = (terrain[None] + np.cumsum(dz, 0) - dz / 2).astype(np.float32)
    p = (1e5 * np.exp(-z / 8000.0)).astype(np.float32)
    exner = ((p / 1e5) ** 0.2857).astype(np.float32)
    theta = (295 + 0.004 * z + r.uniform(-2, 2, shape)).astype(np.float32)
    t = theta * exner
    qsat = 0.622 * 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65)) / p
    qv = (qsat * r.uniform(0.3, 1.05, shape)).astype(np.float32)

    def cloud(hi, frac):
        return np.where(r.uniform(size=shape) < frac,
                        r.uniform(0, hi, shape), 0).astype(np.float32)
    return dict(theta=theta, exner=exner, p=p, qv=qv,
                qc=cloud(1e-3, 0.3), qi=cloud(3e-4, 0.2),
                qr=cloud(5e-4, 0.2), qs=cloud(5e-4, 0.2),
                rho=(p / (287.058 * t)).astype(np.float32),
                u=r.normal(8, 6, shape).astype(np.float32),
                v=r.normal(0, 4, shape).astype(np.float32),
                z=z, dz=dz, terrain=terrain)


# ---------------------------------------------------------------------------
# take_level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [None, 3])
def test_take_level_matches(levels):
    """Every selected element, with indices outside [0, n) clipped."""
    r = np.random.default_rng(1)
    arr = r.normal(size=SHAPE).astype(np.float32)
    shape = SHAPE[1:] if levels is None else (levels,) + SHAPE[1:]
    idx = r.integers(-3, SHAPE[0] + 3, shape).astype(np.int32)
    want = np.asarray(jidx.take_level(_j(arr), _j(idx)))
    got = tidx.take_level(_t(arr), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    # an index broadcast against the array's trailing axes
    want = np.asarray(jidx.take_level(_j(arr), _j(idx[..., :1])))
    got = tidx.take_level(_t(arr), _t(idx[..., :1])).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# wind=2
# ---------------------------------------------------------------------------

def test_mass_conserving_winds_match():
    """update_winds with wind=2 on a ridge's compressed levels: u, v and w
    within 1e-6 of their largest values (the same divisions and cumulative
    sum; observed equal)."""
    m = jax_model(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0,
                  u_speed=9.0, windtype=JC.WIND_CONSERVE_MASS)
    assert float(np.asarray(m.geom.zr_u).min()) < 0.95
    r = np.random.default_rng(2)
    u = r.normal(9, 2, np.asarray(m.state["u"]).shape).astype(np.float32)
    v = r.normal(0, 2, np.asarray(m.state["v"]).shape).astype(np.float32)
    want = jwind.update_winds(_j(u), _j(v), m.geom,
                              JC.WIND_CONSERVE_MASS, 0)
    got = twind.update_winds(_t(u), _t(v), geometry_to_torch(m.geom, "cpu"),
                             C.WIND_CONSERVE_MASS)
    for g, w, name in zip(got, want, "uvw"):
        _close(g, w, 1e-6, 1e-6, name)
    # the models' initial winds
    mt = ideal_ridge_model(nx=30, ny=12, nz=10, dx=1000.0,
                           hill_height=600.0, u_speed=9.0,
                           windtype=C.WIND_CONSERVE_MASS, device="cpu")
    for k in ("u", "v", "w"):
        _close(mt.state[k], m.state[k], 1e-6, 1e-6, k)
    assert float(np.abs(np.asarray(m.state["w"])).max()) > 0.1


@pytest.mark.parametrize("windtype,match", [(4, "wind=4"), (6, "wind=6")])
def test_other_wind_solvers_raise(windtype, match):
    """Every wind solver is ported (tests/test_torch_wind_solvers.py,
    tests/test_torch_linear_model.py); a number that names none raises."""
    g = ideal_ridge_model(nx=20, ny=8, nz=10, hill_height=600.0,
                          device="cpu").geom_t
    u = torch.zeros(10, 8, 21)
    v = torch.zeros(10, 9, 20)
    with pytest.raises(ValueError, match=match):
        twind.update_winds(u, v, g, windtype)


# ---------------------------------------------------------------------------
# ra_simple
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,doy", [(3, 172.5), (4, 355.9), (5, 80.25)])
def test_ra_simple_matches(seed, doy):
    """theta within 1e-6 relative (observed 0: the cooling is ~1e-4 K),
    shortwave, longwave and cloud fraction within rtol 1e-5 (observed up
    to 1.4e-6: exp and pow differ between the libraries by an ulp), at
    day and at night (the solar elevation clamps to 0)."""
    a = _atmosphere(seed)
    ny, nx = SHAPE[1:]
    lat = np.linspace(30, 50, ny * nx).reshape(ny, nx).astype(np.float32)
    lon = np.linspace(-120, 240, ny * nx).reshape(ny, nx).astype(np.float32)
    sin_lat = np.sin(lat * (np.pi / 180.0))
    cos_lat = np.cos(lat * (np.pi / 180.0))
    dt = np.float32(37.5)
    args = [a[k] for k in ("theta", "exner", "qv", "qc", "qs", "qr", "p")]
    with jax.disable_jit():
        want = jra.ra_simple(*[_j(x) for x in args], lon, sin_lat, cos_lat,
                             jnp.float32(doy), jnp.float32(365.0), dt)
    got = tra.ra_simple(*[_t(x) for x in args], _t(lon), _t(sin_lat),
                        _t(cos_lat), torch.tensor(doy, dtype=torch.float32),
                        torch.tensor(365.0), torch.tensor(dt))
    _close(got[0], want[0], 1e-6, 0, "theta")
    for g, w, name in zip(got[1:], want[1:], ("sw", "lw", "cc")):
        _close(g, w, 1e-5, 1e-6, name)
    sw = got[1].numpy()
    assert (sw == 0).any() and sw.max() > 100


# ---------------------------------------------------------------------------
# surface.py
# ---------------------------------------------------------------------------

def _surface_inputs(seed, ny=6, nx=9):
    r = np.random.default_rng(seed)

    def f(lo, hi):
        return r.uniform(lo, hi, (ny, nx)).astype(np.float32)
    wind = f(0, 15)
    wind[0, :3] = 0.0                       # calm cells
    return dict(wind=wind, tskin=f(270, 310), airt=f(275, 305),
                z_atm=f(20, 60), sst=f(275, 303), psfc=f(9e4, 1.02e5),
                ustar=f(0.0, 0.8), qv1=f(2e-3, 2e-2),
                water=r.uniform(size=(ny, nx)) < 0.5, sh=f(-50, 300),
                lh=f(0, 500), z0=f(0.01, 1.0))


@pytest.mark.parametrize("seed", [6, 7])
def test_exchange_coefficient_and_water_simple_match(seed):
    """The exchange coefficient (stable, unstable and calm cells, clipped
    at both ends) and the open-water fluxes within rtol 1e-5 (observed up
    to 3e-7)."""
    d = _surface_inputs(seed)
    lnz = np.log((d["z_atm"] + d["z0"]) / d["z0"]).astype(np.float32)
    base = (75 * 0.41 ** 2 * np.sqrt((d["z_atm"] + d["z0"]) / d["z0"])
            / lnz ** 2).astype(np.float32)
    lnz_term = ((0.41 / lnz) ** 2).astype(np.float32)
    args = (d["wind"], d["tskin"], d["airt"], d["z_atm"], lnz_term, base)
    with jax.disable_jit():
        want = jsfc.exchange_coefficient(*[_j(x) for x in args])
    got = tsfc.exchange_coefficient(*[_t(x) for x in args])
    _close(got, want, 1e-5, 1e-6, "exchange coefficient")
    w = np.asarray(want)
    assert (w == tsfc.MIN_EXCHANGE_C).any() or (w == tsfc.MAX_EXCHANGE_C
                                                 ).any()
    args = (d["sst"], d["psfc"], d["wind"], d["ustar"], d["qv1"],
            d["airt"], d["z_atm"], d["water"], d["sh"], d["lh"], d["z0"],
            d["tskin"])
    with jax.disable_jit():
        want = jsfc.water_simple(*[_j(x) for x in args])
    got = tsfc.water_simple(*[_t(x) for x in args])
    for g, w, name in zip(got, want, ("sh", "lh", "z0", "tskin", "qv")):
        _close(g, w, 1e-5, 1e-6, name)


@pytest.mark.parametrize("seed", [8, 9])
def test_apply_fluxes_and_surface_diagnostics_match(seed):
    """The fluxes spread over the lowest 400 m (theta and qv within rtol
    1e-6, observed 0 and 1.8e-7) and the 2 m diagnostics (rtol 1e-6,
    with cells under the 1e-3 exchange floor)."""
    a = _atmosphere(seed)
    d = _surface_inputs(seed)
    dt = np.float32(20.0)
    args = (a["theta"], a["qv"], a["rho"], a["dz"], a["exner"], d["sh"],
            d["lh"])
    with jax.disable_jit():
        want = jsfc.apply_fluxes(*[_j(x) for x in args], dt,
                                 sh_feedback_fraction=0.8)
    got = tsfc.apply_fluxes(*[_t(x) for x in args], torch.tensor(dt),
                            sh_feedback_fraction=0.8)
    _close(got[0], want[0], 1e-6, 0, "theta")
    _close(got[1], want[1], 1e-6, 1e-7, "qv")
    ex2 = d["wind"] * 0.002
    qfx = d["lh"] / 2.26e6
    args = (d["sh"], qfx, d["tskin"], d["qv1"], ex2, ex2 * 1.3, d["psfc"])
    assert (ex2 < 1e-3).any() and (ex2 >= 1e-3).any()
    with jax.disable_jit():
        want = jsfc.surface_diagnostics(*[_j(x) for x in args])
    got = tsfc.surface_diagnostics(*[_t(x) for x in args])
    for g, w, name in zip(got, want, ("t2", "q2")):
        _close(g, w, 1e-6, 1e-7, name)


# ---------------------------------------------------------------------------
# pbl_simple
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,dt,water,nsub", [(10, 60.0, True, 2),
                                                (11, 300.0, False, 10),
                                                (12, 20.0, True, 1)])
def test_pbl_simple_matches(seed, dt, water, nsub):
    """The diffusivity, the substep count as the JAX package counts it
    (``nsub``: 2, 10 and 1 diffusion substeps here), and the
    six diffused fields within rtol 1e-5 (observed up to 8e-7; Kq 9e-7)
    after them."""
    a = _atmosphere(seed)
    mask = (np.random.default_rng(seed).uniform(size=SHAPE[1:]) < 0.4
            if water else None)
    species = [a[k] for k in ("theta", "qv", "qc", "qi", "qr", "qs")]
    kq_args = species + [a["u"], a["v"], a["exner"], a["z"], a["terrain"],
                         a["dz"]]
    pbl_args = species + [a["u"], a["v"], a["exner"], a["rho"], a["z"],
                          a["dz"], a["terrain"]]
    jmask = None if mask is None else _j(mask)
    tmask = None if mask is None else _t(mask)
    with jax.disable_jit():
        kq_j = jpbl.eddy_diffusivity(*[_j(x) for x in kq_args], dt, jmask)
        want = jpbl.pbl_simple(*[_j(x) for x in pbl_args], dt, jmask)
    dt_t = torch.tensor(dt)
    kq_t = tpbl.eddy_diffusivity(*[_t(x) for x in kq_args], dt_t, tmask)
    _close(kq_t, kq_j, 1e-5, 0, "Kq")
    n_j = max(int(np.ceil(2 * np.max(np.asarray(kq_j) / a["dz"][:-1]))), 1)
    n_t = tpbl.substep_count(kq_t, _t(a["dz"]))
    assert n_t == n_j == nsub
    got = tpbl.pbl_simple(*[_t(x) for x in pbl_args], dt_t, tmask)
    for g, w, name in zip(got, want, ("th", "qv", "qc", "qi", "qr", "qs")):
        _close(g, w, 1e-5, 1e-7, name)


# ---------------------------------------------------------------------------
# the general loop's partial diagnostics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fullphys_state():
    """The JAX full-physics ridge's initial state with theta and the
    winds moved since its derived fields were computed."""
    m = jax_model(nx=24, ny=10, nz=10, dx=1000.0, hill_height=600.0,
                  u_speed=9.0, rh=1.0, mp=JC.MP_THOMPSON,
                  windtype=JC.WIND_CONSERVE_MASS, rad=JC.RA_SIMPLE,
                  pbl=JC.PBL_SIMPLE, lsm=JC.LSM_NOAH,
                  water=JC.WATER_SIMPLE, conv=JC.CU_TIEDTKE)
    s = {k: np.asarray(v) for k, v in m.state.items()}
    r = np.random.default_rng(13)
    for k in ("potential_temperature", "pressure", "u", "v", "w"):
        s[k] = (s[k] * (1 + r.uniform(-1e-3, 1e-3, s[k].shape))
                ).astype(np.float32)
    return m.geom, s


@pytest.mark.parametrize("needs", [
    ("density", "temperature"),
    ("density", "temperature", "exner", "pressure_interface",
     "surface_pressure", "uv_mass")])
def test_partial_refresh_matches(fullphys_state, needs):
    """Each refreshed field within rtol 1e-6 of the JAX refresh, every
    other field untouched."""
    geom, s = fullphys_state
    want = jdiag.diagnostic_update({k: _j(v) for k, v in s.items()}, geom,
                                   full=False, needs=frozenset(needs))
    got = tdiag.diagnostic_update(state_from_numpy(s, "cpu"),
                                  geometry_to_torch(geom, "cpu"),
                                  needs=frozenset(needs))
    assert sorted(got) == sorted(s)
    for k in s:
        if np.array_equal(np.asarray(want[k]), s[k]):
            np.testing.assert_array_equal(got[k].numpy(), s[k], err_msg=k)
        else:
            _close(got[k], want[k], 1e-6, 1e-7, k)


def test_partial_update_with_w_real_matches(fullphys_state):
    """The loop's prologue (every partial field and w_real) within rtol
    1e-6; the output-only diagnostics untouched."""
    geom, s = fullphys_state
    want = jdiag.diagnostic_update({k: _j(v) for k, v in s.items()}, geom,
                                   full=False, with_w_real=True)
    got = tdiag.diagnostic_update(state_from_numpy(s, "cpu"),
                                  geometry_to_torch(geom, "cpu"),
                                  full=False, with_w_real=True)
    assert not np.array_equal(np.asarray(want["w_real"]), s["w_real"])
    for k in want:
        _close(got[k], want[k], 1e-6, 1e-6, k)
    np.testing.assert_array_equal(got["u_10m"].numpy(), s["u_10m"])

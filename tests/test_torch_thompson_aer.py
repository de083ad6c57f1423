"""The aerosol-aware Thompson-Eidhammer scheme (mp=5) of the port against
the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX module
(icar_tpu/physics/mp_thompson.py ``mp_thompson_aer`` and its helpers) and
the port's (icar_tpu_torch/physics/mp_thompson.py). The oracle is the JAX
jnp path run operation by operation (``jax.disable_jit()``), which the port
transcribes: one eager JAX call per state, shared by the tests through
module-scoped fixtures, with its prep block (the helpers' arguments). The
states, 12x5x9 each: warm rain with snow and graupel; mixed phase below
240 K, supersaturated over ice by up to 60% (DeMott nucleation and Koop
freezing act); evaporating cloud in subsaturated air (the droplets lost
through the ``tnc_wev`` table); drizzle in the lowest 500 m over
levels of 50-300 m, w between -0.5 and 0.5 m/s. Each test's teeth show
that its branch acts: the port's result moves when the branch is cut.

Also the effective radii (``calc_effect_rad``, with and without the
droplet number), the default aerosol profiles and the surface flux
(copies of numpy functions, held by tests/test_torch_setup.py), and the
port's own versions of tests/test_thompson_aer.py's behavioural checks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icar_tpu.physics import mp_thompson as mj
from icar_tpu.physics.thompson_tables import ThompsonParams as JParams
from icar_tpu.physics.thompson_tables import get_tables as jget_tables
from icar_tpu_torch.physics import mp_thompson as mt
from icar_tpu_torch.physics import thompson_tables as tt
from icar_tpu_torch.physics.thompson_cases import column

torch.set_num_threads(1)

FIELDS = ("th", "qv", "qc", "qi", "qr", "qs", "qg", "ni", "nr", "nc",
          "nwfa", "nifa")
OUTPUTS = FIELDS + ("rain", "snow", "graupel")
DT = 30.0
# state -> (T range at the surface, lapse rate, qv over saturation range,
# which hydrometeors)
KINDS = {
    "warm rain": ((283.0, 300.0), 0.0065, "water", (0.95, 1.05)),
    "mixed phase": ((215.0, 240.0), 0.0, "ice", (1.0, 1.6)),
    "evaporating cloud": ((275.0, 295.0), 0.0065, "water", (0.9, 0.999)),
    "drizzle": ((280.0, 292.0), 0.0065, "water", (0.95, 1.05)),
}
# the largest share of a field's cells beyond 1e-4 relative (atol 1e-6 of
# its largest magnitude) against the op-by-op JAX call, and the largest
# relative difference anywhere. Observed: no cell beyond 1e-4, largest
# 2.2e-5 (droplet number, evaporating cloud: a power rounds otherwise)
SHARE_1E4 = 0.0
WORST = 1e-4


def _f32(a):
    return np.asarray(a, np.float32)


def aer_state(kind, seed=1, nz=12, ny=5, nx=9):
    """A seeded state of ``kind`` (KINDS) with droplet, aerosol and ice
    nuclei numbers (kg^-1) and w, in the scheme's field order."""
    (lo, hi), lapse, phase, (s0, s1) = KINDS[kind]
    r = np.random.default_rng(seed)
    dz, z, p, exner = column(nz, ny, nx)
    if kind == "drizzle":
        levels = np.array([50., 75., 125., 200., 300., 400.]
                          + [500.] * (nz - 6), np.float32)
        dz = _f32(np.broadcast_to(levels[:, None, None], (nz, ny, nx)))
        z = np.cumsum(dz, 0) - dz / 2
        p = _f32(1e5 * np.exp(-z / 8000.0))
        exner = _f32((p / 1e5) ** (287.04 / 1004.0))
    t = _f32(r.uniform(lo, hi, (ny, nx))[None] - lapse * z
             + r.uniform(-2, 2, (nz, ny, nx)))
    sat = (mt.rsif if phase == "ice" else mt.rslf)(torch.tensor(p),
                                                   torch.tensor(t)).numpy()
    qv = sat * r.uniform(s0, s1, t.shape)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def hydro(scale, share=0.6):
        q = r.uniform(0, scale, t.shape)
        return np.where(r.uniform(size=t.shape) < share, q, 0.0)
    zero = np.zeros_like(t)
    cold = phase == "ice"
    return dict(
        th=_f32(t / exner), qv=_f32(qv),
        qc=_f32(hydro(2e-5, 0.3) if cold else hydro(1.5e-3, 0.8)),
        qi=_f32(hydro(3e-4) if cold else zero),
        qr=_f32(hydro(1e-5, 0.2) if cold else hydro(1e-3)),
        qs=_f32(hydro(8e-4) if kind in ("warm rain", "mixed phase")
                else zero),
        qg=_f32(hydro(5e-4) if kind == "warm rain" else zero),
        ni=_f32(hydro(1e5) if cold else zero), nr=_f32(hydro(5e4)),
        nc=_f32(r.uniform(10e6, 800e6, t.shape) / rho),
        nwfa=_f32(r.uniform(20e6, 2000e6, t.shape) / rho),
        nifa=_f32(r.uniform(0.1e6, 10e6, t.shape) / rho),
        w=_f32(r.uniform(-0.5, 0.5, t.shape)), exner=exner, p=p, dz=dz)


def run_port(s, dt=DT, **swap):
    """The port's mp_thompson_aer on state ``s`` (``swap`` replaces
    inputs); its outputs as numpy arrays in the order of OUTPUTS."""
    T = {k: torch.tensor(v) for k, v in dict(s, **swap).items()}
    acc = torch.zeros(T["p"].shape[1:])
    out = mt.mp_thompson_aer(*(T[k] for k in FIELDS), T["exner"], T["p"],
                             T["dz"], np.float32(dt), acc, acc, acc,
                             w=T["w"])
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def jax_calls():
    """{kind: (state, the op-by-op JAX call's outputs, its prep dict as
    numpy arrays)}: one eager JAX call per state."""
    _, cj = jget_tables(JParams())
    out = {}
    for kind in KINDS:
        s = aer_state(kind)
        J = {k: jnp.asarray(v) for k, v in s.items()}
        acc = jnp.zeros(s["p"].shape[1:], jnp.float32)
        with jax.disable_jit():
            want = mj.mp_thompson_aer(*(J[k] for k in FIELDS), J["exner"],
                                      J["p"], J["dz"], np.float32(DT), acc,
                                      acc, acc, w=J["w"])
            P = mj._prep_block(*(J[k] for k in FIELDS[:9]), J["exner"],
                               J["p"], cj, JParams(), nc1d=J["nc"],
                               nwfa1d=J["nwfa"], nifa1d=J["nifa"],
                               w1d=J["w"])
        out[kind] = (s, [np.asarray(o) for o in want],
                     {k: np.asarray(v) for k, v in P.items()})
    return out


def worst_and_share(got, want):
    """(largest relative difference, share of cells beyond 1e-4 relative)
    with an atol of 1e-6 of the field's largest magnitude."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(g - w) / (np.abs(w) + 1e-30 + 1e-6 * np.abs(w).max())
    return float(rel.max()), float(np.mean(rel > 1e-4))


# ---------------------------------------------------------------------------
# the helpers, on the states' prep fields

def test_nu_c_rounds_as_the_jax_package():
    """nu_c = MIN(15, NINT(1e9/nc)+2), clipped below at 2, on numbers
    from 2 to 1e10 m^-3 and on the ties 1e9/nc = k + 0.5 (NINT rounds half
    to even, as jnp.rint): equal to the JAX function's everywhere, and
    _g_ratios' integer products too (g1 of 1..15 is calc_effect_rad's
    table _G_RATIO)."""
    ties = 1e9 / (np.arange(0, 16) + 0.5)
    nc = _f32(np.concatenate([np.geomspace(2.0, 1e10, 4001), ties,
                              np.nextafter(_f32(ties), np.float32(0)),
                              np.nextafter(_f32(ties), np.float32(1e12))]))
    with jax.disable_jit():
        want = np.asarray(mj._nu_c_jnp(jnp.asarray(nc)))
        g1w, g2w = (np.asarray(g) for g in mj._g_ratios(jnp.asarray(want)))
    got = mt._nu_c(torch.tensor(nc))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == set(range(2, 16))
    g1, g2 = mt._g_ratios(got)
    np.testing.assert_array_equal(g1.numpy(), g1w)
    np.testing.assert_array_equal(g2.numpy(), g2w)
    # calc_effect_rad's g_ratio table is g1 of its shape parameter
    g_ratio, _ = mt._g_ratios(torch.arange(1, 16, dtype=torch.int32))
    np.testing.assert_array_equal(g_ratio.numpy(), np.asarray(mj._G_RATIO))


@pytest.mark.parametrize("Da", [0.04e-6, 0.8e-6])
def test_eff_aero_matches(jax_calls, Da):
    """Eff_aero of the rain's mean diameter against both aerosols, on the
    warm state's prep fields: within 2e-6 relative (observed 4e-7), and
    within the clip's range."""
    _, _, P = jax_calls["warm rain"]
    D = np.where(P["mvd_r"] > 0, P["mvd_r"], 1e-4).astype(np.float32)
    args = [P["visco"], P["rho"], P["temp"]]
    with jax.disable_jit():
        vt = mj.tt.vr_poly_jnp(jnp.asarray(D))
        want = np.asarray(mj._eff_aero(jnp.asarray(D), Da,
                                       *(jnp.asarray(a) for a in args), vt))
    T = [torch.tensor(a) for a in args]
    got = mt._eff_aero(torch.tensor(D), Da, *T, mt._vr_poly(torch.tensor(D)))
    np.testing.assert_allclose(mt._vr_poly(torch.tensor(D)).numpy(),
                               np.asarray(vt), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
    assert 1e-5 <= want.min() and want.max() <= 1.0
    assert np.ptp(want) > 0


def test_ice_demott_and_koop_match(jax_calls):
    """DeMott's dust nuclei and Koop's homogeneous freezing on the mixed
    phase state's prep fields: DeMott within 5e-6 relative (observed
    1.3e-6); Koop within 5e-6 relative or 1e-4 of its largest value, 1000
    per litre (observed 69 per m^3 in four cells: where the probability
    1 - exp(-J V dt) is ~5e-7, one ulp of an exp near 1 is 12% of it);
    both act somewhere there (Koop needs T < 238 K and 40% over ice)."""
    _, _, P = jax_calls["mixed phase"]
    with jax.disable_jit():
        dm = np.asarray(mj._ice_demott(jnp.asarray(P["tempc"]),
                                       jnp.asarray(P["rho"]),
                                       jnp.asarray(P["nifa"])))
        kp = np.asarray(mj._ice_koop(*(jnp.asarray(P[k]) for k in
                                       ("temp", "qv", "qvs", "nwfa")),
                                     jnp.float32(DT)))
    T = {k: torch.tensor(P[k]) for k in ("tempc", "rho", "nifa", "temp",
                                         "qv", "qvs", "nwfa")}
    got_dm = mt._ice_demott(T["tempc"], T["rho"], T["nifa"]).numpy()
    got_kp = mt._ice_koop(T["temp"], T["qv"], T["qvs"], T["nwfa"],
                          DT).numpy()
    cold = P["tempc"] < 0
    np.testing.assert_allclose(got_dm[cold], dm[cold], rtol=5e-6, atol=0)
    np.testing.assert_allclose(got_kp, kp, rtol=5e-6, atol=1e-4 * kp.max())
    assert dm[cold].max() > 0
    koop_on = (P["temp"] < 238.0) & (P["ssati"] >= 0.4)
    assert koop_on.any() and kp[koop_on].max() > 0


@pytest.mark.parametrize("with_nc", [False, True])
def test_calc_effect_rad_matches(jax_calls, with_nc):
    """The effective radii on every state, with the constant Nt_c and with
    the droplet number: within 2e-6 relative (observed 4.8e-7), each
    radius inside its clip, and off its default somewhere."""
    for kind, (s, _, _) in jax_calls.items():
        t = _f32(s["th"] * s["exner"])
        args = [t, s["p"], s["qv"], s["qc"], s["qi"], s["ni"], s["qs"]]
        with jax.disable_jit():
            want = mj.calc_effect_rad(
                *(jnp.asarray(a) for a in args),
                nc=jnp.asarray(s["nc"]) if with_nc else None)
        got = mt.calc_effect_rad(
            *(torch.tensor(a) for a in args),
            nc=torch.tensor(s["nc"]) if with_nc else None)
        for name, g, w in zip(("re_cloud", "re_ice", "re_snow"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=0, err_msg=f"{kind} {name}")
        assert got[0].max() > 2.5e-6, kind


# ---------------------------------------------------------------------------
# the whole call

@pytest.mark.parametrize("kind", list(KINDS))
def test_mp_thompson_aer_matches_the_jnp_path(jax_calls, kind):
    """The whole call against the op-by-op JAX call: every field and
    accumulator finite, no cell beyond 1e-4 relative and none beyond WORST
    (observed at most 2.2e-5)."""
    s, want, _ = jax_calls[kind]
    got = run_port(s)
    for name, g, w in zip(OUTPUTS, got, want):
        assert np.isfinite(g).all(), f"{kind}: non-finite {name}"
        worst, share = worst_and_share(g, w)
        assert share <= SHARE_1E4 and worst <= WORST, (kind, name, worst)


def _moved(a, b):
    return any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_each_branch_acts_on_its_state(jax_calls, monkeypatch):
    """The states reach the branches they are for: the port's result
    moves when a branch is cut -- Koop's and DeMott's nucleation on the
    mixed phase state (ice number), the tnc_wev lookup on the evaporating
    cloud (droplet number), the drizzle where w < 0.1 (cloud water, droplet
    number: w raised to 1 m/s everywhere stops it), the scavenging by
    precipitation on the warm state (the aerosols; less ice nuclei
    left)."""
    cold = run_port(jax_calls["mixed phase"][0])
    for name in ("_ice_koop", "_ice_demott"):
        with monkeypatch.context() as m:
            m.setattr(mt, name, lambda *a, **k: torch.zeros_like(a[0]))
            cut = run_port(jax_calls["mixed phase"][0])
        assert not np.array_equal(cut[7], cold[7]), name

    evap = run_port(jax_calls["evaporating cloud"][0])
    table = mt.device_tnc_wev("cpu")
    with monkeypatch.context() as m:
        m.setattr(mt, "device_tnc_wev", lambda d: torch.zeros_like(table))
        cut = run_port(jax_calls["evaporating cloud"][0])
    assert not np.array_equal(cut[9], evap[9])

    s = jax_calls["drizzle"][0]
    drizzle = run_port(s)
    calm = run_port(s, w=np.ones_like(s["w"]))
    assert not np.array_equal(drizzle[2], calm[2])
    assert not np.array_equal(drizzle[9], calm[9])

    warm = run_port(jax_calls["warm rain"][0])
    with monkeypatch.context() as m:
        m.setattr(mt, "_eff_aero", lambda D, *a: torch.zeros_like(D))
        cut = run_port(jax_calls["warm rain"][0])
    assert _moved(warm[10:12], cut[10:12]) and warm[11].mean() < cut[11].mean()


def test_the_wrappers_and_the_step_agree():
    """mp_thompson_aer is thompson_step with the droplet and aerosol
    numbers, accumulating as mp_thompson does: the accumulators add this
    call's surface precipitation (rain = rain + ice + snow + graupel)."""
    s = aer_state("warm rain", seed=2, nz=8, ny=3, nx=4)
    T = {k: torch.tensor(v) for k, v in s.items()}
    outs = mt.thompson_step(*(T[k] for k in FIELDS[:9]), T["exner"], T["p"],
                            T["dz"], DT, nc1d=T["nc"], nwfa1d=T["nwfa"],
                            nifa1d=T["nifa"], w1d=T["w"])
    acc = torch.ones(3, 4)
    got = mt.mp_thompson_aer(*(T[k] for k in FIELDS), T["exner"], T["p"],
                             T["dz"], DT, acc, acc + 1, acc + 2, w=T["w"])
    for g, w in zip(got[:12], outs[:12]):
        assert torch.equal(g, w)
    pr, pi, ps, pg = outs[12:]
    assert torch.equal(got[12], acc + pr + ps + pg + pi)
    assert torch.equal(got[13], acc + 1 + ps + pi)
    assert torch.equal(got[14], acc + 2 + pg)


# ---------------------------------------------------------------------------
# the default profiles and the surface flux

def test_default_profiles_and_flux_match_the_jax_package():
    """aer_init_profiles and aer_surface_flux give the JAX package's
    values bit for bit on a terrain from 0 to 3000 m (the three h_01
    branches), the flux at 1, 4 and 20 km grid spacing; the reference's
    m^-3 in kg^-1 fields (ROADMAP section 3) kept: the surface value over
    low terrain is NA_CCN0 + NA_CCN1 whatever the density."""
    terrain = _f32(np.linspace(0, 3000, 12).reshape(3, 4))
    z = _f32(np.linspace(0, 9000, 10)[:, None, None] + 0 * terrain)
    for a, b in zip(mt.aer_init_profiles(z, terrain),
                    mj.aer_init_profiles(z, terrain)):
        np.testing.assert_array_equal(a, b)
    nwfa, _ = mt.aer_init_profiles(z, terrain)
    for dx in (1000.0, 4000.0, 20000.0):
        np.testing.assert_array_equal(mt.aer_surface_flux(nwfa[0], dx),
                                      mj.aer_surface_flux(nwfa[0], dx))
    np.testing.assert_allclose(nwfa[0, 0, 0], tt.NA_CCN0 + tt.NA_CCN1,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_thompson_aer.py's behavioural checks, on the port

def _column_case(nz=20, ny=3, nx=4, t_sfc=288.0, rh=1.05):
    """tests/test_thompson_aer.py's ``_case``: a lapse-rate column with
    cloud, rain and snow, and its density."""
    z = np.cumsum(np.full(nz, 300.0)) - 150.0
    p = (101325.0 * np.exp(-z / 8000.0))[:, None, None] \
        * np.ones((nz, ny, nx))
    t = (t_sfc - 0.0065 * z)[:, None, None] * np.ones((nz, ny, nx))
    exner = (p / 100000.0) ** 0.2857
    es = 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86))
    qvs = 0.622 * es / (p - es)
    rho = 0.622 * p / (287.04 * t * (qvs * rh + 0.622))
    full = lambda v: _f32(np.full_like(p, v))
    s = dict(th=_f32(t / exner), qv=_f32(qvs * rh), qc=full(2e-4),
             qi=full(0.0), qr=full(1e-4), qs=full(1e-4), qg=full(0.0),
             ni=full(0.0), nr=full(1e3), nc=_f32(50e6 / rho),
             nwfa=_f32(500e6 / rho), nifa=_f32(1.5e6 / rho),
             w=full(0.0), exner=_f32(exner), p=_f32(p), dz=full(300.0))
    return s


def test_nc_responds_to_nwfa():
    """More CCN, more activated droplets (five times the aerosol, more
    than twice the droplets); every output finite."""
    s = _column_case()
    lo = run_port(s)
    hi = run_port(s, nwfa=s["nwfa"] * 5.0)
    assert hi[9].mean() > 2.0 * lo[9].mean(), (lo[9].mean(), hi[9].mean())
    for o in lo + hi:
        assert np.isfinite(o).all()


def test_activation_depletes_nwfa():
    """Supersaturated everywhere: activation and scavenging take aerosol
    out of nwfa."""
    s = _column_case()
    assert run_port(s)[10].mean() < s["nwfa"].mean()


def test_ice_number_responds_to_nifa():
    """DeMott nucleation scales with dust: a hundred times the ice
    nuclei, more ice."""
    s = _column_case(t_sfc=262.0, rh=1.3)
    lo = run_port(s)
    hi = run_port(s, nifa=s["nifa"] * 100.0)
    assert hi[7].mean() > lo[7].mean(), (lo[7].mean(), hi[7].mean())


def test_rain_scavenges_aerosol():
    """Heavy rain and no cloud (no activation): both aerosols decrease."""
    s = _column_case(rh=0.99)
    s.update(qr=np.full_like(s["qr"], 2e-3), nr=np.full_like(s["nr"], 1e5),
             qc=np.zeros_like(s["qc"]))
    out = run_port(s)
    assert out[10].mean() < s["nwfa"].mean()
    assert out[11].mean() < s["nifa"].mean()

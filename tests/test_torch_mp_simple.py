"""The port's plain SB04 microphysics (the plain version of kernel K2)
against the JAX package's jnp path and its Pallas kernel (interpret mode).

Tolerance rtol 1e-5, atol 3e-8: the same operation order on both sides,
but exp differs between the libraries by an ulp or so, and the saturation
sweeps carry that into cloud water as a few ulps of the ~0.02 kg/kg vapour
field (up to 1.7e-8 seen over 29 seeded cases; 3e-8 is 16 such ulps). The
inputs cover
supersaturated cells, subsaturated cells with cloud, cells that trip the
15-sweep revert, warm and cold columns, and rain and snow falling through
dry layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu.ops import pallas_kernels as pk
from icar_tpu.physics import mp_simple as jmp
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.physics import mp_simple as tmp

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 3e-8
NAMES = ("theta", "qv", "qc", "qr", "qs", "rain", "snow")

# a cell whose saturation adjustment still moves qv by more than MAXERR in
# its 15th sweep, so it reverts (found in the golden ridge run)
REVERT_CELL = dict(t=295.59192, qv=0.01906706, qc=8.7052766e-05,
                   p=94116.77)


def _columns(seed, regime, nz=10, ny=6, nx=9):
    """Seeded (p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz)."""
    r = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    z = np.cumsum(np.full(nz, 300.0)) - 150.0
    t_sfc = {"warm": 300.0, "cold": 262.0, "mixed": 281.0}[regime]
    p = (101325.0 * np.exp(-z / 8000.0))[:, None, None] * np.ones(shape)
    t = (t_sfc - 0.0065 * z)[:, None, None] + r.uniform(-6, 6, shape)
    es = 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86))
    qvs = 0.622 * es / (p - es)
    # supersaturated, near-saturated and dry cells; dry layers at the bottom
    qv = qvs * r.choice([0.3, 0.9, 1.0, 1.2, 1.5], size=shape)
    qv[:2] = qvs[:2] * 0.4
    qc = np.where(r.uniform(size=shape) < 0.5, r.uniform(0, 1e-3, shape), 0)
    qr = np.where(r.uniform(size=shape) < 0.4, r.uniform(0, 5e-4, shape), 0)
    qs = np.where(r.uniform(size=shape) < 0.4, r.uniform(0, 5e-4, shape), 0)
    # plant the reverting cell
    t[4, 2, 3], qv[4, 2, 3] = REVERT_CELL["t"], REVERT_CELL["qv"]
    qc[4, 2, 3], p[4, 2, 3] = REVERT_CELL["qc"], REVERT_CELL["p"]
    exner = (p / 100000.0) ** 0.2857
    theta = t / exner
    rho = p / (287.058 * t)
    rain = r.uniform(0, 3, shape[1:])
    snow = r.uniform(0, 1, shape[1:])
    dz = np.full(shape, 250.0) * r.uniform(0.6, 1.4, (nz, 1, 1))
    return [np.asarray(a, np.float32) for a in
            (p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz)]


CASES = [(seed, regime) for seed, regime in
         ((1, "warm"), (2, "cold"), (3, "mixed"), (4, "warm"), (5, "cold"))]


@pytest.mark.parametrize("seed,regime", CASES)
def test_plain_mp_matches_jnp(seed, regime):
    *args, dz = _columns(seed, regime)
    dt = np.float32(50.0)
    want = jmp.mp_simple(*[jnp.asarray(a) for a in args], dt,
                         jnp.asarray(dz), use_pallas=False)
    got = tmp.mp_simple(*[torch.tensor(a) for a in args], dt,
                        torch.tensor(dz))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("seed,regime", CASES[:3])
def test_plain_mp_matches_pallas_kernel(seed, regime):
    *args, dz = _columns(seed, regime)
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow = args
    dt = np.float32(40.0)
    c2r, c2s = tmp.formation_rates(dt)
    prev = pk.force_interpret(True)
    try:
        want = pk.mp_simple_tpu(*[jnp.asarray(a) for a in args], dt,
                                jnp.asarray(dz), np.float32(c2r),
                                np.float32(c2s))
    finally:
        pk.force_interpret(prev)
    got = tmp.mp_simple(*[torch.tensor(a) for a in args], dt,
                        torch.tensor(dz))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_cloud_conversion_reverts_like_jnp():
    p, _, _, _, qv, qc, _, _, _, _, _ = _columns(3, "mixed")
    t = np.full_like(p, 280.0)
    t[4, 2, 3] = REVERT_CELL["t"]
    want = jmp.cloud_conversion(jnp.asarray(p), jnp.asarray(t),
                                jnp.asarray(qv), jnp.asarray(qc), 40.0)
    got = tmp.cloud_conversion(torch.tensor(p), torch.tensor(t),
                               torch.tensor(qv), torch.tensor(qc))
    for name, g, w in zip(("t", "qv", "qc", "qvsat"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the planted cell reverts to its entry temperature and qc
    assert got[0][4, 2, 3] == np.float32(REVERT_CELL["t"])
    assert got[2][4, 2, 3] == np.float32(REVERT_CELL["qc"])


@pytest.mark.parametrize("snow", [False, True])
def test_sediment_species_matches_jnp(snow):
    r = np.random.default_rng(9)
    nz, ny, nx = 10, 7, 12
    p, theta, exner, rho, qv, *_ = _columns(9, "mixed", nz, ny, nx)
    t = theta * exner
    q = np.where(r.uniform(size=p.shape) < 0.6, r.uniform(0, 8e-4, p.shape),
                 0.0).astype(np.float32)
    dz = (np.full(p.shape, 150.0) * r.uniform(0.6, 1.4, (nz, 1, 1))
          ).astype(np.float32)
    dt = np.float32(60.0)
    fall = tmp.SNOW_FALL_RATE if snow else tmp.RAIN_FALL_RATE
    want = jmp._sediment_species(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t), jnp.asarray(p),
        jnp.asarray(rho), jnp.asarray(dz), dt, fall, np.float32(0.93),
        (lambda T: -jmp.LH_LIQUID - (jmp.LH_VAPOR + (373.15 - T)
                                     * jmp.DLHVDT)) if snow else
        (lambda T: -(jmp.LH_VAPOR + (373.15 - T) * jmp.DLHVDT)))
    got = tmp._sediment_species(
        torch.tensor(q), torch.tensor(qv), torch.tensor(t), torch.tensor(p),
        torch.tensor(rho), torch.tensor(dz), dt, fall, float(np.float32(0.93)),
        tmp._l_subl if snow else tmp._l_evap)
    for name, g, w in zip(("q", "qv", "t", "precip"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_wrapper_on_cpu_updates_in_place():
    p, theta, exner, _, qv, qc, qr, qs, rain, snow, dz = _columns(6, "mixed")
    dt = np.float32(45.0)
    c2r, c2s = tmp.formation_rates(dt)
    # the wrapper computes density from the entry state, as the kernel does
    rho = p / (np.float32(287.058) * (theta * exner))
    want = tmp.mp_simple(*[torch.tensor(a) for a in
                           (p, theta, exner, rho, qv, qc, qr, qs, rain,
                            snow)], dt, torch.tensor(dz), c2r, c2s)
    stack = torch.tensor(np.stack([theta, qv, qc, qr, qs]))
    acc = [torch.tensor(rain), torch.tensor(snow)]
    before = dict(kernels.LAUNCHES)
    kernels.mp_simple(*stack, torch.tensor(p), torch.tensor(exner),
                      torch.tensor(dz), *acc, dt, c2r, c2s)
    for name, g, w in zip(NAMES, list(stack) + acc, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    assert kernels.LAUNCHES == before


def _scaled_density(rho, seed):
    """A density that is not p/(Rd*T): the diagnostic one scaled by a
    seeded factor in [0.7, 1.3] per cell."""
    r = np.random.default_rng(100 + seed)
    return (rho * r.uniform(0.7, 1.3, rho.shape)).astype(np.float32)


@pytest.mark.parametrize("seed,regime", CASES[:3])
def test_density_operand_path_matches_pallas_kernel(seed, regime):
    """The port's K3 path (kernels.mp_simple_rho on CPU tensors) against
    the JAX package's K3 entry, mp_simple_tpu, in interpret mode, with a
    density that is not the diagnostic one; and the density is read: the
    diagnostic density gives another result."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = _columns(
        seed, regime)
    rho2 = _scaled_density(rho, seed)
    dt = np.float32(40.0)
    c2r, c2s = tmp.formation_rates(dt)
    args = (p, theta, exner, rho2, qv, qc, qr, qs, rain, snow)
    prev = pk.force_interpret(True)
    try:
        want = pk.mp_simple_tpu(*[jnp.asarray(a) for a in args], dt,
                                jnp.asarray(dz), np.float32(c2r),
                                np.float32(c2s))
    finally:
        pk.force_interpret(prev)
    fields = [torch.tensor(a) for a in (theta, qv, qc, qr, qs, rain, snow)]
    before = dict(kernels.LAUNCHES)
    kernels.mp_simple_rho(*fields[:5], torch.tensor(p), torch.tensor(exner),
                          torch.tensor(rho2), torch.tensor(dz), *fields[5:],
                          dt, c2r, c2s)
    assert kernels.LAUNCHES == before
    for name, g, w in zip(NAMES, fields, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    diag = tmp.mp_simple(*[torch.tensor(a) for a in
                           (p, theta, exner, rho, qv, qc, qr, qs, rain,
                            snow)], dt, torch.tensor(dz), c2r, c2s)
    assert not torch.equal(diag[3], fields[3]), "density operand not read"


def test_density_operand_wrapper_on_cpu_updates_in_place():
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = _columns(7, "mixed")
    rho2 = _scaled_density(rho, 7)
    dt = np.float32(45.0)
    c2r, c2s = tmp.formation_rates(dt)
    want = tmp.mp_simple(*[torch.tensor(a) for a in
                           (p, theta, exner, rho2, qv, qc, qr, qs, rain,
                            snow)], dt, torch.tensor(dz), c2r, c2s)
    stack = torch.tensor(np.stack([theta, qv, qc, qr, qs]))
    acc = [torch.tensor(rain), torch.tensor(snow)]
    kernels.mp_simple_rho(*stack, torch.tensor(p), torch.tensor(exner),
                          torch.tensor(rho2), torch.tensor(dz), *acc, dt,
                          c2r, c2s)
    for name, g, w in zip(NAMES, list(stack) + acc, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def test_saturation_sweeps_count_each_cells_iterations():
    """The sweep counts behind cloud_conversion's revert: at most
    N_SAT_ITERS, and the planted cell runs all of them."""
    p, _, _, _, qv, qc, _, _, _, _, _ = _columns(3, "mixed")
    t = np.full_like(p, 280.0)
    t[4, 2, 3] = REVERT_CELL["t"]
    *_, niter = tmp.saturation_sweeps(torch.tensor(p), torch.tensor(t),
                                      torch.tensor(qv), torch.tensor(qc))
    assert int(niter.max()) == tmp.N_SAT_ITERS == int(niter[4, 2, 3])
    assert int(niter.min()) >= 1


def _operator_division(a, b):
    """The plain version's divisions before ``_div``: torch's own operator,
    as it rounds them on the CPU (a number over a tensor as the tensor's
    reciprocal times the number)."""
    return a / b


def _card_division(a, b):
    """The same divisions as torch rounds them on the card: a tensor over a
    number as a product with the number's float32 reciprocal, a number over
    a tensor as the tensor's reciprocal times the number."""
    if torch.is_tensor(a) and not torch.is_tensor(b):
        return a * (torch.tensor(1.0, dtype=a.dtype)
                    / torch.tensor(b, dtype=a.dtype))
    if torch.is_tensor(b) and not torch.is_tensor(a):
        return b.reciprocal() * a
    return a / b


def _values_off(got, want):
    """How many output values differ in their bits."""
    return sum(int((np.asarray(g).view(np.int32)
                    != np.asarray(w).view(np.int32)).sum())
               for g, w in zip(got, want))


def test_div_rounds_as_the_jax_package_divides():
    """``_div`` gives the JAX package's bits for a number over an array (the
    CFL count, fall distance, evaporation rate), run op by op or under jit,
    and for an array over a number (vapor2temp, latent heating) run op by
    op, where the card's rounding does not, nor torch's operator on the CPU
    for a number over an array. (Under jit XLA folds an array over a
    constant into a product with its float32 reciprocal, as torch does on
    the card; the kernel divides.)"""
    r = np.random.default_rng(0)
    dz = r.uniform(40.0, 300.0, 50000).astype(np.float32)
    heat = r.uniform(2e6, 3e6, 50000).astype(np.float32)
    dt = float(np.float32(1200.0 / 23))
    over_dz = np.asarray(dt / jnp.asarray(dz))
    assert np.array_equal(over_dz, np.asarray(jax.jit(lambda a: dt / a)(dz)))
    for a, b, want in ((dt, torch.tensor(dz), over_dz),
                       (torch.tensor(heat), tmp.HEAT_CAPACITY,
                        np.asarray(jnp.asarray(heat) / tmp.HEAT_CAPACITY))):
        assert _values_off([tmp._div(a, b).numpy()], [want]) == 0
        assert _values_off([_card_division(a, b).numpy()], [want]) > 0
    assert _values_off([(dt / torch.tensor(dz)).numpy()], [over_dz]) > 0


@pytest.mark.parametrize("seed,regime", CASES)
def test_plain_divisions_are_nearer_the_jax_package(seed, regime,
                                                    monkeypatch):
    """The whole scheme with ``_div`` against the same scheme with the
    divisions torch rounds otherwise (on the CPU, and as on the card): on
    the same seeded columns fewer of its output values differ from the JAX
    package's jnp path, and fewer from its Pallas kernel in interpret
    mode."""
    *args, dz = _columns(seed, regime)
    dt = np.float32(40.0)
    c2r, c2s = tmp.formation_rates(dt)
    jargs = [jnp.asarray(a) for a in args]
    want_jnp = jmp.mp_simple(*jargs, dt, jnp.asarray(dz), use_pallas=False)
    prev = pk.force_interpret(True)
    try:
        want_pallas = pk.mp_simple_tpu(*jargs, dt, jnp.asarray(dz),
                                       np.float32(c2r), np.float32(c2s))
    finally:
        pk.force_interpret(prev)

    def off(division):
        monkeypatch.setattr(tmp, "_div", division)
        got = [g.numpy() for g in tmp.mp_simple(
            *[torch.tensor(a) for a in args], dt, torch.tensor(dz),
            c2r, c2s)]
        return _values_off(got, want_jnp), _values_off(got, want_pallas)

    near = off(tmp._div)
    for division in (_operator_division, _card_division):
        far = off(division)
        assert near[0] < far[0] and near[1] < far[1], (division, near, far)

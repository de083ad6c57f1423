"""SB04 "simple" microphysics: the plain PyTorch version of kernel K2
(icar_tpu/physics/mp_simple.py, the microphysics of Smith & Barstad 2004).

Instant saturation adjustment with latent-heat feedback, time-constant
conversion of cloud to rain/snow, explicit sedimentation at fixed fall
speeds with CFL substepping, and evaporation/sublimation of falling
precipitation. Every branch is a masked ``torch.where`` over the whole
(z, y, x) grid, in the JAX package's operation order. The CUDA kernel
(``csrc/mp_simple.cu``) runs the same scheme on tiles of columns, the cells
spread over a block's threads.
"""

from __future__ import annotations

import torch

from ..ops import pointwise as pw

# module parameters (mp_simple.f90:63-96)
LH_VAPOR = 2.26e6
DLHVDT = 2400.0
LH_LIQUID = 3.34e5
HEAT_CAPACITY = 1006.0
SMALL = 1e-30
SNOW_FORMATION_TC = 1 / 2000.0
RAIN_FORMATION_TC = 1 / 500.0
FREEZING = 273.15
SNOW_FALL_RATE = 1.5     # m/s
RAIN_FALL_RATE = 10.0    # m/s
SNOW_CLOUD_INIT = 1e-4   # kg/kg
RAIN_CLOUD_INIT = 1e-4   # kg/kg
MAXERR = 1e-4
N_SAT_ITERS = 15


def formation_rates(dt):
    """(cloud2rain, cloud2snow) = exp(-dt/tau) in float32, as the JAX
    package computes them from a float32 dt; returned as Python floats
    that hold float32 values."""
    dt32 = torch.tensor(float(dt), dtype=torch.float32)
    c2r = torch.exp(torch.tensor(-RAIN_FORMATION_TC, dtype=torch.float32)
                    * dt32)
    c2s = torch.exp(torch.tensor(-SNOW_FORMATION_TC, dtype=torch.float32)
                    * dt32)
    return float(c2r), float(c2s)


# ``a / b`` as one IEEE division where one operand is a Python number, as
# the kernel divides: torch's own operator is an ulp off now and then,
# enough to change a cell's count of saturation sweeps; the JAX package's
# results lie nearer this rounding (tests/test_torch_mp_simple.py)
_div = pw.div


def sat_mr(temperature, pressure):
    """Saturated mixing ratio [kg/kg] over liquid above 0C, over ice below
    (sat_mr, mp_simple.f90:146-182; Lowe & Ficke 1974)."""
    cold = temperature < FREEZING
    a = torch.where(cold, 21.8745584, 17.2693882).to(temperature.dtype)
    b = torch.where(cold, 7.66, 35.86).to(temperature.dtype)
    e_s = 610.78 * pw.exp(a * (temperature - 273.16) / (temperature - b))
    e_s = torch.where(pressure - e_s <= 0, pressure * 0.99999, e_s)
    return 0.6219907 * e_s / (pressure - e_s)


def saturation_sweeps(pressure, temperature, qv, qc):
    """The sweeps of the saturation adjustment (cloud_conversion,
    mp_simple.f90:198-280): each cell iterates until its own vapour change
    is below MAXERR, at most N_SAT_ITERS times. Returns (temperature, qv,
    qc, qvsat, niter), niter the sweeps each cell took."""
    vapor2temp = _div(LH_VAPOR + (373.15 - temperature) * DLHVDT,
                      HEAT_CAPACITY)
    t = temperature
    qvsat = torch.zeros_like(qv)
    lastqv = qv + 2 * MAXERR
    niter = torch.zeros(qv.shape, dtype=torch.int32, device=qv.device)
    for _ in range(N_SAT_ITERS):
        active = torch.abs(lastqv - qv) > MAXERR
        if not bool(active.any()):
            break
        lastqv = torch.where(active, qv, lastqv)
        qvs = sat_mr(t, pressure)
        qvsat = torch.where(active, qvs, qvsat)

        supersat = qv > qvs
        exc_sup = (qv - qvs) * 0.5
        t_sup = t + exc_sup * vapor2temp
        qv_sup = qv - exc_sup
        qc_sup = qc + exc_sup

        # unsaturated with cloud present: evaporate up to all of qc
        exc_un = (qvs - qv) * 0.5
        evap = torch.where(exc_un >= qc, qc, exc_un)
        t_un = t - evap * vapor2temp
        qv_un = qv + evap
        qc_un = qc - evap

        has_cloud = qc > 0
        t_new = torch.where(supersat, t_sup, torch.where(has_cloud, t_un, t))
        qv_new = torch.where(supersat, qv_sup,
                             torch.where(has_cloud, qv_un, qv))
        qc_new = torch.where(supersat, qc_sup,
                             torch.where(has_cloud, qc_un, qc))

        t = torch.where(active, t_new, t)
        qv = torch.where(active, qv_new, qv)
        qc = torch.where(active, qc_new, qc)
        niter = niter + active.to(torch.int32)
    return t, qv, qc, qvsat, niter


def cloud_conversion(pressure, temperature, qv, qc):
    """Saturation adjustment with latent heating (cloud_conversion,
    mp_simple.f90:198-280). Returns (temperature, qv, qc, qvsat).

    A cell still active in the last of its ``saturation_sweeps`` reverts
    to its entry state (mp_simple.f90:248-255)."""
    pre_t, pre_qc = temperature, qc
    t, qv, qc, qvsat, niter = saturation_sweeps(pressure, temperature, qv,
                                                qc)
    failed = niter >= N_SAT_ITERS
    t = torch.where(failed, pre_t, t)
    qv = torch.where(failed, sat_mr(pre_t, pressure), qv)
    qc = torch.where(failed, pre_qc, qc)
    qc = torch.clamp(qc, min=0.0)
    return t, qv, qc, qvsat


def cloud2hydrometeor(qc, q, conversion, qcmin):
    """Convert cloud to rain/snow with a time constant (cloud2hydrometeor,
    mp_simple.f90:295-315)."""
    delta = torch.where(qc > qcmin, qc - qc * conversion,
                        torch.zeros_like(qc))
    transfer = torch.minimum(delta, qc)
    return torch.clamp(qc - transfer, min=0.0), q + transfer


def phase_change(temperature, q1, qmax, q2, lheat, change_rate):
    """Generic phase change q1 -> q2 with latent heating (phase_change,
    mp_simple.f90:333-362)."""
    delta = (qmax - q2) * change_rate
    delta = torch.minimum(delta, q1)
    delta = torch.minimum(delta, (qmax - q2) * 0.99)
    delta = torch.clamp(delta, min=0.0)
    q1n = torch.clamp(q1 - delta, min=0.0)
    q2n = q2 + delta
    # a number (melting) is divided in double, as the JAX package's Python
    # scalars are
    heat = (_div(lheat, HEAT_CAPACITY) if torch.is_tensor(lheat)
            else lheat / HEAT_CAPACITY)
    tn = temperature + delta * heat
    return tn, q1n, q2n


def mp_conversions(pressure, temperature, qv, qc, qr, qs, cloud2rain,
                   cloud2snow):
    """All per-cell conversions (mp_conversions, mp_simple.f90:381-420)."""
    l_melt = -LH_LIQUID
    l_evap = -(LH_VAPOR + (373.15 - temperature) * DLHVDT)
    l_subl = l_melt + l_evap

    temperature, qv, qc, qvsat = cloud_conversion(pressure, temperature, qv,
                                                  qc)

    any_species = (qc + qr + qs) > SMALL
    qc_big = qc > SMALL
    warm = temperature > FREEZING

    # warm cloud -> rain
    m = any_species & qc_big & warm
    qc_r, qr_r = cloud2hydrometeor(qc, qr, cloud2rain, RAIN_CLOUD_INIT)
    qc = torch.where(m, qc_r, qc)
    qr = torch.where(m, qr_r, qr)
    # above freezing, melt snow into rain
    mm = m & (qs > SMALL)
    t_m, qs_m, qr_m = phase_change(temperature, qs, 100.0, qr, l_melt,
                                   cloud2rain)
    temperature = torch.where(mm, t_m, temperature)
    qs = torch.where(mm, qs_m, qs)
    qr = torch.where(mm, qr_m, qr)

    # cold cloud -> snow
    mc = any_species & qc_big & ~warm
    qc_s, qs_s = cloud2hydrometeor(qc, qs, cloud2snow, SNOW_CLOUD_INIT)
    qc = torch.where(mc, qc_s, qc)
    qs = torch.where(mc, qs_s, qs)

    # subsaturated: evaporate rain, then sublimate snow
    unsat = any_species & (qv < qvsat)
    mr = unsat & (qr > SMALL)
    t_e, qr_e, qv_e = phase_change(temperature, qr, qvsat, qv, l_evap,
                                   cloud2rain / 2)
    temperature = torch.where(mr, t_e, temperature)
    qr = torch.where(mr, qr_e, qr)
    qv = torch.where(mr, qv_e, qv)
    ms = unsat & (qs > SMALL)
    t_s, qs_e, qv_s = phase_change(temperature, qs, qvsat, qv, l_subl,
                                   cloud2snow / 2)
    temperature = torch.where(ms, t_s, temperature)
    qs = torch.where(ms, qs_e, qs)
    qv = torch.where(ms, qv_s, qv)

    return temperature, qv, qc, qr, qs


def _sediment_substep(q, fall_dist, rho, dz):
    """One explicit upstream fall step (sediment, mp_simple.f90:437-459).
    ``fall_dist`` is the per-substep, per-column fall distance [m], shape
    (ny, nx). Returns (q_new, surface_flux [kg/m^2])."""
    sed = fall_dist * q[0] * rho[0]
    flux = fall_dist[None] * q[1:] * rho[1:]        # into layer k from k+1
    zeros = torch.zeros_like(q[:1])
    gain = torch.cat([flux, zeros], dim=0)
    loss = torch.cat([zeros, flux], dim=0)
    q_new = q + (gain - loss) / (rho * dz)
    q_new[0] = q_new[0] + (-sed / (dz[0] * rho[0]))
    return q_new, sed


def _sediment_species(q, qv, temperature, pressure, rho, dz, dt,
                      fall_rate, evap_rate_base, l_heat):
    """CFL-substepped sedimentation + inter-substep evaporation for one
    species (mp_simple.f90:507-564). Each column takes its own number of
    substeps, ceil(max_k dt*v/dz); columns that finish early are masked.

    Returns (q, qv, temperature, accumulated surface precipitation)."""
    dt = float(dt)
    cfl = torch.ceil(torch.amax(_div(dt, dz) * fall_rate, dim=0))  # (ny, nx)
    n_max = int(torch.max(cfl))
    fall_dist = _div(dt * fall_rate, cfl)                          # [m]
    evap_rate = _div(evap_rate_base, 2.0 * cfl)

    precip = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    for s in range(n_max):
        active = s < cfl                                           # (ny, nx)
        q_new, sed = _sediment_substep(q, fall_dist, rho, dz)
        q = torch.where(active[None], q_new, q)
        precip = precip + torch.where(active, sed, torch.zeros_like(sed))
        # evaporate/sublimate fallen precipitation in subsaturated layers
        qvsat = sat_mr(temperature, pressure)
        m = active[None] & (qv < qvsat) & (q > SMALL)
        t_e, q_e, qv_e = phase_change(temperature, q, qvsat, qv,
                                      l_heat(temperature), evap_rate[None])
        temperature = torch.where(m, t_e, temperature)
        q = torch.where(m, q_e, q)
        qv = torch.where(m, qv_e, qv)
    return q, qv, temperature, precip


def _l_evap(t):
    return -(LH_VAPOR + (373.15 - t) * DLHVDT)


def _l_subl(t):
    return -LH_LIQUID + _l_evap(t)


def mp_simple(pressure, theta, exner, rho, qv, qc, qr, qs, rain, snow, dt,
              dz, cloud2rain=None, cloud2snow=None):
    """The whole SB04 scheme (mp_simple.f90:595-646).

    All 3D args are (z, y, x); rain/snow are (y, x) accumulators [mm];
    ``dt`` is a float32 value. The conversion rates default to
    ``formation_rates(dt)``. Returns new (theta, qv, qc, qr, qs, rain,
    snow); the inputs are not modified."""
    if cloud2rain is None:
        cloud2rain, cloud2snow = formation_rates(dt)

    temperature = theta * exner
    temperature, qv, qc, qr, qs = mp_conversions(
        pressure, temperature, qv, qc, qr, qs, cloud2rain, cloud2snow)

    # rain sedimentation, only when rain exists anywhere (mp_simple.f90:507)
    if bool(torch.max(qr) > SMALL):
        qr, qv, temperature, sed = _sediment_species(
            qr, qv, temperature, pressure, rho, dz, dt, RAIN_FALL_RATE,
            cloud2rain, _l_evap)
        rain = rain + sed

    # snow sedimentation; snowfall adds to both snow and total rain
    # (mp_simple.f90:542-549)
    if bool(torch.max(qs) > SMALL):
        qs, qv, temperature, sed = _sediment_species(
            qs, qv, temperature, pressure, rho, dz, dt, SNOW_FALL_RATE,
            cloud2snow, _l_subl)
        rain = rain + sed
        snow = snow + sed

    theta = temperature / exner
    return theta, qv, qc, qr, qs, rain, snow

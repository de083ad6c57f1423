"""Thompson two-moment microphysics (mp=1) and the aerosol-aware
Thompson-Eidhammer scheme (mp=5): the plain PyTorch version of kernel K5
(icar_tpu/physics/mp_thompson.py, Thompson et al. 2004, 2008).

Six water species (vapour, cloud, ice, rain, snow, graupel) with
prognostic ice and rain number, over the whole (z, y, x) grid, following
the JAX package's jnp path expression by expression: prep (loads, clamps,
thermodynamics, snow moments, size distributions), the lookup-table bins,
the table values, the core (process rates, conservation, the TAU+1
update, condensation, rain evaporation, terminal velocities) and the post
block (four sedimentation loops, instant melt/freeze, final update). The
CUDA kernel (``csrc/mp_thompson.cu``) runs the same scheme one column per
thread.

The aerosol-aware scheme (``mp_thompson_aer``, the ``aer`` branches of
the blocks) adds the droplet number and the water- and ice-friendly
aerosol numbers: activation, droplet evaporation through the ``tnc_wev``
table, DeMott dust nucleation, Koop homogeneous freezing, wet scavenging,
drizzle settling in the lowest 500 m. No TPU kernel runs it (the JAX
package's core takes its jnp path when aerosol-aware), so it runs as
plain PyTorch on the card too. ``calc_effect_rad`` forms the effective
radii RRTMG reads, with or without the droplet number; ``aer_init_profiles``
and ``aer_surface_flux`` (numpy, copies) the default aerosol profiles and
the surface replenishment a model installs at set-up.

Differences from the JAX module, none of which changes a value:

- Table values are read by direct indexing. The JAX package reads the
  small 2D tables through one-hot contractions that are exact by
  construction, and skips a big-table gather when no cell of the domain
  consumes it (``_gated_take``, zeros instead); every consumer of a gated
  group is masked by the same predicate, so the real values give the same
  result. The three big stacks are rounded to bfloat16 (round to nearest
  even, as ``ml_dtypes`` does) and widened to float32 when read.
- XLA folds ``x / c`` for a constant ``c`` into ``x * (1/c)`` with the
  reciprocal rounded to float32 (so does PyTorch on the card), and keeps
  ``c / x`` one division; PyTorch on the CPU divides ``x / c`` and computes
  ``c / x`` as ``(1/x) * c``. ``_dc`` and ``_rd`` write out XLA's form, and
  ``_pow`` its rewrites of constant powers, so the port rounds like the
  JAX package on either device.

Only the sedimentation reads the device: each loop's trip count (the
domain's largest fall), once a loop.

Layout (z, y, x), level 0 = surface, float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pointwise as pw
from . import thompson_tables as tt
from .thompson_tables import (AM_I, AM_R, ATO, AV_R, BM_G, BM_I, BM_R,
                              BV_I, C_CUBE, CP2, D0C, D0G, D0R, D0S, EPS,
                              FV_R, GONV_MAX, GONV_MIN, HGFR, KAP0, KAP1,
                              LAM0, LAM1, LFUS, LSUB, LVAP0, MU_S, NBC, NBR,
                              NBS, NTB_C, NTB_G1, NTB_I, NTB_I1, NTB_R,
                              NTB_R1, NTB_S, NTB_T, PI, R1, R2, RHO_NOT,
                              RHO_W, RR2, RV, XM0I, ThompsonParams,
                              get_tables)

T_0 = 273.15
ORV = 1.0 / RV
OLFUS = 1.0 / LFUS
SA = tuple(float(v) for v in tt.SA)
SB = tuple(float(v) for v in tt.SB)

def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _dc(x, c):
    """``x / c`` for a constant ``c`` as XLA computes it: ``x`` times the
    float32 reciprocal of float32 ``c``."""
    return x * float(np.float32(1.0) / np.float32(c))


def _rd(c, x):
    """``c / x`` for a constant ``c``, one float32 division."""
    return torch.tensor(_f32(c), dtype=x.dtype) / x


def _pow(x, e):
    """``x ** e`` for a constant float ``e``, with XLA's rewrites of
    exponents 1, 2, 3 and -1."""
    e = _f32(e)
    if e == 1.0:
        return x
    if e == 2.0:
        return x * x
    if e == 3.0:
        return x * (x * x)
    if e == -1.0:
        return 1.0 / x
    return pw.pow(x, e)


def _ipow(x, n: int):
    """``x ** n`` for a Python int ``n`` >= 1, by the binary exponentiation
    of jax.lax.integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _where(cond, a, b):
    """``jnp.where`` with Python scalars allowed on either side."""
    if not torch.is_tensor(a):
        a = torch.tensor(_f32(a), dtype=torch.float32, device=cond.device)
    if not torch.is_tensor(b):
        b = torch.tensor(_f32(b), dtype=torch.float32, device=cond.device)
    return torch.where(cond, a, b)


def _max(a, b):
    """``jnp.maximum`` (propagates NaN) with a scalar on either side."""
    if not torch.is_tensor(a):
        a, b = b, a
    if not torch.is_tensor(b):
        b = torch.tensor(_f32(b), dtype=a.dtype, device=a.device)
    return torch.maximum(a, b)


def _min(a, b):
    if not torch.is_tensor(a):
        a, b = b, a
    if not torch.is_tensor(b):
        b = torch.tensor(_f32(b), dtype=a.dtype, device=a.device)
    return torch.minimum(a, b)


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


def rslf(p, t):
    """Liquid saturation mixing ratio, Flatau et al. 1992 polynomial
    (mp_thompson.f90:3776-3805)."""
    x = _max(-80.0, t - 273.16)
    C = (0.611583699e3, 0.444606896e2, 0.143177157e1, 0.264224321e-1,
         0.299291081e-3, 0.203154182e-5, 0.702620698e-8, 0.379534310e-11,
         -0.321582393e-13)
    esl = C[8]
    for cc in C[7::-1]:
        esl = cc + x * esl
    return 0.622 * esl / (p - esl)


def rsif(p, t):
    """Ice saturation mixing ratio (mp_thompson.f90:3812-3835)."""
    x = _max(-80.0, t - 273.16)
    C = (0.609868993e3, 0.499320233e2, 0.184672631e1, 0.402737184e-1,
         0.565392987e-3, 0.521693933e-5, 0.307839583e-7, 0.105785160e-9,
         0.161444444e-12)
    esi = C[8]
    for cc in C[7::-1]:
        esi = cc + x * esi
    return 0.622 * esi / (p - esi)


def _field_ab(tc, n):
    """Field et al. (2005) moment coefficients a(n,Tc), b(n,Tc); n is a
    Python float, tc a tensor."""
    loga = (SA[0] + SA[1] * tc + SA[2] * n + SA[3] * tc * n
            + SA[4] * tc * tc + SA[5] * n * n + SA[6] * tc * tc * n
            + SA[7] * tc * n * n + SA[8] * tc ** 3 + SA[9] * n ** 3)
    b = (SB[0] + SB[1] * tc + SB[2] * n + SB[3] * tc * n
         + SB[4] * tc * tc + SB[5] * n * n + SB[6] * tc * tc * n
         + SB[7] * tc * n * n + SB[8] * tc ** 3 + SB[9] * n ** 3)
    return pw.pow(10.0, loga), b


def _field_moment(tc, n, smo2):
    a, b = _field_ab(tc, float(n))
    return a * pw.pow(smo2, b)


def _mantissa_idx(r, lo_exp, ntb):
    """Decimal table index: value m*10^e maps to int(m) + 9*(e - lo_exp)
    (the reference's mantissa search, 0-based)."""
    n = torch.floor(pw.log10(_max(r, 1e-30)))
    mant = r / pw.pow(10.0, n)
    idx = (torch.trunc(mant).to(torch.int32)
           + 9 * (n.to(torch.int32) - lo_exp) - 1)
    return torch.clamp(idx, 0, ntb - 1)


def _nint(x):
    return torch.floor(x + 0.5).to(torch.int32)


def _filldown(vt, present):
    """vt(k) = vt(k) where the species is present, else the value from the
    level above (the reference's top-down carry)."""
    out = torch.empty_like(vt)
    acc = torch.zeros_like(vt[0])
    for k in range(vt.shape[0] - 1, -1, -1):
        acc = torch.where(present[k], vt[k], acc)
        out[k] = acc
    return out


def _cummin_rev(x):
    """Top-down cumulative minimum over axis 0 (NaN-propagating, as
    jnp.minimum)."""
    out = torch.empty_like(x)
    acc = x[-1]
    out[-1] = acc
    for k in range(x.shape[0] - 2, -1, -1):
        acc = torch.minimum(x[k], acc)
        out[k] = acc
    return out


def _sediment(rx, nx_, vt_m, vt_n, rho, dz, DT, with_number,
              floor_m=R1, floor_n=R2, vt_for_cfl=None):
    """Explicit flux-form sedimentation with per-column substepping
    (mp_thompson.f90:2657-2780). Returns (rx, nx_, qten_sed, nten_sed,
    surface flux sum with a leading singleton level axis). The loop runs to
    the domain's largest step count; a column past its own count is left
    as it is."""
    if vt_for_cfl is None:
        vt_for_cfl = torch.maximum(vt_m, vt_n) if with_number else vt_m
    per_k = torch.where(vt_for_cfl > 1e-3,
                        torch.trunc(DT * vt_for_cfl / dz).to(torch.int32)
                        + 1, 0)
    nstep = torch.clamp(torch.amax(per_k, dim=0, keepdim=True), min=1)
    onstep = 1.0 / nstep.to(rx.dtype)
    n_max = int(nstep.max())
    odzq = 1.0 / dz
    orho = 1.0 / rho
    qten = torch.zeros_like(rx)
    nten = torch.zeros_like(rx)
    sfc = torch.zeros_like(rx[:1])
    zero = torch.zeros_like(rx[:1])
    for s in range(n_max):
        active = s < nstep
        sed_m = vt_m * rx
        div_m = torch.cat([sed_m[1:], zero], 0) - sed_m
        d_q = div_m * odzq * onstep * orho
        rx_new = _max(floor_m, rx + div_m * odzq * DT * onstep)
        qten_new = qten + d_q
        sfc_inc = _where(rx_new[:1] > R1 * 10.0, sed_m[:1] * DT * onstep,
                         0.0)
        if with_number:
            sed_n = vt_n * nx_
            div_n = torch.cat([sed_n[1:], zero], 0) - sed_n
            nten_new = nten + div_n * odzq * onstep * orho
            nx_new = _max(floor_n, nx_ + div_n * odzq * DT * onstep)
        else:
            nten_new, nx_new = nten, nx_
        rx = torch.where(active, rx_new, rx)
        nx_ = torch.where(active, nx_new, nx_)
        qten = torch.where(active, qten_new, qten)
        nten = torch.where(active, nten_new, nten)
        sfc = sfc + _where(active, sfc_inc, 0.0)
    return rx, nx_, qten, nten, sfc


def _snow_moments(rs, temp, c):
    """Field et al. snow moments from the 2nd (= bm_s-th) moment
    (mp_thompson.f90:1375-1450)."""
    tc0 = _min(-0.1, temp - 273.15)
    smob = rs * c.oams
    smo2 = smob                                     # bm_s == 2
    loga0 = SA[0] + SA[1] * tc0 + SA[4] * tc0 ** 2 + SA[8] * tc0 ** 3
    b0 = SB[0] + SB[1] * tc0 + SB[4] * tc0 ** 2 + SB[8] * tc0 ** 3
    smo0 = pw.pow(10.0, loga0) * pw.pow(smo2, b0)
    smo1 = _field_moment(tc0, 1.0, smo2)
    smoc = _field_moment(tc0, float(c.cse[0]), smo2)
    smod = _field_moment(tc0, float(c.cse[13]), smo2)
    smoe = _field_moment(tc0, float(c.cse[12]), smo2)
    smof = _field_moment(tc0, float(c.cse[15]), smo2)
    return smob, smo2, smo0, smo1, smoc, smod, smoe, smof


def _graupel_intercept(rg, temp, mvd_r, has_rain, c):
    """Mixing-ratio-dependent graupel intercept with the top-down running
    minimum (mp_thompson.f90:1455-1489)."""
    xslw1 = _where((temp < 270.65) & has_rain & (mvd_r > 100e-6),
                   4.01 + pw.log10(mvd_r), 0.01)
    ygra1 = 4.31 + pw.log10(_max(5e-5, rg))
    zans1 = 3.1 + _rd(100., 300. * xslw1 * ygra1
                      / (_rd(10., xslw1) + 1. + 0.25 * ygra1)
                      + 30. + 10. * ygra1)
    N0_exp = _clip(pw.pow(10.0, zans1), GONV_MIN, GONV_MAX)
    N0_exp = _cummin_rev(N0_exp)
    lam_exp = _pow(N0_exp * c.am_g * c.cgg[0] / rg, c.oge1)
    lamg = lam_exp * (c.cgg[2] * c.ogg2 * c.ogg1) ** c.obmg
    ilamg = 1.0 / lamg
    N0_g = N0_exp / (c.cgg[1] * lam_exp) * _pow(lamg, c.cge[1])
    return ilamg, N0_g


def _rain_slope(rr, nr, c):
    lamr = _pow(AM_R * c.crg[2] * c.org2 * nr / rr, c.obmr)
    ilamr = 1.0 / lamr
    mvd_r = _rd(3.0 + c.mu_r + 0.672, lamr)
    N0_r = nr * c.org2 * _pow(lamr, c.cre[1])
    return ilamr, mvd_r, N0_r


def _rain_nr_from_mvd(rr, mvd, c):
    lamr = _rd(3.0 + c.mu_r + 0.672, mvd)
    return _dc(c.crg[1] * c.org3 * rr * _pow(lamr, BM_R), AM_R)


# lookup-table groups sharing an index tuple, in the JAX package's stack
# order (icar_tpu/physics/mp_thompson.py _RACS_NAMES, ...)
_RACS_NAMES = ("tcs_racs1", "tcs_racs2", "tmr_racs1", "tmr_racs2",
               "tcr_sacr1", "tcr_sacr2", "tms_sacr1", "tms_sacr2",
               "tnr_racs1", "tnr_racs2", "tnr_sacr1", "tnr_sacr2")
_RACG_NAMES = ("tmr_racg", "tcr_gacr", "tnr_racg", "tnr_gacr", "tcg_racg")
_QRFZ_NAMES = ("tpg_qrfz", "tpi_qrfz", "tni_qrfz", "tnr_qrfz")
_QCFZ_NAMES = ("tpi_qcfz", "tni_qcfz")
_IAUS_NAMES = ("tpi_ide", "tps_iaus", "tni_iaus")
# the stacks in the kernel's operand order
BIG_STACKS = ("racs", "racg", "qrfz")
SMALL_STACKS = ("efrw", "efsw", "qcfz", "iaus")
_PREP_CACHE = {}
_DEVICE_CACHE = {}


def params_key(params: ThompsonParams):
    return tuple(sorted(vars(params).items()))


def _prep_tables(params):
    """get_tables plus the stacked groups: ``_stk_racs``/``_stk_racg``/
    ``_stk_qrfz`` as flattened bfloat16 torch tensors (N, size), the small
    ``_stk_qcfz``/``_stk_iaus``/``_stk_efrw``/``_stk_efsw`` as float32
    numpy arrays (N, A, B). Built once per parameter set."""
    key = params_key(params)
    if key not in _PREP_CACHE:
        t, _ = get_tables(params)
        prep = dict(t)
        for gname, names in (("racs", _RACS_NAMES), ("racg", _RACG_NAMES),
                             ("qrfz", _QRFZ_NAMES)):
            flat = np.stack([t[n].reshape(-1) for n in names])
            prep["_stk_" + gname] = torch.from_numpy(
                np.ascontiguousarray(flat, np.float32)).to(torch.bfloat16)
        for gname, names in (("qcfz", _QCFZ_NAMES), ("iaus", _IAUS_NAMES),
                             ("efrw", ("t_Efrw",)), ("efsw", ("t_Efsw",))):
            prep["_stk_" + gname] = np.stack([t[n] for n in names])
        _PREP_CACHE[key] = prep
    return _PREP_CACHE[key]


def device_tables(params, device):
    """{group: tensor} of the seven stacks on ``device`` (the big ones
    bfloat16, the small ones float32) and, as "consts", the kernel's
    constants (kernel_constants, float32); uploaded once per parameter set
    and device."""
    key = (params_key(params), str(torch.device(device)))
    if key not in _DEVICE_CACHE:
        T = _prep_tables(params)
        tabs = {g: torch.as_tensor(T["_stk_" + g]).to(device).contiguous()
                for g in BIG_STACKS + SMALL_STACKS}
        tabs["consts"] = torch.tensor(
            list(kernel_constants(params).values()), dtype=torch.float32,
            device=device)
        _DEVICE_CACHE[key] = tabs
    return _DEVICE_CACHE[key]


def _thermo(temp, pres, qv):
    tempc = temp - 273.15
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    rhof = torch.sqrt(_rd(RHO_NOT, rho))
    rhof2 = torch.sqrt(rhof)
    diffu = 2.11e-5 * _pow(_dc(temp, 273.15), 1.94) * _rd(101325., pres)
    visco = torch.where(tempc >= 0.0,
                        (1.718 + 0.0049 * tempc) * 1e-5,
                        (1.718 + 0.0049 * tempc
                         - 1.2e-5 * tempc * tempc) * 1e-5)
    ocp = 1.0 / (CP2 * (1.0 + 0.887 * qv))
    vsc2 = torch.sqrt(rho / visco)
    lvap = LVAP0 + (2106.0 - 4218.0) * tempc
    tcond = (5.69 + 0.0168 * tempc) * 1e-5 * 418.936
    return rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond


# ---------------------------------------------------------------------------
# the aerosol-aware scheme's helpers (mp_thompson_aer.f90)
# ---------------------------------------------------------------------------

_TNC_CACHE = {}


def device_tnc_wev(device):
    """The droplet-evaporation table ``tnc_wev`` (NBC, NTB_C, NBC),
    flattened, float32, on ``device``; uploaded once per device."""
    key = str(torch.device(device))
    if key not in _TNC_CACHE:
        _TNC_CACHE[key] = torch.as_tensor(
            np.ascontiguousarray(tt.get_aer_tables()["tnc_wev"].ravel(),
                                 np.float32)).to(device)
    return _TNC_CACHE[key]


def _nu_c(ncr):
    """Per-cell cloud shape parameter nu_c = MIN(15, NINT(1e9/nc)+2)
    (mp_thompson_aer.f90:1655), int32; ``ncr`` in m^-3. NINT rounds half
    to even, as jnp.rint does."""
    return torch.clamp(torch.round(_rd(1000e6, ncr)).to(torch.int32) + 2,
                       2, 15)


def _g_ratios(nu_c):
    """Integer gamma ratios of the nu_c family: g1 = G(nu+4)/G(nu+1),
    g2 = G(nu+7)/G(nu+4) (mp_thompson_aer.f90:627-638, bm_r = 3)."""
    nu = nu_c.to(torch.float32)
    g1 = (nu + 1.) * (nu + 2.) * (nu + 3.)
    g2 = (nu + 4.) * (nu + 5.) * (nu + 6.)
    return g1, g2


def _vr_poly(D):
    """The rain fallspeed polynomial (thompson_tables._vr_poly) with the
    JAX package's integer powers (binary exponentiation)."""
    return (-0.1021 + 4.932e3 * D - 0.9551e6 * _ipow(D, 2)
            + 0.07934e9 * _ipow(D, 3) - 0.002362e12 * _ipow(D, 4))


_BOLTZMAN = 1.3806503e-23
_MEAN_PATH = 0.0256e-6


def _cunningham(Da):
    """The slip correction Cc of an aerosol of diameter ``Da`` (a Python
    float): the JAX package forms it in float32 from a float32 exp, here
    on a CPU tensor in its order."""
    e = pw.exp(torch.tensor(_f32(-0.55 * Da / _MEAN_PATH)))
    return float(1. + 2. * _MEAN_PATH / Da * (1.257 + 0.4 * e))


def _eff_aero(D, Da, visco, rho, temp, vt):
    """Aerosol collection efficiency by a collector of diameter D falling
    at vt (Eff_aero, mp_thompson_aer.f90:4993-5024); ``Da`` the aerosol's
    diameter, a Python float."""
    Cc = _cunningham(Da)
    diff = _BOLTZMAN * temp * Cc / (3. * PI * visco * Da)
    Re = 0.5 * rho * D * vt / visco
    Sc = visco / (rho * diff)
    St = Da * Da * vt * 1000. / (9. * visco * D)
    aval = 1. + pw.log(1. + Re)
    St2 = (1.2 + 1. / 12. * aval) / (1. + aval)
    Eff = (_rd(4., Re * Sc) * (1. + 0.4 * torch.sqrt(Re) * _pow(Sc, 1. / 3.)
                               + 0.16 * torch.sqrt(Re) * torch.sqrt(Sc))
           + _rd(4. * Da, D) * (0.02 + _rd(Da, D)
                                * (1. + 2. * torch.sqrt(Re))))
    Eff = Eff + _where(St > St2,
                       _pow((St - St2) / (St - St2 + 0.666667), 1.5), 0.0)
    return _clip(Eff, 1e-5, 1.0)


def _ice_demott(tempc, rho, nifa):
    """Heterogeneous ice nuclei from dust, DeMott et al. (2010)
    (iceDeMott, mp_thompson_aer.f90:4879-4949). nifa in m^-3; returns
    m^-3."""
    nifa_cc = nifa * tt.RHO_NOT0 * 1e-6 / rho
    xni = (5.94e-5 * _pow(-tempc, 3.33)) \
        * pw.pow(nifa_cc, (-0.0264 * tempc) + 0.0033)
    xni = _dc(xni * rho, tt.RHO_NOT0) * 1000.0
    return _max(0.0, xni)


def _ice_koop(temp, qv, qvs, nwfa, dt):
    """Homogeneous freezing of deliquesced aerosols, Koop et al. (2001)
    (iceKoop, mp_thompson_aer.f90:4955-4979). Returns m^-3."""
    R_uni = 8.314
    satw = qv / qvs
    mu_diff = (210368.0 + 131.438 * temp - _rd(3.32373e6, temp)
               - 41729.1 * pw.log(temp))
    a_w_i = pw.exp(mu_diff / (R_uni * temp))
    delta_aw = satw - a_w_i
    log_J = (-906.7 + 8502.0 * delta_aw - 26924.0 * _ipow(delta_aw, 2)
             + 29180.0 * _ipow(delta_aw, 3))
    J_rate = pw.pow(10.0, _min(20.0, log_J))
    prob_h = _min(1. - pw.exp(-J_rate * tt.AR_VOLUME * dt), 1.)
    return _max(0.0, _min(prob_h * nwfa, 1000e3))


# ---------------------------------------------------------------------------
# the staged blocks: prep -> table indices -> table values -> core -> post
# ---------------------------------------------------------------------------

def _prep_block(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d, exner,
                p1d, c, pp, nc1d=None, nwfa1d=None, nifa1d=None, w1d=None):
    """Hydrometeor loads/clamps, thermodynamics, saturation, snow moments
    and size distributions (mp_thompson.f90:1160-1494). Returns the prep
    dict P; its q*1d/n*1d entries are the masked (q > R1) values. With
    ``nc1d`` (the aerosol-aware scheme) also the working droplet and
    aerosol numbers and the vertical velocity ``w1d`` (zeros if None)."""
    aer = nc1d is not None

    t1d = th * exner
    temp = t1d
    qv = _max(1e-10, qv1d)
    pres = p1d
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))

    L_qc = qc1d > R1
    qc1d = _where(L_qc, qc1d, 0.0)
    rc = _where(L_qc, qc1d * rho, R1)

    P = {}
    if aer:
        # working aerosol numbers in m^-3 (mp_thompson_aer.f90:1649-1650)
        # and the droplet number with the mean-size clamp into
        # [D0c, 2*D0r] (:1653-1667)
        nwfa = _clip(nwfa1d * rho, 11.1e6, 9999.0e6)
        nifa = _clip(nifa1d * rho, tt.NA_IN1 * 0.01, 9999.0e6)
        nc1d = _where(L_qc, nc1d, 0.0)
        ncr = _max(2.0, nc1d * rho)
        nu_c0 = _nu_c(ncr)
        g1_0, _ = _g_ratios(nu_c0)
        lamc0 = _pow(ncr * AM_R * g1_0 / rc, c.obmr)
        xDc0 = (BM_R + nu_c0 + 1.0) / lamc0
        cce2 = BM_R + nu_c0.to(torch.float32) + 1.0
        lamc_cl = torch.where(xDc0 < D0C, _dc(cce2, D0C),
                              torch.where(xDc0 > D0R * 2.,
                                          _dc(cce2, D0R * 2.), lamc0))
        ncr = _where(L_qc, _min(tt.NT_C_MAX, rc / (AM_R * g1_0)
                                * _pow(lamc_cl, BM_R)), 2.0)
        w1d = torch.zeros_like(temp) if w1d is None else w1d
        P.update(nc1d=nc1d, ncr=ncr, nwfa=nwfa, nifa=nifa, w1d=w1d,
                 nwfa1d=nwfa1d, nifa1d=nifa1d)

    L_qi = qi1d > R1
    qi1d = _where(L_qi, qi1d, 0.0)
    ni1d = _where(L_qi, ni1d, 0.0)
    ri = _where(L_qi, qi1d * rho, R1)
    ni = _where(L_qi, _max(R2, ni1d * rho), R2)
    # clamp ice mean size into [20, 300] microns by adjusting number
    lami = _pow(AM_I * c.cig[1] * c.oig1 * ni / ri, c.obmi)
    xDi = _rd(BM_I + c.mu_i + 1.0, lami)
    lami_lo = c.cie[1] / 20e-6
    lami_hi = c.cie[1] / 300e-6
    ni_lo = _min(250e3, _dc(c.cig[0] * c.oig2 * ri, AM_I)
                 * lami_lo ** BM_I)
    ni_hi = _dc(c.cig[0] * c.oig2 * ri, AM_I) * lami_hi ** BM_I
    ni = torch.where(L_qi & (xDi < 20e-6), ni_lo,
                     torch.where(L_qi & (xDi > 300e-6), ni_hi, ni))

    L_qr = qr1d > R1
    qr1d = _where(L_qr, qr1d, 0.0)
    nr1d = _where(L_qr, nr1d, 0.0)
    rr = _where(L_qr, qr1d * rho, R1)
    nr = _where(L_qr, _max(R2, nr1d * rho), R2)
    lamr = _pow(AM_R * c.crg[2] * c.org2 * nr / rr, c.obmr)
    mvd_r = _rd(3.0 + c.mu_r + 0.672, lamr)
    mvd_clamped = _clip(mvd_r, D0R * 0.75, 2.5e-3)
    nr = torch.where(L_qr & (mvd_r != mvd_clamped),
                     _rain_nr_from_mvd(rr, mvd_clamped, c), nr)
    mvd_r = _where(L_qr, mvd_clamped, 0.0)

    L_qs = qs1d > R1
    qs1d = _where(L_qs, qs1d, 0.0)
    rs = _where(L_qs, qs1d * rho, R1)
    L_qg = qg1d > R1
    qg1d = _where(L_qg, qg1d, 0.0)
    rg = _where(L_qg, qg1d * rho, R1)

    # thermodynamics
    tempc = temp - 273.15
    rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    qvs = rslf(pres, temp)
    delQvs = _max(0.0, rslf(pres, torch.full_like(temp, 273.15)) - qv)
    qvsi = torch.where(tempc <= 0.0, rsif(pres, temp), qvs)
    satw = qv / qvs
    sati = qv / qvsi
    ssatw = _where(torch.abs(satw - 1.) < EPS, 0.0, satw - 1.)
    ssati = _where(torch.abs(sati - 1.) < EPS, 0.0, sati - 1.)

    # snow moments + graupel/rain intercepts
    smob, smo2, smo0, smo1, smoc, smod, smoe, smof = \
        _snow_moments(rs, temp, c)
    ilamg, N0_g = _graupel_intercept(rg, temp, mvd_r, L_qr, c)
    ilamr, mvd_r, N0_r = _rain_slope(rr, nr, c)

    zero = torch.zeros_like(temp)

    # cloud-droplet size distribution (mp_thompson.f90:1500-1511; aer
    # :1955-1980, the droplet number's)
    if aer:
        nu_cw = _nu_c(ncr)
        g1w, g2w = _g_ratios(nu_cw)
        xDc = _max(D0C * 1e6, _pow(rc / (AM_R * ncr), c.obmr) * 1e6)
        lamc = _pow(ncr * AM_R * g1w / rc, c.obmr)
        mvd_c = _where(L_qc, (3.0 + nu_cw + 0.672) / lamc, D0C)
        Dc_g = (_pow(g2w, c.obmr) / lamc) * 1e6
        P.update(nu_cw=nu_cw)
    else:
        xDc = _max(D0C * 1e6, _pow(_dc(rc, AM_R * pp.Nt_c), c.obmr) * 1e6)
        lamc = _pow(_rd(pp.Nt_c * AM_R * c.ccg[1] * c.ocg1, rc), c.obmr)
        mvd_c = _where(L_qc, _rd(3.0 + c.mu_c + 0.672, lamc), D0C)
        Dc_g = _rd((c.ccg[2] * c.ocg2) ** c.obmr, lamc) * 1e6
    # mean snow size for the snow-cloud collection efficiency index
    xDs = _where(L_qs, smoc / _max(smob, R1), 0.0)

    return dict(
        P,
        t1d=t1d, temp=temp, tempc=tempc, qv=qv, pres=pres, rho=rho,
        rhof=rhof, rhof2=rhof2, diffu=diffu, visco=visco, ocp=ocp,
        vsc2=vsc2, lvap=lvap, tcond=tcond, qvs=qvs, delQvs=delQvs,
        qvsi=qvsi, ssatw=ssatw, ssati=ssati,
        L_qc=L_qc, qc1d=qc1d, rc=rc,
        L_qi=L_qi, qi1d=qi1d, ni1d=ni1d, ri=ri, ni=ni,
        L_qr=L_qr, qr1d=qr1d, nr1d=nr1d, rr=rr, nr=nr, mvd_r=mvd_r,
        L_qs=L_qs, qs1d=qs1d, rs=rs, L_qg=L_qg, qg1d=qg1d, rg=rg,
        smob=smob, smo2=smo2, smo0=smo0, smo1=smo1, smoc=smoc, smod=smod,
        smoe=smoe, smof=smof, ilamg=ilamg, N0_g=N0_g, ilamr=ilamr,
        N0_r=N0_r, zero=zero, xDc=xDc, mvd_c=mvd_c, Dc_g=Dc_g, xDs=xDs,
        qv1d=qv1d, exner=exner)


def _small_indices(P, c):
    """Bins of the small 2D tables (collision efficiencies, cloud-water
    freezing, ice autoconversion/deposition)."""
    rc, ri, ni, tempc = P["rc"], P["ri"], P["ni"], P["tempc"]
    idx_tc = torch.clamp(_nint(-tempc), 1, 45) - 1
    zero = torch.zeros_like(idx_tc)
    idx_c = torch.where(rc > tt.r_c[0], _mantissa_idx(rc, c.nic2, NTB_C),
                        zero)
    idx_i = torch.where(ri > tt.r_i[0], _mantissa_idx(ri, c.nii2, NTB_I),
                        zero)
    idx_i1 = torch.where(ni > tt.Nt_i[0],
                         _mantissa_idx(ni, c.nii3, NTB_I1), zero)
    # collision-efficiency bins (rain/cloud, snow/cloud)
    idx_efr = torch.clamp(
        _dc(NBR * pw.log(_dc(P["mvd_r"], tt.D0R)),
            np.log(float(c.Dr[-1] / c.Dr[0]))).to(torch.int32),
        0, NBR - 1)
    idx_efc = torch.clamp((P["mvd_c"] * 1e6).to(torch.int32) - 1, 0,
                          NBC - 1)
    idx_efs = torch.clamp(
        _dc(NBS * pw.log(_dc(_max(P["xDs"], D0S), tt.D0S)),
            np.log(float(c.Ds[-1] / c.Ds[0]))).to(torch.int32), 0, NBS - 1)
    return dict(idx_tc=idx_tc, idx_c=idx_c, idx_i=idx_i, idx_i1=idx_i1,
                idx_efr=idx_efr, idx_efc=idx_efc, idx_efs=idx_efs)


def _index_block(P, c):
    """Lookup-table bins (mp_thompson.f90:1560-1736): decimal mantissa bins
    for the mixing-ratio tables, temperature bins, and the log-spaced
    collision-efficiency bins."""
    rr, rs, rg, tempc = P["rr"], P["rs"], P["rg"], P["tempc"]
    ilamr, ilamg = P["ilamr"], P["ilamg"]

    idx_t_raw = torch.trunc(_dc(tempc - 2.5, 5.0)).to(torch.int32) - 1
    idx_t = torch.clamp(torch.clamp(-idx_t_raw, min=1), 1, NTB_T) - 1
    has_r = rr > tt.r_r[0]
    zero = torch.zeros_like(idx_t)
    idx_r = torch.where(has_r, _mantissa_idx(rr, c.nir2, NTB_R), zero)
    lam_exp_r = (1.0 / ilamr) * (c.crg[2] * c.org2 * c.org1) ** BM_R
    N0_exp_r = _dc(c.org1 * rr, AM_R) * _pow(lam_exp_r, c.cre[0])
    idx_r1 = torch.where(has_r, _mantissa_idx(N0_exp_r, c.nir3, NTB_R1),
                         zero + (NTB_R1 - 1))
    idx_s = torch.where(rs > tt.r_s[0], _mantissa_idx(rs, c.nis2, NTB_S),
                        zero)
    has_g = rg > tt.r_g[0]
    idx_g = torch.where(has_g, _mantissa_idx(rg, c.nig2, tt.NTB_G), zero)
    lam_exp_g = (1.0 / ilamg) * (c.cgg[2] * c.ogg2 * c.ogg1) ** BM_G
    N0_exp_g = _dc(c.ogg1 * rg, c.am_g) * _pow(lam_exp_g, c.cge[0])
    idx_g1 = torch.where(has_g, _mantissa_idx(N0_exp_g, c.nig3, NTB_G1),
                         zero + (NTB_G1 - 1))
    return dict(idx_t=idx_t, idx_r=idx_r, idx_r1=idx_r1, idx_s=idx_s,
                idx_g=idx_g, idx_g1=idx_g1, **_small_indices(P, c))


def _lookup(tabs, I):
    """Every table value the core consumes, by direct indexing: {table
    name: field}. The big stacks are bfloat16, widened to float32."""
    G = {}
    for gname, names, idxs, dims in (
            ("racs", _RACS_NAMES, ("idx_s", "idx_t", "idx_r1", "idx_r"),
             (NTB_S, NTB_T, NTB_R1, NTB_R)),
            ("racg", _RACG_NAMES, ("idx_g1", "idx_g", "idx_r1", "idx_r"),
             (NTB_G1, tt.NTB_G, NTB_R1, NTB_R)),
            ("qrfz", _QRFZ_NAMES, ("idx_r", "idx_r1", "idx_tc"),
             (NTB_R, NTB_R1, 45))):
        lin = I[idxs[0]].long()
        for d, ix in zip(dims[1:], idxs[1:]):
            lin = lin * d + I[ix].long()
        vals = tabs[gname][:, lin].float()
        G.update({n: vals[i] for i, n in enumerate(names)})
    for gname, names, ia, ib in (
            ("efrw", ("t_Efrw",), "idx_efr", "idx_efc"),
            ("efsw", ("t_Efsw",), "idx_efs", "idx_efc"),
            ("qcfz", _QCFZ_NAMES, "idx_c", "idx_tc"),
            ("iaus", _IAUS_NAMES, "idx_i", "idx_i1")):
        tab = tabs[gname]
        a, b = I[ia].long(), I[ib].long()
        G.update({n: tab[i][a, b] for i, n in enumerate(names)})
    return G


def _core_block(P, idx_i, G, DT, c, pp, tnc_wev=None):
    """Process rates, conservation scalings, tendencies, the TAU+1 update,
    cloud condensation/evaporation, rain evaporation and terminal
    velocities (mp_thompson.f90:1496-2655). ``G`` maps table names to their
    looked-up values; ``idx_i`` is the ice bin (the large-ice
    autoconversion branch reads it). ``DT`` is a float32 value. With a
    prep dict of the aerosol-aware scheme (``ncr`` in P) also the droplet
    and aerosol tendencies; ``tnc_wev`` is then the flattened
    droplet-evaporation table (``device_tnc_wev``)."""
    aer = "ncr" in P
    odt = _f32(np.float32(1.0) / np.float32(DT))
    odts = odt

    (t1d, temp, tempc, qv, pres, rho, rhof, rhof2, diffu, visco, ocp,
     vsc2, lvap, tcond, qvs, delQvs, qvsi, ssatw, ssati) = (
        P["t1d"], P["temp"], P["tempc"], P["qv"], P["pres"], P["rho"],
        P["rhof"], P["rhof2"], P["diffu"], P["visco"], P["ocp"], P["vsc2"],
        P["lvap"], P["tcond"], P["qvs"], P["delQvs"], P["qvsi"],
        P["ssatw"], P["ssati"])
    (L_qc, qc1d, rc, L_qi, qi1d, ni1d, ri, ni, L_qr, qr1d, nr1d, rr, nr,
     mvd_r, L_qs, qs1d, rs, L_qg, qg1d, rg) = (
        P["L_qc"], P["qc1d"], P["rc"], P["L_qi"], P["qi1d"], P["ni1d"],
        P["ri"], P["ni"], P["L_qr"], P["qr1d"], P["nr1d"], P["rr"],
        P["nr"], P["mvd_r"], P["L_qs"], P["qs1d"], P["rs"], P["L_qg"],
        P["qg1d"], P["rg"])
    (smob, smo2, smo0, smo1, smoc, smod, smoe, smof, ilamg, N0_g, ilamr,
     N0_r, zero, qv1d) = (
        P["smob"], P["smo2"], P["smo0"], P["smo1"], P["smoc"], P["smod"],
        P["smoe"], P["smof"], P["ilamg"], P["N0_g"], P["ilamr"],
        P["N0_r"], P["zero"], P["qv1d"])
    if aer:
        nc1d, ncr, nwfa, nifa, nwfa1d = (P["nc1d"], P["ncr"], P["nwfa"],
                                         P["nifa"], P["nwfa1d"])
        nu_cw = P["nu_cw"]

    # ---- warm-rain processes (mp_thompson.f90:1496-1545) ---------------
    Ef_rr = 2.0 - pw.exp(_min(2300.0 * (mvd_r - 1600.0e-6), 50.0))
    pnr_rcr = _where(L_qr & (mvd_r > D0R), Ef_rr * 4. * nr * rr, 0.0)

    xDc, mvd_c, Dc_g = P["xDc"], P["mvd_c"], P["Dc_g"]
    Dc_b = _pow(_max(xDc ** 3 * Dc_g ** 3 - _ipow(xDc, 6), 0.0), 1.0 / 6.0)
    zeta1 = _max(6.25e-6 * xDc * Dc_b ** 3 - 0.4, 0.0)
    zeta = 0.027 * rc * zeta1
    taud = _max(0.5 * Dc_b - 7.5, 0.0) + R1
    tau = _rd(3.72, rc * taud)
    wau_on = L_qc & (rc > 0.01e-3)
    prr_wau = _where(wau_on, _min(rc * odts, zeta / tau), 0.0)
    if aer:
        pnr_wau = prr_wau / (AM_R * nu_cw * D0R ** 3)
        # droplet number lost to autoconversion (mp_thompson_aer.f90:
        # 1978-1979)
        pnc_wau = _where(wau_on, torch.minimum(
            ncr * odts, prr_wau / (AM_R * _ipow(mvd_c, 3))), 0.0)
    else:
        pnr_wau = _dc(prr_wau, AM_R * c.mu_c * D0R ** 3)

    # rain collecting cloud water
    Ef_rw = G["t_Efrw"]
    rcw_on = L_qc & L_qr & (mvd_r > D0R) & (mvd_c > D0C)
    prr_rcw = _where(
        rcw_on,
        _min(rc * odts,
             rhof * c.t1_qr_qc * Ef_rw * rc * N0_r
             * _pow(1.0 / ilamr + FV_R, -c.cre[8])), 0.0)
    if aer:
        # droplet number collected by rain (mp_thompson_aer.f90:1991-1993)
        pnc_rcw = _where(rcw_on, torch.minimum(
            ncr * odts, rhof * c.t1_qr_qc * Ef_rw * ncr * N0_r
            * _pow(1.0 / ilamr + FV_R, -c.cre[8])), 0.0)
        # wet scavenging of aerosols by rain (:1997-2008)
        rca_on = L_qr & (mvd_r > D0R)
        vt_mvd = _vr_poly(mvd_r)
        Ef_ra_w = _eff_aero(mvd_r, 0.04e-6, visco, rho, temp, vt_mvd)
        pna_rca = _where(rca_on, torch.minimum(
            nwfa * odts, rhof * c.t1_qr_qc * Ef_ra_w * nwfa * N0_r
            * _pow(1.0 / ilamr + FV_R, -c.cre[8])), 0.0)
        Ef_ra_d = _eff_aero(mvd_r, 0.8e-6, visco, rho, temp, vt_mvd)
        pnd_rcd = _where(rca_on, torch.minimum(
            nifa * odts, rhof * c.t1_qr_qc * Ef_ra_d * nifa * N0_r
            * _pow(1.0 / ilamr + FV_R, -c.cre[8])), 0.0)

    # deposition/sublimation prefactor (Srivastava & Coen 1992)
    otemp = 1.0 / temp
    rvs = rho * qvsi
    rvs_p = rvs * otemp * (LSUB * otemp * ORV - 1.)
    rvs_pp = rvs * (otemp * (LSUB * otemp * ORV - 1.)
                    * otemp * (LSUB * otemp * ORV - 1.)
                    + (-2. * LSUB * otemp ** 3 * ORV) + otemp * otemp)
    gamsc = LSUB * diffu / tcond * rvs_p
    alphsc = _max(1e-9, 0.5 * (gamsc / (1. + gamsc)) ** 2
                  * rvs_pp / rvs_p * rvs / rvs_p)
    xsat = _where(torch.abs(ssati) < 1e-9, 0.0, ssati)
    t1_subl = 4. * PI * (1.0 - alphsc * xsat + 2. * alphsc ** 2 * xsat ** 2
                         - 5. * alphsc ** 3 * xsat ** 3) / (1. + gamsc)

    # snow/graupel collecting cloud water (mp_thompson.f90:1705-1736)
    xDs = P["xDs"]
    Ef_sw = G["t_Efsw"]
    scw_on = L_qc & (mvd_c > D0C) & (xDs > D0S)
    prs_scw = _where(scw_on, rhof * c.t1_qs_qc * Ef_sw * rc * smoe, 0.0)

    xDg = (BM_G + c.mu_g + 1.) * ilamg
    vtg_c = rhof * pp.av_g * c.cgg[5] * c.ogg3 * _pow(ilamg, pp.bv_g)
    stoke_g = mvd_c * mvd_c * vtg_c * RHO_W / (9. * visco * xDg)
    Ef_gw = torch.where(stoke_g >= 0.4,
                        _where(stoke_g <= 10.0,
                               0.55 * pw.log10(2.51 * stoke_g), 0.77),
                        zero)
    gcw_on = (L_qc & (mvd_c > D0C) & (rg >= tt.r_g[0]) & (xDg > D0G))
    prg_gcw = _where(gcw_on, rhof * c.t1_qg_qc * Ef_gw * rc * N0_g
                     * _pow(ilamg, c.cge[8]), 0.0)
    if aer:
        # droplet number collected by snow and graupel (mp_thompson_aer.
        # f90:2177-2198)
        pnc_scw = _where(scw_on, torch.minimum(
            ncr * odts, rhof * c.t1_qs_qc * Ef_sw * ncr * smoe), 0.0)
        pnc_gcw = _where(gcw_on, torch.minimum(
            ncr * odts, rhof * c.t1_qg_qc * Ef_gw * ncr * N0_g
            * _pow(ilamg, c.cge[8])), 0.0)
        # wet scavenging by snow and graupel (:2203-2226)
        sca_on = rs > tt.r_s[0]
        xDs_a = smoc / _max(smob, R1)
        vts_a = pp.av_s * _pow(xDs_a, pp.bv_s)
        pna_sca = _where(sca_on, torch.minimum(
            nwfa * odts, rhof * c.t1_qs_qc
            * _eff_aero(xDs_a, 0.04e-6, visco, rho, temp, vts_a) * nwfa
            * smoe), 0.0)
        pnd_scd = _where(sca_on, torch.minimum(
            nifa * odts, rhof * c.t1_qs_qc
            * _eff_aero(xDs_a, 0.8e-6, visco, rho, temp, vts_a) * nifa
            * smoe), 0.0)
        gca_on = rg > tt.r_g[0]
        vtg_a = pp.av_g * _pow(xDg, pp.bv_g)
        pna_gca = _where(gca_on, torch.minimum(
            nwfa * odts, rhof * c.t1_qg_qc
            * _eff_aero(xDg, 0.04e-6, visco, rho, temp, vtg_a) * nwfa * N0_g
            * _pow(ilamg, c.cge[8])), 0.0)
        pnd_gcd = _where(gca_on, torch.minimum(
            nifa * odts, rhof * c.t1_qg_qc
            * _eff_aero(xDg, 0.8e-6, visco, rho, temp, vtg_a) * nifa * N0_g
            * _pow(ilamg, c.cge[8])), 0.0)

    # ---- rain collecting snow / graupel via lookup tables --------------
    rs_on = (rr >= tt.r_r[0]) & (rs >= tt.r_s[0])
    cold = temp < T_0
    racs1, racs2 = G["tcs_racs1"], G["tcs_racs2"]
    mracs1, mracs2 = G["tmr_racs1"], G["tmr_racs2"]
    sacr1, sacr2 = G["tcr_sacr1"], G["tcr_sacr2"]
    msacr1, msacr2 = G["tms_sacr1"], G["tms_sacr2"]
    nracs1, nracs2 = G["tnr_racs1"], G["tnr_racs2"]
    nsacr1, nsacr2 = G["tnr_sacr1"], G["tnr_sacr2"]

    prr_rcs_c = torch.maximum(-rr * odts,
                              -(mracs2 + sacr2 + mracs1 + sacr1))
    prs_rcs_c = torch.maximum(-rs * odts, mracs2 + sacr2 - racs1 - msacr1)
    prg_rcs_c = torch.minimum((rr + rs) * odts,
                              mracs1 + sacr1 + racs1 + msacr1)
    pnr_rcs_c = nracs1 + nracs2 + nsacr1 + nsacr2
    prs_rcs_w = torch.maximum(-rs * odts, -racs1 - msacr1 + mracs2 + sacr2)
    prr_rcs_w = -prs_rcs_w
    pnr_rcs_w = nracs2 + nsacr2
    prr_rcs = torch.where(rs_on, torch.where(cold, prr_rcs_c, prr_rcs_w),
                          zero)
    prs_rcs = torch.where(rs_on, torch.where(cold, prs_rcs_c, prs_rcs_w),
                          zero)
    prg_rcs = torch.where(rs_on & cold, prg_rcs_c, zero)
    pnr_rcs = torch.where(rs_on, torch.minimum(
        nr * odts, torch.where(cold, pnr_rcs_c, pnr_rcs_w)), zero)

    rg_on = (rr >= tt.r_r[0]) & (rg >= tt.r_g[0])
    prg_rcg_c = torch.minimum(rr * odts, G["tmr_racg"] + G["tcr_gacr"])
    pnr_rcg_c = torch.minimum(nr * odts, G["tnr_racg"] + G["tnr_gacr"])
    prr_rcg_w = torch.minimum(rg * odts, G["tcg_racg"])
    prg_rcg = torch.where(rg_on, torch.where(cold, prg_rcg_c, -prr_rcg_w),
                          zero)
    prr_rcg = torch.where(rg_on, torch.where(cold, -prg_rcg_c, prr_rcg_w),
                          zero)
    pnr_rcg = torch.where(rg_on & cold, pnr_rcg_c, zero)

    # ---- processes below 0C (mp_thompson.f90:1789-1955) ----------------
    rate_max_i = (qv - qvsi) * rho * odts * 0.999

    frz_tab = rr > tt.r_r[0]
    frz_h = (rr > R1) & (temp < HGFR)
    prg_rfz = torch.where(cold & frz_tab, G["tpg_qrfz"] * odts, zero)
    pri_rfz = torch.where(
        cold, torch.where(frz_tab, G["tpi_qrfz"] * odts,
                          torch.where(frz_h, rr * odts, zero)), zero)
    pni_rfz = torch.where(
        cold, torch.where(frz_tab, G["tni_qrfz"] * odts,
                          torch.where(frz_h, nr * odts, zero)), zero)
    pnr_rfz = torch.where(
        cold & frz_tab,
        torch.minimum(nr * odts, G["tnr_qrfz"] * odts),
        torch.where(cold & frz_h, nr * odts, zero))

    wfz_tab = rc > tt.r_c[0]
    pri_wfz = torch.where(
        cold, torch.where(wfz_tab,
                          torch.minimum(rc * odts, G["tpi_qcfz"] * odts),
                          torch.where((rc > R1) & (temp < HGFR),
                                      rc * odts, zero)), zero)
    if aer:
        pni_wfz = torch.where(
            cold & wfz_tab,
            torch.minimum(torch.minimum(ncr * odts,
                                        _dc(pri_wfz, 2. * XM0I)),
                          G["tni_qcfz"] * odts), zero)
    else:
        pni_wfz = torch.where(
            cold & wfz_tab,
            torch.minimum(_min(_dc(pri_wfz, 2. * XM0I),
                               _f32(np.float32(pp.Nt_c)
                                    * np.float32(odts))),
                          G["tni_qcfz"] * odts), zero)

    # ice nucleation: Cooper (1986), or DeMott (2010) from nifa when
    # aerosol-aware (mp_thompson_aer.f90:2355-2366)
    if aer:
        nuc_on = cold & ((ssati >= 0.25)
                         | ((ssatw > EPS) & (temp < 253.15)))
        xnc = _ice_demott(tempc, rho, nifa)
    else:
        nuc_on = cold & ((ssati >= 0.25)
                         | ((ssatw > EPS) & (temp < 261.15)))
        xnc = _min(250e3, pp.TNO * pw.exp(ATO * (T_0 - temp)))
    xni_c = ni + (pni_rfz + pni_wfz) * DT
    pni_inu = torch.where(nuc_on, _max(0.0, xnc - xni_c) * odts, zero)
    pri_inu = torch.where(nuc_on, torch.minimum(rate_max_i,
                                                XM0I * pni_inu), zero)
    pni_inu = _dc(pri_inu, XM0I)
    if aer:
        # homogeneous freezing of deliquesced aerosols, Koop et al. (2001)
        # (mp_thompson_aer.f90:2369-2377)
        xni_k = smo0 + ni + (pni_rfz + pni_wfz + pni_inu) * DT
        koop_on = (xni_k <= 500e3) & (temp < 238.0) & (ssati >= 0.4)
        xnc_k = _ice_koop(temp, qv, qvs, nwfa, DT)
        pni_iha = torch.where(koop_on, xnc_k * odts, zero)
        pri_iha = torch.where(koop_on, torch.minimum(
            rate_max_i, XM0I * 0.1 * pni_iha), zero)
        pni_iha = _dc(pri_iha, XM0I * 0.1)
    else:
        pni_iha = zero
        pri_iha = zero

    # ice deposition / sublimation
    lami = _pow(AM_I * c.cig[1] * c.oig1 * ni / ri, c.obmi)
    ilami = 1.0 / lami
    xDi = _max(_f32(c.D0i), (BM_I + c.mu_i + 1.0) * ilami)
    xmi = AM_I * _pow(xDi, BM_I)
    oxmi = 1.0 / xmi
    ide_raw = C_CUBE * t1_subl * diffu * ssati * rvs \
        * c.oig1 * c.cig[4] * ni * ilami
    tpi_ide = G["tpi_ide"]
    ide_on = cold & L_qi
    pri_ide_neg = torch.maximum(torch.maximum(-ri * odts, ide_raw),
                                rate_max_i)
    pni_ide = torch.where(ide_on & (ide_raw < 0.0),
                          torch.maximum(-ni * odts, pri_ide_neg * oxmi),
                          zero)
    pri_ide_pos = torch.minimum(ide_raw, rate_max_i)
    prs_ide = torch.where(ide_on & (ide_raw >= 0.0),
                          (1.0 - tpi_ide) * pri_ide_pos, zero)
    pri_ide = torch.where(ide_on,
                          torch.where(ide_raw < 0.0, pri_ide_neg,
                                      tpi_ide * pri_ide_pos), zero)

    # ice -> snow autoconversion via bin table
    iau_big = (idx_i == NTB_I - 1) | (xDi > 5.0 * D0S)
    iau_none = xDi < 0.1 * D0S
    prs_iau = torch.where(
        ide_on,
        torch.where(iau_big, ri * .99 * odts,
                    torch.where(iau_none, zero,
                                torch.minimum(ri * .99 * odts,
                                              G["tps_iaus"] * odts))), zero)
    pni_iau = torch.where(
        ide_on,
        torch.where(iau_big, ni * .95 * odts,
                    torch.where(iau_none, zero,
                                torch.minimum(ni * .95 * odts,
                                              G["tni_iaus"] * odts))), zero)

    # snow deposition / sublimation
    C_snow = _clip(pp.C_sqrd + _dc((tempc + 15.) * (pp.C_cubes - pp.C_sqrd),
                                   -30. + 15.),
                   min(pp.C_sqrd, pp.C_cubes), max(pp.C_sqrd, pp.C_cubes))
    sde_raw = C_snow * t1_subl * diffu * ssati * rvs \
        * (c.t1_qs_sd * smo1 + c.t2_qs_sd * rhof2 * vsc2 * smof)
    prs_sde_c = torch.where(sde_raw < 0.0,
                            torch.maximum(torch.maximum(-rs * odts, sde_raw),
                                          rate_max_i),
                            torch.minimum(sde_raw, rate_max_i))
    prs_sde = torch.where(cold & L_qs, prs_sde_c, zero)

    gde_raw = C_CUBE * t1_subl * diffu * ssati * rvs \
        * N0_g * (c.t1_qg_sd * _pow(ilamg, c.cge[9])
                  + c.t2_qg_sd * vsc2 * rhof2 * _pow(ilamg, c.cge[10]))
    prg_gde_c = torch.where(gde_raw < 0.0,
                            torch.maximum(torch.maximum(-rg * odts, gde_raw),
                                          rate_max_i),
                            torch.minimum(gde_raw, rate_max_i))
    prg_gde = torch.where(cold & L_qg & (ssati < -EPS), prg_gde_c, zero)

    # snow/rain collecting cloud ice
    sci_on = cold & L_qi & (rs >= tt.r_s[0])
    prs_sci = torch.where(sci_on, c.t1_qs_qi * rhof * pp.Ef_si * ri * smoe,
                          zero)
    pni_sci = prs_sci * oxmi
    rci_on = cold & L_qi & (rr >= tt.r_r[0]) & (mvd_r > 4. * xDi)
    lamr_c = 1.0 / ilamr
    pri_rci = torch.where(rci_on, rhof * c.t1_qr_qi * pp.Ef_ri * ri * N0_r
                          * _pow(lamr_c + FV_R, -c.cre[8]), zero)
    pnr_rci = torch.where(rci_on, rhof * c.t1_qr_qi * pp.Ef_ri * ni * N0_r
                          * _pow(lamr_c + FV_R, -c.cre[8]), zero)
    pni_rci = pri_rci * oxmi
    prr_rci = torch.where(rci_on,
                          torch.minimum(rr * odts,
                                        rhof * c.t2_qr_qi * pp.Ef_ri * ni
                                        * N0_r
                                        * _pow(lamr_c + FV_R, -c.cre[7])),
                          zero)
    prg_rci = pri_rci + prr_rci

    # Hallet-Mossop rime splintering
    tf = torch.where((tempc >= -5.0) & (tempc < -3.0), 0.5 * (-3.0 - tempc),
                     torch.where((tempc > -8.0) & (tempc < -5.0),
                                 _dc(8.0 + tempc, 3.0), zero))
    ihm_on = cold & (prg_gcw > EPS) & (tempc > -8.0)
    pni_ihm = torch.where(ihm_on, 3.5e8 * tf * prg_gcw, zero)
    pri_ihm = XM0I * pni_ihm
    denom_hm = _max(prs_scw + prg_gcw, 1e-30)
    prs_ihm = prs_scw / denom_hm * pri_ihm
    prg_ihm = prg_gcw / denom_hm * pri_ihm

    # rimed snow -> graupel conversion + fallspeed boost
    conv_on = cold & (prs_scw > 5.0 * prs_sde) & (prs_sde > EPS)
    r_frac = _min(30.0, prs_scw / _max(prs_sde, 1e-30))
    g_frac = _min(0.75, 0.05 + (r_frac - 5.) * .028)
    vts_boost = _where(cold,
                       _where(conv_on, _min(1.5, 1.1 + (r_frac - 5.) * .016),
                              1.0), 1.5)
    prg_scw = torch.where(conv_on, g_frac * prs_scw, zero)
    prs_scw = torch.where(conv_on, (1. - g_frac) * prs_scw, prs_scw)

    # ---- melting (T >= 0C; mp_thompson.f90:1957-2010) ------------------
    warm = ~cold
    sml_raw = (tempc * tcond - LVAP0 * diffu * delQvs) \
        * (c.t1_qs_me * smo1 + c.t2_qs_me * rhof2 * vsc2 * smof)
    sml = sml_raw + 4218. * OLFUS * tempc * (prr_rcs + prs_scw)
    prr_sml = torch.where(warm & L_qs,
                          torch.minimum(rs * odts, _max(0.0, sml)), zero)
    pnr_sml = torch.where(warm & L_qs,
                          torch.minimum(smo0 * odts,
                                        smo0 / _max(rs, R1) * prr_sml
                                        * pw.pow(10.0, -0.75 * tempc)), zero)
    pnr_sml = torch.where((tempc > 3.5) | (rs < 0.005e-3), zero, pnr_sml)

    sde_w = pp.C_cubes * t1_subl * diffu * ssati * rvs \
        * (c.t1_qs_sd * smo1 + c.t2_qs_sd * rhof2 * vsc2 * smof)
    prs_sde = torch.where(warm & L_qs & (ssati < 0.0),
                          torch.maximum(-rs * odts, sde_w), prs_sde)

    gml_raw = (tempc * tcond - LVAP0 * diffu * delQvs) \
        * N0_g * (c.t1_qg_me * _pow(ilamg, c.cge[9])
                  + c.t2_qg_me * rhof2 * vsc2 * _pow(ilamg, c.cge[10]))
    prr_gml = torch.where(warm & L_qg,
                          torch.minimum(rg * odts, _max(0.0, gml_raw)), zero)
    pnr_gml = torch.where(warm & L_qg,
                          N0_g * c.cgg[1] * _pow(ilamg, c.cge[1])
                          / _max(rg, R1) * prr_gml
                          * pw.pow(10.0, -1.5 * tempc), zero)
    pnr_gml = torch.where((tempc > 7.5) | (rg < 0.005e-3), zero, pnr_gml)
    prg_gde = torch.where(warm & L_qg & (ssati < 0.0),
                          torch.maximum(-rg * odts, gde_raw), prg_gde)

    # dt > 120 s: route collected cloud water to rain above freezing
    if float(DT) > 120.0:
        prr_rcw = prr_rcw + torch.where(warm, prs_scw + prg_gcw, zero)
        prs_scw = torch.where(warm, zero, prs_scw)
        prg_gcw = torch.where(warm, zero, prg_gcw)
    else:
        prr_rcw = prr_rcw + zero

    # ---- conservation scalings (mp_thompson.f90:2016-2105) -------------
    sump = pri_inu + pri_ide + prs_ide + prs_sde + prg_gde
    # the reference's cap omits rho here (mp_thompson.f90:2022), kept
    rate_max = (qv - qvsi) * odts * 0.999
    need = ((sump > EPS) & (sump > rate_max)) \
        | ((sump < -EPS) & (sump < rate_max))
    one = zero + 1.0
    rat = torch.where(need, rate_max / torch.where(sump == 0, one, sump),
                      one)
    pri_inu, pri_ide, pni_ide = pri_inu * rat, pri_ide * rat, pni_ide * rat
    prs_ide, prs_sde, prg_gde = prs_ide * rat, prs_sde * rat, prg_gde * rat

    sump = -prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw - prg_gcw
    rate_max = -rc * odts
    rat = torch.where((sump < rate_max) & L_qc,
                      rate_max / torch.where(sump == 0, one, sump), one)
    prr_wau, pri_wfz, prr_rcw = prr_wau * rat, pri_wfz * rat, prr_rcw * rat
    prs_scw, prg_scw, prg_gcw = prs_scw * rat, prg_scw * rat, prg_gcw * rat

    sump = pri_ide - prs_iau - prs_sci - pri_rci
    rate_max = -ri * odts
    rat = torch.where((sump < rate_max) & L_qi,
                      rate_max / torch.where(sump == 0, one, sump), one)
    pri_ide, prs_iau = pri_ide * rat, prs_iau * rat
    prs_sci, pri_rci = prs_sci * rat, pri_rci * rat

    sump = -prg_rfz - pri_rfz - prr_rci + prr_rcs + prr_rcg
    rate_max = -rr * odts
    rat = torch.where((sump < rate_max) & L_qr,
                      rate_max / torch.where(sump == 0, one, sump), one)
    prg_rfz, pri_rfz, prr_rci = prg_rfz * rat, pri_rfz * rat, prr_rci * rat
    prr_rcs, prr_rcg = prr_rcs * rat, prr_rcg * rat

    sump = prs_sde - prs_ihm - prr_sml + prs_rcs
    rate_max = -rs * odts
    rat = torch.where((sump < rate_max) & L_qs,
                      rate_max / torch.where(sump == 0, one, sump), one)
    prs_sde, prs_ihm = prs_sde * rat, prs_ihm * rat
    prr_sml, prs_rcs = prr_sml * rat, prs_rcs * rat

    sump = prg_gde - prg_ihm - prr_gml + prg_rcg
    rate_max = -rg * odts
    rat = torch.where((sump < rate_max) & L_qg,
                      rate_max / torch.where(sump == 0, one, sump), one)
    prg_gde, prg_ihm = prg_gde * rat, prg_ihm * rat
    prr_gml, prg_rcg = prr_gml * rat, prg_rcg * rat

    pri_ihm = prs_ihm + prg_ihm
    ratio = torch.minimum(torch.abs(prr_rcg), torch.abs(prg_rcg))
    prr_rcg = ratio * torch.sign(prr_rcg)
    prg_rcg = -prr_rcg
    ratio = torch.minimum(torch.abs(prr_rcs), torch.abs(prs_rcs))
    prr_rcs = torch.where(warm, ratio * torch.sign(prr_rcs), prr_rcs)
    prs_rcs = torch.where(warm, -prr_rcs, prs_rcs)

    # ---- tendencies (mp_thompson.f90:2110-2240) ------------------------
    orho = 1.0 / rho
    lfus2 = LSUB - lvap
    qvten = (-pri_inu - pri_iha - pri_ide - prs_ide - prs_sde
             - prg_gde) * orho
    qcten = (-prr_wau - pri_wfz - prr_rcw - prs_scw - prg_scw
             - prg_gcw) * orho
    qiten = (pri_inu + pri_iha + pri_ihm + pri_wfz + pri_rfz + pri_ide
             - prs_iau - prs_sci - pri_rci) * orho
    niten = (pni_inu + pni_iha + pni_ihm + pni_wfz + pni_rfz + pni_ide
             - pni_iau - pni_sci - pni_rci) * orho

    if aer:
        # aerosol number tendencies: wet scavenging and nucleation sinks
        # (mp_thompson_aer.f90:2664-2674)
        nwfaten = -(pna_rca + pna_sca + pna_gca + pni_iha) * orho
        nifaten = -(pnd_rcd + pnd_scd + pnd_gcd + pni_inu) * orho
        # droplet number tendency and the balance keeping the mean size in
        # [D0c, 2*D0r] and at most Nt_c_max drops (:2687-2716)
        ncten = (-pnc_wau - pnc_rcw - pni_wfz - pnc_scw - pnc_gcw) * orho
        xrc_b = _max(R1, (qc1d + qcten * DT) * rho)
        xnc_b = _max(2.0, (nc1d + ncten * DT) * rho)
        nu_cb = _nu_c(xnc_b)
        g1b, _ = _g_ratios(nu_cb)
        lamc_b = _pow(xnc_b * AM_R * g1b / rc, c.obmr)
        xDc_b = (BM_R + nu_cb + 1.0) / lamc_b
        cce2b = BM_R + nu_cb.to(torch.float32) + 1.0
        lamc_cl = torch.where(xDc_b < D0C, _dc(cce2b, D0C),
                              _dc(cce2b, D0R * 2.))
        xnc_cl = xrc_b / (AM_R * g1b) * _pow(lamc_cl, BM_R)
        ncten = torch.where(
            xrc_b > R1,
            torch.where((xDc_b < D0C) | (xDc_b > D0R * 2.),
                        (xnc_cl - nc1d * rho) * odts * orho, ncten),
            -nc1d * odts)
        xnc_b = _max(0.0, (nc1d + ncten * DT) * rho)
        ncten = torch.where(xnc_b > tt.NT_C_MAX,
                            (tt.NT_C_MAX - nc1d * rho) * odts * orho, ncten)

    # ice number/mass balance
    xri = _max(R1, (qi1d + qiten * DT) * rho)
    xni = _max(R2, (ni1d + niten * DT) * rho)
    lami = _pow(AM_I * c.cig[1] * c.oig1 * xni / xri, c.obmi)
    xDi = _rd(BM_I + c.mu_i + 1.0, lami)
    xni_lo = _min(250e3, _dc(c.cig[0] * c.oig2 * xri, AM_I)
                  * (c.cie[1] / 20e-6) ** BM_I)
    xni_hi = _dc(c.cig[0] * c.oig2 * xri, AM_I) * (c.cie[1] / 300e-6) ** BM_I
    niten = torch.where(xri > R1,
                        torch.where(xDi < 20e-6,
                                    (xni_lo - ni1d * rho) * odts * orho,
                                    torch.where(xDi > 300e-6,
                                                (xni_hi - ni1d * rho) * odts
                                                * orho, niten)),
                        -ni1d * odts)
    xni = _max(0.0, (ni1d + niten * DT) * rho)
    niten = torch.where(xni > 250e3, (250e3 - ni1d * rho) * odts * orho,
                        niten)

    qrten = (prr_wau + prr_rcw + prr_sml + prr_gml + prr_rcs + prr_rcg
             - prg_rfz - pri_rfz - prr_rci) * orho
    nrten = (pnr_wau + pnr_sml + pnr_gml
             - (pnr_rfz + pnr_rcr + pnr_rcg + pnr_rcs + pnr_rci)) * orho

    # rain number/mass balance
    xrr = _max(R1, (qr1d + qrten * DT) * rho)
    xnr = _max(R2, (nr1d + nrten * DT) * rho)
    lamr_b = _pow(AM_R * c.crg[2] * c.org2 * xnr / xrr, c.obmr)
    mvd_b = _rd(3.0 + c.mu_r + 0.672, lamr_b)
    mvd_cl = _clip(mvd_b, D0R * 0.75, 2.5e-3)
    xnr_cl = _rain_nr_from_mvd(xrr, mvd_cl, c)
    nrten = torch.where(xrr > R1,
                        torch.where(mvd_b != mvd_cl,
                                    (xnr_cl - nr1d * rho) * odts * orho,
                                    nrten),
                        -nr1d * odts)
    qrten = torch.where(xrr > R1, qrten, -qr1d * odts)

    qsten = (prs_iau + prs_sde + prs_sci + prs_scw + prs_rcs + prs_ide
             - prs_ihm - prr_sml) * orho
    qgten = (prg_scw + prg_rfz + prg_gde + prg_rcg + prg_gcw + prg_rci
             + prg_rcs - prg_ihm - prr_gml) * orho

    tten = torch.where(
        cold,
        (LSUB * ocp * (pri_inu + pri_iha + pri_ide + prs_ide + prs_sde
                       + prg_gde)
         + lfus2 * ocp * (pri_wfz + pri_rfz + prg_rfz + prs_scw + prg_scw
                          + prg_gcw + prg_rcs + prs_rcs + prr_rci
                          + prg_rcg)) * orho,
        (LFUS * ocp * (-prr_sml - prr_gml - prr_rcg - prr_rcs)
         + LSUB * ocp * (prs_sde + prg_gde)) * orho)

    # ---- update to TAU+1 (mp_thompson.f90:2245-2330) -------------------
    temp = t1d + DT * tten
    qv = _max(1e-10, qv1d + DT * qvten)
    rho, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    tempc = temp - 273.15
    otemp = 1.0 / temp
    qvs = rslf(pres, temp)
    ssatw = qv / qvs - 1.0
    ssatw = _where(torch.abs(ssatw) < EPS, 0.0, ssatw)
    lvt2 = lvap * lvap * ocp * ORV * otemp * otemp

    L_qc = (qc1d + qcten * DT) > R1
    rc = _where(L_qc, (qc1d + qcten * DT) * rho, R1)
    L_qi = (qi1d + qiten * DT) > R1
    ri = _where(L_qi, (qi1d + qiten * DT) * rho, R1)
    ni = _where(L_qi, _max(R2, (ni1d + niten * DT) * rho), R2)
    L_qr = (qr1d + qrten * DT) > R1
    rr = _where(L_qr, (qr1d + qrten * DT) * rho, R1)
    nr = _where(L_qr, _max(R2, (nr1d + nrten * DT) * rho), R2)
    lamr_u = _pow(AM_R * c.crg[2] * c.org2 * nr / rr, c.obmr)
    mvd_u = _rd(3.0 + c.mu_r + 0.672, lamr_u)
    mvd_ucl = _clip(mvd_u, D0R * 0.75, 2.5e-3)
    nr = torch.where(L_qr & (mvd_u != mvd_ucl),
                     _rain_nr_from_mvd(rr, mvd_ucl, c), nr)
    mvd_r = _where(L_qr, mvd_ucl, 0.0)
    L_qs = (qs1d + qsten * DT) > R1
    rs = _where(L_qs, (qs1d + qsten * DT) * rho, R1)
    L_qg = (qg1d + qgten * DT) > R1
    rg = _where(L_qg, (qg1d + qgten * DT) * rho, R1)

    smob, smo2, smo0, smo1, smoc, smod, smoe, smof = \
        _snow_moments(rs, temp, c)
    ilamg, N0_g = _graupel_intercept(rg, temp, mvd_r, L_qr, c)
    ilamr, mvd_r, N0_r = _rain_slope(rr, nr, c)
    if aer:
        ncr = _max(2.0, (nc1d + ncten * DT) * rho)
        nwfa = _max(11.1e6, (nwfa1d + nwfaten * DT) * rho)

    # ---- cloud water condensation/evaporation (Newton-Raphson) ---------
    cond_on = (ssatw > EPS) | ((ssatw < -EPS) & L_qc)
    clap = (qv - qvs) / (1. + lvt2 * qvs)
    for _ in range(3):
        fcd = qvs * pw.exp(lvt2 * clap) - qv + clap
        dfcd = qvs * lvt2 * pw.exp(lvt2 * clap) + 1.
        clap = clap - fcd / dfcd
    xrc = rc + clap
    prw_vcd = torch.where(cond_on,
                          torch.where(xrc > 0.0, clap * odt,
                                      -rc / rho * odts), zero)
    if aer:
        # droplet activation during condensation: the reference's
        # activation table is never read (mp_thompson_aer.f90:956-971), so
        # every aerosol of nwfa activates (:3026-3034)
        activating = cond_on & (xrc > 0.0) & (clap > EPS)
        xnc_a = _max(2.0, nwfa)
        pnc_wcd = torch.where(activating,
                              _max(0.0, xnc_a - ncr) * odts * orho, zero)
        # droplet evaporation: the drops smaller than D*, from the tnc_wev
        # table (:3037-3092)
        evap_on = (cond_on & (xrc > 0.0) & (clap < -EPS)
                   & (ssatw < -1e-6))
        otemp_c = 1.0 / temp
        rvs_c = rho * qvs
        rvs_p_c = rvs_c * otemp_c * (lvap * otemp_c * ORV - 1.)
        rvs_pp_c = rvs_c * (otemp_c * (lvap * otemp_c * ORV - 1.)
                            * otemp_c * (lvap * otemp_c * ORV - 1.)
                            + (-2. * lvap * otemp_c ** 3 * ORV)
                            + otemp_c * otemp_c)
        gamsc_c = lvap * diffu / tcond * rvs_p_c
        alphsc_c = _max(1e-9, 0.5 * (gamsc_c / (1. + gamsc_c)) ** 2
                        * rvs_pp_c / rvs_p_c * rvs_c / rvs_p_c)
        xsat_c = _where(torch.abs(ssatw) < 1e-9, 0.0, ssatw)
        t1_ev = 2. * PI * (1.0 - alphsc_c * xsat_c
                           + 2. * alphsc_c ** 2 * xsat_c ** 2
                           - 5. * alphsc_c ** 3 * xsat_c ** 3) \
            / (1. + gamsc_c)
        Dc_star = torch.sqrt(_max(
            0.0, _dc(_dc(-2.0 * DT * t1_ev, 2. * PI) * 4. * diffu * ssatw
                     * rvs_c, RHO_W)))
        idx_d = torch.clamp((1e6 * Dc_star).to(torch.int32), 1, NBC) - 1
        idx_n = torch.clamp(_nint(1.0 + _dc(
            NBC * pw.log(_dc(ncr, tt.t_Nc[0])), tt.NIC1)), 1, NBC) - 1
        idx_c2 = torch.where(rc > tt.r_c[0],
                             _mantissa_idx(rc, c.nic2, NTB_C),
                             torch.zeros_like(idx_d))
        flat_idx = (idx_d * NTB_C + idx_c2) * NBC + idx_n
        tnc = tnc_wev[flat_idx.long()]
        pnc_wcd = torch.where(
            evap_on,
            torch.maximum(-ncr * 0.99 * orho * odt, -tnc * orho * odt),
            pnc_wcd)
        # total cloud evaporation removes every droplet (:3086-3089)
        pnc_wcd = torch.where(cond_on & ~(xrc > 0.0), -ncr * orho * odt,
                              pnc_wcd)
        ncten = ncten + pnc_wcd
        nwfaten = nwfaten - pnc_wcd
    qcten = qcten + prw_vcd
    qvten = qvten - prw_vcd
    tten = tten + lvap * ocp * prw_vcd
    rc = torch.where(cond_on, _max(R1, (qc1d + DT * qcten) * rho), rc)
    if aer:
        ncr = torch.where(cond_on,
                          _max(2.0, (nc1d + DT * ncten) * rho), ncr)
    qv = torch.where(cond_on, _max(1e-10, qv1d + DT * qvten), qv)
    temp = torch.where(cond_on, t1d + DT * tten, temp)
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    qvs = rslf(pres, temp)
    ssatw_new = qv / qvs - 1.0
    ssatw = torch.where(cond_on, ssatw_new, ssatw)

    # ---- rain evaporation (mp_thompson.f90:2410-2475) ------------------
    rev_on = (ssatw < -EPS) & L_qr & ~(prw_vcd > 0.0)
    tempc = temp - 273.15
    otemp = 1.0 / temp
    _, rhof, rhof2, diffu, visco, ocp, vsc2, lvap, tcond = \
        _thermo(temp, pres, qv)
    rvs = rho * qvs
    rvs_p = rvs * otemp * (lvap * otemp * ORV - 1.)
    rvs_pp = rvs * (otemp * (lvap * otemp * ORV - 1.)
                    * otemp * (lvap * otemp * ORV - 1.)
                    + (-2. * lvap * otemp ** 3 * ORV) + otemp * otemp)
    gamsc = lvap * diffu / tcond * rvs_p
    alphsc = _max(1e-9, 0.5 * (gamsc / (1. + gamsc)) ** 2
                  * rvs_pp / rvs_p * rvs / rvs_p)
    xsat = _min(-1e-9, ssatw)
    t1_evap = 2. * PI * (1.0 - alphsc * xsat + 2. * alphsc ** 2 * xsat ** 2
                         - 5. * alphsc ** 3 * xsat ** 3) / (1. + gamsc)
    lamr_e = 1.0 / ilamr
    tiny_r = (qv / qvs < 0.95) & (rr / rho <= 1e-8)
    rev_big = t1_evap * diffu * (-ssatw) * N0_r * rvs \
        * (c.t1_qr_ev * _pow(ilamr, c.cre[9])
           + c.t2_qr_ev * vsc2 * rhof2
           * _pow(lamr_e + 0.5 * FV_R, -c.cre[10]))
    rate_max_e = torch.minimum(rr / rho * odts, (qvs - qv) * odts)
    prv_rev = torch.where(rev_on,
                          torch.where(tiny_r, rr / rho * odts,
                                      torch.minimum(rate_max_e,
                                                    rev_big / rho)), zero)
    pnr_rev = torch.where(rev_on,
                          torch.minimum(nr * 0.99 / rho * odts,
                                        prv_rev * nr / _max(rr, R1)), zero)
    qrten = qrten - prv_rev
    qvten = qvten + prv_rev
    nrten = nrten - pnr_rev
    tten = tten - lvap * ocp * prv_rev
    if aer:
        # evaporated rain releases its aerosol (mp_thompson_aer.f90:3178)
        nwfaten = nwfaten + pnr_rev

    rr = torch.where(rev_on, _max(R1, (qr1d + DT * qrten) * rho), rr)
    qv = torch.where(rev_on, _max(1e-10, qv1d + DT * qvten), qv)
    nr = torch.where(rev_on, _max(R2, (nr1d + DT * nrten) * rho), nr)
    temp = torch.where(rev_on, t1d + DT * tten, temp)
    rho = 0.622 * pres / (RR2 * temp * (qv + 0.622))
    rhof = torch.sqrt(_rd(RHO_NOT, rho))

    # ---- terminal velocities (mp_thompson.f90:2495-2650) ---------------
    has_rr = rr > R1
    lamr_v = _pow(AM_R * c.crg[2] * c.org2 * nr / rr, c.obmr)
    vtr_m = rhof * AV_R * c.crg[5] * c.org3 * _pow(lamr_v, c.cre[2]) \
        * _pow(lamr_v + FV_R, -c.cre[5])
    vtr_n = _dc(rhof * AV_R * c.crg[6], c.crg[11]) \
        * _pow(lamr_v, c.cre[11]) * _pow(lamr_v + FV_R, -c.cre[6])
    vtrk = _filldown(torch.where(has_rr, vtr_m, zero), has_rr)
    vtnrk = _filldown(torch.where(has_rr, vtr_n, zero), has_rr)

    has_ri = ri > R1
    lami_v = _pow(AM_I * c.cig[1] * c.oig1 * ni / ri, c.obmi)
    ilami_v = 1.0 / lami_v
    vti_m = rhof * pp.av_i * c.cig[2] * c.oig2 * _pow(ilami_v, BV_I)
    vti_n = _dc(rhof * pp.av_i * c.cig[5], c.cig[6]) * _pow(ilami_v, BV_I)
    vtik = _filldown(torch.where(has_ri, vti_m, zero), has_ri)
    vtnik = _filldown(torch.where(has_ri, vti_n, zero), has_ri)

    has_rs = rs > R1
    xDs_v = smoc / _max(smob, R1)
    Mrat = 1.0 / _max(xDs_v, 1e-12)
    ils1 = 1. / (Mrat * LAM0 + pp.fv_s)
    ils2 = 1. / (Mrat * LAM1 + pp.fv_s)
    t1_vts = KAP0 * c.csg[3] * _pow(ils1, c.cse[3])
    t2_vts = KAP1 * _pow(Mrat, MU_S) * c.csg[9] * _pow(ils2, c.cse[9])
    ils1b = 1. / (Mrat * LAM0)
    ils2b = 1. / (Mrat * LAM1)
    t3_vts = KAP0 * c.csg[0] * _pow(ils1b, c.cse[0])
    t4_vts = KAP1 * _pow(Mrat, MU_S) * c.csg[6] * _pow(ils2b, c.cse[6])
    vts = rhof * pp.av_s * (t1_vts + t2_vts) / (t3_vts + t4_vts)
    vts_full = torch.where(temp > T_0,
                           torch.maximum(vts * vts_boost, vtrk),
                           vts * vts_boost)
    vtsk = _filldown(torch.where(has_rs, vts_full, zero), has_rs)

    has_rg = rg > R1
    vtg = rhof * pp.av_g * c.cgg[5] * c.ogg3 * _pow(ilamg, pp.bv_g)
    vtg_full = torch.where(temp > T_0, torch.maximum(vtg, vtrk), vtg)
    vtgk = _filldown(torch.where(has_rg, vtg_full, zero), has_rg)

    O = dict(rr=rr, nr=nr, ri=ri, ni=ni, rs=rs, rg=rg, vtrk=vtrk,
             vtnrk=vtnrk, vtik=vtik, vtnik=vtnik, vtsk=vtsk, vtgk=vtgk,
             rho=rho, ocp=ocp, lvap=lvap, tten=tten, qvten=qvten,
             qcten=qcten, qiten=qiten, niten=niten, qrten=qrten,
             nrten=nrten, qsten=qsten, qgten=qgten)
    if aer:
        O.update(ncten=ncten, nwfaten=nwfaten, nifaten=nifaten, rhof=rhof)
    return O


def _post_block(P, O, dzq, DT, c, pp):
    """Sedimentation, (aerosol-aware) drizzle settling, instant melt /
    homogeneous freeze and the final update (mp_thompson.f90:2657-2844).
    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr[, nc, nwfa, nifa],
    ppt_rain, ppt_ice, ppt_snow, ppt_graupel); the ppt fields keep a
    leading singleton level axis."""
    aer = "ncr" in P
    odt = _f32(np.float32(1.0) / np.float32(DT))
    qv1d, exner = P["qv1d"], P["exner"]
    (rr, nr, ri, ni, rs, rg, vtrk, vtnrk, vtik, vtnik, vtsk, vtgk, rho,
     ocp, lvap, tten, qvten, qcten, qiten, niten, qrten, nrten, qsten,
     qgten) = (O[k] for k in _O_NAMES)
    t1d = P["t1d"]
    qc1d, qi1d, ni1d, qr1d, nr1d, qs1d, qg1d = (
        P["qc1d"], P["qi1d"], P["ni1d"], P["qr1d"], P["nr1d"], P["qs1d"],
        P["qg1d"])
    zero = P["zero"]
    if aer:
        nc1d, w1d, rhof = P["nc1d"], P["w1d"], O["rhof"]
        nwfa1d, nifa1d = P["nwfa1d"], P["nifa1d"]
        ncten, nwfaten, nifaten = O["ncten"], O["nwfaten"], O["nifaten"]
        # the drizzle's tendency divides by the density before the TAU+1
        # update, rc_s uses the final one (mp_thompson_aer.f90:2664;
        # reference quirk kept)
        orho = 1.0 / P["rho"]
    # every branch of the core's updates wrote t1d + DT*tten
    temp = t1d + DT * tten

    # ---- sedimentation -------------------------------------------------
    rr, nr, d_q, d_n, ppt_rain = _sediment(
        rr, nr, vtrk, vtnrk, rho, dzq, DT, True)
    qrten = qrten + d_q
    nrten = nrten + d_n
    ri, ni, d_q, d_n, ppt_ice = _sediment(
        ri, ni, vtik, vtnik, rho, dzq, DT, True, vt_for_cfl=vtik)
    qiten = qiten + d_q
    niten = niten + d_n
    rs, _, d_q, _, ppt_snow = _sediment(
        rs, rs, vtsk, vtsk, rho, dzq, DT, False)
    qsten = qsten + d_q
    rg, _, d_q, _, ppt_graupel = _sediment(
        rg, rg, vtgk, vtgk, rho, dzq, DT, False)
    qgten = qgten + d_q

    if aer:
        # cloud droplet (drizzle) settling in the lowest ~500 m above
        # ground under weak vertical motion: one explicit upstream pass of
        # mass and number (mp_thompson_aer.f90:3252-3272, 3411-3424)
        rc_s = _max(R1, (qc1d + qcten * DT) * rho)
        nc_s = _max(2.0, (nc1d + ncten * DT) * rho)
        nu_cs = _nu_c(nc_s)
        g1s, _ = _g_ratios(nu_cs)
        nu_f = nu_cs.to(torch.float32)
        lamc_s = _pow(nc_s * AM_R * g1s / rc_s, c.obmr)
        ilamc_s = 1.0 / lamc_s
        sed_ok = (rc_s > R1) & (w1d < 0.1)
        vtck = torch.where(sed_ok, rhof * tt.AV_C * (nu_f + 4.) * (nu_f + 5.)
                           * _pow(ilamc_s, tt.BV_C), zero)
        vtnck = torch.where(sed_ok, rhof * tt.AV_C * (nu_f + 1.)
                            * (nu_f + 2.) * _pow(ilamc_s, tt.BV_C), zero)
        # the levels whose base lies within 500 m of the ground, up to the
        # highest cloudy one among them (ksed1(5))
        agl = pw.cumsum(dzq, 0)
        elig = ((agl - dzq) < 500.0) & (rc_s > R2)
        below_top = torch.flip(torch.cummax(
            torch.flip(elig.to(torch.int32), [0]), 0).values, [0]) > 0
        sed_c = vtck * rc_s
        sed_nc = vtnck * nc_s
        flux_c = torch.cat([sed_c[1:], zero[:1]], 0) - sed_c
        flux_n = torch.cat([sed_nc[1:], zero[:1]], 0) - sed_nc
        qcten = qcten + torch.where(below_top, flux_c / dzq * orho, zero)
        ncten = ncten + torch.where(below_top, flux_n / dzq * orho, zero)

    # ---- instant melt / homogeneous freeze (mp_thompson.f90:2786-2810) -
    xri = _max(0.0, qi1d + qiten * DT)
    melt = (temp > T_0) & (xri > 0.0)
    qcten = qcten + torch.where(melt, xri * odt, zero)
    qiten = qiten - torch.where(melt, xri * odt, zero)
    niten = torch.where(melt, -ni1d * odt, niten)
    tten = tten - torch.where(melt, LFUS * ocp * xri * odt, zero)

    xrc = _max(0.0, qc1d + qcten * DT)
    frz = (temp < HGFR) & (xrc > 0.0)
    lfus2 = LSUB - lvap
    qiten = qiten + torch.where(frz, xrc * odt, zero)
    niten = niten + torch.where(frz, _dc(xrc, XM0I) * odt, zero)
    qcten = qcten - torch.where(frz, xrc * odt, zero)
    tten = tten + torch.where(frz, lfus2 * ocp * xrc * odt, zero)

    # ---- final update (mp_thompson.f90:2815-2844) ----------------------
    t_out = t1d + tten * DT
    qv_out = _max(1e-10, qv1d + qvten * DT)
    qc_out = qc1d + qcten * DT
    qc_out = torch.where(qc_out <= R1, zero, qc_out)
    qi_out = qi1d + qiten * DT
    ni_out = torch.maximum(_rd(R2, rho), ni1d + niten * DT)
    gone_i = qi_out <= R1
    lami_f = _pow(AM_I * c.cig[1] * c.oig1 * ni_out / _max(qi_out, R1),
                  c.obmi)
    xDi_f = _rd(BM_I + c.mu_i + 1.0, lami_f)
    lami_f = _where(xDi_f < 20e-6, c.cie[1] / 20e-6,
                    _where(xDi_f > 300e-6, c.cie[1] / 300e-6, lami_f))
    ni_out = torch.where(gone_i, zero,
                         torch.minimum(_dc(c.cig[0] * c.oig2 * qi_out, AM_I)
                                       * _pow(lami_f, BM_I),
                                       _rd(250e3, rho)))
    qi_out = torch.where(gone_i, zero, qi_out)
    qr_out = qr1d + qrten * DT
    nr_out = torch.maximum(_rd(R2, rho), nr1d + nrten * DT)
    gone_r = qr_out <= R1
    lamr_f = _pow(AM_R * c.crg[2] * c.org2 * nr_out / _max(qr_out, R1),
                  c.obmr)
    mvd_f = _clip(_rd(3.0 + c.mu_r + 0.672, lamr_f), D0R * 0.75, 2.5e-3)
    nr_out = torch.where(gone_r, zero, _rain_nr_from_mvd(qr_out, mvd_f, c))
    qr_out = torch.where(gone_r, zero, qr_out)
    qs_out = qs1d + qsten * DT
    qs_out = torch.where(qs_out <= R1, zero, qs_out)
    qg_out = qg1d + qgten * DT
    qg_out = torch.where(qg_out <= R1, zero, qg_out)

    # driver-level qv floor (mp_gt_driver, :1005-1020)
    qv_out = _max(qv_out, 1e-7)

    th_out = t_out / exner
    if not aer:
        return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
                ni_out, nr_out, ppt_rain, ppt_ice, ppt_snow, ppt_graupel)

    # the final droplet and aerosol numbers with the size and
    # concentration caps (mp_thompson_aer.f90:3540-3561)
    nc_out = torch.maximum(_rd(2.0, rho), nc1d + ncten * DT)
    nwfa_out = torch.minimum(torch.maximum(nwfa1d + nwfaten * DT,
                                           _rd(11.1e6, rho)),
                             _rd(9999.0e6, rho))
    nifa_out = torch.minimum(_max(nifa1d + nifaten * DT, tt.NA_IN1 * 0.01),
                             _rd(9999.0e6, rho))
    gone_c = qc_out <= R1
    nu_cf = _nu_c(_max(2.0, nc_out * rho))
    g1f, _ = _g_ratios(nu_cf)
    lamc_f = _pow(AM_R * g1f * nc_out / _max(qc_out, R1), c.obmr)
    xDc_f = (BM_R + nu_cf + 1.0) / lamc_f
    cce2f = BM_R + nu_cf.to(torch.float32) + 1.0
    lamc_f = torch.where(xDc_f < D0C, _dc(cce2f, D0C),
                         torch.where(xDc_f > D0R * 2., _dc(cce2f, D0R * 2.),
                                     lamc_f))
    nc_out = torch.where(gone_c, zero,
                         torch.minimum(qc_out / (AM_R * g1f)
                                       * _pow(lamc_f, BM_R),
                                       _rd(tt.NT_C_MAX, rho)))
    return (th_out, qv_out, qc_out, qi_out, qr_out, qs_out, qg_out,
            ni_out, nr_out, nc_out, nwfa_out, nifa_out,
            ppt_rain, ppt_ice, ppt_snow, ppt_graupel)


# the core outputs, in the JAX package's order
_O_NAMES = ("rr", "nr", "ri", "ni", "rs", "rg", "vtrk", "vtnrk", "vtik",
            "vtnik", "vtsk", "vtgk", "rho", "ocp", "lvap", "tten",
            "qvten", "qcten", "qiten", "niten", "qrten", "nrten",
            "qsten", "qgten")


def thompson_step(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d, exner,
                  p1d, dzq, dt, params: ThompsonParams = None, nc1d=None,
                  nwfa1d=None, nifa1d=None, w1d=None):
    """One Thompson step: prep -> bins -> table values -> core -> post
    (mp_thompson.f90:1057-2844); with ``nc1d`` the aerosol-aware scheme.
    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr[, nc, nwfa, nifa],
    ppt_rain, ppt_ice, ppt_snow, ppt_graupel), the ppt fields (ny, nx) in
    kg m-2 (= mm)."""
    params = params or ThompsonParams()
    _, c = get_tables(params)
    DT = _f32(dt)
    P = _prep_block(th, qv1d, qc1d, qi1d, qr1d, qs1d, qg1d, ni1d, nr1d,
                    exner, p1d, c, params, nc1d=nc1d, nwfa1d=nwfa1d,
                    nifa1d=nifa1d, w1d=w1d)
    I = _index_block(P, c)
    G = _lookup(device_tables(params, th.device), I)
    O = _core_block(P, I["idx_i"], G, DT, c, params,
                    tnc_wev=(device_tnc_wev(th.device) if nc1d is not None
                             else None))
    outs = _post_block(P, O, dzq, DT, c, params)
    return outs[:-4] + tuple(o[0] for o in outs[-4:])


def _accumulate(rain, snow, graupel, ppt_rain, ppt_ice, ppt_snow,
                ppt_graupel):
    """The surface accumulators after one step, in the JAX order
    (icar_tpu/physics/mp_thompson.py mp_thompson_stack)."""
    return (rain + ppt_rain + ppt_snow + ppt_graupel + ppt_ice,
            snow + ppt_snow + ppt_ice, graupel + ppt_graupel)


def mp_thompson(th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz, dt,
                rain, snow, graupel, params: ThompsonParams = None):
    """One Thompson step over the full grid (mp_gt_driver,
    mp_thompson.f90:772-1044). rain/snow/graupel are (y, x) accumulators
    [mm]; ni/nr are number mixing ratios [kg^-1].

    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr, rain, snow, graupel)."""
    outs = thompson_step(th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz,
                         dt, params)
    return outs[:9] + _accumulate(rain, snow, graupel, *outs[9:])


# registry name -> scheme position of (th, qv, qc, qi, qr, qs, qg, ni, nr)
_STACK_FIELDS = {
    "potential_temperature": 0, "water_vapor": 1, "cloud_water": 2,
    "cloud_ice": 3, "rain_mass": 4, "snow_mass": 5, "graupel_mass": 6,
    "ice_number": 7, "rain_number": 8,
}
SPECIES = tuple(_STACK_FIELDS)


def stack_smap(names):
    """smap for mp_thompson_stack: scheme position -> stack row, or None
    if ``names`` is not exactly the 9 Thompson-advected species."""
    if len(names) != 9 or set(names) != set(_STACK_FIELDS):
        return None
    smap = [0] * 9
    for row, n in enumerate(names):
        smap[_STACK_FIELDS[n]] = row
    return tuple(smap)


def mp_thompson_stack(qstack, names, exner, p, dz, dt, rain, snow, graupel,
                      params: ThompsonParams = None):
    """One Thompson step on the advected-species stack (9, nz, ny, nx) in
    the order ``names`` (exactly the 9 Thompson species). Returns
    (out_stack in the same order, rain, snow, graupel)."""
    smap = stack_smap(tuple(names))
    if smap is None:
        raise ValueError(f"mp_thompson_stack: {tuple(names)} is not the set "
                         f"of Thompson species {SPECIES}")
    return mp_thompson_smap(qstack, smap, exner, p, dz, dt, rain, snow,
                            graupel, params)


def mp_thompson_smap(qstack, smap, exner, p, dz, dt, rain, snow, graupel,
                     params: ThompsonParams = None):
    """mp_thompson_stack with the stack order given as ``smap`` (scheme
    position -> stack row, as stack_smap returns it): the plain version of
    kernel K5's wrapper."""
    outs = thompson_step(*(qstack[i] for i in smap), exner, p, dz, dt,
                         params)
    out_stack = torch.empty_like(qstack)
    for pos, row in enumerate(smap):
        out_stack[row] = outs[pos]
    return (out_stack,) + _accumulate(rain, snow, graupel, *outs[9:])


# the aerosol-aware scheme's fields, in its order: the nine of the stack,
# then the droplet number and the water- and ice-friendly aerosols
AER_SPECIES = SPECIES + ("cloud_number", "nwfa", "nifa")


def mp_thompson_aer(th, qv, qc, qi, qr, qs_, qg, ni, nr, nc, nwfa, nifa,
                    exner, p, dz, dt, rain, snow, graupel, w=None,
                    params: ThompsonParams = None):
    """One aerosol-aware Thompson-Eidhammer step (the is_aerosol_aware
    path of mp_thompson_aer.f90): the droplet number nc and the water- and
    ice-friendly aerosol numbers nwfa and nifa (all kg^-1) drive droplet
    activation, DeMott (2010) dust nucleation and Koop (2001) homogeneous
    freezing, and precipitation scavenges them. ``w`` is the vertical
    velocity the drizzle settling reads (zeros if None).

    Returns (th, qv, qc, qi, qr, qs, qg, ni, nr, nc, nwfa, nifa, rain,
    snow, graupel)."""
    outs = thompson_step(th, qv, qc, qi, qr, qs_, qg, ni, nr, exner, p, dz,
                         dt, params, nc1d=nc, nwfa1d=nwfa, nifa1d=nifa,
                         w1d=w)
    return outs[:12] + _accumulate(rain, snow, graupel, *outs[12:])


def aer_surface_flux(nwfa_sfc, dx, dy=None):
    """Copy of icar_tpu/physics/mp_thompson.py aer_surface_flux: the CCN
    surface-emission rate nwfa2d [kg^-1 s^-1] from the initial lowest-level
    nwfa (thompson_aer_init, mp_thompson_aer.f90:536-549), scaled down for
    grids finer than 20 km; added to the lowest level at every
    microphysics call (numpy)."""
    dy = dx if dy is None else dy
    s = float(np.sqrt(dx * dy))
    if s / 20000.0 >= 1.0:
        h_01 = 0.875
    else:
        h_01 = (0.875 + 0.125 * ((20000.0 - s) / 16000.0)) * s / 20000.0
    return 10.0 ** (np.log10(nwfa_sfc * 1e-6) - 3.69897) * h_01 * 1e6


def aer_init_profiles(z_agl, terrain):
    """Copy of icar_tpu/physics/mp_thompson.py aer_init_profiles: the
    default CCN/IN profiles of a run without aerosol input, decaying with
    height above ground at a terrain-dependent scale (thompson_aer_init,
    mp_thompson_aer.f90:454-516). ``z_agl`` (z, y, x) [m], ``terrain``
    (y, x) [m] (numpy). NOTE reference fault kept (ROADMAP section 3): the
    concentrations, per m^3, go into the kg^-1 aerosol fields."""
    h_01 = np.where(terrain <= 1000.0, 0.8,
                    np.where(terrain >= 2500.0, 0.01,
                             0.8 * np.cos(terrain * 0.001 - 1.0)))[None]
    niCCN3 = -1.0 * np.log(tt.NA_CCN1 / tt.NA_CCN0) / h_01
    niIN3 = -1.0 * np.log(tt.NA_IN1 / tt.NA_IN0) / h_01
    nwfa = tt.NA_CCN1 + tt.NA_CCN0 * np.exp(-(z_agl / 1000.0) * niCCN3)
    nifa = tt.NA_IN1 + tt.NA_IN0 * np.exp(-(z_agl / 1000.0) * niIN3)
    return nwfa, nifa


def calc_effect_rad(t, p, qv, qc, qi, ni, qs_, params: ThompsonParams = None,
                    nc=None):
    """Cloud, ice and snow effective radii [m] for the radiation
    (calc_effectRad, mp_thompson_aer.f90:5026-5127). ``nc`` is the
    droplet number [kg^-1] of an aerosol-aware run; without it the droplet
    number is the constant Nt_c, as the reference driver always runs it
    (mp_driver.f90:446-476 passes no nc)."""
    params = params or ThompsonParams()
    _, c = get_tables(params)
    rho = 0.622 * p / (RR2 * t * (qv + 0.622))
    rc = _max(R1, qc * rho)
    if nc is None:
        nc = torch.full_like(rc, _f32(params.Nt_c))
    else:
        nc = _max(2.0, nc * rho)
    ri = _max(R1, qi * rho)
    ni_ = _max(R2, ni * rho)
    rs = _max(R1, qs_ * rho)

    # cloud droplets: generalised gamma with an nc-dependent shape
    inu_c = _nu_c(nc)
    inu_c = torch.where(nc < 100.0, torch.full_like(inu_c, 15), inu_c)
    # the reference's table g_ratio(inu) = G(inu+4)/G(inu+1) (mp_thompson_
    # aer.f90:5045-5046; the JAX package's _G_RATIO), computed
    g_r, _ = _g_ratios(inu_c)
    lamc = _pow(nc * AM_R * g_r / rc, c.obmr)
    re_qc = _clip(0.5 * (3.0 + inu_c) / lamc, 2.51e-6, 50e-6)
    re_qc = _where((rc > R1) & (nc > R2), re_qc, 2.49e-6)

    # cloud ice
    lami = _pow(AM_I * c.cig[1] * c.oig1 * ni_ / ri, c.obmi)
    re_qi = _clip(_rd(0.5 * (3.0 + c.mu_i), lami), 5.01e-6, 125e-6)
    re_qi = _where((ri > R1) & (ni_ > R2), re_qi, 4.99e-6)

    # snow: the (bm_s+1)-th over the bm_s-th Field moment
    smob, _, _, _, smoc, _, _, _ = _snow_moments(rs, t, c)
    re_qs = _clip(0.5 * smoc / smob, 10e-6, 999e-6)
    re_qs = _where(rs > R1, re_qs, 9.99e-6)
    return re_qc, re_qi, re_qs


def _field_block(c):
    """Per Field moment n (1, cse[0], cse[12], cse[15]; the order the
    kernel reads them): n and the float64 products of the coefficients with
    n that _field_ab forms before any tensor enters."""
    out = {}
    for j, n in enumerate((1.0, float(c.cse[0]), float(c.cse[12]),
                           float(c.cse[15]))):
        out.update({f"FN{j}": n, f"SA2N{j}": SA[2] * n,
                    f"SA5NN{j}": SA[5] * n * n, f"SA9N3{j}": SA[9] * n ** 3,
                    f"SB2N{j}": SB[2] * n, f"SB5NN{j}": SB[5] * n * n,
                    f"SB9N3{j}": SB[9] * n ** 3})
    return out


def _recip(x) -> float:
    """The float32 reciprocal of float32 ``x`` (how ``_dc`` divides)."""
    return float(np.float32(1.0) / np.float32(x))


def kernel_constants(params: ThompsonParams = None) -> dict:
    """Every parameter-derived constant of the scheme, in the order of the
    ``enum Kc`` of ``csrc/mp_thompson.cu``: each value is the float64
    expression the plain version folds before a tensor enters (grouped as
    it groups them), or the float32 reciprocal ``_dc`` multiplies by. The
    kernel receives them as one float32 array."""
    p = params or ThompsonParams()
    _, c = get_tables(p)
    k = dict(
        RHO_NOT=RHO_NOT, R273=_recip(273.15), ORV=ORV,
        AMI_CIG1_OIG1=AM_I * c.cig[1] * c.oig1, OBMI=c.obmi,
        XDI_NUM=BM_I + c.mu_i + 1.0, CIG0_OIG2=c.cig[0] * c.oig2,
        RAMI=_recip(AM_I), LAMILO3=(c.cie[1] / 20e-6) ** BM_I,
        LAMIHI3=(c.cie[1] / 300e-6) ** BM_I, LAMI_LO=c.cie[1] / 20e-6,
        LAMI_HI=c.cie[1] / 300e-6,
        AMR_CRG2_ORG2=AM_R * c.crg[2] * c.org2, OBMR=c.obmr,
        MVDNUM_R=3.0 + c.mu_r + 0.672, MVD_LO=D0R * 0.75,
        CRG1_ORG3=c.crg[1] * c.org3, RAMR=_recip(AM_R), OAMS=c.oams,
        SA0=SA[0], SA1=SA[1], SA3=SA[3], SA4=SA[4], SA6=SA[6], SA7=SA[7],
        SA8=SA[8], SB0=SB[0], SB1=SB[1], SB3=SB[3], SB4=SB[4], SB6=SB[6],
        SB7=SB[7], SB8=SB[8],
        **_field_block(c),
        AMG=c.am_g, CGG0=c.cgg[0], OGE1=c.oge1,
        LAMG_FAC=(c.cgg[2] * c.ogg2 * c.ogg1) ** c.obmg, CGG1=c.cgg[1],
        CGE1=c.cge[1], ORG2=c.org2, CRE1=c.cre[1],
        R_AMR_NTC=_recip(AM_R * p.Nt_c),
        NTC_AMR_CCG1_OCG1=p.Nt_c * AM_R * c.ccg[1] * c.ocg1,
        MVDNUM_C=3.0 + c.mu_c + 0.672, DCG_NUM=(c.ccg[2] * c.ocg2) ** c.obmr,
        D0C_E6=D0C * 1e6,
        RC0=tt.r_c[0], RI0=tt.r_i[0], NTI0=tt.Nt_i[0], RR0=tt.r_r[0],
        RS0=tt.r_s[0], RG0=tt.r_g[0],
        NIC2=c.nic2, NII2=c.nii2, NII3=c.nii3, NIR2=c.nir2, NIR3=c.nir3,
        NIS2=c.nis2, NIG2=c.nig2, NIG3=c.nig3,
        R_D0R=_recip(tt.D0R), R_LOGDR=_recip(np.log(float(c.Dr[-1]
                                                          / c.Dr[0]))),
        R_D0S=_recip(tt.D0S), R_LOGDS=_recip(np.log(float(c.Ds[-1]
                                                          / c.Ds[0]))),
        R5=_recip(5.0),
        LAMEXPR_FAC=(c.crg[2] * c.org2 * c.org1) ** BM_R, ORG1=c.org1,
        CRE0=c.cre[0], LAMEXPG_FAC=(c.cgg[2] * c.ogg2 * c.ogg1) ** BM_G,
        OGG1=c.ogg1, RAMG=_recip(c.am_g), CGE0=c.cge[0],
        R_PNRWAU=_recip(AM_R * c.mu_c * D0R ** 3), T1QRQC=c.t1_qr_qc,
        NCRE8=-c.cre[8], M2LSUB=-2. * LSUB, FOURPI=4. * PI, TWOPI=2. * PI,
        T1QSQC=c.t1_qs_qc, XDG_NUM=BM_G + c.mu_g + 1., AVG=p.av_g,
        CGG5=c.cgg[5], OGG3=c.ogg3, BVG=p.bv_g, T1QGQC=c.t1_qg_qc,
        CGE8=c.cge[8], R_2XM0I=_recip(2. * XM0I), NTC=p.Nt_c,
        R_XM0I=_recip(XM0I), TNO=p.TNO, D0I=c.D0i, OIG1=c.oig1,
        CIG4=c.cig[4], CSQRD=p.C_sqrd, CDIFF=p.C_cubes - p.C_sqrd,
        R_M15=_recip(-30. + 15.), CLO=min(p.C_sqrd, p.C_cubes),
        CHI=max(p.C_sqrd, p.C_cubes), T1QSSD=c.t1_qs_sd, T2QSSD=c.t2_qs_sd,
        CGE9=c.cge[9], CGE10=c.cge[10], T1QGSD=c.t1_qg_sd,
        T2QGSD=c.t2_qg_sd, T1QSQI=c.t1_qs_qi, EFSI=p.Ef_si,
        T1QRQI=c.t1_qr_qi, EFRI=p.Ef_ri, T2QRQI=c.t2_qr_qi, NCRE7=-c.cre[7],
        R3=_recip(3.0), IAU_BIG=5.0 * D0S, IAU_NONE=0.1 * D0S,
        T1QSME=c.t1_qs_me, T2QSME=c.t2_qs_me, C4218OLFUS=4218. * OLFUS,
        CCUBES=p.C_cubes, T1QGME=c.t1_qg_me, T2QGME=c.t2_qg_me, LFUS=LFUS,
        T1QREV=c.t1_qr_ev, T2QREV=c.t2_qr_ev, CRE9=c.cre[9],
        NCRE10=-c.cre[10], HALF_FVR=0.5 * FV_R,
        CRG5=c.crg[5], ORG3=c.org3, CRE2=c.cre[2], NCRE5=-c.cre[5],
        CRG6=c.crg[6], R_CRG11=_recip(c.crg[11]), CRE11=c.cre[11],
        NCRE6=-c.cre[6], AVI=p.av_i, CIG2=c.cig[2], OIG2=c.oig2,
        CIG5=c.cig[5], R_CIG6=_recip(c.cig[6]), FVS=p.fv_s,
        KAP0_CSG3=KAP0 * c.csg[3], CSE3=c.cse[3], CSG9=c.csg[9],
        CSE9=c.cse[9], KAP0_CSG0=KAP0 * c.csg[0], CSE0=c.cse[0],
        CSG6=c.csg[6], CSE6=c.cse[6], AVS=p.av_s, SIXTH=1.0 / 6.0,
    )
    return {name: float(v) for name, v in k.items()}

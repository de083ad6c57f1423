"""Seeded Thompson states and the comparison of K5 with its plain version.

The states are made with numpy from a seed (the saturation mixing ratios
from the plain version's ``rslf``/``rsif`` on the CPU), in the scheme's field
order, so the same inputs reach the JAX package, the plain version and the
kernel: mixed-regime columns (warm rain, mixed phase, riming, glaciated;
tests/test_thompson_pallas.py ``_mixed_state``), an inert state and an
ice-supersaturated one. ``chip_smoke.py`` and the tests share them, and
share ``compare``, the tolerance K5 is held to against the plain version.
"""

import numpy as np
import torch

from .mp_thompson import rsif, rslf

FIELDS = ("th", "qv", "qc", "qi", "qr", "qs", "qg", "ni", "nr")
OUTPUTS = FIELDS + ("rain", "snow", "graupel")


def _f32(a):
    return np.asarray(a, np.float32)


def column(nz, ny, nx, dz_level=400.0):
    """dz, z (mid-levels), p and exner of a standard column."""
    dz = np.full((nz, ny, nx), dz_level, np.float32)
    z = np.cumsum(dz, axis=0) - dz_level / 2
    p = _f32(1e5 * np.exp(-z / 8000.0))
    exner = _f32((p / 1e5) ** (287.04 / 1004.0))
    return dz, z, p, exner


def mixed_state(seed, nz=20, ny=7, nx=13, dz_level=400.0):
    """Randomized columns spanning warm rain, mixed-phase and glaciated
    regimes, with every species present somewhere."""
    r = np.random.default_rng(seed)
    dz, z, p, exner = column(nz, ny, nx, dz_level)
    t = r.uniform(250.0, 300.0, (ny, nx))[None] - 0.0065 * z + r.uniform(
        -3, 3, (nz, ny, nx))
    qvs = rslf(torch.tensor(p), torch.tensor(_f32(t))).numpy()
    qv = qvs * r.uniform(0.3, 1.3, (nz, ny, nx))

    def hydro(scale):
        q = r.uniform(0, scale, (nz, ny, nx))
        return np.where(r.uniform(size=q.shape) < 0.6, q, 0.0)

    return dict(th=_f32(t / exner), qv=_f32(qv), qc=_f32(hydro(1.5e-3)),
                qi=_f32(hydro(3e-4)), qr=_f32(hydro(1e-3)),
                qs=_f32(hydro(8e-4)), qg=_f32(hydro(5e-4)),
                ni=_f32(hydro(1e6)), nr=_f32(hydro(5e6)), exner=exner, p=p,
                dz=dz)


def inert_state(nz=10, ny=5, nx=11, dz_level=400.0):
    """Dry, water-subsaturated, below the ice nucleation trigger, with a few
    cells under the 1e-7 vapour floor and sub-R1 traces
    (tests/test_thompson_pallas.py test_inert_tile_skip_matches_full)."""
    r = np.random.default_rng(11)
    dz, z, p, exner = column(nz, ny, nx, dz_level)
    t = _f32(285.0 - 0.0065 * z + r.uniform(-2, 2, (nz, ny, nx)))
    qv = _f32(rslf(torch.tensor(p), torch.tensor(t)).numpy() * 0.3)
    qv[0, 0, :3] = 3e-8
    trace = _f32(np.where(r.uniform(size=(nz, ny, nx)) < 0.3, 5e-13, 0.0))
    return dict(th=t / exner, qv=qv, qc=trace, qi=trace, qr=trace, qs=trace,
                qg=trace, ni=trace * 1e6, nr=trace * 1e6, exner=exner, p=p,
                dz=dz)


def ice_supersaturated_state(nz=6, ny=3, nx=7):
    """No hydrometeors, water-subsaturated, ice supersaturation 40% at
    228 K: only nucleation acts (tests/test_thompson_pallas.py
    test_ice_supersaturated_tile_goes_active)."""
    dz = np.full((nz, ny, nx), 400.0, np.float32)
    p = np.full((nz, ny, nx), 4e4, np.float32)
    t = np.full((nz, ny, nx), 228.0, np.float32)
    exner = _f32((p / 1e5) ** (287.04 / 1004.0))
    qv = _f32(rsif(torch.tensor(p), torch.tensor(t)).numpy() * 1.4)
    z = np.zeros((nz, ny, nx), np.float32)
    return dict(th=t / exner, qv=qv, qc=z, qi=z, qr=z, qs=z, qg=z, ni=z,
                nr=z, exner=exner, p=p, dz=dz)


def as_stack(state, device="cpu"):
    """(the (9, nz, ny, nx) stack in the scheme's field order, exner, p,
    dz) of ``state`` as tensors on ``device``."""
    t = lambda a: torch.tensor(a, device=device)
    return (torch.stack([t(state[k]) for k in FIELDS]), t(state["exner"]),
            t(state["p"]), t(state["dz"]))


def compare(got, want, rtol=1e-5, share=1e-4, what="K5"):
    """Hold K5's fields and accumulators ``got`` (in the order of OUTPUTS)
    against the plain version's ``want``: each must be finite, with at most
    ``share`` of its cells beyond ``rtol`` relative (atol 1e-6 of the
    field's largest magnitude), where an ulp could move a bin or a
    threshold. Raises AssertionError naming the field; returns (largest
    absolute difference, {field: share beyond rtol})."""
    worst, shares = 0.0, {}
    for name, g, w in zip(OUTPUTS, got, want):
        g = g.detach().cpu().numpy().astype(np.float64)
        w = w.detach().cpu().numpy().astype(np.float64)
        if not np.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite {name}")
        d = np.abs(g - w)
        rel = d / (np.abs(w) + 1e-6 * np.abs(w).max() + 1e-30)
        shares[name] = float(np.mean(rel > rtol))
        if shares[name] > share:
            raise AssertionError(f"{what}: {name} has {shares[name]:.3%} of "
                                 f"its cells beyond rtol {rtol}")
        worst = max(worst, float(d.max()))
    return worst, shares

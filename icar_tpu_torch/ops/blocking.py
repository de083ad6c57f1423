"""Froude-number flow blocking (icar_tpu/ops/blocking.py, after
winds_blocking.f90, wired to the ``block_flow`` switch as the JAX package
wires it).

A (direction x speed) table of blocked-flow perturbations is built from
linear mountain-wave theory at a fixed N^2: each entry's divergence-implied
vertical motion is integrated upward, and above the level of largest
domain-wide downward motion the perturbation is replaced by a small
continued-divergence fraction (compute_blocked_flow_for_wind,
winds_blocking.f90:498-557). At run time a smoothed bulk Froude number
selects how much of it applies (blocking_fraction,
atm_utilities.f90:497-505). The terrain's blocking heights and the key
level's search are numpy copies of the JAX package's functions (held by
tests/test_torch_setup.py); the table is built on the model's device with
``ops/linear_winds``' batched FFTs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from . import linear_winds as lw
from . import pointwise as pw

FRACTION_CONTINUED_DIVERGENCE = 0.05   # winds_blocking.f90:44
NSQ_BLOCKING = 1e-4                    # :46 (fixed background N^2)


class BlockingData(NamedTuple):
    lut_u: torch.Tensor        # (ndir, nspd, nz, ny, nx+1)
    lut_v: torch.Tensor        # (ndir, nspd, nz, ny+1, nx)
    dir_values: torch.Tensor   # (ndir,)
    spd_values: torch.Tensor   # (nspd,)
    terrain_blocking: torch.Tensor   # (ny, nx) blocking height [m]


def terrain_blocking_heights(terrain: np.ndarray,
                             n_smoothing_passes: int = 3) -> np.ndarray:
    """Copy of icar_tpu/ops/blocking.py: the height scale of terrain
    obstacles, the smoothed local relief (compute_terrain_blocking_heights,
    winds_blocking.f90:339-401)."""
    window_size, smooth_window = 5, 2
    ny, nx = terrain.shape

    def box_mean(a, w):
        out = np.empty_like(a)
        for j in range(ny):
            ys, ye = max(j - w, 0), min(j + w, ny - 1)
            for i in range(nx):
                xs, xe = max(i - w, 0), min(i + w, nx - 1)
                out[j, i] = a[ys:ye + 1, xs:xe + 1].mean()
        return out

    tb = box_mean(np.asarray(terrain, np.float64), smooth_window)
    relief = np.empty_like(tb)
    for j in range(ny):
        ys, ye = max(j - window_size, 0), min(j + window_size, ny - 1)
        for i in range(nx):
            xs, xe = max(i - window_size, 0), min(i + window_size, nx - 1)
            w = tb[ys:ye + 1, xs:xe + 1]
            relief[j, i] = w.max() - w.min()
    tb = relief
    for p in range(n_smoothing_passes):
        tb = box_mean(tb, smooth_window)
    return tb.astype(np.float32)


def _find_max_downward_level(wcol_sums: np.ndarray) -> int:
    """Copy of icar_tpu/ops/blocking.py: the level of largest domain-total
    downward motion, with the reference's early return on descent
    (find_maximum_downward_motion, winds_blocking.f90:559-583)."""
    minw = 999999.0
    max_level = 0
    for i, w in enumerate(wcol_sums):
        if w < minw:
            max_level = i
            minw = w
        elif max_level != 0:
            break
    return max_level


def build_blocking_lut(terrain: np.ndarray, dx: float, dz_levels, lt,
                       device, minimum_step: float = 100.0):
    """The (dir, speed) table of blocked-flow u/v perturbations on
    ``device`` (generate_blocked_flow_lut + compute_blocked_flow_for_wind,
    winds_blocking.f90:403-557): (lut_u (ndir, nspd, nz, ny, nx+1), lut_v
    (ndir, nspd, nz, ny+1, nx), dir values, speed values), the values as
    float32 numpy."""
    ny, nx = terrain.shape
    nz = len(dz_levels)
    spec = lw.Spectrum(terrain, dx, lt.buffer, device)
    NY, NX = spec.kl.shape
    b = spec.buffer
    ndir, nspd = lt.n_dir_values, lt.n_spd_values
    dir_values = np.linspace(lt.dirmin, lt.dirmax, ndir).astype(np.float32)
    spd_values = np.linspace(lt.spdmin, lt.spdmax, nspd).astype(np.float32)
    heights = lw.layer_heights(dz_levels, minimum_step)
    # the entries' winds as the JAX package forms them, one by one
    pairs = [(d, s) for d in range(ndir) for s in range(nspd)]
    u_e = np.array([np.sin(dir_values[d]) * spd_values[s]
                    for d, s in pairs], np.float32)
    v_e = np.array([np.cos(dir_values[d]) * spd_values[s]
                    for d, s in pairs], np.float32)

    lut_u = torch.zeros((ndir * nspd, nz, ny, nx + 1), device=spec.device)
    lut_v = torch.zeros((ndir * nspd, nz, ny + 1, nx), device=spec.device)
    for s0 in range(0, len(pairs), lw.CHUNK):
        sel = slice(s0, min(s0 + lw.CHUNK, len(pairs)))
        B = sel.stop - sel.start
        ent = lw.EntryBatch(
            spec, torch.as_tensor(u_e[sel], device=spec.device),
            torch.as_tensor(v_e[sel], device=spec.device),
            torch.full((B,), np.float32(NSQ_BLOCKING), device=spec.device))
        uf = torch.empty((B, nz, NY, NX), device=spec.device)
        vf = torch.empty((B, nz, NY, NX), device=spec.device)
        for zi in range(nz):
            uf[:, zi], vf[:, zi] = ent.layer_mean(heights[zi])
        for i in range(B):
            u1, v1 = uf[i], vf[i]
            # column-integrated divergence -> w; negative part only
            w = torch.zeros((nz, NY, NX), dtype=torch.float64,
                            device=spec.device)
            w[:, 1:-1, 1:-1] = (u1[:, 1:-1, :-2] - u1[:, 1:-1, 2:]
                                + v1[:, :-2, 1:-1] - v1[:, 2:, 1:-1])
            w = torch.clamp(torch.cumsum(w, dim=0), max=0.0)
            key = _find_max_downward_level(
                w.sum(dim=(1, 2)).cpu().numpy())
            if key < nz - 1:
                u1[key + 1:] = u1[key] * FRACTION_CONTINUED_DIVERGENCE
                v1[key + 1:] = v1[key] * FRACTION_CONTINUED_DIVERGENCE
        # crop the buffer and stagger to the u/v grids (:445-455)
        for zi in range(nz):
            uc, vc = lw.crop_stagger(uf[:, zi], vf[:, zi], b)
            lut_u[sel, zi], lut_v[sel, zi] = uc, vc
    return (lut_u.view(ndir, nspd, nz, ny, nx + 1),
            lut_v.view(ndir, nspd, nz, ny + 1, nx), dir_values, spd_values)


def init_blocking(terrain: np.ndarray, dx: float, dz_levels, lt, block,
                  device) -> BlockingData:
    """The blocking table and terrain heights on ``device``
    (initialize_blocking, winds_blocking.f90:260-333)."""
    tb = terrain_blocking_heights(terrain, block.n_smoothing_passes)
    lut_u, lut_v, dirv, spdv = build_blocking_lut(terrain, dx, dz_levels,
                                                  lt, device)
    t = lambda a: torch.as_tensor(a, device=lut_u.device)
    return BlockingData(lut_u, lut_v, t(dirv), t(spdv), t(tb))


def _box_mean_2d(a, w: int):
    """Edge-clipped box mean over (2w+1)^2 cells (the reference's windowed
    sums): the zero-padded box sums of ``a`` and of ones, each as the sum
    of shifted slices, divided."""
    def box_sum(x):
        p = torch.nn.functional.pad(x, (w, w, w, w))
        n = 2 * w + 1
        rows = p[0:p.shape[0] - n + 1]
        for i in range(1, n):
            rows = rows + p[i:p.shape[0] - n + 1 + i]
        out = rows[:, 0:rows.shape[1] - n + 1]
        for i in range(1, n):
            out = out + rows[:, i:rows.shape[1] - n + 1 + i]
        return out
    return box_sum(a) / box_sum(torch.ones_like(a))


def update_froude(th, u, v, z, terrain_blocking, nsmooth_gridcells: int,
                  n_smoothing_passes: int, fr_max: float):
    """Smoothed bulk Froude number (update_froude_number,
    winds_blocking.f90:67-133): one boundary-mean wind and dry-stability
    value against the local blocking height."""
    th_bot = 0.5 * (torch.mean(th[0, 0, :]) + torch.mean(th[0, -1, :]))
    th_top = 0.5 * (torch.mean(th[-1, 0, :]) + torch.mean(th[-1, -1, :]))
    um = 0.5 * (torch.mean(u[:, 0, :]) + torch.mean(u[:, -1, :]))
    vm = 0.5 * (torch.mean(v[:, 0, :]) + torch.mean(v[:, -1, :]))
    wind_speed = torch.sqrt(um ** 2 + vm ** 2)
    z_bot = z[0, 0, 0]
    z_top = z[-1, 0, 0]
    bv = C.GRAVITY * (pw.log(th_top) - pw.log(th_bot)) / (z_top - z_bot)
    stability = torch.sqrt(torch.clamp(bv, min=0.0))
    denom = terrain_blocking * stability
    froude = torch.where(denom == 0.0, 100.0,
                         wind_speed / torch.clamp(denom, min=1e-12))
    for _ in range(n_smoothing_passes):
        froude = _box_mean_2d(froude, nsmooth_gridcells)
    return froude


def _interp(lut, dir_values, spd_values, uu, vv):
    """Bilinear (dir, speed) interpolation of the table ``lut`` (ndir,
    nspd, ...) at each point's local windowed wind
    (winds_blocking.f90:180-230)."""
    nspd = lut.shape[1]
    flat = lut.reshape((-1,) + lut.shape[2:])
    curdir = lw.calc_direction(uu, vv)
    curspd = torch.sqrt(uu ** 2 + vv ** 2)
    dpos = lw._position(dir_values, curdir)
    spos = lw._position(spd_values, curspd)
    dw, dnext = lw._weight(dir_values, dpos, curdir)
    sw, snext = lw._weight(spd_values, spos, curspd)

    def take(d, s):
        return torch.gather(flat, 0, (d * nspd + s)[None])[0]

    return (sw * (dw * take(dpos, spos) + (1 - dw) * take(dnext, spos))
            + (1 - sw) * (dw * take(dpos, snext)
                          + (1 - dw) * take(dnext, snext)))


def apply_blocking(u, v, froude, bd: BlockingData, winsz: int,
                   blocking_contribution: float, fr_max: float,
                   fr_min: float):
    """Add the Froude-weighted blocked-flow perturbation to the staggered
    winds (spatial_blocking, winds_blocking.f90:142-251)."""
    nz = u.shape[0]
    froude_gain = 1.0 / max(fr_max - fr_min, 1e-3)
    iz = np.arange(nz)
    lo = torch.as_tensor(np.maximum(iz - winsz, 0), device=u.device)
    hi = torch.as_tensor(np.minimum(iz + winsz, nz - 1), device=u.device)

    def vert_window_mean(a):
        # moving mean over z with half-window winsz, edge-clipped
        cs = pw.cumsum(torch.cat([torch.zeros_like(a[:1]), a], dim=0), 0)
        return (cs[hi + 1] - cs[lo]) / (hi - lo + 1).to(a.dtype)[:, None, None]

    u_mean = vert_window_mean(u)          # (nz, ny, nx+1)
    v_mean = vert_window_mean(v)          # (nz, ny+1, nx)
    # wind components co-located per staggered grid (the reference indexes
    # u(i,:,uk) and v(vi,:,k) with clipped cross indices), edge-padded
    v_on_u = 0.5 * (v_mean[:, :-1, :] + v_mean[:, 1:, :])
    v_on_u = torch.cat([v_on_u, v_on_u[:, :, -1:]], dim=2)
    u_on_v = 0.5 * (u_mean[:, :, :-1] + u_mean[:, :, 1:])
    u_on_v = torch.cat([u_on_v, u_on_v[:, -1:, :]], dim=1)

    pert_u = _interp(bd.lut_u, bd.dir_values, bd.spd_values, u_mean, v_on_u)
    pert_v = _interp(bd.lut_v, bd.dir_values, bd.spd_values, u_on_v, v_mean)

    fr_u = torch.cat([froude, froude[:, -1:]], dim=1)
    fr_v = torch.cat([froude, froude[-1:, :]], dim=0)
    frac_u = torch.clamp((fr_max - fr_u) * froude_gain, 0.0, 1.0)
    frac_v = torch.clamp((fr_max - fr_v) * froude_gain, 0.0, 1.0)
    u = u + torch.where((fr_u < fr_max)[None],
                        pert_u * frac_u[None] * blocking_contribution, 0.0)
    v = v + torch.where((fr_v < fr_max)[None],
                        pert_v * frac_v[None] * blocking_contribution, 0.0)
    return u, v

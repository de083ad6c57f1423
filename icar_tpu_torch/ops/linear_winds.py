"""Linear mountain-wave theory wind solver (Barstad & Gronas 2006): the
port of icar_tpu/ops/linear_winds.py.

The host part -- the buffered terrain and its spectrum, the table's axes,
size and budget, and the disk cache -- is numpy, copied function by
function from the JAX package (whose module imports jax) and held to it by
tests/test_torch_setup.py; the cache's file format is the JAX package's,
so a table written by either package is read by the other.

The spatial look-up table (initialize_spatial_winds, linear_winds.f90:
596-830) is built on the model's device: for a chunk of (speed, direction,
N^2) entries at once, every height of a layer is one batch of inverse 2-D
FFTs (``torch.fft``, cuFFT on the card) of the terrain spectrum times the
analytic solution, in the operation order and dtypes of the JAX package's
numpy twin (``perturbation_at_height_np``); the complex products are
written out in real arithmetic, so every element rounds alike wherever it
lies in its tensor.

The runtime lookup (spatial_winds, linear_winds.f90:840-1127) reads the 8
bracketing entries of each cell, as the reference does (:1044-1115), from
flat indices formed once per update; the JAX package streams the whole
table with one-hot weights instead because gathers are slow on the TPU.
The divisions by constants are products with the float32 reciprocal and
the cumulative sums take XLA's order (``ops/pointwise``), as the JAX
package's compiled wind update computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from . import pointwise as pw
from .pointwise import inv

SMALL = 1e-15
# table entries built at once (a chunk's FFT workspace: ~6 complex
# temporaries of entries x heights x the buffered grid)
CHUNK = 24


# ---------------------------------------------------------------------------
# host copies (numpy)
# ---------------------------------------------------------------------------


def add_buffer_topo(terrain: np.ndarray, smooth_window: int, buffer: int) -> np.ndarray:
    """Copy of icar_tpu/ops/linear_winds.py: a blended, smoothed buffer
    ring around the terrain (add_buffer_topo, linear_winds.f90:351-418);
    ``terrain`` (ny, nx) gives (ny+2b, nx+2b)."""
    ny, nx = terrain.shape
    NX, NY = nx + 2 * buffer, ny + 2 * buffer
    out = np.full((NY, NX), terrain.min(), dtype=np.float64)
    out[buffer:NY - buffer, buffer:NX - buffer] = terrain
    # blend left/right edges toward each other (x direction first)
    for i in range(1, buffer + 1):
        w = i / (buffer * 2.0)
        pos = buffer - i
        out[buffer:NY - buffer, pos] = terrain[:, 0] * (1 - w) + terrain[:, -1] * w
        out[buffer:NY - buffer, NX - 1 - pos] = terrain[:, 0] * w + terrain[:, -1] * (1 - w)
    # then blend top/bottom using the already-extended columns
    for i in range(1, buffer + 1):
        w = i / (buffer * 2.0)
        pos = buffer - i
        out[pos, :] = out[buffer, :] * (1 - w) + out[NY - buffer - 1, :] * w
        out[NY - 1 - pos, :] = out[buffer, :] * w + out[NY - buffer - 1, :] * (1 - w)
    # smooth the buffer ring, with window growing away from the real terrain
    if smooth_window > 0:
        for j in range(1, buffer + 1):
            win = min(j, smooth_window)
            padded = out.copy()
            for i in range(NX):
                xs, xe = max(0, i - win), min(NX, i + win + 1)
                row = buffer - j
                ys, ye = max(0, row - win), min(NY, row + win + 1)
                out[row, i] = padded[ys:ye, xs:xe].mean()
                row = NY - 1 - (buffer - j)
                ys, ye = max(0, row - win), min(NY, row + win + 1)
                out[row, i] = padded[ys:ye, xs:xe].mean()
            padded = out.copy()
            for i in range(NY):
                col = buffer - j
                xs, xe = max(0, col - win), min(NX, col + win + 1)
                ys, ye = max(0, i - win), min(NY, i + win + 1)
                out[i, col] = padded[ys:ye, xs:xe].mean()
                col = NX - 1 - (buffer - j)
                xs, xe = max(0, col - win), min(NX, col + win + 1)
                out[i, col] = padded[ys:ye, xs:xe].mean()
    return out


def fourier_terrain(terrain: np.ndarray, buffer: int, smooth_window: int = 5):
    """Copy of icar_tpu/ops/linear_winds.py, returning numpy: the two-pass
    buffered terrain's normalized, fftshifted FFT (setup_linwinds,
    linear_winds.f90:1180-1230). Returns (Fzs complex64, total_buffer)."""
    first = add_buffer_topo(terrain, smooth_window, buffer)
    second = add_buffer_topo(first, 0, 2)
    total_buffer = buffer + 2
    ny, nx = second.shape
    fzs = np.fft.fftshift(np.fft.fft2(second)) / (nx * ny)
    return np.asarray(fzs, np.complex64), total_buffer


def wavenumber_grids(NY: int, NX: int, dx: float):
    """Copy of icar_tpu/ops/linear_winds.py, returning numpy float32: the
    exact fftshifted angular wavenumber grids (the JAX package's deliberate
    divergence from linear_winds.f90:455-468, which misplaces the zero
    wavenumber by half a bin)."""
    k = 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(NX, d=dx))
    l = 2 * np.pi * np.fft.fftshift(np.fft.fftfreq(NY, d=dx))
    k2d = np.broadcast_to(k[None, :], (NY, NX))
    l2d = np.broadcast_to(l[:, None], (NY, NX))
    kl = k2d ** 2 + l2d ** 2
    kl = np.where(kl == 0, SMALL, kl)
    return (np.asarray(k2d, np.float32), np.asarray(l2d, np.float32),
            np.asarray(kl, np.float32))


def lut_size_bytes(lt, nz: int, ny: int, nx: int) -> int:
    """Copy of icar_tpu/ops/linear_winds.py: the spatial LUT's footprint in
    bytes, both wind components, float32 (linear_winds.f90:664-682)."""
    E = lt.n_spd_values * lt.n_dir_values * lt.n_nsq_values
    return 4 * E * nz * (ny * (nx + 1) + (ny + 1) * nx)


def check_lut_budget(lt, nz: int, ny: int, nx: int, n_devices: int = 1,
                     chunk: int = 24):
    """Copy of icar_tpu/ops/linear_winds.py: print the LUT's footprint
    (linear_winds.f90:682) and raise ValueError when a device's share
    exceeds lt.max_lut_gb or a chunk's build workspace lt.max_host_gb."""
    total = lut_size_bytes(lt, nz, ny, nx)
    if str(getattr(lt, "lut_dtype", "float32")) == "bfloat16":
        total //= 2
    per_dev = total / max(n_devices, 1)
    NYb = ny + 2 * (lt.buffer + 2)
    NXb = nx + 2 * (lt.buffer + 2)
    # ~6 live complex64 spectral temporaries + the cropped f32 chunk pair
    host_peak = chunk * (6 * NYb * NXb * 8 + 2 * nz * ny * nx * 4)
    print(f"Linear-theory spatial LUT: {total / 2**20:.1f} MB total "
          f"({lt.n_spd_values}x{lt.n_dir_values}x{lt.n_nsq_values} "
          f"entries, {getattr(lt, 'lut_dtype', 'float32')}), "
          f"{per_dev / 2**20:.1f} MB per device "
          f"across {n_devices} device(s); host build peak "
          f"~{host_peak / 2**20:.0f} MB per {chunk}-entry chunk")
    if per_dev > lt.max_lut_gb * 2**30:
        raise ValueError(
            f"linear-theory spatial LUT needs {per_dev / 2**30:.1f} GB per "
            f"device (> max_lut_gb={lt.max_lut_gb}); reduce n_spd_values/"
            f"n_dir_values/n_nsq_values (lt_parameters), shard over more "
            f"devices, use lut_dtype='bfloat16', or raise max_lut_gb if "
            f"the device memory allows")
    max_host = getattr(lt, "max_host_gb", 16.0)
    if host_peak > max_host * 2**30:
        raise ValueError(
            f"linear-theory LUT build needs ~{host_peak / 2**30:.1f} GB of "
            f"host workspace per chunk (> max_host_gb={max_host}); the "
            f"domain's buffered FFT grid is too large for the host — "
            f"reduce the domain or raise max_host_gb")
    return total


def table_values(lt):
    """Copy of icar_tpu/ops/linear_winds.py: the (spd, dir, nsq) axis
    values (linear_space calls, linear_winds.f90:655-661)."""
    spd = np.linspace(lt.spdmin, lt.spdmax, lt.n_spd_values)
    dirv = np.linspace(lt.dirmin, lt.dirmax, lt.n_dir_values)
    nsq = np.linspace(lt.nsqmin, lt.nsqmax, lt.n_nsq_values)
    return spd.astype(np.float32), dirv.astype(np.float32), nsq.astype(np.float32)


def _lut_params(lt):
    """Copy of icar_tpu/ops/linear_winds.py: the parameters a cache is
    validated against."""
    return np.array([lt.spdmin, lt.spdmax, lt.dirmin, lt.dirmax,
                     lt.nsqmin, lt.nsqmax, lt.n_spd_values,
                     lt.n_dir_values, lt.n_nsq_values, lt.buffer],
                    np.float64)


def _lut_sidecars(path):
    """Copy of icar_tpu/ops/linear_winds.py: the cache's .u.npy and .v.npy
    file names."""
    base = str(path)
    for suf in (".npz", ".nc"):
        if base.endswith(suf):
            base = base[:-len(suf)]
    return base + ".u.npy", base + ".v.npy"


def open_lut_writer(path, E: int, nz: int, ny: int, nx: int,
                    dz_levels, lt):
    """Copy of icar_tpu/ops/linear_winds.py: open the chunked disk cache
    for writing (memmapped sidecars and a meta .npz, lt_lut_io.f90)."""
    upath, vpath = _lut_sidecars(path)
    u_mm = np.lib.format.open_memmap(
        upath, mode="w+", dtype=np.float32, shape=(E, nz, ny, nx + 1))
    v_mm = np.lib.format.open_memmap(
        vpath, mode="w+", dtype=np.float32, shape=(E, nz, ny + 1, nx))
    np.savez(path, dz_levels=np.asarray(dz_levels), params=_lut_params(lt),
             sidecar=np.array(1.0))
    return u_mm, v_mm


def _load_lut_meta(path, dz_levels, lt):
    """Copy of icar_tpu/ops/linear_winds.py: the cache's meta data, None
    unless its parameters and levels are ``lt``'s and ``dz_levels``."""
    try:
        d = np.load(path)
    except (FileNotFoundError, OSError):
        return None
    want = _lut_params(lt)
    if d["params"].shape != want.shape or not np.allclose(d["params"], want):
        return None
    if (d["dz_levels"].shape != np.shape(dz_levels)
            or not np.allclose(d["dz_levels"], dz_levels)):
        return None
    return d


def load_lut_chunks(path, dz_levels, lt, chunk: int = 24):
    """Copy of icar_tpu/ops/linear_winds.py: a generator of (entry slice,
    u chunk, v chunk) over a cached LUT, or None on any parameter
    mismatch."""
    d = _load_lut_meta(path, dz_levels, lt)
    if d is None:
        return None
    if "sidecar" in d:
        upath, vpath = _lut_sidecars(path)
        try:
            u_mm = np.load(upath, mmap_mode="r")
            v_mm = np.load(vpath, mmap_mode="r")
        except (FileNotFoundError, OSError):
            return None
    elif "lut_u" in d:
        u_mm, v_mm = d["lut_u"], d["lut_v"]        # legacy format
    else:
        return None

    def gen():
        E = u_mm.shape[0]
        for s in range(0, E, chunk):
            e = slice(s, min(s + chunk, E))
            yield e, np.asarray(u_mm[e]), np.asarray(v_mm[e])
    return gen()


def save_lut(path, lut_u, lut_v, dz_levels, lt):
    """Copy of icar_tpu/ops/linear_winds.py: write a whole table (numpy
    arrays) to the disk cache."""
    E, nz = np.shape(lut_u)[0], np.shape(lut_u)[1]
    ny, nx = np.shape(lut_v)[2] - 1, np.shape(lut_v)[3]
    u_mm, v_mm = open_lut_writer(path, E, nz, ny, nx, dz_levels, lt)
    u_mm[:] = np.asarray(lut_u)
    v_mm[:] = np.asarray(lut_v)
    u_mm.flush()
    v_mm.flush()


# ---------------------------------------------------------------------------
# the analytic solution and the table build, on the device
# ---------------------------------------------------------------------------


class Spectrum:
    """The buffered terrain's spectrum and wavenumbers on ``device``:
    ``fourier_terrain`` and ``wavenumber_grids`` computed on the host as
    the JAX package computes them, moved once. ``fzs`` is complex64, ``k``,
    ``l``, ``kl`` float32 (NY, NX); ``buffer`` the total buffer width."""

    def __init__(self, terrain, dx: float, buffer: int, device):
        fzs, self.buffer = fourier_terrain(np.asarray(terrain), buffer)
        k, l, kl = wavenumber_grids(fzs.shape[0], fzs.shape[1], dx)
        self.fzs = torch.as_tensor(fzs, device=device)
        self.k, self.l, self.kl = (torch.as_tensor(a, device=device)
                                   for a in (k, l, kl))
        self.device = torch.device(device)


def layer_heights(dz_levels, minimum_layer_size: float = 100.0):
    """For each level, the float32 heights at which its layer mean is
    sampled (linear_perturbation_constz, linear_winds.f90:242-282): n_steps
    midpoints through the layer, formed as the JAX package's build forms
    them."""
    z_bot = np.concatenate([[0.0], np.cumsum(dz_levels[:-1])]).astype(np.float32)
    z_top = np.cumsum(dz_levels).astype(np.float32)
    n_steps = [max(1, int(np.ceil(dz / minimum_layer_size)))
               for dz in dz_levels]
    out = []
    for zi, n in enumerate(n_steps):
        step = (z_top[zi] - z_bot[zi]) / n
        out.append(np.array([np.float32(z_bot[zi] + step * (i + 0.5))
                             for i in range(n)], np.float32))
    return out


def _cmul(ar, ai, br, bi):
    """(ar + i ai) (br + i bi) in real arithmetic."""
    return ar * br - ai * bi, ar * bi + ai * br


class EntryBatch:
    """The z-independent factors of the analytic solution for a batch of
    background winds (u, v) and N^2, (B,) float32 tensors
    (linear_perturbation_at_height, linear_winds.f90:181-237):
        m = sqrt(Nsq*(k^2+l^2)/sigma^2) * sign(sigma) [imaginary if msq<0]
        ineta = i * Fzs * exp(i m z) * (-m) * sigma / kl
    in the order of the JAX package's perturbation_at_height_np."""

    def __init__(self, spec: Spectrum, u, v, nsq):
        u, v, nsq = (a.view(-1, 1, 1, 1) for a in (u, v, nsq))
        sig = u * spec.k + v * spec.l
        sig = torch.where(sig == 0, torch.tensor(np.float32(SMALL),
                                                 device=sig.device), sig)
        msq = nsq / (sig ** 2) * spec.kl
        root = torch.sqrt(torch.abs(msq))
        prop = msq >= 0
        zero = torch.zeros((), device=sig.device)
        self.mr = torch.where(prop, root * torch.sign(sig), zero)
        self.mi = torch.where(prop, zero, root)
        # (0 - m) * sigma
        self.gr, self.gi = (0 - self.mr) * sig, (0 - self.mi) * sig
        # 1j * Fzs
        self.fr, self.fi = -spec.fzs.imag, spec.fzs.real
        self.zero = (u == 0) & (v == 0)
        self.spec = spec

    def layer_mean(self, heights):
        """(u', v') averaged over ``heights`` (float32 numpy): two
        (B, NY, NX) float32 tensors, uncropped."""
        spec = self.spec
        z = torch.as_tensor(heights, device=spec.device).view(1, -1, 1, 1)
        # exp(1j * m * z)
        arg = torch.complex((0 - self.mi) * z, self.mr * z)
        e = torch.exp(arg)
        re, im = _cmul(self.fr, self.fi, e.real, e.imag)
        re, im = _cmul(re, im, self.gr, self.gi)
        re, im = re / spec.kl, im / spec.kl
        NY, NX = spec.kl.shape
        scale = torch.tensor(np.float32(NX * NY), device=spec.device)
        out = []
        for w in (spec.k, spec.l):
            hat = torch.fft.ifftshift(torch.complex(w * re, w * im),
                                      dim=(-2, -1))
            p = torch.fft.ifft2(hat).real * scale
            p = torch.where(self.zero, 0.0, p)
            acc = p[:, 0]
            for h in range(1, p.shape[1]):
                acc = acc + p[:, h]
            out.append(acc / torch.tensor(np.float32(p.shape[1]),
                                          device=spec.device))
        return out[0], out[1]


def crop_stagger(up, vp, buffer: int):
    """Crop the buffer off layer fields (B, NY, NX) and stagger them onto
    the u and v grids (linear_winds.f90:765-773): (B, ny, nx+1) and
    (B, ny+1, nx)."""
    NY, NX = up.shape[-2:]
    b = buffer
    u = (up[:, b:NY - b, b - 1:NX - b] + up[:, b:NY - b, b:NX - b + 1]) * 0.5
    v = (vp[:, b - 1:NY - b, b:NX - b] + vp[:, b:NY - b + 1, b:NX - b]) * 0.5
    return u, v


def table_winds(lt):
    """(u, v, N^2) of every table entry as float32 numpy, in the order
    e = (s*n_dir + d)*n_nsq + n (calc_u, calc_v; the reference's
    hi_u_LUT(spos,dpos,npos,...) flat order)."""
    spd, dirv, nsq_log = table_values(lt)
    ss, dd, nn = np.meshgrid(spd, dirv, nsq_log, indexing="ij")
    u_e = (np.sin(dd) * ss).ravel().astype(np.float32)   # calc_u
    v_e = (np.cos(dd) * ss).ravel().astype(np.float32)   # calc_v
    nsq_e = np.exp(nn).ravel().astype(np.float32)
    return u_e, v_e, nsq_e


def build_lut_chunks(terrain: np.ndarray, dx: float, dz_levels, lt, device,
                     minimum_layer_size: float = 100.0, chunk: int = CHUNK,
                     entries=None):
    """Generator over the spatial wind LUT built on ``device``: yields
    (e, u_chunk (B, nz, ny, nx+1), v_chunk (B, nz, ny+1, nx)) float32
    tensors, ``e`` the entries' slice of the table, or with ``entries``
    (indices into the table) the chunk's indices. Each chunk is a batch of
    B entries; each level's heights are one batch of inverse FFTs."""
    ny, nx = terrain.shape
    nz = len(dz_levels)
    spec = Spectrum(terrain, dx, lt.buffer, device)
    u_e, v_e, nsq_e = table_winds(lt)
    heights = layer_heights(dz_levels, minimum_layer_size)
    ids = np.arange(u_e.size) if entries is None else np.asarray(entries)
    for s in range(0, ids.size, chunk):
        sel = ids[s:s + chunk]
        ent = EntryBatch(spec, *(torch.as_tensor(a[sel], device=spec.device)
                               for a in (u_e, v_e, nsq_e)))
        u_c = torch.empty((sel.size, nz, ny, nx + 1), device=spec.device)
        v_c = torch.empty((sel.size, nz, ny + 1, nx), device=spec.device)
        for zi in range(nz):
            up, vp = ent.layer_mean(heights[zi])
            u_c[:, zi], v_c[:, zi] = crop_stagger(up, vp, spec.buffer)
        yield (slice(s, s + sel.size) if entries is None else sel), u_c, v_c


def place_lut_chunks(chunk_iter, E: int, nz: int, ny: int, nx: int,
                     device, dtype=torch.float32, writer=None):
    """The table on ``device`` in ``dtype`` (float32 or bfloat16, rounded
    to nearest even), filled chunk by chunk from ``chunk_iter`` (device
    tensors or numpy chunks of a cache); ``writer``, a pair of memmap-like
    arrays, also receives each float32 chunk (the disk cache)."""
    bufs = (torch.zeros((E, nz, ny, nx + 1), dtype=dtype, device=device),
            torch.zeros((E, nz, ny + 1, nx), dtype=dtype, device=device))
    for e, u_c, v_c in chunk_iter:
        for buf, ch, i in ((bufs[0], u_c, 0), (bufs[1], v_c, 1)):
            if not torch.is_tensor(ch):
                ch = torch.from_numpy(np.array(ch, np.float32))
            ch = ch.to(device=device, dtype=torch.float32)
            if writer is not None:
                writer[i][e] = ch.cpu().numpy()
            buf[e] = ch.to(dtype)
    return bufs


def build_lut(terrain: np.ndarray, dx: float, dz_levels, lt, device,
              minimum_layer_size: float = 100.0, chunk: int = CHUNK):
    """The whole float32 table on ``device``: (lut_u (E, nz, ny, nx+1),
    lut_v (E, nz, ny+1, nx), (spd, dir, nsq) values)."""
    ny, nx = terrain.shape
    E = lt.n_spd_values * lt.n_dir_values * lt.n_nsq_values
    lut_u, lut_v = place_lut_chunks(
        build_lut_chunks(terrain, dx, dz_levels, lt, device,
                         minimum_layer_size, chunk),
        E, len(dz_levels), ny, nx, device)
    return lut_u, lut_v, table_values(lt)


# ---------------------------------------------------------------------------
# stability (atm_utilities.f90:401-467)
# ---------------------------------------------------------------------------


def calc_sat_lapse_rate(t, mr):
    L = C.LH_VAPORIZATION
    return C.GRAVITY * ((1 + (L * mr) / (C.RD * t))
                        / (C.CP + (L * L * mr * (C.RD / C.RW)) / (C.RD * t * t)))


def calc_dry_stability(th_top, th_bot, z_top, z_bot):
    return C.GRAVITY * (pw.log(th_top) - pw.log(th_bot)) / (z_top - z_bot)


def calc_moist_stability(t_top, t_bot, z_top, z_bot, qv_top, qv_bot, qc):
    t = (t_top + t_bot) / 2
    qv = (qv_top + qv_bot) / 2
    dz = z_top - z_bot
    sat_lapse = calc_sat_lapse_rate(t, qv)
    return (pw.div(C.GRAVITY, t) * ((t_top - t_bot) / dz + sat_lapse)
            * (1 + (C.LH_VAPORIZATION * qv) / (C.RD * t))
            - (pw.div(C.GRAVITY, 1 + qv + qc) * (qv_top - qv_bot) / dz))


def _window(nz: int, vsmooth: int):
    """The clamped vertical window [bottoms, tops] of each level and the
    float32 reciprocal of its length (linear_winds.f90:963-976)."""
    tops = np.minimum(np.arange(nz) + vsmooth, nz - 1)
    bottoms = np.maximum(0, np.arange(nz) - (vsmooth - (tops - np.arange(nz))))
    counts = (tops - bottoms + 1).astype(np.float32)
    return tops, bottoms, np.float32(1.0) / counts


def _window_mean(a, tops, bottoms, inv_counts):
    """The mean of ``a`` (nz, ...) over each level's window, from the
    cumulative sum over the levels, the count's division folded."""
    dev = a.device
    csum = torch.cat([torch.zeros_like(a[:1]), pw.cumsum(a, 0)], dim=0)
    t = torch.as_tensor(tops + 1, device=dev)
    b = torch.as_tensor(bottoms, device=dev)
    w = torch.as_tensor(inv_counts, device=dev)
    return (csum[t] - csum[b]) * w.view(-1, *([1] * (a.dim() - 1)))


def compute_nsquared(theta, exner, z, qv, hydrometeors, vsmooth: int,
                     variable_n: bool, n_squared: float,
                     min_stability: float, max_stability: float,
                     smooth_nsq: bool, winsz: int):
    """Per-cell log Brunt-Vaisala frequency squared with vertical windowing
    and smoothing (spatial_winds, linear_winds.f90:917-982), (nz, ny, nx);
    icar_tpu/ops/linear_winds.py compute_nsquared as its compiled wind
    update computes it."""
    nz = theta.shape[0]
    tops, bottoms, inv_counts = _window(nz, vsmooth)
    if variable_n:
        ti = torch.as_tensor(tops, device=theta.device)
        bi = torch.as_tensor(bottoms, device=theta.device)
        th_t, th_b = theta[ti], theta[bi]
        dry = calc_dry_stability(th_t, th_b, z[ti], z[bi])
        moist = calc_moist_stability(th_t * exner[ti], th_b * exner[bi],
                                     z[ti], z[bi], qv[ti], qv[bi],
                                     hydrometeors)
        nsq = torch.where(hydrometeors < 1e-7, dry, moist)
    else:
        nsq = torch.where(hydrometeors < 1e-7,
                          torch.full_like(theta, n_squared),
                          torch.full_like(theta, n_squared / 10.0))
    nsq = pw.log(torch.clamp(nsq, min_stability, max_stability))
    if smooth_nsq:
        nsq = _window_mean(nsq, tops, bottoms, inv_counts)
        nsq = _box_smooth_2d(nsq, winsz)
    return nsq


def _box_smooth_2d(a, w: int):
    """Separable (2w+1) box filter with replicate padding over the last two
    dims (smooth_array, array_utilities.f90), from cumulative sums."""
    if w <= 0:
        return a
    p = torch.nn.functional.pad(a[None], (w, w, w, w), mode="replicate")[0]
    c = inv(2 * w + 1)
    cs = pw.cumsum(p, -2)
    zero = torch.zeros_like(cs[..., :1, :])
    ys = (cs[..., 2 * w:, :] - torch.cat([zero, cs[..., :-2 * w - 1, :]],
                                         dim=-2)) * c
    cs = pw.cumsum(ys, -1)
    zero = torch.zeros_like(cs[..., :, :1])
    return (cs[..., :, 2 * w:] - torch.cat([zero, cs[..., :, :-2 * w - 1]],
                                           dim=-1)) * c


# ---------------------------------------------------------------------------
# runtime lookup (spatial_winds)
# ---------------------------------------------------------------------------


def _position(values, x):
    """Largest index with values[idx] < x, min 0 (the reference's linear
    scan 'if cur > values(step): pos = step', linear_winds.f90:1048-1076)."""
    idx = torch.searchsorted(values, x.contiguous(), right=False) - 1
    return torch.clamp(idx, 0, values.shape[0] - 1)


def _weight(values, pos, x):
    """Interpolation weight + next position (calc_weight,
    array_utilities.f90:263-288)."""
    n = values.shape[0]
    nextpos = torch.clamp(pos + 1, max=n - 1)
    vals_next = values[nextpos]
    vals_pos = values[pos]
    w = torch.where(pos == n - 1, 1.0,
                    (vals_next - x) / torch.where(vals_next == vals_pos, 1.0,
                                                  vals_next - vals_pos))
    below = x < values[0]
    w = torch.where(below, 1.0, w)
    nextpos = torch.where(below, 0, nextpos)
    return w, nextpos


def corners(values, x):
    """The two (table index, weight) pairs of ``x`` on one table axis:
    its position with the weight w and the next with 1 - w. At the table's
    edges (position == next) both weights fall on the one entry, as the
    JAX package's one-hot stream adds them."""
    pos = _position(values, x)
    w, nxt = _weight(values, pos, x)
    same = pos == nxt
    return ((pos, torch.where(same, w + (1 - w), w)),
            (nxt, torch.where(same, 0.0, 1 - w)))


def interp_lut(lut, s, d, n, n_dir: int, n_nsq: int):
    """Trilinear interpolation of the (spd, dir, nsq) table ``lut``
    (E, *shape) (linear_winds.f90:1083-1115): the 8 bracketing entries of
    each cell, read from the flat table and summed in float32 in ascending
    entry order (the order of the JAX package's stream). ``s``, ``d``,
    ``n`` are the ``corners`` of each axis, broadcasting to ``shape``."""
    shape = lut.shape[1:]
    plane = int(np.prod(shape))
    flat = lut.reshape(-1)
    cell = torch.arange(plane, device=lut.device).view(shape)
    acc = None
    for si, sw in s:
        for di, dw in d:
            sd = (si * n_dir + di) * n_nsq
            wsd = sw * dw
            for ni, nw in n:
                term = (flat.take((sd + ni) * plane + cell).float()
                        * (wsd * nw))
                acc = term if acc is None else acc + term
    return acc


def calc_direction(u, v):
    """Wind direction in [0, 2pi) (calc_direction, atm_utilities.f90:334-355)."""
    d = torch.atan2(u, v)
    return torch.where(d < 0, d + 2 * np.pi, d)


def _level_mean(a):
    """The mean over the levels, summed level by level and scaled by the
    float32 reciprocal of their count (XLA's reduction at these depths)."""
    acc = a[0]
    for k in range(1, a.shape[0]):
        acc = acc + a[k]
    return acc * inv(a.shape[0])


def apply_spatial_winds(u3d, v3d, nsq_log, pert_u, pert_v, lut_u, lut_v,
                        spd_values, dir_values, nsq_values, vsmooth: int,
                        linear_update_fraction: float,
                        linear_contribution: float):
    """Interpolate the LUT at each cell's (speed, direction, N^2), relax the
    stored perturbation toward it, and add it to u/v (spatial_winds,
    linear_winds.f90:996-1122).

    Shapes: u3d (nz, ny, nx+1), v3d (nz, ny+1, nx), nsq_log (nz, ny, nx),
    pert_u like u3d, pert_v like v3d, lut_u (E, nz, ny, nx+1), lut_v
    (E, nz, ny+1, nx) in float32 or bfloat16; the axis values float32
    tensors. Returns (u3d, v3d, pert_u, pert_v)."""
    nz, ny, nxu = u3d.shape
    nx = v3d.shape[2]
    n_dir, n_nsq = dir_values.shape[0], nsq_values.shape[0]

    # vertically averaged background wind per column on the union grid
    # (linear_winds.f90:996-1001): clamp-pad the staggered extra row/col
    u_col = _level_mean(u3d)                             # (ny, nx+1)
    v_col = _level_mean(v3d)                             # (ny+1, nx)
    u_union = torch.cat([u_col, u_col[-1:, :]], dim=0)   # (ny+1, nx+1)
    v_union = torch.cat([v_col, v_col[:, -1:]], dim=1)   # (ny+1, nx+1)
    curdir = calc_direction(u_union, v_union)
    curspd = torch.sqrt(u_union ** 2 + v_union ** 2)

    # N^2 window mean per level (linear_winds.f90:1070-1071), clamp-padded
    # to the union grid (vi = min(i, nx), uk = min(k, ny))
    curnsq = _window_mean(nsq_log, *_window(nz, vsmooth))
    curnsq = torch.cat([curnsq, curnsq[:, -1:, :]], dim=1)
    curnsq = torch.cat([curnsq, curnsq[:, :, -1:]], dim=2)  # (nz, ny+1, nx+1)

    s = corners(spd_values, curspd)
    d = corners(dir_values, curdir)
    n = corners(nsq_values, curnsq)

    def on(axis, rows, cols):
        return tuple((i[..., rows, cols], w[..., rows, cols])
                     for i, w in axis)

    full = slice(None)
    up_new = interp_lut(lut_u, on(s, slice(0, ny), full),
                        on(d, slice(0, ny), full), on(n, slice(0, ny), full),
                        n_dir, n_nsq)
    vp_new = interp_lut(lut_v, on(s, full, slice(0, nx)),
                        on(d, full, slice(0, nx)), on(n, full, slice(0, nx)),
                        n_dir, n_nsq)

    f = linear_update_fraction
    pert_u = pert_u * (1 - f) + f * up_new
    pert_v = pert_v * (1 - f) + f * vp_new
    u3d = u3d + pert_u * linear_contribution
    v3d = v3d + pert_v * linear_contribution
    return u3d, v3d, pert_u, pert_v

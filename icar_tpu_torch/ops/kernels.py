"""The port's hand-written CUDA kernels: build, load, wrappers and launch
counts (the counterpart of icar_tpu/ops/pallas_kernels.py).

The kernels live in ``icar_tpu_torch/csrc/*.cu``, are compiled by ``nvcc``
for ``sm_90a`` (one process per source, all started together) and linked
into one shared library with a plain C interface, called through
``ctypes`` on PyTorch's current CUDA stream. The library is built at the
first launch (never at import) into ``icar_tpu_torch/_build/`` and rebuilt
when the sources change.

Each wrapper takes the plain PyTorch version for a tensor on the CPU, and
launches its kernel for a CUDA tensor; there is no fallback from one to the
other. ``LAUNCHES`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .. import constants as C
from ..physics import mp_simple as mp_plain
from ..physics import mp_thompson as thompson_plain
from . import advection as adv_plain
from . import mpdata as mpdata_plain

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("advect_upwind.cu", "mp_simple.cu", "mpdata.cu",
           "mp_thompson.cu", "upwind_floor.cu", "density_fold.cu")
HEADERS = ("upwind.cuh",)
# -fmad=false: no multiply-add contraction, so each kernel rounds like its
# plain version step by step (the ridge trajectory branches on one-ulp
# differences, see PERF.md); no --use_fast_math, so expf stays accurate
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the most levels each kernel takes: the MAX_NZ of csrc/mpdata.cu (K4),
# and for K2/K3 and K5 the deepest column whose one-column tile fits a
# block's shared memory (icar_mp_simple_max_nz, icar_mp_thompson_max_nz);
# K1 has no limit. Kept here so that a model can be refused before the
# library is built; the CPU tests hold these to the sources.
MAX_NZ = {"advect_upwind": None, "mp_simple": 5810, "mp_simple_rho": 5810,
          "advect_mpdata": 64, "mp_thompson": 1565, "density_fold": None}

# calls that launched a kernel since the last reset (K4's and K5's calls
# are each one sequence of launches); only the kernel branch counts
LAUNCHES = {"advect_upwind": 0, "mp_simple": 0, "mp_simple_rho": 0,
            "advect_mpdata": 0, "mp_thompson": 0, "density_fold": 0}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_levels(path, nz: int):
    """Raise ValueError if a kernel of ``path`` (names of LAUNCHES) takes
    fewer than ``nz`` levels."""
    for name in path:
        limit = MAX_NZ[name]
        if limit is not None and nz > limit:
            raise ValueError(f"nz={nz} exceeds the {limit} levels kernel "
                             f"{name} takes on the card")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                           "CUDA kernels of icar_tpu_torch cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/`` unless a library built from
    the same sources and flags is already there; returns its path and
    records the build time and compiler log (kept beside the library, so
    a cached build has it too) in ``BUILD_INFO``. Each source compiles in
    its own nvcc process, all at once, then one link."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"libicar_kernels_{h.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True, log=log)
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(n).stem}.{tag}.o" for n in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o",
                               str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(n, p.returncode, log) for n, p, log
              in zip(SOURCES, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{n} ({rc}):\n{log}" for n, rc, log in failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(o) for o in objs)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    log = "".join(logs) + res.stdout + res.stderr
    log_path.write_text(log)
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False, log=log)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                      ctypes.c_float)
        lib.icar_advect_upwind.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                           I, F, I, P]
        lib.icar_advect_upwind.restype = I
        lib.icar_advect_upwind_config.argtypes = [I, P]
        lib.icar_advect_upwind_config.restype = I
        lib.icar_advect_upwind_floor.argtypes = [P] * 7 + [I, I, I, I, P]
        lib.icar_advect_upwind_floor.restype = I
        lib.icar_mp_simple.argtypes = [P, P, P, P, P, P, P, P, P, P, I, L,
                                       F, F, F, P]
        lib.icar_mp_simple.restype = I
        lib.icar_mp_simple_rho.argtypes = [P, P, P, P, P, P, P, P, P, P, P,
                                           I, L, F, F, F, P]
        lib.icar_mp_simple_rho.restype = I
        lib.icar_advect_mpdata.argtypes = [P, P, P, P, P, P, P, P, P, I, I,
                                           I, I, F, I, I, I, P]
        lib.icar_advect_mpdata.restype = I
        lib.icar_advect_mpdata_max_nz.argtypes = []
        lib.icar_advect_mpdata_max_nz.restype = I
        lib.icar_mpdata_div.argtypes = [P, P, P, L, P]
        lib.icar_mpdata_div.restype = I
        lib.icar_mp_simple_max_nz.argtypes = []
        lib.icar_mp_simple_max_nz.restype = I
        lib.icar_mp_simple_tile_columns.argtypes = [I]
        lib.icar_mp_simple_tile_columns.restype = I
        lib.icar_mp_simple_smem_bytes.argtypes = [I]
        lib.icar_mp_simple_smem_bytes.restype = L
        lib.icar_mp_simple_fall_tiles.argtypes = [P] * 12 + [I, L, F, F, F,
                                                              P]
        lib.icar_mp_simple_fall_tiles.restype = I
        lib.icar_mp_thompson.argtypes = [P] * 18 + [I, L, F, P]
        lib.icar_mp_thompson.restype = I
        lib.icar_mp_thompson_max_nz.argtypes = []
        lib.icar_mp_thompson_max_nz.restype = I
        lib.icar_mp_thompson_tile_columns.argtypes = [I]
        lib.icar_mp_thompson_tile_columns.restype = I
        lib.icar_mp_thompson_smem_bytes.argtypes = [I]
        lib.icar_mp_thompson_smem_bytes.restype = L
        lib.icar_mp_thompson_n_consts.argtypes = []
        lib.icar_mp_thompson_n_consts.restype = I
        lib.icar_density_fold.argtypes = [P] * 9 + [I, I, I, P]
        lib.icar_density_fold.restype = I
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: upwind advection
# ---------------------------------------------------------------------------

class AdvectWinds(NamedTuple):
    """Loop-invariant advection operands for one interval: the raw winds
    and metrics (the plain version scales them per substep in the jnp
    order) and the kernel's metric winds u*J_u/dx, v*J_v/dx, w*J_w and
    jacobian (setup_module_winds, advect.f90:306-351, minus the dt
    factor). ``density_winds`` weights the kernel's four operands by the
    density and records it in ``rho`` for the plain version."""
    u: torch.Tensor        # (nz, ny, nx+1)
    v: torch.Tensor        # (nz, ny+1, nx)
    w: torch.Tensor        # (nz, ny, nx)
    jaco_u: torch.Tensor
    jaco_v: torch.Tensor
    jaco_w: torch.Tensor
    dz: torch.Tensor       # advection_dz (nz, ny, nx)
    jaco: torch.Tensor     # the kernel's (nz, ny, nx): J, or J*rho
    dx: float
    uj: torch.Tensor       # (nz, ny, nx-1) internal x faces
    vj: torch.Tensor       # (nz, ny-1, nx) internal y faces
    wj: torch.Tensor       # (nz, ny, nx)
    jaco_c: torch.Tensor   # J (nz, ny, nx), the plain version's
    rho: Optional[torch.Tensor] = None   # the density, with density_winds


def prepare_advect_winds(u, v, w, geom) -> AdvectWinds:
    """The advection operands for winds (u, v, w) on ``geom`` (torch
    geometry, ``convert.geometry_to_torch``)."""
    dx = float(geom.dx)
    uj = (u[:, :, 1:-1] * geom.jacobian_u[:, :, 1:-1]
          * (1.0 / dx)).contiguous()
    vj = (v[:, 1:-1, :] * geom.jacobian_v[:, 1:-1, :]
          * (1.0 / dx)).contiguous()
    wj = (w * geom.jacobian_w).contiguous()
    jaco = geom.jacobian.contiguous()
    return AdvectWinds(u, v, w, geom.jacobian_u, geom.jacobian_v,
                       geom.jacobian_w, geom.advection_dz.contiguous(),
                       jaco, dx, uj, vj, wj, jaco)


def density_winds(winds: AdvectWinds, rho) -> AdvectWinds:
    """``winds`` for density advection with the cell density ``rho`` (nz,
    ny, nx): the kernels' operands weighted as the JAX package weights
    them (icar_tpu/ops/advection.py:33-50, 83-84; mpdata.py:206) -- each
    face wind by the face mean of rho (``advection.face_density``: the
    top face takes the top layer's), the jacobian by rho -- so that K1 and
    K4 run unchanged on them. For CUDA tensors one launch of the fold
    kernel (``csrc/density_fold.cu``) forms them, for CPU tensors its
    plain version (``fold_plain``); the two give the same bits. The raw
    fields stay for the plain advection, which a CPU tensor takes with
    ``rho``."""
    if rho.device.type == "cpu":
        uj, vj, wj, jaco = fold_plain(winds, rho)
        return winds._replace(uj=uj, vj=vj, wj=wj, jaco=jaco, rho=rho)
    if rho.device.type != "cuda":
        raise ValueError(f"density_winds: unsupported device {rho.device}")
    nz, ny, nx = rho.shape
    dev = rho.device
    _check(rho, "rho", (nz, ny, nx), dev)
    _check(winds.uj, "uj", (nz, ny, nx - 1), dev)
    _check(winds.vj, "vj", (nz, ny - 1, nx), dev)
    for name in ("wj", "jaco_c"):
        _check(getattr(winds, name), name, (nz, ny, nx), dev)
    out = [torch.empty_like(t) for t in (winds.uj, winds.vj, winds.wj,
                                         winds.jaco_c)]
    err = library().icar_density_fold(
        rho.data_ptr(), winds.uj.data_ptr(), winds.vj.data_ptr(),
        winds.wj.data_ptr(), winds.jaco_c.data_ptr(),
        *(t.data_ptr() for t in out), nz, ny, nx,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "density_fold")
    LAUNCHES["density_fold"] += 1
    uj, vj, wj, jaco = out
    return winds._replace(uj=uj, vj=vj, wj=wj, jaco=jaco, rho=rho)


def fold_plain(winds: AdvectWinds, rho):
    """The density fold in plain PyTorch: (uj, vj, wj, jaco) weighted by
    the face means of ``rho`` and by ``rho``."""
    rho_u, rho_v, rho_w = adv_plain.face_density(rho)
    return (winds.uj * rho_u, winds.vj * rho_v, winds.wj * rho_w,
            winds.jaco_c * rho)


def advect_upwind(q, winds: AdvectWinds, dt, floors, near_end: bool,
                  out=None):
    """Donor-cell update of the species stack ``q`` (S, nz, ny, nx) for
    one substep of length ``dt`` into ``out`` (allocated when None; must
    not alias ``q``). ``floors`` (S,) float32 tensor: with ``near_end``
    each species is clamped to its floor. Returns ``out``."""
    S, nz, ny, nx = q.shape
    if q.device.type == "cpu":
        res = adv_plain.advect_upwind(q, winds.u, winds.v, winds.w, dt,
                                      winds.dx, winds.jaco_u, winds.jaco_v,
                                      winds.jaco_w, winds.jaco_c, winds.dz,
                                      floors=floors, near_end=near_end,
                                      rho=winds.rho,
                                      advect_density=winds.rho is not None)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"advect_upwind: unsupported device {q.device}")
    if nz < 2 or ny < 3 or nx < 3:
        raise ValueError(f"advect_upwind: needs nz >= 2, ny >= 3, nx >= 3, "
                         f"got {(nz, ny, nx)}")
    dev = q.device
    _check(q, "q", (S, nz, ny, nx), dev)
    _check(winds.uj, "uj", (nz, ny, nx - 1), dev)
    _check(winds.vj, "vj", (nz, ny - 1, nx), dev)
    for name in ("wj", "dz", "jaco"):
        _check(getattr(winds, name), name, (nz, ny, nx), dev)
    _check(floors, "floors", (S,), dev)
    if out is None:
        out = torch.empty_like(q)
    _check(out, "out", (S, nz, ny, nx), dev)
    if S == 0:
        return out   # an empty stack: nothing to launch
    if out.data_ptr() == q.data_ptr():
        raise ValueError("advect_upwind: out must not alias q")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().icar_advect_upwind(
        q.data_ptr(), out.data_ptr(), winds.uj.data_ptr(),
        winds.vj.data_ptr(), winds.wj.data_ptr(), winds.dz.data_ptr(),
        winds.jaco.data_ptr(), floors.data_ptr(), S, nz, ny, nx, float(dt),
        int(bool(near_end)), stream)
    _raise_on(err, "advect_upwind")
    LAUNCHES["advect_upwind"] += 1
    return out


UPWIND_CONFIG_KEYS = ("tile_x", "tile_y", "threads", "group", "smem_bytes",
                      "blocks_per_sm")


def upwind_config(S: int) -> dict:
    """K1's launch for a stack of ``S`` species on the current card: its
    tile (columns along x and y), threads per block, the species a block
    marches together, dynamic shared memory and resident blocks per
    multiprocessor."""
    cfg = (ctypes.c_int * len(UPWIND_CONFIG_KEYS))()
    _raise_on(library().icar_advect_upwind_config(int(S), cfg),
              "advect_upwind config")
    return dict(zip(UPWIND_CONFIG_KEYS, list(cfg)))


def advect_upwind_floor(q, winds: AdvectWinds, out):
    """The copy-floor probe on CUDA tensors (``csrc/upwind_floor.cu``): K1's
    bytes moved with no stencil, ``out`` = ``q``. A measurement, not a step
    of any path: its launch is not counted in ``LAUNCHES``."""
    S, nz, ny, nx = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"advect_upwind_floor: unsupported device "
                         f"{q.device}")
    for name, t in (("q", q), ("out", out)):
        _check(t, name, (S, nz, ny, nx), q.device)
    _check(winds.uj, "uj", (nz, ny, nx - 1), q.device)
    _check(winds.vj, "vj", (nz, ny - 1, nx), q.device)
    for name in ("wj", "dz", "jaco"):
        _check(getattr(winds, name), name, (nz, ny, nx), q.device)
    err = library().icar_advect_upwind_floor(
        q.data_ptr(), out.data_ptr(), winds.uj.data_ptr(),
        winds.vj.data_ptr(), winds.wj.data_ptr(), winds.dz.data_ptr(),
        winds.jaco.data_ptr(), S, nz, ny, nx,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "advect_upwind_floor")
    return out


# ---------------------------------------------------------------------------
# K2: SB04 microphysics
# ---------------------------------------------------------------------------

def mp_simple(theta, qv, qc, qr, qs, pressure, exner, dz, rain, snow, dt,
              cloud2rain, cloud2snow):
    """SB04 microphysics, in place: updates the five species (nz, ny, nx)
    and adds the surface precipitation of this call to the (ny, nx)
    ``rain``/``snow`` accumulators. Density is p/(Rd*theta*exner) from the
    entry state; ``dz`` is the mass-level thickness (dz_interface)."""
    if theta.device.type == "cpu":
        rho = pressure / (C.RD * (theta * exner))
        _mp_plain(theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain,
                  snow, dt, cloud2rain, cloud2snow)
        return
    _mp_kernel("mp_simple", theta, qv, qc, qr, qs, pressure, exner, None,
               dz, rain, snow, dt, cloud2rain, cloud2snow)


# ---------------------------------------------------------------------------
# K3: SB04 microphysics with the density as an operand
# ---------------------------------------------------------------------------

def mp_simple_rho(theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain,
                  snow, dt, cloud2rain, cloud2snow):
    """``mp_simple`` with the density ``rho`` (nz, ny, nx) given, as the
    general interval loop passes the state's density: the scheme reads
    whatever ``rho`` holds."""
    if theta.device.type == "cpu":
        _mp_plain(theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain,
                  snow, dt, cloud2rain, cloud2snow)
        return
    _mp_kernel("mp_simple_rho", theta, qv, qc, qr, qs, pressure, exner, rho,
               dz, rain, snow, dt, cloud2rain, cloud2snow)


def _mp_plain(theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain, snow,
              dt, cloud2rain, cloud2snow):
    out = mp_plain.mp_simple(pressure, theta, exner, rho, qv, qc, qr, qs,
                             rain, snow, dt, dz, cloud2rain, cloud2snow)
    for dst, src in zip((theta, qv, qc, qr, qs, rain, snow), out):
        dst.copy_(src)


def mp_simple_fall_tiles(theta, qv, qc, qr, qs, pressure, exner, dz, rain,
                         snow, dt, cloud2rain, cloud2snow, rho=None):
    """``mp_simple`` (``rho`` None) or ``mp_simple_rho`` on CUDA tensors,
    counting the column tiles that ran each fall loop: returns (tiles that
    ran the rain loop, the snow loop, all tiles). A measurement, not a
    step of any path: its launch is not counted in ``LAUNCHES``."""
    counts = torch.zeros(2, dtype=torch.int32, device=theta.device)
    _mp_kernel("mp_simple" if rho is None else "mp_simple_rho", theta, qv,
               qc, qr, qs, pressure, exner, rho, dz, rain, snow, dt,
               cloud2rain, cloud2snow, counts)
    nz, ny, nx = theta.shape
    cols = library().icar_mp_simple_tile_columns(nz)
    rain_tiles, snow_tiles = counts.tolist()
    return rain_tiles, snow_tiles, -(-(ny * nx) // cols)


def _mp_kernel(name, theta, qv, qc, qr, qs, pressure, exner, rho, dz, rain,
               snow, dt, cloud2rain, cloud2snow, fall_tiles=None):
    """Launch K2 (``rho`` None) or K3 on CUDA tensors; with ``fall_tiles``
    (two int32 zeros on the card) count the tiles that ran each fall loop
    there instead of counting the launch."""
    nz, ny, nx = theta.shape
    if theta.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {theta.device}")
    dev = theta.device
    lib = library()
    if lib.icar_mp_simple_tile_columns(nz) == 0:
        raise ValueError(f"{name}: nz={nz} exceeds the kernel's "
                         f"maximum {lib.icar_mp_simple_max_nz()}")
    fields = [("theta", theta), ("qv", qv), ("qc", qc), ("qr", qr),
              ("qs", qs), ("pressure", pressure), ("exner", exner),
              ("dz", dz)]
    if rho is not None:
        fields.append(("rho", rho))
    for fname, t in fields:
        _check(t, fname, (nz, ny, nx), dev)
    _check(rain, "rain", (ny, nx), dev)
    _check(snow, "snow", (ny, nx), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    species = (theta.data_ptr(), qv.data_ptr(), qc.data_ptr(), qr.data_ptr(),
               qs.data_ptr(), pressure.data_ptr(), exner.data_ptr())
    rest = (rain.data_ptr(), snow.data_ptr(), nz, ny * nx, float(dt),
            float(cloud2rain), float(cloud2snow), stream)
    if fall_tiles is not None:
        err = lib.icar_mp_simple_fall_tiles(
            *species, None if rho is None else rho.data_ptr(), dz.data_ptr(),
            *rest[:2], fall_tiles.data_ptr(), *rest[2:])
        _raise_on(err, name)
        return
    if rho is None:
        err = lib.icar_mp_simple(*species, dz.data_ptr(), *rest)
    else:
        err = lib.icar_mp_simple_rho(*species, rho.data_ptr(), dz.data_ptr(),
                                     *rest)
    _raise_on(err, name)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K4: MPDATA advection
# ---------------------------------------------------------------------------

def advect_mpdata(q, winds: AdvectWinds, dt, order: int, use_fct: bool,
                  floors, near_end: bool, out=None):
    """MPDATA update (``order`` >= 1 passes, optional FCT) of the species
    stack ``q`` (S, nz, ny, nx) for one substep of length ``dt`` into
    ``out`` (allocated when None; must not alias ``q``). ``floors`` (S,)
    float32 tensor: with ``near_end`` each species is clamped to its
    floor. The intermediate solutions of orders >= 2 are allocated here;
    the kernel keeps everything else on chip. Returns ``out``."""
    S, nz, ny, nx = q.shape
    order = int(order)
    if q.device.type == "cpu":
        res = mpdata_plain.advect_mpdata(
            q, winds.u, winds.v, winds.w, dt, winds.dx, winds.jaco_u,
            winds.jaco_v, winds.jaco_w, winds.jaco_c, winds.dz, order=order,
            use_fct=use_fct, floors=floors, near_end=near_end,
            rho=winds.rho, advect_density=winds.rho is not None)
        if out is None:
            return res
        out.copy_(res)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"advect_mpdata: unsupported device {q.device}")
    if order < 1:
        raise ValueError(f"advect_mpdata: order must be >= 1, got {order}")
    if nz < 2 or ny < 3 or nx < 3:
        raise ValueError(f"advect_mpdata: needs nz >= 2, ny >= 3, nx >= 3, "
                         f"got {(nz, ny, nx)}")
    lib = library()
    if nz > lib.icar_advect_mpdata_max_nz():
        raise ValueError(f"advect_mpdata: nz={nz} exceeds the kernel's "
                         f"maximum {lib.icar_advect_mpdata_max_nz()}")
    dev = q.device
    _check(q, "q", (S, nz, ny, nx), dev)
    _check(winds.uj, "uj", (nz, ny, nx - 1), dev)
    _check(winds.vj, "vj", (nz, ny - 1, nx), dev)
    for name in ("wj", "dz", "jaco"):
        _check(getattr(winds, name), name, (nz, ny, nx), dev)
    _check(floors, "floors", (S,), dev)
    if out is None:
        out = torch.empty_like(q)
    _check(out, "out", (S, nz, ny, nx), dev)
    if out.data_ptr() == q.data_ptr():
        raise ValueError("advect_mpdata: out must not alias q")
    # the scratch is freed on return while the launches may still run:
    # the caching allocator hands it out again only to later work on the
    # same stream, which runs after them
    scratch = torch.empty((min(order - 1, 2), S, nz, ny, nx), dtype=q.dtype,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.icar_advect_mpdata(
        q.data_ptr(), out.data_ptr(), scratch.data_ptr(), winds.uj.data_ptr(),
        winds.vj.data_ptr(), winds.wj.data_ptr(), winds.dz.data_ptr(),
        winds.jaco.data_ptr(), floors.data_ptr(), S, nz, ny, nx, float(dt),
        order, int(bool(use_fct)), int(bool(near_end)), stream)
    _raise_on(err, "advect_mpdata")
    LAUNCHES["advect_mpdata"] += 1
    return out


# ---------------------------------------------------------------------------
# K5: Thompson microphysics
# ---------------------------------------------------------------------------

def mp_thompson_stack(qstack, smap, exner, pressure, dz_mass, dt, rain,
                      snow, graupel, params=None):
    """Thompson microphysics (mp=1), in place: updates the species stack
    ``qstack`` (9, nz, ny, nx), whose row ``smap[i]`` holds the scheme's
    i-th field of (th, qv, qc, qi, qr, qs, qg, ni, nr), and adds this
    call's surface precipitation to the (ny, nx) accumulators:
    rain += ppt_rain + ppt_snow + ppt_graupel + ppt_ice, snow += ppt_snow +
    ppt_ice, graupel += ppt_graupel. ``dz_mass`` is the mass-level
    thickness. The lookup tables and the kernel's constants go to the
    device once per parameter set (``mp_thompson.device_tables``).

    For a CUDA stack, returns a one-element int32 device tensor that holds,
    once the launches have run, the number of column tiles the kernel found
    active (of ``ceil(ny * nx / C)``, C = ``tile_columns(nz)``); else
    None."""
    params = params or thompson_plain.ThompsonParams()
    smap = tuple(int(i) for i in smap)
    if sorted(smap) != list(range(9)):
        raise ValueError(f"mp_thompson_stack: smap {smap} is not a "
                         f"permutation of the 9 stack rows")
    S, nz, ny, nx = qstack.shape
    if qstack.device.type == "cpu":
        res = thompson_plain.mp_thompson_smap(
            qstack, smap, exner, pressure, dz_mass, dt, rain, snow, graupel,
            params)
        for dst, src in zip((qstack, rain, snow, graupel), res):
            dst.copy_(src)
        return None
    if qstack.device.type != "cuda":
        raise ValueError(f"mp_thompson: unsupported device {qstack.device}")
    dev = qstack.device
    lib = library()
    cols = lib.icar_mp_thompson_tile_columns(nz)
    if cols == 0:
        raise ValueError(f"mp_thompson: nz={nz} exceeds the kernel's "
                         f"maximum {lib.icar_mp_thompson_max_nz()}")
    _check(qstack, "qstack", (9, nz, ny, nx), dev)
    for fname, t in (("exner", exner), ("pressure", pressure),
                     ("dz_mass", dz_mass)):
        _check(t, fname, (nz, ny, nx), dev)
    for fname, t in (("rain", rain), ("snow", snow), ("graupel", graupel)):
        _check(t, fname, (ny, nx), dev)
    tabs = thompson_plain.device_tables(params, dev)
    consts = tabs["consts"]
    if consts.numel() != lib.icar_mp_thompson_n_consts():
        raise ValueError(f"mp_thompson: {consts.numel()} constants, the "
                         f"kernel reads {lib.icar_mp_thompson_n_consts()}")
    smap_c = (ctypes.c_int * 9)(*smap)
    # the counts of active and claimed tiles and the list of active tiles
    # (freed on return while the launches may still run: the caching
    # allocator hands them out again only to later work on the same stream)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    tiles = torch.empty(-(-(ny * nx) // cols), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.icar_mp_thompson(
        qstack.data_ptr(), ctypes.addressof(smap_c), exner.data_ptr(),
        pressure.data_ptr(), dz_mass.data_ptr(),
        *(tabs[g].data_ptr() for g in thompson_plain.BIG_STACKS
          + thompson_plain.SMALL_STACKS),
        consts.data_ptr(), rain.data_ptr(), snow.data_ptr(),
        graupel.data_ptr(), counts.data_ptr(), tiles.data_ptr(), nz,
        ny * nx, float(dt), stream)
    _raise_on(err, "mp_thompson")
    LAUNCHES["mp_thompson"] += 1
    return counts[:1]

"""The CUDA source of kernels K2 and K3 (icar_tpu_torch/csrc/mp_simple.cu),
compiled for the CPU with g++ against the stub CUDA runtime of
tests/test_torch_thompson.py and run one thread per block, against the
plain version (icar_tpu_torch/physics/mp_simple.py).

The kernel's loops over a tile's cells are block-stride between barriers,
so one thread per block runs the same arithmetic as the card does; each
launch becomes a loop over its blocks. Held here: K2 and K3 against the
plain version within chip_smoke.py's K2_RTOL/K2_ATOL on a ridge-like state
whose tiles hold rain in some columns and none in others (and some tiles
nothing to fall at all); the same bits whatever the tiles (the whole
domain in one launch against its columns in two launches of other widths);
the same bits when every tile runs the fall loops (a build with
-DMP_SIMPLE_NO_SKIP); and a column deeper than 64 levels.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import K2_ATOL, K2_RTOL, ridge_columns
from icar_tpu_torch import constants as C
from icar_tpu_torch.physics import mp_simple as mp_plain
from tests.test_torch_thompson import _STUB_RUNTIME

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("theta", "qv", "qc", "qr", "qs", "rain", "snow")

_REPLACE = (
    ("extern __shared__ float k2_smem[];", "static float k2_smem[1 << 16];"),
    ("mp_simple_kernel<kRhoOperand>\n      <<<grid, K2_THREADS, smem, "
     "(cudaStream_t)stream>>>(",
     "BLOCKS_LAUNCH(grid, mp_simple_kernel<kRhoOperand>, "),
)


def build_cpu_kernel(d, defines=()):
    """csrc/mp_simple.cu built by g++ in the directory ``d`` with the stub
    CUDA runtime (no FMA contraction, glibc's libm), with ``defines``;
    returns the loaded library."""
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME)
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "mp_simple.cu")).read()
    for old, new in _REPLACE:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (d / "k2.cpp").write_text(src)
    lib = d / f"libk2{''.join(defines)}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC", "-shared",
                    f"-I{d}", *defines, "-o", str(lib), str(d / "k2.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    so.icar_mp_simple.argtypes = [P] * 10 + [I, L, F, F, F, P]
    so.icar_mp_simple_rho.argtypes = [P] * 11 + [I, L, F, F, F, P]
    so.icar_mp_simple_fall_tiles.argtypes = [P] * 12 + [I, L, F, F, F, P]
    for fn in (so.icar_mp_simple, so.icar_mp_simple_rho,
               so.icar_mp_simple_fall_tiles, so.icar_mp_simple_max_nz):
        fn.restype = I
    so.icar_mp_simple_tile_columns.argtypes = [I]
    so.icar_mp_simple_tile_columns.restype = I
    so.icar_mp_simple_smem_bytes.argtypes = [I]
    so.icar_mp_simple_smem_bytes.restype = L
    return so


@pytest.fixture(scope="module")
def cpu_builds(tmp_path_factory):
    """{"skip": the source as it is, "no_skip": built with
    -DMP_SIMPLE_NO_SKIP, where every tile runs both fall loops}."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("k2cpu")
    return {"skip": build_cpu_kernel(d),
            "no_skip": build_cpu_kernel(d, ("-DMP_SIMPLE_NO_SKIP",))}


def run_cpu(so, state, dt, rho_operand, counts=False):
    """One launch of the CPU build on copies of ``state``: K3 with the
    state's density, else K2; with ``counts`` through the counting entry.
    Returns (theta, qv, qc, qr, qs, rain, snow) as arrays and, with
    ``counts``, (rain tiles, snow tiles)."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = (
        torch.tensor(a) for a in state)
    nz, ny, nx = theta.shape
    c2r, c2s = mp_plain.formation_rates(dt)
    out = (theta, qv, qc, qr, qs)
    ptr = lambda ts: [t.data_ptr() for t in ts]
    rest = [nz, ny * nx, float(dt), c2r, c2s, None]
    if counts:
        n = torch.zeros(2, dtype=torch.int32)
        err = so.icar_mp_simple_fall_tiles(
            *ptr(out + (p, exner)), rho.data_ptr() if rho_operand else None,
            *ptr((dz, rain, snow, n)), *rest)
    elif rho_operand:
        err = so.icar_mp_simple_rho(*ptr(out + (p, exner, rho, dz, rain,
                                                snow)), *rest)
    else:
        err = so.icar_mp_simple(*ptr(out + (p, exner, dz, rain, snow)),
                                *rest)
    assert err == 0
    got = [t.numpy() for t in out + (rain, snow)]
    return (got, tuple(n.tolist())) if counts else got


def run_plain(state, dt, rho_operand):
    """The plain version on ``state``; K2's density is p/(Rd*theta*exner)
    from the entry state, as kernels.mp_simple forms it on the CPU."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = (
        torch.tensor(a) for a in state)
    if not rho_operand:
        rho = p / (C.RD * (theta * exner))
    c2r, c2s = mp_plain.formation_rates(dt)
    return [t.numpy() for t in mp_plain.mp_simple(
        p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dt, dz, c2r, c2s)]


def assert_matches_plain(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, w, rtol=K2_RTOL, atol=K2_ATOL,
                                   err_msg=f"{what}: {name}")


def same_bits(got, want):
    return all(np.array_equal(g.view(np.int32), w.view(np.int32))
               for g, w in zip(got, want))


def tiles(so, nz, ncol):
    return -(-ncol // so.icar_mp_simple_tile_columns(nz))


@pytest.mark.parametrize("rho_operand", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_source_matches_plain(cpu_builds, seed, rho_operand):
    """K2 / K3 on a ridge-like state (200 columns: seven 32-column tiles,
    the last ragged), dt 52.2 s; the state's density scaled off p/(Rd*T)
    for K3, so that it is the operand that counts. Some tiles run the
    fall loops with rain in some columns and none in others; the rest
    hold nothing to fall and skip them."""
    wet = np.arange(200) % 5 < 3
    wet[64:128] = False                    # tiles 2 and 3: nothing at all
    state = ridge_columns(seed, wet=wet)
    if rho_operand:
        state[3] = state[3] * np.random.default_rng(seed).uniform(
            0.8, 1.2, state[3].shape).astype(np.float32)
    dt = np.float32(1200.0 / 23)
    so = cpu_builds["skip"]
    got, (n_rain, n_snow) = run_cpu(so, state, dt, rho_operand, counts=True)
    assert_matches_plain(got, run_plain(state, dt, rho_operand),
                         f"seed {seed}, rho operand {rho_operand}")
    assert same_bits(run_cpu(so, state, dt, rho_operand), got)
    assert tiles(so, 20, 200) == 7
    assert (n_rain, n_snow) == (5, 5)
    raining = (got[3].reshape(20, 200) != 0).any(axis=0)
    assert raining[:32].any() and not raining[:32].all()


@pytest.mark.parametrize("rho_operand", [False, True])
def test_columns_get_the_same_bits_in_any_tile(cpu_builds, rho_operand):
    """The whole domain (200 columns) in one launch against its first 45
    and last 155 columns in two launches: every column lands in another
    tile, at another place in it, next to other columns; the bits do not
    move."""
    state = ridge_columns(3)
    dt = np.float32(1200.0 / 23)
    so = cpu_builds["skip"]
    whole = run_cpu(so, state, dt, rho_operand)
    flat = lambda a: a.reshape(a.shape[:-2] + (-1,))
    parts = []
    for cols in (slice(0, 45), slice(45, 200)):
        part = [np.ascontiguousarray(flat(a)[..., cols][..., None, :])
                for a in state]
        parts.append(run_cpu(so, part, dt, rho_operand))
    joined = [np.concatenate([flat(a), flat(b)], axis=-1)
              for a, b in zip(*parts)]
    assert same_bits(joined, [flat(w) for w in whole])


@pytest.mark.parametrize("rho_operand", [False, True])
@pytest.mark.parametrize("case", ["mixed", "dry", "all wet", "snow only"])
def test_skipping_tiles_keeps_the_bits(cpu_builds, case, rho_operand):
    """The build whose every tile runs both fall loops (-DMP_SIMPLE_NO_SKIP)
    gives the same bits as the package's; it counts every tile, the
    package's only those that hold rain or snow: none of a dry state, all
    of a state wet everywhere, some of a mixed one; in a state below
    freezing without rain, tiles that run the snow loop and not the rain
    loop."""
    wet = {"dry": np.zeros(200, bool),
           "all wet": np.ones(200, bool)}.get(case,
                                              np.arange(200) // 32 % 2 == 0)
    state = ridge_columns(4, wet=wet,
                        t_sfc=262.0 if case == "snow only" else 288.0)
    if case == "snow only":
        state[6] = np.zeros_like(state[6])
    dt = np.float32(1200.0 / 23)
    got, (n_rain, n_snow) = run_cpu(cpu_builds["skip"], state, dt,
                                    rho_operand, counts=True)
    want, n_all = run_cpu(cpu_builds["no_skip"], state, dt, rho_operand,
                          counts=True)
    assert same_bits(got, want)
    n = tiles(cpu_builds["skip"], 20, 200)
    assert n_all == (n, n)
    if case == "dry":
        assert (n_rain, n_snow) == (0, 0)
        assert same_bits(got[3:5], state[6:8])
    elif case == "all wet":
        assert (n_rain, n_snow) == (n, n)
    elif case == "snow only":
        assert (n_rain, n_snow) == (0, 4)
    else:
        assert (n_rain, n_snow) == (4, 4)


@pytest.mark.parametrize("rho_operand", [False, True])
def test_kernel_source_at_96_levels(cpu_builds, rho_operand):
    """A column deeper than K4's 64-level limit: at nz = 96 the
    tile narrows to 8 columns (a ragged last tile of 3), and K2 / K3 match
    the plain version."""
    so = cpu_builds["skip"]
    assert so.icar_mp_simple_tile_columns(96) == 8
    state = ridge_columns(5, nz=96, ny=3, nx=9)
    dt = np.float32(40.0)
    got = run_cpu(so, state, dt, rho_operand)
    assert_matches_plain(got, run_plain(state, dt, rho_operand),
                         f"nz 96, rho operand {rho_operand}")


def test_kernel_source_refuses_what_it_cannot_take(cpu_builds):
    """No levels, no columns, or one level more than a block's shared
    memory holds: the launch is refused (cudaErrorInvalidValue)."""
    so = cpu_builds["skip"]
    top = so.icar_mp_simple_max_nz()
    state = ridge_columns(6, nz=3, ny=1, nx=2)
    p = [torch.tensor(a) for a in state]
    args = [t.data_ptr() for t in (p[1], p[4], p[5], p[6], p[7], p[0], p[2],
                                   p[10], p[8], p[9])]
    for nz, ncol in ((0, 2), (3, 0), (top + 1, 2)):
        assert so.icar_mp_simple(*args, nz, ncol, 30.0, 0.9, 0.98,
                                 None) == 1
    assert so.icar_mp_simple_smem_bytes(top) <= 232448
    assert so.icar_mp_simple_smem_bytes(top + 1) == 0

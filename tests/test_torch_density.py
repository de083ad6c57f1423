"""Density advection (``run.advect_density``) in the port against the JAX
package, on the CPU.

(a) The plain upwind and MPDATA (orders 1-3, FCT on and off) with density
against the JAX package's jnp path (``advect_upwind(..., advect_density=
True, use_pallas=False)``, ``advect_mpdata``) at rtol 1e-6, atol 1e-8, as
tests/test_torch_mpdata.py holds the plain versions without density.
(b) The density-weighted kernel operands (``kernels.density_winds``): the
kernel-order oracle of K1 (``chip_smoke.upwind_oracle``) on them against
the plain version with density at K1's tolerance (the winds are scaled in
another order), and the wrappers on CPU tensors take the plain versions
with the density, not the folded operands. (c) Both density ridges (SB04
with upwind, and with MPDATA) against the jitted JAX model: three
substeps at rtol 1e-5, atol 1e-7 (precipitation rtol 1e-4), as
tests/test_torch_model.py holds the ridges without density, and a whole
interval within the JAX package's own one-ulp spread. (d) Sharded against unsharded,
bit for bit.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icar_tpu import constants as JC
from icar_tpu.models.icar import ideal_ridge_model as jax_model
from icar_tpu.ops import advection as jadv
from icar_tpu.ops import mpdata as jmd
from icar_tpu_torch import constants as C
from icar_tpu_torch.convert import state_from_numpy
from icar_tpu_torch.core.step import path_kernels, quantized_dt
from icar_tpu_torch.forcing.ideal import make_ideal_case
from icar_tpu_torch.models.icar import density_options, ideal_ridge_model
from icar_tpu_torch.ops import advection as tadv
from icar_tpu_torch.ops import kernels
from icar_tpu_torch.ops import mpdata as tmd
from icar_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the kernel-order oracle, no jax)

JNP_RTOL, JNP_ATOL = 1e-6, 1e-8
PROGNOSTICS = ("potential_temperature", "water_vapor", "cloud_water",
               "rain_mass", "snow_mass")
# tests/test_torch_model.py's MPDATA ridge, with either advection. Its rh
# of 0.9 keeps the first substeps off SB04's 15-sweep revert edge: there
# (rh 1.0) the general loop's SB04 reads the state's density, which the
# two packages form a few ulp apart (tests/test_torch_diagnostics.py), and
# one substep already moves a cell's cloud water by 12% between them, as
# much as a one-ulp nudge of theta and qv moves the JAX package's own
CASES = {"upwind": dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1200.0,
                        u_speed=10.0, rh=0.9),
         "MPDATA": dict(nx=40, ny=12, nz=12, dx=1000.0, hill_height=1200.0,
                        u_speed=10.0, rh=0.9, adv=C.ADV_MPDATA)}


def _inputs(seed=17, S=4, nz=8, ny=23, nx=29):
    """A random stack with winds of both signs, metrics near one and a
    density falling with height (tests/test_torch_mpdata.py's inputs)."""
    r = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    q = r.uniform(0.1, 1.0, (S, nz, ny, nx))
    q[1, :, 5:12, 7:15] = 0.0          # a species with a zero patch
    rho = (np.linspace(1.2, 0.6, nz)[:, None, None]
           * r.uniform(0.9, 1.1, (nz, ny, nx)))
    return dict(
        q=f(q), rho=f(rho),
        u=f(r.uniform(-6, 6, (nz, ny, nx + 1))),
        v=f(r.uniform(-6, 6, (nz, ny + 1, nx))),
        w=f(r.uniform(-1, 1, (nz, ny, nx))),
        dz=f(r.uniform(200, 400, (nz, ny, nx))),
        jaco=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        jaco_u=f(r.uniform(0.8, 1.2, (nz, ny, nx + 1))),
        jaco_v=f(r.uniform(0.8, 1.2, (nz, ny + 1, nx))),
        jaco_w=f(r.uniform(0.8, 1.2, (nz, ny, nx))),
        dt=np.float32(20.0), dx=1000.0,
        floors=f([-np.inf, 0.0, 0.0, 0.5][:S]))


def _tensors(d):
    return {k: torch.tensor(v) for k, v in d.items()
            if isinstance(v, np.ndarray)}


def _args(a, d):
    return (a["q"], a["u"], a["v"], a["w"], d["dt"], d["dx"], a["jaco_u"],
            a["jaco_v"], a["jaco_w"], a["jaco"])


def _winds(t, d):
    from types import SimpleNamespace
    geom = SimpleNamespace(dx=d["dx"], jacobian=t["jaco"],
                           jacobian_u=t["jaco_u"], jacobian_v=t["jaco_v"],
                           jacobian_w=t["jaco_w"], advection_dz=t["dz"])
    return kernels.prepare_advect_winds(t["u"], t["v"], t["w"], geom)


@pytest.mark.parametrize("near_end", [False, True])
def test_plain_upwind_with_density_matches_jnp(near_end):
    d = _inputs()
    a = {k: jnp.asarray(v) for k, v in _tensors(d).items()}
    want = jadv.advect_upwind(*_args(a, d), a["rho"], a["dz"],
                              advect_density=True, use_pallas=False,
                              floors=d["floors"],
                              near_end=jnp.float32(near_end))
    t = _tensors(d)
    got = tadv.advect_upwind(*_args(t, d), t["dz"], floors=t["floors"],
                             near_end=near_end, rho=t["rho"],
                             advect_density=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=JNP_RTOL, atol=JNP_ATOL)
    # the density does move the result
    plain = tadv.advect_upwind(*_args(t, d), t["dz"], floors=t["floors"],
                               near_end=near_end)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3


@pytest.mark.parametrize("near_end", [False, True])
@pytest.mark.parametrize("order,fct", [(1, False), (2, False), (2, True),
                                       (3, False), (3, True)])
def test_plain_mpdata_with_density_matches_jnp(order, fct, near_end):
    d = _inputs(5)
    a = {k: jnp.asarray(v) for k, v in _tensors(d).items()}
    want = jmd.advect_mpdata(*_args(a, d), a["rho"], a["dz"], order=order,
                             use_fct=fct, advect_density=True,
                             use_pallas=False, floors=d["floors"],
                             near_end=jnp.float32(near_end))
    t = _tensors(d)
    got = tmd.advect_mpdata(*_args(t, d), t["dz"], order=order, use_fct=fct,
                            advect_density=True, floors=t["floors"],
                            near_end=near_end, rho=t["rho"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=JNP_RTOL, atol=JNP_ATOL)


def test_density_winds_weight_the_kernel_operands():
    """``density_winds``: the kernel's face winds times the face means of
    rho (the top face the top layer's), its jacobian J*rho, the raw
    fields unchanged, and the density recorded for the plain version."""
    d = _inputs(3, ny=11, nx=13)
    t = _tensors(d)
    w = _winds(t, d)
    dw = kernels.density_winds(w, t["rho"])
    rho = t["rho"]
    torch.testing.assert_close(dw.uj, w.uj * ((rho[:, :, 1:] + rho[:, :, :-1])
                                              * 0.5), rtol=0, atol=0)
    torch.testing.assert_close(dw.vj, w.vj * ((rho[:, 1:] + rho[:, :-1])
                                              * 0.5), rtol=0, atol=0)
    torch.testing.assert_close(dw.wj[:-1], w.wj[:-1] * ((rho[1:] + rho[:-1])
                                                        * 0.5),
                               rtol=0, atol=0)
    torch.testing.assert_close(dw.wj[-1], w.wj[-1] * rho[-1], rtol=0, atol=0)
    torch.testing.assert_close(dw.jaco, t["jaco"] * rho, rtol=0, atol=0)
    for k in ("u", "v", "w", "jaco_u", "jaco_v", "jaco_w", "dz", "jaco_c"):
        assert getattr(dw, k) is getattr(w, k), k
    assert dw.rho is rho and w.rho is None
    assert all(x.is_contiguous() for x in (dw.uj, dw.vj, dw.wj, dw.jaco))


# csrc/density_fold.cu for g++ against the stub CUDA runtime of
# tests/test_torch_mpdata_kernel.py: the launch becomes a loop over every
# thread of every block
_FOLD_LAUNCH = """
#define FOLD_LAUNCH(...)                                          \\
  do {                                                            \\
    blockDim.x = FOLD_THREADS;                                    \\
    for (unsigned b_ = 0; b_ < blocks; ++b_)                      \\
      for (unsigned t_ = 0; t_ < FOLD_THREADS; ++t_) {            \\
        blockIdx.x = b_; threadIdx.x = t_;                        \\
        density_fold_kernel(__VA_ARGS__);                         \\
      }                                                           \\
  } while (0)
"""


@pytest.fixture(scope="module")
def cpu_fold(tmp_path_factory):
    """The fold kernel's source compiled for the CPU."""
    import ctypes
    import shutil
    import subprocess
    from test_torch_mpdata_kernel import _STUB_RUNTIME
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("foldcpu")
    (d / "cuda_runtime.h").write_text(_STUB_RUNTIME + _FOLD_LAUNCH)
    src = open(os.path.join(REPO, "icar_tpu_torch", "csrc",
                            "density_fold.cu")).read()
    launch = ("density_fold_kernel<<<blocks, FOLD_THREADS, 0, "
              "(cudaStream_t)stream>>>(")
    assert src.count(launch) == 1
    (d / "fold.cpp").write_text(src.replace(launch, "FOLD_LAUNCH("))
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O1",
                    "-ffp-contract=off", "-fno-fast-math", "-fPIC",
                    "-shared", f"-I{d}", "-o", str(d / "libfold.so"),
                    str(d / "fold.cpp")], check=True, capture_output=True,
                   timeout=300)
    so = ctypes.CDLL(str(d / "libfold.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.icar_density_fold.argtypes = [P] * 9 + [I, I, I, P]
    so.icar_density_fold.restype = I
    return so


@pytest.mark.parametrize("shape", [(6, 9, 13), (2, 3, 3), (5, 17, 41)])
def test_fold_kernel_source_gives_the_plain_fold_bits(cpu_fold, shape):
    """csrc/density_fold.cu, compiled for the CPU, gives ``fold_plain``'s
    (the CPU wrapper's) four operands bit for bit, on planes that no
    block of 256 cells divides."""
    nz, ny, nx = shape
    d = _inputs(13, S=2, nz=nz, ny=ny, nx=nx)
    t = _tensors(d)
    w = _winds(t, d)
    out = [torch.full_like(a, float("nan")) for a in (w.uj, w.vj, w.wj,
                                                       w.jaco_c)]
    err = cpu_fold.icar_density_fold(
        t["rho"].data_ptr(), w.uj.data_ptr(), w.vj.data_ptr(),
        w.wj.data_ptr(), w.jaco_c.data_ptr(), *(a.data_ptr() for a in out),
        nz, ny, nx, None)
    assert err == 0
    for got, want in zip(out, kernels.fold_plain(w, t["rho"])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("near_end", [False, True])
def test_folded_operands_match_the_plain_version(near_end):
    """K1's arithmetic (the kernel-order oracle) on the density-weighted
    operands against the plain upwind with density, at K1's tolerance
    against its plain version: the density enters only through the four
    operands."""
    d = _inputs(11)
    t = _tensors(d)
    dw = kernels.density_winds(_winds(t, d), t["rho"])
    got = chip_smoke.upwind_oracle(t["q"], dw, d["dt"], t["floors"],
                                   near_end)
    want = tadv.advect_upwind(*_args(t, d), t["dz"], floors=t["floors"],
                              near_end=near_end, rho=t["rho"],
                              advect_density=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               rtol=chip_smoke.K1_RTOL,
                               atol=chip_smoke.K1_ATOL)


@pytest.mark.parametrize("scheme", ["upwind", "mpdata"])
def test_wrappers_on_cpu_take_the_plain_version_with_density(scheme):
    """On CPU tensors the wrappers run the plain versions with the
    density (bit for bit), launch nothing, and never read the folded
    operands (here poisoned with NaN)."""
    d = _inputs(6, ny=11, nx=13)
    t = _tensors(d)
    dw = kernels.density_winds(_winds(t, d), t["rho"])
    nan = torch.full_like(dw.jaco, float("nan"))
    dw = dw._replace(uj=dw.uj * nan[:, :, 1:], vj=dw.vj * nan[:, 1:],
                     wj=nan, jaco=nan)
    before = dict(kernels.LAUNCHES)
    if scheme == "upwind":
        got = kernels.advect_upwind(t["q"], dw, d["dt"], t["floors"], True)
        want = tadv.advect_upwind(*_args(t, d), t["dz"], floors=t["floors"],
                                  near_end=True, rho=t["rho"],
                                  advect_density=True)
    else:
        got = kernels.advect_mpdata(t["q"], dw, d["dt"], 2, True,
                                    t["floors"], True)
        want = tmd.advect_mpdata(*_args(t, d), t["dz"], order=2,
                                 use_fct=True, advect_density=True,
                                 floors=t["floors"], near_end=True,
                                 rho=t["rho"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert kernels.LAUNCHES == before


def test_plain_mpdata_without_density_unchanged():
    """Without density the MPDATA arithmetic is the one the JAX package's
    jnp path runs without density, bit for bit (the ridge digests rest on
    it)."""
    d = _inputs(9)
    a = {k: jnp.asarray(v) for k, v in _tensors(d).items()}
    want = jmd.advect_mpdata(*_args(a, d), None, a["dz"], order=2,
                             use_fct=True, use_pallas=False)
    t = _tensors(d)
    got = tmd.advect_mpdata(*_args(t, d), t["dz"], order=2, use_fct=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=JNP_RTOL, atol=JNP_ATOL)


# ---------------------------------------------------------------------------
# the density ridges against the jitted JAX model
# ---------------------------------------------------------------------------

def _jax_density(o):
    o.run.advect_density = True


@pytest.fixture(scope="module", params=sorted(CASES))
def ridge(request):
    """(path, JAX model, its initial state as numpy) for each density
    ridge; the JAX model's step is compiled once per module."""
    case = dict(CASES[request.param])
    if "adv" in case:
        case["adv"] = JC.ADV_MPDATA
    mj = jax_model(**case, options_cb=_jax_density)
    return request.param, mj, {k: np.asarray(v) for k, v in mj.state.items()}


def _port(path, initial):
    mt = ideal_ridge_model(**CASES[path], options_cb=density_options,
                           device="cpu")
    mt.state = state_from_numpy(initial, "cpu")
    return mt


def _restart(mj, initial):
    mj.state = {k: jnp.array(v) for k, v in initial.items()}
    mj.model_time = 0.0


def _assert_match(mt, mj):
    for k in PROGNOSTICS:
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("precipitation", "snowfall"):
        np.testing.assert_allclose(mt.field(k), np.asarray(mj.field(k)),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_density_ridge_short_interval_matches_jax(ridge):
    """Three substeps (a shortened last one and the near-end clamp
    included), SB04 (K3's plain version) with the state's density, then
    the advection with density: cell by cell at rtol 1e-5, atol 1e-7
    (precipitation rtol 1e-4)."""
    path, mj, initial = ridge
    _restart(mj, initial)
    mt = _port(path, initial)
    assert path_kernels(mt.options)[0] == "mp_simple_rho"
    s, g = mt.state, mt.geom_t
    dt = quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx, 0.9, 3)
    seconds = float(np.float32(2.5) * dt)
    mj.advance(seconds)
    mt.advance(seconds)
    assert mt.last_n_substeps == mj.last_n_substeps == 3
    _assert_match(mt, mj)


def test_density_ridge_interval_matches_jax(ridge):
    """A whole 1200 s interval. With density both ridges sit on SB04's
    revert edge (the JAX package rerun with theta and qv nudged by one ulp
    moves theta by up to 6.6e-3 K in the MPDATA case, in 44 cells past
    1e-3; the port differs by at most 3.7e-3 K, in a column of one level
    at its 24th substep, after 18 substeps within 2.5e-4 K, a few ulp of
    300 K). So, as tests/test_torch_model.py holds the golden and bench
    ridges, the port is held to the same substep count and twice the JAX
    package's one-ulp spread (chip_smoke.py ENSEMBLE_MAX per cell,
    ENSEMBLE_MEAN as a domain mean), with a cloud that rains."""
    path, mj, initial = ridge
    _restart(mj, initial)
    mt = _port(path, initial)
    mj.advance(1200.0)
    mt.advance(1200.0)
    assert mt.last_n_substeps == mj.last_n_substeps
    for k, bound in chip_smoke.ENSEMBLE_MAX.items():
        got, want = mt.field(k), np.asarray(mj.field(k))
        d = np.abs(got - want)
        assert np.isfinite(got).all(), k
        assert (d <= bound + 1e-4 * np.abs(want)).all(), (k, d.max())
        assert d.mean() <= chip_smoke.ENSEMBLE_MEAN[k], (k, d.mean())
    for k in ("u", "v", "w"):
        np.testing.assert_array_equal(mt.field(k), np.asarray(mj.field(k)))
    assert mt.field("cloud_water").max() > 1e-4
    assert mt.field("precipitation").max() > 0.1


# ---------------------------------------------------------------------------
# sharded against unsharded
# ---------------------------------------------------------------------------

SHARD_CASE = dict(nx=48, ny=32, nz=8, dx=1000.0, hill_height=500.0,
                  u_speed=10.0, flat_z_height=-2, rh=1.0)


@pytest.mark.parametrize("adv,my,mx", [(C.ADV_UPWIND, 2, 2),
                                       (C.ADV_MPDATA, 4, 1)])
def test_sharded_density_ridge_is_bit_exact(adv, my, mx):
    """Two 300 s intervals with a v flow across the shard boundaries: the
    same substeps, every field bit for bit and the same digest. Each block
    weights its operands by its own density, halo included (theta is
    exchanged, pressure and Exner are per block)."""
    models = []
    for _ in range(2):
        m = ideal_ridge_model(**SHARD_CASE, adv=adv,
                              options_cb=density_options, device="cpu")
        m.set_initial_conditions(make_ideal_case(m.geom, u_profile=10.0,
                                                 v_profile=5.0, rh=1.0))
        models.append(m)
    one, sharded = models
    sharded.attach_mesh(Mesh(["cpu"] * (my * mx), (my, mx)))
    for _ in range(2):
        one.advance(300.0)
        sharded.advance(300.0)
        assert sharded.last_n_substeps == one.last_n_substeps >= 5
    assert one.field("precipitation").max() > 0.0
    for k in sorted(one.state):
        np.testing.assert_array_equal(sharded.field(k), one.field(k),
                                      err_msg=k)
    assert sharded.digest() == one.digest()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (icar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from icar_tpu_torch/csrc, checks each against its
plain PyTorch version on the card at the main path's 500x500x20 shapes,
runs the pinned golden ridge case (tests/golden/ideal_ridge_100.npz) on the
card, then drives the main path -- ideal_ridge_model(...).advance() at
500x500x20 -- and checks that it went through both kernels. Prints the
kernel table as one JSON line, then, as the last line,
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing a result. Imports
nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the bench.py ridge case at full width (bench.py:47-51)
RIDGE = dict(nx=500, ny=500, nz=20, dx=1000.0, hill_height=1000.0,
             u_speed=10.0, rh=0.95, flat_z_height=-5)
RIDGE_INTERVAL = 1200.0
RIDGE_INTERVALS = 2

# tools/make_golden.py CASE / INTERVAL / MIN_STEPS / FIELDS, copied because
# that module imports jax
GOLDEN_CASE = dict(nx=80, ny=16, nz=15, dx=1000.0, hill_height=900.0,
                   u_speed=12.0, rh=1.0)
GOLDEN_INTERVAL = 1800.0
GOLDEN_MIN_STEPS = 100
GOLDEN = os.path.join(ROOT, "tests", "golden", "ideal_ridge_100.npz")
# tests/test_golden.py ATOL (rtol 1e-4): the golden tolerance
GOLDEN_ATOL = {"u": 1e-4, "v": 1e-4, "w": 1e-5, "potential_temperature": 5e-4,
               "water_vapor": 1e-7, "cloud_water": 1e-7, "rain_mass": 1e-7,
               "snow_mass": 1e-7, "precipitation": 1e-4, "snowfall": 1e-4}
# The golden trajectory is not stable under one-ulp changes: the JAX
# package itself, run with one-ulp perturbations of theta (8 runs), leaves
# the golden tolerance in 7 of 8 runs for some field, and in 2 of 8 lands
# on a different branch of the 15-sweep saturation revert (theta off by
# 0.43 K in up to 10% of cells). So the thermodynamic fields are held to
# twice that ensemble's spread instead: per cell (MAX, plus rtol 1e-4) and
# as a domain mean of |difference| (MEAN). u, v, w and snowfall keep the
# golden tolerance. See PERF.md.
ENSEMBLE_MAX = {"potential_temperature": 1.0, "water_vapor": 1.3e-3,
                "cloud_water": 3.5e-4, "rain_mass": 5.5e-5,
                "snow_mass": 6.5e-7, "precipitation": 0.4}
ENSEMBLE_MEAN = {"potential_temperature": 1e-2, "water_vapor": 6e-6,
                 "cloud_water": 2e-6, "rain_mass": 3.5e-7,
                 "snow_mass": 2e-9, "precipitation": 1e-2}

# K1 against its plain version: a few float32 ulp (op order differs by
# design, see csrc/advect_upwind.cu), the tolerance of tests/test_pallas.py
K1_RTOL, K1_ATOL = 5e-6, 1e-7
# K2 against its plain version (same op order, no FMA contraction)
K2_RTOL, K2_ATOL = 1e-5, 1e-8


def log(*args):
    print(*args, flush=True)


def device_info():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "it needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def cuda_ms(fn, reps=7, setup=None):
    """Median milliseconds of fn() over CUDA events; ``setup()`` runs
    before each call, outside the timed span."""
    import torch
    times = []
    for _ in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def assert_close(got, want, rtol, atol, what):
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)
    d = np.abs(got - want)
    big = np.abs(want) > atol     # relative error where it means something
    rel = float((d[big] / np.abs(want[big])).max()) if big.any() else 0.0
    log(f"  {what}: max abs err {d.max():.3e}, max rel err {rel:.3e} "
        f"(cells with |plain| > atol)")
    return float(d.max())


def check_kernels(model, kernels, step, adv_plain, mp_plain):
    """K1 and K2 against their plain versions on the model's state."""
    import torch
    from icar_tpu_torch import constants as C
    s = model.state
    g = model.geom_t
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    out = torch.empty_like(stack)
    results = []

    # --- K1
    run_k1 = lambda: kernels.advect_upwind(stack, winds, dt, floors, True,
                                           out=out)
    run_p1 = lambda: adv_plain.advect_upwind(
        stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u, g.jacobian_v,
        g.jacobian_w, g.jacobian, g.advection_dz, floors=floors,
        near_end=True)
    run_k1()
    torch.cuda.synchronize()
    err1 = assert_close(out, run_p1(), K1_RTOL, K1_ATOL,
                        "advect_upwind kernel vs plain")
    ms1, pms1 = cuda_ms(run_k1), cuda_ms(run_p1)
    log(f"K1 advect_upwind: max_abs_err {err1:.3e} (rtol {K1_RTOL}, atol "
        f"{K1_ATOL}); kernel {ms1:.4f} ms, plain {pms1:.4f} ms")
    results.append(("advect_upwind", err1, ms1, pms1))

    # --- K2 on copies (it updates in place)
    idx = [names.index(k) for k in step.MP_SPECIES]
    p, ex, dz = s["pressure"], s["exner"], g.dz_interface
    c2r, c2s = mp_plain.formation_rates(dt)
    work = torch.empty_like(stack)
    rain = torch.zeros_like(s["precipitation"])
    snow = torch.zeros_like(rain)

    def reset():
        work.copy_(stack)
        rain.zero_()
        snow.zero_()

    def run_k2():
        kernels.mp_simple(*(work[i] for i in idx), p, ex, dz, rain, snow,
                          dt, c2r, c2s)

    def run_p2():
        th = stack[idx[0]]
        rho = p / (C.RD * (th * ex))
        return mp_plain.mp_simple(p, th, ex, rho,
                                  *(stack[i] for i in idx[1:]),
                                  torch.zeros_like(rain),
                                  torch.zeros_like(rain), dt, dz, c2r, c2s)

    reset()
    run_k2()
    torch.cuda.synchronize()
    want = run_p2()
    err2 = 0.0
    for name, got, ref in zip(
            ("theta", "qv", "qc", "qr", "qs", "rain", "snow"),
            [work[i] for i in idx] + [rain, snow], want):
        err2 = max(err2, assert_close(got, ref, K2_RTOL, K2_ATOL,
                                      f"mp_simple kernel vs plain: {name}"))
    ms2, pms2 = cuda_ms(run_k2, setup=reset), cuda_ms(run_p2)
    log(f"K2 mp_simple: max_abs_err {err2:.3e} (rtol {K2_RTOL}, atol "
        f"{K2_ATOL}); kernel {ms2:.4f} ms, plain {pms2:.4f} ms")
    results.append(("mp_simple", err2, ms2, pms2))
    return results


def golden_mismatches(fields, ref):
    """Hold ``fields`` (name -> array) against the golden arrays ``ref``.
    Returns (report lines, names of fields out of tolerance)."""
    report, failed = [], []
    for f, atol in GOLDEN_ATOL.items():
        got = np.asarray(fields[f], np.float64)
        want = np.asarray(ref[f], np.float64)
        d = np.abs(got - want)
        strict = int((d > atol + 1e-4 * np.abs(want)).sum())
        line = (f"{f}: max|d| {d.max():.3e}, mean|d| {d.mean():.3e}, "
                f"{strict} cells outside the golden tolerance")
        if f in ENSEMBLE_MAX:
            ok = (bool((d <= ENSEMBLE_MAX[f] + 1e-4 * np.abs(want)).all())
                  and d.mean() <= ENSEMBLE_MEAN[f])
            line += (f"; ensemble bound {ENSEMBLE_MAX[f]:.1e}/"
                     f"{ENSEMBLE_MEAN[f]:.1e}")
        else:
            ok = strict == 0
        report.append(line + ("" if ok else "  FAIL"))
        if not ok or not np.isfinite(got).all():
            failed.append(f)
    return report, failed


def check_golden(ideal_ridge_model):
    """The pinned golden ridge case on the card (tests/test_golden.py)."""
    ref = np.load(GOLDEN)
    m = ideal_ridge_model(**GOLDEN_CASE, device="cuda")
    steps = 0
    while steps < GOLDEN_MIN_STEPS:
        m.advance(GOLDEN_INTERVAL)
        steps += m.last_n_substeps
    if steps != int(ref["steps"]):
        raise AssertionError(f"golden: {steps} substeps, golden has "
                             f"{int(ref['steps'])}")
    report, failed = golden_mismatches(
        {f: m.field(f) for f in GOLDEN_ATOL}, ref)
    for line in report:
        log("golden " + line)
    if failed:
        raise AssertionError(f"golden fields out of tolerance: {failed}")
    log(f"golden: {steps} substeps, all fields within tolerance")


def main():
    smi = device_info()
    sys.path.insert(0, ROOT)
    import torch
    from icar_tpu_torch.core import step
    from icar_tpu_torch.models.icar import ideal_ridge_model
    from icar_tpu_torch.ops import advection as adv_plain
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.physics import mp_simple as mp_plain

    # 1. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s ({kernels.BUILD_INFO['path']})")
    log(kernels.BUILD_INFO["log"].strip())

    # 2. kernels against their plain versions on a real 500x500x20 state
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**RIDGE, device="cuda")
    warm.advance(RIDGE_INTERVAL)
    torch.cuda.synchronize()
    log(f"setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps")
    checks = check_kernels(warm, kernels, step, adv_plain, mp_plain)
    del warm

    # 3. the golden trajectory on the card
    check_golden(ideal_ridge_model)

    # 4. the main path at full width, counting kernel launches
    model = ideal_ridge_model(**RIDGE, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()
    steps = 0
    t0 = time.perf_counter()
    for _ in range(RIDGE_INTERVALS):
        model.advance(RIDGE_INTERVAL)
        steps += model.last_n_substeps
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name}: {n} launches for {steps} "
                                 "substeps on the main path")
    for f in ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "snow_mass", "precipitation", "u", "v", "w"):
        if not torch.isfinite(model.state[f]).all():
            raise AssertionError(f"main path: non-finite {f}")
    qc_max = float(model.state["cloud_water"].max())
    pr_max = float(model.state["precipitation"].max())
    if not (qc_max > 0 and pr_max > 0):
        raise AssertionError(f"main path: no cloud ({qc_max}) or no "
                             f"precipitation ({pr_max})")
    gp = RIDGE["nx"] * RIDGE["ny"] * RIDGE["nz"]
    rate = gp * steps / seconds
    log(f"main path 500x500x20: {steps} substeps in {seconds:.3f} s = "
        f"{rate / 1e6:.1f}M gp*steps/s on {smi}; qc max {qc_max:.3e}, "
        f"precip max {pr_max:.3f} mm")

    table = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"icar_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for (name, err, ms, pms), replaces in zip(
            checks, ("icar_tpu/ops/pallas_kernels.py:167",
                     "icar_tpu/ops/pallas_kernels.py:679"))]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

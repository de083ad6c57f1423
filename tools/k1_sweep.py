#!/usr/bin/env python3
"""Time builds of kernel K1 (icar_tpu_torch/csrc/advect_upwind.cu with its
tiled kernel in upwind.cuh, also K4's upwind pass) against each other on
the ridge's states, in turns, beside the copy floor, and hold each build
to the first (the package's) bit for bit. Needs one NVIDIA GPU and nvcc.

    python tools/k1_sweep.py [--source NAME=PATH[:-DFLAG,...] ...]
                             [--reps 7] [--turns 2] [--no-package]

``--source`` adds another advect_upwind.cu (its upwind.cuh beside it)
with the same C entry icar_advect_upwind: the parent commit's taken from
git into _archive/, or an edited copy of the package's (the tile, the
species group and the blocks per SM are constants at the top of
upwind.cuh); with ``--no-package`` only the sources are timed, held to
the first of them. Every build is one nvcc process (the package's flags), all
started together. The 500x500x20 ridges (models.icar RIDGE) are advanced
one 1200 s interval each: the upwind ridge (K1 on its 5 species, clamped
as at an interval's end), the MPDATA ridge and the Thompson ridge (K4's
upwind pass on 5 and 9 species, unclamped). On each state every build's
call is timed (median of --reps CUDA-event timings), builds in turn, the
order reversed every other turn, and with them the copy-floor probe
(csrc/upwind_floor.cu: the same bytes moved with no stencil). Prints each
build's ptxas figures and launch shape (a build without the entry
icar_advect_upwind_config, such as the parent's, is taken as 8 x 32
tiles of 256 threads and no shared memory, its blocks per multiprocessor
from its registers), the first build's max_abs_err against the
kernel-order oracle (chip_smoke.upwind_oracle), one JSON line per
(state, build, turn) with the bound, then the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing, bound, ptxas figures, oracle)
from tools.k5_sweep import build_all  # noqa: E402

FLOOR = "copy floor"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[:-DFLAG,...]: another advect_upwind.cu "
                         "with the same C entry")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--package", action=argparse.BooleanOptionalAction,
                    default=True, help="time the package's build too")
    args = ap.parse_args()

    smi = chip_smoke.device_info()
    import torch
    from icar_tpu_torch.core import step
    from icar_tpu_torch.models.icar import (RIDGE, RIDGE_PATHS,
                                            ideal_ridge_model)
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.physics.mp_thompson import device_tables
    from icar_tpu_torch.time_paths import INTERVAL

    src = os.path.join(ROOT, "icar_tpu_torch", "csrc", "advect_upwind.cu")
    builds = [("package", src, [])] if args.package else []
    for spec in args.source:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        builds.append((name, path, [f for f in flags.split(",") if f]))

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs, regs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        built = build_all(builds, kernels, d)
        for name, _, defines in builds:
            lib = ctypes.CDLL(built[name][0])
            lib.icar_advect_upwind.argtypes = [P] * 8 + [I, I, I, I, F, I, P]
            lib.icar_advect_upwind.restype = I
            libs[name] = lib
            figures = chip_smoke.ptxas_figures(built[name][1], "upwind")
            regs[name] = max(f.get("registers", 0) for f in figures.values())
            print(json.dumps({"build": name, "defines": defines,
                              "ptxas": figures}), flush=True)

    def config(name, S):
        """The build's launch shape for S species."""
        lib = libs[name]
        if not hasattr(lib, "icar_advect_upwind_config"):
            # 256 threads, no shared memory: registers are allocated per
            # warp in units of 256, at most 64 warps and 32 blocks an SM
            per_thread = -(-regs[name] // 8) * 8
            warps = min(64, 65536 // (per_thread * 32))
            return dict(tile_x=32, tile_y=8, threads=256, group=S,
                        smem_bytes=0, blocks_per_sm=min(32, warps // 8))
        cfg = (ctypes.c_int * len(kernels.UPWIND_CONFIG_KEYS))()
        lib.icar_advect_upwind_config.argtypes = [I, P]
        lib.icar_advect_upwind_config.restype = I
        if lib.icar_advect_upwind_config(S, cfg) != 0:
            raise RuntimeError(f"{name}: the occupancy query failed")
        return dict(zip(kernels.UPWIND_CONFIG_KEYS, list(cfg)))

    states = []
    for label, path, clamp in (("upwind ridge, K1", "upwind", 1),
                               ("MPDATA ridge, K4 upwind pass", "MPDATA", 0),
                               ("Thompson ridge, K4 upwind pass", "Thompson",
                                0)):
        m = ideal_ridge_model(**RIDGE, **RIDGE_PATHS[path], device="cuda")
        if path == "Thompson":
            device_tables(step.thompson_params(m.options),
                          m.state["pressure"].device)
        m.advance(INTERVAL)
        s, g = m.state, m.geom_t
        names = m.advect_names
        stack = torch.stack([s[k] for k in names])
        dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                               m.options.run.cfl_reduction_factor,
                               m.options.run.cfl_strictness)
        floors = torch.as_tensor(step.limit_floors(names),
                                 device=stack.device)
        winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
        states.append((label, stack, winds, dt, floors, clamp))
        del m

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for label, stack, winds, dt, floors, clamp in states:
        S, nz, ny, nx = stack.shape
        out = torch.empty_like(stack)
        bms, by = chip_smoke.bound(*chip_smoke.advect_work(*stack.shape))

        def call(name):
            if name == FLOOR:
                kernels.advect_upwind_floor(stack, winds, out)
                return
            err = libs[name].icar_advect_upwind(
                stack.data_ptr(), out.data_ptr(), winds.uj.data_ptr(),
                winds.vj.data_ptr(), winds.wj.data_ptr(),
                winds.dz.data_ptr(), winds.jaco.data_ptr(),
                floors.data_ptr(), S, nz, ny, nx, float(dt), clamp,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError {err}")

        want = None
        same = {}
        for name in libs:
            call(name)
            torch.cuda.synchronize()
            got = out.clone()
            if want is None:
                want = got
                oracle = chip_smoke.upwind_oracle(stack, winds, dt, floors,
                                                  bool(clamp))
                err = float((got - oracle).abs().max())
                print(json.dumps({"state": label, "shape": [S, nz, ny, nx],
                                  "build": name,
                                  "max_abs_err_vs_oracle": err}), flush=True)
                if err != 0.0:
                    raise AssertionError(f"{label}: {name}'s K1 is {err} "
                                         f"from the oracle")
            same[name] = torch.equal(got.view(torch.int32),
                                     want.view(torch.int32))
            cfg = config(name, S)
            tiles = (-(-nx // cfg["tile_x"])) * (-(-ny // cfg["tile_y"]))
            cfg["waves"] = tiles / (cfg["blocks_per_sm"] * sm_count)
            print(json.dumps({"state": label, "build": name,
                              "launch": cfg}), flush=True)
        call(FLOOR)
        torch.cuda.synchronize()
        if not torch.equal(out, stack):
            raise AssertionError(f"{label}: the copy floor's output is not q")
        order = list(libs) + [FLOOR]
        for turn in range(args.turns):
            for name in (order if turn % 2 == 0 else order[::-1]):
                ms = chip_smoke.cuda_ms(lambda: call(name), args.reps)
                print(json.dumps({
                    "state": label, "build": name, "turn": turn, "ms": ms,
                    "bound_ms": bms, "bound_by": by,
                    "bit_equal_to_first": same.get(name),
                    "dt": float(dt)}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()

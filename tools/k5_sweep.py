#!/usr/bin/env python3
"""Time builds of kernel K5 (icar_tpu_torch/csrc/mp_thompson.cu) against
each other on the Thompson ridge's states, in turns, and hold each to the
package's own build bit for bit. Needs one NVIDIA GPU and nvcc.

    python tools/k5_sweep.py [--variant NAME=-DFLAG,-DFLAG ...]
                             [--source NAME=PATH[:-DFLAG,...] ...]
                             [--ref NAME=PATH ...]
                             [--reps 7] [--turns 2]

Each variant is the package's source built with extra defines; ``--source``
adds another source with the same C entry, ``--ref`` one with the
single-launch C entry of the first K5 (no counts and tiles arguments).
Every build is one nvcc process (the package's flags), all started
together. The 500x500x20 Thompson ridge of chip_smoke.py is built; on its
initial state and on the state after two 1200 s intervals, each build's
K5 call is timed (median of --reps CUDA-event timings of the whole call on
a fresh copy of the state), builds in turn, the order reversed every other
turn. Prints each build's ptxas figures, one JSON line per (state, build,
turn), then the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing, ptxas figures)


def build_all(builds, kernels, out_dir):
    """Compile each (name, source, defines) into out_dir; returns
    {name: (library path, nvcc log)}."""
    nvcc = kernels._nvcc()
    procs = {}
    for name, src, defines in builds:
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, *defines, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, log)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=-DFLAG[,-DFLAG...]: the package's source "
                         "with these defines")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[:-DFLAG,...]: another source with "
                         "the same C entry")
    ap.add_argument("--ref", action="append", default=[],
                    help="NAME=PATH: a source with the first K5's C entry")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    smi = chip_smoke.device_info()
    import numpy as np
    import torch
    from icar_tpu_torch.core import step
    from icar_tpu_torch.models.icar import (RIDGE, RIDGE_PATHS,
                                            ideal_ridge_model)
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.physics import mp_thompson as tp
    from icar_tpu_torch.time_paths import INTERVAL, INTERVALS

    src = os.path.join(ROOT, "icar_tpu_torch", "csrc", "mp_thompson.cu")
    builds = [("package", src, [], False)]
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append((name, src, [f for f in flags.split(",") if f], False))
    for spec in args.source:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        builds.append((name, path, [f for f in flags.split(",") if f],
                       False))
    for spec in args.ref:
        name, path = spec.split("=", 1)
        builds.append((name, path, [], True))

    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_float)
    libs = {}
    with tempfile.TemporaryDirectory() as d:
        built = build_all([b[:3] for b in builds], kernels, d)
        for name, _, defines, old in builds:
            lib = ctypes.CDLL(built[name][0])
            lib.icar_mp_thompson.argtypes = ([P] * (16 if old else 18)
                                             + [I, L, F, P])
            lib.icar_mp_thompson.restype = I
            if not old:
                lib.icar_mp_thompson_tile_columns.argtypes = [I]
                lib.icar_mp_thompson_tile_columns.restype = I
            libs[name] = (lib, old)
            print(json.dumps({"build": name, "defines": defines, "ptxas":
                              chip_smoke.ptxas_figures(built[name][1],
                                                       "mp_thompson")}),
                  flush=True)

    model = ideal_ridge_model(**RIDGE, **RIDGE_PATHS["Thompson"],
                              device="cuda")
    params = step.thompson_params(model.options)
    dev = model.state["pressure"].device
    tabs = tp.device_tables(params, dev)
    states = [("initial", {k: v.clone() for k, v in model.state.items()})]
    for _ in range(INTERVALS):
        model.advance(INTERVAL)
    states.append(("after two intervals", model.state))

    g = model.geom_t
    names = model.advect_names
    smap = tp.stack_smap(names)
    smap_c = (ctypes.c_int * 9)(*smap)
    for label, s in states:
        stack = torch.stack([s[k] for k in names])
        _, nz, ny, nx = stack.shape
        dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                               model.options.run.cfl_reduction_factor,
                               model.options.run.cfl_strictness)
        p, ex = s["pressure"].contiguous(), s["exner"].contiguous()
        dz = g.dz_mass.contiguous()
        acc0 = [s[k] for k in ("precipitation", "snowfall", "graupel")]
        work = torch.empty_like(stack)
        acc = [torch.empty_like(a) for a in acc0]
        counts = torch.empty(2, dtype=torch.int32, device=dev)
        tiles = torch.empty(ny * nx, dtype=torch.int32, device=dev)

        def reset():
            work.copy_(stack)
            for a, a0 in zip(acc, acc0):
                a.copy_(a0)

        def call(name):
            lib, old = libs[name]
            scratch = [] if old else [counts.data_ptr(), tiles.data_ptr()]
            err = lib.icar_mp_thompson(
                work.data_ptr(), ctypes.addressof(smap_c), ex.data_ptr(),
                p.data_ptr(), dz.data_ptr(),
                *(tabs[t].data_ptr() for t in tp.BIG_STACKS
                  + tp.SMALL_STACKS),
                tabs["consts"].data_ptr(), *(a.data_ptr() for a in acc),
                *scratch, nz, ny * nx, float(dt),
                torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: cudaError {err}")

        want = None
        same = {}
        for name in libs:
            reset()
            call(name)
            torch.cuda.synchronize()
            got = [work.clone()] + [a.clone() for a in acc]
            if want is None:
                want = got
            same[name] = all(torch.equal(a.view(torch.int32),
                                         b.view(torch.int32))
                             for a, b in zip(got, want))
            if not libs[name][1] and name == "package":
                active = int(counts[0])
        order = list(libs)
        for turn in range(args.turns):
            for name in (order if turn % 2 == 0 else order[::-1]):
                ms = chip_smoke.cuda_ms(lambda: call(name), args.reps,
                                        setup=reset)
                print(json.dumps({
                    "state": label, "build": name, "turn": turn, "ms": ms,
                    "bit_equal_to_package": same[name],
                    "package_active_tiles": active,
                    "dt": float(np.float32(dt))}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()

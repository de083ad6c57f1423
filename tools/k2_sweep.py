#!/usr/bin/env python3
"""Time builds of kernels K2 and K3 (icar_tpu_torch/csrc/mp_simple.cu)
against each other on the ridge's states, in turns, and hold each to the
package's own build bit for bit. Needs one NVIDIA GPU and nvcc.

    python tools/k2_sweep.py [--variant NAME=-DFLAG,-DFLAG ...]
                             [--source NAME=PATH[:-DFLAG,...] ...]
                             [--reps 7] [--turns 2]

Each variant is the package's source built with extra defines (for
example -DMP_SIMPLE_NO_SKIP); ``--source`` adds another source with the
same C entries icar_mp_simple and icar_mp_simple_rho (an earlier K2/K3
taken from git, or an edited copy). Every build is one nvcc process (the
package's flags), all started together. The
500x500x20 upwind ridge (models.icar RIDGE) is built; K2 is timed on its
initial state and after one 1200 s interval, K3 on the MPDATA ridge after
one interval: each build's call, median of --reps CUDA-event timings on a
fresh copy of the state, builds in turn, the order reversed every other
turn. Prints each build's ptxas figures, one JSON line per (state, build,
turn), then the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing, ptxas figures)
from tools.k5_sweep import build_all  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=-DFLAG[,-DFLAG...]: the package's source "
                         "with these defines")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[:-DFLAG,...]: another source with "
                         "the same C entries")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    smi = chip_smoke.device_info()
    import numpy as np
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.core import step
    from icar_tpu_torch.models.icar import RIDGE, ideal_ridge_model
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.physics import mp_simple as mp_plain
    from icar_tpu_torch.time_paths import INTERVAL

    src = os.path.join(ROOT, "icar_tpu_torch", "csrc", "mp_simple.cu")
    builds = [("package", src, [])]
    for spec in args.variant:
        name, flags = spec.split("=", 1)
        builds.append((name, src, [f for f in flags.split(",") if f]))
    for spec in args.source:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        builds.append((name, path, [f for f in flags.split(",") if f]))

    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_float)
    libs = {}
    with tempfile.TemporaryDirectory() as d:
        built = build_all(builds, kernels, d)
        for name, _, defines in builds:
            lib = ctypes.CDLL(built[name][0])
            lib.icar_mp_simple.argtypes = [P] * 10 + [I, L, F, F, F, P]
            lib.icar_mp_simple_rho.argtypes = [P] * 11 + [I, L, F, F, F, P]
            lib.icar_mp_simple.restype = I
            lib.icar_mp_simple_rho.restype = I
            libs[name] = lib
            print(json.dumps({"build": name, "defines": defines, "ptxas":
                              chip_smoke.ptxas_figures(built[name][1],
                                                       "mp_simple")}),
                  flush=True)

    states = []
    model = ideal_ridge_model(**RIDGE, device="cuda")
    states.append(("upwind initial", model, False,
                   {k: v.clone() for k, v in model.state.items()}))
    model.advance(INTERVAL)
    states.append(("upwind after one interval", model, False, model.state))
    mpdata = ideal_ridge_model(**RIDGE, adv=C.ADV_MPDATA, device="cuda")
    mpdata.advance(INTERVAL)
    states.append(("MPDATA after one interval", mpdata, True, mpdata.state))

    for label, m, rho_operand, s in states:
        g = m.geom_t
        names = m.advect_names
        idx = [names.index(k) for k in step.MP_SPECIES]
        stack = torch.stack([s[k] for k in names])
        nz, ny, nx = s["pressure"].shape
        dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                               m.options.run.cfl_reduction_factor,
                               m.options.run.cfl_strictness)
        c2r, c2s = mp_plain.formation_rates(dt)
        p, ex, dz = s["pressure"], s["exner"], g.dz_interface
        work = torch.empty_like(stack)
        acc0 = (s["precipitation"], s["snowfall"])
        acc = [torch.empty_like(a) for a in acc0]

        def reset():
            work.copy_(stack)
            for a, a0 in zip(acc, acc0):
                a.copy_(a0)

        def call(name):
            fields = [work[i].data_ptr() for i in idx] + [p.data_ptr(),
                                                          ex.data_ptr()]
            rest = [dz.data_ptr(), *(a.data_ptr() for a in acc), nz,
                    ny * nx, float(dt), c2r, c2s,
                    torch.cuda.current_stream().cuda_stream]
            if rho_operand:
                err = libs[name].icar_mp_simple_rho(
                    *fields, s["density"].data_ptr(), *rest)
            else:
                err = libs[name].icar_mp_simple(*fields, *rest)
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
        order = list(libs)
        for turn in range(args.turns):
            for name in (order if turn % 2 == 0 else order[::-1]):
                ms = chip_smoke.cuda_ms(lambda: call(name), args.reps,
                                        setup=reset)
                print(json.dumps({
                    "state": label, "build": name, "turn": turn, "ms": ms,
                    "bit_equal_to_package": same[name],
                    "dt": float(np.float32(dt))}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()

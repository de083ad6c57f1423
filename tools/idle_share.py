#!/usr/bin/env python3
"""A ridge path's device idle share without the profiler. Needs one
NVIDIA GPU.

    python tools/idle_share.py [--repeat 3] [--root PATH] [--path NAME]

Builds the 500x500x20 ridge (models.icar RIDGE) on the path --path of
models.icar RIDGE_PATHS (default upwind; MPDATA, Thompson, fullphys) of
the package under --root (default: this checkout; give another checkout's root to
measure it with the same script), advances one 1200 s interval to warm up,
then times --repeat runs of two intervals each with
time_paths.run_timed, every kernel launch of the package's library
bracketed by two CUDA events on its stream (the events time the launch's
device work and add a few microseconds of host work per launch). Then one
more interval under torch.profiler gives the device time per substep of
everything that is not one of the package's kernels (PyTorch's own
kernels, copies, memsets; the package's kernels are the device events in
an anonymous namespace). Prints one JSON line per run: the wall, the
substeps, each kernel's launches and summed event time, the kernels' share
of the wall, and the idle share, 1 - (kernel events + other device time)
/ wall, the other device time scaled from the profiled interval's per
substep; then the card's name and power limit.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is measured")
    ap.add_argument("--path", default="upwind",
                    help="a path of models.icar RIDGE_PATHS")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, ROOT)

    import chip_smoke
    smi = chip_smoke.device_info()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from icar_tpu_torch.models.icar import (RIDGE, RIDGE_PATHS,
                                            ideal_ridge_model)
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.profile_interval import device_times
    from icar_tpu_torch.time_paths import INTERVAL, run_timed

    model = ideal_ridge_model(**RIDGE, **RIDGE_PATHS[args.path],
                              device="cuda")
    model.advance(INTERVAL)
    torch.cuda.synchronize()

    # every C entry that launches a kernel of a path, bracketed by events
    lib = kernels.library()
    events, entries = {}, {}
    for name in ("icar_advect_upwind", "icar_mp_simple", "icar_mp_simple_rho",
                 "icar_advect_mpdata", "icar_mp_thompson"):
        fn = entries[name] = getattr(lib, name)

        def timed(*a, _fn=fn, _name=name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = _fn(*a)
            end.record()
            events.setdefault(_name, []).append((start, end))
            return err
        setattr(lib, name, timed)

    runs = []
    for _ in range(args.repeat):
        events.clear()
        steps, seconds = run_timed(model)
        ms = {k: sum(s.elapsed_time(e) for s, e in v)
              for k, v in events.items()}
        runs.append({"wall_ms": 1e3 * seconds, "substeps": steps,
                     "launches": {k: len(v) for k, v in events.items()},
                     "kernel_event_ms": ms})
    for name, fn in entries.items():
        setattr(lib, name, fn)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.advance(INTERVAL)
        torch.cuda.synchronize()
    other_us = sum(t for n, (t, _) in device_times(prof).items()
                   if "anonymous namespace" not in n)
    other_ms_per_step = other_us / 1e3 / model.last_n_substeps

    for run in runs:
        kernel_ms = sum(run["kernel_event_ms"].values())
        other_ms = other_ms_per_step * run["substeps"]
        run.update(kernel_share=kernel_ms / run["wall_ms"],
                   other_device_ms=other_ms,
                   idle_share=1 - (kernel_ms + other_ms) / run["wall_ms"],
                   root=os.path.abspath(args.root), path=args.path)
        print(json.dumps(run), flush=True)
    print(smi)


if __name__ == "__main__":
    main()

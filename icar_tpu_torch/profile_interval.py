"""Where the device time of one forcing interval goes: the ideal ridge
(SB04 with upwind or MPDATA advection, Thompson with MPDATA, or the full
physics column) under torch.profiler.

    python -m icar_tpu_torch.profile_interval [--adv upwind|mpdata]
        [--mp simple|thompson] [--path NAME] [--nx 500] [--ny 500]
        [--nz 20] [--interval 1200] [--device cuda] [--mesh SHAPE]

Builds the model (the bench's ridge, 500x500x20 by default; ``--path``
takes a path of ``models.icar.RIDGE_PATHS`` -- upwind, MPDATA, Thompson,
fullphys, linear, fullphys_kf, ... -- instead of --adv and --mp), advances one interval to
warm up (the kernel build and first launches), then profiles one more
interval (on the linear path each interval follows its wind update, as in
bench.py)
and prints each device activity (kernels, copies, memsets) with its total
time and count, then one JSON line: the wall time of the profiled
interval, the summed device time, the device's idle share (1 - device
time / wall, on one stream) and the card's name. The wall time includes
the profiler's own cost. With ``--device cpu`` there is no device time
and the idle share is null. ``--mesh cards`` shards the model with one
shard per visible card (``parallel.mesh.make_mesh``; ``--path fullphys``
is then bench.py --config conus), ``--mesh MYxMX`` over that grid of
shards on the model's device (on the card: every block's launches on one
stream).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import constants as C
from .models.icar import RIDGE as FULL_RIDGE, RIDGE_PATHS, ideal_ridge_model
from .parallel.mesh import Mesh, make_mesh

# bench.py's ridge case apart from its size
RIDGE = {k: v for k, v in FULL_RIDGE.items() if k not in ("nx", "ny", "nz")}
ADVECTION = {"upwind": C.ADV_UPWIND, "mpdata": C.ADV_MPDATA}
MICROPHYSICS = {"simple": C.MP_SIMPLE, "thompson": C.MP_THOMPSON}


def device_times(prof):
    """{name: [device microseconds, count]} of the profile's device-side
    events, longest first."""
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = out.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us()
            t[1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--adv", choices=sorted(ADVECTION), default="mpdata")
    ap.add_argument("--mp", choices=sorted(MICROPHYSICS), default="simple")
    ap.add_argument("--path", choices=sorted(RIDGE_PATHS), default=None,
                    help="a path of RIDGE_PATHS instead of --adv and --mp")
    ap.add_argument("--nx", type=int, default=500)
    ap.add_argument("--ny", type=int, default=500)
    ap.add_argument("--nz", type=int, default=20)
    ap.add_argument("--interval", type=float, default=1200.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="cards (one shard per visible card) or MYxMX "
                         "shards on --device")
    args = ap.parse_args(argv)

    opts = (RIDGE_PATHS[args.path] if args.path else
            dict(adv=ADVECTION[args.adv], mp=MICROPHYSICS[args.mp]))
    model = ideal_ridge_model(nx=args.nx, ny=args.ny, nz=args.nz, **RIDGE,
                              **opts, device=args.device)
    if args.mesh == "cards":
        model.attach_mesh(make_mesh(args.nx, args.ny))
    elif args.mesh:
        my, mx = (int(n) for n in args.mesh.split("x"))
        model.attach_mesh(Mesh([model.device] * (my * mx), (my, mx)))
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if model.winds_follow_state:
        model.update_winds()
    model.advance(args.interval)
    sync()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if model.winds_follow_state:
            model.update_winds()
        model.advance(args.interval)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    times = device_times(prof)
    device_ms = sum(t for t, _ in times.values()) / 1e3
    for name, (us, count) in times.items():
        print(f"{us / 1e3:10.3f} ms {100 * us / 1e3 / wall_ms:5.1f}% "
              f"{count:5d}x  {name}")
    print(json.dumps({
        "path": args.path, "adv": args.adv, "mp": args.mp,
        "mesh": args.mesh,
        "shape": [args.nz, args.ny, args.nx],
        "substeps": model.last_n_substeps, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall_ms if on_card else None,
        "device": (torch.cuda.get_device_name(model.device) if on_card
                   else "cpu")}))
    return times


if __name__ == "__main__":
    main()

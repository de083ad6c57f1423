"""Throughput of the ridge paths on the card, measured repeatedly.

    python -m icar_tpu_torch.time_paths [--repeat 5] [--mesh cards]

For each path of ``RIDGE_PATHS`` on bench.py's ridge at 500x500x20
(``models.icar.RIDGE``: SB04 + upwind, SB04 + MPDATA, Thompson + MPDATA,
the full physics column of bench.py --config fullphys, SB04 + upwind on
the linear-theory winds of bench.py --config linear, and the general
loop's options: density advection, the microphysics throttle, the full
physics column with MPDATA or SB04; bench.py --config fullphys_rrtmg
with Noah, RRTMG and YSU, and as bench.py builds it; the ridge with WSM3,
WSM6 or Morrison in SB04's place; the full physics column with
Kain-Fritsch, NSAS or BMJ in Tiedtke's place; bench.py --config
mpdata_thompson with Thompson-aerosol, without and with the aerosol-aware
option) it builds a fresh
model, advances one 1200 s interval to warm up, then times ``--repeat``
runs of two intervals each (``run_timed``) and prints one JSON line: for
each path the grid-point substeps per second of every run over the
natural grid, their median and the final state's float64 digest
(``ICARModel.digest``), and the card's name; for the full-physics path
(and the other column-physics paths) and the paths of WSM3, WSM6,
Morrison and the aerosol-aware scheme also the CUDA-event milliseconds
of each stage of one more
interval (``StageTimer``; the ``convection`` stage holds whichever
scheme the path runs); for the linear path, whose winds are solved
anew before each interval as bench.py does, the milliseconds of each of
those updates (left out of the rate) and the stages of one more (N^2,
lookup, balance). With ``--mesh cards`` the model is sharded with one
shard per visible card (``make_mesh``; the paths of ``SHARDED_PATHS``,
among them fullphys, which is then bench.py --config conus, its stages
summed over the blocks, and linear, bench.py --config linear --sharded,
its wind solve one solve of the whole domain); its digest equals the unsharded run's. ``chip_smoke.py`` drives the same
cases through the same ``run_timed``; this module repeats the measurement
so that two checkouts can be compared in one call on one card (run it
from each checkout in turns).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from .core.step import PLAIN_MP, aerosol_aware, column_physics
from .models.icar import RIDGE, RIDGE_PATHS, SHARDED_PATHS, ideal_ridge_model

INTERVAL = 1200.0
INTERVALS = 2


def run_timed(model, intervals=INTERVALS, interval=INTERVAL, wind_ms=None):
    """Advance ``model`` over ``intervals`` intervals of ``interval``
    seconds, host clock between two ``torch.cuda.synchronize()``: (the
    substeps taken, the seconds). A model whose winds follow its state
    (``ICARModel.winds_follow_state``: linear theory) solves them anew
    before each interval (``ICARModel.update_winds``), as bench.py
    --config linear does; each update is timed between two synchronizes
    and left out of the seconds, its milliseconds appended to ``wind_ms``
    when given."""
    torch.cuda.synchronize()
    steps, wind_s = 0, 0.0
    t0 = time.perf_counter()
    for _ in range(intervals):
        if model.winds_follow_state:
            torch.cuda.synchronize()
            tw = time.perf_counter()
            model.update_winds()
            torch.cuda.synchronize()
            dt = time.perf_counter() - tw
            wind_s += dt
            if wind_ms is not None:
                wind_ms.append(1e3 * dt)
        model.advance(interval)
        steps += model.last_n_substeps
    torch.cuda.synchronize()
    return steps, time.perf_counter() - t0 - wind_s


class StageTimer:
    """CUDA-event milliseconds of the named stages of the interval loops
    (the ``timer`` of ``core.step.run_interval_physics`` and of
    ``run_interval_sharded``: diagnostics, the column stages, the
    microphysics' -- mp_simple, mp_simple_rho, mp_thompson,
    mp_thompson_aer, mp_wsm3, mp_wsm6, mp_morrison --, advection): each
    call ``timer(name)``
    brackets a stage's work with two events on the current stream;
    ``ms()`` synchronizes and sums them per stage."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.setdefault(name, []).append((start, end))

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}


def stage_ms(model, interval=INTERVAL):
    """The CUDA-event milliseconds of each stage of one more interval of
    ``model`` (a column-physics path, or one of WSM3, WSM6 or Morrison),
    with the interval's wall and substeps."""
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.advance(interval, timer=timer)
    ms = timer.ms()
    return {"stages_ms": ms, "wall_ms": 1e3 * (time.perf_counter() - t0),
            "substeps": model.last_n_substeps}


def wind_stage_ms(model):
    """The CUDA-event milliseconds of each stage of one more wind update of
    ``model`` (a path whose winds follow its state), with its wall."""
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.update_winds(timer=timer)
    ms = timer.ms()
    return {"stages_ms": ms, "wall_ms": 1e3 * (time.perf_counter() - t0)}


def time_path(case, repeat, cards=False):
    """(gp*steps/s of each of ``repeat`` runs of INTERVALS intervals, the
    final state's digest, the stage times of one more interval of a
    column-physics path or None, the milliseconds of each wind update and
    the stages of one more for a path whose winds follow its state, or
    None); with ``cards``, one shard per visible card."""
    from .parallel.mesh import make_mesh
    model = ideal_ridge_model(**RIDGE, **case, device="cuda")
    if cards:
        model.attach_mesh(make_mesh(RIDGE["nx"], RIDGE["ny"]))
    run_timed(model, intervals=1)
    gp = RIDGE["nx"] * RIDGE["ny"] * RIDGE["nz"]
    rates, wind_ms = [], []
    for _ in range(repeat):
        steps, seconds = run_timed(model, wind_ms=wind_ms)
        rates.append(gp * steps / seconds)
    digest = model.digest()
    stages = (stage_ms(model) if column_physics(model.options)
              or model.options.physics.microphysics in PLAIN_MP
              or aerosol_aware(model.options) else None)
    winds = ({"update_ms": wind_ms, "one_update": wind_stage_ms(model)}
             if model.winds_follow_state else None)
    return rates, digest, stages, winds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--mesh", choices=["cards"], default=None,
                    help="cards: one shard per visible card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_paths: no CUDA device")
    paths = SHARDED_PATHS if args.mesh else list(RIDGE_PATHS)
    out = {"device": torch.cuda.get_device_name(0),
           "cards": torch.cuda.device_count(), "mesh": args.mesh}
    for name in paths:
        rates, digest, stages, winds = time_path(
            RIDGE_PATHS[name], args.repeat, args.mesh == "cards")
        out[name] = {"gp_steps_per_s": rates,
                     "median": statistics.median(rates), "digest": digest}
        if stages is not None:
            out[name]["one_interval"] = stages
        if winds is not None:
            out[name]["wind_update"] = winds
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

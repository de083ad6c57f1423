#!/usr/bin/env python3
"""How many PyTorch operations the full-physics column launches: each
stage of one substep of the full-physics ridge, counted on the CPU.

    python tools/count_ops.py [--nz 20] [--path fullphys_rrtmg_noah]

Builds the full-physics ridge (models.icar FULLPHYS, or with ``--path
fullphys_rrtmg_noah`` its RRTMG + YSU variant) at a small width on the
CPU, advances one 600 s interval, then runs each column-physics stage of
core/physics_step.py once on that state under a dispatch counter and
prints one JSON line: the aten operations each stage dispatches (on the
card each is a launch or a view) and the interval's total with its
substeps. The counts do not depend on the width (the schemes hold no
branch on the data in Python, apart from the PBL's diffusion substeps),
but for RRTMG, whose call repeats per chunk of RRTMG_COL_CHUNK columns
(``rrtmg_ops`` counts it on a model of any size and device, as
chip_smoke.py does at full width); Tiedtke's grow with the levels (its
level scans).
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count(fn, *a):
    """The aten operations ``fn(*a)`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    c = Count()
    with c:
        fn(*a)
    return c.n


def rrtmg_ops(m):
    """The aten operations of one call of each RRTMG stage and of YSU on
    the state of ``m`` (a model of the fullphys_rrtmg_noah path, on any
    device): {stage: count}."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics.rrtmg_lw import TorchCdf
    s = diagnostic_update(m.state, m.geom_t, full=True)
    g = ps.Statics(m.geom_t, m.options)
    dev = s["pressure"].device
    aux = m._time_aux()
    doy = torch.tensor(float(aux["day_of_year0"]), device=dev)
    year = torch.tensor(float(aux["year_length"]), device=dev)
    dt = torch.tensor(25.0, device=dev)
    s = ps.rrtmg_zenith(s, g, doy, year)
    stages = {}

    @contextlib.contextmanager
    def stage(name):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                stages[name] = stages.get(name, 0) + 1
                return func(*args, **(kwargs or {}))
        with Count():
            yield
    total = count(ps.radiation_rrtmg, s, g, m.options, 0.0, doy, year, dt,
                  TorchCdf(), stage)
    stages["radiation (RRTMG call)"] = total
    stages["pbl_ysu"] = count(ps.boundary_layer_ysu, s, g, dt)
    return stages


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nz", type=int, default=20)
    ap.add_argument("--path", default="fullphys",
                    choices=("fullphys", "fullphys_rrtmg_noah"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.models.icar import RIDGE_PATHS, ideal_ridge_model

    m = ideal_ridge_model(nx=30, ny=12, nz=args.nz, dx=1000.0,
                          hill_height=600.0, u_speed=9.0, rh=1.0,
                          **RIDGE_PATHS[args.path], device="cpu")
    m.advance(600.0)
    s = diagnostic_update(m.state, m.geom_t, full=False, with_w_real=True)
    g = ps.Statics(m.geom_t)
    dt = torch.tensor(25.0)
    aux = m._time_aux()
    doy = torch.tensor(float(aux["day_of_year0"]))
    year = torch.tensor(float(aux["year_length"]))
    ops = {"surface (Noah and simple water)": count(
        ps.surface_fluxes, s, g, m.options, dt),
        "apply_fluxes": count(ps.apply_fluxes, s, g, m.options, dt),
        "convection (Tiedtke)": count(ps.convection, s, g, m.options, dt)}
    if args.path == "fullphys":
        ops.update(radiation=count(ps.radiation, s, g, doy, year, dt),
                   pbl=count(ps.boundary_layer, s, g, dt))
    else:
        ops.update(rrtmg_ops(m))
    out = {"nz": args.nz, "path": args.path, "ops_per_call": ops}
    out.update(interval_ops=count(m.advance, 600.0),
               interval_substeps=m.last_n_substeps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

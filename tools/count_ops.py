#!/usr/bin/env python3
"""How many PyTorch operations the full-physics column launches: each
stage of one substep of the full-physics ridge, counted on the CPU.

    python tools/count_ops.py [--nz 20]

Builds the full-physics ridge (models.icar FULLPHYS) at a small width on
the CPU, advances one 600 s interval, then runs each column-physics stage
of core/physics_step.py once on that state under a dispatch counter and
prints one JSON line: the aten operations each stage dispatches (on the
card each is a launch or a view) and the interval's total with its
substeps. The counts do not depend on the width (the schemes hold no
branch on the data in Python, apart from the PBL's diffusion substeps);
Tiedtke's grow with the levels (its level scans).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nz", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.models.icar import FULLPHYS, ideal_ridge_model

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def count(fn, *a):
        c = Count()
        with c:
            fn(*a)
        return c.n

    m = ideal_ridge_model(nx=30, ny=12, nz=args.nz, dx=1000.0,
                          hill_height=600.0, u_speed=9.0, rh=1.0,
                          **FULLPHYS, device="cpu")
    m.advance(600.0)
    s = diagnostic_update(m.state, m.geom_t, full=False, with_w_real=True)
    g = ps.Statics(m.geom_t)
    dt = torch.tensor(25.0)
    aux = m._time_aux()
    doy = torch.tensor(float(aux["day_of_year0"]))
    year = torch.tensor(float(aux["year_length"]))
    out = {"nz": args.nz, "ops_per_call": {
        "radiation": count(ps.radiation, s, g, doy, year, dt),
        "surface (Noah and simple water)": count(ps.surface_fluxes, s, g,
                                                 m.options, dt),
        "apply_fluxes": count(ps.apply_fluxes, s, g, m.options, dt),
        "pbl": count(ps.boundary_layer, s, g, dt),
        "convection (Tiedtke)": count(ps.convection, s, g, m.options, dt)}}
    c = Count()
    with c:
        m.advance(600.0)
    out.update(interval_ops=c.n, interval_substeps=m.last_n_substeps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

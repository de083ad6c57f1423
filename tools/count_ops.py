#!/usr/bin/env python3
"""How many PyTorch operations the full-physics column launches: each
stage of one substep of the full-physics ridge, counted on the CPU.

    python tools/count_ops.py [--nz 20] [--path fullphys_rrtmg_noah]

Builds the full-physics ridge (models.icar FULLPHYS, or with ``--path
fullphys_rrtmg_noah`` its RRTMG + YSU variant, or with ``--path
fullphys_rrtmg`` that variant with Noah-MP, as bench.py builds it, or
with ``--path fullphys_lake`` the fullphys ridge with the lake) at a small
width on the CPU, advances one 600 s interval, then runs each
column-physics stage of
core/physics_step.py once on that state under a dispatch counter and
prints one JSON line: the aten operations each stage dispatches (on the
card each is a launch or a view) and the interval's total with its
substeps. The counts do not depend on the width (the schemes hold no
branch on the data in Python, apart from the PBL's diffusion substeps),
but for RRTMG, whose call repeats per chunk of RRTMG_COL_CHUNK columns
(``rrtmg_ops`` counts it on a model of any size and device, as
chip_smoke.py does at full width); Tiedtke's grow with the levels (its
level scans). ``noahmp_ops`` counts one Noah-MP and one glacier column
call; ``lake_ops`` one CLM lake call (``--path fullphys_lake``: the
fullphys ridge with water=3 and chip_smoke.py's lake band);
``wsm3_ops``, ``wsm6_ops`` and ``morrison_ops`` one call of that
microphysics scheme on a model's state (``--path wsm3``, ``wsm6`` or
``morrison``: the ridge with that scheme in SB04's place, no column
physics; their sedimentation loops run as many trips as the state's
fastest fall needs, so these counts follow the state); ``kf_ops``,
``nsas_ops`` and ``bmj_ops`` one call of that convection scheme within
the convection stage (``--path fullphys_kf``, ``fullphys_nsas`` or
``fullphys_bmj``: the fullphys ridge with that scheme in Tiedtke's place;
Kain-Fritsch's closure runs as many trips, and its feedback substeps as
many steps, as the state's convecting columns need, each trip's host read
counted as one operation, so its count follows the state);
``thompson_aer_ops`` one call of the aerosol-aware Thompson-Eidhammer
scheme (``--path thompson_aer_aware``: bench.py's mpdata_thompson ridge
with mp=5 and the aerosol-aware option; its four sedimentation loops run
as many trips as the state's fastest fall needs).
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


def _time_scalars(m):
    """(doy, year length) of ``m``'s interval as 0-d tensors on its
    device."""
    import torch
    aux = m._time_aux()
    dev = m.device
    return (torch.tensor(float(aux["day_of_year0"]), device=dev),
            torch.tensor(float(aux["year_length"]), device=dev))


def noahmp_ops(m):
    """The aten operations of one ``noahmp_driver`` call and one
    ``glacier_sflx`` call within one surface stage (lsm_dt 300 s) on the
    state of ``m`` (a model of the fullphys_rrtmg path, on any device),
    and of the whole stage: {name: count}. No column reads back to the
    host, so the counts do not depend on the state; on the CPU they hold
    a few more, which depend on the width (``ops/pointwise.py`` pads and
    cuts its operands there)."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics import noahmp, noahmp_glacier
    s = diagnostic_update(m.state, m.geom_t, full=True)
    g = ps.Statics(m.geom_t, m.options)
    doy, year = _time_scalars(m)
    counts = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrap(*a, **k):
            out = []
            counts[name] = count(lambda: out.append(fn(*a, **k)))
            return out[0]
        return fn, wrap
    wrapped = [(mod, name) + counted(mod, name) for mod, name in (
        (noahmp, "noahmp_driver"), (noahmp_glacier, "glacier_sflx"))]
    try:
        for mod, name, _, wrap in wrapped:
            setattr(mod, name, wrap)
        total = count(ps.surface_fluxes, s, g, m.options,
                      torch.tensor(300.0, device=m.device), doy, year)
    finally:
        for mod, name, fn, _ in wrapped:
            setattr(mod, name, fn)
    counts["surface stage (Noah-MP, glacier, simple water)"] = total
    return counts


def lake_ops(m):
    """The aten operations of one ``lake_driver`` call within one surface
    stage (lsm_dt 300 s) on the state of ``m`` (a model with water=3, on
    any device), and of the whole stage: {name: count}. The lake reads
    nothing back to the host, so the count does not depend on the state
    (on the CPU it holds a few more, as ``noahmp_ops`` says)."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics import water_lake
    s = diagnostic_update(m.state, m.geom_t, full=True)
    g = ps.Statics(m.geom_t, m.options)
    counts = {}
    fn = water_lake.lake_driver

    def wrap(*a, **k):
        out = []
        counts["lake_driver"] = count(lambda: out.append(fn(*a, **k)))
        return out[0]
    water_lake.lake_driver = wrap
    try:
        total = count(ps.surface_fluxes, s, g, m.options,
                      torch.tensor(300.0, device=m.device))
    finally:
        water_lake.lake_driver = fn
    counts["surface stage (lake, simple water, the land's scheme)"] = total
    return counts


def _plain_mp_ops(m, mp):
    """The aten operations of one call of the scheme ``mp`` (WSM3, WSM6
    or Morrison) on the state of ``m`` (a model of that scheme, on any
    device) at its interval's dt, and of the call with the copies of its
    outputs into the species stack (``core.step.plain_microphysics``):
    {name: count}. The host reads of the sedimentation count as one
    operation each."""
    import torch
    from icar_tpu_torch.core import step
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    s = diagnostic_update(m.state, m.geom_t, full=False, with_w_real=True)
    g = m.geom_t
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           m.options.run.cfl_reduction_factor,
                           m.options.run.cfl_strictness)
    q = torch.stack([s[k] for k in m.advect_names])
    acc = [s[k].clone() if k in s else None
           for k in ("precipitation", "snowfall", "graupel")]
    mod = step.PLAIN_MP[mp]
    name = {"mp_wsm3": "wsm3", "mp_wsm6": "wsm6",
            "mp_morrison": "mp_morrison"}[step.plain_mp_stage(mp)]
    fn = getattr(mod, name)
    counts = {}

    def wrap(*a, **k):
        out = []
        counts[name] = count(lambda: out.append(fn(*a, **k)))
        return out[0]
    setattr(mod, name, wrap)
    try:
        total = count(step.plain_microphysics, mp, q, m.advect_names, s,
                      g.dz_mass, dt, *acc)
    finally:
        setattr(mod, name, fn)
    counts[f"{name} with the stack's copies"] = total
    return counts


def wsm3_ops(m):
    """``_plain_mp_ops`` of WSM3 (mp=6)."""
    from icar_tpu_torch import constants as C
    return _plain_mp_ops(m, C.MP_WSM3)


def wsm6_ops(m):
    """``_plain_mp_ops`` of WSM6 (mp=4)."""
    from icar_tpu_torch import constants as C
    return _plain_mp_ops(m, C.MP_WSM6)


def morrison_ops(m):
    """``_plain_mp_ops`` of Morrison (mp=3)."""
    from icar_tpu_torch import constants as C
    return _plain_mp_ops(m, C.MP_MORRISON)


PLAIN_MP_OPS = {"wsm3": wsm3_ops, "wsm6": wsm6_ops,
                "morrison": morrison_ops}


def thompson_aer_ops(m):
    """The aten operations of one call of the aerosol-aware scheme
    (``mp_thompson.mp_thompson_aer``) on the state of ``m`` (a model of the
    thompson_aer_aware path, on any device) at its interval's dt, and of
    the call with the surface flux and the copies into the species stack
    (``core.step.thompson_aer_microphysics``) and of the effective radii
    after it: {name: count}. The host reads of the sedimentation count as
    one operation each."""
    import torch
    from icar_tpu_torch.core import step
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics import mp_thompson
    s = diagnostic_update(m.state, m.geom_t, full=False)
    g = m.geom_t
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           m.options.run.cfl_reduction_factor,
                           m.options.run.cfl_strictness)
    q = torch.stack([s[k] for k in m.advect_names])
    acc = [s[k].clone() for k in ("precipitation", "snowfall", "graupel")]
    params = step.thompson_params(m.options)
    fn = mp_thompson.mp_thompson_aer
    counts = {}

    def wrap(*a, **k):
        out = []
        counts["mp_thompson_aer"] = count(lambda: out.append(fn(*a, **k)))
        return out[0]
    mp_thompson.mp_thompson_aer = wrap
    try:
        total = count(step.thompson_aer_microphysics, q, m.advect_names, s,
                      g.dz_mass, dt, *acc, params)
    finally:
        mp_thompson.mp_thompson_aer = fn
    counts["mp_thompson_aer with the flux and the stack's copies"] = total
    counts["effective_radii"] = count(step.effective_radii, s, q,
                                      m.advect_names, params, True)
    return counts


SCHEME_OPS = dict(PLAIN_MP_OPS, thompson_aer_aware=thompson_aer_ops)


def _convection_ops(m, module, name):
    """The aten operations of one call of ``module.name`` (a convection
    scheme) within one convection stage (dt 25 s) on the state of ``m``
    (a model of that scheme, on any device), and of the whole stage:
    {name: count}."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    s = diagnostic_update(m.state, m.geom_t, full=False, with_w_real=True)
    g = ps.Statics(m.geom_t)
    fn = getattr(module, name)
    counts = {}

    def wrap(*a, **k):
        out = []
        counts[name] = count(lambda: out.append(fn(*a, **k)))
        return out[0]
    setattr(module, name, wrap)
    try:
        total = count(ps.convection, s, g, m.options,
                      torch.tensor(25.0, device=m.device))
    finally:
        setattr(module, name, fn)
    counts["convection stage"] = total
    return counts


def kf_ops(m):
    """``_convection_ops`` of Kain-Fritsch (conv=3, ``cu_kf.kfcps``)."""
    from icar_tpu_torch.physics import cu_kf
    return _convection_ops(m, cu_kf, "kfcps")


def nsas_ops(m):
    """``_convection_ops`` of NSAS (conv=4, ``cu_nsas.nsas``)."""
    from icar_tpu_torch.physics import cu_nsas
    return _convection_ops(m, cu_nsas, "nsas")


def bmj_ops(m):
    """``_convection_ops`` of BMJ (conv=5, ``cu_bmj.bmj``)."""
    from icar_tpu_torch.physics import cu_bmj
    return _convection_ops(m, cu_bmj, "bmj")


CONVECTION_OPS = {"fullphys_kf": kf_ops, "fullphys_nsas": nsas_ops,
                  "fullphys_bmj": bmj_ops}


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
                    choices=("fullphys", "fullphys_rrtmg_noah",
                             "fullphys_rrtmg", "fullphys_lake")
                    + tuple(SCHEME_OPS) + tuple(CONVECTION_OPS))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.models.icar import RIDGE_PATHS, ideal_ridge_model

    lake = args.path == "fullphys_lake"
    opts = (dict(RIDGE_PATHS["fullphys"], water=C.WATER_LAKE) if lake
            else RIDGE_PATHS[args.path])
    m = ideal_ridge_model(nx=30, ny=12, nz=args.nz, dx=1000.0,
                          hill_height=600.0, u_speed=9.0, rh=1.0,
                          **opts, device="cpu")
    if args.path in SCHEME_OPS or args.path in CONVECTION_OPS:
        m.advance(600.0)
        fn = SCHEME_OPS.get(args.path) or CONVECTION_OPS[args.path]
        print(json.dumps({"nz": args.nz, "path": args.path,
                          "ops_per_call": fn(m)}))
        return
    if lake:
        import chip_smoke
        chip_smoke.install_lake(m, (2, 10))
    m.advance(600.0)
    s = diagnostic_update(m.state, m.geom_t, full=False, with_w_real=True)
    g = ps.Statics(m.geom_t)
    dt = torch.tensor(25.0)
    doy, year = _time_scalars(m)
    ops = {"apply_fluxes": count(ps.apply_fluxes, s, g, m.options, dt),
           "convection (Tiedtke)": count(ps.convection, s, g, m.options, dt)}
    if args.path == "fullphys_rrtmg":
        ops.update(noahmp_ops(m))
    elif lake:
        ops.update(lake_ops(m))
    else:
        ops["surface (Noah and simple water)"] = count(
            ps.surface_fluxes, s, g, m.options, dt)
    if args.path in ("fullphys", "fullphys_lake"):
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

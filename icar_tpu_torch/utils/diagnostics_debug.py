"""Runtime sanity checks and wall-clock timers
(icar_tpu/utils/diagnostics_debug.py).

Replaces debug_module::domain_check (debug_utils.f90:9-194 of the
reference) and timer_t (timer_h.f90, timer_obj.f90). ``domain_check``
scans torch tensors on their device and reads back only the counts and
extremes it reports; the timers are copies of the JAX package's (held to
them by tests/test_torch_setup.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# (field, less_than, greater_than) bounds from domain_check
# (debug_utils.f90:20-42)
_CHECKS: List[Tuple[str, Optional[float], Optional[float]]] = [
    ("potential_temperature", 100.0, 600.0),
    ("water_vapor", -1e-10, 0.2),
    ("cloud_water", -1e-10, None),
    ("cloud_ice", -1e-10, None),
    ("ice_number", -1e-1, None),
    ("snow_mass", -1e-10, None),
    ("snow_number", -1e-1, None),
    ("rain_mass", -1e-10, None),
    ("rain_number", -1e-1, None),
    ("graupel_mass", -1e-10, None),
    ("graupel_number", -1e-1, None),
    ("w", -1e5, 1e5),
    ("sensible_heat", None, None),
    ("latent_heat", None, None),
    ("skin_temperature", None, None),
    ("roughness_z0", None, None),
    ("surface_pressure", None, None),
    ("exner", None, None),
    ("pressure_interface", None, None),
    ("pressure", None, None),
]


def domain_check(state: Dict[str, torch.Tensor], msg: str = "",
                 fix: bool = False, verbose: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Range/NaN scan of the model state (domain_check, debug_utils.f90:9).

    Returns (possibly-fixed state, list of problem descriptions)."""
    problems: List[str] = []
    s = dict(state)
    for name, lo, hi in _CHECKS:
        if name not in s:
            continue
        arr = s[name]
        n_nan = int((~torch.isfinite(arr)).sum())
        if n_nan:
            problems.append(f"{msg} {name} has {n_nan} non-finite value(s)")
        vals = arr[~torch.isnan(arr)]       # nanmin / nanmax
        if not vals.numel():
            continue
        lowest, highest = (float(v) for v in torch.aminmax(vals))
        if lo is not None and lowest < lo:
            problems.append(f"{msg} {name} below {lo}: min {lowest:.4g}")
            if fix:
                s[name] = torch.clamp(s[name], min=lo if lo > 0 else 0.0)
        if hi is not None and highest > hi:
            problems.append(f"{msg} {name} above {hi}: max {highest:.4g}")
            if fix:
                s[name] = torch.clamp(s[name], max=hi)
    if verbose:
        for p in problems:
            print("domain_check:", p)
    return s, problems


class Timer:
    """Copy of icar_tpu/utils/diagnostics_debug.py.
    Wall-clock timer (timer_t, timer_h.f90:16-32)."""

    def __init__(self):
        self.total = 0.0
        self._start: Optional[float] = None

    def start(self):
        self._start = time.time()

    def stop(self):
        if self._start is not None:
            self.total += time.time() - self._start
            self._start = None

    def reset(self):
        self.total = 0.0
        self._start = None

    def get_time(self) -> float:
        running = time.time() - self._start if self._start is not None else 0.0
        return self.total + running

    def as_string(self) -> str:
        t = self.get_time()
        if t < 1:
            return f"{t*1000:.1f} ms"
        if t < 60:
            return f"{t:.2f} s"
        return f"{t/60:.2f} min"


class Timers:
    """Copy of icar_tpu/utils/diagnostics_debug.py.
    Named timer registry for init/input/physics/output accounting
    (driver.f90:46,204-217)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def __getitem__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer()
        return self._timers[name]

    def report(self) -> str:
        lines = ["Model timing:"]
        for name, t in sorted(self._timers.items()):
            lines.append(f"  {name:16s} {t.as_string()}")
        return "\n".join(lines)

"""Copy of icar_tpu/utils/model_tracking.py, kept identical by tests/test_torch_setup.py.

Namelist-version tracking: per-release option-file changes.

TPU-native equivalent of the reference's ``model_tracking`` module
(src/main/model_tracking.f90:19-123) and ``version_check``
(src/objects/options_obj.f90:280-310): when an options file declares a
namelist version that does not match the running model, the run stops
and every namelist-relevant change *since that version* is printed so
the user knows how to upgrade their options file.

The change descriptions below are condensed summaries of the reference
history (model_tracking.f90:26-65), not the original text.
"""

from __future__ import annotations

from .. import constants as C

# (version, summary of namelist-relevant changes introduced IN that version)
VERSION_HISTORY = [
    ("0.5.1", "earliest tracked version"),
    ("0.5.2", "dxlow plus forcing variable-name options (p/t/qv/qc/qi, "
              "u/v, hi/low-res lat/lon)"),
    ("0.6", "variable names for sensible/latent heat flux and PBL height"),
    ("0.7", "separate input vs output intervals; dz/decrease_dz removed"),
    ("0.7.1", "zvar and landvar names; readz flag; x/y min/max bounds"),
    ("0.7.2", "x/y min/max removed; dz_levels moved into a z_info group"),
    ("0.7.3", "advect_density flag"),
    ("0.8", "vertical interpolation needs zvar (geopotential ok); "
            "smooth_wind_distance"),
    ("0.8.1", "proper date tracking: date='yyyy/mm/dd hh:mm:ss'"),
    ("0.8.2", "preliminary Noah LSM support"),
    ("0.9", "add_low_topo removed; mp_options and lt_options groups"),
    ("0.9.1", "MPDATA advection and adv_options group"),
    ("0.9.2", "output z-axis changed"),
    ("0.9.3", "end_date; date renamed forcing_start_date; "
              "forcing_file_list; lt LUT_filename; mp update_interval; "
              "vert_smooth moved to lt_parameters; z_is_geopotential"),
    ("0.9.4", "Morrison/WSM6 microphysics; low-res linear wind removal; "
              "online bias correction"),
    ("0.9.5", "convective wind advection; improved linear wind LUT"),
    ("1.0", "stable checkpoint release"),
    ("1.0.1", "improved geographic interpolation and time handling"),
    ("2.0a1", "coarray rewrite; many options overhauled"),
    ("2.0a2", "spatially variable dz coordinate"),
    ("2.0a3", "output variables must be listed in the namelist"),
    ("2.1", "reference 2.1 release"),
]

#: versions this build accepts: its own string plus the reference release
#: it is namelist-compatible with.
COMPATIBLE_VERSIONS = (C.VERSION_STRING, "2.1")


def changes_since(version: str) -> str:
    """Human-readable list of namelist changes since ``version``
    (print_model_diffs, model_tracking.f90:73-107)."""
    names = [v for v, _ in VERSION_HISTORY]
    lines = ["Model changes:"]
    if version in names:
        i = names.index(version)
        if i < 5:
            lines.append(" (versions <0.7.3 may not be as reliable)")
        for v, delta in VERSION_HISTORY[i + 1:]:
            lines.append(f"  {v}: {delta}")
    else:
        lines.append("  unable to find a matching version; full history:")
        for v, delta in VERSION_HISTORY:
            lines.append(f"  {v}: {delta}")
    return "\n".join(lines)


def check_version(version: str) -> None:
    """Stop if the options-file version is incompatible
    (version_check, options_obj.f90:280-310)."""
    if version in COMPATIBLE_VERSIONS:
        return
    raise ValueError(
        "Model version does not match namelist version\n"
        f"  Model version: {C.VERSION_STRING} (accepts "
        f"{', '.join(COMPATIBLE_VERSIONS)})\n"
        f"  Namelist version: {version}\n" + changes_since(version))

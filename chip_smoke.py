#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (icar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from icar_tpu_torch/csrc, then:
1. checks K1 (upwind) and K2 (SB04) against their plain PyTorch versions on
   the card at the ridge's 500x500x20 shapes (K2 on its initial state and
   after one interval, and on seeded columns of 96 levels, K3 too); K1
   also bit for bit against its kernel-order oracle (upwind_oracle) there
   and on a random stack of K1_DEEP (96 levels, 9 species); K1's line in
   the table adds the copy floor (the same bytes moved with no stencil,
   csrc/upwind_floor.cu), its launch (tile, blocks per SM, waves) and its
   registers, spills and shared memory from the build log; K2's and K3's
   lines add the share of column tiles that ran each fall loop, the time
   on the initial state, the tile width and their build figures;
2. runs the pinned golden ridge case (tests/golden/ideal_ridge_100.npz);
3. drives the upwind ridge -- ideal_ridge_model(...).advance() at
   500x500x20 -- and checks that it went through K1 and K2 once per
   substep;
4. builds the MPDATA ridge (adv=ADV_MPDATA, order 2 with FCT) at
   500x500x20, and checks K4 (MPDATA) at its shapes, at other orders on a
   smaller random stack, and K3 (SB04 with the state's density) against
   their plain versions;
5. drives the MPDATA ridge and checks that it went through K3 and K4 once
   per substep and through K1 and K2 not at all;
6. checks and times K5 (Thompson) on the Thompson ridge's initial state
   (the MPDATA ridge with mp=MP_THOMPSON, the path of bench.py --config
   mpdata_thompson), then drives that ridge at 500x500x20 and checks that
   it went through K5 and K4 once per substep and through K1, K2 and K3 not
   at all;
7. checks K4 on the 9-species stack and K5 against their plain versions
   on the state that drive left, K5 also on random mixed-regime stacks at
   dt 30, 90 and 150, on an inert and an ice-supersaturated state, and at
   80 levels; K5's line in the table adds its time on the initial state,
   the share of column tiles it found active on each ridge state, and its
   registers, spills and shared memory from the build log.
8. runs the three ridge paths sharded over meshes whose shards all sit on
   this card (parallel/mesh.py; a device may repeat in a mesh): the upwind
   ridge on 2x2, the MPDATA ridge on 4x1, the Thompson ridge on 2x2, two
   intervals each, and checks that each drive took the unsharded drive's
   substep count, gave its digest exactly and launched each kernel of its
   path once per shard and substep. Before that, each per-shard wrapper
   (parallel/shard_kernels.py) was held to the unsharded kernel on the
   state of phases 1, 4 and 7 at max_abs_err 0.0 and timed: K1 and K2 on
   2x2, K3 and K4 on 4x1 and 2x2, K4 (9 species) and K5 on 4x1 and 2x2;
   the per-shard K4 on the 4x1 mesh (the counterpart of the TPU's
   advect_mpdata_padded) also against its plain version on every block.
   With more than one card it also drives the Thompson ridge with one
   shard per card.
9. builds the full-physics ridge (bench.py --config fullphys: Thompson with
   upwind advection, wind=2, simple radiation, Noah with simple water, the
   simple PBL and Tiedtke convection) at 500x500x20 and advances one
   interval; on that state holds K1 on its 9 species to its kernel-order
   oracle (every bit) and its plain version, and K5 to its plain version
   (with its share of active tiles); then drives two intervals of a fresh
   model and checks that it went through K5 and K1 once per substep and
   through K2, K3 and K4 not at all, with convective rain; times each
   stage of one more interval with CUDA events (diagnostics, radiation,
   surface, PBL, convection, restack, K5, K1); and runs the small
   full-physics case of tests/test_torch_fullphys.py for one interval on
   the CPU and on the card, holding the card to the CPU (the same
   substeps, each field within FULLPHYS_BOUNDS). K1's and K5's lines in
   the table add these figures under "fullphys".
10. builds the linear-theory ridge (bench.py --config linear: SB04 and
   upwind on linear mountain-wave winds, the table of 5 speeds x 8
   directions x 3 N^2 with a buffer of 48, built on the card at set-up
   without the disk cache) at 500x500x20; builds its table once more
   alone (timed, equal to the model's bit for bit) and holds two entries
   (the highest speed, two directions) to the CPU's build of them
   (LINEAR_TABLE_BOUND); solves the small case's winds (LINEAR_SMALL) on
   the CPU and on the card with wind=1, 3, 5 and blocking, each within its
   bound (LINEAR_SOLVERS); then drives two intervals of a fresh model with
   a wind update before each (time_paths.run_timed, the updates timed
   apart) and checks that it went through K1 and K2 once per substep and
   through K3, K4 and K5 not at all and that u is off the balance-only
   ridge's; and times the stages of one more wind update with CUDA events
   (N^2, lookup, balance). K1's and K2's lines in the table add the
   launches under "linear".
11. the file-driven run (python -m icar_tpu_torch options.nml): writes
   write_ideal_files' forcing around the 500x500 domain (510x510x24, three
   steps, in the format a machine without h5py writes: CDF-2) and an
   options file (FILE_RUN_Z's 20 levels, SB04 + upwind, forcing and output
   every 1800 s over an hour, a restart at each output), runs it through
   core.driver.main in this process with the launch counts set to 0, and
   checks that K3 and K1 launched once per substep (full-field forcing
   takes the general loop) and no other kernel, that the output holds
   three finite times 0, 1800 and 3600 s with a median u within
   FILE_U_MEDIAN, and that a run resumed from the 1800 s checkpoint
   writes a 3600 s checkpoint equal to the uninterrupted run's bit for
   bit (its digest printed); logs the resumed driver's timers and rate,
   one forcing step's read, regrid, wind solve and tendencies, and the
   dt's read-back a substep; then runs the small case of
   tests/test_torch_driver.py on the CPU and the card with SB04 + upwind
   and with Thompson + upwind and the fullphys schemes, holding the card
   to the CPU (the same substeps, FULLPHYS_BOUNDS). K1's and K3's lines
   in the table add the launches under "file".
12. the general loop's options (GENERAL_PATHS): on the MPDATA_density
   ridge's state after one interval, the density fold kernel
   (csrc/density_fold.cu, kernels.density_winds) against its plain
   version bit for bit, then K1 and K4 on the operands it weights by the
   state's density, K1 against its kernel-order oracle on them (every
   bit) and both against their plain versions with density, each timed
   with and without the fold; then two intervals each of density
   advection with upwind (K3, the fold and K1 once a substep) and with
   MPDATA (K3, the fold and K4), SB04 + upwind with the microphysics every 60 s
   (K1 once a substep, K3 as often as the host's counter predicts), the
   full physics column with MPDATA (K5 and K4 on nine species) and with
   SB04 without Tiedtke (K3 and K1), each with its digest; the
   MPDATA_density ridge sharded 4x1 on this card against its unsharded
   drive; the small cases of the two column-physics paths on the CPU and
   the card (FULLPHYS_BOUNDS). The table adds advect_upwind_density and
   advect_mpdata_density (fold and kernel; the kernel and the fold
   alone) and density_fold, and the other kernels' launches under
   "general".
13. RRTMG and YSU (fullphys_rrtmg_noah: bench.py --config fullphys_rrtmg
   with Noah in Noah-MP's place, on the synthetic k-tables): on the
   500x500x20 path's state after one interval, K1 against its
   kernel-order oracle and K5 against its plain version (0.0 each), one
   RRTMG call's wall and peak memory, its aten operations per stage
   (tools/count_ops.py rrtmg_ops), one chunk of it (16,000 columns) on the
   card against the CPU on the same McICA draws (RRTMG_CHUNK_BOUND); the
   card's own McICA draw over one chunk against its cloud fractions
   (binomial bound); then two intervals of a fresh model (K5 and K1 once a
   substep, RRTMG as often as the host's counter predicts: once an
   interval) with its digest, the stages of one more interval by CUDA
   events (radiation_lw, radiation_sw, cloud_fraction, pbl_ysu, surface,
   convection, mp_thompson, advection and the rest), and the small case
   at noon on the CPU and the card (the larger of FULLPHYS_BOUNDS and
   twice the CPU run's own one-ulp spread). K1's and K5's lines in the
   table add these figures under "fullphys_rrtmg_noah".
14. bench.py --config fullphys_rrtmg as bench.py builds it (RIDGE_PATHS
   fullphys_rrtmg: Noah-MP with its glacier column, initialised on the
   host as bench.py does): on the 500x500x20 path's state after one
   interval, K1 against its kernel-order oracle and K5 against its plain
   version (0.0 each), one surface call's time by CUDA events (its
   noahmp and glacier columns) and the aten operations of one Noah-MP
   and one glacier call (tools/count_ops.py noahmp_ops); then two
   intervals of a fresh model (K5 and K1 once a substep and no other
   kernel, RRTMG and Noah-MP as often as the host's counters predict,
   convective rain) with its digest, the stages of one more interval by
   CUDA events (noahmp and glacier within surface), and the small case
   (noahmp_small_model: a glacier strip, snow of one to three layers) at
   noon on the CPU and the card (the larger of FULLPHYS_BOUNDS and twice
   the CPU run's own one-ulp spread; the layer count by the share of
   cells). K1's and K5's lines in the table add these figures under
   "fullphys_rrtmg".
15. the CLM lake (water=3) on bench.py's fullphys ridge with a band of
   lake across the upwind flat (install_lake: columns LAKE_BAND of every
   row, lake_init with the default 50 m): on the 500x500x20 path's state
   after one interval, K1 against its kernel-order oracle and K5 against
   its plain version (0.0 each), one surface call's time by CUDA events
   (its lake column) and the aten operations of one lake call
   (tools/count_ops.py lake_ops); then two intervals of a fresh model (K5
   and K1 once a substep and no other kernel, the lake as often as the
   host's counter predicts, convective rain) with its digest and the
   lake's (t_lake3d, t_soisno3d, lake_icefrac3d, t_grnd2d), the stages
   of one more interval by CUDA events (lake within surface); the small
   lake case (lake_small_model: cold air, lake ice, snow of one to five
   layers) on the CPU and the card (the larger of FULLPHYS_BOUNDS and
   twice the CPU run's own one-ulp spread; the layer count and the ice
   fraction by the share of cells); and the small file-driven case with
   radiation=1, lsm=1, the lake, SB04 + upwind and the simple PBL
   through core.driver.main on the CPU and the card (K3 and K1 alike;
   its output and restart held the same way). K1's and K5's lines in the
   table add these figures under "fullphys_lake".
16. the other microphysics (WSM3 mp=6, WSM6 mp=4, Morrison mp=3; no
   kernel of their own, plain PyTorch on the card): bench.py's ridge with
   each in SB04's place (RIDGE_PATHS wsm3, wsm6, morrison) at 500x500x20.
   For each, on the path's state after one interval: K1 on its stack of
   4, 7 or 11 species against its kernel-order oracle (every bit) and its
   plain version, one scheme call timed by CUDA events and by the host's
   clock, and its aten operations (tools/count_ops.py wsm3_ops, wsm6_ops,
   morrison_ops); on Morrison's, K4 (order 2, FCT) on its 11 species
   against its plain version. Then two intervals of a fresh model (K1
   once a substep and no other kernel, the scheme as often as the host's
   counter predicts: every substep; every field finite) with its
   digest, and the stages of
   one more interval by CUDA events (diagnostics, mp_wsm3 / mp_wsm6 /
   mp_morrison, advection). Then the small cases on the CPU and the card,
   each field within the larger of FULLPHYS_BOUNDS and twice the CPU run's
   own one-ulp spread (three seeds): each scheme on the cold ridge
   MP_SMALL (ice and snow aloft on both), with upwind and with MPDATA
   there, and in the small full-physics case (with Tiedtke; it and WSM3
   read w_real).
   K1's line in the table adds these figures under "wsm3", "wsm6" and
   "morrison", K4's its 11-species figures under "morrison".
17. Kain-Fritsch, NSAS and BMJ on bench.py's fullphys ridge in Tiedtke's
   place (check_convection): two intervals each (K5 and K1 once a
   substep, the scheme once a substep), K1 and K5 on each state, one
   convection call's time and operations, the stages; the small cases on
   the CPU and the card.
18. Thompson-aerosol (mp=5) on bench.py's mpdata_thompson ridge
   (check_thompson_aer): two intervals of the constant-Nc ridge
   (thompson_aer: K5 and K4 once a substep; its digest must equal the
   Thompson ridge's of phase 6 in every field), K5 on the state it
   leaves (0.0); two intervals of the aerosol-aware ridge
   (thompson_aer_aware: K4 on its 12 species once a substep and no other
   kernel, the plain scheme once a substep, droplets and nwfa moved), K1
   on its 12 species against its oracle (0.0) and K4 on them, one scheme
   call timed with its operations, the stages; the aware ridge sharded
   2x2 on this card against its unsharded digest; the small cases (the
   aware ridge with upwind, K1 once a substep on the card; the RRTMG +
   YSU + Noah-MP case with the aware scheme) on the CPU and the card.
   K1's line adds its 12-species figures under "thompson_aer_aware", K4's
   likewise, K5's its figures under "thompson_aer".
19. bench.py --config conus (check_conus): the full-physics ridge of
   phase 9 on a 1x1 mesh of this card over two intervals, holding phase
   9's substeps and digest exactly, and its stages of one more interval;
   on a 2x2 mesh of this card over one interval, holding the 1x1 model's
   first interval's (and, with more than one card, one shard per card
   over two, holding phase 9's); K5 and K1 launched once per shard and
   substep in each; then the small cases of every column option
   (sharded_small_cases) 2x2 on this card against their unsharded card
   runs, every bit of every field, each kernel of the path once per shard
   and substep. K1's and K5's lines add the launches under "conus", every
   kernel's line the small cases' under "sharded_small".
20. Slice G, what the JAX package shards and the earlier phases did not
   (check_slice_g): bench.py --config linear --sharded, the linear ridge
   of phase 10 built by ideal_ridge_model(mesh=...) on a 1x1 and a 2x2
   mesh of this card over two intervals with a wind update before each,
   each holding phase 10's substeps and digest exactly, K1 and K2 once
   per shard and substep, the wind update's stages on each; then the
   file hour of phase 11 from its forcing files on a 2x2 mesh of this
   card through ICARDriver(mesh=...) with the "sharded" output engine:
   K3 and K1 once per shard and substep, its 3600 s restart equal to
   phase 11's bit for bit, its four shard files at 3600 s stitched (with
   NCFile) equal to phase 11's output there, and a per-shard restart
   (write_restart_sharded) read into a fresh 2x2 model bit for bit. K1's
   line adds its launches under "linear_sharded" and "file_sharded", K2's
   under "linear_sharded", K3's under "file_sharded".
After each drive it prints the float64 digest of the final state (sum and
sum of squares of each advected field, u, v, w and each accumulator).

    python3 chip_smoke.py --phase 20

runs phase 20 alone after what it reads of the earlier phases: the kernels'
build, phase 10's drive of the linear ridge (its digest and substeps) and
phase 11's forcing files and uninterrupted file hour (``phase20_alone``);
it prints their logs and no kernel table.
Prints the kernel table (time, plain time, bound, launches) as one JSON
line, the card's name and power limit, then, as the last line,
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero;
without a CUDA device it exits non-zero before printing a result. Imports
nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# The ridge cases (bench.py's ridge at 500x500x20 with each path's options)
# are the port's own: icar_tpu_torch.models.icar RIDGE and RIDGE_PATHS,
# driven over two 1200 s intervals by icar_tpu_torch.time_paths.run_timed.
# K4 at the other orders, on a random stack of this shape
MPDATA_SMALL = (5, 20, 96, 128)
MPDATA_VARIANTS = ((2, False), (3, True), (4, True))
# K5 on random mixed-regime stacks of this shape at these dt
THOMPSON_SMALL = (20, 96, 128)
THOMPSON_DTS = (30.0, 90.0, 150.0)
# and deeper than K4 takes, on a column count no tile size divides
THOMPSON_DEEP = (80, 47, 101)
# K2 and K3 on seeded columns (ridge_columns) deeper than K4's 64 levels:
# 8-column tiles, the last one ragged
SB04_DEEP = (96, 50, 81)

# the sharded drives of phase 8: (path, mesh shape), every shard on
# cuda:0; and the meshes each per-shard wrapper is held on
SHARD_DRIVES = (("upwind", (2, 2)), ("MPDATA", (4, 1)), ("Thompson", (2, 2)))
SHARD_CHECK_MESHES = ((4, 1), (2, 2))

# the small full-physics case of tests/test_torch_fullphys.py (its strip of
# open water in the first ten columns), one interval on the CPU and on the
# card; bounds on max|card - CPU| / max|CPU| of each field: the advected
# species, every other field; the cloud fraction and the longwave, which
# scales with it, are ill-conditioned where a column holds almost no
# condensate (Xu-Randall's ((1 - rh) qc)^0.25), so they may pass the
# second bound in at most FULLPHYS_ILL_SHARE of the columns. The bounds the
# CPU test holds the port to against the JAX package; the card differs
# from the CPU in its transcendental functions and in K1's scaling of the
# winds (K1_RTOL).
FULLPHYS_SMALL = dict(nx=30, ny=12, nz=10, dx=1000.0, hill_height=600.0,
                      u_speed=9.0, rh=1.0)
FULLPHYS_SMALL_INTERVAL = 600.0
# phase 14's small case (tests/test_torch_noahmp_model.py): FULLPHYS_SMALL
# on RIDGE_PATHS["fullphys_rrtmg"] with a strip of glacier (MODIS ice,
# category 15) along the south edge and snow on a few cells before the
# Noah-MP init: 6, 15, 60 and 150 mm make one, two and three layers
NOAHMP_ICE = 15
NOAHMP_SNOW_MM = (6.0, 15.0, 60.0, 150.0)


def noahmp_small_surface(veg_type, swe):
    """(veg_type, swe) of phase 14's small case, from the ideal case's
    (numpy (ny, nx)): the two southern rows glacier, a row of snow
    patches further north."""
    veg = np.array(veg_type, np.float32)
    swe = np.array(swe, np.float32)
    veg[:2] = NOAHMP_ICE
    for i, mm in enumerate(NOAHMP_SNOW_MM):
        swe[5:7, 3 + 6 * i:6 + 6 * i] = mm
    return veg, swe


# the init's fields bench.py leaves out that a snow pack needs (ROADMAP
# section 3: without them its layers hold no ice and the run turns
# non-finite), installed as the file-driven driver does
NOAHMP_SNOW_FIELDS = {"snow_layer_ice": "snice",
                      "snow_layer_liquid_water": "snliq",
                      "snow_height": "snowh", "soil_water_content": "smc"}


def noahmp_small_model(device):
    """Phase 14's small case on ``device``, starting at local noon
    (RRTMG_NOON): noahmp_small_surface, then ``init_noahmp_state`` anew
    with bench.py's fields and NOAHMP_SNOW_FIELDS (bench.py's fields
    leave the inputs of the init as they were)."""
    import torch
    from icar_tpu_torch.models.icar import (NOAHMP_BENCH_FIELDS,
                                            RIDGE_PATHS, ideal_ridge_model,
                                            init_noahmp_state)
    m = ideal_ridge_model(**FULLPHYS_SMALL, **dict(
        RIDGE_PATHS["fullphys_rrtmg"], options_cb=rrtmg_noon_options),
        device=device)
    s = m.state
    veg, swe = noahmp_small_surface(s["veg_type"].cpu().numpy(),
                                    s["swe"].cpu().numpy())
    s["veg_type"] = torch.as_tensor(veg, device=s["swe"].device)
    s["swe"] = torch.as_tensor(swe, device=s["swe"].device)
    return init_noahmp_state(m, dict(NOAHMP_BENCH_FIELDS,
                                     **NOAHMP_SNOW_FIELDS))
# phase 15, the CLM lake (water=3; tests/test_lake.py:263-285): bench.py's
# fullphys ridge at 500x500x20 with the lake scheme and a band of lake
# (MODIS category 21, the default 50 m deep) across the upwind flat,
# columns LAKE_BAND on every row; the small case is that test's ideal
# ridge with its lake strip, in air LAKE_SMALL_COLD below the
# Weisman-Klemp sounding (the lake starts frozen at the top and its ice
# grows) and snow on the strip that lake_init lays as one to five layers
# (LAKE_SMALL_SWE mm by row)
LAKE_CATEGORY = 21
LAKE_BAND = (50, 150)
LAKE_SMALL = dict(nx=24, ny=8, nz=10, dx=1000.0, hill_height=300.0, rh=0.5)
LAKE_SMALL_BAND = (4, 8)
LAKE_SMALL_COLD = 30.0
LAKE_SMALL_SWE = (0.0, 4.0, 7.0, 20.0, 45.0, 100.0, 200.0, 0.0)
LAKE_SMALL_INTERVAL = 1800.0
# phase 16, the other microphysics: bench.py's ridge with WSM3, WSM6 or
# Morrison in SB04's place (models.icar RIDGE_PATHS); the small cases on a
# ridge of 20 levels (its top near -30 C) at rh 1.0, where each scheme makes
# cloud ice and snow aloft within the interval, with the options of each
# (mp=6 WSM3, mp=4 WSM6, mp=3 Morrison; adv=2 MPDATA)
OTHER_MP = ("wsm3", "wsm6", "morrison")
MP_SMALL = dict(nx=48, ny=12, nz=20, dx=1000.0, hill_height=600.0,
                u_speed=10.0, rh=1.0)
MP_SMALL_INTERVAL = 1200.0
MP_SMALL_PATHS = (("wsm3", dict(mp=6)), ("wsm6", dict(mp=4)),
                  ("morrison", dict(mp=3)),
                  ("wsm3 + MPDATA", dict(mp=6, adv=2)),
                  ("wsm6 + MPDATA", dict(mp=4, adv=2)),
                  ("morrison + MPDATA", dict(mp=3, adv=2)))
# and each in the small full-physics case, in Thompson's place (mp)
MP_FULLPHYS = (("WSM3", 6), ("WSM6", 4), ("Morrison", 3))
# phase 17, the other convection schemes: bench.py's fullphys ridge with
# Kain-Fritsch, NSAS or BMJ in Tiedtke's place (RIDGE_PATHS fullphys_kf,
# fullphys_nsas, fullphys_bmj), and their small cases: FULLPHYS_SMALL with
# its water strip, one FULLPHYS_SMALL_INTERVAL interval for NSAS and BMJ
# (and NSAS again under RRTMG and YSU, rrtmg_small, so that hpbl > 0
# reaches its shallow scheme); Kain-Fritsch two intervals of the case 20
# levels deep (CU_SMALL_KF; FULLPHYS_SMALL's model top, 3.2 km, lies below
# the 3 km cloud depth that KF's trigger asks above the LCL, so KF
# convects nowhere there, in both packages), so that its NCA countdown
# freezes and releases the tendencies
CU_PATHS = (("fullphys_kf", 3), ("fullphys_nsas", 4), ("fullphys_bmj", 5))
CU_SMALL_KF = dict(FULLPHYS_SMALL, nz=20)
CU_SMALL_KF_INTERVALS = 2
# the state fields each scheme keeps, digested after each drive
CU_STATE_FIELDS = {"fullphys_kf": ("kf_nca", "kf_w0avg", "kf_prate"),
                   "fullphys_nsas": ("convective_precipitation",),
                   "fullphys_bmj": ("cldefi",)}
# phase 18, Thompson-aerosol (mp=5): bench.py's mpdata_thompson ridge with
# mp=5 in Thompson's place, without and with the aerosol-aware option
# (RIDGE_PATHS thompson_aer, thompson_aer_aware), each taking AER_SUBSTEPS
# substeps in its two intervals; the aware ridge once more on AER_SHARDS
# shards of this card; the five fields whose digests the constant-Nc ridge
# must share with the Thompson ridge's (mp=1); the small cases: the aware
# ridge AER_SMALL with upwind (K1 on its twelve species) over
# AER_SMALL_INTERVAL, and the small RRTMG + YSU + Noah-MP case at noon
# (FULLPHYS_RRTMG on FULLPHYS_SMALL) with the aware scheme, whose radii
# reach the longwave and the shortwave
AER_PATHS = ("thompson_aer", "thompson_aer_aware")
AER_SUBSTEPS = 46
AER_SHARDS = (2, 2)
AER_DIGEST_FIELDS = ("potential_temperature", "water_vapor", "cloud_water",
                     "rain_mass", "precipitation")
AER_SMALL = dict(nx=48, ny=12, nz=10, dx=1000.0, hill_height=600.0,
                 u_speed=10.0, rh=1.0)
AER_SMALL_INTERVAL = 600.0
# the lake's fields held by the share of cells past their bound: its snow
# layer count and ice fraction flip with one-ulp differences at their
# thresholds (ROADMAP section 3)
LAKE_LEVEL_FIELDS = ("snl2d", "lake_icefrac3d")
# the small file-driven case with the options that take the forcing's
# radiation (radiation=1) and surface fluxes (lsm=1), the lake (water=3)
# on a strip of LAKE_FILE_BAND, SB04 + upwind and the simple PBL; the
# forcing file gains surface fields (LAKE_FILE_SURFACE: per forcing step,
# W m-2 and K) that the namelist names (LAKE_FILE_VARS)
LAKE_FILE_BAND = (4, 12)
LAKE_FILE_DEPTH = 10.0
LAKE_FILE_PHYSICS = dict(mp=2, adv=1, rad=1, lsm=1, water=3, pbl=2)
LAKE_FILE_SURFACE = {"swdown": (350.0, 420.0, 380.0),
                     "lwdown": (300.0, 310.0, 320.0),
                     "sh": (40.0, 60.0, 50.0), "lh": (80.0, 100.0, 90.0),
                     "sst": (284.0, 285.0, 286.0)}
LAKE_FILE_VARS = {"swdown_var": "swdown", "lwdown_var": "lwdown",
                  "shvar": "sh", "lhvar": "lh", "sst_var": "sst"}


def install_lake(model, cols, swe=None):
    """A lake band over the columns ``cols`` (first, end) of every row of
    ``model``, installed on the host as tests/test_lake.py does: the
    land-use category LAKE_CATEGORY on the band, the skin temperature and
    the sst the lowest level's temperature, ``swe`` (mm by row) on the
    band when given, ``water_lake.lake_init`` with the default depth, the
    lake cells water in ``land_mask``; uploaded to the model's device.
    Returns ``model``. On a sharded model the whole state is gathered and
    the result scattered into the blocks."""
    import torch
    from icar_tpu_torch.physics.water_lake import lake_init
    st = model._global_state()
    s = {k: v.detach().cpu().numpy().copy() for k, v in st.items()}
    s["veg_type"][:, cols[0]:cols[1]] = LAKE_CATEGORY
    s["skin_temperature"] = np.asarray(s["temperature"][0],
                                       np.float32).copy()
    s["sst"] = s["skin_temperature"].copy()
    if swe is not None:
        s["swe"][:, cols[0]:cols[1]] = np.asarray(swe, np.float32)[:, None]
    lake_init(s, np.asarray(model.geom.terrain), np.asarray(model.geom.lat))
    new = {k: torch.as_tensor(np.asarray(s[k]), dtype=v.dtype,
                              device=v.device) for k, v in st.items()}
    new["land_mask"] = torch.where(new["lakemask"] > 0.5, 2.0,
                                   new["land_mask"])
    model._install(new)
    return model


def lake_small_model(device):
    """Phase 15's small case on ``device``: tests/test_lake.py's ideal
    ridge with water=3 in air LAKE_SMALL_COLD below its sounding, its lake
    strip with LAKE_SMALL_SWE."""
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.forcing.ideal import (make_ideal_case,
                                              weisman_klemp_theta)
    from icar_tpu_torch.models.icar import ideal_ridge_model
    m = ideal_ridge_model(**LAKE_SMALL, water=C.WATER_LAKE, device=device)
    m.set_initial_conditions(make_ideal_case(
        m.geom, u_profile=10.0, rh=LAKE_SMALL["rh"],
        theta_profile=lambda z: weisman_klemp_theta(z) - LAKE_SMALL_COLD))
    return install_lake(m, LAKE_SMALL_BAND, LAKE_SMALL_SWE)


class lake_land_use:
    """Within the ``with``, a file-driven driver (``core.driver.
    ICARDriver``) set up finds the land-use category LAKE_CATEGORY and a
    lake depth of LAKE_FILE_DEPTH on the columns ``cols`` before its lake
    init: neither the port's driver nor
    the JAX package's reads a land-use category from a file (ROADMAP
    section 3). ``driver_class``: the driver class to patch (the port's by
    default)."""

    def __init__(self, cols, driver_class=None):
        if driver_class is None:
            from icar_tpu_torch.core.driver import ICARDriver
            driver_class = ICARDriver
        self.cls, self.cols = driver_class, cols
        self.fn = driver_class._install_external_conditions

    def __enter__(self):
        fn, cols = self.fn, self.cols

        def with_lakes(driver):
            fn(driver)
            s = dict(driver.model.state)
            veg = s["veg_type"]
            col = np.arange(veg.shape[-1])
            band = ((col >= cols[0]) & (col < cols[1])).astype(np.float32)
            import torch
            if torch.is_tensor(veg):
                band = torch.as_tensor(band, device=veg.device)
            s["veg_type"] = veg * (1.0 - band) + LAKE_CATEGORY * band
            s["lake_depth"] = s["lake_depth"] * (1.0 - band) \
                + LAKE_FILE_DEPTH * band
            driver.model.state = s
        self.cls._install_external_conditions = with_lakes
        return self

    def __exit__(self, *exc):
        self.cls._install_external_conditions = self.fn
        return False


def add_surface_forcing(path, fields=None):
    """Append the forcing-only options' surface fields to the forcing file
    ``path`` (write_ideal_files' layout): each of ``fields`` (name: one
    value per forcing step; LAKE_FILE_SURFACE by default) as a (time, y,
    x) variable, uniform in space."""
    from icar_tpu_torch.io.netcdf import NCFile
    fields = LAKE_FILE_SURFACE if fields is None else fields
    with NCFile(path) as f:
        ny, nx = f.var_shape("lat")
        nt = f.var_shape("u")[0]
    with NCFile(path, "a") as f:
        for name, values in fields.items():
            if len(values) != nt:
                raise ValueError(f"{name}: {len(values)} values for {nt} "
                                 f"forcing steps")
            data = np.broadcast_to(np.asarray(values, np.float32)[:, None,
                                                                  None],
                                   (nt, ny, nx)).copy()
            f.create_var(name, ("time", "y", "x"), data)


FULLPHYS_BOUNDS = {"species": 1e-4, "other": 1e-3}
FULLPHYS_ILL_CONDITIONED = ("cloud_fraction", "longwave")
FULLPHYS_ILL_SHARE = 0.05
# the small linear-theory case of tests/test_torch_linear_model.py (the
# table of tests/test_linear_winds.py small_lt, vert_smooth 5), its winds
# solved on the CPU and on the card by each solver; bound on max|card -
# CPU| of u, v and w over the CPU's largest |u|: the FFTs (cuFFT against
# MKL), log and atan2 round differently, which the box smoothing of N^2
# amplifies (the port and the JAX package differ by 7e-7 of the largest
# wind here on the CPU), and the iterative solver adds an ulp a correction
# (101 of them)
LINEAR_SMALL = dict(nx=48, ny=12, nz=10, dx=1000.0, hill_height=600.0,
                    u_speed=10.0, rh=0.8)
LINEAR_SOLVERS = (("wind=1", 1, False, 2e-5), ("wind=3", 3, False, 5e-5),
                  ("wind=5", 5, False, 5e-5),
                  ("wind=1 with blocking", 1, True, 5e-5))
# the card's table against the CPU's build of two entries at full width
# (the highest speed, two directions, the middle N^2): bound on max|card -
# CPU| over the entry's largest value (the CPU tests hold the port's build
# to the JAX package's within 1e-6 of the table's largest value)
LINEAR_TABLE_BOUND = 1e-5
LINEAR_TABLE_DIRECTIONS = (2, 5)

# phase 11, the file-driven run (python -m icar_tpu_torch options.nml): the
# forcing of write_ideal_files around the bench ridge's 500x500 domain (a
# 510x510x24 forcing grid, three steps, ~450 MB), the ridge's 20 levels,
# SB04 + upwind (the configuration of tests/test_forcing_io.py's ideal_run
# and of the reference's short run), one hour with forcing and output
# every 1800 s and a restart at each output
FILE_RUN = dict(nx=500, ny=500, nz_lo=24, dx=1000.0, hill_height=1000.0,
                u_profile=10.0, nt=3)
FILE_RUN_Z = dict(nz=20, dz_levels=[50.0, 75.0, 125.0, 200.0, 300.0, 400.0]
                  + [500.0] * 14, flat_z_height=-5)
# the small file-driven case of tests/test_torch_driver.py
# (tests/test_forcing_io.py's ideal_run), run on the CPU and on the card
# with each of FILE_PHYSICS and held by FULLPHYS_BOUNDS
FILE_SMALL = dict(nx=48, ny=14, nz_lo=24, dx=1000.0, hill_height=400.0,
                  u_profile=8.0, qv_val=0.004, nt=3)
FILE_SMALL_Z = dict(nz=10, dz_levels=[50.0, 75.0, 125.0, 200.0, 300.0,
                                      400.0] + [500.0] * 4, flat_z_height=-3)
FILE_PHYSICS = (("SB04 + upwind", dict(mp=2, adv=1)),
                ("Thompson + upwind, fullphys", dict(
                    mp=1, adv=1, wind=2, rad=2, pbl=2, lsm=3, water=2,
                    conv=1)))
FILE_INTERVAL = 1800.0
# the forcing's u is 10 m/s; the median of the run's u lies within these
FILE_U_MEDIAN = (4.0, 16.0)

# phase 12, the general loop's options on the bench ridge (models.icar
# RIDGE_PATHS): density advection with either advection, SB04 + upwind
# with the microphysics every 60 s, and the full physics column with MPDATA
# or with SB04 (and without Tiedtke, which the options refuse with SB04);
# the density ridge sharded on one card
GENERAL_PATHS = ("upwind_density", "MPDATA_density", "upwind_mp_throttle",
                 "fullphys_mpdata", "fullphys_sb04")
GENERAL_SHARDED = ("MPDATA_density", (4, 1))
# phase 13, RRTMG and YSU (models.icar RIDGE_PATHS fullphys_rrtmg_noah):
# the small case starts at local noon (19:00 UTC at 105 W), so that the
# shortwave works, and runs all land (with the water strip of
# fullphys_small the JAX package's own run turns non-finite; ROADMAP
# section 3); one RRTMG chunk alone (RRTMG_CHUNK_ROWS rows of the 500-wide
# state, 16,000 columns) card against CPU on the same draws, each output
# within RRTMG_CHUNK_BOUND of the CPU's largest magnitude (the card's
# exp, log and pow round apart; the same draws and cloud fractions give
# the same subcolumns), under a sun at RRTMG_CHUNK_COSZ; the card's own
# McICA draw over one chunk of RRTMG_DRAW_FRACTIONS, each layer's cloudy
# share within RRTMG_DRAW_SIGMAS binomial standard deviations
RRTMG_NOON = "2020-12-01 19:00:00"
RRTMG_CHUNK_ROWS = 32
RRTMG_CHUNK_BOUND = 1e-4
RRTMG_CHUNK_COSZ = 0.5
RRTMG_DRAW_FRACTIONS = np.linspace(0.05, 0.95, 20)
RRTMG_DRAW_SIGMAS = 5.0
# the fields a one-ulp nudge of the small case leaves alone
CATEGORIES = ("land_mask", "veg_type", "soil_type")
# the fields a one-ulp nudge leaves alone on a lake state: the categories,
# the lake mask and the layer count, which the scheme reads as integers
LAKE_NOT_NUDGED = CATEGORIES + ("lakemask", "snl2d")
# YSU's PBL height and exchange coefficient follow the PBL top's level
# index: a column whose top moves one level moves them by a layer's depth,
# so the card is held to the CPU on them as on FULLPHYS_ILL_CONDITIONED,
# by the share of cells past the bound
YSU_LEVEL_FIELDS = ("hpbl", "exch_h")


def write_namelist(path, init, forcing, prefix, z, physics,
                   restart_from=None, var_list=None):
    """Write an options file for one hour of a file-driven run from the
    files ``init`` and ``forcing``: ``z`` (FILE_RUN_Z or FILE_SMALL_Z) its
    levels, ``physics`` its &physics settings, forcing and output every
    FILE_INTERVAL, output and restarts named from ``prefix`` (a restart at
    each output), resumed from the checkpoint ``restart_from`` when given,
    ``var_list`` its &var_list entries (namelist key: variable) when
    given. Returns ``path``."""
    phys = ", ".join(f"{k} = {v}" for k, v in physics.items())
    dz = ", ".join(f"{d:.1f}" for d in z["dz_levels"])
    text = f"""&model_version
    version = "2.1",
/
&physics
    {phys}
/
&parameters
    start_date = "2020-12-01 00:00:00",
    end_date = "2020-12-01 01:00:00",
    inputinterval = {FILE_INTERVAL},
    dx = 1000.0,
    nz = {z["nz"]},
    restart = {".true." if restart_from else ".false."},
/
&z_info
    dz_levels = {dz},
    flat_z_height = {z["flat_z_height"]},
/
&files_list
    init_conditions_file = "{init}",
    boundary_files = "{forcing}",
/
&output_list
    outputinterval = {FILE_INTERVAL},
    output_file = "{prefix}out_",
    restart_file = "{prefix}rst_",
    restartinterval = 1,
/
"""
    if restart_from:
        text += f"""&restart_info
    restart_file = "{restart_from}",
/
"""
    if var_list:
        entries = "\n".join(f'    {k} = "{v}",' for k, v in var_list.items())
        text += f"""&var_list
{entries}
/
"""
    with open(path, "w") as f:
        f.write(text)
    return path


def linear_small_options(o):
    """The small table: buffer 10, 4 speeds x 8 directions x 3 N^2, the
    vertical N^2 window 5."""
    o.lt.buffer = 10
    o.lt.n_dir_values, o.lt.n_spd_values, o.lt.n_nsq_values = 8, 4, 3
    o.lt.variable_n = True
    o.lt.vert_smooth = 5


def linear_blocking_options(o):
    """The small table with flow blocking, its Froude bounds raised so
    that blocking acts on about half the small ridge (whose smoothed
    Froude numbers run from 4.1 to 8.8)."""
    linear_small_options(o)
    o.block.block_flow = True
    o.block.block_fr_max, o.block.block_fr_min = 6.0, 4.0


# tools/make_golden.py CASE / INTERVAL / MIN_STEPS / FIELDS, copied because
# that module imports jax
GOLDEN_CASE = dict(nx=80, ny=16, nz=15, dx=1000.0, hill_height=900.0,
                   u_speed=12.0, rh=1.0)
GOLDEN_INTERVAL = 1800.0
GOLDEN_MIN_STEPS = 100
GOLDEN = os.path.join(ROOT, "tests", "golden", "ideal_ridge_100.npz")
# tests/test_golden.py ATOL (rtol 1e-4): the golden tolerance
GOLDEN_ATOL = {"u": 1e-4, "v": 1e-4, "w": 1e-5, "potential_temperature": 5e-4,
               "water_vapor": 1e-7, "cloud_water": 1e-7, "rain_mass": 1e-7,
               "snow_mass": 1e-7, "precipitation": 1e-4, "snowfall": 1e-4}
# The golden trajectory is not stable under one-ulp changes: the JAX
# package itself, run with one-ulp perturbations of theta (8 runs), leaves
# the golden tolerance in 7 of 8 runs for some field, and in 2 of 8 lands
# on a different branch of the 15-sweep saturation revert (theta off by
# 0.43 K in up to 10% of cells). So the thermodynamic fields are held to
# twice that ensemble's spread instead: per cell (MAX, plus rtol 1e-4) and
# as a domain mean of |difference| (MEAN). u, v, w and snowfall keep the
# golden tolerance. See PERF.md.
ENSEMBLE_MAX = {"potential_temperature": 1.0, "water_vapor": 1.3e-3,
                "cloud_water": 3.5e-4, "rain_mass": 5.5e-5,
                "snow_mass": 6.5e-7, "precipitation": 0.4}
ENSEMBLE_MEAN = {"potential_temperature": 1e-2, "water_vapor": 6e-6,
                 "cloud_water": 2e-6, "rain_mass": 3.5e-7,
                 "snow_mass": 2e-9, "precipitation": 1e-2}

# K1 against its plain version: a few float32 ulp (op order differs by
# design, see csrc/advect_upwind.cu), the tolerance of tests/test_pallas.py;
# against the kernel-order oracle (upwind_oracle) every bit
K1_RTOL, K1_ATOL = 5e-6, 1e-7
# K1 also on a random stack deeper than K4 takes, of more species than a
# block marches together, on a plane no tile divides
K1_DEEP = (9, 96, 47, 101)
# K2 and K3 against their plain version (same op order, no FMA contraction)
K2_RTOL, K2_ATOL = 1e-5, 1e-8
# K4 against its plain version: the winds are scaled in another order, as
# in K1; the tolerance tests/test_pallas.py allows the TPU kernel
K4_RTOL, K4_ATOL = 2e-5, 1e-6
# K5 against its plain version (same operation order, no contraction, the
# same libm on the card): per field, at most K5_SHARE of the cells beyond
# K5_RTOL relative (atol 1e-6 of the field's largest magnitude), where an
# ulp could move a bin or a threshold; the surface accumulators likewise
K5_RTOL, K5_SHARE = 1e-5, 1e-4

# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet):
# its bytes (each input read once, each output written once) at the
# memory's 3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever
# is longer.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 adds, multiplies and divisions, counted from the kernels' sources
# (abs, min, max, compares and selects not counted): K1 per interior cell
# and species (upwind.cuh: six fluxes of 6, 9 for the divergence, 6 wind
# scalings); K4 per corrective pass, per cell and species (mpdata.cu:
# pseudo-velocities 141, FCT factors 43, per interior cell the corrective
# update 50); SB04 (mp_simple.cu) per cell 15, per saturation sweep 18,
# per level of each fall step 16 (the phase changes of the conversions are
# not counted, so this bound errs low).
# K5 (mp_thompson.cu, counted with each transcendental call -- expf, logf,
# log10f, powf, sqrtf -- as one operation, so this bound errs low): per
# cell 1652 (pass A's prep 45, prep 368, bins 60, core 1070, fills and
# final update 109); per level of a column, 3 per species for its step
# count; per level of each sedimentation step, 12 for a mass, 22 for a mass
# and a number, and 3 per column and step for the surface flux.
UPWIND_OPS = 51
MPDATA_PSEUDO_OPS, MPDATA_FCT_OPS, MPDATA_CORRECTIVE_OPS = 141, 43, 50
SB04_CELL_OPS, SB04_SWEEP_OPS, SB04_FALL_OPS = 15, 18, 16
K5_CELL_OPS, K5_CFL_OPS, K5_SED_MASS_OPS, K5_SED_NUMBER_OPS = 1652, 3, 12, 22
K5_SFC_OPS = 3
# the density fold (ops/kernels.py density_winds) per cell: three face
# means of an add and a multiply, four weightings
FOLD_OPS = 10


def log(*args):
    print(*args, flush=True)


def device_info():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "it needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def cuda_ms(fn, reps=7, setup=None):
    """Median milliseconds of fn() over CUDA events; ``setup()`` runs
    before each call, outside the timed span."""
    import torch
    times = []
    for _ in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def assert_close(got, want, rtol, atol, what):
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)
    d = np.abs(got - want)
    big = np.abs(want) > atol     # relative error where it means something
    rel = float((d[big] / np.abs(want[big])).max()) if big.any() else 0.0
    log(f"  {what}: max abs err {d.max():.3e}, max rel err {rel:.3e} "
        f"(cells with |plain| > atol)")
    return float(d.max())


def upwind_oracle(q, winds, dt, floors, near_end):
    """K1's arithmetic in plain PyTorch, bit for bit: the plain update
    (ops/advection.py advect3d_upwind) from the kernel's own scaled winds,
    (u*J_u/dx)*dt and so on (``winds``: kernels.AdvectWinds), then the
    clamp to ``floors`` with ``near_end``. The kernel is held to it at
    max_abs_err 0.0 (the plain advect_upwind scales as u*(dt/dx)*J_u)."""
    import torch
    from icar_tpu_torch.ops import advection as adv_plain
    dt = float(np.float32(dt))
    scaled = adv_plain.CourantWinds(winds.uj * dt, winds.vj * dt,
                                    winds.wj * dt)
    out = adv_plain.advect3d_upwind(q, scaled, winds.dz, winds.jaco)
    if near_end:
        out = torch.maximum(out, floors[:, None, None, None])
    return out


def bound(nbytes, ops):
    """(bound_ms, bound_by) of work that moves ``nbytes`` and does
    ``ops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def advect_work(S, nz, ny, nx, order=1, use_fct=False):
    """Bytes and operations of K1 (order 1) or K4 on an (S, nz, ny, nx)
    stack: q in and out, five wind/metric fields, the floors."""
    n = nz * ny * nx
    nbytes = 4 * (2 * S * n + nz * ny * (nx - 1) + nz * (ny - 1) * nx
                  + 3 * n + S)
    interior = S * nz * (ny - 2) * (nx - 2)
    per_pass = (S * n * (MPDATA_PSEUDO_OPS + (MPDATA_FCT_OPS if use_fct
                                              else 0))
                + interior * MPDATA_CORRECTIVE_OPS)
    return nbytes, UPWIND_OPS * interior + (order - 1) * per_pass


def sb04_work(mp_plain, theta, qv, qc, qr, qs, pressure, exner, dz, dt,
              rho_operand):
    """Bytes and operations of SB04 (K2, or K3 with ``rho_operand``) on
    these inputs: the sweeps each cell needs and the fall steps of the
    columns that hold rain or snow after the conversions."""
    import torch
    nz, ny, nx = theta.shape
    n, plane = nz * ny * nx, ny * nx
    nbytes = 4 * ((14 if rho_operand else 13) * n + 4 * plane)
    t = theta * exner
    *_, niter = mp_plain.saturation_sweeps(pressure, t, qv, qc)
    c2r, c2s = mp_plain.formation_rates(dt)
    _, _, _, qr2, qs2 = mp_plain.mp_conversions(pressure, t, qv, qc, qr, qs,
                                                c2r, c2s)
    ops = SB04_CELL_OPS * n + SB04_SWEEP_OPS * int(niter.sum())
    for q, rate in ((qr2, mp_plain.RAIN_FALL_RATE),
                    (qs2, mp_plain.SNOW_FALL_RATE)):
        steps = torch.ceil(torch.amax(float(dt) / dz * rate, dim=0))
        falls = (q != 0).any(dim=0)
        ops += SB04_FALL_OPS * nz * int(steps[falls].sum())
    return nbytes, ops


def kernel_entry(name, replaces, err, ms, pms, work, launches=None):
    bms, by = bound(*work)
    log(f"  {name}: bound {bms:.4f} ms ({by}), kernel at "
        f"{100 * bms / ms:.1f}% of it")
    return {"name": name, "route": "cuda",
            "source": f"icar_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


# the kernels' sources and the TPU kernels they replace
SOURCE = {"advect_upwind": "advect_upwind.cu", "mp_simple": "mp_simple.cu",
          "mp_simple_rho": "mp_simple.cu", "advect_mpdata": "mpdata.cu",
          "advect_mpdata_9species": "mpdata.cu",
          "advect_mpdata_padded": "mpdata.cu",
          "mp_thompson": "mp_thompson.cu",
          "advect_upwind_density": "advect_upwind.cu",
          "advect_mpdata_density": "mpdata.cu",
          "density_fold": "density_fold.cu"}
REPLACES = {"advect_upwind": "icar_tpu/ops/pallas_kernels.py:167",
            "mp_simple": "icar_tpu/ops/pallas_kernels.py:679",
            "mp_simple_rho": "icar_tpu/ops/pallas_kernels.py:591",
            "advect_mpdata": "icar_tpu/ops/pallas_kernels.py:783",
            "advect_mpdata_9species": "icar_tpu/ops/pallas_kernels.py:783",
            "advect_mpdata_padded": "icar_tpu/ops/pallas_kernels.py:1078",
            "mp_thompson": "icar_tpu/ops/thompson_kernel.py:107",
            "advect_upwind_density": "icar_tpu/ops/pallas_kernels.py:167",
            "advect_mpdata_density": "icar_tpu/ops/pallas_kernels.py:783",
            # no TPU kernel: the JAX package weights the winds with jnp
            "density_fold": "icar_tpu/ops/advection.py:38"}


def check_kernels(model, kernels, step, adv_plain, mp_plain, initial,
                  deep_err):
    """K1 and K2 against their plain versions on the model's state;
    ``initial`` is K2's sb04_on_state result on the ridge's initial
    state, ``deep_err`` its max abs err at SB04_DEEP levels."""
    results = []

    # --- K1: every bit of the kernel-order oracle, and within K1_RTOL of
    # the plain version, here and on a random stack of K1_DEEP
    err1, oerr, ms1, pms1, shape, fms = k1_on_state(
        model, kernels, step, adv_plain, "ridge state", floor=True)
    deep_err1, deep_oerr = check_k1_deep(kernels, adv_plain,
                                         model.state["u"].device)
    log(f"K1 advect_upwind: max_abs_err {max(oerr, deep_oerr)} against the "
        f"kernel-order oracle, {max(err1, deep_err1):.3e} against the plain "
        f"version (rtol {K1_RTOL}, atol {K1_ATOL}); kernel {ms1:.4f} ms, "
        f"plain {pms1:.4f} ms, copy floor {fms:.4f} ms")
    entry = kernel_entry("advect_upwind", REPLACES["advect_upwind"],
                         max(err1, deep_err1), ms1, pms1,
                         advect_work(*shape))
    entry.update(max_abs_err_vs_oracle=max(oerr, deep_oerr),
                 copy_floor_ms=fms)
    results.append(upwind_entry(entry, kernels, shape))

    # --- K2 after one interval; its entry adds the initial state's figures
    err2, ms2, pms2, shares, work2 = sb04_on_state(model, kernels, step,
                                                   mp_plain, False)
    results.append(sb04_entry("mp_simple", kernels, model,
                              max(err2, initial[0], deep_err), ms2, pms2,
                              work2, shares, initial))
    return results


def k1_on_state(model, kernels, step, adv_plain, label, floor=False):
    """K1 on ``model``'s advected stack at the path's dt, clamped, against
    the kernel-order oracle (every bit) and the plain version (K1_RTOL),
    both timed: (max abs err against the plain version, against the
    oracle, kernel ms, plain ms, the stack's shape, the copy floor's ms
    with ``floor`` or None)."""
    import torch
    s = model.state
    g = model.geom_t
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    out = torch.empty_like(stack)
    run_k1 = lambda: kernels.advect_upwind(stack, winds, dt, floors, True,
                                           out=out)
    run_p1 = lambda: adv_plain.advect_upwind(
        stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u, g.jacobian_v,
        g.jacobian_w, g.jacobian, g.advection_dz, floors=floors,
        near_end=True)
    run_k1()
    torch.cuda.synchronize()
    err = assert_close(out, run_p1(), K1_RTOL, K1_ATOL,
                       f"advect_upwind kernel vs plain ({label}, "
                       f"{len(names)} species)")
    oerr = oracle_err(out, upwind_oracle(stack, winds, dt, floors, True),
                      f"advect_upwind kernel vs kernel-order oracle "
                      f"({label}, {len(names)} species)")
    ms, pms = cuda_ms(run_k1), cuda_ms(run_p1)
    fms = None
    if floor:
        copy = torch.empty_like(stack)
        fms = cuda_ms(lambda: kernels.advect_upwind_floor(stack, winds,
                                                          copy))
    return err, oerr, ms, pms, tuple(stack.shape), fms


def oracle_err(got, want, what):
    """The largest difference between ``got`` and the kernel-order oracle
    ``want``: 0.0, or AssertionError."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"{what}: max_abs_err {err}, expected 0.0")
    log(f"  {what}: max_abs_err 0.0")
    return err


def check_k1_deep(kernels, adv_plain, dev):
    """K1 on a random stack of K1_DEEP, clamped and not, against the
    kernel-order oracle (every bit) and the plain version (K1_RTOL):
    returns (max abs err against the plain version, against the
    oracle)."""
    import torch
    q, u, v, w, rg, floors = random_mpdata_case(dev, K1_DEEP, seed=19)
    winds = kernels.prepare_advect_winds(u, v, w, rg)
    dt = np.float32(20.0)
    err = oerr = 0.0
    for near_end in (False, True):
        got = kernels.advect_upwind(q, winds, dt, floors, near_end)
        torch.cuda.synchronize()
        what = (f"advect_upwind kernel ({K1_DEEP} random stack, near_end "
                f"{near_end})")
        err = max(err, assert_close(
            got, adv_plain.advect_upwind(
                q, u, v, w, dt, rg.dx, rg.jacobian_u, rg.jacobian_v,
                rg.jacobian_w, rg.jacobian, rg.advection_dz, floors=floors,
                near_end=near_end), K1_RTOL, K1_ATOL, what + " vs plain"))
        oerr = max(oerr, oracle_err(
            got, upwind_oracle(q, winds, dt, floors, near_end),
            what + " vs kernel-order oracle"))
    return err, oerr


def upwind_entry(entry, kernels, shape):
    """K1's kernel-table entry with its launch: tile, threads, species
    group, shared memory, blocks per SM and the waves of blocks this
    shape takes on this card, and its ptxas figures."""
    import torch
    S, _, ny, nx = shape
    cfg = kernels.upwind_config(S)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-nx // cfg["tile_x"]) * -(-ny // cfg["tile_y"])
    figures = ptxas_figures(kernels.BUILD_INFO["log"], "upwind")
    entry.update(launch=dict(cfg, waves=tiles / (cfg["blocks_per_sm"] * sms)),
                 ptxas={k: v for k, v in figures.items() if "tile" in k})
    log(f"  advect_upwind build: {json.dumps(entry['ptxas'])}; launch "
        f"{json.dumps(entry['launch'])}")
    return entry


def sb04_on_state(model, kernels, step, mp_plain, rho_operand,
                  label="ridge state after one interval"):
    """K2 (or K3 with the state's density, ``rho_operand``) against its
    plain version on ``model``'s state at the path's dt, on copies (it
    updates in place), both timed; then the share of column tiles that ran
    each fall loop (kernels.mp_simple_fall_tiles). Returns (max abs err,
    kernel ms, plain ms, {"rain": share, "snow": share}, work)."""
    import torch
    from icar_tpu_torch import constants as C
    s, g = model.state, model.geom_t
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    idx = [names.index(k) for k in step.MP_SPECIES]
    p, ex, dz = s["pressure"], s["exner"], g.dz_interface
    rho = s["density"] if rho_operand else None
    c2r, c2s = mp_plain.formation_rates(dt)
    name, tag = (("mp_simple_rho", "K3") if rho_operand
                 else ("mp_simple", "K2"))
    work = torch.empty_like(stack)
    acc0 = (s["precipitation"], s["snowfall"])
    acc = [torch.empty_like(a) for a in acc0]

    def reset():
        work.copy_(stack)
        for a, a0 in zip(acc, acc0):
            a.copy_(a0)

    def run_k():
        if rho_operand:
            kernels.mp_simple_rho(*(work[i] for i in idx), p, ex, rho, dz,
                                  *acc, dt, c2r, c2s)
        else:
            kernels.mp_simple(*(work[i] for i in idx), p, ex, dz, *acc, dt,
                              c2r, c2s)

    def run_p():
        th = stack[idx[0]]
        r = rho if rho_operand else p / (C.RD * (th * ex))
        return mp_plain.mp_simple(p, th, ex, r, *(stack[i] for i in idx[1:]),
                                  *acc0, dt, dz, c2r, c2s)

    reset()
    run_k()
    torch.cuda.synchronize()
    want = run_p()
    err = 0.0
    for field, got, ref in zip(
            ("theta", "qv", "qc", "qr", "qs", "rain", "snow"),
            [work[i] for i in idx] + acc, want):
        err = max(err, assert_close(got, ref, K2_RTOL, K2_ATOL,
                                    f"{name} kernel vs plain ({label}): "
                                    f"{field}"))
    ms, pms = cuda_ms(run_k, setup=reset), cuda_ms(run_p)
    reset()
    n_r, n_s, n = kernels.mp_simple_fall_tiles(
        *(work[i] for i in idx), p, ex, dz, *acc, dt, c2r, c2s, rho=rho)
    shares = {"rain": n_r / n, "snow": n_s / n}
    log(f"{tag} {name} on the {label}: max_abs_err {err:.3e} (rtol "
        f"{K2_RTOL}, atol {K2_ATOL}); fall loops ran in {n_r} (rain) and "
        f"{n_s} (snow) of {n} tiles ({100 * shares['rain']:.2f}%, "
        f"{100 * shares['snow']:.2f}%); kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms")
    return err, ms, pms, shares, sb04_work(
        mp_plain, *(stack[i] for i in idx), p, ex, dz, dt, rho_operand)


def ridge_columns(seed, nz=20, ny=5, nx=40, wet=None, t_sfc=288.0,
                  depth=None):
    """Seeded SB04 columns like the ridge's after some cloud has formed,
    made with numpy so that the same inputs reach the plain version, the
    kernel on the card and its source built for the CPU (the tests import
    this): float32 arrays (p, theta, exner, rho, qv, qc, qr, qs, rain,
    snow, dz), the fields (z, y, x) and the accumulators (y, x). Layers
    41-50 m thick at the ground, thickening upward to six times that (so
    rain takes 11-13 substeps of 1200/23 s, snow 2), about 2.3 km at 20
    levels; with ``depth`` the layers are scaled to that total depth [m]. ``wet`` (ny*nx,) bool marks the columns
    that may hold cloud, rain and snow (by default three columns in five);
    the others are subsaturated and free of every hydrometeor. ``t_sfc`` is
    the ground's temperature (lapse rate 6.5 K/km)."""
    r = np.random.default_rng(seed)
    shape = (nz, ny, nx)
    if wet is None:
        wet = np.arange(ny * nx) % 5 < 3
    wet = np.asarray(wet).reshape(1, ny, nx)
    dz = r.uniform(41.0, 50.0, (1, ny, nx)) * (
        1.0 + 2.4 / nz * np.arange(nz))[:, None, None] ** 1.5
    if depth is not None:
        dz = dz * (depth / dz.sum(axis=0, keepdims=True))
    z = np.cumsum(dz, axis=0) - 0.5 * dz
    p = 100000.0 * np.exp(-z / 8000.0)
    t = t_sfc - 0.0065 * z + r.uniform(-1.5, 1.5, shape)
    es = 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86))
    qvs = 0.622 * es / (p - es)
    rh = np.where(wet, r.choice([0.8, 0.95, 1.0, 1.02, 1.1], size=shape),
                  r.uniform(0.4, 0.9, shape))
    qv = qvs * rh

    def hydro(frac, top):
        return np.where(wet & (r.uniform(size=shape) < frac),
                        r.uniform(0, top, shape), 0.0)

    qc = hydro(0.5, 1e-3)
    qr = hydro(0.4, 5e-4) * (r.uniform(size=(1, ny, nx)) < 0.7)
    qs = hydro(0.4, 3e-4) * (t < 275.0)
    exner = (p / 100000.0) ** 0.2857
    theta = t / exner
    rho = p / (287.058 * t)
    rain = r.uniform(0, 3, shape[1:])
    snow = r.uniform(0, 1, shape[1:])
    return [np.ascontiguousarray(a, np.float32) for a in
            (p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz)]


def check_sb04_deep(kernels, mp_plain, dev):
    """K2 and K3 against their plain version on seeded columns of
    SB04_DEEP (deeper than K4's 64 levels, narrower tiles, a
    ragged last tile); returns (K2's max abs err, K3's)."""
    import torch
    from icar_tpu_torch import constants as C
    nz, ny, nx = SB04_DEEP
    dt = np.float32(1200.0 / 23)
    c2r, c2s = mp_plain.formation_rates(dt)
    p, th, ex, rho, qv, qc, qr, qs, rain, snow, dz = (
        torch.tensor(a, device=dev) for a in ridge_columns(8, nz, ny, nx))
    cols = kernels.library().icar_mp_simple_tile_columns(nz)
    errs = []
    for name in ("mp_simple", "mp_simple_rho"):
        r = rho if name == "mp_simple_rho" else p / (C.RD * (th * ex))
        want = mp_plain.mp_simple(p, th, ex, r, qv, qc, qr, qs, rain, snow,
                                  dt, dz, c2r, c2s)
        got = [t.clone() for t in (th, qv, qc, qr, qs, rain, snow)]
        if name == "mp_simple":
            kernels.mp_simple(*got[:5], p, ex, dz, *got[5:], dt, c2r, c2s)
        else:
            kernels.mp_simple_rho(*got[:5], p, ex, rho, dz, *got[5:], dt,
                                  c2r, c2s)
        torch.cuda.synchronize()
        errs.append(max(assert_close(
            g, w, K2_RTOL, K2_ATOL, f"{name} kernel vs plain (seeded "
            f"columns {SB04_DEEP}, {cols}-column tiles): {field}")
            for field, g, w in zip(("theta", "qv", "qc", "qr", "qs", "rain",
                                    "snow"), got, want)))
    log(f"K2/K3 at {nz} levels: max_abs_err {errs[0]:.3e} / {errs[1]:.3e}")
    return errs


def sb04_entry(name, kernels, model, err, ms, pms, work, shares,
               initial=None):
    """The kernel-table entry of K2 or K3 with its fall-tile shares, tile,
    shared memory and ptxas figures; ``initial`` is K2's sb04_on_state
    result on the ridge's initial state."""
    lib = kernels.library()
    nz = model.state["pressure"].shape[0]
    entry = kernel_entry(name, REPLACES[name], err, ms, pms, work)
    entry["fall_tile_share"] = {"after_one_interval": shares}
    if initial is not None:
        entry.update(ms_initial_state=initial[1],
                     plain_ms_initial_state=initial[2],
                     bound_ms_initial_state=bound(*initial[4])[0])
        entry["fall_tile_share"]["initial_state"] = initial[3]
    figures = ptxas_figures(kernels.BUILD_INFO["log"], "mp_simple")
    variant = "ILb1E" if name == "mp_simple_rho" else "ILb0E"
    entry.update(tile_columns=lib.icar_mp_simple_tile_columns(nz),
                 dynamic_smem_bytes=lib.icar_mp_simple_smem_bytes(nz),
                 ptxas={k: v for k, v in figures.items() if variant in k})
    log(f"  {name} build: {json.dumps(entry['ptxas'])}; "
        f"{entry['dynamic_smem_bytes']} B of dynamic shared memory per "
        f"{entry['tile_columns']}-column tile")
    return entry


def random_mpdata_case(dev, shape=MPDATA_SMALL, seed=17):
    """A random stack of ``shape`` (S, nz, ny, nx) on ``dev`` with winds of
    both signs on both axes and metrics near one: (q, u, v, w, geometry
    namespace, floors)."""
    import torch
    r = np.random.default_rng(seed)
    S, nz, ny, nx = shape
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    q = f(r.uniform(0.1, 1.0, (S, nz, ny, nx)))
    u, v = f(r.uniform(-6, 6, (nz, ny, nx + 1))), f(r.uniform(
        -6, 6, (nz, ny + 1, nx)))
    w, dz = f(r.uniform(-1, 1, (nz, ny, nx))), f(r.uniform(
        200, 400, (nz, ny, nx)))
    ju, jv = f(r.uniform(0.8, 1.2, (nz, ny, nx + 1))), f(r.uniform(
        0.8, 1.2, (nz, ny + 1, nx)))
    jw, jaco = f(r.uniform(0.8, 1.2, (nz, ny, nx))), f(r.uniform(
        0.8, 1.2, (nz, ny, nx)))
    geom = SimpleNamespace(dx=1000.0, jacobian_u=ju, jacobian_v=jv,
                           jacobian_w=jw, advection_dz=dz, jacobian=jaco)
    return q, u, v, w, geom, f(np.resize([-np.inf, 0.0, 0.0, 0.0, 0.5], S))


def check_mpdata_kernels(model, kernels, step, mpdata_plain, mp_plain,
                         deep_err):
    """K4 (at the path's order 2 with FCT, and at other orders on a smaller
    random stack) and K3 (with the state's density) against their plain
    versions on the MPDATA model's state; ``deep_err`` is K3's max abs err
    at SB04_DEEP levels."""
    import torch
    s = model.state
    g = model.geom_t
    adv = model.options.adv
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    out = torch.empty_like(stack)
    results = []

    # --- K4 at the path's shapes and options
    order, fct = adv.mpdata_order, adv.flux_corrected_transport
    run_k4 = lambda: kernels.advect_mpdata(stack, winds, dt, order, fct,
                                           floors, True, out=out)
    run_p4 = lambda: mpdata_plain.advect_mpdata(
        stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u, g.jacobian_v,
        g.jacobian_w, g.jacobian, g.advection_dz, order=order, use_fct=fct,
        floors=floors, near_end=True)
    run_k4()
    torch.cuda.synchronize()
    err4 = assert_close(out, run_p4(), K4_RTOL, K4_ATOL,
                        f"advect_mpdata kernel vs plain (order {order}, "
                        f"fct {fct})")
    ms4, pms4 = cuda_ms(run_k4), cuda_ms(run_p4)
    log(f"K4 advect_mpdata: max_abs_err {err4:.3e} (rtol {K4_RTOL}, atol "
        f"{K4_ATOL}); kernel {ms4:.4f} ms, plain {pms4:.4f} ms")

    # --- K4 at the other orders on a random stack
    q, u, v, w, rg, small_floors = random_mpdata_case(stack.device)
    small = kernels.prepare_advect_winds(u, v, w, rg)
    for o, fc in MPDATA_VARIANTS:
        got = kernels.advect_mpdata(q, small, np.float32(20.0), o, fc,
                                    small_floors, True)
        torch.cuda.synchronize()
        want = mpdata_plain.advect_mpdata(
            q, u, v, w, np.float32(20.0), 1000.0, rg.jacobian_u,
            rg.jacobian_v, rg.jacobian_w, rg.jacobian, rg.advection_dz,
            order=o, use_fct=fc, floors=small_floors, near_end=True)
        err4 = max(err4, assert_close(
            got, want, K4_RTOL, K4_ATOL,
            f"advect_mpdata kernel vs plain (order {o}, fct {fc}, "
            f"{MPDATA_SMALL} random stack)"))
    results.append(kernel_entry(
        "advect_mpdata", REPLACES["advect_mpdata"], err4, ms4, pms4,
        advect_work(*stack.shape, order, fct)))

    # --- K3 with the state's density
    err3, ms3, pms3, shares, work3 = sb04_on_state(model, kernels, step,
                                                   mp_plain, True)
    results.append(sb04_entry("mp_simple_rho", kernels, model,
                              max(err3, deep_err), ms3, pms3, work3, shares))
    return results


def check_mpdata_thompson(model, kernels, step, mpdata_plain):
    """K4 on the Thompson path's 9-species stack, at its order and FCT,
    against its plain version on the state the Thompson drive left."""
    err, ms, pms, work = k4_on_state(model, kernels, step, mpdata_plain)
    return [kernel_entry("advect_mpdata_9species",
                         REPLACES["advect_mpdata_9species"], err, ms, pms,
                         work)]


def k4_on_state(model, kernels, step, mpdata_plain):
    """K4 on ``model``'s advected stack at the path's dt and its options'
    order and FCT, clamped, against its plain version (K4_RTOL), both
    timed: (max abs err, kernel ms, plain ms, the work for ``bound``)."""
    import torch
    s = model.state
    g = model.geom_t
    adv = model.options.adv
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    out = torch.empty_like(stack)
    order, fct = adv.mpdata_order, adv.flux_corrected_transport
    run_k4 = lambda: kernels.advect_mpdata(stack, winds, dt, order, fct,
                                           floors, True, out=out)
    run_p4 = lambda: mpdata_plain.advect_mpdata(
        stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u, g.jacobian_v,
        g.jacobian_w, g.jacobian, g.advection_dz, order=order, use_fct=fct,
        floors=floors, near_end=True)
    run_k4()
    torch.cuda.synchronize()
    err = assert_close(out, run_p4(), K4_RTOL, K4_ATOL,
                       f"advect_mpdata kernel vs plain ({len(names)} species, "
                       f"order {order}, fct {fct})")
    ms, pms = cuda_ms(run_k4), cuda_ms(run_p4)
    log(f"K4 advect_mpdata, {len(names)} species: max_abs_err {err:.3e} "
        f"(rtol {K4_RTOL}, atol {K4_ATOL}); kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms")
    return err, ms, pms, advect_work(*stack.shape, order, fct)


def thompson_states(cases, dev):
    """(name, dt, stack, exner, p, dz) of the random states of
    icar_tpu_torch.physics.thompson_cases at THOMPSON_SMALL: mixed-regime
    columns (warm rain, mixed phase, riming, glaciated) at THOMPSON_DTS, an
    inert state (dry, subsaturated, sub-R1 traces, a few cells under the
    vapour floor) and an ice-supersaturated one (228 K, 140% over ice)."""
    states = [(f"mixed seed {seed}", dt, cases.mixed_state(seed,
                                                           *THOMPSON_SMALL))
              for seed, dt in zip((1, 2, 3), THOMPSON_DTS)]
    states += [("inert", 45.0, cases.inert_state(*THOMPSON_SMALL)),
               ("ice-supersaturated", 45.0,
                cases.ice_supersaturated_state(*THOMPSON_SMALL))]
    return [(name, dt) + cases.as_stack(state, dev)
            for name, dt, state in states]


def thompson_compare(cases, got, want, what):
    """Hold K5's fields and accumulators ``got`` against the plain
    version's ``want`` (thompson_cases.compare at K5_RTOL, K5_SHARE).
    Returns the largest absolute difference."""
    worst, shares = cases.compare(got, want, K5_RTOL, K5_SHARE, what)
    log(f"  {what}: max abs err {worst:.3e}; shares beyond rtol {K5_RTOL}: "
        + ", ".join(f"{k} {v:.2e}" for k, v in shares.items()))
    return worst


def thompson_work(tp, stack, smap, exner, p, dz, dt, params):
    """Bytes and operations of K5 on these inputs: the stack read and
    written, exner, p and dz read, the accumulators read and written (the
    table entries each cell reads where a predicate holds are left out, so
    the byte count errs low); the per-cell work, and the sedimentation
    steps this state's columns take (from the plain version's terminal
    velocities)."""
    import torch
    _, nz, ny, nx = stack.shape
    n, plane = nz * ny * nx, ny * nx
    nbytes = 4 * (2 * 9 * n + 3 * n + 2 * 3 * plane)
    _, c = tp.get_tables(params)
    P = tp._prep_block(*(stack[i] for i in smap), exner, p, c, params)
    I = tp._index_block(P, c)
    DT = tp._f32(dt)
    O = tp._core_block(P, I["idx_i"],
                       tp._lookup(tp.device_tables(params, stack.device), I),
                       DT, c, params)

    def steps(vt):
        per_k = torch.where(vt > 1e-3, torch.trunc(DT * vt / dz) + 1, 0)
        return int(torch.clamp(torch.amax(per_k, dim=0), min=1).sum())
    s_num = steps(torch.maximum(O["vtrk"], O["vtnrk"])) + steps(O["vtik"])
    s_mass = steps(O["vtsk"]) + steps(O["vtgk"])
    ops = ((K5_CELL_OPS + 4 * K5_CFL_OPS) * n
           + nz * (K5_SED_NUMBER_OPS * s_num + K5_SED_MASS_OPS * s_mass)
           + K5_SFC_OPS * (s_num + s_mass))
    log(f"  K5 work: {nbytes / 1e9:.4f} GB, {ops / 1e9:.4f} G operations "
        f"({s_num + s_mass} column sedimentation steps)")
    return nbytes, ops


def ptxas_figures(log_text, marker):
    """Registers, spills, stack frame and static shared memory of each
    entry function whose name holds ``marker``, from nvcc's ``-Xptxas -v``
    log: {short name: {...}}."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None or marker not in name:
            continue
        short = re.search(marker + r"(?:_[a-z]+)?_kernel(?:ILb[01]E)?",
                          name)
        fig = out.setdefault(short.group(0) if short else name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            fig.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fig["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            fig["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def k5_on_state(model, kernels, step, tp, cases, label):
    """K5 against its plain version on ``model``'s state at the path's dt,
    both timed; returns (max abs err, kernel ms, plain ms, share of active
    tiles, work)."""
    import torch
    s = model.state
    g = model.geom_t
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    smap = tp.stack_smap(names)
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    params = step.thompson_params(model.options)
    p, ex = s["pressure"].contiguous(), s["exner"].contiguous()
    dz = g.dz_mass.contiguous()
    work = torch.empty_like(stack)
    acc = [torch.empty_like(s["precipitation"]) for _ in range(3)]
    acc0 = [s[k] for k in ("precipitation", "snowfall", "graupel")]

    def reset():
        work.copy_(stack)
        for a, a0 in zip(acc, acc0):
            a.copy_(a0)

    def run_k5():
        return kernels.mp_thompson_stack(work, smap, ex, p, dz, dt, *acc,
                                         params)

    def run_p5():
        return tp.mp_thompson_stack(stack, names, ex, p, dz, dt, *acc0,
                                    params)

    reset()
    n_active = run_k5()
    torch.cuda.synchronize()
    _, nz, ny, nx = stack.shape
    ntiles = -(-(ny * nx) // kernels.library().icar_mp_thompson_tile_columns(
        nz))
    share = int(n_active[0]) / ntiles
    out, *want_acc = run_p5()
    err = thompson_compare(cases, [work[i] for i in smap] + acc,
                           [out[i] for i in smap] + want_acc,
                           f"mp_thompson kernel vs plain ({label}, dt "
                           f"{float(dt)})")
    ms, pms = cuda_ms(run_k5, setup=reset), cuda_ms(run_p5)
    log(f"K5 mp_thompson on the {label}: max_abs_err {err:.3e}; "
        f"{int(n_active[0])} of {ntiles} tiles active ({100 * share:.2f}%); "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return err, ms, pms, share, thompson_work(tp, stack, smap, ex, p, dz, dt,
                                              params)


def check_thompson_kernel(model, kernels, step, tp, cases, initial):
    """K5 against its plain version on the Thompson ridge's state after
    the drive (its entry's time and bound), on the random states of
    thompson_states and at THOMPSON_DEEP levels; ``initial`` is
    k5_on_state's result on the ridge's initial state."""
    import torch
    err5, ms5, pms5, share, work5 = k5_on_state(
        model, kernels, step, tp, cases, "ridge state after two intervals")
    dev = model.state["pressure"].device
    params = step.thompson_params(model.options)
    deep = cases.as_stack(cases.mixed_state(4, *THOMPSON_DEEP,
                                            8000.0 / THOMPSON_DEEP[0]), dev)
    states = thompson_states(cases, dev)
    states.append((f"mixed seed 4, nz {THOMPSON_DEEP[0]}", 60.0) + deep)
    for name, sdt, q, sex, sp, sdz in states:
        z = torch.zeros(q.shape[2:], device=q.device)
        want, *wacc = tp.mp_thompson_stack(q, tp.SPECIES, sex, sp, sdz,
                                           np.float32(sdt), z, z, z)
        got = q.clone()
        gacc = [z.clone() for _ in range(3)]
        kernels.mp_thompson_stack(got, tuple(range(9)), sex, sp, sdz,
                                  np.float32(sdt), *gacc, params)
        torch.cuda.synchronize()
        err5 = max(err5, thompson_compare(
            cases, list(got) + gacc, list(want) + wacc,
            f"mp_thompson kernel vs plain ({name}, dt {sdt}, "
            f"{tuple(q.shape)})"))
    err5 = max(err5, initial[0])
    entry = kernel_entry("mp_thompson", REPLACES["mp_thompson"], err5, ms5,
                         pms5, work5)
    lib = kernels.library()
    nz = model.state["pressure"].shape[0]
    entry.update(
        ms_initial_state=initial[1], plain_ms_initial_state=initial[2],
        bound_ms_initial_state=bound(*initial[4])[0],
        active_tile_share={"initial_state": initial[3],
                           "after_two_intervals": share},
        tile_columns=lib.icar_mp_thompson_tile_columns(nz),
        dynamic_smem_bytes=lib.icar_mp_thompson_smem_bytes(nz),
        ptxas=ptxas_figures(kernels.BUILD_INFO["log"], "mp_thompson"))
    log(f"  K5 build: {json.dumps(entry['ptxas'])}; "
        f"{entry['dynamic_smem_bytes']} B of dynamic shared memory per "
        f"{entry['tile_columns']}-column tile")
    return [entry]


def one_card_mesh(shape):
    """A mesh of ``shape`` whose shards all run on cuda:0."""
    from icar_tpu_torch.parallel.mesh import Mesh
    return Mesh(["cuda:0"] * (shape[0] * shape[1]), shape)


def shard_blocks(model, shape, halo, kernels, step):
    """``model``'s state cut into the blocks of a one-card mesh of
    ``shape`` with ``halo``: the layout, and as lists of blocks the
    geometry, the stack of advected species, the advection winds, the
    floors and the fields the microphysics reads."""
    import torch
    from icar_tpu_torch.parallel.mesh import Layout, scatter_geometry
    s = model.state
    layout = Layout(one_card_mesh(shape), model.geom.ny, model.geom.nx,
                    halo)
    geoms = scatter_geometry(model.geom, layout)
    b = SimpleNamespace(layout=layout, geoms=geoms, **{
        k: layout.scatter(s[k]) for k in (
            "u", "v", "w", "pressure", "exner", "density", "precipitation",
            "snowfall", "graupel") if k in s})
    b.stack = layout.scatter(torch.stack([s[k] for k in model.advect_names]))
    b.winds = [kernels.prepare_advect_winds(u, v, w, g)
               for u, v, w, g in zip(b.u, b.v, b.w, geoms)]
    b.floors = [torch.as_tensor(step.limit_floors(model.advect_names),
                                device=sh.device) for sh in layout.shards]
    return b


def shard_err(layout, blocks, want, what):
    """The largest difference between the owned cells of ``blocks`` and
    the unsharded kernel's ``want``: 0.0, or AssertionError unless every
    bit agrees."""
    import torch
    got = layout.gather(blocks)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        d = (got - want).abs()
        raise AssertionError(f"{what}: {int((got != want).sum())} cells "
                             f"differ from the unsharded kernel (max "
                             f"{float(d.max()):.3e})")
    return float((got - want).abs().max())


def shard_time(label, run, works, setup=None):
    """CUDA-event milliseconds of one per-shard wrapper call (median of 7)
    and the bound of the blocks' summed work ``works`` [(bytes, ops)];
    logged."""
    ms = cuda_ms(run, setup=setup)
    bms, by = bound(sum(w[0] for w in works), sum(w[1] for w in works))
    log(f"  {label}: {ms:.4f} ms per call ({len(works)} launches); bound "
        f"{bms:.4f} ms ({by}), kernel at {100 * bms / ms:.1f}% of it")
    return ms, bms, by


def check_shard_upwind(model, kernels, step, sk, mp_plain):
    """K1 and K2 per shard on a 2x2 mesh against the unsharded kernels on
    the upwind ridge's state: max_abs_err must be 0.0."""
    import torch
    s, g = model.state, model.geom_t
    names = model.advect_names
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    b = shard_blocks(model, (2, 2), sk.UPWIND_HALO, kernels, step)
    L = b.layout

    want = kernels.advect_upwind(stack, kernels.prepare_advect_winds(
        s["u"], s["v"], s["w"], g), dt, floors, True)
    out = [torch.empty_like(q) for q in b.stack]

    def run1():
        sk.advect_upwind_sharded(L, b.stack, b.winds, dt, b.floors, True,
                                 out)
    run1()
    torch.cuda.synchronize()
    err = shard_err(L, out, want, "advect_upwind_sharded 2x2")
    log(f"shard K1 advect_upwind_sharded 2x2: max_abs_err {err} against "
        f"the unsharded kernel")
    shard_time("advect_upwind_sharded 2x2", run1,
               [advect_work(*q.shape) for q in b.stack])

    idx = [names.index(k) for k in step.MP_SPECIES]
    c2r, c2s = mp_plain.formation_rates(dt)
    whole = stack.clone()
    rain = torch.zeros_like(s["precipitation"])
    snow = torch.zeros_like(rain)
    kernels.mp_simple(*(whole[i] for i in idx), s["pressure"], s["exner"],
                      g.dz_interface, rain, snow, dt, c2r, c2s)
    work = [torch.empty_like(q) for q in b.stack]
    rb = [torch.empty_like(x) for x in b.precipitation]
    sb = [torch.empty_like(x) for x in b.precipitation]
    dz = [gg.dz_interface for gg in b.geoms]

    def reset():
        for w, q in zip(work, b.stack):
            w.copy_(q)
        for x in rb + sb:
            x.zero_()

    def run2():
        sk.mp_simple_sharded(*([w[i] for w in work] for i in idx),
                             b.pressure, b.exner, dz, rb, sb, dt, c2r, c2s)
    reset()
    run2()
    torch.cuda.synchronize()
    err = max(shard_err(L, work, whole, "mp_simple_sharded 2x2: stack"),
              shard_err(L, rb, rain, "mp_simple_sharded 2x2: rain"),
              shard_err(L, sb, snow, "mp_simple_sharded 2x2: snow"))
    log(f"shard K2 mp_simple_sharded 2x2: max_abs_err {err} against the "
        f"unsharded kernel")
    shard_time("mp_simple_sharded 2x2", run2, [
        sb04_work(mp_plain, *(q[i] for i in idx), p, ex, d, dt, False)
        for q, p, ex, d in zip(b.stack, b.pressure, b.exner, dz)],
        setup=reset)


def check_shard_mpdata_path(model, kernels, step, sk, mp_plain, tp,
                            mpdata_plain, entry=False):
    """K4 and the path's microphysics (K3 on the MPDATA ridge, K5 on the
    Thompson ridge) per shard on each of SHARD_CHECK_MESHES against the
    unsharded kernels on ``model``'s state: max_abs_err must be 0.0. With
    ``entry``, the per-shard K4 of the 4x1 mesh is also held to its plain
    version on every block, and its kernel-table entry is returned."""
    import torch
    from icar_tpu_torch import constants as C
    s, g = model.state, model.geom_t
    names = model.advect_names
    adv = model.options.adv
    order, fct = adv.mpdata_order, adv.flux_corrected_transport
    thompson = model.options.physics.microphysics == C.MP_THOMPSON
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    want4 = kernels.advect_mpdata(stack, kernels.prepare_advect_winds(
        s["u"], s["v"], s["w"], g), dt, order, fct, floors, True)
    acc_names = ("precipitation", "snowfall") + (("graupel",) if thompson
                                                  else ())
    whole = stack.clone()
    acc = [s[k].clone() for k in acc_names]
    if thompson:
        smap = tp.stack_smap(names)
        params = step.thompson_params(model.options)
        kernels.mp_thompson_stack(whole, smap, s["exner"], s["pressure"],
                                  g.dz_mass, dt, *acc, params)
    else:
        idx = [names.index(k) for k in step.MP_SPECIES]
        c2r, c2s = mp_plain.formation_rates(dt)
        kernels.mp_simple_rho(*(whole[i] for i in idx), s["pressure"],
                              s["exner"], s["density"], g.dz_interface,
                              *acc, dt, c2r, c2s)
    mp_name = "thompson_stack_sharded" if thompson else "mp_simple_sharded"
    result = None
    for shape in SHARD_CHECK_MESHES:
        b = shard_blocks(model, shape, sk.mpdata_halo(order, fct), kernels,
                         step)
        L = b.layout
        tag = f"{shape[0]}x{shape[1]}, {len(names)} species"
        out = [torch.empty_like(q) for q in b.stack]

        def run4():
            sk.advect_mpdata_sharded(L, b.stack, b.winds, dt, order, fct,
                                     b.floors, True, out)
        run4()
        torch.cuda.synchronize()
        err = shard_err(L, out, want4, f"advect_mpdata_sharded {tag}")
        log(f"shard K4 advect_mpdata_sharded {tag}: max_abs_err {err} "
            f"against the unsharded kernel")
        works = [advect_work(*q.shape, order, fct) for q in b.stack]
        ms, bms, by = shard_time(f"advect_mpdata_sharded {tag}", run4, works)
        # the stack's halo exchange, once per substep: each halo cell read
        # once and written once
        halo = sum(q[0, 0].numel() for q in b.stack) - stack[0, 0].numel()
        xms = cuda_ms(lambda: L.exchange(b.stack))
        xbms, _ = bound(2 * 4 * halo * stack.shape[0] * stack.shape[1], 0)
        log(f"  halo exchange {tag} (halo {L.halo}): {xms:.4f} ms per "
            f"substep; bound {xbms:.4f} ms (bytes)")
        if entry and shape == (4, 1):
            def run_plain():
                return [mpdata_plain.advect_mpdata(
                    q, u, v, w, dt, gg.dx, gg.jacobian_u, gg.jacobian_v,
                    gg.jacobian_w, gg.jacobian, gg.advection_dz, order=order,
                    use_fct=fct, floors=f, near_end=True)
                    for q, u, v, w, gg, f in zip(b.stack, b.u, b.v, b.w,
                                                 b.geoms, b.floors)]
            perr = max(assert_close(o, p, K4_RTOL, K4_ATOL,
                                    f"advect_mpdata_sharded {tag}, block "
                                    f"{i}, vs plain")
                       for i, (o, p) in enumerate(zip(out, run_plain())))
            pms = cuda_ms(run_plain)
            log(f"advect_mpdata_padded (per-shard K4, {tag}): max_abs_err "
                f"{perr:.3e} against its plain version (rtol {K4_RTOL}, "
                f"atol {K4_ATOL}); kernel {ms:.4f} ms, plain {pms:.4f} ms")
            err = max(err, shard_random_mpdata(kernels, sk, stack.device))
            result = {"name": "advect_mpdata_padded", "route": "cuda",
                      "source": "icar_tpu_torch/csrc/mpdata.cu",
                      "replaces": REPLACES["advect_mpdata_padded"],
                      "launches": None, "max_abs_err": perr, "ms": ms,
                      "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                      "library_ms": None, "mesh": "4x1 on one card",
                      "max_abs_err_vs_unsharded": err}

        work = [torch.empty_like(q) for q in b.stack]
        accb = [[torch.empty_like(x) for x in getattr(b, k)]
                for k in acc_names]

        def reset():
            for w, q in zip(work, b.stack):
                w.copy_(q)
            for dst, k in zip(accb, acc_names):
                for x, x0 in zip(dst, getattr(b, k)):
                    x.copy_(x0)

        if thompson:
            dzm = [gg.dz_mass for gg in b.geoms]

            def run_mp():
                sk.thompson_stack_sharded(work, smap, b.exner, b.pressure,
                                          dzm, dt, *accb, params)
            mp_works = lambda: [thompson_work(tp, q, smap, ex, p, d, dt,
                                              params)
                                for q, ex, p, d in zip(b.stack, b.exner,
                                                       b.pressure, dzm)]
        else:
            dzi = [gg.dz_interface for gg in b.geoms]

            def run_mp():
                sk.mp_simple_sharded(*([w[i] for w in work] for i in idx),
                                     b.pressure, b.exner, dzi, *accb, dt,
                                     c2r, c2s, rho=b.density)
            mp_works = lambda: [sb04_work(mp_plain, *(q[i] for i in idx), p,
                                          ex, d, dt, True)
                                for q, p, ex, d in zip(b.stack, b.pressure,
                                                       b.exner, dzi)]
        reset()
        run_mp()
        torch.cuda.synchronize()
        err = max([shard_err(L, work, whole, f"{mp_name} {tag}: stack")]
                  + [shard_err(L, x, a, f"{mp_name} {tag}: {k}")
                     for x, a, k in zip(accb, acc, acc_names)])
        log(f"shard {'K5' if thompson else 'K3'} {mp_name} {tag}: "
            f"max_abs_err {err} against the unsharded kernel")
        shard_time(f"{mp_name} {tag}", run_mp, mp_works(), setup=reset)
    return result


def shard_random_mpdata(kernels, sk, dev):
    """The per-shard K4 on the random stack of ``random_mpdata_case``
    (flow across every shard boundary) at orders 1-4, FCT on and off, on
    4x1 and 2x2 meshes with the halo ``sk.mpdata_halo`` gives, against the
    unsharded K4: max_abs_err must be 0.0."""
    import torch
    from icar_tpu_torch.parallel.mesh import Layout
    q, u, v, w, rg, floors = random_mpdata_case(dev)
    winds = kernels.prepare_advect_winds(u, v, w, rg)
    _, _, ny, nx = q.shape
    keys = ("jacobian_u", "jacobian_v", "jacobian_w", "jacobian",
            "advection_dz")
    err = 0.0
    for shape in SHARD_CHECK_MESHES:
        for order in (1, 2, 3, 4):
            for fct in (True, False):
                L = Layout(one_card_mesh(shape), ny, nx,
                           sk.mpdata_halo(order, fct))
                geoms = [SimpleNamespace(dx=rg.dx, **dict(zip(keys, blk)))
                         for blk in zip(*(L.scatter(getattr(rg, k))
                                          for k in keys))]
                wb = [kernels.prepare_advect_winds(ub, vb, wwb, gb)
                      for ub, vb, wwb, gb in zip(L.scatter(u), L.scatter(v),
                                                 L.scatter(w), geoms)]
                qb = L.scatter(q)
                out = [torch.empty_like(x) for x in qb]
                sk.advect_mpdata_sharded(L, qb, wb, np.float32(20.0), order,
                                         fct, [floors] * len(qb), True, out)
                want = kernels.advect_mpdata(q, winds, np.float32(20.0),
                                             order, fct, floors, True)
                torch.cuda.synchronize()
                err = max(err, shard_err(
                    L, out, want, f"advect_mpdata_sharded {shape[0]}x"
                    f"{shape[1]}, order {order}, fct {fct}, random stack"))
    log(f"shard K4 advect_mpdata_sharded on the {MPDATA_SMALL} random "
        f"stack, orders 1-4, FCT on and off, 4x1 and 2x2: max_abs_err {err} "
        f"against the unsharded kernel")
    return err


def golden_mismatches(fields, ref):
    """Hold ``fields`` (name -> array) against the golden arrays ``ref``.
    Returns (report lines, names of fields out of tolerance)."""
    report, failed = [], []
    for f, atol in GOLDEN_ATOL.items():
        got = np.asarray(fields[f], np.float64)
        want = np.asarray(ref[f], np.float64)
        d = np.abs(got - want)
        strict = int((d > atol + 1e-4 * np.abs(want)).sum())
        line = (f"{f}: max|d| {d.max():.3e}, mean|d| {d.mean():.3e}, "
                f"{strict} cells outside the golden tolerance")
        if f in ENSEMBLE_MAX:
            ok = (bool((d <= ENSEMBLE_MAX[f] + 1e-4 * np.abs(want)).all())
                  and d.mean() <= ENSEMBLE_MEAN[f])
            line += (f"; ensemble bound {ENSEMBLE_MAX[f]:.1e}/"
                     f"{ENSEMBLE_MEAN[f]:.1e}")
        else:
            ok = strict == 0
        report.append(line + ("" if ok else "  FAIL"))
        if not ok or not np.isfinite(got).all():
            failed.append(f)
    return report, failed


def check_golden(ideal_ridge_model):
    """The pinned golden ridge case on the card (tests/test_golden.py)."""
    ref = np.load(GOLDEN)
    m = ideal_ridge_model(**GOLDEN_CASE, device="cuda")
    steps = 0
    while steps < GOLDEN_MIN_STEPS:
        m.advance(GOLDEN_INTERVAL)
        steps += m.last_n_substeps
    if steps != int(ref["steps"]):
        raise AssertionError(f"golden: {steps} substeps, golden has "
                             f"{int(ref['steps'])}")
    report, failed = golden_mismatches(
        {f: m.field(f) for f in GOLDEN_ATOL}, ref)
    for line in report:
        log("golden " + line)
    if failed:
        raise AssertionError(f"golden fields out of tolerance: {failed}")
    log(f"golden: {steps} substeps, all fields within tolerance")


DRIVE_FIELDS = ("potential_temperature", "water_vapor", "cloud_water",
                "rain_mass", "snow_mass", "precipitation", "u", "v", "w")


def drive(model, kernels, label, path, smi, fields=DRIVE_FIELDS,
          shards=1, due=None, intervals=2):
    """Advance ``model`` over ``intervals`` 1200 s intervals (two by
    default; ``run_timed``, which
    solves the winds anew before each interval where they follow the
    state) with the launch counts set to 0 just before; check that
    ``fields`` are finite, that there is cloud and precipitation, and that
    each kernel of ``path`` launched once per substep and shard
    (``shards``), or the count ``due`` gives it, and the others not at
    all; log the rate over the natural grid points (the wind updates' time
    apart) and the final state's digest. Returns (launch counts, digest,
    substeps)."""
    import torch
    from icar_tpu_torch.time_paths import run_timed
    kernels.reset_launches()
    wind_ms = []
    steps, seconds = run_timed(model, intervals=intervals, wind_ms=wind_ms)
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        want = steps * shards if name in path else 0
        if due and name in due:
            want = due[name]
        if n != want:
            raise AssertionError(f"{name}: {n} launches for {steps} "
                                 f"substeps on the {label} path, expected "
                                 f"{want}")
    for f in fields:
        if not torch.isfinite(model.global_field(f)).all():
            raise AssertionError(f"{label} path: non-finite {f}")
    qc_max = float(model.global_field("cloud_water").max())
    pr_max = float(model.global_field("precipitation").max())
    if not (qc_max > 0 and pr_max > 0):
        raise AssertionError(f"{label} path: no cloud ({qc_max}) or no "
                             f"precipitation ({pr_max})")
    d = model.options.domain
    rate = d.nx * d.ny * d.nz * steps / seconds
    winds = (f" (wind updates before the intervals apart: "
             f"{', '.join(f'{ms:.3f}' for ms in wind_ms)} ms)"
             if wind_ms else "")
    log(f"{label} path {d.nx}x{d.ny}x{d.nz}: {steps} substeps in "
        f"{seconds:.3f} s = {rate / 1e6:.1f}M gp*steps/s on {smi}{winds}; "
        f"qc max {qc_max:.3e}, precip max {pr_max:.3f} mm; launches "
        f"{launches}")
    digest = model.digest()
    log(f"digest {label}: " + json.dumps(digest))
    return launches, digest, steps


def sharded_drive(label, case, mesh, path, reference, kernels, smi):
    """Drive the ridge ``case`` sharded over ``mesh`` and hold it to the
    unsharded drive's (digest, substeps) ``reference``: every digest sum
    equal, the same substep count. Returns the launch counts."""
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.core.step import thompson_params
    from icar_tpu_torch.models.icar import ideal_ridge_model
    from icar_tpu_torch.physics.mp_thompson import device_tables
    model = ideal_ridge_model(**case, device="cuda")
    model.attach_mesh(mesh)
    if case.get("mp") in (C.MP_THOMPSON, C.MP_THOMPSON_AER):
        # the lookup tables go to each card as set-up, before the timed run
        for dev in set(mesh.devices):
            device_tables(thompson_params(model.options), dev)
    my, mx = mesh.shape
    launches, digest, steps = drive(
        model, kernels, f"{label} sharded {my}x{mx}", path, smi,
        fields=tuple(model.advect_names) + ("precipitation", "u", "v", "w"),
        shards=mesh.size)
    if (digest, steps) != reference:
        raise AssertionError(f"{label} sharded {my}x{mx}: {steps} substeps "
                             f"and digest {digest}; unsharded: "
                             f"{reference[1]} substeps, {reference[0]}")
    log(f"{label} sharded {my}x{mx}: {steps} substeps and every digest sum "
        f"equal to the unsharded drive's")
    return launches


def fullphys_small(ideal_ridge_model, fullphys, device, nudge=False):
    """The small full-physics case with its water strip, one interval on
    ``device``; with ``nudge``, theta and water vapour start one ulp up or
    down per cell (seeded), as the golden ensemble perturbs them."""
    import torch
    m = ideal_ridge_model(**FULLPHYS_SMALL, **fullphys, device=device)
    land = m.state["land_mask"].clone()
    land[:, :10] = 2.0
    m.state = {**m.state, "land_mask": land}
    if nudge:
        r = np.random.default_rng(0)
        for k in ("potential_temperature", "water_vapor"):
            a = m.state[k]
            up = torch.as_tensor(r.uniform(size=tuple(a.shape)) < 0.5,
                                 device=a.device)
            m.state[k] = torch.nextafter(a, torch.where(
                up, torch.full_like(a, np.inf), torch.full_like(a, -np.inf)))
    m.advance(FULLPHYS_SMALL_INTERVAL)
    return m


def hold_card_to_cpu(cpu, card, label, spread=None,
                     ill=FULLPHYS_ILL_CONDITIONED):
    """Hold the model ``card`` (run on the card) to ``cpu`` (the same run
    on the CPU): every field finite and within FULLPHYS_BOUNDS of the
    CPU's (largest difference over the CPU field's largest magnitude;
    the fields of ``ill`` beyond the bound in at most FULLPHYS_ILL_SHARE
    of the cells), or within twice ``spread`` of a field (the same measure
    of the CPU run against one started a ulp away) where that is larger.
    Returns the largest ratio of each group: {group: (ratio, field,
    bound)}."""
    worst = {}
    for k in cpu.state:
        want, got = cpu.field(k).astype(np.float64), card.field(k)
        if not np.isfinite(got).all():
            raise AssertionError(f"{label} on the card: non-finite {k}")
        bound = FULLPHYS_BOUNDS["species" if k in cpu.advect_names
                                else "other"]
        if spread is not None:
            bound = max(bound, 2 * spread[k])
        rel = np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)
        ratio = float(rel.max())
        beyond = float((rel > bound).mean())
        is_ill = k in ill
        if beyond > (FULLPHYS_ILL_SHARE if is_ill else 0.0):
            raise AssertionError(f"{label}: {k} differs by up to "
                                 f"{ratio:.3e} of its largest value "
                                 f"between the card and the CPU, in "
                                 f"{100 * beyond:.1f}% of its cells beyond "
                                 f"{bound}")
        group = ((", ".join(ill) if ill != FULLPHYS_ILL_CONDITIONED
                  else "cloud fraction, longwave") if is_ill else
                 "species" if k in cpu.advect_names else "other")
        if ratio >= worst.get(group, (0.0, "", 0.0))[0]:
            worst[group] = (ratio, k, bound)
    return worst


def nudged(state, seed, skip=CATEGORIES):
    """``state`` with every nonzero value of every float32 field but those
    of ``skip`` one ulp up or down (drawn from ``seed``)."""
    import torch
    r = np.random.default_rng(seed)
    out = dict(state)
    for k, a in state.items():
        if a.dtype != torch.float32 or k in skip:
            continue
        up = torch.as_tensor(r.uniform(size=tuple(a.shape)) < 0.5,
                             device=a.device)
        out[k] = torch.where(a != 0, torch.nextafter(a, torch.where(
            up, torch.full_like(a, np.inf), torch.full_like(a, -np.inf))), a)
    return out


def own_spread(cpu, run, seeds=3):
    """The CPU run's own spread: for each field of the CPU model ``cpu``,
    the largest |nudged - cpu| over the field's largest magnitude of the
    models ``run(seed)`` (started from ``nudged`` states) for ``seeds``
    seeds."""
    spread = {k: 0.0 for k in cpu.state}
    for seed in range(seeds):
        other = run(seed)
        for k in cpu.state:
            want = cpu.field(k).astype(np.float64)
            spread[k] = max(spread[k], float(
                np.abs(other.field(k) - want).max()
                / max(float(np.abs(want).max()), 1e-30)))
    return spread


def check_fullphys_cpu_card(ideal_ridge_model, fullphys, label="fullphys",
                            ulp_spread=False):
    """The small full-physics case (of the schemes ``fullphys``) on the
    CPU (the plain versions) and on the card (the kernels): the same
    substeps, every field held by ``hold_card_to_cpu``, with
    ``ulp_spread`` to the larger of its bound and twice the CPU run's own
    spread under a one-ulp nudge of theta and water vapour (SB04's
    saturation revert, ROADMAP section 3); convective rain on both where
    Tiedtke runs; logs the largest ratio of each group."""
    from icar_tpu_torch import constants as C
    cpu = fullphys_small(ideal_ridge_model, fullphys, "cpu")
    card = fullphys_small(ideal_ridge_model, fullphys, "cuda")
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"small {label} case: {card.last_n_substeps} "
                             f"substeps on the card, {cpu.last_n_substeps} "
                             f"on the CPU")
    spread = None
    if ulp_spread:
        nudged = fullphys_small(ideal_ridge_model, fullphys, "cpu",
                                nudge=True)
        spread = {}
        for k in cpu.state:
            want = cpu.field(k).astype(np.float64)
            spread[k] = float(np.abs(nudged.field(k) - want).max()
                              / max(float(np.abs(want).max()), 1e-30))
        wide = {k: round(v, 6) for k, v in spread.items()
                if 2 * v > FULLPHYS_BOUNDS["species" if k in cpu.advect_names
                                           else "other"]}
        log(f"small {label} case: the CPU run's own one-ulp spread passes "
            f"FULLPHYS_BOUNDS in {wide}")
    worst = hold_card_to_cpu(cpu, card, f"small {label} case", spread)
    for m, where in ((cpu, "CPU"), (card, "card")):
        if (fullphys.get("conv") == C.CU_TIEDTKE
                and not m.field("convective_precipitation").max() > 0):
            raise AssertionError(f"small {label} case on the {where}: no "
                                 f"convective rain")
    log(f"small {label} case {FULLPHYS_SMALL['nx']}x{FULLPHYS_SMALL['ny']}x"
        f"{FULLPHYS_SMALL['nz']}, {FULLPHYS_SMALL_INTERVAL:.0f} s: "
        f"{card.last_n_substeps} substeps on the card and the CPU; largest "
        f"|card - CPU| / max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b})" for g, (r, k, b) in worst.items()))


def check_fullphys(ideal_ridge_model, case, fullphys, kernels, step,
                   adv_plain, tp, cases, smi):
    """Phase 9: K1 and K5 on the full-physics ridge's state after one
    interval, the drive of two intervals with its launch counts, the
    stages of one more interval, and the small case on the CPU and the
    card. Returns the figures K1's and K5's table entries add, and the
    drive's (digest, substeps)."""
    import torch
    from icar_tpu_torch.time_paths import INTERVAL, stage_ms
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**case, device="cuda")
    tp.device_tables(step.thompson_params(warm.options),
                     warm.state["pressure"].device)
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"fullphys setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps")
    label = "fullphys state after one interval"
    err1, oerr1, ms1, pms1, shape, _ = k1_on_state(warm, kernels, step,
                                                   adv_plain, label)
    work1 = advect_work(*shape)
    log(f"K1 advect_upwind on the {label}: max_abs_err {oerr1} against the "
        f"kernel-order oracle, {err1:.3e} against the plain version; kernel "
        f"{ms1:.4f} ms, plain {pms1:.4f} ms, bound {bound(*work1)[0]:.4f} ms")
    err5, ms5, pms5, share, work5 = k5_on_state(warm, kernels, step, tp,
                                                cases, label)
    del warm

    model = ideal_ridge_model(**case, device="cuda")
    path = step.path_kernels(model.options)
    launches, digest, steps = drive(
        model, kernels, "fullphys", path, smi,
        fields=tuple(model.advect_names) + (
            "precipitation", "convective_precipitation", "sensible_heat",
            "latent_heat", "skin_temperature", "soil_temperature", "u", "v",
            "w"))
    if not float(model.global_field("convective_precipitation").max()) > 0:
        raise AssertionError("fullphys path: no convective rain")
    stages = stage_ms(model)
    total = sum(stages["stages_ms"].values())
    log(f"fullphys stages of one more interval ({stages['substeps']} "
        f"substeps, wall {stages['wall_ms']:.1f} ms, the stages' events "
        f"{total:.1f} ms), CUDA-event ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages["stages_ms"].items(),
                                              key=lambda kv: -kv[1])))
    check_fullphys_cpu_card(ideal_ridge_model, fullphys)
    b1, by1 = bound(*work1)
    b5, by5 = bound(*work5)
    return {
        "advect_upwind": {
            "launches": launches["advect_upwind"], "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0]},
        "mp_thompson": {
            "launches": launches["mp_thompson"], "max_abs_err": err5,
            "ms": ms5, "plain_ms": pms5, "bound_ms": b5, "bound_by": by5,
            "active_tile_share": share}}, (digest, steps)


def check_linear_table(model):
    """The card's table: built alone once more from the model's terrain
    and options (timed, and equal to the model's bit for bit), and two
    entries of it against the CPU's build of them at full width. Returns
    the build's seconds."""
    import torch
    from icar_tpu_torch.ops import linear_winds as lw
    g, lt = model.geom, model.options.lt
    dz = np.asarray(model.options.domain.dz_levels[:g.nz], np.float32)
    terrain = np.asarray(g.terrain, np.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lut = lw.build_lut(terrain, g.dx, dz, lt, "cuda")[:2]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nbytes = sum(a.numel() * a.element_size() for a in lut)
    for a, b in zip(lut, model._lut):
        if not torch.equal(a, b):
            raise AssertionError("linear ridge: a second build of the table "
                                 "differs from the model's")
    del lut
    E = lt.n_spd_values * lt.n_dir_values * lt.n_nsq_values
    log(f"linear ridge table: {E} entries ({lt.n_spd_values} speeds x "
        f"{lt.n_dir_values} directions x {lt.n_nsq_values} N^2, buffer "
        f"{lt.buffer}), {nbytes / 1e9:.3f} GB float32, built on the card in "
        f"{build_s:.3f} s (equal to the model's bit for bit)")
    s, n = lt.n_spd_values - 1, lt.n_nsq_values // 2
    entries = [(s * lt.n_dir_values + d) * lt.n_nsq_values + n
               for d in LINEAR_TABLE_DIRECTIONS]
    t0 = time.perf_counter()
    (_, cu, cv), = lw.build_lut_chunks(terrain, g.dx, dz, lt, "cpu",
                                       entries=entries)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for i, e in enumerate(entries):
        for card, cpu in ((model._lut[0][e], cu[i]), (model._lut[1][e],
                                                      cv[i])):
            big = float(cpu.abs().max())
            err = float((card.cpu() - cpu).abs().max()) / big
            if not (big > 0.1 and err <= LINEAR_TABLE_BOUND):
                raise AssertionError(f"linear ridge table entry {e}: card "
                                     f"against CPU {err:.3e} of its largest "
                                     f"value {big:.3f}")
            worst = max(worst, err)
    log(f"linear ridge table entries {entries} against the CPU's build "
        f"({cpu_s:.1f} s): max|card - CPU| / max|CPU| {worst:.3e} (bound "
        f"{LINEAR_TABLE_BOUND})")
    return build_s


def check_linear_small(ideal_ridge_model):
    """The small case's winds by each solver of LINEAR_SOLVERS on the CPU
    and on the card, within its bound times the CPU's largest |u|."""
    report = []
    for label, windtype, block, bound in LINEAR_SOLVERS:
        cb = linear_blocking_options if block else linear_small_options
        cpu, card = (ideal_ridge_model(**LINEAR_SMALL, windtype=windtype,
                                       options_cb=cb, device=dev)
                     for dev in ("cpu", "cuda"))
        big = float(np.abs(cpu.field("u")).max())
        err = max(float(np.abs(card.field(k) - cpu.field(k)).max())
                  for k in "uvw") / big
        if not err <= bound:
            raise AssertionError(f"small linear case, {label}: card against "
                                 f"CPU {err:.3e} of the largest wind")
        report.append(f"{label} {err:.3e} ({bound})")
    log("small linear case winds, max|card - CPU| / max|u| per solver "
        "(bound): " + ", ".join(report))


def check_linear(ideal_ridge_model, case, kernels, step, smi):
    """Phase 10: the linear-theory ridge (bench.py --config linear) at
    500x500x20: its table built on the card and held to the CPU's build,
    the small case's wind solvers on the card against the CPU, two
    intervals of a fresh model with a wind update before each (K1 and K2
    once per substep, u off the balance-only ridge's), and the stages of
    one more wind update. Returns the drive's launch counts and its
    (digest, substeps)."""
    import torch
    from icar_tpu_torch.ops import wind as wind_ops
    from icar_tpu_torch.time_paths import wind_stage_ms
    t0 = time.perf_counter()
    model = ideal_ridge_model(**case, device="cuda")
    torch.cuda.synchronize()
    log(f"linear ridge setup at {case['nx']}x{case['ny']}x{case['nz']} (the "
        f"table's build and the first wind solve included): "
        f"{time.perf_counter() - t0:.1f} s")
    check_linear_table(model)
    del model
    check_linear_small(ideal_ridge_model)

    model = ideal_ridge_model(**case, device="cuda")
    path = step.path_kernels(model.options)
    launches, *reference = drive(model, kernels, "linear", path, smi)
    g = model.geom_t
    u_balance = wind_ops.make_winds_grid_relative(
        *model._case_winds, g.sintheta, g.costheta)[0]
    du = float((model.global_field("u") - u_balance).abs().max())
    if not du > 0.1:
        raise AssertionError(f"linear ridge: u within {du} of the "
                             f"balance-only ridge's")
    one = wind_stage_ms(model)
    log(f"linear ridge: u differs from the balance-only ridge's by up to "
        f"{du:.3f} m/s; one more wind update {one['wall_ms']:.3f} ms of "
        f"wall, CUDA-event ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in one["stages_ms"].items()))
    return launches, tuple(reference)


def file_driver(nml, device):
    """A file-driven run of the options file ``nml`` on ``device``, through
    the driver a user builds (core.driver.ICARDriver); returns it after
    its run."""
    from icar_tpu_torch.config import Options
    from icar_tpu_torch.core.driver import ICARDriver
    options = Options.from_namelist(nml)
    options.validate()
    d = ICARDriver(options, device=device)
    d.run()
    return d


def restart_digest(path):
    """The float64 digest (``state_digest``) of every field of a restart
    file, and the fields themselves."""
    import torch
    from icar_tpu_torch.core.state import state_digest
    from icar_tpu_torch.io.netcdf import NCFile
    with NCFile(path) as f:
        fields = {n: f.read(n) for n in f.variables()}
    return state_digest({k: torch.as_tensor(v) for k, v in fields.items()},
                        sorted(fields)), fields


def host_ms(fn, reps=3):
    """Median milliseconds of fn() on the host clock, each call ended by a
    CUDA synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_file_run_small(tmp):
    """The small file-driven case (FILE_SMALL) with each of FILE_PHYSICS
    on the CPU and on the card: the same substeps an interval, the card
    held to the CPU by ``hold_card_to_cpu``."""
    from icar_tpu_torch.forcing.ideal import write_ideal_files
    small = os.path.join(tmp, "small")
    os.makedirs(small)
    init, forcing = write_ideal_files(small, **FILE_SMALL)
    for i, (label, physics) in enumerate(FILE_PHYSICS):
        runs = {}
        for device in ("cpu", "cuda"):
            prefix = os.path.join(small, f"p{i}_{device}_")
            runs[device] = file_driver(write_namelist(
                prefix + "options.nml", init, forcing, prefix, FILE_SMALL_Z,
                physics), device)
        cpu, card = runs["cpu"], runs["cuda"]
        if card.substeps != cpu.substeps:
            raise AssertionError(f"small file run, {label}: substeps "
                                 f"{card.substeps} on the card, "
                                 f"{cpu.substeps} on the CPU")
        worst = hold_card_to_cpu(cpu.model, card.model,
                                 f"small file run, {label}")
        log(f"small file run {FILE_SMALL['nx']}x{FILE_SMALL['ny']}x"
            f"{FILE_SMALL_Z['nz']}, {label}: substeps {card.substeps} on the "
            f"card and the CPU; largest |card - CPU| / max|CPU| per group "
            f"(bound): " + ", ".join(f"{g} {r:.3e} ({k}; {b})"
                                     for g, (r, k, b) in worst.items()))


def check_file_run(kernels, step, smi, tmp):
    """Phase 11: the file-driven run at full width through the command
    line's entry (``core.driver.main``, in this process) with the launch
    counts set to 0 just before it: K3 and K1 once per substep, no other
    kernel; its output (three times, finite, the median of u); a run
    resumed from its 1800 s checkpoint, whose 3600 s checkpoint must equal
    the uninterrupted run's bit for bit; the resumed driver's timers and
    rate, one forcing step's read, regrid and tendencies, the wind solve
    and the dt's read-back timed; then the small case on the CPU and the
    card. Its files are written under ``tmp``, where phase 20 reads them.
    Returns the drive's launch counts and {"init", "forcing", "prefix"}:
    the forcing files and the uninterrupted run's prefix."""
    import torch
    from icar_tpu_torch.core import driver as drv
    from icar_tpu_torch.forcing.ideal import write_ideal_files
    from icar_tpu_torch.io import netcdf as nc
    t0 = time.perf_counter()
    init, forcing = write_ideal_files(tmp, **FILE_RUN)
    log(f"file run: forcing {FILE_RUN['nx'] + 10}x{FILE_RUN['ny'] + 10}"
        f"x{FILE_RUN['nz_lo']}, {FILE_RUN['nt']} steps, written in "
        f"{time.perf_counter() - t0:.1f} s: {os.path.getsize(forcing)} "
        f"bytes, format {nc.file_format(forcing)} (h5py "
        f"{'present' if nc.h5py else 'absent'}: new files are "
        f"{nc.write_format()})")
    prefix = os.path.join(tmp, "run_")
    nml = write_namelist(prefix + "options.nml", init, forcing, prefix,
                         FILE_RUN_Z, dict(mp=2, adv=1))

    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = drv.main([nml])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"file run: main returned {rc}")
    from icar_tpu_torch.config import Options
    options = Options.from_namelist(nml)
    path = step.path_kernels(options, full_forcing=True)
    steps = launches["advect_upwind"]
    for name, n in launches.items():
        want = steps if name in path else 0
        if n != want or steps == 0:
            raise AssertionError(f"file run: {name} launched {n} times "
                                 f"for {steps} substeps, expected "
                                 f"{want}")
    out = prefix + "out_run.nc"
    with nc.NCFile(out) as f:
        times = f.read("model_time")
        fields = {n: f.read(n) for n in f.variables()}
        fmt = f.format
    if list(times) != [0.0, 1800.0, 3600.0]:
        raise AssertionError(f"file run output: model_time {times}")
    for n, a in fields.items():
        if a.shape[0] != 3 or not np.isfinite(a).all():
            raise AssertionError(f"file run output: {n} of shape "
                                 f"{a.shape}, or non-finite")
    u_median = float(np.median(fields["u"][-1]))
    if not FILE_U_MEDIAN[0] < u_median < FILE_U_MEDIAN[1]:
        raise AssertionError(f"file run: median u {u_median} outside "
                             f"{FILE_U_MEDIAN}")
    gp = FILE_RUN_Z["nz"] * FILE_RUN["ny"] * FILE_RUN["nx"]
    log(f"file run {FILE_RUN['nx']}x{FILE_RUN['ny']}x{FILE_RUN_Z['nz']} "
        f"(main, SB04 + upwind, 3600 s): {steps} substeps in {wall:.1f} "
        f"s of wall (set-up, reads, output and restarts included); "
        f"launches {launches}; output {os.path.getsize(out)} bytes, "
        f"format {fmt}, {len(fields)} variables x 3 times; median u "
        f"{u_median:.3f} m/s; restart "
        f"{os.path.getsize(prefix + 'rst_00001800.nc')} bytes")

    # resumed from the 1800 s checkpoint
    rprefix = os.path.join(tmp, "resumed_")
    resumed = file_driver(write_namelist(
        rprefix + "options.nml", init, forcing, rprefix, FILE_RUN_Z,
        dict(mp=2, adv=1), restart_from=prefix + "rst_00001800.nc"),
        "cuda")
    want, want_fields = restart_digest(prefix + "rst_00003600.nc")
    got, got_fields = restart_digest(rprefix + "rst_00003600.nc")
    for n in want_fields:
        if not np.array_equal(got_fields[n], want_fields[n]):
            raise AssertionError(f"file run resumed at 1800 s: {n} at "
                                 f"3600 s differs from the "
                                 f"uninterrupted run's")
    if got != want:
        raise AssertionError("file run resumed: digest differs")
    log("digest file (3600 s): " + json.dumps(
        {k: want[k] for k in DRIVE_FIELDS if k in want}))
    sec = {k: resumed.timers[k].get_time()
           for k in ("init", "input", "physics", "output")}
    n_sub = resumed.substeps[0]
    log(f"file run resumed at 1800 s: 3600 s checkpoint equal to the "
        f"uninterrupted run's bit for bit ({len(want_fields)} fields); "
        f"{n_sub} substeps, {gp * n_sub / sec['physics'] / 1e6:.1f}M "
        f"gp*steps/s over the physics time on {smi}; driver timers s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sec.items()))

    # one forcing step: the host read, then the regrid, wind solve and
    # tendencies on the card; the wind solve alone; the dt read-back
    m = resumed.model
    t0 = time.perf_counter()
    raw = resumed.forcing.read_step(2)
    read_ms = (time.perf_counter() - t0) * 1e3
    tend_ms = host_ms(lambda: resumed.forcing_tendencies(raw))
    target = resumed.regridder.to_model_grid(raw, m.geom_t)
    regrid_ms = host_ms(lambda: resumed.regridder.to_model_grid(
        raw, m.geom_t))
    wind_ms = cuda_ms(lambda: m.compute_winds(target["u"], target["v"],
                                              rotate=True))
    g, o = m.geom_t, m.options.run
    dt_ms = host_ms(lambda: step.sharded_dt(
        [m.state], [g], o.cfl_reduction_factor, o.cfl_strictness), 10)
    log(f"file run forcing step: read {read_ms:.1f} ms (host), regrid "
        f"{regrid_ms:.2f} ms, regrid + wind solve + tendencies "
        f"{tend_ms:.2f} ms, wind solve alone {wind_ms:.3f} ms "
        f"(CUDA events); dt with its read-back {dt_ms:.3f} ms a "
        f"substep")
    del resumed, m, target
    check_file_run_small(tmp)
    return launches, {"init": init, "forcing": forcing, "prefix": prefix}


def fold_work(nz, ny, nx):
    """Bytes and operations of the density fold: rho and the kernel's four
    operands read, the four weighted ones written."""
    n = nz * ny * nx
    faces = nz * ny * (nx - 1) + nz * (ny - 1) * nx + 2 * n
    return 4 * (n + 2 * faces), FOLD_OPS * n


def check_density_kernels(model, kernels, step, adv_plain, mpdata_plain):
    """The fold kernel (``kernels.density_winds`` with the state's
    density) of ``model``'s state against its plain version (every bit),
    both timed; then K1 and K4 on the operands it weights, at the path's
    dt and clamped: K1 against its kernel-order oracle on those operands
    (every bit) and the plain upwind with density (K1_RTOL), K4 at the
    path's order and FCT against the plain MPDATA with density (K4_RTOL);
    each timed with the fold, alone and against its plain version.
    Returns the three kernel-table entries (K1 and K4 with density, the
    fold)."""
    import torch
    s = model.state
    g = model.geom_t
    names = model.advect_names
    adv = model.options.adv
    stack = torch.stack([s[k] for k in names])
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    floors = torch.as_tensor(step.limit_floors(names), device=stack.device)
    rho = s["density"]
    winds = kernels.prepare_advect_winds(s["u"], s["v"], s["w"], g)
    fold = lambda: kernels.density_winds(winds, rho)
    dw = fold()
    torch.cuda.synchronize()
    ferr = max(oracle_err(got, want, f"density_fold kernel vs plain ({op})")
               for got, want, op in zip(
                   (dw.uj, dw.vj, dw.wj, dw.jaco),
                   kernels.fold_plain(winds, rho), ("uj", "vj", "wj",
                                                    "jaco")))
    fms, fpms = cuda_ms(fold), cuda_ms(lambda: kernels.fold_plain(winds, rho))
    nz, ny, nx = rho.shape
    fold_entry = kernel_entry("density_fold", REPLACES["density_fold"], ferr,
                              fms, fpms, fold_work(nz, ny, nx))
    log(f"density_fold: max_abs_err {ferr} against its plain version; "
        f"kernel {fms:.4f} ms, plain {fpms:.4f} ms")
    raw = (stack, s["u"], s["v"], s["w"], dt, g.dx, g.jacobian_u,
           g.jacobian_v, g.jacobian_w, g.jacobian, g.advection_dz)
    out = torch.empty_like(stack)
    order, fct = adv.mpdata_order, adv.flux_corrected_transport
    runs = {
        "advect_upwind_density": (
            lambda w: kernels.advect_upwind(stack, w, dt, floors, True,
                                            out=out),
            lambda: adv_plain.advect_upwind(*raw, floors=floors,
                                            near_end=True, rho=rho,
                                            advect_density=True),
            K1_RTOL, K1_ATOL, 1, False),
        "advect_mpdata_density": (
            lambda w: kernels.advect_mpdata(stack, w, dt, order, fct, floors,
                                            True, out=out),
            lambda: mpdata_plain.advect_mpdata(
                *raw, order=order, use_fct=fct, advect_density=True,
                floors=floors, near_end=True, rho=rho),
            K4_RTOL, K4_ATOL, order, fct)}
    entries = []
    for name, (kernel, plain, rtol, atol, o, fc) in runs.items():
        kernel(dw)
        torch.cuda.synchronize()
        err = assert_close(out, plain(), rtol, atol,
                           f"{name} kernel on density-weighted operands vs "
                           f"plain with density")
        extra = {}
        if name == "advect_upwind_density":
            extra["max_abs_err_vs_oracle"] = oracle_err(
                out, upwind_oracle(stack, dw, dt, floors, True),
                f"{name} kernel vs kernel-order oracle on density-weighted "
                f"operands")
        ms = cuda_ms(lambda: kernel(fold()))
        kms, pms = cuda_ms(lambda: kernel(dw)), cuda_ms(plain)
        nbytes, ops = advect_work(*stack.shape, o, fc)
        log(f"{name}: max_abs_err {err:.3e} against the plain version "
            f"(rtol {rtol}, atol {atol}); fold + kernel {ms:.4f} ms "
            f"(kernel {kms:.4f}, fold {fms:.4f}), plain {pms:.4f} ms")
        entry = kernel_entry(name, REPLACES[name], err, ms, pms,
                             (nbytes + 4 * rho.numel(),
                              ops + FOLD_OPS * rho.numel()))
        entry.update(extra, kernel_ms=kms, fold_ms=fms)
        entries.append(entry)
    return entries + [fold_entry]


def throttle_due(model, step, intervals, interval, update_interval=None):
    """The microphysics calls (or, given ``update_interval``, another
    throttled scheme's) the host's counter (``core.step.Throttle``)
    predicts for ``intervals`` intervals of ``interval`` seconds of
    ``model``: its winds stay put, so each substep but an interval's
    shortened last one takes the CFL dt of its present state, in the
    loop's float32 time."""
    if update_interval is None:
        update_interval = model.options.mp.update_interval
    s, g = model.state, model.geom_t
    dt_static = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                                  model.options.run.cfl_reduction_factor,
                                  model.options.run.cfl_strictness)
    calls = 0
    for _ in range(intervals):
        throttle = step.Throttle(update_interval)
        t, end = np.float32(0.0), np.float32(interval)
        while t < end - np.float32(1e-3):
            dt = min(dt_static, end - t)
            calls += throttle.step(dt) is not None
            t = np.float32(t + dt)
    return calls


def check_general_paths(ideal_ridge_model, cases, ridge_paths, kernels, step,
                        adv_plain, mpdata_plain, tp, smi):
    """Phase 12: the fold kernel, and K1 and K4 on the density-weighted
    operands, on the MPDATA_density ridge after one interval; the five GENERAL_PATHS
    driven over two intervals each with their launch counts (K1 or K4
    once a substep; K3 or K5 once a substep, or under the throttle as
    often as the host's counter predicts) and digests; the density ridge
    sharded on one card against its unsharded drive; the small cases of
    the two column-physics paths on the CPU and the card. Returns (the
    three kernel-table entries, each drive's launch counts)."""
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.time_paths import INTERVAL, INTERVALS
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**cases["MPDATA_density"], device="cuda")
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"MPDATA_density setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps")
    table = check_density_kernels(warm, kernels, step, adv_plain,
                                  mpdata_plain)
    del warm

    launches, refs, paths = {}, {}, {}
    for label in GENERAL_PATHS:
        model = ideal_ridge_model(**cases[label], device="cuda")
        if model.options.physics.microphysics == C.MP_THOMPSON:
            tp.device_tables(step.thompson_params(model.options),
                             model.state["pressure"].device)
        paths[label] = path = step.path_kernels(model.options)
        due = None
        if model.options.mp.update_interval > 0:
            due = {path[0]: throttle_due(model, step, INTERVALS, INTERVAL)}
        launches[label], *refs[label] = drive(
            model, kernels, label, path, smi,
            fields=tuple(model.advect_names) + ("precipitation", "u", "v",
                                                "w"), due=due)
        if due:
            log(f"{label}: {path[0]} launched {due[path[0]]} times in "
                f"{refs[label][1]} substeps, as the host's counter "
                f"predicts; {path[1]} once a substep")
        del model

    label, shape = GENERAL_SHARDED
    sharded = sharded_drive(label, cases[label], one_card_mesh(shape),
                            paths[label], tuple(refs[label]), kernels, smi)
    # SB04 at the small case's rh 1.0 sits on its saturation revert edge:
    # that case is held to twice its own one-ulp spread where it passes
    # FULLPHYS_BOUNDS (tests/test_torch_column_general.py likewise)
    for label in ("fullphys_mpdata", "fullphys_sb04"):
        check_fullphys_cpu_card(ideal_ridge_model, ridge_paths[label], label,
                                ulp_spread=label == "fullphys_sb04")
    table[0]["launches"] = launches["upwind_density"]["advect_upwind"]
    table[1]["launches"] = launches["MPDATA_density"]["advect_mpdata"]
    table[2]["launches"] = launches["upwind_density"]["density_fold"]
    table[2]["general"] = {"launches": {
        label: n["density_fold"] for label, n in launches.items()
        if n["density_fold"]}}
    table[1]["sharded"] = {"mesh": list(shape),
                           "launches": sharded["advect_mpdata"]}
    return table, launches


def rrtmg_noon_options(o):
    """The synthetic RRTMG k-tables and a start at local noon."""
    from icar_tpu_torch.models.icar import synthetic_rrtmg_tables
    synthetic_rrtmg_tables(o)
    o.run.start_date = RRTMG_NOON


def rrtmg_small(ideal_ridge_model, opts, device, seed=None):
    """The small fullphys_rrtmg_noah case at noon, all land, one interval
    on ``device`` with McICA draws made on the CPU (the same on both
    devices); with ``seed``, every nonzero value of every float field
    but CATEGORIES starts one ulp up or down (seeded)."""
    m = ideal_ridge_model(**FULLPHYS_SMALL, **dict(
        opts, options_cb=rrtmg_noon_options), device=device)
    if seed is not None:
        m.state = nudged(m.state, seed)
    m.mcica_cdf = CountingCdf(on="cpu")
    m.advance(FULLPHYS_SMALL_INTERVAL)
    return m


def check_rrtmg_small(ideal_ridge_model, opts):
    """Phase 13 (a): the small case on the CPU and the card, the same
    substeps and RRTMG calls, every field held by ``hold_card_to_cpu`` to
    the larger of FULLPHYS_BOUNDS and twice the CPU run's own spread under
    a one-ulp nudge of its initial state (three seeds: YSU's PBL top and
    the microphysics' thresholds turn rounding into finite changes;
    YSU_LEVEL_FIELDS by the share of cells past it), the shortwave working
    on both."""
    cpu = rrtmg_small(ideal_ridge_model, opts, "cpu")
    card = rrtmg_small(ideal_ridge_model, opts, "cuda")
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"small fullphys_rrtmg_noah case: "
                             f"{card.last_n_substeps} substeps on the card, "
                             f"{cpu.last_n_substeps} on the CPU")
    calls = [m.mcica_cdf.calls() for m in (cpu, card)]
    if calls[0] != calls[1] or calls[0] < 1:
        raise AssertionError(f"small fullphys_rrtmg_noah case: RRTMG calls "
                             f"{calls} (CPU, card)")
    spread = own_spread(cpu, lambda seed: rrtmg_small(
        ideal_ridge_model, opts, "cpu", seed))
    worst = hold_card_to_cpu(cpu, card, "small fullphys_rrtmg_noah case",
                             spread, FULLPHYS_ILL_CONDITIONED
                             + YSU_LEVEL_FIELDS)
    for m, where in ((cpu, "CPU"), (card, "card")):
        if not m.field("shortwave").max() > 0:
            raise AssertionError(f"small fullphys_rrtmg_noah case on the "
                                 f"{where}: no shortwave at noon")
    wide = {k: round(v, 6) for k, v in spread.items()
            if 2 * v > FULLPHYS_BOUNDS["species" if k in cpu.advect_names
                                       else "other"]}
    log(f"small fullphys_rrtmg_noah case {FULLPHYS_SMALL['nx']}x"
        f"{FULLPHYS_SMALL['ny']}x{FULLPHYS_SMALL['nz']} at noon, "
        f"{FULLPHYS_SMALL_INTERVAL:.0f} s: {card.last_n_substeps} substeps "
        f"and {calls[0]} RRTMG call on the card and the CPU; the CPU run's "
        f"own one-ulp spread passes FULLPHYS_BOUNDS in {wide}; largest "
        f"|card - CPU| / max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b:.3e})" for g, (r, k, b) in worst.items()))


def check_rrtmg_chunk(model):
    """Phase 13 (b): one chunk of RRTMG_CHUNK_ROWS rows of ``model``'s
    state through the longwave and the shortwave drivers on the card and
    on the CPU with the same draws (made on the CPU) and the same cloud
    fractions (cal_cldfra3 on the CPU), the sun at RRTMG_CHUNK_COSZ: each
    output within RRTMG_CHUNK_BOUND of the CPU's largest magnitude.
    Returns {output: largest relative difference}."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.physics import cloud_fraction, rrtmg_lw, rrtmg_sw
    from icar_tpu_torch.physics.ghg import ghg_for_options
    rows = slice(0, RRTMG_CHUNK_ROWS)
    s = {k: (v[..., rows, :] if v.dim() >= 2 else v)
         for k, v in model.state.items()}
    dz = model.geom_t.dz_interface[:, rows]
    if s["pressure"][0].numel() > rrtmg_lw.RRTMG_COL_CHUNK:
        raise AssertionError("phase 13 chunk: more columns than one chunk")
    cpu = {k: v.cpu() for k, v in s.items()}
    cf, qc, qi = cloud_fraction.cal_cldfra3(
        cpu["water_vapor"], cpu["cloud_water"], cpu["cloud_ice"],
        cpu["snow_mass"], dz.cpu(), cpu["pressure"], cpu["temperature"],
        cpu["land_mask"], model.geom.dx / 1000.0)
    ghg = ghg_for_options(model.options)
    cosz = torch.full_like(cpu["land_mask"], RRTMG_CHUNK_COSZ)
    outs = {}
    for dev in ("cpu", "cuda"):
        st = {k: v.to(dev) for k, v in cpu.items()}
        lw_t = ps._on_device(rrtmg_lw.get_lw_tables(), dev,
                             rrtmg_lw.device_tables)
        sw_t = ps._on_device(rrtmg_sw.get_sw_tables(), dev,
                             rrtmg_lw.device_tables)
        common = dict(xland=st["land_mask"], ghg=ghg)
        lw = rrtmg_lw.rrtmg_lw_driver(
            lw_t, rrtmg_lw.TorchCdf(on="cpu"), 0.0, st["pressure"],
            st["pressure_interface"], st["temperature"],
            st["temperature_interface"], st["skin_temperature"],
            st["water_vapor"], qc.to(dev), qi.to(dev), st["snow_mass"],
            cf.to(dev), st["re_cloud"], st["re_ice"], st["re_snow"],
            st["density"], dz.to(dev), st["emissivity"], st["exner"],
            **common)
        sw = rrtmg_sw.rrtmg_sw_driver(
            sw_t, rrtmg_lw.TorchCdf(on="cpu"), 0.0, st["pressure"],
            st["pressure_interface"], st["temperature"],
            st["temperature_interface"], cosz.to(dev), st["albedo"],
            st["water_vapor"], qc.to(dev), qi.to(dev), st["snow_mass"],
            cf.to(dev), st["re_cloud"], st["re_ice"], st["re_snow"],
            st["density"], dz.to(dev), st["exner"], **common)
        names = ("lw th_tend", "glw", "olr", "lwcf", "sw th_tend", "swdown",
                 "gsw", "swcf", "swdir")
        outs[dev] = dict(zip(names, [a.cpu().double() for a in lw + sw]))
    worst = {}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        if not torch.isfinite(got).all():
            raise AssertionError(f"RRTMG chunk on the card: non-finite {k}")
        rel = float((got - want).abs().max()
                    / max(float(want.abs().max()), 1e-30))
        if rel > RRTMG_CHUNK_BOUND:
            raise AssertionError(f"RRTMG chunk: {k} differs by {rel:.3e} of "
                                 f"its largest value between the card and "
                                 f"the CPU (bound {RRTMG_CHUNK_BOUND})")
        worst[k] = rel
    if not float(outs["cuda"]["swdown"].max()) > 0:
        raise AssertionError("RRTMG chunk: no shortwave at the surface")
    log(f"RRTMG one chunk ({RRTMG_CHUNK_ROWS}x{s['pressure'].shape[-1]} "
        f"columns, cloud fraction up to {float(cf.max()):.3f}, cosz "
        f"{RRTMG_CHUNK_COSZ}) card against CPU on the same draws: largest "
        f"|card - CPU| / max|CPU| (bound {RRTMG_CHUNK_BOUND}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def check_mcica_draw(nz):
    """Phase 13 (c): the card's own McICA draw (TorchCdf, its generator
    on the card) over one chunk of RRTMG_COL_CHUNK columns and nz layers
    with the cloud fractions RRTMG_DRAW_FRACTIONS (random overlap): each
    layer's cloudy-subcolumn share within RRTMG_DRAW_SIGMAS binomial
    standard deviations of its fraction. Returns the largest deviation in
    standard deviations."""
    import torch
    from icar_tpu_torch.physics import rrtmg_lw
    n, g = rrtmg_lw.RRTMG_COL_CHUNK, rrtmg_lw.NGPTLW
    cf = torch.tensor(RRTMG_DRAW_FRACTIONS[:nz], dtype=torch.float32,
                      device="cuda")
    nl = cf.shape[0]
    draw = rrtmg_lw.TorchCdf()("lw", 0.0, 0, 1, (nl, n, g), "cuda")
    if draw.device.type != "cuda" or float(draw.min()) < 0 \
            or float(draw.max()) >= 1:
        raise AssertionError("the card's McICA draw is not uniform in "
                             "[0, 1) on the card")
    zero = torch.zeros((nl, n), device="cuda")
    cloudy = rrtmg_lw.mcica_subcol(draw, cf[:, None].expand(nl, n), zero,
                                   zero, zero)[0]
    share = cloudy.double().mean(dim=(1, 2)).cpu().numpy()
    p = RRTMG_DRAW_FRACTIONS[:nl]
    sig = np.abs(share - p) / np.sqrt(p * (1 - p) / (n * g))
    if sig.max() > RRTMG_DRAW_SIGMAS:
        raise AssertionError(f"the card's McICA draw: cloudy shares {share} "
                             f"against fractions {p}, {sig.max():.2f} "
                             f"sigmas off")
    log(f"McICA draw on the card ({nl} layers x {n} columns x {g} g-points):"
        f" each layer's cloudy share within {sig.max():.2f} binomial "
        f"sigmas of its fraction (bound {RRTMG_DRAW_SIGMAS})")
    return float(sig.max())


class CountingCdf:
    """A McICA source that counts its draws (the kinds in order) and draws
    as ``physics.rrtmg_lw.TorchCdf``."""

    def __init__(self, on=None):
        from icar_tpu_torch.physics.rrtmg_lw import TorchCdf
        self.draw, self.kinds, self.chunks = TorchCdf(on), [], []

    def __call__(self, kind, t, chunk, n_chunks, shape, device):
        self.kinds.append(kind)
        self.chunks.append(chunk)
        return self.draw(kind, t, chunk, n_chunks, shape, device)

    def calls(self):
        """The RRTMG calls drawn for: the longwave's first chunks."""
        return sum(k == "lw" and c == 0
                   for k, c in zip(self.kinds, self.chunks))


def check_rrtmg(ideal_ridge_model, cases, ridge_paths, kernels, step,
                adv_plain, tp, thompson_cases, smi):
    """Phase 13: RRTMG and YSU (fullphys_rrtmg_noah). On the 500x500x20
    path's state after one interval: K1 against its kernel-order oracle
    and K5 against its plain version (0.0 each), one RRTMG call's peak
    memory and wall, its aten operations per stage (tools/count_ops.py),
    one chunk card against CPU; the card's own McICA draw; two intervals
    of a fresh model (K5 and K1 once a substep, RRTMG as often as the
    host's counter predicts) with its digest; the stages of one more
    interval by CUDA events; the small case card against CPU. Returns the
    K1 and K5 figures for their table entries."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics.rrtmg_lw import RRTMG_COL_CHUNK
    from icar_tpu_torch.time_paths import INTERVAL, INTERVALS, stage_ms
    label = "fullphys_rrtmg_noah"
    case = cases[label]
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**case, device="cuda")
    tp.device_tables(step.thompson_params(warm.options),
                     warm.state["pressure"].device)
    warm.mcica_cdf = CountingCdf()
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"{label} setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps, "
        f"{warm.mcica_cdf.kinds.count('lw')} longwave chunks drawn")
    state_label = f"{label} state after one interval"
    err1, oerr1, ms1, pms1, shape, _ = k1_on_state(warm, kernels, step,
                                                   adv_plain, state_label)
    err5, ms5, pms5, share, work5 = k5_on_state(warm, kernels, step, tp,
                                                thompson_cases, state_label)
    if oerr1 != 0.0 or err5 != 0.0:
        raise AssertionError(f"{label}: K1 {oerr1} against its oracle, K5 "
                             f"{err5} against its plain version")

    # one RRTMG call on that state: peak memory over what the state holds,
    # wall between synchronizes
    g = ps.Statics(warm.geom_t, warm.options)
    s = diagnostic_update(warm.state, warm.geom_t, full=True)
    aux = warm._time_aux()
    dev = s["pressure"].device
    doy = torch.tensor(float(aux["day_of_year0"]), device=dev)
    year = torch.tensor(float(aux["year_length"]), device=dev)
    dt = torch.tensor(25.0, device=dev)
    s = ps.rrtmg_zenith(s, g, doy, year)
    ps.radiation_rrtmg(s, g, warm.options, 0.0, doy, year, dt,
                       CountingCdf())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tw = time.perf_counter()
    ps.radiation_rrtmg(s, g, warm.options, 0.0, doy, year, dt,
                       CountingCdf())
    torch.cuda.synchronize()
    call_s = time.perf_counter() - tw
    peak = torch.cuda.max_memory_allocated() - base
    ny, nx = s["pressure"].shape[1:]
    log(f"{label}: one RRTMG call (longwave and shortwave, "
        f"{-(-ny * nx // RRTMG_COL_CHUNK)} chunks of {RRTMG_COL_CHUNK} "
        f"columns) {call_s:.3f} s of wall, peak memory {peak / 2**30:.3f} "
        f"GiB over the state's")
    ops = count_ops.rrtmg_ops(warm)
    log(f"{label}: aten operations per call at 500x500x20: "
        + json.dumps(ops))
    check_rrtmg_chunk(warm)
    del warm, s
    check_mcica_draw(int(case["nz"]))

    model = ideal_ridge_model(**case, device="cuda")
    model.mcica_cdf = CountingCdf()
    path = step.path_kernels(model.options)
    due = throttle_due(model, step, INTERVALS, INTERVAL,
                       model.options.rad.update_interval_rrtmg)
    launches, _, steps = drive(
        model, kernels, label, path, smi,
        fields=tuple(model.advect_names) + (
            "precipitation", "convective_precipitation", "sensible_heat",
            "latent_heat", "skin_temperature", "tend_th_lwrad",
            "longwave", "out_longwave_rad", "hpbl", "exch_h", "u", "v",
            "w"))
    calls = model.mcica_cdf.calls()
    if calls != due:
        raise AssertionError(f"{label}: {calls} RRTMG calls in {steps} "
                             f"substeps, the host's counter predicts {due}")
    log(f"{label}: RRTMG called {calls} times in {steps} substeps, as the "
        f"host's counter predicts; mp_thompson and advect_upwind once a "
        f"substep")
    stages = stage_ms(model)
    total = sum(stages["stages_ms"].values())
    log(f"{label} stages of one more interval ({stages['substeps']} "
        f"substeps, wall {stages['wall_ms']:.1f} ms, the stages' events "
        f"{total:.1f} ms), CUDA-event ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages["stages_ms"].items(),
                                              key=lambda kv: -kv[1])))
    del model
    check_rrtmg_small(ideal_ridge_model, ridge_paths[label])
    b1, by1 = bound(*advect_work(*shape))
    b5, by5 = bound(*work5)
    return {
        "advect_upwind": {
            "launches": launches["advect_upwind"], "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0]},
        "mp_thompson": {
            "launches": launches["mp_thompson"], "max_abs_err": err5,
            "ms": ms5, "plain_ms": pms5, "bound_ms": b5, "bound_by": by5,
            "active_tile_share": share}}


def noahmp_small(device, seed=None):
    """Phase 14's small case, one interval on ``device`` with McICA draws
    made on the CPU and Noah-MP's calls counted; with ``seed``, every
    nonzero value of every float field but CATEGORIES starts one ulp up
    or down (seeded). Returns (model, Noah-MP calls)."""
    from icar_tpu_torch.physics import noahmp
    m = noahmp_small_model(device)
    if seed is not None:
        m.state = nudged(m.state, seed)
    m.mcica_cdf = CountingCdf(on="cpu")
    with counted_calls(noahmp, "noahmp_driver") as calls:
        m.advance(FULLPHYS_SMALL_INTERVAL)
    return m, len(calls)


class counted_calls:
    """Within the ``with``, each call of ``module.name`` appends to the
    list the ``with`` gives."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def counted(*a, **k):
            self.calls.append(1)
            return self.fn(*a, **k)
        setattr(self.module, self.name, counted)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def check_noahmp_small():
    """Phase 14 (a): the small case (noahmp_small_model: a glacier strip
    and snow of one to three layers) on the CPU and the card, the same
    substeps and RRTMG and Noah-MP calls, every field held by
    ``hold_card_to_cpu`` to the larger of FULLPHYS_BOUNDS and twice the
    CPU run's own spread under a one-ulp nudge of its initial state (three
    seeds), YSU_LEVEL_FIELDS and the snow layer count by the share of
    cells past it; the glacier strip's ground at or below freezing on
    both."""
    cpu, n_cpu = noahmp_small("cpu")
    card, n_card = noahmp_small("cuda")
    label = "small fullphys_rrtmg case"
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"{label}: {card.last_n_substeps} substeps on "
                             f"the card, {cpu.last_n_substeps} on the CPU")
    calls = [m.mcica_cdf.calls() for m in (cpu, card)]
    if calls[0] != calls[1] or calls[0] < 1 or n_cpu != n_card \
            or n_cpu < 1:
        raise AssertionError(f"{label}: RRTMG calls {calls}, Noah-MP calls "
                             f"{[n_cpu, n_card]} (CPU, card)")
    spread = own_spread(cpu, lambda seed: noahmp_small("cpu", seed)[0])
    worst = hold_card_to_cpu(cpu, card, label, spread,
                             FULLPHYS_ILL_CONDITIONED + YSU_LEVEL_FIELDS
                             + ("snow_nlayers",))
    ice = cpu.field("veg_type") == NOAHMP_ICE
    for m, where in ((cpu, "CPU"), (card, "card")):
        if not (m.field("ground_surf_temperature")[ice] <= 273.16).all():
            raise AssertionError(f"{label} on the {where}: glacier ground "
                                 f"above freezing")
    layers = np.unique(card.field("snow_nlayers"))
    log(f"{label} {FULLPHYS_SMALL['nx']}x{FULLPHYS_SMALL['ny']}x"
        f"{FULLPHYS_SMALL['nz']} at noon, {FULLPHYS_SMALL_INTERVAL:.0f} s: "
        f"{card.last_n_substeps} substeps, {calls[0]} RRTMG and {n_cpu} "
        f"Noah-MP calls on the card and the CPU; snow layer counts "
        f"{layers.tolist()}; largest |card - CPU| / max|CPU| per group "
        f"(bound): " + ", ".join(f"{g} {r:.3e} ({k}; {b:.3e})"
                                 for g, (r, k, b) in worst.items()))


def check_noahmp(ideal_ridge_model, cases, kernels, step, adv_plain, tp,
                 thompson_cases, smi):
    """Phase 14: bench.py's fullphys_rrtmg as bench.py builds it (Noah-MP
    and its glacier column, RIDGE_PATHS["fullphys_rrtmg"]). On the
    500x500x20 path's state after one interval: K1 against its
    kernel-order oracle and K5 against its plain version (0.0 each); one
    surface call's wall by CUDA events (Noah-MP's column and the
    glacier's) and the aten operations of one Noah-MP and one glacier call
    (tools/count_ops.py noahmp_ops); two intervals of a fresh model (K5
    and K1 once a substep and nothing else, RRTMG and Noah-MP as often as
    the host's counters predict, convective rain) with its digest; the
    stages of one more interval by CUDA events; the small case card
    against CPU. Returns the K1 and K5 figures for their table entries."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.physics import noahmp
    from icar_tpu_torch.time_paths import (INTERVAL, INTERVALS, StageTimer,
                                           stage_ms)
    label = "fullphys_rrtmg"
    case = cases[label]
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**case, device="cuda")
    tp.device_tables(step.thompson_params(warm.options),
                     warm.state["pressure"].device)
    warm.mcica_cdf = CountingCdf()
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"{label} setup (Noah-MP init on the host) + first interval at "
        f"500x500x20: {time.perf_counter() - t0:.1f} s, "
        f"{warm.last_n_substeps} substeps")
    state_label = f"{label} state after one interval"
    err1, oerr1, ms1, pms1, shape, _ = k1_on_state(warm, kernels, step,
                                                   adv_plain, state_label)
    err5, ms5, pms5, share, work5 = k5_on_state(warm, kernels, step, tp,
                                                thompson_cases, state_label)
    if oerr1 != 0.0 or err5 != 0.0:
        raise AssertionError(f"{label}: K1 {oerr1} against its oracle, K5 "
                             f"{err5} against its plain version")

    # one surface call (lsm_dt 300 s) on that state, after one untimed
    g = ps.Statics(warm.geom_t, warm.options)
    s = diagnostic_update(warm.state, warm.geom_t, full=True)
    doy, year = count_ops._time_scalars(warm)
    lsm_dt = torch.tensor(300.0, device="cuda")
    ps.surface_fluxes(s, g, warm.options, lsm_dt, doy, year)
    timer = StageTimer()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    with timer("surface"):
        ps.surface_fluxes(s, g, warm.options, lsm_dt, doy, year, timer)
    ms = timer.ms()
    call_s = time.perf_counter() - tw
    ops = count_ops.noahmp_ops(warm)
    log(f"{label}: one surface call {1e3 * call_s:.1f} ms of wall; "
        f"CUDA-event ms: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in ms.items())
        + "; aten operations per call: " + json.dumps(ops))
    del warm, s

    model = ideal_ridge_model(**case, device="cuda")
    model.mcica_cdf = CountingCdf()
    path = step.path_kernels(model.options)
    due = throttle_due(model, step, INTERVALS, INTERVAL,
                       model.options.rad.update_interval_rrtmg)
    due_lsm = throttle_due(model, step, INTERVALS, INTERVAL,
                           model.options.lsm.update_interval)
    with counted_calls(noahmp, "noahmp_driver") as nmp_calls:
        launches, _, steps = drive(
            model, kernels, label, path, smi,
            fields=tuple(model.advect_names) + (
                "precipitation", "convective_precipitation",
                "sensible_heat", "latent_heat", "skin_temperature",
                "ground_surf_temperature", "veg_leaf_temperature",
                "soil_temperature", "longwave", "hpbl", "u", "v", "w"))
    calls = model.mcica_cdf.calls()
    if calls != due or len(nmp_calls) != due_lsm:
        raise AssertionError(f"{label}: {calls} RRTMG and {len(nmp_calls)}"
                             f" Noah-MP calls in {steps} substeps, the "
                             f"host's counters predict {due} and {due_lsm}")
    conv = float(model.global_field("convective_precipitation").max())
    if not conv > 0:
        raise AssertionError(f"{label}: no convective rain")
    log(f"{label}: RRTMG called {calls} and Noah-MP {len(nmp_calls)} times "
        f"in {steps} substeps, as the host's counters predict; "
        f"mp_thompson and advect_upwind once a substep; convective rain "
        f"max {conv:.3f} mm")
    stages = stage_ms(model)
    total = sum(v for k, v in stages["stages_ms"].items()
                if k not in ("noahmp", "glacier"))
    log(f"{label} stages of one more interval ({stages['substeps']} "
        f"substeps, wall {stages['wall_ms']:.1f} ms, the stages' events "
        f"{total:.1f} ms; noahmp and glacier within surface), CUDA-event "
        f"ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages["stages_ms"].items(),
                                              key=lambda kv: -kv[1])))
    del model
    check_noahmp_small()
    b1, by1 = bound(*advect_work(*shape))
    b5, by5 = bound(*work5)
    return {
        "advect_upwind": {
            "launches": launches["advect_upwind"], "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0]},
        "mp_thompson": {
            "launches": launches["mp_thompson"], "max_abs_err": err5,
            "ms": ms5, "plain_ms": pms5, "bound_ms": b5, "bound_by": by5,
            "active_tile_share": share}}


def lake_small(device, seed=None):
    """Phase 15's small case (lake_small_model), one LAKE_SMALL_INTERVAL
    on ``device`` with the lake's calls counted; with ``seed``, every
    nonzero value of every float field but CATEGORIES, the lake mask and
    the layer count starts one ulp up or down (seeded). Returns (model,
    lake calls)."""
    from icar_tpu_torch.physics import water_lake
    m = lake_small_model(device)
    if seed is not None:
        m.state = nudged(m.state, seed, LAKE_NOT_NUDGED)
    with counted_calls(water_lake, "lake_driver") as calls:
        m.advance(LAKE_SMALL_INTERVAL)
    return m, len(calls)


def check_lake_small():
    """Phase 15 (b): the small lake case (lake_small_model: cold air, the
    lake strip with snow of one to five layers) on the CPU and the card:
    the same substeps and lake calls, every field held by
    ``hold_card_to_cpu`` to the larger of FULLPHYS_BOUNDS and twice the
    CPU run's own spread under a one-ulp nudge (three seeds), the layer
    count and the ice fraction (LAKE_LEVEL_FIELDS) by the share of cells
    past it; lake ice and snow layers on both, the lake state untouched
    outside the lake."""
    cpu, n_cpu = lake_small("cpu")
    card, n_card = lake_small("cuda")
    label = "small lake case"
    if card.last_n_substeps != cpu.last_n_substeps or n_cpu != n_card \
            or n_cpu < 1:
        raise AssertionError(f"{label}: substeps {card.last_n_substeps} / "
                             f"{cpu.last_n_substeps}, lake calls {n_card} /"
                             f" {n_cpu} (card / CPU)")
    spread = own_spread(cpu, lambda seed: lake_small("cpu", seed)[0])
    worst = hold_card_to_cpu(cpu, card, label, spread,
                             FULLPHYS_ILL_CONDITIONED + LAKE_LEVEL_FIELDS)
    for m, where in ((cpu, "CPU"), (card, "card")):
        lake = m.field("lakemask") > 0.5
        if not (m.field("lake_icefrac3d")[0][lake] > 0).all():
            raise AssertionError(f"{label} on the {where}: no ice on the "
                                 f"lake's top layer")
        if not (m.field("snl2d")[~lake] == 0).all():
            raise AssertionError(f"{label} on the {where}: lake state "
                                 f"outside the lake")
    layers = np.unique(card.field("snl2d")[card.field("lakemask") > 0.5])
    log(f"{label} {LAKE_SMALL['nx']}x{LAKE_SMALL['ny']}x{LAKE_SMALL['nz']}, "
        f"{LAKE_SMALL_INTERVAL:.0f} s: {card.last_n_substeps} substeps, "
        f"{n_cpu} lake calls on the card and the CPU; snow layer counts on "
        f"the lake {sorted(layers.tolist())}; top-layer ice fraction "
        f"{float(card.field('lake_icefrac3d')[0].max()):.3f}; largest "
        f"|card - CPU| / max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b:.3e})" for g, (r, k, b) in worst.items()))


class nudged_after_init:
    """Within the ``with``, a file-driven driver (``core.driver.
    ICARDriver``) set up starts, right after its lake init, from every
    nonzero float32 value of its state but CATEGORIES, the lake mask and
    the layer count one ulp up or down (``seed``)."""

    def __init__(self, seed):
        from icar_tpu_torch.core.driver import ICARDriver
        self.cls, self.seed = ICARDriver, seed
        self.fn = ICARDriver._init_noahmp

    def __enter__(self):
        fn, seed = self.fn, self.seed

        def with_nudge(driver):
            driver.model.state = nudged(driver.model.state, seed,
                                        LAKE_NOT_NUDGED)
            return fn(driver)
        self.cls._init_noahmp = with_nudge
        return self

    def __exit__(self, *exc):
        self.cls._init_noahmp = self.fn
        return False


def check_lake_file(kernels):
    """Phase 15 (c): the small file-driven case with the forcing-only
    options (LAKE_FILE_PHYSICS: radiation=1, lsm=1, the lake on
    LAKE_FILE_BAND, SB04 + upwind, the simple PBL) through
    ``core.driver.main`` on the CPU and on the card, its forcing file with
    the surface fields these options read (add_surface_forcing): K3 and
    K1 launched alike on the card and no other kernel; the output at 0,
    1800 and 3600 s and the 3600 s restart (the lake's fields among its
    own) held card against CPU to the larger of FULLPHYS_BOUNDS and twice
    the CPU run's own spread under a one-ulp nudge of its state after
    set-up (three seeds: the lake's sensible heat carries the float32
    rounding of its column energy), the layer count and the ice fraction
    by the share of cells."""
    import tempfile
    from icar_tpu_torch.core.driver import main as driver_main
    from icar_tpu_torch.forcing.ideal import write_ideal_files
    from icar_tpu_torch.io.netcdf import NCFile
    label = "small file run, the lake and the forcing-only options"
    outs = {}
    with tempfile.TemporaryDirectory() as d:
        init, forcing = write_ideal_files(d, **FILE_SMALL)
        add_surface_forcing(forcing)
        runs = [("cpu", "cpu", None), ("cuda", "cuda", None)] + [
            (f"nudged{seed}", "cpu", seed) for seed in range(3)]
        for run, device, seed in runs:
            prefix = os.path.join(d, f"{run}_")
            nml = write_namelist(prefix + "options.nml", init, forcing,
                                 prefix, FILE_SMALL_Z, LAKE_FILE_PHYSICS,
                                 var_list=LAKE_FILE_VARS)
            kernels.reset_launches()
            with lake_land_use(LAKE_FILE_BAND), (
                    nudged_after_init(seed) if seed is not None
                    else contextlib.nullcontext()):
                code = driver_main([nml, "--device", device])
            if code != 0:
                raise AssertionError(f"{label} on {device}: exit {code}")
            with NCFile(prefix + "out_run.nc") as f_out, \
                    NCFile(prefix + "rst_00003600.nc") as f_rst:
                outs[run] = ({n: f_out.read(n) for n in f_out.variables()},
                             {n: f_rst.read(n) for n in f_rst.variables()},
                             dict(kernels.LAUNCHES))
    card_launches = outs["cuda"][2]
    k3, k1 = card_launches["mp_simple_rho"], card_launches["advect_upwind"]
    others = {k: v for k, v in card_launches.items()
              if k not in ("mp_simple_rho", "advect_upwind") and v}
    if not (k3 == k1 > 0) or others:
        raise AssertionError(f"{label}: launches {card_launches}")
    species = ("potential_temperature", "water_vapor", "cloud_water",
               "rain_mass", "snow_mass")
    worst = {}
    for i, what in enumerate(("output", "restart")):
        cpu, card = outs["cpu"][i], outs["cuda"][i]
        for k, want in cpu.items():
            want = np.asarray(want, np.float64)
            scale = max(float(np.abs(want).max()), 1e-30)
            spread = max(float(np.abs(outs[f"nudged{seed}"][i][k]
                                      - want).max()) / scale
                         for seed in range(3))
            bound_k = max(FULLPHYS_BOUNDS["species" if k in species
                                          else "other"], 2 * spread)
            got = np.asarray(card[k])
            if not np.isfinite(got).all():
                raise AssertionError(f"{label} on the card: non-finite "
                                     f"{what} {k}")
            rel = np.abs(got - want) / scale
            share = FULLPHYS_ILL_SHARE if k in LAKE_LEVEL_FIELDS else 0.0
            if (rel > bound_k).mean() > share:
                raise AssertionError(f"{label}: {what} {k} differs by up "
                                     f"to {float(rel.max()):.3e} of its "
                                     f"largest value between the card and "
                                     f"the CPU (bound {bound_k:.3e})")
            ratio = float(rel.max()) / bound_k
            if k not in LAKE_LEVEL_FIELDS and \
                    ratio >= worst.get(what, (0.0, "", 0.0))[0]:
                worst[what] = (ratio, k, bound_k)
    lake = outs["cpu"][1]["lakemask"] > 0.5
    log(f"{label} {FILE_SMALL['nx']}x{FILE_SMALL['ny']}x{FILE_SMALL_Z['nz']}"
        f" through core.driver.main: {int(lake.sum())} lake cells, K3 and "
        f"K1 {k1} launches each on the card; largest |card - CPU| / "
        f"max|CPU| as a share of its bound: " + ", ".join(
            f"{w} {r:.3f} ({k}; bound {b:.3e})"
            for w, (r, k, b) in worst.items()))


def check_lake(ideal_ridge_model, cases, kernels, step, adv_plain, tp,
               thompson_cases, smi):
    """Phase 15: the CLM lake (water=3) on bench.py's fullphys ridge with
    a lake band (LAKE_BAND, install_lake). On the 500x500x20 path's state
    after one interval: K1 against its kernel-order oracle and K5 against
    its plain version (0.0 each); one surface call's wall by CUDA events
    (the lake's column within) and the aten operations of one lake call
    (tools/count_ops.py lake_ops); two intervals of a fresh model (K5 and
    K1 once a substep and nothing else, the lake as often as the host's
    counter predicts) with its digest and the lake's; the stages of one
    more interval by CUDA events; then the small lake case and the
    file-driven case with the forcing-only options, card against CPU.
    Returns the K1 and K5 figures for their table entries."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    from icar_tpu_torch.core.state import state_digest
    from icar_tpu_torch.physics import water_lake
    from icar_tpu_torch.time_paths import (INTERVAL, INTERVALS, StageTimer,
                                           stage_ms)
    label = "fullphys_lake"
    case = dict(cases["fullphys"], water=C.WATER_LAKE)
    t0 = time.perf_counter()
    warm = install_lake(ideal_ridge_model(**case, device="cuda"), LAKE_BAND)
    tp.device_tables(step.thompson_params(warm.options),
                     warm.state["pressure"].device)
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    n_lake = int(warm.field("lakemask").sum())
    log(f"{label} setup (lake_init on the host, {n_lake} lake cells) + "
        f"first interval at 500x500x20: {time.perf_counter() - t0:.1f} s, "
        f"{warm.last_n_substeps} substeps")
    state_label = f"{label} state after one interval"
    err1, oerr1, ms1, pms1, shape, _ = k1_on_state(warm, kernels, step,
                                                   adv_plain, state_label)
    err5, ms5, pms5, share, work5 = k5_on_state(warm, kernels, step, tp,
                                                thompson_cases, state_label)
    if oerr1 != 0.0 or err5 != 0.0:
        raise AssertionError(f"{label}: K1 {oerr1} against its oracle, K5 "
                             f"{err5} against its plain version")
    log(f"{label}: K1 on the {state_label} 0.0 against its oracle, "
        f"{ms1:.4f} ms (plain {pms1:.4f}); K5 0.0 against its plain "
        f"version, {ms5:.4f} ms (plain {pms5:.4f}), {100 * share:.1f}% of "
        f"tiles active")

    # one surface call (lsm_dt 300 s) on that state, after one untimed
    g = ps.Statics(warm.geom_t, warm.options)
    s = diagnostic_update(warm.state, warm.geom_t, full=True)
    lsm_dt = torch.tensor(300.0, device="cuda")
    ps.surface_fluxes(s, g, warm.options, lsm_dt)
    timer = StageTimer()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    with timer("surface"):
        ps.surface_fluxes(s, g, warm.options, lsm_dt, stage=timer)
    ms = timer.ms()
    call_s = time.perf_counter() - tw
    ops = count_ops.lake_ops(warm)
    log(f"{label}: one surface call {1e3 * call_s:.1f} ms of wall; "
        f"CUDA-event ms: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in ms.items())
        + "; aten operations per call: " + json.dumps(ops))
    del warm, s

    model = install_lake(ideal_ridge_model(**case, device="cuda"), LAKE_BAND)
    path = step.path_kernels(model.options)
    due_lsm = throttle_due(model, step, INTERVALS, INTERVAL,
                           model.options.lsm.update_interval)
    with counted_calls(water_lake, "lake_driver") as lake_calls:
        launches, _, steps = drive(
            model, kernels, label, path, smi,
            fields=tuple(model.advect_names) + (
                "precipitation", "convective_precipitation",
                "sensible_heat", "latent_heat", "skin_temperature",
                "soil_temperature", "t_lake3d", "t_grnd2d",
                "lake_icefrac3d", "u", "v", "w"))
    if len(lake_calls) != due_lsm:
        raise AssertionError(f"{label}: {len(lake_calls)} lake calls in "
                             f"{steps} substeps, the host's counter "
                             f"predicts {due_lsm}")
    conv = float(model.global_field("convective_precipitation").max())
    if not conv > 0:
        raise AssertionError(f"{label}: no convective rain")
    lake_digest = state_digest(
        {k: model.global_field(k) for k in ("t_lake3d", "t_soisno3d",
                                            "lake_icefrac3d", "t_grnd2d")},
        ["t_lake3d", "t_soisno3d", "lake_icefrac3d", "t_grnd2d"])
    log(f"digest {label} lake: " + json.dumps(lake_digest))
    log(f"{label}: the lake called {len(lake_calls)} times in {steps} "
        f"substeps, as the host's counter predicts; mp_thompson and "
        f"advect_upwind once a substep; convective rain max {conv:.3f} mm")
    stages = stage_ms(model)
    total = sum(v for k, v in stages["stages_ms"].items() if k != "lake")
    log(f"{label} stages of one more interval ({stages['substeps']} "
        f"substeps, wall {stages['wall_ms']:.1f} ms, the stages' events "
        f"{total:.1f} ms; lake within surface), CUDA-event ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages["stages_ms"].items(),
                                              key=lambda kv: -kv[1])))
    del model
    check_lake_small()
    check_lake_file(kernels)
    b1, by1 = bound(*advect_work(*shape))
    b5, by5 = bound(*work5)
    return {
        "advect_upwind": {
            "launches": launches["advect_upwind"], "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0]},
        "mp_thompson": {
            "launches": launches["mp_thompson"], "max_abs_err": err5,
            "ms": ms5, "plain_ms": pms5, "bound_ms": b5, "bound_by": by5,
            "active_tile_share": share}}


def mp_small(ideal_ridge_model, opts, device, seed=None, fullphys=False):
    """Phase 16's small case of the options ``opts`` on ``device``: one
    MP_SMALL_INTERVAL interval of the cold ridge MP_SMALL, or with
    ``fullphys`` one FULLPHYS_SMALL_INTERVAL interval of the small
    full-physics case (FULLPHYS_SMALL with its water strip); with
    ``seed``, every nonzero value of every float field but CATEGORIES
    starts one ulp up or down (seeded)."""
    if fullphys:
        m = ideal_ridge_model(**FULLPHYS_SMALL, **opts, device=device)
        land = m.state["land_mask"].clone()
        land[:, :10] = 2.0
        m.state = {**m.state, "land_mask": land}
    else:
        m = ideal_ridge_model(**MP_SMALL, **opts, device=device)
    if seed is not None:
        m.state = nudged(m.state, seed)
    m.advance(FULLPHYS_SMALL_INTERVAL if fullphys else MP_SMALL_INTERVAL)
    return m


def check_mp_small(ideal_ridge_model, label, opts, fullphys=False):
    """Phase 16's small case ``label`` (``mp_small``) on the CPU and the
    card: the same substeps, every field held by ``hold_card_to_cpu`` to
    the larger of FULLPHYS_BOUNDS and twice the CPU run's own spread under
    a one-ulp nudge of its initial state (three seeds); on the cold ridge,
    cloud ice and snow aloft on both (WSM3's one class of each: its cloud
    water and rain mass below 0 C)."""
    cpu = mp_small(ideal_ridge_model, opts, "cpu", fullphys=fullphys)
    card = mp_small(ideal_ridge_model, opts, "cuda", fullphys=fullphys)
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"small {label} case: {card.last_n_substeps} "
                             f"substeps on the card, {cpu.last_n_substeps} "
                             f"on the CPU")
    spread = own_spread(cpu, lambda seed: mp_small(
        ideal_ridge_model, opts, "cpu", seed, fullphys))
    worst = hold_card_to_cpu(cpu, card, f"small {label} case", spread)
    frozen = {}
    for m, where in ((cpu, "CPU"), (card, "card")):
        if fullphys:
            if not m.field("precipitation").max() > 0:
                raise AssertionError(f"small {label} case on the {where}: "
                                     f"no precipitation")
            continue
        cold = m.field("temperature") < 273.15
        ice, snow = (("cloud_water", "rain_mass")
                     if "cloud_ice" not in m.state
                     else ("cloud_ice", "snow_mass"))
        frozen[where] = (float(m.field(ice)[cold].max()),
                         float(m.field(snow)[cold].max()))
        if not min(frozen[where]) > 0:
            raise AssertionError(f"small {label} case on the {where}: no "
                                 f"ice or snow aloft ({frozen[where]})")
    case = FULLPHYS_SMALL if fullphys else MP_SMALL
    log(f"small {label} case {case['nx']}x{case['ny']}x{case['nz']}, "
        f"{FULLPHYS_SMALL_INTERVAL if fullphys else MP_SMALL_INTERVAL:.0f}"
        f" s: {card.last_n_substeps} substeps on the card and the CPU; "
        + (f"ice and snow maxima below 0 C (CPU, card) {frozen}; "
           if frozen else "")
        + "largest |card - CPU| / max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b:.3e})" for g, (r, k, b) in worst.items()))


def plain_mp_call(model, step, mp):
    """One call of the plain scheme ``mp`` with the copies into the stack
    (``core.step.plain_microphysics``) on ``model``'s state at the path's
    dt: (CUDA-event ms, median of 3 on fresh copies of the stack and the
    accumulators; the host's wall of one more call in ms)."""
    import torch
    s, g = model.state, model.geom_t
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    names = model.advect_names
    q0 = torch.stack([s[k] for k in names])
    acc0 = [s.get(k) for k in ("precipitation", "snowfall", "graupel")]
    work = {}

    def setup():
        work["q"] = q0.clone()
        work["acc"] = [None if a is None else a.clone() for a in acc0]

    def run():
        step.plain_microphysics(mp, work["q"], names, s, g.dz_mass, dt,
                                *work["acc"])
    ms = cuda_ms(run, reps=3, setup=setup)
    setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return ms, 1e3 * (time.perf_counter() - t0)


def check_other_mp(ideal_ridge_model, cases, kernels, step, adv_plain,
                   mpdata_plain, smi):
    """Phase 16: WSM3, WSM6 and Morrison on bench.py's ridge (RIDGE_PATHS
    wsm3, wsm6, morrison). For each, on the 500x500x20 path's state after
    one interval: K1 against its kernel-order oracle (0.0) and its plain
    version, one scheme call by CUDA events and the host's clock, its aten
    operations (tools/count_ops.py); on Morrison's, K4 on its 11 species
    against its plain version. Two intervals of a fresh model (K1 once a
    substep and nothing else, the scheme as often as the host's counter
    predicts) with its digest; the stages of one more interval by CUDA
    events. Then the small cases, card against CPU (``check_mp_small``).
    Returns (K1's figures by path, K4's on Morrison's state)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import FULLPHYS
    from icar_tpu_torch.time_paths import INTERVAL, INTERVALS, stage_ms
    k1, k4 = {}, None
    for label in OTHER_MP:
        case = cases[label]
        mp = case["mp"]
        t0 = time.perf_counter()
        warm = ideal_ridge_model(**case, device="cuda")
        warm.advance(INTERVAL)
        torch.cuda.synchronize()
        log(f"{label} setup + first interval at 500x500x20: "
            f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} "
            f"substeps")
        state_label = f"{label} state after one interval"
        err1, oerr1, ms1, pms1, shape, _ = k1_on_state(
            warm, kernels, step, adv_plain, state_label)
        if oerr1 != 0.0:
            raise AssertionError(f"{label}: K1 {oerr1} against its oracle")
        call_ms, call_wall = plain_mp_call(warm, step, mp)
        ops = count_ops.PLAIN_MP_OPS[label](warm)
        log(f"{label}: K1 on its {shape[0]} species 0.0 against its oracle, "
            f"{ms1:.4f} ms (plain {pms1:.4f}); one {step.plain_mp_stage(mp)}"
            f" call {call_ms:.3f} ms by CUDA events, {call_wall:.1f} ms of "
            f"wall; aten operations per call: " + json.dumps(ops))
        if mp == C.MP_MORRISON:
            err4, ms4, pms4, work4 = k4_on_state(warm, kernels, step,
                                                 mpdata_plain)
            b4, by4 = bound(*work4)
            k4 = {"max_abs_err": err4, "ms": ms4, "plain_ms": pms4,
                  "bound_ms": b4, "bound_by": by4, "species": shape[0]}
        del warm

        model = ideal_ridge_model(**case, device="cuda")
        path = step.path_kernels(model.options)
        if path != ("advect_upwind",):
            raise AssertionError(f"{label}: path {path}")
        due = throttle_due(model, step, INTERVALS, INTERVAL)
        module = step.PLAIN_MP[mp]
        fname = "mp_morrison" if mp == C.MP_MORRISON else label
        with counted_calls(module, fname) as calls:
            launches, _, steps = drive(model, kernels, label, path, smi,
                                       fields=tuple(model.state))
        if not len(calls) == due == steps:
            raise AssertionError(f"{label}: {len(calls)} scheme calls in "
                                 f"{steps} substeps, the host's counter "
                                 f"predicts {due}")
        log(f"{label}: {fname} called {len(calls)} times in {steps} "
            f"substeps, as the host's counter predicts; advect_upwind once "
            f"a substep")
        stages = stage_ms(model)
        log(f"{label} stages of one more interval ({stages['substeps']} "
            f"substeps, wall {stages['wall_ms']:.1f} ms), CUDA-event ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                stages["stages_ms"].items(), key=lambda kv: -kv[1])))
        del model
        b1, by1 = bound(*advect_work(*shape))
        k1[label] = {
            "launches": launches["advect_upwind"], "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0],
            "scheme_ms": call_ms, "scheme_wall_ms": call_wall,
            "scheme_ops": ops}
    for label, opts in MP_SMALL_PATHS:
        check_mp_small(ideal_ridge_model, label, opts)
    for label, mp in MP_FULLPHYS:
        check_mp_small(ideal_ridge_model, f"fullphys with {label}",
                       dict(FULLPHYS, mp=mp), fullphys=True)
    return k1, k4


def cu_small(ideal_ridge_model, label, device, seed=None):
    """Phase 17's small case of the path ``label`` on ``device``:
    FULLPHYS_SMALL with its water strip (Kain-Fritsch: CU_SMALL_KF over
    CU_SMALL_KF_INTERVALS intervals), or for ``nsas_ysu`` the small RRTMG
    + YSU case with NSAS in Tiedtke's place (``rrtmg_small``, all land at
    noon); with ``seed``, every nonzero float value one ulp up or down
    (``nudged``)."""
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import FULLPHYS_RRTMG_NOAH, RIDGE_PATHS
    if label == "nsas_ysu":
        return rrtmg_small(ideal_ridge_model, dict(FULLPHYS_RRTMG_NOAH,
                                                   conv=C.CU_NSAS),
                           device, seed)
    kf = label == "fullphys_kf"
    m = ideal_ridge_model(**(CU_SMALL_KF if kf else FULLPHYS_SMALL),
                          **RIDGE_PATHS[label], device=device)
    land = m.state["land_mask"].clone()
    land[:, :10] = 2.0
    m.state = {**m.state, "land_mask": land}
    if seed is not None:
        m.state = nudged(m.state, seed)
    for _ in range(CU_SMALL_KF_INTERVALS if kf else 1):
        m.advance(FULLPHYS_SMALL_INTERVAL)
    if device == "cuda":
        torch.cuda.synchronize()
    return m


def check_cu_small(ideal_ridge_model, label):
    """Phase 17's small case ``label`` (``cu_small``) on the CPU and the
    card: the same substeps; every field held by ``hold_card_to_cpu`` to
    the larger of FULLPHYS_BOUNDS and twice the CPU run's own spread under
    a one-ulp nudge (three seeds; under YSU its level fields by the share
    of cells past it); convective rain in some columns on both, and under
    YSU a PBL height above 0 on both."""
    cpu = cu_small(ideal_ridge_model, label, "cpu")
    card = cu_small(ideal_ridge_model, label, "cuda")
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"small {label} case: {card.last_n_substeps} "
                             f"substeps on the card, {cpu.last_n_substeps} "
                             f"on the CPU")
    spread = own_spread(cpu, lambda seed: cu_small(ideal_ridge_model, label,
                                                   "cpu", seed))
    ill = FULLPHYS_ILL_CONDITIONED + (YSU_LEVEL_FIELDS
                                      if label == "nsas_ysu" else ())
    worst = hold_card_to_cpu(cpu, card, f"small {label} case", spread, ill)
    shares = {}
    for m, where in ((cpu, "CPU"), (card, "card")):
        shares[where] = float((m.field("convective_precipitation")
                               > 0).mean())
        if not shares[where] > 0:
            raise AssertionError(f"small {label} case on the {where}: no "
                                 f"convective rain")
        if label == "nsas_ysu" and not m.field("hpbl").max() > 0:
            raise AssertionError(f"small {label} case on the {where}: no "
                                 f"PBL height for NSAS's shallow scheme")
    extra = ""
    if label == "fullphys_kf":
        extra = (f"NCA running at the end in "
                 f"{100 * float((card.field('kf_nca') > 0).mean()):.1f}% "
                 f"of the card's columns; ")
    grid = CU_SMALL_KF if label == "fullphys_kf" else FULLPHYS_SMALL
    log(f"small {label} case {grid['nx']}x{grid['ny']}x{grid['nz']}: "
        f"{card.last_n_substeps} substeps in its last interval on the card "
        f"and the CPU; columns with convective rain (CPU, card) "
        f"{shares['CPU']:.3f}, {shares['card']:.3f}; {extra}largest "
        f"|card - CPU| / max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b:.3e})" for g, (r, k, b) in worst.items()))


def convection_call(model, step):
    """One convection stage (``core.physics_step.convection``: the
    path's scheme) on ``model``'s state at the path's dt: (CUDA-event ms,
    median of 3; the host's wall of one more call in ms)."""
    import torch
    from icar_tpu_torch.core import physics_step as ps
    from icar_tpu_torch.core.diagnostics import diagnostic_update
    g = model.geom_t
    s = diagnostic_update(model.state, g, full=False, with_w_real=True)
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    dt = torch.tensor(float(dt), device=s["pressure"].device)
    statics = ps.Statics(g, model.options)
    run = lambda: ps.convection(s, statics, model.options, dt)
    ms = cuda_ms(run, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return ms, 1e3 * (time.perf_counter() - t0)


def check_convection(ideal_ridge_model, cases, kernels, step, adv_plain, tp,
                     thompson_cases, smi):
    """Phase 17: Kain-Fritsch, NSAS and BMJ on bench.py's fullphys ridge
    (RIDGE_PATHS fullphys_kf, fullphys_nsas, fullphys_bmj). For each: two
    intervals of a fresh 500x500x20 model (``drive``: K5 and K1 once a
    substep and nothing else, the scheme once a substep) with its digest
    and its scheme's own fields' digest, the share of columns it triggered
    (columns with convective rain in the two intervals; Kain-Fritsch's
    with NCA running after the last call too) and the convective rain's
    total;
    on the state the drive left, K1 against its kernel-order oracle (0.0)
    and its plain version and K5 against its plain version (0.0; its
    active tiles), one convection call by CUDA events and the host's
    clock with its aten operations (tools/count_ops.py), and the stages of
    one more interval by CUDA events. Then the small cases, card against
    CPU (``check_cu_small``). Returns the K1 and K5 figures by path."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch.core.state import state_digest
    from icar_tpu_torch.physics import cu_bmj, cu_kf, cu_nsas
    from icar_tpu_torch.time_paths import stage_ms
    schemes = {"fullphys_kf": (cu_kf, "kfcps"),
               "fullphys_nsas": (cu_nsas, "nsas"),
               "fullphys_bmj": (cu_bmj, "bmj")}
    figures = {}
    for label, conv in CU_PATHS:
        case = cases[label]
        t0 = time.perf_counter()
        model = ideal_ridge_model(**case, device="cuda")
        tp.device_tables(step.thompson_params(model.options),
                         model.state["pressure"].device)
        path = step.path_kernels(model.options)
        if path != ("mp_thompson", "advect_upwind"):
            raise AssertionError(f"{label}: path {path}")
        log(f"{label} setup at 500x500x20: {time.perf_counter() - t0:.1f} s")
        module, fname = schemes[label]
        with counted_calls(module, fname) as calls:
            launches, _, steps = drive(model, kernels, label, path, smi,
                                       fields=tuple(model.state))
        if len(calls) != steps:
            raise AssertionError(f"{label}: {fname} called {len(calls)} "
                                 f"times in {steps} substeps")
        fields = CU_STATE_FIELDS[label]
        log(f"digest {label} scheme: " + json.dumps(state_digest(
            {k: model.global_field(k) for k in fields}, list(fields))))
        conv_rain = model.global_field("convective_precipitation")
        share = float((conv_rain > 0).float().mean())
        nca = (f", with NCA running after the last call "
               f"{float((model.global_field('kf_nca') > 0).float().mean())}"
               if label == "fullphys_kf" else "")
        log(f"{label}: {fname} called once a substep ({steps} calls); "
            f"triggered share (columns with convective rain in two "
            f"intervals) {share}{nca}; convective rain total "
            f"{float(conv_rain.double().sum())!r} mm over "
            f"{conv_rain.numel()} columns, max {float(conv_rain.max())!r} "
            f"mm")
        state_label = f"{label} state after two intervals"
        err1, oerr1, ms1, pms1, shape, _ = k1_on_state(
            model, kernels, step, adv_plain, state_label)
        err5, ms5, pms5, tiles, work5 = k5_on_state(
            model, kernels, step, tp, thompson_cases, state_label)
        if oerr1 != 0.0 or err5 != 0.0:
            raise AssertionError(f"{label}: K1 {oerr1} against its oracle, "
                                 f"K5 {err5} against its plain version")
        log(f"{label}: K1 on the {state_label} 0.0 against its oracle, "
            f"{ms1:.4f} ms (plain {pms1:.4f}); K5 0.0 against its plain "
            f"version, {ms5:.4f} ms (plain {pms5:.4f}), {100 * tiles:.1f}% "
            f"of tiles active")
        call_ms, call_wall = convection_call(model, step)
        ops = count_ops.CONVECTION_OPS[label](model)
        log(f"{label}: one convection call {call_ms:.3f} ms by CUDA "
            f"events, {call_wall:.1f} ms of wall; aten operations per "
            f"call: " + json.dumps(ops))
        stages = stage_ms(model)
        log(f"{label} stages of one more interval ({stages['substeps']} "
            f"substeps, wall {stages['wall_ms']:.1f} ms), CUDA-event ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                stages["stages_ms"].items(), key=lambda kv: -kv[1])))
        del model
        b1, by1 = bound(*advect_work(*shape))
        b5, by5 = bound(*work5)
        figures[label] = {
            "advect_upwind": {
                "launches": launches["advect_upwind"], "max_abs_err": err1,
                "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
                "bound_ms": b1, "bound_by": by1, "species": shape[0]},
            "mp_thompson": {
                "launches": launches["mp_thompson"], "max_abs_err": err5,
                "ms": ms5, "plain_ms": pms5, "bound_ms": b5,
                "bound_by": by5, "active_tile_share": tiles},
            "scheme": {"triggered_share": share, "call_ms": call_ms,
                       "call_wall_ms": call_wall, "ops": ops}}
    for label in ("fullphys_kf", "fullphys_nsas", "fullphys_bmj",
                  "nsas_ysu"):
        check_cu_small(ideal_ridge_model, label)
    return figures


def aer_small(ideal_ridge_model, label, device, seed=None):
    """Phase 18's small case ``label`` on ``device``: "ridge", the
    aerosol-aware ridge AER_SMALL with upwind advection over
    AER_SMALL_INTERVAL; "fullphys_rrtmg", the small RRTMG + YSU + Noah-MP
    case (FULLPHYS_RRTMG on FULLPHYS_SMALL, all land, at noon on the
    synthetic k-tables, McICA draws made on the CPU) with the aware scheme
    over FULLPHYS_SMALL_INTERVAL; with ``seed``, every nonzero value of
    every float field but CATEGORIES one ulp up or down (``nudged``)."""
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import (FULLPHYS_RRTMG,
                                            aerosol_aware_options)
    if label == "ridge":
        m = ideal_ridge_model(**AER_SMALL, mp=C.MP_THOMPSON_AER,
                              options_cb=aerosol_aware_options,
                              device=device)
    else:
        def options(o):
            rrtmg_noon_options(o)
            aerosol_aware_options(o)
        m = ideal_ridge_model(**FULLPHYS_SMALL, **dict(
            FULLPHYS_RRTMG, mp=C.MP_THOMPSON_AER, options_cb=options),
            device=device)
        m.mcica_cdf = CountingCdf(on="cpu")
    if seed is not None:
        m.state = nudged(m.state, seed)
    m.advance(AER_SMALL_INTERVAL if label == "ridge"
              else FULLPHYS_SMALL_INTERVAL)
    if device == "cuda":
        torch.cuda.synchronize()
    return m


def check_aer_small(ideal_ridge_model, label):
    """Phase 18's small case ``label`` (``aer_small``) on the CPU and the
    card: the same substeps (and RRTMG calls), every field held by
    ``hold_card_to_cpu`` to the larger of FULLPHYS_BOUNDS and twice the
    CPU run's own one-ulp spread (three seeds; under YSU its level fields
    by the share of cells past it); droplets and a droplet radius off its
    default on both; on the card K1 once a substep and no other kernel.
    Returns the card run's K1 launches."""
    from icar_tpu_torch.ops import kernels
    cpu = aer_small(ideal_ridge_model, label, "cpu")
    kernels.reset_launches()
    card = aer_small(ideal_ridge_model, label, "cuda")
    launches = dict(kernels.LAUNCHES)
    what = f"small aerosol-aware {label} case"
    if launches != dict(launches, advect_upwind=card.last_n_substeps) \
            or sum(launches.values()) != card.last_n_substeps:
        raise AssertionError(f"{what}: launches {launches} in "
                             f"{card.last_n_substeps} substeps")
    if card.last_n_substeps != cpu.last_n_substeps:
        raise AssertionError(f"{what}: {card.last_n_substeps} substeps on "
                             f"the card, {cpu.last_n_substeps} on the CPU")
    rrtmg = label != "ridge"
    calls = ""
    if rrtmg:
        n = [m.mcica_cdf.calls() for m in (cpu, card)]
        if n[0] != n[1] or n[0] < 1:
            raise AssertionError(f"{what}: RRTMG calls {n} (CPU, card)")
        calls = f" and {n[0]} RRTMG call"
    spread = own_spread(cpu, lambda seed: aer_small(ideal_ridge_model,
                                                    label, "cpu", seed))
    ill = FULLPHYS_ILL_CONDITIONED + (YSU_LEVEL_FIELDS if rrtmg else ())
    worst = hold_card_to_cpu(cpu, card, what, spread, ill)
    for m, where in ((cpu, "CPU"), (card, "card")):
        if not (m.field("cloud_number").max() > 0
                and m.field("re_cloud").max() > 2.49e-6):
            raise AssertionError(f"{what} on the {where}: no droplets or "
                                 f"no droplet radius")
    grid = AER_SMALL if label == "ridge" else FULLPHYS_SMALL
    log(f"{what} {grid['nx']}x{grid['ny']}x{grid['nz']}: "
        f"{card.last_n_substeps} substeps{calls} on the card and the CPU, "
        f"K1 once a substep on the card's twelve species; "
        f"re_cloud max (CPU, card) {float(cpu.field('re_cloud').max())!r}, "
        f"{float(card.field('re_cloud').max())!r} m; largest |card - CPU| "
        f"/ max|CPU| per group (bound): " + ", ".join(
            f"{g} {r:.3e} ({k}; {b:.3e})" for g, (r, k, b) in worst.items()))
    return launches["advect_upwind"]


def aer_call(model, step):
    """One call of the aerosol-aware scheme with the surface flux and the
    copies into the stack (``core.step.thompson_aer_microphysics``) on
    ``model``'s state at the path's dt: (CUDA-event ms, median of 3 on
    fresh copies of the stack and the accumulators; the host's wall of one
    more call in ms)."""
    import torch
    s, g = model.state, model.geom_t
    dt = step.quantized_dt(s["u"], s["v"], s["w"], g.dz_levels, g.dx,
                           model.options.run.cfl_reduction_factor,
                           model.options.run.cfl_strictness)
    names = model.advect_names
    params = step.thompson_params(model.options)
    q0 = torch.stack([s[k] for k in names])
    acc0 = [s[k] for k in ("precipitation", "snowfall", "graupel")]
    work = {}

    def setup():
        work["q"] = q0.clone()
        work["acc"] = [a.clone() for a in acc0]

    def run():
        step.thompson_aer_microphysics(work["q"], names, s, g.dz_mass, dt,
                                       *work["acc"], params)
    ms = cuda_ms(run, reps=3, setup=setup)
    setup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return ms, 1e3 * (time.perf_counter() - t0)


def check_thompson_aer(ideal_ridge_model, cases, kernels, step, adv_plain,
                       mpdata_plain, tp, thompson_cases, thompson_ref, smi):
    """Phase 18: Thompson-aerosol (mp=5) on bench.py's mpdata_thompson
    ridge (RIDGE_PATHS thompson_aer, thompson_aer_aware), two intervals of
    a fresh 500x500x20 model each (``drive``): AER_SUBSTEPS substeps; K5
    and K4 once a substep on thompson_aer, whose digest must equal the
    Thompson ridge's ``thompson_ref`` (its digest, substeps) in every
    field, AER_DIGEST_FIELDS among them (the radii feed nothing on the
    ridge), K5 then 0.0 against its plain version on the state it left;
    K4 alone once a substep on the aware ridge, the scheme once a
    substep, the droplet number above 0 somewhere and nwfa off its
    initial profile, every field finite, then on its state K1 on its
    twelve species against its kernel-order oracle (0.0) and its plain
    version, K4 on them against its plain version, one scheme call by
    CUDA events and the host's clock with its aten operations
    (tools/count_ops.py thompson_aer_ops), the stages of one more interval;
    the aware ridge sharded AER_SHARDS on this card against its unsharded
    digest; the small cases card against CPU (``check_aer_small``).
    Returns the figures of K1, K4 and K5 by path."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import count_ops
    from icar_tpu_torch.core.state import state_digest
    from icar_tpu_torch.time_paths import stage_ms
    t_phase = time.perf_counter()
    figures, refs = {}, {}
    for label in AER_PATHS:
        aware = label == "thompson_aer_aware"
        model = ideal_ridge_model(**cases[label], device="cuda")
        tp.device_tables(step.thompson_params(model.options),
                         model.state["pressure"].device)
        if aware:
            tp.device_tnc_wev(model.state["pressure"].device)
        path = step.path_kernels(model.options)
        want = (("advect_mpdata",) if aware
                else ("mp_thompson", "advect_mpdata"))
        if path != want:
            raise AssertionError(f"{label}: path {path}")
        nwfa0 = model.state["nwfa"].clone() if aware else None
        with counted_calls(step, "thompson_aer_microphysics") as calls:
            launches, digest, steps = drive(
                model, kernels, label, path, smi,
                fields=tuple(model.state))
        refs[label] = (digest, steps)
        if steps != AER_SUBSTEPS or len(calls) != (steps if aware else 0):
            raise AssertionError(f"{label}: {steps} substeps (expected "
                                 f"{AER_SUBSTEPS}), the aerosol-aware "
                                 f"scheme called {len(calls)} times")
        radii = ("re_cloud", "re_ice", "re_snow")
        log(f"digest {label} radii: " + json.dumps(state_digest(
            {k: model.global_field(k) for k in radii}, list(radii))))
        if float(model.global_field("re_cloud").max()) <= 2.49e-6:
            raise AssertionError(f"{label}: the droplet radius stayed at "
                                 f"its default everywhere")
        state_label = f"{label} state after two intervals"
        if not aware:
            ref_digest, ref_steps = thompson_ref
            if (digest, steps) != (ref_digest, ref_steps):
                raise AssertionError(
                    f"{label}: {steps} substeps and digest {digest}; the "
                    f"Thompson ridge (mp=1): {ref_steps}, {ref_digest}")
            log(f"{label}: {steps} substeps and every digest sum equal to "
                f"the Thompson ridge's (mp=1; "
                f"{', '.join(AER_DIGEST_FIELDS)} among them)")
            err5, ms5, pms5, tiles, work5 = k5_on_state(
                model, kernels, step, tp, thompson_cases, state_label)
            if err5 != 0.0:
                raise AssertionError(f"{label}: K5 {err5} against its plain "
                                     f"version")
            b5, by5 = bound(*work5)
            figures["mp_thompson"] = {
                "launches": launches["mp_thompson"], "max_abs_err": err5,
                "ms": ms5, "plain_ms": pms5, "bound_ms": b5,
                "bound_by": by5, "active_tile_share": tiles}
            figures["advect_mpdata_9species"] = {
                "launches": launches["advect_mpdata"]}
            del model
            continue
        nc_max = float(model.global_field("cloud_number").max())
        moved = float((model.state["nwfa"] - nwfa0).abs().max())
        if not (nc_max > 0 and moved > 0):
            raise AssertionError(f"{label}: droplet number max {nc_max}, "
                                 f"nwfa moved by at most {moved}")
        log(f"{label}: thompson_aer_microphysics called once a substep "
            f"({len(calls)} calls); droplet number max {nc_max!r} kg-1; "
            f"nwfa moved off its initial profile by up to {moved!r} kg-1")
        err1, oerr1, ms1, pms1, shape, _ = k1_on_state(
            model, kernels, step, adv_plain, state_label)
        if oerr1 != 0.0:
            raise AssertionError(f"{label}: K1 {oerr1} against its oracle")
        err4, ms4, pms4, work4 = k4_on_state(model, kernels, step,
                                             mpdata_plain)
        call_ms, call_wall = aer_call(model, step)
        ops = count_ops.thompson_aer_ops(model)
        log(f"{label}: K1 on its {shape[0]} species 0.0 against its "
            f"oracle, {ms1:.4f} ms (plain {pms1:.4f}); K4 on them "
            f"{err4:.3e} against its plain version, {ms4:.4f} ms (plain "
            f"{pms4:.4f}); one thompson_aer_microphysics call {call_ms:.3f} "
            f"ms by CUDA events, {call_wall:.1f} ms of wall; aten operations "
            f"per call: " + json.dumps(ops))
        stages = stage_ms(model)
        log(f"{label} stages of one more interval ({stages['substeps']} "
            f"substeps, wall {stages['wall_ms']:.1f} ms), CUDA-event ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                stages["stages_ms"].items(), key=lambda kv: -kv[1])))
        del model
        b1, by1 = bound(*advect_work(*shape))
        b4, by4 = bound(*work4)
        figures["advect_upwind"] = {
            "launches": 0, "max_abs_err": err1,
            "max_abs_err_vs_oracle": oerr1, "ms": ms1, "plain_ms": pms1,
            "bound_ms": b1, "bound_by": by1, "species": shape[0],
            "scheme_ms": call_ms, "scheme_wall_ms": call_wall,
            "scheme_ops": ops}
        figures["advect_mpdata"] = {
            "launches": launches["advect_mpdata"], "max_abs_err": err4,
            "ms": ms4, "plain_ms": pms4, "bound_ms": b4, "bound_by": by4,
            "species": shape[0]}
    label = "thompson_aer_aware"
    sharded_drive(label, cases[label], one_card_mesh(AER_SHARDS),
                  ("advect_mpdata",), refs[label], kernels, smi)
    figures["advect_upwind"]["small_launches"] = {
        small: check_aer_small(ideal_ridge_model, small)
        for small in ("ridge", "fullphys_rrtmg")}
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return figures


# phase 19, bench.py --config conus (bench.py:109-119): the full physics
# column of phase 9 on a mesh over every card. On one card a 1x1 mesh (the
# measured program) and CONUS_SHARDS on this card; the small cases of every
# column option (sharded_small_cases) on SHARDED_SMALL_MESH on this card
# against their unsharded card runs, every bit of every field
CONUS_SHARDS = (2, 2)
SHARDED_SMALL_MESH = (2, 2)


def sharded_small_cases():
    """{name: (grid, options, interval s)}: the small full-physics case
    (FULLPHYS_SMALL; Kain-Fritsch on CU_SMALL_KF, whose cloud needs its 20
    levels) with sets of options that together run every column option:
    conus (bench.py's conus schemes, with boundary forcing of the species
    and a rain fraction), SB04 with MPDATA, Kain-Fritsch with WSM3, NSAS
    with WSM6, YSU and RRTMG (Noah, at noon), BMJ with Morrison and the
    CLM lake, the aerosol-aware Thompson scheme with RRTMG, YSU and
    Noah-MP (its glacier rows and snow). Each interval is four substeps (Kain-Fritsch's two), in which every
    convection scheme rains."""
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.models.icar import FULLPHYS, aerosol_aware_options

    def noon_aware(o):
        rrtmg_noon_options(o)
        aerosol_aware_options(o)
    return {
        "conus": (FULLPHYS_SMALL, FULLPHYS, 60.0),
        "mpdata_sb04": (FULLPHYS_SMALL, dict(
            FULLPHYS, mp=C.MP_SIMPLE, conv=C.CU_NONE, adv=C.ADV_MPDATA),
            60.0),
        "kf_wsm3": (CU_SMALL_KF, dict(FULLPHYS, conv=C.CU_KF,
                                      mp=C.MP_WSM3), 120.0),
        "nsas_wsm6_ysu_rrtmg": (FULLPHYS_SMALL, dict(
            FULLPHYS, conv=C.CU_NSAS, mp=C.MP_WSM6, pbl=C.PBL_YSU,
            rad=C.RA_RRTMG, options_cb=rrtmg_noon_options), 60.0),
        "bmj_morrison_lake": (FULLPHYS_SMALL, dict(
            FULLPHYS, conv=C.CU_BMJ, mp=C.MP_MORRISON,
            water=C.WATER_LAKE), 60.0),
        "aware_noahmp": (FULLPHYS_SMALL, dict(
            FULLPHYS, mp=C.MP_THOMPSON_AER, pbl=C.PBL_YSU, rad=C.RA_RRTMG,
            lsm=C.LSM_NOAHMP, options_cb=noon_aware), 60.0),
    }


def sharded_small_model(name, device, mesh=None, late=False):
    """The small case ``name`` of ``sharded_small_cases`` on ``device``,
    with a v flow of 3 m/s across the shard edges: the lake case with its
    band (columns 4-8), the Noah-MP case with phase 14's glacier rows and
    snow, the others without RRTMG with the water strip; on ``mesh`` when
    given, the conus case's forcing and rain fraction set after
    attach_mesh with ``late``, else before it."""
    import torch
    from icar_tpu_torch import constants as C
    from icar_tpu_torch.forcing.ideal import make_ideal_case
    from icar_tpu_torch.models.icar import (NOAHMP_BENCH_FIELDS,
                                            ideal_ridge_model,
                                            init_noahmp_state)
    grid, opts, _ = sharded_small_cases()[name]
    m = ideal_ridge_model(**grid, **opts, device=device)
    m.set_initial_conditions(make_ideal_case(m.geom, u_profile=9.0,
                                             v_profile=3.0, rh=grid["rh"]))
    s = m.state
    if name == "bmj_morrison_lake":
        install_lake(m, (4, 8))
    elif name == "aware_noahmp":
        veg, swe = noahmp_small_surface(s["veg_type"].cpu().numpy(),
                                        s["swe"].cpu().numpy())
        m.state = {**s, "veg_type": torch.as_tensor(veg, device=device),
                   "swe": torch.as_tensor(swe, device=device)}
        init_noahmp_state(m, dict(NOAHMP_BENCH_FIELDS, **NOAHMP_SNOW_FIELDS))
    elif opts.get("rad") != C.RA_RRTMG:
        land = s["land_mask"].clone()
        land[:, :10] = 2.0
        m.state = {**s, "land_mask": land}
    shape = tuple(s["pressure"].shape)

    def extras():
        if name == "conus":
            r = np.random.default_rng(5)
            m.set_forcing_tendencies({
                "potential_temperature": r.uniform(
                    -1e-4, 1e-4, shape).astype(np.float32),
                "water_vapor": r.uniform(-1e-7, 1e-8, shape).astype(
                    np.float32)})
            m.set_rain_fraction(np.random.default_rng(6).uniform(
                0.5, 1.5, (12,) + shape[1:]).astype(np.float32))
    if mesh is not None and not late:
        extras()
    if mesh is not None:
        m.attach_mesh(mesh)
    if mesh is None or late:
        extras()
    return m


def sharded_small_run(name, device, mesh=None, late=False):
    """``sharded_small_model`` advanced over its case's interval (the
    conus case with the rain fraction's month 2)."""
    m = sharded_small_model(name, device, mesh, late)
    m.advance(sharded_small_cases()[name][2],
              rain_frac_month=2 if name == "conus" else None)
    return m


def bit_mismatches(one, other):
    """The fields of the model ``one``'s state in which ``other`` differs
    in any bit (the sign of zero included)."""
    return [k for k in sorted(one.state)
            if not np.array_equal(one.field(k).view(np.uint32),
                                  other.field(k).view(np.uint32))]


def check_conus(ideal_ridge_model, case, kernels, step, tp, reference, smi):
    """Phase 19: bench.py's conus at 500x500x20 -- the full physics column
    on a 1x1 mesh of this card over two intervals, one at a time, held to
    phase 9's (digest, substeps) ``reference`` after the second, with its
    stages of one more interval; then on CONUS_SHARDS of this card over
    one interval, held to the 1x1 model's first (digest, substeps) (a
    2x2 mesh on one card has four times the column physics' host
    dispatch: one interval keeps the phase inside the script's time);
    with several cards, one shard per card over two intervals against
    ``reference``; each drive with K5 and K1 launched once per shard and
    substep. Then the small cases of every column option on
    SHARDED_SMALL_MESH of this card against their unsharded card runs
    (the same substeps, every bit of every field, each kernel of the path
    once per shard and substep). Returns K1's and K5's figures ("small":
    the small cases' launches)."""
    import torch
    from icar_tpu_torch.parallel.mesh import make_mesh
    from icar_tpu_torch.time_paths import stage_ms
    t_phase = time.perf_counter()
    fields = ("precipitation", "convective_precipitation", "sensible_heat",
              "latent_heat", "skin_temperature", "soil_temperature", "u",
              "v", "w")
    out = {"advect_upwind": {}, "mp_thompson": {}, "small": {}}

    def conus(label, mesh, intervals):
        """(launches, digest, substeps) of each of ``intervals`` drives of
        one interval (or one drive of two intervals with ``intervals``
        None) of a fresh conus model on ``mesh``."""
        t0 = time.perf_counter()
        model = ideal_ridge_model(**case, device="cuda")
        model.attach_mesh(mesh)
        for dev in set(mesh.devices):
            tp.device_tables(step.thompson_params(model.options), dev)
        torch.cuda.synchronize()
        log(f"conus {label} setup: {time.perf_counter() - t0:.1f} s")
        path = step.path_kernels(model.options)
        runs = [drive(model, kernels, f"conus {label}", path, smi,
                      fields=tuple(model.advect_names) + fields,
                      shards=mesh.size, intervals=1 if intervals else 2)
                for _ in range(intervals or 1)]
        if not float(model.global_field(
                "convective_precipitation").max()) > 0:
            raise AssertionError(f"conus {label}: no convective rain")
        return model, runs

    def held(label, got, want, what):
        launches, digest, steps = got
        if (digest, steps) != want:
            raise AssertionError(f"conus {label}: {steps} substeps and "
                                 f"digest {digest}; {what}: {want[1]} "
                                 f"substeps, {want[0]}")
        log(f"conus {label}: {steps} substeps and every digest sum equal "
            f"to {what}'s; K5 and K1 {launches['mp_thompson']} and "
            f"{launches['advect_upwind']} launches = shards x {steps} "
            f"substeps")
        for name in ("advect_upwind", "mp_thompson"):
            out[name][f"launches_{label}"] = launches[name]

    model, (first, second) = conus("1x1", one_card_mesh((1, 1)), 2)
    held("1x1", ({k: n + second[0][k] for k, n in first[0].items()},
                 second[1], first[2] + second[2]),
         reference, "fullphys (phase 9)")
    stages = stage_ms(model)
    total = sum(stages["stages_ms"].values())
    log(f"conus 1x1 stages of one more interval ({stages['substeps']} "
        f"substeps, wall {stages['wall_ms']:.1f} ms, the stages' events "
        f"{total:.1f} ms), CUDA-event ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(stages["stages_ms"].items(),
                                              key=lambda kv: -kv[1])))
    del model
    label = f"{CONUS_SHARDS[0]}x{CONUS_SHARDS[1]}"
    model, (run,) = conus(label, one_card_mesh(CONUS_SHARDS), 1)
    held(label, run, (first[1], first[2]), "conus 1x1's first interval")
    del model
    if torch.cuda.device_count() > 1:
        model, (run,) = conus("cards", make_mesh(case["nx"], case["ny"]),
                              None)
        held("cards", run, reference, "fullphys (phase 9)")
        del model
    else:
        log("conus with one shard per card: not run (1 CUDA device "
            "visible)")
    log(f"conus at full width: {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    my, mx = SHARDED_SMALL_MESH
    for name in sharded_small_cases():
        one = sharded_small_run(name, "cuda")
        path = step.path_kernels(one.options)
        kernels.reset_launches()
        other = sharded_small_run(name, "cuda", one_card_mesh(
            SHARDED_SMALL_MESH), late=True)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        n = one.last_n_substeps
        if other.last_n_substeps != n:
            raise AssertionError(f"small {name} case {my}x{mx}: "
                                 f"{other.last_n_substeps} substeps, "
                                 f"unsharded {n}")
        for k, v in launches.items():
            want = n * my * mx if k in path else 0
            if v != want:
                raise AssertionError(f"small {name} case {my}x{mx}: {k} "
                                     f"launched {v} times, expected {want}")
        bad = bit_mismatches(one, other)
        if bad:
            raise AssertionError(f"small {name} case {my}x{mx} on the "
                                 f"card differs from its unsharded card "
                                 f"run in {bad}")
        for k in one.state:
            if not np.isfinite(one.field(k)).all():
                raise AssertionError(f"small {name} case: non-finite {k}")
        out["small"][name] = {k: v for k, v in launches.items() if v}
        log(f"small {name} case {my}x{mx} on the card: {n} substeps, every "
            f"bit of every field equal to its unsharded card run; launches "
            f"{out['small'][name]}")
    log(f"conus small cases: {time.perf_counter() - t0:.1f} s; phase 19 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# phase 20, Slice G: bench.py --config linear --sharded (the linear ridge
# of phase 10 built on a mesh, bench.py:203-205) on LINEAR_SHARDS of this
# card, and the file hour of phase 11 through the driver on FILE_SHARDS of
# this card with the "sharded" output engine
LINEAR_SHARDS = ((1, 1), (2, 2))
FILE_SHARDS = (2, 2)


def stitch_shard_files(paths, shapes):
    """{name: the whole field} from output files per shard
    (``ShardedOutputWriter``'s), each piece placed at its file's
    ``y_start``, ``x_start``; ``shapes`` the fields' whole shapes."""
    from icar_tpu_torch.io.netcdf import NCFile
    out = {n: np.full(shape, np.nan, np.float32)
           for n, shape in shapes.items()}
    for p in paths:
        with NCFile(p) as f:
            y0 = int(f.read_attr(None, "y_start"))
            x0 = int(f.read_attr(None, "x_start"))
            for n in shapes:
                a = f.read(n)
                out[n][..., y0:y0 + a.shape[-2], x0:x0 + a.shape[-1]] = a
    return out


def check_slice_g(ideal_ridge_model, case, kernels, step, reference,
                  file_run, smi):
    """Phase 20: the linear ridge at 500x500x20 built by
    ``ideal_ridge_model(mesh=...)`` on each of LINEAR_SHARDS of this card,
    two intervals with a wind update before each, held to phase 10's
    (digest, substeps) ``reference``, K1 and K2 once per shard and
    substep, and one more wind update's stages (on a mesh the state's
    gather and scatter lie outside them); then phase 11's file hour from
    its files (``file_run``) on a FILE_SHARDS mesh of this card through
    ``ICARDriver(mesh=...)`` with the "sharded" engine, K3 and K1 once
    per shard and substep: its 3600 s restart equal to phase 11's bit for
    bit, its shard files at 3600 s stitched equal to phase 11's output
    there, and its per-shard restart read into a fresh model on the same
    mesh bit for bit. Returns {"linear": {kernel: {"launches_1x1": n,
    ...}}, "file": {kernel: n}}."""
    import torch
    from icar_tpu_torch.config import Options
    from icar_tpu_torch.core.driver import ICARDriver, load_domain
    from icar_tpu_torch.core.state import restart_names
    from icar_tpu_torch.io import output as out_io
    from icar_tpu_torch.io.netcdf import NCFile
    from icar_tpu_torch.models.icar import ICARModel
    from icar_tpu_torch.time_paths import wind_stage_ms
    t_phase = time.perf_counter()
    out = {"linear": {"advect_upwind": {}, "mp_simple": {}}, "file": {}}
    for shape in LINEAR_SHARDS:
        label = f"{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        model = ideal_ridge_model(**case, mesh=one_card_mesh(shape),
                                  device="cuda")
        torch.cuda.synchronize()
        log(f"linear sharded {label} setup (its table and the first wind "
            f"solve): {time.perf_counter() - t0:.1f} s")
        path = step.path_kernels(model.options)
        launches, digest, steps = drive(
            model, kernels, f"linear sharded {label}", path, smi,
            shards=shape[0] * shape[1])
        if (digest, steps) != reference:
            raise AssertionError(f"linear sharded {label}: {steps} substeps "
                                 f"and digest {digest}; phase 10: "
                                 f"{reference[1]} substeps, {reference[0]}")
        for name in out["linear"]:
            out["linear"][name][f"launches_{label}"] = launches[name]
        one = wind_stage_ms(model)
        stages = one["stages_ms"]
        log(f"linear sharded {label}: {steps} substeps and every digest sum "
            f"equal to phase 10's; K1 and K2 {launches['advect_upwind']} and "
            f"{launches['mp_simple']} launches = shards x {steps} substeps; "
            f"one more wind update {one['wall_ms']:.3f} ms of wall, "
            f"{one['wall_ms'] - sum(stages.values()):.3f} of it outside the "
            f"stages, CUDA-event ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()))
        del model

    # the file hour on a mesh, from phase 11's files
    t0 = time.perf_counter()
    my, mx = FILE_SHARDS
    prefix = os.path.join(os.path.dirname(file_run["prefix"]), "sharded_")
    options = Options.from_namelist(write_namelist(
        prefix + "options.nml", file_run["init"], file_run["forcing"],
        prefix, FILE_RUN_Z, dict(mp=2, adv=1)))
    options.validate()
    options.output.engine = "sharded"
    mesh = one_card_mesh(FILE_SHARDS)
    kernels.reset_launches()
    d = ICARDriver(options, device="cuda", mesh=mesh)
    d.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = sum(d.substeps)
    path = step.path_kernels(options, full_forcing=True)
    for name, n in launches.items():
        want = my * mx * steps if name in path else 0
        if n != want or steps == 0:
            raise AssertionError(f"file run {my}x{mx}: {name} launched {n} "
                                 f"times for {steps} substeps, expected "
                                 f"{want}")
    out["file"] = launches
    ref = file_run["prefix"]
    want, want_fields = restart_digest(ref + "rst_00003600.nc")
    got, got_fields = restart_digest(prefix + "rst_00003600.nc")
    bad = [n for n in want_fields
           if not np.array_equal(got_fields[n].view(np.uint32),
                                 want_fields[n].view(np.uint32))]
    if bad or got != want or sorted(got_fields) != sorted(want_fields):
        raise AssertionError(f"file run {my}x{mx}: the 3600 s restart "
                             f"differs from phase 11's in {bad}")
    with NCFile(ref + "out_run.nc") as f:
        whole = {n: f.read(n)[-1] for n in f.variables()
                 if n != "model_time"}
    paths = sorted(p for p in d.writer.paths if p.endswith("_00003600.nc"))
    if len(paths) != my * mx:
        raise AssertionError(f"file run {my}x{mx}: {len(paths)} shard "
                             f"files at 3600 s")
    stitched = stitch_shard_files(paths, {n: a.shape
                                          for n, a in whole.items()})
    bad = [n for n in whole
           if not np.array_equal(stitched[n].view(np.uint32),
                                 whole[n].view(np.uint32))]
    if bad:
        raise AssertionError(f"file run {my}x{mx}: the stitched shard files "
                             f"differ from phase 11's output in {bad}")
    log(f"file run {my}x{mx} on this card (ICARDriver, sharded engine): "
        f"{d.substeps} substeps in {wall:.1f} s of wall (set-up, reads, "
        f"output and restarts included); launches {launches}; its 3600 s "
        f"restart equal to phase 11's bit for bit ({len(want_fields)} "
        f"fields); {len(paths)} shard files at 3600 s stitched equal to "
        f"phase 11's output ({len(whole)} fields); driver timers s: "
        + ", ".join(f"{k} {d.timers[k].get_time():.3f}"
                    for k in ("init", "input", "physics", "output")))

    # per-shard restarts into a fresh model on the same mesh
    t0 = time.perf_counter()
    rpaths = out_io.write_restart_sharded(prefix + "shard_rst_", d.model,
                                          3600.0)
    fresh = ICARModel(options, *load_domain(options), device="cuda")
    fresh.attach_mesh(mesh)
    if out_io.read_restart_sharded(rpaths, fresh) != 3600.0:
        raise AssertionError("per-shard restart: time not restored")
    names = [n for n in restart_names(options) if n in fresh._held()]
    bad = [n for n in names
           if not torch.equal(fresh.global_field(n).view(torch.int32),
                              d.model.global_field(n).view(torch.int32))]
    if bad:
        raise AssertionError(f"per-shard restart {my}x{mx}: {bad} differ "
                             f"after the round trip")
    log(f"per-shard restart {my}x{mx}: {len(rpaths)} files, "
        f"{sum(os.path.getsize(p) for p in rpaths)} bytes, read into a "
        f"fresh {my}x{mx} model: {len(names)} fields bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    del d, fresh
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase20_alone(ideal_ridge_model, case, kernels, step, smi):
    """Phase 20 after the parts of phases 10 and 11 that it reads: the
    linear ridge's drive (phase 10's (digest, substeps)) and phase 11's
    forcing files and file hour through ``core.driver.main``, none of them
    checked here beyond what ``check_slice_g`` compares with them."""
    import torch
    from icar_tpu_torch.core import driver as drv
    from icar_tpu_torch.forcing.ideal import write_ideal_files
    model = ideal_ridge_model(**case, device="cuda")
    _, *reference = drive(model, kernels, "linear", step.path_kernels(
        model.options), smi)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        init, forcing = write_ideal_files(tmp, **FILE_RUN)
        prefix = os.path.join(tmp, "run_")
        if drv.main([write_namelist(prefix + "options.nml", init, forcing,
                                    prefix, FILE_RUN_Z,
                                    dict(mp=2, adv=1))]) != 0:
            raise AssertionError("file run: main returned non-zero")
        torch.cuda.synchronize()
        check_slice_g(ideal_ridge_model, case, kernels, step,
                      tuple(reference), {"init": init, "forcing": forcing,
                                         "prefix": prefix}, smi)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phase", type=int, choices=(20,),
                        help="run this phase alone, after what it reads of "
                             "the earlier phases")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    smi = device_info()
    sys.path.insert(0, ROOT)
    import torch
    try:
        from icar_tpu_torch.core import step
    except ModuleNotFoundError as e:
        # the script alone, without the repository around it
        raise SystemExit(f"chip_smoke.py: {e}; run it from the root of a "
                         f"checkout of the repository") from e
    from icar_tpu_torch.models.icar import (RIDGE, RIDGE_PATHS,
                                            ideal_ridge_model)
    from icar_tpu_torch.ops import advection as adv_plain
    from icar_tpu_torch.ops import kernels
    from icar_tpu_torch.ops import mpdata as mpdata_plain
    from icar_tpu_torch.parallel import shard_kernels as sk
    from icar_tpu_torch.parallel.mesh import make_mesh
    from icar_tpu_torch.physics import mp_simple as mp_plain
    from icar_tpu_torch.physics import mp_thompson as thompson_plain
    from icar_tpu_torch.physics import thompson_cases
    from icar_tpu_torch.time_paths import INTERVAL
    cases = {label: dict(RIDGE, **opts) for label, opts in RIDGE_PATHS.items()}

    # 0. build the kernels from the checkout's sources
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s ({kernels.BUILD_INFO['path']})")
    log(kernels.BUILD_INFO["log"].strip())
    if args.phase == 20:
        phase20_alone(ideal_ridge_model, cases["linear"], kernels, step, smi)
        log(f"total wall: {time.perf_counter() - t_start:.1f} s")
        return

    # 1. K1 and K2 against their plain versions on a real 500x500x20 state;
    # K2 first on the initial state (no cloud or rain: every tile should
    # skip the fall loops), then at SB04_DEEP levels
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**cases["upwind"], device="cuda")
    k2_initial = sb04_on_state(warm, kernels, step, mp_plain, False,
                               "ridge's initial state")
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps")
    deep_errs = check_sb04_deep(kernels, mp_plain, warm.state["u"].device)
    table = check_kernels(warm, kernels, step, adv_plain, mp_plain,
                          k2_initial, deep_errs[0])
    check_shard_upwind(warm, kernels, step, sk, mp_plain)
    del warm

    # 2. the golden trajectory on the card
    check_golden(ideal_ridge_model)

    # 3. the upwind ridge at full width, counting kernel launches
    model = ideal_ridge_model(**cases["upwind"], device="cuda")
    paths = {"upwind": ("advect_upwind", "mp_simple"),
             "MPDATA": ("mp_simple_rho", "advect_mpdata"),
             "Thompson": ("mp_thompson", "advect_mpdata")}
    launches, *upwind_ref = drive(model, kernels, "upwind", paths["upwind"],
                                  smi)
    del model

    # 4. K4 and K3 against their plain versions on a real MPDATA state
    t0 = time.perf_counter()
    warm = ideal_ridge_model(**cases["MPDATA"], device="cuda")
    warm.advance(INTERVAL)
    torch.cuda.synchronize()
    log(f"MPDATA setup + first interval at 500x500x20: "
        f"{time.perf_counter() - t0:.1f} s, {warm.last_n_substeps} substeps")
    table += check_mpdata_kernels(warm, kernels, step, mpdata_plain,
                                  mp_plain, deep_errs[1])
    padded = check_shard_mpdata_path(warm, kernels, step, sk, mp_plain,
                                     thompson_plain, mpdata_plain, entry=True)
    del warm

    # 5. the MPDATA ridge at full width, counting kernel launches
    model = ideal_ridge_model(**cases["MPDATA"], device="cuda")
    mpdata_launches, *mpdata_ref = drive(model, kernels, "MPDATA",
                                         paths["MPDATA"], smi)
    del model

    # 6. the Thompson ridge at full width, counting kernel launches; its
    # lookup tables are built and uploaded as set-up, before the timed run
    model = ideal_ridge_model(**cases["Thompson"], device="cuda")
    thompson_plain.device_tables(step.thompson_params(model.options),
                                 model.state["pressure"].device)
    # K5 on the fresh initial state (clear air: every tile inert), before
    # the drive, whose launch counts start at 0
    k5_initial = k5_on_state(model, kernels, step, thompson_plain,
                             thompson_cases, "ridge's initial state")
    thompson_launches, *thompson_ref = drive(
        model, kernels, "Thompson", paths["Thompson"], smi,
        fields=tuple(model.advect_names) + ("precipitation", "snowfall",
                                            "graupel", "u", "v", "w"))

    # 7. K4 with 9 species and K5 against their plain versions on the state
    # the drive left
    table += check_mpdata_thompson(model, kernels, step, mpdata_plain)
    table += check_thompson_kernel(model, kernels, step, thompson_plain,
                                   thompson_cases, k5_initial)
    check_shard_mpdata_path(model, kernels, step, sk, mp_plain,
                            thompson_plain, mpdata_plain)
    del model

    # 8. the three ridge paths sharded over one card, each held to its
    # unsharded drive: the same substeps and digest, each kernel of the
    # path launched once per shard and substep
    refs = {"upwind": tuple(upwind_ref), "MPDATA": tuple(mpdata_ref),
            "Thompson": tuple(thompson_ref)}
    sharded = {}
    for label, shape in SHARD_DRIVES:
        sharded[label] = sharded_drive(label, cases[label],
                                       one_card_mesh(shape), paths[label],
                                       refs[label], kernels, smi)
    if torch.cuda.device_count() > 1:
        mesh = make_mesh(RIDGE["nx"], RIDGE["ny"])
        sharded_drive("Thompson", cases["Thompson"], mesh, paths["Thompson"],
                      refs["Thompson"], kernels, smi)
    else:
        log("Thompson ridge with one shard per card: not run (1 CUDA device "
            "visible)")
    padded["launches"] = sharded["MPDATA"]["advect_mpdata"]
    table.append(padded)

    # 9. the full-physics ridge: K1 and K5 on its state, two intervals
    # counting kernel launches, its stages, and the small case on the CPU
    # and the card
    fullphys, fullphys_ref = check_fullphys(
        ideal_ridge_model, cases["fullphys"], RIDGE_PATHS["fullphys"],
        kernels, step, adv_plain, thompson_plain, thompson_cases, smi)
    # 10. the linear-theory ridge: its table on the card against the CPU,
    # the small case's wind solvers on the card against the CPU, two
    # intervals with a wind update before each counting kernel launches
    linear_launches, linear_ref = check_linear(
        ideal_ridge_model, cases["linear"], kernels, step, smi)
    # 11. the file-driven run through the command line's entry at full
    # width, counting kernel launches, resumed from its checkpoint, and the
    # small case on the CPU and the card
    file_tmp = tempfile.TemporaryDirectory()
    file_launches, file_run = check_file_run(kernels, step, smi,
                                             file_tmp.name)
    # 12. the general loop's options: density advection (K1 and K4 on
    # density-weighted operands), the microphysics throttle, the column
    # physics with MPDATA or SB04, each path counting kernel launches
    general_table, general_launches = check_general_paths(
        ideal_ridge_model, cases, RIDGE_PATHS, kernels, step, adv_plain,
        mpdata_plain, thompson_plain, smi)
    # 13. RRTMG and YSU: K1 and K5 on that path's state, one RRTMG call's
    # memory, operations and a chunk card against CPU, the card's McICA
    # draw, two intervals counting kernel launches and RRTMG calls, the
    # stages, and the small case card against CPU
    rrtmg = check_rrtmg(ideal_ridge_model, cases, RIDGE_PATHS, kernels,
                        step, adv_plain, thompson_plain, thompson_cases, smi)
    # 14. bench.py's fullphys_rrtmg with Noah-MP and its glacier column: K1
    # and K5 on that path's state, one surface call's time and operations,
    # two intervals counting kernel launches, RRTMG and Noah-MP calls, the
    # stages, and the small case card against CPU
    noahmp = check_noahmp(ideal_ridge_model, cases, kernels, step,
                          adv_plain, thompson_plain, thompson_cases, smi)
    # 15. the CLM lake on the fullphys ridge with a lake band: K1 and K5 on
    # that path's state, one surface call's time and the lake's
    # operations, two intervals counting kernel launches and lake calls,
    # the stages; the small lake case and the file-driven case with the
    # forcing-only options, card against CPU
    lake = check_lake(ideal_ridge_model, cases, kernels, step, adv_plain,
                      thompson_plain, thompson_cases, smi)
    # 16. WSM3, WSM6 and Morrison on the ridge: K1 on their stacks of 4, 7
    # and 11 species and K4 on Morrison's, one scheme call's time and
    # operations, two intervals counting kernel launches and scheme calls,
    # the stages; the small cases card against CPU
    other_k1, other_k4 = check_other_mp(ideal_ridge_model, cases, kernels,
                                        step, adv_plain, mpdata_plain, smi)
    # 17. Kain-Fritsch, NSAS and BMJ on the fullphys ridge: two intervals
    # counting kernel launches and scheme calls, the triggered share and
    # the convective rain, K1 and K5 on each path's state, one scheme
    # call's time and operations, the stages; the small cases card
    # against CPU
    convection = check_convection(ideal_ridge_model, cases, kernels, step,
                                  adv_plain, thompson_plain, thompson_cases,
                                  smi)
    # 18. Thompson-aerosol (mp=5) on the Thompson ridge: the constant-Nc
    # ridge (K5, K4; the Thompson ridge's digest), the aerosol-aware ridge
    # (K4 on twelve species; K1 on them against its oracle), one scheme
    # call's time and operations, the stages, the aware ridge sharded 2x2;
    # the small cases card against CPU
    aer = check_thompson_aer(ideal_ridge_model, cases, kernels, step,
                             adv_plain, mpdata_plain, thompson_plain,
                             thompson_cases, tuple(thompson_ref), smi)
    # 19. bench.py's conus (the full physics column on a mesh): 1x1 and
    # 2x2 on this card (one shard per card with several), each held to
    # phase 9's digest and substeps, K5 and K1 once per shard and
    # substep, the stages; the small cases of every column option 2x2 on
    # this card against their unsharded card runs
    conus = check_conus(ideal_ridge_model, cases["fullphys"], kernels,
                        step, thompson_plain, fullphys_ref, smi)
    # 20. Slice G: the linear ridge built on a 1x1 and a 2x2 mesh of this
    # card (phase 10's digest), the file hour of phase 11 on a 2x2 mesh
    # through the driver with the sharded output engine (phase 11's
    # restart and output), per-shard restarts; launches once per shard
    # and substep
    slice_g = check_slice_g(ideal_ridge_model, cases["linear"], kernels,
                            step, linear_ref, file_run, smi)
    file_tmp.cleanup()
    for entry in table[:-1]:
        name = entry["name"]
        if name == "mp_thompson":
            entry["launches"] = thompson_launches[name]
        elif name == "advect_mpdata_9species":
            entry["launches"] = thompson_launches["advect_mpdata"]
        elif name in ("mp_simple_rho", "advect_mpdata"):
            entry["launches"] = mpdata_launches[name]
        else:
            entry["launches"] = launches[name]
        if name in ("advect_upwind", "mp_thompson"):
            entry["fullphys"] = fullphys[name]
            entry["conus"] = conus[name]
            entry["fullphys_rrtmg_noah"] = rrtmg[name]
            entry["fullphys_rrtmg"] = noahmp[name]
            entry["fullphys_lake"] = lake[name]
            for label, fig in convection.items():
                entry[label] = fig[name]
        if name == "advect_upwind":
            entry.update(other_k1)
            entry["thompson_aer_aware"] = aer["advect_upwind"]
        if name == "advect_mpdata":
            entry["morrison"] = other_k4
            entry["thompson_aer_aware"] = aer["advect_mpdata"]
        if name == "advect_mpdata_9species":
            entry["thompson_aer"] = aer["advect_mpdata_9species"]
        if name == "mp_thompson":
            entry["thompson_aer"] = aer["mp_thompson"]
        if name in ("advect_upwind", "mp_simple"):
            entry["linear"] = {"launches": linear_launches[name]}
            entry["linear_sharded"] = slice_g["linear"][name]
        if name in ("advect_upwind", "mp_simple_rho"):
            entry["file"] = {"launches": file_launches[name]}
            entry["file_sharded"] = {"launches": slice_g["file"][name]}
        general = {label: n[name] for label, n in general_launches.items()
                   if n.get(name)}
        if general:
            entry["general"] = {"launches": general}
        small = {label: n[name] for label, n in conus["small"].items()
                 if n.get(name)}
        if small:
            entry["sharded_small"] = {"launches": small}
    table += general_table
    log(f"total wall: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (gs_slam_analytica_jacobian_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit code):

1. Card: prints the card's name and power limit (nvidia-smi) and builds
   every CUDA kernel of the port from ``csrc/`` with nvcc (one process per
   source, started together), printing the build time and ptxas report.
2. Kernels vs their plain PyTorch versions on the card, at the shapes the
   paths launch. Forward: the renderer entry workload (50k-Gaussian
   cloud, 1200x680, pair capacity 2^20) and the room map's pyramid levels
   s=4/2/1 (300x170, 600x340, 1200x680) with and without n_touched, and
   at s=2 once more with n_touched under the blend-weight rule; reports
   max |kernel - plain| for color, depth and T, the n_touched mismatch
   count, and kernel times (CUDA events, median of 7 after warm-up; the
   plain version's at s=2 only, where the kernels line reads it).
   Backward (B2): the room map at s=1 planned as polish_frame
   plans it (pad 2) and as the full-resolution trackers plan it (pad 8),
   at s=2 and s=4 as the exact pyramid plans them, and the entry cloud,
   each under two cotangents (the real one of loss_tracking_rgbd against
   frame 1 at the warm-start pose, and a seeded one); reports max
   |kernel - plain| per column over the column's max, dL/dtau through
   each route, and kernel / bound times (the plain version's at s=1 pad
   2 under the loss cotangent only). Then the lab closure: the 15-Gaussian fixture's
   dL/dtau through the CUDA kernels against the port's analytic lab.
3. Main path: builds the 200k-Gaussian room map (seeded), renders the
   ground-truth frames of bench.py's 5-pose trajectory with the port, and
   tracks frames 1..4 with the forward-only pyramid IRLS tracker at the
   bench operating point (levels (4,2,1), level_iters (5,12,2), curv
   flow, final_level 2, match_blur, plan_pad 4, plan reuse 2, H carried,
   constant-acceleration warm start): one warm pass, then TIMED_REPS timed
   passes (min / median / max wall and host CPU time per frame).
   Fails on non-finite output, pair-plan overflow, mean translation error
   above 1 mm, or a kernel that the main path never launched.
   Then, outside the launch count, one more run at the adapted schedule
   bench.py recorded in BENCH_r05.json, which fails unless its mean
   translation error lies within 5% of the JAX tracker's there.
   torch.profiler leaves the process's host about 2x slower for the rest
   of its life, so every profiled pass (host syncs per frame under CUDA
   sync debug mode, then device busy time, idle share and top kernels, a
   table in chiprun_out/) is deferred until after the SLAM paths; the
   BENCH_r05 schedule is read once more after them.
   Then ``main-path-tile16``: the main path's schedule on 16-px plans and
   the 16x16 kernels (TILE16_REPS timed passes), tracking frames rendered
   on them; it fails above TILE16_MAX_ERR_M or if a 32x32 kernel
   launched. Its tracking of the 32x32 frames is reported beside it.
   Then, outside the counts, the schedule at both tile sizes on plans
   re-sorted on the full depth key: the 16x16 tracker fails above 1 mm
   or off the 32x32 one's error by more than TILE16_FULL_KEY_REL.
4. The exact-gradient paths, each with the launch counts from 0:
   ``keyframe-polish`` (the main path's frames, each followed by
   polish_frame at full resolution, as the frontend does on keyframe
   creation), ``exact-pyramid`` (track_frame_pyr at the reference's own
   defaults: curv fd, every iteration exact, no plan or H carried, as
   the frontend runs it when every frame uses all its iterations),
   ``track_frame_gn`` and the Adam ``track_frame`` on frame 1. Outside
   the counts, the two pyramid paths are profiled (deferred) and
   exact-pyramid runs once more with H carried across frames. Each path
   fails on non-finite output, overflow or a kernel it never launched,
   and on its pose error: keyframe-polish above 1 mm mean, exact-pyramid
   above EXACT_MAX_ERR_M (EXACT_H_MAX_ERR_M with H carried),
   track_frame_gn not below its start error, track_frame at 1 mm or
   more.
5. The mapping paths, each with the launch counts from 0: ``mapping``
   (32x32 kernels) and ``mapping-tile16`` (16x16 kernels). The room map
   is rendered at MAP_KF keyframe poses KF_STEP bench steps apart; the
   port's BackEnd, under the Replica base config as a dict (MAP_CONFIG,
   cut by MAP_CUTS), initializes the map on keyframe 0, maps keyframes
   1.. (fed 1 mm / 1 mrad off their poses, each with handle_keyframe over
   the window) and refines colors for MAP_REFINE_ITERS iterations. Each
   prints walls, iterations/s, active Gaussians, densify counts,
   keyframe PSNR and pose error, host syncs per iteration and (deferred)
   one profiled keyframe, its last window mapped once more; each fails on non-finite state, overflow, a window
   loss that did not fall, a kernel of its tile size not launched or one
   of the other launched, and on PSNR and pose-error limits; the two
   fail unless they agree within MAP_T16_PSNR_DB and MAP_T16_ACTIVE_REL.
6. The SLAM paths, each with the launch counts from 0: the port's SLAM
   driver (``SLAM.run`` with the rendering eval and SLAM_REFINE_ITERS of
   color refinement) on the synthetic room at 1216x672, SLAM_FRAMES
   frames rendered on the host before the clock, under SLAM_CONFIG
   (scripts/tpu_slam_run.py's settings over configs/synthetic/test.yaml):
   ``slam`` (single thread, frontend defaults), ``slam-async`` (the
   threaded pipeline), ``slam-bf16`` (kernel_bf16 with two exact
   full-resolution iterations a frame) and ``slam-mxu`` (below). Each
   prints the driver's FPS,
   per-frame track p50/max, keyframes, ATE, keyframe PSNR before and
   after refinement, active Gaussians and overflow, and fails on an ATE
   of 1 cm or more or above its regression limit (SLAM_ATE_REG_M), fewer
   than SLAM_MIN_KF keyframes, overflow, a
   missing run_summary.json or ply (or one that does not reload to the
   map), a frame not tracked or a kernel of its path not launched;
   slam-bf16 also unless its ATE is within SLAM_BF16_ATE_REL of slam's.
7. A ``{"kernels": [...]}`` line (launches summed over the paths), then
   the card's name and power limit, then the last line
   ``{"ok": true, "device": {...}}``.

Phase 2 also holds B3', B3 and B4 (the 16x16 kernels) against their plain
versions at the tracker's and the mapping path's plans,
render(tile16=True) against render(tile16=False), and the bf16 kernels
B1'-bf16, B1-bf16 and B2-bf16 against their plain bf16 versions on the
room's s=2 tracker plan and s=1 exact plan (the f32 kernel's time on the
same plan beside each). Between phases 3 and 4, ``render-bf16``:
render(bf16=True) with n_touched at the five poses, B1-bf16's path (the
trackers' keyframing render stays f32, as in the reference), reported
against the f32 renders. Phase 4 ends with ``main-path-bf16`` and
``exact-pyramid-bf16``: the main path's schedule and the exact pyramid
with kernel_bf16, each followed by its f32 path's passes for the walls,
held to their f32 paths' limits and to BF16_REL of their mean errors in
the same call (exact-pyramid-bf16: at most BF16_REL above).

The mxu slice adds, in phase 2, B1'-mxu and B1-mxu against their plain
versions on the room's s=4/2/1 tracker plans and at s=2 under nt_weight,
B2-mxu and B2-bf16-mxu on the s=1 polish and pad-8 plans (the f32
kernel's time on the same plan beside each; gates MXU_*), the tensor-core
falloff alone on one chunk (mxu-power-tile line), and B5: each of
csrc/abl16.cu's eight variants against its plain version at a small
shape, then scripts/abl16.py's run at its own shape (1216x704, NC=2:
ms, us/chunk, bound, plain ms). After render-bf16, ``render-mxu``
(render(mxu=True) with n_touched at the five poses, against the f32
renders); after exact-pyramid-bf16, ``main-path-mxu``,
``exact-pyramid-mxu`` and ``exact-pyramid-bf16-mxu`` (as the bf16 paths,
with kernel_mxu, the last with kernel_bf16 too: B2-bf16-mxu's path; none
may launch the f32 B1' or B2); and a fourth SLAM run, ``slam-mxu``
(kernel_mxu with two exact full-resolution iterations a frame, the
driver started with viewer_port=0 as ``slam_main.py --viewer 0`` starts
it; a thread fetches /status and one /frame.png over 127.0.0.1 during
the run and decodes the PNG), held to 1 cm and to SLAM_BF16_ATE_REL of
slam's ATE.

The sub-tile slice: B1', B1 and B2 are the kernels of
csrc/tile32_fwd_subtile.cu and csrc/tile32_bwd_subtile.cu (one CTA per
16x16 quarter, a conservative per-warp cull). On every f32 32x32 plan of
phase 2 they are also held to bit-equal images (B2: the same rows from
two launches), beside the cells the new kernels evaluate
(post_cull_cells, tk.subtile_cells) and the tile-walk's. Every
compositing bound charges only the cells the function needs (bound_ms),
with PRs 1-5's walk bound beside it (walk_bound_ms).

The slice after it: B4 is csrc/tile16_bwd_subtile.cu (the same sub-tile
design on a 16x16 tile, no cluster) and B1'-mxu / B1-mxu are
csrc/tile32_fwd_subtile_mxu.cu (the sub-tile layout on the tensor-core
falloff, the block test with a margin for its rounding). Phase 2 holds
each to its gates as before (B4: columns within BWD_COL_TOL, the same
rows from two launches; the mxu kernels: MXU_*) on the mapping plan and
at s=4/2/1 and under nt_weight, each beside the cells it evaluates.

The slice after that: B1'-bf16 / B1-bf16 (C entry composite32_fwd_bf16)
and B3' / B3 (composite16_fwd) are the f32 sub-tile forward's body
(csrc/subtile_fwd.cuh), with the bfloat16 falloff and a cull margin for
its rounding, and on the 16-px plan (csrc/tile16_fwd_subtile.cu). Phase 2
holds their images and n_touched bit for bit to plain at the s=2 tracker
plan and the s=1 pad-2 plan, and on the tracker's 16-px plans, the fresh
plan and the mapping plan, beside the cells each evaluates.

The slice after those: B2-bf16 and B2-mxu (C entries composite32_bwd_bf16
and composite32_bwd_mxu) are B2's sub-tile body (csrc/tile32_bwd_subtile.cu)
with the bfloat16 falloff and its cull margin, and with the tensor-core
falloff, the mxu margin and per-warp survivor power blocks. Phase 2 holds
each, on the plans of its phase and under both cotangents, to its gates
and to the same rows from two launches, beside the cells it evaluates,
counted from the backward walk's own stops (tk.plain_bwd_walk(done_at=
True), equal to the forward's but under mxu). B2-bf16-mxu (C entry
composite32_bwd_bf16_mxu) is the same sub-tile body with the mxu falloff
and the bfloat16 products, held to the same gates. B5 runs one CTA per
16x16 subtile, held to plain at 1e-5.

The last slice adds the port's bench and entry points and the multi-rank
paths, each with its launch counts (``ops/launches.py``; the ranks'
counts are read in each rank and summed): ``bench``, after
bench-r05-schedule, runs ``python -m gs_slam_analytica_jacobian_tpu_torch.bench``
at its defaults in a process of its own (its JSON line printed; its mean
error within R05_ERR_REL of the JAX record, ground-truth overflow 0, the
adapted level_iters / level_caps present, no TPU figure; its ms/frame
beside bench-r05-schedule's in the same call); ``entry`` calls
graft_entry.entry()'s ``fn(*args)`` (shapes, finite, B1 launched, the
same scene's plan without overflow; B1 on that plan is held against the
plain version in the kernel case entry_cloud50k). After the
mapping paths, ``multichip`` runs graft_entry.dryrun_multichip on
MULTICHIP_RANKS ranks sharing the card (gloo; its gates, and B1' and B2
launched on every rank); ``mapping-mesh2`` runs the backend of the
mapping path on MESH_RANKS ranks over its keyframes, without color
refinement (finite, no overflow, the window loss falling, the path's
kernels launched on every rank, the ranks' final states equal, PSNR
within MESH_PSNR_DB and active Gaussians within MESH_ACTIVE_REL of the
mapping path's before its refinement); ``slab-mesh2`` renders the room
map in MESH_RANKS depth slabs with its mapping-loss gradients (tiled),
against the one-rank render and gradients (SLAB_*). The ranks of
mapping-mesh2 run with GS_SLAM_NAN_CHECK=1 (the backend's finiteness
check after every batch and densify / prune; each rank must run some).
After the mapping path, ``depth_reg`` renders its last keyframe's depth
from the final map (B1') and holds losses.depth_reg on the card against
the same tensors' on the CPU (DEPTH_REG_RTOL). The kernels line takes
each row's source= and replaces= from ops/launches.py PALLAS_SITES.

P1, the fused preprocess (csrc/preprocess.cu, ops/preprocess_fused.py),
which every render and plan build of the paths starts from: phase 2's
``preprocess`` part prints the torch, CUDA and cuBLAS versions, then runs
preprocess_fwd and preprocess_bwd (a seeded tau, screen-space offset and
table gradient, the active mask) on the room map at the main path's
capacity and camera, and at PREP_CAPACITIES (tum-map's map, 2^16 to 2^19
slots at 640x480), against preprocess_plain and preprocess_bwd_plain:
every float field and per-Gaussian gradient bit for bit (torch.equal),
integer flips within PREP_FLIP_FRAC of the rows, dL/dtau within
PREP_TAU_REL and the same from two launches. At the main path's capacity,
2^16 and 2^18 it times each call (wall among PREP_CALLS issued back to
back) beside the eager version's, and the deferred profiled pass reads
their device times. Both counters are in ops/launches.py COUNTERS: the
main path must launch the forward, the exact-gradient and mapping paths
both; the kernels line has a row for each (device ms, wall, plain, bound of
PREP_FWD_BYTES / PREP_BWD_BYTES a slot, by capacity).

P2, the pair gather (csrc/pair_gather.cu, ops/pair_gather.py), which every
render gathers through and every differentiated render sums back through:
phase 2's ``pair_gather`` part builds the main path's plan (the room map
at 1200x680, PAIR_CAP pairs) and its s=2 and s=4 levels, then tum-map's
mapping plan (PG_PAIR_CAP pairs at 640x480) over the room map in
PG_CAPACITIES slots, and holds pair_gather_fwd equal to
pair_gather_plain, segment_reduce_fwd within PG_BWD_REL of the float64
segment sum (the plain chain's own gap reported beside it), exact on
integer touch counts and the same from two launches; it times each call
but the levels' and its plain version, and the deferred profiled pass
reads their device times. Both counters are in ops/launches.py COUNTERS:
the main path and the mapping paths must launch both; the kernels line
has a row for each (the main path's plan, the others by case).
A failed gate is printed and the run
goes on; it exits non-zero before the result lines if any gate failed.
Without CUDA it exits non-zero before printing any result.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gs_slam_analytica_jacobian_tpu_torch import bench, graft_entry  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.bench import ca_start, cv_start  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.device import card_line  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch import jacobian_test as lab  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import _build  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import camera_math as cm  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import launches as path_launches  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import losses  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import pair_gather as pg  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import preprocess_fused as pf  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel16 as tk16  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as tk  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.lie import se3_exp  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.parallel import sharding, slab  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (  # noqa: E402
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_cloud, make_room_map  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.scripts import abl16  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import (  # noqa: E402
    make_render_plan, render)

W, H = 1200, 680
FX = FY = 600.0
N_ROOM = 200_000
N_CLOUD = 50_000
PAIR_CAP = 1 << 20
FRAMES = 5
# timed passes of the main path, keyframe-polish and the BENCH_r05
# schedule: 5 since PR 4 (8 before), for the SLAM paths' time
TIMED_REPS = 5

# The JAX tracker's mean translation error at the BENCH_r05 schedule
# (BENCH_r05.json) on this room map and trajectory. The port's run of that
# schedule must land within R05_ERR_REL of it: the two trackers compute
# the same function, so only reduction order separates them.
R05_JAX_ERR_MEAN_M = 0.746e-3
R05_ERR_REL = 0.05

# Bound model for the compositing kernel: the work the function needs
# on this run's data, whatever cells a design walks. Memory: every live
# pair row (the tiles' runs) read once (64 B), the 5-plane image written
# once, and with n_touched one f32 per live pair written. Arithmetic,
# counted from csrc/tile32_fwd_subtile.cu: a (pair, pixel) cell that
# passes the skip tests while its pixel is not done (counted by the plain
# version: the included cells and each pixel's terminating one) needs the
# falloff and the tests, ~25 FP32 operations (deltas 2, quadratic form 9,
# rect and skip tests 7, exp ~4, the opacity product, the 0.99 cap and
# the 1/255 test 3), and 13 more (T_incl 2, the 1e-4 test 1, the weight
# 1, four multiply-adds 8, the n_touched test 1): 38. Cells that fail the
# tests are skipped work a design may avoid, so they are not charged.
# walk_bound_ms, reported beside it, is the bound PRs 1-5 stated: every
# cell of the 32x32 tile-walk charged 25 and every walked pair row read.
# Peaks: 3.35 TB/s HBM and 67 TFLOP/s FP32 (H100 SXM data sheet,
# non-tensor FP32, at the full 700 W power limit).
OPS_PER_WALKED_CELL = 25.0
OPS_PER_PASSED_CELL = 13.0
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Bound model for the backward kernel (B2), likewise the work needed.
# Memory: every live pair row read once (64 B) and every pair row of
# dfeat written once (64 B), the ten (H, W) planes (forward color 3,
# depth, T; cotangents 3, depth, T) read once. Arithmetic, counted from
# csrc/tile32_bwd_subtile.cu: a cell whose pixel includes the pair
# (counted by the plain version on this run's data) recomputes the
# forward's falloff and tests (25, as above), steps the transmittance
# (T_incl 2, the 1e-4 test 1), evaluates the gradient, 46 (w 1, A 7,
# prefix 2, 1/(1-alpha) 3, dL/dalpha 4, G 2, dL/dG 1, G dx and G dy 2,
# dG/ddx and dG/ddy 8, the five quadratic-form terms 11, d_opa 1, w dC
# and w dD 4), and adds its ten row values into the pair's sums, 10: 84.
# walk_bound_ms: PRs 1-5's bound (25 a cell of the 32x32 tile-walk, 59
# more an included one, walked pair rows read).
OPS_PER_WALKED_CELL_BWD = 25.0
OPS_PER_INCLUDED_CELL_BWD = 59.0

# Tolerances. The kernel is built without multiply-add contraction and
# composites pair by pair like its plain version, so the two agree bit
# for bit wherever their expf does; an ulp of expf difference can still
# move a pixel across the alpha >= 1/255, T < 1e-4 or T > 0.5 thresholds,
# so at most 1e-4 of the live pairs may differ in n_touched, and images
# must agree to 1e-4 absolute.
IMG_TOL = 1e-4
NT_MISMATCH_FRAC = 1e-4
# B2 walks each pixel with the plain version's exact arithmetic; only the
# order in which a row is summed over the tile's 1024 pixels differs
# (warp butterflies, then 32 warp partials in order, against torch's sum).
# Each of the ten columns must agree to BWD_COL_TOL of the column's max
# |value|, and dL/dtau through the two routes to BWD_DTAU_TOL relative.
# Measured on the H100 over every case below in two runs: at most 2.9e-7
# per column and 4.1e-6 on dL/dtau (whose route back through preprocess
# also sums with atomics), so the limits are tightened from the 1e-4 and
# 1e-3 first set to 1e-5 and 1e-4.
BWD_COL_TOL = 1e-5
BWD_DTAU_TOL = 1e-4
# the lab closure's gate (tests/test_tpu_kernels.py:280): the renderer
# carries the 1/255, 0.99 and T < 1e-4 quantization the lab's
# compositing has not
LAB_MAX_REL = 0.05
LAB_MIN_COS = 0.999
EXACT_REPS = 3      # timed passes of the exact-pyramid path
# Regression limits for the exact-pyramid runs, not accuracy targets: at
# these all-exact defaults the JAX tracker itself stays above 1 mm
# (tests/test_torch_tracking.py::test_exact_pyramid_room_parity_midsize:
# on a mid-size copy of this map the port lands on the JAX pose frame by
# frame, without and with H carried, both above 1 mm). Each limit is
# about 1.25 times the port's reading on the H100 (1.86 mm without H,
# 2.37 mm with H carried).
EXACT_MAX_ERR_M = 2.3e-3
EXACT_H_MAX_ERR_M = 3.0e-3
# The Adam tracker's limit (the repo's 1 mm accuracy gate); it depends on
# B2's gradient at every one of its 100 iterations.
ADAM_MAX_ERR_M = 1e-3
# The main path's schedule once more on 16-px plans and the 16x16
# kernels: timed passes, and a regression limit on its mean translation
# error, not an accuracy target. On the H100 (NVIDIA H100 80GB HBM3,
# 700.00 W) it read 1.573 mm against the 32x32 main path's 0.982 mm in
# the same call (1.546 mm on the 32x32 frames). The reference's packed
# int32 sort key keeps 2 fewer depth bits on the 16-px grid, so more
# depth-tied splats composite in emission order. The limit is about 1.25
# times the reading.
TILE16_REPS = 3
TILE16_MAX_ERR_M = 2.0e-3
# The same schedule at both tile sizes on plans re-sorted on the full
# depth key (main_path_full_key), where the two composite alike: the
# 16x16 tracker's mean error within this of the 32x32 tracker's there,
# and under the 1 mm accuracy gate. On the H100 both read 0.834 mm
# (0.015% apart), under the main path's 0.982 mm on the 32-px packed key.
TILE16_FULL_KEY_REL = 0.05
# render(tile16=True) against render(tile16=False) on the same scene and
# fresh plans sorted on the full depth key: each pixel composites the
# same pairs in the same order at both tile sizes, so the renders agree
# to this (with the reference's packed key, depth ties on the finer grid
# composite in emission order; that difference is reported, PERF.md).
T16_FULL_KEY_TOL = 1e-5

# The mapping paths: the room map rendered at MAP_KF keyframe poses
# KF_STEP bench steps apart (Replica's kf_interval: 4,
# configs/rgbd/replica/base_config.yaml:48), mapped by the port's backend
# under the Replica base config, as the backend reads it (values copied
# from base_config.yaml: Dataset :10-30, Training :32-62, opt_params
# :64-80, model_params :82-83), with the cuts in MAP_CUTS. The backend
# reads single_thread from Dataset (slam/backend.py:63 of the JAX
# package) where the base YAML has it under Training (:58): it is set in
# both, so a keyframe runs mapping_itr_num iterations (the scene files,
# e.g. room0.yaml, set Dataset single_thread False: 10 iterations a
# keyframe, mapping beside tracking). monocular follows from sensor_type
# 'depth', as the driver derives it (slam/driver.py:44-47).
MAP_KF = 10
KF_STEP = 4
MAP_CONFIG = {
    "seed": 0,
    "Dataset": dict(sensor_type="depth", pcd_downsample=64,
                    pcd_downsample_init=32, adaptive_pointsize=True,
                    point_size=0.05, type="replica", single_thread=True),
    "Training": dict(
        init_itr_num=1050, init_gaussian_update=100, init_gaussian_reset=500,
        init_gaussian_th=0.005, init_gaussian_extent=30,
        tracking_itr_num=100, mapping_itr_num=150, gaussian_update_every=150,
        gaussian_update_offset=50, gaussian_th=0.7, gaussian_extent=1.0,
        gaussian_reset=2001, size_threshold=20, kf_interval=4,
        window_size=10, pose_window=5, edge_threshold=4,
        rgb_boundary_threshold=0.01, kf_translation=0.04,
        kf_min_translation=0.02, kf_overlap=0.95, prune_mode="slam",
        single_thread=True, spherical_harmonics=False, monocular=False,
        lr=dict(cam_rot_delta=0.003, cam_trans_delta=0.001)),
    "opt_params": dict(
        iterations=30000, position_lr_init=0.00016,
        position_lr_final=0.0000016, position_lr_delay_mult=0.01,
        position_lr_max_steps=30000, feature_lr=0.0025, opacity_lr=0.05,
        scaling_lr=0.001, rotation_lr=0.001, percent_dense=0.01,
        lambda_dssim=0.2, densification_interval=100,
        opacity_reset_interval=3000, densify_from_iter=500,
        densify_until_iter=15000, densify_grad_threshold=0.0002),
    "model_params": dict(sh_degree=0),
}
# Cuts of depth (iterations), not of width. init 1050 -> 100 keeps one
# init densify (init_gaussian_update 100); 150 -> 20 iterations per
# keyframe with the densify schedule unchanged puts one densify_and_prune
# at iteration 200 (100 init + 21 per keyframe, its prune pass included);
# the opacity resets (500, 2001) are not reached; color refinement 26000
# -> MAP_REFINE_ITERS.
MAP_CUTS = {"init_itr_num": 100, "mapping_itr_num": 20}
MAP_REFINE_ITERS = 64
# keyframes 1.. reach the backend this far off their true pose (the error
# scale tracking leaves), in a seeded direction
MAP_PERTURB_M, MAP_PERTURB_RAD = 1e-3, 1e-3
# mapping-tile16 against mapping
MAP_T16_PSNR_DB = 0.5
MAP_T16_ACTIVE_REL = 0.02
# Regression limits for both mapping paths, set from the first H100
# reading (NVIDIA H100 80GB HBM3, 700.00 W; mapping / mapping-tile16):
# keyframe PSNR mean 32.96 / 32.97 dB after mapping and 34.93 / 34.96 dB
# after refinement; mean keyframe pose error 1.03 mm before mapping and
# 1.84 / 1.95 mm after (the window's pose Adam restarts at every keyframe
# and its first steps are lr-sized, 0.5 mm; the map is seeded from the
# perturbed poses).
MAP_PSNR_MAPPED_MIN_DB = 31.0
MAP_PSNR_REFINED_MIN_DB = 33.0
MAP_POSE_ERR_MAX_MM = 2.5

# The multi-rank paths (parallel/sharding.py, parallel/slab.py), ranks
# sharing the one card under gloo: ``multichip`` is dryrun_multichip on
# MULTICHIP_RANKS ranks; ``mapping-mesh2`` the backend on MESH_RANKS
# ranks over the mapping path's MAP_KF keyframes (its room map, config
# and cuts; no color refinement, which runs unsharded), against the
# mapping path before its refinement, within the tile16 gate's form. It
# maps all of them: the frame slots split into contiguous shards, as the
# reference's P("data"), and the window's 10 slots fill from slot 0, so
# over the first 4 keyframes rank 1's slots (6-11) hold nothing.
# ``slab-mesh2`` renders the room map at frame 0 and its mapping-loss
# gradients against keyframe 1's ground truth (a real residual) in
# MESH_RANKS depth slabs (tiled), against the one-rank render of the map
# in the slabs' emission order (depth_slab_order: the packed sort key
# keeps fewer depth bits, so depth ties composite in emission order, and
# on the room's walls the ties are many) and its gradients. Images: the
# reference stops a pixel at the first Gaussian that would take T below
# 1e-4 and drops it, so a pixel stops at a T of up to 1e-4 / (1 - 0.99) =
# SLAB_STOP_T; the slabs behind still add what the one-rank render cut
# there, at most its final T in opacity (times the largest Gaussian color
# or view depth in color and depth: parallel/slab.py). So where the
# one-rank render's final T is SLAB_STOP_T or more (no stop) the images
# agree within SLAB_IMG_TOL, and elsewhere within that bound plus
# SLAB_IMG_TOL (the reference's docstring, slab.py:19-24, says 1e-4 for
# both). Gradients: each field's cosine above SLAB_GRAD_MIN_COS and max
# |diff| / max |one-rank| below SLAB_GRAD_MAX_REL (the lab closure's
# form).
MULTICHIP_RANKS = 4
MESH_RANKS = 2
MESH_PSNR_DB = 0.5
MESH_ACTIVE_REL = 0.02
SLAB_IMG_TOL = 1e-4
SLAB_STOP_T = 1e-2
SLAB_GRAD_MIN_COS = 0.999
SLAB_GRAD_MAX_REL = 0.05
# depth_reg of the mapping path's last keyframe on the card against the
# same tensors' on the CPU (sums in another order)
DEPTH_REG_RTOL = 1e-5

# The bf16 tracker paths (kernel_bf16): timed passes, each followed by
# the same passes of its f32 path (uncounted), so the two walls are read
# minutes apart at most; and their limits beside the f32 paths in the
# same call: main-path-bf16 under 1 mm and within BF16_REL of the main
# path's mean error; exact-pyramid-bf16 under EXACT_MAX_ERR_M and at most
# BF16_REL above exact-pyramid's. The exact pyramid's gate is one-sided:
# on the H100 (NVIDIA H100 80GB HBM3, 700.00 W) exact-pyramid-bf16 read
# 1.057 mm mean (1.620 max) against exact-pyramid's 1.860 mm (4.356 mm
# max, one frame that ends 20 all-exact iterations in a worse valley):
# bf16's rounding moves that frame's descent, and a two-sided 10% gate
# failed on an error 43% lower. The kernels themselves are held bit for
# bit against their plain versions.
BF16_REPS = 3
BF16_REL = 0.10

# The mxu kernels (B1-mxu, B1'-mxu, B2-mxu, B2-bf16-mxu) against their
# plain versions: the tensor cores' power against the plain version's f32
# torch.matmul (precision "highest") differs by rounding, and a flipped
# 1/255 or T test moves one pixel by up to ~4e-3: color and final_T max
# |difference| within 1e-3, depth within 5e-3, the 99.9th percentile of
# |difference| of each plane within 1e-4 (color, T) and 5e-4 (depth, in
# metres up to 6 m: where the expanded form's terms reach |power| ~2900 the
# plain f32 form itself sits ~1e-4 off float64, and on the H100 the depth
# plane of tests/test_torch_cuda.py's wide-angle room read 1.04e-4 at its
# 99.9th percentile, NVIDIA H100 80GB HBM3, 700.00 W); n_touched
# mismatches at most 1e-3 of the live pairs; the backward's columns within
# 1e-3 of their max and dL/dtau within 2e-3 relative (the set of exactly
# zero rows may differ by a flipped test, so it is reported, not gated).
# The falloff alone (mxu_falloff.cuh, one chunk's power block) within 1e-4
# of the f32 G6 @ P6, the reference's documented error
# (tile_kernel2.py:105-108),
# where the power can matter (f32 power >= MXU_POWER_FLOOR: alpha >= 1/255
# needs power >= -5.6); over the whole block within 1e-4 plus two ulps of
# the power: on the H100 the two differ by one f32 ulp at the block's
# largest magnitudes (2.44e-4 at |power| ~ 2048, NVIDIA H100 80GB HBM3,
# 700.00 W), where the f32 G6 @ P6 itself is ~3e-4 off float64.
# B2-bf16-mxu's columns within 2e-3 of their max: its power differs from
# the plain version's by an ulp, which moves G across a bfloat16 rounding
# boundary in some cells, and each such cell's five products move by a
# bfloat16 ulp (2^-8): on the H100 (NVIDIA H100 80GB HBM3, 700.00 W) the
# s=1 polish and pad-8 plans read 1.2e-4-4.3e-4 of the column max under
# both cotangents. The bfloat16 products must also have taken effect:
# B2-bf16-mxu's rows differ from B2-mxu's on the same inputs (the five
# quadratic-form columns, Frobenius norm) by more than from their plain
# version: the bfloat16 rounding itself moves a column by only a small
# multiple of the column limit, so that limit alone cannot tell a kernel
# that kept f32 products apart.
#
# A flipped test is rare but not absent: on the H100 (NVIDIA H100 80GB
# HBM3, 700.00 W, the room's s=4/2/1 tracker plans) 0-3 of the 0.25-4.1
# million image values exceeded those limits (max 1.18e-3 in color,
# 5.06e-3 in depth, 9.2e-4 in T) while the 99.9th percentile read
# 2.4e-6-6.7e-6 (the five planes pooled) and the 99.99th at most 2.6e-5.
# So the max limits above hold all but MXU_FLIP_FRAC of the values, and
# every value stays within what flipped tests can move it by,
# MXU_FLIP_TOL: a pair's 1/255 test
# moves a pixel's weights by at most 2/255 of its channel range (its own
# weight and the transmittance it takes from the pairs behind), the color
# and T in [0, 1], the depth in [0, 6] m on the room.
MXU_IMG_TOL = {"color": 1e-3, "depth": 5e-3, "T": 1e-3}
MXU_FLIP_FRAC = 1e-5
MXU_FLIP_TOL = {"color": 8e-3, "depth": 5e-2, "T": 8e-3}
MXU_P999_TOL = {"color": 1e-4, "depth": 5e-4, "T": 1e-4}
MXU_NT_MISMATCH_FRAC = 1e-3
MXU_BWD_COL_TOL = 1e-3
MXU_BF16_BWD_COL_TOL = 2e-3
MXU_BWD_DTAU_TOL = 2e-3
MXU_POWER_TOL = 1e-4
MXU_POWER_FLOOR = -20.0
# render-mxu against the f32 renders: tests/test_renderer_tiled.py's
# mxu gates (max |difference| of color, depth, opacity), for all but
# MXU_FLIP_FRAC of the values, every value within MXU_FLIP_TOL (the 99.9th
# percentile is reported: the two evaluate the power by different
# formulas, so their differences are not at rounding level): on the H100
# the five renders read max 1.48e-3 (color), 3.06e-3 (depth), 5.5e-4
# (opacity), 2-4 Gaussians of 200k differing in n_touched (the f32
# kernel's direct quadratic form and the tile-local expansion differ by
# f32 rounding, which flips a few 1/255 tests).
MXU_RENDER_TOL = {"color": 1e-3, "depth": 5e-3, "opacity": 1e-3}
MXU_RENDER_FLIP_TOL = {"color": 8e-3, "depth": 5e-2, "opacity": 8e-3}
# The mxu bound: the tensor cores' share, three TF32 m16n16k8 passes of
# the power block, 3 x 2 x 8 FLOP a needed (pair, pixel) cell (a walked
# one under walk_bound_ms) at the dense TF32 peak (495 TFLOP/s, H100 SXM
# data sheet), charged beside the CUDA cores' share at the FP32 peak.
# CUDA-core operations, counted from the first mxu forward's body (one
# CTA per 32x32 tile, PR 5):
# a walked cell the f32 kernel's 25 less the deltas (2) and the quadratic
# form (9), plus the clamp 1: 15;
# a cell that passes the skip tests while its pixel is not done (the only
# cells that reach the log-space prefix) the f32 kernel's 13 less the
# linear T_incl (2), plus log1pf ~8, the second expf ~4, the division ~4,
# the log-space sum and product 2 and the T min 1: 30. The mxu backward
# recomputes the linear walk and keeps the deltas for the gradient
# products: 25 - 9 + 1 = 17 a walked cell, and B2's 59 an included cell.
# The needed cells are charged both shares (forward 15 + 30, backward
# 17 + 59).
TF32_FLOP_PER_S = 495e12
TC_FLOP_PER_CELL = 3 * 2 * 8
OPS_PER_WALKED_CELL_MXU = 15.0
OPS_PER_PASSED_CELL_MXU = 30.0
OPS_PER_WALKED_CELL_BWD_MXU = 17.0

# The SLAM paths: the port's SLAM driver on the synthetic room at
# 1216x672 (fx = fy = 600), scripts/tpu_slam_run.py:34-95's settings over
# configs/synthetic/test.yaml's values, written out as a dict (the card
# machine has no pyyaml). SLAM_FRAMES frames (that script's default),
# rendered before the clock starts. The only cut: color refinement,
# 26000 -> SLAM_REFINE_ITERS iterations.
SLAM_FRAMES = 24
SLAM_REFINE_ITERS = 256
SLAM_CONFIG = {
    "seed": 0,
    "Results": dict(save_results=True, save_dir="results", save_trj=True,
                    save_trj_kf_intv=4, use_gui=False, eval_rendering=True,
                    use_wandb=False),
    "Dataset": dict(
        type="synthetic", sensor_type="depth", scene="room",
        motion_scale=0.5, pcd_downsample=64, pcd_downsample_init=16,
        adaptive_pointsize=True, point_size=0.05, n_frames=SLAM_FRAMES,
        seed=0, single_thread=True,
        Calibration=dict(fx=600.0, fy=600.0, cx=607.5, cy=335.5, k1=0.0,
                         k2=0.0, p1=0.0, p2=0.0, k3=0.0, width=1216,
                         height=672, depth_scale=1.0, distorted=False)),
    "Training": dict(
        init_itr_num=128, init_gaussian_update=64, init_gaussian_reset=5000,
        init_gaussian_th=0.005, init_gaussian_extent=30,
        tracking_itr_num=20, mapping_itr_num=32, gaussian_update_every=64,
        gaussian_update_offset=32, gaussian_th=0.7, gaussian_extent=1.0,
        gaussian_reset=2001, size_threshold=20, kf_interval=2,
        window_size=6, pose_window=3, edge_threshold=1.1,
        rgb_boundary_threshold=0.01, kf_translation=0.01,
        kf_min_translation=0.005, kf_overlap=1.0, prune_mode="slam",
        single_thread=True, spherical_harmonics=False, monocular=False,
        initial_capacity=1 << 18, pair_capacity=1 << 19,
        kf_pending_yield_s=0.0, plan_reuse_frames=0, map_coarse_frac=0.7,
        map_coarse_level=2, prewarm_tracking=True, prewarm_mapping=True,
        tile16=False, lr=dict(cam_rot_delta=0.003, cam_trans_delta=0.001)),
    "opt_params": dict(
        iterations=30000, position_lr_init=0.00016,
        position_lr_final=0.0000016, position_lr_delay_mult=0.01,
        position_lr_max_steps=30000, feature_lr=0.0025, opacity_lr=0.05,
        scaling_lr=0.001, rotation_lr=0.001, percent_dense=0.01,
        lambda_dssim=0.2, densification_interval=100,
        opacity_reset_interval=3000, densify_from_iter=500,
        densify_until_iter=15000, densify_grad_threshold=0.01),
    "model_params": dict(sh_degree=0),
}
# the three runs: frontend defaults (f32); the threaded pipeline
# (single_thread false in both sections, the script's 0.5 s pending-
# keyframe yield); f32 plus kernel_bf16 with two exact full-resolution
# iterations a frame, so B1'-bf16 and B2-bf16 run through the frontend
SLAM_RUNS = (
    ("slam", {}, ("composite32_fwd", "composite32_fwd_ntouch",
                  "composite32_bwd")),
    ("slam-async", {"single_thread": False, "kf_pending_yield_s": 0.5},
     ("composite32_fwd", "composite32_fwd_ntouch", "composite32_bwd")),
    ("slam-bf16", {"kernel_bf16": True, "pyr_exact": [0, 0, 2]},
     ("composite32_fwd_bf16", "composite32_bwd_bf16",
      "composite32_fwd_ntouch")),
    # kernel_mxu with the same two exact full-resolution iterations, so
    # every IRLS render runs B1'-mxu and the exact steps B2-mxu; started
    # as the CLI starts it with --viewer 0 (run_slam probes the viewer)
    ("slam-mxu", {"kernel_mxu": True, "pyr_exact": [0, 0, 2]},
     ("composite32_fwd_mxu", "composite32_bwd_mxu",
      "composite32_fwd_ntouch")),
)
# ATE: under 1 cm, and under a regression limit of ~1.25x the first H100
# reading (NVIDIA H100 80GB HBM3, 700.00 W: slam 1.892 mm, slam-bf16
# 1.797 mm). slam-async read 1.563 mm with 7 keyframes; its keyframe set
# follows the threads' timing, so it shares slam's limit rather than one
# at 1.25x its own first reading.
SLAM_ATE_MAX_M = 0.01
SLAM_ATE_REG_M = {"slam": 2.4e-3, "slam-async": 2.4e-3,
                  "slam-bf16": 2.3e-3}
SLAM_BF16_ATE_REL = 1.25
SLAM_MIN_KF = 3
# slam-mxu: under 1 cm and within SLAM_BF16_ATE_REL of slam's ATE (no
# regression limit of its own before a first reading)


FAILURES = []


def fail(msg):
    """Record a failed gate and go on, so that one call reports every
    phase; the run exits non-zero, without its result lines, at the end
    (check_failures)."""
    print(f"FAIL: {msg}", flush=True)
    FAILURES.append(msg)


def check_failures():
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} gate(s) failed", flush=True)
        sys.exit(1)


def time_ms(fn, reps=7, warm=2):
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def pose_list(n=FRAMES):
    """bench.py's trajectory (bench.py:168-175, the port's bench.pose_list),
    ~6 mm + 4 mrad per frame: its first ``n`` poses (the bench's 5 by
    default)."""
    return bench.pose_list(n)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_case(name, feat, ranges, n_tx, n_ty, w, h, with_ntouch,
                nt_weight=False, tile16=False, time_plain=True, bf16=False,
                mxu=False):
    """A forward kernel against its plain version on one plan: B1/B1'
    (32x32), under ``bf16`` or ``mxu`` their bfloat16 or MXU bodies (and
    the f32 kernel's time on the same plan beside them), or under
    ``tile16`` B3/B3' (n_tx x n_ty is then the 16-px tile grid), with the
    cells the sub-tile kernel evaluates. Plain time unless not
    ``time_plain``."""
    tile = 16 if tile16 else 32

    def kernel(bf16=bf16, mxu=mxu):
        if tile16:
            return tk16.composite16(feat, ranges, n_tx // 2, n_ty // 2, w, h,
                                    with_ntouch, nt_weight)
        return tk.composite32(feat, ranges, n_tx, n_ty, w, h, with_ntouch,
                              nt_weight, bf16, mxu)

    def plain():
        return tk.plain_walk(feat, ranges, n_tx, n_ty, w, h, with_ntouch,
                             nt_weight, tile=tile, bf16=bf16, mxu=mxu)

    # the f32 32x32 kernel's images are held bit for bit to plain, the
    # bf16 and 16-px kernels' images and n_touched bit for bit to plain
    subtile = not (tile16 or bf16 or mxu)
    exact = not mxu and (bf16 or tile16)
    torch.cuda.synchronize()
    ref, walked, passed, stop_at = tk.plain_walk(
        feat, ranges, n_tx, n_ty, w, h, with_ntouch, nt_weight, tile=tile,
        bf16=bf16, mxu=mxu, done_at=True)
    got = kernel()
    torch.cuda.synchronize()
    errs = {
        "color": float((got.color_sum - ref.color_sum).abs().max()),
        "depth": float((got.depth_sum - ref.depth_sum).abs().max()),
        "T": float((got.final_T - ref.final_T).abs().max()),
    }
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    live = int((ranges[:, 1] - ranges[:, 0]).sum())
    nt_bad = int((got.n_touched_pairs != ref.n_touched_pairs).sum())
    walked_pairs = int(walked.sum())
    passed_cells = int(passed)
    diffs = {k: (a - b).abs().flatten() for k, a, b in zip(
        ("color", "depth", "T"), got[:3], ref[:3])}
    diff = torch.cat(list(diffs.values()))
    p999 = {k: float(torch.quantile(d, 0.999)) for k, d in diffs.items()}
    p9999 = {k: float(torch.quantile(d, 0.9999)) for k, d in diffs.items()}
    over_1e3 = int((diff > 1e-3).sum())
    over_tol = sum(int((diffs[k] > MXU_IMG_TOL[k]).sum()) for k in diffs)
    kept, rected = tk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at,
                                    tile=tile, mxu=mxu, bf16=bf16)
    ms = time_ms(kernel)
    plain_ms = (time_ms(plain, reps=3 if bf16 or mxu else 5, warm=1)
                if time_plain else None)
    cells = walked_pairs * tile * tile
    nt_bytes = 4 if with_ntouch else 0
    t_bytes = (live * (64 + nt_bytes) + ranges.numel() * 4
               + 5 * h * w * 4) / HBM_BYTES_PER_S * 1e3
    walk_t_bytes = (walked_pairs * (64 + nt_bytes) + ranges.numel() * 4
                    + 5 * h * w * 4) / HBM_BYTES_PER_S * 1e3
    if mxu:
        t_ops = (passed_cells * (OPS_PER_WALKED_CELL_MXU
                                 + OPS_PER_PASSED_CELL_MXU) / FP32_OPS_PER_S
                 + passed_cells * TC_FLOP_PER_CELL / TF32_FLOP_PER_S) * 1e3
        walk_t_ops = ((cells * OPS_PER_WALKED_CELL_MXU
                       + passed_cells * OPS_PER_PASSED_CELL_MXU)
                      / FP32_OPS_PER_S
                      + cells * TC_FLOP_PER_CELL / TF32_FLOP_PER_S) * 1e3
    else:
        t_ops = passed_cells * (OPS_PER_WALKED_CELL + OPS_PER_PASSED_CELL) \
            / FP32_OPS_PER_S * 1e3
        walk_t_ops = (cells * OPS_PER_WALKED_CELL + passed_cells
                      * OPS_PER_PASSED_CELL) / FP32_OPS_PER_S * 1e3
    rec = dict(case=name, tile=tile, shape=f"{w}x{h}",
               with_ntouch=with_ntouch, bf16=bf16, mxu=mxu,
               nt_weight=nt_weight, live_pairs=live,
               walked_pairs=walked_pairs, walked_cells=cells,
               passed_cells=passed_cells, max_abs_err=errs,
               p999_abs_err=p999, p9999_abs_err=p9999,
               values_over_1e3=over_1e3, values=int(diff.numel()),
               values_over_mxu_tol=over_tol, nt_mismatch=nt_bad, ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations",
               walk_bound_ms=max(walk_t_bytes, walk_t_ops),
               post_cull_cells=kept, rect_cells=rected)
    if mxu:
        rec["bound_tensor_core_ms"] = passed_cells * TC_FLOP_PER_CELL \
            / TF32_FLOP_PER_S * 1e3
    if bf16 or mxu:
        rec["f32_ms"] = time_ms(lambda: kernel(False, False))
        rec["differs_from_f32"] = float(
            (got.color_sum - kernel(False, False).color_sum).abs().max())
    print("kernel-vs-plain " + json.dumps(rec), flush=True)
    if not finite:
        fail(f"{name}: non-finite kernel output")
    if mxu:
        gate = mxu_gate_failure(got, ref, live)
        if gate:
            fail(f"{name} (mxu): {gate}")
    else:
        if max(errs.values()) > IMG_TOL:
            fail(f"{name}: kernel differs from plain by {errs}")
        if nt_bad > NT_MISMATCH_FRAC * live:
            fail(f"{name}: {nt_bad} n_touched mismatches of {live} live "
                 "pairs")
    if subtile:
        # the sub-tile kernel composites the same cells in the same order
        # with the same arithmetic: its images are the plain version's
        if max(errs.values()) > 0.0:
            fail(f"{name}: the sub-tile kernel's images are not bit-equal "
                 f"to plain ({errs})")
    if exact:
        # the bf16 and 16-px sub-tile kernels: only skipped cells are
        # dropped, so images and n_touched are plain's bit for bit
        if max(errs.values()) > 0.0 or nt_bad:
            fail(f"{name}: the sub-tile kernel is not bit-equal to plain "
                 f"({errs}, {nt_bad} n_touched mismatches)")
    if bf16 and rec["differs_from_f32"] <= IMG_TOL:
        fail(f"{name}: the bf16 kernel's image equals the f32 kernel's")
    return rec


def mxu_gate_failure(got, ref, live):
    """What an mxu forward's outputs ``got`` break of the MXU gates against
    its plain version's ``ref`` (``live`` pairs), or None."""
    diffs = {k: (a - b).abs().flatten() for k, a, b in zip(
        ("color", "depth", "T"), got[:3], ref[:3])}
    n = sum(d.numel() for d in diffs.values())
    errs = {k: float(d.max()) for k, d in diffs.items()}
    p999 = {k: float(torch.quantile(d, 0.999)) for k, d in diffs.items()}
    over = sum(int((diffs[k] > MXU_IMG_TOL[k]).sum()) for k in diffs)
    nt_bad = int((got.n_touched_pairs != ref.n_touched_pairs).sum())
    msgs = []
    if over > MXU_FLIP_FRAC * n \
            or any(p999[k] > MXU_P999_TOL[k] for k in p999) \
            or any(errs[k] > MXU_FLIP_TOL[k] for k in errs):
        msgs.append(f"differs from plain by {errs}, {over} of {n} values "
                    f"above {MXU_IMG_TOL}, 99.9th percentiles {p999} "
                    f"(limits: {MXU_FLIP_FRAC:.0e} of the values, "
                    f"{MXU_P999_TOL}, each within {MXU_FLIP_TOL})")
    if nt_bad > MXU_NT_MISMATCH_FRAC * live:
        msgs.append(f"{nt_bad} n_touched mismatches of {live} live pairs")
    return "; ".join(msgs) or None


def kernel_grid(w, h, tile16=False):
    """The tile grid a compositing kernel walks: 32-px tiles, or the
    2*ceil(W/32) x 2*ceil(H/32) grid of 16-px tiles."""
    if tile16:
        n_gx, n_gy = tk16.grid_dims16(w, h)
        return 2 * n_gx, 2 * n_gy
    return tk.grid_dims(w, h)


def pair_rows(prep, w, h, cap, radius_scale=1.0, radius_pad=0.0,
              tile16=False, opa_growth=1.0):
    plan = make_plan(prep, w, h, cap, radius_scale=radius_scale,
                     radius_pad=radius_pad, tile16=tile16,
                     opa_growth=opa_growth)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    n_tx, n_ty = kernel_grid(w, h, tile16)
    return feat, plan.ranges.contiguous(), n_tx, n_ty, plan


def resort_full_depth_key(plan, depth):
    """``plan`` with each tile's pairs in full f32 depth order, ties in
    emission order: the order an int64 [tile | 31 depth bits] sort key
    gives. The reference's packed int32 key keeps 31 - bit_length(n_tiles)
    depth bits (21 on the 32-px grid at 1200x680, 19 on the 16-px one) and
    composites truncated-depth ties in emission order. A tile's pairs
    already stand in (truncated depth, emission) order, so a stable sort
    on (tile, full depth) gives (tile, depth, emission); counts and
    ranges stay, pair_gid1 and aligned_of_em move together."""
    gid1 = plan.pair_gid1
    B_al = gid1.shape[0]
    slot = torch.arange(B_al, device=gid1.device)
    tile = torch.searchsorted(plan.ranges[:, 0].long().contiguous(), slot,
                              right=True) - 1
    bits = depth.contiguous().view(torch.int32).long()[
        torch.clamp(gid1.long() - 1, min=0)]
    key = (tile << 32) | torch.where(gid1 > 0, bits,
                                     torch.full_like(bits, 1 << 31))
    order = torch.sort(key, stable=True).indices
    new_of_old = torch.empty_like(order)
    new_of_old[order] = slot
    aoe = plan.aligned_of_em
    moved = new_of_old[torch.clamp(aoe.long(), max=B_al - 1)].to(torch.int32)
    return plan._replace(pair_gid1=gid1[order],
                         aligned_of_em=torch.where(aoe < B_al, moved, aoe))


class full_depth_key_plans:
    """Inside the block every plan the port builds (renderer_tiled's
    make_plan, which render, the trackers and mapping call) is re-sorted
    by resort_full_depth_key."""

    def __enter__(self):
        self.plan_pairs = inner = renderer_tiled.plan_pairs

        def plan_pairs(prep, *args, **kw):
            return resort_full_depth_key(inner(prep, *args, **kw), prep.depth)
        renderer_tiled.plan_pairs = plan_pairs

    def __exit__(self, *exc):
        renderer_tiled.plan_pairs = self.plan_pairs


def phase_kernels(dev, gm, cam):
    recs = []
    # the renderer entry workload (__graft_entry__.entry)
    means, scales, quats, opac, shs = make_cloud(N_CLOUD, seed=0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    proj = t(cm.projection_matrix(0.01, 100.0, (W - 1) / 2, (H - 1) / 2,
                                  FX, FY, W, H))
    prep = gmath.preprocess(
        t(means), gmath.build_cov3d(t(scales), t(quats)), t(opac), t(shs), 0,
        torch.eye(4, device=dev), proj, torch.zeros(6, device=dev), FX, FY,
        W, H, W / (2 * FX), H / (2 * FY))
    feat, ranges, n_tx, n_ty, plan = pair_rows(prep, W, H, PAIR_CAP)
    print(f"entry scene: {int(plan.num_pairs)} pairs, overflow "
          f"{int(plan.overflow)}", flush=True)
    recs.append(kernel_case("entry_cloud50k", feat, ranges, n_tx, n_ty, W, H,
                            True, time_plain=False))
    recs[-1]["overflow"] = int(plan.overflow)

    # the room map's pyramid levels at the first frame's pose, planned as
    # the tracker plans them (radius_scale 1.1, pad max(2, 4/s), matched
    # low-pass, capacity 2^19 below full resolution); forms are
    # (with_ntouch, nt_weight), and the nt_weight instantiation, which the
    # main path does not run, is held against the plain version once
    both = [(False, False), (True, False)]
    for s, forms in ((4, [(False, False)]), (2, both + [(True, True)]),
                     (1, both)):
        cam_l = tracking._cam_level(cam, s)
        lp = (0.3 + (s * s - 1) / 12.0) / (s * s) if s > 1 else 0.3
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam_l.w2c(), cam_l.projection(), torch.zeros(6, device=dev),
            cam_l.fx, cam_l.fy, cam_l.width, cam_l.height, cam_l.tanfovx,
            cam_l.tanfovy, low_pass=lp)
        cap = PAIR_CAP if s == 1 else PAIR_CAP // 2
        feat, ranges, n_tx, n_ty, plan = pair_rows(
            prep, cam_l.width, cam_l.height, cap, 1.1, max(2.0, 4.0 / s))
        for with_nt, nt_w in forms:
            recs.append(kernel_case(f"room_s{s}", feat, ranges, n_tx, n_ty,
                                    cam_l.width, cam_l.height, with_nt, nt_w,
                                    time_plain=s == 2 and not nt_w))
    return recs


def level_prep_fn(dev, gm, cam_l, low_pass):
    """tau -> preprocess of the room map at ``cam_l``: the chain B2's
    rows travel back along to dL/dtau."""
    def prep_fn(tau):
        return gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam_l.w2c(), cam_l.projection(), tau, cam_l.fx, cam_l.fy,
            cam_l.width, cam_l.height, cam_l.tanfovx, cam_l.tanfovy,
            low_pass=low_pass)
    return prep_fn


def loss_cotangent(planes, target):
    """The cotangent loss_tracking_rgbd hands the compositing, d L /
    d (color_sum, depth_sum, final_T), at zero background and exposure."""
    gt_img, gt_depth, mask = target
    cs, ds, ft = [p.detach().clone().requires_grad_() for p in planes]
    zero = torch.zeros((), device=cs.device)
    image = losses.apply_exposure(cs, zero, zero)
    L = losses.loss_tracking_rgbd(image, ds[None], gt_img, gt_depth,
                                  (1.0 - ft)[None], mask, 0.01, 0.95)
    return torch.autograd.grad(L, (cs, ds, ft))


def mapping_cotangent(planes, target):
    """The cotangent loss_mapping_rgbd hands the compositing against a
    keyframe, at zero background and exposure."""
    gt_img, gt_depth = target[0], target[1]
    cs, ds, ft = [p.detach().clone().requires_grad_() for p in planes]
    zero = torch.zeros((), device=cs.device)
    image = losses.apply_exposure(cs, zero, zero)
    L = losses.loss_mapping_rgbd(image, ds[None], gt_img, gt_depth, 0.01,
                                 0.95)
    grads = torch.autograd.grad(L, (cs, ds, ft), allow_unused=True)
    # T reaches this loss only through the background, which is zero
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, (cs, ds, ft)))


def b2_case(name, dev, prep_fn, w, h, cap, radius_scale, radius_pad,
            target, seed, time_plain=True, tile16=False, opa_growth=1.0,
            cot_fn=loss_cotangent, bf16=False, mxu=False):
    """The backward kernel against its plain version on one plan (B2, with
    a second launch held bit for bit to the first and the cells it
    evaluates; under ``bf16``, ``mxu`` or both B2-bf16, B2-mxu or
    B2-bf16-mxu likewise, on the matching forward's planes with the f32
    kernel's time beside it; under ``tile16`` B4 on a 16-px plan, with a
    second launch and its cells) under ``cot_fn``'s loss cotangent and a
    seeded one: per-column error, dL/dtau through both routes, and kernel
    / bound times, and the plain version's unless not ``time_plain``. The
    cells follow the backward walk's own stops (plain_bwd_walk(done_at=True)),
    which must equal the forward walk's but under mxu (its linear T
    against the forward's log space: the pixels whose stops differ are
    reported)."""
    tau = torch.zeros(6, device=dev, requires_grad=True)
    prep = prep_fn(tau)
    plan = make_plan(prep, w, h, cap, radius_scale=radius_scale,
                     radius_pad=radius_pad, tile16=tile16,
                     opa_growth=opa_growth)
    feat = pair_gather(pack_table(prep), plan)
    feat_c, ranges = feat.detach().contiguous(), plan.ranges.contiguous()
    n_tx, n_ty = kernel_grid(w, h, tile16)
    tile = 16 if tile16 else 32
    if tile16:
        def kernel(*a):
            return tk16.composite16_bwd(*a[:8], n_tx // 2, n_ty // 2, w, h)
    else:
        def kernel(*a, bf16=bf16, mxu=mxu):
            return tk.composite32_bwd(*a, bf16=bf16, mxu=mxu)
    with torch.no_grad():
        fwd = (tk16.composite16_fwd(feat_c, ranges, n_tx // 2, n_ty // 2, w,
                                    h) if tile16
               else tk.composite32_fwd(feat_c, ranges, n_tx, n_ty, w, h,
                                       bf16=bf16, mxu=mxu))
    planes = (fwd.color_sum, fwd.depth_sum, fwd.final_T)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seeded = torch.randn(5, h, w, generator=gen, device=dev)
    cots = {"loss": cot_fn(planes, target),
            "seeded": (seeded[0:3], seeded[3], seeded[4])}
    cull = {}
    live = int((ranges[:, 1] - ranges[:, 0]).sum())
    recs = []
    for kind, cot in cots.items():
        args = (feat_c, ranges, *planes, *cot, n_tx, n_ty, w, h)
        torch.cuda.synchronize()
        with torch.no_grad():
            got = kernel(*args)
            ref, walked, included, stop_at = tk.plain_bwd_walk(
                *args, tile=tile, bf16=bf16, mxu=mxu, done_at=True)
            again = kernel(*args)
        torch.cuda.synchronize()
        if not cull:
            # the cells the sub-tile body evaluates, from the backward
            # walk's stops (the same under every cotangent)
            with torch.no_grad():
                kept, rected = tk.subtile_cells(feat_c, ranges, n_tx, n_ty,
                                                stop_at, tile=tile, mxu=mxu,
                                                bf16=bf16)
                fwd_stop = tk.plain_walk(feat_c, ranges, n_tx, n_ty, w, h,
                                         False, tile=tile, bf16=bf16,
                                         mxu=mxu, done_at=True)[3]
            cull = dict(post_cull_cells=kept, rect_cells=rected,
                        stops_differing_from_forward=int(
                            (stop_at != fwd_stop).sum()))
        extra = dict(cull)
        # warps (and B2's cluster the quarters) are summed in a fixed
        # order: a second launch gives the same rows bit for bit
        extra["repeat_bit_equal"] = bool(torch.equal(got, again))
        col_rel = []
        for c in range(tk.N_ROWS):
            scale = float(ref[:, c].abs().max())
            err = float((got[:, c] - ref[:, c]).abs().max())
            col_rel.append(err / scale if scale > 0 else err)
        if bf16 and mxu:
            with torch.no_grad():
                f32_products = kernel(*args, bf16=False)
            bf16_effect = float((got[:, :5] - f32_products[:, :5]).norm())
            plain_gap = float((got[:, :5] - ref[:, :5]).norm())
        (dtau_k,) = torch.autograd.grad(feat, tau, got, retain_graph=True)
        (dtau_p,) = torch.autograd.grad(feat, tau, ref, retain_graph=True)
        dtau_rel = float((dtau_k - dtau_p).abs().max()
                         / dtau_p.abs().max())
        with torch.no_grad():
            ms = time_ms(lambda: kernel(*args))
            plain_ms = (time_ms(lambda: tk.plain_bwd_walk(
                *args, tile=tile, bf16=bf16, mxu=mxu),
                reps=3 if bf16 or mxu else 7, warm=1)
                if time_plain and kind == "loss" else None)
            f32_ms = (time_ms(lambda: kernel(*args, bf16=False, mxu=False))
                      if bf16 or mxu else None)
        walked_pairs = int(walked.sum())
        included_cells = int(included)
        cells = walked_pairs * tile * tile
        planes_bytes = (feat_c.shape[0] * 64 + ranges.numel() * 4
                        + 10 * h * w * 4)
        t_bytes = (live * 64 + planes_bytes) / HBM_BYTES_PER_S * 1e3
        walk_t_bytes = ((walked_pairs * 64 + planes_bytes)
                        / HBM_BYTES_PER_S * 1e3)
        per_walked = (OPS_PER_WALKED_CELL_BWD_MXU if mxu
                      else OPS_PER_WALKED_CELL_BWD)
        t_ops = (included_cells * (per_walked + OPS_PER_INCLUDED_CELL_BWD)
                 / FP32_OPS_PER_S * 1e3)
        walk_t_ops = ((cells * per_walked
                       + included_cells * OPS_PER_INCLUDED_CELL_BWD)
                      / FP32_OPS_PER_S * 1e3)
        if mxu:
            t_ops += included_cells * TC_FLOP_PER_CELL / TF32_FLOP_PER_S \
                * 1e3
            walk_t_ops += cells * TC_FLOP_PER_CELL / TF32_FLOP_PER_S * 1e3
        rec = dict(
            case=name, tile=tile, cotangent=kind, shape=f"{w}x{h}", bf16=bf16,
            mxu=mxu,
            B_al=int(feat_c.shape[0]), live_pairs=int(plan.num_pairs),
            walked_pairs=walked_pairs,
            walked_cells=walked_pairs * tile * tile,
            included_cells=included_cells, overflow=int(plan.overflow),
            max_abs_err=float((got - ref).abs().max()),
            max_col_rel_err=max(col_rel), col_rel_err=col_rel,
            zero_rows_equal=bool(torch.equal(got.any(dim=1),
                                              ref.any(dim=1))),
            dtau_kernel=dtau_k.tolist(), dtau_plain=dtau_p.tolist(),
            dtau_rel_err=dtau_rel, ms=ms, plain_ms=plain_ms, f32_ms=f32_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes > t_ops else "operations",
            walk_bound_ms=max(walk_t_bytes, walk_t_ops), **extra)
        if bf16 and mxu:
            rec.update(bf16_effect_norm=bf16_effect, plain_gap_norm=plain_gap)
        label = "B4" if tile16 else "B2" + ("-bf16" if bf16 else "") + (
            "-mxu" if mxu else "")
        col_tol = ((MXU_BF16_BWD_COL_TOL if bf16 else MXU_BWD_COL_TOL)
                   if mxu else BWD_COL_TOL)
        dtau_tol = MXU_BWD_DTAU_TOL if mxu else BWD_DTAU_TOL
        print(f"{label.lower()}-vs-plain " + json.dumps(rec), flush=True)
        if not bool(torch.isfinite(got).all()):
            fail(f"{label} {name}/{kind}: non-finite rows")
        if got[:, tk.N_ROWS:].any() or (not rec["zero_rows_equal"]
                                        and not mxu):
            fail(f"{label} {name}/{kind}: rows that must be zero are not")
        if max(col_rel) > col_tol:
            fail(f"{label} {name}/{kind}: a column differs from plain by "
                 f"{max(col_rel):.3e} of its max (limit {col_tol})")
        if dtau_rel > dtau_tol:
            fail(f"{label} {name}/{kind}: dL/dtau differs by "
                 f"{dtau_rel:.3e} relative (limit {dtau_tol})")
        if not extra["repeat_bit_equal"]:
            fail(f"{label} {name}/{kind}: two launches gave different rows")
        if not mxu and extra["stops_differing_from_forward"]:
            fail(f"{label} {name}: the backward walk's stops differ from "
                 f"the forward walk's at "
                 f"{extra['stops_differing_from_forward']} pixels")
        if bf16 and mxu and bf16_effect <= plain_gap:
            fail(f"{label} {name}/{kind}: the bf16 products moved the rows "
                 f"by {bf16_effect:.3e}, no more than the gap to plain "
                 f"{plain_gap:.3e}")
        recs.append(rec)
    return recs


def phase_backward(dev, gm, cam, poses):
    """B2 vs its plain version at the shapes the exact paths launch."""
    gts, _ = render_ground_truth(dev, gm, cam, poses[:2])
    gt1 = gts[1]
    recs = []
    # s=1 as polish_frame (and every exact full-resolution iteration)
    # plans it: radius_scale 1.1, pad 2 px, capacity 2^20
    recs += b2_case("room_s1_polish", dev,
                    level_prep_fn(dev, gm, cam, 0.3), W, H, PAIR_CAP, 1.1,
                    2.0, gt1, seed=1)
    # s=1 as track_frame_gn, track_frame and the exact pyramid's finest
    # level plan it (pad 8); plain version untimed
    recs += b2_case("room_s1_pad8", dev, level_prep_fn(dev, gm, cam, 0.3),
                    W, H, PAIR_CAP, 1.1, 8.0, gt1, seed=4, time_plain=False)
    # s=2 and s=4 as the exact pyramid plans them (pad 8/s, at least 2;
    # capacity 2^19); s=4 walks the longest pair lists per tile
    for s, seed in ((2, 2), (4, 5)):
        cam_s = tracking._cam_level(cam, s)
        gt_s = (tracking._pool_avg(gt1[0], s),
                tracking._stride_center(gt1[1], s),
                tracking._pool_max(gt1[2], s))
        recs += b2_case(f"room_s{s}", dev, level_prep_fn(dev, gm, cam_s, 0.3),
                        cam_s.width, cam_s.height, PAIR_CAP // 2, 1.1,
                        max(2.0, 8.0 / s), gt_s, seed=seed,
                        time_plain=False)
    # the entry cloud, against the room's frame-1 target
    means, scales, quats, opac, shs = make_cloud(N_CLOUD, seed=0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    proj = t(cm.projection_matrix(0.01, 100.0, (W - 1) / 2, (H - 1) / 2,
                                  FX, FY, W, H))
    cov6 = gmath.build_cov3d(t(scales), t(quats))

    def cloud_prep(tau):
        return gmath.preprocess(t(means), cov6, t(opac), t(shs), 0,
                                torch.eye(4, device=dev), proj, tau, FX, FY,
                                W, H, W / (2 * FX), H / (2 * FY))
    recs += b2_case("entry_cloud50k", dev, cloud_prep, W, H, PAIR_CAP, 1.0,
                    0.0, gt1, seed=3, time_plain=False)
    return recs


def phase_lab(dev):
    """dL/dtau closure on the card: the 15-Gaussian fixture's gradient
    through the CUDA kernels against the port's analytic lab."""
    fix = lab.load_fixture()
    analytic = lab.run(fix, mode="exact", verbose=False, device=dev)["total"]
    means = torch.as_tensor(fix["xyz"], device=dev)
    opac = torch.sigmoid(torch.as_tensor(fix["opacity"], device=dev))[:, 0]
    shs = torch.as_tensor(fix["features"], device=dev)
    w2c = torch.as_tensor(np.asarray(fix["w2c_gt"], np.float32)
                          @ np.asarray(fix["T_noise"], np.float32),
                          device=dev)
    gt_color = torch.as_tensor(fix["gt_color"], device=dev)
    gt_depth = torch.as_tensor(fix["gt_depth"], device=dev)
    mask = torch.as_tensor(fix["mask"], device=dev)
    fx, fy, cx, cy = [float(fix[k]) for k in ("fx", "fy", "cx", "cy")]
    h, w = gt_depth.shape
    proj = torch.as_tensor(cm.projection_matrix(0.01, 100.0, cx, cy, fx, fy,
                                                w, h), device=dev)
    cov6 = gmath.build_cov3d(torch.exp(torch.as_tensor(fix["scaling"],
                                                       device=dev)),
                             torch.as_tensor(fix["rotation"], device=dev))
    tau = torch.zeros(6, device=dev, requires_grad=True)
    before = tk.composite32_bwd.launches
    out = renderer_tiled.render(
        means, cov6, opac, shs, 3, w2c, proj, tau, fx, fy, w, h,
        w / (2 * fx), h / (2 * fy), torch.zeros(3, device=dev),
        pair_capacity=1 << 14, need_n_touched=False, device=dev)
    C = out.color.permute(1, 2, 0)
    L = (torch.sum(torch.abs(C - gt_color) * mask[..., None])
         + torch.sum(torch.abs(out.depth[0] - gt_depth)
                     * (mask & (gt_depth > 0))))
    (g,) = torch.autograd.grad(L, tau)
    g = g.cpu().numpy()
    rel = float(np.abs(g - analytic).max() / np.abs(analytic).max())
    cos = float(g @ analytic / (np.linalg.norm(g) * np.linalg.norm(analytic)))
    rec = dict(dtau_cuda=g.tolist(), dtau_lab=analytic.tolist(),
               max_rel=rel, cosine=cos,
               bwd_launches=tk.composite32_bwd.launches - before)
    print("lab-closure " + json.dumps(rec), flush=True)
    if rec["bwd_launches"] != 1:
        fail("lab closure: the gradient did not go through composite32_bwd")
    if not np.all(np.isfinite(g)) or rel >= LAB_MAX_REL or cos <= LAB_MIN_COS:
        fail(f"lab closure: max rel {rel:.4f} (limit {LAB_MAX_REL}), "
             f"cosine {cos:.6f} (limit {LAB_MIN_COS})")
    return rec


def phase_kernels16(dev, gm, cam, gt1):
    """B3', B3 and B4 against their plain versions on the room map at the
    first frame's pose, at the shapes the paths give them: 16-px plans at
    s=4/2/1 as the tracker builds them (beside B1' on the same levels in
    phase_kernels), a fresh 16-px plan at s=1 (window visibility and color
    refinement renders) and the mapping plan at s=1 (radius_scale 1.1, pad
    6, opa_growth 2.23: every mapping iteration). B4 runs on the mapping
    plan under the mapping loss's cotangent against ``gt1`` and a seeded
    one."""
    recs = []
    for s in (4, 2, 1):
        cam_l = tracking._cam_level(cam, s)
        lp = (0.3 + (s * s - 1) / 12.0) / (s * s) if s > 1 else 0.3
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam_l.w2c(), cam_l.projection(), torch.zeros(6, device=dev),
            cam_l.fx, cam_l.fy, cam_l.width, cam_l.height, cam_l.tanfovx,
            cam_l.tanfovy, low_pass=lp)
        cap = PAIR_CAP if s == 1 else PAIR_CAP // 2
        feat, ranges, n_tx, n_ty, plan = pair_rows(
            prep, cam_l.width, cam_l.height, cap, 1.1, max(2.0, 4.0 / s),
            tile16=True)
        recs.append(kernel_case(f"room_s{s}", feat, ranges, n_tx, n_ty,
                                cam_l.width, cam_l.height, False,
                                tile16=True, time_plain=False))
    prep = level_prep_fn(dev, gm, cam, 0.3)(torch.zeros(6, device=dev))
    for case, kw, forms in (
            ("room_s1_fresh16", {}, [(True, False, True),
                                     (False, False, False)]),
            ("room_s1_map16", dict(radius_scale=1.1, radius_pad=6.0,
                                   opa_growth=2.23),
             [(False, False, True), (True, False, False),
              (True, True, False)])):
        feat, ranges, n_tx, n_ty, plan = pair_rows(prep, W, H, PAIR_CAP,
                                                   tile16=True, **kw)
        print(f"{case}: {int(plan.num_pairs)} pairs, overflow "
              f"{int(plan.overflow)}", flush=True)
        for with_nt, nt_w, timed in forms:
            recs.append(kernel_case(case, feat, ranges, n_tx, n_ty, W, H,
                                    with_nt, nt_w, tile16=True,
                                    time_plain=timed))
    b4 = b2_case("room_s1_map16", dev, level_prep_fn(dev, gm, cam, 0.3), W,
                 H, PAIR_CAP, 1.1, 6.0, gt1, seed=6, tile16=True,
                 opa_growth=2.23, cot_fn=mapping_cotangent)
    return recs, b4


def render16_vs_32(dev, gm, cam):
    """render(tile16=True) against render(tile16=False) on the room map at
    the first frame's pose, on fresh plans: with the reference's packed
    int32 sort key (reported: the 16-px grid keeps 2 fewer depth bits, so
    depth ties composite in emission order), and re-sorted on the full
    depth key (gated: every pixel within T16_FULL_KEY_TOL, n_touched
    equal)."""
    bg = torch.zeros(3, device=dev)
    prep = level_prep_fn(dev, gm, cam, 0.3)(torch.zeros(6, device=dev))
    rec = dict(card=card_line())
    for key in ("packed_key", "full_key"):
        outs = []
        for t16 in (False, True):
            plan = make_plan(prep, W, H, PAIR_CAP, active=gm.active,
                             tile16=t16)
            if key == "full_key":
                plan = resort_full_depth_key(plan, prep.depth)
            outs.append(render(gm, cam, None, bg, plan=plan, tile16=t16,
                               device=dev))
        torch.cuda.synchronize()
        r = {}
        for name in ("color", "depth", "opacity"):
            diff = (getattr(outs[0], name) - getattr(outs[1], name)).abs()
            diff = diff.amax(dim=0)
            r[name] = dict(max=float(diff.max()),
                           frac_over_1e5=float((diff > 1e-5).float().mean()))
        nt32, nt16 = (o.n_touched.double() for o in outs)
        r.update(nt_gaussians_differing=int((nt32 != nt16).sum()),
                 nt_gaussians_touched=int((nt32 > 0).sum()),
                 nt_total_rel=float((nt32 - nt16).abs().sum() / nt32.sum()),
                 overflow=[int(o.overflow) for o in outs],
                 finite=all(bool(torch.isfinite(o.color).all())
                            for o in outs))
        rec[key] = r
    print("render-tile16-vs-tile32 " + json.dumps(rec), flush=True)
    full = rec["full_key"]
    worst = max(full[n]["max"] for n in ("color", "depth", "opacity"))
    if not all(rec[k]["finite"] for k in ("packed_key", "full_key")):
        fail("render tile16 vs tile32: non-finite render")
    if any(rec[k]["overflow"] != [0, 0] for k in ("packed_key", "full_key")):
        fail("render tile16 vs tile32: plan overflow")
    if worst > T16_FULL_KEY_TOL or full["nt_gaussians_differing"]:
        fail(f"render tile16 vs tile32 with the full depth key: max "
             f"|difference| {worst:.3e} (limit {T16_FULL_KEY_TOL}), "
             f"{full['nt_gaussians_differing']} Gaussians differ in "
             "n_touched")
    return rec


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_bf16_path(dev, gm, cam, poses, gts):
    """``render(bf16=True)`` with n_touched at each pose of ``poses``,
    launch counts from 0: B1-bf16's path. Reports the PSNR of each bf16
    render against the f32 ground truth rendered at the same pose and the
    n_touched mismatches; fails on non-finite output, overflow, or a bf16
    render equal to the f32 one."""
    path_launches.reset()
    bg = torch.zeros(3, device=dev)
    psnrs, nt_diff, diff, finite, ovf = [], [], 0.0, True, 0
    for Tp, gt in zip(poses, gts):
        c = cam.replace(R=torch.as_tensor(Tp[:3, :3], device=dev),
                        t=torch.as_tensor(Tp[:3, 3], device=dev))
        out = render(gm, c, None, bg, pair_capacity=PAIR_CAP, bf16=True,
                     device=dev)
        with uncounted():
            ref = render(gm, c, None, bg, pair_capacity=PAIR_CAP, device=dev)
        img = torch.clamp(out.color, 0, 1)
        psnrs.append(float(losses.psnr(img, gt[0])))
        nt_diff.append(int((out.n_touched != ref.n_touched).sum()))
        diff = max(diff, float((out.color - ref.color).abs().max()))
        finite &= bool(torch.isfinite(out.color).all()
                       and torch.isfinite(out.depth).all())
        ovf = max(ovf, int(out.overflow))
    rec = dict(path="render-bf16", renders=len(psnrs), resolution=f"{W}x{H}",
               psnr_vs_f32=psnrs, n_touched_mismatch=nt_diff,
               max_abs_color_diff=diff, overflow=ovf, finite=finite,
               card=card_line())
    print("render-bf16 " + json.dumps(rec), flush=True)
    counts = read_counts("render-bf16", ("composite32_fwd_ntouch_bf16",),
                         forbidden=("composite32_fwd_ntouch",))
    if not finite or ovf:
        fail(f"render-bf16: non-finite output or overflow {ovf}")
    if diff <= IMG_TOL:
        fail("render-bf16: the bf16 render equals the f32 one")
    return counts


def phase_kernels_bf16(dev, gm, cam, gt1):
    """B1'-bf16, B1-bf16 (also under the blend-weight rule) and B2-bf16
    against their plain bf16 versions, with the f32 kernel's time on the
    same plan: the room's s=2 tracker plan (the IRLS renders under
    kernel_bf16) and its s=1 plan with pad 2 (the exact full-resolution
    iterations and the polish). Plain versions timed where the kernels
    line reads them."""
    fwd, bwd = [], []
    for s, cap, forms in ((2, PAIR_CAP // 2, ((False, False, True),
                                              (True, False, True),
                                              (True, True, False))),
                          (1, PAIR_CAP, ((False, False, False),
                                         (True, False, False)))):
        cam_l = tracking._cam_level(cam, s)
        lp = (0.3 + (s * s - 1) / 12.0) / (s * s) if s > 1 else 0.3
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam_l.w2c(), cam_l.projection(), torch.zeros(6, device=dev),
            cam_l.fx, cam_l.fy, cam_l.width, cam_l.height, cam_l.tanfovx,
            cam_l.tanfovy, low_pass=lp)
        feat, ranges, n_tx, n_ty, plan = pair_rows(
            prep, cam_l.width, cam_l.height, cap, 1.1, 2.0)
        for with_nt, nt_w, timed in forms:
            fwd.append(kernel_case(f"room_s{s}_bf16", feat, ranges, n_tx,
                                   n_ty, cam_l.width, cam_l.height, with_nt,
                                   nt_w, time_plain=timed, bf16=True))
    bwd += b2_case("room_s1_polish_bf16", dev,
                   level_prep_fn(dev, gm, cam, 0.3), W, H, PAIR_CAP, 1.1,
                   2.0, gt1, seed=6, bf16=True)
    cam2 = tracking._cam_level(cam, 2)
    gt2 = (tracking._pool_avg(gt1[0], 2), tracking._stride_center(gt1[1], 2),
           tracking._pool_max(gt1[2], 2))
    bwd += b2_case("room_s2_bf16", dev, level_prep_fn(dev, gm, cam2, 0.3),
                   cam2.width, cam2.height, PAIR_CAP // 2, 1.1, 4.0, gt2,
                   seed=7, time_plain=False, bf16=True)
    return fwd, bwd


def phase_kernels_mxu(dev, gm, cam, gt1):
    """B1'-mxu and B1-mxu against their plain versions on the room's
    tracker plans at s=4/2/1 (as phase_kernels builds them) and at s=2
    under nt_weight, the f32 kernel's time on the same plan beside each;
    B2-mxu and B2-bf16-mxu on the s=1 polish plan (pad 2) and the s=1 pad-8
    plan under the loss cotangent and a seeded one; then the falloff alone
    (mxu_power_check)."""
    fwd, bwd = [], []
    both = [(False, False), (True, False)]
    for s, forms in ((4, [(False, False)]), (2, both + [(True, True)]),
                     (1, both)):
        cam_l = tracking._cam_level(cam, s)
        lp = (0.3 + (s * s - 1) / 12.0) / (s * s) if s > 1 else 0.3
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam_l.w2c(), cam_l.projection(), torch.zeros(6, device=dev),
            cam_l.fx, cam_l.fy, cam_l.width, cam_l.height, cam_l.tanfovx,
            cam_l.tanfovy, low_pass=lp)
        cap = PAIR_CAP if s == 1 else PAIR_CAP // 2
        feat, ranges, n_tx, n_ty, plan = pair_rows(
            prep, cam_l.width, cam_l.height, cap, 1.1, max(2.0, 4.0 / s))
        for with_nt, nt_w in forms:
            fwd.append(kernel_case(f"room_s{s}_mxu", feat, ranges, n_tx,
                                   n_ty, cam_l.width, cam_l.height, with_nt,
                                   nt_w, time_plain=s == 2 and not nt_w,
                                   mxu=True))
        if s == 1:
            power = mxu_power_check(feat, ranges, n_tx)
    for case, pad, seed, timed in (("room_s1_polish", 2.0, 8, True),
                                   ("room_s1_pad8", 8.0, 9, False)):
        for bf16 in (False, True):
            bwd += b2_case(f"{case}_{'bf16_' if bf16 else ''}mxu", dev,
                           level_prep_fn(dev, gm, cam, 0.3), W, H, PAIR_CAP,
                           1.1, pad, gt1, seed=seed,
                           time_plain=timed, bf16=bf16, mxu=True)
    return fwd, bwd, power


def mxu_power_check(feat, ranges, n_tx):
    """csrc/mxu_falloff.cuh alone: the power block of the first chunk of
    the tile with the most pairs (tensor cores, mxu_power_tile) against
    the f32 G6 @ P6 (torch.matmul at precision "highest") and, for scale,
    both against float64; gated at MXU_POWER_TOL."""
    n = (ranges[:, 1] - ranges[:, 0]).cpu()
    tile = int(torch.argmax(n))
    start = int(ranges[tile, 0])
    rows = feat[start:start + min(int(n[tile]), tk.K)].contiguous()
    tx, ty = tile % n_tx, tile // n_tx
    got = tk.mxu_power_tile(rows, tx, ty)
    ref = tk.mxu_power_tile_plain(rows, tx, ty)
    q = torch.arange(tk.P, device=feat.device)
    r64 = rows.double()
    cx, cy = tx * 32 + 15.5, ty * 32 + 15.5
    pxl = (tx * 32 + q % 32).double() - cx
    pyl = (ty * 32 + q // 32).double() - cy
    mxl, myl = r64[:, 0:1] - cx, r64[:, 1:2] - cy
    ca, cb, cc = r64[:, 2:3], r64[:, 3:4], r64[:, 4:5]
    ref64 = torch.zeros(tk.K, tk.P, dtype=torch.float64, device=feat.device)
    ref64[:rows.shape[0]] = (-0.5 * ca * (mxl - pxl) ** 2
                             - cb * (mxl - pxl) * (myl - pyl)
                             - 0.5 * cc * (myl - pyl) ** 2)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    near = ref >= MXU_POWER_FLOOR
    over = d - (MXU_POWER_TOL + 2.0 ** -22 * ref.abs())
    rec = dict(tile=tile, pairs=int(rows.shape[0]),
               max_abs_power=float(ref.abs().max()),
               max_abs_err_vs_f32=float(d.max()),
               max_abs_err_vs_f32_near=float(d[near].max()),
               cells_near=int(near.sum()),
               cells_differing=int((d > 0).sum()),
               max_abs_err_kernel_vs_f64=float((got.double() - ref64).abs()
                                               .max()),
               max_abs_err_f32_vs_f64=float((ref.double() - ref64).abs()
                                            .max()),
               card=card_line())
    print("mxu-power-tile " + json.dumps(rec), flush=True)
    if rec["max_abs_err_vs_f32_near"] > MXU_POWER_TOL \
            or float(over.max()) > 0:
        fail(f"mxu_falloff: power block {rec['max_abs_err_vs_f32_near']:.3e} "
             f"off the f32 G6 @ P6 where power >= {MXU_POWER_FLOOR} (limit "
             f"{MXU_POWER_TOL}), {rec['max_abs_err_vs_f32']:.3e} over the "
             "block (limit 1e-4 + 2 ulp)")
    return rec


@torch.no_grad()
def render_mxu_path(dev, gm, cam, poses):
    """``render(mxu=True)`` with n_touched at each pose of ``poses``, launch
    counts from 0: B1-mxu's path. Each render is held against the f32
    render at the same pose at MXU_RENDER_TOL (color, depth, opacity);
    n_touched mismatches are reported. Fails on non-finite output,
    overflow or a gate."""
    path_launches.reset()
    bg = torch.zeros(3, device=dev)
    diffs = {k: [] for k in MXU_RENDER_TOL}
    nt_diff, finite, ovf = [], True, 0
    for Tp in poses:
        c = cam.replace(R=torch.as_tensor(Tp[:3, :3], device=dev),
                        t=torch.as_tensor(Tp[:3, 3], device=dev))
        out = render(gm, c, None, bg, pair_capacity=PAIR_CAP, mxu=True,
                     device=dev)
        with uncounted():
            ref = render(gm, c, None, bg, pair_capacity=PAIR_CAP, device=dev)
        for k in diffs:
            diffs[k].append((getattr(out, k) - getattr(ref, k)).abs()
                            .flatten())
        nt_diff.append(int((out.n_touched != ref.n_touched).sum()))
        finite &= bool(torch.isfinite(out.color).all()
                       and torch.isfinite(out.depth).all())
        ovf = max(ovf, int(out.overflow))
    diffs = {k: torch.cat(v) for k, v in diffs.items()}
    every = torch.cat(list(diffs.values()))
    over = sum(int((diffs[k] > MXU_RENDER_TOL[k]).sum()) for k in diffs)
    maxes = {k: float(d.max()) for k, d in diffs.items()}
    p999 = float(torch.quantile(every[:1 << 24], 0.999))
    rec = dict(path="render-mxu", renders=len(poses), resolution=f"{W}x{H}",
               max_abs_diff_vs_f32=maxes, p999_abs_diff=p999,
               values=int(every.numel()), values_over_mxu_tol=over,
               n_touched_mismatch=nt_diff, overflow=ovf, finite=finite,
               card=card_line())
    print("render-mxu " + json.dumps(rec), flush=True)
    counts = read_counts("render-mxu", ("composite32_fwd_ntouch_mxu",),
                         forbidden=("composite32_fwd_ntouch",))
    if not finite or ovf:
        fail(f"render-mxu: non-finite output or overflow {ovf}")
    if over > MXU_FLIP_FRAC * every.numel() \
            or any(maxes[k] > MXU_RENDER_FLIP_TOL[k] for k in maxes):
        fail(f"render-mxu: against the f32 renders {maxes}, {over} values "
             f"above {MXU_RENDER_TOL} (limits: {MXU_FLIP_FRAC:.0e} of the "
             f"values, each within {MXU_RENDER_FLIP_TOL})")
    return counts


def phase_abl16(dev):
    """B5: each variant of csrc/abl16.cu (one CTA per 16x16 subtile)
    against the plain version at a small shape (4 x 3 groups) on the
    script's plan and on a plan whose rect16 columns admit every cell
    (1e-5 relative), then the script's own run (scripts/abl16.py's main:
    1216x704, NC=2) with the launch counts from 0 (the launches line): per
    variant ms, us/chunk, the bound and its share of the time, the error
    at the script's shape and the plain version's time there."""
    recs = {}

    def rel_err(a, b):
        return float(((a - b).abs() / b.abs()).max())

    for v in abl16.VARIANTS:
        rel = err = 0.0
        for make, nc in ((abl16.make_inputs, 1),
                         (abl16.make_admitting_inputs, 2)):
            feat, ranges = make(4, 3, nc, device=dev)
            got = abl16.run(feat, ranges, 4, 3, 128, 96, nc, v)
            ref = abl16.run_plain(feat, ranges, 4, 3, 128, 96, nc, v)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"abl16_{v}: non-finite output")
            rel = max(rel, rel_err(got, ref))
            err = max(err, float((got - ref).abs().max()))
        recs[v] = dict(max_rel_err=rel, max_abs_err=err)
        if not rel <= 1e-5:
            fail(f"abl16_{v}: kernel differs from plain by {rel:.3e} "
                 "relative (limit 1e-5)")
    sh = abl16.SHAPE
    n_gx, n_gy, w, h = sh["n_gx"], sh["n_gy"], sh["W"], sh["H"]
    nc = 2
    feat, ranges = abl16.make_inputs(n_gx, n_gy, nc, device=dev)
    chunks = 4 * n_gx * n_gy * nc
    # the script's run (its main), launch counts from 0
    abl16.run.launches = {v: 0 for v in abl16.VARIANTS}
    for v in abl16.VARIANTS:
        recs[v]["ms"] = time_ms(lambda: abl16.run(
            feat, ranges, n_gx, n_gy, w, h, nc, v))
    launches = dict(abl16.run.launches)
    for v in abl16.VARIANTS:
        bnd, by = abl16.bound_ms(ranges, n_gx, n_gy, nc, v)
        ms = recs[v]["ms"]
        recs[v].update(us_per_chunk=ms * 1e3 / chunks, bound_ms=bnd,
                       bound_by=by, bound_pct=100.0 * bnd / ms)
        with torch.no_grad():
            got = abl16.run(feat, ranges, n_gx, n_gy, w, h, nc, v)
            ref = abl16.run_plain(feat, ranges, n_gx, n_gy, w, h, nc, v)
            recs[v]["max_rel_err_script_shape"] = rel_err(got, ref)
        recs[v]["plain_ms"] = time_ms(lambda: abl16.run_plain(
            feat, ranges, n_gx, n_gy, w, h, nc, v), reps=1, warm=1)
        recs[v]["launches"] = launches[v]
        if recs[v]["max_rel_err_script_shape"] > 1e-5:
            fail(f"abl16_{v}: at the script's shape the kernel differs from "
                 f"plain by {recs[v]['max_rel_err_script_shape']:.3e}")
        if launches[v] == 0:
            fail(f"abl16_{v}: the script's run never launched the kernel")
        r = recs[v]
        print(f"abl16 {v:9s} {r['ms']:8.3f} ms {r['us_per_chunk']:7.3f} "
              f"us/chunk  bound {r['bound_ms']:.3f} ms ({r['bound_by']}; "
              f"{r['bound_pct']:.1f}%)  plain {r['plain_ms']:.1f} ms",
              flush=True)
    print("abl16 " + json.dumps(dict(shape=f"{w}x{h}", chunks=chunks,
                                     variants=recs, card=card_line())),
          flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 2: the fused preprocess (P1) against its plain version
# ---------------------------------------------------------------------------

# tum-map's mapping backend starts its map at 2^16 slots and doubles it as
# it fills (2^18 in its longest runs so far); the check takes one doubling
# more. Each capacity holds the room map's first min(N_ROOM, capacity)
# Gaussians, the rest inactive, seen at 640x480 with TUM fr1/desk's
# intrinsics from inside the room.
PREP_CAPACITIES = (1 << 16, 1 << 17, 1 << 18, 1 << 19)
TUM_FX, TUM_FY, TUM_CX, TUM_CY, TUM_W, TUM_H = (517.306, 516.469, 318.643,
                                                255.314, 640, 480)
# bytes a capacity slot moves at SH degree 0 (csrc/preprocess.cu): the
# forward reads the raw parameters (56), the offset (8) and the mask (1)
# and writes the table (64), aux (32), rect (16), tiles_touched (4) and
# valid (1); the backward reads the parameters (56) and 10 columns of the
# table's gradient (40) and writes the parameters' gradients (56: xyz 12,
# scaling 12, rotation 16, opacity 4, features_dc 12) and the offset's (8)
PREP_FWD_BYTES = 56 + 8 + 1 + 64 + 32 + 16 + 4 + 1
PREP_BWD_BYTES = 56 + 40 + 56 + 8
PREP_KERNELS = ("preprocess_fwd", "preprocess_bwd")
PREP_CALLS = 20       # calls a timing or a profiled pass issues back to back
# the forward's fields and the backward's per-Gaussian gradients must equal
# the plain versions' bit for bit (the benchmark's gradient checks see the
# rounding of a thin splat's conic); tau, a sum over every slot in another
# order, within 1e-5 of its largest component; the integer fields may flip
# where a value rounds across a threshold, in at most 1e-5 of the rows
PREP_TAU_REL = 1e-5
PREP_FLIP_FRAC = 1e-5


def cublas_version():
    """(version, path) of the cuBLAS library this process has loaded
    (cublasGetProperty), or (None, None)."""
    import ctypes
    torch.ones(4, 3, device="cuda") @ torch.ones(3, 3, device="cuda")
    torch.cuda.synchronize()
    with open("/proc/self/maps") as f:
        paths = sorted({ln.split()[-1] for ln in f if "libcublas.so" in ln})
    for path in paths:
        try:
            lib = ctypes.CDLL(path)
            parts = [ctypes.c_int() for _ in range(3)]
            if all(lib.cublasGetProperty(i, ctypes.byref(v)) == 0
                   for i, v in enumerate(parts)):
                return ".".join(str(v.value) for v in parts), path
        except (OSError, AttributeError):
            continue
    return None, None


def tum_room_maps(dev, capacities):
    """For each of ``capacities``: (capacity, the room map's first
    min(N_ROOM, capacity) Gaussians in that many slots, the rest inactive,
    the camera inside the room at 640x480 with TUM fr1/desk's
    intrinsics)."""
    m = make_room_map(N_ROOM, np.random.default_rng(1))
    T = se3_exp(torch.tensor([0.05, -0.02, 0.4, 0.02, -0.05, 0.01],
                             dtype=torch.float64))
    tum = Camera.create(T[:3, :3].numpy(), T[:3, 3].numpy(), TUM_FX, TUM_FY,
                        TUM_CX, TUM_CY, TUM_W, TUM_H, device=dev)
    for cap in capacities:
        k = min(N_ROOM, cap)
        yield cap, gmap.from_numpy(**{f: v[:k] for f, v in m.items()},
                                   max_sh_degree=0, capacity=cap,
                                   device=dev), tum


def back_to_back(fn, calls):
    """A function that calls ``fn`` ``calls`` times."""
    def run():
        for _ in range(calls):
            fn()
    return run


def prep_case(name, gm, cam, seed, time_it):
    """preprocess_fwd and preprocess_bwd on ``gm`` at ``cam`` (a seeded
    tau and screen-space offset, the map's active mask, as a mapping render
    calls them) against preprocess_plain and preprocess_bwd_plain; under
    ``time_it`` each call's wall (CUDA events over PREP_CALLS calls, per
    call, median of 7) beside the plain version's (forward, and forward
    with autograd's backward) and the bound; the device times come from
    the deferred profiled pass (prep_profile)."""
    dev, n, deg = gm.device, gm.capacity, gm.active_sh_degree
    params = [getattr(gm, f) for f in pf.PREP_PARAMS]
    g = torch.Generator(device=dev).manual_seed(seed)
    tau = 0.01 * torch.randn(6, generator=g, device=dev)
    m2o = 0.5 * torch.randn(n, 2, generator=g, device=dev)
    # the gather's backward hands the table's gradient over transposed
    g_table = torch.randn(16, n, generator=g, device=dev).T
    out = pf.preprocess_fwd(params, deg, cam, tau, m2o, gm.active)
    got = pf._views(out)
    table, ref = pf.preprocess_plain(params, deg, cam, tau, m2o, gm.active)
    gb = pf.preprocess_bwd(params, deg, cam, tau, g_table)
    rb = pf.preprocess_bwd_plain(params, deg, cam, tau, g_table)
    torch.cuda.synchronize()
    floats = ("depth", "mean2d", "conic", "cov2d", "opacity", "color")
    fwd_err = max(float((getattr(got, k) - getattr(ref, k)).abs().max())
                  for k in floats)
    fwd_equal = {k: bool(torch.equal(getattr(got, k), getattr(ref, k)))
                 for k in floats}
    fwd_equal["table"] = bool(torch.equal(out.table, table))
    flips = int(((got.valid != ref.valid) | (got.radius != ref.radius)
                 | (got.rect_min != ref.rect_min).any(-1)
                 | (got.rect_max != ref.rect_max).any(-1)
                 | (got.tiles_touched != ref.tiles_touched)
                 | (got.radius_xy != ref.radius_xy).any(-1)).sum())
    groups = (*pf.PREP_PARAMS, "mean2d_offset")
    bwd_equal = {k: bool(torch.equal(gb[k], rb[k])) for k in groups}
    bwd_err = max(float((gb[k] - rb[k]).abs().max()) for k in groups
                  if gb[k].numel())
    finite = all(bool(torch.isfinite(x).all())
                 for x in (out.table, *(gb[k] for k in groups), gb["tau"]))
    tau_scale = float(rb["tau"].abs().max())
    tau_err = float((gb["tau"] - rb["tau"]).abs().max())
    again = pf.preprocess_bwd(params, deg, cam, tau, g_table)["tau"]
    rec = dict(case=name, capacity=n, active=int(gm.active.sum()),
               valid=int(ref.valid.sum()), shape=f"{cam.width}x{cam.height}",
               fwd_max_abs_err=fwd_err, fwd_bit_equal=fwd_equal,
               int_flips=flips, bwd_max_abs_err=bwd_err,
               bwd_bit_equal=bwd_equal, tau_max_abs_err=tau_err,
               tau_scale=tau_scale,
               tau_repeat_equal=bool(torch.equal(again, gb["tau"])),
               bound_fwd_ms=PREP_FWD_BYTES * n / HBM_BYTES_PER_S * 1e3,
               bound_bwd_ms=PREP_BWD_BYTES * n / HBM_BYTES_PER_S * 1e3)
    if not finite:
        fail(f"{name}: non-finite preprocess kernel output")
    if not all(fwd_equal.values()) or flips > PREP_FLIP_FRAC * n:
        fail(f"{name}: the preprocess forward kernel is not the plain "
             f"version bit for bit ({fwd_equal}, max |diff| {fwd_err:.3e}, "
             f"{flips} of {n} rows with an integer field flipped)")
    if not all(bwd_equal.values()):
        fail(f"{name}: the preprocess backward kernel is not the plain "
             f"version bit for bit ({bwd_equal}, max |diff| {bwd_err:.3e})")
    if not (0 < tau_scale and tau_err <= PREP_TAU_REL * tau_scale) \
            or not rec["tau_repeat_equal"]:
        fail(f"{name}: dL/dtau {tau_err:.3e} from the plain version's "
             f"(largest component {tau_scale:.3e}, limit {PREP_TAU_REL} of "
             f"it), the same from two launches: {rec['tau_repeat_equal']}")

    def fwd():
        pf.preprocess_fwd(params, deg, cam, tau, m2o, gm.active)

    def bwd():
        pf.preprocess_bwd(params, deg, cam, tau, g_table)

    def plain_fwd():
        leaves = [p.detach().requires_grad_() for p in params]
        tau_l = tau.clone().requires_grad_()
        m2o_l = m2o.clone().requires_grad_()
        t, _ = pf.preprocess_plain(leaves, deg, cam, tau_l, m2o_l, gm.active)
        return t, leaves + [tau_l, m2o_l]

    def plain_fwd_bwd():
        t, leaves = plain_fwd()
        torch.autograd.grad(t, leaves, g_table, allow_unused=True)

    fns = dict(fwd=fwd, bwd=bwd, plain_fwd=plain_fwd,
               plain_fwd_bwd=plain_fwd_bwd)

    fns = {k: back_to_back(fn, PREP_CALLS) for k, fn in fns.items()}
    if time_it:
        for k, fn in fns.items():
            rec[f"{k}_wall_ms"] = time_ms(fn) / PREP_CALLS
    print("preprocess-vs-plain " + json.dumps(rec), flush=True)
    return rec, fns


def phase_preprocess(dev, gm, cam):
    """P1, the fused preprocess: at the main path's capacity (the room
    map, all 200,000 slots active, at the first frame's camera) and at
    PREP_CAPACITIES (tum-map's), each wrapper against its plain version
    (prep_case), with the versions of torch, CUDA and cuBLAS whose
    rounding the forward mirrors. Returns the records (timed: the main
    path's, 2^16 and 2^18) and the deferred profiled pass that adds each
    timed record's device times."""
    cublas, path = cublas_version()
    print("preprocess versions " + json.dumps(dict(
        torch=torch.__version__, cuda=torch.version.cuda, cublas=cublas,
        cublas_path=path, card=card_line())), flush=True)
    rec, f = prep_case("main_path_room", gm, cam, 0, True)
    recs, fns = [rec], [f]
    for cap, g, tum in tum_room_maps(dev, PREP_CAPACITIES):
        rec, f = prep_case(f"tum_{cap}", g, tum, cap,
                           cap in (1 << 16, 1 << 18))
        recs.append(rec)
        fns.append(f)

    def prep_profile():
        """Device time a call of each of the timed records' functions
        takes (torch.profiler over PREP_CALLS calls; kernels, copies and
        fills), into the records."""
        for rec, f in zip(recs, fns):
            if "fwd_wall_ms" not in rec:
                continue
            for k, fn in f.items():
                p = profile_call(fn, f"profile-preprocess-{rec['case']}-{k}")
                rec[f"{k}_device_ms"] = p["device_busy_ms"] / PREP_CALLS
                rec[f"{k}_launches"] = p["kernel_launches"] / PREP_CALLS
            print("preprocess-profile " + json.dumps(rec), flush=True)
    return recs, prep_profile


# ---------------------------------------------------------------------------
# phase 2: the pair gather's kernels (P2) against their plain versions
# ---------------------------------------------------------------------------

# The main path's renders (the room map at 1200x680 and PAIR_CAP pairs,
# pad 4, with its s=2 and s=4 pyramid levels at 2^19 pairs, pad 2) and
# tum-map's mapping renders: pair capacity 2^20 at 640x480, the map in 2^18
# slots (tum-map's) or 2^17 (tum-mono-map's pruned map), the room map's
# first min(N_ROOM, slots) Gaussians active, seen as phase_preprocess sees
# them. Bytes a call needs (P2's bound at HBM_BYTES_PER_S): the forward
# reads gid1 (4 B a slot) and each kept pair's table row (64 B) and writes
# every slot's row (64 B); the backward reads the emitted pairs' indices (4
# B), the kept pairs' gradient rows (64 B) and the segments (8 B a slot)
# and writes the table's gradient (64 B a slot).
PG_PAIR_CAP = 1 << 20
PG_LEVEL_CAP = 1 << 19
PG_CAPACITIES = (1 << 18, 1 << 17)
PG_CALLS = 20
# the backward against the float64 segment sum: each column's norm of the
# difference within PG_BWD_REL of the column's norm (a direct float32 sum
# of at most a few hundred terms a Gaussian)
PG_BWD_REL = 1e-6
PG_KERNELS = ("pair_gather_fwd", "segment_reduce_fwd")


def pg_case(name, gm, cam, seed, pair_cap=PG_PAIR_CAP, pad=2.0,
            time_it=True):
    """pair_gather_fwd and segment_reduce_fwd on the plan of ``gm`` at
    ``cam`` (``pair_cap`` pairs, radius pad ``pad``) against
    pair_gather_plain and segment_reduce_plain: the forward equal, the
    backward's gap to the float64 segment sum (and the plain version's),
    F = 1 touch counts exact, two backward launches the same; under
    ``time_it`` each call's wall (CUDA events over PG_CALLS calls, median
    of 7) beside the plain version's and the bound."""
    dev = gm.device
    with torch.no_grad():
        table, prep = pf.map_preprocess(gm, cam, active=gm.active)
    plan = make_plan(prep, cam.width, cam.height, pair_cap, radius_pad=pad)
    b_al, n = plan.pair_gid1.shape[0], gm.capacity
    g = torch.Generator(device=dev).manual_seed(seed)
    dfeat = torch.randn(b_al, 16, generator=g, device=dev)
    counts = torch.randint(0, 1025, (b_al,), generator=g, device=dev).float()
    feat = pg.pair_gather_fwd(table, plan)
    ref_feat = pg.pair_gather_plain(table, plan)
    got = pg.segment_reduce_fwd(dfeat, plan)
    again = pg.segment_reduce_fwd(dfeat, plan)
    plain = pg.segment_reduce_plain(dfeat, plan)
    ref = pg.segment_reduce_plain(dfeat.double(), plan)
    nt = pg.segment_reduce_fwd(counts[:, None], plan)
    nt_ref = pg.segment_reduce_plain(counts[:, None].double(), plan)
    torch.cuda.synchronize()
    norm = ref.norm(dim=0)
    pairs, kept = int(plan.num_pairs), int(plan.num_kept)
    rec = dict(case=name, capacity=n, active=int(gm.active.sum()),
               pair_capacity=pair_cap, b_al=b_al, num_pairs=pairs,
               num_kept=kept, overflow=int(plan.overflow),
               shape=f"{cam.width}x{cam.height}",
               fwd_equal=bool(torch.equal(feat, ref_feat)),
               bwd_rel_gap=float(((got.double() - ref).norm(dim=0)
                                  / norm).max()),
               plain_bwd_rel_gap=float(((plain.double() - ref).norm(dim=0)
                                        / norm).max()),
               bwd_max_abs_err=float((got.double() - ref).abs().max()),
               plain_bwd_max_abs_err=float((plain.double() - ref)
                                           .abs().max()),
               ntouch_exact=bool(torch.equal(nt.double(), nt_ref)),
               repeat_equal=bool(torch.equal(got, again)),
               bound_fwd_ms=(4 * b_al + 64 * kept + 64 * b_al)
               / HBM_BYTES_PER_S * 1e3,
               bound_bwd_ms=(4 * pairs + 64 * kept + 8 * n + 64 * n)
               / HBM_BYTES_PER_S * 1e3)
    if not rec["fwd_equal"]:
        fail(f"{name}: the pair gather kernel is not the plain version")
    if not (rec["bwd_rel_gap"] <= PG_BWD_REL and rec["repeat_equal"]
            and rec["ntouch_exact"]):
        fail(f"{name}: the segment sum kernel is {rec['bwd_rel_gap']:.3e} "
             f"from the float64 sum (limit {PG_BWD_REL}), the same from two "
             f"launches: {rec['repeat_equal']}, touch counts exact: "
             f"{rec['ntouch_exact']}")

    fns = dict(fwd=lambda: pg.pair_gather_fwd(table, plan),
               bwd=lambda: pg.segment_reduce_fwd(dfeat, plan),
               plain_fwd=lambda: pg.pair_gather_plain(table, plan),
               plain_bwd=lambda: pg.segment_reduce_plain(dfeat, plan))

    fns = {k: back_to_back(fn, PG_CALLS) for k, fn in fns.items()}
    if time_it:
        for k, fn in fns.items():
            rec[f"{k}_wall_ms"] = time_ms(fn) / PG_CALLS
    print("pair-gather-vs-plain " + json.dumps(rec), flush=True)
    return rec, fns


def phase_pair_gather(dev, gm, cam):
    """P2, the pair gather and its segment-sum backward (pg_case): the
    main path's plan (the room map at ``cam``, PAIR_CAP pairs, pad 4) and
    its s=2 and s=4 levels (PG_LEVEL_CAP pairs, pad 2; checked, not
    timed), then tum-map's mapping plan (PG_PAIR_CAP pairs at 640x480)
    over the room map in each of PG_CAPACITIES slots. Returns the records
    (the main path's first) and the deferred profiled pass that adds each
    timed call's device time and launches."""
    rec, f = pg_case("main_path_room", gm, cam, 0, PAIR_CAP, 4.0)
    recs, fns = [rec], [f]
    for s in (2, 4):
        rec, f = pg_case(f"main_path_room_s{s}", gm,
                         tracking._cam_level(cam, s), s, PG_LEVEL_CAP, 2.0,
                         time_it=False)
        recs.append(rec)
        fns.append(f)
    for cap, g, tum in tum_room_maps(dev, PG_CAPACITIES):
        rec, f = pg_case(f"tum_{cap}", g, tum, cap)
        recs.append(rec)
        fns.append(f)

    def pg_profile():
        for rec, f in zip(recs, fns):
            if "fwd_wall_ms" not in rec:
                continue
            for k, fn in f.items():
                p = profile_call(fn, f"profile-pair-gather-{rec['case']}-{k}")
                rec[f"{k}_device_ms"] = p["device_busy_ms"] / PG_CALLS
                rec[f"{k}_launches"] = p["kernel_launches"] / PG_CALLS
            print("pair-gather-profile " + json.dumps(rec), flush=True)
    return recs, pg_profile


# bench.py's operating point (BENCH_r05.json detail) without its adaptive
# steps: the schedule every tracked frame of the main path runs
BENCH_KW = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
                alpha=0.95, pair_capacity=PAIR_CAP, levels=(4, 2, 1),
                level_iters=(5, 12, 2), level_exact=(0, 0, 0), curv="flow",
                final_level=2, match_blur=True, plan_pad=4.0,
                pair_capacity_ceiling=PAIR_CAP)
# the schedule bench.py had adapted to when it recorded BENCH_r05.json
# (s=4 level dropped, pad 2, per-level capacity buckets): run once more
# and held to the JAX tracker's pose error there (R05_JAX_ERR_MEAN_M)
R05_KW = dict(BENCH_KW, level_iters=(0, 12, 2), plan_pad=2.0,
              pair_capacity=655360, level_caps=(393216, 393216, 655360))
PLAN_REUSE = 2
# track_frame_pyr at the reference's own defaults (the frontend's
# pyr_exact: null configuration): every iteration exact, FD curvature
# probed at the coarse levels, pad 8, full-resolution keyframing render;
# no plan or H carried across frames
EXACT_KW = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
                alpha=0.95, pair_capacity=PAIR_CAP, levels=(4, 2, 1),
                level_iters=(5, 3, 12), level_exact=None, curv="fd",
                probe_levels="coarse", plan_pad=8.0, final_level=1)


def render_ground_truth(dev, gm, cam, poses, tile16=False):
    bg = torch.zeros(3, device=dev)
    gts, overflow = [], 0
    for Tp in poses:
        c = cam.replace(R=torch.as_tensor(Tp[:3, :3], device=dev),
                        t=torch.as_tensor(Tp[:3, 3], device=dev))
        out = render(gm, c, None, bg, pair_capacity=PAIR_CAP, tile16=tile16,
                     device=dev)
        img = torch.clamp(out.color, 0, 1)
        mask = losses.compute_grad_mask(img.mean(dim=0, keepdim=True),
                                        edge_threshold=1.1,
                                        dataset_type="replica")
        gts.append((img, out.depth, mask))
        overflow = max(overflow, int(out.overflow))
        if not (torch.isfinite(img).all() and torch.isfinite(out.depth).all()):
            fail("non-finite ground-truth render")
    return gts, overflow


def track_sequence(dev, gm, cam, gts, poses, kw, collect, polish=False,
                   carry_H=True, reuse_plans=True):
    """Track frames 1..F-1, each warm-started from the previous estimates
    (constant-acceleration prediction once three are known, as bench.py).
    With ``carry_H``, hand each frame's H to the next (H_in); with
    ``reuse_plans``, rebuild the pair plans every PLAN_REUSE frames only;
    with ``polish``, follow every frame with
    polish_frame at full resolution and keep the polished pose, as the
    frontend does on keyframe creation. Host reads (errors, counts) only
    when ``collect``."""
    bg = torch.zeros(3, device=dev)
    R_est = torch.as_tensor(poses[0][:3, :3], device=dev)
    t_est = torch.as_tensor(poses[0][:3, 3], device=dev)
    R_pp = t_pp = R_ppp = t_ppp = None
    H_carry = None
    plan_carry, plan_age = None, 0
    stats = dict(errs=[], errs_irls=[], iters=0, polish_iters=0, npairs=None,
                 overflow=0, finite=True)
    for k in range(1, FRAMES):
        if R_ppp is not None:
            R_ws, t_ws = ca_start(R_est, t_est, R_pp, t_pp, R_ppp, t_ppp)
        elif R_pp is not None:
            R_ws, t_ws = cv_start(R_est, t_est, R_pp, t_pp)
        else:
            R_ws, t_ws = R_est, t_est
        R_ppp, t_ppp = R_pp, t_pp
        R_pp, t_pp = R_est, t_est
        use_plan = (plan_carry if reuse_plans and plan_age < PLAN_REUSE
                    else None)
        res = tracking.track_frame_pyr(
            gm, cam, R_ws, t_ws, gts[k][0], gts[k][1], gts[k][2], bg,
            H_in=H_carry if carry_H and k > 1 else None, plan_in=use_plan,
            device=dev, **kw)
        R_est, t_est = res[0], res[1]
        H_carry = res[7]
        if use_plan is None:
            plan_carry, plan_age = res[11], 1
        else:
            plan_age += 1
        if polish:
            t_irls = t_est
            pol = tracking.polish_frame(
                gm, cam, R_est, t_est, res[2], res[3], gts[k][0], gts[k][1],
                gts[k][2], bg, kw["rgb_boundary_threshold"],
                alpha=kw["alpha"], pair_capacity=PAIR_CAP, device=dev)
            R_est, t_est = pol[0], pol[1]
        if collect:
            t_gt = torch.as_tensor(poses[k][:3, 3])
            out = res[5]
            stats["finite"] &= bool(
                torch.isfinite(out.color).all()
                and torch.isfinite(out.depth).all()
                and torch.isfinite(R_est).all()
                and torch.isfinite(t_est).all())
            stats["iters"] += int(res[4])
            stats["errs"].append(float(torch.linalg.norm(
                t_est.cpu() - t_gt)))
            if polish:
                stats["polish_iters"] += int(pol[4])
                stats["errs_irls"].append(float(torch.linalg.norm(
                    t_irls.cpu() - t_gt)))
                # the plan polish_frame built (same pose, pad, capacity)
                pp = make_render_plan(
                    gm, cam.replace(R=res[0], t=res[1]),
                    pair_capacity=PAIR_CAP, radius_scale=1.1,
                    radius_pad=2.0, device=dev)
                stats["overflow"] = max(stats["overflow"], int(pp.overflow))
            lp = res[10].cpu().numpy().astype(np.int64)
            stats["npairs"] = (lp if stats["npairs"] is None
                               else np.maximum(stats["npairs"], lp))
            stats["overflow"] = max(stats["overflow"], int(res[8].max()),
                                    int(out.overflow))
    torch.cuda.synchronize()
    return stats


def run_schedule(name, dev, gm, cam, gts, poses, kw, gt_overflow,
                 reps=TIMED_REPS, **track_kw):
    """One collecting (warm) pass, then ``reps`` timed passes. Each pass
    records its wall time and the process's host CPU time (all threads),
    both per tracked frame; ms_per_frame is the median wall.
    ``track_kw`` goes to track_sequence (polish, carry_H, reuse_plans)."""
    t0 = time.perf_counter()
    stats = track_sequence(dev, gm, cam, gts, poses, kw, collect=True,
                           **track_kw)
    warm_s = time.perf_counter() - t0
    walls, cpus = [], []
    for _ in range(reps):
        t0, c0 = time.perf_counter(), time.process_time()
        track_sequence(dev, gm, cam, gts, poses, kw, collect=False,
                       **track_kw)
        walls.append((time.perf_counter() - t0) / (FRAMES - 1) * 1e3)
        cpus.append((time.process_time() - c0) / (FRAMES - 1) * 1e3)
    ms_frame = float(np.median(walls))
    errs = stats["errs"]
    rec = dict(
        schedule=name, n_gaussians=N_ROOM, resolution=f"{W}x{H}",
        frames=FRAMES - 1, level_iters=list(kw["level_iters"]),
        ms_per_frame=ms_frame, ms_per_frame_min=min(walls),
        ms_per_frame_max=max(walls), fps=1e3 / ms_frame,
        host_cpu_ms_per_frame=float(np.median(cpus)),
        iters_per_frame=stats["iters"] / (FRAMES - 1),
        level_pairs=[int(p) for p in stats["npairs"]],
        overflow=max(stats["overflow"], gt_overflow),
        pose_err_mean_m=float(np.mean(errs)),
        pose_err_max_m=float(np.max(errs)), finite=stats["finite"],
        warm_pass_s=warm_s, timed_ms_per_frame=walls,
        timed_host_cpu_ms_per_frame=cpus, card=card_line())
    if stats["errs_irls"]:
        rec.update(polish_iters_per_frame=stats["polish_iters"] / (FRAMES - 1),
                   irls_pose_err_mean_m=float(np.mean(stats["errs_irls"])),
                   irls_pose_err_max_m=float(np.max(stats["errs_irls"])),
                   pose_errs_irls_m=stats["errs_irls"], pose_errs_m=errs)
    print(f"{name} " + json.dumps(rec), flush=True)
    return rec


def phase_profile(dev, gm, cam, gts, poses, name="profile", kw=BENCH_KW,
                  **track_kw):
    """Where a tracked frame's time goes: host syncs per frame (CUDA sync
    debug mode), then one torch.profiler pass (profile_call) for device
    busy time (kernels, copies and fills; the kernels' and the
    compositing kernels' share beside it), device launches and the top
    kernels by device time (table in chiprun_out/track_<name>.txt)."""
    syncs = count_syncs(lambda: track_sequence(
        dev, gm, cam, gts, poses, kw, collect=False, **track_kw))
    prof = profile_call(lambda: track_sequence(
        dev, gm, cam, gts, poses, kw, collect=False, **track_kw),
        f"track_{name}")
    frames = FRAMES - 1
    busy_ms, wall_ms = prof["device_busy_ms"], prof["wall_ms"]
    rec = dict(
        frames=frames, wall_ms_per_frame=wall_ms / frames,
        device_busy_ms_per_frame=busy_ms / frames,
        device_kernel_ms_per_frame=prof["device_kernel_ms"] / frames,
        composite_ms_per_frame=prof["composite_fwd_ms"] / frames,
        composite_bwd_ms_per_frame=prof["composite_bwd_ms"] / frames,
        device_idle_share=prof["device_idle_share"],
        kernel_launches_per_frame=prof["kernel_launches"] / frames,
        host_syncs_per_frame=syncs / frames,
        top=[dict(name=t["name"], ms_per_frame=t["ms"] / frames,
                  calls=t["calls"]) for t in prof["top"]],
        card=card_line())
    print(f"{name} " + json.dumps(rec), flush=True)
    return rec


def count_syncs(fn):
    """Host syncs ``fn`` makes (CUDA sync debug mode warnings)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


KERNELS32 = ("composite32_fwd", "composite32_fwd_ntouch", "composite32_bwd")
KERNELS16 = ("composite16_fwd", "composite16_fwd_ntouch", "composite16_bwd")
KERNELS_BF16 = ("composite32_fwd_bf16", "composite32_fwd_ntouch_bf16",
                "composite32_bwd_bf16")

def read_counts(path, required, forbidden=()):
    """The launch counts since path_launches.reset() (ops/launches.py
    COUNTERS: every hand-written kernel a path launches); fails unless
    every kernel in ``required`` was launched on ``path`` and none in
    ``forbidden``."""
    counts = path_launches.counts()
    print(f"{path} launches: {json.dumps(counts)}", flush=True)
    for name in required:
        if counts[name] == 0:
            fail(f"kernel {name} was never launched on the path {path}")
    for name in forbidden:
        if counts[name]:
            fail(f"kernel {name} was launched on the path {path}")
    return counts


class uncounted:
    """Launches inside the block (evaluation renders) leave the counts as
    they were."""

    def __enter__(self):
        self.saved = path_launches.counts()

    def __exit__(self, *exc):
        for n, (fn, attr) in path_launches.COUNTERS.items():
            setattr(fn, attr, self.saved[n])


def check_path(name, rec, max_err_m=1e-3):
    if not rec["finite"]:
        fail(f"{name}: non-finite tracking output")
    if rec["overflow"] > 0:
        fail(f"{name}: pair-plan overflow {rec['overflow']}")
    if rec["pose_err_mean_m"] > max_err_m:
        fail(f"{name}: mean translation error "
             f"{rec['pose_err_mean_m']:.6f} m > {max_err_m:.6f} m")


def run_frame1(name, fn, max_iters, max_err_m, dev, gm, cam, gts, poses):
    """One full-resolution tracker (track_frame_gn or the Adam
    track_frame) on frame 1 from frame 0's pose: pose error, iterations,
    wall; fails on non-finite output, on overflow (of its final render and
    of the pad-8 plan both trackers build at the warm start) or on a
    translation error of ``max_err_m`` or more (None: the start's)."""
    bg = torch.zeros(3, device=dev)
    R0 = torch.as_tensor(poses[0][:3, :3], device=dev)
    t0_ = torch.as_tensor(poses[0][:3, 3], device=dev)
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    res = fn(gm, cam, R0, t0_, gts[1][0], gts[1][1], gts[1][2], bg,
             lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
             alpha=0.95, max_iters=max_iters, pair_capacity=PAIR_CAP,
             device=dev)
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    R, t, out = res[0], res[1], res[5]
    plan = make_render_plan(gm, cam.replace(R=R0, t=t0_),
                            pair_capacity=PAIR_CAP, radius_scale=1.1,
                            radius_pad=8.0, device=dev)
    rec = dict(
        tracker=name, frame=1, max_iters=max_iters, iters=int(res[4]),
        wall_s=wall, host_cpu_s=cpu,
        pose_err_m=float(torch.linalg.norm(
            t.cpu() - torch.as_tensor(poses[1][:3, 3]))),
        start_err_m=float(np.linalg.norm(poses[1][:3, 3] - poses[0][:3, 3])),
        exposure=[float(res[2]), float(res[3])],
        overflow=max(int(out.overflow), int(plan.overflow)),
        finite=bool(torch.isfinite(out.color).all()
                    and torch.isfinite(R).all() and torch.isfinite(t).all()),
        card=card_line())
    print(f"{name} " + json.dumps(rec), flush=True)
    if not rec["finite"] or rec["overflow"] > 0:
        fail(f"{name}: non-finite output or overflow {rec['overflow']}")
    limit = rec["start_err_m"] if max_err_m is None else max_err_m
    if rec["pose_err_m"] >= limit:
        fail(f"{name}: translation error {rec['pose_err_m']:.6f} m, limit "
             f"{limit:.6f} m")
    return rec


def main_path_full_key(dev, gm, cam, poses, main_rec):
    """The main path's schedule at both tile sizes with every plan
    re-sorted on the full depth key (full_depth_key_plans), frames
    rendered so too: the two tile sizes then composite each pixel's pairs
    in the same order, so the 16x16 tracker must land where the 32x32 one
    does (within TILE16_FULL_KEY_REL) and both under 1 mm. Set beside the
    main path's error, this shows how far the packed keys' depth ties
    move each tile size. Outside the launch counts."""
    with uncounted(), full_depth_key_plans():
        gts_fk, gt_overflow = render_ground_truth(dev, gm, cam, poses)
        runs = {t16: track_sequence(dev, gm, cam, gts_fk, poses,
                                    dict(BENCH_KW, tile16=t16), collect=True)
                for t16 in (False, True)}
    rec = {}
    for t16, st in runs.items():
        rec["tile16" if t16 else "tile32"] = dict(
            pose_err_mean_m=float(np.mean(st["errs"])),
            pose_err_max_m=float(np.max(st["errs"])),
            pose_errs_m=st["errs"], iters_per_frame=st["iters"] / (FRAMES - 1),
            overflow=max(st["overflow"], gt_overflow), finite=st["finite"])
    e16, e32 = (rec[k]["pose_err_mean_m"] for k in ("tile16", "tile32"))
    e_main = main_rec["pose_err_mean_m"]
    rec.update(main_path_err_mean_m=e_main,
               tile16_rel_to_tile32=e16 / e32 - 1.0,
               tile16_rel_to_main_path=e16 / e_main - 1.0,
               card=card_line())
    print("main-path-full-depth-key " + json.dumps(rec), flush=True)
    for k in ("tile16", "tile32"):
        check_path(f"main-path-full-depth-key {k}", rec[k])
    if abs(rec["tile16_rel_to_tile32"]) > TILE16_FULL_KEY_REL:
        fail(f"main-path-full-depth-key: tile16 error {e16:.6f} m is "
             f"{rec['tile16_rel_to_tile32']:+.1%} from tile32's {e32:.6f} m")
    return rec


# ---------------------------------------------------------------------------
# phase 6: the SLAM paths
# ---------------------------------------------------------------------------

def slam_config(**training):
    cfg = {k: {kk: (dict(vv) if isinstance(vv, dict) else vv)
               for kk, vv in v.items()} if isinstance(v, dict) else v
           for k, v in SLAM_CONFIG.items()}
    cfg["Training"].update(training)
    cfg["Dataset"]["single_thread"] = cfg["Training"]["single_thread"]
    return cfg


@torch.no_grad()
def keyframe_psnrs(slam):
    """PSNR of each keyframe's render at its estimated pose against its
    frame (clamped, no exposure)."""
    out, dev = [], slam.device
    for uid in slam.frontend.kf_indices:
        rec = slam.frontend.frames[uid]
        cam = slam.cam.replace(
            R=torch.as_tensor(np.asarray(rec.R, np.float32), device=dev),
            t=torch.as_tensor(np.asarray(rec.t, np.float32), device=dev))
        r = render(slam.backend.gm, cam, None, slam.backend.bg,
                   pair_capacity=slam.backend.pair_capacity,
                   need_n_touched=False, device=slam.device)
        gt = torch.as_tensor(slam.dataset[uid][0], device=slam.device)
        out.append(float(losses.psnr(torch.clamp(r.color, 0, 1), gt)))
    return out


def decode_png(data):
    """(h, w, 3) uint8 of an 8-bit RGB PNG whose rows use filter type 0,
    as the port's encoder (gui/headless.py) writes them; raises on a
    malformed file."""
    import struct
    import zlib
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in {kind!r}")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if depth != 8 or ctype != 2:
        raise ValueError("not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def probe_viewer(slam, min_frame=4, timeout_s=600.0):
    """A thread that waits for ``slam``'s browser viewer, then, once the
    status reports frame ``min_frame`` or later, fetches /status and one
    /frame.png over 127.0.0.1 and decodes the PNG. Returns (thread,
    record dict)."""
    import threading
    import urllib.request
    rec = {}

    def get(url):
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()

    def probe():
        t0 = time.time()
        try:
            while slam.web_viewer is None and time.time() - t0 < timeout_s:
                time.sleep(0.05)
            base = f"http://127.0.0.1:{slam.web_viewer.port}"
            while time.time() - t0 < timeout_s:
                code, body = get(base + "/status")
                st = json.loads(body)
                if st["frame"] >= min_frame:
                    break
                time.sleep(0.2)
            rec.update(status=st, status_code=code)
            t1 = time.perf_counter()
            code, body = get(base + "/frame.png?mode=color&follow=1")
            rec.update(frame_code=code, frame_bytes=len(body),
                       frame_s=time.perf_counter() - t1)
            img = decode_png(body)
            rec.update(frame_shape=list(img.shape),
                       frame_mean=float(img.mean()))
        except Exception as e:      # reported and gated by the caller
            rec["error"] = repr(e)

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    return th, rec


def run_slam(name, dev, dataset, out_root, training, required):
    """One SLAM run through the driver (SLAM.run with the rendering eval
    and SLAM_REFINE_ITERS of color refinement), launch counts from 0.
    Reports the driver's FPS, per-frame track p50/max (frame_log),
    keyframes, final ATE, keyframe PSNR before and after refinement,
    active Gaussians and pair overflow: of the tracking plans and the
    keyframing render of each frame's accepted track (hooks on
    track_frame_pyr and FrontEnd.track; an overflowing track that the
    frontend grew its capacities for and re-tracked counts as a re-track),
    of densify, and of the final window's mapping plans."""
    from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
    from gs_slam_analytica_jacobian_tpu_torch.utils import ply
    save_dir = os.path.join(out_root, name)
    os.makedirs(save_dir, exist_ok=True)
    # the mxu run serves the browser viewer, as slam_main.py --viewer 0
    viewer = training.get("kernel_mxu", False)
    slam = SLAM(slam_config(**training), save_dir=save_dir, dataset=dataset,
                viewer_port=0 if viewer else None, device=dev)
    track_ovf = dict(accepted=0, calls=0, last=0)
    inner_track = tracking.track_frame_pyr
    inner_fe_track = slam.frontend.track

    def track_hook(*args, **kw):
        res = inner_track(*args, **kw)
        track_ovf["calls"] += 1
        track_ovf["last"] = max(int(res[8].max()), int(res[5].overflow))
        return res

    def fe_track(idx, rec):
        out = inner_fe_track(idx, rec)
        track_ovf["accepted"] = max(track_ovf["accepted"], track_ovf["last"])
        return out
    slam.frontend.track = fe_track
    psnr_before = []
    inner_refine = slam.backend.color_refinement

    def refine_hook(*args, **kw):
        with uncounted():
            psnr_before.extend(keyframe_psnrs(slam))
        return inner_refine(*args, **kw)
    slam.backend.color_refinement = refine_hook
    tracking.track_frame_pyr = track_hook
    path_launches.reset()
    if viewer:
        probe, probed = probe_viewer(slam)
    try:
        t0 = time.perf_counter()
        res = slam.run(eval_rendering=True,
                       color_refinement_iters=SLAM_REFINE_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracking.track_frame_pyr = inner_track
    if viewer:
        probe.join(timeout=60)
    counts = read_counts(name, required)
    with uncounted():
        psnr_after = keyframe_psnrs(slam)
        be = slam.backend
        map_ovf = window_overflow(be, be.current_window)
    flog = slam.frontend.frame_log
    track_ms = [1e3 * f["track"] for f in flog]
    gm = be.gm
    ply_path = os.path.join(save_dir, "point_cloud", "final",
                            "point_cloud.ply")
    ply_same = False
    if os.path.isfile(ply_path):
        back = ply.load_ply(ply_path, device=dev)
        act = gm.active
        ply_same = all(torch.equal(getattr(back, f), getattr(gm, f)[act])
                       for f in ("xyz", "features_dc", "features_rest",
                                 "scaling", "rotation", "opacity"))
    densify_ovf = max([int(d["overflow"]) for d in be.densify_log] + [0])
    rec = dict(
        path=name, frames=SLAM_FRAMES, resolution="1216x672",
        fps=res["fps"], wall_s=res["wall_time"], run_s=wall,
        track_ms_p50=float(np.median(track_ms)),
        track_ms_max=float(np.max(track_ms)), frames_tracked=len(flog),
        n_keyframes=len(slam.frontend.kf_indices),
        keyframe_ids=list(slam.frontend.kf_indices), ate_m=res.get("ate"),
        kf_psnr_before_mean=float(np.mean(psnr_before)),
        kf_psnr_after_mean=float(np.mean(psnr_after)),
        render_psnr_before=res["rendering_before_opt"]["mean_psnr"],
        render_psnr_after=res["rendering_after_opt"]["mean_psnr"],
        active_gaussians=int(gm.num_active()),
        overflow=dict(tracking=track_ovf["accepted"], densify=densify_ovf,
                      window=map_ovf),
        tracker_calls=track_ovf["calls"],
        summary_written=os.path.isfile(os.path.join(save_dir,
                                                    "run_summary.json")),
        ply_reloads_same=ply_same, prewarm_s=slam.frontend.prewarm_wall_s,
        refine_iters=SLAM_REFINE_ITERS, launches=counts, card=card_line())
    if viewer:
        rec["viewer"] = probed
    print(f"{name} " + json.dumps(rec), flush=True)
    if viewer and (probed.get("error") or probed.get("frame_code") != 200
                   or probed.get("frame_shape") != [slam.cam.height,
                                                    slam.cam.width, 3]
                   or probed.get("status", {}).get("frame", -1) < 0):
        fail(f"{name}: the viewer did not serve a status and a decodable "
             f"frame during the run: {probed}")
    ate = rec["ate_m"]
    limit = min(SLAM_ATE_MAX_M, SLAM_ATE_REG_M.get(name, SLAM_ATE_MAX_M))
    if ate is None or not np.isfinite(ate) or ate >= limit:
        fail(f"{name}: ATE {ate} m, limit {limit} m")
    if rec["n_keyframes"] < SLAM_MIN_KF:
        fail(f"{name}: {rec['n_keyframes']} keyframes (< {SLAM_MIN_KF})")
    if max(rec["overflow"].values()) > 0:
        fail(f"{name}: pair overflow {rec['overflow']}")
    if not (rec["summary_written"] and rec["ply_reloads_same"]):
        fail(f"{name}: run_summary.json or the ply missing, or the ply "
             "does not reload to the same map")
    if rec["frames_tracked"] != SLAM_FRAMES - 1:
        fail(f"{name}: {rec['frames_tracked']} of {SLAM_FRAMES - 1} frames "
             "tracked")
    return rec


def phase_slam(dev):
    """The SLAM paths on one pre-rendered dataset; slam-bf16 and slam-mxu
    within SLAM_BF16_ATE_REL of slam's ATE."""
    from gs_slam_analytica_jacobian_tpu_torch.utils.datasets import \
        load_dataset
    dataset = load_dataset(slam_config())
    t0 = time.perf_counter()
    for i in range(SLAM_FRAMES):
        dataset[i]
    print(f"slam dataset: {SLAM_FRAMES} frames of the synthetic room "
          f"rendered on the host in {time.perf_counter() - t0:.3f} s",
          flush=True)
    out_root = os.path.join(ROOT, "build", "slam_runs")
    recs, launches = {}, {}
    for name, training, required in SLAM_RUNS:
        recs[name] = run_slam(name, dev, dataset, out_root, training,
                              required)
        launches[name] = recs[name]["launches"]
    a = recs["slam"]["ate_m"]
    for other in ("slam-bf16", "slam-mxu"):
        b = recs[other]["ate_m"]
        if a is not None and b is not None and b > SLAM_BF16_ATE_REL * a:
            fail(f"{other}: ATE {b:.6f} m above {SLAM_BF16_ATE_REL} x "
                 f"slam's {a:.6f} m")
    return recs, launches


# ---------------------------------------------------------------------------
# phase 5: the mapping paths
# ---------------------------------------------------------------------------

def mapping_config(tile16):
    cfg = {k: dict(v) if isinstance(v, dict) else v
           for k, v in MAP_CONFIG.items()}
    cfg["Training"].update(MAP_CUTS, tile16=tile16)
    return cfg


def perturbed(T, rng):
    """T with a seeded left perturbation of MAP_PERTURB_M translation and
    MAP_PERTURB_RAD rotation."""
    rho, theta = rng.normal(size=3), rng.normal(size=3)
    tau = np.concatenate([rho / np.linalg.norm(rho) * MAP_PERTURB_M,
                          theta / np.linalg.norm(theta) * MAP_PERTURB_RAD])
    return se3_exp(torch.as_tensor(tau, dtype=torch.float32)).numpy() @ T


@torch.no_grad()
def keyframe_eval(be, kf_gts, kf_poses, uids):
    """Per keyframe of ``uids``: PSNR of the render at the backend's pose
    (clamped, no exposure, as the reference evaluates), the window's
    mapping loss there (with the stored exposures), and the translation
    error of the stored pose, in mm."""
    psnrs, loss, errs = [], 0.0, []
    for u in uids:
        s = be.uid_to_slot[u]
        cam = be.cam.replace(R=be.store.R[s], t=be.store.t[s])
        out = render(be.gm, cam, None, be.bg, pair_capacity=be.pair_capacity,
                     tile16=be.tile16, need_n_touched=False, device=be.device)
        img, dep = kf_gts[u][0], kf_gts[u][1]
        psnrs.append(float(losses.psnr(torch.clamp(out.color, 0, 1), img)))
        loss += float(losses.loss_mapping_rgbd(
            losses.apply_exposure(out.color, be.store.exposure_a[s],
                                  be.store.exposure_b[s]),
            out.depth, img, dep, be.rgb_boundary_threshold, be.alpha))
        errs.append(1e3 * float(torch.linalg.norm(
            be.store.t[s].cpu() - torch.as_tensor(kf_poses[u][:3, 3]))))
    return psnrs, loss, errs


def window_overflow(be, uids):
    """The largest overflow of the window's mapping plans (the plans
    mapping_steps builds) at the backend's current state."""
    worst = 0
    for u in uids:
        s = be.uid_to_slot[u]
        plan = make_render_plan(
            be.gm, be.cam.replace(R=be.store.R[s], t=be.store.t[s]),
            pair_capacity=be.pair_capacity,
            radius_scale=mapping.PLAN_RADIUS_SCALE,
            radius_pad=mapping.PLAN_RADIUS_PAD, tile16=be.tile16,
            opa_growth=mapping.PLAN_OPA_GROWTH, device=be.device)
        worst = max(worst, int(plan.overflow))
    return worst


def composite_part(kernel):
    """The compositing kernel a device kernel's name belongs to
    (composite32_fwd, composite32_bwd, composite16_fwd, composite16_bwd),
    or None. The sub-tile forward of both tile sizes is one template
    (csrc/subtile_fwd.cuh: composite_fwd_subtile<kNTouch, kNtWeight,
    kBF16, kTile16>), told apart by its last argument."""
    if "composite_fwd_subtile<" in kernel:
        args = kernel.split("composite_fwd_subtile<", 1)[1].split(">", 1)[0]
        tile16 = args.split(",")[-1].strip() in ("true", "(bool)1", "1")
        return "composite16_fwd" if tile16 else "composite32_fwd"
    return next((part for part in ("composite32_fwd", "composite32_bwd",
                                   "composite16_fwd", "composite16_bwd")
                 if f"{part}_kernel" in kernel or f"{part}_subtile" in kernel),
                None)


def profile_call(fn, name):
    """Run ``fn`` once under torch.profiler, device activity only: wall,
    device busy time (kernels, copies and fills) and of it the kernels'
    time and the compositing kernels' (forward and backward, both tile
    sizes), idle share, device launches and the top kernels (table of 40
    in chiprun_out/<name>.txt). The device events are read from the trace
    the profiler exports, not from key_averages(), whose per-event Python
    processing took ~100 s for a mapping keyframe's ~10^5 launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    trace = os.path.join(ROOT, "build", f"trace_{name}.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    agg, kernel_ms = {}, 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, n = agg.get(e["name"], (0.0, 0))
            dur = float(e.get("dur", 0.0)) / 1e3
            agg[e["name"]] = (ms + dur, n + 1)
            kernel_ms += dur if e["cat"] == "kernel" else 0.0
    kern = sorted(((k, ms, n) for k, (ms, n) in agg.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kern)
    comp_ms = {part: sum(r[1] for r in kern if composite_part(r[0]) == part)
               for part in ("composite32_fwd", "composite32_bwd",
                            "composite16_fwd", "composite16_bwd")}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(f"{'device ms':>12} {'calls':>8}  name\n")
        for k, ms, n in kern[:40]:
            f.write(f"{ms:12.3f} {n:8d}  {k}\n")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_kernel_ms=kernel_ms,
                composite_fwd_ms=(comp_ms["composite32_fwd"]
                                  + comp_ms["composite16_fwd"]),
                composite_bwd_ms=(comp_ms["composite32_bwd"]
                                  + comp_ms["composite16_bwd"]),
                device_idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=sum(r[2] for r in kern),
                processing_s=time.perf_counter() - t1,
                top=[dict(name=n[:80], ms=t, calls=c)
                     for n, t, c in kern[:10]])


def time_map_calls(be):
    """Wrap ``be.map`` so that each call's device-synchronized wall is
    appended to the returned list as (prune, seconds): handle_keyframe
    makes one call to map the window and one prune pass."""
    walls, inner = [], be.map

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        walls.append((kw.get("prune", False), time.perf_counter() - t0))
        return out
    be.map = timed
    return walls


def run_mapping(name, dev, cam, kf_gts, kf_poses, tile16, mesh=None):
    """The backend over MAP_KF keyframes, as the frontend would feed it:
    keyframe 0 at its true pose (initialize_map), keyframes 1.. with a
    seeded perturbation, each followed by handle_keyframe over the window
    (newest first). On one rank (``mesh`` None) then MAP_REFINE_ITERS of
    color refinement; one keyframe runs under CUDA sync debug mode (host
    syncs per iteration), left out of the wall statistics; and the PSNR
    and pose-error limits. With ``mesh`` ranks (this process one of them)
    the backend maps over the mesh, without refinement, the sync count or
    those limits, and the record carries a digest of the final state.
    Returns (record, backend): the profiled keyframe (profile_mapping)
    maps the backend's last window once more, after every timed pass."""
    cfg = mapping_config(tile16)
    cfg["Training"]["mesh_devices"] = mesh or 1
    refine_iters = 0 if mesh else MAP_REFINE_ITERS
    be = BackEnd(cfg, cam, device=dev)
    be.prewarm_mapping()
    rng = np.random.default_rng(7)
    starts = [kf_poses[0]] + [perturbed(T, rng) for T in kf_poses[1:]]
    gt0 = kf_gts[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be.add_next_kf(0, starts[0][:3, :3], starts[0][:3, 3], 0.0, 0.0, gt0[0],
                   gt0[1], gt0[1][0], init=True)
    be.initialize_map(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    active = {"init": int(be.gm.num_active())}
    map_walls = time_map_calls(be)
    window, per_kf, seed_s = [0], [], []
    sync_kf = None if mesh else 3
    overflow = window_overflow(be, window)
    syncs_per_iter = None
    for k in range(1, MAP_KF):
        gk = kf_gts[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.add_next_kf(k, starts[k][:3, :3], starts[k][:3, 3], 0.0, 0.0,
                       gk[0], gk[1], gk[1][0])
        torch.cuda.synchronize()
        seed_s.append(time.perf_counter() - t0)
        window = ([k] + window)[:be.window_size]
        with uncounted():
            psnr_b, loss_b, _ = keyframe_eval(be, kf_gts, kf_poses, window)
        it0 = be.iteration_count
        map_walls.clear()
        if k == sync_kf:
            syncs_per_iter = (count_syncs(lambda: be.handle_keyframe(k, window))
                              / (be.iteration_count - it0))
        else:
            be.handle_keyframe(k, window)
        with uncounted():
            psnr_a, loss_a, _ = keyframe_eval(be, kf_gts, kf_poses, window)
            overflow = max(overflow, window_overflow(be, window))
        active[f"kf{k}"] = int(be.gm.num_active())
        per_kf.append(dict(kf=k, window=len(window),
                           iters=be.iteration_count - it0,
                           map_s=sum(w for p, w in map_walls if not p),
                           prune_s=sum(w for p, w in map_walls if p),
                           loss_before=loss_b, loss_after=loss_a,
                           psnr_mean_before=float(np.mean(psnr_b)),
                           psnr_mean_after=float(np.mean(psnr_a)),
                           instrumented=k == sync_kf))
    uids = list(range(MAP_KF))
    with uncounted():
        psnr_map, _, err_map = keyframe_eval(be, kf_gts, kf_poses, uids)
    psnr_ref, refine_s = psnr_map, 0.0
    if refine_iters:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.color_refinement(iteration_total=refine_iters)
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
        with uncounted():
            psnr_ref, _, _ = keyframe_eval(be, kf_gts, kf_poses, uids)
    active["refined"] = int(be.gm.num_active())
    err_before = [1e3 * float(np.linalg.norm(starts[k][:3, 3]
                                             - kf_poses[k][:3, 3]))
                  for k in range(1, MAP_KF)]
    plain = [r for r in per_kf if not r["instrumented"]]
    kf_walls = [r["map_s"] for r in plain]
    prune_walls = [r["prune_s"] for r in plain]
    map_iters = sum(r["iters"] - 1 for r in plain)
    act = be.gm.active
    finite = all(bool(torch.isfinite(getattr(be.gm, f)[act]).all())
                 for f in ("xyz", "scaling", "rotation", "opacity",
                           "features_dc"))
    finite &= bool(torch.isfinite(be.store.R).all()
                   and torch.isfinite(be.store.t).all())
    rec = dict(
        path=name, tile16=tile16, keyframes=MAP_KF, resolution=f"{W}x{H}",
        cuts=dict(MAP_CUTS, color_refinement=refine_iters),
        mesh_devices=mesh or 1, frame_slots=be.F,
        init_s=init_s, init_iters=cfg["Training"]["init_itr_num"],
        seed_s_median=float(np.median(seed_s)),
        kf_map_s_median=float(np.median(kf_walls)),
        kf_map_s_max=float(np.max(kf_walls)),
        kf_prune_s_median=float(np.median(prune_walls)),
        kf_prune_s_max=float(np.max(prune_walls)),
        map_iters_per_s=map_iters / float(np.sum(kf_walls)),
        refine_s=refine_s,
        refine_iters_per_s=refine_iters / refine_s if refine_iters else None,
        iterations=be.iteration_count, active=active,
        densify=[dict(iteration=d["iteration"], clone=int(d["clone"]),
                      split=int(d["split"]), prune=int(d["prune"]),
                      overflow=int(d["overflow"])) for d in be.densify_log],
        overflow=overflow, capacity=be.gm.capacity,
        plan_stats=be.plan_stats,
        psnr_mapped_mean=float(np.mean(psnr_map)),
        psnr_mapped_min=float(np.min(psnr_map)),
        psnr_refined_mean=float(np.mean(psnr_ref)),
        psnr_refined_min=float(np.min(psnr_ref)),
        pose_err_before_mm=float(np.mean(err_before)),
        pose_err_after_mm=float(np.mean(err_map[1:])),
        pose_err_after_max_mm=float(np.max(err_map[1:])),
        window_loss_first=per_kf[-1]["loss_before"],
        window_loss_final=per_kf[-1]["loss_after"],
        host_syncs_per_iter=syncs_per_iter,
        finite=finite, per_keyframe=per_kf, card=card_line())
    if mesh:
        rec["state_sha256"] = state_digest(be)
    print(f"{name} " + json.dumps(rec), flush=True)
    if not finite:
        fail(f"{name}: non-finite map or poses")
    if overflow or any(d["overflow"] for d in rec["densify"]):
        fail(f"{name}: overflow (plans {overflow}, densify "
             f"{[d['overflow'] for d in rec['densify']]})")
    if not rec["window_loss_final"] < rec["window_loss_first"]:
        fail(f"{name}: the final window loss {rec['window_loss_final']:.6f}"
             f" is not below the first {rec['window_loss_first']:.6f}")
    if mesh:
        return rec, be
    if (rec["psnr_mapped_mean"] < MAP_PSNR_MAPPED_MIN_DB
            or rec["psnr_refined_mean"] < MAP_PSNR_REFINED_MIN_DB):
        fail(f"{name}: keyframe PSNR {rec['psnr_mapped_mean']:.3f} dB "
             f"mapped, {rec['psnr_refined_mean']:.3f} dB refined (limits "
             f"{MAP_PSNR_MAPPED_MIN_DB}, {MAP_PSNR_REFINED_MIN_DB})")
    if rec["pose_err_after_mm"] > MAP_POSE_ERR_MAX_MM:
        fail(f"{name}: mean keyframe pose error "
             f"{rec['pose_err_after_mm']:.4f} mm after mapping (limit "
             f"{MAP_POSE_ERR_MAX_MM} mm)")
    return rec, be


@torch.no_grad()
def depth_reg_check(name, be, kf_gts):
    """losses.depth_reg of the last keyframe's depth, rendered from the
    backend's final map at its stored pose (B1', uncounted), against that
    keyframe's ground-truth image: on the card, and on the CPU from the
    same tensors."""
    u = MAP_KF - 1
    s = be.uid_to_slot[u]
    cam = be.cam.replace(R=be.store.R[s], t=be.store.t[s])
    with uncounted():
        out = render(be.gm, cam, None, be.bg, pair_capacity=be.pair_capacity,
                     tile16=be.tile16, need_n_touched=False, device=be.device)
    depth, img = out.depth, kf_gts[u][0]
    card = float(losses.depth_reg(depth, img))
    cpu = float(losses.depth_reg(depth.cpu(), img.cpu()))
    rel = abs(card - cpu) / max(abs(cpu), 1e-30)
    print("depth_reg " + json.dumps(dict(
        path=name, keyframe=u, shape=list(depth.shape), card_value=card,
        cpu_value=cpu, rel_diff=rel, rtol=DEPTH_REG_RTOL,
        card=card_line())), flush=True)
    if not (np.isfinite(card) and card > 0 and rel <= DEPTH_REG_RTOL):
        fail(f"depth_reg on {name}: card {card!r} against CPU {cpu!r} "
             f"(rel {rel:.3g}, limit {DEPTH_REG_RTOL})")


def profile_mapping(name, be):
    """One keyframe of a mapping path under torch.profiler (profile_call):
    the backend's last window mapped once more, after every timed pass
    (PERF.md §7: the profiler leaves the process's host slower)."""
    it0 = be.iteration_count
    prof = profile_call(
        lambda: be.handle_keyframe(MAP_KF - 1, be.current_window),
        f"map_{name}")
    prof["iterations"] = be.iteration_count - it0
    print(f"profile-{name} " + json.dumps(dict(prof, card=card_line())),
          flush=True)


# ---------------------------------------------------------------------------
# the port's bench and entry points, and the multi-rank paths
# ---------------------------------------------------------------------------

def phase_bench(r05, dev):
    """``python -m gs_slam_analytica_jacobian_tpu_torch.bench`` at its
    defaults (no BENCH_* set) in a subprocess: its JSON line, its launch
    counts (ops/launches.py COUNTERS' names), and its ms/frame beside this
    call's reading of the schedule it adapts to (bench-r05-schedule,
    ``r05``) and beside bench.run_bench in this process (uncounted)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "gs_slam_analytica_jacobian_tpu_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or not lines:
        fail(f"bench: exit {res.returncode}, no JSON line; stderr tail: "
             f"{res.stderr[-2000:]}")
        return None, {n: 0 for n in path_launches.COUNTERS}
    line = lines[-1]
    print(f"bench {line}", flush=True)
    rec = json.loads(line)
    d = rec["detail"]
    counts = {n: d["kernel_launches"].get(n, 0)
              for n in path_launches.COUNTERS}
    print(f"bench launches: {json.dumps(counts)}", flush=True)
    with uncounted():
        here = bench.run_bench(device=dev)["detail"]
    print(f"bench: {d['ms_per_frame']:.2f} ms/frame ({rec['value']:.3f} "
          f"FPS) against this call's bench-r05-schedule "
          f"{r05['ms_per_frame']:.2f} ms/frame and run_bench in this "
          f"process {here['ms_per_frame']:.2f} ms/frame "
          f"({here['iters_per_frame']} iterations/frame); adapted level_iters "
          f"{d['level_iters']}, level_caps {d['level_caps']}; mean error "
          f"{d['pose_err_mean_m'] * 1e3:.4f} mm; {wall:.1f} s with the "
          "process start", flush=True)
    rel = abs(d["pose_err_mean_m"] / R05_JAX_ERR_MEAN_M - 1.0)
    if rec["metric"] != "tracking_fps_replica_scale" or rel > R05_ERR_REL:
        fail(f"bench: metric {rec['metric']}, mean error "
             f"{d['pose_err_mean_m']} m is {rel:.1%} from the JAX record's "
             f"{R05_JAX_ERR_MEAN_M} m (limit {R05_ERR_REL:.0%})")
    if d["gt_render_overflow"] != 0:
        fail(f"bench: ground-truth overflow {d['gt_render_overflow']}")
    if not d["level_iters"] or not d["level_caps"]:
        fail("bench: no adapted level_iters / level_caps in its record")
    if any(w in line for w in ("TPU", "v5e", "VPU")):
        fail("bench: its record names a TPU figure")
    for name in ("composite32_fwd", "composite32_fwd_ntouch"):
        if counts[name] == 0:
            fail(f"kernel {name} was never launched on the path bench")
    return rec, counts


def phase_entry(dev, case):
    """graft_entry.entry()'s ``fn(*args)`` on the card (the 50k cloud at
    1200x680, pair capacity 2^20): shapes, finite, B1 launched, and fn's
    time outside the count. ``case`` is phase_kernels' entry_cloud50k
    record: the same scene's plan (its overflow, gated here) and B1 held
    against the plain version on it."""
    fn, args = graft_entry.entry(device=dev)
    path_launches.reset()
    color, depth, opacity = fn(*args)
    torch.cuda.synchronize()
    counts = read_counts("entry", ("composite32_fwd_ntouch",))
    with uncounted():
        ms = time_ms(lambda: fn(*args))
    shapes = [tuple(o.shape) for o in (color, depth, opacity)]
    finite = all(bool(torch.isfinite(o).all()) for o in (color, depth,
                                                         opacity))
    rec = dict(shapes=shapes, finite=finite, plan_overflow=case["overflow"],
               b1_max_abs_err=case["max_abs_err"], ms=ms,
               color_mean=float(color.mean()), card=card_line())
    print("entry " + json.dumps(rec), flush=True)
    if shapes != [(3, H, W), (1, H, W), (1, H, W)]:
        fail(f"entry: shapes {shapes}")
    if not finite or case["overflow"]:
        fail(f"entry: finite {finite}, plan overflow {case['overflow']}")
    return counts


def phase_multichip(dev):
    """graft_entry.dryrun_multichip(MULTICHIP_RANKS) with the ranks
    sharing the card (gloo): its gates (finite losses, the map moved,
    n_touched > 0, non-zero slab gradients, the same loss on every rank),
    and B1' and B2 launched on every rank."""
    t0 = time.perf_counter()
    try:
        recs = graft_entry.dryrun_multichip(MULTICHIP_RANKS, device=dev)
    except Exception as e:
        fail(f"multichip: {type(e).__name__}: {e}")
        return {n: 0 for n in path_launches.COUNTERS}
    wall = time.perf_counter() - t0
    total = {n: 0 for n in path_launches.COUNTERS}
    for r in recs:
        per = {n: sum(r[p]["launches"].get(n, 0)
                      for p in ("step", "integrated", "slab"))
               for n in path_launches.COUNTERS}
        print(f"multichip rank {r['rank']} launches: " + json.dumps(
            {p: {n: c for n, c in r[p]["launches"].items() if c}
             for p in ("step", "integrated", "slab")}), flush=True)
        for name in ("composite32_fwd", "composite32_bwd"):
            if per[name] == 0:
                fail(f"multichip: {name} never launched on rank {r['rank']}")
        for n in total:
            total[n] += per[n]
    print("multichip " + json.dumps(dict(
        ranks=MULTICHIP_RANKS, wall_s=wall,
        losses={p: recs[0][p]["loss"] for p in ("step", "integrated",
                                                "slab")},
        card=card_line())), flush=True)
    return total


def state_digest(be):
    """sha256 of the backend's map and keyframe poses (the ranks of a mesh
    must end with the same state bit for bit)."""
    import hashlib
    h = hashlib.sha256()
    for t in (be.gm.xyz, be.gm.opacity, be.gm.scaling, be.gm.features_dc,
              be.gm.active, be.store.R, be.store.t):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def slab_one_rank(dev, gm, cam, gt, slab_order=True):
    """The one-rank reference of slab-mesh2: the full map's tiled render
    at ``cam`` and the gradients of the mapping loss against ``gt`` (in
    the map's order). With ``slab_order`` the map is rendered with its
    Gaussians in the slabs' emission order (depth_slab_order), so that
    depth ties composite as in the slabs."""
    order = (slab.depth_slab_order(gm, cam) if slab_order
             else torch.arange(gm.capacity, device=dev))
    params = {f: getattr(gm, f)[order].detach().requires_grad_()
              for f in gmap.PARAM_FIELDS}
    g = gm.replace(active=gm.active[order], **params)
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = renderer_tiled.render(
        g.xyz, g.get_cov6(), g.get_opacity(), g.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=dev), cam.fx,
        cam.fy, W, H, cam.tanfovx, cam.tanfovy, bg, active=g.active,
        pair_capacity=PAIR_CAP, need_n_touched=False, device=dev)
    loss = losses.loss_mapping_rgbd(out.color, out.depth, gt[0], gt[1],
                                    0.01, 0.95)
    grads = torch.autograd.grad(loss, [params[f] for f in gmap.PARAM_FIELDS])
    torch.cuda.synchronize()
    inv = torch.argsort(order)
    return dict(color=out.color.detach(), depth=out.depth.detach(),
                opacity=out.opacity.detach(), final_T=out.final_T.detach(),
                loss=float(loss.detach()),
                grads={f: g_[inv] for f, g_ in zip(gmap.PARAM_FIELDS,
                                                   grads)},
                wall_s=time.perf_counter() - t0)


def mesh2_rank(device="cuda"):
    """One rank of mapping-mesh2 and slab-mesh2 (spawned by
    sharding.run_ranks; chip_smoke's own state is this process's): the
    room map and the mapping path's keyframes' ground truth made here, the
    backend on the mesh, then the slab render and gradients. Returns the
    records (the slab's images and gradients as numpy) and this rank's
    failed gates."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device.startswith("cuda") else torch.device(device))
    gm, cam = room_scene(dev)
    kf_poses = pose_list(1 + KF_STEP * (MAP_KF - 1))[::KF_STEP]
    with uncounted():
        kf_gts, _ = render_ground_truth(dev, gm, cam, kf_poses)
    # phase_mesh2 starts the ranks with GS_SLAM_NAN_CHECK=1: every batch
    # and densify / prune of the backend runs _assert_finite, counted here
    checks = [0]
    assert_finite = BackEnd._assert_finite

    def counted(be, tag):
        checks[0] += 1
        return assert_finite(be, tag)

    BackEnd._assert_finite = counted
    path_launches.reset()
    try:
        mapping_rec, _ = run_mapping("mapping-mesh2", dev, cam, kf_gts,
                                     kf_poses, False, mesh=MESH_RANKS)
    finally:
        BackEnd._assert_finite = assert_finite
    mapping_rec["launches"] = path_launches.counts()
    mapping_rec["nan_checks"] = checks[0]
    mesh = sharding.make_mesh(MESH_RANKS, device=dev)
    bg = torch.zeros(3, device=dev)
    path_launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, depth, opac = slab.slab_render(mesh, gm, cam, bg, tiled=True,
                                          pair_capacity=PAIR_CAP)
    loss, grads = slab.slab_mapping_loss_and_grads(
        mesh, gm, cam, kf_gts[1][0], kf_gts[1][1], bg, tiled=True,
        pair_capacity=PAIR_CAP)
    torch.cuda.synchronize()
    slab_rec = dict(
        color=color.detach().cpu().numpy(), depth=depth.detach().cpu().numpy(),
        opacity=opac.detach().cpu().numpy(), loss=float(loss.detach()),
        grads={f: g.cpu().numpy() for f, g in grads.items()},
        wall_s=time.perf_counter() - t0,
        launches=path_launches.counts())
    return dict(rank=mesh.rank, mapping=mapping_rec, slab=slab_rec,
                failures=list(FAILURES))


def phase_mesh2(dev, gm, cam, kf_gts, one, launches):
    """mapping-mesh2 and slab-mesh2 on MESH_RANKS ranks sharing the card:
    the first against ``one``, the mapping path's record (its state
    before color refinement), the second against the one-rank render and
    gradients."""
    with uncounted():
        ref = slab_one_rank(dev, gm, cam, kf_gts[1])
        ref_map_order = slab_one_rank(dev, gm, cam, kf_gts[1],
                                      slab_order=False)
    # the ranks (start method spawn) import the backend afresh and read
    # the NaN-check switch; this process's tracked paths stay unchecked
    saved = os.environ.get("GS_SLAM_NAN_CHECK")
    os.environ["GS_SLAM_NAN_CHECK"] = "1"
    t0 = time.perf_counter()
    try:
        ranks = sharding.run_ranks(mesh2_rank, MESH_RANKS, (dev.type,),
                                   device=dev)
    except Exception as e:
        fail(f"mapping-mesh2 / slab-mesh2: {type(e).__name__}: {e}")
        return
    finally:
        if saved is None:
            del os.environ["GS_SLAM_NAN_CHECK"]
        else:
            os.environ["GS_SLAM_NAN_CHECK"] = saved
    wall = time.perf_counter() - t0
    for r in ranks:
        for msg in r["failures"]:
            fail(f"rank {r['rank']}: {msg}")
    for path in ("mapping", "slab"):
        name = f"{path}-mesh2"
        launches[name] = {n: sum(r[path]["launches"][n] for r in ranks)
                          for n in path_launches.COUNTERS}
        print(f"{name} launches by rank: " + json.dumps(
            [r[path]["launches"] for r in ranks]), flush=True)
        for r in ranks:
            for k in (("composite32_fwd", "composite32_bwd")
                      + (("composite32_fwd_ntouch",) if path == "mapping"
                         else ())):
                if r[path]["launches"][k] == 0:
                    fail(f"kernel {k} was never launched on rank "
                         f"{r['rank']} of {name}")
            for k in KERNELS16:
                if r[path]["launches"][k]:
                    fail(f"kernel {k} was launched on rank {r['rank']} of "
                         f"{name}")
    m = ranks[0]["mapping"]
    digests = {r["mapping"]["state_sha256"] for r in ranks}
    last = f"kf{MAP_KF - 1}"
    dpsnr = m["psnr_mapped_mean"] - one["psnr_mapped_mean"]
    dact = m["active"][last] / one["active"][last] - 1.0
    print(f"mapping-mesh2 vs mapping: PSNR {dpsnr:+.4f} dB, active "
          f"Gaussians {dact:+.4%}, keyframe map wall "
          f"{m['kf_map_s_median']:.4f} s against {one['kf_map_s_median']:.4f}"
          f", window loss {m['window_loss_first']:.6f} -> "
          f"{m['window_loss_final']:.6f}; ranks' states equal "
          f"{len(digests) == 1}; {wall:.1f} s with the ranks' start; "
          f"GS_SLAM_NAN_CHECK=1, NaN checks by rank "
          f"{[r['mapping']['nan_checks'] for r in ranks]}; {card_line()}",
          flush=True)
    if len(digests) != 1:
        fail("mapping-mesh2: the ranks' final states differ")
    for r in ranks:
        if not r["mapping"]["nan_checks"]:
            fail(f"mapping-mesh2: rank {r['rank']} ran no NaN check")
    if abs(dpsnr) > MESH_PSNR_DB or abs(dact) > MESH_ACTIVE_REL:
        fail(f"mapping-mesh2 vs mapping: PSNR {dpsnr:+.3f} dB (limit "
             f"{MESH_PSNR_DB}), active {dact:+.2%} (limit "
             f"{MESH_ACTIVE_REL:.0%})")

    s0 = ranks[0]["slab"]
    img_err = {k: float(np.abs(s0[k] - ref[k].cpu().numpy()).max())
               for k in ("color", "depth", "opacity")}
    # the stop rule's bound: per pixel, the one-rank final T times the
    # largest Gaussian color (SH degree 0, clamped at 0) or view depth
    tf = ref["final_T"].cpu().numpy()
    stopped = tf < SLAB_STOP_T
    scale = dict(
        opacity=1.0, depth=float((gm.xyz @ cam.R[2] + cam.t[2]).max()),
        color=float(torch.clamp(0.5 + 0.28209479177387814
                                * gm.features_dc[:, 0], min=0).max()))
    free_err, over_bound = {}, {}
    for k in ("color", "depth", "opacity"):
        d = np.abs(s0[k] - ref[k].cpu().numpy()).max(axis=0)     # (H, W)
        free_err[k] = float(d[~stopped].max()) if (~stopped).any() else 0.0
        over_bound[k] = int((d > tf * scale[k] + SLAB_IMG_TOL).sum())
    grad = {}
    for f in gmap.PARAM_FIELDS:
        a, b = s0["grads"][f].ravel(), ref["grads"][f].cpu().numpy().ravel()
        if b.size == 0:
            continue
        grad[f] = dict(
            cosine=float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                     1e-30)),
            max_rel=float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    same = all(np.array_equal(r["slab"][k], s0[k]) for r in ranks[1:]
               for k in ("color", "depth", "opacity"))
    # beside it, the one-rank render of the map in its own order: the
    # depth ties' order, not the slabs, sets that difference
    map_order_err = {k: float(np.abs(s0[k] - ref_map_order[k].cpu().numpy()
                                     ).max())
                     for k in ("color", "depth", "opacity")}
    rec = dict(ranks=MESH_RANKS, max_abs_err=img_err,
               max_abs_err_unstopped=free_err,
               pixels_over_stop_bound=over_bound,
               stopped_pixels=int(stopped.sum()),
               max_final_T_stopped=float(tf[stopped].max()),
               map_order_max_abs_err=map_order_err,
               loss=s0["loss"], loss_one_rank=ref["loss"], grads=grad,
               ranks_equal=same, wall_s=s0["wall_s"],
               one_rank_wall_s=ref["wall_s"], card=card_line())
    print("slab-mesh2 " + json.dumps(rec), flush=True)
    if (not same or max(free_err.values()) > SLAB_IMG_TOL
            or any(over_bound.values())):
        fail(f"slab-mesh2: images {free_err} off where the one-rank render "
             f"did not stop (limit {SLAB_IMG_TOL}), pixels over the stop "
             f"rule's bound {over_bound}, ranks equal {same}")
    for f, g in grad.items():
        if not (g["cosine"] > SLAB_GRAD_MIN_COS
                and g["max_rel"] < SLAB_GRAD_MAX_REL):
            fail(f"slab-mesh2: {f} gradient cosine {g['cosine']:.6f} "
                 f"(limit {SLAB_GRAD_MIN_COS}), max rel {g['max_rel']:.4f} "
                 f"(limit {SLAB_GRAD_MAX_REL})")


def room_scene(dev):
    """The bench room map (seeded) and the camera at the first pose."""
    gm = gmap.from_numpy(**make_room_map(N_ROOM, np.random.default_rng(0)),
                         max_sh_degree=0, device=dev)
    cam = Camera.create(np.eye(3), np.zeros(3), FX, FY, (W - 1) / 2,
                        (H - 1) / 2, W, H, device=dev)
    return gm, cam


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    run(dev)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev):
    """Every phase on ``dev``; ends with the kernels line. Any failure
    exits non-zero."""
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # seconds from here to the end of each part of the call (phases line)
    t_call, phases = time.perf_counter(), {}

    def phase_done(name):
        phases[name] = round(time.perf_counter() - t_call, 1)

    # phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s wall", flush=True)
    for name, rec in info.items():
        print(f"build {name}: {rec['seconds']:.3f} s -> {rec['path']}",
              flush=True)
        for line in rec["ptxas"].splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"  ptxas: {line.strip()}", flush=True)

    gm, cam = room_scene(dev)
    phase_done("build")

    # phase 2: kernels vs plain versions (these launches are not counted)
    cases = phase_kernels(dev, gm, cam)
    poses = pose_list()
    b2_cases = phase_backward(dev, gm, cam, poses)
    phase_lab(dev)
    gt1 = render_ground_truth(dev, gm, cam, poses[:2])[0][1]
    cases16, b4_cases = phase_kernels16(dev, gm, cam, gt1)
    render16_vs_32(dev, gm, cam)
    cases_bf16, b2_bf16_cases = phase_kernels_bf16(dev, gm, cam, gt1)
    cases_mxu, b2_mxu_cases, _ = phase_kernels_mxu(dev, gm, cam, gt1)
    abl = phase_abl16(dev)
    prep_recs, prep_profile = phase_preprocess(dev, gm, cam)
    pg_recs, pg_profile = phase_pair_gather(dev, gm, cam)
    phase_done("kernels")

    # phase 3: the main path, with launch counts from 0
    path_launches.reset()
    t0 = time.perf_counter()
    gts, gt_overflow = render_ground_truth(dev, gm, cam, poses)
    torch.cuda.synchronize()
    print(f"ground truth: {FRAMES} renders at {W}x{H} in "
          f"{time.perf_counter() - t0:.3f} s, overflow {gt_overflow}",
          flush=True)
    rec = run_schedule("main-path", dev, gm, cam, gts, poses, BENCH_KW,
                       gt_overflow)
    launches = {"main-path": read_counts(
        "main-path", ("composite32_fwd", "composite32_fwd_ntouch",
                      "preprocess_fwd", "pair_gather_fwd",
                      "segment_reduce_fwd"))}
    if not rec["finite"]:
        fail("non-finite tracking output")
    if rec["overflow"] > 0:
        fail(f"pair-plan overflow {rec['overflow']}")
    if rec["pose_err_mean_m"] > 1e-3:
        fail(f"mean translation error {rec['pose_err_mean_m']:.6f} m > 1 mm")

    # torch.profiler leaves this process's host about 2x slower for the
    # rest of its life (PERF.md §7), so every profiled pass is deferred to
    # ``profiles``, run after the last timed one
    profiles = [lambda: phase_profile(dev, gm, cam, gts, poses),
                prep_profile, pg_profile]
    # the schedule of the JAX record
    r05 = run_schedule("bench-r05-schedule", dev, gm, cam, gts, poses,
                       R05_KW, gt_overflow)
    if not r05["finite"] or r05["overflow"] > 0:
        fail("bench-r05-schedule: non-finite output or overflow")
    r05_rel = abs(r05["pose_err_mean_m"] / R05_JAX_ERR_MEAN_M - 1.0)
    if r05_rel > R05_ERR_REL:
        fail(f"bench-r05-schedule: mean translation error "
             f"{r05['pose_err_mean_m']:.6f} m is {r05_rel:.1%} from the JAX "
             f"tracker's {R05_JAX_ERR_MEAN_M} m (limit {R05_ERR_REL:.0%})")

    # the port's bench at its defaults, in a process of its own and in
    # this one, beside the schedule reading above; then the port's entry()
    _, launches["bench"] = phase_bench(r05, dev)
    launches["entry"] = phase_entry(
        dev, next(c for c in cases if c["case"] == "entry_cloud50k"))
    phase_done("main path, r05, bench, entry")

    # the main path's schedule once more on the 16x16 kernels, tracking
    # frames rendered on them: on this dense map the two tile sizes order
    # depth-tied splats differently (render-tile16-vs-tile32 line), so the
    # 32x32 frames are tracked once more only to report that mismatch
    kw16 = dict(BENCH_KW, tile16=True)
    with uncounted():
        gts16, gt16_overflow = render_ground_truth(dev, gm, cam, poses,
                                                   tile16=True)
    path_launches.reset()
    t16 = run_schedule("main-path-tile16", dev, gm, cam, gts16, poses, kw16,
                       gt16_overflow, reps=TILE16_REPS)
    launches["main-path-tile16"] = read_counts(
        "main-path-tile16", ("composite16_fwd", "composite16_fwd_ntouch"),
        forbidden=KERNELS32)
    check_path("main-path-tile16", t16, max_err_m=TILE16_MAX_ERR_M)
    with uncounted():
        cross = track_sequence(dev, gm, cam, gts, poses, kw16, collect=True)
    print("main-path-tile16-on-tile32-frames " + json.dumps(dict(
        pose_err_mean_m=float(np.mean(cross["errs"])),
        pose_err_max_m=float(np.max(cross["errs"])))), flush=True)
    print(f"main-path-tile16: {t16['ms_per_frame']:.3f} ms/frame against "
          f"the 32x32 main path's {rec['ms_per_frame']:.3f}; mean error "
          f"{t16['pose_err_mean_m'] * 1e3:.4f} mm against "
          f"{rec['pose_err_mean_m'] * 1e3:.4f}", flush=True)
    main_path_full_key(dev, gm, cam, poses, rec)

    # render-bf16: the render API with bf16 (n_touched on, as a user's
    # render call has it) at the ground-truth poses: the one path of B1-bf16
    # (the trackers' keyframing render stays f32, as in the reference)
    launches["render-bf16"] = render_bf16_path(dev, gm, cam, poses, gts)
    # render-mxu: likewise with mxu, B1-mxu's path
    launches["render-mxu"] = render_mxu_path(dev, gm, cam, poses)
    phase_done("tile16, render-bf16/mxu")

    # phase 4: the exact-gradient paths, each with launch counts from 0
    all_kernels = KERNELS32 + PREP_KERNELS
    path_launches.reset()
    pol = run_schedule("keyframe-polish", dev, gm, cam, gts, poses,
                       BENCH_KW, gt_overflow, polish=True)
    launches["keyframe-polish"] = read_counts("keyframe-polish", all_kernels)
    check_path("keyframe-polish", pol)
    print(f"keyframe-polish: mean translation error IRLS-only "
          f"{pol['irls_pose_err_mean_m'] * 1e3:.4f} mm, polished "
          f"{pol['pose_err_mean_m'] * 1e3:.4f} mm", flush=True)
    profiles.append(lambda: phase_profile(
        dev, gm, cam, gts, poses, name="profile-keyframe-polish",
        polish=True))

    path_launches.reset()
    exa = run_schedule("exact-pyramid", dev, gm, cam, gts, poses, EXACT_KW,
                       gt_overflow, reps=EXACT_REPS, carry_H=False,
                       reuse_plans=False)
    launches["exact-pyramid"] = read_counts("exact-pyramid", all_kernels)
    check_path("exact-pyramid", exa, max_err_m=EXACT_MAX_ERR_M)
    profiles.append(lambda: phase_profile(
        dev, gm, cam, gts, poses, name="profile-exact-pyramid", kw=EXACT_KW,
        carry_H=False, reuse_plans=False))
    # once more with each frame's H handed to the next (H_in under curv
    # "fd": no probes after frame 1), as the frontend does while frames
    # converge before the iteration cap and bench.py did for BENCH_r01.json
    hc = track_sequence(dev, gm, cam, gts, poses, EXACT_KW, collect=True,
                        reuse_plans=False)
    hc = dict(schedule="exact-pyramid-H-carried",
              iters_per_frame=hc["iters"] / (FRAMES - 1),
              pose_err_mean_m=float(np.mean(hc["errs"])),
              pose_err_max_m=float(np.max(hc["errs"])),
              overflow=max(hc["overflow"], gt_overflow), finite=hc["finite"])
    print("exact-pyramid-H-carried " + json.dumps(hc), flush=True)
    check_path("exact-pyramid-H-carried", hc, max_err_m=EXACT_H_MAX_ERR_M)

    # the bf16 and mxu tracker paths: the main path's schedule and the
    # exact pyramid with kernel_bf16 or kernel_mxu (the exact pyramid also
    # with both), each beside its f32 run; none may launch the f32 B1' or
    # B2 (the keyframing render stays f32, B1)
    exact_kw = dict(carry_H=False, reuse_plans=False)
    for name, kw, base, limit, reps, two_sided, required, track_kw in (
            ("main-path-bf16", dict(BENCH_KW, kernel_bf16=True), rec, 1e-3,
             BF16_REPS, True,
             ("composite32_fwd_bf16", "composite32_fwd_ntouch"), {}),
            ("exact-pyramid-bf16", dict(EXACT_KW, kernel_bf16=True), exa,
             EXACT_MAX_ERR_M, 1, False,
             ("composite32_fwd_bf16", "composite32_bwd_bf16",
              "composite32_fwd_ntouch"), exact_kw),
            ("main-path-mxu", dict(BENCH_KW, kernel_mxu=True), rec, 1e-3,
             BF16_REPS, True,
             ("composite32_fwd_mxu", "composite32_fwd_ntouch"), {}),
            ("exact-pyramid-mxu", dict(EXACT_KW, kernel_mxu=True), exa,
             EXACT_MAX_ERR_M, 1, False,
             ("composite32_fwd_mxu", "composite32_bwd_mxu",
              "composite32_fwd_ntouch"), exact_kw),
            # both flags: the MXU falloff with the bfloat16 gradient
            # products in the exact iterations (B2-bf16-mxu's path)
            ("exact-pyramid-bf16-mxu",
             dict(EXACT_KW, kernel_bf16=True, kernel_mxu=True), exa,
             EXACT_MAX_ERR_M, 1, False,
             ("composite32_fwd_mxu", "composite32_bwd_bf16_mxu",
              "composite32_fwd_ntouch"), exact_kw)):
        path_launches.reset()
        rb = run_schedule(name, dev, gm, cam, gts, poses, kw, gt_overflow,
                          reps=reps, **track_kw)
        launches[name] = read_counts(name, required, forbidden=(
            "composite32_fwd", "composite32_bwd"))
        kw = {k: v for k, v in kw.items()
              if k not in ("kernel_bf16", "kernel_mxu")}
        with uncounted():
            again = run_schedule(f"{name}-f32-again", dev, gm, cam, gts,
                                 poses, kw, gt_overflow, reps=reps,
                                 **track_kw)
        check_path(name, rb, max_err_m=limit)
        rel = rb["pose_err_mean_m"] / base["pose_err_mean_m"] - 1.0
        print(f"{name}: {rb['ms_per_frame']:.3f} ms/frame against "
              f"{again['ms_per_frame']:.3f} for its f32 path run right after "
              f"({base['ms_per_frame']:.3f} earlier); mean error "
              f"{rb['pose_err_mean_m'] * 1e3:.4f} mm against "
              f"{base['pose_err_mean_m'] * 1e3:.4f} ({rel:+.2%})", flush=True)
        if rel > BF16_REL or (two_sided and rel < -BF16_REL):
            fail(f"{name}: mean error {rel:+.2%} from the f32 path's "
                 f"(limit {'+-' if two_sided else '+'}{BF16_REL:.0%})")

    # track_frame_gn must end nearer the truth than it started; Adam, which
    # runs the reference's 100 iterations, within ADAM_MAX_ERR_M
    for name, fn, iters, max_err in (
            ("track_frame_gn", tracking.track_frame_gn, 20, None),
            ("track_frame", tracking.track_frame, 100, ADAM_MAX_ERR_M)):
        path_launches.reset()
        run_frame1(name, fn, iters, max_err, dev, gm, cam, gts, poses)
        launches[name] = read_counts(name, all_kernels)
    phase_done("exact, bf16/mxu paths, frame-1 trackers")

    # phase 5: the mapping paths, each with launch counts from 0
    kf_poses = pose_list(1 + KF_STEP * (MAP_KF - 1))[::KF_STEP]
    kf_gts, kf_overflow = render_ground_truth(dev, gm, cam, kf_poses)
    if kf_overflow:
        fail(f"keyframe ground truth: overflow {kf_overflow}")
    maps = {}
    for name, t16, req, forb in (("mapping", False, KERNELS32, KERNELS16),
                                 ("mapping-tile16", True, KERNELS16,
                                  KERNELS32)):
        path_launches.reset()
        maps[name], be = run_mapping(name, dev, cam, kf_gts, kf_poses, t16)
        profiles.append(functools.partial(profile_mapping, name, be))
        launches[name] = read_counts(name, req + PREP_KERNELS + PG_KERNELS,
                                     forbidden=forb)
        if name == "mapping":
            depth_reg_check(name, be, kf_gts)
    a, b = maps["mapping"], maps["mapping-tile16"]
    dpsnr = b["psnr_refined_mean"] - a["psnr_refined_mean"]
    dact = b["active"]["refined"] / a["active"]["refined"] - 1.0
    print(f"mapping-tile16 vs mapping: PSNR {dpsnr:+.4f} dB, active "
          f"Gaussians {dact:+.4%}, keyframe map wall "
          f"{b['kf_map_s_median']:.4f} s against {a['kf_map_s_median']:.4f}",
          flush=True)
    if abs(dpsnr) > MAP_T16_PSNR_DB or abs(dact) > MAP_T16_ACTIVE_REL:
        fail(f"mapping-tile16 vs mapping: PSNR {dpsnr:+.3f} dB (limit "
             f"{MAP_T16_PSNR_DB}), active {dact:+.2%} (limit "
             f"{MAP_T16_ACTIVE_REL:.0%})")
    phase_done("mapping")

    # the multi-rank paths, the ranks sharing the card: the dry run, then
    # the mapping backend and the depth slabs on a mesh of MESH_RANKS
    launches["multichip"] = phase_multichip(dev)
    phase_mesh2(dev, gm, cam, kf_gts, maps["mapping"], launches)
    phase_done("multichip, mesh2")

    # phase 6: the SLAM paths, each with launch counts from 0
    slam_recs, slam_launches = phase_slam(dev)
    launches.update(slam_launches)
    phase_done("slam")

    # the profiled passes, after every timed one; then the JAX record's
    # schedule once more, read beside its reading before them
    for prof in profiles:
        prof()
    after = run_schedule("bench-r05-schedule-after-profiler", dev, gm, cam,
                         gts, poses, R05_KW, gt_overflow)
    print(f"bench-r05-schedule after the profiled passes: "
          f"{after['ms_per_frame']:.2f} ms/frame, host CPU "
          f"{after['host_cpu_ms_per_frame']:.1f}; before them "
          f"{r05['ms_per_frame']:.2f}, {r05['host_cpu_ms_per_frame']:.1f}",
          flush=True)
    phase_done("profiles")

    # phase 7: the kernels line. Launches: summed over the paths' runs.
    # Times: the 32x32 forward kernels at the shape the main path runs
    # most (the s=2 level: every fine IRLS render and the keyframing
    # render), B2 at the polish_frame shape (s=1) under the loss
    # cotangent; the 16x16 kernels at the mapping shapes: B3' and B4 on
    # the mapping plan (B4 under the mapping loss's cotangent), B3 on a
    # fresh plan (window visibility).
    # Each row's source= and replaces= come from the port's registry of
    # the JAX package's Pallas sites (ops/launches.py PALLAS_SITES).
    total = {n: sum(c[n] for c in launches.values())
             for n in path_launches.COUNTERS}

    def site(name, variant=""):
        where, src, note = path_launches.site_of(name)
        note = ", ".join(n for n in (note, variant) if n)
        return dict(source="gs_slam_analytica_jacobian_tpu_torch/" + src,
                    replaces=where + (f" ({note})" if note else ""))

    def pick(with_nt):
        return next(c for c in cases
                    if c["case"] == "room_s2" and c["with_ntouch"] == with_nt
                    and not c["nt_weight"])

    # the sub-tile kernels (B1', B1, B2) with the cells they evaluate
    # after the rect16 compaction and the block test (post_cull_cells)
    # beside the cells of the 32x32 tile-walk (tile_walk_cells), and PR
    # 1-5's walk bound beside the bound of the work needed
    def subtile_keys(c):
        return dict(post_cull_cells=c["post_cull_cells"],
                    rect_cells=c["rect_cells"],
                    tile_walk_cells=c["walked_cells"],
                    walk_bound_ms=c["walk_bound_ms"])

    kernels = []
    for name, with_nt in (("composite32_fwd", False),
                          ("composite32_fwd_ntouch", True)):
        c = pick(with_nt)
        kernels.append(dict(
            name=name, route="cuda", **site(name), launches=total[name],
            max_abs_err=max(c["max_abs_err"].values()),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=None, shape=c["shape"],
            **subtile_keys(c)))
    c = next(c for c in b2_cases
             if c["case"] == "room_s1_polish" and c["cotangent"] == "loss")
    kernels.append(dict(
        name="composite32_bwd", route="cuda", **site("composite32_bwd"),
        launches=total["composite32_bwd"], max_abs_err=c["max_abs_err"],
        max_col_rel_err=c["max_col_rel_err"], ms=c["ms"],
        plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
        bound_by=c["bound_by"], library_ms=None, shape=c["shape"],
        repeat_bit_equal=c["repeat_bit_equal"], **subtile_keys(c)))
    # B3' and B3 (sub-tile) with the cells they evaluate
    for name, case, with_nt in (
            ("composite16_fwd", "room_s1_map16", False),
            ("composite16_fwd_ntouch", "room_s1_fresh16", True)):
        c = next(
            c for c in cases16 if c["case"] == case
            and c["with_ntouch"] == with_nt and not c["nt_weight"])
        kernels.append(dict(
            name=name, route="cuda", **site(name), launches=total[name],
            max_abs_err=max(c["max_abs_err"].values()),
            nt_mismatch=c["nt_mismatch"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            shape=c["shape"], **subtile_keys(c)))
    # B4 (sub-tile) with the cells it evaluates
    c = next(c for c in b4_cases if c["cotangent"] == "loss")
    kernels.append(dict(
        name="composite16_bwd", route="cuda", **site("composite16_bwd"),
        launches=total["composite16_bwd"], max_abs_err=c["max_abs_err"],
        max_col_rel_err=c["max_col_rel_err"], ms=c["ms"],
        plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
        bound_by=c["bound_by"], library_ms=None, shape=c["shape"],
        repeat_bit_equal=c["repeat_bit_equal"], **subtile_keys(c)))
    # the bf16 variants at the s=2 tracker plan (forward: the sub-tile
    # bf16 kernel, with the cells as for B1') and the s=1 exact plan
    # (backward, loss cotangent), the f32 kernel's time on the same plan
    # beside each; their bound is
    # the f32 kernels' operation count (scalar bfloat16 arithmetic, no
    # bf16x2 packing)
    for name, with_nt in (("composite32_fwd_bf16", False),
                          ("composite32_fwd_ntouch_bf16", True)):
        c = next(
            c for c in cases_bf16 if c["case"] == "room_s2_bf16"
            and c["with_ntouch"] == with_nt and not c["nt_weight"])
        kernels.append(dict(
            name=name, route="cuda", **site(name), launches=total[name],
            max_abs_err=max(c["max_abs_err"].values()),
            nt_mismatch=c["nt_mismatch"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            f32_ms=c["f32_ms"], shape=c["shape"], **subtile_keys(c)))
    # B2-bf16 (sub-tile, the bf16 margin) with the cells it evaluates
    c = next(c for c in b2_bf16_cases
                       if c["case"] == "room_s1_polish_bf16"
                       and c["cotangent"] == "loss")
    kernels.append(dict(
        name="composite32_bwd_bf16", route="cuda",
        **site("composite32_bwd_bf16"),
        launches=total["composite32_bwd_bf16"], max_abs_err=c["max_abs_err"],
        max_col_rel_err=c["max_col_rel_err"], ms=c["ms"],
        plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
        bound_by=c["bound_by"], library_ms=None, f32_ms=c["f32_ms"],
        shape=c["shape"], repeat_bit_equal=c["repeat_bit_equal"],
        **subtile_keys(c)))
    # the mxu variants likewise: the s=2 tracker plan (forward: the
    # sub-tile mxu kernel, with the cells as for B1') and the s=1 polish
    # plan (backward, loss cotangent), the f32 kernel's time on the same
    # plan beside each; the
    # bound charges the tensor cores' share at the TF32 peak beside the
    # CUDA cores' at the FP32 peak
    for name, with_nt in (("composite32_fwd_mxu", False),
                          ("composite32_fwd_ntouch_mxu", True)):
        c = next(
            c for c in cases_mxu if c["case"] == "room_s2_mxu"
            and c["with_ntouch"] == with_nt and not c["nt_weight"])
        kernels.append(dict(
            name=name, route="cuda", **site(name), launches=total[name],
            max_abs_err=max(c["max_abs_err"].values()),
            p999_abs_err=c["p999_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"],
            bound_tensor_core_ms=c["bound_tensor_core_ms"], library_ms=None,
            f32_ms=c["f32_ms"], shape=c["shape"], **subtile_keys(c)))
    # B2-mxu and B2-bf16-mxu (sub-tile, the mxu margin) with the cells
    # each evaluates
    for name, case in (("composite32_bwd_mxu", "room_s1_polish_mxu"),
                       ("composite32_bwd_bf16_mxu",
                        "room_s1_polish_bf16_mxu")):
        c = next(c for c in b2_mxu_cases if c["case"] == case
                 and c["cotangent"] == "loss")
        kernels.append(dict(
            name=name, route="cuda", **site(name), launches=total[name],
            max_abs_err=c["max_abs_err"],
            max_col_rel_err=c["max_col_rel_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=None, f32_ms=c["f32_ms"],
            shape=c["shape"], repeat_bit_equal=c["repeat_bit_equal"],
            **subtile_keys(c)))
    # P1: the fused preprocess at the main path's capacity (ms: device
    # time a call, from the profiled pass; wall_ms: a call's wall among
    # calls issued back to back; plain: the eager version, forward alone
    # and with autograd's backward), tum-map's capacities beside it
    main = next(r for r in prep_recs if r["case"] == "main_path_room")
    for name, k, plain in (("preprocess_fwd", "fwd", "plain_fwd"),
                           ("preprocess_bwd", "bwd", "plain_fwd_bwd")):
        kernels.append(dict(
            name=name, route="cuda",
            source="gs_slam_analytica_jacobian_tpu_torch/csrc/preprocess.cu",
            replaces="none: " + path_launches.OTHER_SOURCES[
                "csrc/preprocess.cu"][0],
            launches=total[name], max_abs_err=main[f"{k}_max_abs_err"],
            bit_equal=all(main[f"{k}_bit_equal"].values()),
            ms=main.get(f"{k}_device_ms"), wall_ms=main[f"{k}_wall_ms"],
            plain_ms=main.get(f"{plain}_device_ms"),
            plain_wall_ms=main[f"{plain}_wall_ms"],
            bound_ms=main[f"bound_{k}_ms"], bound_by="bytes",
            library_ms=None, shape=f"{main['shape']}, {main['capacity']} "
            "slots",
            by_capacity=[dict(capacity=r["capacity"],
                              ms=r.get(f"{k}_device_ms"),
                              wall_ms=r[f"{k}_wall_ms"],
                              plain_ms=r.get(f"{plain}_device_ms"),
                              bound_ms=r[f"bound_{k}_ms"])
                         for r in prep_recs if r["case"] != "main_path_room"
                         and f"{k}_wall_ms" in r]))
    # P2: the pair gather and its segment sum on the main path's plan (ms:
    # device time a call, from the profiled pass; wall_ms: a call's wall
    # among calls issued back to back; plain: the plain chain on the card),
    # tum-map's plan with the map in 2^18 and 2^17 slots beside it. The
    # forward is held to the plain version (bit_equal), the backward to
    # the float64 segment sum (bwd_rel_gap, the plain chain's beside it)
    # and to itself on a second launch (repeat_bit_equal)
    r = pg_recs[0]
    for name, k in (("pair_gather_fwd", "fwd"), ("segment_reduce_fwd", "bwd")):
        if k == "fwd":
            check = dict(max_abs_err=0.0, bit_equal=all(
                c["fwd_equal"] for c in pg_recs))
        else:
            check = dict(max_abs_err=r["bwd_max_abs_err"],
                         bwd_rel_gap=max(c["bwd_rel_gap"] for c in pg_recs),
                         plain_bwd_rel_gap=max(c["plain_bwd_rel_gap"]
                                               for c in pg_recs),
                         repeat_bit_equal=all(c["repeat_equal"]
                                              for c in pg_recs))
        kernels.append(dict(
            name=name, route="cuda",
            source="gs_slam_analytica_jacobian_tpu_torch/csrc/pair_gather.cu",
            replaces="none: " + path_launches.OTHER_SOURCES[
                "csrc/pair_gather.cu"][0],
            launches=total[name], **check,
            ms=r.get(f"{k}_device_ms"), wall_ms=r[f"{k}_wall_ms"],
            plain_ms=r.get(f"plain_{k}_device_ms"),
            plain_wall_ms=r[f"plain_{k}_wall_ms"],
            bound_ms=r[f"bound_{k}_ms"], bound_by="bytes", library_ms=None,
            shape=f"{r['shape']}, {r['pair_capacity']} pairs, "
            f"{r['capacity']} slots",
            by_case=[dict(case=c["case"], shape=c["shape"],
                          capacity=c["capacity"],
                          pair_capacity=c["pair_capacity"],
                          ms=c.get(f"{k}_device_ms"),
                          wall_ms=c[f"{k}_wall_ms"],
                          plain_ms=c.get(f"plain_{k}_device_ms"),
                          bound_ms=c[f"bound_{k}_ms"])
                     for c in pg_recs[1:] if f"{k}_wall_ms" in c]))
    # B5: one entry per variant, at the script's shape; launches from the
    # script's own run (phase_abl16)
    for v, r in abl.items():
        kernels.append(dict(
            name=f"abl16_{v}", route="cuda",
            **site("scripts/abl16.py:run", f"variant {v}"),
            launches=r["launches"],
            max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
            ms=r["ms"], us_per_chunk=r["us_per_chunk"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, shape="1216x704",
            bound_pct=r["bound_pct"]))
    print(f"launches by path: {json.dumps(launches)}", flush=True)
    print(f"phases (s since the build began): {json.dumps(phases)}",
          flush=True)
    check_failures()
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (gs_slam_analytica_jacobian_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit code):

1. Card: prints the card's name and power limit (nvidia-smi) and builds
   every CUDA kernel of the port from ``csrc/`` with nvcc (one process per
   source, started together), printing the build time and ptxas report.
2. Kernels vs their plain PyTorch versions on the card, at the shapes the
   main path launches: the renderer entry workload (50k-Gaussian cloud,
   1200x680, pair capacity 2^20) and the room map's pyramid levels
   s=4/2/1 (300x170, 600x340, 1200x680) with and without n_touched, and
   at s=2 once more with n_touched under the blend-weight rule.
   Reports max |kernel - plain| for color, depth and T, the n_touched
   mismatch count, and kernel / plain times (CUDA events, median of 7
   after warm-up).
3. Main path: builds the 200k-Gaussian room map (seeded), renders the
   ground-truth frames of bench.py's 5-pose trajectory with the port, and
   tracks frames 1..4 with the forward-only pyramid IRLS tracker at the
   bench operating point (levels (4,2,1), level_iters (5,12,2), curv
   flow, final_level 2, match_blur, plan_pad 4, plan reuse 2, H carried,
   constant-acceleration warm start): one warm pass, then TIMED_REPS timed
   passes (min / median / max wall and host CPU time per frame).
   Fails on non-finite output, pair-plan overflow, mean translation error
   above 1 mm, or a kernel that the main path never launched.
   Then, outside the launch count: host syncs per frame (CUDA sync debug
   mode) and one torch.profiler pass (device busy time, idle share, top
   kernels; a table in chiprun_out/), and one more run at the adapted
   schedule bench.py recorded in BENCH_r05.json, which fails unless its
   mean translation error lies within 5% of the JAX tracker's there.
4. A ``{"kernels": [...]}`` line, then the card's name and power limit,
   then the last line ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import _build  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import camera_math as cm  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import losses  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as tk  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.lie import se3_exp  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (  # noqa: E402
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_cloud, make_room_map  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking  # noqa: E402
from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render  # noqa: E402

W, H = 1200, 680
FX = FY = 600.0
N_ROOM = 200_000
N_CLOUD = 50_000
PAIR_CAP = 1 << 20
FRAMES = 5
TIMED_REPS = 8

# The JAX tracker's mean translation error at the BENCH_r05 schedule
# (BENCH_r05.json) on this room map and trajectory. The port's run of that
# schedule must land within R05_ERR_REL of it: the two trackers compute
# the same function, so only reduction order separates them.
R05_JAX_ERR_MEAN_M = 0.746e-3
R05_ERR_REL = 0.05

# Bound model for the compositing kernel. Memory: every pair row the
# tiles walk is read once (64 B), the 5-plane image written once, and
# with n_touched one f32 per walked pair written. Arithmetic: each
# (pair, pixel) cell walked costs ~30 FP32 operations (deltas 2,
# quadratic form 9, rect and skip tests 7, exp ~4, alpha/T/weight 5,
# four multiply-adds 8, minus what a skipped cell never reaches).
# Peaks: 3.35 TB/s HBM and 67 TFLOP/s FP32 (H100 SXM data sheet,
# non-tensor FP32, at the full 700 W power limit).
OPS_PER_CELL = 30.0
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Tolerances. The kernel is built without multiply-add contraction and
# composites pair by pair like its plain version, so the two agree bit
# for bit wherever their expf does; an ulp of expf difference can still
# move a pixel across the alpha >= 1/255, T < 1e-4 or T > 0.5 thresholds,
# so at most 1e-4 of the live pairs may differ in n_touched, and images
# must agree to 1e-4 absolute.
IMG_TOL = 1e-4
NT_MISMATCH_FRAC = 1e-4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def pose_list():
    """bench.py's 5-pose trajectory (bench.py:168-175), ~6 mm + 4 mrad per
    frame, composed in float32."""
    tau_step = np.array([0.0035, -0.0028, 0.0042, 0.002, 0.003, -0.0015],
                        np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(1, FRAMES):
        step = torch.as_tensor(tau_step * np.float32(1.0 + 0.1 * np.sin(k)))
        poses.append(se3_exp(step).numpy() @ poses[-1])
    return poses


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_case(name, feat, ranges, n_tx, n_ty, w, h, with_ntouch,
                nt_weight=False):
    torch.cuda.synchronize()
    (ref, walked) = tk.plain_walk(feat, ranges, n_tx, n_ty, w, h,
                                  with_ntouch, nt_weight)
    got = tk.composite32(feat, ranges, n_tx, n_ty, w, h, with_ntouch,
                         nt_weight)
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
    ms = time_ms(lambda: tk.composite32(feat, ranges, n_tx, n_ty, w, h,
                                        with_ntouch, nt_weight))
    plain_ms = time_ms(lambda: tk.plain_walk(feat, ranges, n_tx, n_ty, w, h,
                                             with_ntouch, nt_weight),
                       reps=5, warm=1)
    n_bytes = (walked_pairs * 64 + ranges.numel() * 4 + 5 * h * w * 4
               + (walked_pairs * 4 if with_ntouch else 0))
    n_ops = walked_pairs * tk.P * OPS_PER_CELL
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    rec = dict(case=name, shape=f"{w}x{h}", with_ntouch=with_ntouch,
               nt_weight=nt_weight, live_pairs=live,
               walked_pairs=walked_pairs, max_abs_err=errs,
               nt_mismatch=nt_bad, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations")
    print("kernel-vs-plain " + json.dumps(rec), flush=True)
    if not finite:
        fail(f"{name}: non-finite kernel output")
    if max(errs.values()) > IMG_TOL:
        fail(f"{name}: kernel differs from plain by {errs}")
    if nt_bad > NT_MISMATCH_FRAC * live:
        fail(f"{name}: {nt_bad} n_touched mismatches of {live} live pairs")
    return rec


def pair_rows(prep, w, h, cap, radius_scale=1.0, radius_pad=0.0):
    plan = make_plan(prep, w, h, cap, radius_scale=radius_scale,
                     radius_pad=radius_pad)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    n_tx, n_ty = tk.grid_dims(w, h)
    return feat, plan.ranges.contiguous(), n_tx, n_ty, plan


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
                            True))

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
                                    cam_l.width, cam_l.height, with_nt, nt_w))
    return recs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def cv_start(R1, t1, R0, t0):
    Rd = R1 @ R0.T
    return Rd @ R1, Rd @ (t1 - t0) + t1


def ca_start(R1, t1, R0, t0, Rm, tm):
    Rd1 = R1 @ R0.T
    td1 = t1 - Rd1 @ t0
    Rd0 = R0 @ Rm.T
    td0 = t0 - Rd0 @ tm
    Ra = Rd1 @ Rd0.T
    ta = td1 - Ra @ td0
    Rp = Ra @ Rd1
    tp = Ra @ td1 + ta
    return Rp @ R1, Rp @ t1 + tp


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


def render_ground_truth(dev, gm, cam, poses):
    bg = torch.zeros(3, device=dev)
    gts, overflow = [], 0
    for Tp in poses:
        c = cam.replace(R=torch.as_tensor(Tp[:3, :3], device=dev),
                        t=torch.as_tensor(Tp[:3, 3], device=dev))
        out = render(gm, c, None, bg, pair_capacity=PAIR_CAP, device=dev)
        img = torch.clamp(out.color, 0, 1)
        mask = losses.compute_grad_mask(img.mean(dim=0, keepdim=True),
                                        edge_threshold=1.1,
                                        dataset_type="replica")
        gts.append((img, out.depth, mask))
        overflow = max(overflow, int(out.overflow))
        if not (torch.isfinite(img).all() and torch.isfinite(out.depth).all()):
            fail("non-finite ground-truth render")
    return gts, overflow


def track_sequence(dev, gm, cam, gts, poses, kw, collect):
    """Track frames 1..F-1, each warm-started from the previous estimates
    (constant-acceleration prediction once three are known, as bench.py),
    rebuilding the pair plans every PLAN_REUSE frames and carrying H.
    Host reads (errors, counts) only when ``collect``."""
    bg = torch.zeros(3, device=dev)
    R_est = torch.as_tensor(poses[0][:3, :3], device=dev)
    t_est = torch.as_tensor(poses[0][:3, 3], device=dev)
    R_pp = t_pp = R_ppp = t_ppp = None
    H_carry = None
    plan_carry, plan_age = None, 0
    stats = dict(errs=[], iters=0, npairs=None, overflow=0, finite=True)
    for k in range(1, FRAMES):
        if R_ppp is not None:
            R_ws, t_ws = ca_start(R_est, t_est, R_pp, t_pp, R_ppp, t_ppp)
        elif R_pp is not None:
            R_ws, t_ws = cv_start(R_est, t_est, R_pp, t_pp)
        else:
            R_ws, t_ws = R_est, t_est
        R_ppp, t_ppp = R_pp, t_pp
        R_pp, t_pp = R_est, t_est
        use_plan = plan_carry if plan_age < PLAN_REUSE else None
        res = tracking.track_frame_pyr(
            gm, cam, R_ws, t_ws, gts[k][0], gts[k][1], gts[k][2], bg,
            H_in=H_carry if k > 1 else None, plan_in=use_plan, device=dev,
            **kw)
        R_est, t_est = res[0], res[1]
        H_carry = res[7]
        if use_plan is None:
            plan_carry, plan_age = res[11], 1
        else:
            plan_age += 1
        if collect:
            out = res[5]
            stats["finite"] &= bool(
                torch.isfinite(out.color).all()
                and torch.isfinite(out.depth).all()
                and torch.isfinite(R_est).all()
                and torch.isfinite(t_est).all())
            stats["iters"] += int(res[4])
            stats["errs"].append(float(torch.linalg.norm(
                t_est.cpu() - torch.as_tensor(poses[k][:3, 3]))))
            lp = res[10].cpu().numpy().astype(np.int64)
            stats["npairs"] = (lp if stats["npairs"] is None
                               else np.maximum(stats["npairs"], lp))
            stats["overflow"] = max(stats["overflow"], int(res[8].max()),
                                    int(out.overflow))
    torch.cuda.synchronize()
    return stats


def run_schedule(name, dev, gm, cam, gts, poses, kw, gt_overflow):
    """One collecting (warm) pass, then TIMED_REPS timed passes. Each pass
    records its wall time and the process's host CPU time (all threads),
    both per tracked frame; ms_per_frame is the median wall."""
    t0 = time.perf_counter()
    stats = track_sequence(dev, gm, cam, gts, poses, kw, collect=True)
    warm_s = time.perf_counter() - t0
    walls, cpus = [], []
    for _ in range(TIMED_REPS):
        t0, c0 = time.perf_counter(), time.process_time()
        track_sequence(dev, gm, cam, gts, poses, kw, collect=False)
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
    print(f"{name} " + json.dumps(rec), flush=True)
    return rec


def phase_profile(dev, gm, cam, gts, poses):
    """Where a tracked frame's time goes: host syncs per frame (CUDA sync
    debug mode), then one torch.profiler pass for device busy time, kernel
    launches and the top kernels by device time."""
    import warnings
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            track_sequence(dev, gm, cam, gts, poses, BENCH_KW, collect=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        track_sequence(dev, gm, cam, gts, poses, BENCH_KW, collect=False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            kern.append((e.key, float(dev_us) / 1e3, int(e.count)))
    kern.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kern)
    comp_ms = sum(r[1] for r in kern if "composite32" in r[0])
    frames = FRAMES - 1
    rec = dict(
        frames=frames, wall_ms_per_frame=wall_ms / frames,
        device_busy_ms_per_frame=busy_ms / frames,
        device_idle_share=(1.0 - busy_ms / wall_ms) if wall_ms else None,
        kernel_launches_per_frame=sum(r[2] for r in kern) / frames,
        composite_ms_per_frame=comp_ms / frames,
        host_syncs_per_frame=syncs / frames,
        top=[dict(name=n[:80], ms_per_frame=t / frames, calls=c)
             for n, t, c in kern[:10]], card=card_line())
    print("profile " + json.dumps(rec), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "track_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s wall", flush=True)
    for name, rec in info.items():
        print(f"build {name}: {rec['seconds']:.3f} s -> {rec['path']}",
              flush=True)
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    gm = gmap.from_numpy(**make_room_map(N_ROOM, np.random.default_rng(0)),
                         max_sh_degree=0, device=dev)
    cam = Camera.create(np.eye(3), np.zeros(3), FX, FY, 599.5, 339.5, W, H,
                        device=dev)

    # phase 2: kernels vs plain versions (these launches are not counted)
    cases = phase_kernels(dev, gm, cam)

    # phase 3: the main path, with launch counts from 0
    wrappers = {"composite32_fwd": tk.composite32_fwd,
                "composite32_fwd_ntouch": tk.composite32_fwd_ntouch}
    for fn in wrappers.values():
        fn.launches = 0
    poses = pose_list()
    t0 = time.perf_counter()
    gts, gt_overflow = render_ground_truth(dev, gm, cam, poses)
    torch.cuda.synchronize()
    print(f"ground truth: {FRAMES} renders at {W}x{H} in "
          f"{time.perf_counter() - t0:.3f} s, overflow {gt_overflow}",
          flush=True)
    rec = run_schedule("main-path", dev, gm, cam, gts, poses, BENCH_KW,
                       gt_overflow)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    if not rec["finite"]:
        fail("non-finite tracking output")
    if rec["overflow"] > 0:
        fail(f"pair-plan overflow {rec['overflow']}")
    if rec["pose_err_mean_m"] > 1e-3:
        fail(f"mean translation error {rec['pose_err_mean_m']:.6f} m > 1 mm")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")

    # where the main path's time goes, and the schedule of the JAX record
    phase_profile(dev, gm, cam, gts, poses)
    r05 = run_schedule("bench-r05-schedule", dev, gm, cam, gts, poses,
                       R05_KW, gt_overflow)
    if not r05["finite"] or r05["overflow"] > 0:
        fail("bench-r05-schedule: non-finite output or overflow")
    r05_rel = abs(r05["pose_err_mean_m"] / R05_JAX_ERR_MEAN_M - 1.0)
    if r05_rel > R05_ERR_REL:
        fail(f"bench-r05-schedule: mean translation error "
             f"{r05['pose_err_mean_m']:.6f} m is {r05_rel:.1%} from the JAX "
             f"tracker's {R05_JAX_ERR_MEAN_M} m (limit {R05_ERR_REL:.0%})")

    # phase 4: the kernels line, at the shape the main path runs most
    # (the s=2 level: every fine IRLS render and the keyframing render)
    src = "gs_slam_analytica_jacobian_tpu_torch/csrc/tile_kernel2_fwd.cu"
    pallas = "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py"

    def pick(with_nt):
        return next(c for c in cases
                    if c["case"] == "room_s2" and c["with_ntouch"] == with_nt
                    and not c["nt_weight"])

    kernels = []
    for name, with_nt, line in (("composite32_fwd", False, 662),
                                ("composite32_fwd_ntouch", True, 642)):
        c = pick(with_nt)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=f"{pallas}:{line}",
            launches=launches[name], max_abs_err=max(c["max_abs_err"].values()),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=None, shape=c["shape"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

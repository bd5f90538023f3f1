"""Benchmark of the port: RGB-D tracking FPS on a Replica-scale scene
(the counterpart of the repository's ``bench.py``).

    python -m gs_slam_analytica_jacobian_tpu_torch.bench [--device cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}. Baseline target (BASELINE.json): >= 30 FPS RGB-D tracking on
Replica room0. The scene is the synthetic converged-map stand-in
(``scenes.make_room_map``, 200k Gaussians at 1200x680, fx = fy = 600),
and the work timed is the tracker's per-frame optimization over a short
trajectory, each frame warm-started from the previous estimate.

The same ``BENCH_*`` knobs as the reference bench, with the same
defaults: BENCH_GAUSSIANS, BENCH_PAIR_CAP, BENCH_FRAMES, BENCH_SCENE
(room / blobs), BENCH_STEP_SCALE, BENCH_TRACKER (pyr / gn / adam), the
pyramid tracker's BENCH_LEVELS, ITERS, EXACT, PROBES, CURV, BF16,
MATCH_BLUR, MXU, TILE16, PAD, SIGMA0, SIGMA_DECAY, SUBSET, FINAL_LEVEL,
and BENCH_REUSE_H, PLAN_REUSE, VISCULL, VISQ, WARMSTART, ALPHA, ADAPT,
ADAPT_LEVELS, WARM_REPS, REPS. A combination the tracker refuses (tile16
with bf16 or mxu) raises here too.

After a collecting pass the bench adapts as the reference bench does:
per-level pair-capacity buckets from the observed pair counts, and after
a three-frame easy streak the s >= 4 iterations dropped and the pad cut
to 2 px; it re-collects at the adapted schedule, runs WARM_REPS warm
reps and times REPS reps (``torch.cuda.synchronize()`` around each). The
value is 1 / (median rep wall / tracked frames).

Runs on the GPU; ``--device cpu`` runs the kernels' plain PyTorch
versions (without a GPU and without it, it raises).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch


def pose_list(n: int, step_scale: float = 1.0):
    """The reference bench's trajectory: ~6 mm + 4 mrad a frame (x
    ``step_scale``), composed in float32."""
    from .ops.lie import se3_exp
    tau_step = step_scale * np.array(
        [0.0035, -0.0028, 0.0042, 0.002, 0.003, -0.0015], np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(1, n):
        step = torch.as_tensor(
            (tau_step * (1.0 + 0.1 * np.sin(k))).astype(np.float32))
        poses.append(se3_exp(step).numpy() @ poses[-1])
    return poses


def blobs_map(N: int, rng):
    """The legacy 'blobs' scene: an unstructured Gaussian cloud."""
    means = np.stack([
        rng.uniform(-4, 4, N), rng.uniform(-2.5, 2.5, N),
        rng.uniform(0.4, 8.0, N)], -1).astype(np.float32)
    return dict(
        xyz=means,
        features_dc=rng.normal(size=(N, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((N, 0, 3), np.float32),
        scaling=rng.normal(size=(N, 3)).astype(np.float32) * 0.3 - 4.0,
        rotation=rng.normal(size=(N, 4)).astype(np.float32),
        opacity=rng.normal(size=(N, 1)).astype(np.float32) + 1.0)


def tracker_options(env: Mapping[str, str], pair_cap: int):
    """(tracker name, its keyword options) from the BENCH_* knobs: the
    pyramid tracker's options start at the reference bench's operating
    point (fine tracking at s=2, final level 2, match_blur, pad 4)."""
    tracker = env.get("BENCH_TRACKER", "pyr")
    kw = {}
    if tracker != "pyr":
        return tracker, kw
    kw.update(curv="flow", level_exact=(0, 0, 0), level_iters=(5, 12, 2),
              final_level=2, match_blur=True, plan_pad=4.0,
              pair_capacity_ceiling=pair_cap)

    def ints(name):
        return tuple(int(x) for x in env[name].split(","))
    if "BENCH_LEVELS" in env:
        kw["levels"] = ints("BENCH_LEVELS")
    if "BENCH_ITERS" in env:
        kw["level_iters"] = ints("BENCH_ITERS")
    if "BENCH_EXACT" in env:
        kw["level_exact"] = ints("BENCH_EXACT")
    if "BENCH_PROBES" in env:
        kw["probe_levels"] = env["BENCH_PROBES"]
    if "BENCH_CURV" in env:
        kw["curv"] = env["BENCH_CURV"]
    if env.get("BENCH_BF16") == "1":
        kw["kernel_bf16"] = True
    if env.get("BENCH_MATCH_BLUR") == "1":
        kw["match_blur"] = True
    if env.get("BENCH_MXU") == "1":
        kw["kernel_mxu"] = True
    if env.get("BENCH_TILE16") == "1":
        kw["tile16"] = True
    if "BENCH_PAD" in env:
        kw["plan_pad"] = float(env["BENCH_PAD"])
    if "BENCH_SIGMA0" in env:
        kw["sigma0"] = float(env["BENCH_SIGMA0"])
    if "BENCH_SIGMA_DECAY" in env:
        kw["sigma_decay"] = float(env["BENCH_SIGMA_DECAY"])
    if "BENCH_SUBSET" in env:
        kw["level_subset"] = tuple(
            float(x) for x in env["BENCH_SUBSET"].split(","))
    if "BENCH_FINAL_LEVEL" in env:
        kw["final_level"] = int(env["BENCH_FINAL_LEVEL"])
    # level_exact follows a custom level count (the tracker zips them)
    n_lv = len(kw.get("levels", (4, 2, 1)))
    if len(kw["level_exact"]) != n_lv:
        kw["level_exact"] = (0,) * (n_lv - 1) + (1,)
    return tracker, kw


def adapt_schedule(kw: dict, npairs, easy_flags, env: Mapping[str, str],
                   pair_cap: int, level_caps=None):
    """The reference bench's two adaptive steps after a collecting pass,
    for the pyramid tracker: per-level pair-capacity buckets (the
    frontend's steady-state rule: observed pairs x1.5, 128k quanta, the
    config cap as ceiling; BENCH_ADAPT=0 disables), and after a 3-frame
    easy streak (warm-start correction < 2 px of flow and motion < 8 px)
    the s >= 4 iterations dropped and the pad cut to <= 2 px (unless
    BENCH_ITERS or BENCH_PAD is set; BENCH_ADAPT_LEVELS=0 disables).
    Updates ``kw`` in place; returns (level caps, adapted)."""
    from .slam.tracking import pair_capacity_bucket
    adapted = False
    if npairs is not None and env.get("BENCH_ADAPT", "1") == "1":
        caps = tuple(pair_capacity_bucket(int(p), pair_cap) if p > 0
                     else pair_cap for p in npairs)
        if caps != level_caps:
            level_caps, adapted = caps, True
    if (len(easy_flags) >= 3 and all(easy_flags[-3:])
            and "BENCH_ITERS" not in env
            and env.get("BENCH_ADAPT_LEVELS", "1") == "1"):
        lv = kw.get("levels", (4, 2, 1))
        it = kw.get("level_iters", (5, 12, 2))
        kw["level_iters"] = tuple(0 if s >= 4 else i for s, i in zip(lv, it))
        if "BENCH_PAD" not in env:
            kw["plan_pad"] = min(kw["plan_pad"], 2.0)
        adapted = True
    return level_caps, adapted


def cv_start(R1, t1, R0, t0):
    """Compose the last inter-frame delta onto the previous estimate:
    T_w = (T1 T0^-1) T1."""
    Rd = R1 @ R0.T
    return Rd @ R1, Rd @ (t1 - t0) + t1


def ca_start(R1, t1, R0, t0, Rm, tm):
    """Constant-acceleration prediction T_w = (D1 D0^-1) D1 T1 with
    D_i = T_{i+1} T_i^-1."""
    Rd1 = R1 @ R0.T
    td1 = t1 - Rd1 @ t0
    Rd0 = R0 @ Rm.T
    td0 = t0 - Rd0 @ tm
    Ra = Rd1 @ Rd0.T
    ta = td1 - Ra @ td0
    Rp = Ra @ Rd1
    tp = Ra @ td1 + ta
    return Rp @ R1, Rp @ t1 + tp


def run_bench(n_gaussians: int = 200_000, width: int = 1200,
              height: int = 680, frames: int = 5, device=None,
              env: Optional[Mapping[str, str]] = None) -> dict:
    """The bench at the given scene size, resolution (fx = fy = width / 2,
    the reference's 600 at 1200 px) and frame count, with the other
    BENCH_* knobs from ``env`` (default: none set). Returns the record
    ``main`` prints."""
    from .device import card_line, resolve_device
    from .models import gaussian_map as gmap
    from .models.camera import Camera
    from .ops import launches, losses
    from .scenes import make_room_map
    from .slam import tracking
    from .slam.render_api import render

    env = {} if env is None else env
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    W, H, N, F = int(width), int(height), int(n_gaussians), int(frames)
    fx = fy = 0.5 * W
    PAIR_CAP = int(env.get("BENCH_PAIR_CAP", 1 << 20))
    cam = Camera.create(np.eye(3), np.zeros(3), fx, fy, (W - 1) / 2,
                        (H - 1) / 2, W, H, device=dev)
    rng = np.random.default_rng(0)
    scene = env.get("BENCH_SCENE", "room")
    arrays = blobs_map(N, rng) if scene == "blobs" else make_room_map(N, rng)
    gm = gmap.from_numpy(**arrays, max_sh_degree=0, device=dev)
    bg = torch.zeros(3, device=dev)

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    launches.reset()
    poses = pose_list(F, float(env.get("BENCH_STEP_SCALE", 1.0)))
    gts, overflow = [], 0
    for T in poses:
        c = cam.replace(R=torch.as_tensor(T[:3, :3], device=dev),
                        t=torch.as_tensor(T[:3, 3], device=dev))
        out_gt = render(gm, c, None, bg, pair_capacity=PAIR_CAP, device=dev)
        img = torch.clamp(out_gt.color, 0, 1)
        # the reference tracks under the Scharr edge mask
        mask = losses.compute_grad_mask(img.mean(dim=0, keepdim=True),
                                        edge_threshold=1.1,
                                        dataset_type="replica")
        gts.append((img, out_gt.depth, mask))
        overflow = max(overflow, int(out_gt.overflow))

    tracker, kw = tracker_options(env, PAIR_CAP)
    track_fn = {"gn": tracking.track_frame_gn,
                "pyr": tracking.track_frame_pyr,
                "adam": tracking.track_frame}[tracker]
    max_iters = 100 if tracker == "adam" else 20
    pyr = tracker == "pyr"
    reuse_H = pyr and env.get("BENCH_REUSE_H", "1") == "1"
    # cross-frame pair-plan reuse: plans rebuilt every K frames
    plan_reuse = int(env.get("BENCH_PLAN_REUSE", "2")) if pyr else 0
    # visibility-culled tracking: every Mth frame refreshes the mask of
    # Gaussians with n_touched >= Q; 0 disables
    vis_cull = int(env.get("BENCH_VISCULL", "0")) if pyr else 0
    vis_q = int(env.get("BENCH_VISQ", "1"))
    alpha = float(env.get("BENCH_ALPHA", 0.95))
    warm_mode = env.get("BENCH_WARMSTART", "const_acc")
    const_vel = warm_mode in ("const_vel", "const_acc")
    const_acc = warm_mode == "const_acc"

    cap_eff = [PAIR_CAP]   # the fine level's adaptive bucket
    lvl_caps = [None]      # per-level adaptive buckets, or None
    vis_frac = [None]

    def track_one(k, R_start, t_start, H_in, plan_in=None, track_mask=None,
                  nt_weight=False):
        kw_k = dict(kw)
        if pyr:
            kw_k.update(H_in=H_in, level_caps=lvl_caps[0], plan_in=plan_in,
                        track_mask=track_mask, nt_weight=nt_weight)
        return track_fn(
            gm, cam, R_start, t_start, gts[k][0], gts[k][1], gts[k][2], bg,
            lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
            alpha=alpha, max_iters=max_iters, pair_capacity=cap_eff[0],
            device=dev, **kw_k)

    def flow_px(Ra, ta, Rb, tb):
        """Pose difference in image-flow pixels at the median depth."""
        dt_ = float(torch.linalg.norm(ta - tb))
        ang = float(torch.arccos(torch.clamp(
            (torch.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))
        return fx * dt_ / med_depth + fx * ang

    def run_sequence(eps, collect=False):
        """Track frames 1..F-1 warm-started from the previous estimate;
        host reads (errors, iterations, pairs) only when ``collect``."""
        R_est = torch.as_tensor(poses[0][:3, :3], device=dev)
        t_est = torch.as_tensor(poses[0][:3, 3], device=dev) + eps
        R_pp = t_pp = R_ppp = t_ppp = None
        H_carry = None
        plan_carry, plan_age = None, 0
        vis_mask, vis_age = None, 0
        errs, iters_tot, npairs, easy_flags = [], 0, None, []
        for k in range(1, F):
            if const_acc and R_ppp is not None:
                R_ws, t_ws = ca_start(R_est, t_est, R_pp, t_pp, R_ppp, t_ppp)
            elif const_vel and R_pp is not None:
                R_ws, t_ws = cv_start(R_est, t_est, R_pp, t_pp)
            else:
                R_ws, t_ws = R_est, t_est
            R_ppp, t_ppp = R_pp, t_pp
            R_pp, t_pp = R_est, t_est
            vis_refresh = vis_cull and (vis_mask is None
                                        or vis_age >= vis_cull)
            use_plan = (plan_carry if (plan_reuse and plan_age < plan_reuse
                                       and not vis_refresh) else None)
            res = track_one(
                k, R_ws, t_ws, H_carry if (reuse_H and k > 1) else None,
                plan_in=use_plan,
                track_mask=(None if (not vis_cull or vis_refresh)
                            else vis_mask),
                nt_weight=bool(vis_cull))
            R_est, t_est = res[0], res[1]
            if reuse_H:
                H_carry = res[7]
            if vis_cull:
                if vis_refresh:
                    vis_mask, vis_age = res[5].n_touched >= vis_q, 0
                    if collect:
                        vis_frac[0] = float(torch.sum(vis_mask)) / N
                else:
                    vis_age += 1
            if plan_reuse:
                if use_plan is None:
                    plan_carry, plan_age = res[11], 1
                else:
                    plan_age += 1
            if collect:
                iters_tot += int(res[4])
                errs.append(float(torch.linalg.norm(
                    t_est.cpu() - torch.as_tensor(poses[k][:3, 3]))))
                if pyr:
                    lp = res[10].cpu().numpy().astype(np.int64)
                    npairs = lp if npairs is None else np.maximum(npairs, lp)
                # warm-start correction and raw motion in flow pixels (the
                # frontend's hardness signals; motion at 4x the threshold)
                easy_flags.append(
                    flow_px(R_est, t_est, R_ws, t_ws) < 2.0
                    and flow_px(R_est, t_est, R_pp, t_pp) < 8.0)
        return errs, iters_tot, t_est, npairs, easy_flags

    d1 = gts[1][1]
    med_depth = float(torch.median(d1[d1 > 0]))
    zero3 = torch.zeros(3, device=dev)

    # warm pass and accuracy collection
    errs, iters_tot, _, npairs, easy_flags = run_sequence(zero3,
                                                          collect=True)

    adapted = False
    if pyr:
        caps, adapted = adapt_schedule(kw, npairs, easy_flags, env, PAIR_CAP,
                                       lvl_caps[0])
        if caps != lvl_caps[0]:
            lvl_caps[0] = caps
            cap_eff[0] = caps[-1]
    if pyr and adapted:
        # re-collect accuracy and pair counts at the adapted schedule
        errs, iters_tot, _, npairs, _ = run_sequence(zero3, collect=True)

    # warm passes over the timed loop's exact path (no host reads)
    for wr in range(int(env.get("BENCH_WARM_REPS", 2))):
        run_sequence(torch.full((3,), -(wr + 1) * 3e-6, device=dev))
        sync()

    # each rep starts 3e-6 m off the true first pose, as the reference
    # bench's reps do, so that every rep tracks the inputs the reference
    # times; 0.003 mm is far below the 0.08 mm accuracy floor
    n_rep = int(env.get("BENCH_REPS", 3))
    rep_walls = []
    t_last = zero3
    for r in range(n_rep):
        sync()
        t0_rep = time.perf_counter()
        eps = t_last * 1e-30 + (r + 1) * 3e-6
        _, _, t_last, _, _ = run_sequence(eps)
        sync()
        rep_walls.append(time.perf_counter() - t0_rep)
    dt = float(np.median(rep_walls)) / (F - 1)
    fps = 1.0 / dt

    # the compositing forward's walked cells a frame: IRLS iterations are
    # forward renders; the keyframing render adds one at the last level.
    # The per-level iteration counts are the schedule scaled to the
    # measured total.
    cells_per_frame = None
    if pyr and npairs is not None:
        it_l = kw.get("level_iters", (5, 12, 2))
        sched = sum(it_l)
        frac = (iters_tot / (F - 1)) / sched if sched else 0.0
        cells_per_frame = 1024.0 * (
            frac * sum(float(p) * it for p, it in zip(npairs, it_l))
            + float(npairs[-1]))

    return {
        "metric": "tracking_fps_replica_scale",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 3),
        "detail": {
            "n_gaussians": N, "resolution": f"{W}x{H}",
            "frames": F - 1,
            "iters_per_frame": round(iters_tot / (F - 1), 2),
            "ms_per_frame": round(dt * 1000, 2),
            "pair_capacity": cap_eff[0],
            "pair_capacity_ceiling": PAIR_CAP,
            "gt_render_overflow": overflow,
            "tracker": tracker,
            "level_iters": list(kw.get("level_iters", ())),
            "level_caps": list(lvl_caps[0] or ()),
            "level_pairs": (None if npairs is None
                            else [int(p) for p in npairs]),
            "reuse_H": reuse_H,
            "plan_reuse": plan_reuse,
            "vis_cull": vis_cull,
            "vis_q": vis_q,
            "vis_frac": (None if vis_frac[0] is None
                         else round(vis_frac[0], 4)),
            "plan_pad": kw.get("plan_pad"),
            "kernel_bf16": bool(kw.get("kernel_bf16", False)),
            "kernel_mxu": bool(kw.get("kernel_mxu", False)),
            "tile16": bool(kw.get("tile16", False)),
            "final_level": kw.get("final_level", 1),
            "rep_walls_s": [round(w, 3) for w in rep_walls],
            "warm_start": warm_mode,
            "pose_err_mean_m": round(float(np.mean(errs)), 6),
            "pose_err_max_m": round(float(np.max(errs)), 6),
            "pair_cells_per_frame": (None if cells_per_frame is None
                                     else int(cells_per_frame)),
            "kernel_launches": launches.counts(),
            "device": card_line() if on_cuda else str(dev),
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    env = os.environ
    rec = run_bench(int(env.get("BENCH_GAUSSIANS", 200_000)), 1200, 680,
                    int(env.get("BENCH_FRAMES", 5)), args.device, env)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()

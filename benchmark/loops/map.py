"""The keyframe-mapping loop: keyframes arrive back to back at the
configuration's spacing along the camera's loop, and each goes through
the mapping backend as the SLAM system hands it over: ``add_next_kf``
(store and seed) and ``handle_keyframe`` (the window's optimisation and
its prune pass), single-threaded, until the window's time is up (the
keyframe in flight is finished).

Set-up makes the world (from the configuration's world seed; the run's
seed picks where on the loop the stream starts, the pose errors and the
checked iterations), renders the keyframes' frames with the plain
reference, initialises the map from keyframe 0 and fills the window;
those keyframes also warm every shape. Every keyframe reaches the backend
1 mm and 1 mrad off its true pose, in a direction drawn from the seed
(the error scale tracking leaves).

The run also notes ``pose_err_mm``, the mean translation error of the
keyframes in the backend's window when the time is up (all but keyframe
0, which stays at its true pose); it is not compared (PERF.md). Checked
once the window has closed, on the first iterations of ``CHECK_ITERS``
batches drawn from the seed, each a batch that built its pair plans from
its own entry state:

- ``grad_gap.<group>``: the gradient each parameter group of the map, the
  keyframes' poses and their exposures got (worked out from the Adam
  moments before and after the iteration) against the reference's
  gradient of the same iteration, recomputed from the program's state
  before it (map, poses, exposures, window; the frames are the
  benchmark's): the norm of the difference over the larger of the
  reference's norm of that group and of the median group (a group whose
  gradient is small carries rounding large against it), the worst
  sampled iteration; a group whose reference gradient is under a
  thousandth of the median group's is left out of that iteration. Each
  group named in the cell's limits is held to its own limit (PERF.md
  says why scaling and rotation are not);
- ``adam_gap``: on the same iterations, the parameters the program
  stepped to against the Adam step of the reference from the program's
  gradient: the largest relative difference over the groups.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import devtrace, harness, work
from ..harness import Check, Context, Run
from ..reference import mapping as rmap
from ..reference import render as rr
from ..reference import scene as rscene
from ..reference import trajectory as rtraj
PERTURB_M, PERTURB_RAD = 1e-3, 1e-3
# what the checks and the trace read (the tests shrink them): the first
# iterations of CHECK_ITERS batches drawn from CHECK_RANGE (counted in
# fresh-plan batches of the window); the keyframe TRACE_KF of the window
# (its intake and its first TRACE_ITERS iterations), with the work of
# every TRACE_STRIDE-th compositing call counted
CHECK_ITERS, CHECK_RANGE = 2, (2, 12)
TRACE_KF, TRACE_ITERS, TRACE_STRIDE = 3, 11, 8


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pose_tensors(T, dev):
    return (torch.tensor(T[:3, :3], dtype=torch.float32, device=dev),
            torch.tensor(T[:3, 3], dtype=torch.float32, device=dev))


def perturbed(T, rng):
    """T moved by Exp(tau), |rho| = 1 mm, |theta| = 1 mrad, in seeded
    directions."""
    rho, theta = rng.normal(size=3), rng.normal(size=3)
    rho = rho / np.linalg.norm(rho) * PERTURB_M
    theta = theta / np.linalg.norm(theta) * PERTURB_RAD
    D = np.eye(4)
    D[:3, :3] = rtraj.so3_exp_np(theta)
    th = float(np.linalg.norm(theta))
    K = np.array([[0, -theta[2], theta[1]], [theta[2], 0, -theta[0]],
                  [-theta[1], theta[0], 0]])
    V = (np.eye(3) + (1 - math.cos(th)) / th ** 2 * K
         + (th - math.sin(th)) / th ** 3 * K @ K)
    D[:3, 3] = V @ rho
    return D @ T


def backend_config(cfg: dict, seed: int) -> dict:
    out = {k: (dict(cfg[k]) if isinstance(cfg[k], dict) else cfg[k])
           for k in ("Training", "Dataset", "opt_params", "model_params")}
    out["seed"] = int(seed)
    return out


def rel(a, b):
    nb = float(torch.linalg.norm(b))
    return float(torch.linalg.norm(a - b)) / max(nb, 1e-30), nb


def run(ctx: Context) -> Run:
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
    from gs_slam_analytica_jacobian_tpu_torch.slam import mapping
    from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd

    dev = ctx.device
    cfg, trf = ctx.config, ctx.traffic
    camc = cfg["camera"]
    T_cfg = cfg["Training"]
    W, H = int(camc["width"]), int(camc["height"])
    rng = np.random.default_rng(ctx.seed)

    # -- set-up ----------------------------------------------------------
    sc = rscene.room_map(int(cfg["world"]["gaussians"]),
                         int(cfg["world"]["seed"]), dev)
    P = int(trf["frames_in_loop"])
    loop = rtraj.loop(P, float(trf["step_m"]), float(trf["step_rad"]))
    every = int(T_cfg["kf_interval"])
    n_views = P // math.gcd(P, every)
    k0 = ctx.seed % P
    kf_poses = [loop[(k0 + j * every) % P] for j in range(n_views)]
    rcam = rr.Cam(R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev),
                  fx=float(camc["fx"]), fy=float(camc["fy"]),
                  cx=float(camc["cx"]), cy=float(camc["cy"]), width=W,
                  height=H)
    bg = torch.zeros(3, device=dev)
    views = []
    for T in kf_poses:
        out = rr.render(sc, rcam.at(*pose_tensors(T, dev)), bg)
        views.append((torch.clamp(out["color"], 0.0, 1.0), out["depth"]))
    del sc
    cam = Camera.create(np.eye(3), np.zeros(3), camc["fx"], camc["fy"],
                        camc["cx"], camc["cy"], W, H, device=dev)
    be = BackEnd(backend_config(cfg, ctx.seed), cam, device=dev)
    be.prewarm_mapping()
    wsize = be.window_size

    def add(j, init=False):
        T = kf_poses[j % n_views] if init else perturbed(
            kf_poses[j % n_views], rng)
        img, depth = views[j % n_views]
        be.add_next_kf(j, T[:3, :3], T[:3, 3], 0.0, 0.0, img, depth,
                       depth[0], init=init)

    add(0, init=True)
    be.initialize_map(0)
    window = [0]
    for j in range(1, wsize):
        add(j)
        window = ([j] + window)[:wsize]
        be.handle_keyframe(j, window)
    sync(dev)

    samples = set(int(x) for x in rng.choice(np.arange(*CHECK_RANGE),
                                             CHECK_ITERS, replace=False))
    kept = {}
    it_no = [0]
    trace_kf, trace_iters = TRACE_KF, TRACE_ITERS
    prof = [None]
    tracing = [False]
    calls = work.Calls(TRACE_STRIDE)
    orig_iter = mapping._mapping_iter
    orig_comp = renderer_tiled.composite32

    def stop_trace():
        renderer_tiled.composite32 = orig_comp
        sync(dev)
        prof[0].__exit__(None, None, None)
        tracing[0] = False

    traced_iters = [0]
    # the sampled iterations are first iterations of batches that built
    # their pair plans from their own entry state: there the plans'
    # pairs and order are those of the iteration's state, which the
    # reference bins afresh (a reused plan keeps an earlier state's)
    fresh = [False, 0]
    orig_steps = mapping.mapping_steps

    def spy_steps(*a, **k):
        fresh[0] = k.get("window_plans_in") is None
        return orig_steps(*a, **k)

    def spy_iter(*a, **k):
        it_no[0] += 1
        sample = fresh[0]
        if sample:
            fresh[0] = False
            fresh[1] += 1
        out = iter_fn(*a, **k)
        if sample and fresh[1] in samples:
            kept[it_no[0]] = (a, out)
        if tracing[0]:
            traced_iters[0] += 1
            if traced_iters[0] >= trace_iters:
                stop_trace()
        return out

    iter_fn = orig_iter
    if ctx.fault == "unchanged":
        def iter_fn(gm, gm_adam, store, pose_adam, *a, **k):
            out = orig_iter(gm, gm_adam, store, pose_adam, *a, **k)
            return out._replace(gm=gm, gm_adam=gm_adam, store=store,
                                pose_adam=pose_adam)
    elif ctx.fault == "half_batch":
        def iter_fn(gm, gm_adam, store, pose_adam, window_idx, window_valid,
                    *a, **k):
            valid = list(window_valid)
            n = sum(valid)
            kept_n = 0
            for j, v in enumerate(valid):
                if v:
                    kept_n += 1
                    valid[j] = kept_n <= (n + 1) // 2
            return orig_iter(gm, gm_adam, store, pose_adam, window_idx,
                             valid, *a, **k)
    elif ctx.fault == "altered":
        def iter_fn(*a, **k):
            out = orig_iter(*a, **k)
            xyz = out.gm.xyz + 1e-3 * out.gm.active[:, None]
            return out._replace(gm=out.gm.replace(xyz=xyz))
    mapping._mapping_iter = spy_iter
    mapping.mapping_steps = spy_steps

    # -- the window ----------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seed_s, window_kfs = [], []
    it0 = be.iteration_count
    sync(dev)
    host_at_start = harness.host_state()
    setup_s = time.perf_counter() - ctx.t_start
    t_win = time.perf_counter()
    cpu0 = time.process_time()
    j = wsize - 1
    while True:
        j += 1
        if ctx.trace and j == wsize - 1 + trace_kf:
            from torch.profiler import ProfilerActivity, profile
            prof[0] = profile(activities=[
                ProfilerActivity.CUDA if dev.type == "cuda"
                else ProfilerActivity.CPU])
            prof[0].__enter__()
            renderer_tiled.composite32 = calls.wrap(orig_comp)
            tracing[0] = True
        # the keyframe intake's span (traced runs, up to the traced
        # keyframe: the profiler slows the process for the rest of it)
        span = ctx.trace and j <= wsize - 1 + trace_kf
        if span:
            sync(dev)
            t0 = time.perf_counter()
        add(j)
        if span:
            sync(dev)
            seed_s.append(time.perf_counter() - t0)
        window = ([j] + window)[:wsize]
        be.handle_keyframe(j, window)
        if tracing[0]:
            stop_trace()
        window_kfs.append(j)
        sync(dev)
        if time.perf_counter() - t_win >= ctx.seconds and (
                not ctx.trace or j >= wsize - 1 + trace_kf):
            break
    window_s = time.perf_counter() - t_win
    cpu_s = time.process_time() - cpu0
    host_at_end = harness.host_state()
    iters = be.iteration_count - it0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    mapping._mapping_iter = orig_iter
    mapping.mapping_steps = orig_steps

    # -- checks ----------------------------------------------------------
    final = [u for u in window if u != 0]
    slots = [be.uid_to_slot[u] for u in final]
    t_got = be.store.t[torch.as_tensor(slots, device=dev)].cpu().double()
    t_true = torch.tensor(np.stack([kf_poses[u % n_views][:3, 3]
                                    for u in final]))
    err = torch.linalg.norm(t_got - t_true, dim=1)
    failed = int((~torch.isfinite(err)).sum())
    pose_err_mm = float(err.mean()) * 1e3
    uid_of_slot = {s: u for u, s in be.uid_to_slot.items()}
    del be

    gaps = {"adam_gap": []}
    detail = []
    for it, (a, out) in sorted(kept.items()):
        (gm, gm_adam, store, pose_adam, window_idx, window_valid, opt_pose,
         opt_exp, cam_t, _bg, gm_lrs, xyz_lr, lr_rot, lr_trans, rgb_bt,
         n_window, alpha, monocular, initialization) = a[:19]
        level = a[23]
        if level != 1 or initialization or monocular:
            raise RuntimeError("the mapping check covers full-resolution "
                               "RGB-D window iterations")
        vs, js = [], []
        for jj, v in enumerate(window_valid):
            if not v:
                continue
            s = int(window_idx[jj])
            img, depth = rmap.quantized(*views[uid_of_slot[s] % n_views])
            vs.append((store.R[s], store.t[s], store.exposure_a[s],
                       store.exposure_b[s], img, depth))
            js.append(jj)
        params = {f: getattr(gm, f) for f in rmap.FIELDS}
        g_prog = {f: (out.gm_adam.m[f] - 0.9 * gm_adam.m[f]) / 0.1
                  for f in rmap.FIELDS}
        g8 = (out.pose_adam.m - 0.9 * pose_adam.m) / 0.1
        g_prog["pose"] = g8[js, :6]
        g_prog["exposure"] = g8[js, 6:]
        for bf16 in ((False, True) if ctx.control else (False,)):
            g_ref, per_view, _ = rmap.window_grads(
                params, gm.active, vs, rcam, float(alpha), float(rgb_bt),
                bf16=bf16)
            g_ref = dict(g_ref)
            g_ref["pose"] = torch.stack([p[0] for p in per_view])
            g_ref["exposure"] = torch.stack(
                [torch.stack([p[1], p[2]]) for p in per_view])
            r = {f: rel(g_prog[f], g_ref[f]) for f in g_ref}
            med = float(np.median([nb for _, nb in r.values()]))
            for f, (gap, nb) in r.items():
                if nb >= 1e-3 * med:
                    gaps.setdefault(f"grad_gap.{f}"
                                    + (".control" if bf16 else ""),
                                    []).append(gap * nb / max(nb, med))
            detail.append(dict(iteration=it, control=bf16, **{
                f: dict(gap=gap, norm=nb) for f, (gap, nb) in r.items()}))
        lrs = dict(gm_lrs, xyz=xyz_lr)
        step = int(out.gm_adam.step)
        adam = []
        for f in rmap.FIELDS:
            new_ref = rmap.adam_step(params[f], g_prog[f], gm_adam.m[f],
                                     gm_adam.v[f], step, lrs[f])
            adam.append(rel(getattr(out.gm, f) - params[f],
                            new_ref - params[f])[0])
        gaps["adam_gap"].append(max(adam))
    lim = ctx.cell["limits"]
    checks = [Check(name, max(vals), float(lim[name.removesuffix(".control")]))
              for name, vals in gaps.items()
              if vals and name.removesuffix(".control") in lim]

    tr = work_out = None
    if prof[0] is not None:
        tr = devtrace.reduce(devtrace.export_events(prof[0]))
        work_out = calls.shares(tr["composite_durs"], rr.walk,
                                rr.tile_lists)
    e2e = dict(map_ms_per_iter=window_s / iters * 1e3, setup_s=setup_s)
    notes = dict(keyframes=len(window_kfs), iterations=iters,
                 window_s=window_s, cpu_s=cpu_s, host_at_start=host_at_start,
                 host_at_end=host_at_end, grad_gap=detail,
                 adam_gap=gaps["adam_gap"], pose_err_mm=pose_err_mm,
                 err_mm_max=float(err.max()) * 1e3)
    return Run(end_to_end=e2e, checks=checks, attempted=len(window_kfs),
               failed=failed, memory_peak_bytes=peak,
               counters=dict(keyframes=len(window_kfs), iterations=iters,
                             traced_iters=traced_iters[0]),
               spans=dict(seed=seed_s), trace=tr, work=work_out,
               notes=notes)

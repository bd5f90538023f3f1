"""The monocular keyframe-mapping loop: ``loops/map.py``'s stream (the same
world, loop and pose errors, keyframes back to back, single-threaded)
under a monocular configuration. A monocular keyframe has no sensor depth,
so each is handed over as the SLAM frontend's monocular branch hands it
over: one full-resolution render of the backend's map at the handed-over
pose, the frontend's ``mono_initial_depth`` on the host (median and std of
the rendered depth, host-generator noise), then ``add_next_kf`` with no
depth and that map to seed from. Keyframe 0 seeds from the random
2 +- 0.3 m depth the frontend's ``initialize`` gives it. The backend maps
RGB only, and its covisibility prune takes Gaussians out after every
keyframe once the first window is full.

Set-up makes the world and the keyframes' frames, initialises the map
from keyframe 0 and fills the window: the backend's monocular start-up
(``mapping_itr_num`` iterations a keyframe until the window is full, then
the initial bundle adjustment and the first prune). In the window every
keyframe's hand-over (render, depth, intake) and its mapping are timed.

The checks are ``loops/map.py``'s (``grad_gap.<group>``, ``adam_gap``)
against ``reference/mapping_mono.py``, on the first iterations of
fresh-plan batches drawn from the seed (map.py's ``CHECK_ITERS``,
``CHECK_RANGE``), and two of the monocular keyframe, each on one window
keyframe drawn from the seed out of ``KF_CHECK_RANGE``:

- ``handover_gap``: the valid-pixel count, median and std that
  ``mono_initial_depth`` drew the keyframe's seeding depth around (its
  span's attributes) against ``seeding_stats`` of the reference's render
  of the same map at the handed-over pose: the largest relative
  difference of the three;
- ``prune_gap``: the Gaussians the keyframe's covisibility prune took out
  of the map (active before it, not after) against
  ``covisibility_prune`` of the reference's ``touched`` sets, one a
  window keyframe, of the map and poses the prune saw: the size of the
  symmetric difference over the reference's count (at least 1).

The run also notes ``pose_err_mm`` (the window's keyframes against their
true poses; the handed-over poses are metric), the map's active Gaussians
when the time is up and the hand-over's milliseconds a keyframe; none is
compared. Besides ``control.py``'s faults the loop plants two of its own:
``prune_coviz`` (the prune takes the Gaussians seen by 4 window keyframes
too) and ``handover_pose`` (the hand-over renders at the previous view's
pose).

With ``--trace 1`` the program's span recorder is on over the window's
keyframes before the traced one (map.py's ``TRACE_KF``: the profiler
slows its keyframe), and ``Run.spans`` holds each kept span's seconds
under its name, and under ``seed`` the synchronised span of each
``add_next_kf`` up to the traced keyframe; the traced keyframe is
profiled, and its compositing calls' work counted, as in map.py.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import devtrace, harness, work
from ..harness import Check, Context, Run
from ..reference import mapping_mono as rmono
from ..reference import render as rr
from ..reference import scene as rscene
from ..reference import trajectory as rtraj
from . import map as mp
from .map import backend_config, perturbed, pose_tensors, rel, sync

# the window keyframes (1: the first timed one) out of which the seed
# draws the one whose hand-over, and the one whose prune, is checked
# (after map.py's TRACE_KF, so the recorder is off there in every run;
# the tests shrink it)
KF_CHECK_RANGE = (4, 12)


def run(ctx: Context) -> Run:
    # the hand-over's program function first: a tree without it stops here
    from gs_slam_analytica_jacobian_tpu_torch.slam.frontend import \
        mono_initial_depth
    from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
    from gs_slam_analytica_jacobian_tpu_torch.slam import mapping, render_api
    from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd
    from gs_slam_analytica_jacobian_tpu_torch.utils import trace as ptrace

    dev = ctx.device
    cfg, trf = ctx.config, ctx.traffic
    camc = cfg["camera"]
    T_cfg = cfg["Training"]
    if not T_cfg["monocular"]:
        raise ValueError("map_mono runs monocular configurations")
    W, H = int(camc["width"]), int(camc["height"])
    rgb_bt = float(T_cfg["rgb_boundary_threshold"])
    rng = np.random.default_rng(ctx.seed)
    # the frontend's own generator for the seeding depth's noise
    depth_rng = np.random.default_rng((ctx.seed, 1))

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
        views.append(torch.clamp(out["color"], 0.0, 1.0))
    del sc, out
    cam = Camera.create(np.eye(3), np.zeros(3), camc["fx"], camc["fy"],
                        camc["cx"], camc["cy"], W, H, device=dev)
    be = BackEnd(backend_config(cfg, ctx.seed), cam, device=dev)
    be.prewarm_mapping()
    wsize = be.window_size
    handover_s, seed_s = [], []
    kf_hand = kf_prune = -1          # drawn once the window is set up
    hand, pruned = {}, {}
    recording = [False]
    timing_seed = [False]

    def keep_hand(drained):
        for sp in drained:
            if (sp["name"] == "frontend.mono_depth"
                    and sp["attrs"].get("frame_idx") == kf_hand):
                hand["stats"] = sp["attrs"]

    def add(j, init=False):
        """The frontend's monocular keyframe hand-over."""
        T = kf_poses[j % n_views] if init else perturbed(
            kf_poses[j % n_views], rng)
        img = views[j % n_views]
        t0 = time.perf_counter()
        if init:
            depth_map = mono_initial_depth(img, None, None, rgb_bt,
                                           depth_rng, frame_idx=j)
        else:
            R_t, t_t = pose_tensors(T, dev)
            R_r, t_r = (pose_tensors(kf_poses[(j - 1) % n_views], dev)
                        if ctx.fault == "handover_pose" else (R_t, t_t))
            out = render_api.render(be.gm, cam.replace(R=R_r, t=t_r), None,
                                    be.bg, pair_capacity=be.pair_capacity,
                                    device=dev)
            own = j == kf_hand and not recording[0]
            if own:
                ptrace.enable(True)
            depth_map = mono_initial_depth(img, out.depth, out.opacity,
                                           rgb_bt, depth_rng, frame_idx=j)
            if own:
                ptrace.enable(False)
                keep_hand(ptrace.drain())
            if j == kf_hand:
                hand.update(gm=be.gm, R=R_t, t=t_t, img=img)
        handover_s.append(time.perf_counter() - t0)
        if timing_seed[0]:
            sync(dev)
            t0 = time.perf_counter()
        be.add_next_kf(j, T[:3, :3], T[:3, 3], 0.0, 0.0, img, None,
                       depth_map, init=init)
        if timing_seed[0]:
            sync(dev)
            seed_s.append(time.perf_counter() - t0)

    add(0, init=True)
    be.initialize_map(0)
    window = [0]
    for j in range(1, wsize):
        add(j)
        window = ([j] + window)[:wsize]
        be.handle_keyframe(j, window)
    sync(dev)
    handover_s.clear()

    samples = set(int(x) for x in rng.choice(np.arange(*mp.CHECK_RANGE),
                                             mp.CHECK_ITERS, replace=False))
    kf_hand, kf_prune = (wsize - 1 + int(x)
                         for x in rng.integers(*KF_CHECK_RANGE, size=2))
    kept = {}
    it_no = [0]
    trace_kf, trace_iters = mp.TRACE_KF, mp.TRACE_ITERS
    prof = [None]
    tracing = [False]
    calls = work.Calls(mp.TRACE_STRIDE)
    orig_iter = mapping._mapping_iter
    orig_comp = renderer_tiled.composite32

    def stop_trace():
        renderer_tiled.composite32 = orig_comp
        sync(dev)
        prof[0].__exit__(None, None, None)
        tracing[0] = False

    traced_iters = [0]
    # checked iterations are first iterations of fresh-plan batches
    # (map.py says why)
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

    # the prune of the keyframe kf_prune: the map and poses it saw (the
    # state its window's n_touched was rendered at) and the map after it
    orig_prune = be._covisibility_prune
    orig_gm_prune = gaussian_map.prune
    mapped = [None]

    def spy_prune(window_uids, n_touched):
        gm0, store0 = be.gm, be.store
        if ctx.fault == "prune_coviz":
            newest3 = sorted(window_uids, reverse=True)[2]

            def wider(gm, state, mask):
                return orig_gm_prune(gm, state, mask | (
                    (gm.n_obs == 4) & (gm.unique_kfids >= newest3)))
            gaussian_map.prune = wider
        try:
            orig_prune(window_uids, n_touched)
        finally:
            gaussian_map.prune = orig_gm_prune
        if mapped[0] == kf_prune:
            pruned.update(window=list(window_uids[:wsize]), gm=gm0,
                          store=store0, active=be.gm.active)
    be._covisibility_prune = spy_prune

    # -- the window ----------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window_kfs = []
    spans = {}
    prunes0 = ptrace.snapshot().get("backend.mono_prune", 0)
    it0 = be.iteration_count
    sync(dev)
    host_at_start = harness.host_state()
    setup_s = time.perf_counter() - ctx.t_start
    last_kf = max(kf_hand, kf_prune,
                  wsize - 1 + trace_kf if ctx.trace else 0)
    if ctx.trace:
        ptrace.drain()
        ptrace.enable(True)
        recording[0] = True
    t_win = time.perf_counter()
    cpu0 = time.process_time()
    j = wsize - 1
    while True:
        j += 1
        if ctx.trace and j == wsize - 1 + trace_kf:
            ptrace.enable(False)
            recording[0] = False
            drained = ptrace.drain()
            keep_hand(drained)
            for sp in drained:
                spans.setdefault(sp["name"], []).append(
                    (sp["end_ns"] - sp["start_ns"]) * 1e-9)
            from torch.profiler import ProfilerActivity, profile
            prof[0] = profile(activities=[
                ProfilerActivity.CUDA if dev.type == "cuda"
                else ProfilerActivity.CPU])
            prof[0].__enter__()
            renderer_tiled.composite32 = calls.wrap(orig_comp)
            tracing[0] = True
        # the intake's synchronised span (traced runs, up to the traced
        # keyframe: the profiler slows the process for the rest of it)
        timing_seed[0] = ctx.trace and j <= wsize - 1 + trace_kf
        mapped[0] = j
        add(j)
        window = ([j] + window)[:wsize]
        be.handle_keyframe(j, window)
        if tracing[0]:
            stop_trace()
        window_kfs.append(j)
        sync(dev)
        if time.perf_counter() - t_win >= ctx.seconds and j >= last_kf:
            break
    window_s = time.perf_counter() - t_win
    cpu_s = time.process_time() - cpu0
    host_at_end = harness.host_state()
    iters = be.iteration_count - it0
    prunes = ptrace.snapshot().get("backend.mono_prune", 0) - prunes0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    mapping._mapping_iter = orig_iter
    mapping.mapping_steps = orig_steps
    be._covisibility_prune = orig_prune
    active = int(be.gm.num_active())
    capacity = int(be.gm.capacity)

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
    slot_of_uid = dict(be.uid_to_slot)
    del be

    gaps = {"adam_gap": []}
    detail = []
    for it, (a, out) in sorted(kept.items()):
        (gm, gm_adam, store, pose_adam, window_idx, window_valid, opt_pose,
         opt_exp, cam_t, _bg, gm_lrs, xyz_lr, lr_rot, lr_trans, rgb_bt_it,
         n_window, alpha, monocular, initialization) = a[:19]
        level = a[23]
        if level != 1 or initialization or not monocular:
            raise RuntimeError("the monocular mapping check covers "
                               "full-resolution monocular window "
                               "iterations")
        vs, js = [], []
        for jj, v in enumerate(window_valid):
            if not v:
                continue
            s = int(window_idx[jj])
            img = views[uid_of_slot[s] % n_views]
            img, _ = rmono.quantized(img, torch.zeros_like(img[:1]))
            vs.append((store.R[s], store.t[s], store.exposure_a[s],
                       store.exposure_b[s], img))
            js.append(jj)
        params = {f: getattr(gm, f) for f in rmono.FIELDS}
        g_prog = {f: (out.gm_adam.m[f] - 0.9 * gm_adam.m[f]) / 0.1
                  for f in rmono.FIELDS}
        g8 = (out.pose_adam.m - 0.9 * pose_adam.m) / 0.1
        g_prog["pose"] = g8[js, :6]
        g_prog["exposure"] = g8[js, 6:]
        for bf16 in ((False, True) if ctx.control else (False,)):
            g_ref, per_view, _ = rmono.window_grads(
                params, gm.active, vs, rcam, float(rgb_bt_it), bf16=bf16)
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
        for f in rmono.FIELDS:
            new_ref = rmono.adam_step(params[f], g_prog[f], gm_adam.m[f],
                                      gm_adam.v[f], step, lrs[f])
            adam.append(rel(getattr(out.gm, f) - params[f],
                            new_ref - params[f])[0])
        gaps["adam_gap"].append(max(adam))

    # the checked keyframe's hand-over and prune
    if "stats" not in hand or "active" not in pruned:
        raise RuntimeError("the checked keyframes were not mapped")
    st = hand["stats"]
    got = (st["n_valid"], st["median"], st["std"])

    def scene_of(gm):
        return dict({f: getattr(gm, f) for f in rmono.FIELDS},
                    active=gm.active)
    gm1, store1 = pruned["gm"], pruned["store"]
    took = gm1.active & ~pruned["active"]
    kf_detail = []
    for bf16 in ((False, True) if ctx.control else (False,)):
        sfx = ".control" if bf16 else ""
        r = rr.render(scene_of(hand["gm"]), rcam.at(hand["R"], hand["t"]),
                      bf16=bf16)
        want = rmono.seeding_stats(hand["img"], r["depth"], r["opacity"],
                                   rgb_bt)
        gaps["handover_gap" + sfx] = [max(
            abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))]
        seen = [rmono.touched(scene_of(gm1),
                              rcam.at(store1.R[slot_of_uid[u]],
                                      store1.t[slot_of_uid[u]]), bf16=bf16)
                for u in pruned["window"]]
        ref = rmono.covisibility_prune(seen, gm1.unique_kfids, gm1.active,
                                       pruned["window"])
        differ = int((took ^ ref).sum())
        gaps["prune_gap" + sfx] = [differ / max(int(ref.sum()), 1)]
        kf_detail.append(dict(
            control=bf16,
            handover=dict(program=got, reference=want, keyframe=kf_hand),
            prune=dict(program=int(took.sum()), reference=int(ref.sum()),
                       differ=differ, keyframe=kf_prune)))
    lim = ctx.cell["limits"]
    checks = [Check(name, max(vals), float(lim[name.removesuffix(".control")]))
              for name, vals in gaps.items()
              if vals and name.removesuffix(".control") in lim]

    tr = work_out = None
    if prof[0] is not None:
        tr = devtrace.reduce(devtrace.export_events(prof[0]))
        work_out = calls.shares(tr["composite_durs"], rr.walk,
                                rr.tile_lists)
    if seed_s:
        spans["seed"] = seed_s
    e2e = dict(map_ms_per_iter=window_s / iters * 1e3, setup_s=setup_s)
    notes = dict(keyframes=len(window_kfs), iterations=iters,
                 window_s=window_s, cpu_s=cpu_s, host_at_start=host_at_start,
                 host_at_end=host_at_end, grad_gap=detail,
                 adam_gap=gaps["adam_gap"], pose_err_mm=pose_err_mm,
                 err_mm_max=float(err.max()) * 1e3,
                 active_gaussians=active, capacity=capacity,
                 handover_ms=1e3 * float(np.mean(handover_s)),
                 mono_prunes=prunes, keyframe_checks=kf_detail,
                 span_counts={k: len(v) for k, v in spans.items()})
    return Run(end_to_end=e2e, checks=checks, attempted=len(window_kfs),
               failed=failed, memory_peak_bytes=peak,
               counters=dict(keyframes=len(window_kfs), iterations=iters,
                             traced_iters=traced_iters[0],
                             mono_prunes=prunes),
               spans=spans, trace=tr, work=work_out, notes=notes)

"""Tracking frontend (torch port of slam/frontend.py): host orchestration
around the trackers. Per-frame tracking with the reference's adaptive
machinery (per-level pair capacities, plan reuse, the visibility-cull
mask, the H cache, the adaptive level schedule, rail-stop re-tracks),
keyframe selection (translation + covisibility overlap), window
management (Szymkiewicz-Simpson culling), the keyframe polish, monocular
depth-prior seeding noise (a numpy generator, as in the reference) and
the backend message protocol.

Frames are uploaded compactly (u8 RGB, u16 depth) and dequantized on the
device; torch's uint16 lacks arithmetic, so the depth codes travel as
int16 and widen through int32. ``prewarm_tracking`` only builds the CUDA
kernels: there are no tracker compiles to walk ahead of the frame loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.camera import Camera
from ..ops import losses
from ..utils.logging import Log
from ..utils.trace import span
from . import tracking


def _dequant_rgb(rgb_u8: np.ndarray, device) -> torch.Tensor:
    """u8 (H, W, 3) -> f32 (3, H, W) in [0, 1], on ``device``."""
    x = torch.tensor(np.ascontiguousarray(rgb_u8), device=device)
    return x.permute(2, 0, 1).to(torch.float32) * (1 / 255.0)


def _dequant_depth(depth_u16: np.ndarray, scale: float,
                   device) -> torch.Tensor:
    """u16 (H, W) depth codes -> f32 meters on ``device``: uploaded as
    int16 (same bytes), widened through int32."""
    x = torch.tensor(np.ascontiguousarray(depth_u16).view(np.int16),
                     device=device)
    codes = x.to(torch.int32) & 0xFFFF
    return codes.to(torch.float32) * float(np.float32(1.0 / scale))


def _overlap_stats(curr_vis, occ_list):
    """Visibility-overlap statistics against each keyframe's occ-aware
    visibility, computed on the device with one device-to-host copy (the
    reference's per-keyframe host set arithmetic, slam_frontend.py:239-246).

    Vectors may be recorded at different map capacities (the map grows);
    shorter ones are padded with False.

    Returns np int64 array [inter_0..K-1, union_0..K-1, cnt_occ_0..K-1,
    cnt_cur]."""
    n = max(max(o.shape[0] for o in occ_list), curr_vis.shape[0])

    def pad(x):
        return (x if x.shape[0] == n
                else torch.nn.functional.pad(x, (0, n - x.shape[0])))

    cur = pad(curr_vis)
    O = torch.stack([pad(o) for o in occ_list])
    inter = torch.count_nonzero(O & cur[None], dim=1)
    union = torch.count_nonzero(O | cur[None], dim=1)
    cnt_occ = torch.count_nonzero(O, dim=1)
    cnt_cur = torch.count_nonzero(cur)
    return torch.cat([inter, union, cnt_occ, cnt_cur[None]]).cpu().numpy()


def mono_initial_depth(gt_image, depth, opacity, rgb_boundary_threshold,
                       rng, frame_idx: int = -1) -> np.ndarray:
    """A monocular keyframe's seeding depth (reference
    slam_frontend.py:73-106), on the host: (H, W) float32.

    Without a render (``depth`` None, the first keyframe) every pixel
    draws 2 + 0.3 N(0, 1). Otherwise ``depth`` and ``opacity`` (1, H, W)
    are the map's render at the keyframe's pose: pixels with depth > 0,
    opacity > 0.95 and a non-black image give the median and standard
    deviation; depths outside median +- std, and invalid pixels, take the
    median with std / 2 noise, the rest keep their depth with std / 5
    noise. Black pixels of ``gt_image`` (3, H, W) get 0. The noise comes
    from the numpy generator ``rng``, one draw a pixel in row-major
    order. The span ``frontend.mono_depth`` covers the copies to the host
    (and so the wait for the render) and keeps the valid-pixel count,
    median and std."""
    with span("frontend.mono_depth", frame_idx=frame_idx) as sp:
        gt_img = gt_image.cpu().numpy()
        valid_rgb = gt_img.sum(axis=0) > rgb_boundary_threshold
        if depth is None:
            initial = 2 * np.ones(gt_img.shape[1:], np.float32)
            initial += (rng.standard_normal(initial.shape)
                        .astype(np.float32) * 0.3)
        else:
            depth = depth.cpu().numpy()[0]
            opac = opacity.cpu().numpy()[0]
            valid = (depth > 0) & (opac > 0.95) & valid_rgb
            vals = depth[valid]
            if vals.size == 0:
                med, std = 2.0, 0.5
            else:
                med, std = float(np.median(vals)), float(np.std(vals))
            sp.attrs.update(n_valid=int(vals.size), median=med, std=std)
            invalid = (depth > med + std) | (depth < med - std) | ~valid
            depth = np.where(invalid, med, depth)
            noise_scale = np.where(invalid, std * 0.5, std * 0.2)
            initial = depth + (rng.standard_normal(depth.shape)
                               .astype(np.float32) * noise_scale)
        initial[~valid_rgb] = 0
        return initial.astype(np.float32)


@dataclass
class FrameRecord:
    """Per-frame state. Poses are host numpy (the keyframing logic is
    host control flow); the image tensors live on the device, uploaded
    once at load and consumed there by tracking, seeding and the keyframe
    store."""

    uid: int
    R: np.ndarray
    t: np.ndarray
    R_gt: np.ndarray
    t_gt: np.ndarray
    exposure_a: float = 0.0
    exposure_b: float = 0.0
    gt_image: Optional[torch.Tensor] = None   # (3, H, W) device
    gt_depth: Optional[torch.Tensor] = None   # (H, W) device
    grad_mask: Optional[torch.Tensor] = None  # (1, H, W) device

    def clean(self):
        self.gt_image = None
        self.gt_depth = None
        self.grad_mask = None


class FrontEnd:
    def __init__(self, config: dict, dataset, cam_template: Camera,
                 backend, device=None):
        """``device=None`` means CUDA (raises without a GPU)."""
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        self.cam = cam_template
        self.backend = backend
        self.link = None          # set by parallel.pipeline for async mode
        self.gm = backend.gm      # map snapshot used for tracking
        self.requested_keyframe = 0

        T = config["Training"]
        self.monocular = T["monocular"]
        self.tracking_itr_num = T["tracking_itr_num"]
        self.kf_interval = T["kf_interval"]
        self.window_size = T["window_size"]
        self.single_thread = T.get("single_thread", True)
        self.kf_translation = T["kf_translation"]
        self.kf_min_translation = T["kf_min_translation"]
        self.kf_overlap = T["kf_overlap"]
        self.kf_cutoff = T.get("kf_cutoff", 0.4)
        self.edge_threshold = T["edge_threshold"]
        self.rgb_boundary_threshold = T["rgb_boundary_threshold"]
        self.alpha = T.get("alpha", 0.95)
        self.lr_rot = T["lr"]["cam_rot_delta"]
        self.lr_trans = T["lr"]["cam_trans_delta"]
        self.pair_capacity = T.get("pair_capacity", 1 << 20)
        # Adaptive per-level pair capacity (the reference's ladder): the
        # plan's cost scales with its capacity, so each pyramid level's
        # capacity follows its observed pair count in 128k quanta with
        # 1.5x headroom, shrinking after a steady streak and growing (with
        # one re-track) at once on overflow. pair_capacity is the ceiling;
        # adapt_pair_capacity: false pins it.
        self.cap_adaptive = bool(T.get("adapt_pair_capacity", True))
        self._cap_quantum = 1 << 17
        self._lvl_caps = None       # per-pyramid-level adaptive buckets
        self._lvl_streaks = None
        # caps tuples run so far: a shrink only moves into one of these,
        # and growth prefers one that covers the need (the reference's
        # rule, which keeps its compiled program set small; here it keeps
        # the schedule the same as the reference's)
        self._seen_caps = set()
        self.use_oracle = T.get("renderer", "tiled") == "oracle"
        # "pyr" = coarse-to-fine IRLS Gauss-Newton (default); "gn" =
        # single-level GN; "adam" = the reference's Adam loop
        # (slam_frontend.py:132-162, up to tracking_itr_num iters).
        self.tracker = T.get("tracker", "pyr")
        self.pyr_levels = tuple(T.get("pyr_levels", (4, 2, 1)))
        # the shipped operating point: fine tracking at s=2 with a
        # 2-iteration full-resolution tail, keyframing render at s=2
        self.pyr_iters = tuple(T.get("pyr_iters", (5, 12, 2)))
        # trailing exact-gradient iterations per level: "auto" (default)
        # runs forward-only IRLS steps on every level and pins the exact
        # L1 fixed point with a 2-iteration analytic polish only on
        # keyframe creation (tracking.polish_frame); an explicit tuple
        # pins per-frame exact counts, null/None = all exact
        pe = T.get("pyr_exact", "auto")
        self.pyr_exact = pe if pe == "auto" else (
            None if pe is None else tuple(pe))
        # flow: H and the IRLS gradient from the per-iteration flow
        # Jacobian; "fd" (frozen probes) remains an option
        self.pyr_curv = T.get("pyr_curv", "flow")
        # adaptive level schedule: drop s>=4 coarse levels while the warm
        # start keeps predicting within ~pyr_easy_flow_px of image flow;
        # a rail-stopped reduced-schedule frame re-tracks with the full
        # pyramid, so the worst case costs one extra track
        self.pyr_adaptive_levels = bool(T.get("pyr_adaptive_levels", True))
        self._easy_streak = 0
        self._easy_flow_px = float(T.get("pyr_easy_flow_px", 2.0))
        self.pyr_probes = T.get("pyr_probes", "coarse")
        # match the coarse-level render's EWA low-pass to the pooled
        # ground truth's blur (tracking.track_frame_pyr match_blur)
        self.pyr_match_blur = bool(T.get("pyr_match_blur", True))
        # resolution (decimation) of the per-frame keyframing render; its
        # consumers (n_touched visibility sets, median depth) are
        # resolution-insensitive, and keyframe creation re-renders at full
        # resolution where seeding needs per-pixel depth
        self.pyr_final_level = int(T.get("pyr_final_level", 2))
        if self.cam.width // self.pyr_final_level < 64:
            # same minimum the tracked-level schedule enforces: tiny
            # images keep the full-resolution final render
            self.pyr_final_level = 1
        if self.use_oracle:
            # the oracle tracker path has no reduced-resolution final
            # render, so out.depth always matches the frame's shapes
            self.pyr_final_level = 1
        # per-level IRLS tile-subset fractions (sparse direct alignment:
        # rank 32x32 tiles by constraint mass, track on the top fraction;
        # exact/polish renders always use every tile). Aligned with
        # pyr_levels; None disables.
        ps = T.get("pyr_subset")
        self.pyr_subset = None if ps is None else tuple(
            float(x) for x in ps)
        if (self.pyr_subset is not None
                and len(self.pyr_subset) != len(self.pyr_levels)):
            raise ValueError(
                f"Training.pyr_subset has {len(self.pyr_subset)} entries "
                f"but pyr_levels has {len(self.pyr_levels)} — they are "
                f"aligned per level (a shorter tuple would silently drop "
                f"tracking levels)")
        # async pacing: device yield per tracked frame while a keyframe
        # request is pending (see _process_frame_tracked); 0 = off
        self._kf_pending_yield = float(T.get("kf_pending_yield_s", 0.0))
        # cross-frame curvature reuse: re-run the FD probes every N frames
        # (0 disables reuse); invalidated when tracking hits max iters
        self.pyr_reprobe = int(T.get("pyr_reprobe", 5))
        # motion-model warm start (see _warm_start): "const_acc"
        # (default) | "const_vel" | "prev" (the reference's
        # previous-pose-only behavior)
        self.warm_mode = T.get("warm_start", "const_acc")
        self._H_cache = None
        self._H_age = 0
        # the tracking renders on the bfloat16 kernel bodies (opt-in)
        self.kernel_bf16 = bool(T.get("kernel_bf16", False))
        # the tracking renders on the MXU kernel bodies (tensor-core
        # falloff + log-space transmittance; opt-in)
        self.kernel_mxu = bool(T.get("kernel_mxu", False))
        # cross-frame pair-plan reuse: hand the previous frame's per-level
        # plans back to the tracker (plan_in) and rebuild every N frames.
        # 0 disables. Reuse is gated on the per-frame motion staying well
        # inside the plan pad (a stale plan drops pairs silently), and the
        # cache dies with any map update (plans hold Gaussian indices).
        self.plan_reuse_frames = int(T.get("plan_reuse_frames", 0))
        self._plan_cache = None
        self._plan_age = 0
        self._plan_sig = None
        self._last_motion_px = float("inf")
        self._plan_reuse_count = 0    # telemetry
        # visibility-culled tracking: Gaussians with n_touched below
        # track_vis_min_touch at a recent pose are left out of the
        # tracking pair plans; every track_vis_cull-th frame tracks
        # unmasked and refreshes the mask from its full final render.
        # 0 disables.
        self.track_vis_cull = int(T.get("track_vis_cull", 0))
        self.track_vis_min_touch = int(T.get("track_vis_min_touch", 1))
        self._vis_mask = None
        self._vis_mask_age = 0
        self._vis_cull_count = 0      # telemetry
        # 16x16-tile kernels (ops/tile_kernel16.py) for tracking
        self.tile16 = bool(T.get("tile16", False))
        # compact frame upload (u8 RGB + u16 depth, dequantized on the
        # device; see _fetch); false uploads f32 frames
        self.compact_upload = bool(T.get("compact_upload", True))
        # build the kernels right after map init, before the frame-loop
        # clock (see prewarm_tracking)
        self.prewarm = bool(T.get("prewarm_tracking", False))
        self._prewarmed = False
        self.prewarm_wall_s = 0.0     # run-summary itemization
        self.dataset_type = config["Dataset"]["type"]
        res = config.get("Results", {})
        self.save_dir = None               # set by the SLAM driver
        self.save_trj = res.get("save_trj", False)
        self.save_trj_kf_intv = res.get("save_trj_kf_intv", 10)

        self.initialized = not self.monocular
        self._prefetch = None      # (idx, thread, result) lookahead slot
        self.frames: Dict[int, FrameRecord] = {}
        self.kf_indices: List[int] = []
        self.ate_log: List[dict] = []   # interim eval series (run summary)
        # per-frame wall-time decomposition (run-summary telemetry):
        # load = dataset IO (prefetch-hidden in async), track = tracking
        # device time incl. any device-queue wait, kf = keyframe host work
        # (polish, seeding, backend request), total = whole process_frame
        self.frame_log: List[dict] = []
        self.current_window: List[int] = []
        self.occ_aware_visibility: Dict[int, torch.Tensor] = {}
        self.median_depth = 1.0
        self.reset = True
        self.bg = torch.zeros(3, dtype=torch.float32, device=self.device)
        self._rng = np.random.default_rng(config.get("seed", 0))

    # ------------------------------------------------------------------
    def _fetch(self, idx: int):
        """Host decode + upload + on-device derivations of one frame:
        returns (d_image (3,H,W) f32, d_depth (H,W) f32 | None,
        grad_mask (1,H,W), pose np). Runs on the prefetch thread for
        frame k+1 while frame k tracks, so decode and upload leave the
        frame-loop critical path.

        The upload prefers the dataset's compact raw path (u8 RGB + u16
        depth in their native width, dequantized on the device, ~3.2x
        fewer bytes than f32 frames); the gray image and the Scharr edge
        mask also derive on the device."""
        dev = self.device
        raw = (self.dataset.raw_frame(idx) if self.compact_upload
               else None)
        if raw is not None:
            rgb_u8, depth_u16, scale, pose = raw
            d_image = _dequant_rgb(rgb_u8, dev)
            d_depth = (None if depth_u16 is None
                       else _dequant_depth(depth_u16, scale, dev))
        else:
            image, depth, pose = self.dataset[idx]
            d_image = torch.as_tensor(np.asarray(image, np.float32),
                                      device=dev)
            d_depth = (None if depth is None else torch.as_tensor(
                np.asarray(depth, np.float32), device=dev))
        gray = d_image.mean(dim=0, keepdim=True)
        grad_mask = losses.compute_grad_mask(
            gray, self.edge_threshold, self.dataset_type)
        return d_image, d_depth, grad_mask, np.asarray(pose)

    def _start_prefetch(self, idx: int):
        """One-frame lookahead on a host thread: frame IO (image decode
        for real datasets, the host raytrace for the synthetic one) and
        the device upload would otherwise sit on the critical path of
        every frame. The reference loads synchronously
        (camera_utils.py:66-84)."""
        import threading
        if not getattr(self.dataset, "prefetchable", False):
            return
        try:
            n = len(self.dataset)
        except TypeError:
            n = None
        if n is not None and idx >= n:
            return
        res = {}

        def go():
            try:
                res[idx] = self._fetch(idx)
            except Exception as e:       # surfaced on consume
                res["err"] = e

        th = threading.Thread(target=go, daemon=True)
        th.start()
        self._prefetch = (idx, th, res)

    def load_frame(self, idx: int) -> FrameRecord:
        data = None
        if self._prefetch is not None and self._prefetch[0] == idx:
            _, th, res = self._prefetch
            th.join()
            data = res.get(idx)
            if data is None and "err" in res:
                Log(f"frame {idx} prefetch failed ({res['err']!r}); "
                    f"reloading synchronously", tag="Frontend")
            self._prefetch = None
        if data is None:
            data = self._fetch(idx)
        self._start_prefetch(idx + 1)
        d_image, d_depth, grad_mask, pose = data
        rec = FrameRecord(
            uid=idx, R=pose[:3, :3].astype(np.float32),
            t=pose[:3, 3].astype(np.float32),
            R_gt=pose[:3, :3].astype(np.float32),
            t_gt=pose[:3, 3].astype(np.float32),
            gt_image=d_image, gt_depth=d_depth,
            grad_mask=grad_mask)
        self.frames[idx] = rec
        return rec

    # ------------------------------------------------------------------
    def add_new_keyframe(self, idx: int, depth=None, opacity=None,
                         init: bool = False) -> np.ndarray:
        """Depth map used for Gaussian seeding
        (reference slam_frontend.py:57-108)."""
        rec = self.frames[idx]
        self.kf_indices.append(idx)
        if not self.monocular:
            # RGBD: pure device expression — no host transfer
            valid_rgb = (rec.gt_image.sum(dim=0)
                         > self.rgb_boundary_threshold)
            return torch.where(valid_rgb, rec.gt_depth,
                               torch.zeros_like(rec.gt_depth))
        return mono_initial_depth(rec.gt_image, depth, opacity,
                                  self.rgb_boundary_threshold, self._rng,
                                  frame_idx=idx)

    # ------------------------------------------------------------------
    def initialize(self, idx: int, rec: FrameRecord):
        """reference slam_frontend.py:110-126."""
        self.initialized = not self.monocular
        self.kf_indices = []
        self.occ_aware_visibility = {}
        self.current_window = []
        rec.R, rec.t = rec.R_gt.copy(), rec.t_gt.copy()
        depth_map = self.add_new_keyframe(idx, init=True)
        self.backend_request_init(idx, rec, depth_map)
        self.reset = False

    # ------------------------------------------------------------------
    def prewarm_tracking(self):
        """Build every CUDA kernel before the frame-loop clock starts. The
        reference walks its jitted tracker variants here to move their
        compiles out of the frame loop; eager PyTorch has no compiles, so
        only the kernels' one-time nvcc builds remain (like
        ``BackEnd.prewarm_mapping``)."""
        if self._prewarmed:
            return
        with span("frontend.prewarm") as sp:
            if self.device.type == "cuda":
                from ..ops import _build
                _build.build()
        self._prewarmed = True
        self.prewarm_wall_s = sp.seconds
        Log(f"prewarmed the tracking kernels in {self.prewarm_wall_s:.1f}s",
            tag="Frontend")

    # ------------------------------------------------------------------
    def _warm_start(self, idx: int):
        """Motion-model pose prediction. The reference warm-starts from
        the previous pose alone (slam_frontend.py:129-130), which leaves
        the full per-frame motion as initial error, which at motion peaks
        rails the iteration cap and seeds keyframes with bad poses.

        "const_vel" composes the last inter-frame delta D1 = T1 T0^-1
        onto the previous pose; "const_acc" (default) also extrapolates
        the delta's change, T_w = (D1 D0^-1) D1 T1, which on smooth
        trajectories shrinks the warm-start error further.
        The acceleration term is noise-amplifying, so it is dropped
        (falling back to const-vel) when it is not small against the
        velocity term; prediction is skipped entirely when the last
        delta is implausibly large (tracking-failure guard)."""
        prev = self.frames[idx - 1]
        prev2 = self.frames.get(idx - 2)
        if prev2 is None or self.warm_mode == "prev":
            return prev.R, prev.t

        def T_of(r):
            T = np.eye(4, dtype=np.float64)
            T[:3, :3] = r.R
            T[:3, 3] = r.t
            return T

        T1, T0 = T_of(prev), T_of(prev2)
        D1 = T1 @ np.linalg.inv(T0)
        if np.linalg.norm(D1[:3, 3]) > 0.1 * max(self.median_depth, 1e-3):
            return prev.R, prev.t
        D = D1
        prev3 = self.frames.get(idx - 3)
        if self.warm_mode == "const_acc" and prev3 is not None:
            D0 = T0 @ np.linalg.inv(T_of(prev3))
            A = D1 @ np.linalg.inv(D0)
            # accept the acceleration only while it is a CORRECTION:
            # |accel| <= 0.5 |vel| + a 1 mm / ~0.3 deg noise floor
            a_tr = np.linalg.norm(A[:3, 3])
            a_rot = np.arccos(np.clip((np.trace(A[:3, :3]) - 1) / 2,
                                      -1.0, 1.0))
            d_tr = np.linalg.norm(D1[:3, 3])
            d_rot = np.arccos(np.clip((np.trace(D1[:3, :3]) - 1) / 2,
                                      -1.0, 1.0))
            if a_tr <= 0.5 * d_tr + 1e-3 and a_rot <= 0.5 * d_rot + 5e-3:
                D = A @ D1
        Tw = D @ T1
        return Tw[:3, :3].astype(np.float32), Tw[:3, 3].astype(np.float32)

    def track(self, idx: int, rec: FrameRecord):
        """reference FrontEnd.tracking (slam_frontend.py:128-196)."""
        R_ws, t_ws = self._warm_start(idx)
        dev = self.device
        gt_depth = (torch.zeros((1,) + tuple(rec.gt_image.shape[1:]),
                                device=dev)
                    if rec.gt_depth is None else rec.gt_depth[None])
        track_fn = {"gn": tracking.track_frame_gn,
                    "pyr": tracking.track_frame_pyr,
                    "adam": tracking.track_frame}.get(
                        self.tracker, tracking.track_frame_pyr)
        max_iters = (self.tracking_itr_num if self.tracker == "adam"
                     else min(self.tracking_itr_num, 20))
        kw = {}
        if self.tracker == "pyr":
            # drop pyramid levels that undershoot one 32x32 tile
            levels, iters, exacts, subsets = [], [], [], []
            if self.pyr_exact == "auto":
                pyr_exact = [0] * len(self.pyr_iters)
            elif self.pyr_exact is None:
                pyr_exact = self.pyr_iters
            else:
                pyr_exact = self.pyr_exact
            pyr_subset = (self.pyr_subset if self.pyr_subset is not None
                          else (1.0,) * len(self.pyr_levels))
            for s, it, ex, sf in zip(self.pyr_levels, self.pyr_iters,
                                     pyr_exact, pyr_subset):
                if self.cam.width // s >= 64 and self.cam.height // s >= 64:
                    levels.append(s)
                    iters.append(it)
                    exacts.append(ex)
                    subsets.append(sf)
            if not levels:
                levels, iters = [1], [max(self.pyr_iters)]
                exacts = [0 if self.pyr_exact == "auto" else iters[0]]
                subsets = [1.0]
            if levels[-1] > self.pyr_final_level:
                # the finest tracked level must reach the final-render
                # resolution (default full res)
                levels.append(self.pyr_final_level)
                iters.append(2)
                exacts.append(0 if self.pyr_exact == "auto" else 2)
                subsets.append(1.0)
            reuse_H = (self.pyr_reprobe > 0 and self._H_cache is not None
                       and self._H_age < self.pyr_reprobe
                       and len(self._H_cache) == len(levels))
            # adaptive schedule: after 3 consecutive easy frames, zero
            # out the s>=4 coarse iterations (level count — and so the
            # H-cache structure — is unchanged; a zero-iteration level
            # is skipped inside the tracker)
            full_iters = tuple(iters)
            reduced = (self.pyr_adaptive_levels
                       and self._easy_streak >= 3
                       and len(levels) > 1
                       and any(s >= 4 and it > 0
                               for s, it in zip(levels, iters)))
            if reduced:
                iters = [0 if s >= 4 else it
                         for s, it in zip(levels, iters)]
            pad_cfg = (float(T_pad) if (
                T_pad := self.config["Training"].get("pyr_pad"))
                is not None else 4.0)
            kw = dict(levels=tuple(levels), level_iters=tuple(iters),
                      level_exact=tuple(exacts),
                      tile16=self.tile16 and not self.use_oracle,
                      # intra-frame pose drift is bounded by the easy-
                      # streak condition (~2 px) on reduced frames, so
                      # the plan pad can shrink with the schedule
                      plan_pad=min(pad_cfg, 2.0) if reduced else pad_cfg,
                      curv=self.pyr_curv, probe_levels=self.pyr_probes,
                      kernel_bf16=(self.kernel_bf16 and not self.use_oracle),
                      kernel_mxu=(self.kernel_mxu and not self.use_oracle),
                      match_blur=self.pyr_match_blur,
                      pair_capacity_ceiling=self.pair_capacity,
                      level_subset=(tuple(subsets)
                                    if self.pyr_subset is not None
                                    else None),
                      # honored even when the schedule tracks FINER than
                      # pyr_final_level (e.g. pyr_iters ending at s=1
                      # with pyr_final_level=2): the keyframing render's
                      # consumers are resolution-insensitive, and the
                      # tracker builds a fresh level plan when the final
                      # level was not tracked (tracking.py plan_s1)
                      final_level=self.pyr_final_level,
                      H_in=self._H_cache if reuse_H else None)
        adaptive = (self.cap_adaptive and self.tracker == "pyr"
                    and not self.use_oracle)
        n_lvl = len(kw["levels"]) if "levels" in kw else 0
        if adaptive:
            ceil = self.pair_capacity
            if (self._lvl_caps is None
                    or len(self._lvl_caps) != n_lvl):
                self._lvl_caps = [
                    ceil if s == 1
                    else max(min(ceil, 1 << 17), ceil // 2)
                    for s in kw["levels"]]
                self._lvl_streaks = [0] * n_lvl
            kw["level_caps"] = tuple(self._lvl_caps)
            cap = self._lvl_caps[-1]
        else:
            cap = self.pair_capacity
        use_plan_reuse = (self.tracker == "pyr" and not self.use_oracle
                          and self.plan_reuse_frames > 0)
        plan_sig = None
        if use_plan_reuse:
            plan_sig = (kw["levels"], kw["level_iters"],
                        kw.get("level_caps"), kw["plan_pad"], cap)
            # accumulated-drift bound: (age+1) frames at the last
            # measured motion rate must stay well inside the plan pad
            # (the pad is the ONLY thing keeping a stale plan a valid
            # superset; beyond it pairs are dropped silently). Needs
            # pyr_adaptive_levels for the motion telemetry — without it
            # _last_motion_px stays inf and reuse never engages.
            budget_ok = ((self._plan_age + 1)
                         * max(self._last_motion_px, 0.5)
                         < 0.6 * float(kw["plan_pad"]))
            if (self._plan_cache is not None
                    and self._plan_age < self.plan_reuse_frames
                    and self._plan_sig == plan_sig and budget_ok):
                kw["plan_in"] = self._plan_cache
        # visibility-culled tracking (see __init__): masked frames plan
        # only recently-contributing gaussians; refresh frames track
        # unmasked (and force a plan rebuild so the final keyframing
        # render — the mask source — sees the full set)
        use_vis_cull = (self.tracker == "pyr" and not self.use_oracle
                        and self.track_vis_cull > 0)
        vis_refresh = False
        if use_vis_cull:
            # count n_touched at the blend-weight threshold on every
            # vis-cull frame (uniform overlap semantics):
            # the T>0.5 set drops back-layer splats that still carry up
            # to half a pixel's color, and masking on it biases the
            # tracked image (tile_kernel2 nt_weight; tests/test_tracking)
            kw["nt_weight"] = True
            if (self._vis_mask is not None
                    and self._vis_mask_age < self.track_vis_cull):
                kw["track_mask"] = self._vis_mask
                self._vis_cull_count += 1
            else:
                vis_refresh = True
                kw.pop("plan_in", None)
        while True:   # doubles caps on overflow; <= log2(ceiling) retries
            res = track_fn(
                self.gm, self.cam,
                torch.as_tensor(np.asarray(R_ws, np.float32), device=dev),
                torch.as_tensor(np.asarray(t_ws, np.float32), device=dev),
                rec.gt_image, gt_depth, rec.grad_mask, self.bg,
                self.lr_rot, self.lr_trans, self.rgb_boundary_threshold,
                alpha=self.alpha, monocular=self.monocular,
                max_iters=max_iters, pair_capacity=cap,
                use_oracle=self.use_oracle, device=dev, **kw)
            R, t, ea, eb, iters, out, med = res[:7]
            # one device concat and one device-to-host copy for every
            # per-frame scalar
            has_lvl = self.tracker == "pyr" and len(res) > 8
            f32 = torch.float32

            def scalar(x):
                return torch.as_tensor(x, device=dev).to(f32).reshape(())

            zero = torch.zeros((), device=dev)
            ovf = zero if out.overflow is None else scalar(out.overflow)
            npairs = scalar(res[9]) if len(res) > 9 else zero
            parts = [R.reshape(-1), t.reshape(-1),
                     torch.stack([scalar(ea), scalar(eb), scalar(iters),
                                  scalar(med), ovf, npairs])]
            if has_lvl:
                parts.append(res[8].to(f32))
                parts.append(res[10].to(f32))
            packed = torch.cat(parts).cpu().numpy()
            ov = int(packed[16])
            lvl_ov = None
            if has_lvl:
                lvl_ov = packed[18:18 + n_lvl].astype(np.int64)
                if lvl_ov.any():
                    Log(f"pyramid-level pair overflow {lvl_ov.tolist()} "
                        f"at levels {kw['levels']} "
                        f"(caps {kw.get('level_caps')})", tag="Frontend")
                ov = max(ov, int(lvl_ov.max()))
            if ov > 0 and adaptive:
                # an overflowing plan dropped pairs — the gradient was
                # corrupted; grow the affected level buckets and re-track
                grew = False
                for li in range(n_lvl):
                    over_here = (lvl_ov is not None and lvl_ov[li] > 0) or (
                        li == n_lvl - 1 and int(packed[16]) > 0)
                    if over_here and self._lvl_caps[li] < self.pair_capacity:
                        self._lvl_caps[li] = min(
                            self._lvl_caps[li] * 2, self.pair_capacity)
                        self._lvl_streaks[li] = 0
                        grew = True
                if grew:
                    # prefer a caps tuple already run that covers the
                    # doubled need (the reference's rule; a 2x-padded cap
                    # is valid, capacities only size the pair buffers)
                    cand = tuple(self._lvl_caps)
                    if cand not in self._seen_caps:
                        covers = [c for c in self._seen_caps
                                  if len(c) == n_lvl
                                  and all(a >= b
                                          for a, b in zip(c, cand))]
                        if covers:
                            self._lvl_caps = list(min(covers, key=sum))
                    kw["level_caps"] = tuple(self._lvl_caps)
                    cap = self._lvl_caps[-1]
                    # capacity shapes changed: a cached plan no longer
                    # fits the retrack's static buffers
                    kw.pop("plan_in", None)
                    self._plan_cache = None
                    # retrack at full fidelity; the full final render
                    # refreshes the mask
                    if kw.pop("track_mask", None) is not None:
                        self._vis_mask = None
                        vis_refresh = use_vis_cull
                    Log(f"pair overflow: re-tracking at level caps "
                        f"{self._lvl_caps}", tag="Frontend")
                    continue
            if (self.tracker == "pyr" and reduced
                    and int(packed[14]) >= sum(kw["level_iters"])):
                # the reduced schedule rail-stopped — the warm start was
                # worse than its streak suggested; redo with the full
                # coarse-to-fine pyramid
                reduced = False
                self._easy_streak = 0
                kw["level_iters"] = full_iters
                kw["plan_pad"] = pad_cfg
                # a rail stop means the motion estimate was wrong — the
                # cached plan's drift budget is void; rebuild fresh
                kw.pop("plan_in", None)
                self._plan_cache = None
                if kw.pop("track_mask", None) is not None:
                    self._vis_mask = None
                    vis_refresh = use_vis_cull
                Log("reduced-schedule rail stop: re-tracking with full "
                    "pyramid", tag="Frontend")
                continue
            break
        iters = int(packed[14])
        if kw.get("level_caps") is not None:
            self._seen_caps.add(tuple(kw["level_caps"]))
        if use_plan_reuse and len(res) > 11:
            if iters >= sum(kw["level_iters"]):
                # rail stop: the pose (and so the plan pose) is suspect
                self._plan_cache = None
                self._plan_age = 0
            elif kw.get("plan_in") is None:
                self._plan_cache = res[11]
                self._plan_age = 0
                self._plan_sig = plan_sig
            else:
                self._plan_age += 1
                self._plan_reuse_count += 1
        if use_vis_cull:
            if iters >= sum(kw["level_iters"]):
                # rail stop: converged-state visibility is suspect
                self._vis_mask = None
            elif vis_refresh:
                # full (unmasked) final render: adopt its contribution
                # set as the tracking mask for the next window of frames
                self._vis_mask = (out.n_touched
                                  >= self.track_vis_min_touch)
                self._vis_mask_age = 0
            else:
                self._vis_mask_age += 1
        if self.tracker == "pyr":
            if iters >= sum(kw["level_iters"]):
                # rail-stopped at the iteration cap on every level: the
                # linearization the cached H came from is suspect — force
                # fresh FD probes on the next frame
                self._H_cache = None
                self._H_age = 0
            elif kw["H_in"] is None and not reduced:
                # reduced frames carry identity placeholders for their
                # skipped coarse levels — caching those would hand fd-mode
                # reuse a unit curvature exactly at the next motion spike
                self._H_cache = res[7]
                self._H_age = 0
            else:
                self._H_age += 1
        rec.R = packed[:9].reshape(3, 3).astype(np.float32)
        rec.t = packed[9:12].astype(np.float32)
        rec.exposure_a, rec.exposure_b = float(packed[12]), float(packed[13])
        self.median_depth = float(packed[15])
        if self.tracker == "pyr" and self.pyr_adaptive_levels:
            # hardness signals for the adaptive schedule: (a) the
            # image-flow magnitude of the warm-start CORRECTION this
            # frame needed, and (b) the raw inter-frame MOTION flow —
            # a tracker stuck in a local valley shows a small correction
            # without rail-stopping, so large motion alone forces the
            # full pyramid

            def _flow(R_a, t_a, R_b, t_b):
                dt_ = float(np.linalg.norm(np.asarray(t_a)
                                           - np.asarray(t_b)))
                dR = np.asarray(R_a) @ np.asarray(R_b).T
                ang = float(np.arccos(np.clip(
                    (np.trace(dR) - 1) / 2, -1, 1)))
                return (self.cam.fx * dt_ / max(self.median_depth, 1e-3)
                        + self.cam.fx * ang)

            corr_px = _flow(rec.R, rec.t, R_ws, t_ws)
            prev = self.frames.get(idx - 1)
            motion_px = (0.0 if prev is None
                         else _flow(rec.R, rec.t, prev.R, prev.t))
            # feeds the plan-reuse drift budget (next frame's gate)
            self._last_motion_px = motion_px if prev is not None \
                else float("inf")
            railed = iters >= sum(kw["level_iters"])
            if (corr_px < self._easy_flow_px
                    and motion_px < 4.0 * self._easy_flow_px
                    and not railed):
                self._easy_streak += 1
            else:
                self._easy_streak = 0
        if ov > 0:
            Log(f"render pair overflow: {ov} pairs dropped "
                f"(pair_capacity={cap}) — raise "
                f"Training.pair_capacity", tag="Frontend")
        elif adaptive and has_lvl:
            # steady-state shrink, independently per pyramid level
            # (coarse counts track the visible-gaussian count, fine the
            # pixel occupancy): quantized observed-pairs bucket with 1.5x
            # headroom, after a 5-frame streak below the current one
            lvl_pairs = packed[18 + n_lvl:18 + 2 * n_lvl].astype(np.int64)
            changed = False
            for li in range(n_lvl):
                if lvl_pairs[li] <= 0:    # level skipped this frame
                    continue
                want = tracking.pair_capacity_bucket(
                    int(lvl_pairs[li]), self.pair_capacity,
                    self._cap_quantum)
                if want < self._lvl_caps[li]:
                    self._lvl_streaks[li] += 1
                    # shrink only into a caps tuple already run (the
                    # reference's rule, where a fresh bucket is a tracker
                    # compile inside the frame loop). Growth
                    # (correctness) is never gated.
                    candidate = list(self._lvl_caps)
                    candidate[li] = want
                    if (self._lvl_streaks[li] >= 5
                            and tuple(candidate) in self._seen_caps):
                        self._lvl_caps[li] = want
                        self._lvl_streaks[li] = 0
                        changed = True
                else:
                    self._lvl_streaks[li] = 0
            if changed:
                Log(f"tracking level caps -> {self._lvl_caps} "
                    f"(levels {kw['levels']})", tag="Frontend")
        return out, iters

    # ------------------------------------------------------------------
    def polish(self, rec: FrameRecord):
        """Exact analytic-gradient polish of a pose about to be persisted
        as a keyframe (the IRLS-only per-frame tracker's counterpart of
        the reference's always-exact gradient; see tracking.polish_frame).
        Only active for the default ``pyr_exact='auto'`` pyramid tracker —
        explicit configs already run their chosen exact iterations."""
        if self.tracker != "pyr" or self.pyr_exact != "auto":
            return
        dev = self.device
        gt_depth = (torch.zeros((1,) + tuple(rec.gt_image.shape[1:]),
                                device=dev)
                    if rec.gt_depth is None else rec.gt_depth[None])

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        res = tracking.polish_frame(
            self.gm, self.cam, f32(rec.R), f32(rec.t), f32(rec.exposure_a),
            f32(rec.exposure_b), rec.gt_image, gt_depth, rec.grad_mask,
            self.bg,
            self.rgb_boundary_threshold, alpha=self.alpha,
            monocular=self.monocular,
            pair_capacity=(self._lvl_caps[-1]
                           if self.cap_adaptive and not self.use_oracle
                           and self._lvl_caps else self.pair_capacity),
            use_oracle=self.use_oracle,
            tile16=self.tile16 and not self.use_oracle, device=dev)
        packed = torch.cat(
            [res[0].reshape(-1), res[1].reshape(-1),
             torch.stack([res[2].reshape(()), res[3].reshape(())])]
        ).cpu().numpy()
        rec.R = packed[:9].reshape(3, 3).astype(np.float32)
        rec.t = packed[9:12].astype(np.float32)
        rec.exposure_a, rec.exposure_b = float(packed[12]), float(packed[13])

    def is_keyframe(self, cur_idx, last_kf_idx, point_ratio):
        """reference slam_frontend.py:198-225 (the visibility overlap
        ``point_ratio`` is precomputed on device by _overlap_stats)."""
        cur = self.frames[cur_idx]
        last = self.frames[last_kf_idx]
        pose_CW = np.eye(4); pose_CW[:3, :3] = cur.R; pose_CW[:3, 3] = cur.t
        last_CW = np.eye(4); last_CW[:3, :3] = last.R; last_CW[:3, 3] = last.t
        last_WC = np.linalg.inv(last_CW)
        dist = np.linalg.norm((pose_CW @ last_WC)[:3, 3])
        dist_check = dist > self.kf_translation * self.median_depth
        dist_check2 = dist > self.kf_min_translation * self.median_depth
        return (point_ratio < self.kf_overlap and dist_check2) or dist_check

    def add_to_window(self, cur_idx, cut_ratios, window):
        """reference slam_frontend.py:227-286. ``cut_ratios[i]`` is the
        device-precomputed intersection/min-count overlap of the current
        frame with window[i] (Szymkiewicz–Simpson)."""
        N_dont_touch = 2
        window = [cur_idx] + window
        removed_frame = None
        to_remove = []
        for i in range(N_dont_touch, len(window)):
            kf_idx = window[i]
            ratio = cut_ratios[i - 1]
            cut_off = self.kf_cutoff if self.initialized else 0.4
            if ratio <= cut_off:
                to_remove.append(kf_idx)
        if to_remove:
            window.remove(to_remove[-1])
            removed_frame = to_remove[-1]

        def cw(uid):
            r = self.frames[uid]
            T = np.eye(4); T[:3, :3] = r.R; T[:3, 3] = r.t
            return T

        kf_0_WC = np.linalg.inv(cw(cur_idx))
        if len(window) > self.window_size:
            inv_dist = []
            for i in range(N_dont_touch, len(window)):
                inv_dists = []
                kf_i_CW = cw(window[i])
                for j in range(N_dont_touch, len(window)):
                    if i == j:
                        continue
                    kf_j_WC = np.linalg.inv(cw(window[j]))
                    T_CiCj = kf_i_CW @ kf_j_WC
                    inv_dists.append(
                        1.0 / (np.linalg.norm(T_CiCj[:3, 3]) + 1e-6))
                T_CiC0 = kf_i_CW @ kf_0_WC
                k = float(np.sqrt(np.linalg.norm(T_CiC0[:3, 3])))
                inv_dist.append(k * sum(inv_dists))
            idx = int(np.argmax(inv_dist))
            removed_frame = window[N_dont_touch + idx]
            window.remove(removed_frame)
        return window, removed_frame

    # ------------------------------------------------------------------
    # backend messaging: direct calls in single-thread mode; the threaded
    # pipeline (parallel.pipeline) sets self.link and routes the same
    # message grammar (["init"|"keyframe"], reference
    # slam_frontend.py:288-300) through queues.
    def backend_request_init(self, idx, rec, depth_map):
        if self.link is not None:
            self.link.send(["init", idx, rec, depth_map])
            self.link.wait_init(self)
            return
        self.backend.reset_state()
        self.backend.add_next_kf(
            idx, rec.R, rec.t, rec.exposure_a, rec.exposure_b,
            rec.gt_image, rec.gt_depth, depth_map, init=True)
        self.backend.initialize_map(idx)
        self.backend.current_window = [idx]
        if getattr(self.backend, "prewarm", False):
            self.backend.prewarm_mapping()
        self.sync_backend()

    def backend_request_keyframe(self, idx, rec, window, depth_map):
        if self.link is not None:
            self.requested_keyframe += 1
            self.link.send(["keyframe", idx, rec, list(window), depth_map])
            return
        self.backend.add_next_kf(
            idx, rec.R, rec.t, rec.exposure_a, rec.exposure_b,
            rec.gt_image, rec.gt_depth, depth_map)
        self.backend.handle_keyframe(idx, window)
        self.sync_backend()

    def sync_backend(self, payload=None):
        """Adopt backend's map + visibility + KF poses
        (reference slam_frontend.py:302-309)."""
        if payload is None:
            payload = (self.backend.gm,
                       dict(self.backend.occ_aware_visibility),
                       self.backend.keyframe_poses())
        gm, occ, kf_poses = payload
        self.gm = gm
        # the map changed (densify/prune/optimize): cached tracking
        # curvature no longer matches the rendered scene, and cached
        # pair plans index into the OLD gaussian array
        self._H_cache = None
        self._H_age = 0
        self._plan_cache = None
        self._plan_age = 0
        # the visibility mask indexes the OLD gaussian array too
        self._vis_mask = None
        self.occ_aware_visibility = dict(occ)
        for uid, R, t in kf_poses:
            if uid in self.frames:
                self.frames[uid].R = R
                self.frames[uid].t = t

    def cleanup(self, idx):
        self.frames[idx].clean()

    # ------------------------------------------------------------------
    def process_frame(self, idx: int):
        """One step of the reference run() loop (slam_frontend.py:332-480),
        single-thread semantics. Returns dict with step info."""
        with span("frontend.frame", frame_idx=idx) as frame:
            if self.link is not None:
                self.link.drain(self)

            with span("frontend.load") as sp:
                rec = self.load_frame(idx)
            self._t_load = sp.seconds
            if self.reset:
                self.initialize(idx, rec)
                self.current_window = [idx]
                if self.prewarm:
                    self.prewarm_tracking()
                return dict(keyframe=True, init=True, iters=0)

            self.initialized = self.initialized or (
                len(self.current_window) == self.window_size)

            # frontend device priority (async): hold off backend idle
            # refinement while this frame's device work (tracking, overlap
            # stats, polish) is in flight — see BackendLink.want_device
            if self.link is not None:
                self.link.want_device.set()
            try:
                return self._process_frame_tracked(idx, rec, frame)
            finally:
                if self.link is not None:
                    self.link.want_device.clear()

    def _process_frame_tracked(self, idx, rec, frame):
        with span("frontend.track") as sp:
            out, iters = self.track(idx, rec)
        t_track = sp.seconds

        def log_frame(kf, extra=0.0):
            self.frame_log.append(dict(
                frame=idx, total=round(frame.seconds, 4),
                load=round(self._t_load, 4), track=round(t_track, 4),
                kf=kf, kf_host=round(extra, 4)))

        if self.requested_keyframe > 0:
            # a keyframe is still being mapped; don't create another
            # (reference slam_frontend.py:407-410)
            self.cleanup(idx)
            log_frame(False)
            # pacing (async): at full ingest rate the per-frame device
            # hold leaves the backend only short windows, so a pending
            # keyframe's mapping batch can starve. Yield the device for an
            # uninterrupted slice so the ack arrives and the window can
            # advance; the wait is drained on the ack itself
            # (BackendLink.wait_ack), so an early-arriving ack resumes
            # tracking immediately instead of sleeping out the window.
            # 0 disables.
            if (self._kf_pending_yield > 0 and not self.single_thread
                    and self.link is not None):
                self.link.want_device.clear()
                self.link.wait_ack(self, self._kf_pending_yield)
            return dict(keyframe=False, iters=iters)

        last_kf = self.current_window[0]
        check_time = (idx - last_kf) >= self.kf_interval
        # visibility vectors stay device-resident; ONE pull gets every
        # overlap statistic the keyframing logic needs
        curr_vis = out.n_touched > 0
        occs = [self.occ_aware_visibility[u] for u in self.current_window]
        K = len(occs)
        st = _overlap_stats(curr_vis, occs)
        inter, union, cnt_occ, cnt_cur = (
            st[:K], st[K:2 * K], st[2 * K:3 * K], st[3 * K])
        point_ratio = inter[0] / max(union[0], 1)
        cut_ratios = inter / np.maximum(np.minimum(cnt_cur, cnt_occ), 1)
        create_kf = self.is_keyframe(idx, last_kf, point_ratio)
        if len(self.current_window) < self.window_size:
            create_kf = check_time and point_ratio < self.kf_overlap
        if self.single_thread:
            create_kf = check_time and create_kf

        if create_kf:
            with span("frontend.kf_host") as kf_sp:
                # keyframe poses are persisted (seeding, mapping anchor, ATE)
                # — pin the exact L1 fixed point before the pose leaves the
                # frontend (see tracking.polish_frame; non-KF frames stay at
                # the IRLS fixed point)
                self.polish(rec)
                self.current_window, removed = self.add_to_window(
                    idx, cut_ratios, self.current_window)
                if (self.monocular and not self.initialized
                        and removed is not None):
                    self.reset = True
                    Log("Keyframes lack sufficient overlap, resetting",
                        tag="Frontend")
                    return dict(keyframe=False, reset=True, iters=iters)
                if not self.monocular:
                    # RGBD seeding uses gt depth only (add_new_keyframe
                    # ignores rendered depth/opacity) — no re-render needed
                    depth_map = self.add_new_keyframe(idx)
                elif self.pyr_final_level != 1:
                    # the per-frame final render ran at reduced resolution
                    # (pyr_final_level); monocular depth seeding is
                    # per-pixel, so re-render this keyframe full-res at the
                    # polished pose (use_oracle pins pyr_final_level to 1
                    # in __init__, so this is always the tiled renderer)
                    from .render_api import render as _render
                    out_full = _render(
                        self.gm, self.cam.replace(
                            R=torch.as_tensor(rec.R, device=self.device),
                            t=torch.as_tensor(rec.t, device=self.device)),
                        None, self.bg, pair_capacity=self.pair_capacity,
                        device=self.device)
                    depth_map = self.add_new_keyframe(
                        idx, depth=out_full.depth, opacity=out_full.opacity)
                else:
                    depth_map = self.add_new_keyframe(
                        idx, depth=out.depth, opacity=out.opacity)
                self.backend_request_keyframe(
                    idx, rec, self.current_window, depth_map)
                # interim trajectory eval every save_trj_kf_intv keyframes
                # (reference slam_frontend.py:461-474)
                if (self.save_trj and self.save_dir is not None
                        and len(self.kf_indices) % self.save_trj_kf_intv == 0):
                    from ..utils import eval as eval_utils
                    ate = eval_utils.eval_ate(
                        self.frames, self.kf_indices, self.save_dir,
                        iterations=idx, monocular=self.monocular)
                    self.ate_log.append(
                        dict(frame=idx, n_kf=len(self.kf_indices), ate=ate))
            # 3 FPS throttle after keyframe creation so the async backend
            # can catch up (reference slam_frontend.py:477-480); a no-op
            # in single-thread mode where the backend ran inline. Release
            # the device-priority hold first so the backend can use the
            # throttle window.
            t_kf_host = kf_sp.seconds
            if not self.single_thread:
                if self.link is not None:
                    self.link.want_device.clear()
                sleep_left = 1.0 / 3.0 - frame.seconds
                if sleep_left > 0:
                    time.sleep(sleep_left)
            log_frame(True, t_kf_host)
        else:
            self.cleanup(idx)
            log_frame(False)
        return dict(keyframe=create_kf, iters=iters)

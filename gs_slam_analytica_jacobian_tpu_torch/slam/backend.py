"""The mapping backend on one device (torch port of slam/backend.py):
keyframe intake and seeding, the densify / prune / opacity-reset
schedule, map initialization, covisibility pruning and color refinement,
around ``mapping.mapping_steps``.

The config is a dict with the layout of the reference's YAML configs
(``Training``, ``Dataset``, ``opt_params``, ``model_params``; read one
with utils/config.py). Random draws come from a ``torch.Generator`` on the
device (seeding keep masks, split noise) and, as in the reference, a
``random.Random`` for the random past keyframes, both seeded by
``config["seed"]`` (default 0). Map iterations run in power-of-2 batches
between schedule events, as the reference's do, and window pair plans are
reused across batches for ``plan_reuse_iters`` iterations while the
window and the Gaussian set stay the same.

With ``Training.mesh_devices`` = n > 1 the backend maps over a mesh of
n ranks (parallel/sharding.py): every rank runs the same ``BackEnd`` on
the same keyframe stream inside an initialized process group of n ranks
(``make_mesh`` raises without one), the window's frame slots are padded
to a multiple of n and split over the ranks, every slot is planned per
batch on its rank, and the host plan cache is off. ``prewarm_mapping``
only builds the CUDA kernels: there are no compiles to walk ahead of the
frame loop.

With ``GS_SLAM_NAN_CHECK=1`` in the environment at import (the JAX
package's switch), every map batch and every densify / prune ends with
``_assert_finite``: the active Gaussians and the keyframe poses must be
finite, or AssertionError((tag, field)). Off, it costs nothing.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import gaussian_map as gmap
from ..models.camera import Camera
from ..models.gaussian_map import GaussianMap
from ..ops.lie import pose_matrix
from ..utils.logging import Log
from . import mapping, seeding
from .mapping import KFStore, PoseAdamState

_NAN_CHECK = os.environ.get("GS_SLAM_NAN_CHECK") == "1"


class BackEnd:
    def __init__(self, config: dict, cam_template: Camera, device=None):
        self.device = dev = resolve_device(device)
        self.config = config
        self.cam = cam_template

        T = config["Training"]
        # keyframe data parallelism over a mesh of ranks; mesh_devices 1
        # keeps the single-device path
        n_mesh = T.get("mesh_devices", 1)
        self.mesh = None
        if n_mesh > 1:
            from ..parallel.sharding import make_mesh
            self.mesh = make_mesh(n_mesh, device=dev)
            Log(f"mapping sharded over {n_mesh} ranks", tag="Backend")
        self.monocular = T["monocular"]
        self.init_itr_num = T["init_itr_num"]
        self.init_gaussian_update = T["init_gaussian_update"]
        self.init_gaussian_reset = T["init_gaussian_reset"]
        self.init_gaussian_th = T["init_gaussian_th"]
        self.cameras_extent = 6.0
        self.init_gaussian_extent = (
            self.cameras_extent * T["init_gaussian_extent"])
        self.mapping_itr_num = T["mapping_itr_num"]
        self.gaussian_update_every = T["gaussian_update_every"]
        self.gaussian_update_offset = T["gaussian_update_offset"]
        self.gaussian_th = T["gaussian_th"]
        self.gaussian_extent = self.cameras_extent * T["gaussian_extent"]
        self.gaussian_reset = T["gaussian_reset"]
        self.size_threshold = T["size_threshold"]
        self.window_size = T["window_size"]
        self.pose_window = T["pose_window"]
        self.lr_rot = T["lr"]["cam_rot_delta"]
        self.lr_trans = T["lr"]["cam_trans_delta"]
        self.rgb_boundary_threshold = T["rgb_boundary_threshold"]
        self.alpha = T.get("alpha", 0.95)
        self.single_thread = config["Dataset"].get("single_thread", False)
        self.prune_mode = T.get("prune_mode", "slam")
        # the threaded pipeline's idle-refinement batch and frontend
        # priority (parallel/pipeline.py), and whether the driver builds
        # the kernels right after map init (prewarm_mapping)
        self.idle_batch = int(T.get("idle_batch", 4))
        self.frontend_priority = bool(T.get("frontend_priority", True))
        self.prewarm = bool(T.get("prewarm_mapping", False))
        self.prewarm_wall_s = 0.0     # run-summary itemization
        self.kf_capacity = T.get("kf_capacity", 128)
        self.use_oracle = T.get("renderer", "tiled") == "oracle"
        self.tile16 = bool(T.get("tile16", False))
        self.live_mode = False

        op = config["opt_params"]
        self.opt_params = op
        self.densify_grad_threshold = op["densify_grad_threshold"]
        self.percent_dense = op["percent_dense"]
        self.lambda_dssim = op["lambda_dssim"]
        self.spatial_lr_scale = 5.0   # the reference's nerf normalization
        self.pair_capacity = T.get("pair_capacity", 1 << 20)
        # window + 2 random slots, padded to a multiple of the mesh
        self.F = self.window_size + 2
        if self.mesh is not None:
            self.F = -(-self.F // n_mesh) * n_mesh

        sh_degree = config["model_params"]["sh_degree"]
        self.gm = GaussianMap.empty(T.get("initial_capacity", 1 << 16),
                                    sh_degree, device=dev)
        self.gm_adam = gmap.adam_init(self.gm)
        self.store = KFStore.empty(self.kf_capacity, cam_template.height,
                                   cam_template.width, device=dev)
        self.uid_to_slot: Dict[int, int] = {}
        self.current_window: List[int] = []   # frame uids, newest first
        self.occ_aware_visibility: Dict[int, torch.Tensor] = {}
        self.iteration_count = 0
        self.last_sent = 0     # iterations since the last sync to tracking
        self.initialized = not self.monocular
        self.pose_adam = PoseAdamState.zero(self.F, device=dev)
        seed = config.get("seed", 0)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._py_rng = random.Random(seed)
        self.bg = torch.zeros(3, dtype=torch.float32, device=dev)

        # window pair-plan cache across batches: (key, plans, iters used)
        self._plan_cache = None
        self._plan_reuse = int(T.get("plan_reuse_iters", 16))
        # coarse-mapping phase: the first map_coarse_frac of a steady
        # keyframe budget renders at map_coarse_level (off by default)
        self.map_coarse_level = int(T.get("map_coarse_level", 2))
        self.map_coarse_frac = float(T.get("map_coarse_frac", 0.0))
        # the 2 random keyframes drawn once per batch (so their plans
        # amortize) instead of once per iteration
        self.map_random_per_batch = bool(T.get("map_random_per_batch",
                                               True))
        self.plan_stats = dict(builds=0, reused_batches=0,
                               reused_iters=0, max_stale_iters=0)
        # per-densify records for run summaries (counts as device tensors)
        self.densify_log: List[dict] = []

    # ------------------------------------------------------------------
    def reset_state(self):
        """Drop every Gaussian and all keyframe state."""
        self.iteration_count = 0
        self._invalidate_plans()
        self.occ_aware_visibility = {}
        self.current_window = []
        self.initialized = not self.monocular
        self.pose_adam = PoseAdamState.zero(self.F, device=self.device)
        self.gm, self.gm_adam = gmap.prune(
            self.gm, self.gm_adam,
            torch.ones(self.gm.capacity, dtype=torch.bool,
                       device=self.device))
        self.store = KFStore.empty(self.kf_capacity, self.cam.height,
                                   self.cam.width, device=self.device)
        self.uid_to_slot = {}

    def _gm_lrs(self, xyz_lr=None):
        return gmap.default_lrs(self.opt_params, self.spatial_lr_scale,
                                xyz_lr=xyz_lr, device=self.device)

    def _xyz_lr(self, iteration):
        op = self.opt_params
        t = np.clip(iteration / op["position_lr_max_steps"], 0.0, 1.0)
        lr_init = op["position_lr_init"] * self.spatial_lr_scale
        lr_final = op["position_lr_final"] * self.spatial_lr_scale
        return float(np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))

    def _ensure_capacity(self, incoming: int):
        free = self.gm.capacity - int(self.gm.num_active())
        while free < incoming:
            new_cap = self.gm.capacity * 2
            Log(f"Growing map capacity to {new_cap}", tag="Backend")
            self.gm, self.gm_adam = gmap.grow(self.gm, self.gm_adam, new_cap)
            free = self.gm.capacity - int(self.gm.num_active())
            self._invalidate_plans()

    def _invalidate_plans(self):
        """The Gaussian set changed (extend, densify, prune, opacity reset,
        growth): a cached plan could miss pairs of new Gaussians."""
        self._plan_cache = None

    def _as_f32(self, x):
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def add_next_kf(self, frame_idx: int, R, t, exposure_a, exposure_b,
                    gt_image, gt_depth, depth_map, init=False):
        """Store the keyframe and seed new Gaussians from ``depth_map``."""
        slot = self.uid_to_slot.get(frame_idx)
        if slot is None:
            slot = len(self.uid_to_slot)
            if slot >= self.kf_capacity:
                self.kf_capacity *= 2
                Log(f"Growing KF store to {self.kf_capacity}", tag="Backend")
                self.store = self.store.grow(self.kf_capacity)
            self.uid_to_slot[frame_idx] = slot
        gt_image = self._as_f32(gt_image)
        gt_depth = (torch.zeros(1, self.cam.height, self.cam.width,
                                device=self.device)
                    if gt_depth is None else self._as_f32(gt_depth))
        if gt_depth.dim() == 2:
            gt_depth = gt_depth[None]
        self.store = self.store.add(
            slot, self._as_f32(R), self._as_f32(t), self._as_f32(exposure_a),
            self._as_f32(exposure_b), gt_image, gt_depth, frame_idx)

        ds_cfg = self.config["Dataset"]
        factor = (ds_cfg["pcd_downsample_init"] if init
                  else ds_cfg["pcd_downsample"])
        block = seeding.seed_from_frame(
            gt_image, self._as_f32(depth_map), self.cam, self._w2c(slot),
            frame_idx, self._gen, factor, ds_cfg["point_size"],
            ds_cfg.get("adaptive_pointsize", False), self.gm.max_sh_degree)
        self._ensure_capacity(int(torch.sum(block.valid)))
        self.gm, self.gm_adam, ov = gmap.extend(self.gm, self.gm_adam, block)
        self._invalidate_plans()
        if int(ov) > 0:
            Log(f"extend overflow {int(ov)}", tag="Backend")

    def _w2c(self, slot):
        return pose_matrix(self.store.R[slot], self.store.t[slot])

    # ------------------------------------------------------------------
    def _window_tensors(self, window_uids: List[int], random_uids: List[int],
                        frames_to_optimize: int):
        """Host slot layout of one iteration: (idx, valid, optimize_pose,
        optimize_exposure), each (F,)."""
        F = self.F
        idx = np.zeros(F, np.int32)
        valid = np.zeros(F, bool)
        opt_pose = np.zeros(F, bool)
        opt_exp = np.zeros(F, bool)
        for i, uid in enumerate(window_uids[:self.window_size]):
            idx[i] = self.uid_to_slot[uid]
            valid[i] = True
            if uid != 0:
                opt_exp[i] = True
                if i < frames_to_optimize:
                    opt_pose[i] = True
        for j, uid in enumerate(random_uids[:2]):
            idx[self.window_size + j] = self.uid_to_slot[uid]
            valid[self.window_size + j] = True
        return idx, valid, opt_pose, opt_exp

    def _pick_randoms(self):
        pool = [u for u in self.uid_to_slot
                if u not in set(self.current_window)]
        self._py_rng.shuffle(pool)
        return pool[:2]

    def _run_batch(self, window_uids, randoms_per_iter, frames_to_optimize,
                   initialization, need_nt=True, level=1):
        """Run the batch in power-of-2 chunks, as the reference does (the
        chunking decides when window plans are rebuilt). Only the last
        chunk renders n_touched, and only with ``need_nt``."""
        out = None
        rest = randoms_per_iter
        while rest:
            T = 1 << (len(rest).bit_length() - 1)
            out = self._run_batch_exact(
                window_uids, rest[:T], frames_to_optimize, initialization,
                need_nt=need_nt and len(rest) == T, level=level)
            rest = rest[T:]
        return out

    def _run_batch_exact(self, window_uids, randoms_per_iter,
                         frames_to_optimize, initialization, need_nt=True,
                         level=1):
        T = len(randoms_per_iter)
        rows = []
        for randoms in randoms_per_iter:
            idx, valid, opt_pose, opt_exp = self._window_tensors(
                window_uids, randoms, frames_to_optimize)
            rows.append(idx)
        window_idx = np.stack(rows)
        xyz_lrs = [self._xyz_lr(self.iteration_count + 1 + i)
                   for i in range(T)]
        plan_key = (tuple(int(x) for x in window_idx[0, :self.window_size]),
                    tuple(bool(v) for v in valid), self.gm.capacity,
                    self.pair_capacity, self.tile16, level)
        plans_in = None
        if (self.mesh is None and not self.use_oracle
                and self._plan_cache is not None
                and self._plan_cache[0] == plan_key
                and self._plan_cache[2] < self._plan_reuse):
            plans_in = self._plan_cache[1]
            self.plan_stats["reused_batches"] += 1
            self.plan_stats["reused_iters"] += T
            self.plan_stats["max_stale_iters"] = max(
                self.plan_stats["max_stale_iters"], self._plan_cache[2] + T)
        rows_const = all(r == randoms_per_iter[0]
                         for r in randoms_per_iter[1:])
        # on the mesh every (padded) slot is planned, each on its rank
        n_planned = None
        if rows_const and self.map_random_per_batch and not self.use_oracle:
            n_planned = (self.F if self.mesh is not None
                         else self.window_size + 2)
        out = mapping.mapping_steps(
            self.gm, self.gm_adam, self.store, window_idx, valid, opt_pose,
            opt_exp, self.pose_adam, self.cam, self.bg, self._gm_lrs(),
            xyz_lrs, self.lr_rot * 0.5, self.lr_trans * 0.5,
            self.rgb_boundary_threshold, n_window=self.window_size,
            alpha=self.alpha, monocular=self.monocular,
            initialization=initialization, pair_capacity=self.pair_capacity,
            use_oracle=self.use_oracle, tile16=self.tile16,
            need_n_touched=need_nt, window_plans_in=plans_in,
            n_planned=n_planned, level=level, mesh=self.mesh)
        if out.window_plans is not None:
            # staleness counts every iteration since the plans were built
            if plans_in is None:
                self.plan_stats["builds"] += 1
            used = T if plans_in is None else self._plan_cache[2] + T
            self._plan_cache = (plan_key, out.window_plans, used)
        self.iteration_count += T
        self.last_sent += T
        self.gm, self.gm_adam = out.gm, out.gm_adam
        self.store, self.pose_adam = out.store, out.pose_adam
        if _NAN_CHECK:
            self._assert_finite(f"after _run_batch T={T} "
                                f"init={initialization}")
        return out

    def _assert_finite(self, tag):
        """AssertionError((tag, field)) unless the active Gaussians'
        parameters and the keyframe poses are finite: one flag per field
        on the device, one host read."""
        act = self.gm.active
        fields = ("xyz", "scaling", "rotation", "opacity", "features_dc")
        flags = [(torch.isfinite(x) | ~act.view(-1, *[1] * (x.dim() - 1))
                  ).all() for x in (getattr(self.gm, f) for f in fields)]
        flags += [torch.isfinite(self.store.R).all(),
                  torch.isfinite(self.store.t).all()]
        for f, ok in zip(fields + ("R", "t"), torch.stack(flags).tolist()):
            if not ok:
                raise AssertionError((tag, f))

    def _next_event(self, it: int) -> int:
        """The first densify or opacity-reset iteration after ``it``."""
        e, o, r = (self.gaussian_update_every, self.gaussian_update_offset,
                   self.gaussian_reset)
        nxt_update = it + ((o - it - 1) % e) + 1
        nxt_reset = it + ((-it - 1) % r) + 1
        return min(nxt_update, nxt_reset)

    def map(self, window_uids: List[int], prune: bool = False,
            iters: int = 1, frames_to_optimize: Optional[int] = None,
            initialization: bool = False):
        """The reference's BackEnd.map: ``iters`` iterations, batched
        between the densify / opacity-reset events; with ``prune``, one
        iteration and the covisibility prune."""
        if len(window_uids) == 0:
            return False
        if frames_to_optimize is None:
            frames_to_optimize = self.pose_window

        coarse_iters = 0
        if (not initialization and not prune and self.map_coarse_level > 1
                and self.map_coarse_frac > 0 and iters >= 4):
            coarse_iters = min(iters - 2,
                               int(round(iters * self.map_coarse_frac)))

        out = None
        remaining = iters
        while remaining > 0:
            in_coarse = (iters - remaining) < coarse_iters
            if prune or initialization:
                batch = remaining
            else:
                batch = min(remaining,
                            self._next_event(self.iteration_count)
                            - self.iteration_count)
                if in_coarse:
                    batch = min(batch, coarse_iters - (iters - remaining))
            if initialization:
                randoms = [[] for _ in range(batch)]
            elif self.map_random_per_batch:
                randoms = [self._pick_randoms()] * batch
            else:
                randoms = [self._pick_randoms() for _ in range(batch)]
            out = self._run_batch(
                window_uids, randoms, frames_to_optimize, initialization,
                need_nt=(prune or batch == remaining) and not in_coarse,
                level=self.map_coarse_level if in_coarse else 1)
            remaining -= batch

            if prune:
                self._covisibility_prune(window_uids, out.n_touched)
                return False
            if initialization:
                continue

            it = self.iteration_count
            if it % self.gaussian_update_every == self.gaussian_update_offset:
                self._densify_and_prune(
                    self.gaussian_th, self.gaussian_extent,
                    self.size_threshold)
            elif it % self.gaussian_reset == 0:
                Log("Resetting opacity of non-visible gaussians",
                    tag="Backend")
                vis_any = torch.any(out.radii > 0, dim=0)
                self.gm, self.gm_adam = gmap.reset_opacity_nonvisible(
                    self.gm, self.gm_adam, vis_any)
                self._invalidate_plans()

        if out is not None:
            for i, uid in enumerate(window_uids[:self.window_size]):
                self.occ_aware_visibility[uid] = out.n_touched[i] > 0
        return True

    def _densify_and_prune(self, th, extent, size_threshold):
        # headroom for split and clone (up to 2x active)
        self._ensure_capacity(int(self.gm.num_active()))
        counts = dict(iteration=self.iteration_count)
        self.gm, self.gm_adam, ov = gmap.densify_and_prune(
            self.gm, self.gm_adam, self._gen, self.densify_grad_threshold,
            th, extent, size_threshold, self.percent_dense, counts=counts)
        counts["overflow"] = ov
        self.densify_log.append(counts)
        self._invalidate_plans()
        if int(ov) > 0:
            Log(f"densify overflow {int(ov)}", tag="Backend")
        if _NAN_CHECK:
            self._assert_finite("after densify_and_prune")

    def _covisibility_prune(self, window_uids, n_touched):
        """The reference's covisibility prune (prune_mode slam/odometry),
        on the device."""
        self.occ_aware_visibility = {}
        k = len(window_uids[:self.window_size])
        for i, uid in enumerate(window_uids[:self.window_size]):
            self.occ_aware_visibility[uid] = n_touched[i] > 0

        if len(window_uids) == self.window_size:
            prune_coviz = 3
            n_obs = torch.sum((n_touched[:k] > 0).to(torch.int32), dim=0,
                              dtype=torch.int32)
            self.gm = self.gm.replace(n_obs=n_obs)
            to_prune = None
            if self.prune_mode == "odometry":
                to_prune = n_obs < 3
            if self.prune_mode == "slam":
                sorted_window = sorted(window_uids, reverse=True)
                kfids = self.gm.unique_kfids
                mask = kfids >= sorted_window[2]
                if not self.initialized:
                    mask = kfids >= 0
                to_prune = (n_obs <= prune_coviz) & mask
            if to_prune is not None and self.monocular:
                self.gm, self.gm_adam = gmap.prune(self.gm, self.gm_adam,
                                                   to_prune)
                self._invalidate_plans()
            if not self.initialized:
                self.initialized = True
                Log("Initialized SLAM", tag="Backend")

    # ------------------------------------------------------------------
    def initialize_map(self, frame_uid: int):
        """The reference's initialize_map: ``init_itr_num`` iterations on
        the first keyframe, densifying every ``init_gaussian_update`` and
        resetting opacity at ``init_gaussian_reset`` and
        ``densify_from_iter``."""
        events = sorted(set(
            list(range(self.init_gaussian_update, self.init_itr_num + 1,
                       self.init_gaussian_update))
            + [self.init_gaussian_reset,
               self.opt_params["densify_from_iter"]]))
        done = 0
        t0 = time.time()
        for ev in events + [self.init_itr_num]:
            if ev <= done or ev > self.init_itr_num:
                continue
            self.map([frame_uid], iters=ev - done, initialization=True,
                     frames_to_optimize=0)
            done = ev
            if ev % self.init_gaussian_update == 0:
                self._densify_and_prune(
                    self.init_gaussian_th, self.init_gaussian_extent, None)
            if ev in (self.init_gaussian_reset,
                      self.opt_params["densify_from_iter"]):
                self.gm, self.gm_adam = gmap.reset_opacity(self.gm,
                                                           self.gm_adam)
        Log(f"Initialized map ({time.time() - t0:.1f}s)", tag="Backend")

    def prewarm_mapping(self):
        """Build every CUDA kernel before the clock starts (the
        reference's compile-and-dispatch walk has no counterpart)."""
        if self.device.type == "cuda":
            from ..ops import _build
            t0 = time.time()
            _build.build()
            self.prewarm_wall_s = time.time() - t0

    def handle_keyframe(self, frame_idx, window_uids):
        """Map the new window, then the prune pass."""
        t0 = time.perf_counter()
        self.current_window = list(window_uids)
        iter_per_kf = self.mapping_itr_num if self.single_thread else 10
        frames_to_optimize = self.pose_window
        if not self.initialized:
            if len(self.current_window) == self.window_size:
                frames_to_optimize = self.window_size - 1
                iter_per_kf = 50 if self.live_mode else 300
                Log("Performing initial BA for initialization",
                    tag="Backend")
            else:
                iter_per_kf = self.mapping_itr_num
        self.pose_adam = PoseAdamState.zero(self.F, device=self.device)
        self.map(self.current_window, iters=iter_per_kf,
                 frames_to_optimize=frames_to_optimize)
        t1 = time.perf_counter()
        self.map(self.current_window, prune=True,
                 frames_to_optimize=frames_to_optimize)
        t2 = time.perf_counter()
        Log(f"keyframe {frame_idx} mapped: {iter_per_kf} iters, window "
            f"{len(self.current_window)}, {t2 - t0:.3f}s (map "
            f"{t1 - t0:.3f} prune {t2 - t1:.3f})", tag="Backend")

    def color_refinement(self, iteration_total: int = 26000,
                         batch: int = 256):
        """The reference's color refinement: random keyframes, the xyz lr
        from the schedule, in power-of-2 batches."""
        Log("Starting color refinement", tag="Backend")
        slots = [self.uid_to_slot[u] for u in self.uid_to_slot]
        it = 0
        while it < iteration_total:
            T = min(batch, iteration_total - it)
            T = 1 << (T.bit_length() - 1)
            idxs = [slots[self._py_rng.randint(0, len(slots) - 1)]
                    for _ in range(T)]
            xyz_lrs = [self._xyz_lr(it + 1 + i) for i in range(T)]
            self.gm, self.gm_adam, _ = mapping.color_refinement_steps(
                self.gm, self.gm_adam, self.store, idxs, xyz_lrs, self.cam,
                self.bg, self._gm_lrs(), self.lambda_dssim,
                pair_capacity=self.pair_capacity, use_oracle=self.use_oracle,
                tile16=self.tile16)
            it += T
        Log("Map refinement done", tag="Backend")

    def keyframe_poses(self):
        """[(uid, R (3, 3), t (3,))] of the current window, as numpy, in
        one device-to-host copy."""
        uids = list(self.current_window)
        if not uids:
            return []
        slots = torch.as_tensor([self.uid_to_slot[u] for u in uids],
                                device=self.device)
        Rt = torch.cat([self.store.R[slots].reshape(len(uids), 9),
                        self.store.t[slots]], dim=1).cpu().numpy()
        return [(u, Rt[i, :9].reshape(3, 3), Rt[i, 9:12])
                for i, u in enumerate(uids)]

"""SLAM driver (torch port of slam/driver.py): wires dataset, frontend and
backend, runs the system (single thread inline, or the backend on a host
thread via parallel/pipeline.py), and evaluates: FPS, final ATE,
rendering metrics with color refinement, the map's ply, headless render
snapshots, the run summary and the optional live PNG stream.

``device=None`` means CUDA (raises without a GPU). ``viewer_port`` serves
the browser viewer (gui/web.py) while the system runs; paused from the
browser, the single-thread loop waits before its next frame.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.camera import Camera
from ..utils import eval as eval_utils
from ..utils import ply
from ..utils.datasets import load_dataset
from ..utils.logging import Log
from .backend import BackEnd
from .frontend import FrontEnd
from .render_api import render


class SLAM:
    def __init__(self, config: dict, save_dir: Optional[str] = None,
                 live_interval: float = 0.0,
                 viewer_port: Optional[int] = None, dataset=None,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.save_dir = save_dir
        # --viewer PORT: interactive browser viewer (gui/web.py), the
        # displayless counterpart of the reference's Open3D window
        self.viewer_port = viewer_port
        self.web_viewer = None
        # --live: stream headless-viewer PNGs of the current map at this
        # interval while the system runs (the displayless stand-in for the
        # reference's interactive window, gui/slam_gui.py:540-571)
        self.live_interval = live_interval
        self.control_queue = None   # visualizer->main pause/unpause channel
        # derive monocular from the sensor type (reference slam.py:44-52)
        config["Training"].setdefault(
            "monocular",
            config["Dataset"].get("sensor_type") == "monocular")
        self.dataset = dataset if dataset is not None else \
            load_dataset(config)
        self.monocular = config["Training"]["monocular"]

        self.cam = Camera.create(
            np.eye(3), np.zeros(3),
            self.dataset.fx, self.dataset.fy, self.dataset.cx,
            self.dataset.cy, self.dataset.width, self.dataset.height,
            device=self.device)

        self.backend = BackEnd(config, self.cam, device=self.device)
        self.frontend = FrontEnd(config, self.dataset, self.cam,
                                 self.backend, device=self.device)
        self.frontend.save_dir = save_dir
        self.use_threads = not config["Training"].get("single_thread", True)

    def run(self, n_frames: Optional[int] = None,
            eval_rendering: bool = False, color_refinement_iters=None):
        N = len(self.dataset) if n_frames is None else min(
            n_frames, len(self.dataset))
        t0 = time.time()
        live_stop = self._start_live_stream()
        if self.viewer_port is not None:
            from ..gui.web import WebViewer
            self.web_viewer = WebViewer(self, self.viewer_port).start()
        try:
            if self.use_threads:
                import queue as _q

                from ..parallel.pipeline import run_pipelined
                self.control_queue = _q.Queue()
                run_pipelined(self.frontend, self.backend, N,
                              control_queue=self.control_queue)
            else:
                for idx in range(N):
                    # viewer pause point (the reference frontend's
                    # per-frame pause poll, slam_frontend.py:333-343)
                    while (self.web_viewer is not None
                           and self.web_viewer.paused):
                        time.sleep(0.05)
                    self.frontend.process_frame(idx)
        finally:
            if live_stop is not None:
                live_stop.set()
            if self.web_viewer is not None:
                self.web_viewer.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        fps = N / wall
        Log(f"Total FPS: {fps:.3f} ({N} frames in {wall:.1f}s)", tag="Eval")

        results = dict(fps=fps, n_frames=N, wall_time=wall)
        if self.frontend.kf_indices:
            results["ate"] = eval_utils.eval_ate(
                self.frontend.frames, self.frontend.kf_indices,
                self.save_dir, final=True, monocular=self.monocular)

        if eval_rendering:
            results["rendering_before_opt"] = self._eval_rendering("before")
            iters = (color_refinement_iters
                     if color_refinement_iters is not None else 26000)
            if iters:
                self.backend.color_refinement(iters)
                self.frontend.sync_backend()
                results["rendering_after_opt"] = self._eval_rendering(
                    "after")
        if self.save_dir:
            ply.save_ply(self.backend.gm,
                         os.path.join(self.save_dir, "point_cloud",
                                      "final", "point_cloud.ply"))
            self._save_renders()
            self._write_run_summary(results)
        return results

    def _write_run_summary(self, results: dict):
        """Consolidated run record — the zero-egress stand-in for the
        reference's wandb run (slam.py:243-250, eval_utils.py:112): one
        JSON with the FPS accounting, the interim ATE series, final
        metrics and run facts."""
        import json

        summary = dict(
            fps=results.get("fps"),
            wall_time_s=results.get("wall_time"),
            n_frames=results.get("n_frames"),
            final_ate_m=results.get("ate"),
            ate_series=list(self.frontend.ate_log),
            n_keyframes=len(self.frontend.kf_indices),
            keyframe_ids=list(map(int, self.frontend.kf_indices)),
            n_gaussians=int(self.backend.gm.num_active()),
            rendering_before_opt=results.get("rendering_before_opt"),
            rendering_after_opt=results.get("rendering_after_opt"),
            monocular=self.monocular,
            device=(torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu"),
            dataset=self.config["Dataset"].get("type"),
            tracker=self.frontend.tracker,
            renderer=("oracle" if self.backend.use_oracle else
                      ("tiled16" if self.backend.tile16 else "tiled32")),
            # window pair-plan cache staleness (see BackEnd.plan_stats):
            # max_stale_iters near plan_reuse_iters with degraded mapping
            # metrics points at stale plans dropping pairs
            plan_cache=dict(self.backend.plan_stats),
            # frames tracked on a reused (cross-frame) pair plan
            track_plan_reuse=self.frontend._plan_reuse_count,
            # one-time pre-frame-loop costs: the kernel builds
            prewarm=dict(
                tracking_s=round(self.frontend.prewarm_wall_s, 2),
                mapping_s=round(self.backend.prewarm_wall_s, 2),
            ),
        )
        flog = self.frontend.frame_log
        if flog:
            # frame-loop wall-time decomposition: where each processed
            # frame's wall went (track includes device-queue wait behind
            # any in-flight mapping batch; other = keyframing stats pull
            # + throttle + sync adoption)
            tot = sum(f["total"] for f in flog)
            summary["frame_time_breakdown_s"] = dict(
                n=len(flog),
                total=round(tot, 2),
                load=round(sum(f["load"] for f in flog), 2),
                track=round(sum(f["track"] for f in flog), 2),
                kf_host=round(sum(f["kf_host"] for f in flog), 2),
                other=round(tot - sum(
                    f["load"] + f["track"] + f["kf_host"] for f in flog), 2),
                track_p50_ms=round(1000 * float(np.median(
                    [f["track"] for f in flog])), 1),
                track_max_ms=round(1000 * max(
                    f["track"] for f in flog), 1),
            )
        with open(os.path.join(self.save_dir, "run_summary.json"),
                  "w") as f:
            json.dump(summary, f, indent=2)
        Log(f"wrote run summary to "
            f"{os.path.join(self.save_dir, 'run_summary.json')}",
            tag="Eval")

    def _start_live_stream(self):
        """--live: a viewer thread snapshotting the evolving map from the
        newest tracked pose every ``live_interval`` seconds. No one writes
        a map's tensors in place, so reading the backend's current
        reference is race-free."""
        if not self.live_interval or not self.save_dir:
            return None
        import threading

        from ..gui.headless import HeadlessViewer

        stop = threading.Event()
        viewer = HeadlessViewer(
            os.path.join(self.save_dir, "live"), self.cam,
            pair_capacity=self.backend.pair_capacity,
            use_oracle=self.backend.use_oracle)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def loop():
            k = 0
            while not stop.wait(self.live_interval):
                frames = self.frontend.frames
                if not frames or int(self.backend.gm.num_active()) == 0:
                    continue
                rec = frames[max(frames)]
                try:
                    with torch.cuda.stream(stream):
                        viewer.snapshot(self.backend.gm, rec.R, rec.t,
                                        tag=f"live{k:05d}")
                except Exception as e:      # never take down the run
                    Log(f"live snapshot failed: {e}", tag="GUI")
                k += 1

        threading.Thread(target=loop, daemon=True).start()
        return stop

    def _save_renders(self, n_orbit: int = 6):
        """Headless visualization dump: per-keyframe snapshots + a free-
        camera orbit (the GUI's role, reference gui/slam_gui.py:540-571)."""
        from ..gui.headless import HeadlessViewer

        viewer = HeadlessViewer(
            os.path.join(self.save_dir, "renders"), self.cam,
            pair_capacity=self.backend.pair_capacity,
            use_oracle=self.backend.use_oracle)
        gm = self.backend.gm
        for uid in self.frontend.kf_indices[-4:]:
            rec = self.frontend.frames[uid]
            viewer.snapshot(gm, rec.R, rec.t, tag=f"kf{uid:04d}")
        viewer.orbit(gm, n_views=n_orbit)
        Log(f"wrote render snapshots to {viewer.out_dir}", tag="GUI")

    def _eval_rendering(self, tag):
        def render_rec(rec):
            cam = self.cam.replace(
                R=torch.as_tensor(np.asarray(rec.R, np.float32),
                                  device=self.device),
                t=torch.as_tensor(np.asarray(rec.t, np.float32),
                                  device=self.device))
            with torch.no_grad():
                return render(self.backend.gm, cam, None,
                              pair_capacity=self.backend.pair_capacity,
                              device=self.device)

        # frames were cleaned; poses survive in frontend.frames
        frames = {}
        for idx in range(len(self.dataset)):
            if idx in self.frontend.frames:
                frames[idx] = self.frontend.frames[idx]
        return eval_utils.eval_rendering(
            frames, self.frontend.kf_indices, self.dataset, render_rec,
            self.save_dir, iteration=tag)

"""Tracking/mapping host-thread pipeline (torch port of
parallel/pipeline.py).

The reference runs tracking and mapping as two processes sharing CUDA
tensors over torch.multiprocessing queues; here the backend is a host
thread and queue.Queue carries the messages. Handing the map over is a
reference copy, which is race-free because nothing writes a map's
tensors in place: the port's map, optimizer and keyframe-store updates
all return new tensors (models/gaussian_map.py, slam/mapping.py), and
both threads enqueue their kernels on one CUDA stream (the caller's
current stream), so a tensor the backend hands over was produced before
anything the frontend enqueues reads it. The message grammar is kept:

  frontend -> backend: ["init", ...] | ["keyframe", ...] | ["color_refinement"]
                       | ["pause"] | ["unpause"] | ["stop"]
  backend -> frontend: ["sync_backend"|"init"|"keyframe", gm,
                        occ_aware_visibility, keyframe_poses]
  control -> frontend: ["pause"] | ["unpause"]   (the GUI's Packet_vis2main
                        flag_pause channel, reference slam.py:98-108,
                        slam_frontend.py:333-343)

(reference slam_frontend.py:288-300, slam_backend.py:355-365.)

Pause semantics mirror the reference: the frontend idles between frames
while paused (forwarding ["pause"] to the backend, which then skips its
idle-mapping refinement, slam_backend.py:386-390); ["unpause"] resumes
both loops where they left off.
"""

from __future__ import annotations

import queue
import threading
import time

import torch

from ..utils.logging import Log


class FakeQueue:
    """Null transport (reference multiprocessing_utils.py:7-18)."""

    def put(self, *a, **k):
        pass

    def get_nowait(self):
        raise queue.Empty

    def get(self, *a, **k):
        raise queue.Empty

    def qsize(self):
        return 0

    def empty(self):
        return True


class BackendLink:
    """Frontend-side handle to the backend thread."""

    def __init__(self, backend_queue: queue.Queue,
                 frontend_queue: queue.Queue):
        self.backend_queue = backend_queue
        self.frontend_queue = frontend_queue
        # frontend-priority device scheduling: set while the frontend has
        # a frame in flight on the device; the backend defers IDLE
        # refinement batches (keyframe mapping is never deferred), which
        # on one in-order stream would otherwise queue tracking behind
        # whole idle-mapping batches.
        self.want_device = threading.Event()

    def send(self, msg):
        self.backend_queue.put(msg)

    def drain(self, frontend):
        """Apply all pending backend->frontend messages."""
        while True:
            try:
                data = self.frontend_queue.get_nowait()
            except queue.Empty:
                return
            self._apply(frontend, data)

    def wait_init(self, frontend):
        while True:
            data = self.frontend_queue.get()
            self._apply(frontend, data)
            if data[0] == "init":
                return

    def wait_all_keyframes(self, frontend):
        while frontend.requested_keyframe > 0:
            data = self.frontend_queue.get()
            self._apply(frontend, data)

    def wait_ack(self, frontend, timeout: float):
        """Yield until every pending keyframe ack lands or ``timeout``
        elapses, applying backend messages as they arrive. Used by the
        frontend's pending-keyframe device yield: blocking on the queue
        (instead of a blind sleep) resumes tracking the moment the
        backend's mapping batch finishes, so an early ack does not cost
        the full yield window."""
        deadline = time.monotonic() + timeout
        while frontend.requested_keyframe > 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            try:
                data = self.frontend_queue.get(timeout=remaining)
            except queue.Empty:
                return
            self._apply(frontend, data)

    @staticmethod
    def _apply(frontend, data):
        tag = data[0]
        if tag == "crash":
            # the backend thread died — every wait_* call sits on this
            # queue, so without propagation the frontend would block
            # forever (e.g. wait_init after an OOM during map init)
            raise RuntimeError(f"backend thread crashed: {data[1]}")
        if tag in ("sync_backend", "init", "keyframe"):
            frontend.sync_backend(tuple(data[1:4]))
            if tag == "keyframe":
                frontend.requested_keyframe -= 1


def backend_loop(backend, backend_queue: queue.Queue,
                 frontend_queue: queue.Queue, want_device=None):
    """The backend thread's message loop (reference BackEnd.run,
    slam_backend.py:367-482): idle single-iteration mapping with periodic
    syncs, plus message handling."""

    def push(tag="sync_backend"):
        backend.last_sent = 0
        frontend_queue.put([tag, backend.gm,
                            dict(backend.occ_aware_visibility),
                            backend.keyframe_poses()])

    paused = False
    try:
        _backend_loop_body(backend, backend_queue, frontend_queue,
                           want_device, push, paused)
    except Exception as e:   # noqa: BLE001 — propagate to the frontend
        Log(f"backend thread crashed: {e!r}", tag="Backend")
        frontend_queue.put(["crash", repr(e)])
        raise


def _backend_loop_body(backend, backend_queue, frontend_queue,
                       want_device, push, paused):
    while True:
        if backend_queue.empty():
            if paused or len(backend.current_window) == 0:
                time.sleep(0.01)
                continue
            if want_device is not None and want_device.is_set():
                # frontend priority: a tracked frame is in flight — defer
                # idle refinement (keyframe messages still preempt below)
                time.sleep(0.005)
                continue
            # idle refinement (reference slam_backend.py:369-383 runs ONE
            # iteration per loop). Idle iterations run in small batches
            # (idle_batch, default 4) that amortize the window plans;
            # message latency stays bounded by one batch.
            backend.map(backend.current_window,
                        iters=getattr(backend, "idle_batch", 4))
            if backend.last_sent >= 10:
                backend.map(backend.current_window, prune=True, iters=10)
                push()
        else:
            data = backend_queue.get()
            tag = data[0]
            if tag == "stop":
                break
            elif tag == "pause":
                # reference slam_backend.py:386-390: skip idle-mapping
                # while the visualizer holds the system paused
                paused = True
            elif tag == "unpause":
                paused = False
            elif tag == "color_refinement":
                backend.color_refinement()
                push()
            elif tag == "init":
                _, idx, rec, depth_map = data
                Log("Resetting the system", tag="Backend")
                backend.reset_state()
                backend.add_next_kf(
                    idx, rec.R, rec.t, rec.exposure_a, rec.exposure_b,
                    rec.gt_image, rec.gt_depth, depth_map, init=True)
                backend.initialize_map(idx)
                backend.current_window = [idx]
                if getattr(backend, "prewarm", False):
                    backend.prewarm_mapping()
                push("init")
            elif tag == "keyframe":
                _, idx, rec, window, depth_map = data
                backend.add_next_kf(
                    idx, rec.R, rec.t, rec.exposure_a, rec.exposure_b,
                    rec.gt_image, rec.gt_depth, depth_map)
                backend.handle_keyframe(idx, window)
                push("keyframe")
            else:
                raise RuntimeError(f"Unprocessed message {tag}")
    # drain (reference slam_backend.py:478-481)
    while not backend_queue.empty():
        backend_queue.get()


def run_pipelined(frontend, backend, n_frames: int,
                  control_queue: "queue.Queue | None" = None,
                  frame_callback=None):
    """Run the SLAM system with the backend on its own host thread.

    ``control_queue`` is the visualizer->main channel (the reference's
    q_vis2main, slam.py:98-108): ["pause"] holds the frontend between
    frames (forwarded to the backend so its idle mapping stops too),
    ["unpause"] resumes. ``frame_callback(idx)`` fires after each
    processed frame (used by the live viewer / tests)."""
    backend_queue: queue.Queue = queue.Queue()
    frontend_queue: queue.Queue = queue.Queue()
    link = BackendLink(backend_queue, frontend_queue)
    frontend.link = link
    frontend.paused = False

    def poll_control(block: bool = False):
        if control_queue is None:
            return
        while True:
            try:
                msg = control_queue.get(timeout=0.01) if block \
                    else control_queue.get_nowait()
            except queue.Empty:
                return
            tag = msg[0]
            if tag in ("pause", "unpause"):
                frontend.paused = tag == "pause"
                backend_queue.put([tag])
                Log(f"{tag}d by control channel", tag="Frontend")

    priority = getattr(backend, "frontend_priority", True)
    dev = getattr(backend, "device", None)
    stream = (torch.cuda.current_stream(dev)
              if dev is not None and dev.type == "cuda" else None)

    def backend_thread():
        # the frontend's stream: both threads' kernels run in one order
        with torch.cuda.stream(stream):
            backend_loop(backend, backend_queue, frontend_queue,
                         link.want_device if priority else None)

    thread = threading.Thread(target=backend_thread, daemon=True)
    thread.start()
    try:
        for idx in range(n_frames):
            poll_control()
            while frontend.paused:
                # keep adopting backend syncs while held (reference
                # slam_frontend.py:333-343)
                link.drain(frontend)
                poll_control(block=True)
            frontend.process_frame(idx)
            if frame_callback is not None:
                frame_callback(idx)
        link.wait_all_keyframes(frontend)
    finally:
        import sys
        backend_queue.put(["stop"])
        # a backend mid-batch can take a while; abandoning the thread
        # leaves it contending with whatever runs next on the device, so
        # wait it out on a clean exit, but not for long on a propagating
        # exception
        wait_s = 60 if sys.exc_info()[0] is not None else 900
        thread.join(timeout=wait_s)
        if thread.is_alive():
            Log(f"backend thread still alive after {wait_s}s stop wait",
                tag="Pipeline")
        frontend.link = None

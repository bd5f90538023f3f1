"""The port's browser viewer (gui/web.py) on the CPU: tests/
test_web_viewer.py's three tests against the port. Drives the real HTTP
surface on 127.0.0.1: the page, live frames in all three view modes
(PNG from the port's zlib encoder, decoded here to check its size and
that it is not blank), the free orbit camera, the status, the
pause/unpause control grammar, and the driver's single-thread pause
point (``SLAM(viewer_port=0).run``)."""

import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

from gs_slam_analytica_jacobian_tpu_torch.gui.web import WebViewer
from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

W, H = 64, 48


def tiny_slam():
    """tests/test_web_viewer.py::tiny_slam's config, on the CPU."""
    cfg = load_config("configs/synthetic/test.yaml")
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = W, H
    cal["fx"] = cal["fy"] = 44.0
    cal["cx"], cal["cy"] = 31.5, 23.5
    cfg["Dataset"]["motion_scale"] = 0.5
    cfg["Dataset"]["n_frames"] = 3
    cfg["Dataset"]["pcd_downsample_init"] = 4
    cfg["Dataset"]["pcd_downsample"] = 8
    cfg["Results"]["save_results"] = False
    T = cfg["Training"]
    T["renderer"] = "tiled"
    T["pair_capacity"] = 1 << 13
    T["init_itr_num"] = 4
    T["init_gaussian_update"] = 4
    T["init_gaussian_reset"] = 5000
    T["tracking_itr_num"] = 3
    T["pyr_iters"] = [2, 2, 2]
    T["mapping_itr_num"] = 2
    T["window_size"] = 3
    T["pose_window"] = 2
    T["initial_capacity"] = 4096
    T["kf_capacity"] = 8
    T["monocular"] = False
    return SLAM(cfg, device="cpu")


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def post(url):
    req = urllib.request.Request(url, method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def decode_png(data):
    """The (h, w, 3) uint8 image of an 8-bit RGB PNG whose rows all use
    filter type 0, as gui/headless.py's encoder writes it."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and ctype == 2
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_web_viewer_endpoints():
    slam = tiny_slam()
    for idx in range(3):
        slam.frontend.process_frame(idx)

    viewer = WebViewer(slam, port=0).start()   # port 0 = auto-assign
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        code, body = get(base + "/")
        assert code == 200 and b"GS-SLAM viewer" in body

        code, body = get(base + "/status")
        st = json.loads(body)
        assert code == 200 and st["frame"] == 2
        assert st["n_gaussians"] > 50 and not st["paused"]

        # follow-camera live render: a PNG of the camera's size
        code, body = get(base + "/frame.png?mode=color&follow=1")
        assert code == 200, body[:300]
        img = decode_png(body)
        assert img.shape == (H, W, 3) and img.max() > 0

        # pause/unpause control grammar (Packet_vis2main role)
        code, _ = post(base + "/control?action=pause")
        assert code == 200 and viewer.paused
        code, _ = post(base + "/control?action=unpause")
        assert code == 200 and not viewer.paused

        code, _ = get(base + "/nope")
        assert code == 404
    finally:
        viewer.stop()


def test_web_viewer_render_modes():
    """All three view modes (color/depth/normal) and the free-orbit camera
    (the mouse-drag role): each a PNG of the camera's size, not blank, and
    the modes differ from each other."""
    slam = tiny_slam()
    for idx in range(3):
        slam.frontend.process_frame(idx)

    viewer = WebViewer(slam, port=0).start()
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        imgs = {}
        for mode in ("color", "depth", "normal"):
            code, body = get(base + f"/frame.png?mode={mode}&follow=1")
            assert code == 200, (mode, body[:300])
            imgs[mode] = decode_png(body)
            assert imgs[mode].shape == (H, W, 3) and imgs[mode].max() > 0
        assert not np.array_equal(imgs["color"], imgs["depth"])
        assert not np.array_equal(imgs["depth"], imgs["normal"])

        code, body = get(
            base + "/frame.png?mode=color&follow=0&yaw=0.7&pitch=-0.3"
                   "&dist=1.5")
        assert code == 200, body[:300]
        free = decode_png(body)
        assert free.shape == (H, W, 3)
        assert not np.array_equal(free, imgs["color"])
    finally:
        viewer.stop()


def test_web_viewer_pause_holds_single_thread_loop():
    """The driver's single-thread pause point: with the viewer paused no
    frame advances; unpausing resumes to completion (the reference
    frontend's per-frame pause poll, slam_frontend.py:333-343)."""
    slam = tiny_slam()
    slam.viewer_port = 0
    done = {}

    def run():
        done["results"] = slam.run(n_frames=3)

    th = threading.Thread(target=run)
    th.start()
    t0 = time.time()
    while slam.web_viewer is None and time.time() - t0 < 60:
        time.sleep(0.01)
    assert slam.web_viewer is not None
    slam.web_viewer.paused = True
    n_before = max(slam.frontend.frames, default=-1)
    time.sleep(0.5)
    n_during = max(slam.frontend.frames, default=-1)
    # allow the one frame that may already have been in flight
    assert n_during <= n_before + 1
    slam.web_viewer.paused = False
    th.join(timeout=300)
    assert not th.is_alive()
    assert np.isfinite(done["results"]["ate"])
    assert slam.web_viewer._server is None        # stopped by run()

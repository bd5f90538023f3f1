"""Headless map visualization: render-to-PNG snapshot consumer (torch port
of gui/headless.py).

The reference's viewer process re-renders map snapshots from a free camera
with the same renderer and shades depth as normals; without a display,
this writes color / depth-colormap / normal-shaded PNGs from given poses
and from an orbit around the map. PNGs are written by a small zlib +
struct encoder (``save_png``), so no imaging package is needed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..models.camera import Camera
from ..models.gaussian_map import GaussianMap
from ..slam.render_api import render
from ..utils.logging import Log


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG (filter type 0 on
    every row, one zlib stream)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(arr: np.ndarray, path: str):
    """arr: (H, W, 3) float [0,1] or (H, W) float -> 8-bit PNG (the values
    the reference's PIL path writes: clip to [0, 1], times 255, truncated
    to uint8)."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    rgb = (np.clip(a, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def colorize_depth(depth: np.ndarray, near: Optional[float] = None,
                   far: Optional[float] = None) -> np.ndarray:
    """Turbo-ish colormap for depth (H, W) -> (H, W, 3)."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if near is None:
        near = float(d[valid].min()) if valid.any() else 0.0
    if far is None:
        far = float(d[valid].max()) if valid.any() else 1.0
    x = np.clip((d - near) / max(far - near, 1e-6), 0, 1)
    # simple 3-stop colormap (blue -> green -> red)
    r = np.clip(2 * x - 1, 0, 1)
    g = 1 - np.abs(2 * x - 1)
    b = np.clip(1 - 2 * x, 0, 1)
    out = np.stack([r, g, b], axis=-1)
    out[~valid] = 0.0
    return out


def depth_to_normals(depth: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Depth -> shaded normal map (H, W, 3) in [0,1]; the reference's
    vis_normal/depth2normal shading (gui/slam_gui.py:461-502), done with
    numpy central differences on the backprojected points."""
    d = np.asarray(depth, np.float32)
    H, W = d.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = d
    x = (xs - W / 2) / fx * z
    y = (ys - H / 2) / fy * z
    p = np.stack([x, y, z], axis=-1)
    dy = np.gradient(p, axis=0)
    dx = np.gradient(p, axis=1)
    n = np.cross(dx.reshape(-1, 3), dy.reshape(-1, 3)).reshape(H, W, 3)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-9)
    shaded = 0.5 * (n + 1.0)
    shaded[d <= 0] = 0.0
    return shaded


class HeadlessViewer:
    """Consumes (GaussianMap, Camera) snapshots and writes PNG frames —
    the GUI process's receive_data/rasterise loop (slam_gui.py:390-459,
    540-571) without a window."""

    def __init__(self, out_dir: str, cam_template: Camera,
                 pair_capacity: int = 1 << 20, use_oracle: bool = False):
        self.out_dir = out_dir
        self.cam = cam_template
        self.pair_capacity = pair_capacity
        self.use_oracle = use_oracle
        self.count = 0

    def snapshot(self, gm: GaussianMap, R: np.ndarray, t: np.ndarray,
                 tag: Optional[str] = None):
        """Render the map from pose (R, t) and write color/depth/normal
        PNGs. Returns the file prefix."""
        dev = self.cam.R.device
        cam = self.cam.replace(
            R=torch.as_tensor(np.asarray(R, np.float32), device=dev),
            t=torch.as_tensor(np.asarray(t, np.float32), device=dev))
        with torch.no_grad():
            out = render(gm, cam, None, torch.zeros(3, device=dev),
                         pair_capacity=self.pair_capacity,
                         use_oracle=self.use_oracle, need_n_touched=False,
                         device=dev)
        color = np.transpose(out.color.cpu().numpy(), (1, 2, 0))
        depth = out.depth.cpu().numpy()[0]
        label = tag if tag is not None else f"{self.count:05d}"
        prefix = os.path.join(self.out_dir, label)
        save_png(color, prefix + "_color.png")
        save_png(colorize_depth(depth), prefix + "_depth.png")
        save_png(depth_to_normals(depth, self.cam.fx, self.cam.fy),
                 prefix + "_normal.png")
        self.count += 1
        return prefix

    def orbit(self, gm: GaussianMap, center: Optional[np.ndarray] = None,
              radius: Optional[float] = None, n_views: int = 8,
              tag: str = "orbit"):
        """Free-camera orbit around the map (the viewer's mouse-drag
        role): n_views poses looking at the map centroid."""
        xyz = gm.xyz[gm.active].detach().cpu().numpy()
        if xyz.size == 0:
            Log("orbit: empty map", tag="GUI")
            return
        if center is None:
            center = xyz.mean(axis=0)
        if radius is None:
            radius = float(np.percentile(
                np.linalg.norm(xyz - center, axis=1), 80)) + 1e-3
        for k in range(n_views):
            ang = 2 * np.pi * k / n_views
            # camera position on a circle in the x-z plane around center
            cpos = center + radius * np.array(
                [np.sin(ang), -0.2, np.cos(ang) - 1.0], np.float32)
            fwd = center - cpos
            fwd = fwd / np.linalg.norm(fwd)
            up = np.array([0, -1, 0], np.float32)
            if abs(float(np.dot(fwd, up))) > 0.9:   # looking along +-y
                up = np.array([1, 0, 0], np.float32)
            right = np.cross(up, fwd)
            right /= np.linalg.norm(right)
            up2 = np.cross(fwd, right)
            R_c2w = np.stack([right, up2, fwd], axis=1)
            R = R_c2w.T
            t = -R @ cpos
            self.snapshot(gm, R, t, tag=f"{tag}_{k:02d}")

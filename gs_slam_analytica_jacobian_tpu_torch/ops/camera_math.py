"""Camera projection math (torch port of ops/camera_math.py).

Plain row-major conventions: ``p_cam = W2C @ p_world`` and
``p_clip = P @ p_cam``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lie import pose_matrix


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def projection_matrix(
    znear: float, zfar: float, cx: float, cy: float, fx: float, fy: float,
    W: int, H: int,
) -> np.ndarray:
    """Intrinsics-aware OpenGL-style projection with principal point,
    row-major: p_clip = P @ [x_cam, 1]. Returned as float32 numpy (host
    math, like the reference)."""
    left = ((2 * cx - W) / W - 1.0) * W / 2.0
    right = ((2 * cx - W) / W + 1.0) * W / 2.0
    top = ((2 * cy - H) / H + 1.0) * H / 2.0
    bottom = ((2 * cy - H) / H - 1.0) * H / 2.0
    left = znear / fx * left
    right = znear / fx * right
    top = znear / fy * top
    bottom = znear / fy * bottom

    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> 4x4 W2C (R stored directly, not transposed)."""
    return pose_matrix(R, t)


def camera_center(w2c: torch.Tensor) -> torch.Tensor:
    """Camera position in world coords: c = -R^T t."""
    return -w2c[:3, :3].T @ w2c[:3, 3]

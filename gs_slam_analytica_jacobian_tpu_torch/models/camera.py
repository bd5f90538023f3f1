"""Camera and per-frame pose state (torch port of models/camera.py).

Frozen dataclasses holding tensors. R, t are world-to-camera, row-major
(p_cam = R @ p_world + t); intrinsics and image size are Python numbers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops import camera_math


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor                     # (3, 3) f32
    t: torch.Tensor                     # (3,)   f32
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tanfovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self) -> float:
        return self.height / (2.0 * self.fy)

    @property
    def fovx(self) -> float:
        return 2 * math.atan(self.tanfovx)

    @property
    def fovy(self) -> float:
        return 2 * math.atan(self.tanfovy)

    def w2c(self) -> torch.Tensor:
        return camera_math.world_to_view(self.R, self.t)

    def projection(self) -> torch.Tensor:
        return torch.as_tensor(
            camera_math.projection_matrix(
                self.znear, self.zfar, self.cx, self.cy, self.fx, self.fy,
                self.width, self.height),
            device=self.R.device)

    def center(self) -> torch.Tensor:
        return camera_math.camera_center(self.w2c())

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(R, t, fx: float, fy: float, cx: float, cy: float,
               width: int, height: int, znear: float = 0.01,
               zfar: float = 100.0, device=None) -> "Camera":
        """``device=None`` means CUDA (raises without a GPU)."""
        dev = resolve_device(device)
        return Camera(
            R=torch.tensor(np.asarray(R, np.float32), device=dev),
            t=torch.tensor(np.asarray(t, np.float32), device=dev),
            fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
            width=int(width), height=int(height), znear=float(znear),
            zfar=float(zfar))

    @staticmethod
    def from_w2c(w2c, fx, fy, cx, cy, width, height, **kw) -> "Camera":
        """A Camera from a 4x4 world-to-camera matrix (numpy); ``kw``
        (znear, zfar, device) goes to ``create``."""
        w2c = np.asarray(w2c)
        return Camera.create(w2c[:3, :3], w2c[:3, 3], fx, fy, cx, cy,
                             width, height, **kw)


@dataclasses.dataclass(frozen=True)
class PoseState:
    """se(3) delta tau = (rho, theta) applied as Exp(tau) @ T_base, and the
    affine exposure image_ab = exp(a) * image + b."""

    tau: torch.Tensor         # (6,)
    exposure_a: torch.Tensor  # ()
    exposure_b: torch.Tensor  # ()

    @staticmethod
    def zero(device=None, dtype=torch.float32) -> "PoseState":
        dev = resolve_device(device)
        return PoseState(tau=torch.zeros(6, dtype=dtype, device=dev),
                         exposure_a=torch.zeros((), dtype=dtype, device=dev),
                         exposure_b=torch.zeros((), dtype=dtype, device=dev))

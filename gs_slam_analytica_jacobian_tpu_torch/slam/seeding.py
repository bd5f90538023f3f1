"""Keyframe -> new Gaussians (torch port of slam/seeding.py): RGB-D
back-projection, a random 1/downsample keep, and the k-NN scale init.

The keep mask draws from a ``torch.Generator``, so its bits are not the
reference's; at ``downsample_factor`` 1 every valid pixel is kept in both
packages. The adaptive point size uses the median of the kept depths as
``jnp.nanmedian`` takes it: the mean of the two middle values of an even
count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.camera import Camera
from ..models.gaussian_map import ParamBlock, inverse_sigmoid
from ..ops import knn
from ..ops.losses import masked_median
from ..ops.sh import num_sh_coeffs, rgb_to_sh0


def backproject_depth(
    depth: torch.Tensor,     # (H, W)
    image: torch.Tensor,     # (3, H, W)
    cam: Camera,
    w2c: torch.Tensor,       # (4, 4)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pinhole unproject every pixel (integer coordinates) to the world.
    Returns (points (P, 3), colors (P, 3), valid (P,)), P = H*W, valid
    where the depth lies in (0, 100]."""
    H, W = depth.shape
    dev = depth.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    px, py = torch.meshgrid(xs, ys, indexing="xy")
    z = depth
    x = (px - cam.cx) / cam.fx * z
    y = (py - cam.cy) / cam.fy * z
    pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = (depth > 0).reshape(-1) & (depth <= 100.0).reshape(-1)
    c2w_R = w2c[:3, :3].T
    c2w_t = -c2w_R @ w2c[:3, 3]
    pts_w = pts_cam @ c2w_R.T + c2w_t
    cols = image.reshape(3, -1).T
    return pts_w, cols, valid


def seed_from_frame(
    image: torch.Tensor,       # (3, H, W)
    depth: torch.Tensor,       # (H, W)
    cam: Camera,
    w2c: torch.Tensor,
    kf_id: int,
    generator: Optional[torch.Generator],
    downsample_factor: float,
    point_size: float,
    adaptive_pointsize: bool,
    max_sh_degree: int,
    isotropic: bool = False,
    max_points: Optional[int] = None,
) -> ParamBlock:
    """A padded ParamBlock of new Gaussians for this keyframe: keep each
    valid pixel with probability 1/downsample_factor, point size
    min(0.05, point_size * median kept depth) when adaptive, scale
    log(sqrt(max(meanDist3NN, 1e-7) * point size)), opacity 0.5,
    identity rotation, DC-only color. The kept points come first, in
    pixel order, truncated to ``max_points`` (default max(2 P /
    downsample_factor, 1024))."""
    H, W = depth.shape
    P = H * W
    dev = depth.device
    if max_points is None:
        max_points = max(int(P / downsample_factor * 2), 1024)
    max_points = min(max_points, P)

    pts, cols, valid = backproject_depth(depth, image, cam, w2c)
    keep = torch.rand(P, generator=generator, device=dev) \
        < (1.0 / downsample_factor)
    valid = valid & keep

    if adaptive_pointsize:
        ps = torch.clamp(point_size * masked_median(
            depth.reshape(-1), valid, float("nan")), max=0.05)
    else:
        ps = torch.tensor(point_size, dtype=torch.float32, device=dev)

    order = torch.sort((~valid).to(torch.int8), stable=True).indices
    order = order[:max_points]
    pts_c, cols_c, valid_c = pts[order], cols[order], valid[order]

    dist2 = torch.clamp(knn.mean_sq_dist_3nn(pts_c, valid_c), min=1e-7) * ps
    scales = torch.log(torch.sqrt(dist2))[:, None].expand(max_points, 3)
    if isotropic:
        scales = scales[:, :1]

    n = max_points
    k_rest = num_sh_coeffs(max_sh_degree) - 1
    rot = torch.zeros(n, 4, dtype=torch.float32, device=dev)
    rot[:, 0] = 1.0
    return ParamBlock(
        xyz=pts_c.to(torch.float32),
        features_dc=rgb_to_sh0(cols_c).reshape(n, 1, 3).to(torch.float32),
        features_rest=torch.zeros(n, k_rest, 3, dtype=torch.float32,
                                  device=dev),
        scaling=scales.to(torch.float32).contiguous(),
        rotation=rot,
        opacity=torch.full((n, 1), float(inverse_sigmoid(torch.tensor(0.5))),
                           dtype=torch.float32, device=dev),
        kf_id=torch.full((n,), kf_id, dtype=torch.int32, device=dev),
        valid=valid_c,
    )

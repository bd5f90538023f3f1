"""Tracking losses, Scharr gradient masks and median depth (torch port of
the tracking part of ops/losses.py). Images are (C, H, W)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv2d_same_reflect(img: torch.Tensor, kernel: torch.Tensor
                         ) -> torch.Tensor:
    """Depthwise 3x3 cross-correlation with reflect padding. img: (C, H, W).
    (Runs in full f32: the package turns cuDNN TF32 off.)"""
    c = img.shape[0]
    p = F.pad(img[None], (1, 1, 1, 1), mode="reflect")
    k = kernel.to(img.dtype).expand(c, 1, 3, 3)
    return F.conv2d(p, k, groups=c)[0]


def image_gradient(image: torch.Tensor):
    """Scharr gradients (grad_v, grad_h), each (C, H, W), with the
    reference's output naming."""
    conv_y = torch.tensor([[3.0, 0, -3], [10, 0, -10], [3, 0, -3]],
                          device=image.device)
    conv_x = torch.tensor([[3.0, 10, 3], [0, 0, 0], [-3, -10, -3]],
                          device=image.device)
    normalizer = 1.0 / torch.sum(torch.abs(conv_y))
    grad_v = normalizer * _conv2d_same_reflect(image, conv_x)
    grad_h = normalizer * _conv2d_same_reflect(image, conv_y)
    return grad_v, grad_h


def image_gradient_mask(image: torch.Tensor, eps: float = 0.01):
    """3x3 all-valid mask of |img| > eps."""
    ones = torch.ones(3, 3, device=image.device)
    p = (torch.abs(image) > eps).to(image.dtype)
    s_v = _conv2d_same_reflect(p, ones)
    return s_v == 9.0, s_v == 9.0


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as jnp.median computes it: the midpoint
    of the two middle order statistics."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def compute_grad_mask(gray: torch.Tensor, edge_threshold: float,
                      dataset_type: str = "generic",
                      rows: int = 32, cols: int = 32) -> torch.Tensor:
    """Edge-intensity mask for tracking (reference camera_utils.py:115-144):
    per-32x32-block median binarization for 'replica', a global median
    threshold otherwise. gray: (1, H, W)."""
    gv, gh = image_gradient(gray)
    mv, mh = image_gradient_mask(gray)
    gv = gv * mv
    gh = gh * mh
    intensity = torch.sqrt(gv * gv + gh * gh)

    if dataset_type == "replica":
        _, H, W = intensity.shape
        bh, bw = H // rows, W // cols
        Hc, Wc = bh * rows, bw * cols
        blocks = intensity[0, :Hc, :Wc].reshape(rows, bh, cols, bw)
        med = _median_last(blocks.permute(0, 2, 1, 3).reshape(
            rows, cols, bh * bw))[:, None, :, None]
        out = (blocks > med * edge_threshold).to(intensity.dtype)
        full = intensity[0].clone()
        full[:Hc, :Wc] = out.reshape(Hc, Wc)
        # pixels outside the tiled region keep raw intensity
        return full[None]
    med = _median_last(intensity.reshape(-1))
    return (intensity > med * edge_threshold).to(intensity.dtype)


def apply_exposure(image: torch.Tensor, exposure_a, exposure_b
                   ) -> torch.Tensor:
    return torch.exp(exposure_a) * image + exposure_b


def loss_tracking_rgb(image, gt_image, opacity, grad_mask,
                      rgb_boundary_threshold: float):
    """Opacity-weighted masked L1. image: (3,H,W), opacity: (1,H,W),
    grad_mask: (1,H,W)."""
    rgb_mask = (torch.sum(gt_image, dim=0, keepdim=True)
                > rgb_boundary_threshold).to(image.dtype)
    mask = rgb_mask * grad_mask
    l1 = opacity * torch.abs(image * mask - gt_image * mask)
    return torch.mean(l1)


def loss_tracking_rgbd(image, depth, gt_image, gt_depth, opacity, grad_mask,
                       rgb_boundary_threshold: float, alpha: float = 0.95):
    """alpha * rgb + (1 - alpha) * depth, depth under an opacity > 0.95
    mask. depth/gt_depth: (1,H,W)."""
    l1_rgb = loss_tracking_rgb(image, gt_image, opacity, grad_mask,
                               rgb_boundary_threshold)
    depth_mask = ((gt_depth > 0.01) & (opacity > 0.95)).to(image.dtype)
    l1_depth = torch.abs(depth * depth_mask - gt_depth * depth_mask)
    return alpha * l1_rgb + (1 - alpha) * torch.mean(l1_depth)


def median_depth(depth, opacity=None, mask=None):
    """Median of valid rendered depth (+inf-padded sort)."""
    d = depth.reshape(-1)
    valid = d > 0
    if opacity is not None:
        valid = valid & (opacity.reshape(-1) > 0.95)
    if mask is not None:
        valid = valid & mask.reshape(-1)
    n = torch.sum(valid)
    s = torch.sort(torch.where(valid, d, torch.full_like(d, float("inf"))))
    s = s.values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (s[lo] + s[hi])
    return torch.where(n > 0, med, torch.zeros_like(med))

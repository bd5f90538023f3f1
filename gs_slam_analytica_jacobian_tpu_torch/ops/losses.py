"""Tracking and mapping losses, Scharr gradient masks, the edge-aware
depth regularizer, median depth and the L1 / PSNR / SSIM metrics (torch
port of ops/losses.py). Images are (C, H, W)."""

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


def depth_reg(depth: torch.Tensor, gt_image: torch.Tensor,
              huber_eps: float = 0.1, mask=None) -> torch.Tensor:
    """Edge-aware depth smoothness (reference slam_utils.py:41-53): the
    mean of |d depth| weighted by exp(-10 (d gray)^2) over the 3x3
    all-valid depth mask, v and h terms summed. ``huber_eps`` and
    ``mask`` are accepted and unused, as in the reference.
    depth: (1, H, W); gt_image: (C, H, W)."""
    del huber_eps, mask
    mask_v, mask_h = image_gradient_mask(depth)
    gray = torch.mean(gt_image, dim=0, keepdim=True)
    gray_grad_v, gray_grad_h = image_gradient(gray)
    depth_grad_v, depth_grad_h = image_gradient(depth)
    mv = mask_v.to(depth.dtype)
    mh = mask_h.to(depth.dtype)
    w_v = torch.exp(-10.0 * gray_grad_v ** 2)
    w_h = torch.exp(-10.0 * gray_grad_h ** 2)
    # the masked means (the reference boolean-indexes, then takes .mean())
    n_v = torch.clamp(torch.sum(mv), min=1.0)
    n_h = torch.clamp(torch.sum(mh), min=1.0)
    return (torch.sum(w_h * torch.abs(depth_grad_h) * mh) / n_h
            + torch.sum(w_v * torch.abs(depth_grad_v) * mv) / n_v)


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


def masked_median(x: torch.Tensor, valid: torch.Tensor,
                  empty: float = 0.0) -> torch.Tensor:
    """Median of x[valid] (1-D) as jnp.median and jnp.nanmedian take it,
    the mean of the two middle values of an even count, by an
    +inf-padded sort (no host sync); ``empty`` when nothing is valid."""
    n = torch.sum(valid)
    s = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))))
    s = s.values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (s[lo] + s[hi])
    return torch.where(n > 0, med, torch.full_like(med, empty))


def median_depth(depth, opacity=None, mask=None):
    """Median of valid rendered depth."""
    d = depth.reshape(-1)
    valid = d > 0
    if opacity is not None:
        valid = valid & (opacity.reshape(-1) > 0.95)
    if mask is not None:
        valid = valid & mask.reshape(-1)
    return masked_median(d, valid)


def loss_mapping_rgb(image, gt_image, rgb_boundary_threshold: float):
    rgb_mask = (torch.sum(gt_image, dim=0, keepdim=True)
                > rgb_boundary_threshold).to(image.dtype)
    return torch.mean(torch.abs(image * rgb_mask - gt_image * rgb_mask))


def loss_mapping_rgbd(image, depth, gt_image, gt_depth,
                      rgb_boundary_threshold: float, alpha: float = 0.95):
    rgb_mask = (torch.sum(gt_image, dim=0, keepdim=True)
                > rgb_boundary_threshold).to(image.dtype)
    depth_mask = (gt_depth > 0.01).to(image.dtype)
    l1_rgb = torch.abs(image * rgb_mask - gt_image * rgb_mask)
    l1_depth = torch.abs(depth * depth_mask - gt_depth * depth_mask)
    return alpha * torch.mean(l1_rgb) + (1 - alpha) * torch.mean(l1_depth)


def isotropic_loss(log_scaling: torch.Tensor, active: torch.Tensor):
    """|s - mean(s)| over active gaussians (the backend weighs it by 10).
    log_scaling: (C, 3)."""
    s = torch.exp(log_scaling)
    dev = torch.abs(s - torch.mean(s, dim=1, keepdim=True))
    w = active.to(s.dtype)[:, None]
    denom = torch.clamp(torch.sum(w) * 3.0, min=1.0)
    return torch.sum(dev * w) / denom


# ---------------------------------------------------------------------------
# Metrics: L1 / PSNR / SSIM
# ---------------------------------------------------------------------------

def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, size: int = 11):
    """Window-11 SSIM with zero padding, as the reference computes it.
    imgs: (C, H, W). (Full f32: the package turns cuDNN TF32 off.)"""
    c = img1.shape[0]
    k = _gaussian_window(size, device=img1.device).expand(c, 1, size, size)

    def conv(x):
        return F.conv2d(x[None], k, padding=size // 2, groups=c)[0]

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = conv(img1 * img1) - mu1_sq
    sigma2 = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1 + sigma2 + C2))
    return torch.mean(s)

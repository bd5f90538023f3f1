"""Per-Gaussian projection math: cov3D, EWA cov2D, screen projection
(torch port of ops/gaussian_math.py).

Differentiable by torch autograd in every Gaussian parameter and the
pose delta tau, which enters as ``w2c_eff = se3_exp(tau) @ w2c`` exactly
as in the reference. The reference's stop-gradients are mirrored: the
frustum clamp's clamped branch, ``campos`` in the SH view direction, and
the cull extents' ``q``, ``a`` and ``c``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import sh as sh_ops
from .lie import quat_to_rotmat, se3_exp

# Tile size of the reference's binning grid (config.h:16-17); the 16-px
# rect visibility test depends on it.
BLOCK_X = 16
BLOCK_Y = 16


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncation with XLA's saturating semantics (NaN -> 0,
    out-of-range values clamp), so rect coordinates of far-off-screen
    splats agree with the reference bit for bit. A plain ``.to(int32)``
    is undefined out of range."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2147483520.0,
                         neginf=-2147483648.0)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def build_cov3d(scale: torch.Tensor, quat: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = R S^2 R^T as (..., 6) upper triangle (xx, xy, xz, yy, yz,
    zz)."""
    R = quat_to_rotmat(quat)
    s = scale_modifier * scale
    M = R * s[..., None, :]
    Sigma = M @ M.transpose(-1, -2)
    return torch.stack(
        [Sigma[..., 0, 0], Sigma[..., 0, 1], Sigma[..., 0, 2],
         Sigma[..., 1, 1], Sigma[..., 1, 2], Sigma[..., 2, 2]], dim=-1)


def cov3d_to_matrix(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) upper triangle -> (..., 3, 3) symmetric."""
    c0, c1, c2, c3, c4, c5 = [cov6[..., i] for i in range(6)]
    return torch.stack(
        [torch.stack([c0, c1, c2], -1),
         torch.stack([c1, c3, c4], -1),
         torch.stack([c2, c4, c5], -1)], -2)


def clamp_view_point(p_view: torch.Tensor, tanfovx: float, tanfovy: float):
    """The EWA frustum clamp: x/y clamped to 1.3*tanfov * z (the clamped
    branch is a constant, as in the CUDA reference's backward)."""
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-8,
                          torch.full_like(tz, 1e-8), tz)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    rx = tx / tz_safe
    ry = ty / tz_safe
    clamped_x = (rx < -limx) | (rx > limx)
    clamped_y = (ry < -limy) | (ry > limy)
    tx_c = (torch.clamp(rx, -limx, limx) * tz).detach()
    ty_c = (torch.clamp(ry, -limy, limy) * tz).detach()
    tx_out = torch.where(clamped_x, tx_c, tx)
    ty_out = torch.where(clamped_y, ty_c, ty)
    return torch.stack([tx_out, ty_out, tz], dim=-1)


def compute_cov2d(p_view: torch.Tensor, cov6: torch.Tensor,
                  W_rot: torch.Tensor, fx: float, fy: float,
                  tanfovx: float, tanfovy: float, low_pass: float = 0.3):
    """EWA 2D covariance (reference forward.cu:76-115) with a configurable
    screen-space dilation ``low_pass`` (px^2). Returns (a, b, c)."""
    t = clamp_view_point(p_view, tanfovx, tanfovy)
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-8,
                          torch.full_like(tz, 1e-8), tz)
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z

    J00 = fx * inv_z
    J02 = -fx * tx * inv_z2
    J11 = fy * inv_z
    J12 = -fy * ty * inv_z2

    W0, W1, W2 = W_rot[0], W_rot[1], W_rot[2]
    T0 = J00[..., None] * W0 + J02[..., None] * W2
    T1 = J11[..., None] * W1 + J12[..., None] * W2

    V = cov3d_to_matrix(cov6)
    VT0 = torch.einsum("...ij,...j->...i", V, T0)
    VT1 = torch.einsum("...ij,...j->...i", V, T1)
    a = torch.sum(T0 * VT0, dim=-1) + low_pass
    b = torch.sum(T0 * VT1, dim=-1)
    c = torch.sum(T1 * VT1, dim=-1) + low_pass
    return a, b, c


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (N, ...))."""

    valid: torch.Tensor       # (N,) bool — frustum & det & non-empty rect
    depth: torch.Tensor       # (N,) camera-space z
    mean2d: torch.Tensor      # (N, 2) pixel coords
    conic: torch.Tensor       # (N, 3) inverse cov2d (a, b, c)
    cov2d: torch.Tensor       # (N, 3) cov2d (a, b, c) incl. low-pass
    opacity: torch.Tensor     # (N,)
    color: torch.Tensor       # (N, 3) clamped SH color
    radius: torch.Tensor      # (N,) float radius in pixels (ceil applied)
    radius_xy: torch.Tensor   # (N, 2) per-axis tight cull half-extents (px)
    rect_min: torch.Tensor    # (N, 2) int32 16-px tile coords (x, y)
    rect_max: torch.Tensor    # (N, 2) int32 16-px tile coords (exclusive)
    tiles_touched: torch.Tensor  # (N,) int32


def preprocess(
    means3d: torch.Tensor,
    cov6: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    sh_degree: int,
    w2c: torch.Tensor,
    proj: torch.Tensor,
    tau: torch.Tensor,
    fx: float, fy: float, width: int, height: int,
    tanfovx: float, tanfovy: float,
    mean2d_offset: Optional[torch.Tensor] = None,
    low_pass: float = 0.3,
) -> Preprocessed:
    """The rasterizer preprocess stage (forward.cu:157-401), vectorized.

    ``mean2d_offset`` is an all-zeros (N, 2) tensor whose gradient is the
    screen-space mean gradient (pixel units) that densification
    accumulates: the reference's ``screenspace_points`` trick."""
    dtype = means3d.dtype
    w2c_eff = se3_exp(tau.to(dtype)) @ w2c

    R_cw = w2c_eff[:3, :3]
    t_cw = w2c_eff[:3, 3]

    p_view = means3d @ R_cw.T + t_cw
    depth = p_view[..., 2]
    in_front = depth > 0.2

    ph = p_view @ proj[:3, :3].T + proj[:3, 3]
    pw_row = p_view @ proj[3, :3] + proj[3, 3]
    p_w = 1.0 / (pw_row + 1e-7)
    p_proj_x = ph[..., 0] * p_w
    p_proj_y = ph[..., 1] * p_w

    mean2d = torch.stack(
        [((p_proj_x + 1.0) * width - 1.0) * 0.5,
         ((p_proj_y + 1.0) * height - 1.0) * 0.5], dim=-1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    a, b, c = compute_cov2d(p_view, cov6, R_cw, fx, fy, tanfovx, tanfovy,
                            low_pass)

    det = a * c - b * b
    det_valid = det != 0.0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    det_inv = 1.0 / det_safe
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    # radius is a ceil, whose derivative is zero: computed off the graph,
    # so no sqrt backward at a zero argument (0 * inf) can reach a, b, c
    a_d, c_d = a.detach(), c.detach()
    mid = 0.5 * (a_d + c_d)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det.detach(), min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    # Tight per-axis cull half-extents (see the reference's note): pixels
    # outside them are alpha-rejected by the compositing kernel anyway.
    # q, a and c are stop-gradients as in the reference: at q = 0 (opacity
    # below 1/255) sqrt's backward would inject NaN.
    opa_d = opacities.detach()
    q = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * opa_d, min=1e-12)),
                    min=0.0)
    sg_a = torch.clamp(a_d, min=0.0)
    sg_c = torch.clamp(c_d, min=0.0)
    half_x = torch.minimum(radius, torch.ceil(torch.sqrt(q * sg_a)))
    half_y = torch.minimum(radius, torch.ceil(torch.sqrt(q * sg_c)))
    nonempty = q > 0.0

    grid_x = (width + BLOCK_X - 1) // BLOCK_X
    grid_y = (height + BLOCK_Y - 1) // BLOCK_Y
    mx = mean2d[..., 0]
    my = mean2d[..., 1]
    rect_min_x = torch.clamp(to_int32((mx - half_x) / BLOCK_X), 0, grid_x)
    rect_min_y = torch.clamp(to_int32((my - half_y) / BLOCK_Y), 0, grid_y)
    rect_max_x = torch.clamp(
        to_int32((mx + half_x + BLOCK_X - 1) / BLOCK_X), 0, grid_x)
    rect_max_y = torch.clamp(
        to_int32((my + half_y + BLOCK_Y - 1) / BLOCK_Y), 0, grid_y)
    tiles = torch.where(
        nonempty, (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y),
        torch.zeros_like(rect_max_x))

    valid = in_front & det_valid & (tiles > 0)

    campos = -(w2c_eff[:3, :3].T @ w2c_eff[:3, 3]).detach()
    campos_eff = campos + tau[:3].to(dtype)
    dirs = means3d - campos_eff
    norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
    dirs = dirs / norm
    color = sh_ops.sh_to_color(sh_degree, shs, dirs)

    zero = torch.zeros_like(radius)
    return Preprocessed(
        valid=valid,
        depth=depth,
        mean2d=mean2d,
        conic=conic,
        cov2d=torch.stack([a, b, c], dim=-1),
        opacity=opacities,
        color=color,
        radius=torch.where(valid, radius, zero),
        radius_xy=torch.where(valid[..., None],
                              torch.stack([half_x, half_y], dim=-1),
                              torch.zeros_like(mean2d)),
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        tiles_touched=torch.where(valid, tiles,
                                  torch.zeros_like(tiles)).to(torch.int32),
    )

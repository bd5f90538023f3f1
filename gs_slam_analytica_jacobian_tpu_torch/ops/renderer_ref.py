"""Reference-fidelity differentiable splat renderer: the dense oracle
(torch port of ops/renderer_ref.py).

An O(N x pixels) vectorized implementation of the reference's tile
rasterizer (cuda_rasterizer/forward.cu:406-535) whose torch autograd
gives the renderer's gradients, including the se(3) pose path. It is what
``use_oracle=True`` selects in the render API and the trackers, and the
gradient oracle the tiled renderer is held against.

Exact semantics carried over:
- global front-to-back depth order (a stable sort, invalid Gaussians at
  the back);
- a Gaussian touches a pixel only if the pixel's 16x16 cell lies in the
  Gaussian's rect;
- skip rules: power > 0, alpha < 1/255, alpha capped at 0.99;
- termination: the first Gaussian whose blend would push T below 1e-4 is
  dropped and everything behind it is skipped;
- color = sum(c_i alpha_i T_i) + T_final bg; depth likewise (no bg);
  opacity = 1 - T_final; n_touched counts pixels with test_T > 0.5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import require_on, resolve_device
from .gaussian_math import BLOCK_X, BLOCK_Y, Preprocessed, preprocess

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    color: torch.Tensor       # (3, H, W)
    depth: torch.Tensor       # (1, H, W)
    opacity: torch.Tensor     # (1, H, W)
    final_T: torch.Tensor     # (H, W)
    radii: torch.Tensor       # (N,) float (0 for culled)
    n_touched: torch.Tensor   # (N,) int32
    mean2d: torch.Tensor      # (N, 2) pixel coords
    overflow: torch.Tensor = None  # pairs dropped by the tiled binner
                                   # (0 / None = exact render)


def _composite_rows(pix_xy, tile_xy, prep_sorted, bg):
    """Composite P pixels against all N sorted Gaussians. pix_xy (P, 2)
    pixel coordinates, tile_xy (P, 2) int32 16-px cells."""
    (mean2d, conic, opacity, color, depth, rect_min, rect_max,
     valid) = prep_sorted

    d = pix_xy[:, None, :] - mean2d[None, :, :]               # (P, N, 2)
    dx, dy = d[..., 0], d[..., 1]
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    power = (-0.5 * (ca[None] * dx * dx + cc[None] * dy * dy)
             - cb[None] * dx * dy)

    tile_ok = ((tile_xy[:, None, 0] >= rect_min[None, :, 0])
               & (tile_xy[:, None, 0] < rect_max[None, :, 0])
               & (tile_xy[:, None, 1] >= rect_min[None, :, 1])
               & (tile_xy[:, None, 1] < rect_max[None, :, 1]))

    alpha = torch.clamp(opacity[None, :] * torch.exp(power), max=ALPHA_MAX)
    ok = valid[None, :] & tile_ok & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha_eff = torch.where(ok, alpha, torch.zeros_like(alpha))  # (P, N)

    one_minus = 1.0 - alpha_eff
    # T_excl[i] = prod_{j<i} (1 - alpha_eff[j]) by a shifted cumprod
    T_incl = torch.cumprod(one_minus, dim=1)
    T_excl = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]],
                       dim=1)
    T_incl = T_excl * one_minus

    would_term = ok & (T_incl < T_EPS)
    cut = torch.cumsum(would_term.to(torch.int32), dim=1) > 0  # inclusive
    include = ok & ~cut

    w = torch.where(include, alpha * T_excl, torch.zeros_like(alpha))
    final_T = torch.prod(torch.where(include, 1.0 - alpha,
                                     torch.ones_like(alpha)), dim=1)

    out_color = w @ color + final_T[:, None] * bg[None, :]    # (P, 3)
    out_depth = w @ depth[:, None]                            # (P, 1)
    touched = (include & (T_incl > 0.5)).to(torch.int32)
    return out_color, out_depth[:, 0], 1.0 - final_T, final_T, \
        touched.sum(dim=0)


def render_from_preprocessed(prep: Preprocessed, width: int, height: int,
                             bg: torch.Tensor, row_chunk: int = 16
                             ) -> RenderOutput:
    """Depth-sort + per-pixel compositing over chunks of ``row_chunk``
    image rows. Differentiable."""
    dev = prep.mean2d.device
    key = torch.where(prep.valid, prep.depth,
                      torch.full_like(prep.depth, float("inf")))
    order = torch.sort(key, stable=True).indices

    prep_sorted = (prep.mean2d[order], prep.conic[order],
                   prep.opacity[order], prep.color[order],
                   prep.depth[order], prep.rect_min[order],
                   prep.rect_max[order], prep.valid[order])

    dt = prep.mean2d.dtype
    ys = torch.arange(height, dtype=dt, device=dev)
    xs = torch.arange(width, dtype=dt, device=dev)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")      # (H, W)
    pix = torch.stack([pix_x, pix_y], dim=-1).reshape(-1, 2)
    tiles = torch.stack([(pix_x / BLOCK_X).to(torch.int32),
                         (pix_y / BLOCK_Y).to(torch.int32)],
                        dim=-1).reshape(-1, 2)

    parts = []
    step = row_chunk * width
    for s in range(0, height * width, step):
        parts.append(_composite_rows(pix[s:s + step], tiles[s:s + step],
                                     prep_sorted, bg))
    color, depth, opac, final_T, touched = zip(*parts)
    n_touched_sorted = torch.stack(touched).sum(dim=0)
    n_touched = torch.empty_like(n_touched_sorted)
    n_touched[order] = n_touched_sorted

    return RenderOutput(
        color=torch.cat(color).reshape(height, width, 3).permute(2, 0, 1),
        depth=torch.cat(depth).reshape(1, height, width),
        opacity=torch.cat(opac).reshape(1, height, width),
        final_T=torch.cat(final_T).reshape(height, width),
        radii=prep.radius,
        n_touched=n_touched.to(torch.int32),
        mean2d=prep.mean2d,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def render(
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
    bg: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    row_chunk: int = 16,
    device=None,
) -> RenderOutput:
    """Full oracle render (preprocess + composite), differentiable in every
    Gaussian parameter, tau and ``mean2d_offset``. ``device=None`` means
    CUDA (raises without a GPU); every tensor argument must already lie on
    that device."""
    dev = resolve_device(device)
    require_on(dev, means3d=means3d, cov6=cov6, opacities=opacities,
               shs=shs, w2c=w2c, proj=proj, tau=tau, bg=bg, active=active,
               mean2d_offset=mean2d_offset)
    prep = preprocess(means3d, cov6, opacities, shs, sh_degree, w2c, proj,
                      tau, fx, fy, width, height, tanfovx, tanfovy,
                      mean2d_offset=mean2d_offset)
    if active is not None:
        prep = prep._replace(
            valid=prep.valid & active,
            radius=torch.where(active, prep.radius,
                               torch.zeros_like(prep.radius)),
            tiles_touched=torch.where(active, prep.tiles_touched,
                                      torch.zeros_like(prep.tiles_touched)))
    return render_from_preprocessed(prep, width, height, bg, row_chunk)

"""Tiled renderer, forward (torch port of ops/renderer_tiled.py):
preprocess -> pair plan -> packed gather -> 32x32 compositing kernel.

On CUDA tensors the compositing runs the hand-written kernel
(ops/tile_kernel2.py); on CPU tensors its plain PyTorch version. The
renderer's backward (the reference's custom VJPs) is not ported yet, so
``render`` runs without autograd.

Flags of the reference that are not ported yet — ``tile16`` (16x16
kernels), ``bf16`` and ``mxu`` (kernel variants) — raise
NotImplementedError instead of being ignored.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import require_on, resolve_device
from .binning2 import FEAT_DIM, PairPlan, plan_pairs
from .gaussian_math import Preprocessed, preprocess
from .pair_gather import pair_gather, segment_reduce_pairs
from .tile_kernel2 import TPX, TPY, K, composite32, grid_dims


class RenderOutput(NamedTuple):
    """Mirror of the reference's RenderOutput (ops/renderer_ref.py)."""

    color: torch.Tensor       # (3, H, W)
    depth: torch.Tensor       # (1, H, W)
    opacity: torch.Tensor     # (1, H, W)
    final_T: torch.Tensor     # (H, W)
    radii: torch.Tensor       # (N,) float (0 for culled)
    n_touched: torch.Tensor   # (N,) int32
    mean2d: torch.Tensor      # (N, 2) pixel coords
    overflow: torch.Tensor = None  # pairs dropped by the binner


def _not_ported(**flags):
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"{name}=True is not ported yet: the 16x16 kernels (tile16) "
                "and the bf16/MXU kernel variants come in a later slice of "
                "the port")


def pack_table(prep: Preprocessed) -> torch.Tensor:
    """(N, 16) per-gaussian feature rows for the pair gather:
    [mean2d(2), conic(3), opacity, color(3), depth, rect16(4), pad(2)]."""
    n = prep.depth.shape[0]
    dt = prep.mean2d.dtype
    rect = torch.cat([prep.rect_min.to(dt), prep.rect_max.to(dt)], dim=-1)
    return torch.cat([
        prep.mean2d,
        prep.conic,
        prep.opacity[:, None],
        prep.color,
        prep.depth[:, None],
        rect,
        torch.zeros(n, FEAT_DIM - 14, dtype=dt, device=prep.depth.device),
    ], dim=-1)


def make_plan(
    prep: Preprocessed,
    width: int, height: int,
    pair_capacity: int,
    active: Optional[torch.Tensor] = None,
    radius_scale: float = 1.0,
    radius_pad: float = 0.0,
    tile16: bool = False,
    opa_growth: float = 1.0,
) -> PairPlan:
    """Bin Gaussians into a reusable 32x32 PairPlan."""
    _not_ported(tile16=tile16)
    if active is not None:
        prep = prep._replace(valid=prep.valid & active)
    n_tx, n_ty = grid_dims(width, height)
    return plan_pairs(prep, TPX, TPY, n_tx, n_ty, pair_capacity, chunk=K,
                      radius_scale=radius_scale, radius_pad=radius_pad,
                      opa_growth=opa_growth)


@torch.no_grad()
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
    pair_capacity: int = 1 << 19,
    plan: Optional[PairPlan] = None,
    need_n_touched: bool = True,
    bf16: bool = False,
    tile16: bool = False,
    nt_weight: bool = False,
    mxu: bool = False,
    low_pass: float = 0.3,
    device=None,
) -> RenderOutput:
    """Forward render. ``device=None`` means CUDA (raises without a GPU);
    every tensor argument must already lie on that device."""
    _not_ported(tile16=tile16, bf16=bf16, mxu=mxu)
    dev = resolve_device(device)
    require_on(dev, means3d=means3d, cov6=cov6, opacities=opacities,
               shs=shs, w2c=w2c, proj=proj, tau=tau, bg=bg, active=active)
    prep = preprocess(
        means3d, cov6, opacities, shs, sh_degree, w2c, proj, tau,
        fx, fy, width, height, tanfovx, tanfovy, low_pass=low_pass)
    if active is not None:
        prep = prep._replace(
            valid=prep.valid & active,
            radius=torch.where(active, prep.radius,
                               torch.zeros_like(prep.radius)),
            tiles_touched=torch.where(active, prep.tiles_touched,
                                      torch.zeros_like(prep.tiles_touched)))

    n_tx, n_ty = grid_dims(width, height)
    if plan is None:
        plan = plan_pairs(prep, TPX, TPY, n_tx, n_ty, pair_capacity, chunk=K)
    feat = pair_gather(pack_table(prep), plan)
    out = composite32(feat, plan.ranges, n_tx, n_ty, width, height,
                      need_n_touched, nt_weight)

    color = out.color_sum + out.final_T[None] * bg[:, None, None]
    opacity = 1.0 - out.final_T

    if need_n_touched:
        nt = segment_reduce_pairs(out.n_touched_pairs, plan).to(torch.int32)
    else:
        nt = torch.zeros(means3d.shape[0], dtype=torch.int32, device=dev)

    return RenderOutput(
        color=color,
        depth=out.depth_sum[None],
        opacity=opacity[None],
        final_T=out.final_T,
        radii=prep.radius,
        n_touched=nt,
        mean2d=prep.mean2d,
        overflow=plan.overflow,
    )

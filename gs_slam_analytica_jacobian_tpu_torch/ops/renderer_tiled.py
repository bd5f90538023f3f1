"""Tiled renderer (torch port of ops/renderer_tiled.py): preprocess ->
pair plan -> packed gather -> 32x32 compositing kernel, or under
``tile16`` a 16-px plan and the 16x16 kernels.

``render`` is differentiable in every Gaussian parameter and the pose
delta tau: torch autograd supplies the preprocess backward, the gather's
backward is the per-gaussian segment sum (ops/pair_gather.py) and the
compositing's is the backward kernel (ops/tile_kernel2.py,
ops/tile_kernel16.py). ``render_prepared`` is everything after the
preprocess, from a ``Preprocessed`` and its packed table: the path
``slam/render_api.py`` takes with the fused preprocess
(ops/preprocess_fused.py), which starts from the map. The plan is
non-differentiable structure, reusable across iterations (``plan=``).
On CUDA tensors the gather and the compositing run the hand-written
kernels; on CPU tensors their plain PyTorch versions. ``ops/renderer_ref.py`` is the
oracle it is tested against.

``bf16`` runs the 32x32 kernels' bfloat16 bodies and ``mxu`` their MXU
bodies (forward and backward; in the forward mxu takes precedence). The
16x16 kernels have neither: ``bf16`` or ``mxu`` beside ``tile16`` raises
NotImplementedError (the reference's tile16 branch silently drops both
flags).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import require_on, resolve_device
from .binning2 import FEAT_DIM, PairPlan, plan_pairs
from .gaussian_math import Preprocessed, preprocess
from .pair_gather import pair_gather, segment_reduce_pairs
from .renderer_ref import RenderOutput
from .tile_kernel2 import TPX, TPY, K, composite32, grid_dims
from .tile_kernel16 import TS, K16, composite16, grid_dims16


def _not_ported(mxu: bool, bf16: bool, tile16: bool):
    if tile16 and (bf16 or mxu):
        raise NotImplementedError(
            "bf16 or mxu beside tile16: the 16x16 kernels have no bfloat16 "
            "or MXU bodies (the reference's tile16 branch drops the flags)")


def pack_table(prep: Preprocessed) -> torch.Tensor:
    """(N, 16) per-gaussian feature rows for the pair gather:
    [mean2d(2), conic(3), opacity, color(3), depth, rect16(4), pad(2)].
    The rect rides along without gradient so the kernel's per-pixel rect
    test uses the current means even under a reused plan."""
    n = prep.depth.shape[0]
    dt = prep.mean2d.dtype
    rect = torch.cat([prep.rect_min.to(dt), prep.rect_max.to(dt)],
                     dim=-1).detach()
    return torch.cat([
        prep.mean2d,
        prep.conic,
        prep.opacity[:, None],
        prep.color,
        prep.depth[:, None],
        rect,
        torch.zeros(n, FEAT_DIM - 14, dtype=dt, device=prep.depth.device),
    ], dim=-1)


def mask_active(prep: Preprocessed, active: torch.Tensor) -> Preprocessed:
    """Only ``active`` rows render: valid, radius and tiles_touched
    masked."""
    return prep._replace(
        valid=prep.valid & active,
        radius=torch.where(active, prep.radius,
                           torch.zeros_like(prep.radius)),
        tiles_touched=torch.where(active, prep.tiles_touched,
                                  torch.zeros_like(prep.tiles_touched)))


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
    """Bin Gaussians into a reusable PairPlan: 32x32 tiles, or under
    ``tile16`` 16x16 tiles on the 2*ceil(W/32) x 2*ceil(H/32) grid (one
    tile column or row more than ceil(W/16) where W mod 32 is in (0, 16])
    with chunk K16, as the 16x16 kernels walk it."""
    if active is not None:
        prep = prep._replace(valid=prep.valid & active)
    if tile16:
        n_gx, n_gy = grid_dims16(width, height)
        return plan_pairs(prep, TS, TS, 2 * n_gx, 2 * n_gy, pair_capacity,
                          chunk=K16, radius_scale=radius_scale,
                          radius_pad=radius_pad, opa_growth=opa_growth)
    n_tx, n_ty = grid_dims(width, height)
    return plan_pairs(prep, TPX, TPY, n_tx, n_ty, pair_capacity, chunk=K,
                      radius_scale=radius_scale, radius_pad=radius_pad,
                      opa_growth=opa_growth)


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
    """Render, differentiable in means3d, cov6, opacities, shs, tau and
    ``mean2d_offset`` (an all-zeros (N, 2) tensor whose gradient is the
    screen-space mean gradient densification reads). ``device=None``
    means CUDA (raises without a GPU); every tensor argument must already
    lie on that device."""
    dev = resolve_device(device)
    require_on(dev, means3d=means3d, cov6=cov6, opacities=opacities,
               shs=shs, w2c=w2c, proj=proj, tau=tau, bg=bg, active=active,
               mean2d_offset=mean2d_offset)
    prep = preprocess(
        means3d, cov6, opacities, shs, sh_degree, w2c, proj, tau,
        fx, fy, width, height, tanfovx, tanfovy,
        mean2d_offset=mean2d_offset, low_pass=low_pass)
    if active is not None:
        prep = mask_active(prep, active)
    return render_prepared(prep, pack_table(prep), width, height, bg,
                           pair_capacity, plan, need_n_touched, bf16,
                           tile16, nt_weight, mxu)


def render_prepared(
    prep: Preprocessed,
    table: torch.Tensor,
    width: int, height: int,
    bg: torch.Tensor,
    pair_capacity: int = 1 << 19,
    plan: Optional[PairPlan] = None,
    need_n_touched: bool = True,
    bf16: bool = False,
    tile16: bool = False,
    nt_weight: bool = False,
    mxu: bool = False,
) -> RenderOutput:
    """``render`` after the preprocess: plan (unless given), gather the
    packed ``table`` (N, 16), composite, add the background. ``prep``'s
    active mask is already applied."""
    _not_ported(mxu=mxu, bf16=bf16, tile16=tile16)
    if plan is None:
        plan = make_plan(prep, width, height, pair_capacity, tile16=tile16)
    feat = pair_gather(table, plan)
    if tile16:
        n_gx, n_gy = grid_dims16(width, height)
        out = composite16(feat, plan.ranges, n_gx, n_gy, width, height,
                          need_n_touched, nt_weight)
    else:
        n_tx, n_ty = grid_dims(width, height)
        out = composite32(feat, plan.ranges, n_tx, n_ty, width, height,
                          need_n_touched, nt_weight, bf16, mxu)

    color = out.color_sum + out.final_T[None] * bg[:, None, None]
    opacity = 1.0 - out.final_T

    if need_n_touched:
        nt = segment_reduce_pairs(out.n_touched_pairs, plan).to(torch.int32)
    else:
        nt = torch.zeros(table.shape[0], dtype=torch.int32,
                         device=table.device)

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

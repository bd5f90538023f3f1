"""16x16 alpha compositing, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions and the differentiable
``composite16`` (counterpart of ops/pallas/tile_kernel16.py).

The forward kernel (``csrc/tile16_fwd_subtile.cu``) replaces the Pallas
TPU kernel ``make_forward_kernel16`` in both of its call forms:

- ``composite16_fwd`` (B3') — without per-pair n_touched (``_fwd_impl16``
  ``with_ntouch=False``, pallas_call at tile_kernel16.py:582): every
  mapping and color-refinement render under ``tile16``;
- ``composite16_fwd_ntouch`` (B3) — with per-pair n_touched, optionally
  under the blend-weight rule ``nt_weight`` (pallas_call at :562): the
  window-visibility renders.

It is the 32x32 forward's sub-tile body (``csrc/subtile_fwd.cuh``) on a
16x16 tile: an 8x4 pixel block per warp, the rect16 compaction and the
conservative block test of ``csrc/subtile_cull.cuh``, bulk asynchronous
staging, n_touched stored once per pair without atomics (a 16-px pair
belongs to one tile); ``plain_walk(tile=16, cull=True)`` walks only the
cells it keeps and ``subtile_cells(tile=16)`` counts them.

The backward kernel (``csrc/tile16_bwd_subtile.cu``, wrapper
``composite16_bwd``, B4) replaces ``make_backward_kernel16``
(``_bwd_impl16``, pallas_call at :622): per-pair gradient rows
``[d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_rgb(3), d_depth, 0 x 6]``. It
runs the 32x32 backward's sub-tile design on a 16x16 tile (an 8x4 pixel
block per warp, the conservative block test of ``csrc/subtile_cull.cuh``,
bulk asynchronous staging, no cluster: a 16-px pair belongs to one tile);
``plain_bwd_walk(tile=16, cull=True)`` walks only the cells it keeps and
``subtile_cells(tile=16)`` counts them.

They compute what the 32x32 kernels compute (the per-pixel semantics of
ops/tile_kernel2.py) on the 16-px plan: tile t = ty * (2 n_gx) + tx of
the 2*ceil(W/32) x 2*ceil(H/32) grid walks the pairs ranges[t]. The TPU
kernel's 2x2 subtile groups, DMA ring, scans, block-permuted image and its
chunk-counter channel have no counterpart: one CTA per 16x16 tile writes
(C, H, W) planes directly. The plain versions are ops/tile_kernel2.py's
``plain_walk`` / ``plain_bwd_walk`` at ``tile=16``, used only on CPU
tensors and as the kernels' oracle on the card.
"""

from __future__ import annotations

import torch

from .tile_kernel2 import (Composite2Out, CompositeFn, _check, _check_planes,
                           launch_bwd, launch_fwd, plain_bwd_walk,
                           plain_walk)

TS = 16           # tile edge in pixels
K16 = 128         # pair rows per chunk (the plan's range alignment)


def grid_dims16(width: int, height: int):
    """(n_gx, n_gy) 32x32 groups; the 16-px tile grid is (2 n_gx, 2 n_gy),
    which can hold one column or row of tiles more than ceil(W/16)."""
    return (width + 31) // 32, (height + 31) // 32


def composite16_plain(feat, ranges, n_gx, n_gy, W, H, with_ntouch=True,
                      nt_weight=False) -> Composite2Out:
    """Plain PyTorch version of the forward kernel (any device)."""
    return plain_walk(feat, ranges, 2 * n_gx, 2 * n_gy, W, H, with_ntouch,
                      nt_weight, tile=TS)[0]


def composite16_bwd_plain(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, n_gx, n_gy, W, H
                          ) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (any device)."""
    return plain_bwd_walk(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, 2 * n_gx, 2 * n_gy, W, H,
                          tile=TS)[0]


def composite16_fwd(feat: torch.Tensor, ranges: torch.Tensor, n_gx: int,
                    n_gy: int, W: int, H: int) -> Composite2Out:
    """B3': forward compositing without per-pair n_touched (zeros)."""
    _check(feat, ranges, 2 * n_gx, 2 * n_gy)
    if feat.device.type == "cpu":
        return composite16_plain(feat, ranges, n_gx, n_gy, W, H,
                                 with_ntouch=False)
    out = launch_fwd("tile16_fwd_subtile", feat, ranges, 2 * n_gx,
                     2 * n_gy, W, H, False, False, "composite16_fwd")
    composite16_fwd.launches += 1
    return out


composite16_fwd.launches = 0


def composite16_fwd_ntouch(feat: torch.Tensor, ranges: torch.Tensor,
                           n_gx: int, n_gy: int, W: int, H: int,
                           nt_weight: bool = False) -> Composite2Out:
    """B3: forward compositing with per-pair n_touched (T_incl > 0.5, or
    alpha*T >= 1/255 under ``nt_weight``)."""
    _check(feat, ranges, 2 * n_gx, 2 * n_gy)
    if feat.device.type == "cpu":
        return composite16_plain(feat, ranges, n_gx, n_gy, W, H,
                                 with_ntouch=True, nt_weight=nt_weight)
    out = launch_fwd("tile16_fwd_subtile", feat, ranges, 2 * n_gx,
                     2 * n_gy, W, H, True, nt_weight, "composite16_fwd")
    composite16_fwd_ntouch.launches += 1
    return out


composite16_fwd_ntouch.launches = 0


def composite16_bwd(feat: torch.Tensor, ranges: torch.Tensor,
                    color_sum: torch.Tensor, depth_sum: torch.Tensor,
                    final_T: torch.Tensor, d_color: torch.Tensor,
                    d_depth: torch.Tensor, d_T: torch.Tensor, n_gx: int,
                    n_gy: int, W: int, H: int) -> torch.Tensor:
    """B4: per-pair gradient rows (B_al, 16) from the forward's planes and
    their cotangents, as ``composite32_bwd`` on the 16-px plan."""
    _check(feat, ranges, 2 * n_gx, 2 * n_gy)
    _check_planes(feat, W, H, color_sum=color_sum, depth_sum=depth_sum,
                  final_T=final_T, d_color=d_color, d_depth=d_depth, d_T=d_T)
    if feat.device.type == "cpu":
        return composite16_bwd_plain(feat, ranges, color_sum, depth_sum,
                                     final_T, d_color, d_depth, d_T, n_gx,
                                     n_gy, W, H)
    dfeat = launch_bwd("tile16_bwd_subtile", feat, ranges, color_sum,
                       depth_sum, final_T, d_color, d_depth, d_T, 2 * n_gx,
                       2 * n_gy, W, H, "composite16_bwd")
    composite16_bwd.launches += 1
    return dfeat


composite16_bwd.launches = 0


def composite16(feat, ranges, n_gx, n_gy, W, H, with_ntouch=True,
                nt_weight=False) -> Composite2Out:
    """Differentiable 16x16 compositing (the reference's ``composite16``):
    feat (B_al, 16) pair rows of a 16-px plan, ranges (4 n_gx n_gy, 2).
    ``with_ntouch=False`` returns zero n_touched."""
    return Composite2Out(*CompositeFn.apply(
        feat, ranges, n_gx, n_gy, W, H, with_ntouch, nt_weight,
        (composite16_fwd, composite16_fwd_ntouch, composite16_bwd)))

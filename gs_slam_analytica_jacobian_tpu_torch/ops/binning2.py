"""Tile binning (torch port of ops/binning2.py).

Expands visible Gaussians into depth-sorted, tile-grouped pair slots with
the reference's static-shape layout: B_al = capacity + n_tiles * chunk,
and each tile's run starts at a multiple of ``chunk`` (the compositing
kernel stages whole chunks that never cross tiles). The plan is separate
from the per-render feature gather so tracking can bin once and reuse it.

Same algorithm as the reference: emission-slot -> gaussian mapping by
scatter-max + cummax, the per-(gaussian, tile) conic cull with its
``opa_growth`` budget, one packed int32 [tile | depth-bits] sort key, and
chunk-aligned relocation by a delta scatter + cumsum. The sort is stable
(emission order breaks ties). XLA's ``mode="drop"`` scatters have no
torch counterpart: here the dropped index lands in one spare slot past
the end, which is cut off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gaussian_math import Preprocessed, to_int32

FEAT_DIM = 16


class PairPlan(NamedTuple):
    """Static-shape pair plan, reusable across render iterations.

    B_al = capacity + n_tiles * chunk (aligned buffer size)."""

    pair_gid1: torch.Tensor     # (B_al,) int32 gaussian index + 1; 0 = dead
    ranges: torch.Tensor        # (n_tiles, 2) int32 [start, end), start%K==0
    aligned_of_em: torch.Tensor  # (capacity,) int32 emission -> aligned pos
                                 # (== B_al for dropped slots)
    seg_start: torch.Tensor     # (N,) int32 emission segment start
    seg_end: torch.Tensor       # (N,) int32 emission segment end (exclusive)
    num_pairs: torch.Tensor     # () int32 pairs emitted (<= capacity)
    overflow: torch.Tensor      # () int32 pairs dropped for lack of capacity
    num_kept: torch.Tensor      # () int32 pairs surviving the conic cull


def _rect(mean2d, rx, ry, tile_w, tile_h, n_tx, n_ty):
    """Coarse rect in tile units (getRect, auxiliary.h:46-56)."""
    mx = mean2d[:, 0]
    my = mean2d[:, 1]
    x0 = torch.clamp(to_int32((mx - rx) / tile_w), 0, n_tx)
    y0 = torch.clamp(to_int32((my - ry) / tile_h), 0, n_ty)
    x1 = torch.clamp(to_int32((mx + rx + tile_w - 1) / tile_w), 0, n_tx)
    y1 = torch.clamp(to_int32((my + ry + tile_h - 1) / tile_h), 0, n_ty)
    return x0, y0, x1, y1


def _scatter_max(size, pos, val):
    """zeros(size).at[pos].max(val, mode="drop") for int32 data and
    0 <= pos <= size: index ``size`` lands in a spare slot that is cut
    off (no boolean mask, so no host sync)."""
    out = torch.zeros(size + 1, dtype=torch.int32, device=pos.device)
    return out.scatter_reduce(0, pos.long(), val, reduce="amax",
                              include_self=True)[:size]


@torch.no_grad()
def plan_pairs(
    prep: Preprocessed,
    tile_w: int, tile_h: int, n_tx: int, n_ty: int,
    capacity: int,
    chunk: int = 128,
    radius_scale: float = 1.0,
    radius_pad: float = 0.0,
    conic_cull: bool = True,
    opa_growth: float = 1.0,
) -> PairPlan:
    """Expand valid Gaussians into depth-sorted, tile-grouped pair slots.

    ``conic_cull`` drops a (gaussian, tile) pair when the splat's peak
    alpha over the tile's pixel box (inflated by ``radius_pad``) is under
    the kernel's 1/255 skip threshold, so it would contribute exactly
    zero; ``opa_growth`` budgets opacity drift under plan reuse."""
    dev = prep.depth.device
    i32 = torch.int32
    f32 = torch.float32
    n = prep.depth.shape[0]
    n_tiles = n_tx * n_ty
    B_al = capacity + n_tiles * chunk

    alive = (prep.valid & (prep.radius_xy[:, 0] > 0.0)
             & (prep.radius_xy[:, 1] > 0.0))
    zero = torch.zeros_like(prep.depth)
    rx = torch.where(alive, prep.radius_xy[:, 0] * radius_scale + radius_pad,
                     zero)
    ry = torch.where(alive, prep.radius_xy[:, 1] * radius_scale + radius_pad,
                     zero)
    x0, y0, x1, y1 = _rect(prep.mean2d, rx, ry, tile_w, tile_h, n_tx, n_ty)
    w = x1 - x0
    counts = torch.where(alive, w * (y1 - y0),
                         torch.zeros_like(w)).to(i32)

    offs = torch.cumsum(counts, 0).to(i32)         # inclusive (N,)
    total = offs[-1]
    starts = offs - counts
    num_pairs = torch.clamp(total, max=capacity)
    overflow = torch.clamp(total - capacity, min=0)

    # emission slot p -> owning gaussian via scatter-max + cummax (only
    # gaussians with counts > 0 scatter; their starts are distinct)
    g_idx = torch.arange(n, dtype=i32, device=dev)
    pos = torch.where((counts > 0) & (starts < capacity), starts,
                      torch.full_like(starts, capacity))
    gmark = _scatter_max(capacity, pos, g_idx + 1)
    gid = torch.clamp(torch.cummax(gmark, 0).values - 1, min=0)
    smark = _scatter_max(capacity, pos, starts + 1)
    start_of_p = torch.clamp(torch.cummax(smark, 0).values - 1, min=0)

    p_idx = torch.arange(capacity, dtype=i32, device=dev)
    local = p_idx - start_of_p
    pair_ok = p_idx < num_pairs

    # one packed gather for per-pair gaussian data
    cols = [x0.to(f32), y0.to(f32), torch.clamp(w, min=1).to(f32),
            prep.depth]
    if conic_cull:
        cols += [prep.mean2d[:, 0], prep.mean2d[:, 1],
                 prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
                 prep.opacity]
    btab = torch.stack(cols, dim=1)
    bt = btab[gid.long()]
    wg = bt[:, 2].to(i32)
    tx = bt[:, 0].to(i32) + torch.remainder(local, wg)
    ty = bt[:, 1].to(i32) + torch.div(local, wg, rounding_mode="floor")
    dead_tile = torch.full_like(tx, n_tiles)
    tile_id = torch.where(pair_ok, ty * n_tx + tx, dead_tile)

    if conic_cull:
        mx, my = bt[:, 4], bt[:, 5]
        ca = torch.clamp(bt[:, 6], min=1e-12)
        cb = bt[:, 7]
        cc = torch.clamp(bt[:, 8], min=1e-12)
        opa = bt[:, 9]
        # pixel box of the tile, inflated by the pose-drift pad
        pad = radius_pad
        dxlo = (tx * tile_w).to(f32) - pad - mx
        dxhi = (tx * tile_w + (tile_w - 1)).to(f32) + pad - mx
        dylo = (ty * tile_h).to(f32) - pad - my
        dyhi = (ty * tile_h + (tile_h - 1)).to(f32) + pad - my
        inside = (dxlo <= 0.0) & (0.0 <= dxhi) & (dylo <= 0.0) & (0.0 <= dyhi)

        # exact min of Q(d) = a dx^2 + 2 b dx dy + c dy^2 over the box:
        # 0 if the mean is inside, else the min over the four edges
        def q_edge_x(ex):
            yy = torch.minimum(torch.maximum(-cb * ex / cc, dylo), dyhi)
            return ca * ex * ex + 2.0 * cb * ex * yy + cc * yy * yy

        def q_edge_y(ey):
            xx = torch.minimum(torch.maximum(-cb * ey / ca, dxlo), dxhi)
            return ca * xx * xx + 2.0 * cb * ey * xx + cc * ey * ey

        qmin = torch.minimum(
            torch.minimum(q_edge_x(dxlo), q_edge_x(dxhi)),
            torch.minimum(q_edge_y(dylo), q_edge_y(dyhi)))
        qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
        opa_eff = torch.clamp(opa * opa_growth, max=1.0)
        qthr = 2.0 * torch.log(torch.clamp(opa_eff, min=1e-12)
                               * (2.0 * 255.0))
        tile_id = torch.where(pair_ok & (qmin > qthr), dead_tile, tile_id)

    pair_live = tile_id < n_tiles
    depth_key = torch.where(pair_live, bt[:, 3],
                            torch.full_like(bt[:, 3], float("inf")))
    num_kept = torch.sum(pair_live.to(i32)).to(i32)

    # packed [tile | depth-bits] int32 key: positive f32 bit patterns are
    # monotonic in value, so truncating low mantissa bits keeps depth
    # order up to >= 2^-13 relative ties, which the stable sort breaks by
    # emission order
    d_bits = 31 - int(n_tiles).bit_length()
    depth_bits = depth_key.contiguous().view(i32)
    key = (tile_id << d_bits) | (depth_bits >> (31 - d_bits))
    key_s, order = torch.sort(key, stable=True)
    gid_s = gid[order]
    em_s = order                                  # == p_idx[order]

    # per-tile ranges in sorted order
    bounds = torch.searchsorted(
        key_s, torch.arange(n_tiles + 1, dtype=i32, device=dev) << d_bits,
        right=False, out_int32=True)
    rs, re_ = bounds[:-1], bounds[1:]
    n_t = re_ - rs

    # aligned relocation offsets: tile t starts at astart[t] (mult of chunk)
    cap_t = torch.div(n_t + chunk - 1, chunk, rounding_mode="floor") * chunk
    astart = (torch.cumsum(cap_t, 0) - cap_t).to(i32)
    ranges = torch.stack([astart, astart + n_t], dim=-1)

    # per-sorted-slot shift via delta scatter + cumsum (empty tiles can
    # share rs positions, so deltas accumulate)
    shift = astart - rs
    delta = torch.diff(shift, prepend=shift[:1] * 0)
    delta[0] = delta[0] + shift[0]
    dvec = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    dvec.index_add_(0, torch.clamp(rs, max=capacity).long(), delta.long())
    new_pos = p_idx.long() + torch.cumsum(dvec[:capacity], 0)
    new_pos = torch.where(key_s < (n_tiles << d_bits), new_pos,
                          torch.full_like(new_pos, B_al))

    # dead slots all land on the spare index B_al, which is cut off
    pair_gid1 = torch.zeros(B_al + 1, dtype=i32, device=dev)
    pair_gid1[new_pos] = gid_s + 1
    pair_gid1 = pair_gid1[:B_al]
    aligned_of_em = torch.full((capacity,), B_al, dtype=i32, device=dev)
    aligned_of_em[em_s] = new_pos.to(i32)

    return PairPlan(pair_gid1=pair_gid1, ranges=ranges.to(i32),
                    aligned_of_em=aligned_of_em,
                    seg_start=starts, seg_end=offs,
                    num_pairs=num_pairs.to(i32), overflow=overflow.to(i32),
                    num_kept=num_kept)

"""Mean squared distance to the 3 nearest neighbours, for Gaussian scale
initialization (torch port of ops/knn.py; the reference's distCUDA2).

- ``mean_sq_dist_3nn_exact``: tiled exact top-3 over all pairs, for the
  per-keyframe point batches of up to 16384 points;
- ``mean_sq_dist_3nn_morton``: a stable Morton-order sort and a
  +/- ``window`` candidate search, for larger batches.

Morton codes are built in int64 (torch's uint32 has few operations):
the same 30-bit codes, with invalid points at 0xFFFFFFFF, in the same
order.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e30


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def mean_sq_dist_3nn_exact(points: torch.Tensor,
                           valid: Optional[torch.Tensor] = None,
                           chunk: int = 1024) -> torch.Tensor:
    """points (N, 3); invalid points are no one's neighbour and get 0.
    Returns (N,)."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.zeros(n, dtype=points.dtype, device=dev)
    cols = torch.arange(n, device=dev)
    for s in range(0, n, chunk):
        q = points[s:s + chunk]
        d = _pairwise_sq_dist(q, points)                   # (c, N)
        rows = torch.arange(s, s + q.shape[0], device=dev)
        d = torch.where(valid[None, :] & (rows[:, None] != cols[None, :]),
                        d, torch.full_like(d, _BIG))
        top = torch.topk(d, 3, dim=1, largest=False).values
        mean = torch.mean(top, dim=-1)
        out[s:s + q.shape[0]] = torch.where(valid[s:s + chunk], mean,
                                            torch.zeros_like(mean))
    return out


def _morton_codes(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """10-bit-per-axis Morton codes in int64; invalid points 0xFFFFFFFF."""
    vm = valid[:, None]
    p = torch.where(vm, points, torch.zeros_like(points))
    lo = torch.amin(torch.where(vm, points, torch.full_like(points, _BIG)),
                    dim=0)
    hi = torch.amax(torch.where(vm, points, torch.full_like(points, -_BIG)),
                    dim=0)
    rng = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp(((p - lo) / rng) * 1023.0, 0, 1023).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.where(valid, code, torch.full_like(code, 0xFFFFFFFF))


def mean_sq_dist_3nn_morton(points: torch.Tensor,
                            valid: Optional[torch.Tensor] = None,
                            window: int = 32) -> torch.Tensor:
    """Approximate 3-NN: Morton order, then the +/- ``window`` neighbours
    in that order (indices clamped at the ends, as the reference does)."""
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    order = torch.sort(_morton_codes(points, valid), stable=True).indices
    pts_s = points[order]
    val_s = valid[order]
    idx = torch.arange(n, device=dev)
    offsets = torch.arange(-window, window + 1, device=dev)
    nbr = torch.clamp(idx[:, None] + offsets[None, :], 0, n - 1)
    cand_valid = val_s[nbr] & (nbr != idx[:, None])
    d = torch.sum((pts_s[nbr] - pts_s[:, None, :]) ** 2, dim=-1)
    d = torch.where(cand_valid, d, torch.full_like(d, _BIG))
    top = torch.topk(d, 3, dim=1, largest=False).values
    mean = torch.mean(top, dim=-1)
    out_s = torch.where(val_s, mean, torch.zeros_like(mean))
    out = torch.empty_like(out_s)
    out[order] = out_s
    return out


def mean_sq_dist_3nn(points: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact up to 16384 points, Morton-window above."""
    if points.shape[0] <= 16384:
        return mean_sq_dist_3nn_exact(points, valid)
    return mean_sq_dist_3nn_morton(points, valid)

"""Per-pair feature gather and per-gaussian segment reduce (torch port of
ops/pair_gather.py, forward only).

Forward: feat[p] = table[plan.pair_gid1[p] - 1] for live pair slots.
``segment_reduce_pairs`` sums per-pair values onto their Gaussian with
the reference's cumsum trick: pairs are contiguous per gaussian in
emission order, so a gather into emission order, one cumsum and two
(N,) gathers give every gaussian's sum without atomics.
"""

from __future__ import annotations

import torch

from .binning2 import PairPlan


def pair_gather(table: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """table: (N, F) per-gaussian rows -> (B_al, F) per-pair rows (dead
    slots zero)."""
    gid1 = plan.pair_gid1
    live = gid1 > 0
    rows = table[torch.clamp(gid1 - 1, min=0).long()]
    return torch.where(live[:, None], rows, torch.zeros_like(rows))


def segment_reduce_pairs(values: torch.Tensor, plan: PairPlan
                         ) -> torch.Tensor:
    """values: (B_al,) or (B_al, F) in ALIGNED order -> (N,) or (N, F)
    per-gaussian sums (n_touched accumulation)."""
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    B_al = plan.pair_gid1.shape[0]
    capacity = plan.aligned_of_em.shape[0]

    ok = plan.aligned_of_em < B_al
    src = torch.clamp(plan.aligned_of_em, max=B_al - 1).long()
    g_em = torch.where(ok[:, None], values[src], torch.zeros_like(values[src]))
    csum = torch.cumsum(g_em, dim=0)

    end = torch.clamp(plan.seg_end, max=capacity)
    start = torch.clamp(plan.seg_start, max=capacity)
    hi = torch.clamp(end - 1, 0, capacity - 1).long()
    lo = torch.clamp(start - 1, 0, capacity - 1).long()
    zero = torch.zeros_like(csum[hi])
    val_hi = torch.where((end >= 1)[:, None], csum[hi], zero)
    val_lo = torch.where((start >= 1)[:, None], csum[lo], zero)
    out = val_hi - val_lo
    return out[:, 0] if squeeze else out

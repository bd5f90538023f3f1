"""Per-pair feature gather and per-gaussian segment reduce (torch port of
ops/pair_gather.py).

Forward: feat[p] = table[plan.pair_gid1[p] - 1] for live pair slots.
Backward: the transpose of the gather is a segment-sum of per-pair rows
onto their Gaussian (``segment_reduce_pairs``, which also accumulates
n_touched). As in the reference, no scatter-add or atomics: pairs are
contiguous per gaussian in emission order.

- On CPU tensors the plain versions (``pair_gather_plain``,
  ``segment_reduce_plain``), the reference's chain: a gather into
  emission order, one cumsum and two (N,) gathers give every gaussian's
  sum.
- On CUDA tensors two hand-written kernels (``csrc/pair_gather.cu``):
  ``pair_gather_fwd`` copies the rows, ``segment_reduce_fwd`` walks each
  gaussian's own emission segment and sums its live pairs' rows in
  emission order, so the work is the live pairs' and not the capacity's,
  and two runs on one input give the same bits. They take float32 at any
  strides and raise on anything else; nothing falls back. Each counts its
  launches (``.launches``).

The kernels replace no ``pl.pallas_call`` site (the JAX package writes the
stage in plain ``jnp``); their counters are in ``ops/launches.py``
``COUNTERS`` all the same, and ``utils/trace.py`` ``snapshot()`` reports
them as ``launch.pair_gather_fwd`` and ``launch.segment_reduce_fwd``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .binning2 import PairPlan


def _vec(x: torch.Tensor) -> int:
    """4 where the kernels may move ``x``'s (rows, F) rows as float4 (F a
    multiple of 4, unit column stride, rows 16-byte aligned), else 1."""
    s0, s1 = x.stride()
    ok = (x.shape[1] % 4 == 0 and s1 == 1 and s0 % 4 == 0
          and x.data_ptr() % 16 == 0)
    return 4 if ok else 1


def _check(x: torch.Tensor, name: str):
    """The kernels' one demand on the float operand; the plan's arrays are
    contiguous int32 on the map's device as ``binning2.plan_pairs`` builds
    them (held by tests/test_torch_pair_gather.py)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} must be 2-D float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _launch(fn, dev, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def pair_gather_fwd(table: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """Launch the gather kernel: (N, F) float32 ``table`` at any strides ->
    (B_al, F) contiguous rows, zero at dead slots. Counts ``launches``."""
    _check(table, "table")
    b_al, f = plan.pair_gid1.shape[0], table.shape[1]
    feat = torch.empty(b_al, f, dtype=torch.float32, device=table.device)
    _launch(_build.entry("pair_gather", "pair_gather_fwd"), table.device,
            _ptr(plan.pair_gid1), _ptr(table), *table.stride(), _ptr(feat),
            b_al, f, _vec(table))
    pair_gather_fwd.launches += 1
    return feat


pair_gather_fwd.launches = 0


def segment_reduce_fwd(values: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """Launch the segment-sum kernel: (B_al, F) float32 ``values`` in
    aligned order, at any strides -> (N, F) contiguous per-gaussian sums.
    Counts ``launches``."""
    _check(values, "values")
    n, f = plan.seg_start.shape[0], values.shape[1]
    b_al, capacity = plan.pair_gid1.shape[0], plan.aligned_of_em.shape[0]
    if values.shape[0] != b_al:
        raise ValueError(f"values has {values.shape[0]} rows, the plan "
                         f"{b_al} slots")
    out = torch.empty(n, f, dtype=torch.float32, device=values.device)
    _launch(_build.entry("pair_gather", "segment_reduce_fwd"), values.device,
            _ptr(plan.seg_start), _ptr(plan.seg_end),
            _ptr(plan.aligned_of_em), _ptr(values), *values.stride(),
            _ptr(out), n, f, capacity, b_al, _vec(values))
    segment_reduce_fwd.launches += 1
    return out


segment_reduce_fwd.launches = 0


class _PairGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        if table.is_cuda:
            return pair_gather_fwd(table, plan)
        return pair_gather_plain(table, plan)

    @staticmethod
    def backward(ctx, dfeat):
        return segment_reduce_pairs(dfeat, ctx.plan), None


def pair_gather(table: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """table: (N, F) per-gaussian rows -> (B_al, F) per-pair rows (dead
    slots zero). Differentiable in ``table``."""
    return _PairGather.apply(table, plan)


def segment_reduce_pairs(values: torch.Tensor, plan: PairPlan
                         ) -> torch.Tensor:
    """values: (B_al,) or (B_al, F) in ALIGNED order -> (N,) or (N, F)
    per-gaussian sums, N = len(plan.seg_start): ``pair_gather``'s backward
    and the n_touched accumulation."""
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    out = (segment_reduce_fwd if values.is_cuda
           else segment_reduce_plain)(values, plan)
    return out[:, 0] if squeeze else out


def pair_gather_plain(table: torch.Tensor, plan: PairPlan) -> torch.Tensor:
    """The gather's plain version, on any device: one row gather and a
    mask."""
    gid1 = plan.pair_gid1
    live = gid1 > 0
    rows = table[torch.clamp(gid1 - 1, min=0).long()]
    return torch.where(live[:, None], rows, torch.zeros_like(rows))


def segment_reduce_plain(values: torch.Tensor, plan: PairPlan
                         ) -> torch.Tensor:
    """The segment sum's plain version, on any device: (B_al, F) -> (N, F)
    as the difference of two prefix sums over the capacity."""
    B_al = plan.pair_gid1.shape[0]
    capacity = plan.aligned_of_em.shape[0]

    ok = plan.aligned_of_em < B_al
    src = torch.clamp(plan.aligned_of_em, max=B_al - 1).long()
    g_em = torch.where(ok[:, None], values[src], torch.zeros_like(values[src]))
    # the scan runs along the last, contiguous axis of (F, capacity): on
    # the card a cumsum along dim 0 of (capacity, F) is an outer-dimension
    # scan that took ~0.37 s at capacity 2^20, F = 16 (H100)
    csum = torch.cumsum(g_em.T.contiguous(), dim=1)

    end = torch.clamp(plan.seg_end, max=capacity)
    start = torch.clamp(plan.seg_start, max=capacity)
    hi = torch.clamp(end - 1, 0, capacity - 1).long()
    lo = torch.clamp(start - 1, 0, capacity - 1).long()
    zero = torch.zeros_like(csum[:, hi])
    val_hi = torch.where((end >= 1)[None], csum[:, hi], zero)
    val_lo = torch.where((start >= 1)[None], csum[:, lo], zero)
    return (val_hi - val_lo).T

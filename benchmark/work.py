"""The work a backward compositing call needs, and the least time the
card could take for it: the kernel roofline's yardstick.

Frozen from ``chip_smoke.py`` (its bound model, PERF.md's kernel table):
the work these inputs need, whatever cells a kernel design walks. Every
live pair row is read once and every pair row of the gradient buffer
written once (64 B each), the ranges and the ten image planes read once.
Arithmetic: 84 FP32 operations a blended cell (the recomputed falloff
and tests 25, the gradient 59).

The cells are counted by the plain walk of the reference
(``reference/render.py`` ``walk`` over the call's own pair lists).
Peaks: 67 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s HBM
(NVIDIA H100 SXM data sheet, at the full 700 W power limit).
"""

from __future__ import annotations

from typing import Optional

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_BWD_INCLUDED = 25.0 + 59.0


def bwd_least_s(live_pairs: int, rows: int, n_ranges: int, width: int,
                height: int, included: int) -> float:
    nbytes = (live_pairs * 64 + rows * 64 + n_ranges * 2 * 4
              + 10 * width * height * 4)
    return max(nbytes / HBM_BYTES_PER_S, included * OPS_BWD_INCLUDED
               / FP32_OPS_PER_S)


class Calls:
    """The differentiated compositing calls of a traced part of a window.
    ``wrap`` puts a recorder around the program's ``composite32``: it
    numbers every differentiated call (whose backward kernel runs in the
    same order) and keeps the pair lists of every ``stride``-th one, so
    that the trace is not filled with the allocations of kept buffers.
    After the window ``shares`` matches the kept calls to their backward
    kernels' device times, which the trace lists in launch order."""

    def __init__(self, stride: int):
        self.stride = int(stride)
        self.kept = []
        self.n_grad = 0

    def wrap(self, composite32):
        def recorded(feat, ranges, n_tx, n_ty, W, H, with_ntouch=True,
                     nt_weight=False, bf16=False, mxu=False):
            if feat.requires_grad:
                if self.n_grad % self.stride == 0:
                    self.kept.append((self.n_grad, feat.detach(), ranges,
                                      n_tx, W, H))
                self.n_grad += 1
            return composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                               nt_weight, bf16, mxu)
        return recorded

    def shares(self, durations: dict, walk, tile_lists) -> dict:
        """{"bwd": %} of the kept calls: least time over device time.
        ``durations["bwd"]``: seconds of the backward compositing kernels
        in launch order (``devtrace.reduce``). Left out where the kernels
        do not pair one to one with the calls."""
        bwd = durations.get("bwd", [])
        least = t = 0.0
        if len(bwd) == self.n_grad:
            for g, feat, ranges, n_tx, W, H in self.kept:
                out = walk(tile_lists(feat, ranges, n_tx, W, H),
                           need_image=False)
                live = int((ranges[:, 1] - ranges[:, 0]).sum())
                least += bwd_least_s(live, feat.shape[0], ranges.shape[0],
                                     W, H, out["included"])
                t += bwd[g]
        self.kept.clear()
        return {"bwd": 100.0 * least / t} if t > 0.0 else {}


def share(run, kind: str) -> Optional[float]:
    """A roofline share the run measured, or None."""
    return None if run.work is None else run.work.get(kind)

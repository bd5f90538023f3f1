"""Reduction of a ``torch.profiler`` trace of part of a run's window to
what the per-layer metrics read: the device's busy time (the union of the
kernel, copy and fill intervals), the traced window's length, kernel
launches, the compositing kernels' device times in launch order, the
device operations that took most time and the longest idle gaps with what
the host was doing in each.

The profiler records device activity only (the kernels, copies and fills,
and the CUDA runtime calls that issued them), which costs the host far
less than recording every operator. It starts and stops right after a
``torch.cuda.synchronize()``, so the traced window is the span of its
events. The trace is exported to a file under ``TMPDIR``, read and
deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def composite_part(kernel: str) -> Optional[str]:
    """The compositing kernel a device kernel's name belongs to
    (composite32_fwd, composite32_bwd, composite16_fwd, composite16_bwd),
    or None. Frozen from ``chip_smoke.py`` ``composite_part``: the
    sub-tile forward of both tile sizes is one template told apart by its
    last argument."""
    if "composite_fwd_subtile<" in kernel:
        args = kernel.split("composite_fwd_subtile<", 1)[1].split(">", 1)[0]
        tile16 = args.split(",")[-1].strip() in ("true", "(bool)1", "1")
        return "composite16_fwd" if tile16 else "composite32_fwd"
    return next((part for part in ("composite32_fwd", "composite32_bwd",
                                   "composite16_fwd", "composite16_bwd")
                 if f"{part}_kernel" in kernel or f"{part}_subtile" in kernel),
                None)


def export_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce(events: list) -> dict:
    """Numbers of the traced window (seconds; times in the trace are
    microseconds)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") in DEVICE_CATS + HOST_CATS
             and "ts" in e]
    if not spans:       # a run on the CPU: nothing ran on a device
        return dict(window_s=0.0, busy_s=0.0, launches=0,
                    composite_durs={}, device_ops=[], idle_gaps=[])
    w0 = min(a for a, _ in spans)
    w1 = max(b for _, b in spans)
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                dev.append((s, t, e["cat"], e.get("name", "")))
    busy = _union([(s, t) for s, t, _, _ in dev])
    by_name, comp = {}, {"fwd": [], "bwd": []}
    launches = 0
    for s, t, cat, name in sorted(dev):
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        if cat == "kernel":
            launches += 1
            part = composite_part(name)
            if part:
                comp[part[-3:]].append((t - s) * 1e-6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps inside the window, named by the innermost host event that
    # spans the gap's middle
    gaps, end = [], w0
    for s, t, _, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "")) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e)
    starts = [h[0] for h in host]
    idle = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        best = None
        i = bisect.bisect_right(starts, mid)
        for h in host[max(0, i - 4000):i]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        idle.append([best[2] if best else "host code between CUDA calls",
                     (g1 - g0) * 1e-6])
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                launches=launches,
                composite_durs=comp,
                device_ops=[[n, v * 1e-6] for n, v in top],
                idle_gaps=idle)

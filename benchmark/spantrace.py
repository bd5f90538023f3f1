"""The program's spans (the port's ``utils/trace.py``) joined with a
``torch.profiler`` trace of the device, and the per-keyframe numbers the
spans give. No cell reads this yet: a traced run has to turn the
program's recorder on and keep the trace's base time, which takes edits
to ``loops/map.py``, ``devtrace.py`` and ``harness.py`` (PERF.md, open
questions).

A span is a dict with ``name``, ``id``, ``parent`` (the id of the
innermost span open on its thread at its entry), ``start_ns``,
``end_ns`` (``time.time_ns()``) and ``attrs``. The profiler writes its
trace on the same clock: an event's ``ts`` in microseconds plus the
trace's ``baseTimeNanoseconds / 1000``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional

from .devtrace import DEVICE_CATS, HOST_CATS

# runtime calls in which the host waits for the device: the
# synchronisations, allocation and release (which synchronise), and a
# copy to the host (matched to its device copy by correlation id)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMalloc", "cudaFree")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync")
NO_SPAN = "(no span)"
ITER = "mapping.iter"
KEYFRAME = ("backend.add_next_kf", "backend.handle_keyframe")


def export_trace(prof):
    """(events, base_ns): a profiler's events and the trace's
    ``baseTimeNanoseconds``, 0 where the trace has none (its ``ts`` are
    then on the clock itself)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))
    finally:
        os.remove(path)


def _idle(events: list) -> list:
    """The traced window's intervals in which no device operation ran, in
    order (``devtrace.reduce``'s window: the span of the device and
    runtime events)."""
    ivals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") in DEVICE_CATS + HOST_CATS
             and "ts" in e]
    if not ivals:
        return []
    w0, w1 = min(a for a, _ in ivals), max(b for _, b in ivals)
    dev = sorted((max(float(e["ts"]), w0),
                  min(float(e["ts"]) + float(e["dur"]), w1))
                 for e in events if e.get("cat") in DEVICE_CATS
                 and "dur" in e)
    gaps, end = [], w0
    for s, t in dev:
        if t <= s:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def _segments(spans: list, base_ns: int) -> list:
    """[(start, end, name)] in trace microseconds: the time the spans
    cover, cut where the innermost open span (the latest started of those
    open) changes."""
    bounds = []
    for k, sp in enumerate(spans):
        bounds.append(((sp["start_ns"] - base_ns) / 1e3, 1, k))
        bounds.append(((sp["end_ns"] - base_ns) / 1e3, 0, k))
    bounds.sort()
    segs, open_ = [], {}
    for i, (t, is_start, k) in enumerate(bounds):
        if is_start:
            open_[k] = spans[k]["start_ns"]
        else:
            open_.pop(k, None)
        if open_ and i + 1 < len(bounds) and bounds[i + 1][0] > t:
            inner = max(open_, key=open_.get)
            segs.append((t, bounds[i + 1][0], spans[inner]["name"]))
    return segs


def _largest_first(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]


def join(events: list, spans: list, base_ns: int = 0) -> dict:
    """What the spans say of a trace:

    - ``idle_by_span``: the device's idle seconds in the traced window,
      summed by the innermost span open during each part of each idle
      interval, ``(no span)`` for the parts no span covers; largest
      first;
    - ``host_wait_s``: the seconds of the runtime calls in which the host
      waits for the device (``SYNC_CALLS``, and ``COPY_CALLS`` whose
      device copy goes to the host) inside ``mapping.iter`` spans;
    - ``launches_by_span``: the device kernels, counted by the innermost
      span open at the runtime call that launched each (matched by
      correlation id); largest first.

    Spans of all threads count alike: the backward's kernels are launched
    from autograd's thread while the span that waits for it is open."""
    segs = _segments(spans, base_ns)
    starts = [sg[0] for sg in segs]

    def name_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else NO_SPAN

    idle, k = {}, 0
    for g0, g1 in _idle(events):
        t = g0
        while k < len(segs) and segs[k][1] <= t:
            k += 1
        j = k
        while t < g1:
            if j < len(segs) and segs[j][0] <= t:
                end, name = min(segs[j][1], g1), segs[j][2]
                j += 1
            else:
                end = min(segs[j][0], g1) if j < len(segs) else g1
                name = NO_SPAN
            idle[name] = idle.get(name, 0.0) + (end - t) * 1e-6
            t = end

    calls, copies_to_host = {}, set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in HOST_CATS:
            calls[corr] = e
        elif e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            copies_to_host.add(corr)
    launches = {}
    for e in events:
        if e.get("cat") == "kernel":
            call = calls.get(e.get("args", {}).get("correlation"))
            name = NO_SPAN if call is None else name_at(float(call["ts"]))
            launches[name] = launches.get(name, 0) + 1

    iters = [((sp["start_ns"] - base_ns) / 1e3,
              (sp["end_ns"] - base_ns) / 1e3) for sp in spans
             if sp["name"] == ITER]
    wait = 0.0
    for e in events:
        if e.get("cat") not in HOST_CATS or "dur" not in e:
            continue
        name = e.get("name", "").split("_v")[0]
        if not (name in SYNC_CALLS or (
                name in COPY_CALLS
                and e.get("args", {}).get("correlation") in copies_to_host)):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        for s, t in iters:
            wait += max(0.0, min(b, t) - max(a, s))
    return dict(idle_by_span=_largest_first(idle), host_wait_s=wait * 1e-6,
                launches_by_span=_largest_first(launches))


def _ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-6


def keyframe_numbers(spans: list, plans_built: int,
                     profiled_frame: Optional[int] = None
                     ) -> Dict[str, Optional[float]]:
    """The span-read numbers of the keyframes recorded before the one
    with ``frame_idx == profiled_frame`` (all, where None): the profiler
    slows the host through the profiled keyframe and stops inside its
    prune pass, which would count its own work as the program's.
    ``plans_built`` is ``render.plans_built`` over the same keyframes.

    - ``intake_ms_per_keyframe``: mean ``backend.add_next_kf``;
    - ``kf_handling_ms_per_keyframe``: per keyframe, ``add_next_kf`` and
      ``handle_keyframe`` less the ``mapping.iter`` spans under them;
    - ``iter_ms``: mean ``mapping.iter``;
    - ``plan_ms_per_build``: the ``render.plan`` spans' total over
      ``plans_built``;
    - ``plans_per_iter``: ``plans_built`` over the ``mapping.iter``
      spans."""
    t0 = min((s["start_ns"] for s in spans if s["name"] in KEYFRAME
              and s["attrs"].get("frame_idx") == profiled_frame),
             default=None)
    if t0 is not None:
        spans = [s for s in spans if s["end_ns"] <= t0]

    def named(name):
        return [s for s in spans if s["name"] == name]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    by_id = {s["id"]: s for s in spans}
    tops = [s for s in spans if s["name"] in KEYFRAME]
    top_ids = {s["id"] for s in tops}
    handling = sum(_ms(s) for s in tops)
    for s in named(ITER):
        p = s["parent"]
        while p is not None and p not in top_ids and p in by_id:
            p = by_id[p]["parent"]
        if p in top_ids:
            handling -= _ms(s)
    n_kf = len({s["attrs"].get("frame_idx") for s in tops})
    n_iter = len(named(ITER))
    return dict(
        intake_ms_per_keyframe=mean([_ms(s) for s in
                                     named("backend.add_next_kf")]),
        kf_handling_ms_per_keyframe=handling / n_kf if n_kf else None,
        iter_ms=mean([_ms(s) for s in named(ITER)]),
        plan_ms_per_build=(sum(_ms(s) for s in named("render.plan"))
                           / plans_built if plans_built else None),
        plans_per_iter=plans_built / n_iter if n_iter else None)

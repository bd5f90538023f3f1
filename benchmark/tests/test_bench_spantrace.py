"""The program's spans joined with a hand-built trace (``spantrace.py``):
idle time put down to the innermost span, ``(no span)`` for the rest,
the host's waits inside ``mapping.iter`` only, launches by span; then
the per-keyframe numbers of hand-built spans, the profiled keyframe left
out."""

import pytest

from benchmark import devtrace, spantrace

BASE_NS = 1_790_000_000_000_000_000
US = 1e-6


def rt(name, ts, dur, corr):
    return dict(cat="cuda_runtime", name=name, ts=ts, dur=dur,
                args=dict(correlation=corr))


def dev(cat, name, ts, dur, corr):
    return dict(cat=cat, name=name, ts=ts, dur=dur,
                args=dict(correlation=corr))


# microseconds past BASE_NS; the device idles 0-2, 10-30, 40-45, 49-53
# and 54-80 of the window 0-90
EVENTS = [
    rt("cudaLaunchKernel", 0, 1, 1),
    dev("kernel", "k1", 2, 8, 1),
    rt("cudaLaunchKernel", 11, 1, 2),
    rt("cudaStreamSynchronize", 13, 17, 0),
    dev("kernel", "k2", 30, 10, 2),
    rt("cudaMemcpyAsync", 41, 9, 3),
    dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 45, 4, 3),
    rt("cudaMemcpyAsync", 51, 1, 4),
    dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 53, 1, 4),
    rt("cudaDeviceSynchronize", 60, 10, 0),
    rt("cudaLaunchKernel", 75, 1, 5),
    dev("kernel", "k3", 80, 10, 5),
    dict(cat="cpu_op", name="aten::add", ts=3, dur=1),
]


def span(name, sid, parent, t0, t1, **attrs):
    """A span from ``t0`` to ``t1`` microseconds past BASE_NS."""
    return dict(name=name, id=sid, parent=parent, tid=1,
                start_ns=BASE_NS + int(t0 * 1000),
                end_ns=BASE_NS + int(t1 * 1000), attrs=attrs)


SPANS = [
    span("mapping.render", 3, 2, 14, 25),
    span("mapping.iter", 2, 1, 12, 50),
    span("backend.handle_keyframe", 1, None, 0, 58, frame_idx=7),
]


def test_idle_goes_to_the_innermost_span():
    out = spantrace.join(EVENTS, SPANS, BASE_NS)
    got = dict(out["idle_by_span"])
    want = {"backend.handle_keyframe": 11 * US, "mapping.iter": 13 * US,
            "mapping.render": 11 * US, spantrace.NO_SPAN: 22 * US}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    # largest first, and all of the window's idle time
    assert out["idle_by_span"][0][0] == spantrace.NO_SPAN
    red = devtrace.reduce(EVENTS)
    assert sum(got.values()) == pytest.approx(red["window_s"]
                                              - red["busy_s"])


def test_host_wait_counts_synchronising_calls_in_iterations():
    # the stream synchronisation (13-30) and the copy to the host (41-50)
    # inside mapping.iter; not the copy to the device, not the device
    # synchronisation outside every iteration
    out = spantrace.join(EVENTS, SPANS, BASE_NS)
    assert out["host_wait_s"] == pytest.approx(26 * US)


def test_launches_by_span():
    out = spantrace.join(EVENTS, SPANS, BASE_NS)
    assert out["launches_by_span"] == [["backend.handle_keyframe", 2],
                                       [spantrace.NO_SPAN, 1]]


def test_absolute_times_without_a_base():
    """A trace with no baseTimeNanoseconds has its ts on the clock."""
    shifted = [dict(e, ts=e["ts"] + BASE_NS / 1000) for e in EVENTS]
    a = spantrace.join(EVENTS, SPANS, BASE_NS)
    b = spantrace.join(shifted, SPANS, 0)
    assert a["launches_by_span"] == b["launches_by_span"]
    assert b["host_wait_s"] == pytest.approx(a["host_wait_s"], abs=1e-9)
    for (na, va), (nb, vb) in zip(a["idle_by_span"], b["idle_by_span"]):
        assert na == nb and vb == pytest.approx(va, abs=1e-9)


def test_a_trace_without_device_work():
    out = spantrace.join([dict(cat="cpu_op", name="x", ts=0, dur=1)],
                         SPANS, BASE_NS)
    assert out == dict(idle_by_span=[], host_wait_s=0.0,
                       launches_by_span=[])


def keyframe_spans():
    """Two keyframes: intake 10 and 6 ms; handling 40 and 20 ms with two
    and one 10-ms iterations under them; one 2-ms plan build; then the
    profiled keyframe."""
    ms = 1000.0
    return [
        span("backend.add_next_kf", 1, None, 0, 10 * ms, frame_idx=5),
        span("backend.handle_keyframe", 2, None, 10 * ms, 50 * ms,
             frame_idx=5),
        span("backend.map", 3, 2, 11 * ms, 45 * ms),
        span("backend.batch", 4, 3, 11 * ms, 44 * ms, T=2, reused=False),
        span("render.plan", 5, 4, 12 * ms, 14 * ms),
        span("mapping.iter", 6, 4, 20 * ms, 30 * ms),
        span("mapping.iter", 7, 4, 30 * ms, 40 * ms),
        span("backend.add_next_kf", 8, None, 60 * ms, 66 * ms,
             frame_idx=10),
        span("backend.handle_keyframe", 9, None, 66 * ms, 86 * ms,
             frame_idx=10),
        span("backend.prune_pass", 10, 9, 70 * ms, 85 * ms),
        span("backend.batch", 11, 10, 70 * ms, 84 * ms, T=1, reused=True),
        span("mapping.iter", 12, 11, 72 * ms, 82 * ms),
        span("backend.add_next_kf", 13, None, 90 * ms, 190 * ms,
             frame_idx=15),
        span("backend.handle_keyframe", 14, None, 190 * ms, 990 * ms,
             frame_idx=15),
        span("mapping.iter", 15, 14, 200 * ms, 900 * ms),
        span("render.plan", 16, 14, 195 * ms, 199 * ms),
    ]


def test_keyframe_numbers_leave_out_the_profiled_keyframe():
    got = spantrace.keyframe_numbers(keyframe_spans(), 1, profiled_frame=15)
    assert got == pytest.approx(dict(
        intake_ms_per_keyframe=8.0,
        kf_handling_ms_per_keyframe=(10 + 40 - 20 + 6 + 20 - 10) / 2,
        iter_ms=10.0, plan_ms_per_build=2.0, plans_per_iter=1 / 3))
    every = spantrace.keyframe_numbers(keyframe_spans(), 2)
    assert every["iter_ms"] == pytest.approx((10 + 10 + 10 + 700) / 4)
    assert every["plan_ms_per_build"] == pytest.approx(3.0)


def test_keyframe_numbers_of_no_spans():
    assert set(spantrace.keyframe_numbers([], 0).values()) == {None}

"""The port's span and counter recorder (utils/trace.py) on the CPU:
nesting and parents, a stack per thread, off mode, counters and the
snapshot with the launch counts, the clock against torch.profiler's, the
span tree a tiny backend's keyframes give, and the records the spans
replaced (``plan_stats``, ``densify_log``, ``frame_log``) reading as
they did."""

import ast
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import launches
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping
from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gs_slam_analytica_jacobian_tpu_torch")


@pytest.fixture
def recorder():
    """The recorder on, empty, and off and empty again afterwards."""
    trace.drain()
    trace.enable(True)
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.drain()


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_nesting_and_parents(recorder):
    with trace.span("a", frame_idx=3) as a:
        with trace.span("b") as b:
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
    with trace.span("e"):
        pass
    spans = trace.drain()
    # kept in the order they closed
    assert [s["name"] for s in spans] == ["c", "b", "d", "a", "e"]
    s = {x["name"]: x for x in spans}
    assert s["a"]["parent"] is None and s["e"]["parent"] is None
    assert s["b"]["parent"] == s["a"]["id"] == a.id
    assert s["c"]["parent"] == s["b"]["id"] == b.id
    assert s["d"]["parent"] == s["a"]["id"]
    assert s["a"]["attrs"] == {"frame_idx": 3}
    assert s["a"]["start_ns"] <= s["b"]["start_ns"] <= s["c"]["start_ns"]
    assert s["c"]["end_ns"] <= s["b"]["end_ns"] <= s["d"]["start_ns"]
    assert s["d"]["end_ns"] <= s["a"]["end_ns"] <= s["e"]["start_ns"]
    assert len({x["id"] for x in spans}) == 5
    assert trace.drain() == []


def test_attributes_set_inside_the_span_are_kept(recorder):
    with trace.span("backend.batch", T=4) as sp:
        sp.attrs["reused"] = True
    (s,) = trace.drain()
    assert s["attrs"] == {"T": 4, "reused": True}


def test_each_thread_keeps_its_own_stack(recorder):
    inside = threading.Barrier(2, timeout=30)
    out = {}

    def work(tag):
        with trace.span("outer", tag=tag) as o:
            inside.wait()       # both outer spans open at once
            with trace.span("inner", tag=tag) as i:
                inside.wait()
        out[tag] = (o.id, i.id, threading.get_ident())

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = trace.drain()
    assert len(spans) == 4
    for s in by_name(spans, "inner"):
        o_id, i_id, tid = out[s["attrs"]["tag"]]
        assert s["id"] == i_id and s["parent"] == o_id and s["tid"] == tid
    for s in by_name(spans, "outer"):
        assert s["parent"] is None
    assert out["x"][2] != out["y"][2]


def test_off_records_nothing_and_still_times(recorder):
    trace.enable(False)
    with trace.span("x") as sp:
        t_open = sp.seconds
        time.sleep(0.003)
        assert sp.seconds >= t_open
    assert sp.seconds >= 0.003
    assert sp.seconds == sp.seconds       # fixed once closed
    assert trace.drain() == []
    # a span entered while off is not kept though recording starts
    # before it closes
    with trace.span("y"):
        trace.enable(True)
        with trace.span("z"):
            pass
    spans = trace.drain()
    assert [s["name"] for s in spans] == ["z"]
    assert spans[0]["parent"] is None


def test_counters_and_snapshot(recorder, monkeypatch):
    before = trace.snapshot()
    trace.count("test.a")
    trace.count("test.a", 2)
    trace.count("test.b")
    trace.enable(False)
    trace.count("test.b")              # counters count whether on or off
    snap = trace.snapshot()
    assert snap["test.a"] - before.get("test.a", 0) == 3
    assert snap["test.b"] - before.get("test.b", 0) == 2
    assert {k for k in snap if k.startswith("launch.")} == {
        f"launch.{k}" for k in launches.COUNTERS}
    fn, attr = launches.COUNTERS["composite32_bwd"]
    monkeypatch.setattr(fn, attr, 7)
    assert trace.snapshot()["launch.composite32_bwd"] == 7
    assert launches.counts()["composite32_bwd"] == 7   # read, not copied


def test_span_clock_is_the_profiler_clock(recorder, tmp_path):
    """A span around a record_function range contains that range once
    the trace's times are put on time.time_ns() (``ts`` in microseconds
    past ``baseTimeNanoseconds``), within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with record_function("probe"):
                torch.ones(256).sum()
                time.sleep(0.005)
    (sp,) = trace.drain()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    (ev,) = [e for e in data["traceEvents"] if e.get("name") == "probe"]
    s0 = (sp["start_ns"] - base) / 1e3
    s1 = (sp["end_ns"] - base) / 1e3
    r0, r1 = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    assert r1 - r0 >= 5000.0
    assert s0 <= r0 + 1000.0 and r1 <= s1 + 1000.0, (s0, r0, r1, s1)


def test_no_clock_reads_left_in_backend_and_frontend():
    """Every self-timing site of the backend and the frontend goes
    through the recorder."""
    for name in ("backend.py", "frontend.py"):
        with open(os.path.join(PORT, "slam", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("time", "perf_counter",
                                         "monotonic"), (name, node.lineno)


def backend_config():
    """A small RGB-D configuration (tests/test_torch_mapping.py's): 4 map
    iterations a keyframe, the densify event at iteration 10."""
    return {
        "seed": 0,
        "Dataset": dict(pcd_downsample=8, pcd_downsample_init=4,
                        adaptive_pointsize=True, point_size=0.05,
                        single_thread=True),
        "Training": dict(
            monocular=False, init_itr_num=4, init_gaussian_update=4,
            init_gaussian_reset=500, init_gaussian_th=0.005,
            init_gaussian_extent=30, mapping_itr_num=4,
            gaussian_update_every=20, gaussian_update_offset=10,
            gaussian_th=0.7, gaussian_extent=1.0, gaussian_reset=2001,
            size_threshold=20, window_size=3, pose_window=2,
            rgb_boundary_threshold=0.01, initial_capacity=1024,
            pair_capacity=1 << 14,
            lr=dict(cam_rot_delta=0.003, cam_trans_delta=0.001)),
        "opt_params": dict(
            position_lr_init=1.6e-4, position_lr_final=1.6e-6,
            position_lr_max_steps=30000, feature_lr=2.5e-3,
            opacity_lr=0.05, scaling_lr=1e-3, rotation_lr=1e-3,
            percent_dense=0.01, lambda_dssim=0.2, densify_from_iter=500,
            densify_grad_threshold=2e-4),
        "model_params": dict(sh_degree=0),
    }


@pytest.fixture(scope="module")
def backend_run():
    """Map initialization, then three keyframes (the third crosses the
    densify event) with the recorder on; the make_render_plan calls
    counted beside the recorder's counter."""
    W, H = 40, 32
    cam = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, (W - 1) / 2,
                        (H - 1) / 2, W, H, device="cpu")
    be = BackEnd(backend_config(), cam, device="cpu")
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for k in range(4):
        img = np.stack([0.5 + 0.4 * np.sin(xx / 5 + k * 0.1),
                        0.5 + 0.4 * np.cos(yy / 4), np.full_like(xx, 0.3)])
        dep = 2.0 + 0.3 * np.sin(xx / 7) + 0.01 * k
        t = np.array([0.01 * k, 0.0, 0.0], np.float32)
        frames.append((img.astype(np.float32), dep.astype(np.float32), t))
    mp = pytest.MonkeyPatch()
    calls = [0]
    orig = mapping.make_render_plan

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    mp.setattr(mapping, "make_render_plan", counted)
    trace.drain()
    try:
        img, dep, t = frames[0]
        be.add_next_kf(0, np.eye(3), t, 0.0, 0.0, img, dep, dep, init=True)
        be.initialize_map(0)
        it0, calls[0] = be.iteration_count, 0
        built0 = trace.snapshot().get("render.plans_built", 0)
        densify0 = len(be.densify_log)
        stats0 = dict(be.plan_stats)
        trace.enable(True)
        window = [0]
        for k in range(1, 4):
            img, dep, t = frames[k]
            be.add_next_kf(k, np.eye(3), t, 0.0, 0.0, img, dep, dep)
            window = ([k] + window)[:3]
            be.handle_keyframe(k, window)
        trace.enable(False)
        spans = trace.drain()
        built = trace.snapshot().get("render.plans_built", 0) - built0
    finally:
        trace.enable(False)
        mp.undo()
    return dict(be=be, spans=spans, iters=be.iteration_count - it0,
                plan_calls=calls[0], built=built, densify0=densify0,
                stats0=stats0)


def test_backend_keyframes_give_the_span_tree(backend_run):
    spans = backend_run["spans"]
    tops = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["attrs"]["frame_idx"]) for s in
            sorted(tops, key=lambda s: s["start_ns"])] == [
        (name, k) for k in (1, 2, 3)
        for name in ("backend.add_next_kf", "backend.handle_keyframe")]
    for add in by_name(spans, "backend.add_next_kf"):
        assert "backend.seed" in [c["name"] for c in children(spans, add)]
    for hk in by_name(spans, "backend.handle_keyframe"):
        kids = sorted(children(spans, hk), key=lambda s: s["start_ns"])
        assert [c["name"] for c in kids] == ["backend.map",
                                             "backend.prune_pass"]
        mp, pp = kids
        assert {c["name"] for c in children(spans, mp)} <= {
            "backend.batch", "backend.densify", "backend.opacity_reset"}
        assert [c["name"] for c in sorted(children(spans, pp),
                                          key=lambda s: s["start_ns"])] == [
            "backend.batch", "backend.covis_prune"]
    # the third keyframe's map crosses the densify event
    assert len(by_name(spans, "backend.densify")) == 1
    for b in by_name(spans, "backend.batch"):
        kids = children(spans, b)
        its = [c for c in kids if c["name"] == "mapping.iter"]
        assert len(its) == b["attrs"]["T"]
        assert isinstance(b["attrs"]["reused"], bool)
        assert {c["name"] for c in kids} <= {
            "mapping.plans", "mapping.iter", "mapping.visibility"}
        # the window's plans unless reused, the random slots' always
        assert len(by_name(kids, "mapping.plans")) == (
            1 if b["attrs"]["reused"] else 2)
    for it in by_name(spans, "mapping.iter"):
        kids = sorted(children(spans, it), key=lambda s: s["start_ns"])
        names = [c["name"] for c in kids]
        n = names.count("mapping.render")
        assert n >= 1 and names == (
            ["mapping.render", "mapping.loss", "mapping.backward"] * n
            + ["mapping.step"])
    plans = {p["id"] for p in by_name(spans, "mapping.plans")}
    for p in by_name(spans, "mapping.plans"):
        assert {c["name"] for c in children(spans, p)} <= {"render.plan"}
    assert by_name(spans, "render.plan")
    assert {s["parent"] for s in by_name(spans, "render.plan")} <= plans
    for name in ("mapping.visibility", "mapping.plans"):
        for s in by_name(spans, name):
            assert by_name([x for x in spans if x["id"] == s["parent"]],
                           "backend.batch")


def test_backend_counts_match_the_work(backend_run):
    spans = backend_run["spans"]
    # 3 keyframes x (4 mapping + 1 prune-pass) iterations
    assert len(by_name(spans, "mapping.iter")) == backend_run["iters"] == 15
    assert backend_run["built"] == backend_run["plan_calls"] > 0
    assert len(by_name(spans, "render.plan")) == backend_run["built"]
    for s in spans:
        assert s["end_ns"] >= s["start_ns"]


def test_backend_records_read_as_before(backend_run):
    be, spans = backend_run["be"], backend_run["spans"]
    assert be.iteration_count == 19
    assert len(be.densify_log) == 2 and be.densify_log[1]["iteration"] == 10
    assert len(be.densify_log) - backend_run["densify0"] == len(
        by_name(spans, "backend.densify"))
    batches = by_name(spans, "backend.batch")
    reused = [b for b in batches if b["attrs"]["reused"]]
    stats = {k: v - backend_run["stats0"][k]
             for k, v in be.plan_stats.items()}
    assert set(stats) == {"builds", "reused_batches", "reused_iters",
                          "max_stale_iters"}
    assert stats["builds"] == len(batches) - len(reused)
    assert stats["reused_batches"] == len(reused)
    assert stats["reused_iters"] == sum(b["attrs"]["T"] for b in reused)
    assert set(be.densify_log[1]) >= {"iteration", "overflow"}


def test_frontend_frame_log_reads_from_spans(recorder, tmp_path):
    """A SLAM run on the CPU (tests/test_torch_slam.py's smoke config):
    ``frame_log`` keeps its keys, and its times are the frontend's
    spans."""
    from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
    from gs_slam_analytica_jacobian_tpu_torch.utils.config import \
        load_config
    cfg = load_config(os.path.join(ROOT, "configs/synthetic/test.yaml"))
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = 64, 48
    cal["fx"] = cal["fy"] = 44.0
    cal["cx"], cal["cy"] = 31.5, 23.5
    cfg["Dataset"].update(pcd_downsample_init=4, pcd_downsample=8,
                          motion_scale=0.5, n_frames=3, single_thread=True)
    cfg["Training"].update(
        renderer="tiled", pair_capacity=1 << 14, init_itr_num=4,
        init_gaussian_update=4, init_gaussian_reset=5000,
        tracking_itr_num=3, pyr_iters=[2, 1, 2], mapping_itr_num=2,
        gaussian_update_every=25, gaussian_update_offset=7, window_size=4,
        pose_window=2, initial_capacity=4096, kf_capacity=16,
        monocular=False, kf_translation=0.01, kf_min_translation=0.005,
        kf_overlap=1.0, single_thread=True)
    cfg["Results"]["save_results"] = False
    slam = SLAM(cfg, save_dir=str(tmp_path), device="cpu")
    slam.run(n_frames=3)
    trace.enable(False)
    spans = trace.drain()
    flog = slam.frontend.frame_log
    assert len(flog) == 2
    for rec in flog:
        assert set(rec) == {"frame", "total", "load", "track", "kf",
                            "kf_host"}
    frames = {s["attrs"]["frame_idx"]: s
              for s in by_name(spans, "frontend.frame")}
    assert sorted(frames) == [0, 1, 2]
    for rec in flog:
        fr = frames[rec["frame"]]
        kids = {c["name"]: c for c in children(spans, fr)}
        ms = {k: (c["end_ns"] - c["start_ns"]) * 1e-9
              for k, c in kids.items()}
        assert rec["load"] == round(ms["frontend.load"], 4)
        assert rec["track"] == round(ms["frontend.track"], 4)
        assert rec["total"] <= round(
            (fr["end_ns"] - fr["start_ns"]) * 1e-9, 4)
        if rec["kf"]:
            assert rec["kf_host"] == round(ms["frontend.kf_host"], 4)
    assert slam.frontend.prewarm_wall_s == 0.0
    assert slam.backend.prewarm_wall_s == 0.0

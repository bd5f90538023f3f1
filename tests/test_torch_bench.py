"""The port's bench (gs_slam_analytica_jacobian_tpu_torch/bench.py) on
the CPU at a tiny size: the JSON record the command prints, its keys
against the reference bench's, the BENCH_* knobs reaching the tracker,
and the adaptive steps against the JAX package's ``pair_capacity_bucket``
(no TPU figure anywhere)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_gaussians=1500, width=64, height=40, frames=3, device="cpu")
TINY_ENV = {"BENCH_ITERS": "1,2,1", "BENCH_REPS": "1",
            "BENCH_WARM_REPS": "1"}


# the reference bench's TPU utilization model, which the port leaves out
# (the benchmark's trace-based roofline replaced it)
NOT_IN_PORT = {"util_est", "util_model"}


def _reference_detail_keys():
    """The detail keys of the root bench.py's printed record."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "n_gaussians"
                for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("no detail dict in bench.py")


@pytest.fixture(scope="module")
def record():
    rec = bench.run_bench(env=TINY_ENV, **TINY)
    return json.loads(json.dumps(rec))          # as the command prints it


def test_bench_record_on_cpu(record):
    assert record["metric"] == "tracking_fps_replica_scale"
    assert record["unit"] == "frames/s"
    assert record["value"] > 0
    assert record["vs_baseline"] == round(record["value"] / 30.0, 3)
    d = record["detail"]
    assert _reference_detail_keys() - NOT_IN_PORT <= set(d)
    assert not NOT_IN_PORT & set(d)
    assert d["resolution"] == "64x40" and d["frames"] == 2
    assert d["n_gaussians"] == 1500
    assert d["gt_render_overflow"] == 0
    assert d["level_iters"] == [1, 2, 1]          # BENCH_ITERS: no level drop
    assert len(d["level_caps"]) == 3 and len(d["level_pairs"]) == 3
    assert d["pair_capacity"] == d["level_caps"][-1]
    assert np.isfinite(d["pose_err_mean_m"]) and d["pose_err_max_m"] >= 0
    assert d["pair_cells_per_frame"] > 0
    # on the CPU: no card, no kernel launched
    assert d["device"] == "cpu"
    assert set(d["kernel_launches"].values()) == {0}
    text = json.dumps(record)
    for word in ("TPU", "v5e", "VPU", "3.85e12"):
        assert word not in text


def test_adapt_schedule_matches_jax_buckets():
    from gs_slam_analytica_jacobian_tpu.slam import tracking as jtracking
    cap = 1 << 20
    for npairs in ([1000, 250_000, 400_000], [0, 87_381, 87_382],
                   [300_000, 600_000, 900_000]):
        kw = dict(level_iters=(5, 12, 2), plan_pad=4.0)
        caps, adapted = bench.adapt_schedule(kw, np.asarray(npairs), [], {},
                                             cap)
        assert adapted
        assert caps == tuple(jtracking.pair_capacity_bucket(p, cap)
                             if p > 0 else cap for p in npairs)
        assert kw == dict(level_iters=(5, 12, 2), plan_pad=4.0)
        # the same buckets again: nothing to adapt
        assert bench.adapt_schedule(kw, np.asarray(npairs), [], {}, cap,
                                    caps) == (caps, False)


def test_adapt_schedule_easy_streak():
    kw = dict(level_iters=(5, 12, 2), plan_pad=4.0)
    caps, adapted = bench.adapt_schedule(kw, None, [False, True, True, True],
                                         {}, 1 << 20)
    assert adapted and caps is None
    assert kw == dict(level_iters=(0, 12, 2), plan_pad=2.0)
    # the streak must be the last three frames; knobs switch it off
    for flags, env in (([True, True, False], {}),
                       ([True] * 3, {"BENCH_ITERS": "5,12,2"}),
                       ([True] * 3, {"BENCH_ADAPT_LEVELS": "0"})):
        kw = dict(level_iters=(5, 12, 2), plan_pad=4.0)
        assert bench.adapt_schedule(kw, None, flags, env, 1 << 20) == (
            None, False)
    kw = dict(levels=(8, 4, 2, 1), level_iters=(2, 5, 12, 2), plan_pad=3.0)
    bench.adapt_schedule(kw, None, [True] * 3, {"BENCH_PAD": "3"}, 1 << 20)
    assert kw["level_iters"] == (0, 0, 12, 2) and kw["plan_pad"] == 3.0
    kw = dict(level_iters=(5, 12, 2), plan_pad=4.0)
    assert bench.adapt_schedule(kw, np.asarray([10, 10, 10]), [], {
        "BENCH_ADAPT": "0"}, 1 << 20) == (None, False)


def test_tracker_options_follow_the_knobs():
    tracker, kw = bench.tracker_options({}, 1 << 20)
    assert tracker == "pyr"
    assert kw == dict(curv="flow", level_exact=(0, 0, 0),
                      level_iters=(5, 12, 2), final_level=2, match_blur=True,
                      plan_pad=4.0, pair_capacity_ceiling=1 << 20)
    env = {"BENCH_LEVELS": "4,2", "BENCH_ITERS": "3,4", "BENCH_PROBES": "all",
           "BENCH_CURV": "fd", "BENCH_BF16": "1", "BENCH_MXU": "1",
           "BENCH_TILE16": "1", "BENCH_PAD": "3.5", "BENCH_SIGMA0": "0.02",
           "BENCH_SIGMA_DECAY": "0.5", "BENCH_SUBSET": "1,0.5",
           "BENCH_FINAL_LEVEL": "1"}
    _, kw = bench.tracker_options(env, 1 << 19)
    assert kw["levels"] == (4, 2) and kw["level_iters"] == (3, 4)
    assert kw["level_exact"] == (0, 1)       # follows the level count
    assert kw["probe_levels"] == "all" and kw["curv"] == "fd"
    assert kw["kernel_bf16"] and kw["kernel_mxu"] and kw["tile16"]
    assert kw["plan_pad"] == 3.5 and kw["sigma0"] == 0.02
    assert kw["sigma_decay"] == 0.5 and kw["level_subset"] == (1.0, 0.5)
    assert kw["final_level"] == 1 and kw["pair_capacity_ceiling"] == 1 << 19
    assert bench.tracker_options({"BENCH_TRACKER": "gn"}, 1) == ("gn", {})


def test_refused_knob_combination_raises():
    """tile16 with bf16 is refused by the port's tracker, so by the bench
    too (nothing is dropped silently)."""
    env = dict(TINY_ENV, BENCH_TILE16="1", BENCH_BF16="1")
    with pytest.raises(NotImplementedError):
        bench.run_bench(env=env, **dict(TINY, n_gaussians=200))


def test_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_bench(**dict(TINY, device=None))

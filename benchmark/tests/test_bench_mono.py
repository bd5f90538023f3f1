"""The monocular mapping cell's checks on the CPU at a size a test run
holds, as ``test_bench_checks.py`` holds the RGB-D cell's: the reference
agrees with the program, the control comes out not correct, and each
planted fault comes out not correct. The limits here are set from this
size's own sound run (three times its reading).

The window is 5 keyframes: the covisibility prune takes every Gaussian
seen by 3 or fewer window keyframes, so a smaller window would prune the
whole map. The backend runs in live mode, whose initial bundle adjustment
takes 50 iterations where a recorded stream's takes 300 (the same code
path, a sixth of the CPU time)."""


import time

import pytest
import torch

from benchmark import control, harness
from benchmark.loops import map as map_loop
from benchmark.loops import map_mono
from gs_slam_analytica_jacobian_tpu_torch.slam import backend

torch.set_num_threads(1)
CPU = torch.device("cpu")
CELL = "tum-mono-map"
SEED = 2 ** 31 + 5
GRADS = {"grad_gap.xyz", "grad_gap.features_dc", "grad_gap.opacity",
         "grad_gap.pose", "grad_gap.exposure"}
# control.py's faults and the two the monocular loop plants itself
FAULTS = control.FAULTS + ("prune_coviz", "handover_pose")


def tiny_mono(config, traffic, cell):
    config["camera"] = dict(width=64, height=48, fx=40.0, fy=40.0, cx=31.5,
                            cy=23.5)
    config["world"] = dict(gaussians=3000, seed=0)
    config["Training"].update(init_itr_num=3, window_size=5,
                              mapping_itr_num=3, pair_capacity=1 << 15,
                              initial_capacity=4096)
    # keyframes further apart than the cell's, so that the window's views
    # overlap in part and the prune's 3 -> 4 fault takes Gaussians out
    traffic.update(frames_in_loop=12, step_m=0.04, step_rad=0.1)


@pytest.fixture(autouse=True, scope="module")
def tiny_samples():
    """One checked iteration, the first timed keyframe's hand-over and
    prune checked, a short trace, and the live-mode start-up."""
    mp = pytest.MonkeyPatch()
    mp.setattr(map_loop, "CHECK_ITERS", 1)
    mp.setattr(map_mono, "KF_CHECK_RANGE", (1, 2))
    mp.setattr(map_loop, "CHECK_RANGE", (1, 2))
    mp.setattr(map_loop, "TRACE_KF", 1)
    mp.setattr(map_loop, "TRACE_ITERS", 3)
    init = backend.BackEnd.__init__

    def live(self, *a, **k):
        init(self, *a, **k)
        self.live_mode = True
    mp.setattr(backend.BackEnd, "__init__", live)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def sound(tiny_samples):
    (_, run), = control.readings(CELL, [SEED], 0.1, CPU, overrides=tiny_mono)
    return run


def test_sound_run_is_correct_and_maps(sound):
    vals = {c.name: c.value for c in sound.checks}
    assert GRADS | {"adam_gap", "handover_gap", "prune_gap"} <= set(vals)
    # the test size's sound readings lie far under the cell's limits
    assert all(c.ok for c in sound.checks
               if not c.name.endswith(".control")), vals
    # the map survived the prunes, and each window keyframe pruned
    assert sound.notes["active_gaussians"] > 0
    assert sound.counters["mono_prunes"] == sound.counters["keyframes"]
    assert sound.end_to_end["map_ms_per_iter"] > 0
    # the checked prune took Gaussians out, as the reference did
    prune = sound.notes["keyframe_checks"][0]["prune"]
    assert prune["reference"] > 0 and prune["differ"] == 0, prune


def test_control_is_not_correct(sound):
    """The gradient groups' controls. At this size the bfloat16 falloff
    moves no Gaussian across the touched or opacity thresholds, so the
    hand-over's and the prune's controls read as their sound numbers
    here; PERF.md gives their card readings."""
    vals = {c.name: c.value for c in sound.checks}
    controls = [k for k in vals if k.endswith(".control")
                and k.removesuffix(".control") in GRADS]
    assert len(controls) == len(GRADS)
    assert {"handover_gap.control", "prune_gap.control"} <= set(vals)
    for k in controls:
        base = vals[k.removesuffix(".control")]
        assert vals[k] > 3.0 * base + 1e-12, (k, vals[k], base)


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(sound, fault):
    limits = {c.name: 3.0 * c.value + 1e-9 for c in sound.checks
              if not c.name.endswith(".control")}

    def shrink(config, traffic, cell):
        tiny_mono(config, traffic, cell)
        cell["limits"] = dict(cell["limits"], **limits)
    (_, run), = control.readings(CELL, [SEED], 0.1, CPU, fault=fault,
                                 overrides=shrink)
    checks = [c for c in run.checks if not c.name.endswith(".control")]
    assert checks and not all(c.ok for c in checks), (
        fault, [(c.name, c.value, c.limit) for c in checks])


def test_traced_run_reads_the_spans(tiny_samples, monkeypatch):
    """A traced run keeps the hand-over's and the prune's spans of the
    keyframes before the traced one (here the second), and the span
    readers read them."""
    monkeypatch.setattr(map_loop, "TRACE_KF", 2)
    bench = harness.load_bench()
    wl, config, traffic, cell = harness.resolve(bench, CELL)
    tiny_mono(config, traffic, cell)
    ctx = harness.Context(workload=wl, config=config, traffic=traffic,
                          cell=cell, seed=SEED + 1, seconds=0.1, trace=True,
                          device=CPU, t_start=time.perf_counter())
    run = harness.run_cell(ctx)
    assert len(run.spans["frontend.mono_depth"]) == 1
    assert len(run.spans["backend.covis_prune"]) == 1
    assert run.counters["traced_iters"] == 3
    _, layer = harness.metrics_of(bench, CELL)
    assert {"mono_depth_ms_per_keyframe", "covis_prune_ms_per_keyframe.mono",
            "seed_ms_per_keyframe", "launches_per_iter.map",
            "composite_bwd_roofline_pct", "device_idle_pct.map"} == {
                m["name"] for m in layer}
    assert len(run.spans["seed"]) == 2
    for name in ("mono_depth_ms_per_keyframe",
                 "covis_prune_ms_per_keyframe.mono", "seed_ms_per_keyframe"):
        assert harness.load_reader(name)(run) > 0.0, name

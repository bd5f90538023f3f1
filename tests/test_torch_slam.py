"""The port's live SLAM system (slam/driver.py, slam/frontend.py,
parallel/pipeline.py, slam_main.py) end to end on the CPU.

- Fast smoke: tests/test_slam_e2e.py::test_slam_smoke_fast's config; the
  run closes with a finite ATE under that test's 0.12 m, and writes
  run_summary.json, the ply (which reloads to the same map) and the
  render snapshots.
- CLI: ``python -m gs_slam_analytica_jacobian_tpu_torch.slam_main
  --device cpu --frames 4`` on configs/synthetic/smoke.yaml with its
  eval_rendering off (26000 color-refinement iterations) and the smoke
  test's iteration cuts (init 8, mapping 4); without ``--device`` it
  raises on a machine without a GPU.
- Threaded pipeline: a smoke run, and a backend exception that reaches
  the caller.

The parity run against JAX is tests/test_torch_slam_parity.py, the
monocular and stereo runs tests/test_torch_slam_sensors.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.parallel.pipeline import \
    run_pipelined
from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
from gs_slam_analytica_jacobian_tpu_torch.utils import ply as tply
from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_config(single_thread=True):
    """test_slam_e2e.py::small_config with test_slam_smoke_fast's cuts."""
    cfg = load_config(os.path.join(ROOT, "configs/synthetic/test.yaml"))
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = 64, 48
    cal["fx"] = cal["fy"] = 44.0
    cal["cx"], cal["cy"] = 31.5, 23.5
    ds = cfg["Dataset"]
    ds.update(pcd_downsample_init=4, pcd_downsample=8, motion_scale=0.5,
              n_frames=5, single_thread=single_thread)
    T = cfg["Training"]
    T.update(renderer="tiled", pair_capacity=1 << 14, init_itr_num=8,
             init_gaussian_update=8, init_gaussian_reset=5000,
             tracking_itr_num=5, pyr_iters=[4, 2, 4], mapping_itr_num=4,
             gaussian_update_every=25, gaussian_update_offset=7,
             window_size=4, pose_window=2, initial_capacity=4096,
             kf_capacity=16, monocular=False, kf_translation=0.01,
             kf_min_translation=0.005, kf_overlap=1.0,
             single_thread=single_thread)
    cfg["opt_params"]["densify_grad_threshold"] = 0.01
    cfg["Results"]["save_results"] = False
    return cfg


def test_slam_smoke_fast(tmp_path):
    cfg = smoke_config()
    slam = SLAM(cfg, save_dir=str(tmp_path), device="cpu")
    results = slam.run(n_frames=5)
    assert results["n_frames"] == 5
    assert np.isfinite(results["ate"]) and results["ate"] < 0.12, results
    assert int(slam.backend.gm.num_active()) > 50
    with open(tmp_path / "run_summary.json") as f:
        summary = json.load(f)
    assert summary["n_frames"] == 5 and summary["device"] == "cpu"
    assert summary["keyframe_ids"] == slam.frontend.kf_indices
    assert len(summary["keyframe_ids"]) >= 2
    assert summary["frame_time_breakdown_s"]["n"] == 4
    ply_path = tmp_path / "point_cloud" / "final" / "point_cloud.ply"
    gm = tply.load_ply(str(ply_path), device="cpu")
    act = slam.backend.gm.active
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        assert torch.equal(getattr(gm, f), getattr(slam.backend.gm, f)[act])
    renders = os.listdir(tmp_path / "renders")
    assert any(r.startswith("orbit_") for r in renders)
    assert any(r.startswith("kf") and r.endswith("_color.png")
               for r in renders)


def test_cli_runs_on_cpu(tmp_path):
    cfg_text = open(os.path.join(ROOT, "configs/synthetic/smoke.yaml")
                    ).read()
    for old, new in (("eval_rendering: true", "eval_rendering: false"),
                     ("init_itr_num: 16", "init_itr_num: 8"),
                     ("init_gaussian_update: 16", "init_gaussian_update: 8"),
                     ("mapping_itr_num: 8", "mapping_itr_num: 4")):
        assert old in cfg_text, old
        cfg_text = cfg_text.replace(old, new)
    (tmp_path / "smoke.yaml").write_text(cfg_text)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m",
         "gs_slam_analytica_jacobian_tpu_torch.slam_main", "--config",
         "smoke.yaml", "--device", "cpu", "--frames", "4"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "results")
            for f in fs if f == "run_summary.json"]
    assert len(runs) == 1
    with open(runs[0]) as f:
        summary = json.load(f)
    assert summary["n_frames"] == 4 and np.isfinite(summary["final_ate_m"])


def test_cli_without_device_raises_without_gpu(tmp_path, monkeypatch):
    from gs_slam_analytica_jacobian_tpu_torch import slam_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = os.path.join(ROOT, "configs/synthetic/smoke.yaml")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_main.main(["--config", cfg, "--frames", "1"])
    # the browser viewer is ported: SLAM takes a port and starts the
    # viewer in run() (tests/test_torch_web_viewer.py drives it)
    slam = SLAM(smoke_config(), viewer_port=0, device="cpu")
    assert slam.viewer_port == 0 and slam.web_viewer is None


def test_threaded_pipeline_smoke():
    cfg = smoke_config(single_thread=False)
    cfg["Dataset"]["n_frames"] = 4
    slam = SLAM(cfg, device="cpu")
    results = slam.run(n_frames=4)
    assert results["n_frames"] == 4
    assert np.isfinite(results["ate"]), results
    assert slam.frontend.requested_keyframe == 0
    assert slam.frontend.link is None
    assert len(slam.frontend.frame_log) == 3      # every frame tracked


def test_pipeline_backend_crash_propagates():
    cfg = smoke_config(single_thread=False)
    cfg["Dataset"]["n_frames"] = 4
    slam = SLAM(cfg, device="cpu")

    def boom(idx):
        raise RuntimeError("synthetic backend failure")

    slam.backend.initialize_map = boom
    with pytest.raises(RuntimeError, match="backend thread crashed"):
        run_pipelined(slam.frontend, slam.backend, 4)

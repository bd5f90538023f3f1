"""The port's stereo and monocular SLAM against the JAX package's
``SLAM(interpret=True)``: tests/test_torch_slam_sensors.py's two smoke
configs with test_torch_slam_parity.py's cuts (``pcd_downsample_init: 1``
and ``pcd_downsample: 1``, so seeding keeps every pixel and the two
packages' different random generators draw nothing that matters; no
densify or opacity reset inside the run) and a small frame. The mono
run's initial-depth noise comes from ``np.random.default_rng(seed)`` on
the host in both packages. Checks, as the RGB-D parity test: the same
keyframe ids, every keyframe pose within 2e-3 (t in m, R entries), ATE
within 10%. The monocular case runs from
tests/test_torch_slam_parity_mono.py (a file of its own, so that the two
SLAM runs of each, ~60-70 s of them in JAX interpret mode, land on
different workers).

Measured on the CPU: stereo keyframes [0, 2] in both, keyframe 2 within
2.9e-5 m (t) and 1.4e-4 (R), ATE 0.17251 m against JAX's 0.17250 m; mono
keyframes [0, 2], within 1.2e-6 m and 1.1e-6, ATE 0.027453 m against
0.027453 m. The 0.130 m against 0.1175 m of the stereo smoke runs
(pcd_downsample_init 8 / pcd_downsample 16) is the packages' different
random draws, not a fault."""

import os

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM
from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config

from test_torch_slam import ROOT, smoke_config

torch.set_num_threads(1)


def _parity_cuts(cfg, width, height, focal, n_frames):
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = width, height
    cal["fx"] = cal["fy"] = focal
    cal["cx"], cal["cy"] = (width - 1) / 2.0, (height - 1) / 2.0
    cfg["Dataset"].update(pcd_downsample_init=1, pcd_downsample=1,
                          n_frames=n_frames)
    cfg["Training"].update(gaussian_update_every=1000,
                           gaussian_update_offset=999, gaussian_reset=5000)
    cfg["Results"]["save_results"] = False
    return cfg


def stereo_config():
    """test_slam_stereo_smoke's config at 48x36 (the same field of view),
    where the rig's disparity range is cut from 32 to 16 so that SGBM
    leaves columns with depth (at 48 px, 32 disparities leave 16 and the
    tracker never moves); the largest disparity on the room is ~4.5 px."""
    cfg = load_config(os.path.join(ROOT, "configs/synthetic/stereo_test.yaml"))
    cfg["Training"].update(
        monocular=False, renderer="tiled", pair_capacity=1 << 14,
        init_itr_num=8, init_gaussian_update=8, init_gaussian_reset=5000,
        tracking_itr_num=5, pyr_iters=[4, 2, 4], mapping_itr_num=4,
        window_size=4, pose_window=2, initial_capacity=4096, kf_capacity=16,
        kf_translation=0.01, kf_min_translation=0.005)
    cfg["Dataset"]["num_disparities"] = 16
    return _parity_cuts(cfg, 48, 36, 30.0, 3)


def mono_config():
    """test_slam_mono_smoke's config at 40x32 (the same field of view)."""
    cfg = smoke_config()
    cfg["Dataset"].update(sensor_type="monocular", motion_scale=0.3)
    cfg["Training"]["monocular"] = True
    return _parity_cuts(cfg, 40, 32, 27.5, 3)


def _run_both(make_cfg):
    from gs_slam_analytica_jacobian_tpu.slam.driver import SLAM as JSLAM

    slam_t = SLAM(make_cfg(), device="cpu")
    res_t = slam_t.run()
    slam_j = JSLAM(make_cfg(), interpret=True)
    res_j = slam_j.run()
    return slam_t, res_t, slam_j, res_j


def _check_parity(slam_t, res_t, slam_j, res_j):
    kf_t, kf_j = slam_t.frontend.kf_indices, slam_j.frontend.kf_indices
    assert kf_t == kf_j and len(kf_t) >= 2, (kf_t, kf_j)
    for uid in kf_t:
        rt, rj = slam_t.frontend.frames[uid], slam_j.frontend.frames[uid]
        np.testing.assert_allclose(rt.t, np.asarray(rj.t), atol=2e-3,
                                   rtol=0, err_msg=f"kf {uid} t")
        np.testing.assert_allclose(rt.R, np.asarray(rj.R), atol=2e-3,
                                   rtol=0, err_msg=f"kf {uid} R")
    a, b = res_t["ate"], res_j["ate"]
    assert np.isfinite(a) and abs(a - b) <= max(0.1 * b, 1e-4), (a, b)


def test_slam_stereo_parity_with_jax():
    pytest.importorskip("cv2")
    _check_parity(*_run_both(stereo_config))

"""The port's SLAM against the JAX package's ``SLAM(interpret=True)`` on
tests/test_torch_slam.py's smoke config cut to 40x32 and 3 frames, with
``pcd_downsample_init: 1`` and ``pcd_downsample: 1`` (seeding keeps
every pixel, so the two packages' different random generators draw
nothing that matters) and no densify or opacity reset inside the run.
Checks: the same keyframe ids, every keyframe pose within 2e-3 (t in m,
R entries), ATE within 10%. Measured: keyframe 2 within 6.5e-4 m and
3.4e-4, ATE 0.03883 m against JAX's 0.03923 m (1.0%)."""

import numpy as np
import torch

from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM

from test_torch_slam import smoke_config

torch.set_num_threads(1)


def parity_config():
    cfg = smoke_config()
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = 40, 32
    cal["cx"], cal["cy"] = 19.5, 15.5
    cfg["Dataset"].update(pcd_downsample_init=1, pcd_downsample=1,
                          n_frames=3)
    # no densify or opacity reset inside the run (the split noise comes
    # from each package's own generator)
    cfg["Training"].update(gaussian_update_every=1000,
                           gaussian_update_offset=999, gaussian_reset=5000)
    return cfg


def test_slam_parity_with_jax():
    from gs_slam_analytica_jacobian_tpu.slam.driver import SLAM as JSLAM

    slam_t = SLAM(parity_config(), device="cpu")
    res_t = slam_t.run()
    slam_j = JSLAM(parity_config(), interpret=True)
    res_j = slam_j.run()
    kf_t, kf_j = slam_t.frontend.kf_indices, slam_j.frontend.kf_indices
    assert kf_t == kf_j and len(kf_t) >= 2, (kf_t, kf_j)
    for uid in kf_t:
        rt, rj = slam_t.frontend.frames[uid], slam_j.frontend.frames[uid]
        np.testing.assert_allclose(rt.t, np.asarray(rj.t), atol=2e-3,
                                   rtol=0, err_msg=f"kf {uid} t")
        np.testing.assert_allclose(rt.R, np.asarray(rj.R), atol=2e-3,
                                   rtol=0, err_msg=f"kf {uid} R")
    a, b = res_t["ate"], res_j["ate"]
    assert abs(a - b) <= max(0.1 * b, 1e-4), (a, b)

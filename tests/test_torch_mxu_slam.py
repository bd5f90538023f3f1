"""The port's SLAM under ``Training.kernel_mxu: true`` against the JAX
package's ``SLAM(interpret=True)`` with the same flag, on
tests/test_torch_slam_parity.py's tiny synthetic sequence (40x32, 3
frames, every pixel seeded, no densify or opacity reset inside the run).
The frontend's tracking renders run the MXU bodies (B1'-mxu, and B2-mxu
in its exact iterations) in both packages, through their plain versions
here. Checks, as that test's: the same keyframe ids, every keyframe pose
within 2e-3 (t in m, R entries), ATE within 10%."""

import numpy as np
import torch

from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk
from gs_slam_analytica_jacobian_tpu_torch.slam.driver import SLAM

from test_torch_slam_parity import parity_config

torch.set_num_threads(1)


def mxu_config():
    cfg = parity_config()
    cfg["Training"]["kernel_mxu"] = True
    return cfg


def test_slam_kernel_mxu_parity_with_jax():
    from gs_slam_analytica_jacobian_tpu.slam.driver import SLAM as JSLAM

    slam_t = SLAM(mxu_config(), device="cpu")
    assert slam_t.frontend.kernel_mxu
    before = ttk.composite32_fwd.launches_mxu
    res_t = slam_t.run()
    assert ttk.composite32_fwd.launches_mxu == before   # CPU: plain version
    slam_j = JSLAM(mxu_config(), interpret=True)
    assert slam_j.frontend.kernel_mxu
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

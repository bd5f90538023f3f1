"""The loop generator the cells' traffic reads."""

import numpy as np
import pytest

from benchmark.reference import trajectory


@pytest.mark.parametrize("P,step_m,step_rad", [(64, 6.1e-3, 3.9e-3),
                                               (80, 13.8e-3, 13.6e-3)])
def test_loop_steps_and_closes(P, step_m, step_rad):
    poses = trajectory.loop(P, step_m, step_rad)
    assert len(poses) == P
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-12)
    dt, da = trajectory.step_stats(poses)
    assert abs(dt - step_m) < 1e-9 and abs(da - step_rad) < 1e-6
    for T in poses:
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                                   atol=1e-12)
    # the last frame steps back to the first as any other frame steps on
    steps = [np.linalg.norm(poses[(k + 1) % P][:3, 3] - poses[k][:3, 3])
             for k in range(P)]
    assert max(steps) < 2.0 * step_m

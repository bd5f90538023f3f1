"""The camera's closed loop, the cells' trajectory: P world-to-camera
poses, periodic with their derivatives, so that a stream replayed
cyclically never jumps. The camera centre and its rotation vector are
sums of the first two harmonics of the loop's phase; the translation and
rotation amplitudes are scaled so that the mean step per frame is the
traffic's. The shape is fixed: every seed tracks the same motion, from
another starting frame.
"""

from __future__ import annotations

import math

import numpy as np


def so3_exp_np(w):
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + math.sin(th) / th * K
            + (1 - math.cos(th)) / th ** 2 * K @ K)


def _shape(theta):
    """Camera centre (3,) and rotation vector (3,) at phase theta, before
    scaling."""
    c = np.array([math.sin(theta), 0.5 * math.sin(2 * theta),
                  0.6 * (1 - math.cos(theta))])
    w = np.array([0.5 * (math.sin(theta + 0.7) - math.sin(0.7)),
                  math.sin(theta), 0.3 * math.sin(2 * theta)])
    return c, w


def _mean_steps(cs, Rs):
    n = len(cs)
    dt = np.mean([np.linalg.norm(cs[(k + 1) % n] - cs[k]) for k in range(n)])
    da = np.mean([math.acos(np.clip(
        (np.trace(Rs[(k + 1) % n] @ Rs[k].T) - 1) / 2, -1, 1))
        for k in range(n)])
    return dt, da


def loop(P: int, step_m: float, step_rad: float):
    """P world-to-camera 4x4 float64 poses of the closed loop; frame 0 is
    the identity (the camera at the room's front, looking +z)."""
    raw = [_shape(2 * math.pi * k / P) for k in range(P)]
    cs = [c for c, _ in raw]
    ws = [w for _, w in raw]
    dt, da = _mean_steps(cs, [so3_exp_np(w) for w in ws])
    k = step_rad / da
    for _ in range(3):   # the angle of a scaled rotation vector is not linear
        k *= step_rad / _mean_steps(cs, [so3_exp_np(w * k) for w in ws])[1]
    poses = []
    for c, w in zip(cs, ws):
        Rw = so3_exp_np(w * k)                      # camera to world
        cw = c * (step_m / dt)
        T = np.eye(4)
        T[:3, :3] = Rw.T
        T[:3, 3] = -Rw.T @ cw
        poses.append(T)
    return poses


def step_stats(poses):
    """(mean translation step m, mean rotation step rad) of a cyclic
    sequence of world-to-camera poses."""
    cs = [-T[:3, :3].T @ T[:3, 3] for T in poses]
    Rs = [T[:3, :3] for T in poses]
    return _mean_steps(cs, Rs)

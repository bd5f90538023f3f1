"""Synthetic scenes, made with numpy from a seed: the port's own copies
of the reference's generators, so that the port's scripts need neither
``bench.py`` nor JAX.

- ``make_room_map`` copies ``bench.py::make_room_map`` (bench.py:28-117):
  a converged-map stand-in of thin, high-opacity, surface-aligned,
  procedurally textured splats on the interior of a furnished room.
- ``make_cloud`` copies ``__graft_entry__._scene`` (its numpy part): the
  unstructured Gaussian cloud of the renderer entry workload.
"""

from __future__ import annotations

import numpy as np


def make_room_map(N, rng):
    """Room-map parameters (log/logit space), as ``gaussian_map.from_numpy``
    takes them. Camera looks +z from the room center wall."""
    # (origin, u_vec, v_vec, normal) rectangles, sizes in meters
    surfaces = [
        # back wall z=7
        ((-4.0, -2.5, 7.0), (8.0, 0, 0), (0, 5.0, 0), (0, 0, -1)),
        # left / right walls
        ((-4.0, -2.5, 0.3), (0, 0, 6.7), (0, 5.0, 0), (1, 0, 0)),
        ((4.0, -2.5, 0.3), (0, 0, 6.7), (0, 5.0, 0), (-1, 0, 0)),
        # floor y=+2.5 (y points down in image space) / ceiling y=-2.5
        ((-4.0, 2.5, 0.3), (8.0, 0, 0), (0, 0, 6.7), (0, -1, 0)),
        ((-4.0, -2.5, 0.3), (8.0, 0, 0), (0, 0, 6.7), (0, 1, 0)),
        # furniture: two boxes (front+top faces) and a screen
        ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 1.5, 0), (0, 0, -1)),
        ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 0, 1.0), (0, -1, 0)),
        ((1.0, 0.5, 5.0), (2.0, 0, 0), (0, 2.0, 0), (0, 0, -1)),
        ((1.0, 0.5, 5.0), (0, 0, 1.2), (0, 2.0, 0), (-1, 0, 0)),
        ((-1.0, -1.0, 6.2), (2.2, 0, 0), (0, 1.4, 0), (0, 0, -1)),
    ]
    areas = np.array([np.linalg.norm(np.cross(u, v))
                      for _, u, v, _ in surfaces])
    counts = (areas / areas.sum() * N).astype(int)
    counts[0] += N - counts.sum()

    xyz, quat = [], []
    for (o, u, v, n), c in zip(surfaces, counts):
        a = rng.uniform(size=(c, 1))
        b = rng.uniform(size=(c, 1))
        p = np.asarray(o) + a * np.asarray(u) + b * np.asarray(v)
        # small normal jitter like a real reconstruction
        p = p + np.asarray(n) * rng.normal(0, 0.004, size=(c, 1))
        xyz.append(p)
        # quaternion rotating e_z onto the surface normal
        n = np.asarray(n, np.float64)
        ez = np.array([0.0, 0.0, 1.0])
        axis = np.cross(ez, n)
        s = np.linalg.norm(axis)
        if s < 1e-8:
            q = (np.array([1.0, 0, 0, 0]) if n[2] > 0
                 else np.array([0.0, 1.0, 0, 0]))
        else:
            ang = np.arctan2(s, np.dot(ez, n))
            axis = axis / s
            q = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])
        # random in-plane spin composed via quaternion product q * qz(phi)
        phi = rng.uniform(0, np.pi, c)
        qz = np.stack([np.cos(phi / 2), np.zeros(c), np.zeros(c),
                       np.sin(phi / 2)], -1)
        w1, x1, y1, z1 = q
        w2, x2, y2, z2 = qz[:, 0], qz[:, 1], qz[:, 2], qz[:, 3]
        quat.append(np.stack([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1))
    xyz = np.concatenate(xyz).astype(np.float32)
    quat = np.concatenate(quat).astype(np.float32)

    # surface-disk scales: tangent ~2-5 cm, normal ~3-5 mm (log-normal)
    log_tan = rng.normal(np.log(0.03), 0.35, size=(N, 2))
    log_nrm = rng.normal(np.log(0.004), 0.25, size=(N, 1))
    scaling = np.concatenate([log_tan, log_nrm], -1).astype(np.float32)

    # multi-scale procedural texture: sum of random 3D sinusoids
    col = np.full((N, 3), 0.45, np.float32)
    for _ in range(8):
        omega = rng.normal(size=3)
        omega *= rng.uniform(2.0, 60.0) / np.linalg.norm(omega)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.04, 0.11, 3)
        col += amp * np.sin(xyz @ omega[:, None] + phase[None])
    col = np.clip(col, 0.02, 0.98)
    C0 = 0.28209479177387814
    features_dc = ((col - 0.5) / C0)[:, None, :].astype(np.float32)

    # converged-map opacities: sigmoid(N(2.2, 0.7)) ~ 0.9
    opacity = rng.normal(2.2, 0.7, size=(N, 1)).astype(np.float32)
    return dict(xyz=xyz, features_dc=features_dc,
                features_rest=np.zeros((N, 0, 3), np.float32),
                scaling=scaling, rotation=quat, opacity=opacity)


def make_cloud(n, seed=0):
    """The entry workload's Gaussian cloud: (means, scales, quats,
    opacities, shs) as float32 numpy, activated (linear scales, [0, 1]
    opacities, degree-0 SH)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(0.5, 5.0, size=n)
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 3.5)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    shs = (rng.normal(size=(n, 1, 3)) * 0.3).astype(np.float32)
    return means, scales, quats, opac, shs

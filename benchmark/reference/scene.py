"""The world map the cells render their input frames from: a converged-map
stand-in of thin, high-opacity, surface-aligned, textured splats on the
inside of a furnished room, made on the device from the seed.

Frozen from the program's ``scenes.py`` ``make_room_map`` (itself a copy
of the repository's ``bench.py:28-117``): the same surfaces, counts,
normal jitter, surface-aligned quaternions with a random in-plane spin,
log-normal scales and logit-normal opacities. Two changes keep every seed
the same workload: the draws come from a ``torch.Generator`` on the
device, and the texture's eight sinusoids have a fixed set of spatial
frequencies (2 to 60 per metre, log-spaced) and a fixed amplitude; the
seed draws their directions and phases. The raw parameters are in the
program's storage form (log scales, logit opacities, degree-0 SH).
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814

# (origin, u, v, normal) rectangles in metres; the camera looks +z from
# the middle of the front wall
SURFACES = [
    ((-4.0, -2.5, 7.0), (8.0, 0, 0), (0, 5.0, 0), (0, 0, -1)),
    ((-4.0, -2.5, 0.3), (0, 0, 6.7), (0, 5.0, 0), (1, 0, 0)),
    ((4.0, -2.5, 0.3), (0, 0, 6.7), (0, 5.0, 0), (-1, 0, 0)),
    ((-4.0, 2.5, 0.3), (8.0, 0, 0), (0, 0, 6.7), (0, -1, 0)),
    ((-4.0, -2.5, 0.3), (8.0, 0, 0), (0, 0, 6.7), (0, 1, 0)),
    ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 1.5, 0), (0, 0, -1)),
    ((-2.5, 1.0, 4.0), (1.5, 0, 0), (0, 0, 1.0), (0, -1, 0)),
    ((1.0, 0.5, 5.0), (2.0, 0, 0), (0, 2.0, 0), (0, 0, -1)),
    ((1.0, 0.5, 5.0), (0, 0, 1.2), (0, 2.0, 0), (-1, 0, 0)),
    ((-1.0, -1.0, 6.2), (2.2, 0, 0), (0, 1.4, 0), (0, 0, -1)),
]
TEXTURE_FREQS = [2.0 * 30.0 ** (i / 7.0) for i in range(8)]
TEXTURE_AMP = 0.075


def _surface_quat(n):
    """Quaternion (w, x, y, z) rotating e_z onto the normal ``n``."""
    nx, ny, nz = n
    ax, ay = -ny, nx            # e_z x n
    s = math.hypot(ax, ay)
    if s < 1e-8:
        return (1.0, 0.0, 0.0, 0.0) if nz > 0 else (0.0, 1.0, 0.0, 0.0)
    ang = math.atan2(s, nz)
    return (math.cos(ang / 2), math.sin(ang / 2) * ax / s,
            math.sin(ang / 2) * ay / s, 0.0)


def counts_per_surface(n: int):
    areas = []
    for _, u, v, _ in SURFACES:
        cx = u[1] * v[2] - u[2] * v[1]
        cy = u[2] * v[0] - u[0] * v[2]
        cz = u[0] * v[1] - u[1] * v[0]
        areas.append(math.sqrt(cx * cx + cy * cy + cz * cz))
    tot = sum(areas)
    counts = [int(a / tot * n) for a in areas]
    counts[0] += n - sum(counts)
    return counts


def room_map(n: int, seed: int, device) -> dict:
    """Raw parameters of an ``n``-Gaussian room: xyz (n, 3), features_dc
    (n, 1, 3), scaling (n, 3) log, rotation (n, 4), opacity (n, 1) logit,
    active (n,) bool."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)

    def uni(*shape):
        return torch.rand(*shape, generator=g, **f32)

    def nrm(*shape):
        return torch.randn(*shape, generator=g, **f32)

    xyz, quat = [], []
    for (o, u, v, nn), c in zip(SURFACES, counts_per_surface(n)):
        o_, u_, v_, n_ = (torch.tensor(x, **f32) for x in (o, u, v, nn))
        p = o_ + uni(c, 1) * u_ + uni(c, 1) * v_ + n_ * (0.004 * nrm(c, 1))
        xyz.append(p)
        w1, x1, y1, z1 = _surface_quat(nn)
        phi = math.pi * uni(c)
        w2, z2 = torch.cos(phi / 2), torch.sin(phi / 2)
        quat.append(torch.stack([w1 * w2 - z1 * z2, x1 * w2 + y1 * z2,
                                 y1 * w2 - x1 * z2, w1 * z2 + z1 * w2], -1))
    xyz = torch.cat(xyz)
    quat = torch.cat(quat)
    scaling = torch.cat([math.log(0.03) + 0.35 * nrm(n, 2),
                         math.log(0.004) + 0.25 * nrm(n, 1)], -1)
    col = torch.full((n, 3), 0.45, **f32)
    for freq in TEXTURE_FREQS:
        omega = nrm(3)
        omega = omega * (freq / torch.linalg.norm(omega))
        phase = 2.0 * math.pi * uni(3)
        col = col + TEXTURE_AMP * torch.sin(xyz @ omega[:, None]
                                            + phase[None])
    col = torch.clamp(col, 0.02, 0.98)
    return dict(xyz=xyz, features_dc=((col - 0.5) / SH_C0)[:, None, :],
                scaling=scaling, rotation=quat,
                opacity=2.2 + 0.7 * nrm(n, 1),
                active=torch.ones(n, dtype=torch.bool, device=device))

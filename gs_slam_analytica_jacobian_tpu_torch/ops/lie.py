"""SO(3)/SE(3) exponentials and helpers (torch port of ops/lie.py).

Same small-angle Taylor branches and the same tau ordering convention as
the JAX reference: tau = (rho[3], theta[3]), translation first.
``se3_exp(tau) @ T`` is the left-multiplicative pose update.
"""

from __future__ import annotations

import torch

_SMALL = 1e-5


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) operator. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def _taylor_switch(angle2, exact_fn, taylor):
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    small = angle < _SMALL
    safe = torch.where(small, torch.ones_like(angle), angle)
    return torch.where(small, taylor, exact_fn(safe))


def _sin_over_x(angle2: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with Taylor fallback; angle2 = x**2."""
    return _taylor_switch(angle2, lambda s: torch.sin(s) / s,
                          1.0 - angle2 / 6.0)


def _one_minus_cos_over_x2(angle2: torch.Tensor) -> torch.Tensor:
    """(1-cos(x))/x**2 with Taylor fallback."""
    return _taylor_switch(angle2, lambda s: (1.0 - torch.cos(s)) / (s * s),
                          0.5 - angle2 / 24.0)


def _x_minus_sin_over_x3(angle2: torch.Tensor) -> torch.Tensor:
    """(x-sin(x))/x**3 with Taylor fallback."""
    return _taylor_switch(
        angle2, lambda s: (s - torch.sin(s)) / (s * s * s),
        1.0 / 6.0 - angle2 / 120.0)


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp of so(3). theta: (3,) -> (3, 3)."""
    W = skew(theta)
    W2 = W @ W
    angle2 = torch.sum(theta * theta)
    I = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return I + _sin_over_x(angle2) * W + _one_minus_cos_over_x2(angle2) * W2


def so3_V(theta: torch.Tensor) -> torch.Tensor:
    """Left-Jacobian V(theta) of SO(3)."""
    W = skew(theta)
    W2 = W @ W
    angle2 = torch.sum(theta * theta)
    I = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return (I + _one_minus_cos_over_x2(angle2) * W
            + _x_minus_sin_over_x3(angle2) * W2)


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """exp of se(3). tau = (rho, theta): (6,) -> (4, 4)."""
    rho = tau[:3]
    theta = tau[3:]
    T = torch.eye(4, dtype=tau.dtype, device=tau.device)
    T[:3, :3] = so3_exp(theta)
    T[:3, 3] = so3_V(theta) @ rho
    return T


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> 4x4 homogeneous transform."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def update_pose(tau: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Left-multiplicative retraction T <- Exp(tau) @ T. Returns
    (new_R, new_t, converged) with converged = |tau| < 1e-4 (a 0-d bool
    tensor)."""
    new_T = se3_exp(tau) @ pose_matrix(R, t)
    converged = torch.linalg.norm(tau) < 1e-4
    return new_T[:3, :3], new_T[:3, 3], converged


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix, normalizing first.
    q: (..., 4) -> (..., 3, 3)."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    q = q / norm
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                         2 * (x * z + r * y)], dim=-1),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - r * x)], dim=-1),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )

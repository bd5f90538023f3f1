"""Analytical se(3) pose-Jacobian lab (torch port of ops/jacobians.py).

- Eq. 3, dmu_I/dtau (reference Loss_Derivative_script.py:496-518);
- Eq. 4, dSigma_I/dtau (reference Loss_Derivative_script.py:520-566, as
  structured matrix calculus);
- the per-pixel alpha-blending backward producing dL/dmu_I, dL/dSigma_I,
  dL/ddepth_i, dL/dcolor_i (reference
  Loss_Derivative_script_compare.py:1173-1351);
- the 4-path dL/dtau assembly: mean + covariance + depth + SH view-dir
  (reference Loss_Derivative_script_compare.py:1587-1695).

Conventions: tau = (rho, theta), left-multiplicative perturbation of T_CW,
so dmu_C/dtau = [I | -skew(mu_C)] and dW/dtheta_k acts as -skew on the
columns of R_CW.

Two scaling modes for image-plane units:
- ``exact`` — pixel-space Jacobians with du/d(x/z) = fx (matches autograd
  of the forward);
- ``reference`` — the reference lab's own rescale, diag(2fx/W, 2fy/H) for
  the mean and (K (x) K) with K = diag(fx, fy) for the covariance
  (Loss_Derivative_script_compare.py:723-755), the units of the golden
  fixtures.

Plain tensor code (no kernel): every function runs on whatever device its
inputs lie on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sh as sh_ops
from .lie import skew


def _dmuC_dtau(mu_c: torch.Tensor) -> torch.Tensor:
    """[I | -skew(mu_c)]: (..., 3, 6)."""
    eye = torch.eye(3, dtype=mu_c.dtype, device=mu_c.device)
    return torch.cat([eye.expand(mu_c.shape[:-1] + (3, 3)), -skew(mu_c)],
                     dim=-1)


# ---------------------------------------------------------------------------
# Eq. 3: dmu_I / dtau
# ---------------------------------------------------------------------------

def dmu_dtau_normalized(mu_c: torch.Tensor) -> torch.Tensor:
    """d(mu_I)/d(tau) on the normalized image plane (u = x/z, v = y/z).
    mu_c: (..., 3) camera-frame means -> (..., 2, 6)."""
    x, y, z = mu_c[..., 0], mu_c[..., 1], mu_c[..., 2]
    a = 1.0 / z
    b = -x / (z * z)
    c = -y / (z * z)
    zero = torch.zeros_like(a)
    dmuI_dmuC = torch.stack([torch.stack([a, zero, b], dim=-1),
                             torch.stack([zero, a, c], dim=-1)], dim=-2)
    return dmuI_dmuC @ _dmuC_dtau(mu_c)


# ---------------------------------------------------------------------------
# Eq. 4: dSigma_I / dtau
# ---------------------------------------------------------------------------

def dSigma_dtau_normalized(R_cw: torch.Tensor, cov3d: torch.Tensor,
                           mu_c: torch.Tensor) -> torch.Tensor:
    """d(Sigma_I)/d(tau) on the normalized image plane, Sigma_I = A Sigma3
    A^T with A = J W: dSigma = dA Sigma A^T + A Sigma dA^T, dA_k = (dJ/dmu_c
    dmu_c/dtau_k) W + J dW/dtau_k, dW/drho = 0, dW/dtheta_k = [e_k]x W.

    R_cw: (3, 3); cov3d: (..., 3, 3); mu_c: (..., 3) -> (..., 2, 2, 6)."""
    dt, dev = mu_c.dtype, mu_c.device
    x, y, z = mu_c[..., 0], mu_c[..., 1], mu_c[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    iz3 = iz2 * iz
    zero = torch.zeros_like(x)

    J = torch.stack([torch.stack([iz, zero, -x * iz2], dim=-1),
                     torch.stack([zero, iz, -y * iz2], dim=-1)], dim=-2)

    # dJ/dmu_c: (..., 2, 3, 3) — dJ[i, j] w.r.t. mu_c[k]
    dJ = torch.zeros(mu_c.shape[:-1] + (2, 3, 3), dtype=dt, device=dev)
    dJ[..., 0, 0, 2] = -iz2
    dJ[..., 0, 2, 0] = -iz2
    dJ[..., 0, 2, 2] = 2 * x * iz3
    dJ[..., 1, 1, 2] = -iz2
    dJ[..., 1, 2, 1] = -iz2
    dJ[..., 1, 2, 2] = 2 * y * iz3

    dJ_dtau = torch.einsum("...ijk,...kt->...ijt", dJ, _dmuC_dtau(mu_c))

    E = torch.eye(3, dtype=dt, device=dev)
    gen = torch.stack([skew(E[k]) @ R_cw for k in range(3)])  # (3, 3, 3)
    dW_dtau = torch.cat([torch.zeros(3, 3, 3, dtype=dt, device=dev), gen],
                        dim=0)                                  # (6, 3, 3)

    dA = (torch.einsum("...ijt,jk->...ikt", dJ_dtau, R_cw)
          + torch.einsum("...ij,tjk->...ikt", J, dW_dtau))
    A = J @ R_cw
    SigAT = torch.einsum("...ij,...kj->...ik", cov3d, A)      # (..., 3, 2)
    term1 = torch.einsum("...ikt,...kj->...ijt", dA, SigAT)   # dA Sig A^T
    term2 = term1.transpose(-3, -2)                           # A Sig dA^T
    return term1 + term2


def pose_jacobians(means_world: torch.Tensor, cov3d: torch.Tensor,
                   w2c: torch.Tensor, fx: float, fy: float, width: int,
                   height: int, mode: str = "exact"):
    """Per-Gaussian (dmu_I/dtau (N, 2, 6), dSigma_I/dtau (N, 2, 2, 6)) in
    image units: ``exact`` scales the mean by (fx, fy), ``reference`` by
    (2fx/W, 2fy/H); the covariance takes K (x) K, K = diag(fx, fy), in
    both."""
    R_cw = w2c[:3, :3]
    mu_c = means_world @ R_cw.T + w2c[:3, 3]
    dmu = dmu_dtau_normalized(mu_c)
    dSig = dSigma_dtau_normalized(R_cw, cov3d, mu_c)
    if mode == "exact":
        su, sv = fx, fy
    elif mode == "reference":
        su, sv = 2.0 * fx / width, 2.0 * fy / height
    else:
        raise ValueError(mode)
    scale_mu = torch.tensor([su, sv], dtype=dmu.dtype, device=dmu.device)
    dmu = dmu * scale_mu[None, :, None]
    scale_sig = torch.tensor([[fx * fx, fx * fy], [fy * fx, fy * fy]],
                             dtype=dSig.dtype, device=dSig.device)
    return dmu, dSig * scale_sig[None, :, :, None]


# ---------------------------------------------------------------------------
# Per-pixel alpha-blending backward (the lab's gradient kernel)
# ---------------------------------------------------------------------------

class LabGrads(NamedTuple):
    grad_mu: torch.Tensor        # (N, 2)
    grad_sigma: torch.Tensor     # (N, 2, 2)
    grad_depth: torch.Tensor     # (N,)
    grad_color: torch.Tensor     # (N, 3)


def _pixels(width: int, height: int, dtype, device) -> torch.Tensor:
    ys = torch.arange(height, dtype=dtype, device=device)
    xs = torch.arange(width, dtype=dtype, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([px, py], dim=-1)                      # (H, W, 2)


def _alpha(pix, means2d, cov_inv, opacities):
    d = pix[:, None, :] - means2d[None, :, :]                 # (P, N, 2)
    t = torch.einsum("pni,nij->pnj", d, cov_inv)
    expo = -0.5 * torch.einsum("pni,pni->pn", t, d)
    return d, torch.clamp(opacities[None, :] * torch.exp(expo), 0.0, 1.0)


def _excl_T(alpha):
    T_incl = torch.cumprod(1.0 - alpha, dim=1)
    return torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], dim=1)


def lab_forward_composite(means2d, covs2d, colors, depths, opacities,
                          width: int, height: int):
    """The lab's simple alpha compositing (no 1/255 cutoff, no
    termination, alpha clipped to [0, 1]), Gaussians DEPTH-SORTED front
    to back — Loss_Derivative_script_compare.py:1264-1290. Returns (color
    (H, W, 3), depth (H, W)). Differentiable."""
    pix = _pixels(width, height, means2d.dtype, means2d.device).reshape(-1, 2)
    _, alpha = _alpha(pix, means2d, torch.linalg.inv(covs2d), opacities)
    w = alpha * _excl_T(alpha)
    color = (w @ colors).reshape(height, width, 3)
    depth = (w @ depths[:, None]).reshape(height, width)
    return color, depth


def lab_gradients(means2d, covs2d, colors, depths, opacities,
                  rendered_color, rendered_depth, gt_color, gt_depth, mask,
                  chunk_rows: int = 8) -> LabGrads:
    """Vectorized compute_gradients_2D_vectorized_chunked (reference
    Loss_Derivative_script_compare.py:1173-1351), over chunks of
    ``chunk_rows`` image rows.

    Loss convention: L = sum |C - gt| mask + sum |D - gt_d| (mask & gt_d>0)
    (sign-L1, summed over pixels)."""
    H, W = rendered_depth.shape
    grad_color_pix = torch.sign(rendered_color - gt_color) * mask[..., None]
    depth_valid = (gt_depth > 0.0) & mask
    grad_depth_pix = torch.sign(rendered_depth - gt_depth) * depth_valid
    cov_inv = torch.linalg.inv(covs2d)
    pix_all = _pixels(W, H, means2d.dtype, means2d.device)

    def after(x):
        """'sum after i': reverse-exclusive cumsum along N."""
        rev = torch.flip(torch.cumsum(torch.flip(x, [1]), dim=1), [1])
        return torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], dim=1)

    g_mu = g_sig = g_dep = g_col = 0.0
    for r in range(0, H, chunk_rows):
        pix = pix_all[r:r + chunk_rows].reshape(-1, 2)
        gC = grad_color_pix[r:r + chunk_rows].reshape(-1, 3)
        gD = grad_depth_pix[r:r + chunk_rows].reshape(-1)
        d, alpha = _alpha(pix, means2d, cov_inv, opacities)
        T = _excl_T(alpha)
        aT = alpha * T                                         # (P, N)

        g_dep = g_dep + torch.sum(aT * gD[:, None], dim=0)
        g_col = g_col + torch.sum(aT[:, :, None] * gC[:, None, :], dim=0)

        color_after = after(colors[None] * aT[..., None])      # (P, N, 3)
        depth_after = after(depths[None] * aT)                 # (P, N)
        safe = torch.where(alpha < 0.999, 1.0 - alpha,
                           torch.ones_like(alpha))
        dC_da = colors[None] * T[..., None] - color_after / safe[..., None]
        dD_da = depths[None] * T - depth_after / safe
        dL_da = (torch.einsum("pi,pni->pn", gC, dC_da) + gD[:, None] * dD_da)

        da_dmu = alpha[..., None] * torch.einsum("nij,pnj->pni", cov_inv, d)
        g_mu = g_mu + torch.sum(dL_da[..., None] * da_dmu, dim=0)

        douter = torch.einsum("pni,pnj->pnij", d, d)
        tmp = torch.einsum("nij,pnjk->pnik", cov_inv, douter)
        da_dSig = 0.5 * alpha[..., None, None] * torch.einsum(
            "pnij,njk->pnik", tmp, cov_inv)
        g_sig = g_sig + torch.sum(dL_da[..., None, None] * da_dSig, dim=0)
    return LabGrads(grad_mu=g_mu, grad_sigma=g_sig, grad_depth=g_dep,
                    grad_color=g_col)


# ---------------------------------------------------------------------------
# dL/dtau assembly (4 paths)
# ---------------------------------------------------------------------------

def sh_viewdir_tau_grad(means_world, shs, sh_degree: int, campos,
                        grad_color) -> torch.Tensor:
    """SH view-direction path: the reference's translation-only
    approximation (backward.cu:141-144; compare script 1636-1660).
    grad_color: (N, 3) dL/dc_i with the clamp mask applied. Returns (6,)
    with only the rho components populated."""
    with torch.enable_grad():
        dirs = (means_world - campos[None]).detach().requires_grad_()
        n = torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8
        color = sh_ops.eval_sh(sh_degree, shs.detach(), dirs / n)
        (dL_ddir,) = torch.autograd.grad(color, dirs, grad_color.detach())
    out = torch.zeros(6, dtype=means_world.dtype, device=means_world.device)
    out[:3] = -torch.sum(dL_ddir, dim=0)
    return out


def assemble_dL_dtau(grads: LabGrads, dmu_dtau, dsig_dtau, mu_c, sh_term):
    """Total dL/dtau = mu-path + cov-path + depth-path + SH-path
    (reference Loss_Derivative_script_compare.py:1613-1683); the depth
    path is dd/dtau = [0, 0, 1, p_C.y, -p_C.x, 0]. Returns (total (6,),
    breakdown dict)."""
    mu_term = torch.einsum("ni,nit->t", grads.grad_mu, dmu_dtau)
    cov_term = torch.einsum("nij,nijt->t", grads.grad_sigma, dsig_dtau)
    zero = torch.zeros_like(mu_c[:, 0])
    dd_dtau = torch.stack([zero, zero, torch.ones_like(zero), mu_c[:, 1],
                           -mu_c[:, 0], zero], dim=-1)
    depth_term = torch.einsum("n,nt->t", grads.grad_depth, dd_dtau)
    total = mu_term + cov_term + depth_term + sh_term
    return total, dict(mu=mu_term, cov=cov_term, depth=depth_term,
                       sh=sh_term)

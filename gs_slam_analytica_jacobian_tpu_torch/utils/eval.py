"""Evaluation: ATE RMSE (Umeyama-aligned APE) + rendering metrics (torch
port of utils/eval.py).

The trajectory statistics are numpy on the host, as in the reference;
``lpips_proxy`` is the same fixed-seed random-feature network in torch,
and ``eval_rendering`` scores renders with the port's PSNR and SSIM. The
trajectory plot stays optional on matplotlib.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import losses
from ..utils.logging import Log


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool):
    """Least-squares similarity transform aligning x (3,N) onto y (3,N).
    Returns (R, t, c). Standard Umeyama 1991 (what evo uses)."""
    mu_x = x.mean(axis=1, keepdims=True)
    mu_y = y.mean(axis=1, keepdims=True)
    var_x = np.mean(np.sum((x - mu_x) ** 2, axis=0))
    cov = (y - mu_y) @ (x - mu_x).T / x.shape[1]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = np.trace(np.diag(d) @ S) / var_x if with_scale else 1.0
    t = mu_y - c * R @ mu_x
    return R, t[:, 0], c


def ate_rmse(traj_est: List[np.ndarray], traj_gt: List[np.ndarray],
             align_scale: bool = False) -> float:
    """ATE RMSE of estimated vs gt c2w poses (4x4), with SE(3)/Sim(3)
    alignment (reference evaluate_evo, eval_utils.py:25-65)."""
    p_est = np.stack([T[:3, 3] for T in traj_est], axis=1)   # (3, N)
    p_gt = np.stack([T[:3, 3] for T in traj_gt], axis=1)
    if not np.all(np.isfinite(p_est)):
        Log("WARNING: non-finite poses in estimated trajectory", tag="Eval")
        return float("nan")
    if p_est.shape[1] < 3:
        # degenerate trajectory: unaligned RMSE
        err = np.linalg.norm(p_est - p_gt, axis=0)
        return float(np.sqrt(np.mean(err ** 2)))
    R, t, c = umeyama_alignment(p_est, p_gt, align_scale)
    aligned = c * R @ p_est + t[:, None]
    err = np.linalg.norm(aligned - p_gt, axis=0)
    return float(np.sqrt(np.mean(err ** 2)))


def _plot_trajectory(trj_est, trj_gt, ate, path):
    """Top-down (x-z) trajectory plot, the role of evo's plot dump
    (reference eval_utils.py:42-63)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib is baked in
        return
    est = np.stack([T[:3, 3] for T in trj_est])
    gt = np.stack([T[:3, 3] for T in trj_gt])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt[:, 0], gt[:, 2], "k--", label="ground truth")
    ax.plot(est[:, 0], est[:, 2], "b-", marker="o", ms=3,
            label="estimate")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(f"ATE RMSE {ate * 100:.2f} cm")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def eval_ate(frames: Dict[int, object], kf_ids: List[int], save_dir=None,
             iterations: int = 0, final: bool = False,
             monocular: bool = False, correct_scale=None) -> float:
    """reference eval_ate (eval_utils.py:68-113): keyframe-trajectory APE,
    with trajectory JSON + plot dumps under save_dir/plot/."""
    trj_est, trj_gt = [], []

    def c2w(R, t):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        return np.linalg.inv(T)

    for kf_id in kf_ids:
        rec = frames[kf_id]
        trj_est.append(c2w(rec.R, rec.t))
        trj_gt.append(c2w(rec.R_gt, rec.t_gt))
    if correct_scale is None:
        correct_scale = monocular
    ate = ate_rmse(trj_est, trj_gt, align_scale=correct_scale)
    Log(f"ATE RMSE [m]: {ate:.6f} ({len(kf_ids)} keyframes)", tag="Eval")
    if save_dir is not None:
        label = "final" if final else str(iterations)
        plot_dir = os.path.join(save_dir, "plot")
        os.makedirs(plot_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"ate_{label}.json"), "w") as f:
            json.dump(dict(ate_rmse=ate, n_kf=len(kf_ids)), f)
        # trajectory dump (reference writes trj_final.json via
        # eval_utils.py:42-63)
        with open(os.path.join(plot_dir, f"trj_{label}.json"), "w") as f:
            json.dump(dict(
                trj_id=list(map(int, kf_ids)),
                trj_est=[T.tolist() for T in trj_est],
                trj_gt=[T.tolist() for T in trj_gt]), f)
        _plot_trajectory(trj_est, trj_gt, ate,
                         os.path.join(plot_dir, f"trj_{label}.png"))
    return ate


_LPIPS_PROXY_WEIGHTS = None


def _lpips_proxy_net():
    """Fixed-seed random-feature conv pyramid for the LPIPS proxy.

    3 conv layers (3->16->32->64 ch, stride 2, 3x3, He-init from a fixed
    seed) — deterministic, weight-free (no pretrained download). Random
    multi-scale conv features correlate with perceptual similarity well
    above pixel metrics (the LPIPS paper's own random-init baseline),
    but this is NOT trained LPIPS(alex) — results are labeled
    ``mean_lpips_proxy`` and are comparable only within this framework.
    """
    global _LPIPS_PROXY_WEIGHTS
    if _LPIPS_PROXY_WEIGHTS is None:
        rng = np.random.default_rng(1234)
        shapes = [(16, 3, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3)]
        _LPIPS_PROXY_WEIGHTS = [
            rng.normal(0.0, np.sqrt(2.0 / (s[1] * s[2] * s[3])),
                       size=s).astype(np.float32)
            for s in shapes]
    return _LPIPS_PROXY_WEIGHTS


def _pad_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """XLA's ``padding="SAME"`` for a k x k kernel at ``stride``: the
    total padding of each axis is max((ceil(n/s) - 1) s + k - n, 0), the
    smaller half before (0 before and 1 after on an even size at k 3,
    stride 2, where conv2d(padding=1) would pad 1 and 1)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def lpips_proxy(img1: torch.Tensor, img2: torch.Tensor) -> float:
    """LPIPS-style perceptual distance from a FIXED RANDOM network
    (see _lpips_proxy_net): per-layer unit-normalized feature diffs,
    spatially averaged, summed over layers (the LPIPS formula,
    reference eval_utils.py:137-160 uses trained AlexNet weights which
    cannot be fetched in a zero-egress environment).

    Inputs (3,H,W) in [0,1]. Returns a python float >= 0; 0 iff equal.
    """
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32, device=a.device)
    xa, xb = a[None] * 2.0 - 1.0, b[None] * 2.0 - 1.0
    total = torch.zeros((), device=a.device)
    with torch.no_grad():
        for w_np in _lpips_proxy_net():
            w = torch.as_tensor(w_np, device=a.device)
            xa = F.relu(F.conv2d(_pad_same(xa), w, stride=2))
            xb = F.relu(F.conv2d(_pad_same(xb), w, stride=2))
            na = xa / (torch.linalg.norm(xa, dim=1, keepdim=True) + 1e-8)
            nb = xb / (torch.linalg.norm(xb, dim=1, keepdim=True) + 1e-8)
            total = total + torch.mean(torch.sum((na - nb) ** 2, dim=1))
    return float(total)


def eval_rendering(frames, kf_ids, dataset, render_fn, save_dir=None,
                   iteration="final", every_n: int = 5) -> dict:
    """PSNR/SSIM over every-5th non-keyframe frame (reference
    eval_rendering, eval_utils.py:116-180; LPIPS omitted — no pretrained
    weights in a zero-egress environment)."""
    psnrs, ssims, lpips_p = [], [], []
    kf_set = set(kf_ids)
    end = len(frames) - 1
    for idx in range(0, end, every_n):
        if idx in kf_set:
            continue
        rec = frames[idx]
        image, _, _ = dataset[idx]
        out = render_fn(rec)
        img = torch.clamp(out.color, 0, 1)
        gt = torch.as_tensor(np.asarray(image, np.float32), device=img.device)
        psnrs.append(float(losses.psnr(img, gt)))
        ssims.append(float(losses.ssim(img, gt)))
        lpips_p.append(lpips_proxy(img, gt))
    result = dict(
        mean_psnr=float(np.mean(psnrs)) if psnrs else float("nan"),
        mean_ssim=float(np.mean(ssims)) if ssims else float("nan"),
        # trained LPIPS(alex) requires pretrained weights; this
        # environment has no torchvision/torchmetrics and no network
        # egress, so that column stays null and a clearly-labeled
        # weight-free proxy (fixed random-feature net, see lpips_proxy)
        # fills the perceptual-metric role
        mean_lpips=None,
        mean_lpips_proxy=(float(np.mean(lpips_p)) if lpips_p
                          else float("nan")),
        lpips_note="mean_lpips (trained alexnet) unavailable without "
                   "pretrained weights (zero-egress environment); "
                   "mean_lpips_proxy is a fixed-seed random-feature "
                   "perceptual distance (lower is better, scale not "
                   "comparable to trained LPIPS)",
        n_frames=len(psnrs))
    Log(f"PSNR: {result['mean_psnr']:.3f}  SSIM: {result['mean_ssim']:.4f} "
        f"({result['n_frames']} frames)", tag="Eval")
    if save_dir is not None:
        # per-iteration psnr dir, like the reference's save_dir/psnr/
        # (eval_utils.py:172-179)
        psnr_dir = os.path.join(save_dir, "psnr", str(iteration))
        os.makedirs(psnr_dir, exist_ok=True)
        with open(os.path.join(psnr_dir, "final_result.json"), "w") as f:
            json.dump(result, f)
        with open(os.path.join(save_dir, f"render_{iteration}.json"),
                  "w") as f:
            json.dump(result, f)
    return result

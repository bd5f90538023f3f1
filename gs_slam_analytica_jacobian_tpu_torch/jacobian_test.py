#!/usr/bin/env python
"""Analytical-Jacobian verification entry point of the PyTorch port
(counterpart of the repository's root ``jacobian_test.py``).

Loads the small Gaussian fixture, perturbs the ground-truth pose with its
noise transform, renders with the lab's compositing, runs the vectorized
per-pixel gradient pass, assembles the analytic 4-path dL/dtau (mean +
covariance + depth + SH view-dir) and compares it with torch autograd of
the same lab loss through the port's ``preprocess``.

Without arguments it runs on the committed 15-Gaussian fixture
(tests/fixtures/jacobian_fixture.npz) on the GPU:

    python -m gs_slam_analytica_jacobian_tpu_torch.jacobian_test \
        [--mode exact|reference] [--device cpu]

``--pt`` with ``--ref-data`` builds the fixture from the reference's own
artifacts (a TorchScript Gaussian checkpoint and a NOCS frame directory)
instead.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .device import resolve_device
from .ops import camera_math as cm
from .ops import gaussian_math as gm
from .ops import jacobians as jac
from .ops import sh as sh_ops
from .ops.lie import se3_exp

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "jacobian_fixture.npz")

# named parameters of a reference checkpoint, in order
# (gaussian_splatting/scene/gaussian_model.py:70-138, load_tensors)
_PT_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation")


def load_fixture(path: str = FIXTURE):
    d = np.load(path)
    return {k: d[k] for k in d.files}


def load_pt_tensors(path: str):
    """torch.jit.load a reference checkpoint -> dict of numpy arrays."""
    mod = torch.jit.load(path, map_location="cpu")
    tensors = [p.detach().cpu().numpy() for _, p in mod.named_parameters()]
    if len(tensors) < 6:
        raise ValueError(
            f"expected >= 6 parameters in {path}, got {len(tensors)}")
    out = dict(zip(_PT_FIELDS, tensors[:6]))
    if out["features_dc"].ndim == 2:                    # (N,3) -> (N,1,3)
        out["features_dc"] = out["features_dc"][:, None, :]
    return out


def load_reference_fixture(pt_path, data_dir, fx=577.5, fy=577.5, cx=319.5,
                           cy=239.5):
    """Build the lab fixture from reference artifacts: a TorchScript
    Gaussian checkpoint (e.g. optimized_params_small.pt) plus a directory
    holding w2c_gt.txt / T_noise.txt (Jacob_test_result format) and the
    NOCS frame as color/depth/mask .npy (or .png)."""
    t = load_pt_tensors(pt_path)
    n = t["xyz"].shape[0]
    k_rest = t["features_rest"].shape[1]
    features = np.zeros((n, 1 + k_rest, 3), np.float32)
    features[:, :1] = t["features_dc"]
    if k_rest:
        features[:, 1:] = t["features_rest"]

    def _load_img(stem):
        p = os.path.join(data_dir, stem + ".npy")
        if os.path.exists(p):
            return np.load(p)
        from PIL import Image
        p = os.path.join(data_dir, stem + ".png")
        return np.asarray(Image.open(p), np.float32) / 255.0

    w2c_gt = np.loadtxt(os.path.join(data_dir, "w2c_gt.txt")
                        ).astype(np.float32)
    T_noise = np.loadtxt(os.path.join(data_dir, "T_noise.txt")
                         ).astype(np.float32)
    return dict(
        xyz=t["xyz"], scaling=t["scaling"], rotation=t["rotation"],
        opacity=t["opacity"], features=features, w2c_gt=w2c_gt,
        T_noise=T_noise, gt_color=_load_img("color").astype(np.float32),
        gt_depth=np.asarray(_load_img("depth"), np.float32),
        mask=np.asarray(_load_img("mask")) > 0.5, fx=fx, fy=fy, cx=cx, cy=cy)


def _cov_matrix(cov2d):
    return torch.stack(
        [torch.stack([cov2d[:, 0], cov2d[:, 1]], -1),
         torch.stack([cov2d[:, 1], cov2d[:, 2]], -1)], -2)


def run(fix, mode: str = "reference", verbose: bool = True, device=None):
    """The lab's analytic dL/dtau and the autograd dL/dtau of the same
    loss at the fixture's noisy pose. ``device=None`` means CUDA."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    means = t(fix["xyz"])
    scales = t(fix["scaling"])            # log-space
    quats = t(fix["rotation"])
    opac = torch.sigmoid(t(fix["opacity"]))[:, 0]
    shs = t(fix["features"])              # (N, 16, 3)
    w2c_np = (np.asarray(fix["w2c_gt"], np.float32)
              @ np.asarray(fix["T_noise"], np.float32))
    gt_color = t(fix["gt_color"])         # (H, W, 3)
    gt_depth = t(fix["gt_depth"])         # (H, W)
    mask = t(fix["mask"])                 # (H, W) bool
    fx, fy, cx, cy = [float(fix[k]) for k in ("fx", "fy", "cx", "cy")]
    H, W = gt_depth.shape

    w2c = t(w2c_np)
    proj = t(cm.projection_matrix(0.01, 100.0, cx, cy, fx, fy, W, H))
    tanfovx, tanfovy = W / (2 * fx), H / (2 * fy)
    cov6 = gm.build_cov3d(torch.exp(scales), quats)
    cov3d = gm.cov3d_to_matrix(cov6)
    zero6 = torch.zeros(6, device=dev)

    # ---- lab forward: project to pixel space, depth-sort, composite ----
    R_cw = w2c[:3, :3]
    mu_c = means @ R_cw.T + w2c[:3, 3]
    order = torch.sort(mu_c[:, 2], stable=True).indices
    campos = -R_cw.T @ w2c[:3, 3]

    prep = gm.preprocess(means, cov6, opac, shs, 3, w2c, proj, zero6, fx, fy,
                         W, H, tanfovx, tanfovy)
    cov2d = _cov_matrix(prep.cov2d)
    colors, depths = prep.color, prep.depth
    C_img, D_img = jac.lab_forward_composite(
        prep.mean2d[order], cov2d[order], colors[order], depths[order],
        opac[order], W, H)
    grads = jac.lab_gradients(
        prep.mean2d[order], cov2d[order], colors[order], depths[order],
        opac[order], C_img, D_img, gt_color, gt_depth, mask)
    inv = torch.argsort(order)
    grads = jac.LabGrads(grads.grad_mu[inv], grads.grad_sigma[inv],
                         grads.grad_depth[inv], grads.grad_color[inv])

    dmu, dsig = jac.pose_jacobians(means, cov3d, w2c, fx, fy, W, H,
                                   mode=mode)
    gcol = torch.where(colors > 0.0, grads.grad_color,
                       torch.zeros_like(grads.grad_color))
    sh_term = jac.sh_viewdir_tau_grad(means, shs, 3, campos, gcol)
    total, parts = jac.assemble_dL_dtau(grads, dmu, dsig, mu_c, sh_term)

    # ---- autograd dL/dtau of the SAME lab loss ----
    tau = torch.zeros(6, device=dev, requires_grad=True)
    w2c_eff = se3_exp(tau) @ w2c
    prep_t = gm.preprocess(means, cov6, opac, shs, 3, w2c_eff, proj, zero6,
                           fx, fy, W, H, tanfovx, tanfovy)
    # the reference's SH-campos convention: stop_grad(campos) + rho
    dirs = means - (campos.detach() + tau[:3])[None]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-8)
    colors_t = torch.clamp(sh_ops.eval_sh(3, shs, dirs) + 0.5, min=0.0)
    C, D = jac.lab_forward_composite(
        prep_t.mean2d[order], _cov_matrix(prep_t.cov2d)[order],
        colors_t[order], prep_t.depth[order], opac[order], W, H)
    L = (torch.sum(torch.abs(C - gt_color) * mask[..., None])
         + torch.sum(torch.abs(D - gt_depth) * (mask & (gt_depth > 0))))
    (ad_tau,) = torch.autograd.grad(L, tau)

    to_np = lambda x: x.detach().cpu().numpy()  # noqa: E731
    if verbose:
        print("=== dL/dtau breakdown (analytic 4-path assembly) ===")
        for k, v in parts.items():
            print(f"  {k:6s}: {to_np(v)}")
        print(f"  total : {to_np(total)}")
        print(f"  autodiff (lab loss at tau=0): {to_np(ad_tau)}")
        err = np.abs(to_np(total) - to_np(ad_tau))
        print(f"  |analytic - autodiff| = {err}  (mode={mode})")
    return dict(total=to_np(total), autodiff=to_np(ad_tau),
                parts={k: to_np(v) for k, v in parts.items()},
                grads=jac.LabGrads(*[to_np(g) for g in grads]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="exact", choices=["exact", "reference"],
                   help="'exact' matches autodiff; 'reference' uses the "
                        "reference lab's NDC mean rescale (golden units)")
    p.add_argument("--fixture", default=FIXTURE)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' to run there)")
    p.add_argument("--pt", default=None,
                   help="reference TorchScript gaussian checkpoint "
                        "(optimized_params_small.pt); requires --ref-data")
    p.add_argument("--ref-data", default=None,
                   help="dir with w2c_gt.txt, T_noise.txt and the NOCS "
                        "frame (color/depth/mask as .npy or .png)")
    args = p.parse_args(argv)
    if args.pt is not None:
        if not args.ref_data:
            p.error("--pt requires --ref-data")
        fix = load_reference_fixture(args.pt, args.ref_data)
    else:
        fix = load_fixture(args.fixture)
    out = run(fix, mode=args.mode, device=args.device)
    if args.mode == "exact":
        err = np.abs(out["total"] - out["autodiff"]).max()
        rel = err / (np.abs(out["autodiff"]).max() + 1e-12)
        print(f"max abs err {err:.3e} (rel {rel:.3e})")
        if rel >= 5e-3:
            print("FAIL: analytic-vs-autodiff mismatch")
            return 1
        print("PASS: analytic dL/dtau matches autodiff")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Plain PyTorch reference of one keyframe-window mapping iteration: the
gradient of the window's mapping loss in every Gaussian parameter, in each
keyframe's pose and exposure, and the Adam step the map takes with it.

Frozen from the program's ``slam/mapping.py`` ``_mapping_iter``,
``ops/losses.py`` (``loss_mapping_rgbd``, ``isotropic_loss``,
``apply_exposure``), ``models/gaussian_map.py`` ``adam_update`` and the
keyframe store's quantization (``KFStore.add``): every valid frame of the
window renders at its stored pose (moved by Exp(tau) at tau = 0) and adds
alpha |exp(a) C + b - I| (masked where the image is not black) and
(1 - alpha) |D - D_gt| (where the depth is valid) as means over the
image; 10 times the isotropic scale term is added once. The renders and
their backward are ``reference/render.py``'s.
"""

from __future__ import annotations

import torch

from . import render as rr

FIELDS = ("xyz", "features_dc", "scaling", "rotation", "opacity")


def quantized(image, depth):
    """The keyframe store's round trip of a (3, H, W) image in [0, 1]
    (u8) and a (1, H, W) depth (16-bit codes of max / 65535)."""
    img = torch.round(torch.clamp(image, 0.0, 1.0) * 255.0).to(
        torch.uint8).to(torch.float32) * (1.0 / 255.0)
    dmax = torch.amax(depth)
    zero = torch.zeros_like(dmax)
    scale = torch.where(dmax > 0, dmax / 65535.0, zero)
    codes = torch.round(depth * torch.where(
        dmax > 0, 65535.0 / torch.clamp(dmax, min=1e-9), zero)).to(
        torch.int32)
    return img, codes.to(torch.float32) * scale


def isotropic_loss(log_scaling, active):
    s = torch.exp(log_scaling)
    dev = torch.abs(s - torch.mean(s, dim=1, keepdim=True))
    w = active.to(s.dtype)[:, None]
    return torch.sum(dev * w) / torch.clamp(torch.sum(w) * 3.0, min=1.0)


def window_grads(params: dict, active, views, cam: rr.Cam, alpha: float,
                 rgb_boundary_threshold: float, bf16: bool = False):
    """Gradients of one iteration's loss. ``params``: the map's raw fields
    (detached); ``views``: per valid frame (R, t, exposure a, b, image,
    depth). Returns ({field: grad}, [(g_tau (6,), g_a, g_b)], loss)."""
    leaves = {f: params[f].detach().clone().requires_grad_() for f in FIELDS}
    scene = dict(leaves, active=active)
    H, W = cam.height, cam.width
    n3, n1 = 3.0 * H * W, float(H * W)
    total = torch.zeros((), device=active.device)
    per_view = []
    for R, t, ea0, eb0, img, depth in views:
        tau = torch.zeros(6, device=active.device, requires_grad=True)
        ea = ea0.detach().clone().requires_grad_()
        eb = eb0.detach().clone().requires_grad_()
        gt_flat = img.reshape(3, -1)
        gd_flat = depth.reshape(-1)
        rgb_mask = (gt_flat.sum(dim=0) > rgb_boundary_threshold).float()
        d_mask = (gd_flat > 0.01).float()

        def pixel_loss(color, dsum, T, pix, ea=ea, eb=eb, gt_flat=gt_flat,
                       gd_flat=gd_flat, rgb_mask=rgb_mask, d_mask=d_mask):
            ok = pix >= 0
            p = torch.where(ok, pix, torch.zeros_like(pix))
            gi = gt_flat[:, p].permute(1, 0, 2)                  # (n, 3, P)
            m = (rgb_mask[p] * ok)[:, None]
            img_ab = torch.exp(ea) * color + eb
            l_rgb = torch.abs(img_ab * m - gi * m).sum() / n3
            dm = d_mask[p] * ok
            l_d = torch.abs(dsum * dm - gd_flat[p] * dm).sum() / n1
            return alpha * l_rgb + (1.0 - alpha) * l_d

        loss = rr.render_grad(scene, cam.at(R, t), pixel_loss, tau=tau,
                              bf16=bf16)
        total = total + loss
        per_view.append((tau.grad.clone(), ea.grad.clone(),
                         eb.grad.clone()))
    iso = 10.0 * isotropic_loss(leaves["scaling"], active)
    iso.backward()
    total = total + iso.detach()
    grads = {f: (leaves[f].grad if leaves[f].grad is not None
                 else torch.zeros_like(leaves[f])) for f in FIELDS}
    return grads, per_view, total


def adam_step(p, g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-15):
    """torch.optim.Adam's step at ``step`` (the new step count) from the
    moments before it: returns the new parameter."""
    t = torch.as_tensor(step, dtype=torch.float32)
    m1 = b1 * m + (1 - b1) * g
    v1 = b2 * v + (1 - b2) * (g * g)
    return p - lr * (m1 / (1.0 - b1 ** t)) / (
        torch.sqrt(v1 / (1.0 - b2 ** t)) + eps)

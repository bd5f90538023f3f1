"""Plain PyTorch reference of one monocular keyframe-window mapping
iteration: the gradient of the window's RGB-only mapping loss in every
Gaussian parameter and in each keyframe's pose and exposure. The Adam
step and the keyframe store's quantization are ``mapping.py``'s
(``adam_step``, ``quantized``), the renders and their backward
``render.py``'s.

Frozen from the program's ``slam/mapping.py`` ``_mapping_iter`` with
``monocular`` set and ``ops/losses.py`` ``loss_mapping_rgb``: every valid
frame of the window renders at its stored pose (moved by Exp(tau) at
tau = 0) and adds |exp(a) C + b - I|, masked where the image is not
black, as a mean over 3 H W; 10 times the isotropic scale term is added
once. Where it departs from ``loss_mapping_rgb``: the mean is summed over
chunks of pixels as the reference renderer hands them over (the same
value, other float32 rounding); the mask multiplies both terms as the
program's does, so a masked pixel adds exactly 0; the exposure is applied
inside the chunk. There is no depth term and no ``alpha``: a monocular
keyframe has no sensor depth.

Two more pieces of the monocular keyframe, written from MonoGS's
semantics (``slam_frontend.py`` ``add_new_keyframe``, ``slam_backend.py``
``prune_mode: slam``): ``seeding_stats``, the valid-pixel count, median
and standard deviation a keyframe's seeding depth is drawn around, from a
render of the map at the keyframe's pose; ``touched`` and
``covisibility_prune``, the Gaussians the window's covisibility prune
takes out. ``touched`` walks ``render.py``'s pair lists as ``walk`` does
and keeps, per pair, whether some pixel blends it with the transmittance
after the blend above 0.5 (the rasteriser's ``n_touched`` > 0).
"""

from __future__ import annotations

import numpy as np
import torch

from . import render as rr
from .mapping import FIELDS, adam_step, isotropic_loss, quantized

__all__ = ["FIELDS", "adam_step", "covisibility_prune", "quantized",
           "seeding_stats", "touched", "window_grads"]
PRUNE_COVIZ = 3       # a Gaussian seen by this many window keyframes or
                      # fewer is pruned


def window_grads(params: dict, active, views, cam: rr.Cam,
                 rgb_boundary_threshold: float, bf16: bool = False):
    """Gradients of one iteration's loss. ``params``: the map's raw fields
    (detached); ``views``: per valid frame (R, t, exposure a, b, image).
    Returns ({field: grad}, [(g_tau (6,), g_a, g_b)], loss)."""
    leaves = {f: params[f].detach().clone().requires_grad_() for f in FIELDS}
    scene = dict(leaves, active=active)
    n3 = 3.0 * cam.height * cam.width
    total = torch.zeros((), device=active.device)
    per_view = []
    for R, t, ea0, eb0, img in views:
        tau = torch.zeros(6, device=active.device, requires_grad=True)
        ea = ea0.detach().clone().requires_grad_()
        eb = eb0.detach().clone().requires_grad_()
        gt_flat = img.reshape(3, -1)
        rgb_mask = (gt_flat.sum(dim=0) > rgb_boundary_threshold).float()

        def pixel_loss(color, dsum, T, pix, ea=ea, eb=eb, gt_flat=gt_flat,
                       rgb_mask=rgb_mask):
            ok = pix >= 0
            p = torch.where(ok, pix, torch.zeros_like(pix))
            gi = gt_flat[:, p].permute(1, 0, 2)                  # (n, 3, P)
            m = (rgb_mask[p] * ok)[:, None]
            img_ab = torch.exp(ea) * color + eb
            return torch.abs(img_ab * m - gi * m).sum() / n3

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


def seeding_stats(image, depth, opacity, rgb_boundary_threshold: float):
    """(n_valid, median, std) of a monocular keyframe's seeding depth:
    over the pixels whose render has depth > 0 and opacity > 0.95 and
    whose image (3, H, W) is not black; (0, 2.0, 0.5) where none is.
    ``depth``, ``opacity``: (1, H, W)."""
    img = image.detach().cpu().numpy()
    d = depth.detach().cpu().numpy()[0]
    o = opacity.detach().cpu().numpy()[0]
    valid = (d > 0) & (o > 0.95) & (img.sum(axis=0) > rgb_boundary_threshold)
    vals = d[valid]
    if vals.size == 0:
        return 0, 2.0, 0.5
    return int(vals.size), float(np.median(vals)), float(np.std(vals))


@torch.no_grad()
def touched(scene: dict, cam: rr.Cam, low_pass: float = 0.3,
            bf16: bool = False, budget: int = 1 << 23) -> torch.Tensor:
    """(N,) bool: the Gaussians of ``scene`` that some pixel of ``cam``'s
    image blends while its transmittance after the blend stays above 0.5.
    Under ``bf16`` the falloff is ``render.py``'s bfloat16 one (the
    precision control)."""
    prep = rr.project(scene, cam, low_pass)
    W, H = cam.width, cam.height
    gid, start, count = rr.bin_cells(prep, W, H)
    lists = rr.cell_lists(rr.pair_rows(prep, gid), start, count, W, H)
    rows, dev = lists.rows, gid.device
    hit = torch.zeros(gid.numel(), dtype=torch.bool, device=dev)
    P = lists.tile * lists.tile
    q = torch.arange(P, device=dev)
    k_ar = torch.arange(rr.BLOCK, device=dev)
    order = torch.argsort(lists.count, descending=True)
    counts_sorted = lists.count[order].tolist()
    nc = max(1, budget // (rr.BLOCK * P))
    for c0 in range(0, len(counts_sorted), nc):
        sel = order[c0:c0 + nc]
        L = counts_sorted[c0]
        xi = lists.ox[sel][:, None] + (q % lists.tile)[None]
        yi = lists.oy[sel][:, None] + (q // lists.tile)[None]
        done = ~((xi < W) & (yi < H))
        px = xi.to(torch.float32)[:, None, :]
        py = yi.to(torch.float32)[:, None, :]
        T = torch.ones(sel.numel(), P, dtype=torch.float32, device=dev)
        st, cnt = lists.start[sel], lists.count[sel]
        for j0 in range(0, L, rr.BLOCK):
            if bool(done.all()):
                break
            j = j0 + k_ar
            row_ok = j[None] < cnt[:, None]                       # (n, k)
            idx = torch.clamp(st[:, None] + j[None], 0,
                              max(rows.shape[0] - 1, 0))
            power, alpha = rr._falloff(rows[idx], px, py, bf16)   # (n, k, P)
            live = (row_ok[..., None] & (power <= 0.0)
                    & (alpha >= rr.ALPHA_MIN) & ~done[:, None, :])
            one_minus = torch.where(live, 1.0 - alpha,
                                    torch.ones_like(alpha))
            T_incl = T[:, None, :] * torch.cumprod(one_minus, dim=1)
            term = live & (T_incl < rr.T_EPS)
            inc = live & (torch.cumsum(term.to(torch.int32), dim=1) == 0)
            seen = (inc & (T_incl > 0.5)).any(dim=2) & row_ok
            hit[idx[seen]] = True
            T = T * torch.prod(torch.where(inc, 1.0 - alpha,
                                           torch.ones_like(alpha)), dim=1)
            done = done | term.any(dim=1)
    out = torch.zeros(prep["depth"].numel(), dtype=torch.bool, device=dev)
    out[gid[hit]] = True
    return out


def covisibility_prune(touched_views, unique_kfids, active, window_uids):
    """(N,) bool: the Gaussians the covisibility prune of a full window
    takes out: those touched by ``PRUNE_COVIZ`` or fewer of the window's
    keyframes (``touched_views``, one (N,) bool a window keyframe), among
    the active ones born at the window's third-newest keyframe or
    later."""
    n_obs = torch.stack([t.to(torch.int32) for t in touched_views]).sum(0)
    newest3 = sorted(window_uids, reverse=True)[2]
    return (n_obs <= PRUNE_COVIZ) & (unique_kfids >= newest3) & active

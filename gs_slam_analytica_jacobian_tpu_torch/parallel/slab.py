"""Model-parallel splat compositing: the GAUSSIAN axis split into depth
slabs over the ranks of a mesh (torch port of parallel/slab.py).

Front-to-back alpha compositing is the associative "over" operator on
(premultiplied color, transmittance):

    (C_a, T_a) OVER (C_b, T_b) = (C_a + T_a * C_b,  T_a * T_b)

so the Gaussians, ordered by view depth, split into depth-contiguous
slabs, one per rank: each rank composites only its own slab, and the
per-pixel slab images are combined with an exclusive prefix product over
the ranks. The one collective of the forward is an all-gather of
image-sized tensors; nothing Gaussian-sized crosses between ranks.
Gradients flow back through the combine, so each rank differentiates
exactly its own slab.

Semantics note: the reference kernel stops a pixel at the first Gaussian
that would take the GLOBAL transmittance below 1e-4, and drops that
Gaussian, so a pixel stops at a T of up to 1e-4 / (1 - 0.99) = 1e-2 (the
alpha clamp). A slab sees only its own transmittance, so what the
one-device render cuts after its stop, the slabs behind still add, with
weight at most that stopped T. The combine therefore deviates only at
pixels where the one-device render stopped, and there by at most its
final T in opacity (times the largest color or depth in color and
depth). The reference's docstring puts this at 1e-4; the stop rule
allows up to 1e-2, and dense surfaces (the bench's room map) come near
it. Within a slab the compositing has the reference's full semantics.

Each slab composites on the dense oracle (ops/renderer_ref.py, the
default) or on the tiled renderer (``tiled=True``: the fused preprocess,
B1' forward and B2 backward on the card, their plain versions on the
CPU). Every rank calls
these functions with the same arguments (SPMD, parallel/sharding.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.camera import Camera
from ..models.gaussian_map import GaussianMap, PARAM_FIELDS
from ..ops import losses, renderer_ref, renderer_tiled
from ..ops.gaussian_math import build_cov3d
from ..ops.preprocess_fused import map_preprocess
from .sharding import Mesh, all_gather, check_mesh


class _GatherSlabs(torch.autograd.Function):
    """all_gather with a backward: every rank's slab images, stacked in
    rank order. The loss must be replicated: every rank computes it from
    the same gathered images, so every rank holds the same cotangent of
    the stack, and its own slab's slice of it is the whole gradient of
    its slab (no collective in the backward)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        return all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def _render_slab(params_sh: Dict[str, torch.Tensor], active_sh, gm, cam,
                 tiled: bool = False, pair_capacity: int = 1 << 16):
    """Render one depth slab from raw (slab) parameter tensors; returns the
    PRE-background (color_sum, depth_sum, final_T). The tiled slab starts
    from the raw parameters as ``render_api.render`` does
    (``map_preprocess``: the fused kernel pair on the card)."""
    dev = gm.device
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    if tiled:
        table, prep = map_preprocess(gm.replace(**params_sh), cam,
                                     active=active_sh)
        out = renderer_tiled.render_prepared(
            prep, table, cam.width, cam.height, bg,
            pair_capacity=pair_capacity, need_n_touched=False)
        return out.color, out.depth[0], out.final_T
    out = renderer_ref.render(
        params_sh["xyz"],
        build_cov3d(torch.exp(params_sh["scaling"]), params_sh["rotation"]),
        torch.sigmoid(params_sh["opacity"])[:, 0],
        torch.cat([params_sh["features_dc"], params_sh["features_rest"]],
                  dim=1),
        gm.active_sh_degree, cam.w2c(), cam.projection(),
        torch.zeros(6, dtype=torch.float32, device=dev),
        cam.fx, cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
        bg, active=active_sh, device=dev)
    return out.color, out.depth[0], out.final_T


def _combine_slabs(c_slab, d_slab, t_slab, bg, mesh: Mesh):
    """Associative OVER-combine of the ranks' slab images: one image-sized
    all-gather, then the exclusive transmittance prefix."""
    stack = _GatherSlabs.apply(
        torch.cat([c_slab, d_slab[None], t_slab[None]]), mesh)  # (P, 5, H, W)
    cs, ds, ts = stack[:, :3], stack[:, 3], stack[:, 4]
    t_excl = torch.cat([torch.ones_like(ts[:1]),
                        torch.cumprod(ts, dim=0)[:-1]], dim=0)
    color = torch.sum(t_excl[:, None] * cs, dim=0)
    depth = torch.sum(t_excl * ds, dim=0)
    T_fin = torch.prod(ts, dim=0)
    color = color + T_fin[None] * bg[:, None, None]
    return color, depth[None], 1.0 - T_fin[None]


def depth_slab_order(gm: GaussianMap, cam: Camera) -> torch.Tensor:
    """Permutation placing active Gaussians in global front-to-back depth
    order (inactive ones at the back): the slab partition key."""
    p_view_z = gm.xyz @ cam.R[2] + cam.t[2]
    key = torch.where(gm.active, p_view_z,
                      torch.full_like(p_view_z, float("inf")))
    return torch.argsort(key, stable=True)


def _slab_params(gm: GaussianMap, order: torch.Tensor, mesh: Mesh):
    """This rank's slab of the depth-ordered parameters and active mask
    (views of the ordered tensors, so gradients reach ``gm``'s)."""
    if gm.capacity % mesh.size:
        raise ValueError(f"map capacity {gm.capacity} does not split over "
                         f"{mesh.size} ranks")
    k = gm.capacity // mesh.size
    sl = slice(mesh.rank * k, (mesh.rank + 1) * k)
    params = {f: getattr(gm, f)[order][sl] for f in PARAM_FIELDS}
    return params, gm.active[order][sl]


def slab_render(mesh: Mesh, gm: GaussianMap, cam: Camera, bg: torch.Tensor,
                tiled: bool = False, pair_capacity: int = 1 << 16):
    """Render with the Gaussian axis split into depth slabs over ``mesh``.
    Returns (color, depth, opacity), the same on every rank;
    differentiable in the map's parameters (each rank's gradient touches
    only its own slab)."""
    check_mesh(mesh)
    params_sh, active_sh = _slab_params(gm, depth_slab_order(gm, cam), mesh)
    c, d, t = _render_slab(params_sh, active_sh, gm, cam, tiled,
                           pair_capacity)
    return _combine_slabs(c, d, t, bg, mesh)


def slab_mapping_loss_and_grads(
    mesh: Mesh,
    gm: GaussianMap,
    cam: Camera,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    bg: torch.Tensor,
    rgb_boundary_threshold: float = 0.01,
    alpha: float = 0.95,
    tiled: bool = False,
    pair_capacity: int = 1 << 16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mapping loss and per-parameter gradients with the map split over
    depth slabs. The gradients come back in the ORIGINAL Gaussian order
    on every rank (the slab permutation inverted; one all-gather of the
    slabs' gradients), so they drop into ``adam_update``."""
    check_mesh(mesh)
    order = depth_slab_order(gm, cam)
    inv = torch.argsort(order)
    params_sh, active_sh = _slab_params(gm, order, mesh)
    params_sh = {f: v.detach().requires_grad_()
                 for f, v in params_sh.items()}
    c, d, t = _render_slab(params_sh, active_sh, gm, cam, tiled,
                           pair_capacity)
    color, depth, _ = _combine_slabs(c, d, t, bg, mesh)
    loss = losses.loss_mapping_rgbd(color, depth, gt_image, gt_depth,
                                    rgb_boundary_threshold, alpha)
    g = torch.autograd.grad(loss, [params_sh[f] for f in PARAM_FIELDS],
                            allow_unused=True)
    flat = torch.cat([
        (gi if gi is not None else torch.zeros_like(params_sh[f])
         ).reshape(params_sh[f].shape[0], -1)
        for f, gi in zip(PARAM_FIELDS, g)], dim=1)       # (C / P, 14)
    full = all_gather(flat, mesh).reshape(gm.capacity, -1)[inv]
    grads, i = {}, 0
    for f in PARAM_FIELDS:
        shape = getattr(gm, f).shape
        n = shape[1:].numel()
        grads[f] = full[:, i:i + n].reshape(shape)
        i += n
    return loss.detach(), grads

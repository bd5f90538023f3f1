"""render(): the map + viewpoint API over the tiled renderer and the
dense oracle (torch port of slam/render_api.py). ``render`` is
differentiable; ``make_render_plan`` builds non-differentiable
structure."""

from __future__ import annotations

from typing import Optional

import torch

from ..device import require_on, resolve_device
from ..models.camera import Camera, PoseState
from ..models.gaussian_map import GaussianMap
from ..ops import gaussian_math as gmath
from ..ops import renderer_ref, renderer_tiled
from ..ops.renderer_ref import RenderOutput
from ..ops.renderer_tiled import make_plan
from ..utils import trace


def _check_inputs(gm: GaussianMap, cam: Camera, device):
    dev = resolve_device(device)
    require_on(dev, map=gm.xyz, camera=cam.R)
    return dev


def render(
    gm: GaussianMap,
    cam: Camera,
    pose: Optional[PoseState] = None,
    bg: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    use_oracle: bool = False,
    pair_capacity: int = 1 << 20,
    plan=None,
    need_n_touched: bool = True,
    bf16: bool = False,
    tile16: bool = False,
    nt_weight: bool = False,
    mxu: bool = False,
    low_pass: float = 0.3,
    device=None,
) -> RenderOutput:
    """Render ``gm`` from ``cam`` (+ pose delta), differentiable in the
    map's tensors, ``pose.tau`` and ``mean2d_offset`` (the reference's
    ``viewspace_points`` trick: the gradient of an all-zeros (N, 2) offset
    is the screen-space mean gradient). ``device=None`` means CUDA; the
    map and camera must lie on the device. ``use_oracle`` selects the dense
    oracle (ops/renderer_ref.py), which, as in the reference, takes none
    of the tiled renderer's options."""
    dev = _check_inputs(gm, cam, device)
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    tau = (pose.tau if pose is not None
           else torch.zeros(6, dtype=torch.float32, device=dev))
    kwargs = dict(
        means3d=gm.xyz, cov6=gm.get_cov6(scaling_modifier),
        opacities=gm.get_opacity(), shs=gm.get_features(),
        sh_degree=gm.active_sh_degree, w2c=cam.w2c(),
        proj=cam.projection(), tau=tau,
        fx=cam.fx, fy=cam.fy, width=cam.width, height=cam.height,
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, bg=bg, active=gm.active,
        mean2d_offset=mean2d_offset, device=dev)
    if use_oracle:
        return renderer_ref.render(**kwargs)
    return renderer_tiled.render(
        **kwargs, pair_capacity=pair_capacity, plan=plan,
        need_n_touched=need_n_touched, bf16=bf16, tile16=tile16,
        nt_weight=nt_weight, mxu=mxu, low_pass=low_pass)


def mark_visible(means3d: torch.Tensor, w2c: torch.Tensor,
                 proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) bool: the point sits in front of the near plane (the
    reference's markVisible predicate p_view.z > 0.2; ``proj`` is accepted
    for API parity and unused)."""
    del proj
    p_z = means3d @ w2c[2, :3] + w2c[2, 3]
    return p_z > 0.2


@torch.no_grad()
def make_render_plan(
    gm: GaussianMap,
    cam: Camera,
    pair_capacity: int = 1 << 20,
    radius_scale: float = 1.0,
    radius_pad: float = 0.0,
    scaling_modifier: float = 1.0,
    tile16: bool = False,
    opa_growth: float = 1.0,
    extra_active: Optional[torch.Tensor] = None,
    device=None,
):
    """Bin once for the given pose; reuse via ``render(..., plan=plan)``.
    A plan built with a ``radius_pad`` stays a superset of the exact pair
    set while the pose drifts by less than the pad (the kernel's per-pixel
    rect test always uses the current means); ``opa_growth`` budgets the
    opacity drift of a map under optimization (mapping's window plans).
    ``extra_active``: an optional (capacity,) bool mask ANDed with the
    map's active set (the tracker's visibility cull plans with it)."""
    dev = _check_inputs(gm, cam, device)
    require_on(dev, extra_active=extra_active)
    trace.count("render.plans_built")
    with trace.span("render.plan"):
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(scaling_modifier), gm.get_opacity(),
            gm.get_features(), gm.active_sh_degree, cam.w2c(),
            cam.projection(), torch.zeros(6, dtype=torch.float32, device=dev),
            cam.fx, cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
        active = (gm.active if extra_active is None
                  else gm.active & extra_active)
        return make_plan(prep, cam.width, cam.height, pair_capacity,
                         active=active, radius_scale=radius_scale,
                         radius_pad=radius_pad, tile16=tile16,
                         opa_growth=opa_growth)

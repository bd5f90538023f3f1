"""Coarse-to-fine IRLS pose tracking, forward only (torch port of the
``track_frame_pyr`` path of slam/tracking.py).

Every iteration renders once, forward only, at the current probe pose
and takes an inverse-compositional IRLS Gauss-Newton step: H = J^T W J
and g = J^T W r from the direct-alignment flow Jacobian of that render
(``curv="flow"``), with motion-floored weights, a trust-region
accept/reject and a pose-step cap, exactly as the reference writes them.
After the pyramid converges, one keyframing render at ``final_level``
produces n_touched.

The reference's ``lax.while_loop`` becomes a Python loop that reads the
convergence flag on the host once per iteration (the 8x8 solve does not
check its info flag on the host). A device-side loop is later work.

Not ported yet (they raise NotImplementedError, naming the later slice):
exact iterations (``level_exact > 0``, the renderer backward), finite-
difference curvature (``curv="fd"``), ``tile16``, ``kernel_bf16``,
``kernel_mxu``, ``level_subset`` and ``use_oracle``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import require_on, resolve_device
from ..models.camera import Camera, PoseState
from ..models.gaussian_map import GaussianMap
from ..ops import losses
from ..ops.lie import pose_matrix, se3_exp
from .render_api import make_render_plan, render


def _not_ported(what: str, later: str):
    raise NotImplementedError(
        f"{what} is not ported yet ({later} comes in a later slice of the "
        "port); the forward-only IRLS path needs curv='flow' and "
        "level_exact of zeros")


# ---------------------------------------------------------------------------
# Image pyramid helpers
# ---------------------------------------------------------------------------

def _pool_avg(x: torch.Tensor, s: int) -> torch.Tensor:
    """(C, H, W) average-pool by integer factor s (crop remainder)."""
    c, h, w = x.shape
    hs, ws = h // s, w // s
    return x[:, :hs * s, :ws * s].reshape(c, hs, s, ws, s).mean(dim=(2, 4))


def _pool_max(x: torch.Tensor, s: int) -> torch.Tensor:
    c, h, w = x.shape
    hs, ws = h // s, w // s
    return x[:, :hs * s, :ws * s].reshape(c, hs, s, ws, s).amax(dim=(2, 4))


def _stride_center(x: torch.Tensor, s: int) -> torch.Tensor:
    """(C, H, W) block-center subsample (for depth): an exact sample for
    odd s, the 2x2 center-block average for even s, aligned with the level
    camera's pixel centers at input offset (s-1)/2."""
    c, h, w = x.shape
    hs, ws = h // s, w // s
    if s % 2 == 1:
        return x[:, s // 2::s, s // 2::s][:, :hs, :ws]
    a = x[:, s // 2 - 1::s, :][:, :hs]
    b = x[:, s // 2::s, :][:, :hs]
    xr = 0.5 * (a + b)
    a = xr[:, :, s // 2 - 1::s][:, :, :ws]
    b = xr[:, :, s // 2::s][:, :, :ws]
    return 0.5 * (a + b)


def _cam_level(cam: Camera, s: int) -> Camera:
    """Scaled-intrinsics camera for pyramid level of decimation s."""
    if s == 1:
        return cam
    return cam.replace(
        fx=cam.fx / s, fy=cam.fy / s,
        cx=(cam.cx + 0.5) / s - 0.5, cy=(cam.cy + 0.5) / s - 0.5,
        width=cam.width // s, height=cam.height // s)


def _central_grad(img: torch.Tensor):
    """Central-difference gradients d/du, d/dv of (C, H, W), replicated
    edges."""
    pu = torch.cat([img[:, :, :1], img, img[:, :, -1:]], dim=2)
    pv = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    gu = 0.5 * (pu[:, :, 2:] - pu[:, :, :-2])
    gv = 0.5 * (pv[:, 2:, :] - pv[:, :-2, :])
    return gu, gv


def _flow_jacobian(cam_l: Camera, image: torch.Tensor, depth: torch.Tensor,
                   opacity: torch.Tensor):
    """Direct-alignment pose Jacobian synthesized from one render (see the
    reference's derivation): a camera-space surface point X moves as
    dX/drho = I, dX/dtheta = -[X]x; the intensity at a fixed pixel changes
    by -grad(I) . du/dtau and the depth by dX_z/dtau - grad(D) . du/dtau.
    Pixels without a confident surface (opacity <= 0.5) get zero pose
    columns. Returns (Jc (8,3,H,W), Jd (8,1,H,W)) including the exposure
    columns d/da = image, d/db = 1."""
    _, H, W = depth.shape
    dev = depth.device
    f32 = torch.float32
    u = torch.arange(W, dtype=f32, device=dev)[None, None, :]
    v = torch.arange(H, dtype=f32, device=dev)[:, None][None]
    conf = (opacity > 0.5).to(f32)
    z = torch.clamp(depth / torch.clamp(opacity, min=0.05), min=0.2)
    xn = (u - cam_l.cx) / cam_l.fx
    yn = (v - cam_l.cy) / cam_l.fy
    inv_z = 1.0 / z

    fx, fy = cam_l.fx, cam_l.fy
    zero = torch.zeros_like(z)
    du = [fx * inv_z, zero, -fx * xn * inv_z,
          -fx * xn * yn, fx * (1.0 + xn * xn), -fx * yn]
    dv = [zero, fy * inv_z, -fy * yn * inv_z,
          -fy * (1.0 + yn * yn), fy * xn * yn, fy * xn]
    dz = [zero, zero, torch.ones_like(z), yn * z, -xn * z, zero]

    gIu, gIv = _central_grad(image)
    gDu, gDv = _central_grad(depth)

    Jc = torch.stack([-conf * (gIu * du[k] + gIv * dv[k]) for k in range(6)])
    Jd = torch.stack([conf * (dz[k] - (gDu * du[k] + gDv * dv[k]))
                      for k in range(6)])
    Jc = torch.cat([Jc, image[None], torch.ones_like(image)[None]], dim=0)
    Jd = torch.cat([Jd, torch.zeros_like(Jd[:2])], dim=0)
    return Jc, Jd


def assemble_Hg(Jc, Jd, image_ab, depth, opacity, sigma, gt_image, gt_depth,
                grad_mask, rgb_boundary_threshold: float, alpha: float,
                monocular: bool, lm_lambda: float):
    """IRLS normal matrix J^T W J and gradient J^T W r with motion-floored
    weights w = m / (|r| + eps + ||J_pose|| * sigma) from the current
    residuals; masks and mean normalizations mirror loss_tracking_*.
    Returns (H (8, 8) with LM damping, g (8,))."""
    H_img, W_img = gt_image.shape[1], gt_image.shape[2]
    n3hw = 3.0 * H_img * W_img
    nhw = float(H_img * W_img)
    rgb_mask = (gt_image.sum(dim=0, keepdim=True)
                > rgb_boundary_threshold).to(torch.float32)
    Jc_f = Jc.reshape(8, -1)
    Jd_f = Jd.reshape(8, -1)
    jn_c = torch.sqrt(torch.sum(Jc[:6] * Jc[:6], dim=0))
    jn_d = torch.sqrt(torch.sum(Jd[:6] * Jd[:6], dim=0))
    r_c = image_ab - gt_image
    w_c = ((opacity * grad_mask * rgb_mask)
           / (torch.abs(r_c) + 1e-3 + jn_c * sigma))
    w_c = (w_c if monocular else alpha * w_c) / n3hw
    H_mat = (Jc_f * w_c.reshape(1, -1)) @ Jc_f.T
    g_vec = Jc_f @ (w_c * r_c).reshape(-1)
    if not monocular:
        depth_mask = ((gt_depth > 0.01) & (opacity > 0.95)).to(torch.float32)
        r_d = depth - gt_depth
        w_d = ((1.0 - alpha) * depth_mask
               / (torch.abs(r_d) + 1e-3 + jn_d * sigma) / nhw)
        H_mat = H_mat + (Jd_f * w_d.reshape(1, -1)) @ Jd_f.T
        g_vec = g_vec + Jd_f @ (w_d * r_d).reshape(-1)
    H_mat = H_mat + lm_lambda * torch.diag(
        torch.clamp(torch.diagonal(H_mat), min=1e-8))
    eye = torch.eye(8, dtype=H_mat.dtype, device=H_mat.device)
    return H_mat + 1e-8 * eye, g_vec


def _gn_level(
    gm: GaussianMap,
    cam_l: Camera,
    R, t, ea, eb,
    gt_image, gt_depth, grad_mask, bg,
    rgb_boundary_threshold: float,
    alpha: float,
    monocular: bool,
    max_iters: int,
    pair_capacity: int,
    lm_lambda: float,
    radius_pad: float,
    H_frozen=None,
    curv: str = "flow",
    low_pass: float = 0.3,
    sigma0: float = 0.01,
    sigma_decay: float = 0.8,
    sigma_in=None,
    step_cap: float = 0.05,
    exact_iters: int = -1,
    plan_in=None,
):
    """One pyramid level of forward-only IRLS Gauss-Newton.

    Trust-region accept/reject: each iteration renders once at the probe
    pose P; if its loss beats the best-so-far B, P becomes B (with its
    gradient and curvature) and the radius grows, else it shrinks; the
    next probe steps from B along B's Newton direction, capped at
    ``step_cap``. ``H_frozen = (H, Jc, Jd)`` reuses a normal matrix (or
    cached Jacobians) instead of the per-iteration flow curvature.

    Returns (R, t, ea, eb, iters_done, (H, Jc, Jd), plan, sigma)."""
    exact_l = max_iters if exact_iters < 0 else min(exact_iters, max_iters)
    if exact_l > 0:
        _not_ported("exact iterations (level_exact > 0)",
                    "the renderer backward")
    if H_frozen is None and curv != "flow":
        _not_ported(f"curv={curv!r}", "finite-difference curvature")
    dev = gm.device
    f32 = torch.float32

    if plan_in is not None:
        plan = plan_in
    else:
        plan = make_render_plan(
            gm, cam_l.replace(R=R, t=t), pair_capacity=pair_capacity,
            radius_scale=1.1, radius_pad=radius_pad, device=dev)

    zeros6 = torch.zeros(6, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    def loss_fn(ea_, eb_, R_, t_):
        out = render(gm, cam_l.replace(R=R_, t=t_),
                     PoseState(tau=zeros6, exposure_a=zero, exposure_b=zero),
                     bg, pair_capacity=pair_capacity, plan=plan,
                     need_n_touched=False, low_pass=low_pass, device=dev)
        image_ab = losses.apply_exposure(out.color, ea_, eb_)
        if monocular:
            L = losses.loss_tracking_rgb(
                image_ab, gt_image, out.opacity, grad_mask,
                rgb_boundary_threshold)
        else:
            L = losses.loss_tracking_rgbd(
                image_ab, out.depth, gt_image, gt_depth, out.opacity,
                grad_mask, rgb_boundary_threshold, alpha)
        return L, (image_ab, out.depth, out.opacity)

    def hg(Jc, Jd, image_ab, depth, opacity, sigma):
        return assemble_Hg(Jc, Jd, image_ab, depth, opacity, sigma,
                           gt_image, gt_depth, grad_mask,
                           rgb_boundary_threshold, alpha, monocular,
                           lm_lambda)

    Jc_probe = Jd_probe = None
    if H_frozen is not None:
        H_const, Jc_probe, Jd_probe = H_frozen
        if Jc_probe is not None:
            def curv_grad(image_ab, depth, opacity, sigma):
                return hg(Jc_probe, Jd_probe, image_ab, depth, opacity,
                          sigma)
        else:
            def curv_grad(image_ab, depth, opacity, sigma):
                Jc, Jd = _flow_jacobian(cam_l, image_ab, depth, opacity)
                _, g_vec = hg(Jc, Jd, image_ab, depth, opacity, sigma)
                return H_const, g_vec
    else:
        def curv_grad(image_ab, depth, opacity, sigma):
            Jc, Jd = _flow_jacobian(cam_l, image_ab, depth, opacity)
            return hg(Jc, Jd, image_ab, depth, opacity, sigma)

    sigma = (torch.tensor(sigma0, dtype=f32, device=dev) if sigma_in is None
             else sigma_in)
    trust = torch.tensor(1.0, dtype=f32, device=dev)
    RB, tB, eaB, ebB = R, t, ea, eb
    LB = torch.tensor(float("inf"), dtype=f32, device=dev)
    gB = torch.zeros(8, dtype=f32, device=dev)
    HB = (torch.eye(8, dtype=f32, device=dev) if H_frozen is None
          else H_frozen[0])
    itr = 0
    converged = False
    while itr < max_iters and not converged:
        L_P, aux = loss_fn(ea, eb, R, t)
        H_mat, g = curv_grad(*aux, sigma)
        accept = L_P <= LB

        def sel(a, b):
            return torch.where(accept, a, b)

        RB, tB, eaB, ebB = sel(R, RB), sel(t, tB), sel(ea, eaB), sel(eb, ebB)
        LB, gB, HB = sel(L_P, LB), sel(g, gB), sel(H_mat, HB)
        trust = torch.where(accept, torch.clamp(trust * 1.5, max=1.0),
                            trust * 0.4)

        delta = torch.linalg.solve_ex(HB, gB).result * trust
        pn = torch.linalg.norm(delta[:6])
        delta = delta * torch.clamp(step_cap / torch.clamp(pn, min=1e-12),
                                    max=1.0)
        new_tau = -delta[:6]
        # self-scaled trust floor for the next linearization
        sigma = torch.minimum(
            torch.clamp(torch.linalg.norm(delta[:6]), min=1e-4),
            sigma * sigma_decay)
        newT = se3_exp(new_tau) @ pose_matrix(RB, tB)
        R, t = newT[:3, :3], newT[:3, 3]
        ea, eb = eaB - delta[6], ebB - delta[7]
        itr += 1
        converged = bool(((torch.linalg.norm(new_tau) < 1e-4) & accept)
                         .item())
    # the final probe may be a rejected overshoot: return the best
    return RB, tB, eaB, ebB, itr, (HB, Jc_probe, Jd_probe), plan, sigma


def pair_capacity_bucket(num_pairs: int, ceiling: int,
                         quantum: int = 1 << 17) -> int:
    """Quantized pair-plan capacity for an observed pair count: 1.5x
    headroom, rounded up to ``quantum``, clamped to [quantum, ceiling]."""
    want = max(int(num_pairs) * 3 // 2, 1)
    want = -(-want // quantum) * quantum
    return min(max(want, quantum), ceiling)


@torch.no_grad()
def track_frame_pyr(
    gm: GaussianMap,
    cam_template: Camera,
    R0: torch.Tensor, t0: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    grad_mask: torch.Tensor,
    bg: torch.Tensor,
    lr_rot: float, lr_trans: float,   # API parity; unused
    rgb_boundary_threshold: float,
    alpha: float = 0.95,
    monocular: bool = False,
    max_iters: int = 20,              # API parity; per-level counts below
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    lm_lambda: float = 1e-2,
    levels: tuple = (4, 2, 1),
    level_iters: tuple = (5, 3, 12),
    curv: str = "fd",
    kernel_bf16: bool = False,
    kernel_mxu: bool = False,
    sigma0: float = 0.01,
    sigma_decay: float = 0.8,
    step_cap: float = 0.05,
    level_exact: Optional[tuple] = None,
    tile16: bool = False,
    plan_pad: float = 8.0,
    H_in=None,
    pair_capacity_ceiling: int = 0,
    level_caps: Optional[tuple] = None,
    level_subset: Optional[tuple] = None,
    plan_in=None,
    nt_weight: bool = False,
    final_level: int = 1,
    match_blur: bool = False,
    device=None,
) -> Tuple:
    """Coarse-to-fine forward-only IRLS tracker (the reference's signature
    and defaults; its defaults ask for exact iterations and FD curvature,
    which are not ported, so callers pass ``curv="flow"`` and
    ``level_exact`` of zeros). The FD-curvature options ``fd_eps`` and
    ``probe_levels`` and the frontend's ``track_mask`` come with the
    slices that use them.

    Levels run coarse-to-fine with warm-started pose and exposure, each on
    a pair plan built at its own resolution (or handed back via
    ``plan_in``) at the capacity ``level_caps[li]`` or, by default,
    ``pair_capacity`` at s=1 and max(min(ceiling, 2^17), ceiling/2) below;
    ``match_blur`` scales the EWA low-pass so a level render's blur
    matches the average-pooled ground truth. The final keyframing render
    runs at ``final_level`` on that level's plan and fills n_touched
    (under ``nt_weight``, at the blend-weight threshold).

    Returns (R, t, ea, eb, total_iters, RenderOutput, median_depth,
    H_out, per-level overflow, final num_pairs, per-level num_pairs,
    plans_out). ``device=None`` means CUDA."""
    del lr_rot, lr_trans, max_iters
    if level_exact is None:
        level_exact = level_iters
    if any(min(int(e), int(i)) > 0 for e, i in zip(level_exact, level_iters)):
        _not_ported("exact iterations (level_exact > 0)",
                    "the renderer backward")
    if curv != "flow":
        _not_ported(f"curv={curv!r}", "finite-difference curvature")
    for name, on in (("tile16", tile16), ("kernel_bf16", kernel_bf16),
                     ("kernel_mxu", kernel_mxu),
                     ("level_subset", level_subset is not None),
                     ("use_oracle", use_oracle)):
        if on:
            _not_ported(name, "the 16x16 kernels, kernel variants, tile "
                        "subsets and the oracle renderer")
    dev = resolve_device(device)
    require_on(dev, map=gm.xyz, camera=cam_template.R, R0=R0, t0=t0,
               gt_image=gt_image, gt_depth=gt_depth, grad_mask=grad_mask,
               bg=bg)

    f32 = torch.float32
    R, t = R0, t0
    ea = torch.zeros((), dtype=f32, device=dev)
    eb = torch.zeros((), dtype=f32, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    total_iters = 0
    plan_s1 = None
    sigma_prev = None
    H_out, lvl_overflow, lvl_pairs, plans_out = [], [], [], []

    for li, (s, iters_l) in enumerate(zip(levels, level_iters)):
        if iters_l <= 0:
            H_out.append((torch.eye(8, dtype=f32, device=dev), None, None)
                         if H_in is None else H_in[li])
            lvl_overflow.append(izero)
            lvl_pairs.append(izero)
            plans_out.append(None if plan_in is None else plan_in[li])
            continue
        cam_l = _cam_level(cam_template, s)
        if s == 1:
            gt_i, gt_d, gm_l = gt_image, gt_depth, grad_mask
        else:
            gt_i = _pool_avg(gt_image, s)
            gt_d = _stride_center(gt_depth, s)
            gm_l = _pool_max(grad_mask, s)
        if level_caps is not None:
            cap_l = level_caps[li]
        else:
            ceil_cap = max(pair_capacity, pair_capacity_ceiling)
            cap_l = (pair_capacity if s == 1
                     else max(min(ceil_cap, 1 << 17), ceil_cap // 2))
        # flow curvature is rebuilt every iteration from the current
        # render, so no normal matrix is carried into a level (H_in only
        # fills skipped levels, as in the reference)
        lp_l = ((0.3 + (s * s - 1) / 12.0) / (s * s)
                if match_blur and s > 1 else 0.3)
        R, t, ea, eb, itr_l, H_prev, plan_l, sigma_prev = _gn_level(
            gm, cam_l, R, t, ea, eb, gt_i, gt_d, gm_l, bg,
            rgb_boundary_threshold, alpha, monocular, iters_l, cap_l,
            lm_lambda, radius_pad=max(2.0, plan_pad / s), H_frozen=None,
            curv=curv, low_pass=lp_l, sigma0=sigma0,
            sigma_decay=sigma_decay, sigma_in=sigma_prev, step_cap=step_cap,
            exact_iters=0, plan_in=None if plan_in is None else plan_in[li])
        total_iters += itr_l
        H_out.append(H_prev)
        plans_out.append(plan_l)
        lvl_overflow.append(plan_l.overflow)
        lvl_pairs.append(plan_l.num_pairs)
        if s == final_level:
            plan_s1 = plan_l
            cap_final = cap_l

    if plan_s1 is None:
        cap_final = pair_capacity
    cam = _cam_level(cam_template, final_level).replace(R=R, t=t)
    out = render(gm, cam, None, bg, pair_capacity=cap_final, plan=plan_s1,
                 nt_weight=nt_weight, device=dev)
    med = losses.median_depth(out.depth, out.opacity)
    num_pairs = izero if plan_s1 is None else plan_s1.num_pairs
    return (R, t, ea, eb, total_iters, out, med, tuple(H_out),
            torch.stack(lvl_overflow), num_pairs, torch.stack(lvl_pairs),
            tuple(plans_out))

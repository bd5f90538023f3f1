"""Pose tracking (torch port of slam/tracking.py): the coarse-to-fine
IRLS tracker ``track_frame_pyr``, the keyframe polish ``polish_frame``,
the Gauss-Newton tracker ``track_frame_gn`` and the reference-parity Adam
tracker ``track_frame``.

An IRLS iteration renders forward only at the current probe pose and
steps along g = J^T W r from the direct-alignment flow Jacobian of that
render (``curv="flow"``) or a frozen finite-difference probe Jacobian
(``curv="fd"``). An exact iteration takes the loss and its analytic
gradient dL/d(tau, exposure a, b) by torch autograd through the
renderer (the backward compositing kernel), which pins the exact L1 fixed
point; the curvature stays the IRLS normal matrix. Motion-floored weights,
the trust-region accept/reject and the pose-step cap are written exactly
as in the reference.

The reference's ``lax.while_loop``s become Python loops that read the
convergence flag on the host once per iteration (the 8x8 solve does not
check its info flag on the host). A device-side loop is later work.

Every tracker takes ``tile16``: its plans and renders then use 16-px
tiles and the 16x16 kernels. Not ported yet (they raise
NotImplementedError, naming the later slice): ``kernel_bf16``,
``kernel_mxu`` and ``level_subset``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
        "port)")


class TrackAdamState(NamedTuple):
    m: torch.Tensor        # (8,) moments for [tau(6), exp_a, exp_b]
    v: torch.Tensor        # (8,)
    step: torch.Tensor     # () int32


def _adam8(adam: TrackAdamState, g: torch.Tensor, lrs: torch.Tensor,
           b1=0.9, b2=0.999, eps=1e-8) -> Tuple[torch.Tensor, TrackAdamState]:
    """torch.optim.Adam default-eps step on the 8 tracking params."""
    step = adam.step + 1
    t = step.to(torch.float32)
    m = b1 * adam.m + (1 - b1) * g
    v = b2 * adam.v + (1 - b2) * g * g
    upd = lrs * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    return upd, TrackAdamState(m=m, v=v, step=step)


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


# ---------------------------------------------------------------------------
# Loss, exact gradient and finite-difference curvature
# ---------------------------------------------------------------------------

def _tracking_loss(out, ea, eb, gt_image, gt_depth, grad_mask,
                   rgb_boundary_threshold: float, alpha: float,
                   monocular: bool):
    """The reference's masked tracking loss of one render. Returns (L,
    exposure-corrected image)."""
    image_ab = losses.apply_exposure(out.color, ea, eb)
    if monocular:
        L = losses.loss_tracking_rgb(image_ab, gt_image, out.opacity,
                                     grad_mask, rgb_boundary_threshold)
    else:
        L = losses.loss_tracking_rgbd(image_ab, out.depth, gt_image,
                                      gt_depth, out.opacity, grad_mask,
                                      rgb_boundary_threshold, alpha)
    return L, image_ab


def _value_and_grad(render_fn, ea, eb, loss_args):
    """L and g = dL/d(tau, a, b) (8,) at tau = 0 by autograd through
    ``render_fn(tau)``: the exact analytic gradient, through the
    renderer's backward. Returns (L, g, (image_ab, depth, opacity)) with
    the images detached."""
    with torch.enable_grad():
        tau = torch.zeros(6, dtype=torch.float32, device=ea.device,
                          requires_grad=True)
        a = ea.detach().clone().requires_grad_()
        b = eb.detach().clone().requires_grad_()
        out = render_fn(tau)
        L, image_ab = _tracking_loss(out, a, b, *loss_args)
        g_tau, g_a, g_b = torch.autograd.grad(L, (tau, a, b))
    g = torch.cat([g_tau, g_a[None], g_b[None]])
    return L.detach(), g, (image_ab.detach(), out.depth.detach(),
                           out.opacity.detach())


def _fd_jacobian(render_fn, fd_eps: float, device):
    """Frozen pose Jacobian from 6 forward finite-difference probes
    ``render_fn(fd_eps e_k)`` around ``render_fn(0)``, with the analytic
    exposure columns d(image)/da = image, d/db = 1 at (a, b) = (0, 0).
    Returns (Jc (8,3,H,W), Jd (8,1,H,W))."""
    taus = torch.eye(6, dtype=torch.float32, device=device) * fd_eps
    out0 = render_fn(torch.zeros(6, dtype=torch.float32, device=device))
    probes = [render_fn(tau) for tau in taus]
    Jc = (torch.stack([o.color for o in probes]) - out0.color[None]) / fd_eps
    Jd = (torch.stack([o.depth for o in probes]) - out0.depth[None]) / fd_eps
    Jc = torch.cat([Jc, out0.color[None], torch.ones_like(out0.color)[None]])
    Jd = torch.cat([Jd, torch.zeros_like(Jd[:2])])
    return Jc, Jd


def _step_pose(delta: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """T <- Exp(-delta[:6]) @ T. Returns (R, t, new_tau)."""
    new_tau = -delta[:6]
    newT = se3_exp(new_tau) @ pose_matrix(R, t)
    return newT[:3, :3], newT[:3, 3], new_tau


# ---------------------------------------------------------------------------
# One pyramid level of IRLS / exact Gauss-Newton
# ---------------------------------------------------------------------------

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
    use_oracle: bool = False,
    fd_eps: float = 1e-3,
    tile16: bool = False,
):
    """One pyramid level of IRLS Gauss-Newton pose refinement.

    Trust-region accept/reject: each iteration renders once at the probe
    pose P; if its loss beats the best-so-far B, P becomes B (with its
    gradient and curvature) and the radius grows, else it shrinks; the
    next probe steps from B along B's Newton direction, capped at
    ``step_cap``. The trailing ``exact_iters`` iterations (all when -1)
    are exact (fwd+bwd render, analytic dL/dtau); the ones before them
    are IRLS (forward only, g = J^T W r), and the exact phase restarts
    from the IRLS phase's best pose.

    Curvature: ``curv="flow"`` assembles H from the flow Jacobian of the
    current render every iteration; ``curv="fd"`` probes J once at level
    entry (6 renders at ``fd_eps``); ``H_frozen = (H, Jc, Jd)`` reuses a
    normal matrix (Jc None: H fixed, g from the flow Jacobian) or cached
    probe Jacobians (H re-assembled with current weights).

    Returns (R, t, ea, eb, iters_done, (H, Jc, Jd), plan, sigma); plan is
    None under ``use_oracle``."""
    dev = gm.device
    f32 = torch.float32

    if plan_in is not None:
        plan = plan_in
    else:
        plan = (None if use_oracle else make_render_plan(
            gm, cam_l.replace(R=R, t=t), pair_capacity=pair_capacity,
            radius_scale=1.1, radius_pad=radius_pad, tile16=tile16,
            device=dev))

    zero = torch.zeros((), dtype=f32, device=dev)
    zeros6 = torch.zeros(6, dtype=f32, device=dev)
    loss_args = (gt_image, gt_depth, grad_mask, rgb_boundary_threshold,
                 alpha, monocular)

    def render_at(tau, R_, t_):
        return render(gm, cam_l.replace(R=R_, t=t_),
                      PoseState(tau=tau, exposure_a=zero, exposure_b=zero),
                      bg, use_oracle=use_oracle, pair_capacity=pair_capacity,
                      plan=plan, need_n_touched=False, tile16=tile16,
                      low_pass=low_pass, device=dev)

    def loss_fn(ea_, eb_, R_, t_):
        out = render_at(zeros6, R_, t_)
        L, image_ab = _tracking_loss(out, ea_, eb_, *loss_args)
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
    elif curv == "flow":
        def curv_grad(image_ab, depth, opacity, sigma):
            Jc, Jd = _flow_jacobian(cam_l, image_ab, depth, opacity)
            return hg(Jc, Jd, image_ab, depth, opacity, sigma)
    else:  # "fd": frozen probe Jacobian at level entry
        Jc_probe, Jd_probe = _fd_jacobian(
            lambda tau: render_at(tau, R, t), fd_eps, dev)

        def curv_grad(image_ab, depth, opacity, sigma):
            return hg(Jc_probe, Jd_probe, image_ab, depth, opacity, sigma)

    def run_phase(st, n_iters, exact):
        (R_, t_, ea_, eb_, sigma, trust, RB, tB, eaB, ebB, LB, gB, HB) = st
        itr = 0
        converged = False
        while itr < n_iters and not converged:
            if exact:
                L_P, g, aux = _value_and_grad(
                    lambda tau: render_at(tau, R_, t_), ea_, eb_, loss_args)
                H_mat, _ = curv_grad(*aux, sigma)
            else:
                L_P, aux = loss_fn(ea_, eb_, R_, t_)
                H_mat, g = curv_grad(*aux, sigma)
            accept = L_P <= LB

            def sel(a, b):
                return torch.where(accept, a, b)

            RB, tB, eaB, ebB = sel(R_, RB), sel(t_, tB), sel(ea_, eaB), \
                sel(eb_, ebB)
            LB, gB, HB = sel(L_P, LB), sel(g, gB), sel(H_mat, HB)
            trust = torch.where(accept, torch.clamp(trust * 1.5, max=1.0),
                                trust * 0.4)

            delta = torch.linalg.solve_ex(HB, gB).result * trust
            pn = torch.linalg.norm(delta[:6])
            delta = delta * torch.clamp(step_cap / torch.clamp(pn, min=1e-12),
                                        max=1.0)
            # self-scaled trust floor for the next linearization
            sigma = torch.minimum(
                torch.clamp(torch.linalg.norm(delta[:6]), min=1e-4),
                sigma * sigma_decay)
            R_, t_, new_tau = _step_pose(delta, RB, tB)
            ea_, eb_ = eaB - delta[6], ebB - delta[7]
            itr += 1
            converged = bool(((torch.linalg.norm(new_tau) < 1e-4) & accept)
                             .item())
        return (R_, t_, ea_, eb_, sigma, trust, RB, tB, eaB, ebB, LB, gB,
                HB), itr

    exact_l = max_iters if exact_iters < 0 else min(exact_iters, max_iters)
    cheap_l = max_iters - exact_l
    sigma = (torch.tensor(sigma0, dtype=f32, device=dev) if sigma_in is None
             else sigma_in)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    zeros8 = torch.zeros(8, dtype=f32, device=dev)
    H0 = (torch.eye(8, dtype=f32, device=dev) if H_frozen is None
          else H_frozen[0])
    st = (R, t, ea, eb, sigma, torch.tensor(1.0, dtype=f32, device=dev),
          R, t, ea, eb, inf, zeros8, H0)
    iters_done = 0
    if cheap_l > 0:
        st, iters_done = run_phase(st, cheap_l, exact=False)
    if exact_l > 0:
        if cheap_l > 0:
            # fresh phase from the IRLS phase's best pose; its approximate
            # gradient must not seed an exact step
            (_, _, _, _, sigma_c, trust_c, RB, tB, eaB, ebB, _, _, HBc) = st
            st = (RB, tB, eaB, ebB, sigma_c, trust_c, RB, tB, eaB, ebB, inf,
                  zeros8, HBc)
        st, n = run_phase(st, exact_l, exact=True)
        iters_done += n
    (_, _, _, _, sigma_f, _, RB, tB, eaB, ebB, _, _, HB) = st
    # the final probe may be a rejected overshoot: return the best
    return RB, tB, eaB, ebB, iters_done, (HB, Jc_probe, Jd_probe), plan, \
        sigma_f


def pair_capacity_bucket(num_pairs: int, ceiling: int,
                         quantum: int = 1 << 17) -> int:
    """Quantized pair-plan capacity for an observed pair count: 1.5x
    headroom, rounded up to ``quantum``, clamped to [quantum, ceiling]."""
    want = max(int(num_pairs) * 3 // 2, 1)
    want = -(-want // quantum) * quantum
    return min(max(want, quantum), ceiling)


def _check_frame(dev, gm, cam, R0, t0, gt_image, gt_depth, grad_mask, bg):
    require_on(dev, map=gm.xyz, camera=cam.R, R0=R0, t0=t0,
               gt_image=gt_image, gt_depth=gt_depth, grad_mask=grad_mask,
               bg=bg)


# ---------------------------------------------------------------------------
# Trackers
# ---------------------------------------------------------------------------

@torch.no_grad()
def polish_frame(
    gm: GaussianMap,
    cam_template: Camera,
    R0: torch.Tensor, t0: torch.Tensor,
    ea0: torch.Tensor, eb0: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    grad_mask: torch.Tensor,
    bg: torch.Tensor,
    rgb_boundary_threshold: float,
    alpha: float = 0.95,
    monocular: bool = False,
    iters: int = 2,
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    tile16: bool = False,
    device=None,
):
    """Exact analytic-gradient polish at full resolution from an already
    converged IRLS pose: ``iters`` exact iterations (plan pad 2 px,
    sigma0 1e-3, step cap 0.05). The frontend tracks every frame IRLS-only
    and pins the exact L1 fixed point here, on keyframe creation.

    Returns (R, t, exposure_a, exposure_b, iters_done). ``device=None``
    means CUDA."""
    dev = resolve_device(device)
    _check_frame(dev, gm, cam_template, R0, t0, gt_image, gt_depth,
                 grad_mask, bg)
    R, t, ea, eb, itr, _, _, _ = _gn_level(
        gm, cam_template, R0, t0, ea0, eb0, gt_image, gt_depth, grad_mask,
        bg, rgb_boundary_threshold, alpha, monocular, iters, pair_capacity,
        1e-2, 2.0, H_frozen=None, curv="flow", sigma0=1e-3, sigma_decay=0.8,
        sigma_in=None, step_cap=0.05, exact_iters=iters,
        use_oracle=use_oracle, fd_eps=1e-3, tile16=tile16)
    return R, t, ea, eb, itr


def _strip_J(entry):
    """Cross-level H reuse: the coarser level's normal matrix transfers
    (mean-normalized entries are resolution-invariant) but its probe
    Jacobian is level-resolution-shaped and does not."""
    return (entry[0], None, None)


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
    fd_eps: float = 1e-3,
    lm_lambda: float = 1e-2,
    levels: tuple = (4, 2, 1),
    level_iters: tuple = (5, 3, 12),
    probe_levels: str = "coarse",
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
    """Coarse-to-fine IRLS Gauss-Newton tracker (the reference's signature
    and defaults, without ``interpret`` and the frontend's
    ``track_mask``).

    Levels run coarse-to-fine with warm-started pose and exposure, each on
    a pair plan built at its own resolution (or handed back via
    ``plan_in``) at the capacity ``level_caps[li]`` or, by default,
    ``pair_capacity`` at s=1 and max(min(ceiling, 2^17), ceiling/2) below.
    ``level_exact`` (default: every iteration) caps how many trailing
    iterations of each level are exact. With ``curv="fd"`` the levels
    ``probe_levels`` names ("coarse": all but the finest unless it runs
    IRLS iterations; "first"; "all") probe J at their own resolution and
    the others reuse the coarser level's H; ``H_in`` (the previous frame's
    ``H_out``) replaces the probes for ``curv != "flow"``. ``match_blur``
    scales the EWA low-pass so a level render's blur matches the
    average-pooled ground truth. The final keyframing render runs at
    ``final_level`` on that level's plan and fills n_touched (under
    ``nt_weight``, at the blend-weight threshold).

    Returns (R, t, ea, eb, total_iters, RenderOutput, median_depth,
    H_out, per-level overflow, final num_pairs, per-level num_pairs,
    plans_out). ``device=None`` means CUDA."""
    del lr_rot, lr_trans, max_iters
    for name, on in (("kernel_bf16", kernel_bf16),
                     ("kernel_mxu", kernel_mxu),
                     ("level_subset", level_subset is not None)):
        if on:
            _not_ported(name, "the kernel variants and tile subsets")
    dev = resolve_device(device)
    _check_frame(dev, gm, cam_template, R0, t0, gt_image, gt_depth,
                 grad_mask, bg)
    if level_exact is None:
        level_exact = level_iters

    f32 = torch.float32
    R, t = R0, t0
    ea = torch.zeros((), dtype=f32, device=dev)
    eb = torch.zeros((), dtype=f32, device=dev)
    izero = torch.zeros((), dtype=torch.int32, device=dev)
    total_iters = 0
    H_prev = None
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
        exact_l = min(int(level_exact[li]), iters_l)
        need_J = exact_l < iters_l and curv == "fd"
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
        if H_in is not None and curv != "flow":
            # cross-frame curvature reuse (the caller re-probes every few
            # frames)
            H_frozen = H_in[li]
        elif curv == "flow":
            H_frozen = None          # flow curvature is per-iteration free
        elif probe_levels == "first":
            H_frozen = (None if H_prev is None or need_J
                        else _strip_J(H_prev))
        elif probe_levels == "all":
            H_frozen = None
        else:  # "coarse": probe at every level but the finest, unless it
            # runs IRLS iterations, which need J at their own resolution
            H_frozen = (None if s > 1 or H_prev is None or need_J
                        else _strip_J(H_prev))
        lp_l = ((0.3 + (s * s - 1) / 12.0) / (s * s)
                if match_blur and s > 1 else 0.3)
        R, t, ea, eb, itr_l, H_prev, plan_l, sigma_prev = _gn_level(
            gm, cam_l, R, t, ea, eb, gt_i, gt_d, gm_l, bg,
            rgb_boundary_threshold, alpha, monocular, iters_l, cap_l,
            lm_lambda, radius_pad=max(2.0, plan_pad / s), H_frozen=H_frozen,
            curv=curv, low_pass=lp_l, sigma0=sigma0, sigma_decay=sigma_decay,
            sigma_in=sigma_prev, step_cap=step_cap, exact_iters=exact_l,
            plan_in=None if plan_in is None else plan_in[li],
            use_oracle=use_oracle, fd_eps=fd_eps, tile16=tile16)
        total_iters += itr_l
        H_out.append(H_prev)
        plans_out.append(plan_l)
        lvl_overflow.append(izero if plan_l is None else plan_l.overflow)
        lvl_pairs.append(izero if plan_l is None else plan_l.num_pairs)
        if s == final_level:
            plan_s1 = plan_l
            cap_final = cap_l

    if plan_s1 is None:
        cap_final = pair_capacity
    cam = _cam_level(cam_template, final_level).replace(R=R, t=t)
    out = render(gm, cam, None, bg, use_oracle=use_oracle,
                 pair_capacity=cap_final, plan=plan_s1, tile16=tile16,
                 nt_weight=nt_weight and not use_oracle, device=dev)
    med = losses.median_depth(out.depth, out.opacity)
    num_pairs = izero if plan_s1 is None else plan_s1.num_pairs
    return (R, t, ea, eb, total_iters, out, med, tuple(H_out),
            torch.stack(lvl_overflow), num_pairs, torch.stack(lvl_pairs),
            tuple(plans_out))


@torch.no_grad()
def track_frame_gn(
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
    max_iters: int = 20,
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    fd_eps: float = 1e-3,
    lm_lambda: float = 1e-2,
    tile16: bool = False,
    device=None,
):
    """Gauss-Newton / IRLS pose tracker at full resolution: the exact
    analytic dL/dtau every iteration; the 8x8 IRLS curvature from a
    Jacobian probed once per frame by 6 finite-difference renders around
    the warm start (analytic exposure columns), reweighted with the
    current residuals every iteration; a 0.7^k step decay after the first
    full step. One plan from the warm start (radius_scale 1.1, pad 8 px;
    16-px tiles under ``tile16``, a port extension: the reference's
    tracker has no such switch).

    Returns (R, t, exposure_a, exposure_b, n_iters, final RenderOutput,
    median_depth). ``device=None`` means CUDA."""
    del lr_rot, lr_trans
    dev = resolve_device(device)
    _check_frame(dev, gm, cam_template, R0, t0, gt_image, gt_depth,
                 grad_mask, bg)
    f32 = torch.float32
    plan = (None if use_oracle else make_render_plan(
        gm, cam_template.replace(R=R0, t=t0), pair_capacity=pair_capacity,
        radius_scale=1.1, radius_pad=8.0, tile16=tile16, device=dev))
    zero = torch.zeros((), dtype=f32, device=dev)
    loss_args = (gt_image, gt_depth, grad_mask, rgb_boundary_threshold,
                 alpha, monocular)

    def render_at(tau, R, t):
        return render(gm, cam_template.replace(R=R, t=t),
                      PoseState(tau=tau, exposure_a=zero, exposure_b=zero),
                      bg, use_oracle=use_oracle, pair_capacity=pair_capacity,
                      plan=plan, need_n_touched=False, tile16=tile16,
                      device=dev)

    Jc, Jd = _fd_jacobian(lambda tau: render_at(tau, R0, t0), fd_eps, dev)

    def curvature(image_ab, depth, opacity):
        """IRLS normal matrix over the frozen J, weights m / (|r| + 1e-3)
        from the current residuals (assemble_Hg without the motion
        floor)."""
        return assemble_Hg(Jc, Jd, image_ab, depth, opacity, 0.0, gt_image,
                           gt_depth, grad_mask, rgb_boundary_threshold,
                           alpha, monocular, lm_lambda)[0]

    R, t = R0, t0
    ea = torch.zeros((), dtype=f32, device=dev)
    eb = torch.zeros((), dtype=f32, device=dev)
    itr = 0
    converged = False
    while itr < max_iters and not converged:
        _, g, aux = _value_and_grad(lambda tau: render_at(tau, R, t), ea, eb,
                                    loss_args)
        scale = 0.7 ** max(itr - 1, 0)
        delta = torch.linalg.solve_ex(curvature(*aux), g).result * scale
        R, t, new_tau = _step_pose(delta, R, t)
        ea, eb = ea - delta[6], eb - delta[7]
        itr += 1
        converged = bool((torch.linalg.norm(new_tau) < 1e-4).item())

    out = render(gm, cam_template.replace(R=R, t=t), None, bg,
                 use_oracle=use_oracle, pair_capacity=pair_capacity,
                 tile16=tile16, device=dev)
    med = losses.median_depth(out.depth, out.opacity)
    return R, t, ea, eb, itr, out, med


@torch.no_grad()
def track_frame(
    gm: GaussianMap,
    cam_template: Camera,
    R0: torch.Tensor, t0: torch.Tensor,
    gt_image: torch.Tensor,
    gt_depth: torch.Tensor,
    grad_mask: torch.Tensor,
    bg: torch.Tensor,
    lr_rot: float, lr_trans: float,
    rgb_boundary_threshold: float,
    alpha: float = 0.95,
    monocular: bool = False,
    max_iters: int = 100,
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    amortize_binning: bool = True,
    tile16: bool = False,
    device=None,
):
    """The reference-parity Adam tracker (reference
    utils/slam_frontend.py:128-196): up to ``max_iters`` iterations of
    render + masked tracking loss + backward + Adam step on (tau, exposure
    a, b), the pose delta retracted onto (R, t) after every step,
    converged when ||tau|| < 1e-4. ``amortize_binning`` bins once from the
    warm start (radius_scale 1.1, pad 8 px) and reuses that plan; the
    final keyframing render at the converged pose plans afresh. Under
    ``tile16`` (a port extension, as in ``track_frame_gn``) every plan
    and render uses 16-px tiles.

    Returns (R, t, exposure_a, exposure_b, n_iters, final RenderOutput,
    median_depth). ``device=None`` means CUDA."""
    dev = resolve_device(device)
    _check_frame(dev, gm, cam_template, R0, t0, gt_image, gt_depth,
                 grad_mask, bg)
    f32 = torch.float32
    lrs = torch.tensor([lr_trans] * 3 + [lr_rot] * 3 + [0.01] * 2,
                       dtype=f32, device=dev)
    plan = (make_render_plan(
        gm, cam_template.replace(R=R0, t=t0), pair_capacity=pair_capacity,
        radius_scale=1.1, radius_pad=8.0, tile16=tile16, device=dev)
        if amortize_binning and not use_oracle else None)
    zero = torch.zeros((), dtype=f32, device=dev)
    loss_args = (gt_image, gt_depth, grad_mask, rgb_boundary_threshold,
                 alpha, monocular)

    def render_at(tau, R, t):
        return render(gm, cam_template.replace(R=R, t=t),
                      PoseState(tau=tau, exposure_a=zero, exposure_b=zero),
                      bg, use_oracle=use_oracle, pair_capacity=pair_capacity,
                      plan=plan, need_n_touched=False, tile16=tile16,
                      device=dev)

    R, t = R0, t0
    ea = torch.zeros((), dtype=f32, device=dev)
    eb = torch.zeros((), dtype=f32, device=dev)
    adam = TrackAdamState(m=torch.zeros(8, dtype=f32, device=dev),
                          v=torch.zeros(8, dtype=f32, device=dev),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))
    itr = 0
    converged = False
    while itr < max_iters and not converged:
        _, g, _ = _value_and_grad(lambda tau: render_at(tau, R, t), ea, eb,
                                  loss_args)
        upd, adam = _adam8(adam, g, lrs)
        # optimizer.step(): params -= upd; tau starts at 0, so new tau = -upd
        R, t, new_tau = _step_pose(upd, R, t)
        ea, eb = ea - upd[6], eb - upd[7]
        itr += 1
        converged = bool((torch.linalg.norm(new_tau) < 1e-4).item())

    out = render(gm, cam_template.replace(R=R, t=t), None, bg,
                 use_oracle=use_oracle, pair_capacity=pair_capacity,
                 tile16=tile16, device=dev)
    med = losses.median_depth(out.depth, out.opacity)
    return R, t, ea, eb, itr, out, med

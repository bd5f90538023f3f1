"""Keyframe-window map optimization, the backend's hot loop (torch port of
slam/mapping.py).

One iteration renders every valid window keyframe and the (up to 2)
random past keyframes, sums the mapping loss (+ 10 x the isotropic scale
term), takes one Adam step on the Gaussian parameters and one on the
window's poses and exposures (never keyframe 0's), and accumulates the
densification statistics from each frame's screen-space mean gradient.

Where the reference runs a ``lax.scan`` over iterations and a
``lax.cond`` per frame slot, the port runs Python loops: slot validity is
known on the host, so an invalid slot is skipped (zero loss, zero radii).
Each frame's loss is differentiated on its own (``backward`` into the
parameters' accumulated gradients), which equals the gradient of the
summed loss and keeps the memory of one frame's graph; the isotropic term
is added once. Window pair plans are built once per ``mapping_steps``
call (radius_scale 1.1, pad 6 px, opa_growth 2.23) from the entry state.

``KFStore`` keeps keyframes quantized as the reference does (u8 RGB,
16-bit depth codes with a per-slot scale). torch's ``uint16`` has few
operations, so the depth codes are stored in int32: the same values,
dequantized the same way.

With ``mesh`` (parallel/sharding.py: one process per rank, every rank
calling ``mapping_steps`` with the same arguments) the frame slots split
into contiguous shards, one per rank: each rank renders and
differentiates its own, and one all-reduce per iteration sums the
parameter gradients, the loss, and the per-frame pose and exposure
gradients, radii and screen-space gradient norms (zero in the slots of
other ranks), after which every rank takes the same Adam steps and
densification statistics as one rank would. The isotropic term is added
after the sum, once. Window plans on the mesh are built by each rank for
its own slots when every slot is planned (``n_planned == F``), and are
not handed back for reuse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.camera import Camera, PoseState
from ..models.gaussian_map import (AdamState, GaussianMap, PARAM_FIELDS,
                                   adam_update)
from ..ops import losses
from ..ops.lie import pose_matrix, se3_exp
from ..parallel.sharding import (all_reduce, check_mesh, flat_grads,
                                 unflat_grads)
from ..utils.trace import span
from .render_api import make_render_plan, render
from .tracking import _cam_level, _pool_avg, _stride_center

# window plans: grown radii and pad cover the pose and xyz drift of a
# batch, opa_growth 2.23 the opacity drift (the reference's values)
PLAN_RADIUS_SCALE = 1.1
PLAN_RADIUS_PAD = 6.0
PLAN_OPA_GROWTH = 2.23


@dataclasses.dataclass(frozen=True)
class KFStore:
    """Fixed-capacity keyframe store on the device: poses, exposures, and
    quantized ground truth (u8 RGB; depth as 16-bit codes in int32 times a
    per-slot scale)."""

    R: torch.Tensor            # (M, 3, 3)
    t: torch.Tensor            # (M, 3)
    exposure_a: torch.Tensor   # (M,)
    exposure_b: torch.Tensor   # (M,)
    gt_image: torch.Tensor     # (M, 3, H, W) uint8
    gt_depth: torch.Tensor     # (M, 1, H, W) int32 codes in [0, 65535]
    depth_scale: torch.Tensor  # (M,) f32 meters per code step
    valid: torch.Tensor        # (M,) bool
    uid: torch.Tensor          # (M,) int32

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @staticmethod
    def empty(capacity: int, height: int, width: int,
              device=None) -> "KFStore":
        dev = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        return KFStore(
            R=torch.eye(3, **f32).repeat(capacity, 1, 1),
            t=torch.zeros(capacity, 3, **f32),
            exposure_a=torch.zeros(capacity, **f32),
            exposure_b=torch.zeros(capacity, **f32),
            gt_image=torch.zeros(capacity, 3, height, width,
                                 dtype=torch.uint8, device=dev),
            gt_depth=torch.zeros(capacity, 1, height, width,
                                 dtype=torch.int32, device=dev),
            depth_scale=torch.zeros(capacity, **f32),
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
            uid=torch.full((capacity,), -1, dtype=torch.int32, device=dev))

    def grow(self, new_capacity: int) -> "KFStore":
        """Pad every array with empty slots up to ``new_capacity``."""
        pad = new_capacity - self.capacity
        if pad <= 0:
            return self
        h, w = self.gt_image.shape[2:]
        more = KFStore.empty(pad, h, w, device=self.R.device)
        return KFStore(**{
            f.name: torch.cat([getattr(self, f.name), getattr(more, f.name)])
            for f in dataclasses.fields(KFStore)})

    def add(self, slot: int, R, t, exposure_a, exposure_b, gt_image,
            gt_depth, uid: int) -> "KFStore":
        """Store a keyframe in ``slot``: gt_image (3, H, W) in [0, 1],
        gt_depth (1, H, W) in meters, quantized as the reference does."""
        img_q = torch.round(torch.clamp(gt_image, 0.0, 1.0) * 255.0
                            ).to(torch.uint8)
        dmax = torch.amax(gt_depth)
        zero = torch.zeros_like(dmax)
        scale = torch.where(dmax > 0, dmax / 65535.0, zero)
        dep_q = torch.round(gt_depth * torch.where(
            dmax > 0, 65535.0 / torch.clamp(dmax, min=1e-9), zero)
        ).to(torch.int32)

        def put(a, v):
            a = a.clone()
            a[slot] = v
            return a
        return KFStore(
            R=put(self.R, R), t=put(self.t, t),
            exposure_a=put(self.exposure_a, exposure_a),
            exposure_b=put(self.exposure_b, exposure_b),
            gt_image=put(self.gt_image, img_q),
            gt_depth=put(self.gt_depth, dep_q),
            depth_scale=put(self.depth_scale, scale),
            valid=put(self.valid, True), uid=put(self.uid, uid))

    def image(self, idx) -> torch.Tensor:
        """(3, H, W) f32 dequantized ground-truth image of slot ``idx``."""
        return self.gt_image[idx].to(torch.float32) * (1.0 / 255.0)

    def depth(self, idx) -> torch.Tensor:
        """(1, H, W) f32 dequantized ground-truth depth of slot ``idx``."""
        return self.gt_depth[idx].to(torch.float32) * self.depth_scale[idx]

    @staticmethod
    def from_jax_fields(fields: Dict[str, np.ndarray],
                        device=None) -> "KFStore":
        """Carry a reference ``KFStore`` across: every field as a numpy
        array, keyed by field name (its u16 depth codes become int32)."""
        dev = resolve_device(device)
        dtypes = {"gt_image": (np.uint8, torch.uint8),
                  "gt_depth": (np.int32, torch.int32),
                  "valid": (np.bool_, torch.bool),
                  "uid": (np.int32, torch.int32)}
        out = {}
        for f in dataclasses.fields(KFStore):
            np_dt, t_dt = dtypes.get(f.name, (np.float32, torch.float32))
            out[f.name] = torch.tensor(np.asarray(fields[f.name], np_dt),
                                       dtype=t_dt, device=dev)
        return KFStore(**out)


class PoseAdamState(NamedTuple):
    """Adam moments of the window's [tau (6), exposure a, b] per slot."""

    m: torch.Tensor      # (F, 8)
    v: torch.Tensor      # (F, 8)
    step: torch.Tensor   # () int32

    @staticmethod
    def zero(F: int, device=None) -> "PoseAdamState":
        dev = resolve_device(device)
        return PoseAdamState(torch.zeros(F, 8, device=dev),
                             torch.zeros(F, 8, device=dev),
                             torch.zeros((), dtype=torch.int32, device=dev))

    @staticmethod
    def from_jax(m, v, step, device=None) -> "PoseAdamState":
        """Carry a reference ``PoseAdamState`` across (numpy arrays)."""
        dev = resolve_device(device)
        return PoseAdamState(
            torch.tensor(np.asarray(m), dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(v), dtype=torch.float32, device=dev),
            torch.tensor(int(step), dtype=torch.int32, device=dev))


class MapStepOut(NamedTuple):
    gm: GaussianMap
    gm_adam: AdamState
    store: KFStore
    pose_adam: PoseAdamState
    loss: torch.Tensor        # () the last iteration's loss
    n_touched: torch.Tensor   # (F, C) int32 (window slots only meaningful)
    radii: torch.Tensor       # (F, C) f32, the last iteration's
    window_plans: object = None   # the window slots' plans (list, None
                                  # per invalid slot), reusable by the next
                                  # batch over the same slots and set


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _level_lowpass(level: int) -> float:
    """The EWA low-pass matched to the pooled ground truth's blur."""
    if level == 1:
        return 0.3
    return (0.3 + (level * level - 1) / 12.0) / (level * level)


def _window_plans(gm, store, slots, valid, cam_lvl, pair_capacity, tile16,
                  dev):
    """One pair plan per slot from the current map and store pose (None
    for an invalid slot, which never renders)."""
    with span("mapping.plans"):
        return [make_render_plan(
            gm, cam_lvl.replace(R=store.R[s], t=store.t[s]),
            pair_capacity=pair_capacity, radius_scale=PLAN_RADIUS_SCALE,
            radius_pad=PLAN_RADIUS_PAD, tile16=tile16,
            opa_growth=PLAN_OPA_GROWTH, device=dev) if v else None
            for s, v in zip(slots, valid)]


def _mapping_iter(
    gm, gm_adam, store, pose_adam, window_idx, window_valid, optimize_pose,
    optimize_exposure, cam_template, bg, gm_lrs, xyz_lr, lr_rot, lr_trans,
    rgb_boundary_threshold, n_window, alpha, monocular, initialization,
    pair_capacity, use_oracle, tile16, window_plans, level, gt_cache,
    mesh=None,
) -> MapStepOut:
    """One map-optimization iteration (the reference's ``_mapping_iter``).
    ``window_idx``, ``window_valid``, ``optimize_pose`` and
    ``optimize_exposure`` are host sequences of length F; ``window_plans``
    holds plans for the leading slots (the rest plan afresh);
    ``gt_cache`` maps a slot to its (pooled) ground truth. On a ``mesh``
    this rank renders only its shard of the slots."""
    with span("mapping.iter"):
        F = len(window_idx)
        C = gm.capacity
        dev = gm.device
        f32 = torch.float32
        cam_lvl = _cam_level(cam_template, level)
        lp = _level_lowpass(level)
        n_planned = 0 if window_plans is None else len(window_plans)

        params = {f: getattr(gm, f).detach().requires_grad_()
                  for f in PARAM_FIELDS}
        gm_p = gm.replace(**params)
        slots = torch.as_tensor(np.asarray(window_idx), device=dev)
        exp_a_w = store.exposure_a[slots]
        exp_b_w = store.exposure_b[slots]

        total = torch.zeros((), dtype=f32, device=dev)
        zeros_c = torch.zeros(C, dtype=f32, device=dev)
        g_tau = torch.zeros(F, 6, dtype=f32, device=dev)
        g_ea = torch.zeros(F, dtype=f32, device=dev)
        g_eb = torch.zeros(F, dtype=f32, device=dev)
        radii, g_norm = [], []
        scale_vec = torch.tensor([0.5 * cam_template.width,
                                  0.5 * cam_template.height], dtype=f32,
                                 device=dev)
        mine = range(F) if mesh is None else mesh.shard(F)
        for j in range(F):
            if not window_valid[j] or j not in mine:
                radii.append(zeros_c)
                g_norm.append(zeros_c)
                continue
            s = int(window_idx[j])
            if s not in gt_cache:
                gt_i, gt_d = store.image(s), store.depth(s)
                if level > 1:
                    gt_i = _pool_avg(gt_i, level)
                    gt_d = _stride_center(gt_d, level)
                gt_cache[s] = (gt_i, gt_d)
            gt_i, gt_d = gt_cache[s]
            tau = torch.zeros(6, dtype=f32, device=dev, requires_grad=True)
            ea = exp_a_w[j].detach().requires_grad_()
            eb = exp_b_w[j].detach().requires_grad_()
            m2o = torch.zeros(C, 2, dtype=f32, device=dev, requires_grad=True)
            with span("mapping.render"):
                out = render(
                    gm_p, cam_lvl.replace(R=store.R[s], t=store.t[s]),
                    PoseState(tau=tau, exposure_a=ea, exposure_b=eb), bg,
                    mean2d_offset=m2o, use_oracle=use_oracle,
                    pair_capacity=pair_capacity,
                    plan=window_plans[j] if j < n_planned else None,
                    need_n_touched=False, tile16=tile16, low_pass=lp,
                    device=dev)
            with span("mapping.loss"):
                image_ab = (out.color if initialization
                            else losses.apply_exposure(out.color, ea, eb))
                if monocular:
                    L = losses.loss_mapping_rgb(image_ab, gt_i,
                                                rgb_boundary_threshold)
                else:
                    L = losses.loss_mapping_rgbd(
                        image_ab, out.depth, gt_i, gt_d,
                        rgb_boundary_threshold, alpha)
            with span("mapping.backward"):
                L.backward()
            total = total + L.detach()
            g_tau[j] = tau.grad
            if ea.grad is not None:
                g_ea[j], g_eb[j] = ea.grad, eb.grad
            radii.append(out.radii.detach())
            # level renders see ~level x larger |dL/d mean2d| for the same
            # scene error: rescale to the full-resolution densify units
            g_norm.append(torch.linalg.norm(m2o.grad * scale_vec, dim=-1)
                          / level)
        g_params = {f: (p.grad if p.grad is not None else torch.zeros_like(p))
                    for f, p in params.items()}
        radii = torch.stack(radii)                                     # (F, C)
        g_norm = torch.stack(g_norm)
        if mesh is not None:
            # one all-reduce: every per-frame row is zero on the ranks that
            # do not own the frame, so the sums are the one-rank values
            buf = all_reduce(torch.cat([
                flat_grads(g_params), g_tau.reshape(-1), g_ea, g_eb,
                radii.reshape(-1), g_norm.reshape(-1), total[None]]), mesh)
            n_p = buf.numel() - (8 * F + 2 * F * C + 1)
            g_params = unflat_grads(buf[:n_p], g_params)
            rest = buf[n_p:]
            g_tau = rest[:6 * F].reshape(F, 6)
            g_ea, g_eb = rest[6 * F:7 * F], rest[7 * F:8 * F]
            radii = rest[8 * F:8 * F + F * C].reshape(F, C)
            g_norm = rest[8 * F + F * C:8 * F + 2 * F * C].reshape(F, C)
            total = rest[-1]
        # the isotropic term counts once, after the frames' sum
        iso = 10.0 * losses.isotropic_loss(params["scaling"], gm.active)
        (g_iso,) = torch.autograd.grad(iso, params["scaling"])
        g_params["scaling"] = g_params["scaling"] + g_iso
        loss_val = total + iso.detach()

        # Gaussian Adam step (xyz lr from the schedule)
        lrs = dict(gm_lrs)
        lrs["xyz"] = xyz_lr
        with torch.no_grad(), span("mapping.step"):
            new_gm, new_gm_adam = adam_update(gm, g_params, gm_adam, lrs)

            # densification statistics and max radii over the valid frames
            wv = torch.as_tensor(np.asarray(window_valid, bool), device=dev)
            upd = (radii > 0) & wv[:, None] & new_gm.active[None, :]
            zero = torch.zeros_like(radii)
            new_gm = new_gm.replace(
                xyz_grad_accum=new_gm.xyz_grad_accum
                + torch.sum(torch.where(upd, g_norm, zero), dim=0),
                denom=new_gm.denom + torch.sum(upd.to(f32), dim=0),
                # level radii are in level pixels, the size prune in full-res
                max_radii2d=torch.maximum(
                    new_gm.max_radii2d,
                    torch.amax(torch.where(upd, radii * level, zero), dim=0)))

            # keyframe pose / exposure Adam (eps 1e-8, torch.optim.Adam's)
            g8 = torch.cat([g_tau, g_ea[:, None], g_eb[:, None]], dim=1)
            lr8 = np.zeros((F, 8), np.float32)
            lr8[np.asarray(optimize_pose, bool), :3] = lr_trans
            lr8[np.asarray(optimize_pose, bool), 3:6] = lr_rot
            lr8[np.asarray(optimize_exposure, bool), 6:] = 0.01
            lr8 = torch.as_tensor(lr8, device=dev)
            b1, b2, eps = 0.9, 0.999, 1e-8
            step = pose_adam.step + 1
            tt = step.to(f32)
            m = b1 * pose_adam.m + (1 - b1) * g8
            v = b2 * pose_adam.v + (1 - b2) * g8 * g8
            updv = lr8 * (m / (1 - b1 ** tt)) / (torch.sqrt(v / (1 - b2 ** tt))
                                                 + eps)
            new_pose_adam = PoseAdamState(m=m, v=v, step=step)
            new_ea = exp_a_w - updv[:, 6]
            new_eb = exp_b_w - updv[:, 7]

            # write back the valid window slots (the first n_window entries)
            R, t = store.R.clone(), store.t.clone()
            ea_s, eb_s = store.exposure_a.clone(), store.exposure_b.clone()
            for j in range(n_window):
                if not window_valid[j]:
                    continue
                s = int(window_idx[j])
                if optimize_pose[j]:
                    nT = se3_exp(-updv[j, :6]) @ pose_matrix(store.R[s],
                                                             store.t[s])
                    R[s], t[s] = nT[:3, :3], nT[:3, 3]
                ea_s[s], eb_s[s] = new_ea[j], new_eb[j]
            new_store = dataclasses.replace(store, R=R, t=t, exposure_a=ea_s,
                                            exposure_b=eb_s)
        return MapStepOut(gm=new_gm, gm_adam=new_gm_adam, store=new_store,
                          pose_adam=new_pose_adam, loss=loss_val,
                          n_touched=None, radii=radii)


def mapping_steps(
    gm: GaussianMap,
    gm_adam: AdamState,
    store: KFStore,
    window_idx,                    # (T, F) slots per iteration (host)
    window_valid,                  # (F,) bool (host)
    optimize_pose,                 # (F,) bool (host)
    optimize_exposure,             # (F,) bool (host)
    pose_adam: PoseAdamState,
    cam_template: Camera,
    bg: torch.Tensor,
    gm_lrs: Dict[str, torch.Tensor],
    xyz_lrs: Sequence[float],      # (T,) scheduled xyz learning rates
    lr_rot: float, lr_trans: float,
    rgb_boundary_threshold: float,
    n_window: int,
    alpha: float = 0.95,
    monocular: bool = False,
    initialization: bool = False,
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    tile16: bool = False,
    mesh=None,
    need_n_touched: bool = True,
    window_plans_in: Optional[List] = None,
    n_planned: Optional[int] = None,
    level: int = 1,
) -> MapStepOut:
    """T map iterations (the reference's ``mapping_steps``). The slot
    layout (``window_idx``, validity and optimize flags) is host data, as
    the backend knows it; the map, store and optimizer states stay on
    their device. Pair plans for the first ``n_planned`` slots (default
    ``n_window``) are built once from the entry state, or taken from
    ``window_plans_in`` for the window part; the others plan afresh at
    every render. ``level`` > 1 renders at 1/level resolution against the
    pooled ground truth with the blur-matched low-pass. With
    ``need_n_touched`` the window's n_touched is rendered at the final
    state (``window_visibility``). With ``mesh`` (a
    ``parallel.sharding.Mesh``; every rank calls this with the same
    arguments) each rank renders its shard of the F slots, F a multiple
    of the mesh size; the plans are per rank (built when ``n_planned ==
    F``), so ``window_plans_in`` is not taken there and none are
    returned."""
    if mesh is not None:
        check_mesh(mesh)
    dev = gm.device
    rows = _host(window_idx).astype(np.int64)
    valid = [bool(v) for v in _host(window_valid)]
    opt_pose = [bool(v) for v in _host(optimize_pose)]
    opt_exp = [bool(v) for v in _host(optimize_exposure)]
    if n_planned is None:
        n_planned = n_window

    window_part = plans = None
    if mesh is not None:
        if window_plans_in is not None:
            raise ValueError("window_plans_in is not taken on a mesh (each "
                             "rank plans its own slots)")
        mine = mesh.shard(len(valid))
        if not use_oracle and n_planned == len(valid):
            plans = _window_plans(
                gm, store, rows[0], [v and j in mine
                                     for j, v in enumerate(valid)],
                _cam_level(cam_template, level), pair_capacity, tile16, dev)
    elif not use_oracle:
        cam_lvl = _cam_level(cam_template, level)
        if window_plans_in is not None:
            window_part = list(window_plans_in)
        else:
            window_part = _window_plans(
                gm, store, rows[0, :n_window], valid[:n_window], cam_lvl,
                pair_capacity, tile16, dev)
        plans = window_part
        if n_planned > n_window:
            # per-batch-fixed random slots: planned once per batch too
            plans = window_part + _window_plans(
                gm, store, rows[0, n_window:n_planned],
                valid[n_window:n_planned], cam_lvl, pair_capacity, tile16,
                dev)

    xyz_lrs = torch.as_tensor(np.asarray(xyz_lrs, np.float32), device=dev)
    gt_cache: Dict[int, tuple] = {}
    out = None
    for i in range(rows.shape[0]):
        out = _mapping_iter(
            gm, gm_adam, store, pose_adam, rows[i], valid, opt_pose,
            opt_exp, cam_template, bg, gm_lrs, xyz_lrs[i], lr_rot, lr_trans,
            rgb_boundary_threshold, n_window, alpha, monocular,
            initialization, pair_capacity, use_oracle, tile16, plans, level,
            gt_cache, mesh)
        gm, gm_adam, store, pose_adam = (out.gm, out.gm_adam, out.store,
                                         out.pose_adam)

    if need_n_touched:
        # n_touched at the final state, for visibility and covisibility
        nt = window_visibility(gm, store, rows[-1], valid, cam_template, bg,
                               pair_capacity=pair_capacity,
                               use_oracle=use_oracle, tile16=tile16,
                               mesh=mesh)
    else:
        nt = torch.zeros(len(valid), gm.capacity, dtype=torch.int32,
                         device=dev)
    return out._replace(n_touched=nt, window_plans=window_part)


@torch.no_grad()
def window_visibility(
    gm: GaussianMap,
    store: KFStore,
    window_idx,                    # (F,) slots (host)
    window_valid,                  # (F,) bool (host)
    cam_template: Camera,
    bg: torch.Tensor,
    pair_capacity: int = 1 << 20,
    use_oracle: bool = False,
    tile16: bool = False,
    mesh=None,
) -> torch.Tensor:
    """(F, C) int32 per-frame n_touched at the current map and poses
    (zeros for an invalid slot): the occlusion-aware visibility. On a
    ``mesh`` each rank renders its shard and one all-reduce assembles the
    rows on every rank."""
    with span("mapping.visibility"):
        rows = []
        slots = _host(window_idx).tolist()
        mine = range(len(slots)) if mesh is None else mesh.shard(len(slots))
        for j, (s, v) in enumerate(zip(slots, _host(window_valid))):
            if not v or j not in mine:
                rows.append(torch.zeros(gm.capacity, dtype=torch.int32,
                                        device=gm.device))
                continue
            cam = cam_template.replace(R=store.R[s], t=store.t[s])
            rows.append(render(gm, cam, None, bg, pair_capacity=pair_capacity,
                               use_oracle=use_oracle, tile16=tile16,
                               device=gm.device).n_touched)
        nt = torch.stack(rows)
        if mesh is not None:
            all_reduce(nt, mesh)
        return nt


def _refinement_grads(gm, store, idx, cam_template, bg, lambda_dssim,
                      pair_capacity, use_oracle, tile16, need_n_touched):
    params = {f: getattr(gm, f).detach().requires_grad_()
              for f in PARAM_FIELDS}
    cam = cam_template.replace(R=store.R[idx], t=store.t[idx])
    out = render(gm.replace(**params), cam, None, bg,
                 pair_capacity=pair_capacity, use_oracle=use_oracle,
                 tile16=tile16, need_n_touched=need_n_touched,
                 device=gm.device)
    gt = store.image(idx)
    L = ((1.0 - lambda_dssim) * losses.l1_loss(out.color, gt)
         + lambda_dssim * (1.0 - losses.ssim(out.color, gt)))
    L.backward()
    return L.detach(), {f: (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                        for f, p in params.items()}


def color_refinement_step(
    gm: GaussianMap, gm_adam: AdamState, store: KFStore, idx: int,
    cam_template: Camera, bg: torch.Tensor, gm_lrs,
    lambda_dssim: float = 0.2, pair_capacity: int = 1 << 20,
    use_oracle: bool = False, tile16: bool = False,
):
    """One color-refinement iteration on keyframe slot ``idx``:
    (1 - l) L1 + l (1 - SSIM). Returns (map, Adam state, loss)."""
    L, g = _refinement_grads(gm, store, idx, cam_template, bg, lambda_dssim,
                             pair_capacity, use_oracle, tile16, True)
    with torch.no_grad():
        new_gm, new_adam = adam_update(gm, g, gm_adam, gm_lrs)
    return new_gm, new_adam, L


def color_refinement_steps(
    gm: GaussianMap, gm_adam: AdamState, store: KFStore,
    idxs: Sequence[int],           # (T,) keyframe slot per iteration
    xyz_lrs: Sequence[float],      # (T,) scheduled xyz learning rates
    cam_template: Camera, bg: torch.Tensor, gm_lrs,
    lambda_dssim: float = 0.2, pair_capacity: int = 1 << 20,
    use_oracle: bool = False, tile16: bool = False,
):
    """T color-refinement iterations, the xyz lr from the schedule.
    Returns (map, Adam state, the last iteration's loss)."""
    xyz = torch.as_tensor(np.asarray(xyz_lrs, np.float32), device=gm.device)
    L = None
    for i, idx in enumerate(_host(idxs).tolist()):
        L, g = _refinement_grads(gm, store, idx, cam_template, bg,
                                 lambda_dssim, pair_capacity, use_oracle,
                                 tile16, False)
        lrs = dict(gm_lrs)
        lrs["xyz"] = xyz[i]
        with torch.no_grad():
            gm, gm_adam = adam_update(gm, g, gm_adam, lrs)
    return gm, gm_adam, L

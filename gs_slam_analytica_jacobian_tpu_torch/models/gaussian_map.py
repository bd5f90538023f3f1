"""Fixed-capacity Gaussian map and its optimizer (torch port of
models/gaussian_map.py).

A frozen dataclass of tensors with an ``active`` mask over a padded
capacity, the same fields and activations as the reference, and the
reference's masked-compaction surgery on it: ``extend`` scatters new
Gaussians into free slots (their Adam moments zeroed), ``prune`` clears
``active`` (and the moments), ``densify_and_prune`` clones, splits and
prunes, ``grow`` doubles the capacity on the host. ``adam_update`` is
torch.optim.Adam with per-group learning rates and eps 1e-15, one shared
step; inactive rows carry zero gradients and moments. Every function
returns new tensors and leaves its inputs as they were, like the
reference's.

``from_jax_fields`` and ``adam_from_jax_fields`` carry a reference map's
weights and optimizer state across: they take the JAX values as numpy
arrays keyed by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sh as sh_ops
from ..ops.gaussian_math import build_cov3d
from ..ops.lie import quat_to_rotmat

# every array field of the map, in the reference's order
ARRAY_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "active", "unique_kfids", "n_obs", "max_radii2d",
                "xyz_grad_accum", "denom")

_DTYPES = {"active": torch.bool, "unique_kfids": torch.int32,
           "n_obs": torch.int32}


@dataclasses.dataclass(frozen=True)
class GaussianMap:
    """Padded parameter store; only rows with ``active`` render."""

    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log-scale
    rotation: torch.Tensor       # (C, 4) quaternion (w, x, y, z)
    opacity: torch.Tensor        # (C, 1) logit
    active: torch.Tensor         # (C,) bool
    unique_kfids: torch.Tensor   # (C,) int32
    n_obs: torch.Tensor          # (C,) int32
    max_radii2d: torch.Tensor    # (C,) f32
    xyz_grad_accum: torch.Tensor  # (C,) f32
    denom: torch.Tensor          # (C,) f32
    max_sh_degree: int
    active_sh_degree: int
    isotropic: bool = False

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        n = torch.linalg.norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(n, min=1e-12)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)[:, 0]

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_cov6(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return build_cov3d(self.get_scaling(), self.rotation, scale_modifier)

    def replace(self, **kw) -> "GaussianMap":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(capacity: int, max_sh_degree: int = 0, isotropic: bool = False,
              device=None) -> "GaussianMap":
        dev = resolve_device(device)
        k_rest = sh_ops.num_sh_coeffs(max_sh_degree) - 1

        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)

        rot = torch.zeros(capacity, 4, device=dev)
        rot[:, 0] = 1.0
        return GaussianMap(
            xyz=z(capacity, 3), features_dc=z(capacity, 1, 3),
            features_rest=z(capacity, k_rest, 3), scaling=z(capacity, 3),
            rotation=rot, opacity=z(capacity, 1),
            active=torch.zeros(capacity, dtype=torch.bool, device=dev),
            unique_kfids=torch.zeros(capacity, dtype=torch.int32, device=dev),
            n_obs=torch.zeros(capacity, dtype=torch.int32, device=dev),
            max_radii2d=z(capacity), xyz_grad_accum=z(capacity),
            denom=z(capacity), max_sh_degree=max_sh_degree,
            active_sh_degree=0, isotropic=isotropic)


def from_numpy(
    xyz: np.ndarray, features_dc: np.ndarray, features_rest: np.ndarray,
    scaling: np.ndarray, rotation: np.ndarray, opacity: np.ndarray,
    max_sh_degree: int, capacity: Optional[int] = None,
    active_sh_degree: Optional[int] = None, device=None,
) -> GaussianMap:
    """Build a map from raw (log/logit-space) parameter arrays; rows past
    ``len(xyz)`` up to ``capacity`` stay inactive."""
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    gm = GaussianMap.empty(capacity, max_sh_degree, device=device)
    if active_sh_degree is None:
        active_sh_degree = max_sh_degree
    dev = gm.device

    def put(dst, src, shape):
        out = dst.clone()
        out[:n] = torch.tensor(
            np.asarray(src, np.float32).reshape(shape), device=dev)
        return out

    k_rest = gm.features_rest.shape[1]
    rest = np.asarray(features_rest, np.float32).reshape(n, -1, 3)[:, :k_rest]
    active = gm.active.clone()
    active[:n] = True
    return gm.replace(
        xyz=put(gm.xyz, xyz, (n, 3)),
        features_dc=put(gm.features_dc, features_dc, (n, 1, 3)),
        features_rest=put(gm.features_rest, rest, (n, k_rest, 3)),
        scaling=put(gm.scaling, scaling, (n, 3)),
        rotation=put(gm.rotation, rotation, (n, 4)),
        opacity=put(gm.opacity, opacity, (n, 1)),
        active=active,
        active_sh_degree=active_sh_degree,
    )


def from_jax_fields(fields: Dict[str, np.ndarray], max_sh_degree: int,
                    active_sh_degree: int, isotropic: bool = False,
                    device=None) -> GaussianMap:
    """Carry a reference map's weights across: ``fields`` holds every
    array field of the JAX ``GaussianMap`` as a numpy array, keyed by field
    name (e.g. ``{f: np.asarray(getattr(gm_jax, f)) for f in
    ARRAY_FIELDS}``); the static fields are passed as they are."""
    dev = resolve_device(device)
    missing = [f for f in ARRAY_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing GaussianMap fields: {missing}")
    arrays = {
        f: torch.tensor(np.asarray(fields[f]),
                        dtype=_DTYPES.get(f, torch.float32), device=dev)
        for f in ARRAY_FIELDS}
    return GaussianMap(**arrays, max_sh_degree=int(max_sh_degree),
                       active_sh_degree=int(active_sh_degree),
                       isotropic=bool(isotropic))


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


class ParamBlock(NamedTuple):
    """A padded block of candidate Gaussians with a validity mask."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    kf_id: torch.Tensor          # (M,) int32
    valid: torch.Tensor          # (M,) bool


PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")


# ---------------------------------------------------------------------------
# Adam with torch semantics (per-group lrs, eps=1e-15)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # () int32, shared across groups


def adam_init(gm: GaussianMap) -> AdamState:
    return AdamState(
        m={f: torch.zeros_like(getattr(gm, f)) for f in PARAM_FIELDS},
        v={f: torch.zeros_like(getattr(gm, f)) for f in PARAM_FIELDS},
        step=torch.zeros((), dtype=torch.int32, device=gm.device))


def adam_update(
    gm: GaussianMap, grads: Dict[str, torch.Tensor], state: AdamState,
    lrs: Dict[str, torch.Tensor],
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
) -> Tuple[GaussianMap, AdamState]:
    """One torch-Adam step over the map parameters."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    new_m, new_v, new_p = {}, {}, {}
    for f in PARAM_FIELDS:
        g = grads[f]
        m = b1 * state.m[f] + (1 - b1) * g
        v = b2 * state.v[f] + (1 - b2) * (g * g)
        new_m[f], new_v[f] = m, v
        upd = lrs[f] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[f] = getattr(gm, f) - upd
    return gm.replace(**new_p), AdamState(m=new_m, v=new_v, step=step)


def xyz_lr_schedule(step, lr_init: float, lr_final: float,
                    lr_delay_mult: float, max_steps: int):
    """Log-lerp xyz LR decay (``lr_delay_mult`` is unused, as in the
    reference)."""
    t = torch.clamp(torch.as_tensor(step / max_steps, dtype=torch.float32),
                    0.0, 1.0)
    return torch.exp(torch.log(torch.tensor(lr_init)) * (1 - t)
                     + torch.log(torch.tensor(lr_final)) * t)


def default_lrs(opt_params: dict, spatial_lr_scale: float, xyz_lr=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Per-group learning rates (the reference's training_setup), as f32
    scalars on ``device``."""
    dev = resolve_device(device)
    if xyz_lr is None:
        xyz_lr = opt_params["position_lr_init"] * spatial_lr_scale

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return dict(
        xyz=f32(xyz_lr),
        features_dc=f32(opt_params["feature_lr"]),
        features_rest=f32(opt_params["feature_lr"] / 20.0),
        opacity=f32(opt_params["opacity_lr"]),
        scaling=f32(opt_params["scaling_lr"] * spatial_lr_scale),
        rotation=f32(opt_params["rotation_lr"]),
    )


# ---------------------------------------------------------------------------
# Masked-compaction map surgery
# ---------------------------------------------------------------------------

def _rows(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (a.dim() - 1))


def _zero_state_rows(state: AdamState, rows_mask: torch.Tensor) -> AdamState:
    def z(d):
        return {f: torch.where(_rows(rows_mask, a), torch.zeros_like(a), a)
                for f, a in d.items()}
    return AdamState(m=z(state.m), v=z(state.v), step=state.step)


def _scatter_rows(dst: torch.Tensor, target: torch.Tensor,
                  src) -> torch.Tensor:
    """dst.at[target].set(src, mode="drop") for 0 <= target <= C: the
    index C lands in a spare row that is cut off."""
    pad = torch.zeros((1,) + tuple(dst.shape[1:]), dtype=dst.dtype,
                      device=dst.device)
    out = torch.cat([dst, pad])
    out[target.long()] = src
    return out[:-1]


def _stable_argsort_bool(x: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(x, stable=True) for a bool vector (False first)."""
    return torch.sort(x.to(torch.int8), stable=True).indices


def extend(gm: GaussianMap, state: AdamState, block: ParamBlock
           ) -> Tuple[GaussianMap, AdamState, torch.Tensor]:
    """Scatter a ParamBlock into free slots (the i-th valid candidate, in
    block order, to the i-th free slot, in slot order). Returns (map,
    state, overflow) where overflow counts valid candidates that did not
    fit."""
    C = gm.capacity
    M = block.valid.shape[0]
    dev = gm.device
    free_slots = _stable_argsort_bool(gm.active)               # (C,)
    n_free = C - gm.num_active()
    cand_order = _stable_argsort_bool(~block.valid)           # valid first
    n_valid = torch.sum(block.valid.to(torch.int32))
    n_place = torch.minimum(n_valid, n_free)
    overflow = n_valid - n_place

    idx = torch.arange(M, device=dev)
    place = idx < n_place
    target = free_slots[torch.clamp(idx, max=C - 1)]
    target = torch.where(place, target, torch.full_like(target, C))

    def scat(dst, src_field):
        return _scatter_rows(dst, target, getattr(block, src_field)[cand_order])

    new_gm = gm.replace(
        xyz=scat(gm.xyz, "xyz"),
        features_dc=scat(gm.features_dc, "features_dc"),
        features_rest=scat(gm.features_rest, "features_rest"),
        scaling=scat(gm.scaling, "scaling"),
        rotation=scat(gm.rotation, "rotation"),
        opacity=scat(gm.opacity, "opacity"),
        active=_scatter_rows(gm.active, target, True),
        unique_kfids=_scatter_rows(gm.unique_kfids, target,
                                   block.kf_id[cand_order].to(torch.int32)),
        n_obs=_scatter_rows(gm.n_obs, target, 0),
        max_radii2d=_scatter_rows(gm.max_radii2d, target, 0.0),
        xyz_grad_accum=_scatter_rows(gm.xyz_grad_accum, target, 0.0),
        denom=_scatter_rows(gm.denom, target, 0.0),
    )
    # new rows start with zero Adam moments
    newly = _scatter_rows(torch.zeros(C, dtype=torch.bool, device=dev),
                          target, True)
    return new_gm, _zero_state_rows(state, newly), overflow


def prune(gm: GaussianMap, state: AdamState, mask: torch.Tensor
          ) -> Tuple[GaussianMap, AdamState]:
    """Deactivate the rows where ``mask`` (and zero their moments)."""
    kill = mask & gm.active
    return gm.replace(active=gm.active & ~kill), _zero_state_rows(state, kill)


def add_densification_stats(gm: GaussianMap, mean2d_grad: torch.Tensor,
                            update_filter: torch.Tensor,
                            width: int, height: int) -> GaussianMap:
    """Accumulate ||dL/dmean2d|| in the reference's NDC-scaled units
    (pixel-space gradients times 0.5 W, 0.5 H)."""
    g = mean2d_grad * torch.tensor([0.5 * width, 0.5 * height],
                                   dtype=mean2d_grad.dtype,
                                   device=mean2d_grad.device)
    norm = torch.linalg.norm(g, dim=-1)
    upd = update_filter & gm.active
    zero = torch.zeros_like(norm)
    return gm.replace(
        xyz_grad_accum=gm.xyz_grad_accum + torch.where(upd, norm, zero),
        denom=gm.denom + upd.to(gm.denom.dtype))


def update_max_radii(gm: GaussianMap, radii: torch.Tensor,
                     visibility: torch.Tensor) -> GaussianMap:
    return gm.replace(max_radii2d=torch.where(
        visibility & gm.active, torch.maximum(gm.max_radii2d, radii),
        gm.max_radii2d))


def _reset_opacity_state(state: AdamState) -> AdamState:
    m, v = dict(state.m), dict(state.v)
    m["opacity"] = torch.zeros_like(m["opacity"])
    v["opacity"] = torch.zeros_like(v["opacity"])
    return AdamState(m=m, v=v, step=state.step)


def reset_opacity(gm: GaussianMap, state: AdamState,
                  value: float = 0.01) -> Tuple[GaussianMap, AdamState]:
    """opacity <- min(opacity, value) on active rows (more transparent
    gaussians keep theirs), and zero the opacity Adam state."""
    cur = torch.sigmoid(gm.opacity)
    tgt = inverse_sigmoid(torch.clamp(cur, max=value))
    new_op = torch.where(gm.active[:, None], tgt, gm.opacity)
    return gm.replace(opacity=new_op), _reset_opacity_state(state)


def reset_opacity_nonvisible(
    gm: GaussianMap, state: AdamState, visible_any: torch.Tensor,
    value: float = 0.4,
) -> Tuple[GaussianMap, AdamState]:
    """opacity <- value on active rows that no frame saw."""
    tgt = inverse_sigmoid(torch.full_like(gm.opacity, value))
    new_op = torch.where((gm.active & ~visible_any)[:, None], tgt,
                         gm.opacity)
    return gm.replace(opacity=new_op), _reset_opacity_state(state)


def split_noise(shape, generator: Optional[torch.Generator], device,
                n: int = 2):
    """The ``n`` standard-normal draws (each ``shape``) that place split
    children. A parity test hands ``densify_and_prune`` the reference's
    draws instead (``noise=``)."""
    return [torch.randn(shape, generator=generator, device=device)
            for _ in range(n)]


def densify_and_prune(
    gm: GaussianMap, state: AdamState, generator: Optional[torch.Generator],
    max_grad: float, min_opacity: float, extent: float,
    max_screen_size: Optional[float], percent_dense: float = 0.01,
    noise=None, counts: Optional[dict] = None,
) -> Tuple[GaussianMap, AdamState, torch.Tensor]:
    """densify_and_clone + densify_and_split + opacity/size prune. The
    split children's offsets are ``noise`` (two (C, 3) standard-normal
    draws) or, by default, two draws from ``generator``. A ``counts`` dict
    receives the clone, split and prune counts as device tensors. Returns
    (map, state, overflow)."""
    zero = torch.zeros_like(gm.denom)
    grads = torch.where(gm.denom > 0, gm.xyz_grad_accum / gm.denom, zero)
    max_scale = torch.amax(gm.get_scaling(), dim=-1)

    # clone: small gaussians with big view-space grads
    clone_mask = (gm.active & (grads >= max_grad)
                  & (max_scale <= percent_dense * extent))
    gm, state, ov1 = extend(gm, state, ParamBlock(
        xyz=gm.xyz, features_dc=gm.features_dc,
        features_rest=gm.features_rest, scaling=gm.scaling,
        rotation=gm.rotation, opacity=gm.opacity,
        kf_id=gm.unique_kfids, valid=clone_mask))

    # split: large gaussians with big grads -> N=2 children
    split_mask = (gm.active & (grads >= max_grad)
                  & (max_scale > percent_dense * extent))
    if counts is not None:
        counts["clone"] = torch.sum(clone_mask)
        counts["split"] = torch.sum(split_mask)
    N = 2
    if noise is None:
        noise = split_noise(gm.xyz.shape, generator, gm.device, N)
    R = quat_to_rotmat(gm.rotation)
    stds = gm.get_scaling()
    blocks = []
    for k in range(N):
        samples = noise[k] * stds
        new_xyz = torch.einsum("nij,nj->ni", R, samples) + gm.xyz
        blocks.append(ParamBlock(
            xyz=new_xyz, features_dc=gm.features_dc,
            features_rest=gm.features_rest,
            scaling=torch.log(stds / (0.8 * N)), rotation=gm.rotation,
            opacity=gm.opacity, kf_id=gm.unique_kfids, valid=split_mask))
    # prune parents before inserting children so their slots are reusable
    gm, state = prune(gm, state, split_mask)
    ov2 = torch.zeros((), dtype=torch.int32, device=gm.device)
    for b in blocks:
        gm, state, ov = extend(gm, state, b)
        ov2 = ov2 + ov

    # prune by opacity / screen size
    prune_mask = gm.get_opacity() < min_opacity
    if max_screen_size is not None:
        big_vs = gm.max_radii2d > max_screen_size
        big_ws = torch.amax(gm.get_scaling(), dim=-1) > 0.1 * extent
        prune_mask = prune_mask | big_vs | big_ws
    if counts is not None:
        counts["prune"] = torch.sum(prune_mask & gm.active)
    gm, state = prune(gm, state, prune_mask)

    gm = gm.replace(xyz_grad_accum=torch.zeros_like(gm.xyz_grad_accum),
                    denom=torch.zeros_like(gm.denom),
                    max_radii2d=torch.zeros_like(gm.max_radii2d))
    return gm, state, ov1 + ov2


def grow(gm: GaussianMap, state: AdamState, new_capacity: int
         ) -> Tuple[GaussianMap, AdamState]:
    """Grow the padded capacity (host-side): new rows are inactive zeros
    with identity quaternions."""
    C = gm.capacity
    assert new_capacity > C
    pad = new_capacity - C

    def pad_arr(a):
        return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])

    rot_pad = torch.zeros(pad, 4, dtype=gm.rotation.dtype, device=gm.device)
    rot_pad[:, 0] = 1.0
    gm2 = gm.replace(
        rotation=torch.cat([gm.rotation, rot_pad]),
        **{f: pad_arr(getattr(gm, f)) for f in ARRAY_FIELDS
           if f != "rotation"})
    st2 = AdamState(m={f: pad_arr(a) for f, a in state.m.items()},
                    v={f: pad_arr(a) for f, a in state.v.items()},
                    step=state.step)
    return gm2, st2


def adam_from_jax_fields(m: Dict[str, np.ndarray], v: Dict[str, np.ndarray],
                         step, device=None) -> AdamState:
    """Carry a reference ``AdamState`` across: its ``m`` and ``v`` dicts
    (numpy arrays keyed by parameter field) and its step."""
    dev = resolve_device(device)

    def t(d):
        return {f: torch.tensor(np.asarray(d[f]), dtype=torch.float32,
                                device=dev) for f in PARAM_FIELDS}
    return AdamState(m=t(m), v=t(v),
                     step=torch.tensor(int(step), dtype=torch.int32,
                                       device=dev))

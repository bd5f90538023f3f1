"""The renderer's per-Gaussian preprocess from the map's raw parameters
to the packed pair-gather table, as one CUDA kernel forward and one
analytic backward (``csrc/preprocess.cu``), joined by a
``torch.autograd.Function``.

``map_preprocess(gm, cam, ...)`` is the entry ``slam/render_api.py``
calls, for renders and plan builds alike. It returns the ``(N, 16)``
table (the layout of ``renderer_tiled.pack_table``: mean2d, conic,
opacity, colour, depth, rect16, two zeros) and the ``Preprocessed``
fields ``make_plan`` reads, with the ``active`` mask applied as
``renderer_tiled.render`` applies it.

- On CPU tensors it runs the plain version, ``preprocess_plain``: the
  map's activations, ``gaussian_math.preprocess``, the mask and
  ``pack_table``, differentiated by autograd.
- On CUDA tensors it launches the kernels or raises; nothing falls back.
  With grad enabled and an input that requires it, the forward
  (``preprocess_fwd``) runs inside ``_FusedPreprocess`` and its backward
  (``preprocess_bwd``) takes the table's gradient to the gradients of
  xyz, raw scaling, raw rotation, raw opacity, the SH features, the
  screen-space offset and the pose twist tau. Without grad the forward
  runs alone and keeps nothing for a backward.

The backward's plain version, ``preprocess_bwd_plain``, computes the
kernel's terms in the kernel's order on tensors; only the tests call it
(against autograd through ``preprocess_plain`` on the CPU, and against
the kernel on the card). Its pose chain (the 6 x 12 Jacobian of
``se3_exp(tau) @ w2c``) is autograd's through ``lie.se3_exp``, where the
kernel takes the same derivative in forward mode.

This kernel replaces no ``pl.pallas_call`` site: the JAX package writes
the stage in plain ``jnp``, which XLA fuses on the TPU. Its launch
counters (``preprocess_fwd.launches``, ``preprocess_bwd.launches``) are in
``ops/launches.py`` ``COUNTERS`` beside the compositing kernels', and
``utils/trace.py`` ``snapshot()`` reports them as ``launch.preprocess_fwd``
and ``launch.preprocess_bwd``. ``renderer_ref.render`` (the dense oracle)
and ``renderer_tiled.render`` (the JAX-mirrored signature over cov6)
keep calling ``gaussian_math.preprocess``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from . import sh as sh_ops
from .camera_math import projection_matrix
from .gaussian_math import Preprocessed, build_cov3d, preprocess
from .lie import quat_to_rotmat, se3_exp
from .renderer_tiled import mask_active, pack_table

# the raw map parameters the kernels read, in the order the C entries and
# the autograd function take them
PREP_PARAMS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
               "features_rest")

THREADS = 256     # the kernels' block size (csrc/preprocess.cu kThreads)
PART = 16         # floats of a block's pose-gradient partials

_F = ctypes.c_float
_I = ctypes.c_int


class PrepParams(ctypes.Structure):
    """The scalars of one call (csrc/preprocess.cu ``Params``)."""

    _fields_ = [("proj", _F * 16), ("fx", _F), ("fy", _F), ("limx", _F),
                ("limy", _F), ("low_pass", _F), ("scale_mod", _F),
                ("width", _I), ("height", _I), ("n", _I), ("k_rest", _I),
                ("iso", _I), ("sh_degree", _I), ("g_s0", _I), ("g_s1", _I)]


class FusedOut(NamedTuple):
    """The forward kernel's outputs (N = capacity)."""

    table: torch.Tensor   # (N, 16) f32, pack_table's layout
    aux: torch.Tensor     # (N, 8) f32 [radius, radius_x, radius_y, a, b, c, 0, 0]
    rect: torch.Tensor    # (N, 4) int32 [rect_min, rect_max]
    tiles: torch.Tensor   # (N,) int32 tiles_touched
    valid: torch.Tensor   # (N,) bool


@functools.lru_cache(maxsize=64)
def _projection(znear, zfar, cx, cy, fx, fy, width, height):
    return tuple(float(v) for v in projection_matrix(
        znear, zfar, cx, cy, fx, fy, width, height).reshape(-1))


def _params(cam, n: int, k_rest: int, iso: bool, sh_degree: int,
            scale_modifier: float, low_pass: float,
            g_strides: Tuple[int, int] = (0, 0)) -> PrepParams:
    p = PrepParams()
    p.proj[:] = _projection(cam.znear, cam.zfar, cam.cx, cam.cy, cam.fx,
                            cam.fy, cam.width, cam.height)
    p.fx, p.fy = cam.fx, cam.fy
    # clamp_view_point's limits, as the plain version forms them (a Python
    # float, rounded to float32 where it meets a tensor)
    p.limx, p.limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    p.low_pass, p.scale_mod = low_pass, scale_modifier
    p.width, p.height, p.n, p.k_rest = cam.width, cam.height, n, k_rest
    p.iso, p.sh_degree = int(iso), sh_degree
    p.g_s0, p.g_s1 = g_strides
    return p


def _check(params: Sequence[torch.Tensor], sh_degree: int, cam, tau,
           mean2d_offset, active):
    """Raise unless every tensor is what the kernels take: float32 (the
    mask bool), contiguous, of the expected shape, on one CUDA device."""
    xyz, scaling, rotation, opacity, fdc, frest = params
    n = xyz.shape[0]
    shapes = {"xyz": (n, 3), "rotation": (n, 4), "opacity": (n, 1),
              "features_dc": (n, 1, 3), "R": (3, 3), "t": (3,),
              "tau": (6,), "mean2d_offset": (n, 2)}
    named = dict(zip(PREP_PARAMS, params), R=cam.R, t=cam.t, tau=tau,
                 mean2d_offset=mean2d_offset)
    for name, x in named.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        want = shapes.get(name)
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scaling.dim() != 2 or scaling.shape[0] != n \
            or scaling.shape[1] not in (1, 3):
        raise ValueError(f"scaling must be ({n}, 3) or ({n}, 1), got "
                         f"{tuple(scaling.shape)}")
    if frest.dim() != 3 or frest.shape[0] != n or frest.shape[2] != 3 \
            or frest.shape[1] < sh_ops.num_sh_coeffs(sh_degree) - 1:
        raise ValueError(f"features_rest must be ({n}, >= "
                         f"{sh_ops.num_sh_coeffs(sh_degree) - 1}, 3), got "
                         f"{tuple(frest.shape)}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree {sh_degree} is not in 0-3")
    if active is not None:
        named["active"] = active
        if active.dtype != torch.bool or tuple(active.shape) != (n,) \
                or not active.is_contiguous():
            raise ValueError(f"active must be a contiguous ({n},) bool "
                             f"tensor, got {tuple(active.shape)} "
                             f"{active.dtype}")
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernel takes CUDA tensors, got "
                         f"{dev} (CPU tensors take preprocess_plain)")
    for name, x in named.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")


def _ptr(x: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def preprocess_fwd(params: Sequence[torch.Tensor], sh_degree: int, cam,
                   tau: Optional[torch.Tensor] = None,
                   mean2d_offset: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None,
                   scale_modifier: float = 1.0,
                   low_pass: float = 0.3) -> FusedOut:
    """Launch the forward kernel on the map's raw parameters (in
    ``PREP_PARAMS`` order) at ``cam`` (its ``R``, ``t`` on the device) and
    the pose twist ``tau`` (None: zero). Counts ``launches``."""
    _check(params, sh_degree, cam, tau, mean2d_offset, active)
    xyz, scaling, _, _, _, frest = params
    n, dev = xyz.shape[0], xyz.device
    p = _params(cam, n, frest.shape[1], scaling.shape[1] == 1, sh_degree,
                scale_modifier, low_pass)
    out = FusedOut(
        table=torch.empty(n, 16, dtype=torch.float32, device=dev),
        aux=torch.empty(n, 8, dtype=torch.float32, device=dev),
        rect=torch.empty(n, 4, dtype=torch.int32, device=dev),
        tiles=torch.empty(n, dtype=torch.int32, device=dev),
        valid=torch.empty(n, dtype=torch.bool, device=dev))
    fn = _build.entry("preprocess", "preprocess_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(p), *[_ptr(x) for x in params], _ptr(tau),
                 _ptr(cam.R), _ptr(cam.t), _ptr(mean2d_offset),
                 _ptr(active), *[_ptr(x) for x in out],
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"preprocess_fwd launch failed: CUDA error {err}")
    preprocess_fwd.launches += 1
    return out


preprocess_fwd.launches = 0


def preprocess_bwd(params: Sequence[torch.Tensor], sh_degree: int, cam,
                   tau: Optional[torch.Tensor], g_table: torch.Tensor,
                   need_offset: bool = True, need_tau: bool = True,
                   scale_modifier: float = 1.0,
                   low_pass: float = 0.3) -> Dict[str, torch.Tensor]:
    """Launch the backward kernels: the gradients of the raw parameters
    (keyed by ``PREP_PARAMS``), of the screen-space offset
    (``mean2d_offset``, under ``need_offset``) and of ``tau`` (under
    ``need_tau``, with ``tau`` given) from the table's gradient
    ``g_table`` (N, 16), at any strides."""
    _check(params, sh_degree, cam, tau, None, None)
    n, dev = params[0].shape[0], params[0].device
    if g_table.dtype != torch.float32 or tuple(g_table.shape) != (n, 16) \
            or g_table.device != dev:
        raise ValueError(f"g_table must be ({n}, 16) float32 on {dev}, got "
                         f"{tuple(g_table.shape)} {g_table.dtype} "
                         f"{g_table.device}")
    scaling, frest = params[1], params[5]
    p = _params(cam, n, frest.shape[1], scaling.shape[1] == 1, sh_degree,
                scale_modifier, low_pass, g_strides=g_table.stride())
    grads = {f: torch.empty_like(x) for f, x in zip(PREP_PARAMS, params)}
    g_m2o = (torch.empty(n, 2, dtype=torch.float32, device=dev)
             if need_offset else None)
    with_tau = need_tau and tau is not None
    n_blocks = (n + THREADS - 1) // THREADS
    partials = (torch.empty(n_blocks, PART, dtype=torch.float32, device=dev)
                if with_tau else None)
    g_tau = (torch.empty(6, dtype=torch.float32, device=dev)
             if with_tau else None)
    fn = _build.entry("preprocess", "preprocess_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(p), *[_ptr(x) for x in params], _ptr(tau),
                 _ptr(cam.R), _ptr(cam.t), _ptr(g_table),
                 *[_ptr(grads[f]) for f in PREP_PARAMS], _ptr(g_m2o),
                 _ptr(partials), _ptr(g_tau), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"preprocess_bwd launch failed: CUDA error {err}")
    preprocess_bwd.launches += 1
    grads["mean2d_offset"] = g_m2o
    grads["tau"] = g_tau
    return grads


preprocess_bwd.launches = 0


class _FusedPreprocess(torch.autograd.Function):
    """The forward kernel, differentiable in the raw parameters, tau and
    the screen-space offset through the backward kernels. Outputs the
    table and, without gradient, aux, rect, tiles and valid."""

    @staticmethod
    def forward(ctx, opts, cam, tau, mean2d_offset, *params):
        out = preprocess_fwd(params, cam=cam, tau=tau,
                             mean2d_offset=mean2d_offset, **opts)
        ctx.opts, ctx.cam = opts, cam
        ctx.save_for_backward(tau, *params)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_table, *_):
        tau, *params = ctx.saved_tensors
        g = preprocess_bwd(params, ctx.opts["sh_degree"], ctx.cam, tau,
                           g_table, need_offset=ctx.needs_input_grad[3],
                           need_tau=ctx.needs_input_grad[2],
                           scale_modifier=ctx.opts["scale_modifier"],
                           low_pass=ctx.opts["low_pass"])
        return (None, None, g["tau"], g["mean2d_offset"],
                *[g[f] if need else None for f, need in
                  zip(PREP_PARAMS, ctx.needs_input_grad[4:])])


def _views(out: FusedOut) -> Preprocessed:
    """The ``Preprocessed`` fields as views of the kernel's outputs."""
    t, aux = out.table, out.aux
    return Preprocessed(
        valid=out.valid, depth=t[:, 9], mean2d=t[:, 0:2], conic=t[:, 2:5],
        cov2d=aux[:, 3:6], opacity=t[:, 5], color=t[:, 6:9],
        radius=aux[:, 0], radius_xy=aux[:, 1:3], rect_min=out.rect[:, 0:2],
        rect_max=out.rect[:, 2:4], tiles_touched=out.tiles)


def preprocess_plain(params: Sequence[torch.Tensor], sh_degree: int, cam,
                     tau: Optional[torch.Tensor] = None,
                     mean2d_offset: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     scale_modifier: float = 1.0, low_pass: float = 0.3
                     ) -> Tuple[torch.Tensor, Preprocessed]:
    """The plain version of the forward, differentiable by autograd: the
    map's activations (``GaussianMap.get_cov6``, ``get_opacity``,
    ``get_features``), ``gaussian_math.preprocess``, the ``active`` mask
    and ``pack_table``. Returns (table, prep)."""
    xyz, scaling, rotation, opacity, fdc, frest = params
    if tau is None:
        tau = torch.zeros(6, dtype=xyz.dtype, device=xyz.device)
    prep = preprocess(
        xyz, build_cov3d(torch.exp(scaling), rotation, scale_modifier),
        torch.sigmoid(opacity)[:, 0], torch.cat([fdc, frest], dim=1),
        sh_degree, cam.w2c().to(xyz.dtype), cam.projection().to(xyz.dtype),
        tau, cam.fx, cam.fy, cam.width, cam.height, cam.tanfovx,
        cam.tanfovy, mean2d_offset=mean2d_offset, low_pass=low_pass)
    if active is not None:
        prep = mask_active(prep, active)
    return pack_table(prep), prep


def map_preprocess(gm, cam, tau: Optional[torch.Tensor] = None,
                   mean2d_offset: Optional[torch.Tensor] = None,
                   scaling_modifier: float = 1.0, low_pass: float = 0.3,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Preprocessed]:
    """(table, prep) of map ``gm`` seen from ``cam`` moved by ``tau``
    (None: zero), with ``mean2d_offset`` added to the means and the
    ``active`` mask applied: the kernels on CUDA tensors, the plain
    version on CPU tensors."""
    params = [getattr(gm, f) for f in PREP_PARAMS]
    if gm.xyz.device.type == "cpu":
        return preprocess_plain(params, gm.active_sh_degree, cam, tau,
                                mean2d_offset, active, scaling_modifier,
                                low_pass)
    params = [x.contiguous() for x in params]
    if not (cam.R.is_contiguous() and cam.t.is_contiguous()):
        cam = cam.replace(R=cam.R.contiguous(), t=cam.t.contiguous())
    opts = dict(sh_degree=gm.active_sh_degree, active=active,
                scale_modifier=scaling_modifier, low_pass=low_pass)
    inputs = [tau, mean2d_offset, *params]
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        out = FusedOut(*_FusedPreprocess.apply(opts, cam, *inputs))
    else:
        out = preprocess_fwd(params, cam=cam, tau=tau,
                             mean2d_offset=mean2d_offset, **opts)
    return out.table, _views(out)


# ---------------------------------------------------------------------------
# The backward's plain version: the kernel's terms in its order, on tensors.

_C0 = sh_ops.SH_C0
_C1 = sh_ops.SH_C1
_C2 = sh_ops.SH_C2
_C3 = sh_ops.SH_C3


def _basis(deg: int, u):
    """The SH basis at the unit direction u = (ux, uy, uz), signs included,
    as the kernel forms it (a list of (N,) tensors, the first a float)."""
    ux, uy, uz = u
    b = [_C0]
    if deg > 0:
        b += [-(_C1 * uy), _C1 * uz, -(_C1 * ux)]
    if deg > 1:
        xx, yy, zz = ux * ux, uy * uy, uz * uz
        xy, yz, xz = ux * uy, uy * uz, ux * uz
        b += [_C2[0] * xy, _C2[1] * yz, _C2[2] * ((2.0 * zz - xx) - yy),
              _C2[3] * xz, _C2[4] * (xx - yy)]
    if deg > 2:
        b += [(_C3[0] * uy) * (3.0 * xx - yy), (_C3[1] * xy) * uz,
              (_C3[2] * uy) * ((4.0 * zz - xx) - yy),
              (_C3[3] * uz) * ((2.0 * zz - 3.0 * xx) - 3.0 * yy),
              (_C3[4] * ux) * ((4.0 * zz - xx) - yy),
              (_C3[5] * uz) * (xx - yy), (_C3[6] * ux) * (xx - 3.0 * yy)]
    return b


def _basis_grad(deg: int, u, gb):
    """dL/du from dL/d basis_k = gb[k] (k >= 1), each basis' gradient."""
    ux, uy, uz = u
    gu = [-_C1 * gb[3], -_C1 * gb[1], _C1 * gb[2]]
    if deg > 1:
        xx, yy, zz = ux * ux, uy * uy, uz * uz
        gu[0] = gu[0] + (_C2[0] * uy * gb[4] + _C2[2] * (-2.0 * ux) * gb[6]
                         + _C2[3] * uz * gb[7] + _C2[4] * (2.0 * ux) * gb[8])
        gu[1] = gu[1] + (_C2[0] * ux * gb[4] + _C2[1] * uz * gb[5]
                         + _C2[2] * (-2.0 * uy) * gb[6]
                         + _C2[4] * (-2.0 * uy) * gb[8])
        gu[2] = gu[2] + (_C2[1] * uy * gb[5] + _C2[2] * (4.0 * uz) * gb[6]
                         + _C2[3] * ux * gb[7])
    if deg > 2:
        gu[0] = gu[0] + (_C3[0] * (6.0 * ux * uy) * gb[9]
                         + _C3[1] * (uy * uz) * gb[10]
                         + _C3[2] * (-2.0 * ux * uy) * gb[11]
                         + _C3[3] * (-6.0 * ux * uz) * gb[12]
                         + _C3[4] * (4.0 * zz - 3.0 * xx - yy) * gb[13]
                         + _C3[5] * (2.0 * ux * uz) * gb[14]
                         + _C3[6] * (3.0 * xx - 3.0 * yy) * gb[15])
        gu[1] = gu[1] + (_C3[0] * (3.0 * xx - 3.0 * yy) * gb[9]
                         + _C3[1] * (ux * uz) * gb[10]
                         + _C3[2] * (4.0 * zz - xx - 3.0 * yy) * gb[11]
                         + _C3[3] * (-6.0 * uy * uz) * gb[12]
                         + _C3[4] * (-2.0 * ux * uy) * gb[13]
                         + _C3[5] * (-2.0 * uy * uz) * gb[14]
                         + _C3[6] * (-6.0 * ux * uy) * gb[15])
        gu[2] = gu[2] + (_C3[1] * (ux * uy) * gb[10]
                         + _C3[2] * (8.0 * uy * uz) * gb[11]
                         + _C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[12]
                         + _C3[4] * (8.0 * ux * uz) * gb[13]
                         + _C3[5] * (xx - yy) * gb[14])
    return gu


def _mv(A, v):
    """A (3, 3) of scalars or tensors times v (3 entries), the kernel's
    order of sums."""
    return [(A[r][0] * v[0] + A[r][1] * v[1]) + A[r][2] * v[2]
            for r in range(3)]


@torch.no_grad()
def preprocess_bwd_plain(params: Sequence[torch.Tensor], sh_degree: int,
                         cam, tau: Optional[torch.Tensor],
                         g_table: torch.Tensor, scale_modifier: float = 1.0,
                         low_pass: float = 0.3) -> Dict[str, torch.Tensor]:
    """The plain version of ``preprocess_bwd``, any device and dtype: the
    kernel's chain of terms on tensors. Returns the gradients keyed by
    ``PREP_PARAMS``, ``mean2d_offset`` and ``tau`` (None without tau)."""
    xyz, scaling, rotation, opacity, fdc, frest = params
    dt, dev = xyz.dtype, xyz.device
    n = xyz.shape[0]
    tau0 = (tau.detach().to(dt) if tau is not None
            else torch.zeros(6, dtype=dt, device=dev))
    w2c = cam.w2c().to(dt)
    w2c_eff = se3_exp(tau0) @ w2c
    W = [[w2c_eff[r, k] for k in range(3)] for r in range(3)]
    campos = -(w2c_eff[:3, :3].T @ w2c_eff[:3, 3])
    ce = [campos[j] + tau0[j] for j in range(3)]
    P = torch.as_tensor(cam.projection(), dtype=dt, device=dev)
    fx, fy = cam.fx, cam.fy
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    x = [xyz[:, k] for k in range(3)]
    # the forward's intermediates, by the plain forward's own operations
    # (on the card torch's products and sums round as the kernel mirrors)
    R_cw, t_cw = w2c_eff[:3, :3], w2c_eff[:3, 3]
    p_view = xyz @ R_cw.T + t_cw
    ph = p_view @ P[:3, :3].T + P[:3, 3]
    pw = p_view @ P[3, :3] + P[3, 3]
    s_all = torch.exp(scaling)
    sp_all = scale_modifier * s_all
    sq = torch.sum(rotation * rotation, dim=-1, keepdim=True)
    qnorm = torch.sqrt(sq + 1e-24)[:, 0]
    qn = [rotation[:, k] / qnorm for k in range(4)]
    Rm = quat_to_rotmat(rotation)
    Mm = Rm * sp_all[..., None, :]
    Vm = Mm @ Mm.transpose(-1, -2)
    s = [s_all[:, min(k, s_all.shape[1] - 1)] for k in range(3)]
    sp = [sp_all[:, min(k, sp_all.shape[1] - 1)] for k in range(3)]
    R = [[Rm[:, a, k] for k in range(3)] for a in range(3)]
    M = [[Mm[:, a, k] for k in range(3)] for a in range(3)]
    r_, x_, y_, z_ = qn
    opa = torch.sigmoid(opacity[:, 0])
    ph0, ph1 = ph[:, 0], ph[:, 1]
    p_w = 1.0 / (pw + 1e-7)
    tx, ty, tz = p_view[:, 0], p_view[:, 1], p_view[:, 2]
    tiny = torch.abs(tz) < 1e-8
    tzs = torch.where(tiny, torch.full_like(tz, 1e-8), tz)
    rx, ry = tx / tzs, ty / tzs
    clx = (rx < -limx) | (rx > limx)
    cly = (ry < -limy) | (ry > limy)
    txo = torch.where(clx, torch.clamp(rx, -limx, limx) * tz, tx)
    tyo = torch.where(cly, torch.clamp(ry, -limy, limy) * tz, ty)
    inv_z = 1.0 / tzs
    inv_z2 = inv_z * inv_z
    J00, J02 = fx * inv_z, (-fx * txo) * inv_z2
    J11, J12 = fy * inv_z, (-fy * tyo) * inv_z2
    T0v = J00[:, None] * R_cw[0] + J02[:, None] * R_cw[2]
    T1v = J11[:, None] * R_cw[1] + J12[:, None] * R_cw[2]
    VT0v = torch.einsum("...ij,...j->...i", Vm, T0v)
    VT1v = torch.einsum("...ij,...j->...i", Vm, T1v)
    a = torch.sum(T0v * VT0v, dim=-1) + low_pass
    b = torch.sum(T0v * VT1v, dim=-1)
    c = torch.sum(T1v * VT1v, dim=-1) + low_pass
    T0, T1 = [T0v[:, k] for k in range(3)], [T1v[:, k] for k in range(3)]
    VT0, VT1 = [VT0v[:, k] for k in range(3)], [VT1v[:, k] for k in range(3)]
    det = a * c - b * b
    dv = det != 0
    di = 1.0 / torch.where(dv, det, torch.ones_like(det))
    dirs = xyz - torch.stack(ce)
    nrm = torch.sqrt(torch.sum(dirs * dirs, dim=-1) + 1e-24)
    d = [dirs[:, k] for k in range(3)]
    u = [d[k] / nrm for k in range(3)]
    nb = sh_ops.num_sh_coeffs(sh_degree)
    sh = torch.cat([fdc, frest], dim=1)[:, :nb]              # (N, nb, 3)
    bas = _basis(sh_degree, u)
    v = _C0 * sh[:, 0]
    for k in range(1, nb):
        v = v + bas[k][:, None] * sh[:, k]
    v = v + 0.5

    gt = [g_table[:, k].to(dt) for k in range(10)]
    gm0, gm1 = gt[0], gt[1]
    zero = torch.zeros_like(tz)
    gx = [zero, zero, zero]
    pg_ce = [zero, zero, zero]

    # colour: the clamp at 0, SH coefficients, the view direction
    gv = torch.where(v < 0, torch.zeros_like(v), torch.stack(gt[6:9], -1))
    g_sh = torch.zeros(n, 1 + frest.shape[1], 3, dtype=dt, device=dev)
    g_sh[:, 0] = gv * _C0
    for k in range(1, nb):
        g_sh[:, k] = gv * bas[k][:, None]
    if sh_degree > 0:
        gb = [None] + [(gv[:, 0] * sh[:, k, 0] + gv[:, 1] * sh[:, k, 1])
                       + gv[:, 2] * sh[:, k, 2] for k in range(1, nb)]
        gu = _basis_grad(sh_degree, u, gb)
        dgu = (d[0] * gu[0] + d[1] * gu[1]) + d[2] * gu[2]
        gn = -dgu / (nrm * nrm)
        dd = [gu[k] / nrm + d[k] * gn / nrm for k in range(3)]
        gx = [gx[k] + dd[k] for k in range(3)]
        pg_ce = [-dd[k] for k in range(3)]

    # conic = (c, -b, a) / det_safe
    gk0, gk1, gk2 = gt[2], gt[3], gt[4]
    ga, gbb, gc = gk2 * di, -gk1 * di, gk0 * di
    gdi = (gk0 * c - gk1 * b) + gk2 * a
    gdet = torch.where(dv, -gdi * di * di, zero)
    ga, gc, gbb = ga + gdet * c, gc + gdet * a, gbb + -2.0 * b * gdet
    gT0 = [2.0 * ga * VT0[k] + gbb * VT1[k] for k in range(3)]
    gT1 = [gbb * VT0[k] + 2.0 * gc * VT1[k] for k in range(3)]
    G = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(i, 3):
            g_ik = ga * T0[i] * T0[k] + gbb * T0[i] * T1[k] + gc * T1[i] * T1[k]
            if k != i:
                g_ik = g_ik + (ga * T0[k] * T0[i] + gbb * T0[k] * T1[i]
                               + gc * T1[k] * T1[i])
            G[i][k] = G[k][i] = 2.0 * g_ik if k == i else g_ik
    gJ00 = (gT0[0] * W[0][0] + gT0[1] * W[0][1]) + gT0[2] * W[0][2]
    gJ02 = (gT0[0] * W[2][0] + gT0[1] * W[2][1]) + gT0[2] * W[2][2]
    gJ11 = (gT1[0] * W[1][0] + gT1[1] * W[1][1]) + gT1[2] * W[1][2]
    gJ12 = (gT1[0] * W[2][0] + gT1[1] * W[2][1]) + gT1[2] * W[2][2]
    pgW = [[J00 * gT0[k] for k in range(3)], [J11 * gT1[k] for k in range(3)],
           [J02 * gT0[k] + J12 * gT1[k] for k in range(3)]]
    g_invz = fx * gJ00 + fy * gJ11
    g_invz2 = (-fx * txo) * gJ02 + (-fy * tyo) * gJ12
    g_invz = g_invz + 2.0 * inv_z * g_invz2
    g_tz_j = torch.where(tiny, zero, -g_invz * inv_z * inv_z)
    g_tx_j = torch.where(clx, zero, gJ02 * inv_z2 * (-fx))
    g_ty_j = torch.where(cly, zero, gJ12 * inv_z2 * (-fy))

    # mean2d = ((p_proj + 1) * size - 1) / 2, p_proj = ph / (pw + 1e-7)
    gpx = gm0 * 0.5 * cam.width
    gpy = gm1 * 0.5 * cam.height
    gph0, gph1 = gpx * p_w, gpy * p_w
    gpw = -(gpx * ph0 + gpy * ph1) * p_w * p_w
    gpv = [(P[0, k] * gph0 + P[1, k] * gph1) + P[3, k] * gpw
           for k in range(3)]
    gpv = [gpv[0] + g_tx_j, gpv[1] + g_ty_j, gpv[2] + (g_tz_j + gt[9])]
    Wt = [[W[r][k] for r in range(3)] for k in range(3)]
    gx = [gx[k] + v_ for k, v_ in enumerate(_mv(Wt, gpv))]
    pgW = [[pgW[r][k] + gpv[r] * x[k] for k in range(3)] for r in range(3)]

    g_opa = gt[5] * (1.0 - opa) * opa

    # Sigma = M M^T, M = R diag(sp): dM = G M
    gR = [[None] * 3 for _ in range(3)]
    gsp = [zero, zero, zero]
    for i in range(3):
        for k in range(3):
            gM = (G[i][0] * M[0][k] + G[i][1] * M[1][k]) + G[i][2] * M[2][k]
            gR[i][k] = gM * sp[k]
            gsp[k] = gsp[k] + gM * R[i][k]
    g_s = [(scale_modifier * gsp[k]) * s[k] for k in range(3)]
    g_scaling = (torch.stack(g_s, -1) if scaling.shape[1] == 3
                 else ((g_s[0] + g_s[1]) + g_s[2])[:, None])
    f = [gR[0][0], gR[0][1], gR[0][2], gR[1][0], gR[1][1], gR[1][2],
         gR[2][0], gR[2][1], gR[2][2]]
    gq = [2.0 * (((-z_ * f[1] + y_ * f[2]) + (z_ * f[3] - x_ * f[5]))
                 + (-y_ * f[6] + x_ * f[7])),
          2.0 * (((y_ * f[1] + z_ * f[2]) + (y_ * f[3] - 2.0 * x_ * f[4]))
                 + ((-r_ * f[5] + z_ * f[6]) + (r_ * f[7] - 2.0 * x_ * f[8]))),
          2.0 * (((-2.0 * y_ * f[0] + x_ * f[1]) + (r_ * f[2] + x_ * f[3]))
                 + ((z_ * f[5] - r_ * f[6]) + (z_ * f[7] - 2.0 * y_ * f[8]))),
          2.0 * (((-2.0 * z_ * f[0] - r_ * f[1]) + (x_ * f[2] + r_ * f[3]))
                 + ((-2.0 * z_ * f[4] + y_ * f[5]) + (x_ * f[6] + y_ * f[7])))]
    dot = ((qn[0] * gq[0] + qn[1] * gq[1]) + qn[2] * gq[2]) + qn[3] * gq[3]
    g_rot = torch.stack([(gq[k] - qn[k] * dot) / qnorm for k in range(4)], -1)

    out = {"xyz": torch.stack(gx, -1), "scaling": g_scaling,
           "rotation": g_rot, "opacity": g_opa[:, None],
           "features_dc": g_sh[:, :1].clone(),
           "features_rest": g_sh[:, 1:].clone(),
           "mean2d_offset": torch.stack([gm0, gm1], -1), "tau": None}
    if tau is not None:
        # the pose's route: dL/dW, dL/dtv summed over the Gaussians, through
        # the Jacobian of se3_exp(tau) @ w2c; dL/dcampos_eff on tau[:3]
        g_eff = torch.stack(
            [torch.stack([pgW[r][k].sum() for k in range(3)]
                         + [gpv[r].sum()]) for r in range(3)])
        with torch.enable_grad():
            tau_r = tau0.clone().requires_grad_()
            (g_tau,) = torch.autograd.grad((se3_exp(tau_r) @ w2c)[:3],
                                           tau_r, g_eff)
        out["tau"] = g_tau + torch.cat(
            [torch.stack([p.sum() for p in pg_ce]),
             torch.zeros(3, dtype=dt, device=dev)])
    return out

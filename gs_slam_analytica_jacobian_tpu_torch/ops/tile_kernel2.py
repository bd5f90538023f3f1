"""32x32 alpha compositing, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions and the autograd function that
joins them (counterpart of ops/pallas/tile_kernel2.py).

The forward kernel (``csrc/tile_kernel2_fwd.cu``) replaces the Pallas TPU
kernel ``make_forward_kernel`` in both of its call forms:

- ``composite32_fwd`` — without per-pair n_touched (``_fwd_impl``
  ``with_ntouch=False``, pallas_call at tile_kernel2.py:662): every IRLS
  render of the tracker;
- ``composite32_fwd_ntouch`` — with per-pair n_touched, optionally under
  the blend-weight rule ``nt_weight`` (pallas_call at :642): the
  keyframing and ground-truth renders.

The backward kernel (``csrc/tile_kernel2_bwd.cu``, wrapper
``composite32_bwd``) replaces ``make_backward_kernel`` (``_bwd_impl``,
pallas_call at :699): per-pair gradient rows
``[d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_rgb(3), d_depth, 0 x 6]`` from
the cotangents of color, depth and final T.

What bounds each kernel on the H100 and what its design does about it is
noted in its CUDA source. Each wrapper checks device, dtype, shape and
contiguity, launches on the current stream and counts its launches in
its ``launches`` attribute. On a CUDA tensor it launches the kernel or
raises; only a tensor on the CPU takes the plain version
(``composite32_plain``, ``composite32_bwd_plain``), which is vectorized
over tiles x pixels and loops over pair chunks. The plain versions are
the kernels' references, not a yardstick of speed.

``composite32`` is differentiable in ``feat`` (a ``torch.autograd
.Function``): its forward runs a forward wrapper, its backward
``composite32_bwd``.

Images are read and written in (C, H, W) directly; the TPU's
block-permuted layout and ``assemble_image`` do not exist here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build
from .binning2 import FEAT_DIM

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

TPX = 32          # tile width in pixels
TPY = 32          # tile height in pixels
P = TPX * TPY     # pixels per tile
K = 128           # pair rows per chunk (the plan's range alignment)
PLAIN_CHUNK = 32  # pair rows the plain version evaluates at once


def grid_dims(width: int, height: int):
    return (width + TPX - 1) // TPX, (height + TPY - 1) // TPY


class Composite2Out(NamedTuple):
    color_sum: torch.Tensor        # (3, H, W) — before background
    depth_sum: torch.Tensor        # (H, W)
    final_T: torch.Tensor          # (H, W)
    n_touched_pairs: torch.Tensor  # (B_al,) f32 per-pair touch counts


def _tile_pixels(n_tx: int, n_ty: int, W: int, H: int, dev, tile: int):
    """Per (tile, pixel) coordinates, (n_tiles, tile^2) each: pixel q of
    tile t is (x, y) = (tx*tile + q%tile, ty*tile + q//tile). Returns (px,
    py, pix_in, t16x, t16y) with the 16-px cell of each pixel."""
    q = torch.arange(tile * tile, device=dev)
    t_ar = torch.arange(n_tx * n_ty, device=dev)
    xi = (t_ar % n_tx)[:, None] * tile + (q % tile)[None]
    yi = (t_ar // n_tx)[:, None] * tile + (q // tile)[None]
    px, py = xi.to(torch.float32), yi.to(torch.float32)
    return px, py, (xi < W) & (yi < H), torch.floor(px / 16.0), \
        torch.floor(py / 16.0)


def plain_walk(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
               n_ty: int, W: int, H: int, with_ntouch: bool = True,
               nt_weight: bool = False, tile: int = TPX
               ) -> Tuple[Composite2Out, torch.Tensor]:
    """Plain PyTorch compositing over square tiles of edge ``tile`` (32 for
    B1, 16 for B3) on an n_tx x n_ty grid. Returns (outputs, pairs_walked)
    where pairs_walked[t] counts the pair rows tile t walked until every
    one of its pixels was done — the work this input needs.

    Vectorized over tiles x pixels. The pair rows come in chunks; the
    falloff, alpha and skip tests of a chunk are evaluated at once, then
    the pairs of the chunk are composited one after another with the
    kernel's exact arithmetic (T_incl = T (1 - alpha), w = alpha T,
    acc += c w, no fused multiply-adds), so on the card the two agree bit
    for bit wherever their exp does."""
    dev = feat.device
    f32 = torch.float32
    chunk = PLAIN_CHUNK
    n_tiles = n_tx * n_ty
    B_al = feat.shape[0]
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()

    px, py, pix_in, t16x, t16y = _tile_pixels(n_tx, n_ty, W, H, dev, tile)
    n_pix = tile * tile

    T = torch.ones(n_tiles, n_pix, dtype=f32, device=dev)
    done = ~pix_in
    acc = torch.zeros(n_tiles, 4, n_pix, dtype=f32, device=dev)
    ntouch = torch.zeros(B_al, dtype=f32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    n_chunks = (n_pairs + chunk - 1) // chunk
    k_ar = torch.arange(chunk, device=dev)

    for c in range(int(n_chunks.max().item()) if n_tiles else 0):
        walking = (c < n_chunks) & ~done.all(dim=1)
        sel = torch.nonzero(walking).squeeze(1)
        if sel.numel() == 0:
            break
        rows = c * chunk + k_ar
        row_ok = rows[None] < n_pairs[sel][:, None]             # (S, k)
        idx = torch.clamp(start[sel][:, None] + rows[None], max=B_al - 1)
        f = feat[idx]                                          # (S, k, 16)

        px_s, py_s = px[sel][:, None], py[sel][:, None]         # (S, 1, P)
        mx, my = f[..., 0:1], f[..., 1:2]
        ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        opa = f[..., 5:6]
        dx = mx - px_s
        dy = my - py_s
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        t16x_s, t16y_s = t16x[sel][:, None], t16y[sel][:, None]
        rect_ok = ((t16x_s >= f[..., 10:11]) & (t16x_s < f[..., 12:13])
                   & (t16y_s >= f[..., 11:12]) & (t16y_s < f[..., 13:14]))
        ok = (row_ok[..., None] & rect_ok & (power <= 0.0)
              & (alpha >= ALPHA_MIN))                          # (S, k, P)

        T_s, done_s, acc_s = T[sel], done[sel], acc[sel]
        nt = torch.zeros(sel.numel(), chunk, dtype=f32, device=dev)
        for k in range(chunk):
            walked[sel] += (row_ok[:, k] & ~done_s.all(dim=1)).long()
            live = ok[:, k] & ~done_s
            a_k = alpha[:, k]
            T_incl = T_s * (1.0 - a_k)
            term = live & (T_incl < T_EPS)
            inc = live & ~term
            w = torch.where(inc, a_k * T_s, torch.zeros_like(a_k))
            acc_s = acc_s + f[:, k, 6:10, None] * w[:, None, :]
            if with_ntouch:
                cond = inc & ((w >= ALPHA_MIN) if nt_weight
                              else (T_incl > 0.5))
                nt[:, k] = (cond & pix_in[sel]).sum(dim=1).to(f32)
            T_s = torch.where(inc, T_incl, T_s)
            done_s = done_s | term
        T[sel], done[sel], acc[sel] = T_s, done_s, acc_s
        if with_ntouch:
            ntouch[idx[row_ok]] = nt[row_ok]

    planes = torch.cat([acc, T[:, None]], dim=1)               # (T, 5, P)
    img = (planes.reshape(n_ty, n_tx, 5, tile, tile)
           .permute(2, 0, 3, 1, 4)
           .reshape(5, n_ty * tile, n_tx * tile))[:, :H, :W]
    out = Composite2Out(color_sum=img[0:3], depth_sum=img[3],
                        final_T=img[4], n_touched_pairs=ntouch)
    return out, walked


def composite32_plain(feat, ranges, n_tx, n_ty, W, H, with_ntouch=True,
                      nt_weight=False) -> Composite2Out:
    """Plain PyTorch version of the kernel (same function, any device)."""
    return plain_walk(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                      nt_weight)[0]


def _check(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int, n_ty: int):
    if feat.dtype != torch.float32 or feat.dim() != 2 \
            or feat.shape[1] != FEAT_DIM:
        raise ValueError(f"feat must be (B_al, {FEAT_DIM}) float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    if ranges.dtype != torch.int32 or tuple(ranges.shape) != (n_tx * n_ty, 2):
        raise ValueError(f"ranges must be ({n_tx * n_ty}, 2) int32, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    if ranges.device != feat.device:
        raise ValueError("feat and ranges lie on different devices")
    if not (feat.is_contiguous() and ranges.is_contiguous()):
        raise ValueError("feat and ranges must be contiguous")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feat.device}")


def launch_fwd(lib: str, feat, ranges, n_tx, n_ty, W, H, with_ntouch,
               nt_weight) -> Composite2Out:
    """Launch the forward kernel of library ``lib`` (whose C entry has the
    signature of ``composite32_fwd``) over an n_tx x n_ty tile grid."""
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned for float4 loads")
    fn = getattr(_build.load(lib), _build.LIBRARIES[lib][1])
    dev = feat.device
    out = torch.empty(5, H, W, dtype=torch.float32, device=dev)
    # pairs a tile never reaches (early exit, aligned gaps) must read 0;
    # without n_touched the kernel leaves it all zero
    ntouch = torch.zeros(feat.shape[0], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.c_void_p(feat.data_ptr()),
                 ctypes.c_void_p(ranges.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()),
                 ctypes.c_void_p(ntouch.data_ptr()),
                 n_tx * n_ty, n_tx, W, H, int(with_ntouch), int(nt_weight),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    return Composite2Out(color_sum=out[0:3], depth_sum=out[3],
                         final_T=out[4], n_touched_pairs=ntouch)


def composite32_fwd(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
                    n_ty: int, W: int, H: int) -> Composite2Out:
    """Forward compositing without per-pair n_touched (zeros)."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=False)
    out = launch_fwd("tile_kernel2_fwd", feat, ranges, n_tx, n_ty, W, H,
                     False, False)
    composite32_fwd.launches += 1
    return out


composite32_fwd.launches = 0


def composite32_fwd_ntouch(feat: torch.Tensor, ranges: torch.Tensor,
                           n_tx: int, n_ty: int, W: int, H: int,
                           nt_weight: bool = False) -> Composite2Out:
    """Forward compositing with per-pair n_touched: pixels where the pair
    was included and T_incl > 0.5, or alpha*T >= 1/255 under
    ``nt_weight``."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=True, nt_weight=nt_weight)
    out = launch_fwd("tile_kernel2_fwd", feat, ranges, n_tx, n_ty, W, H,
                     True, nt_weight)
    composite32_fwd_ntouch.launches += 1
    return out


composite32_fwd_ntouch.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

N_ROWS = 10       # gradient columns a pair row carries (the rest stay 0)


def _to_tiles(img: torch.Tensor, n_tx: int, n_ty: int, tile: int
              ) -> torch.Tensor:
    """(C, H, W) -> (n_tiles, C, tile^2), zero padded to whole tiles; pixel
    q of tile t is (x, y) = (tx*tile + q%tile, ty*tile + q//tile)."""
    C, h, w = img.shape
    x = torch.nn.functional.pad(img, (0, n_tx * tile - w, 0, n_ty * tile - h))
    return (x.reshape(C, n_ty, tile, n_tx, tile).permute(1, 3, 0, 2, 4)
            .reshape(n_tx * n_ty, C, tile * tile))


def plain_bwd_walk(feat, ranges, color_sum, depth_sum, final_T, d_color,
                   d_depth, d_T, n_tx: int, n_ty: int, W: int, H: int,
                   tile: int = TPX
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the compositing over square tiles of edge
    ``tile`` (32 for B2, 16 for B4). Returns (dfeat (B_al, 16),
    pairs_walked per tile, the count of included (pair, pixel) cells).

    The forward walk is recomputed pixel by pixel with the forward's exact
    operation order, so every inclusion decision matches it. Per included
    (pair, pixel) cell, with A = rgb.dC + depth.dD, the running inclusive
    prefix pA of w*A and Stot = C.dC + D.dD from the forward's sums
    (before background):

        dL/dalpha = A T_excl - (dT T_final + Stot - pA) / max(1 - alpha, 1e-6)

    and the gradient flows through the unclamped falloff G = a_un / opa:
    d_opa = sum G dL/dalpha, then the five quadratic-form rows and
    d_rgb, d_depth = sum w dC, dD. Rows of dead slots, skipped pairs and
    pairs after the tile's early exit are exactly zero; columns 10-15 are
    zero."""
    dev = feat.device
    f32 = torch.float32
    chunk = PLAIN_CHUNK
    n_tiles = n_tx * n_ty
    B_al = feat.shape[0]
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()

    px, py, pix_in, t16x, t16y = _tile_pixels(n_tx, n_ty, W, H, dev, tile)
    n_pix = tile * tile

    fwd = _to_tiles(torch.cat([color_sum, depth_sum[None], final_T[None]]),
                    n_tx, n_ty, tile)                          # (T, 5, P)
    cot = _to_tiles(torch.cat([d_color, d_depth[None], d_T[None]]),
                    n_tx, n_ty, tile)
    stot = (((cot[:, 0] * fwd[:, 0] + cot[:, 1] * fwd[:, 1])
             + cot[:, 2] * fwd[:, 2]) + cot[:, 3] * fwd[:, 3])
    c0 = cot[:, 4] * fwd[:, 4] + stot                          # (T, P)

    T = torch.ones(n_tiles, n_pix, dtype=f32, device=dev)
    done = ~pix_in
    pA = torch.zeros(n_tiles, n_pix, dtype=f32, device=dev)
    dfeat = torch.zeros(B_al, feat.shape[1], dtype=f32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    included = torch.zeros((), dtype=torch.long, device=dev)
    n_chunks = (n_pairs + chunk - 1) // chunk
    k_ar = torch.arange(chunk, device=dev)

    for c in range(int(n_chunks.max().item()) if n_tiles else 0):
        walking = (c < n_chunks) & ~done.all(dim=1)
        sel = torch.nonzero(walking).squeeze(1)
        if sel.numel() == 0:
            break
        rows = c * chunk + k_ar
        row_ok = rows[None] < n_pairs[sel][:, None]             # (S, k)
        idx = torch.clamp(start[sel][:, None] + rows[None], max=B_al - 1)
        f = feat[idx]                                          # (S, k, 16)

        px_s, py_s = px[sel][:, None], py[sel][:, None]         # (S, 1, P)
        mx, my = f[..., 0:1], f[..., 1:2]
        ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        opa = f[..., 5:6]
        dx = mx - px_s
        dy = my - py_s
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        a_un = opa * torch.exp(power)
        alpha = torch.clamp(a_un, max=ALPHA_MAX)
        t16x_s, t16y_s = t16x[sel][:, None], t16y[sel][:, None]
        rect_ok = ((t16x_s >= f[..., 10:11]) & (t16x_s < f[..., 12:13])
                   & (t16y_s >= f[..., 11:12]) & (t16y_s < f[..., 13:14]))
        ok = (row_ok[..., None] & rect_ok & (power <= 0.0)
              & (alpha >= ALPHA_MIN))                          # (S, k, P)
        G_all = a_un / torch.clamp(opa, min=1e-12)

        T_s, done_s, pA_s = T[sel], done[sel], pA[sel]
        cot_s, c0_s = cot[sel], c0[sel]
        acc = torch.zeros(sel.numel(), chunk, N_ROWS, dtype=f32, device=dev)
        for k in range(chunk):
            walked[sel] += (row_ok[:, k] & ~done_s.all(dim=1)).long()
            live = ok[:, k] & ~done_s
            a_k = alpha[:, k]
            T_incl = T_s * (1.0 - a_k)
            term = live & (T_incl < T_EPS)
            inc = live & ~term
            included += inc.sum()
            zero = torch.zeros_like(a_k)
            w = torch.where(inc, a_k * T_s, zero)
            fk = f[:, k]                                       # (S, 16)
            A = (((fk[:, 6:7] * cot_s[:, 0] + fk[:, 7:8] * cot_s[:, 1])
                  + fk[:, 8:9] * cot_s[:, 2]) + fk[:, 9:10] * cot_s[:, 3])
            pA_s = pA_s + w * A
            inv_om = 1.0 / torch.clamp(1.0 - a_k, min=1e-6)
            dLda = torch.where(inc, A * T_s - inv_om * (c0_s - pA_s), zero)
            # masked: where power > 0 the falloff may overflow to inf
            G = torch.where(inc, G_all[:, k], zero)
            dLdG = fk[:, 5:6] * dLda
            gdx = G * dx[:, k]
            gdy = G * dy[:, k]
            dG_ddx = -gdx * fk[:, 2:3] - gdy * fk[:, 3:4]
            dG_ddy = -gdy * fk[:, 4:5] - gdx * fk[:, 3:4]
            vals = torch.stack([
                dLdG * dG_ddx, dLdG * dG_ddy, dLdG * (-0.5 * gdx * dx[:, k]),
                dLdG * (-gdx * dy[:, k]), dLdG * (-0.5 * gdy * dy[:, k]),
                G * dLda, w * cot_s[:, 0], w * cot_s[:, 1],
                w * cot_s[:, 2], w * cot_s[:, 3]], dim=1)      # (S, 10, P)
            acc[:, k] = vals.sum(dim=-1)
            T_s = torch.where(inc, T_incl, T_s)
            done_s = done_s | term
        T[sel], done[sel], pA[sel] = T_s, done_s, pA_s
        dfeat[idx[row_ok], :N_ROWS] = acc[row_ok]
    return dfeat, walked, included


def composite32_bwd_plain(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, n_tx, n_ty, W, H
                          ) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (any device)."""
    return plain_bwd_walk(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, n_tx, n_ty, W, H)[0]


def _check_planes(feat: torch.Tensor, W: int, H: int, **planes):
    for name, x in planes.items():
        want = (3, H, W) if x.dim() == 3 else (H, W)
        if x.dtype != torch.float32 or tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != feat.device:
            raise ValueError(f"{name} lies on {x.device}, feat on "
                             f"{feat.device}")


def composite32_bwd(feat: torch.Tensor, ranges: torch.Tensor,
                    color_sum: torch.Tensor, depth_sum: torch.Tensor,
                    final_T: torch.Tensor, d_color: torch.Tensor,
                    d_depth: torch.Tensor, d_T: torch.Tensor, n_tx: int,
                    n_ty: int, W: int, H: int) -> torch.Tensor:
    """Per-pair gradient rows (B_al, 16) from the forward's planes
    (color_sum (3,H,W) before background, depth_sum, final_T) and their
    cotangents. Rows the kernel never writes keep the zero they were
    allocated with."""
    _check(feat, ranges, n_tx, n_ty)
    _check_planes(feat, W, H, color_sum=color_sum, depth_sum=depth_sum,
                  final_T=final_T, d_color=d_color, d_depth=d_depth, d_T=d_T)
    if feat.device.type == "cpu":
        return composite32_bwd_plain(feat, ranges, color_sum, depth_sum,
                                     final_T, d_color, d_depth, d_T, n_tx,
                                     n_ty, W, H)
    dfeat = launch_bwd("tile_kernel2_bwd", feat, ranges, color_sum,
                       depth_sum, final_T, d_color, d_depth, d_T, n_tx, n_ty,
                       W, H)
    composite32_bwd.launches += 1
    return dfeat


def launch_bwd(lib: str, feat, ranges, color_sum, depth_sum, final_T,
               d_color, d_depth, d_T, n_tx, n_ty, W, H) -> torch.Tensor:
    """Launch the backward kernel of library ``lib`` (whose C entry has the
    signature of ``composite32_bwd``) over an n_tx x n_ty tile grid."""
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned for float4 loads")
    fn = getattr(_build.load(lib), _build.LIBRARIES[lib][1])
    dfeat = torch.zeros(feat.shape[0], FEAT_DIM, dtype=torch.float32,
                        device=feat.device)
    planes = [x.contiguous() for x in (color_sum, depth_sum, final_T,
                                       d_color, d_depth, d_T)]
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(ctypes.c_void_p(feat.data_ptr()),
                 ctypes.c_void_p(ranges.data_ptr()),
                 *[ctypes.c_void_p(x.data_ptr()) for x in planes],
                 ctypes.c_void_p(dfeat.data_ptr()),
                 n_tx * n_ty, n_tx, W, H, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    return dfeat


composite32_bwd.launches = 0


class CompositeFn(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` around the compositing, for either
    tile size: ``kernels`` is the (forward, forward with n_touched,
    backward) wrapper triple of one tile size. The forward runs a forward
    wrapper and keeps feat, ranges and the output planes; the backward
    hands their cotangents (zeros where an output got none) to the
    backward wrapper. n_touched is not differentiable."""

    @staticmethod
    def forward(ctx, feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                nt_weight, kernels):
        fwd, fwd_ntouch, bwd = kernels
        if with_ntouch:
            out = fwd_ntouch(feat, ranges, n_tx, n_ty, W, H, nt_weight)
        else:
            out = fwd(feat, ranges, n_tx, n_ty, W, H)
        ctx.save_for_backward(feat, ranges, out.color_sum, out.depth_sum,
                              out.final_T)
        ctx.grid = (n_tx, n_ty, W, H)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(out.n_touched_pairs)
        return tuple(out)

    @staticmethod
    def backward(ctx, d_color, d_depth, d_T, _d_ntouch):
        feat, ranges, color_sum, depth_sum, final_T = ctx.saved_tensors
        cots = [torch.zeros_like(x) if g is None else g
                for g, x in ((d_color, color_sum), (d_depth, depth_sum),
                             (d_T, final_T))]
        dfeat = ctx.bwd(feat, ranges, color_sum, depth_sum, final_T, *cots,
                        *ctx.grid)
        return dfeat, None, None, None, None, None, None, None, None


def composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch=True,
                nt_weight=False) -> Composite2Out:
    """Differentiable 32x32 compositing (the reference's ``composite32``).
    ``with_ntouch=False`` returns zero n_touched."""
    return Composite2Out(*CompositeFn.apply(
        feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight,
        (composite32_fwd, composite32_fwd_ntouch, composite32_bwd)))

"""32x32 forward alpha compositing: the CUDA kernel's wrappers and their
plain PyTorch version (counterpart of ops/pallas/tile_kernel2.py).

The kernel (``csrc/tile_kernel2_fwd.cu``) replaces the Pallas TPU kernel
``make_forward_kernel`` in both of its call forms:

- ``composite32_fwd`` — without per-pair n_touched (``_fwd_impl``
  ``with_ntouch=False``, pallas_call at tile_kernel2.py:662): every IRLS
  render of the tracker;
- ``composite32_fwd_ntouch`` — with per-pair n_touched, optionally under
  the blend-weight rule ``nt_weight`` (pallas_call at :642): the
  keyframing and ground-truth renders.

What bounds the kernel on the H100 and what its design does about it is
noted in the CUDA source. Each wrapper checks device, dtype, shape and
contiguity, launches on the current stream and counts its launches in
its ``launches`` attribute. On a CUDA tensor it launches the kernel or
raises; only a tensor on the CPU takes the plain version
(``composite32_plain``), which is vectorized over tiles x pixels and
loops over pair chunks. The plain version is the kernel's reference, not
a yardstick of speed.

Outputs are written in (C, H, W) directly; the TPU's block-permuted
layout and ``assemble_image`` do not exist here.
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


def plain_walk(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
               n_ty: int, W: int, H: int, with_ntouch: bool = True,
               nt_weight: bool = False
               ) -> Tuple[Composite2Out, torch.Tensor]:
    """Plain PyTorch compositing. Returns (outputs, pairs_walked) where
    pairs_walked[t] counts the pair rows tile t walked until every one of
    its pixels was done — the work this input needs.

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

    q = torch.arange(P, device=dev)
    t_ar = torch.arange(n_tiles, device=dev)
    xi = (t_ar % n_tx)[:, None] * TPX + (q % TPX)[None]
    yi = (t_ar // n_tx)[:, None] * TPY + (q // TPX)[None]
    pix_in = (xi < W) & (yi < H)                               # (T, P)
    px, py = xi.to(f32), yi.to(f32)
    t16x = torch.floor(px / 16.0)
    t16y = torch.floor(py / 16.0)

    T = torch.ones(n_tiles, P, dtype=f32, device=dev)
    done = ~pix_in
    acc = torch.zeros(n_tiles, 4, P, dtype=f32, device=dev)
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
    img = (planes.reshape(n_ty, n_tx, 5, TPY, TPX)
           .permute(2, 0, 3, 1, 4)
           .reshape(5, n_ty * TPY, n_tx * TPX))[:, :H, :W]
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


def _launch(feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight):
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned for float4 loads")
    fn = _build.load("tile_kernel2_fwd").composite32_fwd
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
        raise RuntimeError(f"composite32_fwd launch failed: CUDA error {err}")
    return Composite2Out(color_sum=out[0:3], depth_sum=out[3],
                         final_T=out[4], n_touched_pairs=ntouch)


def composite32_fwd(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
                    n_ty: int, W: int, H: int) -> Composite2Out:
    """Forward compositing without per-pair n_touched (zeros)."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=False)
    out = _launch(feat, ranges, n_tx, n_ty, W, H, False, False)
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
    out = _launch(feat, ranges, n_tx, n_ty, W, H, True, nt_weight)
    composite32_fwd_ntouch.launches += 1
    return out


composite32_fwd_ntouch.launches = 0


def composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch=True,
                nt_weight=False) -> Composite2Out:
    """Forward 32x32 compositing (the reference's ``composite32`` without
    its VJP). ``with_ntouch=False`` returns zero n_touched."""
    if with_ntouch:
        return composite32_fwd_ntouch(feat, ranges, n_tx, n_ty, W, H,
                                      nt_weight)
    return composite32_fwd(feat, ranges, n_tx, n_ty, W, H)

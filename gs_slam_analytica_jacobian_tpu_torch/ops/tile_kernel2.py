"""32x32 alpha compositing, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions and the autograd function that
joins them (counterpart of ops/pallas/tile_kernel2.py).

The forward kernel (``csrc/tile32_fwd_subtile.cu``) replaces the Pallas
TPU kernel ``make_forward_kernel`` in both of its call forms:

- ``composite32_fwd`` — without per-pair n_touched (``_fwd_impl``
  ``with_ntouch=False``, pallas_call at tile_kernel2.py:662): every IRLS
  render of the tracker;
- ``composite32_fwd_ntouch`` — with per-pair n_touched, optionally under
  the blend-weight rule ``nt_weight`` (pallas_call at :642): the
  keyframing and ground-truth renders.

The backward kernel (``csrc/tile32_bwd_subtile.cu``, wrapper
``composite32_bwd``) replaces ``make_backward_kernel`` (``_bwd_impl``,
pallas_call at :699): per-pair gradient rows
``[d_mx, d_my, d_ca, d_cb, d_cc, d_opa, d_rgb(3), d_depth, 0 x 6]`` from
the cotangents of color, depth and final T.

Both f32 kernels run one CTA per 16x16 quarter of a tile, an 8x4 pixel
block per warp, and drop a (pair, block) before the per-pixel walk where
the conservative block test ``block_keep_plain`` (the kernels'
``csrc/subtile_cull.cuh``, same operations) finds alpha < 1/255 at every
pixel of the block; ``plain_walk(cull=True)`` and
``plain_bwd_walk(cull=True)`` walk only the kept cells, and
``subtile_cells`` counts the cells the kernels evaluate. The one-CTA-per-
tile f32 kernels they replaced (``csrc/tile_kernel2_fwd.cu``,
``csrc/tile_kernel2_bwd.cu``) stay as the yardstick wrappers
``composite32_fwd_tile1024`` and ``composite32_bwd_tile1024``, counted on
their own and launched by nothing on a path.

Each wrapper takes ``bf16``: the reference's bfloat16 bodies of the same
three call sites (``_chunk_terms(bf16=True)``, tile_kernel2.py:160-175,
and the backward's bf16 branch, :488-508), which the trackers run under
``kernel_bf16``. The bf16 forward is the f32 forward's sub-tile body
(``csrc/subtile_fwd.cuh``, C entry ``composite32_fwd_bf16`` of
``csrc/tile32_fwd_subtile.cu``) with the bfloat16 falloff and a block
test whose margin covers its rounding (``block_keep_plain(...,
bf16=True)``); the one-CTA-per-tile bf16 forward it replaced stays as the
yardstick ``composite32_fwd_bf16_tile1024``. The bf16 backward is the
f32 backward's sub-tile body with the same falloff and margin (C entry
``composite32_bwd_bf16`` of ``csrc/tile32_bwd_subtile.cu``); the
one-CTA-per-tile bf16 backward it replaced stays as the yardstick
``composite32_bwd_bf16_tile1024``. The falloff is evaluated in bfloat16
from f32 pixel deltas, every product and sum rounded to bfloat16 in the
expression's order, the power clamped to <= 0, ``opa * exp(power)``
rounded once more and widened; transmittance and the sums stay f32. The backward rounds G, dx, dy and dL/dG to
bfloat16 and forms the quadratic-form products in bfloat16, each widened
before its f32 pixel sum. The bf16 kernels are separate C entries with
launch counters of their own (``launches_bf16``); the plain versions take
``bf16`` too and round exactly where the kernels do (torch rounds after
every bfloat16 operation, as ``__hmul_rn``/``__hadd_rn``/``__hsub_rn``
do).

Each wrapper also takes ``mxu``: the reference's MXU bodies of the same
call sites (``_mxu_power``, tile_kernel2.py:96-128, the forward's
log-space transmittance, :279-289, and the backward's MXU falloff,
:387-398), which the trackers run under ``kernel_mxu``. The falloff is the
expanded tile-local quadratic form ``G6 @ P6`` (on the card: 3xTF32 tensor
cores, ``csrc/mxu_falloff.cuh``), clamped to <= 0; the forward's
transmittance is ``T_chunk exp(cumsum(log1p(-alpha)))`` over each 128-pair
chunk with ``T_excl = T_incl / (1 - alpha)``; the backward keeps the
linear transmittance and the direct dx, dy of its gradient products. In
the forward ``mxu`` takes precedence over ``bf16`` (the reference's
``_chunk_terms``); the backward under both runs the MXU falloff with the
bfloat16 gradient products. The mxu kernels are the C entries
``composite32_fwd_mxu`` (``csrc/tile32_fwd_subtile_mxu.cu``: the f32
forward's sub-tile layout, the block test with a margin for the tensor
cores' rounding, ``block_keep_plain(..., centre=)``),
``composite32_bwd_mxu`` and ``composite32_bwd_bf16_mxu`` (the f32
backward's sub-tile body in ``csrc/tile32_bwd_subtile.cu``: per-warp
survivor lists and power blocks as in the mxu forward, the mxu margin,
the linear transmittance; under both flags bf16's rounded products),
counted in ``launches_mxu`` (the backward under both flags in
``launches_bf16_mxu``); the one-CTA-per-tile mxu forward and backwards
the sub-tile ones replaced stay as the yardsticks
``composite32_fwd_mxu_tile1024``, ``composite32_bwd_mxu_tile1024`` and
``composite32_bwd_bf16_mxu_tile1024``. Their plain versions evaluate
the power with ``torch.matmul`` at float32 matmul precision "highest"
(never TF32; they raise otherwise), as the reference's dot runs at
``Precision.HIGHEST``.

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
import functools
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

# the f32 kernels' sub-tile layout and block test (csrc/subtile_cull.cuh)
CELL = 16             # a quarter CTA's edge: one rect16 cell
BLOCK_W, BLOCK_H = 8, 4  # a warp's pixel block
SUB_CHUNK = 64        # pair rows a quarter stages per step
CULL_REL = 2.0 ** -18
CULL_ABS = 2.0 ** -16
PD_REL = 2.0 ** -16
# the block test's margin under mxu: CULL_MXU times a bound of the
# tile-local expansion's terms (|pxl|, |pyl| <= HALF_TILE in a 32x32 tile)
CULL_MXU = 2.0 ** -16
# the block test's margin under bf16 (the bfloat16 falloff), in place of
# CULL_REL and CULL_ABS
CULL_BF16_REL = 2.0 ** -5
CULL_BF16_ABS = 2.0 ** -5
HALF_TILE = (TPX - 1) / 2.0
HALF_TILE_SQ = HALF_TILE * HALF_TILE


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


def _falloff(ca, cb, cc, opa, dx, dy, bf16: bool):
    """(power, a_un = opa exp(power)) in f32. Under ``bf16`` the reference's
    bfloat16 body: dx, dy and the conic rounded to bfloat16, every product
    and sum rounded in the expression's order, the power clamped to <= 0
    (bfloat16 cancellation can round a tiny negative power positive),
    opa exp(power) rounded once more, both widened to f32."""
    if not bf16:
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        return power, opa * torch.exp(power)
    b = torch.bfloat16
    dxb, dyb = dx.to(b), dy.to(b)
    power = (-0.5 * (ca.to(b) * dxb * dxb + cc.to(b) * dyb * dyb)
             - cb.to(b) * dxb * dyb)
    power = torch.clamp(power, max=0.0)
    a_un = opa.to(b) * torch.exp(power)
    return power.float(), a_un.float()


def _assemble(acc, T, ntouch, n_tx: int, n_ty: int, W: int, H: int,
              tile: int) -> Composite2Out:
    """Per-tile sums (T, 4, tile^2) and T (T, tile^2) -> the (C, H, W)
    planes."""
    planes = torch.cat([acc, T[:, None]], dim=1)               # (T, 5, P)
    img = (planes.reshape(n_ty, n_tx, 5, tile, tile)
           .permute(2, 0, 3, 1, 4)
           .reshape(5, n_ty * tile, n_tx * tile))[:, :H, :W]
    return Composite2Out(color_sum=img[0:3], depth_sum=img[3],
                         final_T=img[4], n_touched_pairs=ntouch)


def _check_highest_precision():
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the mxu plain versions need float32 matmul precision 'highest' "
            "(the reference's dot runs at Precision.HIGHEST), got "
            f"{torch.get_float32_matmul_precision()!r}")


def _mxu_form(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
              cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """The falloff of pair rows ``f`` (S, k, 16) at pixels (px, py) (S, 1,
    P) of tiles centred at (cx, cy) (S, 1, 1) as the expanded tile-local
    quadratic form G6 @ P6, (S, k, P), unclamped."""
    _check_highest_precision()
    mxl = f[..., 0:1] - cx
    myl = f[..., 1:2] - cy
    ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
    g3 = ca * mxl + cb * myl
    g4 = cb * mxl + cc * myl
    g5 = -0.5 * (ca * mxl * mxl + 2.0 * cb * mxl * myl + cc * myl * myl)
    G6 = torch.cat([-0.5 * ca, -cb, -0.5 * cc, g3, g4, g5], dim=-1)
    pxl = px - cx
    pyl = py - cy
    P6 = torch.cat([pxl * pxl, pxl * pyl, pyl * pyl, pxl, pyl,
                    torch.ones_like(pxl)], dim=1)              # (S, 6, P)
    return torch.matmul(G6, P6)


def _mxu_power(f, px, py, cx, cy) -> torch.Tensor:
    """The reference's ``_mxu_power``: ``_mxu_form`` clamped to <= 0."""
    return torch.clamp(_mxu_form(f, px, py, cx, cy), max=0.0)


def _tile_centres(sel: torch.Tensor, n_tx: int):
    """(cx, cy) = (tx*32 + 15.5, ty*32 + 15.5) of tiles ``sel``, (S, 1, 1)
    f32 each, as the reference forms them."""
    tx = (sel % n_tx).to(torch.float32) * TPX + (TPX - 1) / 2.0
    ty = (sel // n_tx).to(torch.float32) * TPY + (TPY - 1) / 2.0
    return tx[:, None, None], ty[:, None, None]


def _plain_walk_mxu(feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight,
                    cull: bool = False, done_at: bool = False) -> tuple:
    """``plain_walk`` under ``mxu`` (32x32 tiles): the reference's MXU
    forward chunk by chunk of K = 128 pair rows. Per chunk the falloff is
    ``_mxu_power`` and the transmittance the log-space prefix
    T_incl = T exp(cumsum(log1p(-alpha_eff))), alpha_eff zero where the
    pair is not live, T_excl = T_incl / (1 - alpha_eff); a pixel's done
    flag and T move at the chunk's end (T = min(T, T_incl over included
    pairs)), as in the reference, where T_incl is monotone along the chunk
    so everything behind a terminating pair is dropped too. ``cull`` and
    ``done_at`` as in ``plain_walk``, the block test with the mxu margin
    (``block_keep_plain(..., centre=)``); a pixel's stop offset is its
    first terminating pair's."""
    dev = feat.device
    f32 = torch.float32
    n_tiles = n_tx * n_ty
    B_al = feat.shape[0]
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()

    px, py, pix_in, t16x, t16y = _tile_pixels(n_tx, n_ty, W, H, dev, TPX)
    if cull:
        xb, yb = _pixel_blocks(n_tx, n_ty, dev)
    stop_at = torch.where(pix_in, 1 << 62, -1)
    T = torch.ones(n_tiles, P, dtype=f32, device=dev)
    done = ~pix_in
    acc = torch.zeros(n_tiles, 4, P, dtype=f32, device=dev)
    ntouch = torch.zeros(B_al, dtype=f32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    passed = torch.zeros((), dtype=torch.long, device=dev)
    n_chunks = (n_pairs + K - 1) // K
    k_ar = torch.arange(K, device=dev)

    for c in range(int(n_chunks.max().item()) if n_tiles else 0):
        walking = (c < n_chunks) & ~done.all(dim=1)
        sel = torch.nonzero(walking).squeeze(1)
        if sel.numel() == 0:
            break
        rows = c * K + k_ar
        row_ok = rows[None] < n_pairs[sel][:, None]             # (S, K)
        idx = torch.clamp(start[sel][:, None] + rows[None], max=B_al - 1)
        f = feat[idx]                                          # (S, K, 16)
        cx, cy = _tile_centres(sel, n_tx)
        power = _mxu_power(f, px[sel][:, None], py[sel][:, None], cx, cy)
        alpha = torch.clamp(f[..., 5:6] * torch.exp(power), max=ALPHA_MAX)
        t16x_s, t16y_s = t16x[sel][:, None], t16y[sel][:, None]
        rect_ok = ((t16x_s >= f[..., 10:11]) & (t16x_s < f[..., 12:13])
                   & (t16y_s >= f[..., 11:12]) & (t16y_s < f[..., 13:14]))
        ok = (row_ok[..., None] & rect_ok & (power <= 0.0)
              & (alpha >= ALPHA_MIN))                          # (S, K, P)
        if cull:
            ok &= block_keep_plain(f[..., None, :], xb[sel], yb[sel],
                                   centre=(cx, cy))
        done_s = done[sel]
        live = ok & ~done_s[:, None]
        alpha_eff = torch.where(live, alpha, torch.zeros_like(alpha))
        cum = torch.cumsum(torch.log1p(-alpha_eff), dim=1)
        T_incl = T[sel][:, None] * torch.exp(cum)
        T_excl = T_incl / (1.0 - alpha_eff)
        term = T_incl < T_EPS
        inc = live & ~term
        w = torch.where(inc, alpha, torch.zeros_like(alpha)) * T_excl
        acc[sel] += torch.einsum("skc,skp->scp", f[..., 6:10], w)
        new_T = torch.where(inc, T_incl, torch.full_like(T_incl, 2.0))
        T[sel] = torch.minimum(T[sel], new_T.amin(dim=1))
        stop = live & term
        # pixels done before each row: at the chunk's start or by an
        # earlier row's termination
        before = done_s[:, None] | ((torch.cumsum(stop.int(), dim=1)
                                     - stop.int()) > 0)
        walked[sel] += (row_ok & ~before.all(dim=2)).sum(dim=1)
        passed += (ok & ~before).sum()
        first = c * K + torch.argmax(stop.to(torch.uint8), dim=1)
        stop_at[sel] = torch.where(stop.any(dim=1), first, stop_at[sel])
        done[sel] = done_s | stop.any(dim=1)
        if with_ntouch:
            cond = inc & ((w >= ALPHA_MIN) if nt_weight else (T_incl > 0.5))
            nt = (cond & pix_in[sel][:, None]).sum(dim=2).to(f32)
            ntouch[idx[row_ok]] = nt[row_ok]

    out = _assemble(acc, T, ntouch, n_tx, n_ty, W, H, TPX)
    return (out, walked, passed, stop_at) if done_at else \
        (out, walked, passed)


def mxu_margin_plain(f: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor
                     ) -> torch.Tensor:
    """The block test's extra margin under mxu (``csrc/subtile_cull.cuh``
    ``prepare_mxu``, the same f32 operations in the same order): CULL_MXU
    times Mmag, a bound of every term of the tile-local expansion (and of
    every product that forms G8) of pair rows ``f`` (..., 16) over the
    pixels of the 32x32 tile centred at (cx, cy)."""
    mxl = torch.abs(f[..., 0] - cx)
    myl = torch.abs(f[..., 1] - cy)
    ca, cb, cc = (torch.abs(f[..., i]) for i in (2, 3, 4))
    quad = HALF_TILE_SQ * ((0.5 * ca + cb) + 0.5 * cc)
    lin = HALF_TILE * (((ca * mxl + cb * myl) + cb * mxl) + cc * myl)
    cst = 0.5 * ((ca * mxl * mxl + 2.0 * cb * mxl * myl) + cc * myl * myl)
    return CULL_MXU * ((quad + lin) + cst)


def block_keep_plain(f: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                     centre=None, bf16: bool = False) -> torch.Tensor:
    """The sub-tile kernels' conservative block test
    (``csrc/subtile_cull.cuh``: ``prepare`` then ``block_keep``, the same
    f32 operations in the same order): False only where pair row ``f``
    (..., 16) has opa * exp(power) < 1/255, as the kernels' f32
    arithmetic computes it, at every pixel of the 8x4 block whose top-left
    pixel is (xb, yb) (f32, broadcast against ``f[..., 0]``). The minimum
    of q = ca dx^2 + 2 cb dx dy + cc dy^2 over the block's rectangle of
    deltas (0 if the mean lies inside, else the least of the four edges'
    1-D minima at stationary points clamped to the edge, from 1/ca and
    1/cc) must exceed 2 (L + CULL_REL Smax + CULL_ABS), L = log(opa) -
    log(1/255), Smax = 2 (ca max dx^2 + cc max dy^2): the margin covers
    the rounding of the kernel's power, of this test, of expf and logf
    (the source's note gives the argument). Rows with a non-finite mean,
    conic or opacity and conics that are not clearly positive definite
    get L = +inf and are kept. Under mxu, ``centre`` = (cx, cy) of the
    32x32 tile (broadcast against ``f[..., 0]``) and L carries
    ``mxu_margin_plain`` too: the tensor-core power and the plain
    version's f32 matmul round relative to the tile-local expansion's
    terms. Under ``bf16`` the margin is that of the bfloat16 falloff
    (``_falloff(bf16=True)``, every product and sum rounded to 8
    significant bits): CULL_BF16_REL Smax + CULL_BF16_ABS in place of
    CULL_REL Smax + CULL_ABS (the source's note derives it)."""
    mx, my, ca, cb, cc, opa = (f[..., i] for i in range(6))
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(ca)
              & torch.isfinite(cb) & torch.isfinite(cc)
              & torch.isfinite(opa))
    det = ca * cc - cb * cb
    pd = (ca > 0.0) & (cc > 0.0) & (det > PD_REL * (ca * cc))
    log_min = torch.log(torch.tensor(ALPHA_MIN, dtype=f.dtype))
    L = torch.where(finite & pd, torch.log(opa) - log_min,
                    torch.full_like(opa, float("inf")))
    if centre is not None:
        L = L + mxu_margin_plain(f, *centre)
    inv_ca = 1.0 / ca
    inv_cc = 1.0 / cc
    xlo = mx - (xb + float(BLOCK_W - 1))
    xhi = mx - xb
    ylo = my - (yb + float(BLOCK_H - 1))
    yhi = my - yb
    inside = (xlo <= 0.0) & (xhi >= 0.0) & (ylo <= 0.0) & (yhi >= 0.0)

    def edge_min(a, lo, hi, ca_, cb_, cc_, inv_c):
        d = torch.fmin(torch.fmax(-(cb_ * a) * inv_c, lo), hi)
        return (ca_ * a * a + 2.0 * cb_ * a * d) + cc_ * d * d

    qmin = torch.fmin(
        torch.fmin(edge_min(xlo, ylo, yhi, ca, cb, cc, inv_cc),
                   edge_min(xhi, ylo, yhi, ca, cb, cc, inv_cc)),
        torch.fmin(edge_min(ylo, xlo, xhi, cc, cb, ca, inv_ca),
                   edge_min(yhi, xlo, xhi, cc, cb, ca, inv_ca)))
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    smax = 2.0 * (ca * torch.fmax(xlo * xlo, xhi * xhi)
                  + cc * torch.fmax(ylo * ylo, yhi * yhi))
    rel, abs_ = (CULL_BF16_REL, CULL_BF16_ABS) if bf16 else (CULL_REL,
                                                             CULL_ABS)
    return ~(0.5 * qmin > L + rel * smax + abs_)


def _pixel_blocks(n_tx: int, n_ty: int, dev, tile: int = TPX):
    """(xb, yb) f32, (n_tiles, 1, tile^2): the top-left pixel of the 8x4
    block each pixel of each tile of edge ``tile`` belongs to."""
    q = torch.arange(tile * tile, device=dev)
    t_ar = torch.arange(n_tx * n_ty, device=dev)
    xb = (t_ar % n_tx)[:, None] * tile + (q % tile // BLOCK_W * BLOCK_W)[None]
    yb = (t_ar // n_tx)[:, None] * tile + (q // tile // BLOCK_H
                                           * BLOCK_H)[None]
    return (xb.to(torch.float32)[:, None], yb.to(torch.float32)[:, None])


def plain_walk(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
               n_ty: int, W: int, H: int, with_ntouch: bool = True,
               nt_weight: bool = False, tile: int = TPX, bf16: bool = False,
               mxu: bool = False, cull: bool = False, done_at: bool = False
               ) -> tuple:
    """Plain PyTorch compositing over square tiles of edge ``tile`` (32 for
    B1, 16 for B3) on an n_tx x n_ty grid. Returns (outputs, pairs_walked,
    cells_passed) where pairs_walked[t] counts the pair rows tile t walked
    until every one of its pixels was done, and cells_passed the (pair,
    pixel) cells that passed the skip tests while their pixel was not done
    (the included ones and each pixel's terminating one): the work this
    input needs.

    Vectorized over tiles x pixels. The pair rows come in chunks; the
    falloff, alpha and skip tests of a chunk are evaluated at once, then
    the pairs of the chunk are composited one after another with the
    kernel's exact arithmetic (T_incl = T (1 - alpha), w = alpha T,
    acc += c w, no fused multiply-adds), so on the card the two agree bit
    for bit wherever their exp does. ``mxu`` (32x32 only) runs the MXU
    body instead (``_plain_walk_mxu``), which takes precedence over
    ``bf16``.

    ``cull`` skips every cell whose (pair, 8x4 block) ``block_keep_plain``
    drops, as the sub-tile kernels do (under bf16 and under mxu with the
    margin of that falloff); the outputs and the passed cells are the
    same as without it. ``done_at`` appends
    a fourth result, (n_tiles, tile^2) int64: for each pixel the offset in
    its tile's run of the pair at which it was done, -1 outside the image
    and 2^62 where it never was (``subtile_cells`` reads it)."""
    if mxu:
        if tile != TPX:
            raise ValueError("mxu is a body of the 32x32 kernels only")
        return _plain_walk_mxu(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                               nt_weight, cull=cull, done_at=done_at)
    dev = feat.device
    f32 = torch.float32
    chunk = PLAIN_CHUNK
    n_tiles = n_tx * n_ty
    B_al = feat.shape[0]
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()

    px, py, pix_in, t16x, t16y = _tile_pixels(n_tx, n_ty, W, H, dev, tile)
    n_pix = tile * tile
    if cull:
        xb, yb = _pixel_blocks(n_tx, n_ty, dev, tile)
    never = 1 << 62
    stop_at = torch.where(pix_in, never, -1)

    T = torch.ones(n_tiles, n_pix, dtype=f32, device=dev)
    done = ~pix_in
    acc = torch.zeros(n_tiles, 4, n_pix, dtype=f32, device=dev)
    ntouch = torch.zeros(B_al, dtype=f32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    passed = torch.zeros((), dtype=torch.long, device=dev)
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
        power, a_un = _falloff(ca, cb, cc, opa, dx, dy, bf16)
        alpha = torch.clamp(a_un, max=ALPHA_MAX)
        t16x_s, t16y_s = t16x[sel][:, None], t16y[sel][:, None]
        rect_ok = ((t16x_s >= f[..., 10:11]) & (t16x_s < f[..., 12:13])
                   & (t16y_s >= f[..., 11:12]) & (t16y_s < f[..., 13:14]))
        ok = (row_ok[..., None] & rect_ok & (power <= 0.0)
              & (alpha >= ALPHA_MIN))                          # (S, k, P)
        if cull:
            ok &= block_keep_plain(f[..., None, :], xb[sel], yb[sel],
                                   bf16=bf16)

        T_s, done_s, acc_s = T[sel], done[sel], acc[sel]
        stop_s = stop_at[sel]
        nt = torch.zeros(sel.numel(), chunk, dtype=f32, device=dev)
        for k in range(chunk):
            walked[sel] += (row_ok[:, k] & ~done_s.all(dim=1)).long()
            live = ok[:, k] & ~done_s
            passed += live.sum()
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
            stop_s = torch.where(term, c * chunk + k, stop_s)
        T[sel], done[sel], acc[sel] = T_s, done_s, acc_s
        stop_at[sel] = stop_s
        if with_ntouch:
            ntouch[idx[row_ok]] = nt[row_ok]

    out = _assemble(acc, T, ntouch, n_tx, n_ty, W, H, tile)
    return (out, walked, passed, stop_at) if done_at else \
        (out, walked, passed)


def subtile_cells(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
                  n_ty: int, stop_at: torch.Tensor, tile: int = TPX,
                  mxu: bool = False, bf16: bool = False,
                  batch: int = 1 << 17) -> Tuple[int, int]:
    """The (pair, pixel) cells the sub-tile kernels evaluate on a plan of
    ``tile``-px tiles (32: B1/B1' and B2, under ``bf16`` B1-bf16/B1'-bf16
    and B2-bf16 and under ``mxu`` B1-mxu/B1'-mxu, B2-mxu and, with
    ``bf16`` too, B2-bf16-mxu, whose block tests carry the margin of their
    falloff; 16: B3/B3' and B4), from the
    ``stop_at`` of ``plain_walk(..., done_at=True)`` (the forwards) or
    ``plain_bwd_walk(..., done_at=True)`` (the backwards) of the same
    body: (after the rect16 compaction and the block test, after the
    rect16 compaction alone). A warp's 8x4 block
    walks chunk c of SUB_CHUNK pair rows of its tile's run if one of its
    pixels is not done at the chunk's start (its stop offset >= c *
    SUB_CHUNK), and then evaluates 32 cells for each pair of the chunk that
    covers its 16-px cell and that ``block_keep_plain`` keeps. Counted in
    batches of ``batch`` pair slots."""
    dev = feat.device
    n_tiles = n_tx * n_ty
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()
    # per tile and 8x4 block, the last stop offset
    n_bx = tile // BLOCK_W
    n_blk = n_bx * (tile // BLOCK_H)
    q = torch.arange(tile * tile, device=dev)
    blk = (q // tile // BLOCK_H) * n_bx + q % tile // BLOCK_W
    last = torch.full((n_tiles, n_blk), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(1, blk[None].expand(n_tiles, -1), stop_at, "amax")
    b_ar = torch.arange(n_blk, device=dev)
    bx = (b_ar % n_bx) * BLOCK_W                                 # (n_blk,)
    by = (b_ar // n_bx) * BLOCK_H
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                      n_pairs)
    first = torch.cumsum(n_pairs, 0) - n_pairs
    kept = rected = 0
    for lo in range(0, tile_of.numel(), batch):
        t = tile_of[lo:lo + batch]
        j = torch.arange(lo, lo + t.numel(), device=dev) - first[t]
        f = feat[start[t] + j]                                  # (S, 16)
        x0 = (t % n_tx)[:, None] * tile + bx[None]              # (S, n_blk)
        y0 = (t // n_tx)[:, None] * tile + by[None]
        t16x = (x0 // CELL).to(torch.float32)
        t16y = (y0 // CELL).to(torch.float32)
        rect = ((t16x >= f[:, 10:11]) & (t16x < f[:, 12:13])
                & (t16y >= f[:, 11:12]) & (t16y < f[:, 13:14]))
        walks = (j // SUB_CHUNK * SUB_CHUNK)[:, None] <= last[t]
        live = rect & walks
        centre = (tuple(c[:, :, 0] for c in _tile_centres(t, n_tx))
                  if mxu else None)
        keep = block_keep_plain(f[:, None, :], x0.to(torch.float32),
                                y0.to(torch.float32), centre=centre,
                                bf16=bf16 and not mxu)
        rected += int(live.sum())
        kept += int((live & keep).sum())
    return 32 * kept, 32 * rected


def composite32_plain(feat, ranges, n_tx, n_ty, W, H, with_ntouch=True,
                      nt_weight=False, bf16=False, mxu=False
                      ) -> Composite2Out:
    """Plain PyTorch version of the kernel (same function, any device)."""
    return plain_walk(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                      nt_weight, bf16=bf16, mxu=mxu)[0]


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
               nt_weight, entry: str) -> Composite2Out:
    """Launch the forward kernel ``entry`` of library ``lib`` (a C entry
    with the signature of ``composite32_fwd``) over an n_tx x n_ty tile
    grid."""
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned for float4 loads")
    fn = _build.entry(lib, entry)
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


def _variant(bf16: bool, mxu: bool) -> str:
    """The C entry's and the launch counter's suffix of a variant."""
    return ("_bf16" if bf16 else "") + ("_mxu" if mxu else "")


def _fwd_lib(suffix: str) -> str:
    """The library of a forward variant: the f32 and bf16 sub-tile kernels
    share one, the mxu one has its own."""
    return {"": "tile32_fwd_subtile", "_bf16": "tile32_fwd_subtile",
            "_mxu": "tile32_fwd_subtile_mxu"}[suffix]


def _count(wrapper, suffix: str):
    attr = "launches" + suffix
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def composite32_fwd(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
                    n_ty: int, W: int, H: int, bf16: bool = False,
                    mxu: bool = False) -> Composite2Out:
    """Forward compositing without per-pair n_touched (zeros); the
    bfloat16 falloff under ``bf16``, the MXU body under ``mxu`` (which
    takes precedence)."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=False, bf16=bf16, mxu=mxu)
    suffix = _variant(bf16 and not mxu, mxu)
    out = launch_fwd(_fwd_lib(suffix), feat, ranges, n_tx, n_ty, W, H,
                     False, False, "composite32_fwd" + suffix)
    _count(composite32_fwd, suffix)
    return out


composite32_fwd.launches = 0
composite32_fwd.launches_bf16 = 0
composite32_fwd.launches_mxu = 0


def composite32_fwd_ntouch(feat: torch.Tensor, ranges: torch.Tensor,
                           n_tx: int, n_ty: int, W: int, H: int,
                           nt_weight: bool = False, bf16: bool = False,
                           mxu: bool = False) -> Composite2Out:
    """Forward compositing with per-pair n_touched: pixels where the pair
    was included and T_incl > 0.5, or alpha*T >= 1/255 under
    ``nt_weight``; the bfloat16 falloff under ``bf16``, the MXU body
    under ``mxu`` (which takes precedence)."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=True, nt_weight=nt_weight,
                                 bf16=bf16, mxu=mxu)
    suffix = _variant(bf16 and not mxu, mxu)
    out = launch_fwd(_fwd_lib(suffix), feat, ranges, n_tx, n_ty, W, H,
                     True, nt_weight, "composite32_fwd" + suffix)
    _count(composite32_fwd_ntouch, suffix)
    return out


composite32_fwd_ntouch.launches = 0
composite32_fwd_ntouch.launches_bf16 = 0
composite32_fwd_ntouch.launches_mxu = 0


def composite32_fwd_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                             n_tx: int, n_ty: int, W: int, H: int,
                             with_ntouch: bool = False,
                             nt_weight: bool = False) -> Composite2Out:
    """The f32 forward of the one-CTA-per-tile design that the sub-tile
    kernel replaced (``csrc/tile_kernel2_fwd.cu``, C entry
    ``composite32_fwd_tile1024``): a yardstick timed beside
    ``composite32_fwd`` on the same plans, launched by no path."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=with_ntouch, nt_weight=nt_weight)
    out = launch_fwd("tile_kernel2_fwd", feat, ranges, n_tx, n_ty, W, H,
                     with_ntouch, nt_weight, "composite32_fwd_tile1024")
    composite32_fwd_tile1024.launches += 1
    return out


composite32_fwd_tile1024.launches = 0


def composite32_fwd_bf16_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                                  n_tx: int, n_ty: int, W: int, H: int,
                                  with_ntouch: bool = False,
                                  nt_weight: bool = False) -> Composite2Out:
    """The bf16 forward of the one-CTA-per-tile design that the sub-tile
    kernel replaced (``csrc/tile_kernel2_fwd.cu``, C entry
    ``composite32_fwd_bf16_tile1024``): a yardstick timed beside
    ``composite32_fwd(bf16=True)`` on the same plans, launched by no
    path."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=with_ntouch, nt_weight=nt_weight,
                                 bf16=True)
    out = launch_fwd("tile_kernel2_fwd", feat, ranges, n_tx, n_ty, W, H,
                     with_ntouch, nt_weight, "composite32_fwd_bf16_tile1024")
    composite32_fwd_bf16_tile1024.launches += 1
    return out


composite32_fwd_bf16_tile1024.launches = 0


def composite32_fwd_mxu_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                                 n_tx: int, n_ty: int, W: int, H: int,
                                 with_ntouch: bool = False,
                                 nt_weight: bool = False) -> Composite2Out:
    """The mxu forward of the one-CTA-per-tile design that the sub-tile
    mxu kernel replaced (``csrc/tile_kernel2_fwd.cu``, C entry
    ``composite32_fwd_mxu_tile1024``): a yardstick timed beside
    ``composite32_fwd(mxu=True)`` on the same plans, launched by no
    path."""
    _check(feat, ranges, n_tx, n_ty)
    if feat.device.type == "cpu":
        return composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                                 with_ntouch=with_ntouch, nt_weight=nt_weight,
                                 mxu=True)
    out = launch_fwd("tile_kernel2_fwd", feat, ranges, n_tx, n_ty, W, H,
                     with_ntouch, nt_weight, "composite32_fwd_mxu_tile1024")
    composite32_fwd_mxu_tile1024.launches += 1
    return out


composite32_fwd_mxu_tile1024.launches = 0


def mxu_power_tile(feat: torch.Tensor, tx: int, ty: int) -> torch.Tensor:
    """The tensor-core falloff of ``csrc/mxu_falloff.cuh`` alone, for a
    check on the card: the unclamped power (128, 1024) of one chunk of at
    most 128 pair rows ``feat`` (n, 16) at tile (tx, ty), pixel q = y*32 +
    x; rows >= n are zero. CUDA tensors only (the plain counterpart is
    ``mxu_power_tile_plain``)."""
    if feat.device.type != "cuda":
        raise ValueError("mxu_power_tile runs on a CUDA tensor only")
    if feat.dtype != torch.float32 or feat.dim() != 2 \
            or feat.shape[1] != FEAT_DIM or feat.shape[0] > K \
            or not feat.is_contiguous() or feat.data_ptr() % 16:
        raise ValueError("feat must be (n <= 128, 16) float32, contiguous "
                         "and 16-byte aligned")
    out = torch.empty(K, P, dtype=torch.float32, device=feat.device)
    fn = _build.entry("tile_kernel2_fwd", "mxu_power_tile")
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(ctypes.c_void_p(feat.data_ptr()), feat.shape[0], tx, ty,
                 ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mxu_power_tile launch failed: CUDA error {err}")
    return out


def mxu_power_tile_plain(feat: torch.Tensor, tx: int, ty: int
                         ) -> torch.Tensor:
    """``mxu_power_tile``'s function: ``_mxu_form`` (f32 ``G6 @ P6``,
    unclamped) of one chunk at tile (tx, ty), rows >= n zero."""
    dev = feat.device
    q = torch.arange(P, device=dev)
    px = (tx * TPX + q % TPX).to(feat.dtype)[None, None]
    py = (ty * TPY + q // TPX).to(feat.dtype)[None, None]
    cx = torch.full((1, 1, 1), tx * TPX + (TPX - 1) / 2.0, dtype=feat.dtype,
                    device=dev)
    cy = torch.full((1, 1, 1), ty * TPY + (TPY - 1) / 2.0, dtype=feat.dtype,
                    device=dev)
    out = torch.zeros(K, P, dtype=feat.dtype, device=dev)
    out[:feat.shape[0]] = _mxu_form(feat[None], px, py, cx, cy)[0]
    return out


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
                   tile: int = TPX, bf16: bool = False, mxu: bool = False,
                   cull: bool = False, done_at: bool = False) -> tuple:
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
    zero. Under ``bf16`` the falloff is ``_falloff``'s bfloat16 body and
    the five quadratic-form products are formed in bfloat16 from G, dx,
    dy and dL/dG rounded to bfloat16, each widened before its sum. Under
    ``mxu`` (32x32 only) the falloff is ``_mxu_power`` and a_un = opa
    exp(power) in f32; the walk, the linear transmittance and the products
    (bfloat16 ones too under ``bf16``) stay. ``cull`` skips every cell
    whose (pair, 8x4 block) ``block_keep_plain`` drops, as the sub-tile
    kernels do, with the margin of the walk's falloff (under ``bf16``
    ``bf16=True``, under ``mxu`` the 32x32 tile's ``centre``); a culled
    cell adds exact zeros, so the rows are the same as without it.
    ``done_at`` appends a fourth result as ``plain_walk``'s: for each
    pixel the offset in its tile's run of the pair at which this walk was
    done (-1 outside the image, 2^62 where it never was). Under ``mxu``
    that is where the linear T falls below 1e-4, which can differ from the
    mxu forward's log-space stop; otherwise it equals ``plain_walk``'s."""
    if mxu and tile != TPX:
        raise ValueError("mxu is a body of the 32x32 kernels only")
    dev = feat.device
    f32 = torch.float32
    chunk = PLAIN_CHUNK
    n_tiles = n_tx * n_ty
    B_al = feat.shape[0]
    start = ranges[:, 0].long()
    n_pairs = (ranges[:, 1] - ranges[:, 0]).long()

    px, py, pix_in, t16x, t16y = _tile_pixels(n_tx, n_ty, W, H, dev, tile)
    n_pix = tile * tile
    if cull:
        xb, yb = _pixel_blocks(n_tx, n_ty, dev, tile)
    stop_at = torch.where(pix_in, 1 << 62, -1)

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
        if mxu:
            centre = _tile_centres(sel, n_tx)
            power = _mxu_power(f, px_s, py_s, *centre)
            a_un = opa * torch.exp(power)
        else:
            power, a_un = _falloff(ca, cb, cc, opa, dx, dy, bf16)
        alpha = torch.clamp(a_un, max=ALPHA_MAX)
        t16x_s, t16y_s = t16x[sel][:, None], t16y[sel][:, None]
        rect_ok = ((t16x_s >= f[..., 10:11]) & (t16x_s < f[..., 12:13])
                   & (t16y_s >= f[..., 11:12]) & (t16y_s < f[..., 13:14]))
        ok = (row_ok[..., None] & rect_ok & (power <= 0.0)
              & (alpha >= ALPHA_MIN))                          # (S, k, P)
        if cull:
            ok &= block_keep_plain(f[..., None, :], xb[sel], yb[sel],
                                   centre=centre if mxu else None,
                                   bf16=bf16 and not mxu)
        G_all = a_un / torch.clamp(opa, min=1e-12)

        T_s, done_s, pA_s = T[sel], done[sel], pA[sel]
        stop_s = stop_at[sel]
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
            conic = fk[:, 2:5]
            # masked too: a non-finite mean must not reach a skipped cell
            dxk = torch.where(inc, dx[:, k], zero)
            dyk = torch.where(inc, dy[:, k], zero)
            if bf16:
                b = torch.bfloat16
                G_, dLdG, conic = G.to(b), dLdG.to(b), conic.to(b)
                dxk, dyk = dxk.to(b), dyk.to(b)
            else:
                G_ = G
            ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
            gdx = G_ * dxk
            gdy = G_ * dyk
            dG_ddx = -gdx * ca - gdy * cb
            dG_ddy = -gdy * cc - gdx * cb
            quad = [dLdG * dG_ddx, dLdG * dG_ddy, dLdG * (-0.5 * gdx * dxk),
                    dLdG * (-gdx * dyk), dLdG * (-0.5 * gdy * dyk)]
            vals = torch.stack([q.float() for q in quad] + [
                G * dLda, w * cot_s[:, 0], w * cot_s[:, 1],
                w * cot_s[:, 2], w * cot_s[:, 3]], dim=1)      # (S, 10, P)
            acc[:, k] = vals.sum(dim=-1)
            T_s = torch.where(inc, T_incl, T_s)
            done_s = done_s | term
            stop_s = torch.where(term, c * chunk + k, stop_s)
        T[sel], done[sel], pA[sel] = T_s, done_s, pA_s
        stop_at[sel] = stop_s
        dfeat[idx[row_ok], :N_ROWS] = acc[row_ok]
    return (dfeat, walked, included, stop_at) if done_at else \
        (dfeat, walked, included)


def composite32_bwd_plain(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, n_tx, n_ty, W, H,
                          bf16=False, mxu=False) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (any device)."""
    return plain_bwd_walk(feat, ranges, color_sum, depth_sum, final_T,
                          d_color, d_depth, d_T, n_tx, n_ty, W, H,
                          bf16=bf16, mxu=mxu)[0]


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
                    n_ty: int, W: int, H: int, bf16: bool = False,
                    mxu: bool = False) -> torch.Tensor:
    """Per-pair gradient rows (B_al, 16) from the forward's planes
    (color_sum (3,H,W) before background, depth_sum, final_T) and their
    cotangents; the bfloat16 bodies under ``bf16``, the MXU falloff under
    ``mxu`` (with the bfloat16 products under both). Every body is the
    sub-tile kernel of ``csrc/tile32_bwd_subtile.cu`` (C entries
    ``composite32_bwd``, ``composite32_bwd_bf16``, ``composite32_bwd_mxu``,
    ``composite32_bwd_bf16_mxu``; one body, the block test with the margin
    of each falloff). Rows the kernel never writes keep the zero they were
    allocated with."""
    _check(feat, ranges, n_tx, n_ty)
    _check_planes(feat, W, H, color_sum=color_sum, depth_sum=depth_sum,
                  final_T=final_T, d_color=d_color, d_depth=d_depth, d_T=d_T)
    if feat.device.type == "cpu":
        return composite32_bwd_plain(feat, ranges, color_sum, depth_sum,
                                     final_T, d_color, d_depth, d_T, n_tx,
                                     n_ty, W, H, bf16=bf16, mxu=mxu)
    suffix = _variant(bf16, mxu)
    dfeat = launch_bwd("tile32_bwd_subtile", feat, ranges, color_sum,
                       depth_sum, final_T, d_color, d_depth, d_T, n_tx, n_ty,
                       W, H, "composite32_bwd" + suffix)
    _count(composite32_bwd, suffix)
    return dfeat


def _bwd_tile1024(wrapper, entry: str, bf16: bool, mxu: bool, feat, ranges,
                  color_sum, depth_sum, final_T, d_color, d_depth, d_T,
                  n_tx: int, n_ty: int, W: int, H: int) -> torch.Tensor:
    """A yardstick backward of the one-CTA-per-tile design: C entry
    ``entry`` of ``csrc/tile_kernel2_bwd.cu``, counted in ``wrapper``'s
    ``launches``; the plain version of the ``bf16`` / ``mxu`` body on the
    CPU."""
    _check(feat, ranges, n_tx, n_ty)
    _check_planes(feat, W, H, color_sum=color_sum, depth_sum=depth_sum,
                  final_T=final_T, d_color=d_color, d_depth=d_depth, d_T=d_T)
    if feat.device.type == "cpu":
        return composite32_bwd_plain(feat, ranges, color_sum, depth_sum,
                                     final_T, d_color, d_depth, d_T, n_tx,
                                     n_ty, W, H, bf16=bf16, mxu=mxu)
    dfeat = launch_bwd("tile_kernel2_bwd", feat, ranges, color_sum,
                       depth_sum, final_T, d_color, d_depth, d_T, n_tx, n_ty,
                       W, H, entry)
    wrapper.launches += 1
    return dfeat


def composite32_bwd_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                             color_sum: torch.Tensor, depth_sum: torch.Tensor,
                             final_T: torch.Tensor, d_color: torch.Tensor,
                             d_depth: torch.Tensor, d_T: torch.Tensor,
                             n_tx: int, n_ty: int, W: int, H: int
                             ) -> torch.Tensor:
    """The f32 backward of the one-CTA-per-tile design that the sub-tile
    kernel replaced (``csrc/tile_kernel2_bwd.cu``, C entry
    ``composite32_bwd_tile1024``): a yardstick timed beside
    ``composite32_bwd`` on the same plans, launched by no path."""
    return _bwd_tile1024(composite32_bwd_tile1024, "composite32_bwd_tile1024",
                         False, False, feat, ranges, color_sum, depth_sum,
                         final_T, d_color, d_depth, d_T, n_tx, n_ty, W, H)


def composite32_bwd_bf16_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                                  color_sum: torch.Tensor,
                                  depth_sum: torch.Tensor,
                                  final_T: torch.Tensor,
                                  d_color: torch.Tensor,
                                  d_depth: torch.Tensor, d_T: torch.Tensor,
                                  n_tx: int, n_ty: int, W: int, H: int
                                  ) -> torch.Tensor:
    """The bf16 backward of the one-CTA-per-tile design that the sub-tile
    kernel replaced (``csrc/tile_kernel2_bwd.cu``, C entry
    ``composite32_bwd_bf16_tile1024``): a yardstick timed beside
    ``composite32_bwd(bf16=True)`` on the same plans, launched by no
    path."""
    return _bwd_tile1024(composite32_bwd_bf16_tile1024,
                         "composite32_bwd_bf16_tile1024", True, False, feat,
                         ranges, color_sum, depth_sum, final_T, d_color,
                         d_depth, d_T, n_tx, n_ty, W, H)


def composite32_bwd_mxu_tile1024(feat: torch.Tensor, ranges: torch.Tensor,
                                 color_sum: torch.Tensor,
                                 depth_sum: torch.Tensor,
                                 final_T: torch.Tensor, d_color: torch.Tensor,
                                 d_depth: torch.Tensor, d_T: torch.Tensor,
                                 n_tx: int, n_ty: int, W: int, H: int
                                 ) -> torch.Tensor:
    """The mxu backward of the one-CTA-per-tile design that the sub-tile
    kernel replaced (``csrc/tile_kernel2_bwd.cu``, C entry
    ``composite32_bwd_mxu_tile1024``): a yardstick timed beside
    ``composite32_bwd(mxu=True)`` on the same plans, launched by no
    path."""
    return _bwd_tile1024(composite32_bwd_mxu_tile1024,
                         "composite32_bwd_mxu_tile1024", False, True, feat,
                         ranges, color_sum, depth_sum, final_T, d_color,
                         d_depth, d_T, n_tx, n_ty, W, H)


def composite32_bwd_bf16_mxu_tile1024(feat: torch.Tensor,
                                      ranges: torch.Tensor,
                                      color_sum: torch.Tensor,
                                      depth_sum: torch.Tensor,
                                      final_T: torch.Tensor,
                                      d_color: torch.Tensor,
                                      d_depth: torch.Tensor,
                                      d_T: torch.Tensor, n_tx: int,
                                      n_ty: int, W: int, H: int
                                      ) -> torch.Tensor:
    """The mxu backward with the bfloat16 products of the one-CTA-per-tile
    design that the sub-tile kernel replaced (``csrc/tile_kernel2_bwd.cu``,
    C entry ``composite32_bwd_bf16_mxu_tile1024``): a yardstick timed
    beside ``composite32_bwd(bf16=True, mxu=True)`` on the same plans,
    launched by no path."""
    return _bwd_tile1024(composite32_bwd_bf16_mxu_tile1024,
                         "composite32_bwd_bf16_mxu_tile1024", True, True,
                         feat, ranges, color_sum, depth_sum, final_T,
                         d_color, d_depth, d_T, n_tx, n_ty, W, H)


def launch_bwd(lib: str, feat, ranges, color_sum, depth_sum, final_T,
               d_color, d_depth, d_T, n_tx, n_ty, W, H,
               entry: str) -> torch.Tensor:
    """Launch the backward kernel ``entry`` of library ``lib`` (a C entry
    with the signature of ``composite32_bwd``) over an n_tx x n_ty tile
    grid."""
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned for float4 loads")
    fn = _build.entry(lib, entry)
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
composite32_bwd.launches_bf16 = 0
composite32_bwd.launches_mxu = 0
composite32_bwd.launches_bf16_mxu = 0
composite32_bwd_tile1024.launches = 0
composite32_bwd_bf16_tile1024.launches = 0
composite32_bwd_mxu_tile1024.launches = 0
composite32_bwd_bf16_mxu_tile1024.launches = 0


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
                nt_weight=False, bf16=False, mxu=False) -> Composite2Out:
    """Differentiable 32x32 compositing (the reference's ``composite32``).
    ``with_ntouch=False`` returns zero n_touched; ``bf16`` selects the
    bfloat16 bodies and ``mxu`` the MXU bodies for the forward and its
    backward."""
    kernels = (composite32_fwd, composite32_fwd_ntouch, composite32_bwd)
    if bf16 or mxu:
        kernels = tuple(functools.partial(k, bf16=bf16, mxu=mxu)
                        for k in kernels)
    return Composite2Out(*CompositeFn.apply(
        feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight, kernels))

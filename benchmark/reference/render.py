"""Plain PyTorch reference of the Gaussian-splat renderer: projection,
binning into 16-px cells and front-to-back compositing, forward and (by
autograd) backward. It imports nothing of the measured program.

Written from the renderer's documented semantics, with the arithmetic of
the program's modules frozen here (the origin of each piece is named on
it):

- projection (EWA, the frustum clamp, the conic, the tight per-axis cull
  extents and the 16-px rect): ``gs_slam_analytica_jacobian_tpu_torch/
  ops/gaussian_math.py`` ``preprocess`` (degree-0 SH), ``ops/lie.py``,
  ``ops/camera_math.py`` ``projection_matrix``;
- a Gaussian touches a pixel only where the pixel's 16x16 cell lies in its
  rect; it is skipped where power > 0 or alpha = min(0.99, opa exp(power))
  < 1/255; a pixel stops at the first Gaussian whose blend would take T
  below 1e-4 (that one is not blended);
- the order of the Gaussians in a cell is the binning key's:
  camera-space depth with the low mantissa bits dropped that the key of a
  32-px tile grid has no room for (``ops/binning2.py``: 31 minus the bit
  length of the tile count are kept), ties broken by Gaussian index.

Pair lists are composited in blocks of ``BLOCK`` pairs over chunks of
lists, with the transmittance carried between blocks; inside a block the
product is a cumulative product, so sums are associated otherwise than
in the program's kernels (float32 rounding apart, the same values).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

SH_C0 = 0.28209479177387814
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CELL = 16          # the rect test's cell edge (pixels)
KEY_TILE = 32      # the tile edge whose count sets the depth key's bits
BLOCK = 32         # pair rows composited at once


@dataclasses.dataclass(frozen=True)
class Cam:
    """World-to-camera pose (p_cam = R p_world + t) and pinhole
    intrinsics."""

    R: torch.Tensor
    t: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    def at(self, R, t) -> "Cam":
        return dataclasses.replace(self, R=R, t=t)


# ---------------------------------------------------------------------------
# Lie groups and projection (frozen from ops/lie.py, ops/camera_math.py)
# ---------------------------------------------------------------------------

def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _taylor(angle2, exact_fn, taylor):
    angle = torch.sqrt(torch.clamp(angle2, min=1e-24))
    small = angle < 1e-5
    safe = torch.where(small, torch.ones_like(angle), angle)
    return torch.where(small, taylor, exact_fn(safe))


def se3_exp(tau):
    """exp of se(3), tau = (rho, theta) -> (4, 4)."""
    rho, theta = tau[:3], tau[3:]
    W = skew(theta)
    W2 = W @ W
    a2 = torch.sum(theta * theta)
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device)
    A = _taylor(a2, lambda s: torch.sin(s) / s, 1.0 - a2 / 6.0)
    B = _taylor(a2, lambda s: (1.0 - torch.cos(s)) / (s * s), 0.5 - a2 / 24.0)
    C = _taylor(a2, lambda s: (s - torch.sin(s)) / (s * s * s),
                1.0 / 6.0 - a2 / 120.0)
    T = torch.eye(4, dtype=tau.dtype, device=tau.device)
    T[:3, :3] = eye + A * W + B * W2
    T[:3, 3] = (eye + B * W + C * W2) @ rho
    return T


def pose_matrix(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def quat_to_rotmat(q):
    """(w, x, y, z), normalized first -> (..., 3, 3)."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def projection_matrix(cam: Cam, device) -> torch.Tensor:
    W, H = cam.width, cam.height
    n, f = cam.znear, cam.zfar
    left = n / cam.fx * (((2 * cam.cx - W) / W - 1.0) * W / 2.0)
    right = n / cam.fx * (((2 * cam.cx - W) / W + 1.0) * W / 2.0)
    top = n / cam.fy * (((2 * cam.cy - H) / H + 1.0) * H / 2.0)
    bottom = n / cam.fy * (((2 * cam.cy - H) / H - 1.0) * H / 2.0)
    P = torch.zeros(4, 4, dtype=torch.float32)
    P[0, 0] = 2.0 * n / (right - left)
    P[1, 1] = 2.0 * n / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = f / (f - n)
    P[2, 3] = -(f * n) / (f - n)
    return P.to(device)


def to_int32(x):
    x = torch.nan_to_num(x, nan=0.0, posinf=2147483520.0,
                         neginf=-2147483648.0)
    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def project(scene: dict, cam: Cam, low_pass: float = 0.3,
            tau: Optional[torch.Tensor] = None) -> dict:
    """Per-Gaussian screen quantities of ``scene`` (raw parameters: xyz,
    features_dc, scaling (log), rotation (quaternion), opacity (logit),
    active) seen from ``cam`` moved by Exp(tau). Differentiable in the
    parameters and tau."""
    xyz = scene["xyz"]
    dev = xyz.device
    w2c = pose_matrix(cam.R, cam.t)
    if tau is not None:
        w2c = se3_exp(tau) @ w2c
    R, t = w2c[:3, :3], w2c[:3, 3]
    p_view = xyz @ R.T + t
    depth = p_view[:, 2]
    proj = projection_matrix(cam, dev)
    ph = p_view @ proj[:3, :3].T + proj[:3, 3]
    p_w = 1.0 / (p_view @ proj[3, :3] + proj[3, 3] + 1e-7)
    W, H = cam.width, cam.height
    mean2d = torch.stack([((ph[:, 0] * p_w + 1.0) * W - 1.0) * 0.5,
                          ((ph[:, 1] * p_w + 1.0) * H - 1.0) * 0.5], -1)

    # 3D covariance R S^2 R^T, then the EWA 2D covariance
    Rq = quat_to_rotmat(scene["rotation"])
    M = Rq * torch.exp(scene["scaling"])[:, None, :]
    V = M @ M.transpose(-1, -2)
    tanx, tany = W / (2.0 * cam.fx), H / (2.0 * cam.fy)
    tx, ty, tz = p_view[:, 0], p_view[:, 1], p_view[:, 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-8, torch.full_like(tz, 1e-8),
                          tz)
    limx, limy = 1.3 * tanx, 1.3 * tany
    rx, ry = tx / tz_safe, ty / tz_safe
    tx_c = (torch.clamp(rx, -limx, limx) * tz).detach()
    ty_c = (torch.clamp(ry, -limy, limy) * tz).detach()
    tx = torch.where((rx < -limx) | (rx > limx), tx_c, tx)
    ty = torch.where((ry < -limy) | (ry > limy), ty_c, ty)
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    J00, J02 = cam.fx * inv_z, -cam.fx * tx * inv_z2
    J11, J12 = cam.fy * inv_z, -cam.fy * ty * inv_z2
    T0 = J00[:, None] * R[0] + J02[:, None] * R[2]
    T1 = J11[:, None] * R[1] + J12[:, None] * R[2]
    VT0 = torch.einsum("nij,nj->ni", V, T0)
    VT1 = torch.einsum("nij,nj->ni", V, T1)
    a = torch.sum(T0 * VT0, -1) + low_pass
    b = torch.sum(T0 * VT1, -1)
    c = torch.sum(T1 * VT1, -1) + low_pass
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)

    ad, cd = a.detach(), c.detach()
    mid = 0.5 * (ad + cd)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det.detach(), min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    opacity = torch.sigmoid(scene["opacity"][:, 0])
    q = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * opacity.detach(),
                                                 min=1e-12)), min=0.0)
    half_x = torch.minimum(radius, torch.ceil(torch.sqrt(
        q * torch.clamp(ad, min=0.0))))
    half_y = torch.minimum(radius, torch.ceil(torch.sqrt(
        q * torch.clamp(cd, min=0.0))))
    gx, gy = -(-W // CELL), -(-H // CELL)
    mx, my = mean2d[:, 0].detach(), mean2d[:, 1].detach()
    rect_min = torch.stack([
        torch.clamp(to_int32((mx - half_x) / CELL), 0, gx),
        torch.clamp(to_int32((my - half_y) / CELL), 0, gy)], -1)
    rect_max = torch.stack([
        torch.clamp(to_int32((mx + half_x + CELL - 1) / CELL), 0, gx),
        torch.clamp(to_int32((my + half_y + CELL - 1) / CELL), 0, gy)], -1)
    tiles = ((rect_max[:, 0] - rect_min[:, 0])
             * (rect_max[:, 1] - rect_min[:, 1]))
    valid = ((depth > 0.2) & det_ok & (q > 0.0) & (tiles > 0)
             & scene["active"])
    color = torch.clamp(SH_C0 * scene["features_dc"][:, 0, :] + 0.5,
                        min=0.0)
    return dict(mean2d=mean2d, conic=conic, opacity=opacity, color=color,
                depth=depth, rect_min=rect_min, rect_max=rect_max,
                valid=valid)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def depth_key_bits(width: int, height: int) -> int:
    """Depth bits the binning key keeps at this image size."""
    n_tiles = -(-width // KEY_TILE) * -(-height // KEY_TILE)
    return 31 - int(n_tiles).bit_length()


def bin_cells(prep: dict, width: int, height: int):
    """(gid of each pair in cell order, cell start, cell count): the pairs
    of every 16-px cell, front to back."""
    dev = prep["depth"].device
    gx, gy = -(-width // CELL), -(-height // CELL)
    rmin, rmax = prep["rect_min"].long(), prep["rect_max"].long()
    w = rmax[:, 0] - rmin[:, 0]
    counts = torch.where(prep["valid"], w * (rmax[:, 1] - rmin[:, 1]),
                         torch.zeros_like(w))
    gid = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                  counts)
    first = torch.cumsum(counts, 0) - counts
    local = torch.arange(gid.numel(), device=dev) - first[gid]
    wg = w[gid]
    cell = ((rmin[gid, 1] + local // wg) * gx + rmin[gid, 0] + local % wg)
    d_bits = depth_key_bits(width, height)
    qd = (prep["depth"].detach()[gid].contiguous().view(torch.int32)
          >> (31 - d_bits)).long()
    order = torch.sort((cell << 31) | qd, stable=True).indices
    n_cells = gx * gy
    cell_count = torch.bincount(cell, minlength=n_cells)
    cell_start = torch.cumsum(cell_count, 0) - cell_count
    return gid[order], cell_start, cell_count


# ---------------------------------------------------------------------------
# Compositing over pair lists
# ---------------------------------------------------------------------------

def _falloff(f, px, py, bf16: bool):
    """(power, alpha) of pair rows ``f`` (n, k, >= 6) at pixels (n, 1, P).
    Under ``bf16`` the deltas, conic and opacity are rounded to bfloat16
    and the falloff is computed in bfloat16 (the precision control)."""
    mx, my = f[..., 0:1], f[..., 1:2]
    ca, cb, cc, opa = f[..., 2:3], f[..., 3:4], f[..., 4:5], f[..., 5:6]
    dx, dy = mx - px, my - py
    if bf16:
        b = torch.bfloat16
        dx, dy = dx.to(b), dy.to(b)
        power = (-0.5 * (ca.to(b) * dx * dx + cc.to(b) * dy * dy)
                 - cb.to(b) * dx * dy)
        power = torch.clamp(power, max=0.0)
        a_un = (opa.to(b) * torch.exp(power)).float()
        return power.float(), torch.clamp(a_un, max=ALPHA_MAX)
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    return power, torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)


@dataclasses.dataclass
class Lists:
    """Pair lists over square pixel tiles: list l walks rows
    ``rows[start[l] : start[l] + count[l]]`` (each row: mean x, y, conic
    a, b, c, opacity, r, g, b, depth[, rect16 x0, y0, x1, y1]) over the
    tile x ``tile`` pixels whose top-left is (ox[l], oy[l])."""

    rows: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor
    tile: int
    width: int
    height: int
    rect_test: bool = False


def cell_lists(rows: torch.Tensor, cell_start, cell_count, width: int,
               height: int) -> Lists:
    gx = -(-width // CELL)
    ids = torch.arange(cell_count.numel(), device=rows.device)
    return Lists(rows=rows, start=cell_start, count=cell_count,
                 ox=(ids % gx) * CELL, oy=(ids // gx) * CELL, tile=CELL,
                 width=width, height=height)


def tile_lists(feat: torch.Tensor, ranges: torch.Tensor, n_tx: int,
               width: int, height: int, tile: int = 32) -> Lists:
    """The lists of a compositing call of the program: pair rows ``feat``
    and per-tile [start, end) ``ranges`` on an n_tx-wide grid of
    ``tile``-px tiles, with the per-pixel rect16 test."""
    ids = torch.arange(ranges.shape[0], device=feat.device)
    return Lists(rows=feat, start=ranges[:, 0].long(),
                 count=(ranges[:, 1] - ranges[:, 0]).long(),
                 ox=(ids % n_tx) * tile, oy=(ids // n_tx) * tile, tile=tile,
                 width=width, height=height, rect_test=True)


def walk(lists: Lists, bf16: bool = False, budget: int = 1 << 23,
         chunk_fn: Optional[Callable] = None, need_image: bool = True):
    """Composite every list front to back. Returns dict(color (3, H, W),
    depth (H, W), T (H, W)) (sums before the background) and the counts
    ``passed`` (pair-pixel cells that pass the skip tests while their pixel
    is not done: the blended ones and each pixel's terminating one) and
    ``included`` (the blended ones).

    With ``chunk_fn`` the rows may require grad: after each chunk of lists
    ``chunk_fn(color (n, 3, P), depth (n, P), T (n, P), pix (n, P) linear
    pixel index or -1)`` returns a scalar whose gradient is taken at once
    (so one chunk's graph is alive at a time), and the images are not
    assembled."""
    rows = lists.rows
    dev = rows.device
    tile, W, H = lists.tile, lists.width, lists.height
    P = tile * tile
    n_lists = lists.count.numel()
    q = torch.arange(P, device=dev)
    k_ar = torch.arange(BLOCK, device=dev)
    order = torch.argsort(lists.count, descending=True)
    counts_sorted = lists.count[order].tolist()
    nc = max(1, budget // (BLOCK * P))
    if need_image and chunk_fn is None:
        img = torch.zeros(5, H * W, dtype=torch.float32, device=dev)
        img[4] = 1.0
    passed = torch.zeros((), dtype=torch.long, device=dev)
    included = torch.zeros((), dtype=torch.long, device=dev)
    total = None
    n_rows = rows.shape[0]
    for c0 in range(0, n_lists, nc):
        sel = order[c0:c0 + nc]
        L = counts_sorted[c0]
        n = sel.numel()
        xi = lists.ox[sel][:, None] + (q % tile)[None]
        yi = lists.oy[sel][:, None] + (q // tile)[None]
        pix_in = (xi < W) & (yi < H)
        pix = torch.where(pix_in, yi * W + xi, torch.full_like(xi, -1))
        px = xi.to(torch.float32)[:, None, :]
        py = yi.to(torch.float32)[:, None, :]
        if lists.rect_test:
            cx = torch.floor(px / 16.0)
            cy = torch.floor(py / 16.0)
        T = torch.ones(n, P, dtype=torch.float32, device=dev)
        done = ~pix_in
        acc = torch.zeros(n, 4, P, dtype=torch.float32, device=dev)
        start, cnt = lists.start[sel], lists.count[sel]
        for j0 in range(0, L, BLOCK):
            if bool(done.all()):
                break
            j = j0 + k_ar
            row_ok = j[None] < cnt[:, None]                       # (n, k)
            idx = torch.clamp(start[:, None] + j[None], 0, max(n_rows - 1,
                                                                0))
            f = rows[idx]                                         # (n, k, R)
            power, alpha = _falloff(f, px, py, bf16)              # (n, k, P)
            ok = row_ok[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
            if lists.rect_test:
                ok = ok & ((cx >= f[..., 10:11]) & (cx < f[..., 12:13])
                           & (cy >= f[..., 11:12]) & (cy < f[..., 13:14]))
            live = ok & ~done[:, None, :]
            one_minus = torch.where(live, 1.0 - alpha,
                                    torch.ones_like(alpha))
            cp = torch.cumprod(one_minus, dim=1)
            T_incl = T[:, None, :] * cp
            term = live & (T_incl < T_EPS)
            n_term = torch.cumsum(term.to(torch.int32), dim=1)
            inc = live & (n_term == 0)
            passed = passed + (live & ((n_term - term.to(torch.int32))
                                       == 0)).sum()
            included = included + inc.sum()
            T_excl = T[:, None, :] * torch.cat(
                [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
            w = torch.where(inc, alpha * T_excl, torch.zeros_like(alpha))
            acc = acc + torch.einsum("nkp,nkc->ncp", w, f[..., 6:10])
            T = T * torch.prod(torch.where(inc, 1.0 - alpha,
                                           torch.ones_like(alpha)), dim=1)
            done = done | term.any(dim=1)
        if chunk_fn is not None:
            part = chunk_fn(acc[:, :3], acc[:, 3], T, pix)
            part.backward()
            total = part.detach() if total is None else total + part.detach()
        elif need_image:
            m = pix >= 0
            flat = pix[m]
            img[:4, flat] = acc.permute(1, 0, 2)[:, m]
            img[4, flat] = T[m]
    out = dict(passed=int(passed), included=int(included))
    if chunk_fn is not None:
        out["loss"] = total
    elif need_image:
        img = img.reshape(5, H, W)
        out.update(color=img[:3], depth=img[3], T=img[4])
    return out


def pair_rows(prep: dict, gid: torch.Tensor) -> torch.Tensor:
    """The (M, 10) rows of the pairs ``gid`` (cell order)."""
    tab = torch.cat([prep["mean2d"], prep["conic"], prep["opacity"][:, None],
                     prep["color"], prep["depth"][:, None]], dim=-1)
    return tab[gid]


@torch.no_grad()
def render(scene: dict, cam: Cam, bg: Optional[torch.Tensor] = None,
           low_pass: float = 0.3, bf16: bool = False) -> dict:
    """color (3, H, W) with the background, depth (1, H, W), opacity
    (1, H, W)."""
    prep = project(scene, cam, low_pass)
    gid, start, count = bin_cells(prep, cam.width, cam.height)
    out = walk(cell_lists(pair_rows(prep, gid), start, count, cam.width,
                          cam.height), bf16=bf16)
    color = out["color"]
    if bg is not None:
        color = color + out["T"][None] * bg[:, None, None]
    return dict(color=color, depth=out["depth"][None],
                opacity=(1.0 - out["T"])[None])


def render_grad(scene: dict, cam: Cam, pixel_loss: Callable,
                low_pass: float = 0.3, tau=None, bf16: bool = False,
                budget: int = 1 << 21):
    """Differentiate a per-pixel loss of the render of ``scene`` (whose
    parameters may require grad) from ``cam`` moved by Exp(tau).
    ``pixel_loss(color (n, 3, P), depth (n, P), T (n, P), pix (n, P))``
    returns the loss of one chunk of pixels (pix is the linear pixel index
    or -1 outside the image); the chunks' losses add up to the loss.
    Gradients accumulate in ``.grad`` of every leaf that requires grad.
    Returns the loss."""
    prep = project(scene, cam, low_pass, tau)
    gid, start, count = bin_cells(prep, cam.width, cam.height)
    rows = pair_rows(prep, gid)
    # the chunks differentiate into a leaf copy of the pair rows; one
    # backward then carries the rows' gradient through the gather and the
    # projection
    leaf = rows.detach().requires_grad_()
    out = walk(cell_lists(leaf, start, count, cam.width, cam.height),
               bf16=bf16, budget=budget, chunk_fn=pixel_loss)
    if leaf.grad is not None and rows.requires_grad:
        rows.backward(leaf.grad)
    loss = out.get("loss")
    return loss if loss is not None else torch.zeros((), device=gid.device)


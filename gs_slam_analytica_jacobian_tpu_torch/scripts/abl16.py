"""Ablation microbench of the 16x16 forward kernel's per-chunk cost (the
port of scripts/abl16.py; its kernel is ``csrc/abl16.cu``).

B3's forward chunk body, stripped stage by stage, on a synthetic plan
with the same number of pairs in every 16x16 tile, to see which class of
operation costs what. Variants (the script's, abl16.py:56-62): full,
noexp, noscan, nomxu, notrans, minimal, dyn, prodbody (see
``csrc/abl16.cu``).

    python -m gs_slam_analytica_jacobian_tpu_torch.scripts.abl16 [variant ...]

prints, per variant, the kernel's time (CUDA events, median of 7 after 2
warm-up calls) and microseconds per chunk at the script's shape: 1216x704
(38 x 22 groups of 32x32, 3344 16-px tiles), ``NC`` chunks of 128 pairs
per tile (environment, default 2), features uniform in [0.2, 0.8) from
seed 0. It needs a GPU. ``time_turns`` times a variant in turns against
the first port's design (``design="group"``), as chip_smoke.py does.

``run`` is the wrapper: on a CUDA tensor it launches the variant's kernel,
one CTA per 16x16 subtile (C entry ``abl16_<variant>``, counted in
``run.launches[variant]``), or under ``design="group"`` the yardstick
kept from the first port, one CTA per 32x32 group (C entry
``abl16_<variant>_group``, counted in ``run.launches_group[variant]``);
the two give the same output bit for bit. On a CPU tensor it runs the
plain PyTorch version ``run_plain`` under either design. Nothing here
imports JAX.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

from ..ops import _build

F = 16            # features per pair row
K = 128           # pairs per chunk
PS = 256          # pixels per 16x16 subtile
NS = 4            # subtiles per 32x32 group
VARIANTS = ("full", "noexp", "noscan", "nomxu", "notrans", "minimal", "dyn",
            "prodbody")
# the kernel's designs: one CTA per 16x16 subtile (in use), one CTA per
# 32x32 group (the first port's, a yardstick)
DESIGNS = ("subtile", "group")
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# FP32 operations a walked (pair, pixel) cell costs in csrc/abl16.cu:
# deltas 2, quadratic form 9, opa exp(power) 5 (opa (1 + power) 2), cap
# and tests 4, prefix product 4 (one step 2), weight 1, T min 1, the four
# fused multiply-adds 8 (the plain sum 1); prodbody adds the rect test 4,
# the row test 1, the done test 1 and the stop 1
OPS_PER_CELL = {"full": 34, "noexp": 31, "noscan": 32, "nomxu": 27,
                "notrans": 34, "minimal": 22, "dyn": 34, "prodbody": 41}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor FP32, at 700 W


def flags(variant: str) -> dict:
    """The script's stage switches (abl16.py:56-61)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return dict(exp=variant not in ("noexp", "minimal"),
                scan=variant not in ("noscan", "minimal"),
                mxu=variant not in ("nomxu", "minimal"),
                trans=variant not in ("notrans", "minimal"),
                dyn=variant in ("dyn", "prodbody"),
                prod=variant == "prodbody")


def make_inputs(n_gx: int, n_gy: int, nc: int, seed: int = 0, device=None):
    """The script's synthetic plan: NC chunks of K pairs for each of the
    4 n_gx n_gy 16-px tiles, features uniform in [0.2, 0.8). Returns
    (feat (16, B) f32, ranges (n_tiles, 2) int32)."""
    n_tiles = 4 * n_gx * n_gy
    rng = np.random.default_rng(seed)
    B = n_tiles * nc * K
    feat = rng.uniform(0.2, 0.8, (F, B)).astype(np.float32)
    r = np.zeros((n_tiles, 2), np.int32)
    r[:, 0] = np.arange(n_tiles) * nc * K
    r[:, 1] = r[:, 0] + nc * K
    return (torch.as_tensor(feat, device=device),
            torch.as_tensor(r, device=device))


def make_admitting_inputs(n_gx: int, n_gy: int, nc: int, seed: int = 1,
                          device=None):
    """A plan on which every stage of prodbody acts (the script's own
    admits no cell there: its rect16 columns lie in [0.2, 0.8)): rect16
    columns that admit every cell, means on the groups' pixels, positive
    definite conics, opacities in [0.3, 0.95) and ragged ranges of 0 to
    nc*K pairs per tile (tile 0 empty, tile 1 full, tile 2 37 pairs)."""
    rng = np.random.default_rng(seed)
    n_tiles = 4 * n_gx * n_gy
    B = n_tiles * nc * K
    w, h = 32 * n_gx, 32 * n_gy
    f = rng.uniform(0.2, 0.8, (F, B)).astype(np.float32)
    f[0] = rng.uniform(-4.0, w + 4.0, B)
    f[1] = rng.uniform(-4.0, h + 4.0, B)
    f[2] = rng.uniform(0.02, 0.6, B)
    f[3] = rng.uniform(-0.01, 0.01, B)
    f[4] = rng.uniform(0.02, 0.6, B)
    f[5] = rng.uniform(0.3, 0.95, B)
    f[10], f[11], f[12], f[13] = 0.0, 0.0, 1e3, 1e3
    r = np.zeros((n_tiles, 2), np.int32)
    r[:, 0] = np.arange(n_tiles) * nc * K
    n = rng.integers(0, nc * K + 1, n_tiles)
    n[0], n[1], n[2] = 0, nc * K, 37
    r[:, 1] = r[:, 0] + n
    return (torch.as_tensor(f, device=device),
            torch.as_tensor(r, device=device))


def chunks_walked(ranges: torch.Tensor, n_gx: int, n_gy: int, nc: int,
                  variant: str) -> int:
    """The chunks the variant walks on this plan (every subtile walks nc,
    or under dyn and prodbody its own ceil(n / K))."""
    if flags(variant)["dyn"]:
        n = (ranges[:, 1] - ranges[:, 0]).long()
        return int(((n + K - 1) // K).sum())
    return 4 * n_gx * n_gy * nc


def bound_ms(ranges, n_gx, n_gy, nc, variant) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes this
    input needs moved (each walked pair row read once, 64 B, or one float
    a chunk under notrans; ranges; the output) over the HBM rate and the
    walked cells' FP32 operations over the FP32 peak (H100 SXM)."""
    chunks = chunks_walked(ranges, n_gx, n_gy, nc, variant)
    row_bytes = K * F * 4 if flags(variant)["trans"] else 4
    n_bytes = chunks * row_bytes + ranges.numel() * 4 + 4 * n_gx * n_gy * \
        NS * PS * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = chunks * K * PS * OPS_PER_CELL[variant] / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def run_plain(feat: torch.Tensor, ranges: torch.Tensor, n_gx: int,
              n_gy: int, W: int, H: int, nc: int, variant: str
              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): (n_gy, n_gx, 4,
    256) row sums sum_c acc_c + T_final per subtile pixel, vectorized over
    groups and pixels, chunk by chunk; the prefix product is a cumprod
    over the chunk."""
    fl = flags(variant)
    dev = feat.device
    f32 = torch.float32
    B = feat.shape[1]
    G = n_gx * n_gy
    g = torch.arange(G, device=dev)
    gy, gx = g // n_gx, g % n_gx
    q = torch.arange(PS, device=dev)
    k_ar = torch.arange(K, device=dev)
    out = torch.zeros(G, NS, PS, dtype=f32, device=dev)
    for j in range(NS):
        t16 = (2 * gy + j // 2) * (2 * n_gx) + (2 * gx + j % 2)
        start = ranges[t16, 0].long()
        n_live = (ranges[t16, 1] - ranges[t16, 0]).long()
        ncs = ((n_live + K - 1) // K if fl["dyn"]
               else torch.full_like(n_live, nc))
        if fl["prod"]:
            xi = (gx * 32 + (j % 2) * 16)[:, None] + (q % 16)[None]
            yi = (gy * 32 + (j // 2) * 16)[:, None] + (q // 16)[None]
            px, py = xi.to(f32), yi.to(f32)
            done = ~((xi < W) & (yi < H))                      # (G, P)
            t16x, t16y = torch.floor(px / 16.0), torch.floor(py / 16.0)
            px, py = px[:, None], py[:, None]
        else:
            px = (q % 16).to(f32)[None, None]
            py = (q // 16).to(f32)[None, None]
            done = torch.zeros(G, PS, dtype=torch.bool, device=dev)
        T = torch.ones(G, PS, dtype=f32, device=dev)
        acc = torch.zeros(G, 4 if fl["mxu"] else 1, PS, dtype=f32,
                          device=dev)
        for c in range(int(ncs.max()) if G else 0):
            run_c = (c < ncs)[:, None]                         # (G, 1)
            idx = start[:, None] + c * K + k_ar[None]          # (G, K)
            if fl["trans"]:
                rows = torch.where((idx < B)[..., None],
                                   feat[:, idx.clamp(max=B - 1)].permute(
                                       1, 2, 0), torch.zeros((), device=dev))
            else:
                b0 = start + c * K
                v = torch.where(b0 < B, feat[0, b0.clamp(max=B - 1)],
                                torch.zeros((), device=dev))
                rows = (0.5 + v)[:, None, None].expand(G, K, F)
            mx, my = rows[..., 0:1], rows[..., 1:2]
            ca, cb, cc = rows[..., 2:3], rows[..., 3:4], rows[..., 4:5]
            opa = rows[..., 5:6]
            dx, dy = mx - px, my - py                          # (G, K, P)
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            a_un = opa * (torch.exp(power) if fl["exp"] else 1.0 + power)
            alpha = torch.clamp(a_un, max=ALPHA_MAX)
            ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
            if fl["prod"]:
                rect = ((t16x[:, None] >= rows[..., 10:11])
                        & (t16x[:, None] < rows[..., 12:13])
                        & (t16y[:, None] >= rows[..., 11:12])
                        & (t16y[:, None] < rows[..., 13:14]))
                row_ok = (k_ar[None] < (n_live - c * K)[:, None])[..., None]
                ok = ok & rect & row_ok & ~done[:, None]
            a_eff = torch.where(ok, alpha, torch.zeros_like(alpha))
            T0 = T[:, None]
            if fl["scan"]:
                cum = torch.cumprod(1.0 - a_eff, dim=1)
                T_incl = T0 * cum
                T_excl = T0 * torch.cat([torch.ones_like(cum[:, :1]),
                                         cum[:, :-1]], dim=1)
            else:
                T_excl = T0 * (1.0 - a_eff)
                T_incl = T_excl
            if fl["prod"]:
                term = T_incl < T_EPS
                inc = ok & ~term
                w = torch.where(inc, alpha, torch.zeros_like(alpha)) * T_excl
                new_T = torch.minimum(T, torch.where(
                    inc, T_incl, torch.full_like(T_incl, 2.0)).amin(dim=1))
                done = torch.where(run_c, done | (ok & term).any(dim=1), done)
            else:
                w = a_eff * T_excl
                new_T = torch.minimum(T, T_incl.amin(dim=1))
            if fl["mxu"]:
                d_acc = torch.einsum("gkc,gkp->gcp", rows[..., 6:10], w)
            else:
                d_acc = w.sum(dim=1, keepdim=True) + rows[:, 0, 6][:, None,
                                                                   None]
            acc = torch.where(run_c[..., None], acc + d_acc, acc)
            T = torch.where(run_c, new_T, T)
        out[:, j] = acc.sum(dim=1) + T
    return out.reshape(n_gy, n_gx, NS, PS)


def _check(feat, ranges, n_gx, n_gy):
    if feat.dtype != torch.float32 or feat.dim() != 2 or feat.shape[0] != F:
        raise ValueError(f"feat must be ({F}, B) float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    if ranges.dtype != torch.int32 or \
            tuple(ranges.shape) != (4 * n_gx * n_gy, 2):
        raise ValueError(f"ranges must be ({4 * n_gx * n_gy}, 2) int32, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    if ranges.device != feat.device or feat.device.type not in ("cpu",
                                                                "cuda"):
        raise ValueError("feat and ranges must lie on one CPU or CUDA device")
    if not (feat.is_contiguous() and ranges.is_contiguous()):
        raise ValueError("feat and ranges must be contiguous")


def run(feat: torch.Tensor, ranges: torch.Tensor, n_gx: int, n_gy: int,
        W: int, H: int, nc: int, variant: str,
        design: str = "subtile") -> torch.Tensor:
    """The variant's chunk body over the n_gx x n_gy groups: (n_gy, n_gx,
    4, 256) f32 row sums. CUDA tensors launch ``csrc/abl16.cu``'s kernel
    of ``design`` (``DESIGNS``); CPU tensors take ``run_plain``."""
    flags(variant)
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}")
    _check(feat, ranges, n_gx, n_gy)
    if feat.device.type == "cpu":
        return run_plain(feat, ranges, n_gx, n_gy, W, H, nc, variant)
    name = f"abl16_{variant}" + ("_group" if design == "group" else "")
    out = torch.empty(n_gy, n_gx, NS, PS, dtype=torch.float32,
                      device=feat.device)
    fn = _build.entry("abl16", name)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(ctypes.c_void_p(feat.data_ptr()),
                 ctypes.c_void_p(ranges.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), n_gx, n_gy, W, H, nc,
                 feat.shape[1], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counts = run.launches_group if design == "group" else run.launches
    counts[variant] += 1
    return out


run.launches = {v: 0 for v in VARIANTS}
run.launches_group = {v: 0 for v in VARIANTS}


def time_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def time_turns(feat, ranges, n_gx, n_gy, W, H, nc, variant) -> dict:
    """The variant's time against the group design's in turns (group,
    subtile, subtile, group; ``time_ms`` each): ms and group_ms, the means
    of each design's two turns, and the four turns."""
    def once(design):
        return time_ms(lambda: run(feat, ranges, n_gx, n_gy, W, H, nc,
                                   variant, design=design))
    turns = [once(d) for d in ("group", "subtile", "subtile", "group")]
    return dict(ms=(turns[1] + turns[2]) / 2,
                group_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)


SHAPE = dict(W=1216, H=704, n_gx=38, n_gy=22)   # the script's 836 groups


def main(argv=None) -> int:
    variants = (sys.argv[1:] if argv is None else argv) or ["full", "dyn"]
    if not torch.cuda.is_available():
        print("abl16: needs a GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    W, H, n_gx, n_gy = (SHAPE[k] for k in ("W", "H", "n_gx", "n_gy"))
    n_tiles = 4 * n_gx * n_gy
    nc = int(os.environ.get("NC", "2"))
    feat, ranges = make_inputs(n_gx, n_gy, nc, device=dev)
    print(f"{torch.cuda.get_device_name(0)}: tiles={n_tiles} "
          f"chunks={n_tiles * nc} cells={n_tiles * nc * K * PS / 1e6:.0f}M",
          flush=True)
    for v in variants:
        ms = time_ms(lambda: run(feat, ranges, n_gx, n_gy, W, H, nc, v))
        per_chunk = ms * 1e3 / (n_tiles * nc)
        bnd, by = bound_ms(ranges, n_gx, n_gy, nc, v)
        print(f"{v:10s} {ms:8.3f} ms   {per_chunk:6.3f} us/chunk   bound "
              f"{bnd:.3f} ms ({by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

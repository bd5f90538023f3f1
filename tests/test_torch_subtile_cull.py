"""The sub-tile compositing kernels' conservative block test
(``ops/tile_kernel2.py::block_keep_plain``, the plain version of
``csrc/subtile_cull.cuh::block_keep``, same f32 operations) and the walk
restricted to the cells it keeps.

The test may drop a (pair, 8x4 pixel block) only where the pair is
skipped at every pixel of the block, so:

- no (pair, pixel) cell that passes the skip tests (rect16, power <= 0,
  alpha >= 1/255 as the f32 arithmetic computes it) lies in a dropped
  (pair, block), on seeded rows, on rows built to sit at alpha = 1/255 to
  a few ulps, on huge and needle-thin conics and on scenes and a room-map
  plan whose W, H are not multiples of 32;
- non-PD conics and rows with a NaN or inf are never dropped;
- ``plain_walk(cull=True)`` and ``plain_bwd_walk(cull=True)`` give the
  unculled walks' images, n_touched, passed cells and rows exactly.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
``cuda`` marker)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import camera_math as cm
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map

torch.set_num_threads(1)

F32 = torch.float32
BX = torch.arange(ttk.BLOCK_W, dtype=F32)
BY = torch.arange(ttk.BLOCK_H, dtype=F32)


def _rows(mx, my, ca, cb, cc, opa):
    """Pair rows (n, 16) with the given falloff fields (rect, color 0)."""
    cols = [torch.as_tensor(np.asarray(v, np.float32)).reshape(-1)
            for v in (mx, my, ca, cb, cc, opa)]
    n = max(c.numel() for c in cols)
    f = torch.zeros(n, 16, dtype=F32)
    for i, c in enumerate(cols):
        f[:, i] = c.expand(n)
    return f


def _passes_somewhere(f, xb, yb):
    """Whether each row of f passes the per-pixel skip tests (power <= 0,
    alpha >= 1/255, the kernels' f32 arithmetic) at some pixel of the 8x4
    block at (xb, yb): (n,) bool."""
    px = (xb[:, None, None] + BX[None, None, :]).to(F32)
    py = (yb[:, None, None] + BY[None, :, None]).to(F32)
    g = f[:, :, None, None]
    dx = g[:, 0] - px
    dy = g[:, 1] - py
    power, a_un = ttk._falloff(g[:, 2], g[:, 3], g[:, 4], g[:, 5], dx, dy,
                               False)
    alpha = torch.clamp(a_un, max=ttk.ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ttk.ALPHA_MIN)
    return ok.flatten(1).any(dim=1)


def _assert_conservative(f, xb, yb):
    keep = ttk.block_keep_plain(f, xb, yb)
    bad = _passes_somewhere(f, xb, yb) & ~keep
    assert not bool(bad.any()), f[bad][:4]
    return keep


def _random_rows(rng, n):
    """Seeded rows around a block at the origin: means within +-40 px,
    conics from covariances with eigenvalues 0.3-400 px^2 at any angle,
    opacities 1e-3-1."""
    lam = np.exp(rng.uniform(np.log(0.3), np.log(400.0), size=(n, 2)))
    th = rng.uniform(0, np.pi, size=n)
    c, s = np.cos(th), np.sin(th)
    cxx = lam[:, 0] * c * c + lam[:, 1] * s * s
    cyy = lam[:, 0] * s * s + lam[:, 1] * c * c
    cxy = (lam[:, 0] - lam[:, 1]) * c * s
    det = cxx * cyy - cxy * cxy
    return _rows(rng.uniform(-40, 48, n), rng.uniform(-40, 44, n),
                 cyy / det, -cxy / det, cxx / det,
                 np.exp(rng.uniform(np.log(1e-3), 0.0, n)))


def test_block_keep_is_conservative_on_seeded_rows():
    rng = np.random.default_rng(0)
    f = _random_rows(rng, 20000)
    xb = torch.as_tensor(rng.integers(0, 9, 20000) * 1.0, dtype=F32)
    yb = torch.as_tensor(rng.integers(0, 5, 20000) * 1.0, dtype=F32)
    keep = _assert_conservative(f, xb, yb)
    # the test is not vacuous: it drops most of these rows
    assert 0.3 < float((~keep).float().mean()) < 0.99


def _threshold_rows(ulps):
    """Rows whose alpha at the block's pixel (3, 2) is 1/255 moved by
    ``ulps`` f32 ulps of the opacity (computed with the kernels' f32
    arithmetic): conics of several shapes and sizes, means inside and
    around the block."""
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(400):
        f = _random_rows(rng, 1)
        f[:, 0:2] = torch.as_tensor(rng.uniform(-12.0, 16.0, 2), dtype=F32)
        dx = f[:, 0] - 3.0
        dy = f[:, 1] - 2.0
        power, _ = ttk._falloff(f[:, 2], f[:, 3], f[:, 4], f[:, 5], dx, dy,
                                False)
        if float(power) < -5.0:
            continue
        # the least opacity whose alpha reaches 1/255 at the pixel
        opa = torch.tensor(ttk.ALPHA_MIN, dtype=F32) / torch.exp(power)
        for _ in range(64):
            if float(opa * torch.exp(power)) >= ttk.ALPHA_MIN:
                break
            opa = torch.nextafter(opa, torch.tensor(2.0))
        for _ in range(abs(ulps)):
            opa = torch.nextafter(opa, torch.tensor(2.0 if ulps > 0
                                                    else 0.0))
        f[:, 5] = opa
        rows.append(f)
    return torch.cat(rows)


@pytest.mark.parametrize("ulps", [0, 1, 3, -1, -3])
def test_block_keep_at_the_alpha_threshold(ulps):
    """Pixels at alpha = 1/255 to a few ulps: every row that still passes
    at the pixel is kept."""
    f = _threshold_rows(ulps)
    zero = torch.zeros(f.shape[0], dtype=F32)
    keep = _assert_conservative(f, zero, zero)
    if ulps >= 0:
        assert bool(keep.all())


def test_block_keep_opacity_just_above_the_threshold():
    """opa a few ulps either side of 1/255 with the mean inside the block:
    above, alpha reaches 1/255 at the mean's pixel and the row is kept;
    well below (0.99 of it), the row is dropped everywhere."""
    a = torch.tensor(ttk.ALPHA_MIN, dtype=F32)
    up = [a]
    for _ in range(4):
        up.append(torch.nextafter(up[-1], torch.tensor(1.0)))
    f = _rows(3.0, 2.0, 0.5, 0.1, 0.4, torch.stack(up).numpy())
    zero = torch.zeros(f.shape[0], dtype=F32)
    assert bool(_assert_conservative(f, zero, zero).all())
    f = _rows(3.0, 2.0, 0.5, 0.1, 0.4, 0.99 * ttk.ALPHA_MIN)
    assert not bool(ttk.block_keep_plain(f, zero[:1], zero[:1]).any())


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.floats(-200.0, 200.0, width=32), st.floats(-200.0, 200.0, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(-1.0 + 2.0 ** -11, 1.0 - 2.0 ** -11, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(2.0 ** -10, 1.0, width=32))
def test_block_keep_conservative_hypothesis(mx, my, ca, rho, cc, opa):
    """Any PD conic from needle-thin (eigenvalues apart by 1e9) to huge,
    any mean and opacity: conservative."""
    cb = rho * float(np.sqrt(np.float32(ca) * np.float32(cc)))
    f = _rows(mx, my, ca, cb, cc, opa)
    zero = torch.zeros(1, dtype=F32)
    _assert_conservative(f, zero, zero)


def test_block_keep_never_drops_non_pd_or_non_finite():
    nan, inf = float("nan"), float("inf")
    far = 500.0  # far from the block: a PD row there would be dropped
    rows = [
        (far, far, -1.0, 0.0, 1.0, 0.5),    # ca < 0
        (far, far, 1.0, 0.0, 0.0, 0.5),     # cc = 0
        (far, far, 1.0, 1.0, 1.0, 0.5),     # det = 0
        (far, far, 1.0, 2.0, 1.0, 0.5),     # det < 0
        (nan, far, 1.0, 0.0, 1.0, 0.5),
        (far, inf, 1.0, 0.0, 1.0, 0.5),
        (far, far, nan, 0.0, 1.0, 0.5),
        (far, far, 1.0, inf, 1.0, 0.5),
        (far, far, 1.0, 0.0, 1.0, nan),
        (far, far, 1.0, 0.0, 1.0, inf),
    ]
    f = _rows(*zip(*rows))
    zero = torch.zeros(f.shape[0], dtype=F32)
    assert bool(ttk.block_keep_plain(f, zero, zero).all())
    # the same rows made PD and finite are dropped
    g = _rows(far, far, 1.0, 0.0, 1.0, 0.5)
    assert not bool(ttk.block_keep_plain(g, zero[:1], zero[:1]).any())


def _scene_plan(seed, W, H, n=300, cap=1 << 14):
    """Seeded splats in front of a camera at W x H (not multiples of 32):
    the port's preprocess, plan and pair gather. Returns (feat, ranges,
    n_tx, n_ty)."""
    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * W
    means = (rng.normal(size=(n, 3)) * [0.6, 0.45, 0.4]).astype(np.float32)
    means[:, 2] += 3.0
    scales = np.exp(rng.normal(size=(n, 3)) * 0.6 - 2.2).astype(np.float32)
    scales[: n // 10, 0] *= 30.0  # needle-thin, long splats
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = (1 / (1 + np.exp(-rng.normal(size=n) * 2.5))).astype(np.float32)
    opac[: n // 20] = 0.999   # opaque: pixels finish early
    shs = (rng.normal(size=(n, 1, 3)) * 0.4).astype(np.float32)
    t = torch.as_tensor
    proj = t(cm.projection_matrix(0.01, 100.0, (W - 1) / 2, (H - 1) / 2,
                                  fx, fy, W, H))
    prep = gmath.preprocess(
        t(means), gmath.build_cov3d(t(scales), t(quats)), t(opac), t(shs), 0,
        torch.eye(4), proj, torch.zeros(6), fx, fy, W, H, W / (2 * fx),
        H / (2 * fy))
    plan = make_plan(prep, W, H, cap)
    assert int(plan.overflow) == 0
    feat = pair_gather(pack_table(prep), plan).contiguous()
    n_tx, n_ty = ttk.grid_dims(W, H)
    return feat, plan.ranges.contiguous(), n_tx, n_ty


def _room_plan(W=150, H=85):
    """The room map (4000 Gaussians, seeded) at 150x85 as the tracker
    plans it at full resolution (radius_scale 1.1, pad 2)."""
    gm = gmap.from_numpy(**make_room_map(4000, np.random.default_rng(0)),
                         max_sh_degree=0, device="cpu")
    f = 75.0
    cam = Camera.create(np.eye(3), np.zeros(3), f, f, (W - 1) / 2,
                        (H - 1) / 2, W, H, device="cpu")
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6), cam.fx, cam.fy, W, H,
        cam.tanfovx, cam.tanfovy, low_pass=0.3)
    plan = make_plan(prep, W, H, 1 << 17, radius_scale=1.1, radius_pad=2.0)
    assert int(plan.overflow) == 0
    feat = pair_gather(pack_table(prep), plan).detach().contiguous()
    n_tx, n_ty = ttk.grid_dims(W, H)
    return feat, plan.ranges.contiguous(), n_tx, n_ty


PLANS = {"scene_83x45": lambda: (*_scene_plan(1, 83, 45), 83, 45),
         "scene_125x70": lambda: (*_scene_plan(2, 125, 70, n=500), 125, 70),
         "room_150x85": lambda: (*_room_plan(), 150, 85)}


def _cells_pass_only_in_kept_blocks(feat, ranges, n_tx, n_ty, W, H):
    """Every (pair, pixel) cell of every tile run that passes the skip
    tests, done or not, lies in a (pair, block) block_keep_plain keeps."""
    px, py, pix_in, t16x, t16y = ttk._tile_pixels(n_tx, n_ty, W, H, "cpu",
                                                  ttk.TPX)
    xb, yb = ttk._pixel_blocks(n_tx, n_ty, "cpu")
    n_bad = n_cells = 0
    for t in range(n_tx * n_ty):
        a, b = (int(v) for v in ranges[t])
        if a == b:
            continue
        f = feat[a:b, None, :]                                   # (k, 1, 16)
        power, a_un = ttk._falloff(f[..., 2], f[..., 3], f[..., 4],
                                   f[..., 5], f[..., 0] - px[t],
                                   f[..., 1] - py[t], False)
        alpha = torch.clamp(a_un, max=ttk.ALPHA_MAX)
        rect = ((t16x[t] >= f[..., 10]) & (t16x[t] < f[..., 12])
                & (t16y[t] >= f[..., 11]) & (t16y[t] < f[..., 13]))
        ok = rect & (power <= 0.0) & (alpha >= ttk.ALPHA_MIN) & pix_in[t]
        keep = ttk.block_keep_plain(f, xb[t], yb[t])
        n_bad += int((ok & ~keep).sum())
        n_cells += int(ok.sum())
    assert n_cells > 0 and n_bad == 0, (n_bad, n_cells)


@pytest.mark.parametrize("name", list(PLANS))
def test_no_passing_cell_in_a_dropped_block(name):
    _cells_pass_only_in_kept_blocks(*PLANS[name]())


@pytest.mark.parametrize("name", list(PLANS))
def test_culled_walks_equal_plain_walks(name):
    """The walks restricted to the kept (pair, block) cells give the
    plain walks' images, n_touched (both forms) and passed cells, and the
    backward's rows, exactly; the sub-tile kernels' cell count is at
    least the passed cells and well below the 32x32 tile-walk's."""
    feat, ranges, n_tx, n_ty, W, H = PLANS[name]()
    for nt_weight in (False, True):
        ref, walked, passed, stop_at = ttk.plain_walk(
            feat, ranges, n_tx, n_ty, W, H, True, nt_weight, done_at=True)
        got, _, passed_c = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                          True, nt_weight, cull=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(passed_c) == int(passed)
    rng = np.random.default_rng(3)
    cot = torch.as_tensor(rng.normal(size=(5, H, W)).astype(np.float32))
    args = (feat, ranges, ref.color_sum, ref.depth_sum, ref.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    rows, _, included = ttk.plain_bwd_walk(*args)
    rows_c, _, included_c = ttk.plain_bwd_walk(*args, cull=True)
    assert torch.equal(rows_c, rows)
    assert int(included_c) == int(included) > 0
    kept, rected = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at)
    tile_walk = int(walked.sum()) * ttk.P
    assert int(passed) <= kept <= rected <= tile_walk
    assert kept < tile_walk // 2


def test_subtile_cells_matches_a_literal_count():
    """subtile_cells against a literal loop over tiles, quarters, warps'
    blocks and 64-row chunks (a warp walks a chunk while one of its pixels
    is not done at the chunk's start), in small batches."""
    feat, ranges, n_tx, n_ty, W, H = PLANS["scene_83x45"]()
    _, _, _, stop_at = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                      done_at=True)
    kept = rected = 0
    for t in range(n_tx * n_ty):
        a, b = (int(v) for v in ranges[t])
        tx, ty = t % n_tx, t // n_tx
        for blk in range(32):
            bx, by = (blk % 4) * 8, (blk // 4) * 4
            q = [(by + j) * 32 + bx + i for j in range(4) for i in range(8)]
            last = int(stop_at[t, q].max())
            x0, y0 = tx * 32 + bx, ty * 32 + by
            for r in range(a, b):
                if (r - a) // 64 * 64 > last:
                    break
                f = feat[r]
                cx, cy = float(x0 // 16), float(y0 // 16)
                if not (f[10] <= cx < f[12] and f[11] <= cy < f[13]):
                    continue
                rected += 32
                kept += 32 * bool(ttk.block_keep_plain(
                    f, torch.tensor(float(x0)), torch.tensor(float(y0))))
    assert ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at,
                             batch=97) == (kept, rected)

"""The conservative block test of the redesigned B4 (16x16 tiles) and
B1'-mxu / B1-mxu (the tensor-core falloff) and the walks restricted to the
cells it keeps (``ops/tile_kernel2.py``: ``block_keep_plain``,
``mxu_margin_plain``, ``plain_walk``, ``plain_bwd_walk``,
``subtile_cells``), against the unculled walks and the JAX package's
Pallas kernels in interpret mode:

- under mxu the test drops a (pair, 8x4 block) only where the expanded
  tile-local form (``_mxu_form``, an f32 matmul) leaves alpha < 1/255 at
  every pixel of the block, on seeded rows, rows at alpha = 1/255 to a few
  ulps, needle-thin conics, means 10^3 px outside the tile and
  hypothesis draws; and the plain matmul's power lies within the 12u
  Mmag the margin's derivation (``csrc/subtile_cull.cuh``) allows it;
- ``plain_walk(mxu=True, cull=True)`` gives ``plain_walk(mxu=True)``'s
  images, n_touched and passed cells bit for bit on the room map's plan,
  tests/test_torch_mxu.py's scene and its hard plans (an opaque front that
  exits early, a plan cut by its capacity), and on the last three both
  match JAX's ``_fwd_impl(mxu=True)`` at that file's tolerances (color
  3e-5, depth 2e-4, T 3e-5, n_touched equal). On the room's plan (deeper
  runs) the plain mxu walk itself, culled or not, reads one of 38,250
  color values 3.8e-5 off JAX (its cumsum against the reference's
  triangular matmul), above the 3e-5 those scenes set; it is held to the
  unculled walk there;
- ``plain_bwd_walk(tile=16, cull=True)`` gives the unculled rows bit for
  bit, and matches JAX's ``_bwd_impl16`` at ``tests/test_torch_kernel16.py``'s
  tolerance (2e-3 of each column's max);
- ``subtile_cells`` at tile 16 and under mxu agrees with a literal count.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``cuda`` marker)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel16 as jtk16
from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel16 as ttk16
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map

from test_torch_composite import _feat_ranges, _opaque_front
from test_torch_subtile_cull import _random_rows, _rows, _scene_plan
from test_renderer_ref import make_scene

torch.set_num_threads(1)

F32 = torch.float32
U = 2.0 ** -24
BX = torch.arange(ttk.BLOCK_W, dtype=F32)
BY = torch.arange(ttk.BLOCK_H, dtype=F32)
TX, TY = 3, 2                       # the tile the row tests sit in
CX, CY = TX * 32 + 15.5, TY * 32 + 15.5


def _block_pixels(xb, yb):
    """(n, 1, 32) pixel coordinates of the 8x4 blocks at (xb, yb)."""
    px = (xb[:, None, None] + BX[None, None, :]).expand(-1, 4, -1)
    py = (yb[:, None, None] + BY[None, :, None]).expand(-1, -1, 8)
    return px.reshape(-1, 1, 32), py.reshape(-1, 1, 32)


def _mxu_passes_somewhere(f, xb, yb):
    """Whether each row of f passes the skip tests (power <= 0, alpha >=
    1/255) at some pixel of its 8x4 block with the plain version's mxu
    power (clamped ``_mxu_form`` about the tile centre (CX, CY))."""
    px, py = _block_pixels(xb, yb)
    n = f.shape[0]
    cx = torch.full((n, 1, 1), CX)
    cy = torch.full((n, 1, 1), CY)
    power = ttk._mxu_power(f[:, None, :], px, py, cx, cy)[:, 0]   # (n, 32)
    alpha = torch.clamp(f[:, 5:6] * torch.exp(power), max=ttk.ALPHA_MAX)
    return ((power <= 0.0) & (alpha >= ttk.ALPHA_MIN)).any(dim=1)


def _keep_mxu(f, xb, yb):
    n = f.shape[0]
    return ttk.block_keep_plain(f, xb, yb, centre=(torch.full((n,), CX),
                                                   torch.full((n,), CY)))


def _assert_conservative_mxu(f, xb, yb):
    keep = _keep_mxu(f, xb, yb)
    bad = _mxu_passes_somewhere(f, xb, yb) & ~keep
    assert not bool(bad.any()), f[bad][:4]
    return keep


def _tile_blocks(rng, n):
    """Random 8x4 blocks of tile (TX, TY)."""
    xb = TX * 32 + 8.0 * rng.integers(0, 4, n)
    yb = TY * 32 + 4.0 * rng.integers(0, 8, n)
    return torch.as_tensor(xb, dtype=F32), torch.as_tensor(yb, dtype=F32)


def _shift(f, dx, dy):
    f = f.clone()
    f[:, 0] += dx
    f[:, 1] += dy
    return f


def test_mxu_block_keep_is_conservative_on_seeded_rows():
    rng = np.random.default_rng(0)
    f = _shift(_random_rows(rng, 20000), TX * 32, TY * 32)
    xb, yb = _tile_blocks(rng, 20000)
    keep = _assert_conservative_mxu(f, xb, yb)
    # not vacuous, and close to the f32 test: the margin is small beside
    # the terms the test compares
    assert 0.3 < float((~keep).float().mean()) < 0.99
    keep32 = ttk.block_keep_plain(f, xb, yb)
    assert float((keep != keep32).float().mean()) < 0.01


def _threshold_rows_mxu(ulps):
    """Rows whose mxu alpha at pixel (3, 2) of the tile's block (8, 4) is
    1/255 moved by ``ulps`` f32 ulps of the opacity."""
    rng = np.random.default_rng(7)
    px = torch.tensor([[[TX * 32 + 11.0]]])
    py = torch.tensor([[[TY * 32 + 6.0]]])
    cx, cy = torch.tensor([[[CX]]]), torch.tensor([[[CY]]])
    rows = []
    while len(rows) < 300:
        f = _random_rows(rng, 1)
        f[:, 0:2] = torch.as_tensor(
            rng.uniform(-12.0, 16.0, 2) + [px.item(), py.item()], dtype=F32)
        power = ttk._mxu_power(f[None], px, py, cx, cy)[0, 0, 0]
        if float(power) < -5.0:
            continue
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
def test_mxu_block_keep_at_the_alpha_threshold(ulps):
    f = _threshold_rows_mxu(ulps)
    n = f.shape[0]
    xb = torch.full((n,), TX * 32 + 8.0)
    yb = torch.full((n,), TY * 32 + 4.0)
    keep = _assert_conservative_mxu(f, xb, yb)
    if ulps >= 0:
        assert bool(keep.all())


def test_mxu_block_keep_needles_and_far_means():
    """Needle-thin conics (eigenvalues 1e6 apart) at any angle, and means
    10^3 px outside the tile with wide splats that still reach it: the
    expansion's terms dwarf the power there, and the test stays
    conservative."""
    rng = np.random.default_rng(3)
    n = 6000
    th = rng.uniform(0, np.pi, n)
    lam = np.stack([np.full(n, 0.25), np.full(n, 2.5e5)], 1)
    c, s = np.cos(th), np.sin(th)
    cxx = lam[:, 0] * c * c + lam[:, 1] * s * s
    cyy = lam[:, 0] * s * s + lam[:, 1] * c * c
    cxy = (lam[:, 0] - lam[:, 1]) * c * s
    det = cxx * cyy - cxy * cxy
    near = _rows(rng.uniform(-40, 72, n) + TX * 32,
                 rng.uniform(-40, 72, n) + TY * 32, cyy / det, -cxy / det,
                 cxx / det, np.exp(rng.uniform(np.log(1e-2), 0.0, n)))
    ang = rng.uniform(0, 2 * np.pi, n)
    dist = rng.uniform(1000.0, 1500.0, n)
    var = (dist / rng.uniform(1.0, 3.5, n)) ** 2
    far = _rows(CX + dist * np.cos(ang), CY + dist * np.sin(ang), 1.0 / var,
                0.0, 1.0 / var, np.exp(rng.uniform(np.log(1e-2), 0.0, n)))
    for f in (near, far):
        xb, yb = _tile_blocks(rng, n)
        _assert_conservative_mxu(f, xb, yb)
    # some far rows do reach the tile, and the test keeps them
    keep = _keep_mxu(far, *_tile_blocks(np.random.default_rng(4), n))
    assert 0 < int(keep.sum()) < n


def test_plain_mxu_power_within_the_derived_bound():
    """The margin's derivation allows the plain version's power 12u Mmag
    off the exact power (and the kernel's 78u): on seeded, needle and far
    rows at every pixel of the tile the plain f32 matmul's power lies
    within that of the float64 form, and CULL_MXU covers it."""
    rng = np.random.default_rng(9)
    f = torch.cat([_shift(_random_rows(rng, 3000), TX * 32, TY * 32),
                   _shift(_random_rows(rng, 1000), TX * 32 + 700.0,
                          TY * 32 - 400.0)])
    q = torch.arange(1024)
    px = (TX * 32 + q % 32).to(F32)[None, None]
    py = (TY * 32 + q // 32).to(F32)[None, None]
    cx, cy = torch.tensor([[[CX]]]), torch.tensor([[[CY]]])
    got = ttk._mxu_form(f[None], px, py, cx, cy)[0].double()
    d = f.double()
    dx = d[:, 0:1] - px[0].double()
    dy = d[:, 1:2] - py[0].double()
    exact = -0.5 * (d[:, 2:3] * dx * dx + 2 * d[:, 3:4] * dx * dy
                    + d[:, 4:5] * dy * dy)
    mmag = (ttk.mxu_margin_plain(f, torch.tensor(CX), torch.tensor(CY))
            / ttk.CULL_MXU).double()[:, None]
    err = (got - exact).abs()
    assert bool((err <= 12 * U * mmag).all()), float((err / mmag).max())
    assert ttk.CULL_MXU >= 3 * 78 * U


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.floats(-1500.0, 1500.0, width=32),
       st.floats(-1500.0, 1500.0, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(-1.0 + 2.0 ** -11, 1.0 - 2.0 ** -11, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(2.0 ** -10, 1.0, width=32),
       st.integers(0, 3), st.integers(0, 7))
def test_mxu_block_keep_conservative_hypothesis(mx, my, ca, rho, cc, opa,
                                                bx, by):
    """Any PD conic from needle-thin to huge, any mean within 1500 px of
    the tile, any opacity and block of the tile: conservative."""
    cb = rho * float(np.sqrt(np.float32(ca) * np.float32(cc)))
    f = _rows(CX + mx, CY + my, ca, cb, cc, opa)
    xb = torch.tensor([TX * 32 + 8.0 * bx])
    yb = torch.tensor([TY * 32 + 4.0 * by])
    _assert_conservative_mxu(f, xb, yb)


def test_mxu_block_keep_never_drops_non_pd_or_non_finite():
    nan, inf = float("nan"), float("inf")
    far = CX + 500.0
    f = _rows(*zip(*[(far, far, -1.0, 0.0, 1.0, 0.5),
                     (far, far, 1.0, 2.0, 1.0, 0.5),
                     (nan, far, 1.0, 0.0, 1.0, 0.5),
                     (far, far, 1.0, inf, 1.0, 0.5),
                     (far, far, 1.0, 0.0, 1.0, nan)]))
    n = f.shape[0]
    xb = torch.full((n,), TX * 32.0)
    yb = torch.full((n,), TY * 32.0)
    assert bool(_keep_mxu(f, xb, yb).all())
    g = _rows(far, far, 1.0, 0.0, 1.0, 0.5)
    assert not bool(_keep_mxu(g, xb[:1], yb[:1]).any())


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

def _room_plan(tile16, W=150, H=85, **kw):
    """The room map (4000 Gaussians, seeded) at W x H, planned as the
    tracker plans it at full resolution (radius_scale 1.1, pad 2), or as
    ``kw`` says, on 32- or 16-px tiles."""
    gm = gmap.from_numpy(**make_room_map(4000, np.random.default_rng(0)),
                         max_sh_degree=0, device="cpu")
    f = W / 2.0
    cam = Camera.create(np.eye(3), np.zeros(3), f, f, (W - 1) / 2,
                        (H - 1) / 2, W, H, device="cpu")
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6), cam.fx, cam.fy, W, H,
        cam.tanfovx, cam.tanfovy, low_pass=0.3)
    kw = kw or dict(radius_scale=1.1, radius_pad=2.0)
    plan = make_plan(prep, W, H, 1 << 17, tile16=tile16, **kw)
    assert int(plan.overflow) == 0
    feat = pair_gather(pack_table(prep), plan).detach().contiguous()
    return feat, plan.ranges.contiguous(), W, H


@functools.lru_cache(maxsize=None)
def _mxu_plan(name):
    """(feat, ranges, W, H) of a 32-px plan the mxu walks run on: the
    room, or tests/test_torch_mxu.py's scenes (a seeded scene, an opaque
    front whose tiles exit before their last chunk, a plan cut by its
    capacity)."""
    if name == "room":
        return _room_plan(False)
    sc, cap = {
        "scene": lambda: (make_scene(np.random.default_rng(11), n=40, W=160,
                                     H=72), 8192),
        "early_exit": lambda: (_opaque_front(np.random.default_rng(5)), 8192),
        "overflow": lambda: (make_scene(np.random.default_rng(64), n=64,
                                        W=256, H=64), 128)}[name]()
    feat, ranges, _, _, _ = _feat_ranges(sc, capacity=cap)
    return torch.as_tensor(feat), torch.as_tensor(ranges), sc["W"], sc["H"]


@pytest.mark.parametrize("name", ["room", "scene", "early_exit",
                                  "overflow"])
def test_mxu_culled_walk_equals_plain_and_pallas(name):
    """plain_walk(mxu=True, cull=True) bit for bit against the unculled
    mxu walk (images, n_touched in both forms, passed cells), and but on
    the room's plan (see the module's note) both against JAX's mxu
    forward in interpret mode."""
    feat, ranges, W, H = _mxu_plan(name)
    n_tx, n_ty = ttk.grid_dims(W, H)
    for nt_weight in (False, True):
        ref, _, passed = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, True,
                                        nt_weight, mxu=True)
        got, _, passed_c = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                          True, nt_weight, mxu=True,
                                          cull=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(passed_c) == int(passed) > 0
        if name == "room":
            continue
        img, nt_j = jtk._fwd_impl(jnp.asarray(feat.numpy()),
                                  jnp.asarray(ranges.numpy()), n_tx, n_ty, W,
                                  H, interpret=True, with_ntouch=True,
                                  nt_weight=nt_weight, mxu=True)
        asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
        np.testing.assert_allclose(got.color_sum.numpy(), asm[0:3], atol=3e-5)
        np.testing.assert_allclose(got.depth_sum.numpy(), asm[3], atol=2e-4)
        np.testing.assert_allclose(got.final_T.numpy(), asm[4], atol=3e-5)
        np.testing.assert_array_equal(got.n_touched_pairs.numpy(),
                                      np.asarray(nt_j))
    assert float(got.final_T.min()) < 0.5


@functools.lru_cache(maxsize=None)
def _plan16(name):
    """(feat, ranges, W, H) of a 16-px plan: the room as the tracker or as
    mapping plans it, or the seeded scene of tests/test_torch_kernel16.py
    at 72x40 (neither edge a multiple of 32)."""
    if name == "room_track":
        return _room_plan(True)
    if name == "room_map":
        return _room_plan(True, radius_scale=1.1, radius_pad=6.0,
                          opa_growth=2.23)
    from test_torch_kernel16 import _plans
    sc = make_scene(np.random.default_rng(11), n=60, W=72, H=40)
    plan_j, _, feat, _ = _plans(sc)
    return (torch.as_tensor(feat), torch.as_tensor(np.array(plan_j.ranges)),
            sc["W"], sc["H"])


@pytest.mark.parametrize("name", ["room_track", "room_map", "scene_72x40"])
def test_bwd16_culled_walk_equals_plain_and_pallas(name):
    """plain_bwd_walk(tile=16, cull=True) gives the unculled rows and
    included cells bit for bit (and the culled forward the unculled
    images); the rows match JAX's _bwd_impl16 within 2e-3 of each column's
    max."""
    feat, ranges, W, H = _plan16(name)
    n_gx, n_gy = ttk16.grid_dims16(W, H)
    n_tx, n_ty = 2 * n_gx, 2 * n_gy
    fwd, _, passed = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, False,
                                    tile=16)
    fwd_c, _, passed_c = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                        False, tile=16, cull=True)
    for a, b in zip(fwd_c, fwd):
        assert torch.equal(a, b)
    assert int(passed_c) == int(passed)
    cot = torch.as_tensor(np.random.default_rng(7).normal(
        size=(5, H, W)).astype(np.float32))
    args = (feat, ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    rows, _, inc = ttk.plain_bwd_walk(*args, tile=16)
    rows_c, _, inc_c = ttk.plain_bwd_walk(*args, tile=16, cull=True)
    assert torch.equal(rows_c, rows)
    assert int(inc_c) == int(inc) > 0
    img, _ = jtk16._fwd_impl16(jnp.asarray(feat.numpy()),
                               jnp.asarray(ranges.numpy()), n_gx, n_gy, W, H,
                               interpret=True, with_ntouch=False)
    cot_img = jtk16.disassemble_image16(jnp.asarray(cot.numpy()), n_gx, n_gy)
    ref = np.asarray(jtk16._bwd_impl16(
        jnp.asarray(feat.numpy()), jnp.asarray(ranges.numpy()), img, cot_img,
        n_gx, n_gy, W, H, interpret=True))
    got = rows_c.numpy()
    for col in range(10):
        a = ref[:, col]
        assert np.abs(a).max() > 0, col
        np.testing.assert_allclose(got[:, col], a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=f"column {col}")
    assert not got[:, 10:].any()


def _literal_cells(feat, ranges, n_tx, n_ty, stop_at, tile, mxu):
    """subtile_cells by a literal loop over tiles, warps' 8x4 blocks and
    64-row chunks."""
    kept = rected = 0
    n_bx = tile // 8
    for t in range(n_tx * n_ty):
        a, b = (int(v) for v in ranges[t])
        tx, ty = t % n_tx, t // n_tx
        centre = ((torch.tensor(tx * 32 + 15.5), torch.tensor(ty * 32 + 15.5))
                  if mxu else None)
        for blk in range(n_bx * (tile // 4)):
            bx, by = (blk % n_bx) * 8, (blk // n_bx) * 4
            q = [(by + j) * tile + bx + i for j in range(4) for i in range(8)]
            last = int(stop_at[t, q].max())
            x0, y0 = tx * tile + bx, ty * tile + by
            for r in range(a, b):
                if (r - a) // 64 * 64 > last:
                    break
                f = feat[r]
                cx, cy = float(x0 // 16), float(y0 // 16)
                if not (f[10] <= cx < f[12] and f[11] <= cy < f[13]):
                    continue
                rected += 32
                kept += 32 * bool(ttk.block_keep_plain(
                    f, torch.tensor(float(x0)), torch.tensor(float(y0)),
                    centre=centre))
    return kept, rected


@pytest.mark.parametrize("tile,mxu", [(16, False), (32, True)])
def test_subtile_cells_at_tile16_and_under_mxu(tile, mxu):
    """subtile_cells against a literal count, in small batches, with the
    stop offsets of the f32 16-px walk (the 72x40 scene's 16-px plan) or
    the mxu walk (a seeded scene's 32-px plan at 83x45); the count lies
    between the passed cells and the tile-walk's."""
    if tile == 16:
        feat, ranges, W, H = _plan16("scene_72x40")
        n_gx, n_gy = ttk16.grid_dims16(W, H)
        n_tx, n_ty = 2 * n_gx, 2 * n_gy
    else:
        feat, ranges, n_tx, n_ty = _scene_plan(1, 83, 45)
        W, H = 83, 45
    _, walked, passed, stop_at = ttk.plain_walk(
        feat, ranges, n_tx, n_ty, W, H, False, tile=tile, mxu=mxu,
        done_at=True)
    got = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at, tile=tile,
                            mxu=mxu, batch=97)
    assert got == _literal_cells(feat, ranges, n_tx, n_ty, stop_at, tile,
                                 mxu)
    assert int(passed) <= got[0] < got[1] <= int(walked.sum()) * tile * tile

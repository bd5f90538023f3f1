"""The conservative block test under the bfloat16 falloff (B1'-bf16 /
B1-bf16 of ``csrc/tile32_fwd_subtile.cu``) and the forward walks
restricted to the cells it keeps, at 32 px under bf16 and at 16 px (B3 /
B3' of ``csrc/tile16_fwd_subtile.cu``), against the unculled walks and
the JAX package's Pallas kernels in interpret mode
(``ops/tile_kernel2.py``: ``block_keep_plain(..., bf16=True)``,
``plain_walk``, ``subtile_cells``):

- under bf16 the test drops a (pair, 8x4 block) only where
  ``_falloff(bf16=True)`` (every product and sum rounded to bfloat16)
  leaves alpha < 1/255 at every pixel of the block: on seeded rows, rows
  at alpha = 1/255 to a few bfloat16 ulps of the opacity, needle-thin and
  huge conics, means 10^3 px outside the block and hypothesis draws;
  non-PD and non-finite rows are never dropped;
- the bfloat16 power lies within the bound the margin's derivation
  (``csrc/subtile_cull.cuh``) allows it, 7.1 u_b (ca dx^2 + cc dy^2) of
  the float64 power at the f32 deltas (<= 3.55 u_b Smax), and a_un within
  3.05 u_b of opa exp(power) in the log;
- ``plain_walk(bf16=True, cull=True)`` equals ``plain_walk(bf16=True)``
  bit for bit (images, n_touched in both forms, passed cells) on
  tests/test_torch_subtile_cull.py's plans, and matches JAX's
  ``_fwd_impl(bf16=True)`` within ``tests/test_torch_bf16.py``'s tolerance
  (1/4 of the JAX bf16-vs-f32 gap in color and depth and in n_touched
  mismatches; the JAX side in a subprocess under
  ``XLA_FLAGS=--xla_allow_excess_precision=false``, as there);
- ``plain_walk(tile=16, cull=True)`` equals the unculled 16-px walk bit
  for bit in both n_touched forms, and matches JAX's ``_fwd_impl16``
  within ``tests/test_torch_kernel16.py``'s tolerance (color 3e-5, depth
  2e-4, T 3e-5, n_touched equal);
- ``subtile_cells(bf16=True)`` and the 16-px forward's count agree with a
  literal count.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``cuda`` marker)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel16 as jtk16
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel16 as ttk16
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk

from test_renderer_ref import make_scene
from test_torch_cull16_mxu import _plan16
from test_torch_subtile_cull import PLANS, _random_rows, _rows

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32
UB = 2.0 ** -8                     # bfloat16's unit roundoff
GAP_FRAC = 0.25                    # tests/test_torch_bf16.py's tolerance
BX = torch.arange(ttk.BLOCK_W, dtype=F32)
BY = torch.arange(ttk.BLOCK_H, dtype=F32)


def _block_deltas(f, xb, yb):
    """(dx, dy), (n, 4, 8) f32: the deltas of row f's mean at each pixel
    of its 8x4 block at (xb, yb)."""
    px = (xb[:, None, None] + BX[None, None, :]).to(F32)
    py = (yb[:, None, None] + BY[None, :, None]).to(F32)
    return f[:, 0, None, None] - px, f[:, 1, None, None] - py


def _bf16_falloff(f, xb, yb):
    """(power, a_un) of ``_falloff(bf16=True)`` at each pixel of the
    rows' blocks, (n, 4, 8) each."""
    dx, dy = _block_deltas(f, xb, yb)
    g = f[:, :, None, None]
    return ttk._falloff(g[:, 2], g[:, 3], g[:, 4], g[:, 5], dx, dy, True)


def _passes_somewhere_bf16(f, xb, yb):
    """Whether each row passes the skip tests (power <= 0, alpha >= 1/255
    by the bfloat16 falloff) at some pixel of its block: (n,) bool."""
    power, a_un = _bf16_falloff(f, xb, yb)
    alpha = torch.clamp(a_un, max=ttk.ALPHA_MAX)
    return ((power <= 0.0) & (alpha >= ttk.ALPHA_MIN)).flatten(1).any(dim=1)


def _assert_conservative_bf16(f, xb, yb):
    keep = ttk.block_keep_plain(f, xb, yb, bf16=True)
    bad = _passes_somewhere_bf16(f, xb, yb) & ~keep
    assert not bool(bad.any()), f[bad][:4]
    return keep


def _origin_blocks(rng, n):
    """Random 8x4 blocks of the 32x32 tile at the origin."""
    return (torch.as_tensor(8.0 * rng.integers(0, 4, n), dtype=F32),
            torch.as_tensor(4.0 * rng.integers(0, 8, n), dtype=F32))


def test_bf16_block_keep_is_conservative_on_seeded_rows():
    rng = np.random.default_rng(0)
    f = _random_rows(rng, 20000)
    xb, yb = _origin_blocks(rng, 20000)
    keep = _assert_conservative_bf16(f, xb, yb)
    # not vacuous, and it keeps at least what the f32 test keeps (its
    # margin is wider)
    assert 0.2 < float((~keep).float().mean()) < 0.99
    keep32 = ttk.block_keep_plain(f, xb, yb)
    assert not bool((keep32 & ~keep).any())


def _bf16_step(x, k):
    """The f32 value of bfloat16 ``x`` moved by ``k`` bfloat16 ulps
    (positive finite values)."""
    bits = x.to(torch.bfloat16).view(torch.int16) + k
    return bits.view(torch.bfloat16).float()


def _threshold_rows_bf16(ulps):
    """Rows whose bfloat16 alpha at the block's pixel (3, 2) is 1/255:
    the least bfloat16 opacity that reaches it there, moved by ``ulps``
    bfloat16 ulps; conics of several shapes and sizes, means inside and
    around the block."""
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(400):
        f = _random_rows(rng, 1)
        f[:, 0:2] = torch.as_tensor(rng.uniform(-12.0, 16.0, 2), dtype=F32)
        dx, dy = f[:, 0] - 3.0, f[:, 1] - 2.0

        def a_un(opa):
            return ttk._falloff(f[:, 2], f[:, 3], f[:, 4], opa, dx, dy,
                                True)[1]
        power = ttk._falloff(f[:, 2], f[:, 3], f[:, 4], f[:, 5], dx, dy,
                             True)[0]
        if float(power) < -5.0:
            continue
        opa = (torch.tensor(ttk.ALPHA_MIN) / torch.exp(power)).to(
            torch.bfloat16).float()
        while float(a_un(opa)) >= ttk.ALPHA_MIN:
            opa = _bf16_step(opa, -1)
        while float(a_un(opa)) < ttk.ALPHA_MIN:
            opa = _bf16_step(opa, 1)
        f[:, 5] = _bf16_step(opa, ulps)
        rows.append(f)
    return torch.cat(rows)


@pytest.mark.parametrize("ulps", [0, 1, 3, -1, -3])
def test_bf16_block_keep_at_the_alpha_threshold(ulps):
    """Pixels at bfloat16 alpha = 1/255 to a few bfloat16 ulps of the
    opacity: every row that still passes at the pixel is kept."""
    f = _threshold_rows_bf16(ulps)
    assert f.shape[0] > 100
    zero = torch.zeros(f.shape[0], dtype=F32)
    keep = _assert_conservative_bf16(f, zero, zero)
    if ulps >= 0:
        assert bool(keep.all())


def _needles_and_far(rng, n):
    """Needle-thin conics (eigenvalues 1e6 apart) at any angle near the
    tile at the origin, and wide splats whose means lie 10^3-1.5 x 10^3 px
    outside it."""
    th = rng.uniform(0, np.pi, n)
    lam0, lam1 = 0.25, 2.5e5
    c, s = np.cos(th), np.sin(th)
    cxx = lam0 * c * c + lam1 * s * s
    cyy = lam0 * s * s + lam1 * c * c
    cxy = (lam0 - lam1) * c * s
    det = cxx * cyy - cxy * cxy
    near = _rows(rng.uniform(-40, 72, n), rng.uniform(-40, 72, n), cyy / det,
                 -cxy / det, cxx / det,
                 np.exp(rng.uniform(np.log(1e-2), 0.0, n)))
    ang = rng.uniform(0, 2 * np.pi, n)
    dist = rng.uniform(1000.0, 1500.0, n)
    var = (dist / rng.uniform(1.0, 3.5, n)) ** 2
    far = _rows(15.5 + dist * np.cos(ang), 15.5 + dist * np.sin(ang),
                1.0 / var, 0.0, 1.0 / var,
                np.exp(rng.uniform(np.log(1e-2), 0.0, n)))
    return near, far


def test_bf16_block_keep_needles_huge_and_far_means():
    """Needle-thin conics, huge splats (covariance up to 1e6 px^2) and
    means 10^3 px outside the block: conservative, and some far rows
    reach the block and are kept."""
    rng = np.random.default_rng(3)
    n = 6000
    near, far = _needles_and_far(rng, n)
    lam = np.exp(rng.uniform(np.log(1e3), np.log(1e6), size=(n, 2)))
    huge = _rows(rng.uniform(-900, 900, n), rng.uniform(-900, 900, n),
                 1.0 / lam[:, 0], 0.0, 1.0 / lam[:, 1],
                 np.exp(rng.uniform(np.log(1e-3), 0.0, n)))
    for f in (near, far, huge):
        _assert_conservative_bf16(f, *_origin_blocks(rng, n))
    keep = ttk.block_keep_plain(far, *_origin_blocks(rng, n), bf16=True)
    assert 0 < int(keep.sum()) < n


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.floats(-1500.0, 1500.0, width=32),
       st.floats(-1500.0, 1500.0, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(-1.0 + 2.0 ** -11, 1.0 - 2.0 ** -11, width=32),
       st.floats(2.0 ** -20, 1024.0, width=32),
       st.floats(2.0 ** -10, 1.0, width=32),
       st.integers(0, 3), st.integers(0, 7))
def test_bf16_block_keep_conservative_hypothesis(mx, my, ca, rho, cc, opa,
                                                 bx, by):
    """Any PD conic from needle-thin to huge, any mean within 1500 px of
    the tile, any opacity and block of the tile: conservative."""
    cb = rho * float(np.sqrt(np.float32(ca) * np.float32(cc)))
    f = _rows(15.5 + mx, 15.5 + my, ca, cb, cc, opa)
    _assert_conservative_bf16(f, torch.tensor([8.0 * bx]),
                              torch.tensor([4.0 * by]))


def test_bf16_block_keep_never_drops_non_pd_or_non_finite():
    nan, inf = float("nan"), float("inf")
    far = 500.0
    f = _rows(*zip(*[(far, far, -1.0, 0.0, 1.0, 0.5),
                     (far, far, 1.0, 0.0, 0.0, 0.5),
                     (far, far, 1.0, 1.0, 1.0, 0.5),
                     (far, far, 1.0, 2.0, 1.0, 0.5),
                     (nan, far, 1.0, 0.0, 1.0, 0.5),
                     (far, inf, 1.0, 0.0, 1.0, 0.5),
                     (far, far, nan, 0.0, 1.0, 0.5),
                     (far, far, 1.0, inf, 1.0, 0.5),
                     (far, far, 1.0, 0.0, 1.0, nan),
                     (far, far, 1.0, 0.0, 1.0, inf)]))
    zero = torch.zeros(f.shape[0], dtype=F32)
    assert bool(ttk.block_keep_plain(f, zero, zero, bf16=True).all())
    g = _rows(far, far, 1.0, 0.0, 1.0, 0.5)
    assert not bool(ttk.block_keep_plain(g, zero[:1], zero[:1],
                                         bf16=True).any())


def test_bf16_power_within_the_derived_bound():
    """The margin's derivation: at every pixel of a row's block the
    bfloat16 power lies within 7.1 u_b (ca dx^2 + cc dy^2) of the float64
    power at the f32 deltas, hence within 3.55 u_b Smax, and log a_un
    within 3.05 u_b above log opa + power_b; CULL_BF16_REL and
    CULL_BF16_ABS cover both more than twice. Seeded, needle, far and
    huge rows that pass the PD test."""
    rng = np.random.default_rng(9)
    n = 4000
    near, far = _needles_and_far(rng, n)
    f = torch.cat([_random_rows(rng, n), near, far])
    d = f.double()
    pd = (d[:, 2] * d[:, 4] - d[:, 3] ** 2) > ttk.PD_REL * d[:, 2] * d[:, 4]
    f = f[pd]
    xb, yb = _origin_blocks(rng, f.shape[0])
    power_b, a_un = _bf16_falloff(f, xb, yb)
    dx, dy = (v.double() for v in _block_deltas(f, xb, yb))
    ca, cb, cc = (f.double()[:, i, None, None] for i in (2, 3, 4))
    exact = -0.5 * (ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy)
    terms = ca * dx * dx + cc * dy * dy
    err = (power_b.double() - exact).abs()
    assert bool((err <= 7.1 * UB * terms).all()), float((err / terms).max())
    xlo, xhi = f[:, 0] - (xb + 7.0), f[:, 0] - xb
    ylo, yhi = f[:, 1] - (yb + 3.0), f[:, 1] - yb
    smax = 2.0 * (f[:, 2] * torch.fmax(xlo * xlo, xhi * xhi)
                  + f[:, 4] * torch.fmax(ylo * ylo, yhi * yhi))
    assert bool((err <= 3.55 * UB * smax.double()[:, None, None]).all())
    # the rounding is there: the bound is not vacuous
    assert float((err / terms)[terms > 0].max()) > 2.0 * UB
    live = a_un > 1e-30   # above bfloat16's subnormals
    log_excess = (torch.log(a_un.double()[live])
                  - torch.log(f.double()[:, 5, None, None].expand_as(
                      a_un)[live]) - power_b.double()[live])
    assert float(log_excess.max()) <= 3.05 * UB
    assert ttk.CULL_BF16_REL >= 2 * 3.55 * UB
    assert ttk.CULL_BF16_ABS >= 2 * 3.05 * UB


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

JAX_PLANS = ("scene_83x45", "scene_125x70")


def _jax_bf16_forward(in_path, out_path):
    """The JAX side (``python tests/test_torch_cull_bf16.py IN OUT``, under
    ``--xla_allow_excess_precision=false``): ``_fwd_impl`` with n_touched
    in both forms, bf16 and f32, on each plan of ``IN``."""
    from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
    res = {}
    with np.load(in_path) as z:
        for name in JAX_PLANS:
            feat, ranges = z[f"{name}_feat"], z[f"{name}_ranges"]
            n_tx, n_ty, W, H = (int(v) for v in z[f"{name}_dims"])
            for bf16 in (0, 1):
                for nt_weight in (0, 1):
                    img, nt = jtk._fwd_impl(
                        jnp.asarray(feat), jnp.asarray(ranges), n_tx, n_ty,
                        W, H, interpret=True, with_ntouch=True,
                        bf16=bool(bf16), nt_weight=bool(nt_weight))
                    key = f"{name}_{bf16}{nt_weight}"
                    res[f"{key}_img"] = np.asarray(
                        jtk.assemble_image(img, n_tx, n_ty, W, H))
                    res[f"{key}_nt"] = np.asarray(nt)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref_bf16(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cull_bf16")
    inputs = {}
    for name in JAX_PLANS:
        feat, ranges, n_tx, n_ty, W, H = PLANS[name]()
        inputs.update({f"{name}_feat": feat.numpy(),
                       f"{name}_ranges": ranges.numpy(),
                       f"{name}_dims": np.array([n_tx, n_ty, W, H])})
    in_path, out_path = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(in_path, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), in_path, out_path],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def _plan(name):
    return PLANS[name]()


@pytest.mark.parametrize("name", list(PLANS))
def test_bf16_culled_walk_equals_plain_walk(name):
    """plain_walk(bf16=True, cull=True) bit for bit against the unculled
    bf16 walk: images, n_touched in both forms, passed cells."""
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    for nt_weight in (False, True):
        ref, _, passed = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, True,
                                        nt_weight, bf16=True)
        got, _, passed_c = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                          True, nt_weight, bf16=True,
                                          cull=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(passed_c) == int(passed) > 0
    assert float(got.final_T.min()) < 0.5


@pytest.mark.parametrize("name", JAX_PLANS)
def test_bf16_culled_walk_matches_pallas(jref_bf16, name):
    """The culled bf16 walk against JAX's bf16 forward (per-op rounding):
    color and depth within 1/4 of the JAX bf16-vs-f32 gap, n_touched
    mismatches within 1/4 of the gap's, in both n_touched forms."""
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    for nt_weight in (0, 1):
        got = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, True,
                             bool(nt_weight), bf16=True, cull=True)[0]
        jb = jref_bf16[f"{name}_1{nt_weight}_img"]
        jf = jref_bf16[f"{name}_0{nt_weight}_img"]
        for port, sl in ((got.color_sum.numpy(), slice(0, 3)),
                         (got.depth_sum.numpy(), 3)):
            gap = float(np.abs(jb[sl] - jf[sl]).max())
            assert gap > 1e-3, (name, gap)
            assert float(np.abs(port - jb[sl]).max()) <= GAP_FRAC * gap
        ntb = jref_bf16[f"{name}_1{nt_weight}_nt"]
        ntf = jref_bf16[f"{name}_0{nt_weight}_nt"]
        gap_nt = int((ntb != ntf).sum())
        assert gap_nt > 0
        assert int((got.n_touched_pairs.numpy() != ntb).sum()) \
            <= GAP_FRAC * gap_nt


@pytest.mark.parametrize("name", ["room_track", "room_map", "scene_72x40"])
def test_fwd16_culled_walk_equals_plain_and_pallas(name):
    """plain_walk(tile=16, cull=True) bit for bit against the unculled
    16-px walk (images, n_touched in both forms, passed cells), and
    against JAX's _fwd_impl16 at tests/test_torch_kernel16.py's
    tolerance."""
    feat, ranges, W, H = _plan16(name)
    n_gx, n_gy = ttk16.grid_dims16(W, H)
    n_tx, n_ty = 2 * n_gx, 2 * n_gy
    for nt_weight in (False, True):
        ref, _, passed = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, True,
                                        nt_weight, tile=16)
        got, _, passed_c = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                          True, nt_weight, tile=16,
                                          cull=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert int(passed_c) == int(passed) > 0
        img, nt_j = jtk16._fwd_impl16(jnp.asarray(feat.numpy()),
                                      jnp.asarray(ranges.numpy()), n_gx,
                                      n_gy, W, H, interpret=True,
                                      with_ntouch=True, nt_weight=nt_weight)
        asm = np.asarray(jtk16.assemble_image16(img, n_gx, n_gy, W, H))
        np.testing.assert_allclose(got.color_sum.numpy(), asm[0:3],
                                   atol=3e-5)
        np.testing.assert_allclose(got.depth_sum.numpy(), asm[3], atol=2e-4)
        np.testing.assert_allclose(got.final_T.numpy(), asm[4], atol=3e-5)
        np.testing.assert_array_equal(got.n_touched_pairs.numpy(),
                                      np.asarray(nt_j))
        assert float(got.n_touched_pairs.sum()) > 0
    assert float(got.final_T.min()) < 0.5


def _literal_cells(feat, ranges, n_tx, n_ty, stop_at, tile, bf16):
    """subtile_cells by a literal loop over tiles, warps' 8x4 blocks and
    64-row chunks."""
    kept = rected = 0
    n_bx = tile // ttk.BLOCK_W
    for t in range(n_tx * n_ty):
        a, b = (int(v) for v in ranges[t])
        tx, ty = t % n_tx, t // n_tx
        for blk in range(n_bx * (tile // ttk.BLOCK_H)):
            bx, by = (blk % n_bx) * 8, (blk // n_bx) * 4
            q = [(by + j) * tile + bx + i for j in range(4) for i in range(8)]
            last = int(stop_at[t, q].max())
            x0, y0 = tx * tile + bx, ty * tile + by
            for r in range(a, b):
                if (r - a) // ttk.SUB_CHUNK * ttk.SUB_CHUNK > last:
                    break
                f = feat[r]
                cx, cy = float(x0 // 16), float(y0 // 16)
                if not (f[10] <= cx < f[12] and f[11] <= cy < f[13]):
                    continue
                rected += 32
                kept += 32 * bool(ttk.block_keep_plain(
                    f, torch.tensor(float(x0)), torch.tensor(float(y0)),
                    bf16=bf16))
    return kept, rected


def _map_plan16():
    """A seeded 72x40 scene planned on 16-px tiles as mapping plans
    (radius_scale 1.1, pad 6, opa_growth 2.23)."""
    from test_torch_kernel16 import _plans
    sc = make_scene(np.random.default_rng(11), n=60, W=72, H=40)
    plan_j, _, feat, _ = _plans(sc, radius_scale=1.1, radius_pad=6.0,
                                opa_growth=2.23)
    return (torch.as_tensor(feat), torch.as_tensor(np.array(plan_j.ranges)),
            sc["W"], sc["H"])


@pytest.mark.parametrize("tile,bf16", [(32, True), (16, False)])
def test_subtile_cells_under_bf16_and_for_the_16px_forward(tile, bf16):
    """subtile_cells against a literal count, in small batches: under bf16
    with the stop offsets of the bf16 walk (a seeded scene's 32-px plan at
    83x45), and for the 16-px forward with those of the f32 16-px walk on
    a mapping plan; the count lies between the passed cells and the
    tile-walk's, and under bf16 at or above the f32 test's."""
    if tile == 16:
        feat, ranges, W, H = _map_plan16()
        n_gx, n_gy = ttk16.grid_dims16(W, H)
        n_tx, n_ty = 2 * n_gx, 2 * n_gy
    else:
        feat, ranges, n_tx, n_ty, W, H = _plan("scene_83x45")
    _, walked, passed, stop_at = ttk.plain_walk(
        feat, ranges, n_tx, n_ty, W, H, False, tile=tile, bf16=bf16,
        done_at=True)
    got = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at, tile=tile,
                            bf16=bf16, batch=97)
    assert got == _literal_cells(feat, ranges, n_tx, n_ty, stop_at, tile,
                                 bf16)
    assert int(passed) <= got[0] < got[1] <= int(walked.sum()) * tile * tile
    if bf16:
        f32 = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop_at,
                                tile=tile)
        assert f32[0] <= got[0] and f32[1] == got[1]


if __name__ == "__main__":
    _jax_bf16_forward(sys.argv[1], sys.argv[2])

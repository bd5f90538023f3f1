"""The MXU compositing bodies of the port (B1-mxu, B1'-mxu, B2-mxu and
B2-bf16-mxu plain versions, ``render(mxu=True)``,
``track_frame_pyr(kernel_mxu=True)``) against the JAX package's
``mxu=True`` kernels in interpret mode.

- Forward: ``composite32_plain(mxu=True)`` against ``_fwd_impl(mxu=True)``
  plus ``assemble_image`` on the scenes of tests/test_torch_composite.py
  (single- and multi-chunk tiles, the opaque front that exits early), with
  and without n_touched and ``nt_weight``: color atol 3e-5, depth 2e-4,
  final_T 3e-5, n_touched equal (the f32 gates). Both evaluate the power
  as an f32 ``G6 @ P6`` and the transmittance in log space; only the
  order of the sums differs (measured: 6.6e-7 color, 2.1e-6 depth).
- Backward: ``composite32_bwd_plain(mxu=True)`` against ``_bwd_impl(mxu=
  True)``, and under ``bf16`` as well: columns within 2e-3 of their max
  (tests/test_torch_backward.py's tolerance). The bf16 case's JAX side
  runs in a subprocess under ``XLA_FLAGS=--xla_allow_excess_precision=
  false``, as tests/test_torch_bf16.py explains: under XLA's default the
  CPU compiler keeps the bfloat16 products in f32 and the two differ by
  2.7e-3-3.4e-3 of the column max (measured), with the flag by rounding
  only.
- Render: ``render(mxu=True)`` against JAX ``render(mxu=True)`` on the
  scene of tests/test_renderer_tiled.py:128-172: color, depth, opacity
  and dL/dtau at rtol 2e-3; and the port's mxu render against its own
  f32 render at that test's gates (color 1e-3, depth 5e-3, opacity 1e-3,
  dL/dtau 2e-3 relative).
- Tracker: ``track_frame_pyr(kernel_mxu=True)`` on the scene of
  tests/test_torch_tracking.py with one exact full-resolution level
  (levels (2, 1), iterations (4, 6), the last 2 exact), so B1'-mxu and
  B2-mxu's plain versions both run: R and t within 1e-4 of the JAX
  tracker's, iterations within 1; the same with ``kernel_bf16`` beside it
  against the subprocess.
- The falloff alone: ``mxu_power_tile_plain`` against JAX ``_mxu_power``
  (unclamped) on one chunk.

The CUDA kernels run only on the card: tests/test_torch_cuda.py (``cuda``
marker) holds them against these plain versions there.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking as ttr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

BG = np.array([0.05, 0.1, 0.15], np.float32)
W_T, H_T, CAP_T = 96, 64, 1 << 13
TRACK_KW = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
                pair_capacity=CAP_T, levels=(2, 1), level_iters=(4, 6),
                level_exact=(0, 2), curv="flow", final_level=1)
TAU0 = np.array([0.015, -0.012, 0.015, 0.005, 0.007, -0.004], np.float32)


def _scene(name):
    """tests/test_torch_backward.py's scenes: (scene, pair capacity)."""
    from test_renderer_ref import make_scene
    from test_torch_composite import _opaque_front
    if name == "scene":
        return make_scene(np.random.default_rng(11), n=40, W=160, H=72), 8192
    if name == "early_exit":
        return _opaque_front(np.random.default_rng(5)), 8192
    return make_scene(np.random.default_rng(64), n=64, W=256, H=64), 128


def track_scene_arrays():
    """tests/test_torch_tracking.py::scene's map (600 Gaussians, 96x64)."""
    from test_torch_bf16 import track_scene_arrays as arrays
    return arrays()


def _t(a):
    return torch.as_tensor(np.array(a))


def _bwd_inputs(name, jtk, jnp):
    """feat, ranges, the JAX mxu forward's planes (block layout and
    assembled) and a seeded cotangent (assembled and block layout)."""
    from test_torch_composite import _feat_ranges
    sc, cap = _scene(name)
    W, H = sc["W"], sc["H"]
    feat, ranges, n_tx, n_ty, plan = _feat_ranges(sc, capacity=cap)
    img, _ = jtk._fwd_impl(jnp.asarray(feat), jnp.asarray(ranges), n_tx,
                           n_ty, W, H, interpret=True, with_ntouch=False,
                           mxu=True)
    asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
    cot = np.random.default_rng(7).normal(size=(5, H, W)).astype(np.float32)
    cot_img = jtk.disassemble_image(jnp.asarray(cot), n_tx, n_ty)
    return feat, ranges, n_tx, n_ty, W, H, plan, img, asm, cot, cot_img


# ---------------------------------------------------------------------------
# the JAX side of the bf16 cases (python tests/test_torch_mxu.py OUT)
# ---------------------------------------------------------------------------

def _jax_bf16_reference(out_path):
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
    from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCam
    from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
    from gs_slam_analytica_jacobian_tpu.ops.lie import se3_exp
    from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
    from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
    from gs_slam_analytica_jacobian_tpu.slam import tracking as jtr

    res = {}
    for name in ("scene", "early_exit", "overflow"):
        (feat, ranges, n_tx, n_ty, W, H, _, img, asm, cot,
         cot_img) = _bwd_inputs(name, jtk, jnp)
        res[f"{name}_rows"] = np.asarray(jtk._bwd_impl(
            jnp.asarray(feat), jnp.asarray(ranges), img, cot_img, n_tx,
            n_ty, W, H, interpret=True, mxu=True, bf16=True))
        for key, val in (("feat", feat), ("ranges", ranges), ("asm", asm),
                         ("cot", cot)):
            res[f"{name}_{key}"] = val
    cam = JCam.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                      (H_T - 1) / 2, W_T, H_T)
    gm = jgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0)
    out = japi.render(gm, cam, None, jnp.zeros(3), pair_capacity=CAP_T,
                      interpret=True)
    gt_image = jnp.clip(out.color, 0, 1)
    mask = jlosses.compute_grad_mask(gt_image.mean(axis=0, keepdims=True),
                                     1.1, "replica")
    T0 = se3_exp(jnp.asarray(TAU0))
    r = jtr.track_frame_pyr(
        gm, cam, T0[:3, :3], T0[:3, 3], gt_image, out.depth, mask,
        jnp.zeros(3), interpret=True, kernel_bf16=True, kernel_mxu=True,
        **TRACK_KW)
    res.update(track_R=np.asarray(r[0]), track_t=np.asarray(r[1]),
               track_iters=np.asarray(r[4]), gt_image=np.asarray(gt_image),
               gt_depth=np.asarray(out.depth), mask=np.asarray(mask),
               T0=np.asarray(T0))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref_bf16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mxu") / "jref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), path],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the compositing bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scene", "early_exit"])
@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(True, False), (True, True), (False, False)])
def test_plain_mxu_forward_matches_pallas(name, with_ntouch, nt_weight):
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
    from test_torch_composite import _feat_ranges

    sc, cap = _scene(name)
    W, H = sc["W"], sc["H"]
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc, capacity=cap)
    img, nt_j = jtk._fwd_impl(jnp.asarray(feat), jnp.asarray(ranges), n_tx,
                              n_ty, W, H, interpret=True,
                              with_ntouch=with_ntouch, nt_weight=nt_weight,
                              mxu=True)
    asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
    before = ttk.composite32_fwd.launches_mxu
    out = ttk.composite32(_t(feat), _t(ranges), n_tx, n_ty, W, H,
                          with_ntouch, nt_weight, mxu=True)
    assert ttk.composite32_fwd.launches_mxu == before   # CPU: plain version
    np.testing.assert_allclose(out.color_sum.numpy(), asm[0:3], atol=3e-5)
    np.testing.assert_allclose(out.depth_sum.numpy(), asm[3], atol=2e-4)
    np.testing.assert_allclose(out.final_T.numpy(), asm[4], atol=3e-5)
    np.testing.assert_array_equal(out.n_touched_pairs.numpy(),
                                  np.asarray(nt_j))
    assert float(out.final_T.min()) < 0.5          # a non-trivial image
    if with_ntouch:
        assert float(out.n_touched_pairs.sum()) > 0
    if name == "early_exit":
        # some tile left before its last chunk, in both
        chunks = np.asarray(jtk.chunk_stats_from_img(img, n_tx, n_ty))
        n_chunks = (ranges[:, 1] - ranges[:, 0] + 127) // 128
        assert (chunks.reshape(-1) < n_chunks).any()


@pytest.mark.parametrize("name", ["scene", "early_exit"])
def test_plain_walk_counts_passed_cells(name):
    """plain_walk's third output, the (pair, pixel) cells that pass the
    skip tests while their pixel is not done (what the mxu bound charges
    the log-space prefix to): under f32 it is the backward walk's included
    cells (the same arithmetic) plus at most one terminating cell a pixel,
    at most the walked cells; the mxu walk's count agrees with it within
    1% (the two powers differ by rounding only)."""
    from test_torch_composite import _feat_ranges

    sc, cap = _scene(name)
    W, H = sc["W"], sc["H"]
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc, capacity=cap)
    feat, ranges = _t(feat), _t(ranges)
    out, walked, passed = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H)
    cot = torch.ones(5, H, W)
    _, _, included = ttk.plain_bwd_walk(
        feat, ranges, out.color_sum, out.depth_sum, out.final_T, cot[0:3],
        cot[3], cot[4], n_tx, n_ty, W, H)
    passed, included = int(passed), int(included)
    assert included <= passed <= included + W * H
    assert passed <= int(walked.sum()) * ttk.TPX * ttk.TPY
    if name == "early_exit":   # the opaque front stops most pixels
        assert passed - included > W * H // 2
    _, _, passed_mxu = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H,
                                      mxu=True)
    assert abs(int(passed_mxu) - passed) <= 0.01 * passed


def _check_rows(got, ref, plan):
    for col in range(ttk.N_ROWS):
        a = ref[:, col]
        np.testing.assert_allclose(got[:, col], a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=f"column {col}")
    assert not got[:, 10:].any() and not ref[:, 10:].any()
    np.testing.assert_array_equal(~got.any(axis=1), ~ref.any(axis=1))
    dead = np.asarray(plan.pair_gid1) == 0 if plan is not None else None
    if dead is not None:
        assert (~ref.any(axis=1))[dead].all()


@pytest.mark.parametrize("name", ["scene", "early_exit", "overflow"])
def test_plain_mxu_backward_matches_pallas(name):
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk

    (feat, ranges, n_tx, n_ty, W, H, plan, img, asm, cot,
     cot_img) = _bwd_inputs(name, jtk, jnp)
    if name == "overflow":
        assert int(plan.overflow) > 0
    ref = np.asarray(jtk._bwd_impl(jnp.asarray(feat), jnp.asarray(ranges),
                                   img, cot_img, n_tx, n_ty, W, H,
                                   interpret=True, mxu=True))
    before = ttk.composite32_bwd.launches_mxu
    got = ttk.composite32_bwd(
        _t(feat), _t(ranges), _t(asm[0:3]), _t(asm[3]), _t(asm[4]),
        _t(cot[0:3]), _t(cot[3]), _t(cot[4]), n_tx, n_ty, W, H,
        mxu=True).numpy()
    assert ttk.composite32_bwd.launches_mxu == before
    _check_rows(got, ref, plan)


@pytest.mark.parametrize("name", ["scene", "early_exit", "overflow"])
def test_plain_bf16_mxu_backward_matches_pallas(jref_bf16, name):
    """B2-bf16-mxu: the MXU falloff with the bfloat16 gradient products,
    against the JAX kernel rounding per operation (subprocess)."""
    r = {k: jref_bf16[f"{name}_{k}"] for k in ("feat", "ranges", "asm",
                                               "cot", "rows")}
    H, W = r["asm"].shape[1:]
    n_tx, n_ty = ttk.grid_dims(W, H)
    asm, cot = r["asm"], r["cot"]
    got = ttk.composite32_bwd(
        _t(r["feat"]), _t(r["ranges"]), _t(asm[0:3]), _t(asm[3]),
        _t(asm[4]), _t(cot[0:3]), _t(cot[3]), _t(cot[4]), n_tx, n_ty, W, H,
        bf16=True, mxu=True).numpy()
    _check_rows(got, r["rows"], None)
    # the bfloat16 products are applied: the rows move off the f32 mxu ones
    f32 = ttk.composite32_bwd(
        _t(r["feat"]), _t(r["ranges"]), _t(asm[0:3]), _t(asm[3]),
        _t(asm[4]), _t(cot[0:3]), _t(cot[3]), _t(cot[4]), n_tx, n_ty, W, H,
        mxu=True).numpy()
    assert np.abs(got[:, :5] - f32[:, :5]).max() > \
        1e-4 * np.abs(f32[:, :5]).max()


def test_mxu_power_tile_plain_matches_reference():
    """The falloff check chip_smoke.py makes on the card, on the CPU:
    ``mxu_power_tile_plain`` (unclamped G6 @ P6 of one chunk) against the
    reference's ``_mxu_power`` before its clamp; rows past the chunk
    zero."""
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
    from test_torch_composite import _feat_ranges

    sc, cap = _scene("scene")
    feat, ranges, n_tx, _, _ = _feat_ranges(sc, capacity=cap)
    tile = int(np.argmax(ranges[:, 1] - ranges[:, 0]))
    s, e = ranges[tile]
    n = min(int(e - s), 128)
    rows = feat[s:s + n]
    tx, ty = tile % n_tx, tile // n_tx
    got = ttk.mxu_power_tile_plain(_t(rows), tx, ty).numpy()
    px, py, _ = jtk._pixel_rows(ty, tx, sc["W"], sc["H"])
    cx, cy = tx * 32 + 15.5, ty * 32 + 15.5
    pxl, pyl = px - cx, py - cy
    P6 = jnp.concatenate([pxl * pxl, pxl * pyl, pyl * pyl, pxl, pyl,
                          jnp.ones_like(pxl)], axis=0)
    # the reference's block layout: lane q = s*128 + l is pixel (x, y) =
    # (l % 32, s*4 + l // 32), i.e. q = y * 32 + x as here
    ref_clamped = np.asarray(jtk._mxu_power(jnp.asarray(rows), cx, cy, P6))
    np.testing.assert_allclose(np.minimum(got[:n], 0.0), ref_clamped,
                               rtol=1e-5, atol=1e-4)
    assert got[:n].min() < -1.0 and not got[n:].any()


# ---------------------------------------------------------------------------
# render and tracker
# ---------------------------------------------------------------------------

def _render_scene():
    from test_renderer_ref import make_scene
    return make_scene(np.random.default_rng(0), n=40, W=160, H=64)


def _port_render(sc, tau, mxu):
    from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
    cov6 = tgm.build_cov3d(_t(sc["scales"]), _t(sc["quats"]))
    return trt.render(
        _t(sc["means"]), cov6, _t(sc["opac"]), _t(sc["shs"]), 3,
        _t(sc["w2c"]), _t(sc["proj"]), tau, sc["fx"], sc["fy"], sc["W"],
        sc["H"], sc["tanfovx"], sc["tanfovy"], torch.as_tensor(BG),
        pair_capacity=8192, need_n_touched=False, mxu=mxu, device="cpu")


def test_mxu_render_matches_jax():
    """render(mxu=True) against the reference's, and against the port's
    own f32 render at tests/test_renderer_tiled.py's mxu gates."""
    import jax
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
    from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt

    sc = _render_scene()
    cov6 = jgm.build_cov3d(jnp.asarray(sc["scales"]),
                           jnp.asarray(sc["quats"]))

    def jrender(tau):
        return jrt.render(
            jnp.asarray(sc["means"]), cov6, jnp.asarray(sc["opac"]),
            jnp.asarray(sc["shs"]), 3, jnp.asarray(sc["w2c"]),
            jnp.asarray(sc["proj"]), tau, sc["fx"], sc["fy"], sc["W"],
            sc["H"], sc["tanfovx"], sc["tanfovy"], jnp.asarray(BG),
            pair_capacity=8192, interpret=True, mxu=True,
            need_n_touched=False)

    def jloss(tau):
        o = jrender(tau)
        return jnp.mean(jnp.abs(o.color)) + 0.1 * jnp.mean(jnp.abs(o.depth))

    ref = jrender(jnp.zeros(6))
    g_ref = np.asarray(jax.grad(jloss)(jnp.zeros(6)))

    outs, grads = {}, {}
    for mxu in (True, False):
        tau = torch.zeros(6, requires_grad=True)
        o = _port_render(sc, tau, mxu)
        L = torch.mean(torch.abs(o.color)) + 0.1 * torch.mean(
            torch.abs(o.depth))
        (g,) = torch.autograd.grad(L, tau)
        outs[mxu], grads[mxu] = o, g.numpy()
    got = outs[True]
    for key in ("color", "depth", "opacity"):
        a = np.asarray(getattr(ref, key))
        np.testing.assert_allclose(getattr(got, key).detach().numpy(), a,
                                   rtol=2e-3, atol=2e-3 * np.abs(a).max(),
                                   err_msg=key)
    np.testing.assert_allclose(grads[True], g_ref, rtol=2e-3,
                               atol=2e-3 * np.abs(g_ref).max())
    # against the port's own f32 render
    f32 = outs[False]
    for key, tol in (("color", 1e-3), ("depth", 5e-3), ("opacity", 1e-3)):
        d = float((getattr(got, key) - getattr(f32, key)).abs().max())
        assert d <= tol, (key, d)
    rel = np.abs(grads[True] - grads[False]).max() / np.abs(
        grads[False]).max()
    assert rel < 2e-3, rel


def _track_args(gt_image, gt_depth, mask, T0):
    cam = Camera.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                        (H_T - 1) / 2, W_T, H_T, device="cpu")
    gm = tgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0,
                          device="cpu")
    T0 = _t(T0)
    return (gm, cam, T0[:3, :3], T0[:3, 3], _t(gt_image), _t(gt_depth),
            _t(mask), torch.zeros(3))


def test_track_frame_pyr_mxu_matches_jax():
    """B1'-mxu in every IRLS render and B1'-mxu + B2-mxu in the exact
    full-resolution iterations: the pose within 1e-4 of the JAX mxu
    tracker's, iterations within 1."""
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
    from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCam
    from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
    from gs_slam_analytica_jacobian_tpu.ops.lie import se3_exp
    from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
    from gs_slam_analytica_jacobian_tpu.slam import tracking as jtr

    cam = JCam.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                      (H_T - 1) / 2, W_T, H_T)
    gm = jgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0)
    out = japi.render(gm, cam, None, jnp.zeros(3), pair_capacity=CAP_T,
                      interpret=True)
    gt_image = jnp.clip(out.color, 0, 1)
    mask = jlosses.compute_grad_mask(gt_image.mean(axis=0, keepdims=True),
                                     1.1, "replica")
    T0 = se3_exp(jnp.asarray(TAU0))
    r = jtr.track_frame_pyr(gm, cam, T0[:3, :3], T0[:3, 3], gt_image,
                            out.depth, mask, jnp.zeros(3), interpret=True,
                            kernel_mxu=True, **TRACK_KW)
    counts = (ttk.composite32_fwd.launches_mxu,
              ttk.composite32_bwd.launches_mxu)
    res = ttr.track_frame_pyr(
        *_track_args(gt_image, out.depth, mask, T0), kernel_mxu=True,
        device="cpu", **TRACK_KW)
    assert counts == (ttk.composite32_fwd.launches_mxu,
                      ttk.composite32_bwd.launches_mxu)
    np.testing.assert_allclose(res[0].numpy(), np.asarray(r[0]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(res[1].numpy(), np.asarray(r[1]), atol=1e-4,
                               rtol=0)
    assert abs(int(res[4]) - int(r[4])) <= 1
    assert np.linalg.norm(res[1].numpy()) < 5e-3       # it tracked


def test_track_frame_pyr_bf16_mxu_matches_jax(jref_bf16):
    """kernel_mxu beside kernel_bf16 (the MXU falloff, the backward's
    bfloat16 products) against the JAX tracker rounding per operation."""
    j = jref_bf16
    res = ttr.track_frame_pyr(
        *_track_args(j["gt_image"], j["gt_depth"], j["mask"], j["T0"]),
        kernel_mxu=True, kernel_bf16=True, device="cpu", **TRACK_KW)
    np.testing.assert_allclose(res[0].numpy(), j["track_R"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(res[1].numpy(), j["track_t"], atol=1e-4,
                               rtol=0)
    assert abs(int(res[4]) - int(j["track_iters"])) <= 1
    assert np.linalg.norm(res[1].numpy()) < 5e-3


if __name__ == "__main__":
    _jax_bf16_reference(sys.argv[1])

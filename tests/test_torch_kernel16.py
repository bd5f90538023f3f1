"""The 16x16 compositing module of the port (ops/tile_kernel16.py) and the
``tile16`` renderer vs the JAX reference (Pallas kernels in interpret
mode), on the same scenes:

- the 16-px plan (radius pad, conic cull, opa_growth) at 72x40, where
  neither edge is a multiple of 32: pair_gid1, ranges and the counts
  bit-equal to JAX's ``make_plan(tile16=True)``;
- ``composite16_plain`` vs JAX ``composite16`` with and without n_touched
  and under ``nt_weight``: color atol 3e-5, depth 2e-4, T 3e-5 (the
  tolerances of tests/test_renderer_tiled.py), n_touched exactly;
- ``composite16_bwd_plain`` vs JAX ``_bwd_impl16``: rtol 2e-3 per column
  (the B2 tolerance), the same rows zero;
- the port's ``render(tile16=True)`` vs its ``render(tile16=False)`` on
  fresh plans: every output within 1e-5, n_touched exactly, where no
  depths tie; on a dense room map, bit for bit once the plans are
  re-sorted on the full depth key (the reference's packed key ties depths
  more coarsely on the 16-px grid); and its
  gradients in tau, means, opacity and scales vs JAX's tile16 gradients
  (rtol 2e-3, atol 2e-5 + 2e-3 max, tests/test_renderer_tiled.py:91-120).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
(``cuda`` marker) holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import pair_gather as jpg
from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel16 as jtk16
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel16 as ttk16
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api as tapi

from chip_smoke import resort_full_depth_key
from test_renderer_ref import make_scene

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def T(x):
    return torch.as_tensor(np.array(x))


def _preps(sc):
    jargs = (jnp.asarray(sc["means"]),
             jgm.build_cov3d(jnp.asarray(sc["scales"]),
                             jnp.asarray(sc["quats"])),
             jnp.asarray(sc["opac"]), jnp.asarray(sc["shs"]), 3,
             jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]), jnp.zeros(6),
             sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
             sc["tanfovy"])
    targs = [T(a) if isinstance(a, (np.ndarray, jax.Array)) else a
             for a in jargs]
    return jgm.preprocess(*jargs), tgm.preprocess(*targs)


def _plans(sc, cap=8192, **kw):
    prep_j, prep_t = _preps(sc)
    plan_j = jrt.make_plan(prep_j, sc["W"], sc["H"], cap, tile16=True, **kw)
    plan_t = trt.make_plan(prep_t, sc["W"], sc["H"], cap, tile16=True, **kw)
    feat = np.array(jpg.pair_gather(jrt.pack_table(prep_j), plan_j))
    return plan_j, plan_t, feat, prep_t


@pytest.mark.parametrize("kw", [dict(), dict(radius_scale=1.1,
                                             radius_pad=6.0,
                                             opa_growth=2.23)])
def test_plan16_bit_equal_to_jax(kw):
    sc = make_scene(np.random.default_rng(5), n=60, W=72, H=40)
    plan_j, plan_t, feat, prep_t = _plans(sc, **kw)
    n_gx, n_gy = ttk16.grid_dims16(72, 40)
    assert (n_gx, n_gy) == (3, 2)
    # a 6 x 4 grid of 16-px tiles, not ceil(72/16) x ceil(40/16) = 5 x 3
    assert plan_t.ranges.shape == (4 * n_gx * n_gy, 2)
    for f in ("pair_gid1", "ranges", "aligned_of_em", "seg_start", "seg_end",
              "num_pairs", "overflow", "num_kept"):
        np.testing.assert_array_equal(getattr(plan_t, f).numpy(),
                                      np.asarray(getattr(plan_j, f)),
                                      err_msg=f)
    assert int(plan_t.num_pairs) > 0
    # the gathered pair rows agree as well
    got = pair_gather(trt.pack_table(prep_t), plan_t).numpy()
    np.testing.assert_allclose(got, feat, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_composite16_plain_matches_jax(with_ntouch, nt_weight):
    sc = make_scene(np.random.default_rng(3), n=80, W=72, H=40)
    W, H = sc["W"], sc["H"]
    plan_j, plan_t, feat, _ = _plans(sc)
    n_gx, n_gy = ttk16.grid_dims16(W, H)
    ranges = np.asarray(plan_j.ranges)
    img, nt_j = jtk16._fwd_impl16(jnp.asarray(feat), jnp.asarray(ranges),
                                  n_gx, n_gy, W, H, interpret=True,
                                  with_ntouch=with_ntouch,
                                  nt_weight=nt_weight)
    asm = np.asarray(jtk16.assemble_image16(img, n_gx, n_gy, W, H))
    wrap = (ttk16.composite16_fwd_ntouch if with_ntouch
            else ttk16.composite16_fwd)
    before = wrap.launches
    out = ttk16.composite16(T(feat), T(ranges), n_gx, n_gy, W, H,
                            with_ntouch, nt_weight)
    assert wrap.launches == before          # CPU: the plain version
    np.testing.assert_allclose(out.color_sum.numpy(), asm[0:3], atol=3e-5)
    np.testing.assert_allclose(out.depth_sum.numpy(), asm[3], atol=2e-4)
    np.testing.assert_allclose(out.final_T.numpy(), asm[4], atol=3e-5)
    np.testing.assert_array_equal(out.n_touched_pairs.numpy(),
                                  np.asarray(nt_j))
    if with_ntouch:
        assert out.n_touched_pairs.sum() > 0
    assert float(asm[4].min()) < 0.5       # the scene covers pixels


def test_composite16_bwd_plain_matches_jax():
    sc = make_scene(np.random.default_rng(11), n=60, W=72, H=40)
    W, H = sc["W"], sc["H"]
    plan_j, _, feat, _ = _plans(sc)
    n_gx, n_gy = ttk16.grid_dims16(W, H)
    ranges = np.asarray(plan_j.ranges)
    img, _ = jtk16._fwd_impl16(jnp.asarray(feat), jnp.asarray(ranges), n_gx,
                               n_gy, W, H, interpret=True, with_ntouch=False)
    asm = np.asarray(jtk16.assemble_image16(img, n_gx, n_gy, W, H))
    cot = np.random.default_rng(7).normal(size=(5, H, W)).astype(np.float32)
    cot_img = jtk16.disassemble_image16(jnp.asarray(cot), n_gx, n_gy)
    ref = np.asarray(jtk16._bwd_impl16(jnp.asarray(feat), jnp.asarray(ranges),
                                       img, cot_img, n_gx, n_gy, W, H,
                                       interpret=True))
    got = ttk16.composite16_bwd(
        T(feat), T(ranges), T(asm[0:3]), T(asm[3]), T(asm[4]), T(cot[0:3]),
        T(cot[3]), T(cot[4]), n_gx, n_gy, W, H).numpy()
    assert ttk16.composite16_bwd.launches == 0
    for col in range(10):
        a = ref[:, col]
        assert np.abs(a).max() > 0, col
        np.testing.assert_allclose(got[:, col], a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=f"column {col}")
    assert not got[:, 10:].any()
    np.testing.assert_array_equal(~got.any(axis=1), ~ref.any(axis=1))


def _render_args(sc, tau, means, opac, scales, lib):
    """Positional render arguments in package ``lib`` (jnp or torch)."""
    if lib is jnp:
        cov = jgm.build_cov3d(scales, jnp.asarray(sc["quats"]))
        arr = jnp.asarray
    else:
        cov = tgm.build_cov3d(scales, T(sc["quats"]))
        arr = T
    return (means, cov, opac, arr(sc["shs"]), 3, arr(sc["w2c"]),
            arr(sc["proj"]), tau, sc["fx"], sc["fy"], sc["W"], sc["H"],
            sc["tanfovx"], sc["tanfovy"])


def test_render_tile16_equals_tile32():
    """On fresh, conic-culled plans each pixel composites the same pairs in
    the same order at both tile sizes, so the renders agree."""
    sc = make_scene(np.random.default_rng(4), n=60, W=88, H=56)
    bg = torch.tensor([0.1, 0.2, 0.3])
    args = _render_args(sc, torch.zeros(6), T(sc["means"]), T(sc["opac"]),
                        T(sc["scales"]), torch)
    o32, o16 = (trt.render(*args, bg, pair_capacity=8192, tile16=t16,
                           device="cpu") for t16 in (False, True))
    for name in ("color", "depth", "opacity", "final_T"):
        np.testing.assert_allclose(getattr(o16, name).numpy(),
                                   getattr(o32, name).numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(o16.n_touched.numpy(), o32.n_touched.numpy())
    assert int(o16.n_touched.sum()) > 0


def test_render_tile16_vs_tile32_depth_key():
    """Where the renders part: on a dense room map the reference's packed
    int32 sort key keeps 2 fewer depth bits on the 16-px grid (4x the
    tiles), so splats whose truncated depths tie composite in emission
    order there and the renders differ; re-sorted on the full depth key
    (chip_smoke.resort_full_depth_key) the two tile sizes agree bit for
    bit, n_touched included."""
    W, H = 312, 180
    gm = tgmap.from_numpy(**make_room_map(20000, np.random.default_rng(1)),
                          max_sh_degree=0, device="cpu")
    cam = Camera.create(np.eye(3), np.array([0.05, -0.02, 0.1]), W / 2,
                        W / 2, (W - 1) / 2, (H - 1) / 2, W, H, device="cpu")
    prep = tgm.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6), cam.fx, cam.fy, W, H,
        cam.tanfovx, cam.tanfovy)
    outs = {}
    for full in (False, True):
        for t16 in (False, True):
            plan = trt.make_plan(prep, W, H, 1 << 18, active=gm.active,
                                 tile16=t16)
            if full:
                plan = resort_full_depth_key(plan, prep.depth)
            outs[full, t16] = tapi.render(gm, cam, None, torch.zeros(3),
                                          plan=plan, tile16=t16,
                                          device="cpu")
    packed = (outs[False, False].color - outs[False, True].color).abs()
    assert float((packed > 1e-5).float().mean()) > 1e-3
    for name in ("color", "depth", "opacity"):
        assert torch.equal(getattr(outs[True, False], name),
                           getattr(outs[True, True], name)), name
    assert torch.equal(outs[True, False].n_touched,
                       outs[True, True].n_touched)


def test_render_tile16_gradients_match_jax():
    sc = make_scene(np.random.default_rng(9), n=15, W=144, H=32)
    bg = np.array([0.05, 0.1, 0.15], np.float32)
    rng = np.random.default_rng(2)
    target = rng.uniform(size=(3, sc["H"], sc["W"])).astype(np.float32)
    tgt_d = rng.uniform(size=(1, sc["H"], sc["W"])).astype(np.float32) * 3

    def loss_j(tau, means, opac, scales):
        out = jrt.render(*_render_args(sc, tau, means, opac, scales, jnp),
                         jnp.asarray(bg), pair_capacity=4096, interpret=True,
                         tile16=True)
        return (jnp.mean(jnp.abs(out.color - target))
                + 0.2 * jnp.mean(jnp.abs(out.depth - tgt_d))
                + 0.1 * jnp.mean(out.opacity))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        jnp.zeros(6), jnp.asarray(sc["means"]), jnp.asarray(sc["opac"]),
        jnp.asarray(sc["scales"]))
    xs = [torch.zeros(6, requires_grad=True)] + [
        T(sc[k]).requires_grad_() for k in ("means", "opac", "scales")]
    before = ttk16.composite16_bwd.launches
    out = trt.render(*_render_args(sc, *xs, torch), T(bg),
                     pair_capacity=4096, tile16=True, device="cpu")
    L = (torch.mean(torch.abs(out.color - T(target)))
         + 0.2 * torch.mean(torch.abs(out.depth - T(tgt_d)))
         + 0.1 * torch.mean(out.opacity))
    g_t = torch.autograd.grad(L, xs)
    assert ttk16.composite16_bwd.launches == before
    for a, b, name in zip(g_j, g_t, ["tau", "means", "opac", "scales"]):
        a, b = np.asarray(a), b.numpy()
        assert np.all(np.isfinite(b)), name
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(b, a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=name)

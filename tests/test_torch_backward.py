"""The renderer backward: the port's plain backward compositing
(``composite32_bwd_plain``, what ``composite32_bwd`` runs on CPU tensors)
against the JAX Pallas backward kernel in interpret mode, the gather's
backward against ``jax.vjp``, and whole-render gradients against
``jax.grad`` of the JAX tiled renderer.

Tolerances: per-pair rows rtol 2e-3, atol 2e-5 + 2e-3 max|column| (the
tolerance of tests/test_renderer_tiled.py:72; the port walks a chunk pair
by pair where the TPU kernel scans, and sums each row over the tile's
pixels in another order); rows of dead slots, skipped pairs and pairs
after a tile's early exit, and columns 10-15, exactly zero in both. The
gather's backward atol 1e-6. Render gradients: the loss and tolerances of
tests/test_renderer_tiled.py:40-72.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
(``cuda`` marker) holds it against the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import pair_gather as jpg
from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import pair_gather as tpg
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk

from test_renderer_ref import make_scene
from test_torch_composite import _feat_ranges, _opaque_front

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def _scene(name):
    if name == "scene":
        return make_scene(np.random.default_rng(11), n=40, W=160, H=72), 8192
    if name == "early_exit":
        return _opaque_front(np.random.default_rng(5)), 8192
    return make_scene(np.random.default_rng(64), n=64, W=256, H=64), 128


def _planes(feat, ranges, n_tx, n_ty, W, H, seed):
    """The JAX forward image (block layout and assembled) and a seeded
    cotangent (assembled and disassembled)."""
    img, _ = jtk._fwd_impl(jnp.asarray(feat), jnp.asarray(ranges), n_tx,
                           n_ty, W, H, interpret=True, with_ntouch=False)
    asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
    cot = np.random.default_rng(seed).normal(size=(5, H, W)).astype(
        np.float32)
    cot_img = jtk.disassemble_image(jnp.asarray(cot), n_tx, n_ty)
    return img, asm, cot, cot_img


def _port_bwd(feat, ranges, asm, cot, n_tx, n_ty, W, H):
    def t(a):
        return torch.as_tensor(np.array(a))
    return ttk.composite32_bwd(
        t(feat), t(ranges), t(asm[0:3]), t(asm[3]), t(asm[4]), t(cot[0:3]),
        t(cot[3]), t(cot[4]), n_tx, n_ty, W, H).numpy()


@pytest.mark.parametrize("name", ["scene", "early_exit", "overflow"])
def test_plain_backward_matches_pallas(name):
    sc, cap = _scene(name)
    W, H = sc["W"], sc["H"]
    feat, ranges, n_tx, n_ty, plan = _feat_ranges(sc, capacity=cap)
    if name == "overflow":
        assert int(plan.overflow) > 0
    img, asm, cot, cot_img = _planes(feat, ranges, n_tx, n_ty, W, H, 7)
    ref = np.asarray(jtk._bwd_impl(jnp.asarray(feat), jnp.asarray(ranges),
                                   img, cot_img, n_tx, n_ty, W, H,
                                   interpret=True))
    got = _port_bwd(feat, ranges, asm, cot, n_tx, n_ty, W, H)
    assert ttk.composite32_bwd.launches == 0      # CPU: the plain version

    for col in range(ttk.N_ROWS):
        a = ref[:, col]
        np.testing.assert_allclose(got[:, col], a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=f"column {col}")
    assert not got[:, 10:].any() and not ref[:, 10:].any()
    # the same rows are exactly zero in both ...
    zero_ref = ~ref.any(axis=1)
    np.testing.assert_array_equal(~got.any(axis=1), zero_ref)
    # ... among them every dead slot and every row outside the ranges
    dead = np.asarray(plan.pair_gid1) == 0
    assert zero_ref[dead].all() and (~dead & zero_ref).any()
    in_range = np.zeros(len(feat), bool)
    for s, e in ranges:
        in_range[s:e] = True
    assert zero_ref[~in_range].all()
    if name == "early_exit":
        # pairs after a tile's exit chunk were never reached
        chunks = np.asarray(jtk.chunk_stats_from_img(img, n_tx, n_ty))
        chunks = chunks.reshape(-1).astype(int)
        n_chunks = (ranges[:, 1] - ranges[:, 0] + 127) // 128
        early = np.flatnonzero(chunks < n_chunks)
        assert early.size
        for t in early:
            s = ranges[t, 0] + chunks[t] * 128
            assert not got[s:ranges[t, 1]].any()


def test_plain_backward_matches_autograd_of_plain_forward():
    """JAX-independent: where no alpha reaches the 0.99 cap and no pixel
    terminates, the analytic backward equals torch autograd through the
    plain forward (the clamp and the termination are the only places
    where the two differ by design)."""
    sc = make_scene(np.random.default_rng(21), n=24, W=96, H=64)
    sc["opac"] = sc["opac"] * 0.6
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc)
    W, H = sc["W"], sc["H"]
    f = torch.as_tensor(feat).requires_grad_()
    r = torch.as_tensor(ranges)
    out = ttk.composite32_plain(f, r, n_tx, n_ty, W, H, with_ntouch=False)
    assert float(f.detach()[:, 5].max()) < 0.99
    assert float(out.final_T.detach().min()) > 1e-2   # no pixel terminates
    cot = torch.as_tensor(np.random.default_rng(4).normal(
        size=(5, H, W)).astype(np.float32))
    L = ((out.color_sum * cot[0:3]).sum() + (out.depth_sum * cot[3]).sum()
         + (out.final_T * cot[4]).sum())
    (g_auto,) = torch.autograd.grad(L, f)
    with torch.no_grad():
        g = ttk.composite32_bwd_plain(
            f.detach(), r, out.color_sum.detach(), out.depth_sum.detach(),
            out.final_T.detach(), cot[0:3], cot[3], cot[4], n_tx, n_ty, W,
            H)
    assert float(g[:, :10].abs().sum()) > 0
    for col in range(16):
        a = g_auto[:, col].numpy()
        np.testing.assert_allclose(g[:, col].numpy(), a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max(),
                                   err_msg=f"column {col}")


def test_composite32_autograd_function():
    """composite32's backward hands the output cotangents (zeros for the
    ones that got none) to composite32_bwd."""
    sc, cap = _scene("scene")
    W, H = sc["W"], sc["H"]
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc, capacity=cap)
    f = torch.as_tensor(feat).requires_grad_()
    r = torch.as_tensor(ranges)
    out = ttk.composite32(f, r, n_tx, n_ty, W, H, with_ntouch=True)
    assert not out.n_touched_pairs.requires_grad
    dD = torch.as_tensor(np.random.default_rng(2).normal(size=(H, W)).astype(
        np.float32))
    (g,) = torch.autograd.grad((out.depth_sum * dD).sum(), f)
    z = torch.zeros(3, H, W)
    want = ttk.composite32_bwd_plain(
        f.detach(), r, out.color_sum.detach(), out.depth_sum.detach(),
        out.final_T.detach(), z, dD, torch.zeros(H, W), n_tx, n_ty, W, H)
    assert torch.equal(g, want)
    assert float(g[:, 9].abs().sum()) > 0 and not g[:, 6:9].any()


def test_pair_gather_backward_matches_jax_vjp():
    sc, cap = _scene("overflow")
    prep = jgm.preprocess(
        jnp.asarray(sc["means"]),
        jgm.build_cov3d(jnp.asarray(sc["scales"]), jnp.asarray(sc["quats"])),
        jnp.asarray(sc["opac"]), jnp.asarray(sc["shs"]), 3,
        jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]), jnp.zeros(6),
        sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"], sc["tanfovy"])
    table = np.asarray(jrt.pack_table(prep))
    _, _, _, _, plan_j = _feat_ranges(sc, capacity=cap)
    plan_t = _torch_plan(plan_j)
    # multiples of 2^-10 in [-1, 1): every partial sum is exact in f32, so
    # the two cumsums agree whatever order they add in, and the check is
    # of which rows land on which Gaussian
    dfeat = (np.random.default_rng(9).integers(
        -1024, 1024, size=(plan_j.pair_gid1.shape[0], table.shape[1]))
        / 1024.0).astype(np.float32)
    _, vjp = jax.vjp(lambda tb: jpg.pair_gather(tb, plan_j),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(dfeat))
    tb = torch.tensor(table, requires_grad=True)
    out = tpg.pair_gather(tb, plan_t)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jpg.pair_gather(
                                      jnp.asarray(table), plan_j)))
    (got,) = torch.autograd.grad(out, tb, torch.as_tensor(dfeat))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def _torch_plan(plan_j):
    from gs_slam_analytica_jacobian_tpu_torch.ops.binning2 import PairPlan
    return PairPlan(*[torch.as_tensor(np.array(x)) for x in plan_j])


def _render_loss_args(sc):
    cov6 = np.asarray(jgm.build_cov3d(jnp.asarray(sc["scales"]),
                                      jnp.asarray(sc["quats"])))
    return (np.zeros(6, np.float32), np.array(sc["means"]), cov6,
            np.array(sc["opac"]), np.array(sc["shs"]))


def test_render_gradients_match_jax():
    """d loss / d (tau, means, cov6, opacities, SH) through the whole
    tiled render: the port's autograd vs jax.grad of the JAX renderer."""
    rng = np.random.default_rng(17)
    sc = make_scene(rng, n=15, W=144, H=32)
    W, H = sc["W"], sc["H"]
    bg = np.array([0.05, 0.1, 0.15], np.float32)
    target = rng.uniform(size=(3, H, W)).astype(np.float32)
    tgt_d = rng.uniform(size=(1, H, W)).astype(np.float32) * 3
    rest = (sc["fx"], sc["fy"], W, H, sc["tanfovx"], sc["tanfovy"])
    args = _render_loss_args(sc)

    def jloss(tau, means, cov6, opac, shs):
        out = jrt.render(means, cov6, opac, shs, 3, jnp.asarray(sc["w2c"]),
                         jnp.asarray(sc["proj"]), tau, *rest,
                         jnp.asarray(bg), pair_capacity=4096, interpret=True)
        return (jnp.mean(jnp.abs(out.color - target))
                + 0.2 * jnp.mean(jnp.abs(out.depth - tgt_d))
                + 0.1 * jnp.mean(out.opacity))

    g_ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tau, means, cov6, opac, shs = targs
    out = trt.render(means, cov6, opac, shs, 3, torch.as_tensor(sc["w2c"]),
                     torch.as_tensor(sc["proj"]), tau, *rest,
                     torch.as_tensor(bg), pair_capacity=4096, device="cpu")
    L = ((out.color - torch.as_tensor(target)).abs().mean()
         + 0.2 * (out.depth - torch.as_tensor(tgt_d)).abs().mean()
         + 0.1 * out.opacity.mean())
    g_til = torch.autograd.grad(L, targs)
    for a, b, name in zip(g_ref, g_til,
                          ["tau", "means", "cov6", "opac", "shs"]):
        a, b = np.asarray(a), b.numpy()
        assert np.all(np.isfinite(b)), name
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(
            b, a, rtol=2e-3, atol=2e-5 + 2e-3 * np.abs(a).max(),
            err_msg=name)


def test_gradients_finite_with_subthreshold_opacity():
    """A Gaussian with opacity < 1/255 has an empty cull box (q = 0). The
    render's gradients stay finite, and so do those of its cull extents
    (radius, radius_xy): as in the reference they are stop-gradients
    there, with a zero derivative, where sqrt's backward at q = 0 would
    otherwise give 0 * inf = NaN."""
    rng = np.random.default_rng(13)
    sc = make_scene(rng, n=12, W=96, H=48)
    sc["opac"][3] = 0.002
    sc["opac"][7] = 1e-6
    args = _render_loss_args(sc)
    rest = (sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
            sc["tanfovy"])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tau, means, cov6, opac, shs = targs
    w2c, proj = torch.as_tensor(sc["w2c"]), torch.as_tensor(sc["proj"])
    out = trt.render(means, cov6, opac, shs, 3, w2c, proj, tau, *rest,
                     torch.zeros(3), pair_capacity=4096, device="cpu")
    prep = tgm.preprocess(means, cov6, opac, shs, 3, w2c, proj, tau, *rest)
    assert not bool(prep.valid[3]) and not bool(prep.valid[7])
    L = (out.color.abs().mean() + out.depth.mean()
         + prep.radius_xy.sum() + prep.radius.sum() + prep.mean2d.sum())
    grads = torch.autograd.grad(L, targs)
    for g, name in zip(grads, ["tau", "means", "cov6", "opac", "shs"]):
        assert bool(torch.isfinite(g).all()), name
    # the extents contribute nothing, as jax.grad says of the reference
    jargs = [jnp.asarray(a) for a in args]

    def jext(tau, means, cov6, opac, shs):
        p = jgm.preprocess(means, cov6, opac, shs, 3, jnp.asarray(sc["w2c"]),
                           jnp.asarray(sc["proj"]), tau, *rest)
        return jnp.sum(p.radius_xy) + jnp.sum(p.radius)

    for a in jax.grad(jext, argnums=(0, 1, 2, 3, 4))(*jargs):
        assert not np.asarray(a).any()
    assert not prep.radius_xy.requires_grad and not prep.radius.requires_grad

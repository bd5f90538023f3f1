"""GPU tests of the port (``cuda`` marker): the CUDA compositing kernels
(forward and backward, 32x32 and 16x16, and the bf16 and mxu bodies of
the 32x32 ones) and the B5 ablation kernels against their plain PyTorch
versions, alone and inside a full render and its gradients.

They skip without a GPU. On a machine with one (where JAX need not be
installed) run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports no JAX."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel16 as tk16
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as tk
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render

from chip_smoke import mxu_gate_failure, resort_full_depth_key

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _room(device, n=20000, W=320, H=180):
    gm = gmap.from_numpy(**make_room_map(n, np.random.default_rng(1)),
                         max_sh_degree=0, device=device)
    cam = Camera.create(np.eye(3), np.array([0.05, -0.02, 0.1]), W / 2,
                        W / 2, (W - 1) / 2, (H - 1) / 2, W, H, device=device)
    return gm, cam


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_kernel_bitwise_matches_plain(cuda, with_ntouch, nt_weight):
    gm, cam = _room(cuda)
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=cuda), cam.fx,
        cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    plan = make_plan(prep, cam.width, cam.height, 1 << 18, radius_pad=2.0)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    n_tx, n_ty = tk.grid_dims(cam.width, cam.height)
    before = (tk.composite32_fwd.launches, tk.composite32_fwd_ntouch.launches)
    got = tk.composite32(feat, plan.ranges, n_tx, n_ty, cam.width,
                         cam.height, with_ntouch, nt_weight)
    ref = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, cam.width,
                               cam.height, with_ntouch, nt_weight)
    torch.cuda.synchronize()
    after = (tk.composite32_fwd.launches, tk.composite32_fwd_ntouch.launches)
    assert after[int(with_ntouch)] == before[int(with_ntouch)] + 1
    # built without multiply-add contraction: identical arithmetic
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


def test_render_on_gpu_matches_cpu(cuda):
    """The whole forward path (preprocess, plan, gather, kernel) on the
    card against the same render on the CPU (plain kernel version)."""
    gm_g, cam_g = _room(cuda, n=5000, W=160, H=96)
    gm_c, cam_c = _room("cpu", n=5000, W=160, H=96)
    out_g = render(gm_g, cam_g, None, torch.zeros(3, device=cuda),
                   pair_capacity=1 << 16, device=cuda)
    out_c = render(gm_c, cam_c, None, torch.zeros(3), pair_capacity=1 << 16,
                   device="cpu")
    torch.cuda.synchronize()
    for name in ("color", "depth", "opacity"):
        a, b = getattr(out_g, name).cpu(), getattr(out_c, name)
        assert torch.allclose(a, b, atol=1e-4), name
    nt_g, nt_c = out_g.n_touched.cpu(), out_c.n_touched
    assert int((nt_g != nt_c).sum()) <= max(1, int(1e-3 * nt_c.numel()))
    assert int(out_g.overflow) == 0


def test_backward_kernel_matches_plain(cuda):
    """B2 against composite32_bwd_plain on the card: the walk is the same
    arithmetic (no multiply-add contraction); only the order in which a
    row is summed over the tile's pixels differs."""
    gm, cam = _room(cuda)
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=cuda), cam.fx,
        cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    plan = make_plan(prep, cam.width, cam.height, 1 << 18, radius_pad=2.0)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    n_tx, n_ty = tk.grid_dims(cam.width, cam.height)
    W, H = cam.width, cam.height
    fwd = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch=False)
    g = torch.Generator(device=cuda).manual_seed(0)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, plan.ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    before = tk.composite32_bwd.launches
    got = tk.composite32_bwd(*args)
    ref = tk.composite32_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tk.composite32_bwd.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, 10:].any())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert scale > 0, col
        assert float((got[:, col] - ref[:, col]).abs().max()) \
            <= 1e-4 * scale, col
    # the same rows are exactly zero
    assert torch.equal(got.any(dim=1), ref.any(dim=1))


def test_render_gradients_on_gpu_match_cpu(cuda):
    """d loss / d (tau, means, opacities) through the whole tiled render
    on the card (both kernels) against the same on the CPU (plain
    versions)."""
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        gm, cam = _room(dev, n=5000, W=160, H=96)
        xyz = gm.xyz.clone().requires_grad_()
        opa = gm.get_opacity().detach().clone().requires_grad_()
        tau = torch.zeros(6, device=dev, requires_grad=True)
        out = renderer_tiled.render(
            xyz, gm.get_cov6(), opa, gm.get_features(), 0, cam.w2c(),
            cam.projection(), tau, cam.fx, cam.fy, cam.width, cam.height,
            cam.tanfovx, cam.tanfovy, torch.zeros(3, device=dev),
            active=gm.active, pair_capacity=1 << 16, need_n_touched=False,
            device=dev)
        L = out.color.abs().mean() + 0.1 * out.depth.mean() \
            + 0.05 * out.opacity.mean()
        grads[dev.type] = [x.cpu() for x in torch.autograd.grad(
            L, (tau, xyz, opa))]
    torch.cuda.synchronize()
    for a, b, name in zip(grads["cuda"], grads["cpu"],
                          ("tau", "means", "opac")):
        assert bool(torch.isfinite(a).all()), name
        scale = float(b.abs().max())
        assert scale > 0, name
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3 * scale), name


def _plan16(gm, cam, dev):
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=dev), cam.fx,
        cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    plan = make_plan(prep, cam.width, cam.height, 1 << 18, radius_pad=2.0,
                     tile16=True)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    return feat, plan, tk16.grid_dims16(cam.width, cam.height)


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_kernel16_bitwise_matches_plain(cuda, with_ntouch, nt_weight):
    """B3' / B3 against composite16_plain on a 16-px plan whose grid
    (2*ceil(W/32) x 2*ceil(H/32)) holds a tile column past the image."""
    gm, cam = _room(cuda, W=312, H=180)
    feat, plan, (n_gx, n_gy) = _plan16(gm, cam, cuda)
    W, H = cam.width, cam.height
    wrappers = (tk16.composite16_fwd, tk16.composite16_fwd_ntouch)
    before = [f.launches for f in wrappers]
    got = tk16.composite16(feat, plan.ranges, n_gx, n_gy, W, H, with_ntouch,
                           nt_weight)
    ref = tk16.composite16_plain(feat, plan.ranges, n_gx, n_gy, W, H,
                                 with_ntouch, nt_weight)
    torch.cuda.synchronize()
    assert wrappers[int(with_ntouch)].launches \
        == before[int(with_ntouch)] + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


def test_backward_kernel16_matches_plain(cuda):
    """B4 against composite16_bwd_plain: the same walk; only the order in
    which a row is summed over the tile's 256 pixels differs."""
    gm, cam = _room(cuda, W=312, H=180)
    feat, plan, (n_gx, n_gy) = _plan16(gm, cam, cuda)
    W, H = cam.width, cam.height
    fwd = tk16.composite16_plain(feat, plan.ranges, n_gx, n_gy, W, H,
                                 with_ntouch=False)
    g = torch.Generator(device=cuda).manual_seed(0)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, plan.ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_gx, n_gy, W, H)
    before = tk16.composite16_bwd.launches
    got = tk16.composite16_bwd(*args)
    ref = tk16.composite16_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tk16.composite16_bwd.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, 10:].any())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert scale > 0, col
        assert float((got[:, col] - ref[:, col]).abs().max()) \
            <= 1e-5 * scale, col
    assert torch.equal(got.any(dim=1), ref.any(dim=1))


def test_render_tile16_matches_tile32_on_gpu(cuda):
    """The same scene through the 16x16 and the 32x32 kernels on fresh,
    conic-culled plans re-sorted on the full depth key
    (chip_smoke.resort_full_depth_key): each pixel composites
    the same pairs in the same order, so the renders agree bit for bit,
    n_touched included. (With the reference's packed key the 16-px grid
    keeps 2 fewer depth bits, and depth-tied splats composite in emission
    order there; chip_smoke.py reports that difference.)"""
    gm, cam = _room(cuda, W=312, H=180)
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=cuda), cam.fx,
        cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    outs = []
    for t16 in (False, True):
        plan = resort_full_depth_key(
            make_plan(prep, cam.width, cam.height, 1 << 18,
                      active=gm.active, tile16=t16), prep.depth)
        outs.append(render(gm, cam, None, torch.zeros(3, device=cuda),
                           plan=plan, tile16=t16, device=cuda))
    torch.cuda.synchronize()
    for name in ("color", "depth", "opacity", "n_touched"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), \
            name
    assert int(outs[1].n_touched.sum()) > 0


def _room_rows(cuda):
    gm, cam = _room(cuda)
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=cuda), cam.fx,
        cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    plan = make_plan(prep, cam.width, cam.height, 1 << 18, radius_pad=2.0)
    feat = pair_gather(pack_table(prep), plan).contiguous()
    return feat, plan, cam


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_bf16_kernel_matches_plain(cuda, with_ntouch, nt_weight):
    """B1'-bf16 / B1-bf16 against composite32_plain(bf16=True) on the
    card: both round every bfloat16 operation once (__hmul_rn et al.
    against torch's per-op rounding) and share the f32 remainder, so the
    images agree bit for bit and bf16 is applied (they differ from f32)."""
    feat, plan, cam = _room_rows(cuda)
    W, H = cam.width, cam.height
    n_tx, n_ty = tk.grid_dims(W, H)
    wrapper = tk.composite32_fwd_ntouch if with_ntouch else tk.composite32_fwd
    before = (wrapper.launches, wrapper.launches_bf16)
    got = tk.composite32(feat, plan.ranges, n_tx, n_ty, W, H, with_ntouch,
                         nt_weight, bf16=True)
    ref = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch, nt_weight, bf16=True)
    f32 = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch, nt_weight)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == \
        (before[0], before[1] + 1)
    for a, b in zip(got[:3], ref[:3]):
        assert float((a - b).abs().max()) <= 1e-4
    live = int((plan.ranges[:, 1] - plan.ranges[:, 0]).sum())
    assert int((got.n_touched_pairs != ref.n_touched_pairs).sum()) \
        <= 1e-4 * live
    assert float((got.color_sum - f32.color_sum).abs().max()) > 1e-4


def test_bf16_backward_kernel_matches_plain(cuda):
    """B2-bf16 against composite32_bwd_plain(bf16=True) on the card: each
    column within 1e-5 of its max (only the pixel-sum order differs)."""
    feat, plan, cam = _room_rows(cuda)
    W, H = cam.width, cam.height
    n_tx, n_ty = tk.grid_dims(W, H)
    fwd = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch=False, bf16=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, plan.ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    before = tk.composite32_bwd.launches_bf16
    got = tk.composite32_bwd(*args, bf16=True)
    ref = tk.composite32_bwd_plain(*args, bf16=True)
    torch.cuda.synchronize()
    assert tk.composite32_bwd.launches_bf16 == before + 1
    assert bool(torch.isfinite(got).all())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert float((got[:, col] - ref[:, col]).abs().max()) \
            <= 1e-5 * scale, col
    assert torch.equal(got.any(dim=1), ref.any(dim=1))


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_mxu_kernel_matches_plain(cuda, with_ntouch, nt_weight):
    """B1'-mxu / B1-mxu against composite32_plain(mxu=True) on the card:
    the 3xTF32 tensor-core power against the plain f32 matmul differs by
    rounding, which a flipped 1/255 or T test can carry to one pixel:
    images within 1e-3 (depth 5e-3) but for 1e-5 of the values, each
    within what flipped tests can move (chip_smoke.py MXU_FLIP_TOL; on the
    H100 0-3 of 0.25-4.1 million values exceeded 1e-3 / 5e-3, by up to
    1.18e-3 / 5.06e-3), the 99.9th percentile of |difference| of each
    plane within 1e-4 (color, T) and 5e-4 (depth, chip_smoke.py
    MXU_P999_TOL: the depth plane read 1.04e-4 here on the H100, NVIDIA
    H100 80GB HBM3, 700.00 W; this wide-angle 20k-Gaussian scene drives
    the expanded form's terms to |power| ~2900, where the plain f32
    expanded form itself sits 1e-4 off float64, and depth spans metres),
    n_touched mismatches at most 1e-3 of the live pairs."""
    feat, plan, cam = _room_rows(cuda)
    W, H = cam.width, cam.height
    n_tx, n_ty = tk.grid_dims(W, H)
    wrapper = tk.composite32_fwd_ntouch if with_ntouch else tk.composite32_fwd
    before = (wrapper.launches, wrapper.launches_mxu)
    got = tk.composite32(feat, plan.ranges, n_tx, n_ty, W, H, with_ntouch,
                         nt_weight, mxu=True)
    ref = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch, nt_weight, mxu=True)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_mxu) == \
        (before[0], before[1] + 1)
    for name, a, b, tol, flip, p999 in zip(
            ("color", "depth", "T"), got[:3], ref[:3], (1e-3, 5e-3, 1e-3),
            (8e-3, 5e-2, 8e-3), (1e-4, 5e-4, 1e-4)):
        d = (a - b).abs().flatten()
        assert int((d > tol).sum()) <= 1e-5 * d.numel(), name
        assert float(d.max()) <= flip, name
        q = float(torch.quantile(d, 0.999))
        assert q <= p999, (name, q)
    live = int((plan.ranges[:, 1] - plan.ranges[:, 0]).sum())
    assert int((got.n_touched_pairs != ref.n_touched_pairs).sum()) \
        <= 1e-3 * live


@pytest.mark.parametrize("bf16", [False, True])
def test_mxu_backward_kernel_matches_plain(cuda, bf16):
    """B2-mxu and B2-bf16-mxu against composite32_bwd_plain(mxu=True) on
    the card: each column within 1e-3 of its max (5e-3 under bf16), and
    under bf16 the bfloat16 products took effect: the rows differ from
    B2-mxu's (f32 products) on the same inputs by more than from their
    plain version (the five quadratic-form columns, Frobenius norm)."""
    feat, plan, cam = _room_rows(cuda)
    W, H = cam.width, cam.height
    n_tx, n_ty = tk.grid_dims(W, H)
    fwd = tk.composite32_plain(feat, plan.ranges, n_tx, n_ty, W, H,
                               with_ntouch=False, mxu=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, plan.ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    attr = "launches_bf16_mxu" if bf16 else "launches_mxu"
    before = getattr(tk.composite32_bwd, attr)
    got = tk.composite32_bwd(*args, bf16=bf16, mxu=True)
    ref = tk.composite32_bwd_plain(*args, bf16=bf16, mxu=True)
    torch.cuda.synchronize()
    assert getattr(tk.composite32_bwd, attr) == before + 1
    assert bool(torch.isfinite(got).all())
    # under bf16 an ulp of power moves G across a bfloat16 rounding
    # boundary in some cells, and that cell's products by a bfloat16 ulp:
    # on the H100 (NVIDIA H100 80GB HBM3, 700.00 W) a column of this small
    # wide-angle scene read 2.4e-3 of its max, hence 5e-3 here (the
    # room's chip_smoke.py plans read at most 4.3e-4 and are held to 2e-3)
    tol = 5e-3 if bf16 else 1e-3
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        err = float((got[:, col] - ref[:, col]).abs().max())
        assert err <= tol * scale, (col, err / scale)
    if bf16:
        f32_products = tk.composite32_bwd(*args, mxu=True)
        effect = float((got[:, :5] - f32_products[:, :5]).norm())
        gap = float((got[:, :5] - ref[:, :5]).norm())
        assert effect > gap, (effect, gap)


def test_mxu_power_tile_matches_f32(cuda):
    """csrc/mxu_falloff.cuh alone: one chunk's power block from the
    tensor cores (3xTF32) within 1e-4 of the f32 G6 @ P6 where the power
    can matter (>= -20), and within 1e-4 plus two ulps of the power over
    the block (the two differ by an f32 ulp at |power| ~ 2048, 2.4e-4, as
    measured on the H100; chip_smoke.py MXU_POWER_TOL)."""
    feat, plan, cam = _room_rows(cuda)
    n = (plan.ranges[:, 1] - plan.ranges[:, 0]).cpu()
    tile = int(torch.argmax(n))
    s = int(plan.ranges[tile, 0])
    rows = feat[s:s + min(int(n[tile]), 128)].contiguous()
    n_tx, _ = tk.grid_dims(cam.width, cam.height)
    got = tk.mxu_power_tile(rows, tile % n_tx, tile // n_tx)
    ref = tk.mxu_power_tile_plain(rows, tile % n_tx, tile // n_tx)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    assert float(d[ref >= -20.0].max()) <= 1e-4
    assert bool((d <= 1e-4 + 2.0 ** -22 * ref.abs()).all())


@pytest.mark.parametrize("variant", ["full", "noexp", "noscan", "nomxu",
                                     "notrans", "minimal", "dyn",
                                     "prodbody"])
def test_abl16_kernel_matches_plain(cuda, variant):
    """B5: each variant's kernel (one CTA per subtile) against its plain
    version on the script's plan and on a plan whose rect16 columns admit
    every cell, 1e-5 relative. The admitting plan is also run with one
    more column in feat (B odd) and from a copy of feat 4 bytes past a
    16-byte boundary: the kernel stages those with 4-byte copies."""
    from gs_slam_analytica_jacobian_tpu_torch.scripts import abl16
    counts = abl16.run.launches
    for make, nc in ((abl16.make_inputs, 1), (abl16.make_admitting_inputs,
                                              2)):
        feat, ranges = make(4, 3, nc, device=cuda)
        cases = [feat]
        if make is abl16.make_admitting_inputs:
            cases.append(torch.cat([feat, torch.full_like(feat[:, :1], 0.5)],
                                   dim=1))
            shifted = torch.empty(feat.numel() + 1, device=cuda)[1:]
            cases.append(shifted.view_as(feat).copy_(feat))
            assert cases[-1].data_ptr() % 16 == 4
        for f in cases:
            before = counts[variant]
            got = abl16.run(f, ranges, 4, 3, 128, 96, nc, variant)
            ref = abl16.run_plain(f, ranges, 4, 3, 128, 96, nc, variant)
            torch.cuda.synchronize()
            assert counts[variant] == before + 1
            assert bool(torch.isfinite(got).all())
            assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5


def _subtile_plan(cuda, tile16=False, at_threshold=True):
    """The sub-tile kernels' hard cases on one plan (32-px, or the 16-px
    plan under ``tile16``; n_tx x n_ty is then the 16-px grid): a ragged
    333x197 view of the room (edge tiles and quarters partly or wholly
    outside the image), runs over several 64-row chunks, one tile whose
    run is empty, and, in the longest run, rows the block test must keep
    and the walk must skip or include as the plain version does: a non-PD
    conic, a NaN mean, and (``at_threshold``) means on a pixel with
    opacity at 1/255 and one ulp below."""
    W, H = 333, 197
    gm, cam = _room(cuda, n=30000, W=W, H=H)
    prep = gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6, device=cuda), cam.fx,
        cam.fy, W, H, cam.tanfovx, cam.tanfovy, low_pass=0.3)
    plan = make_plan(prep, W, H, 1 << 19, radius_scale=1.1, radius_pad=2.0,
                     tile16=tile16)
    assert int(plan.overflow) == 0
    feat = pair_gather(pack_table(prep), plan).detach().contiguous().clone()
    ranges = plan.ranges.clone()
    if tile16:
        n_gx, n_gy = tk16.grid_dims16(W, H)
        n_tx, n_ty, edge = 2 * n_gx, 2 * n_gy, 16
    else:
        (n_tx, n_ty), edge = tk.grid_dims(W, H), 32
    runs = (ranges[:, 1] - ranges[:, 0]).long()
    assert int(runs.max()) > 3 * tk.SUB_CHUNK
    t = int(torch.argmax(runs))
    a = int(ranges[t, 0])
    x0, y0 = (t % n_tx) * edge + 5.0, (t // n_tx) * edge + 9.0
    alpha_min = torch.tensor(tk.ALPHA_MIN, dtype=torch.float32)
    feat[a + 3, 3] = 2.0 * torch.sqrt(feat[a + 3, 2] * feat[a + 3, 4])
    feat[a + 70, 0] = float("nan")
    below = torch.nextafter(alpha_min, torch.tensor(0.0))
    for r, opa in ((a + 5, alpha_min), (a + 130, below)) if at_threshold \
            else ():
        feat[r, 0:6] = torch.tensor([x0, y0, 0.3, 0.05, 0.2, float(opa)])
        feat[r, 10:14] = torch.tensor([0.0, 0.0, 1e4, 1e4])
    empty = next(i for i in range(n_tx * n_ty)
                 if i != t and int(runs[i]) > 0)
    ranges[empty, 1] = ranges[empty, 0]
    return feat, ranges.contiguous(), n_tx, n_ty, W, H


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_subtile_forward_matches_plain_on_hard_plan(cuda, with_ntouch,
                                                    nt_weight):
    """B1' / B1 (the sub-tile kernel) bit for bit against the plain
    version."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda)
    ref = tk.composite32_plain(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                               nt_weight)
    wrapper = tk.composite32_fwd_ntouch if with_ntouch else tk.composite32_fwd
    before = wrapper.launches
    got = (tk.composite32_fwd_ntouch(feat, ranges, n_tx, n_ty, W, H,
                                     nt_weight) if with_ntouch
           else tk.composite32_fwd(feat, ranges, n_tx, n_ty, W, H))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


def test_subtile_backward_matches_plain_on_hard_plan(cuda):
    """B2 (the sub-tile kernel, rows summed across its cluster of four in
    a fixed order) against the plain version within BWD_COL_TOL of each
    column's max, the same zero rows, and bit for bit the same rows from
    two launches."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda)
    fwd = tk.composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                               with_ntouch=False)
    g = torch.Generator(device=cuda).manual_seed(2)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    before = tk.composite32_bwd.launches
    got = tk.composite32_bwd(*args)
    again = tk.composite32_bwd(*args)
    ref = tk.composite32_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tk.composite32_bwd.launches == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, 10:].any())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert scale > 0, col
        assert float((got[:, col] - ref[:, col]).abs().max()) \
            <= 1e-5 * scale, col
    assert torch.equal(got.any(dim=1), ref.any(dim=1))


def test_subtile_backward16_matches_plain_on_hard_plan(cuda):
    """B4 (the sub-tile kernel on the 16-px plan) against the plain
    version within 1e-5 of each column's max, the same zero rows, and bit
    for bit the same rows from two launches."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda, tile16=True)
    n_gx, n_gy = n_tx // 2, n_ty // 2
    fwd = tk16.composite16_plain(feat, ranges, n_gx, n_gy, W, H,
                                 with_ntouch=False)
    g = torch.Generator(device=cuda).manual_seed(3)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_gx, n_gy, W, H)
    before = tk16.composite16_bwd.launches
    got = tk16.composite16_bwd(*args)
    again = tk16.composite16_bwd(*args)
    ref = tk16.composite16_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tk16.composite16_bwd.launches == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, 10:].any())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert scale > 0, col
        assert float((got[:, col] - ref[:, col]).abs().max()) \
            <= 1e-5 * scale, col
    assert torch.equal(got.any(dim=1), ref.any(dim=1))


@pytest.mark.parametrize("bf16,mxu", [(True, False), (False, True),
                                      (True, True)])
def test_subtile_bf16_mxu_backward_matches_plain_on_hard_plan(cuda, bf16,
                                                             mxu):
    """B2-bf16, B2-mxu and B2-bf16-mxu (B2's sub-tile body with the
    bfloat16 falloff and its margin, the tensor-core falloff and the mxu
    margin, or that falloff with the bfloat16 products) against the plain
    version of the same body: each column within 1e-5 (bf16,
    chip_smoke.py BWD_COL_TOL), 1e-3 (mxu, MXU_BWD_COL_TOL) or 2e-3 (both,
    MXU_BF16_BWD_COL_TOL) of its max, and bit for bit the same rows from
    two launches of the sub-tile kernel. Under bf16 alone the zero rows
    are plain's (rows at alpha = 1/255 to an ulp included); under mxu
    those rows are left out and the zero rows not compared, as in the mxu
    forward's test: the tensor cores' power and the plain matmul's differ
    by rounding."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda, at_threshold=not mxu)
    fwd = tk.composite32_plain(feat, ranges, n_tx, n_ty, W, H,
                               with_ntouch=False, bf16=bf16, mxu=mxu)
    g = torch.Generator(device=cuda).manual_seed(4)
    cot = torch.randn(5, H, W, generator=g, device=cuda)
    args = (feat, ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)
    attr = {(True, False): "launches_bf16", (False, True): "launches_mxu",
            (True, True): "launches_bf16_mxu"}[(bf16, mxu)]
    before = getattr(tk.composite32_bwd, attr)
    got = tk.composite32_bwd(*args, bf16=bf16, mxu=mxu)
    again = tk.composite32_bwd(*args, bf16=bf16, mxu=mxu)
    ref = tk.composite32_bwd_plain(*args, bf16=bf16, mxu=mxu)
    torch.cuda.synchronize()
    assert getattr(tk.composite32_bwd, attr) == before + 2
    assert torch.equal(got, again)
    tol = (2e-3 if bf16 else 1e-3) if mxu else 1e-5
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, 10:].any())
    for col in range(10):
        scale = float(ref[:, col].abs().max())
        assert scale > 0, col
        err = float((got[:, col] - ref[:, col]).abs().max())
        assert err <= tol * scale, (col, err / scale)
    if not mxu:
        assert torch.equal(got.any(dim=1), ref.any(dim=1))


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_subtile_mxu_forward_matches_plain_on_hard_plan(cuda, with_ntouch,
                                                        nt_weight):
    """B1'-mxu / B1-mxu (the sub-tile kernel with the mxu margin) against
    the plain mxu version under chip_smoke.py's MXU gates
    (mxu_gate_failure: the values above MXU_IMG_TOL counted over the three
    planes together, each within MXU_FLIP_TOL, each plane's 99.9th
    percentile within MXU_P999_TOL). On the H100 one depth value of this
    plan's 0.33 million flipped past 5e-3 (NVIDIA H100 80GB HBM3,
    700.00 W): a per-plane count would allow none. The
    rows placed at alpha = 1/255 to an ulp of the f32 power are left out:
    the tensor cores' power and the plain matmul's differ by rounding
    there, which flips such a row's test by design."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda, at_threshold=False)
    ref = tk.composite32_plain(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                               nt_weight, mxu=True)
    wrapper = tk.composite32_fwd_ntouch if with_ntouch else tk.composite32_fwd
    before = wrapper.launches_mxu
    got = tk.composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                         nt_weight, mxu=True)
    torch.cuda.synchronize()
    assert wrapper.launches_mxu == before + 1
    live = int((ranges[:, 1] - ranges[:, 0]).sum())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert mxu_gate_failure(got, ref, live) is None
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_subtile_bf16_forward_matches_plain_on_hard_plan(cuda, with_ntouch,
                                                         nt_weight):
    """B1'-bf16 / B1-bf16 (the sub-tile kernel with the bfloat16 falloff
    and its cull margin) bit for bit against the plain bf16 version, rows
    at alpha = 1/255 included; bf16 is applied (the images differ from the
    f32 kernel's)."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda)
    ref = tk.composite32_plain(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                               nt_weight, bf16=True)
    wrapper = tk.composite32_fwd_ntouch if with_ntouch else tk.composite32_fwd
    before = (wrapper.launches, wrapper.launches_bf16)
    got = tk.composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                         nt_weight, bf16=True)
    f32 = tk.composite32(feat, ranges, n_tx, n_ty, W, H, with_ntouch,
                         nt_weight)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert float((got.color_sum - f32.color_sum).abs().max()) > 1e-4
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(False, False), (True, False), (True, True)])
def test_subtile_forward16_matches_plain_on_hard_plan(cuda, with_ntouch,
                                                      nt_weight):
    """B3' / B3 (the sub-tile kernel on the 16-px plan, n_touched stored
    without atomics) bit for bit against the plain version."""
    feat, ranges, n_tx, n_ty, W, H = _subtile_plan(cuda, tile16=True)
    n_gx, n_gy = n_tx // 2, n_ty // 2
    ref = tk16.composite16_plain(feat, ranges, n_gx, n_gy, W, H, with_ntouch,
                                 nt_weight)
    wrapper = (tk16.composite16_fwd_ntouch if with_ntouch
               else tk16.composite16_fwd)
    before = wrapper.launches
    got = tk16.composite16(feat, ranges, n_gx, n_gy, W, H, with_ntouch,
                           nt_weight)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if with_ntouch:
        assert float(got.n_touched_pairs.sum()) > 0


def test_entry_on_card_matches_cpu(cuda):
    """graft_entry.entry()'s render on the card (B1, one launch) against
    the same entry on the CPU (plain versions), at a small cloud."""
    from gs_slam_analytica_jacobian_tpu_torch import graft_entry
    kw = dict(n=5000, width=320, height=180, focal=160.0)
    fn, args = graft_entry.entry(device=cuda, **kw)
    before = tk.composite32_fwd_ntouch.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert tk.composite32_fwd_ntouch.launches == before + 1
    fn_c, args_c = graft_entry.entry(device="cpu", **kw)
    for g, w in zip(got, fn_c(*args_c)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4,
                                   rtol=0)

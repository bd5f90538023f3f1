"""GPU tests of the port (``cuda`` marker): the CUDA compositing kernels
(forward and backward, 32x32 and 16x16) against their plain PyTorch
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

from chip_smoke import resort_full_depth_key

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

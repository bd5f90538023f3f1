"""GPU tests of the port (``cuda`` marker): the CUDA compositing kernels
(forward and backward) against their plain PyTorch versions, alone and
inside a full render and its gradients.

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
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as tk
from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import pair_gather
from gs_slam_analytica_jacobian_tpu_torch.ops.renderer_tiled import (
    make_plan, pack_table)
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render

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

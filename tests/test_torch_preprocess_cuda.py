"""GPU tests of the fused preprocess (``cuda`` marker): the CUDA kernels of
``csrc/preprocess.cu`` against their plain versions on the card, at the
benchmark's scene size (the 200,000-Gaussian room in a 2^18 capacity, the
rest inactive, at 640x480 with TUM fr1/desk's intrinsics), alone and
inside a full render with the mapping loss and its backward.

They skip without a GPU. On a machine with one run them without the
suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_cuda.py -q

Tolerances. The forward kernel takes the plain version's operations in
its order, and for the small products and sums that torch leaves to
cuBLAS and its reductions the fused multiply-adds and the order they take
on the card (``csrc/preprocess.cu`` mm3, mv3, sum3): its fields are the
plain version's bit for bit there (a thin splat's determinant cancels, so
one rounding apart its conic can move by a fifth), and the integer fields
(valid, radius, rect, tiles_touched), which could flip only where a value
rounds across a threshold, flip in at most 1e-5 of the rows (none, as
the floats agree). The backward against its plain version (the same
terms in the same order on tensors): every per-Gaussian group bit for
bit; tau, a sum over every Gaussian in another order, within 1e-5 of its
largest component (float32 rounding of sums over 2^18 terms). The whole
render's gradients, kernel path against plain path (autograd) on one
plan: each group's norm of the difference within 1e-5 of the group's
norm (measured: at most 2.3e-7, the rounding of the analytic chain
against autograd's).

This file imports no JAX."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera, PoseState
from gs_slam_analytica_jacobian_tpu_torch.ops import launches
from gs_slam_analytica_jacobian_tpu_torch.ops import losses
from gs_slam_analytica_jacobian_tpu_torch.ops import preprocess_fused as pf
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
from gs_slam_analytica_jacobian_tpu_torch.ops.lie import se3_exp
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

N_ACTIVE, CAPACITY = 200_000, 1 << 18
W, H = 640, 480
FX, FY, CX, CY = 517.306, 516.469, 318.643, 255.314
PAIR_CAP = 1 << 22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _room(dev, sh_degree=0):
    rng = np.random.default_rng(1)
    m = make_room_map(N_ACTIVE, rng)
    if sh_degree:
        m["features_rest"] = rng.normal(
            scale=0.2, size=(N_ACTIVE, (sh_degree + 1) ** 2 - 1, 3))
    gm = gmap.from_numpy(**m, max_sh_degree=sh_degree, capacity=CAPACITY,
                         device=dev)
    return gm


def _camera(dev, k=0):
    """Views inside the room, turned a little each."""
    T = se3_exp(torch.tensor([0.05 * k, -0.02, 0.1 + 0.3 * k, 0.02 * k,
                              -0.05 * k, 0.01], dtype=torch.float64))
    return Camera.create(T[:3, :3].numpy(), T[:3, 3].numpy(), FX, FY, CX,
                         CY, W, H, device=dev)


def _params(gm):
    return [getattr(gm, f) for f in pf.PREP_PARAMS]


@pytest.mark.parametrize("sh_degree,k", [(0, 0), (0, 1), (0, 2), (3, 1)])
def test_forward_kernel_matches_plain(cuda, sh_degree, k):
    gm = _room(cuda, sh_degree)
    cam = _camera(cuda, k)
    n = gm.capacity
    rng = np.random.default_rng(k)
    tau = torch.tensor(rng.normal(scale=0.01, size=6), dtype=torch.float32,
                       device=cuda)
    m2o = torch.tensor(rng.normal(scale=0.5, size=(n, 2)),
                       dtype=torch.float32, device=cuda)
    before = (pf.preprocess_fwd.launches,
              launches.counts()["preprocess_fwd"])
    out = pf.preprocess_fwd(_params(gm), sh_degree, cam, tau, m2o,
                            gm.active, scale_modifier=0.9)
    got = pf._views(out)
    table, ref = pf.preprocess_plain(_params(gm), sh_degree, cam, tau, m2o,
                                     gm.active, scale_modifier=0.9)
    torch.cuda.synchronize()
    assert pf.preprocess_fwd.launches == before[0] + 1
    assert trace.snapshot()["launch.preprocess_fwd"] == before[1] + 1
    assert int(ref.valid.sum()) > 50_000
    flips = ((got.valid != ref.valid) | (got.radius != ref.radius)
             | (got.rect_min != ref.rect_min).any(-1)
             | (got.rect_max != ref.rect_max).any(-1)
             | (got.tiles_touched != ref.tiles_touched)
             | (got.radius_xy != ref.radius_xy).any(-1))
    assert int(flips.sum()) <= 1e-5 * n, int(flips.sum())
    for name in ("depth", "mean2d", "conic", "cov2d", "opacity", "color"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(out.table, table)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_backward_kernel_matches_plain(cuda, sh_degree):
    gm = _room(cuda, sh_degree)
    cam = _camera(cuda, 1)
    n = gm.capacity
    g = torch.Generator(device=cuda).manual_seed(sh_degree)
    tau = 0.01 * torch.randn(6, generator=g, device=cuda)
    # the gather's backward hands the table gradient over transposed
    g_table = torch.randn(16, n, generator=g, device=cuda).T
    before = pf.preprocess_bwd.launches
    got = pf.preprocess_bwd(_params(gm), sh_degree, cam, tau, g_table,
                            scale_modifier=0.9)
    ref = pf.preprocess_bwd_plain(_params(gm), sh_degree, cam, tau, g_table,
                                  scale_modifier=0.9)
    torch.cuda.synchronize()
    assert pf.preprocess_bwd.launches == before + 1
    for name in (*pf.PREP_PARAMS, "mean2d_offset"):
        assert bool(torch.isfinite(got[name]).all()), name
        assert torch.equal(got[name], ref[name]), name
    scale = float(ref["tau"].abs().max())
    err = float((got["tau"] - ref["tau"]).abs().max())
    assert 0 < scale and err <= 1e-5 * scale, (err, scale)
    # the pose gradient's sum runs in a fixed order: the same each time
    again = pf.preprocess_bwd(_params(gm), sh_degree, cam, tau, g_table,
                              scale_modifier=0.9)
    assert torch.equal(again["tau"], got["tau"])


def test_render_gradients_kernel_against_plain(cuda):
    """render_api.render (the kernels) against renderer_tiled.render over
    the map's activations (the plain preprocess) on one plan: the mapping
    loss's gradients in every parameter group, tau, the exposure-free
    image and the screen-space offset."""
    gm = _room(cuda)
    cam = _camera(cuda, 1)
    gt_cam = _camera(cuda, 2)
    bg = torch.zeros(3, device=cuda)
    with torch.no_grad():
        gt = render_api.render(gm, gt_cam, bg=bg, pair_capacity=PAIR_CAP,
                               device=cuda)
    plan = render_api.make_render_plan(gm, cam, pair_capacity=PAIR_CAP,
                                       radius_scale=1.1, radius_pad=6.0,
                                       opa_growth=2.23, device=cuda)
    assert int(plan.overflow) == 0
    grads = {}
    fused_before = (pf.preprocess_fwd.launches, pf.preprocess_bwd.launches)
    for path in ("kernel", "plain"):
        params = {f: getattr(gm, f).detach().requires_grad_()
                  for f in gmap.PARAM_FIELDS}
        gmp = gm.replace(**params)
        tau = torch.zeros(6, device=cuda, requires_grad=True)
        m2o = torch.zeros(gm.capacity, 2, device=cuda, requires_grad=True)
        if path == "kernel":
            out = render_api.render(
                gmp, cam, PoseState(tau, torch.zeros((), device=cuda),
                                    torch.zeros((), device=cuda)), bg,
                mean2d_offset=m2o, plan=plan, need_n_touched=False,
                device=cuda)
        else:
            out = renderer_tiled.render(
                gmp.xyz, gmp.get_cov6(), gmp.get_opacity(),
                gmp.get_features(), 0, cam.w2c(), cam.projection(), tau,
                cam.fx, cam.fy, W, H, cam.tanfovx, cam.tanfovy, bg,
                active=gm.active, mean2d_offset=m2o, plan=plan,
                need_n_touched=False, device=cuda)
        L = losses.loss_mapping_rgbd(out.color, out.depth, gt.color,
                                     gt.depth, 0.01, 0.95)
        L.backward()
        grads[path] = {f: p.grad for f, p in params.items()}
        grads[path].update(tau=tau.grad, mean2d_offset=m2o.grad,
                           color=out.color.detach())
    torch.cuda.synchronize()
    assert pf.preprocess_fwd.launches == fused_before[0] + 1
    assert pf.preprocess_bwd.launches == fused_before[1] + 1
    for name, b in grads["plain"].items():
        a = grads["kernel"][name]
        assert bool(torch.isfinite(a).all()), name
        if b.numel() == 0:          # features_rest at SH degree 0
            continue
        norm = float(torch.linalg.norm(b))
        assert norm > 0, name
        gap = float(torch.linalg.norm(a - b)) / norm
        assert gap <= 1e-5, (name, gap)


def test_every_render_takes_the_kernel(cuda):
    """Renders with and without grad and plan builds each launch the
    forward kernel once (``launch.preprocess_fwd`` in the trace snapshot
    counts it); a backward launches the backward once."""
    gm = _room(cuda)
    cam = _camera(cuda, 0)
    bg = torch.zeros(3, device=cuda)
    c0 = trace.snapshot()["launch.preprocess_fwd"]
    b0 = pf.preprocess_bwd.launches
    plan = render_api.make_render_plan(gm, cam, pair_capacity=PAIR_CAP,
                                       device=cuda)
    with torch.no_grad():
        render_api.render(gm, cam, bg=bg, plan=plan, device=cuda)
    xyz = gm.xyz.detach().requires_grad_()
    out = render_api.render(gm.replace(xyz=xyz), cam, bg=bg, plan=plan,
                            need_n_touched=False, device=cuda)
    out.color.sum().backward()
    torch.cuda.synchronize()
    assert trace.snapshot()["launch.preprocess_fwd"] == c0 + 3
    assert pf.preprocess_bwd.launches == b0 + 1
    assert xyz.grad is not None and bool(xyz.grad.abs().sum() > 0)

"""GPU tests of the pair gather's kernels (``cuda`` marker): the CUDA
kernels of ``csrc/pair_gather.cu`` (``pair_gather_fwd``, the row copy, and
``segment_reduce_fwd``, the per-Gaussian segment sum that is its backward
and the n_touched accumulation) against their plain versions on the card,
on plans of the benchmark's scene (the 200,000-Gaussian room in a 2^18
capacity at 640x480 with TUM fr1/desk's intrinsics): pair capacities 2^14
(the plan overflows) to 2^20 (tum-map's), conic-culled pairs, the 32-px
and the 16-px layouts, F = 16 and F = 1.

They skip without a GPU. On a machine with one run them without the
suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_pair_gather_cuda.py -q

Tolerances. The forward is a copy: equal to the plain version. The
backward adds each Gaussian's terms in emission order in float32, so
against the float64 segment sum (the plain chain run in float64) each
column's norm of the difference stays within 1e-6 of the column's norm
(a direct float32 sum of at most a few hundred terms). The plain
version takes each sum as the difference of two float32 prefix sums over
the whole capacity, which rounds at the prefix sums' magnitude: the
kernel stays within twice the plain version's own gap to the float64
sum of it. Integer-valued terms (n_touched) sum exactly in float32 below
2^24, so there the kernel equals the float64 sum. Two launches on one
input give the same bits (no atomics).

This file imports no JAX."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath
from gs_slam_analytica_jacobian_tpu_torch.ops import launches
from gs_slam_analytica_jacobian_tpu_torch.ops import pair_gather as pg
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
from gs_slam_analytica_jacobian_tpu_torch.ops.lie import se3_exp
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

N_ACTIVE, CAPACITY = 200_000, 1 << 18
W, H = 640, 480
FX, FY, CX, CY = 517.306, 516.469, 318.643, 255.314
# (pair capacity, 16-px layout): 2^14 overflows on either layout
PLANS = [(1 << 14, False), (1 << 17, False), (1 << 20, False),
         (1 << 14, True), (1 << 19, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


_PREP = {}


def _prep(dev, n=N_ACTIVE, capacity=CAPACITY):
    """The room's preprocess at a view inside it, inactive slots masked,
    and its packed table (cached per device and size)."""
    key = (str(dev), n, capacity)
    if key not in _PREP:
        gm = gmap.from_numpy(**make_room_map(n, np.random.default_rng(1)),
                             max_sh_degree=0, capacity=capacity, device=dev)
        T = se3_exp(torch.tensor([0.05, -0.02, 0.4, 0.02, -0.05, 0.01],
                                 dtype=torch.float64))
        cam = Camera.create(T[:3, :3].numpy(), T[:3, 3].numpy(), FX, FY, CX,
                            CY, W, H, device=dev)
        prep = gmath.preprocess(
            gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
            cam.w2c(), cam.projection(), torch.zeros(6, device=dev), cam.fx,
            cam.fy, W, H, cam.tanfovx, cam.tanfovy)
        prep = renderer_tiled.mask_active(prep, gm.active)
        _PREP[key] = (prep, renderer_tiled.pack_table(prep).detach())
    return _PREP[key]


def _plan(dev, cap, tile16):
    prep, table = _prep(dev)
    plan = renderer_tiled.make_plan(prep, W, H, cap, radius_pad=2.0,
                                    tile16=tile16)
    return plan, table


def _segment_sum64(values, plan):
    """The float64 per-Gaussian segment sum (the plain chain in float64)."""
    return pg.segment_reduce_plain(values.double(), plan)


@pytest.mark.parametrize("cap,tile16", PLANS)
def test_forward_equals_plain(cuda, cap, tile16):
    plan, table = _plan(cuda, cap, tile16)
    before = (pg.pair_gather_fwd.launches,
              launches.counts()["pair_gather_fwd"])
    got = pg.pair_gather(table, plan)
    ref = pg.pair_gather_plain(table, plan)
    # a table at other strides (columns apart) takes the one-float path
    strided = pg.pair_gather_fwd(table.T.contiguous().T, plan)
    torch.cuda.synchronize()
    assert pg.pair_gather_fwd.launches == before[0] + 2
    assert trace.snapshot()["launch.pair_gather_fwd"] == before[1] + 2
    assert got.is_contiguous() and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert torch.equal(strided, ref)
    if cap == 1 << 14:
        assert int(plan.overflow) > 0
    assert int(plan.num_kept) < int(plan.num_pairs)   # conic-culled pairs


@pytest.mark.parametrize("cap,tile16", PLANS)
def test_backward_against_float64_and_plain(cuda, cap, tile16):
    plan, _ = _plan(cuda, cap, tile16)
    b_al = plan.pair_gid1.shape[0]
    g = torch.Generator(device=cuda).manual_seed(cap + tile16)
    dfeat = torch.randn(b_al, 16, generator=g, device=cuda)
    before = (pg.segment_reduce_fwd.launches,
              launches.counts()["segment_reduce_fwd"])
    got = pg.segment_reduce_pairs(dfeat, plan)
    again = pg.segment_reduce_pairs(dfeat, plan)
    plain = pg.segment_reduce_plain(dfeat, plan)
    ref = _segment_sum64(dfeat, plan)
    torch.cuda.synchronize()
    assert pg.segment_reduce_fwd.launches == before[0] + 2
    assert trace.snapshot()["launch.segment_reduce_fwd"] == before[1] + 2
    assert got.shape == (plan.seg_start.shape[0], 16)
    assert torch.equal(got, again)
    assert float(ref.norm()) > 0
    gap = (got.double() - ref).norm(dim=0) / ref.norm(dim=0)
    assert float(gap.max()) <= 1e-6, gap
    plain_gap = float((plain.double() - ref).abs().max())
    assert float((got - plain).abs().max()) <= 2 * plain_gap, plain_gap


@pytest.mark.parametrize("cap,tile16", [(1 << 14, False), (1 << 20, False),
                                        (1 << 19, True)])
def test_backward_at_any_strides(cuda, cap, tile16):
    """A gradient handed over transposed, or as every other column of a
    wider one, sums to the same bits as its contiguous copy."""
    plan, _ = _plan(cuda, cap, tile16)
    b_al = plan.pair_gid1.shape[0]
    g = torch.Generator(device=cuda).manual_seed(7)
    wide = torch.randn(b_al, 32, generator=g, device=cuda)
    for dfeat in (wide[:, :16].T.contiguous().T, wide[:, ::2], wide[:, :16]):
        got = pg.segment_reduce_pairs(dfeat, plan)
        ref = pg.segment_reduce_pairs(dfeat.contiguous(), plan)
        assert torch.equal(got, ref), dfeat.stride()


@pytest.mark.parametrize("cap,tile16", PLANS)
def test_n_touched_sums_are_exact(cuda, cap, tile16):
    """F = 1 with integer terms (the per-pair touch counts): exact."""
    plan, _ = _plan(cuda, cap, tile16)
    b_al = plan.pair_gid1.shape[0]
    g = torch.Generator(device=cuda).manual_seed(3)
    counts = torch.randint(0, 1025, (b_al,), generator=g,
                           device=cuda).float()
    got = pg.segment_reduce_pairs(counts, plan)
    ref = _segment_sum64(counts[:, None], plan)[:, 0]
    assert got.shape == (plan.seg_start.shape[0],)
    assert float(ref.max()) < 2 ** 24 and float(ref.sum()) > 0
    assert torch.equal(got.double(), ref)
    assert torch.equal(got, pg.segment_reduce_pairs(counts, plan))


def test_gradcheck_through_pair_gather(cuda):
    """The gather's backward is its adjoint: torch.autograd.gradcheck in
    float32 on a few hundred Gaussians at a small capacity (the gather is
    linear, so central differences are exact up to the table's rounding)."""
    prep, _ = _prep(cuda, n=300, capacity=512)
    plan = renderer_tiled.make_plan(prep, W, H, 1 << 12, radius_pad=2.0)
    assert int(plan.num_kept) > 0
    g = torch.Generator(device=cuda).manual_seed(11)
    table = (2 * torch.rand(512, 16, generator=g, device=cuda) - 1)
    table.requires_grad_()
    before = pg.segment_reduce_fwd.launches
    assert torch.autograd.gradcheck(
        lambda t: pg.pair_gather(t, plan), (table,), eps=0.5, atol=1e-5,
        rtol=1e-4, fast_mode=True)
    assert pg.segment_reduce_fwd.launches > before


def test_render_takes_both_kernels(cuda):
    """A differentiated render with n_touched: the gather forward once,
    the segment sum for n_touched and for the table's gradient."""
    plan, table = _plan(cuda, 1 << 20, False)
    prep, _ = _prep(cuda)
    leaf = table.clone().requires_grad_()
    before = (pg.pair_gather_fwd.launches, pg.segment_reduce_fwd.launches)
    out = renderer_tiled.render_prepared(prep, leaf, W, H,
                                         torch.zeros(3, device=cuda),
                                         plan=plan, need_n_touched=True)
    out.color.square().sum().backward()
    torch.cuda.synchronize()
    assert pg.pair_gather_fwd.launches == before[0] + 1
    assert pg.segment_reduce_fwd.launches == before[1] + 2
    assert int(out.n_touched.sum()) > 0
    assert bool(torch.isfinite(leaf.grad).all()) and bool(leaf.grad.any())

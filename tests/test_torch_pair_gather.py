"""The pair gather on CPU tensors: the plain versions, and the semantics
the CUDA kernels of ``csrc/pair_gather.cu`` implement.

``segment_reduce_pairs`` on a CPU tensor takes the plain chain (prefix
sums over the capacity) and launches no kernel: neither wrapper's
``launches`` moves (read directly and as ``launch.<name>`` in the trace
snapshot), through ``pair_gather``'s
forward and backward alike. Its result is each Gaussian's float64 sum
over its emission segment [seg_start, min(seg_end, capacity)), skipping
the pairs the plan dropped (``aligned_of_em == B_al``: culled, or past
the capacity), which is what ``segment_reduce_fwd`` walks on the card.
Float terms agree within float32 rounding of the prefix sums; integer
terms (n_touched) exactly."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as gmath
from gs_slam_analytica_jacobian_tpu_torch.ops import pair_gather as pg
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

torch.set_num_threads(1)

W, H = 160, 96


def _prep():
    gm = gmap.from_numpy(**make_room_map(3000, np.random.default_rng(1)),
                         max_sh_degree=0, device="cpu")
    cam = Camera.create(np.eye(3), np.array([0.05, -0.02, 0.1]), W / 2,
                        W / 2, (W - 1) / 2, (H - 1) / 2, W, H, device="cpu")
    return gmath.preprocess(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(), 0,
        cam.w2c(), cam.projection(), torch.zeros(6), cam.fx, cam.fy, W, H,
        cam.tanfovx, cam.tanfovy)


def _direct_sum(values, plan):
    """Each Gaussian's float64 sum over its emission segment, clipped to
    the capacity, of the values at its pairs' aligned slots; dropped
    pairs skipped."""
    start = plan.seg_start.numpy().astype(np.int64)
    end = plan.seg_end.numpy().astype(np.int64)
    capacity = plan.aligned_of_em.shape[0]
    b_al = plan.pair_gid1.shape[0]
    owner = np.repeat(np.arange(len(start)), end - start)[:capacity]
    aligned = plan.aligned_of_em.numpy()[:len(owner)]
    keep = aligned < b_al
    out = np.zeros((len(start), values.shape[1]))
    np.add.at(out, owner[keep], values.numpy().astype(np.float64)[
        aligned[keep]])
    return out


@pytest.mark.parametrize("cap,tile16,f,integer", [
    (1 << 14, False, 16, False),
    (1 << 14, False, 1, True),
    (1 << 10, False, 16, False),     # overflows
    (1 << 10, False, 1, True),
    (1 << 14, True, 3, False),       # the 16-px layout
    (1 << 10, True, 1, True),
])
def test_plain_path_is_the_segment_sum(cap, tile16, f, integer):
    prep = _prep()
    plan = renderer_tiled.make_plan(prep, W, H, cap, radius_pad=2.0,
                                    tile16=tile16)
    b_al = plan.pair_gid1.shape[0]
    pairs = int(plan.num_pairs)
    assert int(plan.num_kept) < pairs                # conic-culled pairs
    assert (int(plan.overflow) > 0) == (cap == 1 << 10)
    assert int((plan.aligned_of_em[:pairs] == b_al).sum()) > 0

    before = (pg.pair_gather_fwd.launches, pg.segment_reduce_fwd.launches,
              trace.snapshot()["launch.pair_gather_fwd"],
              trace.snapshot()["launch.segment_reduce_fwd"])
    g = torch.Generator().manual_seed(cap + f)
    if integer:
        values = torch.randint(0, 1025, (b_al, f), generator=g).float()
    else:
        values = torch.randn(b_al, f, generator=g)
    got = pg.segment_reduce_pairs(values[:, 0] if f == 1 else values, plan)
    table = torch.randn(prep.depth.shape[0], f, generator=g,
                        requires_grad=True)
    feat = pg.pair_gather(table, plan)
    assert torch.equal(feat, pg.pair_gather_plain(table, plan))
    feat.backward(values)
    after = (pg.pair_gather_fwd.launches, pg.segment_reduce_fwd.launches,
             trace.snapshot()["launch.pair_gather_fwd"],
             trace.snapshot()["launch.segment_reduce_fwd"])
    assert after == before

    ref = _direct_sum(values, plan)
    got = got.numpy().reshape(ref.shape)
    assert np.abs(ref).sum() > 0
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        # float32 prefix sums over the capacity, differenced
        scale = np.abs(values.numpy()).sum(axis=0)
        assert np.all(np.abs(got - ref) <= 1e-6 * scale), (
            np.abs(got - ref).max(axis=0), scale)
    np.testing.assert_array_equal(table.grad.numpy().reshape(ref.shape), got)


@pytest.mark.parametrize("cap,tile16", [
    (1 << 14, False),
    (1 << 10, False),                # overflows
    (1 << 14, True),
])
def test_plan_arrays_are_what_the_kernels_read(cap, tile16):
    """The CUDA wrappers check only the float operand: the four plan
    arrays the kernels read through raw pointers are contiguous int32, as
    ``plan_pairs`` builds them, on the map's device."""
    prep = _prep()
    plan = renderer_tiled.make_plan(prep, W, H, cap, radius_pad=2.0,
                                    tile16=tile16)
    for k in ("pair_gid1", "aligned_of_em", "seg_start", "seg_end"):
        a = getattr(plan, k)
        assert a.dtype == torch.int32 and a.dim() == 1, k
        assert a.is_contiguous() and a.device == prep.depth.device, k
    assert plan.aligned_of_em.shape[0] == cap
    assert plan.seg_start.shape == plan.seg_end.shape == prep.depth.shape

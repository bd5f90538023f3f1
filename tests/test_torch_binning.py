"""Port pair planning, pair gather and segment reduce vs the JAX reference
on the tests/test_binning.py scenes: the integer plan (ranges, num_pairs,
overflow, num_kept, pair_gid1) is exactly equal; the gathered rows and
the per-gaussian segment sums are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import binning2 as jb
from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import pair_gather as jpg
from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
from gs_slam_analytica_jacobian_tpu_torch.ops import binning2 as tb
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import pair_gather as tpg
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt

from test_renderer_ref import make_scene

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def _preps(sc, stretch=0.0):
    scales = np.asarray(sc["scales"]).copy()
    scales[:, 0] += stretch
    cov6 = np.asarray(jgm.build_cov3d(jnp.asarray(scales),
                                      jnp.asarray(sc["quats"])))
    args = (sc["means"], cov6, sc["opac"], sc["shs"])
    rest = (sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
            sc["tanfovy"])
    jp = jgm.preprocess(*[jnp.asarray(a) for a in args], 3,
                        jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]),
                        jnp.zeros(6), *rest)
    tp = tgm.preprocess(*[torch.as_tensor(np.array(a)) for a in args], 3,
                        torch.as_tensor(sc["w2c"]),
                        torch.as_tensor(sc["proj"]), torch.zeros(6), *rest)
    return jp, tp


def _assert_plans_equal(pt, pj):
    for name in ("ranges", "num_pairs", "overflow", "num_kept", "pair_gid1",
                 "aligned_of_em", "seg_start", "seg_end"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", [
    # (n, W, H, n_tx, n_ty, capacity, conic_cull, stretch, pad, opa_growth)
    (30, 256, 64, 8, 2, 4096, False, 0.0, 0.0, 1.0),
    (64, 256, 64, 8, 2, 8192, True, 0.0, 0.0, 1.0),
    (40, 256, 96, 8, 3, 8192, True, 1.5, 4.0, 2.23),
])
def test_plan_pairs_matches(case):
    n, W, H, n_tx, n_ty, cap, cull, stretch, pad, growth = case
    sc = make_scene(np.random.default_rng(n), n=n, W=W, H=H)
    jp, tp = _preps(sc, stretch)
    kw = dict(capacity=cap, chunk=128, radius_scale=1.1, radius_pad=pad,
              conic_cull=cull, opa_growth=growth)
    pj = jb.plan_pairs(jp, 32, 32, n_tx, n_ty, **kw)
    pt = tb.plan_pairs(tp, 32, 32, n_tx, n_ty, **kw)
    assert int(pt.num_pairs) > 0 and int(pt.overflow) == 0
    if cull and stretch:
        assert int(pt.num_kept) < int(pt.num_pairs)
    _assert_plans_equal(pt, pj)
    assert np.all(pt.ranges[:, 0].numpy() % 128 == 0)
    assert pt.pair_gid1.shape[0] == cap + n_tx * n_ty * 128


def test_plan_pairs_overflow_matches():
    sc = make_scene(np.random.default_rng(64), n=64, W=256, H=64)
    jp, tp = _preps(sc)
    total = int(tb.plan_pairs(tp, 32, 32, 8, 2, capacity=8192).num_pairs)
    small = max(128, (total // 2) // 128 * 128)
    pj = jb.plan_pairs(jp, 32, 32, 8, 2, capacity=small)
    pt = tb.plan_pairs(tp, 32, 32, 8, 2, capacity=small)
    assert int(pt.overflow) == total - small > 0
    _assert_plans_equal(pt, pj)


def test_pair_gather_and_segment_reduce_match():
    sc = make_scene(np.random.default_rng(7), n=40, W=256, H=96)
    jp, tp = _preps(sc, stretch=1.0)
    pj = jb.plan_pairs(jp, 32, 32, 8, 3, capacity=8192)
    pt = tb.plan_pairs(tp, 32, 32, 8, 3, capacity=8192)
    table_j = jrt.pack_table(jp)
    table_t = trt.pack_table(tp)
    np.testing.assert_allclose(table_t.numpy(), np.asarray(table_j),
                               rtol=1e-5, atol=1e-5)
    # gather the SAME table through both plans: rows equal exactly
    feat_j = jpg.pair_gather(table_j, pj)
    feat_t = tpg.pair_gather(torch.as_tensor(np.array(table_j)), pt)
    np.testing.assert_array_equal(feat_t.numpy(), np.asarray(feat_j))
    # per-pair values (1-D and 2-D) summed onto their gaussians
    rng = np.random.default_rng(1)
    B_al = int(pt.pair_gid1.shape[0])
    vals = rng.integers(0, 50, size=(B_al, 3)).astype(np.float32)
    for v in (vals[:, 0], vals):
        got = tpg.segment_reduce_pairs(torch.as_tensor(v), pt).numpy()
        ref = np.asarray(jpg.segment_reduce_pairs(jnp.asarray(v), pj))
        np.testing.assert_array_equal(got, ref)

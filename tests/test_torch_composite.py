"""The compositing kernel module: its plain PyTorch version (what the
wrappers run on CPU tensors) vs the JAX Pallas forward kernel in
interpret mode plus ``assemble_image``, on the same pair rows and ranges.

Tolerances are those of tests/test_renderer_tiled.py:25-37: color atol
3e-5, depth atol 2e-4, final_T atol 3e-5, n_touched exactly equal. The
two sum a chunk's contributions in different orders (JAX: a dot over the
chunk; here: an einsum), which the tolerances absorb.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
(``cuda`` marker) holds it against this plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import binning2 as jb
from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import pair_gather as jpg
from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk

from test_renderer_ref import make_scene


def _opaque_front(rng, W=64, H=64):
    """An opaque front layer over (nearly) everything, 300 translucent
    splats behind it: every tile has more than one chunk of pairs, and a
    tile that saturates inside its first chunk never reaches the rest."""
    nf, nb = 100, 300
    sc = make_scene(rng, n=nf + nb, W=W, H=H)
    m = sc["means"]
    m[:nf, :2] = rng.uniform(-1.0, 1.0, size=(nf, 2))
    m[:nf, 2] = rng.uniform(1.5, 1.8, size=nf)
    m[nf:, 2] = rng.uniform(3.0, 5.0, size=nb)
    sc["scales"][:nf] = 0.3
    sc["opac"][:nf] = 0.995
    return sc


def _feat_ranges(sc, capacity=8192):
    prep = jgm.preprocess(
        jnp.asarray(sc["means"]),
        jgm.build_cov3d(jnp.asarray(sc["scales"]), jnp.asarray(sc["quats"])),
        jnp.asarray(sc["opac"]), jnp.asarray(sc["shs"]), 3,
        jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]), jnp.zeros(6),
        sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"], sc["tanfovy"])
    n_tx, n_ty = jtk.grid_dims(sc["W"], sc["H"])
    plan = jb.plan_pairs(prep, 32, 32, n_tx, n_ty, capacity)
    feat = jpg.pair_gather(jrt.pack_table(prep), plan)
    return np.array(feat), np.array(plan.ranges), n_tx, n_ty, plan


def _jax_composite(feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight):
    img, nt = jtk._fwd_impl(jnp.asarray(feat), jnp.asarray(ranges), n_tx,
                            n_ty, W, H, interpret=True,
                            with_ntouch=with_ntouch, nt_weight=nt_weight)
    asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
    return asm, np.asarray(nt), np.asarray(jtk.chunk_stats_from_img(
        img, n_tx, n_ty))


def _compare(feat, ranges, n_tx, n_ty, W, H, with_ntouch, nt_weight):
    asm, nt_j, chunks = _jax_composite(feat, ranges, n_tx, n_ty, W, H,
                                       with_ntouch, nt_weight)
    out = ttk.composite32(torch.as_tensor(feat), torch.as_tensor(ranges),
                          n_tx, n_ty, W, H, with_ntouch, nt_weight)
    np.testing.assert_allclose(out.color_sum.numpy(), asm[0:3], atol=3e-5)
    np.testing.assert_allclose(out.depth_sum.numpy(), asm[3], atol=2e-4)
    np.testing.assert_allclose(out.final_T.numpy(), asm[4], atol=3e-5)
    np.testing.assert_array_equal(out.n_touched_pairs.numpy(), nt_j)
    return out, chunks


@pytest.mark.parametrize("with_ntouch,nt_weight",
                         [(True, False), (True, True), (False, False),
                          (False, True)])
def test_plain_composite_matches_pallas(with_ntouch, nt_weight):
    sc = make_scene(np.random.default_rng(11), n=40, W=160, H=72)
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc)
    out, _ = _compare(feat, ranges, n_tx, n_ty, sc["W"], sc["H"],
                      with_ntouch, nt_weight)
    assert float(out.final_T.min()) < 0.5          # a non-trivial image
    if with_ntouch:
        assert float(out.n_touched_pairs.sum()) > 0
    # CPU tensors never launch the kernel
    assert ttk.composite32_fwd.launches == 0
    assert ttk.composite32_fwd_ntouch.launches == 0


@pytest.mark.parametrize("nt_weight", [False, True])
def test_plain_composite_early_exit(nt_weight):
    sc = _opaque_front(np.random.default_rng(5))
    feat, ranges, n_tx, n_ty, _ = _feat_ranges(sc)
    out, chunks = _compare(feat, ranges, n_tx, n_ty, sc["W"], sc["H"], True,
                           nt_weight)
    n_chunks = (ranges[:, 1] - ranges[:, 0] + 127) // 128
    # the Pallas kernel left at least one tile before its last chunk ...
    early = np.asarray(chunks).reshape(-1) < n_chunks
    assert early.any()
    # ... and the pairs it never reached read 0 in both
    nt = out.n_touched_pairs.numpy()
    for t in np.flatnonzero(early):
        s = ranges[t, 0] + int(np.asarray(chunks).reshape(-1)[t]) * 128
        assert not nt[s:ranges[t, 1]].any()
    assert float(out.final_T.mean()) < 1e-2


def test_plain_composite_overflowing_plan():
    sc = make_scene(np.random.default_rng(64), n=64, W=256, H=64)
    feat, ranges, n_tx, n_ty, plan = _feat_ranges(sc, capacity=128)
    assert int(plan.overflow) > 0
    _compare(feat, ranges, n_tx, n_ty, sc["W"], sc["H"], True, False)


def test_wrapper_rejects_bad_inputs():
    feat = torch.zeros(256, 16)
    ranges = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ttk.composite32(feat.double(), ranges, 2, 1, 64, 32)
    with pytest.raises(ValueError):
        ttk.composite32(feat, ranges.long(), 2, 1, 64, 32)
    with pytest.raises(ValueError):
        ttk.composite32(feat, ranges, 3, 1, 64, 32)
    with pytest.raises(ValueError):
        ttk.composite32(feat[:, :8], ranges, 2, 1, 64, 32)

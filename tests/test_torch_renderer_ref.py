"""The port's dense oracle renderer (ops/renderer_ref.py):

- against the JAX oracle on the tests/test_renderer_ref.py scene: forward
  at that file's tolerances (color atol 2e-5, depth 1e-4, opacity 2e-5,
  n_touched equal), gradients in tau, means, opacities and scales at
  rtol 2e-3, atol 2e-5 + 2e-3 max|g| (both are f32 autodiff of the same
  dense formula; the sums run in another order);
- against the port's own tiled renderer at the tolerances of
  tests/test_renderer_tiled.py:25-72, forward and gradients (the tiled
  gradients go through the plain backward compositing on CPU tensors);
- through the render API (``use_oracle=True``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import renderer_ref as jref
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_ref as tref
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api as tapi

from test_renderer_ref import make_scene

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def _t(a, grad=False):
    x = torch.as_tensor(np.array(a))
    return x.requires_grad_() if grad else x


def _render(fn, sc, bg, tau, means, opac, scales, **kw):
    """One call of a port renderer on a make_scene scene."""
    return fn(means, tgm.build_cov3d(scales, _t(sc["quats"])), opac,
              _t(sc["shs"]), 3, _t(sc["w2c"]), _t(sc["proj"]), tau,
              sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
              sc["tanfovy"], _t(bg), device="cpu", **kw)


def _loss(out, target, tgt_d, lib=torch):
    return (lib.mean(lib.abs(out.color - target))
            + 0.2 * lib.mean(lib.abs(out.depth - tgt_d))
            + 0.1 * lib.mean(out.opacity))


def _grads(fn, sc, bg, target, tgt_d, **kw):
    args = [_t(np.zeros(6, np.float32), True), _t(sc["means"], True),
            _t(sc["opac"], True), _t(sc["scales"], True)]
    out = _render(fn, sc, bg, *args, **kw)
    L = _loss(out, _t(target), _t(tgt_d))
    return [g.numpy() for g in torch.autograd.grad(L, args)]


def _assert_grads(got, ref):
    for a, b, name in zip(ref, got, ["tau", "means", "opac", "scales"]):
        a = np.asarray(a)
        assert np.all(np.isfinite(b)), name
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(
            b, a, rtol=2e-3, atol=2e-5 + 2e-3 * np.abs(a).max(),
            err_msg=name)


def test_oracle_forward_matches_jax():
    sc = make_scene(np.random.default_rng(0))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jref.render(
        jnp.asarray(sc["means"]),
        jgm.build_cov3d(jnp.asarray(sc["scales"]), jnp.asarray(sc["quats"])),
        jnp.asarray(sc["opac"]), jnp.asarray(sc["shs"]), 3,
        jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]), jnp.zeros(6),
        sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"], sc["tanfovy"],
        jnp.asarray(bg))
    with torch.no_grad():
        got = _render(tref.render, sc, bg, _t(np.zeros(6, np.float32)),
                      _t(sc["means"]), _t(sc["opac"]), _t(sc["scales"]))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=2e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=1e-4)
    np.testing.assert_allclose(got.opacity.numpy(), np.asarray(ref.opacity),
                               atol=2e-5)
    np.testing.assert_array_equal(got.n_touched.numpy(),
                                  np.asarray(ref.n_touched))
    assert int(got.n_touched.sum()) > 0 and int(got.overflow) == 0


def test_oracle_gradients_match_jax():
    rng = np.random.default_rng(1)
    sc = make_scene(rng, n=15, W=64, H=40)
    bg = np.array([0.05, 0.1, 0.15], np.float32)
    target = rng.uniform(size=(3, sc["H"], sc["W"])).astype(np.float32)
    tgt_d = rng.uniform(size=(1, sc["H"], sc["W"])).astype(np.float32) * 3

    def jloss(tau, means, opac, scales):
        out = jref.render(
            means, jgm.build_cov3d(scales, jnp.asarray(sc["quats"])), opac,
            jnp.asarray(sc["shs"]), 3, jnp.asarray(sc["w2c"]),
            jnp.asarray(sc["proj"]), tau, sc["fx"], sc["fy"], sc["W"],
            sc["H"], sc["tanfovx"], sc["tanfovy"], jnp.asarray(bg))
        return _loss(out, target, tgt_d, lib=jnp)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.zeros(6), jnp.asarray(sc["means"]), jnp.asarray(sc["opac"]),
        jnp.asarray(sc["scales"]))
    _assert_grads(_grads(tref.render, sc, bg, target, tgt_d), ref)


def test_tiled_matches_oracle_forward():
    sc = make_scene(np.random.default_rng(2), n=25, W=160, H=40)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    args = (_t(np.zeros(6, np.float32)), _t(sc["means"]), _t(sc["opac"]),
            _t(sc["scales"]))
    with torch.no_grad():
        ref = _render(tref.render, sc, bg, *args)
        out = _render(trt.render, sc, bg, *args, pair_capacity=4096)
    np.testing.assert_allclose(out.color.numpy(), ref.color.numpy(),
                               atol=3e-5)
    np.testing.assert_allclose(out.depth.numpy(), ref.depth.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(out.opacity.numpy(), ref.opacity.numpy(),
                               atol=3e-5)
    np.testing.assert_array_equal(out.n_touched.numpy(),
                                  ref.n_touched.numpy())


def test_tiled_matches_oracle_gradients():
    rng = np.random.default_rng(3)
    sc = make_scene(rng, n=15, W=144, H=32)
    bg = np.array([0.05, 0.1, 0.15], np.float32)
    target = rng.uniform(size=(3, sc["H"], sc["W"])).astype(np.float32)
    tgt_d = rng.uniform(size=(1, sc["H"], sc["W"])).astype(np.float32) * 3
    ref = _grads(tref.render, sc, bg, target, tgt_d)
    got = _grads(trt.render, sc, bg, target, tgt_d, pair_capacity=4096)
    _assert_grads(got, ref)


def test_render_api_use_oracle():
    rng = np.random.default_rng(4)
    n = 80
    gm = tgmap.from_numpy(
        xyz=np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.0, 4.0, n)], -1).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2.3,
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32) + 1.0,
        max_sh_degree=0, device="cpu")
    cam = Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, 31.5, 23.5, 64,
                        48, device="cpu")
    with torch.no_grad():
        ora = tapi.render(gm, cam, None, torch.zeros(3), use_oracle=True,
                          device="cpu")
        til = tapi.render(gm, cam, None, torch.zeros(3), pair_capacity=4096,
                          device="cpu")
    np.testing.assert_allclose(til.color.numpy(), ora.color.numpy(),
                               atol=3e-5)
    np.testing.assert_array_equal(til.n_touched.numpy(),
                                  ora.n_touched.numpy())
    assert float(ora.opacity.max()) > 0.5

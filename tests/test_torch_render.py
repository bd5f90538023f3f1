"""The port's forward renderer vs the JAX tiled renderer (Pallas kernel in
interpret mode), on the same scenes: color atol 3e-5, depth atol 2e-4,
opacity atol 3e-5, n_touched exactly equal (tests/test_renderer_tiled.py
tolerances) — with a fresh plan, with a plan reused at a drifted pose
(``radius_pad``), and through the map API after the weights of a JAX
``GaussianMap`` are carried across."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api as tapi

from test_renderer_ref import make_scene

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def _assert_render_equal(got, ref, n_touched=True):
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color),
                               atol=3e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               atol=2e-4)
    np.testing.assert_allclose(got.opacity.numpy(), np.asarray(ref.opacity),
                               atol=3e-5)
    np.testing.assert_allclose(got.mean2d.numpy(), np.asarray(ref.mean2d),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(ref.radii))
    assert int(got.overflow) == int(ref.overflow)
    if n_touched:
        np.testing.assert_array_equal(got.n_touched.numpy(),
                                      np.asarray(ref.n_touched))


def _args(sc, tau):
    cov6 = np.asarray(jgm.build_cov3d(jnp.asarray(sc["scales"]),
                                      jnp.asarray(sc["quats"])))
    arrays = (sc["means"], cov6, sc["opac"], sc["shs"])
    rest = (sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
            sc["tanfovy"])
    jargs = ([jnp.asarray(a) for a in arrays] + [3, jnp.asarray(sc["w2c"]),
             jnp.asarray(sc["proj"]), jnp.asarray(tau)] + list(rest))
    targs = ([torch.as_tensor(np.array(a)) for a in arrays]
             + [3, torch.as_tensor(sc["w2c"]), torch.as_tensor(sc["proj"]),
                torch.as_tensor(tau)] + list(rest))
    return jargs, targs


@pytest.mark.parametrize("need_n_touched,nt_weight",
                         [(True, False), (True, True), (False, False)])
def test_render_matches_jax(need_n_touched, nt_weight):
    sc = make_scene(np.random.default_rng(3), n=30, W=160, H=64)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jargs, targs = _args(sc, np.zeros(6, np.float32))
    kw = dict(pair_capacity=4096, need_n_touched=need_n_touched,
              nt_weight=nt_weight)
    ref = jrt.render(*jargs, jnp.asarray(bg), interpret=True, **kw)
    got = trt.render(*targs, torch.as_tensor(bg), device="cpu", **kw)
    _assert_render_equal(got, ref, need_n_touched)
    if need_n_touched:
        assert int(got.n_touched.sum()) > 0
    else:
        assert int(got.n_touched.abs().sum()) == 0


def test_render_plan_reuse_with_radius_pad():
    """A plan built at one pose (radius_pad 4 px, radius_scale 1.1) and
    reused at a drifted pose, with a matched low-pass as the pyramid's
    coarse levels use it."""
    sc = make_scene(np.random.default_rng(8), n=40, W=128, H=96)
    bg = np.zeros(3, np.float32)
    jargs0, targs0 = _args(sc, np.zeros(6, np.float32))
    tau = np.array([0.004, -0.003, 0.002, 0.001, 0.002, -0.001], np.float32)
    jargs1, targs1 = _args(sc, tau)
    prep_j = jgm.preprocess(*jargs0)
    prep_t = tgm.preprocess(*targs0)
    plan_j = jrt.make_plan(prep_j, sc["W"], sc["H"], 8192, radius_scale=1.1,
                           radius_pad=4.0)
    plan_t = trt.make_plan(prep_t, sc["W"], sc["H"], 8192, radius_scale=1.1,
                           radius_pad=4.0)
    np.testing.assert_array_equal(plan_t.pair_gid1.numpy(),
                                  np.asarray(plan_j.pair_gid1))
    for lp in (0.3, 0.1125):
        ref = jrt.render(*jargs1, jnp.asarray(bg), pair_capacity=8192,
                         interpret=True, plan=plan_j, low_pass=lp)
        got = trt.render(*targs1, torch.as_tensor(bg), pair_capacity=8192,
                         plan=plan_t, low_pass=lp, device="cpu")
        _assert_render_equal(got, ref)


def _jax_map(n=300, seed=2, sh_degree=3):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    return jgmap.from_numpy(
        xyz=np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.0, 4.0, n)], -1).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        features_rest=rng.normal(size=(n, k - 1, 3)).astype(np.float32)
        * 0.1,
        scaling=rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2.6,
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32) + 1.0,
        max_sh_degree=sh_degree, capacity=n + 20)


def test_weights_carried_across_render_the_same():
    gm_j = _jax_map()
    fields = {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS}
    gm_t = tgmap.from_jax_fields(fields, gm_j.max_sh_degree,
                                 gm_j.active_sh_degree, gm_j.isotropic,
                                 device="cpu")
    assert gm_t.capacity == gm_j.capacity and gm_t.active_sh_degree == 3
    np.testing.assert_allclose(gm_t.get_cov6().numpy(),
                               np.asarray(gm_j.get_cov6()), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gm_t.get_opacity().numpy(),
                               np.asarray(gm_j.get_opacity()), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(gm_t.get_features().numpy(),
                                  np.asarray(gm_j.get_features()))
    np.testing.assert_array_equal(gm_t.active.numpy(),
                                  np.asarray(gm_j.active))

    W, H = 96, 64
    R = np.asarray(jnp.eye(3))
    t = np.array([0.02, -0.01, 0.05], np.float32)
    cam_j = JCamera.create(R, t, 60.0, 60.0, (W - 1) / 2, (H - 1) / 2, W, H)
    cam_t = Camera.create(R, t, 60.0, 60.0, (W - 1) / 2, (H - 1) / 2, W, H,
                          device="cpu")
    ref = japi.render(gm_j, cam_j, None, jnp.zeros(3), pair_capacity=8192,
                      interpret=True)
    got = tapi.render(gm_t, cam_t, None, torch.zeros(3), pair_capacity=8192,
                      device="cpu")
    _assert_render_equal(got, ref)

    # a map built in the port from the same numpy arrays agrees as well
    gm_t2 = tgmap.from_numpy(
        **{f: np.asarray(getattr(gm_j, f))[:300] for f in
           ("xyz", "features_dc", "features_rest", "scaling", "rotation",
            "opacity")}, max_sh_degree=3, capacity=320, device="cpu")
    for f in tgmap.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(gm_t2, f).numpy(),
                                      getattr(gm_t, f).numpy(), err_msg=f)


def test_unported_flags_raise():
    """The 16x16 kernels have no bf16 and no mxu bodies: the port raises
    instead of ignoring them (the reference's tile16 branch silently drops
    bf16/mxu, ops/renderer_tiled.py:149). mxu alone is ported: it renders
    (on the CPU through the plain MXU body, no launch); bf16 alone and mxu
    alone are held against JAX in tests/test_torch_bf16.py and
    tests/test_torch_mxu.py."""
    sc = make_scene(np.random.default_rng(3), n=10, W=64, H=32)
    _, targs = _args(sc, np.zeros(6, np.float32))
    for flags in ({"tile16": True, "mxu": True},
                  {"tile16": True, "bf16": True}):
        with pytest.raises(NotImplementedError):
            trt.render(*targs, torch.zeros(3), device="cpu", **flags)
    from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk
    before = ttk.composite32_fwd_ntouch.launches_mxu
    out = trt.render(*targs, torch.zeros(3), device="cpu", mxu=True)
    ref = trt.render(*targs, torch.zeros(3), device="cpu")
    assert ttk.composite32_fwd_ntouch.launches_mxu == before
    assert float((out.color - ref.color).abs().max()) < 1e-3
    assert float(out.opacity.max()) > 0.1

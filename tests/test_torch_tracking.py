"""The trackers of the port vs the JAX reference (Pallas kernels in
interpret mode) on the tests/test_tracking.py small scene (96x64, 600
Gaussians).

- pyramid helpers and the flow Jacobian: atol 1e-6;
- one IRLS iteration's (H, g): rtol 1e-4;
- one exact iteration's L and g = dL/d(tau, a, b) (renderer backward):
  rtol 1e-3;
- track_frame_pyr (curv="flow", levels (2, 1), level_iters (4, 6),
  level_exact (0, 0), final_level 1): final R and t within 1e-4,
  iteration counts within 1 (the ||tau|| < 1e-4 convergence test is a
  threshold), keyframing n_touched totals within 0.5% (the two final
  poses differ slightly; exact n_touched equality is tested at a fixed
  pose in test_torch_composite.py);
- track_frame_pyr with exact iterations (levels (2, 1), iters (3, 4):
  level_exact (0, 2) under curv="flow", and curv="fd" at its default
  all-exact schedule): R and t within 1e-4, iterations within 1;
- polish_frame: R and t within 1e-4, iterations equal; once more through
  the dense oracle (use_oracle=True);
- track_frame_gn (max_iters 4) and track_frame (Adam, max_iters 5): R,
  t and exposures within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.models.camera import PoseState as JPose
from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
from gs_slam_analytica_jacobian_tpu.ops.lie import se3_exp as jse3_exp
from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
from gs_slam_analytica_jacobian_tpu.slam import tracking as jtr
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.models.camera import PoseState
from gs_slam_analytica_jacobian_tpu_torch.ops import losses as tlosses
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api as tapi
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking as ttr

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)

W, H = 96, 64
CAP = 1 << 13


def T(x):
    return torch.tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    """tests/test_tracking.py::small_scene, built in both packages from
    the same numpy arrays; ground truth rendered by the reference."""
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 60.0, 60.0,
                           (W - 1) / 2, (H - 1) / 2, W, H)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 60.0, 60.0,
                          (W - 1) / 2, (H - 1) / 2, W, H, device="cpu")
    rng = np.random.default_rng(3)
    n = 600
    gm_j = jgmap.from_numpy(
        xyz=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(0.5, 4.0, n)], -1).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2.3,
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32) + 1.0,
        max_sh_degree=0)
    gm_t = tgmap.from_jax_fields(
        {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS},
        gm_j.max_sh_degree, gm_j.active_sh_degree, device="cpu")
    out = japi.render(gm_j, cam_j, None, jnp.zeros(3), pair_capacity=CAP,
                      interpret=True)
    gt_image = np.clip(np.asarray(out.color), 0, 1)
    gt_depth = np.asarray(out.depth)
    mask = np.asarray(jlosses.compute_grad_mask(
        jnp.asarray(gt_image.mean(axis=0, keepdims=True)), 1.1, "replica"))
    tau = np.array([0.015, -0.012, 0.015, 0.005, 0.007, -0.004], np.float32)
    T0 = np.asarray(jse3_exp(jnp.asarray(tau)))
    return dict(cam_j=cam_j, cam_t=cam_t, gm_j=gm_j, gm_t=gm_t,
                gt_image=gt_image, gt_depth=gt_depth, mask=mask,
                R0=T0[:3, :3], t0=T0[:3, 3])


def test_pyramid_helpers_and_cam_level():
    x = np.random.default_rng(0).normal(size=(3, 68, 120)).astype(np.float32)
    for s in (2, 3, 4):
        for name in ("_pool_avg", "_pool_max", "_stride_center"):
            a = getattr(ttr, name)(T(x), s).numpy()
            b = np.asarray(getattr(jtr, name)(jnp.asarray(x), s))
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                       err_msg=(name, s))
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 600.0, 600.0, 599.5,
                           339.5, 1200, 680)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 600.0, 600.0, 599.5,
                          339.5, 1200, 680, device="cpu")
    for s in (1, 2, 4):
        cj, ct = jtr._cam_level(cam_j, s), ttr._cam_level(cam_t, s)
        for f in ("fx", "fy", "cx", "cy", "width", "height"):
            assert getattr(cj, f) == getattr(ct, f), (s, f)


def test_flow_jacobian_and_grad_mask_match(scene):
    sc = scene
    out_j = japi.render(sc["gm_j"], sc["cam_j"], None, jnp.zeros(3),
                        pair_capacity=CAP, interpret=True)
    img, dep, opa = (np.asarray(out_j.color), np.asarray(out_j.depth),
                     np.asarray(out_j.opacity))
    Jc_j, Jd_j = jtr._flow_jacobian(sc["cam_j"], jnp.asarray(img),
                                    jnp.asarray(dep), jnp.asarray(opa))
    Jc_t, Jd_t = ttr._flow_jacobian(sc["cam_t"], T(img), T(dep), T(opa))
    np.testing.assert_allclose(Jc_t.numpy(), np.asarray(Jc_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(Jd_t.numpy(), np.asarray(Jd_j), atol=1e-6,
                               rtol=0)
    gray = img.mean(axis=0, keepdims=True)
    for kind in ("replica", "generic"):
        np.testing.assert_array_equal(
            tlosses.compute_grad_mask(T(gray), 1.1, kind).numpy(),
            np.asarray(jlosses.compute_grad_mask(jnp.asarray(gray), 1.1,
                                                 kind)), err_msg=kind)
    np.testing.assert_allclose(
        float(tlosses.median_depth(T(dep), T(opa))),
        float(jlosses.median_depth(jnp.asarray(dep), jnp.asarray(opa))),
        rtol=1e-6)


def _jax_assemble_Hg(Jc, Jd, image_ab, depth, opacity, sigma, gt_image,
                     gt_depth, grad_mask, alpha=0.95, lm_lambda=1e-2):
    """The reference's assemble_Hg (slam/tracking.py:604-624, a closure
    of _gn_level) written out in jnp; checked against the reference's own
    H below."""
    n3hw = 3.0 * gt_image.shape[1] * gt_image.shape[2]
    nhw = float(gt_image.shape[1] * gt_image.shape[2])
    rgb_mask = (gt_image.sum(axis=0, keepdims=True) > 0.01).astype(
        jnp.float32)
    Jc_f, Jd_f = Jc.reshape(8, -1), Jd.reshape(8, -1)
    jn_c = jnp.sqrt(jnp.sum(Jc[:6] * Jc[:6], axis=0))
    jn_d = jnp.sqrt(jnp.sum(Jd[:6] * Jd[:6], axis=0))
    r_c = image_ab - gt_image
    w_c = ((opacity * grad_mask * rgb_mask)
           / (jnp.abs(r_c) + 1e-3 + jn_c * sigma))
    w_c = alpha * w_c / n3hw
    H_mat = (Jc_f * w_c.reshape(1, -1)) @ Jc_f.T
    g_vec = Jc_f @ (w_c * r_c).reshape(-1)
    depth_mask = ((gt_depth > 0.01) & (opacity > 0.95)).astype(jnp.float32)
    r_d = depth - gt_depth
    w_d = ((1.0 - alpha) * depth_mask
           / (jnp.abs(r_d) + 1e-3 + jn_d * sigma) / nhw)
    H_mat = H_mat + (Jd_f * w_d.reshape(1, -1)) @ Jd_f.T
    g_vec = g_vec + Jd_f @ (w_d * r_d).reshape(-1)
    H_mat = H_mat + lm_lambda * jnp.diag(jnp.maximum(jnp.diag(H_mat), 1e-8))
    return H_mat + 1e-8 * jnp.eye(8), g_vec


def test_one_irls_iteration_H_g_match(scene):
    sc = scene
    gt_i, gt_d, mask = sc["gt_image"], sc["gt_depth"], sc["mask"]
    # the reference's level loop, one iteration: returns that iteration's H
    res_j = jtr._gn_level(
        sc["gm_j"], sc["cam_j"], jnp.asarray(sc["R0"]), jnp.asarray(sc["t0"]),
        jnp.zeros(()), jnp.zeros(()), jnp.asarray(gt_i), jnp.asarray(gt_d),
        jnp.asarray(mask), jnp.zeros(3), 0.01, 0.95, False, 1, CAP, True,
        False, 1e-3, 1e-2, 4.0, H_frozen=None, curv="flow", exact_iters=0)
    res_t = ttr._gn_level(
        sc["gm_t"], sc["cam_t"], T(sc["R0"]), T(sc["t0"]), torch.zeros(()),
        torch.zeros(()), T(gt_i), T(gt_d), T(mask), torch.zeros(3), 0.01,
        0.95, False, 1, CAP, 1e-2, 4.0, H_frozen=None, curv="flow",
        exact_iters=0)
    H_ref = np.asarray(res_j[5][0])
    np.testing.assert_allclose(res_t[5][0].numpy(), H_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(H_ref).max())
    # the step's length (sigma tracks |delta| here) pins H^-1 g as well
    np.testing.assert_allclose(float(res_t[7]), float(res_j[7]), rtol=1e-4)
    np.testing.assert_array_equal(res_t[6].pair_gid1.numpy(),
                                  np.asarray(res_j[6].pair_gid1))

    # (H, g) from the same render of the start pose
    cam_j = sc["cam_j"].replace(R=jnp.asarray(sc["R0"]),
                                t=jnp.asarray(sc["t0"]))
    out_j = japi.render(sc["gm_j"], cam_j, None, jnp.zeros(3),
                        pair_capacity=CAP, interpret=True, plan=res_j[6],
                        need_n_touched=False)
    Jc, Jd = jtr._flow_jacobian(cam_j, out_j.color, out_j.depth,
                                out_j.opacity)
    H_copy, g_ref = _jax_assemble_Hg(Jc, Jd, out_j.color, out_j.depth,
                                     out_j.opacity, 0.01, jnp.asarray(gt_i),
                                     jnp.asarray(gt_d), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(H_copy), H_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(H_ref).max())
    cam_t = sc["cam_t"].replace(R=T(sc["R0"]), t=T(sc["t0"]))
    out_t = tapi.render(sc["gm_t"], cam_t, PoseState.zero(device="cpu"),
                        torch.zeros(3), plan=res_t[6], need_n_touched=False,
                        device="cpu")
    Jc_t, Jd_t = ttr._flow_jacobian(cam_t, out_t.color, out_t.depth,
                                    out_t.opacity)
    H_t, g_t = ttr.assemble_Hg(Jc_t, Jd_t, out_t.color, out_t.depth,
                               out_t.opacity, 0.01, T(gt_i), T(gt_d),
                               T(mask), 0.01, 0.95, False, 1e-2)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(H_t.numpy(), H_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(H_ref).max())
    np.testing.assert_allclose(g_t.numpy(), g_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(g_ref).max())


def test_track_frame_pyr_matches_jax(scene):
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, levels=(2, 1), level_iters=(4, 6),
              level_exact=(0, 0), curv="flow", final_level=1,
              match_blur=True, plan_pad=4.0)
    res_j = jtr.track_frame_pyr(
        sc["gm_j"], sc["cam_j"], jnp.asarray(sc["R0"]),
        jnp.asarray(sc["t0"]), jnp.asarray(sc["gt_image"]),
        jnp.asarray(sc["gt_depth"]), jnp.asarray(sc["mask"]), jnp.zeros(3),
        interpret=True, **kw)
    res_t = ttr.track_frame_pyr(
        sc["gm_t"], sc["cam_t"], T(sc["R0"]), T(sc["t0"]),
        T(sc["gt_image"]), T(sc["gt_depth"]), T(sc["mask"]), torch.zeros(3),
        device="cpu", **kw)
    R_j, t_j = np.asarray(res_j[0]), np.asarray(res_j[1])
    R_t, t_t = res_t[0].numpy(), res_t[1].numpy()
    assert np.linalg.norm(t_t - t_j) < 1e-4, (t_t, t_j)
    assert np.linalg.norm(R_t - R_j) < 1e-4
    assert abs(int(res_t[4]) - int(res_j[4])) <= 1, (res_t[4], res_j[4])
    # it tracked: the start pose was ~2.4 cm off the identity ground truth
    assert np.linalg.norm(t_t) < 2e-3
    nt_j = float(np.asarray(res_j[5].n_touched).sum())
    nt_t = float(res_t[5].n_touched.sum())
    assert nt_j > 0 and abs(nt_t - nt_j) <= 0.005 * nt_j, (nt_t, nt_j)
    np.testing.assert_array_equal(res_t[8].numpy(), np.asarray(res_j[8]))
    np.testing.assert_array_equal(res_t[10].numpy(), np.asarray(res_j[10]))
    assert np.isfinite(float(res_t[6]))
    np.testing.assert_allclose(float(res_t[6]), float(res_j[6]), rtol=1e-3)


def test_track_frame_pyr_tile16_matches_jax(scene):
    """The pyramid tracker on 16-px plans and the 16x16 kernels (the
    reference's tile16 switch): final R and t within 1e-4, iterations
    within 1, the per-level pair counts equal."""
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, levels=(2, 1), level_iters=(3, 4),
              level_exact=(0, 0), curv="flow", final_level=1,
              match_blur=True, plan_pad=4.0, tile16=True)
    res_j = jtr.track_frame_pyr(
        sc["gm_j"], sc["cam_j"], jnp.asarray(sc["R0"]),
        jnp.asarray(sc["t0"]), jnp.asarray(sc["gt_image"]),
        jnp.asarray(sc["gt_depth"]), jnp.asarray(sc["mask"]), jnp.zeros(3),
        interpret=True, **kw)
    res_t = ttr.track_frame_pyr(
        sc["gm_t"], sc["cam_t"], T(sc["R0"]), T(sc["t0"]),
        T(sc["gt_image"]), T(sc["gt_depth"]), T(sc["mask"]), torch.zeros(3),
        device="cpu", **kw)
    np.testing.assert_allclose(res_t[1].numpy(), np.asarray(res_j[1]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res_t[0].numpy(), np.asarray(res_j[0]),
                               rtol=0, atol=1e-4)
    assert abs(int(res_t[4]) - int(res_j[4])) <= 1, (res_t[4], res_j[4])
    np.testing.assert_array_equal(res_t[10].numpy(), np.asarray(res_j[10]))
    # it tracked: the start pose was ~2.4 cm off the identity ground truth
    assert np.linalg.norm(res_t[1].numpy()) < 5e-3


@pytest.mark.parametrize("flag", [
    dict(kernel_bf16=True), dict(kernel_mxu=True),
    dict(level_subset=(1.0, 0.5))])
def test_unported_tracker_options_raise(scene, flag):
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, levels=(2, 1), level_iters=(1, 1),
              level_exact=(0, 0), curv="flow", device="cpu")
    kw.update(flag)
    with pytest.raises(NotImplementedError):
        ttr.track_frame_pyr(sc["gm_t"], sc["cam_t"], T(sc["R0"]),
                            T(sc["t0"]), T(sc["gt_image"]),
                            T(sc["gt_depth"]), T(sc["mask"]), torch.zeros(3),
                            **kw)


def _frame_args(sc, jax_side):
    if jax_side:
        return (sc["gm_j"], sc["cam_j"], jnp.asarray(sc["R0"]),
                jnp.asarray(sc["t0"]), jnp.asarray(sc["gt_image"]),
                jnp.asarray(sc["gt_depth"]), jnp.asarray(sc["mask"]),
                jnp.zeros(3))
    return (sc["gm_t"], sc["cam_t"], T(sc["R0"]), T(sc["t0"]),
            T(sc["gt_image"]), T(sc["gt_depth"]), T(sc["mask"]),
            torch.zeros(3))


def _assert_pose(res_t, res_j, n_exposure=0, iters_tol=1):
    R_j, t_j = np.asarray(res_j[0]), np.asarray(res_j[1])
    assert np.all(np.isfinite(res_t[0].numpy()))
    assert np.linalg.norm(res_t[1].numpy() - t_j) < 1e-4, (res_t[1], t_j)
    assert np.linalg.norm(res_t[0].numpy() - R_j) < 1e-4
    for k in range(2, 2 + n_exposure):
        assert abs(float(res_t[k]) - float(res_j[k])) < 1e-4, k
    assert abs(int(res_t[4]) - int(res_j[4])) <= iters_tol, (res_t[4],
                                                           res_j[4])


def test_one_exact_iteration_L_g_match(scene):
    """L and dL/d(tau, a, b) at the start pose through the renderer's
    backward, on the plan polish_frame builds there."""
    import jax

    sc = scene
    args_j, args_t = _frame_args(sc, True), _frame_args(sc, False)
    ea, eb = 0.05, -0.02
    cam_j = sc["cam_j"].replace(R=args_j[2], t=args_j[3])
    plan_j = japi.make_render_plan(sc["gm_j"], cam_j, pair_capacity=CAP,
                                   radius_scale=1.1, radius_pad=2.0)

    def jloss(tau, a, b):
        out = japi.render(sc["gm_j"], cam_j,
                          JPose(tau=tau, exposure_a=jnp.zeros(()),
                                         exposure_b=jnp.zeros(())),
                          jnp.zeros(3), pair_capacity=CAP, interpret=True,
                          plan=plan_j, need_n_touched=False)
        img = jlosses.apply_exposure(out.color, a, b)
        return jlosses.loss_tracking_rgbd(
            img, out.depth, args_j[4], args_j[5], out.opacity, args_j[6],
            0.01, 0.95)

    L_j, (g_tau, g_a, g_b) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.zeros(6), jnp.float32(ea), jnp.float32(eb))
    g_j = np.concatenate([np.asarray(g_tau), [float(g_a), float(g_b)]])

    cam_t = sc["cam_t"].replace(R=args_t[2], t=args_t[3])
    plan_t = tapi.make_render_plan(sc["gm_t"], cam_t, pair_capacity=CAP,
                                   radius_scale=1.1, radius_pad=2.0,
                                   device="cpu")
    zero = torch.zeros(())

    def render_at(tau):
        return tapi.render(sc["gm_t"], cam_t,
                           PoseState(tau=tau, exposure_a=zero,
                                     exposure_b=zero),
                           torch.zeros(3), pair_capacity=CAP, plan=plan_t,
                           need_n_touched=False, device="cpu")

    L_t, g_t, aux = ttr._value_and_grad(
        render_at, torch.tensor(ea), torch.tensor(eb),
        (args_t[4], args_t[5], args_t[6], 0.01, 0.95, False))
    np.testing.assert_allclose(float(L_t), float(L_j), rtol=1e-3)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    assert np.abs(g_j[:6]).max() > 0 and not aux[0].requires_grad


def test_polish_frame_matches_jax(scene):
    sc = scene
    kw = dict(rgb_boundary_threshold=0.01, pair_capacity=CAP)
    a_j, a_t = _frame_args(sc, True), _frame_args(sc, False)
    res_j = jtr.polish_frame(*a_j[:4], jnp.float32(0.02), jnp.float32(0.0),
                             *a_j[4:], interpret=True, **kw)
    res_t = ttr.polish_frame(*a_t[:4], torch.tensor(0.02), torch.tensor(0.0),
                             *a_t[4:], device="cpu", **kw)
    _assert_pose(res_t, res_j, n_exposure=2, iters_tol=0)
    assert int(res_t[4]) == 2
    # it moved toward the identity ground truth
    assert np.linalg.norm(res_t[1].numpy()) < np.linalg.norm(sc["t0"])


@pytest.mark.parametrize("flags", [dict(curv="flow", level_exact=(0, 2)),
                                   dict(curv="fd")])
def test_track_frame_pyr_exact_matches_jax(scene, flags):
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, levels=(2, 1), level_iters=(3, 4),
              plan_pad=4.0, **flags)
    res_j = jtr.track_frame_pyr(*_frame_args(sc, True), interpret=True,
                                **kw)
    res_t = ttr.track_frame_pyr(*_frame_args(sc, False), device="cpu", **kw)
    _assert_pose(res_t, res_j, n_exposure=2)
    assert np.linalg.norm(res_t[1].numpy()) < 5e-3
    for (Hj, Jcj, _), (Ht, Jct, _) in zip(res_j[7], res_t[7]):
        assert (Jct is None) == (Jcj is None)
        assert Ht.shape == (8, 8) and bool(torch.isfinite(Ht).all())
    if flags["curv"] == "fd":
        # the coarse level probed J; the finest reused its H (_strip_J)
        assert res_t[7][0][1] is not None and res_t[7][1][1] is None


def test_track_frame_gn_matches_jax(scene):
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, max_iters=4)
    res_j = jtr.track_frame_gn(*_frame_args(sc, True), interpret=True, **kw)
    res_t = ttr.track_frame_gn(*_frame_args(sc, False), device="cpu", **kw)
    _assert_pose(res_t, res_j, n_exposure=2, iters_tol=0)
    assert np.linalg.norm(res_t[1].numpy()) < np.linalg.norm(sc["t0"])
    np.testing.assert_allclose(float(res_t[6]), float(res_j[6]), rtol=1e-3)


def test_track_frame_adam_matches_jax(scene):
    sc = scene
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, max_iters=5)
    res_j = jtr.track_frame(*_frame_args(sc, True), interpret=True, **kw)
    res_t = ttr.track_frame(*_frame_args(sc, False), device="cpu", **kw)
    _assert_pose(res_t, res_j, n_exposure=2, iters_tol=0)
    nt_j = float(np.asarray(res_j[5].n_touched).sum())
    assert nt_j > 0 and abs(float(res_t[5].n_touched.sum()) - nt_j) \
        <= 0.005 * nt_j


def test_polish_frame_oracle_matches_jax(scene):
    sc = scene
    kw = dict(rgb_boundary_threshold=0.01, pair_capacity=CAP,
              use_oracle=True)
    a_j, a_t = _frame_args(sc, True), _frame_args(sc, False)
    res_j = jtr.polish_frame(*a_j[:4], jnp.float32(0.0), jnp.float32(0.0),
                             *a_j[4:], interpret=True, **kw)
    res_t = ttr.polish_frame(*a_t[:4], torch.tensor(0.0), torch.tensor(0.0),
                             *a_t[4:], device="cpu", **kw)
    _assert_pose(res_t, res_j, n_exposure=2, iters_tol=0)


MID_W, MID_H, MID_F, MID_CAP = 300, 170, 150.0, 1 << 17


@pytest.fixture(scope="module")
def room_midsize():
    """The chip run's room map and trajectory cut to mid size (the bench
    scene at 20k Gaussians, 300x170, fx 150) in both packages, with the
    ground truth of frames 0..3 rendered by the reference."""
    import chip_smoke
    from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map

    gm_j = jgmap.from_numpy(**make_room_map(20000, np.random.default_rng(0)),
                            max_sh_degree=0)
    gm_t = tgmap.from_jax_fields(
        {k: np.asarray(getattr(gm_j, k)) for k in tgmap.ARRAY_FIELDS}, 0, 0,
        device="cpu")
    poses = chip_smoke.pose_list()[:4]
    intr = (MID_F, MID_F, (MID_W - 1) / 2, (MID_H - 1) / 2, MID_W, MID_H)
    gts = []
    for Tp in poses:
        out = japi.render(gm_j, JCamera.create(Tp[:3, :3], Tp[:3, 3], *intr),
                          None, jnp.zeros(3), pair_capacity=MID_CAP,
                          interpret=True)
        img = np.clip(np.asarray(out.color), 0, 1)
        mask = np.asarray(jlosses.compute_grad_mask(
            jnp.asarray(img.mean(axis=0, keepdims=True)), 1.1, "replica"))
        gts.append((img, np.asarray(out.depth), mask))
    return dict(gm_j=gm_j, gm_t=gm_t, poses=poses, gts=gts,
                cam_j=JCamera.create(np.eye(3), np.zeros(3), *intr),
                cam_t=Camera.create(np.eye(3), np.zeros(3), *intr,
                                    device="cpu"),
                warm=(chip_smoke.cv_start, chip_smoke.ca_start))


@pytest.mark.slow
@pytest.mark.parametrize("carry_H", [False, True])
def test_exact_pyramid_room_parity_midsize(room_midsize, carry_H):
    """track_frame_pyr at the reference's all-exact defaults (levels
    (4, 2, 1), iters (5, 3, 12), curv "fd") over frames 1..3 of the chip
    run's trajectory on the mid-size room, without and with each frame's
    H handed to the next (each package its own). Both packages start each
    frame from the same warm start, predicted from the JAX tracker's
    estimates as the chip run's exact-pyramid path predicts from its own
    (constant velocity, then constant acceleration): on every frame the
    port lands on the JAX pose (within 1e-4), exposures (1e-3 relative)
    and error, and both stay above 1 mm. Chained on its own estimates
    instead, each package drifts from the other by up to ~0.4 mm within a
    frame: the exact steps' accept/reject decisions amplify differences
    of 1e-5 in the start. About 5 minutes per case on one CPU worker
    (``-m slow``)."""
    rm = room_midsize
    cv_start, ca_start = rm["warm"]
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=MID_CAP, levels=(4, 2, 1), level_iters=(5, 3, 12))
    est = [(T(rm["poses"][0][:3, :3]), T(rm["poses"][0][:3, 3]))]
    H_j = H_t = None
    for k in (1, 2, 3):
        if len(est) >= 3:
            Rw, tw = ca_start(*est[-1], *est[-2], *est[-3])
        elif len(est) == 2:
            Rw, tw = cv_start(*est[-1], *est[-2])
        else:
            Rw, tw = est[-1]
        img, dep, mask = rm["gts"][k]
        res_j = jtr.track_frame_pyr(
            rm["gm_j"], rm["cam_j"], jnp.asarray(Rw.numpy()),
            jnp.asarray(tw.numpy()), jnp.asarray(img), jnp.asarray(dep),
            jnp.asarray(mask), jnp.zeros(3), interpret=True,
            H_in=H_j if carry_H else None, **kw)
        res_t = ttr.track_frame_pyr(
            rm["gm_t"], rm["cam_t"], Rw, tw, T(img), T(dep), T(mask),
            torch.zeros(3), device="cpu", H_in=H_t if carry_H else None,
            **kw)
        H_j, H_t = res_j[7], res_t[7]
        est.append((T(res_j[0]), T(res_j[1])))
        _assert_pose(res_t, res_j)
        np.testing.assert_allclose(
            [float(res_t[2]), float(res_t[3])],
            [float(res_j[2]), float(res_j[3])], rtol=1e-3, atol=1e-4)
        t_gt = rm["poses"][k][:3, 3]
        err_j = np.linalg.norm(np.asarray(res_j[1]) - t_gt)
        err_t = np.linalg.norm(res_t[1].numpy() - t_gt)
        assert abs(err_t - err_j) < 1e-4 and err_j > 1e-3, (k, err_t, err_j)


@pytest.mark.slow
def test_main_path_tile16_room_parity_midsize(room_midsize):
    """The chip run's main-path schedule (levels (4, 2, 1), iters (5, 12,
    2), flow curvature, final level 2, matched blur, pad 4) on 16-px plans
    and the 16x16 kernels, over frames 1..3 of the mid-size room, each
    frame from the same warm start predicted from the JAX estimates: on
    every frame the port lands on the JAX pose (within 1e-4) and error,
    with the same per-level pair counts. About 3 minutes on one CPU worker
    (``-m slow``)."""
    rm = room_midsize
    cv_start, ca_start = rm["warm"]
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=MID_CAP, levels=(4, 2, 1), level_iters=(5, 12, 2),
              level_exact=(0, 0, 0), curv="flow", final_level=2,
              match_blur=True, plan_pad=4.0, tile16=True)
    est = [(T(rm["poses"][0][:3, :3]), T(rm["poses"][0][:3, 3]))]
    for k in (1, 2, 3):
        if len(est) >= 3:
            Rw, tw = ca_start(*est[-1], *est[-2], *est[-3])
        elif len(est) == 2:
            Rw, tw = cv_start(*est[-1], *est[-2])
        else:
            Rw, tw = est[-1]
        img, dep, mask = rm["gts"][k]
        res_j = jtr.track_frame_pyr(
            rm["gm_j"], rm["cam_j"], jnp.asarray(Rw.numpy()),
            jnp.asarray(tw.numpy()), jnp.asarray(img), jnp.asarray(dep),
            jnp.asarray(mask), jnp.zeros(3), interpret=True, **kw)
        res_t = ttr.track_frame_pyr(
            rm["gm_t"], rm["cam_t"], Rw, tw, T(img), T(dep), T(mask),
            torch.zeros(3), device="cpu", **kw)
        est.append((T(res_j[0]), T(res_j[1])))
        _assert_pose(res_t, res_j)
        np.testing.assert_array_equal(res_t[10].numpy(), np.asarray(res_j[10]))
        t_gt = rm["poses"][k][:3, 3]
        err_j = np.linalg.norm(np.asarray(res_j[1]) - t_gt)
        err_t = np.linalg.norm(res_t[1].numpy() - t_gt)
        assert abs(err_t - err_j) < 1e-4, (k, err_t, err_j)


@pytest.mark.slow
def test_polish_frame_room_parity_midsize(room_midsize):
    """polish_frame on the mid-size room from frame 1's IRLS pose (the
    JAX tracker at the chip run's main-path schedule, from frame 0's
    pose): the port returns the JAX pose and exposures, and both reject
    every step of the 2-iteration polish, returning the IRLS pose. About
    a minute on one CPU worker (``-m slow``)."""
    rm = room_midsize
    img, dep, mask = rm["gts"][1]
    R0, t0 = rm["poses"][0][:3, :3], rm["poses"][0][:3, 3]
    irls = jtr.track_frame_pyr(
        rm["gm_j"], rm["cam_j"], jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(img), jnp.asarray(dep), jnp.asarray(mask), jnp.zeros(3),
        lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
        pair_capacity=MID_CAP, levels=(4, 2, 1), level_iters=(5, 12, 2),
        level_exact=(0, 0, 0), curv="flow", final_level=2, match_blur=True,
        plan_pad=4.0, interpret=True)
    R_i, t_i, ea, eb = [np.asarray(x) for x in irls[:4]]
    res_j = jtr.polish_frame(
        rm["gm_j"], rm["cam_j"], jnp.asarray(R_i), jnp.asarray(t_i),
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(img), jnp.asarray(dep),
        jnp.asarray(mask), jnp.zeros(3), 0.01, pair_capacity=MID_CAP,
        interpret=True)
    res_t = ttr.polish_frame(
        rm["gm_t"], rm["cam_t"], T(R_i), T(t_i), T(ea), T(eb), T(img),
        T(dep), T(mask), torch.zeros(3), 0.01, pair_capacity=MID_CAP,
        device="cpu")
    _assert_pose(res_t, res_j, n_exposure=2, iters_tol=0)
    np.testing.assert_array_equal(np.asarray(res_j[1]), t_i)
    np.testing.assert_array_equal(res_t[1].numpy(), t_i)

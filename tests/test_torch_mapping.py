"""The port's mapping building blocks vs the JAX reference, on the same
numpy inputs made from a seed:

- map Adam over 3 steps: parameters and moments within rtol 1e-6;
- extend / prune (with overflow), the opacity resets, grow, the
  densification statistics and densify_and_prune (the reference's split
  draws handed to the port): every field exactly, floats within 1e-6;
- k-NN: exact (300 points) and Morton (above the 16384-point switch):
  rtol 1e-5;
- seed_from_frame at downsample_factor 1 (every valid pixel kept in
  both) with an even count of valid depths, which pins the median: 1e-6,
  log-scales 2e-5 (the k-NN distances' rtol 1e-5, halved by the log of a
  square root);
- mapping losses, L1, PSNR and SSIM: rtol 1e-5;
- KFStore quantization: codes exactly, dequantized values within 1e-7;
- color_refinement_steps (2 iterations, tiled, Pallas in interpret
  mode): as test_torch_mapping_steps.py holds mapping_steps;
- BackEnd: a port-only run over 4 keyframes that crosses a densify event.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.ops import knn as jknn
from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
from gs_slam_analytica_jacobian_tpu.slam import mapping as jmapping
from gs_slam_analytica_jacobian_tpu.slam import seeding as jseeding
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import knn as tknn
from gs_slam_analytica_jacobian_tpu_torch.ops import losses as tlosses
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping as tmapping
from gs_slam_analytica_jacobian_tpu_torch.slam import seeding as tseeding
from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)


def T(x):
    return torch.tensor(np.array(x))


def _block_arrays(rng, n, valid=None):
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=(rng.normal(size=(n, 3)) * 0.5 - 2.0).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        kf_id=rng.integers(0, 5, n).astype(np.int32),
        valid=(np.ones(n, bool) if valid is None else valid))


def _blocks(arrays):
    return (jgmap.ParamBlock(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tgmap.ParamBlock(**{k: T(v) for k, v in arrays.items()}))


def _maps(rng, n=40, cap=64):
    """The same map in both packages: ``n`` Gaussians extended into an
    empty capacity-``cap`` map, with random statistics."""
    bj, bt = _blocks(_block_arrays(rng, n))
    gj = jgmap.GaussianMap.empty(cap, 0)
    gt = tgmap.GaussianMap.empty(cap, 0, device="cpu")
    gj, sj, _ = jgmap.extend(gj, jgmap.adam_init(gj), bj)
    gt, st, _ = tgmap.extend(gt, tgmap.adam_init(gt), bt)
    stats = dict(
        xyz_grad_accum=rng.uniform(0, 2e-3, cap).astype(np.float32),
        denom=rng.integers(0, 3, cap).astype(np.float32),
        max_radii2d=rng.uniform(0, 40, cap).astype(np.float32))
    gj = gj.replace(**{k: jnp.asarray(v) for k, v in stats.items()})
    gt = gt.replace(**{k: T(v) for k, v in stats.items()})
    return gj, sj, gt, st


def _assert_maps_equal(gj, gt, sj=None, st=None, atol=1e-6):
    for f in tgmap.ARRAY_FIELDS:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)
    if sj is not None:
        for f in tgmap.PARAM_FIELDS:
            np.testing.assert_allclose(st.m[f].numpy(), np.asarray(sj.m[f]),
                                       rtol=0, atol=atol, err_msg=f)
            np.testing.assert_allclose(st.v[f].numpy(), np.asarray(sj.v[f]),
                                       rtol=0, atol=atol, err_msg=f)
        assert int(st.step) == int(sj.step)


def test_adam_three_steps_match(rng):
    gj, sj, gt, st = _maps(rng)
    op = dict(position_lr_init=1.6e-4, feature_lr=2.5e-3, opacity_lr=0.05,
              scaling_lr=1e-3, rotation_lr=1e-3)
    lj = jgmap.default_lrs(op, 5.0)
    lt = tgmap.default_lrs(op, 5.0, device="cpu")
    for f in tgmap.PARAM_FIELDS:
        assert float(lt[f]) == float(lj[f]), f
    for _ in range(3):
        g = {f: rng.normal(size=getattr(gt, f).shape).astype(np.float32)
             * np.asarray(gj.active).reshape((-1,) + (1,) * (
                 getattr(gt, f).dim() - 1))
             for f in tgmap.PARAM_FIELDS}
        gj, sj = jgmap.adam_update(gj, {k: jnp.asarray(v)
                                        for k, v in g.items()}, sj, lj)
        gt, st = tgmap.adam_update(gt, {k: T(v) for k, v in g.items()}, st,
                                   lt)
    for f in tgmap.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
        np.testing.assert_allclose(st.m[f].numpy(), np.asarray(sj.m[f]),
                                   rtol=1e-6, atol=1e-9, err_msg=f)
        np.testing.assert_allclose(st.v[f].numpy(), np.asarray(sj.v[f]),
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    assert int(st.step) == int(sj.step) == 3
    lr_j = jgmap.xyz_lr_schedule(1234, 8e-4, 8e-6, 0.01, 30000)
    lr_t = tgmap.xyz_lr_schedule(1234, 8e-4, 8e-6, 0.01, 30000)
    np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)


def test_extend_prune_overflow_match(rng):
    gj, sj, gt, st = _maps(rng, n=40, cap=48)
    sj = dataclasses.replace(sj, m={k: v + 1.0 for k, v in sj.m.items()})
    st = tgmap.AdamState(m={k: v + 1.0 for k, v in st.m.items()}, v=st.v,
                         step=st.step)
    kill = rng.uniform(size=48) < 0.3
    gj, sj = jgmap.prune(gj, sj, jnp.asarray(kill))
    gt, st = tgmap.prune(gt, st, T(kill))
    _assert_maps_equal(gj, gt, sj, st)
    # 48 candidates, some invalid, into the free slots: overflow
    bj, bt = _blocks(_block_arrays(rng, 48, rng.uniform(size=48) < 0.8))
    gj, sj, ovj = jgmap.extend(gj, sj, bj)
    gt, st, ovt = tgmap.extend(gt, st, bt)
    assert int(ovj) > 0 and int(ovt) == int(ovj)
    _assert_maps_equal(gj, gt, sj, st)


@pytest.mark.parametrize("op", ["reset_opacity", "reset_opacity_nonvisible",
                                "grow", "densification_stats"])
def test_map_surgery_matches(rng, op):
    gj, sj, gt, st = _maps(rng)
    if op == "reset_opacity":
        gj, sj = jgmap.reset_opacity(gj, sj, 0.01)
        gt, st = tgmap.reset_opacity(gt, st, 0.01)
    elif op == "reset_opacity_nonvisible":
        vis = rng.uniform(size=64) < 0.5
        gj, sj = jgmap.reset_opacity_nonvisible(gj, sj, jnp.asarray(vis))
        gt, st = tgmap.reset_opacity_nonvisible(gt, st, T(vis))
    elif op == "grow":
        gj, sj = jgmap.grow(gj, sj, 100)
        gt, st = tgmap.grow(gt, st, 100)
        assert gt.capacity == 100
    else:
        g = rng.normal(size=(64, 2)).astype(np.float32)
        r = rng.uniform(0, 50, 64).astype(np.float32)
        f = rng.uniform(size=64) < 0.6
        gj = jgmap.add_densification_stats(gj, jnp.asarray(g),
                                           jnp.asarray(f), 64, 48)
        gt = tgmap.add_densification_stats(gt, T(g), T(f), 64, 48)
        gj = jgmap.update_max_radii(gj, jnp.asarray(r), jnp.asarray(f))
        gt = tgmap.update_max_radii(gt, T(r), T(f))
    _assert_maps_equal(gj, gt, sj, st)


def test_densify_and_prune_matches(rng):
    """Clone, split (the reference's two normal draws handed to the port)
    and the opacity / screen-size / world-size prune, on a capacity that
    overflows."""
    gj, sj, gt, st = _maps(rng, n=40, cap=48)
    # half the Gaussians small enough to clone (below 0.01 x extent 3)
    small = np.where(np.arange(48)[:, None] % 2 == 0,
                     np.asarray(gj.scaling) - 3.0, np.asarray(gj.scaling))
    gj, gt = gj.replace(scaling=jnp.asarray(small)), gt.replace(
        scaling=T(small))
    key = jax.random.PRNGKey(7)
    gj2, sj2, ovj = jgmap.densify_and_prune(
        gj, sj, key, 2e-4, 0.3, 3.0, 20.0, 0.01)
    noise = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise.append(T(jax.random.normal(sub, (48, 3), jnp.float32)))
    counts = {}
    gt2, st2, ovt = tgmap.densify_and_prune(
        gt, st, None, 2e-4, 0.3, 3.0, 20.0, 0.01, noise=noise,
        counts=counts)
    assert int(ovt) == int(ovj) > 0
    assert int(counts["clone"]) > 0 and int(counts["split"]) > 0
    assert int(counts["prune"]) > 0
    _assert_maps_equal(gj2, gt2, sj2, st2)


def test_knn_exact_and_morton_match(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) < 0.9
    np.testing.assert_allclose(
        tknn.mean_sq_dist_3nn(T(pts), T(valid)).numpy(),
        np.asarray(jknn.mean_sq_dist_3nn(jnp.asarray(pts),
                                         jnp.asarray(valid))), rtol=1e-5)
    # above 16384 points the dispatch takes the Morton-window search
    n = 16384 + 600
    g = np.stack(np.meshgrid(np.linspace(0, 2, 131), np.linspace(0, 1, 130)),
                 -1).reshape(-1, 2)[:n]
    pts = np.concatenate([g, 0.05 * rng.normal(size=(len(g), 1))],
                         1).astype(np.float32)
    valid = rng.uniform(size=len(g)) < 0.95
    got = tknn.mean_sq_dist_3nn(T(pts), T(valid)).numpy()
    ref = np.asarray(jknn.mean_sq_dist_3nn(jnp.asarray(pts),
                                           jnp.asarray(valid)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(
        tknn._morton_codes(T(pts), T(valid)).numpy(),
        np.asarray(jknn._morton_codes(jnp.asarray(pts),
                                      jnp.asarray(valid))).astype(np.int64))


@pytest.mark.parametrize("adaptive", [True, False])
def test_seed_from_frame_matches(rng, adaptive):
    H, W = 16, 24
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0.0
    depth[0, 0] = 150.0            # beyond 100 m: invalid
    n_valid = int(((depth > 0) & (depth <= 100)).sum())
    if n_valid % 2:
        depth[np.argwhere(depth > 0)[1][0], np.argwhere(depth > 0)[1][1]] = 0
    assert int(((depth > 0) & (depth <= 100)).sum()) % 2 == 0
    image = rng.uniform(size=(3, H, W)).astype(np.float32)
    R = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0, -0.1, 0.05], [0.1, 0, -0.02], [-0.05, 0.02, 0]], jnp.float32)))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = R, [0.1, -0.2, 0.3]
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 20.0, 21.0, 11.5, 7.5, W,
                           H)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 20.0, 21.0, 11.5, 7.5, W, H,
                          device="cpu")
    bj = jseeding.seed_from_frame(
        jnp.asarray(image), jnp.asarray(depth), cam_j, jnp.asarray(w2c), 3,
        jax.random.PRNGKey(0), 1.0, 0.05, adaptive, 0)
    bt = tseeding.seed_from_frame(
        T(image), T(depth), cam_t, T(w2c), 3, torch.Generator().manual_seed(0),
        1.0, 0.05, adaptive, 0)
    np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
    np.testing.assert_array_equal(bt.kf_id.numpy(), np.asarray(bj.kf_id))
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        np.testing.assert_allclose(getattr(bt, f).numpy(),
                                   np.asarray(getattr(bj, f)), rtol=1e-6,
                                   atol=2e-5 if f == "scaling" else 1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("name", ["loss_mapping_rgb", "loss_mapping_rgbd",
                                  "isotropic_loss", "l1_loss", "psnr",
                                  "ssim"])
def test_mapping_losses_match(rng, name):
    H, W = 20, 28
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    gt[:, :3] = 0.0                 # below the rgb boundary threshold
    dep = rng.uniform(0, 3, (1, H, W)).astype(np.float32)
    gtd = rng.uniform(0, 3, (1, H, W)).astype(np.float32)
    gtd[:, 5:7] = 0.0
    args = {"loss_mapping_rgb": (img, gt, 0.01),
            "loss_mapping_rgbd": (img, dep, gt, gtd, 0.01, 0.95),
            "isotropic_loss": (rng.normal(size=(30, 3)).astype(np.float32),
                               rng.uniform(size=30) < 0.7),
            "l1_loss": (img, gt), "psnr": (img, gt), "ssim": (img, gt)}[name]
    conv = [(jnp.asarray(a), T(a)) if isinstance(a, np.ndarray) else (a, a)
            for a in args]
    want = float(getattr(jlosses, name)(*[c[0] for c in conv]))
    got = float(getattr(tlosses, name)(*[c[1] for c in conv]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kfstore_quantization_matches(rng):
    H, W = 12, 10
    img = rng.uniform(-0.1, 1.1, (3, H, W)).astype(np.float32)
    dep = rng.uniform(0, 5, (1, H, W)).astype(np.float32)
    R = np.eye(3, dtype=np.float32)[[1, 0, 2]]
    sj = jmapping.KFStore.empty(2, H, W).add(
        1, jnp.asarray(R), jnp.ones(3), 0.1, -0.2, jnp.asarray(img),
        jnp.asarray(dep), 7)
    st = tmapping.KFStore.empty(2, H, W, device="cpu").add(
        1, T(R), torch.ones(3), torch.tensor(0.1), torch.tensor(-0.2), T(img),
        T(dep), 7)
    for f in dataclasses.fields(jmapping.KFStore):
        a, b = np.asarray(getattr(sj, f.name)), getattr(st, f.name).numpy()
        np.testing.assert_allclose(b, a.astype(b.dtype), rtol=0, atol=1e-7,
                                   err_msg=f.name)
    np.testing.assert_allclose(st.image(1).numpy(), np.asarray(sj.image(1)),
                               atol=1e-7)
    np.testing.assert_allclose(st.depth(1).numpy(), np.asarray(sj.depth(1)),
                               atol=1e-7)
    # carried across, and grown
    st2 = tmapping.KFStore.from_jax_fields(
        {f.name: np.asarray(getattr(sj, f.name))
         for f in dataclasses.fields(jmapping.KFStore)}, device="cpu")
    assert torch.equal(st2.gt_depth, st.gt_depth)
    sg = st.grow(5)
    assert sg.capacity == 5 and not bool(sg.valid[2:].any())
    assert torch.equal(sg.gt_image[:2], st.gt_image)


def test_color_refinement_steps_match(rng):
    """Two refinement iterations (L1 + SSIM, tiled renderer) from the same
    map and store: the loss rtol 1e-5, the moments within 1e-3 of their
    max, parameters as in test_torch_mapping_steps.py."""
    W, H, n = 48, 32, 500
    arrays = dict(
        xyz=np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(0.5, 3.0, n)], -1).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32) * 0.2 - 2.5,
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32))
    gj = jgmap.from_numpy(**arrays, max_sh_degree=0, capacity=512)
    gt = tgmap.from_jax_fields(
        {f: np.asarray(getattr(gj, f)) for f in tgmap.ARRAY_FIELDS}, 0, 0,
        device="cpu")
    sj = jmapping.KFStore.empty(2, H, W)
    for i in range(2):
        sj = sj.add(i, jnp.eye(3), jnp.asarray([0.03 * i, 0.0, 0.0]), 0.0,
                    0.0, jnp.asarray(rng.uniform(size=(3, H, W)),
                                     jnp.float32),
                    jnp.ones((1, H, W)), i)
    st = tmapping.KFStore.from_jax_fields(
        {f.name: np.asarray(getattr(sj, f.name))
         for f in dataclasses.fields(jmapping.KFStore)}, device="cpu")
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 30.0, 30.0, (W - 1) / 2,
                           (H - 1) / 2, W, H)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, (W - 1) / 2,
                          (H - 1) / 2, W, H, device="cpu")
    op = dict(position_lr_init=1.6e-4, feature_lr=2.5e-3, opacity_lr=0.05,
              scaling_lr=1e-3, rotation_lr=1e-3)
    lj, lt = jgmap.default_lrs(op, 5.0), tgmap.default_lrs(op, 5.0,
                                                           device="cpu")
    gj2, aj, Lj = jmapping.color_refinement_steps(
        gj, jgmap.adam_init(gj), sj, jnp.asarray([1, 0], jnp.int32),
        jnp.asarray([8e-4, 7e-4], jnp.float32), cam_j, jnp.zeros(3), lj,
        pair_capacity=1 << 14, interpret=True)
    gt2, at, Lt = tmapping.color_refinement_steps(
        gt, tgmap.adam_init(gt), st, [1, 0], [8e-4, 7e-4], cam_t,
        torch.zeros(3), lt, pair_capacity=1 << 14)
    np.testing.assert_allclose(float(Lt), float(Lj), rtol=1e-5)
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        mj = np.asarray(aj.m[f])
        scale = np.abs(mj).max()
        np.testing.assert_allclose(at.m[f].numpy(), mj, rtol=0,
                                   atol=1e-3 * scale, err_msg=f)
        diff = np.abs(getattr(gt2, f).numpy() - np.asarray(getattr(gj2, f)))
        lr = float(lt[f]) if f != "xyz" else 8e-4
        signal = np.abs(mj) > 1e-2 * scale
        assert diff[signal].max() <= 2e-3 * lr + 1e-6, f
        assert diff.max() <= 4 * lr + 1e-6, f


def _backend_config():
    """A small RGB-D configuration: 4 map iterations per keyframe, the
    densify event at iteration 10 (offset 10 every 20)."""
    return {
        "seed": 0,
        "Dataset": dict(pcd_downsample=8, pcd_downsample_init=4,
                        adaptive_pointsize=True, point_size=0.05,
                        single_thread=True),
        "Training": dict(
            monocular=False, init_itr_num=4, init_gaussian_update=4,
            init_gaussian_reset=500, init_gaussian_th=0.005,
            init_gaussian_extent=30, mapping_itr_num=4,
            gaussian_update_every=20, gaussian_update_offset=10,
            gaussian_th=0.7, gaussian_extent=1.0, gaussian_reset=2001,
            size_threshold=20, window_size=3, pose_window=2,
            rgb_boundary_threshold=0.01, initial_capacity=1024,
            pair_capacity=1 << 14,
            lr=dict(cam_rot_delta=0.003, cam_trans_delta=0.001)),
        "opt_params": dict(
            position_lr_init=1.6e-4, position_lr_final=1.6e-6,
            position_lr_max_steps=30000, feature_lr=2.5e-3,
            opacity_lr=0.05, scaling_lr=1e-3, rotation_lr=1e-3,
            percent_dense=0.01, lambda_dssim=0.2, densify_from_iter=500,
            densify_grad_threshold=2e-4),
        "model_params": dict(sh_degree=0),
    }


def test_backend_runs_keyframes_through_densify(rng):
    """Port only: map initialization, three keyframes (the third crosses
    the densify event), the prune passes and a few color-refinement
    iterations, on a tiny RGB-D sequence of a random scene."""
    W, H = 40, 32
    cam = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, (W - 1) / 2,
                        (H - 1) / 2, W, H, device="cpu")
    be = BackEnd(_backend_config(), cam, device="cpu")
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for k in range(4):
        img = np.stack([0.5 + 0.4 * np.sin(xx / 5 + k * 0.1),
                        0.5 + 0.4 * np.cos(yy / 4), np.full_like(xx, 0.3)])
        dep = 2.0 + 0.3 * np.sin(xx / 7) + 0.01 * k
        t = np.array([0.01 * k, 0.0, 0.0], np.float32)
        frames.append((img.astype(np.float32), dep.astype(np.float32), t))
    img, dep, t = frames[0]
    be.add_next_kf(0, np.eye(3), t, 0.0, 0.0, img, dep, dep, init=True)
    be.initialize_map(0)
    n_init = int(be.gm.num_active())
    assert n_init > 0 and len(be.densify_log) == 1
    window = [0]
    for k in range(1, 4):
        img, dep, t = frames[k]
        be.add_next_kf(k, np.eye(3), t, 0.0, 0.0, img, dep, dep)
        window = ([k] + window)[:3]
        be.handle_keyframe(k, window)
    # 4 init + 3 x (4 mapping + 1 prune) iterations; densify at 10
    assert be.iteration_count == 19
    assert len(be.densify_log) == 2 and be.densify_log[1]["iteration"] == 10
    assert be.current_window == window
    assert set(be.occ_aware_visibility) == set(window)
    be.color_refinement(iteration_total=3, batch=2)
    act = be.gm.active
    for f in ("xyz", "scaling", "opacity", "features_dc", "rotation"):
        assert bool(torch.isfinite(getattr(be.gm, f)[act]).all()), f
    poses = be.keyframe_poses()
    assert [p[0] for p in poses] == window
    assert all(np.isfinite(p[1]).all() and np.isfinite(p[2]).all()
               for p in poses)
    # keyframe 0's pose is never optimized
    s0 = be.uid_to_slot[0]
    assert torch.equal(be.store.R[s0], torch.eye(3))
    assert torch.equal(be.store.t[s0], T(frames[0][2]))

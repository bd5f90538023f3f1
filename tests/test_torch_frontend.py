"""The port's tracking frontend (slam/frontend.py) against the JAX
package's ``FrontEnd(interpret=True)``, module by module, with the map and
frames carried across from the JAX side:

- ``_overlap_stats``, ``_warm_start`` (const_acc, const_vel, prev, and the
  large-motion guard), ``is_keyframe``, ``add_to_window``: equal;
- ``_fetch`` on the synthetic room (compact upload): image and depth
  bit-equal, the grad mask equal;
- the monocular keyframe depth prior (numpy noise from the same seed):
  bit-equal;
- one ``track`` call (the default pyramid schedule, which on a 96x64
  frame is one full-resolution level of 12 IRLS iterations and the
  keyframing render) and one ``polish`` on tests/test_torch_tracking.py's
  600-Gaussian scene: pose within 1e-4, iterations within 1, the
  adaptive state (level caps, easy streak, median depth) equal;
- ``track_frame_pyr`` with ``track_mask`` and ``level_subset``: pose
  within 1e-4 of JAX's, the keyframing render's n_touched equal on the
  masked-out Gaussians (zero) and within 0.5% in total.
"""

import copy
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
from gs_slam_analytica_jacobian_tpu.ops.lie import se3_exp as jse3_exp
from gs_slam_analytica_jacobian_tpu.slam import frontend as jfe
from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
from gs_slam_analytica_jacobian_tpu.slam import tracking as jtr
from gs_slam_analytica_jacobian_tpu.utils import datasets as jds
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.slam import frontend as tfe
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking as ttr
from gs_slam_analytica_jacobian_tpu_torch.utils import datasets as tds

from test_torch_bf16 import TAU0, track_scene_arrays
from test_torch_slam import smoke_config

torch.set_num_threads(1)

W, H, CAP = 96, 64, 1 << 13


def _config(monocular=False):
    cfg = smoke_config()
    cal = cfg["Dataset"]["Calibration"]
    cal.update(width=W, height=H, fx=60.0, fy=60.0, cx=(W - 1) / 2,
               cy=(H - 1) / 2)
    cfg["Dataset"].update(scene="room", n_frames=3)
    cfg["Training"].update(pair_capacity=CAP, tracking_itr_num=20,
                           pyr_iters=[5, 12, 12], monocular=monocular)
    return cfg


@pytest.fixture(scope="module")
def scene():
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W - 1) / 2,
                           (H - 1) / 2, W, H)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W - 1) / 2,
                          (H - 1) / 2, W, H, device="cpu")
    gm_j = jgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0)
    gm_t = tgmap.from_jax_fields(
        {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS},
        gm_j.max_sh_degree, gm_j.active_sh_degree, device="cpu")
    out = japi.render(gm_j, cam_j, None, jnp.zeros(3), pair_capacity=CAP,
                      interpret=True)
    gt_image = np.clip(np.asarray(out.color), 0, 1)
    gt_depth = np.asarray(out.depth)[0]
    mask = np.asarray(jlosses.compute_grad_mask(
        jnp.asarray(gt_image.mean(axis=0, keepdims=True)), 1.1, "replica"))
    T0 = np.asarray(jse3_exp(jnp.asarray(TAU0)))
    return dict(cam_j=cam_j, cam_t=cam_t, gm_j=gm_j, gm_t=gm_t,
                gt_image=gt_image, gt_depth=gt_depth, mask=mask, T0=T0)


def _frontends(sc, monocular=False, dataset=None):
    cfg = _config(monocular)
    fe_j = jfe.FrontEnd(cfg, dataset, sc["cam_j"],
                        SimpleNamespace(gm=sc["gm_j"]), interpret=True)
    fe_t = tfe.FrontEnd(copy.deepcopy(cfg), dataset, sc["cam_t"],
                        SimpleNamespace(gm=sc["gm_t"]), device="cpu")
    return fe_j, fe_t


def _pose(tau):
    T = np.asarray(jse3_exp(jnp.asarray(np.asarray(tau, np.float32))))
    return T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)


def _put_frames(fe, poses, mod):
    for uid, (R, t) in poses.items():
        fe.frames[uid] = mod.FrameRecord(uid=uid, R=R, t=t, R_gt=R, t_gt=t)


def test_overlap_stats_matches_jax():
    rng = np.random.default_rng(0)
    cur = rng.uniform(size=300) < 0.4
    occ = [rng.uniform(size=n) < 0.5 for n in (300, 250, 280)]
    got = tfe._overlap_stats(torch.as_tensor(cur),
                             [torch.as_tensor(o) for o in occ])
    ref = jfe._overlap_stats(jnp.asarray(cur), [jnp.asarray(o) for o in occ])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["const_acc", "const_vel", "prev"])
def test_warm_start_matches_jax(scene, mode):
    fe_j, fe_t = _frontends(scene)
    for fe in (fe_j, fe_t):
        fe.warm_mode = mode
    steps = {0: np.zeros(6), 1: [0.01, -0.004, 0.012, 0.002, 0.003, -0.001],
             2: [0.021, -0.009, 0.023, 0.0045, 0.0055, -0.0022],
             3: [0.032, -0.013, 0.035, 0.0066, 0.0081, -0.0035]}
    poses = {k: _pose(v) for k, v in steps.items()}
    _put_frames(fe_j, poses, jfe)
    _put_frames(fe_t, poses, tfe)
    for idx in (1, 2, 3, 4):
        (Rj, tj), (Rt, tt) = fe_j._warm_start(idx), fe_t._warm_start(idx)
        np.testing.assert_allclose(Rt, Rj, atol=1e-7)
        np.testing.assert_allclose(tt, tj, atol=1e-7)
    # the large-motion guard falls back to the previous pose
    big = {5: _pose([0.5, 0, 0, 0, 0, 0])}
    _put_frames(fe_j, big, jfe)
    _put_frames(fe_t, big, tfe)
    np.testing.assert_array_equal(fe_t._warm_start(6)[1],
                                  fe_j._warm_start(6)[1])


def test_is_keyframe_and_add_to_window_match_jax(scene):
    fe_j, fe_t = _frontends(scene)
    rng = np.random.default_rng(1)
    poses = {k: _pose(rng.normal(size=6) * 0.02) for k in range(8)}
    _put_frames(fe_j, poses, jfe)
    _put_frames(fe_t, poses, tfe)
    for fe in (fe_j, fe_t):
        fe.median_depth = 2.5
        fe.window_size = 4
    for cur, last, ratio in ((3, 0, 0.99), (3, 0, 0.5), (5, 4, 0.2),
                             (7, 1, 1.0)):
        assert fe_t.is_keyframe(cur, last, ratio) == \
            fe_j.is_keyframe(cur, last, ratio)
    window = [6, 4, 3, 2, 1]
    for initialized in (False, True):
        for ratios in (np.array([0.9, 0.8, 0.1, 0.7, 0.6]),
                       np.array([0.9, 0.9, 0.9, 0.9, 0.9])):
            fe_j.initialized = fe_t.initialized = initialized
            assert fe_t.add_to_window(7, ratios, list(window)) == \
                fe_j.add_to_window(7, ratios, list(window))


def test_fetch_matches_jax(scene):
    ds_cfg = _config()
    ds_t, ds_j = tds.load_dataset(ds_cfg), jds.load_dataset(ds_cfg)
    fe_j, _ = _frontends(scene, dataset=ds_j)
    _, fe_t = _frontends(scene, dataset=ds_t)
    got, ref = fe_t._fetch(1), fe_j._fetch(1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3], ref[3])
    assert float(got[2].sum()) > 0


def test_mono_keyframe_depth_prior_matches_jax(scene):
    fe_j, fe_t = _frontends(scene, monocular=True)
    img = scene["gt_image"]
    rng = np.random.default_rng(2)
    depth = (2.0 + rng.uniform(-0.5, 0.5, (1, H, W))).astype(np.float32)
    opac = rng.uniform(0.9, 1.0, (1, H, W)).astype(np.float32)
    fe_j.frames[3] = jfe.FrameRecord(uid=3, R=None, t=None, R_gt=None,
                                     t_gt=None, gt_image=jnp.asarray(img))
    fe_t.frames[3] = tfe.FrameRecord(uid=3, R=None, t=None, R_gt=None,
                                     t_gt=None, gt_image=torch.as_tensor(img))
    for kw_j, kw_t in (({}, {}),
                       (dict(depth=jnp.asarray(depth),
                             opacity=jnp.asarray(opac)),
                        dict(depth=torch.as_tensor(depth),
                             opacity=torch.as_tensor(opac)))):
        np.testing.assert_array_equal(fe_t.add_new_keyframe(3, **kw_t),
                                      fe_j.add_new_keyframe(3, **kw_j))


def test_track_and_polish_match_jax(scene):
    sc = scene
    fe_j, fe_t = _frontends(sc)
    R0, t0 = sc["T0"][:3, :3], sc["T0"][:3, 3]
    _put_frames(fe_j, {0: (R0, t0)}, jfe)
    _put_frames(fe_t, {0: (R0, t0)}, tfe)
    eye = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rec_j = jfe.FrameRecord(uid=1, R=R0, t=t0, R_gt=eye[0], t_gt=eye[1],
                            gt_image=jnp.asarray(sc["gt_image"]),
                            gt_depth=jnp.asarray(sc["gt_depth"]),
                            grad_mask=jnp.asarray(sc["mask"]))
    rec_t = tfe.FrameRecord(uid=1, R=R0, t=t0, R_gt=eye[0], t_gt=eye[1],
                            gt_image=torch.as_tensor(sc["gt_image"]),
                            gt_depth=torch.as_tensor(sc["gt_depth"]),
                            grad_mask=torch.as_tensor(sc["mask"]))
    fe_j.frames[1], fe_t.frames[1] = rec_j, rec_t
    out_j, it_j = fe_j.track(1, rec_j)
    out_t, it_t = fe_t.track(1, rec_t)
    np.testing.assert_allclose(rec_t.R, rec_j.R, atol=1e-4, rtol=0)
    np.testing.assert_allclose(rec_t.t, rec_j.t, atol=1e-4, rtol=0)
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    assert np.linalg.norm(rec_t.t) < 5e-3                 # it tracked
    assert fe_t._lvl_caps == fe_j._lvl_caps
    assert fe_t._easy_streak == fe_j._easy_streak
    assert abs(fe_t.median_depth - fe_j.median_depth) < 1e-3
    assert out_t.n_touched.shape == (len(track_scene_arrays()["xyz"]),)
    # the keyframe polish, from the same pose on both sides
    rec_t.R, rec_t.t = rec_j.R.copy(), rec_j.t.copy()
    rec_t.exposure_a, rec_t.exposure_b = rec_j.exposure_a, rec_j.exposure_b
    fe_j.polish(rec_j)
    fe_t.polish(rec_t)
    np.testing.assert_allclose(rec_t.R, rec_j.R, atol=1e-4, rtol=0)
    np.testing.assert_allclose(rec_t.t, rec_j.t, atol=1e-4, rtol=0)
    assert abs(rec_t.exposure_a - rec_j.exposure_a) < 1e-4


def test_track_mask_and_level_subset_match_jax(scene):
    sc = scene
    n = len(track_scene_arrays()["xyz"])
    keep = np.random.default_rng(4).uniform(size=n) < 0.85
    kw = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
              pair_capacity=CAP, levels=(1,), level_iters=(4,),
              level_exact=(0,), curv="flow", final_level=1,
              level_subset=(0.5,), nt_weight=True)
    R0, t0 = sc["T0"][:3, :3], sc["T0"][:3, 3]
    res_j = jtr.track_frame_pyr(
        sc["gm_j"], sc["cam_j"], jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(sc["gt_image"]), jnp.asarray(sc["gt_depth"])[None],
        jnp.asarray(sc["mask"]), jnp.zeros(3), interpret=True,
        track_mask=jnp.asarray(keep), **kw)
    res_t = ttr.track_frame_pyr(
        sc["gm_t"], sc["cam_t"], torch.as_tensor(R0), torch.as_tensor(t0),
        torch.as_tensor(sc["gt_image"]),
        torch.as_tensor(sc["gt_depth"])[None], torch.as_tensor(sc["mask"]),
        torch.zeros(3), track_mask=torch.as_tensor(keep), device="cpu",
        **kw)
    np.testing.assert_allclose(res_t[0].numpy(), np.asarray(res_j[0]),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(res_t[1].numpy(), np.asarray(res_j[1]),
                               atol=1e-4, rtol=0)
    assert abs(int(res_t[4]) - int(res_j[4])) <= 1
    nt_t, nt_j = res_t[5].n_touched.numpy(), np.asarray(res_j[5].n_touched)
    assert not nt_t[~keep].any() and not nt_j[~keep].any()
    assert abs(int(nt_t.sum()) - int(nt_j.sum())) <= 0.005 * nt_j.sum()
    assert int(nt_t.sum()) > 0

"""The port's evaluation and I/O (utils/eval.py, utils/ply.py,
utils/state_io.py, utils/checkpoints.py, gui/headless.py) against the JAX
package's: ATE and the Umeyama alignment within 1e-6, the LPIPS proxy
within 1e-5 relative on odd and even image sizes (XLA's SAME padding),
eval_rendering on given renders, ply and state files written by either
package loading in the other, checkpoint tensors equal, and the stdlib
PNG writer readable by PIL with the reference's pixel values."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.gui import headless as jheadless
from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.slam import mapping as jmapping
from gs_slam_analytica_jacobian_tpu.utils import checkpoints as jckpt
from gs_slam_analytica_jacobian_tpu.utils import eval as jeval
from gs_slam_analytica_jacobian_tpu.utils import ply as jply
from gs_slam_analytica_jacobian_tpu.utils import state_io as jstate
from gs_slam_analytica_jacobian_tpu_torch.gui import headless as theadless
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.utils import checkpoints as tckpt
from gs_slam_analytica_jacobian_tpu_torch.utils import eval as teval
from gs_slam_analytica_jacobian_tpu_torch.utils import ply as tply
from gs_slam_analytica_jacobian_tpu_torch.utils import state_io as tstate

torch.set_num_threads(1)


def _trajectories(rng, n):
    est, gt = [], []
    for i in range(n):
        T = np.eye(4)
        a = 0.3 * i
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = rng.normal(size=3)
        gt.append(T)
        E = T.copy()
        E[:3, 3] = 1.3 * T[:3, 3] + 0.05 * rng.normal(size=3) + 0.2
        est.append(E)
    return est, gt


@pytest.mark.parametrize("n,scale", [(8, False), (8, True), (2, False)])
def test_ate_rmse_matches_jax(n, scale):
    est, gt = _trajectories(np.random.default_rng(n), n)
    a = teval.ate_rmse(est, gt, align_scale=scale)
    b = jeval.ate_rmse(est, gt, align_scale=scale)
    assert np.isfinite(a) and abs(a - b) <= 1e-6
    x = np.random.default_rng(1).normal(size=(3, 10))
    y = 0.7 * x + 0.1
    for ra, rb in zip(teval.umeyama_alignment(x, y, True),
                      jeval.umeyama_alignment(x, y, True)):
        np.testing.assert_allclose(ra, rb, atol=1e-6)


def test_eval_ate_writes_the_same_files(tmp_path):
    est, gt = _trajectories(np.random.default_rng(3), 5)
    frames = {}
    for i, (E, G) in enumerate(zip(est, gt)):
        We, Wg = np.linalg.inv(E), np.linalg.inv(G)
        frames[i] = SimpleNamespace(R=We[:3, :3], t=We[:3, 3],
                                    R_gt=Wg[:3, :3], t_gt=Wg[:3, 3])
    a = teval.eval_ate(frames, list(range(5)), str(tmp_path / "t"),
                       final=True)
    b = jeval.eval_ate(frames, list(range(5)), str(tmp_path / "j"),
                       final=True)
    assert abs(a - b) <= 1e-6
    for rel in ("ate_final.json", "plot/trj_final.json"):
        assert (tmp_path / "t" / rel).read_text() == \
            (tmp_path / "j" / rel).read_text()


@pytest.mark.parametrize("h,w", [(32, 48), (33, 47)])
def test_lpips_proxy_matches_jax(h, w):
    rng = np.random.default_rng(h)
    a = rng.uniform(size=(3, h, w)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    got = teval.lpips_proxy(torch.as_tensor(a), torch.as_tensor(b))
    ref = jeval.lpips_proxy(jnp.asarray(a), jnp.asarray(b))
    assert got > 0
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    assert teval.lpips_proxy(torch.as_tensor(a), torch.as_tensor(a)) == 0.0


def test_eval_rendering_matches_jax(tmp_path):
    """eval_rendering on given renders: the same frames scored, PSNR and
    SSIM within 1e-5 relative, the LPIPS proxy within 1e-5."""
    rng = np.random.default_rng(7)
    imgs = [rng.uniform(size=(3, 40, 56)).astype(np.float32)
            for _ in range(12)]
    renders = [np.clip(x + 0.05 * rng.normal(size=x.shape), -0.1, 1.1
                       ).astype(np.float32) for x in imgs]
    dataset = [(x, None, np.eye(4)) for x in imgs]
    frames = {i: SimpleNamespace(uid=i) for i in range(12)}
    kf = [0, 1, 5]
    a = teval.eval_rendering(
        frames, kf, dataset,
        lambda rec: SimpleNamespace(color=torch.as_tensor(renders[rec.uid])),
        str(tmp_path / "t"), iteration="before")
    b = jeval.eval_rendering(
        frames, kf, dataset,
        lambda rec: SimpleNamespace(color=jnp.asarray(renders[rec.uid])),
        str(tmp_path / "j"), iteration="before")
    assert a["n_frames"] == b["n_frames"] == 1     # frame 10 (0, 5 are KFs)
    for k in ("mean_psnr", "mean_ssim", "mean_lpips_proxy"):
        assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])
    assert os.path.isfile(tmp_path / "t" / "psnr" / "before" /
                          "final_result.json")


def _jax_map(n=50, capacity=64, sh=1, seed=0):
    rng = np.random.default_rng(seed)
    k = (sh + 1) ** 2 - 1
    return jgmap.from_numpy(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, k, 3)).astype(np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        max_sh_degree=sh, capacity=capacity)


def _port_map(gm_j):
    return tgmap.from_jax_fields(
        {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS},
        gm_j.max_sh_degree, gm_j.active_sh_degree, device="cpu")


PLY_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "active")


def test_ply_round_trips_across_packages(tmp_path):
    gm_j = _jax_map()
    gm_t = _port_map(gm_j)
    tply.save_ply(gm_t, str(tmp_path / "t.ply"))
    jply.save_ply(gm_j, str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    from_port = jply.load_ply(str(tmp_path / "t.ply"))
    from_jax = tply.load_ply(str(tmp_path / "j.ply"), device="cpu")
    again = tply.load_ply(str(tmp_path / "t.ply"), device="cpu")
    for f in PLY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(from_port, f)),
                                      getattr(from_jax, f).numpy())
        np.testing.assert_array_equal(getattr(again, f).numpy(),
                                      getattr(from_jax, f).numpy())
    assert from_jax.max_sh_degree == 1 and from_jax.capacity == 50


def _jax_state(rng, gm_j):
    adam = jgmap.adam_init(gm_j)
    adam = jgmap.AdamState(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in adam.m.items()},
        v={k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
           for k, v in adam.v.items()},
        step=jnp.asarray(7, jnp.int32))
    M, H, W = 3, 6, 8
    store = jmapping.KFStore(
        R=jnp.asarray(rng.normal(size=(M, 3, 3)).astype(np.float32)),
        t=jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32)),
        exposure_a=jnp.asarray(rng.normal(size=M).astype(np.float32)),
        exposure_b=jnp.asarray(rng.normal(size=M).astype(np.float32)),
        gt_image=jnp.asarray(rng.integers(0, 256, (M, 3, H, W),
                                          dtype=np.uint8)),
        gt_depth=jnp.asarray(rng.integers(0, 65536, (M, 1, H, W),
                                          dtype=np.uint16)),
        depth_scale=jnp.asarray(rng.uniform(size=M).astype(np.float32)),
        valid=jnp.asarray([True, True, False]),
        uid=jnp.asarray([0, 4, -1], jnp.int32))
    pose = jmapping.PoseAdamState(
        m=jnp.asarray(rng.normal(size=(5, 8)).astype(np.float32)),
        v=jnp.asarray(rng.uniform(size=(5, 8)).astype(np.float32)),
        step=jnp.asarray(3, jnp.int32))
    return adam, store, pose


def _assert_state_equal(t_state, j_state):
    gm_t, adam_t, store_t, pose_t, meta_t = t_state
    gm_j, adam_j, store_j, pose_j, meta_j = j_state
    for f in tgmap.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(gm_t, f).numpy(),
                                      np.asarray(getattr(gm_j, f)), err_msg=f)
    assert (gm_t.max_sh_degree, gm_t.active_sh_degree) == \
        (gm_j.max_sh_degree, gm_j.active_sh_degree)
    for k in adam_j.m:
        np.testing.assert_array_equal(adam_t.m[k].numpy(),
                                      np.asarray(adam_j.m[k]))
        np.testing.assert_array_equal(adam_t.v[k].numpy(),
                                      np.asarray(adam_j.v[k]))
    assert int(adam_t.step) == int(adam_j.step)
    for f in ("R", "t", "exposure_a", "exposure_b", "gt_image", "gt_depth",
              "depth_scale", "valid", "uid"):
        np.testing.assert_array_equal(
            getattr(store_t, f).numpy().astype(np.int64 if f == "gt_depth"
                                               else None),
            np.asarray(getattr(store_j, f)).astype(
                np.int64 if f == "gt_depth" else None), err_msg=f)
    assert store_t.gt_depth.dtype == torch.int32
    np.testing.assert_array_equal(pose_t.m.numpy(), np.asarray(pose_j.m))
    assert int(pose_t.step) == int(pose_j.step)
    assert meta_t == meta_j


def test_state_io_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(11)
    gm_j = _jax_map(seed=1)
    adam_j, store_j, pose_j = _jax_state(rng, gm_j)
    meta = {"current_window": [4, 0]}
    jstate.save_state(str(tmp_path / "j.npz"), gm_j, adam_j, store_j,
                      pose_j, meta)
    t_state = tstate.load_state(str(tmp_path / "j.npz"), device="cpu")
    j_state = jstate.load_state(str(tmp_path / "j.npz"))
    _assert_state_equal(t_state, j_state)
    # and back: the port writes, JAX and the port read the same state
    tstate.save_state(str(tmp_path / "t.npz"), *t_state[:4], meta)
    with np.load(tmp_path / "t.npz") as z, np.load(tmp_path / "j.npz") as y:
        assert sorted(z.files) == sorted(y.files)
        for k in z.files:
            assert z[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(z[k], y[k], err_msg=k)
    _assert_state_equal(tstate.load_state(str(tmp_path / "t.npz"), "cpu"),
                        jstate.load_state(str(tmp_path / "t.npz")))


def test_checkpoint_tensors_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    n = 20
    tensors = dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, 3, 3)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))
    np.savez(tmp_path / "m.npz", **tensors)
    a = tckpt.load_npz_tensors(str(tmp_path / "m.npz"))
    b = jckpt.load_npz_tensors(str(tmp_path / "m.npz"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    gm_t = tckpt.load_tensors(str(tmp_path / "m.npz"), device="cpu")
    gm_j = jckpt.load_tensors(str(tmp_path / "m.npz"))
    for f in PLY_FIELDS:
        np.testing.assert_array_equal(getattr(gm_t, f).numpy(),
                                      np.asarray(getattr(gm_j, f)))
    assert gm_t.max_sh_degree == gm_j.max_sh_degree == 1
    # a plain .pt (weights only): the six tensors in order
    torch.save([torch.as_tensor(tensors[k]) for k in (
        "xyz", "features_dc", "features_rest", "opacity", "scaling",
        "rotation")], tmp_path / "m.pt")
    c = tckpt.load_pt_tensors(str(tmp_path / "m.pt"))
    for k in a:
        np.testing.assert_array_equal(c[k], a[k])


def test_save_png_readable_by_pil(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(9)
    for arr in (rng.uniform(-0.2, 1.2, (13, 17, 3)),
                rng.uniform(size=(9, 6))):
        theadless.save_png(arr, str(tmp_path / "t.png"))
        jheadless.save_png(arr, str(tmp_path / "j.png"))
        got = np.asarray(Image.open(tmp_path / "t.png"))
        ref = np.asarray(Image.open(tmp_path / "j.png"))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_headless_snapshot_and_orbit(tmp_path):
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    gm = _port_map(_jax_map(n=200, capacity=256, sh=0, seed=2))
    gm = gm.replace(xyz=gm.xyz * 0.3 + torch.tensor([0.0, 0.0, 3.0]),
                    scaling=gm.scaling * 0.2 - 2.5)
    cam = Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, 31.5, 23.5, 64,
                        48, device="cpu")
    v = theadless.HeadlessViewer(str(tmp_path), cam, pair_capacity=1 << 14)
    prefix = v.snapshot(gm, np.eye(3), np.zeros(3), tag="x")
    for kind in ("color", "depth", "normal"):
        assert os.path.getsize(f"{prefix}_{kind}.png") > 0
    v.orbit(gm, n_views=2)
    assert os.path.isfile(tmp_path / "orbit_01_color.png")

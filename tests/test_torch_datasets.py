"""The port's dataset ingestion and config loader (utils/datasets.py,
utils/config.py, the frontend's frame dequantization) against the JAX
package's, on the mock trees of tests/test_datasets_parsers.py: parsed
paths and poses, loaded frames, compact raw frames and synthetic frames
(plane, room, stereo room) bit-equal; every committed YAML config loads
to the same dict."""

import glob
import os

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.utils import config as jconfig
from gs_slam_analytica_jacobian_tpu.utils import datasets as jds
from gs_slam_analytica_jacobian_tpu_torch.slam import frontend as tfe
from gs_slam_analytica_jacobian_tpu_torch.utils import config as tconfig
from gs_slam_analytica_jacobian_tpu_torch.utils import datasets as tds

from test_datasets_parsers import (_euroc_config, _rot_z,  # noqa: F401
                                   _write_png, euroc_tree, tum_tree)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tum_config(root):
    return {"Dataset": {
        "type": "tum", "dataset_path": str(root),
        "Calibration": dict(fx=30.0, fy=30.0, cx=15.5, cy=11.5,
                            width=32, height=24, depth_scale=5000.0,
                            distorted=False)}}


def _assert_frames_equal(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_tum_parser_matches_jax(tum_tree):
    root, poses_c2w = tum_tree
    p, q = tds.TUMParser(str(root)), jds.TUMParser(str(root))
    assert p.n_img == q.n_img == 3
    assert p.color_paths == q.color_paths
    assert p.depth_paths == q.depth_paths
    for i in range(3):
        np.testing.assert_array_equal(p.poses[i], q.poses[i])
        np.testing.assert_allclose(p.poses[i], np.linalg.inv(poses_c2w[i]),
                                   atol=1e-9)


def test_tum_dataset_frames_match_jax(tum_tree):
    root, _ = tum_tree
    ds, dj = tds.load_dataset(_tum_config(root)), jds.load_dataset(
        _tum_config(root))
    assert len(ds) == len(dj) == 3
    for i in range(3):
        _assert_frames_equal(ds[i], dj[i])
        _assert_frames_equal(ds.raw_frame(i), dj.raw_frame(i))
    np.testing.assert_allclose(ds[1][1], 2.0)


def test_tum_association_rejects_far_pose(tmp_path):
    root = tmp_path / "tum2"
    root.mkdir()
    img = np.zeros((8, 8, 3), np.uint8)
    for i in range(2):
        _write_png(str(root / "rgb" / f"{i}.png"), img)
        _write_png(str(root / "depth" / f"{i}.png"),
                   np.full((8, 8), 100, np.uint16))
    (root / "rgb.txt").write_text("10.0 rgb/0.png\n12.0 rgb/1.png\n")
    (root / "depth.txt").write_text("10.0 depth/0.png\n12.0 depth/1.png\n")
    (root / "groundtruth.txt").write_text(
        "# hdr\n10.0 0 0 0 0 0 0 1\n12.5 0 0 0 0 0 0 1\n")
    p = tds.TUMParser(str(root))
    assert p.n_img == 1
    assert os.path.basename(p.color_paths[0]) == "0.png"


def test_replica_parser_and_dataset_match_jax(tmp_path):
    from PIL import Image
    root = tmp_path / "replica"
    (root / "results").mkdir(parents=True)
    rng = np.random.default_rng(1)
    lines = []
    for i in range(3):
        img = rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "results" / f"frame{i:06d}.jpg")
        _write_png(str(root / "results" / f"depth{i:06d}.png"),
                   np.full((16, 20), 1000 * (i + 1), np.uint16))
        T = np.eye(4)
        T[:3, :3] = _rot_z(0.1 * i)
        T[:3, 3] = [i * 0.1, 0, 0]
        lines.append(" ".join(str(v) for v in T.reshape(-1)))
    (root / "traj.txt").write_text("\n".join(lines) + "\n")
    p, q = tds.ReplicaParser(str(root)), jds.ReplicaParser(str(root))
    assert p.n_img == q.n_img == 3
    for i in range(3):
        np.testing.assert_array_equal(p.poses[i], q.poses[i])
    cfg = {"Dataset": {"type": "replica", "dataset_path": str(root),
                       "Calibration": dict(fx=20.0, fy=20.0, cx=9.5,
                                           cy=7.5, width=20, height=16,
                                           depth_scale=1000.0)}}
    ds, dj = tds.load_dataset(cfg), jds.load_dataset(cfg)
    for i in range(3):
        _assert_frames_equal(ds[i], dj[i])
        _assert_frames_equal(ds.raw_frame(i), dj.raw_frame(i))


@pytest.mark.parametrize("k1", [0.0, -0.3])
def test_undistortion_matches_jax(tmp_path, k1):
    H, W = 48, 64
    img = np.random.default_rng(2).integers(0, 255, (H, W, 3),
                                            dtype=np.uint8)
    _write_png(str(tmp_path / "f.png"), img)
    calib = dict(fx=60.0, fy=60.0, cx=(W - 1) / 2, cy=(H - 1) / 2,
                 width=W, height=H, distorted=True, k1=k1, k2=0.0, p1=0.0,
                 p2=0.0, k3=0.0)
    out = []
    for mod in (tds, jds):
        ds = mod.MonocularDataset({"Dataset": {"Calibration": calib}})
        ds.color_paths = [str(tmp_path / "f.png")]
        ds.poses = [np.eye(4)]
        ds.num_imgs = 1
        out.append(ds[0])
    _assert_frames_equal(out[0], out[1])
    assert out[0][1] is None


def test_euroc_parser_and_stereo_match_jax(euroc_tree):
    root, body_poses, (W, H, DISP) = euroc_tree
    p, q = tds.EuRoCParser(str(root)), jds.EuRoCParser(str(root))
    assert p.n_img == q.n_img == 2
    for i in range(2):
        np.testing.assert_array_equal(p.poses[i], q.poses[i])
    ds = tds.load_dataset(_euroc_config(root, W, H))
    dj = jds.load_dataset(_euroc_config(root, W, H))
    _assert_frames_equal(ds[0], dj[0])
    valid = ds[0][1] > 0
    np.testing.assert_allclose(np.median(ds[0][1][valid]),
                               47.90639384423901 / DISP, rtol=0.15)


def test_raw_frame_dequantization_matches_jax(tum_tree):
    """The frontend's on-device dequantization (u16 depth through int16 /
    int32) against the JAX frontend's, bit for bit."""
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.slam.frontend import (
        _dequant_depth, _dequant_rgb)

    root, _ = tum_tree
    ds = tds.load_dataset(_tum_config(root))
    rgb_u8, depth_u16, scale, _ = ds.raw_frame(0)
    depth_u16 = depth_u16.copy()
    depth_u16[0, :4] = [0, 1, 40000, 65535]     # codes above int16's range
    got_i = tfe._dequant_rgb(rgb_u8, "cpu").numpy()
    got_d = tfe._dequant_depth(depth_u16, scale, "cpu").numpy()
    ref_i = np.asarray(_dequant_rgb(jnp.asarray(rgb_u8)))
    ref_d = np.asarray(_dequant_depth(jnp.asarray(depth_u16),
                                      jnp.float32(1.0 / scale)))
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)
    assert got_d[0, 3] == np.float32(65535) * np.float32(1.0 / scale)


def _synthetic_config(scene, sensor="depth", n=3):
    return {"Dataset": dict(
        type="synthetic", n_frames=n, seed=0, scene=scene,
        motion_scale=0.5, sensor_type=sensor,
        Calibration=dict(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64,
                         height=48, depth_scale=1.0, distorted=False))}


@pytest.mark.parametrize("scene", ["plane", "room"])
def test_synthetic_frames_bit_equal(scene):
    ds = tds.load_dataset(_synthetic_config(scene))
    dj = jds.load_dataset(_synthetic_config(scene))
    assert type(ds).__name__ == type(dj).__name__ == "SyntheticDataset"
    assert len(ds) == len(dj) == 3
    for i in range(3):
        _assert_frames_equal(ds[i], dj[i])
        _assert_frames_equal(ds.raw_frame(i), dj.raw_frame(i))
    assert (ds.fx, ds.fy, ds.fovx, ds.fovy) == (dj.fx, dj.fy, dj.fovx,
                                                  dj.fovy)


def test_synthetic_stereo_frames_bit_equal():
    pytest.importorskip("cv2")
    ds = tds.load_dataset(_synthetic_config("room", "stereo", n=2))
    dj = jds.load_dataset(_synthetic_config("room", "stereo", n=2))
    assert type(ds).__name__ == "SyntheticStereoDataset"
    for i in range(2):
        _assert_frames_equal(ds[i], dj[i])
        _assert_frames_equal(ds.raw_frame(i), dj.raw_frame(i))


def test_realsense_with_injected_pipeline_matches_jax():
    rng = np.random.default_rng(5)
    frames = [(rng.integers(0, 255, (12, 16, 3), dtype=np.uint8),
               rng.uniform(-0.5, 3.0, (12, 16)).astype(np.float32))
              for _ in range(2)]

    def factory():
        class Pipe:
            k = 0

            def get_frames(self, has_depth):
                img, dep = frames[Pipe.k % 2]
                Pipe.k += 1
                return img, (dep.copy() if has_depth else None)
        return Pipe(), dict(fx=20.0, fy=21.0, cx=7.5, cy=5.5, width=16,
                            height=12, depth_scale=0.5)

    cfg = {"Dataset": {"type": "realsense", "sensor_type": "depth",
                       "n_frames": 2}}
    ds = tds.RealsenseDataset(cfg, pipeline_factory=factory)
    got = [ds[0], ds[1]]
    dj = jds.RealsenseDataset(cfg, pipeline_factory=factory)
    ref = [dj[0], dj[1]]
    for a, b in zip(got, ref):
        _assert_frames_equal(a, b)
    assert not ds.prefetchable and len(ds) == 2


CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_load_config_matches_jax(path):
    assert tconfig.load_config(path) == jconfig.load_config(path)


def test_load_config_names_pyyaml_when_missing(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        tconfig.load_config(CONFIGS[0])

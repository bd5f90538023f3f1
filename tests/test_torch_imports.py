"""Import hygiene of the PyTorch port: it (and chip_smoke.py) imports
neither jax nor anything of the JAX package, and its entry points default
to CUDA and raise without a GPU instead of falling back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gs_slam_analytica_jacobian_tpu_torch"
JAX_PKG = "gs_slam_analytica_jacobian_tpu"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


# the modules of the mapping slice, each of which must be among those
# imported below
MAPPING_MODULES = ("utils.logging", "ops.knn", "ops.tile_kernel16",
                   "slam.seeding", "slam.mapping", "slam.backend")
# the modules of the live-system slice, likewise
SYSTEM_MODULES = ("utils.config", "utils.datasets", "utils.eval",
                  "utils.ply", "utils.checkpoints", "utils.state_io",
                  "gui.headless", "slam.frontend", "parallel.pipeline",
                  "slam.driver", "slam_main")
# the modules of the mxu slice (the browser viewer, the B5 harness)
MXU_SLICE_MODULES = ("gui.web", "scripts.abl16")
# the last modules of the JAX package: the bench and entry points, the
# keyframe data-parallel and depth-slab meshes
LAST_SLICE_MODULES = ("bench", "graft_entry", "parallel.sharding",
                      "parallel.slab", "ops.launches")


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in (MAPPING_MODULES + SYSTEM_MODULES + MXU_SLICE_MODULES
              + LAST_SLICE_MODULES):
        assert f"{PORT.name}.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or "
        f"m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", JAX_PKG), (path, name)


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    from gs_slam_analytica_jacobian_tpu_torch import jacobian_test
    from gs_slam_analytica_jacobian_tpu_torch.device import resolve_device
    from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_ref
    from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
    from gs_slam_analytica_jacobian_tpu_torch.slam import render_api
    from gs_slam_analytica_jacobian_tpu_torch.slam import tracking

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 8
    gm = gaussian_map.from_numpy(
        xyz=np.ones((n, 3), np.float32), features_dc=np.zeros((n, 1, 3)),
        features_rest=np.zeros((n, 0, 3)), scaling=np.zeros((n, 3)),
        rotation=np.tile([1.0, 0, 0, 0], (n, 1)), opacity=np.zeros((n, 1)),
        max_sh_degree=0, device="cpu")
    cam = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, 31.5, 15.5, 64,
                        32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_api.render(gm, cam)                     # device=None
    with pytest.raises(RuntimeError, match="CUDA"):
        render_api.make_render_plan(gm, cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, 31.5, 15.5, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        gaussian_map.GaussianMap.empty(4)
    z = torch.zeros(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        renderer_tiled.render(gm.xyz, gm.get_cov6(), gm.get_opacity(),
                              gm.get_features(), 0, cam.w2c(),
                              cam.projection(), torch.zeros(6), 30.0, 30.0,
                              64, 32, 1.0, 0.5, torch.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.track_frame_pyr(
            gm, cam, cam.R, cam.t, torch.zeros(3, 32, 64), z, z, z, 0.0,
            0.0, 0.01, levels=(1,), level_iters=(1,), level_exact=(0,),
            curv="flow")
    frame = (gm, cam, cam.R, cam.t, torch.zeros(3, 32, 64), z, z, z)
    for tracker in (tracking.track_frame_gn, tracking.track_frame):
        with pytest.raises(RuntimeError, match="CUDA"):
            tracker(*frame, 0.0, 0.0, 0.01, max_iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.polish_frame(*frame[:4], z[0], z[0], *frame[4:], 0.01)
    with pytest.raises(RuntimeError, match="CUDA"):
        renderer_ref.render(gm.xyz, gm.get_cov6(), gm.get_opacity(),
                            gm.get_features(), 0, cam.w2c(),
                            cam.projection(), torch.zeros(6), 30.0, 30.0,
                            64, 32, 1.0, 0.5, torch.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        jacobian_test.run(jacobian_test.load_fixture(), verbose=False)
    # explicitly on the CPU it renders (plain kernel version)
    out = render_api.render(gm, cam, device="cpu")
    assert out.color.shape == (3, 32, 64)
    # tensors on another device than the one asked for are refused
    with pytest.raises(ValueError):
        render_api.render(gm, cam, device="meta")


def test_mapping_entry_points_default_to_cuda(monkeypatch):
    """The mapping slice's entry points take ``device=None`` as CUDA and
    raise without a GPU. Without an initialized process group of the
    right size the mesh raises a clear error (make_mesh, BackEnd with
    mesh_devices 2, mapping_steps(mesh=)): nothing falls back to one
    rank."""
    import torch.distributed as dist
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.parallel import sharding
    from gs_slam_analytica_jacobian_tpu_torch.slam import mapping
    from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd

    assert not (dist.is_available() and dist.is_initialized())
    cam = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, 31.5, 15.5, 64,
                        32, device="cpu")
    cfg = {"Dataset": {}, "opt_params": {}, "model_params": {},
           "Training": {"mesh_devices": 2}}
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        sharding.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        BackEnd(cfg, cam, device="cpu")
    args = (None, None, None, [[0]], [True], [False], [False], None, cam,
            None, {}, [1e-3], 0.0, 0.0, 0.01, 1)
    with pytest.raises(TypeError, match="Mesh"):
        mapping.mapping_steps(*args, mesh=object())
    mesh = sharding.Mesh(group=None, rank=0, size=2,
                         device=torch.device("cpu"), backend="gloo")
    with pytest.raises(RuntimeError, match="not initialized"):
        mapping.mapping_steps(*args, mesh=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mapping.KFStore.empty(2, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        mapping.PoseAdamState.zero(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        BackEnd({"Training": {}}, cam)


def test_system_modules_import_without_optional_packages():
    """The card machine has no pyyaml, PIL, cv2 or matplotlib: the live
    system's modules import without them (each is imported only where a
    YAML file, an image file, stereo or a plot needs it)."""
    blocked = ("yaml", "PIL", "cv2", "matplotlib")
    mods = [f"{PORT.name}.{m}" for m in SYSTEM_MODULES + MXU_SLICE_MODULES]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for b in {blocked!r}:\n"
        "    sys.modules[b] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"from {PORT.name}.utils import datasets\n"
        "ds = datasets.load_dataset({'Dataset': dict(type='synthetic', "
        "n_frames=2, scene='room', Calibration=dict(fx=20.0, fy=20.0, "
        "cx=7.5, cy=5.5, width=16, height=12, depth_scale=1.0))})\n"
        "assert ds[1][0].shape == (3, 12, 16)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_last_slice_entry_points_default_to_cuda(monkeypatch):
    """The bench, entry(), the dry run and the rank spawner take
    ``device=None`` as CUDA and raise without a GPU (before any rank is
    spawned); the slab functions need an initialized mesh."""
    from gs_slam_analytica_jacobian_tpu_torch import bench, graft_entry
    from gs_slam_analytica_jacobian_tpu_torch.parallel import sharding, slab

    mesh = sharding.Mesh(group=None, rank=0, size=2,
                         device=torch.device("cpu"), backend="gloo")
    with pytest.raises(RuntimeError, match="not initialized"):
        slab.slab_render(mesh, None, None, None)
    with pytest.raises(RuntimeError, match="not initialized"):
        slab.slab_mapping_loss_and_grads(mesh, None, None, None, None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run_bench(64, 64, 32, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry(n=8, width=64, height=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.run_ranks(print, 2)

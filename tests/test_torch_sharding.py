"""Keyframe data parallelism of the port (parallel/sharding.py,
``mapping_steps(mesh=)``, ``BackEnd`` with ``mesh_devices``) on 4 gloo
ranks on the CPU, spawned once for the whole file, against the port's
one-rank runs and the JAX package's 8-device CPU mesh, on the inputs of
tests/test_multichip.py (``build_problem``).

Tolerances are the JAX mesh tests': the loss rtol 3e-4, parameters
atol 2.5 lr (one Adam step moves a parameter by at most ~lr; where a
gradient is ~0, sum-order noise can flip its sign), ``store.t`` atol
2.5e-3, n_touched equal for more than 85% of the entries. Against the
port's one-rank run the densification statistics of the first
iteration are equal (each frame's rows are computed by one rank and
summed in the one-rank order), and every rank ends with the same state
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.parallel import sharding
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping as tmapping

# one intra-op thread (the spawned ranks set their own)
torch.set_num_threads(1)

N_RANKS = 4
LRS = {"xyz": 1e-3, "features_dc": 2e-3, "features_rest": 1e-4,
       "opacity": 5e-2, "scaling": 1e-3, "rotation": 1e-3}
CHECKED_LRS = {"xyz": 1e-3, "scaling": 1e-3, "opacity": 5e-2,
               "features_dc": 2e-3}
# problem -> (build_problem keywords, tiled)
PROBLEMS = {"oracle": (dict(), False),
            "tiled": (dict(W=64, H=32, n=96, C=128), True)}
STATE = ("xyz", "features_dc", "scaling", "rotation", "opacity",
         "xyz_grad_accum", "denom", "max_radii2d")


def _camera(W, H):
    return Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, (W - 1) / 2,
                         (H - 1) / 2, W, H, device="cpu")


def _port_problem(p):
    gm = tgmap.from_jax_fields(p["gm"], 0, 0, device="cpu")
    store = tmapping.KFStore.from_jax_fields(p["store"], device="cpu")
    return gm, tgmap.adam_init(gm), store, _camera(p["W"], p["H"])


def run_steps(p, mesh, F=8, T=1):
    """tests/test_multichip.py's ``run_steps`` on the port."""
    gm, adam, store, cam = _port_problem(p)
    valid = np.ones(F, bool)
    valid[-1] = False                     # one dummy slot
    opt_pose = np.zeros(F, bool)
    opt_pose[1:3] = True
    opt_exp = np.zeros(F, bool)
    opt_exp[1] = True
    return tmapping.mapping_steps(
        gm, adam, store, np.tile(np.arange(F, dtype=np.int32)[None], (T, 1)),
        valid, opt_pose, opt_exp, tmapping.PoseAdamState.zero(F, device="cpu"),
        cam, torch.zeros(3), LRS, [1e-3] * T, 1e-3, 1e-3, 0.01, n_window=4,
        alpha=0.95, monocular=False, pair_capacity=1 << 12,
        use_oracle=not p["tiled"], mesh=mesh)


def _record(out):
    rec = {f: getattr(out.gm, f).numpy() for f in STATE}
    rec.update(loss=float(out.loss), store_t=out.store.t.numpy(),
               store_R=out.store.R.numpy(),
               exposure_a=out.store.exposure_a.numpy(),
               n_touched=out.n_touched.numpy(), radii=out.radii.numpy(),
               pose_m=out.pose_adam.m.numpy(), pose_v=out.pose_adam.v.numpy())
    return rec


def step_inputs(p, F=8):
    """sharded_mapping_step's frames: the store's first F keyframes."""
    _, _, store, _ = _port_problem(p)
    valid = [True] * (F - 1) + [False]
    return (store.R[:F], store.t[:F],
            torch.stack([store.image(i) for i in range(F)]),
            torch.stack([store.depth(i) for i in range(F)]), valid)


def one_rank_step(p):
    """The sharded step's definition on one rank: the summed loss of the
    valid frames, its gradient, one Adam step."""
    gm, adam, _, cam = _port_problem(p)
    R, t, imgs, deps, valid = step_inputs(p)
    from gs_slam_analytica_jacobian_tpu_torch.ops import losses
    from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render
    params = {f: getattr(gm, f).detach().requires_grad_()
              for f in tgmap.PARAM_FIELDS}
    total = 0.0
    for j, v in enumerate(valid):
        if v:
            out = render(gm.replace(**params), cam.replace(R=R[j], t=t[j]),
                         None, torch.zeros(3), use_oracle=True,
                         pair_capacity=1 << 12, device="cpu")
            total = total + losses.loss_mapping_rgbd(
                out.color, out.depth, imgs[j], deps[j], 0.01, 0.95)
    total.backward()
    g = {f: p_.grad for f, p_ in params.items()}
    with torch.no_grad():
        new_gm, _ = tgmap.adam_update(gm, g, adam, LRS)
    return new_gm, float(total.detach())


def backend_config(mesh_devices):
    """tests/test_multichip.py's trimmed BackEnd configuration."""
    from gs_slam_analytica_jacobian_tpu_torch.utils.config import load_config
    cfg = load_config("configs/synthetic/test.yaml")
    cal = cfg["Dataset"]["Calibration"]
    cal["width"], cal["height"] = 32, 24
    cal["fx"] = cal["fy"] = 20.0
    cal["cx"], cal["cy"] = 15.5, 11.5
    T = cfg["Training"]
    T.update(renderer="oracle", monocular=False, mesh_devices=mesh_devices,
             window_size=4, pose_window=2, initial_capacity=256,
             kf_capacity=8, init_itr_num=2, init_gaussian_update=4,
             mapping_itr_num=1)
    cfg["Dataset"]["pcd_downsample_init"] = 16
    cfg["Dataset"]["pcd_downsample"] = 32
    return cfg


def backend_inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(3, 24, 32)).astype(np.float32)
    dep = rng.uniform(1.0, 3.0, size=(24, 32)).astype(np.float32)
    return img, dep


def run_backend(cfg, img, dep):
    from gs_slam_analytica_jacobian_tpu_torch.slam.backend import BackEnd
    cam = Camera.create(np.eye(3), np.zeros(3), 20.0, 20.0, 15.5, 11.5, 32,
                        24, device="cpu")
    be = BackEnd(cfg, cam, device="cpu")
    be.add_next_kf(0, np.eye(3), np.zeros(3), 0.0, 0.0, img, dep, dep,
                   init=True)
    be.initialize_map(0)
    be.add_next_kf(1, np.eye(3), np.array([0.02, 0, 0], np.float32), 0.0,
                   0.0, img, dep, dep)
    be.handle_keyframe(1, [1, 0])
    rec = {f: getattr(be.gm, f).numpy() for f in STATE + ("active",)}
    rec.update(F=be.F, store_t=be.store.t.numpy(),
               num_active=int(be.gm.num_active()))
    return rec


def _all_ranks(problems, cfg, img, dep):
    """One rank of the file's mesh: every mesh case, one record each."""
    mesh = sharding.make_mesh(N_RANKS, device="cpu")
    recs = {name: _record(run_steps(p, mesh)) for name, p in problems.items()}
    p = problems["oracle"]
    gm, adam, _, cam = _port_problem(p)
    R, t, imgs, deps, valid = step_inputs(p)
    new_gm, _, loss = sharding.sharded_mapping_step(
        mesh, gm, adam, R, t, imgs, deps, valid, cam, torch.zeros(3), LRS,
        use_oracle=True, pair_capacity=1 << 12)
    recs["step"] = {f: getattr(new_gm, f).numpy() for f in STATE}
    recs["step"]["loss"] = float(loss)
    recs["backend"] = run_backend(cfg, img, dep)
    return recs


@pytest.fixture(scope="module")
def problems():
    """build_problem's inputs (the JAX map and store) as numpy fields."""
    from gs_slam_analytica_jacobian_tpu.slam import mapping as jmapping
    from test_multichip import build_problem
    out = {}
    for name, (kw, tiled) in PROBLEMS.items():
        cam, gm, adam, store = build_problem(np.random.default_rng(0), **kw)
        out[name] = dict(
            gm={f: np.asarray(getattr(gm, f)) for f in tgmap.ARRAY_FIELDS},
            store={f.name: np.asarray(getattr(store, f.name))
                   for f in dataclasses.fields(jmapping.KFStore)},
            W=cam.width, H=cam.height, tiled=tiled,
            jax=(cam, gm, adam, store))
    return out


@pytest.fixture(scope="module")
def mesh_runs(problems):
    plain = {k: {q: v for q, v in p.items() if q != "jax"}
             for k, p in problems.items()}
    img, dep = backend_inputs()
    recs = sharding.run_ranks(
        _all_ranks, N_RANKS, (plain, backend_config(N_RANKS), img, dep),
        device="cpu")
    assert [r["backend"]["F"] for r in recs] == [8] * N_RANKS
    return recs


def _strip(p):
    return {q: v for q, v in p.items() if q != "jax"}


def _assert_close_to(rec, ref, loss_rtol=3e-4):
    np.testing.assert_allclose(rec["loss"], ref["loss"], rtol=loss_rtol)
    for f, lr in CHECKED_LRS.items():
        np.testing.assert_allclose(rec[f], ref[f], rtol=0, atol=2.5 * lr,
                                   err_msg=f)
    np.testing.assert_allclose(rec["store_t"], ref["store_t"], rtol=0,
                               atol=2.5e-3)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_mesh_ranks_agree(mesh_runs, name):
    """Every rank ends with the same map, store, pose optimizer and loss,
    bit for bit (the replicated state stays replicated)."""
    ref = mesh_runs[0][name]
    for r in mesh_runs[1:]:
        for k, v in ref.items():
            np.testing.assert_array_equal(r[name][k], v, err_msg=k)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_mesh_matches_one_rank(problems, mesh_runs, name):
    one = _record(run_steps(_strip(problems[name]), None))
    mesh = mesh_runs[0][name]
    _assert_close_to(mesh, one)
    # densification statistics of the first iteration: equal to the
    # one-rank sums (each frame's rows come from one rank)
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(mesh[f], one[f], err_msg=f)
    np.testing.assert_array_equal(mesh["radii"], one["radii"])
    np.testing.assert_allclose(mesh["store_R"], one["store_R"], atol=1e-6)
    np.testing.assert_allclose(mesh["pose_m"], one["pose_m"], atol=1e-6)
    assert np.mean(mesh["n_touched"] == one["n_touched"]) > 0.85


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_mesh_matches_jax_mesh(problems, mesh_runs, name):
    """The port's 4-rank mesh against the JAX package's 8-device mesh on
    the same inputs, at the JAX mesh test's tolerances."""
    import jax
    from gs_slam_analytica_jacobian_tpu.parallel.sharding import make_mesh
    from test_multichip import run_steps as jax_run_steps
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    cam, gm, adam, store = problems[name]["jax"]
    out = jax_run_steps(make_mesh(8), cam, gm, adam, store, F=8,
                        tiled=problems[name]["tiled"])
    ref = {f: np.asarray(getattr(out.gm, f)) for f in CHECKED_LRS}
    ref.update(loss=float(out.loss), store_t=np.asarray(out.store.t))
    mesh = mesh_runs[0][name]
    _assert_close_to(mesh, ref)
    nt_m, nt_j = mesh["n_touched"], np.asarray(out.n_touched)
    assert np.mean(nt_m == nt_j) > 0.85
    assert np.mean(np.abs(nt_m - nt_j) / np.maximum(np.abs(nt_j), 1)) < 0.05


def test_sharded_mapping_step(problems, mesh_runs):
    """sharded_mapping_step on 4 ranks against its one-rank definition
    and against the JAX package's on its 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from gs_slam_analytica_jacobian_tpu.parallel import sharding as jsharding
    p = problems["oracle"]
    one_gm, one_loss = one_rank_step(_strip(p))
    rec = mesh_runs[0]["step"]
    one = {f: getattr(one_gm, f).detach().numpy() for f in CHECKED_LRS}
    np.testing.assert_allclose(rec["loss"], one_loss, rtol=3e-4)
    for f, lr in CHECKED_LRS.items():
        np.testing.assert_allclose(rec[f], one[f], rtol=0, atol=2.5 * lr,
                                   err_msg=f)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    cam, gm, adam, store = p["jax"]
    F = 8
    new_gm, _, loss = jsharding.sharded_mapping_step(
        jsharding.make_mesh(8), gm, adam, store.R[:F], store.t[:F],
        jnp.stack([store.image(i) for i in range(F)]),
        jnp.stack([store.depth(i) for i in range(F)]),
        jnp.asarray([True] * (F - 1) + [False]), cam, jnp.zeros(3), LRS,
        use_oracle=True, pair_capacity=1 << 12)
    np.testing.assert_allclose(rec["loss"], float(loss), rtol=3e-4)
    for f, lr in CHECKED_LRS.items():
        np.testing.assert_allclose(rec[f], np.asarray(getattr(new_gm, f)),
                                   rtol=0, atol=2.5 * lr, err_msg=f)


def test_backend_mesh_trimmed(mesh_runs):
    """BackEnd with mesh_devices=4 (tests/test_multichip.py's trimmed
    wiring gate): init and one keyframe mapped on the mesh; F padded to
    8; finite; every rank the same; and the one-rank BackEnd's map within
    the mapping tolerances."""
    recs = [r["backend"] for r in mesh_runs]
    rec = recs[0]
    for r in recs[1:]:
        for k in ("xyz", "opacity", "active", "store_t"):
            np.testing.assert_array_equal(r[k], rec[k], err_msg=k)
    active = rec["active"]
    assert rec["num_active"] > 0
    assert np.all(np.isfinite(rec["xyz"][active]))
    one = run_backend(backend_config(1), *backend_inputs())
    assert one["F"] == 6
    np.testing.assert_array_equal(one["active"], active)
    for f, lr in CHECKED_LRS.items():
        np.testing.assert_allclose(rec[f][active], one[f][active], rtol=0,
                                   atol=2.5 * lr * 4, err_msg=f)


def test_mesh_rejects_frames_that_do_not_split():
    """F must be a multiple of the mesh size (Mesh.shard)."""
    mesh = sharding.Mesh(group=None, rank=0, size=3, device=torch.device(
        "cpu"), backend="gloo")
    with pytest.raises(ValueError, match="split"):
        mesh.shard(8)
    assert list(sharding.Mesh(None, 1, 4, torch.device("cpu"),
                              "gloo").shard(8)) == [2, 3]

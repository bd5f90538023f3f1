"""``mapping_steps`` of the port vs the JAX reference: T = 2 iterations
over F = 3 frame slots (2 window keyframes, 1 random) at 64x48 with 2000
Gaussians, from the same map, store and optimizer states carried across,
on the tiled renderer at both tile sizes (Pallas kernels in interpret
mode; the port's plain versions) here and on the dense oracle in
tests/test_torch_mapping_steps_oracle.py (each variant is one JAX
compile of 15-35 s, so the two files share them out). The tiled cases
cover an invalid slot with the random slot planned once per batch
(``n_planned``), and a random slot that changes between iterations
(fresh plans).

Tolerances: the Adam moments within 1e-3 of each field's max |m| (v, m
squared in scale, within 2e-3 of its max). A parameter whose gradient
stands clear of rounding noise (|m| > 1e-2 max |m|) lies within 1e-3 of
its T Adam steps (1e-3 T lr, + 1e-6 for its own rounding). Where a
gradient is rounding noise (the tiled backward's cumsum segment-reduce
leaves ~1e-10 where the true gradient is 0), Adam's sign-like first
steps can differ by up to lr per step, so there the bound is 2 T lr.
Densification sums within 1e-3 of their max (sums of gradient norms, as
the moments), counts and max radii exactly, poses and exposures 1e-6,
the pose Adam's m 1e-6 and v 2e-3 of its max, the loss rtol 1e-5, the
window's n_touched exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.slam import mapping as jmapping
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping as tmapping

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)

W, H, N, CAP, F, T_ITERS = 64, 48, 2000, 2304, 3, 2
LRS = {"xyz": 1e-3, "features_dc": 2e-3, "features_rest": 1e-4,
       "opacity": 5e-2, "scaling": 1e-3, "rotation": 1e-3}
# variant -> (use_oracle, tile16, window rows, valid, n_planned)
VARIANTS = {
    "oracle": (True, False, [[1, 0, 2], [1, 0, 3]], [1, 1, 1], None),
    "tile32": (False, False, [[1, 0, 2], [1, 0, 2]], [1, 1, 0], 3),
    "tile16": (False, True, [[1, 0, 2], [1, 0, 3]], [1, 1, 1], None),
}
_RUNS = {}


def _problem():
    rng = np.random.default_rng(0)
    arrays = dict(
        xyz=np.stack([rng.uniform(-1, 1, N), rng.uniform(-0.7, 0.7, N),
                      rng.uniform(0.5, 3.0, N)], -1).astype(np.float32),
        features_dc=rng.normal(size=(N, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((N, 0, 3), np.float32),
        scaling=rng.normal(size=(N, 3)).astype(np.float32) * 0.2 - 3.0,
        rotation=rng.normal(size=(N, 4)).astype(np.float32),
        opacity=rng.normal(size=(N, 1)).astype(np.float32))
    gm = jgmap.from_numpy(**arrays, max_sh_degree=0, capacity=CAP)
    store = jmapping.KFStore.empty(4, H, W)
    for i in range(4):
        t = np.array([0.02 * i, -0.01 * i, 0.0], np.float32)
        store = store.add(
            i, jnp.eye(3), jnp.asarray(t), 0.01 * i, -0.02 * i,
            jnp.asarray(rng.uniform(size=(3, H, W)).astype(np.float32)),
            jnp.asarray(rng.uniform(0.5, 3.0, (1, H, W)).astype(np.float32)),
            i)
    return gm, store


def _run(variant):
    if variant in _RUNS:
        return _RUNS[variant]
    use_oracle, tile16, rows, valid, n_planned = VARIANTS[variant]
    rows = np.asarray(rows, np.int32)
    valid = np.asarray(valid, bool)
    opt_pose = np.array([True, False, False])
    opt_exp = np.array([True, False, False])
    gm_j, store_j = _problem()
    cam_j = JCamera.create(np.eye(3), np.zeros(3), 40.0, 40.0, (W - 1) / 2,
                           (H - 1) / 2, W, H)
    out_j = jmapping.mapping_steps(
        gm_j, jgmap.adam_init(gm_j), store_j, jnp.asarray(rows),
        jnp.asarray(valid), jnp.asarray(opt_pose), jnp.asarray(opt_exp),
        jmapping.PoseAdamState.zero(F), cam_j, jnp.zeros(3), LRS,
        jnp.full((T_ITERS,), 1e-3), 1e-3, 1e-3, 0.01, n_window=2,
        pair_capacity=1 << 14, use_oracle=use_oracle, interpret=True,
        tile16=tile16, n_planned=n_planned)

    gm_t = tgmap.from_jax_fields(
        {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS}, 0, 0,
        device="cpu")
    adam_j = jgmap.adam_init(gm_j)
    adam_t = tgmap.adam_from_jax_fields(
        {f: np.asarray(adam_j.m[f]) for f in tgmap.PARAM_FIELDS},
        {f: np.asarray(adam_j.v[f]) for f in tgmap.PARAM_FIELDS},
        int(adam_j.step), device="cpu")
    store_t = tmapping.KFStore.from_jax_fields(
        {f.name: np.asarray(getattr(store_j, f.name))
         for f in dataclasses.fields(jmapping.KFStore)}, device="cpu")
    zero = jmapping.PoseAdamState.zero(F)
    cam_t = Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, (W - 1) / 2,
                          (H - 1) / 2, W, H, device="cpu")
    out_t = tmapping.mapping_steps(
        gm_t, adam_t, store_t, rows, valid, opt_pose, opt_exp,
        tmapping.PoseAdamState.from_jax(zero.m, zero.v, zero.step,
                                        device="cpu"),
        cam_t, torch.zeros(3),
        {k: torch.tensor(v, dtype=torch.float32) for k, v in LRS.items()},
        [1e-3] * T_ITERS, 1e-3, 1e-3, 0.01, n_window=2,
        pair_capacity=1 << 14, use_oracle=use_oracle, tile16=tile16,
        n_planned=n_planned)
    _RUNS[variant] = (out_j, out_t)
    return out_j, out_t


@pytest.mark.parametrize("variant", ["tile32", "tile16"])
def test_mapping_steps_parameters_match(variant):
    check_parameters(variant)


@pytest.mark.parametrize("variant", ["tile32", "tile16"])
def test_mapping_steps_state_match(variant):
    check_state(variant)


def check_parameters(variant):
    out_j, out_t = _run(variant)
    for f in tgmap.PARAM_FIELDS:
        mj = np.asarray(out_j.gm_adam.m[f])
        if mj.size == 0:
            continue
        scale = np.abs(mj).max()
        assert scale > 0, f
        np.testing.assert_allclose(out_t.gm_adam.m[f].numpy(), mj, rtol=0,
                                   atol=1e-3 * scale, err_msg=f)
        vj = np.asarray(out_j.gm_adam.v[f])
        np.testing.assert_allclose(out_t.gm_adam.v[f].numpy(), vj, rtol=0,
                                   atol=2e-3 * np.abs(vj).max(), err_msg=f)
        pj, pt = np.asarray(getattr(out_j.gm, f)), getattr(out_t.gm, f).numpy()
        diff = np.abs(pt - pj)
        signal = np.abs(mj) > 1e-2 * scale
        assert signal.sum() > 0.05 * signal.size, f
        bound = 1e-3 * T_ITERS * LRS[f] + 1e-6
        assert diff[signal].max() <= bound, (f, diff[signal].max())
        assert diff.max() <= 2 * T_ITERS * LRS[f] + 1e-6, (f, diff.max())
    assert int(out_t.gm_adam.step) == int(out_j.gm_adam.step) == T_ITERS


def check_state(variant):
    out_j, out_t = _run(variant)
    np.testing.assert_allclose(float(out_t.loss), float(out_j.loss),
                               rtol=1e-5)
    gj, gt = out_j.gm, out_t.gm
    np.testing.assert_allclose(gt.xyz_grad_accum.numpy(),
                               np.asarray(gj.xyz_grad_accum), rtol=1e-4,
                               atol=1e-3 * float(np.abs(
                                   np.asarray(gj.xyz_grad_accum)).max()))
    np.testing.assert_array_equal(gt.denom.numpy(), np.asarray(gj.denom))
    np.testing.assert_array_equal(gt.max_radii2d.numpy(),
                                  np.asarray(gj.max_radii2d))
    assert float(gt.denom.sum()) > 0
    np.testing.assert_array_equal(out_t.radii.numpy(),
                                  np.asarray(out_j.radii))
    for f in ("R", "t", "exposure_a", "exposure_b"):
        np.testing.assert_allclose(getattr(out_t.store, f).numpy(),
                                   np.asarray(getattr(out_j.store, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    # the optimized window keyframe moved; keyframe 0's slot did not
    assert float(np.abs(np.asarray(out_j.store.t[1])
                        - np.array([0.02, -0.01, 0.0])).max()) > 1e-4
    np.testing.assert_array_equal(out_t.store.t[0].numpy(),
                                  np.zeros(3, np.float32))
    np.testing.assert_allclose(out_t.pose_adam.m.numpy(),
                               np.asarray(out_j.pose_adam.m), rtol=0,
                               atol=1e-6)
    vj = np.asarray(out_j.pose_adam.v)
    np.testing.assert_allclose(out_t.pose_adam.v.numpy(), vj, rtol=0,
                               atol=2e-3 * np.abs(vj).max())
    # window_visibility at the final state: n_touched exactly
    np.testing.assert_array_equal(out_t.n_touched.numpy(),
                                  np.asarray(out_j.n_touched))
    assert int(out_t.n_touched.sum()) > 0

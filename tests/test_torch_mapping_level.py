"""``mapping_steps(level=2)`` of the port (the coarse mapping phase:
half-resolution renders against the pooled ground truth with the
blur-matched low-pass, densify statistics rescaled to full-resolution
units) against the JAX package on the inputs of tests/test_multichip.py's
``test_mapping_coarse_level_optimizes`` (``build_problem``: F = 8 slots
at 64x48, 160 Gaussians; T = 1 and 4 iterations at level 2, 4 at level
1), on the tiled renderer (Pallas in interpret mode; the port's plain
versions).

Tolerances (tests/test_torch_mapping_steps.py's): the loss rtol 1e-5;
parameters within 2 T lr (where a gradient is rounding noise Adam's
sign-like steps can differ by lr a step); after one iteration the
densify counts and max radii exactly, the gradient-norm sums within 1e-3
of their max. The port also passes the JAX test's own checks: the loss
falls over the batch, every field stays finite, and the level-2 radii
land in full-resolution units.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping as tmapping

torch.set_num_threads(1)

F, T = 8, 4
LRS = {"xyz": 1e-3, "features_dc": 2e-3, "features_rest": 1e-4,
       "opacity": 5e-2, "scaling": 1e-3, "rotation": 1e-3}
RUNS = ((2, 1), (2, T), (1, T))
FIELDS = ("xyz", "features_dc", "scaling", "opacity", "rotation",
          "xyz_grad_accum", "denom", "max_radii2d")


def _args():
    rows = np.tile(np.arange(F, dtype=np.int32)[None], (T, 1))
    valid = np.ones(F, bool)
    valid[-1] = False
    sel = np.zeros(F, bool)
    sel[1] = True
    return rows, valid, sel


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp
    from gs_slam_analytica_jacobian_tpu.slam import mapping as jmapping
    from test_multichip import build_problem

    cam_j, gm_j, adam_j, store_j = build_problem(np.random.default_rng(0))
    rows, valid, sel = _args()
    gm_fields = {f: np.asarray(getattr(gm_j, f)) for f in tgmap.ARRAY_FIELDS}
    store_fields = {f.name: np.asarray(getattr(store_j, f.name))
                    for f in dataclasses.fields(jmapping.KFStore)}
    W, H = cam_j.width, cam_j.height
    cam_t = Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, (W - 1) / 2,
                          (H - 1) / 2, W, H, device="cpu")
    out = {}
    for level, t_ in RUNS:
        oj = jmapping.mapping_steps(
            gm_j, adam_j, store_j, jnp.asarray(rows[:t_]),
            jnp.asarray(valid), jnp.asarray(sel), jnp.asarray(sel),
            jmapping.PoseAdamState.zero(F), cam_j, jnp.zeros(3), LRS,
            jnp.full((t_,), 1e-3), 1e-3, 1e-3, 0.01, n_window=4, alpha=0.95,
            monocular=False, pair_capacity=1 << 12, use_oracle=False,
            interpret=True, level=level)
        gm_t = tgmap.from_jax_fields(gm_fields, 0, 0, device="cpu")
        ot = tmapping.mapping_steps(
            gm_t, tgmap.adam_init(gm_t),
            tmapping.KFStore.from_jax_fields(store_fields, device="cpu"),
            rows[:t_], valid, sel, sel,
            tmapping.PoseAdamState.zero(F, device="cpu"), cam_t,
            torch.zeros(3), LRS, [1e-3] * t_, 1e-3, 1e-3, 0.01, n_window=4,
            alpha=0.95, monocular=False, pair_capacity=1 << 12,
            use_oracle=False, level=level)
        out[(level, t_)] = (
            {f: np.asarray(getattr(oj.gm, f)) for f in FIELDS}
            | {"loss": float(oj.loss), "t": np.asarray(oj.store.t)},
            {f: getattr(ot.gm, f).numpy() for f in FIELDS}
            | {"loss": float(ot.loss), "t": ot.store.t.numpy()})
    return out


@pytest.mark.parametrize("level,t_", RUNS)
def test_mapping_level_matches_jax(runs, level, t_):
    j, p = runs[(level, t_)]
    np.testing.assert_allclose(p["loss"], j["loss"], rtol=1e-5)
    for f in ("xyz", "features_dc", "scaling", "opacity", "rotation"):
        np.testing.assert_allclose(p[f], j[f], rtol=0,
                                   atol=2 * t_ * LRS[f] + 1e-6, err_msg=f)
    np.testing.assert_allclose(p["t"], j["t"], rtol=0, atol=2 * t_ * 1e-3)
    if t_ == 1:
        np.testing.assert_array_equal(p["denom"], j["denom"])
        np.testing.assert_array_equal(p["max_radii2d"], j["max_radii2d"])
        scale = np.abs(j["xyz_grad_accum"]).max()
        np.testing.assert_allclose(p["xyz_grad_accum"], j["xyz_grad_accum"],
                                   rtol=0, atol=1e-3 * scale)


def test_mapping_coarse_level_optimizes_port(runs):
    """The JAX test's own checks, on the port's runs."""
    first, coarse, full = (runs[k][1] for k in RUNS)
    assert np.isfinite(coarse["loss"])
    assert coarse["loss"] < first["loss"]
    for f in ("xyz", "scaling", "opacity", "features_dc"):
        assert np.all(np.isfinite(coarse[f])), f
    r2, r1 = coarse["max_radii2d"], full["max_radii2d"]
    both = (r1 > 2.0) & (r2 > 0)
    assert both.sum() > 10
    assert 0.7 < np.median(r2[both] / r1[both]) < 1.5
    assert float(np.sum(coarse["denom"])) > 0

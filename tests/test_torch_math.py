"""Port math vs the JAX reference: Lie group, quaternions, covariances,
SH and the full preprocess stage, on the same numpy inputs.

Float fields match at rtol/atol 1e-5 (f32 arithmetic in two libraries:
exp/log/sqrt and summation order differ by a few ulp); the integer and
boolean fields (valid, rect_min, rect_max, tiles_touched) are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
from gs_slam_analytica_jacobian_tpu.ops import lie as jlie
from gs_slam_analytica_jacobian_tpu.ops import sh as jsh
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import lie as tlie
from gs_slam_analytica_jacobian_tpu_torch.ops import sh as tsh

from test_renderer_ref import make_scene

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def T(x):
    return torch.as_tensor(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("scale", [0.0, 1e-7, 3e-6, 0.05, 0.4, 2.5])
def test_so3_se3_exp_match(scale):
    """Includes angles under the 1e-5 Taylor cutoff. (Angles near 1e-3
    are left out: there (1 - cos x) / x^2 cancels catastrophically in f32
    in both packages, each off by up to ~25% depending on how its cos
    rounds, so so3_V's first-order term is not comparable at 1e-5.)"""
    rng = np.random.default_rng(int(scale * 1e7) % 1000)
    tau = (rng.normal(size=6) * scale).astype(np.float32)
    tau[:3] = rng.normal(size=3).astype(np.float32) * 0.3
    np.testing.assert_allclose(tlie.so3_exp(T(tau[3:])).numpy(),
                               np.asarray(jlie.so3_exp(J(tau[3:]))), **TOL)
    np.testing.assert_allclose(tlie.so3_V(T(tau[3:])).numpy(),
                               np.asarray(jlie.so3_V(J(tau[3:]))), **TOL)
    np.testing.assert_allclose(tlie.se3_exp(T(tau)).numpy(),
                               np.asarray(jlie.se3_exp(J(tau))), **TOL)
    R = np.asarray(jlie.so3_exp(J([0.1, -0.2, 0.3])))
    t = np.array([0.5, -0.1, 2.0], np.float32)
    got = tlie.update_pose(T(tau), T(R), T(t))
    ref = jlie.update_pose(J(tau), J(R), J(t))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert bool(got[2]) == bool(ref[2])


def test_quat_cov3d_cov2d_sh_match(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = np.exp(rng.normal(size=(50, 3)) * 0.4 - 1.6).astype(np.float32)
    np.testing.assert_allclose(tlie.quat_to_rotmat(T(q)).numpy(),
                               np.asarray(jlie.quat_to_rotmat(J(q))), **TOL)
    cov_t = tgm.build_cov3d(T(s), T(q))
    cov_j = jgm.build_cov3d(J(s), J(q))
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), **TOL)

    p_view = rng.normal(size=(50, 3)).astype(np.float32)
    p_view[:, 2] = np.abs(p_view[:, 2]) + 0.3
    W_rot = np.asarray(jlie.so3_exp(J([0.05, -0.03, 0.02])))
    for lp in (0.3, 0.1125):
        a = tgm.compute_cov2d(T(p_view), cov_t, T(W_rot), 60.0, 55.0,
                              0.8, 0.6, low_pass=lp)
        b = jgm.compute_cov2d(J(p_view), cov_j, J(W_rot), 60.0, 55.0,
                              0.8, 0.6, low_pass=lp)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)

    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    shs = (rng.normal(size=(50, 16, 3)) * 0.4).astype(np.float32)
    for deg in range(4):
        np.testing.assert_allclose(
            tsh.sh_to_color(deg, T(shs), T(dirs)).numpy(),
            np.asarray(jsh.sh_to_color(deg, J(shs), J(dirs))), **TOL)


@pytest.mark.parametrize("n,W,H,low_pass", [(25, 160, 40, 0.3),
                                            (60, 96, 64, 0.1125)])
def test_preprocess_matches(n, W, H, low_pass):
    rng = np.random.default_rng(n)
    sc = make_scene(rng, n=n, W=W, H=H)
    # push a few splats behind the camera and far off-screen
    sc["means"][:3, 2] = [-1.0, 0.1, 0.25]
    sc["means"][3, 0] = 40.0
    tau = np.array([0.01, -0.02, 0.005, 0.003, -0.002, 0.004], np.float32)
    args = (sc["means"], np.asarray(jgm.build_cov3d(J(sc["scales"]),
                                                    J(sc["quats"]))),
            sc["opac"], sc["shs"])
    ref = jgm.preprocess(*[J(a) for a in args], 3, J(sc["w2c"]),
                         J(sc["proj"]), J(tau), sc["fx"], sc["fy"], W, H,
                         sc["tanfovx"], sc["tanfovy"], low_pass=low_pass)
    got = tgm.preprocess(*[T(a) for a in args], 3, T(sc["w2c"]),
                         T(sc["proj"]), T(tau), sc["fx"], sc["fy"], W, H,
                         sc["tanfovx"], sc["tanfovy"], low_pass=low_pass)
    for name in got._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if name in ("valid", "rect_min", "rect_max", "tiles_touched"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            ok = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), ok, err_msg=name)
            np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert 0 < int(got.valid.sum()) < n

"""The analytic-Jacobian lab of the port (ops/jacobians.py and its runner
gs_slam_analytica_jacobian_tpu_torch/jacobian_test.py) on the committed
15-Gaussian fixture, on the CPU:

- it reproduces tests/fixtures/jacobian_golden.npz at the tolerances of
  tests/test_jacobian_golden.py:24-38;
- its exact mode matches torch autograd of the lab's forward (rel < 5e-4,
  as tests/test_jacobian_golden.py:41);
- its pose Jacobians (Eq. 3/4, both modes) match the JAX lab's (rtol 1e-5);
- the port's tiled renderer dL/dtau (plain backward compositing on CPU
  tensors) closes on the lab's exact total: max rel < 5%, cosine > 0.999
  (the gate of tests/test_tpu_kernels.py:280; the renderer carries the
  1/255, 0.99 and T < 1e-4 quantization the lab's compositing has not)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops import jacobians as jjac
from gs_slam_analytica_jacobian_tpu_torch import jacobian_test as lab
from gs_slam_analytica_jacobian_tpu_torch.ops import camera_math as cm
from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
from gs_slam_analytica_jacobian_tpu_torch.ops import jacobians as tjac
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt

# one intra-op thread: under pytest-xdist each worker would otherwise
# start a thread pool over every core, and the plain versions' many
# small operations then spin-wait against each other's pools
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def fix():
    return lab.load_fixture(os.path.join(FIXDIR, "jacobian_fixture.npz"))


@pytest.fixture(scope="module")
def exact(fix):
    return lab.run(fix, mode="exact", verbose=False, device="cpu")


def test_lab_reproduces_goldens(fix):
    gold = np.load(os.path.join(FIXDIR, "jacobian_golden.npz"))
    res = lab.run(fix, mode="reference", verbose=False, device="cpu")
    np.testing.assert_allclose(res["total"], gold["dL_dtau"], rtol=2e-3,
                               atol=1e-3)
    np.testing.assert_allclose(res["grads"].grad_mu, gold["grad_mu"],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(res["grads"].grad_sigma, gold["grad_sigma"],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(res["grads"].grad_depth, gold["grad_depth"],
                               rtol=2e-3, atol=1e-5)


def test_lab_exact_mode_matches_autodiff(exact):
    err = np.abs(exact["total"] - exact["autodiff"]).max()
    rel = err / (np.abs(exact["autodiff"]).max() + 1e-12)
    assert rel < 5e-4, (exact["total"], exact["autodiff"])
    assert set(exact["parts"]) == {"mu", "cov", "depth", "sh"}


@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_pose_jacobians_match_jax(fix, mode):
    w2c = (np.asarray(fix["w2c_gt"], np.float32)
           @ np.asarray(fix["T_noise"], np.float32))
    cov6 = tgm.build_cov3d(torch.exp(torch.as_tensor(fix["scaling"])),
                           torch.as_tensor(fix["rotation"]))
    cov3d = tgm.cov3d_to_matrix(cov6).numpy()
    H, W = fix["gt_depth"].shape
    fx, fy = float(fix["fx"]), float(fix["fy"])
    got = tjac.pose_jacobians(torch.as_tensor(fix["xyz"]),
                              torch.as_tensor(cov3d), torch.as_tensor(w2c),
                              fx, fy, W, H, mode=mode)
    ref = jjac.pose_jacobians(jnp.asarray(fix["xyz"]), jnp.asarray(cov3d),
                              jnp.asarray(w2c), fx, fy, W, H, mode=mode)
    for g, r, name in zip(got, ref, ("dmu", "dSigma")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_tiled_renderer_dtau_closes_on_lab(fix, exact):
    analytic = exact["total"]
    means = torch.as_tensor(fix["xyz"])
    opac = torch.sigmoid(torch.as_tensor(fix["opacity"]))[:, 0]
    shs = torch.as_tensor(fix["features"])
    w2c = torch.as_tensor(np.asarray(fix["w2c_gt"], np.float32)
                          @ np.asarray(fix["T_noise"], np.float32))
    gt_color = torch.as_tensor(fix["gt_color"])
    gt_depth = torch.as_tensor(fix["gt_depth"])
    mask = torch.as_tensor(fix["mask"])
    fx, fy, cx, cy = [float(fix[k]) for k in ("fx", "fy", "cx", "cy")]
    H, W = gt_depth.shape
    proj = torch.as_tensor(cm.projection_matrix(0.01, 100.0, cx, cy, fx, fy,
                                                W, H))
    cov6 = tgm.build_cov3d(torch.exp(torch.as_tensor(fix["scaling"])),
                           torch.as_tensor(fix["rotation"]))
    tau = torch.zeros(6, requires_grad=True)
    out = trt.render(means, cov6, opac, shs, 3, w2c, proj, tau, fx, fy, W,
                     H, W / (2 * fx), H / (2 * fy), torch.zeros(3),
                     pair_capacity=1 << 14, need_n_touched=False,
                     device="cpu")
    C = out.color.permute(1, 2, 0)
    D = out.depth[0]
    L = (torch.sum(torch.abs(C - gt_color) * mask[..., None])
         + torch.sum(torch.abs(D - gt_depth) * (mask & (gt_depth > 0))))
    (g,) = torch.autograd.grad(L, tau)
    g = g.numpy()
    assert np.all(np.isfinite(g)), g
    rel = np.abs(g - analytic).max() / (np.abs(analytic).max() + 1e-12)
    cos = float(g @ analytic
                / (np.linalg.norm(g) * np.linalg.norm(analytic) + 1e-12))
    assert rel < 0.05, (g, analytic, rel)
    assert cos > 0.999, cos

"""The reference API the port gained last, against the JAX package, on the
same numpy inputs made from a seed:

- ``ops.losses.depth_reg`` on test_losses.py's inputs (carved invalid
  depth; a smooth depth): rtol 1e-5 against JAX and against that file's
  numpy re-derivation; its autograd gradient w.r.t. depth finite and
  within 1e-5 (relative to its largest entry) of ``jax.grad``'s on the
  carved depth. On the smooth depth every depth gradient is exactly 0,
  where |x| has no derivative: torch.abs takes 0 there (as the
  reference's PyTorch does), jnp.abs +1, so the port's gradient is 0 at
  the regularizer's minimum and JAX's is not (ROADMAP queue C);
- ``ops.sh.sh0_to_rgb``: a round trip with ``rgb_to_sh0`` and JAX's
  values; ``ops.camera_math.ndc_to_pix``: JAX's values;
- ``models.camera.Camera.from_w2c``: the same fields as JAX's;
- the backend's NaN check (``GS_SLAM_NAN_CHECK=1``, the module flag
  patched): a map poisoned with NaN raises ``AssertionError`` with JAX's
  tag and field after the next batch; with the flag off the same run
  does not raise and ``_assert_finite`` is never called.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCamera
from gs_slam_analytica_jacobian_tpu.ops import camera_math as jcm
from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
from gs_slam_analytica_jacobian_tpu.ops import sh as jsh
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import camera_math as tcm
from gs_slam_analytica_jacobian_tpu_torch.ops import losses as tlosses
from gs_slam_analytica_jacobian_tpu_torch.ops import sh as tsh
from gs_slam_analytica_jacobian_tpu_torch.ops.lie import se3_exp
from gs_slam_analytica_jacobian_tpu_torch.slam import backend as tbackend

from test_losses import _np_conv3x3_reflect, _np_scharr
from test_torch_mapping import _backend_config

# one intra-op thread (see test_torch_math.py)
torch.set_num_threads(1)

RTOL = 1e-5


def _carved_inputs(rng):
    """tests/test_losses.py's depth_reg inputs: random depth with an
    invalid (zero) block, so the 3x3 mask is not trivial."""
    H, W = 14, 19
    depth = rng.uniform(0.5, 3.0, size=(1, H, W)).astype(np.float32)
    depth[0, 3:6, 4:9] = 0.0
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    return depth, gt


def _np_depth_reg(depth, gt):
    """tests/test_losses.py's numpy re-derivation of the reference."""
    valid = (np.abs(depth[0]) > 0.01).astype(np.float32)
    m = _np_conv3x3_reflect(valid, np.ones((3, 3))) == 9.0
    ggv, ggh = _np_scharr(gt.mean(axis=0))
    dgv, dgh = _np_scharr(depth[0])
    return ((np.exp(-10 * ggh[m] ** 2) * np.abs(dgh[m])).mean()
            + (np.exp(-10 * ggv[m] ** 2) * np.abs(dgv[m])).mean())


def _smooth_inputs(rng):
    del rng
    return (np.full((1, 16, 16), 2.0, np.float32),
            np.zeros((3, 16, 16), np.float32))


@pytest.mark.parametrize("inputs", [_carved_inputs, _smooth_inputs],
                         ids=["carved", "smooth"])
def test_depth_reg_matches_jax(rng, inputs):
    depth, gt = inputs(rng)
    d = torch.tensor(depth, requires_grad=True)
    loss = tlosses.depth_reg(d, torch.tensor(gt))
    (grad,) = torch.autograd.grad(loss, d)
    got, grad = float(loss.detach()), grad.numpy()
    ref = jlosses.depth_reg(jnp.asarray(depth), jnp.asarray(gt))
    ref_grad = np.asarray(jax.grad(jlosses.depth_reg)(jnp.asarray(depth),
                                                      jnp.asarray(gt)))
    np.testing.assert_allclose(got, float(ref), rtol=RTOL, atol=1e-7)
    assert np.isfinite(grad).all()
    if inputs is _carved_inputs:
        np.testing.assert_allclose(got, _np_depth_reg(depth, gt), rtol=RTOL)
        scale = float(np.abs(ref_grad).max())
        assert got > 0 and scale > 0
        np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=RTOL * scale)
    else:
        # abs at exactly 0: torch's subgradient 0, JAX's +1
        assert got < 1e-6
        assert not grad.any() and np.abs(ref_grad).max() > 0


def test_depth_reg_ignores_huber_eps_and_mask(rng):
    depth, gt = _carved_inputs(rng)
    d, g = torch.tensor(depth), torch.tensor(gt)
    assert float(tlosses.depth_reg(d, g)) == float(tlosses.depth_reg(
        d, g, huber_eps=0.5, mask=torch.zeros(1, 14, 19, dtype=torch.bool)))


def test_sh0_to_rgb_round_trip_and_jax(rng):
    rgb = rng.uniform(size=(50, 1, 3)).astype(np.float32)
    sh0 = tsh.rgb_to_sh0(torch.tensor(rgb))
    np.testing.assert_allclose(tsh.sh0_to_rgb(sh0).numpy(), rgb, rtol=0,
                               atol=1e-6)
    x = rng.normal(size=(50, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh0_to_rgb(torch.tensor(x)).numpy(),
                               np.asarray(jsh.sh0_to_rgb(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-7)


def test_ndc_to_pix_matches_jax(rng):
    v = rng.uniform(-1.5, 1.5, size=(100, 2)).astype(np.float32)
    for S in (1200, 680.0):
        np.testing.assert_allclose(
            tcm.ndc_to_pix(torch.tensor(v), S).numpy(),
            np.asarray(jcm.ndc_to_pix(jnp.asarray(v), S)), rtol=RTOL)


def test_camera_from_w2c_matches_jax(rng):
    tau = torch.tensor(rng.normal(size=6) * 0.3, dtype=torch.float32)
    w2c = se3_exp(tau).numpy()
    args = (512.0, 498.5, 319.5, 239.5, 640, 480)
    got = Camera.from_w2c(w2c, *args, znear=0.05, zfar=50.0, device="cpu")
    ref = JCamera.from_w2c(w2c, *args, znear=0.05, zfar=50.0)
    assert got.R.device.type == "cpu" and got.R.dtype == torch.float32
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(ref.R))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))
    for f in ("fx", "fy", "cx", "cy", "width", "height", "znear", "zfar"):
        assert getattr(got, f) == getattr(ref, f), f
        assert type(getattr(got, f)) is type(getattr(ref, f)), f
    np.testing.assert_allclose(got.w2c().numpy(), np.asarray(ref.w2c()),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the backend's NaN check
# ---------------------------------------------------------------------------

def _frame(k, W=40, H=32):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 5 + k * 0.1),
                    0.5 + 0.4 * np.cos(yy / 4), np.full_like(xx, 0.3)])
    dep = 2.0 + 0.3 * np.sin(xx / 7) + 0.01 * k
    return (img.astype(np.float32), dep.astype(np.float32),
            np.array([0.01 * k, 0.0, 0.0], np.float32))


def _run(monkeypatch, flag, poison):
    """Map initialization, then keyframe 1 added and one map batch, the
    map's first active Gaussian's xyz set to NaN before it if ``poison``.
    Returns the number of _assert_finite calls."""
    monkeypatch.setattr(tbackend, "_NAN_CHECK", flag)
    calls = []
    check = tbackend.BackEnd._assert_finite

    def counted(be, tag):
        calls.append(tag)
        return check(be, tag)

    monkeypatch.setattr(tbackend.BackEnd, "_assert_finite", counted)
    W, H = 40, 32
    cam = Camera.create(np.eye(3), np.zeros(3), 30.0, 30.0, (W - 1) / 2,
                        (H - 1) / 2, W, H, device="cpu")
    be = tbackend.BackEnd(_backend_config(), cam, device="cpu")
    img, dep, t = _frame(0)
    be.add_next_kf(0, np.eye(3), t, 0.0, 0.0, img, dep, dep, init=True)
    be.initialize_map(0)
    img, dep, t = _frame(1)
    be.add_next_kf(1, np.eye(3), t, 0.0, 0.0, img, dep, dep)
    if poison:
        i = int(torch.nonzero(be.gm.active)[0])
        xyz = be.gm.xyz.clone()
        xyz[i] = float("nan")
        be.gm = be.gm.replace(xyz=xyz)
    be.map([1, 0], iters=1)
    return calls


def test_nan_check_raises_with_the_tag_and_field(monkeypatch):
    with pytest.raises(AssertionError) as e:
        _run(monkeypatch, True, poison=True)
    assert e.value.args[0] == ("after _run_batch T=1 init=False", "xyz")


def test_nan_check_runs_after_every_batch_and_densify(monkeypatch):
    calls = _run(monkeypatch, True, poison=False)
    # init: 4 iterations in one batch, then densify_and_prune; one batch
    assert calls == ["after _run_batch T=4 init=True",
                     "after densify_and_prune",
                     "after _run_batch T=1 init=False"]


def test_nan_check_off_is_never_called(monkeypatch):
    assert _run(monkeypatch, False, poison=True) == []

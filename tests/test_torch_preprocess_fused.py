"""The fused preprocess (ops/preprocess_fused.py) on the CPU: its plain
analytic backward against autograd through its plain forward, its
dispatch, and its kernel wrappers' checks.

The analytic backward (``preprocess_bwd_plain``, the CUDA backward's
terms in its order) is held to ``torch.autograd`` through
``preprocess_plain`` (the map's activations, ``gaussian_math.preprocess``
and ``pack_table``) for one table gradient, on scenes that reach every
branch the backward keeps: points whose frustum ratio is clamped, points
behind the near plane (some behind the camera), a zero covariance at
``low_pass`` 0 (``det == 0``), opacity under 1/255 (``q = 0``), SH
colours clamped at 0, a screen-space offset, ``scale_modifier`` 0.7 and a
nonzero pose twist tau, at SH degrees 0-3, anisotropic and isotropic.

Tolerances. In float64 both sides evaluate the same derivative to
float64 rounding: each group within 1e-9 of its largest entry (the
chains are ~100 operations long; their rounding and the cancellations of
the conic's determinant stay far under it, and any wrong or missing term
is of the group's own size). In float32 autograd sums some terms in
another order (the einsums and matmuls of the covariances, torch's
reductions): each group within 1e-4 of its largest entry, and the pose
twist, a sum over every Gaussian, within 1e-4 of its largest component
(measured: at most 8.1e-6, in scaling and rotation at ``low_pass`` 0;
float32's unit roundoff is 6e-8; the conic's ``1 / det`` and the
perspective divide amplify the rounding of nearly degenerate splats,
which the random scenes contain). An isotropic splat's rotation
gradient is zero, rounded: it is held to the scaling group's size.

The CUDA kernels run only on the card: tests/test_torch_preprocess_cuda.py
(``cuda`` marker) holds them against these plain versions there."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import preprocess_fused as pf
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_ref
from gs_slam_analytica_jacobian_tpu_torch.slam import render_api
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

torch.set_num_threads(1)

W, H = 96, 64


def _camera(dtype=torch.float32):
    rng = np.random.default_rng(3)
    R = np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    return Camera(R=torch.tensor(R, dtype=dtype),
                  t=torch.tensor([0.05, -0.03, 0.1], dtype=dtype),
                  fx=80.0, fy=78.0, cx=47.5, cy=31.5, width=W, height=H)


def _scene(sh_degree, iso, dtype=torch.float32, seed=0):
    """Raw parameters (PREP_PARAMS order) of a scene in front of
    ``_camera`` with every edge case named in the module docstring; the
    last rows are the zero covariances."""
    rng = np.random.default_rng(seed + 10 * sh_degree + int(iso))
    cam = _camera(torch.float64)
    n = 160
    z = rng.uniform(0.5, 4.0, n)
    p_cam = np.stack([rng.uniform(-0.6, 0.6, n) * z,
                      rng.uniform(-0.5, 0.5, n) * z, z], -1)
    p_cam[:12, 0] = np.linspace(2.0, 3.5, 12) * p_cam[:12, 2]   # clamped x
    p_cam[12:24, 1] = -np.linspace(1.8, 3.0, 12) * p_cam[12:24, 2]
    p_cam[24:32, 2] = np.linspace(-1.0, 0.19, 8)                 # near plane
    R, t = cam.R.numpy(), cam.t.numpy()
    xyz = (p_cam - t) @ R                                         # world
    scaling = rng.uniform(-4.0, -1.5, (n, 1 if iso else 3))
    scaling[-6:] = -400.0                      # exp underflows: Sigma = 0
    rotation = rng.normal(size=(n, 4))
    opacity = rng.uniform(-3.0, 3.0, (n, 1))
    opacity[32:40] = -8.0                                        # < 1/255
    k = (sh_degree + 1) ** 2
    feats = rng.normal(scale=0.6, size=(n, k, 3))
    feats[40:52, 0] = -4.0                                      # clamped
    rest = np.zeros((n, 15, 3))
    rest[:, :k - 1] = feats[:, 1:]
    arrays = [xyz, scaling, rotation, opacity, feats[:, :1], rest]
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _grads_autograd(params, sh_degree, cam, tau, m2o, g_table, sm, lp):
    leaves = [p.clone().requires_grad_() for p in params]
    tau_l = tau.clone().requires_grad_()
    m2o_l = m2o.clone().requires_grad_()
    table, _ = pf.preprocess_plain(leaves, sh_degree, cam, tau_l, m2o_l,
                                   scale_modifier=sm, low_pass=lp)
    torch.sum(table * g_table).backward()
    out = {f: x.grad for f, x in zip(pf.PREP_PARAMS, leaves)}
    out.update(mean2d_offset=m2o_l.grad, tau=tau_l.grad)
    return out


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("sh_degree,iso,low_pass",
                         [(0, False, 0.3), (1, False, 0.0), (2, True, 0.3),
                          (3, False, 0.0), (3, True, 0.3)])
def test_plain_backward_matches_autograd(sh_degree, iso, low_pass, dtype,
                                         rtol):
    params = _scene(sh_degree, iso, dtype)
    cam = _camera(dtype)
    n = params[0].shape[0]
    rng = np.random.default_rng(100 + sh_degree)
    tau = torch.tensor([0.02, -0.01, 0.03, 0.015, -0.02, 0.01], dtype=dtype)
    m2o = torch.tensor(rng.normal(scale=0.5, size=(n, 2)), dtype=dtype)
    g_table = torch.tensor(rng.normal(size=(n, 16)), dtype=dtype)
    sm = 0.7

    # the scene reaches the branches it is meant to
    table, prep = pf.preprocess_plain(params, sh_degree, cam, tau, m2o,
                                      scale_modifier=sm, low_pass=low_pass)
    assert not bool(prep.valid[24:32].any())
    assert bool((prep.depth[24:32] < 0).any())
    if low_pass == 0.0:
        det = prep.cov2d[:, 0] * prep.cov2d[:, 2] - prep.cov2d[:, 1] ** 2
        assert bool((det[-6:] == 0).all())
    assert bool((prep.color[40:52] == 0).any())
    assert bool((prep.tiles_touched[32:40] == 0).all())

    want = _grads_autograd(params, sh_degree, cam, tau, m2o, g_table, sm,
                           low_pass)
    got = pf.preprocess_bwd_plain(params, sh_degree, cam, tau, g_table,
                                  scale_modifier=sm, low_pass=low_pass)
    for name in (*pf.PREP_PARAMS, "mean2d_offset", "tau"):
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        if name == "rotation" and iso:
            # Sigma = s^2 I does not depend on the rotation of an isotropic
            # splat: both sides round a zero sum of terms of the scaling
            # gradient's size
            scale = max(scale, float(want["scaling"].abs().max()))
        if name == "features_rest" and sh_degree == 0:
            assert float(a.abs().max()) == 0.0 == scale
            continue
        assert scale > 0, name
        err = float((a - b).abs().max())
        assert err <= rtol * scale, (name, err, scale)


def test_plain_backward_without_tau():
    """No pose twist: no tau gradient, the rest as with a zero twist."""
    params = _scene(1, False)
    cam = _camera()
    g_table = torch.tensor(np.random.default_rng(7).normal(size=(160, 16)),
                           dtype=torch.float32)
    got = pf.preprocess_bwd_plain(params, 1, cam, None, g_table)
    ref = pf.preprocess_bwd_plain(params, 1, cam, torch.zeros(6), g_table)
    assert got["tau"] is None
    for name in pf.PREP_PARAMS:
        assert torch.equal(got[name], ref[name]), name


def _map(n=300, seed=1):
    from gs_slam_analytica_jacobian_tpu_torch.scenes import make_room_map
    return gmap.from_numpy(**make_room_map(n, np.random.default_rng(seed)),
                           max_sh_degree=0, device="cpu")


def test_cpu_and_oracle_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain version through every entry of
    render_api (renders with and without grad, plan builds), and the dense
    oracle keeps gaussian_math.preprocess: the kernel wrappers are never
    called and count nothing (``launch.preprocess_fwd`` and
    ``launch.preprocess_bwd`` in the trace snapshot stay)."""
    def refuse(*a, **k):
        raise AssertionError("a CPU path reached the kernel wrapper")

    monkeypatch.setattr(pf, "preprocess_fwd", refuse)
    monkeypatch.setattr(pf, "preprocess_bwd", refuse)
    kernels = ("launch.preprocess_fwd", "launch.preprocess_bwd")
    before = [trace.snapshot()[k] for k in kernels]
    gm = _map()
    cam = Camera.create(np.eye(3), np.array([0.05, -0.02, 0.1]), 40.0, 40.0,
                        31.5, 23.5, 64, 48, device="cpu")
    params = {f: getattr(gm, f).detach().requires_grad_()
              for f in gmap.PARAM_FIELDS}
    gmp = gm.replace(**params)
    plan = render_api.make_render_plan(gmp, cam, pair_capacity=1 << 14,
                                       device="cpu")
    for oracle in (False, True):
        out = render_api.render(gmp, cam, pair_capacity=1 << 14,
                                plan=None if oracle else plan,
                                use_oracle=oracle, device="cpu")
        out.color.sum().backward()
    with torch.no_grad():
        render_api.render(gm, cam, pair_capacity=1 << 14, device="cpu")
    calls = []
    monkeypatch.setattr(renderer_ref, "preprocess",
                        lambda *a, **k: calls.append(1) or refuse())
    with pytest.raises(AssertionError, match="CPU path"):
        render_api.render(gm, cam, use_oracle=True, device="cpu")
    assert calls == [1]
    assert [trace.snapshot()[k] for k in kernels] == before


def test_cpu_render_is_the_plain_path():
    """On CPU tensors render_api.render gives what renderer_tiled.render
    gives from the map's activations (the path before the fused entry)."""
    from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled
    gm = _map()
    cam = Camera.create(np.eye(3), np.array([0.05, -0.02, 0.1]), 40.0, 40.0,
                        31.5, 23.5, 64, 48, device="cpu")
    got = render_api.render(gm, cam, pair_capacity=1 << 14, device="cpu")
    ref = renderer_tiled.render(
        gm.xyz, gm.get_cov6(), gm.get_opacity(), gm.get_features(),
        gm.active_sh_degree, cam.w2c(), cam.projection(), torch.zeros(6),
        cam.fx, cam.fy, cam.width, cam.height, cam.tanfovx, cam.tanfovy,
        torch.zeros(3), active=gm.active, pair_capacity=1 << 14,
        device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _wrapper_args():
    params = _scene(0, False)
    return params, _camera()


@pytest.mark.parametrize("fault", ["device", "dtype", "contiguity", "shape",
                                   "active_dtype", "degree"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    params, cam = _wrapper_args()
    kw = {}
    if fault == "dtype":
        params[0] = params[0].double()
    elif fault == "contiguity":
        params[2] = params[2].t().contiguous().t()
    elif fault == "shape":
        params[3] = params[3][:, 0]
    elif fault == "active_dtype":
        kw["active"] = torch.ones(params[0].shape[0], dtype=torch.uint8)
    elif fault == "degree":
        kw["sh_degree"] = 4
    match = {"device": "CUDA tensors", "dtype": "float32",
             "contiguity": "contiguous", "shape": "opacity",
             "active_dtype": "active", "degree": "features_rest|SH degree"}
    args = dict(sh_degree=0, cam=cam)
    args.update({k: v for k, v in kw.items() if k == "sh_degree"})
    # process-wide counters: other tests in the session may have launched
    before = (pf.preprocess_fwd.launches, pf.preprocess_bwd.launches)
    with pytest.raises(ValueError, match=match[fault]):
        pf.preprocess_fwd(params, active=kw.get("active"), **args)
    with pytest.raises(ValueError, match=match[fault] if fault not in (
            "active_dtype",) else "CUDA tensors"):
        pf.preprocess_bwd(params, args["sh_degree"], cam, None,
                          torch.zeros(params[0].shape[0], 16))
    assert (pf.preprocess_fwd.launches,
            pf.preprocess_bwd.launches) == before


def test_views_share_the_table():
    """The Preprocessed fields the fused path hands on are views of the
    kernel's outputs, in pack_table's columns."""
    n = 5
    out = pf.FusedOut(table=torch.arange(16.0 * n).reshape(n, 16),
                      aux=torch.arange(8.0 * n).reshape(n, 8),
                      rect=torch.arange(4 * n, dtype=torch.int32).reshape(n, 4),
                      tiles=torch.arange(n, dtype=torch.int32),
                      valid=torch.ones(n, dtype=torch.bool))
    prep = pf._views(out)
    assert torch.equal(prep.mean2d, out.table[:, 0:2])
    assert torch.equal(prep.conic, out.table[:, 2:5])
    assert torch.equal(prep.opacity, out.table[:, 5])
    assert torch.equal(prep.color, out.table[:, 6:9])
    assert torch.equal(prep.depth, out.table[:, 9])
    assert torch.equal(prep.radius, out.aux[:, 0])
    assert torch.equal(prep.radius_xy, out.aux[:, 1:3])
    assert torch.equal(prep.cov2d, out.aux[:, 3:6])
    assert torch.equal(prep.rect_min, out.rect[:, :2])
    assert torch.equal(prep.rect_max, out.rect[:, 2:])
    assert prep.mean2d.data_ptr() == out.table.data_ptr()

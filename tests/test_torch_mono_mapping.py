"""The port's monocular mapping against the benchmark's plain reference
(``benchmark/reference/mapping_mono.py``), and the frontend's monocular
seeding depth against the method body it was moved out of.

On the CPU at 64x48 with a seeded random room map: one monocular window
iteration's gradients (worked out from the Adam moments before and after
it, as the benchmark's check does) and its Adam step must agree with the
reference's. Both sides compute in float32 and sum in other orders (the
reference composites pair blocks with cumulative products and adds its
pixel chunks one by one), so a gradient group is held to a relative gap
of 1e-4, as the RGB-D reference test holds one frame's; the Adam step,
which both sides take from the same gradient, to 1e-5.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import mapping_mono as rmono
from benchmark.reference import render as rr
from benchmark.reference import scene as rscene
from benchmark.reference import trajectory as rtraj
from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as gmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.slam import frontend as tfe
from gs_slam_analytica_jacobian_tpu_torch.slam import mapping
from gs_slam_analytica_jacobian_tpu_torch.utils import trace

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 64, 48
FX = FY = 40.0
CX, CY = 31.5, 23.5
N, CAP = 3000, 4096
GRAD_TOL, ADAM_TOL = 1e-4, 1e-5


def _pose(i):
    """Keyframe i of a short sideways sweep: (R, t) world to camera."""
    th = 0.02 * i
    R = torch.tensor([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                      [-np.sin(th), 0.0, np.cos(th)]], dtype=torch.float32)
    return R, torch.tensor([0.03 * i, -0.01 * i, 0.02], dtype=torch.float32)


@pytest.fixture(scope="module")
def window():
    """A map, Adam state and store of four keyframes (no sensor depth),
    stored 1 mm / a few mrad off the poses their images were rendered at,
    with non-zero exposures and Adam moments."""
    g = torch.Generator().manual_seed(7)
    sc = rscene.room_map(N, 4, CPU)
    gm = gmap.GaussianMap.empty(CAP, 0, device=CPU)
    gm = gm.replace(**{f: torch.cat([sc[f], getattr(gm, f)[N:]])
                       for f in rmono.FIELDS + ("active",)})
    adam = gmap.adam_init(gm)
    adam = dataclasses.replace(
        adam, step=torch.tensor(4, dtype=torch.int32),
        m={f: 1e-3 * torch.randn(v.shape, generator=g)
           for f, v in adam.m.items()},
        v={f: 1e-6 * torch.rand(v.shape, generator=g)
           for f, v in adam.v.items()})
    rcam = rr.Cam(R=torch.eye(3), t=torch.zeros(3), fx=FX, fy=FY, cx=CX,
                  cy=CY, width=W, height=H)
    store = mapping.KFStore.empty(4, H, W, device=CPU)
    for i in range(4):
        R, t = _pose(i)
        img = rr.render(sc, rcam.at(R, t), torch.zeros(3))["color"]
        img = torch.clamp(img, 0.0, 1.0)
        R_s = torch.tensor(rtraj.so3_exp_np(np.array([2e-3, -1e-3, 1e-3])),
                           dtype=torch.float32) @ R
        store = store.add(i, R_s, t + 1e-3, torch.tensor(0.02 * i),
                          torch.tensor(-0.01 * i), img,
                          torch.zeros(1, H, W), i)
    cam = Camera.create(np.eye(3), np.zeros(3), FX, FY, CX, CY, W, H,
                        device=CPU)
    return gm, adam, store, rcam, cam


def test_mono_iteration_matches_the_reference(window):
    gm, adam, store, rcam, cam = window
    # window slots 0-2 and one of the two random slots
    idx = np.array([[2, 1, 0, 3, 0]])
    valid = np.array([True, True, True, True, False])
    opt_pose = np.array([True, True, False, False, False])
    opt_exp = np.array([True, True, False, False, False])
    lrs = gmap.default_lrs(dict(position_lr_init=0.0016, feature_lr=0.0025,
                                opacity_lr=0.05, scaling_lr=0.001,
                                rotation_lr=0.001), 5.0, device=CPU)
    pose_adam = mapping.PoseAdamState.zero(5, device=CPU)
    out = mapping.mapping_steps(
        gm, adam, store, idx, valid, opt_pose, opt_exp, pose_adam, cam,
        torch.zeros(3), lrs, [0.008], 0.0015, 0.0005, 0.01, n_window=3,
        monocular=True, pair_capacity=1 << 15, need_n_touched=False)

    js = [0, 1, 2, 3]
    vs = [(store.R[s], store.t[s], store.exposure_a[s], store.exposure_b[s],
           store.image(s)) for s in idx[0, js]]
    params = {f: getattr(gm, f) for f in rmono.FIELDS}
    g_ref, per_view, _ = rmono.window_grads(params, gm.active, vs, rcam,
                                            0.01)
    g_prog = {f: (out.gm_adam.m[f] - 0.9 * adam.m[f]) / 0.1
              for f in rmono.FIELDS}
    for f in rmono.FIELDS:
        gap = float(torch.linalg.norm(g_prog[f] - g_ref[f])
                    / torch.linalg.norm(g_ref[f]))
        assert gap < GRAD_TOL, (f, gap)
    g8 = (out.pose_adam.m - pose_adam.m * 0.9) / 0.1
    tau_ref = torch.stack([p[0] for p in per_view])
    exp_ref = torch.stack([torch.stack([p[1], p[2]]) for p in per_view])
    for got, ref in ((g8[js, :6], tau_ref), (g8[js, 6:], exp_ref)):
        gap = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        assert gap < GRAD_TOL, gap

    lrs = dict(lrs, xyz=torch.tensor(0.008))
    for f in rmono.FIELDS:
        new_ref = rmono.adam_step(params[f], g_prog[f], adam.m[f],
                                  adam.v[f], int(out.gm_adam.step), lrs[f])
        step_got = getattr(out.gm, f) - params[f]
        step_ref = new_ref - params[f]
        gap = float(torch.linalg.norm(step_got - step_ref)
                    / torch.linalg.norm(step_ref))
        assert gap < ADAM_TOL, (f, gap)


def _before_the_move(gt_image, depth, opacity, rgb_boundary_threshold, rng):
    """``FrontEnd.add_new_keyframe``'s monocular branch as it read before
    ``mono_initial_depth`` took it over."""
    gt_img = gt_image.cpu().numpy()
    valid_rgb = gt_img.sum(axis=0) > rgb_boundary_threshold
    if depth is None:
        initial = 2 * np.ones(gt_img.shape[1:], np.float32)
        initial += (rng.standard_normal(initial.shape)
                    .astype(np.float32) * 0.3)
    else:
        depth = depth.cpu().numpy()[0]
        opac = opacity.cpu().numpy()[0]
        valid = (depth > 0) & (opac > 0.95) & valid_rgb
        vals = depth[valid]
        if vals.size == 0:
            med, std = 2.0, 0.5
        else:
            med, std = float(np.median(vals)), float(np.std(vals))
        invalid = (depth > med + std) | (depth < med - std) | ~valid
        depth = np.where(invalid, med, depth)
        noise_scale = np.where(invalid, std * 0.5, std * 0.2)
        initial = depth + (rng.standard_normal(depth.shape)
                           .astype(np.float32) * noise_scale)
    initial[~valid_rgb] = 0
    return initial.astype(np.float32)


def _handover_inputs(case):
    g = torch.Generator().manual_seed(3)
    img = torch.rand(3, H, W, generator=g)
    img[:, :5] = 0.0                                   # black rows
    if case == "first":
        return img, None, None
    depth = 1.0 + 2.0 * torch.rand(1, H, W, generator=g)
    depth[:, :, :7] = 0.0                              # nothing rendered
    opac = torch.rand(1, H, W, generator=g)
    if case == "empty":
        opac = 0.5 * opac                              # no valid pixel
    return img, depth, opac


@pytest.mark.parametrize("case", ["first", "rendered", "empty"])
def test_mono_initial_depth_draw_for_draw(case):
    """The moved function, and the frontend's method that now calls it,
    give what the method gave: the same values from the same generator
    state, and leave the generator where it left it."""
    img, depth, opac = _handover_inputs(case)
    want_rng = np.random.default_rng(11)
    want = _before_the_move(img, depth, opac, 0.01, want_rng)
    want_next = want_rng.standard_normal()

    rng = np.random.default_rng(11)
    got = tfe.mono_initial_depth(img, depth, opac, 0.01, rng)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert rng.standard_normal() == want_next

    fe = SimpleNamespace(frames={5: SimpleNamespace(gt_image=img)},
                         kf_indices=[], monocular=True,
                         rgb_boundary_threshold=0.01,
                         _rng=np.random.default_rng(11))
    got = tfe.FrontEnd.add_new_keyframe(fe, 5, depth=depth, opacity=opac,
                                        init=case == "first")
    np.testing.assert_array_equal(got, want)
    assert fe.kf_indices == [5]


def test_mono_initial_depth_span_keeps_host_statistics():
    img, depth, opac = _handover_inputs("rendered")
    trace.drain()
    trace.enable(True)
    try:
        tfe.mono_initial_depth(img, depth, opac, 0.01,
                               np.random.default_rng(0), frame_idx=9)
    finally:
        trace.enable(False)
    spans = [s for s in trace.drain() if s["name"] == "frontend.mono_depth"]
    assert len(spans) == 1
    a = spans[0]["attrs"]
    d, o = depth[0].numpy(), opac[0].numpy()
    valid = (d > 0) & (o > 0.95) & (img.numpy().sum(axis=0) > 0.01)
    assert a["frame_idx"] == 9 and a["n_valid"] == int(valid.sum())
    assert a["median"] == float(np.median(d[valid]))
    assert a["std"] == float(np.std(d[valid]))

"""The benchmark's checks on the CPU at a size a test run holds: the
reference agrees with the program, the control comes out not correct,
and a run with its timed path broken underneath (a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced) comes out not correct. The limits here are set from this
size's own sound run (three times its reading): the cells' limits are
for their full sizes."""


import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.loops import map as map_loop
from benchmark.reference import mapping as rmap
from benchmark.reference import render as rr
from benchmark.reference import scene as rscene

torch.set_num_threads(1)
CPU = torch.device("cpu")


def tiny_map(config, traffic, cell):
    config["camera"] = dict(width=64, height=48, fx=40.0, fy=40.0, cx=31.5,
                            cy=23.5)
    config["world"] = dict(gaussians=3000, seed=0)
    config["Training"].update(init_itr_num=3, window_size=3,
                              mapping_itr_num=3, pair_capacity=1 << 15,
                              initial_capacity=4096)
    traffic.update(frames_in_loop=8)


CELLS = {"tum-map": tiny_map}


@pytest.fixture(autouse=True, scope="module")
def tiny_samples():
    """One checked iteration and a short trace at the test size."""
    mp = pytest.MonkeyPatch()
    mp.setattr(map_loop, "CHECK_ITERS", 1)
    mp.setattr(map_loop, "CHECK_RANGE", (1, 2))
    mp.setattr(map_loop, "TRACE_KF", 1)
    mp.setattr(map_loop, "TRACE_ITERS", 3)
    yield
    mp.undo()


@pytest.fixture(scope="module", params=sorted(CELLS))
def sound(request, tiny_samples):
    """The cell's sound readings at the test size, beside its control's."""
    name = request.param
    (_, run), = control.readings(name, [2 ** 31 + 5], 0.1, CPU,
                                 overrides=CELLS[name])
    return name, {c.name: c.value for c in run.checks}


def test_control_is_not_correct(sound):
    name, vals = sound
    controls = [k for k in vals if k.endswith(".control")]
    assert controls
    for k in controls:
        base = vals[k.removesuffix(".control")]
        assert vals[k] > 3.0 * base + 1e-12, (name, k, vals[k], base)


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_is_not_correct(sound, fault):
    name, vals = sound
    limits = {k: 3.0 * v + 1e-9 for k, v in vals.items()
              if not k.endswith(".control")}

    def shrink(config, traffic, cell):
        CELLS[name](config, traffic, cell)
        cell["limits"] = dict(cell["limits"], **limits)
    (_, run), = control.readings(name, [2 ** 31 + 5], 0.1, CPU, fault=fault,
                                 overrides=shrink)
    checks = [c for c in run.checks if not c.name.endswith(".control")]
    assert checks and not all(c.ok for c in checks), (
        name, fault, [(c.name, c.value, c.limit) for c in checks])


def test_reference_render_matches_the_program():
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.models.gaussian_map import \
        GaussianMap
    from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render
    W, H = 96, 64
    sc = rscene.room_map(6000, 3, CPU)
    gm = GaussianMap.empty(6000, 0, device=CPU).replace(
        **{k: sc[k] for k in rmap.FIELDS + ("active",)})
    R = torch.eye(3)
    t = torch.tensor([0.01, -0.02, 0.03])
    cam = Camera.create(np.eye(3), np.zeros(3), 48.0, 48.0, 47.5, 31.5, W,
                        H, device=CPU).replace(R=R, t=t)
    bg = torch.zeros(3)
    out = render(gm, cam, None, bg, pair_capacity=1 << 16, device=CPU)
    ref = rr.render(sc, rr.Cam(R=R, t=t, fx=48.0, fy=48.0, cx=47.5,
                               cy=31.5, width=W, height=H), bg)
    assert float((out.color - ref["color"]).abs().max()) < 1e-5
    assert float((out.depth - ref["depth"]).abs().max()) < 1e-4
    assert float((out.opacity - ref["opacity"]).abs().max()) < 1e-5


def test_reference_gradient_matches_the_program():
    """One frame's mapping-loss gradient, the reference's against autograd
    through the program's renderer."""
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import (
        Camera, PoseState)
    from gs_slam_analytica_jacobian_tpu_torch.models.gaussian_map import \
        GaussianMap
    from gs_slam_analytica_jacobian_tpu_torch.ops import losses
    from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render
    W, H = 64, 48
    sc = rscene.room_map(3000, 4, CPU)
    R, t = torch.eye(3), torch.tensor([0.0, 0.01, 0.02])
    rc = rr.Cam(R=R, t=t, fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=W,
                height=H)
    gt = rr.render(sc, rc.at(R, t + 0.003), torch.zeros(3))
    img, depth = rmap.quantized(gt["color"].clamp(0, 1), gt["depth"])
    ea, eb = torch.tensor(0.01), torch.tensor(-0.02)
    g_ref, per_view, loss = rmap.window_grads(
        {f: sc[f] for f in rmap.FIELDS}, sc["active"],
        [(R, t, ea, eb, img, depth)], rc, 0.95, 0.01)

    params = {f: sc[f].clone().requires_grad_() for f in rmap.FIELDS}
    gm = GaussianMap.empty(3000, 0, device=CPU).replace(
        active=sc["active"], **params)
    cam = Camera.create(np.eye(3), np.zeros(3), 40.0, 40.0, 31.5, 23.5, W,
                        H, device=CPU).replace(R=R, t=t)
    tau = torch.zeros(6, requires_grad=True)
    a, b = ea.clone().requires_grad_(), eb.clone().requires_grad_()
    out = render(gm, cam, PoseState(tau=tau, exposure_a=a, exposure_b=b),
                 torch.zeros(3), pair_capacity=1 << 15,
                 need_n_touched=False, device=CPU)
    L = losses.loss_mapping_rgbd(losses.apply_exposure(out.color, a, b),
                                 out.depth, img, depth, 0.01, 0.95)
    L = L + 10.0 * losses.isotropic_loss(params["scaling"], sc["active"])
    L.backward()
    assert abs(L.item() - loss.item()) < 1e-5 * L.item()
    for f in rmap.FIELDS:
        gap = float(torch.linalg.norm(params[f].grad - g_ref[f])
                    / torch.linalg.norm(g_ref[f]))
        assert gap < 1e-4, (f, gap)
    assert float((tau.grad - per_view[0][0]).abs().max()
                 / tau.grad.abs().max()) < 1e-4


@pytest.mark.cuda
def test_reference_render_matches_the_program_on_the_card():
    """The same on the card, at Replica's 1200x680 and the 200k room."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
    from gs_slam_analytica_jacobian_tpu_torch.models.gaussian_map import \
        GaussianMap
    from gs_slam_analytica_jacobian_tpu_torch.slam.render_api import render
    dev = torch.device("cuda")
    W, H = 1200, 680
    sc = rscene.room_map(200_000, 0, dev)
    gm = GaussianMap.empty(200_000, 0, device=dev).replace(
        **{k: sc[k] for k in rmap.FIELDS + ("active",)})
    R = torch.eye(3, device=dev)
    t = torch.tensor([0.01, -0.02, 0.03], device=dev)
    cam = Camera.create(np.eye(3), np.zeros(3), 600.0, 600.0, 599.5, 339.5,
                        W, H, device=dev).replace(R=R, t=t)
    bg = torch.zeros(3, device=dev)
    out = render(gm, cam, None, bg, device=dev)
    ref = rr.render(sc, rr.Cam(R=R, t=t, fx=600.0, fy=600.0, cx=599.5,
                               cy=339.5, width=W, height=H), bg)
    d = (out.color - ref["color"]).abs().flatten()
    assert float(torch.quantile(d[:1 << 24], 0.5)) < 1e-6

"""The bfloat16 compositing bodies of the port (B1-bf16, B1'-bf16, B2-bf16
plain versions, ``render(bf16=True)``, ``track_frame_pyr(kernel_bf16=
True)``) against the JAX package's ``bf16=True`` kernels in interpret
mode.

The JAX reference runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``. Under XLA's default the
CPU compiler keeps the kernel body's bfloat16 intermediates in f32 (it
drops convert pairs), so interpret mode does not round where the Pallas
source says it rounds; with the flag it rounds after every bfloat16
operation, as eager JAX, torch and the CUDA kernels (``__hmul_rn``) do.
Measured (40-Gaussian 160x64 scene of tests/test_renderer_tiled.py:128,
per-op rounding): port bf16 against JAX bf16 differs by 2.4e-7 in color
and 7.2e-7 in depth (max abs), n_touched equal, dL/dtau 1.2e-6 and
dL/dmeans 1.4e-6 relative (max over the max), while JAX bf16 against JAX
f32 differs by 6.5e-3, 2.0e-2, 24 n_touched entries, 7.0e-3 and 3.8e-3.
Each comparison is held at 1/4 of that bf16-vs-f32 gap (the control:
port bf16 against port f32 lies within 1/2 and 2x of the gap, so bf16 is
applied). Under XLA's default rounding (test_bf16_render_default_xla)
the port stands at 0.28-0.32 of the gap in color and depth and 0.20 in
dL/dtau, so that comparison is held at 0.4.

Tracker: track_frame_pyr(kernel_bf16=True) on the small room scene of
tests/test_torch_tracking.py (levels (2, 1), iterations (4, 6), the last
2 of the full-resolution level exact, so B1'-bf16 and B2-bf16 both run)
lands on the JAX tracker's pose within 1e-4 (R and t), iterations within
1. bf16 beside tile16 still raises (and so does mxu beside tile16); bf16
beside mxu runs the MXU forward (the reference's mxu_ctx takes precedence
over bf16 for the falloff), so its images equal mxu's alone, while the
backward keeps the bfloat16 products (held against JAX in
tests/test_torch_mxu.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch.models import gaussian_map as tgmap
from gs_slam_analytica_jacobian_tpu_torch.models.camera import Camera
from gs_slam_analytica_jacobian_tpu_torch.ops import renderer_tiled as trt
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as tk
from gs_slam_analytica_jacobian_tpu_torch.slam import tracking as ttr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GAP_FRAC = 0.25           # port vs JAX bf16, of the JAX bf16-vs-f32 gap
DEFAULT_XLA_FRAC = 0.4    # the same under XLA's default excess precision
W_T, H_T, CAP_T = 96, 64, 1 << 13
BG = np.array([0.05, 0.1, 0.15], np.float32)
TRACK_KW = dict(lr_rot=0.003, lr_trans=0.001, rgb_boundary_threshold=0.01,
                pair_capacity=CAP_T, levels=(2, 1), level_iters=(4, 6),
                level_exact=(0, 2), curv="flow", final_level=1)


# ---------------------------------------------------------------------------
# scenes (numpy, shared by both sides)
# ---------------------------------------------------------------------------

def render_scene():
    sys.path.insert(0, str(ROOT / "tests"))
    from test_renderer_ref import make_scene
    return make_scene(np.random.default_rng(0), n=40, W=160, H=64)


def track_scene_arrays():
    """tests/test_torch_tracking.py::scene's map (600 Gaussians, 96x64)."""
    rng = np.random.default_rng(3)
    n = 600
    return dict(
        xyz=np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(0.5, 4.0, n)], -1).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3,
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2.3,
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32) + 1.0)


TAU0 = np.array([0.015, -0.012, 0.015, 0.005, 0.007, -0.004], np.float32)


# ---------------------------------------------------------------------------
# the JAX side (run in a subprocess: python tests/test_torch_bf16.py OUT)
# ---------------------------------------------------------------------------

def _jax_reference(out_path):
    import jax
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.models import gaussian_map as jgmap
    from gs_slam_analytica_jacobian_tpu.models.camera import Camera as JCam
    from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
    from gs_slam_analytica_jacobian_tpu.ops import losses as jlosses
    from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt
    from gs_slam_analytica_jacobian_tpu.ops.lie import se3_exp
    from gs_slam_analytica_jacobian_tpu.slam import render_api as japi
    from gs_slam_analytica_jacobian_tpu.slam import tracking as jtr

    res = {}
    sc = render_scene()
    cov6 = jgm.build_cov3d(jnp.asarray(sc["scales"]),
                           jnp.asarray(sc["quats"]))
    rest = (sc["fx"], sc["fy"], sc["W"], sc["H"], sc["tanfovx"],
            sc["tanfovy"])

    def rend(bf16, tau, means, nt):
        return jrt.render(
            means, cov6, jnp.asarray(sc["opac"]), jnp.asarray(sc["shs"]), 3,
            jnp.asarray(sc["w2c"]), jnp.asarray(sc["proj"]), tau, *rest,
            jnp.asarray(BG), pair_capacity=8192, interpret=True, bf16=bf16,
            need_n_touched=nt)

    def loss(tau, means, bf16):
        o = rend(bf16, tau, means, False)
        return (jnp.mean(jnp.abs(o.color))
                + 0.1 * jnp.mean(jnp.abs(o.depth)))

    for b in (0, 1):
        for nt in (0, 1):
            o = rend(bool(b), jnp.zeros(6), jnp.asarray(sc["means"]),
                     bool(nt))
            res[f"color_{b}{nt}"] = np.asarray(o.color)
            res[f"depth_{b}{nt}"] = np.asarray(o.depth)
            res[f"nt_{b}{nt}"] = np.asarray(o.n_touched)
        g_tau, g_means = jax.grad(loss, argnums=(0, 1))(
            jnp.zeros(6), jnp.asarray(sc["means"]), bool(b))
        res[f"dtau_{b}"] = np.asarray(g_tau)
        res[f"dmeans_{b}"] = np.asarray(g_means)

    cam = JCam.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                      (H_T - 1) / 2, W_T, H_T)
    gm = jgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0)
    out = japi.render(gm, cam, None, jnp.zeros(3), pair_capacity=CAP_T,
                      interpret=True)
    gt_image = jnp.clip(out.color, 0, 1)
    mask = jlosses.compute_grad_mask(gt_image.mean(axis=0, keepdims=True),
                                     1.1, "replica")
    T0 = se3_exp(jnp.asarray(TAU0))
    for b in (0, 1):
        r = jtr.track_frame_pyr(
            gm, cam, T0[:3, :3], T0[:3, 3], gt_image, out.depth, mask,
            jnp.zeros(3), interpret=True, kernel_bf16=bool(b), **TRACK_KW)
        res[f"track_R_{b}"] = np.asarray(r[0])
        res[f"track_t_{b}"] = np.asarray(r[1])
        res[f"track_iters_{b}"] = np.asarray(r[4])
    res["gt_image"] = np.asarray(gt_image)
    res["gt_depth"] = np.asarray(out.depth)
    res["mask"] = np.asarray(mask)
    res["T0"] = np.asarray(T0)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16") / "jref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), path],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _port_render(sc, tau=None, means=None, **flags):
    from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
    cov6 = tgm.build_cov3d(torch.as_tensor(sc["scales"]),
                           torch.as_tensor(sc["quats"]))
    return trt.render(
        torch.as_tensor(sc["means"]) if means is None else means, cov6,
        torch.as_tensor(sc["opac"]), torch.as_tensor(sc["shs"]), 3,
        torch.as_tensor(sc["w2c"]), torch.as_tensor(sc["proj"]),
        torch.zeros(6) if tau is None else tau, sc["fx"], sc["fy"], sc["W"],
        sc["H"], sc["tanfovx"], sc["tanfovy"], torch.as_tensor(BG),
        pair_capacity=8192, device="cpu", **flags)


@pytest.fixture(scope="module")
def port():
    sc = render_scene()
    res = {}
    for b in (0, 1):
        for nt in (0, 1):
            o = _port_render(sc, bf16=bool(b), need_n_touched=bool(nt))
            res[f"color_{b}{nt}"] = o.color.numpy()
            res[f"depth_{b}{nt}"] = o.depth.numpy()
            res[f"nt_{b}{nt}"] = o.n_touched.numpy()
        tau = torch.zeros(6, requires_grad=True)
        means = torch.tensor(sc["means"], requires_grad=True)
        o = _port_render(sc, tau, means, bf16=bool(b), need_n_touched=False)
        L = torch.mean(torch.abs(o.color)) + 0.1 * torch.mean(
            torch.abs(o.depth))
        L.backward()
        res[f"dtau_{b}"] = tau.grad.numpy()
        res[f"dmeans_{b}"] = means.grad.numpy()
    return res


def _gap(a, b, rel):
    d = float(np.abs(a - b).max())
    return d / float(np.abs(b).max()) if rel else d


@pytest.mark.parametrize("nt", [0, 1])
def test_bf16_render_matches_jax(jref, port, nt):
    """B1-bf16 (with n_touched) and B1'-bf16 (without): color, depth and
    n_touched of the port's bf16 render against JAX's, at most 1/4 of the
    JAX bf16-vs-f32 gap; port bf16 against port f32 within [1/2, 2] of
    it."""
    for key in ("color", "depth"):
        gap = _gap(jref[f"{key}_1{nt}"], jref[f"{key}_0{nt}"], False)
        assert gap > 1e-3, (key, gap)
        err = _gap(port[f"{key}_1{nt}"], jref[f"{key}_1{nt}"], False)
        assert err <= GAP_FRAC * gap, (key, err, gap)
        ctrl = _gap(port[f"{key}_1{nt}"], port[f"{key}_0{nt}"], False)
        assert 0.5 * gap <= ctrl <= 2.0 * gap, (key, ctrl, gap)
    if nt:
        gap_nt = int((jref["nt_11"] != jref["nt_01"]).sum())
        assert gap_nt > 0
        assert int((port["nt_11"] != jref["nt_11"]).sum()) <= \
            GAP_FRAC * gap_nt
        assert int(port["nt_11"].sum()) > 0


def test_bf16_gradients_match_jax(jref, port):
    """B2-bf16 through the render's autograd: dL/dtau and dL/dmeans,
    relative to their max, at most 1/4 of the JAX bf16-vs-f32 gap; the
    control as for the render."""
    for key in ("dtau", "dmeans"):
        gap = _gap(jref[f"{key}_1"], jref[f"{key}_0"], True)
        assert gap > 1e-3, (key, gap)
        err = _gap(port[f"{key}_1"], jref[f"{key}_1"], True)
        assert err <= GAP_FRAC * gap, (key, err, gap)
        ctrl = _gap(port[f"{key}_1"], port[f"{key}_0"], True)
        assert 0.5 * gap <= ctrl <= 2.0 * gap, (key, ctrl, gap)


def test_bf16_render_default_xla(port):
    """The same render against JAX's interpret mode under XLA's default
    rounding (this process's flags): XLA keeps the bfloat16 intermediates
    in f32, so the two differ at 0.28-0.32 of the bf16-vs-f32 gap in
    color and depth and 0.20 in dL/dtau (measured); held at 0.4."""
    import jax
    import jax.numpy as jnp

    from gs_slam_analytica_jacobian_tpu.ops import gaussian_math as jgm
    from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt

    sc = render_scene()
    cov6 = jgm.build_cov3d(jnp.asarray(sc["scales"]),
                           jnp.asarray(sc["quats"]))

    def rend(bf16, tau):
        return jrt.render(
            jnp.asarray(sc["means"]), cov6, jnp.asarray(sc["opac"]),
            jnp.asarray(sc["shs"]), 3, jnp.asarray(sc["w2c"]),
            jnp.asarray(sc["proj"]), tau, sc["fx"], sc["fy"], sc["W"],
            sc["H"], sc["tanfovx"], sc["tanfovy"], jnp.asarray(BG),
            pair_capacity=8192, interpret=True, bf16=bf16,
            need_n_touched=False)

    for key in ("color", "depth"):
        jb = np.asarray(getattr(rend(True, jnp.zeros(6)), key))
        jf = np.asarray(getattr(rend(False, jnp.zeros(6)), key))
        gap = _gap(jb, jf, False)
        err = _gap(port[f"{key}_10"], jb, False)
        assert err <= DEFAULT_XLA_FRAC * gap, (key, err, gap)

    def loss(tau, bf16):
        o = rend(bf16, tau)
        return (jnp.mean(jnp.abs(o.color))
                + 0.1 * jnp.mean(jnp.abs(o.depth)))

    gb = np.asarray(jax.grad(loss)(jnp.zeros(6), True))
    gf = np.asarray(jax.grad(loss)(jnp.zeros(6), False))
    assert _gap(port["dtau_1"], gb, True) <= \
        DEFAULT_XLA_FRAC * _gap(gb, gf, True)


def test_bf16_plain_backward_rows(port):
    """composite32_bwd_plain(bf16=True) differs from the f32 rows only in
    the five quadratic-form columns and d_opa (through the bfloat16
    falloff); d_rgb and d_depth of a pair agree to bf16 precision."""
    sc = render_scene()
    from gs_slam_analytica_jacobian_tpu_torch.ops import gaussian_math as tgm
    from gs_slam_analytica_jacobian_tpu_torch.ops.pair_gather import \
        pair_gather
    cov6 = tgm.build_cov3d(torch.as_tensor(sc["scales"]),
                           torch.as_tensor(sc["quats"]))
    prep = tgm.preprocess(
        torch.as_tensor(sc["means"]), cov6, torch.as_tensor(sc["opac"]),
        torch.as_tensor(sc["shs"]), 3, torch.as_tensor(sc["w2c"]),
        torch.as_tensor(sc["proj"]), torch.zeros(6), sc["fx"], sc["fy"],
        sc["W"], sc["H"], sc["tanfovx"], sc["tanfovy"])
    plan = trt.make_plan(prep, sc["W"], sc["H"], 8192)
    feat = pair_gather(trt.pack_table(prep), plan).detach().contiguous()
    n_tx, n_ty = tk.grid_dims(sc["W"], sc["H"])
    gen = torch.Generator().manual_seed(0)
    cot = torch.randn(5, sc["H"], sc["W"], generator=gen)
    rows = {}
    for b in (False, True):
        fwd = tk.composite32_fwd(feat, plan.ranges, n_tx, n_ty, sc["W"],
                                 sc["H"], bf16=b)
        rows[b] = tk.composite32_bwd(
            feat, plan.ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, sc["W"], sc["H"], bf16=b)
    assert torch.isfinite(rows[True]).all()
    assert not rows[True][:, tk.N_ROWS:].any()
    for c in range(tk.N_ROWS):
        scale = float(rows[False][:, c].abs().max())
        rel = float((rows[True][:, c] - rows[False][:, c]).abs().max()) / scale
        assert rel < 0.1, (c, rel)
    # bf16 is applied to the quadratic-form columns
    quad = (rows[True][:, :5] - rows[False][:, :5]).abs().max()
    assert float(quad) > 1e-4 * float(rows[False][:, :5].abs().max())


def test_track_frame_pyr_bf16_matches_jax(jref):
    """track_frame_pyr(kernel_bf16=True): B1'-bf16 in every IRLS render
    and B1-bf16 + B2-bf16 in the exact full-resolution iterations. The
    port lands on the JAX bf16 tracker's pose within 1e-4, iterations
    within 1; and near (5e-3) but not on the f32 tracker's pose."""
    cam = Camera.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                        (H_T - 1) / 2, W_T, H_T, device="cpu")
    gm = tgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0,
                          device="cpu")
    T0 = torch.as_tensor(jref["T0"])
    args = (gm, cam, T0[:3, :3], T0[:3, 3],
            torch.as_tensor(jref["gt_image"]),
            torch.as_tensor(jref["gt_depth"]), torch.as_tensor(jref["mask"]),
            torch.zeros(3))
    counts = (tk.composite32_fwd.launches_bf16,)
    res = ttr.track_frame_pyr(*args, kernel_bf16=True, device="cpu",
                              **TRACK_KW)
    assert counts == (tk.composite32_fwd.launches_bf16,)  # CPU: no launch
    np.testing.assert_allclose(res[0].numpy(), jref["track_R_1"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(res[1].numpy(), jref["track_t_1"], atol=1e-4,
                               rtol=0)
    assert abs(int(res[4]) - int(jref["track_iters_1"])) <= 1
    assert np.linalg.norm(res[1].numpy()) < 5e-3       # it tracked
    assert np.abs(res[1].numpy() - jref["track_t_0"]).max() < 5e-3


@pytest.mark.parametrize("flags", [dict(tile16=True, bf16=True),
                                   dict(tile16=True, mxu=True),
                                   dict(tile16=True, bf16=True, mxu=True)])
def test_render_flags_that_still_raise(flags):
    with pytest.raises(NotImplementedError):
        _port_render(render_scene(), **flags)


def test_render_bf16_beside_mxu():
    """mxu, once raising, is ported: beside bf16 the forward runs the MXU
    body alone (images equal to render(mxu=True)), the backward the MXU
    falloff with the bfloat16 products (dL/dtau moves off mxu's)."""
    sc = render_scene()
    outs, grads = [], []
    for bf16 in (False, True):
        tau = torch.zeros(6, requires_grad=True)
        o = _port_render(sc, tau, mxu=True, bf16=bf16, need_n_touched=False)
        (g,) = torch.autograd.grad(o.color.abs().mean(), tau)
        outs.append(o)
        grads.append(g)
    assert torch.equal(outs[0].color, outs[1].color)
    assert torch.equal(outs[0].depth, outs[1].depth)
    assert float((grads[0] - grads[1]).abs().max()) > 0


@pytest.mark.parametrize("flags", [dict(kernel_bf16=True, tile16=True),
                                   dict(kernel_mxu=True, tile16=True)])
def test_tracker_flags_that_still_raise(flags):
    cam = Camera.create(np.eye(3), np.zeros(3), 60.0, 60.0, (W_T - 1) / 2,
                        (H_T - 1) / 2, W_T, H_T, device="cpu")
    gm = tgmap.from_numpy(**track_scene_arrays(), max_sh_degree=0,
                          device="cpu")
    z = torch.zeros(1, H_T, W_T)
    with pytest.raises(NotImplementedError):
        ttr.track_frame_pyr(gm, cam, cam.R, cam.t, torch.zeros(3, H_T, W_T),
                            z, z, torch.zeros(3), device="cpu",
                            **dict(TRACK_KW, **flags))


if __name__ == "__main__":
    _jax_reference(sys.argv[1])

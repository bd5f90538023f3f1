"""Entry points of the port (the counterparts of the repository's
``__graft_entry__.py``): ``entry()``, the flagship forward render, and
``dryrun_multichip(n)``, a dry run of the multi-rank paths.

    python -m gs_slam_analytica_jacobian_tpu_torch.graft_entry \\
        [multichip N] [--device cpu]

Both run on the GPU unless ``--device`` (``device=``) names another
device; without a GPU and without ``--device cpu`` they raise.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

ENTRY_SIZE = (1200, 680)
ENTRY_FOCAL = 600.0
ENTRY_GAUSSIANS = 50_000
ENTRY_PAIR_CAP = 1 << 20


def entry(n: int = ENTRY_GAUSSIANS, width: int = ENTRY_SIZE[0],
          height: int = ENTRY_SIZE[1], focal: float = ENTRY_FOCAL,
          device=None):
    """(fn, example_args): the forward render of the flagship model, the
    tiled differentiable splat renderer, on ``scenes.make_cloud(n)`` at
    Replica resolution (1200x680, fx = fy = 600, pair capacity 2^20, zero
    tau and background). ``fn(*args)`` returns (color (3, H, W), depth
    (1, H, W), opacity (1, H, W))."""
    from .device import resolve_device
    from .ops import camera_math as cm
    from .ops import renderer_tiled
    from .ops.gaussian_math import build_cov3d
    from .scenes import make_cloud

    dev = resolve_device(device)
    W, H, fx = int(width), int(height), float(focal)
    fy = fx
    means, scales, quats, opac, shs = make_cloud(n, seed=0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    cov6 = build_cov3d(t(scales), t(quats))
    w2c = torch.eye(4, device=dev)
    proj = t(cm.projection_matrix(0.01, 100.0, (W - 1) / 2, (H - 1) / 2,
                                  fx, fy, W, H))
    tau = torch.zeros(6, device=dev)
    bg = torch.zeros(3, device=dev)

    def fn(means, cov6, opac, shs, w2c, proj, tau, bg):
        out = renderer_tiled.render(
            means, cov6, opac, shs, 0, w2c, proj, tau, fx, fy, W, H,
            W / (2 * fx), H / (2 * fy), bg, pair_capacity=ENTRY_PAIR_CAP,
            device=dev)
        return out.color, out.depth, out.opacity

    return fn, (t(means), cov6, t(opac), t(shs), w2c, proj, tau, bg)


# the dry run's shapes (the reference's): 64x32, 64 Gaussians, F = 2n
DRY_W, DRY_H, DRY_FOCAL, DRY_GAUSSIANS = 64, 32, 40.0, 64


def _dryrun_rank(n_ranks: int, device: str):
    """One rank of ``dryrun_multichip``: one sharded mapping step, the
    integrated ``mapping_steps`` on the mesh, then the depth-slab
    model-parallel loss and gradients, all on the tiled renderer. Prints
    the three lines and returns what they report (numbers and the launch
    counts of each part)."""
    from .models import gaussian_map as gmap
    from .models.camera import Camera
    from .ops import launches
    from .parallel import sharding, slab
    from .slam import mapping as mp
    from .slam.mapping import KFStore, PoseAdamState

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device.startswith("cuda") else torch.device(device)
    mesh = sharding.make_mesh(n_ranks, device=dev)
    W, H, n = DRY_W, DRY_H, DRY_GAUSSIANS
    fx = fy = DRY_FOCAL
    F = n_ranks * 2
    who = f"dryrun_multichip({n_ranks}) rank {mesh.rank}"
    rec = {"rank": mesh.rank}

    rng = np.random.default_rng(0)
    means = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    means[:, 2] = rng.uniform(1.0, 3.0, size=n)
    gm = gmap.from_numpy(
        xyz=means,
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.2,
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.full((n, 3), -2.5, np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.ones((n, 1), np.float32), max_sh_degree=0, device=dev)
    adam = gmap.adam_init(gm)
    cam = Camera.create(np.eye(3), np.zeros(3), fx, fy, (W - 1) / 2,
                        (H - 1) / 2, W, H, device=dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    frames_R = torch.eye(3, device=dev).repeat(F, 1, 1)
    frames_t = t(rng.normal(size=(F, 3)).astype(np.float32) * 0.05)
    gt_images = t(rng.uniform(size=(F, 3, H, W)).astype(np.float32))
    gt_depths = t(rng.uniform(1.0, 3.0, size=(F, 1, H, W)).astype(np.float32))
    bg = torch.zeros(3, device=dev)

    # 1. one sharded mapping step (sharding.sharded_mapping_step)
    launches.reset()
    lrs = {f: 0.001 for f in gmap.PARAM_FIELDS}
    new_gm, _, loss = sharding.sharded_mapping_step(
        mesh, gm, adam, frames_R, frames_t, gt_images, gt_depths,
        [True] * F, cam, bg, lrs, pair_capacity=1 << 14)
    loss = float(loss)
    delta = float(torch.max(torch.abs(new_gm.xyz - gm.xyz)))
    rec["step"] = dict(loss=loss, max_dxyz=delta, launches=launches.counts())
    if not math.isfinite(loss):
        raise RuntimeError(f"{who}: non-finite sharded mapping loss")
    if not delta > 0:
        raise RuntimeError(f"{who}: the sharded step did not move the map")
    print(f"{who}: loss={loss:.4f} max|dxyz|={delta:.2e} "
          f"mesh={mesh.size} ranks ({mesh.backend}, {mesh.device})",
          flush=True)

    # 2. the integrated path: mapping_steps on the mesh, as BackEnd runs it
    launches.reset()
    store = KFStore.empty(F + 2, H, W, device=dev)
    for i in range(F):
        store = store.add(i, torch.eye(3, device=dev), frames_t[i], 0.0, 0.0,
                          gt_images[i], gt_depths[i], i)
    T = 2
    sel = np.zeros(F, bool)
    sel[1] = True
    out = mp.mapping_steps(
        gm, adam, store, np.tile(np.arange(F, dtype=np.int32)[None], (T, 1)),
        np.ones(F, bool), sel, sel, PoseAdamState.zero(F, device=dev), cam,
        bg, {f: 1e-3 for f in gmap.PARAM_FIELDS}, [1e-3] * T, 1e-3, 1e-3,
        0.01, n_window=F - 2, pair_capacity=1 << 14, mesh=mesh)
    loss2 = float(out.loss)
    touched = int((out.n_touched > 0).sum())
    rec["integrated"] = dict(loss=loss2, n_touched_pos=touched,
                             launches=launches.counts())
    if not math.isfinite(loss2):
        raise RuntimeError(f"{who}: non-finite integrated loss")
    if not touched > 0:
        raise RuntimeError(f"{who}: the integrated run touched no Gaussian")
    print(f"{who} integrated mapping_steps: loss={loss2:.4f} "
          f"n_touched>0: {touched}", flush=True)

    # 3. the model-parallel path: the Gaussian axis in depth slabs
    launches.reset()
    loss3, grads = slab.slab_mapping_loss_and_grads(
        mesh, gm, cam, gt_images[0], gt_depths[0], bg, tiled=True)
    loss3 = float(loss3)
    gmax = float(torch.max(torch.abs(grads["xyz"])))
    rec["slab"] = dict(loss=loss3, max_dxyz_grad=gmax,
                       launches=launches.counts())
    if not math.isfinite(loss3):
        raise RuntimeError(f"{who}: non-finite slab-MP loss")
    if not gmax > 0:
        raise RuntimeError(f"{who}: slab-MP gradients are zero")
    print(f"{who} slab model-parallel: loss={loss3:.4f} "
          f"max|dL/dxyz|={gmax:.2e}", flush=True)
    return rec


def dryrun_multichip(n_devices: int, device=None):
    """Spawn ``n_devices`` ranks (a process group on a free localhost
    port; on CUDA they share the GPUs there are) and run one sharded
    mapping step, integrated ``mapping_steps`` and the slab model-parallel
    loss and gradients on tiny shapes; each rank prints three lines.
    Returns the ranks' records; raises if a rank fails a gate (finite
    losses, the map moved, n_touched > 0, non-zero slab gradients) or
    the ranks disagree on a loss."""
    from .device import resolve_device
    from .parallel.sharding import run_ranks
    dev = resolve_device(device)
    recs = run_ranks(_dryrun_rank, n_devices, (n_devices, str(dev)),
                     device=dev)
    for part in ("step", "integrated", "slab"):
        losses_ = {r[part]["loss"] for r in recs}
        if len(losses_) != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                               f"{part} losses differ: {sorted(losses_)}")
    return recs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", nargs="?", default="entry",
                   choices=("entry", "multichip"))
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks of the multichip dry run")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    if args.what == "multichip":
        dryrun_multichip(args.n, device=args.device)
        return
    fn, fargs = entry(device=args.device)
    out = fn(*fargs)
    if out[0].is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    main()

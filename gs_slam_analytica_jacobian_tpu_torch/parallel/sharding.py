"""Keyframe data parallelism across ranks (torch port of
parallel/sharding.py).

The natural scale-out axis of GS-SLAM mapping is the keyframe (view)
axis: each rank renders and differentiates its shard of the window's
keyframes against a replicated Gaussian map, the gradients are summed
across ranks, and every rank takes the same Adam step. Where the
reference drives every device of a ``("data",)`` mesh from one process
(shard_map, psum), the port is SPMD: one process per rank under
``torch.distributed``, every rank calling the same functions on the same
replicated state. ``Mesh`` stands for the process group and this rank's
place in it; the frame axis splits into contiguous shards, one per rank
(``P("data")``), so F must be a multiple of the mesh size.

Process groups: gloo on the CPU; on CUDA, nccl where every rank has a
GPU of its own and gloo where ranks share one (nccl refuses two ranks on
one device). gloo takes every collective used here on CUDA tensors, so
the compute and the collectives' operands stay on the card.
``run_ranks`` spawns the ranks of one machine (start method spawn: CUDA
cannot fork), builds the kernels first in the parent, gives each rank
one torch intra-op thread, and tears the group down when a rank ends.
"""

from __future__ import annotations

import dataclasses
import socket
import traceback
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.camera import Camera
from ..models.gaussian_map import (AdamState, GaussianMap, PARAM_FIELDS,
                                   adam_update)
from ..ops import losses


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``("data",)`` mesh of ranks: the process group, this rank,
    the number of ranks and this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def shard(self, n: int) -> range:
        """This rank's contiguous shard of ``n`` items (``n`` a multiple
        of the mesh size, as the reference's ``P("data")`` requires)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} "
                             "ranks (the frame axis must be a multiple of "
                             "the mesh size)")
        k = n // self.size
        return range(self.rank * k, (self.rank + 1) * k)


def backend_for(device: torch.device, world_size: int) -> str:
    """gloo on the CPU, and on CUDA where ranks share a GPU; nccl where
    every rank has a GPU of its own."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_mesh(n_devices: int, device=None) -> Mesh:
    """The mesh of the initialized default process group, which must have
    ``n_devices`` ranks; this rank computes on ``device`` (default: the
    current CUDA device). Raises if no such group is initialized: nothing
    falls back to one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh({n_devices}) needs an initialized torch.distributed "
            f"process group of {n_devices} ranks (init_process_group, or "
            "run_ranks, which spawns them)")
    size = dist.get_world_size()
    if size != n_devices:
        raise RuntimeError(f"make_mesh({n_devices}): the process group has "
                           f"{size} ranks")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if dev.type == "cpu" and backend != "gloo":
        raise RuntimeError(f"a CPU mesh needs the gloo backend, not "
                           f"{backend}")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                device=dev, backend=backend)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``Mesh`` whose process group is still
    initialized with its size."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.sharding.Mesh (from "
                        f"make_mesh), not {type(mesh).__name__}")
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(mesh.group) == mesh.size):
        raise RuntimeError(f"the mesh's process group of {mesh.size} ranks "
                           "is not initialized")


def all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced over the ranks (in place; returned)."""
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.stack(parts)


def flat_grads(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The parameter gradients as one flat buffer (PARAM_FIELDS order), so
    that one collective carries them all."""
    return torch.cat([grads[f].reshape(-1) for f in PARAM_FIELDS])


def unflat_grads(flat: torch.Tensor, like: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for f in PARAM_FIELDS:
        n = like[f].numel()
        out[f] = flat[i:i + n].reshape(like[f].shape)
        i += n
    return out


def sharded_mapping_step(
    mesh: Mesh,
    gm: GaussianMap,
    gm_adam: AdamState,
    frames_R: torch.Tensor,      # (F, 3, 3), F a multiple of the mesh size
    frames_t: torch.Tensor,      # (F, 3)
    gt_images: torch.Tensor,     # (F, 3, H, W)
    gt_depths: torch.Tensor,     # (F, 1, H, W)
    frames_valid,                # (F,) bool
    cam_template: Camera,
    bg: torch.Tensor,
    gm_lrs,
    rgb_boundary_threshold: float = 0.01,
    alpha: float = 0.95,
    use_oracle: bool = False,
    pair_capacity: int = 1 << 18,
) -> Tuple[GaussianMap, AdamState, torch.Tensor]:
    """One data-parallel map optimization step. Every rank calls it with
    the same (replicated) arguments; each renders its shard of the F
    frames, the summed loss and parameter gradients are all-reduced, and
    every rank takes the same Adam step. Returns (gm, adam, loss), the
    same on every rank."""
    from ..slam.render_api import render
    valid = [bool(v) for v in torch.as_tensor(frames_valid).tolist()]
    params = {f: getattr(gm, f).detach().requires_grad_()
              for f in PARAM_FIELDS}
    gm_p = gm.replace(**params)
    local = torch.zeros((), dtype=torch.float32, device=gm.device)
    for j in mesh.shard(len(valid)):
        if not valid[j]:
            continue
        cam = cam_template.replace(R=frames_R[j], t=frames_t[j])
        out = render(gm_p, cam, None, bg, use_oracle=use_oracle,
                     pair_capacity=pair_capacity, need_n_touched=False,
                     device=gm.device)
        L = losses.loss_mapping_rgbd(out.color, out.depth, gt_images[j],
                                     gt_depths[j], rgb_boundary_threshold,
                                     alpha)
        L.backward()
        local = local + L.detach()
    g = {f: (p.grad if p.grad is not None else torch.zeros_like(p))
         for f, p in params.items()}
    buf = all_reduce(torch.cat([flat_grads(g), local[None]]), mesh)
    grads = unflat_grads(buf[:-1], g)
    with torch.no_grad():
        new_gm, new_adam = adam_update(gm, grads, gm_adam, gm_lrs)
    return new_gm, new_adam, buf[-1]


# ---------------------------------------------------------------------------
# ranks of one machine
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world_size: int, init_method: str,
                       device=None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device: on CUDA, its own GPU where there are
    enough, else GPU ``rank`` modulo the count (ranks share)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a GPU; pass device='cpu' "
                               "for a gloo mesh on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, world_size),
                            init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def _rank_main(fn, rank, world_size, init_method, device, args, queue):
    torch.set_num_threads(1)
    try:
        init_process_group(rank, world_size, init_method, device)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n: int, args: Sequence = (), device=None,
              timeout_s: float = 3600.0) -> List:
    """Spawn ``n`` ranks on this machine, each joining a process group of
    ``n`` (a free localhost port) and calling ``fn(*args)``, which may
    call ``make_mesh(n, device)``; returns their results in rank order.
    ``fn`` must be importable by name (spawned ranks import it) and its
    result picklable. On CUDA the kernels are built here first, so that
    the ranks only load them. Raises, after stopping every rank, if one
    fails."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
        from ..ops import _build
        _build.build()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, init_method, str(dev), tuple(args),
                               q), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    waited = 0.0
    try:
        while len(results) < n:
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1.0
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead or waited > timeout_s:
                    raise RuntimeError(
                        f"rank(s) {dead} ended with exit codes "
                        f"{[procs[i].exitcode for i in dead]}" if dead
                        else f"ranks did not finish in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return [results[r] for r in range(n)]


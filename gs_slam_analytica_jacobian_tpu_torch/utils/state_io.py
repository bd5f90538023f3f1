"""Mid-run SLAM state checkpoint / resume (torch port of
utils/state_io.py): the Gaussian map and its Adam state, the keyframe
store and the pose Adam, and the backend's host bookkeeping, in one .npz
with the reference's keys and dtypes, so a file written by either package
loads in the other. The store's depth codes, int32 in the port's
``KFStore``, are written as the reference's uint16 and read back as
int32.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from ..models.gaussian_map import (ARRAY_FIELDS, AdamState, GaussianMap,
                                   adam_from_jax_fields, from_jax_fields)
from ..slam.mapping import KFStore, PoseAdamState


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_state(path: str, gm: GaussianMap, gm_adam: AdamState,
               store: KFStore, pose_adam: PoseAdamState,
               meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"gm.{f}": _host(getattr(gm, f)) for f in ARRAY_FIELDS}
    for name, d in (("m", gm_adam.m), ("v", gm_adam.v)):
        for k, a in d.items():
            arrays[f"adam.{name}.{k}"] = _host(a)
    arrays["adam.step"] = _host(gm_adam.step)
    for f in dataclasses.fields(KFStore):
        arrays[f"store.{f.name}"] = _host(getattr(store, f.name))
    arrays["store.gt_depth"] = arrays["store.gt_depth"].astype(np.uint16)
    arrays["pose_adam.m"] = _host(pose_adam.m)
    arrays["pose_adam.v"] = _host(pose_adam.v)
    arrays["pose_adam.step"] = _host(pose_adam.step)
    arrays["meta"] = np.frombuffer(
        json.dumps(dict(meta or {},
                        max_sh_degree=gm.max_sh_degree,
                        active_sh_degree=gm.active_sh_degree,
                        isotropic=gm.isotropic)
                   ).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device=None) -> Tuple[GaussianMap, AdamState,
                                                 KFStore, PoseAdamState,
                                                 dict]:
    """The state in ``path`` on ``device`` (None: CUDA)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())

    gm = from_jax_fields({k[3:]: v for k, v in arrays.items()
                          if k.startswith("gm.")},
                         meta["max_sh_degree"], meta["active_sh_degree"],
                         meta.get("isotropic", False), device=device)
    m = {k.split(".", 2)[2]: v for k, v in arrays.items()
         if k.startswith("adam.m.")}
    v = {k.split(".", 2)[2]: a for k, a in arrays.items()
         if k.startswith("adam.v.")}
    gm_adam = adam_from_jax_fields(m, v, arrays["adam.step"], device=device)

    st = {k[6:]: a for k, a in arrays.items() if k.startswith("store.")}
    if "depth_scale" not in st:
        # checkpoint format v1: f32 images/depths, no per-slot depth
        # scale. Quantize as KFStore.add does (u8 RGB; u16 depth at
        # dmax/65535).
        img = np.clip(np.asarray(st["gt_image"], np.float32), 0.0, 1.0)
        st["gt_image"] = np.round(img * 255.0).astype(np.uint8)
        dep = np.maximum(np.asarray(st["gt_depth"], np.float32), 0.0)
        dmax = dep.reshape(dep.shape[0], -1).max(axis=1)
        scale = np.where(dmax > 0, dmax / 65535.0, 0.0).astype(np.float32)
        st["gt_depth"] = np.round(
            dep / np.maximum(scale, 1e-12)[:, None, None, None]
        ).astype(np.uint16)
        st["depth_scale"] = scale
    store = KFStore.from_jax_fields(st, device=device)
    pose_adam = PoseAdamState.from_jax(
        arrays["pose_adam.m"], arrays["pose_adam.v"],
        arrays["pose_adam.step"], device=device)
    return gm, gm_adam, store, pose_adam, meta


def save_backend(path: str, backend, extra_meta: dict | None = None):
    """Checkpoint a BackEnd instance (host bookkeeping included)."""
    meta = dict(extra_meta or {})
    meta["uid_to_slot"] = {str(k): v for k, v in backend.uid_to_slot.items()}
    meta["current_window"] = list(backend.current_window)
    meta["iteration_count"] = backend.iteration_count
    meta["initialized"] = bool(backend.initialized)
    save_state(path, backend.gm, backend.gm_adam, backend.store,
               backend.pose_adam, meta)


def load_backend(path: str, backend):
    """Restore a BackEnd instance in place, on its device; returns the
    meta dict."""
    gm, gm_adam, store, pose_adam, meta = load_state(path, backend.device)
    backend.gm = gm
    backend.gm_adam = gm_adam
    backend.store = store
    backend.pose_adam = pose_adam
    backend.uid_to_slot = {int(k): v
                           for k, v in meta["uid_to_slot"].items()}
    backend.current_window = list(meta["current_window"])
    backend.iteration_count = int(meta["iteration_count"])
    backend.initialized = bool(meta["initialized"])
    return meta

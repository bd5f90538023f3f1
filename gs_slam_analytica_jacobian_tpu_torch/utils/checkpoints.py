"""Checkpoint ingestion: reference .pt maps -> GaussianMap (torch port of
utils/checkpoints.py).

The reference's Jacobian lab loads optimized maps saved as TorchScript
modules whose named parameters are, in order:
[xyz, features_dc, features_rest, opacity, scaling, rotation]. Such an
archive is read with ``torch.jit.load`` (TorchScript, not a pickle);
any other ``.pt`` file with ``torch.load(weights_only=True)``, as a list
of those six tensors in that order or a dict keyed by their names.
``.npz`` conversions (``pt_to_npz``) are interchangeable with the JAX
package's.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

_PT_FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation")


def _is_torchscript(path: str) -> bool:
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.endswith("constants.pkl") for n in z.namelist())
    except zipfile.BadZipFile:
        return False


def load_pt_tensors(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint -> dict of numpy arrays."""
    if _is_torchscript(path):
        mod = torch.jit.load(path, map_location="cpu")
        tensors = [p for _, p in mod.named_parameters()]
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        tensors = ([obj[k] for k in _PT_FIELDS] if isinstance(obj, dict)
                   else list(obj))
    if len(tensors) < 6:
        raise ValueError(
            f"expected >= 6 parameters in {path}, got {len(tensors)}")
    out = {k: t.detach().cpu().numpy() for k, t in zip(_PT_FIELDS, tensors)}
    if out["features_dc"].ndim == 2:                    # (N,3) -> (N,1,3)
        out["features_dc"] = out["features_dc"][:, None, :]
    return out


def pt_to_npz(pt_path: str, npz_path: Optional[str] = None) -> str:
    if npz_path is None:
        npz_path = os.path.splitext(pt_path)[0] + ".npz"
    np.savez(npz_path, **load_pt_tensors(pt_path))
    return npz_path


def load_npz_tensors(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in _PT_FIELDS}


def load_tensors(path: str, capacity: Optional[int] = None, device=None):
    """The reference's GaussianModel.load_tensors: a GaussianMap on
    ``device`` (None: CUDA) from a .pt or converted .npz checkpoint."""
    from ..models import gaussian_map as gmap

    t = (load_npz_tensors(path) if path.endswith(".npz")
         else load_pt_tensors(path))
    n = t["xyz"].shape[0]
    k_rest = t["features_rest"].shape[1] if t["features_rest"].ndim == 3 \
        else 0
    # sh degree from rest coeff count: (deg+1)^2 - 1
    deg = int(round((k_rest + 1) ** 0.5)) - 1
    fr = t["features_rest"].reshape(n, k_rest, 3) if k_rest else \
        np.zeros((n, 0, 3), np.float32)
    return gmap.from_numpy(
        xyz=t["xyz"].astype(np.float32),
        features_dc=t["features_dc"].astype(np.float32),
        features_rest=fr.astype(np.float32),
        scaling=t["scaling"].astype(np.float32),
        rotation=t["rotation"].astype(np.float32),
        opacity=t["opacity"].reshape(n, 1).astype(np.float32),
        max_sh_degree=max(deg, 0),
        active_sh_degree=max(deg, 0),
        capacity=capacity, device=device)


def main():  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference .pt gaussian checkpoint to .npz")
    ap.add_argument("pt_path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = pt_to_npz(args.pt_path, args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

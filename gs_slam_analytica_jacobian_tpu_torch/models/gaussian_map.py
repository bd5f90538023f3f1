"""Fixed-capacity Gaussian map (torch port of models/gaussian_map.py).

A frozen dataclass of tensors with an ``active`` mask over a padded
capacity, the same fields and activations as the reference. Adam,
densify and prune belong to the mapping slice and are not ported yet.

``from_jax_fields`` carries a reference map's weights across: it takes
the JAX map's fields as numpy arrays keyed by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sh as sh_ops
from ..ops.gaussian_math import build_cov3d

# every array field of the map, in the reference's order
ARRAY_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "active", "unique_kfids", "n_obs", "max_radii2d",
                "xyz_grad_accum", "denom")

_DTYPES = {"active": torch.bool, "unique_kfids": torch.int32,
           "n_obs": torch.int32}


@dataclasses.dataclass(frozen=True)
class GaussianMap:
    """Padded parameter store; only rows with ``active`` render."""

    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log-scale
    rotation: torch.Tensor       # (C, 4) quaternion (w, x, y, z)
    opacity: torch.Tensor        # (C, 1) logit
    active: torch.Tensor         # (C,) bool
    unique_kfids: torch.Tensor   # (C,) int32
    n_obs: torch.Tensor          # (C,) int32
    max_radii2d: torch.Tensor    # (C,) f32
    xyz_grad_accum: torch.Tensor  # (C,) f32
    denom: torch.Tensor          # (C,) f32
    max_sh_degree: int
    active_sh_degree: int
    isotropic: bool = False

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        n = torch.linalg.norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(n, min=1e-12)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)[:, 0]

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_cov6(self, scale_modifier: float = 1.0) -> torch.Tensor:
        return build_cov3d(self.get_scaling(), self.rotation, scale_modifier)

    def replace(self, **kw) -> "GaussianMap":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(capacity: int, max_sh_degree: int = 0, isotropic: bool = False,
              device=None) -> "GaussianMap":
        dev = resolve_device(device)
        k_rest = sh_ops.num_sh_coeffs(max_sh_degree) - 1

        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)

        rot = torch.zeros(capacity, 4, device=dev)
        rot[:, 0] = 1.0
        return GaussianMap(
            xyz=z(capacity, 3), features_dc=z(capacity, 1, 3),
            features_rest=z(capacity, k_rest, 3), scaling=z(capacity, 3),
            rotation=rot, opacity=z(capacity, 1),
            active=torch.zeros(capacity, dtype=torch.bool, device=dev),
            unique_kfids=torch.zeros(capacity, dtype=torch.int32, device=dev),
            n_obs=torch.zeros(capacity, dtype=torch.int32, device=dev),
            max_radii2d=z(capacity), xyz_grad_accum=z(capacity),
            denom=z(capacity), max_sh_degree=max_sh_degree,
            active_sh_degree=0, isotropic=isotropic)


def from_numpy(
    xyz: np.ndarray, features_dc: np.ndarray, features_rest: np.ndarray,
    scaling: np.ndarray, rotation: np.ndarray, opacity: np.ndarray,
    max_sh_degree: int, capacity: Optional[int] = None,
    active_sh_degree: Optional[int] = None, device=None,
) -> GaussianMap:
    """Build a map from raw (log/logit-space) parameter arrays; rows past
    ``len(xyz)`` up to ``capacity`` stay inactive."""
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    gm = GaussianMap.empty(capacity, max_sh_degree, device=device)
    if active_sh_degree is None:
        active_sh_degree = max_sh_degree
    dev = gm.device

    def put(dst, src, shape):
        out = dst.clone()
        out[:n] = torch.tensor(
            np.asarray(src, np.float32).reshape(shape), device=dev)
        return out

    k_rest = gm.features_rest.shape[1]
    rest = np.asarray(features_rest, np.float32).reshape(n, -1, 3)[:, :k_rest]
    active = gm.active.clone()
    active[:n] = True
    return gm.replace(
        xyz=put(gm.xyz, xyz, (n, 3)),
        features_dc=put(gm.features_dc, features_dc, (n, 1, 3)),
        features_rest=put(gm.features_rest, rest, (n, k_rest, 3)),
        scaling=put(gm.scaling, scaling, (n, 3)),
        rotation=put(gm.rotation, rotation, (n, 4)),
        opacity=put(gm.opacity, opacity, (n, 1)),
        active=active,
        active_sh_degree=active_sh_degree,
    )


def from_jax_fields(fields: Dict[str, np.ndarray], max_sh_degree: int,
                    active_sh_degree: int, isotropic: bool = False,
                    device=None) -> GaussianMap:
    """Carry a reference map's weights across: ``fields`` holds every
    array field of the JAX ``GaussianMap`` as a numpy array, keyed by field
    name (e.g. ``{f: np.asarray(getattr(gm_jax, f)) for f in
    ARRAY_FIELDS}``); the static fields are passed as they are."""
    dev = resolve_device(device)
    missing = [f for f in ARRAY_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing GaussianMap fields: {missing}")
    arrays = {
        f: torch.tensor(np.asarray(fields[f]),
                        dtype=_DTYPES.get(f, torch.float32), device=dev)
        for f in ARRAY_FIELDS}
    return GaussianMap(**arrays, max_sh_degree=int(max_sh_degree),
                       active_sh_degree=int(active_sh_degree),
                       isotropic=bool(isotropic))

"""PLY save/load of the Gaussian map (torch port of utils/ply.py; no
plyfile dependency, binary little-endian PLY written directly).

The reference's attribute naming (x y z nx ny nz f_dc_* f_rest_* opacity
scale_* rot_*) and layout, so a file written by either package loads in
the other. The map's tensors are read on the host; ``load_ply`` builds
the map on ``device`` (None: CUDA).
"""

from __future__ import annotations

import os

import numpy as np

from ..models.gaussian_map import GaussianMap, from_numpy


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _attributes(gm: GaussianMap):
    act = _host(gm.active)
    xyz = _host(gm.xyz)[act]
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # features stored channel-major like the torch .transpose(1,2).flatten
    f_dc = _host(gm.features_dc)[act].transpose(0, 2, 1).reshape(n, -1)
    f_rest = _host(gm.features_rest)[act].transpose(0, 2, 1).reshape(n, -1)
    opacity = _host(gm.opacity)[act]
    scale = _host(gm.scaling)[act]
    rot = _host(gm.rotation)[act]
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scale.shape[1])]
    names += [f"rot_{i}" for i in range(rot.shape[1])]
    data = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scale, rot], axis=1
    ).astype("<f4")
    return names, data


def save_ply(gm: GaussianMap, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names, data = _attributes(gm)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {data.shape[0]}"]
        header += [f"property float {n}" for n in names]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str, capacity=None, device=None) -> GaussianMap:
    with open(path, "rb") as f:
        names = []
        n_vertex = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(
            f.read(n_vertex * len(names) * 4), dtype="<f4"
        ).reshape(n_vertex, len(names))
    col = {n: i for i, n in enumerate(names)}
    xyz = data[:, [col["x"], col["y"], col["z"]]]
    f_dc = data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
    rest_names = sorted(
        (n for n in names if n.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        f_rest = data[:, [col[n] for n in rest_names]]
        f_rest = f_rest.reshape(n_vertex, 3, -1).transpose(0, 2, 1)
        k_rest = f_rest.shape[1]
    else:
        f_rest = np.zeros((n_vertex, 0, 3), np.float32)
        k_rest = 0
    sh_deg = int(round(np.sqrt(k_rest + 1))) - 1
    scale_names = sorted((n for n in names if n.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((n for n in names if n.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    scaling = data[:, [col[n] for n in scale_names]]
    if scaling.shape[1] == 1:
        scaling = np.repeat(scaling, 3, axis=1)
    rotation = data[:, [col[n] for n in rot_names]]
    opacity = data[:, col["opacity"]][:, None]
    return from_numpy(xyz, f_dc.reshape(n_vertex, 1, 3), f_rest, scaling,
                      rotation, opacity, max_sh_degree=sh_deg,
                      capacity=capacity, device=device)

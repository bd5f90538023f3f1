"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each source in ``csrc/`` compiles on first use into
``build/torch_kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. The library exposes a
plain C entry that takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; no PyTorch headers are compiled, which
keeps a build to seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# -fmad=false: no multiply-add contraction, so the kernels round exactly
# like their plain PyTorch versions (one op per torch kernel) and a
# threshold test (alpha >= 1/255, T < 1e-4) never flips between the two.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# kernel library name -> (source file, C entry, argtypes)
_VP = ctypes.c_void_p
_INT = ctypes.c_int
LIBRARIES = {
    "tile_kernel2_fwd": ("tile_kernel2_fwd.cu", "composite32_fwd",
                         [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                          _INT, _VP]),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / LIBRARIES[name][0]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, dict]:
    """Compile every named library that is not built yet, one nvcc per
    source, all started together. Returns per-library
    {"path", "seconds", "ptxas"} (seconds 0.0 and ptxas "" when the
    library was already built). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            info[name] = {"path": str(path), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, path)
        info[name] = {"path": str(path), "seconds": secs, "ptxas": log}
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _, entry, argtypes = LIBRARIES[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib

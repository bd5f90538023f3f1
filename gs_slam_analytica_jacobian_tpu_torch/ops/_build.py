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

# kernel library name -> (source file, {C entry: argtypes}); a source may
# export several entries (the bf16 and mxu variants, and the bodies of the
# one-CTA-per-tile designs kept as yardsticks, beside each other)
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FWD_ARGS = [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _VP]
_BWD_ARGS = [_VP] * 9 + [_INT, _INT, _INT, _INT, _VP]
_ABL16_ARGS = [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _VP]
LIBRARIES = {
    "tile32_fwd_subtile": ("tile32_fwd_subtile.cu",
                           {"composite32_fwd": _FWD_ARGS,
                            "composite32_fwd_bf16": _FWD_ARGS}),
    "tile32_fwd_subtile_mxu": ("tile32_fwd_subtile_mxu.cu",
                               {"composite32_fwd_mxu": _FWD_ARGS}),
    "tile32_bwd_subtile": ("tile32_bwd_subtile.cu",
                           {"composite32_bwd": _BWD_ARGS,
                            "composite32_bwd_bf16": _BWD_ARGS,
                            "composite32_bwd_mxu": _BWD_ARGS,
                            "composite32_bwd_bf16_mxu": _BWD_ARGS}),
    "tile_kernel2_fwd": ("tile_kernel2_fwd.cu",
                         {"composite32_fwd_tile1024": _FWD_ARGS,
                          "composite32_fwd_bf16_tile1024": _FWD_ARGS,
                          "composite32_fwd_mxu_tile1024": _FWD_ARGS,
                          "mxu_power_tile": [_VP, _INT, _INT, _INT, _VP,
                                             _VP]}),
    "tile_kernel2_bwd": ("tile_kernel2_bwd.cu",
                         {"composite32_bwd_tile1024": _BWD_ARGS,
                          "composite32_bwd_bf16_tile1024": _BWD_ARGS,
                          "composite32_bwd_mxu_tile1024": _BWD_ARGS,
                          "composite32_bwd_bf16_mxu_tile1024": _BWD_ARGS}),
    "tile16_fwd_subtile": ("tile16_fwd_subtile.cu",
                           {"composite16_fwd": _FWD_ARGS}),
    "tile_kernel16_fwd": ("tile_kernel16_fwd.cu",
                          {"composite16_fwd_walk": _FWD_ARGS}),
    "tile16_bwd_subtile": ("tile16_bwd_subtile.cu",
                           {"composite16_bwd": _BWD_ARGS}),
    "tile_kernel16_bwd": ("tile_kernel16_bwd.cu",
                          {"composite16_bwd_walk": _BWD_ARGS}),
    "abl16": ("abl16.cu", {f"abl16_{v}{d}": _ABL16_ARGS for v in (
        "full", "noexp", "noscan", "nomxu", "notrans", "minimal", "dyn",
        "prodbody") for d in ("", "_group")}),
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
    """The library's path, keyed by its source, the headers in csrc/ (a
    source may include any of them) and the flags."""
    src = (CSRC / LIBRARIES[name][0]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
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
    """The loaded library ``name``, built first if needed, with the
    argtypes and restype of every C entry it exports set."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for c_entry, argtypes in LIBRARIES[name][1].items():
            fn = getattr(lib, c_entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(name: str, fn: str):
    """The C entry ``fn`` of library ``name`` (loaded, built if needed)."""
    if fn not in LIBRARIES[name][1]:
        raise KeyError(f"library {name} exports no entry {fn}")
    return getattr(load(name), fn)

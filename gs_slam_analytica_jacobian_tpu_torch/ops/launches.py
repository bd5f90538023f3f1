"""Launch counts of the compositing kernels a path runs.

Each kernel wrapper adds one to a counter attribute where it launches its
CUDA kernel (never for its plain version on a CPU tensor). ``COUNTERS``
names them: the bf16 and mxu variants count in their wrapper's
``launches_bf16``, ``launches_mxu`` and (the backward under both)
``launches_bf16_mxu``. ``counts`` reads them and ``reset`` sets them to
0, so a process (a bench run, one rank of a mesh) can report what its
path launched.
"""

from __future__ import annotations

from typing import Dict

from . import tile_kernel16 as tk16
from . import tile_kernel2 as tk

COUNTERS = {
    "composite32_fwd": (tk.composite32_fwd, "launches"),
    "composite32_fwd_ntouch": (tk.composite32_fwd_ntouch, "launches"),
    "composite32_bwd": (tk.composite32_bwd, "launches"),
    "composite16_fwd": (tk16.composite16_fwd, "launches"),
    "composite16_fwd_ntouch": (tk16.composite16_fwd_ntouch, "launches"),
    "composite16_bwd": (tk16.composite16_bwd, "launches"),
    "composite32_fwd_bf16": (tk.composite32_fwd, "launches_bf16"),
    "composite32_fwd_ntouch_bf16": (tk.composite32_fwd_ntouch,
                                    "launches_bf16"),
    "composite32_bwd_bf16": (tk.composite32_bwd, "launches_bf16"),
    "composite32_fwd_mxu": (tk.composite32_fwd, "launches_mxu"),
    "composite32_fwd_ntouch_mxu": (tk.composite32_fwd_ntouch,
                                   "launches_mxu"),
    "composite32_bwd_mxu": (tk.composite32_bwd, "launches_mxu"),
    "composite32_bwd_bf16_mxu": (tk.composite32_bwd, "launches_bf16_mxu"),
}


def counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)

"""Launch counts of the compositing kernels a path runs.

Each kernel wrapper adds one to a counter attribute where it launches its
CUDA kernel (never for its plain version on a CPU tensor). ``COUNTERS``
names them: the bf16 and mxu variants count in their wrapper's
``launches_bf16``, ``launches_mxu`` and (the backward under both)
``launches_bf16_mxu``. ``counts`` reads them and ``reset`` sets them to
0, so a process (a bench run, one rank of a mesh) can report what its
path launched.

``PALLAS_SITES`` maps every ``pl.pallas_call`` site of the JAX package
and its scripts to the CUDA kernels that replace it;
tests/test_torch_inventory.py holds it to the JAX sources and to
``COUNTERS``.
"""

from __future__ import annotations

from typing import Dict, Tuple

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


_FWD_BF16 = "bf16=True, _chunk_terms :160-175"
_FWD_MXU = "mxu=True, _mxu_power :96-128, log-space T :279-289"

# Keyed "<path>:<line>" from the repository root. ``counters``: each
# COUNTERS name that launches a kernel of the site -> (its CUDA source in
# the package, the JAX lines of its variant); ``yardsticks``: the
# designs those kernels replaced, C entries that only chip_smoke.py
# times and no path launches, likewise. B5 has no counter: its kernels
# are launched by the port's script entry ``entry`` ("<file in the
# package>:<wrapper>"; counts in ``run.launches``).
PALLAS_SITES = {
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py:642": dict(
        kernel="B1", body="_fwd_impl with n_touched, make_forward_kernel",
        counters={
            "composite32_fwd_ntouch": ("csrc/tile32_fwd_subtile.cu", ""),
            "composite32_fwd_ntouch_bf16": ("csrc/tile32_fwd_subtile.cu",
                                            _FWD_BF16),
            "composite32_fwd_ntouch_mxu": ("csrc/tile32_fwd_subtile_mxu.cu",
                                           _FWD_MXU)},
        yardsticks={}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py:662": dict(
        kernel="B1'", body="_fwd_impl, make_forward_kernel",
        counters={
            "composite32_fwd": ("csrc/tile32_fwd_subtile.cu", ""),
            "composite32_fwd_bf16": ("csrc/tile32_fwd_subtile.cu",
                                     _FWD_BF16),
            "composite32_fwd_mxu": ("csrc/tile32_fwd_subtile_mxu.cu",
                                    _FWD_MXU)},
        yardsticks={
            "composite32_fwd_tile1024": ("csrc/tile_kernel2_fwd.cu", ""),
            "composite32_fwd_bf16_tile1024": ("csrc/tile_kernel2_fwd.cu",
                                              "bf16=True"),
            "composite32_fwd_mxu_tile1024": ("csrc/tile_kernel2_fwd.cu",
                                             "mxu=True")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py:699": dict(
        kernel="B2", body="_bwd_impl, make_backward_kernel",
        counters={
            "composite32_bwd": ("csrc/tile32_bwd_subtile.cu", ""),
            "composite32_bwd_bf16": ("csrc/tile32_bwd_subtile.cu",
                                     "bf16=True, :488-508"),
            "composite32_bwd_mxu": ("csrc/tile32_bwd_subtile.cu",
                                    "mxu=True, :387-398"),
            "composite32_bwd_bf16_mxu": ("csrc/tile32_bwd_subtile.cu",
                                         "mxu=True, :387-398, bf16 "
                                         ":488-508")},
        yardsticks={
            "composite32_bwd_tile1024": ("csrc/tile_kernel2_bwd.cu", ""),
            "composite32_bwd_bf16_tile1024": ("csrc/tile_kernel2_bwd.cu",
                                              "bf16=True"),
            "composite32_bwd_mxu_tile1024": ("csrc/tile_kernel2_bwd.cu",
                                             "mxu=True"),
            "composite32_bwd_bf16_mxu_tile1024": ("csrc/tile_kernel2_bwd.cu",
                                                  "mxu=True, bf16=True")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:562": dict(
        kernel="B3", body="_fwd_impl16 with n_touched, "
                          "make_forward_kernel16",
        counters={
            "composite16_fwd_ntouch": ("csrc/tile16_fwd_subtile.cu", "")},
        yardsticks={}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:582": dict(
        kernel="B3'", body="_fwd_impl16, make_forward_kernel16",
        counters={"composite16_fwd": ("csrc/tile16_fwd_subtile.cu", "")},
        yardsticks={
            "composite16_fwd_walk": ("csrc/tile_kernel16_fwd.cu", "")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:622": dict(
        kernel="B4", body="_bwd_impl16, make_backward_kernel16",
        counters={"composite16_bwd": ("csrc/tile16_bwd_subtile.cu", "")},
        yardsticks={
            "composite16_bwd_walk": ("csrc/tile_kernel16_bwd.cu", "")}),
    "scripts/abl16.py:237": dict(
        kernel="B5", body="run, make_kernel",
        counters={},
        entry={"scripts/abl16.py:run": ("csrc/abl16.cu", "make_kernel :55")},
        yardsticks={
            "scripts/abl16.py:run(design='group')": ("csrc/abl16.cu",
                                                     "make_kernel :55")}),
}


# CUDA sources that replace no pl.pallas_call site, with the JAX code
# whose work they do: tests/test_torch_inventory.py holds every source in
# csrc/ to a site of PALLAS_SITES or to a line here. Their wrappers count
# their launches themselves, outside COUNTERS.
OTHER_SOURCES = {
    "csrc/preprocess.cu": (
        "ops/gaussian_math.py preprocess, the map's activations and "
        "ops/renderer_tiled.py pack_table: plain jnp that XLA fuses; the "
        "port's ops/preprocess_fused.py counts preprocess_fwd.launches and "
        "preprocess_bwd.launches"),
    "csrc/pair_gather.cu": (
        "ops/pair_gather.py _fwd_impl (the row gather) and _pg_bwd / "
        "segment_reduce_pairs (the cumsum segment-reduce): plain jnp; the "
        "port's ops/pair_gather.py counts pair_gather_fwd.launches and "
        "segment_reduce_fwd.launches"),
}


def site_of(name: str) -> Tuple[str, str, str]:
    """(site, CUDA source, variant lines) of a COUNTERS name, a yardstick
    or B5's entry, from PALLAS_SITES."""
    for site, v in PALLAS_SITES.items():
        for group in ("counters", "entry", "yardsticks"):
            if name in v.get(group, {}):
                return (site,) + v[group][name]
    raise KeyError(name)


def counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)

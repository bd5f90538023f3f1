"""Launch counts of every hand-written kernel a path runs.

Each kernel wrapper adds one to a counter attribute where it launches its
CUDA kernel (never for its plain version on a CPU tensor). ``COUNTERS``
names them: the compositing kernels, whose bf16 and mxu variants count in
their wrapper's ``launches_bf16``, ``launches_mxu`` and (the backward
under both) ``launches_bf16_mxu``, and the preprocess and pair-gather
kernels. ``counts`` reads them and ``reset`` sets them to 0, so a process
(a bench run, one rank of a mesh) can report what its path launched;
``utils/trace.py`` ``snapshot()`` reports them as ``launch.<name>``.

``PALLAS_SITES`` maps every ``pl.pallas_call`` site of the JAX package
and its scripts to the CUDA kernels that replace it, and
``OTHER_SOURCES`` the CUDA sources that replace none to the JAX code
whose work they do; tests/test_torch_inventory.py holds both to the JAX
sources, to ``csrc/`` and to ``COUNTERS``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import pair_gather as pg
from . import preprocess_fused as pf
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
    "preprocess_fwd": (pf.preprocess_fwd, "launches"),
    "preprocess_bwd": (pf.preprocess_bwd, "launches"),
    "pair_gather_fwd": (pg.pair_gather_fwd, "launches"),
    "segment_reduce_fwd": (pg.segment_reduce_fwd, "launches"),
}


_FWD_BF16 = "bf16=True, _chunk_terms :160-175"
_FWD_MXU = "mxu=True, _mxu_power :96-128, log-space T :279-289"

# Keyed "<path>:<line>" from the repository root. ``counters``: each
# COUNTERS name that launches a kernel of the site -> (its CUDA source in
# the package, the JAX lines of its variant). B5 has no counter: its
# kernels are launched by the port's script entry ``entry`` ("<file in
# the package>:<wrapper>"; counts in ``run.launches``).
PALLAS_SITES = {
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py:642": dict(
        kernel="B1", body="_fwd_impl with n_touched, make_forward_kernel",
        counters={
            "composite32_fwd_ntouch": ("csrc/tile32_fwd_subtile.cu", ""),
            "composite32_fwd_ntouch_bf16": ("csrc/tile32_fwd_subtile.cu",
                                            _FWD_BF16),
            "composite32_fwd_ntouch_mxu": ("csrc/tile32_fwd_subtile_mxu.cu",
                                           _FWD_MXU)}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel2.py:662": dict(
        kernel="B1'", body="_fwd_impl, make_forward_kernel",
        counters={
            "composite32_fwd": ("csrc/tile32_fwd_subtile.cu", ""),
            "composite32_fwd_bf16": ("csrc/tile32_fwd_subtile.cu",
                                     _FWD_BF16),
            "composite32_fwd_mxu": ("csrc/tile32_fwd_subtile_mxu.cu",
                                    _FWD_MXU)}),
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
                                         ":488-508")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:562": dict(
        kernel="B3", body="_fwd_impl16 with n_touched, "
                          "make_forward_kernel16",
        counters={
            "composite16_fwd_ntouch": ("csrc/tile16_fwd_subtile.cu", "")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:582": dict(
        kernel="B3'", body="_fwd_impl16, make_forward_kernel16",
        counters={"composite16_fwd": ("csrc/tile16_fwd_subtile.cu", "")}),
    "gs_slam_analytica_jacobian_tpu/ops/pallas/tile_kernel16.py:622": dict(
        kernel="B4", body="_bwd_impl16, make_backward_kernel16",
        counters={"composite16_bwd": ("csrc/tile16_bwd_subtile.cu", "")}),
    "scripts/abl16.py:237": dict(
        kernel="B5", body="run, make_kernel",
        counters={},
        entry={"scripts/abl16.py:run": ("csrc/abl16.cu", "make_kernel :55")}),
}


# CUDA sources that replace no pl.pallas_call site -> (the JAX code whose
# work they do, the COUNTERS names of their kernels):
# tests/test_torch_inventory.py holds every source in csrc/ to a site of
# PALLAS_SITES or to an entry here, and the two together to COUNTERS.
OTHER_SOURCES = {
    "csrc/preprocess.cu": (
        "ops/gaussian_math.py preprocess, the map's activations and "
        "ops/renderer_tiled.py pack_table: plain jnp that XLA fuses",
        ("preprocess_fwd", "preprocess_bwd")),
    "csrc/pair_gather.cu": (
        "ops/pair_gather.py _fwd_impl (the row gather) and _pg_bwd / "
        "segment_reduce_pairs (the cumsum segment-reduce): plain jnp",
        ("pair_gather_fwd", "segment_reduce_fwd")),
}


def site_of(name: str) -> Tuple[str, str, str]:
    """(site, CUDA source, variant lines) of a COUNTERS name of a
    PALLAS_SITES site, or B5's entry."""
    for site, v in PALLAS_SITES.items():
        for group in ("counters", "entry"):
            if name in v.get(group, {}):
                return (site,) + v[group][name]
    raise KeyError(name)


def counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)

"""B5, the 16x16 chunk-body ablation harness: the port's plain version
(``gs_slam_analytica_jacobian_tpu_torch.scripts.abl16.run`` on CPU
tensors) against the JAX script's kernel, for each of the 8 variants.

The JAX side is scripts/abl16.py's ``make_kernel`` wrapped in the same
``pl.pallas_call`` as its ``run`` (abl16.py:226-243) with
``interpret=True`` (``run`` has no interpret flag, and the script stays
as it is). The script is loaded with importlib; its import sets JAX's
compile-cache options (abl16.py:27-28), which are restored right after.

Two plans at n_gx=2, n_gy=1 (64x32 pixels, 8 16-px tiles):
- the script's own: NC=1 chunk of 128 pairs per tile, features uniform in
  [0.2, 0.8) from seed 0. Its rect16 columns lie in [0.2, 0.8), so
  prodbody's rect test admits no cell there (T = 1 everywhere): the
  check of prodbody's arithmetic is the second plan;
- one whose rect16 columns admit every cell, with means on the group's
  pixels, positive-definite conics and ragged ranges (0 to 2 chunks of
  pairs per tile, NC=2), so the dynamic trip counts, the row test and the
  1e-4 stop all act.

Tolerance: 1e-5 relative (the kernel walks a chunk pair by pair, the
reference scans it, and the two sum in other orders).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gs_slam_analytica_jacobian_tpu_torch.scripts import abl16

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_GX, N_GY = 2, 1
W, H = 32 * N_GX, 32 * N_GY


def _load_script():
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "abl16_reference", ROOT / "scripts" / "abl16.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load_script()


def _jax_run(mod, feat, ranges, nc, variant):
    """abl16.py::run (:223-242) with interpret=True, unjitted; the block
    layout turned into (n_gy, n_gx, 4, 256)."""
    kernel = mod.make_kernel(2 * N_GX, W, H, nc, variant)
    img_spec = pl.BlockSpec((6, 8, 128), lambda gy, gx, *_: (0, gy, gx),
                            memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(N_GY, N_GX),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=img_spec,
        scratch_shapes=[
            pltpu.VMEM((mod.NBUF, mod.F, mod.K), jnp.float32),
            pltpu.SemaphoreType.DMA((mod.NBUF,)),
        ],
    )
    img = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((6, N_GY * 8, N_GX * 128),
                                       jnp.float32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(jnp.asarray(ranges).reshape(-1), jnp.asarray(feat))
    img = np.asarray(img)
    # every one of the 6 channels carries the row sum
    assert all(np.array_equal(img[c], img[0]) for c in range(6))
    x = img[0].reshape(N_GY, 4, 2, N_GX, 128).transpose(0, 3, 1, 2, 4)
    return x.reshape(N_GY, N_GX, 4, 256)


def _admitting_plan(nc=2):
    f, r = abl16.make_admitting_inputs(N_GX, N_GY, nc)
    return f.numpy(), r.numpy()


@pytest.mark.parametrize("variant", abl16.VARIANTS)
def test_plain_matches_script_kernel(ref, variant):
    feat, ranges = abl16.make_inputs(N_GX, N_GY, 1)
    want = _jax_run(ref, feat.numpy(), ranges.numpy(), 1, variant)
    got = abl16.run(feat, ranges, N_GX, N_GY, W, H, 1, variant).numpy()
    assert abl16.run.launches[variant] == 0        # CPU: the plain version
    assert np.all(np.isfinite(got)) and got.shape == (N_GY, N_GX, 4, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if variant == "prodbody":
        # the script's rect16 columns admit nothing: T stays 1
        assert np.all(got == 1.0)


@pytest.mark.parametrize("variant", abl16.VARIANTS)
def test_plain_matches_script_kernel_admitting_plan(ref, variant):
    f, r = _admitting_plan()
    want = _jax_run(ref, f, r, 2, variant)
    got = abl16.run(torch.as_tensor(f), torch.as_tensor(r), N_GX, N_GY, W,
                    H, 2, variant).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if variant == "prodbody":
        # the rect test admits cells (row sums off 1) and the empty tile
        # 0 reads T = 1
        assert np.all(got[0, 0, 0] == 1.0) and got.max() > 1.05


@pytest.mark.parametrize("variant", abl16.VARIANTS)
def test_group_design_on_cpu_is_the_plain_version(variant):
    """``design="group"`` (on a GPU the yardstick's C entries,
    ``abl16_<variant>_group``) takes the same plain version on CPU
    tensors as the default design and counts no launch of either; an
    unknown design raises."""
    f, r = (torch.as_tensor(x) for x in _admitting_plan())
    before = (dict(abl16.run.launches), dict(abl16.run.launches_group))
    got = abl16.run(f, r, N_GX, N_GY, W, H, 2, variant, design="group")
    assert torch.equal(got, abl16.run(f, r, N_GX, N_GY, W, H, 2, variant))
    assert torch.equal(got, abl16.run_plain(f, r, N_GX, N_GY, W, H, 2,
                                            variant))
    assert (abl16.run.launches, abl16.run.launches_group) == before
    with pytest.raises(ValueError):
        abl16.run(f, r, N_GX, N_GY, W, H, 2, variant, design="tile")


def test_bound_and_chunks():
    """The bound counts what the variant walks on this plan: every
    subtile's NC chunks, or under dyn its own ceil(n / 128)."""
    f, r = _admitting_plan()
    r = torch.as_tensor(r)
    n = (r[:, 1] - r[:, 0]).numpy()
    assert abl16.chunks_walked(r, N_GX, N_GY, 2, "full") == 8 * 2
    assert abl16.chunks_walked(r, N_GX, N_GY, 2, "dyn") == int(
        ((n + 127) // 128).sum())
    ms, by = abl16.bound_ms(r, N_GX, N_GY, 2, "full")
    assert by == "operations" and ms > 0
    with pytest.raises(ValueError):
        abl16.run(torch.as_tensor(f), r, N_GX, N_GY, W, H, 2, "nope")

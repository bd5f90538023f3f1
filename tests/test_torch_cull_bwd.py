"""The backward walks of B2-bf16 and B2-mxu restricted to the cells their
block tests keep (``ops/tile_kernel2.py``: ``plain_bwd_walk(cull=True)``
under ``bf16`` and ``mxu``, the plain versions of the sub-tile kernel
``csrc/tile32_bwd_subtile.cu``), the backward's own stop offsets
(``plain_bwd_walk(done_at=True)``) and the cells counted from them
(``subtile_cells``), against the unculled walks, the forward walks and
the JAX package's Pallas backward in interpret mode:

- ``plain_bwd_walk(cull=True)`` under bf16 (the margin of
  ``block_keep_plain(..., bf16=True)``), under mxu (the 32x32 tile's
  ``centre``) and under both gives the unculled walk's rows, included
  cells and stops bit for bit on tests/test_torch_subtile_cull.py's plans:
  a culled cell adds exact zeros;
- the backward's stops equal ``plain_walk(done_at=True)``'s for f32 and
  bf16 (the same falloff, tests and transmittance step);
- the culled bf16 rows match JAX's ``_bwd_impl(bf16=True)`` within
  ``tests/test_torch_bf16.py``'s tolerance, each column within 1/4 of the
  JAX bf16-vs-f32 gap of that column (the JAX side in a subprocess under
  ``XLA_FLAGS=--xla_allow_excess_precision=false``, as there), and the
  culled mxu rows match ``_bwd_impl(mxu=True)`` within
  ``tests/test_torch_mxu.py``'s 2e-3 of each column's max, on one small
  plan (interpret mode is slow);
- ``subtile_cells`` under the backward's stops agrees with a literal
  count for the f32, bf16, mxu and bf16 + mxu bodies (the last equal to
  the mxu body's).

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``cuda`` marker)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu.ops.pallas import tile_kernel2 as jtk
from gs_slam_analytica_jacobian_tpu_torch.ops import tile_kernel2 as ttk

from test_torch_subtile_cull import PLANS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GAP_FRAC = 0.25                    # tests/test_torch_bf16.py's tolerance
BODIES = {"bf16": (True, False), "mxu": (False, True),
          "bf16_mxu": (True, True)}
JAX_BF16_PLANS = ("scene_83x45", "scene_125x70")


@functools.lru_cache(maxsize=None)
def _plan(name):
    return PLANS[name]()


def _cot(H, W, seed=3):
    """A seeded cotangent of the five planes, (5, H, W) f32 numpy."""
    return np.random.default_rng(seed).normal(size=(5, H, W)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _bwd_args(name, bf16, mxu):
    """plain_bwd_walk's arguments on plan ``name``: the planes of the
    forward walk of the same body and a seeded cotangent."""
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    fwd = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, False, bf16=bf16,
                         mxu=mxu)[0]
    cot = torch.as_tensor(_cot(H, W))
    return (feat, ranges, fwd.color_sum, fwd.depth_sum, fwd.final_T,
            cot[0:3], cot[3], cot[4], n_tx, n_ty, W, H)


@pytest.mark.parametrize("body", list(BODIES))
@pytest.mark.parametrize("name", list(PLANS))
def test_culled_bwd_walk_equals_plain_bwd_walk(name, body):
    """plain_bwd_walk(cull=True) under bf16, mxu and both: the unculled
    walk's rows, included cells and stops, bit for bit; the block test
    drops cells there."""
    bf16, mxu = BODIES[body]
    args = _bwd_args(name, bf16, mxu)
    rows, _, inc, stop = ttk.plain_bwd_walk(*args, bf16=bf16, mxu=mxu,
                                            done_at=True)
    rows_c, _, inc_c, stop_c = ttk.plain_bwd_walk(*args, bf16=bf16, mxu=mxu,
                                                  cull=True, done_at=True)
    assert torch.equal(rows_c, rows)
    assert int(inc_c) == int(inc) > 0
    assert torch.equal(stop_c, stop)
    assert bool(rows[:, :ttk.N_ROWS].any(dim=1).any())
    assert not bool(rows[:, ttk.N_ROWS:].any())
    feat, ranges, n_tx, n_ty = args[0], args[1], args[8], args[9]
    kept, rected = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop,
                                     mxu=mxu, bf16=bf16)
    assert kept < rected


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", list(PLANS))
def test_bwd_stops_equal_forward_stops(name, bf16):
    """The backward's stop offsets equal the forward walk's under f32 and
    bf16 (the same falloff, tests and transmittance step); on the seeded
    scenes (opaque splats) some pixels stop, on the room's plan none."""
    args = _bwd_args(name, bf16, False)
    stop = ttk.plain_bwd_walk(*args, bf16=bf16, done_at=True)[3]
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    stop_f = ttk.plain_walk(feat, ranges, n_tx, n_ty, W, H, False, bf16=bf16,
                            done_at=True)[3]
    assert torch.equal(stop, stop_f)
    stopped = bool(((stop >= 0) & (stop < 1 << 62)).any())
    assert stopped == name.startswith("scene"), name


# ---------------------------------------------------------------------------
# against the JAX package's backward in interpret mode
# ---------------------------------------------------------------------------

def _jax_bf16_backward(in_path, out_path):
    """The JAX side (``python tests/test_torch_cull_bwd.py IN OUT``, under
    ``--xla_allow_excess_precision=false``): on each plan of ``IN``, the
    forward and the backward of the bf16 and the f32 bodies in interpret
    mode, under the plan's cotangent."""
    res = {}
    with np.load(in_path) as z:
        for name in JAX_BF16_PLANS:
            feat = jnp.asarray(z[f"{name}_feat"])
            ranges = jnp.asarray(z[f"{name}_ranges"])
            n_tx, n_ty, W, H = (int(v) for v in z[f"{name}_dims"])
            cot_img = jtk.disassemble_image(jnp.asarray(z[f"{name}_cot"]),
                                            n_tx, n_ty)
            for bf16 in (0, 1):
                img, _ = jtk._fwd_impl(feat, ranges, n_tx, n_ty, W, H,
                                       interpret=True, with_ntouch=False,
                                       bf16=bool(bf16))
                res[f"{name}_{bf16}_asm"] = np.asarray(
                    jtk.assemble_image(img, n_tx, n_ty, W, H))
                res[f"{name}_{bf16}_rows"] = np.asarray(jtk._bwd_impl(
                    feat, ranges, img, cot_img, n_tx, n_ty, W, H,
                    interpret=True, bf16=bool(bf16)))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jref_bf16(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cull_bwd")
    inputs = {}
    for name in JAX_BF16_PLANS:
        feat, ranges, n_tx, n_ty, W, H = _plan(name)
        inputs.update({f"{name}_feat": feat.numpy(),
                       f"{name}_ranges": ranges.numpy(),
                       f"{name}_dims": np.array([n_tx, n_ty, W, H]),
                       f"{name}_cot": _cot(H, W)})
    in_path, out_path = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(in_path, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), in_path, out_path],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def _port_rows(name, asm, **flags):
    """The culled plain backward on plan ``name`` from the forward planes
    ``asm`` (5, H, W) under the plan's cotangent, as numpy."""
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    cot = torch.as_tensor(_cot(H, W))
    a = torch.as_tensor(np.array(asm))
    return ttk.plain_bwd_walk(feat, ranges, a[0:3], a[3], a[4], cot[0:3],
                              cot[3], cot[4], n_tx, n_ty, W, H, cull=True,
                              **flags)[0].numpy()


@pytest.mark.parametrize("name", JAX_BF16_PLANS)
def test_bf16_culled_bwd_walk_matches_pallas(jref_bf16, name):
    """The culled bf16 rows against JAX's bf16 backward (per-op rounding)
    on the same planes and cotangent: each column within 1/4 of the JAX
    bf16-vs-f32 gap of that column."""
    got = _port_rows(name, jref_bf16[f"{name}_1_asm"], bf16=True)
    rows_b = jref_bf16[f"{name}_1_rows"]
    rows_f = jref_bf16[f"{name}_0_rows"]
    for col in range(ttk.N_ROWS):
        gap = float(np.abs(rows_b[:, col] - rows_f[:, col]).max())
        assert gap > 1e-3 * float(np.abs(rows_f[:, col]).max()), (col, gap)
        err = float(np.abs(got[:, col] - rows_b[:, col]).max())
        assert err <= GAP_FRAC * gap, (col, err, gap)
    assert not got[:, ttk.N_ROWS:].any()


def test_mxu_culled_bwd_walk_matches_pallas():
    """The culled mxu rows against JAX's mxu backward on one small plan
    (its own mxu forward's planes, the plan's cotangent): each column
    within 2e-3 of its max, the same zero rows."""
    name = "scene_83x45"
    feat, ranges, n_tx, n_ty, W, H = _plan(name)
    fj, rj = jnp.asarray(feat.numpy()), jnp.asarray(ranges.numpy())
    img, _ = jtk._fwd_impl(fj, rj, n_tx, n_ty, W, H, interpret=True,
                           with_ntouch=False, mxu=True)
    asm = np.asarray(jtk.assemble_image(img, n_tx, n_ty, W, H))
    cot_img = jtk.disassemble_image(jnp.asarray(_cot(H, W)), n_tx, n_ty)
    ref = np.asarray(jtk._bwd_impl(fj, rj, img, cot_img, n_tx, n_ty, W, H,
                                   interpret=True, mxu=True))
    got = _port_rows(name, asm, mxu=True)
    for col in range(ttk.N_ROWS):
        a = ref[:, col]
        assert np.abs(a).max() > 0, col
        np.testing.assert_allclose(got[:, col], a, rtol=2e-3,
                                   atol=2e-5 + 2e-3 * np.abs(a).max(),
                                   err_msg=f"column {col}")
    assert not got[:, ttk.N_ROWS:].any()
    np.testing.assert_array_equal(~got.any(axis=1), ~ref.any(axis=1))


# ---------------------------------------------------------------------------
# the cells the sub-tile backward evaluates
# ---------------------------------------------------------------------------

def _literal_cells(feat, ranges, n_tx, n_ty, stop_at, bf16, mxu):
    """subtile_cells by a literal loop over tiles, warps' 8x4 blocks and
    64-row chunks (a warp walks a chunk while one of its pixels is not
    done at the chunk's start)."""
    kept = rected = 0
    for t in range(n_tx * n_ty):
        a, b = (int(v) for v in ranges[t])
        tx, ty = t % n_tx, t // n_tx
        centre = ((torch.tensor(tx * 32 + 15.5), torch.tensor(ty * 32 + 15.5))
                  if mxu else None)
        for blk in range(32):
            bx, by = (blk % 4) * 8, (blk // 4) * 4
            q = [(by + j) * 32 + bx + i for j in range(4) for i in range(8)]
            last = int(stop_at[t, q].max())
            x0, y0 = tx * 32 + bx, ty * 32 + by
            for r in range(a, b):
                if (r - a) // ttk.SUB_CHUNK * ttk.SUB_CHUNK > last:
                    break
                f = feat[r]
                cx, cy = float(x0 // 16), float(y0 // 16)
                if not (f[10] <= cx < f[12] and f[11] <= cy < f[13]):
                    continue
                rected += 32
                kept += 32 * bool(ttk.block_keep_plain(
                    f, torch.tensor(float(x0)), torch.tensor(float(y0)),
                    centre=centre, bf16=bf16 and not mxu))
    return kept, rected


def _bwd_cells(body):
    """(subtile_cells, included cells, tile-walk pairs, plan) of the
    backward walk of ``body`` on a seeded scene's 32-px plan at 83x45,
    counted in small batches."""
    bf16, mxu = BODIES.get(body, (False, False))
    args = _bwd_args("scene_83x45", bf16, mxu)
    _, walked, inc, stop = ttk.plain_bwd_walk(*args, bf16=bf16, mxu=mxu,
                                              done_at=True)
    feat, ranges, n_tx, n_ty = args[0], args[1], args[8], args[9]
    got = ttk.subtile_cells(feat, ranges, n_tx, n_ty, stop, mxu=mxu,
                            bf16=bf16, batch=97)
    assert got == _literal_cells(feat, ranges, n_tx, n_ty, stop, bf16, mxu)
    return got, int(inc), int(walked.sum())


@pytest.mark.parametrize("body", ["f32", "bf16", "mxu", "bf16_mxu"])
def test_subtile_cells_under_the_backward_stops(body):
    """subtile_cells with the stop offsets of the backward walk of each
    body (a seeded scene's 32-px plan at 83x45) against a literal count;
    the count lies between the included cells and the tile-walk's. Under
    both flags the cells are the mxu body's: the same falloff, tests,
    transmittance and margin (bf16 rounds only the products)."""
    got, inc, walked = _bwd_cells(body)
    assert inc <= got[0] < got[1] <= walked * ttk.P
    if body == "bf16_mxu":
        assert got == _bwd_cells("mxu")[0]


if __name__ == "__main__":
    _jax_bf16_backward(sys.argv[1], sys.argv[2])

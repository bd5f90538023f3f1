"""The port's ``entry()`` (graft_entry.py) against the repository's
``__graft_entry__.entry()``: the same cloud (scenes.make_cloud against
__graft_entry__._scene) and the forward render of the tiled renderer on
the same numpy inputs, at a small cloud and size (the JAX side's Pallas
kernel in interpret mode; the port's plain version on the CPU). Color
and opacity within 1e-5; depth, which spans metres, within
tests/test_torch_render.py's 2e-4 (it reads ~1.5e-5 here)."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch import graft_entry

torch.set_num_threads(1)

N, W, H, FOCAL = 600, 96, 64, 48.0


def test_entry_workload_shapes():
    """At its defaults the entry is the flagship workload: the 50k cloud
    at 1200x680, fx = fy = 600 (built on the CPU here, not rendered)."""
    fn, args = graft_entry.entry(device="cpu")
    means, cov6, opac, shs, w2c, proj, tau, bg = args
    assert means.shape == (50_000, 3) and cov6.shape == (50_000, 6)
    assert opac.shape == (50_000,) and shs.shape == (50_000, 1, 3)
    assert torch.equal(w2c, torch.eye(4))
    assert not tau.any() and not bg.any()
    assert graft_entry.ENTRY_PAIR_CAP == 1 << 20


def test_entry_matches_jax_entry():
    import jax.numpy as jnp
    import __graft_entry__ as jentry
    from gs_slam_analytica_jacobian_tpu.ops import renderer_tiled as jrt

    fn, args = graft_entry.entry(n=N, width=W, height=H, focal=FOCAL,
                                 device="cpu")
    jargs = jentry._scene(N, W, H, FOCAL, FOCAL)
    for a, b in zip(args[:6], jargs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    color, depth, opacity = fn(*args)
    assert color.shape == (3, H, W)
    assert depth.shape == opacity.shape == (1, H, W)
    ref = jrt.render(*jargs[:4], 0, *jargs[4:], jnp.zeros(6), FOCAL, FOCAL,
                     W, H, W / (2 * FOCAL), H / (2 * FOCAL), jnp.zeros(3),
                     pair_capacity=graft_entry.ENTRY_PAIR_CAP, interpret=True)
    assert int(ref.overflow) == 0
    for got, want, tol in ((color, ref.color, 1e-5),
                           (depth, ref.depth, 2e-4),
                           (opacity, ref.opacity, 1e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
    assert float(opacity.max()) > 0.5


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()

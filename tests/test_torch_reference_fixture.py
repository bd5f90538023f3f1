"""``load_reference_fixture`` of both packages (the root jacobian_test.py
and the port's) on the same scripted reference artifacts written to
tmp_path: a TorchScript module with the reference's parameter layout (as
tests/test_datasets_live.py writes one), w2c_gt.txt / T_noise.txt, and
the frame as color/depth/mask .npy. The two fixtures must be equal."""

import numpy as np
import pytest
import torch

from gs_slam_analytica_jacobian_tpu_torch import jacobian_test as tlab

torch.set_num_threads(1)


def write_artifacts(tmp_path, n=23, k_rest=15, H=12, W=16):
    rng = np.random.default_rng(0)
    arrays = dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, k_rest, 3)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            # registration order == the reference's load_tensors order
            for k in ("xyz", "features_dc", "features_rest", "opacity",
                      "scaling", "rotation"):
                setattr(self, k, torch.nn.Parameter(
                    torch.from_numpy(arrays[k])))

        def forward(self):
            return self.xyz

    pt = tmp_path / "optimized_params_small.pt"
    torch.jit.save(torch.jit.script(M()), str(pt))
    data = tmp_path / "data"
    data.mkdir()
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    noise = np.eye(4)
    noise[:3, 3] = [0.01, 0.0, -0.02]
    np.savetxt(data / "w2c_gt.txt", w2c)
    np.savetxt(data / "T_noise.txt", noise)
    np.save(data / "color.npy", rng.uniform(size=(H, W, 3)))
    np.save(data / "depth.npy", rng.uniform(0.5, 2.0, size=(H, W)))
    np.save(data / "mask.npy", rng.uniform(size=(H, W)))
    return str(pt), str(data), arrays


@pytest.mark.parametrize("k_rest", [15, 0])
def test_reference_fixture_matches_jax(tmp_path, k_rest):
    import jacobian_test as jlab
    pt, data, arrays = write_artifacts(tmp_path, k_rest=k_rest)
    a = tlab.load_reference_fixture(pt, data)
    b = jlab.load_reference_fixture(pt, data)
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a["features"].shape == (23, 1 + k_rest, 3)
    np.testing.assert_array_equal(a["features"][:, :1],
                                  arrays["features_dc"])
    np.testing.assert_array_equal(a["xyz"], arrays["xyz"])
    assert a["mask"].dtype == bool and a["fx"] == 577.5

"""The port's monocular SLAM against the JAX package's
``SLAM(interpret=True)``: tests/test_torch_slam_parity_sensors.py's
``mono_config`` (tests/test_torch_slam_sensors.py::test_slam_mono_smoke
with the parity cuts at 40x32). The initial-depth noise comes from
``np.random.default_rng(seed)`` on the host in both packages. Checks: the
same keyframe ids, every keyframe pose within 2e-3, ATE within 10%."""

import torch

from test_torch_slam_parity_sensors import _check_parity, _run_both, \
    mono_config

torch.set_num_threads(1)


def test_slam_mono_parity_with_jax():
    _check_parity(*_run_both(mono_config))

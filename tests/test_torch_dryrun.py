"""``dryrun_multichip`` of the port (graft_entry.py) on 2 gloo ranks on
the CPU: each rank prints the three lines of the repository's
``__graft_entry__.dryrun_multichip`` (the sharded step, the integrated
``mapping_steps``, the slab model-parallel loss and gradients) under the
same gates, and the ranks agree on every loss."""

import re

import numpy as np
import torch

from gs_slam_analytica_jacobian_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_dryrun_multichip_two_ranks(capfd):
    recs = graft_entry.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for r in range(2):
        who = re.escape(f"dryrun_multichip(2) rank {r}")
        assert re.search(who + r": loss=\d+\.\d{4} max\|dxyz\|=", out), out
        assert re.search(who + r" integrated mapping_steps: loss=\d+\.\d{4} "
                         r"n_touched>0: [1-9]\d*", out), out
        assert re.search(who + r" slab model-parallel: loss=\d+\.\d{4} "
                         r"max\|dL/dxyz\|=", out), out
    assert [r["rank"] for r in recs] == [0, 1]
    for part in ("step", "integrated", "slab"):
        assert recs[0][part]["loss"] == recs[1][part]["loss"]
        assert np.isfinite(recs[0][part]["loss"])
    assert recs[0]["step"]["max_dxyz"] > 0
    assert recs[0]["integrated"]["n_touched_pos"] > 0
    assert recs[0]["slab"]["max_dxyz_grad"] > 0
    # the slab loss is the reference dry run's (the same scene and frame,
    # MULTICHIP_r05.json: 0.4469)
    assert abs(recs[0]["slab"]["loss"] - 0.4469) < 1e-3
    # no kernel launches on the CPU: the plain versions ran
    assert not any(recs[0]["slab"]["launches"].values())

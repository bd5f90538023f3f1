"""The roofline's work count on a tiny plan against a hand count."""

import math

import torch

from benchmark import work
from benchmark.reference import render as rr


def row(mx, my, a, opa, rect, color=(0.5, 0.5, 0.5), depth=1.0):
    return [mx, my, a, 0.0, a, opa, *color, depth, *rect, 0.0, 0.0]


def test_walk_counts_against_a_hand_count():
    # one 32-px tile, three pairs front to back: a small splat in the
    # 16-px cell (0, 0); the same splat restricted by its rect to cell
    # (1, 0), where it is under 1/255 everywhere; a flat opaque splat over
    # cell (0, 0)
    feat = torch.tensor([row(5.0, 5.0, 1.0, 0.5, (0, 0, 1, 1)),
                         row(5.0, 5.0, 1.0, 0.5, (1, 0, 2, 1)),
                         row(0.0, 0.0, 0.0, 0.99, (0, 0, 1, 1))])
    ranges = torch.tensor([[0, 3]], dtype=torch.int32)
    out = rr.walk(rr.tile_lists(feat, ranges, 1, 32, 32), need_image=False)
    small = sum(1 for x in range(16) for y in range(16)
                if 0.5 * math.exp(-0.5 * ((x - 5) ** 2 + (y - 5) ** 2))
                >= 1 / 255)
    assert out["passed"] == small + 256
    assert out["included"] == small + 256

    least = work.bwd_least_s(3, 3, 1, 32, 32, out["included"])
    nbytes = 3 * 64 + 3 * 64 + 8 + 10 * 32 * 32 * 4
    assert least == max(nbytes / 3.35e12, (small + 256) * 84 / 67e12)
    # the recorder keeps every second differentiated call and pairs it
    # with its backward kernel's time in launch order; a forward-only call
    # is not counted
    calls = work.Calls(2)
    composite = calls.wrap(lambda *a: None)
    composite(feat.detach(), ranges, 1, 1, 32, 32, False)
    for _ in range(3):
        composite(feat.requires_grad_(True), ranges, 1, 1, 32, 32, False)
    got = calls.shares({"bwd": [2e-3, 5.0, 4e-3]}, rr.walk, rr.tile_lists)
    assert got == {"bwd": 100.0 * 2 * least / 6e-3}
    # kernels that do not pair one to one with the calls: left out
    calls = work.Calls(1)
    calls.wrap(lambda *a: None)(feat, ranges, 1, 1, 32, 32, False)
    assert calls.shares({"bwd": []}, rr.walk, rr.tile_lists) == {}


def test_termination_stops_the_count():
    # two flat opaque splats: the second takes T from 0.01 to 1e-4 * ...;
    # a third behind them is never walked at pixels already done
    flat = [row(0.0, 0.0, 0.0, 0.99, (0, 0, 1, 1)) for _ in range(4)]
    feat = torch.tensor(flat)
    ranges = torch.tensor([[0, 4]], dtype=torch.int32)
    out = rr.walk(rr.tile_lists(feat, ranges, 1, 16, 16, tile=16),
                  need_image=False)
    # T: 1 -> 0.01 -> 1e-4 (not below) or terminates; either way each of
    # the 256 pixels passes at most 3 pairs and blends at most 2
    assert 256 * 2 <= out["passed"] <= 256 * 3
    assert out["included"] <= out["passed"]

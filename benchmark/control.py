"""Readings of a cell's compared numbers, for setting its limits: each
seed's run of the program with, beside each number, its control (the
program's lower-precision path, or the reference at the next lower
precision, in the program's place), or the program with a fault planted
in its timed path. One process runs every seed.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--fault unchanged|half_batch|altered]

Prints one JSON line per seed: {"seed", "fault", "checks": {name: value},
"notes"}. The benchmark's own runs never run a control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

FAULTS = ("unchanged", "half_batch", "altered")


def readings(workload: str, seeds, seconds: float, device, fault=None,
             overrides=None):
    """[(seed, Run)] of the cell, under the control or with ``fault``;
    ``overrides`` is a function that edits (config, traffic, cell) in
    place (the tests shrink the cell with it)."""
    bench = harness.load_bench()
    out = []
    for seed in seeds:
        wl, config, traffic, cell = harness.resolve(bench, workload)
        if overrides is not None:
            overrides(config, traffic, cell)
        ctx = harness.Context(
            workload=wl, config=config, traffic=traffic, cell=cell,
            seed=int(seed), seconds=float(seconds), trace=False,
            device=device, t_start=time.perf_counter(),
            control=fault is None, fault=fault)
        out.append((seed, harness.run_cell(ctx)))
        gc.collect()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=FAULTS, default=None)
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, run in readings(args.workload, seeds, args.seconds,
                              torch.device("cuda", 0), fault=args.fault):
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "checks": {c.name: c.value for c in run.checks},
                          "end_to_end": run.end_to_end,
                          "notes": run.notes}, default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    harness.process_env()
    sys.exit(main())

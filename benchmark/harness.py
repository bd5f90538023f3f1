"""One run of a benchmark cell: finds the cell by name, runs it, prints it.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- a configuration is ``configs/<name>.json`` (its ``file``): the
  deployment's settings as they are run;
- a traffic mix is ``traffic/<name>.json``: the parameters one general
  generator reads, and the loop (``loops/<loop>.py``) that drives the
  program with it;
- a cell's limits, the numbers its check compares with, are
  ``cells/<workload>.json``;
- a per-layer metric is ``metrics/<name>.py``, whose ``read(run)`` returns
  the metric from the run's counters, spans and trace, or None when there
  is nothing to read (the metric is then left out).

A loop's ``run(ctx)`` sets up, measures for ``ctx.seconds`` and checks the
timed path's outputs against the plain reference (``reference/``); it
returns a ``Run``. With ``--trace 1`` it also profiles part of its window
(``devtrace.py``) and the per-layer metrics are reported instead of the
end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that may not be loaded in the process that prints a result: JAX
# and the JAX package (compared by whole top-level names: the port's own
# name starts with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gs_slam_analytica_jacobian_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct needs value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a loop hands back."""
    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None       # devtrace.reduce(...)
    work: Optional[dict] = None        # roofline work of the traced part
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    # a fault planted in the timed path (benchmark/control.py, the tests)
    fault: Optional[str] = None
    # beside each compared number, its control: the program's
    # lower-precision path or the reference at the next lower precision
    control: bool = False


# the host CPUs a run's process is held to: the last of those it may use
PINNED_CPUS = 2


def process_env():
    """The environment a run's process keeps, set before torch loads:
    every build and kernel cache at a fixed place inside the checkout
    (the program's own CUDA builds go to build/torch_kernels/), one host
    thread for the CPU side of torch (the loops are launch-bound, and idle
    worker threads spinning beside the launching one make the host's
    speed, and the walls, vary between processes), and the process and
    every thread it starts held to the same ``PINNED_CPUS`` host CPUs, so
    that the scheduler does not move the launching thread between cores
    or sockets."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if hasattr(os, "sched_setaffinity"):
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cpus[-PINNED_CPUS:])


def host_state() -> dict:
    """What the host and the card run at, for telling a slow run's cause:
    the process's CPUs and their clocks, the load, and the card's SM and
    memory clocks, temperature, power draw and performance state."""
    out = {"load": os.getloadavg()}
    if hasattr(os, "sched_getaffinity"):
        cpus = sorted(os.sched_getaffinity(0))
        out["cpus"] = cpus
        try:
            with open("/proc/cpuinfo") as f:
                mhz = [float(line.split(":")[1]) for line in f
                       if line.startswith("cpu MHz")]
            out["cpu_mhz"] = [mhz[c] for c in cpus if c < len(mhz)]
        except (OSError, ValueError, IndexError):
            pass
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
             "temperature.gpu,power.draw,pstate", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        out["card"] = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(bench: dict, name: str, root: str = ROOT):
    """(workload, configuration, traffic, cell file) of the cell
    ``name``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     wl["traffic"] + ".json"))
    cell = load_json(os.path.join(HERE, "cells", name + ".json"))
    return wl, config, traffic, cell


def metrics_of(bench: dict, wl_name: str):
    """(end-to-end specs, per-layer specs) that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if wl_name in m.get("workloads", [wl_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (wl_name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(ctx: Context) -> Run:
    loop = importlib.import_module("benchmark.loops." + ctx.traffic["loop"])
    return loop.run(ctx)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def result_line(bench: dict, ctx: Context, run: Run, device: dict) -> dict:
    e2e, layer = metrics_of(bench, ctx.workload["name"])
    metrics = {}
    if ctx.trace:
        for m in layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(run.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    correct = bool(run.checks) and all(c.ok for c in run.checks)
    out = {"correct": correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if ctx.trace and run.trace is not None:
        out["device"] = dict(device, busy_s=run.trace["busy_s"],
                             window_s=run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    return out


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_bench()
    wl, config, traffic, cell = resolve(bench, args.workload)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"{wl['name']} needs {wl['chips']} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    ctx = Context(workload=wl, config=config, traffic=traffic, cell=cell,
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=dev, t_start=t_start)
    run = run_cell(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(wl["chips"]),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = result_line(bench, ctx, run, device)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    card = card_power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for k, v in run.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0

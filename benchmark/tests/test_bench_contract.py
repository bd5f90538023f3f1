"""BENCHMARK.json against the benchmark's contract, and the files each
name in it resolves to (configurations, traffic, cells, loops, metric
readers)."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def all_names():
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(key, e["name"]) for e in BENCH[key]]
    out += [("traffic", w["traffic"]) for w in BENCH["workloads"]]
    out += [("config", w["config"]) for w in BENCH["workloads"]]
    out += [("reduced", r) for c in BENCH["configs"] for r in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", all_names())
def test_name_rules(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_rules(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("unit,ok", [("ms", True), ("tokens/s", True),
                                     ("%", True), ("a b", False),
                                     ("x" * 17, False), ("µs", False)])
def test_unit_pattern(unit, ok):
    assert bool(UNIT.match(unit)) == ok


@pytest.mark.parametrize("name,ok", [("replica-track", True),
                                     ("launches_per_iter.map", True),
                                     ("a,b", False), ("a/b", False),
                                     (".x", False), ("x" * 65, False)])
def test_name_pattern(name, ok):
    assert bool(NAME.match(name)) == ok


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(wl):
    """Configuration, traffic, limits, loop and readers of every cell."""
    w, config, traffic, cell = harness.resolve(BENCH, wl["name"])
    assert w["chips"] == 1
    assert config["name"] == wl["config"]
    importlib.import_module("benchmark.loops." + traffic["loop"])
    e2e, layer = harness.metrics_of(BENCH, wl["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.load_reader(m["name"]))
    assert cell["limits"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("benchmark/")
    assert cfg["source"].startswith("https://")
    with open(os.path.join(harness.ROOT, cfg["file"])) as f:
        data = json.load(f)
    # the configuration's file names every key it cut, with the reason
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_readers_leave_out_what_they_cannot_read():
    empty = harness.Run(end_to_end={}, checks=[], attempted=0, failed=0,
                        memory_peak_bytes=0)
    for m in BENCH["per_layer"]:
        assert harness.load_reader(m["name"])(empty) is None, m["name"]

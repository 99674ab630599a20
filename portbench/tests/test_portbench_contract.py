"""BENCHMARK.json against its format: names, units and
lengths in the allowed characters, every cell's files found by name, and
every metric's reader present."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_are_allowed(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metrics_keys_units_and_sources(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").exists()
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_unique_names_and_used_configs():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(cell):
    assert cell["chips"] in (1, 4)
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    cfile = json.loads((ROOT / conf["file"]).read_text())
    assert cfile["name"] == conf["name"] and cfile["reduced"] == conf["reduced"]
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["kind"] in cfile["control"]
    limits = json.loads((ROOT / "portbench" / "cells" / f"{cell['name']}.json").read_text())
    assert limits["limits"]
    e2e = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert len(e2e) >= 2
    per_layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [])]
    assert per_layer


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer

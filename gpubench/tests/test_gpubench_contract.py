"""BENCHMARK.json keeps to the benchmark's contract, and every cell, its
configuration, its traffic mix and its per-layer metrics are found by name
from files of their own."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            extra = set(entry) - KEYS[group] - ({"workloads"} if group in (
                "end_to_end", "per_layer") else set())
            assert set(entry) >= KEYS[group] and not extra, (group, entry["name"])


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)
        for key in e.get("reduced", []):
            assert NAME.match(key)
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)


def test_metrics_rules():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert any(cell in m.get("workloads", cells) and m["name"] != "setup_s"
                   for m in BENCH["end_to_end"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_each_piece_found_by_name():
    from gpubench import generator, run

    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert "assumed" in config and "guarantees" in config
    for w in BENCH["workloads"]:
        cell, config, e2e, per_layer = run.load_cell(w["name"])
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").is_file()
        mix = generator.load(w["traffic"], config)
        assert mix.unit_size > 0 and mix.batch_size > 0
        assert [m["name"] for m in e2e] == ["transitions_per_s", "setup_s"]
        for m in per_layer:
            assert callable(run.load_reader(m["name"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fit_the_check():
    # a full check with 24 cells: 2 + 14 runs a cell, each allowed its
    # seconds and 60 more, 2 x 90 s of compile a cell, and 1200 s spare
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200

"""CPU tests of ``BENCHMARK.json`` and of finding each piece of a cell by
name: the character rules of names and units, the keys each entry may
have, and the files of every configuration, traffic mix, check and metric.

    python -m pytest benchmark -q
"""
import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.runners.base import Runner

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_and_names(section):
    for entry in MANIFEST[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry
        assert NAME.match(entry["name"]), entry["name"]
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
                assert "\t" not in entry[text]
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert len(layer) <= 200 and "\n" not in layer


def test_cells_use_their_configs():
    configs = {c["name"] for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("benchmark/")
    data = json.loads(path.read_text())
    assert data["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    assert all(NAME.match(k) for k in config["reduced"])
    assert data["precision"]["compute"] == "bfloat16"
    assert data["precision"]["parameters"] == "float32"
    assert data["config"]["Arch"]["max_channel"] == 512


@pytest.mark.parametrize("workload", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(workload):
    cell = harness.load_cell(workload["name"], MANIFEST)
    assert issubclass(harness.runner_class(cell.traffic["kind"]), Runner)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]))


def test_every_file_name_keeps_the_rules():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel

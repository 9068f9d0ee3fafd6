"""``BENCHMARK.json`` against the files it names and the rules a benchmark
file keeps: names and units in the allowed characters, every entry's keys,
every per-layer metric's cells reporting the metric it moves, at most a
quarter of the cells (one at least) on four chips, a reader for every
metric, a workload file and a traffic file for every cell, and a full
check's time inside its budget."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

from portbench.harness import spec

BENCH = spec.load_benchmark()
WIDTH = re.compile(r"(_dims?$|_rank$|hidden_size|intermediate|latent|state_size|projection|head_dim|expansion|"
                   r"experts_per_tok|embed|width)", re.IGNORECASE)
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    command, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(paths) <= 16 and len(command) <= 32
    for path in paths:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert (ROOT / path).is_dir()
    for word in command:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


def _names(entries):
    return [entry["name"] for entry in entries]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(section):
    names = _names(BENCH[section])
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME_RE.match(name), name


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files)) and 1 <= len(BENCH["configs"]) <= 24
    for config in BENCH["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["name"] in used
        assert TEXT.match(config["source"]) and TEXT.match(config["why"])
        assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
        assert data["source"] == config["source"]
        assert len(config["reduced"]) <= 16
        for key in config["reduced"]:
            assert spec.NAME_RE.match(key) and not WIDTH.search(key), key


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for cell in cells:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and TEXT.match(cell["why"])
        assert spec.NAME_RE.match(cell["traffic"]) and cell["config"] in _names(BENCH["configs"])
        loaded = spec.load_cell(cell["name"])  # raises where a file disagrees
        assert loaded.workload["why"] == cell["why"]
        assert set(loaded.limits) >= {"policy_mean_rel", "loss_rel"}, "every cell's check has limits"
        assert all(isinstance(v, (int, float)) and v >= 0 for v in loaded.limits.values())


def test_metrics_entries():
    cells = set(_names(BENCH["workloads"]))
    end_to_end = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in end_to_end and 1 <= len(end_to_end) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    layers = {}
    for metric in BENCH["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in SOURCES and TEXT.match(metric["layer"])
        assert metric["moves"] in end_to_end
        layers.setdefault(metric["layer"].lower(), set()).add(metric["layer"])
    assert all(len(spellings) == 1 for spellings in layers.values()), "one layer, one spelling"
    for metric in [*BENCH["end_to_end"], *BENCH["per_layer"]]:
        assert spec.UNIT_RE.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert set(metric.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file(), metric["name"]
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in _names(BENCH["workloads"]):
        loaded = spec.load_cell(cell)
        names = _names(loaded.end_to_end)
        assert "setup_s" in names and len(names) >= 2 and loaded.per_layer


def test_per_layer_cells_report_what_they_move():
    for metric in BENCH["per_layer"]:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", _names(BENCH["workloads"])):
            assert cell in moved.get("workloads", [cell]), (metric["name"], cell)


def test_a_full_check_fits_its_time_with_the_full_24_cells():
    seconds = BENCH["run_seconds"]
    total = (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_file_names_under_paths_use_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        relative = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", relative), relative

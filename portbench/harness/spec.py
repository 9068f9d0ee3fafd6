"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root and the
files it names by name under ``portbench/``.

* ``configs/<config>.json``: one configuration (the zoo entry, the
  overrides, the published counts, ``source``, ``reduced``, ``assumed``);
* ``traffic/<traffic>.json``: one traffic mix (environments per chip,
  iterations per dispatch, and why);
* ``workloads/<cell>.json``: one cell (its configuration, traffic and
  chips, as ``BENCHMARK.json`` has them, its ``why``, and the limits of
  the numbers that decide ``correct``);
* ``metrics/<metric>.py``: one metric's reader, ``read(run)``.

Everything is found by name; nothing here knows a particular cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["BENCH_DIR", "Cell", "ROOT", "load_benchmark", "load_cell", "load_reader", "NAME_RE", "UNIT_RE"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    chips: int
    end_to_end: list   # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list    # and with --trace 1

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` with its files; raises ``KeyError`` for a cell the
    benchmark does not list and ``ValueError`` where a file disagrees with
    ``BENCHMARK.json``."""
    benchmark = benchmark if benchmark is not None else load_benchmark(bench_dir.parent)
    entry = next((w for w in benchmark["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    config = _read_json(bench_dir.parent / config_entry["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    workload = _read_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json gives {key}={workload.get(key)!r}, BENCHMARK.json {entry[key]!r}")
    if config.get("name") != entry["config"]:
        raise ValueError(f"{config_entry['file']} names {config.get('name')!r}, not {entry['config']!r}")
    return Cell(name, config, traffic, workload, entry["chips"],
                [m for m in benchmark["end_to_end"] if _reports(m, name)],
                [m for m in benchmark["per_layer"] if _reports(m, name)])


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<metric>.py`` (a name may hold dots)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

"""The limits of the numbers that decide ``correct``, from readings.

    python3 portbench/harness/limits.py readings.jsonl [more.jsonl ...]

reads the rows that ``run.py --readings K`` prints (one JSON object a
seed: ``program``, and on the first seeds ``control`` and each planted
fault), and the result lines of the cell's runs (the program's readings
on their seeds), and prints, for every compared number (``check.COMPARED``), its two
readings and the limit set between them:

* the lower reading is the largest the program gives over the seeds;
* the upper reading is the least of: the control's smallest reading, where
  it is three times the lower or more; each fault's smallest reading, where
  it is ten times the lower or more (a state left unchanged: three times);
* the limit is ``lower ** 0.4 * upper ** 0.6``: inside both, with more
  room above the lower reading (fresh seeds read higher) than below the
  upper one.

A number that has no upper reading gets no limit and is not compared.
The last line printed is ``{"limits": {...}}``, with the exact
comparisons' 0 (``check.EXACT``), to copy into the cell's workload file.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness.check import COMPARED, EXACT  # noqa: E402

FAULTS = {"half_batch": 10.0, "unchanged_state": 3.0}
CONTROL_FACTOR = 3.0
WEIGHT_UPPER = 0.6

__all__ = ["COMPARED", "limits"]


def _least(rows, key, name):
    values = [row[key][name] for row in rows if key in row and row[key].get(name) is not None]
    return min(values) if values else None


def limits(rows: list[dict], names=COMPARED) -> dict:
    """``{name: {"lower", "upper", "upper_from", "limit"}}``; ``limit`` None
    where no reading bounds the number from above."""
    out = {}
    for name in names:
        lower = max(row["program"][name] for row in rows)
        candidates = []
        control = _least(rows, "control", name)
        if control is not None and control >= CONTROL_FACTOR * lower:
            candidates.append((control, "control"))
        for fault, factor in FAULTS.items():
            value = _least(rows, fault, name)
            if value is not None and value >= factor * lower:
                candidates.append((value, fault))
        upper, source = min(candidates) if candidates else (None, None)
        limit = None if upper is None else lower ** (1 - WEIGHT_UPPER) * upper ** WEIGHT_UPPER
        out[name] = {"lower": lower, "upper": upper, "upper_from": source, "limit": limit}
    return out


def _row(line: dict) -> dict:
    """A readings row as it is, or a run's result line as the program's
    reading (its compared numbers and ``info``)."""
    if "checks" not in line:
        return line
    return {"seed": line["info"]["seed"],
            "program": {**line["info"], **{name: entry["value"] for name, entry in line["checks"].items()}}}


def main(paths: list[str]) -> None:
    rows = []
    for path in paths:
        with open(path) as f:
            rows += [_row(json.loads(line)) for line in f if line.startswith("{")]
    table = limits(rows)
    print(f"{len(rows)} seeds, {sum('control' in r for r in rows)} with the control and faults")
    for name, entry in table.items():
        print(f"{name}: lower {entry['lower']:.6g}, upper {entry['upper']} ({entry['upper_from']}), "
              f"limit {entry['limit']}")
    found = {k: float(f"{v['limit']:.4g}") for k, v in table.items() if v["limit"]}
    print(json.dumps({"limits": {**found, **EXACT}}))


if __name__ == "__main__":
    main(sys.argv[1:])

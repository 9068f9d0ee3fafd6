"""A CPU rehearsal of a run: a tiny cell whose benchmark entry, traffic,
workload and cut configuration the test writes itself, driven through
``runner.run_cell`` as ``run.py`` drives it (``run.py`` itself refuses a
machine without the cards), untraced and traced; and ``run.py``'s refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, tiny_config

from portbench.harness import runner, spec

LOOSE = {"policy_mean_rel": 0.05, "value_rel": 0.05, "advantage_rel": 0.05, "loss_rel": 0.05,
         "grad_norm_median_gap": 0.05, "param_change_median_gap": 0.05, "plan_steps_differ": 0}


def _tiny_bench(tmp_path, config_name: str, limits: dict) -> spec.Cell:
    bench = spec.load_benchmark()
    config = tiny_config(spec._read_json(ROOT / f"portbench/configs/{config_name}.json"))
    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "workloads"):
        (root / "bench" / sub).mkdir(parents=True)
    (root / "bench/configs/tiny.json").write_text(json.dumps({**config, "name": "tiny"}))
    (root / "bench/traffic/e64.json").write_text(json.dumps(
        {"environments_per_chip": 64, "iterations_per_dispatch": 2, "why": "tiny"}))
    (root / "bench/workloads/tiny.e64.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "e64", "chips": 1, "why": "tiny", "limits": limits}))
    entry = {"name": "tiny.e64", "config": "tiny", "traffic": "e64", "chips": 1, "why": "tiny"}
    benchmark = {**bench, "configs": [{"name": "tiny", "source": "test", "file": "bench/configs/tiny.json",
                                       "reduced": [], "why": "tiny"}],
                 "workloads": [entry],
                 "end_to_end": [{k: v for k, v in m.items() if k != "workloads"} for m in bench["end_to_end"]],
                 "per_layer": [{k: v for k, v in m.items() if k != "workloads"} for m in bench["per_layer"]]}
    return spec.load_cell("tiny.e64", benchmark, root / "bench")


@pytest.mark.parametrize("config_name", ["velocity_rough_mlp", "velocity_flat_transformer"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_runs_end_to_end(tmp_path, config_name, traced):
    cell = _tiny_bench(tmp_path, config_name, LOOSE)
    result = runner.run_cell(cell, 2 ** 31 + 101, 0.5, traced, device="cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(LOOSE)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 2 and result["attempted"] % 2 == 0  # whole chunks of 2 iterations
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    json.dumps(result)  # one JSON line
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"} and "busy_s" in result["device"]
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert result["metrics"]["wall_env_steps_per_s"]["value"] > 0
    else:
        assert result["metrics"]["setup_s"]["value"] > 0
        # no device: the readers of the card's time and memory find nothing
        assert "peak_mem_gib" not in result["metrics"] and "device_ms_per_iter" not in result["metrics"]


def test_a_limit_that_a_number_exceeds_makes_the_run_incorrect(tmp_path):
    cell = _tiny_bench(tmp_path, "velocity_rough_mlp", {**LOOSE, "policy_mean_rel": 1e-9})
    result = runner.run_cell(cell, 2 ** 31 + 102, 0.2, False, device="cpu")
    assert result["correct"] is False and result["checks"]["policy_mean_rel"]["limit"] == 1e-9


def _run_py(*args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def test_run_py_refuses_a_cell_it_does_not_list():
    done = _run_py("--workload", "no_such.cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert done.returncode == 2 and done.stdout == ""


def test_run_py_refuses_a_machine_without_the_cards():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    name = spec.load_benchmark()["workloads"][0]["name"]
    done = _run_py("--workload", name, "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0")
    assert done.returncode == 3 and done.stdout == "" and "needs 1 CUDA device" in done.stderr

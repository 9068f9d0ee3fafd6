"""Shared by the benchmark's CPU tests: the checkout on ``sys.path``, few
threads, and tiny cells (a configuration of the benchmark cut to widths and
sizes that a test run holds)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(4)

from portbench.harness import spec  # noqa: E402

# What each kind of configuration is cut to: fewer steps, and for the MLP
# narrower layers (the transformer keeps its widths; 64 environments hold it).
TINY = {"mlp": {"num_steps_per_update": 8, "actor_hidden_dims": [64, 32, 32], "critic_hidden_dims": [64, 32, 32]},
        "transformer": {"num_steps_per_update": 8}}


def tiny_config(config: dict) -> dict:
    """``config`` cut to ``TINY``, the cut given to the zoo entry as
    overrides."""
    config = copy.deepcopy(config)
    small = TINY[config["kind"]]
    config["agent"].update(small)
    config["overrides"] = dict(small)
    return config


def tiny_cell(name: str, envs: int = 64, per_chunk: int = 2) -> spec.Cell:
    """The benchmark's cell ``name`` (its limits included) at a tiny size."""
    cell = spec.load_cell(name)
    cell.config = tiny_config(cell.config)
    cell.traffic = {**cell.traffic, "environments_per_chip": envs, "iterations_per_dispatch": per_chunk}
    return cell


def cells() -> list[str]:
    return [w["name"] for w in spec.load_benchmark()["workloads"] if w["chips"] == 1]

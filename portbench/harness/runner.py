"""A run of a cell: the run, the check, the metrics, the result line.

``run_cell`` runs the cell (``session.run``), frees the program's state,
runs the check (``check``) and the metric readers (``metrics/<name>.py``),
and returns the result object that ``run.py`` prints.  ``readings`` runs
set-up and the first chunk only, for several seeds in one process, and
returns each seed's numbers for the program, for the control (the
reference one precision below the configuration's) and for each planted
fault: the readings the limits are set from.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys

import torch

from portbench.harness import check, spec
from portbench.harness.session import run
from portbench.work.schedule import kernel_calls, model_flops, sizes_of

__all__ = ["Context", "FAULTS", "FORBIDDEN_MODULES", "forbidden_modules", "readings", "run_cell"]

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cusrl_tpu")


def forbidden_modules() -> list[str]:
    """The JAX modules this process holds, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: spec.Cell
    run: object           # session.Run
    device_name: str

    @property
    def sizes(self):
        return sizes_of(self.cell.config, self.cell.traffic)

    @property
    def trace(self):
        return self.run.trace

    def kernel_calls(self):
        return kernel_calls(self.sizes)

    def model_flops(self) -> float:
        return model_flops(self.sizes)


def _free() -> None:
    """Returns the device memory of objects dropped by the caller (the
    Trainer holds reference cycles through its hooks)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _program(result) -> tuple[dict, check.Program]:
    """The recorded rollout, and the program's outputs as the check reads
    them."""
    capture = result.capture
    rollout = {k: capture.rollout[k] for k in ("raw_observation", "raw_next_observation", "action", "reward",
                                                "terminated", "truncated")}
    program = check.Program(mean=capture.rollout["mean"], observation=capture.rollout["observation"],
                            value=capture.update["value"], advantage=capture.update["advantage"],
                            losses=capture.losses, first_grads=capture.first_grads, params=capture.params,
                            plan_steps_differ=capture.plan_steps_differ)
    return rollout, program


def _compare(cell, result, device):
    """``(numbers, rollout, reference)``: the program's first update against
    the reference's."""
    rollout, program = _program(result)
    reference = check.reference_update(cell.config, result.initial_weights, rollout, result.capture.plan, device)
    return check.readings(program, reference, result.initial_weights), rollout, reference


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda") -> dict:
    result, trainer = run(cell, seed, seconds, traced, device)
    del trainer
    _free()
    numbers = _compare(cell, result, device)[0]
    correct, checks = check.verdict(numbers, cell.limits)
    on_card = torch.device(device).type == "cuda"
    ctx = Context(cell, result, torch.cuda.get_device_name(0) if on_card else "cpu")
    metrics = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": ctx.device_name, "count": 1,
                   "memory_peak_bytes": result.memory_peak_bytes}
    if on_card:
        device_info["power_limit_w"] = _power_limit_w(torch.cuda.current_device())
    line = {"correct": correct, "attempted": result.window_iterations, "failed": result.failed,
            "metrics": metrics, "device": device_info}
    print(f"[window] setup {result.setup_s:.2f} s, window {result.window_s:.3f} s, {result.window_iterations} "
          f"iterations, {result.window_s * 1e3 / max(result.window_iterations, 1):.2f} ms an iteration, peak "
          f"{result.memory_peak_bytes} B, chunks ending at {[round(t, 3) for t in result.chunk_ends]} s, device busy over the window "
          f"{result.window_device_s} s in {result.window_device_events} events", file=sys.stderr)
    if traced and ctx.trace is not None:
        _describe(ctx.trace)
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        line["breakdown"] = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps}
    line["info"] = {"seed": seed, **{k: v for k, v in numbers.items() if k not in checks}}
    line["checks"] = checks
    return line


def _power_limit_w(index: int) -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (a card set below
    its maximum runs slower under load)."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i",
                               str(index)], capture_output=True, text=True, timeout=30)
        return float(done.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _describe(trace) -> None:
    """What the traced chunk held, on standard error: host launch calls by
    name, device events, and the host ranges that launched each kernel
    namespace's kernels (the attribution the rooflines rely on)."""
    import collections

    print(f"[trace] {trace.iterations} iterations, {trace.window_s:.3f} s, {trace.device_events} device events, "
          f"busy {trace.busy_s:.3f} s; launch calls {trace.launch_calls}; launches {trace.launches}", file=sys.stderr)
    owners = collections.defaultdict(collections.Counter)
    for name, _, enclosing in trace.kernels:
        space = name.split("(")[0].rsplit("::", 1)[0].split("<")[0].split(" ")[-1] if "::" in name else "-"
        owners[space][" > ".join(e[:40] for e in enclosing[-2:]) or "(none)"] += 1
    for space, counter in sorted(owners.items()):
        print(f"[trace] {space}: {dict(counter.most_common(4))}", file=sys.stderr)


FAULTS = ("half_batch", "unchanged_state")


def readings(cell: spec.Cell, seeds: list[int], device: str = "cuda"):
    """Yields, per seed, ``{"seed", "program", "control", <each of FAULTS>}``:
    the check's numbers for the program and for the reference put in its
    place, in the control's precision or with a fault planted.  Set-up and
    the first chunk only."""
    for seed in seeds:
        result, trainer = run(cell, seed, None, False, device)
        del trainer
        _free()
        numbers, rollout, reference = _compare(cell, result, device)
        plan, weights = result.capture.plan, result.initial_weights
        row = {"seed": seed, "program": numbers,
               "control": check.readings(check.control_program(cell.config, weights, rollout, plan, device),
                                         reference, weights)}
        for fault in FAULTS:
            planted = check.control_program(cell.config, weights, rollout, plan, device, fault=fault)
            row[fault] = check.readings(planted, reference, weights)
        yield row

"""The comparison that decides ``correct``.

The program's first update, as ``session.FirstUpdateCapture`` recorded it
on the timed path (through the agent's hooks), against the plain reference's (``reference.ppo.
first_update``) on the same inputs: the raw rollout, the initial weights,
the plan.  The numbers compared, each against its limit in the cell's
workload file:

* ``policy_mean_rel``: the rollout policy's mean at every step, relative
  Frobenius gap ``|prog - ref| / |ref|``;
* ``value_rel``, ``advantage_rel``: the values and the standardized
  advantages over the rollout, the same measure;
* ``loss_rel``: the worst of the first three minibatch losses,
  ``|prog - ref| / |ref|``;
* ``grad_norm_gap``: the first gradient as the optimizer takes it, by the
  worst leaf: ``| |g_prog| - |g_ref| | / max(|g_ref|, the median leaf's)``;
* ``param_change_gap``: the parameters' change after three steps, the
  same measure, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's;
* ``grad_norm_median_gap``, ``param_change_median_gap``: the median leaf's
  gap of the same two (steady from seed to seed where the worst leaf is one
  small leaf's rounding noise);
* ``plan_steps_differ``: the number of the first three minibatches whose
  rows are not the recorded plan's (the reference follows that plan), an
  exact comparison with the limit 0.

``observation_gap`` (the largest difference of a normalized observation)
is printed beside them and not compared.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from portbench.reference.mlp import MlpActorCritic
from portbench.reference.ppo import FirstUpdate, Hyper, first_update
from portbench.reference.precision import fp32_matmuls, lower

__all__ = ["COMPARED", "EXACT", "Program", "control_program", "readings", "reference_update", "verdict"]

COMPARED = ("policy_mean_rel", "value_rel", "advantage_rel", "loss_rel", "grad_norm_gap", "grad_norm_median_gap",
            "param_change_gap", "param_change_median_gap")
# Numbers compared exactly: their limit is 0 in every cell.
EXACT = {"plan_steps_differ": 0}


def _model(config: dict, backbone: str, head: str):
    if config["kind"] == "mlp":
        return MlpActorCritic(len(config["agent"]["actor_hidden_dims"]), backbone, head, tuple(config["std_bounds"]))
    from portbench.reference.encoder import TransformerActorCritic

    return TransformerActorCritic(config, backbone, head)


def hyper(config: dict) -> Hyper:
    agent, h = config["agent"], config["hyper"]
    return Hyper(gamma=h["gamma"], lamda=h["lamda"], clip_ratio=h["clip_ratio"],
                 value_loss_weight=h["value_loss_weight"], entropy_loss_weight=agent["entropy_loss_weight"],
                 max_grad_norm=h["max_grad_norm"], lr=agent["lr"], betas=tuple(h["betas"]), eps=h["eps"])


class Program(dict):
    """What the program produced: ``mean``, ``observation``, ``value``,
    ``advantage``, ``losses``, ``first_grads``, ``params``, and
    ``plan_steps_differ`` (absent where the reference stands in)."""


def _first(config, model, weights, rollout, plan, device, batch_fraction: float = 1.0, lr: float | None = None):
    perms, block, mini_batches = plan
    to = {k: v.to(device) for k, v in rollout.items()}
    hp = hyper(config) if lr is None else dataclasses.replace(hyper(config), lr=lr)
    with fp32_matmuls():
        return first_update(model, {k: v.to(device) for k, v in weights.items()}, to, perms.to(device), block,
                            mini_batches, hp, batch_fraction=batch_fraction)


def reference_update(config, weights, rollout, plan, device) -> FirstUpdate:
    precision = config["precision"]
    return _first(config, _model(config, precision["reference_backbone"], precision["reference_head"]), weights,
                  rollout, plan, device)


def control_program(config, weights, rollout, plan, device, fault: str | None = None) -> Program:
    """The reference put in the program's place: in the nearest precision
    below the configuration's (``fault`` None), or at full precision with
    a fault planted (``"half_batch"``: each minibatch's loss over its first
    half of rows; ``"unchanged_state"``: steps that leave the parameters and
    the optimizer's state as they were)."""
    precision = config["precision"]
    if fault is None:
        model = _model(config, lower(precision["backbone"]), lower(precision["head"]))
        update = _first(config, model, weights, rollout, plan, device)
    elif fault == "half_batch":
        model = _model(config, precision["reference_backbone"], precision["reference_head"])
        update = _first(config, model, weights, rollout, plan, device, batch_fraction=0.5)
    elif fault == "unchanged_state":
        model = _model(config, precision["reference_backbone"], precision["reference_head"])
        update = _first(config, model, weights, rollout, plan, device, lr=0.0)
        update.first_grads = {name: torch.zeros_like(g) for name, g in update.first_grads.items()}
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return Program(mean=update.mean, observation=update.observation, value=update.value,
                   advantage=update.advantage, losses=update.losses, first_grads=update.first_grads,
                   params=update.params)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.to(a.device).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _leaf_gaps(program: dict, reference: dict, leaves) -> dict:
    """Each leaf's ``| |prog| - |ref| | / max(|ref|, the median leaf's |ref|)``."""
    norms = {name: float(reference[name].double().norm()) for name in reference}
    median = statistics.median(norms.values())
    return {name: abs(float(program[name].double().norm()) - norms[name]) / max(norms[name], median, 1e-30)
            for name in leaves}


def _worst(gaps: dict) -> tuple[float, str]:
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def readings(program: Program, ref: FirstUpdate, initial: dict) -> dict:
    device = ref.mean.device
    grads = {k: v.to(device) for k, v in program["first_grads"].items()}
    grad_norms = {name: float(g.double().norm()) for name, g in ref.first_grads.items()}
    median = statistics.median(grad_norms.values())
    moved = [name for name, n in grad_norms.items() if n >= 1e-3 * median]
    p0 = {k: v.to(device) for k, v in initial.items()}
    change_prog = {k: program["params"][k].to(device) - p0[k] for k in ref.params}
    change_ref = {k: ref.params[k] - p0[k] for k in ref.params}
    losses = [abs(float(p) - float(r)) / max(abs(float(r)), 1e-30) for p, r in zip(program["losses"], ref.losses)]
    grad_gaps = _leaf_gaps(grads, ref.first_grads, ref.first_grads)
    grad_gap, grad_leaf = _worst(grad_gaps)
    change_gaps = _leaf_gaps(change_prog, change_ref, moved)
    change_gap, change_leaf = _worst(change_gaps)
    return {
        "policy_mean_rel": _rel(program["mean"].to(device), ref.mean),
        "value_rel": _rel(program["value"].to(device), ref.value),
        "advantage_rel": _rel(program["advantage"].to(device), ref.advantage),
        "loss_rel": max(losses) if len(losses) == len(ref.losses) else float("inf"),
        "grad_norm_gap": grad_gap,
        "grad_norm_median_gap": statistics.median(grad_gaps.values()),
        "param_change_gap": change_gap,
        "param_change_median_gap": statistics.median(change_gaps.values()),
        "observation_gap": float((program["observation"].to(device) - ref.observation).abs().max()),
        **({"plan_steps_differ": program["plan_steps_differ"]} if "plan_steps_differ" in program else {}),
        "grad_norm_gap_leaf": grad_leaf,
        "param_change_gap_leaf": change_leaf,
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that the
    cell's workload file gives a limit (``harness.limits`` sets them); a
    missing number fails, and so does a cell without limits."""
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    correct = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks

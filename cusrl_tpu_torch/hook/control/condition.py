"""Conditional objective activation (counterpart of
``cusrl_tpu/hook/control/condition.py``).

Each condition, a callable ``(metadata, batch) -> bool`` (a Python bool or a
0-d tensor), gives a 0/1 scale written into
``batch["__objective_scales__"][hook_name]``; ``HookComposite`` multiplies
that hook's losses by it.  The controlled hook still runs, so its metrics
are recorded whatever the condition says, as in JAX.  The hook must come
before the hooks it controls.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Callable

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["ConditionalObjectiveActivation", "EpochIndexCondition"]


class EpochIndexCondition:
    """True when ``metadata["epoch_index"]`` is in the configured set."""

    def __init__(self, epoch_index: int | Iterable[int]):
        if isinstance(epoch_index, int):
            epoch_index = [epoch_index]
        self.epoch_index = tuple(sorted(set(epoch_index)))

    def __call__(self, metadata, batch) -> bool:
        return metadata["epoch_index"] in self.epoch_index

    def __hash__(self):
        return hash(self.epoch_index)

    def __eq__(self, other):
        return isinstance(other, EpochIndexCondition) and self.epoch_index == other.epoch_index


class ConditionalObjectiveActivation(Hook):
    training_only = True

    def __init__(self, named_conditions: tuple[tuple[str, Callable], ...] = (), **kwargs):
        super().__init__(**kwargs)
        self.named_conditions = tuple(named_conditions)

    @staticmethod
    def create(named_conditions: dict[str, Callable] | None = None, **kwargs: Callable):
        merged = dict(named_conditions or {})
        merged.update(kwargs)
        return ConditionalObjectiveActivation(named_conditions=tuple(sorted(merged.items())))

    def init(self, agent) -> None:
        for hook_name, _ in self.named_conditions:
            agent.get_hook(hook_name)  # raises if missing

    def objective(self, agent, metadata, batch):
        scales = dict(batch.get("__objective_scales__", {}))
        for hook_name, condition in self.named_conditions:
            value = condition(metadata, batch)
            scales[hook_name] = value.float() if isinstance(value, torch.Tensor) else float(value)
        batch["__objective_scales__"] = scales
        return None, {}

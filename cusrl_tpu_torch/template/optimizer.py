"""Optimizer construction (counterpart of ``cusrl_tpu/template/optimizer.py``).

Parameters are grouped by dotted-path prefixes of the agent's named
parameters (``actor...``, ``critic...``); the longest prefix wins and the rest
fall into the factory's own ``"default"`` group.  Each group is one
``torch.optim`` parameter group, so its learning rate can change at run time
(``set_learning_rate``).  ``torch.optim.Adam`` computes
``p -= lr * m_hat / (sqrt(v_hat) + eps)``, the same update as the JAX
package's ``optax.scale_by_adam(eps=1e-8)`` followed by ``-lr``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["AdamFactory", "Optimizer", "OptimizerFactory", "build_optimizer"]


@dataclasses.dataclass
class OptimizerFactory:
    cls: str = "adam"
    lr: float = 1e-3
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    param_groups: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AdamFactory(OptimizerFactory):
    cls: str = "adam"


class Optimizer:
    """A torch optimizer whose parameter groups carry names."""

    def __init__(self, optimizer: torch.optim.Optimizer, group_names: list[str], labels: dict[str, str]):
        self.optimizer = optimizer
        self.group_names = group_names
        self.labels = labels  # parameter path -> group name
        self.base_learning_rates = {name: float(g["lr"]) for name, g in zip(group_names, optimizer.param_groups)}

    def group(self, name: str) -> dict:
        return self.optimizer.param_groups[self.group_names.index(name)]

    @property
    def learning_rates(self) -> dict[str, float]:
        """Host values (reading a device learning rate waits for the device)."""
        return {name: float(group["lr"]) for name, group in zip(self.group_names, self.optimizer.param_groups)}

    def set_learning_rate(self, group: str, lr) -> None:
        """``lr``: a float, or a 0-d tensor once the rates live on the device."""
        g = self.group(group)
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].copy_(lr) if isinstance(lr, torch.Tensor) else g["lr"].fill_(lr)
        else:
            g["lr"] = float(lr)

    def use_device_learning_rates(self) -> None:
        """Keeps each group's learning rate in a 0-d fp32 tensor on its
        parameters' device, so an on-device schedule can rewrite it without a
        host sync.  On CUDA the update then runs ``capturable`` (every Adam
        scalar on the device); the arithmetic is ``optax.scale_by_adam`` with
        ``-lr`` as before.  Call before the first step."""
        for group in self.optimizer.param_groups:
            device = group["params"][0].device
            if not isinstance(group["lr"], torch.Tensor):
                group["lr"] = torch.full((), float(group["lr"]), device=device)
            group["capturable"] = device.type == "cuda"

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.optimizer.step()


def _assign_group(path: str, prefixes: list[str], default: str) -> str:
    best, group = -1, default
    for prefix in prefixes:
        if (path == prefix or path.startswith(prefix)) and len(prefix) > best:
            best, group = len(prefix), prefix
    return group


def build_optimizer(factory: OptimizerFactory, named_parameters) -> Optimizer:
    if factory.cls.lower() != "adam":
        raise NotImplementedError(f"optimizer '{factory.cls}' is not ported yet (only 'adam')")
    named = [(path, p) for path, p in named_parameters if p.requires_grad]
    prefixes = list(factory.param_groups)
    members: dict[str, list] = {}
    labels = {}
    for path, param in named:
        group = _assign_group(path, prefixes, "default")
        members.setdefault(group, []).append(param)
        labels[path] = group
    group_names = sorted(members)
    groups = []
    for name in group_names:
        overrides = factory.param_groups.get(name, {})
        kwargs = {**factory.kwargs, **{k: v for k, v in overrides.items() if k != "lr"}}
        betas = (float(kwargs.get("b1", 0.9)), float(kwargs.get("b2", 0.999)))
        groups.append({"params": members[name], "lr": float(overrides.get("lr", factory.lr)), "betas": betas,
                       "eps": float(kwargs.get("eps", 1e-8))})
    return Optimizer(torch.optim.Adam(groups), group_names, labels)

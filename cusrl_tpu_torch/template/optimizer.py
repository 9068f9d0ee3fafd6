"""Optimizer construction (counterpart of ``cusrl_tpu/template/optimizer.py``).

Parameters are grouped by dotted-path prefixes of the agent's named
parameters (``actor...``, ``critic...``, ``hooks.<hook_name>...``); the
longest prefix wins and the rest fall into the factory's own ``"default"``
group.  ``build_optimizer`` also takes a ``{prefix: factory}`` mapping, the
JAX package's: each prefix owns a group named after it, a factory's own
``param_groups`` become ``"{prefix}.{sub_prefix}"`` groups, and the first
factory's group is the default.  Groups no parameter falls into are dropped.
Each group is one ``torch.optim`` parameter group, so its learning rate can
change at run time (``set_learning_rate``).

The update directions are the JAX package's optax transforms (``_SCALERS``):

* ``adam``: ``scale_by_adam``; when every group is Adam the port runs
  ``torch.optim.Adam``, which computes the same
  ``p -= lr * m_hat / (sqrt(v_hat) + eps)``;
* ``adamw``: ``scale_by_adam``, then ``+ weight_decay * p`` on every leaf;
* ``sgd``: ``trace(momentum, nesterov)``, the identity at momentum 0;
* ``rmsprop``: ``scale_by_rms(decay, eps)``, ``g * rsqrt(nu + eps)`` with
  ``nu`` starting at 0;

each followed by ``p += -lr * u``.  Groups of mixed families (or any family
but Adam) run ``OptaxDirections``, which writes that arithmetic with
``torch._foreach_*`` ops and reads a device learning rate as a tensor (no
host sync).  ``CUSRL_TPU_PACKED_ADAM=1`` (off by default, as in JAX) runs
Adam on one flat fp32 vector (``PackedAdam``) where every group is Adam with
the same moments and every parameter is fp32.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any

import torch

__all__ = [
    "AdamFactory",
    "AdamWFactory",
    "OptaxDirections",
    "Optimizer",
    "OptimizerFactory",
    "PackedAdam",
    "SgdFactory",
    "build_optimizer",
]

# Each family's hyperparameters and their defaults (``_SCALERS``, optimizer.py:32-41).
_FAMILIES: dict[str, dict[str, Any]] = {
    "adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8},
    "adamw": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 1e-2},
    "sgd": {"momentum": 0.0, "nesterov": False},
    "rmsprop": {"decay": 0.99, "eps": 1e-8},
}


@dataclasses.dataclass
class OptimizerFactory:
    """A named direction transform with prefix param groups; ``param_groups``
    maps path prefixes to per-group overrides (``lr`` and any of the
    family's kwargs)."""

    cls: str = "adam"
    lr: float = 1e-3
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    param_groups: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)

    def hyperparameters(self, overrides: dict[str, Any] | None = None) -> dict[str, Any]:
        """The family's hyperparameters for a group: defaults, the factory's
        kwargs, then the group's overrides (``lr`` aside); unknown keys are
        ignored, as the JAX scalers' ``**_`` does."""
        family = self.cls.lower()
        if family not in _FAMILIES:
            raise ValueError(f"Unsupported optimizer '{self.cls}' (available: {sorted(_FAMILIES)})")
        given = {**self.kwargs, **{k: v for k, v in (overrides or {}).items() if k != "lr"}}
        return {"family": family, **{k: given.get(k, v) for k, v in _FAMILIES[family].items()}}

    def group_lr(self, overrides: dict[str, Any] | None = None) -> float:
        return float((overrides or {}).get("lr", self.lr))


@dataclasses.dataclass
class AdamFactory(OptimizerFactory):
    cls: str = "adam"


@dataclasses.dataclass
class AdamWFactory(OptimizerFactory):
    cls: str = "adamw"

    def __post_init__(self):
        self.kwargs.setdefault("weight_decay", 1e-2)


@dataclasses.dataclass
class SgdFactory(OptimizerFactory):
    cls: str = "sgd"
    lr: float = 1e-2


def _neg(lr):
    """``-lr`` as the scalar of a foreach product: a float, or a 0-d tensor
    on the parameters' device (a device lr is never read on the host)."""
    return -lr if isinstance(lr, torch.Tensor) else -float(lr)


class OptaxDirections(torch.optim.Optimizer):
    """The JAX package's optax directions per parameter group (its
    ``family``: adam, adamw, sgd, rmsprop), each followed by
    ``p += -lr * u``.  State per parameter: ``step`` (fp32, adam and adamw),
    ``exp_avg`` / ``exp_avg_sq`` (adam, adamw), ``momentum_buffer`` (sgd with
    momentum), ``square_avg`` (rmsprop), created at the first step as zeros.
    A parameter without a gradient is skipped, as ``torch.optim`` does."""

    def __init__(self, groups: list[dict]):
        super().__init__(groups, {})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            family = group["family"]
            if family in ("adam", "adamw"):
                updates = self._adam(group, params, grads, states)
                if family == "adamw":
                    torch._foreach_add_(updates, torch._foreach_mul(params, float(group["weight_decay"])))
            elif family == "sgd":
                updates = self._sgd(group, grads, states)
            else:
                updates = self._rmsprop(group, grads, states)
            torch._foreach_add_(params, torch._foreach_mul(updates, _neg(group["lr"])))

    @staticmethod
    def _adam(group, params, grads, states):
        b1, b2, eps = float(group["b1"]), float(group["b2"]), float(group["eps"])
        for p, state in zip(params, states):
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
        mu = [s["exp_avg"] for s in states]
        nu = [s["exp_avg_sq"] for s in states]
        steps = [s["step"] for s in states]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu (optax update_moment).
        new_mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1), torch._foreach_mul(mu, b1))
        new_nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2),
                                    torch._foreach_mul(nu, b2))
        torch._foreach_copy_(mu, new_mu)
        torch._foreach_copy_(nu, new_nu)
        torch._foreach_add_(steps, 1.0)
        # mu / (1 - b1^count), nu / (1 - b2^count), then mu_hat / (sqrt(nu_hat) + eps).
        c1 = [1.0 - torch.pow(b1, s) for s in steps]
        c2 = [1.0 - torch.pow(b2, s) for s in steps]
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        return torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))

    @staticmethod
    def _sgd(group, grads, states):
        momentum = float(group["momentum"])
        if not momentum:
            return list(grads)
        for g, state in zip(grads, states):
            if not state:
                state["momentum_buffer"] = torch.zeros_like(g)
        trace = [s["momentum_buffer"] for s in states]
        # optax.trace: t = g + decay t; the update is t, or g + decay t with nesterov.
        new_trace = torch._foreach_add(grads, torch._foreach_mul(trace, momentum))
        torch._foreach_copy_(trace, new_trace)
        if group["nesterov"]:
            return torch._foreach_add(grads, torch._foreach_mul(new_trace, momentum))
        return new_trace

    @staticmethod
    def _rmsprop(group, grads, states):
        decay, eps = float(group["decay"]), float(group["eps"])
        for g, state in zip(grads, states):
            if not state:
                state["square_avg"] = torch.zeros_like(g)
        nu = [s["square_avg"] for s in states]
        new_nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - decay),
                                    torch._foreach_mul(nu, decay))
        torch._foreach_copy_(nu, new_nu)
        # optax.scale_by_rms: g * rsqrt(nu + eps).
        return torch._foreach_mul(grads, torch._foreach_reciprocal(torch._foreach_sqrt(
            torch._foreach_add(new_nu, eps))))


class PackedAdam(torch.optim.Optimizer):
    """Adam on one flat fp32 vector (``Optimizer._apply_packed``): the
    gradients and the parameters are concatenated, updated in one pass with
    a per-element learning rate where the groups' rates differ, and the
    parameters copied back.  Each parameter's ``exp_avg`` / ``exp_avg_sq``
    state is a view of the flat moments and ``step`` one shared tensor, so a
    snapshot restores them as the per-parameter state of ``torch.optim``.
    The update covers every parameter: one without a gradient takes zeros,
    as a leaf without a loss term does in JAX."""

    def __init__(self, groups: list[dict], b1: float, b2: float, eps: float):
        super().__init__(groups, {})
        self.b1, self.b2, self.eps = b1, b2, eps
        self._params = [p for group in self.param_groups for p in group["params"]]
        self._sizes = [p.numel() for p in self._params]
        device = self._params[0].device
        total = sum(self._sizes)
        self._mu = torch.zeros(total, device=device)
        self._nu = torch.zeros(total, device=device)
        self._count = torch.zeros((), device=device)
        for p, mu, nu in zip(self._params, self._mu.split(self._sizes), self._nu.split(self._sizes)):
            self.state[p] = {"step": self._count, "exp_avg": mu.view_as(p), "exp_avg_sq": nu.view_as(p)}

    def _lr_vector(self):
        groups = self.param_groups
        if len(groups) == 1:
            return groups[0]["lr"]
        lrs = []
        for group in groups:
            lr = group["lr"]
            lr = lr if isinstance(lr, torch.Tensor) else torch.tensor(float(lr), device=self._mu.device)
            lrs += [lr.float().expand(p.numel()) for p in group["params"]]
        return torch.cat(lrs)

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2, eps = self.b1, self.b2, self.eps
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1) for p in self._params]).float()
        self._mu.copy_((1.0 - b1) * g + b1 * self._mu)
        self._nu.copy_((1.0 - b2) * (g * g) + b2 * self._nu)
        self._count.add_(1.0)
        mu_hat = self._mu / (1.0 - torch.pow(b1, self._count))
        nu_hat = self._nu / (1.0 - torch.pow(b2, self._count))
        update = mu_hat / (torch.sqrt(nu_hat) + eps)
        vec = torch.cat([p.reshape(-1) for p in self._params]) - self._lr_vector() * update
        torch._foreach_copy_(self._params, [v.view_as(p) for v, p in zip(vec.split(self._sizes), self._params)])


class Optimizer:
    """A torch optimizer whose parameter groups carry names."""

    def __init__(self, optimizer: torch.optim.Optimizer, group_names: list[str], labels: dict[str, str]):
        self.optimizer = optimizer
        self.group_names = group_names
        self.labels = labels  # parameter path -> group name
        self.base_learning_rates = {name: float(g["lr"]) for name, g in zip(group_names, optimizer.param_groups)}

    @property
    def packed(self) -> bool:
        return isinstance(self.optimizer, PackedAdam)

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
        host sync.  On CUDA ``torch.optim.Adam`` then runs ``capturable``
        (every Adam scalar on the device); the arithmetic is
        ``optax.scale_by_adam`` with ``-lr`` as before.  ``OptaxDirections``
        and ``PackedAdam`` take the tensor as it is.  Call before the first
        step."""
        for group in self.optimizer.param_groups:
            device = group["params"][0].device
            if not isinstance(group["lr"], torch.Tensor):
                group["lr"] = torch.full((), float(group["lr"]), device=device)
            if isinstance(self.optimizer, torch.optim.Adam):
                group["capturable"] = device.type == "cuda"

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.optimizer.step()


def _assign_group(path: str, prefix_to_group: dict[str, str], default: str) -> str:
    best, group = -1, default
    for prefix, name in prefix_to_group.items():
        if path.startswith(prefix) and len(prefix) > best:
            best, group = len(prefix), name
    return group


def _groups_of(factory) -> tuple[dict, dict, str]:
    """``({group: (hyperparameters, lr)}, {prefix: group}, default group)``
    of a factory or a ``{prefix: factory}`` mapping (``build_optimizer``,
    optimizer.py:207-241)."""
    groups, prefix_to_group = {}, {}
    if not isinstance(factory, Mapping):
        groups["default"] = (factory.hyperparameters(), factory.group_lr())
        for prefix, overrides in factory.param_groups.items():
            groups[prefix] = (factory.hyperparameters(overrides), factory.group_lr(overrides))
            prefix_to_group[prefix] = prefix
        return groups, prefix_to_group, "default"
    for prefix, sub in factory.items():
        groups[prefix] = (sub.hyperparameters(), sub.group_lr())
        prefix_to_group[prefix] = prefix
        for sub_prefix, overrides in sub.param_groups.items():
            groups[f"{prefix}.{sub_prefix}"] = (sub.hyperparameters(overrides), sub.group_lr(overrides))
            prefix_to_group[sub_prefix] = f"{prefix}.{sub_prefix}"
    return groups, prefix_to_group, next(iter(factory))


def _packed_moments(factory) -> tuple[float, float, float] | None:
    """(b1, b2, eps) where packed Adam applies (``_packable_adam``): read from
    ``CUSRL_TPU_PACKED_ADAM=1`` (default off), every factory Adam, no group
    overriding more than its lr, and one moments configuration."""
    if os.environ.get("CUSRL_TPU_PACKED_ADAM", "0") != "1":
        return None
    factories = list(factory.values()) if isinstance(factory, Mapping) else [factory]
    if not factories or any(f.cls.lower() != "adam" for f in factories):
        return None
    if any(k != "lr" for f in factories for overrides in f.param_groups.values() for k in overrides):
        return None
    configs = {tuple(float(f.kwargs.get(k, d)) for k, d in _FAMILIES["adam"].items()) for f in factories}
    return configs.pop() if len(configs) == 1 else None


def build_optimizer(factory: OptimizerFactory | Mapping[str, OptimizerFactory], named_parameters) -> Optimizer:
    named = [(path, p) for path, p in named_parameters if p.requires_grad]
    specs, prefix_to_group, default = _groups_of(factory)
    members: dict[str, list] = {}
    labels = {}
    for path, param in named:
        group = _assign_group(path, prefix_to_group, default)
        members.setdefault(group, []).append(param)
        labels[path] = group
    group_names = sorted(members)
    groups = []
    for name in group_names:
        hyper, lr = specs[name]
        groups.append({"params": members[name], "lr": lr, **hyper})
    moments = _packed_moments(factory)
    if moments is not None and all(p.dtype == torch.float32 for _, p in named):
        optimizer = PackedAdam([{"params": g["params"], "lr": g["lr"]} for g in groups], *moments)
    elif all(g["family"] == "adam" for g in groups):
        optimizer = torch.optim.Adam([{"params": g["params"], "lr": g["lr"], "betas": (float(g["b1"]), float(g["b2"])),
                                       "eps": float(g["eps"])} for g in groups])
    else:
        optimizer = OptaxDirections(groups)
    return Optimizer(optimizer, group_names, labels)

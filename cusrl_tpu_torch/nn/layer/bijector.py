"""Bijective scalar transformations for positive quantities such as policy
standard deviations (counterpart of ``cusrl_tpu/nn/layer/bijector.py``):
exp and identity with clamped inverses and the string spec format
``"exp_0.01_1.0"``.  The sigmoid and softplus bijectors wait for a slice whose
configuration uses them."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Bijector",
    "ExponentialBijector",
    "IdentityBijector",
    "make_bijector",
]


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: min/max of tensors split the gradient
    evenly on ties, so a value sitting exactly on a bound (an std parameter
    initialised at the upper bound) gets half of it, as in JAX.
    ``torch.clamp`` would pass all of it.  The bounds are filled on the
    tensor's device (no host-to-device copy, which would wait on the device)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


@dataclasses.dataclass(frozen=True)
class Bijector:
    @classmethod
    def from_str(cls, spec: str) -> "Bijector":
        if not spec:
            return cls()
        return cls(*[float(p) for p in spec.split("_")])

    def __call__(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityBijector(Bijector):
    def __call__(self, x):
        return x

    def inverse(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class ExponentialBijector(Bijector):
    min_value: float = 0.01
    max_value: float = 1.0

    def __call__(self, x):
        lo, hi = math.log(self.min_value), math.log(self.max_value)
        if _is_tensor(x):
            return torch.exp(_clip(x, lo, hi))
        return math.exp(min(max(x, lo), hi))

    def inverse(self, y):
        if _is_tensor(y):
            return torch.log(_clip(y, self.min_value, self.max_value))
        return math.log(min(max(y, self.min_value), self.max_value))


def make_bijector(spec: str | Bijector | None) -> Bijector:
    if isinstance(spec, Bijector):
        return spec
    if spec is None:
        return IdentityBijector()
    kind, _, params = spec.partition("_")
    table: dict[str, type[Bijector]] = {
        "": IdentityBijector,
        "identity": IdentityBijector,
        "exp": ExponentialBijector,
        "exponential": ExponentialBijector,
    }
    if kind.lower() not in table:
        raise ValueError(f"Unsupported bijector specification '{spec}'")
    return table[kind.lower()].from_str(params)

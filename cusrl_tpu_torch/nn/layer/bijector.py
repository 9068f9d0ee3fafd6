"""Bijective scalar transformations for positive quantities such as policy
standard deviations (counterpart of ``cusrl_tpu/nn/layer/bijector.py``):
identity, exp, sigmoid and softplus, each with the JAX package's clamps, and
the string spec format ``"exp_0.01_1.0"`` (``"sigmoid_<min>_<max>_<eps>"``,
``"softplus_<scale>_<min>_<max>"``)."""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Bijector",
    "ExponentialBijector",
    "IdentityBijector",
    "SigmoidBijector",
    "SoftplusBijector",
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


@dataclasses.dataclass(frozen=True)
class SigmoidBijector(Bijector):
    min_value: float = 0.0
    max_value: float = 1.0
    eps: float = 0.01

    def __call__(self, x):
        span = self.max_value - self.min_value
        if _is_tensor(x):
            return self.min_value + span * (1.0 / (1.0 + torch.exp(-x)))
        return self.min_value + span / (1.0 + math.exp(-x))

    def inverse(self, y):
        lo, hi = self.min_value + self.eps, self.max_value - self.eps
        if _is_tensor(y):
            clamped = _clip(y, lo, hi)
            return torch.log((clamped - self.min_value) / (self.max_value - clamped))
        clamped = min(max(y, lo), hi)
        return math.log((clamped - self.min_value) / (self.max_value - clamped))


@dataclasses.dataclass(frozen=True)
class SoftplusBijector(Bijector):
    """``softplus(scale * x) / scale`` with ``x`` clamped to the inverses of
    ``min_value`` and ``max_value``."""

    scale: float = 1.0
    min_value: float = 0.01
    max_value: float = 1.0

    def _inverse_unclamped(self, y: float) -> float:
        scaled = y * self.scale
        return (scaled + math.log1p(-math.exp(-scaled))) / self.scale

    def __call__(self, x):
        lo = self._inverse_unclamped(self.min_value)
        hi = self._inverse_unclamped(self.max_value)
        if _is_tensor(x):
            return torch.logaddexp(_clip(x, lo, hi) * self.scale, torch.zeros_like(x)) / self.scale
        clamped = min(max(x, lo), hi)
        return math.log1p(math.exp(clamped * self.scale)) / self.scale

    def inverse(self, y):
        if _is_tensor(y):
            scaled = _clip(y, self.min_value, self.max_value) * self.scale
            return (scaled + torch.log1p(-torch.exp(-scaled))) / self.scale
        return self._inverse_unclamped(min(max(y, self.min_value), self.max_value))


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
        "sigmoid": SigmoidBijector,
        "softplus": SoftplusBijector,
    }
    if kind.lower() not in table:
        raise ValueError(f"Unsupported bijector specification '{spec}'")
    return table[kind.lower()].from_str(params)

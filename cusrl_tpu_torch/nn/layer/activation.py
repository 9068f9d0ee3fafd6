"""Gated-linear-unit activations and small utility layers (counterpart of
``cusrl_tpu/nn/layer/activation.py``).

The GLUs split the last axis in two halves ``a, b`` and return ``a * f(b)``,
with ``f`` the tanh form of gelu (``jax.nn.gelu``'s default) or silu.
"""

from __future__ import annotations

import torch
from torch import nn

from cusrl_tpu_torch.nn.layer.linear import ACTIVATIONS

__all__ = ["DetachGradient", "GeGlu", "ParameterWrapper", "SwiGlu", "geglu", "swiglu"]


def geglu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * ACTIVATIONS["gelu"](b)


def swiglu(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * ACTIVATIONS["silu"](b)


class GeGlu(nn.Module):
    def forward(self, x):
        return geglu(x)


class SwiGlu(nn.Module):
    def forward(self, x):
        return swiglu(x)


class DetachGradient(nn.Module):
    """``detach`` as a composable layer."""

    def forward(self, x):
        return x.detach()


class ParameterWrapper(nn.Module):
    """A bare parameter tensor as a module: returns ``value`` whatever it is
    called with."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.value = nn.Parameter(value)

    def forward(self, *_args):
        return self.value

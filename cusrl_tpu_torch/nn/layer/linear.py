"""Linear layer and activation registry (counterpart of
``cusrl_tpu/nn/layer/linear.py``).

Numerics follow the JAX layer: with ``compute_dtype="bfloat16"`` the operands
are rounded to bf16, the product accumulates in fp32 (bf16 products are exact
in fp32, so an fp32 matmul of the rounded operands IS bf16-operand/fp32-
accumulate arithmetic), the fp32 bias is added and the result is cast to bf16.
``compute_dtype=None`` keeps everything fp32.  ``weight`` is ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ACTIVATIONS", "Linear", "get_activation"]


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default form
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
    "mish": F.mish,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name: str | Callable | None) -> Callable:
    if callable(name):
        return name
    if name is None:
        return ACTIVATIONS["identity"]
    key = name.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'")
    return ACTIVATIONS[key]


class Linear(nn.Module):
    """y = x @ W^T + b with optional bf16 compute."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        bias: bool = True,
        compute_dtype: str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        # Kaiming-uniform fan-in init, as the JAX layer.
        bound = 1.0 / math.sqrt(input_dim) if input_dim > 0 else 0.0
        weight = torch.empty(output_dim, input_dim).uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(weight)
        if bias:
            self.bias = nn.Parameter(torch.empty(output_dim).uniform_(-bound, bound, generator=generator))
        else:
            self.register_parameter("bias", None)
        self.compute_dtype = compute_dtype

    @property
    def input_dim(self) -> int:
        return self.weight.shape[1]

    @property
    def output_dim(self) -> int:
        return self.weight.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            dtype = getattr(torch, self.compute_dtype)
            y = F.linear(x.to(dtype).float(), self.weight.to(dtype).float(), self.bias)
            return y.to(dtype)
        return F.linear(x.float(), self.weight, self.bias)

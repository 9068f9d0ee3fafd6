"""MLP backbone (counterpart of ``cusrl_tpu/nn/module/mlp.py``).

``forward`` keeps the ``(output, memory, aux)`` contract of the JAX modules
(``sequential`` and ``done`` are accepted and change nothing: a feedforward
module maps ``[T, N, C]`` row by row).
On CUDA tensors with enough rows the whole chain runs as one fused kernel
(``nn/kernels/fused_mlp.py``); elsewhere it runs layer by layer with the same
numerics.  ``fused_kernel=False`` keeps a module off the kernels everywhere:
a network differentiated to second order (AMP's discriminator and its
gradient penalty) needs it, as the kernels' backward is first-order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract
from cusrl_tpu_torch.nn.kernels.fused_mlp import fused_mlp, supports_fused_mlp
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation

__all__ = ["Mlp", "MlpFactory"]


class Mlp(BackboneContract, nn.Module):

    def __init__(
        self,
        layers: list[Linear],
        activation: str = "elu",
        ends_with_activation: bool = False,
        fused_kernel: bool = True,
    ):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.activation = activation
        self.ends_with_activation = ends_with_activation
        self.fused_kernel = fused_kernel

    @property
    def input_dim(self) -> int:
        return self.layers[0].input_dim

    @property
    def output_dim(self) -> int:
        return self.layers[-1].output_dim

    @property
    def activation_fn(self) -> Callable:
        return get_activation(self.activation)

    def _can_fuse(self, x: torch.Tensor) -> bool:
        """The JAX rule (``mlp.py:63-77``) with "backend is TPU" replaced by
        "tensor is on CUDA"."""
        rows = 1
        for dim in x.shape[:-1]:
            rows *= dim
        return (
            self.fused_kernel
            and x.dim() >= 2
            and rows >= 256
            and x.is_cuda
            and supports_fused_mlp(self.activation, len(self.layers), self.ends_with_activation)
            and all(l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers)
        )

    def forward(self, x: torch.Tensor, memory=None, **kwargs):
        if self._can_fuse(x):
            batch_shape = x.shape[:-1]
            out = fused_mlp(
                x.reshape(-1, x.shape[-1]),
                [l.weight for l in self.layers],
                [l.bias for l in self.layers],
                self.activation,
                self.ends_with_activation,
            )
            return out.reshape(*batch_shape, out.shape[-1]), memory, {}
        act = self.activation_fn
        for index, layer in enumerate(self.layers):
            x = layer(x)
            if index < len(self.layers) - 1 or self.ends_with_activation:
                x = act(x)
        return x, memory, {}


@dataclasses.dataclass
class MlpFactory:
    """Builds an Mlp; hidden layers use ``compute_dtype`` (``"default"`` reads
    ``CONFIG.compute_dtype``)."""

    hidden_dims: tuple[int, ...] = (256, 256)
    activation: str = "elu"
    ends_with_activation: bool = True
    bias: bool = True
    compute_dtype: str | None = "default"
    fused_kernel: bool = True

    is_recurrent = False

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> Mlp:
        from cusrl_tpu_torch.utils.config import CONFIG

        compute_dtype = CONFIG.compute_dtype if self.compute_dtype == "default" else self.compute_dtype
        dims = [input_dim, *self.hidden_dims]
        if output_dim is not None:
            dims.append(output_dim)
        layers = [
            Linear(dims[i], dims[i + 1], bias=self.bias, compute_dtype=compute_dtype, generator=generator)
            for i in range(len(dims) - 1)
        ]
        return Mlp(layers, self.activation, self.ends_with_activation, self.fused_kernel)

"""Convolutional backbone (counterpart of ``cusrl_tpu/nn/module/cnn.py``):
a stack of 2-D convolutions with the activation after each, flattened into
an fp32 ``Linear`` head.

The input is the JAX module's: a flat ``[..., H * W * C]`` observation in
``(H, W, C)`` order (or ``[..., H, W, C]``), and the flattened feature map is
taken in the same NHWC order, so the head's weight carries across unchanged.
The convolutions are cuDNN's on the card (``F.conv2d``; the JAX module is
``lax.conv_general_dilated``, not a Pallas kernel).  With a compute dtype the
operands are rounded to it, the products accumulate in fp32, the result is
rounded to it and the rounded bias is added in it, as in JAX.  Weights are
``[out, in, kh, kw]``; the JAX module's HWIO arrays are the same with their
axes permuted (``jax_layouts``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation
from cusrl_tpu_torch.nn.layer.separable_conv import HWIO_FROM_OIHW, _pair, conv2d_nhwc

__all__ = ["Cnn", "CnnFactory", "Conv2d"]


class Conv2d(nn.Module):
    """NHWC in and out, as the JAX layer."""

    jax_layouts = {"weight": HWIO_FROM_OIHW}

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding="VALID",
                 compute_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        kernel_size = _pair(kernel_size)
        bound = 1.0 / math.sqrt(in_channels * kernel_size[0] * kernel_size[1])
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size).uniform_(
            -bound, bound, generator=generator))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound, bound, generator=generator))
        self.stride = _pair(stride)
        self.padding = padding
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = getattr(torch, self.compute_dtype) if self.compute_dtype else torch.float32
        y = conv2d_nhwc(x.to(dtype).float(), self.weight.to(dtype).float(), self.stride, self.padding).to(dtype)
        return y + self.bias.to(dtype) if self.bias is not None else y


class Cnn(BackboneContract, nn.Module):
    def __init__(self, convs: list[Conv2d], head: Linear, activation: str = "relu",
                 input_shape: tuple[int, int, int] = (0, 0, 0), output_dim: int = 0):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.head = head
        self.activation = activation
        self.input_shape = tuple(input_shape)
        self.output_dim = output_dim

    @property
    def input_dim(self) -> int:
        return math.prod(self.input_shape)

    def forward(self, x, memory: Memory = None, **kwargs):
        act = get_activation(self.activation)
        h, w, c = self.input_shape
        lead = x.shape[:-1] if x.shape[-1] == h * w * c else x.shape[:x.dim() - 3]
        x = x.reshape(-1, h, w, c)
        for conv in self.convs:
            x = act(conv(x))
        out = self.head(x.reshape(x.shape[0], -1).float())
        return out.reshape(*lead, self.output_dim), memory, {}


@dataclasses.dataclass
class CnnFactory:
    input_shape: tuple[int, int, int] = (64, 64, 3)  # (H, W, C)
    channels: tuple[int, ...] = (16, 32, 32)
    kernel_sizes: tuple[int, ...] = (8, 4, 3)
    strides: tuple[int, ...] = (4, 2, 1)
    activation: str = "relu"
    hidden_dim: int = 256
    compute_dtype: str | None = "default"

    is_recurrent = False

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> Cnn:
        from cusrl_tpu_torch.utils.config import CONFIG

        dtype = CONFIG.compute_dtype if self.compute_dtype == "default" else self.compute_dtype
        h, w, c = self.input_shape
        if input_dim not in (h * w * c, 0):
            raise ValueError(f"input_dim {input_dim} incompatible with input_shape {self.input_shape}")
        convs, in_c, shape = [], c, (h, w)
        for out_c, k, s in zip(self.channels, self.kernel_sizes, self.strides):
            convs.append(Conv2d(in_c, out_c, k, s, compute_dtype=dtype, generator=generator))
            shape = tuple((d - k) // s + 1 for d in shape)
            in_c = out_c
        out_dim = output_dim or self.hidden_dim
        head = Linear(shape[0] * shape[1] * in_c, out_dim, generator=generator)
        return Cnn(convs, head, self.activation, self.input_shape, out_dim)


Cnn.Factory = CnnFactory

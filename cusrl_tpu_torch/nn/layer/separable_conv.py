"""Depthwise-separable 2-D convolution (counterpart of
``cusrl_tpu/nn/layer/separable_conv.py``): a depthwise convolution (one group
per input channel, ``depth_multiplier`` filters each) followed by a 1x1
pointwise projection and a bias, in fp32, NHWC in and out as in JAX.

Weights are stored in PyTorch's ``[out, in / groups, kh, kw]`` layout; the JAX
module's ``[kh, kw, in / groups, out]`` (HWIO) is the same array with its axes
permuted (``jax_layouts``, which ``utils/interop.py`` applies when it carries
weights across).  Padding takes the JAX strings: ``"VALID"``, and ``"SAME"``,
which pads as XLA does (``ceil(size / stride)`` outputs, the total padding
split with the larger half after), asymmetrically where the stride is above
1; or explicit ``((top, bottom), (left, right))`` pairs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SeparableConv2d", "conv2d_nhwc"]

HWIO_FROM_OIHW = (2, 3, 1, 0)  # the JAX weight is the port's permuted by this


def _pair(value) -> tuple[int, int]:
    return (value, value) if isinstance(value, int) else tuple(value)


def _explicit_padding(padding, size: tuple[int, int], kernel: tuple[int, int], stride: tuple[int, int]):
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        pads = []
        for d, k, s in zip(size, kernel, stride):
            total = max((math.ceil(d / s) - 1) * s + k - d, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return tuple(tuple(p) for p in padding)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, stride, padding, groups: int = 1) -> torch.Tensor:
    """``x [N, H, W, C]`` convolved with ``weight [O, C / groups, kh, kw]``
    with the JAX padding rules; ``[N, H', W', O]``, no bias."""
    stride = _pair(stride)
    (top, bottom), (left, right) = _explicit_padding(padding, tuple(x.shape[1:3]), tuple(weight.shape[2:]), stride)
    x = x.permute(0, 3, 1, 2)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, stride=stride, groups=groups).permute(0, 2, 3, 1)


class SeparableConv2d(nn.Module):
    jax_layouts = {"depthwise": HWIO_FROM_OIHW, "pointwise": HWIO_FROM_OIHW}

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding="SAME",
                 depth_multiplier: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        kernel_size = _pair(kernel_size)
        mid = in_channels * depth_multiplier
        bound_d = 1.0 / math.sqrt(kernel_size[0] * kernel_size[1])
        bound_p = 1.0 / math.sqrt(mid)
        self.depthwise = nn.Parameter(torch.empty(mid, 1, *kernel_size).uniform_(-bound_d, bound_d,
                                                                                 generator=generator))
        self.pointwise = nn.Parameter(torch.empty(out_channels, mid, 1, 1).uniform_(-bound_p, bound_p,
                                                                                    generator=generator))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(-bound_p, bound_p, generator=generator))
        self.stride = _pair(stride)
        self.padding = padding
        self.in_channels = in_channels

    def forward(self, x):
        y = conv2d_nhwc(x.float(), self.depthwise, self.stride, self.padding, groups=self.in_channels)
        y = conv2d_nhwc(y, self.pointwise, 1, "VALID")
        return y + self.bias if self.bias is not None else y

"""Frozen affine normalization modules (counterpart of
``cusrl_tpu/nn/module/normalization.py``): ``Normalization`` computes
``(x - shift) / scale`` and ``Denormalization`` ``x * scale + shift``, in
fp32, cast back to the input's dtype.  The statistics are parameters that
take no gradient (the JAX modules' frozen fields), so they carry across by
path as the other parameters do.
"""

from __future__ import annotations

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory

__all__ = ["Denormalization", "Normalization"]


class _FrozenAffine(BackboneContract, nn.Module):
    def __init__(self, scale, shift):
        super().__init__()
        self.scale = nn.Parameter(torch.as_tensor(scale, dtype=torch.float32), requires_grad=False)
        self.shift = nn.Parameter(torch.as_tensor(shift, dtype=torch.float32), requires_grad=False)

    @property
    def input_dim(self) -> int:
        return self.scale.shape[-1]

    @property
    def output_dim(self) -> int:
        return self.scale.shape[-1]


class Normalization(_FrozenAffine):
    """``y = (x - shift) / scale`` with frozen statistics."""

    def forward(self, x, memory: Memory = None, **kwargs):
        return ((x.float() - self.shift) / self.scale).to(x.dtype), memory, {}


class Denormalization(_FrozenAffine):
    """``y = x * scale + shift`` with frozen statistics."""

    def forward(self, x, memory: Memory = None, **kwargs):
        return (x.float() * self.scale + self.shift).to(x.dtype), memory, {}

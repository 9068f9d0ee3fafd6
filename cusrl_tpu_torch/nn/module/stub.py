"""Stub and identity backbones (counterpart of ``cusrl_tpu/nn/module/stub.py``).

``StubModule`` outputs fp32 zeros: the critic's backbone in pure
distillation, where no value function is learned.  ``Identity`` passes its
input through.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract

__all__ = ["Identity", "IdentityFactory", "StubModule", "StubModuleFactory"]


class StubModule(BackboneContract, nn.Module):
    def __init__(self, input_dim: int = 0, output_dim: int = 1):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim

    def forward(self, x: torch.Tensor, memory=None, **kwargs):
        return torch.zeros(*x.shape[:-1], self.output_dim, device=x.device), memory, {}


class Identity(BackboneContract, nn.Module):
    def __init__(self, input_dim: int = 0):
        super().__init__()
        self.input_dim = input_dim

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def forward(self, x: torch.Tensor, memory=None, **kwargs):
        return x, memory, {}


@dataclasses.dataclass
class StubModuleFactory:
    output_dim: int = 1

    is_recurrent = False

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> StubModule:
        return StubModule(input_dim, output_dim or self.output_dim)


@dataclasses.dataclass
class IdentityFactory:
    is_recurrent = False

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> Identity:
        return Identity(input_dim)


StubModule.Factory = StubModuleFactory
Identity.Factory = IdentityFactory

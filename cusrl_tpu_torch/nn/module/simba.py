"""SimBa residual backbone (counterpart of ``cusrl_tpu/nn/module/simba.py``):
an input projection, residual blocks of LayerNorm -> Linear (4x wide) ->
activation -> Linear, and a final LayerNorm.  Plain ``Linear`` layers, as in
JAX (no kernel: the JAX module reaches no Pallas call)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation
from cusrl_tpu_torch.nn.layer.mha import LayerNorm

__all__ = ["LayerNorm", "Simba", "SimbaBlock", "SimbaFactory"]


class SimbaBlock(nn.Module):
    def __init__(self, norm: LayerNorm, up: Linear, down: Linear, activation: str = "relu"):
        super().__init__()
        self.norm, self.up, self.down = norm, up, down
        self.activation = activation

    def forward(self, x):
        return x + self.down(get_activation(self.activation)(self.up(self.norm(x))))


class Simba(BackboneContract, nn.Module):
    def __init__(self, input_proj: Linear, blocks: list[SimbaBlock], final_norm: LayerNorm, input_dim: int = 0,
                 output_dim: int = 0):
        super().__init__()
        self.input_proj = input_proj
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.input_dim, self.output_dim = input_dim, output_dim

    def forward(self, x, memory: Memory = None, **kwargs):
        h = self.input_proj(x)
        for block in self.blocks:
            h = block(h)
        return self.final_norm(h), memory, {}


@dataclasses.dataclass
class SimbaFactory:
    hidden_dim: int = 256
    num_blocks: int = 2
    activation: str = "relu"
    compute_dtype: str | None = "default"

    is_recurrent = False

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> Simba:
        from cusrl_tpu_torch.utils.config import CONFIG

        dtype = CONFIG.compute_dtype if self.compute_dtype == "default" else self.compute_dtype
        h = self.hidden_dim
        input_proj = Linear(input_dim, h, compute_dtype=dtype, generator=generator)
        blocks = [SimbaBlock(LayerNorm(h), Linear(h, 4 * h, compute_dtype=dtype, generator=generator),
                             Linear(4 * h, h, compute_dtype=dtype, generator=generator), self.activation)
                  for _ in range(self.num_blocks)]
        return Simba(input_proj, blocks, LayerNorm(h), input_dim, h)


Simba.Factory = SimbaFactory

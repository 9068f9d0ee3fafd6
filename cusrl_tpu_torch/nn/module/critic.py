"""Value function module (counterpart of ``cusrl_tpu/nn/module/critic.py``).
The value head is an fp32 ``Linear`` whatever the backbone's compute dtype."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.layer.linear import Linear

__all__ = ["Value", "ValueFactory"]


class Value(nn.Module):
    def __init__(self, backbone: nn.Module, head: Linear):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def is_recurrent(self) -> bool:
        return self.backbone.is_recurrent

    def init_memory(self, batch_size: int):
        return self.backbone.init_memory(batch_size) if self.backbone.is_recurrent else None

    def forward(self, state: torch.Tensor, memory=None, **kwargs):
        """Returns ``(value, new_memory, aux)`` with the value in fp32;
        ``sequential`` and ``done`` pass to the backbone."""
        latent, new_memory, backbone_aux = self.backbone(state, memory, **kwargs)
        value = self.head(latent.float())
        aux = {f"backbone.{k}": v for k, v in backbone_aux.items()}
        aux["backbone.output"] = latent
        return value, new_memory, aux

    # -- counterfactual-append evaluation (nn/base.py contract) ----------------

    @property
    def supports_next_token_eval(self) -> bool:
        return self.backbone.supports_next_token_eval

    def sequential_with_ctx(self, state, memory, done):
        latent, new_memory, ctx = self.backbone.sequential_with_ctx(state, memory, done)
        return self.head(latent.float()), new_memory, ctx

    def eval_next_token(self, y, ctx):
        return self.head(self.backbone.eval_next_token(y, ctx).float())


@dataclasses.dataclass
class ValueFactory:
    backbone_factory: object

    def __call__(self, input_dim: int, value_dim: int, generator: torch.Generator | None = None) -> Value:
        backbone = self.backbone_factory(input_dim, None, generator)
        return Value(backbone, Linear(backbone.output_dim, value_dim, generator=generator))

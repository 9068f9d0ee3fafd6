"""Actor module: backbone + distribution head (counterpart of
``cusrl_tpu/nn/module/actor.py``).  ``aux`` always carries
``"backbone.output"``; a recurrent backbone's memory passes through."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.module.distribution import NormalDist, NormalDistFactory, OneHotCategoricalDist

__all__ = ["Actor", "ActorFactory"]


class Actor(nn.Module):
    def __init__(self, backbone: nn.Module, distribution: NormalDist | OneHotCategoricalDist):
        super().__init__()
        self.backbone = backbone
        self.distribution = distribution

    @property
    def is_recurrent(self) -> bool:
        return self.backbone.is_recurrent

    def init_memory(self, batch_size: int):
        return self.backbone.init_memory(batch_size) if self.backbone.is_recurrent else None

    def forward(self, observation: torch.Tensor, memory=None, **kwargs):
        """Returns ``(dist_params, new_memory, aux)``; ``sequential`` and
        ``done`` pass to the backbone."""
        latent, new_memory, backbone_aux = self.backbone(observation, memory, **kwargs)
        dist_params = self.distribution(latent)
        aux = {f"backbone.{k}": v for k, v in backbone_aux.items()}
        aux["backbone.output"] = latent
        return dist_params, new_memory, aux

    def explore(self, observation, generator: torch.Generator | None = None, memory=None, *,
                noise: torch.Tensor | None = None, **kwargs):
        """Samples an action: ``(dist_params, (action, logp), new_memory, aux)``.
        ``noise`` replaces the draw from ``generator`` when given."""
        dist_params, new_memory, aux = self(observation, memory, **kwargs)
        action, logp = self.distribution.sample(dist_params, generator, noise)
        return dist_params, (action, logp), new_memory, aux

    def act_deterministic(self, observation, memory=None, **kwargs):
        """``(the distribution's mode from the backbone's latent, new_memory)``."""
        latent, new_memory, _ = self.backbone(observation, memory, **kwargs)
        return self.distribution.determine(latent), new_memory

    def compute_logp(self, dist_params, action):
        return self.distribution.compute_logp(dist_params, action)

    def compute_entropy(self, dist_params):
        return self.distribution.compute_entropy(dist_params)

    def compute_kl_div(self, p, q):
        return self.distribution.compute_kl_div(p, q)


@dataclasses.dataclass
class ActorFactory:
    backbone_factory: object
    distribution_factory: object = dataclasses.field(default_factory=NormalDistFactory)

    def __call__(self, input_dim: int, action_dim: int, generator: torch.Generator | None = None) -> Actor:
        backbone = self.backbone_factory(input_dim, None, generator)
        distribution = self.distribution_factory(backbone.output_dim, action_dim, generator)
        return Actor(backbone, distribution)

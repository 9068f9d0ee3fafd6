"""Weight initialization hook (counterpart of
``cusrl_tpu/hook/control/initialization.py``): orthogonal weights with gain
``scale`` (sqrt 2), ``scale_dist`` (sqrt 2 * 0.1) for the actor's
distribution mean head, and zero biases."""

from __future__ import annotations

import math

import torch

from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["ModuleInitialization"]


class ModuleInitialization(Hook):
    def __init__(
        self,
        scale: float = math.sqrt(2),
        scale_dist: float = math.sqrt(2) * 0.1,
        zero_bias: bool = True,
        init_actor: bool = True,
        init_critic: bool = True,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.scale = scale
        self.scale_dist = scale_dist
        self.zero_bias = zero_bias
        self.init_actor = init_actor
        self.init_critic = init_critic

    @torch.no_grad()
    def _reinit(self, module: torch.nn.Module, generator: torch.Generator,
                gain_overrides: dict[str, float]) -> list[str]:
        """Re-initializes every ``Linear`` below ``module`` (the transformer's
        input, attention, feed-forward and gate projections included);
        returns their paths."""
        paths = []
        for path, layer in module.named_modules():
            if not isinstance(layer, Linear):
                continue
            paths.append(path)
            gain = self.scale
            for prefix, g in gain_overrides.items():
                if path == prefix or path.startswith(prefix + "."):
                    gain = g
            torch.nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            if self.zero_bias and layer.bias is not None:
                layer.bias.zero_()
        return paths

    def init(self, agent) -> None:
        if self.init_actor:
            self._reinit(agent.actor, agent.init_generator, {"distribution.mean_head": self.scale_dist})
        if self.init_critic:
            self._reinit(agent.critic, agent.init_generator, {})

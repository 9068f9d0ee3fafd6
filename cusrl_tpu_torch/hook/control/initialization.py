"""Weight initialization hook (counterpart of
``cusrl_tpu/hook/control/initialization.py``): orthogonal weights with gain
``scale`` (sqrt 2), ``scale_dist`` (sqrt 2 * 0.1) for the actor's
distribution mean head, and zero biases.  ``orthogonal`` draws one such
matrix; ``map_linear_layers`` applies ``fn(path, linear)`` to every
``Linear`` below a module, in place."""

from __future__ import annotations

import math

import torch

from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["ModuleInitialization", "map_linear_layers", "orthogonal"]


def orthogonal(generator: torch.Generator | None, shape: tuple[int, int], gain: float = 1.0) -> torch.Tensor:
    """An fp32 ``shape`` matrix with orthonormal rows or columns, times ``gain``."""
    return torch.nn.init.orthogonal_(torch.empty(shape), gain=gain, generator=generator)


@torch.no_grad()
def map_linear_layers(module: torch.nn.Module, fn) -> list[str]:
    """Calls ``fn(path, linear)`` on every ``Linear`` below ``module`` (its
    weights change in place); returns their paths."""
    paths = []
    for path, layer in module.named_modules():
        if isinstance(layer, Linear):
            fn(path, layer)
            paths.append(path)
    return paths


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

    def _reinit(self, module: torch.nn.Module, generator: torch.Generator,
                gain_overrides: dict[str, float]) -> list[str]:
        """Re-initializes every ``Linear`` below ``module`` (the transformer's
        input, attention, feed-forward and gate projections included);
        returns their paths."""
        def fn(path: str, layer: Linear) -> None:
            gain = self.scale
            for prefix, g in gain_overrides.items():
                if path == prefix or path.startswith(prefix + "."):
                    gain = g
            torch.nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            if self.zero_bias and layer.bias is not None:
                layer.bias.zero_()

        return map_linear_layers(module, fn)

    def init(self, agent) -> None:
        if self.init_actor:
            self._reinit(agent.actor, agent.init_generator, {"distribution.mean_head": self.scale_dist})
        if self.init_critic:
            self._reinit(agent.critic, agent.init_generator, {})

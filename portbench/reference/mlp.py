"""The plain MLP actor-critic: two ELU backbones of the same widths, an
fp32 Gaussian mean head with a state-independent log standard deviation,
and an fp32 value head.  The standard deviation is ``exp(clip(p, log
lo, log hi))`` (``std_bounds`` = (lo, hi)); a parameter exactly on a bound
takes half of its gradient (``clip`` as a minimum of a maximum, whose
gradient splits evenly on ties: ``jnp.clip``'s rule, which the
configuration's published semantics follow).

Parameters are a dict of fp32 tensors under the checkpoint's dotted paths
(``actor.backbone.layers.<i>.weight`` ``[out, in]``, ``.bias``;
``actor.distribution.mean_head.*``, ``actor.distribution.std_param``;
``critic.backbone.layers.<i>.*``, ``critic.head.*``).  Every function maps
``[..., D]`` row by row.  ``precision`` names the backbones' products
(``"fp32"`` for the reference) and the heads' (``"fp32"``); the control
lowers both (``precision.lower``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import linear

__all__ = ["MlpActorCritic", "bounded_std"]


def bounded_std(param: torch.Tensor, bounds) -> torch.Tensor:
    lo, hi = (math.log(b) for b in bounds)
    param = param.float()
    return torch.exp(torch.minimum(torch.maximum(param, torch.full_like(param, lo)), torch.full_like(param, hi)))


class MlpActorCritic:
    temporal = False

    def __init__(self, num_layers: int, backbone_precision: str = "fp32", head_precision: str = "fp32",
                 std_bounds: tuple = (0.01, 1.0)):
        self.num_layers = num_layers
        self.std_bounds = std_bounds
        self.backbone_precision = backbone_precision
        self.head_precision = head_precision

    def _backbone(self, params: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.elu(linear(x, params[f"{prefix}.backbone.layers.{i}.weight"], params[f"{prefix}.backbone.layers.{i}.bias"],
                             self.backbone_precision))
        return x

    def actor(self, params: dict, obs: torch.Tensor, done: torch.Tensor | None = None) -> dict:
        """``{"mean", "std"}`` of the action distribution."""
        latent = self._backbone(params, "actor", obs)
        mean = linear(latent, params["actor.distribution.mean_head.weight"],
                      params["actor.distribution.mean_head.bias"], self.head_precision)
        std = bounded_std(params["actor.distribution.std_param"], self.std_bounds).expand_as(mean)
        return {"mean": mean, "std": std}

    def critic(self, params: dict, obs: torch.Tensor, done: torch.Tensor | None = None) -> torch.Tensor:
        latent = self._backbone(params, "critic", obs)
        return linear(latent, params["critic.head.weight"], params["critic.head.bias"], self.head_precision)

    def critic_values(self, params: dict, obs: torch.Tensor, next_obs: torch.Tensor, done: torch.Tensor):
        """The rollout's values and the values of each step's next observation."""
        return self.critic(params, obs), self.critic(params, next_obs)

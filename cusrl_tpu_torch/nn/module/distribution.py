"""Normal action distribution (counterpart of ``NormalDist`` in
``cusrl_tpu/nn/module/distribution.py``).

All distribution math is fp32 whatever the backbone's compute dtype: the mean
head is an fp32 ``Linear`` and parameters, log-probabilities, entropy and KL
are computed in fp32.  Distribution parameters are plain dicts of tensors so
they store directly into transitions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cusrl_tpu_torch.nn.layer.bijector import Bijector, make_bijector
from cusrl_tpu_torch.nn.layer.linear import Linear

__all__ = ["NormalDist", "NormalDistFactory"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _normal_logp(mean, std, x):
    z = (x - mean) / std
    return torch.sum(-0.5 * z.square() - torch.log(std) - _LOG_SQRT_2PI, dim=-1, keepdim=True)


class NormalDist(nn.Module):
    """Gaussian with a state-independent learnable std vector (through a bijector)."""

    def __init__(self, mean_head: Linear, std_param: torch.Tensor, bijector: Bijector):
        super().__init__()
        self.mean_head = mean_head
        self.std_param = nn.Parameter(std_param)
        self.bijector = bijector

    @property
    def input_dim(self) -> int:
        return self.mean_head.input_dim

    @property
    def output_dim(self) -> int:
        return self.mean_head.output_dim

    def forward(self, backbone_feat: torch.Tensor) -> dict[str, torch.Tensor]:
        mean = self.mean_head(backbone_feat.float())
        std = self.bijector(self.std_param.float()).expand_as(mean)
        return {"mean": mean, "std": std}

    def sample(self, dist_params, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """``(action, logp)``; ``noise`` (standard normal, the mean's shape)
        replaces the draw from ``generator`` when given."""
        mean, std = dist_params["mean"].float(), dist_params["std"].float()
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = mean + std * noise.float()
        return action, _normal_logp(mean, std, action)

    def compute_logp(self, dist_params, sample):
        return _normal_logp(dist_params["mean"].float(), dist_params["std"].float(), sample.float())

    def compute_entropy(self, dist_params):
        std = dist_params["std"].float()
        return torch.sum(torch.log(std) + 0.5 + _LOG_SQRT_2PI, dim=-1, keepdim=True)

    def compute_kl_div(self, p, q):
        mean1, std1 = p["mean"].float(), p["std"].float()
        mean2, std2 = q["mean"].float(), q["std"].float()
        var_ratio = (std1 / std2).square()
        kl = 0.5 * (var_ratio + ((mean2 - mean1) / std2).square() - 1.0) - torch.log(std1 / std2)
        return torch.sum(kl, dim=-1, keepdim=True)


@dataclasses.dataclass
class NormalDistFactory:
    init_std: float | None = None
    bijector: str | None = "exp"

    def __call__(self, input_dim: int, output_dim: int, generator: torch.Generator | None = None) -> NormalDist:
        bij = make_bijector(self.bijector)
        init_std = 1.0 if self.init_std is None else self.init_std
        if init_std <= 0:
            raise ValueError("'init_std' must be positive")
        return NormalDist(
            mean_head=Linear(input_dim, output_dim, generator=generator),
            std_param=torch.full((output_dim,), bij.inverse(init_std)),
            bijector=bij,
        )

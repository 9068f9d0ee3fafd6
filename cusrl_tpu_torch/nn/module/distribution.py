"""Action distributions (counterpart of ``Distribution``, ``NormalDist``,
``AdaptiveNormalDist`` and ``OneHotCategoricalDist`` in
``cusrl_tpu/nn/module/distribution.py``).

All distribution math is fp32 whatever the backbone's compute dtype: the mean
head is an fp32 ``Linear`` and parameters, log-probabilities, entropy and KL
are computed in fp32.  Distribution parameters are plain dicts of tensors so
they store directly into transitions.  ``determine(latent)`` and
``mode(dist_params)`` give the deterministic action (the mean, or the
argmax's one-hot vector).  ``AdaptiveNormalDist`` takes its std from an
fp32 head on the latent (zero weights and the bijector's inverse of
``init_std`` as bias at start, as in JAX); with ``backward=False`` the std
head reads a detached latent, so its loss reaches the head but not the
backbone.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cusrl_tpu_torch.nn.layer.bijector import Bijector, make_bijector
from cusrl_tpu_torch.nn.layer.linear import Linear

__all__ = [
    "AdaptiveNormalDist",
    "Distribution",
    "AdaptiveNormalDistFactory",
    "NormalDist",
    "NormalDistFactory",
    "OneHotCategoricalDist",
    "OneHotCategoricalDistFactory",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _normal_logp(mean, std, x):
    z = (x - mean) / std
    return torch.sum(-0.5 * z.square() - torch.log(std) - _LOG_SQRT_2PI, dim=-1, keepdim=True)


class Distribution(nn.Module):
    """Action distribution head: backbone features -> distribution parameters
    through ``mean_head``.  Subclasses give ``sample`` and ``compute_logp``;
    entropy and KL default to single-sample Monte-Carlo estimates."""

    @property
    def input_dim(self) -> int:
        return self.mean_head.input_dim

    @property
    def output_dim(self) -> int:
        return self.mean_head.output_dim

    def sample(self, dist_params, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        raise NotImplementedError

    def compute_logp(self, dist_params, sample):
        raise NotImplementedError

    def compute_entropy(self, dist_params, generator: torch.Generator | None = None):
        return -self.sample(dist_params, generator)[1]

    def compute_kl_div(self, p, q, generator: torch.Generator | None = None):
        sample, logp = self.sample(p, generator)
        return logp - self.compute_logp(q, sample)

    def determine(self, backbone_feat: torch.Tensor) -> torch.Tensor:
        return self.mean_head(backbone_feat.float())

    def mode(self, dist_params) -> torch.Tensor:
        return dist_params["mean"]


class _Normal(Distribution):
    """Diagonal-Gaussian math in fp32, shared by the two Normal heads."""

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


class NormalDist(_Normal):
    """Gaussian with a state-independent learnable std vector (through a bijector)."""

    def __init__(self, mean_head: Linear, std_param: torch.Tensor, bijector: Bijector):
        super().__init__()
        self.mean_head = mean_head
        self.std_param = nn.Parameter(std_param)
        self.bijector = bijector

    def forward(self, backbone_feat: torch.Tensor) -> dict[str, torch.Tensor]:
        mean = self.mean_head(backbone_feat.float())
        std = self.bijector(self.std_param.float()).expand_as(mean)
        return {"mean": mean, "std": std}


class AdaptiveNormalDist(_Normal):
    """Gaussian with a state-dependent std: ``bijector(std_head(latent))``."""

    def __init__(self, mean_head: Linear, std_head: Linear, bijector: Bijector, backward: bool = True):
        super().__init__()
        self.mean_head = mean_head
        self.std_head = std_head
        self.bijector = bijector
        self.backward = backward

    def forward(self, backbone_feat: torch.Tensor) -> dict[str, torch.Tensor]:
        feat = backbone_feat.float()
        mean = self.mean_head(feat)
        std = self.bijector(self.std_head(feat if self.backward else feat.detach()))
        return {"mean": mean, "std": std.float()}


def _one_hot(index: torch.Tensor, num_classes: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(index, num_classes).float()


class OneHotCategoricalDist(Distribution):
    """One-hot categorical over the logits of an fp32 head, with
    straight-through samples: the forward value is the drawn one-hot vector,
    the gradient the softmax's."""

    def __init__(self, mean_head: Linear):
        super().__init__()
        self.mean_head = mean_head

    def forward(self, backbone_feat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"logits": self.mean_head(backbone_feat.float())}

    def sample(self, dist_params, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """``(action, logp)``: the one-hot ``argmax(logits + noise)``, ``noise``
        a standard Gumbel draw of the logits' shape (the JAX package's
        ``jax.random.categorical``), drawn from ``generator`` unless given."""
        logits = dist_params["logits"].float()
        if noise is None:
            tiny = torch.finfo(torch.float32).tiny
            uniform = torch.rand(logits.shape, generator=generator, device=logits.device) * (1.0 - tiny) + tiny
            noise = -torch.log(-torch.log(uniform))
        hard = _one_hot(torch.argmax(logits + noise.float(), dim=-1), logits.shape[-1])
        soft = torch.softmax(logits, dim=-1)
        action = soft + (hard - soft).detach()  # forward: hard; backward: the softmax's
        logp = torch.sum(torch.log_softmax(logits, dim=-1) * hard, dim=-1, keepdim=True)
        return action, logp

    def compute_logp(self, dist_params, sample):
        logp = torch.log_softmax(dist_params["logits"].float(), dim=-1)
        return torch.sum(logp * sample.float(), dim=-1, keepdim=True)

    def compute_entropy(self, dist_params):
        logp = torch.log_softmax(dist_params["logits"].float(), dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1, keepdim=True)

    def compute_kl_div(self, p, q):
        logp = torch.log_softmax(p["logits"].float(), dim=-1)
        logq = torch.log_softmax(q["logits"].float(), dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1, keepdim=True)

    def determine(self, backbone_feat: torch.Tensor) -> torch.Tensor:
        return self.mode(self(backbone_feat))

    def mode(self, dist_params) -> torch.Tensor:
        logits = dist_params["logits"]
        return _one_hot(torch.argmax(logits, dim=-1), logits.shape[-1])


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


@dataclasses.dataclass
class AdaptiveNormalDistFactory:
    init_std: float | None = None
    bijector: str | None = "exp"
    backward: bool = True

    def __call__(self, input_dim: int, output_dim: int,
                 generator: torch.Generator | None = None) -> AdaptiveNormalDist:
        bij = make_bijector(self.bijector)
        init_std = 1.0 if self.init_std is None else self.init_std
        if init_std <= 0:
            raise ValueError("'init_std' must be positive")
        mean_head = Linear(input_dim, output_dim, generator=generator)
        std_head = Linear(input_dim, output_dim)
        with torch.no_grad():
            std_head.weight.zero_()
            std_head.bias.fill_(bij.inverse(init_std))
        return AdaptiveNormalDist(
            mean_head=mean_head,
            std_head=std_head,
            bijector=bij,
            backward=self.backward,
        )


@dataclasses.dataclass
class OneHotCategoricalDistFactory:
    def __call__(self, input_dim: int, output_dim: int,
                 generator: torch.Generator | None = None) -> OneHotCategoricalDist:
        return OneHotCategoricalDist(mean_head=Linear(input_dim, output_dim, generator=generator))

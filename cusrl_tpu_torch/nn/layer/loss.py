"""Loss utilities (counterpart of ``cusrl_tpu/nn/layer/loss.py``).

``gradient_penalty`` differentiates ``fn`` with respect to its input with
``create_graph=True``, so the penalty itself can be differentiated again
(with respect to ``fn``'s parameters): every operation of ``fn`` must be
twice differentiable.  The fused kernels' backward is first-order and raises
under a second derivative, so a network behind ``fn`` runs its plain layers
(``MlpFactory(fused_kernel=False)``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

__all__ = ["GradientPenaltyLoss", "L2RegularizationLoss", "NormalNllLoss", "gradient_penalty"]


def gradient_penalty(fn: Callable[[torch.Tensor], torch.Tensor], inputs: torch.Tensor, *,
                     reduce_mean: bool = True) -> torch.Tensor:
    """``E[||d fn(x) / d x||^2]``: the per-sample squared norm of the
    gradient of ``sum(fn(x))`` at ``inputs``, averaged over the leading axis
    (or per sample without ``reduce_mean``); differentiable to second order."""
    x = inputs if inputs.requires_grad else inputs.detach().requires_grad_()
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
    per_sample = grads.reshape(grads.shape[0], -1).square().sum(-1)
    return per_sample.mean() if reduce_mean else per_sample


class GradientPenaltyLoss:
    def __init__(self, reduce_mean: bool = True):
        self.reduce_mean = reduce_mean

    def __call__(self, fn, inputs):
        return gradient_penalty(fn, inputs, reduce_mean=self.reduce_mean)


class NormalNllLoss:
    """Negative log-likelihood of targets under a diagonal Gaussian prediction."""

    def __init__(self, eps: float = 1e-6, full: bool = False):
        self.eps = eps
        self.full = full

    def __call__(self, mean, var, target):
        var = torch.clamp(var.float(), min=self.eps)
        nll = 0.5 * (torch.log(var) + (target - mean).square() / var)
        if self.full:
            nll = nll + 0.5 * math.log(2.0 * math.pi)
        return nll.mean()


class L2RegularizationLoss:
    """Mean squared magnitude of a set of parameters (weight decay as a loss):
    ``weight * sum(p^2) / count`` over every element."""

    def __init__(self, weight: float = 1.0):
        self.weight = weight

    def __call__(self, params: Iterable[torch.Tensor] | torch.nn.Module) -> torch.Tensor:
        leaves = list(params.parameters() if isinstance(params, torch.nn.Module) else params)
        if not leaves:
            return torch.zeros(())
        total = sum(leaf.float().square().sum() for leaf in leaves)
        count = sum(leaf.numel() for leaf in leaves)
        return self.weight * total / count

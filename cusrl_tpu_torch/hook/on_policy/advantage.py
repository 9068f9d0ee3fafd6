"""Advantage normalization (counterpart of ``AdvantageNormalization`` in
``cusrl_tpu/hook/on_policy/advantage.py``): standardize over every axis but
the last, with the population variance and ``1e-8`` inside the root, once
over the whole rollout (the minibatch-wise variant is not ported yet)."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils import distributed

__all__ = ["AdvantageNormalization", "standardize"]


def standardize(advantage: torch.Tensor, group=None) -> torch.Tensor:
    """Standardized ``advantage``; under a process ``group`` with the mean
    and variance of every rank's rows (``merge_moments``)."""
    advantage = advantage.float()
    dims = tuple(range(advantage.dim() - 1))
    mean = advantage.mean(dim=dims)
    var = advantage.var(dim=dims, unbiased=False)
    if group is not None:
        count = torch.full((), advantage[..., 0].numel(), dtype=torch.float32, device=advantage.device)
        mean, var, _ = distributed.merge_moments(mean, var, count, group)
    return (advantage - mean) / torch.sqrt(var + 1e-8)


class AdvantageNormalization(Hook):
    training_only = True
    batch_keys = ("advantage",)

    def pre_update(self, agent, rollout: dict) -> dict:
        rollout["advantage"] = standardize(rollout["advantage"], getattr(agent, "process_group", None))
        return {}

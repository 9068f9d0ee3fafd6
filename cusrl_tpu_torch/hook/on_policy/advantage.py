"""Advantage post-processing (counterpart of
``cusrl_tpu/hook/on_policy/advantage.py``).  ``AdvantageNormalization``
standardizes over every axis but the last, with the population variance and
``1e-8`` inside the root, once over the whole rollout, or with
``mini_batch_wise`` over each minibatch in ``objective``.  Under a
data-parallel agent either takes the moments of every rank's rows (the
global rollout, or the global minibatch).  ``AdvantageReduction`` reduces
multi-reward advantages to one channel per row: a weighted sum or mean."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils import distributed

__all__ = ["AdvantageNormalization", "AdvantageReduction", "standardize"]


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

    def __init__(self, mini_batch_wise: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.mini_batch_wise = mini_batch_wise

    def pre_update(self, agent, rollout: dict) -> dict:
        if not self.mini_batch_wise:
            rollout["advantage"] = standardize(rollout["advantage"], getattr(agent, "process_group", None))
        return {}

    def objective(self, agent, metadata, batch):
        if self.mini_batch_wise:
            batch["advantage"] = standardize(batch["advantage"], getattr(agent, "process_group", None))
        return None, {}


class AdvantageReduction(Hook):
    jax_config_fields = ("weight",)
    training_only = True
    batch_keys = ("advantage",)

    def __init__(self, reduction: str = "sum", weight: tuple[float, ...] | None = None, **kwargs):
        super().__init__(**kwargs)
        if reduction not in ("sum", "mean"):
            raise ValueError(f"Unsupported reduction '{reduction}'")
        self.reduction = reduction
        self.weight = None if weight is None else tuple(weight)

    def objective(self, agent, metadata, batch):
        advantage = batch["advantage"]
        if self.weight is not None:
            advantage = advantage * torch.tensor(self.weight, dtype=advantage.dtype, device=advantage.device)
        reduce = torch.sum if self.reduction == "sum" else torch.mean
        batch["advantage"] = reduce(advantage, dim=-1, keepdim=True)
        return None, {}

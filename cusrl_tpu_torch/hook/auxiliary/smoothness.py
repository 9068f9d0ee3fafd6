"""Action smoothness penalties (counterpart of
``cusrl_tpu/hook/auxiliary/smoothness.py``): finite differences of the
policy's mean along the time axis of a temporal ``[T, B, A]`` batch, the
pairs that span an episode boundary masked out with the done flags::

    1st order:  |a[t+1] - a[t]|              valid unless done[t]
    2nd order:  |a[t+2] - 2 a[t+1] + a[t]|   valid unless done[t] or done[t+1]

Each weight is a scalar or one per action channel.  Under a data-parallel
agent each loss is the mean over every rank's valid pairs: the ranks'
counts summed in one all-reduce, and the rank's term of that mean
(``utils.distributed.mean_term``).
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils import distributed

__all__ = ["ActionSmoothnessLoss"]


def _weight(weight, device):
    """A scalar weight as a host float (no copy to the device), a per-channel
    one as a tensor."""
    if isinstance(weight, (int, float)):
        return float(weight)
    return torch.tensor(weight, dtype=torch.float32, device=device)


def _masked_sums(values: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the valid values, their count)``."""
    weight = valid.float()
    return (values * weight).sum(), weight.sum() * values.shape[-1]


class ActionSmoothnessLoss(Hook):
    jax_config_fields = ("weight_1st_order", "weight_2nd_order")
    training_only = True
    batch_keys = ("done",)

    def __init__(self, weight_1st_order: float | tuple[float, ...] | None = None,
                 weight_2nd_order: float | tuple[float, ...] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.weight_1st_order = weight_1st_order
        self.weight_2nd_order = weight_2nd_order

    def objective(self, agent, metadata, batch):
        if not metadata.get("temporal"):
            raise ValueError("ActionSmoothnessLoss requires temporal batches")
        mean = batch["curr_action_dist"]["mean"]  # [T, B, A]
        if mean.shape[0] < 3:
            raise ValueError(f"Sequences need >= 3 steps; got {mean.shape[0]}")
        not_boundary = ~batch["done"]  # [T, B, 1]
        sums = {}
        if self.weight_1st_order is not None:
            weight = _weight(self.weight_1st_order, mean.device)
            diff = (mean[1:] - mean[:-1]).abs()
            sums["action_smoothness_1st_order_loss"] = _masked_sums(
                (weight * diff).sum(-1, keepdim=True), not_boundary[:-1])
        if self.weight_2nd_order is not None:
            weight = _weight(self.weight_2nd_order, mean.device)
            diff = (mean[2:] - 2.0 * mean[1:-1] + mean[:-2]).abs()
            sums["action_smoothness_2nd_order_loss"] = _masked_sums(
                (weight * diff).sum(-1, keepdim=True), not_boundary[:-2] & not_boundary[1:-1])
        if not sums:
            return None, {}
        group = getattr(agent, "process_group", None)
        if group is None:
            return {key: total / torch.clamp(count, min=1.0) for key, (total, count) in sums.items()}, {}
        counts = distributed.weighted_sum(torch.stack([count for _, count in sums.values()]), 1.0, group)
        return {key: distributed.mean_term(total, torch.clamp(count, min=1.0), agent.row_share)
                for (key, (total, _)), count in zip(sums.items(), counts.unbind())}, {}

"""Action smoothness penalties (counterpart of
``cusrl_tpu/hook/auxiliary/smoothness.py``): finite differences of the
policy's mean along the time axis of a temporal ``[T, B, A]`` batch, the
pairs that span an episode boundary masked out with the done flags::

    1st order:  |a[t+1] - a[t]|              valid unless done[t]
    2nd order:  |a[t+2] - 2 a[t+1] + a[t]|   valid unless done[t] or done[t+1]

Each weight is a scalar or one per action channel.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["ActionSmoothnessLoss"]


def _weight(weight, device):
    """A scalar weight as a host float (no copy to the device), a per-channel
    one as a tensor."""
    if isinstance(weight, (int, float)):
        return float(weight)
    return torch.tensor(weight, dtype=torch.float32, device=device)


def _masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    weight = valid.float()
    return (values * weight).sum() / torch.clamp(weight.sum() * values.shape[-1], min=1.0)


class ActionSmoothnessLoss(Hook):
    jax_config_fields = ("weight_1st_order", "weight_2nd_order")
    training_only = True
    data_parallel = False
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
        objectives = {}
        if self.weight_1st_order is not None:
            weight = _weight(self.weight_1st_order, mean.device)
            diff = (mean[1:] - mean[:-1]).abs()
            objectives["action_smoothness_1st_order_loss"] = _masked_mean(
                (weight * diff).sum(-1, keepdim=True), not_boundary[:-1])
        if self.weight_2nd_order is not None:
            weight = _weight(self.weight_2nd_order, mean.device)
            diff = (mean[2:] - 2.0 * mean[1:-1] + mean[:-2]).abs()
            objectives["action_smoothness_2nd_order_loss"] = _masked_mean(
                (weight * diff).sum(-1, keepdim=True), not_boundary[:-2] & not_boundary[1:-1])
        return objectives or None, {}

"""Generalized Advantage Estimation (counterpart of
``cusrl_tpu/hook/on_policy/gae.py``): the reverse recurrence as a Python loop
over the time axis, in fp32, with the optional distinct ``lamda_value`` for
the return targets.  With ``recompute`` the advantages and returns are
computed afresh for every minibatch in ``objective`` (from the batch's
rewards, dones, values and next values) instead of once in ``pre_update``;
that needs temporal batches, whose time axis is intact."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["GeneralizedAdvantageEstimation", "generalized_advantage_estimation"]


def generalized_advantage_estimation(reward, done, value, next_value, gamma: float, lamda: float):
    """``A[t] = delta[t] + (1 - done[t]) * gamma * lamda * A[t+1]`` with
    ``delta[t] = r[t] + gamma * V'[t] - V[t]`` over ``[T, N, Dr]`` tensors."""
    not_done = 1.0 - done.float()
    delta = reward.float() + gamma * next_value.float() - value.float()
    advantage = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in reversed(range(delta.shape[0])):
        carry = delta[t] + not_done[t] * gamma * lamda * carry
        advantage[t] = carry
    return advantage


class GeneralizedAdvantageEstimation(Hook):
    training_only = True

    def __init__(self, gamma: float = 0.99, lamda: float = 0.95, lamda_value: float | None = None,
                 recompute: bool = False, **kwargs):
        super().__init__(**kwargs)
        if not 0 <= gamma < 1:
            raise ValueError(f"'gamma' must be in [0, 1); got {gamma}")
        if not 0 <= lamda <= 1:
            raise ValueError(f"'lamda' must be in [0, 1]; got {lamda}")
        if lamda_value is not None and not 0 <= lamda_value <= 1:
            raise ValueError(f"'lamda_value' must be in [0, 1]; got {lamda_value}")
        self.gamma = gamma
        self.lamda = lamda
        self.lamda_value = lamda_value
        self.recompute = recompute
        # What a recomputing objective reads of the batch.
        self.batch_keys = ("reward", "done", "value", "next_value") if recompute else ()

    def _compute(self, data: dict) -> None:
        args = (data["reward"], data["done"], data["value"], data["next_value"], self.gamma)
        advantage = generalized_advantage_estimation(*args, self.lamda)
        value_advantage = advantage if self.lamda_value is None else generalized_advantage_estimation(
            *args, self.lamda_value
        )
        data["advantage"] = advantage
        data["return"] = data["value"].float() + value_advantage

    def pre_update(self, agent, rollout: dict) -> dict:
        if not self.recompute:
            self._compute(rollout)
        return {}

    def objective(self, agent, metadata, batch):
        if self.recompute:
            if not metadata.get("temporal"):
                raise RuntimeError("GAE recompute requires temporal batches (time axis intact)")
            with torch.no_grad():  # the inputs are rollout constants
                self._compute(batch)
        return None, {}

"""Value computation and value loss hooks (counterpart of
``cusrl_tpu/hook/on_policy/value.py``).

Only the feedforward ``deferred=True`` branch of ``ValueComputation`` is
ported: no critic pass runs during the rollout; ``pre_update`` evaluates the
critic over the whole ``[T*N]`` rollout twice (observations, then next
observations for the bootstrap).  ``next_value[t] = value[t + 1]``, the
bootstrap value where the step truncated and at the last step, and
``termination_value`` where it terminated: termination overrides the
truncation bootstrap, as in the JAX package (``value.py:223-229``).  The
environments of this slice always return the final state of a truncated
episode, so the JAX branch for environments that do not is not ported yet.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["ValueComputation", "ValueLoss", "compute_next_value"]


def compute_next_value(value, bootstrap, terminated, truncated, termination_value: float = 0.0):
    """``[T, N, Dr]`` next-step values with truncation bootstrap and
    termination override."""
    next_value = torch.cat([value[1:], bootstrap[-1:]], dim=0)
    next_value = torch.where(truncated, bootstrap, next_value)
    # A Python scalar, not a host tensor: the latter is copied to the device
    # and waits for it.
    return torch.where(terminated, float(termination_value), next_value)


class ValueComputation(Hook):
    def __init__(self, termination_value: float = 0.0, sparse_bootstrap: bool = False, **kwargs):
        super().__init__(**kwargs)
        if sparse_bootstrap:
            raise NotImplementedError("sparse_bootstrap is not ported yet")
        self.termination_value = termination_value

    def init(self, agent) -> None:
        if agent.critic.is_recurrent:
            raise NotImplementedError("recurrent critics (per-step and deferred='sequential') are not ported yet")

    def pre_update(self, agent, rollout: dict) -> dict:
        critic = agent.critic
        observation = get_first(rollout, "state", "observation")
        next_state = get_first(rollout, "next_state", "next_observation")
        t, n = observation.shape[:2]

        def eval_batched(states):
            value, _, _ = critic(states.reshape(t * n, *states.shape[2:]))
            return value.reshape(t, n, -1)

        value = eval_batched(observation)
        bootstrap = eval_batched(next_state)
        rollout["value"] = value
        rollout["next_value"] = compute_next_value(
            value, bootstrap, rollout["terminated"], rollout["truncated"], self.termination_value
        )
        return {}


class ValueLoss(Hook):
    """MSE or PPO-clipped value regression toward the computed returns."""

    training_only = True
    batch_keys = ("value", "return", "observation", "state")

    def __init__(self, weight: float = 0.5, loss_clip: float | None = None, **kwargs):
        super().__init__(**kwargs)
        if weight <= 0:
            raise ValueError("'weight' must be positive")
        if loss_clip is not None and loss_clip <= 0:
            raise ValueError("'loss_clip' must be positive or None")
        self.weight = weight
        self.loss_clip = loss_clip

    def objective(self, agent, metadata, batch):
        if "curr_value" in batch:  # precomputed by JointPolicyValueEvaluation
            curr_value = batch["curr_value"]
        else:
            curr_value, _, _ = agent.critic(get_first(batch, "state", "observation"))
            batch["curr_value"] = curr_value
        value, returns = batch["value"], batch["return"]
        if self.loss_clip is None:
            loss = (curr_value - returns).square().mean()
        else:
            clipped = value + torch.clamp(curr_value - value, -self.loss_clip, self.loss_clip)
            loss = torch.maximum((curr_value - returns).square(), (clipped - returns).square()).mean()
        metrics = {"value": curr_value.detach().sum(-1).mean()}
        return {"value_loss": loss * self.weight}, metrics

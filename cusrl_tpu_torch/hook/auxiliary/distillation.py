"""Policy distillation (counterpart of ``cusrl_tpu/hook/auxiliary/distillation.py``).

``PolicyDistillationLoss`` regresses the current policy's mean onto expert
actions already in the batch; ``PolicyDistillation`` also runs a frozen
expert actor during the rollout to produce them.  The expert is ``expert=``
(any actor module) or the actor of a ``package`` export at ``expert_path``
(``export.load_exported_policy``); ``init`` moves it to the agent's device
and freezes it: it is a frozen hook-owned network
(``hooks.<hook_name>.expert.*``, JAX's ``hooks.<index>.expert.*``), out of
the optimizer, gradient clipping and the gradient all-reduce.  A recurrent
expert's memory resets where an episode ends.  Its step runs without a
gradient, so on the card an MLP expert takes the chain forward (K1f) at the
rollout's row count.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.nn.base import reset_memory
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import flatten_nested, map_nested

__all__ = ["PolicyDistillation", "PolicyDistillationLoss"]


class PolicyDistillationLoss(Hook):
    jax_config_fields = ("weight",)

    def __init__(self, target_name: str = "expert_action", weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.target_name = target_name
        self.weight = weight
        self.batch_keys = (target_name,)

    def objective(self, agent, metadata, batch):
        mean = batch["curr_action_dist"]["mean"]
        loss = (mean - batch[self.target_name].detach()).square().mean()
        return {"distillation_loss": loss * self.weight}, {}


class PolicyDistillation(PolicyDistillationLoss):
    """Queries the frozen expert every step; trains the policy toward its
    deterministic actions."""

    def __init__(self, target_name: str = "expert_action", weight: float = 1.0, *, expert=None,
                 expert_path: str | None = None, observation_name: str = "observation", **kwargs):
        super().__init__(target_name, weight, **kwargs)
        self.expert = expert
        self.expert_path = expert_path
        self.observation_name = observation_name
        self.expert_memory = None

    def init(self, agent) -> None:
        expert = self.expert
        if expert is None:
            if not self.expert_path:
                raise ValueError("Provide 'expert' module or 'expert_path'")
            from cusrl_tpu_torch.export import load_exported_policy

            expert = load_exported_policy(self.expert_path)
        self.expert = expert.to(agent.device).requires_grad_(False)
        if expert.is_recurrent:
            self.expert_memory = map_nested(lambda t: t.to(agent.device), expert.init_memory(agent.parallelism))

    def frozen_modules(self) -> dict:
        return {"expert": self.expert}

    def state_tensors(self) -> dict:
        return {} if self.expert_memory is None else flatten_nested(self.expert_memory, "expert_memory")

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        action, new_memory = self.expert.act_deterministic(transition[self.observation_name], self.expert_memory)
        transition[self.target_name] = action
        if new_memory is not None:
            self.expert_memory = reset_memory(new_memory, transition["done"])

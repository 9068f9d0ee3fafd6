"""On-policy batch preparation (counterpart of
``cusrl_tpu/hook/on_policy/common.py``): re-evaluates the policy on the batch
(or takes ``curr_action_dist`` from ``JointPolicyValueEvaluation``) and writes
the log-probabilities, entropy and probability ratios the losses read.  On a
temporal minibatch (whole environments over the rollout) the actor runs in
sequence mode from the stored rollout-initial memory, with done-driven
resets.  With ``calculate_kl_divergence`` (``MiniBatchWiseLRSchedule`` turns
it on) it also writes ``kl_divergence``, KL(rollout policy || current)."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["OnPolicyPreparation"]


class OnPolicyPreparation(Hook):
    training_only = True
    batch_keys = ("observation", "action", "action_logp", "action_dist", "actor_memory", "done")

    def __init__(self, calculate_kl_divergence: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.calculate_kl_divergence = calculate_kl_divergence

    def objective(self, agent, metadata, batch):
        actor = agent.actor
        if "curr_action_dist" in batch:
            action_dist = batch["curr_action_dist"]
            aux = batch.get("actor_intermediate", {})
        else:
            temporal = metadata.get("temporal", False)
            memory = batch.get("actor_memory")
            if temporal and memory is not None:
                memory = map_nested(lambda m: m[0], memory)
            action_dist, _, aux = actor(batch["observation"], memory, sequential=temporal, done=batch.get("done"))
        action_logp = actor.compute_logp(action_dist, batch["action"])
        entropy = actor.compute_entropy(action_dist)
        logp_ratio = action_logp - batch["action_logp"]
        batch["curr_action_dist"] = action_dist
        batch["actor_intermediate"] = aux
        batch["curr_action_logp"] = action_logp
        batch["curr_entropy"] = entropy
        batch["action_logp_ratio"] = logp_ratio
        batch["action_prob_ratio"] = torch.exp(logp_ratio)
        if self.calculate_kl_divergence:
            batch["kl_divergence"] = actor.compute_kl_div(batch["action_dist"], action_dist)
        metrics = {"ratio": logp_ratio.detach().abs().mean(), "entropy": entropy.detach().mean()}
        return None, metrics

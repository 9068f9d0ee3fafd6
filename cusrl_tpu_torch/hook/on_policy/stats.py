"""Post-update on-policy statistics (counterpart of
``cusrl_tpu/hook/on_policy/stats.py``): one policy pass over the whole
rollout after the update, recording the KL divergence to the rollout policy,
the importance-weighted advantage and the action std."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["OnPolicyStatistics"]


class OnPolicyStatistics(Hook):
    training_only = True

    def post_update(self, agent, rollout: dict) -> dict:
        actor = agent.actor
        action_dist, _, _ = actor(rollout["observation"])
        kl = actor.compute_kl_div(rollout["action_dist"], action_dist)
        logp_ratio = actor.compute_logp(action_dist, rollout["action"]) - rollout["action_logp"]
        metrics = {
            "kl_divergence": kl.mean(),
            "importance_weighted_advantage": (rollout["advantage"] * torch.exp(logp_ratio)).mean(),
        }
        if "std" in action_dist:
            metrics["action_std"] = action_dist["std"].mean()
        return metrics

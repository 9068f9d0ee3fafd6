"""Post-update on-policy statistics (counterpart of
``cusrl_tpu/hook/on_policy/stats.py``): one policy pass over the whole
rollout after the update, recording the KL divergence to the rollout policy,
the importance-weighted advantage and the action std.

``compute_rollout_kl`` caches that pass in the rollout dict, keyed by the
actor parameters' version counters: ``OnPolicyStatistics`` and the KL-based
learning-rate schedules share ONE actor pass (one K1f launch over the
98,304-row rollout; for the transformer one K3f and two K1f launches) per
update, and a parameter changed in between (a restored update) invalidates
it.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["OnPolicyStatistics", "compute_rollout_kl"]

_CACHE_KEY = "__post_update_kl__"


def compute_rollout_kl(agent, rollout: dict):
    """``(mean KL(rollout policy || current), current action_dist)`` over the
    whole ``[T, N]`` rollout (a recurrent actor in sequence mode from the
    rollout-initial ``actor_memory``)."""
    actor = agent.actor
    version = tuple(p._version for p in actor.parameters())
    cached = rollout.get(_CACHE_KEY)
    if cached is not None and cached[0] == version:
        return cached[1]
    memory = rollout.get("actor_memory")
    if memory is not None:
        memory = map_nested(lambda m: m[0], memory)
    action_dist, _, _ = actor(rollout["observation"], memory, sequential=actor.is_recurrent, done=rollout.get("done"))
    kl = actor.compute_kl_div(rollout["action_dist"], action_dist)
    result = (kl.mean(), action_dist)
    rollout[_CACHE_KEY] = (version, result)
    return result


class OnPolicyStatistics(Hook):
    training_only = True

    def post_update(self, agent, rollout: dict, snapshot=None) -> dict:
        actor = agent.actor
        kl, action_dist = compute_rollout_kl(agent, rollout)
        logp_ratio = actor.compute_logp(action_dist, rollout["action"]) - rollout["action_logp"]
        metrics = {
            "kl_divergence": kl,
            "importance_weighted_advantage": (rollout["advantage"] * torch.exp(logp_ratio)).mean(),
        }
        if "std" in action_dist:
            metrics["action_std"] = action_dist["std"].mean()
        return metrics

"""Reward shaping hook (counterpart of ``cusrl_tpu/hook/mdp/reward.py``):
``reward * scale + shift``, clipped to ``[lower_bound, upper_bound]`` where
either is set, in ``post_step``."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["RewardShaping"]


class RewardShaping(Hook):
    def __init__(self, scale: float = 1.0, shift: float = 0.0, lower_bound: float | None = None,
                 upper_bound: float | None = None, **kwargs):
        super().__init__(**kwargs)
        self.scale = scale
        self.shift = shift
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        reward = transition["reward"] * self.scale + self.shift
        if self.lower_bound is not None or self.upper_bound is not None:
            reward = torch.clamp(reward, self.lower_bound, self.upper_bound)
        transition["reward"] = reward

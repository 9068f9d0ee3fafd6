"""PPO clipped surrogate and entropy bonus (counterpart of
``cusrl_tpu/hook/on_policy/ppo.py``)."""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["EntropyLoss", "PpoSurrogateLoss", "ppo_surrogate_loss"]


def ppo_surrogate_loss(advantage, prob_ratio, clip_ratio: float):
    advantage = advantage.float()
    clipped = torch.clamp(prob_ratio, 1.0 - clip_ratio, 1.0 + clip_ratio)
    return -torch.minimum(advantage * prob_ratio, advantage * clipped).mean()


class PpoSurrogateLoss(Hook):
    training_only = True
    batch_keys = ("advantage",)

    def __init__(self, clip_ratio: float = 0.2, weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        if clip_ratio <= 0:
            raise ValueError("'clip_ratio' must be positive")
        if weight < 0:
            raise ValueError("'weight' must be non-negative")
        self.clip_ratio = clip_ratio
        self.weight = weight

    def objective(self, agent, metadata, batch):
        advantage = batch["advantage"]
        if advantage.shape[-1] != 1:
            raise ValueError(f"Expected advantage with shape [..., 1]; got {tuple(advantage.shape)}")
        loss = ppo_surrogate_loss(advantage, batch["action_prob_ratio"], self.clip_ratio)
        return {"surrogate_loss": loss * self.weight}, {}


class EntropyLoss(Hook):
    training_only = True

    def __init__(self, weight: float = 0.01, **kwargs):
        super().__init__(**kwargs)
        if weight < 0:
            raise ValueError("'weight' must be non-negative")
        self.weight = weight

    def objective(self, agent, metadata, batch):
        return {"entropy_loss": -batch["curr_entropy"].mean() * self.weight}, {}

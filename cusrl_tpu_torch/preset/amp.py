"""AMP preset (counterpart of ``cusrl_tpu/preset/amp.py``): PPO plus
extrinsic reward scaling and the AMP discriminator, inserted before value
computation (``RewardShaping`` before ``value_computation``, AMP after it)."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from cusrl_tpu_torch.hook.auxiliary.amp import AdversarialMotionPrior
from cusrl_tpu_torch.hook.mdp.reward import RewardShaping
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.template.actor_critic import ActorCriticFactory

__all__ = ["AmpAgentFactory"]


@dataclasses.dataclass(kw_only=True)
class AmpAgentFactory(PpoAgentFactory):
    extrinsic_reward_scale: float = 1.0
    amp_discriminator_hidden_dims: Iterable[int] = (256, 128)
    amp_dataset_source: Any = None
    amp_state_indices: tuple[int, ...] | None = None
    amp_batch_size: int = 512
    amp_reward_scale: float = 1.0
    amp_loss_weight: float = 1.0
    amp_grad_penalty_weight: float = 5.0

    def to_underlying(self) -> ActorCriticFactory:
        underlying = super().to_underlying()
        underlying.register_hook(RewardShaping(scale=self.extrinsic_reward_scale), before="value_computation")
        underlying.register_hook(
            AdversarialMotionPrior(
                discriminator_factory=MlpFactory(
                    hidden_dims=tuple(self.amp_discriminator_hidden_dims),
                    activation=self.activation_fn,
                    ends_with_activation=True,
                    # The gradient penalty differentiates the discriminator to
                    # second order; the kernels' backward is first-order.
                    fused_kernel=False,
                ),
                dataset_source=self.amp_dataset_source,
                state_indices=self.amp_state_indices,
                batch_size=self.amp_batch_size,
                reward_scale=self.amp_reward_scale,
                loss_weight=self.amp_loss_weight,
                grad_penalty_weight=self.amp_grad_penalty_weight,
            ),
            after="reward_shaping",
        )
        return underlying

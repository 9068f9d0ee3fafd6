"""Distillation preset (counterpart of ``cusrl_tpu/preset/distillation.py``):
behavior cloning from a frozen expert, the Stub critic, no value learning,
MSE to the expert's actions."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cusrl_tpu_torch.hook.auxiliary.distillation import PolicyDistillation
from cusrl_tpu_torch.hook.control.initialization import ModuleInitialization
from cusrl_tpu_torch.hook.mdp.observation import ObservationNormalization
from cusrl_tpu_torch.hook.on_policy.common import OnPolicyPreparation
from cusrl_tpu_torch.hook.on_policy.gradient_clipping import GradientClipping
from cusrl_tpu_torch.nn.module.actor import ActorFactory
from cusrl_tpu_torch.nn.module.critic import ValueFactory
from cusrl_tpu_torch.nn.module.distribution import NormalDistFactory
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.nn.module.stub import StubModuleFactory
from cusrl_tpu_torch.preset.optimizer import AdamFactory
from cusrl_tpu_torch.sampler.mini_batch_sampler import AutoMiniBatchSampler
from cusrl_tpu_torch.template.actor_critic import ActorCriticFactory
from cusrl_tpu_torch.template.agent import AgentFactory
from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["DistillationAgentFactory", "distillation_hook_suite"]


def distillation_hook_suite(
    expert_path: str = "",
    expert=None,
    expert_observation_name: str = "observation",
    normalize_observation: bool = False,
    max_grad_norm: float | None = 1.0,
) -> list[Hook]:
    hooks: list[Hook | None] = [
        ModuleInitialization(),
        ObservationNormalization() if normalize_observation else None,
        OnPolicyPreparation(),
        PolicyDistillation(expert_path=expert_path, expert=expert, observation_name=expert_observation_name),
        GradientClipping(max_grad_norm),
    ]
    return [hook for hook in hooks if hook is not None]


@dataclasses.dataclass(kw_only=True)
class DistillationAgentFactory(AgentFactory):
    num_steps_per_update: int = 24
    actor_hidden_dims: Sequence[int] = (256, 128)
    activation_fn: str = "relu"
    lr: float = 2e-4
    sampler_epochs: int = 1
    sampler_mini_batches: int = 8
    init_distribution_std: float | None = None
    expert_path: str = ""
    expert: object = None
    expert_observation_name: str = "observation"
    normalize_observation: bool = False
    max_grad_norm: float | None = 1.0

    def to_underlying(self) -> ActorCriticFactory:
        return ActorCriticFactory(
            num_steps_per_update=self.num_steps_per_update,
            actor_factory=ActorFactory(
                backbone_factory=MlpFactory(hidden_dims=tuple(self.actor_hidden_dims), activation=self.activation_fn,
                                            ends_with_activation=True),
                distribution_factory=NormalDistFactory(init_std=self.init_distribution_std),
            ),
            critic_factory=ValueFactory(backbone_factory=StubModuleFactory()),
            optimizer_factory=AdamFactory(lr=self.lr),
            sampler=AutoMiniBatchSampler(num_epochs=self.sampler_epochs, num_mini_batches=self.sampler_mini_batches),
            hooks=distillation_hook_suite(
                expert_path=self.expert_path,
                expert=self.expert,
                expert_observation_name=self.expert_observation_name,
                normalize_observation=self.normalize_observation,
                max_grad_norm=self.max_grad_norm,
            ),
            name=self.name,
        )

    def __call__(self, environment_spec: EnvironmentSpec, *, device=None, seed: int = 0):
        return self.to_underlying()(environment_spec, device=device, seed=seed)

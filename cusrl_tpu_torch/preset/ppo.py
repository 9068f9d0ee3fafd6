"""PPO presets (counterpart of ``cusrl_tpu/preset/ppo.py``:
``ppo_hook_suite``, ``PpoAgentFactory``, ``RecurrentPpoAgentFactory`` and
``TransformerPpoAgentFactory``).

The hook order is the JAX suite's (``preset/ppo.py:61-111``); with recurrent
backbones the joint evaluation is ``JointSequentialEvaluation``, and the fused
PPO update is built as there, for its ``init`` to refuse them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cusrl_tpu_torch.hook.control.initialization import ModuleInitialization
from cusrl_tpu_torch.hook.mdp.observation import ObservationNormalization
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization
from cusrl_tpu_torch.hook.on_policy.common import OnPolicyPreparation
from cusrl_tpu_torch.hook.on_policy.fused_update import FusedPpoUpdate
from cusrl_tpu_torch.hook.on_policy.gae import GeneralizedAdvantageEstimation
from cusrl_tpu_torch.hook.on_policy.gradient_clipping import GradientClipping
from cusrl_tpu_torch.hook.on_policy.joint_eval import JointPolicyValueEvaluation
from cusrl_tpu_torch.hook.on_policy.joint_seq_eval import JointSequentialEvaluation
from cusrl_tpu_torch.hook.on_policy.lr_schedule import AdaptiveLRSchedule
from cusrl_tpu_torch.hook.on_policy.ppo import EntropyLoss, PpoSurrogateLoss
from cusrl_tpu_torch.hook.on_policy.stats import OnPolicyStatistics
from cusrl_tpu_torch.hook.on_policy.value import ValueComputation, ValueLoss
from cusrl_tpu_torch.nn.module.actor import ActorFactory
from cusrl_tpu_torch.nn.module.critic import ValueFactory
from cusrl_tpu_torch.nn.module.distribution import NormalDistFactory, OneHotCategoricalDistFactory
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.preset.optimizer import AdamFactory
from cusrl_tpu_torch.sampler.mini_batch_sampler import AutoMiniBatchSampler
from cusrl_tpu_torch.template.actor_critic import ActorCriticFactory
from cusrl_tpu_torch.template.agent import AgentFactory
from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.template.hook import Hook

__all__ = [
    "PpoAgentFactory",
    "RecurrentPpoAgentFactory",
    "TransformerPpoAgentFactory",
    "get_distribution_factory",
    "ppo_hook_suite",
]


def ppo_hook_suite(
    orthogonal_init: bool = True,
    normalize_observation: bool = False,
    defer_normalization_updates: bool = False,
    store_original_observations: bool = True,
    sparse_value_bootstrap: bool = False,
    gae_gamma: float = 0.99,
    gae_lamda: float = 0.95,
    gae_lamda_value: float | None = None,
    normalize_advantage: bool = True,
    value_loss_weight: float = 0.5,
    value_loss_clip: float | None = None,
    surrogate_clip_ratio: float = 0.2,
    surrogate_loss_weight: float = 1.0,
    entropy_loss_weight: float = 0.01,
    max_grad_norm: float | None = 1.0,
    grad_clip_groups: dict[str, float] | None = None,
    desired_kl_divergence: float | None = None,
    max_kl_divergence: float | None = None,
    fuse_actor_critic_evaluation: bool = False,
    fused_ppo_update: bool = False,
    recurrent_backbones: bool = False,
) -> list[Hook]:
    if fused_ppo_update:
        # One fused step (K2f + K9s) computes surrogate + value loss and their
        # gradients; entropy stays outside.  Replaces the five-hook span below.
        # As in the JAX suite, recurrent backbones build it too and its init
        # refuses them (ValueError).
        objective_span: list[Hook | None] = [
            FusedPpoUpdate(
                clip_ratio=surrogate_clip_ratio,
                weight=surrogate_loss_weight,
                value_loss_weight=value_loss_weight,
                entropy_loss_weight=entropy_loss_weight,
                value_loss_clip=value_loss_clip,
            )
        ]
    else:
        if not fuse_actor_critic_evaluation:
            joint_eval = None
        elif recurrent_backbones:
            joint_eval = JointSequentialEvaluation()
        else:
            joint_eval = JointPolicyValueEvaluation()
        objective_span = [
            joint_eval,
            ValueLoss(weight=value_loss_weight, loss_clip=value_loss_clip),
            OnPolicyPreparation(),
            PpoSurrogateLoss(clip_ratio=surrogate_clip_ratio, weight=surrogate_loss_weight),
            EntropyLoss(weight=entropy_loss_weight),
        ]
    hooks: list[Hook | None] = [
        ModuleInitialization(init_actor=orthogonal_init, init_critic=orthogonal_init),
        (
            ObservationNormalization(
                defer_updates=defer_normalization_updates, store_originals=store_original_observations
            )
            if normalize_observation
            else None
        ),
        ValueComputation(sparse_bootstrap=sparse_value_bootstrap),
        GeneralizedAdvantageEstimation(gamma=gae_gamma, lamda=gae_lamda, lamda_value=gae_lamda_value),
        AdvantageNormalization() if normalize_advantage else None,
        *objective_span,
        GradientClipping(max_grad_norm, grad_clip_groups),
        OnPolicyStatistics(),
        (
            AdaptiveLRSchedule(desired_kl_divergence, max_kl_divergence=max_kl_divergence)
            if desired_kl_divergence is not None
            else None
        ),
    ]
    return [hook for hook in hooks if hook is not None]


def get_distribution_factory(action_space_type: str, **kwargs):
    """``NormalDistFactory(**kwargs)`` for a continuous action space,
    ``OneHotCategoricalDistFactory()`` for a discrete one."""
    if action_space_type == "continuous":
        return NormalDistFactory(**kwargs)
    if action_space_type == "discrete":
        return OneHotCategoricalDistFactory()
    raise ValueError(f"Unsupported action space type '{action_space_type}'")


@dataclasses.dataclass(kw_only=True)
class PpoAgentFactory(AgentFactory):
    """Flat-kwarg PPO config lowering to ``ActorCriticFactory``; the defaults
    are the JAX factory's."""

    num_steps_per_update: int = 24
    actor_hidden_dims: Sequence[int] = (256, 128)
    critic_hidden_dims: Sequence[int] = (256, 128)
    activation_fn: str = "relu"
    action_space_type: str = "continuous"
    lr: float = 2e-4
    sampler_epochs: int = 5
    sampler_mini_batches: int = 4
    orthogonal_init: bool = True
    init_distribution_std: float | None = None
    normalize_observation: bool = False
    defer_normalization_updates: bool = False
    store_original_observations: bool = True
    sparse_value_bootstrap: bool = False
    gae_gamma: float = 0.99
    gae_lamda: float = 0.95
    gae_lamda_value: float | None = None
    normalize_advantage: bool = True
    value_loss_weight: float = 0.5
    value_loss_clip: float | None = None
    surrogate_clip_ratio: float = 0.2
    surrogate_loss_weight: float = 1.0
    entropy_loss_weight: float = 0.01
    max_grad_norm: float | None = 1.0
    grad_clip_groups: dict[str, float] = dataclasses.field(default_factory=dict)
    desired_kl_divergence: float | None = None
    max_kl_divergence: float | None = None
    fuse_actor_critic_evaluation: bool = False
    fused_ppo_update: bool = False

    def _backbone_factory(self, hidden_dims) -> MlpFactory:
        return MlpFactory(hidden_dims=tuple(hidden_dims), activation=self.activation_fn, ends_with_activation=True)

    def _hooks(self) -> list[Hook]:
        return ppo_hook_suite(
            orthogonal_init=self.orthogonal_init,
            normalize_observation=self.normalize_observation,
            defer_normalization_updates=self.defer_normalization_updates,
            store_original_observations=self.store_original_observations,
            sparse_value_bootstrap=self.sparse_value_bootstrap,
            gae_gamma=self.gae_gamma,
            gae_lamda=self.gae_lamda,
            gae_lamda_value=self.gae_lamda_value,
            normalize_advantage=self.normalize_advantage,
            value_loss_weight=self.value_loss_weight,
            value_loss_clip=self.value_loss_clip,
            surrogate_clip_ratio=self.surrogate_clip_ratio,
            surrogate_loss_weight=self.surrogate_loss_weight,
            entropy_loss_weight=self.entropy_loss_weight,
            max_grad_norm=self.max_grad_norm,
            grad_clip_groups=self.grad_clip_groups,
            desired_kl_divergence=self.desired_kl_divergence,
            max_kl_divergence=self.max_kl_divergence,
            fuse_actor_critic_evaluation=self.fuse_actor_critic_evaluation,
            fused_ppo_update=self.fused_ppo_update,
            recurrent_backbones=self._recurrent_backbones,
        )

    # Subclasses with recurrent backbones flip this (the hook suite's joint
    # evaluation and fused update differ for them).
    _recurrent_backbones = False

    def to_underlying(self) -> ActorCriticFactory:
        return ActorCriticFactory(
            num_steps_per_update=self.num_steps_per_update,
            actor_factory=ActorFactory(
                backbone_factory=self._backbone_factory(self.actor_hidden_dims),
                distribution_factory=get_distribution_factory(self.action_space_type,
                                                              init_std=self.init_distribution_std),
            ),
            critic_factory=ValueFactory(backbone_factory=self._backbone_factory(self.critic_hidden_dims)),
            optimizer_factory=AdamFactory(lr=self.lr),
            sampler=AutoMiniBatchSampler(num_epochs=self.sampler_epochs, num_mini_batches=self.sampler_mini_batches),
            hooks=self._hooks(),
            name=self.name,
        )

    def __call__(self, environment_spec: EnvironmentSpec, *, device=None, seed: int = 0):
        return self.to_underlying()(environment_spec, device=device, seed=seed)


@dataclasses.dataclass(kw_only=True)
class RecurrentPpoAgentFactory(PpoAgentFactory):
    """PPO with recurrent (GRU/LSTM) backbones, ``Sequential(Rnn, Mlp)`` or
    the bare RNN without ``mlp_hidden_dims``; temporal sampling engages
    through the memory entries of the rollout."""

    _recurrent_backbones = True

    rnn_type: str = "gru"
    rnn_hidden_size: int = 256
    rnn_num_layers: int = 1
    mlp_hidden_dims: Sequence[int] = (256,)

    def _backbone_factory(self, hidden_dims):
        from cusrl_tpu_torch.nn.module.rnn import RnnFactory
        from cusrl_tpu_torch.nn.module.sequential import SequentialFactory

        rnn = RnnFactory(cell=self.rnn_type, hidden_size=self.rnn_hidden_size, num_layers=self.rnn_num_layers)
        if not self.mlp_hidden_dims:
            return rnn
        return SequentialFactory(factories=(
            rnn,
            MlpFactory(hidden_dims=tuple(self.mlp_hidden_dims), activation=self.activation_fn,
                       ends_with_activation=True),
        ))


@dataclasses.dataclass(kw_only=True)
class TransformerPpoAgentFactory(PpoAgentFactory):
    """PPO with causal windowed-attention backbones: one or more
    ``CausalTransformerEncoderLayer``s (ring KV cache, done-driven segment
    resets, the lane kernels in sequence mode) followed by an optional MLP
    head stack.  Temporal sampling engages through the memory entries of the
    rollout."""

    _recurrent_backbones = True

    embed_dim: int = 128
    num_heads: int = 4
    attention_window: int = 16
    num_attention_layers: int = 1
    use_alibi: bool = False
    use_rope: bool = True
    attention_norm_mode: str = "pre"
    attention_gate: str | None = "residual"
    mlp_hidden_dims: Sequence[int] = (256,)

    def _backbone_factory(self, hidden_dims):
        from cusrl_tpu_torch.nn.module.causal_attn import CausalTransformerEncoderLayerFactory
        from cusrl_tpu_torch.nn.module.sequential import SequentialFactory

        factories = tuple(
            CausalTransformerEncoderLayerFactory(
                embed_dim=self.embed_dim,
                num_heads=self.num_heads,
                window=self.attention_window,
                use_alibi=self.use_alibi,
                use_rope=self.use_rope,
                norm_mode=self.attention_norm_mode,
                gate=self.attention_gate,
            )
            for _ in range(self.num_attention_layers)
        )
        if self.mlp_hidden_dims:
            factories = factories + (
                MlpFactory(hidden_dims=tuple(self.mlp_hidden_dims), activation=self.activation_fn,
                           ends_with_activation=True),
            )
        return factories[0] if len(factories) == 1 else SequentialFactory(factories=factories)

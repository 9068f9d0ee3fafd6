"""The whole PPO + value objective in one fused step (counterpart of
``cusrl_tpu/hook/on_policy/fused_update.py``).

``FusedPpoUpdate`` replaces the JointPolicyValueEvaluation -> ValueLoss ->
OnPolicyPreparation -> PpoSurrogateLoss -> EntropyLoss span of the PPO suite
with one objective.  Where the backbones' kernels apply (``Mlp._can_fuse``:
CUDA tensors, bf16 layers, enough rows) it calls ``fused_ppo_step`` (K2f,
then K9s, or K9m); elsewhere ``ppo_step_reference``, the same math through
autograd.  The head kernels take at most ``MAX_HEAD_DIM`` outputs per head;
with a wider action or value head (decided from the shapes at ``init``) the
two chains still run in their kernels (``fused_mlp_pair``, K2f/K2b under
autograd) and the fp32 heads and the loss run outside them
(``ppo_loss_reference``), as ``JointPolicyValueEvaluation`` evaluates heads
it does not fuse.
The entropy of the state-independent-std Gaussian depends only on ``std`` and
is computed outside the kernel; its gradient and the kernel's ``std``
gradient reach ``std_param`` through the bijector.  Objectives:
``fused_surrogate_value_loss`` and ``entropy_loss``; metrics:
``surrogate_loss``, ``value_loss``, ``ratio``, ``entropy`` and ``value``.
"""

from __future__ import annotations

import math

import torch

from cusrl_tpu_torch.hook.on_policy.joint_eval import _fusable
from cusrl_tpu_torch.nn.kernels.fused_mlp import MAX_HEAD_DIM, fused_mlp_pair
from cusrl_tpu_torch.nn.kernels.fused_ppo_step import fused_ppo_step, ppo_loss_reference, ppo_step_reference
from cusrl_tpu_torch.nn.module.distribution import NormalDist
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["FusedPpoUpdate"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class FusedPpoUpdate(Hook):
    training_only = True
    batch_keys = ("observation", "state", "action", "action_logp", "advantage", "return", "value")

    def __init__(self, clip_ratio: float = 0.2, weight: float = 1.0, value_loss_weight: float = 0.5,
                 entropy_loss_weight: float = 0.01, value_loss_clip: float | None = None, **kwargs):
        super().__init__(**kwargs)
        if clip_ratio <= 0:
            raise ValueError("'clip_ratio' must be positive")
        if weight < 0:
            raise ValueError("'weight' must be non-negative")
        if value_loss_weight <= 0:
            raise ValueError("'value_loss_weight' must be positive")
        if entropy_loss_weight < 0:
            raise ValueError("'entropy_loss_weight' must be non-negative")
        if value_loss_clip is not None and value_loss_clip <= 0:
            raise ValueError("'value_loss_clip' must be positive or None")
        self.clip_ratio = clip_ratio
        self.weight = weight
        self.value_loss_weight = value_loss_weight
        self.entropy_loss_weight = entropy_loss_weight
        self.value_loss_clip = value_loss_clip
        self.fuse_heads = True

    def init(self, agent) -> None:
        reason = _fusable(agent.actor.backbone, agent.critic.backbone)
        if reason is not None:
            raise ValueError(f"FusedPpoUpdate requires fusable backbones: {reason}. Disable fused_ppo_update "
                             "for this architecture.")
        dist = agent.actor.distribution
        if type(dist) is not NormalDist:
            raise ValueError("FusedPpoUpdate requires a NormalDist actor (state-independent std); "
                             f"got {type(dist).__name__}. Disable fused_ppo_update.")
        if dist.mean_head.bias is None or agent.critic.head.bias is None:
            raise ValueError("FusedPpoUpdate requires biased mean/value heads")
        if getattr(agent.critic, "action_aware", False):
            raise ValueError("FusedPpoUpdate does not support action-aware critics")
        # Wider heads than the head kernels take run outside them (objective).
        self.fuse_heads = max(dist.mean_head.output_dim, agent.critic.head.output_dim) <= MAX_HEAD_DIM

    def objective(self, agent, metadata, batch):
        actor, critic = agent.actor, agent.critic
        backbone, dist = actor.backbone, actor.distribution
        observation = batch["observation"]
        xa = observation.reshape(-1, observation.shape[-1])
        critic_input = get_first(batch, "state", "observation")
        xc = critic_input.reshape(-1, critic_input.shape[-1]).to(xa.dtype)
        n = xa.shape[0]
        advantage = batch["advantage"].reshape(n, -1)
        if advantage.shape[-1] != 1:
            raise ValueError(f"Expected advantage with shape [..., 1]; got {tuple(batch['advantage'].shape)}")
        old_value = batch["value"].reshape(n, -1) if self.value_loss_clip is not None else None
        std = dist.bijector(dist.std_param.float()).reshape(-1)
        args = (
            xa, xc,
            [l.weight for l in backbone.layers], [l.bias for l in backbone.layers],
            [l.weight for l in critic.backbone.layers], [l.bias for l in critic.backbone.layers],
            dist.mean_head.weight, dist.mean_head.bias, critic.head.weight, critic.head.bias, std,
            batch["action"].reshape(n, -1), batch["action_logp"].reshape(n, -1), advantage, old_value,
            batch["return"].reshape(n, -1), self.clip_ratio, self.weight, self.value_loss_weight,
            backbone.activation, backbone.ends_with_activation,
        )
        fused = backbone._can_fuse(xa)
        if fused and self.fuse_heads:
            loss_core, (surrogate_loss, value_loss, ratio, value) = fused_ppo_step(
                *args, loss_clip=self.value_loss_clip
            )
        else:
            if fused:  # wide heads: the chains in their kernels, the heads and loss outside
                latents = fused_mlp_pair(*args[:6], backbone.activation, backbone.ends_with_activation,
                                         skip_input_grad=True)
                loss_core, m = ppo_loss_reference(*latents, *args[6:19], loss_clip=self.value_loss_clip)
            else:
                loss_core, m = ppo_step_reference(*args, loss_clip=self.value_loss_clip)
            surrogate_loss, value_loss, ratio, value = m["surrogate_loss"], m["value_loss"], m["ratio"], m["value"]
        entropy = torch.sum(torch.log(std) + 0.5 + _LOG_SQRT_2PI)
        objectives = {
            "fused_surrogate_value_loss": loss_core,
            "entropy_loss": -entropy * self.entropy_loss_weight,
        }
        metrics = {
            "surrogate_loss": surrogate_loss,
            "value_loss": value_loss,
            "ratio": ratio,
            "entropy": entropy.detach(),
            "value": value,
        }
        return objectives, metrics

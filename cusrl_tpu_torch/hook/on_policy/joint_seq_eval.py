"""Joint actor+critic sequence evaluation for recurrent backbones
(counterpart of ``cusrl_tpu/hook/on_policy/joint_seq_eval.py``).

The PPO presets build the actor and the critic with identical backbone
architectures.  On a temporal minibatch this hook evaluates both and writes
``curr_action_dist``, ``actor_intermediate`` and ``curr_value``, which
``OnPolicyPreparation`` and ``ValueLoss`` then take instead of running their
own passes.

Backbones of the pair shape (a ``CausalTransformerEncoderLayer``, optionally
followed by one ``Mlp`` tail) whose layers are both fused-eligible take the
pair route: ``fused_pair_sequence`` (the K5 pre and post ops around one lane
attention call per layer), then the two tails as one ``fused_mlp_pair`` (K2
with input gradients, which flow back through the block) when both fuse.
Recurrent cells of one class (a ``Gru``, ``Lstm`` or ``VanillaRnn``,
optionally followed by one ``Mlp`` tail) run as the JAX package's vmapped
stack does: each step's products as one batched product over the two
networks' stacked weights (``rnn.stacked_sequence``), then the tails as one
``fused_mlp_pair`` with input gradients (K2, flowing back into the cells)
when both fuse.  Other backbones run one after the other: the vmapped leaf
stack computes the same numbers.
"""

from __future__ import annotations

import torch
from torch import nn

from cusrl_tpu_torch.nn.kernels.fused_mlp import fused_mlp_pair
from cusrl_tpu_torch.nn.module.causal_attn import CausalTransformerEncoderLayer, fused_pair_sequence
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.nn.module.rnn import _RnnBase, stacked_sequence
from cusrl_tpu_torch.nn.module.sequential import Sequential
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first, map_nested

__all__ = ["JointSequentialEvaluation"]


def _config(module: nn.Module) -> dict:
    """A module's static configuration: its attributes that are neither
    tensors nor modules (the JAX tree definition's static fields)."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, (torch.Tensor, nn.Module))}


def _stackable(actor_backbone, critic_backbone) -> str | None:
    """None when the two backbones have one structure, else why not."""
    if not (actor_backbone.is_recurrent and critic_backbone.is_recurrent):
        return "both backbones must be recurrent (use JointPolicyValueEvaluation for MLPs)"
    a_mods, c_mods = list(actor_backbone.named_modules()), list(critic_backbone.named_modules())
    if [(n, type(m), _config(m)) for n, m in a_mods] != [(n, type(m), _config(m)) for n, m in c_mods]:
        return "backbone structures/static configs differ"
    a_params, c_params = list(actor_backbone.named_parameters()), list(critic_backbone.named_parameters())
    if [(n, p.shape, p.dtype) for n, p in a_params] != [(n, p.shape, p.dtype) for n, p in c_params]:
        return "backbone leaf shapes/dtypes differ"
    return None


def _pair_parts(backbone, head_types=(CausalTransformerEncoderLayer,)):
    """``(head module, Mlp tail or None, memory key or None)`` for a backbone
    that is a ``head_types`` module, optionally followed by one ``Mlp``,
    else ``(None, None, None)``."""
    if isinstance(backbone, head_types):
        return backbone, None, None
    if (isinstance(backbone, Sequential) and len(backbone.members) == 2
            and isinstance(backbone.members[0], head_types) and isinstance(backbone.members[1], Mlp)):
        return backbone.members[0], backbone.members[1], "0"
    return None, None, None


class JointSequentialEvaluation(Hook):
    """Precomputes ``curr_action_dist`` and ``curr_value`` for recurrent
    (transformer, GRU, LSTM) agents; must precede ValueLoss and OnPolicyPreparation (the PPO presets
    place it so)."""

    training_only = True
    batch_keys = ("observation", "state", "actor_memory", "critic_memory", "done")

    def init(self, agent) -> None:
        reason = _stackable(agent.actor.backbone, agent.critic.backbone)
        if reason is not None:
            raise ValueError(
                f"JointSequentialEvaluation requires stackable backbones: {reason}. "
                "Disable fuse_actor_critic_evaluation for this architecture."
            )
        if getattr(agent.critic, "action_aware", False):
            raise ValueError("JointSequentialEvaluation does not support action-aware critics")

    def objective(self, agent, metadata, batch):
        if not metadata.get("temporal", False):
            return None, {}  # non-temporal batches keep the per-module passes
        actor, critic = agent.actor, agent.critic
        observation = batch["observation"]
        critic_input = get_first(batch, "state", "observation").to(observation.dtype)
        actor_memory = map_nested(lambda m: m[0], batch["actor_memory"])
        critic_memory = map_nested(lambda m: m[0], batch["critic_memory"])
        done = batch.get("done")

        layer_a, tail_a, key_a = _pair_parts(actor.backbone)
        layer_c, tail_c, key_c = _pair_parts(critic.backbone)
        rnn_a, rtail_a, rkey_a = _pair_parts(actor.backbone, (_RnnBase,))
        rnn_c, rtail_c, rkey_c = _pair_parts(critic.backbone, (_RnnBase,))
        if (layer_a is not None and layer_c is not None and (tail_a is None) == (tail_c is None)
                and layer_a._fused_eligible(observation, True) and layer_c._fused_eligible(critic_input, True)):
            latent_a, latent_c = self._pair_eval(layer_a, layer_c, tail_a, tail_c, key_a, key_c, observation,
                                                 critic_input, actor_memory, critic_memory, done)
        elif rnn_a is not None and rnn_c is not None:  # one structure (init checked it)
            mem_a = actor_memory if rkey_a is None else actor_memory[rkey_a]
            mem_c = critic_memory if rkey_c is None else critic_memory[rkey_c]
            la, lc, _, _ = stacked_sequence(rnn_a, rnn_c, observation, critic_input, mem_a, mem_c, done)
            latent_a, latent_c = self._tails(la, lc, rtail_a, rtail_c)
        else:
            latent_a = actor.backbone(observation, actor_memory, sequential=True, done=done)[0]
            latent_c = critic.backbone(critic_input, critic_memory, sequential=True, done=done)[0]

        batch["curr_action_dist"] = actor.distribution(latent_a)
        batch["actor_intermediate"] = {"backbone.output": latent_a}
        batch["curr_value"] = critic.head(latent_c.float())
        return None, {}

    @staticmethod
    def _pair_eval(layer_a, layer_c, tail_a, tail_c, key_a, key_c, observation, critic_input, actor_memory,
                   critic_memory, done):
        mem_a = actor_memory if key_a is None else actor_memory[key_a]
        mem_c = critic_memory if key_c is None else critic_memory[key_c]
        if done is None:
            done = torch.zeros(*observation.shape[:2], 1, dtype=torch.bool, device=observation.device)
        la, lc, _, _ = fused_pair_sequence(layer_a, layer_c, observation, critic_input, mem_a, mem_c, done)
        return JointSequentialEvaluation._tails(la, lc, tail_a, tail_c)

    @staticmethod
    def _tails(la, lc, tail_a, tail_c):
        """The two Mlp tails (if any) on ``[T, B, E]`` latents: as one pair
        launch when both fuse (input gradients flow back into the modules
        below), else each on its own."""
        if tail_a is None:
            return la, lc
        rows = la.shape[0] * la.shape[1]
        la_flat, lc_flat = la.reshape(rows, -1), lc.reshape(rows, -1)
        if (tail_a._can_fuse(la_flat) and tail_c._can_fuse(lc_flat)
                and tail_a.activation == tail_c.activation
                and tail_a.ends_with_activation == tail_c.ends_with_activation
                and [l.weight.shape for l in tail_a.layers] == [l.weight.shape for l in tail_c.layers]):
            ta, tc = fused_mlp_pair(
                la_flat, lc_flat,
                [l.weight for l in tail_a.layers], [l.bias for l in tail_a.layers],
                [l.weight for l in tail_c.layers], [l.bias for l in tail_c.layers],
                tail_a.activation, tail_a.ends_with_activation, skip_input_grad=False,
            )
            return ta.reshape(*la.shape[:2], -1), tc.reshape(*lc.shape[:2], -1)
        return tail_a(la, sequential=True)[0], tail_c(lc, sequential=True)[0]

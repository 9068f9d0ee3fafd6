"""Fused actor+critic batch evaluation (counterpart of
``cusrl_tpu/hook/on_policy/joint_eval.py``).

Evaluates both same-shape MLP backbones of a minibatch at once and writes
``curr_action_dist`` / ``curr_value``, which ``OnPolicyPreparation`` and
``ValueLoss`` then reuse.  On CUDA the two chains run in one launch of the
pair kernel (``fused_mlp_pair``, forward with saved activations and a backward
that skips layer 0's input gradient, since observations are data).
With ``fuse_heads=True`` the fp32 distribution-mean and value heads join the
same launch (``fused_mlp_pair_heads``, K8f/K8b): only ``[rows, A]`` means and
``[rows, Dv]`` values leave the kernel.
Elsewhere the stacked plain branch runs: per layer, the two weight matrices
are stacked to ``[2, out, in]`` and applied to the stacked ``[2, B, in]``
activations with the Linear layer's numerics, through
``parallel.tensor.parallel_chain``: on a tensor-parallel agent the two
backbones hold the same shards (one spec, one shape), and each collective
carries both chains; on whole weights it moves nothing.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.nn.kernels.fused_mlp import MAX_HEAD_DIM, fused_mlp_pair, fused_mlp_pair_heads
from cusrl_tpu_torch.nn.module.distribution import NormalDist
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.parallel.tensor import parallel_chain, shard_of
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["JointPolicyValueEvaluation"]


def _stacked_product(x, layer_a, layer_c):
    """x ``[2, ..., in]`` through the two layers' weights stacked to ``[2,
    out, in]``: the fp32 products without the biases (``Linear.product``'s
    numerics; a row-parallel pair's partial sums).  The lead dimensions (a
    temporal batch's, the symmetric augmentation's) flatten into one."""
    lead = x.shape[1:-1]
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    weight = torch.stack([layer_a.weight, layer_c.weight])
    if layer_a.compute_dtype is not None:
        dtype = getattr(torch, layer_a.compute_dtype)
        y = torch.bmm(x.to(dtype).float(), weight.to(dtype).float().transpose(1, 2))
    else:
        y = torch.bmm(x.float(), weight.transpose(1, 2))
    return y.reshape(y.shape[0], *lead, y.shape[-1])


def _stacked_finish(y, layer_a, layer_c, act):
    """``_stacked_product``'s sums with the biases, in the compute dtype
    (``Linear.finish``), activated unless ``act`` is None."""
    if layer_a.bias is not None:
        y = y + torch.stack([layer_a.bias, layer_c.bias]).reshape(2, *([1] * (y.dim() - 2)), -1)
    if layer_a.compute_dtype is not None:
        y = y.to(getattr(torch, layer_a.compute_dtype))
    return y if act is None else act(y)


def _fusable(actor_backbone, critic_backbone) -> str | None:
    """None when the two backbones can be evaluated together, else the reason."""
    if not isinstance(actor_backbone, Mlp) or not isinstance(critic_backbone, Mlp):
        return "both backbones must be feedforward Mlp modules"
    if actor_backbone.activation != critic_backbone.activation:
        return "backbone activations differ"
    if actor_backbone.ends_with_activation != critic_backbone.ends_with_activation:
        return "ends_with_activation differs"
    if len(actor_backbone.layers) != len(critic_backbone.layers):
        return "backbone depths differ"
    for la, lc in zip(actor_backbone.layers, critic_backbone.layers):
        if la.weight.shape != lc.weight.shape:
            return f"layer shapes differ ({tuple(la.weight.shape)} vs {tuple(lc.weight.shape)})"
        if (la.bias is None) != (lc.bias is None):
            return "bias configuration differs"
        if la.compute_dtype != lc.compute_dtype:
            return "compute dtypes differ"
    return None


class JointPolicyValueEvaluation(Hook):
    training_only = True
    batch_keys = ("observation", "state")

    def __init__(self, fuse_heads: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.fuse_heads = fuse_heads
        self.expose_latent = False

    def init(self, agent) -> None:
        reason = _fusable(agent.actor.backbone, agent.critic.backbone)
        if reason is not None:
            raise ValueError(
                f"JointPolicyValueEvaluation requires fusable backbones: {reason}. "
                "Disable fuse_actor_critic_evaluation for this architecture."
            )
        if self.fuse_heads:
            # The head kernel takes a NormalDist with biased fp32 heads of at
            # most MAX_HEAD_DIM outputs; anything else evaluates the heads
            # outside the kernel.
            dist, head = agent.actor.distribution, agent.critic.head
            self.fuse_heads = (
                type(dist) is NormalDist
                and dist.mean_head.bias is not None
                and head.bias is not None
                and max(dist.mean_head.output_dim, head.output_dim) <= MAX_HEAD_DIM
            )

    def post_init(self, agent) -> None:
        # Representation hooks probe the actor latent: keep exposing it (its
        # cotangent flows back through the kernel).
        if self.fuse_heads:
            self.expose_latent = any(h.active and getattr(h, "latent_name", None) is not None for h in agent.hooks)

    def objective(self, agent, metadata, batch):
        actor, critic = agent.actor, agent.critic
        observation = batch["observation"]
        critic_input = get_first(batch, "state", "observation").to(observation.dtype)
        ab, cb = actor.backbone, critic.backbone
        if ab._can_fuse(observation):
            lead = observation.shape[:-1]
            backbone_args = (
                observation.reshape(-1, observation.shape[-1]),
                critic_input.reshape(-1, critic_input.shape[-1]),
                [l.weight for l in ab.layers],
                [l.bias for l in ab.layers],
                [l.weight for l in cb.layers],
                [l.bias for l in cb.layers],
            )
            if self.fuse_heads:
                # Both chains and the fp32 heads in one launch (K8f/K8b).
                dist = actor.distribution
                outs = fused_mlp_pair_heads(
                    *backbone_args, dist.mean_head.weight, dist.mean_head.bias, critic.head.weight, critic.head.bias,
                    ab.activation, ab.ends_with_activation, skip_input_grad=True, expose_latent=self.expose_latent,
                )
                mean = outs[0].reshape(*lead, outs[0].shape[-1])
                # NormalDist.forward's std, outside the kernel: its gradient
                # reaches std_param through the bijector.
                std = dist.bijector(dist.std_param.float())
                batch["curr_action_dist"] = {"mean": mean, "std": std.expand_as(mean)}
                batch["curr_value"] = outs[1].reshape(*lead, outs[1].shape[-1])
                if self.expose_latent:
                    batch["actor_intermediate"] = {"backbone.output": outs[2].reshape(*lead, outs[2].shape[-1])}
                return None, {}
            actor_latent, critic_latent = fused_mlp_pair(
                *backbone_args, ab.activation, ab.ends_with_activation, skip_input_grad=True,
            )
            actor_latent = actor_latent.reshape(*lead, actor_latent.shape[-1])
            critic_latent = critic_latent.reshape(*lead, critic_latent.shape[-1])
        else:
            x = torch.stack([observation, critic_input])
            act = ab.activation_fn
            num_layers = len(ab.layers)
            x = parallel_chain(x, [shard_of(la.weight) for la in ab.layers],
                               lambda h, index: _stacked_product(h, ab.layers[index], cb.layers[index]),
                               lambda y, index: _stacked_finish(y, ab.layers[index], cb.layers[index],
                                                                act if index < num_layers - 1
                                                                or ab.ends_with_activation else None))
            actor_latent, critic_latent = x[0], x[1]
        batch["curr_action_dist"] = actor.distribution(actor_latent)
        batch["actor_intermediate"] = {"backbone.output": actor_latent}
        batch["curr_value"] = critic.head(critic_latent.float())
        return None, {}

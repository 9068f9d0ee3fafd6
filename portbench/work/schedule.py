"""One training iteration's kernel calls and model FLOP, from the
configuration's widths and the traffic's sizes.

``kernel_calls`` lists every call the iteration's schedule makes of the
hand-written kernel families: the rollout's steps, the value
and next-value passes, each minibatch's forward and backward, and the KL
pass after the update.  It is counted from the configuration, not from
which kernel ran, so that a later change that takes work off a kernel
shows as a lower share.  ``LAUNCH_KEYS`` names the launch counter
(``LAUNCHES`` in ``cusrl_tpu_torch/nn/kernels/*.py``) each call family
should move, which the readers check against the traced window.
``model_flops`` counts every network's matrix products of the iteration,
forward and backward (the input layer's input gradient excluded: the
observations are data), attention's products included, recomputation
excluded.
"""

from __future__ import annotations

import dataclasses

from portbench.work.arithmetic import (
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    band_pairs,
    block_work,
    chain_work,
    lane_work,
)

__all__ = ["Call", "Sizes", "kernel_calls", "model_flops", "sizes_of"]


@dataclasses.dataclass(frozen=True)
class Call:
    family: str      # "mlp_chain", "fused_block" or "lane_attention"
    key: str         # the launch counter's key (K1f, K2b, K4pre_f, K3f, ...)
    count: int       # calls per iteration
    flops: float     # per call
    nbytes: float    # per call
    peak_flops: float = PEAK_BF16_FLOPS


@dataclasses.dataclass(frozen=True)
class Sizes:
    kind: str                 # "mlp" or "transformer"
    envs: int                 # environments on the card
    steps: int                # rollout steps per iteration
    epochs: int
    mini_batches: int
    obs_dim: int
    action_dim: int
    hidden: tuple = ()        # mlp: the backbones' hidden widths
    embed: int = 0            # transformer
    heads: int = 0
    window: int = 0
    ff: int = 0
    head_hidden: tuple = ()   # transformer: the MLP head after the encoder layer

    @property
    def rows(self) -> int:
        return self.envs * self.steps

    @property
    def mb_rows(self) -> int:
        """The rows of one minibatch."""
        return self.rows // self.mini_batches

    @property
    def minibatches(self) -> int:
        return self.epochs * self.mini_batches


def sizes_of(config: dict, traffic: dict) -> Sizes:
    """``Sizes`` from a configuration file and a traffic file."""
    agent = config["agent"]
    common = dict(envs=traffic["environments_per_chip"], steps=agent["num_steps_per_update"],
                  epochs=agent["sampler_epochs"], mini_batches=agent["sampler_mini_batches"],
                  obs_dim=config["observation_dim"], action_dim=config["action_dim"])
    if config["kind"] == "mlp":
        return Sizes("mlp", hidden=tuple(agent["actor_hidden_dims"]), **common)
    return Sizes("transformer", embed=agent["embed_dim"], heads=agent["num_heads"], window=agent["attention_window"],
                 ff=config["feedforward_dim"], head_hidden=tuple(agent["mlp_hidden_dims"]), **common)


def _macs(dims) -> int:
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def kernel_calls(s: Sizes) -> list[Call]:
    if s.kind == "mlp":
        dims = (s.obs_dim, *s.hidden)
        mb = s.minibatches
        return [
            # The rollout's actor steps, the value and next-value passes, the KL pass.
            Call("mlp_chain", "K1f", s.steps, *chain_work(s.envs, 1, False, False, False, dims)),
            Call("mlp_chain", "K1f", 3, *chain_work(s.rows, 1, False, False, False, dims)),
            # Each minibatch's actor and critic together, saving; their backward.
            Call("mlp_chain", "K2f", mb, *chain_work(s.mb_rows, 2, False, True, False, dims)),
            Call("mlp_chain", "K2b", mb, *chain_work(s.mb_rows, 2, True, False, False, dims)),
        ]
    e, f, n = s.embed, s.ff, s.envs
    ffn, head = (e, f, e), (e, *s.head_hidden)
    mb, mb_envs = s.minibatches, s.envs // s.mini_batches
    seq_pairs = band_pairs(s.steps, s.window)
    return [
        # The rollout's step route: the actor's feed-forward and its head, one token an environment.
        Call("mlp_chain", "K1f", s.steps, *chain_work(n, 1, False, False, False, ffn, x_bytes=2)),
        Call("mlp_chain", "K1f", s.steps, *chain_work(n, 1, False, False, False, head, x_bytes=2)),
        # The head in the value pass, the next-value pass and the KL pass.
        Call("mlp_chain", "K1f", 3, *chain_work(s.rows, 1, False, False, False, head, x_bytes=2)),
        # Each minibatch's actor and critic head, saving, and its backward into the encoder.
        Call("mlp_chain", "K1f", 2 * mb, *chain_work(s.mb_rows, 1, False, True, False, head, x_bytes=2)),
        Call("mlp_chain", "K1b", 2 * mb, *chain_work(s.mb_rows, 1, True, False, True, head, x_bytes=2)),
        # The encoder block: the value, next-value and KL passes, each minibatch's two networks.
        Call("fused_block", "K4pre_f", 3, *block_work("pre_f", s.rows, 1, e, f, s.obs_dim)),
        Call("fused_block", "K4post_f", 3, *block_work("post_f", s.rows, 1, e, f, s.obs_dim, save=False)),
        Call("fused_block", "K4pre_f", 2 * mb, *block_work("pre_f", s.mb_rows, 1, e, f, s.obs_dim)),
        Call("fused_block", "K4post_f", 2 * mb, *block_work("post_f", s.mb_rows, 1, e, f, s.obs_dim)),
        Call("fused_block", "K4pre_b", 2 * mb, *block_work("pre_b", s.mb_rows, 1, e, f, s.obs_dim)),
        Call("fused_block", "K4post_b", 2 * mb, *block_work("post_b", s.mb_rows, 1, e, f, s.obs_dim)),
        # The windowed attention: the value and KL passes, each minibatch's two
        # networks forward (saving) and backward, the next-value pass.
        Call("lane_attention", "K3f", 2,
             *lane_work("K3f", n, s.heads, s.steps, s.window, e // s.heads, n * seq_pairs), PEAK_FP32_FLOPS),
        Call("lane_attention", "K3f", 2 * mb,
             *lane_work("K3f", mb_envs, s.heads, s.steps, s.window, e // s.heads, mb_envs * seq_pairs, save=True),
             PEAK_FP32_FLOPS),
        Call("lane_attention", "K3b", 2 * mb,
             *lane_work("K3b", mb_envs, s.heads, s.steps, s.window, e // s.heads, mb_envs * seq_pairs, out_bytes=2),
             PEAK_FP32_FLOPS),
        Call("lane_attention", "K6", 1,
             *lane_work("K6", n, s.heads, s.steps, s.window, e // s.heads, n * band_pairs(s.steps, s.window, 1)),
             PEAK_FP32_FLOPS),
    ]


def model_flops(s: Sizes) -> float:
    """The iteration's model FLOP (see the module's docstring)."""
    if s.kind == "mlp":
        body = _macs((s.obs_dim, *s.hidden))
        actor, critic = body + s.hidden[-1] * s.action_dim, body + s.hidden[-1]
        # Backward: dW of every layer, dX of every layer but the first.
        first = s.obs_dim * s.hidden[0]
        forward = s.rows * actor + 2 * s.rows * critic + s.rows * actor  # rollout, value passes, KL pass
        update = s.minibatches * s.mb_rows * (3 * (actor + critic) - 2 * first)
        return 2.0 * (forward + update)
    e, f = s.embed, s.ff
    attn = 2 * (s.window + 1) * e  # QK and PV over the band, every head: per token
    layer = s.obs_dim * e + 3 * e * e + attn + e * e + 2 * e * f
    head = _macs((e, *s.head_hidden))
    actor, critic = layer + head + s.head_hidden[-1] * s.action_dim, layer + head + s.head_hidden[-1]
    first = s.obs_dim * e
    forward = s.rows * actor + 2 * s.rows * critic + s.rows * actor  # rollout, value and next-value passes, KL pass
    update = s.minibatches * s.mb_rows * (3 * (actor + critic) - 2 * first)
    return 2.0 * (forward + update)

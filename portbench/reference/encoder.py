"""The plain windowed causal transformer actor-critic.

Each network: an input projection to ``embed``, one pre-norm encoder layer
(LayerNorm, fp32 internals, population variance, eps 1e-6; multi-head
self-attention over a window of ``window`` earlier steps and the step
itself, inside the step's episode, RoPE with the half-split pairing and
wavelength 1e4 on q and k at their positions; a residual; LayerNorm, the
feed-forward ``down(gelu_tanh(up(x)))``, a residual), then the ELU head
layers, then the fp32 Gaussian mean head (``mlp.bounded_std``) or the
fp32 value head.  Sequences are ``[T, B, D]`` with episode ends ``done``
``[T, B, 1]``; a query sees the keys of its own segment (the episode ends
strictly before it split them), and the first rollout starts with an empty
cache.  The values' next-observation pass appends each step's next
observation as one more token after the step (its own key and value, and
the ``window`` keys before it), over the rollout's keys with the last
step's episode end left out.  Parameters are a dict of fp32 tensors under
the checkpoint's dotted paths.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.mlp import bounded_std
from portbench.reference.precision import linear

__all__ = ["TransformerActorCritic"]


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _rope(x, positions, wavelength: float = 10000.0):
    """x ``[..., L, D]`` rotated at ``positions`` ``[L]``."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(wavelength) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _segments(done):
    """``[B, T]``: the episode ends strictly before each step."""
    done = done[..., 0].to(torch.int32)  # [T, B]
    shifted = torch.cat([torch.zeros_like(done[:1]), done[:-1]], 0)
    return torch.cumsum(shifted, 0).transpose(0, 1)


class TransformerActorCritic:
    temporal = True

    def __init__(self, config: dict, backbone_precision: str = "fp32", head_precision: str = "fp32"):
        agent = config["agent"]
        self.embed, self.heads, self.window = agent["embed_dim"], agent["num_heads"], agent["attention_window"]
        self.head_layers = len(agent["mlp_hidden_dims"])
        self.std_bounds = tuple(config["std_bounds"])
        self.backbone_precision = backbone_precision
        self.head_precision = head_precision

    def _lin(self, params, name, x, precision=None):
        return linear(x, params[f"{name}.weight"], params[f"{name}.bias"], precision or self.backbone_precision)

    def _heads(self, x):
        """``[T, B, E] -> [B, H, T, D]``."""
        t, b, _ = x.shape
        return x.reshape(t, b, self.heads, -1).permute(1, 2, 0, 3)

    def _project(self, params, p, x):
        """The input projection and the attention's pre-norm q, k, v."""
        h = self._lin(params, f"{p}.input_proj", x)
        a = _layer_norm(h, params[f"{p}.norm1.scale"], params[f"{p}.norm1.bias"])
        q, k, v = (self._heads(self._lin(params, f"{p}.attention.mha.{n}_proj", a)) for n in "qkv")
        return h, q, k, v

    def _finish(self, params, p, h, attn):
        """``attn`` ``[B, H, T, D]``: the output projection, the residuals and the feed-forward."""
        t = attn.shape[2]
        merged = attn.permute(2, 0, 1, 3).reshape(t, attn.shape[0], self.embed)
        h1 = h + self._lin(params, f"{p}.attention.mha.out_proj", merged)
        a = _layer_norm(h1, params[f"{p}.norm2.scale"], params[f"{p}.norm2.bias"])
        up = F.gelu(self._lin(params, f"{p}.feed_forward.up", a), approximate="tanh")
        return h1 + self._lin(params, f"{p}.feed_forward.down", up)

    def _sequence(self, params, prefix, x, done):
        """The encoder layer over ``x`` ``[T, B, D]``; returns ``(out, keys)``
        with the rotated keys, the values and the segments for a
        next-token pass."""
        p = f"{prefix}.backbone.modules.0"
        steps = x.shape[0]
        h, q, k, v = self._project(params, p, x)
        positions = self.window + torch.arange(steps, device=x.device)
        q, k = _rope(q, positions), _rope(k, positions)
        seg = _segments(done)
        t = torch.arange(steps, device=x.device)
        band = (t[None, :] <= t[:, None]) & (t[None, :] >= t[:, None] - self.window)
        mask = band[None] & (seg[:, :, None] == seg[:, None, :])  # [B, T, T]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
        scores = torch.where(mask[:, None], scores, -torch.inf)
        attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)
        return self._finish(params, p, h, attn), (k, v, seg)

    def _tail(self, params, prefix, z):
        for i in range(self.head_layers):
            z = F.elu(self._lin(params, f"{prefix}.backbone.modules.1.layers.{i}", z))
        return z

    def actor(self, params: dict, obs: torch.Tensor, done: torch.Tensor) -> dict:
        z = self._tail(params, "actor", self._sequence(params, "actor", obs, done)[0])
        mean = self._lin(params, "actor.distribution.mean_head", z, self.head_precision)
        std = bounded_std(params["actor.distribution.std_param"], self.std_bounds).expand_as(mean)
        return {"mean": mean, "std": std}

    def critic(self, params: dict, obs: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
        z = self._tail(params, "critic", self._sequence(params, "critic", obs, done)[0])
        return self._lin(params, "critic.head", z, self.head_precision)

    def critic_values(self, params: dict, obs: torch.Tensor, next_obs: torch.Tensor, done: torch.Tensor):
        """The rollout's values (the last step's episode end left out) and
        each step's next observation's value as the token after it."""
        done_seq = torch.cat([done[:-1], torch.zeros_like(done[-1:])], 0)
        out, (keys, values, seg) = self._sequence(params, "critic", obs, done_seq)
        value = self._lin(params, "critic.head", self._tail(params, "critic", out), self.head_precision)
        p = "critic.backbone.modules.0"
        steps = obs.shape[0]
        h, q, k_self, v_self = self._project(params, p, next_obs)
        positions = self.window + 1 + torch.arange(steps, device=obs.device)
        q, k_self = _rope(q, positions), _rope(k_self, positions)
        t = torch.arange(steps, device=obs.device)
        band = (t[None, :] <= t[:, None]) & (t[None, :] >= t[:, None] + 1 - self.window)
        mask = band[None] & (seg[:, :, None] == seg[:, None, :])  # [B, T(query), T(key)]
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bhqd,bhkd->bhqk", q, keys) * scale
        scores = torch.where(mask[:, None], scores, -torch.inf)
        own = (q * k_self).sum(-1, keepdim=True) * scale
        weights = torch.softmax(torch.cat([own, scores], -1), -1)
        attn = weights[..., :1] * v_self + torch.einsum("bhqk,bhkd->bhqd", weights[..., 1:], values)
        z = self._tail(params, "critic", self._finish(params, p, h, attn))
        return value, self._lin(params, "critic.head", z, self.head_precision)

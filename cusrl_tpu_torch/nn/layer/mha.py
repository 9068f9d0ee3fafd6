"""Multi-head attention and transformer layers (counterpart of
``cusrl_tpu/nn/layer/mha.py``: ``scaled_dot_product_attention``,
``MultiheadAttention`` with its aliases and its cross-attention form,
``FeedForward``, ``_LayerNorm``, ``_RmsNorm``, ``TransformerEncoderLayer``
and ``TransformerDecoderLayer``).

Numerics follow the JAX layers: SDPA in fp32 with ``-1e30`` masking and rows
without a valid key set to exactly 0; the fused q/k/v projection as one
matmul against the concatenated weights (bf16 operands, fp32 accumulation
and bias, cast down); LayerNorm with fp32 internals, the population variance
and eps 1e-6; QK-norm as an RMS norm over each head's features (fp32, eps
1e-6, an fp32 scale of the head's width, cast back) on q and k after the
projection and before RoPE, so a ring cache holds normed keys that are not
yet rotated.  On CUDA tensors with enough rows the FeedForward runs as one
fused chain kernel with gelu (``nn/kernels/fused_mlp.py``).  These layers
declare no tensor-parallel specs: under tensor parallelism their weights stay
whole and their kernels run as in one process.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cusrl_tpu_torch.nn.kernels.fused_mlp import fused_mlp, supports_fused_mlp
from cusrl_tpu_torch.nn.layer.encoding import RotaryEmbedding
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation

__all__ = [
    "FeedForward",
    "LayerNorm",
    "MultiheadAttention",
    "MultiheadCrossAttention",
    "MultiheadSelfAttention",
    "TransformerDecoderLayer",
    "TransformerEncoderLayer",
    "scaled_dot_product_attention",
]


def scaled_dot_product_attention(q, k, v, mask=None, bias=None):
    """q ``[.., H, Lq, D]``, k/v ``[.., H, Lk, D]``; ``mask`` bool,
    broadcastable to ``[.., H, Lq, Lk]``; fp32 out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1)
    if mask is not None:
        weights = torch.where(mask.any(-1, keepdim=True), weights, 0.0)
    return torch.einsum("...qk,...kd->...qd", weights, v.float())


class _RmsNorm(nn.Module):
    """RMS norm over the last axis: fp32 math, eps 1e-6, an fp32 ``scale``,
    cast back to the input's dtype (the QK-norm of ``mha.py:48-58``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6) * self.scale).to(x.dtype)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, kv_dim: int | None = None, qk_norm: bool = False,
                 rope: bool = False, compute_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        kv_dim = kv_dim or embed_dim
        for name, input_dim in (("q_proj", embed_dim), ("k_proj", kv_dim), ("v_proj", kv_dim),
                                ("out_proj", embed_dim)):
            setattr(self, name, Linear(input_dim, embed_dim, compute_dtype=compute_dtype, generator=generator))
        head_dim = embed_dim // num_heads
        self.q_norm = _RmsNorm(head_dim) if qk_norm else None
        self.k_norm = _RmsNorm(head_dim) if qk_norm else None
        self.rope = RotaryEmbedding(head_dim) if rope else None
        self.num_heads = num_heads

    def _split(self, x):
        """``[.., L, C] -> [.., H, L, D]``."""
        return x.reshape(*x.shape[:-1], self.num_heads, -1).transpose(-2, -3)

    @staticmethod
    def _merge(x):
        """``[.., H, L, D] -> [.., L, H*D]``."""
        x = x.transpose(-2, -3)
        return x.reshape(*x.shape[:-2], -1)

    def _fused_dot(self, x, projs):
        """One matmul against the concatenated weights of ``projs``, with
        ``Linear``'s numerics; returns the per-projection outputs."""
        weight = torch.cat([p.weight for p in projs], 0)  # [out_total, in]
        bias = None
        if any(p.bias is not None for p in projs):
            bias = torch.cat([p.bias if p.bias is not None else torch.zeros_like(p.weight[:, 0]) for p in projs])
        dtype = projs[0].compute_dtype
        if dtype is not None:
            dtype = getattr(torch, dtype)
            h = F.linear(x.to(dtype).float(), weight.to(dtype).float(), bias).to(dtype)
        else:
            h = F.linear(x.float(), weight, bias)
        return h.split([p.output_dim for p in projs], dim=-1)

    def _rope_q(self, q, q_positions):
        if self.rope is None:
            return q
        if q_positions is None:
            q_positions = torch.arange(q.shape[-2], device=q.device)
        return self.rope(q, q_positions)

    def project_q(self, query, q_positions=None):
        """Query projection, QK-norm and RoPE: ``[.., Lq, C] -> [.., H, Lq, D]``."""
        q = self._split(self.q_proj(query))
        if self.q_norm is not None:
            q = self.q_norm(q)
        return self._rope_q(q, q_positions)

    def project_kv_raw(self, keyvalue):
        """k/v ``[.., H, Lk, D]`` from one matmul, with K-norm and without
        RoPE: the part a cache holds (a cached token's position changes as it
        ages)."""
        k, v = (self._split(t) for t in self._fused_dot(keyvalue, (self.k_proj, self.v_proj)))
        if self.q_norm is not None:
            k = self.k_norm(k)
        return k, v

    def project_qkv_raw(self, x, q_positions=None):
        """q/k/v ``[.., H, L, D]`` from one matmul, QK-normed; RoPE on q only
        (k stays raw for the cache and is rotated at attention time by
        ``rope_k``)."""
        q, k, v = (self._split(t) for t in self._fused_dot(x, (self.q_proj, self.k_proj, self.v_proj)))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        return self._rope_q(q, q_positions), k, v

    def rope_k(self, k, kv_positions):
        return k if self.rope is None else self.rope(k, kv_positions)

    def project_qkv(self, query, keyvalue=None, q_positions=None, kv_positions=None):
        """Projections, QK-norm and RoPE: per-head q/k/v ``[.., H, L, D]``."""
        keyvalue = query if keyvalue is None else keyvalue
        q = self.project_q(query, q_positions)
        k, v = self.project_kv_raw(keyvalue)
        if self.rope is not None:
            if kv_positions is None:
                kv_positions = torch.arange(k.shape[-2], device=k.device)
            k = self.rope_k(k, kv_positions)
        return q, k, v

    def merge_output(self, out):
        """Head merge + output projection of externally computed attention."""
        return self.out_proj(self._merge(out))

    def forward(self, query, keyvalue=None, mask=None, bias=None, q_positions=None, kv_positions=None,
                kv_pad_to: int | None = None):
        """query ``[.., Lq, C]``, keyvalue ``[.., Lk, Ckv]`` (the query when
        None); ``mask`` bool ``[.., Lq, Lk]`` or with a head axis;
        ``kv_pad_to`` pads the key axis with zeros after the projections and
        RoPE (the mask must cover the padded slots)."""
        q, k, v = self.project_qkv(query, keyvalue, q_positions, kv_positions)
        if kv_pad_to is not None and kv_pad_to > k.shape[-2]:
            extra = kv_pad_to - k.shape[-2]
            k, v = F.pad(k, (0, 0, 0, extra)), F.pad(v, (0, 0, 0, extra))
        if mask is not None and mask.dim() == q.dim() - 1:
            mask = mask.unsqueeze(-3)  # the head axis
        return self.out_proj(self._merge(scaled_dot_product_attention(q, k, v, mask=mask, bias=bias)))


MultiheadSelfAttention = MultiheadAttention


class MultiheadCrossAttention(MultiheadAttention):
    def forward(self, query, keyvalue, **kwargs):
        if keyvalue is None:
            raise ValueError("Cross attention requires a key/value input")
        return super().forward(query, keyvalue, **kwargs)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, activation: str = "gelu", glu: bool = False,
                 compute_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.up = Linear(dim, hidden_dim * 2 if glu else hidden_dim, compute_dtype=compute_dtype, generator=generator)
        self.down = Linear(hidden_dim, dim, compute_dtype=compute_dtype, generator=generator)
        self.activation = activation
        self.glu = glu

    def _can_fuse(self, x: torch.Tensor) -> bool:
        """The JAX rule (``mha.py:241-259``) with "backend is TPU" replaced by
        "tensor is on CUDA"."""
        rows = 1
        for dim in x.shape[:-1]:
            rows *= dim
        return (
            not self.glu
            and x.dim() >= 2
            and rows >= 256
            and x.is_cuda
            and supports_fused_mlp(self.activation, 2, False)
            and all(l.compute_dtype == "bfloat16" and l.bias is not None for l in (self.up, self.down))
        )

    def forward(self, x):
        if self._can_fuse(x):
            out = fused_mlp(x.reshape(-1, x.shape[-1]), [self.up.weight, self.down.weight],
                            [self.up.bias, self.down.bias], self.activation, False)
            return out.reshape(*x.shape[:-1], out.shape[-1])
        h = self.up(x)
        if self.glu:
            a, b = h.chunk(2, dim=-1)
            h = a * get_activation(self.activation)(b)
        else:
            h = get_activation(self.activation)(h)
        return self.down(h)


class LayerNorm(nn.Module):
    """fp32 internals, population variance, eps 1e-6 (``_LayerNorm``, and
    SimBa's ``LayerNorm`` with its ``epsilon``)."""

    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.epsilon = epsilon

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.epsilon) * self.scale + self.bias).to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """Self-attention and FeedForward with residuals, in ``pre``, ``post`` or
    ``none`` norm mode.  As in JAX, ``attn_kwargs`` (``qk_norm``, ``rope``,
    ``compute_dtype``, ...) go to the attention only: the FeedForward is
    fp32 (``ff_dim`` defaults to ``4 * dim``)."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int | None = None, norm_mode: str = "pre",
                 generator: torch.Generator | None = None, **attn_kwargs):
        super().__init__()
        self.attention = MultiheadAttention(dim, num_heads, generator=generator, **attn_kwargs)
        self.feed_forward = FeedForward(dim, ff_dim or 4 * dim, generator=generator)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.norm_mode = norm_mode

    def forward(self, x, mask=None):
        if self.norm_mode == "pre":
            x = x + self.attention(self.norm1(x), mask=mask)
            x = x + self.feed_forward(self.norm2(x))
        elif self.norm_mode == "post":
            x = self.norm1(x + self.attention(x, mask=mask))
            x = self.norm2(x + self.feed_forward(x))
        else:
            x = x + self.attention(x, mask=mask)
            x = x + self.feed_forward(x)
        return x


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self-attention, cross-attention over ``memory`` (``memory_dim``
    wide, ``dim`` by default) and FeedForward, each with a residual."""

    def __init__(self, dim: int, num_heads: int, memory_dim: int | None = None, ff_dim: int | None = None,
                 generator: torch.Generator | None = None, **kwargs):
        super().__init__()
        self.self_attention = MultiheadAttention(dim, num_heads, generator=generator, **kwargs)
        self.cross_attention = MultiheadCrossAttention(dim, num_heads, kv_dim=memory_dim, generator=generator,
                                                       **kwargs)
        self.feed_forward = FeedForward(dim, ff_dim or 4 * dim, generator=generator)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.norm_mode = "pre"

    def forward(self, x, memory, self_mask=None, cross_mask=None):
        x = x + self.self_attention(self.norm1(x), mask=self_mask)
        x = x + self.cross_attention(self.norm2(x), memory, mask=cross_mask)
        return x + self.feed_forward(self.norm3(x))

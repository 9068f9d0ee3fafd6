"""Multi-head attention pieces of the causal transformer (counterpart of
``scaled_dot_product_attention``, ``MultiheadAttention``, ``FeedForward`` and
``_LayerNorm`` in ``cusrl_tpu/nn/layer/mha.py``).

Numerics follow the JAX layers: SDPA in fp32 with ``-1e30`` masking and rows
without a valid key set to exactly 0; the fused q/k/v projection as one
matmul against the concatenated weights (bf16 operands, fp32 accumulation
and bias, cast down); LayerNorm with fp32 internals, the population variance
and eps 1e-6.  On CUDA tensors with enough rows the FeedForward runs as one
fused chain kernel with gelu (``nn/kernels/fused_mlp.py``).  QK-norm is not
ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cusrl_tpu_torch.nn.kernels.fused_mlp import fused_mlp, supports_fused_mlp
from cusrl_tpu_torch.nn.layer.encoding import RotaryEmbedding
from cusrl_tpu_torch.nn.layer.linear import Linear, get_activation

__all__ = ["FeedForward", "LayerNorm", "MultiheadAttention", "scaled_dot_product_attention"]


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


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, qk_norm: bool = False, rope: bool = False,
                 compute_dtype: str | None = None, generator: torch.Generator | None = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if qk_norm:
            raise NotImplementedError("QK-norm is not ported yet")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(embed_dim, embed_dim, compute_dtype=compute_dtype, generator=generator))
        self.rope = RotaryEmbedding(embed_dim // num_heads) if rope else None
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

    def project_qkv_raw(self, x, q_positions=None):
        """q/k/v ``[.., H, L, D]`` from one matmul; RoPE on q only (k stays
        raw for the cache and is rotated at attention time by ``rope_k``)."""
        q, k, v = (self._split(t) for t in self._fused_dot(x, (self.q_proj, self.k_proj, self.v_proj)))
        if self.rope is not None:
            if q_positions is None:
                q_positions = torch.arange(q.shape[-2], device=q.device)
            q = self.rope(q, q_positions)
        return q, k, v

    def rope_k(self, k, kv_positions):
        return k if self.rope is None else self.rope(k, kv_positions)

    def merge_output(self, out):
        """Head merge + output projection of externally computed attention."""
        return self.out_proj(self._merge(out))


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
    """fp32 internals, population variance, eps 1e-6 (``_LayerNorm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + 1e-6) * self.scale + self.bias).to(x.dtype)

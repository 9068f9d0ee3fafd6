"""Sliding-window causal self-attention as a recurrent module (counterpart of
``cusrl_tpu/nn/module/causal_attn.py``: ``CausalMultiheadSelfAttention``,
``CausalTransformerEncoderLayer`` and its factory, on the modular route).

The memory caches the last ``window + 1`` projected key/value pairs in a
ring::

    memory = {
        "k_cache": [N, H, P, D],   # pre-RoPE keys (P = window + 1 ring slots)
        "v_cache": [N, H, P, D],   # in the projections' dtype
        "cache_mask": [N, P],      # per-slot validity (fp32)
        "cursor": [] int64,        # GLOBAL next-write slot, a device tensor
    }

A step projects only the new token's k/v, writes them at ``cursor`` and
attends over the ring; RoPE positions come from the slots' ages
``(cursor - i) mod P`` and keys are cached before RoPE.  The cursor stays on
the device: the write is an ``index_copy`` and the chronological unroll an
``index_select`` with tensor indices, so no step reads it on the host.
Done-driven resets zero the per-env mask but never the cursor.

Sequence mode computes all T queries against ``[cache ++ sequence]`` keys:
``lane`` through the K3 kernel wrapper (``nn/kernels/lane_attention.py``;
on CUDA for T <= 64, the JAX "auto" rule with "TPU" read as "CUDA"),
``batched`` as one masked SDPA, ``scan`` as a loop of the single-step cell
(the definitional reference).  Where the JAX rule picks the banded flash
kernel (K7, long sequences) the port raises ``NotImplementedError``.  The
fused-block route (K4/K5) and the env-minor variants are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory
from cusrl_tpu_torch.nn.kernels.lane_attention import (
    lane_next_token_attention,
    lane_window_attention,
    next_token_plain,
)
from cusrl_tpu_torch.nn.layer.encoding import alibi_slopes
from cusrl_tpu_torch.nn.layer.gate import make_gate
from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.nn.layer.mha import FeedForward, LayerNorm, MultiheadAttention, scaled_dot_product_attention

__all__ = [
    "CausalMultiheadSelfAttention",
    "CausalTransformerEncoderLayer",
    "CausalTransformerEncoderLayerFactory",
    "fused_pair_sequence",
]

LANE_MAX_T = 64  # the JAX "auto" rule's lane limit


def _cursor_scalar(cursor: torch.Tensor) -> torch.Tensor:
    """The global cursor (0-d) from any stored form ([] live, [N] stored)."""
    return cursor.reshape(-1)[0] if cursor.dim() else cursor


class CausalMultiheadSelfAttention(BackboneContract, nn.Module):
    is_recurrent = True

    def __init__(self, mha: MultiheadAttention, window: int = 16, use_alibi: bool = False, input_dim: int = 0,
                 sequence_mode: str = "auto"):
        super().__init__()
        if sequence_mode not in ("auto", "lane", "batched", "scan", "banded"):
            raise ValueError(f"Unknown sequence_mode '{sequence_mode}'")
        self.mha = mha
        self.window = window
        self.use_alibi = use_alibi
        self.input_dim = input_dim
        self.sequence_mode = sequence_mode
        # Slopes as floats for the kernels (passed by value) and as a buffer
        # for the plain paths, so no step copies them to the device.
        self.slopes = tuple(alibi_slopes(mha.num_heads)) if use_alibi else None
        self.register_buffer("alibi", torch.tensor(self.slopes or (), dtype=torch.float32), persistent=False)

    @property
    def output_dim(self) -> int:
        return self.input_dim

    @property
    def _ring_slots(self) -> int:
        return self.window + 1

    def init_memory(self, batch_size: int) -> Memory:
        heads = self.mha.num_heads
        head_dim = self.input_dim // heads
        device = self.mha.q_proj.weight.device
        # The projections' output dtype, so the ring stores exactly what
        # project_qkv_raw produces.
        dtype = getattr(torch, self.mha.k_proj.compute_dtype or "float32")
        shape = (batch_size, heads, self._ring_slots, head_dim)
        return {
            "k_cache": torch.zeros(shape, dtype=dtype, device=device),
            "v_cache": torch.zeros(shape, dtype=dtype, device=device),
            "cache_mask": torch.zeros(batch_size, self._ring_slots, device=device),
            "cursor": torch.zeros((), dtype=torch.int64, device=device),
        }

    # -- single step (ring write + masked SDPA over the ring) ------------------

    def _step(self, x, memory):
        """x ``[N, C]``; returns ``(out [N, C], new ring memory)``."""
        slots = self._ring_slots
        cursor = _cursor_scalar(memory["cursor"])
        device = x.device
        q, k_new, v_new = self.mha.project_qkv_raw(
            x[:, None], q_positions=torch.full((1,), self.window, device=device)
        )  # [N, H, 1, D], q RoPE'd at position W
        index = cursor.reshape(1)
        k_cache = memory["k_cache"].index_copy(2, index, k_new.to(memory["k_cache"].dtype))
        v_cache = memory["v_cache"].index_copy(2, index, v_new.to(memory["v_cache"].dtype))
        mask = memory["cache_mask"].index_copy(1, index, torch.ones_like(memory["cache_mask"][:, :1]))

        ages = torch.remainder(cursor - torch.arange(slots, device=device), slots)  # [P]; 0 == current token
        k_rot = self.mha.rope_k(k_cache, self.window - ages)
        bias = None
        if self.use_alibi:
            bias = -self.alibi[:, None, None] * ages[None, None, :].float()  # [H, 1, P]
        out = scaled_dot_product_attention(q, k_rot, v_cache, mask=(mask > 0.5)[:, None, None, :], bias=bias)
        out = self.mha.merge_output(out)[:, 0]
        new_memory = {
            "k_cache": k_cache.detach(),
            "v_cache": v_cache.detach(),
            "cache_mask": mask,
            "cursor": torch.remainder(cursor + 1, slots).expand(memory["cursor"].shape),
        }
        return out, new_memory

    # -- shared sequence-mode plumbing -----------------------------------------

    def _unrolled_cache(self, memory):
        """Ring -> chronological last-W cache: ``(k_raw [N, H, W, D], v,
        mask [N, W])``; slot ``cursor`` is the oldest entry."""
        cursor = _cursor_scalar(memory["cursor"])
        device = memory["cache_mask"].device
        index = torch.remainder(cursor + 1 + torch.arange(self.window, device=device), self._ring_slots)
        return (memory["k_cache"].index_select(2, index), memory["v_cache"].index_select(2, index),
                memory["cache_mask"].index_select(1, index))

    def _sequence_qkv(self, x, memory):
        """``(q [N, H, T, D], k_rot/v [N, H, W+T, D], k_raw, cache_mask,
        q_pos, kv_pos)`` for ``x [T, N, C]``."""
        t_len = x.shape[0]
        device = x.device
        k_cache, v_cache, cache_mask = self._unrolled_cache(memory)
        q_pos = self.window + torch.arange(t_len, device=device)
        kv_pos = torch.arange(self.window + t_len, device=device)
        q, k_seq, v_seq = self.mha.project_qkv_raw(x.transpose(0, 1), q_positions=q_pos)
        dtype = torch.promote_types(k_cache.dtype, k_seq.dtype)
        k_raw = torch.cat([k_cache.to(dtype), k_seq.to(dtype)], 2)
        v_all = torch.cat([v_cache.to(dtype), v_seq.to(dtype)], 2)
        return q, self.mha.rope_k(k_raw, kv_pos), v_all, k_raw, cache_mask, q_pos, kv_pos

    @staticmethod
    def _segments(done, t_len: int, batch: int):
        """``(done [T, N], seg [T, N])``: seg counts the dones strictly before t."""
        done2 = done.reshape(t_len, batch)
        shifted = torch.cat([torch.zeros_like(done2[:1]), done2[:-1]], 0)
        return done2, torch.cumsum(shifted.to(torch.int32), 0, dtype=torch.int32)

    def _final_memory(self, k_raw, v_all, k_valid, k_seg, seg, done2, memory):
        """Ring-form final memory: the last P combined tokens in order with
        cursor 0, valid iff valid and in the post-rollout episode's segment."""
        slots = self._ring_slots
        final_seg = seg[-1] + done2[-1].to(torch.int32)  # [N]
        final_valid = (k_valid > 0) & (k_seg == final_seg[:, None])  # [N, W+T]
        return {
            "k_cache": k_raw[:, :, -slots:].detach().to(memory["k_cache"].dtype),
            "v_cache": v_all[:, :, -slots:].detach().to(memory["v_cache"].dtype),
            "cache_mask": final_valid[:, -slots:].to(memory["cache_mask"].dtype),
            "cursor": torch.zeros_like(memory["cursor"]),
        }

    def _resolve_mode(self, x, collect_ctx: bool) -> str:
        mode = self.sequence_mode
        if collect_ctx and mode == "scan":
            return "batched"  # the scan cell exposes no whole-sequence keys
        if mode == "auto":
            t_len, window = x.shape[0], self.window
            if t_len <= LANE_MAX_T and x.is_cuda:
                return "lane"
            block = min(128, -(-t_len // 8) * 8)
            band = (1 + -(-window // block)) * block
            mode = "banded" if band * 2 <= window + t_len else "batched"
        if mode == "banded":
            raise NotImplementedError("the banded window-attention kernel (K7, banded_window_attention) that long "
                                      "sequences take is not ported yet")
        return mode

    def forward(self, x, memory: Memory = None, *, sequential: bool = False, done=None,
                collect_next_ctx: bool = False, **kwargs):
        if memory is None:
            memory = self.init_memory(x.shape[1] if sequential else x.shape[0])
        if not sequential:
            return (*self._step(x, memory), {})
        if done is None:
            done = torch.zeros(*x.shape[:2], 1, dtype=torch.bool, device=x.device)
        mode = self._resolve_mode(x, collect_next_ctx)
        if mode in ("lane", "batched"):
            return self._sequence(x, memory, done, lane=mode == "lane", collect_ctx=collect_next_ctx)
        outputs = []
        for t in range(x.shape[0]):
            out, memory = self._step(x[t], memory)
            keep = ~done[t]  # [N, 1]
            memory = {
                "k_cache": torch.where(keep[..., None, None], memory["k_cache"], 0.0),
                "v_cache": torch.where(keep[..., None, None], memory["v_cache"], 0.0),
                "cache_mask": torch.where(keep, memory["cache_mask"], 0.0),
                "cursor": memory["cursor"],
            }
            outputs.append(out)
        return torch.stack(outputs), memory, {}

    def _sequence(self, x, memory, done, *, lane: bool, collect_ctx: bool):
        """All T queries at once: through the K3 wrapper (``lane``) or one
        masked SDPA over ``[cache ++ sequence]`` keys (``batched``), with
        the same masks: query t (combined position W+t) sees positions
        ``[t, W+t]`` of its own segment; cache slots belong to segment 0 and
        are valid by ``cache_mask``."""
        t_len, batch = x.shape[:2]
        window = self.window
        q, k_rot, v_all, k_raw, cache_mask, q_pos, kv_pos = self._sequence_qkv(x, memory)
        done2, seg = self._segments(done, t_len, batch)
        q_seg = seg.transpose(0, 1)  # [N, T]
        k_seg = torch.cat([torch.zeros_like(q_seg[:, :1]).expand(batch, window), q_seg], 1)  # [N, W+T]
        k_valid = torch.cat([(cache_mask > 0.5).to(torch.int32),
                             torch.ones(batch, t_len, dtype=torch.int32, device=x.device)], 1)
        if lane:
            out = lane_window_attention(q, k_rot, v_all, q_seg, k_seg, k_valid, window=window, slopes=self.slopes)
        else:
            in_window = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] >= q_pos[:, None] - window)
            mask = in_window[None] & (q_seg[:, :, None] == k_seg[:, None, :]) & (k_valid[:, None, :] > 0)
            bias = None
            if self.use_alibi:
                distance = (q_pos[:, None] - kv_pos[None, :]).float()  # [T, W+T]
                bias = -self.alibi[:, None, None] * distance[None]  # [H, T, W+T]
            out = scaled_dot_product_attention(q, k_rot, v_all, mask=mask[:, None], bias=bias)
        outputs = self.mha.merge_output(out).transpose(0, 1)  # [T, N, C]
        new_memory = self._final_memory(k_raw, v_all, k_valid, k_seg, seg, done2, memory)
        aux = {"next_ctx": (k_rot, v_all, k_valid, k_seg, q_seg)} if collect_ctx else {}
        return outputs, new_memory, aux

    # -- counterfactual-append evaluation (nn/base.py contract) ----------------

    @property
    def supports_next_token_eval(self) -> bool:
        return True

    def sequential_with_ctx(self, x, memory: Memory, done):
        out, new_memory, aux = self(x, memory, sequential=True, done=done, collect_next_ctx=True)
        return out, new_memory, aux.pop("next_ctx")

    def eval_next_core(self, q, k_self_rot, v_self, ctx):
        """Query t over the value pass's keys ``[t+1, W+t]`` (the W tokens its
        ring would hold after writing y[t]) plus its own k/v: K6 for short
        sequences (its wrapper takes the plain version on the CPU), the plain
        version otherwise, as the JAX routing.  fp32 ``[N, H, T, D]``."""
        k_rot, v_all, k_valid, k_seg, q_seg = ctx
        args = (q, k_self_rot, v_self, k_rot, v_all, q_seg, k_seg, k_valid)
        if q.shape[2] <= LANE_MAX_T:
            return lane_next_token_attention(*args, window=self.window, slopes=self.slopes)
        return next_token_plain(*args, self.window, self.slopes)

    def _next_token_heads(self, a):
        """q, k_self (RoPE'd at ``W+t+1``) and v_self of ``a [T, N, C]``."""
        q_pos = self.window + 1 + torch.arange(a.shape[0], device=a.device)
        q, k_self, v_self = self.mha.project_qkv_raw(a.transpose(0, 1), q_positions=q_pos)
        return q, self.mha.rope_k(k_self, q_pos), v_self

    def eval_next_token(self, y, ctx):
        """``y [T, N, C] -> [T, N, C]``: the output for y[t] as if processed
        right after x[t], without advancing the ring."""
        out = self.eval_next_core(*self._next_token_heads(y), ctx)
        return self.mha.merge_output(out).transpose(0, 1)


def fused_pair_sequence(layer_a, layer_c, xa, xc, mem_a, mem_c, done):
    """The actor+critic fused-block pass of the JAX package needs the K4/K5
    kernels (``nn/kernels/fused_block.py``), which are not ported yet."""
    raise NotImplementedError("fused_pair_sequence needs the fused-block kernels K4/K5, not ported yet")


class CausalTransformerEncoderLayer(BackboneContract, nn.Module):
    """input proj -> [norm] windowed causal attention [gate] -> [norm] FFN
    [gate], on the modular route (the JAX layer with
    ``CUSRL_TPU_FUSED_TRANSFORMER=0``)."""

    is_recurrent = True

    def __init__(self, input_proj: Linear | None, attention: CausalMultiheadSelfAttention, feed_forward: FeedForward,
                 norm1: LayerNorm, norm2: LayerNorm, gate1: nn.Module, gate2: nn.Module, norm_mode: str = "pre",
                 input_dim: int = 0):
        super().__init__()
        self.input_proj = input_proj
        self.attention = attention
        self.feed_forward = feed_forward
        self.norm1, self.norm2 = norm1, norm2
        self.gate1, self.gate2 = gate1, gate2
        self.norm_mode = norm_mode
        self.input_dim = input_dim

    @property
    def output_dim(self) -> int:
        return self.attention.input_dim

    def init_memory(self, batch_size: int) -> Memory:
        return self.attention.init_memory(batch_size)

    def _chain(self, h, attend):
        """The residual/gate/norm skeleton every route shares (stepwise,
        sequence, context-collecting, counterfactual append): ``attend``
        maps the attention input to ``(attn_out, extra)``."""
        if self.norm_mode == "pre":
            attn_out, extra = attend(self.norm1(h))
            out = self.gate1(h, attn_out)
            out = self.gate2(out, self.feed_forward(self.norm2(out)))
        elif self.norm_mode == "post":
            attn_out, extra = attend(h)
            out = self.norm1(self.gate1(h, attn_out))
            out = self.norm2(self.gate2(out, self.feed_forward(out)))
        else:
            attn_out, extra = attend(h)
            out = self.gate1(h, attn_out)
            out = self.gate2(out, self.feed_forward(out))
        return out, extra

    def _project(self, x):
        return self.input_proj(x) if self.input_proj is not None else x

    def forward(self, x, memory: Memory = None, *, sequential: bool = False, done=None, **kwargs):
        out, new_memory = self._chain(
            self._project(x), lambda a: self.attention(a, memory, sequential=sequential, done=done)[:2]
        )
        return out, new_memory, {}

    @property
    def supports_next_token_eval(self) -> bool:
        return True

    def sequential_with_ctx(self, x, memory: Memory, done):
        if memory is None:
            memory = self.init_memory(x.shape[1])
        if done is None:
            done = torch.zeros(*x.shape[:2], 1, dtype=torch.bool, device=x.device)

        def attend(a):
            out, new_memory, aux = self.attention(a, memory, sequential=True, done=done, collect_next_ctx=True)
            return out, (new_memory, aux.pop("next_ctx"))

        out, (new_memory, ctx) = self._chain(self._project(x), attend)
        return out, new_memory, ctx

    def eval_next_token(self, y, ctx):
        attention = self.attention

        def attend(a):
            out = attention.eval_next_core(*attention._next_token_heads(a), ctx)
            return attention.mha.merge_output(out).transpose(0, 1), None

        return self._chain(self._project(y), attend)[0]


@dataclasses.dataclass
class CausalTransformerEncoderLayerFactory:
    embed_dim: int = 128
    num_heads: int = 4
    window: int = 16
    ff_dim: int | None = None
    norm_mode: str = "pre"
    gate: str | None = "residual"
    use_alibi: bool = False
    use_rope: bool = True
    qk_norm: bool = False
    compute_dtype: str | None = "default"

    is_recurrent = True

    def __call__(self, input_dim: int, output_dim: int | None,
                 generator: torch.Generator | None = None) -> CausalTransformerEncoderLayer:
        from cusrl_tpu_torch.utils.config import CONFIG

        dtype = CONFIG.compute_dtype if self.compute_dtype == "default" else self.compute_dtype
        embed = self.embed_dim
        input_proj = None
        if input_dim != embed:
            input_proj = Linear(input_dim, embed, compute_dtype=dtype, generator=generator)
        attention = CausalMultiheadSelfAttention(
            MultiheadAttention(embed, self.num_heads, qk_norm=self.qk_norm, rope=self.use_rope, compute_dtype=dtype,
                               generator=generator),
            window=self.window, use_alibi=self.use_alibi, input_dim=embed,
        )
        return CausalTransformerEncoderLayer(
            input_proj=input_proj,
            attention=attention,
            feed_forward=FeedForward(embed, self.ff_dim or 4 * embed, compute_dtype=dtype, generator=generator),
            norm1=LayerNorm(embed),
            norm2=LayerNorm(embed),
            gate1=make_gate(self.gate, embed, generator),
            gate2=make_gate(self.gate, embed, generator),
            norm_mode=self.norm_mode,
            input_dim=input_dim,
        )

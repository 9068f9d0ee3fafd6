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
``banded`` through the K7 kernel wrapper (``nn/kernels/banded_attention.py``;
where the JAX rule picks it: long sequences whose key band is at most half
the keys), ``batched`` as one masked SDPA, ``scan`` as a loop of the
single-step cell (the definitional reference).

The encoder layer's fused-block route (``nn/kernels/fused_block.py``: K4, and
K5 for the actor+critic pair in ``fused_pair_sequence``) runs every matmul
and LayerNorm of the block in two ops around the attention middle
(``sequence_core`` / ``step_core``).  The route is chosen per call by the JAX
package's rule and environment variables: ``CUSRL_TPU_FUSED_TRANSFORMER``
(``1``, the default: CUDA tensors with at least 256 rows; ``0``: never;
``force``: always, the kernels' plain versions on the CPU) and
``CUSRL_TPU_FUSED_TRANSFORMER_STEP`` (``1`` adds the single-step route;
default ``0``).  A QK-normed layer keeps the modular route, as in JAX: K3 in
sequence mode, the ring's SDPA in a step, K6 in the next-token pass.
``CUSRL_TPU_PAIR_CONCAT=1`` (read per call) makes the pair pass one lane
call over both networks' environments side by side.  The env-minor variants
(``CUSRL_TPU_SEQCORE_EM``, ``CUSRL_TPU_LANE_EM``) are not ported.

Under tensor parallelism (``parallel.distribute_agent(...,
tensor_parallel=True)``) these modules keep their weights whole (only
``Mlp`` declares ``tp_specs``), so the attention kernels (K3f/K3b/K6/K7f)
and the fused block (K4/K5) run as in one process, with the same numerics,
where the JAX package's rule drops every Pallas kernel under a mesh; a
sharded Mlp head after them runs its layers plain.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory
from cusrl_tpu_torch.nn.kernels.banded_attention import banded_window_attention
from cusrl_tpu_torch.nn.kernels.fused_block import (
    fused_block_pair_post,
    fused_block_pair_pre,
    fused_block_post,
    fused_block_pre,
    supports_fused_block,
)
from cusrl_tpu_torch.nn.kernels.lane_attention import (
    lane_next_token_attention,
    lane_window_attention,
    next_token_plain,
)
from cusrl_tpu_torch.nn.layer.encoding import alibi_slopes
from cusrl_tpu_torch.nn.layer.gate import ResidualGate, make_gate
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
        q, k_new, v_new = self.mha.project_qkv_raw(
            x[:, None], q_positions=torch.full((1,), self.window, device=x.device)
        )  # [N, H, 1, D], q RoPE'd at position W
        out, new_memory = self._ring_attend(q, k_new, v_new, memory)
        return self.mha.merge_output(out)[:, 0], new_memory

    def step_core(self, q, k_new, v_new, memory):
        """Ring write and masked SDPA for pre-projected single-step q/k/v
        (``[N, H, 1, D]``, q RoPE'd at position W, k raw): the attention
        middle of the fused-block step route.  Returns the merged heads
        ``[N, E]`` fp32 without the output projection (the post op has it)."""
        out, new_memory = self._ring_attend(q, k_new, v_new, memory)
        return self.mha._merge(out)[:, 0], new_memory

    def _ring_attend(self, q, k_new, v_new, memory):
        """Writes ``k_new``/``v_new`` at the cursor and attends over the ring:
        ``(out [N, H, 1, D] fp32, new memory)``."""
        slots = self._ring_slots
        cursor = _cursor_scalar(memory["cursor"])
        index = cursor.reshape(1)
        k_cache = memory["k_cache"].index_copy(2, index, k_new.to(memory["k_cache"].dtype))
        v_cache = memory["v_cache"].index_copy(2, index, v_new.to(memory["v_cache"].dtype))
        mask = memory["cache_mask"].index_copy(1, index, torch.ones_like(memory["cache_mask"][:, :1]))

        ages = torch.remainder(cursor - torch.arange(slots, device=q.device), slots)  # [P]; 0 == current token
        k_rot = self.mha.rope_k(k_cache, self.window - ages)
        bias = None
        if self.use_alibi:
            bias = -self.alibi[:, None, None] * ages[None, None, :].float()  # [H, 1, P]
        out = scaled_dot_product_attention(q, k_rot, v_cache, mask=(mask > 0.5)[:, None, None, :], bias=bias)
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
        if mode in ("lane", "banded", "batched"):
            return self._sequence(x, memory, done, kernel=mode, collect_ctx=collect_next_ctx)
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

    def _sequence(self, x, memory, done, *, kernel: str, collect_ctx: bool):
        """All T queries of ``x [T, N, C]`` at once: the projections, then
        ``_attend_sequence`` and the output projection."""
        q_pos = self.window + torch.arange(x.shape[0], device=x.device)
        q, k_seq, v_seq = self.mha.project_qkv_raw(x.transpose(0, 1), q_positions=q_pos)
        out, new_memory, ctx = self._attend_sequence(q, k_seq, v_seq, memory, done, kernel=kernel,
                                                     collect_ctx=collect_ctx)
        outputs = self.mha.merge_output(out).transpose(0, 1)  # [T, N, C]
        return outputs, new_memory, ({"next_ctx": ctx} if collect_ctx else {})

    def _split_qkv(self, qkv_flat, t_len: int, batch: int):
        """The fused ``[T*N, 3E]`` projections as q, k, v ``[N, H, T, D]``."""
        embed, heads = self.input_dim, self.mha.num_heads
        return [qkv_flat[:, i * embed:(i + 1) * embed].reshape(t_len, batch, heads, -1).permute(1, 2, 0, 3)
                for i in range(3)]

    def sequence_core(self, qkv_flat, memory, done, t_len: int, batch: int, *, collect_ctx: bool = False):
        """Attention middle of the fused-block route: the pre op's ``[T*N, 3E]``
        bf16 projections (k not yet RoPE'd) in; the merged heads ``[T*N, E]``
        fp32 (no output projection: the post op has it) and the ring-form
        final memory out, and with ``collect_ctx`` the next-token context.
        Same masks and cache as ``_sequence``; the K3 wrapper for T <= 64,
        the K7 wrapper for longer sequences (JAX ``causal_attn.py:395-402``)."""
        if os.environ.get("CUSRL_TPU_SEQCORE_EM", "0").lower() not in ("0", ""):
            raise NotImplementedError("the env-minor sequence core (CUSRL_TPU_SEQCORE_EM) is not ported")
        q, k_seq, v_seq = self._split_qkv(qkv_flat, t_len, batch)
        if self.mha.rope is not None:
            q = self.mha.rope(q, self.window + torch.arange(t_len, device=q.device))
        kernel = "lane" if t_len <= LANE_MAX_T else "banded"
        out, new_memory, ctx = self._attend_sequence(q, k_seq, v_seq, memory, done, kernel=kernel,
                                                     collect_ctx=collect_ctx)
        merged = self.mha._merge(out).transpose(0, 1).reshape(t_len * batch, self.input_dim)
        return (merged, new_memory, ctx) if collect_ctx else (merged, new_memory)

    def _attend_sequence(self, q, k_seq, v_seq, memory, done, *, kernel: str, collect_ctx: bool):
        """q (RoPE'd at ``W+t``), k_seq, v_seq ``[N, H, T, D]`` against
        ``[cache ++ sequence]`` keys, through the K3 wrapper (``lane``), the
        K7 wrapper (``banded``) or one masked SDPA (``batched``), with the
        same masks: query t (combined
        position W+t) sees positions ``[t, W+t]`` of its own segment; cache
        slots belong to segment 0 and are valid by ``cache_mask``.  Returns
        ``(out [N, H, T, D] fp32, new memory, next-token context or None)``."""
        batch, _, t_len, _ = q.shape
        window = self.window
        device = q.device
        k_cache, v_cache, cache_mask = self._unrolled_cache(memory)
        q_pos = window + torch.arange(t_len, device=device)
        kv_pos = torch.arange(window + t_len, device=device)
        dtype = torch.promote_types(k_cache.dtype, k_seq.dtype)
        k_raw = torch.cat([k_cache.to(dtype), k_seq.to(dtype)], 2)
        v_all = torch.cat([v_cache.to(dtype), v_seq.to(dtype)], 2)
        k_rot = self.mha.rope_k(k_raw, kv_pos)
        done2, seg = self._segments(done, t_len, batch)
        q_seg = seg.transpose(0, 1)  # [N, T]
        k_seg = torch.cat([torch.zeros_like(q_seg[:, :1]).expand(batch, window), q_seg], 1)  # [N, W+T]
        k_valid = torch.cat([(cache_mask > 0.5).to(torch.int32),
                             torch.ones(batch, t_len, dtype=torch.int32, device=device)], 1)
        if kernel == "lane":
            out = lane_window_attention(q, k_rot, v_all, q_seg, k_seg, k_valid, window=window, slopes=self.slopes)
        elif kernel == "banded":
            out = banded_window_attention(q, k_rot, v_all, q_seg, k_seg, k_valid, window=window, slopes=self.slopes)
        else:
            in_window = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] >= q_pos[:, None] - window)
            mask = in_window[None] & (q_seg[:, :, None] == k_seg[:, None, :]) & (k_valid[:, None, :] > 0)
            bias = None
            if self.use_alibi:
                distance = (q_pos[:, None] - kv_pos[None, :]).float()  # [T, W+T]
                bias = -self.alibi[:, None, None] * distance[None]  # [H, T, W+T]
            out = scaled_dot_product_attention(q, k_rot, v_all, mask=mask[:, None], bias=bias)
        new_memory = self._final_memory(k_raw, v_all, k_valid, k_seg, seg, done2, memory)
        ctx = (k_rot, v_all, k_valid, k_seg, q_seg) if collect_ctx else None
        return out, new_memory, ctx

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
    """The actor's and the critic's encoder layers as one pair pass: both pre
    ops in one K5 launch, the lane attention (``sequence_core``), both post
    ops in one K5 launch.  The attention is one call per layer, or with
    ``CUSRL_TPU_PAIR_CONCAT=1`` one call over both layers' environments
    concatenated (``2 * batch``; the attention has no weights and both layers
    share its configuration), split back after.  Both memories share the
    global ring cursor (both backbones advance through the same rollout).
    Returns ``(latent_a, latent_c, new_mem_a, new_mem_c)``."""
    t_len, batch = xa.shape[:2]
    rows = t_len * batch
    ha, hc, qkva, qkvc = fused_block_pair_pre(xa.reshape(rows, xa.shape[-1]), xc.reshape(rows, xc.shape[-1]),
                                              layer_a._pre_params(), layer_c._pre_params())
    if os.environ.get("CUSRL_TPU_PAIR_CONCAT", "0") == "1":
        width = qkva.shape[-1]
        qkv = torch.cat([qkva.reshape(t_len, batch, width), qkvc.reshape(t_len, batch, width)], 1)
        memory = {key: torch.cat([mem_a[key], mem_c[key]], 0) for key in ("k_cache", "v_cache", "cache_mask")}
        memory["cursor"] = mem_a["cursor"]
        attn, new_memory = layer_a.attention.sequence_core(qkv.reshape(2 * rows, width), memory,
                                                           torch.cat([done, done], 1), t_len, 2 * batch)
        attn = attn.reshape(t_len, 2 * batch, -1)
        attna, attnc = attn[:, :batch].reshape(rows, -1), attn[:, batch:].reshape(rows, -1)
        new_mem_a, new_mem_c = ({key: value if key == "cursor" else value[half]
                                 for key, value in new_memory.items()}
                                for half in (slice(0, batch), slice(batch, 2 * batch)))
    else:
        attna, new_mem_a = layer_a.attention.sequence_core(qkva, mem_a, done, t_len, batch)
        attnc, new_mem_c = layer_c.attention.sequence_core(qkvc, mem_c, done, t_len, batch)
    outa, outc = fused_block_pair_post(attna, attnc, ha, hc, layer_a._post_params(), layer_c._post_params(),
                                       layer_a.feed_forward.activation)
    return outa.reshape(t_len, batch, -1), outc.reshape(t_len, batch, -1), new_mem_a, new_mem_c


class CausalTransformerEncoderLayer(BackboneContract, nn.Module):
    """input proj -> [norm] windowed causal attention [gate] -> [norm] FFN
    [gate]: the modular route, or the fused-block route where
    ``_fused_eligible`` allows it (the JAX layer's two routes)."""

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
        """The residual/gate/norm skeleton every modular route shares
        (stepwise, sequence, context-collecting, counterfactual append):
        ``attend`` maps the attention input to ``(attn_out, extra)``."""
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

    # -- the fused-block route (K4) ---------------------------------------------

    def _fused_eligible(self, x, sequential: bool) -> bool:
        """The JAX rule (``causal_attn.py:870-921``), with "backend is TPU" read
        as "tensor is on CUDA".  The kernels cover the preset configuration
        without QK-norm; anything else keeps the modular route."""
        # Read per call: 1 (default) on CUDA tensors, 0 never, force always
        # (the kernels' plain versions on the CPU).
        mode = os.environ.get("CUSRL_TPU_FUSED_TRANSFORMER", "1").lower()
        if mode == "0" or x.dim() != (3 if sequential else 2):
            return False
        if not sequential and mode != "force" and os.environ.get("CUSRL_TPU_FUSED_TRANSFORMER_STEP", "0") != "1":
            return False  # the step route is off by default
        if self.norm_mode != "pre" or self.input_proj is None:
            return False
        if not (isinstance(self.gate1, ResidualGate) and isinstance(self.gate2, ResidualGate)):
            return False
        if self.attention.mha.q_norm is not None or self.attention.sequence_mode not in ("auto", "lane", "banded"):
            return False
        ff = self.feed_forward
        if ff.glu or not supports_fused_block(ff.activation):
            return False
        mha = self.attention.mha
        linears = (self.input_proj, mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj, ff.up, ff.down)
        if not all(l.compute_dtype == "bfloat16" and l.bias is not None for l in linears):
            return False
        rows = x.shape[0] * (x.shape[1] if sequential else 1)
        return mode == "force" or (rows >= 256 and x.is_cuda)

    def _pre_params(self):
        mha = self.attention.mha
        return (self.input_proj.weight, self.input_proj.bias, self.norm1.scale, self.norm1.bias,
                mha.q_proj.weight, mha.k_proj.weight, mha.v_proj.weight,
                mha.q_proj.bias, mha.k_proj.bias, mha.v_proj.bias)

    def _post_params(self):
        mha, ff = self.attention.mha, self.feed_forward
        return (mha.out_proj.weight, mha.out_proj.bias, self.norm2.scale, self.norm2.bias,
                ff.up.weight, ff.up.bias, ff.down.weight, ff.down.bias)

    def _fused_pass(self, x, middle):
        """pre op -> ``middle(qkv_flat, t_len, batch)`` -> post op over
        ``x [T, N, C]``; ``middle`` returns ``(attn [T*N, E], extra)``."""
        t_len, batch = x.shape[:2]
        h, qkv = fused_block_pre(x.reshape(t_len * batch, x.shape[-1]), *self._pre_params())
        attn, extra = middle(qkv, t_len, batch)
        out = fused_block_post(attn, h, *self._post_params(), self.feed_forward.activation)
        return out.reshape(t_len, batch, -1), extra

    def _fused_step(self, x, memory):
        """The single-step route: pre op -> ring write and masked SDPA
        (``step_core``) -> post op, their primal variants."""
        attention = self.attention

        def middle(qkv, t_len, batch):
            q, k_new, v_new = attention._split_qkv(qkv, 1, batch)
            if attention.mha.rope is not None:
                q = attention.mha.rope(q, torch.full((1,), attention.window, device=q.device))
            return attention.step_core(q, k_new, v_new, memory)

        out, new_memory = self._fused_pass(x[None], middle)
        return out[0], new_memory, {}

    # -- routes --------------------------------------------------------------------

    def forward(self, x, memory: Memory = None, *, sequential: bool = False, done=None, **kwargs):
        if self._fused_eligible(x, sequential):
            if memory is None:
                memory = self.init_memory(x.shape[1] if sequential else x.shape[0])
            if not sequential:
                return self._fused_step(x, memory)
            if done is None:
                done = torch.zeros(*x.shape[:2], 1, dtype=torch.bool, device=x.device)
            out, new_memory = self._fused_pass(
                x, lambda qkv, t, n: self.attention.sequence_core(qkv, memory, done, t, n))
            return out, new_memory, {}
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
        if self._fused_eligible(x, True):
            def middle(qkv, t_len, batch):
                attn, new_memory, ctx = self.attention.sequence_core(qkv, memory, done, t_len, batch, collect_ctx=True)
                return attn, (new_memory, ctx)

            out, (new_memory, ctx) = self._fused_pass(x, middle)
            return out, new_memory, ctx

        def attend(a):
            out, new_memory, aux = self.attention(a, memory, sequential=True, done=done, collect_next_ctx=True)
            return out, (new_memory, aux.pop("next_ctx"))

        out, (new_memory, ctx) = self._chain(self._project(x), attend)
        return out, new_memory, ctx

    def eval_next_token(self, y, ctx):
        attention = self.attention
        if self._fused_eligible(y, True):
            mha = attention.mha
            q_pos = attention.window + 1 + torch.arange(y.shape[0], device=y.device)

            def middle(qkv, t_len, batch):
                q, k_self, v_self = attention._split_qkv(qkv, t_len, batch)
                if mha.rope is not None:
                    q = mha.rope(q, q_pos)
                out = attention.eval_next_core(q, mha.rope_k(k_self, q_pos), v_self, ctx)
                return mha._merge(out).transpose(0, 1).reshape(t_len * batch, -1), None

            return self._fused_pass(y, middle)[0]

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

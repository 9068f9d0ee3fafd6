"""Episode-boundary sequence utilities (counterpart of
``cusrl_tpu/nn/utils/recurrent.py``), on tensors.

The recurrent modules reset their memory on done inside the sequence loop, so
nothing needs these for correctness; they give per-episode views (step
counters, segment lengths, the compact split-and-pad convention) and memory
selection helpers, with the JAX package's shapes and masks.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.utils.nest import map_nested

__all__ = [
    "compute_cumulative_timesteps",
    "compute_reverse_cumulative_timesteps",
    "compute_sequence_lengths",
    "concat_memory",
    "select_initial_memory",
    "split_and_pad_sequences",
    "unpad_and_merge_sequences",
]


def compute_cumulative_timesteps(done: torch.Tensor) -> torch.Tensor:
    """Steps since the episode's start, per position: ``done [T, N, 1]`` ->
    ``[T, N]`` int32."""
    done2 = done.reshape(done.shape[0], -1)
    carry = torch.zeros(done2.shape[1], dtype=torch.int32, device=done.device)
    out = []
    for done_t in done2:
        out.append(carry)
        carry = torch.where(done_t, 0, carry + 1).to(torch.int32)
    return torch.stack(out)


def compute_reverse_cumulative_timesteps(done: torch.Tensor) -> torch.Tensor:
    """Steps until the episode's end (the current one included, less one),
    per position."""
    done2 = done.reshape(done.shape[0], -1)
    carry = torch.zeros(done2.shape[1], dtype=torch.int32, device=done.device)
    out = []
    for done_t in reversed(done2):
        carry = (torch.where(done_t, 0, carry) + 1).to(torch.int32)
        out.append(carry)
    return torch.stack(out[::-1]) - 1


def compute_sequence_lengths(done: torch.Tensor) -> torch.Tensor:
    """Length of the episode segment holding each position."""
    return compute_cumulative_timesteps(done) + compute_reverse_cumulative_timesteps(done) + 1


def split_and_pad_sequences(data: torch.Tensor, done: torch.Tensor):
    """The JAX package's compact convention: ``(data [T, N, C] unchanged,
    mask [T, N] bool)``, every position valid within its own episode."""
    timesteps = compute_cumulative_timesteps(done)
    mask = torch.ones(data.shape[0], *done.shape[1:-1], dtype=torch.bool, device=data.device)
    return data, mask & (timesteps >= 0)


def unpad_and_merge_sequences(padded: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverse of ``split_and_pad_sequences`` under the compact convention."""
    return padded


def select_initial_memory(memory, temporal: bool = True):
    """The first step's memory out of a ``[T, ...]`` memory stack."""
    if memory is None:
        return None
    return map_nested(lambda m: m[0], memory) if temporal else memory


def concat_memory(memory_a, memory_b, dim: int = -2):
    """Two same-structure memories concatenated along ``dim``."""
    if memory_a is None:
        return memory_b
    if memory_b is None:
        return memory_a
    if isinstance(memory_a, dict):
        return {key: concat_memory(memory_a[key], memory_b[key], dim) for key in memory_a}
    return torch.cat([memory_a, memory_b], dim=dim)

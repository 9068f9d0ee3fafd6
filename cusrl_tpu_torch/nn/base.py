"""Memory helpers and the module contracts of the backbones (counterpart of
``reset_memory``, ``storable_memory`` and the counterfactual-append contract
of ``cusrl_tpu/nn/base.py``).

Forward convention for backbone modules::

    output, new_memory, aux = module(x, memory, sequential=False, done=None)

``memory`` is None for feedforward modules and a nested dict of tensors for
recurrent ones.  Rank-0 leaves are GLOBAL state shared by all environments
(the ring cache's write cursor): resets keep them, and a transition stores
them broadcast to ``[N]``.
"""

from __future__ import annotations

from typing import Any

import torch

from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["BackboneContract", "Memory", "reset_memory", "storable_memory"]

Memory = Any  # None | tensor | nested dict of tensors


def reset_memory(memory: Memory, done: torch.Tensor) -> Memory:
    """Zeroes the entries of environments where ``done`` (``[N, 1]`` or
    ``[N]``) is set; rank-0 leaves survive untouched."""
    if memory is None:
        return None

    def _reset(leaf):
        if leaf.dim() == 0:
            return leaf
        mask = done.reshape(done.shape[:1] + (1,) * (leaf.dim() - 1))
        return torch.where(mask, torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf)

    return map_nested(_reset, memory)


def storable_memory(memory: Memory, batch_size: int) -> Memory:
    """The memory as a transition stores it: rank-0 leaves broadcast to
    ``[batch_size]``; the owners read them back with ``reshape(-1)[0]``."""
    if memory is None:
        return None
    return map_nested(lambda leaf: leaf.expand(batch_size) if leaf.dim() == 0 else leaf, memory)


class BackboneContract:
    """Defaults of the memory and counterfactual-append contracts for a
    feedforward backbone (``nn/base.py:105-147``): no memory, and
    ``eval_next_token(y, ctx)`` is just the module on ``y``.  Recurrent
    modules override all of it."""

    is_recurrent = False

    def init_memory(self, batch_size: int) -> Memory:
        return None

    @property
    def supports_next_token_eval(self) -> bool:
        return not self.is_recurrent

    def sequential_with_ctx(self, x, memory: Memory, done):
        out, new_memory, _ = self(x, memory, sequential=True, done=done)
        return out, new_memory, None

    def eval_next_token(self, y, ctx):
        if self.is_recurrent:
            raise NotImplementedError(f"{type(self).__name__} does not implement next-token evaluation")
        out, _, _ = self(y)
        return out

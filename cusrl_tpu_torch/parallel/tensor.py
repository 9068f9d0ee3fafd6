"""Megatron-style tensor parallelism over a model process group (the
counterpart of what XLA inserts for the JAX package's ``model`` axis).

A sharded parameter is held, not masked: ``parallel.distribute_agent``
narrows each parameter that its module's ``tp_specs`` shards to this rank's
slice, in place, and attaches a ``TensorShard`` (``tp_shard``: the sharded
dimension, the model group, this rank's index in it and the full shape).  An
optimizer built on the parameters then holds sharded moments.  Whole
parameters carry none.

Four autograd Functions move activations across the model group; each
backward is written with the others, so a second derivative (AMP's gradient
penalty through a sharded discriminator) differentiates through them:

* ``copy_in``: identity forward, all-reduce backward (before a column layer);
* ``reduce_out``: all-reduce forward, identity backward (after a row layer's
  partial product);
* ``gather_out``: all-gather of the last dimension forward, this rank's slice
  backward (after a column layer that no row layer follows);
* ``split_in``: this rank's slice of the last dimension forward, all-gather
  backward (``gather_out``'s backward).

Each collective is counted under the ``model`` axis of
``utils.distributed.COLLECTIVES_BY_AXIS``.  A bf16 activation or gradient
crosses the group as fp32: an all-reduce then rounds once, after the sum,
and gloo, which runs the CPU tests and two ranks on one card, takes it.  ``parallel_chain`` runs a chain
of layers, each whole, column-parallel (output dimension sharded) or
row-parallel (input dimension sharded), with these Functions between them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from cusrl_tpu_torch.utils import distributed

__all__ = [
    "TensorShard",
    "copy_in",
    "gather_out",
    "logical_shape",
    "parallel_chain",
    "reduce_out",
    "shard_of",
    "shard_parameter",
    "split_in",
]

AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class TensorShard:
    """A tensor's Megatron sharding: ``dim`` split in ``world`` equal parts
    over the model ``group``, this rank holding part ``rank`` of
    ``full_shape``."""

    dim: int
    group: Any
    rank: int
    world: int
    full_shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return self.full_shape[self.dim] // self.world

    def take(self, full):
        """This rank's part of a full tensor or array."""
        index = [slice(None)] * len(self.full_shape)
        index[self.dim] = slice(self.rank * self.size, (self.rank + 1) * self.size)
        return full[tuple(index)]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's part (a collective of the model
        group)."""
        return _gather(local.detach(), self.group, self.dim)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = distributed.gather(x.float() if x.dtype == torch.bfloat16 else x, group, AXIS)
    return torch.cat(list(parts.unbind(0)), dim=dim).to(x.dtype)


def shard_of(tensor) -> TensorShard | None:
    return getattr(tensor, "tp_shard", None)


def logical_shape(tensor) -> tuple[int, ...]:
    """The shape of the whole tensor a shard is part of."""
    shard = shard_of(tensor)
    return tuple(tensor.shape) if shard is None else shard.full_shape


@torch.no_grad()
def shard_parameter(parameter: torch.nn.Parameter, dim: int, group) -> TensorShard:
    """Narrows ``parameter`` to this rank's part of ``dim``, in place (the
    ``Parameter`` object stays, so an optimizer built on it keeps it)."""
    shard = TensorShard(dim, group, dist.get_rank(group), dist.get_world_size(group), tuple(parameter.shape))
    parameter.data = shard.take(parameter.data).contiguous()
    parameter.tp_shard = shard
    return shard


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_out(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return distributed._all_reduce(x.float().contiguous().clone(), group, AXIS).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return copy_in(grad, ctx.group), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return split_in(grad, ctx.group), None


class _SplitIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size = x.shape[-1] // dist.get_world_size(group)
        return x.narrow(-1, dist.get_rank(group) * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_out(grad, ctx.group), None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceOut.apply(x, group)


def gather_out(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherOut.apply(x, group)


def split_in(x: torch.Tensor, group) -> torch.Tensor:
    return _SplitIn.apply(x, group)


def parallel_chain(x: torch.Tensor, shards: Sequence[TensorShard | None],
                   product: Callable[[torch.Tensor, int], torch.Tensor],
                   finish: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """``x`` through layers ``0 .. len(shards) - 1``: ``product(x, i)`` is
    layer ``i``'s product without its bias, ``finish(y, i)`` adds the bias,
    casts and activates.  ``shards[i]`` is the weight's ``TensorShard``
    (None: whole).  A column layer (dim 0) takes ``copy_in`` of its
    replicated input and leaves its output sharded for the row layer (dim 1)
    after it, or gathers it (``gather_out``) where none follows; a row
    layer's partial product goes through ``reduce_out`` before its
    replicated bias.  Whole layers run as they are: a pair left whole by the
    replicated fallback moves nothing."""
    count = len(shards)
    for index, shard in enumerate(shards):
        column = shard is not None and shard.dim == 0
        if column:
            x = copy_in(x, shard.group)
        y = product(x, index)
        if shard is not None and shard.dim == 1:
            y = reduce_out(y, shard.group)
        x = finish(y, index)
        following = shards[index + 1] if index + 1 < count else None
        if column and (following is None or following.dim != 1):
            x = gather_out(x, shard.group)
    return x


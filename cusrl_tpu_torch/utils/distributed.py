"""Multi-process helpers (counterpart of ``cusrl_tpu/utils/distributed.py``).

The ten host helpers (``enabled`` ... ``gather_print``) coordinate processes:
metric averaging, rank-0 printing and logging, object broadcast for the run
directory's name.  Each is a no-op at world size 1 (no process group, or a
group of one), as in the JAX package.

The device collectives below them serve a data-parallel agent
(``parallel.distribute_agent``), whose ``process_group`` they take.  In the
JAX package XLA inserts these inside the jitted update over a batch sharded
on the mesh; here the agent calls them where its gradients and statistics
must become global: ``reduce_gradients`` (one flat all-reduce of every
gradient, each rank weighted by its share of the minibatch's rows),
``weighted_sum`` (means over rows), ``merge_moments`` (running statistics,
Chan's merge of every rank's ``(mean, var, count)`` in rank order) and
``gather`` (the rollout's batch keys), and ``mean_term`` for a loss that is
not a plain mean over the rank's rows (a subsample drawn over the global
minibatch, a masked mean).  Unlike the host helpers they run
whenever the agent holds a group, a group of one included: there each is the
identity, bit for bit.  Gloo moves CUDA tensors through the host and gathers
none, so on gloo a CUDA gather is a sum of zero-padded parts.
``COLLECTIVES`` counts each collective's calls and bytes, and
``COLLECTIVES_BY_AXIS`` the same by the mesh axis whose group it ran over
(``data`` by default; ``model`` for the tensor-parallel operators of
``parallel/tensor.py``; ``ici`` and ``dcn`` for the two levels of a
hierarchical mesh's gradient reduce).
"""

from __future__ import annotations

import builtins
from typing import Any, TypeVar

import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "COLLECTIVES_BY_AXIS",
    "average_dict",
    "barrier",
    "broadcast_obj",
    "enabled",
    "gather",
    "gather_obj",
    "gather_print",
    "is_main_process",
    "mean_term",
    "merge_moments",
    "print_rank0",
    "rank",
    "reduce_gradients",
    "reset_collective_counts",
    "weighted_sum",
    "world_size",
]

_T = TypeVar("_T")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def enabled() -> bool:
    return _initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if enabled():
        dist.barrier()


def gather_obj(obj: _T) -> list[_T]:
    """Every process's picklable ``obj``, in rank order."""
    if not enabled():
        return [obj]
    gathered: list[Any] = [None] * world_size()
    dist.all_gather_object(gathered, obj)
    return gathered


def broadcast_obj(obj: _T) -> _T:
    """Process 0's picklable ``obj`` on every process."""
    if not enabled():
        return obj
    holder = [obj]
    dist.broadcast_object_list(holder, src=0)
    return holder[0]


def average_dict(info: dict[str, float]) -> dict[str, float]:
    """Averages a metric dict across processes: each key over the processes
    that hold it.  The dicts are gathered, not all-reduced as one stacked
    tensor: a key can be missing on some ranks (the episode statistics appear
    on a rank once one of its episodes has finished), and an all-reduce of
    tensors of unequal lengths fails or hangs."""
    if not enabled():
        return dict(info)
    gathered = gather_obj({key: float(value) for key, value in info.items()})
    keys = sorted({key for part in gathered for key in part})
    return {key: sum(values) / len(values)
            for key in keys for values in [[part[key] for part in gathered if key in part]]}


def print_rank0(*args: Any, **kwargs: Any) -> None:
    if is_main_process():
        builtins.print(*args, **kwargs)


def gather_print(*args: Any, **kwargs: Any) -> None:
    """Prints from every process, prefixed and ordered by rank."""
    if not enabled():
        builtins.print(*args, **kwargs)
        return
    for index in range(world_size()):
        if index == rank():
            builtins.print(f"[rank {index}]", *args, **kwargs)
        barrier()


# -- device collectives of a data-parallel agent -------------------------------

COLLECTIVES: dict[str, list[int]] = {"all_reduce": [0, 0], "all_gather": [0, 0]}
COLLECTIVES_BY_AXIS: dict[str, dict[str, list[int]]] = {}


def reset_collective_counts() -> None:
    for entry in COLLECTIVES.values():
        entry[0] = entry[1] = 0
    COLLECTIVES_BY_AXIS.clear()


def _count(kind: str, tensor: torch.Tensor, parts: int = 1, axis: str = "data") -> None:
    """One collective of ``kind`` over ``axis`` moving ``parts`` copies of ``tensor``."""
    size = parts * tensor.numel() * tensor.element_size()
    for entry in (COLLECTIVES[kind], COLLECTIVES_BY_AXIS.setdefault(axis, {}).setdefault(kind, [0, 0])):
        entry[0] += 1
        entry[1] += size


def _all_reduce(tensor: torch.Tensor, group, axis: str = "data") -> torch.Tensor:
    _count("all_reduce", tensor, axis=axis)
    dist.all_reduce(tensor, group=group)
    return tensor


def gather(tensor: torch.Tensor, group, axis: str = "data") -> torch.Tensor:
    """``[W, *tensor.shape]``: every rank's ``tensor`` in rank order."""
    world = dist.get_world_size(group)
    source = tensor.contiguous()
    if source.dtype == torch.bool:
        return gather(source.view(torch.uint8), group, axis).view(torch.bool)
    if source.is_cuda and dist.get_backend(group) == "gloo":
        out = source.new_zeros(world, *source.shape)
        out[dist.get_rank(group)] = source
        return _all_reduce(out, group, axis)
    _count("all_gather", source, world, axis)
    if dist.get_backend(group) == "gloo":
        parts = [torch.empty_like(source) for _ in range(world)]
        dist.all_gather(parts, source, group=group)
        return torch.stack(parts)
    out = source.new_empty(world, *source.shape)
    dist.all_gather_into_tensor(out, source, group=group)
    return out


def weighted_sum(tensor: torch.Tensor, weight: float, group) -> torch.Tensor:
    """``sum over ranks of weight_r * tensor_r`` (a new tensor): with each
    rank's share of the rows as ``weight``, the global mean of per-rank means."""
    return _all_reduce(tensor * weight, group)


def mean_term(local_sum: torch.Tensor, global_count, row_share: float) -> torch.Tensor:
    """This rank's term of the global mean ``sum over ranks of local_sum_r /
    global_count``.  The update weights every rank's losses (through the
    gradients) and metrics by its ``row_share`` and sums them, so the term is
    ``local_sum / (global_count * row_share)``."""
    return local_sum / (global_count * row_share)


@torch.no_grad()
def reduce_gradients(parameters, weight: float, group) -> None:
    """Replaces every ``.grad`` by ``sum over ranks of weight_r * grad_r``,
    one all-reduce of one flat buffer per dtype.  ``group`` is a process
    group, or a mapping ``{axis: group}`` of levels reduced in turn (a
    hierarchical mesh's ``ici`` then ``dcn``: every rank ends with the same
    bits)."""
    levels = group if isinstance(group, dict) else {"data": group}
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in parameters:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat.mul_(weight)
        for axis, level in levels.items():
            _all_reduce(flat, level, axis)
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(parts, grads)])


@torch.no_grad()
def merge_moments(mean: torch.Tensor, var: torch.Tensor, count: torch.Tensor, group):
    """Every rank's per-channel ``(mean [C], var [C], count [])`` merged in rank
    order (Chan's merge, as the running statistics fold a batch): the
    statistics of all ranks' rows together, the same bits on every rank."""
    from cusrl_tpu_torch.nn.utils.normalization import merge_mean_var

    channels = mean.shape[0]
    stacked = gather(torch.cat([mean.float(), var.float(), count.float().reshape(1)]), group)
    mean, var, count = stacked[0, :channels], stacked[0, channels:-1], stacked[0, -1]
    for part in stacked[1:]:
        mean, var, count = merge_mean_var(mean, var, count, part[:channels], part[channels:-1], part[-1])
    return mean, var, count

"""Data-parallel placement (counterpart of the data-parallel half of
``cusrl_tpu/parallel/sharding.py``).

The JAX package places the agent's state on a ``(data, model)`` device mesh
and lets XLA insert the collectives.  Here a "mesh" is a process group (one
device per process): ``get_mesh`` is the default group, ``replicate``
broadcasts rank 0's tensors, ``shard_batch`` keeps the process's own part of
a batch, and ``distribute_agent`` broadcasts rank 0's agent state and marks
the agent distributed, after which its updates are global
(``parallel.multiprocess``).  The tensor-parallel half (``collect_tp_specs``,
``distribute_agent(tensor_parallel=True)``) and the hierarchical ``dcn``
mesh are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from cusrl_tpu_torch.parallel.multiprocess import broadcast_agent_state, check_data_parallel_route, process_mesh
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["data_axes", "distribute_agent", "get_mesh", "replicate", "shard_batch"]


def get_mesh(model_parallel_size: int = 1):
    """The default process group (data parallelism only)."""
    if model_parallel_size != 1:
        raise NotImplementedError("tensor parallelism is not ported yet (ROADMAP.md, Queue 1 item 2b)")
    return process_mesh()


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes: the one data axis of a process group."""
    return ("data",)


@torch.no_grad()
def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor leaf of ``tree`` replaced, in place, by rank 0's."""
    group = mesh or process_mesh()
    source = dist.get_global_rank(group, 0)

    def broadcast(leaf):
        dist.broadcast(leaf, source, group=group)
        return leaf

    return map_nested(broadcast, tree)


def shard_batch(tree: Any, mesh=None, axis: int = 0) -> Any:
    """This process's part of every tensor leaf along ``axis`` (equal parts,
    the first ranks one more where the length does not divide)."""
    group = mesh or process_mesh()
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    return map_nested(lambda leaf: torch.tensor_split(leaf, world, dim=axis)[rank], tree)


def distribute_agent(agent, mesh=None, tensor_parallel: bool = False):
    """Broadcasts rank 0's agent state to every process and marks the agent
    distributed (its ``process_group``): from then on its rollout statistics
    and updates are global.  Returns the group."""
    check_data_parallel_route(agent, tensor_parallel)
    group = mesh or process_mesh()
    agent.process_group = group
    broadcast_agent_state(agent, group)
    return group

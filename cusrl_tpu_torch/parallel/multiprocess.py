"""Cross-process data-parallel training (counterpart of
``cusrl_tpu/parallel/multiprocess.py``).

PyTorch's idiom: one process per device (``torchrun``), the default process
group joined by ``utils.config.configure_distributed``.  Parameters are
replicated over the data axes, each data rank collects rollouts from its own
environments, and one update runs over the concatenation of every data
rank's rollout: the agent's ``update_body`` under its ``process_group``
(``template/actor_critic.py`` says how), which is what the JAX package's
global jitted step computes.  On a mesh with a model axis
(``parallel.get_mesh``) the process group is the data group; model peers
hold the same rows and, under tensor parallelism, each its part of every
sharded parameter (``parallel/tensor.py``).

Usage per process (after ``configure_distributed()``)::

    agent = factory(env_spec)              # the same architecture on every rank
    broadcast_agent_state(agent)           # rank 0's state everywhere
    ...collect a [T, N_local] rollout...
    metrics = cross_process_update(agent, rollout)  # one global update

Every process ends each update holding the same parameters (the same part
of each sharded one among data peers), optimizer state and hook state, bit
for bit (except the per-environment state: memories and episode flags stay
the data rank's own), so checkpoints stay rank-0-only (a sharded leaf is
gathered to its full shape) and resume from any rank's view.  Every route
the port trains on one process runs so: the mini-batch, temporal and random
samplers, hook-owned networks and every hook; ``cross_process_update(agent)``
without a rollout, and the host loop's ``agent.update()``, take the agent's
``Buffer``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cusrl_tpu_torch.parallel.tensor import shard_of
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.interop import state_entries
from cusrl_tpu_torch.utils.nest import get_schema, iterate_nested, reconstruct_nested

__all__ = [
    "broadcast_agent_state",
    "check_data_parallel_route",
    "cross_process_update",
    "data_group",
    "globalize_rollout",
    "is_sharded",
    "process_mesh",
]


def process_mesh():
    """The default process group: every process of the run, one device each
    (the JAX package's 1-D ``data`` mesh)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call utils.config.configure_distributed() first")
    return dist.group.WORLD


def data_group(mesh):
    """The batch axis of ``mesh``: a ``ProcessMesh``'s data group, or the
    process group itself."""
    return getattr(mesh, "data", mesh)


def check_data_parallel_route(agent, tensor_parallel: bool = False) -> None:
    """Every route the port trains on one process runs data-parallel, and
    tensor-parallel on a mesh with a model axis: nothing raises.  Kept for
    the callers that check a configuration before distributing it."""


@torch.no_grad()
def broadcast_agent_state(agent, group=None) -> None:
    """Replicates rank 0's agent state to every process of ``group`` (a
    mesh: all of its processes; by default the agent's mesh, else its
    process group): every leaf of the checkpoint's map (parameters,
    optimizer state, every hook's state tensors, learning rates, the
    iteration; a sharded leaf goes as its full array and each rank writes
    its part), the sampler's plan generator and the hooks' generators (AMP's
    expert rows and subsamples are drawn over the global batch, the same on
    every rank).  The action noise generator stays the rank's own
    (``distribute_agent`` gives model peers one)."""
    group = group or getattr(agent, "mesh", None) or agent.process_group or process_mesh()
    group = getattr(group, "world", group)
    main = dist.get_rank(group) == 0
    if main and agent.plan_generator is None:
        agent.plan_generator = torch.Generator(device=agent.device).manual_seed(agent.init_generator.initial_seed() + 2)
    if dist.get_world_size(group) == 1:
        return
    entries = state_entries(agent)
    hooks = {name: g for name, g in agent._generators().items() if name.startswith("hooks.")}
    # Reading a sharded leaf gathers it over its model group: every rank reads.
    state = {path: entry.read() for path, entry in entries.items()} if main or is_sharded(agent) else None
    payload = [{"state": state,
                "plan": agent.plan_generator.get_state().numpy(),
                "hooks": {name: g.get_state().numpy() for name, g in hooks.items()}} if main else None]
    dist.broadcast_object_list(payload, src=dist.get_global_rank(group, 0), group=group)
    # Rank 0 too writes what it sent: a host learning rate goes out as float32
    # and must hold the same bits everywhere.
    for path, entry in entries.items():
        entry.write(path, payload[0]["state"][path])
    if not main:
        agent.plan_generator = torch.Generator(device=agent.device)
        agent.plan_generator.set_state(torch.from_numpy(np.array(payload[0]["plan"], dtype=np.uint8)))
        for name, generator in hooks.items():
            generator.set_state(torch.from_numpy(np.array(payload[0]["hooks"][name], dtype=np.uint8)))


def is_sharded(agent) -> bool:
    """Whether any parameter of the agent is a tensor-parallel shard."""
    return any(shard_of(p) is not None for p in agent.model.parameters())


def globalize_rollout(rollout: dict, group, env_axis: int = 1) -> dict:
    """Every data rank's rollout fields concatenated on the environment axis
    (``group``: a process group, or a mesh's data group), in rank order:
    one gather per dtype and lead shape, of the fields flattened side by
    side.  The fields are ``[T, N_local, ...]``, the
    memories ``[1, N_local, ...]`` (as of the rollout's first step) or
    ``[T, N_local, ...]`` (per step): the port's memories hold the
    environments first (the recurrent modules' ``[N, layers, H]``, the
    attention cache's ``[N, heads, slots, D]``, and ``storable_memory``
    broadcasts a 0-d leaf, the cache's cursor, to ``[N]``), so every leaf
    has them on ``env_axis``.  A leaf whose ``env_axis`` is not the
    rollout's environment count raises."""
    group = data_group(group)
    schema = get_schema(rollout)
    leaves = dict(iterate_nested(rollout))
    counts = {path: leaf.shape[env_axis] if leaf.dim() > env_axis else None for path, leaf in leaves.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(f"the rollout's fields disagree on their environments (axis {env_axis}): {counts}")
    groups: dict[tuple, list[str]] = {}
    for path in sorted(leaves):  # the same order on every rank, whatever the dict's
        leaf = leaves[path]
        groups.setdefault((str(leaf.dtype), tuple(leaf.shape[:env_axis])), []).append(path)
    world = dist.get_world_size(group)
    result = {}
    for _, paths in sorted(groups.items()):
        lead = leaves[paths[0]].shape[: env_axis + 1]
        widths = [leaves[p][(0,) * (env_axis + 1)].numel() for p in paths]
        flat = torch.cat([leaves[p].reshape(*lead, w) for p, w in zip(paths, widths)], dim=-1)
        gathered = distributed.gather(flat, group)  # [W, T, N, F]
        gathered = gathered.movedim(0, env_axis).reshape(*lead[:env_axis], world * lead[env_axis], -1)
        for p, part in zip(paths, gathered.split(widths, dim=-1)):
            result[p] = part.reshape(*part.shape[: env_axis + 1], *leaves[p].shape[env_axis + 1:])
    return reconstruct_nested(result, schema)


def cross_process_update(agent, rollout: dict | None = None, epoch_perms=None, group=None) -> dict[str, float]:
    """One update over the concatenation of every data rank's ``[T, N_local,
    ...]`` rollout (by default the agent's buffer, with its ``buffer_state``
    and the memories as of its first step, as ``agent.update()`` takes
    them); returns the metrics on the host.  The plan comes from
    ``epoch_perms`` or the agent's ``plan_generator``
    (``broadcast_agent_state``), the same on every rank, not from the
    rank-offset action noise stream.  ``group`` (a process group or a mesh:
    its data group) defaults to the agent's."""
    previous = agent.process_group
    agent.process_group = data_group(group) if group is not None else previous or process_mesh()
    try:
        buffer_state = None
        if rollout is None:
            rollout, buffer_state = agent.take_buffered_rollout()
        metrics = agent.update_body(rollout, epoch_perms=epoch_perms, buffer_state=buffer_state)
    finally:
        agent.process_group = previous
    agent.apply_schedules(agent.iteration)
    keys = sorted(metrics)
    values = torch.stack([torch.as_tensor(metrics[k], device=agent.device).float().reshape(()) for k in keys])
    return dict(zip(keys, values.tolist()))

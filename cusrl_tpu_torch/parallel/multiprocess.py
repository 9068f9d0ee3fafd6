"""Cross-process data-parallel training (counterpart of
``cusrl_tpu/parallel/multiprocess.py``).

PyTorch's idiom: one process per device (``torchrun``), the default process
group joined by ``utils.config.configure_distributed``.  Parameters are
replicated, each process collects rollouts from its own environments, and
one update runs over the concatenation of every process's rollout: the
agent's ``update_body`` under its ``process_group`` (``template/
actor_critic.py`` says how), which is what the JAX package's global jitted
step computes.

Usage per process (after ``configure_distributed()``)::

    agent = factory(env_spec)              # the same architecture on every rank
    broadcast_agent_state(agent)           # rank 0's state everywhere
    ...collect a [T, N_local] rollout...
    metrics = cross_process_update(agent, rollout)  # one global update

Every process ends each update holding the same parameters, optimizer state
and hook state, bit for bit, so checkpoints stay rank-0-only and resume from
any rank's view.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cusrl_tpu_torch.sampler.mini_batch_sampler import MiniBatchSampler
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.interop import state_entries
from cusrl_tpu_torch.utils.nest import get_schema, iterate_nested, reconstruct_nested

__all__ = [
    "broadcast_agent_state",
    "check_data_parallel_route",
    "cross_process_update",
    "globalize_rollout",
    "process_mesh",
]


def process_mesh():
    """The default process group: every process of the run, one device each
    (the JAX package's 1-D ``data`` mesh)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call utils.config.configure_distributed() first")
    return dist.group.WORLD


def check_data_parallel_route(agent, sampler=None) -> None:
    """Raises ``NotImplementedError`` for a route this port does not run
    under more than one rank: recurrent and transformer actors (whose
    minibatches the temporal samplers draw), the random samplers,
    hook-owned networks (trained or frozen) and the hooks marked
    ``data_parallel = False`` (the symmetry, distillation and smoothness
    hooks)."""
    group = agent.process_group
    if group is None or dist.get_world_size(group) == 1:
        return
    where = "is not ported yet under data parallelism (ROADMAP.md, Queue 1 item 2a)"
    sampler = sampler or agent.sampler
    if getattr(agent.actor, "is_recurrent", False) or getattr(sampler, "temporal", False):
        raise NotImplementedError(f"a temporal sampler (a recurrent or transformer actor) {where}")
    if not isinstance(sampler, MiniBatchSampler):
        raise NotImplementedError(f"the random samplers ({type(sampler).__name__}) {where}")
    owners = [hook.hook_name for hook in agent.hooks if hook.owned_modules()]
    if owners:
        raise NotImplementedError(f"hook-owned networks ({', '.join(owners)}) {where}")
    single = [hook.hook_name for hook in agent.hooks if hook.active and not hook.data_parallel]
    if single:
        raise NotImplementedError(f"the hooks {', '.join(single)} {where}")


@torch.no_grad()
def broadcast_agent_state(agent, group=None) -> None:
    """Replicates rank 0's agent state to every process: every leaf of the
    checkpoint's map (parameters, optimizer state, every hook's state
    tensors, learning rates, the iteration) and the sampler's plan
    generator.  The action noise generator stays the rank's own."""
    group = group or agent.process_group or process_mesh()
    main = dist.get_rank(group) == 0
    if main and agent.plan_generator is None:
        agent.plan_generator = torch.Generator(device=agent.device).manual_seed(agent.init_generator.initial_seed() + 2)
    if dist.get_world_size(group) == 1:
        return
    entries = state_entries(agent)
    payload = [{"state": {path: entry.read() for path, entry in entries.items()},
                "plan": agent.plan_generator.get_state().numpy()} if main else None]
    dist.broadcast_object_list(payload, src=dist.get_global_rank(group, 0), group=group)
    if not main:
        for path, entry in entries.items():
            entry.write(path, payload[0]["state"][path])
        agent.plan_generator = torch.Generator(device=agent.device)
        agent.plan_generator.set_state(torch.from_numpy(np.array(payload[0]["plan"], dtype=np.uint8)))


def globalize_rollout(rollout: dict, group, env_axis: int = 1) -> dict:
    """Every process's ``[T, N_local, ...]`` rollout fields concatenated on
    the environment axis, in rank order: one gather per dtype of the
    fields flattened side by side."""
    schema = get_schema(rollout)
    leaves = dict(iterate_nested(rollout))
    by_dtype: dict[str, list[str]] = {}
    for path in sorted(leaves):  # the same order on every rank, whatever the dict's
        by_dtype.setdefault(str(leaves[path].dtype), []).append(path)
    world = dist.get_world_size(group)
    result = {}
    for _, paths in sorted(by_dtype.items()):
        lead = leaves[paths[0]].shape[: env_axis + 1]
        widths = [leaves[p][0, 0].numel() if leaves[p].dim() > env_axis + 1 else 1 for p in paths]
        flat = torch.cat([leaves[p].reshape(*lead, w) for p, w in zip(paths, widths)], dim=-1)
        gathered = distributed.gather(flat, group)  # [W, T, N, F]
        gathered = gathered.movedim(0, env_axis).reshape(*lead[:env_axis], world * lead[env_axis], -1)
        for p, part in zip(paths, gathered.split(widths, dim=-1)):
            result[p] = part.reshape(*part.shape[: env_axis + 1], *leaves[p].shape[env_axis + 1:])
    return reconstruct_nested(result, schema)


def cross_process_update(agent, rollout: dict | None = None, epoch_perms=None, group=None) -> dict[str, float]:
    """One update over the concatenation of every process's ``[T, N_local,
    ...]`` rollout (by default the agent's buffer, which only the host loop
    fills: not ported under more than one rank); returns the metrics on the
    host.  The plan comes from ``epoch_perms`` or the agent's
    ``plan_generator`` (``broadcast_agent_state``), the same on every rank,
    not from the rank-offset action noise stream."""
    previous = agent.process_group
    agent.process_group = group or previous or process_mesh()
    try:
        if rollout is None:
            if dist.get_world_size(agent.process_group) > 1:
                raise NotImplementedError("the host loop under data parallelism is not ported yet "
                                          "(ROADMAP.md, Queue 1 item 2a)")
            rollout = agent.buffer.data
            agent.step_index = 0
        metrics = agent.update_body(rollout, epoch_perms=epoch_perms)
    finally:
        agent.process_group = previous
    agent.apply_schedules(agent.iteration)
    keys = sorted(metrics)
    values = torch.stack([torch.as_tensor(metrics[k], device=agent.device).float().reshape(()) for k in keys])
    return dict(zip(keys, values.tolist()))

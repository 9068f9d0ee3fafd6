"""Device-resident rollout driver (counterpart of
``cusrl_tpu/template/rollout.py``'s ``ScanRolloutDriver``).

The JAX driver fuses the rollout and the update into one ``lax.scan``
program.  Here the rollout is a Python loop over device tensors:
``pre_act -> actor.explore -> post_act -> env.step -> post_step`` per step,
plus the same per-step transition fields and episode aggregates; the
transitions stack into the ``[T, N, ...]`` rollout the update consumes.  There
is no packing: the agent's state is always readable.  Memories (a recurrent
actor's, a recurrent critic's) are recorded once, as of the rollout's first
step, as ``[1, N, ...]`` entries: sequence-mode passes replay the rollout from
them, and the per-step ring snapshots (about 214 MB per network at the
transformer entry's shapes) are never stored.  Only a sampler with
``requires_per_step_memory`` (windows from any step) gets the per-step
``[T, N, ...]`` stacks of the memories entering each step, which the
transitions then carry, as the JAX driver keeps them.  The actor's memory
stays on the agent from rollout to rollout.  Under a data-parallel agent each
rank's driver steps its own environments (the JAX driver shards them over
the mesh) and the episode aggregates are averaged across ranks on the
device: one all-reduce a rollout, no host transfer.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.environment import TensorEnvironment
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.nest import map_nested, stack_nested

__all__ = ["RolloutDriver"]


class RolloutDriver:
    def __init__(self, agent, environment: TensorEnvironment):
        if environment.num_instances != agent.parallelism:
            raise ValueError("environment and agent disagree on the number of instances")
        self.agent = agent
        self.environment = environment
        self._env_state = None

    def _ensure_initialized(self) -> None:
        if self._env_state is not None:
            return
        agent, env = self.agent, self.environment
        self._env_state = env.init_fn(agent.generator)
        self._observation, self._obs_state = env.observe_fn(self._env_state)
        self._cum_reward = torch.zeros(env.num_instances, device=agent.device)
        self._cum_length = torch.zeros(env.num_instances, dtype=torch.int32, device=agent.device)

    @torch.no_grad()
    def collect(self, num_steps: int):
        """One rollout; returns ``(rollout of [T, N, ...] tensors, aggregates
        [3] = (finished episodes, their return sum, their length sum))``."""
        self._ensure_initialized()
        agent, env = self.agent, self.environment
        initial_memories = agent.rollout_memory_entries()
        transitions = []
        episodes = torch.zeros((), device=agent.device)
        return_sum = torch.zeros((), device=agent.device)
        length_sum = torch.zeros((), device=agent.device)
        for _ in range(num_steps):
            transition = agent.act_body(self._observation, state=self._obs_state)
            self._env_state, reward, terminated, truncated, info = env.step_fn(
                self._env_state, transition["action"], agent.generator
            )
            next_observation, next_obs_state = env.observe_fn(self._env_state)
            transition["next_observation"] = next_observation
            if next_obs_state is not None:
                transition["next_state"] = next_obs_state
            transition.update(reward=reward, terminated=terminated, truncated=truncated, **(info or {}))
            transition = agent.step_body(transition)

            done = transition["done"].reshape(-1)
            self._cum_reward += reward.sum(-1)
            self._cum_length += 1
            episodes += done.sum()
            return_sum += torch.where(done, self._cum_reward, 0.0).sum()
            length_sum += torch.where(done, self._cum_length.float(), 0.0).sum()
            self._cum_reward = torch.where(done, 0.0, self._cum_reward)
            self._cum_length = torch.where(done, 0, self._cum_length).to(torch.int32)

            transitions.append(transition)
            self._observation, self._obs_state = next_observation, next_obs_state
        rollout = stack_nested(transitions, torch.stack)
        rollout.update({key: map_nested(lambda x: x[None], value) for key, value in initial_memories.items()})
        aggregates = torch.stack([episodes, return_sum, length_sum])
        if agent.process_group is not None:
            group = agent.process_group
            aggregates = distributed.weighted_sum(aggregates, 1.0 / torch.distributed.get_world_size(group), group)
        return rollout, aggregates

    def collect_and_update(self, num_steps: int):
        """One training iteration (rollout + update); returns ``(aggregates
        [3], metrics dict of 0-d tensors)``, all on the device."""
        rollout, aggregates = self.collect(num_steps)
        metrics = self.agent.update_body(rollout)
        return aggregates, metrics

    def collect_and_update_many(self, num_steps: int, num_iters: int):
        """``num_iters`` training iterations of ``num_steps`` steps each;
        returns ``(aggregates [K, 3], metric values [K, M], metric keys: one
        tuple per iteration)``, all values on the device, for one transfer
        by the caller.  Row ``k`` holds iteration ``k``'s values in the order
        of its keys, zero-padded to ``M``, the most any iteration has: a
        schedule that switches a hook on or off changes the keys from one
        iteration to the next.  ``update_body`` advances
        ``agent.iteration``; the hook schedules are applied after each
        iteration, as the JAX driver's per-iteration branch does
        (``rollout.py:250-260``).  A schedule that changes the rollout's
        length (``OnPolicyBufferCapacitySchedule``) takes effect at the next
        call: every iteration of this one runs ``num_steps`` steps, as in the
        JAX driver.  The JAX driver's single-dispatch scan over iterations
        has no counterpart: CUDA launches are already queued asynchronously,
        so the host runs ahead of the device until the caller's transfer."""
        aggregates, rows, keys = [], [], []
        for _ in range(num_iters):
            aggs, metrics = self.collect_and_update(num_steps)
            keys.append(tuple(sorted(metrics)))
            aggregates.append(aggs)
            rows.append(torch.stack([torch.as_tensor(metrics[k], device=self.agent.device).float().reshape(())
                                     for k in keys[-1]]))
            self.agent.apply_schedules(self.agent.iteration)
        width = max(len(row) for row in rows)
        stacked = torch.stack([torch.nn.functional.pad(row, (0, width - len(row))) for row in rows])
        return torch.stack(aggregates), stacked, keys

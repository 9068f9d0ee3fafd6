"""Random samplers (counterpart of ``cusrl_tpu/sampler/random_sampler.py``).

``RandomSampler`` draws ``num_batches`` batches of ``batch_size`` independent
transitions, uniformly over the flattened ``[T*N]`` rollout;
``TemporalRandomSampler`` draws ``num_batches`` batches of ``batch_size``
random ``(environment, start)`` windows of ``sequence_len`` steps (the whole
rollout when None) and gathers ``[L, B, ...]`` minibatches.  Its windows start
anywhere in the rollout, so it sets ``requires_per_step_memory``: the rollout
then keeps the ``[T, N, ...]`` stacks of the memories entering each step, and
the consumers read a window's first row.  ``AutoRandomSampler`` is temporal
iff the rollout carries memory.

The update runs the plan as one pass of ``num_batches`` minibatches, with the
JAX plan's metadata (``total_batches``, ``temporal``, ``batch_index``).
Indices are drawn from the agent's generator on its device, or injected
(``plan``: the ``[K, B]`` indices, or the ``([K, L, B] time, [K, B]
environment)`` indices), so a test can hand in the JAX sampler's plan.

``buffer_state = {"cursor", "full"}`` (the agent's ``Buffer``, host values)
bounds the draws to the valid steps, ``capacity`` once full, else
``cursor`` (``random_sampler.py:29-37,59-83``): ``RandomSampler`` draws over
the first ``valid * N`` rows of the flattened rollout; the temporal windows
start in logical time over the valid extent, and on a wrapped ring step
``t`` of a window lies at ``(cursor + t) % capacity``, the oldest step at the
cursor.  Without it the plans cover the whole rollout.

Under a data-parallel agent the indices are drawn over the global rollout
(every rank's environments, in rank order) from a generator that is the same
on every rank, and each rank gathers its slice of each batch's draws
(``gather``'s ``rows``, the mini-batch samplers' ``shard_rows``).
"""

from __future__ import annotations

import dataclasses

import torch

from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["AutoRandomSampler", "RandomPlan", "RandomSampler", "TemporalRandomSampler"]


@dataclasses.dataclass
class RandomPlan:
    num_mini_batches: int
    indices: object  # [K, B] rows, or ([K, L, B] time, [K, B] environment) indices

    epoch_start = 0  # one pass of num_mini_batches minibatches
    num_epochs = 1

    @property
    def batch_size(self) -> int:
        """Draws per batch (rows, or windows when temporal)."""
        return (self.indices[1] if isinstance(self.indices, tuple) else self.indices).shape[-1]


def _valid_steps(capacity: int, buffer_state) -> int | None:
    """The number of valid steps: the capacity once full, else the cursor
    (None: the whole rollout)."""
    if buffer_state is None:
        return None
    return capacity if bool(buffer_state["full"]) else int(buffer_state["cursor"])


def _has_memory(rollout: dict) -> bool:
    return any(key.split(".")[0].endswith("memory") for key in rollout)


class _RandomBase:
    num_epochs = 1  # the plan is one pass of num_batches minibatches

    def resolve(self, rollout: dict):
        return self

    def metadata(self, plan: RandomPlan, epoch: int, mini_batch: int) -> dict:
        return {"total_batches": plan.num_mini_batches, "temporal": self.temporal, "batch_index": mini_batch}


@dataclasses.dataclass
class RandomSampler(_RandomBase):
    num_batches: int = 1
    batch_size: int = 256

    temporal = False

    def make_epoch_plan(self, capacity: int, parallelism: int, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu", plan=None, buffer_state=None) -> RandomPlan:
        valid = _valid_steps(capacity, buffer_state)
        if plan is None:
            total = (capacity if valid is None else valid) * parallelism
            plan = torch.randint(0, total, (self.num_batches, self.batch_size), generator=generator, device=device)
        indices = torch.as_tensor(plan, dtype=torch.int64, device=device)
        if indices.shape != (self.num_batches, self.batch_size):
            raise ValueError(f"plan must be [{self.num_batches}, {self.batch_size}]; got {tuple(indices.shape)}")
        return RandomPlan(self.num_batches, indices)

    def source(self, rollout: dict) -> dict:
        """The rollout flattened to ``[T*N, ...]``.  A memory entry (a
        recurrent rollout's ``[1, N, ...]``) cannot follow single
        transitions: such rollouts take ``TemporalRandomSampler``."""
        if _has_memory(rollout):
            raise ValueError("RandomSampler draws single transitions; a rollout with recurrent memory needs "
                             "TemporalRandomSampler (or AutoRandomSampler)")
        return {key: map_nested(lambda x: x.reshape(-1, *x.shape[2:]), value) for key, value in rollout.items()}

    def gather(self, source: dict, plan: RandomPlan, epoch: int, mini_batch: int,
               rows: tuple[int, int] | None = None) -> dict:
        idx = plan.indices[mini_batch]
        if rows is not None:
            idx = idx[rows[0]:rows[1]]
        return map_nested(lambda x: x[idx], source)


@dataclasses.dataclass
class TemporalRandomSampler(_RandomBase):
    num_batches: int = 1
    batch_size: int = 64
    sequence_len: int | None = None

    temporal = True
    requires_per_step_memory = True

    def make_epoch_plan(self, capacity: int, parallelism: int, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu", plan=None, buffer_state=None) -> RandomPlan:
        length = capacity if self.sequence_len is None else min(self.sequence_len, capacity)
        shape = (self.num_batches, self.batch_size)
        if plan is None:
            valid = _valid_steps(capacity, buffer_state)
            num_starts = capacity - length + 1 if valid is None else max(valid - length + 1, 1)
            env_indices = torch.randint(0, parallelism, shape, generator=generator, device=device)
            starts = torch.randint(0, num_starts, shape, generator=generator, device=device)
            time_indices = starts[:, None, :] + torch.arange(length, device=device)[None, :, None]  # [K, L, B]
            if valid is not None and bool(buffer_state["full"]):  # logical time -> ring position
                time_indices = (int(buffer_state["cursor"]) + time_indices) % capacity
        else:
            time_indices, env_indices = plan
        time_indices = torch.as_tensor(time_indices, dtype=torch.int64, device=device)
        env_indices = torch.as_tensor(env_indices, dtype=torch.int64, device=device)
        if time_indices.shape != (self.num_batches, length, self.batch_size) or env_indices.shape != shape:
            raise ValueError(f"plan must be ([{self.num_batches}, {length}, {self.batch_size}], "
                             f"[{self.num_batches}, {self.batch_size}]); got {tuple(time_indices.shape)}, "
                             f"{tuple(env_indices.shape)}")
        return RandomPlan(self.num_batches, (time_indices, env_indices))

    def source(self, rollout: dict) -> dict:
        return rollout

    def gather(self, source: dict, plan: RandomPlan, epoch: int, mini_batch: int,
               rows: tuple[int, int] | None = None) -> dict:
        time_indices, env_indices = plan.indices[0][mini_batch], plan.indices[1][mini_batch]  # [L, B], [B]
        if rows is not None:
            time_indices, env_indices = time_indices[:, rows[0]:rows[1]], env_indices[rows[0]:rows[1]]
        return map_nested(lambda x: x[time_indices, env_indices[None, :]], source)


@dataclasses.dataclass
class AutoRandomSampler:
    """``TemporalRandomSampler`` for a rollout that carries memory, else
    ``RandomSampler``."""

    num_batches: int = 1
    batch_size: int = 256
    sequence_len: int | None = None

    requires_per_step_memory = True  # it may resolve to TemporalRandomSampler

    def resolve(self, rollout: dict):
        if _has_memory(rollout):
            return TemporalRandomSampler(self.num_batches, self.batch_size, self.sequence_len)
        return RandomSampler(self.num_batches, self.batch_size)

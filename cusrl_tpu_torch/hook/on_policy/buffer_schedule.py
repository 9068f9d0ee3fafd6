"""Rollout-length schedule (counterpart of
``cusrl_tpu/hook/on_policy/buffer_schedule.py``).

After each update the schedule sets ``agent.num_steps_per_update`` and
resizes the host loop's buffer.  Under the Trainer's tensor driver a chunk of
iterations runs at the length it started with: the new length takes effect
at the next chunk, as in the JAX Trainer.
"""

from __future__ import annotations

from typing import Callable

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["OnPolicyBufferCapacitySchedule"]


class OnPolicyBufferCapacitySchedule(Hook):
    training_only = True

    def __init__(self, schedule: Callable[[int], int] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.schedule = schedule

    def schedule_is_noop(self, iteration: int) -> bool:
        return False

    def apply_schedule(self, iteration: int, agent=None) -> None:
        capacity = int(self.schedule(iteration))
        agent.num_steps_per_update = capacity
        agent.resize_buffer(capacity)

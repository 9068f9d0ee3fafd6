"""Hook parameter and activation schedules (counterpart of
``cusrl_tpu/hook/control/schedule.py``).

``HookParameterSchedule`` sets a field of another hook from an iteration
scheduler after each update (``Hook.update_attribute``: a device tensor takes
the value in place); ``HookActivationSchedule`` switches another hook on or
off.  Both run on the host, between updates.
"""

from __future__ import annotations

from typing import Any, Callable

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["HookActivationSchedule", "HookParameterSchedule"]


class HookParameterSchedule(Hook):
    training_only = True

    def __init__(self, target_hook: str | None = None, parameter: str | None = None,
                 scheduler: Callable[[int], Any] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.target_hook = target_hook
        self.parameter = parameter
        self.scheduler = scheduler
        if self.name is None:
            self.name = f"{target_hook}_{parameter}_schedule"

    def init(self, agent) -> None:
        agent.get_hook(self.target_hook)  # raises if missing

    def schedule_is_noop(self, iteration: int) -> bool:
        return False

    def apply_schedule(self, iteration: int, agent=None) -> None:
        agent.get_hook(self.target_hook).update_attribute(self.parameter, self.scheduler(iteration))


class HookActivationSchedule(Hook):
    training_only = True

    def __init__(self, target_hook: str | None = None, scheduler: Callable[[int], bool] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.target_hook = target_hook
        self.scheduler = scheduler
        if self.name is None:
            self.name = f"{target_hook}_activation_schedule"

    def init(self, agent) -> None:
        agent.get_hook(self.target_hook)

    def schedule_is_noop(self, iteration: int) -> bool:
        return False

    def apply_schedule(self, iteration: int, agent=None) -> None:
        agent.get_hook(self.target_hook).with_active(bool(self.scheduler(iteration)))

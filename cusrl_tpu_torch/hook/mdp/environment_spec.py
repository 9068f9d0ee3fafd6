"""Environment-spec override hooks (counterpart of
``cusrl_tpu/hook/mdp/environment_spec.py``).

An override applies at hook-init time, before any later hook reads the spec:
register it first (index 0).  The dimensions are fixed by then; override
behavioral attributes (mirror functions, statistics groups, normalization
statistics, ...).
"""

from __future__ import annotations

from typing import Any, Callable

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["DynamicEnvironmentSpecOverride", "EnvironmentSpecOverride"]


class EnvironmentSpecOverride(Hook):
    """Sets each ``(name, value)`` of ``overrides`` on the agent's spec."""

    def __init__(self, overrides: tuple[tuple[str, Any], ...] = (), **kwargs):
        super().__init__(**kwargs)
        self.overrides = tuple(overrides)

    @staticmethod
    def create(overrides: dict[str, Any] | None = None, **kwargs: Any) -> "EnvironmentSpecOverride":
        merged = dict(overrides or {})
        merged.update(kwargs)
        return EnvironmentSpecOverride(overrides=tuple(sorted(merged.items())))

    def init(self, agent) -> None:
        for name, value in self.overrides:
            setattr(agent.environment_spec, name, value)


class DynamicEnvironmentSpecOverride(Hook):
    """Sets the attributes ``overrides_factory(environment_instance)``
    returns on the agent's spec."""

    def __init__(self, overrides_factory: Callable[[Any], dict[str, Any]] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.overrides_factory = overrides_factory

    def init(self, agent) -> None:
        spec = agent.environment_spec
        if spec.environment_instance is None:
            raise ValueError("'environment_instance' is not set in the environment_spec")
        for name, value in self.overrides_factory(spec.environment_instance).items():
            setattr(spec, name, value)

"""Iteration-indexed schedulers (counterpart of
``cusrl_tpu/utils/scheduler.py``): step, piecewise-linear, cosine, tanh and
exponential interpolation, and the threshold predicates ``LessThan`` and
``NotLessThan``.  They run on the host between updates (they drive hook
attributes through ``HookParameterSchedule`` and ``HookActivationSchedule``),
so plain ``math`` does; the values and the errors are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, TypeAlias

__all__ = [
    "CosineAnnealingScheduler",
    "ExponentialScheduler",
    "LessThan",
    "NotLessThan",
    "PiecewiseLinearScheduler",
    "StepScheduler",
    "TanhScheduler",
]

Anchor: TypeAlias = tuple[int, float]
Transition: TypeAlias = tuple[int, Any]


def _check_increasing(points) -> None:
    steps = [p[0] for p in points]
    if any(a >= b for a, b in zip(steps, steps[1:])):
        raise ValueError("Step coordinates must be strictly increasing.")


class LessThan:
    """Predicate: iteration < threshold."""

    def __init__(self, threshold: int):
        self.threshold = threshold

    def __call__(self, value: int) -> bool:
        return value < self.threshold


class NotLessThan:
    """Predicate: iteration >= threshold."""

    def __init__(self, threshold: int):
        self.threshold = threshold

    def __call__(self, value: int) -> bool:
        return value >= self.threshold


class StepScheduler:
    """Piecewise-constant schedule: starts at ``initial_value`` and jumps to each
    transition's value once the iteration reaches its step."""

    def __init__(self, initial_value: Any, *transitions: Transition):
        self.initial_value = initial_value
        self.transitions = transitions
        _check_increasing(transitions)

    def __call__(self, iteration: int) -> Any:
        value = self.initial_value
        for step, scheduled in self.transitions:
            if iteration < step:
                break
            value = scheduled
        return value


class PiecewiseLinearScheduler:
    """Linear interpolation between anchors; clamps outside the anchor range."""

    def __init__(self, *anchors: Anchor):
        if len(anchors) < 2:
            raise ValueError("At least two anchors are required.")
        _check_increasing(anchors)
        self.anchors = anchors

    def __call__(self, iteration: int) -> float:
        if iteration <= self.anchors[0][0]:
            return self.anchors[0][1]
        for (s0, v0), (s1, v1) in zip(self.anchors, self.anchors[1:]):
            if iteration <= s1:
                t = (iteration - s0) / (s1 - s0)
                return v0 + (v1 - v0) * t
        return self.anchors[-1][1]


class CosineAnnealingScheduler:
    """Cosine interpolation from ``start`` to ``end`` anchor."""

    def __init__(self, start: Anchor, end: Anchor):
        _check_increasing((start, end))
        self.start_step, self.start_value = start
        self.end_step, self.end_value = end

    def __call__(self, iteration: int) -> float:
        if iteration <= self.start_step:
            return self.start_value
        if iteration >= self.end_step:
            return self.end_value
        t = (iteration - self.start_step) / (self.end_step - self.start_step)
        return self.end_value + 0.5 * (self.start_value - self.end_value) * (1.0 + math.cos(math.pi * t))


class TanhScheduler:
    """Tanh-shaped interpolation from ``start`` to ``end``; ``eta`` sets steepness."""

    def __init__(self, start: Anchor, end: Anchor, eta: float):
        _check_increasing((start, end))
        if eta <= 0:
            raise ValueError("'eta' must be positive.")
        self.start_step, self.start_value = start
        self.end_step, self.end_value = end
        self.eta = eta
        self._mid = 0.5 * (self.start_step + self.end_step)
        self._eps0 = self._epsilon(self.start_step)
        self._eps1 = self._epsilon(self.end_step)

    def _epsilon(self, iteration: float) -> float:
        t = 2.0 * (iteration - self._mid) / (self.end_step - self.start_step)
        return 0.5 + 0.5 * math.tanh(self.eta * t)

    def __call__(self, iteration: int) -> float:
        if iteration <= self.start_step:
            return self.start_value
        if iteration >= self.end_step:
            return self.end_value
        t = (self._epsilon(iteration) - self._eps0) / (self._eps1 - self._eps0)
        return self.start_value + (self.end_value - self.start_value) * t


class ExponentialScheduler:
    """Geometric decay ``value = initial * rate ** iteration`` with optional floor."""

    def __init__(self, initial_value: float, rate: float, minimum: float | None = None):
        self.initial_value = initial_value
        self.rate = rate
        self.minimum = minimum

    def __call__(self, iteration: int) -> float:
        value = self.initial_value * self.rate**iteration
        if self.minimum is not None:
            value = max(value, self.minimum)
        return value

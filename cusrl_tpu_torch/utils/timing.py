"""Wall-clock timing (counterpart of ``Timer`` and ``Rate`` in
``cusrl_tpu/utils/timing.py``).

``Timer.record`` is a context manager accumulating named buckets.  With
``synchronize=True`` it waits for the CUDA device (``torch.cuda.synchronize``)
at entry and exit, so a bucket covers the device work queued inside it; on a
process that has not touched CUDA it is a plain host clock.  ``Rate`` paces a
real-time loop.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Rate", "Timer"]


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self, synchronize: bool = False):
        self.synchronize = synchronize
        self._totals: dict[str, float] = {}

    @contextlib.contextmanager
    def record(self, name: str):
        if self.synchronize:
            _synchronize()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize:
                _synchronize()
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds

    def total(self, name: str) -> float:
        return self._totals.get(name, 0.0)

    def clear(self) -> None:
        self._totals.clear()


class Rate:
    """Real-time loop pacing at a fixed frequency (0 disables pacing)."""

    def __init__(self, frequency: float):
        self.frequency = frequency
        self.period = 1.0 / frequency if frequency > 0 else 0.0
        self._next_tick: float | None = None

    def reset(self) -> None:
        self._next_tick = None

    def tick(self) -> None:
        if self.period <= 0:
            return
        now = time.perf_counter()
        if self._next_tick is None:
            self._next_tick = now + self.period
            return
        sleep_for = self._next_tick - now
        if sleep_for > 0:
            time.sleep(sleep_for)
            self._next_tick += self.period
        else:  # fell behind: re-anchor instead of bursting
            self._next_tick = now + self.period

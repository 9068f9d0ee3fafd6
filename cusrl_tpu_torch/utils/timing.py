"""Wall-clock timing (counterpart of ``Timer`` in ``cusrl_tpu/utils/timing.py``).

``Timer.record`` is a context manager accumulating named buckets.  With
``synchronize=True`` it waits for the CUDA device (``torch.cuda.synchronize``)
at entry and exit, so a bucket covers the device work queued inside it; on a
process that has not touched CUDA it is a plain host clock.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["Timer"]


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

"""Running-mean metric accumulators (counterpart of ``cusrl_tpu/utils/metrics.py``).

``record`` keeps device tensors as they are; ``summary`` brings every pending
value to the host in ONE transfer (a single concatenated tensor), so recording
never waits on the device.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

__all__ = ["Metrics"]


class _Metric:
    __slots__ = ("mean", "count")

    def __init__(self) -> None:
        self.mean = 0.0
        self.count = 0

    def update(self, mean: float, count: int) -> None:
        if count == 0:
            return
        total = self.count + count
        self.mean = self.mean * (self.count / total) + float(mean) * (count / total)
        self.count = total


class Metrics:
    """Per-name running means with counts."""

    def __init__(self) -> None:
        self._data: dict[str, _Metric] = {}
        self._pending: list[tuple[str, Any]] = []

    def clear(self) -> None:
        self._data.clear()
        self._pending.clear()

    def record(self, metrics: Mapping[str, Any] | None = None, /, **kwargs: Any) -> None:
        for name, value in [*(metrics or {}).items(), *kwargs.items()]:
            if value is not None:
                self._pending.append((name, value))

    def _drain(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        tensors = [v.detach().reshape(-1).double() for _, v in pending if isinstance(v, torch.Tensor)]
        host = iter(())
        if tensors:
            flat = torch.cat([t.to(tensors[0].device) for t in tensors]).cpu()
            host = iter(flat.split([t.numel() for t in tensors]))
        for name, value in pending:
            array = next(host).numpy() if isinstance(value, torch.Tensor) else np.asarray(value, dtype=np.float64)
            if array.size:
                self._data.setdefault(name, _Metric()).update(array.mean(), array.size)

    def summary(self, prefix: str = "") -> dict[str, float]:
        self._drain()
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        return {f"{prefix}{name}": metric.mean for name, metric in self._data.items()}

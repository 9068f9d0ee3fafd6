"""Device memory statistics (counterpart of ``cusrl_tpu/hook/control/memory.py``).

After each update, on a CUDA agent, records the caching allocator's bytes in
use and its peak (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``
and ``.peak``, a host-side read that does not wait on the device) as
``Memory/device_bytes_in_use`` and ``Memory/device_peak_bytes``.  On the CPU
it records nothing, as the JAX hook records nothing where the device gives
no statistics.  ``EmptyCudaCache`` is an alias, as in JAX: neither package
empties a cache.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.template.hook import Hook

__all__ = ["DeviceMemoryStats", "EmptyCudaCache"]


class DeviceMemoryStats(Hook):
    training_only = True

    def apply_schedule(self, iteration: int, agent=None) -> None:
        if agent is None or agent.device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(agent.device)
        if "allocated_bytes.all.current" in stats:
            agent.record(**{
                "Memory/device_bytes_in_use": float(stats["allocated_bytes.all.current"]),
                "Memory/device_peak_bytes": float(stats["allocated_bytes.all.peak"]),
            })


EmptyCudaCache = DeviceMemoryStats

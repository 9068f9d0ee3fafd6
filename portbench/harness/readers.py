"""What the metric readers share: a kernel family's roofline share and
the traced chunk's per-iteration device time of a selection of kernels.

A reader returns None where its trace holds nothing to read (no trace, no
device event of its kernels, or launch counters that disagree with the
schedule the work is counted from); the harness then leaves its metric
out of the result line.  A share is never given as 0.
"""

from __future__ import annotations

import collections
import sys

from portbench.harness.trace import in_namespaces
from portbench.work.arithmetic import bound_s

__all__ = ["family_selector", "per_iteration_ms", "roofline_percent"]


def family_selector(namespaces, shared=(), owners=()):
    """Kernels of ``namespaces``, and kernels of ``shared`` namespaces that
    a host range whose name holds one of ``owners`` launched."""
    def select(name, enclosing) -> bool:
        if in_namespaces(name, namespaces):
            return True
        return in_namespaces(name, shared) and any(o in e for e in enclosing for o in owners)
    return select


def per_iteration_ms(trace, select) -> float | None:
    if trace is None:
        return None
    seconds = trace.device_s(select)
    return seconds * 1e3 / trace.iterations if seconds > 0 else None


def roofline_percent(ctx, family: str, select) -> float | None:
    """The least time of the iteration's ``family`` calls over the device
    time of the kernels ``select`` picks, in percent."""
    trace = ctx.trace
    calls = [c for c in ctx.kernel_calls() if c.family == family]
    if trace is None or not calls:
        return None
    want = collections.Counter()
    for call in calls:
        want[call.key] += call.count * trace.iterations
    have = {key: trace.launches.get(key, 0) for key in want}
    if have != dict(want):
        print(f"[{family}] launch counters {have} disagree with the schedule's {dict(want)}: no share",
              file=sys.stderr)
        return None
    device_s = trace.device_s(select)
    if device_s <= 0:
        return None
    least = sum(call.count * bound_s(call.flops, call.nbytes, call.peak_flops) for call in calls) * trace.iterations
    return 100.0 * least / device_s

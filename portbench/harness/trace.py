"""The traced chunk: ``torch.profiler`` over one whole chunk of the
training loop, reduced to what the per-layer readers read.

The profiler's Chrome trace is read back (``export_chrome_trace`` into
``TMPDIR``, deleted at once): device events (kernels, copies, fills) with
their launching host call by correlation id, host events by thread, and
the harness's own ``portbench.*`` ranges.  ``is_device_work`` keeps the
event filter of ``chip_smoke.py`` (``_is_device_work``: a range that
PyTorch also records on the device repeats its kernels' time and is not
device work) and ``in_namespaces`` its kernel-name rule (``_in_namespaces``:
a kernel belongs to a namespace by its own name, not by the types its
signature names).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

__all__ = ["DEVICE_CATEGORIES", "LAUNCH_CALLS", "DeviceTime", "Trace", "in_namespaces", "is_device_work", "summarize",
           "union_length"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# Host calls that put work on the device: kernel launches (runtime and
# driver API), copies and fills, graph launches.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemsetAsync",
                "cudaMemset", "cudaGraphLaunch")


def in_namespaces(name: str, namespaces) -> bool:
    """Whether the kernel ``name`` (demangled or not) is a function of one
    of ``namespaces``."""
    return any(f"{ns}::" in name.split("(")[0] or name.startswith(f"_ZN{len(ns)}{ns}") for ns in namespaces)


def is_device_work(event: dict) -> bool:
    """Whether a Chrome-trace event is work on the device."""
    return event.get("cat") in DEVICE_CATEGORIES


def union_length(spans) -> tuple[float, list]:
    """``(length, merged)``: the length of the union of the ``(start, end)``
    intervals, and the union as sorted disjoint ``[start, end]`` pairs."""
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(end - start for start, end in merged), merged


@dataclasses.dataclass
class Trace:
    window_s: float                 # host clock from the profiler's start to its stop
    iterations: int                 # training iterations in the traced chunk
    busy_s: float                   # the union of the device events
    kernels: list                   # [(name, seconds, owners: tuple of enclosing host names)]
    launch_calls: dict              # {host call name: count}
    idle_gaps: list                 # [(what the host was doing, seconds)], most first
    launches: dict                  # the port's launch counters over the chunk
    device_events: int

    def device_s(self, select) -> float:
        """Seconds of the kernels for which ``select(name, owners)`` holds."""
        return sum(seconds for name, seconds, owners in self.kernels if select(name, owners))

    def device_ops(self, top: int = 10) -> list:
        totals = collections.Counter()
        for name, seconds, _ in self.kernels:
            totals[name[:160]] += seconds
        return [[name, seconds] for name, seconds in totals.most_common(top)]


def _enclosing(host_by_thread: dict, queries: list) -> dict:
    """For each ``(tid, ts, key)`` query, the names of the host events on
    thread ``tid`` that contain ``ts``, outermost first: ``{key: names}``."""
    found = {}
    by_thread = collections.defaultdict(list)
    for tid, ts, key in queries:
        by_thread[tid].append((ts, key))
    for tid, items in by_thread.items():
        events = host_by_thread.get(tid, [])
        items.sort()
        stack, i = [], 0
        for ts, key in items:
            while i < len(events) and events[i][0] <= ts:
                stack.append(events[i])
                i += 1
            stack = [e for e in stack if e[1] >= ts]
            found[key] = tuple(e[2] for e in stack)
    return found


def summarize(path: str, window_s: float, iterations: int, launches: dict) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, host = [], collections.defaultdict(list)
    launch_by_corr = {}
    calls = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append(e)
        elif cat in HOST_CATEGORIES:
            start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            host[e.get("tid")].append((start, end, e.get("name", "")))
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_by_corr[corr] = (e.get("tid"), start)
                if e.get("name") in LAUNCH_CALLS:
                    calls[e["name"]] += 1
    for items in host.values():
        items.sort(key=lambda x: (x[0], -x[1]))
    queries = [(tid, ts, corr) for corr, (tid, ts) in launch_by_corr.items()]
    owners = _enclosing(host, queries)
    kernels, spans = [], []
    for e in device:
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((start, start + dur))
        corr = (e.get("args") or {}).get("correlation")
        kernels.append((e.get("name", ""), dur * 1e-6, owners.get(corr, ())))
    busy_us, merged = union_length(spans)
    busy_s = busy_us * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1) if merged[i + 1][0] > merged[i][1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    longest = gaps[:2000]
    midpoints = [(tid, (a + b) / 2, (tid, index)) for index, (a, b) in enumerate(longest) for tid in host]
    inside = _enclosing(host, midpoints)
    idle = collections.Counter()
    for index, (a, b) in enumerate(longest):
        stacks = [inside.get((tid, index), ()) for tid in host]
        deepest = max(stacks, key=len, default=())
        span = next((name for stack in stacks for name in reversed(stack) if name.startswith("portbench.")), "")
        op = next((name for name in reversed(deepest) if not name.startswith("portbench.")), "idle")
        idle[f"{span} > {op}" if span else op] += (b - a) * 1e-6
    return Trace(window_s, iterations, busy_s, kernels, dict(calls), [[k, v] for k, v in idle.most_common(10)],
                 launches, len(device))


def record(profile_factory):
    """A profiler session whose ``finish(window_s, iterations, launches)``
    returns the ``Trace``."""
    return _Session(profile_factory)


class _Session:
    def __init__(self, profile_factory):
        self.profiler = profile_factory()

    def __enter__(self):
        self.profiler.__enter__()
        return self

    def finish(self, window_s: float, iterations: int, launches: dict) -> Trace:
        self.profiler.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self.profiler.export_chrome_trace(path)
            return summarize(path, window_s, iterations, launches)
        finally:
            os.remove(path)


class DeviceTime:
    """``torch.profiler`` with the device's activity alone, over a whole
    window: ``finish()`` stops it and returns ``(busy seconds, device
    events)``, the union of the intervals of the device's kernels, copies
    and fills.  The events are read from the profiler's memory, not from a
    trace file: a window holds a million or more of them."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.profiler = profile(activities=[ProfilerActivity.CUDA])
        self.profiler.__enter__()
        return self

    def finish(self) -> tuple[float, int]:
        self.profiler.__exit__(None, None, None)
        events = self.profiler.profiler.kineto_results.events()
        spans = [(e.start_ns(), e.end_ns()) for e in events if _on_device(e)]
        return union_length(spans)[0] * 1e-9, len(spans)


def _on_device(event) -> bool:
    """Whether a profiler event is work on the device (a kernel, copy or
    fill), by its category where PyTorch names it, else by its device and
    not being a range recorded on the device."""
    if hasattr(event, "activity_type"):
        return event.activity_type() in DEVICE_CATEGORIES
    from torch.autograd import DeviceType

    annotation = hasattr(event, "is_user_annotation") and event.is_user_annotation()
    return event.device_type() == DeviceType.CUDA and not annotation

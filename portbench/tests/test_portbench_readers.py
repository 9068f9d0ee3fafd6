"""The union of device intervals (``trace.union_length``) and the readers
of the card's time: ``device_ms_per_iter`` over the window, ``step_mfu``
over the traced chunk, and ``wall_env_steps_per_s``, on made-up runs."""

from __future__ import annotations

import types

import pytest

from portbench.harness import spec
from portbench.harness.trace import union_length
from portbench.work.arithmetic import PEAK_BF16_FLOPS


@pytest.mark.parametrize("spans, length", [
    ([], 0),
    ([(0, 5)], 5),
    ([(0, 5), (5, 7)], 7),          # touching
    ([(0, 5), (2, 3)], 5),          # nested
    ([(4, 9), (0, 5), (20, 21)], 10),  # overlapping, out of order, apart
])
def test_union_length(spans, length):
    assert union_length(spans)[0] == length


def _ctx(window_device_s=None, events=0, iterations=10, trace=None, window_s=2.0, env_steps=1000):
    run = types.SimpleNamespace(window_device_s=window_device_s, window_device_events=events,
                                window_iterations=iterations, window_s=window_s, env_steps=env_steps)
    return types.SimpleNamespace(run=run, trace=trace, model_flops=lambda: 1e12)


def test_device_ms_per_iter_reads_the_window_and_nothing_without_a_device():
    read = spec.load_reader("device_ms_per_iter").read
    assert read(_ctx(0.5, 1234, 10)) == pytest.approx(50.0)
    assert read(_ctx()) is None and read(_ctx(0.5, 0, 10)) is None


def test_step_mfu_is_model_flop_over_the_busy_time():
    read = spec.load_reader("step_mfu").read
    trace = types.SimpleNamespace(device_events=7, busy_s=2.0, iterations=4)
    assert read(_ctx(trace=trace)) == pytest.approx(100.0 * 4e12 / (2.0 * PEAK_BF16_FLOPS))
    assert read(_ctx()) is None


def test_wall_env_steps_per_s_is_read_in_the_traced_run_only():
    read = spec.load_reader("wall_env_steps_per_s").read
    assert read(_ctx(trace=types.SimpleNamespace())) == pytest.approx(500.0)
    assert read(_ctx()) is None

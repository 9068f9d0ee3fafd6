"""The check that decides ``correct`` fails what it must, at a tiny size on
the CPU.  The control (the reference one precision below the
configuration's, in the program's place) fails each cell's own limits on
three seeds.  At the tiny size the program's own readings differ from the
card's (fewer rows are averaged), so the runs below are judged by limits
set the way the cells' are (``harness.limits``) from tiny readings: a
sound run passes, and a whole run with a fault planted in the program's
timed path (``harness.check.control_program`` plants the same faults in
the reference for the readings) does not."""

from __future__ import annotations

import functools

import pytest
import torch
from conftest import cells, tiny_cell

from portbench.harness import check, limits, runner

SEEDS = [2 ** 31 + 31 + i for i in range(3)]


@functools.lru_cache(maxsize=None)
def _tiny_readings(name: str) -> tuple:
    return tuple(runner.readings(tiny_cell(name, per_chunk=1), SEEDS, device="cpu"))


@pytest.mark.parametrize("name", cells())
def test_the_control_fails_the_cells_limits(name):
    cell = tiny_cell(name)
    for row in _tiny_readings(name):
        assert not check.verdict(row["control"], cell.limits)[0], row["control"]


def _tiny_limits(name: str) -> dict:
    table = limits.limits(list(_tiny_readings(name)))
    return {**{key: entry["limit"] for key, entry in table.items() if entry["limit"] is not None}, **check.EXACT}


@pytest.mark.parametrize("name", cells())
def test_the_control_and_the_faults_separate_at_the_tiny_size(name):
    rows, bounds = _tiny_readings(name), _tiny_limits(name)
    for row in rows:
        assert check.verdict(row["program"], bounds)[0]
        for key in ("control", "half_batch", "unchanged_state"):
            assert not check.verdict(row[key], bounds)[0], (key, row[key])


def _half_batch(monkeypatch):
    """Each minibatch keeps its first half of rows (environments for a
    temporal sampler): its mean is taken over the rest."""
    from cusrl_tpu_torch.sampler import mini_batch_sampler as samplers
    from cusrl_tpu_torch.utils.nest import map_nested

    for cls, axis in ((samplers.MiniBatchSampler, 0), (samplers.TemporalMiniBatchSampler, 1)):
        gather = cls.gather

        def halved(self, *args, _gather=gather, _axis=axis, **kwargs):
            return map_nested(lambda x: x.narrow(_axis, 0, max(1, x.shape[_axis] // 2)), _gather(self, *args, **kwargs))

        monkeypatch.setattr(cls, "gather", halved)


def _unchanged_state(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    from cusrl_tpu_torch.template.optimizer import Optimizer

    step = Optimizer.step

    def unchanged(self):
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        saved = [p.detach().clone() for p in params]
        step(self)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)

    monkeypatch.setattr(Optimizer, "step", unchanged)


def _rows_out_of_plan(monkeypatch):
    """Each minibatch's rows (environments for a temporal sampler) turned
    by one place: the update no longer follows the plan it drew."""
    from cusrl_tpu_torch.sampler import mini_batch_sampler as samplers
    from cusrl_tpu_torch.utils.nest import map_nested

    for cls, axis in ((samplers.MiniBatchSampler, 0), (samplers.TemporalMiniBatchSampler, 1)):
        gather = cls.gather

        def turned(self, *args, _gather=gather, _axis=axis, **kwargs):
            return map_nested(lambda x: x.roll(1, _axis), _gather(self, *args, **kwargs))

        monkeypatch.setattr(cls, "gather", turned)


FAULTS = {"half_batch": _half_batch, "unchanged_state": _unchanged_state, "rows_out_of_plan": _rows_out_of_plan}


def _run(name: str) -> dict:
    cell = tiny_cell(name, per_chunk=1)
    cell.workload = {**cell.workload, "limits": _tiny_limits(name)}
    return runner.run_cell(cell, SEEDS[0], 0.2, False, device="cpu")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", cells())
def test_a_fault_in_the_program_makes_the_run_incorrect(name, fault, monkeypatch):
    _tiny_limits(name)  # the readings before the fault is planted
    FAULTS[fault](monkeypatch)
    result = _run(name)
    assert result["correct"] is False, result["checks"]
    if fault == "rows_out_of_plan":
        assert result["checks"]["plan_steps_differ"]["value"] == 3


@pytest.mark.parametrize("name", cells())
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"] is True, result["checks"]

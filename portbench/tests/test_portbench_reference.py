"""The plain reference (``portbench/reference``) against the port at a
tiny size on the CPU, both in fp32: the same first update to rounding.
And two pieces of the reference against a count by hand."""

from __future__ import annotations

import pytest
import torch
from conftest import cells, tiny_cell

from portbench.harness import runner
from portbench.reference.ppo import Hyper, gae, normalize_observations

# fp32 on both sides: what differs is the order of the sums.
FP32 = {"policy_mean_rel": 1e-5, "value_rel": 1e-5, "advantage_rel": 1e-5, "loss_rel": 1e-5, "grad_norm_gap": 1e-5,
        "grad_norm_median_gap": 1e-5, "param_change_gap": 1e-3, "param_change_median_gap": 1e-5}


@pytest.mark.parametrize("name", cells())
def test_reference_and_port_agree_in_fp32(name, monkeypatch):
    from cusrl_tpu_torch.utils.config import CONFIG

    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    row = next(runner.readings(tiny_cell(name, per_chunk=1), [2 ** 31 + 17], device="cpu"))
    gaps = {key: row["program"][key] for key in FP32}
    assert all(gaps[key] < FP32[key] for key in FP32), gaps
    assert row["program"]["observation_gap"] < 1e-3 and row["program"]["plan_steps_differ"] == 0


def test_gae_by_hand():
    reward = torch.tensor([[[1.0]], [[2.0]], [[3.0]]])
    done = torch.tensor([[[False]], [[True]], [[False]]])
    value = torch.tensor([[[0.5]], [[0.25]], [[1.0]]])
    next_value = torch.tensor([[[0.25]], [[0.0]], [[2.0]]])
    gamma, lam = 0.9, 0.5
    a2 = 3.0 + gamma * 2.0 - 1.0
    a1 = 2.0 + gamma * 0.0 - 0.25  # the episode ends: nothing carried back into it
    a0 = (1.0 + gamma * 0.25 - 0.5) + gamma * lam * a1
    assert torch.allclose(gae(reward, done, value, next_value, gamma, lam).reshape(-1), torch.tensor([a0, a1, a2]))


def test_observation_statistics_by_hand():
    # Two steps, two environments, one feature; the first environment's
    # episode ends at step 0, so its next first observation joins the statistics.
    raw = torch.tensor([[[1.0], [3.0]], [[5.0], [7.0]]])
    raw_next = torch.tensor([[[2.0], [4.0]], [[6.0], [8.0]]])
    done = torch.tensor([[[True], [False]], [[False], [False]]])
    obs, next_obs = normalize_observations(raw, raw_next, done, Hyper())
    seen = torch.tensor([1.0, 3.0])
    assert torch.allclose(obs[0, :, 0], (seen - seen.mean()) / torch.sqrt(seen.var(unbiased=False) + 1e-8))
    seen = torch.tensor([1.0, 3.0, 2.0, 4.0])
    assert torch.allclose(next_obs[0, :, 0], (torch.tensor([2.0, 4.0]) - seen.mean())
                          / torch.sqrt(seen.var(unbiased=False) + 1e-8))
    seen = torch.tensor([1.0, 3.0, 2.0, 4.0, 5.0])
    assert torch.allclose(obs[1, :, 0], (torch.tensor([5.0, 7.0]) - seen.mean())
                          / torch.sqrt(seen.var(unbiased=False) + 1e-8))


@pytest.mark.parametrize("name", cells())
def test_the_reference_in_blocks_is_the_reference_whole(name):
    from portbench.harness import check
    from portbench.harness.session import run
    from portbench.reference.ppo import first_update

    cell = tiny_cell(name, per_chunk=1)
    run, trainer = run(cell, 2 ** 31 + 23, None, False, "cpu")
    del trainer
    rollout, _ = runner._program(run)
    perms, block, mini_batches = run.capture.plan
    model = check._model(cell.config, "fp32", "fp32")
    updates = [first_update(model, run.initial_weights, rollout, perms, block, mini_batches, check.hyper(cell.config),
                            block_rows=rows) for rows in (1 << 20, 24)]
    whole, blocks = updates
    assert torch.allclose(whole.mean, blocks.mean, atol=1e-6) and torch.allclose(whole.value, blocks.value, atol=1e-6)
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(whole.losses, blocks.losses))
    norms = {key: float(g.norm()) for key, g in whole.first_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    for key in whole.params:
        assert torch.allclose(whole.first_grads[key], blocks.first_grads[key], rtol=1e-4, atol=1e-8), key
        if norms[key] >= 1e-3 * median:  # Adam turns a gradient that is nought to rounding into steps of lr
            assert (whole.params[key] - blocks.params[key]).abs().max() < 1e-5, key  # a hundredth of lr

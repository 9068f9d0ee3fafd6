"""The control hooks and schedules of the port against the JAX package, at
small size: the iteration schedulers (every value on iterations 0-40 and
every error), ``HookParameterSchedule``, ``HookActivationSchedule``,
``ConditionalObjectiveActivation`` with ``EpochIndexCondition``,
``MiniBatchWiseLRSchedule``, ``OptimizationStage`` (a nested
``StateEstimation`` and ``GradientClipping`` with the stage's own Adam) and
its checkpoint in either package, ``OnPolicyBufferCapacitySchedule`` through
the Trainer, ``DeviceMemoryStats`` on the CPU, and the data-parallel guard.

The updates follow ``tests/test_torch_aux_hooks.py``'s helpers: the zoo's
Velocity-Rough ``ppo`` configuration at widths 32-16 on both sides with the
hooks registered where the JAX tests register them, the port with the JAX
agent's weights and hook state, the same numpy rollouts (actions from the
JAX actor as it stands before each update) and the JAX sampler's plans; the
schedules run after each update on both sides.  Both sides compute in fp32
here, so metrics, parameters, hook state and optimizer state agree to 1e-5
(relative and absolute).  The schedulers and the Trainer's step counts are
compared exactly.
"""

from __future__ import annotations

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.auxiliary.estimation import StateEstimation as JaxStateEstimation
from cusrl_tpu.hook.control.condition import ConditionalObjectiveActivation as JaxConditional
from cusrl_tpu.hook.control.condition import EpochIndexCondition as JaxEpochIndexCondition
from cusrl_tpu.hook.control.memory import DeviceMemoryStats as JaxDeviceMemoryStats
from cusrl_tpu.hook.control.optimization_stage import OptimizationStage as JaxOptimizationStage
from cusrl_tpu.hook.control.schedule import HookActivationSchedule as JaxActivationSchedule
from cusrl_tpu.hook.control.schedule import HookParameterSchedule as JaxParameterSchedule
from cusrl_tpu.hook.on_policy.buffer_schedule import OnPolicyBufferCapacitySchedule as JaxCapacitySchedule
from cusrl_tpu.hook.on_policy.gradient_clipping import GradientClipping as JaxGradientClipping
from cusrl_tpu.hook.on_policy.lr_schedule import MiniBatchWiseLRSchedule as JaxMiniBatchWise
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.preset.optimizer import AdamFactory as JaxAdamFactory
from cusrl_tpu.template.logger import load_checkpoint_file as jax_load_checkpoint_file
from cusrl_tpu.template.logger import save_checkpoint_file as jax_save_checkpoint_file
from cusrl_tpu.utils import scheduler as jax_scheduler
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.hook import (
    ConditionalObjectiveActivation,
    DeviceMemoryStats,
    EmptyCudaCache,
    EpochIndexCondition,
    GradientClipping,
    HookActivationSchedule,
    HookParameterSchedule,
    MiniBatchWiseLRSchedule,
    OnPolicyBufferCapacitySchedule,
    OptimizationStage,
    StateEstimation,
)
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.parallel import multiprocess
from cusrl_tpu_torch.preset.optimizer import AdamFactory
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils import scheduler
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_aux_hooks import PolicyDistillationLossForStage
from tests.test_torch_aux_hooks import N, T, _t, build, compare, rollout_arrays

FP32_TOL = (dict(rtol=1e-5, atol=1e-5),) * 3  # metrics, parameters, hook state


_UPDATES: dict = {}  # one jitted JAX update per agent (kept beside it), so a second update reuses its compile


def updates_both(jax_agent, agent, seeds):
    """One update per seed on both sides (the rollout from the JAX actor as
    it stands, the JAX sampler's plan fed to the port), each followed by the
    schedules of the next iteration; returns ``[(jax metrics, port
    metrics), ...]``."""
    results = []
    for i, seed in enumerate(seeds):
        rollout = rollout_arrays(jax_agent, seed)
        key = jax.random.key(5 + i)
        jax_rollout = jax.tree.map(jnp.asarray, rollout)
        plan = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
        perms = [np.array(p[1]) for p in plan] if isinstance(plan, list) else np.array(plan[1])
        jitted = _UPDATES.setdefault(id(jax_agent), (jax_agent, jax.jit(jax_agent.update_body)))[1]
        jax_agent.state, jax_metrics = jitted(jax_agent.state, jax_rollout, key)
        jax_agent.iteration += 1
        jax_agent._apply_schedules(jax_agent.iteration)
        metrics = agent.update_body(jax.tree.map(_t, rollout), epoch_perms=perms)
        agent.apply_schedules(agent.iteration)
        results.append((jax_metrics, metrics))
    return results


def jax_new_state(jax_agent) -> dict:
    return {p: np.asarray(v, np.float32) for p, v in tree_paths(jax_agent.state)
            if p.startswith(("actor.", "critic.", "hooks."))}


def compare_updates(jax_agent, agent, results):
    for jax_metrics, metrics in results[:-1]:
        assert set(metrics) == set(jax_metrics)
        for key, value in jax_metrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), err_msg=key, **FP32_TOL[0])
    return compare(*results[-1], jax_new_state(jax_agent), agent, tol=FP32_TOL)


# -- the schedulers --------------------------------------------------------------

SCHEDULERS = {
    "less_than": lambda m: m.LessThan(7),
    "not_less_than": lambda m: m.NotLessThan(7),
    "step": lambda m: m.StepScheduler(1.0, (5, 0.5), (12, 0.25), (30, 0.0)),
    "piecewise_linear": lambda m: m.PiecewiseLinearScheduler((3, 0.02), (10, 0.01), (25, 0.0)),
    "cosine": lambda m: m.CosineAnnealingScheduler((2, 1.0), (33, 0.1)),
    "tanh": lambda m: m.TanhScheduler((4, 0.0), (36, 2.0), 2.5),
    "exponential": lambda m: m.ExponentialScheduler(1.0, 0.9, 0.05),
    "exponential_unbounded": lambda m: m.ExponentialScheduler(3.0, 1.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_on_iterations_0_to_40(name):
    """Exactly equal values (Python floats and bools on both sides)."""
    ours, theirs = SCHEDULERS[name](scheduler), SCHEDULERS[name](jax_scheduler)
    for iteration in range(41):
        assert ours(iteration) == theirs(iteration), iteration


BAD_SCHEDULERS = {
    "one_anchor": lambda m: m.PiecewiseLinearScheduler((0, 1.0)),
    "piecewise_not_increasing": lambda m: m.PiecewiseLinearScheduler((0, 1.0), (0, 2.0)),
    "step_not_increasing": lambda m: m.StepScheduler(1.0, (5, 0.5), (3, 0.1)),
    "cosine_backwards": lambda m: m.CosineAnnealingScheduler((5, 1.0), (2, 0.0)),
    "tanh_backwards": lambda m: m.TanhScheduler((5, 1.0), (5, 0.0), 1.0),
    "tanh_eta": lambda m: m.TanhScheduler((0, 1.0), (5, 0.0), 0.0),
}


@pytest.mark.parametrize("name", sorted(BAD_SCHEDULERS))
def test_scheduler_raises_as_jax(name):
    with pytest.raises(ValueError) as jax_error:
        BAD_SCHEDULERS[name](jax_scheduler)
    with pytest.raises(ValueError, match=str(jax_error.value)):
        BAD_SCHEDULERS[name](scheduler)


def test_scheduler_exports_match_jax():
    import cusrl_tpu.utils as jax_utils
    import cusrl_tpu_torch.utils as utils

    assert set(jax_scheduler.__all__) == set(scheduler.__all__)
    for name in scheduler.__all__:
        assert getattr(utils, name) is getattr(scheduler, name) and hasattr(jax_utils, name)


# -- parameter, activation and conditional schedules ----------------------------


def test_parameter_and_activation_schedules_match_jax():
    """The port of ``tests/test_aux_hooks.py``'s schedule tests, through two
    updates on both sides: ``entropy_loss.weight`` follows a piecewise-linear
    schedule (0.02 - 2 * 0.002 after two updates) and the activation
    schedule switches ``entropy_loss`` off from iteration 1, so the second
    update has no ``entropy_loss`` on either side."""
    pw = lambda m: m.PiecewiseLinearScheduler((0, 0.02), (10, 0.0))
    hooks = [(JaxParameterSchedule(target_hook="entropy_loss", parameter="weight", scheduler=pw(jax_scheduler)),
              HookParameterSchedule(target_hook="entropy_loss", parameter="weight", scheduler=pw(scheduler)), {}),
             (JaxActivationSchedule(target_hook="entropy_loss", scheduler=jax_scheduler.LessThan(1)),
              HookActivationSchedule(target_hook="entropy_loss", scheduler=scheduler.LessThan(1)), {})]
    jax_agent, agent = build(hooks, compute_dtype="float32")
    assert agent.get_hook("entropy_loss_weight_schedule").hook_name == "entropy_loss_weight_schedule"
    results = updates_both(jax_agent, agent, (21, 22))
    assert "entropy_loss" in results[0][1] and "entropy_loss" not in results[1][1]
    compare_updates(jax_agent, agent, results)
    weight = agent.get_hook("entropy_loss").weight
    assert weight == pytest.approx(0.02 - 2 * 0.002, abs=1e-6)
    assert weight == pytest.approx(float(jax_agent.get_hook("entropy_loss").weight), abs=1e-7)
    assert not agent.get_hook("entropy_loss").active and not jax_agent.get_hook("entropy_loss").active


def test_conditional_objective_activation_matches_jax():
    """``value_loss`` counts in epoch 1 only and ``entropy_loss`` in epoch
    0 only (scales of 0 and 1 on the losses, which both sides still
    report); one update, every metric and parameter."""
    conditions = lambda c: dict(value_loss=c(1), entropy_loss=c(0))
    hooks = [(JaxConditional.create(**conditions(JaxEpochIndexCondition)),
              ConditionalObjectiveActivation.create(**conditions(EpochIndexCondition)), {"before": "value_loss"})]
    jax_agent, agent = build(hooks, compute_dtype="float32")
    assert EpochIndexCondition((2, 1, 2)).epoch_index == (1, 2) and EpochIndexCondition(1) == EpochIndexCondition([1])
    results = updates_both(jax_agent, agent, (23,))
    assert np.isfinite(float(results[0][1]["entropy_loss"]))
    compare_updates(jax_agent, agent, results)


# -- minibatch-wise learning rate --------------------------------------------------


def test_minibatch_wise_lr_schedule_matches_jax():
    """Registered after ``on_policy_preparation`` (which it makes compute
    the KL): one update; the ``lr_scale`` metric, every other metric, the
    parameters, the scale and the groups' learning rates as JAX's."""
    hooks = [(JaxMiniBatchWise(desired_kl_divergence=0.01), MiniBatchWiseLRSchedule(desired_kl_divergence=0.01),
              {"after": "on_policy_preparation"})]
    jax_agent, agent = build(hooks, compute_dtype="float32")
    assert agent.get_hook("on_policy_preparation").calculate_kl_divergence
    results = updates_both(jax_agent, agent, (24,))
    compare_updates(jax_agent, agent, results)
    for name, lr in jax_agent.state.learning_rates.items():
        np.testing.assert_allclose(float(agent.optimizer.group(name)["lr"]), float(lr), rtol=1e-6)


def test_minibatch_wise_schedule_scales_lr_during_update():
    """The port of ``tests/test_cli_errors_and_lr.py``'s check: the first
    update barely moves the policy, so each of its 4 minibatches scales
    the rate up by 1.5."""
    factory = PpoAgentFactory(num_steps_per_update=8, actor_hidden_dims=(16,), critic_hidden_dims=(16,),
                              sampler_epochs=2, sampler_mini_batches=2).to_underlying()
    factory.register_hook(MiniBatchWiseLRSchedule(desired_kl_divergence=0.01, threshold=2.0, scale_factor=1.5),
                          after="on_policy_preparation")
    env = VelocityLocomotionEnv(num_instances=16, observation_dim=12, action_dim=3, seed=1, device="cpu")
    agent = factory(env.spec, device="cpu", seed=0)
    base_lr = float(agent.optimizer.group("default")["lr"])
    RolloutDriver(agent, env).collect_and_update(agent.num_steps_per_update)
    new_lr = float(agent.optimizer.group("default")["lr"])
    assert new_lr == pytest.approx(base_lr * 1.5**4, rel=1e-3)


def test_minibatch_wise_requires_kl_entry():
    agent = types.SimpleNamespace(iteration=0)
    with pytest.raises(RuntimeError, match="kl_divergence"):
        MiniBatchWiseLRSchedule(desired_kl_divergence=0.01).objective(agent, {}, {})
    with pytest.raises(RuntimeError, match="kl_divergence"):
        JaxMiniBatchWise(desired_kl_divergence=0.01).objective(None, {}, {})


# -- the optimization stage ----------------------------------------------------


class ActionMeanLoss(Hook):
    """The port of ``tests/test_aux_hooks.py``'s ``PolicyDistillationLossForStage``:
    a stage loss on the actor, pulling its mean toward zero."""

    def objective(self, agent, metadata, batch):
        dist_params, _, _ = agent.actor(batch["observation"], None)
        return {"stage_aux_loss": dist_params["mean"].square().mean() * 0.01}, {}


def _stage_hooks():
    """A stage with its own Adam: state estimation of two observation
    channels from the observation, the actor-mean loss, then clipping."""
    def stage(estimation, mean_loss, clipping, mlp, adam):
        return dict(stage_name="aux", optimizer_factory=adam(lr=1e-3), stage_hooks=(
            estimation(estimator_factory=mlp(hidden_dims=(16,)), target_name="observation", target_indices=(0, 1)),
            mean_loss(), clipping(max_grad_norm=0.5)))

    return [(JaxOptimizationStage(**stage(JaxStateEstimation, PolicyDistillationLossForStage, JaxGradientClipping,
                                          JaxMlpFactory, JaxAdamFactory)),
             OptimizationStage(**stage(StateEstimation, ActionMeanLoss, GradientClipping, MlpFactory, AdamFactory)),
             {})]


@pytest.fixture(scope="module")
def stage_agents():
    return build(_stage_hooks(), compute_dtype="float32")


def test_optimization_stage_update_matches_jax(stage_agents):
    """Two updates: the stage's losses and its clipping's norm among the
    metrics, every parameter, and the whole checkpoint map, the stage's
    optimizer state and the agent's included, as JAX's.  The stage's Adam
    moves the actor (its loss reaches it) but, on both sides, not the
    estimator: JAX's composite puts the stage's pre-step networks back (a
    JAX quirk the port follows: ROADMAP Queue 3), and the agent's Adam,
    which holds the estimator too, gets no gradient for it."""
    jax_agent, agent = stage_agents
    stage = agent.get_hook("optimization_stage_aux")
    estimator = stage.stage_hooks[0].estimator
    assert "hooks.optimization_stage_aux.stage_hooks.0.estimator.layers.0.weight" in agent.optimizer.labels
    assert set(stage.batch_keys) == {"observation", "estimator_memory", "done"}
    before = {k: v.clone() for k, v in estimator.state_dict().items()}
    results = updates_both(jax_agent, agent, (25, 26))
    assert {"state_estimation_loss", "stage_aux_loss", "grad_norm/default"} <= set(results[-1][1])
    compare_updates(jax_agent, agent, results)
    assert all(torch.equal(v, before[k]) for k, v in estimator.state_dict().items())
    state, jax_state = agent.state_dict()["agent_state"], jax_agent.state_dict()["agent_state"]
    assert set(state) == set(jax_state)
    index = [h.hook_name for h in agent.hooks].index("optimization_stage_aux")
    moment = f"hooks.{index}.opt_state.0.inner_state.mu.hooks.optimization_stage_aux.stage_hooks.0.estimator."
    assert {f"hooks.{index}.opt_state.0.inner_state.count", f"hooks.{index}.stage_learning_rates.default",
            f"hooks.{index}.stage_hooks.0.weight", moment + "layers.0.weight"} <= set(state)
    assert int(state[f"hooks.{index}.opt_state.0.inner_state.count"]) == 2 * 20
    assert np.abs(state[moment + "layers.0.weight"]).max() > 0
    for key, value in state.items():
        np.testing.assert_allclose(value, np.asarray(jax_state[key], value.dtype), rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("stage_first", [False, True])
def test_rejected_update_restores_as_jax(stage_first):
    """With ``max_kl_divergence`` below any KL every update is rejected: the
    parameters and the agent's optimizer state go back to the snapshot on
    both sides, and so does the stage's optimizer where the stage comes
    before the learning-rate schedule; after it the stage keeps its moments
    and count (JAX's ``post_update`` fold puts a later hook's own self back:
    ROADMAP Queue 3).  The checkpoint maps equal."""
    hooks = [(*pair, {"index": 0} if stage_first else {}) for *pair, _ in _stage_hooks()]
    jax_agent, agent = build(hooks, compute_dtype="float32", max_kl_divergence=1e-12)
    results = updates_both(jax_agent, agent, (27,))
    assert float(results[0][1]["update_rejected"]) == 1.0 == float(results[0][0]["update_rejected"])
    state, jax_state = agent.state_dict()["agent_state"], jax_agent.state_dict()["agent_state"]
    index = [h.hook_name for h in agent.hooks].index("optimization_stage_aux")
    assert int(state[f"hooks.{index}.opt_state.0.inner_state.count"]) == (0 if stage_first else 20)
    for key, value in state.items():
        np.testing.assert_allclose(value, np.asarray(jax_state[key], value.dtype), err_msg=key, **FP32_TOL[0])


def test_optimization_stage_checkpoint_loads_in_either_package(stage_agents, tmp_path):
    """A JAX checkpoint of the stage agent loads into a fresh port agent
    value for value, and the port's file loads in the JAX package without
    a warning about a path."""
    jax_agent, agent = stage_agents
    jax_file = str(tmp_path / "jax.npz")
    jax_save_checkpoint_file(jax_file, {"agent": jax_agent.state_dict(), "iteration": 2})
    _, fresh = build(_stage_hooks(), compute_dtype="float32")
    with pytest.warns(RuntimeWarning, match="No 'torch_rng' entry"):
        fresh.load_state_dict(load_checkpoint_file(jax_file)["agent"])
    jax_state = jax_agent.state_dict()["agent_state"]
    for key, value in fresh.state_dict()["agent_state"].items():
        np.testing.assert_array_equal(value, np.asarray(jax_state[key], value.dtype), err_msg=key)
    with torch.no_grad():
        fresh.get_hook("optimization_stage_aux").stage_hooks[0].estimator.layers[0].bias.add_(0.5)
    path = str(tmp_path / "port.npz")
    save_checkpoint_file(path, {"agent": fresh.state_dict(), "iteration": 2})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_agent.load_state_dict(jax_load_checkpoint_file(path)["agent"])
    assert not [str(w.message) for w in caught if "checkpoint" in str(w.message).lower()]
    for key, value in fresh.state_dict()["agent_state"].items():
        np.testing.assert_array_equal(value, np.asarray(jax_agent.state_dict()["agent_state"][key], value.dtype),
                                      err_msg=key)


# -- buffer capacity through the Trainer -------------------------------------------


def _trainers(hook_pair, chunk: int):
    """The zoo's Velocity-Rough ``ppo`` Trainer of each package at 16
    environments, widths 16, 4 steps, one minibatch an update and
    ``iterations_per_dispatch=chunk``, with one hook added."""
    trainers = []
    for get, hook, device in ((jax_get_experiment, hook_pair[0], None), (get_experiment, hook_pair[1], "cpu")):
        factory = get("Velocity-Rough", "ppo").to_training_factory()
        factory.environment_kwargs = {"num_instances": 16}
        factory.agent.actor_hidden_dims = factory.agent.critic_hidden_dims = (16,)
        factory.agent.num_steps_per_update = 4
        factory.agent.sampler_epochs = factory.agent.sampler_mini_batches = 1
        factory.iterations_per_dispatch = chunk
        factory.num_iterations = 2 * chunk
        underlying = factory.agent.to_underlying()
        underlying.register_hook(hook, before="value_computation")
        factory.agent = underlying
        trainers.append(factory(verbose=False) if device is None else factory(verbose=False, device=device))
    return trainers


def test_capacity_schedule_takes_effect_at_the_next_chunk_as_in_jax(monkeypatch):
    """4 steps for iterations 0-1, 8 from 2 on, chunks of 4 iterations: on
    both sides the first chunk's four rollouts keep their 4 steps (a chunk
    runs the length it started with), the second chunk's take 8, and every
    row of the first chunk counts 8 steps an environment, the capacity after
    the chunk's schedules (a JAX quirk the port follows: ROADMAP Queue 3)."""
    schedule = lambda it: 4 if it < 2 else 8
    jax_trainer, trainer = _trainers((JaxCapacitySchedule(schedule=schedule),
                                      OnPolicyBufferCapacitySchedule(schedule=schedule)), chunk=4)
    lengths = []
    collect = RolloutDriver.collect
    monkeypatch.setattr(RolloutDriver, "collect",
                        lambda self, num_steps: lengths.append(num_steps) or collect(self, num_steps))
    steps = {"jax": [], "port": []}
    for _ in range(4):
        jax_trainer._rollout_and_update()
        trainer.rollout_and_update()
        steps["jax"].append(jax_trainer.stats.total_steps)
        steps["port"].append(trainer.stats.total_steps)
    assert steps["jax"] == steps["port"] == [8 * 16, 16 * 16, 24 * 16, 32 * 16]
    assert lengths == [4, 4, 4, 4]
    for _ in range(4):
        trainer.rollout_and_update()
    assert lengths == [4, 4, 4, 4, 8, 8, 8, 8]
    assert trainer.agent.num_steps_per_update == trainer.agent.buffer.capacity == 8


def test_capacity_resize_on_the_driver():
    """The port of ``tests/test_buffer_schedule_scan.py``: the driver's
    iteration at the current length, then the schedules (where the resize
    fires): lengths 4, 4, 8, 8, finite metrics and weights."""
    factory = PpoAgentFactory(num_steps_per_update=4, actor_hidden_dims=(16,), critic_hidden_dims=(16,),
                              sampler_epochs=1, sampler_mini_batches=1, normalize_observation=True).to_underlying()
    factory.register_hook(OnPolicyBufferCapacitySchedule(schedule=lambda it: 4 if it < 2 else 8),
                          before="value_computation")
    env = VelocityLocomotionEnv(num_instances=16, observation_dim=12, action_dim=4, device="cpu")
    agent = factory(env.spec, device="cpu", seed=0)
    driver = RolloutDriver(agent, env)
    seen = []
    for _ in range(4):
        seen.append(agent.num_steps_per_update)
        _, stacked, keys = driver.collect_and_update_many(agent.num_steps_per_update, 1)
    assert seen == [4, 4, 8, 8]
    assert torch.isfinite(stacked).all() and len(keys) == 1
    assert torch.isfinite(agent.actor.backbone.layers[0].weight).all()


def test_activation_schedule_inside_a_chunk():
    """``entropy_loss`` switched off from iteration 2 inside a chunk of 4:
    the JAX Trainer's chunk fails to stack iterations with different metric
    counts (a JAX fault the port does not follow: ROADMAP Queue 3); the
    port's Trainer records each iteration's own metrics."""
    jax_trainer, trainer = _trainers((JaxActivationSchedule(target_hook="entropy_loss",
                                                            scheduler=jax_scheduler.LessThan(2)),
                                      HookActivationSchedule(target_hook="entropy_loss",
                                                             scheduler=scheduler.LessThan(2))), chunk=4)
    with pytest.raises(ValueError, match="same shape"):
        jax_trainer._rollout_and_update()
    rows = [trainer.rollout_and_update() for _ in range(4)]
    assert trainer.host_transfers == 1
    assert ["entropy_loss" in row for row in rows] == [True, True, False, False]
    assert all(np.isfinite(v) for row in rows for v in row.values())


# -- memory statistics and the data-parallel guard ---------------------------------


def test_device_memory_stats_record_nothing_on_the_cpu(stage_agents):
    """On the CPU neither package's hook records a thing (JAX's device gives
    no statistics); ``EmptyCudaCache`` is the same hook in both."""
    jax_agent, agent = stage_agents
    hook = DeviceMemoryStats()
    assert EmptyCudaCache is DeviceMemoryStats and not hook.schedule_is_noop(3)
    agent.metrics.clear()
    hook.apply_schedule(3, agent)
    assert not agent.metrics.summary()
    jax_agent.metrics.clear()
    JaxDeviceMemoryStats().apply_schedule(3, jax_agent)
    assert not jax_agent.metrics.summary()


def test_single_process_hooks_raise_under_more_than_one_rank(stage_agents):
    """The stage, the minibatch-wise rate and the minibatch-wise advantage
    normalization take global gradients and statistics under a process
    group now (held against JAX on gloo ranks in
    ``tests/test_torch_distributed_routes.py``): they pass the route check,
    as the schedules and the whole-rollout normalization do, and so does
    tensor parallelism (on gloo ranks in
    ``tests/test_torch_tensor_parallel.py``)."""
    _, agent = stage_agents
    for hook in (OptimizationStage(), MiniBatchWiseLRSchedule(), AdvantageNormalization(mini_batch_wise=True),
                 AdvantageNormalization(), HookParameterSchedule(target_hook="x", parameter="y"),
                 HookActivationSchedule(target_hook="x"), OnPolicyBufferCapacitySchedule(),
                 ConditionalObjectiveActivation.create(), DeviceMemoryStats()):
        assert not hasattr(hook, "data_parallel")
        multiprocess.check_data_parallel_route(types.SimpleNamespace(hooks=[hook]))
    multiprocess.check_data_parallel_route(agent, tensor_parallel=True)

"""The port's zoo, Trainer and their utilities, on the CPU.

The zoo's registered kwargs must equal the JAX package's letter for letter,
and so must its playing and benchmarking factories; a chunked Trainer run
(``iterations_per_dispatch=3`` with checkpoint boundaries every 4
iterations) must give the same per-iteration metrics as an unchunked one,
with one host transfer per chunk.  The Trainer takes a logger, a checkpoint
and a profiler window, and still refuses a non-tensor environment.
"""

import json
import os

import numpy as np
import pytest
import torch

from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu.zoo.registry import list_experiments as jax_list_experiments
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.template.logger import LoggerFactory
from cusrl_tpu_torch.template.player import Player
from cusrl_tpu_torch.template.trainer import EnvironmentStats, Trainer
from cusrl_tpu_torch.utils.metrics import Metrics
from cusrl_tpu_torch.utils.timing import Timer
from cusrl_tpu_torch.zoo.registry import get_experiment, list_experiments


@pytest.mark.parametrize("environment", ["Velocity-Flat", "Velocity-Rough"])
def test_zoo_ppo_entries_match_jax(environment):
    spec, ref = get_experiment(environment, "ppo"), jax_get_experiment(environment, "ppo")
    assert spec.agent_meta_factory_kwargs == ref.agent_meta_factory_kwargs
    assert spec.training_env_factory_kwargs == ref.training_env_factory_kwargs
    assert spec.benchmarking_env_factory_kwargs == ref.benchmarking_env_factory_kwargs
    for name in ("num_iterations", "checkpoint_interval", "iterations_per_dispatch", "experiment_name"):
        assert getattr(spec, name) == getattr(ref, name), name
    assert list_experiments() == jax_list_experiments() and len(list_experiments()) == 42
    for lower in ("to_playing_factory", "to_benchmarking_factory"):
        factory, ref_factory = getattr(spec, lower)(), getattr(ref, lower)()
        assert type(factory).__name__ == type(ref_factory).__name__
        for name in ("environment_kwargs", "num_steps", "num_episodes", "deterministic", "timestep"):
            assert getattr(factory, name) == getattr(ref_factory, name), (lower, name)


def _simulator_entries() -> list[str]:
    from cusrl_tpu.zoo.registry import registry as jax_registry

    jax_list_experiments()
    return sorted(k for k, spec in jax_registry.items() if spec.training_env_factory.__module__.startswith(
        ("cusrl_tpu.environment.isaaclab", "cusrl_tpu.environment.mjlab")))


@pytest.mark.parametrize("key", _simulator_entries())
def test_zoo_simulator_entries_match_jax(key):
    """The 30 IsaacLab, mjlab and robot_lab entries: the registered kwargs,
    factories and player letter for letter; they register without their
    simulators."""
    spec, ref = get_experiment(key), jax_get_experiment(key)
    assert spec.agent_meta_factory_kwargs == ref.agent_meta_factory_kwargs
    assert spec.agent_meta_factory.__name__ == ref.agent_meta_factory.__name__
    for name in ("training_env_factory_kwargs", "playing_env_factory_kwargs", "benchmarking_env_factory_kwargs",
                 "num_iterations", "checkpoint_interval", "iterations_per_dispatch", "experiment_name"):
        assert getattr(spec, name) == getattr(ref, name), name
    for name in ("training_env_factory", "playing_env_factory", "player_factory"):
        got, want = getattr(spec, name), getattr(ref, name)
        assert got.__name__ == want.__name__, name
        assert got.__module__ == want.__module__.replace("cusrl_tpu.", "cusrl_tpu_torch.", 1), name
    assert len(_simulator_entries()) == 30


def test_zoo_factory_builds_the_uncut_agent_with_its_hooks():
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

    factory = get_experiment("Velocity-Rough", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 8}
    trainer = factory(device="cpu", verbose=False)
    kwargs = {k: v for k, v in get_experiment("Velocity-Rough", "ppo").agent_meta_factory_kwargs.items()
              if k in ("normalize_observation", "desired_kl_divergence", "entropy_loss_weight",
                       "fuse_actor_critic_evaluation")}
    assert [h.hook_name for h in trainer.agent.hooks] == [h.hook_name for h in jax_suite(**kwargs)]
    assert [l.output_dim for l in trainer.agent.actor.backbone.layers] == [512, 256, 128]
    assert trainer.iterations_per_dispatch == 10 and trainer.agent.device.type == "cpu"


def _run(iterations_per_dispatch, iterations=7):
    factory = get_experiment("Velocity-Rough", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 32}
    factory.agent.actor_hidden_dims = factory.agent.critic_hidden_dims = (32, 16)
    factory.agent.num_steps_per_update = 8
    factory.num_iterations, factory.checkpoint_interval = iterations, 4
    factory.iterations_per_dispatch = iterations_per_dispatch
    trainer = factory(device="cpu", verbose=False, seed=3)
    rows = [trainer.rollout_and_update() for _ in range(iterations)]
    return rows, trainer


def test_chunked_trainer_matches_unchunked():
    chunked, trainer = _run(3)
    single, single_trainer = _run(1)
    # Chunks of 3 clamp at the checkpoint boundary (4) and the end (7): 3, 1, 3.
    assert trainer.host_transfers == 3 and single_trainer.host_transfers == 7
    assert trainer.agent.iteration == 7
    for a, b in zip(chunked, single):
        assert set(a) == set(b) and "lr_scale" in a and "kl_divergence" in a
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7, err_msg=key)
    assert trainer.stats.total_steps == 7 * 8 * 32


def test_trainer_loop_logs_the_jax_format(capsys):
    factory = get_experiment("Velocity-Flat", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 16}
    factory.agent.actor_hidden_dims = factory.agent.critic_hidden_dims = (16,)
    factory.agent.num_steps_per_update = 4
    factory.num_iterations = 2
    trainer = factory(device="cpu")
    trainer.run_training_loop()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iter     1/2 | reward       n/a | env_fps") and "agent_fps" in lines[1]


def test_trainer_refuses_what_is_not_ported():
    """What the Trainer and the Player refused before the host-loop slice, a
    host ``Environment``, now trains and plays: one iteration of the host
    driver and a few Player steps on ``DummyEnvironment``, continuous
    actions, with the Timer's environment/agent split."""
    from cusrl_tpu_torch.testing.environment import DummyEnvironment

    factory = get_experiment("Velocity-Flat", "ppo").make_agent_factory()
    factory.actor_hidden_dims = factory.critic_hidden_dims = (16,)
    factory.num_steps_per_update = 4
    trainer = Trainer(DummyEnvironment(observation_dim=48, action_dim=12, num_instances=8), factory,
                      num_iterations=1, device="cpu", verbose=False)
    assert trainer.driver is None
    trainer.run_training_loop()
    assert trainer.agent.iteration == 1 and trainer.stats.total_steps == 4 * 8
    player = Player(DummyEnvironment(observation_dim=48, action_dim=12, num_instances=8), factory, device="cpu",
                    num_steps=3, verbose=False)
    summary = player.run_playing_loop()
    assert player.steps_taken == 3 and np.isfinite(summary["step_reward"])


@pytest.mark.parametrize("option", ["logger_factory", "checkpoint", "profile_dir"])
def test_trainer_takes_what_was_refused(option, tmp_path):
    """The three options the Trainer refused before this slice: a logger
    (run directory, metadata, checkpoints), a checkpoint to resume from, and a
    profiler window."""
    env = VelocityLocomotionEnv(num_instances=16, device="cpu")
    factory = get_experiment("Velocity-Flat", "ppo").make_agent_factory()
    factory.actor_hidden_dims = factory.critic_hidden_dims = (16,)
    factory.num_steps_per_update = 8
    kwargs = {
        "logger_factory": dict(logger_factory=LoggerFactory(log_dir=str(tmp_path)), metadata={"k": 1}),
        "checkpoint": dict(checkpoint={"agent": Trainer(env, factory, device="cpu").agent.state_dict(),
                                       "stats": {"total_steps": 128}, "iteration": 1}),
        "profile_dir": dict(profile_dir=str(tmp_path / "trace"), profile_iterations=(1, 2)),
    }[option]
    trainer = Trainer(env, factory, num_iterations=2, device="cpu", verbose=False, **kwargs)
    trainer.run_training_loop()
    assert trainer.agent.iteration == 2
    if option == "logger_factory":
        assert json.load(open(os.path.join(trainer.logger.info_dir, "metadata.json"))) == {"k": 1}
        assert os.listdir(trainer.logger.ckpt_dir) == ["ckpt_2.npz"]
    elif option == "checkpoint":
        assert trainer.host_transfers == 1 and trainer.stats.total_steps == 128 + 8 * 16
    else:
        assert os.path.isfile(tmp_path / "trace" / "trace.json")


def test_metrics_timer_and_environment_stats():
    metrics = Metrics()
    metrics.record({"a": torch.tensor(1.0), "b": 2.0})
    metrics.record(a=torch.tensor([3.0, 5.0]))
    assert metrics.summary("Train") == {"Train/a": 3.0, "Train/b": 2.0}
    metrics.clear()
    assert metrics.summary() == {}
    timer = Timer(synchronize=True)
    with timer.record("x"):
        pass
    timer.add("x", 1.0)
    assert timer.total("x") >= 1.0
    timer.clear()
    assert timer.total("x") == 0.0
    stats = EnvironmentStats(max_episodes=3)
    stats.track_aggregates(2.0, 4.0, 20.0, 10)
    stats.track_aggregates(0.0, 0.0, 0.0, 10)
    stats.track_aggregates(2.0, 8.0, 40.0, 10)
    assert stats.summary() == {"Environment/episode_reward": 3.0, "Environment/episode_length": 15.0}
    assert stats.total_steps == 30

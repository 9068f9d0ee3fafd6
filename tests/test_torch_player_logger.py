"""The port's Player, Logger backends, SaveTransition and the Trainer's
checkpoint and profiler cadence, on the CPU, against the JAX package where it
has a counterpart: the Player's summary keys on the same checkpoint, the
jsonl logger's interval averages on the same scalar stream, the
SaveTransition shards on the same transitions; the tensorboard backend
writes an event file, wandb and swanlab log through fake modules (as
``tests/test_logging_and_save_transition.py`` does) and a missing package
raises ``ImportError`` naming it; the Trainer saves at every interval and at
the end, and ``profile_dir`` writes a trace of its window."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.hook.player.save_transition import SaveTransition as JaxSaveTransition
from cusrl_tpu.template.logger import make_logger_factory as jax_make_logger_factory
from cusrl_tpu.template.player import Player as JaxPlayer
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.hook.player.save_transition import SaveTransition
from cusrl_tpu_torch.template.logger import LoggerFactory, make_logger_factory
from cusrl_tpu_torch.template.player import Player, PlayerHook
from cusrl_tpu_torch.template.trial import Trial
from cusrl_tpu_torch.zoo.registry import get_experiment

SMALL = dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 32), num_steps_per_update=8)


def _factories():
    jf = jax_get_experiment("Velocity-Flat", "ppo").make_agent_factory()
    tf = get_experiment("Velocity-Flat", "ppo").make_agent_factory()
    for f in (jf, tf):
        for key, value in SMALL.items():
            setattr(f, key, value)
    return jf, tf


class _Recorder(PlayerHook):
    def __init__(self):
        self.calls = []

    def init(self, player):
        self.calls.append("init")

    def step(self, player, transition):
        self.calls.append(("step", sorted(transition)))

    def reset(self, player, indices):
        self.calls.append(("reset", list(indices)))

    def close(self, player):
        self.calls.append("close")


@pytest.mark.parametrize("num_steps", [3, 12])
def test_player_summary_keys_match_jax(num_steps, capsys):
    """The same JAX checkpoint in both Players (8 environments, 5-step
    episodes, unpaced): the same summary keys (episodes finish only in the
    12-step run), finite values, the box-drawn table, and hooks that see
    every step and every reset."""
    jf, tf = _factories()
    checkpoint = {"agent": jf(JaxEnv(num_instances=8).spec).state_dict()}
    jax_player = JaxPlayer(JaxEnv(num_instances=8, episode_length=5), jf, checkpoint=checkpoint, num_steps=num_steps,
                           timestep=0, verbose=False)
    recorder = _Recorder()
    player = Player(VelocityLocomotionEnv(num_instances=8, episode_length=5, device="cpu"), tf, checkpoint=checkpoint,
                    num_steps=num_steps, timestep=0, hooks=(recorder,))
    summary = player.run_playing_loop()
    assert set(summary) == set(jax_player.run_playing_loop())
    assert set(summary) == ({"step_reward"} | ({"episode_reward", "episode_length"} if num_steps > 5 else set()))
    assert all(np.isfinite(v) for v in summary.values())
    if num_steps > 5:
        assert summary["episode_length"] == 5.0
    out = capsys.readouterr().out
    assert out.startswith("┌") and "step_reward" in out
    assert recorder.calls[0] == "init" and recorder.calls[-1] == "close"
    assert recorder.calls.count(("step", ["reward", "terminated", "truncated"])) == num_steps
    assert [c for c in recorder.calls if c[0] == "reset"] == [("reset", list(range(8)))] * (num_steps // 5)
    assert player.agent.inference_mode and player.agent.get_hook("observation_normalization").frozen


def test_jsonl_interval_averaging_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    stream = [{"a": float(rng.standard_normal()), "b": float(rng.random())} for _ in range(7)]
    rows = []
    for make, where in ((make_logger_factory, "port"), (jax_make_logger_factory, "jax")):
        logger = make("jsonl", log_dir=str(tmp_path / where), interval=3)("run")
        for iteration, scalars in enumerate(stream):
            logger.log_scalars(scalars if iteration != 4 else {"a": scalars["a"]}, iteration)
        logger.close()
        rows.append([json.loads(line) for line in open(os.path.join(logger.log_dir, "metrics.jsonl"))])
        assert os.path.realpath(tmp_path / where / "latest") == os.path.realpath(logger.log_dir)
    assert rows[0] == rows[1] and len(rows[0]) == 2


def test_tensorboard_writes_an_event_file(tmp_path):
    pytest.importorskip("tensorboard")
    logger = make_logger_factory("tensorboard", log_dir=str(tmp_path))("run")
    logger.log_scalars({"x": 1.0}, 0)
    logger.close()
    assert any(name.startswith("events.out.tfevents") for name in os.listdir(logger.log_dir))


@pytest.mark.parametrize("backend", ["wandb", "swanlab"])
def test_optional_backends_log_through_fake_modules(tmp_path, monkeypatch, backend):
    calls = []

    class _Run:
        def log(self, scalars, step=None):
            calls.append((dict(scalars), step))

        def finish(self):
            calls.append("finish")

    fake = types.ModuleType(backend)
    fake.init = lambda **kwargs: _Run()
    monkeypatch.setitem(sys.modules, backend, fake)
    logger = make_logger_factory(backend, log_dir=str(tmp_path))("run")
    logger.log_scalars({"m": 7.0}, iteration=11)
    assert calls == [({"m": 7.0}, 11)]
    monkeypatch.setitem(sys.modules, backend, None)  # the package missing
    with pytest.raises(ImportError, match=backend):
        make_logger_factory(backend, log_dir=str(tmp_path))("run")
    with pytest.raises(ValueError, match="Unknown logger backend"):
        make_logger_factory("nope", log_dir=str(tmp_path))("run")


@pytest.mark.parametrize("save_interval", [None, 3])
def test_save_transition_shards_match_jax(tmp_path, save_interval):
    rng = np.random.default_rng(1)
    steps = [{"observation": rng.standard_normal((4, 3)).astype(np.float32),
              "reward": rng.standard_normal((4, 1)).astype(np.float32),
              "terminated": rng.random((4, 1)) < 0.3, "ignored": np.zeros(4)} for _ in range(7)]
    for hook, where, convert in ((SaveTransition, "port", torch.from_numpy), (JaxSaveTransition, "jax", np.asarray)):
        saver = hook(output_path=tmp_path / where / "tr", keys=("observation", "reward", "terminated"),
                     save_interval=save_interval)
        saver.init(None)
        for step in steps:
            saver.step(None, {k: convert(v) for k, v in step.items()})
        saver.close(None)
    port, jax_files = sorted(os.listdir(tmp_path / "port")), sorted(os.listdir(tmp_path / "jax"))
    assert port == jax_files and len(port) == (1 if save_interval is None else 3)
    for name in port:
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])


def _trainer(tmp_path):
    factory = get_experiment("Velocity-Flat", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": 32}
    for key, value in SMALL.items():
        setattr(factory.agent, key, value)
    factory.num_iterations, factory.checkpoint_interval = 5, 2
    return factory(logger_factory=LoggerFactory(log_dir=str(tmp_path / "logs")), verbose=False, device="cpu")


def test_trainer_checkpoints_at_every_interval_and_the_end(tmp_path):
    """Chunks of up to 10 clamp to the checkpoints (2, 4) and the end (5)."""
    trainer = _trainer(tmp_path)
    trainer.run_training_loop()
    assert trainer.host_transfers == 3
    assert sorted(os.listdir(trainer.logger.ckpt_dir)) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_5.npz"]
    checkpoint = Trial(str(tmp_path / "logs"), checkpoint="4").load_checkpoint()
    assert checkpoint["iteration"] == 4 and checkpoint["stats"] == {"total_steps": 4 * 8 * 32}
    assert checkpoint["environment"] == {} and checkpoint["agent"]["agent_state"]["iteration"] == 4


def test_trainer_profile_dir_writes_a_trace(tmp_path):
    """The window (1, 3): chunks also clamp to its ends, so they end at 1, 2,
    3, 4 and 5."""
    trainer = _trainer(tmp_path)
    trainer.profile_dir, trainer.profile_iterations = str(tmp_path / "trace"), (1, 3)
    trainer.run_training_loop()
    assert trainer.host_transfers == 5
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert trace["traceEvents"]

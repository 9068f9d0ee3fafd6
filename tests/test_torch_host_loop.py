"""The host-loop driver of the port against the JAX package's, on the CPU:
the host environments (``NativeCartPoleEnv`` across its 500-step
truncation, ``DummyEnvironment`` and the gym adapters on the same seeds and
actions, arrays held exactly), one whole iteration of path H (the zoo's
``CartPole-v1``/``ppo`` entry as registered: tanh 4-64-64, 8 environments, 32
steps, 20 epochs of one 256-row minibatch) through the JAX Trainer and the
port's, the Player's deterministic actions on a host environment, and the
CLI on the gym entry.

Both sides of the iteration start from the JAX agent's weights
(``load_jax_state``), take the JAX agent's actions (replayed through the
categorical's Gumbel noise: a large value on the JAX action's class) and
the JAX sampler's minibatch permutations.  In bf16 the port runs its
kernels' plain versions (``Mlp._can_fuse`` without "on CUDA"), the JAX
package its XLA layers.  Observations are held exactly, the metrics at
``BF16_TOL`` (``tests/test_torch_update_zoo.py``).  The JAX package's
``NativeCartPoleEnv`` loads the library the port builds from the same
source, so neither writes beside it."""

import random

import numpy as np
import pytest
import torch

import cusrl_tpu.environment.native as jax_native
from cusrl_tpu.environment.native import NativeCartPoleEnv as JaxNativeCartPoleEnv
from cusrl_tpu.template.player import Player as JaxPlayer
from cusrl_tpu.template.trainer import Trainer as JaxTrainer
from cusrl_tpu.testing.environment import DummyEnvironment as JaxDummyEnvironment
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu.zoo.registry import registry as jax_registry
from cusrl_tpu_torch.__main__ import main
from cusrl_tpu_torch.environment.native import NativeCartPoleEnv, build_native_library
from cusrl_tpu_torch.nn.kernels.fused_mlp import LAUNCHES, reset_launch_counts
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.template.player import Player
from cusrl_tpu_torch.template.trainer import Trainer
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

BF16_TOL = dict(rtol=1e-3, atol=1e-4)  # the metrics' of tests/test_torch_update_zoo.py
ENTRY = ["-env", "CartPole-v1", "-alg", "ppo", "--device", "cpu"]


@pytest.fixture
def jax_native_library(monkeypatch):
    monkeypatch.setattr(jax_native, "build_native_library", lambda force=False: build_native_library())


def _balance(observation):
    """A linear controller that keeps most poles up past the 500-step truncation."""
    o = np.asarray(observation)
    return (o[:, 2] + 0.5 * o[:, 3] + 0.05 * o[:, 0] + 0.1 * o[:, 1] > 0).astype(int)


def test_native_cartpole_matches_jax(jax_native_library):
    env, jax_env = NativeCartPoleEnv(4, seed=1), JaxNativeCartPoleEnv(4, seed=1)
    assert env.spec.autoreset is False and (env.spec.observation_dim, env.spec.action_dim) == (4, 2)
    observation, _, _ = env.reset()
    np.testing.assert_array_equal(observation, jax_env.reset()[0])
    rng = np.random.default_rng(0)
    truncations = terminations = 0
    for _ in range(650):
        action = _balance(observation)
        action[3] = rng.integers(2)  # one instance acts at random and terminates often
        one_hot = np.eye(2, dtype=np.float32)[action]
        got, want = env.step(one_hot), jax_env.step(one_hot)
        for a, b in zip(got[:5], want[:5]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        observation, terminated, truncated = got[0], got[3], got[4]
        truncations, terminations = truncations + int(truncated.sum()), terminations + int(terminated.sum())
        done = np.nonzero((terminated | truncated)[:, 0])[0]
        if done.size:
            new, _, _ = env.reset(indices=done)
            np.testing.assert_array_equal(new, jax_env.reset(indices=done)[0])
            observation = observation.copy()
            observation[done] = new[done]
    assert truncations >= 1 and terminations >= 1
    np.testing.assert_array_equal(env.step(action)[0], jax_env.step(action)[0])  # indices as well as one-hot


def test_dummy_environment_matches_jax():
    kwargs = dict(observation_dim=5, action_dim=2, num_instances=6, state_dim=3, reward_dim=2, done_prob=0.3,
                  seed=4, timestep=0.02, custom=1)
    env, jax_env = DummyEnvironment(**kwargs), JaxDummyEnvironment(**kwargs)
    assert env.spec.extras == jax_env.spec.extras == {"custom": 1} and env.spec.get("custom") == 1
    assert env.spec.timestep == 0.02 and env.spec.state_dim == 3
    for got, want in zip(env.reset()[:2], jax_env.reset()[:2]):
        np.testing.assert_array_equal(got, want)
    for _ in range(20):
        action = np.zeros((6, 2), np.float32)
        for got, want in zip(env.step(action)[:5], jax_env.step(action)[:5]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", ["CartPole-v1", "Pendulum-v1"])
def test_gym_adapters_match_jax(task):
    pytest.importorskip("gymnasium")
    from cusrl_tpu.environment.gym import make_gym_env as jax_make_gym_env
    from cusrl_tpu.environment.gym import make_gym_vec as jax_make_gym_vec
    from cusrl_tpu_torch.environment.gym import make_gym_env, make_gym_vec

    rng = np.random.default_rng(5)
    for vectorized in (True, False):
        pair = []
        for make in ((make_gym_vec, jax_make_gym_vec) if vectorized else (make_gym_env, jax_make_gym_env)):
            random.seed(11)  # the adapters seed their environments from Python's generator
            pair.append(make(task, num_envs=3) if vectorized else make(task))
        env, jax_env = pair
        assert (env.spec.observation_dim, env.spec.action_dim, env.num_instances) == (
            jax_env.spec.observation_dim, jax_env.spec.action_dim, jax_env.num_instances)
        assert env.spec.action_space == jax_env.spec.action_space and "gym_spec" in env.spec.extras
        np.testing.assert_array_equal(env.reset()[0], jax_env.reset()[0])
        n = env.num_instances
        for _ in range(40):
            if task == "CartPole-v1":
                action = np.eye(2, dtype=np.float32)[rng.integers(2, size=n)]
            else:
                action = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
            got, want = env.step(action), jax_env.step(action)
            for a, b in zip(got[:5], want[:5]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            done = np.nonzero((got[3] | got[4])[:, 0])[0]
            if done.size:
                np.testing.assert_array_equal(env.reset(indices=done)[0], jax_env.reset(indices=done)[0])
        env.close()
        jax_env.close()


def _entry_factories():
    return (jax_get_experiment("CartPole-v1", "ppo").make_agent_factory(),
            get_experiment("CartPole-v1", "ppo").make_agent_factory())


def test_path_h_iteration_matches_jax(monkeypatch, jax_native_library):
    """One host-loop iteration of path H at its registered size, the JAX
    Trainer against the port's, on the same weights, actions and plan."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: x.dim() >= 2 and all(
        l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))
    jf, tf = _entry_factories()
    jax_trainer = JaxTrainer(JaxNativeCartPoleEnv(8, seed=3), jf, num_iterations=1, verbose=False)
    trainer = Trainer(NativeCartPoleEnv(8, seed=3), tf, num_iterations=1, verbose=False, device="cpu")
    jax_agent, agent = jax_trainer.agent, trainer.agent
    assert (agent.num_steps_per_update, agent.parallelism, agent.sampler.num_epochs) == (32, 8, 20)
    assert type(agent.actor.distribution).__name__ == "OneHotCategoricalDist"
    assert [l.weight.shape[1] for l in agent.actor.backbone.layers] == [4, 64]
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])

    actions, captured = [], {}
    jax_step = jax_trainer.environment.step
    jax_trainer.environment.step = lambda action: (actions.append(np.argmax(np.asarray(action), -1)),
                                                   jax_step(action))[1]
    jax_update = jax_agent._get_update_jit()

    def spy(state, rollout, key, buffer_state):
        captured.update(rollout=rollout, key=key, buffer_state=buffer_state)
        return jax_update(state, rollout, key, buffer_state)

    jax_agent._update_jit = spy
    jax_metrics = jax_trainer._rollout_and_update()
    rollout = captured["rollout"]
    _, perms, _ = jax_agent.sampler.make_epoch_plan(captured["key"], 32, 8, rollout)

    sample = agent.actor.distribution.sample
    replay = list(actions)
    agent.actor.distribution.sample = lambda params, generator=None, noise=None: sample(
        params, generator, torch.nn.functional.one_hot(torch.from_numpy(replay.pop(0)), 2).float() * 1e6)
    update_body = agent.update_body
    seen = {}

    def update_with_jax_plan(rollout, epoch_perms=None, buffer_state=None):
        seen["buffer_state"] = buffer_state
        return update_body(rollout, np.asarray(perms), buffer_state)

    agent.update_body = update_with_jax_plan
    reset_launch_counts()
    metrics = trainer.rollout_and_update()
    assert not replay and not any(LAUNCHES.values())  # the plain versions on the CPU
    assert seen["buffer_state"] == {"cursor": int(captured["buffer_state"]["cursor"]),
                                    "full": bool(captured["buffer_state"]["full"])} == {"cursor": 0, "full": True}
    data = agent.buffer.data
    for key in ("observation", "next_observation", "terminated", "truncated", "reward"):
        np.testing.assert_array_equal(data[key].numpy(), np.asarray(rollout[key]), err_msg=key)
    np.testing.assert_array_equal(data["action"].argmax(-1).numpy(), np.asarray(rollout["action"]).argmax(-1))
    assert bool(data["terminated"].any())  # episodes end inside the rollout
    assert set(metrics) == set(jax_metrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key], float(jax_metrics[key]), err_msg=key, **BF16_TOL)
    assert trainer.stats.total_steps == jax_trainer.stats.total_steps == 32 * 8
    assert trainer.stats.summary() == pytest.approx(jax_trainer.stats.summary(), rel=1e-12)
    assert agent.iteration == jax_agent.iteration == 1


def test_player_deterministic_actions_match_jax(monkeypatch, jax_native_library):
    """The Player on ``NativeCartPoleEnv(8)`` from a JAX checkpoint: the
    port's deterministic actions (the categorical's mode) are the JAX
    package's ``determine``, step for step, and the summaries agree (fp32)."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    jf, tf = _entry_factories()
    checkpoint = {"agent": jf(JaxNativeCartPoleEnv(8).spec).state_dict()}
    recorded = []
    players = []
    for make_player, make_env, factory, kwargs in (
            (JaxPlayer, JaxNativeCartPoleEnv, jf, {}), (Player, NativeCartPoleEnv, tf, {"device": "cpu"})):
        env, steps = make_env(8, seed=5), []
        env_step = env.step
        env.step = lambda action, env_step=env_step, steps=steps: (steps.append(np.asarray(action)),
                                                                   env_step(action))[1]
        with pytest.warns(RuntimeWarning) if make_player is Player else _no_warning():
            player = make_player(env, factory, checkpoint=checkpoint, num_steps=80, timestep=0, verbose=False,
                                 **kwargs)
        players.append((player, player.run_playing_loop()))
        recorded.append(np.stack(steps))
    (jax_player, jax_summary), (player, summary) = players
    np.testing.assert_array_equal(recorded[1], recorded[0])
    assert set(np.unique(recorded[1])) == {0.0, 1.0} and player.steps_taken == 80
    assert set(summary) == set(jax_summary) and "episode_reward" in summary
    for key in summary:
        np.testing.assert_allclose(summary[key], jax_summary[key], rtol=1e-6, err_msg=key)
    observation = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    latent, _, _ = jax_player.agent.state.actor.backbone(observation)
    np.testing.assert_array_equal(player.agent.act(observation),
                                  np.asarray(jax_player.agent.state.actor.distribution.determine(latent)))


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cli_trains_plays_and_benchmarks_the_gym_entry(tmp_path, capsys):
    pytest.importorskip("gymnasium")
    logs = tmp_path / "logs"
    trainer = main(["train", *ENTRY, "--num-iterations", "2", "--logger", "jsonl", "--seed", "0",
                    "--log-dir", str(logs), "--quiet"])
    assert trainer.agent.iteration == 2 and trainer.driver is None
    assert trainer.stats.total_steps == 2 * 32 * 8 and trainer.agent.device.type == "cpu"
    assert (logs / "latest" / "ckpt" / "ckpt_2.npz").is_file()
    capsys.readouterr()
    for command, extra, overrides in (("play", ["--num-steps", "20"], ["--", "--environment_kwargs.render_mode", "none"]),
                                      ("benchmark", ["--num-steps", "12"], [])):
        player = main([command, *ENTRY, "--log-dir", str(logs), "--checkpoint", str(logs / "latest"), *extra,
                       *overrides])
        assert "step_reward" in capsys.readouterr().out
        assert player.agent.inference_mode and player.steps_taken == int(extra[1])
        assert player.environment.num_instances == (1 if command == "play" else 8)
    # The exported graph gives the categorical's mode: the one-hot argmax.
    from cusrl_tpu_torch.export import load_exported_graph

    main(["export", *ENTRY, "--log-dir", str(logs), "--checkpoint", str(logs / "latest"), "-o",
          str(tmp_path / "graph"), "--batch-size", "8", "--", "--environment_kwargs.render_mode", "none"])
    call, _ = load_exported_graph(str(tmp_path / "graph"))
    observation = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
    with torch.no_grad():
        logits = trainer.agent.actor(torch.from_numpy(observation))[0]["logits"]
    want = torch.nn.functional.one_hot(logits.argmax(-1), 2).float()
    torch.testing.assert_close(call({"observation": torch.from_numpy(observation)})["action"], want)
    capsys.readouterr()
    main(["list-experiments"])
    listed = capsys.readouterr().out.split()
    assert {"CartPole-v1_ppo", "Pendulum-v1_ppo", "MountainCar-v0_ppo", "BipedalWalker-v3_ppo"} <= set(listed)
    jax_get_experiment("CartPole-v1", "ppo")  # loads the JAX registry
    jax_gym = {name for name, spec in jax_registry.items()
               if spec.training_env_factory.__module__ == "cusrl_tpu.environment.gym"}
    assert len(jax_gym) == 7 and {name for name in listed if get_experiment(name).training_env_factory.__module__
                                  == "cusrl_tpu_torch.environment.gym"} == jax_gym
    for name in jax_gym:  # the entries' kwargs are the JAX entries'
        spec, ref = get_experiment(name), jax_registry[name]
        assert spec.agent_meta_factory_kwargs == ref.agent_meta_factory_kwargs
        assert spec.training_env_factory_kwargs == ref.training_env_factory_kwargs
        assert spec.playing_env_factory_kwargs == ref.playing_env_factory_kwargs
        assert (spec.num_iterations, spec.checkpoint_interval) == (ref.num_iterations, ref.checkpoint_interval)

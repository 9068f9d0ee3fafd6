"""The port's environment, acting and rollout driver on the CPU, against the
JAX package where both compute the same thing.

Tolerances: fp32 at 1e-5 (summation order of the small matmuls only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.preset.ppo import PpoAgentFactory as JaxPpoFactory
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils.config import CONFIG, resolve_device
from cusrl_tpu_torch.utils.interop import load_jax_state

FP32 = dict(rtol=1e-5, atol=1e-5)
N, OBS, ACT = 16, 12, 3


def _envs(episode_length=1000):
    jax_env = JaxEnv(num_instances=N, observation_dim=OBS, action_dim=ACT, episode_length=episode_length, seed=3)
    env = VelocityLocomotionEnv(num_instances=N, observation_dim=OBS, action_dim=ACT, episode_length=episode_length,
                                device="cpu", actuation=np.asarray(jax_env._actuation),
                                obs_proj=np.asarray(jax_env._obs_proj))
    return jax_env, env


def test_env_step_matches_jax():
    jax_env, env = _envs(episode_length=50)
    rng = np.random.default_rng(0)
    state = {
        "pos": (rng.standard_normal((N, 2)) * 10).astype(np.float32),
        "vel": rng.standard_normal((N, 2)).astype(np.float32),
        "command": rng.uniform(-1, 1, (N, 2)).astype(np.float32),
        "last_action": rng.uniform(-1, 1, (N, ACT)).astype(np.float32),
        "steps": rng.integers(0, 49, N).astype(np.int32),
    }
    state["steps"][:3] = 49  # truncate now
    state["pos"][3] = [49.999, 0.0]  # leave the arena now
    state["vel"][3] = [5.0, 0.0]
    action = rng.uniform(-1.5, 1.5, (N, ACT)).astype(np.float32)

    jax_state = jax.tree.map(jnp.asarray, state)
    jnew, jrew, jterm, jtrunc, _ = jax_env.step_fn(jax_state, jnp.asarray(action), jax.random.key(0))
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    tnew, trew, tterm, ttrunc, _ = env.step_fn(tstate, torch.from_numpy(action), torch.Generator().manual_seed(0))

    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    assert ttrunc[:3].all() and tterm[3].all()
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **FP32)
    reset = (tterm | ttrunc).numpy()[:, 0]
    for key in ("pos", "vel", "last_action", "steps"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), err_msg=key, **FP32)
    # Commands are redrawn from each side's own generator on reset rows only.
    np.testing.assert_array_equal(tnew["command"].numpy()[~reset], np.asarray(jnew["command"])[~reset])
    tobs, _ = env.observe_fn(tnew)
    jobs, _ = jax_env.observe_fn(jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in tnew.items()}))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **FP32)


def test_act_with_injected_noise_matches_jax(monkeypatch):
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)  # JAX weights independent of earlier tests
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    jax_env, env = _envs()
    kwargs = dict(actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16), activation_fn="elu")
    jax_agent = JaxPpoFactory(**kwargs)(jax_env.spec)
    agent = PpoAgentFactory(**kwargs)(env.spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((N, OBS)).astype(np.float32)
    noise = rng.standard_normal((N, ACT)).astype(np.float32)
    action = agent.act(torch.from_numpy(obs), noise=torch.from_numpy(noise))
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    want = dist["mean"] + dist["std"] * noise
    np.testing.assert_allclose(action.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(agent.transition["action_logp"].numpy(),
                               np.asarray(jax_agent.state.actor.compute_logp(dist, want)), **FP32)


def test_collect_and_update_runs_end_to_end_on_cpu():
    env = VelocityLocomotionEnv(num_instances=32, observation_dim=16, action_dim=4, episode_length=10, device="cpu")
    agent = PpoAgentFactory(num_steps_per_update=8, actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                            activation_fn="elu", lr=1e-3, entropy_loss_weight=0.005,
                            fuse_actor_critic_evaluation=True)(env.spec, device="cpu")
    before = {k: v.detach().clone() for k, v in agent.model.named_parameters()}
    driver = RolloutDriver(agent, env)
    for _ in range(2):
        aggregates, metrics = driver.collect_and_update(8)
    assert agent.iteration == 2
    assert aggregates.shape == (3,) and float(aggregates[0]) == 32  # every episode of 10 steps ended once in 16
    assert float(aggregates[2]) == 32 * 10
    assert {"value_loss", "surrogate_loss", "entropy_loss", "kl_divergence", "grad_norm/default"} <= set(metrics)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(before[k], v) for k, v in agent.model.named_parameters())


def test_host_loop_act_step_update():
    env = VelocityLocomotionEnv(num_instances=8, observation_dim=16, action_dim=4, device="cpu")
    agent = PpoAgentFactory(num_steps_per_update=4, actor_hidden_dims=(16,), critic_hidden_dims=(16,),
                            sampler_mini_batches=2)(env.spec, device="cpu")
    state = env.init_fn(agent.generator)
    obs, _ = env.observe_fn(state)
    should_update = False
    while not should_update:
        action = agent.act(obs)
        state, reward, terminated, truncated, _ = env.step_fn(state, action, agent.generator)
        obs, _ = env.observe_fn(state)
        should_update = agent.step(obs, reward, terminated, truncated)
    metrics = agent.update()
    assert agent.iteration == 1 and agent.step_index == 0 and all(np.isfinite(v) for v in metrics.values())
    # The ring holds the rollout it updated on, as the JAX agent's does: full, the cursor back at 0.
    assert agent.buffer.full and agent.buffer.cursor == 0 and agent.buffer["observation"].shape == (4, 8, 16)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VelocityLocomotionEnv(num_instances=4)
    assert resolve_device("cpu") == torch.device("cpu")

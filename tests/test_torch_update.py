"""One whole PPO update of the port against the JAX package's, at small size.

Both agents are the slice's configuration (the Velocity-Rough ``ppo`` kwargs
without observation normalization and with a fixed learning rate) at narrow
widths.  The port takes the JAX agent's weights through ``load_jax_state``;
both update on the same injected rollout (made with numpy from a seed, with
actions sampled from the JAX actor) and the same epoch permutations, taken
from the JAX sampler's ``make_epoch_plan`` with the key given to
``update_body``.  On the CPU the JAX side runs its plain XLA chain and the
stacked joint evaluation; so does the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.preset.ppo import PpoAgentFactory as JaxPpoFactory
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state

T, N, OBS, ACT = 8, 64, 16, 4  # 512 rows: 4 minibatches of one 128-row tile each
SLICE_KWARGS = dict(
    num_steps_per_update=T,
    actor_hidden_dims=(32, 16),
    critic_hidden_dims=(32, 16),
    activation_fn="elu",
    lr=1e-3,
    sampler_epochs=5,
    sampler_mini_batches=4,
    entropy_loss_weight=0.005,
    fuse_actor_critic_evaluation=True,
)


def _rollout(jax_agent, seed):
    rng = np.random.default_rng(seed)
    obs = np.tanh(rng.standard_normal((T, N, OBS))).astype(np.float32)
    next_obs = np.concatenate([obs[1:], np.tanh(rng.standard_normal((1, N, OBS)))], 0).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    noise = rng.standard_normal((T, N, ACT)).astype(np.float32)
    action = dist["mean"] + dist["std"] * noise
    logp = jax_agent.state.actor.compute_logp(dist, action)
    terminated = rng.random((T, N, 1)) < 0.05
    truncated = rng.random((T, N, 1)) < 0.05
    return {
        "observation": obs,
        "next_observation": next_obs,
        "action": np.asarray(action),
        "action_logp": np.asarray(logp),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, N, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
        "done": terminated | truncated,
    }


def _run_both(compute_dtype, monkeypatch):
    # The JAX agent draws its weights from the process-wide seed and key
    # counter; pin both so the weights do not depend on the tests run before.
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    jax_env = JaxEnv(num_instances=N, observation_dim=OBS, action_dim=ACT)
    jax_agent = JaxPpoFactory(**SLICE_KWARGS)(jax_env.spec)
    env = VelocityLocomotionEnv(num_instances=N, observation_dim=OBS, action_dim=ACT, device="cpu")
    agent = PpoAgentFactory(**SLICE_KWARGS)(env.spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])

    rollout = _rollout(jax_agent, seed=11)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    key = jax.random.key(5)
    _, perms, batch_size = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    assert batch_size == 128 and perms.shape == (5, 4)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)

    torch_rollout = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rollout)
    metrics = agent.update_body(torch_rollout, epoch_perms=np.array(perms))
    new_params = {p: np.asarray(v) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic."))}
    return jax_metrics, metrics, new_params, agent


def _compare(jax_metrics, metrics, new_params, agent, metric_tol, param_tol):
    assert set(metrics) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), err_msg=key, **metric_tol)
    params = dict(agent.model.named_parameters())
    assert set(params) == set(new_params)
    for path, expected in new_params.items():
        np.testing.assert_allclose(params[path].detach().numpy(), expected, err_msg=path, **param_tol)


def test_update_matches_jax_in_fp32(monkeypatch):
    """All fp32 on both sides: the point is the algorithm.  What remains is
    fp32 summation order (XLA:CPU and PyTorch block their matmuls and
    reductions differently), carried through 20 Adam steps of lr 1e-3:
    measured at ~3e-7 on parameters and ~3e-6 on metrics."""
    _compare(*_run_both(None, monkeypatch), metric_tol=dict(rtol=1e-5, atol=5e-6), param_tol=dict(rtol=0, atol=2e-6))


def test_update_matches_jax_in_bf16(monkeypatch):
    """bf16 backbones on both sides (the default policy).  A bf16 rounding of
    an activation or a cotangent can land on the other side of a rounding
    boundary (XLA:CPU fuses and accumulates differently), a 2^-8 relative
    step.  Metrics move by ~6e-5; a weight whose gradient sits near zero can
    take Adam steps of the other sign, so weights are held to a few lr-sized
    (1e-3) steps.  Such a step in the value head moves the mean ``value`` by
    up to ~8e-4 for some initial weights (seed 7, key counter 7); the pinned
    weights measure 0.4 of the metric tolerance."""
    _compare(*_run_both("bfloat16", monkeypatch), metric_tol=dict(rtol=1e-3, atol=1e-4),
             param_tol=dict(rtol=0, atol=3e-3))

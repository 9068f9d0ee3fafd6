"""One whole PPO update of the zoo's Velocity-Rough configuration, port
against JAX package, at small widths, for the three update paths:

A: the zoo's hooks (observation normalization, joint evaluation, adaptive LR);
B: A with ``JointPolicyValueEvaluation(fuse_heads=True)`` (K8);
C: A with ``fused_ppo_update=True`` (K9, split mode).

The port takes the JAX agent's weights and hook state through
``load_jax_state``; both update on the same injected rollout (made with numpy
from a seed, actions sampled from the JAX actor) and the same epoch
permutations, taken from the JAX sampler's plan.  On the CPU the JAX package
runs its XLA references.  In bf16 the port is forced onto its kernel paths
(``Mlp._can_fuse`` without "on CUDA"), so the plain versions of K2/K8/K9 run;
in fp32 the kernels do not apply (they are bf16) and both sides run their
plain chains (for C the bf16 reference).  Tolerances as
tests/test_torch_update.py: fp32 to summation order (metrics rtol 1e-5,
parameters 2e-6), bf16 to one rounding carried through 20 Adam steps
(metrics rtol 1e-3 / atol 1e-4, parameters 3e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.hook.on_policy.joint_eval import JointPolicyValueEvaluation as JaxJointEval
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.hook.on_policy.joint_eval import JointPolicyValueEvaluation
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.nn.kernels.fused_mlp import LAUNCHES, reset_launch_counts
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

T, N, OBS, ACT = 8, 64, 16, 4  # 512 rows: 4 minibatches of one 128-row tile each
SMALL = dict(num_steps_per_update=T, actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16))
# (metrics, parameters, hook state).  The schedule's accumulator holds
# log(KL): its error is the KL's relative error, and the KL is a small
# difference of nearly equal terms (measured 1.5e-5 in fp32, 7.5e-4 in bf16).
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=2e-6), dict(rtol=1e-4, atol=1e-4))
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=3e-3), dict(rtol=1e-3, atol=2e-3))


def _factories(path, **overrides):
    kwargs = {**SMALL, **overrides, **({"fused_ppo_update": True} if path == "C" else {})}
    jf, tf = jax_get_experiment("Velocity-Rough", "ppo").make_agent_factory(), get_experiment(
        "Velocity-Rough", "ppo").make_agent_factory()
    for f in (jf, tf):
        for k, v in kwargs.items():
            setattr(f, k, v)
    if path != "B":
        return jf, tf
    jf, tf = jf.to_underlying(), tf.to_underlying()
    jf.hooks = [JaxJointEval(fuse_heads=True) if isinstance(h, JaxJointEval) else h for h in jf.hooks]
    tf.hooks = [JointPolicyValueEvaluation(fuse_heads=True) if isinstance(h, JointPolicyValueEvaluation) else h
                for h in tf.hooks]
    return jf, tf


def _rollout(jax_agent, seed, act=ACT):
    rng = np.random.default_rng(seed)
    obs = np.tanh(rng.standard_normal((T, N, OBS))).astype(np.float32)
    next_obs = np.concatenate([obs[1:], np.tanh(rng.standard_normal((1, N, OBS)))], 0).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    action = dist["mean"] + dist["std"] * rng.standard_normal((T, N, act)).astype(np.float32)
    terminated = rng.random((T, N, 1)) < 0.05
    truncated = rng.random((T, N, 1)) < 0.05
    return {
        "observation": obs,
        "next_observation": next_obs,
        "action": np.asarray(action),
        "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, action)),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, N, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
        "done": terminated | truncated,
    }


def _hook_state(jax_agent, rng):
    """Non-trivial hook state on the JAX side (it is carried to the port)."""
    for index, hook in enumerate(jax_agent.state.hooks):
        if hook.hook_name == "observation_normalization":
            acc = None if hook.obs_acc is None else tuple(
                jnp.asarray(v) for v in (rng.standard_normal(OBS) * 30, rng.random(OBS) * 200 + 100, 60.0))
            rms = hook.observation_rms.replace(mean=jnp.asarray(rng.standard_normal(OBS), jnp.float32),
                                               var=jnp.asarray(rng.random(OBS) + 0.5, jnp.float32),
                                               count=jnp.asarray(300.0, jnp.float32))
            jax_agent.update_hook(hook.hook_name, hook.replace(observation_rms=rms, obs_acc=acc))
        elif hook.hook_name == "adaptive_l_r_schedule":
            jax_agent.update_hook(hook.hook_name, hook.replace(
                lr_scale=jnp.asarray(0.7, jnp.float32), accumulated_log_error=jnp.asarray(0.4, jnp.float32),
                error_count=jnp.asarray(2.0, jnp.float32)))


def _agents(path, compute_dtype, monkeypatch, act=ACT, reward_dim=1, **overrides):
    """The JAX agent and the port's, with the JAX agent's weights and hook
    state (``act`` actions, ``reward_dim`` values)."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    # The kernels' path on the CPU: the JAX rule without "on CUDA" (and
    # without the row minimum, so the 128-row minibatches take it too).
    monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: x.dim() >= 2 and all(
        l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))
    jf, tf = _factories(path, **overrides)
    jax_spec = JaxEnv(num_instances=N, observation_dim=OBS, action_dim=act).spec
    spec = VelocityLocomotionEnv(num_instances=N, observation_dim=OBS, action_dim=act, device="cpu").spec
    jax_agent = jf(dataclasses.replace(jax_spec, reward_dim=reward_dim))
    agent = tf(dataclasses.replace(spec, reward_dim=reward_dim), device="cpu")
    _hook_state(jax_agent, np.random.default_rng(3))
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    return jax_agent, agent


def _run_both(path, compute_dtype, monkeypatch, act=ACT, **overrides):
    jax_agent, agent = _agents(path, compute_dtype, monkeypatch, act=act, **overrides)
    rollout = _rollout(jax_agent, seed=11, act=act)
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    _, perms, _ = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    reset_launch_counts()
    metrics = agent.update_body(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rollout),
                                epoch_perms=np.array(perms))
    new = {p: np.asarray(v) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic.", "hooks."))}
    return jax_metrics, metrics, new, agent


def _compare(jax_metrics, metrics, new, agent, tol):
    metric_tol, param_tol, state_tol = tol
    assert set(metrics) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), err_msg=key, **metric_tol)
    params = dict(agent.model.named_parameters())
    assert set(params) == {p for p in new if not p.startswith("hooks.")}
    for path, param in params.items():
        np.testing.assert_allclose(param.detach().numpy(), new[path], err_msg=path, **param_tol)
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            np.testing.assert_allclose(tensor.float().numpy(), new[f"hooks.{index}.{name}"].astype(np.float32),
                                       err_msg=f"{hook.hook_name}.{name}", **state_tol)


@pytest.mark.parametrize("path", ["A", "B", "C"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_zoo_update_matches_jax(path, compute_dtype, monkeypatch):
    """In fp32 the fused step (C) still runs bf16 chains on both sides (the
    JAX ``ppo_step_reference`` is bf16 whatever the compute dtype), so C is
    held to the bf16 tolerances."""
    result = _run_both(path, compute_dtype, monkeypatch)
    _compare(*result, FP32_TOL if compute_dtype is None and path != "C" else BF16_TOL)
    if compute_dtype is not None:  # the plain versions ran, and counted no launch
        assert not any(LAUNCHES.values())


def test_deferred_normalization_and_rejected_update_match_jax(monkeypatch):
    """bench.py's normalization settings (deferred statistics folded in
    pre_update, no originals) and a ``max_kl_divergence`` that rejects the
    update: parameters, optimizer moments and the other hooks' state go back
    to their pre-update values, while the adapted ``lr_scale`` is kept."""
    jax_metrics, metrics, new, agent = _run_both(
        "A", "bfloat16", monkeypatch, defer_normalization_updates=True, store_original_observations=False,
        max_kl_divergence=1e-9,
    )
    assert float(metrics["update_rejected"]) == 1.0 == float(jax_metrics["update_rejected"])
    _compare(jax_metrics, metrics, new, agent, BF16_TOL)
    optimizer = agent.optimizer.optimizer
    for p in agent.model.parameters():
        assert not optimizer.state[p]["exp_avg"].any() and not optimizer.state[p]["exp_avg_sq"].any()
    assert float(agent.get_hook("adaptive_l_r_schedule").lr_scale) != 0.7


WIDE = 65  # one output past the head kernels' MAX_HEAD_DIM


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_zoo_update_with_a_wide_action_head_matches_jax(compute_dtype, monkeypatch):
    """Path C with 65 actions: ``FusedPpoUpdate`` takes the wide head (in
    bf16 through the chains' kernel route, K2 plain versions, with the heads
    and the loss outside) and the whole update matches the JAX hook's, at
    path C's tolerances."""
    result = _run_both("C", compute_dtype, monkeypatch, act=WIDE)
    hook = result[3].get_hook("fused_ppo_update")
    assert not hook.fuse_heads
    _compare(*result, BF16_TOL)
    if compute_dtype is not None:  # the plain versions ran, and counted no launch
        assert not any(LAUNCHES.values())


@pytest.mark.parametrize("wide", ["action", "value"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_fused_update_objective_with_a_wide_head_matches_jax(wide, compute_dtype, monkeypatch):
    """One ``FusedPpoUpdate.objective`` with a 65-wide action head or a
    65-wide value head, on the same weights and batch (actions drawn around
    the JAX actor's mean with the same noise): objectives, metrics and every
    parameter's gradient against the JAX hook's.  In bf16 the port takes the
    wide route (the chains through ``fused_mlp_pair``, here its plain
    version), in fp32 ``ppo_step_reference``; the JAX hook runs its XLA
    reference."""
    act, value_dim = (WIDE, 1) if wide == "action" else (ACT, WIDE)
    jax_agent, agent = _agents("C", compute_dtype, monkeypatch, act=act, reward_dim=value_dim,
                               value_loss_clip=0.2)
    rows = 256
    rng = np.random.default_rng(23)
    obs = np.tanh(rng.standard_normal((rows, OBS))).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    action = np.asarray(dist["mean"] + dist["std"] * rng.standard_normal((rows, act)).astype(np.float32))
    logp = np.asarray(jax_agent.state.actor.compute_logp(dist, jnp.asarray(action)))
    batch = {
        "observation": obs,
        "action": action,
        "action_logp": (logp + 0.1 * rng.standard_normal(logp.shape)).astype(np.float32),
        "advantage": rng.standard_normal((rows, 1)).astype(np.float32),
        "return": rng.standard_normal((rows, value_dim)).astype(np.float32),
        "value": rng.standard_normal((rows, value_dim)).astype(np.float32),
    }
    jax_hook = next(h for h in jax_agent.state.hooks if h.hook_name == "fused_ppo_update")
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_objective(actor, critic):
        _, _, objectives, metrics = jax_hook.objective(jax_agent.state.replace(actor=actor, critic=critic), None,
                                                       jax_batch)
        return sum(objectives.values()), (objectives, metrics)

    (_, (jax_objectives, jax_metrics)), jax_grads = jax.value_and_grad(jax_objective, argnums=(0, 1), has_aux=True)(
        jax_agent.state.actor, jax_agent.state.critic)
    jax_grads = {p: np.asarray(g) for p, g in tree_paths({"actor": jax_grads[0], "critic": jax_grads[1]})}

    hook = agent.get_hook("fused_ppo_update")
    assert not hook.fuse_heads
    reset_launch_counts()
    objectives, metrics = hook.objective(agent, None, {k: torch.tensor(v) for k, v in batch.items()})
    sum(objectives.values()).backward()
    assert not any(LAUNCHES.values())
    assert set(objectives) == set(jax_objectives) and set(metrics) == set(jax_metrics)
    for key in objectives:
        np.testing.assert_allclose(objectives[key].item(), float(jax_objectives[key]), err_msg=key, **FP32_TOL[0])
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jax_metrics[key]), err_msg=key, **FP32_TOL[0])
    params = dict(agent.model.named_parameters())
    assert set(params) <= set(jax_grads)
    for path, param in params.items():
        want = jax_grads[path]
        # The backbones are bf16 on both sides (the fused step's chains are
        # bf16 whatever the compute dtype): their gradients differ by flipped
        # bf16 roundings (measured up to 6.8e-3 of the largest element).  The
        # fp32 heads and std are held as the metrics are.
        if ".backbone." in path:
            np.testing.assert_allclose(param.grad.numpy(), want, err_msg=path, rtol=0,
                                       atol=1e-2 * np.abs(want).max())
        else:
            np.testing.assert_allclose(param.grad.numpy(), want, err_msg=path, **FP32_TOL[0])


@pytest.mark.parametrize("final_state_is_missing", [True, False])
def test_feedforward_value_bootstrap_follows_final_state_is_missing(final_state_is_missing, monkeypatch):
    """The feedforward (``deferred=True``) ValueComputation against the JAX
    hook on a 6 x 4 rollout with 2 truncated rows and 1 terminated one: with
    the final state missing, truncated rows take their own value and the last
    row bootstraps from the critic on its next state."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    jf, tf = _factories("A")
    jax_spec = dataclasses.replace(JaxEnv(num_instances=4, observation_dim=OBS, action_dim=ACT).spec,
                                   final_state_is_missing=final_state_is_missing)
    spec = dataclasses.replace(VelocityLocomotionEnv(num_instances=4, observation_dim=OBS, action_dim=ACT,
                                                     device="cpu").spec, final_state_is_missing=final_state_is_missing)
    jax_agent, agent = jf(jax_spec), tf(spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((7, 4, OBS)).astype(np.float32)
    truncated = np.zeros((6, 4, 1), bool)
    truncated[1, 2] = truncated[4, 0] = True
    terminated = np.zeros((6, 4, 1), bool)
    terminated[3, 1] = True
    rollout = {"observation": obs[:-1], "next_observation": obs[1:], "terminated": terminated,
               "truncated": truncated, "done": terminated | truncated}
    jax_hook = jax_agent.get_hook("value_computation")
    _, jax_rollout, _ = jax_hook.pre_update(jax_agent.state, jax.tree.map(jnp.asarray, rollout))
    hook = agent.get_hook("value_computation")
    assert hook.deferred is True and hook.bootstrap_truncated_states is not final_state_is_missing
    port_rollout = {k: torch.from_numpy(v) for k, v in rollout.items()}
    with torch.no_grad():
        hook.pre_update(agent, port_rollout)
    for key in ("value", "next_value"):
        np.testing.assert_allclose(port_rollout[key].numpy(), np.asarray(jax_rollout[key]), err_msg=key,
                                   **FP32_TOL[0])
    next_value, value = port_rollout["next_value"].numpy(), port_rollout["value"].numpy()
    if final_state_is_missing:
        np.testing.assert_array_equal(next_value[truncated[..., 0]], value[truncated[..., 0]])

"""The AMP slice of the port against the JAX package, at small size:
``RewardShaping``, ``gradient_penalty`` and the other losses,
``AdversarialMotionPrior``'s ``post_step`` and objective, the scripted
``demonstration_dataset``, the zoo's ``Velocity-Flat``/``amp`` entry (its
kwargs, its optimizer labels, ``load_jax_state``), the first-order kernel
Functions, and one whole update of a narrow AMP agent.

Both sides take the same draws: the expert rows and minibatch subsamples the
JAX hook draws from its PRNG key are recomputed here (``_jax_draws``, the
hook's own splits) and queued on the port's hook (``queue_draws``).  The
discriminator's last bias is lifted to 0.5 on the JAX side before its
weights are carried over: at these widths its relu output is otherwise 0 on
every row, and the gradient penalty and the style reward would hold nothing
to compare.  Tolerances: fp32 to summation order (1e-6 for the elementwise
pieces, the update's metrics rtol 1e-5 / atol 5e-6 and parameters 2e-6);
bf16 to one rounding carried through 16 Adam steps (metrics rtol 1e-3 /
atol 1e-4, parameters 3e-3), as ``tests/test_torch_update_zoo.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment import locomotion as jax_locomotion
from cusrl_tpu.hook.auxiliary.amp import AdversarialMotionPrior as JaxAmp
from cusrl_tpu.hook.mdp.reward import RewardShaping as JaxRewardShaping
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.layer import loss as jax_loss
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment import locomotion
from cusrl_tpu_torch.hook.auxiliary.amp import AdversarialMotionPrior
from cusrl_tpu_torch.hook.mdp.reward import RewardShaping
from cusrl_tpu_torch.nn.kernels import fused_mlp
from cusrl_tpu_torch.nn.layer import loss
from cusrl_tpu_torch.nn.module.mlp import Mlp, MlpFactory
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

T, N, OBS, ACT, STATE = 16, 32, 24, 4, 8  # 512 rows: 4 minibatches of one 128-row tile
WIDTH = 2 * STATE
BATCH = 64
HOOK = "adversarial_motion_prior"
SMALL = dict(num_steps_per_update=T, actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 32),
             amp_discriminator_hidden_dims=(32, 32), amp_batch_size=BATCH, amp_state_indices=tuple(range(STATE)))
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=2e-6), dict(rtol=1e-4, atol=1e-4))
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=3e-3), dict(rtol=1e-3, atol=2e-3))
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(rng, sizes):
    """The JAX hook's draws, ``(num, high)`` each in order: one split of its
    key and ``randint(key, (num,), 0, high)``; returns (indices, new key)."""
    out = []
    for num, high in sizes:
        key, rng = jax.random.split(rng)
        out.append(np.asarray(jax.random.randint(key, (num,), 0, high)))
    return out, rng


def _with_live_logits(jax_hook):
    """The JAX hook with its discriminator's last bias at 0.5."""
    disc = jax_hook.discriminator
    last = disc.layers[-1].replace(bias=jnp.full_like(disc.layers[-1].bias, 0.5))
    return jax_hook.replace(discriminator=disc.replace(layers=disc.layers[:-1] + (last,)))


def _copy_discriminator(jax_hook, hook):
    with torch.no_grad():
        for jl, layer in zip(jax_hook.discriminator.layers, hook.discriminator.layers):
            layer.weight.copy_(_t(jl.weight))
            layer.bias.copy_(_t(jl.bias))


def _hooks(compute_dtype, monkeypatch, dataset, **kwargs):
    """A JAX AMP hook (discriminator 32-32-1 relu with a live logit) and the
    port's with the same weights and dataset."""
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    factory_kwargs = dict(hidden_dims=(32, 32), activation="relu", ends_with_activation=True, fused_kernel=False)
    common = dict(dataset_source=dataset, state_indices=tuple(range(STATE)), batch_size=BATCH, reward_scale=0.7,
                  loss_weight=1.3, grad_penalty_weight=5.0, **kwargs)
    jax_hook = _with_live_logits(JaxAmp(discriminator_factory=JaxMlpFactory(**factory_kwargs), **common)
                                 .init(None, jax.random.key(3)))
    hook = AdversarialMotionPrior(discriminator_factory=MlpFactory(**factory_kwargs), **common)
    hook.init(types.SimpleNamespace(device=torch.device("cpu"), init_generator=torch.Generator().manual_seed(0),
                                    environment_spec=None))
    _copy_discriminator(jax_hook, hook)
    return jax_hook, hook


def _dataset(rng, rows=256):
    return rng.standard_normal((rows, WIDTH)).astype(np.float32) * 0.5 + 0.1


# -- RewardShaping and the losses ----------------------------------------------


@pytest.mark.parametrize("bounds", [(None, None), (-0.5, None), (None, 0.3), (-0.2, 0.4)])
def test_reward_shaping_matches_jax(bounds):
    rng = np.random.default_rng(0)
    reward = rng.standard_normal((N, 1)).astype(np.float32)
    jax_hook = JaxRewardShaping(scale=0.1, shift=0.05, lower_bound=bounds[0], upper_bound=bounds[1])
    _, jax_tr = jax_hook.post_step(None, {"reward": jnp.asarray(reward)})
    tr = {"reward": _t(reward)}
    RewardShaping(scale=0.1, shift=0.05, lower_bound=bounds[0], upper_bound=bounds[1]).post_step(None, tr)
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(jax_tr["reward"]), **TOL)


def _small_mlp(rng):
    return [(rng.standard_normal((12, WIDTH)).astype(np.float32) * 0.4, rng.standard_normal(12).astype(np.float32)),
            (rng.standard_normal((1, 12)).astype(np.float32) * 0.4, np.float32([0.2]))]


@pytest.mark.parametrize("reduce_mean", [True, False])
def test_gradient_penalty_and_its_parameter_gradient_match_jax(reduce_mean):
    """The penalty of a tanh MLP and its gradient with respect to the MLP's
    weights (a second derivative), fp32."""
    rng = np.random.default_rng(1)
    layers = _small_mlp(rng)
    x = rng.standard_normal((20, WIDTH)).astype(np.float32)

    def jax_fn(params):
        return lambda v: jnp.tanh(v @ params[0][0].T + params[0][1]) @ params[1][0].T + params[1][1]

    def jax_total(params):
        return jnp.sum(jax_loss.gradient_penalty(jax_fn(params), jnp.asarray(x), reduce_mean=reduce_mean))

    jax_value = jax_loss.GradientPenaltyLoss(reduce_mean)(jax_fn(jax.tree.map(jnp.asarray, layers)), jnp.asarray(x))
    jax_grads = jax.grad(jax_total)(jax.tree.map(jnp.asarray, layers))
    params = [[_t(w).requires_grad_(), _t(b).requires_grad_()] for w, b in layers]

    def fn(v):
        return torch.tanh(v @ params[0][0].T + params[0][1]) @ params[1][0].T + params[1][1]

    value = loss.GradientPenaltyLoss(reduce_mean)(fn, _t(x))
    leaves = [p for layer in params for p in layer]
    # The last bias does not reach the input gradient: JAX's zeros, torch's None.
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, torch.autograd.grad(value.sum(), leaves, allow_unused=True))]
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jax_value), **TOL)
    for got, want in zip(grads, jax.tree.leaves(jax_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_normal_nll_and_l2_regularization_match_jax():
    rng = np.random.default_rng(2)
    mean, target = (rng.standard_normal((6, 3)).astype(np.float32) for _ in range(2))
    var = np.abs(rng.standard_normal((6, 3))).astype(np.float32)
    var[0, 0] = 0.0  # clamped to eps
    for full in (False, True):
        np.testing.assert_allclose(loss.NormalNllLoss(full=full)(_t(mean), _t(var), _t(target)).numpy(),
                                   np.asarray(jax_loss.NormalNllLoss(full=full)(mean, var, target)), **TOL)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (4,))]
    np.testing.assert_allclose(loss.L2RegularizationLoss(0.3)([_t(p) for p in params]).numpy(),
                               np.asarray(jax_loss.L2RegularizationLoss(0.3)(params)), **TOL)


# -- the AMP hook --------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_amp_post_step_matches_jax(compute_dtype, monkeypatch):
    """Three steps: the style reward added to the reward, the running
    statistics (agent rows, then expert rows) and the stored normalized
    transitions, on ``next_state`` where the transition has one."""
    rng = np.random.default_rng(4)
    jax_hook, hook = _hooks(compute_dtype, monkeypatch, _dataset(rng))
    for step in range(3):
        tr = {"observation": np.tanh(rng.standard_normal((N, OBS))).astype(np.float32) * 2,
              "next_observation": np.tanh(rng.standard_normal((N, OBS))).astype(np.float32) * 2,
              "reward": rng.standard_normal((N, 1)).astype(np.float32)}
        if step == 2:
            tr["next_state"] = rng.standard_normal((N, OBS)).astype(np.float32)
        (expert,), _ = _jax_draws(jax_hook.rng, [(N, 256)])
        hook.queue_draws(expert=[expert])
        jax_hook, jax_tr = jax.jit(lambda h, x: h.post_step(None, x))(jax_hook, jax.tree.map(jnp.asarray, tr))
        port_tr = {k: _t(v) for k, v in tr.items()}
        hook.post_step(None, port_tr)
        for key in ("reward", "agent_transition", "expert_transition"):
            # bf16: the logit one rounding apart moves the style reward by at
            # most 0.7 * (2^-7 + its log's rounding), under 1e-2.
            atol = 1e-2 if key == "reward" and compute_dtype else 1e-5
            np.testing.assert_allclose(port_tr[key].float().numpy(), np.asarray(jax_tr[key], np.float32),
                                       err_msg=key, rtol=1e-6, atol=atol)
        for name, tensor in hook.state_tensors().items():
            want = dict(tree_paths(jax_hook))[name]
            np.testing.assert_allclose(tensor.numpy(), np.asarray(want), err_msg=name, rtol=1e-5, atol=1e-6)
    # The style reward is at least reward_scale * log 2: the logit is relu'd.
    style = port_tr["reward"] - _t(tr["reward"])
    assert (style >= 0.7 * np.log(2) - 1e-6).all()


def _jax_objective(jax_hook, batch):
    def total(disc):
        _, _, objectives, metrics = jax_hook.replace(discriminator=disc).objective(None, {}, batch)
        return sum(objectives.values()), (objectives, metrics)

    (_, (objectives, metrics)), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jax_hook.discriminator)
    return objectives, metrics, grads


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_amp_objective_matches_jax(compute_dtype, monkeypatch):
    """Both losses, ``amp_accuracy`` and the discriminator's gradients (the
    gradient penalty's second derivative included) on a 2 x 96-row batch
    subsampled to 64 rows with the JAX hook's indices."""
    rng = np.random.default_rng(5)
    jax_hook, hook = _hooks(compute_dtype, monkeypatch, _dataset(rng))
    batch = {"agent_transition": rng.standard_normal((2, 96, WIDTH)).astype(np.float32),
             "expert_transition": rng.standard_normal((2, 96, WIDTH)).astype(np.float32) + 0.3}
    (indices,), _ = _jax_draws(jax_hook.rng, [(BATCH, 192)])
    hook.queue_draws(subsample=[indices])
    objectives, metrics, jax_grads = _jax_objective(jax_hook, jax.tree.map(jnp.asarray, batch))
    port_objectives, port_metrics = hook.objective(None, {}, {k: _t(v) for k, v in batch.items()})
    sum(port_objectives.values()).backward()
    tol = TOL if compute_dtype is None else dict(rtol=1e-2, atol=1e-3)
    assert set(port_objectives) == set(objectives) == {"amp_discrimination_loss", "amp_grad_penalty_loss"}
    assert float(port_objectives["amp_grad_penalty_loss"]) > 0
    for key in objectives:
        np.testing.assert_allclose(float(port_objectives[key]), float(objectives[key]), err_msg=key, **tol)
    np.testing.assert_allclose(float(port_metrics["amp_accuracy"]), float(metrics["amp_accuracy"]), **TOL)
    for (path, want), (name, p) in zip(tree_paths(jax_grads), hook.discriminator.named_parameters()):
        assert path == name
        scale = np.abs(np.asarray(want)).max()
        assert np.abs(p.grad.numpy() - np.asarray(want)).max() <= (1e-5 if compute_dtype is None else 2e-2) * scale


def test_agent_logits_are_never_below_zero(monkeypatch):
    """The JAX package's quirk, followed: the discriminator's trailing relu
    makes every logit >= 0, so no agent row counts as classified and
    ``amp_accuracy`` is at most 0.5 on both sides."""
    rng = np.random.default_rng(6)
    jax_hook, hook = _hooks(None, monkeypatch, _dataset(rng))
    x = _t(rng.standard_normal((500, WIDTH)).astype(np.float32) * 3)
    logits = hook._logit(x)
    assert (logits >= 0).all() and (np.asarray(jax_hook.discriminator(jnp.asarray(x.numpy()))[0]) >= 0).all()
    batch = {"agent_transition": x, "expert_transition": x + 1}
    _, metrics = hook.objective(None, {}, batch)
    assert float(metrics["amp_accuracy"]) <= 0.5


def test_amp_dataset_sources(monkeypatch, tmp_path):
    """A ``.npy`` path, an array, a callable (given the agent's device where
    it takes one) and the spec's ``demonstration_sampler`` (with
    ``demonstration_prefetch`` rows) all give the same device dataset."""
    data = _dataset(np.random.default_rng(7), rows=64)
    np.save(tmp_path / "demo.npy", data)
    agent = types.SimpleNamespace(device=torch.device("cpu"), init_generator=torch.Generator().manual_seed(0),
                                  environment_spec=types.SimpleNamespace(demonstration_sampler=lambda n: data[:n]))
    factory = MlpFactory(hidden_dims=(8,), activation="relu", fused_kernel=False)
    for source, rows in ((str(tmp_path / "demo.npy"), 64), (data, 64), (_t(data), 64), (lambda: data, 64),
                         (lambda device: _t(data).to(device), 64), (None, 48)):
        hook = AdversarialMotionPrior(discriminator_factory=factory, dataset_source=source,
                                      demonstration_prefetch=48)
        hook.init(agent)
        assert hook.dataset.dtype == torch.float32 and hook.dataset.device.type == "cpu"
        np.testing.assert_array_equal(hook.dataset.numpy(), data[:rows])
    with pytest.raises(ValueError, match="Unsupported dataset file format"):
        AdversarialMotionPrior(discriminator_factory=factory, dataset_source="demo.csv").init(agent)


def test_demonstration_dataset_matches_jax_before_any_reset():
    """The scripted controller on the JAX environment's matrices and first
    state: the rows agree while no instance has reset (a reset redraws a
    command from each side's own stream); 8 steps of 16 instances.  The
    controller's gain (25) feeds each step's rounding back into the next, so
    the two sides drift apart by about 2.5x a step (1e-5 after 16 steps,
    1.5e-4 after 28): the first 8 steps hold at 2e-5."""
    jax_env = jax_locomotion.VelocityLocomotionEnv(num_instances=16, seed=1)
    want = np.asarray(jax_locomotion.demonstration_dataset(num_transitions=128, num_instances=16, seed=1))
    init = jax_env.init_fn(jax.random.key(2))
    env = locomotion.VelocityLocomotionEnv(num_instances=16, device="cpu", actuation=np.asarray(jax_env._actuation),
                                           obs_proj=np.asarray(jax_env._obs_proj))
    got = locomotion.demonstration_dataset(num_transitions=128, num_instances=16, seed=1, env=env,
                                           init_state={k: _t(v) for k, v in init.items()})
    assert got.shape == want.shape == (128, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    # Its own generator (seeded from ``seed``) on the caller's device.
    default = locomotion.demonstration_dataset(num_transitions=300, num_instances=64, device="cpu")
    assert default.shape == (300, 32) and torch.isfinite(default).all()
    again = locomotion.demonstration_dataset(num_transitions=300, num_instances=64, device="cpu")
    assert torch.equal(default, again)


# -- the zoo entry ---------------------------------------------------------------


def test_amp_entry_kwargs_equal_jax():
    spec, jax_spec = get_experiment("Velocity-Flat", "amp"), jax_get_experiment("Velocity-Flat", "amp")
    kwargs, jax_kwargs = dict(spec.agent_meta_factory_kwargs), dict(jax_spec.agent_meta_factory_kwargs)
    assert kwargs.pop("amp_dataset_source") is locomotion.demonstration_dataset
    assert jax_kwargs.pop("amp_dataset_source") is jax_locomotion.demonstration_dataset
    assert kwargs == jax_kwargs
    for name in ("training_env_factory_kwargs", "benchmarking_env_factory_kwargs", "num_iterations",
                 "checkpoint_interval", "iterations_per_dispatch"):
        assert getattr(spec, name) == getattr(jax_spec, name), name
    factory, jax_factory = spec.make_agent_factory(), jax_spec.make_agent_factory()
    assert [h.hook_name for h in factory.to_underlying().hooks] == [
        h.hook_name for h in jax_factory.to_underlying().hooks]


def _entry_agents(monkeypatch, compute_dtype="bfloat16", small=True, dataset=None):
    """The zoo entry's JAX agent and the port's (narrow when ``small``), the
    port with the JAX agent's weights and hook state."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    jf = jax_get_experiment("Velocity-Flat", "amp").make_agent_factory()
    tf = get_experiment("Velocity-Flat", "amp").make_agent_factory()
    if small:
        for f in (jf, tf):
            for k, v in {**SMALL, "amp_dataset_source": dataset}.items():
                setattr(f, k, v)
    obs, act = (OBS, ACT) if small else (48, 12)
    jax_spec = jax_locomotion.VelocityLocomotionEnv(num_instances=N, observation_dim=obs, action_dim=act).spec
    spec = locomotion.VelocityLocomotionEnv(num_instances=N, observation_dim=obs, action_dim=act, device="cpu").spec
    jax_agent = jf(jax_spec)
    if small:
        jax_agent.update_hook(HOOK, _with_live_logits(jax_agent.get_hook(HOOK)))
    agent = tf(spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    return jax_agent, agent


def test_amp_entry_builds_with_jax_labels_and_loads_jax_state(monkeypatch):
    """The uncut entry's agent: the optimizer's labels equal JAX's
    ``labels_flat`` (the discriminator's ``hooks.adversarial_motion_prior.*``
    paths included, all in ``default``), 32-512-256-1 relu, the actor and the
    critic 316,185 parameters together, a 65,536 x 32 dataset; then
    ``load_jax_state`` carries the discriminator, ``transition_rms`` and
    ``dataset``, and a missing path raises."""
    jax_agent, agent = _entry_agents(monkeypatch, small=False)
    assert agent.optimizer.labels == jax_agent.optimizer.labels_flat
    disc = [k for k in agent.optimizer.labels if k.startswith(f"hooks.{HOOK}.discriminator.")]
    assert len(disc) == 6 and {agent.optimizer.labels[k] for k in disc} == {"default"}
    hook = agent.get_hook(HOOK)
    assert [tuple(l.weight.shape) for l in hook.discriminator.layers] == [(512, 32), (256, 512), (1, 256)]
    assert not hook.discriminator.fused_kernel and hook.discriminator.activation == "relu"
    assert sum(p.numel() for n, p in agent.model.named_parameters() if not n.startswith("hooks.")) == 316185
    state = jax_agent.state_dict()["agent_state"]
    for path, param in hook.discriminator.named_parameters():
        np.testing.assert_array_equal(param.detach().numpy(), state[f"hooks.3.discriminator.{path}"])
    np.testing.assert_array_equal(hook.dataset.numpy(), state["hooks.3.dataset"])
    assert hook.dataset.shape == (65536, 32)
    state = dict(state)
    state["hooks.3.transition_rms.mean"] = state["hooks.3.transition_rms.mean"] + 1.0
    load_jax_state(agent, state)
    np.testing.assert_array_equal(hook.transition_rms.mean.numpy(), state["hooks.3.transition_rms.mean"])
    del state["hooks.3.discriminator.layers.2.bias"]
    with pytest.raises(KeyError, match="discriminator.layers.2.bias"):
        load_jax_state(agent, state)


def _update_both(compute_dtype, monkeypatch):
    """One whole iteration of the narrow entry on both sides: T steps of
    ``RewardShaping`` and AMP ``post_step`` (the JAX hook's expert draws),
    then ``update_body`` on the resulting rollout (the JAX sampler's
    permutations and the JAX hook's subsample draws)."""
    rng = np.random.default_rng(8)
    monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: self.fused_kernel and x.dim() >= 2 and all(
        l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))
    jax_agent, agent = _entry_agents(monkeypatch, compute_dtype, dataset=_dataset(rng))
    obs = np.tanh(rng.standard_normal((T + 1, N, OBS))).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs[:-1]))
    action = dist["mean"] + dist["std"] * rng.standard_normal((T, N, ACT)).astype(np.float32)
    terminated, truncated = rng.random((T, N, 1)) < 0.05, rng.random((T, N, 1)) < 0.05
    rollout = {"observation": obs[:-1], "next_observation": obs[1:], "action": np.asarray(action),
               "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, action)),
               "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
               "terminated": terminated, "truncated": truncated, "done": terminated | truncated}
    env_reward = rng.standard_normal((T, N, 1)).astype(np.float32)
    jax_hook_names = [h.hook_name for h in jax_agent.state.hooks]
    hook = agent.get_hook(HOOK)
    steps = {"jax": [], "port": []}
    for t in range(T):
        (expert,), _ = _jax_draws(jax_agent.get_hook(HOOK).rng, [(N, 256)])
        hook.queue_draws(expert=[expert])
        tr = {"observation": obs[t], "next_observation": obs[t + 1], "reward": env_reward[t]}
        jax_tr = jax.tree.map(jnp.asarray, tr)
        for name in ("reward_shaping", HOOK):
            new_hook, jax_tr = jax_agent.get_hook(name).post_step(None, jax_tr)
            jax_agent.update_hook(name, new_hook)
        port_tr = {k: _t(v) for k, v in tr.items()}
        for name in ("reward_shaping", HOOK):
            agent.get_hook(name).post_step(agent, port_tr)
        steps["jax"].append(jax_tr)
        steps["port"].append(port_tr)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    jax_rollout.update({k: jnp.stack([tr[k] for tr in steps["jax"]]) for k in
                        ("reward", "agent_transition", "expert_transition")})
    port_rollout = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rollout)
    port_rollout.update({k: torch.stack([tr[k] for tr in steps["port"]]) for k in
                         ("reward", "agent_transition", "expert_transition")})
    np.testing.assert_allclose(port_rollout["reward"].numpy(), np.asarray(jax_rollout["reward"]),
                               rtol=1e-5, atol=1e-5 if compute_dtype is None else 1e-2)
    key = jax.random.key(5)
    _, perms, _ = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    subsample, _ = _jax_draws(jax_agent.get_hook(HOOK).rng, [(BATCH, T * N // 4)] * 16)
    hook.queue_draws(subsample=subsample)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    metrics = agent.update_body(port_rollout, epoch_perms=np.array(perms))
    assert not hook._subsample_draws  # all 16 minibatches took the JAX draws
    assert jax_hook_names.index(HOOK) == 3
    new = {p: np.asarray(v) for p, v in tree_paths(new_state)
           if p.startswith(("actor.", "critic.", "hooks.")) and not p.endswith(".rng")}
    return jax_metrics, metrics, new, agent


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_amp_update_matches_jax(compute_dtype, monkeypatch):
    """Every metric (the AMP losses and accuracy included), every parameter
    (the discriminator's under ``hooks.3.discriminator``) and the AMP hook's
    running statistics after one whole iteration."""
    jax_metrics, metrics, new, agent = _update_both(compute_dtype, monkeypatch)
    metric_tol, param_tol, state_tol = FP32_TOL if compute_dtype is None else BF16_TOL
    assert set(metrics) == set(jax_metrics)
    assert {"amp_discrimination_loss", "amp_grad_penalty_loss", "amp_accuracy"} <= set(metrics)
    assert float(metrics["amp_grad_penalty_loss"]) > 0
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), err_msg=key, **metric_tol)
    index = {h.hook_name: i for i, h in enumerate(agent.hooks)}
    for path, param in agent.model.named_parameters():
        if path.startswith("hooks."):
            _, name, rest = path.split(".", 2)
            path = f"hooks.{index[name]}.{rest}"
        np.testing.assert_allclose(param.detach().numpy(), new[path], err_msg=path, **param_tol)
    for name, tensor in agent.get_hook(HOOK).state_tensors().items():
        np.testing.assert_allclose(tensor.numpy(), new[f"hooks.3.{name}"], err_msg=name, **state_tol)


# -- first-order kernel Functions ----------------------------------------------


def _chain(rng, widths=(6, 8, 4)):
    return ([_t(rng.standard_normal((b, a)).astype(np.float32) * 0.5).requires_grad_()
             for a, b in zip(widths[:-1], widths[1:])],
            [_t(rng.standard_normal(b).astype(np.float32) * 0.1).requires_grad_() for b in widths[1:]])


def test_second_derivative_through_the_mlp_kernels_raises():
    """``_FusedMlp`` and ``_FusedMlpPair`` have a first-order backward
    (``once_differentiable``, as the JAX kernels' ``custom_vjp``): under a
    trainable head, as the discriminator's gradient penalty would put them,
    the first derivative works and a second raises instead of losing its
    second-order term (on the CPU their plain backward would give one)."""
    rng = np.random.default_rng(9)
    ws, bs = _chain(rng)
    head = _t(rng.standard_normal((4, 1)).astype(np.float32)).requires_grad_()
    x = _t(rng.standard_normal((5, 6)).astype(np.float32)).requires_grad_()
    calls = {
        "single": lambda: (fused_mlp._FusedMlp.apply(x, "relu", True, 2, *ws, *bs).float() @ head).sum(),
        "pair": lambda: sum((o.float() @ head).sum() for o in fused_mlp._FusedMlpPair.apply(
            x, x * 2, "elu", True, 2, False, *ws, *bs, *ws, *bs)),
    }
    for name, call in calls.items():
        (gx,) = torch.autograd.grad(call(), x)
        assert torch.isfinite(gx).all(), name
        (gx,) = torch.autograd.grad(call(), x, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            gx.square().sum().backward()

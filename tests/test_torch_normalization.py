"""The port's running statistics, observation normalization and KL-adaptive
learning-rate schedule against the JAX package's, on the same inputs (made
with numpy from a seed).

All of it is fp32: statistics at 1e-6 (the same formulas, summed in another
order); normalized observations at 1e-5 (a division by sqrt(var + 1e-8) of
values up to the clamp of 10).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.mdp.observation import ObservationNormalization as JaxObsNorm
from cusrl_tpu.hook.on_policy.lr_schedule import AdaptiveLRSchedule as JaxAdaptive
from cusrl_tpu.hook.on_policy.lr_schedule import ThresholdLRSchedule as JaxThreshold
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.layer.rms import RunningMeanStd as JaxRms
from cusrl_tpu.nn.utils.normalization import mean_var_count as jax_mvc
from cusrl_tpu.nn.utils.normalization import merge_mean_var as jax_merge
from cusrl_tpu.template.environment import EnvironmentSpec as JaxSpec
from cusrl_tpu_torch.hook.mdp.observation import ObservationNormalization
from cusrl_tpu_torch.hook.on_policy.lr_schedule import AdaptiveLRSchedule, ThresholdLRSchedule
from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.nn.utils.normalization import mean_var_count, merge_mean_var
from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.template.optimizer import AdamFactory, build_optimizer

STATS = dict(rtol=1e-6, atol=1e-6)
NORMALIZED = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("mask_kind", ["none", "some", "empty"])
def test_mean_var_count_and_merge_match_jax(mask_kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 7)) * 3 + 1).astype(np.float32)
    mask = {"none": None, "some": rng.random((6, 5)) < 0.4, "empty": np.zeros((6, 5), bool)}[mask_kind]
    got = mean_var_count(torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask))
    want = jax_mvc(jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **STATS)
    old = (rng.standard_normal(7).astype(np.float32), rng.random(7).astype(np.float32) + 0.5, np.float32(12.0))
    merged = merge_mean_var(*(torch.as_tensor(v) for v in old), *got)
    jmerged = jax_merge(*(jnp.asarray(v) for v in old), *want)
    for a, b in zip(merged, jmerged):
        np.testing.assert_allclose(_np(a), np.asarray(b), **STATS)


@pytest.mark.parametrize("options", [
    dict(),
    dict(groups=((0, 1, 2), (4, 5)), excluded_indices=(6,), max_count=50.0),
])
def test_running_mean_std_matches_jax(options):
    rng = np.random.default_rng(1)
    port, ref = RunningMeanStd(7, **options, device="cpu"), JaxRms.init(7, **options)
    for step in range(5):
        x = (rng.standard_normal((16, 7)) * (step + 1) + step).astype(np.float32)
        mask = rng.random(16) < 0.5 if step != 2 else np.zeros(16, bool)  # step 2: an empty batch
        port.update(torch.from_numpy(x), mask=torch.from_numpy(mask))
        ref = ref.update(jnp.asarray(x), mask=jnp.asarray(mask))
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(_np(getattr(port, name)), np.asarray(getattr(ref, name)), **STATS)
        probe = (rng.standard_normal((4, 7)) * 40).astype(np.float32)
        np.testing.assert_allclose(_np(port.normalize(torch.from_numpy(probe))),
                                   np.asarray(ref.normalize(jnp.asarray(probe))), **NORMALIZED)


@pytest.mark.parametrize("defer_updates,store_originals,final_state_is_missing", [
    (False, True, False),  # the zoo's settings
    (True, False, False),  # bench.py's settings
    (False, False, True),
])
def test_observation_normalization_matches_jax(defer_updates, store_originals, final_state_is_missing):
    """A scripted sequence of observations and dones through pre_act /
    post_step (and pre_update every 3 steps): the transitions and the
    statistics agree after every call."""
    n, dim = 8, 5
    rng = np.random.default_rng(2)
    jax_spec = JaxSpec(observation_dim=dim, action_dim=2, num_instances=n, final_state_is_missing=final_state_is_missing)
    jhook = JaxObsNorm(defer_updates=defer_updates, store_originals=store_originals)
    jhook = jhook.init(types.SimpleNamespace(environment_spec=jax_spec), jax.random.key(0))
    spec = EnvironmentSpec(observation_dim=dim, action_dim=2, num_instances=n,
                           final_state_is_missing=final_state_is_missing)
    hook = ObservationNormalization(defer_updates=defer_updates, store_originals=store_originals)
    hook.init(types.SimpleNamespace(environment_spec=spec, device=torch.device("cpu")))
    assert sorted(hook.state_tensors()) == sorted(path for path, _ in tree_paths(jhook))

    obs = (rng.standard_normal((n, dim)) * 2 + 1).astype(np.float32)
    for step in range(7):
        transition = {"observation": torch.from_numpy(obs)}
        hook.pre_act(None, transition)
        jhook, jt = jhook.pre_act(None, {"observation": jnp.asarray(obs)})
        next_obs = (rng.standard_normal((n, dim)) * 2 + 1 + step).astype(np.float32)
        done = rng.random((n, 1)) < 0.3
        transition.update(next_observation=torch.from_numpy(next_obs), done=torch.from_numpy(done))
        jt.update(next_observation=jnp.asarray(next_obs), done=jnp.asarray(done))
        hook.post_step(None, transition)
        jhook, jt = jhook.post_step(None, jt)
        assert set(transition) == set(jt)
        for key in jt:
            np.testing.assert_allclose(_np(transition[key]), np.asarray(jt[key]), err_msg=key, **NORMALIZED)
        if step % 3 == 2:
            hook.pre_update(None, {})
            jhook, _, _ = jhook.pre_update(None, {})
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(_np(getattr(hook.observation_rms, name)),
                                       np.asarray(getattr(jhook.observation_rms, name)), err_msg=name, **STATS)
        if defer_updates:
            for a, b in zip(hook.obs_acc, jhook.obs_acc):
                np.testing.assert_allclose(_np(a), np.asarray(b), **STATS)
        obs = next_obs


def _schedule_agent(lr=1e-3):
    param = torch.nn.Parameter(torch.zeros(3))
    optimizer = build_optimizer(AdamFactory(lr=lr), [("actor.w", param)])
    return types.SimpleNamespace(actor=torch.nn.Module(), optimizer=optimizer, iteration=0,
                                 device=torch.device("cpu"))


class _JaxState:
    """The slice of the JAX AgentState the schedules' post_update reads."""

    def __init__(self, learning_rates, iteration):
        self.actor = object()
        self.learning_rates = learning_rates
        self.iteration = iteration

    def replace(self, **kwargs):
        new = _JaxState(self.learning_rates, self.iteration)
        new.__dict__.update(kwargs)
        return new


@pytest.mark.parametrize("kind", ["adaptive", "threshold"])
def test_lr_schedules_match_jax_over_a_kl_sequence(kind):
    """A sequence of post-update KL values with a 3-iteration warm-up: the
    scale, the error accumulators and the actor group's learning rate agree
    after every update (the JAX hook's own post_update and apply_schedule)."""
    kwargs = dict(warmup_iterations=3, initial_scale=0.25)
    if kind == "adaptive":
        hook, jhook = AdaptiveLRSchedule(0.01, **kwargs), JaxAdaptive(0.01, **kwargs)
    else:
        hook, jhook = ThresholdLRSchedule(0.01, **kwargs), JaxThreshold(0.01, **kwargs)
    agent = _schedule_agent()
    hook.init(agent)
    hook.post_init(agent)
    hook.apply_schedule(0, agent)
    jhook = jhook.replace(target_groups=("default",), base_lrs=(("default", 1e-3),)).apply_schedule(0)
    state = _JaxState({"default": jnp.asarray(1e-3, jnp.float32)}, 0)
    kls = [0.05, 0.03, 0.002, 0.04, 0.0, 0.011, 0.1, 0.1, 0.1, 0.001, 0.001, 0.02]
    for iteration, kl in enumerate(kls):
        state = state.replace(iteration=jnp.asarray(iteration, jnp.int32))
        rollout = {"__post_update_kl__": (state.actor, (jnp.asarray(kl, jnp.float32), None))}
        jhook, state, jm = jhook.post_update(state, rollout, None)
        agent.iteration = iteration
        metrics = hook.post_update(agent, {"__post_update_kl__": ((), (torch.tensor(kl), None))})
        agent.iteration = iteration + 1
        hook.apply_schedule(iteration + 1, agent)
        jhook = jhook.apply_schedule(iteration + 1)
        np.testing.assert_allclose(_np(metrics["lr_scale"]), np.asarray(jm["lr_scale"]), **STATS)
        for name, value in hook.state_tensors().items():
            np.testing.assert_allclose(_np(value), np.asarray(getattr(jhook, name)), err_msg=name, **STATS)
        np.testing.assert_allclose(agent.optimizer.learning_rates["default"],
                                   float(state.learning_rates["default"]), **STATS)


def test_load_jax_state_carries_hook_state_and_refuses_unknown_paths():
    """Hook state moves by the JAX paths (``hooks.<index>.<field>``); a
    missing or extra path of a stateful hook raises, configuration fields are
    skipped."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.interop import load_jax_state
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    factory.actor_hidden_dims = factory.critic_hidden_dims = (16,)
    factory.defer_normalization_updates = True
    agent = factory(VelocityLocomotionEnv(num_instances=4, device="cpu").spec, device="cpu")
    state = {path: p.detach().numpy().copy() for path, p in agent.model.named_parameters()}
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            state[f"hooks.{index}.{name}"] = np.full(tuple(tensor.shape), 3, dtype=tensor.numpy().dtype)
    norm = [i for i, h in enumerate(agent.hooks) if h.hook_name == "observation_normalization"][0]
    sched = [i for i, h in enumerate(agent.hooks) if h.hook_name == "adaptive_l_r_schedule"][0]
    state[f"hooks.{sched}.desired_kl_divergence"] = np.float32(0.01)  # configuration: skipped
    load_jax_state(agent, state)
    assert float(agent.hooks[norm].observation_rms.count) == 3.0 and float(agent.hooks[sched].lr_scale) == 3.0
    assert float(agent.hooks[norm].obs_acc[2]) == 3.0
    for broken in ({k: v for k, v in state.items() if k != f"hooks.{norm}.obs_acc.1"},
                   {**state, f"hooks.{sched}.unknown": np.float32(1.0)}):
        with pytest.raises(KeyError, match="state of hook"):
            load_jax_state(agent, broken)

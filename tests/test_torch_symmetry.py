"""The symmetry slice of the port against the JAX package, at small size:
the environment spec's new fields and its override hooks, ``MirrorDef``
(self-inverse, equal to JAX's), observation normalization with mirrored
statistics (direct and deferred), with the observation a subset of the
state, ``ObservationNanToNum``, ``TransitionMirroring``,
``SymmetricDataAugmentation`` (its transition fields, its batch edits on
axis 1 and on a temporal batch's axis 2, one whole update of path S),
``MirrorSymmetryLoss`` (one whole update of path SL), the mirrored recurrent
memories, ``SymmetricArchitecture`` / ``SymmetricActor`` (and its exports),
and the hook orders and the fused route, which raise or run where the JAX
package's do.

Tolerances: elementwise fp32 work 1e-6; running statistics 1e-5 relative
(fp32 sums in another order); the whole updates bf16 as
``tests/test_torch_aux_hooks.py`` states.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.auxiliary import symmetry as jax_symmetry
from cusrl_tpu.hook.mdp import environment_spec as jax_environment_spec
from cusrl_tpu.hook.mdp import observation as jax_observation
from cusrl_tpu.nn.base import reset_memory as jax_reset_memory
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.template.environment import EnvironmentSpec as JaxSpec
from cusrl_tpu.testing import DummyEnvironment as JaxDummyEnvironment
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.export import export_agent, load_exported_graph, load_exported_policy
from cusrl_tpu_torch.hook.auxiliary.symmetry import (
    MirrorDef,
    MirrorSymmetryLoss,
    SymmetricActor,
    SymmetricArchitecture,
    SymmetricDataAugmentation,
    TransitionMirroring,
)
from cusrl_tpu_torch.hook.mdp.environment_spec import DynamicEnvironmentSpecOverride, EnvironmentSpecOverride
from cusrl_tpu_torch.hook.mdp.observation import ObservationNanToNum, ObservationNormalization
from cusrl_tpu_torch.template.environment import EnvironmentSpec, TensorEnvironment
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_torch_aux_hooks import ACT, BF16_TOL, N, OBS, T, _t, build, compare, rollout_arrays, step_hooks
from tests.test_torch_aux_hooks import update_both

STATS = dict(rtol=1e-5, atol=1e-6)


def involution(dim: int, seed: int):
    """A random self-inverse mirror (pairs swapped, both members of a pair
    flipped together), as ``tests/test_symmetry.py`` draws them: ``(port
    MirrorDef, JAX MirrorDef)``."""
    rng = np.random.default_rng(seed)
    perm = np.arange(dim)
    order = rng.permutation(dim)
    for a, b in zip(order[0::2], order[1::2]):
        perm[a], perm[b] = perm[b], perm[a]
    flipped = [int(i) for i in rng.choice(dim, size=dim // 3, replace=False)]
    flips = sorted(set(flipped) | {int(perm[i]) for i in flipped})
    return MirrorDef(perm.tolist(), flips), jax_symmetry.MirrorDef(perm.tolist(), flips)


def halves(dim: int, flips):
    """Path S's mirror: swap the halves, flip a channel pair closed under
    the swap."""
    half = dim // 2
    dest = (*range(half, dim), *range(half))
    return MirrorDef(dest, flips), jax_symmetry.MirrorDef(dest, flips)


def mirrors(state_dim=None):
    """``(port overrides, JAX overrides)`` of the spec's mirror fields."""
    obs, jobs = involution(OBS, 0)
    act, jact = involution(ACT, 1)
    port, jax_ = {"mirror_observation": obs, "mirror_action": act}, {"mirror_observation": jobs,
                                                                     "mirror_action": jact}
    if state_dim is not None:
        port["mirror_state"], jax_["mirror_state"] = involution(state_dim, 2)
    return port, jax_


def _with_mirrors(state_dim=None):
    port, jax_ = mirrors(state_dim)

    def edit(jax_spec, spec):
        for key in port:
            setattr(jax_spec, key, jax_[key])
            setattr(spec, key, port[key])

    return edit


# -- the spec and MirrorDef ----------------------------------------------------


def test_spec_has_the_jax_fields_and_the_environments_set_their_instance():
    assert [f.name for f in dataclasses.fields(EnvironmentSpec)] == [f.name for f in dataclasses.fields(JaxSpec)]
    env = DummyEnvironment(observation_dim=4, action_dim=2, num_instances=3)
    assert env.spec.environment_instance is env
    assert JaxDummyEnvironment(observation_dim=4, action_dim=2, num_instances=3).spec.environment_instance is not None
    tensor_env = TensorEnvironment(EnvironmentSpec(observation_dim=4, action_dim=2))
    assert tensor_env.spec.environment_instance is tensor_env and tensor_env.spec.autoreset


def test_spec_overrides_match_jax():
    """``EnvironmentSpecOverride.create`` (sorted items) and the dynamic
    override from the environment instance set the same fields; the dynamic
    one raises without an instance, as JAX's."""
    mirror, jax_mirror = involution(4, 0)
    hook = EnvironmentSpecOverride.create({"timestep": 0.02}, mirror_observation=mirror)
    jax_hook = jax_environment_spec.EnvironmentSpecOverride.create({"timestep": 0.02},
                                                                   mirror_observation=jax_mirror)
    assert [k for k, _ in hook.overrides] == [k for k, _ in jax_hook.overrides] == ["mirror_observation", "timestep"]
    env = DummyEnvironment(observation_dim=4, action_dim=2, num_instances=3)
    hook.init(types.SimpleNamespace(environment_spec=env.spec))
    assert env.spec.timestep == 0.02 and env.spec.mirror_observation is mirror
    factory = lambda instance: {"state_stat_groups": ((0, 1),), "extras": {"n": instance.num_instances}}
    DynamicEnvironmentSpecOverride(factory).init(types.SimpleNamespace(environment_spec=env.spec))
    assert env.spec.state_stat_groups == ((0, 1),) and env.spec.extras == {"n": 3}
    with pytest.raises(ValueError, match="'environment_instance' is not set"):
        DynamicEnvironmentSpecOverride(factory).init(
            types.SimpleNamespace(environment_spec=EnvironmentSpec(observation_dim=4, action_dim=2)))


@pytest.mark.parametrize("dim,seed", [(10, 0), (48, 1), (12, 2)])
def test_mirror_def_is_self_inverse_and_equals_jax(dim, seed):
    mirror, jax_mirror = involution(dim, seed)
    x = np.random.default_rng(seed + 10).standard_normal((3, 4, dim)).astype(np.float32)
    got = mirror(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mirror(jnp.asarray(x))))
    np.testing.assert_array_equal(mirror(got).numpy(), x)
    assert got.dtype == torch.float32 and mirror(_t(x).to(torch.bfloat16)).dtype == torch.bfloat16
    assert mirror == MirrorDef(mirror.destination_indices, mirror.flipped_indices)
    assert hash(mirror) == hash(jax_mirror) and repr(mirror) == repr(jax_mirror)
    # Path S's mirrors are self-inverse too.
    for dim_, flips in ((48, (0, 1, 24, 25)), (12, (0, 6))):
        half, _ = halves(dim_, flips)
        y = torch.randn(5, dim_)
        assert torch.equal(half(half(y)), y)


# -- observation normalization ---------------------------------------------------


def _normalization_pair(spec_kwargs, **hook_kwargs):
    mirrors_port, mirrors_jax = {}, {}
    if spec_kwargs.pop("mirrored", False):
        mirrors_port, mirrors_jax = mirrors(spec_kwargs.get("state_dim"))
    spec = EnvironmentSpec(observation_dim=OBS, action_dim=ACT, num_instances=N, **spec_kwargs, **mirrors_port)
    jax_spec = JaxSpec(observation_dim=OBS, action_dim=ACT, num_instances=N, **spec_kwargs, **mirrors_jax)
    hook = ObservationNormalization(**hook_kwargs)
    hook.init(types.SimpleNamespace(environment_spec=spec, device=torch.device("cpu")))
    jax_hook = jax_observation.ObservationNormalization(**hook_kwargs).init(
        types.SimpleNamespace(environment_spec=jax_spec), jax.random.key(0))
    return hook, jax_hook


@pytest.mark.parametrize("case", ["mirrored", "mirrored_deferred", "subset_of_state", "subset_deferred"])
def test_observation_statistics_match_jax(case):
    """Three steps of ``pre_act`` / ``post_step`` (resets in between) and,
    deferred, ``pre_update``: the mirrored statistics (observation and
    state) or the observation's taken from the state's at its indices, and
    the normalized transitions."""
    state_dim = 20
    spec_kwargs = {"state_dim": state_dim}
    if case.startswith("mirrored"):
        spec_kwargs["mirrored"] = True
    else:
        spec_kwargs["observation_is_subset_of_state"] = tuple(range(2, 2 + OBS))
    hook, jax_hook = _normalization_pair(spec_kwargs, defer_updates=case.endswith("deferred"))
    rng = np.random.default_rng(5)
    agent = types.SimpleNamespace(process_group=None)
    for step in range(3):
        tr = {"observation": rng.standard_normal((N, OBS)).astype(np.float32) * 3 + 1,
              "state": rng.standard_normal((N, state_dim)).astype(np.float32) * 2 - 1,
              "next_observation": rng.standard_normal((N, OBS)).astype(np.float32) + 2,
              "next_state": rng.standard_normal((N, state_dim)).astype(np.float32) - 0.5,
              "done": rng.random((N, 1)) < 0.3}
        jax_tr = jax.tree.map(jnp.asarray, tr)
        port_tr = {k: _t(v) for k, v in tr.items()}
        for callback in ("pre_act", "post_step"):
            jax_hook, jax_tr = getattr(jax_hook, callback)(None, jax_tr)
            getattr(hook, callback)(agent, port_tr)
        for key in ("observation", "state", "next_observation", "next_state"):
            np.testing.assert_allclose(port_tr[key].numpy(), np.asarray(jax_tr[key]), err_msg=key, rtol=1e-5,
                                       atol=1e-5)
    jax_hook, _, _ = jax_hook.pre_update(None, {})
    hook.pre_update(agent, {})
    jax_state = dict(tree_paths(jax_hook))
    for name, tensor in hook.state_tensors().items():
        np.testing.assert_allclose(tensor.float().numpy(), np.asarray(jax_state[name], np.float32), err_msg=name,
                                   **STATS)
    assert float(hook.observation_rms.count) > 0


def test_observation_nan_to_num_matches_jax():
    x = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
    for kwargs in ({}, {"nan": -1.0, "posinf": 5.0, "neginf": -5.0}):
        tr = {"observation": x, "state": x * 2, "next_observation": x, "next_state": None}
        jax_hook = jax_observation.ObservationNanToNum(**kwargs)
        _, jax_tr = jax_hook.pre_act(None, {k: jnp.asarray(v) for k, v in tr.items() if v is not None})
        _, jax_tr = jax_hook.post_step(None, jax_tr)
        port_tr = {k: _t(v) for k, v in tr.items() if v is not None}
        hook = ObservationNanToNum(**kwargs)
        hook.pre_act(None, port_tr)
        hook.post_step(None, port_tr)
        for key in ("observation", "state", "next_observation"):
            np.testing.assert_array_equal(port_tr[key].numpy(), np.asarray(jax_tr[key]), err_msg=key)


# -- transition-level hooks ------------------------------------------------------


def _symmetry_pair(cls, jax_cls, state_dim=6, three=False, **kwargs):
    port, jax_ = mirrors(state_dim)
    if three:  # a mirror with two variants: the original and its negation
        obs, jobs = port["mirror_observation"], jax_["mirror_observation"]
        port["mirror_observation"] = lambda x: torch.stack([obs(x), -obs(x)])
        jax_["mirror_observation"] = lambda x: jnp.stack([jobs(x), -jobs(x)])
    spec = EnvironmentSpec(observation_dim=OBS, action_dim=ACT, num_instances=N, state_dim=state_dim, **port)
    jax_spec = JaxSpec(observation_dim=OBS, action_dim=ACT, num_instances=N, state_dim=state_dim, **jax_)
    actor = types.SimpleNamespace(is_recurrent=False)
    agent = types.SimpleNamespace(environment_spec=spec, actor=actor, critic=actor, parallelism=N,
                                  device=torch.device("cpu"), observation_dim=OBS, records_per_step_memory=False)
    hook = cls(**kwargs)
    hook.init(agent)
    jax_hook = jax_cls(**kwargs).init(types.SimpleNamespace(environment_spec=jax_spec, actor=actor, critic=actor),
                                      jax.random.key(0))
    return hook, jax_hook, agent


def _transition(rng, state_dim=6):
    return {"observation": rng.standard_normal((N, OBS)).astype(np.float32),
            "next_observation": rng.standard_normal((N, OBS)).astype(np.float32),
            "state": rng.standard_normal((N, state_dim)).astype(np.float32),
            "next_state": rng.standard_normal((N, state_dim)).astype(np.float32),
            "action": rng.standard_normal((N, ACT)).astype(np.float32), "done": rng.random((N, 1)) < 0.2}


def test_transition_mirroring_matches_jax():
    hook, jax_hook, agent = _symmetry_pair(TransitionMirroring, jax_symmetry.TransitionMirroring)
    tr = _transition(np.random.default_rng(6))
    jax_tr = jax.tree.map(jnp.asarray, tr)
    port_tr = {k: _t(v) for k, v in tr.items()}
    for callback in ("pre_act", "post_act", "post_step"):
        jax_hook, jax_tr = getattr(jax_hook, callback)(None, jax_tr)
        getattr(hook, callback)(agent, port_tr)
    for key in tr:
        np.testing.assert_array_equal(port_tr[key].numpy(), np.asarray(jax_tr[key]), err_msg=key)
    assert not np.array_equal(port_tr["observation"].numpy(), tr["observation"])


@pytest.mark.parametrize("three", [False, True])
def test_data_augmentation_fields_and_batch_edits_match_jax(three):
    """``post_step``'s ``augmented_*`` fields, ``[N, K+1, C]`` (with a
    two-variant mirror ``K = 2``), then the objective's edits of a flat
    batch (axis 1) and of a temporal one (axis 2): the replaced inputs and
    the repeated ``action_logp``, ``advantage``, ``value`` and ``return``."""
    hook, jax_hook, agent = _symmetry_pair(SymmetricDataAugmentation, jax_symmetry.SymmetricDataAugmentation,
                                           three=three)
    if three:  # the two variants of the action too
        act, jact = hook.mirror_action, jax_hook.mirror_action
        hook.mirror_action = lambda x: torch.stack([act(x), -act(x)])
        hook.mirror_state = lambda x: torch.stack([x, -x])
        jax_hook = jax_hook.replace(mirror_action=lambda x: jnp.stack([jact(x), -jact(x)]),
                                    mirror_state=lambda x: jnp.stack([x, -x]))
    tr = _transition(np.random.default_rng(7))
    jax_hook, jax_tr = jax_hook.post_step(None, jax.tree.map(jnp.asarray, tr))
    port_tr = {k: _t(v) for k, v in tr.items()}
    hook.post_step(agent, port_tr)
    streams = 3 if three else 2
    for key in ("augmented_observation", "augmented_next_observation", "augmented_state", "augmented_next_state",
                "augmented_action"):
        assert port_tr[key].shape[:2] == (N, streams), key
        np.testing.assert_array_equal(port_tr[key].numpy(), np.asarray(jax_tr[key]), err_msg=key)
    rng = np.random.default_rng(8)
    for temporal in (False, True):
        lead = (T, N // 8) if temporal else (N,)
        batch = {k: rng.standard_normal((*lead, *port_tr[k].shape[1:])).astype(np.float32)
                 for k in port_tr if k.startswith("augmented")}
        batch.update({k: rng.standard_normal((*lead, 1)).astype(np.float32)
                      for k in ("action_logp", "advantage", "value", "return")})
        _, jax_batch, _, _ = jax_hook.objective(None, {"temporal": temporal}, jax.tree.map(jnp.asarray, batch))
        port_batch = {k: _t(v) for k, v in batch.items()}
        hook.objective(agent, {"temporal": temporal}, port_batch)
        for key in ("observation", "next_observation", "action", "state", "next_state", "action_logp", "advantage",
                    "value", "return"):
            assert port_batch[key].shape == jax_batch[key].shape, key
            np.testing.assert_array_equal(port_batch[key].numpy(), np.asarray(jax_batch[key]), err_msg=key)


def test_symmetry_hooks_need_the_mirrors():
    for missing in ("mirror_observation", "mirror_action", "mirror_state"):
        port, _ = mirrors(6)
        del port[missing]
        spec = EnvironmentSpec(observation_dim=OBS, action_dim=ACT, state_dim=6, **port)
        with pytest.raises(ValueError, match=f"'{missing}' must be defined"):
            MirrorSymmetryLoss().init(types.SimpleNamespace(environment_spec=spec))


# -- whole updates: paths S and SL -----------------------------------------------


def _s_override(port: bool):
    """Path S's override at small widths: the halves of the observation and
    the action swapped, one channel pair flipped."""
    obs = halves(OBS, (0, 1, OBS // 2, OBS // 2 + 1))
    act = halves(ACT, (0, ACT // 2))
    index = 0 if port else 1
    cls = EnvironmentSpecOverride if port else jax_environment_spec.EnvironmentSpecOverride
    return cls.create(mirror_observation=obs[index], mirror_action=act[index])


@pytest.mark.parametrize("path", ["S", "SL"])
def test_symmetric_update_matches_jax(path):
    """Path S (``SymmetricDataAugmentation`` before the joint evaluation:
    the update's batch doubles) and path SL (``MirrorSymmetryLoss`` after
    ``on_policy_preparation``), each with the override at index 0: the
    mirrored observation statistics of the rollout (``post_step`` over its
    next observations), then one whole update."""
    if path == "S":
        extra = (jax_symmetry.SymmetricDataAugmentation(), SymmetricDataAugmentation(),
                 {"before": "joint_policy_value_evaluation"})
    else:
        extra = (jax_symmetry.MirrorSymmetryLoss(weight=1.0), MirrorSymmetryLoss(weight=1.0),
                 {"after": "on_policy_preparation"})
    jax_agent, agent = build([(_s_override(False), _s_override(True), {"index": 0}), extra])
    assert agent.environment_spec.mirror_observation == MirrorDef(*[(*range(8, 16), *range(8)), (0, 1, 8, 9)])
    rollout = rollout_arrays(jax_agent, 14)
    names = ["observation_normalization"] + (["symmetric_data_augmentation"] if path == "S" else [])
    jax_steps, steps = step_hooks(jax_agent, agent, rollout, names)
    for key in steps:
        np.testing.assert_allclose(steps[key], jax_steps[key], rtol=1e-5, atol=1e-5, err_msg=key)
    normalized = {**rollout, **jax_steps}
    port_normalized = jax.tree.map(_t, {**rollout, **steps})
    jax_metrics, metrics, new = update_both(jax_agent, agent, normalized, port_normalized)
    if path == "SL":
        assert "action_mean_symmetry_loss" in metrics
    compare(jax_metrics, metrics, new, agent, BF16_TOL)


def test_hook_order_and_fused_route_follow_jax():
    """With the joint evaluation, augmentation placed after it (before
    ``on_policy_preparation``) meets the un-augmented evaluation and fails
    to broadcast in both packages; the symmetry loss on the fused PPO update
    (no ``curr_action_dist``) raises ``KeyError`` in both."""
    hook, jax_hook, agent = _symmetry_pair(MirrorSymmetryLoss, jax_symmetry.MirrorSymmetryLoss)
    batch = {"observation": np.zeros((4, OBS), np.float32)}
    agent.actor = lambda x, m, **k: ({"mean": x[..., :ACT], "std": x[..., :ACT]}, None, {})
    with pytest.raises(KeyError, match="curr_action_dist"):
        hook.objective(agent, {}, {k: _t(v) for k, v in batch.items()})
    state = types.SimpleNamespace(actor=lambda x, m, **k: ({"mean": x[..., :ACT], "std": x[..., :ACT]}, None, {}))
    with pytest.raises(KeyError, match="curr_action_dist"):
        jax_hook.objective(state, {}, jax.tree.map(jnp.asarray, batch))
    jf = jax_get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    tf = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    names = [[h.hook_name for h in f.to_underlying().hooks] for f in (jf, tf)]
    assert names[0] == names[1]
    assert names[1].index("joint_policy_value_evaluation") < names[1].index("on_policy_preparation")
    from cusrl_tpu_torch.hook.on_policy.common import OnPolicyPreparation

    batch = {"curr_action_dist": {"mean": torch.zeros(4, ACT), "std": torch.ones(4, ACT)},
             "action": torch.zeros(4, 2, ACT), "action_logp": torch.zeros(4, 2, 1)}
    with pytest.raises(RuntimeError, match="size of tensor"):
        OnPolicyPreparation().objective(types.SimpleNamespace(actor=agent_actor()), {}, batch)


def agent_actor():
    from cusrl_tpu_torch.nn.module.actor import ActorFactory
    from cusrl_tpu_torch.nn.module.mlp import MlpFactory

    return ActorFactory(MlpFactory(hidden_dims=(8,)))(OBS, ACT, torch.Generator().manual_seed(0))


# -- recurrent memories and the symmetric actor ---------------------------------


def test_mirrored_recurrent_memories_match_jax():
    """A GRU actor (``recurrent_ppo`` at hidden 8): the symmetry loss's
    mirrored memory after the rollout's steps against the JAX hook's; the
    augmentation's mirrored actor and critic streams (``[N, K, ...]``, K = 1)
    against the JAX backbones stepped on the mirrored inputs with resets.
    The JAX augmentation itself cannot step a recurrent actor: its initial
    mirrored memory has no stream axis, and the first ``post_step`` fails to
    concatenate it (shown here); the port keeps the stream axis from the
    start."""
    def small(f):
        for key, value in dict(num_steps_per_update=T, rnn_hidden_size=8, mlp_hidden_dims=(8,)).items():
            setattr(f, key, value)
        return f.to_underlying()

    jf, tf = (small(g("Velocity-Flat", "recurrent_ppo").make_agent_factory()) for g in (jax_get_experiment,
                                                                                     get_experiment))
    hooks = [(jax_symmetry.MirrorSymmetryLoss(), MirrorSymmetryLoss(), {"after": "on_policy_preparation"})]
    jax_agent, agent = build(hooks, factory=(jf, tf), spec_edit=_with_mirrors())
    augmentation = SymmetricDataAugmentation()
    augmentation.init(agent)
    agent.hooks.append(augmentation)
    jax_augmentation = jax_symmetry.SymmetricDataAugmentation().init(jax_agent, jax.random.key(0))
    rollout = rollout_arrays(jax_agent, 15)
    with pytest.raises(TypeError, match="different numbers of dimensions"):
        jax_augmentation.post_step(jax_agent.state, {k: jnp.asarray(rollout[k][0]) for k in (
            "observation", "next_observation", "action", "done")} | {"actor_memory": jax_agent.state.actor.init_memory(N)})
    step_hooks(jax_agent, agent, rollout, ["mirror_symmetry_loss"])
    jax_state = dict(tree_paths(jax_agent.get_hook("mirror_symmetry_loss")))
    for key, tensor in agent.get_hook("mirror_symmetry_loss").state_tensors().items():
        np.testing.assert_allclose(tensor.numpy(), np.asarray(jax_state[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    # The augmentation's streams, against the JAX backbones on the mirrored inputs.
    mirror = jax_agent.get_hook("mirror_symmetry_loss").mirror_observation
    want = {"actor": jax_agent.state.actor.init_memory(N), "critic": jax_agent.state.critic.init_memory(N)}
    for t in range(T):
        tr = {k: _t(rollout[k][t]) for k in ("observation", "next_observation", "action", "done")}
        augmentation.post_step(agent, tr)
        done = jnp.asarray(rollout["done"][t])
        mirrored = mirror(jnp.asarray(rollout["observation"][t]))
        for name in want:
            _, memory, _ = getattr(jax_agent.state, name).backbone(mirrored, want[name])
            want[name] = jax_reset_memory(memory, done)
    for name, memory in (("actor", augmentation.mirrored_actor_memory), ("critic",
                                                                          augmentation.mirrored_critic_memory)):
        for (path, got), (_, ref) in zip(tree_paths(memory), tree_paths(want[name])):
            assert got.shape == (N, 1, *ref.shape[1:]), path
            np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=path)
    assert set(agent.rollout_memory_entries()) == {"actor_memory", "critic_memory", "mirrored_actor_memory"}
    entries = augmentation.rollout_memory_entries()
    assert set(entries) == {"augmented_actor_memory", "augmented_critic_memory"}
    for name in ("actor", "critic"):  # the original stream first, then the mirrored one
        leaf = next(iter(entries[f"augmented_{name}_memory"].values()))
        assert leaf.shape[:2] == (N, 2)
    leaf = next(iter(entries["augmented_actor_memory"].values()))
    torch.testing.assert_close(leaf[:, 0], next(iter(agent.actor_memory.values())))


def test_symmetric_actor_matches_jax_and_exports(tmp_path):
    """``SymmetricArchitecture`` wraps the actor on both sides (the same
    parameter paths): the averaged distribution and the deterministic action
    equal JAX's, the policy is symmetric, and the agent exports (``package``
    and ``torch_export``) and acts in inference mode."""
    jax_agent, agent = build([(jax_symmetry.SymmetricArchitecture(), SymmetricArchitecture(), {"index": 0})],
                             spec_edit=_with_mirrors(), compute_dtype=None)
    assert isinstance(agent.actor, SymmetricActor)
    assert type(jax_agent.state.actor).__name__ == "SymmetricActor"
    obs = np.random.default_rng(16).standard_normal((5, OBS)).astype(np.float32)
    dist, _, aux = jax_agent.state.actor(jnp.asarray(obs))
    action, _ = jax_agent.state.actor.act_deterministic(jnp.asarray(obs))
    with torch.no_grad():
        port_dist, _, port_aux = agent.actor(_t(obs))
        port_action, _ = agent.actor.act_deterministic(_t(obs))
    for key in ("mean", "std"):
        np.testing.assert_allclose(port_dist[key].numpy(), np.asarray(dist[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(port_action.numpy(), np.asarray(action), rtol=1e-5, atol=1e-6)
    assert set(port_aux) == set(aux)
    mirror_obs, mirror_act = agent.environment_spec.mirror_observation, agent.environment_spec.mirror_action
    with torch.no_grad():
        mirrored, _ = agent.actor.act_deterministic(mirror_obs(_t(obs)))
    torch.testing.assert_close(mirror_act(mirrored), port_action, rtol=1e-5, atol=1e-5)
    export_agent(agent, str(tmp_path / "pkg"), target_format="package", verbose=False)
    assert isinstance(load_exported_policy(str(tmp_path / "pkg")), SymmetricActor)
    export_agent(agent, str(tmp_path / "graph"), target_format="torch_export", verbose=False)
    call, manifest = load_exported_graph(str(tmp_path / "graph"))
    out = call({"observation": _t(obs[:1])})
    torch.testing.assert_close(out["action"], port_action[:1], rtol=1e-5, atol=1e-5)
    agent.set_inference_mode(True)
    assert agent.act(np.resize(obs, (N, OBS))).shape == (N, ACT)

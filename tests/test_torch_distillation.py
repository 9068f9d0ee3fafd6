"""The distillation slice of the port against the JAX package, at small
size: the Stub and Identity modules, the preset (its fields, hooks, Stub
critic and optimizer labels), ``PolicyDistillationLoss``, the frozen expert
given by ``expert=`` (an MLP one and a GRU one whose memory resets where an
episode ends) and loaded from a ``package`` export (on the agent's device,
out of the optimizer), one whole distillation update, and the checkpoint of
a distillation agent in either package.

The student is the preset at widths 32-16 on both sides; the expert is a
PPO actor built by the JAX package, carried into the port's expert through
``load_jax_state``.  Tolerances: fp32 1e-6 (the losses on fp32 inputs, the
Stub); bf16 backbones as ``tests/test_torch_aux_hooks.py`` states (the
expert's actions, one bf16 rounding apart, 1e-2).
"""

from __future__ import annotations

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.auxiliary import distillation as jax_distillation
from cusrl_tpu.nn.module import stub as jax_stub
from cusrl_tpu.preset.distillation import DistillationAgentFactory as JaxDistillationAgentFactory
from cusrl_tpu.template.logger import load_checkpoint_file as jax_load_checkpoint_file
from cusrl_tpu.template.logger import save_checkpoint_file as jax_save_checkpoint_file
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.export import export_agent
from cusrl_tpu_torch.hook.auxiliary.distillation import PolicyDistillation, PolicyDistillationLoss
from cusrl_tpu_torch.nn.base import storable_memory
from cusrl_tpu_torch.nn.module.stub import Identity, IdentityFactory, StubModule, StubModuleFactory
from cusrl_tpu_torch.preset.distillation import DistillationAgentFactory
from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_torch_aux_hooks import ACT, BF16_TOL, FP32, N, OBS, T, _t, build, compare, rollout_arrays, step_hooks
from tests.test_torch_aux_hooks import update_both

HOOK = "policy_distillation"
STUDENT = dict(num_steps_per_update=T, actor_hidden_dims=(32, 16))


def test_stub_modules_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    stub, jax_stub_module = StubModuleFactory()(7, 2), jax_stub.StubModuleFactory()(7, 2, jax.random.key(0))
    out, memory, aux = stub(_t(x), "m")
    jax_out, _, _ = jax_stub_module(jnp.asarray(x))
    assert out.shape == jax_out.shape == (3, 5, 2) and out.dtype == torch.float32 and not out.any()
    assert memory == "m" and aux == {} and not stub.is_recurrent
    assert StubModuleFactory()(7, None).output_dim == jax_stub.StubModuleFactory()(7, None, None).output_dim == 1
    identity = IdentityFactory()(7, 3)
    assert isinstance(identity, Identity) and identity.output_dim == 7 and torch.equal(identity(_t(x))[0], _t(x))
    assert StubModule.Factory is StubModuleFactory and Identity.Factory is IdentityFactory


def test_policy_distillation_loss_matches_jax():
    rng = np.random.default_rng(1)
    batch = {"curr_action_dist": {"mean": rng.standard_normal((9, ACT)).astype(np.float32)},
             "teacher": rng.standard_normal((9, ACT)).astype(np.float32)}
    _, _, want, _ = jax_distillation.PolicyDistillationLoss(target_name="teacher", weight=0.3).objective(
        None, {}, jax.tree.map(jnp.asarray, batch))
    hook = PolicyDistillationLoss(target_name="teacher", weight=0.3)
    got, _ = hook.objective(None, {}, jax.tree.map(_t, batch))
    assert hook.batch_keys == ("teacher",) and set(got) == set(want) == {"distillation_loss"}
    np.testing.assert_allclose(float(got["distillation_loss"]), float(want["distillation_loss"]), **FP32)


@pytest.fixture(scope="module")
def experts():
    """A PPO actor of the JAX package (ELU 32-16) and the port's with its
    weights: the expert on both sides."""
    jax_agent, agent = build()
    return jax_agent.state.actor, agent.actor


def _distillation_agents(experts, **kwargs):
    jax_expert, expert = experts
    jf = JaxDistillationAgentFactory(expert=jax_expert, **STUDENT, **kwargs)
    tf = DistillationAgentFactory(expert=expert, **STUDENT, **kwargs)
    return build(factory=(jf.to_underlying(), tf.to_underlying()))


def test_distillation_preset_matches_jax(experts):
    """The preset's fields and defaults, its hooks, the Stub critic and the
    optimizer's labels (the expert in none) equal the JAX preset's."""
    assert [(f.name, f.default) for f in dataclasses.fields(DistillationAgentFactory)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxDistillationAgentFactory)]
    jax_agent, agent = _distillation_agents(experts)
    assert [h.hook_name for h in agent.hooks] == [h.hook_name for h in jax_agent.state.hooks] == [
        "module_initialization", "on_policy_preparation", HOOK, "gradient_clipping"]
    assert isinstance(agent.critic.backbone, StubModule)
    assert agent.optimizer.labels == jax_agent.optimizer.labels_flat
    assert not any(".expert." in path for path in agent.optimizer.labels)
    expert = agent.get_hook(HOOK).expert
    assert not any(p.requires_grad for p in expert.parameters())
    assert set(agent.model["hooks"][HOOK]) == {"expert"}


def test_distillation_update_matches_jax(experts):
    """The expert's actions over the rollout (``post_step``), then one
    whole update of the student: ``distillation_loss``, the ratio, entropy
    and gradient norm, every parameter (the expert's unchanged)."""
    jax_agent, agent = _distillation_agents(experts)
    rollout = rollout_arrays(jax_agent, 21)
    jax_steps, steps = step_hooks(jax_agent, agent, rollout, [HOOK])
    np.testing.assert_allclose(steps["expert_action"], jax_steps["expert_action"], rtol=1e-2, atol=1e-2)
    before = {k: v.clone() for k, v in agent.get_hook(HOOK).expert.state_dict().items()}
    jax_metrics, metrics, new = update_both(jax_agent, agent, {**rollout, **jax_steps},
                                            jax.tree.map(_t, {**rollout, **steps}))
    assert "distillation_loss" in metrics
    paths = compare(jax_metrics, metrics, new, agent, BF16_TOL)
    assert f"hooks.{HOOK}.expert.backbone.layers.0.weight" in paths
    for key, value in agent.get_hook(HOOK).expert.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_recurrent_expert_memory_resets_like_jax():
    """A GRU expert (``recurrent_ppo`` at hidden 8): its deterministic
    actions and its memory over 8 steps with episode ends, against the JAX
    hook's."""
    def small(f):
        for key, value in dict(num_steps_per_update=T, rnn_hidden_size=8, mlp_hidden_dims=(8,)).items():
            setattr(f, key, value)
        return f.to_underlying()

    jax_agent, agent = build(factory=tuple(small(g("Velocity-Flat", "recurrent_ppo").make_agent_factory())
                                           for g in (jax_get_experiment, get_experiment)))
    fake = types.SimpleNamespace(parallelism=N, device=torch.device("cpu"))
    jax_hook = jax_distillation.PolicyDistillation(expert=jax_agent.state.actor).init(fake, jax.random.key(0))
    hook = PolicyDistillation(expert=agent.actor)
    hook.init(fake)
    rng = np.random.default_rng(22)
    post_step = jax.jit(lambda h, tr: h.post_step(None, tr))
    for step in range(T):
        tr = {"observation": rng.standard_normal((N, OBS)).astype(np.float32), "done": rng.random((N, 1)) < 0.3}
        jax_hook, jax_tr = post_step(jax_hook, jax.tree.map(jnp.asarray, tr))
        port_tr = {k: _t(v) for k, v in tr.items()}
        hook.post_step(None, port_tr)
        np.testing.assert_allclose(port_tr["expert_action"].float().numpy(),
                                   np.asarray(jax_tr["expert_action"], np.float32), rtol=1e-2, atol=1e-2)
    jax_memory = dict(jax.tree_util.tree_leaves_with_path(jax_hook.expert_memory))
    (name, tensor), = hook.state_tensors().items()
    assert name == "expert_memory.0"
    np.testing.assert_allclose(tensor.numpy(), np.asarray(next(iter(jax_memory.values()))), rtol=1e-4, atol=1e-4)
    assert storable_memory(hook.expert_memory, N)["0"].shape[0] == N


def test_expert_from_a_package_export(experts, tmp_path):
    """``expert_path``: the actor of a ``package`` export, on the agent's
    device, frozen (out of the optimizer and its gradient), registered at
    ``hooks.policy_distillation.expert.*``, acting as the exporting actor."""
    _, expert = experts
    source = types.SimpleNamespace(actor=expert, hooks=[], environment_spec=types.SimpleNamespace(
        observation_dim=OBS, action_dim=ACT, observation_normalization=None, action_denormalization=None))
    export_agent(source, str(tmp_path / "expert"), target_format="package", verbose=False)
    factory = DistillationAgentFactory(expert_path=str(tmp_path / "expert"), **STUDENT)
    from cusrl_tpu_torch.template.environment import EnvironmentSpec

    agent = factory(EnvironmentSpec(observation_dim=OBS, action_dim=ACT, num_instances=N), device="cpu")
    loaded = agent.get_hook(HOOK).expert
    assert loaded is agent.model["hooks"][HOOK]["expert"] and loaded is not expert
    assert all(p.device.type == "cpu" and not p.requires_grad for p in loaded.parameters())
    assert not any(".expert." in path for path in agent.optimizer.labels)
    assert {f"hooks.{HOOK}.expert.backbone.layers.0.weight", f"hooks.{HOOK}.expert.distribution.std_param"} <= set(
        dict(agent.model.named_parameters()))
    obs = torch.tanh(torch.randn(N, OBS, generator=torch.Generator().manual_seed(3)))
    tr = {"observation": obs, "done": torch.zeros(N, 1, dtype=torch.bool)}
    agent.get_hook(HOOK).post_step(agent, tr)
    with torch.no_grad():
        want, _ = expert.act_deterministic(obs)
    torch.testing.assert_close(tr["expert_action"], want)
    with pytest.raises(ValueError, match="Provide 'expert' module or 'expert_path'"):
        PolicyDistillation().init(types.SimpleNamespace(device="cpu", parallelism=N))


def test_distillation_checkpoint_loads_in_either_package(experts, tmp_path):
    """The port's checkpoint of a distillation agent (the expert's weights
    under ``hooks.2.expert.*``) loads in the JAX package without a warning,
    and the JAX one in the port, value for value."""
    jax_agent, agent = _distillation_agents(experts)
    with torch.no_grad():
        agent.actor.distribution.std_param.add_(0.5)
    path = str(tmp_path / "port.npz")
    save_checkpoint_file(path, {"agent": agent.state_dict(), "iteration": 3})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_agent.load_state_dict(jax_load_checkpoint_file(path)["agent"])
    assert not [str(w.message) for w in caught if "checkpoint" in str(w.message).lower()]
    state, jax_state = agent.state_dict()["agent_state"], jax_agent.state_dict()["agent_state"]
    assert set(state) == set(jax_state) and "hooks.2.expert.backbone.layers.1.bias" in state
    for key, value in state.items():
        np.testing.assert_array_equal(value, np.asarray(jax_state[key], value.dtype), err_msg=key)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint_file(path, {"agent": jax_agent.state_dict(), "iteration": 3})
    _, fresh = _distillation_agents(experts)
    with pytest.warns(RuntimeWarning, match="No 'torch_rng' entry"):  # a JAX file has no generator state
        fresh.load_state_dict(load_checkpoint_file(path)["agent"])
    assert fresh.iteration == jax_agent.iteration
    for key, value in fresh.state_dict()["agent_state"].items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)

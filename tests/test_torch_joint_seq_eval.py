"""``JointSequentialEvaluation`` in the port against the JAX hook, on the CPU
(``tests/test_joint_seq_eval.py`` is the JAX package's own).

Both agents come from the transformer PPO factory at small widths (embed 32,
2 heads, window 4, an MLP tail of 16, 16-D observations, 4-D actions) with
``fuse_actor_critic_evaluation=True``; the port takes the JAX agent's weights
through ``load_jax_state``.  Inputs are made with numpy from a seed.

Tolerances: the pair route (bf16 weights, ``CUSRL_TPU_FUSED_TRANSFORMER=
force``: the fused block's plain versions here, Pallas in interpret mode in
JAX) holds outputs to 5e-2 (the JAX package's fused-against-modular
tolerance: JAX's interpret mode drops one bf16 rounding of the residual,
tests/test_torch_fused_block.py) and each gradient to 2e-2 of the largest
gradient of its network.  The actor's gradients are small beside its mean
head's (the head's orthogonal gain is 0.01), and the two sides' bf16
roundings of its cotangents, which fall differently, move them by up to
15 % of their own largest element while the same comparison in fp32 agrees
to 1e-6.  The modular route (fp32 weights, so not fused-eligible) holds
1e-5 of the largest element: the same arithmetic in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import cusrl_tpu
from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.template.hook import find_hook
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.hook.on_policy.joint_seq_eval import JointSequentialEvaluation
from cusrl_tpu_torch.nn.module import causal_attn as tca
from cusrl_tpu_torch.preset.ppo import TransformerPpoAgentFactory
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state

OBS, ACT, T, N = 16, 4, 8, 16
KWARGS = dict(embed_dim=32, num_heads=2, attention_window=4, mlp_hidden_dims=(16,), num_steps_per_update=T,
              sampler_epochs=2, sampler_mini_batches=2, normalize_observation=True, fuse_actor_critic_evaluation=True)
PAIR_OUT = dict(rtol=5e-2, atol=5e-2)
PAIR_GRAD = 2e-2  # of the network's largest gradient
MODULAR_OUT = dict(rtol=1e-5, atol=1e-5)
MODULAR_GRAD = 1e-5


def _make_agents(monkeypatch, compute_dtype):
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    cusrl_tpu.set_global_seed(0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    jax_agent = cusrl_tpu.TransformerPpoAgentFactory(**KWARGS)(JaxEnv(num_instances=32, observation_dim=OBS,
                                                                      action_dim=ACT).spec)
    agent = TransformerPpoAgentFactory(**KWARGS)(
        VelocityLocomotionEnv(num_instances=32, observation_dim=OBS, action_dim=ACT, device="cpu").spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    assert [h.hook_name for h in agent.hooks] == [h.hook_name for h in jax_agent.state.hooks]
    return jax_agent, agent


@pytest.fixture(scope="module")
def agents():
    """The bf16 agents, built once for the module (building the JAX agent
    dominates these tests' time); the tests leave their weights as they are."""
    with pytest.MonkeyPatch.context() as patch:
        yield _make_agents(patch, "bfloat16")


def _batches(jax_agent, agent, seed):
    """The same temporal minibatch for both: observations, dones mid-rollout
    and part-valid rollout-initial rings (``[1, N, ...]``)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, N, OBS)).astype(np.float32)
    done = rng.random((T, N, 1)) < 0.2
    jbatch, batch = {"observation": jnp.asarray(obs), "done": jnp.asarray(done)}, {
        "observation": torch.from_numpy(obs), "done": torch.from_numpy(done)}
    for key, module in (("actor_memory", jax_agent.state.actor), ("critic_memory", jax_agent.state.critic)):
        mem = module.init_memory(N)["0"]
        mem = {
            "k_cache": jnp.asarray(rng.standard_normal(mem["k_cache"].shape), jnp.bfloat16),
            "v_cache": jnp.asarray(rng.standard_normal(mem["v_cache"].shape), jnp.bfloat16),
            "cache_mask": jnp.asarray(rng.random(mem["cache_mask"].shape) < 0.5, jnp.float32),
            "cursor": jnp.full((N,), 2, jnp.int32),
        }
        jbatch[key] = {"0": jax.tree.map(lambda m: m[None], mem)}
        batch[key] = {"0": {k: torch.from_numpy(np.asarray(v, np.float32)).to(
            torch.bfloat16 if k.endswith("cache") else (torch.int64 if k == "cursor" else torch.float32))[None]
            for k, v in mem.items()}}
    return jbatch, batch


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, N, ACT)).astype(np.float32), rng.standard_normal((T, N, 1)).astype(np.float32)


def _jax_eval(jax_agent, jbatch, cot):
    """The JAX hook's outputs and the gradients of ``sum(mean * gm) +
    sum(value * gv)`` over the actor's and the critic's parameters."""
    state = jax_agent.state
    _, hook = find_hook(state.hooks, "joint_sequential_evaluation")

    def loss(actor, critic):
        st = state.replace(actor=actor, critic=critic)
        _, out, _, _ = hook.objective(st, {"temporal": True}, dict(jbatch))
        total = jnp.sum(out["curr_action_dist"]["mean"] * cot[0]) + jnp.sum(out["curr_value"] * cot[1])
        return total, (out["curr_action_dist"]["mean"], out["curr_value"])

    (_, outs), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(state.actor, state.critic)
    return outs, {f"{net}.{p}": np.asarray(v, np.float32) for net, g in zip(("actor", "critic"), grads)
                  for p, v in tree_paths(g)}


def _port_eval(agent, batch, cot):
    hook = agent.get_hook("joint_sequential_evaluation")
    agent.model.zero_grad()
    _, metrics = hook.objective(agent, {"temporal": True}, batch)
    assert metrics == {} and batch["actor_intermediate"]["backbone.output"].shape == (T, N, 16)
    mean, value = batch["curr_action_dist"]["mean"], batch["curr_value"]
    ((mean * torch.from_numpy(cot[0])).sum() + (value * torch.from_numpy(cot[1])).sum()).backward()
    return (mean, value), {n: p.grad for n, p in agent.model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("route", ["pair", "modular"])
def test_joint_evaluation_matches_jax(monkeypatch, request, route):
    """The pair route under ``force`` (K5 in the port, the Pallas pair kernels
    in JAX) and the not-eligible route (fp32 weights: the port's two
    backbones in turn, JAX's vmapped stack): outputs and every parameter's
    gradient."""
    jax_agent, agent = request.getfixturevalue("agents") if route == "pair" else _make_agents(monkeypatch, None)
    monkeypatch.setenv("CUSRL_TPU_FUSED_TRANSFORMER", "force")
    calls = []
    real = tca.fused_pair_sequence
    import cusrl_tpu_torch.hook.on_policy.joint_seq_eval as jse

    monkeypatch.setattr(jse, "fused_pair_sequence", lambda *a: calls.append(1) or real(*a))
    jbatch, batch = _batches(jax_agent, agent, 1)
    cot = _cotangents(2)
    (jmean, jvalue), jgrads = _jax_eval(jax_agent, jbatch, cot)
    (mean, value), grads = _port_eval(agent, batch, cot)
    assert bool(calls) == (route == "pair")
    out_tol, grad_tol = (PAIR_OUT, PAIR_GRAD) if route == "pair" else (MODULAR_OUT, MODULAR_GRAD)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), **out_tol)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), **out_tol)
    assert set(grads) == set(jgrads) - {"actor.distribution.std_param"}
    scale = {net: max(np.abs(g).max() for p, g in jgrads.items() if p.startswith(net)) for net in ("actor", "critic")}
    for path, grad in grads.items():
        err = np.abs(grad.numpy() - jgrads[path]).max()
        assert err <= grad_tol * scale[path.split(".")[0]], (path, err)


def test_jax_agent_with_joint_evaluation_loads(agents):
    """``load_jax_state`` takes a JAX agent built with
    ``fuse_actor_critic_evaluation=True`` (no new parameter; the hook lists
    match by ``hook_name``, the fixture's assertion)."""
    jax_agent, agent = agents
    assert isinstance(agent.get_hook("joint_sequential_evaluation"), JointSequentialEvaluation)
    state = jax_agent.state_dict()["agent_state"]
    for path, param in agent.model.named_parameters():
        np.testing.assert_array_equal(param.detach().numpy(), np.asarray(state[path], np.float32))


def test_non_temporal_batch_passes_through(agents):
    _, agent = agents
    batch = {"observation": torch.zeros(N, OBS)}
    assert agent.get_hook("joint_sequential_evaluation").objective(agent, {"temporal": False}, batch) == (None, {})
    assert set(batch) == {"observation"}


class _Recurrent(nn.Module):
    """A stand-in recurrent backbone that is neither causal attention nor a
    recurrent cell; it records whether each call ran in sequence mode."""

    is_recurrent = True

    def __init__(self, width=4):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(width))
        self._calls = []

    def forward(self, x, memory=None, *, sequential=False, done=None):
        self._calls.append(sequential)
        return x[..., : self.weight.shape[0]] + self.weight, memory, {}


def test_rejections_match_jax(agents):
    """Unstackable backbones and action-aware critics raise ValueError, as the
    JAX hook's ``init``; a recurrent backbone outside the transformer pair
    and the recurrent cells' stack runs each network on its own in sequence
    mode (the JAX vmapped stack computes the same numbers)."""
    _, agent = agents
    layer = agent.actor.backbone.members[0]

    def fake(actor_backbone, critic_backbone, action_aware=False):
        actor = type("Actor", (), {"backbone": actor_backbone, "distribution": staticmethod(lambda z: {"mean": z})})()
        critic = type("Critic", (), {"backbone": critic_backbone, "action_aware": action_aware,
                                     "head": staticmethod(lambda z: z.sum(-1, keepdim=True))})()
        return type("Agent", (), {"actor": actor, "critic": critic})()

    hook = JointSequentialEvaluation()
    with pytest.raises(ValueError, match="must be recurrent"):
        hook.init(fake(layer, agent.actor.backbone.members[1]))
    with pytest.raises(ValueError, match="static configs differ"):
        hook.init(fake(agent.actor.backbone, layer))
    other = tca.CausalTransformerEncoderLayerFactory(embed_dim=32, num_heads=2, window=3, ff_dim=128)(OBS, None)
    with pytest.raises(ValueError, match="static configs differ"):
        hook.init(fake(layer, other))
    with pytest.raises(ValueError, match="action-aware"):
        hook.init(fake(agent.actor.backbone, agent.critic.backbone, action_aware=True))
    hook.init(fake(agent.actor.backbone, agent.critic.backbone))

    stub = fake(_Recurrent(), _Recurrent())
    hook.init(stub)
    batch = {"observation": torch.ones(T, N, OBS), "actor_memory": {}, "critic_memory": {}}
    hook.objective(stub, {"temporal": True}, batch)
    assert stub.actor.backbone._calls == stub.critic.backbone._calls == [True]
    assert batch["curr_action_dist"]["mean"].shape == (T, N, 4) and batch["curr_value"].shape == (T, N, 1)

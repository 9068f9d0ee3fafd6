"""The port's modules and hooks against the JAX package's, on the same inputs
and carried weights (made with numpy from a seed).

Tolerances: fp32 paths at 1e-5 (summation order only); bf16 paths at 1e-2
relative (one bf16 rounding, 2^-8, landing on the other side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.on_policy.advantage import _standardize as jax_standardize
from cusrl_tpu.hook.on_policy.gae import generalized_advantage_estimation as jax_gae
from cusrl_tpu.hook.on_policy.gradient_clipping import GradientClipping as JaxGradientClipping
from cusrl_tpu.hook.on_policy.ppo import ppo_surrogate_loss as jax_surrogate
from cusrl_tpu.nn.layer.linear import Linear as JaxLinear
from cusrl_tpu.nn.module.distribution import NormalDist as JaxNormalDist
from cusrl_tpu.nn.module.mlp import Mlp as JaxMlp
from cusrl_tpu_torch.hook.on_policy.advantage import standardize
from cusrl_tpu_torch.hook.on_policy.gae import generalized_advantage_estimation
from cusrl_tpu_torch.hook.on_policy.gradient_clipping import GradientClipping
from cusrl_tpu_torch.hook.on_policy.ppo import EntropyLoss, ppo_surrogate_loss
from cusrl_tpu_torch.nn.layer.bijector import make_bijector
from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.nn.module.distribution import NormalDist
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.preset.ppo import ppo_hook_suite

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _linear_pair(rng, din, dout, compute_dtype):
    w = (rng.standard_normal((dout, din)) / np.sqrt(din)).astype(np.float32)
    b = (rng.standard_normal(dout) * 0.1).astype(np.float32)
    port = Linear(din, dout, compute_dtype=compute_dtype)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
        port.bias.copy_(torch.from_numpy(b))
    return JaxLinear(weight=jnp.asarray(w), bias=jnp.asarray(b), compute_dtype=compute_dtype), port


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_linear_matches_jax(compute_dtype):
    rng = np.random.default_rng(0)
    jl, tl = _linear_pair(rng, 24, 40, compute_dtype)
    x = rng.standard_normal((50, 24)).astype(np.float32)
    got, want = tl(torch.from_numpy(x)), jl(jnp.asarray(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               **(FP32 if compute_dtype is None else BF16))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_mlp_matches_jax(compute_dtype):
    rng = np.random.default_rng(1)
    dims = (48, 64, 32, 16)
    pairs = [_linear_pair(rng, dims[i], dims[i + 1], compute_dtype) for i in range(len(dims) - 1)]
    jm = JaxMlp(layers=tuple(p[0] for p in pairs), activation="elu", ends_with_activation=True,
                input_dim=dims[0], output_dim=dims[-1])
    tm = Mlp([p[1] for p in pairs], activation="elu", ends_with_activation=True)
    x = rng.standard_normal((300, dims[0])).astype(np.float32)  # >= 256 rows: the kernel rule, minus CUDA
    got, memory, aux = tm(torch.from_numpy(x))
    assert memory is None and aux == {}
    want, _, _ = jm(jnp.asarray(x))
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               **(FP32 if compute_dtype is None else BF16))
    assert not tm._can_fuse(torch.from_numpy(x))  # CPU tensors never take the kernel


def test_normal_dist_logp_entropy_kl_match_jax():
    rng = np.random.default_rng(2)
    jl, tl = _linear_pair(rng, 16, 4, None)
    std_param = (rng.standard_normal(4) * 0.3 - 0.5).astype(np.float32)
    bij = make_bijector("exp")
    td = NormalDist(tl, torch.from_numpy(std_param), bij)
    from cusrl_tpu.nn.layer.bijector import make_bijector as jax_make_bijector

    jd = JaxNormalDist(mean_head=jl, std_param=jnp.asarray(std_param), bijector=jax_make_bijector("exp"))
    feat = rng.standard_normal((64, 16)).astype(np.float32)
    action = rng.standard_normal((64, 4)).astype(np.float32)
    tp, jp = td(torch.from_numpy(feat)), jd(jnp.asarray(feat))
    for key in ("mean", "std"):
        np.testing.assert_allclose(tp[key].detach().numpy(), np.asarray(jp[key]), **FP32)
    np.testing.assert_allclose(td.compute_logp(tp, torch.from_numpy(action)).detach().numpy(),
                               np.asarray(jd.compute_logp(jp, jnp.asarray(action))), **FP32)
    np.testing.assert_allclose(td.compute_entropy(tp).detach().numpy(), np.asarray(jd.compute_entropy(jp)), **FP32)
    q = {"mean": tp["mean"] + 0.3, "std": tp["std"] * 1.2}
    jq = {"mean": jp["mean"] + 0.3, "std": jp["std"] * 1.2}
    np.testing.assert_allclose(td.compute_kl_div(tp, q).detach().numpy(), np.asarray(jd.compute_kl_div(jp, jq)),
                               **FP32)
    noise = rng.standard_normal((64, 4)).astype(np.float32)
    action_t, logp_t = td.sample(tp, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(action_t.detach().numpy(), np.asarray(jp["mean"] + jp["std"] * noise), **FP32)


def test_std_clip_gradient_matches_jax_at_the_bound():
    """std_param initialised at log(max_std) sits on the clip bound, where
    jnp.clip passes half the gradient; the port must too (a divergence found
    while porting: torch.clamp passes all of it)."""
    x = np.array([0.0, -0.5, 0.3], np.float32)
    from cusrl_tpu.nn.layer.bijector import make_bijector as jax_make_bijector

    want = jax.grad(lambda v: jnp.sum(jax_make_bijector("exp")(v)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    make_bijector("exp")(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **FP32)
    assert t.grad[0] == pytest.approx(0.5)


def test_gae_and_advantage_normalization_match_jax():
    rng = np.random.default_rng(3)
    shape = (12, 7, 1)
    reward, value, next_value = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    done = rng.random(shape) < 0.2
    want = jax_gae(jnp.asarray(reward), jnp.asarray(done), jnp.asarray(value), jnp.asarray(next_value), 0.99, 0.95)
    got = generalized_advantage_estimation(torch.from_numpy(reward), torch.from_numpy(done), torch.from_numpy(value),
                                           torch.from_numpy(next_value), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    np.testing.assert_allclose(standardize(got).numpy(), np.asarray(jax_standardize(want)), **FP32)


def test_value_computation_next_value_masking_matches_jax(monkeypatch):
    """ValueComputation.pre_update of both agents (same carried critic, fp32)
    on a rollout where some steps terminate, some truncate and some do both:
    termination overrides the truncation bootstrap."""
    from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
    from cusrl_tpu.hook.on_policy.value import ValueComputation as JaxValueComputation
    from cusrl_tpu.preset.ppo import PpoAgentFactory as JaxPpoFactory
    from cusrl_tpu.utils import misc as jax_misc
    from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
    from cusrl_tpu_torch.utils.config import CONFIG
    from cusrl_tpu_torch.utils.interop import load_jax_state

    monkeypatch.setattr(JAX_CONFIG, "seed", 0)  # JAX weights independent of earlier tests
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    kwargs = dict(actor_hidden_dims=(32,), critic_hidden_dims=(32,), activation_fn="elu")
    jax_agent = JaxPpoFactory(**kwargs)(JaxEnv(num_instances=5, observation_dim=8, action_dim=2).spec)
    agent = PpoAgentFactory(**kwargs)(VelocityLocomotionEnv(num_instances=5, observation_dim=8, action_dim=2,
                                                            device="cpu").spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])

    rng = np.random.default_rng(4)
    t, n = 6, 5
    terminated = np.zeros((t, n, 1), bool)
    truncated = np.zeros((t, n, 1), bool)
    terminated[1, 0] = terminated[3, 2] = terminated[5, 4] = True
    truncated[2, 1] = truncated[3, 2] = truncated[5, 3] = True  # [3, 2] does both
    rollout = {
        "observation": rng.standard_normal((t, n, 8)).astype(np.float32),
        "next_observation": rng.standard_normal((t, n, 8)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
    }
    hook = next(h for h in jax_agent.state.hooks if isinstance(h, JaxValueComputation))
    _, jax_out, _ = hook.pre_update(jax_agent.state, jax.tree.map(jnp.asarray, rollout))
    port_out = {k: torch.from_numpy(v) for k, v in rollout.items()}
    with torch.no_grad():  # as ActorCritic.update_body runs it
        agent.get_hook("value_computation").pre_update(agent, port_out)
    for key in ("value", "next_value"):
        np.testing.assert_allclose(port_out[key].numpy(), np.asarray(jax_out[key]), **FP32)
    assert port_out["next_value"][3, 2, 0] == 0.0 and port_out["next_value"][1, 0, 0] == 0.0


def test_ppo_surrogate_and_entropy_loss_match_jax():
    rng = np.random.default_rng(5)
    advantage = rng.standard_normal((256, 1)).astype(np.float32)
    ratio = np.exp(rng.standard_normal((256, 1)) * 0.3).astype(np.float32)
    want = jax_surrogate(jnp.asarray(advantage), jnp.asarray(ratio), 0.2)
    got = ppo_surrogate_loss(torch.from_numpy(advantage), torch.from_numpy(ratio), 0.2)
    np.testing.assert_allclose(float(got), float(want), **FP32)
    entropy = rng.standard_normal((256, 1)).astype(np.float32)
    objectives, _ = EntropyLoss(weight=0.005).objective(None, {}, {"curr_entropy": torch.from_numpy(entropy)})
    np.testing.assert_allclose(float(objectives["entropy_loss"]), -0.005 * entropy.mean(), **FP32)


def test_gradient_clipping_matches_jax():
    rng = np.random.default_rng(6)
    grads = {
        "actor": {"a": rng.standard_normal((8, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)},
        "critic": {"c": rng.standard_normal((3, 5)).astype(np.float32) * 3},
    }
    groups = {"critic": 0.5}
    jax_hook = JaxGradientClipping.create(1.0, groups)
    _, _, jax_clipped, jax_metrics = jax_hook.pre_optim(None, jax.tree.map(jnp.asarray, grads))

    model = torch.nn.Module()
    for net in ("actor", "critic"):
        sub = torch.nn.Module()
        for name, g in grads[net].items():
            p = torch.nn.Parameter(torch.zeros(g.shape))
            p.grad = torch.from_numpy(g.copy())
            sub.register_parameter(name, p)
        model.add_module(net, sub)
    agent = type("A", (), {"model": model})()
    metrics = GradientClipping(1.0, groups).pre_optim(agent)
    assert set(metrics) == set(jax_metrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jax_metrics[key]), **FP32)
    for net in grads:
        for name in grads[net]:
            np.testing.assert_allclose(getattr(getattr(model, net), name).grad.numpy(),
                                       np.asarray(jax_clipped[net][name]), **FP32)


@pytest.mark.parametrize("option", [
    dict(normalize_observation=True, sparse_value_bootstrap=True),
    dict(fused_ppo_update=True, recurrent_backbones=True),
])
def test_hook_suite_refuses_options_not_ported(option):
    """The sparse bootstrap, ported since, no longer raises: beside
    observation normalization the suite holds the JAX suite's hooks in its
    order, the value hook with ``sparse_bootstrap``.  The fused update of
    recurrent backbones is refused as the JAX package refuses it: the suite
    builds ``FusedPpoUpdate`` in the JAX suite's order, and its ``init``
    raises ``ValueError`` on the same agent configuration (the transformer
    entry with ``fused_ppo_update``) in both packages."""
    if not option.get("fused_ppo_update"):
        from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

        hooks = ppo_hook_suite(**option)
        assert [h.hook_name for h in hooks] == [h.hook_name for h in jax_suite(**option)]
        assert next(h for h in hooks if h.hook_name == "value_computation").sparse_bootstrap
        return
    from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite
    from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    names = [h.hook_name for h in ppo_hook_suite(**option)]
    assert names == [h.hook_name for h in jax_suite(**option)]
    assert "fused_ppo_update" in names
    factories = [get("Velocity-Flat", "transformer_ppo").make_agent_factory()
                 for get in (jax_get_experiment, get_experiment)]
    for factory in factories:
        for key, value in dict(fused_ppo_update=True, embed_dim=32, num_heads=2, attention_window=4,
                               mlp_hidden_dims=(32,)).items():
            setattr(factory, key, value)
    env_kwargs = dict(num_instances=8, observation_dim=10, action_dim=3)
    with pytest.raises(ValueError, match="FusedPpoUpdate requires fusable backbones"):
        factories[0](JaxEnv(**env_kwargs).spec)
    with pytest.raises(ValueError, match="FusedPpoUpdate requires fusable backbones"):
        factories[1](VelocityLocomotionEnv(**env_kwargs, device="cpu").spec, device="cpu")


@pytest.mark.parametrize("option", [
    dict(desired_kl_divergence=0.01, recurrent_backbones=True, fuse_actor_critic_evaluation=True),
    dict(recurrent_backbones=True, fuse_actor_critic_evaluation=True),
])
def test_recurrent_hook_suite_builds_the_joint_evaluation_in_jax_order(option):
    """With recurrent backbones the joint evaluation is
    ``JointSequentialEvaluation``, in the JAX suite's position."""
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

    names = [h.hook_name for h in ppo_hook_suite(**option)]
    assert names == [h.hook_name for h in jax_suite(**option)]
    assert names.index("joint_sequential_evaluation") == names.index("value_loss") - 1


def test_hook_suite_order_matches_jax():
    from cusrl_tpu.preset.ppo import ppo_hook_suite as jax_suite

    kwargs = dict(fuse_actor_critic_evaluation=True)
    assert [h.hook_name for h in ppo_hook_suite(**kwargs)] == [h.hook_name for h in jax_suite(**kwargs)]


def test_adam_with_prefix_groups_and_runtime_lr_matches_optax():
    """torch.optim.Adam per prefix group against the JAX optimizer (optax
    scale_by_adam, then -lr per group), with one group's learning rate
    changed between steps.  fp32 at 1e-6 (the same formula, elementwise)."""
    from cusrl_tpu.template.optimizer import AdamFactory as JaxAdamFactory
    from cusrl_tpu.template.optimizer import build_optimizer as jax_build_optimizer
    from cusrl_tpu_torch.template.optimizer import AdamFactory, build_optimizer

    rng = np.random.default_rng(7)
    shapes = {"actor": {"w": (6, 4), "b": (6,)}, "critic": {"w": (3, 6)}}
    params = {net: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
              for net, leaves in shapes.items()}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(3)]
    groups = {"critic": {"lr": 3e-3}}

    jax_opt = jax_build_optimizer(JaxAdamFactory(lr=1e-3, param_groups=groups), params)
    jax_params, state, lrs = jax.tree.map(jnp.asarray, params), jax_opt.init(params), jax_opt.init_learning_rates()

    named = [(f"{net}.{k}", torch.nn.Parameter(torch.from_numpy(v.copy())))
             for net, leaves in params.items() for k, v in leaves.items()]
    opt = build_optimizer(AdamFactory(lr=1e-3, param_groups=groups), named)
    assert opt.labels == {"actor.w": "default", "actor.b": "default", "critic.w": "critic"}
    for step, g in enumerate(grads):
        if step == 2:
            lrs = {**lrs, "critic": jnp.asarray(5e-4, jnp.float32)}
            opt.set_learning_rate("critic", 5e-4)
        jax_params, state = jax_opt.apply(jax.tree.map(jnp.asarray, g), state, jax_params, lrs)
        for path, p in named:
            net, k = path.split(".")
            p.grad = torch.from_numpy(g[net][k])
        opt.step()
    assert opt.learning_rates == {"critic": 5e-4, "default": 1e-3}
    for path, p in named:
        net, k = path.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[net][k]), rtol=1e-6, atol=1e-6)

"""The auxiliary hooks of the port against the JAX package, at small size:
random network distillation (its Xavier init by per-layer standard
deviation, its reward and loss through one whole update), the return, state
and next-state probes (and their export heads), state estimation with an
MLP and with a GRU estimator (its rollout memory), action smoothness under
the temporal sampler, advantage reduction, the initialization helpers, the
checkpoint of an RND agent in either package, and the data-parallel guard.

The whole updates follow ``tests/test_torch_update_zoo.py``: the zoo's
Velocity-Rough ``ppo`` configuration at widths 32-16 on both sides (joint
evaluation, observation normalization, the adaptive learning rate), the
hooks registered where the JAX tests register them, the port with the JAX
agent's weights and hook state (``load_jax_state``: RND's target and
predictor, the estimator, the probes), the same numpy rollout (actions from
the JAX actor), the rollout-time callbacks run step by step on both sides,
and the JAX sampler's plan.  Both sides run their plain layers on the CPU.
Tolerances: bf16 backbones, one rounding carried through the update's Adam
steps (metrics rtol 1e-3 / atol 1e-4, parameters 3e-3, hook state rtol
1e-3 / atol 2e-3); the fp32 islands (heads, losses on fp32 inputs) 1e-6.

The helpers here (``build``, ``rollout_arrays``, ``step_hooks``,
``update_both``, ``compare``) serve ``test_torch_symmetry.py`` and
``test_torch_distillation.py`` too.
"""

from __future__ import annotations

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.auxiliary import estimation as jax_estimation
from cusrl_tpu.hook.auxiliary import representation as jax_representation
from cusrl_tpu.hook.auxiliary import rnd as jax_rnd
from cusrl_tpu.hook.auxiliary import smoothness as jax_smoothness
from cusrl_tpu.hook.control import initialization as jax_initialization
from cusrl_tpu.hook.on_policy.advantage import AdvantageReduction as JaxAdvantageReduction
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.nn.module.rnn import RnnFactory as JaxRnnFactory
from cusrl_tpu.nn.module.sequential import SequentialFactory as JaxSequentialFactory
from cusrl_tpu.sampler.mini_batch_sampler import TemporalMiniBatchSampler as JaxTemporalSampler
from cusrl_tpu.testing import DummyEnvironment as JaxDummyEnvironment
from cusrl_tpu.template.logger import load_checkpoint_file as jax_load_checkpoint_file
from cusrl_tpu.template.logger import save_checkpoint_file as jax_save_checkpoint_file
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.export import build_actor_graph
from cusrl_tpu_torch.hook.auxiliary.estimation import StateEstimation
from cusrl_tpu_torch.hook.auxiliary.representation import NextStatePrediction, ReturnPrediction, StatePrediction
from cusrl_tpu_torch.hook.auxiliary.rnd import RandomNetworkDistillation
from cusrl_tpu_torch.hook.auxiliary.smoothness import ActionSmoothnessLoss
from cusrl_tpu_torch.hook.control.initialization import map_linear_layers, orthogonal
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageReduction
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.nn.module.rnn import RnnFactory
from cusrl_tpu_torch.nn.module.sequential import SequentialFactory
from cusrl_tpu_torch.parallel import multiprocess
from cusrl_tpu_torch.sampler.mini_batch_sampler import TemporalMiniBatchSampler
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

T, N, OBS, ACT, STATE = 8, 64, 16, 4, 10  # 512 rows: 4 minibatches of one 128-row tile
SMALL = dict(num_steps_per_update=T, actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16))
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=3e-3), dict(rtol=1e-3, atol=2e-3))
FP32 = dict(rtol=1e-6, atol=1e-6)
# A loss computed in bf16, as in JAX (RND's mean square of two bf16 outputs),
# is itself a bf16 number: one flipped rounding moves it by 2^-8 relative.
BF16_VALUED = dict(rtol=1e-2, atol=1e-4)
STEP_KEYS = ("observation", "next_observation", "state", "next_state", "action", "done", "terminated", "truncated",
             "reward")


def _t(a):
    return torch.from_numpy(np.array(a))


def build(hooks=(), state_dim=None, temporal=False, factory=None, spec_edit=None, compute_dtype="bfloat16",
          **overrides):
    """The JAX agent and the port's: ``factory`` (``(jax, port)``
    underlying factories) or the zoo's Velocity-Rough ``ppo`` at SMALL
    widths, with ``hooks`` (``(jax hook, port hook, position)``)
    registered on both and the JAX agent's state loaded into the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JAX_CONFIG, "seed", 0)
        mp.setattr(jax_misc, "_KEY_COUNTER", [0])
        mp.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
        mp.setattr(CONFIG, "compute_dtype", compute_dtype)
        if factory is None:
            jf = jax_get_experiment("Velocity-Rough", "ppo").make_agent_factory()
            tf = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
            for f in (jf, tf):
                for key, value in {**SMALL, **overrides}.items():
                    setattr(f, key, value)
            factory = (jf.to_underlying(), tf.to_underlying())
        ju, tu = factory
        if temporal:
            ju.sampler, tu.sampler = JaxTemporalSampler(num_epochs=2, num_mini_batches=2), TemporalMiniBatchSampler(
                num_epochs=2, num_mini_batches=2)
        for jax_hook, hook, position in hooks:
            ju.register_hook(jax_hook, **position)
            tu.register_hook(hook, **position)
        # The testing environments' specs (with a state where ``state_dim``).
        dims = dict(observation_dim=OBS, action_dim=ACT, num_instances=N, state_dim=state_dim)
        jax_spec, spec = JaxDummyEnvironment(**dims).spec, DummyEnvironment(**dims).spec
        if spec_edit is not None:
            spec_edit(jax_spec, spec)
        jax_agent, agent = ju(jax_spec), tu(spec, device="cpu")
    load_jax_state(agent, jax_agent.state_dict()["agent_state"])
    return jax_agent, agent


def rollout_arrays(jax_agent, seed, state_dim=None):
    """A ``[T, N]`` rollout made with numpy; actions from the JAX actor."""
    rng = np.random.default_rng(seed)
    obs = np.tanh(rng.standard_normal((T + 1, N, OBS))).astype(np.float32)
    terminated, truncated = rng.random((T, N, 1)) < 0.05, rng.random((T, N, 1)) < 0.05
    actor = jax_agent.state.actor
    dist, _, _ = actor(jnp.asarray(obs[:-1]), actor.init_memory(N), sequential=actor.is_recurrent,
                       done=jnp.asarray(terminated | truncated))
    action = np.asarray(dist["mean"] + dist["std"] * rng.standard_normal((T, N, ACT)).astype(np.float32))
    rollout = {
        "observation": obs[:-1], "next_observation": obs[1:], "action": action,
        "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, jnp.asarray(action))),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, N, 1)).astype(np.float32),
        "terminated": terminated, "truncated": truncated, "done": terminated | truncated,
    }
    if state_dim is not None:
        state = rng.standard_normal((T + 1, N, state_dim)).astype(np.float32)
        rollout.update(state=state[:-1], next_state=state[1:])
    return rollout


def step_hooks(jax_agent, agent, rollout, names, callbacks=("post_step",)):
    """Runs the named hooks' rollout-time callbacks step by step on both
    sides; returns the new transition fields, stacked, ``(jax, port)``."""
    jax_steps, steps = [], []
    jitted = {c: jax.jit(lambda hook, state, tr, c=c: getattr(hook, c)(state, tr)) for c in callbacks}
    for t in range(T):
        tr = {k: rollout[k][t] for k in STEP_KEYS if k in rollout}
        jax_tr = jax.tree.map(jnp.asarray, tr)
        port_tr = {k: _t(v) for k, v in tr.items()}
        for callback in callbacks:
            for name in names:
                new_hook, jax_tr = jitted[callback](jax_agent.get_hook(name), jax_agent.state, jax_tr)
                jax_agent.update_hook(name, new_hook)
                getattr(agent.get_hook(name), callback)(agent, port_tr)
        jax_steps.append({k: v for k, v in jax_tr.items() if k not in tr})
        steps.append({k: v for k, v in port_tr.items() if k not in tr})
    stack = lambda items, fn: {k: jax.tree.map(lambda *xs: fn(xs), *[s[k] for s in items]) for k in items[0]}
    return (jax.tree.map(lambda x: np.asarray(x, np.float32), stack(jax_steps, jnp.stack)),
            jax.tree.map(lambda x: x.float().numpy(), stack(steps, torch.stack)))


def update_both(jax_agent, agent, rollout, port_rollout=None, temporal=False):
    """One whole update on both sides, the JAX sampler's plan fed to the
    port; returns ``(jax metrics, port metrics, the JAX agent's new state by
    path)``."""
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    if temporal:
        _, _, indices = jax_agent.sampler.make_plan(key, T, N, jax_rollout)
        plan = np.asarray(indices).reshape(jax_agent.sampler.num_epochs, -1)
    else:
        _, plan, _ = jax_agent.sampler.make_epoch_plan(key, T, N, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    port_rollout = jax.tree.map(_t, rollout) if port_rollout is None else port_rollout
    metrics = agent.update_body(port_rollout, epoch_perms=np.array(plan))
    new = {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic.", "hooks."))}
    return jax_metrics, metrics, new


def jax_path(agent, path: str) -> str:
    """A port parameter path by the JAX agent's (``hooks.<index>.*``)."""
    if not path.startswith("hooks."):
        return path
    _, name, rest = path.split(".", 2)
    return f"hooks.{[h.hook_name for h in agent.hooks].index(name)}.{rest}"


def compare(jax_metrics, metrics, new, agent, tol=BF16_TOL, metric_tol=None):
    """Every metric, every parameter (the hooks' networks by their JAX
    paths) and every hook state tensor; returns the compared parameter paths."""
    metric_default, param_tol, state_tol = tol
    assert set(metrics) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), err_msg=key,
                                   **(metric_tol or {}).get(key, metric_default))
    paths = []
    for path, param in agent.model.named_parameters():
        np.testing.assert_allclose(param.detach().float().numpy(), new[jax_path(agent, path)], err_msg=path,
                                   **param_tol)
        paths.append(path)
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            np.testing.assert_allclose(tensor.float().numpy(), new[f"hooks.{index}.{name}"], err_msg=name,
                                       **state_tol)
    return paths


# -- random network distillation ----------------------------------------------


def test_rnd_init_is_xavier_normal_with_the_jax_standard_deviations():
    """Path X's RND networks (ELU 48-256-128-64): each layer's weights have
    the Xavier standard deviation sqrt(2 / (fan_in + fan_out)) on both
    sides, within 5 % (12,288 to 32,768 draws a layer), zero biases, and
    the target is frozen while the predictor trains."""
    agent = types.SimpleNamespace(state_dim=48, init_generator=torch.Generator().manual_seed(0), device="cpu")
    hook = RandomNetworkDistillation(module_factory=MlpFactory(hidden_dims=(256, 128)), output_dim=64)
    hook.init(agent)
    jax_hook = jax.jit(lambda key: jax_rnd.RandomNetworkDistillation(
        module_factory=JaxMlpFactory(hidden_dims=(256, 128)), output_dim=64).init(
        types.SimpleNamespace(state_dim=48), key))(jax.random.key(0))
    assert set(hook.trainable_modules()) == {"predictor"} and set(hook.frozen_modules()) == {"target"}
    for name in ("target", "predictor"):
        layers, jax_layers = getattr(hook, name).layers, getattr(jax_hook, name).layers
        assert [tuple(l.weight.shape) for l in layers] == [(256, 48), (128, 256), (64, 128)]
        for layer, jax_layer in zip(layers, jax_layers):
            out_dim, in_dim = layer.weight.shape
            want = np.sqrt(2.0 / (in_dim + out_dim))
            assert abs(layer.weight.std().item() / want - 1) < 0.05, name
            assert abs(float(jnp.std(jax_layer.weight)) / want - 1) < 0.05, name
            assert not layer.bias.any() and not np.asarray(jax_layer.bias).any()


def _x_hooks():
    """Path X's hooks at small widths: RND before value_computation, then
    the return probe after on_policy_preparation."""
    return [(jax_rnd.RandomNetworkDistillation(module_factory=JaxMlpFactory(hidden_dims=(16,)), output_dim=8,
                                               reward_scale=0.5), RandomNetworkDistillation(
        module_factory=MlpFactory(hidden_dims=(16,)), output_dim=8, reward_scale=0.5), {"before": "value_computation"}),
            (jax_representation.ReturnPrediction(), ReturnPrediction(), {"after": "on_policy_preparation"})]


@pytest.fixture(scope="module")
def x_agents():
    return build(_x_hooks())


def test_rnd_and_return_prediction_update_matches_jax(x_agents):
    """Path X at small widths: the RND reward in ``pre_update`` (``rnd_reward``),
    its loss and the return probe's, every metric, the predictor's, the
    return head's and the PPO networks' parameters after one update; the
    frozen target unchanged."""
    jax_agent, agent = x_agents
    target = {k: v.clone() for k, v in agent.get_hook("random_network_distillation").target.state_dict().items()}
    jax_metrics, metrics, new = update_both(jax_agent, agent, rollout_arrays(jax_agent, 11))
    assert {"rnd_reward", "rnd_loss", "return_prediction_loss"} <= set(metrics)
    paths = compare(jax_metrics, metrics, new, agent, metric_tol={"rnd_loss": BF16_VALUED, "rnd_reward": BF16_VALUED})
    assert {"hooks.random_network_distillation.predictor.layers.0.weight",
            "hooks.random_network_distillation.target.layers.1.bias",
            "hooks.return_prediction.predictor.weight"} <= set(paths)
    for key, value in agent.get_hook("random_network_distillation").target.state_dict().items():
        assert torch.equal(value, target[key])
    # The target is out of the optimizer; the predictor and the probe in it.
    labels = agent.optimizer.labels
    assert not any(".target." in p for p in labels)
    assert "hooks.random_network_distillation.predictor.layers.0.weight" in labels
    assert labels == jax_agent.optimizer.labels_flat


def test_rnd_agent_checkpoint_loads_in_either_package(x_agents, tmp_path):
    """The port's checkpoint of the RND agent loads in the JAX package
    (every path, the target's and the predictor's included, without a
    warning) and the JAX one in the port, value for value."""
    jax_agent, agent = x_agents
    with torch.no_grad():
        agent.get_hook("random_network_distillation").predictor.layers[0].bias.add_(0.25)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint_file(path, {"agent": agent.state_dict(), "iteration": 1})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_agent.load_state_dict(jax_load_checkpoint_file(path)["agent"])
    assert not [str(w.message) for w in caught if "checkpoint" in str(w.message).lower()]
    jax_state = jax_agent.state_dict()["agent_state"]
    state = agent.state_dict()["agent_state"]
    assert set(state) == set(jax_state)
    index = [h.hook_name for h in agent.hooks].index("random_network_distillation")
    assert {f"hooks.{index}.target.layers.0.weight", f"hooks.{index}.predictor.layers.1.bias"} <= set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(value, np.asarray(jax_state[key], value.dtype), err_msg=key)
    jax_path_ = str(tmp_path / "jax.npz")
    jax_save_checkpoint_file(jax_path_, {"agent": jax_agent.state_dict(), "iteration": 1})
    _, fresh = build(_x_hooks())
    with pytest.warns(RuntimeWarning, match="No 'torch_rng' entry"):  # a JAX file has no generator state
        fresh.load_state_dict(load_checkpoint_file(jax_path_)["agent"])
    for key, value in fresh.state_dict()["agent_state"].items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)


# -- the probes and state estimation on a state-bearing environment -------------


def test_state_probes_and_estimation_update_matches_jax():
    """``StatePrediction``, ``NextStatePrediction`` (the action cast to the
    latent's bf16) and an MLP ``StateEstimation`` on a spec with a 10-wide
    state: the estimator's ``pre_act`` estimates over the rollout, then one
    whole update (every metric, the estimator's and both heads'
    parameters)."""
    hooks = [
        (jax_estimation.StateEstimation(estimator_factory=JaxMlpFactory(hidden_dims=(16,)), target_indices=(0, 1)),
         StateEstimation(estimator_factory=MlpFactory(hidden_dims=(16,)), target_indices=(0, 1)),
         {"before": "value_computation"}),
        (jax_representation.StatePrediction(target_indices=(0, 1)), StatePrediction(target_indices=(0, 1)),
         {"after": "on_policy_preparation"}),
        (jax_representation.NextStatePrediction(target_indices=(0,)), NextStatePrediction(target_indices=(0,)),
         {"after": "on_policy_preparation"}),
    ]
    # The critic reads the 10-wide state: no joint evaluation (its backbones differ).
    jax_agent, agent = build(hooks, state_dim=STATE, fuse_actor_critic_evaluation=False)
    rollout = rollout_arrays(jax_agent, 12, STATE)
    jax_steps, steps = step_hooks(jax_agent, agent, rollout, ["state_estimation"], ("pre_act",))
    np.testing.assert_allclose(steps["state_estimation"], jax_steps["state_estimation"], rtol=1e-2, atol=1e-2)
    jax_metrics, metrics, new = update_both(jax_agent, agent, rollout)
    assert {"state_estimation_loss", "state_prediction_loss", "next_state_prediction_loss"} <= set(metrics)
    paths = compare(jax_metrics, metrics, new, agent)
    assert {"hooks.state_estimation.estimator.layers.1.weight", "hooks.state_prediction.predictor.bias",
            "hooks.next_state_prediction.predictor.weight"} <= set(paths)
    assert agent.get_hook("next_state_prediction").predictor.weight.shape == (1, 16 + ACT)


def test_gru_estimator_and_action_smoothness_update_match_jax():
    """Under the temporal sampler: a ``StateEstimation`` with a GRU 8 -> MLP
    estimator (its memory steps in ``pre_act`` and resets in ``post_step``,
    the rollout replays it from ``estimator_memory``) and
    ``ActionSmoothnessLoss`` with a per-channel first-order weight; the
    estimates, the memory after the rollout, then one whole update."""
    jax_estimator = JaxSequentialFactory(factories=(JaxRnnFactory(cell="gru", hidden_size=8),
                                                    JaxMlpFactory(hidden_dims=(8,))))
    estimator = SequentialFactory(factories=(RnnFactory(cell="gru", hidden_size=8), MlpFactory(hidden_dims=(8,))))
    weights = (0.1, 0.2, 0.3, 0.4)
    hooks = [
        (jax_estimation.StateEstimation(estimator_factory=jax_estimator, target_indices=(0, 1)),
         StateEstimation(estimator_factory=estimator, target_indices=(0, 1)), {"before": "value_computation"}),
        (jax_smoothness.ActionSmoothnessLoss(weight_1st_order=weights, weight_2nd_order=0.1),
         ActionSmoothnessLoss(weight_1st_order=weights, weight_2nd_order=0.1), {"after": "on_policy_preparation"}),
    ]
    jax_agent, agent = build(hooks, state_dim=STATE, temporal=True, fuse_actor_critic_evaluation=False)
    rollout = rollout_arrays(jax_agent, 13, STATE)
    jax_hook, hook = jax_agent.get_hook("state_estimation"), agent.get_hook("state_estimation")
    initial = jax.tree.map(lambda m: np.asarray(m)[None], jax_hook.memory)
    port_initial = jax.tree.map(lambda m: m[None].clone(), hook.memory)
    jax_steps, steps = step_hooks(jax_agent, agent, rollout, ["state_estimation"], ("pre_act", "post_step"))
    np.testing.assert_allclose(steps["state_estimation"], jax_steps["state_estimation"], rtol=1e-2, atol=1e-2)
    for name, tensor in hook.state_tensors().items():
        np.testing.assert_allclose(tensor.numpy(), np.asarray(dict(tree_paths(jax_agent.get_hook(
            "state_estimation")))[name]), rtol=1e-5, atol=1e-5, err_msg=name)
    port_rollout = {**jax.tree.map(_t, rollout), "estimator_memory": port_initial}
    jax_metrics, metrics, new = update_both(jax_agent, agent, {**rollout, "estimator_memory": initial},
                                            port_rollout, temporal=True)
    assert {"state_estimation_loss", "action_smoothness_1st_order_loss",
            "action_smoothness_2nd_order_loss"} <= set(metrics)
    assert agent.get_hook("action_smoothness_loss").weight_1st_order == weights
    compare(jax_metrics, metrics, new, agent)


def test_action_smoothness_objective_matches_jax():
    """Both orders on a ``[6, 5, 3]`` mean with episode boundaries, scalar
    and per-channel weights (fp32); a non-temporal batch and fewer than 3
    steps raise as in JAX."""
    rng = np.random.default_rng(3)
    mean = rng.standard_normal((6, 5, 3)).astype(np.float32)
    done = rng.random((6, 5, 1)) < 0.3
    for w1, w2 in ((0.5, None), (None, (0.1, 0.2, 0.3)), ((1.0, 2.0, 3.0), 0.25)):
        jax_hook = jax_smoothness.ActionSmoothnessLoss(weight_1st_order=w1, weight_2nd_order=w2)
        _, _, want, _ = jax_hook.objective(None, {"temporal": True}, {"curr_action_dist": {"mean": jnp.asarray(mean)},
                                                                       "done": jnp.asarray(done)})
        got, _ = ActionSmoothnessLoss(weight_1st_order=w1, weight_2nd_order=w2).objective(
            None, {"temporal": True}, {"curr_action_dist": {"mean": _t(mean)}, "done": _t(done)})
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), err_msg=key, **FP32)
    with pytest.raises(ValueError, match="requires temporal batches"):
        ActionSmoothnessLoss(weight_1st_order=1.0).objective(None, {"temporal": False}, {})
    with pytest.raises(ValueError, match=">= 3 steps"):
        ActionSmoothnessLoss(weight_1st_order=1.0).objective(
            None, {"temporal": True}, {"curr_action_dist": {"mean": torch.zeros(2, 1, 1)}, "done": torch.zeros(2, 1, 1)})


def test_probe_heads_join_the_export_graph(x_agents):
    """``post_export``: the return head is an exposed output of the port's
    actor graph, fed by the actor's latent, equal to the JAX head on that
    latent (fp32 head)."""
    jax_agent, agent = x_agents
    graph = build_actor_graph(agent)
    assert "return_prediction" in graph.exposed_outputs
    obs = torch.tanh(torch.randn(5, OBS, generator=torch.Generator().manual_seed(0)))
    with torch.no_grad():
        out = graph.build()({"observation": obs})
        latent = out["actor.backbone.output"]
        want = jax_agent.get_hook("return_prediction").predictor(jnp.asarray(latent.float().numpy()))
    np.testing.assert_allclose(out["return_prediction"].numpy(), np.asarray(want), **FP32)


# -- advantage reduction and the initialization helpers ------------------------


@pytest.mark.parametrize("reduction,weight", [("sum", None), ("mean", None), ("sum", (0.5, 2.0, -1.0))])
def test_advantage_reduction_matches_jax(reduction, weight):
    advantage = np.random.default_rng(4).standard_normal((7, 3)).astype(np.float32)
    _, jax_batch, _, _ = JaxAdvantageReduction(reduction=reduction, weight=weight).objective(
        None, {}, {"advantage": jnp.asarray(advantage)})
    batch = {"advantage": _t(advantage)}
    AdvantageReduction(reduction=reduction, weight=weight).objective(None, {}, batch)
    np.testing.assert_allclose(batch["advantage"].numpy(), np.asarray(jax_batch["advantage"]), **FP32)
    with pytest.raises(ValueError, match="Unsupported reduction"):
        AdvantageReduction(reduction="max")


def test_initialization_helpers_match_jax():
    """``orthogonal``: orthonormal rows (or columns) times the gain, as
    JAX's; ``map_linear_layers`` visits the actor's Linear layers by the JAX
    paths."""
    for shape in ((6, 4), (4, 6)):
        w = orthogonal(torch.Generator().manual_seed(0), shape, gain=2.0).numpy()
        jw = np.asarray(jax_initialization.orthogonal(jax.random.key(0), shape, 2.0))
        small = min(shape)
        for m in (w, jw):
            gram = m.T @ m if shape[0] >= shape[1] else m @ m.T
            np.testing.assert_allclose(gram, 4.0 * np.eye(small), atol=1e-5)
    jax_agent, agent = build()
    jax_paths = []
    jax_initialization.map_linear_layers(jax_agent.state.actor, lambda p, l: jax_paths.append(p) or l)
    assert map_linear_layers(agent.actor, lambda p, l: None) == jax_paths


# -- data parallelism ----------------------------------------------------------


def test_new_hooks_raise_under_more_than_one_rank(x_agents, monkeypatch):
    """Under a group of two every new hook that owns a network or is marked
    single-process raises, naming Queue 1 item 2a."""
    from cusrl_tpu_torch.hook import (
        ActionSmoothnessLoss as Smooth, MirrorSymmetryLoss, PolicyDistillationLoss, SymmetricDataAugmentation)

    _, agent = x_agents
    monkeypatch.setattr(multiprocess.dist, "get_world_size", lambda group=None: 2)
    agent.process_group = object()
    try:
        with pytest.raises(NotImplementedError, match=r"hook-owned networks \(random_network_distillation, "
                                                      r"return_prediction\).*item 2a"):
            multiprocess.check_data_parallel_route(agent)
        for hook in (Smooth(weight_1st_order=1.0), MirrorSymmetryLoss(), PolicyDistillationLoss(),
                     SymmetricDataAugmentation(), AdvantageReduction()):
            single = types.SimpleNamespace(process_group=object(), actor=agent.actor, sampler=agent.sampler,
                                           hooks=[hook])
            with pytest.raises(NotImplementedError, match=f"{hook.hook_name}.*item 2a"):
                multiprocess.check_data_parallel_route(single)
    finally:
        agent.process_group = None

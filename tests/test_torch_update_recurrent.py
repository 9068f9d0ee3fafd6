"""The zoo's ``Velocity-Flat``/``recurrent_ppo`` entry in the port, against
the JAX package, on the CPU, at small widths (GRU 32, ELU head 16, T = 8,
N = 64: four minibatches of 16 environments).

Both sides run on a replay environment: the same observations, rewards and
terminations (numpy, from a seed, with resets in mid-rollout) whatever the
actions.  The JAX agent collects two rollouts through its scan driver (the
first warms the memories and the observation statistics); the port takes
its weights, hook state and actor memory as of the second rollout's start
through ``load_jax_state`` and collects the same rollout through its
``RolloutDriver``, each step's action noise recovered from the JAX
rollout's actions.  The per-step critic's values, bootstrap values and
next values, and the memory entries (per-step stacks under
``TemporalRandomSampler``, rollout-initial ``[1, N, ...]`` entries
otherwise), are held to the JAX rollout's.  Then both sides update on the
JAX rollout with the same sampler plan (the JAX sampler's), and every
metric, parameter and hook state is held to the JAX update's.

In bf16 the port is forced onto its kernel path (``Mlp._can_fuse`` without
"on CUDA"), so the head's K1 (and, under the joint evaluation, K2) plain
versions run; the JAX package runs its CPU route.  Tolerances as
tests/test_torch_update_zoo.py: fp32 to summation order (metrics rtol
1e-5, parameters 2e-6), bf16 to one rounding carried through 20 Adam steps
(metrics rtol 1e-3 / atol 1e-4, parameters 3e-3; the rollout's values
within one bf16 rounding of the head's output, 2e-3).  The KL and the
importance-weighted advantage are small differences of nearly equal terms:
in bf16 they are held as the transformer test holds them (rtol 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxLocomotionEnv
from cusrl_tpu.hook.on_policy.advantage import AdvantageNormalization as JaxAdvantageNormalization
from cusrl_tpu.hook.on_policy.gae import GeneralizedAdvantageEstimation as JaxGae
from cusrl_tpu.hook.on_policy.stats import OnPolicyStatistics as JaxStatistics
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.sampler.random_sampler import RandomSampler as JaxRandomSampler
from cusrl_tpu.sampler.random_sampler import TemporalRandomSampler as JaxTemporalRandomSampler
from cusrl_tpu.template.environment import EnvironmentSpec as JaxSpec
from cusrl_tpu.template.environment import JaxEnvironment
from cusrl_tpu.template.rollout import ScanRolloutDriver
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization
from cusrl_tpu_torch.hook.on_policy.gae import GeneralizedAdvantageEstimation
from cusrl_tpu_torch.hook.on_policy.stats import OnPolicyStatistics
from cusrl_tpu_torch.nn.kernels.fused_mlp import LAUNCHES, reset_launch_counts
from cusrl_tpu_torch.nn.module.mlp import Mlp
from cusrl_tpu_torch.nn.module.rnn import Gru, Lstm
from cusrl_tpu_torch.sampler import AutoRandomSampler, RandomSampler, TemporalRandomSampler
from cusrl_tpu_torch.template.environment import EnvironmentSpec, TensorEnvironment
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.zoo.registry import get_experiment

T, N, OBS, ACT = 8, 64, 10, 3
SMALL = dict(num_steps_per_update=T, rnn_hidden_size=32, mlp_hidden_dims=(16,))
# (metrics, parameters, hook state, the rollout's values and memories)
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=2e-6), dict(rtol=1e-4, atol=1e-4),
            dict(rtol=1e-5, atol=1e-5))
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=3e-3), dict(rtol=1e-3, atol=2e-3),
            dict(rtol=2e-3, atol=2e-3))
BF16_DIFFERENCE_METRICS = ("kl_divergence", "importance_weighted_advantage", "ratio", "surrogate_loss")
K, B, L = 4, 16, 6  # random samplers: 4 batches of 16 windows of 6 steps (16 x 8 = 128 rows for RandomSampler)


def _tables(seed=0, steps=2 * T):
    rng = np.random.default_rng(seed)
    terminated = rng.random((steps, N, 1)) < 0.05
    truncated = rng.random((steps, N, 1)) < 0.05
    terminated[T + 3, :5] = True  # resets in mid-rollout whatever the draw
    truncated[T + 5, 5:10] = True
    return {
        "obs": np.tanh(rng.standard_normal((steps + 1, N, OBS))).astype(np.float32),
        "reward": rng.standard_normal((steps, N, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated & ~terminated,
    }


class JaxReplay(JaxEnvironment):
    """Replays the tables whatever the actions (the JAX side)."""

    def __init__(self, spec, tables):
        super().__init__(spec)
        self.tables = {k: jnp.asarray(v) for k, v in tables.items()}

    def init_fn(self, key):
        return {"t": jnp.zeros((), jnp.int32)}

    def observe_fn(self, env_state):
        return self.tables["obs"][env_state["t"]], None

    def step_fn(self, env_state, action, key):
        t = env_state["t"]
        return ({"t": t + 1}, self.tables["reward"][t], self.tables["terminated"][t], self.tables["truncated"][t],
                {})


class Replay(TensorEnvironment):
    """The port's replay of the same tables, from step ``start``."""

    def __init__(self, spec, tables, start):
        super().__init__(spec)
        self.tables = {k: torch.from_numpy(np.array(v)) for k, v in tables.items()}
        self.start = start

    def init_fn(self, generator):
        return {"t": self.start}

    def observe_fn(self, env_state):
        return self.tables["obs"][env_state["t"]], None

    def step_fn(self, env_state, action, generator):
        t = env_state["t"]
        return ({"t": t + 1}, self.tables["reward"][t], self.tables["terminated"][t], self.tables["truncated"][t],
                {})


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _configure(factory, sampler, hooks):
    """The underlying factory with the sampler and hook list swapped in."""
    factory = factory.to_underlying()
    if sampler is not None:
        factory.sampler = sampler
    if hooks is not None:
        factory.hooks = hooks(factory.hooks)
    return factory


def _recompute_hooks(jax_side):
    """GAE with ``recompute=True``; advantage normalization and the
    statistics hook read the rollout's advantages, which recompute leaves to
    the minibatches, so both go (the JAX hooks would raise)."""
    gae, norm, stats = ((JaxGae, JaxAdvantageNormalization, JaxStatistics) if jax_side
                        else (GeneralizedAdvantageEstimation, AdvantageNormalization, OnPolicyStatistics))

    def edit(hooks):
        return [gae(gamma=h.gamma, lamda=h.lamda, recompute=True) if isinstance(h, gae) else h
                for h in hooks if not isinstance(h, (norm, stats))]

    return edit


CASES = {
    # name: (zoo entry, compute dtype, agent overrides, sampler, hook edit)
    "fp32": ("recurrent_ppo", None, {}, None, False),
    "bf16": ("recurrent_ppo", "bfloat16", {}, None, False),
    "joint": ("recurrent_ppo", "bfloat16", {"fuse_actor_critic_evaluation": True}, None, False),
    "lstm": ("recurrent_ppo", None, {"rnn_type": "lstm", "rnn_num_layers": 2}, None, False),
    "gae_recompute": ("recurrent_ppo", None, {}, None, True),
    "temporal_random": ("recurrent_ppo", None, {}, "temporal", False),
    "temporal_random_joint": ("recurrent_ppo", "bfloat16", {"fuse_actor_critic_evaluation": True}, "temporal",
                              False),
    "random": ("ppo", None, {"actor_hidden_dims": (32, 16), "critic_hidden_dims": (32, 16)}, "random", False),
}


def _agents(case, monkeypatch):
    entry, compute_dtype, overrides, sampler, recompute = CASES[case]
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", compute_dtype)
    monkeypatch.setattr(CONFIG, "compute_dtype", compute_dtype)
    if compute_dtype is not None:  # the kernels' path on the CPU: the JAX rule without "on CUDA"
        monkeypatch.setattr(Mlp, "_can_fuse", lambda self, x: x.dim() >= 2 and all(
            l.compute_dtype == "bfloat16" and l.bias is not None for l in self.layers))
    jf, tf = (jax_get_experiment("Velocity-Flat", entry).make_agent_factory(),
              get_experiment("Velocity-Flat", entry).make_agent_factory())
    small = SMALL if entry == "recurrent_ppo" else {"num_steps_per_update": T}
    for f in (jf, tf):
        for k, v in {**small, **overrides}.items():
            setattr(f, k, v)
    samplers = {"temporal": (JaxTemporalRandomSampler(K, B, L), TemporalRandomSampler(K, B, L)),
                "random": (JaxRandomSampler(K, B * T), RandomSampler(K, B * T))}.get(sampler, (None, None))
    jf = _configure(jf, samplers[0], _recompute_hooks(True) if recompute else None)
    tf = _configure(tf, samplers[1], _recompute_hooks(False) if recompute else None)
    spec = dict(observation_dim=OBS, action_dim=ACT, num_instances=N)
    tables = _tables()
    jax_env = JaxReplay(JaxSpec(**spec), tables)
    jax_agent = jf(jax_env.spec)
    agent = tf(EnvironmentSpec(**spec), device="cpu")
    # Non-trivial statistics and schedule state before the first rollout.
    rng = np.random.default_rng(3)
    for h in jax_agent.state.hooks:
        if h.hook_name == "observation_normalization":
            rms = h.observation_rms.replace(mean=jnp.asarray(rng.standard_normal(OBS) * 0.1, jnp.float32),
                                            var=jnp.asarray(rng.random(OBS) + 0.5, jnp.float32),
                                            count=jnp.asarray(300.0, jnp.float32))
            jax_agent.update_hook(h.hook_name, h.replace(observation_rms=rms))
        elif h.hook_name == "adaptive_l_r_schedule":
            jax_agent.update_hook(h.hook_name, h.replace(lr_scale=jnp.asarray(0.7, jnp.float32)))
    return jax_agent, agent, jax_env, tables


def _collect_both(jax_agent, agent, jax_env, tables):
    """The JAX driver's second rollout and the port driver's of the same
    steps; returns both rollouts (the JAX one as numpy)."""
    driver = ScanRolloutDriver(jax_agent, jax_env, packed=False)
    driver.collect(T)  # warms the memories and the statistics
    state = jax_agent.state_dict()
    load_jax_state(agent, state["agent_state"], actor_memory=state["actor_memory"])
    rollout, _ = driver.collect(T)
    rollout = jax.tree.map(np.asarray, rollout)

    noise = (rollout["action"] - rollout["action_dist"]["mean"]) / rollout["action_dist"]["std"]
    steps = iter(torch.from_numpy(noise))
    act_body = agent.act_body
    agent.act_body = lambda observation, noise=None, state=None: act_body(observation, next(steps), state)
    port_driver = RolloutDriver(agent, Replay(agent.environment_spec, tables, start=T))
    port_rollout, _ = port_driver.collect(T)
    del agent.act_body
    return rollout, port_rollout


def _assert_close(got, want, tol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _assert_close(got[key], want[key], tol, f"{what}.{key}")
        return
    np.testing.assert_allclose(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), err_msg=what, **tol)


def _compare_rollouts(case, jax_agent, agent, rollout, port_rollout):
    """Values, bootstrap values, memories and (after the value hook's
    pre_update) next values of the two drivers' rollouts."""
    tol = (FP32_TOL if CASES[case][1] is None else BF16_TOL)[3]
    memory_keys = sorted(k for k in rollout if k.endswith("memory"))
    assert memory_keys == sorted(k for k in port_rollout if k.endswith("memory"))
    recurrent = CASES[case][0] == "recurrent_ppo"
    if recurrent:
        assert memory_keys == ["actor_memory", "critic_memory"]
        assert agent.get_hook("value_computation").deferred is False
        assert {"value", "bootstrap_value"} <= set(port_rollout)
        per_step = CASES[case][3] == "temporal"
        for key in memory_keys:  # [T, N, ...] stacks under a per-step sampler, else [1, N, ...]
            leaves = jax.tree.leaves(rollout[key])
            assert all(leaf.shape[0] == (T if per_step else 1) for leaf in leaves), key
    for key in ("observation", "action", "action_logp", "done", *memory_keys,
                *(("value", "bootstrap_value") if recurrent else ())):
        _assert_close(port_rollout[key], rollout[key], tol, key)
    jax_hook = jax_agent.get_hook("value_computation")
    _, jax_out, _ = jax_hook.pre_update(jax_agent.state, jax.tree.map(jnp.asarray, rollout))
    port = dict(port_rollout)
    agent.get_hook("value_computation").pre_update(agent, port)
    for key in ("value", "next_value"):
        _assert_close(port[key], jax_out[key], tol, key)


def _plan(jax_agent, key, rollout):
    """The JAX sampler's plan in the form the port's sampler takes."""
    sampler, epochs = jax_agent.sampler, getattr(jax_agent.sampler, "num_epochs", 1)
    _, _, indices = sampler.make_plan(key, T, N, rollout)
    if isinstance(sampler, (JaxRandomSampler, JaxTemporalRandomSampler)):
        return jax.tree.map(np.asarray, indices)
    return np.asarray(indices).reshape(epochs, -1)  # the temporal plan's environment order (16 < 128: no tiles)


def _update_both(case, jax_agent, agent, rollout):
    key = jax.random.key(5)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    plan = _plan(jax_agent, key, jax_rollout)
    new_state, jax_metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key)
    reset_launch_counts()
    metrics = agent.update_body(_to_torch(rollout), epoch_perms=plan)
    assert not any(LAUNCHES.values())  # the CPU ran the plain versions

    metric_tol, param_tol, state_tol, _ = FP32_TOL if CASES[case][1] is None else BF16_TOL
    assert set(metrics) == set(jax_metrics)
    for name, value in jax_metrics.items():
        tol = dict(rtol=2e-2, atol=1e-4) if CASES[case][1] and name in BF16_DIFFERENCE_METRICS else metric_tol
        np.testing.assert_allclose(float(metrics[name]), float(value), err_msg=name, **tol)
    new = {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state)
           if p.startswith(("actor.", "critic.", "hooks."))}
    params = dict(agent.model.named_parameters())
    assert set(params) == {p for p in new if not p.startswith("hooks.")}
    for path, param in params.items():
        np.testing.assert_allclose(param.detach().numpy(), new[path], err_msg=path, **param_tol)
    checked = set()
    for index, hook in enumerate(agent.hooks):
        for name, tensor in hook.state_tensors().items():
            tol = dict(rtol=0, atol=2e-2) if CASES[case][1] and name == "accumulated_log_error" else state_tol
            np.testing.assert_allclose(tensor.float().numpy(), new[f"hooks.{index}.{name}"], err_msg=name, **tol)
            checked.add(f"{hook.hook_name}.{name}")
    return checked


@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_rollout_and_update_match_jax(case, monkeypatch):
    jax_agent, agent, jax_env, tables = _agents(case, monkeypatch)
    rollout, port_rollout = _collect_both(jax_agent, agent, jax_env, tables)
    _compare_rollouts(case, jax_agent, agent, rollout, port_rollout)
    checked = _update_both(case, jax_agent, agent, rollout)
    if CASES[case][0] == "recurrent_ppo":
        cell = agent.actor.backbone.members[0]
        assert isinstance(cell, Lstm if case == "lstm" else Gru)
        # The per-step critic's memory after the rollout (the update leaves it).
        suffixes = ("0.hidden", "0.cell") if case == "lstm" else ("0",)
        assert {f"value_computation.memory.{s}" for s in suffixes} <= checked


def test_zoo_recurrent_entry_matches_jax(monkeypatch):
    """The entry's kwargs are the JAX entry's; its agent has the JAX agent's
    hooks and parameter paths; without a card it runs only on request."""
    spec, ref = get_experiment("Velocity-Flat", "recurrent_ppo"), jax_get_experiment("Velocity-Flat",
                                                                                    "recurrent_ppo")
    assert spec.agent_meta_factory_kwargs == ref.agent_meta_factory_kwargs
    assert spec.training_env_factory_kwargs == ref.training_env_factory_kwargs == {"num_instances": 1024}
    assert spec.benchmarking_env_factory_kwargs == ref.benchmarking_env_factory_kwargs
    for name in ("num_iterations", "checkpoint_interval", "iterations_per_dispatch", "experiment_name"):
        assert getattr(spec, name) == getattr(ref, name), name
    factory = spec.to_training_factory()
    factory.environment_kwargs = {"num_instances": 8}
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory(verbose=False)
    trainer = factory(device="cpu", verbose=False)
    agent = trainer.agent
    gru, head = agent.actor.backbone.members
    assert isinstance(gru, Gru) and gru.hidden_size == 256 and gru.num_layers == 1 and gru.compute_dtype is None
    assert [l.output_dim for l in head.layers] == [128] and head.activation == "elu" and head.ends_with_activation
    assert agent.get_hook("value_computation").deferred is False
    jax_factory = ref.make_agent_factory()
    jax_agent = jax_factory(JaxLocomotionEnv(num_instances=8).spec)
    assert [h.hook_name for h in agent.hooks] == [h.hook_name for h in jax_agent.state.hooks]
    jax_paths = ({f"actor.{p}" for p, _ in tree_paths(jax_agent.state.actor)}
                 | {f"critic.{p}" for p, _ in tree_paths(jax_agent.state.critic)})
    assert set(dict(agent.model.named_parameters())) == jax_paths


def test_hooks_raise_where_the_jax_hooks_raise():
    """A per-step sampler under ``deferred="sequential"``, GAE recompute on a
    non-temporal batch, and single-transition sampling of a recurrent
    rollout."""
    from cusrl_tpu_torch.hook.on_policy.value import ValueComputation
    from cusrl_tpu_torch.preset.ppo import RecurrentPpoAgentFactory, TransformerPpoAgentFactory

    env = VelocityLocomotionEnv(num_instances=4, observation_dim=OBS, action_dim=ACT, device="cpu")
    factory = TransformerPpoAgentFactory(embed_dim=16, num_heads=2, attention_window=4, mlp_hidden_dims=(16,),
                                         num_steps_per_update=4).to_underlying()
    factory.sampler = TemporalRandomSampler(2, 2, 3)
    factory.hooks = [ValueComputation(deferred="sequential") if isinstance(h, ValueComputation) else h
                     for h in factory.hooks]
    with pytest.raises(ValueError, match="records no per-step critic_memory"):
        factory(env.spec, device="cpu")
    factory.hooks = [ValueComputation() if isinstance(h, ValueComputation) else h for h in factory.hooks]
    assert factory(env.spec, device="cpu").get_hook("value_computation").deferred is False  # auto: per-step
    with pytest.raises(RuntimeError, match="requires temporal batches"):
        GeneralizedAdvantageEstimation(recompute=True).objective(None, {"temporal": False}, {})
    with pytest.raises(ValueError, match="needs TemporalRandomSampler"):
        RandomSampler(1, 4).source({"observation": torch.zeros(2, 4, 1), "actor_memory": torch.zeros(1, 4, 3)})
    # A partly filled ring (cursor 3 of 4): the windows of 2 steps lie in the first 3.
    plan = TemporalRandomSampler(8, 2, 2).make_epoch_plan(4, 4, torch.Generator().manual_seed(0),
                                                          buffer_state={"cursor": 3, "full": False})
    assert int(plan.indices[0].max()) <= 2
    agent = RecurrentPpoAgentFactory(rnn_hidden_size=8, mlp_hidden_dims=(), num_steps_per_update=4)(
        env.spec, device="cpu")
    assert isinstance(agent.actor.backbone, Gru)  # the bare cell without mlp_hidden_dims


def test_random_samplers_draw_and_gather_like_jax():
    """Plans drawn from the agent's generator cover the rollout as the JAX
    plans do; a given plan gathers the JAX gather's rows; the auto sampler
    resolves on the rollout's memory."""
    rollout = {"observation": torch.arange(T * N, dtype=torch.float32).reshape(T, N, 1)}
    gen = torch.Generator().manual_seed(0)
    plan = RandomSampler(3, 8).make_epoch_plan(T, N, gen)
    assert plan.num_mini_batches == 3 and plan.indices.shape == (3, 8) and int(plan.indices.max()) < T * N
    sampler = TemporalRandomSampler(2, 5, 4)
    plan = sampler.make_epoch_plan(T, N, gen)
    time_indices, env_indices = plan.indices
    assert time_indices.shape == (2, 4, 5) and env_indices.shape == (2, 5)
    assert (time_indices.diff(dim=1) == 1).all() and int(time_indices.max()) < T
    jax_sampler = JaxTemporalRandomSampler(2, 5, 4)
    jax_rollout = {"observation": jnp.arange(T * N, dtype=jnp.float32).reshape(T, N, 1)}
    _, meta, (jt, je) = jax_sampler.make_plan(jax.random.key(1), T, N, jax_rollout)
    plan = sampler.make_epoch_plan(T, N, None, "cpu", (np.asarray(jt), np.asarray(je)))
    for i in range(2):
        got = sampler.gather(sampler.source(rollout), plan, 0, i)
        want = jax_sampler.gather(jax_rollout, (jt[i], je[i]))
        np.testing.assert_array_equal(got["observation"].numpy(), np.asarray(want["observation"]))
        assert sampler.metadata(plan, 0, i) == {"total_batches": 2, "temporal": True, "batch_index": i}
    assert type(AutoRandomSampler(2, 4).resolve(rollout)) is RandomSampler
    assert type(AutoRandomSampler(2, 4).resolve({**rollout, "critic_memory": None})) is TemporalRandomSampler


def test_trainer_runs_the_recurrent_entry_in_chunks():
    """Chunks of 3 (then 1) give the same metrics as single iterations; one
    host transfer per chunk; the rollout records the initial memories only."""

    def trainer(chunk):
        factory = get_experiment("Velocity-Flat", "recurrent_ppo").to_training_factory()
        factory.environment_kwargs = {"num_instances": 16}
        for k, v in dict(SMALL, num_steps_per_update=6, rnn_hidden_size=16).items():
            setattr(factory.agent, k, v)
        factory.num_iterations, factory.iterations_per_dispatch = 4, chunk
        return factory(device="cpu", verbose=False, seed=3)

    chunked, single = trainer(3), trainer(1)
    rows = [chunked.rollout_and_update() for _ in range(4)]
    ref = [single.rollout_and_update() for _ in range(4)]
    assert chunked.host_transfers == 2 and single.host_transfers == 4
    for a, b in zip(rows, ref):
        assert set(a) == set(b) and "kl_divergence" in a and "value_loss" in a
        for name in a:
            assert np.isfinite(a[name])
            np.testing.assert_allclose(a[name], b[name], rtol=1e-5, atol=1e-6, err_msg=name)
    rollout, _ = chunked.driver.collect(6)
    assert rollout["actor_memory"]["0"].shape == rollout["critic_memory"]["0"].shape == (1, 16, 1, 16)
    assert rollout["value"].shape == rollout["bootstrap_value"].shape == (6, 16, 1)

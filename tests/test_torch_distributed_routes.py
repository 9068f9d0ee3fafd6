"""Data parallelism on every route the port trains, on real gloo ranks,
against the JAX package's single-process update over the joined rollout.

Each route is a small agent built on both sides with the same
configuration (fp32, ``N_G = 12`` environments, ``T = 8`` steps, 2 epochs
of 3 minibatches): the recurrent entry with a GRU and with an LSTM, its
``ActionSmoothnessLoss`` and its ``TemporalRandomSampler``, the transformer
entry on the modular route and with ``JointSequentialEvaluation``, the AMP
entry (the discriminator's subsample drawn over the global minibatch), RND
with the return probe, distillation from a frozen expert,
``SymmetricDataAugmentation``, ``MirrorSymmetryLoss``,
``AdvantageReduction`` over two reward channels, an ``OptimizationStage``
with ``MiniBatchWiseLRSchedule``, the minibatch-wise advantage
normalization with per-epoch minibatch counts, ``RandomSampler``, and the
host loop's ``agent.update()`` and ``cross_process_update(agent)`` on the
ranks' ``Buffer``.  In this process the port's agent at ``N_G``
environments, with the JAX agent's state, collects a rollout on random data
through the host loop (``act``/``step``: every hook's rollout-time fields
and memories, warm after a first rollout); the JAX agent's plan and AMP's
subsample draws are taken from its keys, and its jitted ``update_body``
runs on the whole rollout while the ranks run.  Each of ``W = 2`` and
``W = 3`` ranks (one spawn per world size for every route) loads the same
JAX state (its own environments' rows of the per-environment state),
takes its environments' part of the rollout, the fed plan and draws, and
runs one global update.  With 3 minibatches ``W = 3`` splits each 32-row
minibatch 11/11/10 and each 4-environment temporal minibatch 2/1/1.

Each case holds rank 0's metrics, parameters and hook state against JAX at
``FP32_TOL`` (``tests/test_torch_distributed_update.py``), the
per-environment state (memories) of every rank against its rows of JAX's,
and every rank's metrics and state, bit for bit, against rank 0's.  The
ranks import only the port.  Last, ``globalize_rollout`` on the transformer
route's rollout joins every memory leaf on its environments.
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusrl_tpu.hook.auxiliary import representation as jax_representation
from cusrl_tpu.hook.auxiliary import rnd as jax_rnd
from cusrl_tpu.hook.auxiliary import smoothness as jax_smoothness
from cusrl_tpu.hook.auxiliary import symmetry as jax_symmetry
from cusrl_tpu.hook.auxiliary.estimation import StateEstimation as JaxStateEstimation
from cusrl_tpu.hook.control.optimization_stage import OptimizationStage as JaxOptimizationStage
from cusrl_tpu.hook.on_policy.advantage import AdvantageNormalization as JaxAdvantageNormalization
from cusrl_tpu.hook.on_policy.advantage import AdvantageReduction as JaxAdvantageReduction
from cusrl_tpu.hook.on_policy.gradient_clipping import GradientClipping as JaxGradientClipping
from cusrl_tpu.hook.on_policy.lr_schedule import MiniBatchWiseLRSchedule as JaxMiniBatchWise
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.preset.distillation import DistillationAgentFactory as JaxDistillationAgentFactory
from cusrl_tpu.preset.optimizer import AdamFactory as JaxAdamFactory
from cusrl_tpu.sampler.mini_batch_sampler import MiniBatchSampler as JaxMiniBatchSampler
from cusrl_tpu.sampler.random_sampler import RandomSampler as JaxRandomSampler
from cusrl_tpu.sampler.random_sampler import TemporalRandomSampler as JaxTemporalRandomSampler
from cusrl_tpu.testing import DummyEnvironment as JaxDummyEnvironment
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.hook import (
    ActionSmoothnessLoss,
    GradientClipping,
    MiniBatchWiseLRSchedule,
    MirrorSymmetryLoss,
    NextStatePrediction,
    OptimizationStage,
    RandomNetworkDistillation,
    ReturnPrediction,
    StateEstimation,
    SymmetricDataAugmentation,
)
from cusrl_tpu_torch.hook.on_policy.advantage import AdvantageNormalization, AdvantageReduction
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.preset.distillation import DistillationAgentFactory
from cusrl_tpu_torch.preset.optimizer import AdamFactory
from cusrl_tpu_torch.sampler import MiniBatchSampler, RandomSampler, TemporalRandomSampler
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import load_jax_state
from cusrl_tpu_torch.utils.nest import map_nested
from cusrl_tpu_torch.zoo.registry import get_experiment
from tests.test_torch_distributed import start
from tests.test_torch_distributed_update import FP32_TOL
from tests.test_torch_symmetry import involution

T, N_G, OBS, ACT, STATE = 8, 12, 10, 4, 6
WORLDS = (2, 3)
SAMPLER = dict(sampler_epochs=2, sampler_mini_batches=3)
MLP = dict(actor_hidden_dims=(16, 16), critic_hidden_dims=(16, 16), **SAMPLER)
RECURRENT = dict(rnn_hidden_size=16, mlp_hidden_dims=(16,), **SAMPLER)
# At the card's update check's lr 1e-4 (the entry's 1e-3 / 10): the attention's
# key bias gets no gradient in exact arithmetic (a shift of every score of a
# query), so Adam steps on its fp32 noise, which the ranks' summation order
# changes; at 1e-3 that moves it, and a feed-forward weight with a gradient
# near Adam's epsilon, by up to 6.3e-6 from the single process.
TRANSFORMER = dict(embed_dim=16, num_heads=2, attention_window=4, mlp_hidden_dims=(16,), lr=1e-4, **SAMPLER)
AMP_BATCH = 24


# -- the routes: (JAX underlying factory, port underlying factory, options) ----


def _zoo(name, algorithm, **overrides):
    factories = []
    for get in (jax_get_experiment, get_experiment):
        factory = get(name, algorithm).make_agent_factory()
        for key, value in {"num_steps_per_update": T, **overrides}.items():
            setattr(factory, key, value)
        factories.append(factory)
    return factories


def _underlying(name, algorithm, hooks=(), **overrides):
    """The zoo entry's underlying factories with ``hooks`` (``(jax hook,
    port hook, position)``) registered on both."""
    jf, tf = (f.to_underlying() for f in _zoo(name, algorithm, **overrides))
    for jax_hook, hook, position in hooks:
        jf.register_hook(jax_hook, **position)
        tf.register_hook(hook, **position)
    return jf, tf


def _samplers(jf, tf, jax_sampler, sampler):
    jf.sampler, tf.sampler = jax_sampler, sampler
    return jf, tf


def _amp():
    dataset = np.random.default_rng(2).standard_normal((256, 2 * STATE)).astype(np.float32) * 0.5 + 0.1
    return _underlying("Velocity-Flat", "amp", **MLP, amp_discriminator_hidden_dims=(16, 16),
                       amp_batch_size=AMP_BATCH, amp_state_indices=tuple(range(STATE)), amp_dataset_source=dataset)


def _distillation():
    expert_jf, expert_tf = _underlying("Velocity-Rough", "ppo", **MLP)
    jax_expert = expert_jf(JaxDummyEnvironment(observation_dim=OBS, action_dim=ACT).spec).state.actor
    expert = expert_tf(DummyEnvironment(observation_dim=OBS, action_dim=ACT).spec, device="cpu").actor
    student = dict(num_steps_per_update=T, actor_hidden_dims=(16, 16), sampler_epochs=2, sampler_mini_batches=3)
    return (JaxDistillationAgentFactory(expert=jax_expert, **student).to_underlying(),
            DistillationAgentFactory(expert=expert, **student).to_underlying())


def _stage():
    def stage(estimation, clipping, mlp, adam):
        return dict(stage_name="aux", optimizer_factory=adam(lr=1e-3), stage_hooks=(
            estimation(estimator_factory=mlp(hidden_dims=(16,)), target_name="observation", target_indices=(0, 1)),
            clipping(max_grad_norm=0.5)))

    return _underlying("Velocity-Rough", "ppo", [
        (JaxMiniBatchWise(), MiniBatchWiseLRSchedule(), {"after": "on_policy_preparation"}),
        (JaxOptimizationStage(**stage(JaxStateEstimation, JaxGradientClipping, JaxMlpFactory, JaxAdamFactory)),
         OptimizationStage(**stage(StateEstimation, GradientClipping, MlpFactory, AdamFactory)), {})], **MLP)


def _mini_batch_wise():
    jf, tf = _underlying("Velocity-Rough", "ppo", **MLP)
    jf.hooks = [JaxAdvantageNormalization(mini_batch_wise=True) if h.hook_name == "advantage_normalization" else h
                for h in jf.hooks]
    tf.hooks = [AdvantageNormalization(mini_batch_wise=True) if h.hook_name == "advantage_normalization" else h
                for h in tf.hooks]
    counts = (3, 2)  # per-epoch minibatch counts: two plan segments
    return _samplers(jf, tf, JaxMiniBatchSampler(num_epochs=2, num_mini_batches=counts),
                     MiniBatchSampler(num_epochs=2, num_mini_batches=counts))


ROUTES = {
    "gru": lambda: (_underlying("Velocity-Flat", "recurrent_ppo", **RECURRENT), {}),
    "lstm": lambda: (_underlying("Velocity-Flat", "recurrent_ppo", rnn_type="lstm", **RECURRENT), {}),
    "smoothness": lambda: (_underlying("Velocity-Flat", "recurrent_ppo", [(
        jax_smoothness.ActionSmoothnessLoss(weight_1st_order=(0.1, 0.2, 0.3, 0.4), weight_2nd_order=0.1),
        ActionSmoothnessLoss(weight_1st_order=(0.1, 0.2, 0.3, 0.4), weight_2nd_order=0.1),
        {"after": "on_policy_preparation"})], **RECURRENT), {}),
    "temporal_random": lambda: (_samplers(*_underlying("Velocity-Flat", "recurrent_ppo", **RECURRENT),
                                          JaxTemporalRandomSampler(3, 5, 4), TemporalRandomSampler(3, 5, 4)),
                                {"mode": "buffer"}),
    "transformer": lambda: (_underlying("Velocity-Flat", "transformer_ppo", **TRANSFORMER), {}),
    "transformer_joint": lambda: (_underlying("Velocity-Flat", "transformer_ppo", fuse_actor_critic_evaluation=True,
                                              **TRANSFORMER), {}),
    "amp": lambda: (_amp(), {"amp": True}),
    "rnd_probes": lambda: (_underlying("Velocity-Rough", "ppo", [
        (jax_rnd.RandomNetworkDistillation(module_factory=JaxMlpFactory(hidden_dims=(16,)), output_dim=8,
                                           reward_scale=0.5),
         RandomNetworkDistillation(module_factory=MlpFactory(hidden_dims=(16,)), output_dim=8, reward_scale=0.5),
         {"before": "value_computation"}),
        (jax_representation.ReturnPrediction(), ReturnPrediction(), {"after": "on_policy_preparation"}),
        (jax_representation.NextStatePrediction(target_indices=(0,)), NextStatePrediction(target_indices=(0,)),
         {"after": "on_policy_preparation"})], fuse_actor_critic_evaluation=False, **MLP), {"state_dim": STATE}),
    "distillation": lambda: (_distillation(), {}),
    "augmentation": lambda: (_underlying("Velocity-Rough", "ppo", [
        (jax_symmetry.SymmetricDataAugmentation(), SymmetricDataAugmentation(),
         {"before": "joint_policy_value_evaluation"})], **MLP), {"mirrors": True}),
    "mirror_loss": lambda: (_underlying("Velocity-Rough", "ppo", [
        (jax_symmetry.MirrorSymmetryLoss(weight=0.5), MirrorSymmetryLoss(weight=0.5),
         {"after": "on_policy_preparation"})], **MLP), {"mirrors": True}),
    "reduction": lambda: (_underlying("Velocity-Rough", "ppo", [
        (JaxAdvantageReduction(weight=(0.5, 2.0)), AdvantageReduction(weight=(0.5, 2.0)),
         {"before": "ppo_surrogate_loss"})], **MLP), {"reward_dim": 2}),
    "stage": lambda: (_stage(), {}),
    "mini_batch_wise": lambda: (_mini_batch_wise(), {}),
    "random": lambda: (_samplers(*_underlying("Velocity-Rough", "ppo", **MLP), JaxRandomSampler(3, 20),
                                 RandomSampler(3, 20)), {"mode": "buffer"}),
    "host_update": lambda: (_underlying("Velocity-Rough", "ppo", **MLP), {"mode": "update"}),
    "host_buffer": lambda: (_underlying("Velocity-Rough", "ppo", **MLP), {"mode": "buffer"}),
}


# -- this process: the rollout, the plan and the JAX update --------------------


def _collect(agent, rng, state_dim):
    """Two rollouts of the host loop on random data; returns the second
    (memories warm), its ``buffer_state`` and its memory keys."""
    n = agent.parallelism
    for _ in range(2):
        for _ in range(T):
            state = None if state_dim is None else rng.standard_normal((n, state_dim)).astype(np.float32)
            agent.act(np.tanh(rng.standard_normal((n, OBS))).astype(np.float32), state)
            agent.step(np.tanh(rng.standard_normal((n, OBS))).astype(np.float32),
                       rng.standard_normal((n, agent.value_dim)).astype(np.float32), rng.random((n, 1)) < 0.05,
                       rng.random((n, 1)) < 0.05,
                       next_state=None if state_dim is None else rng.standard_normal((n, state_dim)).astype(
                           np.float32))
        memory_keys = sorted(agent._initial_memories)
        rollout, buffer_state = agent.take_buffered_rollout()
    rollout = map_nested(lambda x: x.detach().numpy().copy(), rollout)
    return rollout, buffer_state, memory_keys


def _plan(jax_sampler, port_sampler, key, rollout, buffer_state):
    """The JAX sampler's plan, in the port's form."""
    if isinstance(port_sampler, RandomSampler):
        return np.asarray(jax_sampler.make_plan(key, T, N_G, rollout, buffer_state)[2])
    if isinstance(port_sampler, TemporalRandomSampler):
        return tuple(np.asarray(x) for x in jax_sampler.make_plan(key, T, N_G, rollout, buffer_state)[2])
    if port_sampler.temporal:  # N_G < 128: environments one by one
        return np.asarray(jax_sampler.make_plan(key, T, N_G, rollout)[2]).reshape(port_sampler.num_epochs, -1)
    plan = jax_sampler.make_epoch_plan(key, T, N_G, rollout)
    return [np.array(p[1]) for p in plan] if isinstance(plan, list) else np.array(plan[1])


def _prepare(name, monkeypatch):
    """The route's inputs for the ranks and its JAX update (not yet run)."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    (jf, tf), options = ROUTES[name]()
    dims = dict(observation_dim=OBS, action_dim=ACT, num_instances=N_G, state_dim=options.get("state_dim"),
                reward_dim=options.get("reward_dim", 1))
    jax_spec, spec = JaxDummyEnvironment(**dims).spec, DummyEnvironment(**dims).spec
    if options.get("mirrors"):
        for key, (mirror, jax_mirror) in (("mirror_observation", involution(OBS, 0)),
                                          ("mirror_action", involution(ACT, 1))):
            setattr(jax_spec, key, jax_mirror)
            setattr(spec, key, mirror)
    jax_agent, agent = jf(jax_spec), tf(spec, device="cpu")
    state = jax_agent.state_dict()["agent_state"]
    load_jax_state(agent, state)
    rollout, buffer_state, memory_keys = _collect(agent, np.random.default_rng(len(name)), options.get("state_dim"))
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    jax_buffer_state = {"cursor": jnp.asarray(buffer_state["cursor"], jnp.int32),
                        "full": jnp.asarray(buffer_state["full"])}
    key = jax.random.key(5)
    plan = _plan(jax_agent.sampler, agent.sampler.resolve(rollout), key, jax_rollout, jax_buffer_state)
    draws = {}
    if options.get("amp"):
        hook = "adversarial_motion_prior"
        rng, subsample = jax_agent.get_hook(hook).rng, []
        for _ in range(2 * 3):  # one split of the hook's key and one draw per minibatch
            draw_key, rng = jax.random.split(rng)
            subsample.append(np.asarray(jax.random.randint(draw_key, (AMP_BATCH,), 0, T * N_G // 3)))
        draws[hook] = subsample

    def oracle():
        new_state, metrics = jax.jit(jax_agent.update_body)(jax_agent.state, jax_rollout, key, jax_buffer_state)
        return ({k: float(v) for k, v in metrics.items()},
                {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state)
                 if p.startswith(("actor.", "critic.", "hooks.")) and not p.endswith(".rng")})

    case = {"factory": tf, "spec": spec, "state": state, "rollout": rollout, "plan": plan, "draws": draws,
            "mode": options.get("mode", "rollout"), "memory_keys": memory_keys}
    return case, oracle


_WORKER = r"""
import dataclasses, os, pickle, sys, time
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed
configure_distributed("cpu", timeout_s=60)
CONFIG.compute_dtype = None
from cusrl_tpu_torch.nn.module.causal_attn import CausalMultiheadSelfAttention
from cusrl_tpu_torch.parallel import cross_process_update, distribute_agent, globalize_rollout
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.interop import load_jax_state, state_entries
from cusrl_tpu_torch.utils.nest import iterate_nested, map_nested

# The lane route of the attention (K3's plain version), as the JAX package's on the CPU.
resolve = CausalMultiheadSelfAttention._resolve_mode
CausalMultiheadSelfAttention._resolve_mode = lambda self, x, ctx: (
    "lane" if self.sequence_mode == "auto" else resolve(self, x, ctx))
data = pickle.loads(open(os.path.join(os.environ["CASE_DIR"], "input.pkl"), "rb").read())
group = torch.distributed.group.WORLD
rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
n = data["envs"] // world
rows = np.arange(rank * n, (rank + 1) * n)


def fit(state, agent):
    # The JAX state of N_G environments: a per-environment entry takes this rank's rows.
    entries, fitted, per_env = state_entries(agent), {}, []
    for path, value in state.items():
        value = np.asarray(value)
        entry = entries.get(path)
        if entry is not None and tuple(value.shape) != tuple(entry.shape):
            value = np.take(value, rows, axis=[a != b for a, b in zip(value.shape, entry.shape)].index(True))
            per_env.append(path)
        fitted[path] = value
    return fitted, per_env


out = {}
for name, case in data["routes"].items():
    agent = case["factory"](dataclasses.replace(case["spec"], num_instances=n), device="cpu", seed=rank)
    distribute_agent(agent)
    state, per_env = fit(case["state"], agent)
    load_jax_state(agent, state)
    for hook_name, draws in case["draws"].items():
        agent.get_hook(hook_name).queue_draws(subsample=draws)
    rollout = map_nested(lambda a: torch.from_numpy(np.array(a[:, rows])), case["rollout"])
    if name == "transformer":  # every memory leaf joined on its environments
        memories = {k: rollout[k] for k in case["memory_keys"]}
        joined = dict(iterate_nested(globalize_rollout(memories, group)))
        out["joined"] = all(np.array_equal(value.numpy(), np.asarray(dict(iterate_nested(
            {k: case["rollout"][k] for k in case["memory_keys"]}))[path])) for path, value in joined.items())
        out["joined_paths"] = sorted(joined)
    distributed.reset_collective_counts()
    begin = time.perf_counter()
    if case["mode"] == "rollout":
        metrics = cross_process_update(agent, rollout, epoch_perms=case["plan"])
    else:  # the host loop: the rank's steps pushed into its Buffer
        for t in range(rollout["action"].shape[0]):
            agent.buffer.push({k: map_nested(lambda x: x[t], v) for k, v in rollout.items()
                               if k not in case["memory_keys"]})
        agent._initial_memories = {k: map_nested(lambda x: x[0], rollout[k]) for k in case["memory_keys"]}
        update_body = agent.update_body
        agent.update_body = lambda r, **kw: update_body(r, **{**kw, "epoch_perms": case["plan"]})
        metrics = agent.update() if case["mode"] == "update" else cross_process_update(
            agent, epoch_perms=case["plan"])
    out[name] = {"metrics": metrics, "per_env": per_env, "seconds": time.perf_counter() - begin,
                 "collectives": {k: list(v) for k, v in distributed.COLLECTIVES.items()},
                 "draws_left": sum(len(agent.get_hook(h)._subsample_draws) for h in case["draws"]),
                 "state": {p: np.array(e.read()) for p, e in state_entries(agent).items()}}
open(os.path.join(os.environ["CASE_DIR"], f"rank{rank}.pkl"), "wb").write(pickle.dumps(out))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    """Every route's inputs, the ranks of both world sizes started on them,
    the JAX updates run meanwhile; returns ``({world: rank results},
    {route: JAX (metrics, state)})``."""
    cases, oracles = {}, {}
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
        monkeypatch.setattr(CONFIG, "compute_dtype", None)
        for name in ROUTES:
            cases[name], oracles[name] = _prepare(name, monkeypatch)
        waits = {}
        for world in WORLDS:
            case_dir = tmp_path_factory.mktemp(f"routes{world}")
            (case_dir / "input.pkl").write_bytes(pickle.dumps({"envs": N_G, "routes": cases}))
            waits[world] = start(_WORKER, world, case_dir)
        with ThreadPoolExecutor(4) as pool:  # the JAX compiles, side by side
            results = dict(zip(oracles, pool.map(lambda oracle: oracle(), oracles.values())))
    return {world: wait() for world, wait in waits.items()}, results


def _is_parameter(path: str) -> bool:
    return path.startswith(("actor.", "critic.")) or (path.startswith("hooks.") and ".opt_state." not in path
                                                      and any(f".{m}." in path for m in (
                                                          "discriminator", "predictor", "target", "expert",
                                                          "estimator")))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_the_jax_single_process_update(routes, route, world):
    """Rank 0's metrics, parameters (the hooks' networks included) and hook
    state against the JAX update over the joined rollout; every rank's
    per-environment state (the memories a sequence pass leaves) against its
    rows of JAX's."""
    ranks, oracle = routes
    jax_metrics, jax_state = oracle[route]
    metric_tol, param_tol, state_tol = FP32_TOL
    result = ranks[world][0][route]
    assert result["draws_left"] == 0
    assert set(result["metrics"]) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(result["metrics"][key], value, err_msg=key, **metric_tol)
    compared = [p for p in jax_state if p in result["state"]]
    assert {p for p in jax_state if p.startswith(("actor.", "critic."))} <= set(compared)
    n = N_G // world
    for rank, rank_result in enumerate(ranks[world]):
        state = rank_result[route]["state"]
        for path in compared:
            want = jax_state[path]
            if path in rank_result[route]["per_env"]:
                got = np.asarray(state[path], np.float32)
                axis = [a != b for a, b in zip(want.shape, got.shape)].index(True)
                want = np.take(want, np.arange(rank * n, (rank + 1) * n), axis=axis)
            elif rank:
                continue
            np.testing.assert_allclose(np.asarray(state[path], np.float32), want, err_msg=path,
                                       **(param_tol if _is_parameter(path) else state_tol))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_ranks_end_bit_for_bit_equal(routes, route, world):
    """Metrics, parameters, optimizer states (the stage's included), hook
    state and learning rates: the same bits on every rank; only the
    per-environment state is the rank's own."""
    ranks, _ = routes
    first = ranks[world][0][route]
    for rank, results in enumerate(ranks[world][1:], 1):
        result = results[route]
        assert result["metrics"] == first["metrics"], f"rank {rank} metrics"
        assert set(result["state"]) == set(first["state"]) and result["per_env"] == first["per_env"]
        for path, value in first["state"].items():
            if path not in first["per_env"]:
                np.testing.assert_array_equal(result["state"][path], value, err_msg=f"rank {rank}: {path}")


def test_memories_join_on_their_environments(routes):
    """The transformer's rollout memories (the attention caches ``[1, N,
    heads, slots, D]`` and the cursor broadcast to ``[1, N]``), joined by
    ``globalize_rollout`` on every rank, equal the single process's, bit for
    bit: a join on another axis would change their shape or their order."""
    ranks, _ = routes
    for world in WORLDS:
        for result in ranks[world]:
            assert result["joined"] and any(p.endswith("k_cache") for p in result["joined_paths"])
            assert any(p.endswith("cursor") for p in result["joined_paths"])

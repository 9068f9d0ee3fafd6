"""Tensor parallelism and the hierarchical mesh on real gloo ranks, against
the JAX package.

``parallel.get_mesh(model_parallel_size=M, dcn_parallel_size=K)`` lays the
ranks out as JAX lays out devices (the model axis fastest), and
``distribute_agent(..., tensor_parallel=True)`` narrows every Mlp parameter
that ``Mlp.tp_specs`` shards (Megatron style) to the rank's part.  Each case
is a small agent (fp32, ``N_G = 12`` environments, ``T = 8`` steps, 2 epochs
of 3 minibatches, the port's agent collecting the rollout through the host
loop, the JAX plan and AMP's draws fed, as
``tests/test_torch_distributed_routes.py`` does), updated once on the ranks
and held against the JAX package's single-process update over the whole
rollout:

* meshes: 1 x 2 (``model=2``), 2 x 2, ``dcn=2 x data=2`` (pure data
  parallelism, the gradient reduced within ``ici`` then ``dcn``) and 1 x 4,
  where the MLP agent's 6-wide last layers do not divide and stay whole,
  with JAX's warning;
* routes at 1 x 2: the MLP agent with the joint evaluation (on every mesh),
  ``FusedPpoUpdate`` on its plain route, the transformer entry (its ELU head
  sharded), the recurrent entry (a GRU with a sharded head) and AMP (the
  discriminator sharded, its gradient penalty differentiating through the
  Megatron operators); the MLP agent also against JAX's own tensor-parallel
  update on the virtual 8-device CPU mesh.

Every whole leaf and metric is bit for bit equal on all ranks, every sharded
leaf across data peers, and model peers hold the same gradient of every
whole leaf after the backward (no reduce makes them so).  Then the Trainer:
two iterations at 1 x 2 against the port's one process, the same state,
seeds, action noise and plans, the model peers stepping the same
observations and actions bit for bit; its rank-0 checkpoint loads into a
one-process agent bit for bit.  Last, ``collect_tp_specs`` against JAX's
under the interop path map, and the exports.
"""

from __future__ import annotations

import dataclasses
import pickle
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.hook.auxiliary import rnd as jax_rnd
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.nn.module.mlp import MlpFactory as JaxMlpFactory
from cusrl_tpu.parallel import sharding as jax_sharding
from cusrl_tpu.testing import DummyEnvironment as JaxDummyEnvironment
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu_torch.hook import RandomNetworkDistillation
from cusrl_tpu_torch.nn.module.mlp import MlpFactory
from cusrl_tpu_torch.testing.environment import DummyEnvironment
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import _jax_parameter_path, load_jax_state
from tests.test_torch_distributed import start
from tests.test_torch_distributed_routes import (ACT, AMP_BATCH, N_G, OBS, RECURRENT, SAMPLER, TRANSFORMER, T,
                                                 _amp, _collect, _plan, _underlying)
from tests.test_torch_distributed_update import BF16_TOL, FP32_TOL

MLP = dict(actor_hidden_dims=(16, 16, 6), critic_hidden_dims=(16, 16, 6), **SAMPLER)
ROUTES = {
    "mlp": lambda: (_underlying("Velocity-Rough", "ppo", **MLP), FP32_TOL),
    # Its JAX reference runs bf16 chains whatever the compute dtype (tests/test_torch_distributed_update.py).
    "fused": lambda: (_underlying("Velocity-Rough", "ppo", fused_ppo_update=True, **MLP), BF16_TOL),
    "transformer": lambda: (_underlying("Velocity-Flat", "transformer_ppo", **TRANSFORMER), FP32_TOL),
    "gru": lambda: (_underlying("Velocity-Flat", "recurrent_ppo", **RECURRENT), FP32_TOL),
    "amp": lambda: (_amp(), FP32_TOL),
}
# (world, model, dcn) -> the routes updated on that mesh.
MESHES = {"1x2": (2, 2, 1, tuple(ROUTES)), "2x2": (4, 2, 1, ("mlp",)), "dcn2x2": (4, 1, 2, ("mlp",)),
          "1x4": (4, 4, 1, ("mlp",))}
TRAINER = dict(envs=16, steps=8, iterations=2)


def _prepare(name):
    """The route's inputs for the ranks, its JAX update (not yet run) and tolerance."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(JAX_CONFIG, "seed", 0)
        monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
        (jf, tf), tol = ROUTES[name]()
        dims = dict(observation_dim=OBS, action_dim=ACT, num_instances=N_G)
        jax_spec, spec = JaxDummyEnvironment(**dims).spec, DummyEnvironment(**dims).spec
        jax_agent, agent = jf(jax_spec), tf(spec, device="cpu")
    state = jax_agent.state_dict()["agent_state"]
    load_jax_state(agent, state)
    rollout, buffer_state, memory_keys = _collect(agent, np.random.default_rng(len(name)), None)
    jax_rollout = jax.tree.map(jnp.asarray, rollout)
    jax_buffer_state = {"cursor": jnp.asarray(buffer_state["cursor"], jnp.int32),
                        "full": jnp.asarray(buffer_state["full"])}
    key = jax.random.key(5)
    plan = _plan(jax_agent.sampler, agent.sampler.resolve(rollout), key, jax_rollout, jax_buffer_state)
    draws = {}
    if name == "amp":
        hook = "adversarial_motion_prior"
        rng, subsample = jax_agent.get_hook(hook).rng, []
        for _ in range(2 * 3):  # one split of the hook's key and one draw per minibatch
            draw_key, rng = jax.random.split(rng)
            subsample.append(np.asarray(jax.random.randint(draw_key, (AMP_BATCH,), 0, T * N_G // 3)))
        draws[hook] = subsample

    def oracle(mesh=None):
        state = jax_agent.state
        if mesh is not None:  # JAX's own tensor-parallel update
            jax_sharding.distribute_agent(jax_agent, mesh, tensor_parallel=True)
            state = jax_agent.state
        with jax.set_mesh(mesh) if mesh is not None else _nothing():
            new_state, metrics = jax.jit(jax_agent.update_body)(state, jax_rollout, key, jax_buffer_state)
        return ({k: float(v) for k, v in metrics.items()},
                {p: np.asarray(v, np.float32) for p, v in tree_paths(new_state)
                 if p.startswith(("actor.", "critic.", "hooks.")) and not p.endswith(".rng")})

    case = {"factory": tf, "spec": spec, "state": state, "rollout": rollout, "plan": plan, "draws": draws,
            "memory_keys": memory_keys}
    return case, oracle, tol


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *args):
        return False


_COMMON = r"""
import dataclasses, os, pickle, sys, warnings
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed
configure_distributed("cpu", timeout_s=60)
CONFIG.compute_dtype = None
warnings.simplefilter("always")
from cusrl_tpu_torch.nn.module.causal_attn import CausalMultiheadSelfAttention
from cusrl_tpu_torch.parallel import cross_process_update, distribute_agent, get_mesh
from cusrl_tpu_torch.parallel.tensor import shard_of
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.interop import load_jax_state, state_entries
from cusrl_tpu_torch.utils.nest import map_nested

# The lane route of the attention (K3's plain version), as the JAX package's on the CPU.
resolve = CausalMultiheadSelfAttention._resolve_mode
CausalMultiheadSelfAttention._resolve_mode = lambda self, x, ctx: (
    "lane" if self.sequence_mode == "auto" else resolve(self, x, ctx))
with open(os.path.join(os.environ["CASE_DIR"], "input.pkl"), "rb") as f:
    data = pickle.load(f)
rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()


def fit(state, agent, rows):
    # The JAX state of N_G environments: a per-environment entry takes this data rank's rows.
    entries, fitted, per_env = state_entries(agent), {}, []
    for path, value in state.items():
        value = np.asarray(value)
        entry = entries.get(path)
        if entry is not None and tuple(value.shape) != tuple(entry.shape):
            value = np.take(value, rows, axis=[a != b for a, b in zip(value.shape, entry.shape)].index(True))
            per_env.append(path)
        fitted[path] = value
    return fitted, per_env


def update(case, model, dcn):
    mesh = get_mesh(model, dcn_parallel_size=dcn)
    data_world, data_rank = world // model, rank // model
    n = data["envs"] // data_world
    rows = np.arange(data_rank * n, (data_rank + 1) * n)
    agent = case["factory"](dataclasses.replace(case["spec"], num_instances=n), device="cpu", seed=rank)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        distribute_agent(agent, mesh, tensor_parallel=True)
    state, per_env = fit(case["state"], agent, rows)
    load_jax_state(agent, state)
    for hook_name, draws in case["draws"].items():
        agent.get_hook(hook_name).queue_draws(subsample=draws)
    rollout = map_nested(lambda a: torch.from_numpy(np.array(a[:, rows])), case["rollout"])
    names = {id(p): name for name, p in agent.model.named_parameters()}
    first = {}

    def keep_first(optimizer, args, kwargs):  # the gradients after the backward and the data reduce
        if not first and optimizer is agent.optimizer.optimizer:
            first.update({names[id(p)]: p.grad.detach().clone() for group in optimizer.param_groups
                          for p in group["params"] if p.grad is not None and shard_of(p) is None})

    handle = register_optimizer_step_pre_hook(keep_first)
    distributed.reset_collective_counts()
    try:
        metrics = cross_process_update(agent, rollout, epoch_perms=case["plan"])
    finally:
        handle.remove()
    by_axis = {axis: {k: list(v) for k, v in kinds.items()} for axis, kinds in distributed.COLLECTIVES_BY_AXIS.items()}
    return {"metrics": metrics, "per_env": per_env, "collectives": by_axis, "first_grads": first,
            "warnings": [str(w.message) for w in caught],
            "sharded": {p: (shard_of(v).dim, tuple(v.shape)) for p, v in agent.model.named_parameters()
                        if shard_of(v) is not None},
            "moments": {p: tuple(agent.optimizer.optimizer.state[v]["exp_avg"].shape)
                        for p, v in agent.model.named_parameters() if shard_of(v) is not None},
            "state": {p: np.array(e.read()) for p, e in state_entries(agent).items()}}
"""

_MAIN = r"""
out = {}
for mesh_name, (mesh_world, model, dcn, routes) in data["meshes"].items():
    if mesh_world == world:
        out[mesh_name] = {name: update(data["routes"][name], model, dcn) for name in routes}
if world == 2:
    from cusrl_tpu_torch.template.logger import save_checkpoint_file

    CONFIG.model_parallel_size = 2
    trainer, record = build_trainer(data["trainer"])
    mesh = get_mesh()
    distribute_agent(trainer.agent, mesh, tensor_parallel=True)
    metrics = [trainer.rollout_and_update() for _ in range(data["trainer"]["iterations"])]
    checkpoint = trainer.make_checkpoint()
    if rank == 0:
        save_checkpoint_file(os.path.join(os.environ["CASE_DIR"], "ckpt.npz"), checkpoint)
    out["trainer"] = {"metrics": metrics, "record": record, "seed": CONFIG.process_seed,
                      "data_ranks": trainer._data_ranks(),
                      "state": {p: np.array(e.read()) for p, e in state_entries(trainer.agent).items()}}
open(os.path.join(os.environ["CASE_DIR"], f"rank{rank}.pkl"), "wb").write(pickle.dumps(out))
torch.distributed.destroy_process_group()
"""

_TRAINER = r"""
def build_trainer(setup):
    # Velocity-Rough ppo at small widths through its training factory, the
    # action noise and the plans fed from tables (the one-process agent draws
    # its plan from the noise generator, a distributed one from its plan
    # generator), recording each step's observation and action.
    import numpy as np
    import torch

    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("Velocity-Rough", "ppo").to_training_factory()
    factory.environment_kwargs = {"num_instances": setup["envs"]}
    factory.iterations_per_dispatch = 1
    factory.agent.num_steps_per_update = setup["steps"]
    factory.agent.actor_hidden_dims = factory.agent.critic_hidden_dims = (16, 16, 6)
    trainer = factory(device="cpu", verbose=False)
    agent = trainer.agent
    rng = np.random.default_rng(4)
    noise = iter(torch.from_numpy(rng.standard_normal(
        (setup["iterations"] * setup["steps"], setup["envs"], agent.action_dim)).astype(np.float32)))
    perms = iter([np.stack([rng.permutation(setup["steps"] * setup["envs"]) for _ in range(5)])
                  for _ in range(setup["iterations"])])
    record = {"observation": [], "action": []}
    act_body, update_body = agent.act_body, agent.update_body

    def act(observation, noise_=None, state=None):
        transition = act_body(observation, next(noise), state)
        record["observation"].append(observation.numpy().copy())
        record["action"].append(transition["action"].numpy().copy())
        return transition

    agent.act_body = act
    agent.update_body = lambda rollout, **kwargs: update_body(rollout, epoch_perms=next(perms))
    return trainer, record
"""
_WORKER = _COMMON + _TRAINER + _MAIN


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' ranks started on every mesh's routes, the JAX
    updates (and JAX's own tensor-parallel update of the MLP agent) and the
    port's one-process Trainer run meanwhile."""
    cases, oracles, tols = {}, {}, {}
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
        monkeypatch.setattr(CONFIG, "compute_dtype", None)
        for name in ROUTES:
            cases[name], oracles[name], tols[name] = _prepare(name)
        waits = {}
        for world in (2, 4):
            case_dir = tmp_path_factory.mktemp(f"tp{world}")
            (case_dir / "input.pkl").write_bytes(pickle.dumps(
                {"envs": N_G, "routes": cases, "meshes": MESHES, "trainer": TRAINER}))
            waits[world] = (case_dir, start(_WORKER, world, case_dir))
        with ThreadPoolExecutor(4) as pool:  # the JAX compiles, side by side
            results = dict(zip(oracles, pool.map(lambda oracle: oracle(), oracles.values())))
        jax_tp = oracles["mlp"](jax_sharding.get_mesh(model_parallel_size=2))
        namespace = {}
        exec(compile(_TRAINER, "trainer", "exec"), namespace)
        trainer, record = namespace["build_trainer"](TRAINER)
        single = {"metrics": [trainer.rollout_and_update() for _ in range(TRAINER["iterations"])], "record": record,
                  "state": {p: np.array(e.read()) for p, e in state_entries_of(trainer.agent).items()}}
    ranks = {world: wait() for world, (_, wait) in waits.items()}
    return ranks, results, jax_tp, tols, single, waits[2][0]


def state_entries_of(agent):
    from cusrl_tpu_torch.utils.interop import state_entries

    return state_entries(agent)


def _mesh_results(runs, mesh):
    ranks, *_ = runs
    world = MESHES[mesh][0]
    return [result[mesh] for result in ranks[world]]


def _is_parameter(path: str) -> bool:
    return path.startswith(("actor.", "critic.")) or (path.startswith("hooks.") and ".opt_state." not in path and any(
        f".{m}." in path for m in ("discriminator", "predictor", "target", "expert", "estimator")))


def _compare(result, oracle, tol, rank=0, world=1):
    metric_tol, param_tol, state_tol = tol
    jax_metrics, jax_state = oracle
    assert set(result["metrics"]) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(result["metrics"][key], value, err_msg=key, **metric_tol)
    compared = [p for p in jax_state if p in result["state"]]
    assert {p for p in jax_state if p.startswith(("actor.", "critic."))} <= set(compared)
    n = N_G // world
    for path in compared:
        want = jax_state[path]
        got = np.asarray(result["state"][path], np.float32)
        if path in result["per_env"]:
            axis = [a != b for a, b in zip(want.shape, got.shape)].index(True)
            want = np.take(want, np.arange(rank * n, (rank + 1) * n), axis=axis)
        np.testing.assert_allclose(got, want, err_msg=path, **(param_tol if _is_parameter(path) else state_tol))


CASES = [(mesh, route) for mesh, (_, _, _, routes) in MESHES.items() for route in routes]


@pytest.mark.parametrize("mesh, route", CASES)
def test_update_matches_the_jax_single_process_update(runs, mesh, route):
    """Metrics, parameters (shards gathered to their full arrays: the
    entries' reads), the hooks' networks and state against JAX's update over
    the joined rollout; each data rank's per-environment state against its
    rows of JAX's."""
    _, oracles, _, tols, _, _ = runs
    results = _mesh_results(runs, mesh)
    model = MESHES[mesh][1]
    data_world = len(results) // model
    for rank, result in enumerate(results):
        if rank % model == 0:
            _compare(result[route], oracles[route], tols[route], rank // model, data_world)


@pytest.mark.parametrize("mesh, route", CASES)
def test_ranks_end_bit_for_bit_equal(runs, mesh, route):
    """Every metric and every leaf (a sharded one gathered) the same bits on
    every rank; only the per-environment state is a data rank's own, the
    same on its model peers."""
    results = _mesh_results(runs, mesh)
    model = MESHES[mesh][1]
    first = results[0][route]
    for rank, results_r in enumerate(results):
        result = results_r[route]
        peer = results[rank - rank % model][route]
        assert result["metrics"] == first["metrics"], f"rank {rank} metrics"
        assert set(result["state"]) == set(first["state"]) and result["per_env"] == first["per_env"]
        for path, value in result["state"].items():
            want = peer["state"][path] if path in first["per_env"] else first["state"][path]
            np.testing.assert_array_equal(value, want, err_msg=f"rank {rank}: {path}")


@pytest.mark.parametrize("mesh, route", CASES)
def test_model_peers_hold_the_same_gradients_of_whole_leaves(runs, mesh, route):
    """The first minibatch's gradient of every whole leaf (heads, odd layers'
    biases, ``std_param``, a replicated pair) after the backward: the same
    bits on model peers, with no reduce over the model group."""
    results = _mesh_results(runs, mesh)
    model = MESHES[mesh][1]
    for rank, result in enumerate(results):
        grads, lead = result[route]["first_grads"], results[rank - rank % model][route]["first_grads"]
        assert grads and set(grads) == set(lead)
        for path, value in grads.items():
            assert torch.equal(value, lead[path]), f"rank {rank}: {path}"


def test_mlp_update_matches_the_jax_tensor_parallel_update(runs):
    """The 1 x 2 ranks against JAX's own ``distribute_agent(agent,
    get_mesh(model_parallel_size=2), tensor_parallel=True)`` update on the
    virtual 8-device CPU mesh."""
    _, _, jax_tp, tols, _, _ = runs
    _compare(_mesh_results(runs, "1x2")[0]["mlp"], jax_tp, tols["mlp"])


def test_shards_and_the_replicated_fallback(runs):
    """At 1 x 2 each Mlp's even layers hold half their output rows and odd
    layers half their input columns (the 6-wide last layers three rows);
    at 1 x 4 the 6-wide layers stay whole, each leaf with JAX's warning, and
    the announcement of the chain kernels' drop is made once a process."""
    shapes = _mesh_results(runs, "1x2")[0]["mlp"]["sharded"]
    moments = _mesh_results(runs, "1x2")[0]["mlp"]["moments"]
    assert moments == {path: shape for path, (_, shape) in shapes.items()}  # Adam's moments held sharded too
    assert shapes["actor.backbone.layers.0.weight"] == (0, (8, OBS))
    assert shapes["actor.backbone.layers.1.weight"] == (1, (16, 8))
    assert shapes["critic.backbone.layers.2.bias"] == (0, (3,))
    assert "actor.backbone.layers.1.bias" not in shapes and "critic.head.weight" not in shapes
    four = _mesh_results(runs, "1x4")
    for result in four:
        sharded = result["mlp"]["sharded"]
        assert sharded["actor.backbone.layers.0.weight"] == (0, (4, OBS))
        assert not any(".layers.2." in path for path in sharded)
        fallback = [w for w in result["mlp"]["warnings"] if "does not divide over model=4" in w]
        assert len(fallback) == 4  # two leaves of two 6-wide layers
    ranks, *_ = runs
    for world in (2, 4):
        for result in ranks[world]:
            announced = [w for mesh, routes in result.items() if mesh in MESHES for route in routes.values()
                         for w in route["warnings"] if "disables the fused MLP chain kernels" in w]
            assert len(announced) == 1


def test_collectives_by_axis(runs):
    """The Megatron operators run over ``model``; the gradients over
    ``data`` (a group of one at 1 x 2: the identity), over ``ici`` then
    ``dcn`` on the hierarchical mesh, which moves nothing over ``model``."""
    one = _mesh_results(runs, "1x2")[0]["mlp"]["collectives"]
    assert one["model"]["all_reduce"][0] > 0 and one["model"]["all_gather"][0] > 0
    hierarchical = _mesh_results(runs, "dcn2x2")[0]["mlp"]["collectives"]
    assert "model" not in hierarchical
    assert hierarchical["ici"]["all_reduce"] == hierarchical["dcn"]["all_reduce"]
    assert hierarchical["ici"]["all_reduce"][0] == 2 * 3  # 2 epochs x 3 minibatches
    replicated = _mesh_results(runs, "1x4")[0]["mlp"]["collectives"]["model"]
    assert "all_gather" not in replicated  # the sharded pairs end on a row layer; the 6-wide layers move nothing


def test_trainer_at_1x2_matches_one_process(runs):
    """Two iterations through ``Trainer.rollout_and_update`` at 1 x 2
    (``CONFIG.model_parallel_size = 2``: both ranks seed as data rank 0)
    against one process with the same seed, noise and plans: the model
    peers step the same observations and actions bit for bit, and both
    match the one process at JAX's own tensor-parallel tolerance (atol 5e-5,
    ``tests/test_parallel.py``): the rollout feeds the reordered sums back
    through the environment."""
    ranks, _, _, _, single, _ = runs
    first, second = (result["trainer"] for result in ranks[2])
    assert first["seed"] == second["seed"] == CONFIG.seed and first["data_ranks"] == 1
    for key in ("observation", "action"):
        assert len(first["record"][key]) == TRAINER["iterations"] * TRAINER["steps"]
        for step, (a, b) in enumerate(zip(first["record"][key], second["record"][key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {step}")
        np.testing.assert_allclose(np.stack(first["record"][key]), np.stack(single["record"][key]), rtol=0,
                                   atol=5e-5, err_msg=key)
    assert first["metrics"] == second["metrics"]
    for got, want in zip(first["metrics"], single["metrics"]):
        assert set(got) == set(want)
        for key in ("Train/surrogate_loss", "Train/value_loss"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=5e-5, err_msg=key)
    for path, value in single["state"].items():
        if path.startswith(("actor.", "critic.")):
            np.testing.assert_allclose(first["state"][path], value, rtol=0, atol=5e-5, err_msg=path)


def test_checkpoint_of_a_tensor_parallel_run_loads_into_one_process(runs):
    """The 1 x 2 Trainer's rank-0 checkpoint has the one-process shapes and
    loads into a one-process agent bit for bit."""
    from cusrl_tpu_torch.template.logger import load_checkpoint_file

    ranks, *_, case_dir = runs
    checkpoint = load_checkpoint_file(str(case_dir / "ckpt.npz"))
    namespace = {}
    exec(compile(_TRAINER, "trainer", "exec"), namespace)
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(CONFIG, "compute_dtype", None)
        trainer, _ = namespace["build_trainer"](TRAINER)
    agent = trainer.agent
    agent.load_state_dict(checkpoint["agent"])
    state = {p: np.array(e.read()) for p, e in state_entries_of(agent).items()}
    want = ranks[2][0]["trainer"]["state"]
    assert set(state) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(state[path], value, err_msg=path)
    assert tuple(agent.actor.backbone.layers[0].weight.shape) == (16, agent.observation_dim)


def _spec_agents():
    """The AMP entry's agent with RND's networks, on both sides."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(JAX_CONFIG, "seed", 0)
        monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
        jf, tf = _amp()
        jf.register_hook(jax_rnd.RandomNetworkDistillation(module_factory=JaxMlpFactory(hidden_dims=(16,)),
                                                           output_dim=8), before="value_computation")
        tf.register_hook(RandomNetworkDistillation(module_factory=MlpFactory(hidden_dims=(16,)), output_dim=8),
                         before="value_computation")
        dims = dict(observation_dim=OBS, action_dim=ACT, num_instances=N_G)
        return jf(JaxDummyEnvironment(**dims).spec), tf(DummyEnvironment(**dims).spec, device="cpu")


def test_collect_tp_specs_equals_jax_under_the_path_map():
    """Every Mlp of the agent (actor, critic, AMP's discriminator, RND's
    predictor and target) declares JAX's specs, by the port's parameter
    paths, which the interop path map takes to JAX's."""
    from cusrl_tpu_torch.parallel import collect_tp_specs

    jax_agent, agent = _spec_agents()
    jax_specs = {path: tuple(spec) for path, spec in jax_sharding.collect_tp_specs(jax_agent.state).items()}
    index_of = {hook.hook_name: index for index, hook in enumerate(agent.hooks)}
    specs = {_jax_parameter_path(path, index_of): spec for path, spec in collect_tp_specs(agent).items()}
    assert specs == jax_specs
    assert any(".discriminator." in p for p in specs) and any(".predictor." in p for p in specs)
    assert any(".target." in p for p in specs)


def test_jax_leaves_a_non_dividing_leaf_replicated_with_a_warning():
    """JAX's side of the fallback the 1 x 4 ranks take: a 6-wide layer on a
    model axis of 4 stays replicated, with the warning the port repeats."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(JAX_CONFIG, "seed", 0)
        monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
        (jf, _), _ = ROUTES["mlp"]()
        jax_agent = jf(JaxDummyEnvironment(observation_dim=OBS, action_dim=ACT, num_instances=N_G).spec)
    with pytest.warns(UserWarning, match="does not divide over model=4; leaving replicated"):
        jax_sharding.distribute_agent(jax_agent, jax_sharding.get_mesh(model_parallel_size=4), tensor_parallel=True)
    leaves = dict(tree_paths(jax_agent.state))
    assert leaves["actor.backbone.layers.2.weight"].sharding.is_fully_replicated
    assert not leaves["actor.backbone.layers.0.weight"].sharding.is_fully_replicated
    # JAX places the moments of a sharded leaf replicated (ROADMAP.md, Queue 3); the port holds them sharded.
    assert leaves["opt_state.0.inner_state.mu.actor.backbone.layers.0.weight"].sharding.is_fully_replicated


def test_tensor_parallel_rules_are_jax_s():
    from cusrl_tpu_torch.parallel import tensor_parallel_rules

    assert tensor_parallel_rules() == [(pattern, tuple(spec)) for pattern, spec in
                                       jax_sharding.tensor_parallel_rules()]


def test_mlp_tp_specs_keys_match_jax_for_every_depth():
    from cusrl_tpu.nn.module.mlp import MlpFactory as JaxFactory

    for hidden in ((8,), (8, 8), (8, 8, 8, 8)):
        for bias in (True, False):
            jax_mlp = JaxFactory(hidden_dims=hidden, bias=bias)(4, 3, jax.random.key(0))
            mlp = MlpFactory(hidden_dims=hidden, bias=bias)(4, 3)
            assert mlp.tp_specs() == jax_mlp.tp_specs()


def test_a_whole_mlp_keeps_its_route_and_numerics():
    """Without shards nothing changes: ``sharded`` is False, ``_can_fuse``
    follows the JAX rule, and the chain is the layer-by-layer one."""
    mlp = MlpFactory(hidden_dims=(8, 8), compute_dtype=None)(4, 3, torch.Generator().manual_seed(0))
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    assert not mlp.sharded and mlp.ends_with_activation and not mlp._can_fuse(x)
    h = x
    for layer in mlp.layers:
        h = torch.nn.functional.elu(layer(h))
    assert torch.equal(mlp(x)[0], h)

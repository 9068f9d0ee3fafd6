"""Data-parallel updates of the port on real gloo ranks against one process.

``W`` subprocess ranks (``torch.distributed`` over gloo on the CPU, each with
a free port, a process-group timeout and a hard ``communicate`` timeout) each
hold their own ``[T, N_local]`` rollout.  One ``cross_process_update`` on them
must give the JAX package's single-process ``update_body`` on the rollouts
concatenated on the environment axis (the oracle of
``tests/test_multihost.py``), with the JAX plan's permutations fed, and every
rank must end with the same parameters, optimizer state and hook state, bit
for bit.  The configuration is the zoo's Velocity-Rough ``ppo`` at small
widths (observation normalization, the KL-adaptive learning rate, here with
an update-rejection bound the update stays under, joint evaluation), with
non-trivial hook state carried from the JAX side, in fp32.  W = 2 splits each
128-row tile between the ranks; W = 3 with 3 minibatches gives the ranks 43,
43 and 42 rows of each 128-row minibatch.  Tolerances are those of
``tests/test_torch_update_zoo.py``: fp32 summation order for the joint route,
and for the fused update (``fused_ppo_update=True``, split and mono mode, the
plain versions on the CPU) bf16 rounding, since its JAX reference runs bf16
chains whatever the compute dtype.

Then the device-resident driver: two ranks of N/2 environments against one
process of N, on an environment that replays tables indexed by step and
global environment, with the same action noise and permutations fed; the
parameters and the running statistics agree across ranks bit for bit and
with the single process to fp32 summation order.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv as JaxEnv
from cusrl_tpu.nn.base import tree_paths
from cusrl_tpu.utils import misc as jax_misc
from cusrl_tpu.utils.config import CONFIG as JAX_CONFIG
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from tests.test_torch_distributed import launch

T, OBS, ACT = 8, 16, 4
OVERRIDES = dict(num_steps_per_update=T, actor_hidden_dims=(32, 16), critic_hidden_dims=(32, 16),
                 max_kl_divergence=1.0)
# (metrics, parameters, hook state), as tests/test_torch_update_zoo.py.
FP32_TOL = (dict(rtol=1e-5, atol=5e-6), dict(rtol=0, atol=2e-6), dict(rtol=1e-4, atol=1e-4))
BF16_TOL = (dict(rtol=1e-3, atol=1e-4), dict(rtol=0, atol=3e-3), dict(rtol=1e-3, atol=2e-3))
WORLDS = {2: dict(n_local=32, mini_batches=4), 3: dict(n_local=16, mini_batches=3)}
CASES = {"joint": (False, "split"), "fused_split": (True, "split"), "fused_mono": (True, "mono")}


_UPDATE_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed
configure_distributed("cpu", timeout_s=60)
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.nn.kernels import fused_ppo_step
from cusrl_tpu_torch.parallel import cross_process_update, distribute_agent
from cusrl_tpu_torch.template.logger import load_checkpoint_file, save_checkpoint_file
from cusrl_tpu_torch.utils.interop import load_jax_state, state_entries
from cusrl_tpu_torch.utils.nest import map_nested
from cusrl_tpu_torch.zoo.registry import get_experiment

case_dir = os.environ["CASE_DIR"]
data = pickle.loads(open(os.path.join(case_dir, "input.pkl"), "rb").read())
rank, n = torch.distributed.get_rank(), data["n_local"]
CONFIG.compute_dtype = None


def build(kwargs):
    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    for key, value in kwargs.items():
        setattr(factory, key, value)
    spec = VelocityLocomotionEnv(num_instances=n, observation_dim=data["obs"], action_dim=data["act"],
                                 device="cpu").spec
    return factory(spec, device="cpu", seed=100 + rank)  # each rank its own weights until the broadcast


def own(rollout):
    return map_nested(lambda a: torch.from_numpy(np.array(a[:, rank * n:(rank + 1) * n])), rollout)


def snapshot(agent):
    return {path: np.array(entry.read()) for path, entry in state_entries(agent).items()}


out = {}
for name, case in data["cases"].items():
    fused_ppo_step._PPO_MODE = case["mode"]
    agent = build(case["kwargs"])
    if rank == 0:
        load_jax_state(agent, case["state"])
    distribute_agent(agent)
    metrics = cross_process_update(agent, own(case["rollouts"][0]), epoch_perms=case["perms"][0])
    out[name] = {"metrics": metrics, "state": snapshot(agent)}
    if name == "joint":  # saved on rank 0, resumed on every rank into fresh agents
        path = os.path.join(case_dir, "ckpt.npz")
        if rank == 0:
            save_checkpoint_file(path, {"agent": agent.state_dict()})
        torch.distributed.barrier()
        resumed = build(case["kwargs"])
        resumed.load_state_dict(load_checkpoint_file(path)["agent"])
        distribute_agent(resumed)
        metrics = cross_process_update(resumed, own(case["rollouts"][1]), epoch_perms=case["perms"][1])
        out["resumed"] = {"metrics": metrics, "state": snapshot(resumed)}
open(os.path.join(case_dir, f"rank{rank}.pkl"), "wb").write(pickle.dumps(out))
torch.distributed.destroy_process_group()
"""


def _rollout(jax_agent, seed, n):
    rng = np.random.default_rng(seed)
    obs = np.tanh(rng.standard_normal((T, n, OBS))).astype(np.float32)
    next_obs = np.concatenate([obs[1:], np.tanh(rng.standard_normal((1, n, OBS)))], 0).astype(np.float32)
    dist, _, _ = jax_agent.state.actor(jnp.asarray(obs))
    action = dist["mean"] + dist["std"] * rng.standard_normal((T, n, ACT)).astype(np.float32)
    terminated = rng.random((T, n, 1)) < 0.05
    truncated = rng.random((T, n, 1)) < 0.05
    return {
        "observation": obs,
        "next_observation": next_obs,
        "action": np.asarray(action),
        "action_logp": np.asarray(jax_agent.state.actor.compute_logp(dist, action)),
        "action_dist": {"mean": np.asarray(dist["mean"]), "std": np.asarray(dist["std"])},
        "reward": rng.standard_normal((T, n, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": truncated,
        "done": terminated | truncated,
    }


def _hook_state(jax_agent, rng):
    """Non-trivial hook state on the JAX side (rank 0 loads it, the broadcast
    carries it to the others)."""
    for hook in jax_agent.state.hooks:
        if hook.hook_name == "observation_normalization":
            rms = hook.observation_rms.replace(mean=jnp.asarray(rng.standard_normal(OBS), jnp.float32),
                                               var=jnp.asarray(rng.random(OBS) + 0.5, jnp.float32),
                                               count=jnp.asarray(300.0, jnp.float32))
            jax_agent.update_hook(hook.hook_name, hook.replace(observation_rms=rms))
        elif hook.hook_name == "adaptive_l_r_schedule":
            jax_agent.update_hook(hook.hook_name, hook.replace(
                lr_scale=jnp.asarray(0.7, jnp.float32), accumulated_log_error=jnp.asarray(0.4, jnp.float32),
                error_count=jnp.asarray(2.0, jnp.float32)))


def _jax_case(kwargs, world, n_local, monkeypatch):
    """The JAX agent's initial state, each update's rollouts (every rank's,
    side by side), plans and results: one update, then (for the resume) a
    second from the first's state on new rollouts."""
    monkeypatch.setattr(JAX_CONFIG, "seed", 0)
    monkeypatch.setattr(jax_misc, "_KEY_COUNTER", [0])
    monkeypatch.setattr(JAX_CONFIG, "compute_dtype", None)
    factory = jax_get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    for key, value in kwargs.items():
        setattr(factory, key, value)
    jax_agent = factory(JaxEnv(num_instances=n_local, observation_dim=OBS, action_dim=ACT).spec)
    _hook_state(jax_agent, np.random.default_rng(3))
    state = jax_agent.state_dict()["agent_state"]
    update = jax.jit(jax_agent.update_body)
    rollouts, perms, results = [], [], []
    for index in range(2):
        parts = [_rollout(jax_agent, 11 + 10 * index + r, n_local) for r in range(world)]
        rollout = jax.tree.map(lambda *xs: np.concatenate(xs, axis=1), *parts)
        jax_rollout = jax.tree.map(jnp.asarray, rollout)
        key = jax.random.key(5 + index)
        _, plan, _ = jax_agent.sampler.make_epoch_plan(key, T, world * n_local, jax_rollout)
        new_state, metrics = update(jax_agent.state, jax_rollout, key)
        jax_agent.state = new_state
        rollouts.append(rollout)
        perms.append(np.array(plan))
        results.append(({k: float(v) for k, v in metrics.items()},
                        {p: np.asarray(v) for p, v in tree_paths(new_state) if p.startswith(("actor.", "critic.", "hooks."))}))
    return {"state": state, "rollouts": rollouts, "perms": perms}, results


def _port_single_process(inputs, kwargs, n_local):
    """The port's own update of one process on every rank's rollout."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.interop import load_jax_state, state_entries
    from cusrl_tpu_torch.utils.nest import map_nested
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    for key, value in kwargs.items():
        setattr(factory, key, value)
    agent = factory(VelocityLocomotionEnv(num_instances=n_local, observation_dim=OBS, action_dim=ACT,
                                          device="cpu").spec, device="cpu")
    load_jax_state(agent, inputs["state"])
    rollout = map_nested(lambda a: torch.from_numpy(np.array(a)), inputs["rollouts"][0])
    metrics = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=inputs["perms"][0]).items()}
    return metrics, {path: np.array(entry.read()) for path, entry in state_entries(agent).items()}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def distributed_run(request, tmp_path_factory):
    from cusrl_tpu_torch.utils.config import CONFIG

    world = request.param
    n_local, mini_batches = WORLDS[world]["n_local"], WORLDS[world]["mini_batches"]
    cases, oracle, single = {}, {}, {}
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(CONFIG, "compute_dtype", None)
        for name, (fused, mode) in CASES.items():
            kwargs = {**OVERRIDES, "sampler_mini_batches": mini_batches, "fused_ppo_update": fused}
            if fused and mode == "mono":  # the same updates as split on the CPU
                cases[name] = {**cases["fused_split"], "kwargs": kwargs, "mode": mode}
                oracle[name], single[name] = oracle["fused_split"], single["fused_split"]
                continue
            inputs, results = _jax_case(kwargs, world, n_local, monkeypatch)
            cases[name] = {**inputs, "kwargs": kwargs, "mode": mode}
            oracle[name] = results[0]
            if name == "joint":
                oracle["resumed"] = results[1]
            else:
                single[name] = _port_single_process(inputs, kwargs, n_local)
    case_dir = tmp_path_factory.mktemp(f"dp{world}")
    (case_dir / "input.pkl").write_bytes(pickle.dumps({"n_local": n_local, "obs": OBS, "act": ACT, "cases": cases}))
    return world, launch(_UPDATE_WORKER, world, case_dir), oracle, single


def _compare_with_jax(result, oracle, tol, hook_state=True):
    metric_tol, param_tol, state_tol = tol
    jax_metrics, jax_state = oracle
    assert set(result["metrics"]) == set(jax_metrics)
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(result["metrics"][key], value, err_msg=key, **metric_tol)
    state = result["state"]
    params = {p for p in state if p.startswith(("actor.", "critic."))}
    assert params == {p for p in jax_state if not p.startswith("hooks.")}
    for path in params:
        np.testing.assert_allclose(state[path], jax_state[path], err_msg=path, **param_tol)
    if not hook_state:
        return
    hooks = [p for p in jax_state if p.startswith("hooks.") and p in state]
    assert any(p.endswith("observation_rms.mean") for p in hooks) and any(p.endswith("lr_scale") for p in hooks)
    for path in hooks:
        np.testing.assert_allclose(np.asarray(state[path], np.float32), np.asarray(jax_state[path], np.float32),
                                   err_msg=path, **state_tol)


def _ranks_equal(results, name):
    first = results[0][name]
    for rank, result in enumerate(results[1:], 1):
        assert result[name]["metrics"] == first["metrics"], f"rank {rank} metrics"
        assert set(result[name]["state"]) == set(first["state"])
        for path, value in first["state"].items():
            np.testing.assert_array_equal(result[name]["state"][path], value, err_msg=f"rank {rank}: {path}")


@pytest.mark.parametrize("name", ["joint", "fused_split", "fused_mono", "resumed"])
def test_ranks_end_bit_for_bit_equal(distributed_run, name):
    """Parameters, optimizer moments and counts, learning rates, the
    normalizer's statistics and the schedule's state: the same bits on every
    rank after the update."""
    _, results, _, _ = distributed_run
    _ranks_equal(results, name)


@pytest.mark.parametrize("name", ["joint", "resumed"])
def test_update_matches_the_jax_single_process_update(distributed_run, name):
    """``resumed``: a checkpoint of the first update saved on rank 0, loaded
    by fresh agents on every rank, then a second update, against the JAX
    agent's second update from its first."""
    _, results, oracle, _ = distributed_run
    _compare_with_jax(results[0][name], oracle[name], FP32_TOL)
    assert results[0][name]["metrics"]["update_rejected"] == 0.0


@pytest.mark.parametrize("name", ["fused_split", "fused_mono"])
def test_fused_update_matches_the_single_process_update(distributed_run, name):
    """The fused PPO update (each rank's loss and gradient normalized by its
    own rows, combined by row share) against the port's single-process fused
    update on every rank's rollout: metrics, parameters, optimizer state and
    hook state; and against the JAX update on metrics and parameters.  Its
    chains are bf16 whatever the compute dtype, and a bf16 product rounds
    differently over a rank's rows than over all of them, so both are held
    to the bf16 tolerances.  The JAX reference's chains also round
    differently from the port's: on this data the single-process port itself
    reads the schedule's log-KL accumulator 3.0e-3 from the JAX package's (a
    KL 0.3 % apart), so the hook state is held to the port's single process,
    not to JAX."""
    _, results, oracle, single = distributed_run
    result, (metrics, state) = results[0][name], single[name]
    metric_tol, param_tol, state_tol = BF16_TOL
    assert set(result["metrics"]) == set(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(result["metrics"][key], value, err_msg=key, **metric_tol)
    assert set(result["state"]) == set(state)
    for path, value in state.items():
        tol = param_tol if path.startswith(("actor.", "critic.", "opt_state.")) else state_tol
        np.testing.assert_allclose(np.asarray(result["state"][path], np.float64), np.asarray(value, np.float64),
                                   err_msg=path, **tol)
    _compare_with_jax(result, oracle[name], BF16_TOL, hook_state=False)


_DRIVER_COMMON = r"""
import numpy as np
import torch
from cusrl_tpu_torch.template.environment import EnvironmentSpec, TensorEnvironment
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.interop import state_entries
from cusrl_tpu_torch.zoo.registry import get_experiment

STEPS, ENVS, OBS, ACT, ITERATIONS = 8, 32, 16, 4, 2


class TableEnv(TensorEnvironment):
    # Observations, rewards and episode ends read from tables by step and
    # global environment: a slice of the environments replays the same rows.
    def __init__(self, first, count):
        super().__init__(EnvironmentSpec(observation_dim=OBS, action_dim=ACT, num_instances=count))
        rng = np.random.default_rng(7)
        rows = ITERATIONS * STEPS + 1
        cut = slice(first, first + count)
        self.obs = torch.from_numpy(rng.standard_normal((rows, ENVS, OBS)).astype(np.float32) * 3 + 1)[:, cut]
        self.reward = torch.from_numpy(rng.standard_normal((rows, ENVS, 1)).astype(np.float32))[:, cut]
        self.terminated = torch.from_numpy(rng.random((rows, ENVS, 1)) < 0.1)[:, cut]
        self.truncated = torch.from_numpy(rng.random((rows, ENVS, 1)) < 0.05)[:, cut]
        self.noise = torch.from_numpy(rng.standard_normal((rows, ENVS, ACT)).astype(np.float32))[:, cut]
        self.perms = [np.stack([rng.permutation(STEPS * ENVS) for _ in range(5)]) for _ in range(ITERATIONS)]

    def init_fn(self, generator):
        return 0

    def observe_fn(self, t):
        return self.obs[t], None

    def step_fn(self, t, action, generator):
        reward = self.reward[t] + 0.1 * torch.tanh(action).sum(-1, keepdim=True)
        return t + 1, reward, self.terminated[t], self.truncated[t], {}


def train(first, count, seed, distribute=None):
    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    factory.num_steps_per_update, factory.actor_hidden_dims, factory.critic_hidden_dims = STEPS, (32, 16), (32, 16)
    env = TableEnv(first, count)
    agent = factory(env.spec, device="cpu", seed=seed)
    if distribute is not None:
        distribute(agent)
    act_body, update_body, steps, updates = agent.act_body, agent.update_body, iter(env.noise), iter(env.perms)
    agent.act_body = lambda observation, noise=None, state=None: act_body(observation, next(steps), state)
    agent.update_body = lambda rollout: update_body(rollout, epoch_perms=next(updates))
    driver = RolloutDriver(agent, env)
    aggregates = [driver.collect_and_update(STEPS)[0].tolist() for _ in range(ITERATIONS)]
    state = {path: np.array(entry.read()) for path, entry in state_entries(agent).items()}
    return {"state": state, "aggregates": aggregates}
"""

_DRIVER_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed
configure_distributed("cpu", timeout_s=60)
CONFIG.compute_dtype = None
from cusrl_tpu_torch.parallel import distribute_agent
""" + _DRIVER_COMMON + r"""
rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
result = train(rank * ENVS // world, ENVS // world, seed=rank, distribute=distribute_agent)
open(os.path.join(os.environ["CASE_DIR"], f"rank{rank}.pkl"), "wb").write(pickle.dumps(result))
torch.distributed.destroy_process_group()
"""


def test_device_resident_driver_on_two_ranks_matches_one_process(tmp_path, monkeypatch):
    """Two ranks of 16 environments through ``RolloutDriver`` against one
    process of 32 (two iterations): observation statistics folded from every
    rank's rows at each step, the global update, episode aggregates averaged
    across ranks.  The environment's per-environment flags (``last_done``)
    stay the rank's own."""
    from cusrl_tpu_torch.utils.config import CONFIG

    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    namespace = {}
    exec(compile(_DRIVER_COMMON, "driver_common", "exec"), namespace)
    single = namespace["train"](0, namespace["ENVS"], seed=0)
    ranks = launch(_DRIVER_WORKER, 2, tmp_path)
    per_env = ("last_done",)
    for path, value in ranks[0]["state"].items():
        if not path.endswith(per_env):
            np.testing.assert_array_equal(ranks[1]["state"][path], value, err_msg=path)
    assert ranks[0]["aggregates"] == ranks[1]["aggregates"]
    for path, value in single["state"].items():
        if path.endswith(per_env):
            np.testing.assert_array_equal(np.concatenate([r["state"][path] for r in ranks]), value)
        elif path.endswith(("rms.mean", "rms.var", "rms.count")):
            np.testing.assert_allclose(ranks[0]["state"][path], value, rtol=1e-5, atol=1e-6, err_msg=path)
        elif path.startswith(("actor.", "critic.")):
            np.testing.assert_allclose(ranks[0]["state"][path], value, rtol=0, atol=2e-6, err_msg=path)
    # Averaged aggregates: the episode count and sums are the single process's over 2.
    np.testing.assert_allclose(np.array(ranks[0]["aggregates"]) * 2, np.array(single["aggregates"]), rtol=1e-5)

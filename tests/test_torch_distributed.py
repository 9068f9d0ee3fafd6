"""The port's process topology and distributed helpers on real gloo ranks
(counterparts of ``tests/test_multihost.py``'s bootstrap and of the JAX
package's ``utils/distributed.py`` and ``configure_distributed``).

Two subprocess ranks join a gloo group from torchrun's variables (a free
port, a process-group timeout, a hard ``communicate`` timeout) and check the
ten host helpers, the device collectives of a data-parallel agent, the
rank-0-only run directory, the ``seed + rank`` seeding, the CLI's
independent copies (the JAX CLI never calls ``distribute_agent``), a global
update on each route that once raised under more than one rank, and
tensor parallelism on the two ranks (only a mesh that does not divide the
processes raises).  In this process:
``configure_distributed`` without the variables, the device it picks, and a
group of one leaving the update bit for bit.  Last, ``torchrun`` launching
the CLI on two CPU ranks.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cusrl_tpu_torch.utils import config as config_module
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed, resolve_device

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 150
SHRINK = ["--environment_kwargs.num_instances", "16", "--agent.actor_hidden_dims", "(16, 16)",
          "--agent.critic_hidden_dims", "(16, 16)", "--agent.num_steps_per_update", "8"]
TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(script: str, world: int, case_dir: Path):
    """Starts ``script`` on ``world`` gloo ranks (torchrun's variables, a
    free port); returns the function that waits for them and returns each
    rank's pickled ``rank<r>.pkl`` from ``case_dir``.  A rank that fails or
    overruns fails the test, and every rank is killed on the way out."""
    env = {**os.environ, "REPO_ROOT": str(ROOT), "CASE_DIR": str(case_dir), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]

    def wait() -> list:
        errors = []
        try:
            for rank, proc in enumerate(procs):
                _, err = proc.communicate(timeout=TIMEOUT)
                if proc.returncode:
                    errors.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        assert not errors, "\n".join(errors)
        return [pickle.loads((case_dir / f"rank{r}.pkl").read_bytes()) for r in range(world)]

    return wait


def launch(script: str, world: int, case_dir: Path) -> list:
    """``start`` and wait: each rank's pickled result."""
    return start(script, world, case_dir)()


_WORKER = r"""
import contextlib, io, os, pickle, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed, resolve_device
joined = configure_distributed("cpu", timeout_s=60)
from cusrl_tpu_torch.__main__ import main
from cusrl_tpu_torch.logger import Jsonl
from cusrl_tpu_torch.nn.utils.normalization import mean_var_count
from cusrl_tpu_torch.parallel import cross_process_update, distribute_agent, get_mesh, replicate, shard_batch
from cusrl_tpu_torch.sampler import TemporalMiniBatchSampler
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.misc import set_global_seed
from cusrl_tpu_torch.zoo.registry import get_experiment

case_dir = os.environ["CASE_DIR"]
rank = distributed.rank()
group = torch.distributed.group.WORLD
out = {"joined": joined, "backend": torch.distributed.get_backend(), "device": str(resolve_device("cpu")),
       "enabled": distributed.enabled(), "rank": rank, "world": distributed.world_size(),
       "config": (CONFIG.rank, CONFIG.world_size, CONFIG.local_rank, CONFIG.is_main_process),
       "is_main": distributed.is_main_process()}
distributed.barrier()
out["gathered"] = distributed.gather_obj(f"proc{rank}")
out["bcast"] = distributed.broadcast_obj("root-value" if rank == 0 else None)
out["avg"] = distributed.average_dict({"x": float(rank), "y": 10.0 * (rank + 1), **({"late": 4.0} if rank else {})})
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    distributed.print_rank0("only rank 0")
    distributed.gather_print("every rank")
out["printed"] = printed.getvalue()
out["process_seed"] = (set_global_seed(5), CONFIG.seed, CONFIG.process_seed, float(torch.rand(())))

# The device collectives of a data-parallel agent.
out["gather"] = distributed.gather(torch.tensor([rank, rank + 0.5]), group).tolist()
out["gather_bool"] = distributed.gather(torch.tensor([rank == 1, True]), group).tolist()
out["weighted_sum"] = distributed.weighted_sum(torch.tensor([2.0 * (rank + 1)]), 0.25, group).tolist()
data = [torch.randn(5 + 3 * r, 3, generator=torch.Generator().manual_seed(r)) * (r + 1) + r for r in range(2)]
mask = data[rank][:, 0] > -0.5
out["merged"] = [t.tolist() for t in distributed.merge_moments(*mean_var_count(data[rank], mask=mask), group)]
out["pooled"] = [t.tolist() for t in mean_var_count(torch.cat([d[d[:, 0] > -0.5] for d in data]))]
param = torch.nn.Parameter(torch.zeros(3))
param.grad = torch.full((3,), float(rank + 1))
distributed.reduce_gradients([param], [0.75, 0.25][rank], group)
out["reduced_grad"] = param.grad.tolist()
out["replicated"] = replicate({"w": torch.full((2,), float(rank))}, group)["w"].tolist()
out["shard"] = shard_batch({"x": torch.arange(5)}, group)["x"].tolist()
out["collectives"] = {k: list(v) for k, v in distributed.COLLECTIVES.items()}

# The run directory: rank 0's name everywhere, files from rank 0 only.
logs = os.path.join(case_dir, "logs")
logger = Jsonl(log_dir=logs, name="mh", add_timestamp=rank == 0)  # rank 1's own name would differ
logger.log_scalars({"value": float(rank)}, 0)
saved = logger.save_checkpoint({"x": {"a": np.zeros(1)}}, 1)
logger.close()
distributed.barrier()
out["log_dir"], out["saved"] = logger.log_dir, saved

# The CLI trains an independent copy on each rank (it never distributes the agent).
trainer = main(["train", "-env", "Velocity-Flat", "-alg", "ppo", "--device", "cpu", "--num-iterations", "2",
                "--logger", "jsonl", "--seed", "3", "--log-dir", os.path.join(case_dir, "cli"), "--quiet", "--",
                *os.environ["SHRINK"].split("|")])
out["cli_group"] = trainer.agent.process_group is None
out["cli_weight"] = trainer.agent.model["actor"].backbone.layers[0].weight.detach().sum().item()


def raises(fn, kind=NotImplementedError):
    try:
        fn()
    except kind as error:
        return str(error)
    return None


def spec_of(name, algorithm, envs=8):
    factory = get_experiment(name, algorithm).to_training_factory()
    return factory, factory.environment_factory(**{**factory.environment_kwargs, "num_instances": envs,
                                                   "device": "cpu"})


def drive(agent, env, mode, steps=4, data_rank=None):
    # ``steps`` host-loop steps on the data rank's own random data (by default
    # this rank's), then one global update.
    rng = np.random.default_rng(10 + (rank if data_rank is None else data_rank))
    n = env.spec.num_instances
    for _ in range(steps):
        agent.act(rng.standard_normal((n, env.spec.observation_dim)).astype(np.float32))
        agent.step(rng.standard_normal((n, env.spec.observation_dim)).astype(np.float32),
                   rng.standard_normal((n, 1)).astype(np.float32), rng.random((n, 1)) < 0.1,
                   np.zeros((n, 1), bool))
    if mode == "update":
        metrics = agent.update()
    elif mode == "buffer":
        metrics = cross_process_update(agent)
    else:
        metrics = cross_process_update(agent, agent.take_buffered_rollout()[0])
    params = {path: p.detach().numpy().copy() for path, p in agent.model.named_parameters()}
    return {"metrics": metrics, "params": params}


routes = {}
factory, env = spec_of("Velocity-Flat", "transformer_ppo")
for key, value in dict(embed_dim=16, num_heads=2, attention_window=4, mlp_hidden_dims=(16,),
                       num_steps_per_update=4).items():
    setattr(factory.agent, key, value)
agent = factory.agent(env.spec, device="cpu", seed=rank)
distribute_agent(agent)
routes["transformer"] = drive(agent, env, "rollout")
factory, env = spec_of("Velocity-Flat", "recurrent_ppo")
factory.agent.rnn_hidden_size, factory.agent.mlp_hidden_dims, factory.agent.num_steps_per_update = 16, (16,), 4
agent = factory.agent(env.spec, device="cpu", seed=rank)
distribute_agent(agent)
routes["recurrent"] = drive(agent, env, "rollout")
factory, env = spec_of("Velocity-Flat", "amp")
for key in ("actor_hidden_dims", "critic_hidden_dims", "amp_discriminator_hidden_dims"):
    setattr(factory.agent, key, (16,))
factory.agent.num_steps_per_update = 4
agent = factory.agent(env.spec, device="cpu", seed=rank)
distribute_agent(agent)
routes["amp"] = drive(agent, env, "rollout")
factory, env = spec_of("Velocity-Flat", "ppo")
factory.agent.actor_hidden_dims = factory.agent.critic_hidden_dims = (16,)
factory.agent.num_steps_per_update = 4
for route, mode in (("host_update", "update"), ("host_buffer", "buffer")):
    agent = factory.agent(env.spec, device="cpu", seed=rank)
    distribute_agent(agent)
    routes[route] = drive(agent, env, mode)
temporal = factory.agent.to_underlying()
temporal.sampler = TemporalMiniBatchSampler(num_epochs=2, num_mini_batches=2)
agent = temporal(env.spec, device="cpu", seed=rank)
distribute_agent(agent)
routes["temporal_rollout"] = drive(agent, env, "rollout")
tensor_parallel = temporal(env.spec, device="cpu", seed=rank)
distribute_agent(tensor_parallel, get_mesh(model_parallel_size=2), tensor_parallel=True)
out["tensor_parallel"] = {"route": drive(tensor_parallel, env, "rollout", data_rank=0),
                          "indivisible": raises(lambda: get_mesh(model_parallel_size=3), ValueError)}
out["routes"] = routes
open(os.path.join(case_dir, f"rank{rank}.pkl"), "wb").write(pickle.dumps(out))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("ranks")
    os.environ["SHRINK"] = "|".join(SHRINK)
    try:
        return case_dir, launch(_WORKER, 2, case_dir)
    finally:
        del os.environ["SHRINK"]


def test_ranks_join_the_group_from_the_torchrun_variables(two_ranks):
    _, results = two_ranks
    for rank, result in enumerate(results):
        assert result["joined"] and result["backend"] == "gloo" and result["device"] == "cpu"
        assert result["enabled"] and result["rank"] == rank and result["world"] == 2
        assert result["config"] == (rank, 2, rank, rank == 0) and result["is_main"] == (rank == 0)


def test_object_helpers(two_ranks):
    _, results = two_ranks
    for result in results:
        assert result["gathered"] == ["proc0", "proc1"]
        assert result["bcast"] == "root-value"
        # Each key over the ranks that hold it.
        assert result["avg"] == {"x": 0.5, "y": 15.0, "late": 4.0}


def test_rank0_printing_and_rank_ordered_printing(two_ranks):
    _, results = two_ranks
    assert results[0]["printed"] == "only rank 0\n[rank 0] every rank\n"
    assert results[1]["printed"] == "[rank 1] every rank\n"


def test_seeding_is_seed_plus_rank(two_ranks):
    _, results = two_ranks
    draws = []
    for rank, result in enumerate(results):
        process_seed, seed, config_seed, draw = result["process_seed"]
        assert (process_seed, seed, config_seed) == (5 + rank, 5, 5 + rank)
        draws.append(draw)
    assert draws[0] == float(torch.rand((), generator=torch.Generator().manual_seed(5))) != draws[1]


def test_device_collectives(two_ranks):
    _, results = two_ranks
    for result in results:
        assert result["gather"] == [[0.0, 0.5], [1.0, 1.5]]
        assert result["gather_bool"] == [[False, True], [True, True]]
        assert result["weighted_sum"] == [0.25 * 2.0 + 0.25 * 4.0]
        np.testing.assert_allclose(np.concatenate([np.ravel(t) for t in result["merged"]]),
                                   np.concatenate([np.ravel(t) for t in result["pooled"]]), rtol=1e-5, atol=1e-6)
        assert result["reduced_grad"] == [0.75 * 1 + 0.25 * 2] * 3
        assert result["replicated"] == [0.0, 0.0]
        assert result["collectives"]["all_gather"][0] == 3  # gather (bool gathers as uint8), merge_moments
        assert result["collectives"]["all_reduce"][0] == 2  # weighted_sum, reduce_gradients
    assert [r["shard"] for r in results] == [[0, 1, 2], [3, 4]]
    assert results[0]["merged"] == results[1]["merged"]


def test_run_directory_is_rank0s(two_ranks):
    case_dir, results = two_ranks
    assert results[0]["log_dir"] == results[1]["log_dir"]
    assert results[0]["saved"] == results[1]["saved"]
    runs = sorted(p.name for p in (case_dir / "logs").iterdir() if p.name != "latest")
    assert len(runs) == 1 and runs[0].endswith("_mh")
    run = case_dir / "logs" / runs[0]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["ckpt_1.npz"]
    assert [json.loads(line)["value"] for line in open(run / "metrics.jsonl")] == [0.0]


def test_cli_trains_an_independent_copy_on_each_rank(two_ranks):
    """As in the JAX package, the CLI does not call ``distribute_agent``:
    each rank's agent keeps its own weights (seed + rank) and trains alone,
    while the run directory is rank 0's and the logs are averaged."""
    case_dir, results = two_ranks
    assert results[0]["cli_group"] and results[1]["cli_group"]
    assert results[0]["cli_weight"] != results[1]["cli_weight"]
    runs = [p for p in (case_dir / "cli").iterdir() if p.name != "latest"]
    assert len(runs) == 1
    rows = [json.loads(line) for line in open(runs[0] / "metrics.jsonl")]
    assert [row["Perf/environment_step"] for row in rows] == [8 * 16 * 2, 2 * 8 * 16 * 2]


@pytest.mark.parametrize("route", ["transformer", "recurrent", "amp", "host_update", "host_buffer",
                                   "temporal_rollout"])
def test_routes_run_under_two_ranks(two_ranks, route):
    """Each route once raised under more than one rank; now a few host-loop
    steps on each rank's own data and one global update (on a rollout the
    agent took from its buffer, in ``agent.update()``, or in
    ``cross_process_update(agent)`` on the buffer) give finite metrics and
    the same metrics and parameters, bit for bit, on both ranks.  Their
    updates are held against JAX in ``tests/test_torch_distributed_routes.py``."""
    _, results = two_ranks
    first, second = (result["routes"][route] for result in results)
    assert first["metrics"] and all(np.isfinite(value) for value in first["metrics"].values())
    assert first["metrics"] == second["metrics"]
    assert set(first["params"]) == set(second["params"])
    for path, value in first["params"].items():
        np.testing.assert_array_equal(second["params"][path], value, err_msg=path)


def test_tensor_parallelism_still_raises(two_ranks):
    """Tensor parallelism once raised; now the temporal route trains on a
    1 x 2 mesh (its Mlps sharded over the two ranks: the same metrics, each
    rank half of every sharded leaf and the same bits of every whole one),
    and only a mesh that does not divide the processes raises, with JAX's
    message."""
    _, results = two_ranks
    first, second = (result["tensor_parallel"]["route"] for result in results)
    assert first["metrics"] and all(np.isfinite(value) for value in first["metrics"].values())
    assert first["metrics"] == second["metrics"]
    differ = [path for path, value in first["params"].items() if not np.array_equal(value, second["params"][path])]
    assert "actor.backbone.layers.0.weight" in differ and "actor.distribution.mean_head.weight" not in differ
    for path in differ:
        assert first["params"][path].shape == second["params"][path].shape
    assert first["params"]["actor.backbone.layers.0.weight"].shape[0] == 8  # half of the 16 hidden units
    for result in results:
        assert "not divisible by model_parallel_size=3" in result["tensor_parallel"]["indivisible"]


def test_configure_distributed_without_the_variables_is_a_no_op(monkeypatch):
    for name in TORCHRUN_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    assert not configure_distributed("cpu") and not dist.is_initialized()
    assert (CONFIG.rank, CONFIG.world_size, CONFIG.local_rank, CONFIG.is_main_process) == (0, 1, 0, True)
    monkeypatch.setattr(CONFIG, "seed", 7)
    assert CONFIG.process_seed == 7
    assert resolve_device("cpu") == torch.device("cpu")


def test_configure_distributed_picks_nccl_and_the_local_card(monkeypatch):
    """On the card: NCCL, ``cuda:LOCAL_RANK`` current, an explicit timeout;
    ``--device cuda`` then resolves to ``cuda:LOCAL_RANK``.  (No card here:
    CUDA's presence and the group's start are stood in for.)"""
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: calls.setdefault("device", index))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kwargs: calls.update(backend=backend, **kwargs))
    assert configure_distributed()
    assert calls["device"] == 1 and calls["backend"] == "nccl"
    assert (calls["rank"], calls["world_size"], calls["timeout"].total_seconds()) == (3, 4, 300.0)
    assert configure_distributed("cpu", backend="gloo", timeout_s=30) and calls["backend"] == "gloo"
    monkeypatch.setattr(config_module, "_initialized", lambda: True)
    assert resolve_device("cuda") == torch.device("cuda", 1) and resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)


def test_configure_distributed_without_a_card_raises(monkeypatch):
    for name, value in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        configure_distributed("cuda")
    assert not dist.is_initialized()


def _small_agent(seed):
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    factory.num_steps_per_update, factory.actor_hidden_dims, factory.critic_hidden_dims = 8, (32, 16), (32, 16)
    env = VelocityLocomotionEnv(num_instances=32, observation_dim=16, action_dim=4, device="cpu")
    return factory(env.spec, device="cpu", seed=seed), env


def test_a_group_of_one_leaves_the_update_bit_for_bit(monkeypatch):
    """An agent without a group runs no collective; one distributed over a
    gloo group of one runs them (the identity), and both end with the same
    bits after a rollout and an update through the driver: metrics,
    parameters, optimizer state and hook state."""
    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.template.rollout import RolloutDriver
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.interop import state_entries

    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    perms = np.stack([np.random.default_rng(e).permutation(8 * 32) for e in range(5)])

    def run(distribute):
        agent, env = _small_agent(seed=0)
        if distribute:
            distribute_agent(agent)
        update_body = agent.update_body
        agent.update_body = lambda rollout: update_body(rollout, epoch_perms=perms)
        distributed.reset_collective_counts()
        aggregates, metrics = RolloutDriver(agent, env).collect_and_update(8)
        counts = {k: v[0] for k, v in distributed.COLLECTIVES.items()}
        state = {p: np.array(e.read()) for p, e in state_entries(agent).items()}
        return aggregates.tolist(), {k: float(v) for k, v in metrics.items()}, state, counts

    plain = run(False)
    assert plain[3] == {"all_reduce": 0, "all_gather": 0}
    for name, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(name, value)
    assert configure_distributed("cpu", timeout_s=60)
    try:
        grouped = run(True)
    finally:
        dist.destroy_process_group()
    assert grouped[3]["all_reduce"] > 20 and grouped[3]["all_gather"] > 16  # every minibatch, every fold
    assert grouped[0] == plain[0] and grouped[1] == plain[1]
    assert set(grouped[2]) == set(plain[2])
    for path, value in plain[2].items():
        np.testing.assert_array_equal(grouped[2][path], value, err_msg=path)


def test_torchrun_launches_the_cli_on_two_cpu_ranks(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    cusrl_tpu_torch train ... --device cpu`` at a shrunk size: exit 0, one
    run directory (rank 0's), its jsonl lines counting env-steps x 2."""
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m",
           "cusrl_tpu_torch", "train", "-env", "Velocity-Flat", "-alg", "ppo", "--device", "cpu",
           "--num-iterations", "3", "--logger", "jsonl", "--seed", "0", "--log-dir", str(logs), "--", *SHRINK]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = [p for p in logs.iterdir() if p.name != "latest"]
    assert len(runs) == 1 and os.path.realpath(logs / "latest") == str(runs[0])
    rows = [json.loads(line) for line in open(runs[0] / "metrics.jsonl")]
    assert [row["iteration"] for row in rows] == [0, 1, 2]
    assert [row["Perf/environment_step"] for row in rows] == [(i + 1) * 8 * 16 * 2 for i in range(3)]
    assert sorted(p.name for p in (runs[0] / "ckpt").iterdir()) == ["ckpt_3.npz"]
    assert proc.stdout.count("iter     3/3") == 1  # rank 0 prints

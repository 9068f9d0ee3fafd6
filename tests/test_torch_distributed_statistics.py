"""Rollout-time statistics under data parallelism: the port against the JAX
package's multi-process run (a JAX quirk the port does not follow).

AMP's ``transition_rms`` folds every step's agent and expert transitions in
``post_step``, during the rollout.  In the JAX package's env-sharded
multi-process run (``tests/test_multihost.py``'s topology: each process
collects its own environments with ``ScanRolloutDriver``, then
``cross_process_update`` joins the rollouts) ``post_step`` runs on the
process's own environments, so each process folds only its own rows: after
``T`` steps of ``N`` environments its count is ``2 T N`` and its moments its
own, where one process of every environment counts ``2 T W N``.  The port
follows the single process: each fold merges every rank's rows
(``utils.distributed.merge_moments``), as its observation statistics do, so
the ranks hold the same statistics, those of one process of all their
environments.  Two JAX processes (``jax.distributed``) and two gloo ranks of
the port run side by side.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

from cusrl_tpu_torch.utils.config import CONFIG
from tests.test_torch_distributed import ROOT, TIMEOUT, _free_port, start

T, N, OBS, ACT, STATE = 4, 8, 12, 3, 6
SMALL = dict(num_steps_per_update=T, actor_hidden_dims=(16,), critic_hidden_dims=(16,),
             amp_discriminator_hidden_dims=(16,), amp_state_indices=tuple(range(STATE)), amp_batch_size=16)


def _dataset():
    return np.random.default_rng(0).standard_normal((256, 2 * STATE)).astype(np.float32)


_JAX_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from cusrl_tpu.utils import distributed
from cusrl_tpu.utils.config import configure_distributed
configure_distributed(timeout_s=60)
from cusrl_tpu.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu.parallel.multiprocess import broadcast_agent_state
from cusrl_tpu.template.rollout import ScanRolloutDriver
from cusrl_tpu.zoo.registry import get_experiment

rank = distributed.rank()
factory = get_experiment("Velocity-Flat", "amp").make_agent_factory()
for key, value in {**json.loads(os.environ["SMALL"]), "amp_dataset_source": np.random.default_rng(0).standard_normal(
        (256, 2 * int(os.environ["STATE"]))).astype(np.float32)}.items():
    setattr(factory, key, tuple(value) if isinstance(value, list) else value)
env = VelocityLocomotionEnv(num_instances=int(os.environ["N"]), observation_dim=int(os.environ["OBS"]),
                            action_dim=int(os.environ["ACT"]), seed=100 + rank)
agent = factory(env.spec)
broadcast_agent_state(agent)
ScanRolloutDriver(agent, env, packed=False).collect(int(os.environ["T"]))
rms = agent.get_hook("adversarial_motion_prior").transition_rms
print("RESULT " + json.dumps({"rank": rank, "count": float(rms.count), "mean": np.asarray(rms.mean).tolist()}))
"""

_PORT_COMMON = r"""
import numpy as np
import torch
from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
from cusrl_tpu_torch.zoo.registry import get_experiment


def amp_agent(envs, small, dataset, seed):
    factory = get_experiment("Velocity-Flat", "amp").make_agent_factory()
    for key, value in {**small, "amp_dataset_source": dataset}.items():
        setattr(factory, key, value)
    spec = VelocityLocomotionEnv(num_instances=envs, observation_dim=OBS, action_dim=ACT, device="cpu").spec
    return factory(spec, device="cpu", seed=seed)


def steps(agent, table, draws, rows):
    # AMP's post_step on the table's rows (observations, rewards), the expert rows fed.
    hook = agent.get_hook("adversarial_motion_prior")
    hook.queue_draws(expert=draws)
    for t in range(len(draws)):
        hook.post_step(agent, {"observation": table["obs"][t, rows], "next_observation": table["obs"][t + 1, rows],
                               "reward": table["reward"][t, rows]})
    rms = hook.transition_rms
    return {"mean": rms.mean.numpy().copy(), "var": rms.var.numpy().copy(), "count": float(rms.count)}
"""

_PORT_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch
torch.set_num_threads(1)
from cusrl_tpu_torch.utils.config import CONFIG, configure_distributed
configure_distributed("cpu", timeout_s=60)
CONFIG.compute_dtype = None
from cusrl_tpu_torch.parallel import distribute_agent
data = pickle.loads(open(os.path.join(os.environ["CASE_DIR"], "input.pkl"), "rb").read())
OBS, ACT = data["obs"], data["act"]
""" + _PORT_COMMON + r"""
rank = torch.distributed.get_rank()
agent = amp_agent(data["n"], data["small"], data["dataset"], seed=rank)
distribute_agent(agent)
result = steps(agent, data["table"], data["draws"], slice(rank * data["n"], (rank + 1) * data["n"]))
open(os.path.join(os.environ["CASE_DIR"], f"rank{rank}.pkl"), "wb").write(pickle.dumps(result))
torch.distributed.destroy_process_group()
"""


def test_amp_transition_statistics_are_global_in_the_port_and_process_local_in_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(CONFIG, "compute_dtype", None)
    rng = np.random.default_rng(4)
    table = {"obs": torch.from_numpy(np.tanh(rng.standard_normal((T + 1, 2 * N, OBS))).astype(np.float32)),
             "reward": torch.from_numpy(rng.standard_normal((T, 2 * N, 1)).astype(np.float32))}
    draws = [torch.from_numpy(rng.integers(0, 256, 2 * N)) for _ in range(T)]  # every environment's expert row
    (tmp_path / "input.pkl").write_bytes(pickle.dumps({"n": N, "obs": OBS, "act": ACT, "small": SMALL,
                                                       "dataset": _dataset(), "table": table, "draws": draws}))
    port_ranks = start(_PORT_WORKER, 2, tmp_path)
    env = {**os.environ, "REPO_ROOT": str(ROOT), "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "JAX_NUM_PROCESSES": "2", "JAX_PLATFORMS": "cpu", "SMALL": json.dumps(SMALL), "T": str(T), "N": str(N),
           "OBS": str(OBS), "ACT": str(ACT), "STATE": str(STATE)}
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_WORKER], env={**env, "JAX_PROCESS_ID": str(rank)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    namespace = {"OBS": OBS, "ACT": ACT}
    exec(compile(_PORT_COMMON, "port_common", "exec"), namespace)
    single = namespace["steps"](namespace["amp_agent"](2 * N, SMALL, _dataset(), seed=0), table, draws, slice(None))
    jax_results = {}
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, f"JAX process {rank} failed:\n{err[-3000:]}"
            jax_results[rank] = json.loads([line for line in out.splitlines() if line.startswith("RESULT ")][-1][7:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = port_ranks()
    # The port: every rank holds one process's statistics of both ranks' environments.
    assert single["count"] == 2 * T * 2 * N
    for result in ranks:
        assert result["count"] == single["count"]
        for key in ("mean", "var"):
            np.testing.assert_array_equal(result[key], ranks[0][key])
            np.testing.assert_allclose(result[key], single[key], rtol=1e-5, atol=1e-6, err_msg=key)
    # JAX: each process folded its own environments' rows only.
    for rank in range(2):
        assert jax_results[rank]["count"] == 2 * T * N
    assert not np.allclose(jax_results[0]["mean"], jax_results[1]["mean"])

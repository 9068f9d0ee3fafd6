"""Training orchestrator (counterpart of ``cusrl_tpu/template/trainer.py``).

Two drivers behind one Trainer, as in the JAX package:

* **Host driver**, for an ``Environment`` (gym adapters, the native
  CartPole, ``DummyEnvironment``, the IsaacLab and mjlab adapters): a Python
  loop around the agent's ``act`` and ``step`` until ``step`` says an update
  is due, then ``update`` (``_rollout_and_update_host``).  The environment's
  ``info`` arrays go into the transitions; where the environment does not
  autoreset the finished instances are reset by index.  The episode sums
  stay where the observation lies (a simulator's tensors on its device,
  numpy arrays on the host), and each step's finished-episode aggregates
  come to the host with the update's metrics, in its one transfer, so a
  rollout step waits on nothing.  The
  Timer splits each iteration into ``environment`` (the loop, the policy's
  steps included) and ``agent`` (the update), and ``Perf/environment_fps``
  reads the first.  ``iterations_per_dispatch`` does not apply: every
  iteration makes its own transfers.
* **Tensor driver**, for a device-resident ``TensorEnvironment``: the
  ``RolloutDriver`` (the JAX Trainer's scan path, ``_rollout_and_update_scan``
  and its chunked form).

With ``iterations_per_dispatch = K > 1`` the tensor driver runs
K iterations per chunk and brings their aggregates and metrics to the host in
ONE transfer; chunks clamp to checkpoint boundaries and to the end of
training.  Each call of the per-iteration step still returns one iteration's
metrics, and ``Perf/*`` times are amortised over the chunk.

The JAX Trainer prefetches the next chunk before it blocks on the current
one's transfer; that has no counterpart here: CUDA launches are queued
asynchronously, so the host already runs ahead of the device until the
chunk's one transfer.

With a ``logger_factory`` the Trainer writes the run directory
(``info/metadata.json``, ``agent_info.txt``, the git provenance of
``save_version_info``), logs every iteration's scalars and saves
``ckpt/ckpt_<iteration>.npz`` every ``checkpoint_interval`` iterations and
at the end.  ``checkpoint`` (a loaded checkpoint dict) resumes: the agent's
state, the step count, the iteration; the environment's state is empty, so
a resumed run starts fresh episodes, as the JAX package's does.  Logging
reads the chunk's host values: a chunk that ends at no checkpoint makes one
host transfer.  ``profile_dir`` records a ``torch.profiler`` trace
(``trace.json``) of the iterations ``profile_iterations = (start, stop)``;
chunks also clamp to those two iterations, so the trace holds exactly the
window's device work.

Under several processes (``torchrun``) each rank runs its own Trainer, as in
the JAX package: env-steps count ``x`` the data ranks (the world, or a
distributed agent's data group: model peers step the same environments),
the logged scalars are
averaged across ranks (``utils.distributed.average_dict``), and the run
directory's files, the logger's output and the prints come from rank 0
only.  Whether the ranks share one policy is the agent's business
(``parallel.distribute_agent``); the Trainer does not distribute it.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from cusrl_tpu_torch.template.environment import (
    Environment,
    TensorEnvironment,
    update_observation_and_state,
)
from cusrl_tpu_torch.template.logger import LoggerFactory
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.timing import Timer

__all__ = ["EnvironmentStats", "Trainer", "TrainerHook", "save_version_info"]


class EnvironmentStats:
    """Rolling episode reward/length statistics from per-iteration aggregates."""

    def __init__(self, max_episodes: int = 100):
        self.max_episodes = max_episodes
        self._episodes: deque[tuple[float, float, float]] = deque(maxlen=256)  # (count, return_sum, length_sum)
        self.total_steps = 0

    def track_aggregates(self, count: float, return_sum: float, length_sum: float, steps: int) -> None:
        self.total_steps += steps
        if count > 0:
            self._episodes.append((count, return_sum, length_sum))
            while sum(c for c, _, _ in self._episodes) - self._episodes[0][0] >= self.max_episodes:
                self._episodes.popleft()

    @property
    def episode_count(self) -> float:
        return sum(c for c, _, _ in self._episodes)

    @property
    def mean_episode_reward(self) -> float | None:
        count = self.episode_count
        return None if count == 0 else sum(r for _, r, _ in self._episodes) / count

    @property
    def mean_episode_length(self) -> float | None:
        count = self.episode_count
        return None if count == 0 else sum(l for _, _, l in self._episodes) / count

    def summary(self, prefix: str = "Environment/") -> dict[str, float]:
        result: dict[str, float] = {}
        if (reward := self.mean_episode_reward) is not None:
            result[f"{prefix}episode_reward"] = reward
        if (length := self.mean_episode_length) is not None:
            result[f"{prefix}episode_length"] = length
        return result

    def state_dict(self) -> dict:
        return {"total_steps": self.total_steps}

    def load_state_dict(self, state: dict) -> None:
        # Only the step count: the rolling window starts anew.
        self.total_steps = int(state.get("total_steps", 0))


def save_version_info(output_dir: str) -> None:
    """Git provenance of the working directory: ``workspace.txt``, the last
    20 commits, the status and the diff."""
    os.makedirs(output_dir, exist_ok=True)

    def run(cmd: list[str]) -> str:
        try:
            return subprocess.run(cmd, capture_output=True, text=True, timeout=20).stdout
        except (OSError, subprocess.SubprocessError):
            return ""

    with open(os.path.join(output_dir, "workspace.txt"), "w") as f:
        f.write(os.getcwd() + "\n")
    for name, cmd in [
        ("git_log.txt", ["git", "log", "--oneline", "-20"]),
        ("git_status.txt", ["git", "status", "--short"]),
        ("git_diff.patch", ["git", "diff"]),
    ]:
        out = run(cmd)
        if out:
            with open(os.path.join(output_dir, name), "w") as f:
                f.write(out)


class TrainerHook:
    """Side callbacks on the training loop (not agent hooks)."""

    def init(self, trainer: "Trainer") -> None:
        pass

    def pre_iteration(self, trainer: "Trainer") -> None:
        pass

    def post_iteration(self, trainer: "Trainer", metrics: dict[str, float]) -> None:
        pass


class Trainer:
    def __init__(
        self,
        environment: Environment | TensorEnvironment | Callable[[], Any],
        agent_factory,
        num_iterations: int = 1000,
        logger_factory: LoggerFactory | Callable[..., Any] | None = None,
        checkpoint_interval: int = 50,
        experiment_name: str = "experiment",
        checkpoint: dict[str, Any] | None = None,
        verbose: bool = True,
        hooks: tuple[TrainerHook, ...] = (),
        metadata: dict[str, Any] | None = None,
        profile_dir: str | None = None,
        profile_iterations: tuple[int, int] = (3, 6),
        iterations_per_dispatch: int = 1,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        self.environment = environment() if callable(environment) and not hasattr(environment, "spec") else environment
        self.agent = agent_factory(self.environment.spec, device=device, seed=seed)
        self.num_iterations = num_iterations
        self.checkpoint_interval = checkpoint_interval
        self.verbose = verbose
        self.stats = EnvironmentStats()
        self.timer = Timer(synchronize=True)
        self.hooks = tuple(hooks)
        self.logger = logger_factory(experiment_name) if logger_factory is not None else None
        self.profile_dir = profile_dir
        self.profile_iterations = tuple(profile_iterations)
        self._profiler = None
        self.iterations_per_dispatch = max(1, int(iterations_per_dispatch))
        is_tensor = isinstance(self.environment, TensorEnvironment)
        self.driver = RolloutDriver(self.agent, self.environment) if is_tensor else None
        self._host_obs = self._host_state = None
        self.host_transfers = 0  # one per chunk (the tensor driver)
        self._pending_rows: list[torch.Tensor] = []
        self._pending_keys: list[tuple[str, ...]] = []
        self._last_chunk_done: float | None = None
        self._chunk_iter_time = 0.0
        if checkpoint is not None:
            self.load_checkpoint(checkpoint)
        if self.logger is not None and distributed.is_main_process():
            save_version_info(self.logger.info_dir)
            with open(os.path.join(self.logger.info_dir, "metadata.json"), "w") as f:
                json.dump(metadata or {}, f, indent=2, default=str)
            self._save_agent_info()
        for hook in self.hooks:
            hook.init(self)

    def _save_agent_info(self) -> None:
        """The hook pipeline, the parameter shapes and count, the spec."""
        agent = self.agent
        lines = [f"agent: {type(agent).__name__}", f"spec: {agent.environment_spec}", "", "hooks:"]
        lines += [f"  - {hook.hook_name}: {type(hook).__name__}(active={hook.active})" for hook in agent.hooks]
        lines += ["", "parameters:"]
        lines += [f"  {path}: {tuple(p.shape)}" for path, p in agent.model.named_parameters()]
        lines.append(f"total_parameters: {sum(p.numel() for p in agent.model.parameters())}")
        with open(os.path.join(self.logger.info_dir, "agent_info.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # -- checkpointing ---------------------------------------------------------

    def make_checkpoint(self) -> dict[str, Any]:
        return {
            "agent": self.agent.state_dict(),
            "environment": self.environment.state_dict(),
            "stats": self.stats.state_dict(),
            "iteration": self.agent.iteration,
        }

    def load_checkpoint(self, checkpoint: dict[str, Any]) -> None:
        self.agent.load_state_dict(checkpoint.get("agent", {}))
        if checkpoint.get("environment"):
            self.environment.load_state_dict(checkpoint["environment"])
        if checkpoint.get("stats"):
            self.stats.load_state_dict(checkpoint["stats"])
        if "iteration" in checkpoint:
            self.agent.set_iteration(int(checkpoint["iteration"]))

    # -- main loop -------------------------------------------------------------

    def run_training_loop(self) -> None:
        for iteration in range(self.agent.iteration, self.num_iterations):
            if self.profile_dir is not None and iteration == self.profile_iterations[0]:
                self._start_profile()
            for hook in self.hooks:
                hook.pre_iteration(self)
            metrics = self.rollout_and_update()
            if self._profiler is not None and iteration + 1 == self.profile_iterations[1]:
                self._stop_profile()
            metrics = self._log_iteration(iteration, metrics)
            for hook in self.hooks:
                hook.post_iteration(self, metrics)
            if self.logger is not None and (iteration + 1) % self.checkpoint_interval == 0:
                self.logger.save_checkpoint(self.make_checkpoint(), iteration + 1)
        if self._profiler is not None:
            self._stop_profile()
        if self.logger is not None:
            self.logger.save_checkpoint(self.make_checkpoint(), self.num_iterations)
            self.logger.close()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.agent.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()

    def _stop_profile(self) -> None:
        if self.agent.device.type == "cuda":
            torch.cuda.synchronize()
        profiler, self._profiler = self._profiler, None
        profiler.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))

    def rollout_and_update(self) -> dict[str, float]:
        """One iteration's metrics; on the tensor driver device work and the
        host transfer happen on the first call of each chunk."""
        if self.driver is None:
            return self._rollout_and_update_host()
        if not self._pending_rows:
            self._run_chunk()
        self.timer.add("agent", self._chunk_iter_time)
        row = self._pending_rows.pop(0)
        count, return_sum, length_sum = (float(x) for x in row[:3])
        steps = self.agent.num_steps_per_update * self.environment.num_instances * self._data_ranks()
        self.stats.track_aggregates(count, return_sum, length_sum, steps)
        self.agent.record(dict(zip(self._pending_keys.pop(0), row[3:])))
        summary = self.agent.metrics.summary()
        self.agent.metrics.clear()
        return summary

    def _data_ranks(self) -> int:
        """The processes that step environments of their own."""
        group = getattr(self.agent, "process_group", None)
        return distributed.world_size() if group is None else torch.distributed.get_world_size(group)

    def _rollout_and_update_host(self) -> dict[str, float]:
        """The host loop.  The episode sums are tensors on the observation's
        device (the CPU for numpy arrays, which ``torch.as_tensor`` shares),
        and each step's ``(finished episodes, their return sum, their length
        sum)`` comes to the host with the update's metrics, so a rollout step
        waits on nothing; ``EnvironmentStats`` then takes them step by step."""
        env, agent = self.environment, self.agent
        if self._host_obs is None:
            self._host_obs, self._host_state, _ = env.reset()
            device = self._host_obs.device if isinstance(self._host_obs, torch.Tensor) else "cpu"
            self._host_cum_reward = torch.zeros(env.num_instances, dtype=torch.float64, device=device)
            self._host_cum_length = torch.zeros_like(self._host_cum_reward)
        cum_reward, cum_length = self._host_cum_reward, self._host_cum_length
        finished = []
        with self.timer.record("environment"):
            should_update = False
            while not should_update:
                action = agent.act(self._host_obs, self._host_state)
                obs, state, reward, terminated, truncated, info = env.step(action)
                done = (torch.as_tensor(terminated) | torch.as_tensor(truncated)).reshape(-1)
                cum_reward += torch.as_tensor(reward).sum(-1)
                cum_length += 1
                finished.append(torch.stack([done.sum(dtype=torch.float64), torch.where(done, cum_reward, 0.0).sum(),
                                             torch.where(done, cum_length, 0.0).sum()]))
                cum_reward.masked_fill_(done, 0.0)
                cum_length.masked_fill_(done, 0.0)
                self.stats.total_steps += env.num_instances
                extra = {k: v for k, v in (info or {}).items() if isinstance(v, (np.ndarray, torch.Tensor))}
                should_update = agent.step(obs, reward, terminated, truncated, next_state=state, **extra)
                if not env.spec.autoreset:
                    obs, state = self._reset_finished(obs, state, done)
                self._host_obs, self._host_state = obs, state
        with self.timer.record("agent"):
            metrics, aggregates = agent.update_and_read(torch.stack(finished))
        for count, return_sum, length_sum in aggregates.tolist():
            self.stats.track_aggregates(count, return_sum, length_sum, 0)
        return metrics

    def _reset_finished(self, obs, state, done: torch.Tensor):
        """Resets by index the instances that finished this step, for an
        environment that does not autoreset."""
        indices = done.nonzero().reshape(-1).cpu().numpy()
        if not indices.size:
            return obs, state
        new_obs, new_state, _ = self.environment.reset(indices=indices)
        if not isinstance(obs, torch.Tensor):
            return update_observation_and_state(obs, state, new_obs, new_state, indices)
        obs = torch.where(done[:, None], new_obs, obs)
        if state is not None and new_state is not None:
            state = torch.where(done[:, None], new_state, state)
        return obs, state

    def chunk_size(self) -> int:
        """Iterations in the next chunk: clamped to the next checkpoint
        boundary, to the end of training and to the profiler window's ends."""
        logical = self.agent.iteration
        boundary = self.checkpoint_interval - (logical % self.checkpoint_interval)
        chunk = min(self.iterations_per_dispatch, self.num_iterations - logical, boundary)
        if self.profile_dir is not None:
            chunk = min([chunk] + [end - logical for end in self.profile_iterations if end > logical])
        return max(1, chunk)

    def _run_chunk(self) -> None:
        start = time.perf_counter()
        chunk = self.chunk_size()
        aggregates, stacked, keys = self.driver.collect_and_update_many(self.agent.num_steps_per_update, chunk)
        values = torch.cat([aggregates.float(), stacked], dim=1).double().cpu()  # the chunk's one transfer
        self.host_transfers += 1
        now = time.perf_counter()
        # Amortise wall time over the chunk's iterations; between chunks the
        # span from one chunk's end to the next's is the per-chunk cost.
        since = self._last_chunk_done if self._last_chunk_done is not None else start
        self._chunk_iter_time = (now - since) / chunk
        self._last_chunk_done = now
        self._pending_rows = list(values.numpy())
        self._pending_keys = keys

    # -- logging ---------------------------------------------------------------

    def _log_iteration(self, iteration: int, metrics: dict[str, float]) -> dict[str, float]:
        env_time = self.timer.total("environment")
        agent_time = self.timer.total("agent")
        self.timer.clear()
        steps = self.agent.num_steps_per_update * self.environment.num_instances * self._data_ranks()
        info = {f"Train/{k}": v for k, v in metrics.items()}
        info.update(self.stats.summary())
        # A simulator's metrics (the IsaacLab and mjlab adapters' extras["log"]).
        get_metrics = getattr(self.environment, "get_metrics", None)
        if get_metrics is not None:
            info.update({f"Environment/{k}": v for k, v in get_metrics().items()})
        info.update(
            {
                "Perf/environment_time": env_time,
                "Perf/agent_time": agent_time,
                "Perf/environment_step": float(self.stats.total_steps),
                "Perf/environment_fps": steps / env_time if env_time > 0 else 0.0,
                "Perf/agent_fps": steps / agent_time if agent_time > 0 else 0.0,
                "Perf/total_fps": steps / (env_time + agent_time) if env_time + agent_time > 0 else 0.0,
            }
        )
        info = distributed.average_dict(info)
        if self.logger is not None:
            self.logger.log_scalars(info, iteration)
        if self.verbose and distributed.is_main_process():
            reward = info.get("Environment/episode_reward")
            reward_str = f"{reward:9.3f}" if reward is not None else "      n/a"
            print(
                f"iter {iteration + 1:>5}/{self.num_iterations} | reward {reward_str} | "
                f"env_fps {info['Perf/environment_fps']:>12.0f} | agent_fps {info['Perf/agent_fps']:>12.0f}"
            )
        return info

"""Training orchestrator (counterpart of ``cusrl_tpu/template/trainer.py``).

The port's Trainer drives a device-resident ``TensorEnvironment`` through the
``RolloutDriver`` (the JAX Trainer's scan path, ``_rollout_and_update_scan``
and its chunked form).  With ``iterations_per_dispatch = K > 1`` the loop runs
K iterations per chunk and brings their aggregates and metrics to the host in
ONE transfer; chunks clamp to checkpoint boundaries and to the end of
training.  Each call of the per-iteration step still returns one iteration's
metrics, and ``Perf/*`` times are amortised over the chunk.

The JAX Trainer prefetches the next chunk before it blocks on the current
one's transfer; that has no counterpart here: CUDA launches are queued
asynchronously, so the host already runs ahead of the device until the
chunk's one transfer.

Not ported yet (they raise ``NotImplementedError``): the host-loop driver for
a non-tensor ``Environment``, ``logger_factory``, checkpoint files
(``checkpoint``) and the profiler window (``profile_dir``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable

import torch

from cusrl_tpu_torch.template.environment import TensorEnvironment
from cusrl_tpu_torch.template.rollout import RolloutDriver
from cusrl_tpu_torch.utils.timing import Timer

__all__ = ["EnvironmentStats", "Trainer", "TrainerHook"]


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
        environment: TensorEnvironment | Callable[[], Any],
        agent_factory,
        num_iterations: int = 1000,
        logger_factory=None,
        checkpoint_interval: int = 50,
        checkpoint: dict[str, Any] | None = None,
        verbose: bool = True,
        hooks: tuple[TrainerHook, ...] = (),
        profile_dir: str | None = None,
        iterations_per_dispatch: int = 1,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        for name, value in (("logger_factory", logger_factory), ("checkpoint", checkpoint),
                            ("profile_dir", profile_dir)):
            if value is not None:
                raise NotImplementedError(f"Trainer '{name}' is not ported yet")
        self.environment = environment() if callable(environment) and not hasattr(environment, "spec") else environment
        if not isinstance(self.environment, TensorEnvironment):
            raise NotImplementedError("the host-loop driver for non-tensor environments is not ported yet")
        self.agent = agent_factory(self.environment.spec, device=device, seed=seed)
        self.num_iterations = num_iterations
        self.checkpoint_interval = checkpoint_interval
        self.verbose = verbose
        self.stats = EnvironmentStats()
        self.timer = Timer(synchronize=True)
        self.hooks = tuple(hooks)
        self.iterations_per_dispatch = max(1, int(iterations_per_dispatch))
        self.driver = RolloutDriver(self.agent, self.environment)
        self.host_transfers = 0  # one per chunk
        self._pending_rows: list[torch.Tensor] = []
        self._pending_keys: tuple[str, ...] = ()
        self._last_chunk_done: float | None = None
        self._chunk_iter_time = 0.0
        for hook in self.hooks:
            hook.init(self)

    # -- main loop -------------------------------------------------------------

    def run_training_loop(self) -> None:
        for iteration in range(self.agent.iteration, self.num_iterations):
            for hook in self.hooks:
                hook.pre_iteration(self)
            metrics = self._log_iteration(iteration, self.rollout_and_update())
            for hook in self.hooks:
                hook.post_iteration(self, metrics)

    def rollout_and_update(self) -> dict[str, float]:
        """One iteration's metrics; device work and the host transfer happen
        on the first call of each chunk."""
        if not self._pending_rows:
            self._run_chunk()
        self.timer.add("agent", self._chunk_iter_time)
        row = self._pending_rows.pop(0)
        count, return_sum, length_sum = (float(x) for x in row[:3])
        steps = self.agent.num_steps_per_update * self.environment.num_instances
        self.stats.track_aggregates(count, return_sum, length_sum, steps)
        self.agent.record(dict(zip(self._pending_keys, row[3:])))
        summary = self.agent.metrics.summary()
        self.agent.metrics.clear()
        return summary

    def chunk_size(self) -> int:
        """Iterations in the next chunk: clamped to the next checkpoint
        boundary and to the end of training."""
        logical = self.agent.iteration
        boundary = self.checkpoint_interval - (logical % self.checkpoint_interval)
        return max(1, min(self.iterations_per_dispatch, self.num_iterations - logical, boundary))

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
        steps = self.agent.num_steps_per_update * self.environment.num_instances
        info = {f"Train/{k}": v for k, v in metrics.items()}
        info.update(self.stats.summary())
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
        if self.verbose:
            reward = info.get("Environment/episode_reward")
            reward_str = f"{reward:9.3f}" if reward is not None else "      n/a"
            print(
                f"iter {iteration + 1:>5}/{self.num_iterations} | reward {reward_str} | "
                f"env_fps {info['Perf/environment_fps']:>12.0f} | agent_fps {info['Perf/agent_fps']:>12.0f}"
            )
        return info

"""Evaluation loop (counterpart of ``cusrl_tpu/template/player.py``).

Loads a checkpoint, puts the agent in inference mode (deterministic actions,
the distribution's mode, unless asked otherwise) and steps the environment
with real-time pacing at ``1 / timestep`` (``Rate``; ``timestep=0``, the
benchmark's, runs unpaced); stops after ``num_steps``, when every instance
has finished ``num_episodes`` episodes, or on SIGINT; ends with a box-drawn
summary: ``step_reward`` (the mean reward of a step) and, once an episode has
finished, ``episode_reward`` and ``episode_length`` (means over the finished
episodes).  ``PlayerHook``s see every step's ``reward``, ``terminated`` and
``truncated`` and every reset.

A host ``Environment`` is driven on numpy arrays, as the JAX Player drives
it: the episode statistics are kept on the host, and where the environment
does not autoreset the finished instances are reset by index.
A ``TensorEnvironment`` is driven step by step through ``_TensorEnvAdapter``
(the counterpart of ``_JaxEnvAdapter``), on its device: the episode
statistics accumulate there and come to the host once, at the end; a step
waits on the device only where ``num_episodes`` or a hook needs the host.
``steps_taken`` and ``loop_seconds`` (the loop's wall time, its final
transfer included) give the loop's rate.  Under several processes only rank 0
prints the summary.
"""

from __future__ import annotations

import signal
import time
from typing import Any

import numpy as np
import torch

from cusrl_tpu_torch.template.environment import TensorEnvironment, get_done_indices, update_observation_and_state
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.metrics import Metrics
from cusrl_tpu_torch.utils.timing import Rate

__all__ = ["Player", "PlayerHook"]


class PlayerHook:
    def init(self, player: "Player") -> None:
        pass

    def step(self, player: "Player", transition: dict[str, Any]) -> None:
        pass

    def reset(self, player: "Player", indices) -> None:
        pass

    def close(self, player: "Player") -> None:
        pass


class _TensorEnvAdapter:
    """Drives a ``TensorEnvironment`` step by step; draws from its own
    generator on the environment's device, seeded with ``seed``."""

    def __init__(self, env: TensorEnvironment, seed: int = 0):
        self.env = env
        self.spec = env.spec
        self.num_instances = env.num_instances
        self.device = getattr(env, "device", torch.device("cpu"))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._env_state = None

    def reset(self, indices=None):
        # A tensor environment autoresets: only the first reset builds a state.
        if self._env_state is None or indices is None:
            self._env_state = self.env.init_fn(self.generator)
        observation, state = self.env.observe_fn(self._env_state)
        return observation, state, {}

    @torch.no_grad()
    def step(self, action):
        self._env_state, reward, terminated, truncated, info = self.env.step_fn(
            self._env_state, torch.as_tensor(action, device=self.device), self.generator
        )
        observation, state = self.env.observe_fn(self._env_state)
        return observation, state, reward, terminated, truncated, info

    def close(self):
        self.env.close()


class Player:
    def __init__(
        self,
        environment,
        agent_factory,
        checkpoint: dict[str, Any] | None = None,
        deterministic: bool = True,
        num_steps: int | None = None,
        num_episodes: int | None = None,
        timestep: float | None = None,
        hooks: tuple[PlayerHook, ...] = (),
        verbose: bool = True,
        device=None,
        seed: int = 0,
    ):
        raw_env = environment() if callable(environment) and not hasattr(environment, "spec") else environment
        is_tensor = isinstance(raw_env, TensorEnvironment)
        self.environment = _TensorEnvAdapter(raw_env, seed=seed) if is_tensor else raw_env
        self.agent = agent_factory.from_environment(self.environment, device=device, seed=seed)
        if checkpoint is not None:
            self.agent.load_state_dict(checkpoint.get("agent", checkpoint))
        self.agent.set_inference_mode(deterministic=deterministic)
        self.num_steps = num_steps
        self.num_episodes = num_episodes
        self.hooks = tuple(hooks)
        self.verbose = verbose
        self.metrics = Metrics()
        if timestep is None:
            timestep = self.environment.spec.timestep
        self.rate = Rate(1.0 / timestep) if timestep else Rate(0.0)
        self.steps_taken = 0
        self.loop_seconds = 0.0
        self._stop = False

    def _handle_sigint(self, *_args) -> None:
        self._stop = True

    def run_playing_loop(self) -> dict[str, float]:
        for hook in self.hooks:
            hook.init(self)
        previous_handler = signal.signal(signal.SIGINT, self._handle_sigint)
        try:
            return self._run()
        finally:
            signal.signal(signal.SIGINT, previous_handler)
            for hook in self.hooks:
                hook.close(self)

    def _run(self) -> dict[str, float]:
        start = time.perf_counter()
        if isinstance(self.environment, _TensorEnvAdapter):
            self._run_tensor()
        else:
            self._run_host()
        self.loop_seconds = time.perf_counter() - start
        summary = self.metrics.summary()
        if self.verbose and distributed.is_main_process():
            width = max((len(k) for k in summary), default=10) + 2
            print("┌" + "─" * (width + 14) + "┐")
            for key, value in summary.items():
                print(f"│ {key:<{width}}{value:>10.4f}  │")
            print("└" + "─" * (width + 14) + "┘")
        return summary

    def _stops(self, step: int, finished) -> bool:
        if self.num_steps is not None and step >= self.num_steps:
            return True
        return self.num_episodes is not None and bool((finished >= self.num_episodes).all())

    def _run_host(self) -> None:
        """The host environment's loop (``cusrl_tpu/template/player.py:130-184``)."""
        env = self.environment
        observation, state, _ = env.reset()
        episode_counts = np.zeros(env.num_instances, dtype=np.int64)
        episode_rewards: list[float] = []
        episode_lengths: list[float] = []
        cum_reward = np.zeros(env.num_instances)
        cum_length = np.zeros(env.num_instances)
        step = 0
        self.rate.reset()
        while not self._stop:
            action = self.agent.act(observation, state)
            observation, state, reward, terminated, truncated, _ = env.step(action)
            self.agent.step(observation, reward, terminated, truncated, next_state=state)
            transition = {"reward": reward, "terminated": terminated, "truncated": truncated}
            for hook in self.hooks:
                hook.step(self, transition)
            cum_reward += np.asarray(reward).sum(-1)
            cum_length += 1
            self.metrics.record(step_reward=float(np.asarray(reward).mean()))
            done_indices = get_done_indices(terminated, truncated)
            if done_indices.size:
                episode_counts[done_indices] += 1
                episode_rewards.extend(cum_reward[done_indices].tolist())
                episode_lengths.extend(cum_length[done_indices].tolist())
                cum_reward[done_indices] = 0
                cum_length[done_indices] = 0
                if not env.spec.autoreset:
                    new_obs, new_state, _ = env.reset(indices=done_indices)
                    observation, state = update_observation_and_state(observation, state, new_obs, new_state,
                                                                      done_indices)
                for hook in self.hooks:
                    hook.reset(self, done_indices)
            step += 1
            if self._stops(step, episode_counts):
                break
            self.rate.tick()
        self.steps_taken = step
        if episode_rewards:
            self.metrics.record(episode_reward=episode_rewards, episode_length=episode_lengths)

    def _run_tensor(self) -> None:
        env = self.environment
        observation, state, _ = env.reset()
        zeros = torch.zeros(env.num_instances, device=env.device)
        episode_counts = zeros.long()
        cum_reward, cum_length = zeros.clone(), zeros.clone()
        finished = torch.zeros(3, device=env.device)  # episodes, their reward sum, their length sum
        step_reward_sum = torch.zeros((), device=env.device)
        step = 0
        self.rate.reset()

        while not self._stop:
            action = self.agent.act(observation, state)
            observation, state, reward, terminated, truncated, _ = env.step(action)
            self.agent.step(observation, reward, terminated, truncated, next_state=state)
            transition = {"reward": reward, "terminated": terminated, "truncated": truncated}
            for hook in self.hooks:
                hook.step(self, transition)

            done = (terminated | truncated).reshape(-1)
            cum_reward += reward.sum(-1)
            cum_length += 1
            step_reward_sum += reward.mean()
            finished += torch.stack([done.sum(), torch.where(done, cum_reward, 0.0).sum(),
                                     torch.where(done, cum_length, 0.0).sum()])
            episode_counts += done
            cum_reward = torch.where(done, 0.0, cum_reward)
            cum_length = torch.where(done, 0.0, cum_length)
            if self.hooks:
                indices = done.nonzero().reshape(-1).cpu().numpy()
                if indices.size:
                    for hook in self.hooks:
                        hook.reset(self, indices)

            step += 1
            if self._stops(step, episode_counts):
                break
            self.rate.tick()

        self.steps_taken = step
        values = torch.cat([step_reward_sum.reshape(1), finished]).tolist()  # the loop's one transfer
        self.metrics.record(step_reward=values[0] / max(step, 1))
        if values[1] > 0:
            self.metrics.record(episode_reward=values[2] / values[1], episode_length=values[3] / values[1])

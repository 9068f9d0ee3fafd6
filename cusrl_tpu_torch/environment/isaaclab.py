"""IsaacLab environment adapter (counterpart of ``cusrl_tpu/environment/isaaclab.py``).

IsaacLab is imported inside the launcher only: the adapter and the zoo's
entries load without it, and building an environment without it raises
``ImportError``.  As in the JAX package the ``policy`` and ``critic``
observation groups map to the observation and the state, the simulator
autoresets (``autoreset=True``) and omits final states
(``final_state_is_missing=True``), ``step_dt`` is the timestep, AMP's
demonstrations come from ``collect_reference_motions`` and the metrics from
``extras["log"]``.

The simulator's tensors stay on its device: ``step`` takes the agent's action
tensor (moved only where the devices differ) and returns the observation
``[N, D]``, the reward ``[N, 1]`` float32 and the flags ``[N, 1]`` bool as
device copies of the simulator's own, so a card-resident simulator and agent
exchange no host copy.  They are copies because the simulator rewrites its
buffers in place every step (IsaacLab's ``reward_buf``, ``reset_terminated``
and ``reset_time_outs``, and mjlab's after it) while the agent's buffer keeps
what each step returned until the update.  ``get_metrics`` reads all of
``extras["log"]`` in one transfer.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from cusrl_tpu_torch.template.environment import Environment

__all__ = ["IsaacLabEnvAdapter", "IsaacLabEnvLauncher", "TrainerCfg", "make_isaaclab_env"]


class ManagerBasedEnvAdapter(Environment):
    """The bridge to a manager-based simulator environment (IsaacLab's and
    mjlab's share it): the observation groups, the autoreset flags and the
    tensors on the simulator's device; ``collect_reference_motions`` is the
    demonstration sampler where ``demonstrations`` is set."""

    demonstrations = True

    def __init__(self, wrapped):
        self.wrapped = wrapped
        unwrapped = getattr(wrapped, "unwrapped", wrapped)
        observation_dim = int(np.prod(unwrapped.observation_space["policy"].shape[1:]))
        action_dim = int(np.prod(unwrapped.action_space.shape[1:]))
        state_dim = None
        if "critic" in getattr(unwrapped.observation_space, "spaces", {}):
            state_dim = int(np.prod(unwrapped.observation_space["critic"].shape[1:]))
        sampler = getattr(unwrapped, "collect_reference_motions", None) if self.demonstrations else None
        super().__init__(
            observation_dim=observation_dim,
            action_dim=action_dim,
            num_instances=unwrapped.num_envs,
            state_dim=state_dim,
            autoreset=True,
            final_state_is_missing=True,
            timestep=getattr(unwrapped, "step_dt", None),
            demonstration_sampler=sampler,
        )
        self.device = torch.device(getattr(unwrapped, "device", "cuda"))
        self._last_extras: dict = {}

    def _split_obs(self, obs_dict):
        observation = torch.as_tensor(obs_dict["policy"]).reshape(self.num_instances, -1).clone()
        state = None
        if self.spec.state_dim is not None:
            state = torch.as_tensor(obs_dict["critic"]).reshape(self.num_instances, -1).clone()
        return observation, state

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        obs_dict, extras = self.wrapped.reset()
        observation, state = self._split_obs(obs_dict)
        return observation, state, extras

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        obs_dict, reward, terminated, truncated, extras = self.wrapped.step(action)
        observation, state = self._split_obs(obs_dict)
        self._last_extras = extras or {}
        return (
            observation,
            state,
            torch.as_tensor(reward).reshape(-1, 1).to(torch.float32, copy=True),
            torch.as_tensor(terminated).reshape(-1, 1).to(torch.bool, copy=True),
            torch.as_tensor(truncated).reshape(-1, 1).to(torch.bool, copy=True),
            {},
        )

    def get_metrics(self) -> dict[str, float]:
        """The mean of each entry of the last step's ``extras["log"]``."""
        log = self._last_extras.get("log") or {}
        if not log:
            return {}
        means = torch.stack([torch.as_tensor(value, device=self.device).float().mean() for value in log.values()])
        return dict(zip(log, means.tolist()))

    def close(self):
        self.wrapped.close()


class IsaacLabEnvAdapter(ManagerBasedEnvAdapter):
    """An IsaacLab ``ManagerBasedRLEnv`` (or its gym wrapper) as an ``Environment``."""


class IsaacLabEnvLauncher(IsaacLabEnvAdapter):
    """Starts Isaac Sim's ``AppLauncher`` in this process, parses the task's
    configuration (``num_envs``, ``device`` where given, then ``kwargs`` set
    on it), imports each of ``extensions`` as ``<extension>.tasks`` (their
    tasks register on import) and wraps ``gym.make(task)``; ``close`` also
    closes the app."""

    def __init__(
        self,
        task: str,
        num_envs: int | None = None,
        headless: bool = True,
        play: bool = False,
        extensions: Sequence[str] = (),
        device: str | torch.device | None = None,
        **kwargs: Any,
    ):
        try:
            from isaaclab.app import AppLauncher
        except ImportError as error:
            raise ImportError("IsaacLabEnvLauncher requires an IsaacLab installation") from error

        parser = argparse.ArgumentParser()
        AppLauncher.add_app_launcher_args(parser)
        args, _ = parser.parse_known_args([])
        args.headless = headless and not play
        self._app = AppLauncher(args).app

        import importlib

        import gymnasium as gym
        import isaaclab_tasks  # noqa: F401  (registers the tasks)
        from isaaclab_tasks.utils.parse_cfg import parse_env_cfg

        for extension in extensions:
            importlib.import_module(f"{extension}.tasks")

        device_kwargs = {} if device is None else {"device": str(device)}
        env_cfg = parse_env_cfg(task, num_envs=num_envs, **device_kwargs)
        for key, value in kwargs.items():
            setattr(env_cfg, key, value)
        super().__init__(gym.make(task, cfg=env_cfg))

    def close(self):
        super().close()
        if self._app is not None:
            self._app.close()


@dataclasses.dataclass
class TrainerCfg:
    """A trainer configuration IsaacLab's workflows can carry in their Hydra
    configurations: ``cfg(environment)`` seeds the process and builds the
    port's Trainer on ``device`` (the card unless ``"cpu"``)."""

    num_iterations: int = 1000
    checkpoint_interval: int = 50
    seed: int = 0
    agent_factory: Any = None
    logger: str | None = "tensorboard"
    log_dir: str = "logs"
    experiment_name: str = "isaaclab"
    device: str | None = None

    def __call__(self, environment: Environment, checkpoint: dict | None = None):
        from cusrl_tpu_torch.template.logger import LoggerFactory
        from cusrl_tpu_torch.template.trainer import Trainer
        from cusrl_tpu_torch.utils.misc import set_global_seed

        seed = set_global_seed(self.seed)
        backend = None if self.logger in (None, "none") else self.logger
        return Trainer(
            environment=environment,
            agent_factory=self.agent_factory,
            num_iterations=self.num_iterations,
            logger_factory=LoggerFactory(backend=backend, log_dir=self.log_dir),
            checkpoint_interval=self.checkpoint_interval,
            experiment_name=self.experiment_name,
            checkpoint=checkpoint,
            device=self.device,
            seed=seed,
        )


def make_isaaclab_env(task: str, num_envs: int | None = None, play: bool = False,
                      **kwargs: Any) -> IsaacLabEnvLauncher:
    """An IsaacLab environment; ``play=True`` takes the task's registered
    ``-Play`` variant (``Play`` inserted before its version)."""
    if play:
        ids = task.split("-")
        ids.insert(-1, "Play")
        task = "-".join(ids)
    return IsaacLabEnvLauncher(task, num_envs=num_envs, play=play, **kwargs)

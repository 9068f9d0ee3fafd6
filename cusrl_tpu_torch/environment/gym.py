"""Gymnasium adapters (counterpart of ``cusrl_tpu/environment/gym.py``).

Host ``Environment``s on numpy arrays for the classic-control and Box2D
tasks.  A vector environment runs with gymnasium's autoreset disabled, so the
Trainer resets finished instances by mask; discrete actions arrive one-hot
from ``OneHotCategoricalDist`` and are converted with argmax.  gymnasium is
imported inside the functions only: the entries register without it and
fail where their environment is built.  ``make_gym_env`` and
``make_gym_vec`` accept the ``device`` the zoo's factories pass and drop it:
the environments live on the host.
"""

from __future__ import annotations

import random as _random
import warnings
from typing import Any

import numpy as np

from cusrl_tpu_torch.template.environment import Environment

__all__ = ["GymEnvAdapter", "GymVectorEnvAdapter", "make_gym_env", "make_gym_vec"]


def _action_dim_of(space) -> int:
    import gymnasium as gym

    if isinstance(space, gym.spaces.Box):
        if len(space.shape) != 1:
            raise ValueError("Box action spaces must be 1D")
        return space.shape[0]
    if isinstance(space, gym.spaces.Discrete):
        return int(space.n)
    raise ValueError(f"Unsupported action space: {space!r}")


def _check_obs_space(space) -> int:
    import gymnasium as gym

    if not isinstance(space, gym.spaces.Box) or len(space.shape) != 1:
        raise ValueError("Only 1D Box observation spaces are supported")
    return space.shape[0]


class GymEnvAdapter(Environment):
    """One gymnasium environment as a 1-instance vectorized Environment."""

    def __init__(self, wrapped):
        import gymnasium as gym

        super().__init__(
            observation_dim=_check_obs_space(wrapped.observation_space),
            action_dim=_action_dim_of(wrapped.action_space),
            num_instances=1,
            observation_space=wrapped.observation_space,
            action_space=wrapped.action_space,
            gym_spec=wrapped.spec,
        )
        self._discrete = isinstance(wrapped.action_space, gym.spaces.Discrete)
        wrapped.reset(seed=_random.getrandbits(32))
        self.wrapped = wrapped

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        observation, info = self.wrapped.reset()
        if self.wrapped.render_mode is not None:
            self.wrapped.render()
        return observation.reshape(1, -1).astype(np.float32), None, info

    def step(self, action):
        action = np.asarray(action)
        action = int(np.argmax(action, axis=-1).squeeze()) if self._discrete else action.reshape(-1)
        observation, reward, terminated, truncated, info = self.wrapped.step(action)
        if self.wrapped.render_mode is not None:
            self.wrapped.render()
        return (
            observation.reshape(1, -1).astype(np.float32),
            None,
            np.asarray([[reward]], np.float32),
            np.asarray([[terminated]], bool),
            np.asarray([[truncated]], bool),
            info,
        )

    def close(self):
        self.wrapped.close()


class GymVectorEnvAdapter(Environment):
    """A ``gym.vector.VectorEnv`` with autoreset disabled; partial resets by mask."""

    def __init__(self, wrapped):
        import gymnasium as gym

        autoreset_mode = wrapped.metadata.get("autoreset_mode")
        if autoreset_mode is None:
            warnings.warn("GymVectorEnvAdapter expects 'autoreset_mode' to be DISABLED.")
        elif autoreset_mode != gym.vector.AutoresetMode.DISABLED:
            raise ValueError("Vector environments require autoreset_mode=DISABLED")
        super().__init__(
            observation_dim=_check_obs_space(wrapped.single_observation_space),
            action_dim=_action_dim_of(wrapped.single_action_space),
            num_instances=wrapped.num_envs,
            observation_space=wrapped.single_observation_space,
            action_space=wrapped.single_action_space,
            gym_spec=wrapped.spec,
        )
        self._discrete = isinstance(wrapped.single_action_space, gym.spaces.Discrete)
        wrapped.reset(seed=_random.getrandbits(32))
        self.wrapped = wrapped

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        if indices is None:
            observation, info = self.wrapped.reset()
        else:
            mask = np.zeros(self.num_instances, bool)
            mask[np.asarray(indices)] = True
            observation, info = self.wrapped.reset(options={"reset_mask": mask})
        if self.wrapped.render_mode is not None:
            self.wrapped.render()
        return np.asarray(observation, np.float32), None, info

    def step(self, action):
        action = np.asarray(action)
        if self._discrete:
            action = np.argmax(action, axis=-1)
        observation, reward, terminated, truncated, info = self.wrapped.step(action)
        if self.wrapped.render_mode is not None:
            self.wrapped.render()
        return (
            np.asarray(observation, np.float32),
            None,
            np.asarray(reward, np.float32).reshape(-1, 1),
            np.asarray(terminated, bool).reshape(-1, 1),
            np.asarray(truncated, bool).reshape(-1, 1),
            info,
        )

    def close(self):
        self.wrapped.close()


def make_gym_env(id: str, max_episode_steps: int | None = None, device=None, **kwargs: Any) -> GymEnvAdapter:
    import gymnasium as gym

    return GymEnvAdapter(gym.make(id=id, max_episode_steps=max_episode_steps, **kwargs))


def make_gym_vec(id: str, num_envs: int = 1, vectorization_mode: str = "sync", vector_kwargs: dict | None = None,
                 device=None, **kwargs: Any) -> GymVectorEnvAdapter:
    import gymnasium as gym

    return GymVectorEnvAdapter(gym.make_vec(
        id=id,
        num_envs=num_envs,
        vectorization_mode=vectorization_mode,
        vector_kwargs=(vector_kwargs or {}) | {"autoreset_mode": gym.vector.AutoresetMode.DISABLED},
        **kwargs,
    ))

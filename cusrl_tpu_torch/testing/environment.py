"""Dummy environment for tests and examples (counterpart of
``DummyEnvironment`` in ``cusrl_tpu/testing/environment.py``).

A host ``Environment`` of random observations and rewards, each instance
terminating with probability ``done_prob`` and truncating with half of it.
It draws from numpy's generator in the JAX package's order, so the same seed
gives the same arrays.
"""

from __future__ import annotations

import numpy as np

from cusrl_tpu_torch.template.environment import Environment

__all__ = ["DummyEnvironment"]


class DummyEnvironment(Environment):
    def __init__(
        self,
        observation_dim: int = 8,
        action_dim: int = 4,
        num_instances: int = 4,
        state_dim: int | None = None,
        reward_dim: int = 1,
        done_prob: float = 0.1,
        seed: int = 0,
        **spec_kwargs,
    ):
        super().__init__(observation_dim, action_dim, num_instances, state_dim=state_dim, reward_dim=reward_dim,
                         **spec_kwargs)
        self.done_prob = done_prob
        self._rng = np.random.default_rng(seed)

    def _observe(self):
        n = self.num_instances
        observation = self._rng.standard_normal((n, self.spec.observation_dim), dtype=np.float32)
        state = None
        if self.spec.state_dim is not None:
            state = self._rng.standard_normal((n, self.spec.state_dim), dtype=np.float32)
        return observation, state

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        observation, state = self._observe()
        return observation, state, {}

    def step(self, action):
        n = self.num_instances
        observation, state = self._observe()
        reward = self._rng.standard_normal((n, self.spec.reward_dim)).astype(np.float32)
        terminated = self._rng.random((n, 1)) < self.done_prob
        truncated = self._rng.random((n, 1)) < self.done_prob / 2
        return observation, state, reward, terminated, truncated, {}

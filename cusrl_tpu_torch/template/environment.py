"""Environment contracts (counterpart of ``cusrl_tpu/template/environment.py``:
``EnvironmentSpec``, the host-driven ``Environment`` and the device-resident
``JaxEnvironment``).

``Environment`` is the host-driven vectorized contract on numpy arrays (gym
adapters, the native CartPole, external simulators)::

    reset(indices=None)  -> (observation, state | None, info)
    step(action)         -> (observation, state | None, reward [N, Dr], terminated [N, 1], truncated [N, 1], info)

The Trainer drives it with a Python loop around the agent's ``act`` and
``step``, and resets the finished instances itself where ``spec.autoreset``
is false (``get_done_indices``, ``update_observation_and_state``).

``TensorEnvironment`` is the device-resident contract on torch tensors::

    init_fn(generator)                       -> env_state  (dict of [N, ...] tensors)
    observe_fn(env_state)                    -> (observation, state | None)
    step_fn(env_state, action, generator)    -> (env_state, reward, terminated, truncated, info)

``step_fn`` autoresets: a finished instance's returned state already holds
the next episode's start, while reward/terminated/truncated describe the
finished transition.  Shapes: reward ``[N, reward_dim]``, terminated and
truncated ``[N, 1]`` bool.  Its ``state_dict`` is empty, as the JAX
package's is: a resumed run starts fresh episodes.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Callable

import numpy as np

__all__ = [
    "Environment",
    "EnvironmentSpec",
    "TensorEnvironment",
    "get_done_indices",
    "update_observation_and_state",
]


@dataclasses.dataclass
class EnvironmentSpec:
    """The JAX spec's fields.  The mirror functions map ``[..., C]`` to
    ``[..., C]`` (one variant) or ``[K, ..., C]`` (K variants); the symmetry
    hooks and observation normalization read them.  ``environment_instance``
    is the environment that built the spec (``DynamicEnvironmentSpecOverride``
    reads it)."""

    observation_dim: int
    action_dim: int
    num_instances: int = 1
    state_dim: int | None = None
    reward_dim: int = 1
    autoreset: bool = False
    final_state_is_missing: bool = False
    timestep: float | None = None  # the Player paces at 1 / timestep
    # Spaces (loosely typed; only the gym adapters fill them).
    observation_space: Any = None
    action_space: Any = None
    # Symmetry transformations: callables tensor -> mirrored tensor.
    mirror_observation: Callable | None = None
    mirror_state: Callable | None = None
    mirror_action: Callable | None = None
    # Predefined export-time statistics: (scale, shift) pairs.
    observation_normalization: tuple[Any, Any] | None = None
    state_normalization: tuple[Any, Any] | None = None
    action_denormalization: tuple[Any, Any] | None = None
    observation_normalization_excluded_indices: tuple[int, ...] | None = None
    state_normalization_excluded_indices: tuple[int, ...] | None = None
    observation_stat_groups: tuple[tuple[int, ...], ...] = ()
    state_stat_groups: tuple[tuple[int, ...], ...] = ()
    # Observation channels as indices into the state: observation
    # normalization then takes the observation's statistics from the state's.
    observation_is_subset_of_state: Any = None
    # Imitation: ``sampler(num) -> [num, D]`` expert transitions (AMP).
    demonstration_sampler: Callable[[int], Any] | None = None
    environment_instance: Any = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default=None):
        if hasattr(self, key):
            return getattr(self, key)
        return self.extras.get(key, default)

    @property
    def has_state(self) -> bool:
        return self.state_dim is not None


class Environment(ABC):
    """Host-driven vectorized environment; the spec is built from the
    keyword arguments, unknown keys going to ``spec.extras``."""

    def __init__(self, observation_dim: int, action_dim: int, num_instances: int, state_dim: int | None = None,
                 **spec_kwargs: Any):
        known = {f.name for f in dataclasses.fields(EnvironmentSpec)}
        extras = {k: v for k, v in spec_kwargs.items() if k not in known}
        spec_kwargs = {k: v for k, v in spec_kwargs.items() if k in known}
        self.spec = EnvironmentSpec(observation_dim=observation_dim, action_dim=action_dim,
                                    num_instances=num_instances, state_dim=state_dim, environment_instance=self,
                                    extras=extras, **spec_kwargs)

    @property
    def num_instances(self) -> int:
        return self.spec.num_instances

    @abstractmethod
    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        raise NotImplementedError

    @abstractmethod
    def step(self, action):
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        pass

    def close(self) -> None:
        pass


class TensorEnvironment:
    def __init__(self, spec: EnvironmentSpec):
        spec.autoreset = True
        spec.environment_instance = self
        self.spec = spec

    @property
    def num_instances(self) -> int:
        return self.spec.num_instances

    def init_fn(self, generator):
        raise NotImplementedError

    def observe_fn(self, env_state):
        raise NotImplementedError

    def step_fn(self, env_state, action, generator):
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state_dict: dict) -> None:
        pass

    def close(self) -> None:
        pass


def get_done_indices(terminated, truncated) -> np.ndarray:
    """Indices of the instances that finished this step."""
    done = np.asarray(terminated).reshape(-1) | np.asarray(truncated).reshape(-1)
    return np.nonzero(done)[0]


def update_observation_and_state(observation, state, new_observation, new_state, indices):
    """Writes the rows ``indices`` of a partial reset into copies of the
    running observation and state."""
    observation = np.asarray(observation).copy()
    observation[indices] = np.asarray(new_observation)[indices]
    if state is not None and new_state is not None:
        state = np.asarray(state).copy()
        state[indices] = np.asarray(new_state)[indices]
    return observation, state

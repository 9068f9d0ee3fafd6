"""Environment contract (counterpart of ``cusrl_tpu/template/environment.py``:
``EnvironmentSpec`` and the device-resident ``JaxEnvironment``).

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
from typing import Any, Callable

__all__ = ["EnvironmentSpec", "TensorEnvironment"]


@dataclasses.dataclass
class EnvironmentSpec:
    """The subset of the JAX spec's fields the port reads (the mirror
    functions and ``observation_is_subset_of_state`` are not ported yet)."""

    observation_dim: int
    action_dim: int
    num_instances: int = 1
    state_dim: int | None = None
    reward_dim: int = 1
    final_state_is_missing: bool = False
    timestep: float | None = None  # the Player paces at 1 / timestep
    # Predefined export-time statistics: (scale, shift) pairs.
    observation_normalization: tuple[Any, Any] | None = None
    action_denormalization: tuple[Any, Any] | None = None
    observation_normalization_excluded_indices: tuple[int, ...] | None = None
    state_normalization_excluded_indices: tuple[int, ...] | None = None
    observation_stat_groups: tuple[tuple[int, ...], ...] = ()
    state_stat_groups: tuple[tuple[int, ...], ...] = ()
    # Imitation: ``sampler(num) -> [num, D]`` expert transitions (AMP).
    demonstration_sampler: Callable[[int], Any] | None = None

    @property
    def has_state(self) -> bool:
        return self.state_dim is not None


class TensorEnvironment:
    def __init__(self, spec: EnvironmentSpec):
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

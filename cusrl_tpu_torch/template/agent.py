"""Agent base (counterpart of ``cusrl_tpu/template/agent.py``): dimensions,
device, random generators, update cadence, inference mode and the
checkpoint's top level."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.config import resolve_device
from cusrl_tpu_torch.utils.metrics import Metrics

__all__ = ["Agent", "AgentFactory"]


class Agent:
    def __init__(
        self,
        environment_spec: EnvironmentSpec,
        num_steps_per_update: int,
        device: str | torch.device | None = None,
        seed: int = 0,
        name: str = "Agent",
    ):
        self.environment_spec = environment_spec
        self.num_steps_per_update = int(num_steps_per_update)
        self.name = name
        self.device = resolve_device(device)
        self.observation_dim = environment_spec.observation_dim
        self.action_dim = environment_spec.action_dim
        self.state_dim = environment_spec.state_dim or environment_spec.observation_dim
        self.parallelism = environment_spec.num_instances
        self.iteration = 0
        self.step_index = 0
        self.inference_mode = False
        self.deterministic = False
        self.metrics = Metrics()
        # Explicit generators in place of jax.random keys: parameters are
        # initialised on the host (the same weights on every device), sampling
        # (actions, permutations, commands) draws on the agent's device.
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        # Data parallelism (parallel.distribute_agent): the process group the
        # update's collectives run over (a mesh's data group), and the epoch
        # plan's generator, the same on every rank (``generator`` stays the
        # data rank's own); during an update, this rank's ``(start, stop,
        # size)`` of the global minibatch.  On a mesh with a model axis, the
        # mesh (``parallel.ProcessMesh``) and its model group.
        self.process_group = None
        self.plan_generator: torch.Generator | None = None
        self.batch_slice: tuple[int, int, int] | None = None
        self.mesh = None
        self.model_group = None

    @property
    def gradient_group(self):
        """What the gradients' all-reduce runs over: the process group, or a
        mesh's levels (``utils.distributed.reduce_gradients``).  Model peers
        need none: they hold the same gradient of every whole leaf by
        construction, and each its own part of a sharded one."""
        return self.process_group if self.mesh is None else self.mesh.gradient_levels

    def record(self, metrics_dict: dict | None = None, /, **kwargs) -> None:
        self.metrics.record(metrics_dict, **kwargs)

    def set_inference_mode(self, deterministic: bool = True) -> None:
        self.inference_mode = True
        self.deterministic = deterministic

    def set_iteration(self, iteration: int) -> None:
        self.iteration = int(iteration)

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        return {"iteration": self.iteration}

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        if "iteration" in state_dict:
            self.set_iteration(int(state_dict["iteration"]))

    @classmethod
    def warn(cls, message: str) -> None:
        """A ``RuntimeWarning`` naming the agent class (catchable and
        filterable by callers and tests), on rank 0 only."""
        if distributed.is_main_process():
            warnings.warn(f"{cls.__name__}: {message}", RuntimeWarning, stacklevel=3)


@dataclasses.dataclass(kw_only=True)
class AgentFactory:
    num_steps_per_update: int = 24
    name: str = "Agent"

    def from_environment(self, environment, *, device=None, seed: int = 0) -> Agent:
        """The agent for ``environment``'s spec, on ``device`` (by default the
        environment's own)."""
        if device is None:
            device = getattr(environment, "device", None)
        return self(environment.spec, device=device, seed=seed)

"""Agent base (counterpart of ``cusrl_tpu/template/agent.py``): dimensions,
device, random generators and update cadence."""

from __future__ import annotations

import dataclasses

import torch

from cusrl_tpu_torch.template.environment import EnvironmentSpec
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
        self.metrics = Metrics()
        # Explicit generators in place of jax.random keys: parameters are
        # initialised on the host (the same weights on every device), sampling
        # (actions, permutations, commands) draws on the agent's device.
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def record(self, metrics_dict: dict | None = None, /, **kwargs) -> None:
        self.metrics.record(metrics_dict, **kwargs)


@dataclasses.dataclass(kw_only=True)
class AgentFactory:
    num_steps_per_update: int = 24
    name: str = "Agent"

"""Auxiliary state estimation (counterpart of
``cusrl_tpu/hook/auxiliary/estimation.py``).

A hook-owned estimator (``hooks.<hook_name>.estimator.*``, possibly
recurrent) predicts a slice of one transition entry from a slice of another
(privileged state from observations, say), trained with MSE.  ``pre_act``
writes its estimate into the transition; a recurrent estimator's memory
advances there, resets where an episode ends, and is recorded as
``estimator_memory`` (as of the rollout's first step, or per step under a
sampler with ``requires_per_step_memory``), so the objective replays the
rollout in sequence mode.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import flatten_nested, map_nested

__all__ = ["StateEstimation"]


def _dim_of(agent, name: str, dim: int | None) -> int:
    if dim is not None:
        return dim
    if name in ("observation", "next_observation"):
        return agent.observation_dim
    if name in ("state", "next_state"):
        return agent.state_dim
    raise ValueError(f"Dimension must be specified for entry '{name}'")


class StateEstimation(Hook):
    jax_config_fields = ("weight",)

    def __init__(self, estimator_factory=None, source_name: str = "observation",
                 source_indices: tuple[int, ...] | None = None, source_dim: int | None = None,
                 target_name: str = "state", target_indices: tuple[int, ...] | None = None,
                 target_dim: int | None = None, estimation_name: str = "state_estimation", weight: float = 1.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.estimator_factory = estimator_factory
        self.source_name, self.source_indices, self.source_dim = source_name, source_indices, source_dim
        self.target_name, self.target_indices, self.target_dim = target_name, target_indices, target_dim
        self.estimation_name = estimation_name
        self.weight = weight
        self.estimator = None
        self.memory = None
        self._indices = {}
        self.batch_keys = (source_name, target_name, "estimator_memory", "done")

    def init(self, agent) -> None:
        source_dim = _dim_of(agent, self.source_name, self.source_dim)
        target_dim = _dim_of(agent, self.target_name, self.target_dim)
        for name, indices in (("source", self.source_indices), ("target", self.target_indices)):
            if indices is not None:
                self._indices[name] = torch.tensor(tuple(indices), dtype=torch.long, device=agent.device)
        if self.source_indices is not None:
            source_dim = len(self.source_indices)
        if self.target_indices is not None:
            target_dim = len(self.target_indices)
        self.estimator = self.estimator_factory(source_dim, target_dim, agent.init_generator)
        if self.estimator.is_recurrent:
            self.memory = map_nested(lambda t: t.to(agent.device), self.estimator.init_memory(agent.parallelism))

    def trainable_modules(self) -> dict:
        return {"estimator": self.estimator}

    def state_tensors(self) -> dict:
        return {} if self.memory is None else flatten_nested(self.memory, "memory")

    def rollout_memory_entries(self) -> dict:
        return {} if self.memory is None else {"estimator_memory": self.memory}

    def _slice(self, x: torch.Tensor, which: str) -> torch.Tensor:
        index = self._indices.get(which)
        return x if index is None else x.index_select(-1, index)

    @torch.no_grad()
    def pre_act(self, agent, transition: dict) -> None:
        source = self._slice(transition[self.source_name], "source")
        estimation, next_memory, _ = self.estimator(source, self.memory)
        transition[self.estimation_name] = estimation
        if self.memory is not None:
            if agent.records_per_step_memory:
                transition["estimator_memory"] = storable_memory(self.memory, source.shape[0])
            self.memory = next_memory

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        if self.memory is not None:
            self.memory = reset_memory(self.memory, transition["done"])

    def objective(self, agent, metadata, batch):
        source = self._slice(batch[self.source_name], "source")
        target = self._slice(batch[self.target_name], "target")
        memory = batch.get("estimator_memory")
        temporal = metadata.get("temporal", False)
        if temporal and memory is not None:
            memory = map_nested(lambda m: m[0], memory)
        estimation, _, _ = self.estimator(source, memory, sequential=temporal, done=batch.get("done"))
        loss = (estimation.float() - target.detach().float()).square().mean()
        return {"state_estimation_loss": loss * self.weight}, {}

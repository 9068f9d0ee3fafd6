"""Representation-learning probes (counterpart of
``cusrl_tpu/hook/auxiliary/representation.py``).

fp32 linear heads (hook-owned, ``hooks.<hook_name>.predictor.*``) on the
actor's intermediate representation, which ``OnPolicyPreparation`` and the
joint evaluation publish as ``batch["actor_intermediate"]``: the return (or
the value), a slice of the state, and a slice of the next state from the
latent and the action.  Each head is also an extra output of the export
graph (``post_export``).
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["NextStatePrediction", "ReturnPrediction", "StatePrediction"]


@torch.no_grad()
def _latent_dim(agent, latent_name: str) -> int:
    actor = agent.actor
    device = next(actor.parameters()).device
    _, _, aux = actor(torch.zeros(1, agent.observation_dim, device=device), actor.init_memory(1))
    if latent_name not in aux:
        raise KeyError(f"Actor does not publish intermediate '{latent_name}' (has {sorted(aux)})")
    return aux[latent_name].shape[-1]


class _LatentProbe(Hook):
    jax_config_fields = ("weight",)
    training_only = True
    loss_name = ""
    head_name = ""

    def __init__(self, target_indices: tuple[int, ...] | None = None, latent_name: str = "backbone.output",
                 weight: float = 0.01, **kwargs):
        super().__init__(**kwargs)
        self.target_indices = None if target_indices is None else tuple(target_indices)
        self.latent_name = latent_name
        self.weight = weight
        self.predictor: Linear | None = None
        self._index = None

    def _target_dim(self, agent) -> int:
        if not agent.environment_spec.has_state:
            raise ValueError(f"{type(self).__name__} requires a state space")
        if self.target_indices is not None:
            self._index = torch.tensor(self.target_indices, dtype=torch.long, device=agent.device)
            return len(self.target_indices)
        return agent.state_dim

    def trainable_modules(self) -> dict:
        return {"predictor": self.predictor}

    def _slice(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._index is None else x.index_select(-1, self._index)

    def _loss(self, inputs: torch.Tensor, target: torch.Tensor):
        loss = (self.predictor(inputs) - target.detach()).square().mean()
        return {self.loss_name: loss * self.weight}, {}

    def post_export(self, agent, graph) -> None:
        graph.add_head(self.head_name, self.predictor, input_name=f"actor.{self.latent_name}")


class ReturnPrediction(_LatentProbe):
    loss_name, head_name = "return_prediction_loss", "return_prediction"
    batch_keys = ("value", "return")

    def __init__(self, latent_name: str = "backbone.output", weight: float = 0.01,
                 predicts_value_instead_of_return: bool = False, **kwargs):
        super().__init__(None, latent_name, weight, **kwargs)
        self.predicts_value_instead_of_return = predicts_value_instead_of_return

    def init(self, agent) -> None:
        self.predictor = Linear(_latent_dim(agent, self.latent_name), agent.value_dim,
                                generator=agent.init_generator)

    def objective(self, agent, metadata, batch):
        target = batch["value"] if self.predicts_value_instead_of_return else batch["return"]
        return self._loss(batch["actor_intermediate"][self.latent_name], target)


class StatePrediction(_LatentProbe):
    loss_name, head_name = "state_prediction_loss", "state_prediction"
    batch_keys = ("state",)

    def init(self, agent) -> None:
        self.predictor = Linear(_latent_dim(agent, self.latent_name), self._target_dim(agent),
                                generator=agent.init_generator)

    def objective(self, agent, metadata, batch):
        return self._loss(batch["actor_intermediate"][self.latent_name], self._slice(batch["state"]))


class NextStatePrediction(_LatentProbe):
    """An action-conditioned forward model on the actor's latent."""

    loss_name, head_name = "next_state_prediction_loss", "next_state_prediction"
    batch_keys = ("action", "next_state")

    def init(self, agent) -> None:
        target_dim = self._target_dim(agent)
        self.predictor = Linear(_latent_dim(agent, self.latent_name) + agent.action_dim, target_dim,
                                generator=agent.init_generator)

    def objective(self, agent, metadata, batch):
        latent = batch["actor_intermediate"][self.latent_name]
        inputs = torch.cat([latent, batch["action"].to(latent.dtype)], dim=-1)
        return self._loss(inputs, self._slice(batch["next_state"]))

    def post_export(self, agent, graph) -> None:
        graph.add_head(self.head_name, self.predictor, input_name=f"actor.{self.latent_name}",
                       extra_inputs=("action",))

"""Random Network Distillation (counterpart of ``cusrl_tpu/hook/auxiliary/rnd.py``).

The intrinsic reward ``reward_scale * mean((f_target(s') - f_predictor(s'))^2)``
is added to the rollout's reward in ``pre_update`` (before the values and
advantages: register the hook before ``value_computation``); the predictor
trains toward the frozen target with MSE.  Both are hook-owned networks
built by ``module_factory`` and re-initialized Xavier-normal with zero
biases (``_xavier_reinit``); the target is frozen
(``hooks.<hook_name>.target.*``), the predictor trained
(``hooks.<hook_name>.predictor.*``).  Both passes take the whole ``[T, N]``
rollout, and each minibatch, at once: on the card an ``Mlp`` runs the chain
kernels (the target and ``pre_update``'s predictor the primal forward, the
objective's predictor the saving forward and the backward without the
input's gradient).
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.hook.control.initialization import map_linear_layers
from cusrl_tpu_torch.nn.layer.linear import Linear
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["RandomNetworkDistillation"]


def _xavier_reinit(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Xavier-normal weights and zero biases for every ``Linear`` below
    ``module`` (JAX ``rnd.py:22``: ``glorot_normal``)."""
    def fn(path: str, layer: Linear) -> None:
        torch.nn.init.xavier_normal_(layer.weight, generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()

    map_linear_layers(module, fn)
    return module


class RandomNetworkDistillation(Hook):
    jax_config_fields = ("reward_scale",)
    batch_keys = ("next_state", "next_observation")

    def __init__(self, module_factory=None, output_dim: int = 64, reward_scale: float = 1.0,
                 state_indices: tuple[int, ...] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.module_factory = module_factory
        self.output_dim = output_dim
        self.reward_scale = reward_scale
        self.state_indices = None if state_indices is None else tuple(state_indices)
        self.target = self.predictor = None
        self._index = None

    def init(self, agent) -> None:
        input_dim = agent.state_dim if self.state_indices is None else len(self.state_indices)
        generator = agent.init_generator
        target = self.module_factory(input_dim, self.output_dim, generator)
        predictor = self.module_factory(input_dim, self.output_dim, generator)
        self.target = _xavier_reinit(target, generator)
        self.predictor = _xavier_reinit(predictor, generator)
        if self.state_indices is not None:
            self._index = torch.tensor(self.state_indices, dtype=torch.long, device=agent.device)

    def trainable_modules(self) -> dict:
        return {"predictor": self.predictor}

    def frozen_modules(self) -> dict:
        return {"target": self.target}

    def _novelty(self, state: torch.Tensor):
        x = state if self._index is None else state.index_select(-1, self._index)
        with torch.no_grad():
            target_out, _, _ = self.target(x)
        predicted, _, _ = self.predictor(x)
        return target_out, predicted

    def pre_update(self, agent, rollout: dict) -> dict:
        with torch.no_grad():
            target_out, predicted = self._novelty(get_first(rollout, "next_state", "next_observation"))
            # In the networks' dtype (bf16 under the default compute dtype), as JAX.
            rnd_reward = self.reward_scale * (target_out - predicted).square().mean(-1, keepdim=True)
        rollout["reward"] = rollout["reward"] + rnd_reward
        return {"rnd_reward": rnd_reward.mean()}

    def objective(self, agent, metadata, batch):
        target_out, predicted = self._novelty(get_first(batch, "next_state", "next_observation"))
        return {"rnd_loss": (predicted - target_out).square().mean()}, {}

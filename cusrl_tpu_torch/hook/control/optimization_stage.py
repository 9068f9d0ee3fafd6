"""Nested optimization stage (counterpart of
``cusrl_tpu/hook/control/optimization_stage.py``).

After the agent's optimizer step for a minibatch (``post_objective``) the
stage runs its own hooks' ``objective`` on the minibatch, one backward of
their summed losses, their ``pre_optim`` (``GradientClipping`` among them)
and a step of its own optimizer, ``stage_optimizer``, built from
``optimizer_factory`` over every trainable parameter of the agent, as JAX's
is.  The stage's losses are reported as metrics.  The stage hooks' networks
are the stage's (``hooks.<stage>.stage_hooks.<i>.<module>``), so the agent's
optimizer holds them too; the agent's losses never reach them, so its Adam
leaves them where they are, as in JAX.  The stage's step moves the agent's
networks (a stage loss on the actor trains the actor), but its own hooks'
networks keep the weights they had before the step, while the stage
optimizer's moments and count advance: JAX's ``HookComposite.post_objective``
puts the stage's returned self, which holds the pre-step networks, back into
the stage's slot over the stepped state.  The port follows that quirk of the
JAX package (ROADMAP Queue 3).  Stage hooks see the minibatch as
the agent's objective left it, detached (JAX differentiates the stage's
loss alone), and ``metadata["optimization_stage"]`` names the stage.  The
stage's checkpoint entries are JAX's: the stage hooks' state and
configuration under ``stage_hooks.<i>.``, ``opt_state.*`` and
``stage_learning_rates.*`` (``utils/interop.py``).  Under a data-parallel
agent the stage's gradients are reduced before its hooks' ``pre_optim`` and
its step, as the agent's are (each rank weighted by its ``row_share``), so
its optimizer state stays the same on every rank.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.template.optimizer import OptimizerFactory, build_optimizer
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["OptimizationStage"]


class OptimizationStage(Hook):
    training_only = True

    def __init__(self, stage_name: str = "stage", stage_hooks: tuple[Hook, ...] = (),
                 optimizer_factory: OptimizerFactory | None = None, **kwargs):
        super().__init__(**kwargs)
        self.stage_name = stage_name
        self.stage_hooks = tuple(stage_hooks)
        self.optimizer_factory = optimizer_factory
        self.stage_optimizer = None

    @property
    def hook_name(self) -> str:
        return self.name or f"optimization_stage_{self.stage_name}"

    @property
    def batch_keys(self) -> tuple[str, ...]:
        return tuple(key for hook in self.stage_hooks if hook.active for key in getattr(hook, "batch_keys", ()))

    def init(self, agent) -> None:
        for hook in self.stage_hooks:
            hook.init(agent)
            for module in hook.frozen_modules().values():
                module.requires_grad_(False)

    def trainable_modules(self) -> dict[str, nn.Module]:
        owned = {str(i): nn.ModuleDict(m) for i, hook in enumerate(self.stage_hooks) if (m := hook.owned_modules())}
        return {"stage_hooks": nn.ModuleDict(owned)} if owned else {}

    def state_tensors(self) -> dict[str, Any]:
        return {f"stage_hooks.{i}.{key}": value for i, hook in enumerate(self.stage_hooks)
                for key, value in hook.state_tensors().items()}

    def post_init(self, agent) -> None:
        for hook in self.stage_hooks:
            hook.post_init(agent)
        self.stage_optimizer = build_optimizer(self.optimizer_factory, agent.model.named_parameters())
        # All of its state on the device, so an update rejection restores it by a device select.
        self.stage_optimizer.use_device_learning_rates()

    def schedule_is_noop(self, iteration: int) -> bool:
        return all(hook.schedule_is_noop(iteration) for hook in self.stage_hooks)

    def apply_schedule(self, iteration: int, agent=None) -> None:
        for hook in self.stage_hooks:
            hook.apply_schedule(iteration, agent)

    def post_objective(self, agent, metadata: dict, batch: dict) -> dict:
        metadata = {**metadata, "optimization_stage": self.hook_name}
        batch = map_nested(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, batch)
        active = [hook for hook in self.stage_hooks if hook.active]
        objectives: dict[str, torch.Tensor] = {}
        metrics: dict[str, Any] = {}
        for hook in active:
            obj, m = hook.objective(agent, metadata, batch)
            objectives.update(obj or {})
            metrics.update(m)
        if not objectives:
            return {}
        self.stage_optimizer.zero_grad()
        agent.optimizer.zero_grad()  # the agent's step left its gradients on the parameters
        sum(value.float() for value in objectives.values()).backward()
        if agent.process_group is not None:
            distributed.reduce_gradients(agent.model.parameters(), agent.row_share, agent.gradient_group)
        for hook in active:
            metrics.update(hook.pre_optim(agent))
        own = [p for module in self.trainable_modules().values() for p in module.parameters()]
        kept = [p.detach().clone() for p in own]
        self.stage_optimizer.step()
        with torch.no_grad():
            for param, value in zip(own, kept):
                param.copy_(value)
        metrics.update({key: value.detach() for key, value in objectives.items()})
        return metrics

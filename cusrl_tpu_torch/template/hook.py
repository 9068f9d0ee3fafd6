"""Hook system (counterpart of ``cusrl_tpu/template/hook.py``).

A hook is a plain object with lifecycle callbacks.  PyTorch runs eagerly, so
callbacks read the agent and update the payload dicts in place instead of
returning new pytrees; the order of the lifecycle is the JAX package's:

  host side, once:  ``init(agent)`` per hook, then (once the optimizer
                    exists) ``post_init(agent)`` per hook
  every env step:   ``pre_act`` -> actor explore -> ``post_act`` -> env step
                    -> ``post_step``
  every update:     ``pre_update``; then per minibatch ``objective`` (losses
                    summed, one backward) -> ``pre_optim`` (gradients on the
                    parameters) -> optimizer step -> ``post_objective`` (a
                    nested optimization stage's point); finally
                    ``post_update``.
  after an update:  ``apply_schedule(iteration, agent)`` (host side), unless
                    every active hook's ``schedule_is_noop(iteration)``.
  host loop:        ``should_update(agent)`` when a rollout is complete.
  at export:        ``pre_export(agent, graph)`` per hook, then the actor,
                    then ``post_export(agent, graph)`` per hook.

A hook's device state (running statistics, an adaptive scale) lives in
tensors that it updates in place and lists in ``state_tensors()``, keyed by
the JAX hook's field path.  A hook that trains a network of its own (AMP's
discriminator, RND's predictor) returns it from ``trainable_modules()``
after ``init``, and one it owns but never trains (RND's target, the
distillation expert) from ``frozen_modules()``; the agent registers both as
``model["hooks"][hook_name][name]``, so their parameters are
``hooks.<hook_name>.<name>...``, the JAX state's paths, and move and
snapshot with the actor's and the critic's.  The frozen ones have
``requires_grad`` off: the optimizer, gradient clipping and the gradient
all-reduce never see them.
``post_update`` receives the pre-update ``snapshot`` (parameters, optimizer
state and every hook's state tensors) when some active hook sets
``needs_snapshot``; otherwise it gets None and no snapshot is taken.

``HookComposite`` folds each callback over the active hooks in list order;
in inference mode (the Player) it skips the hooks marked ``training_only``.
An earlier hook may write ``batch["__objective_scales__"][hook_name]``
(``ConditionalObjectiveActivation``): that hook's losses are multiplied by
the scale (a 0/1 number or tensor), so its metrics stay as they are.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Any, Iterable

if TYPE_CHECKING:
    from torch import nn

    from cusrl_tpu_torch.template.actor_critic import ActorCritic

__all__ = ["Hook", "HookComposite", "camel_to_snake"]


def camel_to_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


class Hook:
    """Base hook.  Subclasses keep their configuration as attributes and
    override callbacks."""

    training_only: bool = False
    # post_update reads the pre-update snapshot (taken only when some hook asks).
    needs_snapshot: bool = False
    # Fields of the JAX hook's state that are configuration here: the
    # checkpoint reads and writes them as the hook's attributes, and
    # load_jax_state skips them.
    jax_config_fields: tuple[str, ...] = ()

    def __init__(self, *, name: str | None = None, active: bool = True):
        self.name = name
        self.active = active

    @property
    def hook_name(self) -> str:
        return self.name or camel_to_snake(type(self).__name__)

    def init(self, agent: "ActorCritic") -> None:
        """Builds what the hook needs from the agent (host side, once)."""

    def post_init(self, agent: "ActorCritic") -> None:
        """After every hook's ``init`` and the optimizer's construction."""

    def with_active(self, active: bool) -> "Hook":
        self.active = active
        return self

    def apply_schedule(self, iteration: int, agent: "ActorCritic | None" = None) -> None:
        """Host-side schedule, applied at construction and after each update."""

    def schedule_is_noop(self, iteration: int) -> bool:
        """True when ``apply_schedule(iteration)`` changes nothing (a hook
        that overrides ``apply_schedule`` overrides this too)."""
        return type(self).apply_schedule is Hook.apply_schedule

    def update_attribute(self, name: str, value: Any) -> "Hook":
        """A schedule's entry point: sets attribute ``name``; a device tensor
        takes the value in place (no host sync)."""
        current = getattr(self, name)
        if hasattr(current, "fill_"):
            current.fill_(value)
        else:
            setattr(self, name, value)
        return self

    def state_tensors(self) -> dict[str, Any]:
        """The hook's device state, updated in place, by JAX field path."""
        return {}

    def trainable_modules(self) -> dict[str, "nn.Module"]:
        """The networks the hook trains, by JAX field name (after ``init``)."""
        return {}

    def frozen_modules(self) -> dict[str, "nn.Module"]:
        """The networks the hook owns but never trains, by JAX field name
        (after ``init``)."""
        return {}

    def owned_modules(self) -> dict[str, "nn.Module"]:
        return {**self.trainable_modules(), **self.frozen_modules()}

    def rollout_memory_entries(self) -> dict[str, Any]:
        """Memories the rollout records as of its first step (``[1, N, ...]``
        in the rollout), by rollout key."""
        return {}

    def should_update(self, agent: "ActorCritic") -> bool:
        """Whether the host loop may update once the rollout is complete (all
        active hooks must agree)."""
        return True

    def pre_act(self, agent: "ActorCritic", transition: dict) -> None:
        pass

    def post_act(self, agent: "ActorCritic", transition: dict) -> None:
        pass

    def post_step(self, agent: "ActorCritic", transition: dict) -> None:
        pass

    def pre_update(self, agent: "ActorCritic", rollout: dict) -> dict[str, Any]:
        """``rollout`` holds ``[T, N, ...]`` tensors; returns metrics."""
        return {}

    def objective(self, agent: "ActorCritic", metadata: dict, batch: dict):
        """Returns ``(objectives: dict[str, scalar tensor] | None, metrics)``."""
        return None, {}

    def pre_optim(self, agent: "ActorCritic") -> dict[str, Any]:
        """Gradient-space callback (gradients are on the parameters); returns metrics."""
        return {}

    def post_objective(self, agent: "ActorCritic", metadata: dict, batch: dict) -> dict[str, Any]:
        """After the optimizer step of a minibatch; returns metrics."""
        return {}

    def post_update(self, agent: "ActorCritic", rollout: dict, snapshot=None) -> dict[str, Any]:
        """After the optimization epochs; ``snapshot`` as the module says."""
        return {}

    def pre_export(self, agent: "ActorCritic", graph) -> None:
        """Adds nodes ahead of the actor to the export graph."""

    def post_export(self, agent: "ActorCritic", graph) -> None:
        """Adds nodes (heads) after the actor to the export graph."""


class HookComposite:
    """Folds callbacks over the active hooks in order."""

    def __init__(self, hooks: Iterable[Hook], inference_mode: bool = False):
        self.hooks = list(hooks)
        self.inference_mode = inference_mode

    def _active(self) -> list[Hook]:
        return [h for h in self.hooks if h.active and not (self.inference_mode and h.training_only)]

    def pre_act(self, agent, transition: dict) -> None:
        for hook in self._active():
            hook.pre_act(agent, transition)

    def post_act(self, agent, transition: dict) -> None:
        for hook in self._active():
            hook.post_act(agent, transition)

    def post_step(self, agent, transition: dict) -> None:
        for hook in self._active():
            hook.post_step(agent, transition)

    def pre_update(self, agent, rollout: dict) -> dict:
        metrics: dict = {}
        for hook in self._active():
            metrics.update(hook.pre_update(agent, rollout))
        return metrics

    def objective(self, agent, metadata: dict, batch: dict):
        objectives: dict = {}
        metrics: dict = {}
        for hook in self._active():
            obj, m = hook.objective(agent, metadata, batch)
            scale = batch.get("__objective_scales__", {}).get(hook.hook_name)
            if obj and scale is not None:
                obj = {key: value * scale for key, value in obj.items()}
            for key in obj or {}:
                if key in objectives:
                    raise RuntimeError(f"Duplicate objective '{key}'")
            objectives.update(obj or {})
            metrics.update(m)
        return objectives, metrics

    def pre_optim(self, agent) -> dict:
        metrics: dict = {}
        for hook in self._active():
            metrics.update(hook.pre_optim(agent))
        return metrics

    def post_objective(self, agent, metadata: dict, batch: dict) -> dict:
        metrics: dict = {}
        for hook in self._active():
            metrics.update(hook.post_objective(agent, metadata, batch))
        return metrics

    def post_update(self, agent, rollout: dict, snapshot=None) -> dict:
        metrics: dict = {}
        for hook in self._active():
            metrics.update(hook.post_update(agent, rollout, snapshot))
        return metrics


def find_hook(hooks: Iterable[Hook], name: str) -> Hook:
    for hook in hooks:
        if hook.hook_name == name:
            return hook
    raise KeyError(f"No hook named '{name}'")

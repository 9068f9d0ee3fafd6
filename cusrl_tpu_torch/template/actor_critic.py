"""Actor-critic agent (counterpart of ``cusrl_tpu/template/actor_critic.py``:
act, step and update).

The actor, the critic and the networks the hooks train live in one
``nn.ModuleDict`` so their parameter paths (``actor.backbone.layers.0.weight``,
``hooks.adversarial_motion_prior.discriminator.layers.0.weight``, ...) are the
JAX package's dotted paths (``params_view``): the optimizer's groups, gradient
clipping, the update snapshot and ``.to(device)`` cover the hooks' networks
as they cover the actor and the critic.
``update_body`` runs ``pre_update``, then epochs x minibatches of
objective -> backward -> ``pre_optim`` -> optimizer step, then
``post_update``; the objective runs once per minibatch.  Step metrics are
averaged over all minibatches, as in the JAX update.  A recurrent actor's
memory (``actor_memory``) is carried by the agent: it advances in
``act_body`` and resets where an episode ends in ``step_body``.  Under a
sampler with ``requires_per_step_memory`` (``TemporalRandomSampler``) each
transition records the memories entering its step (``actor_memory`` here,
``critic_memory`` in ``ValueComputation``), stacked ``[T, N, ...]``;
otherwise the rollout records them once, as of its first step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.nn.module.actor import Actor, ActorFactory
from cusrl_tpu_torch.nn.module.critic import Value, ValueFactory
from cusrl_tpu_torch.template.agent import Agent, AgentFactory
from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.template.hook import Hook, HookComposite, find_hook
from cusrl_tpu_torch.template.optimizer import OptimizerFactory, build_optimizer
from cusrl_tpu_torch.utils.nest import map_nested, stack_nested

__all__ = ["ActorCritic", "ActorCriticFactory"]


class ActorCritic(Agent):
    def __init__(
        self,
        environment_spec: EnvironmentSpec,
        actor_factory: ActorFactory,
        critic_factory: ValueFactory,
        optimizer_factory: OptimizerFactory,
        sampler,
        hooks: Iterable[Hook],
        num_steps_per_update: int,
        device: str | torch.device | None = None,
        seed: int = 0,
        name: str = "Agent",
    ):
        super().__init__(environment_spec, num_steps_per_update, device=device, seed=seed, name=name)
        self.value_dim = environment_spec.reward_dim
        self.sampler = sampler
        actor = actor_factory(self.observation_dim, self.action_dim, self.init_generator)
        critic = critic_factory(self.state_dim, self.value_dim, self.init_generator)
        self.model = nn.ModuleDict({"actor": actor, "critic": critic})
        self.hooks = list(hooks)
        names = [h.hook_name for h in self.hooks]
        if len(names) != len(set(names)):
            raise RuntimeError(f"Duplicate hook names: {sorted({n for n in names if names.count(n) > 1})}")
        for hook in self.hooks:
            hook.init(self)
        # Registered before the model moves and the optimizer is built.
        hook_modules = {h.hook_name: nn.ModuleDict(m) for h in self.hooks if (m := h.trainable_modules())}
        if hook_modules:
            self.model["hooks"] = nn.ModuleDict(hook_modules)
        self.model.to(self.device)
        # A recurrent actor's memory, carried from step to step and from
        # rollout to rollout (None for a feedforward actor).
        self.actor_memory = self.actor.init_memory(self.parallelism)
        self.optimizer = build_optimizer(optimizer_factory, self.model.named_parameters())
        self._composite = HookComposite(self.hooks)
        self.transition: dict[str, Any] = {}
        self.buffer: list[dict] = []
        self._initial_memories: dict[str, Any] = {}  # the buffered rollout's, for update()
        for hook in self.hooks:
            hook.post_init(self)
        self.apply_schedules(0)

    @property
    def actor(self) -> Actor:
        return self.model["actor"]

    @property
    def critic(self) -> Value:
        return self.model["critic"]

    @property
    def records_per_step_memory(self) -> bool:
        """Whether transitions record the memories entering their step (the
        sampler replays windows from any step)."""
        return getattr(self.sampler, "requires_per_step_memory", False)

    def get_hook(self, hook_name: str) -> Hook:
        return find_hook(self.hooks, hook_name)

    def apply_schedules(self, iteration: int) -> None:
        """Host-side hook schedules (at construction and after each update)."""
        for hook in self._composite._active():
            hook.apply_schedule(iteration, self)

    # -- update snapshots (taken only when a hook's post_update reads one) ----

    @torch.no_grad()
    def take_snapshot(self) -> dict:
        """Device copies of the parameters, the optimizer state and every
        hook's state tensors."""
        optimizer = self.optimizer.optimizer
        return {
            "params": {path: p.detach().clone() for path, p in self.model.named_parameters()},
            "optimizer": {path: {k: v.clone() for k, v in optimizer.state.get(p, {}).items()}
                          for path, p in self.model.named_parameters()},
            "hooks": [{k: v.clone() for k, v in hook.state_tensors().items()} for hook in self.hooks],
        }

    @torch.no_grad()
    def restore_snapshot(self, snapshot: dict, where: torch.Tensor, keep: Hook | None = None) -> None:
        """Where the 0-d bool ``where`` holds, puts the snapshot back into the
        parameters, the optimizer state and the state of every hook but
        ``keep``; a device select, no host branch.  Optimizer state created
        after the snapshot (the first update) goes back to zeros."""
        optimizer = self.optimizer.optimizer
        for path, p in self.model.named_parameters():
            p.copy_(torch.where(where, snapshot["params"][path], p))
            old_state = snapshot["optimizer"][path]
            for key, value in optimizer.state.get(p, {}).items():
                if isinstance(value, torch.Tensor):
                    old = old_state.get(key)
                    value.copy_(torch.where(where.to(value.device), torch.zeros_like(value) if old is None else old,
                                            value))
        for hook, old_state in zip(self.hooks, snapshot["hooks"]):
            if hook is keep:
                continue
            for key, value in hook.state_tensors().items():
                value.copy_(torch.where(where, old_state[key], value))

    # -- rollout ---------------------------------------------------------------

    def rollout_memory_entries(self) -> dict:
        """The memories a rollout records, as of its first step: the actor's
        (``actor_memory``) and each active hook's
        (``Hook.rollout_memory_entries``), with rank-0 leaves broadcast to
        ``[N]``.  Sequence-mode passes replay the rollout from them; the
        per-step snapshots are never stored (``rollout.py:46-71,114-121``).
        None under a per-step sampler, whose transitions carry the memories
        entering each step."""
        if self.records_per_step_memory:
            return {}
        entries = {} if self.actor_memory is None else {"actor_memory": self.actor_memory}
        for hook in self._composite._active():
            entries.update({k: v for k, v in hook.rollout_memory_entries().items() if v is not None})
        return {key: storable_memory(value, self.parallelism) for key, value in entries.items()}

    @torch.no_grad()
    def act_body(self, observation: torch.Tensor, noise: torch.Tensor | None = None,
                 state: torch.Tensor | None = None) -> dict:
        """pre_act -> actor explore -> post_act; returns the transition
        (with the environment's ``state`` where it has one).  A recurrent
        actor's memory advances here and resets in ``step_body``."""
        transition: dict[str, Any] = {"observation": observation}
        if state is not None:
            transition["state"] = state
        self._composite.pre_act(self, transition)
        if self.actor_memory is not None and self.records_per_step_memory:
            transition["actor_memory"] = storable_memory(self.actor_memory, self.parallelism)
        dist_params, (action, logp), self.actor_memory, _ = self.actor.explore(
            transition["observation"], self.generator, self.actor_memory, noise=noise
        )
        transition.update(action_dist=dist_params, action=action, action_logp=logp)
        self._composite.post_act(self, transition)
        return transition

    @torch.no_grad()
    def step_body(self, transition: dict) -> dict:
        transition["done"] = transition["terminated"] | transition["truncated"]
        self._composite.post_step(self, transition)
        self.actor_memory = reset_memory(self.actor_memory, transition["done"])
        return transition

    def act(self, observation, noise: torch.Tensor | None = None) -> torch.Tensor:
        if self.step_index == 0:
            self._initial_memories = self.rollout_memory_entries()
        self.transition = self.act_body(torch.as_tensor(observation, device=self.device), noise)
        return self.transition["action"]

    def step(self, next_observation, reward, terminated, truncated, **info) -> bool:
        """Records the transition; returns whether an update is due."""
        terminated = torch.as_tensor(terminated, device=self.device)
        truncated = torch.as_tensor(truncated, device=self.device)
        if terminated.dtype != torch.bool or truncated.dtype != torch.bool:
            raise TypeError("'terminated' and 'truncated' must have dtype bool")
        transition = dict(self.transition)
        transition.update(
            next_observation=torch.as_tensor(next_observation, device=self.device),
            reward=torch.as_tensor(reward, device=self.device),
            terminated=terminated,
            truncated=truncated,
            **info,
        )
        self.buffer.append(self.step_body(transition))
        self.step_index += 1
        return self.step_index >= self.num_steps_per_update

    def update(self) -> dict[str, float]:
        rollout = stack_nested(self.buffer, torch.stack)
        rollout.update({k: map_nested(lambda x: x[None], v) for k, v in self._initial_memories.items()})
        self.buffer = []
        self.step_index = 0
        return {key: float(value) for key, value in self.update_body(rollout).items()}

    # -- update ----------------------------------------------------------------

    def _batch_keys(self) -> set[str]:
        keys: set[str] = set()
        for hook in self._composite._active():
            keys.update(getattr(hook, "batch_keys", ()))
        return keys

    def _train_step(self, metadata: dict, batch: dict) -> dict:
        objectives, metrics = self._composite.objective(self, metadata, batch)
        step_metrics = {key: value.detach() for key, value in objectives.items()}
        step_metrics.update(metrics)
        if objectives:
            loss = sum(value.float() for value in objectives.values())
            self.optimizer.zero_grad()
            loss.backward()
            step_metrics.update(self._composite.pre_optim(self))
            self.optimizer.step()
        return step_metrics

    def update_body(self, rollout: dict, epoch_perms=None) -> dict[str, torch.Tensor]:
        """One whole update on a ``[T, N, ...]`` rollout (memories as
        ``[1, N, ...]``, or ``[T, N, ...]`` per step); returns metrics as 0-d
        tensors.  ``epoch_perms`` injects the sampler's plan (the mini-batch
        samplers' permutations, the random samplers' indices).  With memory in
        the rollout the sampler is temporal: minibatches are whole
        environments or windows, and the hooks see ``metadata["temporal"]``."""
        rollout = dict(rollout)
        sampler = self.sampler.resolve(rollout)
        active = self._composite._active()
        snapshot = self.take_snapshot() if any(h.needs_snapshot for h in active) else None
        with torch.no_grad():
            metrics = self._composite.pre_update(self, rollout)
        capacity, parallelism = rollout["action"].shape[:2]
        plan = sampler.make_epoch_plan(capacity, parallelism, self.generator, self.device, epoch_perms)
        source = sampler.source({key: rollout[key] for key in self._batch_keys() if key in rollout})
        sums: dict[str, torch.Tensor] = {}
        steps = 0
        for epoch in range(sampler.num_epochs):
            for mini_batch in range(plan.num_mini_batches):
                batch = sampler.gather(source, plan, epoch, mini_batch)
                metadata = sampler.metadata(plan, epoch, mini_batch)
                for key, value in self._train_step(metadata, batch).items():
                    sums[key] = sums[key] + value if key in sums else value
                steps += 1
        metrics.update({key: value / steps for key, value in sums.items()})
        with torch.no_grad():
            metrics.update(self._composite.post_update(self, rollout, snapshot))
        self.iteration += 1
        return metrics


@dataclasses.dataclass(kw_only=True)
class ActorCriticFactory(AgentFactory):
    actor_factory: ActorFactory
    critic_factory: ValueFactory
    optimizer_factory: Any
    sampler: Any
    hooks: list[Hook] = dataclasses.field(default_factory=list)

    def __call__(self, environment_spec: EnvironmentSpec, *, device=None, seed: int = 0) -> ActorCritic:
        return ActorCritic(
            environment_spec=environment_spec,
            actor_factory=self.actor_factory,
            critic_factory=self.critic_factory,
            optimizer_factory=self.optimizer_factory,
            sampler=self.sampler,
            hooks=self.hooks,
            num_steps_per_update=self.num_steps_per_update,
            device=device,
            seed=seed,
            name=self.name,
        )

    # -- hook list editing (cusrl_tpu/template/actor_critic.py:716-745) --------

    def register_hook(self, hook: Hook, index: int | None = None, before: str | None = None,
                      after: str | None = None) -> "ActorCriticFactory":
        if (index is not None) + (before is not None) + (after is not None) > 1:
            raise ValueError("Only one of index, before, or after can be specified")
        if before is not None:
            index = self.get_hook_index(before)
        elif after is not None:
            index = self.get_hook_index(after) + 1
        elif index is None:
            index = len(self.hooks)
        self.hooks.insert(index, hook)
        return self

    def get_hook(self, hook_name: str) -> Hook:
        return self.hooks[self.get_hook_index(hook_name)]

    def get_hook_index(self, hook_name: str) -> int:
        for i, hook in enumerate(self.hooks):
            if hook.hook_name == hook_name:
                return i
        raise ValueError(f"No hook named '{hook_name}' is registered")

    def remove_hook(self, hook_name: str) -> "ActorCriticFactory":
        self.hooks.pop(self.get_hook_index(hook_name))
        return self

"""Actor-critic agent (counterpart of ``cusrl_tpu/template/actor_critic.py``:
act, step and update).

The actor, the critic and the networks the hooks train live in one
``nn.ModuleDict`` so their parameter paths (``actor.backbone.layers.0.weight``,
``hooks.adversarial_motion_prior.discriminator.layers.0.weight``, ...) are the
JAX package's dotted paths (``params_view``): the optimizer's groups, gradient
clipping, the update snapshot and ``.to(device)`` cover the hooks' networks
as they cover the actor and the critic.
``update_body`` runs ``pre_update``, then epochs x minibatches of
objective -> backward -> ``pre_optim`` -> optimizer step -> ``post_objective``
(an ``OptimizationStage``'s own objective and step), then ``post_update``;
the objective runs once per minibatch.  Under per-epoch minibatch counts the
sampler's plan is a list of segments, run in order.  Step metrics are
averaged over all minibatches, as in the JAX update.  The schedules run
after each update (``apply_schedules``), skipped when every active hook's
``schedule_is_noop``; ``resize_buffer`` follows a capacity schedule.  A
recurrent actor's memory (``actor_memory``) is carried by the agent: it
advances in ``act_body`` and resets where an episode ends in ``step_body``.  Under a
sampler with ``requires_per_step_memory`` (``TemporalRandomSampler``) each
transition records the memories entering its step (``actor_memory`` here,
``critic_memory`` in ``ValueComputation``), stacked ``[T, N, ...]``;
otherwise the rollout records them once, as of its first step.

The host loop (``act`` and ``step`` on numpy arrays, ``update``) pushes each
step's transition into a ``Buffer`` of ``num_steps_per_update`` steps on the
agent's device; ``step`` returns whether an update is due (every active
hook's ``should_update`` agreeing), and ``update`` reads the buffer (one
stack per field), hands the samplers its ``buffer_state`` and brings the
metrics to the host in one transfer.  The tensor driver
(``template/rollout.py``) stacks its own rollout and calls ``update_body``.

In inference mode (``set_inference_mode``, the Player's) the hooks marked
``training_only`` are skipped, the hooks adapt (observation normalization
freezes), ``act`` takes the distribution's mode where ``deterministic``,
``step`` keeps no transition, and every MLP of the model runs its kernel at
any row count: the floor of 256 rows is the JAX rule for a training pass,
and a policy step at the Player's 64 environments would fall below it.

``state_dict()`` is the JAX package's layout: ``iteration``,
``agent_state`` (every leaf by its JAX path, ``utils/interop.py``) and
``actor_memory``, plus the port's own ``torch_rng``: the states of the
agent's generators and of every hook's (``hooks.<hook_name>.generator``;
the environment draws from the agent's generator).  ``load_state_dict``
warns and keeps the initial value where a path is missing, as the JAX
package does.

A data-parallel agent (``parallel.distribute_agent``: ``process_group`` set)
runs ``update_body`` as one global update over every rank's rollout, the
JAX package's ``cross_process_update``: ``pre_update`` on the rank's own
rollout (the statistics it takes are global, see the hooks; its metrics are
averaged over the ranks), then the batch keys gathered on the environment
axis (memories included), the plan drawn over the global batch from
``plan_generator`` (the same on every rank), each rank's slice of every
global minibatch (rows, or environments under a temporal sampler:
``batch_slice``), and between ``backward`` and ``pre_optim`` one flat
all-reduce of the gradients weighted by each rank's share of the minibatch
(``row_share``; ``utils.distributed.reduce_gradients``, the reference's
``reduce_gradients``).  A loss that is a plain mean over the rank's rows
needs nothing more; a hook whose loss is another mean (AMP's subsample, a
masked mean) returns its rank's term of the global mean
(``utils.distributed.mean_term``).  The objective's metrics are averaged
with the same weights, one all-reduce an update.  The host loop's
``update`` runs so on the buffer's rollout.  On a mesh with a model axis
``process_group`` is the data group (the batch, ``row_share``, the rollout's
join, the metrics' means, every hook's statistics); model peers hold the
same rows, and under tensor parallelism each its part of the sharded Mlp
parameters, whose forward passes exchange activations over ``model_group``
(``parallel/tensor.py``).  The gradients are reduced over the data group
(or a hierarchical mesh's ``ici`` then ``dcn`` groups: ``gradient_group``),
whole and sharded leaves alike.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Iterable

import numpy as np
import torch
from torch import nn

from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.nn.module.actor import Actor, ActorFactory
from cusrl_tpu_torch.nn.module.critic import Value, ValueFactory
from cusrl_tpu_torch.parallel.multiprocess import globalize_rollout
from cusrl_tpu_torch.sampler.mini_batch_sampler import shard_rows
from cusrl_tpu_torch.template.agent import Agent, AgentFactory
from cusrl_tpu_torch.template.buffer import Buffer
from cusrl_tpu_torch.template.environment import EnvironmentSpec
from cusrl_tpu_torch.template.hook import Hook, HookComposite, find_hook
from cusrl_tpu_torch.template.optimizer import OptimizerFactory, build_optimizer
from cusrl_tpu_torch.utils import distributed
from cusrl_tpu_torch.utils.interop import load_agent_state, memory_to_numpy, state_entries
from cusrl_tpu_torch.utils.nest import map_nested

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
        hook_modules = {h.hook_name: nn.ModuleDict(m) for h in self.hooks if (m := h.owned_modules())}
        if hook_modules:
            self.model["hooks"] = nn.ModuleDict(hook_modules)
        for hook in self.hooks:
            for module in hook.frozen_modules().values():
                module.requires_grad_(False)
        self.model.to(self.device)
        # A recurrent actor's memory, carried from step to step and from
        # rollout to rollout (None for a feedforward actor).
        self.actor_memory = self.actor.init_memory(self.parallelism)
        self.optimizer = build_optimizer(optimizer_factory, self.model.named_parameters())
        self._composite = HookComposite(self.hooks)
        self.transition: dict[str, Any] = {}
        self.buffer = Buffer(self.num_steps_per_update, self.parallelism, self.device)
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
        active = self._composite._active()
        if all(hook.schedule_is_noop(iteration) for hook in active):
            return
        for hook in active:
            hook.apply_schedule(iteration, self)

    def resize_buffer(self, capacity: int) -> None:
        """A new rollout length for the host loop's buffer (emptied)."""
        self.buffer.resize(capacity)

    def set_iteration(self, iteration: int) -> None:
        if iteration != self.iteration:
            super().set_iteration(iteration)
            self.apply_schedules(iteration)

    def set_inference_mode(self, deterministic: bool = True) -> None:
        super().set_inference_mode(deterministic)
        self._composite = HookComposite(self.hooks, inference_mode=True)
        for hook in self.hooks:
            adapt = getattr(hook, "set_inference_mode", None)
            if adapt is not None:
                adapt(True)
        for module in self.model.modules():
            if hasattr(module, "min_fused_rows"):
                module.min_fused_rows = 1

    # -- checkpointing -----------------------------------------------------------

    def _generators(self) -> dict[str, torch.Generator]:
        generators = {"agent.init_generator": self.init_generator, "agent.generator": self.generator}
        if self.plan_generator is not None:
            generators["agent.plan_generator"] = self.plan_generator
        for hook in self.hooks:
            if isinstance(getattr(hook, "generator", None), torch.Generator):
                generators[f"hooks.{hook.hook_name}.generator"] = hook.generator
        return generators

    def state_dict(self) -> dict[str, Any]:
        result = super().state_dict()
        result["agent_state"] = {path: entry.read() for path, entry in state_entries(self).items()}
        result["actor_memory"] = memory_to_numpy(self.actor_memory)
        result["torch_rng"] = {name: g.get_state().numpy() for name, g in self._generators().items()}
        return result

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        super().load_state_dict(state_dict)
        saved = state_dict.get("agent_state")
        if saved is None:
            self.warn("No 'agent_state' entry in checkpoint.")
            return
        load_agent_state(self, saved, state_dict.get("actor_memory"))
        if "torch_rng" not in state_dict:
            self.warn("No 'torch_rng' entry (a JAX package checkpoint): the generators keep their seeds.")
        for name, generator in self._generators().items():
            rng = state_dict.get("torch_rng", {}).get(name)
            if rng is None or rng.shape != tuple(generator.get_state().shape):
                if "torch_rng" in state_dict:
                    self.warn(f"No usable generator state for '{name}'; keeping its seed.")
                continue
            generator.set_state(torch.from_numpy(np.array(rng, dtype=np.uint8)))
        self.set_iteration(int(state_dict.get("iteration", self.iteration)))

    def export(self, output_dir: str, **kwargs) -> None:
        from cusrl_tpu_torch.export import export_agent

        export_agent(self, output_dir, **kwargs)

    # -- update snapshots (taken only when a hook's post_update reads one) ----

    def _optimizers(self) -> list:
        """``(owning hook or None, torch optimizer)`` for the update's
        optimizers: the agent's, then each optimization stage's
        (``OptimizationStage.stage_optimizer``)."""
        stages = [(hook, hook.stage_optimizer.optimizer) for hook in self.hooks
                  if getattr(hook, "stage_optimizer", None) is not None]
        return [(None, self.optimizer.optimizer), *stages]

    @torch.no_grad()
    def take_snapshot(self) -> dict:
        """Device copies of the parameters, the optimizers' state and every
        hook's state tensors."""
        params = list(self.model.named_parameters())
        return {
            "params": {path: p.detach().clone() for path, p in params},
            "optimizer": [{path: {k: v.clone() for k, v in optimizer.state.get(p, {}).items()} for path, p in params}
                          for _, optimizer in self._optimizers()],
            "hooks": [{k: v.clone() for k, v in hook.state_tensors().items()} for hook in self.hooks],
        }

    @torch.no_grad()
    def restore_snapshot(self, snapshot: dict, where: torch.Tensor, keep: Hook | None = None) -> None:
        """Where the 0-d bool ``where`` holds, puts the snapshot back into the
        parameters, the optimizers' state and the state of every hook but
        ``keep``; a device select, no host branch.  Optimizer state created
        after the snapshot (the first update) goes back to zeros.  The
        active hooks after ``keep`` keep their state, their networks and
        their stage optimizer's state, as in JAX: its ``post_update`` fold
        puts each later hook's own post-update self back over the restored
        state (ROADMAP Queue 3)."""
        active = self._composite._active()
        later = {h.hook_name for h in active[active.index(keep) + 1:]} if keep in active else set()
        for path, p in self.model.named_parameters():
            if not (path.startswith("hooks.") and path.split(".")[1] in later):
                p.copy_(torch.where(where, snapshot["params"][path], p))
        for (owner, optimizer), saved in zip(self._optimizers(), snapshot["optimizer"]):
            if owner is not None and owner.hook_name in later:
                continue
            for path, p in self.model.named_parameters():
                old_state = saved[path]
                for key, value in optimizer.state.get(p, {}).items():
                    if isinstance(value, torch.Tensor):
                        old = old_state.get(key)
                        value.copy_(torch.where(where.to(value.device),
                                                torch.zeros_like(value) if old is None else old, value))
        for hook, old_state in zip(self.hooks, snapshot["hooks"]):
            if hook is keep or hook.hook_name in later:
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
        if self.inference_mode and self.deterministic:  # the distribution's mode
            dist_params, self.actor_memory, _ = self.actor(transition["observation"], self.actor_memory)
            action = self.actor.distribution.mode(dist_params)
            logp = self.actor.compute_logp(dist_params, action)
        else:
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

    def _device_tensor(self, value) -> torch.Tensor:
        """``value`` on the agent's device; a host array goes to the card by a
        non-blocking copy from pinned memory, so the host does not wait."""
        if isinstance(value, np.ndarray) and self.device.type == "cuda":
            return torch.from_numpy(np.require(value, requirements="CW")).pin_memory().to(self.device,
                                                                                          non_blocking=True)
        return torch.as_tensor(value, device=self.device)

    def act(self, observation, state=None, noise: torch.Tensor | None = None):
        """The action for ``observation`` (numpy in, numpy out: the step's
        one transfer to the host)."""
        if self.step_index == 0 and not self.inference_mode:
            self._initial_memories = self.rollout_memory_entries()
        self.transition = self.act_body(self._device_tensor(observation), noise,
                                        None if state is None else self._device_tensor(state))
        action = self.transition["action"]
        return action.cpu().numpy() if isinstance(observation, np.ndarray) else action

    def step(self, next_observation, reward, terminated, truncated, next_state=None, **info) -> bool:
        """Records the transition (none in inference mode), with the
        environment's ``info`` arrays; returns whether an update is due."""
        terminated = self._device_tensor(terminated)
        truncated = self._device_tensor(truncated)
        if terminated.dtype != torch.bool or truncated.dtype != torch.bool:
            raise TypeError("'terminated' and 'truncated' must have dtype bool")
        transition = dict(self.transition)
        transition.update(
            next_observation=self._device_tensor(next_observation),
            reward=self._device_tensor(reward),
            terminated=terminated,
            truncated=truncated,
        )
        transition.update({key: map_nested(self._device_tensor, value) for key, value in info.items()
                           if value is not None})
        if next_state is not None:
            transition["next_state"] = self._device_tensor(next_state)
        transition = self.step_body(transition)
        self.step_index += 1
        if self.inference_mode:
            return False
        self.buffer.push(transition)
        return self.step_index >= self.num_steps_per_update and all(
            hook.should_update(self) for hook in self.hooks if hook.active)

    def take_buffered_rollout(self) -> tuple[dict, dict]:
        """The buffer's rollout with the memories as of its first step, and
        its ``buffer_state``; the next step starts a new rollout."""
        rollout = self.buffer.data
        rollout.update({k: map_nested(lambda x: x[None], v) for k, v in self._initial_memories.items()})
        self.step_index = 0
        return rollout, {"cursor": self.buffer.cursor, "full": self.buffer.full}

    def update(self) -> dict[str, float]:
        """One update on the buffer's rollout (global under a process
        group); the metrics come to the host in one transfer."""
        return self.update_and_read()[0]

    def update_and_read(self, extra: torch.Tensor | None = None) -> tuple[dict[str, float], np.ndarray | None]:
        """``update``, and the caller's ``extra`` tensor read to the host: in
        the metrics' transfer (in fp64) where it lies on the agent's device,
        else on its own (no wait for a CPU tensor)."""
        rollout, buffer_state = self.take_buffered_rollout()
        metrics = self.update_body(rollout, buffer_state=buffer_state)
        keys = sorted(metrics)
        values = torch.stack([torch.as_tensor(metrics[k], device=self.device).float().reshape(()) for k in keys])
        self.apply_schedules(self.iteration)
        read = None
        if extra is not None and extra.device == values.device:
            values = torch.cat([values.double(), extra.double().reshape(-1)])
        elif extra is not None:
            read = extra.double().cpu().numpy()
        values = values.tolist()
        if extra is not None and read is None:
            read = np.asarray(values[len(keys):]).reshape(extra.shape)
        return dict(zip(keys, values[:len(keys)])), read

    # -- update ----------------------------------------------------------------

    def _batch_keys(self) -> set[str]:
        keys: set[str] = set()
        for hook in self._composite._active():
            keys.update(getattr(hook, "batch_keys", ()))
        return keys

    @property
    def row_share(self) -> float:
        """This rank's share of the current global minibatch (1 without a
        process group)."""
        if self.batch_slice is None:
            return 1.0
        start, stop, size = self.batch_slice
        return (stop - start) / size

    def _train_step(self, metadata: dict, batch: dict) -> tuple[dict, dict, dict]:
        """One minibatch: ``(the objective's metrics, pre_optim's,
        post_objective's)``.  Under a process group the gradients are
        reduced before ``pre_optim``, with this rank's ``row_share`` of the
        global minibatch as its weight."""
        objectives, metrics = self._composite.objective(self, metadata, batch)
        step_metrics = {key: value.detach() for key, value in objectives.items()}
        step_metrics.update(metrics)
        optim_metrics = {}
        if objectives:
            loss = sum(value.float() for value in objectives.values())
            self.optimizer.zero_grad()
            loss.backward()
            if self.process_group is not None:
                distributed.reduce_gradients(self.model.parameters(), self.row_share, self.gradient_group)
            optim_metrics = self._composite.pre_optim(self)
            self.optimizer.step()
        return step_metrics, optim_metrics, self._composite.post_objective(self, metadata, batch)

    def update_body(self, rollout: dict, epoch_perms=None, buffer_state=None) -> dict[str, torch.Tensor]:
        """One whole update on a ``[T, N, ...]`` rollout (memories as
        ``[1, N, ...]``, or ``[T, N, ...]`` per step); returns metrics as 0-d
        tensors.  ``epoch_perms`` injects the sampler's plan (the mini-batch
        samplers' permutations, the random samplers' indices).  With memory in
        the rollout the sampler is temporal: minibatches are whole
        environments or windows, and the hooks see ``metadata["temporal"]``.
        ``buffer_state`` (``{"cursor", "full"}``) goes to a sampler that
        takes it (the random samplers)."""
        rollout = dict(rollout)
        sampler = self.sampler.resolve(rollout)
        group = self.process_group
        active = self._composite._active()
        snapshot = self.take_snapshot() if any(h.needs_snapshot for h in active) else None
        with torch.no_grad():
            metrics = self._composite.pre_update(self, rollout)
        if group is not None and metrics:  # means over the rank's rollout, one of W equal parts
            keys = sorted(metrics)
            stacked = torch.stack([torch.as_tensor(metrics[key]).float().reshape(()) for key in keys])
            world = torch.distributed.get_world_size(group)
            metrics = dict(zip(keys, distributed.weighted_sum(stacked, 1.0 / world, group).unbind()))
        capacity, parallelism = rollout["action"].shape[:2]
        ring = {}
        if buffer_state is not None and "buffer_state" in inspect.signature(sampler.make_epoch_plan).parameters:
            ring["buffer_state"] = buffer_state
        batch_keys = {key: rollout[key] for key in self._batch_keys() if key in rollout}
        generator = self.generator
        if group is not None:
            # One global batch: every rank's environments, in rank order.
            batch_keys = globalize_rollout(batch_keys, group)
            parallelism *= torch.distributed.get_world_size(group)
            generator = self.plan_generator
            if generator is None and epoch_perms is None:
                raise RuntimeError("a distributed update draws its plan from 'plan_generator': "
                                   "call parallel.broadcast_agent_state(agent) first")
        plan = sampler.make_epoch_plan(capacity, parallelism, generator, self.device, epoch_perms, **ring)
        source = sampler.source(batch_keys)
        sums: dict[str, torch.Tensor] = {}
        steps = 0
        try:
            for segment in plan if isinstance(plan, list) else [plan]:
                rows = None
                if group is not None:
                    rows = shard_rows(segment.batch_size, torch.distributed.get_rank(group),
                                      torch.distributed.get_world_size(group))
                    self.batch_slice = (*rows, segment.batch_size)
                for epoch in range(segment.num_epochs):
                    for mini_batch in range(segment.num_mini_batches):
                        batch = sampler.gather(source, segment, epoch, mini_batch, rows)
                        metadata = sampler.metadata(segment, segment.epoch_start + epoch, mini_batch)
                        step_metrics, optim_metrics, post_metrics = self._train_step(metadata, batch)
                        for key, value in {**step_metrics, **optim_metrics, **post_metrics}.items():
                            # The rank's term weighted by its share, summed over the ranks below (a
                            # value that is global already, a gradient norm, comes back as it is).
                            value = value * self.row_share if group is not None else value
                            sums[key] = sums[key] + value if key in sums else value
                        steps += 1
        finally:
            self.batch_slice = None
        if group is not None and sums:
            keys = sorted(sums)
            stacked = torch.stack([sums[key].float().reshape(()) for key in keys])
            sums.update(zip(keys, distributed.weighted_sum(stacked, 1.0, group).unbind()))
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

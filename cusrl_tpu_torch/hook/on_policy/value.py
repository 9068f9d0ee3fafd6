"""Value computation and value loss hooks (counterpart of
``cusrl_tpu/hook/on_policy/value.py``).

``deferred`` is chosen as in the JAX hook (``value.py:58-98``): a
feedforward critic takes ``True``; a recurrent one that supports the
counterfactual-append contract takes ``"sequential"`` unless the sampler
needs per-step memory (``requires_per_step_memory``) or
``CUSRL_TPU_DEFERRED_SEQ=0``; any other recurrent critic (a GRU or an LSTM)
takes the per-step path, ``False``.

* ``deferred=True``: no critic pass runs during the rollout; ``pre_update``
  evaluates the critic over the whole ``[T*N]`` rollout twice (observations,
  then next observations for the bootstrap).
* ``deferred="sequential"``: no critic pass during the rollout either; one
  sequence-mode pass over the rollout from the hook's memory as of the
  rollout's start (the values, the final memory and the attention context),
  then one counterfactual "next token" pass for the bootstrap values
  (``value.py:143-167``).  The last step's done is zeroed for the pass, so
  the final memory is the pre-reset state the last-row bootstrap needs; the
  hook's memory then resets where the last step ended an episode.
* ``deferred=False``: the critic runs in every rollout step.  ``post_act``
  records the step's ``value`` from the hook's memory (and, under a
  per-step sampler, that memory as ``critic_memory``) and advances the
  memory; ``post_step`` records ``bootstrap_value``, the value of the step's
  next state from the advanced, pre-reset memory, and only then resets the
  memory where the step ended an episode (``value.py:100-135``).

``next_value[t] = value[t + 1]``, the bootstrap value where the step
truncated and at the last step, and ``termination_value`` where it
terminated: termination overrides the truncation bootstrap
(``value.py:223-229``).  Environments whose final state is missing
(``final_state_is_missing``) bootstrap truncated steps with their own value
on every path, and the last step with the critic on its next state
(``value.py:194-195,206-228``): the batched path then runs its second pass
on the last row only.

``sparse_bootstrap`` (the batched path): bootstrap values are read only at
truncated steps and at the last step, so instead of the second ``[T*N]``
pass the critic runs on the first N truncated next states (gathered in row
order by a cumulative sum, no host read), whose values are scattered back,
and on the last step's next states; where more than N steps truncated, the
full pass runs instead (``value.py:234-265``).  The result equals the full
pass on every input.  JAX picks the pass on the device (``lax.cond``); here
the overflow flag goes to pinned host memory before the value pass is
queued, and the host waits for it (a CUDA event) only after queueing that
pass, so the device is not left idle.  That is one host read per update,
counted in ``host_reads``.
"""

from __future__ import annotations

import os

import torch

from cusrl_tpu_torch.nn.base import reset_memory, storable_memory
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import flatten_nested, get_first, map_nested

__all__ = ["ValueComputation", "ValueLoss", "compute_next_value"]


def compute_next_value(value, bootstrap, terminated, truncated, termination_value: float = 0.0):
    """``[T, N, Dr]`` next-step values with truncation bootstrap and
    termination override."""
    next_value = torch.cat([value[1:], bootstrap[-1:]], dim=0)
    next_value = torch.where(truncated, bootstrap, next_value)
    # A Python scalar, not a host tensor: the latter is copied to the device
    # and waits for it.
    return torch.where(terminated, float(termination_value), next_value)


class ValueComputation(Hook):
    # The JAX hook's termination value is a state field there.
    jax_config_fields = ("termination_value",)

    def __init__(self, termination_value: float = 0.0, sparse_bootstrap: bool = False,
                 deferred: bool | str | None = None, **kwargs):
        super().__init__(**kwargs)
        self.termination_value = termination_value
        self.sparse_bootstrap = sparse_bootstrap
        self.host_reads = 0  # the sparse bootstrap's overflow flags read on the host
        self._overflow_flag = None
        self.deferred = deferred
        self.memory = None
        self.bootstrap_truncated_states = True

    def init(self, agent) -> None:
        critic = agent.critic
        per_step_sampler = agent.records_per_step_memory
        self.bootstrap_truncated_states = not agent.environment_spec.final_state_is_missing
        if self.deferred is None:
            if not critic.is_recurrent:
                self.deferred = True
            elif (not per_step_sampler and critic.supports_next_token_eval
                  and os.environ.get("CUSRL_TPU_DEFERRED_SEQ", "1") != "0"):
                self.deferred = "sequential"
            else:
                self.deferred = False
        if not critic.is_recurrent:
            if self.deferred == "sequential":
                self.deferred = True  # the sequential path of a feedforward critic is the batched one
            return
        if self.deferred is True:
            raise ValueError("deferred=True ValueComputation requires a feedforward critic "
                             "(recurrent critics use deferred='sequential')")
        if self.deferred == "sequential" and not critic.supports_next_token_eval:
            raise ValueError("deferred='sequential' requires a critic supporting next-token evaluation")
        if self.deferred == "sequential" and per_step_sampler:
            raise ValueError("deferred='sequential' records no per-step critic_memory snapshots, which this sampler "
                             "(requires_per_step_memory) needs for BPTT from arbitrary offsets; use the per-step "
                             "path (deferred=False)")
        # Hooks initialize before the model moves to the agent's device.
        self.memory = map_nested(lambda t: t.to(agent.device), critic.init_memory(agent.parallelism))

    def state_tensors(self) -> dict[str, torch.Tensor]:
        return {} if self.memory is None else flatten_nested(self.memory, "memory")

    def rollout_memory_entries(self) -> dict:
        if self.memory is None or self.deferred is True:
            return {}
        return {"critic_memory": self.memory}

    @torch.no_grad()
    def post_act(self, agent, transition: dict) -> None:
        if self.deferred:
            return
        observation = get_first(transition, "state", "observation")
        value, next_memory, _ = agent.critic(observation, self.memory)
        transition["value"] = value
        if self.memory is not None:
            if agent.records_per_step_memory:
                transition["critic_memory"] = storable_memory(self.memory, observation.shape[0])
            self.memory = next_memory

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        if self.memory is None or self.deferred == "sequential":
            return
        next_state = get_first(transition, "next_state", "next_observation")
        transition["bootstrap_value"], _, _ = agent.critic(next_state, self.memory)
        self.memory = reset_memory(self.memory, transition["done"])

    def pre_update(self, agent, rollout: dict) -> dict:
        critic = agent.critic
        observation = get_first(rollout, "state", "observation")
        next_state = get_first(rollout, "next_state", "next_observation")
        terminated, truncated = rollout["terminated"], rollout["truncated"]

        def eval_batched(states):
            t, n = states.shape[:2]
            value, _, _ = critic(states.reshape(t * n, *states.shape[2:]))
            return value.reshape(t, n, -1)

        if self.deferred == "sequential":
            done = rollout["done"]
            done_seq = torch.cat([done[:-1], torch.zeros_like(done[-1:])], 0)
            value, final_memory, ctx = critic.sequential_with_ctx(observation, self.memory, done_seq)
            if self.bootstrap_truncated_states:
                bootstrap = critic.eval_next_token(next_state, ctx)
            else:  # truncated steps bootstrap with their own value; the last row steps once more
                last_value, _, _ = critic(next_state[-1], final_memory)
                bootstrap = torch.cat([value[:-1], last_value[None]], 0)
                bootstrap = torch.where(truncated, value, bootstrap)
            self.memory = reset_memory(final_memory, done[-1])
        elif self.deferred and self.bootstrap_truncated_states and self.sparse_bootstrap:
            overflow = self._read_overflow(truncated)
            value = eval_batched(observation)
            bootstrap = self._sparse_bootstrap(critic, next_state, truncated, overflow())
        else:  # the batched pass (deferred=True), or the per-step path's values from the rollout
            value = eval_batched(observation) if self.deferred else rollout["value"]
            bootstrap = None if self.deferred else rollout.get("bootstrap_value")
            if self.bootstrap_truncated_states:
                if bootstrap is None:  # a feedforward critic: one batched pass
                    bootstrap = eval_batched(next_state)
            else:
                last = bootstrap[-1] if bootstrap is not None else critic(next_state[-1])[0]
                bootstrap = torch.cat([value[:-1], last[None]], 0)
                bootstrap = torch.where(truncated, value, bootstrap)
        rollout["value"] = value
        rollout["next_value"] = compute_next_value(value, bootstrap, terminated, truncated, self.termination_value)
        return {}

    def _read_overflow(self, truncated: torch.Tensor):
        """Starts reading whether more steps truncated than there are
        environments; returns the function that waits for the answer."""
        t, n = truncated.shape[:2]
        overflow = truncated.sum() > n
        self.host_reads += 1
        if overflow.device.type != "cuda":
            return lambda: bool(overflow)
        if self._overflow_flag is None:  # pinned, so the copy does not wait for the device
            self._overflow_flag = torch.empty((), dtype=torch.bool, pin_memory=True)
        host = self._overflow_flag.copy_(overflow, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()

        def wait() -> bool:
            ready.synchronize()
            return bool(host)

        return wait

    @staticmethod
    def _sparse_bootstrap(critic, next_state: torch.Tensor, truncated: torch.Tensor, overflow: bool):
        """Bootstrap values ``[T, N, Dr]`` where ``compute_next_value`` reads
        them: at the truncated steps the critic on the first N truncated next
        states (or on all of them where ``overflow``), at the last step's
        other rows the critic on its next states."""
        t, n = next_state.shape[:2]
        flat_states = next_state.reshape(t * n, *next_state.shape[2:])
        if overflow:
            boot = critic(flat_states)[0]
        else:
            flat = truncated.reshape(t * n)
            position = torch.cumsum(flat.int(), 0) - 1
            slot = torch.where(flat & (position < n), position, n)  # slot n collects what is dropped
            rows = torch.arange(t * n, device=flat.device)
            index = torch.full((n + 1,), t * n, dtype=torch.long, device=flat.device).scatter_(0, slot, rows)[:n]
            values = critic(flat_states[index.clamp(max=t * n - 1)])[0]  # [N, Dr]
            boot = values.new_zeros(t * n + 1, values.shape[-1]).index_copy_(0, index, values)[:t * n]
        boot = boot.reshape(t, n, -1)
        last = torch.where(truncated[-1], boot[-1], critic(next_state[-1])[0])
        return torch.cat([boot[:-1], last[None]], 0)


class ValueLoss(Hook):
    """MSE or PPO-clipped value regression toward the computed returns; on a
    temporal minibatch the critic runs in sequence mode from the stored
    rollout-initial memory."""

    jax_config_fields = ("weight",)
    training_only = True
    batch_keys = ("value", "return", "observation", "state", "critic_memory", "done")

    def __init__(self, weight: float = 0.5, loss_clip: float | None = None, **kwargs):
        super().__init__(**kwargs)
        if weight <= 0:
            raise ValueError("'weight' must be positive")
        if loss_clip is not None and loss_clip <= 0:
            raise ValueError("'loss_clip' must be positive or None")
        self.weight = weight
        self.loss_clip = loss_clip

    def objective(self, agent, metadata, batch):
        if "curr_value" in batch:  # precomputed by JointPolicyValueEvaluation
            curr_value = batch["curr_value"]
        else:
            temporal = metadata.get("temporal", False)
            memory = batch.get("critic_memory")
            if temporal and memory is not None:
                memory = map_nested(lambda m: m[0], memory)
            curr_value, _, _ = agent.critic(get_first(batch, "state", "observation"), memory, sequential=temporal,
                                            done=batch.get("done"))
            batch["curr_value"] = curr_value
        value, returns = batch["value"], batch["return"]
        if self.loss_clip is None:
            loss = (curr_value - returns).square().mean()
        else:
            clipped = value + torch.clamp(curr_value - value, -self.loss_clip, self.loss_clip)
            loss = torch.maximum((curr_value - returns).square(), (clipped - returns).square()).mean()
        metrics = {"value": curr_value.detach().sum(-1).mean()}
        return {"value_loss": loss * self.weight}, metrics

"""Observation/state online normalization (counterpart of
``ObservationNormalization`` in ``cusrl_tpu/hook/mdp/observation.py``).

Statistics update policy, as in the JAX hook:
* ``post_step`` folds every ``next_observation`` (and ``next_state``) into
  the running statistics;
* ``pre_act`` also folds the rows that start an episode, which never appear
  as anyone's ``next_observation``: rows where ``first_step OR last_done``;
  with ``final_state_is_missing`` only the very first call folds anything.

``defer_updates=True`` accumulates raw ``(sum, sumsq, count)`` per stream
instead and folds them once per rollout in ``pre_update`` (statistics then lag
by at most one rollout).  ``store_originals`` keeps the raw values as
``original_*`` transition fields.  Every update runs on the device with
masks and ``torch.where`` (no host branch), in place on tensors listed in
``state_tensors()`` under the JAX field paths.  The environment spec's
mirror functions and ``observation_is_subset_of_state`` are not ported
(``EnvironmentSpec`` does not carry them yet), nor are ``renormalize`` and
the frozen (inference) mode; ``ObservationNanToNum`` waits.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["ObservationNormalization"]


def _zero_acc(dim: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return torch.zeros(dim, device=device), torch.zeros(dim, device=device), torch.zeros((), device=device)


@torch.no_grad()
def _accumulate(acc, data, mask) -> None:
    """Adds ``data``'s raw sums (rows where ``mask``) into ``acc`` in place."""
    data = data.float().reshape(-1, data.shape[-1])
    total, sumsq, count = acc
    if mask is not None:
        w = mask.float().reshape(-1, 1)
        total.add_((data * w).sum(0))
        sumsq.add_((data.square() * w).sum(0))
        count.add_(w.sum())
    else:
        total.add_(data.sum(0))
        sumsq.add_(data.square().sum(0))
        count.add_(float(data.shape[0]))


def _finalize_acc(acc):
    total, sumsq, count = acc
    safe = torch.clamp(count, min=1.0)
    mean = total / safe
    var = torch.clamp(sumsq / safe - mean.square(), min=0.0)
    return mean, var, count


class ObservationNormalization(Hook):
    def __init__(self, max_count: float | None = None, defer_updates: bool = False, store_originals: bool = True,
                 **kwargs):
        super().__init__(**kwargs)
        self.max_count = max_count
        self.defer_updates = defer_updates
        self.store_originals = store_originals
        self.observation_rms: RunningMeanStd | None = None
        self.state_rms: RunningMeanStd | None = None
        self.obs_acc = self.state_acc = None
        self.last_done = self.first_step = None
        self.final_state_is_missing = False

    def init(self, agent) -> None:
        spec = agent.environment_spec
        for name in ("mirror_observation", "mirror_state", "observation_is_subset_of_state"):
            if getattr(spec, name, None) is not None:
                raise NotImplementedError(f"ObservationNormalization with '{name}' is not ported yet")
        device = agent.device
        self.observation_rms = RunningMeanStd(
            spec.observation_dim, max_count=self.max_count, groups=spec.observation_stat_groups,
            excluded_indices=spec.observation_normalization_excluded_indices, device=device,
        )
        if spec.has_state:
            self.state_rms = RunningMeanStd(
                spec.state_dim, max_count=self.max_count, groups=spec.state_stat_groups,
                excluded_indices=spec.state_normalization_excluded_indices, device=device,
            )
        if self.defer_updates:
            self.obs_acc = _zero_acc(spec.observation_dim, device)
            if spec.has_state:
                self.state_acc = _zero_acc(spec.state_dim, device)
        self.final_state_is_missing = spec.final_state_is_missing
        self.last_done = torch.zeros(spec.num_instances, 1, dtype=torch.bool, device=device)
        self.first_step = torch.ones((), dtype=torch.bool, device=device)

    def state_tensors(self) -> dict[str, torch.Tensor]:
        tensors: dict[str, torch.Tensor] = {}
        for name, rms in (("observation_rms", self.observation_rms), ("state_rms", self.state_rms)):
            if rms is not None:
                tensors.update({f"{name}.mean": rms.mean, f"{name}.var": rms.var, f"{name}.count": rms.count})
        for name, acc in (("obs_acc", self.obs_acc), ("state_acc", self.state_acc)):
            if acc is not None:
                tensors.update({f"{name}.{i}": t for i, t in enumerate(acc)})
        if self.last_done is not None:
            tensors.update(last_done=self.last_done, first_step=self.first_step)
        return tensors

    # -- statistics updates ----------------------------------------------------

    def _update(self, observation, state, mask) -> None:
        if self.defer_updates:
            _accumulate(self.obs_acc, observation, mask)
            if state is not None and self.state_acc is not None:
                _accumulate(self.state_acc, state, mask)
            return
        if state is not None and self.state_rms is not None:
            self.state_rms.update(state, mask=mask)
        self.observation_rms.update(observation, mask=mask)

    # -- lifecycle ---------------------------------------------------------------

    @torch.no_grad()
    def pre_act(self, agent, transition: dict) -> None:
        observation = transition["observation"]
        env_state = transition.get("state")
        rows = observation.shape[:-1]
        if not self.final_state_is_missing:
            mask = self.first_step | self.last_done.reshape(rows)
        else:
            mask = self.first_step.expand(rows)
        self._update(observation, env_state, mask)
        self.first_step.fill_(False)
        if self.store_originals:
            transition["original_observation"] = observation
        transition["observation"] = self.observation_rms.normalize(observation)
        if self.state_rms is not None and env_state is not None:
            if self.store_originals:
                transition["original_state"] = env_state
            transition["state"] = self.state_rms.normalize(env_state)

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        next_observation = transition["next_observation"]
        next_state = transition.get("next_state")
        self._update(next_observation, next_state, None)
        self.last_done.copy_(transition["done"].reshape(self.last_done.shape))
        if self.store_originals:
            transition["original_next_observation"] = next_observation
        transition["next_observation"] = self.observation_rms.normalize(next_observation)
        if self.state_rms is not None and next_state is not None:
            if self.store_originals:
                transition["original_next_state"] = next_state
            transition["next_state"] = self.state_rms.normalize(next_state)

    @torch.no_grad()
    def pre_update(self, agent, rollout: dict) -> dict:
        if not self.defer_updates:
            return {}
        # Fold the rollout's raw sums into the running statistics once.
        self.observation_rms.update_from_stats(*_finalize_acc(self.obs_acc))
        if self.state_acc is not None and self.state_rms is not None:
            self.state_rms.update_from_stats(*_finalize_acc(self.state_acc))
        for acc in (self.obs_acc, self.state_acc):
            for t in acc or ():
                t.zero_()
        return {}

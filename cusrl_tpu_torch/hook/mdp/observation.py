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
by at most one rollout).  Under a data-parallel agent every fold takes
all ranks' rows, as the JAX package's mesh gives them by construction: the
batch's ``(mean, var, count)`` merged across ranks
(``utils.distributed.merge_moments``), or the deferred ``(sum, sumsq,
count)`` all-reduced, before the update of the running statistics, so the
ranks' statistics stay equal.  ``store_originals`` keeps the raw values as
``original_*`` transition fields.  With the environment spec's mirror
functions every fold takes the statistics of the batch and its mirror image
together (JAX ``observation.py:159-163,257-259``): the batch's moments, merged
across ranks first under a process group, then averaged with their mirror,
which is what one process would fold from every rank's rows.  With
``observation_is_subset_of_state`` the observation's statistics are the
state's at those indices, copied after each fold.  ``renormalize`` is not
ported.  Every update runs on the device with masks and ``torch.where`` (no
host branch), in place on tensors listed in ``state_tensors()`` under the JAX
field paths.  In inference mode (``set_inference_mode``, the Player's) the
hook is frozen: it normalizes and updates nothing.  At export it puts the
observation statistics ahead of the actor (``pre_export``).

``ObservationNanToNum`` replaces NaN and infinities in observations and
states (JAX ``observation.py:53``).
"""

from __future__ import annotations

import numpy as np
import torch

from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.nn.utils.normalization import mean_var_count
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils import distributed

__all__ = ["ObservationNanToNum", "ObservationNormalization"]


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


def _finalize_acc(acc, group=None):
    total, sumsq, count = acc
    if group is not None:
        total, sumsq, count = distributed.weighted_sum(torch.cat([total, sumsq, count.reshape(1)]), 1.0,
                                                       group).split([total.shape[0], sumsq.shape[0], 1])
        count = count.reshape(())
    safe = torch.clamp(count, min=1.0)
    mean = total / safe
    var = torch.clamp(sumsq / safe - mean.square(), min=0.0)
    return mean, var, count


def _mirror_moments(mean, var, count, mirror):
    """The moments of a batch and its mirror image together."""
    if mirror is not None:
        m_mean = mirror(mean)
        m_var = mirror(var).abs()
        var = (var + m_var) / 2 + (mean - m_mean).square() / 4
        mean = (mean + m_mean) / 2
    return mean, var, count


@torch.no_grad()
def _fold(rms: RunningMeanStd, data, mask, group, mirror=None) -> None:
    """Folds ``data`` (rows where ``mask``) into ``rms``: every rank's rows
    under a process ``group``, with their mirror image where ``mirror``."""
    moments = mean_var_count(data, mask=mask)
    if group is not None:
        moments = distributed.merge_moments(*moments, group)
    rms.update_from_stats(*_mirror_moments(*moments, mirror))


class ObservationNanToNum(Hook):
    """Replaces NaN, +inf and -inf in observations and states (``None``:
    the dtype's largest finite values, as ``torch.nan_to_num``)."""

    jax_config_fields = ("nan", "posinf", "neginf")

    def __init__(self, nan: float = 0.0, posinf: float | None = None, neginf: float | None = None, **kwargs):
        super().__init__(**kwargs)
        self.nan = nan
        self.posinf = posinf
        self.neginf = neginf

    def _clean(self, transition: dict, *keys: str) -> None:
        for key in keys:
            if transition.get(key) is not None:
                transition[key] = torch.nan_to_num(transition[key], nan=self.nan, posinf=self.posinf,
                                                   neginf=self.neginf)

    def pre_act(self, agent, transition: dict) -> None:
        self._clean(transition, "observation", "state")

    def post_step(self, agent, transition: dict) -> None:
        self._clean(transition, "next_observation", "next_state")


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
        self.frozen = False
        self.mirror_observation = self.mirror_state = None
        self.subset_index: torch.Tensor | None = None

    def set_inference_mode(self, inference: bool) -> None:
        self.frozen = self.frozen or inference

    def init(self, agent) -> None:
        spec = agent.environment_spec
        device = agent.device
        subset = spec.observation_is_subset_of_state
        if subset is not None:
            if not spec.has_state:
                raise ValueError("'observation_is_subset_of_state' set without a state")
            subset = [int(i) for i in np.atleast_1d(np.asarray(subset)).tolist()]
            self.subset_index = torch.tensor(subset, dtype=torch.long, device=device)
            self.observation_rms = RunningMeanStd(spec.observation_dim, device=device)
        else:
            self.observation_rms = RunningMeanStd(
                spec.observation_dim, max_count=self.max_count, groups=spec.observation_stat_groups,
                excluded_indices=spec.observation_normalization_excluded_indices, device=device,
            )
        self.mirror_observation, self.mirror_state = spec.mirror_observation, spec.mirror_state
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

    def _update(self, agent, observation, state, mask) -> None:
        if self.frozen:
            return
        if self.defer_updates:
            _accumulate(self.obs_acc, observation, mask)
            if state is not None and self.state_acc is not None:
                _accumulate(self.state_acc, state, mask)
            return
        group = getattr(agent, "process_group", None)
        if state is not None and self.state_rms is not None:
            _fold(self.state_rms, state, mask, group, self.mirror_state)
        if self.subset_index is not None:
            self._copy_subset_stats()
        else:
            _fold(self.observation_rms, observation, mask, group, self.mirror_observation)

    def _copy_subset_stats(self) -> None:
        obs, state = self.observation_rms, self.state_rms
        obs.mean.copy_(state.mean.index_select(0, self.subset_index))
        obs.var.copy_(state.var.index_select(0, self.subset_index))
        obs.count.copy_(state.count)

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
        self._update(agent, observation, env_state, mask)
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
        self._update(agent, next_observation, next_state, None)
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
        if not self.defer_updates or self.frozen:
            return {}
        # Fold the rollout's raw sums into the running statistics once.
        group = getattr(agent, "process_group", None)
        if self.subset_index is None:
            self.observation_rms.update_from_stats(
                *_mirror_moments(*_finalize_acc(self.obs_acc, group), self.mirror_observation))
        if self.state_acc is not None and self.state_rms is not None:
            self.state_rms.update_from_stats(*_mirror_moments(*_finalize_acc(self.state_acc, group),
                                                              self.mirror_state))
        if self.subset_index is not None:
            self._copy_subset_stats()
        for acc in (self.obs_acc, self.state_acc):
            for t in acc or ():
                t.zero_()
        return {}

    def pre_export(self, agent, graph) -> None:
        graph.add_normalization("observation_rms", self.observation_rms, input_name="observation")

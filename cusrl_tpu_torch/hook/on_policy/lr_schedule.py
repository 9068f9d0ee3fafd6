"""KL-targeted learning-rate control (counterpart of
``cusrl_tpu/hook/on_policy/lr_schedule.py``: ``AdaptiveLRSchedule``,
``ThresholdLRSchedule`` and ``MiniBatchWiseLRSchedule``).

After each update the hook reads the post-update KL over the whole rollout
(``compute_rollout_kl``, shared with ``OnPolicyStatistics``), adapts
``lr_scale`` and writes ``base_lr * lr_scale`` into the actor's optimizer
groups.  ``lr_scale``, ``accumulated_log_error`` and ``error_count`` are 0-d
device tensors and the groups' learning rates are device tensors too
(``Optimizer.use_device_learning_rates``), so nothing here waits on the device.
With ``max_kl_divergence`` an update whose KL exceeds it is rejected:
parameters, optimizer state and every other hook's state are restored from
the pre-update snapshot by a device select (``torch.where``), while this
hook's adapted ``lr_scale`` is kept, as in the JAX hook.
``MiniBatchWiseLRSchedule`` adapts per minibatch instead: its ``objective``
scales ``lr_scale`` by the minibatch's mean KL (``OnPolicyPreparation``'s
``kl_divergence``, which its ``post_init`` turns on) and its ``pre_optim``
writes ``base_lr * lr_scale`` into every group before the step, all on the
device.  Under a data-parallel agent the minibatch's KL is the global
minibatch's: the ranks' means weighted by their row shares, one all-reduce
on the device, so every rank takes the same rate.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.hook.on_policy.stats import compute_rollout_kl
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils import distributed

__all__ = ["AdaptiveLRSchedule", "MiniBatchWiseLRSchedule", "ThresholdLRSchedule"]


class _KLDivergenceBasedLRSchedule(Hook):
    training_only = True
    jax_config_fields = ("desired_kl_divergence",)

    def __init__(self, desired_kl_divergence: float = 0.01, *, max_kl_divergence: float | None = None,
                 scale_all_params: bool = False, warmup_iterations: int = 0, initial_scale: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.desired_kl_divergence = desired_kl_divergence
        self.max_kl_divergence = max_kl_divergence
        self.scale_all_params = scale_all_params
        self.warmup_iterations = warmup_iterations
        self.initial_scale = initial_scale
        self.needs_snapshot = max_kl_divergence is not None
        self.target_groups: tuple[str, ...] = ()
        self.base_lrs: dict[str, float] = {}
        self.lr_scale: torch.Tensor | None = None

    def _state_names(self) -> tuple[str, ...]:
        return ("lr_scale",)

    def init(self, agent) -> None:
        for name in self._state_names():
            setattr(self, name, torch.full((), 1.0 if name == "lr_scale" else 0.0, device=agent.device))

    def state_tensors(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._state_names()}

    def post_init(self, agent) -> None:
        # Every group, or the groups holding actor parameters.
        optimizer = agent.optimizer
        actor_groups = {g for path, g in optimizer.labels.items() if path.startswith("actor")}
        if self.scale_all_params:
            groups = tuple(optimizer.group_names)
        else:
            groups = tuple(sorted(actor_groups)) or tuple(optimizer.group_names)
        self.target_groups = groups
        self.base_lrs = {g: optimizer.base_learning_rates[g] for g in groups}
        optimizer.use_device_learning_rates()

    def _compute_scale(self, kl: torch.Tensor) -> torch.Tensor:
        """Updates the hook's accumulators; returns the multiplicative scale."""
        raise NotImplementedError

    @torch.no_grad()
    def advance(self, kl: torch.Tensor, iteration: int) -> torch.Tensor:
        """One post-update step of the schedule for ``kl`` after update
        ``iteration``: returns the new ``lr_scale`` (also stored in place)."""
        scale = self._compute_scale(kl)
        if iteration >= self.warmup_iterations:
            self.lr_scale.mul_(scale)
        return self.lr_scale

    def _apply_scale(self, agent) -> None:
        for group in self.target_groups:
            agent.optimizer.set_learning_rate(group, self.base_lrs[group] * self.lr_scale)

    @torch.no_grad()
    def post_update(self, agent, rollout: dict, snapshot=None) -> dict:
        kl, _ = compute_rollout_kl(agent, rollout)
        lr_scale = self.advance(kl, agent.iteration)
        self._apply_scale(agent)
        metrics = {"lr_scale": lr_scale.clone(), "kl_divergence": kl}
        if self.max_kl_divergence is not None:
            reject = kl > self.max_kl_divergence
            agent.restore_snapshot(snapshot, reject, keep=self)
            metrics["update_rejected"] = reject.float()
        return metrics

    def schedule_is_noop(self, iteration: int) -> bool:
        return self.warmup_iterations <= 0 or iteration > self.warmup_iterations

    def apply_schedule(self, iteration: int, agent=None) -> None:
        if self.schedule_is_noop(iteration):
            return
        progress = min(iteration, self.warmup_iterations) / self.warmup_iterations
        self.lr_scale.fill_(self.initial_scale + (1.0 - self.initial_scale) * progress)


class ThresholdLRSchedule(_KLDivergenceBasedLRSchedule):
    """Scales the learning rate down/up by ``scale_factor`` when the KL leaves
    the band ``[desired / threshold, desired * threshold]``."""

    def __init__(self, desired_kl_divergence: float = 0.01, *, threshold: float = 1.2, scale_factor: float = 1.1,
                 **kwargs):
        super().__init__(desired_kl_divergence, **kwargs)
        self.threshold = threshold
        self.scale_factor = scale_factor

    def _compute_scale(self, kl):
        desired = self.desired_kl_divergence
        return torch.where(kl > desired * self.threshold, 1.0 / self.scale_factor,
                           torch.where(kl < desired / self.threshold, self.scale_factor, 1.0))


class AdaptiveLRSchedule(_KLDivergenceBasedLRSchedule):
    """Integrates the log KL error; rescales once the accumulator crosses
    ``threshold``."""

    def __init__(self, desired_kl_divergence: float = 0.01, *, threshold: float = 1.0, scale_factor: float = 0.2,
                 **kwargs):
        super().__init__(desired_kl_divergence, **kwargs)
        self.threshold = threshold
        self.scale_factor = scale_factor
        self.accumulated_log_error: torch.Tensor | None = None
        self.error_count: torch.Tensor | None = None

    def _state_names(self) -> tuple[str, ...]:
        return ("lr_scale", "accumulated_log_error", "error_count")

    def _compute_scale(self, kl):
        kl = torch.clamp(kl.float(), min=1e-5)
        acc = self.accumulated_log_error + torch.log(kl / self.desired_kl_divergence)
        count = self.error_count + 1.0
        trigger = acc.abs() >= self.threshold
        scale = torch.where(trigger, torch.exp(-torch.clamp(acc / count, -1.0, 1.0) * self.scale_factor), 1.0)
        self.accumulated_log_error.copy_(torch.where(trigger, 0.0, acc))
        self.error_count.copy_(torch.where(trigger, 0.0, count))
        return scale


class MiniBatchWiseLRSchedule(ThresholdLRSchedule):
    """Per-minibatch threshold control (rsl-rl style) of every group's rate."""

    def __init__(self, desired_kl_divergence: float = 0.01, *, threshold: float = 2.0, scale_factor: float = 1.5,
                 scale_all_params: bool = True, **kwargs):
        super().__init__(desired_kl_divergence, threshold=threshold, scale_factor=scale_factor,
                         scale_all_params=scale_all_params, **kwargs)

    def post_init(self, agent) -> None:
        from cusrl_tpu_torch.hook.on_policy.common import OnPolicyPreparation

        for hook in agent.hooks:
            if isinstance(hook, OnPolicyPreparation):
                hook.calculate_kl_divergence = True
        super().post_init(agent)

    def post_update(self, agent, rollout: dict, snapshot=None) -> dict:
        return {}

    def objective(self, agent, metadata, batch):
        if "kl_divergence" not in batch:
            raise RuntimeError("MiniBatchWiseLRSchedule requires 'kl_divergence' from OnPolicyPreparation")
        with torch.no_grad():
            kl = batch["kl_divergence"].mean()
            group = getattr(agent, "process_group", None)
            if group is not None:
                kl = distributed.weighted_sum(kl, agent.row_share, group)
            scale = self._compute_scale(kl)
            if agent.iteration >= self.warmup_iterations:
                self.lr_scale.mul_(scale)
        return None, {"lr_scale": self.lr_scale.clone()}

    def pre_optim(self, agent) -> dict:
        self._apply_scale(agent)
        return {}

"""Adversarial Motion Priors (counterpart of ``cusrl_tpu/hook/auxiliary/amp.py``).

A discriminator learns to tell the agent's transitions ``(s_t, s_{t+1})``
from expert ones; ``post_step`` adds the style reward
``reward_scale * -log(max(1 - sigmoid(D(x)), 1e-4))`` to the environment's
reward, and the objective trains the discriminator with BCE on logits
(agent rows 0, expert rows 1) plus the gradient penalty at the expert rows,
``E[||dD/dx||^2]``, which differentiates the discriminator twice: it runs its
plain layers (``fused_kernel=False``).

The expert dataset is resident on the agent's device: a ``.npy`` path, an
array, a callable (called with ``device=`` the agent's device when it takes
that keyword) or, without a source, ``demonstration_prefetch`` transitions
from the environment spec's ``demonstration_sampler``, drawn once at
``init``.  The hook draws expert rows and minibatch subsamples from its own
``torch.Generator`` on the device; ``queue_draws`` hands it indices to take
first, so a test can give two implementations the same draws.

As in the JAX package, ``MlpFactory(ends_with_activation=True)`` applies the
activation after the 1-wide output layer too, so with relu the logit is
never below 0: the agent is never classified as such, ``amp_accuracy`` is at
most 0.5 and the style reward at least ``reward_scale * log 2``.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np
import torch

from cusrl_tpu_torch.nn.layer.loss import gradient_penalty
from cusrl_tpu_torch.nn.layer.rms import RunningMeanStd
from cusrl_tpu_torch.template.hook import Hook
from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["AdversarialMotionPrior"]


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``mean(max(l, 0) - l t + log1p(exp(-|l|)))`` in the logits' dtype, the
    JAX hook's formula."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs())))


class AdversarialMotionPrior(Hook):
    # JAX state fields that are configuration here; the JAX hook's PRNG key
    # is not carried (the port's stream is a torch.Generator of its own).
    jax_config_fields = ("reward_scale", "loss_weight", "grad_penalty_weight", "rng")
    batch_keys = ("agent_transition", "expert_transition")

    def __init__(
        self,
        discriminator_factory=None,
        dataset_source: Any = None,
        state_indices: tuple[int, ...] | None = None,
        demonstration_prefetch: int = 65536,
        batch_size: int | None = 512,
        reward_scale: float = 1.0,
        loss_weight: float = 1.0,
        grad_penalty_weight: float = 5.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.discriminator_factory = discriminator_factory
        self.dataset_source = dataset_source
        self.state_indices = None if state_indices is None else tuple(state_indices)
        self.demonstration_prefetch = demonstration_prefetch
        self.batch_size = batch_size
        self.reward_scale = reward_scale
        self.loss_weight = loss_weight
        self.grad_penalty_weight = grad_penalty_weight
        self.discriminator = None
        self.transition_rms: RunningMeanStd | None = None
        self.dataset: torch.Tensor | None = None
        self.generator: torch.Generator | None = None
        self._state_index = None
        self._expert_draws: list[torch.Tensor] = []
        self._subsample_draws: list[torch.Tensor] = []

    def _load_dataset(self, agent) -> torch.Tensor:
        source = self.dataset_source
        if isinstance(source, str):
            if not source.endswith(".npy"):
                raise ValueError(f"Unsupported dataset file format for '{source}'")
            dataset = np.load(source)
        elif isinstance(source, (np.ndarray, torch.Tensor)):
            dataset = source
        elif callable(source):
            takes_device = "device" in inspect.signature(source).parameters
            dataset = source(device=agent.device) if takes_device else source()
        elif source is not None:
            raise ValueError(f"Unsupported 'dataset_source' type: {type(source)}")
        else:
            sampler = agent.environment_spec.demonstration_sampler
            if sampler is None:
                raise ValueError("Provide 'dataset_source' or environment_spec.demonstration_sampler")
            dataset = sampler(self.demonstration_prefetch)
        if not isinstance(dataset, torch.Tensor):
            dataset = torch.from_numpy(np.asarray(dataset))
        return dataset.to(agent.device, torch.float32)

    def init(self, agent) -> None:
        self.dataset = self._load_dataset(agent)
        transition_dim = self.dataset.shape[-1]
        self.discriminator = self.discriminator_factory(transition_dim, 1, agent.init_generator)
        self.transition_rms = RunningMeanStd(transition_dim, device=agent.device)
        seed = int(torch.randint(0, 2**62, (), generator=agent.init_generator))
        self.generator = torch.Generator(device=agent.device).manual_seed(seed)
        if self.state_indices is not None:
            self._state_index = torch.tensor(self.state_indices, dtype=torch.long, device=agent.device)

    def trainable_modules(self) -> dict:
        return {"discriminator": self.discriminator}

    def state_tensors(self) -> dict[str, torch.Tensor]:
        rms = self.transition_rms
        return {"transition_rms.mean": rms.mean, "transition_rms.var": rms.var, "transition_rms.count": rms.count,
                "dataset": self.dataset}

    # -- randomness --------------------------------------------------------------

    def queue_draws(self, expert=(), subsample=()) -> None:
        """Indices the hook takes, in order, before it draws its own: each
        ``expert`` entry for one ``post_step`` (``[N]`` rows of the dataset),
        each ``subsample`` entry for one objective (``[batch_size]`` rows of
        the flattened minibatch)."""
        device = self.dataset.device
        self._expert_draws += [torch.as_tensor(i, dtype=torch.long).to(device) for i in expert]
        self._subsample_draws += [torch.as_tensor(i, dtype=torch.long).to(device) for i in subsample]

    def _draw(self, queue: list, num: int, high: int) -> torch.Tensor:
        if queue:
            return queue.pop(0)
        return torch.randint(0, high, (num,), generator=self.generator, device=self.dataset.device)

    # -- lifecycle ---------------------------------------------------------------

    def _logit(self, x: torch.Tensor) -> torch.Tensor:
        return self.discriminator(x)[0]

    @torch.no_grad()
    def post_step(self, agent, transition: dict) -> None:
        agent_transition = transition.pop("amp_obs", None)
        if agent_transition is None:
            if self._state_index is None:
                raise ValueError("AMP observations not provided and 'state_indices' is not set")
            obs = get_first(transition, "state", "observation").index_select(-1, self._state_index)
            next_obs = get_first(transition, "next_state", "next_observation").index_select(-1, self._state_index)
            agent_transition = torch.cat([obs, next_obs], dim=-1)
        indices = self._draw(self._expert_draws, agent_transition.shape[0], self.dataset.shape[0])
        expert_transition = self.dataset[indices]
        self.transition_rms.update(agent_transition)
        self.transition_rms.update(expert_transition)
        agent_transition = self.transition_rms.normalize(agent_transition)
        transition["agent_transition"] = agent_transition
        transition["expert_transition"] = self.transition_rms.normalize(expert_transition)
        # In the logit's dtype (bf16 under the default compute dtype), scaled
        # in fp32: the JAX hook's arithmetic, its sigmoid as XLA expands it
        # (1 / (1 + exp(-x)), each step rounded to the logit's dtype).
        logit = self._logit(agent_transition)
        sigmoid = 1.0 / (1.0 + torch.exp(-logit))
        neg_log = -torch.log(torch.clamp(1.0 - sigmoid, min=1e-4))
        transition["reward"] = transition["reward"] + self.reward_scale * neg_log.float()

    def objective(self, agent, metadata: dict, batch: dict):
        width = batch["agent_transition"].shape[-1]
        agent_transition = batch["agent_transition"].reshape(-1, width)
        expert_transition = batch["expert_transition"].reshape(-1, width)
        if self.batch_size is not None:
            indices = self._draw(self._subsample_draws, self.batch_size, agent_transition.shape[0])
            agent_transition = agent_transition[indices]
            expert_transition = expert_transition[indices]
        agent_logit = self._logit(agent_transition)
        expert_logit = self._logit(expert_transition)
        discrimination_loss = 0.5 * (_bce_with_logits(agent_logit, torch.zeros_like(agent_logit))
                                     + _bce_with_logits(expert_logit, torch.ones_like(expert_logit)))
        # E[||dD(x)/dx||^2] at the expert rows, differentiable once more.
        grad_penalty = gradient_penalty(self._logit, expert_transition)
        objectives = {
            "amp_discrimination_loss": discrimination_loss.float() * self.loss_weight,
            "amp_grad_penalty_loss": grad_penalty * (self.grad_penalty_weight * self.loss_weight),
        }
        with torch.no_grad():
            accuracy = 0.5 * ((agent_logit < 0).float().mean() + (expert_logit > 0).float().mean())
        return objectives, {"amp_accuracy": accuracy}

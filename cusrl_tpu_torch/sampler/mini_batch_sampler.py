"""Mini-batch samplers, non-temporal branch (counterpart of
``cusrl_tpu/sampler/mini_batch_sampler.py``).

One permutation per epoch over the flattened ``[T*N]`` rollout, at tile
granularity, as the JAX sampler's default ``shuffle_block_size="auto"``:
128-row tiles whenever the rollout and the minibatch both divide into them
(each minibatch is then a gather of whole tiles); otherwise rows.  The JAX
sampler's other shuffle settings are not ported yet.  Each epoch covers every
transition once; the ``total % num_mini_batches`` remainder is dropped.  The
epoch permutations can be injected (``epoch_perms``), so a test can hand in
the JAX sampler's plan.
"""

from __future__ import annotations

import dataclasses

import torch

from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["AutoMiniBatchSampler", "EpochPlan", "MiniBatchSampler"]

TILE = 128


@dataclasses.dataclass
class EpochPlan:
    block: int            # rows per permuted unit (1 = row permutation)
    batch_size: int
    num_mini_batches: int
    perms: torch.Tensor   # [num_epochs, total // block] int64


@dataclasses.dataclass
class MiniBatchSampler:
    num_epochs: int = 1
    num_mini_batches: int = 1

    def __post_init__(self):
        if self.num_epochs <= 0:
            raise ValueError("'num_epochs' must be positive")
        if not isinstance(self.num_mini_batches, int):
            raise NotImplementedError("per-epoch minibatch counts are not ported yet")
        if self.num_mini_batches <= 0:
            raise ValueError("'num_mini_batches' must be positive")

    def _resolve_block(self, total: int, batch_size: int) -> int:
        """``shuffle_block_size="auto"`` of the JAX sampler."""
        if total % TILE or batch_size % TILE or total // TILE < self.num_mini_batches:
            return 1
        return TILE

    def make_epoch_plan(self, capacity: int, parallelism: int, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu", epoch_perms=None) -> EpochPlan:
        total = capacity * parallelism
        count = self.num_mini_batches
        if count > total:
            raise ValueError(f"'num_mini_batches' ({count}) exceeds sample count ({total})")
        batch_size = total // count
        block = self._resolve_block(total, batch_size)
        units = total // block
        if epoch_perms is not None:
            perms = torch.as_tensor(epoch_perms, dtype=torch.int64, device=device)
            if perms.shape != (self.num_epochs, units):
                raise ValueError(f"epoch_perms must be [{self.num_epochs}, {units}]; got {tuple(perms.shape)}")
        else:
            perms = torch.stack(
                [torch.randperm(units, generator=generator, device=device) for _ in range(self.num_epochs)]
            )
        return EpochPlan(block, batch_size, count, perms)

    def gather(self, flat: dict, plan: EpochPlan, epoch: int, mini_batch: int) -> dict:
        """Minibatch ``mini_batch`` of epoch ``epoch`` from the flattened
        ``[T*N, ...]`` rollout: a gather of whole tiles, or of rows."""
        perm = plan.perms[epoch]
        if plan.block > 1:
            per_batch = plan.batch_size // plan.block
            idx = perm[mini_batch * per_batch : (mini_batch + 1) * per_batch]
            return map_nested(
                lambda x: x.reshape(-1, plan.block, *x.shape[1:])[idx].reshape(plan.batch_size, *x.shape[1:]), flat
            )
        idx = perm[mini_batch * plan.batch_size : (mini_batch + 1) * plan.batch_size]
        return map_nested(lambda x: x[idx], flat)


@dataclasses.dataclass
class AutoMiniBatchSampler(MiniBatchSampler):
    """Temporal iff the rollout carries recurrent memory; only the
    non-temporal branch is ported, so a rollout with memory raises."""

    def check_rollout(self, rollout: dict) -> None:
        if any(key.endswith("memory") for key in rollout):
            raise NotImplementedError("temporal (recurrent) minibatch sampling is not ported yet")

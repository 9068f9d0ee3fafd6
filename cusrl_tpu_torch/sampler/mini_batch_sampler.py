"""Mini-batch samplers (counterpart of ``cusrl_tpu/sampler/mini_batch_sampler.py``).

``MiniBatchSampler`` permutes the flattened ``[T*N]`` rollout once per
epoch, at tile granularity, as the JAX sampler's default
``shuffle_block_size="auto"``: 128-row tiles whenever the rollout and the
minibatch both divide into them (each minibatch is then a gather of whole
tiles); otherwise rows.  ``TemporalMiniBatchSampler`` (recurrent backbones)
takes whole environments over all T steps: the same rule over the N
environments, 128-environment tiles, and the gather indexes the tiled view
of the environment axis, so memory entries stored as ``[1, N, ...]`` follow
their environments.  ``AutoMiniBatchSampler`` is temporal iff the rollout
carries memory.  The JAX sampler's other shuffle settings and per-epoch
minibatch counts are not ported yet.  Each epoch covers every transition (or
environment) once; the ``total % num_mini_batches`` remainder is dropped.
The epoch permutations can be injected (``epoch_perms``), so a test can hand
in the JAX sampler's plan.

Under a data-parallel agent (``parallel.distribute_agent``) the plan covers
the global batch: ``W`` ranks' ``[T, N]`` rollouts gathered on the
environment axis, so global row ``t * W * N + r * N + n`` is rank ``r``'s
row ``(t, n)``, drawn from a generator that is the same on every rank.  Each
rank gathers only its own slice of each global minibatch's rows
(``shard_rows``: equal parts, the first ``B % W`` ranks one row more), and
its share of the rows weights its gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["AutoMiniBatchSampler", "EpochPlan", "MiniBatchSampler", "TemporalMiniBatchSampler", "shard_rows"]

TILE = 128


def shard_rows(batch_size: int, rank: int, world_size: int) -> tuple[int, int]:
    """Rank ``rank``'s ``[start, stop)`` of a ``batch_size``-row minibatch."""
    base, extra = divmod(batch_size, world_size)
    start = rank * base + min(rank, extra)
    stop = start + base + (rank < extra)
    if stop == start:
        raise ValueError(f"a {batch_size}-row minibatch leaves rank {rank} of {world_size} no rows")
    return start, stop


@dataclasses.dataclass
class EpochPlan:
    block: int            # samples per permuted unit (1 = sample permutation)
    batch_size: int       # samples per minibatch (rows, or environments when temporal)
    num_mini_batches: int
    perms: torch.Tensor   # [num_epochs, total // block] int64


@dataclasses.dataclass
class MiniBatchSampler:
    num_epochs: int = 1
    num_mini_batches: int = 1

    temporal = False

    def __post_init__(self):
        if self.num_epochs <= 0:
            raise ValueError("'num_epochs' must be positive")
        if not isinstance(self.num_mini_batches, int):
            raise NotImplementedError("per-epoch minibatch counts are not ported yet")
        if self.num_mini_batches <= 0:
            raise ValueError("'num_mini_batches' must be positive")

    def resolve(self, rollout: dict) -> "MiniBatchSampler":
        """The sampler that serves this rollout."""
        return self

    def _num_samples(self, capacity: int, parallelism: int) -> int:
        return capacity * parallelism

    def _resolve_block(self, total: int, batch_size: int) -> int:
        """``shuffle_block_size="auto"`` of the JAX sampler."""
        if total % TILE or batch_size % TILE or total // TILE < self.num_mini_batches:
            return 1
        return TILE

    def make_epoch_plan(self, capacity: int, parallelism: int, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu", epoch_perms=None) -> EpochPlan:
        total = self._num_samples(capacity, parallelism)
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

    def source(self, rollout: dict) -> dict:
        """The rollout fields in the layout ``gather`` indexes: ``[T*N, ...]``."""
        return {key: map_nested(lambda x: x.reshape(-1, *x.shape[2:]), value) for key, value in rollout.items()}

    def metadata(self, plan: EpochPlan, epoch: int, mini_batch: int) -> dict:
        """What the hooks see of minibatch ``mini_batch`` of epoch ``epoch``."""
        return {"total_epochs": self.num_epochs, "total_mini_batches": plan.num_mini_batches, "epoch_index": epoch,
                "mini_batch_index": mini_batch, "temporal": self.temporal}

    def _indices(self, plan: EpochPlan, epoch: int, mini_batch: int) -> torch.Tensor:
        per_batch = plan.batch_size // plan.block
        return plan.perms[epoch][mini_batch * per_batch : (mini_batch + 1) * per_batch]

    def gather(self, source: dict, plan: EpochPlan, epoch: int, mini_batch: int,
               rows: tuple[int, int] | None = None) -> dict:
        """Minibatch ``mini_batch`` of epoch ``epoch``: a gather of whole
        tiles, or of rows; with ``rows``, only the minibatch's rows
        ``[start, stop)`` (the tiles that hold them)."""
        idx = self._indices(plan, epoch, mini_batch)
        start, stop = rows or (0, plan.batch_size)
        if plan.block > 1:
            first, last = start // plan.block, -(-stop // plan.block)
            offset = first * plan.block
            return map_nested(
                lambda x: x.reshape(-1, plan.block, *x.shape[1:])[idx[first:last]].reshape(-1, *x.shape[1:])[
                    start - offset: stop - offset], source
            )
        return map_nested(lambda x: x[idx[start:stop]], source)


@dataclasses.dataclass
class TemporalMiniBatchSampler(MiniBatchSampler):
    """Whole environments over all T steps (``[T, B, ...]`` minibatches)."""

    temporal = True

    def _num_samples(self, capacity: int, parallelism: int) -> int:
        return parallelism

    def source(self, rollout: dict) -> dict:
        return rollout

    def gather(self, source: dict, plan: EpochPlan, epoch: int, mini_batch: int) -> dict:
        idx = self._indices(plan, epoch, mini_batch)
        if plan.block > 1:
            return map_nested(
                lambda x: x.reshape(x.shape[0], -1, plan.block, *x.shape[2:])[:, idx].reshape(
                    x.shape[0], plan.batch_size, *x.shape[2:]), source
            )
        return map_nested(lambda x: x[:, idx], source)


@dataclasses.dataclass
class AutoMiniBatchSampler(MiniBatchSampler):
    """Temporal iff the rollout carries recurrent memory (a key ending in
    "memory")."""

    def resolve(self, rollout: dict) -> MiniBatchSampler:
        temporal = any(key.endswith("memory") for key in rollout)
        cls = TemporalMiniBatchSampler if temporal else MiniBatchSampler
        return cls(self.num_epochs, self.num_mini_batches)

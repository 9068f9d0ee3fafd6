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
carries memory.  ``shuffle_block_size`` set to an integer takes tiles of
that many rows (it must divide the rollout and the minibatch, else
``ValueError``, as in JAX); 1 permutes rows.  ``shuffle=False`` keeps the
rollout's order.  ``num_mini_batches`` may be a sequence, one count per
epoch: the plan is then a list of ``EpochPlan`` segments, one per run of
equal counts (``epoch_segments``, the JAX sampler's), each with its own
tile size and minibatch size.  Each epoch covers every transition (or
environment) once; the ``total % num_mini_batches`` remainder is dropped.
The epoch permutations can be injected (``epoch_perms``; a list with one
array per segment), so a test can hand in the JAX sampler's plan.

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
    epoch_start: int = 0  # the segment's first epoch

    @property
    def num_epochs(self) -> int:
        return self.perms.shape[0]


@dataclasses.dataclass
class MiniBatchSampler:
    num_epochs: int = 1
    num_mini_batches: int | tuple[int, ...] = 1
    shuffle: bool = True
    shuffle_block_size: int | str = "auto"

    temporal = False

    def __post_init__(self):
        if self.num_epochs <= 0:
            raise ValueError("'num_epochs' must be positive")
        if isinstance(self.num_mini_batches, int):
            if self.num_mini_batches <= 0:
                raise ValueError("'num_mini_batches' must be positive")
        else:
            self.num_mini_batches = tuple(self.num_mini_batches)
            if len(self.num_mini_batches) != self.num_epochs:
                raise ValueError(
                    "'num_mini_batches' must be an integer or a sequence with one value per "
                    f"epoch ({self.num_epochs}); got {len(self.num_mini_batches)} values"
                )
            if any(value <= 0 for value in self.num_mini_batches):
                raise ValueError("'num_mini_batches' values must be positive")

    def resolve(self, rollout: dict) -> "MiniBatchSampler":
        """The sampler that serves this rollout."""
        return self

    def epoch_segments(self) -> list[tuple[int, int, int]]:
        """Contiguous ``(epoch_start, num_epochs, num_mini_batches)`` runs."""
        if isinstance(self.num_mini_batches, int):
            return [(0, self.num_epochs, self.num_mini_batches)]
        segments: list[tuple[int, int, int]] = []
        for epoch, count in enumerate(self.num_mini_batches):
            if segments and segments[-1][2] == count:
                start, length, _ = segments[-1]
                segments[-1] = (start, length + 1, count)
            else:
                segments.append((epoch, 1, count))
        return segments

    def _num_samples(self, capacity: int, parallelism: int) -> int:
        return capacity * parallelism

    def _resolve_block(self, total: int, batch_size: int, count: int) -> int:
        """The JAX sampler's ``shuffle_block_size`` rule for a segment of
        ``count`` minibatches."""
        block = self.shuffle_block_size
        if block == "auto":
            if total % TILE or batch_size % TILE or total // TILE < count:
                return 1
            return TILE
        block = int(block)
        if block > 1 and (total % block != 0 or batch_size % block != 0):
            raise ValueError(
                f"shuffle_block_size={block} must divide both the rollout ({total}) and the "
                f"mini-batch size ({batch_size})"
            )
        return max(block, 1)

    def make_epoch_plan(self, capacity: int, parallelism: int, generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu", epoch_perms=None) -> EpochPlan | list[EpochPlan]:
        """One ``EpochPlan``, or a list of segments for per-epoch counts."""
        total = self._num_samples(capacity, parallelism)
        segments = self.epoch_segments()
        given = [epoch_perms] if epoch_perms is not None and len(segments) == 1 else epoch_perms
        plans = []
        for index, (epoch_start, num_epochs, count) in enumerate(segments):
            if count > total:
                raise ValueError(f"'num_mini_batches' ({count}) exceeds sample count ({total})")
            batch_size = total // count
            block = self._resolve_block(total, batch_size, count)
            units = total // block
            if given is not None:
                perms = torch.as_tensor(given[index], dtype=torch.int64, device=device)
                if perms.shape != (num_epochs, units):
                    raise ValueError(f"epoch_perms must be [{num_epochs}, {units}]; got {tuple(perms.shape)}")
            elif self.shuffle:
                perms = torch.stack([torch.randperm(units, generator=generator, device=device)
                                     for _ in range(num_epochs)])
            else:
                perms = torch.arange(units, device=device).repeat(num_epochs, 1)
            plans.append(EpochPlan(block, batch_size, count, perms, epoch_start))
        return plans[0] if len(plans) == 1 else plans

    def source(self, rollout: dict) -> dict:
        """The rollout fields in the layout ``gather`` indexes: ``[T*N, ...]``."""
        return {key: map_nested(lambda x: x.reshape(-1, *x.shape[2:]), value) for key, value in rollout.items()}

    def metadata(self, plan: EpochPlan, epoch: int, mini_batch: int) -> dict:
        """What the hooks see of minibatch ``mini_batch`` of epoch ``epoch``
        (counted from the first epoch of the update)."""
        return {"total_epochs": self.num_epochs, "total_mini_batches": plan.num_mini_batches, "epoch_index": epoch,
                "mini_batch_index": mini_batch, "temporal": self.temporal}

    def _indices(self, plan: EpochPlan, epoch: int, mini_batch: int) -> torch.Tensor:
        per_batch = plan.batch_size // plan.block
        return plan.perms[epoch][mini_batch * per_batch : (mini_batch + 1) * per_batch]

    def gather(self, source: dict, plan: EpochPlan, epoch: int, mini_batch: int,
               rows: tuple[int, int] | None = None) -> dict:
        """Minibatch ``mini_batch`` of the plan's epoch ``epoch`` (counted
        from the segment's first): a gather of whole
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

    def _resolve_block(self, total: int, batch_size: int, count: int) -> int:
        # Unshuffled, the JAX sampler takes environments one by one.
        return super()._resolve_block(total, batch_size, count) if self.shuffle else 1

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
        return cls(self.num_epochs, self.num_mini_batches, self.shuffle, self.shuffle_block_size)

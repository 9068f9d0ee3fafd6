"""Running mean/std normalizer (counterpart of ``cusrl_tpu/nn/layer/rms.py``).

An ``nn.Module`` with fp32 buffers ``mean``, ``var`` and ``count``, updated in
place (the JAX module returns a new pytree; here the buffers keep their
identity, so a snapshot can be restored into them).  Channel groups share
statistics, excluded indices pass through unnormalized, counts can be capped
with ``max_count``, and an empty batch leaves the state as it was (a
``torch.where`` select, no host branch).
"""

from __future__ import annotations

import torch
from torch import nn

from cusrl_tpu_torch.nn.utils.normalization import mean_var_count, merge_mean_var

__all__ = ["RunningMeanStd"]


def _as_index_tuple(indices) -> tuple[int, ...]:
    if indices is None:
        return ()
    if isinstance(indices, slice):
        raise TypeError("Pass explicit index tuples, not slices.")
    if isinstance(indices, int):
        return (indices,)
    return tuple(int(i) for i in indices)


class RunningMeanStd(nn.Module):
    def __init__(
        self,
        num_channels: int,
        *,
        groups=(),
        excluded_indices=None,
        clamp: float | None = 10.0,
        max_count: float | None = None,
        epsilon: float = 1e-8,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if clamp is not None and clamp <= 0:
            raise ValueError("'clamp' must be None or positive")
        if max_count is not None and max_count <= 0:
            raise ValueError("'max_count' must be None or positive")
        self.groups = tuple(_as_index_tuple(g) for g in groups)
        self.excluded_indices = _as_index_tuple(excluded_indices)
        seen: set[int] = set()
        for g in self.groups:
            if seen & set(g):
                raise ValueError("Indices in 'groups' must not overlap")
            seen |= set(g)
        if seen & set(self.excluded_indices):
            raise ValueError("'excluded_indices' must not overlap with 'groups'")
        self.clamp = clamp
        self.max_count = max_count
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(num_channels, device=device))
        self.register_buffer("var", torch.ones(num_channels, device=device))
        self.register_buffer("count", torch.zeros((), device=device))

    @property
    def num_channels(self) -> int:
        return self.mean.shape[0]

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var + self.epsilon)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 ``(x - mean) / std``, clamped, cast back to ``x``'s dtype."""
        y = (x.float() - self.mean) / self.std
        if self.clamp is not None:
            y = torch.clamp(y, -self.clamp, self.clamp)
        return y.to(x.dtype)

    forward = normalize

    def _index(self, indices: tuple[int, ...]) -> torch.Tensor:
        """Device index tensor, made once (a fresh host-to-device copy per
        update would wait on the device)."""
        cache = self.__dict__.setdefault("_index_cache", {})
        key = (indices, self.mean.device)
        if key not in cache:
            cache[key] = torch.tensor(indices, dtype=torch.long, device=self.mean.device)
        return cache[key]

    def _process_batch_stats(self, batch_mean, batch_var):
        if self.excluded_indices:
            idx = self._index(self.excluded_indices)
            batch_mean = batch_mean.index_fill(0, idx, 0.0)
            batch_var = batch_var.index_fill(0, idx, 1.0)
        for group in self.groups:
            idx = self._index(group)
            g_mean = batch_mean.index_select(0, idx).mean()
            g_sq_mean = batch_mean.index_select(0, idx).square().mean()
            g_var = batch_var.index_select(0, idx).mean() - g_mean.square() + g_sq_mean
            batch_mean = batch_mean.index_fill(0, idx, g_mean)
            batch_var = batch_var.index_fill(0, idx, g_var)
        return batch_mean, batch_var

    @torch.no_grad()
    def update(self, x: torch.Tensor, *, mask: torch.Tensor | None = None) -> None:
        self.update_from_stats(*mean_var_count(x, mask=mask))

    @torch.no_grad()
    def update_from_stats(self, batch_mean, batch_var, batch_count) -> None:
        batch_count = torch.as_tensor(batch_count, dtype=torch.float32, device=self.count.device)
        batch_mean, batch_var = self._process_batch_stats(batch_mean.float(), batch_var.float())
        mean, var, count = merge_mean_var(self.mean, self.var, self.count, batch_mean, batch_var, batch_count)
        empty = batch_count == 0
        mean = torch.where(empty, self.mean, mean)
        var = torch.where(empty, self.var, var)
        count = torch.where(empty, self.count, count)
        if self.max_count is not None:
            count = torch.clamp(count, max=self.max_count)
        self.mean.copy_(mean)
        self.var.copy_(var)
        self.count.copy_(count)

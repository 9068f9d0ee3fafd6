"""Rollout buffer (counterpart of ``cusrl_tpu/template/buffer.py``).

A mapping of field names over device storage: a dict of ``[capacity,
parallelism, ...]`` tensors on the agent's device, nested fields under
dotted paths (``action_dist.logits``).  The host loop ``push``es one step at
a time; a step is queued as it comes (write-behind) and the queue is flushed
into the storage when the data is read: one ``torch.stack`` per field for a
whole rollout written from the ring's start, else one indexed write per step
into a copy of the storage.  ``replace_data`` swaps in a whole ``[T, N, ...]``
rollout.

``cursor`` and ``full`` are host values: the ring's next slot and whether it
has wrapped.  ``num_valid_steps`` is the capacity once full, else the cursor;
the random samplers read them as ``buffer_state``.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping, MutableMapping
from typing import Any

import torch

from cusrl_tpu_torch.utils.nest import get_schema, iterate_nested, reconstruct_nested

__all__ = ["Buffer", "Sampler"]


class Buffer(MutableMapping):
    def __init__(self, capacity: int, parallelism: int, device: str | torch.device | None = None):
        self.capacity = int(capacity)
        self.parallelism = int(parallelism)
        self.device = None if device is None else torch.device(device)
        self.cursor = 0
        self.full = False
        self.schema: dict[str, Any] = {}
        self.storage: dict[str, torch.Tensor] = {}
        self._pending: list[tuple[int, dict[str, torch.Tensor]]] = []

    # -- mapping interface over top-level field names -------------------------

    def __iter__(self) -> Iterator[str]:
        yield from self.schema

    def __len__(self) -> int:
        return len(self.schema)

    def __contains__(self, key) -> bool:
        return key in self.schema

    def __getitem__(self, key: str):
        self._flush()
        return reconstruct_nested(self.storage, self.schema[key])

    def __setitem__(self, name: str, data) -> None:
        if data is None:
            return
        self._check_schema(name, data)
        for key, value in iterate_nested(data, name):
            value = self._tensor(value)
            if tuple(value.shape[:2]) != (self.capacity, self.parallelism):
                raise ValueError(f"Field '{key}' must have shape [capacity={self.capacity}, "
                                 f"parallelism={self.parallelism}, ...]; got {tuple(value.shape)}")
            self.storage[key] = value

    def __delitem__(self, name: str) -> None:
        if name not in self.schema:
            raise KeyError(name)
        for _, key in iterate_nested(self.schema[name]):
            del self.storage[key]
        del self.schema[name]

    def get(self, key: str, default=None):
        if key not in self.schema:
            return default
        return self[key]

    # -- lifecycle ------------------------------------------------------------

    def clear(self) -> None:
        self.cursor = 0
        self.full = False
        self.schema.clear()
        self.storage.clear()
        self._pending.clear()

    def reset_cursor(self) -> None:
        self.cursor = 0

    def resize(self, capacity: int) -> None:
        if capacity != self.capacity:
            self.clear()
            self.capacity = int(capacity)

    @property
    def num_valid_steps(self) -> int:
        return self.capacity if self.full else self.cursor

    # -- write paths ----------------------------------------------------------

    def _tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value, device=self.device)

    def push(self, transition: Mapping[str, Any]) -> None:
        """Appends one step; leaves must have shape ``[parallelism, ...]``.
        The step is queued and written when the data is next read."""
        values: dict[str, torch.Tensor] = {}
        for name, nested in transition.items():
            if nested is None:
                continue
            self._check_schema(name, nested)
            for key, value in iterate_nested(nested, name):
                value = self._tensor(value)
                if value.dim() < 1 or value.shape[0] != self.parallelism:
                    raise ValueError(f"A step of '{key}' must have shape [parallelism={self.parallelism}, ...]; "
                                     f"got {tuple(value.shape)}")
                values[key] = value
        if values:
            self._pending.append((self.cursor, values))
        self.cursor += 1
        if self.cursor == self.capacity:
            self.full = True
            self.cursor = 0

    def _flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        contiguous = (
            len(pending) == self.capacity
            and all(cursor == i for i, (cursor, _) in enumerate(pending))
            and all(values.keys() == pending[0][1].keys() for _, values in pending)
        )
        if contiguous:  # a whole rollout from the ring's start: one stack per field
            for key in pending[0][1]:
                self.storage[key] = torch.stack([values[key] for _, values in pending])
            return
        # Each step into a copy of its field (a tensor read out before stays as it was).
        updated: dict[str, torch.Tensor] = {}
        for cursor, values in pending:
            for key, value in values.items():
                if key not in updated:
                    old = self.storage.get(key)
                    updated[key] = (torch.zeros((self.capacity, *value.shape), dtype=value.dtype, device=value.device)
                                    if old is None else old.clone())
                updated[key][cursor] = value
        self.storage.update(updated)

    def replace_data(self, data: Mapping[str, Any]) -> None:
        """Swaps in a whole ``[T, N, ...]`` rollout."""
        self.clear()
        for name, nested in data.items():
            if nested is None:
                continue
            self._check_schema(name, nested)
            for key, value in iterate_nested(nested, name):
                self.storage[key] = self._tensor(value)
        self.full = True

    # -- read path ------------------------------------------------------------

    @property
    def data(self) -> dict[str, Any]:
        """Every field, nested as pushed (``[capacity, N, ...]`` tensors)."""
        self._flush()
        return {name: reconstruct_nested(self.storage, schema) for name, schema in self.schema.items()}

    def sample(self, fn) -> dict[str, Any]:
        """Maps ``fn(dotted path, tensor)`` over every leaf, keeping the nesting."""
        self._flush()
        mapped = {key: fn(key, value) for key, value in self.storage.items()}
        return {name: reconstruct_nested(mapped, schema) for name, schema in self.schema.items()}

    def _check_schema(self, name: str, data) -> None:
        incoming = get_schema(data, name)
        if name not in self.schema:
            self.schema[name] = incoming
        elif self.schema[name] != incoming:
            raise ValueError(f"Schema mismatch for field '{name}'")


class Sampler:
    """Base sampler: one batch, the whole buffer."""

    def __call__(self, buffer: Buffer):
        yield {}, buffer.data

"""Dataclass conversion helpers (counterpart of
``cusrl_tpu/utils/dataclass_utils.py``).

``to_dataclass`` converts config-ish objects (dataclasses, dicts, objects with
``__dict__``) into ad-hoc dataclasses; ``to_strict_typed_dataclass`` also pins
the field types to the current values' types.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["to_dataclass", "to_strict_typed_dataclass"]


def _fields_from(obj: Any) -> dict[str, Any]:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "__dict__"):
        return {k: v for k, v in vars(obj).items() if not k.startswith("_")}
    raise TypeError(f"Cannot convert {type(obj).__name__} to a dataclass")


def to_dataclass(obj: Any):
    """An ad-hoc dataclass instance mirroring the object's public fields."""
    values = _fields_from(obj)
    cls = dataclasses.make_dataclass(
        f"{type(obj).__name__}Config", [(name, Any, dataclasses.field(default=None)) for name in values]
    )
    return cls(**values)


def to_strict_typed_dataclass(obj: Any):
    """Like ``to_dataclass``, with field types pinned to the current value types."""
    values = _fields_from(obj)
    cls = dataclasses.make_dataclass(
        f"{type(obj).__name__}StrictConfig",
        [(name, type(value), dataclasses.field(default=None)) for name, value in values.items()],
    )
    return cls(**values)

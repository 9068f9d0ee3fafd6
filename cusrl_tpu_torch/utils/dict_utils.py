"""Object <-> dict serialization for configuration trees (counterpart of
``cusrl_tpu/utils/dict_utils.py``).

Factory dataclasses serialize to plain JSON-able dicts with a ``__class__``
tag of the form ``"module:QualName"``, and rebuild from them.
"""

from __future__ import annotations

import dataclasses
import importlib
from collections.abc import Mapping
from typing import Any, TypeVar

from cusrl_tpu_torch.utils.nest import get_first

__all__ = ["from_dict", "get_first", "prefix_dict_keys", "to_dict"]

_V = TypeVar("_V")

CLASS_TAG = "__class__"


def _class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(path: str) -> type:
    module_name, _, qualname = path.partition(":")
    obj: Any = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def to_dict(obj: Any) -> Any:
    """Recursively converts dataclasses to tagged dicts (lists/dicts/scalars pass through)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        result: dict[str, Any] = {CLASS_TAG: _class_path(type(obj))}
        for field in dataclasses.fields(obj):
            if not field.repr and field.name.startswith("_"):
                continue
            result[field.name] = to_dict(getattr(obj, field.name))
        return result
    if isinstance(obj, Mapping):
        return {key: to_dict(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        converted = [to_dict(value) for value in obj]
        return converted if isinstance(obj, list) else tuple(converted)
    if isinstance(obj, type):
        return {CLASS_TAG: _class_path(obj), "__is_type__": True}
    if callable(obj) and hasattr(obj, "__module__") and hasattr(obj, "__qualname__") and "<" not in obj.__qualname__:
        return {CLASS_TAG: f"{obj.__module__}:{obj.__qualname__}", "__is_type__": True}
    return obj


def from_dict(data: Any, obj: Any = None) -> Any:
    """Inverse of ``to_dict``: rebuilds tagged dataclasses recursively.  With a
    template ``obj`` and an untagged dict, the template's fields are replaced
    by the matching keys."""
    if isinstance(data, Mapping):
        if CLASS_TAG in data:
            cls = _resolve_class(data[CLASS_TAG])
            if data.get("__is_type__"):
                return cls
            kwargs = {k: from_dict(v) for k, v in data.items() if k not in (CLASS_TAG, "__is_type__")}
            if dataclasses.is_dataclass(cls):
                names = {f.name for f in dataclasses.fields(cls) if f.init}
                kwargs = {k: v for k, v in kwargs.items() if k in names}
            return cls(**kwargs)
        if obj is not None and dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            updates = {f.name: from_dict(data[f.name], getattr(obj, f.name))
                       for f in dataclasses.fields(obj) if f.name in data}
            return dataclasses.replace(obj, **updates)
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        rebuilt = [from_dict(v) for v in data]
        return rebuilt if isinstance(data, list) else tuple(rebuilt)
    return data


def prefix_dict_keys(data: Mapping[str, _V], prefix: str) -> dict[str, _V]:
    return {f"{prefix}{key}": value for key, value in data.items()}

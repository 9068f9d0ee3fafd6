"""Nested-dict helpers (the subset of ``cusrl_tpu/utils/nest.py`` and
``dict_utils.py`` the port needs)."""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = ["flatten_nested", "get_first", "map_nested", "stack_nested"]

_MISSING = object()


def map_nested(fn: Callable, data: Any) -> Any:
    """Applies ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(data, Mapping):
        return {key: map_nested(fn, value) for key, value in data.items()}
    return fn(data)


def flatten_nested(data: Any, prefix: str = "") -> dict:
    """Nested dict -> ``{dotted path: leaf}`` (a non-dict ``data`` is the
    leaf at ``prefix``)."""
    if not isinstance(data, Mapping):
        return {prefix: data}
    out = {}
    for key, value in data.items():
        out.update(flatten_nested(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def stack_nested(items: list, stack: Callable) -> Any:
    """Stacks a list of same-structure nested dicts leaf by leaf."""
    first = items[0]
    if isinstance(first, Mapping):
        return {key: stack_nested([item[key] for item in items], stack) for key in first}
    return stack(items)


def get_first(data: Mapping, *keys, default: Any = _MISSING) -> Any:
    """Returns the first present key's value; raises KeyError if none present and no default."""
    for key in keys:
        if key in data:
            return data[key]
    if default is _MISSING:
        raise KeyError(f"None of {keys!r} present")
    return default

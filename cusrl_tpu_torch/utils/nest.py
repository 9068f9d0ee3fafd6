"""Nested-dict helpers (the subset of ``cusrl_tpu/utils/nest.py`` and
``dict_utils.py`` the port needs)."""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = ["get_first", "map_nested", "stack_nested"]

_MISSING = object()


def map_nested(fn: Callable, data: Any) -> Any:
    """Applies ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(data, Mapping):
        return {key: map_nested(fn, value) for key, value in data.items()}
    return fn(data)


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

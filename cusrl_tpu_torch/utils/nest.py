"""Nested-dict helpers (the subset of ``cusrl_tpu/utils/nest.py`` and
``dict_utils.py`` the port needs)."""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = [
    "flatten_nested",
    "get_first",
    "get_schema",
    "iterate_nested",
    "map_nested",
    "reconstruct_nested",
    "stack_nested",
]

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


def _join(prefix: str, key: Any) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def get_schema(data: Any, prefix: str = "") -> Any:
    """The nest's structure with dotted-path leaf names:
    ``{"a": {"b": x}, "c": y}`` -> ``{"a": {"b": "a.b"}, "c": "c"}``."""
    if isinstance(data, Mapping):
        return {key: get_schema(value, _join(prefix, key)) for key, value in data.items()}
    if isinstance(data, (list, tuple)):
        walked = [get_schema(value, _join(prefix, i)) for i, value in enumerate(data)]
        return tuple(walked) if isinstance(data, tuple) else walked
    return prefix


def iterate_nested(data: Any, prefix: str = ""):
    """Yields ``(dotted path, leaf)`` pairs in order (dicts, lists and tuples)."""
    if isinstance(data, Mapping):
        for key, value in data.items():
            yield from iterate_nested(value, _join(prefix, key))
    elif isinstance(data, (list, tuple)):
        for index, value in enumerate(data):
            yield from iterate_nested(value, _join(prefix, index))
    else:
        yield prefix, data


def reconstruct_nested(flattened: Mapping[str, Any], schema: Any) -> Any:
    """The inverse of ``iterate_nested`` given ``get_schema``'s schema."""
    if isinstance(schema, Mapping):
        return {key: reconstruct_nested(flattened, value) for key, value in schema.items()}
    if isinstance(schema, (list, tuple)):
        rebuilt = [reconstruct_nested(flattened, value) for value in schema]
        return tuple(rebuilt) if isinstance(schema, tuple) else rebuilt
    return flattened[schema]

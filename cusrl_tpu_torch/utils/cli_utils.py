"""CLI override layer (counterpart of ``cusrl_tpu/utils/cli_utils.py``).

``--agent.lr 1e-4``-style dotted-path overrides apply onto the factory
dataclass tree (dataclasses and dicts); the applied ``{path: raw text}`` is
recorded into the trial's ``metadata.json`` and replayed with
``--inherit-args``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
from typing import Any

__all__ = ["apply_overrides", "parse_value", "split_cli_overrides"]


def parse_value(text: str) -> Any:
    """Parses a CLI literal: int/float/bool/None/tuple/list/str."""
    lowered = text.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("none", "null"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def split_cli_overrides(argv: list[str]) -> tuple[list[str], list[str]]:
    """Splits argv at the first ``--`` separator into (own args, overrides)."""
    if "--" in argv:
        index = argv.index("--")
        return argv[:index], argv[index + 1:]
    return argv, []


def _set_path(obj: Any, path: list[str], value: Any) -> Any:
    key = path[0]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if not hasattr(obj, key):
            raise AttributeError(f"No field '{key}' on {type(obj).__name__}")
        new_value = value if len(path) == 1 else _set_path(getattr(obj, key), path[1:], value)
        try:
            return dataclasses.replace(obj, **{key: new_value})
        except TypeError:  # a non-init field: set on a copy
            clone = copy.copy(obj)
            object.__setattr__(clone, key, new_value)
            return clone
    if isinstance(obj, dict):
        new_value = value if len(path) == 1 else _set_path(obj.get(key), path[1:], value)
        return {**obj, key: new_value}
    raise TypeError(f"Cannot apply override path '{'.'.join(path)}' to {type(obj).__name__}")


def apply_overrides(obj: Any, overrides: list[str]) -> tuple[Any, dict[str, Any]]:
    """Applies ``--a.b.c value`` (or ``--a.b.c=value``) pairs; returns (new
    obj, {path: raw value} applied)."""
    applied: dict[str, Any] = {}
    index = 0
    while index < len(overrides):
        arg = overrides[index]
        if not arg.startswith("--"):
            raise ValueError(f"Expected an override flag (--path.to.field), got '{arg}'")
        key = arg[2:]
        if "=" in key:
            key, _, raw = key.partition("=")
            index += 1
        else:
            if index + 1 >= len(overrides):
                raise ValueError(f"Missing value for override '{arg}'")
            raw = overrides[index + 1]
            index += 2
        obj = _set_path(obj, key.split("."), parse_value(raw))
        applied[key] = raw
    return obj, applied

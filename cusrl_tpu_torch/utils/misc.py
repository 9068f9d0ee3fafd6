"""Seeding and module import (counterpart of ``cusrl_tpu/utils/misc.py``).

``set_global_seed`` seeds Python's ``random``, numpy and torch (the host
generator and every CUDA device's) with ``seed + rank`` and records the base
seed in ``CONFIG.seed``; the experiment factories seed the agent with
``CONFIG.process_seed`` when the caller gives none, so each process of a
data-parallel run starts from its own weights (``parallel.distribute_agent``
then broadcasts rank 0's) and draws its own action noise.  The port draws from explicit ``torch.Generator``s seeded from that
value, in place of the JAX package's ``new_key``.
"""

from __future__ import annotations

import importlib
import importlib.util
import random
import sys
from typing import Any

import numpy as np
import torch

from cusrl_tpu_torch.utils.config import CONFIG

__all__ = ["import_module", "import_obj", "set_global_seed"]


def set_global_seed(seed: int | None = None) -> int:
    """Seeds python, numpy and torch with ``seed + rank`` (``seed`` a random
    one when None) and records ``seed`` in ``CONFIG.seed``; returns the
    process's seed."""
    if seed is None:
        seed = random.randint(0, 2**31 - 1)
    CONFIG.seed = int(seed)
    process_seed = CONFIG.process_seed
    random.seed(process_seed)
    np.random.seed(process_seed % (2**32))
    torch.manual_seed(process_seed)  # also seeds every CUDA device
    return process_seed


def import_module(module_name: str | None = None, path: str | None = None, args: list[str] | None = None):
    """Imports a module by name or file path, optionally with a temporary argv."""
    if (module_name is None) == (path is None):
        raise ValueError("Specify exactly one of 'module_name' or 'path'.")
    old_argv = sys.argv
    try:
        if args is not None:
            sys.argv = [module_name or path or ""] + list(args)
        if module_name is not None:
            return importlib.import_module(module_name)
        spec = importlib.util.spec_from_file_location("_cusrl_tpu_torch_dynamic", path)
        assert spec is not None and spec.loader is not None
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.argv = old_argv


def import_obj(path: str) -> Any:
    """Imports ``module:attr`` or dotted ``module.attr``."""
    if ":" in path:
        module_name, _, attr = path.partition(":")
    else:
        module_name, _, attr = path.rpartition(".")
    obj: Any = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj

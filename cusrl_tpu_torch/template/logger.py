"""Logger base and factory (counterpart of ``cusrl_tpu/template/logger.py``).

Creates ``[log_dir]/[timestamp]_[name]/{info,ckpt}`` with a ``latest``
symlink in ``log_dir``, averages scalars over ``interval`` iterations, and
writes checkpoints.  A checkpoint file keeps the JAX package's ``.npz``
layout: every top-level entry whose value is a non-empty dict of numpy arrays
is stored as ``<top>::<path>`` arrays, everything else pickled into the
``__pickled__`` byte array, so a file written by either package loads in the
other (the pickle holds only Python and numpy objects).  Under several
processes every rank builds its Logger: the directory's name is rank 0's
(broadcast), and only rank 0 creates the directories, writes the backend's
output and saves checkpoints.
"""

from __future__ import annotations

import io
import os
import pickle
import time
from typing import Any

import numpy as np

from cusrl_tpu_torch.utils import distributed

__all__ = ["Logger", "LoggerFactory", "load_checkpoint_file", "make_logger_factory", "save_checkpoint_file"]


def save_checkpoint_file(path: str, checkpoint: dict[str, Any]) -> None:
    arrays: dict[str, np.ndarray] = {}
    rest: dict[str, Any] = {}
    for key, value in checkpoint.items():
        if isinstance(value, dict) and value and all(isinstance(v, np.ndarray) for v in value.values()):
            for sub, arr in value.items():
                arrays[f"{key}::{sub}"] = arr
        else:
            rest[key] = value
    buffer = io.BytesIO()
    pickle.dump(rest, buffer)
    arrays["__pickled__"] = np.frombuffer(buffer.getvalue(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint_file(path: str) -> dict[str, Any]:
    with np.load(path, allow_pickle=False) as data:
        checkpoint: dict[str, Any] = pickle.loads(data["__pickled__"].tobytes())
        for key in data.files:
            if key == "__pickled__":
                continue
            top, _, sub = key.partition("::")
            checkpoint.setdefault(top, {})[sub] = data[key]
    return checkpoint


class Logger:
    def __init__(self, log_dir: str = "logs", name: str = "experiment", interval: int = 1,
                 add_timestamp: bool = True, **kwargs):
        self.interval = max(int(interval), 1)
        self._accumulator: dict[str, list[float]] = {}
        if add_timestamp:
            stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
            dir_name = f"{stamp}_{name}" if name else stamp
        else:
            dir_name = name
        dir_name = distributed.broadcast_obj(dir_name)
        self.name = name
        self.log_dir = os.path.join(log_dir, dir_name)
        self.info_dir = os.path.join(self.log_dir, "info")
        self.ckpt_dir = os.path.join(self.log_dir, "ckpt")
        if not distributed.is_main_process():
            return
        os.makedirs(self.info_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        latest = os.path.join(log_dir, "latest")
        try:
            if os.path.islink(latest) or os.path.exists(latest):
                os.remove(latest)
            os.symlink(dir_name, latest)
        except OSError:
            pass
        self._setup_backend(**kwargs)

    # -- scalar logging --------------------------------------------------------

    def log_scalars(self, scalars: dict[str, float], iteration: int) -> None:
        """Accumulates scalars; writes their averages on interval boundaries."""
        for key, value in scalars.items():
            self._accumulator.setdefault(key, []).append(float(value))
        if (iteration + 1) % self.interval == 0:
            averaged = {k: float(np.mean(v)) for k, v in self._accumulator.items() if v}
            self._accumulator.clear()
            if distributed.is_main_process():
                self._log_impl(averaged, iteration)

    def _setup_backend(self, **kwargs) -> None:
        pass

    def _log_impl(self, scalars: dict[str, float], iteration: int) -> None:
        pass

    def close(self) -> None:
        pass

    # -- checkpoints -----------------------------------------------------------

    def save_checkpoint(self, checkpoint: dict[str, Any], iteration: int) -> str:
        path = os.path.join(self.ckpt_dir, f"ckpt_{iteration}.npz")
        if distributed.is_main_process():
            save_checkpoint_file(path, checkpoint)
        return path


class LoggerFactory:
    def __init__(self, backend: str | None = None, log_dir: str = "logs", interval: int = 1, **kwargs):
        self.backend = backend
        self.log_dir = log_dir
        self.interval = interval
        self.kwargs = kwargs

    def __call__(self, name: str = "experiment") -> Logger:
        cls = _resolve_logger_class(self.backend)
        return cls(log_dir=self.log_dir, name=name, interval=self.interval, **self.kwargs)


def _resolve_logger_class(backend: str | None) -> type[Logger]:
    """The ``Logger`` subclass of ``cusrl_tpu_torch.logger`` named ``backend``
    (case and underscores ignored); None is the base (files only)."""
    if backend is None:
        return Logger
    import cusrl_tpu_torch.logger as logger_pkg

    wanted = backend.replace("_", "").lower()
    for attr in dir(logger_pkg):
        obj = getattr(logger_pkg, attr)
        if isinstance(obj, type) and issubclass(obj, Logger) and attr.lower() == wanted:
            return obj
    raise ValueError(f"Unknown logger backend '{backend}'")


def make_logger_factory(backend: str | None = None, log_dir: str = "logs", interval: int = 1, **kwargs):
    return LoggerFactory(backend=backend, log_dir=log_dir, interval=interval, **kwargs)

"""Logger backends (counterpart of ``cusrl_tpu/logger/backends.py``), found
by class name.  ``Jsonl`` needs nothing beyond the standard library; the
others import their package when a logger is built and raise ``ImportError``
naming it when it is missing (the GPU machine has no tensorboard: use
``--logger jsonl`` there)."""

from __future__ import annotations

import json
import os

from cusrl_tpu_torch.template.logger import Logger

__all__ = ["Jsonl", "Swanlab", "Tensorboard", "Wandb"]


class Jsonl(Logger):
    """One JSON object per logged iteration in ``<log_dir>/metrics.jsonl``."""

    def _setup_backend(self, **kwargs) -> None:
        self._fh = open(os.path.join(self.log_dir, "metrics.jsonl"), "w")

    def _log_impl(self, scalars, iteration) -> None:
        record = {"iteration": int(iteration)}
        record.update({key: float(value) for key, value in scalars.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if hasattr(self, "_fh"):
            self._fh.close()


class Tensorboard(Logger):
    def _setup_backend(self, **kwargs) -> None:
        import sys
        import types

        # Event files need only tensorboard's TensorFlow stub: keep a real
        # TensorFlow out of a process that holds torch (and, in tests, JAX).
        sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as error:
            raise ImportError("the tensorboard backend requires the 'tensorboard' package") from error
        self._writer = SummaryWriter(log_dir=self.log_dir, **kwargs)

    def _log_impl(self, scalars, iteration) -> None:
        for key, value in scalars.items():
            self._writer.add_scalar(key, value, iteration)

    def close(self) -> None:
        if hasattr(self, "_writer"):
            self._writer.close()


class Wandb(Logger):
    def _setup_backend(self, **kwargs) -> None:
        try:
            import wandb
        except ImportError as error:
            raise ImportError("the wandb backend requires the 'wandb' package") from error
        self._run = wandb.init(dir=self.log_dir, name=self.name, **kwargs)

    def _log_impl(self, scalars, iteration) -> None:
        self._run.log(scalars, step=iteration)

    def close(self) -> None:
        if hasattr(self, "_run"):
            self._run.finish()


class Swanlab(Logger):
    def _setup_backend(self, **kwargs) -> None:
        try:
            import swanlab
        except ImportError as error:
            raise ImportError("the swanlab backend requires the 'swanlab' package") from error
        self._run = swanlab.init(logdir=self.log_dir, experiment_name=self.name, **kwargs)

    def _log_impl(self, scalars, iteration) -> None:
        self._run.log(scalars, step=iteration)

"""Checkpoint/trial discovery (counterpart of ``cusrl_tpu/template/trial.py``).

Resolves ``<log_dir>/<experiment>`` (or the ``latest`` symlink) to a concrete
run directory and ``ckpt/ckpt_<iteration>.npz`` file, parses ``env_algo`` names,
and loads ``info/metadata.json`` for CLI-arg inheritance.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

from cusrl_tpu_torch.template.logger import load_checkpoint_file

__all__ = ["Trial"]

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


class Trial:
    def __init__(self, log_dir: str, experiment_name: str | None = None, checkpoint: str | int | None = None):
        self.log_dir = log_dir
        self.experiment_name = experiment_name
        self.trial_dir = self._resolve_trial_dir(checkpoint)
        self.checkpoint_path = self._resolve_checkpoint(checkpoint)

    # -- resolution ------------------------------------------------------------

    def _resolve_trial_dir(self, checkpoint) -> str:
        if isinstance(checkpoint, str) and os.path.isfile(checkpoint):
            return os.path.dirname(os.path.dirname(os.path.abspath(checkpoint)))
        if isinstance(checkpoint, str) and os.path.isdir(checkpoint):
            # --checkpoint <experiment dir or run dir>.
            root = os.path.abspath(checkpoint)
        else:
            root = self.log_dir
            if self.experiment_name:
                root = os.path.join(root, self.experiment_name)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"No such experiment directory: {root}")
        latest = os.path.join(root, "latest")
        if os.path.islink(latest) or os.path.isdir(latest):
            return os.path.realpath(latest)
        # Otherwise: the directory itself is a run dir, or pick the newest child.
        if os.path.isdir(os.path.join(root, "ckpt")):
            return root
        children = sorted(
            (os.path.join(root, d) for d in os.listdir(root) if os.path.isdir(os.path.join(root, d, "ckpt"))),
        )
        if not children:
            raise FileNotFoundError(f"No runs with checkpoints under {root}")
        return children[-1]

    def _resolve_checkpoint(self, checkpoint) -> str | None:
        if isinstance(checkpoint, str) and os.path.isfile(checkpoint):
            return os.path.abspath(checkpoint)
        ckpt_dir = os.path.join(self.trial_dir, "ckpt")
        if not os.path.isdir(ckpt_dir):
            return None
        candidates: dict[int, str] = {}
        for name in os.listdir(ckpt_dir):
            match = _CKPT_RE.search(name)
            if match:
                candidates[int(match.group(1))] = os.path.join(ckpt_dir, name)
        if not candidates:
            return None
        if isinstance(checkpoint, int) or (isinstance(checkpoint, str) and checkpoint.isdigit()):
            iteration = int(checkpoint)
            if iteration not in candidates:
                raise FileNotFoundError(f"No checkpoint for iteration {iteration} in {ckpt_dir}")
            return candidates[iteration]
        return candidates[max(candidates)]

    # -- parsed properties -----------------------------------------------------

    @property
    def name(self) -> str:
        return os.path.basename(self.trial_dir)

    @property
    def environment_name(self) -> str | None:
        if self.experiment_name and "_" in self.experiment_name:
            return self.experiment_name.rsplit("_", 1)[0]
        return None

    @property
    def algorithm_name(self) -> str | None:
        if self.experiment_name and "_" in self.experiment_name:
            return self.experiment_name.rsplit("_", 1)[1]
        return None

    @property
    def iteration(self) -> int | None:
        if self.checkpoint_path is None:
            return None
        match = _CKPT_RE.search(self.checkpoint_path)
        return int(match.group(1)) if match else None

    # -- loading ---------------------------------------------------------------

    def load_checkpoint(self) -> dict[str, Any] | None:
        if self.checkpoint_path is None:
            return None
        return load_checkpoint_file(self.checkpoint_path)

    def load_metadata(self) -> dict[str, Any]:
        path = os.path.join(self.trial_dir, "info", "metadata.json")
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            return json.load(f)

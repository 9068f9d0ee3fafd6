"""Transition recording player hook (counterpart of
``cusrl_tpu/hook/player/save_transition.py``): buffers the chosen keys of
every step's transition on the host and writes them, stacked over steps, to
an ``.npz`` file, or to numbered shards every ``save_interval`` steps."""

from __future__ import annotations

import os
from collections import defaultdict
from datetime import datetime
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from cusrl_tpu_torch.template.player import Player, PlayerHook

__all__ = ["SaveTransition"]


class SaveTransition(PlayerHook):
    DEFAULT_KEYS = ("observation", "reward", "terminated", "truncated", "action")

    def __init__(
        self,
        output_path: str | os.PathLike | None = None,
        keys: Iterable[str] = DEFAULT_KEYS,
        save_interval: int | None = None,
    ):
        if output_path is None:
            output_path = Path(f"transition_{datetime.now().strftime('%Y%m%d_%H%M%S')}.npz")
        else:
            output_path = Path(output_path)
            if output_path.suffix != ".npz":
                output_path = Path(f"{output_path}.npz")
        if save_interval is not None and save_interval <= 0:
            raise ValueError("'save_interval' must be positive or None")
        self.output_path = output_path
        self.keys = tuple(keys)
        self.save_interval = save_interval
        self.shard_index = 0
        self.buffer: defaultdict[str, list[np.ndarray]] = defaultdict(list)
        self._step_count = 0

    def init(self, player: Player) -> None:
        self.shard_index = 0
        self._step_count = 0
        self.buffer.clear()

    def step(self, player: Player, transition: dict) -> None:
        for key in self.keys:
            if key in transition:
                value = transition[key]
                self.buffer[key].append(value.cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value))
        self._step_count += 1
        if self.save_interval is not None and self._step_count % self.save_interval == 0:
            self.flush()

    def close(self, player: Player) -> None:
        self.flush()

    def flush(self) -> None:
        if not self.buffer:
            return
        arrays = {key: np.stack(value, axis=0) for key, value in self.buffer.items()}
        output_path = self.output_path
        if self.save_interval is not None:
            output_path = output_path.with_name(f"{output_path.stem}_{self.shard_index:06d}.npz")
        output_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(output_path, **arrays)
        self.shard_index += 1
        self.buffer.clear()

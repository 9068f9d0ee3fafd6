"""Native (C) vectorized environment (counterpart of
``cusrl_tpu/environment/native.py``).

``NativeCartPoleEnv`` drives the repository's C batch stepper
(``native/cartpole_batch.c``: Barto-Sutton-Anderson cart-pole dynamics, the
system gymnasium's CartPole-v1 simulates, with its 500-step truncation)
through ``ctypes`` on numpy arrays.  It is a host ``Environment``: the
Trainer's host driver and the Player run it as they run a gym adapter.
``build_native_library`` compiles the source with ``gcc -O3 -shared -fPIC``
at first use into ``cusrl_tpu_torch/_build/`` (ignored by git), under a name
that carries a hash of the source; nothing is written beside the source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from cusrl_tpu_torch.template.environment import Environment

__all__ = ["NativeCartPoleEnv", "build_native_library"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "cartpole_batch.c"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def build_native_library(force: bool = False) -> Path:
    """The compiled stepper, built if missing (or with ``force``)."""
    lib = _BUILD_DIR / f"libcartpole_batch-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]}.so"
    if lib.exists() and not force:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")  # processes building at once each replace the file whole
    subprocess.run([os.environ.get("CC", "gcc"), "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC), "-lm"],
                   check=True)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    lib.cartpole_reset.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.cartpole_step.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


class NativeCartPoleEnv(Environment):
    """Batch CartPole on the C stepper; discrete actions arrive one-hot (or
    as indices).  ``device`` is accepted, as the zoo's factories pass it,
    and unused: the environment lives on the host."""

    def __init__(self, num_instances: int = 64, seed: int = 0, device=None):
        super().__init__(observation_dim=4, action_dim=2, num_instances=num_instances, autoreset=False)
        self._lib = _library()
        n = num_instances
        self._state = np.zeros((n, 4), np.float64)
        self._steps = np.zeros(n, np.int32)
        self._reward = np.zeros(n, np.float64)
        self._terminated = np.zeros(n, np.uint8)
        self._truncated = np.zeros(n, np.uint8)
        self._seed = ctypes.c_uint64(seed * 2654435761 + 0x9E3779B97F4A7C15)

    def reset(self, indices=None, *, randomize_episode_progress: bool = False):
        n = self.num_instances
        index_array = np.arange(n, dtype=np.int32) if indices is None else np.asarray(indices, np.int32).reshape(-1)
        self._lib.cartpole_reset(_ptr(self._state, ctypes.c_double), _ptr(self._steps, ctypes.c_int32), n,
                                 _ptr(index_array, ctypes.c_int32), len(index_array), ctypes.byref(self._seed))
        return self._state.astype(np.float32), None, {}

    def step(self, action):
        action = np.asarray(action)
        discrete = np.argmax(action, axis=-1).astype(np.int32) if action.ndim > 1 else action.astype(np.int32)
        self._lib.cartpole_step(_ptr(self._state, ctypes.c_double), _ptr(self._steps, ctypes.c_int32),
                                self.num_instances, _ptr(discrete, ctypes.c_int32),
                                _ptr(self._reward, ctypes.c_double), _ptr(self._terminated, ctypes.c_uint8),
                                _ptr(self._truncated, ctypes.c_uint8))
        return (
            self._state.astype(np.float32),
            None,
            self._reward.astype(np.float32).reshape(-1, 1),
            self._terminated.astype(bool).reshape(-1, 1),
            self._truncated.astype(bool).reshape(-1, 1),
            {},
        )

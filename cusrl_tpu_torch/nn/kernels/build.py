"""Builds and loads the hand-written CUDA kernels of ``cusrl_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  All sources
compile in parallel (one ``nvcc`` process each) at first use, into
``cusrl_tpu_torch/_build/`` (listed in ``.gitignore``).  A library is reused
while its file name, which carries a hash of the sources, matches.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "build_all", "load_library"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compiles every source whose library is missing, all at once; returns
    ``{source stem: library path}``.  Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _library_path(src)) for src in _sources()}
    pending = {stem: pair for stem, pair in targets.items() if not pair[1].exists()}
    if pending:
        nvcc = _nvcc()
        procs = {}
        for stem, (src, lib) in pending.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
        failures = []
        for stem, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{stem}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"--- {stem} (nvcc exit {proc.returncode}) ---\n{log}")
                continue
            os.replace(tmp, lib)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {stem: lib for stem, (_, lib) in targets.items()}


def load_library(stem: str) -> ctypes.CDLL:
    """Returns the loaded library built from ``csrc/<stem>.cu``, building all
    kernels first if needed."""
    with _lock:
        lib = _libraries.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"No CUDA source csrc/{stem}.cu")
            lib = _libraries[stem] = ctypes.CDLL(str(paths[stem]))
        return lib

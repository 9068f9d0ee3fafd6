"""Runtime device, precision and process topology (counterpart of
``cusrl_tpu/utils/config.py``: the ``compute_dtype`` policy, the seed, the
device and ``configure_distributed``).

``compute_dtype="bfloat16"`` (the default, as in the JAX package) runs backbone
matmuls on bf16 operands with fp32 accumulation; ``None`` keeps everything
fp32.  Distribution math and value heads are fp32 either way.  ``seed`` is the
base seed ``utils.misc.set_global_seed`` records; each process draws from
``process_seed = seed + rank // model_parallel_size``, and the experiment
factories build their agent from it when the caller gives no seed.
``model_parallel_size`` (1 by default, as in the JAX package) is the model
axis of ``parallel.get_mesh``'s default mesh.  Ranks are laid out with the
model axis fastest, so ``rank // model_parallel_size`` is the process's data
coordinate: the model peers of a tensor-parallel run share their seed, and
with it their environments and their action noise.  Set it before the
factories run.

The process topology is PyTorch's: one process per device, launched by
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  ``configure_distributed`` joins the default process group
(NCCL for the card, gloo for ``device="cpu"``) and makes ``cuda:LOCAL_RANK``
the default device; without those variables it does nothing, and ``rank`` is
0 and ``world_size`` 1.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["CONFIG", "RuntimeConfig", "configure_distributed", "resolve_device"]

_TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass
class RuntimeConfig:
    compute_dtype: str | None = "bfloat16"
    seed: int = 0
    model_parallel_size: int = 1

    @property
    def rank(self) -> int:
        return dist.get_rank() if _initialized() else 0

    @property
    def world_size(self) -> int:
        return dist.get_world_size() if _initialized() else 1

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK", "0")) if _initialized() else 0

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    @property
    def process_seed(self) -> int:
        return self.seed + self.rank // self.model_parallel_size


CONFIG = RuntimeConfig()


def configure_distributed(device: str | torch.device | None = None, backend: str | None = None,
                          timeout_s: float = 300.0) -> bool:
    """Joins the default process group from torchrun's variables; returns
    whether one is initialized.  ``backend`` defaults to NCCL for the card
    (``device`` None or CUDA) and gloo for the CPU; on the card
    ``cuda:LOCAL_RANK`` becomes the current device.  Every collective of the
    group fails after ``timeout_s`` seconds instead of waiting forever on a
    rank that never joins.  A no-op once initialized or without the
    variables."""
    if _initialized():
        return True
    if any(name not in os.environ for name in _TORCHRUN_VARIABLES):
        return False
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend or ("nccl" if on_card else "gloo"),
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda:LOCAL_RANK`` in a process group).
    Raises when CUDA is requested (explicitly or by default) but absent: the
    port never quietly runs on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device '{device}'")
    if device.type == "cuda" and device.index is None and _initialized():
        device = torch.device("cuda", CONFIG.local_rank)
    return device

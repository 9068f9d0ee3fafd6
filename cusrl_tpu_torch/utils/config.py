"""Runtime device and precision policy (counterpart of
``cusrl_tpu/utils/config.py``: only the ``compute_dtype`` policy and the device).

``compute_dtype="bfloat16"`` (the default, as in the JAX package) runs backbone
matmuls on bf16 operands with fp32 accumulation; ``None`` keeps everything
fp32.  Distribution math and value heads are fp32 either way.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CONFIG", "RuntimeConfig", "resolve_device"]


@dataclasses.dataclass
class RuntimeConfig:
    compute_dtype: str | None = "bfloat16"


CONFIG = RuntimeConfig()


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is requested (explicitly or
    by default) but absent: the port never quietly runs on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device '{device}'")
    return device

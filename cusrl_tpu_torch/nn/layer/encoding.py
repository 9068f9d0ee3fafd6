"""Rotary embeddings and ALiBi slopes (counterpart of ``RotaryEmbedding`` and
``alibi_slopes`` in ``cusrl_tpu/nn/layer/encoding.py``).

RoPE uses the half-split pairing (``x1 = x[..., :D/2]`` rotates with
``x2 = x[..., D/2:]``), computes in fp32 and casts back to the input dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["RotaryEmbedding", "alibi_slopes"]


class RotaryEmbedding(nn.Module):
    """RoPE on the trailing head dimension; holds no parameters."""

    def __init__(self, dim: int, max_wavelength: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.max_wavelength = max_wavelength

    def _angles(self, positions: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(-math.log(self.max_wavelength)
                          * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
        return positions[..., None].float() * freqs  # [..., half]

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x ``[..., L, dim]``, positions ``[..., L]`` -> rotated x."""
        angles = self._angles(positions)
        cos, sin = torch.cos(angles), torch.sin(angles)
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def alibi_slopes(num_heads: int) -> list[float]:
    """ALiBi per-head slopes (geometric sequence), as Python floats."""

    def slopes_power_of_2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return slopes_power_of_2(num_heads)
    closest = 2 ** math.floor(math.log2(num_heads))
    return slopes_power_of_2(closest) + slopes_power_of_2(2 * closest)[0::2][: num_heads - closest]

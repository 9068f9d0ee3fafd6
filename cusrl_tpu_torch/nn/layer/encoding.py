"""Positional encodings (counterpart of ``cusrl_tpu/nn/layer/encoding.py``):
the sinusoidal encoding (``[sin, cos]`` of the positions times
``max_wavelength ** (-i / half)``, fp32), its 2-D form (rows in the first half
of the channels, columns in the second), the learnable table (normal * 0.02
at start), rotary embeddings and ALiBi slopes.

RoPE uses the half-split pairing (``x1 = x[..., :D/2]`` rotates with
``x2 = x[..., D/2:]``), computes in fp32 and casts back to the input dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = [
    "LearnablePositionalEncoding",
    "RotaryEmbedding",
    "Sinusoidal2dPositionalEncoding",
    "SinusoidalPositionalEncoding",
    "alibi_slopes",
]


def _angles(positions: torch.Tensor, dim: int, max_wavelength: float) -> torch.Tensor:
    """``positions [...] -> [..., dim // 2]`` fp32 angles."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_wavelength)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    return positions[..., None].float() * freqs


def _sinusoidal(positions: torch.Tensor, dim: int, max_wavelength: float) -> torch.Tensor:
    angles = _angles(positions, dim, max_wavelength)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class SinusoidalPositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_wavelength: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.max_wavelength = max_wavelength

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """positions ``[...]`` -> encodings ``[..., dim]``."""
        return _sinusoidal(positions, self.dim, self.max_wavelength)


class LearnablePositionalEncoding(nn.Module):
    def __init__(self, max_len: int, dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.table = nn.Parameter(torch.randn(max_len, dim, generator=generator) * 0.02)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.table[positions]


class Sinusoidal2dPositionalEncoding(nn.Module):
    """Half the channels encode ``rows``, half ``cols``."""

    def __init__(self, dim: int, max_wavelength: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.max_wavelength = max_wavelength

    def forward(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        return torch.cat([_sinusoidal(rows, half, self.max_wavelength), _sinusoidal(cols, half, self.max_wavelength)],
                         dim=-1)


class RotaryEmbedding(nn.Module):
    """RoPE on the trailing head dimension; holds no parameters."""

    def __init__(self, dim: int, max_wavelength: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.max_wavelength = max_wavelength

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x ``[..., L, dim]``, positions ``[..., L]`` -> rotated x."""
        angles = _angles(positions, self.dim, self.max_wavelength)
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

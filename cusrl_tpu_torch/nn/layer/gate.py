"""Residual gates (counterpart of ``cusrl_tpu/nn/layer/gate.py``), including
the GRU-style gate of GTrXL.  Each gate maps ``(residual input x, transformed
y)`` to the block output; gate ``Linear`` layers are fp32."""

from __future__ import annotations

import torch
from torch import nn

from cusrl_tpu_torch.nn.layer.linear import Linear

__all__ = [
    "GruGate",
    "HighwayGate",
    "InputGate",
    "OutputGate",
    "PassthroughGate",
    "ResidualGate",
    "SigmoidTanhGate",
    "make_gate",
]


class PassthroughGate(nn.Module):
    def __init__(self, dim: int = 0):
        super().__init__()
        self.dim = dim

    def forward(self, x, y):
        return y


class ResidualGate(PassthroughGate):
    def forward(self, x, y):
        return x + y


class _LinearGate(nn.Module):
    def __init__(self, gate: Linear):
        super().__init__()
        self.gate = gate


class InputGate(_LinearGate):
    def forward(self, x, y):
        return torch.sigmoid(self.gate(x)) * x + y


class OutputGate(_LinearGate):
    def forward(self, x, y):
        return x + torch.sigmoid(self.gate(x)) * y


class HighwayGate(_LinearGate):
    def forward(self, x, y):
        g = torch.sigmoid(self.gate(x))
        return g * x + (1.0 - g) * y


class SigmoidTanhGate(_LinearGate):
    def forward(self, x, y):
        return x + torch.sigmoid(self.gate(y)) * torch.tanh(y)


class GruGate(nn.Module):
    """GRU-style gated residual (GTrXL)."""

    def __init__(self, dim: int, gru_bias: float = 2.0, generator: torch.Generator | None = None):
        super().__init__()
        for name in ("w_r", "u_r", "w_z", "u_z", "w_g", "u_g"):
            setattr(self, name, Linear(dim, dim, bias=False, generator=generator))
        self.bias = nn.Parameter(torch.full((dim,), float(gru_bias)))

    def forward(self, x, y):
        r = torch.sigmoid(self.w_r(y) + self.u_r(x))
        z = torch.sigmoid(self.w_z(y) + self.u_z(x) - self.bias)
        h = torch.tanh(self.w_g(y) + self.u_g(r * x))
        return (1.0 - z) * x + z * h


_LINEAR_GATES = {"input": InputGate, "output": OutputGate, "highway": HighwayGate, "sigmoid_tanh": SigmoidTanhGate}


def make_gate(kind: str | None, dim: int, generator: torch.Generator | None = None,
              gru_bias: float = 2.0) -> nn.Module:
    kind = (kind or "residual").lower()
    if kind in ("passthrough", "none"):
        return PassthroughGate(dim)
    if kind == "residual":
        return ResidualGate(dim)
    if kind in _LINEAR_GATES:
        return _LINEAR_GATES[kind](Linear(dim, dim, generator=generator))
    if kind == "gru":
        return GruGate(dim, gru_bias, generator)
    raise ValueError(f"Unknown gate kind '{kind}'")

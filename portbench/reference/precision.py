"""Matrix products at a stated precision, for the plain reference and for
its lower-precision control.

``linear(x, weight, bias, precision)`` is ``x @ weight.T + bias`` with
fp32 accumulation and its operands rounded to ``precision``: ``"fp32"``
(no rounding; TF32 must be off, ``fp32_matmuls()``), ``"bf16"`` or
``"fp8"`` (float8 e4m3 with one scale per tensor, its largest magnitude
mapped to 448).  The backward rounds its operands the same way (the
cotangent, the weight and the saved input), as a training step at that
precision would.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["PRECISIONS", "fp32_matmuls", "linear", "lower", "round_to"]

PRECISIONS = ("fp32", "bf16", "fp8")
_FP8_MAX = 448.0


def lower(precision: str) -> str:
    """The nearest precision below ``precision``: the control's."""
    return {"fp32": "bf16", "bf16": "fp8"}[precision]


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (fp32) rounded to ``precision`` and returned in fp32."""
    x = x.float()
    if precision == "fp32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, precision):
        xq, wq = round_to(x, precision), round_to(weight, precision)
        ctx.save_for_backward(xq, wq)
        ctx.precision = precision
        y = xq @ wq.T
        return y if bias is None else y + bias.float()

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = round_to(grad, ctx.precision)
        grad_x = gq @ wq if ctx.needs_input_grad[0] else None
        grad_w = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1]) if ctx.needs_input_grad[1] else None
        grad_b = grad.reshape(-1, grad.shape[-1]).sum(0) if ctx.needs_input_grad[2] else None
        return grad_x, grad_w, grad_b, None


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, precision: str = "fp32") -> torch.Tensor:
    if precision == "fp32":
        y = x.float() @ weight.float().T
        return y if bias is None else y + bias.float()
    return _Linear.apply(x.float(), weight, bias, precision)


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

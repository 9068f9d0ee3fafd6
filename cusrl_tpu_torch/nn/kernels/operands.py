"""How the attention kernels take their operands (K3f, K3b and K6 in
``lane_attention.py``, K7f in ``banded_attention.py``): tensors read in
place with their strides, and ALiBi slopes passed by value."""

from __future__ import annotations

import torch

__all__ = ["in_place", "in_units", "slope_values"]


def in_units(t: torch.Tensor) -> torch.Tensor:
    """``t`` ([N, H, L, D]) as the kernels read it in place: the last dim
    contiguous, every row at a 16-byte boundary; otherwise a contiguous
    copy."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and all(st % vec == 0 for st in t.stride()[:-1]) and t.data_ptr() % 16 == 0:
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def in_place(p, operands: dict, strides: dict) -> list:
    """Points the ctypes parameter block ``p`` at ``operands`` (``{field:
    tensor}``: rows ``[N, H, L, D]`` and masks ``[N, L]``) as the kernels
    read them in place: a copy only where a row would not be 16-byte aligned
    or a mask is not int32.  ``strides`` names each field's stride field in
    ``p`` (a row's three outer strides, a mask's two).  Returns the tensors
    pointed to, in order (kept alive until the launch)."""
    keep = []
    for name, t in operands.items():
        t = in_units(t) if t.dim() == 4 else (t if t.dtype == torch.int32 else t.to(torch.int32))
        setattr(p, name, t.data_ptr())
        getattr(p, strides[name])[:] = t.stride()[:-1] if t.dim() == 4 else t.stride()
        keep.append(t)
    return keep


def slope_values(slopes) -> tuple[float, ...] | None:
    """ALiBi slopes as a tuple of floats (the kernels take them by value)."""
    if slopes is None:
        return None
    if isinstance(slopes, torch.Tensor):
        raise TypeError("pass ALiBi slopes as a sequence of floats (a tensor would need a device read)")
    return tuple(float(s) for s in slopes)

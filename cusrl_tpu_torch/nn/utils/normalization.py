"""Streaming statistics (counterpart of ``cusrl_tpu/nn/utils/normalization.py``):
masked per-channel mean/variance/count and Chan's parallel merge (the
``uncentered`` variant has no caller in the port yet).

Degenerate cases (an empty batch, a zero count) are selected with
``torch.where`` on device values, never with a Python branch, so the rollout
never waits on the device for them.
"""

from __future__ import annotations

import torch

__all__ = ["mean_var_count", "merge_mean_var"]


def mean_var_count(x: torch.Tensor, *, mask: torch.Tensor | None = None):
    """Per-channel mean, variance and count over all leading dims of ``[..., C]``.

    Rows where ``mask`` (broadcastable to ``x.shape[:-1]``) is false are
    ignored.  Returns fp32 ``(mean [C], var [C], count [])``; an empty batch
    gives the identity statistics (mean 0, var 1)."""
    x = x.float().reshape(-1, x.shape[-1])
    if mask is not None:
        m = mask.float().reshape(-1, 1)
        count = m.sum()
        safe = torch.clamp(count, min=1.0)
        mean = (x * m).sum(0) / safe
        var = ((x - mean).square() * m).sum(0) / safe
    else:
        count = torch.full((), float(x.shape[0]), device=x.device)
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    empty = count == 0
    mean = torch.where(empty, 0.0, mean)
    var = torch.where(empty, 1.0, var)
    return mean, var, count


def merge_mean_var(old_mean, old_var, old_count, new_mean, new_var, new_count):
    """Chan's parallel merge of two (mean, var, count) aggregates."""
    total = old_count + new_count
    safe_total = torch.clamp(total, min=1e-8)
    w_new = new_count / safe_total
    w_old = old_count / safe_total
    delta = new_mean - old_mean
    mean = old_mean + delta * w_new
    var = old_var + (new_var - old_var) * w_new + delta.square() * (w_old * w_new)
    return mean, var, total

"""Per-prefix gradient clipping (counterpart of
``cusrl_tpu/hook/on_policy/gradient_clipping.py``).

Each parameter falls into the longest configured path prefix or the default
group; each group's pre-clip global norm is recorded, and its gradients are
scaled by ``min(1, limit / max(norm, 1e-12))`` (the JAX formula, not
``torch.nn.utils.clip_grad_norm_``'s ``limit / (norm + 1e-6)``).  The norm is
over the whole arrays, as JAX's over its logical leaves: on a
tensor-parallel agent a sharded leaf's squares are summed over the model
group (one all-reduce a group of leaves), a whole leaf's counted once.
"""

from __future__ import annotations

import torch

from cusrl_tpu_torch.parallel.tensor import reduce_out, shard_of
from cusrl_tpu_torch.template.hook import Hook

__all__ = ["GradientClipping"]


class GradientClipping(Hook):
    training_only = True

    def __init__(self, max_grad_norm: float | None = 1.0, groups: dict[str, float | None] | None = None, **kwargs):
        super().__init__(**kwargs)
        groups = dict(groups or {})
        for prefix, limit in groups.items():
            if not prefix:
                raise ValueError("Empty prefixes not allowed; use 'max_grad_norm' for the default group")
            if limit is not None and limit < 0:
                raise ValueError(f"Group limit for '{prefix}' must be non-negative")
        if max_grad_norm is not None and max_grad_norm < 0:
            raise ValueError("'max_grad_norm' must be non-negative")
        self.max_grad_norm = max_grad_norm
        self.groups = tuple(sorted(groups.items(), key=lambda kv: len(kv[0]), reverse=True))

    def _match(self, path: str) -> str:
        for prefix, _ in self.groups:
            if path == prefix or path.startswith(prefix + "."):
                return prefix
        return ""

    @torch.no_grad()
    def pre_optim(self, agent) -> dict:
        limits = dict(self.groups)
        members: dict[str, list[torch.Tensor]] = {}
        shards: dict[str, list] = {}
        for path, param in agent.model.named_parameters():
            if param.grad is not None:
                members.setdefault(self._match(path), []).append(param.grad)
                shards.setdefault(self._match(path), []).append(shard_of(param))
        metrics = {}
        for group in sorted(members):
            grads = members[group]
            whole = [g for g, shard in zip(grads, shards[group]) if shard is None]
            split = [(g, shard) for g, shard in zip(grads, shards[group]) if shard is not None]
            squares = sum(g.float().square().sum() for g in whole)
            if split:
                squares = squares + reduce_out(sum(g.float().square().sum() for g, _ in split), split[0][1].group)
            norm = torch.sqrt(squares)
            metrics[f"grad_norm/{group or 'default'}"] = norm
            limit = limits.get(group, self.max_grad_norm)
            if limit is not None:
                scale = torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        return metrics

"""Sequential composition of backbone modules (counterpart of
``cusrl_tpu/nn/module/sequential.py``).

Memory is a dict keyed by the stringified member index, holding entries only
for recurrent members.  The members are registered under ``modules``, the
JAX field's name, so parameter paths read ``backbone.modules.0....`` in both
packages; ``nn.Module.modules()`` keeps that attribute name, so the list is
reached through ``members``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory

__all__ = ["Sequential", "SequentialFactory"]


class Sequential(BackboneContract, nn.Module):
    def __init__(self, modules):
        super().__init__()
        self._modules["modules"] = nn.ModuleList(modules)

    @property
    def members(self) -> nn.ModuleList:
        return self._modules["modules"]

    @property
    def input_dim(self) -> int:
        return self.members[0].input_dim

    @property
    def output_dim(self) -> int:
        return self.members[-1].output_dim

    @property
    def is_recurrent(self) -> bool:
        return any(m.is_recurrent for m in self.members)

    def init_memory(self, batch_size: int) -> Memory:
        memory = {str(i): m.init_memory(batch_size) for i, m in enumerate(self.members) if m.is_recurrent}
        return memory or None

    def forward(self, x, memory: Memory = None, *, sequential: bool = False, done=None, **kwargs):
        new_memory, aux = {}, {}
        for index, module in enumerate(self.members):
            key = str(index)
            sub_memory = None if memory is None else memory.get(key)
            x, sub_new, sub_aux = module(x, sub_memory, sequential=sequential, done=done, **kwargs)
            if module.is_recurrent:
                new_memory[key] = sub_new
            aux.update({f"{index}.{k}": v for k, v in sub_aux.items()})
        return x, (new_memory or None), aux

    @property
    def supports_next_token_eval(self) -> bool:
        return all(m.supports_next_token_eval for m in self.members)

    def sequential_with_ctx(self, x, memory: Memory, done):
        new_memory, ctxs = {}, []
        for index, module in enumerate(self.members):
            sub_memory = None if memory is None else memory.get(str(index))
            x, sub_new, sub_ctx = module.sequential_with_ctx(x, sub_memory, done)
            if module.is_recurrent:
                new_memory[str(index)] = sub_new
            ctxs.append(sub_ctx)
        return x, (new_memory or None), tuple(ctxs)

    def eval_next_token(self, y, ctx):
        for module, sub_ctx in zip(self.members, ctx):
            y = module.eval_next_token(y, sub_ctx)
        return y


@dataclasses.dataclass
class SequentialFactory:
    factories: tuple = ()

    @property
    def is_recurrent(self) -> bool:
        return any(f.is_recurrent for f in self.factories)

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> Sequential:
        modules = []
        dim = input_dim
        for i, factory in enumerate(self.factories):
            module = factory(dim, output_dim if i == len(self.factories) - 1 else None, generator)
            modules.append(module)
            dim = module.output_dim
        return Sequential(modules)

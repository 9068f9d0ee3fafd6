"""Recurrent backbones (counterpart of ``cusrl_tpu/nn/module/rnn.py``):
``Gru``, ``Lstm``, ``VanillaRnn`` (alias ``Rnn``) and ``RnnFactory``.

Each layer keeps the JAX module's raw parameters, ``weights_ih.<layer>``
``[G*H, C_in]``, ``weights_hh.<layer>`` ``[G*H, H]``, ``biases_ih.<layer>``
and ``biases_hh.<layer>`` ``[G*H]``, in ``nn.ParameterList``s (not ``Linear``
layers, which ``ModuleInitialization`` would re-initialise); the gates are
r, z, n for the GRU (``r * (W_hn h + b_hn)`` inside its tanh) and i, f, g, o
for the LSTM.  Memory is ``[N, num_layers, H]`` in fp32, ``{"hidden",
"cell"}`` for the LSTM.  The products run on ``compute_dtype`` operands with
fp32 accumulation, or in true fp32 when it is None; the state stays fp32.

Sequence mode (``x [T, N, C]``) is a loop over T of the same ``_step`` with
``_reset_carry`` after each step, the memory entering step t being the
post-step memory of t - 1 with its done rows zeroed: exactly what a rollout
produces, so sequence mode equals the stepwise rollout by construction.
``stacked_sequence`` runs two modules of one structure (an actor's and a
critic's) as one batched product a step over their stacked weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cusrl_tpu_torch.nn.base import BackboneContract, Memory
from cusrl_tpu_torch.utils.nest import map_nested

__all__ = ["Gru", "Lstm", "Rnn", "RnnFactory", "VanillaRnn", "stacked_sequence"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype: str | None) -> torch.Tensor:
    """``x @ w^T`` over the last two axes with fp32 accumulation: on
    ``compute_dtype`` operands, exactly multiplied in fp32, or in fp32."""
    wt = w.transpose(-1, -2)
    if compute_dtype is not None:
        dtype = _DTYPES[compute_dtype]
        return x.to(dtype).float() @ wt.to(dtype).float()
    return x.float() @ wt.float()


def _reset_carry(carry: Memory, done_t: torch.Tensor, pair_axis: bool = False) -> Memory:
    """Zeroes the rows of every memory leaf where ``done_t`` ``[N, 1]`` is
    set (the rows of axis 1 with ``pair_axis``)."""
    lead = 1 if pair_axis else 0

    def _reset(leaf):
        mask = done_t.reshape(*(1,) * lead, done_t.shape[0], *(1,) * (leaf.dim() - 1 - lead))
        return torch.where(mask, torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf)

    return map_nested(_reset, carry)


def _gru_cell(x, h, w_ih, w_hh, b_ih, b_hh, compute_dtype):
    h = h.float()
    gi = _matmul(x, w_ih, compute_dtype) + b_ih
    gh = _matmul(h, w_hh, compute_dtype) + b_hh
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = (1.0 - z) * n + z * h
    return h_new, h_new


def _rnn_cell(x, h, w_ih, w_hh, b_ih, b_hh, compute_dtype):
    h = h.float()
    h_new = torch.tanh(_matmul(x, w_ih, compute_dtype) + b_ih + _matmul(h, w_hh, compute_dtype) + b_hh)
    return h_new, h_new


def _lstm_cell(x, hc, w_ih, w_hh, b_ih, b_hh, compute_dtype):
    h, c = hc["hidden"].float(), hc["cell"].float()
    gates = _matmul(x, w_ih, compute_dtype) + b_ih + _matmul(h, w_hh, compute_dtype) + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    return h_new, {"hidden": h_new, "cell": c_new}


class _RnnBase(BackboneContract, nn.Module):
    """Layer stack, step, sequence loop and done resets."""

    is_recurrent = True
    _cell_fn = None

    def __init__(self, weights_ih, weights_hh, biases_ih, biases_hh, input_dim: int, hidden_size: int,
                 num_layers: int = 1, compute_dtype: str | None = None):
        super().__init__()
        self.weights_ih = nn.ParameterList(weights_ih)
        self.weights_hh = nn.ParameterList(weights_hh)
        self.biases_ih = nn.ParameterList(biases_ih)
        self.biases_hh = nn.ParameterList(biases_hh)
        self.input_dim = input_dim
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype

    @property
    def output_dim(self) -> int:
        return self.hidden_size

    def init_memory(self, batch_size: int) -> Memory:
        return torch.zeros(batch_size, self.num_layers, self.hidden_size, device=self.weights_hh[0].device)

    def _split_memory(self, memory, layer: int):
        return memory[..., layer, :]

    def _merge_memory(self, slices):
        return torch.stack(slices, dim=-2)

    def _layer_params(self, layer: int):
        return self.weights_ih[layer], self.weights_hh[layer], self.biases_ih[layer], self.biases_hh[layer]

    def _step(self, x, memory, params=None):
        """One time step through every layer; ``params(layer)`` gives the
        layer's weights (the module's own by default).  Returns
        ``(top output, new memory)``."""
        params = params or self._layer_params
        new_slices, out = [], x
        for layer in range(self.num_layers):
            out, h_new = type(self)._cell_fn(out, self._split_memory(memory, layer), *params(layer),
                                            self.compute_dtype)
            new_slices.append(h_new)
        return out, self._merge_memory(new_slices)

    def _sequence(self, x, memory, done, params=None, pair_axis: bool = False):
        """Sequence mode over ``x [T, N, C]`` (``[2, T, N, C]`` with
        ``pair_axis``, the memory stacked the same way)."""
        outputs = []
        for t in range(x.shape[-3]):
            out, memory = self._step(x[..., t, :, :], memory, params)
            memory = _reset_carry(memory, done[t], pair_axis)
            outputs.append(out)
        return torch.stack(outputs, dim=-3), memory

    def forward(self, x, memory: Memory = None, *, sequential: bool = False, done=None, **kwargs):
        if memory is None:
            memory = self.init_memory(x.shape[1] if sequential else x.shape[0])
        if not sequential:
            out, new_memory = self._step(x, memory)
            return out, new_memory, {}
        if done is None:
            done = torch.zeros(*x.shape[:2], 1, dtype=torch.bool, device=x.device)
        outputs, final_memory = self._sequence(x, memory, done)
        return outputs, final_memory, {}


class Gru(_RnnBase):
    _cell_fn = staticmethod(_gru_cell)


class VanillaRnn(_RnnBase):
    _cell_fn = staticmethod(_rnn_cell)


Rnn = VanillaRnn


class Lstm(_RnnBase):
    _cell_fn = staticmethod(_lstm_cell)

    def init_memory(self, batch_size: int) -> Memory:
        shape = (batch_size, self.num_layers, self.hidden_size)
        device = self.weights_hh[0].device
        return {"hidden": torch.zeros(shape, device=device), "cell": torch.zeros(shape, device=device)}

    def _split_memory(self, memory, layer: int):
        return {"hidden": memory["hidden"][..., layer, :], "cell": memory["cell"][..., layer, :]}

    def _merge_memory(self, slices):
        return {"hidden": torch.stack([s["hidden"] for s in slices], dim=-2),
                "cell": torch.stack([s["cell"] for s in slices], dim=-2)}


def stacked_sequence(module_a: _RnnBase, module_c: _RnnBase, x_a, x_c, memory_a, memory_c, done):
    """Sequence mode of two modules of one structure on their own inputs and
    memories, each product one batched product over the pair's stacked
    weights (the JAX package's vmapped stack); gradients reach both
    parameter sets.  Returns ``(out_a, out_c, final memory_a, final memory_c)``."""
    if type(module_a) is not type(module_c) or module_a.num_layers != module_c.num_layers:
        raise ValueError("stacked recurrent modules must have one structure")
    stacked = [[torch.stack([pa, pc]) for pa, pc in zip(module_a._layer_params(l), module_c._layer_params(l))]
               for l in range(module_a.num_layers)]
    for params in stacked:
        params[2], params[3] = params[2].unsqueeze(-2), params[3].unsqueeze(-2)  # biases [2, 1, G*H]
    x = torch.stack([x_a, x_c.to(x_a.dtype)])
    memory = _stack_pair(memory_a, memory_c)
    if done is None:
        done = torch.zeros(*x_a.shape[:2], 1, dtype=torch.bool, device=x_a.device)
    outputs, final = module_a._sequence(x, memory, done, params=lambda layer: stacked[layer], pair_axis=True)
    return outputs[0], outputs[1], map_nested(lambda m: m[0], final), map_nested(lambda m: m[1], final)


def _stack_pair(a: Memory, c: Memory) -> Memory:
    """Two same-structure memories stacked leaf by leaf on a new axis 0."""
    if isinstance(a, dict):
        return {key: _stack_pair(a[key], c[key]) for key in a}
    return torch.stack([a, c])


_NUM_GATES = {"gru": 3, "lstm": 4, "rnn": 1}
_CLASSES = {"gru": Gru, "lstm": Lstm, "rnn": VanillaRnn}


@dataclasses.dataclass
class RnnFactory:
    cell: str = "gru"
    hidden_size: int = 256
    num_layers: int = 1
    compute_dtype: str | None = None

    is_recurrent = True

    def __call__(self, input_dim: int, output_dim: int | None, generator: torch.Generator | None = None) -> _RnnBase:
        cell = self.cell.lower()
        if cell not in _CLASSES:
            raise ValueError(f"Unsupported RNN cell '{self.cell}'")
        gates, h = _NUM_GATES[cell], self.hidden_size
        bound = 1.0 / math.sqrt(h)

        def uniform(*shape):
            return nn.Parameter(torch.rand(*shape, generator=generator) * (2 * bound) - bound)

        w_ih, w_hh, b_ih, b_hh = [], [], [], []
        for layer in range(self.num_layers):
            w_ih.append(uniform(gates * h, input_dim if layer == 0 else h))
            w_hh.append(uniform(gates * h, h))
            b_ih.append(uniform(gates * h))
            b_hh.append(uniform(gates * h))
        return _CLASSES[cell](w_ih, w_hh, b_ih, b_hh, input_dim=input_dim, hidden_size=h,
                              num_layers=self.num_layers, compute_dtype=self.compute_dtype)

"""Fused MLP chain kernels on Hopper (counterpart of
``cusrl_tpu/nn/kernels/fused_mlp.py``: ``fused_mlp`` and ``fused_mlp_pair``).

Two hand-written CUDA kernels (``csrc/mlp_chain_fwd.cu``,
``csrc/mlp_chain_bwd.cu``) run one Linear+activation chain, or two same-shape
chains (actor and critic) in one launch:

====  =====================  ==============================================
K1f   ``mlp_chain_fwd`` x1   replaces ``_fwd_kernel`` (``_run_fwd``)
K1b   ``mlp_chain_bwd`` x1   replaces ``_bwd_kernel`` (``_run_bwd``)
K2f   ``mlp_chain_fwd`` x2   replaces ``_pair_fwd_kernel`` (``_pair_run_fwd``)
K2b   ``mlp_chain_bwd`` x2   replaces ``_pair_bwd_kernel`` (``_pair_run_bwd``)
====  =====================  ==============================================

What bounds them on the H100 and what the design does about it is written at
the top of each CUDA source.  Beside each kernel this module keeps its plain
PyTorch version, which repeats the kernel's arithmetic step by step (including
the explicit backward formulas): bf16 operands, fp32 accumulation, fp32 bias,
round to bf16, activation in fp32 on the bf16 value, round to bf16 again; the
backward keeps ``d`` in fp32, multiplies it by the activation derivative taken
from the saved post-activation, and feeds ``bf16(d)`` to both products.

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per kernel name; the plain versions count nothing.

Layouts are the port's parameter layouts: ``weights[l]`` is ``[out, in]``
fp32, ``biases[l]`` is ``[out]`` fp32, and weight gradients come back
``[out, in]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

__all__ = [
    "LAUNCHES",
    "fused_mlp",
    "fused_mlp_pair",
    "mlp_chain_bwd_plain",
    "mlp_chain_fwd_plain",
    "reset_launch_counts",
    "supports_fused_mlp",
]

_BF16 = torch.bfloat16
_ACTIVATION_CODES = {"identity": 0, "none": 0, "elu": 1, "relu": 2, "tanh": 3}
MAX_LAYERS = 8  # MLP_MAX_LAYERS in csrc/mlp_chain.cuh
MAX_WIDTH = 512  # MLP_MAX_WIDTH
WIDTH_MULTIPLE = 16  # the kernels' 16x16x16 WMMA tiles
ROW_TILE = 64  # mlp::BM

LAUNCHES: dict[str, int] = {"K1f": 0, "K1b": 0, "K2f": 0, "K2b": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_mlp(activation: str, num_layers: int, trailing: bool = False) -> bool:
    """Exactly what the CUDA kernels take: elu, relu, tanh and identity, 1 to
    ``MAX_LAYERS`` layers.  (gelu, which the TPU kernels also take, waits for
    the transformer slice.)"""
    del trailing
    return isinstance(activation, str) and activation.lower() in _ACTIVATION_CODES and 1 <= num_layers <= MAX_LAYERS


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _act_plain(activation: str, z: torch.Tensor) -> torch.Tensor:
    """fp32 activation of the bf16-rounded pre-activation (``_act_kernel``)."""
    if activation == "elu":
        return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    if activation == "relu":
        return torch.clamp(z, min=0.0)
    if activation == "tanh":
        return torch.tanh(z)
    return z


def _dact_plain(activation: str, h: torch.Tensor) -> torch.Tensor:
    """Derivative from the saved post-activation (``_dact_from_h``)."""
    if activation == "elu":
        return torch.clamp(h + 1.0, max=1.0)
    if activation == "relu":
        return (h > 0).float()
    if activation == "tanh":
        return 1.0 - h * h
    return torch.ones_like(h)


def mlp_chain_fwd_plain(x, weights, biases, activation: str, trailing: bool, save_hiddens: bool):
    """Returns ``(out [N, out_last] bf16, [h_1..h_{L-1}] bf16 if save_hiddens)``."""
    num_layers = len(weights)
    h = x.to(_BF16)
    hiddens = []
    for layer, (w, b) in enumerate(zip(weights, biases)):
        z = (h.float() @ w.to(_BF16).float().T + b.float()).to(_BF16)
        h = _act_plain(activation, z.float()).to(_BF16) if (layer < num_layers - 1 or trailing) else z
        if save_hiddens and layer < num_layers - 1:
            hiddens.append(h)
    return h, hiddens


def mlp_chain_bwd_plain(x, g, weights, hs, activation: str, trailing: bool, skip_input_grad: bool):
    """Gradient chain from the saved activations ``hs = [h_1..h_L]`` (``h_L``
    is the chain output).  Returns ``(dx fp32 or None, dws [out, in] fp32, dbs fp32)``."""
    num_layers = len(weights)
    d = g.float()
    dws: list = [None] * num_layers
    dbs: list = [None] * num_layers
    for layer in reversed(range(num_layers)):
        if layer < num_layers - 1 or trailing:
            d = d * _dact_plain(activation, hs[layer].float())
        d_bf = d.to(_BF16).float()
        h_in = (x if layer == 0 else hs[layer - 1]).to(_BF16).float()
        dws[layer] = d_bf.T @ h_in
        dbs[layer] = d.sum(0)
        if layer == 0 and skip_input_grad:
            return None, dws, dbs
        d = d_bf @ weights[layer].to(_BF16).float()
    return d, dws, dbs


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_P8 = ctypes.c_void_p * MAX_LAYERS


class _Chain(ctypes.Structure):
    """Mirror of ``MlpChain`` in csrc/mlp_chain.cuh."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("w", _P8),
        ("b", _P8),
        ("h", _P8),
        ("g", ctypes.c_void_p),
        ("d", _P8),
        ("dbp", _P8),
        ("dw", _P8),
        ("db", _P8),
        ("dx", ctypes.c_void_p),
    ]


class _Params(ctypes.Structure):
    """Mirror of ``MlpParams`` in csrc/mlp_chain.cuh."""

    _fields_ = [
        ("chain", _Chain * 2),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("num_layers", ctypes.c_int),
        ("num_rows", ctypes.c_int),
        ("activation", ctypes.c_int),
        ("trailing", ctypes.c_int),
        ("save_hiddens", ctypes.c_int),
        ("x_is_bf16", ctypes.c_int),
        ("skip_input_grad", ctypes.c_int),
    ]


def _library(stem: str) -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels.build import load_library

    lib = load_library(stem)
    fn = getattr(lib, stem)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mlp_chain_error_string.argtypes = [ctypes.c_int]
        lib.mlp_chain_error_string.restype = ctypes.c_char_p
    return lib


def _validate(xs, wss, bss=None) -> list[int]:
    """Checks what the kernels take and returns the chain widths (biases are
    checked when given)."""
    device = xs[0].device
    dims = [wss[0][0].shape[1]] + [w.shape[0] for w in wss[0]]
    if not 1 <= len(wss[0]) <= MAX_LAYERS:
        raise ValueError(f"fused MLP kernels take 1 to {MAX_LAYERS} layers; got {len(wss[0])}")
    bad = [d for d in dims if d % WIDTH_MULTIPLE or not 0 < d <= MAX_WIDTH]
    if bad:
        raise ValueError(f"fused MLP kernels take widths that are multiples of {WIDTH_MULTIPLE} up to {MAX_WIDTH}; "
                         f"got {dims}")
    for i, (x, ws) in enumerate(zip(xs, wss)):
        bs = bss[i] if bss is not None else (None,) * len(ws)
        if x.dtype not in (torch.float32, _BF16) or x.dtype != xs[0].dtype:
            raise TypeError(f"inputs must share one dtype, fp32 or bf16; got {x.dtype}")
        if x.dim() != 2 or x.shape != xs[0].shape or x.shape[1] != dims[0]:
            raise ValueError(f"input of shape {tuple(x.shape)} does not fit widths {dims}")
        if [ws[0].shape[1]] + [w.shape[0] for w in ws] != dims:
            raise ValueError("the two chains must have the same widths")
        for layer, (w, b) in enumerate(zip(ws, bs)):
            if w.shape != (dims[layer + 1], dims[layer]) or w.dtype != torch.float32:
                raise ValueError(f"layer {layer}: weight must be fp32 [out, in]; got {w.dtype} {tuple(w.shape)}")
            if bss is not None and (b is None or b.shape != (dims[layer + 1],) or b.dtype != torch.float32):
                raise ValueError(f"layer {layer}: bias must be fp32 [out]")
        for t in (x, *ws, *(b for b in bs if b is not None)):
            if t.device != device:
                raise ValueError("all tensors must lie on one CUDA device")
    if xs[0].shape[0] >= 2**31:
        raise ValueError("row count exceeds the kernels' int range")
    return dims


def _params(dims, num_rows, activation, trailing) -> _Params:
    p = _Params()
    for i, d in enumerate(dims):
        p.dims[i] = d
    p.num_layers = len(dims) - 1
    p.num_rows = num_rows
    p.activation = _ACTIVATION_CODES[activation]
    p.trailing = int(trailing)
    return p


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.mlp_chain_error_string(code).decode()} (cudaError {code})")


def _launch_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter):
    dims = _validate(xs, wss, bss)
    num_layers, n = len(dims) - 1, xs[0].shape[0]
    xs = [x.contiguous() for x in xs]
    wss = [[w.detach().contiguous() for w in ws] for ws in wss]
    bss = [[b.detach().contiguous() for b in bs] for bs in bss]
    hss = [
        [torch.empty(n, dims[l + 1], dtype=_BF16, device=xs[0].device)
         for l in range(num_layers) if save_hiddens or l == num_layers - 1]
        for _ in xs
    ]
    if n > 0:
        p = _params(dims, n, activation, trailing)
        p.save_hiddens = int(save_hiddens)
        p.x_is_bf16 = int(xs[0].dtype == _BF16)
        for i, (x, ws, bs, hs) in enumerate(zip(xs, wss, bss, hss)):
            chain = p.chain[i]
            chain.x = x.data_ptr()
            for l in range(num_layers):
                chain.w[l] = ws[l].data_ptr()
                chain.b[l] = bs[l].data_ptr()
            # h[l] for the layers whose output is written (all when saving, else the last).
            written = range(num_layers) if save_hiddens else [num_layers - 1]
            for l, h in zip(written, hs):
                chain.h[l] = h.data_ptr()
        lib = _library("mlp_chain_fwd")
        stream = torch.cuda.current_stream(xs[0].device).cuda_stream
        code = lib.mlp_chain_fwd(ctypes.byref(p), len(xs), stream)
        LAUNCHES[counter] += 1
        _check(lib, code, "mlp_chain_fwd")
    return [hs[-1] for hs in hss], [hs[:-1] for hs in hss]


def _launch_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter):
    dims = _validate(xs, wss)
    num_layers, n = len(dims) - 1, xs[0].shape[0]
    device = xs[0].device
    xs = [x.contiguous() for x in xs]
    gs = [g.to(_BF16).contiguous() for g in gs]
    wss = [[w.detach().contiguous() for w in ws] for ws in wss]
    hss = [[h.contiguous() for h in hs] for hs in hss]
    for g, hs in zip(gs, hss):
        if g.shape != (n, dims[-1]) or g.device != device:
            raise ValueError(f"cotangent must be [N, {dims[-1]}] on {device}; got {tuple(g.shape)} on {g.device}")
        if len(hs) != num_layers or any(
            h.dtype != _BF16 or h.shape != (n, dims[l + 1]) or h.device != device for l, h in enumerate(hs)
        ):
            raise ValueError("saved activations must be bf16 [N, width] for every layer, on the inputs' device")
    row_tiles = -(-n // ROW_TILE)
    results = []
    scratch = []
    p = _params(dims, n, activation, trailing)
    p.x_is_bf16 = int(xs[0].dtype == _BF16)
    p.skip_input_grad = int(skip_input_grad)
    for i, (x, g, ws, hs) in enumerate(zip(xs, gs, wss, hss)):
        dws = [torch.empty(dims[l + 1], dims[l], device=device) for l in range(num_layers)]
        dbs = [torch.empty(dims[l + 1], device=device) for l in range(num_layers)]
        dx = None if skip_input_grad else torch.empty(n, dims[0], device=device)
        ds = [torch.empty(n, dims[l + 1], dtype=_BF16, device=device) for l in range(num_layers)]
        dbp = [torch.empty(max(row_tiles, 1), dims[l + 1], device=device) for l in range(num_layers)]
        scratch.append((ds, dbp))
        chain = p.chain[i]
        chain.x = x.data_ptr()
        chain.g = g.data_ptr()
        chain.dx = None if dx is None else dx.data_ptr()
        for l in range(num_layers):
            chain.w[l] = ws[l].data_ptr()
            chain.h[l] = hs[l].data_ptr()
            chain.d[l] = ds[l].data_ptr()
            chain.dbp[l] = dbp[l].data_ptr()
            chain.dw[l] = dws[l].data_ptr()
            chain.db[l] = dbs[l].data_ptr()
        results.append((dx, dws, dbs))
    if n == 0:
        return [(dx, [dw.zero_() for dw in dws], [db.zero_() for db in dbs]) for dx, dws, dbs in results]
    lib = _library("mlp_chain_bwd")
    stream = torch.cuda.current_stream(device).cuda_stream
    code = lib.mlp_chain_bwd(ctypes.byref(p), len(xs), stream)
    LAUNCHES[counter] += 1
    _check(lib, code, "mlp_chain_bwd")
    return results


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _chain_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter):
    """Forward of 1 or 2 chains; returns (outs, hiddens) per chain."""
    device = xs[0].device
    if device.type == "cuda":
        return _launch_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter)
    if device.type != "cpu":
        raise RuntimeError(f"fused MLP kernels run on CUDA tensors; got {device}")
    results = [mlp_chain_fwd_plain(x, ws, bs, activation, trailing, save_hiddens) for x, ws, bs in zip(xs, wss, bss)]
    return [r[0] for r in results], [r[1] for r in results]


def _chain_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter):
    """Backward of 1 or 2 chains; returns [(dx or None, dws, dbs)] per chain."""
    device = xs[0].device
    if device.type == "cuda":
        return _launch_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter)
    if device.type != "cpu":
        raise RuntimeError(f"fused MLP kernels run on CUDA tensors; got {device}")
    return [
        mlp_chain_bwd_plain(x, g, ws, hs, activation, trailing, skip_input_grad)
        for x, g, ws, hs in zip(xs, gs, wss, hss)
    ]


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, activation, trailing, num_layers, *params):
        ws, bs = params[:num_layers], params[num_layers:]
        outs, hiddens = _chain_fwd([x], [ws], [bs], activation, trailing, True, "K1f")
        ctx.save_for_backward(x, *ws, *hiddens[0], outs[0])
        ctx.meta = (activation, trailing, num_layers)
        return outs[0]

    @staticmethod
    def backward(ctx, g):
        activation, trailing, num_layers = ctx.meta
        saved = ctx.saved_tensors
        x, ws, hs = saved[0], saved[1 : 1 + num_layers], saved[1 + num_layers :]
        skip = not ctx.needs_input_grad[0]
        ((dx, dws, dbs),) = _chain_bwd([x], [g], [ws], [hs], activation, trailing, skip, "K1b")
        return (None if dx is None else dx.to(x.dtype), None, None, None, *dws, *dbs)


class _FusedMlpPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xa, xc, activation, trailing, num_layers, skip_input_grad, *params):
        nl = num_layers
        wa, ba, wc, bc = params[:nl], params[nl : 2 * nl], params[2 * nl : 3 * nl], params[3 * nl :]
        outs, hiddens = _chain_fwd([xa, xc], [wa, wc], [ba, bc], activation, trailing, True, "K2f")
        ctx.save_for_backward(xa, xc, *wa, *wc, *hiddens[0], outs[0], *hiddens[1], outs[1])
        ctx.meta = (activation, trailing, num_layers, skip_input_grad)
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, ga, gc):
        activation, trailing, nl, skip_input_grad = ctx.meta
        saved = ctx.saved_tensors
        xa, xc = saved[:2]
        wa, wc = saved[2 : 2 + nl], saved[2 + nl : 2 + 2 * nl]
        ha, hc = saved[2 + 2 * nl : 2 + 3 * nl], saved[2 + 3 * nl :]
        ga = torch.zeros_like(ha[-1]) if ga is None else ga
        gc = torch.zeros_like(hc[-1]) if gc is None else gc
        skip = skip_input_grad or not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
        (dxa, dwa, dba), (dxc, dwc, dbc) = _chain_bwd(
            [xa, xc], [ga, gc], [wa, wc], [ha, hc], activation, trailing, skip, "K2b"
        )
        dxa = None if dxa is None else dxa.to(xa.dtype)
        dxc = None if dxc is None else dxc.to(xc.dtype)
        return (dxa, dxc, None, None, None, None, *dwa, *dba, *dwc, *dbc)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_mlp(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "elu",
    trailing: bool = True,
) -> torch.Tensor:
    """Runs the whole Linear+activation chain as one fused op; returns bf16
    ``[N, out_last]``.  A call that needs no gradient saves no hiddens (the
    primal kernel writes only the output)."""
    activation = activation.lower()
    if not supports_fused_mlp(activation, len(weights), trailing):
        raise ValueError(f"fused_mlp does not take activation '{activation}' with {len(weights)} layers")
    weights, biases = tuple(weights), tuple(biases)
    if _needs_grad(x, *weights, *biases):
        return _FusedMlp.apply(x, activation, trailing, len(weights), *weights, *biases)
    outs, _ = _chain_fwd([x], [weights], [biases], activation, trailing, False, "K1f")
    return outs[0]


def fused_mlp_pair(
    xa: torch.Tensor,
    xc: torch.Tensor,
    weights_a: Sequence[torch.Tensor],
    biases_a: Sequence[torch.Tensor],
    weights_c: Sequence[torch.Tensor],
    biases_c: Sequence[torch.Tensor],
    activation: str = "elu",
    trailing: bool = True,
    *,
    skip_input_grad: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Runs two same-shape chains (actor and critic) in one launch.
    ``skip_input_grad=True`` declares the inputs are data: the backward skips
    layer 0's dX product and returns no input gradient."""
    activation = activation.lower()
    if len(weights_a) != len(weights_c):
        raise ValueError("the two chains must have the same depth")
    if not supports_fused_mlp(activation, len(weights_a), trailing):
        raise ValueError(f"fused_mlp_pair does not take activation '{activation}' with {len(weights_a)} layers")
    xc = xc.to(xa.dtype)
    params = (*weights_a, *biases_a, *weights_c, *biases_c)
    if _needs_grad(xa, xc, *params):
        return _FusedMlpPair.apply(xa, xc, activation, trailing, len(weights_a), bool(skip_input_grad), *params)
    outs, _ = _chain_fwd([xa, xc], [tuple(weights_a), tuple(weights_c)], [tuple(biases_a), tuple(biases_c)],
                         activation, trailing, False, "K2f")
    return outs[0], outs[1]

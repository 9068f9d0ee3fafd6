"""Fused MLP chain kernels on Hopper (counterpart of
``cusrl_tpu/nn/kernels/fused_mlp.py``: ``fused_mlp``, ``fused_mlp_pair`` and
``fused_mlp_pair_heads``).

Two hand-written CUDA kernels (``csrc/mlp_chain_fwd.cu``,
``csrc/mlp_chain_bwd.cu``) run one Linear+activation chain, or two same-shape
chains (actor and critic) in one launch, optionally with fp32 heads on the
chain outputs:

====  ==========================  ==============================================
K1f   ``mlp_chain_fwd`` x1        replaces ``_fwd_kernel`` (``_run_fwd``)
K1b   ``mlp_chain_bwd`` x1        replaces ``_bwd_kernel`` (``_run_bwd``)
K2f   ``mlp_chain_fwd`` x2        replaces ``_pair_fwd_kernel`` (``_pair_run_fwd``)
K2b   ``mlp_chain_bwd`` x2        replaces ``_pair_bwd_kernel`` (``_pair_run_bwd``)
K8f   ``mlp_chain_fwd`` x2+heads  replaces ``_pair_heads_fwd_kernel`` (``_pair_heads_run_fwd``)
K8b   ``mlp_chain_bwd`` x2+heads  replaces ``_pair_heads_bwd_kernel`` (``_pair_heads_run_bwd``)
====  ==========================  ==============================================

``mlp_chain_bwd`` with the PPO loss (K9s), and ``mlp_ppo_step`` (K9m: the
chains' forward, the loss and the backward in one phase-1 launch), are launched from
``fused_ppo_step.py``; their counts live in ``LAUNCHES`` here too.  The heads
are fp32 islands: ``f32(latent) W^T + b`` with fp32 weights, and their
backward keeps the latent's cotangent in fp32 until the activation derivative.

What bounds them on the H100 and what the design does about it is written at
the top of each CUDA source.  The forward (K1f, K2f, K8f) and phase 1 of the
backward (K1b, K2b, K8b, K9s) take their products with wgmma from bf16
images of the weights (``weight_images.py``, shared with the fused block),
the backward's of the transposed weights, made afresh on every call: a
chain whose images fit in a block converts them there; a wider one is packed
into scratch that ``_launch_fwd`` / ``_launch_bwd`` allocates, in a second
launch, and streams through a ring (``weight_images.chain_plan`` and
``chain_bwd_plan`` mirror the kernels' plans, ``fwd_plan`` and ``bwd_plan``
read them from the card; ``ppo_step_plan`` K9m's, which streams the
forward's and the backward's images through one ring).  Beside each kernel
this module keeps its plain PyTorch version, which repeats the kernel's
arithmetic step by step (including the explicit backward formulas): bf16
operands, fp32 accumulation, fp32 bias, round to bf16, activation in fp32 on
the bf16 value, round to bf16 again; the
backward keeps ``d`` in fp32, multiplies it by the activation derivative taken
from the saved post-activation, and feeds ``bf16(d)`` to both products.  gelu
(the tanh form) saves the hidden layers' pre-activations instead: its
derivative comes from them in fp32, and ``h = bf16(gelu(z))`` is recomputed
where a weight gradient needs it.

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per kernel name; the plain versions count nothing.

Layouts are the port's parameter layouts: ``weights[l]`` is ``[out, in]``
fp32, ``biases[l]`` is ``[out]`` fp32, and weight gradients come back
``[out, in]``.

The kernels' products step through k in 16s, so every width they see is a
multiple of 16.  The input width may be any from 1 to ``MAX_WIDTH`` (a gym
task's 4 observations): a launch with a narrow input takes ``x`` with zero
columns up to the next multiple of 16 and ``W_0`` with as many zero columns
(``pad_input``, a copy of each per launch), which leaves every fp32 sum as it
was; the backward gives back ``dW_0`` and ``dX`` without the padding's
columns.  The plain versions take the input as it is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from cusrl_tpu_torch.nn.kernels import dw_phase2, weight_images

__all__ = [
    "LAUNCHES",
    "fused_mlp",
    "fused_mlp_pair",
    "fused_mlp_pair_heads",
    "bwd_plan",
    "fwd_plan",
    "ppo_step_plan",
    "head_bwd_plain",
    "mlp_chain_bwd_plain",
    "mlp_chain_fwd_parallel",
    "mlp_chain_fwd_plain",
    "pad_input",
    "pair_heads_fwd_plain",
    "reset_launch_counts",
    "supports_fused_mlp",
    "warn_tensor_parallel",
]

_BF16 = torch.bfloat16
_ACTIVATION_CODES = {"identity": 0, "none": 0, "elu": 1, "relu": 2, "tanh": 3, "gelu": 4}
# Activations whose derivative is not a function of the output: the grad
# call saves the bf16 PRE-activations of the hidden layers instead, and the
# backward recomputes the activation from them (fused_mlp.py:44-50 of the JAX
# package).  Such a chain ends without an activation.
_PREACT_ACTIVATIONS = ("gelu",)
_GELU_C = 0.7978845608028654  # sqrt(2/pi): the tanh form of jax.nn.gelu
MAX_LAYERS = 8  # MLP_MAX_LAYERS in csrc/mlp_chain.cuh
MAX_WIDTH = 512  # MLP_MAX_WIDTH
WIDTH_MULTIPLE = 16  # the products' k16 steps (wgmma)
ROW_TILE = 64  # mlp::BM (wg::TILE_M)

MAX_HEAD_DIM = 64  # mlp::MAX_HEAD_DIM

LAUNCHES: dict[str, int] = {"K1f": 0, "K1b": 0, "K2f": 0, "K2b": 0, "K8f": 0, "K8b": 0, "K9s": 0, "K9m": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_mlp(activation: str, num_layers: int, trailing: bool = False) -> bool:
    """Exactly what the CUDA kernels take: elu, relu, tanh, gelu (tanh form)
    and identity, 1 to ``MAX_LAYERS`` layers; a gelu chain ends without an
    activation (the JAX rule: its output slot holds the primal)."""
    if not isinstance(activation, str) or activation.lower() not in _ACTIVATION_CODES:
        return False
    if activation.lower() in _PREACT_ACTIVATIONS and trailing:
        return False
    return 1 <= num_layers <= MAX_LAYERS


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
    if activation == "gelu":
        return 0.5 * z * (1.0 + torch.tanh(_GELU_C * (z + 0.044715 * z * z * z)))
    return z


def _dact_plain(activation: str, h: torch.Tensor) -> torch.Tensor:
    """Derivative from the saved post-activation (``_dact_from_h``), or for
    gelu from the saved pre-activation (``_dact_from_z``)."""
    if activation == "gelu":
        u = _GELU_C * (h + 0.044715 * h * h * h)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * 0.044715 * h * h)
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du
    if activation == "elu":
        return torch.clamp(h + 1.0, max=1.0)
    if activation == "relu":
        return (h > 0).float()
    if activation == "tanh":
        return 1.0 - h * h
    return torch.ones_like(h)


def mlp_chain_fwd_plain(x, weights, biases, activation: str, trailing: bool, save_hiddens: bool):
    """Returns ``(out [N, out_last] bf16, [h_1..h_{L-1}] bf16 if save_hiddens)``;
    for gelu the saved ``h_l`` are the pre-activations."""
    num_layers = len(weights)
    h = x.to(_BF16)
    hiddens = []
    for layer, (w, b) in enumerate(zip(weights, biases)):
        z = (h.float() @ w.to(_BF16).float().T + b.float()).to(_BF16)
        h = _act_plain(activation, z.float()).to(_BF16) if (layer < num_layers - 1 or trailing) else z
        if save_hiddens and layer < num_layers - 1:
            hiddens.append(z if activation in _PREACT_ACTIVATIONS else h)
    return h, hiddens


def mlp_chain_fwd_parallel(x, weights, biases, activation: str, trailing: bool):
    """``mlp_chain_fwd_plain``'s output on a chain whose weights may be
    tensor-parallel shards (their ``tp_shard``): the same bf16 numerics, with
    the Megatron operators between the layers (``parallel.tensor``); on
    whole weights the same bits."""
    from cusrl_tpu_torch.parallel.tensor import parallel_chain, shard_of

    num_layers = len(weights)

    def product(h, layer):
        return h.float() @ weights[layer].to(_BF16).float().T

    def finish(y, layer):
        z = (y + biases[layer].float()).to(_BF16)
        return _act_plain(activation, z.float()).to(_BF16) if (layer < num_layers - 1 or trailing) else z

    return parallel_chain(x.to(_BF16), [shard_of(w) for w in weights], product, finish)


_tp_warned = False


def warn_tensor_parallel(mesh_shape) -> None:
    """The one-time notice (a ``UserWarning``, once a process) that model-axis
    sharding takes the sharded Mlp modules off the MLP chain kernels, as
    JAX's ``kernel_mesh_status`` announces its own fallback."""
    global _tp_warned
    if _tp_warned:
        return
    _tp_warned = True
    import warnings

    warnings.warn(
        f"Model-axis sharding on mesh {dict(mesh_shape)} disables the fused MLP chain kernels "
        "(K1f/K1b, K2f/K2b, K8f/K8b, K9s/K9m) on the sharded Mlp modules: the kernels take whole weights and "
        "fuse a chain across the row-parallel boundary, so those modules run their layers plain, with the "
        "collectives between them.  Modules whose weights stay whole (the attention kernels K3f/K3b/K6/K7f, "
        "the fused block K4/K5, an Mlp left replicated) keep their kernels.",
        stacklevel=3,
    )


def pair_heads_fwd_plain(x, weights, biases, head_weight, head_bias, activation: str, trailing: bool, save: bool):
    """One chain of K8f: the chain, then its fp32 head on the bf16 latent
    (``LinearFp32``).  Returns ``(head out [N, dim] fp32, latent bf16 or
    None, [h_1..h_{L-1}] if save)``."""
    latent, hiddens = mlp_chain_fwd_plain(x, weights, biases, activation, trailing, save)
    out = latent.float() @ head_weight.T + head_bias
    return out, (latent if save else None), hiddens


def head_bwd_plain(latent, g, head_weight, gl=None):
    """fp32 head backward of K8b: ``(d latent fp32, dW_head [dim, latent],
    db_head)`` with ``d = g W (+ gl)``."""
    g = g.float()
    d = g @ head_weight
    if gl is not None:
        d = d + gl.float()
    return d, g.T @ latent.float(), g.sum(0)


def mlp_chain_bwd_plain(x, g, weights, hs, activation: str, trailing: bool, skip_input_grad: bool):
    """Gradient chain from the saved activations ``hs = [h_1..h_L]`` (``h_L``
    is the chain output; for gelu ``h_1..h_{L-1}`` are pre-activations); ``g``
    is the output cotangent (bf16 from a loss
    outside, fp32 from a head).  Returns ``(dx fp32 or None, dws [out, in]
    fp32, dbs fp32)``."""
    num_layers = len(weights)
    d = g.float()
    dws: list = [None] * num_layers
    dbs: list = [None] * num_layers
    for layer in reversed(range(num_layers)):
        if layer < num_layers - 1 or trailing:
            d = d * _dact_plain(activation, hs[layer].float())
        d_bf = d.to(_BF16).float()
        if layer > 0 and activation in _PREACT_ACTIVATIONS:  # h = act(z), as the forward rounded it
            h_in = _act_plain(activation, hs[layer - 1].float()).to(_BF16).float()
        else:
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
        ("wpack", ctypes.c_void_p),
    ]


class _Head(ctypes.Structure):
    """Mirror of ``MlpHead`` in csrc/mlp_chain.cuh."""

    _fields_ = [
        ("w", ctypes.c_void_p),
        ("b", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("gl", ctypes.c_void_p),
        ("part", ctypes.c_void_p),
        ("dw", ctypes.c_void_p),
        ("db", ctypes.c_void_p),
        ("dim", ctypes.c_int),
        ("stride", ctypes.c_int),
    ]


class _Loss(ctypes.Structure):
    """Mirror of ``MlpLoss`` in csrc/mlp_chain.cuh."""

    _fields_ = [
        ("action", ctypes.c_void_p),
        ("old_logp", ctypes.c_void_p),
        ("advantage", ctypes.c_void_p),
        ("old_value", ctypes.c_void_p),
        ("returns", ctypes.c_void_p),
        ("std", ctypes.c_void_p),
        ("dstd", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
        ("clip_ratio", ctypes.c_float),
        ("w_surr", ctypes.c_float),
        ("w_value", ctypes.c_float),
        ("loss_clip", ctypes.c_float),
        ("inv_n", ctypes.c_float),
        ("inv_nv", ctypes.c_float),
        ("use_old_value", ctypes.c_int),
    ]


class _Params(ctypes.Structure):
    """Mirror of ``MlpParams`` in csrc/mlp_chain.cuh."""

    _fields_ = [
        ("chain", _Chain * 2),
        ("head", _Head * 2),
        ("loss", _Loss),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("num_layers", ctypes.c_int),
        ("num_rows", ctypes.c_int),
        ("activation", ctypes.c_int),
        ("trailing", ctypes.c_int),
        ("save_hiddens", ctypes.c_int),
        ("x_is_bf16", ctypes.c_int),
        ("skip_input_grad", ctypes.c_int),
        ("head_mode", ctypes.c_int),
        ("num_stages", ctypes.c_int),
    ]


def _library(stem: str) -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels.build import load_library

    lib = load_library(stem)
    fn = getattr(lib, stem)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        lib.mlp_chain_error_string.argtypes = [ctypes.c_int]
        lib.mlp_chain_error_string.restype = ctypes.c_char_p
        if stem == "mlp_chain_bwd":  # (params, [chains,] phase-2 scratch, stream)
            scratch = ctypes.POINTER(dw_phase2.DwScratch)
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, scratch, ctypes.c_void_p]
            lib.mlp_ppo_step.argtypes = [ctypes.POINTER(_Params), scratch, ctypes.c_void_p]
            lib.mlp_ppo_step.restype = ctypes.c_int
            lib.mlp_chain_bwd_plan.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.mlp_chain_bwd_plan.restype = ctypes.c_int
            lib.mlp_ppo_step_plan.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(ctypes.c_int)]
            lib.mlp_ppo_step_plan.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
            lib.mlp_chain_fwd_plan.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.mlp_chain_fwd_plan.restype = ctypes.c_int
    return lib


def _validate(xs, wss, bss=None) -> list[int]:
    """Checks what the kernels take and returns the chain widths (biases are
    checked when given).  Every launch runs it, so the common case takes few
    Python steps; a failing check finds its message on the way out."""
    x0, ws0 = xs[0], wss[0]
    if not 1 <= len(ws0) <= MAX_LAYERS:
        raise ValueError(f"fused MLP kernels take 1 to {MAX_LAYERS} layers; got {len(ws0)}")
    dims = [ws0[0].shape[1], *(w.shape[0] for w in ws0)]
    if any(d % WIDTH_MULTIPLE or not 0 < d <= MAX_WIDTH for d in dims[1:]) or not 0 < dims[0] <= MAX_WIDTH:
        raise ValueError(f"fused MLP kernels take an input width up to {MAX_WIDTH} and hidden and output widths "
                         f"that are multiples of {WIDTH_MULTIPLE} up to {MAX_WIDTH}; got {dims}")
    shapes = [(dims[l + 1], dims[l]) for l in range(len(ws0))]
    index, f32 = x0.get_device(), torch.float32
    for i, (x, ws) in enumerate(zip(xs, wss)):
        bs = bss[i] if bss is not None else ()
        if x.dtype not in (f32, _BF16) or x.dtype != x0.dtype:
            raise TypeError(f"inputs must share one dtype, fp32 or bf16; got {x.dtype}")
        if x.dim() != 2 or x.shape != x0.shape or x.shape[1] != dims[0]:
            raise ValueError(f"input of shape {tuple(x.shape)} does not fit widths {dims}")
        if (len(ws) != len(shapes) or any(w.shape != s or w.dtype != f32 for w, s in zip(ws, shapes))
                or (bss is not None and (len(bs) != len(shapes) or any(
                    b is None or b.shape != s[:1] or b.dtype != f32 for b, s in zip(bs, shapes))))):
            if [ws[0].shape[1], *(w.shape[0] for w in ws)] != dims:
                raise ValueError("the two chains must have the same widths")
            for layer, w in enumerate(ws):
                if w.shape != shapes[layer] or w.dtype != f32:
                    raise ValueError(f"layer {layer}: weight must be fp32 [out, in]; got {w.dtype} {tuple(w.shape)}")
            raise ValueError(f"biases must be fp32 [out] for widths {dims}")
        if any(t.get_device() != index for t in (x, *ws, *bs)):
            raise ValueError("all tensors must lie on one CUDA device")
    if x0.shape[0] >= 2**31:
        raise ValueError("row count exceeds the kernels' int range")
    return dims


def _padded(width: int) -> int:
    return -(-width // WIDTH_MULTIPLE) * WIDTH_MULTIPLE


def pad_input(xs, wss):
    """``(xs, wss)`` as a launch gives them to the kernel: where the input
    width is not a multiple of 16, each ``x`` with zero columns up to the
    next one and each chain's ``W_0`` with as many zero columns (fresh
    tensors); otherwise as they are."""
    width = wss[0][0].shape[1]
    extra = _padded(width) - width
    if not extra:
        return xs, wss
    xs = [torch.nn.functional.pad(x.detach(), (0, extra)) for x in xs]
    wss = [[torch.nn.functional.pad(ws[0].detach(), (0, extra)), *ws[1:]] for ws in wss]
    return xs, wss


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


def _validate_heads(heads, latent: int, device) -> None:
    """Each head is ``(w [dim, latent] fp32, b [dim] fp32 or None, ...)``."""
    for w, b, *_ in heads:
        dim = w.shape[0]
        if w.dim() != 2 or w.shape[1] != latent or w.dtype != torch.float32 or not 0 < dim <= MAX_HEAD_DIM:
            raise ValueError(f"head weight must be fp32 [dim <= {MAX_HEAD_DIM}, {latent}]; got {w.dtype} "
                             f"{tuple(w.shape)}")
        if b is not None and (b.shape != (dim,) or b.dtype != torch.float32):
            raise ValueError(f"head bias must be fp32 [{dim}]")
        if any(t is not None and t.device != device for t in (w, b)):
            raise ValueError("all tensors must lie on one CUDA device")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PLAN_KEYS = ("images", "slots", "resident", "tiles", "blocks", "smem_bytes", "sms", "per_sm")


def fwd_plan(dims, rows: int, chains: int) -> dict:
    """The plan ``mlpf::plan`` makes for a chain forward of widths ``dims``
    on the current card, with the keys of ``weight_images.chain_plan``."""
    p = _params([_padded(dims[0]), *dims[1:]], rows, "elu", True)
    out = (ctypes.c_int * 8)()
    lib = _library("mlp_chain_fwd")
    _check(lib, lib.mlp_chain_fwd_plan(ctypes.byref(p), chains, out), "mlp_chain_fwd_plan")
    return dict(zip(_PLAN_KEYS, out))


def bwd_plan(dims, rows: int, chains: int, skip_input_grad: bool, head_mode: int = 0, head_dim: int = 0) -> dict:
    """The plan ``mlpb::plan`` makes for phase 1 of a chain backward on the
    current card (heads of ``head_dim`` outputs on every chain), with the
    keys of ``weight_images.chain_bwd_plan``."""
    p = _params([_padded(dims[0]), *dims[1:]], rows, "elu", True)
    p.skip_input_grad, p.head_mode = int(skip_input_grad), head_mode
    for i in range(chains):
        p.head[i].dim = head_dim
    out = (ctypes.c_int * 8)()
    lib = _library("mlp_chain_bwd")
    _check(lib, lib.mlp_chain_bwd_plan(ctypes.byref(p), chains, out), "mlp_chain_bwd_plan")
    return dict(zip(_PLAN_KEYS, out))


def ppo_step_plan(dims, rows: int, head_dim: int) -> dict:
    """The plan ``mlpm::plan`` makes for K9m's phase 1 on the current card
    (two chains of widths ``dims``, heads of ``head_dim`` outputs), with the
    keys of ``weight_images.ppo_step_plan``."""
    p = _params([_padded(dims[0]), *dims[1:]], rows, "elu", True)
    p.skip_input_grad, p.head_mode = 1, 2
    for i in range(2):
        p.head[i].dim = head_dim
    out = (ctypes.c_int * 9)()
    lib = _library("mlp_chain_bwd")
    _check(lib, lib.mlp_ppo_step_plan(ctypes.byref(p), out), "mlp_ppo_step_plan")
    return dict(zip((*_PLAN_KEYS, "fwd_images"), out))


def _launch_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter, heads=None):
    """K1f/K2f; with ``heads`` (one ``(w [dim, latent], b [dim])`` per chain)
    K8f, which also returns the heads' fp32 outputs and writes the chain
    outputs only with ``save_hiddens``.  Returns ``(outs, hiddens, head_outs)``
    per chain (``outs`` None where not written)."""
    dims = _validate(xs, wss, bss)
    xs, wss = pad_input(xs, wss)
    dims[0] = xs[0].shape[1]
    num_layers, n = len(dims) - 1, xs[0].shape[0]
    device = xs[0].device
    if heads is not None:
        _validate_heads(heads, dims[-1], device)
    write_out = heads is None or save_hiddens
    written = list(range(num_layers)) if save_hiddens else ([num_layers - 1] if write_out else [])
    xs = [dw_phase2.aligned16(x) for x in xs]
    wss = [[w.contiguous() for w in ws] for ws in wss]  # data_ptr needs no detach
    bss = [[b.contiguous() for b in bs] for bs in bss]
    hss = [[torch.empty(n, dims[l + 1], dtype=_BF16, device=device) for l in written] for _ in xs]
    head_outs = None
    if heads is not None:
        heads = [(dw_phase2.aligned16(w), b.contiguous()) for w, b in heads]  # 16-byte rows for the kernel
        head_outs = [torch.empty(n, w.shape[0], device=device) for w, _ in heads]
    if n > 0:
        p = _params(dims, n, activation, trailing)
        p.save_hiddens = int(save_hiddens)
        p.x_is_bf16 = int(xs[0].dtype == _BF16)
        plan = weight_images.chain_plan(tuple(dims), n, len(xs), _sms(device.index))
        if not plan["resident"]:  # the pack kernel's images, streamed per tile: one buffer for every chain
            p.num_stages = images = plan["images"]
            wpack = torch.empty(len(xs), images * weight_images.STAGE_BYTES // 2, dtype=_BF16, device=device)
        for i, (x, ws, bs, hs) in enumerate(zip(xs, wss, bss, hss)):
            chain = p.chain[i]
            chain.x = x.data_ptr()
            if not plan["resident"]:
                chain.wpack = wpack[i].data_ptr()
            chain.w[:num_layers] = [w.data_ptr() for w in ws]
            chain.b[:num_layers] = [b.data_ptr() for b in bs]
            for l, h in zip(written, hs):
                chain.h[l] = h.data_ptr()
            if heads is not None:
                head = p.head[i]
                head.w, head.b = heads[i][0].data_ptr(), heads[i][1].data_ptr()
                head.out, head.dim = head_outs[i].data_ptr(), heads[i][0].shape[0]
        p.head_mode = int(heads is not None)
        lib = _library("mlp_chain_fwd")
        stream = torch.cuda.current_stream(device.index).cuda_stream
        code = lib.mlp_chain_fwd(ctypes.byref(p), len(xs), stream)
        LAUNCHES[counter] += 1
        _check(lib, code, "mlp_chain_fwd")
    outs = [hs[-1] if write_out else None for hs in hss]
    hiddens = [hs[:-1] if save_hiddens else [] for hs in hss]
    return outs, hiddens, head_outs


def _bwd_params(xs, gs, wss, hss, activation, trailing, skip_input_grad, heads, loss):
    """Checks the inputs of one ``mlp_chain_bwd`` or ``mlp_ppo_step`` launch
    and fills its ``MlpParams``.  Returns ``(p, phase2, results, scratch)``:
    ``phase2`` phase 2's split and scratch (``DwScratch``; None for no
    rows), ``results`` as ``_launch_bwd`` returns them (allocated, written
    by the launch) and ``scratch`` the tensors the launch also reads or
    writes, which must outlive it."""
    dims = _validate(xs, wss)
    width = dims[0]
    xs, wss = pad_input(xs, wss)
    dims[0] = xs[0].shape[1]
    num_layers, n = len(dims) - 1, xs[0].shape[0]
    device = xs[0].device
    xs = [dw_phase2.aligned16(x) for x in xs]
    wss = [[w.detach().contiguous() for w in ws] for ws in wss]
    hss = [[dw_phase2.aligned16(h) for h in hs] for hs in hss]
    if heads is None:
        gs = [dw_phase2.aligned16(g.to(_BF16)) for g in gs]
        for g in gs:
            if g.shape != (n, dims[-1]) or g.device != device:
                raise ValueError(f"cotangent must be [N, {dims[-1]}] on {device}; got {tuple(g.shape)} on {g.device}")
    else:
        _validate_heads(heads, dims[-1], device)
        heads = [tuple(None if t is None else dw_phase2.aligned16(t.detach().float()) for t in head) for head in heads]
        for w, _, g, gl in heads:
            if (loss is None and (g is None or g.shape != (n, w.shape[0]))) or (
                    gl is not None and gl.shape != (n, dims[-1])):
                raise ValueError("head cotangents must be fp32 [N, dim] (and [N, latent] for the latent)")
    for hs in hss:
        if len(hs) != num_layers or any(
            h.dtype != _BF16 or h.shape != (n, dims[l + 1]) or h.device != device for l, h in enumerate(hs)
        ):
            raise ValueError("saved activations must be bf16 [N, width] for every layer, on the inputs' device")
    row_tiles = -(-n // ROW_TILE)
    results = []
    scratch = [xs, wss, hss, gs]
    col_floats = []
    p = _params(dims, n, activation, trailing)
    p.x_is_bf16 = int(xs[0].dtype == _BF16)
    p.skip_input_grad = int(skip_input_grad)
    p.head_mode = 0 if heads is None else (2 if loss is not None else 1)
    for i, (x, ws, hs) in enumerate(zip(xs, wss, hss)):
        dws = [torch.empty(dims[l + 1], dims[l], device=device) for l in range(num_layers)]
        dbs = [torch.empty(dims[l + 1], device=device) for l in range(num_layers)]
        dx = None if skip_input_grad else torch.empty(n, dims[0], device=device)
        ds = [torch.empty(n, dims[l + 1], dtype=_BF16, device=device) for l in range(num_layers)]
        dbp = [torch.empty(max(row_tiles, 1), dims[l + 1], device=device) for l in range(num_layers)]
        scratch.append((ds, dbp))
        chain = p.chain[i]
        chain.x = x.data_ptr()
        chain.dx = None if dx is None else dx.data_ptr()
        if heads is None:
            chain.g = gs[i].data_ptr()
        for l in range(num_layers):
            chain.w[l] = ws[l].data_ptr()
            chain.h[l] = hs[l].data_ptr()
            chain.d[l] = ds[l].data_ptr()
            chain.dbp[l] = dbp[l].data_ptr()
            chain.dw[l] = dws[l].data_ptr()
            chain.db[l] = dbs[l].data_ptr()
        head_grads = None
        col_floats.append(sum(dims[1:]))  # phase 2's column sums: every layer's db, then the head's partials
        if heads is not None:
            w, b, g, gl = heads[i]
            dim = w.shape[0]
            stride = dim * dims[-1] + dim + (0 if loss is None else 2 + (dim if i == 0 else 0))
            col_floats[-1] += stride
            part = torch.empty(max(row_tiles, 1), stride, device=device)
            head_grads = (torch.empty(dim, dims[-1], device=device), torch.empty(dim, device=device))
            scratch.append((part, w, b, g, gl))
            head = p.head[i]
            head.w, head.b = w.data_ptr(), None if b is None else b.data_ptr()
            head.g, head.gl = None if g is None else g.data_ptr(), None if gl is None else gl.data_ptr()
            head.part, head.dim, head.stride = part.data_ptr(), dim, stride
            head.dw, head.db = head_grads[0].data_ptr(), head_grads[1].data_ptr()
        results.append((dx, dws, dbs, head_grads))
    if loss is not None:
        loss.fill(p.loss, n, heads[1][0].shape[0])
    phase2 = None
    if n > 0:
        phase2, tensors = dw_phase2.make_scratch([(dims[l + 1], dims[l]) for l in range(num_layers)], col_floats, n,
                                                 device)
        scratch.append(tensors)
    if width != dims[0]:  # the padding's columns of dW_0 and dX are not given back
        results = [(None if dx is None else dx[:, :width], [dws[0][:, :width], *dws[1:]], dbs, head_grads)
                   for dx, dws, dbs, head_grads in results]
    return p, phase2, results, scratch


def _zeroed(results, loss):
    """The results of a launch over no rows: every sum is 0."""
    for _, dws, dbs, head_grads in results:
        for t in (*dws, *dbs, *(head_grads or ())):
            t.zero_()
    if loss is not None:
        loss.dstd.zero_()
        loss.sums.zero_()
    return results


def _launch_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter, heads=None, loss=None):
    """K1b/K2b from bf16 cotangents ``gs`` of the chain outputs.  With
    ``heads`` (one ``(w [dim, latent], b, g [N, dim] fp32, gl [N, latent] or
    None)`` per chain) K8b: the chains' cotangents come from the heads', and
    each chain's result also carries the head's ``(dw, db)``.  With ``loss``
    (``_LossArgs``) K9s: the heads' cotangents come from the PPO loss; the
    loss's ``dstd`` and ``sums`` are filled in.  Returns
    ``[(dx or None, dws, dbs, head_grads or None)]`` per chain."""
    p, phase2, results, scratch = _bwd_params(xs, gs, wss, hss, activation, trailing, skip_input_grad, heads, loss)
    n = xs[0].shape[0]
    if n == 0:
        return _zeroed(results, loss)
    dims = tuple(p.dims[:p.num_layers + 1])
    head_dim = max(p.head[i].dim for i in range(len(xs))) if heads is not None else 0
    plan = weight_images.chain_bwd_plan(dims, n, len(xs), _sms(xs[0].device.index), bool(skip_input_grad),
                                        p.head_mode, head_dim)
    if not plan["resident"]:  # the pack kernel's images of W_l^T, streamed per tile: one buffer for every chain
        p.num_stages = images = plan["images"]
        wpack = torch.empty(len(xs), images * weight_images.STAGE_BYTES // 2, dtype=_BF16, device=xs[0].device)
        scratch.append(wpack)
        for i in range(len(xs)):
            p.chain[i].wpack = wpack[i].data_ptr()
    lib = _library("mlp_chain_bwd")
    code = lib.mlp_chain_bwd(ctypes.byref(p), len(xs), ctypes.byref(phase2),
                             torch.cuda.current_stream(xs[0].device).cuda_stream)
    LAUNCHES[counter] += 1
    _check(lib, code, "mlp_chain_bwd")
    return results


def _launch_ppo_step(xs, wss, bss, heads, loss, activation, trailing):
    """K9m: in one phase-1 launch, per row tile, both chains' forward from
    ``xs`` and the biases ``bss``, then K9s's heads, loss and backward on the
    activations just produced (no input gradient); the forward's and the
    backward's weight images are packed into one scratch per chain
    (``weight_images.ppo_step_plan``).  ``heads`` and ``loss`` as
    ``_launch_bwd`` takes them for K9s.  Returns ``(results, hiddens)``:
    ``[(None, dws, dbs, head_grads)]`` and the bf16 activations
    ``[h_1..h_L]`` the launch wrote, per chain."""
    dims = _validate(xs, wss, bss)
    n, device = xs[0].shape[0], xs[0].device
    hss = [[torch.empty(n, d, dtype=_BF16, device=device) for d in dims[1:]] for _ in xs]
    p, phase2, results, scratch = _bwd_params(xs, None, wss, hss, activation, trailing, True, heads, loss)
    bss = [[b.detach().contiguous() for b in bs] for bs in bss]
    for i, bs in enumerate(bss):
        for l, b in enumerate(bs):
            p.chain[i].b[l] = b.data_ptr()
    p.save_hiddens = 1
    if n == 0:
        return _zeroed(results, loss), hss
    plan = weight_images.ppo_step_plan(tuple(dims), n, _sms(device.index), max(p.head[0].dim, p.head[1].dim))
    p.num_stages = plan["images"]
    wpack = torch.empty(2, plan["images"] * weight_images.STAGE_BYTES // 2, dtype=_BF16, device=device)
    for i in range(2):
        p.chain[i].wpack = wpack[i].data_ptr()
    lib = _library("mlp_chain_bwd")
    code = lib.mlp_ppo_step(ctypes.byref(p), ctypes.byref(phase2), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["K9m"] += 1
    _check(lib, code, "mlp_ppo_step")
    return results, hss


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _on_cuda(device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); raises on any other device."""
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fused MLP kernels run on CUDA tensors; got {device}")
    return device.type == "cuda"


def _chain_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter):
    """Forward of 1 or 2 chains; returns (outs, hiddens) per chain."""
    if _on_cuda(xs[0].device):
        return _launch_fwd(xs, wss, bss, activation, trailing, save_hiddens, counter)[:2]
    results = [mlp_chain_fwd_plain(x, ws, bs, activation, trailing, save_hiddens) for x, ws, bs in zip(xs, wss, bss)]
    return [r[0] for r in results], [r[1] for r in results]


def _chain_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter):
    """Backward of 1 or 2 chains; returns [(dx or None, dws, dbs)] per chain."""
    if _on_cuda(xs[0].device):
        results = _launch_bwd(xs, gs, wss, hss, activation, trailing, skip_input_grad, counter)
        return [r[:3] for r in results]
    return [
        mlp_chain_bwd_plain(x, g, ws, hs, activation, trailing, skip_input_grad)
        for x, g, ws, hs in zip(xs, gs, wss, hss)
    ]


def _heads_fwd(xs, wss, bss, heads, activation, trailing, save):
    """K8f or its plain version: ``(means/values per chain, outs, hiddens)``;
    ``outs`` and ``hiddens`` only with ``save``."""
    if _on_cuda(xs[0].device):
        outs, hiddens, head_outs = _launch_fwd(xs, wss, bss, activation, trailing, save, "K8f", heads=heads)
        return head_outs, outs, hiddens
    results = [pair_heads_fwd_plain(x, ws, bs, w, b, activation, trailing, save)
               for x, ws, bs, (w, b) in zip(xs, wss, bss, heads)]
    return [r[0] for r in results], [r[1] for r in results], [r[2] for r in results]


def _heads_bwd(xs, heads, wss, hss, activation, trailing, skip_input_grad):
    """K8b or its plain version; ``heads`` as ``_launch_bwd`` takes them.
    Returns ``[(dx or None, dws, dbs, (dw_head, db_head))]`` per chain."""
    if _on_cuda(xs[0].device):
        return _launch_bwd(xs, None, wss, hss, activation, trailing, skip_input_grad, "K8b", heads=heads)
    results = []
    for x, (w, _, g, gl), ws, hs in zip(xs, heads, wss, hss):
        d, dw_head, db_head = head_bwd_plain(hs[-1], g, w, gl)
        dx, dws, dbs = mlp_chain_bwd_plain(x, d, ws, hs, activation, trailing, skip_input_grad)
        results.append((dx, dws, dbs, (dw_head, db_head)))
    return results


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, activation, trailing, num_layers, *params):
        ws, bs = params[:num_layers], params[num_layers:]
        outs, hiddens = _chain_fwd([x], [ws], [bs], activation, trailing, True, "K1f")
        ctx.save_for_backward(x, *ws, *hiddens[0], outs[0])
        ctx.meta = (activation, trailing, num_layers)
        return outs[0]

    @staticmethod
    @once_differentiable
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
    @once_differentiable
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


class _FusedMlpPairHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xa, xc, activation, trailing, num_layers, expose_latent, skip_input_grad, *params):
        nl = num_layers
        wa, ba, wc, bc = params[:nl], params[nl : 2 * nl], params[2 * nl : 3 * nl], params[3 * nl : 4 * nl]
        wm, bm, wv, bv = params[4 * nl :]
        (mean, value), (la, lc), (ha, hc) = _heads_fwd(
            [xa, xc], [wa, wc], [ba, bc], [(wm, bm), (wv, bv)], activation, trailing, True
        )
        ctx.save_for_backward(xa, xc, *wa, *wc, wm, wv, *ha, la, *hc, lc)
        ctx.meta = (activation, trailing, nl, expose_latent, skip_input_grad)
        return (mean, value, la) if expose_latent else (mean, value)

    @staticmethod
    @once_differentiable
    def backward(ctx, gm, gv, gl=None):
        activation, trailing, nl, expose_latent, skip_input_grad = ctx.meta
        saved = ctx.saved_tensors
        xa, xc = saved[:2]
        wa, wc = saved[2 : 2 + nl], saved[2 + nl : 2 + 2 * nl]
        wm, wv = saved[2 + 2 * nl : 4 + 2 * nl]
        ha, hc = saved[4 + 2 * nl : 4 + 3 * nl], saved[4 + 3 * nl :]
        gm = torch.zeros(ha[-1].shape[0], wm.shape[0], device=wm.device) if gm is None else gm
        gv = torch.zeros(hc[-1].shape[0], wv.shape[0], device=wv.device) if gv is None else gv
        skip = skip_input_grad or not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
        (dxa, dwa, dba, (dwm, dbm)), (dxc, dwc, dbc, (dwv, dbv)) = _heads_bwd(
            [xa, xc], [(wm, None, gm, gl if expose_latent else None), (wv, None, gv, None)],
            [wa, wc], [ha, hc], activation, trailing, skip,
        )
        dxa = None if dxa is None else dxa.to(xa.dtype)
        dxc = None if dxc is None else dxc.to(xc.dtype)
        return (dxa, dxc, None, None, None, None, None, *dwa, *dba, *dwc, *dbc, dwm, dbm, dwv, dbv)


def fused_mlp_pair_heads(
    xa: torch.Tensor,
    xc: torch.Tensor,
    weights_a: Sequence[torch.Tensor],
    biases_a: Sequence[torch.Tensor],
    weights_c: Sequence[torch.Tensor],
    biases_c: Sequence[torch.Tensor],
    mean_weight: torch.Tensor,
    mean_bias: torch.Tensor,
    value_weight: torch.Tensor,
    value_bias: torch.Tensor,
    activation: str = "elu",
    trailing: bool = True,
    *,
    expose_latent: bool = False,
    skip_input_grad: bool = True,
):
    """Both chains and the fp32 heads in one launch (K8f; backward K8b).

    Returns ``(mean [N, A] fp32, value [N, Dv] fp32)``, and with
    ``expose_latent=True`` also the actor latent (bf16), whose cotangent flows
    back through K8b.  Head weights are ``[out, in]`` (``head.weight``),
    biases ``[out]``.  A call that needs no gradient writes only the heads'
    outputs (and the latent with ``expose_latent``)."""
    activation = activation.lower()
    if len(weights_a) != len(weights_c):
        raise ValueError("the two chains must have the same depth")
    if not supports_fused_mlp(activation, len(weights_a), trailing):
        raise ValueError(f"fused_mlp_pair_heads does not take activation '{activation}' with {len(weights_a)} layers")
    xc = xc.to(xa.dtype)
    params = (*weights_a, *biases_a, *weights_c, *biases_c, mean_weight, mean_bias, value_weight, value_bias)
    if _needs_grad(xa, xc, *params):
        return _FusedMlpPairHeads.apply(xa, xc, activation, trailing, len(weights_a), bool(expose_latent),
                                        bool(skip_input_grad), *params)
    (mean, value), (la, _), _ = _heads_fwd(
        [xa, xc], [tuple(weights_a), tuple(weights_c)], [tuple(biases_a), tuple(biases_c)],
        [(mean_weight, mean_bias), (value_weight, value_bias)], activation, trailing, bool(expose_latent),
    )
    return (mean, value, la) if expose_latent else (mean, value)

"""Banded sliding-window attention for long sequences on Hopper (counterpart
of ``cusrl_tpu/nn/kernels/banded_attention.py``: ``banded_window_attention``).

One hand-written CUDA kernel (``csrc/banded_attention.cu``):

====  ======================  ==================================================
K7f   ``banded_attention_fwd``  replaces ``_attention_kernel`` (``_banded_pallas``)
====  ======================  ==================================================

What bounds it on the H100 and what the design does about it is written at
the top of the CUDA source.  The public function keeps the JAX layout: q
``[N, H, T, D]``, k/v ``[N, H, W+T, D]`` (cache ++ sequence), ``q_seg
[N, T]``, ``k_seg``/``k_valid [N, W+T]``; the output is fp32.  Query t
(combined position ``W+t``) sees the combined keys ``[t, W+t]`` of its own
segment that ``k_valid`` marks; scores are fp32 ``q.k / sqrt(D)``, minus the
ALiBi slope times the distance where slopes are given; a row with no valid
key is exactly 0.

``banded_plain`` is the plain PyTorch version, laid out as the JAX package's
``_banded_reference``: pad to the banding plan, gather each query block's key
band, an fp32 masked softmax over it.  It is the CPU path, the kernel's oracle
on the card, and the backward: as the JAX package's custom VJP
(``_banded_op_bwd``), the gradient recomputes through it under autograd from
the saved q, k and v (the JAX package has no backward kernel for K7).

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches; the plain version counts nothing.  ALiBi slopes are a sequence of
floats (passed to the kernel by value, so no host-to-device copy).  The
kernel reads its operands in place with their strides (the transformer hands
over a transposed ``q_seg``), as the lane kernels do.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from cusrl_tpu_torch.nn.kernels.operands import in_place, slope_values

__all__ = ["LAUNCHES", "banded_plain", "banded_window_attention", "fwd_plan", "reset_launch_counts"]

MAX_HEADS = 32  # BANDED_MAX_HEADS in csrc/banded_attention.cu
HEAD_DIMS = (8, 16, 32, 64)  # the head dims the kernel is instantiated for
MAX_SMEM = 232448  # the 227 KB a block may use
TC_BLOCK_Q, TC_KEYS = 128, 32  # banded::TC_BQ, TC_KEYS: the tensor-core path's queries a block, keys a chunk
THREADS, BLOCKS_PER_SM = 256, 3  # banded::THREADS, BLOCKS: the lanes path's threads a block at most, three to an SM
MIN_BLOCK_Q = 8  # banded::MIN_BQ
KEYS_PER_PASS = 32  # band::NB: the lanes path's band scores kept in registers

LAUNCHES: dict[str, int] = {"K7f": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain version (CPU path, the kernel's oracle on the card, and the backward)
# ---------------------------------------------------------------------------


def _plan(t_len: int, s_len: int, window: int, block_q: int):
    """Static banding plan (``_plan``): ``(BQ, nQ, num_kb, T_pad, S_pad)``."""
    bq = min(block_q, -(-t_len // 8) * 8)
    num_q = -(-t_len // bq)
    num_kb = 1 + -(-window // bq)
    t_pad, s_pad = num_q * bq, (num_q + num_kb - 1) * bq
    assert s_pad >= s_len, (s_pad, s_len)
    return bq, num_q, num_kb, t_pad, s_pad


def banded_plain(q, k, v, q_seg, k_seg, k_valid, window: int, slopes=None, block_q: int = 128):
    """The function of K7f, step by step as ``_banded_reference``: fp32
    ``[N, H, T, D]``.  Differentiable in q, k and v."""
    n, heads, t_len, dim = q.shape
    bq, num_q, num_kb, t_pad, s_pad = _plan(t_len, k.shape[2], window, block_q)
    dt, ds = t_pad - t_len, s_pad - k.shape[2]
    pad4 = lambda x, d: torch.nn.functional.pad(x, (0, 0, 0, d))
    # Padded queries get segment -2, padded keys -1: they never match anything.
    q, k, v = pad4(q, dt), pad4(k, ds), pad4(v, ds)
    q_seg = torch.nn.functional.pad(q_seg.to(torch.int32), (0, dt), value=-2)
    k_seg = torch.nn.functional.pad(k_seg.to(torch.int32), (0, ds), value=-1)
    k_valid = torch.nn.functional.pad(k_valid.to(torch.int32), (0, ds), value=0)

    device = q.device
    bw = num_kb * bq
    band = torch.arange(num_q, device=device)[:, None] * bq + torch.arange(bw, device=device)[None, :]  # [nQ, BW]
    qb = q.reshape(n, heads, num_q, bq, dim)  # [N, H, nQ, BQ, D]
    kb, vb = k[:, :, band], v[:, :, band]  # [N, H, nQ, BW, D]
    scores = torch.einsum("nhgqd,nhgkd->nhgqk", qb.float(), kb.float()) / math.sqrt(dim)  # [N, H, nQ, BQ, BW]

    q_pos = window + torch.arange(num_q, device=device)[:, None, None] * bq + torch.arange(bq, device=device)[:, None]
    k_pos = band[:, None, :]  # [nQ, 1, BW]
    in_window = (k_pos <= q_pos) & (k_pos >= q_pos - window)  # [nQ, BQ, BW]
    q_seg_b = q_seg.reshape(n, num_q, bq)
    mask = in_window[None] & (q_seg_b[..., None] == k_seg[:, band][:, :, None, :]) & (k_valid[:, band] > 0)[:, :, None, :]
    mask = mask[:, None]  # [N, 1, nQ, BQ, BW]

    if slopes is not None:
        slopes_t = torch.as_tensor(list(slopes), dtype=torch.float32, device=device)
        scores = scores - slopes_t[None, :, None, None, None] * (q_pos - k_pos).float()[None, None]
    scores = torch.where(mask, scores, -1e30)
    weights = torch.softmax(scores, dim=-1)
    weights = torch.where(mask.any(-1, keepdim=True), weights, 0.0)
    out = torch.einsum("nhgqk,nhgkd->nhgqd", weights, vb.float())
    return out.reshape(n, heads, t_pad, dim)[:, :, :t_len]


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------


class _BandedParams(ctypes.Structure):
    """Mirror of ``BandedParams`` in csrc/banded_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("q_seg", ctypes.c_void_p),
        ("k_seg", ctypes.c_void_p),
        ("k_valid", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("heads", ctypes.c_int),
        ("t_len", ctypes.c_int),
        ("window", ctypes.c_int),
        ("dim", ctypes.c_int),
        ("is_bf16", ctypes.c_int),
        ("use_alibi", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("slopes", ctypes.c_float * MAX_HEADS),
    ] + [(name, ctypes.c_longlong * 3) for name in ("sq", "sk", "sv")] + [
        (name, ctypes.c_longlong * 2) for name in ("sqseg", "skseg", "skval")]


def _library() -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels.build import load_library

    lib = load_library("banded_attention")
    if lib.banded_attention_error_string.restype is not ctypes.c_char_p:
        lib.banded_attention_fwd.argtypes = [ctypes.POINTER(_BandedParams), ctypes.c_void_p]
        lib.banded_attention_fwd.restype = ctypes.c_int
        lib.banded_attention_fwd_plan.argtypes = [ctypes.POINTER(_BandedParams), ctypes.POINTER(ctypes.c_int)]
        lib.banded_attention_fwd_plan.restype = ctypes.c_int
        lib.banded_attention_error_string.argtypes = [ctypes.c_int]
        lib.banded_attention_error_string.restype = ctypes.c_char_p
    return lib


def fwd_plan(t_len: int, window: int, dim: int, dtype: torch.dtype) -> dict:
    """K7f's launch plan (``banded::plan_of``).  bf16 with ``dim >= 16``
    takes the tensor-core path: two threads a query (a warp per 16), 128
    queries a block (fewer for a short sequence, a multiple of 16), halved
    while the block's staging does not fit shared memory: the key and value
    rows its warps' chunks of 32 keys reach (``bq - 16 + 32 * chunks``) and
    the block's q rows, each padded by 16 bytes, and a (segment, valid) pair
    per key row; ``passes`` counts the chunks.  fp32, ``dim == 8``, or a
    window too wide for that staging at 16 queries takes the lanes path:
    ``lanes`` per query (each on ``dim / lanes`` columns in 16-byte units,
    at most four), ``256 / lanes`` queries a block (fewer for a short
    sequence, a multiple of 8), halved while the band (its K and V rows and
    (segment, valid) pairs) does not fit; ``passes`` 1 where the band's
    ``window + 1`` scores fit the 32 kept in registers, else 2.  ``block_q``
    is 0 where even the smallest block does not fit (its shared memory is
    then the smallest block's)."""
    size = dtype.itemsize
    if size == 2 and dim >= 16:
        chunks = -(-(16 + window) // TC_KEYS)

        def tc_smem(bq):
            rows = bq - 16 + TC_KEYS * chunks
            return (2 * rows + bq) * (dim + 8) * 2 + rows * 8

        bq = min(TC_BLOCK_Q, -(-t_len // 16) * 16)
        while bq > 16 and tc_smem(bq) > MAX_SMEM:
            bq = max(16, bq // 2 // 16 * 16)
        if tc_smem(bq) <= MAX_SMEM:
            return dict(lanes=2, block_q=bq, threads=2 * bq, smem_bytes=tc_smem(bq), passes=chunks,
                        blocks_per_sm=3 if dim <= 32 else 2, tensor_cores=1)
    lanes = min(dim * size // 16, 4)

    def smem(bq):
        return (bq + window) * (2 * dim * size + 8)

    bq = min(THREADS // lanes, -(-t_len // 8) * 8)
    while bq > MIN_BLOCK_Q and smem(bq) > MAX_SMEM:
        bq = max(MIN_BLOCK_Q, bq // 2)
    fits = smem(bq) <= MAX_SMEM
    return dict(lanes=lanes, block_q=bq if fits else 0, threads=bq * lanes if fits else 0, smem_bytes=smem(bq),
                passes=1 if window < KEYS_PER_PASS else 2, blocks_per_sm=BLOCKS_PER_SM, tensor_cores=0)


def fwd_card_plan(q, window: int) -> dict:
    """The plan ``banded::launch`` makes on the card for queries shaped as
    ``q``, with the keys of ``fwd_plan``."""
    n, heads, t_len, dim = q.shape
    p = _BandedParams()
    p.n, p.heads, p.t_len, p.window, p.dim = n, heads, t_len, window, dim
    p.is_bf16 = int(q.dtype == torch.bfloat16)
    keys = ("lanes", "block_q", "threads", "smem_bytes", "passes", "blocks_per_sm", "tensor_cores")
    out = (ctypes.c_int * len(keys))()
    lib = _library()
    code = lib.banded_attention_fwd_plan(ctypes.byref(p), out)
    if code != 0:
        raise RuntimeError(f"banded_attention_fwd_plan failed: {lib.banded_attention_error_string(code).decode()}")
    return dict(zip(keys, out))


# The fields' stride fields in ``BandedParams``.
_STRIDES = {"q": "sq", "k": "sk", "v": "sv", "q_seg": "sqseg", "k_seg": "skseg", "k_valid": "skval"}


def _fwd_params(q, k, v, q_seg, k_seg, k_valid, window: int, slopes):
    """K7f's parameter block, which reads its operands in place with their
    strides (the main path's q_seg is a transposed view), and the tensors it
    points to (kept alive until the launch)."""
    n, heads, t_len, dim = q.shape
    p = _BandedParams()
    keep = in_place(p, dict(q=q, k=k, v=v, q_seg=q_seg, k_seg=k_seg, k_valid=k_valid), _STRIDES)
    p.n, p.heads, p.t_len, p.window, p.dim = n, heads, t_len, window, dim
    p.is_bf16 = int(q.dtype == torch.bfloat16)
    p.use_alibi = int(slopes is not None)
    p.scale = 1.0 / math.sqrt(dim)
    for i, s in enumerate(slopes or ()):
        p.slopes[i] = float(s)
    return p, keep


def _launch_fwd(q, k, v, q_seg, k_seg, k_valid, window: int, slopes) -> torch.Tensor:
    """K7f: checks what the kernel takes and launches it, reading the
    operands in place; fp32 ``[N, H, T, D]``."""
    if q.dim() != 4:
        raise ValueError(f"q must be [N, H, T, D]; got {tuple(q.shape)}")
    n, heads, t_len, dim = q.shape
    s_len = window + t_len
    if window < 0 or k.shape != (n, heads, s_len, dim) or v.shape != k.shape:
        raise ValueError(f"k/v must be [N, H, W+T, D] = {(n, heads, s_len, dim)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if dim not in HEAD_DIMS or not 0 < heads <= MAX_HEADS or t_len <= 0:
        raise ValueError(f"the banded kernel takes head dims {HEAD_DIMS} and up to {MAX_HEADS} heads; "
                         f"got D={dim}, H={heads}, T={t_len}")
    if q_seg.shape != (n, t_len) or k_seg.shape != (n, s_len) or k_valid.shape != (n, s_len):
        raise ValueError("q_seg must be [N, T] and k_seg/k_valid [N, W+T]")
    if slopes is not None and len(slopes) != heads:
        raise ValueError(f"slopes must have one value per head ({heads})")
    if any(t.device != q.device for t in (k, v, q_seg, k_seg, k_valid)):
        raise ValueError("all tensors must lie on one CUDA device")
    plan = fwd_plan(t_len, window, dim, q.dtype)
    if plan["block_q"] == 0:
        raise ValueError(f"window {window} is too wide for the banded kernel: the key band of its smallest query "
                         f"block needs {plan['smem_bytes']} bytes of shared memory, more than {MAX_SMEM}")
    if n * heads * -(-t_len // plan["block_q"]) >= 2**31 or n * heads * s_len * dim >= 2**62:
        raise ValueError("problem exceeds the kernel's index range")
    out = torch.empty(n, heads, t_len, dim, device=q.device)
    if n == 0:
        return out
    p, keep = _fwd_params(q, k, v, q_seg, k_seg, k_valid, window, slopes)
    p.out = out.data_ptr()
    lib = _library()
    code = lib.banded_attention_fwd(ctypes.byref(p), torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["K7f"] += 1
    if code != 0:
        raise RuntimeError(f"banded_attention_fwd launch failed: {lib.banded_attention_error_string(code).decode()} "
                           f"(cudaError {code})")
    del keep
    return out


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _on_cuda(device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); raises on any other device."""
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"the banded attention kernel runs on CUDA tensors; got {device}")
    return device.type == "cuda"


def _fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes, block_q):
    if _on_cuda(q.device):
        return _launch_fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes)
    return banded_plain(q, k, v, q_seg, k_seg, k_valid, window, slopes, block_q)


class _BandedWindowAttention(torch.autograd.Function):
    """K7f forward (it saves nothing of its own); the backward recomputes
    through ``banded_plain`` under autograd from the saved q, k and v, as
    ``_banded_op_bwd``.  Input gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, k_valid, window, slopes, block_q):
        ctx.save_for_backward(q, k, v, q_seg, k_seg, k_valid)
        ctx.meta = (window, slopes, block_q)
        return _fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes, block_q)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, q_seg, k_seg, k_valid = ctx.saved_tensors
        window, slopes, block_q = ctx.meta
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = banded_plain(*leaves, q_seg, k_seg, k_valid, window, slopes, block_q)
            dq, dk, dv = torch.autograd.grad(out, leaves, g.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None, None


def banded_window_attention(q, k, v, q_seg, k_seg, k_valid, *, window: int,
                            slopes: Sequence[float] | None = None, block_q: int = 128) -> torch.Tensor:
    """Sliding-window segment-masked attention over ``[cache ++ sequence]``
    keys; fp32 ``[N, H, T, D]``, rows with no valid key exactly 0.  ``block_q``
    is the plain version's query block (the CPU path and the backward); the
    kernel takes its own.  A call that needs a gradient saves q, k and v for
    the recomputing backward; one that needs none saves nothing."""
    slopes = slope_values(slopes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandedWindowAttention.apply(q, k, v, q_seg, k_seg, k_valid, int(window), slopes, int(block_q))
    return _fwd(q, k, v, q_seg, k_seg, k_valid, int(window), slopes, int(block_q))

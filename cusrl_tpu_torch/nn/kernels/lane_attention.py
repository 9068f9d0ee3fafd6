"""Windowed, segment-masked attention for short per-env problems on Hopper
(counterpart of ``cusrl_tpu/nn/kernels/lane_attention.py``:
``lane_window_attention`` and ``lane_next_token_attention``).

One hand-written CUDA source (``csrc/lane_attention.cu``) holds three kernels:

====  ======================  ==================================================
K3f   ``lane_attention_fwd``  replaces ``_fwd_kernel`` (``_lane_pallas_fwd``)
K3b   ``lane_attention_bwd``  replaces ``_bwd_kernel`` (``_lane_pallas_bwd``)
K6    ``lane_attention_next`` replaces ``_next_fwd_kernel``
                              (``lane_next_token_attention``)
====  ======================  ==================================================

What bounds them on the H100 and what the design does about it is written at
the top of the CUDA source.  Public functions keep the JAX layout: q
``[N, H, T, D]``, k/v ``[N, H, W+T, D]`` (cache ++ sequence), ``q_seg
[N, T]``, ``k_seg``/``k_valid [N, W+T]``; outputs are fp32.  Query t sees the
combined keys ``[t, W+t]`` (the band ``j = 0..W``, key ``t+j``) under the
segment and validity masks; rows with no valid key are exactly 0.

Beside each kernel is its plain PyTorch version, in the same band form: the
scores of query t against keys ``t+j``, the masked softmax normalised
before the weighted sum, and the backward from the saved probabilities
(``ds = (dw - sum dw w) w / sqrt(D)``; ``dk``/``dv`` summed over the queries
that see each key, ``j`` ascending).  It computes the same function as the
JAX package's dense references ``_lane_reference`` and
``_next_token_reference``.

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches; the plain versions count nothing.  ALiBi slopes are a sequence of
floats (passed to the kernels by value, so no host-to-device copy).  The
kernels read their operands in place with their strides (the transformer
hands over head-split views, a transposed ``q_seg`` and a transposed
cotangent).  K3b writes ``dq``, ``dk`` and ``dv`` in the dtype its caller
asks for: the autograd wrapper takes the inputs' dtype, one rounding of the
kernel's fp32 sums.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from cusrl_tpu_torch.nn.kernels.operands import in_place, slope_values

__all__ = [
    "LAUNCHES",
    "bwd_plan",
    "fwd_plan",
    "lane_bwd_plain",
    "lane_fwd_plain",
    "lane_next_token_attention",
    "lane_window_attention",
    "next_plan",
    "next_token_plain",
    "reset_launch_counts",
]

MAX_HEADS = 32  # LANE_MAX_HEADS in csrc/lane_attention.cu
HEAD_DIMS = (8, 16, 32, 64)  # the head dims the kernels are instantiated for
MAX_QUERIES = 128  # lane::TARGET_THREADS: queries per (env, head) problem

LAUNCHES: dict[str, int] = {"K3f": 0, "K3b": 0, "K6": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _band(x: torch.Tensor, window: int) -> torch.Tensor:
    """``[N, H, W+T, D] -> [N, H, T, D, W+1]``: ``out[..., t, :, j] = x[..., t+j, :]``."""
    return x.float().unfold(2, window + 1, 1)


def _band_mask(q_seg, k_seg, k_valid, window: int) -> torch.Tensor:
    """``[N, 1, T, W+1]``: key ``t+j`` is in query t's segment and valid."""
    b = window + 1
    mask = (k_seg.unfold(1, b, 1) == q_seg[:, :, None]) & (k_valid.unfold(1, b, 1) > 0)
    return mask[:, None]


def _alibi(slopes, distance: torch.Tensor, device) -> torch.Tensor:
    """``[1, H, 1, len(distance)]`` ALiBi bias ``-slope * distance``."""
    slopes = torch.as_tensor(list(slopes), dtype=torch.float32, device=device)
    return -(slopes[None, :, None, None] * distance.float()[None, None, None, :])


def _normalise(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the last axis; rows without a valid key are 0."""
    scores = torch.where(mask, scores, -1e30)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    denom = p.sum(-1, keepdim=True)
    return p * torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom, 1.0), 0.0)


def lane_fwd_plain(q, k, v, q_seg, k_seg, k_valid, window: int, slopes=None, save_probs: bool = False):
    """K3f's function: ``(out [N, H, T, D] fp32, probs [N, H, T, W+1] fp32
    or None)``; ``probs[..., t, j]`` weights key ``t+j``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("nhtd,nhtdj->nhtj", q.float(), _band(k, window)) * scale
    if slopes is not None:
        scores = scores + _alibi(slopes, window - torch.arange(window + 1, device=q.device), q.device)
    probs = _normalise(scores, _band_mask(q_seg, k_seg, k_valid, window))
    out = torch.einsum("nhtj,nhtdj->nhtd", probs, _band(v, window))
    return out, (probs if save_probs else None)


def lane_bwd_plain(q, k, v, probs, g, window: int):
    """K3b's function: ``(dq [N, H, T, D], dk, dv [N, H, W+T, D])`` fp32 from
    the saved probabilities and the output's cotangent ``g``."""
    t_len = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, gf = q.float(), g.float()
    dw = torch.einsum("nhtd,nhtdj->nhtj", gf, _band(v, window))
    rho = (dw * probs).sum(-1, keepdim=True)
    ds = (dw - rho) * probs * scale
    dq = torch.einsum("nhtj,nhtdj->nhtd", ds, _band(k, window))
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for j in range(window + 1):
        dv[:, :, j : j + t_len] += probs[..., j, None] * gf
        dk[:, :, j : j + t_len] += ds[..., j, None] * qf
    return dq, dk, dv


def next_token_plain(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, window: int, slopes=None):
    """K6's function: query t over the band ``j = 1..W`` (ALiBi distance
    ``W+1-j``) plus its own ``k_self``/``v_self`` at distance 0; fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    kb, vb = _band(k, window)[..., 1:], _band(v, window)[..., 1:]
    scores = torch.einsum("nhtd,nhtdj->nhtj", qf, kb) * scale
    if slopes is not None:
        scores = scores + _alibi(slopes, window + 1 - torch.arange(1, window + 1, device=q.device), q.device)
    self_score = (qf * k_self.float()).sum(-1, keepdim=True) * scale
    mask = _band_mask(q_seg, k_seg, k_valid, window)[..., 1:]
    all_scores = torch.cat([self_score, scores], -1)
    all_mask = torch.cat([torch.ones_like(mask[..., :1]), mask], -1).expand(all_scores.shape)
    probs = _normalise(all_scores, all_mask)
    return probs[..., :1] * v_self.float() + torch.einsum("nhtj,nhtdj->nhtd", probs[..., 1:], vb)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------


class _LaneParams(ctypes.Structure):
    """Mirror of ``LaneParams`` in csrc/lane_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("k_self", ctypes.c_void_p),
        ("v_self", ctypes.c_void_p),
        ("q_seg", ctypes.c_void_p),
        ("k_seg", ctypes.c_void_p),
        ("k_valid", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("probs", ctypes.c_void_p),
        ("dq", ctypes.c_void_p),
        ("dk", ctypes.c_void_p),
        ("dv", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("heads", ctypes.c_int),
        ("t_len", ctypes.c_int),
        ("window", ctypes.c_int),
        ("dim", ctypes.c_int),
        ("is_bf16", ctypes.c_int),
        ("use_alibi", ctypes.c_int),
        ("out_bf16", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("slopes", ctypes.c_float * MAX_HEADS),
    ] + [(name, ctypes.c_longlong * 3) for name in ("sq", "sks", "svs", "sk", "sv", "sg")] + [
        (name, ctypes.c_longlong * 2) for name in ("sqseg", "skseg", "skval")]


_ENTRY = {"K3f": "lane_attention_fwd", "K3b": "lane_attention_bwd", "K6": "lane_attention_next"}


def _library() -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels.build import load_library

    lib = load_library("lane_attention")
    if lib.lane_attention_error_string.restype is not ctypes.c_char_p:
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_LaneParams), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("lane_attention_next_plan", "lane_attention_fwd_plan", "lane_attention_bwd_plan"):
            getattr(lib, name).argtypes = [ctypes.POINTER(_LaneParams), ctypes.POINTER(ctypes.c_int)]
            getattr(lib, name).restype = ctypes.c_int
        lib.lane_attention_error_string.argtypes = [ctypes.c_int]
        lib.lane_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(q, k, v, q_seg, k_seg, k_valid, window: int, slopes) -> None:
    """Raises on what the kernels do not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [N, H, T, D]; got {tuple(q.shape)}")
    n, heads, t_len, dim = q.shape
    s_len = window + t_len
    if window < 0 or k.shape != (n, heads, s_len, dim) or v.shape != k.shape:
        raise ValueError(f"k/v must be [N, H, W+T, D] = {(n, heads, s_len, dim)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if dim not in HEAD_DIMS or not 0 < heads <= MAX_HEADS or not 0 < t_len <= MAX_QUERIES:
        raise ValueError(f"the lane kernels take head dims {HEAD_DIMS}, up to {MAX_HEADS} heads and "
                         f"{MAX_QUERIES} queries; got D={dim}, H={heads}, T={t_len}")
    if q_seg.shape != (n, t_len) or k_seg.shape != (n, s_len) or k_valid.shape != (n, s_len):
        raise ValueError("q_seg must be [N, T] and k_seg/k_valid [N, W+T]")
    if slopes is not None and len(slopes) != heads:
        raise ValueError(f"slopes must have one value per head ({heads})")
    tensors = [q, k, v, q_seg, k_seg, k_valid]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must lie on one CUDA device")


def _fill(p: _LaneParams, q, window: int, slopes) -> _LaneParams:
    n, heads, t_len, dim = q.shape
    p.n, p.heads, p.t_len, p.window, p.dim = n, heads, t_len, window, dim
    p.is_bf16 = int(q.dtype == torch.bfloat16)
    p.scale = 1.0 / math.sqrt(dim)
    p.use_alibi = int(slopes is not None)
    for i, s in enumerate(slopes or ()):
        p.slopes[i] = float(s)
    return p


# The fields' stride fields in ``LaneParams``.
_STRIDES = {"q": "sq", "k_self": "sks", "v_self": "svs", "k": "sk", "v": "sv", "g": "sg", "q_seg": "sqseg",
            "k_seg": "skseg", "k_valid": "skval"}


def _fwd_params(q, k, v, q_seg, k_seg, k_valid, window: int, slopes):
    """K3f's parameter block, which reads its operands in place with their
    strides (the main path's q_seg is a transposed view)."""
    _check_inputs(q, k, v, q_seg, k_seg, k_valid, window, slopes)
    p = _LaneParams()
    keep = in_place(p, dict(q=q, k=k, v=v, q_seg=q_seg, k_seg=k_seg, k_valid=k_valid), _STRIDES)
    return _fill(p, q, window, slopes), keep


def _bwd_params(q, k, v, probs, g, q_seg, k_seg, k_valid, window: int):
    """K3b's parameter block, which reads q, k, v and the fp32 cotangent in
    place with their strides (the main path's g is a transposed view of the
    merged heads' gradient) and the saved probabilities as K3f wrote them;
    it reads no mask (a masked key's probability is 0)."""
    _check_inputs(q, k, v, q_seg, k_seg, k_valid, window, None)
    n, heads, t_len, _ = q.shape
    if probs.shape != (n, heads, t_len, window + 1) or probs.dtype != torch.float32 or probs.device != q.device:
        raise ValueError(f"probs must be fp32 [N, H, T, W+1] on {q.device}")
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"the cotangent must be [N, H, T, D] on {q.device}")
    p = _LaneParams()
    keep = in_place(p, dict(q=q, k=k, v=v, g=g if g.dtype == torch.float32 else g.float()), _STRIDES)
    probs = probs.contiguous()
    p.probs = probs.data_ptr()
    return _fill(p, q, window, None), keep + [probs]


def _next_params(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, window: int, slopes):
    """K6's parameter block, which reads its operands in place with their
    strides (the main path's v_self is a view of the projection, q_seg a
    transposed view)."""
    _check_inputs(q, k, v, q_seg, k_seg, k_valid, window, slopes)
    p = _LaneParams()
    operands = dict(q=q, k_self=k_self, v_self=v_self, k=k, v=v, q_seg=q_seg, k_seg=k_seg, k_valid=k_valid)
    keep = in_place(p, operands, _STRIDES)
    return _fill(p, q, window, slopes), keep


NEXT_TARGET_THREADS, NEXT_MAX_THREADS = 256, 512  # lane::NEXT_TARGET_THREADS, NEXT_MAX_THREADS
NEXT_SOFT_SMEM, MAX_SMEM = 64 * 1024, 232448  # lane::NEXT_SOFT_SMEM, lane::MAX_SMEM
KEYS_PER_PASS = 32  # band::NB: K3f's scores and K3b's dw kept in registers
SMALL_THREADS, SMALL_BLOCKS = 288, 3  # lane::SMALL_THREADS, SMALL_BLOCKS


def _block_plan(kernel: str, t_len: int, dim: int, size: int, per_problem: int) -> dict:
    """``lane::block_problems``: lanes per query (each on ``dim / lanes``
    columns in 16-byte units, at most four), problems per block (at least
    256 threads where the queries allow, at most 512, fewer while the
    block's staging of ``per_problem`` bytes a problem exceeds 64 KB),
    threads per block and the dynamic shared memory."""
    lanes = min(dim * size // 16, 4)
    per = t_len * lanes
    pb = max(1, -(-NEXT_TARGET_THREADS // per))
    while pb > 1 and (pb * per > NEXT_MAX_THREADS or pb * per_problem > NEXT_SOFT_SMEM):
        pb -= 1
    if pb * per_problem > MAX_SMEM:
        raise ValueError(f"{kernel} does not fit a block at T={t_len}, D={dim}")
    return dict(lanes=lanes, problems=pb, threads=pb * per, smem_bytes=pb * per_problem)


def next_plan(t_len: int, window: int, dim: int, dtype: torch.dtype) -> dict:
    """K6's launch plan (``lane::launch``, ``_block_plan``) for its staging:
    the K and V rows and one (segment, valid) pair per key, per problem."""
    size = torch.empty((), dtype=dtype).element_size()
    return _block_plan("K6", t_len, dim, size, (window + t_len) * (2 * dim * size + 8))


def _with_passes(plan: dict, window: int) -> dict:
    """A plan with the passes over the band, 1 where its ``window + 1`` keys
    fit the 32 kept in registers, else 2 (computed again in the second), and
    the blocks per SM of the kernel instance launched: three for blocks of
    up to 288 threads (their registers capped to fit), else one."""
    return dict(plan, passes=1 if window < KEYS_PER_PASS else 2,
                blocks_per_sm=SMALL_BLOCKS if plan["threads"] <= SMALL_THREADS else 1)


def fwd_plan(t_len: int, window: int, dim: int, dtype: torch.dtype) -> dict:
    """K3f's launch plan: K6's layout and staging (``next_plan``), the
    scores' passes and blocks per SM (``_with_passes``)."""
    return _with_passes(next_plan(t_len, window, dim, dtype), window)


def bwd_stage_bytes(t_len: int, window: int, dim: int, size: int) -> int:
    """K3b's staging of one problem (``lane::BwdStage``): the K and V rows,
    the q rows, the fp32 cotangent in rows padded by 16 bytes, and the
    probabilities and ds in rows padded to an odd count of floats."""
    return ((2 * (window + t_len) + t_len) * dim * size + t_len * (dim + 4) * 4
            + 2 * t_len * ((window + 1) | 1) * 4)


def bwd_plan(t_len: int, window: int, dim: int, dtype: torch.dtype) -> dict:
    """K3b's launch plan: ``_block_plan`` for its staging
    (``bwd_stage_bytes``), its passes over the band's dw and blocks per SM
    (``_with_passes``)."""
    size = torch.empty((), dtype=dtype).element_size()
    plan = _block_plan("K3b", t_len, dim, size, bwd_stage_bytes(t_len, window, dim, size))
    return _with_passes(plan, window)


def _card_plan(entry: str, q, window: int, keys) -> dict:
    p = _fill(_LaneParams(), q, window, None)
    out = (ctypes.c_int * len(keys))()
    lib = _library()
    code = getattr(lib, entry)(ctypes.byref(p), out)
    if code != 0:
        raise RuntimeError(f"{entry} failed: {lib.lane_attention_error_string(code).decode()}")
    return dict(zip(keys, out))


def next_card_plan(q, window: int) -> dict:
    """The plan ``lane::launch`` makes on the card for K6's queries
    shaped as ``q``, with the keys of ``next_plan``."""
    return _card_plan("lane_attention_next_plan", q, window, ("lanes", "problems", "threads", "smem_bytes"))


def fwd_card_plan(q, window: int) -> dict:
    """The plan ``lane::launch`` makes on the card for K3f's queries shaped
    as ``q``, with the keys of ``fwd_plan``."""
    return _card_plan("lane_attention_fwd_plan", q, window,
                      ("lanes", "problems", "threads", "smem_bytes", "passes", "blocks_per_sm"))


def bwd_card_plan(q, window: int) -> dict:
    """The plan ``lane::launch`` makes on the card for K3b's queries shaped
    as ``q``, with the keys of ``bwd_plan``."""
    return _card_plan("lane_attention_bwd_plan", q, window,
                      ("lanes", "problems", "threads", "smem_bytes", "passes", "blocks_per_sm"))


def _launch(name: str, p: _LaneParams, device) -> None:
    lib = _library()
    code = getattr(lib, _ENTRY[name])(ctypes.byref(p), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        raise RuntimeError(f"{_ENTRY[name]} launch failed: {lib.lane_attention_error_string(code).decode()} "
                           f"(cudaError {code})")


def _launch_fwd(q, k, v, q_seg, k_seg, k_valid, window: int, slopes, save_probs: bool):
    """K3f: ``(out, probs or None)``."""
    p, keep = _fwd_params(q, k, v, q_seg, k_seg, k_valid, window, slopes)
    n, heads, t_len, dim = q.shape
    out = torch.empty(n, heads, t_len, dim, device=q.device)
    probs = torch.empty(n, heads, t_len, window + 1, device=q.device) if save_probs else None
    p.out = out.data_ptr()
    p.probs = None if probs is None else probs.data_ptr()
    _launch("K3f", p, q.device)
    del keep
    return out, probs


def _launch_bwd(q, k, v, probs, g, q_seg, k_seg, k_valid, window: int, out_dtype: torch.dtype = torch.float32):
    """K3b: ``(dq, dk, dv)`` in ``out_dtype`` (fp32, or bf16: the fp32 sums
    rounded once)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3b writes fp32 or bf16 gradients; got {out_dtype}")
    p, keep = _bwd_params(q, k, v, probs, g, q_seg, k_seg, k_valid, window)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    p.out_bf16 = int(out_dtype == torch.bfloat16)
    p.dq, p.dk, p.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    _launch("K3b", p, q.device)
    del keep
    return dq, dk, dv


def _launch_next(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, window: int, slopes):
    """K6: ``out`` fp32."""
    if k_self.shape != q.shape or v_self.shape != q.shape or k_self.dtype != q.dtype or v_self.dtype != q.dtype:
        raise ValueError("k_self/v_self must match q's shape and dtype")
    if k_self.device != q.device or v_self.device != q.device:
        raise ValueError("all tensors must lie on one CUDA device")
    p, keep = _next_params(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, window, slopes)
    out = torch.empty(q.shape, device=q.device)
    p.out = out.data_ptr()
    _launch("K6", p, q.device)
    del keep
    return out


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _on_cuda(device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); raises on any other device."""
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"lane attention kernels run on CUDA tensors; got {device}")
    return device.type == "cuda"


def _fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes, save_probs):
    if _on_cuda(q.device):
        return _launch_fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes, save_probs)
    return lane_fwd_plain(q, k, v, q_seg, k_seg, k_valid, window, slopes, save_probs)


class _LaneWindowAttention(torch.autograd.Function):
    """K3f saving the probabilities; backward K3b.  Input gradients come back
    in the inputs' dtypes (``lane_attention.py:306-321``): on the card K3b
    writes them so (one rounding of its fp32 sums, no cast kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, k_valid, window, slopes):
        out, probs = _fwd(q, k, v, q_seg, k_seg, k_valid, window, slopes, True)
        ctx.save_for_backward(q, k, v, probs, q_seg, k_seg, k_valid)
        ctx.window = window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, probs, q_seg, k_seg, k_valid = ctx.saved_tensors
        if _on_cuda(q.device):
            dq, dk, dv = _launch_bwd(q, k, v, probs, g, q_seg, k_seg, k_valid, ctx.window, q.dtype)
        else:
            dq, dk, dv = lane_bwd_plain(q, k, v, probs, g, ctx.window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def lane_window_attention(q, k, v, q_seg, k_seg, k_valid, *, window: int,
                          slopes: Sequence[float] | None = None) -> torch.Tensor:
    """Windowed segment-masked attention over ``[cache ++ sequence]`` keys;
    fp32 ``[N, H, T, D]``.  A call that needs a gradient saves the
    probabilities (K3f) for K3b; one that needs none takes the primal
    variant, which writes only the output."""
    slopes = slope_values(slopes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _LaneWindowAttention.apply(q, k, v, q_seg, k_seg, k_valid, int(window), slopes)
    return _fwd(q, k, v, q_seg, k_seg, k_valid, int(window), slopes, False)[0]


def lane_next_token_attention(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, *, window: int,
                              slopes: Sequence[float] | None = None) -> torch.Tensor:
    """Counterfactual-append attention (K6): query t (RoPE'd at ``W+t+1``)
    over the value pass's combined keys ``[t+1, W+t]`` plus its own
    ``k_self``/``v_self``; forward only (bootstrap values are consumed
    without gradient).  fp32 ``[N, H, T, D]``."""
    slopes = slope_values(slopes)
    if _on_cuda(q.device):
        return _launch_next(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, int(window), slopes)
    return next_token_plain(q, k_self, v_self, k, v, q_seg, k_seg, k_valid, int(window), slopes)

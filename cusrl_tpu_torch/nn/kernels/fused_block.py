"""Fused transformer-block kernels on Hopper (counterpart of
``cusrl_tpu/nn/kernels/fused_block.py``: ``fused_block_pre``,
``fused_block_post``, ``fused_block_pair_pre``, ``fused_block_pair_post`` and
``supports_fused_block``).

One hand-written CUDA source (``csrc/fused_block.cu``) runs every matmul and
LayerNorm of one pre-norm ``CausalTransformerEncoderLayer`` with residual
gates as two programs around its attention, for one layer (K4) or the actor's
and the critic's layers in one launch (K5):

- pre forward (``fused_block_pre_fwd``): ``h = input_proj(x)``,
  ``qkv = LN1(h) [W_q; W_k; W_v]^T + b``; replaces ``_pre_fwd_kernel`` and
  ``_pair_pre_fwd_kernel``;
- pre backward (``fused_block_pre_bwd``): replaces ``_pre_bwd_kernel`` and
  ``_pair_pre_bwd_kernel``; its phase 1 takes its products with wgmma from
  images of the transposed weights (``pre_bwd_stages``), packed per call and
  kept resident in one block per SM where they fit (``pre_bwd_plan``
  mirrors its plan);
- post forward (``fused_block_post_fwd``, saving or primal):
  ``r1 = h + attn W_o^T + b``, ``out = r1 + FFN(LN2(r1))``; replaces
  ``_post_fwd_kernel`` and ``_pair_post_fwd_kernel``;
- post backward (``fused_block_post_bwd``): replaces ``_post_bwd_kernel``
  and ``_pair_post_bwd_kernel``; its phase 1 takes its products with wgmma
  from images of the transposed weights (``bwd_stages``), packed per call
  and streamed as the post forward's (``post_bwd_plan`` mirrors its plan).

What bounds them on the H100 and what the design does about it is written at
the top of the CUDA source.  The forwards run in two launches: a pack kernel
turns the fp32 weights into bf16 images in the layout the products read
(afresh on every call: the optimizer updates the weights in place), then one
persistent kernel per op walks the row tiles with wgmma products.  The
wrappers allocate the images' scratch (``fwd_stages`` lists them;
``weight_images.pack_plain``, shared with the MLP chain forward, is the pack's
plain version) and ``fwd_grid`` / ``fwd_plan`` give the grid.  Beside the kernels this module keeps their plain
PyTorch versions, which repeat the kernels' arithmetic step by step, the
backwards as explicit formulas (mirrors of the TPU kernels' ``_pre_bwd_kernel``
and ``_post_bwd_kernel``, not autograd of the forward): bf16 operands, fp32
accumulation and bias, LayerNorm in fp32 with the population variance and eps
1e-6, residual adds of two bf16 values rounded to bf16, the FFN activation in
fp32 on the bf16 pre-activation.

The residual ``h`` leaves the pre op as an fp32 tensor holding the bf16
values.  The post backward returns its cotangent in fp32 (the TPU kernel's
``dh``), and PyTorch's autograd would round a gradient to a bf16 input's
dtype; carried as fp32, it reaches the pre backward unrounded, as the Pallas
route hands it over (``tests/test_torch_fused_block.py`` shows the difference).

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises (an activation the kernels do not
take raises there too; on the CPU it takes the reference).  ``LAUNCHES``
counts launches per op (``K4pre_f`` ... ``K5post_b``); the plain versions
count nothing.
Layouts are the port's parameters: weights ``[out, in]`` fp32, biases and
LayerNorm parameters ``[dim]`` fp32; q, k and v keep their three matrices.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from cusrl_tpu_torch.nn.kernels import dw_phase2, weight_images
from cusrl_tpu_torch.nn.kernels.fused_mlp import _ACTIVATION_CODES, _PREACT_ACTIVATIONS, _act_plain, _dact_plain

__all__ = [
    "FWD_GRID",
    "LAUNCHES",
    "bwd_stages",
    "STAGE_COLS",
    "STAGE_ROWS",
    "fused_block_pair_post",
    "fused_block_pair_pre",
    "fused_block_post",
    "fused_block_pre",
    "fwd_grid",
    "fwd_plan",
    "fwd_stages",
    "post_bwd_plain",
    "post_bwd_plan",
    "post_fwd_plain",
    "post_reference",
    "pre_bwd_plain",
    "pre_bwd_plan",
    "pre_bwd_stages",
    "pre_fwd_plain",
    "reset_launch_counts",
    "supports_fused_block",
    "tile_schedule",
]

_BF16 = torch.bfloat16
_SUPPORTED = ("elu", "relu", "tanh", "gelu", "identity", "none")
LN_EPS = 1e-6
MAX_EMBED = 128  # FB_MAX_EMBED in csrc/fused_block.cu
MAX_WIDTH = 512  # MLP_MAX_WIDTH: the input and FFN widths
WIDTH_MULTIPLE = 16  # the products' k16 steps (wgmma)
ROW_TILE = 64  # wg::TILE_M: the backwards' row tiles

LAUNCHES: dict[str, int] = {f"K{k}{op}_{d}": 0 for k in (4, 5) for op in ("pre", "post") for d in ("f", "b")}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_block(activation) -> bool:
    return isinstance(activation, str) and activation.lower() in _SUPPORTED


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _linear_plain(a, w, b):
    """bf16(bf16(a) bf16(W)^T + b) with fp32 accumulation and bias."""
    return (a.to(_BF16).float() @ w.to(_BF16).float().T + b).to(_BF16)


def _ln_plain(x32, g, b):
    """``(y fp32, xhat, inv)``: LayerNorm with the population variance."""
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * inv
    return xhat * g + b, xhat, inv


def _ln_bwd_plain(dy, xhat, inv, g):
    """LayerNorm input cotangent (``_ln_bwd``)."""
    dxhat = dy * g
    return inv * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def pre_fwd_plain(x, w_in, b_in, g1, bb1, w_q, w_k, w_v, b_q, b_k, b_v):
    """``(h [N, E] fp32 holding bf16 values, qkv [N, 3E] bf16)``."""
    h = _linear_plain(x, w_in, b_in)
    y = _ln_plain(h.float(), g1, bb1)[0].to(_BF16)
    return h.float(), _linear_plain(y, torch.cat([w_q, w_k, w_v]), torch.cat([b_q, b_k, b_v]))


def pre_bwd_plain(x, h, gh, gqkv, w_in, w_q, w_k, w_v, g1, bb1, skip_input_grad: bool):
    """``_pre_bwd_kernel``: ``(dx fp32 or None, dw_in, db_in, dg1, dbb1, dw_q,
    dw_k, dw_v, db_q, db_k, db_v)``; ``gh`` (fp32) may be None."""
    embed = w_in.shape[0]
    y, xhat, inv = _ln_plain(h.float(), g1, bb1)
    dqkv = gqkv.float()
    dqkv_bf = dqkv.to(_BF16).float()
    dw_qkv = dqkv_bf.T @ y.to(_BF16).float()  # [3E, E]
    dy = dqkv_bf @ torch.cat([w_q, w_k, w_v]).to(_BF16).float()
    dh = _ln_bwd_plain(dy, xhat, inv, g1)
    if gh is not None:
        dh = dh + gh.float()
    dh_bf = dh.to(_BF16).float()
    dx = None if skip_input_grad else dh_bf @ w_in.to(_BF16).float()
    return (dx, dh_bf.T @ x.to(_BF16).float(), dh.sum(0), (dy * xhat).sum(0), dy.sum(0),
            *dw_qkv.split(embed), *dqkv.sum(0).split(embed))


def post_fwd_plain(attn, h, w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down, activation: str, save: bool):
    """``(out [N, E] bf16, r1 bf16, saved bf16)``, the last two None without
    ``save``; ``saved`` is the pre-activation for gelu, else the hidden."""
    r1 = (h.float() + _linear_plain(attn, w_o, b_o).float()).to(_BF16)
    y2 = _ln_plain(r1.float(), g2, bb2)[0].to(_BF16)
    z1 = _linear_plain(y2, w_up, b_up)
    hid = _act_plain(activation, z1.float()).to(_BF16)
    out = (r1.float() + _linear_plain(hid, w_down, b_down).float()).to(_BF16)
    if not save:
        return out, None, None
    return out, r1, (z1 if activation in _PREACT_ACTIVATIONS else hid)


def post_bwd_plain(attn, g, r1, saved, w_o, w_up, w_down, g2, bb2, activation: str):
    """``_post_bwd_kernel``: ``(dattn fp32, dh fp32, dw_o, db_o, dg2, dbb2,
    dw_up, db_up, dw_down, db_down)``."""
    gf = g.float()
    g_bf = gf.to(_BF16).float()
    s = saved.float()
    hid = _act_plain(activation, s).to(_BF16).float() if activation in _PREACT_ACTIVATIONS else s
    dz1 = (g_bf @ w_down.to(_BF16).float()) * _dact_plain(activation, s)
    dz1_bf = dz1.to(_BF16).float()
    y2, xhat2, inv2 = _ln_plain(r1.float(), g2, bb2)
    dy2 = dz1_bf @ w_up.to(_BF16).float()
    dr1 = gf + _ln_bwd_plain(dy2, xhat2, inv2, g2)
    dr1_bf = dr1.to(_BF16).float()
    return (dr1_bf @ w_o.to(_BF16).float(), dr1, dr1_bf.T @ attn.to(_BF16).float(), dr1.sum(0),
            (dy2 * xhat2).sum(0), dy2.sum(0), dz1_bf.T @ y2.to(_BF16).float(), dz1.sum(0), g_bf.T @ hid, gf.sum(0))


def post_reference(attn, h, w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down, activation):
    """The post block for an activation the kernels do not take
    (``_post_reference``), differentiable by autograd; CPU tensors only (the
    wrappers raise for such an activation on CUDA tensors)."""
    from cusrl_tpu_torch.nn.layer.linear import get_activation

    r1 = (h.float() + _linear_plain(attn, w_o, b_o).float()).to(_BF16)
    y2 = _ln_plain(r1.float(), g2, bb2)[0].to(_BF16)
    hid = get_activation(activation)(_linear_plain(y2, w_up, b_up))
    return (r1.float() + _linear_plain(hid, w_down, b_down).float()).to(_BF16)


# ---------------------------------------------------------------------------
# The forwards' weight images and tile schedule (csrc/fused_block.cu, fbf)
# ---------------------------------------------------------------------------

STAGE_ROWS, STAGE_COLS = weight_images.STAGE_ROWS, weight_images.STAGE_COLS  # one weight image
# (tile rows, blocks per SM) of each forward (fbf::PRE_WGS, fbf::POST_WGS and
# their blocks per SM): 64 rows per consumer warpgroup.
FWD_GRID = {"pre": (128, 1), "post": (64, 2)}


def fwd_stages(op: str, in_dim: int, embed: int, ff: int) -> list[tuple[int, int, int]]:
    """``(matrix, n0, k0)`` of each weight image of the ``"pre"`` or
    ``"post"`` forward, in the order its kernel takes them (``fbf::pre_pack``,
    ``fbf::post_pack``).  Pre's matrices are ``W_in`` and ``[W_q; W_k;
    W_v]``; post's are ``W_o``, ``W_up`` and ``W_down``, the last two by
    128-column chunk of the FFN hidden."""
    def kblocks(k):
        return -(-k // STAGE_COLS)

    def chunks(n):
        return range(0, n, STAGE_ROWS)

    if op == "pre":
        return ([(0, 0, k0) for k0 in range(0, in_dim, STAGE_COLS)]
                + [(1, n0, k0) for n0 in chunks(3 * embed) for k0 in range(0, embed, STAGE_COLS)])
    stages = [(0, 0, k0) for k0 in range(0, embed, STAGE_COLS)]
    for c0 in chunks(ff):
        stages += [(1, c0, k0) for k0 in range(0, embed, STAGE_COLS)]
        stages += [(2, 0, c0 + STAGE_COLS * k) for k in range(kblocks(min(STAGE_ROWS, ff - c0)))]
    return stages


def bwd_stages(embed: int, ff: int) -> list[tuple[int, int, int]]:
    """``(matrix, n0, k0)`` of each weight image of the post backward's
    phase 1 (``fbb::post_bwd_pack``), in the order its kernel takes them: per
    128-column chunk of the FFN hidden, ``W_down^T``'s rows of the chunk by K
    block (``dz1 = g W_down``), then ``W_up^T``'s K blocks of the chunk
    (``dy2 += dz1 W_up``); last ``W_o^T`` by K block (``dattn = dr1 W_o``).
    Matrices 0, 1, 2 are ``W_o``, ``W_up`` and ``W_down``, each transposed
    (``weight_images.pack_plain(..., transpose=(True,) * 3)``)."""
    stages = []
    for c0 in range(0, ff, STAGE_ROWS):
        stages += [(2, c0, k0) for k0 in range(0, embed, STAGE_COLS)]
        stages += [(1, 0, k0) for k0 in range(c0, min(c0 + STAGE_ROWS, ff), STAGE_COLS)]
    return stages + [(0, 0, k0) for k0 in range(0, embed, STAGE_COLS)]


def pre_bwd_stages(in_dim: int, embed: int, skip_input_grad: bool) -> list[tuple[int, int, int]]:
    """``(matrix, n0, k0)`` of each weight image of the pre backward's
    phase 1 (``fbp::pre_bwd_pack``), in the order its kernel takes them:
    ``W_q^T``, ``W_k^T`` and ``W_v^T`` by K block (``dy = gqkv [W_q; W_k;
    W_v]``, the K blocks of the gqkv tile's three segments), then, unless
    ``skip_input_grad``, per 128-column chunk of the input width ``W_in^T``'s
    rows by K block (``dx = dh W_in``).  Matrices 0-3 are ``W_q``, ``W_k``,
    ``W_v`` and ``W_in``, each transposed (``weight_images.pack_plain(...,
    transpose=(True,) * 4)``)."""
    stages = [(q, 0, k0) for q in range(3) for k0 in range(0, embed, STAGE_COLS)]
    if not skip_input_grad:
        stages += [(3, n0, k0) for n0 in range(0, in_dim, STAGE_ROWS) for k0 in range(0, embed, STAGE_COLS)]
    return stages


@functools.lru_cache(maxsize=None)
def _stage_count(op: str, in_dim: int, embed: int, ff: int, skip_input_grad: bool = True) -> int:
    if op == "pre_bwd":
        return len(pre_bwd_stages(in_dim, embed, skip_input_grad))
    return len(bwd_stages(embed, ff)) if op == "post_bwd" else len(fwd_stages(op, in_dim, embed, ff))


BARRIER_BYTES = 2 * 24 * 8  # a ring's barriers: up to 24 slots (fbf::BARRIER_BYTES)
RED_FLOATS = 2 * 3 * 4 * 64  # the column sums' warp partials of both warpgroups, three sets at once (fbb::)
PRE_RED_FLOATS = 2 * 6 * 4 * 64  # the pre backward's: its six sums of a tile at once (fbp::RED_FLOATS)
ROW_FLOATS = 2 * 64 * 4  # the halves of four row sums per warpgroup and row (fbb::ROW_FLOATS)


PRE_BWD_BLOCKS_PER_SM = 1  # fbp::BLOCKS_PER_SM: the qkv images stay resident beside the gqkv tiles
PRE_BWD_GQKV_TILES = 2  # fbp::GQKV_TILES: the next tile's gqkv arrives while one is worked on


def _bwd_layout(what: str, images: int, wg_bytes: int, red_floats: int, embed: int, rows: int, chains: int,
                sms: int, per_sm: int) -> dict:
    """A backward's phase-1 plan through ``fbf::make_layout`` (one set of
    64-row tiles, ``wg_bytes`` of them; LN's two parameters and the column
    and row sums' partials beside them; the ring's slots take what is left
    of the block's share of the SM, resident when every image has one)."""
    par_bytes = ((2 * embed + red_floats + ROW_FLOATS) * 4 + 15) & ~15
    budget = min(weight_images.BLOCK_SMEM, weight_images.SM_SMEM // per_sm - 1024)
    fit = (budget - 1024 - wg_bytes - par_bytes - BARRIER_BYTES) // weight_images.STAGE_BYTES
    if fit < 2:
        raise ValueError(f"no launch plan for {what}")
    slots = min(images, fit)
    tiles = -(-rows // ROW_TILE)
    return dict(images=images, slots=slots, resident=int(slots == images), tiles=tiles,
                blocks=weight_images.persistent_blocks(tiles, per_sm, chains, sms),
                smem_bytes=slots * weight_images.STAGE_BYTES + wg_bytes + par_bytes + 16 * slots + 1024, sms=sms)


@functools.lru_cache(maxsize=256)
def post_bwd_plan(rows: int, chains: int, embed: int, ff: int, sms: int) -> dict:
    """The post backward's phase-1 plan (``fbb::plan`` through
    ``fbf::make_layout``), with the keys of ``fwd_plan``: two consumer
    warpgroups, each taking half of every product's columns, in each of two
    blocks per SM; 64-row tiles of g, r1 and one 128-column chunk of the
    hidden, LN2's parameters and the column and row sums' partials beside
    the ring, whose slots take what is left."""
    wg_bytes = 2 * weight_images.kblocks(embed) * weight_images.ABLOCK_BYTES + 2 * weight_images.ABLOCK_BYTES
    return _bwd_layout(f"the post backward at embed {embed}, ffn {ff}", len(bwd_stages(embed, ff)), wg_bytes,
                       RED_FLOATS, embed, rows, chains, sms, 2)


@functools.lru_cache(maxsize=256)
def pre_bwd_plan(rows: int, chains: int, in_dim: int, embed: int, skip_input_grad: bool, sms: int) -> dict:
    """The pre backward's phase-1 plan (``fbp::plan`` through
    ``fbf::make_layout``), with the keys of ``fwd_plan``: two consumer
    warpgroups, each taking half of every product's columns, in
    ``PRE_BWD_BLOCKS_PER_SM`` block(s) per SM; ``PRE_BWD_GQKV_TILES``
    64-row gqkv tiles (three segments of ``pad64(embed)`` columns each, the
    current one later bf16(dh)), LN1's parameters and the column sums' (six
    sets) and row sums' partials beside the ring."""
    wg_bytes = PRE_BWD_GQKV_TILES * 3 * weight_images.kblocks(embed) * weight_images.ABLOCK_BYTES
    return _bwd_layout(f"the pre backward at input {in_dim}, embed {embed}",
                       len(pre_bwd_stages(in_dim, embed, skip_input_grad)), wg_bytes, PRE_RED_FLOATS, embed, rows,
                       chains, sms, PRE_BWD_BLOCKS_PER_SM)


def fwd_grid(op: str, rows: int, chains: int, num_sms: int) -> tuple[int, int]:
    """``(blocks per chain, tiles per chain)`` of the ``"pre"`` or ``"post"``
    forward's launch (``fbf::plan``): the op's blocks per SM on every SM,
    split between the chains, at most one per tile."""
    tile_rows, per_sm = FWD_GRID[op]
    tiles = -(-rows // tile_rows)
    return weight_images.persistent_blocks(tiles, per_sm, chains, num_sms), tiles


def tile_schedule(op: str, rows: int, chains: int, num_sms: int) -> list[tuple[int, int, int]]:
    """``(chain, block, tile)`` in the order each persistent block walks its
    tiles (``weight_images.tile_schedule``)."""
    return weight_images.tile_schedule(*fwd_grid(op, rows, chains, num_sms), chains)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_P4 = ctypes.c_void_p * 4


class _Chain(ctypes.Structure):
    """Mirror of ``FbChain`` in csrc/fused_block.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("x", "h", "g", "gh", "r1", "s")] + [
        ("w", _P4), ("b", _P4)] + [(name, ctypes.c_void_p) for name in (
            "ln_g", "ln_b", "out0", "out1", "out2", "sa", "sb", "sc", "part", "dw", "sums", "wpack")]


class _Params(ctypes.Structure):
    """Mirror of ``FbParams`` in csrc/fused_block.cu."""

    _fields_ = [("chain", _Chain * 2)] + [(name, ctypes.c_int) for name in (
        "num_rows", "in_dim", "embed", "ff", "activation", "x_is_bf16", "num_stages")]


_ENTRIES = ("fused_block_pre_fwd", "fused_block_pre_bwd", "fused_block_post_fwd", "fused_block_post_bwd")
_PLAN_KEYS = ("images", "slots", "resident", "tiles", "blocks", "smem_bytes", "sms")


def _library() -> ctypes.CDLL:
    from cusrl_tpu_torch.nn.kernels.build import load_library

    lib = load_library("fused_block")
    if lib.fused_block_error_string.restype is not ctypes.c_char_p:
        for name in _ENTRIES:
            fn = getattr(lib, name)
            if name.endswith("_bwd"):  # (params, chains, phase-2 scratch, stream)
                fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.POINTER(dw_phase2.DwScratch),
                               ctypes.c_void_p]
            else:
                fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.fused_block_fwd_plan.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.fused_block_fwd_plan.restype = ctypes.c_int
        for name in ("fused_block_post_bwd_plan", "fused_block_pre_bwd_plan"):
            getattr(lib, name).argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            getattr(lib, name).restype = ctypes.c_int
        lib.fused_block_error_string.argtypes = [ctypes.c_int]
        lib.fused_block_error_string.restype = ctypes.c_char_p
    return lib


def _launch(entry: str, counter: str, p: _Params, chains: int, device, phase2=None) -> None:
    """Launches ``entry``; a backward also takes phase 2's ``DwScratch``."""
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if phase2 is None:
        code = getattr(lib, entry)(ctypes.byref(p), chains, stream)
    else:
        code = getattr(lib, entry)(ctypes.byref(p), chains, ctypes.byref(phase2), stream)
    LAUNCHES[counter] += 1
    if code != 0:
        raise RuntimeError(f"{entry} launch failed: {lib.fused_block_error_string(code).decode()} (cudaError {code})")


def fwd_plan(op: str, rows: int, chains: int, in_dim: int, embed: int, ff: int, activation: str = "gelu",
             save: bool = True) -> dict:
    """The plan ``fbf::plan`` makes for a ``"pre"`` or ``"post"`` forward on
    the current card: weight images per tile, ring slots, whether the images
    stay resident, tiles and blocks per chain, dynamic shared memory, SMs."""
    p = _Params(num_rows=rows, in_dim=in_dim, embed=embed, ff=ff, activation=_ACTIVATION_CODES[activation])
    if save:
        p.chain[0].out1 = 1  # saving mode: the plan reads only whether out1 is set
    out = (ctypes.c_int * 7)()
    lib = _library()
    code = lib.fused_block_fwd_plan(ctypes.byref(p), chains, int(op == "post"), out)
    if code != 0:
        raise RuntimeError(f"fused_block_fwd_plan failed: {lib.fused_block_error_string(code).decode()}")
    return dict(zip(_PLAN_KEYS, out))


def _card_plan(entry: str, p: _Params, chains: int) -> dict:
    out = (ctypes.c_int * 7)()
    lib = _library()
    code = getattr(lib, entry)(ctypes.byref(p), chains, out)
    if code != 0:
        raise RuntimeError(f"{entry} failed: {lib.fused_block_error_string(code).decode()}")
    return dict(zip(_PLAN_KEYS, out))


def bwd_plan(rows: int, chains: int, embed: int, ff: int) -> dict:
    """The plan ``fbb::plan`` makes for the post backward's phase 1 on the
    current card, with the keys of ``post_bwd_plan``."""
    return _card_plan("fused_block_post_bwd_plan", _Params(num_rows=rows, embed=embed, ff=ff), chains)


def pre_bwd_card_plan(rows: int, chains: int, in_dim: int, embed: int, skip_input_grad: bool) -> dict:
    """The plan ``fbp::plan`` makes for the pre backward's phase 1 on the
    current card, with the keys of ``pre_bwd_plan``."""
    p = _Params(num_rows=rows, in_dim=in_dim, embed=embed)
    if not skip_input_grad:
        p.chain[0].out0 = 1  # dX: the plan reads only whether out0 is set
    return _card_plan("fused_block_pre_bwd_plan", p, chains)


def _validate(rows, widths: dict, tensors, device) -> None:
    """Checks what the kernels take: widths that are multiples of 16 (the
    embedding up to MAX_EMBED, the others up to MAX_WIDTH), fp32 parameters,
    every tensor on one device."""
    for name, width in widths.items():
        limit = MAX_EMBED if name == "embed" else MAX_WIDTH
        if width % WIDTH_MULTIPLE or not 0 < width <= limit:
            raise ValueError(f"fused block kernels take {name} widths that are multiples of {WIDTH_MULTIPLE} up "
                             f"to {limit}; got {width}")
    if rows >= 2**31:
        raise ValueError("row count exceeds the kernels' int range")
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError("all tensors must lie on one CUDA device")


def _check_params(params, shapes) -> list[torch.Tensor]:
    for t, shape in zip(params, shapes):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"parameters must be fp32 of shapes {shapes}; got {t.dtype} {tuple(t.shape)}")
    return [t if t.is_contiguous() else t.contiguous() for t in params]


def _pre_shapes(in_dim: int, embed: int):
    e = (embed,)
    return ((embed, in_dim), e, e, e, (embed, embed), (embed, embed), (embed, embed), e, e, e)


def _post_shapes(embed: int, ff: int):
    e = (embed,)
    return ((embed, embed), e, e, e, (ff, embed), (ff,), (embed, ff), e)


def _launch_pre_fwd(xs, pss, counter):
    """``(hs, qkvs)`` per chain."""
    n, in_dim = xs[0].shape
    embed, device = pss[0][0].shape[0], xs[0].device
    _validate(n, {"input": in_dim, "embed": embed}, [*xs, *(t for ps in pss for t in ps)], device)
    if any(x.dtype not in (torch.float32, _BF16) or x.dtype != xs[0].dtype or x.shape != xs[0].shape for x in xs):
        raise TypeError("inputs must share one shape and one dtype, fp32 or bf16")
    stages = _stage_count("pre", in_dim, embed, 0)
    p = _Params(num_rows=n, in_dim=in_dim, embed=embed, x_is_bf16=int(xs[0].dtype == _BF16), num_stages=stages)
    keep, hs, qkvs = [], [], []
    for i, (x, ps) in enumerate(zip(xs, pss)):
        x = dw_phase2.aligned16(x)
        w_in, b_in, g1, bb1, w_q, w_k, w_v, b_q, b_k, b_v = _check_params(ps, _pre_shapes(in_dim, embed))
        h = torch.empty(n, embed, device=device)
        qkv = torch.empty(n, 3 * embed, dtype=_BF16, device=device)
        chain = p.chain[i]
        chain.x, chain.ln_g, chain.ln_b = x.data_ptr(), g1.data_ptr(), bb1.data_ptr()
        for j, (w, b) in enumerate(((w_in, b_in), (w_q, b_q), (w_k, b_k), (w_v, b_v))):
            chain.w[j], chain.b[j] = w.data_ptr(), b.data_ptr()
        wpack = torch.empty(stages, STAGE_ROWS, STAGE_COLS, dtype=_BF16, device=device)
        chain.out0, chain.out1, chain.wpack = h.data_ptr(), qkv.data_ptr(), wpack.data_ptr()
        keep += [x, w_in, b_in, g1, bb1, w_q, w_k, w_v, b_q, b_k, b_v, wpack]
        hs.append(h)
        qkvs.append(qkv)
    if n:
        _launch("fused_block_pre_fwd", counter, p, len(xs), device)
    return hs, qkvs


def _launch_pre_bwd(xs, hs, ghs, gqkvs, pss, skip_input_grad, counter):
    """Per chain ``(dx or None, dw_in, db_in, dg1, dbb1, dw_q, dw_k, dw_v,
    db_q, db_k, db_v)``."""
    n, in_dim = xs[0].shape
    embed, device = pss[0][0].shape[0], xs[0].device
    shapes = _pre_shapes(in_dim, embed)
    _validate(n, {"input": in_dim, "embed": embed}, [*xs, *hs, *ghs, *gqkvs], device)
    row_tiles = max(-(-n // ROW_TILE), 1)
    stages = _stage_count("pre_bwd", in_dim, embed, 0, bool(skip_input_grad))
    p = _Params(num_rows=n, in_dim=in_dim, embed=embed, x_is_bf16=int(xs[0].dtype == _BF16), num_stages=stages)
    keep, results = [], []
    for i, (x, h, gh, gqkv, ps) in enumerate(zip(xs, hs, ghs, gqkvs, pss)):
        w_in, _, g1, bb1, w_q, w_k, w_v, *_ = _check_params(ps, shapes)
        if h.dtype != torch.float32 or h.shape != (n, embed) or gqkv.shape != (n, 3 * embed):
            raise ValueError("h must be fp32 [N, E] and the qkv cotangent [N, 3E]")
        if gh is not None and gh.shape != (n, embed):
            raise ValueError("the residual's cotangent must be [N, E]")
        x, h = dw_phase2.aligned16(x), dw_phase2.aligned16(h)
        gqkv = dw_phase2.aligned16(gqkv.to(_BF16))
        gh = None if gh is None else dw_phase2.aligned16(gh.float())
        dx = None if skip_input_grad else torch.empty(n, in_dim, device=device)
        sa, sb = (torch.empty(n, embed, dtype=_BF16, device=device) for _ in range(2))
        part = torch.empty(row_tiles, 6 * embed, device=device)
        dw = torch.empty(embed * in_dim + 3 * embed * embed, device=device)
        sums = torch.empty(6 * embed, device=device)
        wpack = torch.empty(stages, STAGE_ROWS, STAGE_COLS, dtype=_BF16, device=device)
        chain = p.chain[i]
        chain.x, chain.h, chain.g, chain.wpack = x.data_ptr(), h.data_ptr(), gqkv.data_ptr(), wpack.data_ptr()
        chain.gh = None if gh is None else gh.data_ptr()
        for j, w in enumerate((w_in, w_q, w_k, w_v)):
            chain.w[j] = w.data_ptr()
        chain.ln_g, chain.ln_b = g1.data_ptr(), bb1.data_ptr()
        chain.out0 = None if dx is None else dx.data_ptr()
        chain.sa, chain.sb, chain.part, chain.dw, chain.sums = (t.data_ptr() for t in (sa, sb, part, dw, sums))
        keep += [x, h, gqkv, gh, w_in, w_q, w_k, w_v, g1, bb1, sa, sb, part, wpack]
        dws = dw.split([embed * in_dim] + [embed * embed] * 3)
        db_in, dg1, dbb1, db_q, db_k, db_v = sums.split(embed)
        results.append((dx, dws[0].view(embed, in_dim), db_in, dg1, dbb1, *(d.view(embed, embed) for d in dws[1:]),
                        db_q, db_k, db_v))
    if n:
        shapes = [(embed, in_dim)] + [(embed, embed)] * 3
        kinds = [dw_phase2.H_BF16 if p.x_is_bf16 else dw_phase2.H_F32] + [dw_phase2.H_BF16] * 3
        phase2, tensors = dw_phase2.make_scratch(shapes, [6 * embed] * len(xs), n, device, kinds)
        keep += tensors
        _launch("fused_block_pre_bwd", counter, p, len(xs), device, phase2)
    else:
        for r in results:
            for t in r[1:]:
                t.zero_()
    return results


def _launch_post_fwd(attns, hs, pss, activation, save, counter):
    """``(outs, r1s, saveds)`` per chain (the last two None without ``save``)."""
    n, embed = attns[0].shape
    ff, device = pss[0][4].shape[0], attns[0].device
    _validate(n, {"embed": embed, "ffn": ff}, [*attns, *hs, *(t for ps in pss for t in ps)], device)
    stages = _stage_count("post", 0, embed, ff)
    p = _Params(num_rows=n, embed=embed, ff=ff, activation=_ACTIVATION_CODES[activation], num_stages=stages)
    keep, outs, r1s, saveds = [], [], [], []
    for i, (attn, h, ps) in enumerate(zip(attns, hs, pss)):
        if attn.shape != (n, embed) or h.shape != (n, embed):
            raise ValueError(f"attn and h must be [N, {embed}]")
        attn, h = dw_phase2.aligned16(attn.float()), dw_phase2.aligned16(h.float())
        w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down = _check_params(ps, _post_shapes(embed, ff))
        out = torch.empty(n, embed, dtype=_BF16, device=device)
        r1 = torch.empty(n, embed, dtype=_BF16, device=device) if save else None
        saved = torch.empty(n, ff, dtype=_BF16, device=device) if save else None
        chain = p.chain[i]
        chain.x, chain.h, chain.ln_g, chain.ln_b = attn.data_ptr(), h.data_ptr(), g2.data_ptr(), bb2.data_ptr()
        for j, (w, b) in enumerate(((w_o, b_o), (w_up, b_up), (w_down, b_down))):
            chain.w[j], chain.b[j] = w.data_ptr(), b.data_ptr()
        wpack = torch.empty(stages, STAGE_ROWS, STAGE_COLS, dtype=_BF16, device=device)
        chain.out0, chain.wpack = out.data_ptr(), wpack.data_ptr()
        chain.out1 = None if r1 is None else r1.data_ptr()
        chain.out2 = None if saved is None else saved.data_ptr()
        keep += [attn, h, w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down, wpack]
        outs.append(out)
        r1s.append(r1)
        saveds.append(saved)
    if n:
        _launch("fused_block_post_fwd", counter, p, len(attns), device)
    return outs, r1s, saveds


def _launch_post_bwd(attns, gs, r1s, saveds, wss, activation, counter):
    """Per chain ``(dattn, dh, dw_o, db_o, dg2, dbb2, dw_up, db_up, dw_down,
    db_down)``; ``wss`` holds ``(w_o, w_up, w_down, g2, bb2)`` per chain."""
    n, embed = attns[0].shape
    ff, device = wss[0][1].shape[0], attns[0].device
    _validate(n, {"embed": embed, "ffn": ff}, [*attns, *gs, *r1s, *saveds], device)
    row_tiles = max(-(-n // ROW_TILE), 1)
    num_sums = 4 * embed + ff
    stages = _stage_count("post_bwd", 0, embed, ff)
    p = _Params(num_rows=n, embed=embed, ff=ff, activation=_ACTIVATION_CODES[activation], num_stages=stages)
    keep, results = [], []
    for i, (attn, g, r1, saved, ws) in enumerate(zip(attns, gs, r1s, saveds, wss)):
        w_o, w_up, w_down, g2, bb2 = _check_params(
            ws, ((embed, embed), (ff, embed), (embed, ff), (embed,), (embed,)))
        if g.shape != (n, embed) or r1.dtype != _BF16 or saved.dtype != _BF16 or saved.shape != (n, ff):
            raise ValueError("the cotangent must be [N, E] and the saved r1 / activations bf16 [N, E] / [N, F]")
        attn, r1, saved = dw_phase2.aligned16(attn.float()), dw_phase2.aligned16(r1), dw_phase2.aligned16(saved)
        g = dw_phase2.aligned16(g.to(_BF16))
        dattn, dh = (torch.empty(n, embed, device=device) for _ in range(2))
        sa, sb = (torch.empty(n, embed, dtype=_BF16, device=device) for _ in range(2))
        sc = torch.empty(n, ff, dtype=_BF16, device=device)
        part = torch.empty(row_tiles, num_sums, device=device)
        dw = torch.empty(embed * embed + 2 * ff * embed, device=device)
        sums = torch.empty(num_sums, device=device)
        wpack = torch.empty(stages, STAGE_ROWS, STAGE_COLS, dtype=_BF16, device=device)
        chain = p.chain[i]
        chain.x, chain.g, chain.r1, chain.s = attn.data_ptr(), g.data_ptr(), r1.data_ptr(), saved.data_ptr()
        chain.wpack = wpack.data_ptr()
        for j, w in enumerate((w_o, w_up, w_down)):
            chain.w[j] = w.data_ptr()
        chain.ln_g, chain.ln_b = g2.data_ptr(), bb2.data_ptr()
        chain.out0, chain.out1 = dattn.data_ptr(), dh.data_ptr()
        chain.sa, chain.sb, chain.sc, chain.part, chain.dw, chain.sums = (
            t.data_ptr() for t in (sa, sb, sc, part, dw, sums))
        keep += [attn, g, r1, saved, w_o, w_up, w_down, g2, bb2, sa, sb, sc, part, wpack]
        dw_o, dw_up, dw_down = dw.split([embed * embed, ff * embed, embed * ff])
        db_o, dg2, dbb2, db_up, db_down = sums.split([embed, embed, embed, ff, embed])
        results.append((dattn, dh, dw_o.view(embed, embed), db_o, dg2, dbb2, dw_up.view(ff, embed), db_up,
                        dw_down.view(embed, ff), db_down))
    if n:
        shapes = [(embed, embed), (ff, embed), (embed, ff)]
        kinds = [dw_phase2.H_F32, dw_phase2.H_BF16,  # W_o's attn is fp32; W_down's H saved for gelu
                 dw_phase2.H_SAVED if activation in _PREACT_ACTIVATIONS else dw_phase2.H_BF16]
        phase2, tensors = dw_phase2.make_scratch(shapes, [num_sums] * len(attns), n, device, kinds)
        keep += tensors
        _launch("fused_block_post_bwd", counter, p, len(attns), device, phase2)
    else:
        for r in results:
            for t in r[2:]:
                t.zero_()
    return results


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _on_cuda(device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    plain version); raises on any other device."""
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fused block kernels run on CUDA tensors; got {device}")
    return device.type == "cuda"


def _counter(op: str, chains: int) -> str:
    return f"K{4 if chains == 1 else 5}{op}"


def _pre_fwd(xs, pss):
    if _on_cuda(xs[0].device):
        return _launch_pre_fwd(xs, pss, _counter("pre_f", len(xs)))
    outs = [pre_fwd_plain(x, *ps) for x, ps in zip(xs, pss)]
    return [o[0] for o in outs], [o[1] for o in outs]


def _pre_bwd(xs, hs, ghs, gqkvs, pss, skip_input_grad):
    if _on_cuda(xs[0].device):
        return _launch_pre_bwd(xs, hs, ghs, gqkvs, pss, skip_input_grad, _counter("pre_b", len(xs)))
    return [pre_bwd_plain(x, h, gh, gqkv, ps[0], *ps[4:7], ps[2], ps[3], skip_input_grad)
            for x, h, gh, gqkv, ps in zip(xs, hs, ghs, gqkvs, pss)]


def _post_fwd(attns, hs, pss, activation, save):
    if _on_cuda(attns[0].device):
        return _launch_post_fwd(attns, hs, pss, activation, save, _counter("post_f", len(attns)))
    outs = [post_fwd_plain(a, h, *ps, activation, save) for a, h, ps in zip(attns, hs, pss)]
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]


def _post_bwd(attns, gs, r1s, saveds, wss, activation):
    if _on_cuda(attns[0].device):
        return _launch_post_bwd(attns, gs, r1s, saveds, wss, activation, _counter("post_b", len(attns)))
    return [post_bwd_plain(a, g, r1, s, *ws, activation) for a, g, r1, s, ws in zip(attns, gs, r1s, saveds, wss)]


def _per_chain(flat, chains: int) -> list[tuple]:
    size = len(flat) // chains
    return [tuple(flat[i * size:(i + 1) * size]) for i in range(chains)]


class _Pre(torch.autograd.Function):
    """``chains`` pre ops (K4pre / K5pre); inputs ``(x_0.., *params_0, ..)``,
    outputs ``(h_0.., qkv_0..)``."""

    @staticmethod
    def forward(ctx, chains, skip_input_grad, *tensors):
        xs, flat = tensors[:chains], tensors[chains:]
        hs, qkvs = _pre_fwd(xs, _per_chain(flat, chains))
        ctx.save_for_backward(*xs, *hs, *flat)
        ctx.meta = (chains, skip_input_grad)
        return (*hs, *qkvs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        chains, skip_input_grad = ctx.meta
        saved = ctx.saved_tensors
        xs, hs, pss = saved[:chains], saved[chains:2 * chains], _per_chain(saved[2 * chains:], chains)
        gqkvs = [torch.zeros(h.shape[0], 3 * h.shape[1], dtype=_BF16, device=h.device) if g is None else g
                 for g, h in zip(grads[chains:], hs)]
        skip = skip_input_grad or not any(ctx.needs_input_grad[2:2 + chains])
        results = _pre_bwd(xs, hs, grads[:chains], gqkvs, pss, skip)
        dxs = [None if r[0] is None else r[0].to(x.dtype) for r, x in zip(results, xs)]
        return (None, None, *dxs, *(g for r in results for g in r[1:]))


class _Post(torch.autograd.Function):
    """``chains`` post ops saving r1 and the FFN activations (K4post / K5post);
    inputs ``(attn_0.., h_0.., *params_0, ..)``, outputs ``(out_0..)``."""

    @staticmethod
    def forward(ctx, chains, activation, *tensors):
        attns, hs, flat = tensors[:chains], tensors[chains:2 * chains], tensors[2 * chains:]
        pss = _per_chain(flat, chains)
        outs, r1s, saveds = _post_fwd(attns, hs, pss, activation, True)
        weights = [t for ps in pss for t in (ps[0], ps[4], ps[6], ps[2], ps[3])]  # w_o, w_up, w_down, g2, bb2
        ctx.save_for_backward(*attns, *r1s, *saveds, *weights)
        ctx.meta = (chains, activation, [h.dtype for h in hs])
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        chains, activation, h_dtypes = ctx.meta
        saved = ctx.saved_tensors
        attns, r1s, saveds = saved[:chains], saved[chains:2 * chains], saved[2 * chains:3 * chains]
        wss = _per_chain(saved[3 * chains:], chains)
        gs = [torch.zeros_like(r1) if g is None else g for g, r1 in zip(gs, r1s)]
        results = _post_bwd(attns, gs, r1s, saveds, wss, activation)
        dattns = [r[0].to(a.dtype) for r, a in zip(results, attns)]
        dhs = [r[1].to(dtype) for r, dtype in zip(results, h_dtypes)]
        return (None, None, *dattns, *dhs, *(g for r in results for g in r[2:]))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _pre(xs, pss, skip_input_grad):
    flat = [t for ps in pss for t in ps]
    if _needs_grad(*xs, *flat):
        outs = _Pre.apply(len(xs), bool(skip_input_grad), *xs, *flat)
        return list(outs[:len(xs)]), list(outs[len(xs):])
    return _pre_fwd(xs, pss)


def _post(attns, hs, pss, activation):
    flat = [t for ps in pss for t in ps]
    if _needs_grad(*attns, *hs, *flat):
        return list(_Post.apply(len(attns), activation, *attns, *hs, *flat))
    return _post_fwd(attns, hs, pss, activation, False)[0]  # the primal variant saves nothing


def fused_block_pre(x, w_in, b_in, ln1_scale, ln1_bias, w_q, w_k, w_v, b_q, b_k, b_v, *,
                    skip_input_grad: bool = True):
    """``h = input_proj(x)``; ``qkv = LN1(h) [W_q; W_k; W_v]^T + b`` in one
    op.  Returns ``(h [N, E] fp32 holding bf16 values, qkv [N, 3E] bf16)``.
    ``skip_input_grad=True`` declares x is data (observations): the backward
    returns no input gradient."""
    hs, qkvs = _pre([x], [(w_in, b_in, ln1_scale, ln1_bias, w_q, w_k, w_v, b_q, b_k, b_v)], skip_input_grad)
    return hs[0], qkvs[0]


def fused_block_pair_pre(xa, xc, params_a, params_c, *, skip_input_grad: bool = True):
    """Two pre ops (actor and critic) in one launch; ``params_*`` as
    ``fused_block_pre`` takes them.  Returns ``(ha, hc, qkva, qkvc)``."""
    hs, qkvs = _pre([xa, xc.to(xa.dtype)], [tuple(params_a), tuple(params_c)], skip_input_grad)
    return hs[0], hs[1], qkvs[0], qkvs[1]


def _unsupported_on_cpu(activation, device) -> bool:
    """True when ``activation`` is one the kernels do not take and the tensor
    lies on the CPU (the reference runs, as the TPU package's
    ``_post_reference``); raises for such an activation on CUDA tensors."""
    if supports_fused_block(activation):
        return False
    if _on_cuda(device):
        raise NotImplementedError(f"the fused block kernels do not take activation {activation!r}; "
                                  f"supported: {', '.join(_SUPPORTED)}")
    return True


def fused_block_post(attn, h, w_o, b_o, ln2_scale, ln2_bias, w_up, b_up, w_down, b_down,
                     activation: str = "gelu"):
    """``r1 = h + attn W_o^T + b_o``; ``out = r1 + FFN(LN2(r1))`` in one op;
    ``attn`` is the merged heads' attention (fp32), ``h`` the pre op's
    residual.  Returns bf16 ``[N, E]``.  A call that needs no gradient takes
    the primal variant, which writes only ``out``."""
    params = (w_o, b_o, ln2_scale, ln2_bias, w_up, b_up, w_down, b_down)
    if _unsupported_on_cpu(activation, attn.device):
        return post_reference(attn, h, *params, activation)
    return _post([attn], [h], [params], activation.lower())[0]


def fused_block_pair_post(attna, attnc, ha, hc, params_a, params_c, activation: str = "gelu"):
    """Two post ops (actor and critic) in one launch; ``params_*`` as
    ``fused_block_post`` takes them.  Returns ``(outa, outc)``."""
    if _unsupported_on_cpu(activation, attna.device):
        return (post_reference(attna, ha, *params_a, activation), post_reference(attnc, hc, *params_c, activation))
    outs = _post([attna, attnc], [ha, hc], [tuple(params_a), tuple(params_c)], activation.lower())
    return outs[0], outs[1]

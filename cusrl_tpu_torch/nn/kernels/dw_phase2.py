"""Phase 2 of the backward kernels (``csrc/dw_phase2.cuh``): how its rows are
split over blocks, and the scratch the wrappers allocate for it.

Every backward of the port (K1b, K2b, K8b, K9s, K9m in ``fused_mlp.py`` and
``fused_ppo_step.py``; K4 and K5 pre and post in ``fused_block.py``) ends in
phase 2: each weight gradient ``dW = D^T H`` over all rows, and the column
sums of phase 1's per-row-tile partials.  Its grid is (dW tiles, row splits,
chains): each block sums one 64 x 64 dW tile over one contiguous range of row
tiles into a scratch ``[splits, dW]``, and a second launch adds the splits in
order.  The split comes from ``dw_row_splits``, a pure function of the
shapes, so a shape always gives the same summation order and two calls the
same bits.  Phase 2 reads its operands with 16-byte loads: ``aligned16``
gives the wrappers each operand at such an address.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

__all__ = [
    "DW_TILE",
    "DwScratch",
    "ROW_TILE",
    "SMS",
    "aligned16",
    "dw_row_splits",
    "dw_tile_count",
    "make_scratch",
    "scratch_shapes",
]

ROW_TILE = 64  # rows per row tile: mlp::BM and dw::RT
DW_TILE = 64  # dW tile edge: dw::TILE
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # phase 2's blocks the split aims for on each SM
MIN_TILES_PER_SPLIT = 4  # row tiles a split holds at least (when there are as many)


def dw_tile_count(dw_shapes: Sequence[tuple[int, int]]) -> int:
    """64 x 64 tiles of the weight gradients ``[(n_out, n_in), ...]``."""
    return sum(-(-n_out // DW_TILE) * -(-n_in // DW_TILE) for n_out, n_in in dw_shapes)


def dw_row_splits(row_tiles: int, dw_tiles: int, chains: int, sms: int = SMS) -> tuple[int, int]:
    """``(splits, row tiles per split)`` for phase 2 over ``row_tiles`` row
    tiles with ``dw_tiles`` dW tiles per chain: enough splits for about
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, at least
    ``MIN_TILES_PER_SPLIT`` row tiles per split, one split for few rows.
    Split ``s`` holds row tiles ``[s * per, min((s + 1) * per, row_tiles))``;
    every split but the last holds ``per``, the last at least one."""
    if row_tiles < 1 or dw_tiles < 1 or chains < 1:
        raise ValueError(f"phase 2 needs row tiles, dW tiles and chains; got {row_tiles}, {dw_tiles}, {chains}")
    wanted = -(-BLOCKS_PER_SM * sms // (dw_tiles * chains))
    splits = max(1, min(wanted, row_tiles // MIN_TILES_PER_SPLIT))
    per = -(-row_tiles // splits)
    return -(-row_tiles // per), per


def scratch_shapes(dw_shapes: Sequence[tuple[int, int]], col_floats: Sequence[int],
                   splits: int) -> tuple[tuple[int, int], list[tuple[int, int]]]:
    """Shapes of phase 2's fp32 scratch per chain: the partial dW of every
    job ``[splits, sum(n_out * n_in)]`` and each chain's column sums
    ``[splits, col_floats[c]]``."""
    return (splits, sum(n_out * n_in for n_out, n_in in dw_shapes)), [(splits, c) for c in col_floats]


class DwScratch(ctypes.Structure):
    """Mirror of ``DwScratch`` in csrc/dw_phase2.cuh."""

    _fields_ = [
        ("tiles", ctypes.c_void_p * 2),
        ("cols", ctypes.c_void_p * 2),
        ("splits", ctypes.c_int),
        ("per_split", ctypes.c_int),
        ("dw_floats", ctypes.c_int),
        ("col_floats", ctypes.c_int * 2),
    ]


def make_scratch(dw_shapes: Sequence[tuple[int, int]], col_floats: Sequence[int], num_rows: int,
                 device) -> tuple[DwScratch, list[torch.Tensor]]:
    """Phase 2's split and scratch for one launch over ``num_rows`` (> 0)
    rows and ``len(col_floats)`` chains: ``(the DwScratch, its tensors)``;
    the tensors must outlive the launch."""
    chains = len(col_floats)
    row_tiles = -(-num_rows // ROW_TILE)
    splits, per = dw_row_splits(row_tiles, dw_tile_count(dw_shapes), chains)
    tiles_shape, cols_shapes = scratch_shapes(dw_shapes, col_floats, splits)
    tensors = [torch.empty(tiles_shape, device=device) for _ in range(chains)]
    tensors += [torch.empty(shape, device=device) for shape in cols_shapes]
    s = DwScratch(splits=splits, per_split=per, dw_floats=tiles_shape[1])
    for c in range(chains):
        s.tiles[c], s.cols[c] = tensors[c].data_ptr(), tensors[chains + c].data_ptr()
        s.col_floats[c] = col_floats[c]
    return s, tensors


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at an address phase 2's 16-byte loads can read: a
    contiguous view at another offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()

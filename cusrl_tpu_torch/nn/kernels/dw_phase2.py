"""Phase 2 of the backward kernels (``csrc/dw_phase2.cuh``): its plan (how
its rows are split over blocks and clusters) and the scratch the wrappers
allocate for it.

Every backward of the port (K1b, K2b, K8b, K9s, K9m in ``fused_mlp.py`` and
``fused_ppo_step.py``; K4 and K5 pre and post in ``fused_block.py``) ends in
phase 2: each weight gradient ``dW = D^T H`` over all rows, and the column
sums of phase 1's per-row-tile partials.  It is one launch whose grid is
(row splits, dW tiles, chains): each block sums one dW tile of 128 outputs
and up to 256 inputs (128 where the block converts H: fp32, or a saved gelu
pre-activation; the wrappers name each job's kind of H, ``kinds``) over one
contiguous range of row tiles on wgmma, fed by TMA.  The splits of a tile
form clusters of ``cluster`` blocks that add their partials through
distributed shared memory in rank order; where a tile has more splits than a
cluster, each cluster writes its reduced partial to ``partials`` and the
last cluster of each slice (an integer semaphore in ``counters``) adds them
in cluster order.  The plan comes from ``dw_row_splits``, a pure function of
the shapes, so a shape always gives the same summation order (every call,
every rank) and two calls the same bits.  Phase 2 reads its operands with
TMA, which needs 16-byte aligned rows and addresses: ``aligned16`` gives the
wrappers each operand at such an address.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

__all__ = [
    "DW_TILE",
    "DwScratch",
    "H_BF16",
    "H_F32",
    "H_SAVED",
    "MAX_JOBS",
    "ROW_TILE",
    "WAVE",
    "aligned16",
    "col_chunk",
    "dw_row_splits",
    "dw_tile_count",
    "make_scratch",
    "scratch_shapes",
    "split_range",
]

ROW_TILE = 64  # rows per row tile: mlp::BM and dw::RT
DW_TILE = 128  # dW tile outputs: dw::TILE_M
DW_TILE_N, DW_TILE_N_CONVERTED = 256, 128  # dW tile inputs, H bf16 and H converted: dw::TILE_N, TILE_N_CONVERTED
# What a job's H is (dw::HKind), which the wrappers choose and the kernel
# takes as given: bf16 as the products read it; fp32, which the blocks round
# to bf16; a saved bf16 gelu pre-activation z, which they turn into bf16(gelu(z)).
H_BF16, H_F32, H_SAVED = 0, 1, 2
MAX_JOBS = 8  # DW_MAX_JOBS
# Blocks an H100 SXM runs at once (one a SM) in clusters of 1, 2, 4 and 8, as
# ``dw_phase2_max_blocks`` reads them there: 132 SMs, 120 in clusters of 4 or
# 8, which the GPCs' SM counts leave short.
WAVE = {1: 132, 2: 132, 4: 120, 8: 120}
MAX_CLUSTER = 8  # dw::MAX_CLUSTER
MIN_TILES_PER_SPLIT = 4  # row tiles a split holds at least (when there are as many)
COL_ALIGN = 32  # the column sums of a tile, a multiple of this


def dw_tile_count(dw_shapes: Sequence[tuple[int, int]], kinds: Sequence[int] = ()) -> int:
    """dW tiles of the weight gradients ``[(n_out, n_in), ...]`` whose H are
    of ``kinds`` (``H_BF16`` where not given): 128 outputs by 256 inputs, or
    by 128 where the blocks convert H (``H_F32``, ``H_SAVED``)."""
    kinds = list(kinds) + [H_BF16] * (len(dw_shapes) - len(kinds))
    return sum(-(-n_out // DW_TILE) * -(-n_in // (DW_TILE_N if k == H_BF16 else DW_TILE_N_CONVERTED))
               for (n_out, n_in), k in zip(dw_shapes, kinds))


def dw_row_splits(row_tiles: int, dw_tiles: int, chains: int) -> tuple[int, int]:
    """``(splits, cluster)`` for phase 2 over ``row_tiles`` row tiles with
    ``dw_tiles`` dW tiles per chain.  For each cluster (a power of two up to
    ``MAX_CLUSTER``) the splits a tile wants fill one wave of blocks in such
    clusters (``WAVE``), at least ``MIN_TILES_PER_SPLIT`` row tiles each,
    rounded down to whole clusters; the largest cluster that keeps three
    quarters of the most splits any cluster gives wins (a larger cluster
    leaves less to the last cluster's sum).  One split for few rows.  Split
    ``s`` holds the row tiles of ``split_range(row_tiles, splits, s)``, at
    least one."""
    if row_tiles < 1 or dw_tiles < 1 or chains < 1:
        raise ValueError(f"phase 2 needs row tiles, dW tiles and chains; got {row_tiles}, {dw_tiles}, {chains}")
    splits = {}
    for cluster in (8, 4, 2, 1):
        wanted = max(1, min(WAVE[cluster] // (dw_tiles * chains), row_tiles // MIN_TILES_PER_SPLIT))
        splits[cluster] = wanted // cluster * cluster
    best = max(splits.values())
    cluster = next(c for c in (8, 4, 2, 1) if splits[c] and 4 * splits[c] >= 3 * best)
    return splits[cluster], cluster


def split_range(row_tiles: int, splits: int, s: int) -> range:
    """The row tiles of split ``s``: ``[s R / S, (s + 1) R / S)``, rounded
    down, so that the splits differ by one row tile at most."""
    return range(s * row_tiles // splits, (s + 1) * row_tiles // splits)


def col_chunk(col_floats: Sequence[int], dw_tiles: int) -> int:
    """Column sums each tile's blocks take (tile t the columns ``[t c, (t + 1)
    c)`` of each chain): the chains' most over the tiles, rounded up to
    ``COL_ALIGN``."""
    per_tile = -(-max(col_floats) // dw_tiles)
    return -(-per_tile // COL_ALIGN) * COL_ALIGN


def scratch_shapes(dw_tiles: int, chains: int, splits: int, cluster: int, chunk: int) -> tuple | None:
    """Shape of phase 2's fp32 scratch: each cluster's reduced vector of each
    tile (its partial tile, then its column sums), at the widest tile's
    stride, ``[chains, tiles, clusters, 128 * 256 + chunk]``; ``None`` where
    one cluster holds every split of a tile."""
    clusters = splits // cluster
    return None if clusters == 1 else (chains, dw_tiles, clusters, DW_TILE * DW_TILE_N + chunk)


class DwScratch(ctypes.Structure):
    """Mirror of ``DwScratch`` in csrc/dw_phase2.cuh."""

    _fields_ = [
        ("partials", ctypes.c_void_p),
        ("counters", ctypes.c_void_p),
        ("splits", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("col_chunk", ctypes.c_int),
        ("kinds", ctypes.c_int * MAX_JOBS),
    ]


# The semaphores, int32 zeros, per device and stream: a launch leaves its
# counters at 0 (each slice's last block resets its own), so launches on one
# stream share them in turn; another stream takes its own.
_counters: dict[tuple[str, int], torch.Tensor] = {}


def _semaphores(device, count: int) -> torch.Tensor:
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (str(device), stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < count:
        buf = _counters[key] = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
    return buf


def make_scratch(dw_shapes: Sequence[tuple[int, int]], col_floats: Sequence[int], num_rows: int,
                 device, kinds: Sequence[int]) -> tuple[DwScratch, list[torch.Tensor]]:
    """Phase 2's plan and scratch for one launch over ``num_rows`` (> 0) rows
    and ``len(col_floats)`` chains, each job's H of ``kinds[j]`` (which the
    kernel takes as given): ``(the DwScratch, its tensors)``; the tensors
    must outlive the launch."""
    if len(kinds) != len(dw_shapes) or len(kinds) > MAX_JOBS or not set(kinds) <= {H_BF16, H_F32, H_SAVED}:
        raise ValueError(f"phase 2 needs a kind of H for each of its at most {MAX_JOBS} jobs; got {kinds}")
    chains = len(col_floats)
    tiles = dw_tile_count(dw_shapes, kinds)
    splits, cluster = dw_row_splits(-(-num_rows // ROW_TILE), tiles, chains)
    chunk = col_chunk(col_floats, tiles)
    s = DwScratch(splits=splits, cluster=cluster, tiles=tiles, col_chunk=chunk,
                  kinds=(ctypes.c_int * MAX_JOBS)(*kinds))
    shape = scratch_shapes(tiles, chains, splits, cluster, chunk)
    if shape is None:
        return s, []
    partials = torch.empty(shape, device=device)
    counters = _semaphores(device, chains * tiles * cluster)
    s.partials, s.counters = partials.data_ptr(), counters.data_ptr()
    return s, [partials, counters]


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at an address phase 2's TMA loads can read: a
    contiguous view at another offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()

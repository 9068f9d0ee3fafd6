"""The Hopper forwards' weight images and persistent tile schedule, in Python
(``csrc/hopper_wg.cuh``: ``wg::Pack``, ``wg::pack_unit``; used by the fused
block's forwards, ``fused_block.py``, and the MLP chain forward,
``fused_mlp.py``).

A weight image is rows ``[n0, n0 + 128)`` and columns ``[k0, k0 + 64)`` of
one fp32 ``[out, in]`` matrix as bf16, each image row's 16-byte chunks
swizzled (chunk ``c`` at ``c ^ (row % 8)``: the 128-byte swizzle wgmma reads),
0 past the matrix.  A kernel takes its images in a fixed order, listed here as
``(matrix, n0, k0)`` per image; ``pack_plain`` is the pack's plain version.

The MLP chain forward's launch plan (``mlpf::plan`` in
``csrc/mlp_chain_fwd.cu``) is mirrored by ``chain_plan``: whether a chain's
images stay resident in a block or stream through a ring, the ring's slots,
the blocks per SM and the shared memory per block.  Persistent blocks take
tiles ``b``, ``b + blocks``, ... of their chain (``tile_schedule``).  Nothing
here touches a card.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "STAGE_BYTES",
    "STAGE_COLS",
    "STAGE_ROWS",
    "TILE_ROWS",
    "chain_plan",
    "chain_stages",
    "pack_plain",
    "persistent_blocks",
    "tile_schedule",
    "unpack_plain",
]

STAGE_ROWS, STAGE_COLS = 128, 64  # one image, [128][64] bf16 (wg::STAGE_N, wg::KBLOCK)
STAGE_BYTES = STAGE_ROWS * STAGE_COLS * 2
TILE_ROWS = 64  # rows of one warpgroup product (wg::TILE_M)
ABLOCK_BYTES = TILE_ROWS * STAGE_COLS * 2  # one 64-column K block of a 64-row activation tile
SM_SMEM, BLOCK_SMEM = 233472, 232448  # shared memory of one SM, the most one block may use (mlpf::)
SLOT_COST = STAGE_BYTES + 16  # a ring slot and its two barriers (mlpf::SLOT_COST)


def kblocks(k: int) -> int:
    return -(-k // STAGE_COLS)


def _swizzle_index() -> torch.Tensor:
    """``[128, 8, 8]``: where logical 16-byte chunk ``c`` of image row ``n``
    sits, ``c ^ (n % 8)``, repeated over the chunk's eight values."""
    n = torch.arange(STAGE_ROWS)[:, None]
    return (torch.arange(8)[None, :] ^ (n % 8))[..., None].expand(STAGE_ROWS, 8, 8)


def pack_plain(matrices, stages) -> torch.Tensor:
    """The plain version of the pack (``wg::pack_unit`` over every unit of
    every image): bf16 ``[len(stages), 128, 64]`` images of the matrices'
    slices, 0 past a matrix's edge, each row's 16-byte chunks swizzled (on
    the CPU)."""
    out = torch.zeros(len(stages), STAGE_ROWS, 8, 8, dtype=torch.bfloat16)
    for img, (m, n0, k0) in zip(out, stages):
        part = matrices[m][n0:n0 + STAGE_ROWS, k0:k0 + STAGE_COLS].detach().cpu().to(torch.bfloat16)
        logical = torch.zeros(STAGE_ROWS, STAGE_COLS, dtype=torch.bfloat16)
        logical[:part.shape[0], :part.shape[1]] = part
        img.scatter_(1, _swizzle_index(), logical.view(STAGE_ROWS, 8, 8))
    return out.view(len(stages), STAGE_ROWS, STAGE_COLS)


def unpack_plain(images, stages, shapes) -> list[torch.Tensor]:
    """The bf16 matrices of ``shapes`` whose images ``images`` holds: the
    inverse of ``pack_plain``."""
    mats = [torch.zeros(shape, dtype=torch.bfloat16) for shape in shapes]
    for img, (m, n0, k0) in zip(images.view(-1, STAGE_ROWS, 8, 8), stages):
        logical = img.gather(1, _swizzle_index()).view(STAGE_ROWS, STAGE_COLS)
        rows, cols = min(STAGE_ROWS, shapes[m][0] - n0), min(STAGE_COLS, shapes[m][1] - k0)
        mats[m][n0:n0 + rows, k0:k0 + cols] = logical[:rows, :cols]
    return mats


def persistent_blocks(tiles: int, per_sm: int, chains: int, sms: int) -> int:
    """Blocks per chain of a persistent forward: ``per_sm`` blocks on every
    SM, split between the chains, at most one per tile."""
    return max(1, min(tiles, per_sm * sms // chains))


def tile_schedule(blocks: int, tiles: int, chains: int) -> list[tuple[int, int, int]]:
    """``(chain, block, tile)`` in the order each persistent block walks its
    tiles: block ``b`` takes tiles ``b``, ``b + blocks``, ..."""
    return [(c, b, t) for c in range(chains) for b in range(blocks) for t in range(b, tiles, blocks)]


def chain_stages(dims) -> list[tuple[int, int, int]]:
    """``(layer, n0, k0)`` of each image of an MLP chain of widths ``dims``
    in the order the chain forward takes them (``mlpf::chain_pack``): per
    layer, per 128-row chunk of its output, per 64-column K block."""
    return [(l, n0, k0) for l in range(len(dims) - 1)
            for n0 in range(0, dims[l + 1], STAGE_ROWS) for k0 in range(0, dims[l], STAGE_COLS)]


@functools.lru_cache(maxsize=256)
def chain_plan(dims: tuple, rows: int, chains: int, sms: int) -> dict:
    """The MLP chain forward's launch plan (``mlpf::plan``): images per
    tile, ring slots, whether the images stay resident (converted once per
    block, no pack launch) or stream (packed into ``images`` x 16 KB of
    device memory per chain), 64-row tiles and blocks per chain, dynamic
    shared memory per block, SMs and blocks per SM.  The block's two
    activation tiles hold the even and the odd layers' inputs, each as wide
    as the widest it holds; resident before streamed (a streamed ring has
    at least 2 slots), and for each two blocks per SM before one, unless
    the launch has no more tiles than SMs."""
    images = sum(-(-dims[l + 1] // STAGE_ROWS) * kblocks(dims[l]) for l in range(len(dims) - 1))
    tiles = -(-rows // TILE_ROWS)
    t0, t1 = (max(kblocks(d) for d in dims[parity::2]) * ABLOCK_BYTES for parity in (0, 1))
    per_sms = (1,) if tiles * chains <= sms else (2, 1)
    fits = [(n, (min(BLOCK_SMEM, SM_SMEM // n - 1024) - 1024 - t0 - t1) // SLOT_COST) for n in per_sms]
    choice = ([(per_sm, images) for per_sm, fit in fits if fit >= images]
              + [(per_sm, fit) for per_sm, fit in fits if fit >= 2])
    if not choice:
        raise ValueError(f"no launch plan for widths {dims}")
    per_sm, slots = choice[0]
    return dict(images=images, slots=slots, resident=int(slots == images), tiles=tiles,
                blocks=persistent_blocks(tiles, per_sm, chains, sms),
                smem_bytes=slots * STAGE_BYTES + t0 + t1 + 16 * slots + 1024, sms=sms, per_sm=per_sm)

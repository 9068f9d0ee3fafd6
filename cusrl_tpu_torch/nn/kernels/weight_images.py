"""The Hopper kernels' weight images and persistent tile schedule, in Python
(``csrc/hopper_wg.cuh``: ``wg::Pack``, ``wg::pack_unit``; used by the fused
block's forwards and post backward, ``fused_block.py``, and the MLP chain's
forward and backward, ``fused_mlp.py``).

A weight image is rows ``[n0, n0 + 128)`` and columns ``[k0, k0 + 64)`` of
one matrix as bf16, each image row's 16-byte chunks swizzled (chunk ``c`` at
``c ^ (row % 8)``: the 128-byte swizzle wgmma reads), 0 past the matrix.  The
matrix is an fp32 ``[out, in]`` weight, or for a backward's data product
(``d_in = d_out W``, whose K-major B operand is ``W^T``) its transpose.  A
kernel takes its images in a fixed order, listed here as ``(matrix, n0, k0)``
per image; ``pack_plain`` is the pack's plain version.

The MLP chain forward's launch plan (``mlpf::plan`` in
``csrc/mlp_chain_fwd.cu``) is mirrored by ``chain_plan``, phase 1 of its
backward (``mlpb::plan`` in ``csrc/mlp_chain_bwd.cu``) by ``chain_bwd_plan``,
the single-launch PPO step's (K9m, ``mlpm::plan``) by ``ppo_step_plan`` with
its image order ``ppo_step_stages``: whether a chain's images stay resident
in a block or stream through a ring, the ring's slots, the blocks per SM and
the shared memory per block.
Persistent blocks take tiles ``b``, ``b + blocks``, ... of their chain
(``tile_schedule``).  Nothing here touches a card.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "STAGE_BYTES",
    "STAGE_COLS",
    "STAGE_ROWS",
    "TILE_ROWS",
    "chain_bwd_plan",
    "chain_bwd_stages",
    "chain_plan",
    "chain_stages",
    "pack_plain",
    "persistent_blocks",
    "ppo_step_plan",
    "ppo_step_stages",
    "tile_schedule",
    "unpack_plain",
]

STAGE_ROWS, STAGE_COLS = 128, 64  # one image, [128][64] bf16 (wg::STAGE_N, wg::KBLOCK)
STAGE_BYTES = STAGE_ROWS * STAGE_COLS * 2
TILE_ROWS = 64  # rows of one warpgroup product (wg::TILE_M)
ABLOCK_BYTES = TILE_ROWS * STAGE_COLS * 2  # one 64-column K block of a 64-row activation tile
SM_SMEM, BLOCK_SMEM = 233472, 232448  # shared memory of one SM, the most one block may use (wg::)
SLOT_COST = STAGE_BYTES + 16  # a ring slot and its two barriers (wg::SLOT_COST)


def kblocks(k: int) -> int:
    return -(-k // STAGE_COLS)


def _swizzle_index() -> torch.Tensor:
    """``[128, 8, 8]``: where logical 16-byte chunk ``c`` of image row ``n``
    sits, ``c ^ (n % 8)``, repeated over the chunk's eight values."""
    n = torch.arange(STAGE_ROWS)[:, None]
    return (torch.arange(8)[None, :] ^ (n % 8))[..., None].expand(STAGE_ROWS, 8, 8)


def pack_plain(matrices, stages, transpose=()) -> torch.Tensor:
    """The plain version of the pack (``wg::pack_unit`` over every unit of
    every image): bf16 ``[len(stages), 128, 64]`` images of the matrices'
    slices, 0 past a matrix's edge, each row's 16-byte chunks swizzled (on
    the CPU).  Where ``transpose[m]`` is true the images are of
    ``matrices[m].T`` (``wg::Pack::trans``)."""
    out = torch.zeros(len(stages), STAGE_ROWS, 8, 8, dtype=torch.bfloat16)
    for img, (m, n0, k0) in zip(out, stages):
        mat = matrices[m].T if m < len(transpose) and transpose[m] else matrices[m]
        part = mat[n0:n0 + STAGE_ROWS, k0:k0 + STAGE_COLS].detach().cpu().to(torch.bfloat16)
        logical = torch.zeros(STAGE_ROWS, STAGE_COLS, dtype=torch.bfloat16)
        logical[:part.shape[0], :part.shape[1]] = part
        img.scatter_(1, _swizzle_index(), logical.view(STAGE_ROWS, 8, 8))
    return out.view(len(stages), STAGE_ROWS, STAGE_COLS)


def unpack_plain(images, stages, shapes, transpose=()) -> list[torch.Tensor]:
    """The bf16 matrices whose images ``images`` holds: the inverse of
    ``pack_plain``.  ``shapes`` are the matrices' as ``pack_plain`` took
    them; where ``transpose[m]`` is false or missing, the images' own
    matrix comes back (for a transposed pack, ``matrices[m].T`` at its
    shape ``shapes[m][::-1]``)."""
    logical_shapes = [tuple(shape)[::-1] if m < len(transpose) and transpose[m] else tuple(shape)
                      for m, shape in enumerate(shapes)]
    mats = [torch.zeros(shape, dtype=torch.bfloat16) for shape in logical_shapes]
    for img, (m, n0, k0) in zip(images.view(-1, STAGE_ROWS, 8, 8), stages):
        logical = img.gather(1, _swizzle_index()).view(STAGE_ROWS, STAGE_COLS)
        rows, cols = min(STAGE_ROWS, mats[m].shape[0] - n0), min(STAGE_COLS, mats[m].shape[1] - k0)
        mats[m][n0:n0 + rows, k0:k0 + cols] = logical[:rows, :cols]
    return [mat.T if m < len(transpose) and transpose[m] else mat for m, mat in enumerate(mats)]


def persistent_blocks(tiles: int, per_sm: int, chains: int, sms: int) -> int:
    """Blocks per chain of a persistent forward: ``per_sm`` blocks on every
    SM, split between the chains, at most one per tile."""
    return max(1, min(tiles, per_sm * sms // chains))


def tile_schedule(blocks: int, tiles: int, chains: int) -> list[tuple[int, int, int]]:
    """``(chain, block, tile)`` in the order each persistent block walks its
    tiles: block ``b`` takes tiles ``b``, ``b + blocks``, ..."""
    return [(c, b, t) for c in range(chains) for b in range(blocks) for t in range(b, tiles, blocks)]


def _ring(images: int, fixed: int, few_tiles: bool, dims) -> tuple[int, int]:
    """``(blocks per SM, ring slots)`` of a chain kernel beside ``fixed``
    bytes of shared memory per block (``wg::ring_slots``): resident (a slot
    per image) before streamed (at least 2 slots), and for each two blocks
    per SM before one, unless the launch has no more tiles than SMs."""
    fits = [(n, (min(BLOCK_SMEM, SM_SMEM // n - 1024) - 1024 - fixed) // SLOT_COST)
            for n in ((1,) if few_tiles else (2, 1))]
    choice = ([(per_sm, images) for per_sm, fit in fits if fit >= images]
              + [(per_sm, fit) for per_sm, fit in fits if fit >= 2])
    if not choice:
        raise ValueError(f"no launch plan for widths {dims}")
    return choice[0]


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
    per_sm, slots = _ring(images, t0 + t1, tiles * chains <= sms, dims)
    return dict(images=images, slots=slots, resident=int(slots == images), tiles=tiles,
                blocks=persistent_blocks(tiles, per_sm, chains, sms),
                smem_bytes=slots * STAGE_BYTES + t0 + t1 + 16 * slots + 1024, sms=sms, per_sm=per_sm)


def chain_bwd_stages(dims, skip_input_grad: bool) -> list[tuple[int, int, int]]:
    """``(layer, n0, k0)`` of each image of phase 1 of an MLP chain's
    backward (``mlpb::bwd_pack``), in the order its kernel takes them: per
    layer from the top down, while its data product ``bf16(d_l) W_l`` runs
    (layer 0's is dX, skipped with ``skip_input_grad``), per 128-row chunk
    of ``W_l^T`` (``[in, out]``: the product's output columns), per 64-column
    K block.  Every matrix is transposed (``pack_plain(..., transpose)``)."""
    layers = range(len(dims) - 2, 0 if skip_input_grad else -1, -1)
    return [(l, n0, k0) for l in layers for n0 in range(0, dims[l], STAGE_ROWS)
            for k0 in range(0, dims[l + 1], STAGE_COLS)]


RED_BYTES = 4 * 128 * 4  # the column sums' warp partials of a block (mlpb::RED_BYTES)


def _bwd_tiles(dims, skip_input_grad: bool, head_mode: int) -> tuple[int, int]:
    """Bytes of a chain backward's two tiles (``mlpb::tile_bytes``): each
    layer's ``bf16(d_l)`` of its parity where the layer's product runs, and
    with heads the latent in the tile of the chain's depth's parity."""
    num_layers = len(dims) - 1
    widest = [0, 0]
    for l in range(num_layers):
        if l > 0 or not skip_input_grad:
            widest[l & 1] = max(widest[l & 1], kblocks(dims[l + 1]))
    if head_mode:
        widest[num_layers & 1] = max(widest[num_layers & 1], kblocks(dims[-1]))
    return widest[0] * ABLOCK_BYTES, widest[1] * ABLOCK_BYTES


def _head_bytes(head_mode: int, head_dim: int) -> int:
    """The heads' scratch of a tile (``mlpb::head_bytes``): gh, and for the
    loss (mode 2) also the heads' outputs and the per-row loss terms."""
    return TILE_ROWS * (3 * head_dim + 2 if head_mode == 2 else head_dim) * 4 if head_mode else 0


@functools.lru_cache(maxsize=256)
def chain_bwd_plan(dims: tuple, rows: int, chains: int, sms: int, skip_input_grad: bool, head_mode: int = 0,
                   head_dim: int = 0) -> dict:
    """Phase 1's launch plan of an MLP chain's backward (``mlpb::plan``),
    with the keys of ``chain_plan``.  Its two swizzled tiles hold each
    layer's ``bf16(d_l)`` where the layer's product runs (even and odd
    layers), and with heads (``head_mode`` 1: K8b, 2: K9s; ``head_dim`` the
    wider head) the latent in the tile of the chain's depth's parity; beside
    them the column sums' partials and the heads' scratch (``gh``; K9s also
    the heads' outputs and the per-row loss terms).  No images (one layer
    without dX) counts as resident."""
    images = len(chain_bwd_stages(dims, skip_input_grad))
    tiles = -(-rows // TILE_ROWS)
    t0, t1 = _bwd_tiles(dims, skip_input_grad, head_mode)
    heads = _head_bytes(head_mode, head_dim)
    per_sm, slots = _ring(images, t0 + t1 + RED_BYTES + heads, tiles * chains <= sms, dims)
    return dict(images=images, slots=slots, resident=int(slots == images), tiles=tiles,
                blocks=persistent_blocks(tiles, per_sm, chains, sms),
                smem_bytes=slots * STAGE_BYTES + t0 + t1 + RED_BYTES + heads + 16 * slots + 1024, sms=sms,
                per_sm=per_sm)


def ppo_step_stages(dims) -> list[tuple[int, int, int]]:
    """``(matrix, n0, k0)`` of each image K9m's phase 1 takes per tile, in
    its ring's order (``mlpm::plan``): the forward's images of ``W_l``
    (matrix ``l``, ``chain_stages``), then the backward's of ``W_l^T``
    (matrix ``L + l``, ``chain_bwd_stages`` without dX).  Their pack is
    ``pack_plain(ws + ws, stages, (False,) * L + (True,) * L)``."""
    num_layers = len(dims) - 1
    return chain_stages(dims) + [(num_layers + l, n0, k0) for l, n0, k0 in chain_bwd_stages(dims, True)]


@functools.lru_cache(maxsize=256)
def ppo_step_plan(dims: tuple, rows: int, sms: int, head_dim: int) -> dict:
    """K9m's phase-1 plan (``mlpm::plan``) for two chains of widths ``dims``
    with heads of up to ``head_dim`` outputs, with the keys of
    ``chain_plan`` and ``fwd_images`` (the forward's share of each tile's
    images).  The images always stream, forward's then backward's, through
    one ring; its two tiles are each as large as the forward's
    (``chain_plan``) or the backward's (``chain_bwd_plan``) of its parity,
    beside the column sums' partials and the loss heads' scratch; the ring
    takes the slots that fit, at least 2 and no more than a tile's images
    (or 2), two blocks per SM before one unless the launch has no more
    tiles than SMs."""
    fwd = len(chain_stages(dims))
    images = len(ppo_step_stages(dims))
    tiles = -(-rows // TILE_ROWS)
    bwd = _bwd_tiles(dims, True, 2)
    t0, t1 = (max(max(kblocks(d) for d in dims[parity::2]) * ABLOCK_BYTES, bwd[parity]) for parity in (0, 1))
    fixed = t0 + t1 + RED_BYTES + _head_bytes(2, head_dim)
    for per_sm in ((1,) if tiles * 2 <= sms else (2, 1)):
        fit = (min(BLOCK_SMEM, SM_SMEM // per_sm - 1024) - 1024 - fixed) // SLOT_COST
        if fit >= 2:
            slots = min(fit, max(images, 2))
            break
    else:
        raise ValueError(f"no K9m launch plan for widths {dims}")
    return dict(images=images, slots=slots, resident=0, tiles=tiles, blocks=persistent_blocks(tiles, per_sm, 2, sms),
                smem_bytes=slots * STAGE_BYTES + fixed + 16 * slots + 1024, sms=sms, per_sm=per_sm, fwd_images=fwd)

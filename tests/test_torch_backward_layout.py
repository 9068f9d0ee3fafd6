"""Phase 1 of the backwards' Python-side layout on the CPU: the images of the
transposed weights (``weight_images.pack_plain(..., transpose)``), the order
the MLP chain backward (``weight_images.chain_bwd_stages``) and the fused
block's post backward (``fused_block.bwd_stages``) take them in, their launch
plans (``chain_bwd_plan``, ``post_bwd_plan``) and the persistent schedule.
No kernel runs here; the card checks the kernels against the same plans
(``test_backward_plans_match_the_python_mirrors``)."""

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import fused_block as fb
from cusrl_tpu_torch.nn.kernels import weight_images as wi

EIGHT_LAYERS = (512, 16, 512, 48, 80, 128, 256, 512, 16)
WIDTHS = [(48, 512, 256, 128), (128, 512, 128), (128, 128), (16, 16), (512, 16), (16, 512), EIGHT_LAYERS]
BLOCK_WIDTHS = [(128, 512), (16, 16), (16, 48), (128, 48), (48, 144), (128, 16)]  # (embed, ffn)


def _weights(dims, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, a, generator=gen) for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dims", WIDTHS)
def test_transposed_chain_images_unpack_to_the_transposed_weights(dims, skip):
    """Each image of W_l^T unpacks to ``w.t().to(bfloat16)``, with its
    swizzle: every element of a layer whose product runs lands in exactly one
    image; past a matrix's edge the images hold 0."""
    ws = _weights(dims, seed=sum(dims) + skip)
    stages = wi.chain_bwd_stages(dims, skip)
    transpose = (True,) * len(ws)
    images = wi.pack_plain(ws, stages, transpose)
    assert images.shape == (len(stages), wi.STAGE_ROWS, wi.STAGE_COLS) and images.dtype == torch.bfloat16
    back = wi.unpack_plain(images, stages, [tuple(w.t().shape) for w in ws])
    used = sorted({m for m, _, _ in stages})
    assert used == list(range(1 if skip else 0, len(ws)))
    for m in used:
        assert torch.equal(back[m], ws[m].t().to(torch.bfloat16))
    stored = wi.unpack_plain(images, stages, [tuple(w.shape) for w in ws], transpose)
    for m in used:
        assert torch.equal(stored[m], ws[m].to(torch.bfloat16))
    covered = sum(min(wi.STAGE_ROWS, ws[m].shape[1] - n0) * min(wi.STAGE_COLS, ws[m].shape[0] - k0)
                  for m, n0, k0 in stages)
    assert covered == sum(ws[m].numel() for m in used)  # no element twice
    assert int((images != 0).sum()) == sum(int((ws[m].to(torch.bfloat16) != 0).sum()) for m in used)


def test_swizzle_of_a_transposed_image():
    """Logical chunk c of image row n sits at chunk c ^ (n % 8): element
    (n, k) of the image of W^T is W[k][n]."""
    w = torch.arange(64 * 128, dtype=torch.float32).view(64, 128)  # exact in bf16 below 256: checked by index
    w = (w % 251).float()
    images = wi.pack_plain([w], [(0, 0, 0)], (True,))
    img = images[0]
    for n in (0, 1, 7, 8, 77, 127):
        for k in (0, 9, 17, 63):
            chunk = (k // 8) ^ (n % 8)
            assert img[n, chunk * 8 + k % 8] == w[k, n].to(torch.bfloat16)


@pytest.mark.parametrize("dims,skip,count", [((48, 512, 256, 128), True, 20), ((48, 512, 256, 128), False, 28),
                                             ((128, 512, 128), False, 16), ((128, 128), False, 2),
                                             ((128, 128), True, 0), ((16, 16), False, 1), ((512, 16), False, 4),
                                             (EIGHT_LAYERS, True, 40), (EIGHT_LAYERS, False, 44)])
def test_chain_backward_image_order_follows_the_kernel(dims, skip, count):
    """Layers from the top down while their product runs; per layer the
    128-row chunks of W_l^T (the product's output columns), each chunk's K
    blocks over the layer's output width in order (one ``wg::issue``)."""
    stages = wi.chain_bwd_stages(dims, skip)
    assert len(stages) == count
    position = 0
    for layer in range(len(dims) - 2, 0 if skip else -1, -1):
        for n0 in range(0, dims[layer], 128):
            chunk = stages[position:position + wi.kblocks(dims[layer + 1])]
            assert chunk == [(layer, n0, k0) for k0 in range(0, dims[layer + 1], 64)]
            position += len(chunk)
    assert position == len(stages)
    if dims == (48, 512, 256, 128) and skip:
        assert stages[:4] == [(2, 0, 0), (2, 0, 64), (2, 128, 0), (2, 128, 64)]
        assert stages[-4:] == [(1, 384, 0), (1, 384, 64), (1, 384, 128), (1, 384, 192)]


@pytest.mark.parametrize("embed,ff", BLOCK_WIDTHS)
def test_post_backward_images_unpack_and_follow_the_kernel(embed, ff):
    """The post backward's images: W_down^T's chunk rows and W_up^T's chunk
    columns per 128-column chunk of the hidden, then W_o^T; each unpacks to
    its weight's bf16 transpose, every element once."""
    gen = torch.Generator().manual_seed(embed + ff)
    mats = [torch.randn(embed, embed, generator=gen), torch.randn(ff, embed, generator=gen),
            torch.randn(embed, ff, generator=gen)]  # W_o, W_up, W_down as stored ([out, in])
    stages = fb.bwd_stages(embed, ff)
    kb_e = wi.kblocks(embed)
    position = 0
    for c0 in range(0, ff, 128):
        assert stages[position:position + kb_e] == [(2, c0, k0) for k0 in range(0, embed, 64)]
        position += kb_e
        ups = [(1, 0, k0) for k0 in range(c0, min(c0 + 128, ff), 64)]
        assert stages[position:position + len(ups)] == ups
        position += len(ups)
    assert stages[position:] == [(0, 0, k0) for k0 in range(0, embed, 64)]
    images = wi.pack_plain(mats, stages, (True, True, True))
    back = wi.unpack_plain(images, stages, [tuple(m.t().shape) for m in mats])
    for m, b in zip(mats, back):
        assert torch.equal(b, m.t().to(torch.bfloat16))
    assert int((images != 0).sum()) == sum(int((m.to(torch.bfloat16) != 0).sum()) for m in mats)
    if (embed, ff) == (128, 512):
        assert len(stages) == 18  # W_down^T 4 chunks x 2 K blocks, W_up^T 8 K blocks, W_o^T 2


@pytest.mark.parametrize("head", [(0, 0), (1, 1), (1, 64), (2, 12), (2, 64)])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("rows,chains,sms", [(1, 1, 132), (1024, 2, 132), (24576 + 17, 2, 132), (65573, 1, 7)])
@pytest.mark.parametrize("dims", WIDTHS)
def test_chain_backward_plan_fits_the_block_and_the_sm(dims, rows, chains, sms, skip, head):
    """Resident exactly when every image has its slot (no images at all for
    one layer without dX); a streamed ring has at least 2 slots; the tiles
    hold each product's A operand and the heads' latent; a block's shared
    memory stays within 227 KB, and its blocks per SM within the SM's."""
    head_mode, head_dim = head
    plan = wi.chain_bwd_plan(dims, rows, chains, sms, skip, head_mode, head_dim)
    num_layers = len(dims) - 1
    widest = [0, 0]
    for layer in range(num_layers):
        if layer or not skip:
            widest[layer % 2] = max(widest[layer % 2], wi.kblocks(dims[layer + 1]))
    if head_mode:
        widest[num_layers % 2] = max(widest[num_layers % 2], wi.kblocks(dims[-1]))
    heads = 64 * (3 * head_dim + 2 if head_mode == 2 else head_dim) * 4
    assert plan["images"] == len(wi.chain_bwd_stages(dims, skip))
    assert plan["resident"] == (plan["slots"] == plan["images"])
    assert plan["resident"] or plan["slots"] >= 2
    assert plan["smem_bytes"] == (plan["slots"] * (wi.STAGE_BYTES + 16) + 8192 * sum(widest) + wi.RED_BYTES + heads
                                  + 1024)
    assert plan["smem_bytes"] <= 232448 and plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["tiles"] == -(-rows // 64) and 1 <= plan["blocks"] <= plan["tiles"]


@pytest.mark.parametrize("dims,skip,head,resident,per_sm,slots", [
    ((48, 512, 256, 128), True, (0, 0), 0, 2, 3),  # K2b: 20 images stream, two blocks per SM
    ((48, 512, 256, 128), False, (0, 0), 0, 1, 7),  # K1b with dX: 28 images, the 512-wide d_0 tile
    ((48, 512, 256, 128), True, (1, 12), 0, 2, 3),  # K8b
    ((48, 512, 256, 128), True, (2, 12), 0, 2, 3),  # K9s
    ((128, 128), False, (0, 0), 1, 2, 2),  # the transformer's ELU head: 2 images resident
    ((128, 512, 128), False, (0, 0), 0, 1, 8),  # the gelu FFN: 16 images stream
    ((128, 128), True, (0, 0), 1, 2, 0)])  # one layer without dX: no product, no images
def test_chain_backward_plan_at_the_zoo_widths(dims, skip, head, resident, per_sm, slots):
    plan = wi.chain_bwd_plan(dims, 65536, 1 if head == (0, 0) and not skip else 2, 132, skip, *head)
    assert (plan["resident"], plan["per_sm"], plan["slots"]) == (resident, per_sm, slots)


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 6144, 65536 + 37])
@pytest.mark.parametrize("embed,ff", BLOCK_WIDTHS)
def test_post_backward_plan_fits_two_blocks_per_sm(embed, ff, rows, chains, sms):
    plan = fb.post_bwd_plan(rows, chains, embed, ff, sms)
    wg_bytes = (2 * wi.kblocks(embed) + 2) * 8192
    par = (2 * embed + fb.RED_FLOATS + fb.ROW_FLOATS) * 4
    assert plan["images"] == len(fb.bwd_stages(embed, ff))
    assert plan["resident"] == (plan["slots"] == plan["images"]) and plan["slots"] >= 2
    assert plan["smem_bytes"] == plan["slots"] * (wi.STAGE_BYTES + 16) + wg_bytes + par + 1024
    assert 2 * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["tiles"] == -(-rows // 64) and 1 <= plan["blocks"] <= min(plan["tiles"], 2 * sms // chains)
    if (embed, ff) == (128, 512):
        assert (plan["images"], plan["slots"], plan["resident"]) == (18, 3, 0)


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 24576 + 17, 65573])
def test_backward_schedules_take_every_tile_once(rows, chains, sms):
    """Each (chain, tile) is taken by exactly one persistent block, for the
    chain backward and the post backward alike; the blocks' shares differ by
    at most one tile."""
    plans = [wi.chain_bwd_plan((48, 512, 256, 128), rows, chains, sms, True),
             fb.post_bwd_plan(rows, chains, 128, 512, sms)]
    for plan in plans:
        blocks, tiles = plan["blocks"], plan["tiles"]
        schedule = wi.tile_schedule(blocks, tiles, chains)
        assert sorted((c, t) for c, _, t in schedule) == [(c, t) for c in range(chains) for t in range(tiles)]
        for c in range(chains):
            per_block = [sum(1 for c_, b, _ in schedule if (c_, b) == (c, k)) for k in range(blocks)]
            assert max(per_block) - min(per_block) <= 1 and min(per_block) >= 1


PRE_WIDTHS = [(48, 128), (16, 16), (512, 128), (16, 128), (512, 16), (80, 48), (144, 64)]  # (in, embed)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("in_dim,embed", PRE_WIDTHS)
def test_pre_backward_image_order_follows_the_kernel(in_dim, embed, skip):
    """W_q^T, W_k^T and W_v^T by K block (one run of K blocks over the gqkv
    tile's three segments), then W_in^T's 128-row chunks of the input width,
    each chunk's K blocks over the embedding in order (``fbp::pre_bwd_pack``)."""
    stages = fb.pre_bwd_stages(in_dim, embed, skip)
    kb_e = wi.kblocks(embed)
    assert stages[:3 * kb_e] == [(q, 0, k0) for q in range(3) for k0 in range(0, embed, 64)]
    tail = stages[3 * kb_e:]
    if skip:
        assert tail == []
    else:
        assert tail == [(3, n0, k0) for n0 in range(0, in_dim, 128) for k0 in range(0, embed, 64)]
        assert len(tail) == -(-in_dim // 128) * kb_e
    if (in_dim, embed) == (48, 128):
        assert len(stages) == (6 if skip else 8)  # the zoo's widths: 96 KB of qkv images, W_in^T 32 KB


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("in_dim,embed", PRE_WIDTHS)
def test_pre_backward_images_unpack_to_the_transposed_weights(in_dim, embed, skip):
    """Each image unpacks to its weight's bf16 transpose (W_q^T, W_k^T, W_v^T
    and, with dX, W_in^T), every element in exactly one image, 0 past a
    matrix's edge."""
    gen = torch.Generator().manual_seed(in_dim + embed + skip)
    mats = [torch.randn(embed, embed, generator=gen) for _ in range(3)] + [torch.randn(embed, in_dim, generator=gen)]
    stages = fb.pre_bwd_stages(in_dim, embed, skip)
    images = wi.pack_plain(mats, stages, (True,) * 4)
    used = [0, 1, 2] if skip else [0, 1, 2, 3]
    assert sorted({m for m, _, _ in stages}) == used
    back = wi.unpack_plain(images, stages, [tuple(m.t().shape) for m in mats])
    for m in used:
        assert torch.equal(back[m], mats[m].t().to(torch.bfloat16))
    qkv_t = torch.cat([back[q] for q in range(3)], 1)  # [E, 3E]: the B operand of dy = gqkv [W_q; W_k; W_v]
    assert torch.equal(qkv_t, torch.cat(mats[:3]).t().to(torch.bfloat16))
    covered = sum(min(wi.STAGE_ROWS, mats[m].shape[1] - n0) * min(wi.STAGE_COLS, mats[m].shape[0] - k0)
                  for m, n0, k0 in stages)
    assert covered == sum(mats[m].numel() for m in used)
    assert int((images != 0).sum()) == sum(int((mats[m].to(torch.bfloat16) != 0).sum()) for m in used)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
@pytest.mark.parametrize("in_dim,embed", PRE_WIDTHS)
def test_pre_backward_plan_fits_the_block_and_the_sm(in_dim, embed, rows, chains, sms, skip):
    """The gqkv tiles (three segments of pad64(E) columns each), LN1's
    parameters and the sums' partials (six sets) beside the ring; resident
    exactly when every image has its slot, a streamed ring at least 2 slots;
    within 227 KB a block and the SM's shared memory for its blocks per SM."""
    plan = fb.pre_bwd_plan(rows, chains, in_dim, embed, skip, sms)
    per_sm = fb.PRE_BWD_BLOCKS_PER_SM
    tile = fb.PRE_BWD_GQKV_TILES * 3 * wi.kblocks(embed) * 8192
    par = (2 * embed + fb.PRE_RED_FLOATS + fb.ROW_FLOATS) * 4
    assert plan["images"] == len(fb.pre_bwd_stages(in_dim, embed, skip))
    assert plan["resident"] == (plan["slots"] == plan["images"]) and plan["slots"] >= 2
    assert plan["smem_bytes"] == plan["slots"] * (wi.STAGE_BYTES + 16) + tile + par + 1024
    assert plan["smem_bytes"] <= 232448 and per_sm * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["tiles"] == -(-rows // 64) and 1 <= plan["blocks"] <= min(plan["tiles"], per_sm * sms // chains)


@pytest.mark.parametrize("skip,resident,slots", [(True, 1, 6), (False, 0, 7)])
def test_pre_backward_plan_at_the_zoo_widths(skip, resident, slots):
    """Input 48, embedding 128: the six qkv images stay resident in one
    block per SM beside two gqkv tiles (the paths' skip_input_grad); with
    dX's two more images they stream through seven slots."""
    plan = fb.pre_bwd_plan(65536, 1, 48, 128, skip, 132)
    assert (plan["resident"], plan["slots"], plan["blocks"], plan["tiles"]) == (resident, slots, 132, 1024)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 6144 + 17, 65536 + 37])
def test_pre_backward_schedule_takes_every_tile_once(rows, chains, sms, skip):
    plan = fb.pre_bwd_plan(rows, chains, 48, 128, skip, sms)
    blocks, tiles = plan["blocks"], plan["tiles"]
    schedule = wi.tile_schedule(blocks, tiles, chains)
    assert sorted((c, t) for c, _, t in schedule) == [(c, t) for c in range(chains) for t in range(tiles)]
    for c in range(chains):
        per_block = [sum(1 for c_, b, _ in schedule if (c_, b) == (c, k)) for k in range(blocks)]
        assert max(per_block) - min(per_block) <= 1 and min(per_block) >= 1

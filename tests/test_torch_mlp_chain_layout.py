"""The MLP chain forward's Python-side layout on the CPU: the weight images its
pack writes (``weight_images.chain_stages``, ``pack_plain``, shared with the
fused block's forwards), the launch plan's choice between resident and
streamed images and its shared memory (``weight_images.chain_plan``), and
the persistent blocks' tile schedule.  No kernel runs here; the card checks
the kernel against the same plan (``test_chain_forward_plan_matches_the_python_mirror``)."""

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import weight_images as wi

EIGHT_LAYERS = (512, 16, 512, 48, 80, 128, 256, 512, 16)
WIDTHS = [(48, 512, 256, 128), (128, 512, 128), (128, 128), (16, 16), (512, 16), EIGHT_LAYERS]


def _weights(dims, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, a, generator=gen) for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("dims", WIDTHS)
def test_chain_images_unpack_to_the_bf16_weights(dims):
    """Every weight element lands in exactly one image and comes back as
    ``w.to(bfloat16)``; everything past a matrix's edge is 0."""
    mats = _weights(dims, seed=sum(dims))
    stages = wi.chain_stages(dims)
    images = wi.pack_plain(mats, stages)
    assert images.shape == (len(stages), wi.STAGE_ROWS, wi.STAGE_COLS) and images.dtype == torch.bfloat16
    back = wi.unpack_plain(images, stages, [m.shape for m in mats])
    for m, b in zip(mats, back):
        assert torch.equal(b, m.to(torch.bfloat16))
    covered = sum(min(wi.STAGE_ROWS, mats[m].shape[0] - n0) * min(wi.STAGE_COLS, mats[m].shape[1] - k0)
                  for m, n0, k0 in stages)
    assert covered == sum(m.numel() for m in mats)  # no element twice
    assert int((images != 0).sum()) == sum(int((m.to(torch.bfloat16) != 0).sum()) for m in mats)


@pytest.mark.parametrize("dims,count", [((48, 512, 256, 128), 24), ((128, 512, 128), 16), ((128, 128), 2),
                                        ((16, 16), 1), ((512, 16), 8), (EIGHT_LAYERS, 51)])
def test_chain_image_order_follows_the_kernel(dims, count):
    """The kernel takes each layer in turn, per 128-column chunk of its
    output, the chunk's K blocks in order (one ``wg::issue`` per chunk)."""
    stages = wi.chain_stages(dims)
    assert len(stages) == count
    position = 0
    for layer, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        for n0 in range(0, n, 128):
            chunk = stages[position:position + wi.kblocks(k)]
            assert chunk == [(layer, n0, k0) for k0 in range(0, k, 64)]
            position += len(chunk)
    assert position == len(stages)
    if dims == (48, 512, 256, 128):
        assert stages[:5] == [(0, 0, 0), (0, 128, 0), (0, 256, 0), (0, 384, 0), (1, 0, 0)]
        assert stages[-4:] == [(2, 0, 0), (2, 0, 64), (2, 0, 128), (2, 0, 192)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 1024, 98304 + 37])
@pytest.mark.parametrize("dims", WIDTHS)
def test_chain_plan_fits_the_block_and_the_sm(dims, rows, chains, sms):
    """Resident exactly when every image has its slot; a streamed ring has at
    least 2 slots; a block's shared memory (tiles, ring, barriers and 1 KB of
    alignment) stays within 227 KB, and its blocks per SM within the SM's."""
    plan = wi.chain_plan(dims, rows, chains, sms)
    tiles = [max(wi.kblocks(d) for d in dims[parity::2]) * 8192 for parity in (0, 1)]
    assert plan["images"] == len(wi.chain_stages(dims))
    assert plan["resident"] == (plan["slots"] == plan["images"])
    assert plan["resident"] or plan["slots"] >= 2
    assert plan["smem_bytes"] == plan["slots"] * (wi.STAGE_BYTES + 16) + sum(tiles) + 1024
    assert plan["smem_bytes"] <= 232448 and plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["tiles"] == -(-rows // 64) and 1 <= plan["blocks"] <= plan["tiles"]
    if plan["tiles"] * chains <= sms:
        assert plan["per_sm"] == 1  # few tiles: the layout with the most slots


@pytest.mark.parametrize("dims,resident,per_sm,slots", [((48, 512, 256, 128), 0, 1, 8), ((128, 512, 128), 0, 1, 9),
                                                        ((128, 128), 1, 2, 2), ((16, 16), 1, 2, 1),
                                                        ((512, 16), 1, 1, 8), (EIGHT_LAYERS, 0, 1, 6)])
def test_chain_plan_at_the_zoo_widths(dims, resident, per_sm, slots):
    """At 98,304 rows on 132 SMs: the main path's chain (384 KB of images)
    and the gelu FFN stream through one block per SM; the transformer's
    128 -> 128 head keeps its 2 images resident in two blocks per SM; a
    chain whose images fit only in a whole SM keeps them there (resident
    before streamed)."""
    plan = wi.chain_plan(dims, 98304, 1, 132)
    assert (plan["resident"], plan["per_sm"], plan["slots"]) == (resident, per_sm, slots)


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("rows", [1, 63, 65, 1024, 24576 + 17, 98304 + 37])
def test_chain_tile_schedule_covers_every_tile_once(rows, chains, sms):
    plan = wi.chain_plan((48, 512, 256, 128), rows, chains, sms)
    blocks, tiles = plan["blocks"], plan["tiles"]
    assert blocks <= max(1, plan["per_sm"] * sms // chains)
    schedule = wi.tile_schedule(blocks, tiles, chains)
    assert sorted((c, t) for c, _, t in schedule) == [(c, t) for c in range(chains) for t in range(tiles)]
    for c in range(chains):
        per_block = [sum(1 for c_, b, _ in schedule if (c_, b) == (c, k)) for k in range(blocks)]
        assert max(per_block) - min(per_block) <= 1 and min(per_block) >= 1

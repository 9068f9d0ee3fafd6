"""K9m's phase 1 (the single-launch PPO step, ``mlpm::`` in
``csrc/mlp_chain_bwd.cu``) on the CPU, Python side only: the order in which
one ring hands a tile its images (``weight_images.ppo_step_stages``: the
forward's images of W_l, then the backward's of W_l^T), their pack, the
launch plan (``ppo_step_plan``: ring slots, always streamed, shared memory,
blocks per SM) and the tile schedule.  No kernel runs here; the card checks
the kernel's own plan against the same mirror
(``test_ppo_step_plan_matches_the_python_mirror``)."""

import pytest
import torch

from cusrl_tpu_torch.nn.kernels import weight_images as wi

EIGHT_LAYERS = (512, 16, 512, 48, 80, 128, 256, 512, 16)
WIDTHS = [(48, 512, 256, 128), (128, 512, 128), (128, 128), (16, 16), (512, 16), (16, 512), EIGHT_LAYERS]


@pytest.mark.parametrize("dims", WIDTHS)
def test_ppo_step_images_are_the_forward_then_the_backward(dims):
    """A tile takes the forward's images in the chain forward's order, then
    the backward's (no dX) in the chain backward's: the two kernels' own
    orders, back to back, in one ring."""
    stages = wi.ppo_step_stages(dims)
    forward, backward = wi.chain_stages(dims), wi.chain_bwd_stages(dims, True)
    num_layers = len(dims) - 1
    assert stages[:len(forward)] == forward
    assert stages[len(forward):] == [(num_layers + l, n0, k0) for l, n0, k0 in backward]
    if dims == (48, 512, 256, 128):
        assert (len(forward), len(backward)) == (24, 20)
        assert stages[23:25] == [(2, 0, 192), (3 + 2, 0, 0)]  # W_2's last image, then W_2^T's first


@pytest.mark.parametrize("dims", WIDTHS[:5])
def test_ppo_step_images_unpack_to_the_weights_and_their_transposes(dims):
    """Packed as ``pack_plain(ws + ws, stages, (False,) * L + (True,) * L)``:
    the forward's images unpack to ``bf16(W_l)``, the backward's (images of
    ``W_l^T``, unpacked to the stored layout) to ``bf16(W_l)`` too, for every
    layer above the first; every element once."""
    gen = torch.Generator().manual_seed(sum(dims))
    ws = [torch.randn(b, a, generator=gen) for a, b in zip(dims[:-1], dims[1:])]
    num_layers = len(ws)
    transpose = (False,) * num_layers + (True,) * num_layers
    stages = wi.ppo_step_stages(dims)
    images = wi.pack_plain(ws + ws, stages, transpose)
    back = wi.unpack_plain(images, stages, [tuple(w.shape) for w in ws + ws], transpose)
    for l, w in enumerate(ws):
        assert torch.equal(back[l], w.to(torch.bfloat16))
        if l > 0:
            assert torch.equal(back[num_layers + l], w.to(torch.bfloat16))
    assert not back[num_layers].any()  # layer 0's dX product does not run: no image of W_0^T
    expected = sum(int((w.to(torch.bfloat16) != 0).sum()) for w in ws) + sum(
        int((w.to(torch.bfloat16) != 0).sum()) for w in ws[1:])
    assert int((images != 0).sum()) == expected


@pytest.mark.parametrize("head_dim", [1, 12, 64])
@pytest.mark.parametrize("rows,sms", [(1, 132), (1000, 132), (24576, 132), (24576 + 17, 7), (65573, 132)])
@pytest.mark.parametrize("dims", WIDTHS)
def test_ppo_step_plan_fits_the_block_and_the_sm(dims, rows, sms, head_dim):
    """Always streamed, at least 2 slots and no more than a tile's images (or
    2); the two tiles each hold the forward's and the backward's operand of
    their parity; the column sums' partials and the loss heads' scratch
    beside them; a block within 227 KB, its blocks per SM within the SM's;
    two blocks per SM wherever they fit and the launch has more tiles than
    SMs."""
    plan = wi.ppo_step_plan(dims, rows, sms, head_dim)
    num_layers = len(dims) - 1
    fwd = [max(wi.kblocks(d) for d in dims[parity::2]) for parity in (0, 1)]
    bwd = [0, 0]
    for layer in range(1, num_layers):
        bwd[layer % 2] = max(bwd[layer % 2], wi.kblocks(dims[layer + 1]))
    bwd[num_layers % 2] = max(bwd[num_layers % 2], wi.kblocks(dims[-1]))
    tiles = 8192 * sum(max(f, b) for f, b in zip(fwd, bwd))
    fixed = tiles + wi.RED_BYTES + 64 * (3 * head_dim + 2) * 4
    assert plan["images"] == len(wi.ppo_step_stages(dims)) and plan["fwd_images"] == len(wi.chain_stages(dims))
    assert plan["resident"] == 0 and 2 <= plan["slots"] <= max(plan["images"], 2)
    assert plan["smem_bytes"] == plan["slots"] * (wi.STAGE_BYTES + 16) + fixed + 1024
    assert plan["smem_bytes"] <= 232448 and plan["per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["tiles"] == -(-rows // 64) and 1 <= plan["blocks"] <= plan["tiles"]
    assert plan["blocks"] == wi.persistent_blocks(plan["tiles"], plan["per_sm"], 2, sms)
    two = (min(232448, 233472 // 2 - 1024) - 1024 - fixed) // (wi.STAGE_BYTES + 16) >= 2
    assert plan["per_sm"] == (2 if two and 2 * plan["tiles"] > sms else 1)
    if plan["slots"] < max(plan["images"], 2):  # the ring takes every slot that fits
        assert plan["smem_bytes"] + wi.STAGE_BYTES + 16 > (232448 if plan["per_sm"] == 1 else 233472 // 2 - 1024)


def test_ppo_step_plan_at_the_zoo_widths():
    """Velocity-Rough's 48-512-256-128 chains with the 12-D mean and 1-D
    value heads at the minibatch's 24,576 rows: 44 images a tile (24 of the
    forward) through 7 slots, one block of four consumer warpgroups per SM,
    66 blocks per chain over 384 tiles."""
    plan = wi.ppo_step_plan((48, 512, 256, 128), 24576, 132, 12)
    assert plan == dict(images=44, slots=7, resident=0, tiles=384, blocks=66, smem_bytes=225904, sms=132, per_sm=1,
                        fwd_images=24)


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("rows", [1, 63, 65, 1000, 24576, 24576 + 17])
def test_ppo_step_schedule_takes_every_tile_of_both_chains_once(rows, sms):
    plan = wi.ppo_step_plan((48, 512, 256, 128), rows, sms, 12)
    schedule = wi.tile_schedule(plan["blocks"], plan["tiles"], 2)
    assert sorted((c, t) for c, _, t in schedule) == [(c, t) for c in range(2) for t in range(plan["tiles"])]
    for c in range(2):
        per_block = [sum(1 for c_, b, _ in schedule if (c_, b) == (c, k)) for k in range(plan["blocks"])]
        assert max(per_block) - min(per_block) <= 1 and min(per_block) >= 1
